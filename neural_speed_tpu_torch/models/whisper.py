"""Whisper encoder-decoder (port of `neural_speed_tpu/models/whisper.py`).

The same model and the same host loop as the JAX package: a conv1d x2
front-end with exact-erf GELU, learned positions, pre-LN blocks, a
cross-attention decoder over a float32 self-attention `KVCache`, greedy /
sampled decoding with whisper's timestamp rules, beam search, language
detection, and the converter from HF `WhisperForConditionalGeneration`
state dicts.  Activations, the self-attention cache and the cross K/V are
float32, as in the JAX package.

Where the JAX package runs XLA, the port runs its kernels.  The JAX
package's attention falls back to XLA's float32 `attention_ref` for the
encoder and the cross attention (1500 frames: `flash._supported` asks for
S % 128 == 0) and for the decoder's single-token MHA steps over the float32
cache (`attention.py:222-224`).  The port sends all of them to kernels C
and B (`flash.mha`): the non-causal variant for the encoder (T = S = 1500,
laid out at S = 1536) and the cross attention, the causal one for the
decoder's cache.  The kernels round q, K, V and P to bf16 before their
products (as the JAX Pallas kernels do) and write float32 outputs, so the
port agrees with the JAX package's float32 path within a tolerance, not bit
for bit (`tests/test_torch_whisper.py` states it).  The front-end's
convolutions are exact float32 products (unfold + `torch.matmul`; cuDNN's
convolution would run in TF32 on the card), and nothing here changes
PyTorch's TF32 flags.

Quantized whisper (`convert_whisper(..., qspec)`) runs its linears through
`qmatmul` with float32 activations and float32 outputs, as the JAX
package's kernels do (`_compute_dtype`'s float32 branch): the plain version
on the CPU; on the card the `_f32` instances of kernels F, P and P's
one-plane INT instances (int8 g128, the `AudioModel` default, goes to the
last), a float32 GEMV per decode step and, over the encoder's 1500 frames
and the cross K/V, a GEMM in 3xTF32 on the tensor cores, within
float32-level error (the `check_f32_formats` contract of `chip_smoke.py`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .._build import resolve_device
from ..ops import flash
from ..ops import kv_cache as kvc
from ..ops.attention import attention, attention_cache, kv_layout
from ..ops.norms import layer_norm
from .transformer import linear

Params = Dict[str, Any]

@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    vocab_size: int = 51865
    d_model: int = 384
    n_heads: int = 6
    encoder_layers: int = 4
    decoder_layers: int = 4
    ffn_dim: int = 1536
    num_mel_bins: int = 80
    max_source_positions: int = 1500
    max_target_positions: int = 448
    decoder_start_token_id: int = 50258
    eos_token_id: int = 50257
    norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def whisper_config_from_hf(hf: Dict[str, Any]) -> WhisperConfig:
    return WhisperConfig(
        vocab_size=hf["vocab_size"],
        d_model=hf["d_model"],
        n_heads=hf["encoder_attention_heads"],
        encoder_layers=hf["encoder_layers"],
        decoder_layers=hf["decoder_layers"],
        ffn_dim=hf["encoder_ffn_dim"],
        num_mel_bins=hf["num_mel_bins"],
        max_source_positions=hf["max_source_positions"],
        max_target_positions=hf["max_target_positions"],
        decoder_start_token_id=hf.get("decoder_start_token_id", 50258),
        eos_token_id=hf.get("eos_token_id", 50257),
    )


def _norm(x, p, eps):
    return layer_norm(x, p["weight"], p.get("bias"), eps)


def _mha(x_q, x_kv, p, cfg: WhisperConfig, positions, kv_lens, causal):
    """Projection + attention for encoder blocks (no cache)."""
    b, t, _ = x_q.shape
    s = x_kv.shape[1]
    h, d = cfg.n_heads, cfg.head_dim
    q = linear(x_q, p["q"]).reshape(b, t, h, d)
    k = linear(x_kv, p["k"]).reshape(b, s, h, d)
    v = linear(x_kv, p["v"]).reshape(b, s, h, d)
    out = attention(q, k, v, positions, kv_lens,
                    scale=1.0 / math.sqrt(d), causal=causal)
    return linear(out.reshape(b, t, h * d), p["o"])


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------


def _conv1d(x: torch.Tensor, p: Params, stride: int) -> torch.Tensor:
    """conv1d(kernel 3, padding 1) over x [B, T, C_in] -> [B, T_out, C_out]
    (w [C_out, C_in, 3]) as windows times the flattened kernel: one exact
    float32 product."""
    w = p["w"].float()
    xp = F.pad(x, (0, 0, 1, 1))                          # [B, T + 2, C_in]
    win = xp.unfold(1, 3, stride)                        # [B, T_out, C_in, 3]
    win = win.reshape(*win.shape[:2], -1)
    return win @ w.reshape(w.shape[0], -1).t() + p["b"].float()


def encode(params: Params, cfg: WhisperConfig, mel: torch.Tensor
           ) -> torch.Tensor:
    """mel [B, n_mels, frames] -> encoder states [B, frames//2, D].

    conv1d(k3, p1) + gelu, conv1d(k3, s2, p1) + gelu, + learned positions,
    pre-LN non-causal self-attention blocks (kernel C over 1500 frames laid
    out at 1536), final LN."""
    enc = params["encoder"]
    x = mel.float().transpose(1, 2)                      # [B, frames, mels]
    x = F.gelu(_conv1d(x, enc["conv1"], 1))
    x = F.gelu(_conv1d(x, enc["conv2"], 2))              # [B, T, D]
    b, t = x.shape[0], x.shape[1]
    x = x + enc["pos"][:t][None].float()
    positions = torch.arange(t, dtype=torch.int32,
                             device=x.device)[None].expand(b, t)
    kv_lens = torch.full((b,), t, dtype=torch.int32, device=x.device)
    for lp in enc["layers"]:
        h = _norm(x, lp["attn_norm"], cfg.norm_eps)
        x = x + _mha(h, h, lp["attn"], cfg, positions, kv_lens, causal=False)
        h = _norm(x, lp["ffn_norm"], cfg.norm_eps)
        h = F.gelu(linear(h, lp["fc1"]))
        x = x + linear(h, lp["fc2"])
    return _norm(x, enc["final_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------


def cross_kv(params: Params, cfg: WhisperConfig, enc_states: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project every decoder layer's cross-attention K/V once per utterance.

    Unlike the JAX function, which returns a list of per-layer (k, v)
    `[B, S, H, D]`, this returns (k, v) already in the attention kernels'
    layout: each a stacked cache `[decoder_layers, B, H, S_pad, D]`
    (float32, S_pad the next multiple of 64, zero rows past S), so the
    decode steps read layer i in place and never lay out
    layers x 2 x S x D floats again (`k[i, :, :, :S].transpose(1, 2)` is
    the JAX function's layer i)."""
    b, s, _ = enc_states.shape
    h, d = cfg.n_heads, cfg.head_dim
    layers = params["decoder"]["layers"]
    k_all = v_all = None
    for i, lp in enumerate(layers):
        k = linear(enc_states, lp["cross"]["k"]).reshape(b, s, h, d)
        v = linear(enc_states, lp["cross"]["v"]).reshape(b, s, h, d)
        k_all = kv_layout(k.float(), k_all, i, len(layers))
        v_all = kv_layout(v.float(), v_all, i, len(layers))
    return k_all, v_all


def decoder_forward(
    params: Params,
    cfg: WhisperConfig,
    tokens: torch.Tensor,         # [B, T]
    positions: torch.Tensor,      # [B, T]
    cache: kvc.KVCache,           # self-attn cache (decoder_layers deep)
    kv_lens: torch.Tensor,        # [B] self-attn lengths AFTER this step
    cross: Tuple,                 # (k, v) from cross_kv
    enc_lens: torch.Tensor,       # [B] encoder frame counts
) -> Tuple[torch.Tensor, kvc.KVCache]:
    """Logits [B, T, V] and the cache (written in place).  Self-attention is
    causal over the float32 cache (kernels C and B); cross attention is
    non-causal over `cross` (kernel C for a T > 1 prefix, B per token)."""
    dec = params["decoder"]
    b, t = tokens.shape
    h, d = cfg.n_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(d)
    ck, cv = cross
    x = dec["embed"][tokens.long()].float()
    pos_emb = dec["pos"][positions.clamp(
        0, cfg.max_target_positions - 1).long()]
    x = x + pos_emb.float()

    for i, lp in enumerate(dec["layers"]):
        # causal self-attention over the cache
        hh = _norm(x, lp["attn_norm"], cfg.norm_eps)
        q = linear(hh, lp["attn"]["q"]).reshape(b, t, h, d)
        k = linear(hh, lp["attn"]["k"]).reshape(b, t, h, d)
        v = linear(hh, lp["attn"]["v"]).reshape(b, t, h, d)
        cache = kvc.append_layer(cache, i, k, v, positions)
        a = attention_cache(q, cache, i, positions, kv_lens, scale=scale,
                            causal=True, out_dtype=x.dtype)
        x = x + linear(a.reshape(b, t, h * d), lp["attn"]["o"])

        # cross-attention over encoder states
        hh = _norm(x, lp["cross_norm"], cfg.norm_eps)
        qc = linear(hh, lp["cross"]["q"]).reshape(b, t, h, d)
        a = flash.mha(qc, ck, cv, None, None, positions, enc_lens,
                      scale=scale, causal=False, out_dtype=x.dtype, layer=i)
        x = x + linear(a.reshape(b, t, h * d), lp["cross"]["o"])

        hh = _norm(x, lp["ffn_norm"], cfg.norm_eps)
        hh = F.gelu(linear(hh, lp["fc1"]))
        x = x + linear(hh, lp["fc2"])

    x = _norm(x, dec["final_norm"], cfg.norm_eps)
    logits = linear(x, params["proj_out"])
    return logits, cache


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------


def _self_cache(cfg: WhisperConfig, b: int, device) -> kvc.KVCache:
    return kvc.init_cache(cfg.decoder_layers, b, cfg.max_target_positions,
                          cfg.n_heads, cfg.head_dim, torch.float32,
                          device=device)


def _host(logits: torch.Tensor) -> np.ndarray:
    return logits.float().cpu().numpy()


class WhisperModel:
    """User-facing transcription model; runs where its params lie."""

    def __init__(self, params: Params, cfg: WhisperConfig):
        self.params = params
        self.cfg = cfg
        self.device = params["decoder"]["embed"].device

    # -- audio -> encoder states --------------------------------------
    def encode_audio(self, audio: np.ndarray
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """PCM -> (states [1, T, D], enc_lens [1]).  The mel front-end takes
        its default 80 bins whatever `cfg.num_mel_bins` is, as the JAX
        package does (a 128-bin model fails at conv1 in both)."""
        from ..ops.mel import log_mel_spectrogram

        mel = log_mel_spectrogram(np.asarray(audio))
        mel = torch.from_numpy(mel)[None].to(self.device)
        states = encode(self.params, self.cfg, mel)
        enc_lens = torch.full((1,), states.shape[1], dtype=torch.int32,
                              device=self.device)
        return states, enc_lens

    def _prefix_step(self, enc_states, enc_lens, prefix: List[int], b: int):
        """A fresh cache and cross K/V, and the forced prefix's step."""
        cfg = self.cfg
        dev = enc_states.device
        cache = _self_cache(cfg, b, dev)
        cross = cross_kv(self.params, cfg, enc_states)
        n = len(prefix)
        toks = torch.tensor([prefix] * b, dtype=torch.int32, device=dev)
        pos = torch.arange(n, dtype=torch.int32, device=dev)[None].expand(
            b, n).contiguous()
        kv_lens = torch.full((b,), n, dtype=torch.int32, device=dev)
        logits, cache = decoder_forward(self.params, cfg, toks, pos, cache,
                                        kv_lens, cross, enc_lens)
        return logits, kvc.set_lengths(cache, kv_lens), cross

    def _step(self, tokens: torch.Tensor, cache, cross, enc_lens):
        """One decode step for tokens [B, 1] at each slot's stored length."""
        n = cache.lengths
        kv_lens = n + 1
        logits, cache = decoder_forward(self.params, self.cfg, tokens,
                                        n[:, None], cache, kv_lens, cross,
                                        enc_lens)
        return logits, kvc.set_lengths(cache, kv_lens)

    def generate(self, enc_states, enc_lens, forced_ids: List[int],
                 max_new_tokens: int = 128,
                 timestamp_begin: Optional[int] = None,
                 temperature: float = 0.0,
                 seed: int = 0) -> List[int]:
        """Decode given the forced decoder prefix
        (<|startoftranscript|> [lang] [task] ...): greedy at temperature 0,
        softmax sampling above through a numpy `default_rng(seed)` on the
        host, as the JAX package does.  `timestamp_begin`: vocab id of
        <|0.00|> enables timestamp decoding with the whisper rules.  Tracks
        the chosen ids' logprobs in `self.last_avg_logprob`."""
        self._rng = np.random.default_rng(seed)
        self._logprobs: List[float] = []
        cfg = self.cfg
        b = enc_states.shape[0]
        prefix = [cfg.decoder_start_token_id] + list(forced_ids)
        logits, cache, cross = self._prefix_step(enc_states, enc_lens,
                                                 prefix, b)
        out = list(prefix)
        tok = self._pick(logits[0, -1], out, timestamp_begin, temperature)
        for _ in range(max_new_tokens):
            out.append(tok)
            if tok == cfg.eos_token_id:
                break
            toks = torch.full((b, 1), tok, dtype=torch.int32,
                              device=enc_states.device)
            logits, cache = self._step(toks, cache, cross, enc_lens)
            tok = self._pick(logits[0, -1], out, timestamp_begin,
                             temperature)
        # average only the kept tokens' logprobs: when the loop exhausts
        # max_new_tokens the trailing _pick's token is discarded
        kept = len(out) - len(prefix)
        self.last_avg_logprob = (float(np.mean(self._logprobs[:kept]))
                                 if kept > 0 else 0.0)
        return out

    def _finish(self, lg: np.ndarray, temperature: float) -> int:
        """Pick from rule-masked logits (greedy or sampled) and record the
        chosen token's logprob under the untempered distribution."""
        x = lg - lg.max()
        logz = np.log(np.exp(x[np.isfinite(x)]).sum())
        if temperature <= 0.0:
            tok = int(np.argmax(lg))
        else:
            xt = (lg - lg.max()) / temperature
            p = np.where(np.isfinite(xt), np.exp(xt), 0.0)
            p = p / p.sum()
            tok = int(self._rng.choice(len(p), p=p))
        self._logprobs.append(float(x[tok] - logz))
        return tok

    def _pick(self, logits, generated: List[int],
              ts_begin: Optional[int], temperature: float = 0.0) -> int:
        """Greedy argmax (or sampled at temperature > 0), with the whisper
        timestamp rules applied when timestamp decoding is on."""
        lg = _host(logits).copy()
        if ts_begin is None:
            return self._finish(lg, temperature)
        last_was_ts = bool(generated) and generated[-1] >= ts_begin
        penul_was_ts = len(generated) > 1 and generated[-2] >= ts_begin
        if last_was_ts and not penul_was_ts:
            # second of a pair: must be a timestamp (same or later)
            lg[: generated[-1]] = -np.inf
            return self._finish(lg, temperature)
        if last_was_ts and penul_was_ts:
            # a closed pair: next must be text or EOS
            lg[ts_begin:] = -np.inf
            return self._finish(lg, temperature)
        # monotonicity: never go back before the latest timestamp
        latest = max((t for t in generated if t >= ts_begin),
                     default=ts_begin)
        lg[ts_begin:latest] = -np.inf
        # force a timestamp when the timestamp mass beats the best text tok
        x = lg - lg.max()
        probs = np.exp(x) / np.exp(x).sum()
        if probs[ts_begin:].sum() > probs[: ts_begin].max():
            lg[: ts_begin] = -np.inf
        return self._finish(lg, temperature)

    def segments(self, ids: List[int], timestamp_begin: int,
                 time_precision: float = 0.02):
        """Split timestamped output into (start_s, end_s, token_ids)
        segments."""
        segs = []
        start = None
        buf: List[int] = []
        for t in ids:
            if t >= timestamp_begin:
                ts = (t - timestamp_begin) * time_precision
                if start is None:
                    start = ts
                else:
                    segs.append((start, ts, buf))
                    start, buf = None, []
            elif start is not None:
                buf.append(t)
        return segs

    def transcribe_ids(self, audio: np.ndarray, forced_ids: List[int],
                       max_new_tokens: int = 224) -> List[int]:
        states, enc_lens = self.encode_audio(audio)
        return self.generate(states, enc_lens, forced_ids, max_new_tokens)

    def detect_language(self, enc_states, enc_lens,
                        lang_ids: List[int]) -> np.ndarray:
        """Language auto-detect: one decoder step from
        <|startoftranscript|>, softmax restricted to the language tokens.
        Returns probabilities aligned with `lang_ids`."""
        logits, _, _ = self._prefix_step(
            enc_states, enc_lens, [self.cfg.decoder_start_token_id],
            enc_states.shape[0])
        lg = _host(logits[0, 0])[np.asarray(lang_ids)]
        x = lg - lg.max()
        p = np.exp(x)
        return p / p.sum()

    def generate_beam(self, enc_states, enc_lens, forced_ids,
                      num_beams: int = 4, max_new_tokens: int = 128,
                      length_penalty: float = 1.0) -> List[int]:
        return _beam_generate(self, enc_states, enc_lens, forced_ids,
                              num_beams, max_new_tokens, length_penalty)


# ---------------------------------------------------------------------------
# HF converter
# ---------------------------------------------------------------------------


def convert_whisper(sd: Dict[str, Any], hf_cfg: Dict[str, Any],
                    qspec=None, device=None) -> Tuple[Params, WhisperConfig]:
    """HF WhisperForConditionalGeneration state dict -> (params, cfg) on
    `device` (the card unless the CPU is asked for): float32 weights
    `[in, out]` (views of the state dict's `[out, in]` tensors), float32
    biases and LN params, or with `qspec` the linears whose smaller side
    reaches a group quantized on `device` (the JAX package's rule, K not
    repadded).  proj_out is tied to the float32 token embedding."""
    cfg = whisper_config_from_hf(hf_cfg)
    dev = resolve_device(device)

    def f32(name):
        return sd[name].to(dev, torch.float32)

    def lin(prefix, has_bias=True):
        w = f32(prefix + ".weight").t()                  # [in, out]
        if qspec is not None and min(w.shape) >= qspec.effective_group(
                w.shape[0]):
            from ..ops.quantize import quantize

            p = {"w": quantize(w.contiguous(), qspec)}
        else:
            p = {"w": w}
        if has_bias and prefix + ".bias" in sd:
            p["b"] = f32(prefix + ".bias")
        return p

    def nrm(prefix):
        return {"weight": f32(prefix + ".weight"),
                "bias": f32(prefix + ".bias")}

    def attn(prefix):
        return {"q": lin(prefix + ".q_proj"),
                "k": lin(prefix + ".k_proj", has_bias=False),
                "v": lin(prefix + ".v_proj"),
                "o": lin(prefix + ".out_proj")}

    enc_layers = []
    for i in range(cfg.encoder_layers):
        p = f"model.encoder.layers.{i}"
        enc_layers.append({
            "attn_norm": nrm(p + ".self_attn_layer_norm"),
            "attn": attn(p + ".self_attn"),
            "ffn_norm": nrm(p + ".final_layer_norm"),
            "fc1": lin(p + ".fc1"),
            "fc2": lin(p + ".fc2"),
        })
    dec_layers = []
    for i in range(cfg.decoder_layers):
        p = f"model.decoder.layers.{i}"
        dec_layers.append({
            "attn_norm": nrm(p + ".self_attn_layer_norm"),
            "attn": attn(p + ".self_attn"),
            "cross_norm": nrm(p + ".encoder_attn_layer_norm"),
            "cross": attn(p + ".encoder_attn"),
            "ffn_norm": nrm(p + ".final_layer_norm"),
            "fc1": lin(p + ".fc1"),
            "fc2": lin(p + ".fc2"),
        })

    embed = f32("model.decoder.embed_tokens.weight")
    params: Params = {
        "encoder": {
            "conv1": {"w": f32("model.encoder.conv1.weight"),
                      "b": f32("model.encoder.conv1.bias")},
            "conv2": {"w": f32("model.encoder.conv2.weight"),
                      "b": f32("model.encoder.conv2.bias")},
            "pos": f32("model.encoder.embed_positions.weight"),
            "layers": enc_layers,
            "final_norm": nrm("model.encoder.layer_norm"),
        },
        "decoder": {
            "embed": embed,
            "pos": f32("model.decoder.embed_positions.weight"),
            "layers": dec_layers,
            "final_norm": nrm("model.decoder.layer_norm"),
        },
        # proj_out is tied to the token embedding in whisper
        "proj_out": {"w": embed.t()},
    }
    return params, cfg


def _log_softmax(x: torch.Tensor) -> torch.Tensor:
    x = x - x.amax(dim=-1, keepdim=True)
    return x - torch.log(torch.exp(x).sum(dim=-1, keepdim=True))


def _beam_generate(model: WhisperModel, enc_states, enc_lens, forced_ids,
                   num_beams: int, max_new_tokens: int,
                   length_penalty: float = 1.0) -> List[int]:
    """Beam search: the encoder states repeated per beam, the self-attention
    cache at batch num_beams, beams reordered by `kv_cache.reorder` (a
    gather)."""
    cfg = model.cfg
    eos = cfg.eos_token_id
    prefix = [cfg.decoder_start_token_id] + list(forced_ids)
    dev = enc_states.device

    states = enc_states.repeat_interleave(num_beams, dim=0)
    lens = enc_lens.repeat_interleave(num_beams, dim=0)
    logits, cache, cross = model._prefix_step(states, lens, prefix,
                                              num_beams)
    logp = _host(_log_softmax(logits[:, -1].float()))
    beams = [list(prefix) for _ in range(num_beams)]
    # first expansion: top beams from beam 0 only (all identical so far)
    top = np.argsort(-logp[0])[:num_beams]
    scores = logp[0][top].astype(np.float64)
    nxt = [int(t) for t in top]
    finished: list = []

    for _ in range(max_new_tokens):
        for i in range(num_beams):
            beams[i] = beams[i] + [nxt[i]]
        live = [i for i in range(num_beams) if nxt[i] != eos]
        for i in range(num_beams):
            if nxt[i] == eos:
                lp = scores[i] / (len(beams[i]) - len(prefix)) ** (
                    length_penalty)
                finished.append((lp, beams[i]))
        if not live or len(finished) >= num_beams:
            break

        toks = torch.tensor(nxt, dtype=torch.int32, device=dev)[:, None]
        logits, cache = model._step(toks, cache, cross, lens)
        logp = _host(_log_softmax(logits[:, 0].float()))

        cand = []
        for i in live:
            top = np.argsort(-logp[i])[: 2 * num_beams]
            for t in top:
                cand.append((scores[i] + float(logp[i][t]), i, int(t)))
        cand.sort(key=lambda c: -c[0])
        cand = cand[:num_beams]
        src = np.asarray([c[1] for c in cand], np.int32)
        # pad the beam set if fewer live candidates than beams
        while len(cand) < num_beams:
            cand.append(cand[-1])
            src = np.append(src, src[-1])
        cache = kvc.reorder(cache, torch.from_numpy(src))
        beams = [list(beams[c[1]]) for c in cand]
        scores = np.asarray([c[0] for c in cand])
        nxt = [c[2] for c in cand]

    if not finished:
        for i in range(num_beams):
            lp = scores[i] / max(len(beams[i]) - len(prefix), 1) ** (
                length_penalty)
            finished.append((lp, beams[i]))
    finished.sort(key=lambda f: -f[0])
    return finished[0][1]
