"""Whisper in the port (`neural_speed_tpu_torch.models.whisper`,
`ops/mel.py`, `api.AudioModel`) against the JAX package on the CPU.

A tiny whisper (d_model 128, 2 heads of 64, 2 + 2 layers, whisper's
51865-token vocabulary, 1500 encoder frames, 448 decoder positions) is
drawn from a seed with numpy in the HF `WhisperForConditionalGeneration`
layout: linear weights N(0, 1 / fan_in) (random HF-init weights of
std 0.02 give nearly flat logits, whose greedy ids would hang on
last-bit ties), the token embedding N(0, 0.5^2), the position embeddings
N(0, 4^2) (smaller ones let the tied head map a token to itself, so that
every greedy step repeats it).  Both packages convert
the same state dict; the JAX package runs its XLA path (float32
attention: whisper never reaches a Pallas kernel there), the port its
kernels' plain versions, which round q, K, V and P to bf16 as the kernels
do.  So floats agree within stated tolerances, not bit for bit:

* encoder states within ENC_TOL (largest |state| ~4);
* logits within LOGIT_TOL (largest |logit| ~40);
* greedy, timestamp, sampled and beam ids identical, with the greedy
  steps' top-2 margins (after the timestamp rules) above LOGIT_TOL.

The mel front-end is bit-equal; the converted trees, the beam search's
`reorder` and the safetensors round trip are equal bit for bit.
"""

import dataclasses
import math
import wave

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu import api as japi
from neural_speed_tpu.models import whisper as JW
from neural_speed_tpu.ops import kv_cache as jkv
from neural_speed_tpu.ops import mel as jmel
from neural_speed_tpu.ops.qtypes import named_qspec as j_named_qspec
from neural_speed_tpu_torch import _build
from neural_speed_tpu_torch import api as tapi
from neural_speed_tpu_torch.convert import loaders as tload
from neural_speed_tpu_torch.models import whisper as TW
from neural_speed_tpu_torch.models.params import params_from_numpy
from neural_speed_tpu_torch.ops import kv_cache as tkv
from neural_speed_tpu_torch.ops import mel as tmel
from neural_speed_tpu_torch.ops import quantize as tquant
from neural_speed_tpu_torch.ops.qtypes import named_qspec
from neural_speed_tpu_torch.utils import synthetic as syn

from tests.torch_port_util import (assert_tree_equal, to_numpy,
                                   torch_to_numpy, tree_to_numpy)

torch.set_num_threads(1)

TINY_HF = dict(
    model_type="whisper", vocab_size=51865, d_model=128, encoder_layers=2,
    decoder_layers=2, encoder_attention_heads=2, decoder_attention_heads=2,
    encoder_ffn_dim=256, decoder_ffn_dim=256, num_mel_bins=80,
    max_source_positions=1500, max_target_positions=448,
    decoder_start_token_id=50258, eos_token_id=50257)
# the params seed, searched on the CPU for greedy ids that change from step
# to step, greedy / timestamp margins above LOGIT_TOL and sampled rungs
# that agree; the audio's seed
SEED = 14
AUDIO_SEED = 3
ENC_TOL = 0.02
LOGIT_TOL = 0.25
FORCED = [50259, 50359, 50363]   # <|en|> <|transcribe|> <|notimestamps|>
TS_FORCED = [50259, 50359]
TS_BEGIN = 50364                 # <|0.00|>
# the timestamp tokens' embedding rows (tied to the LM head) drawn at this
# multiple of the others' scale, so that random weights emit timestamps
# and the timestamp rules run
TS_GAIN = 2.0
# the position embeddings' scale, above the token rows': with small ones
# the tied head maps a token to itself and every greedy step repeats it
POS_SCALE = 4.0
STEPS = 10


def draw_state_dict(seed: int):
    """The tiny whisper's HF state dict (float32 CPU tensors) from numpy."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, shape in syn.whisper_hf_shapes(TINY_HF).items():
        x = rng.standard_normal(shape).astype(np.float32)
        if "layer_norm" in name:
            x = (1.0 if name.endswith("weight") else 0.0) + 0.1 * x
        elif name.endswith("embed_tokens.weight"):
            x = 0.5 * x
            x[TS_BEGIN:] *= TS_GAIN
        elif "embed_positions" in name:
            x = POS_SCALE * x
        elif name.endswith("bias"):
            x = 0.02 * x
        else:                               # linears [out, in], convs
            x = x / math.sqrt(int(np.prod(shape[1:])))
        sd[name] = torch.from_numpy(x)
    return sd


def audio_of(seed: int, seconds: float = 3.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    tone = 0.3 * np.sin(2 * np.pi * 440.0 * np.arange(n) / 16000)
    return (tone + 0.05 * rng.standard_normal(n)).astype(np.float32)


@pytest.fixture(scope="module")
def sd():
    return draw_state_dict(SEED)


@pytest.fixture(scope="module")
def models(sd):
    jp, jc = JW.convert_whisper(sd, TINY_HF)
    tp, tc = TW.convert_whisper(sd, TINY_HF, device="cpu")
    return jp, jc, tp, tc


@pytest.fixture(scope="module")
def states(models):
    """Encoder states of both packages for one mel: (JAX numpy, port)."""
    jp, jc, tp, tc = models
    mel = jmel.log_mel_spectrogram(audio_of(AUDIO_SEED))
    sj = np.asarray(JW.encode(jp, jc, jnp.asarray(mel)[None]))
    st = TW.encode(tp, tc, torch.from_numpy(mel)[None])
    return sj, st


def _lens(n: int, b: int = 1):
    return (jnp.full((b,), n, jnp.int32),
            torch.full((b,), n, dtype=torch.int32))


def _j_states(sj):
    return jnp.asarray(sj)


def _t_states(sj):
    """The JAX states as the port's input: the decoder tests feed both
    packages the same encoder output."""
    return torch.from_numpy(sj.copy())


# ---------------------------------------------------------------------------
# mel, converter, params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [16000 * 2, tmel.N_SAMPLES,
                               tmel.N_SAMPLES + 1234],
                         ids=["2s", "30s", "over30s"])
def test_mel_bit_equal(n):
    """`log_mel_spectrogram` (padded to 30 s, or cut) and its parts equal
    the JAX package's numpy module bit for bit."""
    rng = np.random.default_rng(n)
    audio = (0.1 * rng.standard_normal(n)).astype(np.float32)
    np.testing.assert_array_equal(tmel.log_mel_spectrogram(audio),
                                  jmel.log_mel_spectrogram(audio))
    np.testing.assert_array_equal(tmel.mel_filter_bank(),
                                  jmel.mel_filter_bank())
    f = np.linspace(0, 8000, 97)
    np.testing.assert_array_equal(tmel.mel_to_hertz(tmel.hertz_to_mel(f)),
                                  jmel.mel_to_hertz(jmel.hertz_to_mel(f)))


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_convert_whisper_trees_equal(sd, quant):
    """`convert_whisper` gives the JAX package's tree leaf for leaf (float32
    weights `[in, out]`, biases, LN params; int8 g128 QTensors bit for bit),
    and `params_from_numpy` carries the JAX tree across equal."""
    jq = j_named_qspec("int8", group_size=128) if quant else None
    tq = named_qspec("int8", group_size=128) if quant else None
    jp, jc = JW.convert_whisper(sd, TINY_HF, jq)
    tp, tc = TW.convert_whisper(sd, TINY_HF, tq, device="cpu")
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert_tree_equal(jp, tp)
    assert_tree_equal(jp, params_from_numpy(tree_to_numpy(jp),
                                            device="cpu"))


def test_whisper_hf_shapes_match_transformers():
    """`whisper_hf_shapes` names every tensor of transformers'
    `WhisperForConditionalGeneration` with its shape (but the tied
    proj_out), and whisper-large-v2's config converts to its published
    sizes."""
    from transformers import WhisperConfig, WhisperForConditionalGeneration

    hf = {k: v for k, v in TINY_HF.items() if k != "model_type"}
    m = WhisperForConditionalGeneration(WhisperConfig(**hf))
    want = {k: tuple(v.shape) for k, v in m.state_dict().items()
            if k != "proj_out.weight"}
    assert syn.whisper_hf_shapes(TINY_HF) == want
    cfg = TW.whisper_config_from_hf(syn.whisper_large_v2_config())
    assert (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.encoder_layers,
            cfg.decoder_layers, cfg.ffn_dim, cfg.vocab_size) == (
        1280, 20, 64, 32, 32, 5120, 51865)
    n = sum(math.prod(s) for s in syn.whisper_hf_shapes(
        syn.whisper_large_v2_config()).values())
    assert 1.54e9 < n < 1.55e9


def test_write_safetensors_round_trip(tmp_path, sd):
    """`write_safetensors` writes a file that the port's reader reads back
    bit for bit (float32, bf16, int8) and the `safetensors` package reads
    too (numpy has no bf16: float32 and int8 there)."""
    from safetensors.numpy import load_file

    tensors = dict(list(sd.items())[:5])
    tensors["b"] = torch.arange(-7, 9, dtype=torch.int8).reshape(4, 4)
    tensors["h"] = torch.linspace(-3, 3, 12).to(torch.bfloat16)
    path = str(tmp_path / "x.safetensors")
    syn.write_safetensors(path, tensors)
    back = tload.read_safetensors(path)
    assert list(back) == list(tensors)
    for k, v in tensors.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k
    tensors.pop("h")
    syn.write_safetensors(path, tensors)
    lib = load_file(path)
    for k, v in tensors.items():
        np.testing.assert_array_equal(lib[k], v.numpy())


# ---------------------------------------------------------------------------
# encoder and decoder
# ---------------------------------------------------------------------------


def test_encode_matches_jax(models, states):
    """`encode` (exact float32 convolutions, the non-causal attention
    through kernel C's plain version over 1500 frames laid out at 1536)
    within ENC_TOL of the JAX package's."""
    jp, jc, tp, tc = models
    sj, st = states
    assert st.shape == sj.shape == (1, 1500, 128) and st.dtype == torch.float32
    np.testing.assert_allclose(st.numpy(), sj, rtol=0, atol=ENC_TOL)
    mel = torch.from_numpy(jmel.log_mel_spectrogram(audio_of(AUDIO_SEED)))[None]
    before = _build.plain_dispatches["flash_prefill_f32_noncausal"]
    TW.encode(tp, tc, mel)
    assert (_build.plain_dispatches["flash_prefill_f32_noncausal"]
            == before + jc.encoder_layers)


def test_conv_front_end_is_exact_float32(models):
    """The unfold + matmul convolutions equal `conv1d` in float64 to float32
    precision, at stride 1 and 2."""
    _, _, tp, _ = models
    x = torch.randn((1, 80, 300), generator=torch.Generator().manual_seed(1))
    p = tp["encoder"]["conv1"]
    got = TW._conv1d(x.transpose(1, 2), p, 1).transpose(1, 2)
    want = torch.nn.functional.conv1d(x.double(), p["w"].double(),
                                      p["b"].double(), padding=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)
    h = torch.nn.functional.gelu(got)
    p = tp["encoder"]["conv2"]
    got = TW._conv1d(h.transpose(1, 2), p, 2).transpose(1, 2)
    want = torch.nn.functional.conv1d(h.double(), p["w"].double(),
                                      p["b"].double(), stride=2, padding=1)
    assert got.shape == (1, 128, 150)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)


def test_cross_kv_layout_matches_jax(models, states):
    """`cross_kv` hands the decoder K/V in the kernels' stacked layout
    `[L, B, H, 1536, D]` with zero rows past 1500; laid back out as the JAX
    package's per-layer `[B, S, H, D]` K/V, equal to them within float32
    rounding."""
    jp, jc, tp, tc = models
    sj, _ = states
    jkvs = JW.cross_kv(jp, jc, _j_states(sj))
    k_all, v_all = TW.cross_kv(tp, tc, _t_states(sj))
    assert k_all.shape == (2, 1, 2, 1536, 64) and k_all.dtype == torch.float32
    assert not k_all[:, :, :, 1500:].any() and not v_all[:, :, :, 1500:].any()
    for i, (jk, jv) in enumerate(jkvs):
        for got, want in ((k_all, jk), (v_all, jv)):
            np.testing.assert_allclose(
                got[i, :, :, :1500].transpose(1, 2).numpy(),
                np.asarray(want), atol=1e-5)


def test_decoder_forward_matches_jax(models, states):
    """`decoder_forward` over the forced prefix (T = 4: kernel C causal over
    the float32 cache, non-causal over the cross K/V) and three decode
    steps (kernel B, both variants) feeding JAX's greedy tokens: logits
    within LOGIT_TOL, the float32 caches' K/V within ENC_TOL (they are
    projections of hidden states that carry the attention's bf16
    rounding)."""
    jp, jc, tp, tc = models
    sj, _ = states
    jl, tl = _lens(1500)
    jcache = jkv.init_cache(2, 1, 448, 2, 64, jnp.float32)
    tcache = tkv.init_cache(2, 1, 448, 2, 64, torch.float32, device="cpu")
    jcross = tuple(JW.cross_kv(jp, jc, _j_states(sj)))
    tcross = TW.cross_kv(tp, tc, _t_states(sj))
    toks = [jc.decoder_start_token_id] + FORCED
    names = ["flash_prefill_f32", "flash_prefill_f32_noncausal",
             "flash_decode_f32", "flash_decode_f32_noncausal"]
    before = [_build.plain_dispatches[n] for n in names]
    n = 0
    for step in range(4):
        cur = toks if step == 0 else [nxt]
        t = len(cur)
        pos = np.arange(n, n + t, dtype=np.int32)[None]
        lens = np.array([n + t], np.int32)
        lj, jcache = JW.decoder_forward(
            jp, jc, jnp.asarray([cur], jnp.int32), jnp.asarray(pos), jcache,
            jnp.asarray(lens), jcross, jl)
        jcache = jkv.set_lengths(jcache, jnp.asarray(lens))
        lt, tcache = TW.decoder_forward(
            tp, tc, torch.tensor([cur], dtype=torch.int32),
            torch.from_numpy(pos), tcache, torch.from_numpy(lens), tcross,
            tl)
        tkv.set_lengths(tcache, torch.from_numpy(lens))
        lj = np.asarray(lj)
        assert lt.shape == lj.shape and lt.dtype == torch.float32
        np.testing.assert_allclose(lt.numpy(), lj, rtol=0, atol=LOGIT_TOL)
        nxt = int(np.argmax(lj[0, -1]))
        n += t
    for name in ("k", "v"):
        np.testing.assert_allclose(torch_to_numpy(getattr(tcache, name)),
                                   to_numpy(getattr(jcache, name)), rtol=0,
                                   atol=ENC_TOL)
    got = [_build.plain_dispatches[n] - b for n, b in zip(names, before)]
    assert got == [2, 2, 6, 6]


# ---------------------------------------------------------------------------
# generation
# ---------------------------------------------------------------------------


def _record_margins(monkeypatch):
    """Record the top-2 margin of every greedy pick of the JAX model (the
    logits after the timestamp rules)."""
    margins = []
    orig = JW.WhisperModel._finish

    def finish(self, lg, temperature):
        fin = np.sort(lg[np.isfinite(lg)])
        margins.append(float(fin[-1] - fin[-2]))
        return orig(self, lg, temperature)

    monkeypatch.setattr(JW.WhisperModel, "_finish", finish)
    return margins


@pytest.mark.parametrize("timestamps", [False, True],
                         ids=["plain", "timestamps"])
def test_greedy_generate_matches_jax(models, states, monkeypatch,
                                     timestamps):
    """Greedy `generate`, without and with whisper's timestamp rules:
    identical ids, the JAX picks' top-2 margins above LOGIT_TOL, and
    `last_avg_logprob` within LOGIT_TOL; the segments equal."""
    jp, jc, tp, tc = models
    sj, _ = states
    jl, tl = _lens(1500)
    forced, ts = (TS_FORCED, TS_BEGIN) if timestamps else (FORCED, None)
    margins = _record_margins(monkeypatch)
    jm, tm = JW.WhisperModel(jp, jc), TW.WhisperModel(tp, tc)
    ij = jm.generate(_j_states(sj), jl, forced, STEPS, timestamp_begin=ts)
    it = tm.generate(_t_states(sj), tl, forced, STEPS, timestamp_begin=ts)
    assert it == ij
    # the draw is not degenerate: the picks change from step to step
    new = ij[len(forced) + 1:]
    assert len(set(new)) > len(new) // 2, new
    assert min(margins) > LOGIT_TOL, margins
    assert abs(tm.last_avg_logprob - jm.last_avg_logprob) < LOGIT_TOL
    if timestamps:
        assert any(t >= TS_BEGIN for t in ij[len(forced) + 1:])
        assert tm.segments(it, TS_BEGIN) == jm.segments(ij, TS_BEGIN)


@pytest.mark.parametrize("temperature,seed", [(0.4, 1), (1.0, 5)],
                         ids=["t0.4", "t1.0"])
def test_sampled_rung_matches_jax(models, states, temperature, seed):
    """A sampled rung of the temperature ladder with the same seed (numpy's
    `default_rng` on the host in both packages): the same ids and
    `last_avg_logprob` within LOGIT_TOL."""
    jp, jc, tp, tc = models
    sj, _ = states
    jl, tl = _lens(1500)
    jm, tm = JW.WhisperModel(jp, jc), TW.WhisperModel(tp, tc)
    ij = jm.generate(_j_states(sj), jl, FORCED, STEPS,
                     temperature=temperature, seed=seed)
    it = tm.generate(_t_states(sj), tl, FORCED, STEPS,
                     temperature=temperature, seed=seed)
    assert it == ij
    assert abs(tm.last_avg_logprob - jm.last_avg_logprob) < LOGIT_TOL


def test_detect_language_matches_jax(models, states):
    """`detect_language` over the 99 language tokens: the same argmax and
    probabilities within 0.02."""
    jp, jc, tp, tc = models
    sj, _ = states
    jl, tl = _lens(1500)
    ids = list(range(50259, 50358))
    pj = JW.WhisperModel(jp, jc).detect_language(_j_states(sj), jl, ids)
    pt = TW.WhisperModel(tp, tc).detect_language(_t_states(sj), tl, ids)
    assert int(np.argmax(pt)) == int(np.argmax(pj))
    np.testing.assert_allclose(pt, pj, rtol=0, atol=0.02)
    assert abs(pt.sum() - 1.0) < 1e-6


def test_generate_beam_matches_jax(models, states):
    """`generate_beam` with 3 beams (kernel B at B = 3, `reorder` every
    step): identical ids."""
    jp, jc, tp, tc = models
    sj, _ = states
    jl, tl = _lens(1500)
    ij = JW.WhisperModel(jp, jc).generate_beam(_j_states(sj), jl, FORCED,
                                               num_beams=3, max_new_tokens=6)
    it = TW.WhisperModel(tp, tc).generate_beam(_t_states(sj), tl, FORCED,
                                               num_beams=3, max_new_tokens=6)
    assert it == ij
    new = ij[len(FORCED) + 1:]
    assert len(set(new)) > len(new) // 2, new


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["float32", "int8"])
def test_reorder_bit_equal(quantized):
    """`kv_cache.reorder` gathers every tensor and the lengths over the
    slot axis as the JAX function does, bit for bit, into a new cache."""
    rng = np.random.default_rng(7)
    shape = (2, 4, 2, 64, 8)
    if quantized:
        k, v = (rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2))
        ks, vs = (rng.uniform(0.01, 0.03, shape[:4]).astype(np.float32)
                  for _ in range(2))
    else:
        k, v = (rng.standard_normal(shape).astype(np.float32)
                for _ in range(2))
        ks = vs = None
    lens = np.array([5, 9, 2, 64], np.int32)
    src = np.array([2, 2, 0, 3], np.int32)
    opt_j = lambda a: None if a is None else jnp.asarray(a)
    opt_t = lambda a: None if a is None else torch.from_numpy(a.copy())
    jc = jkv.reorder(jkv.KVCache(*(opt_j(a) for a in (k, v, ks, vs, lens))),
                     jnp.asarray(src))
    old = tkv.KVCache(*(opt_t(a) for a in (k, v, ks, vs, lens)))
    tc = tkv.reorder(old, torch.from_numpy(src))
    for name in ("k", "v", "k_scale", "v_scale", "lengths"):
        want, got = getattr(jc, name), getattr(tc, name)
        assert (want is None) == (got is None), name
        if got is not None:
            np.testing.assert_array_equal(torch_to_numpy(got), to_numpy(want))
    assert torch.equal(old.k, torch.from_numpy(k))


# ---------------------------------------------------------------------------
# AudioModel
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def saved(tmp_path_factory, sd):
    """The tiny whisper saved by transformers (`config.json` +
    `model.safetensors`), and a 3-second 16-bit wav."""
    from transformers import WhisperConfig, WhisperForConditionalGeneration

    d = tmp_path_factory.mktemp("tiny_whisper")
    hf = {k: v for k, v in TINY_HF.items() if k != "model_type"}
    m = WhisperForConditionalGeneration(WhisperConfig(**hf))
    missing, unexpected = m.load_state_dict(sd, strict=False)
    assert not unexpected and set(missing) <= {"proj_out.weight"}
    m.save_pretrained(str(d))
    wav = str(d / "clip.wav")
    pcm = np.clip(audio_of(AUDIO_SEED + 1) * 32768.0, -32768, 32767)
    with wave.open(wav, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.astype(np.int16).tobytes())
    return str(d), wav


@pytest.mark.parametrize("timestamps", [False, True],
                         ids=["ids", "timestamps"])
def test_audio_model_transcribe_matches_jax(saved, timestamps):
    """`AudioModel().init(dir)` + `transcribe(wav)` (no tokenizer: token
    ids, or segments of ids with timestamps; the temperature-fallback
    ladder) against the JAX `AudioModel` on the same directory: the same
    output, and `load_wav` bit-equal."""
    d, wav = saved
    np.testing.assert_array_equal(tapi.load_wav(wav), japi.load_wav(wav))
    jm = japi.AudioModel().init(d)
    assert jm.tokenizer is None
    tm = tapi.AudioModel().init(d, device="cpu")
    want = jm.transcribe(wav, max_new_tokens=6, timestamps=timestamps)
    got = tm.transcribe(wav, max_new_tokens=6, timestamps=timestamps)
    assert got == want
    assert tm.model.device.type == "cpu"


# the quantized formats of the CPU route: the AudioModel default (int8
# g128, P's one-plane INT instances on the card), nf4 (F) and asymmetric
# int5 (P)
QUANT = {"int8": ("int8", True), "nf4": ("nf4", True),
         "int5-asym": ("int5", False)}


def _prefix_logits_jax(jp, jc, sj, jl):
    cache = jkv.init_cache(jc.decoder_layers, 1, 448, jc.n_heads,
                           jc.head_dim, jnp.float32)
    toks = [jc.decoder_start_token_id] + FORCED
    n = len(toks)
    lj, _ = JW.decoder_forward(
        jp, jc, jnp.asarray([toks], jnp.int32),
        jnp.arange(n, dtype=jnp.int32)[None], cache,
        jnp.full((1,), n, jnp.int32), tuple(JW.cross_kv(jp, jc, sj)), jl)
    return np.asarray(lj)


def _prefix_logits_port(tp, tc, st, tl):
    cache = tkv.init_cache(tc.decoder_layers, 1, 448, tc.n_heads,
                           tc.head_dim, torch.float32, device="cpu")
    toks = [tc.decoder_start_token_id] + FORCED
    n = len(toks)
    lt, _ = TW.decoder_forward(
        tp, tc, torch.tensor([toks], dtype=torch.int32),
        torch.arange(n, dtype=torch.int32)[None], cache,
        torch.full((1,), n, dtype=torch.int32), TW.cross_kv(tp, tc, st), tl)
    return lt.numpy()


@pytest.mark.parametrize("fmt", sorted(QUANT))
def test_quantized_route_on_the_cpu(sd, states, fmt):
    """`convert_whisper(..., qspec)` on the CPU (float32 activations through
    `qmatmul`'s plain version) in int8, nf4 and asymmetric int5 at g128:
    every linear quantized (d_model 128 and ffn 256 reach the group), the
    prefix logits within LOGIT_TOL of the JAX package's quantized model and
    the greedy ids equal."""
    name, sym = QUANT[fmt]
    sj, _ = states
    jp, jc = JW.convert_whisper(sd, TINY_HF, j_named_qspec(name, 128, sym))
    tp, tc = TW.convert_whisper(sd, TINY_HF, named_qspec(name, 128, sym),
                                device="cpu")
    assert isinstance(tp["encoder"]["layers"][0]["fc1"]["w"], tquant.QTensor)
    assert isinstance(tp["decoder"]["layers"][0]["cross"]["k"]["w"],
                      tquant.QTensor)
    jl, tl = _lens(1500)
    before = _build.plain_dispatches["qmatmul"]
    lt = _prefix_logits_port(tp, tc, _t_states(sj), tl)
    assert _build.plain_dispatches["qmatmul"] > before
    lj = _prefix_logits_jax(jp, jc, _j_states(sj), jl)
    assert lt.dtype == np.float32
    np.testing.assert_allclose(lt, lj, rtol=0, atol=LOGIT_TOL)
    ij = JW.WhisperModel(jp, jc).generate(_j_states(sj), jl, FORCED, 6)
    it = TW.WhisperModel(tp, tc).generate(_t_states(sj), tl, FORCED, 6)
    assert it == ij


def test_quantized_audio_model_matches_jax(saved):
    """`AudioModel().init(dir, use_quant=True, device="cpu")` (int8 g128, the
    default format) transcribes the wav as the JAX package's
    `AudioModel().init(dir, use_quant=True)` does."""
    d, wav = saved
    jm = japi.AudioModel().init(d, use_quant=True)
    tm = tapi.AudioModel().init(d, use_quant=True, device="cpu")
    assert isinstance(tm.model.params["decoder"]["layers"][0]["fc1"]["w"],
                      tquant.QTensor)
    assert (tm.transcribe(wav, max_new_tokens=6)
            == jm.transcribe(wav, max_new_tokens=6))


def test_serving_path_leaves_tf32_off(models, states):
    """The port never turns TF32 on: the flags are as they were after
    encoding and generating."""
    jp, jc, tp, tc = models
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    _, tl = _lens(1500)
    mel = torch.from_numpy(tmel.log_mel_spectrogram(audio_of(3)))[None]
    st = TW.encode(tp, tc, mel)
    TW.WhisperModel(tp, tc).generate(st, tl, FORCED, 2)
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision()) == flags
    assert flags[0] is False and flags[2] == "highest"


def test_segments_and_compression_ratio_match_jax(models):
    """The host helpers: `segments` and `_compression_ratio`."""
    jp, jc, tp, tc = models
    ids = [50258, 50364, 7, 8, 50380, 50390, 9, 50400, 50410, 3]
    assert (TW.WhisperModel(tp, tc).segments(ids, TS_BEGIN)
            == JW.WhisperModel(jp, jc).segments(ids, TS_BEGIN))
    for data in (b"", b"abc" * 40, bytes(range(200))):
        assert (tapi.AudioModel._compression_ratio(data)
                == japi.AudioModel._compression_ratio(data))
