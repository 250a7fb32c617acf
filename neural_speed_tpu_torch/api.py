"""User-facing API (port of `neural_speed_tpu/api.py`): `Model` and the
`ModelServer` function (continuous-batching serving), and `AudioModel`
(whisper transcription) with `load_wav`.

The port imports only torch, numpy and the standard library: `init` reads
`config.json` with `json` and the weights with `convert/loaders.
load_state_dict` (a local directory), and the tokenizer is an optional
argument (any object with the `transformers` tokenizer methods used here:
`__call__` / `decode` for `Model`, `convert_tokens_to_ids`, `decode`,
`unk_token_id` for `AudioModel`).  Without one, `Model.eos_id` is None and
`transcribe` returns token ids (or segments of ids), as the JAX classes do
when their tokenizer fails to load.  Models run on the card unless
`device="cpu"` is passed.

Serving: `Model().init(dir, ...)` (or `init_from_gguf(path)`) builds an
`Engine` or, with `paged=True`, a `PagedEngine`; `generate` runs the
prompts through `runtime/scheduler.ContinuousBatchingScheduler`;
`ModelServer(model, response_fn, ...)` serves `issue_query` calls from a
worker thread (`runtime/server.py`).  Not ported, and raising with the
ROADMAP section 1 item that ports them: `use_cache`, `session_path`,
`quant_model`, `save_state`, `load_state` (item 6); `lora_path`,
`init_from_bin`, `init_from_ne_bin` (item 8); `num_beams > 1`,
`prefix_cache=True` (item 5); `tp > 1` (item 9).  `generate(speculative=
True)` runs prompt-lookup speculative decoding (`runtime/speculative.py`):
one prompt over a contiguous engine through the single-sequence helpers,
batches and paged engines through the scheduler's joint steps; `ModelServer`
takes `speculative` / `spec_k` and `mixed_prefill` / `mixed_chunk`.
"""

from __future__ import annotations

import json
import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .ops.qtypes import named_qspec


def _refuse(what: str, item: int) -> None:
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP section 1, "
                              f"item {item})")


class Model:
    def __init__(self):
        self.engine = None
        self.cfg = None
        self.tokenizer = None
        self.eos_id: Optional[int] = None

    # ------------------------------------------------------------------
    def init(
        self,
        model_name: str,
        use_quant: bool = True,
        weight_dtype: str = "int4",
        group_size: int = 128,
        scale_dtype: str = "fp32",
        alg: str = "sym",
        use_cache: bool = False,
        max_batch: int = 1,
        ctx_size: int = 2048,
        kv_quantized: bool = False,
        model_file: Optional[str] = None,
        lora_path: Optional[str] = None,
        lora_scale: Optional[float] = None,
        tp: int = 1,
        paged: bool = False,
        page_size: int = 128,
        n_pages: Optional[int] = None,
        prefix_cache: bool = False,
        memory_dtype: str = "auto",
        device=None,
        tokenizer=None,
    ):
        """Convert (and with `use_quant` quantize: `weight_dtype`,
        `group_size`, `scale_dtype` "fp32" / "bf16", `alg` "sym" / "asym")
        a local HF checkpoint directory (`config.json` and `*.safetensors`
        or `pytorch_model*.bin`) on `device` (the card unless the CPU is
        asked for), then build the engine (`_make_engine`).  `tokenizer`
        sets `eos_id` from its `eos_token_id`."""
        from ._build import resolve_device
        from .convert import loaders
        from .convert.hf import params_from_state_dict
        from .models.configs import arch_from_hf_config

        if use_cache:
            _refuse("the packed-model cache (use_cache)", 6)
        if lora_path is not None:
            _refuse("LoRA adapters (lora_path)", 8)
        self._check_engine_args(tp, prefix_cache)
        # the device first: the weights are converted and quantized there
        device = resolve_device(device)
        with open(os.path.join(model_name, "config.json")) as f:
            hf_cfg = json.load(f)
        self.cfg = arch_from_hf_config(hf_cfg)
        self._set_tokenizer(tokenizer)
        qspec = None
        if use_quant:
            qspec = named_qspec(
                weight_dtype, group_size=group_size,
                symmetric=(alg == "sym"),
                scale_dtype={"fp32": "float32", "bf16": "bfloat16"}.get(
                    scale_dtype, "float32"))
        sd = loaders.load_state_dict(model_name)
        params = params_from_state_dict(sd, self.cfg, qspec, device=device)
        del sd
        self._make_engine(params, max_batch, ctx_size, kv_quantized, tp=tp,
                          paged=paged, page_size=page_size, n_pages=n_pages,
                          prefix_cache=prefix_cache,
                          memory_dtype=memory_dtype, device=device)
        return self

    def _set_tokenizer(self, tokenizer) -> None:
        self.tokenizer = tokenizer
        self.eos_id = (None if tokenizer is None
                       else getattr(tokenizer, "eos_token_id", None))

    @staticmethod
    def _check_engine_args(tp: int, prefix_cache: bool) -> None:
        if tp > 1:
            _refuse("tensor-parallel serving (tp > 1)", 9)
        if prefix_cache:
            _refuse("prefix caching (prefix_cache=True)", 5)

    def init_from_bin(self, *args, **kwargs):
        _refuse("packed-model files (init_from_bin)", 8)

    def init_from_ne_bin(self, *args, **kwargs):
        _refuse("NE 'ggjt' files (init_from_ne_bin)", 8)

    def init_from_gguf(self, gguf_path: str, max_batch: int = 1,
                       ctx_size: int = 2048, kv_quantized: bool = False,
                       tp: int = 1, paged: bool = False,
                       page_size: int = 128, n_pages: Optional[int] = None,
                       prefix_cache: bool = False,
                       memory_dtype: str = "auto", device=None,
                       tokenizer=None):
        """A GGUF file of the llama or mixtral arch
        (`convert/gguf.load_gguf_model`), decoded on `device`."""
        from .convert import gguf as gguf_mod

        self._check_engine_args(tp, prefix_cache)
        params, cfg, _tok = gguf_mod.load_gguf_model(gguf_path, device=device)
        self.cfg = cfg
        self._set_tokenizer(tokenizer)
        self._make_engine(params, max_batch, ctx_size, kv_quantized, tp=tp,
                          paged=paged, page_size=page_size, n_pages=n_pages,
                          prefix_cache=prefix_cache,
                          memory_dtype=memory_dtype, device=device)
        return self

    def _make_engine(self, params, max_batch, ctx_size, kv_quantized,
                     tp: int = 1, paged: bool = False, page_size: int = 128,
                     n_pages: Optional[int] = None,
                     prefix_cache: bool = False,
                     memory_dtype: str = "auto", device=None):
        """The engine over `params`: the KV memory type `memory_dtype`
        (auto / f16 / bf16: bf16; f32; int8: the quantized cache, as
        `kv_quantized`), `paged` with `page_size` and `n_pages`."""
        from .runtime.engine import Engine, PagedEngine

        self._check_engine_args(tp, prefix_cache)
        if memory_dtype in ("auto", "f16", "bf16"):
            kv_dtype = torch.bfloat16
        elif memory_dtype == "f32":
            kv_dtype = torch.float32
        elif memory_dtype == "int8":
            kv_dtype, kv_quantized = torch.bfloat16, True
        else:
            raise ValueError(f"unknown memory_dtype {memory_dtype!r}")
        if paged:
            self.engine = PagedEngine(
                params, self.cfg, max_batch=max_batch, max_len=ctx_size,
                kv_quantized=kv_quantized, page_size=page_size,
                n_pages=n_pages, kv_dtype=kv_dtype, device=device)
            return
        self.engine = Engine(
            params, self.cfg, max_batch=max_batch, max_len=ctx_size,
            kv_quantized=kv_quantized, kv_dtype=kv_dtype, device=device)

    # ------------------------------------------------------------------
    def generate(
        self,
        input_ids,
        max_new_tokens: int = 128,
        do_sample: bool = False,
        temperature: float = 0.8,
        top_k: int = 40,
        top_p: float = 0.95,
        repetition_penalty: float = 1.1,
        num_beams: int = 1,
        early_stopping: bool = False,
        length_penalty: float = 1.0,
        seed: int = 0,
        streamer: Optional[Callable[[int], None]] = None,
        stopping_criteria: Optional[Callable[[List[int]], bool]] = None,
        ignore_prompt: bool = False,
        session_path: Optional[str] = None,
        speculative: bool = False,
        speculative_k: int = 7,
        **kwargs,
    ):
        """HF-style generate over the continuous-batching scheduler: greedy
        or sampled, with the repetition penalty (1.1 by default, as the JAX
        package), a `streamer(token)` callback and `stopping_criteria(ids)`
        (checked between tokens: it makes the scheduler step one token at a
        time).  `speculative=True` verifies up to `speculative_k` draft
        tokens per forward: greedy output is the greedy sequence, sampled
        output is distributed as sequential sampling.  Returns prompt +
        generated ids per prompt (generated only with `ignore_prompt`)."""
        from .ops.sampling import SamplingParams
        from .runtime.scheduler import ContinuousBatchingScheduler
        from .utils.profiler import verbose_level

        if kwargs:
            import warnings

            warnings.warn("ignoring unsupported generate() kwargs: "
                          f"{sorted(kwargs)}", stacklevel=2)
        if num_beams > 1:
            _refuse("beam search (num_beams > 1)", 5)
        if session_path is not None:
            _refuse("prompt-session files (session_path)", 6)
        if verbose_level() >= 1:
            import sys

            print(f"generation config: max_new_tokens={max_new_tokens} "
                  f"do_sample={do_sample} temperature={temperature} "
                  f"top_k={top_k} top_p={top_p} "
                  f"repetition_penalty={repetition_penalty} "
                  f"num_beams={num_beams} seed={seed}", file=sys.stderr)
        ids = self._to_list_batch(input_ids)
        if speculative:
            return self._generate_speculative(
                ids, max_new_tokens, do_sample, temperature, top_k, top_p,
                repetition_penalty, seed, streamer, stopping_criteria,
                ignore_prompt, speculative_k)
        sp = SamplingParams(
            do_sample=do_sample, temperature=temperature, top_k=top_k,
            top_p=top_p, repetition_penalty=repetition_penalty,
        )
        # a stopping_criteria must run between tokens -> per-token steps; a
        # streamer wants small flush granularity; otherwise large chunks
        chunk = (1 if stopping_criteria is not None
                 else 8 if streamer is not None else 16)
        sched = ContinuousBatchingScheduler(
            self.engine, sp, eos_id=self.eos_id, seed=seed, chunk_size=chunk,
            # the ladder would widen the granularity these callbacks rely on
            adaptive_chunk=stopping_criteria is None and streamer is None,
        )
        seqs = {}
        for p in ids:
            rid = sched.add_request(p, max_new_tokens, streamer=streamer)
            seqs[rid] = p
        done = {}
        while sched.has_work:
            sched.step()
            for s in sched.pop_finished():
                done[s.request_id] = s.generated
            if stopping_criteria is not None:
                for slot, s in list(sched.running.items()):
                    if stopping_criteria(seqs[s.request_id] + s.generated):
                        s.max_new_tokens = len(s.generated)  # stop now
        if verbose_level() >= 0:
            sched.timings.print_timings()
        return [
            (seqs[rid] if not ignore_prompt else []) + done[rid]
            for rid in sorted(done)
        ]

    def _generate_speculative(self, ids, max_new_tokens, do_sample,
                              temperature, top_k, top_p, repetition_penalty,
                              seed, streamer, stopping_criteria,
                              ignore_prompt, speculative_k):
        """generate(speculative=True), routed as the JAX package: one prompt
        over a contiguous engine takes the single-sequence helpers (slot 0),
        batches and paged engines the scheduler's joint steps."""
        from .ops.sampling import SamplingParams
        from .runtime import speculative as spec
        from .runtime.scheduler import ContinuousBatchingScheduler

        if stopping_criteria is not None:
            raise ValueError("speculative=True needs num_beams=1, no "
                             "stopping_criteria/session")
        single = len(ids) == 1 and not hasattr(self.engine, "page_size")
        if do_sample:
            sp = SamplingParams(
                do_sample=True, temperature=temperature, top_k=top_k,
                top_p=top_p, repetition_penalty=repetition_penalty)
        else:
            sp = SamplingParams(do_sample=False,
                                repetition_penalty=repetition_penalty)
        if single:
            with torch.inference_mode():
                if do_sample:
                    out = spec.generate_sampled_speculative(
                        self.engine, ids[0], max_new_tokens, sp,
                        eos_id=self.eos_id, k=speculative_k, seed=seed)
                else:
                    out = spec.generate_greedy_speculative(
                        self.engine, ids[0], max_new_tokens,
                        eos_id=self.eos_id, k=speculative_k, sp=sp)
            if streamer is not None:
                for t in out:
                    streamer(t)
            return [(ids[0] if not ignore_prompt else []) + out]
        # one multi-token verify forward over every slot per step
        sched = ContinuousBatchingScheduler(
            self.engine, sp, eos_id=self.eos_id, seed=seed,
            speculative=True, spec_k=speculative_k)
        rids = [sched.add_request(p, max_new_tokens, streamer=streamer)
                for p in ids]
        done = {s.request_id: s.generated for s in sched.run_to_completion()}
        return [(p if not ignore_prompt else []) + done[r]
                for p, r in zip(ids, rids)]

    @torch.inference_mode()
    def __call__(self, input_ids, **kw):
        """Float32 logits `[B, T, vocab]` for a batch of prompts, each row
        padded with -inf past its prompt, from a fresh cache of the
        engine's KV type (`max(T + 1, 16)` rows, rounded up to the 64 the
        attention kernels take)."""
        from .models.transformer import forward
        from .ops import kv_cache as kvc

        ids = self._to_list_batch(input_ids)
        b = len(ids)
        maxlen = max(len(p) for p in ids)
        eng = self.engine
        rows = -(-max(maxlen + 1, 16) // 64) * 64
        cache = kvc.init_cache(
            self.cfg.n_layers, b, rows, self.cfg.n_kv_heads,
            self.cfg.head_dim, eng.kv_dtype, eng.kv_quantized,
            device=eng.device, scale_dtype=eng.kv_scale_dtype)
        arr = np.zeros((b, maxlen), np.int32)
        lens = np.zeros((b,), np.int32)
        for i, p in enumerate(ids):
            arr[i, : len(p)] = p
            lens[i] = len(p)
        dev = eng.device
        pos = torch.arange(maxlen, dtype=torch.int32, device=dev)[None]
        logits, _ = forward(eng.params, eng.cfg,
                            torch.from_numpy(arr).to(dev),
                            pos.repeat(b, 1), cache,
                            torch.from_numpy(lens).to(dev), comp=eng.comp)
        out = logits.float().cpu().numpy()
        for i, p in enumerate(ids):  # -inf padding rows
            out[i, len(p):] = -np.inf
        return out

    @staticmethod
    def _to_list_batch(input_ids) -> List[List[int]]:
        if hasattr(input_ids, "tolist"):
            input_ids = input_ids.tolist()
        if input_ids and isinstance(input_ids[0], int):
            input_ids = [input_ids]
        return [list(p) for p in input_ids]

    # tokenizer conveniences ------------------------------------------
    def tokenize(self, text: str) -> List[int]:
        return self.tokenizer(text)["input_ids"]

    def detokenize(self, ids: Sequence[int]) -> str:
        return self.tokenizer.decode(list(ids))

    def quant_model(self, out_path: str) -> None:
        _refuse("packed-model files (quant_model)", 6)

    def save_state(self, path: str) -> None:
        _refuse("KV sessions (save_state)", 6)

    def load_state(self, path: str) -> None:
        _refuse("KV sessions (load_state)", 6)


def ModelServer(engine_or_model, response_fn, **kw):
    """`runtime/server.ModelServer` over a `Model`'s engine (or an
    engine)."""
    from .runtime.server import ModelServer as _MS

    eng = (engine_or_model.engine
           if isinstance(engine_or_model, Model) else engine_or_model)
    return _MS(eng, response_fn, **kw)


class AudioModel:
    """Whisper transcription API."""

    def __init__(self):
        self.model = None
        self.tokenizer = None

    def init(self, model_name: str, use_quant: bool = False,
             weight_dtype: str = "int8", group_size: int = 128,
             device=None, tokenizer=None):
        """Load a local HF whisper directory (`config.json` and
        `*.safetensors` or `pytorch_model*.bin`) onto `device` (the card
        unless the CPU is asked for).  `use_quant` quantizes the linears
        whose smaller side reaches a group (`weight_dtype`, default int8,
        `group_size`, default 128) on that device; their float32
        activations go through `qmatmul`'s float32 kernels on the card (int8
        and other INT packs: P's one-plane INT instances; nf4 / fp4: F;
        int3/5/6/7, fp8: P) and its plain version on the CPU."""
        from .convert import loaders
        from .models import whisper as W

        qspec = (named_qspec(weight_dtype, group_size=group_size)
                 if use_quant else None)
        with open(os.path.join(model_name, "config.json")) as f:
            hf_cfg = json.load(f)
        sd = loaders.load_state_dict(model_name)
        params, cfg = W.convert_whisper(sd, hf_cfg, qspec, device=device)
        self.model = W.WhisperModel(params, cfg)
        self.tokenizer = tokenizer
        return self

    # whisper's language codes (whisper.cpp g_lang map order; "yue" is
    # the 100th language added with large-v3 tokenizers — probing a
    # token the tokenizer lacks is harmless, _lang_token_ids filters)
    LANGUAGES = (
        "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he "
        "uk el ms cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa "
        "lv bn sr az sl kn et mk br eu is hy ne mn bs kk sq sw gl mr pa "
        "si km sn yo so af oc ka be tg sd gu am yi lo uz fo ht ps tk nn "
        "mt sa lb my bo tl mg as tt haw ln ha ba jw su yue"
    ).split()

    def forced_ids(self, language: str = "en", task: str = "transcribe"):
        if self.tokenizer is None:
            return []
        ids = self.tokenizer.convert_tokens_to_ids(
            [f"<|{language}|>", f"<|{task}|>", "<|notimestamps|>"]
        )
        return [i for i in ids if i is not None and i >= 0]

    def _lang_token_ids(self):
        """(codes, vocab ids) for the language tokens present in the
        tokenizer (tiny test tokenizers may carry a subset)."""
        if self.tokenizer is None:
            return [], []
        codes, ids = [], []
        unk = getattr(self.tokenizer, "unk_token_id", None)
        for code in self.LANGUAGES:
            i = self.tokenizer.convert_tokens_to_ids(f"<|{code}|>")
            if i is not None and i >= 0 and i != unk:
                codes.append(code)
                ids.append(i)
        return codes, ids

    def detect_language(self, audio):
        """Language auto-detect.  Returns (best_code, {code: prob})."""
        if isinstance(audio, str):
            audio = load_wav(audio)
        codes, ids = self._lang_token_ids()
        if not ids:
            raise ValueError("tokenizer has no language tokens")
        states, enc_lens = self.model.encode_audio(audio)
        probs = self.model.detect_language(states, enc_lens, ids)
        dist = dict(zip(codes, probs.tolist()))
        return max(dist, key=dist.get), dist

    @staticmethod
    def _compression_ratio(data: bytes) -> float:
        """zlib compression ratio of the decoded text — whisper.cpp's
        repetition detector (highly repetitive loops compress absurdly
        well)."""
        import zlib

        if not data:
            return 0.0
        return len(data) / max(len(zlib.compress(data)), 1)

    def transcribe(self, audio, language: str = "en",
                   task: str = "transcribe", max_new_tokens: int = 224,
                   timestamps: bool = False,
                   temperature=(0.0, 0.2, 0.4, 0.6, 0.8, 1.0),
                   compression_ratio_threshold: float = 2.4,
                   logprob_threshold: float = -1.0):
        """audio: float PCM @16kHz (numpy) or a .wav path.  With
        `timestamps=True` returns [(start_s, end_s, text)] segments.
        `language="auto"` runs language detection first.

        Temperature fallback: decode greedily first; if the output is
        degenerate (compression ratio > threshold: repetition loop) or
        low-confidence (avg logprob < threshold), retry at the next
        temperature.  Pass a single float (or (t,)) to disable."""
        if isinstance(audio, str):
            audio = load_wav(audio)
        if isinstance(temperature, (int, float)):
            temperature = (float(temperature),)
        states = enc_lens = None
        if language == "auto":
            # encode once and reuse the states for detection and
            # transcription
            codes, ids_ = self._lang_token_ids()
            if not ids_:
                raise ValueError("tokenizer has no language tokens")
            states, enc_lens = self.model.encode_audio(audio)
            probs = self.model.detect_language(states, enc_lens, ids_)
            language = codes[int(np.argmax(probs))]
        forced = self.forced_ids(language, task)
        ts_begin = None
        if timestamps:
            forced = [t for t in forced
                      if self.tokenizer is None
                      or t != self.tokenizer.convert_tokens_to_ids(
                          "<|notimestamps|>")]
            ts_begin = (self.tokenizer.convert_tokens_to_ids("<|0.00|>")
                        if self.tokenizer is not None else 50364)
        if states is None:
            states, enc_lens = self.model.encode_audio(audio)
        ids = None
        for ti, temp in enumerate(temperature):
            ids = self.model.generate(states, enc_lens, forced,
                                      max_new_tokens,
                                      timestamp_begin=ts_begin,
                                      temperature=temp, seed=ti)
            if ti == len(temperature) - 1:
                break
            # quality gates (whisper.cpp decoder_should_retry semantics)
            if self.model.last_avg_logprob < logprob_threshold:
                continue
            if self.tokenizer is not None:
                text = self.tokenizer.decode(ids, skip_special_tokens=True)
                if self._compression_ratio(
                        text.encode()) > compression_ratio_threshold:
                    continue
            break
        if timestamps:
            segs = self.model.segments(ids, ts_begin)
            if self.tokenizer is None:
                return segs
            return [(t0, t1, self.tokenizer.decode(toks))
                    for t0, t1, toks in segs]
        if self.tokenizer is None:
            return ids
        return self.tokenizer.decode(ids, skip_special_tokens=True)


def load_wav(path: str) -> np.ndarray:
    """Minimal 16-bit PCM WAV reader @16kHz (stdlib `wave`; other rates are
    resampled linearly)."""
    import wave

    with wave.open(path, "rb") as w:
        assert w.getsampwidth() == 2, "expect 16-bit PCM"
        rate = w.getframerate()
        data = np.frombuffer(w.readframes(w.getnframes()), np.int16)
        if w.getnchannels() > 1:
            data = data.reshape(-1, w.getnchannels()).mean(axis=1)
    audio = data.astype(np.float32) / 32768.0
    if rate != 16000:  # naive linear resample
        n = int(len(audio) * 16000 / rate)
        audio = np.interp(
            np.linspace(0, len(audio) - 1, n),
            np.arange(len(audio)), audio,
        ).astype(np.float32)
    return audio
