"""User-facing API (port of `neural_speed_tpu/api.py`): whisper transcription.

`AudioModel` and `load_wav` as in the JAX package.  The port imports only
torch, numpy and the standard library: `init` reads `config.json` with
`json` and the weights with `convert/loaders.load_state_dict` (a local
directory), and the tokenizer is an optional argument (any object with
the `transformers` tokenizer methods used here: `convert_tokens_to_ids`,
`decode`, `unk_token_id`).  Without one, `transcribe` returns token ids
(or segments of ids), as the JAX class does when its tokenizer fails to
load.  The model runs on the card unless `device="cpu"` is passed.
`api.Model` / `api.ModelServer` are not ported yet (ROADMAP section 1,
item 4).
"""

from __future__ import annotations

import json
import os

import numpy as np

from .ops.qtypes import named_qspec


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
