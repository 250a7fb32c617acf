"""Prompt-lookup speculative decoding (port of
`neural_speed_tpu/runtime/speculative.py`).

Greedy decoding verifies k draft tokens per model call instead of one: the
drafts come from n-gram matches against the context so far (prompt lookup:
no draft model), and one multi-token forward scores draft + 1 positions.
The accept rule keeps the longest prefix whose argmax agrees with the
draft, plus the first correction, so the output is the greedy sequence
(with the repetition / frequency / presence penalties when a
`SamplingParams` is given, through a host replica of `ops/sampling`'s
greedy pipeline).  Sampled decoding accepts a draft token x with
probability p(x) and on rejection draws from p with x removed
(`generate_sampled_speculative`): every emitted token is distributed as
sequential sampling from the model.

The verify forward is `models.transformer.forward` at positions
`n .. n + k` over the existing cache, its rows padded to `_SPEC_BUCKETS`.
Rejected draft rows need no erase: the slot's length is rolled back to
the accepted prefix, and later writes overwrite the stale rows.  Over the
int8 cache under `NST_FLASH_INT8=qk`, verify forwards of t tokens with
t * n_rep <= 8 run kernel B's int8 dot over several tokens per slot
(`ops/flash.mha`); the others run kernel C, as prefill does.

The verify forward runs at T = k + 1 while plain decode runs at T = 1, so
the GEMMs' blocking differs and logits can differ in the last bits; on a
real model's margins this does not flip an argmax, on a random one it can.
The host random streams (`numpy.random.default_rng(seed)`) are the JAX
package's, so sampled draws depend on the logits alone.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..models.transformer import forward
from ..ops import kv_cache as kvc
from ..ops.sampling import SamplingParams
from .engine import Engine, pad_to_bucket

# Verify-forward pad buckets: the engine's prefill buckets start at 32,
# which would run every k <= 7 verify at T = 32; these keep the verify
# forward at the next power of two >= k + 1.
_SPEC_BUCKETS = (2, 4, 8, 16, 32)


def propose_ngram(context: List[int], k: int, max_ngram: int = 3,
                  min_ngram: int = 1) -> Optional[List[int]]:
    """Draft the k tokens that followed the most recent match of the
    longest context-suffix n-gram (prompt lookup decoding).  Long contexts
    take the vectorized numpy form."""
    if len(context) > 64:
        return _propose_ngram_np(np.asarray(context, np.int32), k,
                                 max_ngram, min_ngram)
    return _propose_ngram_list(context, k, max_ngram, min_ngram)


def _propose_ngram_list(context: List[int], k: int, max_ngram: int,
                        min_ngram: int) -> Optional[List[int]]:
    n_ctx = len(context)
    if n_ctx < min_ngram + 1:
        return None
    for n in range(min(max_ngram, n_ctx - 1), min_ngram - 1, -1):
        tail = context[n_ctx - n:]
        for start in range(n_ctx - n - 1, -1, -1):
            if context[start:start + n] == tail:
                cont = context[start + n: start + n + k]
                if cont:
                    return list(cont)
    return None


def _propose_ngram_np(ctx: np.ndarray, k: int, max_ngram: int,
                      min_ngram: int) -> Optional[List[int]]:
    """propose_ngram with every window-vs-suffix compare of an n-gram size
    in one numpy op (the same most-recent longest match)."""
    n_ctx = ctx.size
    for n in range(min(max_ngram, n_ctx - 1), min_ngram - 1, -1):
        tail = ctx[n_ctx - n:]
        # candidate starts 0 .. n_ctx-1-n (the suffix itself is excluded)
        win = np.lib.stride_tricks.sliding_window_view(ctx[: n_ctx - 1], n)
        hits = np.nonzero((win == tail).all(axis=1))[0]
        if hits.size:
            start = int(hits[-1])  # most recent match
            cont = ctx[start + n: start + n + k]
            if cont.size:
                return [int(t) for t in cont]
    return None


@torch.inference_mode()
def _verify_forward(params, cfg, cache, ids, pos, kv_lens, comp=None):
    """Full-logits multi-token forward over the existing cache: logits
    [B, T, V] at every draft position, and the cache (written in place)."""
    return forward(params, cfg, ids, pos, cache, kv_lens, comp=comp)


@torch.inference_mode()
def _verify_forward_rows(params, cfg, cache, ids, pos, kv_lens, row_idx,
                         comp=None):
    """_verify_forward returning only the per-slot rows `row_idx` [B, R]:
    the rows are gathered before the LM head, so a mixed prefill chunk
    projects the rows that the accept loops read, not every padded row."""
    return forward(params, cfg, ids, pos, cache, kv_lens,
                   logits_positions=row_idx, comp=comp)


@torch.inference_mode()
def _verify_forward_argmax(params, cfg, cache, ids, pos, kv_lens,
                           comp=None):
    """The verify forward reduced on the device to each position's argmax
    id [B, T] int32 (unpenalized greedy only: penalties need the rows)."""
    logits, cache = forward(params, cfg, ids, pos, cache, kv_lens, comp=comp)
    return torch.argmax(logits, dim=-1).to(torch.int32), cache


def _penalized_row(row: np.ndarray, sp: SamplingParams,
                   obs: List[int]) -> np.ndarray:
    """Host replica of ops/sampling.apply_penalties on one logit row: the
    repetition penalty over the last `penalty_window` observed tokens,
    frequency / presence over every observed count, float32."""
    l = np.asarray(row, np.float32).copy()
    if sp.repetition_penalty != 1.0 and obs:
        rp = np.float32(sp.repetition_penalty)
        win = np.unique(np.asarray(obs[-sp.penalty_window:], np.int64))
        win = win[(win >= 0) & (win < l.shape[0])]
        lw = l[win]
        l[win] = np.where(lw > 0, lw / rp, lw * rp)
    if sp.frequency_penalty != 0.0 or sp.presence_penalty != 0.0:
        cnt = np.bincount(
            np.clip(np.asarray(obs, np.int64), 0, l.shape[0] - 1),
            minlength=l.shape[0],
        ).astype(np.float32)
        l = l - cnt * np.float32(sp.frequency_penalty) - (
            cnt > 0
        ).astype(np.float32) * np.float32(sp.presence_penalty)
    return l


def _softmax_np(l: np.ndarray) -> np.ndarray:
    e = np.exp(l - l.max())
    return e / e.sum()


def _target_dist(row: np.ndarray, sp: SamplingParams,
                 obs: List[int]) -> np.ndarray:
    """Host replica of the sampling pipeline's token distribution
    (ops/sampling.sample: penalties -> temperature -> top-k -> top-p ->
    softmax).  tfs / typical / mirostat are refused upstream."""
    l = _penalized_row(row, sp, obs)
    if sp.temperature <= 0.0:
        # do_sample with temperature <= 0 is greedy: a point mass at the
        # penalized argmax
        p = np.zeros_like(l)
        p[int(np.argmax(l))] = 1.0
        return p
    l = l / np.float32(sp.temperature)
    v = l.shape[0]
    if 0 < sp.top_k < v:
        # an O(V) selection instead of a full sort
        kth = np.partition(l, v - sp.top_k)[v - sp.top_k]
        l[l < kth] = -np.inf
    if sp.top_p < 1.0:
        # the nucleus cutoff without sorting the whole vocab: grow a top-m
        # selection until its mass covers top_p (the kept set is a prefix
        # of the descending order, so the cutoff is the full sort's)
        mx = l.max()
        total = np.exp(l - mx).sum()
        m = 64
        while True:
            m = min(m, v)
            top = np.partition(l, v - m)[v - m:]
            sl = np.sort(top)[::-1]
            p = np.exp(sl - mx) / total
            cum = np.cumsum(p)
            if cum[-1] >= sp.top_p or m >= v:
                break
            m *= 2
        keep = cum - p < sp.top_p
        keep[0] = True  # always keep top-1
        cutoff = sl[keep].min()
        l[l < cutoff] = -np.inf
    return _softmax_np(l)


class _PenalizedGreedy:
    """Host replica of ops/sampling's greedy with penalties: the repetition
    penalty over the last `penalty_window` observed tokens (the prompt's
    last window, then every generated token) and frequency / presence
    over the observed counts, float32.  With sampled params it only tracks
    the observed tokens (`obs`, read by `_target_dist`)."""

    def __init__(self, prompt: List[int], sp: Optional[SamplingParams]):
        self.sp = sp
        self.obs: List[int] = (
            list(prompt[-sp.penalty_window:]) if sp is not None else []
        )

    def pick(self, row: np.ndarray, extra: List[int]) -> int:
        """argmax of penalties(row) given observed = self.obs + extra."""
        if self.sp is None:
            return int(np.argmax(row))
        if self.sp.do_sample:
            raise ValueError("pick() is greedy-only")
        return int(np.argmax(_penalized_row(row, self.sp, self.obs + extra)))

    def observe(self, tokens: List[int]) -> None:
        if self.sp is not None:
            self.obs.extend(tokens)


def _host_row(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


def _check_contiguous(engine: Engine) -> None:
    if not isinstance(engine.cache, kvc.KVCache):
        raise NotImplementedError(
            "the single-sequence speculative helper owns slot 0 of a "
            "contiguous cache; paged engines speculate through the "
            "ContinuousBatchingScheduler(speculative=True)")


class _Slot0:
    """Slot 0 of a contiguous engine after its prefill, for the
    single-sequence helpers: the verify inputs and the lazily synced device
    lengths (the verify forward is masked by its explicit kv_lens and
    positions, so the cache's lengths are pushed only before a plain decode
    and at the end)."""

    def __init__(self, engine: Engine, n_past: int):
        self.eng = engine
        self.n_past = n_past
        self.base_lens = engine.cache.lengths.cpu().numpy()  # spectators
        self.dirty = False

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.eng.device)

    def sync(self) -> None:
        b = self.eng.max_batch
        kvc.set_lengths(self.eng.cache, self._dev(np.where(
            np.arange(b) == 0, self.n_past, self.base_lens).astype(np.int32)))
        self.dirty = False

    def decode(self, tok: int) -> np.ndarray:
        """One plain decode step of slot 0; its float32 logit row."""
        if self.dirty:
            self.sync()
        b = self.eng.max_batch
        active = torch.zeros((b,), dtype=torch.bool)
        active[0] = True
        logits = self.eng.decode(
            torch.full((b,), tok, dtype=torch.int32), active)
        self.n_past += 1  # decode_step advanced the device lengths too
        return _host_row(logits[0])

    def verify(self, seq: List[int], pad_t: int, argmax: bool):
        """[tok, *draft] in one forward: the argmax ids [len(seq)] or the
        float32 logit rows [len(seq), V]."""
        eng, b = self.eng, self.eng.max_batch
        ids = np.zeros((b, pad_t), np.int32)
        ids[0, : len(seq)] = seq
        pos = np.arange(pad_t)[None, :] + np.where(
            np.arange(b) == 0, self.n_past, 0)[:, None]
        in_range = (np.arange(pad_t)[None, :] < len(seq)) & (
            np.arange(b) == 0)[:, None]
        pos = np.where(in_range, pos, eng.max_len - 1).astype(np.int32)
        kv_lens = np.where(np.arange(b) == 0, self.n_past + len(seq),
                           self.base_lens).astype(np.int32)
        fn = _verify_forward_argmax if argmax else _verify_forward
        out, eng.cache = fn(eng.params, eng.cfg, eng.cache, self._dev(ids),
                            self._dev(pos), self._dev(kv_lens),
                            comp=eng.comp)
        if argmax:
            return out[0, : len(seq)].cpu().numpy()
        return _host_row(out[0, : len(seq)])

    def advance(self, n: int) -> None:
        """Roll the slot to the accepted prefix (stale draft rows past it
        are masked by kv_lens and overwritten by later writes)."""
        self.n_past += n
        self.dirty = True


def generate_greedy_speculative(
    engine: Engine,
    prompt: List[int],
    max_new_tokens: int,
    eos_id: Optional[int] = None,
    k: int = 7,
    max_ngram: int = 3,
    sp: Optional[SamplingParams] = None,
) -> List[int]:
    """Greedy generation with n-gram speculation on slot 0 of a contiguous
    engine: token for token `Engine.generate_greedy` (sp None) or the
    scheduler's penalized greedy (sp given)."""
    _check_contiguous(engine)
    pen = _PenalizedGreedy(prompt, sp)
    logits = engine.prefill([prompt])
    slot = _Slot0(engine, len(prompt))
    out: List[int] = []
    tok = pen.pick(_host_row(logits[0]), [])
    pen.observe([tok])
    pad_t = pad_to_bucket(k + 1, _SPEC_BUCKETS)
    while len(out) < max_new_tokens:
        out.append(tok)
        if (eos_id is not None and tok == eos_id) or len(out) >= max_new_tokens:
            break
        draft = propose_ngram(prompt + out, k, max_ngram=max_ngram)
        if not draft:
            tok = pen.pick(slot.decode(tok), [])
            pen.observe([tok])
            continue
        # verify [tok, *draft] in one forward: causal masking makes each
        # row's logits independent of the later (maybe wrong) draft rows
        seq = [tok] + draft
        if sp is None:
            g_row = slot.verify(seq, pad_t, argmax=True)
            picks = lambda j: int(g_row[j])  # noqa: E731
        else:
            rows = slot.verify(seq, pad_t, argmax=False)
            picks = lambda j: pen.pick(rows[j], draft[:j])  # noqa: E731
        # row j scores the token after seq[j]; its penalty state has
        # observed draft[:j] on top of everything up to tok
        accepted = 0
        while True:
            g = picks(accepted)
            if (accepted < len(draft)
                    and len(out) + accepted + 1 < max_new_tokens
                    and g == draft[accepted]
                    and not (eos_id is not None and g == eos_id)):
                accepted += 1
            else:
                nxt = g
                break
        out.extend(draft[:accepted])
        pen.observe(draft[:accepted])
        tok = nxt  # the first correction / the next greedy token
        pen.observe([tok])
        slot.advance(1 + accepted)
    if slot.dirty:
        slot.sync()
    return out


def generate_sampled_speculative(
    engine: Engine,
    prompt: List[int],
    max_new_tokens: int,
    sp: SamplingParams,
    eos_id: Optional[int] = None,
    k: int = 7,
    max_ngram: int = 3,
    seed: int = 0,
) -> List[int]:
    """Sampled speculative decoding (rejection sampling against the
    point-mass n-gram draft): draft token x is accepted with probability
    p(x); on rejection the correction is drawn from p with x removed and
    renormalized, so P[emit y] = p(y).  Temperature, top-k, top-p and the
    penalties (the host replica of ops/sampling.sample); tfs / typical /
    mirostat raise.  The host draws come from
    `numpy.random.default_rng(seed)`, as in the JAX package."""
    if not sp.do_sample:
        raise ValueError("use generate_greedy_speculative for greedy")
    if sp.mirostat or sp.tfs_z < 1.0 or sp.typical_p < 1.0:
        raise ValueError("sampled speculative supports temperature/top_k/"
                         "top_p/penalties only")
    _check_contiguous(engine)
    rng = np.random.default_rng(seed)
    obs: List[int] = list(prompt[-sp.penalty_window:])

    def draw(p: np.ndarray) -> int:
        return int(rng.choice(p.shape[0], p=p))

    logits = engine.prefill([prompt])
    slot = _Slot0(engine, len(prompt))
    out: List[int] = []
    tok = draw(_target_dist(_host_row(logits[0]), sp, obs))
    obs.append(tok)
    pad_t = pad_to_bucket(k + 1, _SPEC_BUCKETS)
    while len(out) < max_new_tokens:
        out.append(tok)
        if (eos_id is not None and tok == eos_id) or len(out) >= max_new_tokens:
            break
        draft = propose_ngram(prompt + out, k, max_ngram=max_ngram)
        if not draft:
            tok = draw(_target_dist(slot.decode(tok), sp, obs))
            obs.append(tok)
            continue
        rows = slot.verify([tok] + draft, pad_t, argmax=False)
        committed: List[int] = []
        while True:
            j = len(committed)
            p_j = _target_dist(rows[j], sp, obs + committed)
            if (j < len(draft)
                    and len(out) + j + 1 < max_new_tokens
                    and not (eos_id is not None and draft[j] == eos_id)):
                x = draft[j]
                if rng.random() < p_j[x]:
                    committed.append(x)
                    continue
                q = p_j.copy()
                q[x] = 0.0
                s = float(q.sum())
                if s <= 0.0:  # all mass on x (p(x) = 1): accept is forced
                    committed.append(x)
                    continue
                nxt = draw(q / s)  # the residual distribution
                break
            nxt = draw(p_j)  # bonus token / budget or eos stop
            break
        out.extend(committed)
        obs.extend(committed)
        tok = nxt
        obs.append(tok)
        slot.advance(1 + len(committed))
    if slot.dirty:
        slot.sync()
    return out
