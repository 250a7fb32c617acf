"""Continuous-batching scheduler (port of `neural_speed_tpu/runtime/
scheduler.py`): FCFS waiting / running / finished pools over the engine's
fixed decode slots, and iteration-level steps.

A step admits and prefills a batch of waiting requests into free slots
(`_prefill_batch`), or decodes the running slots: through the engine's
EOS-aware decode window (`_window_step`, engines with `supports_window`,
the default) or through the chunk ladder (`_decode_step`, `window=1` or
`chunk_size=1`), either one pipelined: the next dispatch leaves from the
previous one's device carry, and the host commits the previous tokens
after it.  With `speculative`, decoding slots instead run joint steps
(`_joint_step`): each proposes a prompt-lookup draft and one multi-token
verify forward scores every slot (`runtime/speculative.py`), greedy
accepting the longest agreeing prefix and the correction, sampled by
rejection sampling against the draft; an EMA of the accepted tokens per
verify picks the draft length and backs off to plain decode for a while
when it collapses.  With `mixed_prefill`, admitted prompts are fed
`mixed_chunk` tokens per joint step beside the decoding slots' rows
(`_admit_mixed`).  The host bookkeeping (the `_slot_len` mirror, page
reservations through `prepare_*` / `commit_lens` / `release_slot`, sampler
state per slot and its host replicas, streamers, finish order) follows
the JAX scheduler's, name for name and in the same order, so greedy
deliveries equal the JAX package's.

The device sampler state is the port's `ops/sampling` (a `torch.Generator`
where JAX has a PRNG key), so ids it samples are the port's own; a seed
gives the same ids run after run.  The joint steps sample on the host with
the JAX package's stream (`numpy.random.default_rng(seed ^ 0x5EED)`), so
there a draw depends on the logits alone.  Steps run under
`torch.inference_mode()`.

Not ported, and raising with the ROADMAP section 1 item that ports them:
eviction when a slot's context fills (`_maybe_evict`, item 6, also when a
joint step's rows would fill it) and `save_state` / `load_state` (item 6).
The state only those paths read (eviction's settings, the prompt prefix a
session or the prefix cache (item 5) leaves in a slot) comes with them.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops import sampling as smp
from ..utils.profiler import Timings
from .engine import Engine, pad_to_bucket
from .speculative import (_SPEC_BUCKETS, _PenalizedGreedy, _target_dist,
                          propose_ngram)


class SeqStatus:
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODING = "decoding"
    FINISHED = "finished"


@dataclasses.dataclass
class Sequence:
    """One request and what it has generated."""

    request_id: int
    prompt: List[int]
    max_new_tokens: int = 128
    status: str = SeqStatus.WAITING
    slot: int = -1
    generated: List[int] = dataclasses.field(default_factory=list)
    receive_time: float = dataclasses.field(default_factory=time.time)
    end_time: Optional[float] = None
    streamer: Optional[Callable[[int], None]] = None
    # mixed prefill+decode steps: the (clamped) prompt suffix still to be
    # written to KV, and how many of its tokens have been fed so far
    feed: Optional[List[int]] = None
    fed: int = 0


def _host(t: torch.Tensor) -> np.ndarray:
    """A device tensor on the host (the one synchronising read)."""
    return t.cpu().numpy()


class ContinuousBatchingScheduler:
    """FCFS iteration-level scheduler over the Engine's fixed decode slots."""

    def __init__(self, engine: Engine,
                 params: Optional[smp.SamplingParams] = None,
                 eos_id: Optional[int] = None, seed: int = 0,
                 chunk_size: int = 8, speculative: bool = False,
                 spec_k: int = 7, spec_min_k: int = 3,
                 spec_max_ngram: int = 3, mixed_prefill: bool = False,
                 mixed_chunk: int = 32, adaptive_chunk: bool = True,
                 pipeline_decode: bool = True,
                 window: Optional[int] = None):
        self.engine = engine
        self.eos_id = eos_id
        self.timings = Timings()
        # tokens decoded per device dispatch: the host syncs once per chunk;
        # 1 restores per-token stepping (a stopping_criteria needs it)
        self.chunk_size = max(1, chunk_size)
        # deepen the chunk 4x when nothing is waiting (identical outputs)
        self.adaptive_chunk = adaptive_chunk
        # dispatch chunk / window N+1 from N's device carry, then commit N
        self.pipeline_decode = pipeline_decode
        self._pending = None  # ("chunk"|"window", payload) — in-flight decode
        # the EOS-aware decode window caps the tokens per dispatch (the
        # ladder's 4x chunk bound by default); window=1 / chunk_size=1
        # takes the chunk ladder
        if window is None:
            window = (4 if adaptive_chunk else 1) * max(1, chunk_size)
        self.window_cap = max(1, int(window))
        self.sp = params or smp.SamplingParams(do_sample=False)
        # -- batched speculative decoding --------------------------------
        # every step each decoding slot proposes its own prompt-lookup draft
        # and one multi-token verify forward scores all slots; the draft
        # length follows an EMA of the accepted tokens per verify, and when
        # that collapses the scheduler decodes plainly for a spell
        # (`spec_backoff_chunks` steps) before it probes again
        self.speculative = speculative
        # -- mixed prefill+decode steps ----------------------------------
        # each joint step feeds every admitted prompt its next <=
        # mixed_chunk tokens beside the decoding slots' rows: running
        # decodes never stall behind a long prompt
        self.mixed_prefill = mixed_prefill
        self.mixed_chunk = max(1, mixed_chunk)
        if speculative or mixed_prefill:
            mode = "speculative" if speculative else "mixed-prefill"
            if self.sp.do_sample and (self.sp.mirostat or self.sp.tfs_z < 1.0
                                      or self.sp.typical_p < 1.0):
                raise ValueError(
                    f"sampled {mode} scheduling supports temperature/"
                    "top_k/top_p/penalties only (no host replica of "
                    "tfs/typical/mirostat)")
        if ((speculative or mixed_prefill)
                and hasattr(engine, "page_size")):
            # the JAX package writes a joint step's rows through the page
            # table only up to page_size tokens: every row fits in a page
            ps = int(engine.page_size)
            if ps < 2:
                raise ValueError("speculative/mixed scheduling on paged "
                                 "KV needs page_size >= 2")
            self.mixed_chunk = min(self.mixed_chunk, ps)
            spec_k = min(spec_k, ps - 1)
            spec_min_k = min(spec_min_k, ps - 1)
        if mixed_prefill and engine.cfg.rope_style == "chatglm":
            # GLM blank infilling makes prompt attention bidirectional:
            # chunked prefill cannot feed it
            raise NotImplementedError(
                "mixed_prefill cannot chunk chatglm-1's bidirectional "
                "prompt (GLM blank-infilling mask); use the default "
                "alternating scheduler")
        self.spec_k = spec_k
        self.spec_min_k = spec_min_k
        self.spec_max_ngram = spec_max_ngram
        self.spec_backoff_chunks = 4      # plain steps per backoff spell
        self._pens: Dict[int, object] = {}          # slot -> _PenalizedGreedy
        # the host stream of the joint steps' draws (the device sampler
        # drives prefill and backoff decode)
        self._spec_rng = np.random.default_rng(np.uint64(seed) ^ 0x5EED)
        self._spec_gain_ema = float(spec_k) / 2     # optimistic start
        self._spec_backoff = 0
        # joint steps mask by explicit kv lengths: the cache's lengths are
        # pushed lazily, before a step that reads them
        self._dev_lens_dirty = False
        self._slot_len = np.zeros((engine.max_batch,), np.int64)  # host KV mirror
        self.waiting: Deque[Sequence] = deque()
        self.running: Dict[int, Sequence] = {}  # slot -> seq
        self.finished: Deque[Sequence] = deque()
        self.free_slots = list(range(engine.max_batch))[::-1]
        self._next_rid = 0
        self._seed = seed
        self.sampler = self._new_sampler()
        self._last_tokens = np.zeros((engine.max_batch,), np.int32)

    def _new_sampler(self) -> smp.SamplerState:
        return smp.init_state(
            self._seed, self.engine.max_batch, self.engine.cfg.vocab_size,
            window=self.sp.penalty_window, tau=self.sp.mirostat_tau,
            device=self.engine.device)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.engine.device)

    # ------------------------------------------------------------------
    def add_request(self, prompt: Sequence[int], max_new_tokens: int = 128,
                    streamer=None) -> int:
        """Queue a request; returns its id."""
        rid = self._next_rid
        self._next_rid += 1
        self.waiting.append(
            Sequence(rid, list(prompt), max_new_tokens, streamer=streamer))
        return rid

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def pop_finished(self) -> List[Sequence]:
        out = list(self.finished)
        self.finished.clear()
        return out

    def warmup(self, prompt_len: int = 8) -> None:
        """Run one throwaway request to completion before real traffic, then
        reset the scheduler to its freshly constructed state (deliveries
        after a warmup equal a cold scheduler's).  On the card this pays the
        kernels' build and first launches outside any request's latency."""
        assert not self.has_work, "warmup() must run before any request"
        budget = self.chunk_size * (6 if self.adaptive_chunk else 2) + 2
        if self.speculative or self.mixed_prefill:
            budget = max(budget, 2 * self.mixed_chunk
                         + 2 * (self.spec_k + 1) + 4)
        self.add_request([1] * max(1, prompt_len), budget)
        self.run_to_completion()
        self.finished.clear()
        # reset to the constructed state: sampler streams, speculative
        # adaptivity, per-slot mirrors
        self.sampler = self._new_sampler()
        self._spec_rng = np.random.default_rng(np.uint64(self._seed)
                                               ^ 0x5EED)
        self._spec_gain_ema = float(self.spec_k) / 2
        self._spec_backoff = 0
        self._pens.clear()
        self._pending = None
        self._dev_lens_dirty = False
        self._slot_len[:] = 0
        self._last_tokens[:] = 0
        self.timings = type(self.timings)()

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def step(self) -> None:
        """One scheduler iteration: admit and prefill a batch of new
        requests, or decode the running slots, or with mixed_prefill both
        in one joint forward."""
        if self.waiting:
            # a pending decode may finish sequences and free slots; the
            # admission decision must see the post-flush state
            self._flush_pending()
        admit = bool(self.waiting and self.free_slots)
        if self.mixed_prefill:
            mid = any(q.status == SeqStatus.PREFILL
                      for q in self.running.values())
            decoding = any(q.status == SeqStatus.DECODING
                           for q in self.running.values())
            if mid or (admit and decoding):
                self._flush_pending()
                if admit:
                    self._admit_mixed()
                self._joint_step(include_prefill=True)
                return
        if admit:
            self._prefill_batch()
        elif self.running:
            if self.speculative and self._spec_backoff == 0:
                self._flush_pending()
                self._joint_step(include_prefill=False)
            else:
                if self._spec_backoff > 0:
                    self._spec_backoff -= 1
                    if self._spec_backoff == 0:
                        # probe speculation again with a clean slate
                        self._spec_gain_ema = 1.0
                self._decode_step()

    def _sync_dev_lengths(self) -> None:
        """Push the host KV-length mirror to the device cache (the joint
        steps mask by explicit kv lengths; prefill and plain decode read
        the cache's)."""
        from ..ops import kv_cache as kvc

        kvc.set_lengths(self.engine.cache,
                        self._dev(self._slot_len.astype(np.int32)))
        self._dev_lens_dirty = False

    def _penalties_active(self) -> bool:
        return (self.sp.repetition_penalty != 1.0
                or self.sp.frequency_penalty != 0.0
                or self.sp.presence_penalty != 0.0)

    def run_to_completion(self) -> List[Sequence]:
        res = []
        while self.has_work:
            self.step()
            res.extend(self.pop_finished())
        return res

    # ------------------------------------------------------------------
    def _prefill_batch(self) -> None:
        if self._dev_lens_dirty:
            self._sync_dev_lengths()  # spectators' kv_lens read the cache's
        # admission: min(free slots, waiting)
        batch: List[Sequence] = []
        while self.waiting and self.free_slots:
            seq = self.waiting.popleft()
            seq.slot = self.free_slots.pop()
            seq.status = SeqStatus.PREFILL
            # registered at once, so `has_work` stays true during prefill
            self.running[seq.slot] = seq
            batch.append(seq)

        eng = self.engine
        maxlen = max(len(s.prompt) for s in batch)
        t = pad_to_bucket(maxlen, eng.buckets)
        ids = np.zeros((eng.max_batch, t), np.int32)
        lens = np.zeros((eng.max_batch,), np.int32)
        start = np.zeros((eng.max_batch,), np.int32)
        for s in batch:
            p = s.prompt[-t:]  # clamp over-long to the bucket
            ids[s.slot, : len(p)] = p
            lens[s.slot] = len(p)
        eng.prepare_prefill([s.slot for s in batch],
                            [lens[s.slot] for s in batch], starts=start)
        with self.timings.timer("prefill", int(lens.sum())):
            logits = eng.run_prefill(torch.from_numpy(ids),
                                     torch.from_numpy(lens),
                                     torch.from_numpy(start))
            if logits.is_cuda:
                torch.cuda.synchronize(logits.device)
        self._sample_and_commit(logits, {s.slot: s for s in batch},
                                prompt_obs=batch)
        for s in batch:
            if s.status != SeqStatus.FINISHED:  # first token may be eos
                self._slot_len[s.slot] = int(lens[s.slot])
                s.status = SeqStatus.DECODING

    def _can_pipeline(self, active_prev: np.ndarray, chunk: int) -> bool:
        """True iff a next chunk may leave from the pending chunk's device
        carry with the same active set: no admission possible, and, as if
        every pending token were consumed, no slot can finish on budget or
        run out of context (an EOS mid-chunk is fine: the extra chunk's
        tokens for that slot are discarded like mid-chunk tails)."""
        if (not self.pipeline_decode or self.waiting
                or self._dev_lens_dirty or self.speculative
                or self.mixed_prefill):
            return False
        # every dispatched slot must still be running and decoding, or the
        # stale mask would advance a freed slot's mirror and claim pages
        for slot in np.nonzero(active_prev)[0]:
            seq = self.running.get(int(slot))
            if seq is None or seq.status != SeqStatus.DECODING:
                return False
            if seq.max_new_tokens - len(seq.generated) <= chunk:
                return False
        for slot, seq in self.running.items():
            if seq.status == SeqStatus.DECODING and not active_prev[slot]:
                return False  # active set changed
        # _slot_len already includes the pending chunk
        if int(self._slot_len[active_prev].max()) + chunk > \
                self.engine.max_len:
            return False
        return True

    def _dispatch_decode(self, tokens: torch.Tensor, active_np: np.ndarray,
                         chunk: int) -> None:
        eng = self.engine
        eng.prepare_decode(active_np, chunk)
        with self.timings.timer("decode", int(active_np.sum()) * chunk):
            toks, self.sampler = eng.run_decode_chunk(
                self.sampler, tokens, self._dev(active_np), chunk, self.sp)
        self._slot_len[active_np] += chunk
        self._pending = ("chunk", (toks, active_np, chunk))

    def _flush_pending(self) -> None:
        if self._pending is None:
            return
        kind, payload = self._pending
        self._pending = None
        if kind == "window":
            buf, em, _toks, _act, _bud, active_np, w = payload
            self._commit_window(buf, em, active_np, w)
            return
        toks, active_np, chunk = payload
        self._commit_decode(_host(toks), active_np, chunk)

    def _commit_decode(self, toks_np: np.ndarray, active_np: np.ndarray,
                       chunk: int) -> None:
        active_np = active_np.copy()
        for step in range(chunk):
            for slot, seq in list(self.running.items()):
                if not active_np[slot]:
                    continue
                tok = int(toks_np[slot, step])
                seq.generated.append(tok)
                self._last_tokens[slot] = tok
                pen = self._pens.get(slot)
                if pen is not None:
                    pen.observe([tok])  # keep the host greedy state resumable
                if seq.streamer is not None:
                    seq.streamer(tok)
                if (self.eos_id is not None and tok == self.eos_id) or len(
                    seq.generated
                ) >= seq.max_new_tokens:
                    active_np[slot] = False  # later chunk tokens discarded
                    self._finish(slot, seq)

    def _use_window(self) -> bool:
        return (getattr(self.engine, "supports_window", False)
                and not self.speculative and not self.mixed_prefill
                and self.window_cap > 1 and self.chunk_size > 1)

    def _decode_step(self) -> None:
        if self._use_window():
            self._window_step()
            return
        if self._pending is not None:
            _kind, (toks_prev, active_prev, chunk_prev) = self._pending
            if self._can_pipeline(active_prev, chunk_prev):
                # dispatch chunk N+1 from chunk N's device carry, then
                # process N's tokens
                self._pending = None
                self._dispatch_decode(toks_prev[:, -1], active_prev,
                                      chunk_prev)
                self._commit_decode(_host(toks_prev), active_prev,
                                    chunk_prev)
                return
            self._flush_pending()
        if self._dev_lens_dirty:
            self._sync_dev_lengths()
            self._sync_sampler_from_pens()
        eng = self.engine
        active_np = np.zeros((eng.max_batch,), bool)
        for slot, seq in self.running.items():
            if seq.status == SeqStatus.DECODING:
                active_np[slot] = True
        if not active_np.any():
            return
        # a two-step ladder: sequences finishing mid-chunk discard their
        # tail tokens
        chunk = self.chunk_size
        if self.adaptive_chunk and not self.waiting:
            big = 4 * self.chunk_size
            remaining = min(
                seq.max_new_tokens - len(seq.generated)
                for slot, seq in self.running.items() if active_np[slot])
            headroom = self.engine.max_len - int(
                self._slot_len[active_np].max())
            if remaining >= big and headroom >= big:
                chunk = big
        self._maybe_evict(active_np, chunk)
        self._dispatch_decode(self._dev(self._last_tokens), active_np, chunk)
        if not self._can_pipeline(active_np, chunk):
            self._flush_pending()

    # -- EOS-aware device decode windows --------------------------------
    def _window_step(self) -> None:
        """Decode through engine.run_decode_window: up to `window_cap`
        tokens per dispatch, with per-slot EOS / budget stops inside the
        loop; pipelined dispatches leave from the previous window's device
        carries (tokens, active, budget)."""
        eng = self.engine
        if self._pending is not None:
            kind, payload = self._pending
            if kind == "window":
                buf, em, toks_d, act_d, bud_d, active_np, w = payload
                if self._can_pipeline_window(active_np, w):
                    self._pending = None
                    self._dispatch_window(toks_d, act_d, bud_d, active_np,
                                          w)
                    self._commit_window(buf, em, active_np, w)
                    return
            self._flush_pending()
        if self._dev_lens_dirty:
            self._sync_dev_lengths()
            self._sync_sampler_from_pens()
        active_np = np.zeros((eng.max_batch,), bool)
        for slot, seq in self.running.items():
            if seq.status == SeqStatus.DECODING:
                active_np[slot] = True
        if not active_np.any():
            return
        # the base chunk when requests wait (responsive admission) or near
        # the context limit; otherwise up to window_cap
        w = min(self.chunk_size, self.window_cap)
        if not self.waiting:
            headroom = eng.max_len - int(self._slot_len[active_np].max())
            rem = max(seq.max_new_tokens - len(seq.generated)
                      for slot, seq in self.running.items()
                      if active_np[slot])
            big = min(self.window_cap, max(w, rem))
            if big <= headroom:
                w = big
        self._maybe_evict(active_np, w)
        budget = np.zeros((eng.max_batch,), np.int32)
        for slot, seq in self.running.items():
            if active_np[slot]:
                budget[slot] = seq.max_new_tokens - len(seq.generated)
        self._dispatch_window(self._dev(self._last_tokens),
                              self._dev(active_np), self._dev(budget),
                              active_np, w)
        if not self._can_pipeline_window(active_np, w):
            self._flush_pending()

    def _dispatch_window(self, tokens, act_dev, bud_dev,
                         active_np: np.ndarray, w: int) -> None:
        eng = self.engine
        eng.prepare_decode(active_np, w)
        with self.timings.timer("decode", int(active_np.sum()) * w):
            buf, em, toks_d, act_d, bud_d, self.sampler = \
                eng.run_decode_window(self.sampler, tokens, act_dev,
                                      bud_dev, w, self.window_cap, self.sp,
                                      self.eos_id)
        # pessimistic mirror advance (the commit rolls back by w and applies
        # the emitted count)
        self._slot_len[active_np] += w
        self._pending = ("window", (buf, em, toks_d, act_d, bud_d,
                                    active_np, w))

    def _commit_window(self, buf, em, active_np: np.ndarray,
                       w: int) -> None:
        buf_np = _host(buf)   # [B, cap]
        em_np = _host(em)     # [B]
        for slot, seq in list(self.running.items()):
            if not active_np[slot]:
                continue
            cnt = int(em_np[slot])
            self._slot_len[slot] += cnt - w  # undo the pessimistic advance
            toks = buf_np[slot, :cnt].tolist()
            pen = self._pens.get(slot)
            for tok in toks:
                seq.generated.append(tok)
                self._last_tokens[slot] = tok
                if pen is not None:
                    pen.observe([tok])
                if seq.streamer is not None:
                    seq.streamer(tok)
            if toks and ((self.eos_id is not None
                          and toks[-1] == self.eos_id)
                         or len(seq.generated) >= seq.max_new_tokens):
                self._finish(slot, seq)
        # paged KV: snap the page-reservation mirror to the committed
        # lengths (no-op on the contiguous engine)
        self.engine.commit_lens(self._slot_len)

    def _can_pipeline_window(self, active_np: np.ndarray, w: int) -> bool:
        """Window N+1 may leave from N's device carries whenever no
        admission, eviction or host-state change can interleave (EOS and
        budget stops deactivate on the device)."""
        if (not self.pipeline_decode or self.waiting
                or self._dev_lens_dirty):
            return False
        for slot in np.nonzero(active_np)[0]:
            seq = self.running.get(int(slot))
            if seq is None or seq.status != SeqStatus.DECODING:
                return False
        for slot, seq in self.running.items():
            if seq.status == SeqStatus.DECODING and not active_np[slot]:
                return False  # active set changed under us
        # context headroom for one more full window
        if int(self._slot_len[active_np].max()) + w > self.engine.max_len:
            return False
        return True

    # -- mixed admission (chunked prefill) ------------------------------
    def _admit_mixed(self) -> None:
        """Admit waiting requests into free slots for chunked prefill: the
        prompt is fed `mixed_chunk` tokens per joint step (clamped to the
        context as `_prefill_batch`'s bucket clamp)."""
        while self.waiting and self.free_slots:
            seq = self.waiting.popleft()
            seq.slot = self.free_slots.pop()
            seq.status = SeqStatus.PREFILL
            cap = max(1, self.engine.max_len - 1)
            seq.feed = list(seq.prompt)[-cap:]
            seq.fed = 0
            self._slot_len[seq.slot] = 0
            self._dev_lens_dirty = True  # joint steps mask by explicit args
            self.running[seq.slot] = seq

    # -- batched speculative decoding / mixed prefill+decode ------------
    def _joint_step(self, include_prefill: bool) -> None:
        """One combined forward for every slot with work.

        Decoding slots contribute a [last_tok, *draft] row (the draft empty
        unless speculation is on): greedy keeps the longest agreeing prefix
        plus the correction, sampled rejection-samples against the
        point-mass draft, so each slot's output is the sequential one at
        about 1 + accepted tokens per dispatch.  With include_prefill,
        prefill slots contribute their next <= mixed_chunk prompt tokens
        (their logits unused until the chunk that completes the prompt,
        whose last row gives the first token)."""
        eng = self.engine
        slots = [(slot, seq) for slot, seq in self.running.items()
                 if seq.status == SeqStatus.DECODING]
        slots_p = [(slot, seq) for slot, seq in self.running.items()
                   if seq.status == SeqStatus.PREFILL] if include_prefill \
            else []
        if not slots and not slots_p:
            return
        speculate = self.speculative and self._spec_backoff == 0
        # the adaptive draft length: long drafts pay only when acceptance
        # is high (the verify cost grows with the padded bucket)
        k = self.spec_k if self._spec_gain_ema >= 2.0 else self.spec_min_k
        b = eng.max_batch
        drafts: Dict[int, List[int]] = {}
        for slot, seq in slots:
            d = (propose_ngram(seq.prompt + seq.generated, k,
                               max_ngram=self.spec_max_ngram) or []) \
                if speculate else []
            # never draft past the remaining budget: only the correction
            # token can finish a slot
            room = seq.max_new_tokens - len(seq.generated) - 1
            drafts[slot] = d[:max(0, room)]
        rows: Dict[int, List[int]] = {
            slot: [int(self._last_tokens[slot])] + drafts[slot]
            for slot, _ in slots
        }
        for slot, seq in slots_p:
            rows[slot] = list(seq.feed[seq.fed: seq.fed + self.mixed_chunk])
        max_seq = max(len(r) for r in rows.values())
        buckets = _SPEC_BUCKETS if self.mixed_chunk <= _SPEC_BUCKETS[-1] \
            else _SPEC_BUCKETS + (self.mixed_chunk,)
        if hasattr(eng, "page_size"):
            # the padded window fits in one page too
            ps = int(eng.page_size)
            buckets = tuple(x for x in buckets if x <= ps)
            if not buckets or buckets[-1] < ps:
                buckets = buckets + (ps,)
        pad_t = pad_to_bucket(max_seq, buckets)

        active_np = np.zeros((b,), bool)
        for slot, _ in slots:
            active_np[slot] = True
        # only decoding slots can run out of context, and only by their own
        # rows (prefill slots fit by the admission clamp)
        look = max((len(rows[slot]) for slot, _ in slots), default=0)
        if slots and (self._slot_len[active_np] + look
                      > eng.max_len - 1).any():
            if self._dev_lens_dirty:
                self._sync_dev_lengths()
            self._maybe_evict(active_np, look)

        ids = np.zeros((b, pad_t), np.int32)
        seq_lens = np.zeros((b,), np.int32)
        for slot, row in rows.items():
            ids[slot, : len(row)] = row
            seq_lens[slot] = len(row)
        pos = np.arange(pad_t)[None, :] + self._slot_len[:, None]
        in_range = np.arange(pad_t)[None, :] < seq_lens[:, None]
        pos = np.where(in_range, pos, eng.max_len - 1).astype(np.int32)
        kv_lens = (self._slot_len + seq_lens).astype(np.int32)
        # paged KV: reserve pages up to each row's end (provisional until
        # commit_lens below; idle slots reserve nothing)
        eng.prepare_rows(np.where(seq_lens > 0,
                                  self._slot_len + seq_lens, 0))

        sampled = self.sp.do_sample
        penalized = self._penalties_active()
        timer_key = "mixed" if slots_p else "decode"
        with self.timings.timer(timer_key, int(seq_lens.sum())):
            if sampled or penalized:
                # fetch the rows the accept loops read: every decode row,
                # but only the prompt-completing row of a prefill chunk
                need = 1
                for slot, _ in slots:
                    need = max(need, len(rows[slot]))
                r = pad_to_bucket(need, buckets) if slots_p else pad_t
                r = min(r, pad_t)
                row_idx = np.minimum(
                    np.broadcast_to(np.arange(r), (b, r)), pad_t - 1
                ).astype(np.int32).copy()
                for slot, _ in slots_p:
                    row_idx[slot, :] = len(rows[slot]) - 1
                rows_np = eng.run_verify_rows(
                    ids, pos, kv_lens, row_idx).float().cpu().numpy()
            else:
                g_np = _host(eng.run_verify_argmax(ids, pos, kv_lens))

        # prefill slots: commit the fed chunk; the completing chunk's last
        # row gives the request's first token (on the host, with the accept
        # loops' replicas)
        for slot, seq in slots_p:
            n = len(rows[slot])
            seq.fed += n
            self._slot_len[slot] += n
            self._dev_lens_dirty = True
            if seq.fed < len(seq.feed):
                continue
            pen = _PenalizedGreedy(seq.prompt, self.sp)
            self._pens[slot] = pen
            # every fetched row of a prefill slot is the completing row
            if sampled:
                p0 = _target_dist(rows_np[slot, 0], self.sp, pen.obs)
                tok = int(self._spec_rng.choice(p0.shape[0], p=p0))
            elif penalized:
                tok = pen.pick(rows_np[slot, 0], [])
            else:
                tok = int(g_np[slot, n - 1])
            pen.observe([tok])
            seq.status = SeqStatus.DECODING
            self._last_tokens[slot] = tok
            seq.generated.append(tok)
            if seq.streamer is not None:
                seq.streamer(tok)
            if (self.eos_id is not None and tok == self.eos_id) or len(
                seq.generated
            ) >= seq.max_new_tokens:
                self._finish(slot, seq)

        gain_total = 0
        for slot, seq in slots:
            draft = drafts[slot]
            pen = self._pens[slot]
            if sampled:
                # rejection sampling against the point-mass draft (as
                # speculative.generate_sampled_speculative)
                rng = self._spec_rng
                acc: List[int] = []
                while True:
                    j = len(acc)
                    p_j = _target_dist(rows_np[slot, j], self.sp,
                                       pen.obs + acc)
                    if (j < len(draft)
                            and not (self.eos_id is not None
                                     and draft[j] == self.eos_id)):
                        x = draft[j]
                        if rng.random() < p_j[x]:
                            acc.append(x)
                            continue
                        q = p_j.copy()
                        q[x] = 0.0
                        s = float(q.sum())
                        if s <= 0.0:  # a point mass at x: accept is forced
                            acc.append(x)
                            continue
                        nxt = int(rng.choice(q.shape[0], p=q / s))
                        break
                    nxt = int(rng.choice(p_j.shape[0], p=p_j))
                    break
                accepted = len(acc)
                committed = acc + [nxt]
            else:
                if penalized:
                    picks = lambda j: pen.pick(rows_np[slot, j], draft[:j])  # noqa: B023,E731,E501
                else:
                    picks = lambda j: int(g_np[slot, j])  # noqa: B023,E731
                accepted = 0
                while True:
                    g = picks(accepted)
                    if (accepted < len(draft) and g == draft[accepted]
                            and not (self.eos_id is not None
                                     and g == self.eos_id)):
                        accepted += 1
                    else:
                        nxt = g
                        break
                committed = draft[:accepted] + [nxt]
            gain_total += accepted
            pen.observe(committed)
            # KV advanced by last_tok + the accepted drafts; nxt's KV is
            # written by the next step, whose input it is.  Rejected rows
            # need no erase: kv_lens masks them and later writes overwrite.
            self._slot_len[slot] += 1 + accepted
            self._dev_lens_dirty = True
            for tok in committed:
                seq.generated.append(tok)
                self._last_tokens[slot] = tok
                if seq.streamer is not None:
                    seq.streamer(tok)
                if (self.eos_id is not None and tok == self.eos_id) or len(
                    seq.generated
                ) >= seq.max_new_tokens:
                    self._finish(slot, seq)
                    break

        if speculate and slots:
            mean_gain = gain_total / len(slots)
            self._spec_gain_ema = 0.8 * self._spec_gain_ema + 0.2 * mean_gain
            if self._spec_gain_ema < 0.35 and self.spec_backoff_chunks > 0:
                # speculation is not paying: plain decode for a spell
                self._spec_backoff = self.spec_backoff_chunks
        # paged KV: roll the provisional reservations back to what was
        # committed (no-op on the contiguous engine)
        eng.commit_lens(self._slot_len)

    def _finish(self, slot: int, seq: Sequence) -> None:
        seq.status = SeqStatus.FINISHED
        seq.end_time = time.time()
        self.running.pop(slot, None)
        self.free_slots.append(slot)
        self.finished.append(seq)
        self._pens.pop(slot, None)
        self.engine.release_slot(slot)
        self._slot_len[slot] = 0

    def _sync_sampler_from_pens(self) -> None:
        """Rebuild the device sampler's penalty state from the host replicas
        (the device ring and counts go stale during joint steps, which
        sample on the host; plain decode samples on the device)."""
        if not ((self.speculative or self.mixed_prefill)
                and self._penalties_active()):
            return
        for slot, seq in self.running.items():
            pen = self._pens.get(slot)
            if pen is None:
                continue
            self.sampler = smp.reset_slot(
                self.sampler, slot, self.sp.mirostat_tau)
            if pen.obs:
                self.sampler = smp.observe_prompt_slot(
                    self.sampler, slot, pen.obs)

    def _maybe_evict(self, active_np: np.ndarray,
                     lookahead: int = 1) -> None:
        """StreamingLLM eviction when a slot's KV would fill: not ported
        (ROADMAP section 1, item 6).  Raises before any state changes, and
        only when a slot really fills."""
        lengths = self._slot_len  # host mirror: no device sync
        full = active_np & (lengths + lookahead > self.engine.max_len - 1)
        if full.any():
            raise NotImplementedError(
                f"slots {np.nonzero(full)[0].tolist()} fill their "
                f"{self.engine.max_len}-token context: StreamingLLM eviction "
                f"is not ported yet (ROADMAP section 1, item 6)")

    def _sample_and_commit(self, logits: torch.Tensor,
                           slot_map: Dict[int, Sequence],
                           prompt_obs: Optional[List[Sequence]] = None):
        if prompt_obs:
            # reset the slot's sampler state and record the prompt for the
            # repetition penalties (the last penalty_window tokens)
            for s in prompt_obs:
                self.sampler = smp.reset_slot(
                    self.sampler, s.slot, self.sp.mirostat_tau)
                self.sampler = smp.observe_prompt_slot(
                    self.sampler, s.slot,
                    s.prompt[-self.sp.penalty_window:])
        # only the committed slots observe into the penalty state: running
        # decode slots are spectators in this full-batch logit block
        commit_mask = np.zeros((self.engine.max_batch,), bool)
        for slot in slot_map:
            commit_mask[slot] = True
        with self.timings.timer("sample", len(slot_map)):
            toks, self.sampler = smp.sample(logits, self.sampler, self.sp,
                                            active=self._dev(commit_mask))
        toks_np = _host(toks)
        for slot, seq in slot_map.items():
            tok = int(toks_np[slot])
            seq.generated.append(tok)
            self._last_tokens[slot] = tok
            if self.speculative or self.mixed_prefill:
                pen = _PenalizedGreedy(seq.prompt, self.sp)
                pen.observe([tok])
                self._pens[slot] = pen
            if seq.streamer is not None:
                seq.streamer(tok)
            if (self.eos_id is not None and tok == self.eos_id) or len(
                seq.generated
            ) >= seq.max_new_tokens:
                self._finish(slot, seq)

    # -- checkpoint / resume --------------------------------------------
    def save_state(self, path: str) -> None:
        raise NotImplementedError("scheduler checkpoints (save_state) are "
                                  "not ported yet (ROADMAP section 1, item 6)")

    @classmethod
    def load_state(cls, engine: Engine, path: str, streamers=None):
        raise NotImplementedError("scheduler checkpoints (load_state) are "
                                  "not ported yet (ROADMAP section 1, item 6)")
