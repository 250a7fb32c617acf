"""Continuous-batching scheduler (port of `neural_speed_tpu/runtime/
scheduler.py`, its default path): FCFS waiting / running / finished pools
over the engine's fixed decode slots, and iteration-level steps.

A step admits and prefills a batch of waiting requests into free slots
(`_prefill_batch`), or decodes the running slots: through the engine's
EOS-aware decode window (`_window_step`, engines with `supports_window`,
the default) or through the chunk ladder (`_decode_step`, `window=1` or
`chunk_size=1`), either one pipelined: the next dispatch leaves from the
previous one's device carry, and the host commits the previous tokens
after it.  The host bookkeeping (the `_slot_len` mirror, page reservations
through `prepare_*` / `commit_lens` / `release_slot`, sampler state per
slot, streamers, finish order) follows the JAX scheduler's, name for name
and in the same order, so greedy deliveries equal the JAX package's.

The sampler state is the port's `ops/sampling` (a `torch.Generator` where
JAX has a PRNG key), so sampled ids are the port's own; a seed gives the
same ids run after run.  Steps run under `torch.inference_mode()`.

Not ported, and raising with the ROADMAP section 1 item that ports them:
`speculative` and `mixed_prefill` (item 7), eviction when a slot's context
fills (`_maybe_evict`, item 6) and `save_state` / `load_state` (item 6).
The state only those paths read (the joint steps' host penalty replicas
and device-length resync, eviction's settings, the prompt prefix a
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


def _host(t: torch.Tensor) -> np.ndarray:
    """A device tensor on the host (the one synchronising read)."""
    return t.cpu().numpy()


class ContinuousBatchingScheduler:
    """FCFS iteration-level scheduler over the Engine's fixed decode slots."""

    def __init__(self, engine: Engine,
                 params: Optional[smp.SamplingParams] = None,
                 eos_id: Optional[int] = None, seed: int = 0,
                 chunk_size: int = 8, speculative: bool = False,
                 mixed_prefill: bool = False, adaptive_chunk: bool = True,
                 pipeline_decode: bool = True,
                 window: Optional[int] = None):
        if speculative or mixed_prefill:
            raise NotImplementedError(
                f"{'speculative' if speculative else 'mixed_prefill'} "
                f"scheduling (the scheduler's joint steps) is not ported yet "
                f"(ROADMAP section 1, item 7)")
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
        self.add_request([1] * max(1, prompt_len), budget)
        self.run_to_completion()
        self.finished.clear()
        # reset to the constructed state: sampler stream, per-slot mirrors
        self.sampler = self._new_sampler()
        self._pending = None
        self._slot_len[:] = 0
        self._last_tokens[:] = 0
        self.timings = type(self.timings)()

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def step(self) -> None:
        """One scheduler iteration: admit and prefill a batch of new
        requests, or decode the running slots."""
        if self.waiting:
            # a pending decode may finish sequences and free slots; the
            # admission decision must see the post-flush state
            self._flush_pending()
        if self.waiting and self.free_slots:
            self._prefill_batch()
        elif self.running:
            self._decode_step()

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
        if not self.pipeline_decode or self.waiting:
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
                if seq.streamer is not None:
                    seq.streamer(tok)
                if (self.eos_id is not None and tok == self.eos_id) or len(
                    seq.generated
                ) >= seq.max_new_tokens:
                    active_np[slot] = False  # later chunk tokens discarded
                    self._finish(slot, seq)

    def _use_window(self) -> bool:
        return (getattr(self.engine, "supports_window", False)
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
            for tok in toks:
                seq.generated.append(tok)
                self._last_tokens[slot] = tok
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
        if not self.pipeline_decode or self.waiting:
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

    def _finish(self, slot: int, seq: Sequence) -> None:
        seq.status = SeqStatus.FINISHED
        seq.end_time = time.time()
        self.running.pop(slot, None)
        self.free_slots.append(slot)
        self.finished.append(seq)
        self.engine.release_slot(slot)
        self._slot_len[slot] = 0

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
