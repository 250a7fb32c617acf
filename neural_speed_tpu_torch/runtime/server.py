"""ModelServer: a background worker thread and a response callback (port of
`neural_speed_tpu/runtime/server.py`).

A worker thread drains an issue queue into the continuous-batching
scheduler, steps it, and calls `response_fn(request_id, generated)` for
each finished request.  PyTorch's grad and inference modes are per thread,
so the worker runs the scheduler under `torch.inference_mode()`.  `join`
waits until every issued request's `response_fn` has returned (a count of
requests in flight, lowered after each callback), or re-raises an error of
the worker.  `speculative` (with `spec_k`) and `mixed_prefill` (with
`mixed_chunk`) reach the scheduler's joint steps.

Not ported, and raising with the ROADMAP section 1 item that ports them:
beam serving (`num_beams > 1`, `beam_config`: item 5), `save_state`
(item 6).
"""

from __future__ import annotations

import queue
import threading
import traceback
from typing import Callable, List, Optional, Sequence

import torch

from ..ops.sampling import SamplingParams
from .engine import Engine
from .scheduler import ContinuousBatchingScheduler


class ModelServer:
    def __init__(
        self,
        engine: Engine,
        response_fn: Callable[[int, List[int]], None],
        sampling: Optional[SamplingParams] = None,
        eos_id: Optional[int] = None,
        max_new_tokens: int = 128,
        speculative: bool = False,
        spec_k: int = 7,
        num_beams: int = 1,
        beam_config=None,
        mixed_prefill: bool = False,
        mixed_chunk: int = 32,
        warmup: bool = False,
        window: Optional[int] = None,
    ):
        if num_beams > 1 or beam_config is not None:
            raise NotImplementedError("beam serving (num_beams > 1, "
                                      "beam_config) is not ported yet "
                                      "(ROADMAP section 1, item 5)")
        self.sched = ContinuousBatchingScheduler(
            engine, sampling, eos_id, speculative=speculative,
            spec_k=spec_k, mixed_prefill=mixed_prefill,
            mixed_chunk=mixed_chunk, window=window,
        )
        if warmup:
            # the first kernel build and launches before real traffic
            self.sched.warmup()
        self.response_fn = response_fn
        self.max_new_tokens = max_new_tokens
        self._queue: "queue.Queue" = queue.Queue()
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        # requests issued whose response_fn has not returned yet
        self._done = threading.Condition()
        self._in_flight = 0
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- client API ------------------------------------------------------
    def issue_query(self, prompt: Sequence[int],
                    max_new_tokens: Optional[int] = None) -> None:
        # None: the server's default budget
        with self._done:
            self._in_flight += 1
        self._queue.put((list(prompt), max_new_tokens))

    def join(self) -> None:
        """Block until the response callback of every issued request has
        returned; re-raise a worker error."""
        with self._done:
            self._done.wait_for(
                lambda: self._in_flight == 0 or self._err is not None)
        if self._err:
            raise self._err

    def save_state(self, path: str, timeout: Optional[float] = 60.0) -> None:
        raise NotImplementedError("server checkpoints (save_state) are not "
                                  "ported yet (ROADMAP section 1, item 6)")

    def shutdown(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()

    # -- worker ----------------------------------------------------------
    def _worker(self) -> None:
        try:
            with torch.inference_mode():
                self._serve()
        except BaseException as e:  # surfaced on join()
            traceback.print_exc()
            with self._done:
                self._err = e
                self._done.notify_all()

    def _serve(self) -> None:
        while not self._stop.is_set():
            drained = False
            while True:
                try:
                    prompt, mnt = self._queue.get_nowait()
                    self.sched.add_request(prompt,
                                           mnt or self.max_new_tokens)
                    drained = True
                except queue.Empty:
                    break
            if self.sched.has_work:
                self.sched.step()
                for seq in self.sched.pop_finished():
                    self.response_fn(seq.request_id, seq.generated)
                    with self._done:
                        self._in_flight -= 1
                        self._done.notify_all()
            elif not drained:
                self._stop.wait(0.005)
