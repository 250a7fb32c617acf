"""Timings (port of `neural_speed_tpu/utils/profiler.py`, in part).

* `verbose_level()` reads `NEURAL_SPEED_VERBOSE` as the JAX package does:
  -1 off, 0 timings, 1 also the generation config.
* `Timings` keeps the load / prefill / decode / sample timers and per-eval
  times and prints the `print_timings()` report, as the JAX class.  The
  timers read the host clock around the work they wrap: the scheduler
  wraps calls that end in a synchronising read, so the times are the
  card's, queue included.

Not ported: `op_profile` and `per_op_table` (the per-op table from a
device trace) are ROADMAP section 1, item 10.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field
from typing import List


def verbose_level() -> int:
    """NEURAL_SPEED_VERBOSE: -1 off, 0 timings, 1 +generation config."""
    try:
        return int(os.environ.get("NEURAL_SPEED_VERBOSE", "-1"))
    except ValueError:
        return -1


@dataclass
class Timings:
    load_s: float = 0.0
    sample_s: float = 0.0
    sample_n: int = 0
    prefill_s: float = 0.0
    prefill_tokens: int = 0
    decode_s: float = 0.0
    decode_tokens: int = 0
    eval_times: List[float] = field(default_factory=list)  # per-eval seconds
    _t0: float = field(default_factory=time.time)

    @contextlib.contextmanager
    def timer(self, kind: str, tokens: int = 1):
        tic = time.perf_counter()
        yield
        dt = time.perf_counter() - tic
        self.eval_times.append(dt)
        if kind == "load":
            self.load_s += dt
        elif kind == "prefill":
            self.prefill_s += dt
            self.prefill_tokens += tokens
        elif kind == "decode":
            self.decode_s += dt
            self.decode_tokens += tokens
        elif kind == "sample":
            self.sample_s += dt
            self.sample_n += tokens

    def print_timings(self, file=None) -> None:
        """The timings report, to stderr by default."""
        f = file or sys.stderr
        total = time.time() - self._t0
        p = self.prefill_tokens or 1
        d = self.decode_tokens or 1
        s = self.sample_n or 1
        print("\nnst_print_timings:", file=f)
        print(f"  load time    = {self.load_s*1e3:10.2f} ms", file=f)
        print(f"  sample time  = {self.sample_s*1e3:10.2f} ms / {self.sample_n}"
              f" runs ({self.sample_s*1e3/s:8.2f} ms per run)", file=f)
        print(f"  prefill time = {self.prefill_s*1e3:10.2f} ms / "
              f"{self.prefill_tokens} tokens "
              f"({self.prefill_s*1e3/p:8.2f} ms per token)", file=f)
        print(f"  decode time  = {self.decode_s*1e3:10.2f} ms / "
              f"{self.decode_tokens} tokens "
              f"({self.decode_s*1e3/d:8.2f} ms per token "
              f"= {d/max(self.decode_s,1e-9):.2f} tok/s)", file=f)
        print(f"  total time   = {total*1e3:10.2f} ms", file=f)
