"""Device selection, launch counters and the lazy `nvcc` build of the kernels.

Importing this module builds nothing and needs no `nvcc`: the kernels in
`csrc/*.cu` are compiled on first use, one `nvcc` process per source, all
started together, into `build/` at the repository root, and loaded with
`ctypes`.  A build failure raises; nothing falls back to the plain versions.

Every C entry point takes its pointers as `c_void_p`, its sizes as `c_int`
and the current CUDA stream last, and returns `cudaGetLastError()` after the
launch; `check()` turns a non-zero code into an exception.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Kernel launches per wrapper (one per wrapper call that launched its
# kernel), and calls that a dispatcher answered with the plain PyTorch
# version because its tensors lay on the CPU.
launches: collections.Counter = collections.Counter()
plain_dispatches: collections.Counter = collections.Counter()
# The attention kernels' launches per head-dim instance ("<name> d<D>"),
# counted beside `launches` at the same place.
instance_launches: collections.Counter = collections.Counter()
# Kernel B's launches over several tokens per slot, per token count
# ("<name> t<T>"), counted beside `launches` at the same place.
multi_launches: collections.Counter = collections.Counter()


def reset_counts() -> None:
    launches.clear()
    plain_dispatches.clear()
    instance_launches.clear()
    multi_launches.clear()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  Raises when no card is present and none was asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


class _Library:
    """The compiled kernels: one shared library per `csrc/*.cu` source."""

    def __init__(self):
        self._libs: Optional[Dict[str, ctypes.CDLL]] = None
        self._lock = threading.Lock()
        self.build_seconds: Optional[float] = None
        self.source_seconds: Dict[str, float] = {}
        self.build_log: str = ""

    def _nvcc(self) -> str:
        for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
            if cand and os.path.exists(cand):
                return cand
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")

    def build(self) -> Dict[str, ctypes.CDLL]:
        with self._lock:
            if self._libs is None:
                self._libs = self._build_all()
            return self._libs

    def _build_all(self) -> Dict[str, ctypes.CDLL]:
        import time

        t0 = time.time()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        sources = sorted(CSRC.glob("*.cu"))
        nvcc = self._nvcc()
        procs, logs_of = {}, {}
        for src in sources:
            out = BUILD_DIR / f"lib{src.stem}.so"
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(out), str(src)]
            # each compiler writes to a file: a pipe nobody reads would block
            # it once full, while the loop below only polls
            logs_of[src.stem] = open(BUILD_DIR / f"lib{src.stem}.log", "w+")
            procs[src.stem] = subprocess.Popen(
                cmd, stdout=logs_of[src.stem], stderr=subprocess.STDOUT,
                text=True)
        pending = dict(procs)
        while pending:  # note when each compiler ends: the slowest sets the build
            for name in [n for n, p in pending.items() if p.poll() is not None]:
                self.source_seconds[name] = time.time() - t0
                del pending[name]
            time.sleep(0.05)
        logs, failed = [], []
        for name, proc in procs.items():
            with logs_of[name] as f:
                f.seek(0)
                text = f.read()
            logs.append(f"== {name} ({self.source_seconds[name]:.1f} s) ==\n{text}")
            if proc.returncode != 0:
                failed.append(name)
        self.build_log = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{self.build_log}")
        libs = {src.stem: ctypes.CDLL(str(BUILD_DIR / f"lib{src.stem}.so"))
                for src in sources}
        self.build_seconds = time.time() - t0
        return libs

    def fn(self, lib: str, name: str, n_ptr: int, n_int: int,
           n_float: int = 0):
        """C entry `name` of `lib`: `n_ptr` pointers, `n_int` ints,
        `n_float` floats, then the stream; returns an int error code."""
        f = getattr(self.build()[lib], name)
        if f.argtypes is None:
            f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                          + [ctypes.c_float] * n_float + [ctypes.c_void_p])
            f.restype = ctypes.c_int
        return f


kernels = _Library()


def stream_handle() -> int:
    return torch.cuda.current_stream().cuda_stream


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA error {code} launching {what}")
