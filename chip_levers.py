#!/usr/bin/env python3
"""Time kernels C and 9 (`csrc/flash_prefill.cuh`), the GEMV or the
float32 GEMM of kernels F and P (`csrc/qmm_fp.cuh`), or kernel B
(`csrc/flash_decode.cuh`), in variants of their header, on one NVIDIA GPU.

    python3 chip_levers.py base no_convert timed    # the variants named
    python3 chip_levers.py --dims 128,256 base      # at these head dims
    python3 chip_levers.py --gemv --check base splits_ceil   # F / P GEMV
    python3 chip_levers.py --f32 base parent        # the float32 GEMM
    python3 chip_levers.py --acc                    # its accumulation lever
    python3 chip_levers.py --rate                   # wgmma issue rates
    python3 chip_levers.py --decode parent timed    # kernel B's parent body
    python3 chip_levers.py --decode base new_timed  # ... and this tree's
    python3 chip_levers.py --decode-cases TREE out.json  # B / 10's cases

A variant (VARIANTS) is a list of (old, new) strings replaced in a copy of
`flash_prefill.cuh`; the copy is built alone (with `common.cuh` and
`qmm_fp.cuh`, one `nvcc` per head-dim source) into a temporary directory and
timed with `chip_smoke.time_ms` (CUDA events, cold L2, median of 10) on
kernel C at B = 1, T = 2048 with 1975 real rows (the bench prefill), 32
heads over int8, bf16 and float32 K/V at each head dim, each output held
against the plain version (the largest error over its 4-ulp row tolerance
is printed beside the time; a variant that skips work fails it by design).
`timed` adds `clock64` counters to the heaviest block of head 0 and prints,
per call, the cycles its consumer warpgroup spent waiting for tiles, in
Q K^T, in the softmax and in P V, and the cycles warpgroup 0 spent waiting
and converting.  With `--gemv` a variant (GEMV_VARIANTS) replaces strings
of `qmm_fp.cuh`; the F, P and grouped F/P sources are built (every one for
`base`, so that its ptxas table lists every GEMV instance: registers,
stack, spills) and the GEMV is timed on GEMV_CASES against `qmatmul_plain`
(2 bf16 ulps of the largest output); `--check` first holds every format
and row count of GEMV_CHECK_FORMATS against the plain version.  `--f32`
builds F's and P's sources alone per F32_VARIANTS variant (`parent`: the
parent commit's, unpacked into `archive_check/parent`) and holds the float32
GEMM on every `chip_smoke._f32_cases` pack at whisper's shapes and Llama o
against a float64 product, timed, with a repeat check (`run_f32`); `--acc`
runs the accumulation lever (ACC_LEVER_CU, `run_acc`); `--rate` the issue
rate probe (RATE_PROBE_CU).  `--decode` builds the `flash_decode_d<D>.cu`
sources alone per DECODE_VARIANTS variant (the parent commit's header from
`archive_check/parent`, called through its own C entry) or TREE_VARIANTS
variant (this tree's) and times kernel B on DECODE_CASES against the plain
version (`run_decode`); `--decode-cases` runs chip_smoke.py's B / 10
cases from a tree for a pair run (`run_decode_cases`).  Results go to levers.json (levers_gemv.json,
levers_f32.json, levers_acc.json, levers_rate.json, levers_decode.json) in
`chip_smoke.OUT_DIR`.
"""

import argparse
import json
import math
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# The transform's conversion, the anchor most variants replace.
_CONVERT = ("v[j] = to_bf16x8<KV>(s0 + (size_t)(j0 + j) * RSTEP * D * "
            "sizeof(KV));")
_GROUP = "ITEMS = (BC + RSTEP - 1) / RSTEP, GROUP = 4;"

VARIANTS = {
    "base": [],
    # int8 / float32: the transform stores without loading or converting
    "no_convert": [(_CONVERT, "v[j] = make_uint4(r, ch, 0u, 0u);")],
    # ... or does nothing at all (the barriers and fences stay)
    "no_transform": [("#pragma unroll\n  for (int j0 = 0; j0 < ITEMS; "
                      "j0 += GROUP) {",
                      "#pragma unroll\n  for (int j0 = 0; j0 < 0; "
                      "j0 += GROUP) {")],
    "group2": [(_GROUP, _GROUP.replace("4;", "2;"))],
    "group8": [(_GROUP, _GROUP.replace("4;", "8;"))],
    "bs3": [("constexpr int BS = 2; ", "constexpr int BS = DI > 128 ? 2 : 3; ")],
    "timed": [
        ("#include <climits>\n", "#include <climits>\n#include <cstdio>\n"),
        ("      for (int u = 0; u < nu; ++u) {\n"
         "        const int i = u / 2, st = i % BS, slot = u % L::RS;",
         "      long long pf_e = 0, pf_f = 0, pf_c = 0, pf_s = 0, pf_t;\n"
         "      for (int u = 0; u < nu; ++u) {\n"
         "        const int i = u / 2, st = i % BS, slot = u % L::RS;"),
        ("        if (!isv) bar_wait(&t_empty[st], ((i / BS) & 1) ^ 1);\n"
         "        bar_wait(&r_full[slot], (u / L::RS) & 1);",
         "        pf_t = clock64();\n"
         "        if (!isv) bar_wait(&t_empty[st], ((i / BS) & 1) ^ 1);\n"
         "        pf_e += clock64() - pf_t; pf_t = clock64();\n"
         "        bar_wait(&r_full[slot], (u / L::RS) & 1);\n"
         "        pf_f += clock64() - pf_t; pf_t = clock64();"),
        ("        asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: "
         "\"memory\");\n        asm volatile(\"bar.sync 1, 128;\\n\" ::: "
         "\"memory\");  // the slot is read",
         "        pf_c += clock64() - pf_t; pf_t = clock64();\n"
         "        asm volatile(\"fence.proxy.async.shared::cta;\\n\" ::: "
         "\"memory\");\n        asm volatile(\"bar.sync 1, 128;\\n\" ::: "
         "\"memory\");  // the slot is read\n"
         "        pf_s += clock64() - pf_t;"),
        ("        if (tid == 0 && isv) bar_arrive(&t_full[st]);\n      }\n",
         "        if (tid == 0 && isv) bar_arrive(&t_full[st]);\n      }\n"
         "      if (tid == 0 && blockIdx.x == 0 && blockIdx.y == 0) "
         "printf(\"X n=%d empty %lld full %lld conv %lld sync %lld\\n\", "
         "nu, pf_e, pf_f, pf_c, pf_s);\n"),
        ("    bar_wait(q_full, 0);\n"
         "    for (int i = 0; i < n_tiles; ++i) {",
         "    bar_wait(q_full, 0);\n"
         "    long long qw = 0, qk = 0, qs = 0, qp = 0, q_t;\n"
         "    for (int i = 0; i < n_tiles; ++i) {"),
        ("      bar_wait(&t_full[st], (i / BS) & 1);\n      float s[BC / 2];",
         "      q_t = clock64();\n"
         "      bar_wait(&t_full[st], (i / BS) & 1);\n"
         "      qw += clock64() - q_t; q_t = clock64();\n"
         "      float s[BC / 2];"),
        ("      keep_regs(s);\n\n      const int c0 = i * BC;",
         "      keep_regs(s);\n      qk += clock64() - q_t; "
         "q_t = clock64();\n      const int c0 = i * BC;"),
        ("      for (int p = 0; p < NP; ++p) keep_regs(o[p]);\n"
         "      asm volatile(\"wgmma.fence.sync.aligned;\\n\" ::: \"memory\");",
         "      for (int p = 0; p < NP; ++p) keep_regs(o[p]);\n"
         "      qs += clock64() - q_t; q_t = clock64();\n"
         "      asm volatile(\"wgmma.fence.sync.aligned;\\n\" ::: \"memory\");"),
        ("      if (tid % 128 == 0) bar_arrive(&t_empty[st]);\n    }\n",
         "      qp += clock64() - q_t;\n"
         "      if (tid % 128 == 0) bar_arrive(&t_empty[st]);\n    }\n"
         "    if (tid == 128 && blockIdx.x == 0 && blockIdx.y == 0) "
         "printf(\"C n=%d wait %lld qk %lld softmax %lld pv %lld\\n\", "
         "n_tiles, qw, qk, qs, qp);\n"),
    ],
}

# The GEMV's variants: (old, new) strings of `qmm_fp.cuh`, and the formats
# whose sources a variant builds (None: every F / P / grouped source); a
# Python-side lever replaces a wrapper function while it is timed
# (`_py_hooks`).
GEMV_VARIANTS = {
    "base": ([], None),
    # the CUDA-core GEMV's K splits by kernel A's rule, which rounds the
    # split count up (a second, short wave of blocks)
    "splits_ceil": ([], ("int5", "int3", "int7")),
    # the parent commit's GEMV (`archive_check/parent`: its sources, its
    # splits, a launch per 8 rows) on the same inputs
    "parent": ([], ("int1", "int2", "int3", "int4", "int5", "int7", "nf4",
                    "fp8_e4m3")),
}
# (label, format, group, symmetric, float offsets, shape (K, N), M, scale
# dtype)
_BF = "bfloat16"
GEMV_CASES = [
    ("int1 M=1 qkv", "int1", 128, True, False, (4096, 12288), 1, _BF),
    ("int1 M=1 o", "int1", 128, True, False, (4096, 4096), 1, _BF),
    ("int1 M=1 gateup", "int1", 128, True, False, (4096, 22016), 1, _BF),
    ("nf4 M=1 qkv", "nf4", 128, True, False, (4096, 12288), 1, _BF),
    ("nf4 M=4 o", "nf4", 128, True, False, (4096, 4096), 4, _BF),
    ("nf4 M=4 gateup", "nf4", 128, True, False, (4096, 22016), 4, _BF),
    ("nf4 M=8 gateup", "nf4", 128, True, False, (4096, 22016), 8, _BF),
    ("q2_k M=8 qkv", "int2", 16, False, True, (4096, 12288), 8, "float32"),
    ("q2_k M=8 gateup", "int2", 16, False, True, (4096, 22016), 8, "float32"),
    ("gptq M=1 qkv", "int4", 128, False, False, (4096, 12288), 1, "float32"),
    ("gptq M=5 qkv", "int4", 128, False, False, (4096, 12288), 5, "float32"),
    ("gptq M=8 qkv", "int4", 128, False, False, (4096, 12288), 8, "float32"),
    ("gptq M=8 gateup", "int4", 128, False, False, (4096, 22016), 8, "float32"),
    ("q4_0 M=8 qkv", "int4", 32, True, False, (4096, 12288), 8, "float32"),
    ("q4_0 M=8 gateup", "int4", 32, True, False, (4096, 22016), 8, "float32"),
    ("int2 asym M=1 o", "int2", 128, False, False, (4096, 4096), 1, "float32"),
    ("int5 asym M=1 qkv", "int5", 128, False, False, (4096, 12288), 1, _BF),
    ("int5 asym M=1 down", "int5", 128, False, False, (12288, 4096), 1, _BF),
    ("int5 asym M=4 qkv", "int5", 128, False, False, (4096, 12288), 4, _BF),
    ("int5 asym M=8 qkv", "int5", 128, False, False, (4096, 12288), 8, _BF),
    ("int3 M=1 qkv", "int3", 128, True, False, (4096, 12288), 1, _BF),
    ("int7 M=1 qkv", "int7", 128, True, False, (4096, 12288), 1, _BF),
    ("int7 M=8 qkv", "int7", 128, True, False, (4096, 12288), 8, _BF),
    ("nf4 M=4 qkv", "nf4", 128, True, False, (4096, 12288), 4, _BF),
    ("e4m3 M=8 qkv", "fp8_e4m3", 128, True, False, (4096, 12288), 8, _BF),
    ("nf4 M=16 qkv", "nf4", 128, True, False, (4096, 12288), 16, _BF),
    ("e4m3 M=16 qkv", "fp8_e4m3", 128, True, False, (4096, 12288), 16, _BF),
]

# Held against `qmatmul_plain` only (no timing) with `--check`: every
# format and zero mode of F and P at Llama's o (4096, 4096) and these rows,
# bf16 x, and float32 x at a few.
GEMV_CHECK_FORMATS = [
    ("nf4", "nf4", 128, True, False), ("fp4 f32s", "fp4", 128, True, False),
    ("int1", "int1", 128, True, False), ("int2 asym", "int2", 128, False, False),
    ("q2_k", "int2", 16, False, True), ("int3", "int3", 128, True, False),
    ("gptq", "int4", 128, False, False), ("q4_0", "int4", 32, True, False),
    ("q4_1 g8", "int4", 8, False, True), ("int5 asym", "int5", 128, False, False),
    ("int5 off", "int5", 64, False, True), ("int6", "int6", 128, True, False),
    ("int7", "int7", 128, True, False), ("q8_0", "int8", 32, True, False),
    ("int8 asym", "int8", 128, False, False), ("int8 off", "int8", 16, False, True),
    ("e4m3", "fp8_e4m3", 128, True, False), ("e5m2", "fp8_e5m2", 128, True, False)]
GEMV_CHECK_M = (1, 4, 5, 8, 9, 16, 31, 32)
GEMV_CHECK_M_F32 = (1, 4, 9, 32)


def check_gemv() -> list:
    """Every GEMV_CHECK_FORMATS pack at every GEMV_CHECK_M (bf16) and
    GEMV_CHECK_M_F32 (float32 x) against the plain version: the largest
    error over its tolerance per case (2 bf16 ulps of the largest output;
    float32: 256 float32 ulps)."""
    import torch

    import chip_smoke as cs
    from neural_speed_tpu_torch.ops import matmul
    from neural_speed_tpu_torch.ops.qtypes import named_qspec
    from neural_speed_tpu_torch.utils.synthetic import synth_qtensor

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, bad = [], []
    for label, fmt, g, sym, off in GEMV_CHECK_FORMATS:
        sd = "bfloat16" if label in ("nf4", "int1", "int5 asym") else "float32"
        qt = synth_qtensor(gen, 4096, 4096, named_qspec(fmt, g, sym, sd))
        if off:
            qt = cs._float_offsets(gen, qt)
        for dt, ms_ in ((torch.bfloat16, GEMV_CHECK_M),
                        (torch.float32, GEMV_CHECK_M_F32)):
            for m in ms_:
                x = torch.randn((m, 4096), generator=gen, device="cuda").to(dt)
                got = matmul.qmatmul(x, qt)
                want = matmul.qmatmul_plain(x, qt)
                torch.cuda.synchronize()
                if dt == torch.bfloat16:
                    worst = cs.compare(got, want, 2, per_row=False)["worst"]
                else:
                    ref = x.double() @ __import__(
                        "neural_speed_tpu_torch.ops.quantize", fromlist=["x"]
                    ).dequantize(qt, torch.float32).double()
                    worst = cs.compare_f64(got, ref)["worst"]
                rows.append((label, str(dt).replace("torch.", ""), m, worst))
                if not worst <= 1.0:
                    bad.append(rows[-1])
        print(f"check {label}: " + json.dumps([round(r[3], 3) for r in rows
                                               if r[0] == label]), flush=True)
    print(f"check: {len(rows)} cases, {len(bad)} beyond the tolerance: "
          + json.dumps(bad), flush=True)
    return rows


def _py_hooks(name):
    """Python-side levers: (module, attribute, replacement) while a variant
    is timed."""
    from neural_speed_tpu_torch.ops import matmul

    ceil = (matmul, "fp_gemv_simt_splits",
            lambda k, n, bands, cols, n_sm, per_sm=4: matmul._gemv_splits(
                k, n, n_sm, bands, cols))
    if name == "splits_ceil":  # the rule `_gemv_splits` keeps for kernel A
        return [ceil]
    if name == "parent":  # every M <= 32 through the CUDA-core entry
        return [ceil, (matmul, "fp_gemv_body", lambda m, dt: "simt")]
    return []


def ptxas_table(log: str, pattern: str = "gemv|splitk") -> list:
    """(function, registers, stack bytes, spill bytes) of each entry of a
    `-Xptxas -v` log whose (demangled) name matches `pattern`."""
    import re
    import subprocess

    rows, fn = [], None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn, stack, spill = m.group(1), None, None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and fn:
            stack, spill = int(m.group(1)), int(m.group(2)) + int(m.group(3))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            rows.append([fn, int(m.group(1)), stack, spill])
            fn = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True).stdout.split("\n")
        for r, nm in zip(rows, names):
            r[0] = nm or r[0]
    except OSError:
        pass
    return sorted({tuple(r) for r in rows if re.search(pattern, r[0])})


def _gemv_sources(tmp: Path, reps, fmts, parent: bool = False) -> None:
    csrc = ROOT / "neural_speed_tpu_torch" / "csrc"
    if parent:  # the parent commit unpacked by `git archive`
        csrc = ROOT / "archive_check" / "parent" / "neural_speed_tpu_torch" / "csrc"
    for f in csrc.iterdir():
        stem = f.stem
        keep = f.name in ("qmm_fp.cuh", "qmatmul_planar.cuh",
                          "qmatmul_grouped_fp.cuh")
        if f.suffix == ".cu" and stem.startswith(
                ("qmatmul_planar_", "qmatmul_grouped_fp_", "qmatmul_lut")):
            key = stem.rsplit("_", 1)[1]
            key = {"lut": "nf4", "e4m3": "fp8_e4m3", "e5m2": "fp8_e5m2"}.get(key, key)
            keep = fmts is None or key in fmts
        if keep:
            shutil.copy(f, tmp / f.name)
    src = (tmp / "qmm_fp.cuh").read_text()
    for old, new in reps:
        if src.count(old) != 1:
            raise ValueError(f"the header has not one copy of {old[:60]!r}")
        src = src.replace(old, new)
    (tmp / "qmm_fp.cuh").write_text(src)


def run_gemv(names, check: bool = False) -> dict:
    import torch

    import chip_smoke as cs
    from neural_speed_tpu_torch import _build
    from neural_speed_tpu_torch.ops import matmul
    from neural_speed_tpu_torch.ops.qtypes import named_qspec
    from neural_speed_tpu_torch.utils.synthetic import synth_qtensor

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {}
    for label, fmt, g, sym, off, (k, n), m, sdt in GEMV_CASES:
        qt = synth_qtensor(gen, k, n, named_qspec(fmt, g, sym, sdt))
        if off:
            qt = cs._float_offsets(gen, qt)
        x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        cases[label] = (fmt, x, qt)
    res = {}
    for name in names:
        reps, fmts = GEMV_VARIANTS[name]
        tmp = Path(tempfile.mkdtemp())
        _gemv_sources(tmp, reps, fmts, parent=name == "parent")
        _build.CSRC, _build.BUILD_DIR = tmp, tmp / "build"
        _build.kernels = _build._Library()
        t0 = time.time()
        _build.kernels.build()
        table = ptxas_table(_build.kernels.build_log)
        for row in table:
            print("  ptxas " + json.dumps(row), flush=True)
        if check and fmts is None:
            res[name + " check"] = check_gemv()
        out = {}
        saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in _py_hooks(name)]
        for mod, attr, fn in _py_hooks(name):
            setattr(mod, attr, fn)
        for label, (fmt, x, qt) in cases.items():
            if fmts is not None and fmt not in fmts:
                continue
            ms = cs.time_ms(lambda: matmul.qmatmul(x, qt))
            err = cs.compare(matmul.qmatmul(x, qt), matmul.qmatmul_plain(x, qt),
                             2, per_row=False)["worst"]
            out[label] = (ms, err)
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
        torch.cuda.synchronize()
        res[name] = dict(times=out, ptxas=table)
        print(f"{name} (built in {time.time() - t0:.1f} s): "
              + json.dumps({k: [round(v[0], 4), round(v[1], 3)]
                            for k, v in out.items()}), flush=True)
        shutil.rmtree(tmp, ignore_errors=True)
    return res


# The float32 GEMM's accumulation lever (`--acc`): a plain 3xTF32 GEMM on
# `wgmma` (one warpgroup, 64 x 128 tiles, K steps of 64; x and the float32
# weight staged by plain loads, W split into TF32 hi + lo pairs in the
# 128-byte-swizzled K-major tiles, x split in registers).  MODE: 0 the
# three products (lo_x hi_w, hi_x lo_w, hi_x hi_w) accumulated over the
# whole K in the tensor-core accumulator; 1 a fresh accumulator every K
# step, added into a float32 register total (round to nearest); 2 one
# product (hi_x hi_w: 1xTF32); 3 as 0 with hi_x hi_w first; 4 as 0 with
# A's fragment rows and columns swapped (a layout probe: it must fail).
ACC_LEVER_CU = r"""
#include "qmm_fp.cuh"

using namespace nstfp;
using namespace nstfp::tc;

namespace {
constexpr int LBM = 64, LBK = 64, LXS = LBK + 4;
constexpr int LEVER_SMEM = 65536 + LBM * LXS * 4 + 1024;

template <int MODE>
__global__ void __launch_bounds__(128, 1)
acc_lever_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 float* __restrict__ out, int M, int K, int N) {
  extern __shared__ unsigned char lsm_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(lsm_raw) + 1023) & ~(uintptr_t)1023);
  unsigned char* wh = sm;          // [2][128][32] TF32, 128-byte swizzle
  unsigned char* wl = sm + 32768;
  float* xs = reinterpret_cast<float*>(sm + 65536);
  const int t = threadIdx.x, wq = t / 32, lane = t % 32, g = lane / 4, q = lane % 4;
  const int m0 = blockIdx.y * LBM, n0 = blockIdx.x * tc::BN;
  float acc[64], tot[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += LBK) {
    for (int i = t; i < LBM * LBK; i += 128) {
      const int r = i / LBK, k = i % LBK;
      xs[r * LXS + k] = (m0 + r < M && k0 + k < K) ? x[(size_t)(m0 + r) * K + k0 + k] : 0.f;
    }
    for (int k = 0; k < LBK; ++k) {
      const int n = n0 + t;
      const float v = (n < N && k0 + k < K) ? w[(size_t)(k0 + k) * N + n] : 0.f;
      const uint32_t h = tf32_rna(v), l = tf32_rna(v - __uint_as_float(h));
      const int off = (k / 32) * 16384 + sw128_chunk(t, (k % 32) / 4) + (k % 4) * 4;
      *reinterpret_cast<uint32_t*>(wh + off) = h;
      *reinterpret_cast<uint32_t*>(wl + off) = l;
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
#pragma unroll 1
    for (int kk = 0; kk < LBK / 8; ++kk) {
      const float* xr = xs + (16 * wq + g) * LXS + 8 * kk + q;
      float a[4] = {xr[0], xr[8 * LXS], xr[4], xr[8 * LXS + 4]};
      if (MODE == 4) {
        const float s = a[1];
        a[1] = a[2];
        a[2] = s;
      }
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        hi[j] = tf32_rna(a[j]);
        lo[j] = tf32_rna(a[j] - __uint_as_float(hi[j]));
      }
      const uint64_t dh = sw128_desc(wh + (kk / 4) * 16384) + 2 * (kk % 4);
      const uint64_t dl = sw128_desc(wl + (kk / 4) * 16384) + 2 * (kk % 4);
      const int sd = (MODE == 1 && kk == 0) ? 0 : 1;
      keep_regs(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      if (MODE == 2) {
        wgmma_tf32_rs(acc, hi, dh, sd);
      } else if (MODE == 3) {
        wgmma_tf32_rs(acc, hi, dh, sd);
        wgmma_tf32_rs(acc, lo, dh, 1);
        wgmma_tf32_rs(acc, hi, dl, 1);
      } else {
        wgmma_tf32_rs(acc, lo, dh, sd);
        wgmma_tf32_rs(acc, hi, dl, 1);
        wgmma_tf32_rs(acc, hi, dh, 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      keep_regs(acc);
    }
    if (MODE == 1) {
#pragma unroll
      for (int i = 0; i < 64; ++i) tot[i] += acc[i];
    }
    __syncthreads();
  }
  store_tile<128>(MODE == 1 ? tot : acc, out, m0, n0, M, M, N);
}

template <int MODE>
cudaError_t launch_lever(const float* x, const float* w, float* out, int M, int K, int N,
                         cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(acc_lever_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         LEVER_SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((N + tc::BN - 1) / tc::BN, (M + LBM - 1) / LBM);
  acc_lever_kernel<MODE><<<grid, 128, LEVER_SMEM, st>>>(x, w, out, M, K, N);
  return cudaGetLastError();
}
}  // namespace

extern "C" int nst_acc_lever(const void* x, const void* w, void* out, int M, int K, int N,
                             int mode, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return (int)launch_lever<0>(xf, wf, o, M, K, N, st);
    case 1: return (int)launch_lever<1>(xf, wf, o, M, K, N, st);
    case 2: return (int)launch_lever<2>(xf, wf, o, M, K, N, st);
    case 3: return (int)launch_lever<3>(xf, wf, o, M, K, N, st);
    case 4: return (int)launch_lever<4>(xf, wf, o, M, K, N, st);
  }
  return (int)cudaErrorInvalidValue;
}
"""
ACC_MODES = {0: "3xTF32, whole K in the accumulator",
             1: "3xTF32, a fresh accumulator per K step folded into float32",
             2: "1xTF32", 3: "3xTF32, whole K, hi x hi first",
             4: "3xTF32 with A's fragment layout swapped (probe)"}
# (label, format, group, symmetric) at whisper's fc2 (K = 5120) over its
# 1500 frames and Llama-2-7B's o (K = 4096) at 2048 rows
ACC_FORMATS = [("int8 sym f32", "int8", 128, True), ("nf4", "nf4", 128, True),
               ("int5 asym", "int5", 128, False)]
ACC_SHAPES = [("fc2", 5120, 1280, 1500), ("llama o", 4096, 4096, 2048)]


def acc_rounding_probe(lever) -> dict:
    """How the tensor cores round a TF32 sum into the float32 accumulator:
    one wgmma puts 1.0 (or -1.0) in the accumulator, the next adds f ulps
    of it (f = 0.25, 0.5, 0.75), exactly representable in TF32; the result
    minus the start, in ulps of 1.0 (0 or 1 for round to nearest at 0.75:
    1; toward zero: 0).  The same sum inside one wgmma (both products in
    one k8 step) is printed beside it."""
    import torch

    fr = (0.25, 0.5, 0.75)
    m, k, n = 64, 64, 128
    x = torch.zeros((m, k), device="cuda")
    w = torch.zeros((k, n), device="cuda")
    w[0], w[1], w[8] = 1.0, 1.0, 1.0
    for i, f in enumerate(fr):
        for sgn in (1.0, -1.0):
            r = 2 * i + (sgn < 0)
            x[r, 0], x[r, 8] = sgn, sgn * f * 2.0 ** -23            # two steps
            x[32 + r, 0], x[32 + r, 1] = sgn, sgn * f * 2.0 ** -23  # one step
    out = torch.empty((m, n), device="cuda")
    lever(x, w, out, 0)
    torch.cuda.synchronize()
    res = {}
    for i, f in enumerate(fr):
        for sgn in (1.0, -1.0):
            r = 2 * i + (sgn < 0)
            res[f"{sgn * f:+.2f} ulp across steps"] = (
                (out[r, 0].double().abs() - 1.0) / 2.0 ** -23).item()
            res[f"{sgn * f:+.2f} ulp in one step"] = (
                (out[32 + r, 0].double().abs() - 1.0) / 2.0 ** -23).item()
    return res


def run_acc() -> dict:
    """Step 0 of the float32 GEMM's design: compare_f64's worst for each
    ACC_MODES variant of the lever on ACC_FORMATS x ACC_SHAPES (the
    dequantized float32 weight, x drawn as check_f32_formats draws it), the
    accumulator's rounding (acc_rounding_probe), the lever's ms, and the
    `ptxas -v` table of every GEMM instance of this tree's F / P sources
    (the float32 GEMM's among them)."""
    import torch

    import chip_smoke as cs
    from neural_speed_tpu_torch import _build
    from neural_speed_tpu_torch.ops.quantize import dequantize
    from neural_speed_tpu_torch.ops.qtypes import named_qspec
    from neural_speed_tpu_torch.utils.synthetic import synth_qtensor

    tmp = Path(tempfile.mkdtemp())
    _gemv_sources(tmp, [], None)
    for f in tmp.glob("qmatmul_grouped_fp*"):
        f.unlink()
    (tmp / "acc_lever.cu").write_text(ACC_LEVER_CU)
    _build.CSRC, _build.BUILD_DIR = tmp, tmp / "build"
    _build.kernels = _build._Library()
    t0 = time.time()
    _build.kernels.build()
    print(f"built in {time.time() - t0:.1f} s", flush=True)
    table = ptxas_table(_build.kernels.build_log, "gemm|acc_lever")
    for row in table:
        print("  ptxas " + json.dumps(row), flush=True)
    fn = _build.kernels.fn("acc_lever", "nst_acc_lever", 3, 4)

    def lever(x, w, out, mode):
        _build.check(fn(x.data_ptr(), w.data_ptr(), out.data_ptr(), x.shape[0],
                        x.shape[1], w.shape[1], mode, _build.stream_handle()),
                     "acc_lever")

    res = dict(ptxas=table, probe=acc_rounding_probe(lever), cases={})
    print("rounding probe: " + json.dumps(res["probe"]), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for shape, k, n, m in ACC_SHAPES:
        for label, fmt, g, sym in ACC_FORMATS:
            qt = synth_qtensor(gen, k, n, named_qspec(fmt, g, sym))
            w = dequantize(qt, torch.float32).contiguous()
            x = torch.randn((m, k), generator=gen, device="cuda") * 1.37
            ref = x.double() @ w.double()
            row = {}
            for mode in ACC_MODES:
                out = torch.empty((m, n), device="cuda")
                lever(x, w, out, mode)
                torch.cuda.synchronize()
                row[mode] = dict(worst=cs.compare_f64(out, ref)["worst"],
                                 ms=cs.time_ms(lambda: lever(x, w, out, mode)))
            row["plain f32 matmul"] = dict(
                worst=cs.compare_f64(x @ w, ref)["worst"],
                ms=cs.time_ms(lambda: x @ w))
            key = f"{label} {shape} M={m} K={k} N={n}"
            res["cases"][key] = row
            print(f"{key}: " + json.dumps({str(md): [round(v["worst"], 4),
                                                     round(v["ms"], 4)]
                                           for md, v in row.items()}),
                  flush=True)
            del qt, w, x, ref
    print("modes: " + json.dumps(ACC_MODES), flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return res


# The tensor cores' issue rate (`--rate`): one block of two warpgroups,
# each issuing groups of 12 wgmma on zeroed shared-memory tiles into its own
# accumulator and waiting for each group, clock64 around 200 groups;
# printed as cycles per wgmma.  MODE: 0 m64n128k16 bf16 (A and B from
# shared memory), 1 m64n128k8 TF32 with A from registers (the float32
# GEMM's form), 2 the same with one warpgroup alone.
RATE_PROBE_CU = r"""
#include <cstdio>
#include "qmm_fp.cuh"

using namespace nstfp::tc;

namespace {
template <int MODE>
__global__ void __launch_bounds__(256, 1) rate_kernel(long long* out) {
  extern __shared__ unsigned char rsm_raw[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(rsm_raw) + 1023) & ~(uintptr_t)1023);
  for (int i = threadIdx.x; i < 65536 / 16; i += blockDim.x)
    reinterpret_cast<uint4*>(sm)[i] = make_uint4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int c = threadIdx.x / 128;
  if (MODE == 2 && c == 1) return;
  const uint64_t da = sw128_desc(sm + c * 8192), db = sw128_desc(sm + 32768);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const long long t0 = clock64();
  for (int it = 0; it < 200; ++it) {
    keep_regs(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      const uint32_t za[4] = {0u, 0u, 0u, 0u};
      if (MODE == 0)
        Wgmma<128>::mma(acc, da + 2 * (k % 4), db + 2 * (k % 4));
      else
        wgmma_tf32_rs(acc, za, db + 2 * (k % 4), 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    keep_regs(acc);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  keep_regs(acc);
  const long long t1 = clock64();
  if (threadIdx.x % 128 == 0) out[c] = t1 - t0;
  if (acc[0] != 0.f) out[2] = 1;
}

template <int MODE>
int launch(long long* out, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(rate_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, 66560);
  if (err != cudaSuccess) return (int)err;
  rate_kernel<MODE><<<1, 256, 66560, st>>>(out);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" int nst_rate_probe(void* out, int mode, void* stream) {
  long long* o = static_cast<long long*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: return launch<0>(o, st);
    case 1: return launch<1>(o, st);
    case 2: return launch<2>(o, st);
  }
  return (int)cudaErrorInvalidValue;
}
"""
RATE_MODES = {0: "bf16 m64n128k16, 2 warpgroups",
              1: "tf32 m64n128k8, A from registers, 2 warpgroups",
              2: "tf32 m64n128k8, A from registers, 1 warpgroup"}


def run_rate() -> dict:
    """RATE_PROBE_CU's cycles per wgmma for each RATE_MODES mode (median of
    5 launches, the slower warpgroup)."""
    import statistics

    import torch

    from neural_speed_tpu_torch import _build

    tmp = Path(tempfile.mkdtemp())
    shutil.copy(ROOT / "neural_speed_tpu_torch" / "csrc" / "qmm_fp.cuh", tmp)
    (tmp / "rate_probe.cu").write_text(RATE_PROBE_CU)
    _build.CSRC, _build.BUILD_DIR = tmp, tmp / "build"
    _build.kernels = _build._Library()
    _build.kernels.build()
    fn = _build.kernels.fn("rate_probe", "nst_rate_probe", 1, 1)
    res = {}
    for mode, what in RATE_MODES.items():
        per = []
        for _ in range(5):
            out = torch.zeros(3, dtype=torch.int64, device="cuda")
            _build.check(fn(out.data_ptr(), mode, _build.stream_handle()), "rate")
            torch.cuda.synchronize()
            per.append(max(out[:2].tolist()) / (200 * 12))
        res[what] = statistics.median(per)
        print(f"  {what}: {res[what]:.1f} cycles per wgmma", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    return res


# The float32 GEMM's variants (`--f32`): (old, new) strings of
# `qmm_fp.cuh`; "parent" builds the parent commit's sources
# (`archive_check/parent`, unpacked by `git archive`) unchanged.
_F32_MMAS = ("        wgmma_tf32_rs(acc, xl[p], bh + 2 * kk, kk == 0 ? 0 : 1);\n"
             "        wgmma_tf32_rs(acc, xh[p], bl + 2 * kk, 1);\n"
             "        wgmma_tf32_rs(acc, xh[p], bh + 2 * kk, 1);\n")
_F32_LEVER = ("nf4", "int8", "int5")
F32_VARIANTS = {
    "base": ([], None),
    # no products (the loads, the transform, the splits and the barriers)
    "no_mma": ([(_F32_MMAS, "        acc[kk] += __uint_as_float(xh[p][0] ^ xl[p][1]);\n")],
               _F32_LEVER),
    # the transform writes (almost) nothing: one weight of eight computed,
    # no W tile stored (the products run on stale tiles)
    "no_transform": ([
        ("          store_tf32x8(bt, tl, ((row0 + i) * EF + band0) / 8 + o, v);\n",
         "          if (v[0] == 1.2345f) store_tf32x8(bt, tl, ((row0 + i) * EF + band0) / 8 + o, v);\n"),
        ("        store_tf32x8(bt, col + j, oct, v);\n",
         "        if (v[0] == 1.2345f) store_tf32x8(bt, col + j, oct, v);\n"),
    ], _F32_LEVER),
    # clock64 counters in block (0, 0), printed at its end: per transform
    # warp (packed formats) the cycles of the whole loop, in the hook (the
    # packs' loads thread 0 issues), waiting for the packed tile and for a
    # free W slot; per consumer warpgroup the loop, the waits for W and x,
    # the k8 steps' reads, splits and issues, and the last wait for the
    # products
    "timed": ([
        ("#include <climits>\n", "#include <climits>\n#include <cstdio>\n"),
        ("  reload(0);\n  for (int s = 0; s < steps; ++s) {\n    hook(s);\n"
         "    const int ws = s % RG::kSW;\n    bar_wait(&w_full[ws], (s / RG::kSW) & 1);\n",
         "  reload(0);\n  long long pf_hook = 0, pf_w = 0, pf_b = 0, pf_all = clock64();\n"
         "  for (int s = 0; s < steps; ++s) {\n    long long pt0 = clock64();\n    hook(s);\n"
         "    long long pt1 = clock64();\n"
         "    const int ws = s % RG::kSW;\n    bar_wait(&w_full[ws], (s / RG::kSW) & 1);\n"
         "    pf_hook += pt1 - pt0; pf_w += clock64() - pt1;\n"),
        ("    const int bst = s % RG::kSB;\n    bar_wait(&b_empty[bst], ((s / RG::kSB) & 1) ^ 1);\n"
         "    unsigned char* bt = reinterpret_cast<unsigned char*>(bs_all) + bst * RG::kBStage;\n"
         "    if constexpr (A4) {",
         "    const int bst = s % RG::kSB;\n    long long pt3 = clock64();\n"
         "    bar_wait(&b_empty[bst], ((s / RG::kSB) & 1) ^ 1);\n    pf_b += clock64() - pt3;\n"
         "    unsigned char* bt = reinterpret_cast<unsigned char*>(bs_all) + bst * RG::kBStage;\n"
         "    if constexpr (A4) {"),
        ("    if (s + 1 < steps) reload(s + 1);\n  }\n}\n\n// Transform warpgroups, byte rows",
         "    if (s + 1 < steps) reload(s + 1);\n  }\n"
         "  if (RG::kTf32 && blockIdx.x == 0 && blockIdx.y == 0 && lane == 0)\n"
         "    printf(\"T warp %d steps %d all %lld hook %lld wfull %lld bempty %lld\\n\", "
         "(int)(threadIdx.x / 32), steps, clock64() - pf_all, pf_hook, pf_w, pf_b);\n"
         "}\n\n// Transform warpgroups, byte rows"),
        ("    for (int s = 0; s < steps; ++s) {\n      const int xst = s % SX, bst = s % SB;\n"
         "      bar_wait(&b_full[bst], (s / SB) & 1);\n      bar_wait(&x_full[xst * 2 + c], (s / SX) & 1);\n",
         "    long long pc_b = 0, pc_i = 0, pc_w = 0, pc_all = clock64(), pc0;\n"
         "    for (int s = 0; s < steps; ++s) {\n      const int xst = s % SX, bst = s % SB;\n"
         "      pc0 = clock64();\n"
         "      bar_wait(&b_full[bst], (s / SB) & 1);\n      bar_wait(&x_full[xst * 2 + c], (s / SX) & 1);\n"
         "      pc_b += clock64() - pc0;\n"),
        ("      const uint64_t bl = sw128_desc(bs + bst * b_stage + TF32_TILE);\n",
         "      const uint64_t bl = sw128_desc(bs + bst * b_stage + TF32_TILE);\n"
         "      pc0 = clock64();\n"),
        ("      asm volatile(\"wgmma.wait_group.sync.aligned 0;\\n\" ::: \"memory\");\n"
         "      keep_regs(acc);\n      if (t == 0) {  // step s's products",
         "      pc_i += clock64() - pc0; pc0 = clock64();\n"
         "      asm volatile(\"wgmma.wait_group.sync.aligned 0;\\n\" ::: \"memory\");\n"
         "      pc_w += clock64() - pc0;\n"
         "      keep_regs(acc);\n      if (t == 0) {  // step s's products"),
        ("    store_tile<BN>(tot, out, m_blk + 64 * c, n_blk, M, M, N);\n",
         "    if (blockIdx.x == 0 && blockIdx.y == 0 && t == 0)\n"
         "      printf(\"C wg %d steps %d all %lld wait %lld issue %lld drain %lld\\n\", "
         "c, steps, clock64() - pc_all, pc_b, pc_i, pc_w);\n"
         "    store_tile<BN>(tot, out, m_blk + 64 * c, n_blk, M, M, N);\n"),
    ], ("nf4", "int5")),
    # the parent's sources as they are (its float32 SIMT GEMM)
    "parent": ([], None),
}
# the cases a lever variant (a format list above) is timed on
F32_LEVER_CASES = ("q/k/v/o M=1500", "fc1 M=1500", "fc2 M=1500", "llama o M=2048")
F32_M = {"q/k/v/o": (33, 100, 1500), "fc1": (33, 100, 1500),
         "fc2": (33, 100, 1500), "llama o": (33, 100, 2048)}
F32_REPEAT = 20


def run_f32(names) -> dict:
    """Each F32_VARIANTS variant of the float32 GEMM built alone (kernel F's
    and P's sources), its `ptxas -v` table, and on every `chip_smoke.
    _f32_cases` pack at whisper-large-v2's and Llama-2-7B o's shapes and
    F32_M rows: compare_f64's worst against a float64 product of the same
    dequantized weight, the kernel's ms, and F32_REPEAT calls of the fc1
    case at M = 1500 compared byte for byte."""
    import torch

    import chip_smoke as cs
    from neural_speed_tpu_torch import _build
    from neural_speed_tpu_torch.ops import matmul
    from neural_speed_tpu_torch.ops.quantize import dequantize
    from neural_speed_tpu_torch.utils.synthetic import synth_qtensor

    shapes = dict(cs.WHISPER_LINEARS, **{"llama o": cs.SHAPES_7B["o"]})
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = []
    for kname, letter, spec, transform in cs._f32_cases():
        for shape, (k, n) in shapes.items():
            qt = synth_qtensor(gen, k, n, spec)
            if transform is not None:
                qt = transform(gen, qt)
            w64 = dequantize(qt, torch.float32).double()
            for m in F32_M[shape]:
                x = torch.randn((m, k), generator=gen, device="cuda") * 1.37
                cases.append((f"{cs._fmt_name(qt)} {shape} M={m}", x, qt,
                              x.double() @ w64))
            del w64
    res = {}
    for name in names:
        tmp = Path(tempfile.mkdtemp())
        reps, fmts = F32_VARIANTS[name]
        _gemv_sources(tmp, reps, fmts, parent=name == "parent")
        for f in tmp.glob("qmatmul_grouped_fp*"):
            f.unlink()
        _build.CSRC, _build.BUILD_DIR = tmp, tmp / "build"
        _build.kernels = _build._Library()
        t0 = time.time()
        _build.kernels.build()
        table = ptxas_table(_build.kernels.build_log, "gemm_tf32x3|gemm_f32")
        for row in table:
            print("  ptxas " + json.dumps(row), flush=True)
        notes = sorted({ln.strip() for ln in _build.kernels.build_log.splitlines()
                        if "wgmma" in ln})
        for ln in notes:
            print("  ptxas note: " + ln, flush=True)
        out = {}
        for label, x, qt, ref in cases:
            if fmts is not None and not (
                    label.endswith(F32_LEVER_CASES)
                    and label.split("/")[0].split(" ")[0] in fmts):
                continue
            got = matmul.qmatmul(x, qt)
            torch.cuda.synchronize()
            worst = cs.compare_f64(got, ref)["worst"]
            out[label] = (cs.time_ms(lambda: matmul.qmatmul(x, qt)), worst)
            print(f"  {name} {label}: {out[label][0]:.4f} ms, worst "
                  f"{worst:.4f}", flush=True)
        label, x, qt, _ = next(c for c in cases if c[0].endswith("fc1 M=1500")
                               and (fmts is None or c[0].split("/")[0] in fmts))
        first = matmul.qmatmul(x, qt)
        differ = sum(int(not torch.equal(matmul.qmatmul(x, qt), first))
                     for _ in range(F32_REPEAT))
        print(f"  {name} repeat {label}: {differ} of {F32_REPEAT} calls "
              f"differ", flush=True)
        res[name] = dict(times=out, ptxas=table, ptxas_notes=notes,
                         repeat_differ=differ,
                         build_s=time.time() - t0)
        shutil.rmtree(tmp, ignore_errors=True)
    return res


# Kernels B and 10 (`--decode`): the parent commit's body (`parent`: the
# split kernel and the combine kernel of `archive_check/parent`, called
# through its own C entry) and the same with clock64 counters in block
# (0, 0, 0) of the split kernel (`timed`: per 128-column sub-chunk, the
# cycles of thread 0 in the V loads, the scores, the row maxima, the
# softmax, P V and the three barriers); `base` is this tree's body through
# `flash.decode_cuda`.  Cases (DECODE_CASES): Llama-2-7B's 32 KV heads and
# Mixtral's 8 under 32 query heads, int8 (the extra column and the fused
# append) and bf16 K/V, at B = 1 (kv_len 1976) and B = 4 (phase 2's ragged
# lengths, a spectator), and Grok-1's 48 over 8 with the softcap (int8).
_SUB_END = ("          acc[r][f] = acc[r][f] * alpha[r] + a;\n        }\n      }\n"
            "    }\n    __syncthreads();\n  }\n")
_GT = "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"({}));"
DECODE_VARIANTS = {
    "parent": [],
    "timed": [
        ("#include \"common.cuh\"\n", "#include \"common.cuh\"\n#include <cstdio>\n"),
        ("  for (int cs = c0; cs < c1; cs += THREADS) {\n    const int c = cs + tid;",
         "  long long tl = 0, ts = 0, tm = 0, tx = 0, tp = 0, tsy = 0, tt, "
         "t00 = clock64();\n  int nsub = 0;\n"
         "  for (int cs = c0; cs < c1; cs += THREADS) {\n    const int c = cs + tid;"),
        ("    const int ncols = min(THREADS, c1 - cs);\n",
         "    const int ncols = min(THREADS, c1 - cs);\n    tt = clock64();\n"),
        ("    float s[R];\n#pragma unroll\n    for (int r = 0; r < R; ++r) s[r] = 0.f;\n"
         "    float vsc = 1.f;",
         "    tl += clock64() - tt; tt = clock64();\n"
         "    float s[R];\n#pragma unroll\n    for (int r = 0; r < R; ++r) s[r] = 0.f;\n"
         "    float vsc = 1.f;"),
        ("    // MULTI: a column is valid for row r below the row's own end",
         "    ts += clock64() - tt; tt = clock64();\n"
         "    // MULTI: a column is valid for row r below the row's own end"),
        ("      if (lane == 0) red_max[r][warp] = mx;\n    }\n    __syncthreads();\n"
         "    float alpha[R];",
         "      if (lane == 0) red_max[r][warp] = mx;\n    }\n"
         "    tm += clock64() - tt; tt = clock64();\n    __syncthreads();\n"
         "    tsy += clock64() - tt; tt = clock64();\n    float alpha[R];"),
        ("      m_run[r] = m_new;\n    }\n    __syncthreads();",
         "      m_run[r] = m_new;\n    }\n    tx += clock64() - tt; tt = clock64();\n"
         "    __syncthreads();\n    tsy += clock64() - tt; tt = clock64();"),
        (_SUB_END,
         _SUB_END.replace("    }\n    __syncthreads();\n  }\n",
                          "    }\n    tp += clock64() - tt; tt = clock64();\n"
                          "    __syncthreads();\n    tsy += clock64() - tt; ++nsub;\n  }\n"
                          "  if (tid == 0 && blockIdx.x == 0 && blockIdx.y == 0 && "
                          "blockIdx.z == 0)\n    printf(\"TIMED sub %d load %lld score %lld "
                          "max %lld softmax %lld pv %lld sync %lld all %lld\\n\", nsub, tl, "
                          "ts, tm, tx, tp, tsy, clock64() - t00);\n")),
    ],
}
# Variants of this tree's header (`--decode base ...`): `new_timed` prints,
# for every block of (KV head 0, slot 0), the globaltimer (ns) at its start
# and its offsets after the prologue, the walk, the counter's atomic and
# the end, and warp 0's cycles waiting on its ring and in its whole walk.
TREE_VARIANTS = {
    "base": [],
    "new_timed": [
        ("#include \"common.cuh\"\n", "#include \"common.cuh\"\n#include <cstdio>\n"),
        ("  if constexpr (EXACT) D = DI;\n  using E = nst::KVElem<T>;",
         "  unsigned long long g0, g1, g2, g3, g4;\n  " + _GT.format("g0")
         + "\n  if constexpr (EXACT) D = DI;\n  using E = nst::KVElem<T>;"),
        ("  // ---- the warp's walk:", "  " + _GT.format("g1")
         + "\n  long long cw = 0, cl = clock64(), ct;\n  // ---- the warp's walk:"),
        ("      cp_wait<STAGES - 2>();\n      __syncwarp();\n",
         "      ct = clock64();\n      cp_wait<STAGES - 2>();\n      __syncwarp();\n"
         "      cw += clock64() - ct;\n"),
        ("  cp_wait<0>();\n", "  cp_wait<0>();\n  cl = clock64() - cl;\n  "
         + _GT.format("g2") + "\n"),
        ("  if (!s_last) return;", "  " + _GT.format("g3") + "\n"
         "  if (hk == 0 && b == 0 && tid == 0 && !s_last)\n"
         "    printf(\"NB split %d last 0 start %llu pro %llu walk %llu atomic %llu "
         "wait %lld loop %lld steps %d\\n\", split, g0, g1 - g0, g2 - g0, g3 - g0, "
         "cw, cl, nsteps);\n  if (!s_last) return;"),
        ("    if (!append) return;",
         "    " + _GT.format("g4") + "\n"
         "    if (hk == 0 && b == 0 && tid == 0)\n"
         "      printf(\"NB split %d last 1 start %llu pro %llu walk %llu atomic %llu "
         "end %llu wait %lld loop %lld steps %d\\n\", split, g0, g1 - g0, g2 - g0, "
         "g3 - g0, g4 - g0, cw, cl, nsteps);\n"
         "    if (!append) return;"),
    ],
}
# (label, K/V, H, Hkv, B, softcap, D): D = 128 but for phase 2's head-dim
# cases at one query head per KV head (80, the masked 72 through the 80
# instance, 96 in bf16, whisper's 20 heads of 64)
DECODE_CASES = [(f"{kv} H=32 Hkv={hkv} B={b}", kv, 32, hkv, b, 0.0, 128)
                for kv in ("int8", "bf16") for hkv in (32, 8) for b in (1, 4)] + [
    (f"grok softcap int8 H=48 Hkv=8 B={b}", "int8", 48, 8, b, 30.0, 128)
    for b in (1, 4)] + [
    (f"{kv} D={d} H={h} Hkv={h} B=4", kv, h, h, 4, 0.0, d)
    for kv, d, h in (("int8", 80, 32), ("int8", 72, 32), ("bf16", 96, 64),
                     ("int8", 64, 20), ("f32", 256, 16))]


def _decode_inputs(gen, kv, h, hkv, b, softcap, d):
    """One DECODE_CASES case: q, the current k / v (int8), the contiguous
    cache (one layer), pos and kv_lens at head dim d, S = 2048."""
    import torch

    import chip_smoke as cs

    s = 2048
    lens = [1976] if b == 1 else cs.DECODE_LENS
    kv_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    pos = kv_lens - 1
    if b > 1:
        pos[-1] = s - 1                     # a spectator parked at S - 1
    cache = cs._gathered(cs._random_pool(gen, 1, b, hkv, s, d, 128, kv), 0)
    q = torch.randn((b, 1, h, d), generator=gen, device="cuda")
    if softcap:
        k = cache[0].float() * (1.0 if cache[2] is None
                                else cache[2].float()[..., None])
        q = q * (0.7 * softcap / k.std().item())
    q = q.to(torch.bfloat16)
    extra = kv == "int8"
    kn, vn = ((torch.randn((b, 1, hkv, d), generator=gen, device="cuda")
               .to(torch.bfloat16)) for _ in range(2)) if extra else (None, None)
    return q, kn, vn, cache, pos, kv_lens, 1 / math.sqrt(d)


def _parent_decode(lib, q, kn, vn, cache, pos, kv_lens, scale, softcap,
                   out_dtype):
    """The parent's `nst_flash_decode` (14 pointers, 14 ints, 2 floats; its
    combine kernel as a second launch), with the fused append."""
    import ctypes

    import torch

    from neural_speed_tpu_torch import _build

    b, _, h, d = q.shape
    k, v, ks, vs = cache
    hkv, s = k.shape[2], k.shape[3]
    chunk = 256
    splits = -(-s // chunk)
    part_m = torch.empty((b, h, splits), dtype=torch.float32, device="cuda")
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, h, splits, d), dtype=torch.float32, device="cuda")
    out = torch.empty((b, 1, h, d), dtype=out_dtype, device="cuda")
    f = lib.nst_flash_decode
    f.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 14
                  + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    ptr = lambda t: 0 if t is None else t.data_ptr()
    extra = kn is not None
    kv_type = 0 if ks is not None else (1 if k.dtype == torch.bfloat16 else 2)
    code = f(q.data_ptr(), ptr(kn), ptr(vn), k.data_ptr(), v.data_ptr(), ptr(ks),
             ptr(vs), 0, pos.data_ptr(), kv_lens.data_ptr(), part_m.data_ptr(),
             part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(), b, h, hkv, s, d,
             0, chunk, int(extra), int(extra), kv_type, 1, 0, 0, 1, scale, softcap,
             _build.stream_handle())
    _build.check(code, "the parent's nst_flash_decode")
    return out


def _kernel_ms(fn) -> dict:
    """Device ms of each kernel one fn() call launches (torch.profiler)."""
    import torch

    import chip_smoke as cs

    for _ in range(6):
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ev = cs._kernel_events(prof)
        if ev:
            out = {}
            for e in ev:
                key = cs._kernel_name(e.name).split("<")[0].split("::")[-1]
                out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
            return out
        time.sleep(1.0)
    return {}


def run_decode(names) -> dict:
    """Each DECODE_VARIANTS variant on every DECODE_CASES case: the output
    against `flash.decode_plain` (the largest error over its 4-ulp row
    tolerance), the kernel's ms (`time_ms`: CUDA events, cold L2, median of
    10), each launched kernel's device ms (torch.profiler), and for
    `timed` the counters' line; the ptxas table of the variant's build."""
    import ctypes

    import torch

    import chip_smoke as cs
    from neural_speed_tpu_torch import _build
    from neural_speed_tpu_torch.ops import flash

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {c[0]: _decode_inputs(gen, *c[1:]) + (c[5],) for c in DECODE_CASES}
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    res = {}
    for name in names:
        tmp = Path(tempfile.mkdtemp())
        parent = name in DECODE_VARIANTS
        reps = DECODE_VARIANTS[name] if parent else TREE_VARIANTS[name]
        csrc = (ROOT / "archive_check" / "parent" if parent else ROOT) / \
            "neural_speed_tpu_torch" / "csrc"
        for f in csrc.iterdir():
            if f.name in ("common.cuh", "flash_decode.cuh") or (
                    f.name.startswith("flash_decode_d") and f.suffix == ".cu"):
                shutil.copy(f, tmp / f.name)
        src = (tmp / "flash_decode.cuh").read_text()
        for old, new in reps:
            if src.count(old) != 1:
                raise ValueError(f"the header has not one copy of {old[:60]!r}")
            src = src.replace(old, new)
        (tmp / "flash_decode.cuh").write_text(src)
        _build.CSRC, _build.BUILD_DIR = tmp, tmp / "build"
        _build.kernels = _build._Library()
        t0 = time.time()
        libs = _build.kernels.build()
        table = ptxas_table(_build.kernels.build_log, "flash_decode")
        for row in table:
            print("  ptxas " + json.dumps(row), flush=True)
        out = {}
        for label, (q, kn, vn, cache, pos, kv_lens, scale, cap) in cases.items():
            if parent and cache[0].dtype == torch.float32:
                continue   # the parent's float32 K/V gave NaN through this call
            fresh = lambda: [None if a is None else a.clone() for a in cache]
            if parent:
                lib = libs[f"flash_decode_d{flash.instance_dim(q.shape[-1])}"]
                run = lambda c: _parent_decode(lib, q, kn, vn,
                                               c, pos, kv_lens, scale, cap,
                                               torch.bfloat16)
            else:
                run = lambda c: flash.decode_cuda(
                    q, kn, vn, *c, 0, pos, kv_lens, scale, kn is not None,
                    torch.bfloat16, softcap=cap)
            want = flash.decode_plain(q, kn, vn, *fresh(), 0, pos, kv_lens, scale,
                                      kn is not None, torch.bfloat16, softcap=cap)
            work = fresh()
            got = run(work)
            torch.cuda.synchronize()
            worst = cs.compare(got, want, 4, per_row=True)["worst"]
            ms = cs.time_ms(lambda: run(work))
            per_kernel = _kernel_ms(lambda: run(work))
            b, hkv = q.shape[0], cache[0].shape[2]
            out[label] = dict(ms=ms, worst=worst, kernels=per_kernel)
            print(f"  {name} {label}: {ms:.4f} ms, worst {worst:.3f}, kernels "
                  + json.dumps({k: round(v, 4) for k, v in per_kernel.items()})
                  + (f"; parent grid {8 * hkv * b} blocks on {n_sm} SMs"
                     if parent else ""), flush=True)
        torch.cuda.synchronize()
        res[name] = dict(times=out, ptxas=table, build_s=time.time() - t0,
                         source_s=dict(_build.kernels.source_seconds))
        print(f"{name}: built in {time.time() - t0:.1f} s", flush=True)
        shutil.rmtree(tmp, ignore_errors=True)
    return res


def run_decode_cases(tree: Path, out: Path) -> int:
    """One run of a pair run of kernels B and 10 (`--decode-cases TREE
    JSON`): from the tree given (the parent's or this one, holding this
    chip_smoke.py), the `flash_decode*.cu` sources built alone into
    `<tree>/build_pair` (that build reloaded when it is there: the parent's
    second run), then every B / 10 case of chip_smoke.py's phase 2 in one
    order on one generator (`check_flash_decode`, `_paged`, the decode
    cases of VARIANT / DIM / SOFTCAP / SCALE_F32 / QK / QK_MULTI /
    NONCAUSAL / WHISPER_SELF, `b1`, `decode_repeat`; not the prefill cases,
    nor `decode_launches`, which fails on the parent by design).  Failures
    are reported, not raised; the records go to `out` as chip_smoke.json's
    `kernels`, for `chip_smoke.py --compare-runs`."""
    import ctypes
    import traceback

    os.chdir(tree)
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from neural_speed_tpu_torch import _build

    src = tree / "build_pair" / "src"
    src.mkdir(parents=True, exist_ok=True)
    for f in (tree / "neural_speed_tpu_torch" / "csrc").iterdir():
        if f.suffix == ".cuh" or (f.name.startswith("flash_decode")
                                  and f.suffix == ".cu"):
            shutil.copy(f, src / f.name)
    _build.CSRC, _build.BUILD_DIR = src, tree / "build_pair" / "build"
    _build.kernels = _build._Library()
    stems = sorted(p.stem for p in src.glob("*.cu"))
    sos = [_build.BUILD_DIR / f"lib{s}.so" for s in stems]
    t0 = time.time()
    if all(p.exists() for p in sos):
        _build.kernels._libs = {s: ctypes.CDLL(str(p))
                                for s, p in zip(stems, sos)}
        print("reused the build", flush=True)
    else:
        _build.kernels.build()
        print(f"built in {time.time() - t0:.1f} s " + json.dumps(
            {k: round(v, 1) for k, v in _build.kernels.source_seconds.items()}),
            flush=True)
    chk = cs.Checks(torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(0)
    fails = []

    def run(label, fn):
        try:
            fn()
        except Exception:  # noqa: BLE001 - reported, and the run goes on
            fails.append(label)
            print(f"FAIL {label}\n{traceback.format_exc()[-3000:]}",
                  flush=True)

    t1 = time.time()
    run("check_flash_decode", lambda: cs.check_flash_decode(chk, gen))
    run("check_flash_decode_paged",
        lambda: cs.check_flash_decode_paged(chk, gen))
    for case in (cs.VARIANT_CASES + cs.DIM_CASES + cs.SOFTCAP_CASES
                 + cs.SCALE_F32_CASES):
        if case[0] == "decode":
            run(str(case), lambda: cs._variant_case(chk, gen, *case))
    for case in cs.QK_CASES:
        run("qk " + str(case),
            lambda: cs._variant_case(chk, gen, *case, qk=True))
    for case in cs.QK_MULTI_CASES:
        run("multi " + str(case), lambda: cs._qk_multi_case(chk, gen, *case))
    for case in cs.NONCAUSAL_CASES:
        if case[0] == "decode":
            run("noncausal " + str(case),
                lambda: cs._whisper_case(chk, gen, *case))
    for case in cs.WHISPER_SELF_CASES:
        if case[0] == "decode":
            run("self " + str(case), lambda: cs._whisper_case(
                chk, gen, *case, causal=True, s=cs.WHISPER_TGT))
    run("b1", lambda: cs.check_flash_decode_b1(chk, gen))
    run("repeat", lambda: cs.check_flash_decode_repeat(chk, gen))
    print(f"checks in {time.time() - t1:.1f} s; FAILED {len(fails)}: {fails}",
          flush=True)
    with open(out, "w") as f:
        json.dump(dict(kernels=[dict(name=r["name"], cases=r["cases"])
                                for r in chk.records.values()],
                       checks=chk.notes, fails=fails), f, indent=1)
    return 1 if fails else 0


def _sources(tmp: Path, dims, reps) -> None:
    csrc = ROOT / "neural_speed_tpu_torch" / "csrc"
    for f in csrc.iterdir():
        keep = f.name in ("common.cuh", "qmm_fp.cuh", "flash_prefill.cuh") or (
            f.name.startswith(("flash_prefill_d", "flash_prefill_paged_d"))
            and int(f.stem.rsplit("_d", 1)[1]) in dims)
        if keep:
            shutil.copy(f, tmp / f.name)
    src = (tmp / "flash_prefill.cuh").read_text()
    for old, new in reps:
        if src.count(old) != 1:
            raise ValueError(f"the header has not one copy of {old[:60]!r}")
        src = src.replace(old, new)
    (tmp / "flash_prefill.cuh").write_text(src)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("variants", nargs="*",
                    choices=sorted(set(VARIANTS) | set(GEMV_VARIANTS)
                                   | set(F32_VARIANTS) | set(DECODE_VARIANTS)
                                   | set(TREE_VARIANTS)))
    ap.add_argument("--dims", default="128")
    ap.add_argument("--gemv", action="store_true",
                    help="the variants are GEMV_VARIANTS of qmm_fp.cuh")
    ap.add_argument("--acc", action="store_true",
                    help="the float32 GEMM's accumulation lever (ACC_MODES) "
                         "and the ptxas table of the F / P GEMMs; no "
                         "variants are named")
    ap.add_argument("--rate", action="store_true",
                    help="the tensor cores' issue rate (RATE_MODES)")
    ap.add_argument("--f32", action="store_true",
                    help="the variants are F32_VARIANTS of the float32 GEMM")
    ap.add_argument("--decode", action="store_true",
                    help="the variants are DECODE_VARIANTS of kernel B")
    ap.add_argument("--decode-cases", nargs=2, metavar=("TREE", "JSON"),
                    help="kernels B and 10's phase-2 cases from TREE, "
                         "their sources built alone, records to JSON "
                         "(one run of a pair run; run_decode_cases)")
    ap.add_argument("--check", action="store_true",
                    help="with --gemv: hold every format and row count "
                         "against the plain version first (GEMV_CHECKS)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_levers: no CUDA device", file=sys.stderr)
        return 2
    if args.decode_cases:
        return run_decode_cases(Path(args.decode_cases[0]).resolve(),
                                Path(args.decode_cases[1]).resolve())
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from neural_speed_tpu_torch import _build
    from neural_speed_tpu_torch.ops import flash

    os.makedirs(cs.OUT_DIR, exist_ok=True)
    import subprocess

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    if args.acc:
        res = run_acc()
        with open(os.path.join(cs.OUT_DIR, "levers_acc.json"), "w") as f:
            json.dump(res, f, indent=1)
        return 0
    if args.rate:
        res = run_rate()
        with open(os.path.join(cs.OUT_DIR, "levers_rate.json"), "w") as f:
            json.dump(res, f, indent=1)
        if not args.f32:
            return 0
    if args.f32:
        res = run_f32(args.variants)
        with open(os.path.join(cs.OUT_DIR, "levers_f32.json"), "w") as f:
            json.dump(res, f, indent=1)
        return 0
    if args.decode:
        res = run_decode(args.variants)
        with open(os.path.join(cs.OUT_DIR, "levers_decode.json"), "w") as f:
            json.dump(res, f, indent=1)
        return 0
    if args.gemv:
        res = run_gemv(args.variants, args.check)
        with open(os.path.join(cs.OUT_DIR, "levers_gemv.json"), "w") as f:
            json.dump(res, f, indent=1)
        return 0
    dims = [int(x) for x in args.dims.split(",")]
    gen = torch.Generator(device="cuda").manual_seed(0)
    t, h, s, lens = 2048, 32, 2048, [1975]
    kv_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    ar = torch.arange(t, device="cuda", dtype=torch.int32)[None]
    pos = torch.where(ar < kv_lens[:, None], ar, torch.full_like(ar, s - 1))
    cases = {}
    for d in dims:
        for kv in ("int8", "bf16", "f32"):
            q = torch.randn((1, t, h, d), generator=gen, device="cuda").to(
                torch.bfloat16)
            cache = cs._gathered(cs._random_pool(gen, 1, 1, h, s, d, 128, kv),
                                 0)
            cases[f"d{d} {kv}"] = (q, *cache, 0, pos, kv_lens,
                                   1 / math.sqrt(d), torch.bfloat16)
    res = {}
    for name in args.variants:
        tmp = Path(tempfile.mkdtemp())
        _sources(tmp, dims, VARIANTS[name])
        _build.CSRC, _build.BUILD_DIR = tmp, tmp / "build"
        _build.kernels = _build._Library()
        t0 = time.time()
        _build.kernels.build()
        regs = sorted({ln.strip() for ln in _build.kernels.build_log.splitlines()
                       if "registers" in ln or "stack frame" in ln})
        out = {}
        for key, a in cases.items():
            ms = cs.time_ms(lambda: flash.prefill_cuda(*a))
            err = cs.compare(flash.prefill_cuda(*a), flash.prefill_plain(*a),
                             4, per_row=True)["worst"]
            out[key] = (ms, err)
        torch.cuda.synchronize()
        res[name] = dict(times=out, ptxas=regs)
        print(f"{name} (built in {time.time() - t0:.1f} s): "
              + json.dumps({k: [round(v[0], 4), round(v[1], 3)]
                            for k, v in out.items()}), flush=True)
        for ln in regs:
            print("  " + ln, flush=True)
        shutil.rmtree(tmp, ignore_errors=True)
    with open(os.path.join(cs.OUT_DIR, "levers.json"), "w") as f:
        json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
