#!/usr/bin/env python3
"""Time kernels C and 9 (`csrc/flash_prefill.cuh`), or the GEMV of kernels F
and P (`csrc/qmm_fp.cuh`), in variants of their header, on one NVIDIA GPU.

    python3 chip_levers.py base no_convert timed    # the variants named
    python3 chip_levers.py --dims 128,256 base      # at these head dims
    python3 chip_levers.py --gemv --check base splits_ceil   # F / P GEMV

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
and row count of GEMV_CHECK_FORMATS against the plain version.  Results go
to levers.json (levers_gemv.json with `--gemv`) in `chip_smoke.OUT_DIR`.
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
    ap.add_argument("variants", nargs="+",
                    choices=sorted(set(VARIANTS) | set(GEMV_VARIANTS)))
    ap.add_argument("--dims", default="128")
    ap.add_argument("--gemv", action="store_true",
                    help="the variants are GEMV_VARIANTS of qmm_fp.cuh")
    ap.add_argument("--check", action="store_true",
                    help="with --gemv: hold every format and row count "
                         "against the plain version first (GEMV_CHECKS)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_levers: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from neural_speed_tpu_torch import _build
    from neural_speed_tpu_torch.ops import flash

    os.makedirs(cs.OUT_DIR, exist_ok=True)
    import subprocess

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
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
