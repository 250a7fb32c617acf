#!/usr/bin/env python3
"""Time kernels C and 9 (`csrc/flash_prefill.cuh`) in variants of their
header, on one NVIDIA GPU.

    python3 chip_levers.py base no_convert timed    # the variants named
    python3 chip_levers.py --dims 128,256 base      # at these head dims

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
and converting.  Results go to levers.json in `chip_smoke.OUT_DIR`.
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
    ap.add_argument("variants", nargs="+", choices=sorted(VARIANTS))
    ap.add_argument("--dims", default="128")
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
