#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`neural_speed_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                 # all phases (needs one card)
    python3 chip_smoke.py --kernels-only  # build + kernel checks only
    python3 chip_smoke.py --profile       # all phases + a torch.profiler
                                          # trace of the main path

Phases, each raising on failure so the run exits non-zero:

1. print the card (`nvidia-smi` name and power limit) and build the kernels
   from `neural_speed_tpu_torch/csrc/*.cu` with `nvcc` (sm_90a);
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, with the stated tolerance, and time kernel, plain
   version and a library yardstick (CUDA events around each call, cold L2,
   host time excluded: see `time_ms`);
3. a tiny model through `Engine` on the card against the same model on the
   CPU (plain versions): logits within tolerance, identical greedy ids at
   every step;
4. the main path: a Llama-2-7B-shaped int4 model (full width and depth,
   random weights from a seed, drawn on the card) serves 4 ragged requests,
   then the bench shape (B = 1, a 1975-token prefill, 64 greedy steps); every
   kernel's launch counter must be > 0 and no plain version may run.  With
   `--profile`, torch.profiler then traces one prefill and 8 decode steps
   (device time by kernel group, idle share).

It prints a `kernels` JSON line, then as its last line
`{"ok": true, "device": {...}}`.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# Published peaks (NVIDIA data sheets): device-memory bytes/s and dense
# bf16 tensor FLOP/s; the bound of a call is the larger of bytes / rate and
# operations / peak.
PEAKS = {"H100 SXM": (3.35e12, 989e12), "H100 PCIe": (2.0e12, 756e12),
         "H100 NVL": (3.9e12, 835e12), "H200": (4.8e12, 989e12)}


def peaks_for(name: str):
    if "H200" in name:
        return PEAKS["H200"]
    if "NVL" in name:
        return PEAKS["H100 NVL"]
    if "PCIe" in name:
        return PEAKS["H100 PCIe"]
    return PEAKS["H100 SXM"]


def bound(nbytes: float, flops: float, name: str):
    bw, fl = peaks_for(name)
    tb, tf = nbytes / bw * 1e3, flops / fl * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def log(msg: str) -> None:
    print(msg, flush=True)


def _kernel_events(prof):
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


_TIMING = {}


def _flush_l2() -> None:
    """Read a 256 MB buffer, which evicts the card's 50 MB L2 with clean
    lines: the next call finds its inputs in device memory, as the main
    path finds each layer's weights and cache."""
    if "buf" not in _TIMING:
        _TIMING["buf"] = torch.ones(64 << 20, device="cuda")
    _TIMING["buf"].amax()


def _sleep_cycles_per_ms() -> float:
    if "cycles" not in _TIMING:
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(1000)
        a.record()
        torch.cuda._sleep(50_000_000)
        b.record()
        b.synchronize()
        _TIMING["cycles"] = 50_000_000 / a.elapsed_time(b)
    return _TIMING["cycles"]


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Device time of one fn() call: the median over `reps` calls of CUDA
    events recorded just before and just after the call, each call after an
    L2 flush.  A sleep kernel holds the stream while the host enqueues every
    call, so the host's time between launches is not counted.  If the sleep
    ends before the host is done, it is doubled and the calls are timed
    again; after four tries this raises."""
    event = lambda: torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    for _ in range(warmup):
        _flush_l2()
        event().record()
        fn()
        event().record()
    host_ms = (time.perf_counter() - t0) * 1e3 / warmup
    torch.cuda.synchronize()
    sleep_ms = 2 * reps * host_ms + 1.0
    for _ in range(4):
        gate = event()
        spans = [(event(), event()) for _ in range(reps)]
        torch.cuda._sleep(int(sleep_ms * _sleep_cycles_per_ms()))
        gate.record()
        for start, end in spans:
            _flush_l2()
            start.record()
            fn()
            end.record()
        ahead = not gate.query()
        torch.cuda.synchronize()
        if ahead:
            return statistics.median(s.elapsed_time(e) for s, e in spans)
        sleep_ms *= 2
    raise RuntimeError(f"time_ms: the host did not get ahead of the device "
                       f"within a {sleep_ms / 2:.1f} ms sleep")


def _category(kernel_name: str) -> str:
    for key, cat in (("int4", "qmatmul"), ("splitk", "qmatmul"),
                     ("flash_decode", "flash_decode"),
                     ("flash_prefill", "flash_prefill")):
        if key in kernel_name:
            return cat
    return "other"


def profile_window(fn, label: str, steps: int) -> dict:
    """Trace fn() with torch.profiler: device time per step by kernel group
    and the device's idle share between the first kernel's start and the
    last kernel's end (host gaps between launches count as idle).  The
    per-kernel table goes to chiprun_out/profile_<label>.txt."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = _kernel_events(prof)
    if not ev:
        raise RuntimeError(f"profile {label}: torch.profiler recorded no "
                           "CUDA kernel")
    spans = sorted((e.time_range.start, e.time_range.end) for e in ev)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    by_cat, by_name = {}, {}
    for e in ev:
        us = e.time_range.elapsed_us()
        cat = _category(e.name)
        by_cat[cat] = by_cat.get(cat, 0.0) + us
        n = by_name.setdefault(e.name, [0, 0.0])
        n[0] += 1
        n[1] += us
    with open(os.path.join(OUT_DIR, f"profile_{label}.txt"), "w") as f:
        for name, (cnt, us) in sorted(by_name.items(), key=lambda x: -x[1][1]):
            f.write(f"{us / steps / 1e3:10.4f} ms/step {cnt:8d} calls  "
                    f"{name[:150]}\n")
    res = dict(window_ms=window / steps / 1e3, busy_ms=busy / steps / 1e3,
               idle_share=1 - busy / window,
               device_ms={k: v / steps / 1e3 for k, v in by_cat.items()})
    log(f"  profile {label} (per step, under the profiler): window "
        f"{res['window_ms']:.3f} ms, device busy {res['busy_ms']:.3f} ms, "
        f"idle share {res['idle_share']:.3f}; device ms by group "
        + json.dumps({k: round(v, 4) for k, v in res["device_ms"].items()}))
    return res


ATOL = 1e-6   # for rows whose outputs are all 0 (no valid column)


def compare(got: torch.Tensor, want: torch.Tensor, ulps: int,
            per_row: bool) -> dict:
    """|got - want| against `ulps` bf16 ulps (2**-8 relative) of a scale:
    the largest |want| of the element's row (the last axis) with `per_row`,
    else of the whole tensor.  Returns the largest absolute error, the
    largest error over its scale, and the largest error over its
    tolerance (the check passes when that is <= 1)."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs()
    scale = mag.amax(-1, keepdim=True) if per_row else mag.amax()
    tol = ulps * 2.0 ** -8 * scale + ATOL
    return dict(err=diff.max().item(),
                rel=(diff / scale.clamp_min(ATOL)).max().item(),
                worst=(diff / tol).max().item(),
                tol=f"{ulps} bf16 ulps of the largest |output| of its "
                    f"{'row' if per_row else 'tensor'}")


class Checks:
    def __init__(self, card: str):
        self.card = card
        self.records = {}

    def add(self, name, route, source, replaces, shape, cmp, ms, plain_ms,
            lib_ms, nbytes, flops, main=False):
        """One case of a kernel's check; the `main` case gives the kernel's
        times in the kernels line."""
        b_ms, b_by = bound(nbytes, flops, self.card)
        log(f"  {name} {shape}: max_abs_err={cmp['err']:.3e}, largest "
            f"error / scale {cmp['rel']:.3e}, largest error / tolerance "
            f"{cmp['worst']:.3f} (tolerance {cmp['tol']}) "
            f"kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
            f"library={'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} "
            f"bound={b_ms:.4f} ms ({b_by})")
        if not cmp["worst"] <= 1.0:
            raise AssertionError(f"{name} {shape}: error beyond the "
                                 f"tolerance ({cmp})")
        rec = self.records.setdefault(name, {
            "name": name, "route": route, "source": source,
            "replaces": replaces, "cases": []})
        rec["cases"].append(dict(shape=shape, max_abs_err=cmp["err"],
                                 err_over_scale=cmp["rel"],
                                 err_over_tol=cmp["worst"], ms=ms,
                                 plain_ms=plain_ms, library_ms=lib_ms,
                                 bound_ms=b_ms, bound_by=b_by, main=main))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def check_qmatmul(chk: Checks, gen: torch.Generator) -> None:
    from neural_speed_tpu_torch.ops import matmul
    from neural_speed_tpu_torch.ops.qtypes import QSpec, QType
    from neural_speed_tpu_torch.ops.quantize import dequantize
    from neural_speed_tpu_torch.utils.synthetic import synth_qtensor

    spec = QSpec(QType.INT, 4, 128, True, scale_dtype="bfloat16")
    shapes = [(4096, 12288), (4096, 4096), (4096, 22016), (11264, 4096),
              (4096, 32000)]
    for k, n in shapes:
        qt = synth_qtensor(gen, k, n, spec)
        w_bf16 = dequantize(qt, torch.bfloat16)
        # M = 8192: the ragged prefill (B = 4 at the 2048 bucket)
        for m in (1, 4, 2048) + ((8192,) if (k, n) == (4096, 4096) else ()):
            x = (torch.randn((m, k), generator=gen, device="cuda")
                 ).to(torch.bfloat16)
            got = matmul.qmatmul_cuda(x, qt)
            want = matmul.qmatmul_plain(x, qt)
            torch.cuda.synchronize()
            # bf16 output: one rounding in each version plus f32 sums taken
            # in another order -> two bf16 ulps of the largest output
            cmp = compare(got, want, 2, per_row=False)
            del got, want
            ms = time_ms(lambda: matmul.qmatmul_cuda(x, qt))
            plain_ms = time_ms(lambda: matmul.qmatmul_plain(x, qt), reps=3)
            lib_ms = time_ms(lambda: torch.matmul(x, w_bf16))
            nbytes = m * k * 2 + k * n // 2 + (k // 128) * n * 2 + m * n * 2
            chk.add("qmatmul_int4", "cuda", "neural_speed_tpu_torch/csrc/qmatmul.cu",
                    "neural_speed_tpu/ops/matmul.py:127", f"M={m} K={k} N={n}",
                    cmp, ms, plain_ms, lib_ms, nbytes, 2.0 * m * n * k,
                    main=(m, k, n) == (1, 4096, 22016))


def _random_cache(gen, layers, b, hkv, s, d):
    from neural_speed_tpu_torch.ops.kv_cache import KVCache

    codes = lambda: torch.randint(-127, 128, (layers, b, hkv, s, d),
                                  generator=gen, device="cuda",
                                  dtype=torch.int8)
    scales = lambda: ((torch.rand((layers, b, hkv, s), generator=gen,
                                  device="cuda") + 0.5) * 0.02
                      ).to(torch.bfloat16)
    return KVCache(codes(), codes(), scales(), scales(),
                   torch.zeros((b,), dtype=torch.int32, device="cuda"))


def _clone(c):
    from neural_speed_tpu_torch.ops.kv_cache import KVCache

    return KVCache(c.k.clone(), c.v.clone(), c.k_scale.clone(),
                   c.v_scale.clone(), c.lengths.clone())


def _dequant_layer(c, layer):
    k = (c.k[layer].float() * c.k_scale[layer].float()[..., None])
    v = (c.v[layer].float() * c.v_scale[layer].float()[..., None])
    return k.to(torch.bfloat16), v.to(torch.bfloat16)


def check_flash_decode(chk: Checks, gen: torch.Generator) -> None:
    from neural_speed_tpu_torch.ops import flash

    b, h, hkv, d, s, layer = 4, 32, 32, 128, 2048, 1
    cache = _random_cache(gen, 2, b, hkv, s, d)
    # slots 0-2 live (new token at kv_len - 1), slot 3 a spectator parked
    # at max_len - 1 over its 900 stored rows
    kv_lens = torch.tensor([1976, 1500, 37, 900], dtype=torch.int32,
                           device="cuda")
    pos = torch.tensor([1975, 1499, 36, s - 1], dtype=torch.int32,
                       device="cuda")
    q = (torch.randn((b, 1, h, d), generator=gen, device="cuda")
         ).to(torch.bfloat16)
    kn = torch.randn((b, 1, hkv, d), generator=gen, device="cuda"
                     ).to(torch.bfloat16)
    vn = torch.randn((b, 1, hkv, d), generator=gen, device="cuda"
                     ).to(torch.bfloat16)
    scale = 1.0 / math.sqrt(d)
    ck, cp = _clone(cache), _clone(cache)
    args = lambda c: (q, kn, vn, c.k, c.v, c.k_scale, c.v_scale, layer, pos,
                      kv_lens, scale, True, torch.bfloat16)
    got = flash.decode_cuda(*args(ck))
    want = flash.decode_plain(*args(cp))
    torch.cuda.synchronize()
    for name in ("k", "v", "k_scale", "v_scale"):
        a, c = getattr(ck, name), getattr(cp, name)
        if not torch.equal(a, c):
            bad = (a != c).nonzero()
            raise AssertionError(
                f"flash_decode: cache {name} differs from the plain version "
                f"at {bad.shape[0]} places, first {bad[:4].tolist()}: "
                f"{a[tuple(bad[0])].item()} vs {c[tuple(bad[0])].item()}")
    if not torch.equal(ck.k[0], cache.k[0]) or not torch.equal(
            ck.k[layer, 3], cache.k[layer, 3]):
        raise AssertionError("flash_decode wrote outside its row")
    # bf16(P * v_scale) is rounded against each split's running max in the
    # kernel and against the global max in the plain version (half an ulp
    # per term, summed with random signs), plus the bf16 output rounding:
    # within 4 bf16 ulps of the largest output of the (slot, head) row
    cmp = compare(got, want, 4, per_row=True)
    ms = time_ms(lambda: flash.decode_cuda(*args(ck)))
    plain_ms = time_ms(lambda: flash.decode_plain(*args(cp)), reps=3)
    kd, vd = _dequant_layer(cache, layer)
    live = torch.arange(s, device="cuda")[None] < torch.where(
        pos == kv_lens - 1, kv_lens - 1, kv_lens)[:, None]
    mask = live[:, None, None, :]
    qs = q.transpose(1, 2)
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, kd, vd, attn_mask=mask))
    cols = live.sum().item()
    nbytes = (cols * hkv * (2 * d + 4) + 2 * b * h * d * 2
              + 2 * b * hkv * d * 2 + 3 * hkv * (2 * d + 4))
    chk.add("flash_decode", "cuda", "neural_speed_tpu_torch/csrc/flash_decode.cu",
            "neural_speed_tpu/ops/flash.py:267",
            f"B={b} H={h} S={s} kv_len=1976/1500/37/900(spectator)",
            cmp, ms, plain_ms, lib_ms, nbytes, 4.0 * cols * h * d, main=True)


def check_flash_prefill(chk: Checks, gen: torch.Generator) -> None:
    from neural_speed_tpu_torch.ops import flash

    t, h, hkv, d, s, layer = 2048, 32, 32, 128, 2048, 0
    scale = 1.0 / math.sqrt(d)
    # the main path's two prefills at the 2048 bucket: the ragged batch of
    # four, and the bench shape (its headline case); padding rows sit on
    # the trash position s - 1
    for lens in ([1975, 900, 300, 37], [1975]):
        b = len(lens)
        cache = _random_cache(gen, 1, b, hkv, s, d)
        kv_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
        ar = torch.arange(t, device="cuda", dtype=torch.int32)[None]
        pos = torch.where(ar < kv_lens[:, None], ar,
                          torch.full_like(ar, s - 1))
        q = (torch.randn((b, t, h, d), generator=gen, device="cuda")
             ).to(torch.bfloat16)
        args = (q, cache.k, cache.v, cache.k_scale, cache.v_scale, layer,
                pos, kv_lens, scale, torch.bfloat16)
        got = flash.prefill_cuda(*args)
        want = flash.prefill_plain(*args)
        torch.cuda.synchronize()
        # as kernel B: bf16(P * v_scale) rounded against the running max of
        # a 64-column tile in the kernel and the row's max in the plain
        # version, and the bf16 output rounding
        cmp = compare(got, want, 4, per_row=True)
        del got, want
        torch.cuda.empty_cache()
        ms = time_ms(lambda: flash.prefill_cuda(*args))
        plain_ms = time_ms(lambda: flash.prefill_plain(*args), reps=3)
        kd, vd = _dequant_layer(cache, layer)
        col = torch.arange(s, device="cuda")
        mask = ((col[None, None] < kv_lens[:, None, None])
                & (col[None, None] <= pos[:, :, None]))          # [B, T, S]
        qs = q.transpose(1, 2)
        lib_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qs, kd, vd, attn_mask=mask[:, None]))
        pairs = mask.sum().item()
        nbytes = 2 * b * t * h * d * 2 + sum(lens) * hkv * (2 * d + 4)
        chk.add("flash_prefill", "cuda",
                "neural_speed_tpu_torch/csrc/flash_prefill.cu",
                "neural_speed_tpu/ops/flash.py:142",
                f"B={b} T={t} (real rows {'/'.join(map(str, lens))}) H={h} "
                f"S={s}", cmp, ms, plain_ms, lib_ms, nbytes,
                4.0 * pairs * h * d, main=b == 1)
        del cache, q, kd, vd, mask
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 3: a tiny model on the card against the CPU
# ---------------------------------------------------------------------------


def check_tiny_model() -> None:
    from neural_speed_tpu_torch.models.arch import ArchConfig
    from neural_speed_tpu_torch.ops.qtypes import QSpec, QType
    from neural_speed_tpu_torch.runtime.engine import Engine
    from neural_speed_tpu_torch.utils.synthetic import synth_params

    cfg = ArchConfig(name="llama", vocab_size=512, hidden_size=512,
                     n_layers=2, n_heads=8, n_kv_heads=4,
                     intermediate_size=1408, max_position_embeddings=256)
    spec = QSpec(QType.INT, 4, 64, True, scale_dtype="bfloat16")
    # seed 15: every greedy step's top-2 margin on the CPU is more than
    # twice the logit tolerance, so equal ids at every step is a real check
    params = synth_params(cfg, spec, seed=15, device="cpu")
    eng = {dev: Engine(params, cfg, max_batch=3, max_len=256, device=dev)
           for dev in ("cuda", "cpu")}
    prompts = [list(range(3, 40)), [7, 8, 9], list(range(100, 190))]
    logits = {dev: e.prefill(prompts).float().cpu() for dev, e in eng.items()}
    active = torch.tensor([True, False, True])
    for step in range(9):
        # bf16 logits: a few bf16 ulps (2**-8 relative) of the largest logit
        tol = 0.02 * logits["cpu"][active].abs().max().item()
        diff = (logits["cuda"] - logits["cpu"])[active].abs().max().item()
        if diff > tol:
            raise AssertionError(f"tiny model step {step}: logits differ by "
                                 f"{diff} > {tol}")
        top2 = logits["cpu"][active].topk(2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).min().item()
        if margin <= 2 * tol:
            raise AssertionError(f"tiny model step {step}: top-2 margin "
                                 f"{margin} within twice the tolerance {tol}")
        ids = {dev: lg.argmax(-1) for dev, lg in logits.items()}
        if not torch.equal(ids["cuda"][active], ids["cpu"][active]):
            raise AssertionError(f"tiny model step {step}: greedy ids differ")
        if step < 8:
            toks = ids["cpu"].to(torch.int32)
            logits = {dev: e.decode(toks, active).float().cpu()
                      for dev, e in eng.items()}
    log("  tiny model: logits within 2% of the largest logit of the CPU "
        "plain path and greedy ids equal at all 9 steps (top-2 margin above "
        "twice that at each)")


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def serve_7b(profile: bool) -> dict:
    from neural_speed_tpu_torch import _build
    from neural_speed_tpu_torch.models.transformer import fuse_params
    from neural_speed_tpu_torch.ops import kv_cache as kvc
    from neural_speed_tpu_torch.ops.qtypes import QSpec, QType
    from neural_speed_tpu_torch.runtime.engine import (Engine, decode_n_steps,
                                                       prefill_step)
    from neural_speed_tpu_torch.utils.synthetic import (llama2_7b_arch,
                                                        synth_params)

    cfg = llama2_7b_arch()
    spec = QSpec(QType.INT, 4, 128, True, scale_dtype="bfloat16")
    t0 = time.time()
    params = fuse_params(synth_params(cfg, spec, seed=0), cfg)
    torch.cuda.synchronize()
    log(f"  7B-shaped params ({cfg.n_layers} layers) on the card in "
        f"{time.time() - t0:.1f} s")
    eng = Engine(params, cfg, max_batch=4, max_len=2048, fuse=False)

    # four ragged requests; slots go idle at different steps
    _build.reset_counts()
    lens = [1975, 900, 300, 37]
    budgets = [24, 8, 16, 4]
    gen = torch.Generator().manual_seed(0)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in lens]
    torch.cuda.synchronize()
    t0 = time.time()
    logits = eng.prefill(prompts)
    torch.cuda.synchronize()
    ttft4 = time.time() - t0
    if logits.shape != (4, cfg.vocab_size) or not torch.isfinite(logits).all():
        raise AssertionError("ragged prefill: bad logits")
    tok = logits.argmax(-1).to(torch.int32)
    out = [[int(x)] for x in tok]
    steps = 0
    t0 = time.time()
    while True:
        active = torch.tensor([len(o) < n for o, n in zip(out, budgets)])
        if not active.any():
            break
        logits = eng.decode(tok, active)
        if not torch.isfinite(logits[active.cuda()]).all():
            raise AssertionError("ragged decode: non-finite logits")
        tok = logits.argmax(-1).to(torch.int32)
        for i in range(4):
            if active[i]:
                out[i].append(int(tok[i]))
        steps += 1
    torch.cuda.synchronize()
    ragged_decode_s = time.time() - t0
    lengths = eng.cache.lengths.tolist()
    want = [n + b - 1 for n, b in zip(lens, budgets)]
    if lengths != want:
        raise AssertionError(f"ragged: cache lengths {lengths} != {want}")
    ragged_counts = dict(_build.launches)
    log(f"  ragged: 4 requests (prompts {lens}, budgets {budgets}) prefill "
        f"{ttft4 * 1e3:.1f} ms, {steps} decode steps in "
        f"{ragged_decode_s * 1e3:.1f} ms; launches {ragged_counts}")

    # the bench shape: B = 1, a 1975-token prefill, 64 greedy steps
    cache = kvc.init_cache(cfg.n_layers, 1, 2048, cfg.n_kv_heads,
                           cfg.head_dim)
    t = 2048
    ids = torch.randint(0, cfg.vocab_size, (1, t), generator=gen).to(
        torch.int32).cuda()
    lens1 = torch.tensor([1975], dtype=torch.int32, device="cuda")
    start = torch.zeros((1,), dtype=torch.int32, device="cuda")
    before = dict(_build.launches)
    prefill_step(eng.params, eng.cfg, cache, ids, lens1, start)  # warm
    kvc.set_lengths(cache, start)
    torch.cuda.synchronize()
    t0 = time.time()
    logits, cache = prefill_step(eng.params, eng.cfg, cache, ids, lens1,
                                 start)
    torch.cuda.synchronize()
    ttft = time.time() - t0
    tok = logits.argmax(-1).to(torch.int32)
    active = torch.ones((1,), dtype=torch.bool, device="cuda")
    decode_n_steps(eng.params, eng.cfg, cache, tok, active, 4)  # warm
    kvc.set_lengths(cache, lens1)
    n_steps = 64
    torch.cuda.synchronize()
    t0 = time.time()
    toks, cache = decode_n_steps(eng.params, eng.cfg, cache, tok, active,
                                 n_steps)
    torch.cuda.synchronize()
    dt = time.time() - t0
    if toks.shape != (1, n_steps) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError("bench decode: bad token ids")
    if cache.lengths.tolist() != [1975 + n_steps]:
        raise AssertionError(f"bench: cache length {cache.lengths.tolist()}")
    bench_counts = {k: v - before.get(k, 0)
                    for k, v in _build.launches.items()}
    log(f"  bench shape: TTFT {ttft * 1e3:.2f} ms (1975 tokens, B=1); "
        f"decode {dt / n_steps * 1e3:.3f} ms/token = "
        f"{n_steps / dt:.2f} tok/s over {n_steps} steps; launches "
        f"{bench_counts}")

    res = dict(ttft_ms=ttft * 1e3, decode_ms_per_token=dt / n_steps * 1e3,
               tok_s=n_steps / dt, ragged_prefill_ms=ttft4 * 1e3,
               ragged_decode_ms=ragged_decode_s * 1e3, ragged_steps=steps,
               ragged_counts=ragged_counts, bench_counts=bench_counts)
    if profile:
        # where the time goes: one traced prefill and 8 traced decode steps
        kvc.set_lengths(cache, start)
        res["profile_prefill"] = profile_window(
            lambda: prefill_step(eng.params, eng.cfg, cache, ids, lens1,
                                 start), "prefill", 1)
        res["profile_decode"] = profile_window(
            lambda: decode_n_steps(eng.params, eng.cfg, cache, tok, active,
                                   8), "decode", 8)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one prefill and 8 decode steps of the "
                         "main path with torch.profiler")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from neural_speed_tpu_torch import _build

    os.makedirs(OUT_DIR, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card_line = smi.stdout.strip().splitlines()[0]
    log(card_line)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")

    log("phase 1: build")
    _build.kernels.build()
    log(f"  built {sorted(_build.kernels.build())} in "
        f"{_build.kernels.build_seconds:.1f} s")
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        f.write(_build.kernels.build_log)

    log("phase 2: kernels against their plain versions")
    chk = Checks(name)
    gen = torch.Generator(device="cuda").manual_seed(0)
    check_flash_decode(chk, gen)
    check_flash_prefill(chk, gen)
    check_qmatmul(chk, gen)
    torch.cuda.empty_cache()
    summary = {}
    if not args.kernels_only:
        log("phase 3: tiny model on the card against the CPU")
        check_tiny_model()
        log("phase 4: Llama-2-7B-shaped int4 serving")
        _build.reset_counts()
        summary = serve_7b(args.profile)
        counts = dict(_build.launches)
        for k in ("qmatmul", "flash_decode", "flash_prefill"):
            for part in ("ragged_counts", "bench_counts"):
                if summary[part].get(k, 0) <= 0:
                    raise AssertionError(f"{k} was not launched in {part}")
        if sum(_build.plain_dispatches.values()):
            raise AssertionError("a plain version ran on the main path: "
                                 f"{dict(_build.plain_dispatches)}")
        log(f"  main path launches {counts}; plain-version dispatches "
            f"{dict(_build.plain_dispatches)}")
    else:
        counts = {}

    launches_of = {"qmatmul_int4": "qmatmul", "flash_decode": "flash_decode",
                   "flash_prefill": "flash_prefill"}
    kernels = []
    for rec in chk.records.values():
        main = next(c for c in rec["cases"] if c["main"])
        kernels.append(dict(
            name=rec["name"], route=rec["route"], source=rec["source"],
            replaces=rec["replaces"],
            launches=counts.get(launches_of[rec["name"]], 0),
            max_abs_err=max(c["max_abs_err"] for c in rec["cases"]),
            ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], library_ms=main["library_ms"],
            shape=main["shape"], cases=rec["cases"]))
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card_line, kernels=kernels, e2e=summary), f,
                  indent=1)
    log(json.dumps({"kernels": [{k: v for k, v in r.items() if k != "cases"}
                                for r in kernels]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
