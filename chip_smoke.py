#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`neural_speed_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                 # all phases (needs one card)
    python3 chip_smoke.py --kernels-only  # build + kernel checks only
    python3 chip_smoke.py --kernels-only --only qmatmul_lut,flash
                                          # ... of the kernels so named
    python3 chip_smoke.py --profile       # all phases + a torch.profiler
                                          # trace of the main path
    python3 chip_smoke.py --phases 3,12   # build + only these phases
    python3 chip_smoke.py --phases 13     # the serving path (api.Model)
    python3 chip_smoke.py --phases 14     # speculative / mixed serving
    python3 chip_smoke.py --phases 2 --only qk
                                          # the int8 score dot's checks
    python3 chip_smoke.py --compare-runs p.json c.json p2.json
                                          # a pair run's outputs compared
    python3 chip_smoke.py --phases 2 --only qmatmul_lut_f32
                                          # phase 2 of the kernels so named

Phases, each raising on failure so the run exits non-zero:

1. print the card (`nvidia-smi` name and power limit) and build the kernels
   from `neural_speed_tpu_torch/csrc/*.cu` with `nvcc` (sm_90a);
2. hold each kernel against its plain PyTorch version on the card at the
   main path's shapes, with the stated tolerance, and time kernel, plain
   version and a library yardstick (CUDA events around each call, cold L2,
   host time excluded: see `time_ms`).  The attention kernels run at 32
   and at 8 KV heads (n_rep 1 and 4).  The paged attention kernels run
   over a shuffled page table, at page sizes 128 and 16, and must also
   equal the contiguous kernels over the gathered layer bit for bit.  The
   grouped MoE kernels (kernel 11 and the grouped instances of F and P)
   run at Mixtral-8x7B's expert shapes over routes from `route_tokens`
   (uniform, one expert taking every token, one expert empty, a B = 4
   decode step) and as the single-token GEMV, kernel 11 also at Grok-1's
   down projection (K = 32768) at bm = 64 and 128.  Kernel A runs at
   M = 1, 4, the GEMV's ends and its one-pass tensor-core rows (8, 9, 16,
   32), the GEMM's (33, 100, 1975, 2048), and at 5, 6, 7 rows
   (`gemv_odd`); its GEMM is held against P's one-plane INT4 instance on
   the same pack, output digests equal (`a_vs_p`).  P's one-plane INT instances
   run on the GPTQ / AWQ and GGUF packs (uint8 zero points, float32 and
   double-quantized scales, widths 1, 2, 4 and 8).  The attention variants
   (VARIANT_CASES): kernels B, C, 9 and 10 over bf16 K/V and with ALiBi
   over int8 and bf16 K/V, at 32 and 40 heads, and kernel C at Falcon-7B's
   71 query heads over one KV head, each paged kernel equal to its
   contiguous twin bit for bit; the head-dim instances (DIM_CASES):
   kernels B, C, 9 and 10 at D = 80, 96 and 256 and the masked D = 72,
   over int8, bf16 and float32 K/V, decode (B = 4) and prefill (T = 2048),
   and Gemma-2B's 8 query heads over one KV head at 256; grok's logit
   softcap of 30 (SOFTCAP_CASES) on kernels B, C, 9 and 10 at Grok-1's 48
   query heads over 8 KV heads, over int8 K/V with bf16 and float32
   scales, bf16 K/V and with ALiBi, q drawn so that the softcap bites
   (each output also held far from the output without it); int8 K/V with
   float32 scales at Llama-2-7B's shapes (SCALE_F32_CASES), the fused
   append's codes and float32 scales equal to the plain version's; the
   non-causal variant (NONCAUSAL_CASES) of kernels C and 9 at
   whisper-large-v2's encoder (B = 1, T = 1500, 20 heads of 64, float32
   K/V, q and output over S = 1536, kv_len 1500, the padding filled with
   large values) and cross prefix (T = 4, B = 1 and 4), of B and 10 at
   its cross attention per decode step (B = 1 and 4, position 0), over
   int8 and bf16 K/V and with ALiBi once each, each output also held far
   from the causal one; the causal float32 instances of C, 9, B and 10 at
   whisper's decoder self-attention (WHISPER_SELF_CASES: S = 448, the
   4-token prefix, decode steps at B = 1 and 4 at a few lengths); a
   float32 output must not be a bf16 value; the float32-activation
   instances of F, P and P's INT instances (`check_f32_formats`: nf4,
   int5 asymmetric, int3, fp8_e4m3, float offsets, int8, int4 asymmetric
   and kernel A's pack) at whisper-large-v2's linears (M = 1, 4, 1500;
   fc1 also at 33 and 100) and Llama-2-7B's o at M = 33, 100 and 2048,
   within 256 float32 ulps of a float64 product, a TF32 product and the
   kernel on bf16-rounded x failing it (the GEMM's bound: 3xTF32 on the
   tensor cores), and 20 calls of fc1 at M = 1500 per instance giving the
   same bytes (`check_f32_repeat`);
   the int8 score dot (`NST_FLASH_INT8=qk`, QK_CASES) in B and 10 at every
   head-dim instance, both scale types, ALiBi, the softcap and without the
   extra column, q drawn with outliers, each output also held more than 10
   tolerances from the output without it and timed beside it; and kernel
   B's int8 dot over several tokens per slot (QK_MULTI_CASES: speculative
   decoding's verify steps at t = 2, 4 and 8 over Llama-2-7B's heads, t = 2
   over Mixtral's 8 KV heads, float32 scales, ALiBi and non-causal at
   t = 4, the head-dim instances at t = 4; padded rows at max_len - 1 and
   an idle slot), each timed beside its plain version and SDPA over the
   dequantized K/V with the same per-row mask; the GEMM of F, P and P's
   INT instances at the low end of its route (M = 33 and 100: nf4, int5
   asymmetric, int1, fp8_e4m3, GGUF Q4_0 at Llama-2-7B's qkv,
   `check_gemm_low_m`); and the rows decode body (ROWS_CASES: Gemma-2B's
   8 query heads over one KV head at D = 256 and Falcon-7B's 71 over one
   at D = 64, B = 1 and 4, over int8, bf16 and float32 K/V; 12 over 3 at
   D = 128, once with ALiBi and the softcap), contiguous and paged over a
   shuffled table, the paged equal to the contiguous bit for bit, each
   timed beside its plain version, SDPA and kernel C / 9 on the same call;
   kernels G and H (int8 compute, `check_int8_formats`) at the five Llama
   shapes at M = 9, 16, 32 (the GEMV), 1975, 2048 (the GEMM), and 31, 33,
   100 at qkv and o, over every width they take (int4 symmetric and
   asymmetric with bf16 or float32 scales, int8; int2, int3, int5, int6,
   int7, symmetric and asymmetric) and per token, each timed beside
   `torch._int_mm` on a row-major and a column-major B (the faster kept,
   its layout recorded); their bf16 output as the model path calls them,
   grouped and per token (`check_int8_epilogue`); and their repeat check
   (`check_int8_rows`: 20 calls after L2 flushes give one digest at 8192,
   1975 and 32 rows, and rows 0..1974 equal at 8192 and 1975); kernels C
   and 9 at the edges of their body (PREFILL_CASES: T = 1, 4 and 8, one
   consumer warpgroup, the last two at the end of each slot's kv_len as
   verify steps; 65 at the end; 1975 over kv_len 1975, over int8 and
   bf16 K/V) and kernel 9 at page size 48, each C / 9 case at B = 1 from
   position 0 timed beside SDPA with the mask and with `is_causal` over
   the real rows (the faster kept as the library time, its call named);
   and their repeat check (`flash_prefill_repeat`: 20 calls after L2
   flushes give one digest at the headline case and at page size 16);
   the GEMV of F, P and P's INT instances where the main path runs it
   (`check_fp_gemv`: 8, 16 and 32 rows at Llama-2-7B's qkv and gate/up in
   nf4, int5 asymmetric, int3, int7, fp8_e4m3, GPTQ, GGUF Q4_0 and Q2_K;
   1 and 4 rows of int3 and int7; 5, 9 and 31 rows of int5 and GPTQ at
   qkv), its repeat check (`fp_gemv_repeat`: 20 calls after L2 flushes
   give one digest at 1, 4, 9 and 32 rows) and its launch check
   (`fp_gemv_launches`: torch.profiler sees one GEMV launch per call, and
   at most one reduce, at every M <= 32); kernels B and 10 at B = 1 (a
   live slot at kv_len 1976: int8 and bf16 K/V at 32 and 8 KV heads,
   Grok-1's softcap at n_rep 6; each paged twin at page size 128, the int8
   ones also at 16: DECODE_B1_CASES), their launch check
   (`decode_launches`: torch.profiler sees one kernel per `decode_cuda` /
   `decode_paged_cuda` call) and their repeat check (`decode_repeat`: 20
   calls after L2 flushes give one digest at the headline case and at page
   size 16).  Kernels B and 10 are timed over DECODE_REPS calls, the other
   kernels over TIME_REPS; each check logs its seconds.  A plain version
   that takes PLAIN_ONCE_MS or more is timed once (`plain_time_ms`);
3. a tiny model through `Engine` on the card against the same model on the
   CPU (plain versions), once in int4, once per configuration of phase
   5 and as a tiny Mixtral at B = 3 and B = 1: logits within tolerance,
   identical greedy ids at every step; then a tiny `PagedEngine` the same
   way, through a release and a refill into fragmented pages; then the
   converted checkpoints: a GPTQ act-order llama, GGUF Q4_0 / Q8_0 /
   Q4_K_M / Q2_K llamas, a GGUF Q4_0 and an nf4 Mixtral; then tiny HF
   float checkpoints converted by `convert/hf.py`: MPT (6 heads, ALiBi)
   over the bf16 and the int8 cache, BLOOM and Falcon (MQA) over bf16, and
   the tiny llama through a bf16 `PagedEngine`, a release and a refill;
   a Gemma at head dim 256, a Phi at 80 and a GPT-NeoX at 96 over bf16,
   and the Phi over a float32 cache; a tiny grok (n_rep 6 at head dim 128,
   the softcap at 2, where it bites) through `Engine` and `PagedEngine` at
   B = 3 and B = 1, and the tiny llama over int8 K/V with float32 scales;
   a tiny whisper (head dim 64) in float32, int8 and nf4: encoder states,
   logits and greedy, timestamp and 3-beam ids against the CPU, the
   greedy and beam ids changing from step to step; a tiny llama written as
   an HF checkpoint directory and loaded (int4 g64) by `Model().init(dir)`
   on the card and by `Model().init(dir, device="cpu")`, `generate` over
   `Engine` and `ModelServer` over `PagedEngine`, every sampling call's
   logits held card against CPU, without and with the int8 score dot
   (`check_tiny_serving`).
   Phases 3-8 serve over the int8 cache (`kv_quantized=True`), phases 9-11
   over the engines' default bf16 cache, int8 and float32;
4. the main path: a Llama-2-7B-shaped int4 model (full width and depth,
   random weights from a seed, drawn on the card) serves 4 ragged requests,
   then the bench shape (B = 1, a 1975-token prefill, 64 greedy steps); every
   kernel's launch counter must be > 0 and no plain version may run.  With
   `--profile`, torch.profiler then traces one prefill and 8 decode steps
   (device time by kernel group, idle share);
5. the same path in the other weight formats: the 32-layer model packed as
   nf4, asymmetric int5, fp8_e4m3, and int4 / int3 with int8 compute
   (`Engine(comp="int8")`), each serving B = 1, a 1975-token prefill and 32
   greedy steps; the expected matmul kernels (and only they) must have
   launched at prefill and at decode, and no plain version may run;
6. the phase-4 model (the same params) through `PagedEngine` at page size
   128: (a) the 4 ragged requests on a 40-page pool, every logit equal to
   phase 4's bit for bit and the pool returned in full after
   `release_slot`; (b) the bench shape (TTFT, ms/token, launches); (c) the
   ragged requests through 8-step decode windows as a scheduler drives
   them, greedy (ids equal to (a)) and sampled with the default
   `SamplingParams`.  Both paged kernels must launch, neither contiguous
   attention kernel, and no plain version;
7. a Mixtral-8x7B-shaped int4 model (full width and depth, 8 experts
   top-2, random weights from a seed, drawn on the card): (a) the ragged
   requests through `Engine`, (b) the bench shape (B = 1: the MoE layers
   take the single-token path), (c) (a) through `PagedEngine`, every logit
   equal to (a)'s bit for bit.  It prints the weight GiB, TTFT, ms/token
   and launches per kernel; the grouped kernel and kernel A must launch in
   prefill and decode, no plain version may run, and the MoE layers of a
   B = 4 and a B = 1 decode step must not synchronise the host;
8. quantized checkpoints drawn from a seed in their published layouts and
   converted by the port's loaders, each serving the bench shape (B = 1, a
   1975-token prefill, 32 greedy steps): Llama-2-7B as GPTQ int4 g128
   act-order (AutoGPTQ v1 layout, repacked on the card; also the ragged
   requests through `Engine` and `PagedEngine`, bit-equal), as GGUF Q4_0
   through a file (`GGUFWriter`, `load_gguf_model`), as GGUF Q8_0 and
   Q2_K; Mixtral-8x7B as GGUF Q4_0 (the ragged requests too, and the MoE
   layers of a B = 4 and a B = 1 step under the sync check) and as nf4.
   Each run prints weight GiB, TTFT, ms/token and launches per kernel; the
   expected matmul kernels (and only they) must launch at prefill and at
   decode, and no plain version may run;
9. float HF checkpoints drawn on the card in their published layouts and
   converted there by `convert/hf.py` to int4, at full width and depth:
   MPT-7B over the default bf16 cache (bench shape with 64 greedy steps;
   the ragged requests through `Engine` and `PagedEngine`, bit-equal) and
   over int8, BLOOM-7B1 (bf16 cache, bench shape) and Falcon-7B at g64
   (bf16 cache, bench shape; the ragged requests through `Engine` and
   `PagedEngine`, bit-equal: its decode runs the rows body and its paged
   twin).  Each prints checkpoint and weight GiB,
   conversion seconds and peak GiB, TTFT, ms/token, launches per prefill
   and per decode step, and the tied LM head's ms per step; with
   `--profile`, a trace of MPT-7B's prefill and decode;
10. the head dims 256, 80 and 96 and float32 K/V at full width and depth,
   float HF checkpoints drawn and converted on the card as in phase 9 (int4
   g128): Gemma-7B over bf16 (bench shape; ragged `Engine` = `PagedEngine`
   bit for bit), GPT-J-6B over int8 (bench shape: kernel B's fused append
   at D = 256), Phi-2 over bf16 and over float32 K/V (bench shape and
   ragged bit-equality each), GPT-NeoX-20B over bf16 (bench shape, a
   38.3 GiB checkpoint).  Each prints what phase 9 prints and the launches
   per head-dim instance, which must include the model's;
11. Grok-1 at full width (hpcai-tech/grok-1's config; 16 of its 64 layers,
   int4 g128, random weights from a seed drawn on the card after every
   earlier phase's params are freed): (a) the ragged requests through
   `Engine` over the default bf16 cache and `PagedEngine`, bit-equal;
   (b) the bench shape (64 greedy steps); (c) (a) and (b) over int8 K/V
   with float32 scales; (d) a 2-layer full-width checkpoint in the
   hpcai-tech layout converted on the card by `map_grok`, serving the
   ragged requests.  The softcap variants of C / 9 and B / 10, A and
   kernel 11 must launch, no plain version may run, and the MoE layers of
   a B = 4 and a B = 1 decode step must not synchronise the host;
12. whisper-large-v2 at full width and depth in float32 (`serve_whisper`:
   a 5.75 GiB checkpoint drawn on the card, written to a temporary
   directory and loaded by `AudioModel().init`; `transcribe` of a 30 s
   wav; mel, encode, cross K/V, the forced prefix, 64 decode steps and a
   4-beam search timed).  The non-causal and causal float32 instances of
   C and B at head dim 64 must launch and no plain version may run.  Then
   the same checkpoint quantized on the card (g128): int8 through
   `AudioModel().init(dir, use_quant=True)` (transcribe, encode, cross
   K/V, prefix, 64 decode steps, 4-beam search), nf4 and asymmetric int5
   (one encode, 16 decode steps); the format's float32 matmul instance must
   launch at encode and in a decode step, no bf16 matmul instance and no
   plain version may run, and TF32 must stay off;
13. the continuous-batching serving path: the phase-4 model as an
   `api.Model` over `PagedEngine` (int8 pool, 4 slots, page size 128)
   serving 8 requests issued at once through `ModelServer` (prompts
   1975 / 900 / 300 / 37 / 1500 / 640 / 128 / 9, budgets 24 / 8 / 16 / 4 /
   32 / 12 / 20 / 6, greedy), without and then with the int8 score dot:
   every budget delivered, first tokens equal to each prompt's argmax
   prefilled alone (where the margin clears 2%), the pool free after
   `join`, kernels A, 9 and 10 (its `_qk` instance under qk) launched and
   no plain version; the first decode window over four of the prompts
   held against kernel 10's plain version, without and with qk; TTFT per
   request, ms/token, requests/s and tokens/s on the host clock; with `--profile`, one traced 8-token decode window
   of the scheduler without and with qk (idle share);
14. speculative and mixed-prefill serving with the phase-4 model over the
   int8 cache: (a) `api.Model.generate(prompt, speculative=True,
   speculative_k=7)` on a contiguous B = 1 engine (the single-sequence
   helper; a 1975-token prompt, a seeded 48-token pattern repeated; 64
   ids), qk off then on, its ids held against `Engine.generate_greedy`'s
   wherever the top-2 margin exceeds twice the measured difference between
   the verify forward's rows and the decode logits, its first verify
   forward against the same forward through the attention kernel's plain
   version (within 2% of the largest logit); (b) phase 13's eight
   requests through `ModelServer(speculative=True)` on a contiguous B = 4
   engine, qk off and on, then on the B = 4 `PagedEngine` at page size 128;
   (c) `ModelServer(mixed_prefill=True, mixed_chunk=32)` on that pool;
   each held against the same server without speculation (equal ids where
   the margin allows), TTFT and ms/token per request, requests/s, tokens/s,
   draft tokens accepted per verify and the share of steps in backoff;
   then the ms of a verify step at T = 4 and 8 against a decode step at
   B = 4 (and with `--profile` a traced T = 8 verify step).  Under qk the
   t > 1 qk instance of B must launch; no plain version may run.

It prints a `kernels` JSON line, then as its last line
`{"ok": true, "device": {...}}`.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out")

# Published peaks (NVIDIA data sheets): device-memory bytes/s, dense bf16
# tensor FLOP/s and float32 FLOP/s outside the tensor cores; the bound of a
# call is the larger of bytes / rate and operations / peak.
PEAKS = {"H100 SXM": (3.35e12, 989e12, 67e12),
         "H100 PCIe": (2.0e12, 756e12, 51e12),
         "H100 NVL": (3.9e12, 835e12, 60e12), "H200": (4.8e12, 989e12, 67e12)}


def peaks_for(name: str):
    if "H200" in name:
        return PEAKS["H200"]
    if "NVL" in name:
        return PEAKS["H100 NVL"]
    if "PCIe" in name:
        return PEAKS["H100 PCIe"]
    return PEAKS["H100 SXM"]


def bound(nbytes: float, flops: float, name: str, peak: str = "bf16"):
    """The least ms for the work: bytes at the memory rate against
    operations at the dense bf16 peak, the int8 peak (twice it), the
    float32 (non-tensor) peak, or "tf32x3": a float32-accurate product as
    three TF32 products on the tensor cores (TF32 at half the bf16 peak,
    three times the work: the bf16 peak / 6)."""
    bw, fl, f32 = peaks_for(name)
    rate = {"bf16": fl, "int8": 2 * fl, "f32": f32, "tf32x3": fl / 6}[peak]
    tb, tf = nbytes / bw * 1e3, flops / rate * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


_T0 = time.time()


def log(msg: str) -> None:
    print(msg, flush=True)


def log_phase(msg: str) -> None:
    """A phase's first line, with the seconds since the run started."""
    log(f"{msg} [{time.time() - _T0:.1f} s]")


def _kernel_name(name: str) -> str:
    """A profiler kernel name without its return type, the anonymous
    namespace and its argument list: "void (anonymous namespace)::f<int>(
    float*)" -> "f<int>"."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    depth = 0
    for i in range(len(name) - 1, -1, -1):  # the "(" that opens the last ")"
        depth += {")": 1, "(": -1}.get(name[i], 0)
        if depth == 0 and name[i] == "(":
            return name[:i]
    return name


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


# Timed calls per case: TIME_REPS for the kernels this tree did not change
# (phase 2's depth, cut to keep the default run inside its time limit),
# DECODE_REPS for kernels B and 10 (redesigned here, held against the
# parent in a pair run).
TIME_REPS = 5
DECODE_REPS = 10


def time_ms(fn, reps: int = TIME_REPS, warmup: int = 2) -> float:
    """Device time of one fn() call: the median over `reps` calls of CUDA
    events recorded just before and just after the call, each call after an
    L2 flush.  Before each call a sleep kernel holds the stream while the
    host enqueues the call, so the host's time between launches is not
    counted (one sleep per call: CUDA's launch queue holds about a thousand
    launches, and a plain version may make hundreds).  If a sleep
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
    sleep_ms = 2 * host_ms + 0.5
    for _ in range(4):
        spans, ahead = [], True
        for _ in range(reps):
            gate, start, end = event(), event(), event()
            _flush_l2()
            torch.cuda._sleep(int(sleep_ms * _sleep_cycles_per_ms()))
            gate.record()
            start.record()
            fn()
            end.record()
            ahead = ahead and not gate.query()
            spans.append((start, end))
        torch.cuda.synchronize()
        if ahead:
            return statistics.median(s.elapsed_time(e) for s, e in spans)
        sleep_ms *= 2
    raise RuntimeError(f"time_ms: the host did not get ahead of the device "
                       f"within a {sleep_ms / 2:.1f} ms sleep per call")


PLAIN_ONCE_MS = 5.0


def plain_time_ms(fn) -> float:
    """A plain version's device time: one timed call after one warm-up, and
    the median of three only when that call took less than PLAIN_ONCE_MS
    (a plain version is the yardstick of correctness, not of speed)."""
    once = time_ms(fn, reps=1, warmup=1)
    return once if once >= PLAIN_ONCE_MS else time_ms(fn, reps=3)


def _category(kernel_name: str) -> str:
    tc = re.search(r"gemm_kernel<\d+, \d+, (true|false), [^,]+, (true|false)>",
                   kernel_name)
    if tc and tc.group(2) == "true":
        # kernel A's and kernel 11's GEMMs: the tc template with A4 = true
        return "qmatmul_grouped" if tc.group(1) == "true" else "qmatmul"
    if "nstfp::" in kernel_name:
        # F, P and P's one-plane INT instances; the grouped ones take
        # GROUPED = true (the third template argument of gemm_kernel and
        # gemv_row_kernel), the float32-activation ones float32 x and out;
        # both write float32 through splitk_reduce_kernel<float>
        if re.search(r"(gemm_kernel|gemv_row_kernel)<\d+, \d+, true", kernel_name):
            return "qmatmul_grouped_fp"
        if "gemm_tf32x3" in kernel_name or "float, float" in kernel_name:
            return "qmatmul_fp_f32"
        if "<float>" in kernel_name:
            return "splitk_reduce_f32"
        return "qmatmul_fp"
    if "int4" in kernel_name or "splitk" in kernel_name:
        # kernel 11's instances: GROUPED = true, float32 output
        grouped = "true" in kernel_name or "<float>" in kernel_name
        return "qmatmul_grouped" if grouped else "qmatmul"
    for key in ("flash_decode", "flash_prefill", "flash_rows"):
        if key in kernel_name:
            return key
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
    largest error over its scale, the largest error over its tolerance (the
    check passes when that is <= 1), and a digest of `got`'s bytes (two
    builds of a kernel give the same output on the same inputs when their
    digests agree)."""
    diff = (got.float() - want.float()).abs()
    mag = want.float().abs()
    scale = mag.amax(-1, keepdim=True) if per_row else mag.amax()
    tol = ulps * 2.0 ** -8 * scale + ATOL
    raw = got.detach().contiguous().view(torch.uint8).cpu().numpy()
    return dict(err=diff.max().item(),
                rel=(diff / scale.clamp_min(ATOL)).max().item(),
                worst=(diff / tol).max().item(),
                digest=hashlib.sha256(raw.tobytes()).hexdigest()[:16],
                tol=f"{ulps} bf16 ulps of the largest |output| of its "
                    f"{'row' if per_row else 'tensor'}")


class Checks:
    def __init__(self, card: str):
        self.card = card
        self.records = {}
        self.notes = {}   # checks that record no kernel case

    def add(self, name, route, source, replaces, shape, cmp, ms, plain_ms,
            lib_ms, nbytes, flops, main=False, peak="bf16", extra=None):
        """One case of a kernel's check; the `main` case gives the kernel's
        times in the kernels line.  `peak`: the operations' rate of the
        bound ("bf16", "int8" or "f32"); `extra`: more fields of the case's
        record."""
        b_ms, b_by = bound(nbytes, flops, self.card, peak)
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
                                 digest=cmp.get("digest"),
                                 err_over_scale=cmp["rel"],
                                 err_over_tol=cmp["worst"], ms=ms,
                                 plain_ms=plain_ms, library_ms=lib_ms,
                                 bound_ms=b_ms, bound_by=b_by, main=main,
                                 **(extra or {})))


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


# Kernel A at Llama-2-7B's projections (qkv, o, gate/up, down repadded to
# K = 11264, head) and rows: decode (1, 4), the GEMV's ends and its one-pass
# tensor-core body (8, 9, 16, 32: speculative verify steps), the GEMM from
# its low end to the bench prefill (33, 100, 1975, 2048).
QMATMUL_SHAPES = [(4096, 12288), (4096, 4096), (4096, 22016), (11264, 4096),
                  (4096, 32000)]
QMATMUL_M = (1, 4, 8, 9, 16, 32, 33, 100, 1975, 2048)


def check_qmatmul(chk: Checks, gen: torch.Generator) -> None:
    from neural_speed_tpu_torch.ops import matmul
    from neural_speed_tpu_torch.ops.qtypes import QSpec, QType
    from neural_speed_tpu_torch.ops.quantize import dequantize
    from neural_speed_tpu_torch.utils.synthetic import synth_qtensor

    spec = QSpec(QType.INT, 4, 128, True, scale_dtype="bfloat16")
    for k, n in QMATMUL_SHAPES:
        qt = synth_qtensor(gen, k, n, spec)
        w_bf16 = dequantize(qt, torch.bfloat16)
        # M = 8192: the ragged prefill (B = 4 at the 2048 bucket)
        for m in QMATMUL_M + ((8192,) if (k, n) == (4096, 4096) else ()):
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
            plain_ms = plain_time_ms(lambda: matmul.qmatmul_plain(x, qt))
            lib_ms = time_ms(lambda: torch.matmul(x, w_bf16))
            extra = None
            if m > matmul.GEMV_MAX_M:
                # the GEMM's x in band-major order: a copy on the host side
                extra = dict(band_major_ms=time_ms(
                    lambda: matmul._band_major(x, 8)))
            nbytes = m * k * 2 + k * n // 2 + (k // 128) * n * 2 + m * n * 2
            chk.add("qmatmul_int4", "cuda", "neural_speed_tpu_torch/csrc/qmatmul.cu",
                    "neural_speed_tpu/ops/matmul.py:127", f"M={m} K={k} N={n}",
                    cmp, ms, plain_ms, lib_ms, nbytes, 2.0 * m * n * k,
                    main=(m, k, n) == (1, 4096, 22016), extra=extra)


# The Llama-2-7B projections: qkv, o, gate/up, down, head.  The down
# projection's K = 11008 is K-repadded at load time to the pack period x 128.
SHAPES_7B = {"qkv": (4096, 12288), "o": (4096, 4096), "gateup": (4096, 22016),
             "down": (11008, 4096), "head": (4096, 32000)}


def _shape(name: str, spec):
    from neural_speed_tpu_torch.ops.matmul import kernel_k_multiple

    k, n = SHAPES_7B[name]
    period = kernel_k_multiple(spec) * 128
    return -(-k // period) * period, n


def _fmt_name(qt) -> str:
    spec = qt.spec
    name = spec.qtype.value if spec.qtype.value != "int" else f"int{spec.bits}"
    if spec.lut is not None:
        name += "+lut"
    if qt.zeros is not None:
        name += "/f32off" if qt.zeros.is_floating_point() else "/asym"
    return name + ("/f32s" if qt.scales.dtype == torch.float32 else "")


def _float_offsets(gen, qt):
    """The pack with ggml float offsets m (w = s * code + m) in place of its
    symmetric offset."""
    import dataclasses

    m = (torch.rand(qt.scales.shape, generator=gen, device="cuda") - 0.5) * 0.2
    return dataclasses.replace(qt, zeros=m)


def check_fp_formats(chk: Checks, gen: torch.Generator) -> None:
    """Kernels F and P against `qmatmul_plain` at the 7B shapes."""
    from neural_speed_tpu_torch.ops import matmul
    from neural_speed_tpu_torch.ops.qtypes import FP4_LUT, named_qspec
    from neural_speed_tpu_torch.ops.quantize import dequantize
    from neural_speed_tpu_torch.utils.synthetic import synth_qtensor
    import dataclasses

    bf = dict(group_size=128, scale_dtype="bfloat16")
    nf4 = named_qspec("nf4", **bf)
    # a converter's table: the fp4 values reversed, float32 scales
    fp4 = dataclasses.replace(named_qspec("fp4", 128),
                              lut=tuple(float(v) for v in FP4_LUT[::-1]))
    int5 = named_qspec("int5", symmetric=False, **bf)
    e4m3 = named_qspec("fp8_e4m3", **bf)
    sm = (1, 2048)
    lut_cases = [(nf4, name, (1, 4, 2048), False) for name in SHAPES_7B]
    lut_cases.append((fp4, "o", sm, False))
    planar_cases = [(int5, name, (1, 4, 2048), False)
                    for name in ("qkv", "gateup", "down", "head")]
    planar_cases += [
        (e4m3, "o", (1, 4, 2048), False), (e4m3, "down", sm, False),
        (e4m3, "gateup", sm, False),
        (named_qspec("int3", **bf), "o", sm, False),
        (named_qspec("int7", **bf), "o", sm, False),
        (named_qspec("int7", **bf), "down", (4,), False),
        (named_qspec("int6", 128), "o", sm, False),
        (named_qspec("fp8_e5m2", 128), "o", sm, False),
        (named_qspec("int4", 128), "o", sm, True)]
    kernels = (
        ("qmatmul_lut", matmul.qmatmul_lut_cuda, lut_cases,
         "neural_speed_tpu_torch/csrc/qmatmul_lut.cu",
         "neural_speed_tpu/ops/matmul.py:217", nf4),
        ("qmatmul_planar", matmul.qmatmul_planar_cuda, planar_cases,
         "neural_speed_tpu_torch/csrc/qmatmul_planar.cuh",
         "neural_speed_tpu/ops/matmul.py:376", int5))
    for kname, launch, cases, source, replaces, main_spec in kernels:
        for spec, shape_name, ms_list, offsets in cases:
            k, n = _shape(shape_name, spec)
            qt = synth_qtensor(gen, k, n, spec)
            if offsets:
                qt = _float_offsets(gen, qt)
            w_bf16 = dequantize(qt, torch.bfloat16)
            for m in ms_list:
                x = torch.randn((m, k), generator=gen, device="cuda").to(
                    torch.bfloat16)
                got = launch(x, qt)
                want = matmul.qmatmul_plain(x, qt)
                torch.cuda.synchronize()
                # as kernel A: both versions take the same dequantized
                # values (float32 at M <= 32, rounded once to bf16 above), so
                # only the order of the float32 sums and the bf16 rounding
                # of the output differ -> two bf16 ulps of the largest output
                cmp = compare(got, want, 2, per_row=False)
                ms = time_ms(lambda: launch(x, qt))
                del got, want
                plain_ms = plain_time_ms(lambda: matmul.qmatmul_plain(x, qt))
                lib_ms = time_ms(lambda: torch.matmul(x, w_bf16))
                nbytes = m * k * 2 + qt.nbytes() + m * n * 2
                chk.add(kname, "cuda", source, replaces,
                        f"{_fmt_name(qt)} M={m} K={k} N={n}", cmp, ms,
                        plain_ms, lib_ms, nbytes, 2.0 * m * n * k,
                        main=(spec is main_spec and m == 1
                              and shape_name == "gateup"))
            del qt, w_bf16
            torch.cuda.empty_cache()


# The low end of the GEMM route (M = 33 and 100, just above the GEMV's
# M <= 32) at Llama-2-7B's qkv for the formats of rows 1-3: nf4 (F), int5
# asymmetric and fp8_e4m3 (P), int1 and GGUF Q4_0 (P's one-plane INT
# instances).  Drawn from a generator of their own (LOW_M_SEED), after
# every other check.
LOW_M_SEED = 33
LOW_M = (33, 100)


def check_gemm_low_m(chk: Checks, gen: torch.Generator) -> None:
    """Kernels F, P and P's INT instances at M = 33 and 100 against
    `qmatmul_plain` (2 bf16 ulps of the largest output, as the M = 2048
    cases), through `qmatmul` (the route the main path takes)."""
    from neural_speed_tpu_torch.ops import matmul
    from neural_speed_tpu_torch.ops.qtypes import named_qspec
    from neural_speed_tpu_torch.ops.quantize import dequantize
    from neural_speed_tpu_torch.utils.synthetic import synth_qtensor

    gen = torch.Generator(device="cuda").manual_seed(LOW_M_SEED)
    bf = dict(scale_dtype="bfloat16")
    kinds = {"F": ("qmatmul_lut", "neural_speed_tpu_torch/csrc/qmatmul_lut.cu",
                   "neural_speed_tpu/ops/matmul.py:217"),
             "P": ("qmatmul_planar",
                   "neural_speed_tpu_torch/csrc/qmatmul_planar.cuh",
                   "neural_speed_tpu/ops/matmul.py:376"),
             "I": ("qmatmul_int",
                   "neural_speed_tpu_torch/csrc/qmatmul_planar.cuh",
                   "neural_speed_tpu/ops/matmul.py:127")}
    for spec in (named_qspec("nf4", 128, **bf),
                 named_qspec("int5", 128, False, **bf),
                 named_qspec("int1", 128, **bf),
                 named_qspec("fp8_e4m3", 128, **bf),
                 named_qspec("int4", 32)):                # GGUF Q4_0
        k, n = _shape("qkv", spec)
        qt = synth_qtensor(gen, k, n, spec)
        kname, source, replaces = kinds[matmul.kernel_for(qt)]
        w_bf16 = dequantize(qt, torch.bfloat16)
        for m in LOW_M:
            x = torch.randn((m, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            got = matmul.qmatmul(x, qt)
            want = matmul.qmatmul_plain(x, qt)
            torch.cuda.synchronize()
            # as the M = 2048 cases: the same dequantized values, float32
            # sums in another order, one bf16 rounding of the output
            cmp = compare(got, want, 2, per_row=False)
            del got, want
            ms = time_ms(lambda: matmul.qmatmul(x, qt))
            plain_ms = plain_time_ms(lambda: matmul.qmatmul_plain(x, qt))
            lib_ms = time_ms(lambda: torch.matmul(x, w_bf16))
            chk.add(kname, "cuda", source, replaces,
                    f"{_fmt_name(qt)} g={spec.group_size} M={m} K={k} N={n}",
                    cmp, ms, plain_ms, lib_ms,
                    m * k * 2 + qt.nbytes() + m * n * 2, 2.0 * m * n * k)
        del qt, w_bf16
        torch.cuda.empty_cache()


# The GEMV of F, P and P's one-plane INT instances (`csrc/qmm_fp.cuh`) where
# the main path runs it: decode (1, 4 rows), odd row counts (5, 9, 31) and
# speculative verify steps (8, 16, 32 rows: T = 2..8 over 4 slots), at
# Llama-2-7B's qkv and gate/up, in the formats of phases 5 and 8.  Drawn
# from a generator of its own (FP_GEMV_SEED), after every other check.
FP_GEMV_SEED = 19
FP_GEMV_REPEAT_CALLS = 20


def _fp_gemv_formats():
    """(label, spec, pack transform, extra (shape, rows) cases)."""
    from neural_speed_tpu_torch.ops.qtypes import named_qspec

    bf = dict(scale_dtype="bfloat16")
    decode = [("qkv", (1, 4)), ("gateup", (1, 4))]
    odd = [("qkv", (5, 9, 31))]
    return [("nf4", named_qspec("nf4", 128, **bf), None, []),
            ("int5 asym", named_qspec("int5", 128, False, **bf), None, odd),
            ("int3", named_qspec("int3", 128, **bf), None, decode),
            ("int7", named_qspec("int7", 128, **bf), None, decode),
            ("fp8_e4m3", named_qspec("fp8_e4m3", 128, **bf), None, []),
            ("gptq", named_qspec("int4", 128, False), None, odd),
            ("q4_0", named_qspec("int4", 32), None, []),
            ("q2_k", named_qspec("int2", 16, False), _float_offsets, [])]


_FP_KERNELS = {
    "F": ("qmatmul_lut", "neural_speed_tpu_torch/csrc/qmatmul_lut.cu",
          "neural_speed_tpu/ops/matmul.py:217"),
    "P": ("qmatmul_planar", "neural_speed_tpu_torch/csrc/qmatmul_planar.cuh",
          "neural_speed_tpu/ops/matmul.py:376"),
    "I": ("qmatmul_int", "neural_speed_tpu_torch/csrc/qmatmul_planar.cuh",
          "neural_speed_tpu/ops/matmul.py:127")}


def _fp_gemv_pack(gen, spec, transform, shape_name):
    from neural_speed_tpu_torch.utils.synthetic import synth_qtensor

    k, n = _shape(shape_name, spec)
    qt = synth_qtensor(gen, k, n, spec)
    return qt if transform is None else transform(gen, qt)


def check_fp_gemv(chk: Checks, gen: torch.Generator) -> None:
    """The GEMV of F, P and P's INT instances through `qmatmul` (the main
    path's route) at 8, 16 and 32 rows at qkv and gate/up in every format of
    `_fp_gemv_formats`, and its extra decode and odd-row cases, against
    `qmatmul_plain` (2 bf16 ulps of the largest output, as every F / P
    case), each timed beside the plain version and `torch.matmul` on the
    dequantized bf16 weight."""
    from neural_speed_tpu_torch.ops import matmul
    from neural_speed_tpu_torch.ops.quantize import dequantize

    gen = torch.Generator(device="cuda").manual_seed(FP_GEMV_SEED)
    for label, spec, transform, extra in _fp_gemv_formats():
        cases = [("qkv", (8, 16, 32)), ("gateup", (8, 16, 32))] + extra
        for shape_name in dict.fromkeys(name for name, _ in cases):
            qt = _fp_gemv_pack(gen, spec, transform, shape_name)
            k, n = qt.shape
            kname, source, replaces = _FP_KERNELS[matmul.kernel_for(qt)]
            w_bf16 = dequantize(qt, torch.bfloat16)
            for m in sorted(m for name, ms_ in cases if name == shape_name
                            for m in ms_):
                x = torch.randn((m, k), generator=gen, device="cuda").to(
                    torch.bfloat16)
                got = matmul.qmatmul(x, qt)
                want = matmul.qmatmul_plain(x, qt)
                torch.cuda.synchronize()
                cmp = compare(got, want, 2, per_row=False)
                del got, want
                ms = time_ms(lambda: matmul.qmatmul(x, qt))
                plain_ms = plain_time_ms(lambda: matmul.qmatmul_plain(x, qt))
                lib_ms = time_ms(lambda: torch.matmul(x, w_bf16))
                chk.add(kname, "cuda", source, replaces,
                        f"gemv {label} {_fmt_name(qt)} g={spec.group_size} "
                        f"{shape_name} M={m} K={k} N={n}", cmp, ms, plain_ms,
                        lib_ms, m * k * 2 + qt.nbytes() + m * n * 2,
                        2.0 * m * n * k)
            del qt, w_bf16
            torch.cuda.empty_cache()


def check_fp_gemv_repeat(chk: Checks, gen: torch.Generator) -> None:
    """The GEMV is deterministic: FP_GEMV_REPEAT_CALLS calls on the same
    rows, each after an L2 flush, give one digest, at 1, 4, 9 and 32 rows
    (both bodies, the CUDA-core splits' reduce and the cluster's), int5
    asymmetric and GPTQ at qkv.  Drawn from a generator of its own."""
    from neural_speed_tpu_torch.ops import matmul

    gen = torch.Generator(device="cuda").manual_seed(FP_GEMV_SEED + 1)
    for label, spec, transform, _ in _fp_gemv_formats():
        if label not in ("int5 asym", "gptq"):
            continue
        qt = _fp_gemv_pack(gen, spec, transform, "qkv")
        k, n = qt.shape
        for m in (1, 4, 9, 32):
            x = torch.randn((m, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            first = matmul.qmatmul(x, qt)
            bad = 0
            for _ in range(FP_GEMV_REPEAT_CALLS):
                _flush_l2()
                bad += int(not torch.equal(matmul.qmatmul(x, qt), first))
            digest = compare(first, first, 2, per_row=False)["digest"]
            chk.notes.setdefault("fp_gemv_repeat", []).append(
                dict(pack=label, m=m, k=k, n=n, calls=FP_GEMV_REPEAT_CALLS,
                     differing=bad, digest=digest))
            log(f"  fp_gemv_repeat {label} M={m} K={k} N={n}: "
                f"{FP_GEMV_REPEAT_CALLS} calls after L2 flushes, {bad} "
                f"differing (digest {digest})")
            if bad:
                raise AssertionError(f"F / P GEMV {label} M={m}: {bad} of "
                                     f"{FP_GEMV_REPEAT_CALLS} calls differ")
        del qt
        torch.cuda.empty_cache()


def _kernel_names(fn) -> list:
    """The CUDA kernels one fn() call launches, by torch.profiler (a session
    that records no kernel is run again after a second's pause, up to six
    times: three sessions in a row have recorded nothing)."""
    for attempt in range(6):
        if attempt:
            time.sleep(1.0)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in _kernel_events(prof)]
        if names:
            return names
    raise RuntimeError("torch.profiler recorded no CUDA kernel")


def _kernel_groups(fns) -> list:
    """The CUDA kernels each of fns launches, from one torch.profiler
    session over all of them: a sleep kernel launched before each call
    (its name read from a session of its own) marks where the call's
    kernels begin.  The profiler has stopped recording after some tens of
    sessions in one process (a full run lost the GEMV launch check so), so
    the launch checks take one session for a batch of calls, after a first
    round outside it; a session that records no kernel, or not one mark a
    call, is run again after a second's pause, up to six times."""
    for fn in fns:        # a first round: uploads and allocations of first use
        fn()
    mark = _kernel_names(lambda: torch.cuda._sleep(1))
    if len(mark) != 1:
        raise RuntimeError(f"a sleep launched {mark}")
    for attempt in range(6):
        if attempt:
            time.sleep(1.0)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for fn in fns:
                torch.cuda._sleep(1)
                fn()
            torch.cuda.synchronize()
        groups = []
        for e in sorted(_kernel_events(prof), key=lambda e: e.time_range.start):
            if e.name == mark[0]:
                groups.append([])
            elif groups:
                groups[-1].append(e.name)
        if len(groups) == len(fns):
            return groups
    raise RuntimeError("torch.profiler did not record one mark a call")


def check_fp_gemv_launches(chk: Checks, gen: torch.Generator) -> None:
    """One GEMV launch per call, plus at most one reduce (the CUDA-core
    body's splits), at every M <= 32 for int5 asymmetric (multi-plane) and
    GPTQ (one plane), at 1, 4, 8, 9, 16 and 32 rows for nf4 and fp8_e4m3
    (bytes), and at 1, 9 and 32 rows of float32 x (quantized Whisper's
    path): the kernels torch.profiler records for each `qmatmul` call (one
    session a pack, `_kernel_groups`)."""
    from neural_speed_tpu_torch.ops import matmul

    gen = torch.Generator(device="cuda").manual_seed(FP_GEMV_SEED + 2)
    every, some = tuple(range(1, matmul.GEMV_MAX_M + 1)), (1, 4, 8, 9, 16, 32)
    rows = {"int5 asym": every, "gptq": every, "nf4": some, "fp8_e4m3": some}
    seen = {}
    for label, spec, transform, _ in _fp_gemv_formats():
        if label not in rows:
            continue
        qt = _fp_gemv_pack(gen, spec, transform, "qkv")
        k = qt.shape[0]
        cases = [(m, torch.bfloat16) for m in rows[label]]
        if label in ("int5 asym", "gptq"):
            cases += [(m, torch.float32) for m in (1, 9, 32)]
        xs = [torch.randn((m, k), generator=gen, device="cuda").to(dt)
              for m, dt in cases]
        groups = _kernel_groups([lambda x=x: matmul.qmatmul(x, qt) for x in xs])
        for (m, dt), names in zip(cases, groups):
            gemv = [nm for nm in names if "gemv" in nm]
            rest = [nm for nm in names if "gemv" not in nm]
            ok = len(gemv) == 1 and all("splitk_reduce" in nm for nm in rest) \
                and len(rest) <= 1
            key = f"{label} {str(dt).replace('torch.', '')} M={m}"
            seen[key] = [_kernel_name(nm) for nm in names]
            if not ok:
                raise AssertionError(f"F / P GEMV {key}: launches {names}")
        del qt
        torch.cuda.empty_cache()
    chk.notes["fp_gemv_launches"] = seen
    bodies = collections.Counter(tuple(v) for v in seen.values())
    log(f"  fp_gemv_launches: {len(seen)} calls, each one GEMV launch and at "
        f"most one reduce; kernels per call: "
        + json.dumps({" + ".join(k): v for k, v in bodies.items()}))


ODD_ROWS_SEED = 16
ODD_ROWS_SEED = 16


def check_gemv_odd_rows(chk: Checks, gen: torch.Generator) -> None:
    """Kernel A's GEMV at 5, 6 and 7 rows (a speculative verify step of
    T = 2 over 3 slots is 6), at the five Llama shapes, against the plain
    version (2 bf16 ulps, as `check_qmatmul`): a body of 4 rows taken
    once would leave rows 4.. unwritten.  Drawn from a generator of its
    own (ODD_ROWS_SEED)."""
    from neural_speed_tpu_torch.ops import matmul
    from neural_speed_tpu_torch.ops.qtypes import QSpec, QType
    from neural_speed_tpu_torch.utils.synthetic import synth_qtensor

    gen = torch.Generator(device="cuda").manual_seed(ODD_ROWS_SEED)
    spec = QSpec(QType.INT, 4, 128, True, scale_dtype="bfloat16")
    for k, n in QMATMUL_SHAPES:
        qt = synth_qtensor(gen, k, n, spec)
        for m in (5, 6, 7):
            x = torch.randn((m, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            got = matmul.qmatmul_cuda(x, qt)
            want = matmul.qmatmul_plain(x, qt)
            torch.cuda.synchronize()
            cmp = compare(got, want, 2, per_row=False)
            del got, want
            ms = time_ms(lambda: matmul.qmatmul_cuda(x, qt))
            plain_ms = plain_time_ms(lambda: matmul.qmatmul_plain(x, qt))
            chk.add("qmatmul_int4", "cuda",
                    "neural_speed_tpu_torch/csrc/qmatmul.cu",
                    "neural_speed_tpu/ops/matmul.py:127",
                    f"odd rows M={m} K={k} N={n}", cmp, ms, plain_ms, None,
                    m * k * 2 + k * n // 2 + (k // 128) * n * 2 + m * n * 2,
                    2.0 * m * n * k)
        del qt
        torch.cuda.empty_cache()


GEMM_ROWS_SEED = 17
GEMM_ROWS_CALLS = 20


def check_gemm_rows(chk: Checks, gen: torch.Generator) -> None:
    """Kernel A's GEMM is deterministic and each row's output depends on
    that row only, as `Engine` and `PagedEngine` need to give equal logits:
    GEMM_ROWS_CALLS calls on the same rows, each after an L2 flush (the
    weights cold, as on the main path), give one digest, at 8192 and 1975
    rows, and the first 1975 rows of an 8192-row call equal the 1975-row
    call's.  At the Llama-2-7B shapes and MPT-7B's MLP (16384 wide).
    Drawn from a generator of its own (GEMM_ROWS_SEED)."""
    from neural_speed_tpu_torch.ops import matmul
    from neural_speed_tpu_torch.ops.qtypes import QSpec, QType
    from neural_speed_tpu_torch.utils.synthetic import synth_qtensor

    gen = torch.Generator(device="cuda").manual_seed(GEMM_ROWS_SEED)
    spec = QSpec(QType.INT, 4, 128, True, scale_dtype="bfloat16")
    for k, n in QMATMUL_SHAPES + [(4096, 16384), (16384, 4096)]:
        qt = synth_qtensor(gen, k, n, spec)
        x = torch.randn((8192, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        firsts = {}
        for m in (8192, 1975):
            xm = x[:m].contiguous()
            first = matmul.qmatmul_cuda(xm, qt)
            bad_calls = 0
            for _ in range(GEMM_ROWS_CALLS):
                _flush_l2()
                bad = (matmul.qmatmul_cuda(xm, qt) != first).nonzero()
                if bad.numel():
                    bad_calls += 1
                    log(f"  qmatmul_int4 GEMM rows M={m} K={k} N={n}: a call "
                        f"differs at {bad.shape[0]} outputs, first "
                        f"{bad[0].tolist()}")
            if bad_calls:
                raise AssertionError(
                    f"kernel A M={m} K={k} N={n}: {bad_calls} of "
                    f"{GEMM_ROWS_CALLS} calls on the same rows differ")
            firsts[m] = first
        bad = (firsts[1975] != firsts[8192][:1975]).nonzero()
        if bad.numel():
            raise AssertionError(
                f"kernel A K={k} N={n}: rows 0..1974 alone differ from the "
                f"same rows of an 8192-row call at {bad.shape[0]} outputs, "
                f"first {bad[0].tolist()}")
        log(f"  qmatmul_int4 GEMM rows K={k} N={n}: {GEMM_ROWS_CALLS} calls "
            f"each at 8192 and 1975 rows, after L2 flushes, bit-equal; rows "
            f"0..1974 the same in both")
        del qt, x, firsts, xm, first
        torch.cuda.empty_cache()


A_VS_P_SEED = 15


def check_a_vs_p(chk: Checks, gen: torch.Generator) -> None:
    """Kernel A's GEMM against P's one-plane INT4 instance on the same pack
    (its bf16 scales handed to P as float32, the same values) at the five
    Llama shapes, M = 2048: both run the TMA + wgmma template on the same
    band-major x, A dequantizing in bf16x2 and P in float32, so the bf16
    weights and the order of the sums are the same: the output digests
    must be equal.  Each is also held against the plain version (2 bf16
    ulps).  Drawn from a generator of its own (A_VS_P_SEED)."""
    import dataclasses

    from neural_speed_tpu_torch.ops import matmul
    from neural_speed_tpu_torch.ops.qtypes import QSpec, QType
    from neural_speed_tpu_torch.utils.synthetic import synth_qtensor

    gen = torch.Generator(device="cuda").manual_seed(A_VS_P_SEED)
    spec = QSpec(QType.INT, 4, 128, True, scale_dtype="bfloat16")
    for k, n in QMATMUL_SHAPES:
        qt = synth_qtensor(gen, k, n, spec)
        qp = dataclasses.replace(qt, scales=qt.scales.float())
        assert matmul.kernel_for(qt) == "A" and matmul.kernel_for(qp) == "I"
        x = torch.randn((2048, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        got_a, got_p = matmul.qmatmul_cuda(x, qt), matmul.qmatmul_int_cuda(x, qp)
        want = matmul.qmatmul_plain(x, qt)
        torch.cuda.synchronize()
        cmp_a = compare(got_a, want, 2, per_row=False)
        cmp_p = compare(got_p, want, 2, per_row=False)
        if cmp_a["digest"] != cmp_p["digest"]:
            raise AssertionError(
                f"kernel A and P's INT4 instance differ at K={k} N={n}: "
                f"largest |A - P| {(got_a.float() - got_p.float()).abs().max().item()}")
        del got_a, got_p, want
        ms = time_ms(lambda: matmul.qmatmul_cuda(x, qt))
        p_ms = time_ms(lambda: matmul.qmatmul_int_cuda(x, qp))
        plain_ms = plain_time_ms(lambda: matmul.qmatmul_plain(x, qt))
        chk.add("qmatmul_int4", "cuda", "neural_speed_tpu_torch/csrc/qmatmul.cu",
                "neural_speed_tpu/ops/matmul.py:127",
                f"A = P digest M=2048 K={k} N={n}", cmp_a, ms, plain_ms, None,
                2048 * k * 2 + k * n // 2 + (k // 128) * n * 2 + 2048 * n * 2,
                2.0 * 2048 * n * k, extra=dict(p_ms=p_ms, p_digest=cmp_p["digest"]))
        del qt, qp, x
        torch.cuda.empty_cache()


def _double_quant(gen, qt):
    """The pack with double-quantized scales: int8 codes in [1, 127] and a
    float32 secondary scale per column."""
    import dataclasses

    k, n = qt.shape
    g = qt.spec.effective_group(k)
    codes = torch.randint(1, 128, (k // g, n), generator=gen, device="cuda",
                          dtype=torch.int8)
    sscale = (torch.rand((1, n), generator=gen, device="cuda") + 0.5) * 2e-4
    spec = dataclasses.replace(qt.spec, double_quant=True)
    return dataclasses.replace(qt, scales=codes, sscale=sscale, spec=spec)


def _int_cases():
    """P's one-plane INT instances ("qmatmul_int": row 1's packs that kernel
    A does not take) and kernel P's new float-offset widths (row 3), as
    (kernel, spec, shape names, M values, pack transform)."""
    from neural_speed_tpu_torch.ops.qtypes import named_qspec

    five = tuple(SHAPES_7B)
    all_m, two_m = (1, 4, 2048), (1, 2048)
    gptq = named_qspec("int4", 128, False)             # GPTQ / AWQ
    q4_0 = named_qspec("int4", 32)                     # GGUF Q4_0
    q8_0 = named_qspec("int8", 32)                     # GGUF Q8_0
    return [
        ("qmatmul_int", gptq, five, all_m, None),
        ("qmatmul_int", q4_0, five, all_m, None),
        ("qmatmul_int", q8_0, five, two_m, None),
        ("qmatmul_int", named_qspec("int8", 128, False), five, two_m, None),
        ("qmatmul_int", named_qspec("int2", 128, False), five, two_m, None),
        ("qmatmul_int", named_qspec("int1", 128, scale_dtype="bfloat16"),
         five, two_m, None),
        ("qmatmul_int", named_qspec("int4", 128), ("gateup", "o"), all_m,
         _double_quant),
        ("qmatmul_planar", named_qspec("int2", 16, False), ("gateup", "down"),
         all_m, _float_offsets),                       # GGUF Q2_K
        ("qmatmul_planar", named_qspec("int2", 128, False), ("o",), two_m,
         _float_offsets),
        ("qmatmul_planar", named_qspec("int8", 16, False), ("o",), two_m,
         _float_offsets),
        ("qmatmul_planar", named_qspec("int8", 128, False), ("gateup",),
         two_m, _float_offsets)]


def check_int_formats(chk: Checks, gen: torch.Generator) -> None:
    """P's one-plane INT instances (INT 1/2/4/8 with uint8 zero points,
    float32 or double-quantized scales) and kernel P's float offsets at
    widths 2 and 8 against `qmatmul_plain` at the 7B shapes, through
    `qmatmul` (the route the main path takes)."""
    from neural_speed_tpu_torch.ops import matmul
    from neural_speed_tpu_torch.ops.quantize import dequantize
    from neural_speed_tpu_torch.utils.synthetic import synth_qtensor

    sources = {
        "qmatmul_int": ("neural_speed_tpu_torch/csrc/qmatmul_planar.cuh",
                        "neural_speed_tpu/ops/matmul.py:127"),
        "qmatmul_planar": ("neural_speed_tpu_torch/csrc/qmatmul_planar.cuh",
                           "neural_speed_tpu/ops/matmul.py:376")}
    for kname, spec, shape_names, ms_list, transform in _int_cases():
        for shape_name in shape_names:
            k, n = _shape(shape_name, spec)
            qt = synth_qtensor(gen, k, n, spec)
            if transform is not None:
                qt = transform(gen, qt)
            letter = {"qmatmul_int": "I", "qmatmul_planar": "P"}[kname]
            if matmul.kernel_for(qt) != letter:
                raise AssertionError(f"{_fmt_name(qt)} routes to "
                                     f"{matmul.kernel_for(qt)!r}, not {letter}")
            w_bf16 = dequantize(qt, torch.bfloat16)
            for m in ms_list:
                x = torch.randn((m, k), generator=gen, device="cuda").to(
                    torch.bfloat16)
                got = matmul.qmatmul(x, qt)
                want = matmul.qmatmul_plain(x, qt)
                torch.cuda.synchronize()
                # as kernels F and P: the same dequantized values in both
                # versions, float32 sums in another order and one bf16
                # rounding of the output -> two bf16 ulps of the largest output
                cmp = compare(got, want, 2, per_row=False)
                ms = time_ms(lambda: matmul.qmatmul(x, qt))
                del got, want
                plain_ms = plain_time_ms(lambda: matmul.qmatmul_plain(x, qt))
                lib_ms = time_ms(lambda: torch.matmul(x, w_bf16))
                nbytes = m * k * 2 + qt.nbytes() + m * n * 2
                dq = "/dq" if qt.sscale is not None else ""
                chk.add(kname, "cuda", *sources[kname],
                        f"{_fmt_name(qt)}{dq} g={spec.group_size} M={m} K={k} "
                        f"N={n}", cmp, ms, plain_ms, lib_ms, nbytes,
                        2.0 * m * n * k,
                        main=(kname == "qmatmul_int" and spec.group_size == 128
                              and spec.bits == 4 and not spec.symmetric
                              and m == 1 and shape_name == "gateup"))
            del qt, w_bf16
            torch.cuda.empty_cache()


# Float32 activations (quantized Whisper's linears): whisper-large-v2's
# (K, N) at the encoder's 1500 frames (GEMM) and at decode (M = 1, 4: GEMV),
# and Llama-2-7B's o projection at M = 2048 beside the bf16 cases.
WHISPER_LINEARS = {"q/k/v/o": (1280, 1280), "fc1": (1280, 5120),
                   "fc2": (5120, 1280)}
F32_ULPS = 256


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (to nearest)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def compare_f64(got: torch.Tensor, ref: torch.Tensor) -> dict:
    """|got - ref| against F32_ULPS float32 ulps (2**-23 relative) of the
    largest |ref| of the tensor, ref a float64 product of the same
    dequantized weight or another float32 one: float32 sums over K <= 5120
    taken in any order stay within a few dozen of them of the exact sum, a
    TF32 product (x and W rounded to 10-bit mantissas) lands thousands away
    (each case checks both)."""
    diff = (got.double() - ref).abs()
    scale = ref.abs().amax()
    tol = F32_ULPS * 2.0 ** -23 * scale
    raw = got.detach().contiguous().view(torch.uint8).cpu().numpy()
    return dict(err=diff.max().item(),
                rel=(diff / scale).max().item(),
                worst=(diff / tol).max().item(),
                digest=hashlib.sha256(raw.tobytes()).hexdigest()[:16],
                tol=f"{F32_ULPS} float32 ulps of the largest |output| of the "
                    "tensor")


def _f32_cases():
    """(counter, letter, spec, pack transform) of the float32 instances:
    F (nf4), P (int5 asymmetric, int3, fp8_e4m3, int4 with float offsets)
    and P's one-plane INT instances (int8 symmetric with float32 scales:
    the AudioModel default; int4 with uint8 zero points; kernel A's pack,
    int4 symmetric with bf16 scales)."""
    from neural_speed_tpu_torch.ops.qtypes import named_qspec

    return [
        ("qmatmul_lut_f32", "F", named_qspec("nf4", 128), None),
        ("qmatmul_planar_f32", "P", named_qspec("int5", 128, False), None),
        ("qmatmul_planar_f32", "P", named_qspec("int3", 128), None),
        ("qmatmul_planar_f32", "P", named_qspec("fp8_e4m3", 128), None),
        ("qmatmul_planar_f32", "P", named_qspec("int4", 128), _float_offsets),
        ("qmatmul_int_f32", "I", named_qspec("int8", 128), None),
        ("qmatmul_int_f32", "I", named_qspec("int4", 128, False), None),
        ("qmatmul_int_f32", "I",
         named_qspec("int4", 128, scale_dtype="bfloat16"), None)]


def check_f32_formats(chk: Checks, gen: torch.Generator) -> None:
    """The float32-activation instances of F, P and P's one-plane INT
    instances through `qmatmul` (the route whisper takes; kernel A's pack
    must route to "I"), against the plain version and a float64 product of
    the same dequantized weight (`compare_f64`), at whisper-large-v2's
    shapes at M = 1, 4 and 1500 (fc1 also at the GEMM's edges, 33 and 100)
    and Llama-2-7B's o at M = 33, 100 and 2048.  The GEMM's bound is the
    3xTF32 rate (`bound`'s "tf32x3"), the GEMV's its bytes.  x is drawn
    so that its low mantissa bits matter (normal draws times 1.37).  Each
    case also checks that a TF32 product of the same operands fails the
    tolerance, that the kernel fed x rounded to bf16 lands more than 10
    tolerances away (a kernel that rounds x would not), that no output is a
    bf16 value, and that only the instance's own counter moved.  The
    library call is `torch.matmul` on the float32 dequantized weight with
    TF32 off."""
    from neural_speed_tpu_torch import _build
    from neural_speed_tpu_torch.ops import matmul
    from neural_speed_tpu_torch.ops.quantize import dequantize
    from neural_speed_tpu_torch.utils.synthetic import synth_qtensor

    sources = {
        "qmatmul_lut_f32": ("neural_speed_tpu_torch/csrc/qmatmul_lut.cu",
                            "neural_speed_tpu/ops/matmul.py:217"),
        "qmatmul_planar_f32": (
            "neural_speed_tpu_torch/csrc/qmatmul_planar.cuh",
            "neural_speed_tpu/ops/matmul.py:376"),
        "qmatmul_int_f32": ("neural_speed_tpu_torch/csrc/qmatmul_planar.cuh",
                            "neural_speed_tpu/ops/matmul.py:127")}
    shapes = [(name, kn, (1, 4, 33, 100, 1500) if name == "fc1" else (1, 4, 1500))
              for name, kn in WHISPER_LINEARS.items()]
    shapes.append(("llama o", SHAPES_7B["o"], (33, 100, 2048)))
    mains = {("qmatmul_lut_f32", "nf4/f32s"),
             ("qmatmul_planar_f32", "int5/asym/f32s"),
             ("qmatmul_int_f32", "int8/f32s")}
    for kname, letter, spec, transform in _f32_cases():
        for shape_name, (k, n), ms_list in shapes:
            qt = synth_qtensor(gen, k, n, spec)
            if transform is not None:
                qt = transform(gen, qt)
            route = matmul.kernel_route(qt, torch.float32)
            if route != letter:
                raise AssertionError(f"{_fmt_name(qt)}: float32 x routes to "
                                     f"{route!r}, not {letter}")
            w32 = dequantize(qt, torch.float32)
            w64 = w32.double()
            w_tf32 = _tf32(w32).double()
            for m in ms_list:
                x = torch.randn((m, k), generator=gen, device="cuda") * 1.37
                before = dict(_build.launches)
                got = matmul.qmatmul(x, qt)
                moved = {c: v - before.get(c, 0)
                         for c, v in _build.launches.items()
                         if v != before.get(c, 0)}
                if moved != {kname: 1} or got.dtype != torch.float32:
                    raise AssertionError(f"{kname} {_fmt_name(qt)} M={m}: "
                                         f"launches {moved}, out {got.dtype}")
                want = matmul.qmatmul_plain(x, qt)
                ref = x.double() @ w64
                rounded = matmul.qmatmul(x.to(torch.bfloat16).float(), qt)
                torch.cuda.synchronize()
                what = f"{_fmt_name(qt)} {shape_name} M={m} K={k} N={n}"
                # the kernel against the plain version (both float32 sums
                # of the same products), and each against the float64 one
                cmp = compare_f64(got, want.double())
                vs64 = {}
                for out, label in ((got, "kernel"), (want, "plain version")):
                    vs64[label] = compare_f64(out, ref)["worst"]
                    if not vs64[label] <= 1.0:
                        raise AssertionError(f"{kname} {what}: the {label} "
                                             f"misses the float64 product")
                tf32 = compare_f64(_tf32(x).double() @ w_tf32, ref)["worst"]
                off = compare_f64(rounded, ref)["worst"]
                in_bf16 = (got.to(torch.bfloat16).float() == got).float(
                ).mean()
                log(f"    {kname} {what}: against the float64 product the "
                    f"kernel at {vs64['kernel']:.3f} tolerances, the plain "
                    f"version at {vs64['plain version']:.3f}, a TF32 product "
                    f"at {tf32:.1f}, the kernel on bf16-rounded x at "
                    f"{off:.1f}; {in_bf16.item():.1%} of outputs bf16 values")
                if not (tf32 > 1.0 and off > 10.0 and in_bf16.item() < 0.5):
                    raise AssertionError(f"{kname} {what}: the check is blind "
                                         f"(TF32 {tf32}, bf16 x {off}, bf16 "
                                         f"values {in_bf16.item()})")
                del got, want, ref, rounded
                ms = time_ms(lambda: matmul.qmatmul(x, qt))
                plain_ms = plain_time_ms(lambda: matmul.qmatmul_plain(x, qt))
                lib_ms = time_ms(lambda: torch.matmul(x, w32))
                nbytes = m * k * 4 + qt.nbytes() + m * n * 4
                chk.add(kname, "cuda", *sources[kname], what, cmp, ms,
                        plain_ms, lib_ms, nbytes, 2.0 * m * n * k,
                        main=((kname, _fmt_name(qt)) in mains and m == 1500
                              and shape_name == "fc1"),
                        peak="tf32x3" if m > matmul.GEMV_MAX_M else "f32",
                        extra=dict(f64_over_tol=vs64["kernel"],
                                   tf32_over_tol=tf32, bf16_x_over_tol=off,
                                   bf16_valued_share=in_bf16.item()))
            del qt, w32, w64, w_tf32
            torch.cuda.empty_cache()


F32_REPEAT_CALLS = 20


def check_f32_repeat(chk: Checks, gen: torch.Generator) -> None:
    """The float32 GEMM's determinism: F32_REPEAT_CALLS calls of whisper's
    fc1 at M = 1500 through each instance (F nf4, P int5 asymmetric, I int8,
    the AudioModel default), each with a cold L2, give the first call's
    bytes (no atomics: each output is written once, its sums in a fixed
    order).  Its own generator, so earlier checks keep their inputs."""
    from neural_speed_tpu_torch.ops import matmul
    from neural_speed_tpu_torch.utils.synthetic import synth_qtensor

    del gen
    rgen = torch.Generator(device="cuda").manual_seed(19)
    k, n = WHISPER_LINEARS["fc1"]
    res = {}
    cases = _f32_cases()
    for kname, _, spec, _ in (cases[0], cases[1], cases[5]):  # nf4, int5, int8
        qt = synth_qtensor(rgen, k, n, spec)
        x = torch.randn((1500, k), generator=rgen, device="cuda") * 1.37
        first = matmul.qmatmul(x, qt)
        differ = 0
        for _ in range(F32_REPEAT_CALLS):
            _flush_l2()
            differ += int(not torch.equal(matmul.qmatmul(x, qt), first))
        res[f"{kname} {_fmt_name(qt)}"] = differ
        del qt, x, first
    log(f"  float32 GEMM repeat (whisper fc1, M=1500, {F32_REPEAT_CALLS} "
        f"calls each): calls that differ from the first {res}")
    chk.notes["f32_repeat"] = res
    if len(res) != 3 or any(res.values()):
        raise AssertionError(f"float32 GEMM repeat: {res}")


def compare_f32(got: torch.Tensor, want: torch.Tensor, groups: int) -> dict:
    """|got - want| against `groups` float32 ulps (2**-23 relative) of the
    largest |want|: the integer partials of kernels G and H are exact, so
    only the order of the float32 sum over the K groups differs, and each of
    its additions rounds by at most half an ulp of a partial sum in either
    version.  With a digest of `got`'s bytes, as `compare`."""
    diff = (got - want).abs()
    scale = want.abs().amax()
    tol = groups * 2.0 ** -23 * scale + ATOL * 1e-3
    raw = got.detach().contiguous().view(torch.uint8).cpu().numpy()
    return dict(err=diff.max().item(),
                rel=(diff / scale.clamp_min(ATOL)).max().item(),
                worst=(diff / tol).max().item(),
                digest=hashlib.sha256(raw.tobytes()).hexdigest()[:16],
                tol=f"{groups} float32 ulps of the largest |output| of the "
                    "tensor")


# Kernels G (int4) and H (int3) at Llama-2-7B's five projections and rows:
# the GEMV's (9, 16, 32: one and two m16 tiles), the bench prefill (1975,
# 2048); the GEMV's and the GEMM's edges (31, 33, 100) at qkv and o.
INT8_M = (9, 16, 32, 1975, 2048)
INT8_EDGE_M = (31, 33, 100)


def _int8_weights(qt) -> torch.Tensor:
    """The pack's int8 weight values code - zero point, [K, N] row-major."""
    from neural_speed_tpu_torch.ops.quantize import unpack_codes

    spec = qt.spec
    k = qt.shape[0]
    g = spec.effective_group(k)
    codes = unpack_codes(qt.data, spec.bits, k).to(torch.int32)
    zero = (spec.code_offset if qt.zeros is None else
            torch.repeat_interleave(qt.zeros.to(torch.int32), g, 0))
    return (codes - zero).to(torch.int8)


def int8_library_ms(xq: torch.Tensor, w_int8: torch.Tensor):
    """The yardstick of kernels G and H: `torch._int_mm(xq, W)` (int32 out,
    no scales) with W row-major ([K, N] contiguous) and column-major (its
    transpose contiguous, transposed back); the faster of the two and its
    layout, or (None, None) where the call refuses the shape (M <= 16,
    ...)."""
    best = (None, None)
    for layout, w in (("row-major", w_int8),
                      ("column-major", w_int8.t().contiguous().t())):
        try:
            torch._int_mm(xq, w)
        except RuntimeError:
            continue
        ms = time_ms(lambda: torch._int_mm(xq, w))
        if best[0] is None or ms < best[0]:
            best = (ms, layout)
        del w
    return best


def check_int8_formats(chk: Checks, gen: torch.Generator) -> None:
    """Kernels G and H against `qmatmul_int8_plain` at the 7B shapes: the
    GEMV (M <= 32) and the GEMM, every width the kernels take (G: int4
    symmetric / asymmetric with bf16 or float32 scales, int8 symmetric; H:
    int2, int3, int5, int6, int7, symmetric and asymmetric), grouped and per
    token.  Float32 out (the bf16 epilogue: `check_int8_epilogue`)."""
    from neural_speed_tpu_torch.ops import matmul
    from neural_speed_tpu_torch.ops.qtypes import named_qspec
    from neural_speed_tpu_torch.utils.synthetic import synth_qtensor

    bf = dict(group_size=128, scale_dtype="bfloat16")
    int4, int3 = named_qspec("int4", **bf), named_qspec("int3", **bf)
    two_m = (32, 2048)
    g_cases = [(int4, name, INT8_M + (INT8_EDGE_M if name in ("qkv", "o")
                                      else ()), False) for name in SHAPES_7B]
    g_cases += [(named_qspec("int4", symmetric=False, **bf), "o", two_m, False),
                (named_qspec("int4", 128), "o", two_m, False),
                (named_qspec("int8", **bf), "o", two_m, False),
                (named_qspec("int8", 128), "qkv", (1975,), False),
                (int4, "o", two_m, True)]
    h_cases = [(int3, name, INT8_M + (INT8_EDGE_M if name in ("qkv", "o")
                                      else ()), False) for name in SHAPES_7B]
    h_cases += [(named_qspec("int5", symmetric=False, **bf), "o", two_m, False),
                (named_qspec("int6", 128), "o", two_m, False),
                (named_qspec("int2", **bf), "o", two_m, False),
                (named_qspec("int2", symmetric=False, **bf), "o", two_m, False),
                (named_qspec("int7", **bf), "o", two_m, False),
                (named_qspec("int7", symmetric=False, **bf), "o", two_m, False),
                (int3, "o", two_m, True)]
    kernels = (
        ("qmatmul_int8", g_cases, "neural_speed_tpu_torch/csrc/qmatmul_int8.cu",
         "neural_speed_tpu/ops/matmul.py:814", int4),
        ("qmatmul_int8_planar", h_cases,
         "neural_speed_tpu_torch/csrc/qmatmul_int8_planar.cu",
         "neural_speed_tpu/ops/matmul.py:880", int3))
    for kname, cases, source, replaces, main_spec in kernels:
        for spec, shape_name, ms_list, per_token in cases:
            k, n = _shape(shape_name, spec)
            qt = synth_qtensor(gen, k, n, spec)
            w_int8 = _int8_weights(qt)
            for m in ms_list:
                x = torch.randn((m, k), generator=gen, device="cuda")
                xq, ascale = matmul._act_quant(x, k if per_token else 128)
                if per_token:
                    ascale = None
                got = matmul.qmatmul_int8_cuda(xq, ascale, qt)
                want = matmul.qmatmul_int8_plain(xq, ascale, qt)
                torch.cuda.synchronize()
                cmp = compare_f32(got, want, k // 128)
                del got, want
                ms = time_ms(lambda: matmul.qmatmul_int8_cuda(xq, ascale, qt))
                plain_ms = plain_time_ms(
                    lambda: matmul.qmatmul_int8_plain(xq, ascale, qt))
                lib_ms, layout = int8_library_ms(xq, w_int8)
                nbytes = (m * k + (0 if per_token else m * (k // 128) * 4)
                          + qt.nbytes() + m * n * 4)
                chk.add(kname, "cuda", source, replaces,
                        f"{_fmt_name(qt)}{' per-token' if per_token else ''} "
                        f"M={m} K={k} N={n}", cmp, ms, plain_ms, lib_ms,
                        nbytes, 2.0 * m * n * k, peak="int8",
                        main=(spec is main_spec and m == 2048
                              and shape_name == "gateup" and not per_token),
                        extra=dict(library_layout=layout))
            del qt, w_int8
            torch.cuda.empty_cache()


INT8_EPILOGUE_SEED = 19
INT8_ROWS_SEED = 18


def check_int8_epilogue(chk: Checks, gen: torch.Generator) -> None:
    """The model path's calls of kernels G and H (`qmatmul_int8` from
    `linear`): bf16 written once by the kernel, grouped (`comp="int8"`: the
    plain version's float32 output rounded to bf16) and per token
    (`comp="int8t"`: the float32 output times the per-token scale, then
    rounded), at o and gate/up, M = 32 and 2048, int4 and int3; 2 bf16 ulps
    (one rounding each side after float32 sums in another order).  Drawn
    from a generator of its own (INT8_EPILOGUE_SEED)."""
    from neural_speed_tpu_torch.ops import matmul
    from neural_speed_tpu_torch.ops.qtypes import named_qspec
    from neural_speed_tpu_torch.utils.synthetic import synth_qtensor

    gen = torch.Generator(device="cuda").manual_seed(INT8_EPILOGUE_SEED)
    bf = dict(group_size=128, scale_dtype="bfloat16")
    for kname, fmt in (("qmatmul_int8", "int4"), ("qmatmul_int8_planar", "int3")):
        spec = named_qspec(fmt, **bf)
        for shape_name in ("o", "gateup"):
            k, n = _shape(shape_name, spec)
            qt = synth_qtensor(gen, k, n, spec)
            for m in (32, 2048):
                x = torch.randn((m, k), generator=gen, device="cuda")
                for per_token in (False, True):
                    xq, ascale = matmul._act_quant(x, k if per_token else 128)
                    grouped = None if per_token else ascale
                    rs = ascale if per_token else None
                    got = matmul.qmatmul_int8_cuda(xq, grouped, qt,
                                                   torch.bfloat16, rs)
                    want = matmul.qmatmul_int8_plain(xq, grouped, qt)
                    if per_token:
                        want = want * ascale
                    want = want.to(torch.bfloat16)
                    torch.cuda.synchronize()
                    cmp = compare(got, want, 2, per_row=False)
                    del got, want
                    ms = time_ms(lambda: matmul.qmatmul_int8_cuda(
                        xq, grouped, qt, torch.bfloat16, rs))
                    plain_ms = plain_time_ms(lambda: matmul.qmatmul_int8_plain(
                        xq, grouped, qt))
                    chk.add(kname, "cuda",
                            f"neural_speed_tpu_torch/csrc/{kname}.cu",
                            "neural_speed_tpu/ops/matmul.py:"
                            + ("814" if kname == "qmatmul_int8" else "880"),
                            f"bf16 out {fmt}{' per-token' if per_token else ''}"
                            f" M={m} K={k} N={n}", cmp, ms, plain_ms,
                            None, m * k + qt.nbytes() + m * n * 2,
                            2.0 * m * n * k, peak="int8")
            del qt
            torch.cuda.empty_cache()


def check_int8_rows(chk: Checks, gen: torch.Generator) -> None:
    """Kernels G and H are deterministic and each row's output depends on
    that row only (as `check_gemm_rows` holds kernel A): GEMM_ROWS_CALLS
    calls on the same rows, each after an L2 flush, give one digest at 8192
    and 1975 rows (the GEMM) and at 32 (the GEMV and its cluster
    reduction), and the first 1975 rows of an 8192-row call equal the
    1975-row call's.  int4 and int3 at the five Llama-2-7B shapes.  Drawn
    from a generator of its own (INT8_ROWS_SEED)."""
    from neural_speed_tpu_torch.ops import matmul
    from neural_speed_tpu_torch.ops.qtypes import named_qspec
    from neural_speed_tpu_torch.utils.synthetic import synth_qtensor

    gen = torch.Generator(device="cuda").manual_seed(INT8_ROWS_SEED)
    bf = dict(group_size=128, scale_dtype="bfloat16")
    for kname, fmt in (("qmatmul_int8", "int4"), ("qmatmul_int8_planar", "int3")):
        spec = named_qspec(fmt, **bf)
        for shape_name in SHAPES_7B:
            k, n = _shape(shape_name, spec)
            qt = synth_qtensor(gen, k, n, spec)
            x = torch.randn((8192, k), generator=gen, device="cuda")
            xq, ascale = matmul._act_quant(x, 128)
            del x
            firsts = {}
            for m in (8192, 1975, 32):
                xm, am = xq[:m].contiguous(), ascale[:m].contiguous()
                first = matmul.qmatmul_int8_cuda(xm, am, qt)
                bad_calls = 0
                for _ in range(GEMM_ROWS_CALLS):
                    _flush_l2()
                    bad = (matmul.qmatmul_int8_cuda(xm, am, qt) != first).nonzero()
                    if bad.numel():
                        bad_calls += 1
                        log(f"  {kname} rows M={m} K={k} N={n}: a call "
                            f"differs at {bad.shape[0]} outputs, first "
                            f"{bad[0].tolist()}")
                if bad_calls:
                    raise AssertionError(
                        f"{kname} M={m} K={k} N={n}: {bad_calls} of "
                        f"{GEMM_ROWS_CALLS} calls on the same rows differ")
                firsts[m] = first
            bad = (firsts[1975] != firsts[8192][:1975]).nonzero()
            if bad.numel():
                raise AssertionError(
                    f"{kname} K={k} N={n}: rows 0..1974 alone differ from the "
                    f"same rows of an 8192-row call at {bad.shape[0]} outputs, "
                    f"first {bad[0].tolist()}")
            log(f"  {kname} rows {fmt} K={k} N={n}: {GEMM_ROWS_CALLS} calls "
                f"each at 8192, 1975 and 32 rows, after L2 flushes, "
                f"bit-equal; rows 0..1974 the same at 8192 and 1975")
            del qt, xq, ascale, firsts, xm, am, first
            torch.cuda.empty_cache()


def check_ragged_shapes(chk: Checks, gen: torch.Generator) -> None:
    """Kernels F, P (and its one-plane INT instances), G, H at shapes off
    the tiles: N = 264 (a multiple of 8 only), g = 64, M = 5 and M = 37 (a
    partial row tile), K the pack period x g; and groups of 128 that
    straddle the bands of the pack.  Correctness only: these are not
    main-path shapes, so nothing is timed and nothing enters the kernels
    line."""
    from neural_speed_tpu_torch.ops import matmul
    from neural_speed_tpu_torch.ops.qtypes import named_qspec
    from neural_speed_tpu_torch.utils.synthetic import synth_qtensor

    n, worst = 264, {}
    for name, sym in (("nf4", True), ("int3", False), ("int6", True),
                      ("int7", False), ("fp8_e4m3", True), ("int4", True),
                      ("int8", True), ("int2", False), ("int1", True),
                      ("int8", False), ("int4", False)):
        spec = named_qspec(name, 64, sym)
        k = 3 * matmul.kernel_k_multiple(spec) * 64
        qt = synth_qtensor(gen, k, n, spec)
        for m in (5, 37):
            x = torch.randn((m, k), generator=gen, device="cuda")
            if matmul.kernel_for(qt):
                xb = x.to(torch.bfloat16)
                cmp = compare(matmul.qmatmul(xb, qt),
                              matmul.qmatmul_plain(xb, qt), 2, per_row=False)
                worst[f"{name}{'' if sym else '/asym'} M={m}"] = cmp["worst"]
            if matmul.int8_kernel_for(qt):
                xq, ascale = matmul._act_quant(x, 64)
                cmp = compare_f32(matmul.qmatmul_int8_cuda(xq, ascale, qt),
                                  matmul.qmatmul_int8_plain(xq, ascale, qt),
                                  k // 64)
                worst[f"{name}{'' if sym else '/asym'} int8 M={m}"] = \
                    cmp["worst"]
    torch.cuda.synchronize()
    # groups that straddle a band of the pack (K = 11008 before the load-time
    # repad: 1376 word rows per band at 8 bands, 344 at 32, against g = 128)
    for name, sym in (("int4", False), ("nf4", True), ("int5", True),
                      ("int1", True)):
        spec = named_qspec(name, 128, sym)
        k = 11008 if name != "int1" else 11264
        qt = synth_qtensor(gen, k, n, spec)
        xb = torch.randn((5, k), generator=gen, device="cuda").to(
            torch.bfloat16)
        cmp = compare(matmul.qmatmul(xb, qt), matmul.qmatmul_plain(xb, qt), 2,
                      per_row=False)
        worst[f"{name}{'' if sym else '/asym'} g=128 K={k} M=5"] = cmp["worst"]
    torch.cuda.synchronize()
    log("  ragged shapes (N=264, g=64; straddling groups), largest error / "
        "tolerance: "
        + json.dumps({k: round(v, 3) for k, v in worst.items()}))
    bad = {k: v for k, v in worst.items() if not v <= 1.0}
    if bad:
        raise AssertionError(f"ragged shapes beyond the tolerance: {bad}")


def compare_rows(got: torch.Tensor, want: torch.Tensor, rel: float) -> dict:
    """|got - want| against `rel` times the largest |want| of the element's
    row (float32 outputs whose versions sum exact products in another
    order)."""
    diff = (got.float() - want.float()).abs()
    scale = want.float().abs().amax(-1, keepdim=True)
    tol = rel * scale + ATOL
    return dict(err=diff.max().item(),
                rel=(diff / scale.clamp_min(ATOL)).max().item(),
                worst=(diff / tol).max().item(),
                tol=f"{rel:.3g} of the largest |output| of its row")


# Mixtral-8x7B's expert projections (K, N): gate and up, down.
MOE_SHAPES = {"gate/up": (4096, 14336), "down": (14336, 4096)}
# Grok-1's down projection (hpcai-tech/grok-1: intermediate 32768, hidden
# 6144), whose K sends the JAX package's rule to bm = 64; the card routes
# it at bm = 128 (`moe.choose_bm`).
GROK_DOWN = {"grok-1 down": (32768, 6144)}
GROK_ROUTES = [("uniform", 2048, 64), ("uniform", 2048, 128)]
N_EXPERTS, TOP_K = 8, 2


def _route_eids(kind: str, gen: torch.Generator, n_tok: int) -> torch.Tensor:
    """Router picks (token-major, each token's two experts distinct):
    uniform, every token on expert 3 (its second pick elsewhere), or
    expert 5 empty."""
    dev = gen.device
    if kind == "one expert":
        other = torch.randint(0, N_EXPERTS - 1, (n_tok,), generator=gen,
                              device=dev)
        second = (3 + 1 + other) % N_EXPERTS
        return torch.stack([torch.full_like(second, 3), second], 1).reshape(-1)
    pool = N_EXPERTS - (kind == "one empty")
    picks = torch.rand((n_tok, pool), generator=gen, device=dev).argsort(
        -1)[:, :TOP_K]
    if kind == "one empty":
        picks = picks + (picks >= 5).long()
    return picks.reshape(-1)


GROUPED_ROUTES = [("uniform", 2048, 128), ("one expert", 2048, 128),
                  ("one empty", 2048, 128), ("uniform", 4, 128),
                  ("uniform", 2048, 64)]


def _check_stack(chk: Checks, gen: torch.Generator, kname: str, source: str,
                 spec, routes, gemm, gemv, main: bool,
                 projs=tuple(MOE_SHAPES)) -> None:
    """One grouped kernel on one stack format at Mixtral's expert shapes:
    the GEMM (`gemm`) over `routes` (kind, tokens, bm) and the 2-row GEMV
    (`gemv`), each against its plain version.  Outputs are float32 sums of
    exact products in another order: within 2**-12 of the row's largest
    |output|.  Library yardstick: a loop of torch.matmul over the experts'
    segments on bf16 weights dequantized beforehand."""
    from neural_speed_tpu_torch.ops import moe
    from neural_speed_tpu_torch.ops.quantize import dequantize
    from neural_speed_tpu_torch.utils.synthetic import synth_stacked

    rel = 2.0 ** -12
    for proj in projs:
        k, n = {**MOE_SHAPES, **GROK_DOWN}[proj]
        st = synth_stacked(gen, N_EXPERTS, k, n, spec)
        fmt = _fmt_name(st.expert(0))
        w_bf16 = [dequantize(st.expert(e), torch.bfloat16)
                  for e in range(N_EXPERTS)]
        expert_bytes = st.nbytes() // N_EXPERTS
        for kind, n_tok, bm in routes:
            eid = _route_eids(kind, gen, n_tok)
            r = moe.route_tokens(eid, N_EXPERTS, TOP_K, bm)
            x = torch.randn((n_tok, k), generator=gen, device="cuda").to(
                torch.bfloat16)
            xs = torch.cat([x, x.new_zeros((1, k))]).index_select(0, r.src)
            run = lambda: gemm(xs, st, r.block_expert, bm, r.block_rows)
            got = run()
            want = moe.grouped_qmatmul_plain(xs, st, r.block_expert, bm)
            torch.cuda.synchronize()
            cmp = compare_rows(got, want, rel)
            del got, want
            counts = torch.bincount(eid, minlength=N_EXPERTS).tolist()
            seg, off = [], 0
            for e, c in enumerate(counts):
                seg.append((off, c, e))
                off += -(-c // bm) * bm
            lib = lambda: [torch.matmul(xs[o:o + c], w_bf16[e])
                           for o, c, e in seg if c]
            ms = time_ms(run)
            plain_ms = plain_time_ms(lambda: moe.grouped_qmatmul_plain(
                xs, st, r.block_expert, bm))
            lib_ms = time_ms(lib)
            rows = n_tok * TOP_K
            touched = sum(1 for c in counts if c)
            nbytes = (touched * expert_bytes + rows * k * 2
                      + xs.shape[0] * n * 4)
            chk.add(kname, "cuda", source, "neural_speed_tpu/ops/moe.py:304",
                    f"GEMM {fmt} g={spec.group_size} {proj} {kind} {n_tok} "
                    f"tokens x top-2 bm={bm} M_pad={xs.shape[0]} K={k} N={n}",
                    cmp, ms, plain_ms, lib_ms, nbytes, 2.0 * rows * n * k,
                    main=main and (proj, kind, n_tok, bm) == (
                        "gate/up", "uniform", 2048, 128))
            del xs, r
        # the single-token decode: two rows, an expert each
        x2 = torch.randn((1, k), generator=gen, device="cuda").to(
            torch.bfloat16).expand(TOP_K, k).contiguous()
        row_e = torch.tensor([6, 1], dtype=torch.int32, device="cuda")
        run = lambda: gemv(x2, st, row_e)
        got = run()
        want = moe.grouped_qmatmul_rows_plain(x2, st, row_e)
        torch.cuda.synchronize()
        cmp = compare_rows(got, want, rel)
        ms = time_ms(run)
        plain_ms = plain_time_ms(lambda: moe.grouped_qmatmul_rows_plain(
            x2, st, row_e))
        lib_ms = time_ms(lambda: [torch.matmul(x2[j:j + 1], w_bf16[e])
                                  for j, e in enumerate((6, 1))])
        nbytes = TOP_K * (expert_bytes + k * 2 + n * 4)
        chk.add(kname, "cuda", source, "neural_speed_tpu/ops/moe.py:304",
                f"GEMV {fmt} g={spec.group_size} {proj} 2 rows, experts 6 "
                f"and 1, K={k} N={n}", cmp, ms, plain_ms, lib_ms, nbytes,
                2.0 * TOP_K * n * k)
        del st, w_bf16
        torch.cuda.empty_cache()


def check_grouped(chk: Checks, gen: torch.Generator) -> None:
    """Kernel 11 against its plain versions at Mixtral-8x7B's expert shapes
    (E = 8, int4 g128, bf16 scales): the GEMM over the routes of 2048
    tokens x top-2 (uniform, one expert taking every token, one expert
    empty: padding blocks and empty segments), of a B = 4 decode step
    (8 rows in 9 blocks of 128, mostly padding) and of 2048 tokens at
    bm = 64; the GEMV over 2 rows, an expert each (the single-token
    decode); then Grok-1's down projection (K = 32768) over 2048 tokens at
    bm = 64 and 128, and its GEMV."""
    from neural_speed_tpu_torch.ops import moe
    from neural_speed_tpu_torch.ops.qtypes import named_qspec

    spec = named_qspec("int4", 128, scale_dtype="bfloat16")
    for routes, projs in ((GROUPED_ROUTES, tuple(MOE_SHAPES)),
                          (GROK_ROUTES, tuple(GROK_DOWN))):
        _check_stack(chk, gen, "qmatmul_grouped",
                     "neural_speed_tpu_torch/csrc/qmatmul_grouped.cu", spec,
                     routes, moe.grouped_qmatmul_cuda,
                     moe.grouped_qmatmul_rows_cuda, main=True, projs=projs)


def check_grouped_fp(chk: Checks, gen: torch.Generator) -> None:
    """The grouped instances of kernels F and P against their plain
    versions at Mixtral-8x7B's expert shapes, over kernel 11's routes: the
    stacks of a GGUF Q4_0 Mixtral (int4 symmetric, float32 scales, g = 32),
    int4 asymmetric with float32 scales, int8 and nf4 over every route;
    int1 and int2 over the uniform route (gate/up).  Tolerance as kernel
    11's."""
    from neural_speed_tpu_torch.ops import moe
    from neural_speed_tpu_torch.ops.qtypes import named_qspec

    bf = dict(scale_dtype="bfloat16")
    both, uniform = tuple(MOE_SHAPES), GROUPED_ROUTES[:1]
    stacks = [(named_qspec("int4", 32), GROUPED_ROUTES, True, both),
              (named_qspec("int4", 128, False), GROUPED_ROUTES, False, both),
              (named_qspec("int8", 128, **bf), GROUPED_ROUTES, False, both),
              (named_qspec("nf4", 128, **bf), GROUPED_ROUTES, False, both),
              (named_qspec("int2", 128, **bf), uniform, False, ("gate/up",)),
              (named_qspec("int1", 128, **bf), uniform, False, ("gate/up",))]
    for spec, routes, main, projs in stacks:
        _check_stack(chk, gen, "qmatmul_grouped_fp",
                     "neural_speed_tpu_torch/csrc/qmatmul_grouped_fp.cuh",
                     spec, routes, moe.grouped_qmatmul_fp_cuda,
                     moe.grouped_qmatmul_rows_fp_cuda, main, projs)


def _random_cache(gen, layers, b, hkv, s, d, bf16=False):
    """Random int8 codes and bf16 scales, or with `bf16` random bf16 K/V
    (a normal draw, |x| ~ 1) and no scales."""
    from neural_speed_tpu_torch.ops.kv_cache import KVCache

    lengths = torch.zeros((b,), dtype=torch.int32, device="cuda")
    if bf16:
        rows = lambda: torch.randn((layers, b, hkv, s, d), generator=gen,
                                   device="cuda").to(torch.bfloat16)
        return KVCache(rows(), rows(), None, None, lengths)
    codes = lambda: torch.randint(-127, 128, (layers, b, hkv, s, d),
                                  generator=gen, device="cuda",
                                  dtype=torch.int8)
    scales = lambda: ((torch.rand((layers, b, hkv, s), generator=gen,
                                  device="cuda") + 0.5) * 0.02
                      ).to(torch.bfloat16)
    return KVCache(codes(), codes(), scales(), scales(), lengths)


def _clone(c):
    import dataclasses

    return dataclasses.replace(c, **{n: getattr(c, n).clone() for n in (
        "k", "v", "k_scale", "v_scale", "lengths")
        if getattr(c, n) is not None})


def _dequant_layer(c, layer):
    if c.k_scale is None:
        return c.k[layer], c.v[layer]
    k = (c.k[layer].float() * c.k_scale[layer].float()[..., None])
    v = (c.v[layer].float() * c.v_scale[layer].float()[..., None])
    return k.to(torch.bfloat16), v.to(torch.bfloat16)


# KV heads of the attention checks: Llama-2-7B's 32 (n_rep = 1) and
# Mixtral-8x7B's 8 (n_rep = 4), under 32 query heads.
KV_HEADS = (32, 8)


def check_flash_decode(chk: Checks, gen: torch.Generator) -> None:
    for hkv in KV_HEADS:
        _check_flash_decode(chk, gen, hkv)


def _check_flash_decode(chk: Checks, gen: torch.Generator, hkv: int) -> None:
    from neural_speed_tpu_torch.ops import flash

    b, h, d, s, layer = 4, 32, 128, 2048, 1
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
    ms = time_ms(lambda: flash.decode_cuda(*args(ck)), reps=DECODE_REPS)
    plain_ms = plain_time_ms(lambda: flash.decode_plain(*args(cp)))
    kd, vd = _dequant_layer(cache, layer)
    live = torch.arange(s, device="cuda")[None] < torch.where(
        pos == kv_lens - 1, kv_lens - 1, kv_lens)[:, None]
    mask = live[:, None, None, :]
    qs = q.transpose(1, 2)
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, kd, vd, attn_mask=mask, enable_gqa=hkv != h))
    cols = live.sum().item()
    nbytes = (cols * hkv * (2 * d + 4) + 2 * b * h * d * 2
              + 2 * b * hkv * d * 2 + 3 * hkv * (2 * d + 4))
    chk.add("flash_decode", "cuda",
            "neural_speed_tpu_torch/csrc/flash_decode.cuh",
            "neural_speed_tpu/ops/flash.py:267",
            f"B={b} H={h} Hkv={hkv} S={s} kv_len=1976/1500/37/900(spectator)",
            cmp, ms, plain_ms, lib_ms, nbytes, 4.0 * cols * h * d,
            main=hkv == 32)


def _library_ms(qs, kd, vd, mask, gqa: bool, lens, scale: float):
    """SDPA's time over the same bf16 K/V: with the boolean mask (which
    keeps PyTorch off its flash backend) and, at B = 1, with `is_causal`
    over the slot's real rows (prompt rows 0..n-1 over columns 0..n-1: the
    same function on every real row).  Returns the faster and a record of
    both, with the faster one's name."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    masked = time_ms(lambda: sdpa(qs, kd, vd, attn_mask=mask, scale=scale,
                                  enable_gqa=gqa))
    rec = dict(library_masked_ms=masked, library_causal_ms=None,
               library_call="sdpa attn_mask")
    if len(lens) == 1:
        n = lens[0]
        causal = time_ms(lambda: sdpa(
            qs[:, :, :n], kd[:, :, :n], vd[:, :, :n], is_causal=True,
            scale=scale, enable_gqa=gqa))
        rec["library_causal_ms"] = causal
        if causal < masked:
            rec["library_call"] = f"sdpa is_causal over {n} rows"
    log(f"  library: SDPA with the mask {masked:.4f} ms, is_causal "
        + ("n/a" if rec["library_causal_ms"] is None
           else f"{rec['library_causal_ms']:.4f} ms"))
    return min(v for v in (masked, rec["library_causal_ms"]) if v is not None
               ), rec


def check_flash_prefill(chk: Checks, gen: torch.Generator) -> None:
    from neural_speed_tpu_torch.ops import flash

    t, h, d, s, layer = 2048, 32, 128, 2048, 0
    scale = 1.0 / math.sqrt(d)
    # the main path's two prefills at the 2048 bucket: the ragged batch of
    # four, and the bench shape (its headline case); padding rows sit on
    # the trash position s - 1
    for lens, hkv in ((lens, hkv) for hkv in KV_HEADS
                      for lens in ([1975, 900, 300, 37], [1975])):
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
        plain_ms = plain_time_ms(lambda: flash.prefill_plain(*args))
        kd, vd = _dequant_layer(cache, layer)
        col = torch.arange(s, device="cuda")
        mask = ((col[None, None] < kv_lens[:, None, None])
                & (col[None, None] <= pos[:, :, None]))          # [B, T, S]
        qs = q.transpose(1, 2)
        lib_ms, lib = _library_ms(qs, kd, vd, mask[:, None], hkv != h, lens,
                                  scale)
        pairs = mask.sum().item()
        nbytes = 2 * b * t * h * d * 2 + sum(lens) * hkv * (2 * d + 4)
        chk.add("flash_prefill", "cuda",
                "neural_speed_tpu_torch/csrc/flash_prefill.cuh",
                "neural_speed_tpu/ops/flash.py:142",
                f"B={b} T={t} (real rows {'/'.join(map(str, lens))}) H={h} "
                f"Hkv={hkv} S={s}", cmp, ms, plain_ms, lib_ms, nbytes,
                4.0 * pairs * h * d, main=b == 1 and hkv == 32, extra=lib)
        del cache, q, kd, vd, mask
        torch.cuda.empty_cache()


KV_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _random_pool(gen, layers, b, hkv, s, d, ps, kv="int8"):
    """A page pool of random codes and bf16 scales (`kv` "int8"; float32
    scales with "int8f32"; or, with "bf16" / "f32", random bf16 / float32
    rows, a normal draw) for `b` slots of `s` rows, with a shuffled table:
    a random permutation of every page but the trash page (the last), so a
    fault in the page indexing cannot hide behind an identity-like
    table."""
    from neural_speed_tpu_torch.ops.paged_kv import PagedKVCache

    nb = s // ps
    n_pages = b * nb + 1
    shape = (layers, hkv, n_pages, ps, d)
    tables = torch.randperm(n_pages - 1, generator=gen, device="cuda")
    tables = tables.reshape(b, nb).to(torch.int32)
    lengths = torch.zeros((b,), dtype=torch.int32, device="cuda")
    if kv in KV_DTYPES:
        rows = lambda: torch.randn(shape, generator=gen, device="cuda").to(
            KV_DTYPES[kv])
        return PagedKVCache(rows(), rows(), None, None, tables, lengths)
    codes = lambda: torch.randint(-127, 128, shape, generator=gen,
                                  device="cuda", dtype=torch.int8)
    sdt = torch.float32 if kv == "int8f32" else torch.bfloat16
    scales = lambda: ((torch.rand((layers, hkv, n_pages, 1, ps),
                                  generator=gen, device="cuda") + 0.5) * 0.02
                      ).to(sdt)
    return PagedKVCache(codes(), codes(), scales(), scales(), tables,
                        lengths)


def _clone_pool(c):
    import dataclasses

    return dataclasses.replace(c, **{n: getattr(c, n).clone() for n in (
        "k_pages", "v_pages", "k_scale", "v_scale")
        if getattr(c, n) is not None})


def _gathered(pool, layer):
    """The layer in the contiguous cache's layout, as layer 0 of a stacked
    cache: rows [1, B, H, S, D], scales [1, B, H, S] (None for bf16)."""
    from neural_speed_tpu_torch.ops.paged_kv import gather_layer_codes

    return [None if a is None else a[None].contiguous()
            for a in gather_layer_codes(
                pool.k_pages, pool.v_pages, pool.k_scale, pool.v_scale,
                pool.page_tables, layer)]


def check_flash_decode_paged(chk: Checks, gen: torch.Generator) -> None:
    """The paged decode kernel at kernel B's shapes over a shuffled pool,
    at page size 128 (the main path's) and 16."""
    from neural_speed_tpu_torch.ops import flash
    from neural_speed_tpu_torch.ops.paged_kv import gathered_layer

    b, h, d, s, layer = 4, 32, 128, 2048, 1
    kv_lens = torch.tensor([1976, 1500, 37, 900], dtype=torch.int32,
                           device="cuda")
    pos = torch.tensor([1975, 1499, 36, s - 1], dtype=torch.int32,
                       device="cuda")
    scale = 1.0 / math.sqrt(d)
    # Mixtral's 8 KV heads at the main path's page size only
    for ps, hkv in ((128, 32), (16, 32), (128, 8)):
        q = (torch.randn((b, 1, h, d), generator=gen, device="cuda")
             ).to(torch.bfloat16)
        kn, vn = ((torch.randn((b, 1, hkv, d), generator=gen, device="cuda")
                   ).to(torch.bfloat16) for _ in range(2))
        pool = _random_pool(gen, 2, b, hkv, s, d, ps)
        ck = _gathered(pool, layer)
        pk, pp = _clone_pool(pool), _clone_pool(pool)
        args = lambda c, fused=True: (
            q, kn, vn, c.k_pages, c.v_pages, c.k_scale, c.v_scale,
            c.page_tables, layer, pos, kv_lens, scale, fused, torch.bfloat16)
        # the contiguous kernel over the gathered layer, no append: the
        # paged kernel must give its outputs bit for bit
        same = torch.equal(
            flash.decode_paged_cuda(*args(pool, False)),
            flash.decode_cuda(q, kn, vn, *ck, 0, pos, kv_lens, scale, False,
                              torch.bfloat16))
        got = flash.decode_paged_cuda(*args(pk))
        want = flash.decode_paged_plain(*args(pp))
        torch.cuda.synchronize()
        # as kernel B: within 4 bf16 ulps of the largest output of the row
        cmp = compare(got, want, 4, per_row=True)
        if not cmp["worst"] <= 1.0:
            raise AssertionError(f"flash_decode_paged (page size {ps}): "
                                 f"error beyond the tolerance ({cmp})")
        if not same:
            raise AssertionError(f"flash_decode_paged (page size {ps}) "
                                 "differs from kernel B over the same rows")
        n = pool.n_pages - 1                    # every page but the trash
        for name in ("k_pages", "v_pages", "k_scale", "v_scale"):
            a, c = getattr(pk, name)[:, :, :n], getattr(pp, name)[:, :, :n]
            if not torch.equal(a, c):
                bad = (a != c).nonzero()
                raise AssertionError(
                    f"flash_decode_paged (page size {ps}): pool {name} "
                    f"differs from the plain version at {bad.shape[0]} "
                    f"places, first {bad[:4].tolist()}")
        changed = (pk.k_pages != pool.k_pages).any(-1).sum().item()
        if changed != 3 * hkv:                  # one row per live slot, head
            raise AssertionError(f"flash_decode_paged (page size {ps}) "
                                 f"changed {changed} K rows, not {3 * hkv}")
        ms = time_ms(lambda: flash.decode_paged_cuda(*args(pk)),
                     reps=DECODE_REPS)
        plain_ms = plain_time_ms(lambda: flash.decode_paged_plain(*args(pp)))
        kd, vd = gathered_layer(pool, layer)
        live = torch.arange(s, device="cuda")[None] < torch.where(
            pos == kv_lens - 1, kv_lens - 1, kv_lens)[:, None]
        qs = q.transpose(1, 2)
        lib_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qs, kd, vd, attn_mask=live[:, None, None, :],
                enable_gqa=hkv != h))
        cols = live.sum().item()
        nbytes = (cols * hkv * (2 * d + 4) + pool.page_tables.numel() * 4
                  + 2 * b * h * d * 2 + 2 * b * hkv * d * 2
                  + 3 * hkv * (2 * d + 4))
        chk.add("flash_decode_paged", "cuda",
                "neural_speed_tpu_torch/csrc/flash_decode.cuh",
                "neural_speed_tpu/ops/flash.py:1196",
                f"B={b} H={h} Hkv={hkv} S={s} page size {ps}, shuffled "
                f"table, kv_len=1976/1500/37/900(spectator)", cmp, ms,
                plain_ms, lib_ms, nbytes, 4.0 * cols * h * d,
                main=ps == 128 and hkv == 32)
        del pool, pk, pp, ck, kd, vd
        torch.cuda.empty_cache()


def check_flash_prefill_paged(chk: Checks, gen: torch.Generator) -> None:
    """The paged prefill kernel at kernel C's shapes over a shuffled pool:
    the ragged batch and the bench shape at page size 128, the bench shape
    at 16."""
    from neural_speed_tpu_torch.ops import flash
    from neural_speed_tpu_torch.ops.paged_kv import gathered_layer

    t, h, d, layer = 2048, 32, 128, 0
    scale = 1.0 / math.sqrt(d)
    for lens, ps, hkv in (([1975, 900, 300, 37], 128, 32), ([1975], 128, 32),
                          ([1975], 16, 32), ([1975, 900, 300, 37], 128, 8),
                          ([1975], 128, 8), ([1975], 48, 32)):
        b = len(lens)
        # a whole number of pages that the contiguous kernel can also read
        # (S a multiple of 64): 2112 = 44 pages of 48
        s = 2048 if ps != 48 else 2112
        pool = _random_pool(gen, 1, b, hkv, s, d, ps)
        kv_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
        ar = torch.arange(t, device="cuda", dtype=torch.int32)[None]
        pos = torch.where(ar < kv_lens[:, None], ar,
                          torch.full_like(ar, s - 1))
        q = (torch.randn((b, t, h, d), generator=gen, device="cuda")
             ).to(torch.bfloat16)
        args = (q, pool.k_pages, pool.v_pages, pool.k_scale, pool.v_scale,
                pool.page_tables, layer, pos, kv_lens, scale, torch.bfloat16)
        got = flash.prefill_paged_cuda(*args)
        same = torch.equal(got, flash.prefill_cuda(
            q, *_gathered(pool, layer), 0, pos, kv_lens, scale,
            torch.bfloat16))
        want = flash.prefill_paged_plain(*args)
        torch.cuda.synchronize()
        # as kernel C: within 4 bf16 ulps of the largest output of the row
        cmp = compare(got, want, 4, per_row=True)
        if not cmp["worst"] <= 1.0:
            raise AssertionError(f"flash_prefill_paged (page size {ps}): "
                                 f"error beyond the tolerance ({cmp})")
        if not same:
            raise AssertionError(f"flash_prefill_paged (page size {ps}) "
                                 "differs from kernel C over the same rows")
        del got, want
        torch.cuda.empty_cache()
        ms = time_ms(lambda: flash.prefill_paged_cuda(*args))
        plain_ms = plain_time_ms(lambda: flash.prefill_paged_plain(*args))
        kd, vd = gathered_layer(pool, layer)
        col = torch.arange(s, device="cuda")
        mask = ((col[None, None] < kv_lens[:, None, None])
                & (col[None, None] <= pos[:, :, None]))          # [B, T, S]
        qs = q.transpose(1, 2)
        lib_ms, lib = _library_ms(qs, kd, vd, mask[:, None], hkv != h, lens,
                                  scale)
        pairs = mask.sum().item()
        nbytes = (2 * b * t * h * d * 2 + sum(lens) * hkv * (2 * d + 4)
                  + pool.page_tables.numel() * 4)
        chk.add("flash_prefill_paged", "cuda",
                "neural_speed_tpu_torch/csrc/flash_prefill.cuh",
                "neural_speed_tpu/ops/flash.py:1111",
                f"B={b} T={t} (real rows {'/'.join(map(str, lens))}) H={h} "
                f"Hkv={hkv} S={s} page size {ps}, shuffled table", cmp, ms,
                plain_ms, lib_ms, nbytes, 4.0 * pairs * h * d,
                main=b == 1 and ps == 128 and hkv == 32, extra=lib)
        del pool, q, kd, vd, mask
        torch.cuda.empty_cache()


# The attention variants of slice 7, each on a contiguous kernel and its
# paged twin: bf16 K/V (the JAX package's default cache) and ALiBi slopes.
# Head counts: MPT-7B's and BLOOM-7B1's 32 (power-of-two slopes),
# Baichuan-13B's 40 (the non-power-of-two branch), and Falcon-7B's 71 query
# heads over one KV head at D = 64, whose decode goes to kernel C.
# (kernel, K/V, ALiBi, H, Hkv, D, T, kv_lens, main)
DECODE_LENS = [1976, 1500, 37, 900]
VARIANT_CASES = [
    ("decode", "bf16", False, 32, 32, 128, 1, DECODE_LENS, False),
    ("decode", "bf16", False, 32, 8, 128, 1, DECODE_LENS, False),
    ("decode", "bf16", True, 32, 32, 128, 1, DECODE_LENS, True),
    ("decode", "bf16", True, 40, 40, 128, 1, DECODE_LENS, False),
    ("decode", "int8", True, 32, 32, 128, 1, DECODE_LENS, False),
    ("decode", "int8", True, 40, 40, 128, 1, DECODE_LENS, False),
    ("prefill", "bf16", False, 32, 32, 128, 2048, [1975], False),
    ("prefill", "bf16", False, 32, 32, 128, 2048, [1975, 900, 300, 37],
     False),
    ("prefill", "bf16", True, 32, 32, 128, 2048, [1975], True),
    ("prefill", "bf16", True, 40, 40, 128, 2048, [1975], False),
    ("prefill", "int8", True, 32, 32, 128, 2048, [1975], False),
    ("prefill", "int8", True, 40, 40, 128, 2048, [1975], False),
    ("prefill", "bf16", False, 71, 1, 64, 1, DECODE_LENS, False),
    ("prefill", "bf16", False, 71, 1, 64, 2048, [1975], False),
]
# The head-dim instances over int8, bf16 and float32 K/V, each a
# decode step (B = 4) and a prefill (T = 2048, 1975 real rows) at the
# models' own heads: Phi-2's 32 at D = 80 (the float32 instances' main
# cases: phase 10 serves Phi-2 over a float32 cache), GPT-NeoX-20B's 64 at
# 96, Gemma-7B's and GPT-J-6B's 16 at 256; Gemma-2B's 8 query heads over
# one KV head at 256 (decode through kernel C); and the masked head dim 72
# (through the 80 instance; int8 rows of 72 bytes take 8-byte loads).
DIM_CASES = [
    (kernel, kv, False, h, h, d, t, lens, kv == "f32" and d == 80)
    for d, h in ((80, 32), (96, 64), (256, 16), (72, 32))
    for kv in ("int8", "bf16", "f32")
    for kernel, t, lens in (("decode", 1, DECODE_LENS),
                            ("prefill", 2048, [1975]))
] + [("prefill", "bf16", False, 8, 1, 256, 1, DECODE_LENS, False),
     ("prefill", "bf16", False, 8, 1, 256, 2048, [1975], False)]
# The logit softcap (30, grok's) on kernels B, C, 9 and 10 at Grok-1's
# heads (48 query heads over 8 KV heads, n_rep 6: kernel B's MAX_REP
# instance; D = 128): a decode step (B = 4, the int8 cases with the fused
# append) and the bench prefill (T = 2048, 1975 real rows), over int8 K/V
# with bf16 and with float32 scales and over bf16 K/V (the engines'
# default cache), and ALiBi with the softcap.  q is drawn so that the
# scores' spread is 0.7 x the cap (the largest |score| of a row 2-3x the
# cap), where the softcap bites: each case also holds the kernel's output
# more than 10 tolerances away from the plain version without the softcap.
SOFTCAP = 30.0
SOFTCAP_CASES = [
    (kernel, kv, alibi, 48, 8, 128, t, lens, kv == "int8" and not alibi,
     SOFTCAP)
    for kernel, t, lens in (("decode", 1, DECODE_LENS),
                            ("prefill", 2048, [1975]))
    for kv, alibi in (("int8", False), ("int8f32", False), ("bf16", False),
                      ("int8", True))
]
# int8 K/V with float32 scales at Llama-2-7B's decode step (the fused
# append writes float32 scales) and bench prefill, without the softcap.
SCALE_F32_CASES = [
    ("decode", "int8f32", False, 32, 32, 128, 1, DECODE_LENS, True),
    ("prefill", "int8f32", False, 32, 32, 128, 2048, [1975], True),
]
# The int8 score dot (NST_FLASH_INT8=qk) in kernels B and 10, every
# head-dim instance at the shapes of the cases above: Llama-2-7B's heads
# (the main case), Mixtral's 8 KV heads, float32 scales, ALiBi, Grok-1's
# heads with the softcap, D = 80 / 96 / 256 and the masked 72, and kernel B
# without the extra column (the contiguous cache after a plain append,
# which goes to kernel B under qk).  q is drawn with outliers (`_qk_q`):
# each case also holds the output more than 10 tolerances from the plain
# version without the int8 dot, and times the kernel without it beside.
# (kernel, K/V, ALiBi, H, Hkv, D, T, kv_lens, main, softcap, extra column)
QK_CASES = [
    ("decode", "int8", False, 32, 32, 128, 1, DECODE_LENS, True, 0.0, True),
    ("decode", "int8", False, 32, 8, 128, 1, DECODE_LENS, False, 0.0, True),
    ("decode", "int8f32", False, 32, 32, 128, 1, DECODE_LENS, False, 0.0,
     True),
    ("decode", "int8", True, 32, 32, 128, 1, DECODE_LENS, False, 0.0, True),
    ("decode", "int8", False, 48, 8, 128, 1, DECODE_LENS, False, SOFTCAP,
     True),
    ("decode", "int8", False, 32, 32, 128, 1, DECODE_LENS, False, 0.0,
     False),
] + [("decode", "int8", False, h, h, d, 1, DECODE_LENS, False, 0.0, True)
     for d, h in ((80, 32), (96, 64), (256, 16), (72, 32), (64, 32))]
# Counter suffix of each K/V type of the cases.
# The decode body of the MQA / odd-KV-head calls (csrc/flash_rows.cuh) and
# its paged twin: Gemma-2B's 8 query heads over one KV head at D = 256 and
# Falcon-7B's 71 over one at D = 64, at B = 1 and B = 4, over int8, bf16
# and float32 K/V; 12 heads over 3 at D = 128 (an odd KV head count); ALiBi
# with the softcap once.  Each case also times kernel C / 9 (the body these
# calls took before) on the same call.  Drawn from a generator of their own
# (ROWS_SEED), after every other check: a pair run's other cases keep their
# inputs.
ROWS_SEED = 14
ROWS_CASES = [
    ("rows", kv, False, h, 1, d, 1, lens,
     kv == "bf16" and h == 71 and len(lens) == 4)
    for h, d in ((8, 256), (71, 64))
    for lens in ([1976], DECODE_LENS)
    for kv in ("int8", "bf16", "f32")
] + [("rows", "int8", False, 12, 3, 128, 1, DECODE_LENS, False),
     ("rows", "bf16", True, 12, 3, 128, 1, DECODE_LENS, False, SOFTCAP)]
# Kernels C and 9 on the calls of their new body's edges, each contiguous
# and paged (bit-equal) at Llama-2-7B's heads over int8 and bf16 K/V: T = 1
# (decode through C: one live row per block), 4 and 8 at the end of each
# slot's kv_len (speculative verify steps, B = 4 ragged; all three take one
# consumer warpgroup), 65 at the end (a prefill chunk over two warpgroups)
# and 1975 from position 0 over kv_len 1975 (a ragged last row tile and
# column tile).  (K/V, T, kv_lens, at the end of kv_len)  Drawn from a
# generator of their own (PREFILL_SEED), after every other check.
PREFILL_SEED = 18
PREFILL_CASES = [(kv, t, lens, at_end) for kv in ("int8", "bf16")
                 for t, lens, at_end in (
                     (1, DECODE_LENS, False), (4, DECODE_LENS, True),
                     (8, DECODE_LENS, True), (65, [1975, 900, 300, 65], True),
                     (1975, [1975], False))]
PREFILL_REPEAT_CALLS = 20
KV_SUFFIX = {"int8": "", "int8f32": "_f32scale", "bf16": "_bf16",
             "f32": "_f32"}


def _sdpa_mask(valid, pos, slopes, s):
    """SDPA's attn_mask for `valid` [B, T, S]: the boolean mask, or with
    ALiBi slopes [H] a float bias slope * (col - pos) with -inf on masked
    columns ([B, H, T, S])."""
    if slopes is None:
        return valid[:, None]
    col = torch.arange(s, device="cuda").float()
    bias = slopes[None, :, None, None] * (col[None, None, None, :]
                                          - pos.float()[:, None, :, None])
    return torch.where(valid[:, None], bias,
                       torch.full_like(bias, float("-inf")))


def _qk_q(gen, b, t, h, d):
    """q for the int8 score dot's cases: each row twice a normal draw with
    one element +-60 (30x the rest).  The row's int8 scale is then set by
    that element and the others quantize to a few levels, so the output
    moves far from the float product's; a plain normal q moves it by about
    one tolerance."""
    q = torch.randn((b, t, h, d), generator=gen, device="cuda")
    at = torch.randint(0, d, (b, t, h, 1), generator=gen, device="cuda")
    sign = torch.randint(0, 2, (b, t, h, 1), generator=gen,
                         device="cuda").float() * 2 - 1
    return 2.0 * q.scatter(-1, at, 30.0 * sign)


def _variant_case(chk, gen, kernel, kv, alibi, h, hkv, d, t, lens, main,
                  softcap=0.0, extra=None, qk=False, at_end=False,
                  spectator=True, ps=128):
    """One case of VARIANT_CASES / DIM_CASES / SOFTCAP_CASES /
    SCALE_F32_CASES / QK_CASES (`kv`: "int8", "int8f32" (float32 scales),
    "bf16" or "f32"; `extra`: the extra column, by default on for int8
    decode; `qk`: the int8 score dot): a shuffled pool at page size 128 and
    the same rows gathered
    into a contiguous cache (at a page size other than 128 the contiguous
    kernel is not recorded: the case at 128 holds it); the contiguous kernel and the paged kernel
    each within 4 bf16 ulps per row of its plain version, the paged kernel
    equal to the contiguous one bit for bit, and (int8 decode) the fused
    append equal to the plain version's.  With a softcap, q is scaled so
    that it bites (with `qk` too), and the kernel's output must lie more
    than 10 tolerances from the plain version's without it.  With `qk`, q has
    outliers (`_qk_q`) and the output must lie more than 10 tolerances from
    the plain version's without the int8 dot; the kernel without it is
    timed beside.  `at_end`: a call of t > 1 tokens at the end of each
    slot's kv_len (a speculative verify step or a prefill chunk), not a
    prompt from position 0.  `spectator`: at t = 1 the last slot is parked
    at max_len - 1 (False: every slot live); `ps`: the pool's page size.  Times kernel, plain version and SDPA over the
    same K/V (bf16; ALiBi as a float mask; at B = 1 from position 0 also
    SDPA's `is_causal` over the real rows, `_library_ms`; no SDPA call
    computes the softcap, so none is timed then)."""
    from neural_speed_tpu_torch.ops import flash
    from neural_speed_tpu_torch.ops.attention import alibi_slopes
    from neural_speed_tpu_torch.ops.paged_kv import gathered_layer

    s, layer = 2048, 1
    b = len(lens)
    scale = 1.0 / math.sqrt(d)
    slopes = alibi_slopes(h, "cuda") if alibi else None
    pool = _random_pool(gen, 2, b, hkv, s, d, ps, kv)
    ck = _gathered(pool, layer)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    if t == 1:      # live slots at kv_len - 1, the last one a spectator
        pos = (kv_lens - 1)[:, None].clone()
        if spectator:
            pos[-1] = s - 1
    else:
        ar = torch.arange(t, device="cuda", dtype=torch.int32)[None]
        start = (kv_lens - t).clamp_min(0)[:, None] if at_end else 0
        pos = torch.where(ar < kv_lens[:, None], start + ar,
                          torch.full_like(ar, s - 1))
    if qk:
        q = _qk_q(gen, b, t, h, d)
    else:
        q = torch.randn((b, t, h, d), generator=gen, device="cuda")
    if softcap:
        # scores (q . k) * scale of spread 0.7 x the cap (the int8 dot's
        # rows, with their outliers, each by its own norm)
        kstd = gathered_layer(pool, layer)[0].float().std().item()
        norm = q.norm(dim=-1, keepdim=True) if qk else math.sqrt(d)
        q = q * (0.7 * softcap / (kstd * norm * scale))
    q = q.to(torch.bfloat16)
    if extra is None:
        extra = kernel == "decode" and kv in ("int8", "int8f32")
    kn, vn = ((torch.randn((b, 1, hkv, d), generator=gen, device="cuda")
               ).to(torch.bfloat16) for _ in range(2)) if extra else (None,
                                                                     None)
    if kernel == "decode":
        cargs = lambda c, fused=extra: (q, kn, vn, *c, 0, pos[:, 0], kv_lens,
                                        scale, fused, torch.bfloat16)
        pargs = lambda p, fused=extra: (
            q, kn, vn, p.k_pages, p.v_pages, p.k_scale, p.v_scale,
            p.page_tables, layer, pos[:, 0], kv_lens, scale, fused,
            torch.bfloat16)
        fns = (flash.decode_cuda, flash.decode_plain, flash.decode_paged_cuda,
               flash.decode_paged_plain)
    else:
        cargs = lambda c, fused=False: (q, *c, 0, pos, kv_lens, scale,
                                        torch.bfloat16)
        pargs = lambda p, fused=False: (
            q, p.k_pages, p.v_pages, p.k_scale, p.v_scale, p.page_tables,
            layer, pos, kv_lens, scale, torch.bfloat16)
        fns = (flash.prefill_cuda, flash.prefill_plain,
               flash.prefill_paged_cuda, flash.prefill_paged_plain)
        if kernel == "rows":    # kernel C's function at T = 1, another body
            fns = (flash.rows_cuda, flash.prefill_plain,
                   flash.rows_paged_cuda, flash.prefill_paged_plain)
    c_cuda, c_plain, p_cuda, p_plain = fns
    kw = dict(alibi=slopes, softcap=softcap)
    if qk:
        kw["qk"] = True
    # the paged kernel over the pool and the contiguous kernel over the
    # gathered rows, without the append: equal bit for bit
    same = torch.equal(p_cuda(*pargs(pool, False), **kw),
                       c_cuda(*cargs(ck, False), **kw))
    suffix = (KV_SUFFIX[kv] + ("_softcap" if softcap else "")
              + ("_qk" if qk else ""))
    what = (f"{kernel} {kv} K/V{', ALiBi' if alibi else ''}"
            f"{f', softcap {softcap}' if softcap else ''}"
            f"{'' if extra or kernel != 'decode' else ', no extra column'} "
            f"H={h} Hkv={hkv} D={d} T={t}")
    if not same:
        raise AssertionError(f"flash_{kernel}_paged{suffix} ({what}) differs "
                             f"from the contiguous kernel over the same rows")
    col = torch.arange(s, device="cuda")
    cache_len = torch.where(extra & (pos[:, 0] == kv_lens - 1), kv_lens - 1,
                            kv_lens)
    valid = ((col[None, None] < cache_len[:, None, None])
             & (col[None, None] <= pos[:, :, None]))              # [B,T,S]
    pairs = valid.sum().item()
    kv_bytes = 2 * d * {"int8": 1, "int8f32": 1, "bf16": 2, "f32": 4}[kv] + (
        {"int8": 4, "int8f32": 8}.get(kv, 0))
    nbytes = (2 * b * t * h * d * 2 + valid.any(1).sum().item() * hkv
              * kv_bytes + (2 * b * hkv * d * 2 if extra else 0))
    for paged in (False, True):
        if not paged and ps != 128:
            continue
        name = f"flash_{kernel}{'_paged' if paged else ''}{suffix}"
        mk = (lambda: _clone_pool(pool)) if paged else (
            lambda: [None if a is None else a.clone() for a in ck])
        run, plain, args = ((p_cuda, p_plain, pargs) if paged
                            else (c_cuda, c_plain, cargs))
        a_k, a_p = mk(), mk()
        got = run(*args(a_k), **kw)
        want = plain(*args(a_p), **kw)
        torch.cuda.synchronize()
        if extra:
            ta = [getattr(a_k, n) for n in ("k_pages", "v_pages", "k_scale",
                                            "v_scale")] if paged else a_k
            tb = [getattr(a_p, n) for n in ("k_pages", "v_pages", "k_scale",
                                            "v_scale")] if paged else a_p
            n_keep = pool.n_pages - 1          # every page but the trash
            for x, y in zip(ta, tb):
                x, y = (x[:, :, :n_keep], y[:, :, :n_keep]) if paged else (
                    x, y)
                if not torch.equal(x, y):
                    raise AssertionError(f"{name} ({what}): the fused append "
                                         "differs from the plain version's")
        # as kernels B and C: within 4 bf16 ulps of the largest output of
        # the (slot, row, head) row
        cmp = compare(got, want, 4, per_row=True)
        if softcap:
            # the softcap bites: the output without it lies far away
            uncapped = plain(*args(mk(), False), alibi=slopes,
                             **({"qk": True} if qk else {}))
            off = compare(got, uncapped, 4, per_row=True)["worst"]
            if not off > 10:
                raise AssertionError(
                    f"{name} ({what}): the output is only {off:.2f} "
                    f"tolerances from the output without the softcap")
            log(f"  {name}: {off:.1f} tolerances from the output without "
                f"the softcap")
            del uncapped
        extra_rec = None
        if qk:
            # the int8 dot shows: the output without it lies far away
            off_kw = dict(kw, qk=False)
            off = compare(got, plain(*args(mk()), **off_kw), 4,
                          per_row=True)["worst"]
            if not off > 10:
                raise AssertionError(
                    f"{name} ({what}): the output is only {off:.2f} "
                    f"tolerances from the output without the int8 dot")
            off_ms = time_ms(lambda: run(*args(a_k), **off_kw))
            log(f"  {name}: {off:.1f} tolerances from the output without "
                f"the int8 dot; the kernel without it {off_ms:.4f} ms")
            extra_rec = dict(off_tolerances=off, qk_off_ms=off_ms)
        del got, want
        ms = time_ms(lambda: run(*args(a_k), **kw),
                     reps=DECODE_REPS if kernel == "decode" else TIME_REPS)
        if kernel == "rows":
            # the body these calls took before (kernel C / 9), timed beside
            prev = flash.prefill_paged_cuda if paged else flash.prefill_cuda
            c_ms = time_ms(lambda: prev(*args(a_k), **kw))
            log(f"  {name}: kernel {'9' if paged else 'C'} on the same "
                f"call {c_ms:.4f} ms")
            extra_rec = dict(extra_rec or {}, prev_body_ms=c_ms)
        plain_ms = plain_time_ms(lambda: plain(*args(a_p), **kw))
        lib_ms = None
        if not softcap:
            kd, vd = gathered_layer(pool, layer)
            mask = _sdpa_mask(valid, pos, slopes, s)
            qs = q.transpose(1, 2)
            if kernel == "prefill" and t > 1 and not (alibi or at_end):
                lib_ms, lib = _library_ms(qs, kd, vd, mask, hkv != h, lens,
                                          scale)
                extra_rec = dict(extra_rec or {}, **lib)
            else:
                lib_ms = time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(
                        qs, kd, vd, attn_mask=mask, scale=scale,
                        enable_gqa=hkv != h))
            del kd, vd, mask
        del a_k, a_p
        chk.add(name, "cuda",
                f"neural_speed_tpu_torch/csrc/flash_{kernel}.cuh",
                "neural_speed_tpu/ops/flash.py:"
                + {("decode", False): "267", ("decode", True): "1196",
                   ("prefill", False): "142", ("prefill", True): "1111",
                   ("rows", False): "142",
                   ("rows", True): "1111"}[kernel, paged],
                f"B={b} T={t} H={h} Hkv={hkv} D={d} (instance "
                f"{flash.instance_dim(d)}) {kv} S={s} kv_len="
                f"{'/'.join(map(str, lens))}{' ALiBi' if alibi else ''}"
                f"{' (no extra column)' if qk and not extra else ''}"
                f"{' at the end of kv_len' if at_end else ''}"
                f"{f', page size {ps}, shuffled table' if paged else ''}",
                cmp, ms, plain_ms, lib_ms,
                nbytes + (pool.page_tables.numel() * 4 if paged else 0),
                4.0 * pairs * h * d, main=main, extra=extra_rec)
        torch.cuda.empty_cache()
    del pool, ck
    torch.cuda.empty_cache()


def check_flash_prefill_cases(chk: Checks, gen: torch.Generator) -> None:
    gen = torch.Generator(device="cuda").manual_seed(PREFILL_SEED)
    for kv, t, lens, at_end in PREFILL_CASES:
        _variant_case(chk, gen, "prefill", kv, False, 32, 32, 128, t, lens,
                      False, at_end=at_end)


def check_flash_prefill_repeat(chk: Checks, gen: torch.Generator) -> None:
    """Kernels C and 9 are deterministic: PREFILL_REPEAT_CALLS calls on the
    same inputs, each after an L2 flush, give one digest, at the headline
    case (int8, B = 1, T = 2048 with 1975 real rows, Llama-2-7B's heads)
    and at page size 16 over a shuffled table.  A ring stage overwritten
    before it was consumed would show as a call that differs (such a race
    in the GEMM template's rings gave one wrong call in ~300, within no
    tolerance check's reach).  Drawn from a generator of its own."""
    from neural_speed_tpu_torch.ops import flash

    gen = torch.Generator(device="cuda").manual_seed(PREFILL_SEED + 1)
    t, h, d, s, lens = 2048, 32, 128, 2048, [1975]
    scale = 1.0 / math.sqrt(d)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    ar = torch.arange(t, device="cuda", dtype=torch.int32)[None]
    pos = torch.where(ar < kv_lens[:, None], ar, torch.full_like(ar, s - 1))
    q = torch.randn((1, t, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    cache = _random_cache(gen, 1, 1, h, s, d)
    pool = _random_pool(gen, 1, 1, h, s, d, 16)
    for what, fn in (
            ("flash_prefill", lambda: flash.prefill_cuda(
                q, cache.k, cache.v, cache.k_scale, cache.v_scale, 0, pos,
                kv_lens, scale, torch.bfloat16)),
            ("flash_prefill_paged page size 16",
             lambda: flash.prefill_paged_cuda(
                 q, pool.k_pages, pool.v_pages, pool.k_scale, pool.v_scale,
                 pool.page_tables, 0, pos, kv_lens, scale, torch.bfloat16))):
        first = fn()
        differing = 0
        for _ in range(PREFILL_REPEAT_CALLS):
            _flush_l2()
            bad = (fn() != first).nonzero()
            if bad.numel():
                differing += 1
                log(f"  {what}: a call differs at {bad.shape[0]} outputs, "
                    f"first {bad[0].tolist()}")
        log(f"  flash_prefill_repeat {what}: {PREFILL_REPEAT_CALLS} calls "
            f"after L2 flushes, {differing} differing")
        if differing:
            raise AssertionError(f"{what}: {differing} of "
                                 f"{PREFILL_REPEAT_CALLS} calls on the same "
                                 "inputs differ")
    del cache, pool, q
    torch.cuda.empty_cache()


def check_flash_variants(chk: Checks, gen: torch.Generator) -> None:
    for case in VARIANT_CASES:
        _variant_case(chk, gen, *case)


def check_flash_dims(chk: Checks, gen: torch.Generator) -> None:
    for case in DIM_CASES:
        _variant_case(chk, gen, *case)


def check_flash_softcap(chk: Checks, gen: torch.Generator) -> None:
    for case in SOFTCAP_CASES + SCALE_F32_CASES:
        _variant_case(chk, gen, *case)


def check_flash_rows(chk: Checks, gen: torch.Generator) -> None:
    gen = torch.Generator(device="cuda").manual_seed(ROWS_SEED)
    for case in ROWS_CASES:
        _variant_case(chk, gen, *case)


def check_flash_qk(chk: Checks, gen: torch.Generator) -> None:
    for case in QK_CASES:
        _variant_case(chk, gen, *case, qk=True)


# Kernel B's int8 score dot over several tokens per slot (speculative
# decoding's verify steps, t * n_rep <= 8, the contiguous int8 cache, no
# extra column): Llama-2-7B's heads at t = 2, 4 and 8 (t = 8: the main
# case, phase 14's verify at spec_k 7), Mixtral's 8 KV heads at t = 2
# (n_rep 4), float32 scales, ALiBi and the non-causal variant at t = 4, and
# the head-dim instances 80 / 96 / 256 / 64 at t = 4.  The slots are those
# of a joint step over phase 2's lengths: slots 0 and 2 verify t real rows
# ending at kv_len - 1, slot 1 has t // 2 real rows and the rest padded at
# max_len - 1, slot 3 is idle (all rows at max_len - 1 over its 900 stored
# rows).  q has outliers (`_qk_q`): the output must lie more than 10
# tolerances from the plain version's without the int8 dot.
# (H, Hkv, D, t, K/V, ALiBi, causal, main)
QK_MULTI_CASES = [
    (32, 32, 128, 8, "int8", False, True, True),
    (32, 32, 128, 4, "int8", False, True, False),
    (32, 32, 128, 2, "int8", False, True, False),
    (32, 8, 128, 2, "int8", False, True, False),
    (32, 32, 128, 4, "int8f32", False, True, False),
    (32, 32, 128, 4, "int8", True, True, False),
    (32, 32, 128, 4, "int8", False, False, False),
] + [(h, h, d, 4, "int8", False, True, False)
     for d, h in ((80, 32), (96, 64), (256, 16), (64, 32))]


def _qk_multi_case(chk, gen, h, hkv, d, t, kv, alibi, causal, main):
    """One case of QK_MULTI_CASES: kernel B's `_qk_multi` launch within 4
    bf16 ulps per row of its plain version, the cache untouched, the output
    more than 10 tolerances from the plain version without the int8 dot;
    times the kernel, the plain version and SDPA over the dequantized K/V
    with the same per-row mask (ALiBi as a float mask)."""
    from neural_speed_tpu_torch import _build
    from neural_speed_tpu_torch.ops import flash
    from neural_speed_tpu_torch.ops.attention import alibi_slopes

    s, layer = 2048, 1
    lens = DECODE_LENS
    b = len(lens)
    scale = 1.0 / math.sqrt(d)
    codes = lambda: torch.randint(-127, 128, (2, b, hkv, s, d), generator=gen,
                                  device="cuda", dtype=torch.int8)
    sdt = torch.float32 if kv == "int8f32" else torch.bfloat16
    scales = lambda: ((torch.rand((2, b, hkv, s), generator=gen,
                                  device="cuda") + 0.5) * 0.02).to(sdt)
    cache = [codes(), codes(), scales(), scales()]
    keep = [a.clone() for a in cache]
    kv_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    real = [t, max(1, t // 2), t, 0]                   # rows per slot
    pos = torch.full((b, t), s - 1, dtype=torch.int32)
    for i, n in enumerate(real):
        pos[i, :n] = torch.arange(lens[i] - n, lens[i])
    pos = pos.cuda()
    q = _qk_q(gen, b, t, h, d).to(torch.bfloat16)
    slopes = alibi_slopes(h, "cuda") if alibi else None
    args = (q, None, None, *cache, layer, pos, kv_lens, scale, False,
            torch.bfloat16)
    kw = dict(alibi=slopes, causal=causal, qk=True)
    name = ("flash_decode" + KV_SUFFIX[kv] + ("" if causal else "_noncausal")
            + "_qk_multi")
    before = _build.launches[name]
    got = flash.decode_cuda(*args, **kw)
    want = flash.decode_plain(*args, **kw)
    torch.cuda.synchronize()
    if _build.launches[name] != before + 1:
        raise AssertionError(f"{name}: the launch was not counted")
    if not all(torch.equal(a, c) for a, c in zip(cache, keep)):
        raise AssertionError(f"{name}: the kernel wrote to the cache")
    what = (f"B={b} T={t} H={h} Hkv={hkv} D={d} (instance "
            f"{flash.instance_dim(d)}) {kv} S={s} kv_len="
            f"{'/'.join(map(str, lens))} rows {'/'.join(map(str, real))}"
            f"{' ALiBi' if alibi else ''}{'' if causal else ' non-causal'}")
    cmp = compare(got, want, 4, per_row=True)
    off = compare(got, flash.decode_plain(*args, alibi=slopes,
                                          causal=causal), 4,
                  per_row=True)["worst"]
    if not off > 10:
        raise AssertionError(f"{name} ({what}): the output is only "
                             f"{off:.2f} tolerances from the output without "
                             f"the int8 dot")
    del got, want
    ms = time_ms(lambda: flash.decode_cuda(*args, **kw), reps=DECODE_REPS)
    plain_ms = plain_time_ms(lambda: flash.decode_plain(*args, **kw))
    col = torch.arange(s, device="cuda")
    valid = col[None, None] < kv_lens[:, None, None]
    if causal:
        valid = valid & (col[None, None] <= pos[:, :, None])   # [B, t, S]
    k8, v8, ks, vs = (a[layer] for a in cache)
    kd = (k8.float() * ks.float()[..., None]).to(torch.bfloat16)
    vd = (v8.float() * vs.float()[..., None]).to(torch.bfloat16)
    mask = _sdpa_mask(valid, pos, slopes, s)
    qs = q.transpose(1, 2)
    lib_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qs, kd, vd, attn_mask=mask, scale=scale, enable_gqa=hkv != h))
    kv_bytes = 2 * d + (8 if kv == "int8f32" else 4)
    nbytes = (2 * b * t * h * d * 2 + valid.any(1).sum().item() * hkv
              * kv_bytes)
    chk.add(name, "cuda", "neural_speed_tpu_torch/csrc/flash_decode.cuh",
            "neural_speed_tpu/ops/flash.py:267", what, cmp, ms, plain_ms,
            lib_ms, nbytes, 4.0 * valid.sum().item() * h * d, main=main,
            extra=dict(off_tolerances=off))
    log(f"  {name}: {off:.1f} tolerances from the output without the int8 "
        f"dot")
    del cache, keep, kd, vd, mask
    torch.cuda.empty_cache()


def check_flash_qk_multi(chk: Checks, gen: torch.Generator) -> None:
    for case in QK_MULTI_CASES:
        _qk_multi_case(chk, gen, *case)


# Kernels B and 10 at B = 1 (one request decoding: the grid is B * Hkv *
# splits, so the split count sets how much of the card works), kv_len 1976,
# the slot live (the extra column and the fused append over int8): int8
# and bf16 K/V at Llama-2-7B's 32 KV heads and Mixtral's 8 (32 query
# heads), Grok-1's softcap at n_rep 6 (48 over 8); each paged twin over a
# shuffled pool at page size 128, and the int8 cases also at 16.  (K/V, H,
# Hkv, softcap, page size)  Drawn from a generator of their own
# (DECODE_SEED): a pair run's other cases keep their inputs.
DECODE_SEED = 21
DECODE_B1_CASES = [(kv, 32, hkv, 0.0, ps) for kv in ("int8", "bf16")
                   for hkv in (32, 8)
                   for ps in ((128, 16) if kv == "int8" else (128,))] + [
    ("int8", 48, 8, SOFTCAP, 128)]
DECODE_REPEAT_CALLS = 20


def check_flash_decode_b1(chk: Checks, gen: torch.Generator) -> None:
    gen = torch.Generator(device="cuda").manual_seed(DECODE_SEED)
    for kv, h, hkv, cap, ps in DECODE_B1_CASES:
        _variant_case(chk, gen, "decode", kv, False, h, hkv, 128, 1, [1976],
                      False, cap, spectator=False, ps=ps)


def _decode_calls(gen):
    """Kernel B / 10 calls for the launch and repeat checks: (label,
    call), each call on inputs of its own (int8 at the main path's B = 4,
    Llama-2-7B's heads, the extra column and the fused append; bf16 at 8
    KV heads; the int8 score dot at t = 1 and t = 4; the pool at page sizes
    16 and 128)."""
    from neural_speed_tpu_torch.ops import flash

    b, h, d, s = 4, 32, 128, 2048
    scale = 1.0 / math.sqrt(d)
    kv_lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device="cuda")
    pos = kv_lens - 1
    pos[-1] = s - 1
    calls = []
    for label, kv, hkv, qk, t, ps in (
            ("int8 Hkv=32", "int8", 32, False, 1, None),
            ("bf16 Hkv=8", "bf16", 8, False, 1, None),
            ("int8 qk Hkv=32", "int8", 32, True, 1, None),
            ("int8 qk t=2 Hkv=8", "int8", 8, True, 2, None),
            ("paged int8 Hkv=32 page size 128", "int8", 32, False, 1, 128),
            ("paged int8 Hkv=32 page size 16", "int8", 32, False, 1, 16)):
        pool = _random_pool(gen, 1, b, hkv, s, d, ps or 128, kv)
        q = torch.randn((b, t, h, d), generator=gen, device="cuda").to(
            torch.bfloat16)
        extra = kv == "int8" and t == 1
        kn, vn = ((torch.randn((b, 1, hkv, d), generator=gen, device="cuda")
                   .to(torch.bfloat16)) for _ in range(2)) if extra else (
                       None, None)
        if t > 1:
            p = (kv_lens[:, None] - t + torch.arange(
                t, device="cuda", dtype=torch.int32)[None]).contiguous()
        else:
            p = pos
        if ps is None:
            c = _gathered(pool, 0)
            fn = (lambda q=q, kn=kn, vn=vn, c=c, p=p, extra=extra, qk=qk:
                  flash.decode_cuda(q, kn, vn, *c, 0, p, kv_lens, scale,
                                    extra, torch.bfloat16, qk=qk))
        else:
            fn = (lambda q=q, kn=kn, vn=vn, c=pool, extra=extra:
                  flash.decode_paged_cuda(
                      q, kn, vn, c.k_pages, c.v_pages, c.k_scale, c.v_scale,
                      c.page_tables, 0, pos, kv_lens, scale, extra,
                      torch.bfloat16))
        calls.append((label, fn))
    return calls


def check_flash_decode_launches(chk: Checks, gen: torch.Generator) -> None:
    """One kernel launch per `decode_cuda` / `decode_paged_cuda` call: the
    kernels torch.profiler records for each call (one session for all,
    `_kernel_groups`).  Fails on the parent's body (a split kernel and a
    combine kernel) by design."""
    gen = torch.Generator(device="cuda").manual_seed(DECODE_SEED + 1)
    calls = _decode_calls(gen)
    groups = _kernel_groups([fn for _, fn in calls])
    seen = {}
    for (label, _), names in zip(calls, groups):
        seen[label] = [_kernel_name(nm) for nm in names]
        if len(names) != 1 or "flash_decode" not in names[0]:
            raise AssertionError(f"kernel B / 10 {label}: launches {names}")
    chk.notes["decode_launches"] = seen
    log(f"  decode_launches: {len(seen)} calls, one launch each: "
        + json.dumps(sorted({v[0] for v in seen.values()})))


def check_flash_decode_repeat(chk: Checks, gen: torch.Generator) -> None:
    """Kernels B and 10 are deterministic: DECODE_REPEAT_CALLS calls on the
    same inputs, each after an L2 flush, give one digest at the headline
    case (int8, B = 4, Llama-2-7B's heads, the fused append rewriting the
    same row) and over the pool at page size 16.  The splits are merged in
    split order by whichever block finishes last: an arrival-order merge
    or a partial read before it was written would show as a call that
    differs."""
    gen = torch.Generator(device="cuda").manual_seed(DECODE_SEED + 2)
    for label, fn in _decode_calls(gen):
        if label not in ("int8 Hkv=32", "paged int8 Hkv=32 page size 16"):
            continue
        first = fn()
        differing = 0
        for _ in range(DECODE_REPEAT_CALLS):
            _flush_l2()
            bad = (fn() != first).nonzero()
            if bad.numel():
                differing += 1
                log(f"  {label}: a call differs at {bad.shape[0]} outputs, "
                    f"first {bad[0].tolist()}")
        digest = compare(first, first, 4, per_row=True)["digest"]
        chk.notes.setdefault("decode_repeat", []).append(
            dict(case=label, calls=DECODE_REPEAT_CALLS, differing=differing,
                 digest=digest))
        log(f"  decode_repeat {label}: {DECODE_REPEAT_CALLS} calls after L2 "
            f"flushes, {differing} differing (digest {digest})")
        if differing:
            raise AssertionError(f"kernel B / 10 {label}: {differing} of "
                                 f"{DECODE_REPEAT_CALLS} calls differ")
    torch.cuda.empty_cache()


# The non-causal variant (whisper's encoder and cross attention) at
# whisper-large-v2's heads (H = Hkv = 20, D = 64) over its 1500 encoder
# frames laid out at S = 1536 (kv_len 1500 masks the padding): kernels C
# and 9 at the encoder's self-attention (B = 1, T = 1500, float32 K/V, q
# and output; the padding filled with large values, so that a leak shows)
# and at the cross attention of the forced prefix (T = 4, B = 1 and 4: the
# beam search's batch), kernels B and 10 at the cross attention of a
# decode step (B = 1 and 4, pos 0); int8 and bf16 K/V and ALiBi once each
# (bf16 q and output).  Queries sit at positions 0..T-1, where causal
# attention would mask most columns: each output is also held far from
# the causal output of the same inputs.
# (kernel, K/V, ALiBi, T, kv_lens, main, pad filled)
WHISPER_S = 1536
NONCAUSAL_CASES = [
    ("prefill", "f32", False, 1500, [1500], True, True),
    ("prefill", "f32", False, 4, [1500], False, False),
    ("prefill", "f32", False, 4, [1500] * 4, False, False),
    ("decode", "f32", False, 1, [1500], True, False),
    ("decode", "f32", False, 1, [1500] * 4, False, False),
    ("decode", "int8", False, 1, [1500] * 4, False, False),
    ("prefill", "bf16", False, 4, [1500] * 4, False, False),
    ("decode", "bf16", True, 1, [1500] * 4, False, False),
]


# Whisper's decoder self-attention: causal, float32 K/V, q and output over
# its 448-row cache (H = Hkv = 20, D = 64): kernel B at decode steps
# (pos = kv_len - 1; B = 1 and the 4 beams, at a few lengths) and kernel C
# at the 4-token forced prefix (pos 0..3, kv_len 4); the rows past each
# length filled with large values; the paged twins at page size 64.
# (kernel, K/V, ALiBi, T, kv_lens, main, pad filled)
WHISPER_TGT = 448
WHISPER_SELF_CASES = [
    ("prefill", "f32", False, 4, [4], False, True),
    ("prefill", "f32", False, 4, [4] * 4, False, True),
    ("decode", "f32", False, 1, [68], False, True),
    ("decode", "f32", False, 1, [448], False, True),
    ("decode", "f32", False, 1, [20] * 4, False, True),
    ("decode", "f32", False, 1, [5, 137, 300, 448], False, True),
]


def _fill_pad(pool, layer: int, lens, s: int = WHISPER_S) -> None:
    """Large values in the rows past each slot's length (the layout's
    padding, or the cache's unwritten rows), in place."""
    ps = pool.k_pages.shape[3]
    for b, n in enumerate(lens):
        for c0 in range(n - n % ps, s, ps):
            page = pool.page_tables[b, c0 // ps]
            r0 = max(n - c0, 0)
            for a in (pool.k_pages, pool.v_pages):
                a[layer, :, page, r0:] = (127 if a.dtype == torch.int8
                                          else 1.0e4)


def _whisper_case(chk, gen, kernel, kv, alibi, t, lens, main, pad,
                  causal=False, s=WHISPER_S):
    """One case of NONCAUSAL_CASES (or, `causal` over `s` rows,
    WHISPER_SELF_CASES): a shuffled pool at page size 128 (64 when `s` is
    not a multiple of 128) and the same rows gathered into a contiguous
    cache; the output of q's dtype (a float32 one not rounded through
    bf16), the contiguous kernel within 4 bf16 ulps per row of its plain
    version, the paged kernel equal to it bit for bit, and the output more
    than 10 tolerances from the plain version's of the other variant (not
    at a causal decode step, where pos = kv_len - 1 makes both the same).
    Times kernel, plain version and SDPA over the same K/V (the mask of the
    variant; the padding masked as keys)."""
    from neural_speed_tpu_torch.ops import flash
    from neural_speed_tpu_torch.ops.attention import alibi_slopes
    from neural_speed_tpu_torch.ops.paged_kv import gathered_layer

    h = hkv = 20
    d, ps, layer = 64, 128 if s % 128 == 0 else 64, 1
    b = len(lens)
    scale = 1.0 / math.sqrt(d)
    slopes = alibi_slopes(h, "cuda") if alibi else None
    f32 = kv == "f32"
    io = torch.float32 if f32 else torch.bfloat16
    pool = _random_pool(gen, 2, b, hkv, s, d, ps, kv)
    if pad:
        _fill_pad(pool, layer, lens, s)
    ck = _gathered(pool, layer)
    kv_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    if causal and kernel == "decode":   # live slots: pos = kv_len - 1
        pos = (kv_lens - 1)[:, None].clone()
    else:
        pos = torch.arange(t, device="cuda", dtype=torch.int32)[None].expand(
            b, t).contiguous()
    q = torch.randn((b, t, h, d), generator=gen, device="cuda").to(io)
    if kernel == "decode":
        cargs = lambda c: (q, None, None, *c, 0, pos[:, 0], kv_lens, scale,
                           False, io)
        pargs = lambda p: (q, None, None, p.k_pages, p.v_pages, p.k_scale,
                           p.v_scale, p.page_tables, layer, pos[:, 0],
                           kv_lens, scale, False, io)
        fns = (flash.decode_cuda, flash.decode_plain, flash.decode_paged_cuda,
               flash.decode_paged_plain)
    else:
        cargs = lambda c: (q, *c, 0, pos, kv_lens, scale, io)
        pargs = lambda p: (q, p.k_pages, p.v_pages, p.k_scale, p.v_scale,
                           p.page_tables, layer, pos, kv_lens, scale, io)
        fns = (flash.prefill_cuda, flash.prefill_plain,
               flash.prefill_paged_cuda, flash.prefill_paged_plain)
    c_cuda, c_plain, p_cuda, p_plain = fns
    kw = dict(alibi=slopes, causal=causal)
    variant = "causal" if causal else "non-causal"
    suffix = KV_SUFFIX[kv] + ("" if causal else "_noncausal")
    what = (f"{kernel} {kv} K/V{', ALiBi' if alibi else ''}, {variant}, "
            f"B={b} T={t} S={s}")
    if not torch.equal(p_cuda(*pargs(pool), **kw), c_cuda(*cargs(ck), **kw)):
        raise AssertionError(f"flash_{kernel}_paged{suffix} ({what}) differs "
                             f"from the contiguous kernel over the same rows")
    col = torch.arange(s, device="cuda")
    valid = (col[None, None] < kv_lens[:, None, None]).expand(b, t, s)
    if causal:
        valid = valid & (col[None, None] <= pos[:, :, None])
    pairs = valid.sum().item()
    kv_bytes = 2 * d * {"int8": 1, "bf16": 2, "f32": 4}[kv] + (
        4 if kv == "int8" else 0)
    nbytes = (2 * b * t * h * d * io.itemsize
              + valid.any(1).sum().item() * hkv * kv_bytes)
    for paged in (False, True):
        name = f"flash_{kernel}{'_paged' if paged else ''}{suffix}"
        run, plain, args, c = ((p_cuda, p_plain, pargs, pool) if paged
                               else (c_cuda, c_plain, cargs, ck))
        got = run(*args(c), **kw)
        if got.dtype != io:
            raise AssertionError(f"{name} ({what}) wrote {got.dtype}, not "
                                 f"{io}")
        # a float32 output stored from the float32 sums, not through bf16
        # (which the ulp tolerance below would let pass)
        in_bf16 = (got.to(torch.bfloat16).to(io) == got).float().mean()
        if f32 and not in_bf16.item() < 0.5:
            raise AssertionError(f"{name} ({what}): {in_bf16.item():.0%} of "
                                 f"the float32 outputs are bf16 values")
        want = plain(*args(c), **kw)
        torch.cuda.synchronize()
        # as kernels B and C: within 4 bf16 ulps of the largest output of
        # the (slot, row, head) row
        cmp = compare(got, want, 4, per_row=True)
        if not (causal and kernel == "decode"):
            other = plain(*args(c), alibi=slopes, causal=not causal)
            off = compare(got, other, 4, per_row=True)["worst"]
            if not off > 10:
                raise AssertionError(
                    f"{name} ({what}): the output is only {off:.2f} "
                    f"tolerances from the {'non-' if causal else ''}causal "
                    f"one")
            log(f"  {name}: {off:.1f} tolerances from the "
                f"{'non-' if causal else ''}causal output")
            del other
        del got, want
        ms = time_ms(lambda: run(*args(c), **kw),
                     reps=DECODE_REPS if kernel == "decode" else TIME_REPS)
        plain_ms = plain_time_ms(lambda: plain(*args(c), **kw))
        kd, vd = gathered_layer(pool, layer, io)
        mask = _sdpa_mask(valid, pos, slopes, s)
        qs = q.transpose(1, 2)
        lib_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qs, kd, vd, attn_mask=mask, scale=scale))
        del kd, vd, mask
        chk.add(name, "cuda",
                f"neural_speed_tpu_torch/csrc/flash_{kernel}.cuh",
                "neural_speed_tpu/ops/flash.py:"
                + {("decode", False): "267", ("decode", True): "1196",
                   ("prefill", False): "142", ("prefill", True): "1111",
                   ("rows", False): "142",
                   ("rows", True): "1111"}[kernel, paged],
                f"B={b} T={t} H={h} Hkv={hkv} D={d} {kv} q/out "
                f"{'f32' if f32 else 'bf16'} S={s} kv_len="
                f"{'/'.join(map(str, lens))} {variant}, "
                + (f"pos kv_len-1" if causal and kernel == "decode"
                   else f"pos 0..{t - 1}")
                + f"{' ALiBi' if alibi else ''}"
                f"{', padding filled' if pad else ''}"
                f"{f', page size {ps}, shuffled table' if paged else ''}",
                cmp, ms, plain_ms, lib_ms,
                nbytes + (pool.page_tables.numel() * 4 if paged else 0),
                4.0 * pairs * h * d, main=main)
        torch.cuda.empty_cache()
    del pool, ck
    torch.cuda.empty_cache()


def check_flash_noncausal(chk: Checks, gen: torch.Generator) -> None:
    for case in NONCAUSAL_CASES:
        _whisper_case(chk, gen, *case)


def check_flash_whisper_self(chk: Checks, gen: torch.Generator) -> None:
    for case in WHISPER_SELF_CASES:
        _whisper_case(chk, gen, *case, causal=True, s=WHISPER_TGT)


# ---------------------------------------------------------------------------
# phase 3: a tiny model on the card against the CPU
# ---------------------------------------------------------------------------


def format_configs():
    """The configurations of the formats path (phases 3 and 5): label, the
    model's one `QSpec` (g = 128 at full width; phase 3 uses g = 64), the
    int8-compute switch, and the matmul kernels its prefill and its decode
    steps must launch."""
    from neural_speed_tpu_torch.ops.qtypes import named_qspec

    bf = dict(scale_dtype="bfloat16")
    return [
        ("nf4", lambda g: named_qspec("nf4", g, **bf), None,
         ("qmatmul_lut",), ("qmatmul_lut",)),
        ("int5 asymmetric", lambda g: named_qspec("int5", g, False, **bf), None,
         ("qmatmul_planar",), ("qmatmul_planar",)),
        ("fp8_e4m3", lambda g: named_qspec("fp8_e4m3", g, **bf), None,
         ("qmatmul_planar",), ("qmatmul_planar",)),
        ("int4 + comp=int8", lambda g: named_qspec("int4", g, **bf), "int8",
         ("qmatmul_int8", "qmatmul"), ("qmatmul",)),
        ("int3 + comp=int8", lambda g: named_qspec("int3", g, **bf), "int8",
         ("qmatmul_int8_planar", "qmatmul_planar"), ("qmatmul_planar",)),
    ]


# Params seed and number of checked steps (prefill + greedy decode steps) of
# the tiny model per configuration: seeds whose greedy streams keep every
# checked step's top-2 margin on the CPU above twice the logit tolerance, so
# that equal ids at every step is a real check.  Asymmetric int5 draws
# uniform zero points, which makes large logits with narrow margins: no seed
# below 400 keeps 9 clear steps, so it is held for 5.  The tiny Mixtral's
# seed also keeps every routing decision of a real token on the CPU at
# least 3.6 bf16 ulps of the row's largest router logit from a tie, at
# B = 3 and B = 1 (1 in 240 seeds searched did both over 6 steps).  The
# converted checkpoints (`check_tiny_checkpoints`) were searched the same
# way over seeds 0-399: their uniform codes give flat logits, so the GGUF
# Q8_0 llama is held for the 7 steps its best seed keeps clear, and the
# nf4 Mixtral, whose router gaps are narrow, for 4.  The tiny HF archs
# (`check_tiny_hf`) were searched the same way over seeds 0-299 (the tiny
# GPT-NeoX at head dim 96 kept 9 clear steps at one seed only); the int4
# seed and the refill prompt of the paged check keep their margins over the
# bf16 pool too.  The tiny grok (`check_tiny_grok`) was searched over seeds
# 0-59 for routing decisions 3.6 bf16 ulps clear of a tie (its router
# logits round to bf16, as the JAX package's: 3 seeds of 60 kept them so
# in all four runs) and greedy margins (all wide); the tiny llama keeps its
# int4 seed's margins over int8 K/V with float32 scales.
TINY_SEEDS = {"int4": (15, 9), "nf4": (268, 9), "int5 asymmetric": (84, 5),
              "fp8_e4m3": (562, 9), "int4 + comp=int8": (172, 9),
              "int3 + comp=int8": (1, 9), "mixtral int4": (89, 6),
              "mixtral int4 B=1": (89, 6), "gptq act-order": (2, 9),
              "gguf Q4_0": (4, 9), "gguf Q8_0": (10, 7),
              "gguf Q4_K_M": (166, 9), "gguf Q2_K": (60, 9),
              "mixtral gguf Q4_0": (7, 6), "mixtral nf4": (87, 4),
              "mpt bf16": (33, 9), "mpt int8": (11, 9), "bloom bf16": (19, 9),
              "falcon bf16": (22, 9), "int4 paged bf16": (15, 9),
              "gemma bf16": (0, 9), "phi bf16": (172, 9),
              "gpt_neox bf16": (299, 9), "phi f32": (172, 9),
              "grok": (12, 6), "int4 f32 scales": (15, 9),
              "tiny hf llama": (3, 8), "tiny hf llama qk": (393, 8)}


TINY_CFG = dict(name="llama", vocab_size=512, hidden_size=512, n_layers=2,
                n_heads=8, n_kv_heads=4, intermediate_size=1408,
                max_position_embeddings=256)
TINY_PROMPTS = [list(range(3, 40)), [7, 8, 9], list(range(100, 190))]


def _hold_tiny(logits, active, what) -> torch.Tensor:
    """Card logits against CPU logits of the active rows: within 2% of the
    largest logit (a few bf16 ulps), with the CPU's top-2 margin above twice
    that, and equal greedy ids.  Returns the CPU's ids."""
    tol = 0.02 * logits["cpu"][active].abs().max().item()
    diff = (logits["cuda"] - logits["cpu"])[active].abs().max().item()
    if diff > tol:
        raise AssertionError(f"{what}: logits differ by {diff} > {tol}")
    top2 = logits["cpu"][active].topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).min().item()
    if margin <= 2 * tol:
        raise AssertionError(f"{what}: top-2 margin {margin} within twice "
                             f"the tolerance {tol}")
    ids = {dev: lg.argmax(-1) for dev, lg in logits.items()}
    if not torch.equal(ids["cuda"][active], ids["cpu"][active]):
        raise AssertionError(f"{what}: greedy ids differ")
    return ids["cpu"].to(torch.int32)


# The tiny Mixtral of phase 3: the llama above with 8 query heads over 2 KV
# heads (Mixtral's n_rep = 4) and 4 experts, top-2; shorter prompts, so
# that fewer routing decisions have to keep clear margins.  At B = 3 every
# MoE layer takes the grouped path, at B = 1 the single-token path.
TINY_MOE = dict(TINY_CFG, name="mixtral", n_kv_heads=2)
TINY_MOE_PROMPTS = [list(range(3, 20)), [7, 8, 9], list(range(100, 130))]


def tiny_moe_cfg():
    from neural_speed_tpu_torch.models.arch import ArchConfig, MoEConfig

    return ArchConfig(**TINY_MOE, moe=MoEConfig(num_experts=4, top_k=2))


# The tiny grok of phase 3: `grok_arch` at hidden 256 with Grok-1's 48 / 8
# query / KV heads cut to 12 / 2 (n_rep 6: kernel B's MAX_REP instance) at
# its head dim 128, 4 experts of width 512 top-2, the embedding and output
# multipliers and the sandwich norms; the softcap at 2 (the scores' spread
# is about 2 at these weights, so it bites: at 30 it would not).
TINY_GROK_HF = {"model_type": "grok-1", "vocab_size": 512, "hidden_size": 256,
                "intermediate_size": 512, "num_hidden_layers": 2,
                "num_attention_heads": 12, "num_key_value_heads": 2,
                "max_position_embeddings": 256, "num_local_experts": 4,
                "num_experts_per_tok": 2,
                "embedding_multiplier_scale": 78.38367176906169,
                "output_multiplier_scale": 0.5773502691896257}
TINY_GROK_SOFTCAP = 2.0


def tiny_grok_cfg(softcap: float = TINY_GROK_SOFTCAP):
    import dataclasses

    from neural_speed_tpu_torch.models.configs import grok_arch

    return dataclasses.replace(grok_arch(TINY_GROK_HF), head_dim=128,
                               logit_softcap=softcap)


def check_tiny_grok() -> dict:
    """The tiny grok through `Engine` and `PagedEngine` on the card against
    the CPU at B = 3 (the grouped MoE path) and B = 1 (the single-token
    path) over the default bf16 cache, and at B = 3 over int8 K/V; then
    the tiny llama over int8 K/V with float32 scales through both engines.
    Counts are set to 0 before and read after: the softcap variants of
    kernels B / 10 and C / 9 over bf16 and int8 K/V, kernel 11 and A must
    launch on the card, and the float32-scale instances of B, C, 9 and
    10."""
    from neural_speed_tpu_torch import _build
    from neural_speed_tpu_torch.ops.qtypes import named_qspec

    int4 = named_qspec("int4", 64, scale_dtype="bfloat16")
    _build.reset_counts()
    for paged in (False, True):
        for prompts in (TINY_MOE_PROMPTS, TINY_MOE_PROMPTS[:1]):
            check_tiny_model(
                f"grok{' paged' if paged else ''} B={len(prompts)}", int4,
                None, tiny_grok_cfg(), prompts, kv_quantized=False,
                paged=paged, seed_label="grok")
        check_tiny_model(f"grok int8{' paged' if paged else ''} B=3", int4,
                         None, tiny_grok_cfg(), TINY_MOE_PROMPTS,
                         paged=paged, seed_label="grok")
        check_tiny_model(f"int4 f32 scales{' paged' if paged else ''}", int4,
                         None, kv_scale_dtype=torch.float32, paged=paged,
                         seed_label="int4 f32 scales")
    counts = {k: v for k, v in _build.launches.items() if v}
    need = [f"flash_{k}{p}{s}" for k in ("prefill", "decode")
            for p in ("", "_paged")
            for s in ("_bf16_softcap", "_softcap", "_f32scale")]
    for k in need + ["qmatmul_grouped", "qmatmul"]:
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"tiny grok / float32 scales: {k} was not "
                                 f"launched on the card: {counts}")
    log(f"  tiny grok and float32 scales: launches on the card {counts}")
    return counts


def check_tiny_model(label: str, spec, comp, cfg=None,
                     prompts=TINY_PROMPTS, params_fn=None,
                     kv_quantized: bool = True,
                     kv_dtype=torch.bfloat16, kv_scale_dtype=None,
                     paged: bool = False, seed_label: str = "",
                     kv_append: str = "") -> None:
    """A tiny model through `Engine` (with `paged`, `PagedEngine` at page
    size 16) on the card and on the CPU: params from `synth_params(cfg,
    spec)` or, for a converted checkpoint, from `params_fn(cfg, generator)`
    (drawn on the CPU), seeded per label (or `seed_label`); the int8 cache
    (bf16 scales, or `kv_scale_dtype`), or with `kv_quantized=False` a
    cache of `kv_dtype` values (the default bf16, or float32).  With
    `kv_append`, the engines are built under `NST_KV_APPEND=kv_append`,
    must pin that mode, and under "defer" the card's decode steps must
    launch kernel B (its extra-kv column, then the append)."""
    from neural_speed_tpu_torch import _build
    from neural_speed_tpu_torch.models.arch import ArchConfig
    from neural_speed_tpu_torch.runtime.engine import Engine, PagedEngine
    from neural_speed_tpu_torch.utils.synthetic import synth_params

    seed, checks = TINY_SEEDS[seed_label or label]
    cfg = cfg or ArchConfig(**TINY_CFG)
    if params_fn is None:
        params = synth_params(cfg, spec, seed=seed, device="cpu")
    else:
        params = params_fn(cfg, torch.Generator().manual_seed(seed))
    b = len(prompts)
    make, kw = ((PagedEngine, dict(page_size=16, n_pages=b * 256 // 16))
                if paged else (Engine, {}))
    env = os.environ.get("NST_KV_APPEND")
    if kv_append:
        os.environ["NST_KV_APPEND"] = kv_append
    try:
        eng = {dev: make(params, cfg, max_batch=b, max_len=256,
                         kv_dtype=kv_dtype, kv_quantized=kv_quantized,
                         kv_scale_dtype=kv_scale_dtype, device=dev, comp=comp,
                         **kw)
               for dev in ("cuda", "cpu")}
    finally:
        if kv_append:
            os.environ.pop("NST_KV_APPEND", None)
            if env is not None:
                os.environ["NST_KV_APPEND"] = env
    if kv_append and any(e.cfg.kv_append != kv_append for e in eng.values()):
        raise AssertionError(f"tiny model ({label}): the engines pinned "
                             f"{[e.cfg.kv_append for e in eng.values()]}, "
                             f"not {kv_append!r}")
    logits = {dev: e.prefill(prompts).float().cpu()
              for dev, e in eng.items()}
    active = torch.tensor([True, False, True][:b])
    decode_b = _build.launches["flash_decode"]
    for step in range(checks):
        toks = _hold_tiny(logits, active, f"tiny model ({label}, params seed "
                          f"{seed}) step {step}")
        if step < checks - 1:
            logits = {dev: e.decode(toks, active).float().cpu()
                      for dev, e in eng.items()}
    if kv_append == "defer" and _build.launches["flash_decode"] == decode_b:
        raise AssertionError(f"tiny model ({label}): kernel B did not launch "
                             f"at decode")
    log(f"  tiny model ({label}, params seed {seed}): logits within 2% of the "
        f"largest logit of the CPU plain path and greedy ids equal at all "
        f"{checks} steps (top-2 margin above twice that at each)")


# The paged tiny model holds the int4 configuration's first 5 steps, then
# refills slot 1 and holds 3 more steps of every slot: slots 0 and 2 stay
# within the 9 steps whose margins TINY_SEEDS cleared, and the refill
# prompt is one whose stream keeps clear margins (searched on the CPU).
TINY_PAGED_STEPS = 5
TINY_REFILL = [412, 12, 413, 240, 264, 323, 147, 501, 28, 143, 196, 292, 209,
               67, 24, 1, 25, 77, 511, 98, 334, 384, 120, 145, 223, 135, 498,
               91, 459, 408, 432, 60, 201, 321, 252, 341, 346, 339, 32, 491,
               284, 462, 139, 185, 450, 96]


class _SampleLog:
    """Records the logits and active rows of every `sampling.sample` call
    (copied to the CPU) while installed."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from neural_speed_tpu_torch.ops import sampling as smp

        self._orig = smp.sample

        def sample(logits, state, p, active=None):
            act = (torch.ones(logits.shape[0], dtype=torch.bool)
                   if active is None else active.cpu())
            self.calls.append((logits.float().cpu(), act))
            return self._orig(logits, state, p, active)

        smp.sample = sample
        return self

    def __exit__(self, *exc):
        from neural_speed_tpu_torch.ops import sampling as smp

        smp.sample = self._orig


# The tiny serving check of phase 3: TINY_CFG's llama as a float HF
# checkpoint directory (`write_tiny_llama`, matrices N(0, 0.1^2): at
# synth_hf_state_dict's 0.02 the greedy streams repeat one token), loaded
# and quantized to int4 g64 by `Model().init(dir)`, prompts 0 and 2, greedy
# without the repetition penalty, 8 new tokens each.  The draw's seeds,
# one without and one with the int8 score dot (TINY_SEEDS["tiny hf
# llama"], ["tiny hf llama qk"]), were searched on the CPU for top-2
# margins above twice `_hold_tiny`'s tolerance at every sampling call and
# streams of at least 4 distinct ids (without qk seed 3 was the only one
# of 0-199; with qk 393 the first found).
TINY_HF_LLAMA = dict(model_type="llama", vocab_size=512, hidden_size=512,
                     num_hidden_layers=2, num_attention_heads=8,
                     num_key_value_heads=4, intermediate_size=1408,
                     max_position_embeddings=256, tie_word_embeddings=False)
TINY_HF_INIT = 0.1
TINY_SERVE_PROMPTS = [TINY_PROMPTS[0], TINY_PROMPTS[2]]
TINY_SERVE_NEW = 8


def write_tiny_llama(d: str, seed: int, init: float) -> None:
    """TINY_HF_LLAMA as a local HF checkpoint directory: `config.json` and
    `model.safetensors` (bf16, `synth_hf_state_dict` drawn on the CPU, the
    matrices scaled from N(0, 0.02^2) to N(0, init^2))."""
    from neural_speed_tpu_torch.models.configs import arch_from_hf_config
    from neural_speed_tpu_torch.utils.synthetic import (synth_hf_state_dict,
                                                        write_safetensors)

    sd = synth_hf_state_dict("llama", arch_from_hf_config(TINY_HF_LLAMA),
                             seed=seed, device="cpu")
    sd = {k: (v.float() * (init / 0.02)).to(v.dtype) if v.dim() == 2 else v
          for k, v in sd.items()}
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(TINY_HF_LLAMA, f)
    write_safetensors(os.path.join(d, "model.safetensors"), sd)


def tiny_serving_run(d: str, dev: str, qk: bool) -> tuple:
    """The tiny llama of directory `d` through `Model().init(d)` (on the
    card by default: `dev` "cuda" passes no device) as `generate` over
    `Engine` and `ModelServer` over `PagedEngine` (page size 128), the int8
    cache, with the int8 score dot (`qk`) or without.  Returns (generate's
    ids, the server's ids, generate's sampling calls, the server's sampling
    calls, the launches in the run)."""
    from neural_speed_tpu_torch import _build, api
    from neural_speed_tpu_torch.ops import flash
    from neural_speed_tpu_torch.ops.sampling import SamplingParams

    where = {} if dev == "cuda" else {"device": dev}
    prev = flash.FLASH_INT8_DOT
    flash.FLASH_INT8_DOT = qk
    try:
        before = dict(_build.launches)
        models = {paged: api.Model().init(
            d, weight_dtype="int4", group_size=64, scale_dtype="bf16",
            max_batch=2, ctx_size=256, kv_quantized=True, paged=paged,
            page_size=128, **where) for paged in (False, True)}
        for m in models.values():
            if m.engine.device.type != dev:
                raise AssertionError(f"Model().init built its engine on "
                                     f"{m.engine.device}, not {dev}")
        with _SampleLog() as gen_log:
            out = models[False].generate(
                TINY_SERVE_PROMPTS, max_new_tokens=TINY_SERVE_NEW,
                ignore_prompt=True, repetition_penalty=1.0)
        results = {}
        with _SampleLog() as srv_log:
            with api.ModelServer(
                    models[True], lambda rid, toks: results.update(
                        {rid: list(toks)}),
                    sampling=SamplingParams(do_sample=False,
                                            repetition_penalty=1.0),
                    max_new_tokens=TINY_SERVE_NEW) as srv:
                for p in TINY_SERVE_PROMPTS:
                    srv.issue_query(p)
                srv.join()
        eng = models[True].engine
        if eng._alloc.available != eng.n_pages - 1:
            raise AssertionError(f"tiny api.Model on {dev}: pages left "
                                 f"allocated")
        launches = {k: v - before.get(k, 0) for k, v in
                    _build.launches.items() if v != before.get(k, 0)}
    finally:
        flash.FLASH_INT8_DOT = prev
    return (out, [results[i] for i in range(len(out))], gen_log.calls,
            srv_log.calls, launches)


def check_tiny_serving(qk: bool) -> dict:
    """The tiny llama directory through `Model().init(dir)` on the card and
    `Model().init(dir, device="cpu")` (`tiny_serving_run`), with or without
    the int8 score dot (`qk`): every sampling call's logits are held card
    against CPU by `_hold_tiny`; the ids are equal and the server delivers
    `generate`'s.  Returns the card's launches."""
    import tempfile

    label = f"tiny api.Model ({'qk' if qk else 'qk off'})"
    seed, _ = TINY_SEEDS["tiny hf llama" + (" qk" if qk else "")]
    with tempfile.TemporaryDirectory() as d:
        write_tiny_llama(d, seed, TINY_HF_INIT)
        runs = {dev: tiny_serving_run(d, dev, qk) for dev in ("cuda", "cpu")}
    card, cpu = runs["cuda"], runs["cpu"]
    for part, calls in (("generate", 2), ("ModelServer", 3)):
        if len(card[calls]) != len(cpu[calls]):
            raise AssertionError(f"{label} {part}: {len(card[calls])} "
                                 f"sampling calls on the card, "
                                 f"{len(cpu[calls])} on the CPU")
        for i, ((lg, act), (lc, _)) in enumerate(zip(card[calls],
                                                     cpu[calls])):
            _hold_tiny({"cuda": lg, "cpu": lc}, act,
                       f"{label} {part} sampling call {i}")
    if card[:2] != cpu[:2] or card[0] != card[1]:
        raise AssertionError(f"{label}: ids card {card[:2]} CPU {cpu[:2]}")
    if any(len(g) != TINY_SERVE_NEW for g in card[0]):
        raise AssertionError(f"{label}: budgets not delivered: {card[0]}")
    launches = card[4]
    want = {"qmatmul", "flash_decode_qk", "flash_decode_paged_qk"} if qk else {
        "qmatmul", "flash_decode", "flash_decode_paged"}
    missing = want - set(launches)
    if missing or (not qk and any(k.endswith("_qk") for k in launches)):
        raise AssertionError(f"{label}: card launches {launches}")
    log(f"  {label}: Model().init(dir) on the card (seed {seed}; int4 g64, "
        f"converted and quantized there), generate (Engine) and ModelServer (PagedEngine) "
        f"equal to Model().init(dir, device='cpu'), ids {card[0]}, every "
        f"sampling call held by _hold_tiny; card launches {launches}")
    return launches


def check_tiny_paged(label: str = "int4", kv_quantized: bool = True
                     ) -> None:
    """A tiny `PagedEngine` (page size 16, a pool of 24 pages for 3 slots of
    256 rows) on the card against the same engine on the CPU: the `label`
    configuration's first steps (int4 over the int8 pool; or, with
    `kv_quantized=False`, over the default bf16 pool), then slot 1 is
    released and a new prompt prefilled into the freed, fragmented pages
    (`prepare_prefill` / `run_prefill`, the other slots spectators), then
    3 steps with all three slots live.  Held as `check_tiny_model`."""
    from neural_speed_tpu_torch.models.arch import ArchConfig
    from neural_speed_tpu_torch.ops.qtypes import named_qspec
    from neural_speed_tpu_torch.runtime.engine import PagedEngine
    from neural_speed_tpu_torch.utils.synthetic import synth_params

    seed, checks = TINY_SEEDS[label][0], TINY_PAGED_STEPS
    cfg = ArchConfig(**TINY_CFG)
    params = synth_params(cfg, named_qspec("int4", 64, scale_dtype="bfloat16"),
                          seed=seed, device="cpu")
    eng = {dev: PagedEngine(params, cfg, max_batch=3, max_len=256,
                            kv_quantized=kv_quantized, page_size=16,
                            n_pages=24, device=dev)
           for dev in ("cuda", "cpu")}
    logits = {dev: e.prefill(TINY_PROMPTS).float().cpu()
              for dev, e in eng.items()}
    active = torch.tensor([True, False, True])
    what = (f"tiny paged model ({'int8' if kv_quantized else 'bf16'} pool, "
            f"params seed {seed})")
    for step in range(checks):
        toks = _hold_tiny(logits, active, f"{what} step {step}")
        if step < checks - 1:
            logits = {dev: e.decode(toks, active).float().cpu()
                      for dev, e in eng.items()}
    t = 64
    ids = torch.zeros((3, t), dtype=torch.int32)
    ids[1, :len(TINY_REFILL)] = torch.tensor(TINY_REFILL)
    lens = torch.tensor([0, len(TINY_REFILL), 0], dtype=torch.int32)
    starts = torch.zeros((3,), dtype=torch.int32)
    for e in eng.values():
        e.release_slot(1)
        e.prepare_prefill([1], [len(TINY_REFILL)], starts=starts)
    if not (eng["cuda"]._tables == eng["cpu"]._tables).all():
        raise AssertionError(f"{what}: page tables differ")
    refill = {dev: e.run_prefill(ids, lens, starts).float().cpu()
              for dev, e in eng.items()}
    toks[1] = _hold_tiny(refill, torch.tensor([False, True, False]),
                         f"{what} refill")[1]
    everyone = torch.ones((3,), dtype=torch.bool)
    for step in range(3):
        logits = {dev: e.decode(toks, everyone).float().cpu()
                  for dev, e in eng.items()}
        toks = _hold_tiny(logits, everyone, f"{what} after the refill, step "
                          f"{step}")
    for e in eng.values():
        for slot in range(3):
            e.release_slot(slot)
        if e._alloc.available != e.n_pages - 1:
            raise AssertionError(f"{what}: the pool was not returned")
    log(f"  {what}: {checks} steps, a release and a refill into fragmented "
        f"pages, 3 more steps: logits within 2% of the largest logit of the "
        f"CPU plain path and greedy ids equal at every step")


# ---------------------------------------------------------------------------
# quantized checkpoints drawn from a seed (phases 3 and 8)
# ---------------------------------------------------------------------------

# GPTQ's act-order config (AutoGPTQ v1 layout, int4, g = 128)
GPTQ_HF = {"quantization_config": {"quant_method": "gptq", "bits": 4,
                                   "group_size": 128, "desc_act": True}}


def gptq_params(cfg, gen: torch.Generator, scale: float = 0.01):
    """An act-order GPTQ checkpoint in AutoGPTQ v1 layout drawn on `gen`'s
    device (uniform `qweight` / `qzeros` words, float16 `scales`, a random
    group permutation as `g_idx` per linear; bf16 embedding and head),
    converted by `params_from_quantized_state_dict` on that device."""
    from neural_speed_tpu_torch.convert.gptq import \
        params_from_quantized_state_dict

    dev = gen.device
    h, v = cfg.hidden_size, cfg.vocab_size
    ones = lambda: torch.ones((h,), device=dev)
    words = lambda r, c: torch.randint(-2 ** 31, 2 ** 31, (r, c), generator=gen,
                                       device=dev, dtype=torch.int32)
    sd = {"model.embed_tokens.weight": (torch.randn(
              (v, h), generator=gen, device=dev) * 0.02).to(torch.bfloat16),
          "model.norm.weight": ones(),
          "lm_head.weight": (torch.randn((v, h), generator=gen, device=dev)
                             * 0.02).to(torch.bfloat16)}
    projs = [("self_attn.q_proj", h, cfg.q_dim), ("self_attn.k_proj", h,
             cfg.kv_dim), ("self_attn.v_proj", h, cfg.kv_dim),
             ("self_attn.o_proj", cfg.q_dim, h),
             ("mlp.gate_proj", h, cfg.intermediate_size),
             ("mlp.up_proj", h, cfg.intermediate_size),
             ("mlp.down_proj", cfg.intermediate_size, h)]
    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        sd[pre + "input_layernorm.weight"] = ones()
        sd[pre + "post_attention_layernorm.weight"] = ones()
        for name, k, n in projs:
            sd[pre + name + ".qweight"] = words(k // 8, n)
            sd[pre + name + ".qzeros"] = words(k // 128, n // 8)
            sd[pre + name + ".scales"] = ((torch.rand(
                (k // 128, n), generator=gen, device=dev) + 0.5) * scale).half()
            sd[pre + name + ".g_idx"] = (torch.arange(k, device=dev) // 128)[
                torch.randperm(k, generator=gen, device=dev)].to(torch.int32)
    return params_from_quantized_state_dict(sd, cfg, GPTQ_HF)


def _ggml():
    from neural_speed_tpu_torch.convert import gguf

    return gguf


# ggml block types' float16 fields: (byte offset, magnitude), drawn so that
# the weights are of the order of the int4 models' (|w| up to ~0.1)
GGML_FP16 = {"Q4_0": [(0, 0.01)], "Q8_0": [(0, 6e-4)],
             "Q4_K": [(0, 1e-4), (2, 1e-3)], "Q6_K": [(208, 2e-5)],
             "Q2_K": [(80, 2e-3), (82, 3e-3)]}


def draw_blocks(gen: torch.Generator, ttype: str, rows: int, row_len: int):
    """Block bytes of a ggml tensor [rows, row_len] on `gen`'s device:
    uniform bytes, with each float16 field drawn finite."""
    g = _ggml()
    code = getattr(g, f"GGML_{ttype}")
    be, bb = g.ggml_block_info(code)
    nb = rows * row_len // be
    dev = gen.device
    raw = torch.randint(0, 256, (nb, bb), generator=gen, device=dev,
                        dtype=torch.uint8)
    for off, mag in GGML_FP16[ttype]:
        d = ((torch.rand((nb,), generator=gen, device=dev) + 0.5) * mag).half()
        raw[:, off:off + 2] = d.view(torch.uint8).reshape(nb, 2)
    return raw.reshape(-1)


def gguf_linear(gen, ttype: str, k: int, n: int) -> dict:
    """A linear [K, N] from ggml block bytes drawn on the card or the CPU,
    through `gguf_tensor_to_qtensor` (ggml orientation: N rows of K)."""
    g = _ggml()
    raw = draw_blocks(gen, ttype, n, k)
    return {"w": g.gguf_tensor_to_qtensor(raw, (k, n),
                                          getattr(g, f"GGML_{ttype}"))}


def gguf_params(cfg, gen: torch.Generator, types: dict) -> dict:
    """A llama or mixtral GGUF model drawn as block bytes per tensor and
    decoded on `gen`'s device (`types`: ggml type per role, `attn_q`,
    `attn_k`, `attn_v`, `attn_output`, `ffn_gate`, `ffn_up`, `ffn_down`,
    `output`).  A MoE layer's experts are fused and stacked layer by layer
    (`fuse_params`), so the per-expert packs of one layer at most are live
    beside the stacks."""
    from neural_speed_tpu_torch.models.transformer import fuse_params

    dev = gen.device
    h, inter = cfg.hidden_size, cfg.intermediate_size
    ones = lambda: {"weight": torch.ones((h,), device=dev)}
    p = {"embed": {"weight": (torch.randn((cfg.vocab_size, h), generator=gen,
                                          device=dev) * 0.02).to(
                                              torch.bfloat16)},
         "layers": [], "final_norm": ones(),
         "lm_head": gguf_linear(gen, types["output"], h, cfg.vocab_size)}
    for _ in range(cfg.n_layers):
        lp = {"attn_norm": ones(), "ffn_norm": ones(),
              "q": gguf_linear(gen, types["attn_q"], h, cfg.q_dim),
              "k": gguf_linear(gen, types["attn_k"], h, cfg.kv_dim),
              "v": gguf_linear(gen, types["attn_v"], h, cfg.kv_dim),
              "o": gguf_linear(gen, types["attn_output"], cfg.q_dim, h)}
        ffn = lambda: {"gate": gguf_linear(gen, types["ffn_gate"], h, inter),
                       "up": gguf_linear(gen, types["ffn_up"], h, inter),
                       "down": gguf_linear(gen, types["ffn_down"], inter, h)}
        if cfg.moe is None:
            lp["ffn"] = ffn()
        else:
            n_exp = cfg.moe.num_experts
            lp["moe"] = {"router": {"w": torch.randn(
                (h, n_exp), generator=gen, device=dev) * 0.02},
                "experts": [ffn() for _ in range(n_exp)]}
            lp = fuse_params({"layers": [lp]}, cfg)["layers"][0]
        p["layers"].append(lp)
    return p


LLAMA_GGUF = {
    "Q4_0": dict(attn_q="Q4_0", attn_k="Q4_0", attn_v="Q4_0",
                 attn_output="Q4_0", ffn_gate="Q4_0", ffn_up="Q4_0",
                 ffn_down="Q4_0", output="Q6_K"),
    "Q8_0": dict(attn_q="Q8_0", attn_k="Q8_0", attn_v="Q8_0",
                 attn_output="Q8_0", ffn_gate="Q8_0", ffn_up="Q8_0",
                 ffn_down="Q8_0", output="Q8_0"),
    # llama.cpp's Q4_K_M: Q6_K for attn_v and ffn_down (and the head)
    "Q4_K_M": dict(attn_q="Q4_K", attn_k="Q4_K", attn_v="Q6_K",
                   attn_output="Q4_K", ffn_gate="Q4_K", ffn_up="Q4_K",
                   ffn_down="Q6_K", output="Q6_K"),
    "Q2_K": dict(attn_q="Q2_K", attn_k="Q2_K", attn_v="Q2_K",
                 attn_output="Q2_K", ffn_gate="Q2_K", ffn_up="Q2_K",
                 ffn_down="Q2_K", output="Q6_K"),
}


# The tiny llama of the GGUF checkpoints: an FFN of 1536, a multiple of the
# K-quants' 256-element super-blocks.
TINY_GGUF = dict(TINY_CFG, intermediate_size=1536)


def check_tiny_checkpoints() -> None:
    """Phase 3's converted checkpoints, drawn on the CPU from a seed in
    their published layouts: a GPTQ act-order llama; GGUF llamas as Q4_0,
    Q8_0, Q4_K_M (Q4_K, with Q6_K for attn_v, ffn_down and the head) and
    Q2_K; a tiny Mixtral as GGUF Q4_0 (experts stacked from the per-tensor
    packs) and as nf4.  Each through `Engine` on the card against the
    CPU, held as `check_tiny_model`."""
    from neural_speed_tpu_torch.models.arch import ArchConfig
    from neural_speed_tpu_torch.ops.qtypes import named_qspec

    check_tiny_model("gptq act-order", None, None, ArchConfig(**TINY_CFG),
                     params_fn=gptq_params)
    for name in ("Q4_0", "Q8_0", "Q4_K_M", "Q2_K"):
        check_tiny_model(f"gguf {name}", None, None, ArchConfig(**TINY_GGUF),
                         params_fn=lambda c, g, t=LLAMA_GGUF[name]:
                         gguf_params(c, g, t))
    check_tiny_model("mixtral gguf Q4_0", None, None, tiny_moe_cfg(),
                     TINY_MOE_PROMPTS, params_fn=lambda c, g: gguf_params(
                         c, g, LLAMA_GGUF["Q4_0"]))
    check_tiny_model("mixtral nf4", named_qspec("nf4", 64,
                                                scale_dtype="bfloat16"),
                     None, tiny_moe_cfg(), TINY_MOE_PROMPTS)


# The tiny HF-arch models of phase 3: float checkpoints drawn on the CPU in
# their HF layouts (`synth_hf_state_dict`) and converted by the port's
# `convert/hf.py` to int4 g64.  An MPT of 6 heads (ALiBi with the
# non-power-of-two slopes), a BLOOM (embedding LayerNorm, biases, ALiBi)
# and a Falcon (8 query heads over one KV head: decode through kernel C),
# at head dim 64; a Gemma at head dim 256, a Phi at 80 and a GPT-NeoX at
# 96, the head dims of their full-size models (phase 10).
TINY_HF = {
    "mpt": dict(model_type="mpt", d_model=384, n_heads=6, n_layers=2,
                expansion_ratio=4, max_seq_len=256, vocab_size=512,
                attn_config={"alibi": True}),
    "bloom": dict(model_type="bloom", hidden_size=512, n_head=8, n_layer=2,
                  vocab_size=512),
    "falcon": dict(model_type="falcon", hidden_size=512,
                   num_attention_heads=8, num_hidden_layers=2,
                   vocab_size=512, multi_query=True, parallel_attn=True,
                   alibi=False, new_decoder_architecture=False),
    "gemma": dict(model_type="gemma", hidden_size=512, num_hidden_layers=2,
                  num_attention_heads=4, num_key_value_heads=4,
                  head_dim=256, intermediate_size=1024, vocab_size=512,
                  max_position_embeddings=256),
    "phi": dict(model_type="phi", hidden_size=320, num_hidden_layers=2,
                num_attention_heads=4, partial_rotary_factor=0.4,
                intermediate_size=1280, vocab_size=512,
                max_position_embeddings=256),
    "gpt_neox": dict(model_type="gpt_neox", hidden_size=384,
                     num_hidden_layers=2, num_attention_heads=4,
                     rotary_pct=0.25, intermediate_size=1536, vocab_size=512,
                     max_position_embeddings=256,
                     use_parallel_residual=True),
}


def hf_tiny(model_type: str):
    """(cfg, params_fn) of a tiny HF-arch model for `check_tiny_model`."""
    from neural_speed_tpu_torch.convert.hf import params_from_state_dict
    from neural_speed_tpu_torch.models.configs import arch_from_hf_config
    from neural_speed_tpu_torch.ops.qtypes import named_qspec
    from neural_speed_tpu_torch.utils.synthetic import synth_hf_state_dict

    def params_fn(cfg, gen):
        sd = synth_hf_state_dict(model_type, cfg, seed=gen.initial_seed(),
                                 device="cpu")
        return params_from_state_dict(
            sd, cfg, named_qspec("int4", 64, scale_dtype="bfloat16"),
            device="cpu")

    return arch_from_hf_config(TINY_HF[model_type]), params_fn


def check_tiny_hf() -> None:
    """Phase 3's tiny HF archs: MPT over the default bf16 cache and over
    int8, BLOOM and Falcon over bf16, Gemma (head dim 256), Phi (80) and
    GPT-NeoX (96) over bf16 and Phi over float32, each through `Engine` on
    the card against the CPU (`check_tiny_model`); then the tiny llama
    through a bf16 `PagedEngine`, a release and a refill
    (`check_tiny_paged`)."""
    for label, mt, kv in (("mpt bf16", "mpt", "bf16"),
                          ("mpt int8", "mpt", "int8"),
                          ("bloom bf16", "bloom", "bf16"),
                          ("falcon bf16", "falcon", "bf16"),
                          ("gemma bf16", "gemma", "bf16"),
                          ("phi bf16", "phi", "bf16"),
                          ("gpt_neox bf16", "gpt_neox", "bf16"),
                          ("phi f32", "phi", "f32")):
        cfg, params_fn = hf_tiny(mt)
        check_tiny_model(label, None, None, cfg, params_fn=params_fn,
                         kv_quantized=kv == "int8",
                         kv_dtype=KV_DTYPES.get(kv, torch.bfloat16))
    check_tiny_paged("int4 paged bf16", kv_quantized=False)


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------


def params_7b():
    """The Llama-2-7B-shaped int4 model (g = 128, bf16 scales, random
    weights from seed 0), fused, on the card: phases 4 and 6 share it."""
    from neural_speed_tpu_torch.models.transformer import fuse_params
    from neural_speed_tpu_torch.ops.qtypes import QSpec, QType
    from neural_speed_tpu_torch.utils.synthetic import (llama2_7b_arch,
                                                        synth_params)

    cfg = llama2_7b_arch()
    spec = QSpec(QType.INT, 4, 128, True, scale_dtype="bfloat16")
    t0 = time.time()
    params = fuse_params(synth_params(cfg, spec, seed=0), cfg)
    torch.cuda.synchronize()
    log(f"  7B-shaped params ({cfg.n_layers} layers) on the card in "
        f"{time.time() - t0:.1f} s")
    return params, cfg


# The four ragged requests of phases 4 and 6: prompt lengths and budgets.
RAGGED_LENS = [1975, 900, 300, 37]
RAGGED_BUDGETS = [24, 8, 16, 4]


def serve_ragged(eng, prompts, what: str) -> dict:
    """Prefill the ragged requests, then greedy steps (`eng.decode`) until
    every budget is spent; slots go idle at different steps.  Returns the
    ids, every step's logits (kept on the card) and the times."""
    budgets = RAGGED_BUDGETS
    torch.cuda.synchronize()
    t0 = time.time()
    logits = eng.prefill(prompts)
    torch.cuda.synchronize()
    ttft = time.time() - t0
    if logits.shape != (4, eng.cfg.vocab_size) or not torch.isfinite(
            logits).all():
        raise AssertionError(f"{what} prefill: bad logits")
    all_logits = [logits]
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
            raise AssertionError(f"{what} decode: non-finite logits")
        all_logits.append(logits)
        tok = logits.argmax(-1).to(torch.int32)
        for i in range(4):
            if active[i]:
                out[i].append(int(tok[i]))
        steps += 1
    torch.cuda.synchronize()
    decode_s = time.time() - t0
    lengths = eng.cache.lengths.tolist()
    want = [n + b - 1 for n, b in zip(RAGGED_LENS, budgets)]
    if lengths != want:
        raise AssertionError(f"{what}: cache lengths {lengths} != {want}")
    return dict(ids=out, logits=all_logits, ttft_s=ttft, decode_s=decode_s,
                steps=steps)


def serve_7b(params, cfg, profile: bool):
    """Phase 4.  Returns the summary and, for phase 6, the ragged run's
    prompts, ids and logits and the bench shape's prompt."""
    from neural_speed_tpu_torch import _build
    from neural_speed_tpu_torch.ops import kv_cache as kvc
    from neural_speed_tpu_torch.runtime.engine import (Engine, decode_n_steps,
                                                       prefill_step)

    eng = Engine(params, cfg, max_batch=4, max_len=2048, kv_quantized=True,
                 fuse=False)

    # four ragged requests; slots go idle at different steps
    _build.reset_counts()
    lens, budgets = RAGGED_LENS, RAGGED_BUDGETS
    gen = torch.Generator().manual_seed(0)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in lens]
    ragged = serve_ragged(eng, prompts, "ragged")
    ttft4, ragged_decode_s, steps = (ragged["ttft_s"], ragged["decode_s"],
                                     ragged["steps"])
    ragged_counts = dict(_build.launches)
    log(f"  ragged: 4 requests (prompts {lens}, budgets {budgets}) prefill "
        f"{ttft4 * 1e3:.1f} ms, {steps} decode steps in "
        f"{ragged_decode_s * 1e3:.1f} ms; launches {ragged_counts}")

    # the bench shape: B = 1, a 1975-token prefill, 64 greedy steps
    cache = kvc.init_cache(cfg.n_layers, 1, 2048, cfg.n_kv_heads,
                           cfg.head_dim, quantized=True)
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
    return res, dict(prompts=prompts, ragged=ragged, bench_ids=ids)


# ---------------------------------------------------------------------------
# phase 5: the formats path, full width and depth
# ---------------------------------------------------------------------------


def weight_bytes(node) -> int:
    """Bytes of a params tree on the card (packed planes, scales, zeros and
    dense tensors)."""
    if hasattr(node, "nbytes") and callable(node.nbytes):
        return node.nbytes()
    if isinstance(node, dict):
        return sum(weight_bytes(v) for v in node.values())
    if isinstance(node, list):
        return sum(weight_bytes(v) for v in node)
    return node.numel() * node.element_size()


def serve_7b_formats() -> dict:
    """The 32-layer Llama-2-7B-shaped model through `Engine`, B = 1, a
    1975-token prefill and 32 greedy steps, once per weight format.  Counts
    are set to 0 just before each configuration is driven and read just
    after."""
    from neural_speed_tpu_torch import _build
    from neural_speed_tpu_torch.runtime.engine import Engine, decode_n_steps
    from neural_speed_tpu_torch.utils.synthetic import (llama2_7b_arch,
                                                        synth_params)

    cfg = llama2_7b_arch()
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (1975,), generator=gen).tolist()
    n_steps = 32
    results = {}

    for label, make_spec, comp, prefill_kernels, decode_kernels in \
            format_configs():
        eng = Engine(synth_params(cfg, make_spec(128), seed=0), cfg,
                     max_batch=1, max_len=2048, kv_quantized=True, comp=comp)
        nbytes = weight_bytes(eng.params)
        eng.prefill([prompt[:40]])                    # warm: first launches
        _build.reset_counts()
        torch.cuda.synchronize()
        t0 = time.time()
        logits = eng.prefill([prompt])
        torch.cuda.synchronize()
        ttft = time.time() - t0
        prefill_counts = dict(_build.launches)
        if logits.shape != (1, cfg.vocab_size) or not torch.isfinite(
                logits).all():
            raise AssertionError(f"{label}: bad prefill logits")
        tok = logits.argmax(-1).to(torch.int32)
        on = torch.ones((1,), dtype=torch.bool, device="cuda")
        t0 = time.time()
        toks, eng.cache = decode_n_steps(eng.params, eng.cfg, eng.cache, tok,
                                         on, n_steps, eng.comp)
        torch.cuda.synchronize()
        dt = time.time() - t0
        counts = dict(_build.launches)
        logits = eng.decode(toks[:, -1], on)          # one more, for its logits
        decode_counts = {k: v - prefill_counts.get(k, 0)
                         for k, v in counts.items()}
        if not torch.isfinite(logits).all() or not (
                (toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"{label}: bad decode logits or ids")
        if eng.cache.lengths.tolist() != [1975 + n_steps + 1]:
            raise AssertionError(f"{label}: cache length "
                                 f"{eng.cache.lengths.tolist()}")
        for part, have, need in (("prefill", prefill_counts, prefill_kernels),
                                 ("decode", decode_counts, decode_kernels)):
            matmuls = {k for k, v in have.items()
                       if k.startswith("qmatmul") and v > 0}
            if matmuls != set(need):
                raise AssertionError(f"{label}: {part} launched {have}, "
                                     f"expected the matmul kernels {need}")
        for k in ("flash_prefill",):
            if prefill_counts.get(k, 0) <= 0:
                raise AssertionError(f"{label}: {k} was not launched")
        if decode_counts.get("flash_decode", 0) <= 0:
            raise AssertionError(f"{label}: flash_decode was not launched")
        if sum(_build.plain_dispatches.values()):
            raise AssertionError(f"{label}: a plain version ran: "
                                 f"{dict(_build.plain_dispatches)}")
        log(f"  {label}: weights {nbytes / 2 ** 30:.3f} GiB on the card; TTFT "
            f"{ttft * 1e3:.2f} ms (1975 tokens, B=1); decode "
            f"{dt / n_steps * 1e3:.3f} ms/token over {n_steps} steps; launches "
            f"per prefill {prefill_counts}, per {n_steps} decode steps "
            f"{decode_counts}; plain dispatches 0")
        results[label] = dict(weight_bytes=nbytes, ttft_ms=ttft * 1e3,
                              decode_ms_per_token=dt / n_steps * 1e3,
                              prefill_counts=prefill_counts,
                              decode_counts=decode_counts)
        del eng
        torch.cuda.empty_cache()
    return results


# ---------------------------------------------------------------------------
# phase 6: paged serving, full width and depth
# ---------------------------------------------------------------------------


def _serve_windows(params, cfg, prompts, sp, seed: int, width: int = 8):
    """The ragged requests as a continuous-batching scheduler drives a
    paged engine: `prepare_prefill` / `run_prefill`, the first token sampled
    from the prefill logits, then windows of `width` steps
    (`prepare_decode(active, width)` -> `run_decode_window` ->
    `commit_lens`) until every budget is spent.  Returns the ids, the
    number of windows, the decode seconds and the engine's final lengths."""
    import numpy as np

    from neural_speed_tpu_torch.ops import sampling as smp
    from neural_speed_tpu_torch.runtime.engine import PagedEngine

    eng = PagedEngine(params, cfg, max_batch=4, max_len=2048,
                      kv_quantized=True, page_size=128, n_pages=40, fuse=False)
    lens = np.array(RAGGED_LENS, np.int32)
    budgets = np.array(RAGGED_BUDGETS)
    ids = torch.zeros((4, 2048), dtype=torch.int32)
    st = smp.init_state(seed, 4, cfg.vocab_size, window=sp.penalty_window,
                        tau=sp.mirostat_tau)
    for i, p in enumerate(prompts):
        ids[i, :len(p)] = torch.tensor(p, dtype=torch.int32)
        st = smp.observe_prompt_slot(st, i, p)
    starts = np.zeros((4,), np.int32)
    eng.prepare_prefill(range(4), lens, starts=starts)
    logits = eng.run_prefill(ids, torch.from_numpy(lens),
                             torch.from_numpy(starts))
    last, st = smp.sample(logits, st, sp)
    out = [[int(x)] for x in last.tolist()]
    slot_len = lens.astype(np.int64)
    windows = 0
    torch.cuda.synchronize()
    t0 = time.time()
    while True:
        active = np.array([len(o) < b for o, b in zip(out, budgets)])
        if not active.any():
            break
        rem = np.where(active, budgets - np.array([len(o) for o in out]), 0)
        eng.prepare_decode(active, width)
        buf, em, last, _act, _bud, st = eng.run_decode_window(
            st, last, torch.from_numpy(active),
            torch.from_numpy(rem.astype(np.int32)), width, width, sp, None)
        em, buf = em.cpu().numpy(), buf.cpu().numpy()
        for slot in np.nonzero(active)[0]:
            out[slot] += buf[slot, :em[slot]].tolist()
        slot_len += np.where(active, em, 0)
        eng.commit_lens(slot_len)
        windows += 1
    torch.cuda.synchronize()
    decode_s = time.time() - t0
    lengths = eng.cache.lengths.tolist()
    for slot in range(4):
        eng.release_slot(slot)
    if eng._alloc.available != eng.n_pages - 1:
        raise AssertionError("windows: the pool was not returned")
    return out, windows, decode_s, lengths


def serve_7b_paged(params, cfg, ref: dict, profile: bool) -> dict:
    """Phase 6: the phase-4 model through `PagedEngine` (page size 128).
    (a) the ragged requests step by step on a 40-page pool (4 x 2048 / 128
    = 64 pages would hold every slot's full length), held bit for bit
    against phase 4's logits and ids; (b) the bench shape; (c) the ragged
    requests through decode windows, greedy (ids equal to (a)) and sampled
    with the default `SamplingParams` (ids in range, each request's budget
    emitted, lengths as expected)."""
    import numpy as np

    from neural_speed_tpu_torch import _build
    from neural_speed_tpu_torch.ops import kv_cache as kvc
    from neural_speed_tpu_torch.ops import sampling as smp
    from neural_speed_tpu_torch.runtime.engine import (PagedEngine,
                                                       decode_n_steps,
                                                       prefill_step)

    res = {}
    # (a) the ragged requests, each step through eng.decode (one table
    # upload per step)
    eng = PagedEngine(params, cfg, max_batch=4, max_len=2048,
                      kv_quantized=True, page_size=128, n_pages=40, fuse=False)
    got = serve_ragged(eng, ref["prompts"], "paged ragged")
    want = ref["ragged"]
    if got["ids"] != want["ids"]:
        raise AssertionError(f"paged ragged: ids {got['ids']} differ from "
                             f"phase 4's {want['ids']}")
    for step, (a, b) in enumerate(zip(got["logits"], want["logits"])):
        if not torch.equal(a, b):
            raise AssertionError(
                f"paged ragged step {step}: logits differ from phase 4's by "
                f"up to {(a - b).abs().max().item()}")
    pages = eng.n_pages - 1 - eng._alloc.available
    for slot in range(4):
        eng.release_slot(slot)
    if eng._alloc.available != eng.n_pages - 1:
        raise AssertionError("paged ragged: the pool was not returned")
    del eng
    res["ragged"] = dict(prefill_ms=got["ttft_s"] * 1e3,
                         decode_ms=got["decode_s"] * 1e3, steps=got["steps"],
                         pages_used=pages)
    log(f"  (a) ragged: prefill {got['ttft_s'] * 1e3:.1f} ms, {got['steps']} "
        f"decode steps in {got['decode_s'] * 1e3:.1f} ms on {pages} of 40 "
        f"pages; logits of the prefill and of all {got['steps']} steps equal "
        f"phase 4's bit for bit, ids equal; the pool returned in full")

    # (b) the bench shape: B = 1, a 1975-token prefill, 64 greedy steps
    eng = PagedEngine(params, cfg, max_batch=1, max_len=2048,
                      kv_quantized=True, page_size=128, n_pages=16, fuse=False)
    prompt = ref["bench_ids"][0, :1975].tolist()
    eng.prefill([prompt])                                   # warm
    eng.release_slot(0)
    before = dict(_build.launches)
    torch.cuda.synchronize()
    t0 = time.time()
    logits = eng.prefill([prompt])
    torch.cuda.synchronize()
    ttft = time.time() - t0
    per_prefill = {k: v - before.get(k, 0) for k, v in _build.launches.items()
                   if v - before.get(k, 0)}
    tok = logits.argmax(-1).to(torch.int32)
    on = torch.ones((1,), dtype=torch.bool, device="cuda")
    lens1 = torch.tensor([1975], dtype=torch.int32, device="cuda")
    n_steps = 64
    # the pages of all 64 steps are claimed up front, as a decode window's
    # are; the warm steps roll back
    eng.prepare_decode(np.array([True]), n_steps)
    decode_n_steps(params, eng.cfg, eng.cache, tok, on, 4)  # warm
    kvc.set_lengths(eng.cache, lens1)
    before = dict(_build.launches)
    torch.cuda.synchronize()
    t0 = time.time()
    toks, _ = decode_n_steps(params, eng.cfg, eng.cache, tok, on, n_steps)
    torch.cuda.synchronize()
    dt = time.time() - t0
    per_step = {k: (v - before.get(k, 0)) / n_steps
                for k, v in _build.launches.items() if v - before.get(k, 0)}
    if toks.shape != (1, n_steps) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError("paged bench decode: bad token ids")
    if eng.cache.lengths.tolist() != [1975 + n_steps]:
        raise AssertionError(f"paged bench: cache length "
                             f"{eng.cache.lengths.tolist()}")
    res["bench"] = dict(ttft_ms=ttft * 1e3,
                        decode_ms_per_token=dt / n_steps * 1e3,
                        launches_per_prefill=per_prefill,
                        launches_per_decode_step=per_step)
    log(f"  (b) bench shape: TTFT {ttft * 1e3:.2f} ms (1975 tokens, B=1); "
        f"decode {dt / n_steps * 1e3:.3f} ms/token over {n_steps} steps; "
        f"launches per prefill {per_prefill}, per decode step {per_step}")
    if profile:
        kvc.set_lengths(eng.cache, lens1)
        res["profile_decode"] = profile_window(
            lambda: decode_n_steps(params, eng.cfg, eng.cache, tok, on, 8),
            "decode_paged", 8)
        zero = torch.zeros((1,), dtype=torch.int32, device="cuda")
        res["profile_prefill"] = profile_window(
            lambda: prefill_step(params, eng.cfg, eng.cache,
                                 ref["bench_ids"], lens1, zero),
            "prefill_paged", 1)
    del eng

    # (c) decode windows of 8 steps, greedy and then sampled
    greedy = smp.SamplingParams(do_sample=False, repetition_penalty=1.0)
    want_len = [n + b - 1 for n, b in zip(RAGGED_LENS, RAGGED_BUDGETS)]
    for label, sp in (("greedy", greedy), ("sampled", smp.SamplingParams())):
        ids, windows, decode_s, lengths = _serve_windows(
            params, cfg, ref["prompts"], sp, seed=0)
        if label == "greedy" and ids != want["ids"]:
            raise AssertionError(f"windows (greedy): ids {ids} differ from "
                                 f"the step-by-step run's {want['ids']}")
        if [len(x) for x in ids] != RAGGED_BUDGETS or not all(
                0 <= i < cfg.vocab_size for x in ids for i in x):
            raise AssertionError(f"windows ({label}): ids {ids}")
        if lengths != want_len:
            raise AssertionError(f"windows ({label}): cache lengths "
                                 f"{lengths} != {want_len}")
        res[f"windows_{label}"] = dict(windows=windows,
                                       decode_ms=decode_s * 1e3)
        log(f"  (c) windows of 8 ({label}{', ' + repr(sp) if label == 'sampled' else ''}): "
            f"{windows} windows in {decode_s * 1e3:.1f} ms; every request "
            f"emitted its budget, lengths {lengths}"
            + ("; ids equal (a)'s" if label == "greedy" else ""))
    return res


# ---------------------------------------------------------------------------
# phase 7: Mixtral-8x7B serving, full width and depth
# ---------------------------------------------------------------------------


def _moe_without_sync(step, n_layers: int, what: str) -> None:
    """Run `step()` with every `moe_ffn` call under
    `torch.cuda.set_sync_debug_mode("error")`: an operation in the MoE
    layer that synchronises the host raises.  The rest of the step (table
    uploads, the argmax) runs in the default mode."""
    from neural_speed_tpu_torch.models import transformer

    inner = transformer.moe_ffn
    calls = []

    def checked(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return inner(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            calls.append(1)

    transformer.moe_ffn = checked
    try:
        step()
        torch.cuda.synchronize()
    except RuntimeError as e:
        raise AssertionError(f"{what}: the MoE layer synchronised the host: "
                             f"{e}") from e
    finally:
        transformer.moe_ffn = inner
    if len(calls) != n_layers:
        raise AssertionError(f"{what}: {len(calls)} MoE calls checked, not "
                             f"{n_layers}")
    log(f"  {what}: {len(calls)} moe_ffn calls under sync debug mode "
        f"\"error\", none synchronised")


def serve_mixtral(profile: bool) -> dict:
    """Phase 7: a Mixtral-8x7B-shaped int4 model (g = 128, bf16 scales,
    32 layers at full width, 8 experts top-2, random weights from seed 0
    drawn on the card).  (a) the four ragged requests through `Engine`;
    (b) the bench shape, B = 1: a 1975-token prefill and 64 greedy steps,
    where every MoE layer takes the single-token path; (c) (a) through
    `PagedEngine` at page size 128, every logit equal to (a)'s bit for bit.
    The MoE layers of one B = 4 step of (a) and one step of (b) run under
    the sync check.  Counts are set to 0 just before each part is driven
    and read just after."""
    from neural_speed_tpu_torch import _build
    from neural_speed_tpu_torch.models.transformer import fuse_params
    from neural_speed_tpu_torch.ops import kv_cache as kvc
    from neural_speed_tpu_torch.ops.qtypes import named_qspec
    from neural_speed_tpu_torch.runtime.engine import (Engine, PagedEngine,
                                                       decode_n_steps,
                                                       prefill_step)
    from neural_speed_tpu_torch.utils.synthetic import (mixtral_8x7b_arch,
                                                        synth_params)

    cfg = mixtral_8x7b_arch()
    spec = named_qspec("int4", 128, scale_dtype="bfloat16")
    t0 = time.time()
    params = fuse_params(synth_params(cfg, spec, seed=0), cfg)
    torch.cuda.synchronize()
    nbytes = weight_bytes(params)
    log(f"  Mixtral-8x7B-shaped params ({cfg.n_layers} layers, "
        f"{cfg.moe.num_experts} experts) on the card in "
        f"{time.time() - t0:.1f} s: weights {nbytes / 2 ** 30:.3f} GiB")
    res = dict(weight_bytes=nbytes)

    def must_launch(counts, names, what):
        for k in names:
            if counts.get(k, 0) <= 0:
                raise AssertionError(f"{what}: {k} was not launched: {counts}")
        if sum(_build.plain_dispatches.values()):
            raise AssertionError(f"{what}: a plain version ran: "
                                 f"{dict(_build.plain_dispatches)}")

    # (a) the ragged requests through Engine
    eng = Engine(params, cfg, max_batch=4, max_len=2048, kv_quantized=True,
                 fuse=False)
    gen = torch.Generator().manual_seed(0)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in RAGGED_LENS]
    _build.reset_counts()
    ragged = serve_ragged(eng, prompts, "mixtral ragged")
    counts = dict(_build.launches)
    must_launch(counts, ("qmatmul", "qmatmul_grouped", "flash_prefill",
                         "flash_decode"), "mixtral ragged")
    res["ragged"] = dict(prefill_ms=ragged["ttft_s"] * 1e3,
                         decode_ms=ragged["decode_s"] * 1e3,
                         steps=ragged["steps"], launches=counts)
    log(f"  (a) ragged: 4 requests (prompts {RAGGED_LENS}, budgets "
        f"{RAGGED_BUDGETS}) prefill {ragged['ttft_s'] * 1e3:.1f} ms, "
        f"{ragged['steps']} decode steps in {ragged['decode_s'] * 1e3:.1f} ms;"
        f" launches {counts}")
    everyone = torch.ones((4,), dtype=torch.bool)
    tok = ragged["logits"][-1].argmax(-1).to(torch.int32)
    _moe_without_sync(lambda: eng.decode(tok, everyone), cfg.n_layers,
                      "(a) one B = 4 decode step")
    del eng
    torch.cuda.empty_cache()

    # (b) the bench shape: B = 1, a 1975-token prefill, 64 greedy steps
    cache = kvc.init_cache(cfg.n_layers, 1, 2048, cfg.n_kv_heads,
                           cfg.head_dim, quantized=True)
    ids = torch.randint(0, cfg.vocab_size, (1, 2048), generator=gen).to(
        torch.int32).cuda()
    lens1 = torch.tensor([1975], dtype=torch.int32, device="cuda")
    start = torch.zeros((1,), dtype=torch.int32, device="cuda")
    prefill_step(params, cfg, cache, ids, lens1, start)          # warm
    kvc.set_lengths(cache, start)
    _build.reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    logits, cache = prefill_step(params, cfg, cache, ids, lens1, start)
    torch.cuda.synchronize()
    ttft = time.time() - t0
    per_prefill = dict(_build.launches)
    must_launch(per_prefill, ("qmatmul", "qmatmul_grouped", "flash_prefill"),
                "mixtral bench prefill")
    if not torch.isfinite(logits).all():
        raise AssertionError("mixtral bench prefill: non-finite logits")
    tok = logits.argmax(-1).to(torch.int32)
    on = torch.ones((1,), dtype=torch.bool, device="cuda")
    decode_n_steps(params, cfg, cache, tok, on, 4)                # warm
    kvc.set_lengths(cache, lens1)
    n_steps = 64
    _build.reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    toks, cache = decode_n_steps(params, cfg, cache, tok, on, n_steps)
    torch.cuda.synchronize()
    dt = time.time() - t0
    per_step = {k: v / n_steps for k, v in _build.launches.items()}
    must_launch(per_step, ("qmatmul", "qmatmul_grouped", "flash_decode"),
                "mixtral bench decode")
    if toks.shape != (1, n_steps) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError("mixtral bench decode: bad token ids")
    if cache.lengths.tolist() != [1975 + n_steps]:
        raise AssertionError(f"mixtral bench: cache length "
                             f"{cache.lengths.tolist()}")
    res["bench"] = dict(ttft_ms=ttft * 1e3,
                        decode_ms_per_token=dt / n_steps * 1e3,
                        launches_per_prefill=per_prefill,
                        launches_per_decode_step=per_step)
    log(f"  (b) bench shape: TTFT {ttft * 1e3:.2f} ms (1975 tokens, B=1); "
        f"decode {dt / n_steps * 1e3:.3f} ms/token over {n_steps} steps; "
        f"launches per prefill {per_prefill}, per decode step {per_step}")
    _moe_without_sync(
        lambda: decode_n_steps(params, cfg, cache, toks[:, -1], on, 1),
        cfg.n_layers, "(b) one B = 1 decode step")
    if profile:
        kvc.set_lengths(cache, lens1)
        res["profile_decode"] = profile_window(
            lambda: decode_n_steps(params, cfg, cache, tok, on, 8),
            "decode_mixtral", 8)
        res["profile_prefill"] = profile_window(
            lambda: prefill_step(params, cfg, cache, ids, lens1, start),
            "prefill_mixtral", 1)
    del cache
    torch.cuda.empty_cache()

    # (c) (a) through PagedEngine, page size 128
    eng = PagedEngine(params, cfg, max_batch=4, max_len=2048,
                      kv_quantized=True, page_size=128, n_pages=40, fuse=False)
    _build.reset_counts()
    got = serve_ragged(eng, prompts, "mixtral paged ragged")
    counts = dict(_build.launches)
    must_launch(counts, ("qmatmul", "qmatmul_grouped", "flash_prefill_paged",
                         "flash_decode_paged"), "mixtral paged ragged")
    if got["ids"] != ragged["ids"]:
        raise AssertionError(f"mixtral paged ragged: ids {got['ids']} differ "
                             f"from (a)'s {ragged['ids']}")
    for step, (a, b) in enumerate(zip(got["logits"], ragged["logits"])):
        if not torch.equal(a, b):
            raise AssertionError(
                f"mixtral paged ragged step {step}: logits differ from (a)'s "
                f"by up to {(a - b).abs().max().item()}")
    for slot in range(4):
        eng.release_slot(slot)
    if eng._alloc.available != eng.n_pages - 1:
        raise AssertionError("mixtral paged ragged: the pool was not returned")
    res["paged_ragged"] = dict(prefill_ms=got["ttft_s"] * 1e3,
                               decode_ms=got["decode_s"] * 1e3,
                               steps=got["steps"], launches=counts)
    log(f"  (c) paged ragged: prefill {got['ttft_s'] * 1e3:.1f} ms, "
        f"{got['steps']} decode steps in {got['decode_s'] * 1e3:.1f} ms; "
        f"logits of the prefill and of all {got['steps']} steps equal (a)'s "
        f"bit for bit, ids equal; launches {counts}")
    return res


# ---------------------------------------------------------------------------
# phase 8: quantized checkpoints, full width and depth
# ---------------------------------------------------------------------------


def _bench_engine(label: str, eng, prompt, n_steps: int, prefill_kernels,
                  decode_kernels, sync_moe: bool = False,
                  profile: str = "",
                  attention=("flash_prefill", "flash_decode")) -> dict:
    """The bench shape through `eng` (B = 1): a warm prefill, the timed
    1975-token prefill, `n_steps` greedy steps (`decode_n_steps`).  The
    matmul kernels launched at prefill and at decode must be exactly the
    expected ones, the `attention` kernels (prefill's, decode's) must
    launch and no plain version may run.  Counts are set to 0 just before the timed prefill and read
    just after the decode steps.  With `profile` (a file label),
    torch.profiler then traces one prefill and 8 decode steps."""
    from neural_speed_tpu_torch import _build
    from neural_speed_tpu_torch.runtime.engine import decode_n_steps

    cfg = eng.cfg
    eng.prefill([prompt[:40]])                    # warm: first launches
    _build.reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    logits = eng.prefill([prompt])
    torch.cuda.synchronize()
    ttft = time.time() - t0
    prefill_counts = dict(_build.launches)
    prefill_instances = dict(_build.instance_launches)
    if logits.shape != (1, cfg.vocab_size) or not torch.isfinite(
            logits).all():
        raise AssertionError(f"{label}: bad prefill logits")
    tok = logits.argmax(-1).to(torch.int32)
    on = torch.ones((1,), dtype=torch.bool, device="cuda")
    t0 = time.time()
    toks, eng.cache = decode_n_steps(eng.params, eng.cfg, eng.cache, tok, on,
                                     n_steps, eng.comp)
    torch.cuda.synchronize()
    dt = time.time() - t0
    counts = dict(_build.launches)
    decode_counts = {k: v - prefill_counts.get(k, 0) for k, v in
                     counts.items()}
    decode_instances = {k: v - prefill_instances.get(k, 0) for k, v in
                        _build.instance_launches.items()}
    if sync_moe:
        _moe_without_sync(lambda: eng.decode(toks[:, -1], on), cfg.n_layers,
                          f"{label}: one B = 1 decode step")
    logits = eng.decode(toks[:, -1], on)          # one more, for its logits
    if not torch.isfinite(logits).all() or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"{label}: bad decode logits or ids")
    for part, have, need in (("prefill", prefill_counts, prefill_kernels),
                             ("decode", decode_counts, decode_kernels)):
        matmuls = {k for k, v in have.items()
                   if k.startswith("qmatmul") and v > 0}
        if matmuls != set(need):
            raise AssertionError(f"{label}: {part} launched {have}, "
                                 f"expected the matmul kernels {need}")
    if prefill_counts.get(attention[0], 0) <= 0 or decode_counts.get(
            attention[1], 0) <= 0:
        raise AssertionError(f"{label}: an attention kernel was not "
                             f"launched: {prefill_counts} {decode_counts}")
    if sum(_build.plain_dispatches.values()):
        raise AssertionError(f"{label}: a plain version ran: "
                             f"{dict(_build.plain_dispatches)}")
    nbytes = weight_bytes(eng.params)
    log(f"  {label}: weights {nbytes / 2 ** 30:.3f} GiB; TTFT "
        f"{ttft * 1e3:.2f} ms (1975 tokens, B=1); decode "
        f"{dt / n_steps * 1e3:.3f} ms/token over {n_steps} steps; launches "
        f"per prefill {prefill_counts}, per {n_steps} decode steps "
        f"{decode_counts}; attention launches per head-dim instance: "
        f"prefill {prefill_instances}, decode {decode_instances}; plain "
        f"dispatches 0")
    res = dict(weight_bytes=nbytes, ttft_ms=ttft * 1e3,
               decode_ms_per_token=dt / n_steps * 1e3,
               prefill_counts=prefill_counts, decode_counts=decode_counts,
               prefill_instances=prefill_instances,
               decode_instances=decode_instances)
    if profile:
        res["profile_decode"] = profile_window(
            lambda: decode_n_steps(eng.params, eng.cfg, eng.cache,
                                   toks[:, -1], on, 8, eng.comp),
            f"decode_{profile}", 8)
        res["profile_prefill"] = profile_window(
            lambda: eng.prefill([prompt]), f"prefill_{profile}", 1)
    return res


def _ragged_equal(label: str, params, cfg, prompts, need,
                  kv_quantized: bool = True,
                  kv_dtype=torch.bfloat16, kv_scale_dtype=None) -> dict:
    """The four ragged requests through `Engine`, then through
    `PagedEngine` (page size 128, 40 pages), every logit equal bit for bit;
    `need`: the kernels that must launch; the int8 cache (bf16 scales, or
    `kv_scale_dtype`), or with `kv_quantized=False` a cache of `kv_dtype`
    values (the default bf16, or float32)."""
    from neural_speed_tpu_torch import _build
    from neural_speed_tpu_torch.runtime.engine import Engine, PagedEngine

    out = {}
    runs = {}
    kw = dict(max_batch=4, max_len=2048, kv_dtype=kv_dtype,
              kv_quantized=kv_quantized, kv_scale_dtype=kv_scale_dtype,
              fuse=False)
    for name, make in (("Engine", lambda: Engine(params, cfg, **kw)),
                       ("PagedEngine", lambda: PagedEngine(
                           params, cfg, page_size=128, n_pages=40, **kw))):
        eng = make()
        _build.reset_counts()
        runs[name] = serve_ragged(eng, prompts, f"{label} {name} ragged")
        counts = dict(_build.launches)
        for k in need:
            if counts.get(k, 0) <= 0:
                raise AssertionError(f"{label} {name} ragged: {k} was not "
                                     f"launched: {counts}")
        if sum(_build.plain_dispatches.values()):
            raise AssertionError(f"{label} {name}: a plain version ran")
        out[name] = dict(prefill_ms=runs[name]["ttft_s"] * 1e3,
                         decode_ms=runs[name]["decode_s"] * 1e3,
                         steps=runs[name]["steps"], launches=counts,
                         instances=dict(_build.instance_launches))
        if name == "PagedEngine":
            for slot in range(4):
                eng.release_slot(slot)
        del eng
        torch.cuda.empty_cache()
    a, b = runs["Engine"], runs["PagedEngine"]
    if a["ids"] != b["ids"]:
        raise AssertionError(f"{label}: PagedEngine's ids {b['ids']} differ "
                             f"from Engine's {a['ids']}")
    for step, (x, y) in enumerate(zip(a["logits"], b["logits"])):
        if not torch.equal(x, y):
            raise AssertionError(
                f"{label} ragged step {step}: PagedEngine's logits differ "
                f"from Engine's by up to {(x - y).abs().max().item()}")
    log(f"  {label} ragged (prompts {RAGGED_LENS}, budgets "
        f"{RAGGED_BUDGETS}): Engine prefill {out['Engine']['prefill_ms']:.1f}"
        f" ms, {a['steps']} steps in {out['Engine']['decode_ms']:.1f} ms; "
        f"PagedEngine {out['PagedEngine']['prefill_ms']:.1f} ms, "
        f"{out['PagedEngine']['decode_ms']:.1f} ms; every logit of the "
        f"prefill and of all {a['steps']} steps equal bit for bit; launches "
        f"{out['Engine']['launches']}; attention launches per instance "
        f"{out['Engine']['instances']}, paged "
        f"{out['PagedEngine']['instances']}")
    return out


def _write_gguf_7b(path: str, cfg, gen) -> None:
    """A Llama-2-7B GGUF file in llama.cpp's Q4_0 layout (every projection
    and `token_embd` Q4_0, `output` Q6_K, norms F32), its block bytes drawn
    on the card, written with the port's `GGUFWriter`."""
    import numpy as np

    g = _ggml()
    h, inter = cfg.hidden_size, cfg.intermediate_size
    w = g.GGUFWriter(path)
    for key, val in (("general.architecture", "llama"),
                     ("general.name", "chip_smoke Llama-2-7B Q4_0"),
                     ("llama.vocab_size", cfg.vocab_size),
                     ("llama.embedding_length", h),
                     ("llama.block_count", cfg.n_layers),
                     ("llama.attention.head_count", cfg.n_heads),
                     ("llama.attention.head_count_kv", cfg.n_kv_heads),
                     ("llama.feed_forward_length", inter),
                     ("llama.context_length", cfg.max_position_embeddings),
                     ("llama.attention.layer_norm_rms_epsilon", 1e-5),
                     ("llama.rope.freq_base", 10000.0)):
        w.add(key, val)

    def put(name, ttype, rows, row_len):
        shape = np.broadcast_to(np.uint8(0), (rows, row_len))
        if ttype == "F32":    # a norm: one dimension, as converters write it
            w.add_tensor(name, shape[0], g.GGML_F32,
                         raw=torch.ones((row_len,), dtype=torch.float32))
        else:
            w.add_tensor(name, shape, getattr(g, f"GGML_{ttype}"),
                         raw=draw_blocks(gen, ttype, rows, row_len))

    put("token_embd.weight", "Q4_0", cfg.vocab_size, h)
    put("output_norm.weight", "F32", 1, h)
    put("output.weight", "Q6_K", cfg.vocab_size, h)
    for i in range(cfg.n_layers):
        b = f"blk.{i}."
        put(b + "attn_norm.weight", "F32", 1, h)
        put(b + "ffn_norm.weight", "F32", 1, h)
        for name, rows, row_len in (("attn_q", cfg.q_dim, h),
                                    ("attn_k", cfg.kv_dim, h),
                                    ("attn_v", cfg.kv_dim, h),
                                    ("attn_output", h, cfg.q_dim),
                                    ("ffn_gate", inter, h),
                                    ("ffn_up", inter, h),
                                    ("ffn_down", h, inter)):
            put(f"{b}{name}.weight", "Q4_0", rows, row_len)
    w.write()


def serve_quantized(profile: bool) -> dict:
    """Phase 8: checkpoints drawn from a seed in their published layouts,
    converted by the port's loaders and served at full width and depth,
    each at the bench shape (B = 1, 1975-token prefill, 32 greedy steps):
    (a) Llama-2-7B GPTQ int4 g128 act-order, drawn on the card in AutoGPTQ
    v1 layout, plus the ragged requests through `Engine` and `PagedEngine`
    (bit-equal); (b) Llama-2-7B GGUF Q4_0 through a file written with the
    port's `GGUFWriter` and read by `load_gguf_model`; (c) Llama-2-7B GGUF
    Q8_0 and Q2_K through `gguf_tensor_to_qtensor`; (d) Mixtral-8x7B GGUF
    Q4_0 through `gguf_tensor_to_qtensor` per tensor, stacked layer by
    layer, with the ragged requests and the MoE layers of a B = 4 and a
    B = 1 step under the sync check; (e) Mixtral-8x7B nf4 (`synth_params`).
    """
    import shutil
    import tempfile

    from neural_speed_tpu_torch import _build
    from neural_speed_tpu_torch.models.transformer import fuse_params
    from neural_speed_tpu_torch.ops.qtypes import named_qspec
    from neural_speed_tpu_torch.runtime.engine import Engine
    from neural_speed_tpu_torch.utils.synthetic import (llama2_7b_arch,
                                                        mixtral_8x7b_arch,
                                                        synth_params)

    cfg = llama2_7b_arch()
    gen = torch.Generator(device="cuda").manual_seed(8)
    pgen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (1975,), generator=pgen).tolist()
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=pgen).tolist()
               for n in RAGGED_LENS]
    n_steps = 32
    res = {}

    def built(label, make):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        params = make()
        torch.cuda.synchronize()
        log(f"  {label}: converted on the card in {time.time() - t0:.1f} s, "
            f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
            f"GiB")
        return params, time.time() - t0

    def bench(label, params, cfg_, pre, dec, sync_moe=False):
        eng = Engine(params, cfg_, max_batch=1, max_len=2048,
                     kv_quantized=True)
        key = label.split(" ", 1)[1].replace(" ", "_").replace("-", "_")
        out = _bench_engine(label, eng, prompt, n_steps, pre, dec, sync_moe,
                            key.lower() if profile else "")
        del eng
        torch.cuda.empty_cache()
        return out

    # (a) GPTQ act-order: nothing fuses, every projection gathers x
    params, secs = built("(a) Llama-2-7B GPTQ int4 g128 act-order",
                         lambda: fuse_params(gptq_params(cfg, gen), cfg))
    if "perm" not in params["layers"][0]["q"] or "qkv" in params["layers"][0]:
        raise AssertionError("(a): the act-order perms were lost")
    res["gptq"] = bench("(a) GPTQ act-order", params, cfg, ("qmatmul_int",),
                        ("qmatmul_int",))
    res["gptq"]["convert_s"] = secs
    res["gptq"]["ragged"] = _ragged_equal("(a) GPTQ act-order", params, cfg,
                                          prompts, ("qmatmul_int",))
    del params
    torch.cuda.empty_cache()

    # (b) GGUF Q4_0 through a file
    tmp = tempfile.mkdtemp(prefix="chip_smoke_gguf_")
    try:
        path = os.path.join(tmp, "llama-2-7b.Q4_0.gguf")
        t0 = time.time()
        _write_gguf_7b(path, cfg, gen)
        size = os.path.getsize(path)
        log(f"  (b) wrote {path} ({size / 2 ** 30:.2f} GiB) in "
            f"{time.time() - t0:.1f} s")
        g = _ggml()
        params, secs = built("(b) Llama-2-7B GGUF Q4_0 from the file",
                             lambda: g.load_gguf_model(path)[0])
    finally:
        shutil.rmtree(tmp)
    res["gguf_q4_0"] = bench("(b) GGUF Q4_0", params, cfg,
                             ("qmatmul_int", "qmatmul_planar"),
                             ("qmatmul_int", "qmatmul_planar"))
    res["gguf_q4_0"].update(convert_s=secs, file_bytes=size)
    del params
    torch.cuda.empty_cache()

    # (c) GGUF Q8_0 and Q2_K, tensor by tensor
    for name, kernels in (("Q8_0", ("qmatmul_int",)),
                          ("Q2_K", ("qmatmul_planar",))):
        params, secs = built(f"(c) Llama-2-7B GGUF {name}",
                             lambda: gguf_params(cfg, gen, LLAMA_GGUF[name]))
        res[f"gguf_{name.lower()}"] = bench(f"(c) GGUF {name}", params, cfg,
                                            kernels, kernels)
        res[f"gguf_{name.lower()}"]["convert_s"] = secs
        del params
        torch.cuda.empty_cache()

    # (d) Mixtral-8x7B GGUF Q4_0: experts stacked layer by layer
    mcfg = mixtral_8x7b_arch()
    params, secs = built("(d) Mixtral-8x7B GGUF Q4_0",
                         lambda: gguf_params(mcfg, gen, LLAMA_GGUF["Q4_0"]))
    peak = torch.cuda.max_memory_allocated()
    st = params["layers"][0]["moe"]["experts_stacked"]["gateup"]
    if st.spec.bits != 4 or st.scales.dtype != torch.float32:
        raise AssertionError(f"(d): unexpected expert stack {st.spec}")
    moe_kernels = ("qmatmul_int", "qmatmul_grouped_fp", "qmatmul_planar")
    eng = Engine(params, mcfg, max_batch=4, max_len=2048, kv_quantized=True,
                 fuse=False)
    _build.reset_counts()
    ragged = serve_ragged(eng, prompts, "(d) Mixtral GGUF Q4_0 ragged")
    counts = dict(_build.launches)
    for k in moe_kernels + ("flash_prefill", "flash_decode"):
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"(d) ragged: {k} was not launched: {counts}")
    if sum(_build.plain_dispatches.values()):
        raise AssertionError("(d) ragged: a plain version ran")
    everyone = torch.ones((4,), dtype=torch.bool)
    tok = ragged["logits"][-1].argmax(-1).to(torch.int32)
    _moe_without_sync(lambda: eng.decode(tok, everyone), mcfg.n_layers,
                      "(d) one B = 4 decode step")
    log(f"  (d) ragged: prefill {ragged['ttft_s'] * 1e3:.1f} ms, "
        f"{ragged['steps']} steps in {ragged['decode_s'] * 1e3:.1f} ms; "
        f"launches {counts}")
    del eng
    torch.cuda.empty_cache()
    res["mixtral_q4_0"] = bench("(d) Mixtral GGUF Q4_0", params, mcfg,
                                moe_kernels, moe_kernels, sync_moe=True)
    res["mixtral_q4_0"].update(
        convert_s=secs, peak_gib=peak / 2 ** 30,
        ragged=dict(prefill_ms=ragged["ttft_s"] * 1e3,
                    decode_ms=ragged["decode_s"] * 1e3,
                    steps=ragged["steps"], launches=counts))
    del params, ragged
    torch.cuda.empty_cache()

    # (e) Mixtral-8x7B nf4: the grouped LUT instance
    params, secs = built("(e) Mixtral-8x7B nf4", lambda: fuse_params(
        synth_params(mcfg, named_qspec("nf4", 128, scale_dtype="bfloat16"),
                     seed=0), mcfg))
    res["mixtral_nf4"] = bench("(e) Mixtral nf4", params, mcfg,
                               ("qmatmul_lut", "qmatmul_grouped_fp"),
                               ("qmatmul_lut", "qmatmul_grouped_fp"))
    res["mixtral_nf4"]["convert_s"] = secs
    del params
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 9: float HF checkpoints of the ALiBi / LayerNorm family
# ---------------------------------------------------------------------------


def _head_ms(params, cfg) -> float:
    """Device ms of the tied LM head of one decode step (float32 product
    over the whole embedding, as `forward` computes it)."""
    emb = params["embed"]["weight"]
    x = torch.randn((1, 1, cfg.hidden_size), device="cuda").to(emb.dtype)
    return time_ms(lambda: x.float() @ emb.t().to(x.dtype).float())


def _convert_hf(label: str, mt: str, cfg, group: int, seed: int):
    """A random float checkpoint of HF `model_type` `mt` drawn on the card
    in its published layout (`synth_hf_state_dict`), converted there by
    `convert/hf.py` to fused int4 params (bf16 group scales, group
    `group`); the checkpoint is freed.  Returns (params, info: checkpoint
    GiB, conversion seconds, peak GiB)."""
    from neural_speed_tpu_torch.convert.hf import params_from_state_dict
    from neural_speed_tpu_torch.models.transformer import fuse_params
    from neural_speed_tpu_torch.ops.qtypes import named_qspec
    from neural_speed_tpu_torch.utils.synthetic import synth_hf_state_dict

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    sd = synth_hf_state_dict(mt, cfg, seed=seed)
    sd_bytes = sum(t.numel() * t.element_size() for t in sd.values())
    torch.cuda.synchronize()
    t0 = time.time()
    params = fuse_params(params_from_state_dict(
        sd, cfg, named_qspec("int4", group, scale_dtype="bfloat16")), cfg)
    torch.cuda.synchronize()
    secs = time.time() - t0
    del sd
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    info = dict(checkpoint_gib=sd_bytes / 2 ** 30, convert_s=secs,
                convert_peak_gib=peak / 2 ** 30)
    log(f"  {label}: a {sd_bytes / 2 ** 30:.2f} GiB bf16 checkpoint "
        f"({cfg.n_layers} layers) converted on the card in {secs:.1f} s, "
        f"peak memory {peak / 2 ** 30:.2f} GiB")
    return params, info


def _bench_hf(label: str, params, cfg, kv: str, attention, n_steps: int,
              prof: str = "") -> dict:
    """The bench shape (`_bench_engine`: B = 1, a 1975-token prefill,
    `n_steps` greedy steps) through `Engine` over a `kv` cache ("int8",
    "bf16" or "f32"); kernel A the only matmul kernel, the `attention`
    kernels (prefill's, decode's) launched at the model's head-dim
    instance.  Adds the serving peak and the launches per decode step."""
    from neural_speed_tpu_torch.ops.flash import instance_dim
    from neural_speed_tpu_torch.runtime.engine import Engine

    pgen = torch.Generator().manual_seed(9)
    prompt = torch.randint(0, cfg.vocab_size, (1975,),
                           generator=pgen).tolist()
    eng = Engine(params, cfg, max_batch=1, max_len=2048,
                 kv_dtype=KV_DTYPES.get(kv, torch.bfloat16),
                 kv_quantized=kv == "int8", fuse=False)
    torch.cuda.reset_peak_memory_stats()
    out = _bench_engine(label, eng, prompt, n_steps, ("qmatmul",),
                        ("qmatmul",), profile=prof, attention=attention)
    di = instance_dim(cfg.head_dim)
    for part, name in zip(("prefill_instances", "decode_instances"),
                          attention):
        if out[part].get(f"{name} d{di}", 0) <= 0:
            raise AssertionError(f"{label}: {name}'s head-dim {di} instance "
                                 f"was not launched: {out[part]}")
    out["serve_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["per_decode_step"] = {k: v / n_steps for k, v in
                              out["decode_counts"].items()}
    log(f"  {label}: serving peak {out['serve_peak_gib']:.2f} GiB; "
        f"launches per decode step {out['per_decode_step']}")
    del eng
    torch.cuda.empty_cache()
    return out


def _ragged_hf(label: str, params, cfg, kv: str, kernels) -> dict:
    """The ragged requests through `Engine` and `PagedEngine` over a `kv`
    cache, every logit equal bit for bit (`_ragged_equal`); `kernels`: the
    contiguous prefill and decode kernels, then the paged ones, which must
    launch."""
    pgen = torch.Generator().manual_seed(10)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=pgen).tolist()
               for n in RAGGED_LENS]
    out = _ragged_equal(label, params, cfg, prompts, ("qmatmul",),
                        kv_quantized=kv == "int8",
                        kv_dtype=KV_DTYPES.get(kv, torch.bfloat16))
    for name, need in (("Engine", kernels[:2]), ("PagedEngine", kernels[2:])):
        for k in need:
            if out[name]["launches"].get(k, 0) <= 0:
                raise AssertionError(f"{label} {name}: {k} was not "
                                     f"launched: {out[name]['launches']}")
    return out


def serve_hf(profile: bool) -> dict:
    """Phase 9: random float checkpoints drawn on the card in the published
    HF layouts (`synth_hf_state_dict`, seeds 91-93) and converted by the
    port's `convert/hf.py` to int4 (bf16 group scales), each at full width
    and depth, each freed before the next:
    (a) MPT-7B g128 over the default bf16 cache: the bench shape (B = 1, a
        1975-token prefill, 64 greedy steps), then the ragged requests
        through `Engine` and `PagedEngine`, every logit equal bit for bit;
    (b) MPT-7B g128 over the int8 cache (`kv_quantized=True`): the same;
        ALiBi through the fused int8 decode of kernels B and 10;
    (c) BLOOM-7B1 g128, bf16 cache: the bench shape (embedding LayerNorm,
        biases, the 250880-row tied head);
    (d) Falcon-7B g64 (K = 4544 is not a multiple of 128), bf16 cache: the
        bench shape, then the ragged requests through `Engine` and
        `PagedEngine`, every logit equal bit for bit; 71 query heads over
        one KV head, so decode goes to the rows body's bf16 instance
        (`flash_rows_bf16`, `flash_rows_paged_bf16`).
    Each prints the checkpoint and weight GiB, the conversion's seconds and
    peak GiB, TTFT, ms/token, launches per prefill and per decode step of
    each kernel, and the plain dispatches (none may run)."""
    from neural_speed_tpu_torch.utils.synthetic import (bloom_7b1_arch,
                                                        falcon_7b_arch,
                                                        mpt_7b_arch)

    n_steps = 64
    res = {}
    bf16 = ("flash_prefill_bf16", "flash_decode_bf16",
            "flash_prefill_paged_bf16", "flash_decode_paged_bf16")
    int8 = ("flash_prefill", "flash_decode", "flash_prefill_paged",
            "flash_decode_paged")

    # (a) and (b): MPT-7B, ALiBi
    cfg = mpt_7b_arch()
    params, info = _convert_hf("(a) MPT-7B int4 g128", "mpt", cfg, 128, 91)
    res["mpt_bf16"] = dict(info, **_bench_hf(
        "(a) MPT-7B bf16 KV", params, cfg, "bf16", bf16[:2], n_steps,
        "mpt_bf16" if profile else ""))
    res["mpt_bf16"]["ragged"] = _ragged_hf("(a) MPT-7B bf16 KV", params, cfg,
                                           "bf16", bf16)
    res["mpt_int8"] = dict(info, **_bench_hf(
        "(b) MPT-7B int8 KV", params, cfg, "int8", int8[:2], n_steps))
    res["mpt_int8"]["ragged"] = _ragged_hf("(b) MPT-7B int8 KV", params, cfg,
                                           "int8", int8)
    res["mpt_bf16"]["tied_head_ms"] = _head_ms(params, cfg)
    del params
    torch.cuda.empty_cache()

    # (c) BLOOM-7B1
    cfg = bloom_7b1_arch()
    params, info = _convert_hf("(c) BLOOM-7B1 int4 g128", "bloom", cfg, 128,
                               92)
    res["bloom_bf16"] = dict(info, **_bench_hf(
        "(c) BLOOM-7B1 bf16 KV", params, cfg, "bf16", bf16[:2], n_steps))
    res["bloom_bf16"]["tied_head_ms"] = _head_ms(params, cfg)
    del params
    torch.cuda.empty_cache()

    # (d) Falcon-7B at g64
    cfg = falcon_7b_arch()
    params, info = _convert_hf("(d) Falcon-7B int4 g64", "falcon", cfg, 64,
                               93)
    rows = ("flash_prefill_bf16", "flash_rows_bf16",
            "flash_prefill_paged_bf16", "flash_rows_paged_bf16")
    res["falcon_bf16"] = dict(info, **_bench_hf(
        "(d) Falcon-7B bf16 KV", params, cfg, "bf16", rows[:2], n_steps))
    res["falcon_bf16"]["ragged"] = _ragged_hf("(d) Falcon-7B bf16 KV", params,
                                              cfg, "bf16", rows)
    res["falcon_bf16"]["tied_head_ms"] = _head_ms(params, cfg)
    del params
    torch.cuda.empty_cache()
    for k in ("mpt_bf16", "bloom_bf16", "falcon_bf16"):
        log(f"  {k}: tied LM head {res[k]['tied_head_ms']:.3f} ms per "
            f"decode step")
    return res


def serve_hf_dims(profile: bool) -> dict:
    """Phase 10: the head dims 256, 80 and 96 and float32 K/V at full width
    and depth.  Random float checkpoints drawn on the card in the published
    HF layouts (`synth_hf_state_dict`, seeds 94-97) and converted there by
    `convert/hf.py` to int4 g128 (bf16 group scales), each freed before the
    next:
    (a) Gemma-7B (head dim 256, 16 heads over 16 KV heads, the tied
        256000-row head) over the default bf16 cache: the bench shape (B =
        1, a 1975-token prefill, 64 greedy steps), then the ragged requests
        through `Engine` and `PagedEngine`, every logit equal bit for bit;
    (b) GPT-J-6B (head dim 256) over the int8 cache: the bench shape, its
        decode through kernel B's fused append at D = 256;
    (c) Phi-2 (head dim 80) over bf16: the bench shape, and the ragged
        requests, `Engine` = `PagedEngine` bit for bit;
    (d) Phi-2 over float32 K/V (`kv_dtype=torch.float32`): the same, through
        all four float32 instances;
    (e) GPT-NeoX-20B (head dim 96, 44 layers, a 38.3 GiB bf16 checkpoint:
        drawn and converted whole, its peak printed) over bf16: the bench
        shape.
    Each prints the checkpoint and weight GiB, the conversion's seconds and
    peak GiB, TTFT, ms/token, launches per kernel and per head-dim instance
    at prefill and per decode step, and the plain dispatches (none may
    run).  With `--profile`, a trace of Gemma-7B's prefill and decode."""
    from neural_speed_tpu_torch.utils.synthetic import (gemma_7b_arch,
                                                        gptj_6b_arch,
                                                        gptneox_20b_arch,
                                                        phi_2_arch)

    n_steps = 64
    res = {}
    kernels = {kv: tuple(f"flash_{k}{'' if kv == 'int8' else '_' + kv}"
                         for k in ("prefill", "decode", "prefill_paged",
                                   "decode_paged"))
               for kv in ("int8", "bf16", "f32")}

    # (a) Gemma-7B, head dim 256
    cfg = gemma_7b_arch()
    params, info = _convert_hf("(a) Gemma-7B int4 g128", "gemma", cfg, 128,
                               94)
    res["gemma_bf16"] = dict(info, **_bench_hf(
        "(a) Gemma-7B bf16 KV", params, cfg, "bf16", kernels["bf16"][:2],
        n_steps, "gemma_bf16" if profile else ""))
    res["gemma_bf16"]["ragged"] = _ragged_hf(
        "(a) Gemma-7B bf16 KV", params, cfg, "bf16", kernels["bf16"])
    del params
    torch.cuda.empty_cache()

    # (b) GPT-J-6B, head dim 256, int8 K/V
    cfg = gptj_6b_arch()
    params, info = _convert_hf("(b) GPT-J-6B int4 g128", "gptj", cfg, 128, 95)
    res["gptj_int8"] = dict(info, **_bench_hf(
        "(b) GPT-J-6B int8 KV", params, cfg, "int8", kernels["int8"][:2],
        n_steps))
    del params
    torch.cuda.empty_cache()

    # (c) and (d): Phi-2, head dim 80, bf16 and float32 K/V
    cfg = phi_2_arch()
    params, info = _convert_hf("(c) Phi-2 int4 g128", "phi", cfg, 128, 96)
    for key, kv, what in (("phi_bf16", "bf16", "(c) Phi-2 bf16 KV"),
                          ("phi_f32", "f32", "(d) Phi-2 float32 KV")):
        res[key] = dict(info, **_bench_hf(what, params, cfg, kv,
                                          kernels[kv][:2], n_steps))
        res[key]["ragged"] = _ragged_hf(what, params, cfg, kv, kernels[kv])
    del params
    torch.cuda.empty_cache()

    # (e) GPT-NeoX-20B, head dim 96
    cfg = gptneox_20b_arch()
    params, info = _convert_hf("(e) GPT-NeoX-20B int4 g128", "gpt_neox", cfg,
                               128, 97)
    res["gptneox_bf16"] = dict(info, **_bench_hf(
        "(e) GPT-NeoX-20B bf16 KV", params, cfg, "bf16",
        kernels["bf16"][:2], n_steps))
    del params
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 11: Grok-1 at full width
# ---------------------------------------------------------------------------

GROK_LAYERS = 16


def _grok_kernels(kv: str) -> tuple:
    """The softcap attention kernels of a Grok-1 run over a `kv` cache
    ("bf16", or "int8 f32 scales"): contiguous prefill, decode, then the
    paged ones."""
    suffix = "_bf16" if kv == "bf16" else "_f32scale"
    return tuple(f"flash_{k}{suffix}_softcap" for k in (
        "prefill", "decode", "prefill_paged", "decode_paged"))


def serve_grok(profile: bool) -> dict:
    """Phase 11: Grok-1 (hpcai-tech/grok-1's config.json: hidden 6144, 48
    query heads over 8 KV heads of head dim 128, 8 experts of width 32768
    top-2, vocab 131072 tied to the head, logit softcap 30, GELU experts,
    sandwich norms) at full width, int4 g128 with bf16 scales, random
    weights from seed 0 drawn on the card; 16 of its 64 layers, because
    all 64 take about 151 GiB in int4.
    (a) the ragged requests through `Engine` over the default bf16 cache
        and through `PagedEngine`, every logit equal bit for bit, and the
        MoE layers of one B = 4 decode step under the sync check;
    (b) the bench shape (B = 1, a 1975-token prefill, 64 greedy steps) over
        bf16, one B = 1 step's MoE layers under the sync check;
    (c) (b) over int8 K/V with float32 scales (`kv_scale_dtype`), and the
        ragged requests, `Engine` = `PagedEngine` bit for bit;
    (d) a 2-layer checkpoint at full width in the hpcai-tech layout drawn
        on the card in bf16 and converted there by `convert/hf.py`'s
        `map_grok` (`params_from_state_dict`, the step `convert_model`
        takes for a float directory) to int4 g128: the ragged requests
        through `Engine`.
    Each run prints weight GiB, TTFT, ms/token, the serving peak and the
    launches per prefill and per decode step of each kernel and variant:
    the softcap variants of C / 9 at prefill and of B / 10 at decode, A and
    kernel 11 must launch, and no plain version may run.  The tied head's
    float32 product per decode step is timed apart."""
    import gc

    from neural_speed_tpu_torch import _build
    from neural_speed_tpu_torch.convert.hf import params_from_state_dict
    from neural_speed_tpu_torch.models.transformer import fuse_params
    from neural_speed_tpu_torch.ops.qtypes import named_qspec
    from neural_speed_tpu_torch.runtime.engine import Engine
    from neural_speed_tpu_torch.utils.synthetic import (grok_1_arch,
                                                        synth_hf_state_dict,
                                                        synth_params)

    gc.collect()
    torch.cuda.empty_cache()
    cfg = grok_1_arch(GROK_LAYERS)
    spec = named_qspec("int4", 128, scale_dtype="bfloat16")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    params = fuse_params(synth_params(cfg, spec, seed=0), cfg)
    torch.cuda.synchronize()
    nbytes = weight_bytes(params)
    log(f"  Grok-1 at full width, {GROK_LAYERS} of its 64 layers (all 64 "
        f"take about 151 GiB in int4): params drawn on the card in "
        f"{time.time() - t0:.1f} s, weights {nbytes / 2 ** 30:.3f} GiB, "
        f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    res = dict(layers=GROK_LAYERS, weight_bytes=nbytes,
               head_ms=_head_ms(params, cfg))
    log(f"  the tied head's float32 product: {res['head_ms']:.3f} ms per "
        f"decode step")
    pgen = torch.Generator().manual_seed(11)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=pgen).tolist()
               for n in RAGGED_LENS]
    prompt = torch.randint(0, cfg.vocab_size, (1975,),
                           generator=pgen).tolist()
    moe = ("qmatmul", "qmatmul_grouped")
    n_steps = 64
    for key, kv, scale_dtype, what in (
            ("bf16", "bf16", None, "Grok-1 bf16 KV"),
            ("int8_f32scale", "int8 f32 scales", torch.float32,
             "Grok-1 int8 KV, float32 scales")):
        kernels = _grok_kernels(kv)
        quant = scale_dtype is not None
        # (a) / (c): the ragged requests, Engine = PagedEngine bit for bit
        torch.cuda.reset_peak_memory_stats()
        ragged = _ragged_equal(f"({'c' if quant else 'a'}) {what}", params,
                               cfg, prompts, moe, kv_quantized=quant,
                               kv_scale_dtype=scale_dtype)
        for name, need in (("Engine", kernels[:2]),
                           ("PagedEngine", kernels[2:])):
            for k in need:
                if ragged[name]["launches"].get(k, 0) <= 0:
                    raise AssertionError(f"{what} {name}: {k} was not "
                                         f"launched: {ragged[name]}")
        ragged_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"  {what} ragged: serving peak {ragged_peak:.2f} GiB")
        # (b) / (c): the bench shape
        eng = Engine(params, cfg, max_batch=4, max_len=2048,
                     kv_quantized=quant, kv_scale_dtype=scale_dtype,
                     fuse=False)
        if not quant:
            gen = torch.Generator().manual_seed(12)
            tok = torch.randint(0, cfg.vocab_size, (4,), generator=gen).to(
                torch.int32)
            eng.prefill(prompts)
            _moe_without_sync(
                lambda: eng.decode(tok, torch.ones((4,), dtype=torch.bool)),
                cfg.n_layers, f"(a) {what}: one B = 4 decode step")
        del eng
        torch.cuda.empty_cache()
        eng = Engine(params, cfg, max_batch=1, max_len=2048,
                     kv_quantized=quant, kv_scale_dtype=scale_dtype,
                     fuse=False)
        torch.cuda.reset_peak_memory_stats()
        bench = _bench_engine(
            f"({'c' if quant else 'b'}) {what}", eng, prompt, n_steps, moe,
            moe, sync_moe=not quant,
            profile="grok" if profile and not quant else "",
            attention=kernels[:2])
        bench["serve_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        bench["per_decode_step"] = {k: v / n_steps for k, v in
                                    bench["decode_counts"].items()}
        log(f"  {what}: serving peak {bench['serve_peak_gib']:.2f} GiB; "
            f"launches per decode step {bench['per_decode_step']}")
        res[key] = dict(bench, ragged=ragged, ragged_peak_gib=ragged_peak)
        del eng
        torch.cuda.empty_cache()
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the converter: a 2-layer hpcai-tech checkpoint at full width
    ccfg = grok_1_arch(2)
    torch.cuda.reset_peak_memory_stats()
    sd = synth_hf_state_dict("grok-1", ccfg, seed=13)
    sd_bytes = sum(t.numel() * t.element_size() for t in sd.values())
    torch.cuda.synchronize()
    t0 = time.time()
    cparams = fuse_params(params_from_state_dict(sd, ccfg, spec), ccfg)
    torch.cuda.synchronize()
    secs = time.time() - t0
    del sd
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    cbytes = weight_bytes(cparams)
    log(f"  (d) a {sd_bytes / 2 ** 30:.2f} GiB bf16 Grok-1 checkpoint (2 "
        f"layers at full width, the hpcai-tech layout) converted by map_grok "
        f"on the card in {secs:.2f} s, peak {peak:.2f} GiB; weights "
        f"{cbytes / 2 ** 30:.3f} GiB")
    eng = Engine(cparams, ccfg, max_batch=4, max_len=2048, fuse=False)
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    got = serve_ragged(eng, prompts, "(d) converted Grok-1 ragged")
    serve_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = dict(_build.launches)
    for k in moe + _grok_kernels("bf16")[:2]:
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"(d) converted Grok-1: {k} was not "
                                 f"launched: {counts}")
    if sum(_build.plain_dispatches.values()):
        raise AssertionError("(d) converted Grok-1: a plain version ran")
    log(f"  (d) converted Grok-1 ragged: prefill {got['ttft_s'] * 1e3:.1f} "
        f"ms, {got['steps']} decode steps in {got['decode_s'] * 1e3:.1f} ms; "
        f"serving peak {serve_peak:.2f} GiB; launches {counts}")
    res["converted"] = dict(checkpoint_gib=sd_bytes / 2 ** 30,
                            convert_s=secs, convert_peak_gib=peak,
                            weight_bytes=cbytes,
                            prefill_ms=got["ttft_s"] * 1e3,
                            decode_ms=got["decode_s"] * 1e3,
                            steps=got["steps"], serve_peak_gib=serve_peak,
                            launches=counts)
    del eng, cparams
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# whisper (phases 3 and 12)
# ---------------------------------------------------------------------------

# The tiny whisper of phase 3: whisper's vocabulary and frame counts at
# d_model 128, 2 heads of head dim 64 (large-v2's), 2 + 2 layers, drawn
# with numpy as `tests/test_torch_whisper.py` draws it (linear weights
# N(0, 1 / fan_in), the timestamp tokens' tied embedding rows at 2x the
# others' scale so that the timestamp rules run, position embeddings
# N(0, 4^2), so that the tied head does not map a token to itself and the
# ids change from step to step); seed 14, searched on the CPU for ids that
# vary and greedy margins far above WHISPER_LOGIT_TOL.
TINY_WHISPER_HF = dict(
    model_type="whisper", vocab_size=51865, d_model=128, encoder_layers=2,
    decoder_layers=2, encoder_attention_heads=2, decoder_attention_heads=2,
    encoder_ffn_dim=256, decoder_ffn_dim=256, num_mel_bins=80,
    max_source_positions=1500, max_target_positions=448,
    decoder_start_token_id=50258, eos_token_id=50257)
TINY_WHISPER_SEED = 14
WHISPER_TS_GAIN = 2.0
WHISPER_POS_SCALE = 4.0
WHISPER_FORCED = [50259, 50359, 50363]  # <|en|> <|transcribe|> <|notimestamps|>
WHISPER_TS = 50364                      # <|0.00|>
# card against CPU: both round q, K, V and P to bf16 but sum in other
# orders (and the card's float32 GEMMs in other blocks), which flips a
# bf16 rounding of P now and then: 2.8x the sound reading on an H100
# (7.2e-3), below the 2.4e-2 by which an attention output rounded through
# bf16 moves the CPU's logits (phase 3 logs it), far below the greedy
# margins (1.19)
WHISPER_LOGIT_TOL = 0.02
# The attention kernels of whisper's path: non-causal (encoder, cross
# attention) and causal (the decoder's float32 self-attention cache), C at
# a prefix or the encoder, B per decode step.
WHISPER_KERNELS = ("flash_prefill_f32_noncausal", "flash_decode_f32_noncausal",
                   "flash_prefill_f32", "flash_decode_f32")


def _whisper_audio(seed: int, seconds: float) -> "np.ndarray":
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    tone = 0.3 * np.sin(2 * np.pi * 440.0 * np.arange(n) / 16000)
    return (tone + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _tiny_whisper_sd(seed: int) -> dict:
    import numpy as np

    from neural_speed_tpu_torch.utils.synthetic import whisper_hf_shapes

    rng = np.random.default_rng(seed)
    sd = {}
    for name, shape in whisper_hf_shapes(TINY_WHISPER_HF).items():
        x = rng.standard_normal(shape).astype(np.float32)
        if "layer_norm" in name:
            x = (1.0 if name.endswith("weight") else 0.0) + 0.1 * x
        elif name.endswith("embed_tokens.weight"):
            x = 0.5 * x
            x[WHISPER_TS:] *= WHISPER_TS_GAIN
        elif "embed_positions" in name:
            x = WHISPER_POS_SCALE * x
        elif name.endswith("bias"):
            x = 0.02 * x
        else:
            x = x / math.sqrt(int(np.prod(shape[1:])))
        sd[name] = torch.from_numpy(x)
    return sd


def _tiny_whisper_logits(W, params, cfg, states, lens, ids):
    """The decoder's logits over `ids[:-1]` in one prefix step."""
    dev = states.device
    cache = W._self_cache(cfg, 1, dev)
    n = len(ids) - 1
    logits, _ = W.decoder_forward(
        params, cfg, torch.tensor([ids[:-1]], dtype=torch.int32, device=dev),
        torch.arange(n, dtype=torch.int32, device=dev)[None], cache,
        torch.full((1,), n, dtype=torch.int32, device=dev),
        W.cross_kv(params, cfg, states), lens)
    return logits[0].cpu()


def _bf16_output_shift(W, params, cfg, states, lens, ids, logits):
    """How far the CPU's logits move when the attention's float32 output is
    rounded through bf16 (the plain versions wrapped): the size of the
    fault that the logit tolerance would have to see."""
    from neural_speed_tpu_torch.ops import flash

    saved = {n: getattr(flash, n) for n in ("decode_plain", "prefill_plain")}

    def rounded(f):
        def g(*a, **k):
            o = f(*a, **k)
            return o.to(torch.bfloat16).to(o.dtype)
        return g
    try:
        for n, f in saved.items():
            setattr(flash, n, rounded(f))
        moved = _tiny_whisper_logits(W, params, cfg, states, lens, ids)
    finally:
        for n, f in saved.items():
            setattr(flash, n, f)
    return (moved - logits).abs().max().item()


# The counter of each float32-activation matmul instance, by the kernel
# `matmul.kernel_route` gives a pack at float32 x.
F32_COUNTERS = {"F": "qmatmul_lut_f32", "P": "qmatmul_planar_f32",
                "I": "qmatmul_int_f32"}


def _f32_counter(params) -> str:
    """The float32 matmul instance a quantized whisper's linears launch."""
    from neural_speed_tpu_torch.ops import matmul

    qt = params["encoder"]["layers"][0]["fc1"]["w"]
    return F32_COUNTERS[matmul.kernel_route(qt, torch.float32)]


def check_tiny_whisper(label: str = "float32", qspec=None) -> dict:
    """The tiny whisper (float32, or its linears quantized by `qspec`: the
    float32-activation matmul instances) on the card against the same
    model on the CPU (the
    plain versions): encoder states within 1e-3, greedy ids identical and
    the logits over them within WHISPER_LOGIT_TOL with the CPU's top-2
    margins above it; the timestamp route and a 3-beam search give the CPU's
    ids; the greedy and beam ids change from step to step (a draw that
    repeats one token would pass with broken attention).  Counts are set
    to 0 before the card's runs and read after: the non-causal and causal
    float32 instances of C and B (and the quantized model's float32 matmul
    instance) must launch, and no plain version may run there.  Also logs
    how far a float32 attention output rounded through bf16 would move the
    CPU's logits."""
    import numpy as np

    from neural_speed_tpu_torch import _build
    from neural_speed_tpu_torch.models import whisper as W
    from neural_speed_tpu_torch.ops.mel import log_mel_spectrogram

    sd = _tiny_whisper_sd(TINY_WHISPER_SEED)
    mel = torch.from_numpy(log_mel_spectrogram(_whisper_audio(3, 3.0)))[None]
    runs = {}
    for dev in ("cpu", "cuda"):
        if dev == "cuda":
            _build.reset_counts()
        params, cfg = W.convert_whisper(sd, TINY_WHISPER_HF, qspec,
                                        device=dev)
        m = W.WhisperModel(params, cfg)
        states = W.encode(params, cfg, mel.to(dev))
        lens = torch.full((1,), states.shape[1], dtype=torch.int32,
                          device=dev)
        ids = m.generate(states, lens, WHISPER_FORCED, 10)
        ts = m.generate(states, lens, WHISPER_FORCED[:2], 10,
                        timestamp_begin=WHISPER_TS)
        beam = m.generate_beam(states, lens, WHISPER_FORCED, num_beams=3,
                               max_new_tokens=6)
        logits = _tiny_whisper_logits(W, params, cfg, states, lens, ids)
        runs[dev] = dict(states=states.cpu(), ids=ids, ts=ts, beam=beam,
                         logits=logits)
        if dev == "cpu":
            shift = _bf16_output_shift(W, params, cfg, states, lens, ids,
                                       logits)
    counts = {k: v for k, v in _build.launches.items() if v}
    cpu, card = runs["cpu"], runs["cuda"]
    err_s = (cpu["states"] - card["states"]).abs().max().item()
    err_l = (cpu["logits"] - card["logits"]).abs().max().item()
    top = cpu["logits"][len(WHISPER_FORCED):].topk(2, dim=-1).values
    margin = (top[:, 0] - top[:, 1]).min().item()
    kernels = WHISPER_KERNELS + ((_f32_counter(params),) if qspec else ())
    log(f"  tiny whisper ({label}): card ids {card['ids']}, timestamps "
        f"{card['ts']}, "
        f"beam {card['beam']}; encoder states within {err_s:.2e}, logits "
        f"within {err_l:.2e} (tolerance {WHISPER_LOGIT_TOL}), smallest "
        f"greedy margin {margin:.3f}; a bf16-rounded attention output would "
        f"move the CPU's logits by {shift:.2e}; launches on the card "
        f"{counts}")
    if not err_s <= 1e-3:
        raise AssertionError(f"tiny whisper: encoder states differ from the "
                             f"CPU's by {err_s}")
    if not err_l <= WHISPER_LOGIT_TOL < margin:
        raise AssertionError(f"tiny whisper: logits differ from the CPU's by "
                             f"{err_l} (margin {margin})")
    for key in ("ids", "ts", "beam"):
        if card[key] != cpu[key]:
            raise AssertionError(f"tiny whisper: {key} on the card "
                                 f"{card[key]} differ from the CPU's "
                                 f"{cpu[key]}")
    for key in ("ids", "beam"):
        new = cpu[key][len(WHISPER_FORCED) + 1:]
        if not len(set(new)) > len(new) // 2:
            raise AssertionError(f"tiny whisper: the draw's {key} repeat "
                                 f"({new}): the id checks would be blind")
    if not any(t >= WHISPER_TS for t in card["ts"][3:]):
        raise AssertionError("tiny whisper: the timestamp route emitted no "
                             "timestamp")
    for k in kernels:
        if counts.get(k, 0) <= 0:
            raise AssertionError(f"tiny whisper: {k} was not launched on "
                                 f"the card: {counts}")
    if sum(_build.plain_dispatches.values()):
        raise AssertionError("tiny whisper: a plain version ran on the "
                             f"card: {dict(_build.plain_dispatches)}")
    return counts


def _unique_bytes(node) -> int:
    """Bytes of the distinct storages under a params tree (proj_out is a
    view of the token embedding), a `QTensor`'s planes, scales and zeros
    included."""
    import dataclasses

    seen = {}

    def walk(n):
        if isinstance(n, dict):
            for v in n.values():
                walk(v)
        elif isinstance(n, (list, tuple)):
            for v in n:
                walk(v)
        elif dataclasses.is_dataclass(n):
            for f in dataclasses.fields(n):
                walk(getattr(n, f.name))
        elif isinstance(n, torch.Tensor):
            st = n.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()

    walk(node)
    return sum(seen.values())


def _host_ms(fn, reps: int = 3) -> float:
    """Median host-clock ms of fn() ending in a synchronize."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _whisper_prefix(params, cfg, cross, lens):
    """The step of the forced 4-token prefix over a fresh self-attention
    cache, as a function returning (logits, cache)."""
    from neural_speed_tpu_torch.models import whisper as W
    from neural_speed_tpu_torch.ops import kv_cache as kvc

    prefix = [cfg.decoder_start_token_id] + WHISPER_FORCED
    toks = torch.tensor([prefix], dtype=torch.int32, device="cuda")
    pos = torch.arange(4, dtype=torch.int32, device="cuda")[None]
    four = torch.full((1,), 4, dtype=torch.int32, device="cuda")

    def prefix_step():
        cache = W._self_cache(cfg, 1, "cuda")
        logits, cache = W.decoder_forward(params, cfg, toks, pos, cache, four,
                                          cross, lens)
        return logits, kvc.set_lengths(cache, four)

    return prefix_step


# The bf16-activation matmul counters, which no whisper path may move.
BF16_MATMULS = ("qmatmul", "qmatmul_lut", "qmatmul_planar", "qmatmul_int",
                "qmatmul_int8", "qmatmul_int8_planar")


def serve_whisper_quant(d: str, wav: str, weight_dtype: str,
                        symmetric: bool, full: bool, profile: bool) -> dict:
    """Phase 12, quantized: whisper-large-v2 from the checkpoint in `d`
    with its linears quantized on the card at g128 (float32 scales; the
    smaller side of every linear reaches the group), through
    `AudioModel().init(d, use_quant=True, weight_dtype=)` (asymmetric
    formats through `convert_whisper`, since `AudioModel` takes symmetric
    ones only, as in the JAX package).  Counts set to 0 before the load
    and read after the run.  `full`: `transcribe(wav)`, encode, cross K/V,
    the prefix, 64 decode steps and a 4-beam search, each timed; else one
    encode and 16 decode steps.  The float32 matmul instance of the format
    must launch at encode (the GEMM) and in a decode step (the GEMV), no
    bf16 matmul instance and no plain version may run, outputs must be
    finite and of their shapes, and TF32 must stay off.  With `profile`,
    torch.profiler traces one encode and 8 decode steps."""
    import gc
    import json

    from neural_speed_tpu_torch import _build
    from neural_speed_tpu_torch.api import AudioModel
    from neural_speed_tpu_torch.convert import loaders
    from neural_speed_tpu_torch.models import whisper as W
    from neural_speed_tpu_torch.ops.mel import log_mel_spectrogram
    from neural_speed_tpu_torch.ops.qtypes import named_qspec

    label = f"{weight_dtype}{'' if symmetric else ' asymmetric'} g128"
    res = {}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_counts()
    t0 = time.time()
    if symmetric:
        am = AudioModel().init(d, use_quant=True, weight_dtype=weight_dtype)
        m = am.model
    else:
        with open(os.path.join(d, "config.json")) as f:
            hf = json.load(f)
        m = W.WhisperModel(*W.convert_whisper(
            loaders.load_state_dict(d), hf,
            named_qspec(weight_dtype, 128, False), device="cuda"))
    torch.cuda.synchronize()
    res["load_s"] = time.time() - t0
    params, cfg = m.params, m.cfg
    counter = _f32_counter(params)
    res["weight_bytes"] = _unique_bytes(params)
    if full:
        t0 = time.time()
        ids = am.transcribe(wav, max_new_tokens=16)
        torch.cuda.synchronize()
        res["transcribe_s"] = time.time() - t0
        res["transcribe_ids"] = ids
        if not (ids[0] == cfg.decoder_start_token_id
                and all(0 <= t < cfg.vocab_size for t in ids)):
            raise AssertionError(f"phase 12 ({label}): transcribe gave {ids}")
    mel = torch.from_numpy(log_mel_spectrogram(_whisper_audio(12, 30.0))
                           )[None].cuda()
    before = collections.Counter(_build.launches)
    states = W.encode(params, cfg, mel)
    torch.cuda.synchronize()
    res["encode_launches"] = dict(collections.Counter(_build.launches)
                                  - before)
    res["encode_ms"] = _host_ms(lambda: W.encode(params, cfg, mel),
                                reps=3 if full else 1)
    lens = torch.full((1,), states.shape[1], dtype=torch.int32,
                      device="cuda")
    cross = W.cross_kv(params, cfg, states)
    if full:
        res["cross_kv_ms"] = _host_ms(lambda: W.cross_kv(params, cfg, states))
    if not (states.shape == (1, cfg.max_source_positions, cfg.d_model)
            and bool(torch.isfinite(states).all())
            and bool(torch.isfinite(cross[0]).all())):
        raise AssertionError(f"phase 12 ({label}): encoder states or cross "
                             f"K/V not finite or of the wrong shape")
    prefix_step = _whisper_prefix(params, cfg, cross, lens)
    if full:
        res["prefix_ms"] = _host_ms(prefix_step)
    logits, cache = prefix_step()
    tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
    before = collections.Counter(_build.launches)
    logits, cache = m._step(tok, cache, cross, lens)
    torch.cuda.synchronize()
    res["decode_step_launches"] = dict(collections.Counter(_build.launches)
                                       - before)
    n_steps = 64 if full else 16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        logits, cache = m._step(tok, cache, cross, lens)
    torch.cuda.synchronize()
    res["decode_ms_per_token"] = (time.perf_counter() - t0) * 1e3 / n_steps
    res["decode_steps"] = n_steps
    if not (logits.shape == (1, 1, cfg.vocab_size)
            and bool(torch.isfinite(logits).all())
            and int(cache.lengths[0]) == 5 + n_steps):
        raise AssertionError(f"phase 12 ({label}): decode logits not finite "
                             f"or of the wrong shape, or cache length "
                             f"{int(cache.lengths[0])}")
    if profile:
        tag = weight_dtype + ("" if symmetric else "_asym")
        res["profile_encode"] = profile_window(
            lambda: W.encode(params, cfg, mel), f"encode_whisper_{tag}", 1)

        def eight_steps():
            c = cache
            t = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            for _ in range(8):
                lg, c = m._step(t, c, cross, lens)
                t = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)

        res["profile_decode"] = profile_window(eight_steps,
                                               f"decode_whisper_{tag}", 8)
        del eight_steps
    del cache, logits
    if full:
        t0 = time.time()
        res["beam_ids"] = m.generate_beam(states, lens, WHISPER_FORCED,
                                          num_beams=4, max_new_tokens=16)
        torch.cuda.synchronize()
        res["beam_s"] = time.time() - t0
    res["launches"] = {k: v for k, v in _build.launches.items() if v}
    res["instances"] = {k: v for k, v in
                        _build.instance_launches.items() if v}
    res["plain"] = dict(_build.plain_dispatches)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    res["counter"] = counter
    times = ", ".join(f"{k} {res[k]:.2f} {'s' if k.endswith('_s') else 'ms'}"
                      for k in ("load_s", "transcribe_s", "encode_ms",
                                "cross_kv_ms", "prefix_ms", "beam_s")
                      if k in res)
    log(f"  whisper-large-v2 {label}: weights "
        f"{res['weight_bytes'] / 2 ** 30:.3f} GiB, peak "
        f"{res['peak_gib']:.2f} GiB; {times}; decode "
        f"{res['decode_ms_per_token']:.3f} ms/token over {n_steps} steps"
        + (f"; transcribe ids {res['transcribe_ids']}, beam ids "
           f"{res['beam_ids']}" if full else ""))
    log(f"  whisper-large-v2 {label} launches {res['launches']}; at one "
        f"encode {res['encode_launches']}; at one decode step "
        f"{res['decode_step_launches']}; plain-version dispatches "
        f"{res['plain']}")
    for part in ("encode_launches", "decode_step_launches"):
        if res[part].get(counter, 0) <= 0:
            raise AssertionError(f"phase 12 ({label}): {counter} was not "
                                 f"launched in {part}")
    moved = [k for k in BF16_MATMULS if res["launches"].get(k)]
    if moved or sum(res["plain"].values()):
        raise AssertionError(f"phase 12 ({label}): bf16 matmul instances "
                             f"{moved} or plain versions {res['plain']} ran")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError(f"phase 12 ({label}): TF32 was turned on")
    del m, params, cross, states
    if full:
        del am
    gc.collect()
    torch.cuda.empty_cache()
    return res


def serve_whisper(profile: bool) -> dict:
    """Phase 12: whisper-large-v2 at full width and depth (openai/
    whisper-large-v2's config.json: d_model 1280, 32 + 32 layers, 20 heads
    of 64, ffn 5120, 80 mel bins, vocab 51865, 1500 / 448 positions), in
    float32, the `AudioModel` default: random weights from seed 0 drawn on
    the card in the HF layout, written to a temporary directory as
    `config.json` + `model.safetensors`, loaded by `AudioModel().init(dir)`.
    Then, with the counts set to 0: `transcribe(wav)` of a 30-second 16-bit
    wav drawn from a seed (ids, the temperature-fallback ladder); the mel
    (host), one 30 s chunk's `encode` and `cross_kv`, the forced prefix's
    step, 64 decode steps through `decoder_forward` (tokens fed back on the
    card: random weights may emit EOS early inside `generate`), and
    `generate_beam` with 4 beams for 16 steps (kernel B at B = 4 and
    `reorder`).  The non-causal and causal float32 instances of C and B at
    head dim 64 must launch, no plain version may run, the outputs must be
    finite and of their shapes, and TF32 must still be off.  With
    `profile`, torch.profiler traces one encode and 8 decode steps.  Then,
    the float32 params freed, the same checkpoint quantized on the card
    (`serve_whisper_quant`): int8 g128 in full, nf4 and asymmetric int5
    briefly."""
    import gc
    import tempfile
    import wave

    import numpy as np

    from neural_speed_tpu_torch import _build
    from neural_speed_tpu_torch.api import AudioModel
    from neural_speed_tpu_torch.models import whisper as W
    from neural_speed_tpu_torch.ops.mel import log_mel_spectrogram
    from neural_speed_tpu_torch.utils.synthetic import (
        whisper_large_v2_config, write_whisper_checkpoint)

    gc.collect()
    torch.cuda.empty_cache()
    hf = whisper_large_v2_config()
    res = {}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.time()
        nfile = write_whisper_checkpoint(d, hf, seed=0)
        res["checkpoint_bytes"] = nfile
        res["write_s"] = time.time() - t0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        wav = os.path.join(d, "clip.wav")
        pcm = np.clip(_whisper_audio(12, 30.0) * 32768.0, -32768, 32767)
        with wave.open(wav, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes(pcm.astype(np.int16).tobytes())
        _build.reset_counts()
        t0 = time.time()
        am = AudioModel().init(d)
        torch.cuda.synchronize()
        res["load_s"] = time.time() - t0
        m, params, cfg = am.model, am.model.params, am.model.cfg
        res["weight_bytes"] = _unique_bytes(params)
        log(f"  whisper-large-v2: checkpoint {nfile / 2 ** 30:.3f} GiB "
            f"drawn and written in {res['write_s']:.1f} s, loaded by "
            f"AudioModel().init in {res['load_s']:.1f} s; weights "
            f"{res['weight_bytes'] / 2 ** 30:.3f} GiB on the card")
        t0 = time.time()
        ids = am.transcribe(wav, max_new_tokens=16)
        torch.cuda.synchronize()
        res["transcribe_s"] = time.time() - t0
        res["transcribe_ids"] = ids
        if not (ids[0] == cfg.decoder_start_token_id
                and all(0 <= t < cfg.vocab_size for t in ids)):
            raise AssertionError(f"phase 12: transcribe gave {ids}")
        audio = _whisper_audio(12, 30.0)
        t0 = time.perf_counter()
        mel_np = log_mel_spectrogram(audio)
        res["mel_ms"] = (time.perf_counter() - t0) * 1e3
        mel = torch.from_numpy(mel_np)[None].cuda()
        states = W.encode(params, cfg, mel)
        res["encode_ms"] = _host_ms(lambda: W.encode(params, cfg, mel))
        lens = torch.full((1,), states.shape[1], dtype=torch.int32,
                          device="cuda")
        cross = W.cross_kv(params, cfg, states)
        res["cross_kv_ms"] = _host_ms(lambda: W.cross_kv(params, cfg,
                                                         states))
        if not (states.shape == (1, cfg.max_source_positions, cfg.d_model)
                and bool(torch.isfinite(states).all())
                and cross[0].shape == (cfg.decoder_layers, 1, cfg.n_heads,
                                       WHISPER_S, cfg.head_dim)):
            raise AssertionError("phase 12: encoder states or cross K/V "
                                 "not finite or of the wrong shape")
        prefix_step = _whisper_prefix(params, cfg, cross, lens)
        res["prefix_ms"] = _host_ms(prefix_step)
        logits, cache = prefix_step()
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        n_steps = 64
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            logits, cache = m._step(tok, cache, cross, lens)
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        res["decode_ms_per_token"] = (time.perf_counter() - t0) * 1e3 / n_steps
        if not (logits.shape == (1, 1, cfg.vocab_size)
                and bool(torch.isfinite(logits).all())):
            raise AssertionError("phase 12: decode logits not finite or of "
                                 "the wrong shape")
        if int(cache.lengths[0]) != 4 + n_steps:
            raise AssertionError(f"phase 12: cache length "
                                 f"{int(cache.lengths[0])}")
        del cache, logits
        if profile:
            res["profile_encode"] = profile_window(
                lambda: W.encode(params, cfg, mel), "encode_whisper", 1)
            logits, cache = prefix_step()

            def eight_steps():
                c = cache
                t = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
                for _ in range(8):
                    lg, c = m._step(t, c, cross, lens)
                    t = lg[:, -1].argmax(-1, keepdim=True).to(torch.int32)

            res["profile_decode"] = profile_window(eight_steps,
                                                   "decode_whisper", 8)
            del cache, logits, eight_steps
        t0 = time.time()
        beam = m.generate_beam(states, lens, WHISPER_FORCED, num_beams=4,
                               max_new_tokens=16)
        torch.cuda.synchronize()
        res["beam_s"] = time.time() - t0
        res["beam_ids"] = beam
        res["launches"] = {k: v for k, v in _build.launches.items() if v}
        res["instances"] = {k: v for k, v in
                            _build.instance_launches.items() if v}
        res["plain"] = dict(_build.plain_dispatches)
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        # the prefix step's closure holds the params and the cross K/V too
        del am, m, params, cross, states, prefix_step
        log(f"  whisper-large-v2: transcribe(30 s wav, 16 new tokens, the "
            f"temperature ladder) {res['transcribe_s']:.2f} s -> "
            f"{res['transcribe_ids']}; mel {res['mel_ms']:.1f} ms (host), "
            f"encode {res['encode_ms']:.2f} ms, cross_kv "
            f"{res['cross_kv_ms']:.2f} ms, forced prefix (4 tokens) "
            f"{res['prefix_ms']:.2f} ms, decode "
            f"{res['decode_ms_per_token']:.3f} ms/token over {n_steps} steps, "
            f"generate_beam (4 beams, 16 steps) {res['beam_s']:.2f} s; peak "
            f"{res['peak_gib']:.2f} GiB")
        log(f"  whisper-large-v2 launches {res['launches']}; per head-dim "
            f"instance {res['instances']}; plain-version dispatches "
            f"{res['plain']}")
        for k in WHISPER_KERNELS:
            if res["instances"].get(f"{k} d64", 0) <= 0:
                raise AssertionError(f"phase 12: {k} d64 was not launched")
        if sum(res["plain"].values()):
            raise AssertionError(f"phase 12: a plain version ran: "
                                 f"{res['plain']}")
        if (torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32
                or torch.get_float32_matmul_precision() != "highest"):
            raise AssertionError("phase 12: TF32 was turned on")
        gc.collect()
        torch.cuda.empty_cache()
        # the same checkpoint with its linears quantized: int8 (the
        # AudioModel default) in full, nf4 and asymmetric int5 briefly
        res["quant"] = {
            fmt: serve_whisper_quant(d, wav, fmt, sym, full, profile and full)
            for fmt, sym, full in (("int8", True, True), ("nf4", True, False),
                                   ("int5", False, False))}
        log("  whisper-large-v2 encode ms (one 30 s chunk): float32 "
            f"{res['encode_ms']:.2f}, " + ", ".join(
                f"{fmt} {q['encode_ms']:.2f}" for fmt, q in res["quant"].items()))
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 13: continuous-batching serving through api.Model / ModelServer
# ---------------------------------------------------------------------------

# Eight requests issued at once: phase 4's four ragged ones, then four more.
SERVE_LENS = RAGGED_LENS + [1500, 640, 128, 9]
SERVE_BUDGETS = RAGGED_BUDGETS + [32, 12, 20, 6]


def _alone_logits(params, cfg, prompts):
    """Each prompt prefilled alone (B = 1, a contiguous int8 cache): its
    last-token logits, on the CPU (float32)."""
    from neural_speed_tpu_torch.ops import kv_cache as kvc
    from neural_speed_tpu_torch.runtime.engine import pad_to_bucket, prefill_step

    cache = kvc.init_cache(cfg.n_layers, 1, 2048, cfg.n_kv_heads,
                           cfg.head_dim, quantized=True)
    out = []
    for p in prompts:
        t = pad_to_bucket(len(p), (32, 64, 128, 256, 512, 1024, 2048))
        ids = torch.zeros((1, t), dtype=torch.int32)
        ids[0, :len(p)] = torch.tensor(p, dtype=torch.int32)
        zero = torch.zeros((1,), dtype=torch.int32, device="cuda")
        kvc.set_lengths(cache, zero)
        logits, cache = prefill_step(
            params, cfg, cache, ids.cuda(),
            torch.tensor([len(p)], dtype=torch.int32, device="cuda"), zero)
        out.append(logits[0].float().cpu())
    return out


def _serve_once(model, prompts, qk: bool, on_server=None,
                **server_kw) -> dict:
    """The eight requests through `ModelServer(**server_kw)` (greedy,
    eos_id None), issued at once.  The first token of each is timed by a
    streamer that a wrapper of the scheduler's `add_request` attaches (the
    server's `issue_query` takes none); finishes by the response callback.
    `on_server(srv)` may wrap more of the scheduler before the requests."""
    from neural_speed_tpu_torch import _build, api
    from neural_speed_tpu_torch.ops import flash

    first, done, results, prefill = {}, {}, {}, {}
    prev = flash.FLASH_INT8_DOT
    flash.FLASH_INT8_DOT = qk
    try:
        def respond(rid, toks):
            done[rid] = time.perf_counter()
            results[rid] = list(toks)

        srv = api.ModelServer(model, respond, max_new_tokens=8, **server_kw)
        if on_server is not None:
            on_server(srv)
        add = srv.sched.add_request

        def add_request(prompt, max_new_tokens=128, streamer=None):
            rid = srv.sched._next_rid
            stream = lambda tok: first.setdefault(rid, time.perf_counter())
            return add(prompt, max_new_tokens, streamer=stream)

        srv.sched.add_request = add_request
        # each request's prefill logits (the row its first token is sampled
        # from), kept for the check against the prompt prefilled alone
        commit = srv.sched._sample_and_commit

        def sample_and_commit(logits, slot_map, prompt_obs=None):
            for slot, seq in slot_map.items():
                prefill[seq.request_id] = logits[slot].float().cpu()
            return commit(logits, slot_map, prompt_obs)

        srv.sched._sample_and_commit = sample_and_commit
        _build.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p, n in zip(prompts, SERVE_BUDGETS):
            srv.issue_query(p, max_new_tokens=n)
        srv.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        srv.shutdown()
    finally:
        flash.FLASH_INT8_DOT = prev
    n = len(prompts)
    ttft = [(first[i] - t0) * 1e3 for i in range(n)]
    per_tok = [(done[i] - first[i]) * 1e3 / (SERVE_BUDGETS[i] - 1)
               for i in range(n)]
    return dict(ids=[results[i] for i in range(n)], wall_s=wall,
                prefill_logits=[prefill.get(i) for i in range(n)],
                ttft_ms=ttft, ms_per_token=per_tok,
                requests_per_s=n / wall,
                tokens_per_s=sum(SERVE_BUDGETS) / wall,
                decode_ms_per_token=statistics.median(per_tok),
                launches=dict(_build.launches),
                instances=dict(_build.instance_launches),
                plain=dict(_build.plain_dispatches),
                timings=dict(prefill_s=srv.sched.timings.prefill_s,
                             decode_s=srv.sched.timings.decode_s,
                             decode_tokens=srv.sched.timings.decode_tokens))


def _hold_window(eng, prompts, qk: bool) -> dict:
    """The first decode window of phase 13's engine, held against its plain
    version: the scheduler over the first four prompts (greedy without the
    repetition penalty, budget 9: the prefill's token and one 8-token
    window), run once through the kernels and once with kernel 10's wrapper
    swapped for its plain version on the card, with or without the int8
    score dot (`qk`).  At each step every slot's logits lie within 2% of
    the plain run's largest logit, and its id equals the plain run's
    wherever the plain top-2 margin exceeds twice the slot's difference (a
    slot is compared up to its first id that differs).  Returns the slot
    steps compared and the largest difference."""
    from neural_speed_tpu_torch.ops import flash
    from neural_speed_tpu_torch.ops import sampling as smp
    from neural_speed_tpu_torch.runtime.scheduler import (
        ContinuousBatchingScheduler)

    what = f"phase 13 decode window ({'qk' if qk else 'qk off'})"
    sp = smp.SamplingParams(do_sample=False, repetition_penalty=1.0)
    calls = {}
    prev_qk, prev_fn = flash.FLASH_INT8_DOT, flash.decode_paged_cuda
    flash.FLASH_INT8_DOT = qk
    try:
        for mode in ("kernel", "plain"):
            if mode == "plain":
                flash.decode_paged_cuda = flash.decode_paged_plain
            sched = ContinuousBatchingScheduler(eng, sp, window=8,
                                                pipeline_decode=False)
            for p in prompts[:4]:
                sched.add_request(p, 9)
            sched.step()                          # the prefill
            with _SampleLog() as rec:
                sched.step()                      # one 8-token window
            sched.run_to_completion()
            calls[mode] = rec.calls
    finally:
        flash.FLASH_INT8_DOT = prev_qk
        flash.decode_paged_cuda = prev_fn
    if len(calls["kernel"]) != len(calls["plain"]):
        raise AssertionError(f"{what}: {len(calls['kernel'])} steps through "
                             f"the kernels, {len(calls['plain'])} plain")
    live = torch.ones(len(calls["plain"][0][1]), dtype=torch.bool)
    checked, worst, share = 0, 0.0, 0.0
    for i, ((lk, act), (lp, _)) in enumerate(zip(calls["kernel"],
                                                 calls["plain"])):
        rows = act & live
        if not rows.any():
            break
        tol = 0.02 * lp[rows].abs().max().item()
        top2 = lp.topk(2, dim=-1).values
        for r in rows.nonzero().flatten().tolist():
            diff = (lk[r] - lp[r]).abs().max().item()
            worst = max(worst, diff)
            share = max(share, diff / (tol / 0.02))
            if diff > tol:
                raise AssertionError(f"{what}: step {i} slot {r}: logits "
                                     f"differ by {diff} > {tol}")
            if int(lk[r].argmax()) == int(lp[r].argmax()):
                checked += 1
            elif (top2[r, 0] - top2[r, 1]).item() > 2 * diff:
                raise AssertionError(f"{what}: step {i} slot {r}: id "
                                     f"{int(lk[r].argmax())}, plain "
                                     f"{int(lp[r].argmax())}")
            else:
                live[r] = False
    if not checked:
        raise AssertionError(f"{what}: no step was compared")
    log(f"  {what}: through kernel 10 against its plain version on the "
        f"card: {checked} slot steps with equal ids, logits within "
        f"{worst:.3g}, at most {100 * share:.3g}% of the step's largest "
        f"logit (2% allowed)")
    return dict(slot_steps=checked, max_abs_diff=worst,
                max_share_of_largest=share)


def serve_model_server(profile: bool) -> dict:
    """Phase 13: Llama-2-7B int4 (phase 4's params, 32 layers) as an
    `api.Model` over `PagedEngine(kv_quantized=True, max_batch=4,
    max_len=2048, page_size=128)`, serving eight requests through
    `ModelServer`, without and then with the int8 score dot: every budget
    delivered; each request's prefill logits within 2% of the largest
    logit (as `_hold_tiny`) of its prompt prefilled alone, and its first
    token the penalized argmax of the prompt alone (the server's greedy
    sampler applies the repetition penalty of 1.1 over the prompt) wherever
    that top-2 margin exceeds twice the logits' measured difference; the
    pool free after `join`, kernels A, 9 and 10 launched (10's `_qk`
    instance under qk) and no plain version.  Then the first decode window
    of each, through the kernels, against the same window with kernel 10's
    plain version (`_hold_window`).  Host clock: TTFT per request
    (issue to its first token), ms/token per request, requests/s and
    tokens/s.  `--profile`: one traced decode window of the scheduler
    (8 tokens, B = 4) with and without qk."""
    import gc

    from neural_speed_tpu_torch import api
    from neural_speed_tpu_torch.ops import flash
    from neural_speed_tpu_torch.ops import sampling as smp
    from neural_speed_tpu_torch.runtime.scheduler import (
        ContinuousBatchingScheduler)

    params, cfg = params_7b()
    model = api.Model()
    model.cfg = cfg
    model._make_engine(params, 4, 2048, True, paged=True, page_size=128)
    eng = model.engine
    gen = torch.Generator().manual_seed(13)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in SERVE_LENS]
    alone = _alone_logits(eng.params, eng.cfg, prompts)
    # the server's greedy sampler: the repetition penalty over the prompt
    sp = smp.SamplingParams(do_sample=False)

    def penalized(lg, p):
        st = smp.observe_prompt_slot(
            smp.init_state(0, 1, cfg.vocab_size, window=sp.penalty_window,
                           device="cpu"), 0, p[-sp.penalty_window:])
        return smp.apply_penalties(lg[None], st, sp)[0]
    # the first launches and the build outside the timed runs
    warm = ContinuousBatchingScheduler(eng)
    warm.warmup(prompt_len=64)
    res = {}
    for qk in (False, True):
        key = "qk" if qk else "qk_off"
        r = _serve_once(model, prompts, qk)
        what = f"phase 13 ({'qk' if qk else 'qk off'})"
        if [len(g) for g in r["ids"]] != SERVE_BUDGETS:
            raise AssertionError(f"{what}: delivered {[len(g) for g in r['ids']]}"
                                 f" tokens, budgets {SERVE_BUDGETS}")
        checked, equal, diffs = 0, 0, []
        for i, (lg, got, g) in enumerate(zip(alone, r["prefill_logits"],
                                             r["ids"])):
            diff = (got - lg).abs().max().item()
            diffs.append(diff)
            equal += diff == 0
            if diff > 0.02 * lg.abs().max().item():
                raise AssertionError(
                    f"{what}: request {i}'s prefill logits differ from its "
                    f"prompt alone's by {diff}")
            pen = penalized(lg, prompts[i])
            top2 = pen.topk(2).values
            # the penalty scales a logit by at most 1.1
            if (top2[0] - top2[1]).item() > 2 * 1.1 * diff:
                checked += 1
                if g[0] != int(pen.argmax()):
                    raise AssertionError(
                        f"{what}: request {i}'s first token {g[0]} is not "
                        f"the argmax {int(pen.argmax())} of its prompt "
                        f"alone")
        if not checked:
            raise AssertionError(f"{what}: no first token was checked")
        r["prefill_logits_max_diff"] = diffs
        del r["prefill_logits"]
        if eng._alloc.available != eng.n_pages - 1:
            raise AssertionError(f"{what}: {eng.n_pages - 1 - eng._alloc.available}"
                                 f" pages left allocated after join")
        want = ("qmatmul", "flash_prefill_paged",
                "flash_decode_paged_qk" if qk else "flash_decode_paged")
        for k in want:
            if r["launches"].get(k, 0) <= 0:
                raise AssertionError(f"{what}: {k} was not launched")
        if not qk and any(k.endswith("_qk") for k in r["launches"]):
            raise AssertionError(f"{what}: a _qk instance ran with qk off")
        if sum(r["plain"].values()):
            raise AssertionError(f"{what}: a plain version ran: {r['plain']}")
        r["first_tokens_checked"] = checked
        log(f"  {what}: 8 requests (prompts {SERVE_LENS}, budgets "
            f"{SERVE_BUDGETS}) in {r['wall_s'] * 1e3:.1f} ms: "
            f"{r['requests_per_s']:.3f} requests/s, "
            f"{r['tokens_per_s']:.2f} tokens/s; TTFT ms "
            f"{[round(x, 1) for x in r['ttft_ms']]}; ms/token "
            f"{[round(x, 2) for x in r['ms_per_token']]} (median "
            f"{r['decode_ms_per_token']:.2f}); prefill logits equal to "
            f"the prompt alone's bit for bit at {equal} of 8 (largest "
            f"difference {max(diffs):.3g}); first tokens equal to the "
            f"prompt alone's penalized argmax at {checked} of 8 (the "
            f"others' margins within twice that difference); the pool "
            f"free; launches {r['launches']}")
        res[key] = r
    for qk in (False, True):
        res[f"window_hold_{'qk' if qk else 'qk_off'}"] = _hold_window(
            eng, prompts, qk)
    if res["qk"]["ids"] != res["qk_off"]["ids"]:
        same = sum(a == b for a, b in zip(res["qk"]["ids"],
                                          res["qk_off"]["ids"]))
        log(f"  phase 13: qk changed the streams of {8 - same} of 8 "
            f"requests (its scores differ from the float product's)")
    log(f"  phase 13: decode ms/token (median over requests) qk off "
        f"{res['qk_off']['decode_ms_per_token']:.2f}, qk "
        f"{res['qk']['decode_ms_per_token']:.2f}")
    if profile:
        for qk in (False, True):
            prev = flash.FLASH_INT8_DOT
            flash.FLASH_INT8_DOT = qk
            try:
                sched = ContinuousBatchingScheduler(eng, window=8,
                                                    pipeline_decode=False)
                for p in prompts[:4]:
                    sched.add_request(p, 17)
                sched.step()                      # the prefill
                label = f"decode_serving{'_qk' if qk else ''}"
                res[f"profile_{label}"] = profile_window(
                    lambda: sched.step(), label, 8)
                sched.run_to_completion()
            finally:
                flash.FLASH_INT8_DOT = prev
    del model, eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 14: speculative and mixed-prefill serving
# ---------------------------------------------------------------------------

SPEC_PATTERN, SPEC_PROMPT_LEN, SPEC_NEW = 48, 1975, 64


def _spec_prompt(vocab: int):
    """A seeded 48-token pattern repeated to 1975 tokens: prompt lookup
    finds a full 7-token draft at the first step."""
    g = torch.Generator().manual_seed(14)
    pat = torch.randint(0, vocab, (SPEC_PATTERN,), generator=g).tolist()
    return (pat * (SPEC_PROMPT_LEN // SPEC_PATTERN + 1))[:SPEC_PROMPT_LEN]


def _top2_gap(row: torch.Tensor) -> float:
    top2 = row.float().topk(2).values
    return (top2[0] - top2[1]).item()


def _counts():
    from neural_speed_tpu_torch import _build

    return [collections.Counter(c) for c in (
        _build.launches, _build.instance_launches, _build.multi_launches,
        _build.plain_dispatches)]


def _restore_counts(saved) -> None:
    from neural_speed_tpu_torch import _build

    for c, keep in zip((_build.launches, _build.instance_launches,
                        _build.multi_launches, _build.plain_dispatches),
                       saved):
        c.clear()
        c.update(keep)


def _spec_single(model, prompt, qk: bool) -> dict:
    """Phase 14 (a): `Model.generate(prompt, speculative=True,
    speculative_k=7)` on the contiguous B = 1 engine (the single-sequence
    helper), greedy without the penalty, against `Engine.generate_greedy`'s
    steps (their logits kept): the ids equal up to the first position whose
    top-2 margin is within twice the measured difference between the first
    verify forward's rows (T = 8 for a full draft) and the same positions'
    decode logits (T = 1); the first verify forward's logits within 2% of
    its largest logit (`_hold_window`'s rule: the logits are bf16 values,
    whose ulp at |logit| 64-128 is 0.78-0.39% of it) of the same forward
    with the attention kernel's plain version on the card (B's `_qk_multi`
    under qk, C without)."""
    from neural_speed_tpu_torch import _build
    from neural_speed_tpu_torch.ops import flash
    from neural_speed_tpu_torch.runtime import speculative as tsp

    eng = model.engine
    what = f"phase 14 (a) ({'qk' if qk else 'qk off'})"
    prev = flash.FLASH_INT8_DOT
    flash.FLASH_INT8_DOT = qk
    try:
        # the sequential reference, as Engine.generate_greedy, logits kept
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = eng.prefill([prompt])
        ref, ref_logits = [], []
        active = torch.zeros((1,), dtype=torch.bool)
        active[0] = True
        for _ in range(SPEC_NEW):
            ref_logits.append(logits[0].float().cpu())
            tok = int(torch.argmax(logits[0]))
            ref.append(tok)
            logits = eng.decode(torch.full((1,), tok, dtype=torch.int32),
                                active)
        torch.cuda.synchronize()
        greedy_s = time.perf_counter() - t0
        if ref != eng.generate_greedy(prompt, SPEC_NEW):
            raise AssertionError(f"{what}: generate_greedy differs from its "
                                 f"own steps")
        verifies, first, decodes = [], {}, []
        orig = tsp._verify_forward
        eng_decode = eng.decode

        def decode(tokens, active):
            decodes.append(1)
            return eng_decode(tokens, active)

        def verify(params, cfg, cache, ids, pos, kv_lens, comp=None):
            out, cache = orig(params, cfg, cache, ids, pos, kv_lens, comp)
            verifies.append(ids.shape[1])
            if not first:
                # the same forward (its rows are in the cache already)
                # through the attention kernel's plain version
                saved = _counts()
                fns = flash.decode_cuda, flash.prefill_cuda
                flash.decode_cuda = flash.decode_plain
                flash.prefill_cuda = flash.prefill_plain
                try:
                    plain, _ = orig(params, cfg, cache, ids, pos, kv_lens,
                                    comp)
                finally:
                    flash.decode_cuda, flash.prefill_cuda = fns
                    _restore_counts(saved)
                real = int((pos[0] < cache.max_len - 1).sum())
                first.update(rows=out[0, :real].float().cpu(),
                             plain=plain[0, :real].float().cpu(),
                             ids=ids[0, :real].cpu().tolist(),
                             at=len(decodes), t=ids.shape[1])
            return out, cache

        tsp._verify_forward = verify
        eng.decode = decode
        _build.reset_counts()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model.generate([prompt], max_new_tokens=SPEC_NEW,
                                 repetition_penalty=1.0, speculative=True,
                                 speculative_k=7, ignore_prompt=True)[0]
            torch.cuda.synchronize()
            spec_s = time.perf_counter() - t0
        finally:
            tsp._verify_forward = orig
            del eng.decode
        launches = dict(_build.launches)
        multi = dict(_build.multi_launches)
        plain_n = sum(_build.plain_dispatches.values())
    finally:
        flash.FLASH_INT8_DOT = prev
    if len(out) != SPEC_NEW or not verifies:
        raise AssertionError(f"{what}: {len(out)} tokens, {len(verifies)} "
                             f"verify forwards")
    # the first verify's rows that follow the greedy prefix: its row j
    # scores the token after ids[j], which is greedy id at + 1 + j
    at = first["at"]
    d = 0.0
    for j in range(len(first["ids"])):
        if first["ids"][:j + 1] != ref[at:at + j + 1] or at + 1 + j >= len(
                ref_logits):
            break
        d = max(d, (first["rows"][j] - ref_logits[at + 1 + j]).abs().max(
        ).item())
    span = first["plain"].abs().max().item()
    hold = (first["rows"] - first["plain"]).abs().max().item()
    if hold > 0.02 * span:
        raise AssertionError(f"{what}: the first verify forward differs from "
                             f"its plain-attention twin by {hold} > 2% of "
                             f"{span}")
    under = sum(_top2_gap(r) <= 2 * d for r in ref_logits)
    equal = 0
    for i, (a, b) in enumerate(zip(out, ref)):
        if a == b:
            equal += 1
            continue
        gap = _top2_gap(ref_logits[i])
        if gap > 2 * d:
            raise AssertionError(f"{what}: id {i} is {a}, greedy {b}, at a "
                                 f"margin {gap} > 2 x {d}")
        break
    if qk and launches.get("flash_decode_qk_multi", 0) <= 0:
        raise AssertionError(f"{what}: kernel B's t > 1 qk instance was not "
                             f"launched: {launches}")
    if plain_n:
        raise AssertionError(f"{what}: a plain version ran on the main path")
    res = dict(ids_equal_to_greedy=equal, positions_under_margin=under,
               first_verify_t=first["t"], first_verify_at=at,
               first_verify_rows=len(first["ids"]),
               t8_vs_t1_max_diff=d, first_verify_plain_diff=hold,
               first_verify_span=span, verifies=len(verifies),
               plain_decodes=len(decodes),
               verify_t=collections.Counter(verifies),
               # every token but the prefill's comes from a decode step or
               # a verify (its correction plus the accepted drafts)
               accepted_per_verify=(SPEC_NEW - 1 - len(decodes)
                                    - len(verifies)) / len(verifies),
               spec_ms_per_token=spec_s * 1e3 / SPEC_NEW,
               greedy_ms_per_token=greedy_s * 1e3 / SPEC_NEW,
               launches=launches, multi_launches=multi)
    log(f"  {what}: {SPEC_NEW} ids of a {len(prompt)}-token prompt (a "
        f"{SPEC_PATTERN}-token pattern): {equal} equal to generate_greedy's "
        f"before the first difference, {under} of {SPEC_NEW} positions with "
        f"a top-2 margin within 2 x {d:.4g} (the difference of the first "
        f"verify's rows, T = {first['t']} after {at} plain decode steps, "
        f"from the T = 1 logits); {len(verifies)} verify forwards "
        f"{dict(res['verify_t'])} and {len(decodes)} plain decode steps, "
        f"{res['accepted_per_verify']:.2f} draft tokens accepted per verify; "
        f"first verify within {hold:.4g} of its plain-attention twin"
        f" ({100 * hold / span:.3g}% of the largest logit, "
        f"{hold / 2.0 ** (math.floor(math.log2(span)) - 7):.3g} bf16 ulps "
        f"of it; 2% allowed); host ms/token "
        f"speculative {res['spec_ms_per_token']:.2f}, greedy "
        f"{res['greedy_ms_per_token']:.2f}; t > 1 launches {multi}")
    return res


class _SpecStats:
    """Wraps a server's scheduler: joint steps (verifies), those that fed
    prompt chunks, the draft tokens accepted, and the steps taken in
    backoff."""

    def __init__(self):
        self.steps = self.backoff_steps = self.verifies = 0
        self.slot_verifies = self.accepted = self.chunk_steps = 0

    def install(self, srv) -> None:
        sched = srv.sched
        joint, step = sched._joint_step, sched.step

        def joint_step(include_prefill):
            dec = [s for s in sched.running.values()
                   if s.status == "decoding"]
            before = [len(s.generated) for s in dec]
            self.chunk_steps += include_prefill and any(
                s.status == "prefill" for s in sched.running.values())
            joint(include_prefill)
            self.verifies += 1
            self.slot_verifies += len(dec)
            self.accepted += sum(len(s.generated) - n - 1
                                 for s, n in zip(dec, before))

        def stepper():
            self.steps += 1
            self.backoff_steps += sched._spec_backoff > 0
            step()

        sched._joint_step, sched.step = joint_step, stepper

    def as_dict(self) -> dict:
        return dict(steps=self.steps, backoff_share=(
            self.backoff_steps / max(1, self.steps)), verifies=self.verifies,
            prompt_chunk_steps=self.chunk_steps,
            accepted_per_slot_verify=self.accepted / max(
                1, self.slot_verifies))


def _held_against(what, got, base, prompts, params, cfg, d) -> dict:
    """Each request's ids against the run without speculation: equal up to
    the first difference, where the margin of the prompt and the common
    prefix prefilled alone (the server's penalty over the observed tokens)
    must lie within twice `d`."""
    from neural_speed_tpu_torch.ops import sampling as smp
    from neural_speed_tpu_torch.runtime import speculative as tsp

    sp = smp.SamplingParams(do_sample=False)
    same, compared = 0, 0
    for i, (a, b) in enumerate(zip(got, base)):
        k = next((j for j in range(min(len(a), len(b))) if a[j] != b[j]),
                 None)
        if k is None and len(a) == len(b):
            same += 1
            compared += len(a)
            continue
        k = min(len(a), len(b)) if k is None else k
        compared += k
        ctx = prompts[i] + a[:k]
        row = _alone_logits(params, cfg, [ctx])[0].numpy()
        obs = prompts[i][-sp.penalty_window:] + a[:k]
        l = tsp._penalized_row(row, sp, obs)
        top2 = sorted(l)[-2:]
        if top2[1] - top2[0] > 2 * d:
            raise AssertionError(f"{what}: request {i} differs at id {k} "
                                 f"({a[k:k + 1]} vs {b[k:k + 1]}) at a margin "
                                 f"{top2[1] - top2[0]} > 2 x {d}")
    log(f"  {what}: {same} of {len(got)} requests equal to the run without "
        f"speculation, {compared} ids compared (the others differ where the "
        f"margin is within 2 x {d:.4g})")
    return dict(requests_equal=same, ids_compared=compared)


def _step_ms(fn, reps: int = 5) -> float:
    """Median ms of fn() between CUDA events (the host's launch gaps
    included), after two warm-up calls."""
    for _ in range(2):
        fn()
    spans = []
    for _ in range(reps):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        fn()
        b.record()
        b.synchronize()
        spans.append(a.elapsed_time(b))
    return statistics.median(spans)


def _verify_times(eng, params, card: str, profile: bool) -> dict:
    """ms of a verify step of the B = 4 contiguous engine at T = 4 and 8
    (every slot at 1975 cached tokens) against a plain decode step, qk off
    and on, and the bytes bound of a step (the weights read once and every
    slot's K/V)."""
    from neural_speed_tpu_torch.ops import flash
    from neural_speed_tpu_torch.ops import kv_cache as kvc

    b, ctx, cfg = eng.max_batch, 1975, eng.cfg
    g = torch.Generator().manual_seed(7)
    res = {}
    prev = flash.FLASH_INT8_DOT
    try:
        for qk in (False, True):
            flash.FLASH_INT8_DOT = qk
            for t in (4, 8):
                ids = torch.randint(0, cfg.vocab_size, (b, t), generator=g)
                pos = (ctx + torch.arange(t))[None].repeat(b, 1).int()
                lens = torch.full((b,), ctx + t, dtype=torch.int32)
                res[f"verify_t{t}{'_qk' if qk else ''}_ms"] = _step_ms(
                    lambda: eng.run_verify_argmax(ids, pos, lens))
            toks = torch.randint(0, cfg.vocab_size, (b,), generator=g).int()
            active = torch.ones((b,), dtype=torch.bool)

            def decode():
                kvc.set_lengths(eng.cache, torch.full(
                    (b,), ctx, dtype=torch.int32, device=eng.device))
                eng.decode(toks, active)

            res[f"decode{'_qk' if qk else ''}_ms"] = _step_ms(decode)
        if profile:
            flash.FLASH_INT8_DOT = True
            ids = torch.randint(0, cfg.vocab_size, (b, 8), generator=g)
            pos = (ctx + torch.arange(8))[None].repeat(b, 1).int()
            lens = torch.full((b,), ctx + 8, dtype=torch.int32)
            res["profile_verify_t8_qk"] = profile_window(
                lambda: eng.run_verify_argmax(ids, pos, lens),
                "verify_t8_qk", 1)
    finally:
        flash.FLASH_INT8_DOT = prev
    kv = (b * cfg.n_layers * cfg.n_kv_heads * (ctx + 8)
          * (2 * cfg.head_dim + 4))
    res["bound_ms"], res["bound_by"] = bound(weight_bytes(params) + kv, 0.0,
                                             card)
    log(f"  phase 14 verify steps (B = {b}, {ctx} cached tokens per slot, "
        f"CUDA events, host launch gaps included): " + ", ".join(
            f"{k} {v:.2f}" for k, v in res.items()
            if k.endswith("_ms") and k != "bound_ms")
        + f"; the bytes bound of a step "
        f"{res['bound_ms']:.3f} ms (weights read once, K/V)")
    return res


def serve_speculative(card: str, profile: bool) -> dict:
    """Phase 14 at Llama-2-7B width (phase 4's int4 params, 32 layers,
    max_len 2048, the int8 cache): (a) `_spec_single` qk off then on; (b)
    phase 13's eight requests through `ModelServer(speculative=True)` on the
    contiguous B = 4 engine, qk off and on, then on phase 13's `PagedEngine`
    (page size 128), each held against the same server without
    speculation (`_held_against`); (c) `ModelServer(mixed_prefill=True,
    mixed_chunk=32)` on the paged engine, held the same way.  Prints TTFT
    and ms/token per request, requests/s, tokens/s, draft tokens accepted
    per verify and the share of steps in backoff, and the verify step's ms
    at T = 4 and 8 against a decode step (`_verify_times`).  Under qk the
    t > 1 qk instance of B must launch, in (c) kernel 9 for the chunks; no
    plain version may run."""
    import gc

    from neural_speed_tpu_torch import _build, api
    from neural_speed_tpu_torch.runtime.scheduler import (
        ContinuousBatchingScheduler)

    params, cfg = params_7b()
    model = api.Model()
    model.cfg = cfg
    res = {}
    # (a) the single-sequence helper on a contiguous B = 1 engine
    model._make_engine(params, 1, 2048, True, paged=False)
    ContinuousBatchingScheduler(model.engine).warmup(prompt_len=64)
    prompt = _spec_prompt(cfg.vocab_size)
    for qk in (False, True):
        res[f"single_{'qk' if qk else 'qk_off'}"] = _spec_single(
            model, prompt, qk)
    d = max(r["t8_vs_t1_max_diff"] for k, r in res.items()
            if k.startswith("single"))
    gen = torch.Generator().manual_seed(13)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in SERVE_LENS]

    def served(key, qk, want_kernels, **kw):
        stats = _SpecStats() if kw else None
        r = _serve_once(model, prompts, qk, on_server=(
            stats.install if stats else None), **kw)
        r.pop("prefill_logits")
        if [len(g) for g in r["ids"]] != SERVE_BUDGETS:
            raise AssertionError(f"phase 14 {key}: delivered "
                                 f"{[len(g) for g in r['ids']]} tokens")
        for k in want_kernels:
            if r["launches"].get(k, 0) <= 0:
                raise AssertionError(f"phase 14 {key}: {k} was not launched: "
                                     f"{r['launches']}")
        if sum(r["plain"].values()):
            raise AssertionError(f"phase 14 {key}: a plain version ran: "
                                 f"{r['plain']}")
        if stats:
            r["spec"] = stats.as_dict()
        r["multi_launches"] = dict(_build.multi_launches)
        log(f"  phase 14 {key}: {r['requests_per_s']:.3f} requests/s, "
            f"{r['tokens_per_s']:.2f} tokens/s; TTFT ms "
            f"{[round(x, 1) for x in r['ttft_ms']]}; ms/token "
            f"{[round(x, 2) for x in r['ms_per_token']]} (median "
            f"{r['decode_ms_per_token']:.2f})"
            + (f"; {r['spec']['verifies']} joint steps "
               f"({r['spec']['prompt_chunk_steps']} with prompt chunks), "
               f"{r['spec']['accepted_per_slot_verify']:.2f} draft tokens "
               f"accepted per slot and joint step, "
               f"{100 * r['spec']['backoff_share']:.1f}% of "
               f"{r['spec']['steps']} steps in backoff" if stats else "")
            + f"; t > 1 launches {r['multi_launches']}")
        res[key] = r
        return r

    # (b) ModelServer(speculative=True) on the contiguous B = 4 engine
    del model.engine
    torch.cuda.empty_cache()
    model._make_engine(params, 4, 2048, True, paged=False)
    ContinuousBatchingScheduler(model.engine).warmup(prompt_len=64)
    for qk in (False, True):
        tag = "qk" if qk else "qk_off"
        base = served(f"contiguous_{tag}", qk, ("qmatmul", "flash_prefill"))
        spec = served(f"contiguous_spec_{tag}", qk,
                      ("qmatmul", "flash_prefill") + (
                          ("flash_decode_qk_multi",) if qk else ()),
                      speculative=True)
        res[f"contiguous_spec_{tag}"]["held"] = _held_against(
            f"phase 14 (b) contiguous ({tag})", spec["ids"], base["ids"],
            prompts, model.engine.params, cfg, d)
    res["verify_times"] = _verify_times(model.engine, model.engine.params,
                                        card, profile)
    # (b) on the paged engine, then (c) mixed prefill there
    del model.engine
    torch.cuda.empty_cache()
    model._make_engine(params, 4, 2048, True, paged=True, page_size=128)
    ContinuousBatchingScheduler(model.engine).warmup(prompt_len=64)
    base = served("paged", False, ("qmatmul", "flash_prefill_paged"))
    for key, kw, kernels in (
            ("paged_spec", dict(speculative=True),
             ("qmatmul", "flash_prefill_paged")),
            ("paged_mixed", dict(mixed_prefill=True, mixed_chunk=32),
             ("qmatmul", "flash_prefill_paged"))):
        r = served(key, False, kernels, **kw)
        if "mixed" in key and not r["spec"]["prompt_chunk_steps"]:
            raise AssertionError("phase 14 (c): no joint step fed a prompt "
                                 "chunk (kernel 9 at T = 32)")
        r["held"] = _held_against(f"phase 14 ({'c' if 'mixed' in key else 'b'}"
                                  f") {key}", r["ids"], base["ids"], prompts,
                                  model.engine.params, cfg, d)
    eng = model.engine
    if eng._alloc.available != eng.n_pages - 1:
        raise AssertionError("phase 14: pages left allocated after the "
                             "paged runs")
    del model, eng, params
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _redesigned(name: str, shape: str) -> bool:
    """Cases of the bodies this tree redesigned, whose float32 sums may run
    in another order than the parent's, so their digests may differ: kernels
    B and 10 (`flash_decode...`, `flash_decode_paged...`: both products on
    the tensor cores, the splits merged in the same launch).  Every other
    case must keep its digest."""
    return name.startswith("flash_decode")


def compare_runs(paths) -> dict:
    """A pair run's `chip_smoke.json` files, in the order parent, change,
    parent: for every case that the runs share (kernel name and shape),
    whether the kernel's output digest is the same in all of them (the
    redesigned GEMM's cases apart, `_redesigned`), and per kernel the median
    of the cases' change / parent time ratios (against the mean of the two
    parent runs) beside the parent / parent median."""
    runs = []
    for p in paths:
        with open(p) as f:
            runs.append({(k["name"], c["shape"]): c for k in json.load(f)[
                "kernels"] for c in k["cases"]})
    p1, ch, p2 = runs
    shared = [key for key in p1 if key in ch and key in p2]
    differ = [key for key in shared
              if not p1[key]["digest"] == ch[key]["digest"]
              == p2[key]["digest"]]
    redesigned = [key for key in differ if _redesigned(*key)]
    differ = [key for key in differ if not _redesigned(*key)]
    ratios, noise = collections.defaultdict(list), collections.defaultdict(
        list)
    for key in shared:
        ratios[key[0]].append(ch[key]["ms"] / (0.5 * (p1[key]["ms"]
                                                      + p2[key]["ms"])))
        noise[key[0]].append(p2[key]["ms"] / p1[key]["ms"])
    res = dict(cases=len(shared), digests_differ=differ,
               redesigned_differ=len(redesigned),
               median_ratio={k: statistics.median(v)
                             for k, v in ratios.items()},
               parent_parent={k: statistics.median(v)
                              for k, v in noise.items()},
               all_cases=statistics.median(
                   [r for v in ratios.values() for r in v]),
               all_parent_parent=statistics.median(
                   [r for v in noise.values() for r in v]),
               only_in_change=sorted({k[0] for k in ch if k not in p1}),
               redesigned_cases=[
                   (key[0], key[1], ch[key]["ms"] / (0.5 * (p1[key]["ms"]
                                                            + p2[key]["ms"])))
                   for key in shared if _redesigned(*key)])
    log(json.dumps(res))
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks")
    ap.add_argument("--only", default="",
                    help="in phase 2, check only the kernels whose name "
                         "contains this (qmatmul_lut, flash, ...; several, "
                         "comma-separated)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one prefill and 8 decode steps of the "
                         "main path with torch.profiler")
    ap.add_argument("--compare-runs", nargs=3, metavar="JSON",
                    help="compare a pair run's chip_smoke.json files "
                         "(parent, change, parent): output digests and "
                         "kernel-time ratios per kernel; nothing else runs")
    ap.add_argument("--phases", default="",
                    help="run only these phases after the build (numbers "
                         "2-14, comma-separated; 6 needs 4); the default "
                         "runs every phase")
    args = ap.parse_args()
    phases = ({int(x) for x in args.phases.split(",")} if args.phases
              else set(range(2, 15)))
    if 6 in phases and 4 not in phases:
        ap.error("--phases: phase 6 serves phase 4's params")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.compare_runs:
        res = compare_runs(args.compare_runs)
        return 1 if res["digests_differ"] else 0
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

    log_phase("phase 1: build")
    _build.kernels.build()
    log(f"  built in {_build.kernels.build_seconds:.1f} s; seconds until each "
        f"source's nvcc ended: " + json.dumps(
            {k: round(v, 1) for k, v in _build.kernels.source_seconds.items()}))
    with open(os.path.join(OUT_DIR, "chip_smoke_build.log"), "w") as f:
        f.write(_build.kernels.build_log)

    log_phase("phase 2: kernels against their plain versions")
    chk = Checks(name)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for names, check in (("flash_decode", check_flash_decode),
                        ("flash_prefill", check_flash_prefill),
                        ("flash_decode_paged", check_flash_decode_paged),
                        ("flash_prefill_paged", check_flash_prefill_paged),
                        ("flash_decode_bf16 flash_prefill_bf16 "
                         "flash_decode_paged_bf16 flash_prefill_paged_bf16 "
                         "alibi", check_flash_variants),
                        ("flash_decode flash_prefill _f32 dims",
                         check_flash_dims),
                        ("flash_decode flash_prefill softcap _f32scale",
                         check_flash_softcap),
                        ("flash_decode flash_prefill noncausal _f32",
                         check_flash_noncausal),
                        ("flash_decode flash_prefill _f32 whisper",
                         check_flash_whisper_self),
                        ("flash_decode flash_decode_paged qk",
                         check_flash_qk),
                        ("flash_decode qk multi", check_flash_qk_multi),
                        ("flash_decode flash_decode_paged b1",
                         check_flash_decode_b1),
                        ("flash_decode flash_decode_paged decode_repeat",
                         check_flash_decode_repeat),
                        ("qmatmul_int4", check_qmatmul),
                        ("qmatmul_lut qmatmul_planar", check_fp_formats),
                        ("qmatmul_int8 qmatmul_int8_planar",
                         check_int8_formats),
                        ("qmatmul_int8 qmatmul_int8_planar int8_epilogue",
                         check_int8_epilogue),
                        ("ragged qmatmul_lut qmatmul_planar qmatmul_int8 "
                         "qmatmul_int8_planar", check_ragged_shapes),
                        ("qmatmul_grouped", check_grouped),
                        ("qmatmul_int qmatmul_planar", check_int_formats),
                        ("qmatmul_lut_f32 qmatmul_planar_f32 qmatmul_int_f32",
                         check_f32_formats),
                        ("qmatmul_lut_f32 qmatmul_planar_f32 qmatmul_int_f32 "
                         "f32_repeat", check_f32_repeat),
                        ("qmatmul_grouped_fp", check_grouped_fp),
                        ("qmatmul_lut qmatmul_planar qmatmul_int low_m",
                         check_gemm_low_m),
                        ("flash_rows flash_rows_paged rows",
                         check_flash_rows),
                        ("a_vs_p", check_a_vs_p),
                        ("gemv_odd", check_gemv_odd_rows),
                        ("gemm_rows", check_gemm_rows),
                        ("qmatmul_int8 qmatmul_int8_planar int8_rows gemm_rows",
                         check_int8_rows),
                        ("flash_prefill flash_prefill_paged prefill_cases",
                         check_flash_prefill_cases),
                        ("flash_prefill flash_prefill_repeat",
                         check_flash_prefill_repeat),
                        ("qmatmul_lut qmatmul_planar qmatmul_int fp_gemv",
                         check_fp_gemv),
                        ("fp_gemv_repeat", check_fp_gemv_repeat),
                        ("fp_gemv_launches", check_fp_gemv_launches),
                        ("decode_launches", check_flash_decode_launches)):
        if 2 in phases and any(o in names for o in args.only.split(",")):
            t_check = time.time()
            check(chk, gen)
            log(f"  [{check.__name__}: {time.time() - t_check:.1f} s]")
    torch.cuda.empty_cache()
    summary = {}
    counts = collections.Counter()
    instances = collections.Counter()
    if not args.kernels_only and 3 in phases:
        from neural_speed_tpu_torch.ops.qtypes import named_qspec

        log_phase("phase 3: tiny model on the card against the CPU")
        check_tiny_model("int4", named_qspec("int4", 64,
                                             scale_dtype="bfloat16"), None)
        check_tiny_model("int4 NST_KV_APPEND=defer", named_qspec(
            "int4", 64, scale_dtype="bfloat16"), None, seed_label="int4",
            kv_append="defer")
        for label, make_spec, comp, _, _ in format_configs():
            check_tiny_model(label, make_spec(64), comp)
        int4 = named_qspec("int4", 64, scale_dtype="bfloat16")
        check_tiny_model("mixtral int4", int4, None, tiny_moe_cfg(),
                         TINY_MOE_PROMPTS)
        check_tiny_model("mixtral int4 B=1", int4, None, tiny_moe_cfg(),
                         TINY_MOE_PROMPTS[:1])
        check_tiny_paged()
        check_tiny_checkpoints()
        check_tiny_hf()
        counts.update(check_tiny_grok())
        counts.update(check_tiny_whisper())
        for fmt in ("int8", "nf4"):
            counts.update(check_tiny_whisper(f"{fmt} g128",
                                             named_qspec(fmt, 128)))
        for qk in (False, True):
            counts.update(check_tiny_serving(qk))
    if not args.kernels_only and 4 in phases:
        log_phase("phase 4: Llama-2-7B-shaped int4 serving")
        params, cfg = params_7b()
        _build.reset_counts()
        summary, ref = serve_7b(params, cfg, args.profile)
        counts.update(_build.launches)
        for k in ("qmatmul", "flash_decode", "flash_prefill"):
            for part in ("ragged_counts", "bench_counts"):
                if summary[part].get(k, 0) <= 0:
                    raise AssertionError(f"{k} was not launched in {part}")
        if sum(_build.plain_dispatches.values()):
            raise AssertionError("a plain version ran on the main path: "
                                 f"{dict(_build.plain_dispatches)}")
        log(f"  main path launches {dict(_build.launches)}; plain-version "
            f"dispatches {dict(_build.plain_dispatches)}")
    if not args.kernels_only and 5 in phases:
        log_phase("phase 5: Llama-2-7B-shaped serving in the other weight "
                  "formats")
        summary["formats"] = serve_7b_formats()
        for res in summary["formats"].values():
            counts.update(res["prefill_counts"])
            counts.update(res["decode_counts"])
    if not args.kernels_only and 6 in phases:
        log_phase("phase 6: Llama-2-7B-shaped int4 serving through "
                  "PagedEngine")
        _build.reset_counts()
        summary["paged"] = serve_7b_paged(params, cfg, ref, args.profile)
        paged_counts = dict(_build.launches)
        for k in ("flash_decode_paged", "flash_prefill_paged"):
            if paged_counts.get(k, 0) <= 0:
                raise AssertionError(f"phase 6: {k} was not launched")
        for k in ("flash_decode", "flash_prefill"):
            if paged_counts.get(k, 0):
                raise AssertionError(f"phase 6: the contiguous kernel {k} "
                                     "ran on the paged path")
        if sum(_build.plain_dispatches.values()):
            raise AssertionError("phase 6: a plain version ran: "
                                 f"{dict(_build.plain_dispatches)}")
        summary["paged"]["launches"] = paged_counts
        log(f"  paged path launches {paged_counts}; plain-version "
            f"dispatches {dict(_build.plain_dispatches)}")
        counts.update(paged_counts)
    if not args.kernels_only and 4 in phases:
        del params, ref
        torch.cuda.empty_cache()
    if not args.kernels_only and 7 in phases:
        log_phase("phase 7: Mixtral-8x7B-shaped int4 serving")
        summary["mixtral"] = serve_mixtral(args.profile)
        for part in ("ragged", "paged_ragged"):
            counts.update(summary["mixtral"][part]["launches"])
        bench = summary["mixtral"]["bench"]
        counts.update(bench["launches_per_prefill"])
        counts.update({k: round(v * 64) for k, v in
                       bench["launches_per_decode_step"].items()})
        torch.cuda.empty_cache()
    if not args.kernels_only and 8 in phases:
        log_phase("phase 8: quantized checkpoints (GPTQ, GGUF) at full width "
                  "and depth")
        summary["checkpoints"] = serve_quantized(args.profile)
        for run in summary["checkpoints"].values():
            counts.update(run["prefill_counts"])
            counts.update(run["decode_counts"])
            ragged = run.get("ragged", {})
            for part in ragged.values() if "launches" not in ragged else (
                    ragged,):
                counts.update(part["launches"])
    for phase, what, serve, key in (
            (9, "float HF checkpoints (MPT-7B, BLOOM-7B1, Falcon-7B) at full "
             "width and depth", serve_hf, "hf"),
            (10, "the head dims 256, 80 and 96 and float32 K/V (Gemma-7B, "
             "GPT-J-6B, Phi-2, GPT-NeoX-20B) at full width and depth",
             serve_hf_dims, "hf_dims"),
            (11, f"Grok-1 at full width, {GROK_LAYERS} of its 64 layers "
             f"(the logit softcap, float32 KV scales)", serve_grok, "grok")):
        if not args.kernels_only and phase in phases:
            log_phase(f"phase {phase}: {what}")
            _build.reset_counts()
            summary[key] = serve(args.profile)
            for run in summary[key].values():
                if not isinstance(run, dict):
                    continue
                counts.update(run.get("launches", {}))
                counts.update(run.get("prefill_counts", {}))
                counts.update(run.get("decode_counts", {}))
                instances.update(run.get("prefill_instances", {}))
                instances.update(run.get("decode_instances", {}))
                for part in run.get("ragged", {}).values():
                    counts.update(part["launches"])
                    instances.update(part["instances"])
    if not args.kernels_only and 12 in phases:
        log_phase("phase 12: whisper-large-v2 at full width and depth "
                  "(AudioModel: float32, then int8, nf4, int5)")
        summary["whisper"] = serve_whisper(args.profile)
        for run in (summary["whisper"], *summary["whisper"]["quant"].values()):
            counts.update(run["launches"])
            instances.update(run["instances"])
    if not args.kernels_only and 13 in phases:
        log_phase("phase 13: Llama-2-7B int4 served through api.Model / "
                  "ModelServer (PagedEngine, int8 pool), qk off then on")
        summary["serving"] = serve_model_server(args.profile)
        for key in ("qk_off", "qk"):
            counts.update(summary["serving"][key]["launches"])
            instances.update(summary["serving"][key]["instances"])
    if not args.kernels_only and 14 in phases:
        log_phase("phase 14: Llama-2-7B int4 speculative and mixed-prefill "
                  "serving (the single-sequence helper, ModelServer over "
                  "Engine and PagedEngine), qk off then on")
        summary["speculative"] = serve_speculative(name, args.profile)
        multi = collections.Counter()
        for run in summary["speculative"].values():
            counts.update(run.get("launches", {}))
            instances.update(run.get("instances", {}))
            multi.update(run.get("multi_launches", {}))
        log(f"  phase 14: kernel B's t > 1 launches per token count "
            f"{dict(multi)}")
    if not args.kernels_only:
        log(f"  launches over the paths {dict(counts)}; attention launches "
            f"per head-dim instance in phases 9-12 {dict(instances)}")

    launches_of = {"qmatmul_int4": "qmatmul"}
    kernels = []
    for rec in chk.records.values():
        main = next((c for c in rec["cases"] if c["main"]), rec["cases"][0])
        kernels.append(dict(
            name=rec["name"], route=rec["route"], source=rec["source"],
            replaces=rec["replaces"],
            launches=counts.get(launches_of.get(rec["name"], rec["name"]), 0),
            max_abs_err=max(c["max_abs_err"] for c in rec["cases"]),
            ms=main["ms"], plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], library_ms=main["library_ms"],
            shape=main["shape"], cases=rec["cases"]))
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(card=card_line,
                       build_s=_build.kernels.build_seconds,
                       kernels=kernels, checks=chk.notes, e2e=summary), f,
                  indent=1)
    log_phase("done")
    log(json.dumps({"kernels": [{k: v for k, v in r.items() if k != "cases"}
                                for r in kernels]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
