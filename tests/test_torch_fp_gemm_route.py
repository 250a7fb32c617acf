"""The host side of the GEMM of kernels F, P and P's one-plane INT
instances and of their grouped instances (`csrc/qmm_fp.cuh`), on the CPU.

* `kernel_takes` / `grouped_kernel_takes` accept every pack the serving
  paths use (the weight formats of phases 5 and 8, the checkpoints'
  zero modes, Mixtral's grouped stacks) at the 7B and 8x7B shapes and at a
  ragged N (264, a multiple of 8 only), and route each to its kernel: a
  redesign of the GEMM must not quietly narrow `_fp_shape_ok`.  (The
  shapes checks read shapes and dtypes only, so the 7B packs are
  allocated, not drawn.)
* The tile walk the GEMM relies on, rebuilt with numpy over packs drawn by
  the port's `pack_codes`: x in band-major order (`_band_major`,
  k' = r * EF + b for k = b * KW + r); each plane viewed as its 4-D tensor
  map (N, rows of a band block, band blocks, experts) and cut into the
  boxes (BN, R = 64 / EF, q, 1) that the producer loads at (n_blk, s * R,
  0, e); each weight's code rebuilt from its planes' words as the
  dequantizing threads do (`code_of`), and the 16-byte chunk of 8
  consecutive k' it lands in.  The product over the rebuilt band-major
  tiles equals the product over the codes in K order, exactly (integer
  codes and small integer x).
* The scale staging: a dequantizing thread holds one (group, column) per
  band for a whole K step (packed formats) or per 8-row run (byte rows),
  so for every pack `_fp_shape_ok` takes, the rows a thread covers in a
  step lie in one group; and it reloads a band's scale exactly when its
  group changes (once per group).
"""

import numpy as np
import pytest
import torch

from neural_speed_tpu_torch.ops import matmul as tmm
from neural_speed_tpu_torch.ops import moe as tmoe
from neural_speed_tpu_torch.ops.qtypes import named_qspec, plane_widths
from neural_speed_tpu_torch.ops.quantize import QTensor, pack_codes

BK, BN = 64, 128

# (name, group, symmetric, scale dtype, zeros): the packs of phases 5 and 8
# and of the converters (GPTQ / AWQ uint8 zero points, GGUF float offsets,
# double-quantized scales).
PACKS = [
    ("nf4", 128, True, "bfloat16", None),
    ("nf4", 64, True, "float32", None),
    ("fp4", 128, True, "float32", None),
    ("int5", 128, False, "bfloat16", "uint8"),
    ("int5", 128, True, "bfloat16", None),
    ("int3", 128, True, "bfloat16", None),
    ("int6", 128, True, "float32", None),
    ("int7", 128, True, "bfloat16", None),
    ("fp8_e4m3", 128, True, "bfloat16", None),
    ("fp8_e5m2", 128, True, "float32", None),
    ("int1", 128, True, "bfloat16", None),
    ("int2", 128, False, "float32", "uint8"),
    ("int2", 16, False, "float32", "float32"),     # GGUF Q2_K
    ("int4", 128, False, "float32", "uint8"),      # GPTQ / AWQ
    ("int4", 32, True, "float32", None),           # GGUF Q4_0
    ("int4", 32, False, "float32", "float32"),     # GGUF Q4_1 / K-quants
    ("int6", 16, False, "float32", "float32"),     # GGUF Q6_K-like offsets
    ("int8", 32, True, "float32", None),           # GGUF Q8_0
    ("int8", 128, False, "float32", "uint8"),
    ("int8", 16, False, "float32", "float32"),
    ("int4", 128, True, "float32", "dq"),          # double-quantized
]
SHAPES_7B = {"qkv": (4096, 12288), "o": (4096, 4096),
             "gateup": (4096, 22016), "down": (11008, 4096),
             "head": (4096, 32000)}


def _pack_like(name, g, sym, sdt, zeros, k, n):
    """A pack of the format's planes, scales and zeros (allocated only)."""
    spec = named_qspec(name, g, sym, scale_dtype=sdt,
                       double_quant=zeros == "dq")
    widths = tmm.planes_of(spec)
    data = ((torch.empty((k, n), dtype=torch.uint8),) if widths == (8,)
            else tuple(torch.empty((k * w // 32, n), dtype=torch.int32)
                       for w in widths))
    gk = spec.effective_group(k)
    sdtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[sdt]
    scales = torch.empty((k // gk, n), dtype=(
        torch.int8 if zeros == "dq" else sdtype))
    sscale = torch.empty((1, n)) if zeros == "dq" else None
    z = {None: None, "dq": None,
         "uint8": torch.empty((k // gk, n), dtype=torch.uint8),
         "float32": torch.empty((k // gk, n))}[zeros]
    return QTensor(data, scales, z, sscale, spec, (k, n))


def _k_for(spec, k):
    """K as the loaders pad it: a multiple of the pack period x 128."""
    period = tmm.kernel_k_multiple(spec) * 128
    return -(-k // period) * period


@pytest.mark.parametrize("shape", list(SHAPES_7B) + ["ragged"])
@pytest.mark.parametrize("pack", PACKS, ids=[
    f"{p[0]}-g{p[1]}{'' if p[2] else '-asym'}-{p[3][:4]}-{p[4]}"
    for p in PACKS])
def test_kernel_takes_serving_packs(pack, shape):
    name, g, sym, sdt, zeros = pack
    spec = named_qspec(name, g, sym)
    if shape == "ragged":
        k, n = 3 * tmm.kernel_k_multiple(spec) * g, 264
    else:
        k, n = SHAPES_7B[shape]
        k = _k_for(spec, k)
    qt = _pack_like(name, g, sym, sdt, zeros, k, n)
    assert tmm.kernel_for(qt) in ("A", "F", "P", "I")
    assert tmm.kernel_takes(qt), tmm._describe(qt)


# Mixtral's grouped stacks (phase 7 and phase 8's GGUF / nf4 Mixtral)
STACKS = [("int4", 32, True, "float32"), ("int4", 128, False, "float32"),
          ("int8", 128, True, "bfloat16"), ("nf4", 128, True, "bfloat16"),
          ("int2", 128, True, "bfloat16"), ("int1", 128, True, "bfloat16"),
          ("int4", 128, True, "bfloat16")]


@pytest.mark.parametrize("proj", ["gate/up", "down"])
@pytest.mark.parametrize("stack", STACKS,
                         ids=[f"{s[0]}-g{s[1]}{'' if s[2] else '-asym'}-"
                              f"{s[3][:4]}" for s in STACKS])
def test_grouped_kernel_takes_mixtral_stacks(stack, proj):
    name, g, sym, sdt = stack
    k, n = {"gate/up": (4096, 14336), "down": (14336, 4096)}[proj]
    qt = _pack_like(name, g, sym, sdt, None if sym else "uint8", k, n)
    e = 8
    st = tmoe.StackedExperts(
        tuple(d[None].expand(e, *d.shape) for d in qt.data),
        qt.scales[None].expand(e, *qt.scales.shape),
        None if qt.zeros is None else qt.zeros[None].expand(
            e, *qt.zeros.shape), qt.spec, (k, n), e)
    assert tmoe.grouped_kernel_for(st) in ("11", "fp")
    assert tmoe.grouped_kernel_takes(st)


def test_band_major_matches_numpy():
    rng = np.random.default_rng(0)
    for bands in (1, 8, 16, 32):
        k = 256 * 3
        x = rng.standard_normal((37, k)).astype(np.float32)
        got = tmm._band_major(torch.from_numpy(x), bands).numpy()
        kw = k // bands
        want = np.empty_like(x)
        for r in range(kw):
            for b in range(bands):
                want[:, r * bands + b] = x[:, b * kw + r]
        np.testing.assert_array_equal(got, want)


def _tile_walk(planes, bits, k, n, n_experts=1):
    """The codes a GEMM of the port's design dequantizes, rebuilt from the
    stored planes through its boxes: returns [E, K', N] codes in band-major
    order k' (step s, 16-byte chunk c, lane j -> k' = 64 s + 8 c + j)."""
    if bits == 8:    # byte rows: boxes (BN, 64) at (n_blk, 64 s)
        rows = [np.asarray(p) for p in planes][0].reshape(n_experts, k, n)
        out = np.zeros((n_experts, k, n), np.int64)
        for e in range(n_experts):
            for s in range(-(-k // BK)):
                for n0 in range(0, n, BN):
                    box = rows[e, s * BK:(s + 1) * BK, n0:n0 + BN]
                    out[e, s * BK:s * BK + box.shape[0], n0:n0 + BN] = box
        return out
    widths = plane_widths(bits)
    ef = 32 // min(widths)
    kw, r_step = k // ef, BK // ef
    q = [ef * w // 32 for w in widths]
    # each plane as its map: (experts, band blocks q, rows KW, N)
    maps = [np.asarray(p).view(np.uint32).reshape(n_experts, qp, kw, n)
            for p, qp in zip(planes, q)]
    out = np.zeros((n_experts, k, n), np.int64)
    for e in range(n_experts):
        for s in range(k // BK):
            for n0 in range(0, n, BN):
                boxes = [m[e, :, s * r_step:(s + 1) * r_step, n0:n0 + BN]
                         for m in maps]          # [q][R][<=BN] words
                for i in range(r_step):
                    for b in range(ef):
                        code = np.zeros(boxes[0].shape[-1], np.int64)
                        shift = bits
                        for w, qp, box in zip(widths, q, boxes):
                            shift -= w
                            word = box[b % qp, i].astype(np.int64)
                            code |= ((word >> (w * (b // qp)))
                                     & ((1 << w) - 1)) << shift
                        kp = s * BK + i * ef + b   # chunk (i*ef+b)//8, lane b%8
                        out[e, kp, n0:n0 + BN] = code
    return out


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6, 7, 8])
def test_tile_walk_rebuilds_the_product(bits):
    """The boxes, the code rebuild and band-major x give x @ codes exactly,
    for one matrix and for a stack of 3 experts (the expert coordinate)."""
    rng = np.random.default_rng(bits)
    k, n, e = 512, 264, 3
    codes = rng.integers(0, 1 << bits, (e, k, n))
    planes = [pack_codes(torch.from_numpy(codes[i]), bits) for i in range(e)]
    stacked = tuple(torch.stack([p[j] for p in planes])
                    for j in range(len(planes[0])))
    walked = _tile_walk([p.numpy() for p in stacked], bits, k, n, e)
    ef = 1 if bits == 8 else 32 // min(plane_widths(bits))
    x = rng.integers(-3, 4, (5, k)).astype(np.float64)
    xk = tmm._band_major(torch.from_numpy(x), ef).numpy()
    for i in range(e):
        np.testing.assert_array_equal(xk @ walked[i], x @ codes[i])


@pytest.mark.parametrize("pack", [p for p in PACKS if p[4] != "dq"], ids=[
    f"{p[0]}-g{p[1]}{'' if p[2] else '-asym'}-{p[4]}"
    for p in PACKS if p[4] != "dq"])
def test_scale_groups_held_per_step(pack):
    """For the 7B shapes and the ragged one: the rows a thread dequantizes
    in a step lie in one group of each band, and the reload rule (the band
    row where the held group ends) fires once per group."""
    name, g, sym, _, _ = pack
    spec = named_qspec(name, g, sym)
    bits8 = tmm.planes_of(spec) == (8,)
    ef = tmm._finest_bands(spec)
    for k in [_k_for(spec, kk) for kk, _ in SHAPES_7B.values()] + [
            3 * tmm.kernel_k_multiple(spec) * g]:
        gk = spec.effective_group(k)
        if bits8:
            for k0 in range(0, k, 8):          # one thread's 8-row run
                assert k0 // gk == (k0 + 7) // gk
            continue
        kw, r = k // ef, BK // ef
        for b in range(ef):
            rows = np.arange(kw)
            groups = (b * kw + rows) // gk
            step_groups = groups.reshape(-1, r)
            assert (step_groups == step_groups[:, :1]).all()
            # the kernel's reload rule, walked step by step
            loads, nxt = [], 0
            for s in range(kw // r):
                if s * r >= nxt:
                    grp = (b * kw + s * r) // gk
                    nxt = (grp + 1) * gk - b * kw
                    loads.append(grp)
            assert loads == sorted(set(groups.tolist()))
