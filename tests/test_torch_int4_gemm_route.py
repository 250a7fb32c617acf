"""The host side of kernel A's and kernel 11's redesigned bodies, on the CPU
(numpy emulations of the device arithmetic: no kernel runs here).

* The bf16x2 dequantization of kernel A's format in the TMA + wgmma GEMM
  (`csrc/qmm_fp.cuh::a4_chunk`): prmt of the word and the word >> 4, lop3
  with 0x000F000F / 0x43004300, hsub2 of 136, hmul2 by the bands' scale
  pair, emulated bit for bit, equals `dequantize(qt, torch.bfloat16)` for
  all 16 codes times every finite bf16 scale (negative, subnormal, tiny,
  large: every exponent), and lands in the chunk in band order, so the
  product over band-major x (`_band_major`, no x permutation) equals the
  product in K order.
* Kernel A's packs and kernel 11's stacks route to their kernels at the
  Llama-2-7B, Mixtral-8x7B and Grok-1 shapes, the ragged N = 264 and the
  repadded K = 11264; the entries run the template with A4 and no `wmma`
  GEMM is left.
* The 9-32-row GEMV (`csrc/qmm_int4.cuh::gemv_mma_kernel`): its fragment
  mapping over band-major x emulated lane by lane (m16n8k8 as PTX defines
  the fragments) gives x @ W exactly on integer data, every output row and
  column written once and every word row read once, at M = 9, 16, 31 and
  32.
* The card's bm (`moe.choose_bm` on a CUDA device: 128 whatever K): a
  token's `moe_ffn` output does not depend on bm, held against the JAX
  package on the CPU.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu.models import transformer as jtr
from neural_speed_tpu_torch.models import transformer as ttr
from neural_speed_tpu_torch.models.params import params_from_numpy
from neural_speed_tpu_torch.ops import matmul as tmm
from neural_speed_tpu_torch.ops import moe as tmoe
from neural_speed_tpu_torch.ops.qtypes import named_qspec
from neural_speed_tpu_torch.ops.quantize import QTensor, dequantize, pack_codes

from tests.test_torch_moe import _cfgs, _hold, _moe_params, _x, BF16_ULPS2, RTOL
from tests.torch_port_util import tree_to_numpy

CSRC = Path(tmm.__file__).resolve().parent.parent / "csrc"


# ---------------------------------------------------------------------------
# the bf16x2 dequantization
# ---------------------------------------------------------------------------


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _f32_to_bf16_bits(v: np.ndarray) -> np.ndarray:
    """IEEE round to nearest even, as the card's bf16 arithmetic."""
    t = torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def _byte_perm(x: np.ndarray, y: np.ndarray, sel: int) -> np.ndarray:
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of
    the 8-byte value y:x."""
    xy = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros(x.shape, np.uint64)
    for i in range(4):
        src = (sel >> (4 * i)) & 7
        byte = (xy >> np.uint64(8 * src)) & np.uint64(0xFF)
        out |= byte << np.uint64(8 * i)
    return out.astype(np.uint32)


def a4_chunk(w: np.ndarray, s_bits: np.ndarray) -> np.ndarray:
    """`a4_chunk` on words `w` [...] (uint32) with the 8 bands' bf16 scales
    `s_bits` [..., 8] (uint16 bit patterns): the chunk's 8 bf16 weights
    [..., 8] as uint16 bits, each pair computed as the kernel does."""
    w4 = w >> np.uint32(4)
    out = np.zeros(w.shape + (8,), np.uint16)
    for j in range(4):
        t = _byte_perm(w, w4, j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12))
        v = (t & np.uint32(0x000F000F)) | np.uint32(0x43004300)
        for half, band in ((0, 2 * j), (1, 2 * j + 1)):
            h = _bf16_bits_to_f32(((v >> np.uint32(16 * half)) & 0xFFFF)
                                  .astype(np.uint16))
            # hsub2: 128 + c - 136, exact; hmul2: the exact product rounded
            # once (float32 holds it: 8-bit by 4-bit significands)
            d = _f32_to_bf16_bits(h - np.float32(136.0))
            with np.errstate(over="ignore"):   # the largest scales: inf
                p = _bf16_bits_to_f32(d) * _bf16_bits_to_f32(s_bits[..., band])
            out[..., band] = _f32_to_bf16_bits(p)
    return out


def _every_bf16_scale() -> np.ndarray:
    """Every finite bf16 value, both signs, zero and subnormals included."""
    bits = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
    exp = (bits >> 7) & 0xFF
    return bits[exp != 0xFF]


def test_a4_chunk_is_dequantize_for_every_code_and_scale():
    scales = _every_bf16_scale()
    n = scales.size
    k, g = 128, 128                                  # KW = 16, one group
    kw = k // 8
    codes = np.broadcast_to((np.arange(k) % 16)[:, None], (k, n))
    # every code in every band at some word row, shifted per column
    codes = (codes + np.arange(n)[None, :]) % 16
    words = pack_codes(torch.from_numpy(codes.astype(np.int64)), 4)[0]
    sc = torch.from_numpy(scales.view(np.int16)[None, :].copy()).view(
        torch.bfloat16)
    qt = QTensor((words,), sc, None, None,
                 named_qspec("int4", g, scale_dtype="bfloat16"), (k, n))
    want = dequantize(qt, torch.bfloat16).view(torch.int16).numpy().view(
        np.uint16)
    w = words.numpy().view(np.uint32)                # [KW, N]
    s8 = np.broadcast_to(scales[None, :, None], (kw, n, 8))
    got = a4_chunk(w, s8)                            # [KW, N, 8]
    for b in range(8):
        np.testing.assert_array_equal(got[:, :, b], want[b * kw:(b + 1) * kw])
    # the sweep covers every exponent and both signs
    exps = np.unique((scales >> 7) & 0xFF)
    assert exps.size == 255 and (scales >> 15).min() == 0 \
        and (scales >> 15).max() == 1


def test_a4_chunks_over_band_major_x_rebuild_the_product():
    """The GEMM's K step s is 8 word rows x 8 bands; chunk r of a column is
    a4_chunk of word [s * 8 + r, n], at k' = 8 (s * 8 + r) + band: band
    order, so x in band-major order (`_band_major`, k' = r * 8 + b) and no
    permutation of x gives the product in K order, exactly (integer codes,
    scale 1, small integer x)."""
    rng = np.random.default_rng(4)
    k, n = 512, 264
    kw = k // 8
    codes = rng.integers(0, 16, (k, n))
    words = pack_codes(torch.from_numpy(codes), 4)[0].numpy().view(np.uint32)
    one = np.full((kw, n, 8), 0x3F80, np.uint16)     # bf16 1.0
    tiles = a4_chunk(words, one)                      # [KW, N, 8]
    w_kprime = _bf16_bits_to_f32(tiles.transpose(0, 2, 1).reshape(k, n))
    x = rng.integers(-3, 4, (5, k)).astype(np.float32)
    xk = tmm._band_major(torch.from_numpy(x), 8).numpy()
    np.testing.assert_array_equal(xk.astype(np.float64) @ w_kprime,
                                  x.astype(np.float64) @ (codes - 8))


# ---------------------------------------------------------------------------
# routing and the entries
# ---------------------------------------------------------------------------

A_SHAPES = {"qkv": (4096, 12288), "o": (4096, 4096), "gateup": (4096, 22016),
            "down": (11264, 4096), "head": (4096, 32000),
            "grok qkv": (6144, 10240), "grok o": (6144, 6144),
            "grok head": (6144, 131072), "ragged": (384, 264)}
STACK_SHAPES = {"mixtral gate/up": (4096, 14336), "mixtral down": (14336, 4096),
                "grok gate/up": (6144, 32768), "grok down": (32768, 6144),
                "ragged": (384, 264)}


def _a_pack(k, n, g=128):
    spec = named_qspec("int4", g, scale_dtype="bfloat16")
    return QTensor((torch.empty((k // 8, n), dtype=torch.int32),),
                   torch.empty((k // g, n), dtype=torch.bfloat16), None, None,
                   spec, (k, n))


@pytest.mark.parametrize("shape", list(A_SHAPES))
def test_a_packs_route_to_kernel_a(shape):
    k, n = A_SHAPES[shape]
    qt = _a_pack(k, n)
    assert tmm.kernel_for(qt) == "A" and tmm.kernel_takes(qt)
    assert tmm.kernel_route(qt, torch.bfloat16) == "A"


@pytest.mark.parametrize("shape", list(STACK_SHAPES))
def test_int4_stacks_route_to_kernel_11(shape):
    k, n = STACK_SHAPES[shape]
    qt = _a_pack(k, n)
    e = 8
    st = tmoe.StackedExperts(
        (qt.data[0][None].expand(e, k // 8, n),),
        qt.scales[None].expand(e, *qt.scales.shape), None, qt.spec, (k, n), e)
    assert tmoe.grouped_kernel_for(st) == "11" and tmoe.grouped_kernel_takes(st)


def _strip_comments(src: str) -> str:
    return re.sub(r"//[^\n]*", "", src)


def test_entries_run_the_template_and_no_wmma_gemm_is_left():
    """Kernel A's and kernel 11's GEMM entries launch the TMA + wgmma
    template with A4 (both bm for 11); the int4 header keeps the GEMVs and
    the split-K sum only."""
    a = _strip_comments((CSRC / "qmatmul.cu").read_text())
    g = _strip_comments((CSRC / "qmatmul_grouped.cu").read_text())
    h = _strip_comments((CSRC / "qmm_int4.cuh").read_text())
    assert re.search(r"launch_gemm<nstfp::FMT_INT4, 2, false, __nv_bfloat16, "
                     r"true>", a)
    for mi in (2, 1):
        assert re.search(rf"launch_gemm<nstfp::FMT_INT4, {mi}, true, float, "
                         rf"true>", g)
    assert "wmma" not in h and "gemm_int4_kernel" not in h
    kernels = set(re.findall(
        r"__global__ void(?:\s+__launch_bounds__\([^)]*\))?\s+(\w+)\(", h))
    assert kernels == {"gemv_int4_kernel", "splitk_reduce_kernel",
                       "gemv_mma_kernel"}


# ---------------------------------------------------------------------------
# the 9-32-row GEMV: fragments, tiling, one pass
# ---------------------------------------------------------------------------

MMA_BN = tmm.GEMV_MMA_COLS


def _mma_gemv(x, words, scales, g, splits):
    """gemv_mma_kernel's index math lane by lane; returns the output, how
    often each (row, column) was written, and how often each word row was
    read by each column's lanes."""
    m, k = x.shape
    n = words.shape[1]
    kw = k // 8
    xk = tmm._band_major(torch.from_numpy(x), 8).numpy()
    rows = ((kw + splits - 1) // splits + 7) // 8 * 8
    mt16 = 2 if m > 16 else 1
    part = np.zeros((splits, m, n))
    written = np.zeros((splits, m, n), np.int64)
    reads = np.zeros((kw, n), np.int64)
    codes = np.stack([(words >> (4 * b)) & 15 for b in range(8)])   # [8,KW,N]
    for split in range(splits):
        kb0, kb1 = split * rows, min(split * rows + rows, kw)
        for c0 in range(0, -(-n // MMA_BN) * MMA_BN, 32):   # warps
            acc = np.zeros((mt16, 4, 32, 4))      # [i][jn][lane][reg]
            for kb in range(kb0, kb1, 8):
                for lane in range(32):
                    gq, t = lane // 4, lane % 4
                    if c0 + 4 * gq < n:
                        for r in range(2):
                            reads[kb + 2 * t + r, c0 + 4 * gq:c0 + 4 * gq + 4] += 1
                for band in range(8):
                    for jn in range(4):
                        bm = np.zeros((8, 8))      # B[k][col] from lanes
                        for lane in range(32):
                            gq, t = lane // 4, lane % 4
                            col = c0 + 4 * gq + jn
                            if c0 + 4 * gq >= n:
                                continue
                            s = scales[(band * kw + kb) // g, col]
                            for r, kk in ((0, t), (1, t + 4)):
                                c = codes[band, kb + 2 * t + r, col]
                                bm[kk, gq] = s * (c - 8)
                        for i in range(mt16):
                            am = np.zeros((16, 8))
                            for lane in range(32):
                                gq, t = lane // 4, lane % 4
                                for h in range(2):
                                    row = 16 * i + gq + 8 * h
                                    if row >= m:
                                        continue
                                    # band b of the uint4s at word rows
                                    # kb + 2t and kb + 2t + 1 of band-major x
                                    kx = (kb + 2 * t) * 8 + band
                                    am[gq + 8 * h, t] = xk[row, kx]
                                    am[gq + 8 * h, t + 4] = xk[row, kx + 8]
                            d = am @ bm
                            for lane in range(32):
                                gq, t = lane // 4, lane % 4
                                acc[i, jn, lane] += [d[gq, 2 * t], d[gq, 2 * t + 1],
                                                     d[gq + 8, 2 * t],
                                                     d[gq + 8, 2 * t + 1]]
            for lane in range(32):
                gq, t = lane // 4, lane % 4
                n8 = c0 + 8 * t
                if n8 >= n:
                    continue
                for i in range(mt16):
                    for h in range(2):
                        row = 16 * i + gq + 8 * h
                        if row >= m:
                            continue
                        for e in range(2):
                            for jn in range(4):
                                col = n8 + 4 * e + jn
                                part[split, row, col] = acc[i, jn, lane, 2 * h + e]
                                written[split, row, col] += 1
    return part.sum(0), written, reads


@pytest.mark.parametrize("m", [9, 16, 31, 32])
def test_mma_gemv_tiling_covers_every_row_once(m):
    rng = np.random.default_rng(m)
    k, n, g, splits = 128, 264, 32, 2
    codes = rng.integers(0, 16, (k, n))
    words = pack_codes(torch.from_numpy(codes), 4)[0].numpy().view(np.uint32)
    words = words.astype(np.int64)
    scales = rng.integers(1, 4, (k // g, n)).astype(np.float64)
    x = rng.integers(-3, 4, (m, k)).astype(np.float64)
    got, written, reads = _mma_gemv(x, words, scales, g, splits)
    w = np.repeat(scales, g, axis=0) * (codes - 8)
    np.testing.assert_array_equal(got, x @ w)
    assert (written == 1).all()            # every split writes its partials
    assert (reads == 1).all()              # one pass over the words


def test_gemv_rows_go_to_one_launch_shape():
    """Rows 1-8 take the CUDA-core bodies (512 columns a block), 9-32 the
    tensor-core one (128): the wrapper's split rule follows the body."""
    assert tmm.GEMV_SIMT_MAX_M == 8 and tmm.GEMV_MAX_M == 32
    for k, n in A_SHAPES.values():
        for cols in (512, MMA_BN):
            splits = tmm._gemv_splits(k, n, 132, 8, cols)
            rows = -(-(k // 8) // splits)
            assert splits >= 1 and -(-(k // 8) // rows) <= splits


# ---------------------------------------------------------------------------
# the card's bm
# ---------------------------------------------------------------------------


def test_choose_bm_on_the_card_is_128_whatever_k():
    for k in (4096, 14336, 32768, 65536):
        assert tmoe.choose_bm(k, torch.bfloat16, torch.device("cuda")) == 128
        assert tmoe.choose_bm(k, torch.bfloat16, "cpu") == tmoe.choose_bm(
            k, torch.bfloat16)
    # the JAX package's rule on the CPU: Grok-1's K = 32768 takes 64
    assert tmoe.choose_bm(32768, torch.bfloat16) == 64
    assert tmoe.choose_bm(14336, torch.bfloat16) == 128


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_ffn_per_token_output_is_independent_of_bm(dtype, monkeypatch):
    """The grouped path of `moe_ffn` routed at bm = 64 and at bm = 128 (the
    card's block whatever K) gives each token the same output, and both
    hold against the JAX package's `moe_ffn` (its own bm) as
    `test_torch_moe.py` holds the grouped path."""
    jcfg, tcfg = _cfgs()
    jp = _moe_params(11, "stacked")
    tp = params_from_numpy(tree_to_numpy(jp), device="cpu")
    jx, tx = _x(12, (2, 9, 128), dtype)
    want = jtr.moe_ffn(jx, jp, jcfg)
    outs = {}
    for bm in (64, 128):
        monkeypatch.setattr(tmoe, "choose_bm", lambda *a, bm=bm, **k: bm)
        outs[bm] = ttr.moe_ffn(tx, tp, tcfg)
        _hold(outs[bm], want, dtype, BF16_ULPS2)
    a, b = (outs[bm].float().numpy() for bm in (64, 128))
    tol = (RTOL if dtype == "float32" else 0.0) * np.abs(a).max()
    np.testing.assert_allclose(a, b, rtol=0, atol=tol)
    assert np.asarray(jnp.asarray(want)).shape == a.shape
