"""The host side of kernels G and H (int8 compute), redesigned for Hopper, on
the CPU: numpy emulations of the device arithmetic (no kernel runs here).

* The transform of the GEMM (`csrc/qmm_int8.cuh::transform_pair` /
  `transform_bytes`): the byte-parallel gather of two bands from four word
  rows (prmt), the shift and masks, G's fold `((code | 0x80) - zp) ^ 0x80`
  and the 8-bit rows' `code ^ 0x80`, emulated bit for bit with the threads'
  16-byte chunks stored through the 128-byte swizzle, equal
  `unpack_codes(...) - zp` for every code, every zero point and every width
  2-8 (H: the planes' raw codes, shifted and summed, less the zero point).
* The GEMM's walk (plane, chunk of CR word rows, band): every word row of
  every plane is loaded once, every K step lies inside one group, steps
  are padded to a multiple of 32 with zero weight rows; emulated with int32
  partials (each below 2^22, the range of the exact float conversion) and
  the kernel's float32 fold order, it equals the JAX package's
  `qmatmul_int8` (Pallas bodies in interpret mode) within (K / g) float32
  ulps of the largest output, for G and H, grouped and per token.
* The GEMV (M <= 32): its m16n8k32 fragments emulated lane by lane as PTX
  defines them, over K splits (a cluster) and steps that meet several
  groups, give `xq @ (code - zp)` exactly on integer data at M = 9, 16, 31
  and 32, every output written once.
* The epilogue's one rounding: the sum times the per-token scale, then
  bf16, equals `(out.float() * ascale).to(bfloat16)`.
* Routing and sources: G / H packs at the Llama-2-7B shapes and the ragged
  N = 264 route to the kernels' entries with the argument counts the
  wrapper binds; the GEMM runs wgmma on int8 operands and the PR 3
  single-buffered mma.sync GEMM is gone.
"""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu.ops import matmul as jm
from neural_speed_tpu.ops.qtypes import named_qspec as jax_named_qspec
from neural_speed_tpu_torch.ops import matmul as tmm
from neural_speed_tpu_torch.ops.qtypes import named_qspec, plane_widths
from neural_speed_tpu_torch.ops.quantize import QTensor, pack_codes, unpack_codes

from tests.torch_port_util import port_qtensor

jq = importlib.import_module("neural_speed_tpu.ops.quantize")

CSRC = Path(tmm.__file__).resolve().parent.parent / "csrc"
U32 = np.uint32


# ---------------------------------------------------------------------------
# device primitives
# ---------------------------------------------------------------------------


def _byte_perm(x, y, sel: int):
    """CUDA's __byte_perm: byte i of the result is byte (sel >> 4i) & 7 of
    the 8-byte value y:x."""
    xy = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(x, np.uint64)
    out = np.zeros(np.shape(xy), np.uint64)
    for i in range(4):
        src = (sel >> (4 * i)) & 7
        out |= ((xy >> np.uint64(8 * src)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(U32)


def gather4(w0, w1, w2, w3, sel):
    return _byte_perm(_byte_perm(w0, w1, sel), _byte_perm(w2, w3, sel), 0x5410)


def fold4(c, zp4):
    return ((np.asarray(c, U32) | U32(0x80808080)) - np.asarray(zp4, U32)) \
        ^ U32(0x80808080)


def byte_x4(z, j):
    return ((np.asarray(z, U32) >> U32(8 * j)) & U32(255)) * U32(0x01010101)


def bytes_of(v):
    """uint32 [...] -> int8 [..., 4], little-endian (byte i = K value i)."""
    return np.asarray(v, U32)[..., None].view(np.uint8).reshape(
        np.shape(v) + (4,)).view(np.int8)


def exact_float(v):
    """`exact_float`: the bits of 1.5 * 2^23 + v as a float, less 1.5 * 2^23."""
    v = np.asarray(v, np.int64)
    assert ((v >= -2 ** 22) & (v < 2 ** 22)).all()
    bits = (0x4B400000 + v).astype(np.uint32)
    return bits.view(np.float32) - np.float32(12582912.0)


def sw128_chunk(row, ch):
    return row * 128 + ((ch ^ (row & 7)) << 4)


def fma32(acc, v, w):
    """float32 acc + v * w rounded once (float64 holds the exact product of
    a 22-bit integer and a float32)."""
    return (acc.astype(np.float64) + v.astype(np.float64) * w.astype(np.float64)
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# the GEMM's transform and walk
# ---------------------------------------------------------------------------

BN = 128


def _pack(bits, sym, k, n, g, rng, scale_dtype=torch.bfloat16):
    codes = rng.integers(0, 1 << bits, (k, n))
    spec = named_qspec(f"int{bits}", g, sym)
    zeros = None if sym else torch.from_numpy(
        rng.integers(0, 1 << bits, (k // g, n)).astype(np.uint8))
    scales = torch.from_numpy(rng.uniform(0.5, 2.0, (k // g, n)).astype(
        np.float32)).to(scale_dtype)
    qt = QTensor(pack_codes(torch.from_numpy(codes), bits), scales, zeros, None,
                 spec, (k, n))
    return qt, codes


def _zp(qt, k):
    """Zero point per (group, column): uint8 zeros or the symmetric offset."""
    g = qt.spec.effective_group(k)
    n = qt.shape[1]
    if qt.zeros is None:
        return np.full((k // g, n), qt.spec.code_offset, np.int64)
    return qt.zeros.numpy().astype(np.int64)


def _walk(bits, k, g):
    """The (plane, width, shift, chunk rows, chunk start, band, k0) of every
    step, in the kernel's order (the producer's, the transform's and the
    consumers' loops)."""
    steps = []
    widths = (8,) if bits == 8 else plane_widths(bits)
    shift = bits
    for p, w in enumerate(widths):
        shift -= w if bits != 8 else 8
        e = 1 if w == 8 else 32 // w
        kw = k // e
        cr = tmm._chunk_rows(g, kw)
        assert cr, (bits, k, g)
        for r0 in range(0, kw, cr):
            for b in range(e):
                steps.append((p, w, max(shift, 0), cr, r0, b, b * kw + r0))
    return steps


def transform_chunk(bits, w, stage, n_blk, b, cr, gi_pair, zp):
    """`transform_pair` (packed, bands b and b + 1) or `transform_bytes`
    (w == 8) on one chunk `stage [CR, BN]` (uint32 words or bytes as
    uint32 of 4 columns), thread by thread: returns the swizzled tiles
    (one or two 16 KB buffers of bytes) and how often each 16-byte chunk
    was stored."""
    crp = -(-cr // 32) * 32
    fold = bits in (4, 8)
    tiles = [np.zeros(128 * 128, np.uint8) for _ in range(1 if w == 8 else 2)]
    stores = [np.zeros(128 * 8, np.int64) for _ in tiles]
    n = zp.shape[1]
    for wq in range(4):
        for l in range(32):
            rot = (l >> 1) & 3
            n0 = n_blk + 4 * l
            if w != 8 and fold:
                zz = [np.uint32(0)] * 2
                if n0 < n:
                    zz = [np.frombuffer(zp[gi, n0:n0 + 4].astype(np.uint8).tobytes(),
                                        U32)[0] for gi in gi_pair]
            for jb in range(wq, crp // 16, 4):
                outs = [np.zeros((4, 4), U32) for _ in tiles]  # [column][unit]
                for u in range(4):
                    row = jb * 16 + 4 * u
                    live = row < cr
                    for c in range(4):
                        if not live:
                            continue
                        if w == 8:
                            ws = [stage[row + i, l] for i in range(4)]
                            sel = c | ((c + 4) << 4)
                            outs[0][c, u] = gather4(*ws, sel) ^ U32(0x80808080)
                        else:
                            ws = [stage[row + i, 4 * l + c] for i in range(4)]
                            bit = w * b
                            byte, sh = bit >> 3, bit & 7
                            sel = byte | ((byte + 4) << 4)
                            mask = U32(((1 << w) - 1) * 0x01010101)
                            v = gather4(*ws, sel) >> U32(sh)
                            c0, c1 = v & mask, (v >> U32(w)) & mask
                            if fold:
                                c0 = fold4(c0, byte_x4(zz[0], c))
                                c1 = fold4(c1, byte_x4(zz[1], c))
                            outs[0][c, u], outs[1][c, u] = c0, c1
                for cc in range(4):
                    c = cc ^ rot
                    off = sw128_chunk(4 * l + c, jb)
                    for t, o, st in zip(tiles, outs, stores):
                        t[off:off + 16] = o[c].view(np.uint8)
                        st[off // 16] += 1
    return tiles, stores


def tile_kmajor(tile):
    """The swizzled tile as wgmma reads it: element (n, k) at
    n * 128 + ((k / 16) ^ (n % 8)) * 16 + k % 16 -> int8 [128, 128]."""
    out = np.zeros((128, 128), np.int8)
    for r in range(128):
        for ch in range(8):
            off = sw128_chunk(r, ch)
            out[r, 16 * ch:16 * ch + 16] = tile[off:off + 16].view(np.int8)
    return out


def gemm_emulated(xq, ascale, rscale, qt, check_walk=True):
    """The GEMM of kernels G and H over one or more 128-column tiles
    (rows all at once: the tile's rows do not interact): transform, int32
    products per step, the fold in the kernel's order; float32 out."""
    bits = qt.spec.bits
    m, k = xq.shape
    n = qt.shape[1]
    g = qt.spec.effective_group(k)
    zp = _zp(qt, k)
    ws = qt.scales.float().numpy()
    planes = [p.numpy().view(U32) if bits != 8 else p.numpy() for p in qt.data]
    steps = _walk(bits, k, g)
    cr0 = steps[0][3]
    xsum = tmm.int8_xsum(torch.from_numpy(xq), cr0).numpy() if bits not in (4, 8) \
        else None
    xq64 = xq.astype(np.int64)
    xpad = np.concatenate([xq64, np.zeros((m, 128), np.int64)], 1)
    out = np.zeros((m, n), np.float32)
    reads = [np.zeros(pl.shape[0], np.int64) for pl in planes]
    for n_blk in range(0, n, BN):
        facc = np.zeros((m, BN), np.float32)
        cols = np.arange(n_blk, n_blk + BN)
        live = cols < n
        i = 0
        while i < len(steps):
            p, w, sh, cr, r0, b, k0 = steps[i]
            stage_src = planes[p][r0:r0 + cr, n_blk:n_blk + BN]
            if n_blk == 0 and b == 0:     # the chunk's one load
                reads[p][r0:r0 + cr] += 1
            if w == 8:   # bytes: a uint32 of 4 columns per row
                st = np.zeros((cr, BN), np.uint8)
                st[:, :stage_src.shape[1]] = stage_src
                stage = st.view(U32)
            else:
                stage = np.zeros((cr, BN), U32)
                stage[:, :stage_src.shape[1]] = stage_src
            pair = 1 if w == 8 else 2
            kw = k // (1 if w == 8 else 32 // w)
            gis = [((b + j) * kw + r0) // g for j in range(pair)]
            tiles, stores = transform_chunk(bits, w, stage, n_blk, b, cr,
                                            gis, zp)
            crp = -(-cr // 32) * 32
            for j, (tile, st) in enumerate(zip(tiles, stores)):
                p_, w_, sh_, cr_, r0_, b_, k0_ = steps[i + j]
                assert (b_, r0_) == (b + j, r0)
                kt = tile_kmajor(tile)                       # [N, K]
                # every chunk of K written once, K padded with zero rows
                phys = st.reshape(128, 8)
                written = np.stack([phys[r, np.arange(8) ^ (r & 7)]
                                    for r in range(128)])
                assert (written[:, :crp // 16] == 1).all() and \
                    (written[:, crp // 16:] == 0).all()
                assert (kt[:, cr_:crp] == 0).all()
                gi = k0_ // g
                if check_walk:  # the step lies inside one group
                    assert (k0_ + cr_ - 1) // g == gi
                # the x box: 128 K columns from k0, zeros past K
                d = xpad[:, k0_:k0_ + crp] @ kt[:, :crp].T.astype(np.int64)
                v = d << sh_
                if bits not in (4, 8) and p_ == 0:
                    v = v - xsum[:, k0_ // cr0][:, None] * zp[gi, np.minimum(
                        cols, n - 1)][None, :]
                wsl = np.where(live, ws[gi, np.minimum(cols, n - 1)], 0.0
                               ).astype(np.float32)
                asl = (np.ones(m, np.float32) if ascale is None
                       else ascale[:, gi].astype(np.float32))
                facc = fma32(facc, exact_float(v), (wsl[None, :] * asl[:, None]
                                                    ).astype(np.float32))
            i += pair
        if rscale is not None:
            facc = (facc * rscale.reshape(m, 1)).astype(np.float32)
        out[:, n_blk:n_blk + BN] = facc[:, :min(BN, n - n_blk)]
    if check_walk:
        for r in reads:
            assert (r == 1).all()                # each word row loaded once
    return out


def _every_code_pack(bits, k, n):
    """Codes cycling through every value in every band of every column."""
    codes = (np.arange(k)[:, None] + np.arange(n)[None, :]) % (1 << bits)
    return codes


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 7, 8])
def test_transform_is_code_minus_zero_point(bits):
    """Every code meets every zero point (G int4: 0..15 and the symmetric
    8; int8: the symmetric 128; H: raw codes, the zero point taken apart):
    the tiles of every step equal unpack_codes - zp."""
    k, n = 1024, 256 if bits != 4 else 128 * 2
    g = 128
    codes = _every_code_pack(bits, k, n)
    for sym in ((True,) if bits == 8 else (True, False)):
        zeros = None
        if not sym:   # every zero point against every code
            zeros = torch.from_numpy(
                ((np.arange(k // g)[:, None] * 7 + np.arange(n)[None, :] // 16)
                 % (1 << bits)).astype(np.uint8))
        qt = QTensor(pack_codes(torch.from_numpy(codes), bits),
                     torch.ones((k // g, n)), zeros, None,
                     named_qspec(f"int{bits}", g, sym), (k, n))
        assert (unpack_codes(qt.data, bits, k).numpy() == codes).all()
        zp = _zp(qt, k)
        planes = [p.numpy().view(U32) if bits != 8 else p.numpy() for p in qt.data]
        got = {p: np.zeros((k, n), np.int64) for p in range(len(planes))}
        for p, w, sh, cr, r0, b, k0 in _walk(bits, k, g):
            if w != 8 and b % 2:
                continue
            for n_blk in range(0, n, BN):
                src = planes[p][r0:r0 + cr, n_blk:n_blk + BN]
                stage = np.ascontiguousarray(src).view(U32) if w == 8 else src
                kw = k // (1 if w == 8 else 32 // w)
                gis = [((b + j) * kw + r0) // g for j in range(2)]
                tiles, _ = transform_chunk(bits, w, stage, n_blk, b, cr, gis, zp)
                for j, tile in enumerate(tiles):
                    kk = (b + j) * kw + r0
                    got[p][kk:kk + cr, n_blk:n_blk + BN] = tile_kmajor(tile)[:, :cr].T
        zrow = np.repeat(zp, g, axis=0)
        if bits in (4, 8):
            want = codes - zrow
            np.testing.assert_array_equal(got[0], want)
            assert {int(z) for z in np.unique(zp)} == (
                set(range(16)) if not sym else {1 << (bits - 1)})
            assert set(np.unique(codes)) == set(range(1 << bits))
        else:
            shift = bits
            total = np.zeros((k, n), np.int64)
            for p, w in enumerate(plane_widths(bits)):
                shift -= w
                np.testing.assert_array_equal(got[p], (codes >> shift) & ((1 << w) - 1))
                total += got[p] << shift
            np.testing.assert_array_equal(total - zrow, codes - zrow)


def test_fold4_for_every_code_and_zero_point():
    """The byte-parallel fold on all 16 x 16 int4 (code, zero point) pairs
    and int8's code ^ 0x80 on all 256 codes, four bytes at a time."""
    c, z = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    c, z = c.ravel(), z.ravel()
    words = (c * 0x01010101).astype(U32) ^ U32(0x00000000)
    got = bytes_of(fold4(words, (z * 0x01010101).astype(U32)))
    np.testing.assert_array_equal(got, np.repeat((c - z)[:, None], 4, 1))
    # mixed bytes: four different codes in one word
    rng = np.random.default_rng(1)
    cc = rng.integers(0, 16, (4096, 4))
    zz = rng.integers(0, 16, (4096, 1))
    w4 = (cc * (1 << (8 * np.arange(4)))).sum(1).astype(U32)
    np.testing.assert_array_equal(bytes_of(fold4(w4, (zz[:, 0] * 0x01010101).astype(U32))),
                                  cc - zz)
    b = np.arange(256)
    np.testing.assert_array_equal(bytes_of((b * 0x01010101).astype(U32)
                                           ^ U32(0x80808080))[:, 0], b - 128)


def test_exact_float_is_exact_over_its_range():
    v = np.concatenate([np.arange(-5000, 5000), np.array([2 ** 22 - 1, -2 ** 22,
                                                          123456, -2 ** 21])])
    np.testing.assert_array_equal(exact_float(v), v.astype(np.float32))


GEMM_CASES = [  # bits, sym, K, g, per_token, scale dtype
    (4, True, 1024, 128, False, torch.bfloat16),    # K / 8 >= g: Pallas takes it
    (4, False, 1024, 128, False, torch.float32),
    (8, True, 384, 128, False, torch.bfloat16),
    (4, True, 1024, 128, True, torch.bfloat16),
    (2, False, 512, 128, False, torch.bfloat16),
    (3, True, 512, 128, False, torch.bfloat16),    # 1-bit plane: CR 16, padded
    (3, False, 512, 128, True, torch.bfloat16),
    (5, False, 1024, 128, False, torch.float32),
    (7, False, 1024, 128, False, torch.bfloat16),
    (6, True, 1024, 128, True, torch.bfloat16),
    (4, False, 512, 64, False, torch.bfloat16),    # g = 64: the plain version only
    (3, False, 512, 64, True, torch.bfloat16),
]


@pytest.mark.parametrize("bits,sym,k,g,per_token,sdt", GEMM_CASES)
def test_gemm_walk_matches_jax(bits, sym, k, g, per_token, sdt):
    """The GEMM emulated step by step (transform, int32 products, fold in
    the kernel's order) against the JAX package's `qmatmul_int8` on the same
    float32 activations, its Pallas bodies in interpret mode (which take
    g % 128 == 0 and M % 32 == 0; at g = 64 the port's plain version, which
    `test_torch_matmul.py` holds to them), and against the plain version:
    (K / g) float32 ulps of the largest output.  N = 264: the last column
    tile is ragged."""
    rng = np.random.default_rng(bits * 100 + k + g + per_token)
    n = 264
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    jqt = jq.quantize(jnp.asarray(w), jax_named_qspec(
        f"int{bits}", g, sym,
        scale_dtype="bfloat16" if sdt == torch.bfloat16 else "float32"))
    tqt = port_qtensor(jqt)
    assert tmm.int8_kernel_for(tqt) == ("G" if bits in (4, 8) else "H")
    m = 64
    x = rng.standard_normal((m, k)).astype(np.float32)
    xq, ascale = tmm._act_quant(torch.from_numpy(x), k if per_token else g)
    got = gemm_emulated(xq.numpy(), None if per_token else ascale.numpy(),
                        ascale.numpy() if per_token else None, tqt)
    plain = tmm.qmatmul_int8_plain(xq, None if per_token else ascale, tqt).numpy()
    if per_token:
        plain = plain * ascale.numpy()
    tol = (k // g) * 2.0 ** -23 * np.abs(plain).max()
    np.testing.assert_allclose(got, plain, rtol=0, atol=tol)
    if g % 128 == 0:
        want = np.asarray(jm.qmatmul_int8(jnp.asarray(x), jqt, interpret=True,
                                          per_token=per_token))
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_walk_steps_stay_in_one_group_and_pad_to_32():
    """At the Llama-2-7B shapes and g = 64 / 128 every step lies inside one
    group, and band rows that are not a multiple of 32 give zero-padded
    steps (CR 16 at the 1-bit plane of K = 512)."""
    for bits in (2, 3, 4, 5, 6, 7, 8):
        for k, g in ((4096, 128), (12288, 128), (11264, 128), (6144, 64), (512, 64)):
            if bits == 4 and k == 12288:
                continue
            widths = (8,) if bits == 8 else plane_widths(bits)
            if any((k * w // 32 if w < 8 else k) % 8 for w in widths):
                continue
            if not all(tmm._chunk_rows(g, k * w // 32 if w < 8 else k) for w in widths):
                continue
            steps = _walk(bits, k, g)
            cover = np.zeros(k, np.int64)
            for p, w, sh, cr, r0, b, k0 in steps:
                assert (k0 + cr - 1) // g == k0 // g and cr % 8 == 0 and cr <= 128
                if p == len(widths) - 1:
                    cover[k0:k0 + cr] += 1
            assert (cover == 1).all()      # the narrowest plane covers K once
    assert any(cr % 32 for *_, cr, _r, _b, _k in
               [s[:4] + s[4:] for s in _walk(3, 512, 64)])


# ---------------------------------------------------------------------------
# the GEMV: m16n8k32 fragments lane by lane
# ---------------------------------------------------------------------------

GEMV_COLS = tmm.INT8_GEMV_COLS


def _mma(afr, bfr):
    """mma.sync m16n8k32 s8: A [lane][4 regs] (rows g / g + 8, K 4t / 16 +
    4t), B [lane][2 regs] (column g, K 4t / 16 + 4t) -> D [lane][4]
    (rows g / g + 8, columns 2t / 2t + 1), from PTX's fragment layouts."""
    A = np.zeros((16, 32), np.int64)
    B = np.zeros((32, 8), np.int64)
    for lane in range(32):
        gq, t = lane // 4, lane % 4
        for reg, (r, k) in enumerate(((gq, 4 * t), (gq + 8, 4 * t),
                                      (gq, 16 + 4 * t), (gq + 8, 16 + 4 * t))):
            A[r, k:k + 4] = bytes_of(afr[lane][reg])
        for reg, k in enumerate((4 * t, 16 + 4 * t)):
            B[k:k + 4, gq] = bytes_of(bfr[lane][reg])
    D = A @ B
    return [[D[l // 4, 2 * (l % 4)], D[l // 4, 2 * (l % 4) + 1],
             D[l // 4 + 8, 2 * (l % 4)], D[l // 4 + 8, 2 * (l % 4) + 1]]
            for l in range(32)]


def gemv_emulated(xq, qt, splits):
    """gemv_kernel's index math lane by lane (scales 1, no ascale): the
    output, how often each output was written, and how often each word row
    of each plane was loaded."""
    bits = qt.spec.bits
    m, k = xq.shape
    n = qt.shape[1]
    g = qt.spec.effective_group(k)
    zp = _zp(qt, k)
    mt16 = 2 if m > 16 else 1
    fold = bits in (4, 8)
    widths = (8,) if bits == 8 else plane_widths(bits)
    planes = [p.numpy().view(U32) if bits != 8 else p.numpy() for p in qt.data]
    out = np.zeros((m, n))
    written = np.zeros((m, n), np.int64)
    reads = [np.zeros(p.shape, np.int64) for p in planes]
    def xword(staged, r, b, off):
        if r >= m:
            return U32(0)
        return np.frombuffer(staged[r, b, off:off + 4].tobytes(), U32)[0]

    for cb in range(-(-n // GEMV_COLS)):
        parts = []
        for split in range(splits):
            part = np.zeros((mt16 * 16, GEMV_COLS))
            for warp in range(4):
                nw = cb * GEMV_COLS + 32 * warp
                facc = np.zeros((32, mt16, 4, 4))      # [lane][i][jn][e]
                shift = bits
                for p, w in enumerate(widths):
                    shift -= w if bits != 8 else 8
                    sh_ = max(shift, 0)
                    e_ = 1 if w == 8 else 32 // w
                    kw = k // e_
                    rs = (-(-kw // splits) + 31) // 32 * 32
                    rlo, rhi = split * rs, min(split * rs + rs, kw)
                    corr = not fold and p == 0
                    for r0 in range(rlo, rhi, 32):
                        # the lane's word rows: 4t..4t+3 and 16+4t..16+4t+3
                        words = np.zeros((32, 2, 4, 4), U32)
                        for lane in range(32):
                            gq, t = lane // 4, lane % 4
                            n4 = nw + 4 * gq
                            for u in range(2):
                                for i in range(4):
                                    r = r0 + 16 * u + 4 * t + i
                                    if n4 < n and r < rhi:
                                        if w == 8:
                                            words[lane, u, i, 0] = np.frombuffer(
                                                planes[0][r, n4:n4 + 4].tobytes(), U32)[0]
                                        else:
                                            words[lane, u, i] = planes[p][r, n4:n4 + 4]
                                        reads[p][r, n4:n4 + 4] += 1
                        rend = min(r0 + 32, rhi)
                        # gv_stage: xq's 32 K values of each band, zeros past rhi
                        staged = np.zeros((m, e_, 32), np.int8)
                        for bb in range(e_):
                            for q in range(8):
                                if r0 + 4 * q < rhi:
                                    kk = bb * kw + r0 + 4 * q
                                    staged[:, bb, 4 * q:4 * q + 4] = xq[:, kk:kk + 4]
                        for b in range(e_):
                            cw = np.zeros((32, 2, 4), U32)
                            for lane in range(32):
                                for u in range(2):
                                    for jn in range(4):
                                        if w == 8:
                                            ws_ = words[lane, u, :, 0]
                                            cw[lane, u, jn] = gather4(*ws_, jn | ((jn + 4) << 4))
                                        else:
                                            bit = w * (b - b % 2)
                                            byte, sh = bit >> 3, bit & 7
                                            v = gather4(*words[lane, u, :, jn],
                                                        byte | ((byte + 4) << 4)) >> U32(sh)
                                            if b % 2:
                                                v = v >> U32(w)
                                            cw[lane, u, jn] = v & U32(((1 << w) - 1) * 0x01010101)
                            k0, kend = b * kw + r0, b * kw + rend
                            for gg in range(k0 // g, (kend - 1) // g + 1):
                                afr = [[[U32(0)] * 4 for _ in range(32)] for _ in range(mt16)]
                                bfr = [[[U32(0)] * 2 for _ in range(32)] for _ in range(4)]
                                xs = np.zeros((32, mt16, 2), np.int64)
                                ins = []
                                for lane in range(32):
                                    gq, t = lane // 4, lane % 4
                                    n4 = nw + 4 * gq
                                    u0 = r0 + 4 * t < rhi
                                    u1 = r0 + 16 + 4 * t < rhi
                                    in0 = u0 and (k0 + 4 * t) // g == gg
                                    in1 = u1 and (k0 + 16 + 4 * t) // g == gg
                                    ins.append((in0, in1))
                                    for jn in range(4):
                                        c0, c1 = cw[lane, 0, jn], cw[lane, 1, jn]
                                        if w == 8:
                                            c0, c1 = c0 ^ U32(0x80808080), c1 ^ U32(0x80808080)
                                        elif fold:
                                            z = zp[gg, n4 + jn] if n4 < n else 0
                                            c0 = fold4(c0, U32(z * 0x01010101))
                                            c1 = fold4(c1, U32(z * 0x01010101))
                                        bfr[jn][lane] = [c0 if in0 else U32(0),
                                                         c1 if in1 else U32(0)]
                                    for i in range(mt16):
                                        for h in range(2):
                                            r = 16 * i + gq + 8 * h
                                            afr[i][lane][h] = xword(staged, r, b, 4 * t)
                                            afr[i][lane][h + 2] = xword(staged, r, b, 16 + 4 * t)
                                if corr:   # the quad's masked row sums
                                    for i in range(mt16):
                                        for h in range(2):
                                            part_s = [
                                                (int(bytes_of(afr[i][l][h]).astype(np.int64).sum())
                                                 if ins[l][0] else 0)
                                                + (int(bytes_of(afr[i][l][h + 2]).astype(np.int64).sum())
                                                   if ins[l][1] else 0) for l in range(32)]
                                            for l in range(32):
                                                q = l - l % 4
                                                xs[l, i, h] = sum(part_s[q:q + 4])
                                for i in range(mt16):
                                    for jn in range(4):
                                        d = _mma(afr[i], bfr[jn])
                                        for lane in range(32):
                                            t = lane % 4
                                            nc = nw + 8 * t
                                            for e in range(4):
                                                h, col = e >> 1, e & 1
                                                v = int(d[lane][e]) << sh_
                                                if corr:
                                                    cn = min(nc + 4 * col + jn, n - 1)
                                                    v -= xs[lane, i, h] * int(zp[gg, cn])
                                                facc[lane, i, jn, e] += v
                for lane in range(32):
                    gq, t = lane // 4, lane % 4
                    for i in range(mt16):
                        for jn in range(4):
                            for e in range(4):
                                row = 16 * i + gq + 8 * (e >> 1)
                                col = 32 * warp + 8 * t + 4 * (e & 1) + jn
                                part[row, col] = facc[lane, i, jn, e]
            parts.append(part)
        cols = GEMV_COLS // splits
        for split in range(splits):      # the cluster's reduction, rank order
            for row in range(m):
                for col in range(split * cols, split * cols + cols):
                    nn = cb * GEMV_COLS + col
                    v = sum(parts[r][row, col] for r in range(splits))
                    if nn < n:
                        out[row, nn] = v
                        written[row, nn] += 1
    return out, written, reads


GEMV_CASES = [  # bits, sym, K, g, splits
    (4, False, 256, 8, 2),    # G: steps meet four groups; an empty split
    (3, False, 512, 32, 2),   # H: a correction from the fragments, planes of 16 and 8 rows a split
    (8, True, 256, 32, 4),    # G: byte rows
]


@pytest.mark.parametrize("m", [9, 16, 31, 32])
@pytest.mark.parametrize("bits,sym,k,g,splits", GEMV_CASES)
def test_gemv_fragments_give_the_integer_product(bits, sym, k, g, splits, m):
    rng = np.random.default_rng(bits * 31 + m)
    n = 136                                  # two column blocks, the second ragged
    qt, codes = _pack(bits, sym, k, n, g, rng)
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    got, written, reads = gemv_emulated(xq, qt, splits)
    want = xq.astype(np.int64) @ (codes - np.repeat(_zp(qt, k), g, axis=0))
    np.testing.assert_array_equal(got, want)
    assert (written == 1).all()
    for r in reads:                          # one pass over the words
        assert (r[:, :n] == 1).all()


# ---------------------------------------------------------------------------
# the epilogue, routing and the sources
# ---------------------------------------------------------------------------


def test_per_token_epilogue_rounds_once():
    """The kernels multiply the float32 sum by the per-token scale and round
    once to bf16: the value of the wrapper's `(out * ascale).to(bf16)`."""
    rng = np.random.default_rng(3)
    out = (rng.standard_normal((37, 264)) * 300).astype(np.float32)
    ascale = rng.uniform(1e-3, 1e-1, (37, 1)).astype(np.float32)
    kernel = torch.from_numpy((out * ascale).astype(np.float32)).to(torch.bfloat16)
    want = (torch.from_numpy(out).float() * torch.from_numpy(ascale)).to(torch.bfloat16)
    assert torch.equal(kernel.view(torch.int16), want.view(torch.int16))
    # and the CPU path of qmatmul_int8 is that value
    k, n, g = 512, 264, 128
    qt, _ = _pack(4, True, k, n, g, rng)
    x = torch.from_numpy(rng.standard_normal((37, k)).astype(np.float32)).to(
        torch.bfloat16)
    got = tmm.qmatmul_int8(x, qt, per_token=True)
    xq, asc = tmm._act_quant(x.float(), k)
    ref = (tmm.qmatmul_int8_plain(xq, None, qt) * asc).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, ref)
    emu = gemm_emulated(xq.numpy(), None, asc.numpy(), qt)
    emu_b = torch.from_numpy(emu).to(torch.bfloat16).float()
    tol = (k // g) * 2.0 ** -23 * np.abs(emu).max() + 2.0 ** -8 * np.abs(emu).max()
    np.testing.assert_allclose(emu_b.numpy(), ref.float().numpy(), rtol=0, atol=tol)


SHAPES_7B = {"qkv": (4096, 12288), "o": (4096, 4096), "gateup": (4096, 22016),
             "down": (11264, 4096), "down int3": (12288, 4096),
             "head": (4096, 32000), "ragged": (1536, 264)}


def _meta_pack(fmt, k, n, g=128):
    name, _, asym = fmt.partition("-")
    spec = named_qspec(name, g, not asym, scale_dtype="bfloat16")
    bits = spec.bits
    widths = (8,) if bits == 8 else plane_widths(bits)
    data = tuple(torch.empty((k, n), dtype=torch.uint8) if w == 8 else
                 torch.empty((k * w // 32, n), dtype=torch.int32) for w in widths)
    zeros = torch.empty((k // g, n), dtype=torch.uint8) if asym else None
    return QTensor(data, torch.empty((k // g, n), dtype=torch.bfloat16), zeros,
                   None, spec, (k, n))


@pytest.mark.parametrize("shape", list(SHAPES_7B))
@pytest.mark.parametrize("fmt", ["int4", "int4-asym", "int8", "int2-asym", "int3",
                                 "int5-asym", "int6", "int7-asym"])
def test_packs_route_to_the_int8_entries(fmt, shape):
    k, n = SHAPES_7B[shape]
    g = 64 if shape == "ragged" else 128
    qt = _meta_pack(fmt, k, n, g)
    letter = tmm.int8_kernel_for(qt)
    assert letter == ("G" if fmt in ("int4", "int4-asym", "int8") else "H")
    widths = (8,) if qt.spec.bits == 8 else plane_widths(qt.spec.bits)
    chunks = [tmm._chunk_rows(g, k * w // 32 if w < 8 else k) for w in widths]
    assert all(c and c % 8 == 0 and c <= 128 for c in chunks)
    splits = tmm.int8_gemv_splits(k, n, widths, 132)
    assert splits in (1, 2, 4, 8)
    kw = min(k * w // 32 if w < 8 else k for w in widths)
    assert kw // splits >= 32             # every split keeps a 32-row step
    assert -(-n // tmm.INT8_GEMV_COLS) * splits <= 4 * 132 or splits == 1


def _strip_comments(src: str) -> str:
    return re.sub(r"//[^\n]*", "", src)


def test_entries_bind_the_redesigned_bodies():
    h = _strip_comments((CSRC / "qmm_int8.cuh").read_text())
    kernels = set(re.findall(
        r"__global__ void(?:\s+__launch_bounds__\([^)]*\))?\s+(\w+)\(", h))
    assert kernels == {"gemm_kernel", "gemv_kernel"}
    gemm = h[h.index("gemm_kernel("):h.index("inline bool x_map")]
    assert "wgmma_s8(" in gemm and "mma_m16n8k32" not in gemm
    assert "m64n128k32.s32.s8.s8" in h and "tma_2d(" in gemm and "bar_wait(" in gemm
    assert "atomicAdd" not in h and not re.search(r"\bmma_s8\(", h)
    assert "splitk_sum_kernel" not in h
    for src, widths, infix in (("qmatmul_int8.cu", (4, 8), ""),
                               ("qmatmul_int8_planar.cu", (2, 3, 5, 6, 7), "planar_")):
        s = _strip_comments((CSRC / src).read_text())
        for route in ("gemm", "gemv"):
            m = re.search(rf'extern "C" int nst_qmatmul_int8_{infix}{route}\(([^)]*)\)', s)
            params = [p.strip() for p in m.group(1).split(",")]
            ptrs = [p for p in params if "*" in p]
            ints = [p for p in params if p.startswith("int ")]
            # the wrapper binds 10 pointers, 12 ints and the stream
            assert len(ptrs) == 11 and ptrs[-1] == "void* stream" and len(ints) == 12
            assert {int(w) for w in re.findall(rf"run_{route}<(\d)>", s)} == set(widths)
    wrapper = Path(tmm.__file__).read_text()
    assert re.search(r'_build\.kernels\.fn\(name, f"nst_\{name\}_\{route\}", 10, 12\)',
                     wrapper)
