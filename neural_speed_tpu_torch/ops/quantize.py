"""Packed int weights as torch tensors (port of `neural_speed_tpu/ops/quantize.py`).

Storage is the JAX package's planar ("sub-band") packing, bit for bit: a
`[K, N]` code tensor of width `w` bits is split along K into `e = 32 // w`
contiguous sub-bands, and word `[kb, n]` holds `band_i[kb, n]` at bit offset
`w * i`.  Words are held as **int32 bit views** of the uint32 words: torch's
CPU build has no right shift for uint32, and an arithmetic shift followed by
the width mask gives the same codes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .qtypes import FP4_LUT, NF4_LUT, QSpec, QType, plane_widths


@dataclasses.dataclass
class QTensor:
    """A quantized 2-D weight `[K, N]` (K = contraction dim).

    data   : tuple of packed planes — int32 views of the uint32 planar words
             for INT widths < 8 and NF4/FP4, one uint8 `[K, N]` for INT8.
    scales : `[K/g, N]` group scales (float32 or bfloat16; int8 when
             double-quantized, with `sscale` the `[1, N]` secondary scale).
    zeros  : `[K/g, N]` uint8 zero points (asymmetric INT) or None.
    """

    data: Tuple[torch.Tensor, ...]
    scales: torch.Tensor
    zeros: Optional[torch.Tensor]
    sscale: Optional[torch.Tensor]
    spec: QSpec
    shape: Tuple[int, int]
    k_shards: int = 1

    def effective_scales(self, dtype=torch.float32) -> torch.Tensor:
        s = self.scales
        if self.sscale is not None:
            s = s.float() * self.sscale
        return s.to(dtype)

    def to(self, device) -> "QTensor":
        mv = lambda a: None if a is None else a.to(device)
        return dataclasses.replace(
            self, data=tuple(d.to(device) for d in self.data),
            scales=self.scales.to(device), zeros=mv(self.zeros),
            sscale=mv(self.sscale))


def _to_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> the int32 tensor with the same bits."""
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def pack_plane(codes: torch.Tensor, width: int) -> torch.Tensor:
    """Pack `[K, N]` codes (values < 2**width) into `[K//e, N]` int32 words:
    bits `[w*i, w*(i+1))` of word `[kb, n]` hold `codes[i*(K//e) + kb, n]`."""
    k, n = codes.shape
    e = 32 // width
    if k % e:
        raise ValueError(f"K={k} must be divisible by {e} for {width}-bit packing")
    bands = codes.to(torch.int64).reshape(e, k // e, n)
    word = torch.zeros((k // e, n), dtype=torch.int64, device=codes.device)
    for i in range(e):
        word |= bands[i] << (width * i)
    return _to_int32_bits(word)


def unpack_plane(word: torch.Tensor, width: int) -> torch.Tensor:
    """Inverse of `pack_plane`: `[K//e, N]` int32 -> `[K, N]` uint8 codes."""
    e = 32 // width
    mask = (1 << width) - 1
    bands = [(word >> (width * i)) & mask for i in range(e)]
    return torch.cat(bands, dim=0).to(torch.uint8)


def pack_codes(codes: torch.Tensor, bits: int,
               k_shards: int = 1) -> Tuple[torch.Tensor, ...]:
    """Pack unsigned `[K, N]` codes into planar planes; odd widths split into
    4/2/1-bit planes, most significant first.  `k_shards > 1` packs K in
    independent slabs."""
    if bits == 8:
        return (codes.to(torch.uint8),)
    if k_shards > 1:
        k = codes.shape[0]
        if k % k_shards:
            raise ValueError(f"K={k} not divisible by k_shards={k_shards}")
        parts = [pack_codes(codes[i * k // k_shards:(i + 1) * k // k_shards],
                            bits, 1) for i in range(k_shards)]
        return tuple(torch.cat([p[j] for p in parts], dim=0)
                     for j in range(len(parts[0])))
    planes = []
    shift = bits
    for w in plane_widths(bits):
        shift -= w
        part = (codes.to(torch.int32) >> shift) & ((1 << w) - 1)
        planes.append(pack_plane(part, w))
    return tuple(planes)


def unpack_codes(planes: Tuple[torch.Tensor, ...], bits: int, k: int,
                 k_shards: int = 1) -> torch.Tensor:
    """Inverse of `pack_codes` -> unsigned `[K, N]` uint8 codes."""
    if bits == 8:
        return planes[0].to(torch.uint8)
    if k_shards > 1:
        outs = []
        for i in range(k_shards):
            sub = tuple(p[i * p.shape[0] // k_shards:
                          (i + 1) * p.shape[0] // k_shards] for p in planes)
            outs.append(unpack_codes(sub, bits, k // k_shards, 1))
        return torch.cat(outs, dim=0)
    shift = bits
    out = None
    for w, p in zip(plane_widths(bits), planes):
        shift -= w
        part = unpack_plane(p, w).to(torch.int32) << shift
        out = part if out is None else out | part
    return out.to(torch.uint8)


def _lut_for(spec: QSpec) -> torch.Tensor:
    if spec.lut is not None:
        return torch.tensor(spec.lut, dtype=torch.float32)
    src = NF4_LUT if spec.qtype == QType.NF4 else FP4_LUT
    return torch.from_numpy(src.copy())


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Full dequantization to `[K, N]`: values are computed in float32 and
    rounded once to `dtype` (the JAX package's `dequantize`)."""
    spec = qt.spec
    if spec.is_fp8:
        raise NotImplementedError("fp8 weights are not ported yet")
    k, n = qt.shape
    g = spec.effective_group(k)
    sfull = torch.repeat_interleave(qt.effective_scales(torch.float32), g,
                                    dim=0)
    if spec.is_lut:
        codes = unpack_codes(qt.data, 4, k, qt.k_shards).long()
        vals = _lut_for(spec).to(codes.device)[codes]
        return (vals * sfull).to(dtype)
    codes = unpack_codes(qt.data, spec.bits, k, qt.k_shards).to(torch.int32)
    if spec.bits == 1:
        vals = (2 * codes - 1).float()
    elif spec.symmetric and qt.zeros is None:
        vals = (codes - spec.code_offset).float()
    elif qt.zeros.is_floating_point():
        # ggml Q4_1/Q5_1 convention: w = scale * code + m
        zfull = torch.repeat_interleave(qt.zeros.float(), g, dim=0)
        return (codes.float() * sfull + zfull).to(dtype)
    else:
        zfull = torch.repeat_interleave(qt.zeros.to(torch.int32), g, dim=0)
        vals = (codes - zfull).float()
    return (vals * sfull).to(dtype)


def concat_n(qts) -> QTensor:
    """Concatenate QTensors along N (fused QKV / gate+up): planar packing is
    column-independent, so words, scales and zeros concatenate exactly."""
    q0 = qts[0]
    for q in qts[1:]:
        if (q.spec != q0.spec or q.shape[0] != q0.shape[0]
                or q.k_shards != q0.k_shards
                or (q.zeros is None) != (q0.zeros is None)
                or (q.sscale is None) != (q0.sscale is None)):
            raise ValueError("incompatible QTensors for N-concat")
    cat = lambda xs: torch.cat(xs, dim=1)
    data = tuple(cat([q.data[i] for q in qts]) for i in range(len(q0.data)))
    zeros = cat([q.zeros for q in qts]) if q0.zeros is not None else None
    sscale = cat([q.sscale for q in qts]) if q0.sscale is not None else None
    n_total = sum(q.shape[1] for q in qts)
    return QTensor(data, cat([q.scales for q in qts]), zeros, sscale, q0.spec,
                   (q0.shape[0], n_total), q0.k_shards)


def repad_k(qt: QTensor, multiple: int) -> QTensor:
    """Re-pack with K padded up to `multiple` (lossless: padded code rows get
    zero scales and dequantize to exactly 0).  `qmatmul` zero-pads the
    activations to match."""
    k, n = qt.shape
    spec = qt.spec
    g = spec.effective_group(k)
    if (k % multiple == 0 or qt.k_shards != 1 or spec.is_fp8
            or k % g != 0):
        return qt
    k_pad = -(-k // multiple) * multiple
    bits = 4 if spec.is_lut else spec.bits
    codes = unpack_codes(qt.data, bits, k)
    codes = torch.nn.functional.pad(codes, (0, 0, 0, k_pad - k))
    extra_g = k_pad // g - qt.scales.shape[0]
    pad_rows = lambda a: torch.nn.functional.pad(a, (0, 0, 0, extra_g))
    zeros = pad_rows(qt.zeros) if qt.zeros is not None else None
    return QTensor(pack_codes(codes, bits), pad_rows(qt.scales), zeros,
                   qt.sscale, spec, (k_pad, n), 1)


def repad_n(qt: QTensor, multiple: int) -> QTensor:
    """Re-pack with N padded up to `multiple` (padded columns carry zero
    scales; the caller slices the product back to the true N)."""
    k, n = qt.shape
    if n % multiple == 0:
        return qt
    pad = -(-n // multiple) * multiple - n
    pad_cols = lambda a: None if a is None else torch.nn.functional.pad(
        a, (0, pad))
    return QTensor(tuple(pad_cols(d) for d in qt.data), pad_cols(qt.scales),
                   pad_cols(qt.zeros), pad_cols(qt.sscale), qt.spec,
                   (k, n + pad), qt.k_shards)
