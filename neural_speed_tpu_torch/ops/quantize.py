"""Weight quantization and packed storage as torch tensors (port of
`neural_speed_tpu/ops/quantize.py`).

Storage is the JAX package's planar ("sub-band") packing, bit for bit: a
`[K, N]` code tensor of width `w` bits is split along K into `e = 32 // w`
contiguous sub-bands, and word `[kb, n]` holds `band_i[kb, n]` at bit offset
`w * i`.  Words are held as **int32 bit views** of the uint32 words: torch's
CPU build has no right shift for uint32, and an arithmetic shift followed by
the width mask gives the same codes.  FP8 codes are held as `torch.uint8` bit
patterns (one `[K, N]` plane) and viewed as `torch.float8_*` to decode.

`quantize` (RTN) gives the JAX package's planes, scales, zeros and `sscale`
bit for bit on the same float32 weight: IEEE division by tensors (PyTorch's
CUDA division by a Python scalar multiplies by the reciprocal), round half to
even, `searchsorted` with the left side.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .qtypes import FP4_LUT, NF4_LUT, QSpec, QType, plane_widths


@dataclasses.dataclass
class QTensor:
    """A quantized 2-D weight `[K, N]` (K = contraction dim).

    data   : tuple of packed planes — int32 views of the uint32 planar words
             for INT widths < 8 and NF4/FP4, one uint8 `[K, N]` for INT8 and
             for FP8 (its bit patterns).
    scales : `[K/g, N]` group scales (float32 or bfloat16; int8 when
             double-quantized, with `sscale` the `[1, N]` secondary scale).
    zeros  : `[K/g, N]` uint8 zero points (asymmetric INT), float32 offsets
             (ggml convention `w = scale * code + m`) or None.
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

    def nbytes(self) -> int:
        leaves = (*self.data, self.scales, self.zeros, self.sscale)
        return sum(t.numel() * t.element_size() for t in leaves
                   if t is not None)

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


_EPS = 1e-8
_FP8_DTYPES = {QType.FP8_E4M3: torch.float8_e4m3fn,
               QType.FP8_E5M2: torch.float8_e5m2}


def _lut_for(spec: QSpec) -> np.ndarray:
    if spec.lut is not None:
        # a converter's foreign code -> value table
        return np.asarray(spec.lut, np.float32)
    return NF4_LUT if spec.qtype == QType.NF4 else FP4_LUT


@functools.lru_cache(maxsize=None)
def _lut_tensors(spec_key, device_str: str):
    """(values, searchsorted boundaries, sorted position -> code) of a
    table on a device; built once per (table, device), so no call copies
    from the host."""
    lut = np.asarray(spec_key, np.float32)
    order = np.argsort(lut)
    sorted_lut = lut[order]
    boundaries = (sorted_lut[1:] + sorted_lut[:-1]) / 2.0
    dev = torch.device(device_str)
    return (torch.from_numpy(lut.copy()).to(dev),
            torch.from_numpy(boundaries.astype(np.float32)).to(dev),
            torch.from_numpy(order.astype(np.uint8)).to(dev))


def lut_values(spec: QSpec, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """The 16 table values of a LUT spec as a tensor on `device` (cached per
    table and device)."""
    vals = _lut_tensors(tuple(float(v) for v in _lut_for(spec)),
                        str(torch.device(device)))[0]
    return vals if dtype == torch.float32 else vals.to(dtype)


def _encode_lut(x: torch.Tensor, spec: QSpec) -> torch.Tensor:
    """Nearest-code encoding through the sorted table's midpoints."""
    _, boundaries, perm = _lut_tensors(
        tuple(float(v) for v in _lut_for(spec)), str(x.device))
    return perm[torch.searchsorted(boundaries, x.contiguous())]


def decode_lut(codes: torch.Tensor, spec: QSpec,
               dtype=torch.float32) -> torch.Tensor:
    """uint8 codes -> table values."""
    return lut_values(spec, dtype, codes.device)[codes.long()]


def _seq_mean(a: torch.Tensor) -> torch.Tensor:
    """Mean over axis 1 with the float32 sum taken as XLA's CPU reduction
    takes it (rows in order within blocks of 32, then the block sums in
    order), so the 1-bit scales match the JAX package's bit for bit."""
    total = None
    for start in range(0, a.shape[1], 32):
        block = a[:, start]
        for i in range(start + 1, min(start + 32, a.shape[1])):
            block = block + a[:, i]
        total = block if total is None else total + block
    return total / total.new_full((), a.shape[1])


def quantize(w: torch.Tensor, spec: QSpec, k_shards: int = 1) -> QTensor:
    """RTN-quantize a float `[K, N]` weight (per-group symmetric /
    asymmetric round to nearest, LUT nearest code, FP8 cast)."""
    k, n = w.shape
    g = spec.effective_group(k)
    spec.groups(k)  # validates divisibility
    wg = w.float().reshape(k // g, g, n)
    const = lambda v: wg.new_full((), v)
    eps = lambda a: a.clamp_min(_EPS)

    zeros = None
    if spec.is_fp8:
        fmax = 448.0 if spec.qtype == QType.FP8_E4M3 else 57344.0
        scales = eps(wg.abs().amax(dim=1) / const(fmax))
        codes = (wg / scales[:, None, :]).reshape(k, n).to(
            _FP8_DTYPES[spec.qtype])
        data = (codes.view(torch.uint8),)
    elif spec.is_lut:
        scales = eps(wg.abs().amax(dim=1))
        normed = (wg / scales[:, None, :]).reshape(k, n)
        data = pack_codes(_encode_lut(normed, spec), 4, k_shards)
    elif spec.symmetric:
        if spec.bits == 1:
            scales = eps(_seq_mean(wg.abs()))
            codes = (wg >= 0).to(torch.uint8).reshape(k, n)
        else:
            scales = eps(wg.abs().amax(dim=1) / const(spec.maxq))
            q = torch.clamp(torch.round(wg / scales[:, None, :]), spec.minq,
                            spec.maxq)
            codes = (q + spec.code_offset).to(torch.uint8).reshape(k, n)
        data = pack_codes(codes, spec.bits, k_shards)
    else:  # asymmetric INT
        wmin, wmax = wg.amin(dim=1), wg.amax(dim=1)
        maxcode = (1 << spec.bits) - 1
        scales = eps((wmax - wmin) / const(maxcode))
        zp = torch.clamp(torch.round(-wmin / scales), 0, maxcode)
        q = torch.clamp(torch.round(wg / scales[:, None, :])
                        + zp[:, None, :], 0, maxcode)
        codes = q.to(torch.uint8).reshape(k, n)
        zeros = zp.to(torch.uint8)
        data = pack_codes(codes, spec.bits, k_shards)

    sscale = None
    if spec.double_quant:
        smax = eps(scales.amax(dim=0, keepdim=True))  # [1, N]
        sscale = smax / const(127.0)
        scales = torch.clamp(torch.round(scales / sscale), 1, 127).to(
            torch.int8)
    elif spec.scale_dtype == "bfloat16":
        scales = scales.to(torch.bfloat16)
    return QTensor(data, scales, zeros, sscale, spec, (k, n), k_shards)


def dequantize(qt: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Full dequantization to `[K, N]`: values are computed in float32 and
    rounded once to `dtype` (the JAX package's `dequantize`)."""
    spec = qt.spec
    k, n = qt.shape
    g = spec.effective_group(k)
    sfull = torch.repeat_interleave(qt.effective_scales(torch.float32), g,
                                    dim=0)
    if spec.is_fp8:
        vals = qt.data[0].view(_FP8_DTYPES[spec.qtype]).float()
        return (vals * sfull).to(dtype)
    if spec.is_lut:
        codes = unpack_codes(qt.data, 4, k, qt.k_shards)
        return (decode_lut(codes, spec) * sfull).to(dtype)
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


def repack(qt: QTensor, k_shards: int) -> QTensor:
    """Losslessly re-pack into `k_shards` K-slabs (row sharding): codes are
    unpacked and packed again; scales and zeros already split on group
    boundaries."""
    if qt.k_shards == k_shards:
        return qt
    spec = qt.spec
    if spec.is_fp8 or (spec.qtype == QType.INT and spec.bits == 8):
        return dataclasses.replace(qt, k_shards=k_shards)
    k = qt.shape[0]
    g = spec.effective_group(k)
    if (k // k_shards) % g and spec.group_size != -1:
        raise ValueError(f"K shard {k}/{k_shards} breaks group boundary g={g}")
    bits = 4 if spec.is_lut else spec.bits
    codes = unpack_codes(qt.data, bits, k, qt.k_shards)
    return dataclasses.replace(qt, data=pack_codes(codes, bits, k_shards),
                               k_shards=k_shards)


def quantization_error(w: torch.Tensor, spec: QSpec) -> torch.Tensor:
    """RMS relative error of a quantize / dequantize round trip."""
    wd = dequantize(quantize(w, spec))
    return torch.sqrt(torch.mean((w - wd) ** 2)) / torch.sqrt(
        torch.mean(w ** 2)).clamp_min(_EPS)


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


def split_n(qt: QTensor, sections) -> Tuple[QTensor, ...]:
    """Split along N into contiguous pieces of the given sizes, the inverse
    of `concat_n` (every component is `[*, N]`, so a column slice is a valid
    pack)."""
    if sum(sections) != qt.shape[1]:
        raise ValueError(f"sections {sections} != N={qt.shape[1]}")
    cut = lambda a, sl: None if a is None else a[..., sl].contiguous()
    outs, start = [], 0
    for n in sections:
        sl = slice(start, start + n)
        outs.append(dataclasses.replace(
            qt, data=tuple(cut(d, sl) for d in qt.data),
            scales=cut(qt.scales, sl), zeros=cut(qt.zeros, sl),
            sscale=cut(qt.sscale, sl), shape=(qt.shape[0], n)))
        start += n
    return tuple(outs)


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


def quantize_tree(params, policy) -> dict:
    """Quantize the float 2-D "w" leaves of a params tree per a path policy:
    `policy(path) -> Optional[QSpec]` with paths like "layers.3.ffn.down" or
    "lm_head" (`convert.quant_config.load_quant_config` builds one).  None, or
    a K the group does not divide, keeps the leaf in floating point."""

    def walk(node, path):
        if isinstance(node, dict):
            out = {}
            for key, val in node.items():
                sub = f"{path}.{key}" if path else key
                if (key == "w" and isinstance(val, torch.Tensor)
                        and val.ndim == 2):
                    spec = policy(path)
                    if (spec is not None
                            and val.shape[0] % spec.effective_group(
                                val.shape[0]) == 0):
                        out[key] = quantize(val.float(), spec)
                    else:
                        out[key] = val
                else:
                    out[key] = walk(val, sub)
            return out
        if isinstance(node, list):
            return [walk(v, f"{path}.{i}") for i, v in enumerate(node)]
        return node

    return walk(params, "")


def widen_bits(qt: QTensor) -> QTensor:
    """Re-pack odd bit widths (3/5/6/7) into the next one-plane width (4 or
    8 bits): codes are unchanged integers, so the mapping is exact.  A
    symmetric pack gets its original offset 2**(bits-1) as an explicit zero
    point.  Kernel P reads odd widths as stored, so the card's path does not
    use this."""
    spec = qt.spec
    if spec.qtype != QType.INT or spec.bits in (1, 2, 4, 8):
        return qt
    target = 4 if spec.bits < 4 else 8
    k, n = qt.shape
    codes = unpack_codes(qt.data, spec.bits, k, qt.k_shards)
    new_spec = dataclasses.replace(spec, bits=target)
    zeros = qt.zeros
    if spec.symmetric:
        g = spec.effective_group(k)
        zeros = torch.full((max(k // g, 1), n), 1 << (spec.bits - 1),
                           dtype=torch.uint8, device=codes.device)
        new_spec = dataclasses.replace(new_spec, symmetric=False)
    return QTensor(pack_codes(codes, target, qt.k_shards), qt.scales, zeros,
                   qt.sscale, new_spec, qt.shape, qt.k_shards)
