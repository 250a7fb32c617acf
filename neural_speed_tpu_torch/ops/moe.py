"""Grouped MoE expert dispatch (port of `neural_speed_tpu/ops/moe.py`).

Exact and static-shaped, as in the JAX package:

1. `route_tokens` sorts the A = N * top_k router assignments by expert and
   lays each expert's rows out in a segment that starts on an M-block
   boundary (padding rows read an appended zero row).  `M_pad = (ceil(A /
   bm) + E) * bm` bounds every routing, so no assignment is dropped.  Every
   size is static and every op stays on the device: no host sync.
2. `grouped_qmatmul` is one dequant-GEMM over the sorted rows in which row
   block i uses expert `block_expert[i]`'s weights; its output is float32.

`grouped_qmatmul_rows` is the port's decode entry (at most 32 rows, the
expert of each row read on the device): the JAX package runs its B*T == 1
path as a `lax.switch` over the selected experts, which the port replaces
with one launch per projection for all top_k experts.

A CPU tensor goes through the plain versions; a CUDA tensor through kernel
11 (`csrc/qmatmul_grouped.cu`: int4, symmetric, bf16 scales; its GEMM on
the TMA + `wgmma` template of `csrc/qmm_fp.cuh`), through the
grouped instances of kernels F and P (`csrc/qmatmul_grouped_fp.cuh`, one
library per format: NF4 / FP4 and one-plane INT 1/2/4/8 with the symmetric
offset or uint8 zero points, bf16 or float32 scales), or raises naming the
format (multi-plane and K-slab stacks, which the JAX package runs on XLA).

`StackedExperts` holds one projection's E experts stacked on a leading
axis; it replaces the per-expert `QTensor` list at load time
(`transformer.fuse_params`) so weights are not held twice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import torch

from .. import _build
from .matmul import (GEMV_MAX_M, _band_major, _describe, _gemv_splits,
                     _sm_count)
from .qtypes import QSpec, QType, plane_widths
from .quantize import QTensor, dequantize


@dataclasses.dataclass
class StackedExperts:
    """E experts' packed weights stacked on a leading axis.

    data   : tuple of planes, each `[E, KW, N]` (int32 words; uint8 rows
             for 8-bit and FP8).
    scales : `[E, K/g, N]`.
    zeros  : `[E, K/g, N]` uint8 or None.
    spec   : the shared QSpec.
    shape  : per-expert logical (K, N).
    """

    data: Tuple[torch.Tensor, ...]
    scales: torch.Tensor
    zeros: Optional[torch.Tensor]
    spec: QSpec
    shape: Tuple[int, int]
    n_experts: int
    k_shards: int = 1

    def expert(self, e: int) -> QTensor:
        """One expert as a `QTensor` (views, no copy)."""
        return QTensor(
            tuple(d[e] for d in self.data), self.scales[e],
            None if self.zeros is None else self.zeros[e], None, self.spec,
            self.shape, self.k_shards)

    def leaf_dims(self) -> Tuple[int, int]:
        n = self.scales.shape[-1]
        d0 = self.data[0]
        if self.spec.qtype == QType.INT and self.spec.bits == 8:
            return d0.shape[1], n
        w0 = 4 if self.spec.is_lut else plane_widths(self.spec.bits)[0]
        return d0.shape[1] * (32 // w0), n

    def local_view(self) -> "StackedExperts":
        """Shape and k_shards fixed to the leaves."""
        k, n = self.leaf_dims()
        if (k, n) == self.shape:
            return self
        local_shards = self.k_shards * k // self.shape[0]
        if local_shards * self.shape[0] != self.k_shards * k or local_shards < 1:
            raise ValueError(
                f"row shard {k} incompatible with k_shards={self.k_shards} "
                f"of global K={self.shape[0]}")
        return dataclasses.replace(self, shape=(k, n), k_shards=local_shards)

    def nbytes(self) -> int:
        leaves = (*self.data, self.scales, self.zeros)
        return sum(t.numel() * t.element_size() for t in leaves
                   if t is not None)

    def to(self, device) -> "StackedExperts":
        return dataclasses.replace(
            self, data=tuple(d.to(device) for d in self.data),
            scales=self.scales.to(device),
            zeros=None if self.zeros is None else self.zeros.to(device))


def stack_experts(qts) -> Optional[StackedExperts]:
    """Stack per-expert QTensors; None when they are not stackable
    (mismatched specs or shapes, double-quant, FP8 or float-offset formats
    keep the per-expert list)."""
    q0 = qts[0]
    for qt in qts:
        if (qt.spec != q0.spec or qt.shape != q0.shape
                or qt.k_shards != q0.k_shards or len(qt.data) != len(q0.data)
                or qt.sscale is not None
                or (qt.zeros is None) != (q0.zeros is None)):
            return None
        if qt.zeros is not None and qt.zeros.is_floating_point():
            return None
        if qt.spec.is_fp8 or qt.spec.double_quant:
            return None
    return StackedExperts(
        tuple(torch.stack([qt.data[i] for qt in qts])
              for i in range(len(q0.data))),
        torch.stack([qt.scales for qt in qts]),
        None if q0.zeros is None else torch.stack([qt.zeros for qt in qts]),
        q0.spec, q0.shape, len(qts), q0.k_shards)


# ---------------------------------------------------------------------------
# routing (device ops, static shapes)
# ---------------------------------------------------------------------------


class Routing(NamedTuple):
    src: torch.Tensor           # [M_pad] token-row gather index (N = zero row)
    dest_by_a: torch.Tensor     # [A] sorted-row index of assignment a
    block_expert: torch.Tensor  # [M_pad // bm] expert id per M-block
    # port only: rows of each block that hold an assignment (the live rows
    # of a segment come first), so the kernel can skip the rest
    block_rows: torch.Tensor    # [M_pad // bm]


def route_tokens(eid: torch.Tensor, num_experts: int, top_k: int,
                 bm: int) -> Routing:
    """Sort the A = N * top_k expert assignments into block-aligned expert
    segments.  `eid[a]` is the expert of assignment `a` (token `a //
    top_k`).  Padding rows point `src` at row N (the caller appends a zero
    row).  Gives the JAX package's `src`, `dest_by_a` and `block_expert`
    bit for bit, with no op that synchronises the host: counts by
    `scatter_add_`, a stable `argsort`, static-size scatters."""
    dev = eid.device
    a_tot = eid.shape[0]
    n_tok = a_tot // top_k
    eid = eid.to(torch.int64)
    counts = torch.zeros((num_experts,), dtype=torch.int64, device=dev)
    counts.scatter_add_(0, eid, torch.ones_like(eid))
    seg = torch.div(counts + (bm - 1), bm, rounding_mode="floor") * bm
    ends = torch.cumsum(seg, 0)
    starts = ends - seg
    order = torch.argsort(eid, stable=True)
    eid_s = eid.index_select(0, order)
    run_start = (torch.cumsum(counts, 0) - counts).index_select(0, eid_s)
    rank = torch.arange(a_tot, device=dev) - run_start
    dest = starts.index_select(0, eid_s) + rank
    n_mb = -(-a_tot // bm) + num_experts                  # static bound
    src = torch.full((n_mb * bm,), n_tok, dtype=torch.int64, device=dev)
    src.scatter_(0, dest, torch.div(order, top_k, rounding_mode="floor"))
    dest_by_a = torch.zeros((a_tot,), dtype=torch.int64, device=dev)
    dest_by_a.scatter_(0, order, dest)
    blk = torch.arange(n_mb, device=dev) * bm
    block_expert = torch.clamp(
        torch.searchsorted(ends, blk, right=True), 0, num_experts - 1)
    live_end = (starts + counts).index_select(0, block_expert)
    block_rows = torch.clamp(live_end - blk, 0, bm)
    return Routing(src.to(torch.int32), dest_by_a.to(torch.int32),
                   block_expert.to(torch.int32), block_rows.to(torch.int32))


def choose_bm(max_k: int, dtype, device=None) -> int:
    """M block.  On the CPU the JAX package's rule: 128 rows unless a
    [bm, K] block of x would exceed 4 MB of the TPU's VMEM (then 64), so
    the plain versions route as the reference does.  On the card 128 rows
    whatever K: the grouped GEMMs stream x through TMA in 64-wide K steps
    and never hold such a block, and 128-row tiles dequantize each expert
    tile for twice the rows.  A token's output does not depend on bm (each
    row is its expert's product; padding rows are skipped)."""
    if device is not None and torch.device(device).type == "cuda":
        return 128
    nbytes = 2 if dtype == torch.bfloat16 else 4
    return 128 if max_k * nbytes * 128 <= 4 * 1024 * 1024 else 64


def _bands(spec: QSpec) -> int:
    return 1 if spec.bits == 8 and not spec.is_lut else (
        32 // (4 if spec.is_lut else spec.bits))


def _kernel_group_stacked(st: StackedExperts) -> int:
    """The JAX kernel's group: g, or gcd(g, K / bands) where a group
    straddles a band."""
    k = st.shape[0]
    g = st.spec.effective_group(k)
    if g >= k:
        return g
    kw = k // _bands(st.spec)
    if g <= kw and kw % g == 0:
        return g
    return math.gcd(g, kw)


def _stack_kernel_ok(st: StackedExperts) -> bool:
    """Packs the JAX package's Pallas kernel takes (LUT, INT 1/2/4/8 with
    or without zero points)."""
    spec = st.spec
    if st.k_shards != 1 or len(st.data) != 1:
        return False
    if not (spec.is_lut or spec.bits in (1, 2, 4, 8)):
        return False
    return _kernel_group_stacked(st) >= 32


GROUPED_BMS = (64, 128)


def grouped_kernel_eligible(st: StackedExperts) -> bool:
    """Packs kernel 11 takes: one int4 plane per expert, symmetric, bf16
    group scales with g a multiple of 8 dividing K, K % 64 == 0, N % 8 ==
    0 (kernel A's formats); the rest of `_stack_kernel_ok`'s packs go to
    the grouped F/P instances (`grouped_kernel_for`)."""
    spec = st.spec
    k, n = st.shape
    g = spec.effective_group(k)
    return (spec.qtype == QType.INT and spec.bits == 4 and spec.symmetric
            and st.zeros is None and st.k_shards == 1 and len(st.data) == 1
            and st.scales.dtype == torch.bfloat16
            and k % 64 == 0 and n % 8 == 0 and g % 8 == 0 and k % g == 0)


def grouped_kernel_for(st: StackedExperts) -> str:
    """Which grouped kernel takes the stack: "11" (kernel 11), "fp" (the
    grouped instances of kernels F and P), or "" (multi-plane or K-slab
    stacks).  Every stack `_stack_kernel_ok` takes has a kernel."""
    spec = st.spec
    if st.k_shards != 1 or len(st.data) != 1:
        return ""
    if grouped_kernel_eligible(st):
        return "11"
    if spec.is_lut or spec.bits in (1, 2, 4, 8):
        return "fp"
    return ""


def _grouped_fp_shape_ok(st: StackedExperts) -> bool:
    """Shapes the grouped F/P instances take, per expert as `qmatmul`'s F
    and P do (`_fp_shape_ok`), stacked on a leading axis."""
    k, n = st.shape
    e = st.n_experts
    g = st.spec.effective_group(k)
    bands = _bands(st.spec)
    byte_rows = st.spec.bits == 8 and not st.spec.is_lut
    plane = st.data[0]
    return (n % 8 == 0 and g % 8 == 0 and k % g == 0
            and k % (bands * 8) == 0 and plane.shape == (e, k // bands, n)
            and plane.dtype == (torch.uint8 if byte_rows else torch.int32)
            and st.scales.shape == (e, k // g, n)
            and st.scales.dtype in (torch.bfloat16, torch.float32)
            and (st.zeros is None or (st.zeros.dtype == torch.uint8
                                      and st.zeros.shape == (e, k // g, n))))


def grouped_kernel_takes(st: StackedExperts) -> bool:
    """Whether a grouped kernel takes the stack as stored: its format and
    its shapes (the wrapper's checks, devices aside)."""
    route = grouped_kernel_for(st)
    return route == "11" or (route == "fp" and _grouped_fp_shape_ok(st))


def _describe_stack(st: StackedExperts) -> str:
    return (f"{_describe(st.expert(0))} x {st.n_experts} experts")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def grouped_qmatmul_plain(xs: torch.Tensor, st: StackedExperts,
                          block_expert: torch.Tensor, bm: int) -> torch.Tensor:
    """Plain version (the JAX package's `_grouped_xla`): each expert's
    dense product over every row, kept where the row's block belongs to it.
    The weight is rounded to the compute dtype (bf16 for bf16 rows) before
    a product with float32 sums, as `qmatmul_xla(..., float32)` does."""
    cdt = torch.bfloat16 if xs.dtype == torch.bfloat16 else torch.float32
    row_e = block_expert.to(torch.int64)[:, None].expand(-1, bm).reshape(-1)
    xf = xs.to(cdt).float()
    out = torch.zeros((xs.shape[0], st.shape[1]), dtype=torch.float32,
                      device=xs.device)
    for e in range(st.n_experts):
        y = xf @ dequantize(st.expert(e), cdt).float()
        out = torch.where((row_e == e)[:, None], y, out)
    return out


def grouped_qmatmul_rows_plain(x2: torch.Tensor, st: StackedExperts,
                               row_expert: torch.Tensor) -> torch.Tensor:
    """Plain version of the per-row entry: row m times expert
    `row_expert[m]`, on exact float32 weights (the compute dtype of
    `qmatmul` at M <= 32), float32 output."""
    row_e = row_expert.to(torch.int64)
    xf = x2.float()
    out = torch.zeros((x2.shape[0], st.shape[1]), dtype=torch.float32,
                      device=x2.device)
    for e in range(st.n_experts):
        y = xf @ dequantize(st.expert(e), torch.float32)
        out = torch.where((row_e == e)[:, None], y, out)
    return out


# ---------------------------------------------------------------------------
# kernel 11
# ---------------------------------------------------------------------------


def _grouped_checks(x2: torch.Tensor, st: StackedExperts, what: str,
                    extra=()) -> None:
    k, n = st.shape
    g = st.spec.effective_group(k)
    e = st.n_experts
    words = st.data[0]
    tensors = (x2, words, st.scales, *extra)
    ok = (grouped_kernel_eligible(st) and x2.dtype == torch.bfloat16
          and x2.shape[1] == k and words.dtype == torch.int32
          and words.shape == (e, k // 8, n)
          and st.scales.shape == (e, k // g, n)
          and all(t.is_cuda and t.device == x2.device and t.is_contiguous()
                  and t.data_ptr() % 16 == 0 for t in tensors))
    if not ok:
        raise ValueError(
            f"kernel 11 ({what}) takes contiguous, 16-byte aligned CUDA "
            f"tensors: bf16 x [M, K] and int4/symmetric/bf16-scale experts "
            f"stacked [E, K/8, N] with K % 64 == 0, "
            f"N % 8 == 0, g % 8 == 0; "
            f"got x {x2.dtype} {tuple(x2.shape)} on {x2.device}, pack "
            f"{_describe_stack(st)} on {words.device}")


def grouped_qmatmul_cuda(xs: torch.Tensor, st: StackedExperts,
                         block_expert: torch.Tensor, bm: int,
                         block_rows: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Kernel 11's GEMM on sorted rows `xs [M_pad, K]` bf16: row block i
    (of `bm` rows) times expert `block_expert[i]`; output float32.  With
    `block_rows`, rows of block i past `block_rows[i]` are written as zeros
    without being computed (they read the zero row)."""
    m = xs.shape[0]
    n_mb = m // bm if bm else 0
    idx = (block_expert,) + (() if block_rows is None else (block_rows,))
    _grouped_checks(xs, st, "GEMM", idx)
    if bm not in GROUPED_BMS or m % bm or any(
            t.dtype != torch.int32 or t.shape != (n_mb,) for t in idx):
        raise ValueError(
            f"kernel 11 (GEMM) takes bm in {GROUPED_BMS} dividing M and int32 "
            f"block maps [M / bm]; got bm {bm}, M {m}, maps "
            f"{[(t.dtype, tuple(t.shape)) for t in idx]}")
    k, n = st.shape
    xk = _band_major(xs, 8)
    out = torch.empty((m, n), dtype=torch.float32, device=xs.device)
    fn = _build.kernels.fn("qmatmul_grouped", "nst_qmatmul_grouped_gemm", 6, 5)
    code = fn(xk.data_ptr(), st.data[0].data_ptr(), st.scales.data_ptr(),
              block_expert.data_ptr(),
              0 if block_rows is None else block_rows.data_ptr(),
              out.data_ptr(), m, k, n, st.spec.effective_group(k), bm,
              _build.stream_handle())
    _build.check(code, "qmatmul_grouped")
    _build.launches["qmatmul_grouped"] += 1
    return out


def grouped_qmatmul_rows_cuda(x2: torch.Tensor, st: StackedExperts,
                              row_expert: torch.Tensor) -> torch.Tensor:
    """Kernel 11's GEMV: row m of `x2 [M, K]` bf16 (M <= 32) times expert
    `row_expert[m]`, split over K as kernel A's GEMV; float32 output."""
    m = x2.shape[0]
    _grouped_checks(x2, st, "GEMV", (row_expert,))
    if not (1 <= m <= GEMV_MAX_M and row_expert.dtype == torch.int32
            and row_expert.shape == (m,)):
        raise ValueError(
            f"kernel 11 (GEMV) takes 1..{GEMV_MAX_M} rows and an int32 "
            f"expert per row; got M {m}, experts {row_expert.dtype} "
            f"{tuple(row_expert.shape)}")
    k, n = st.shape
    splits = _gemv_splits(k, n, _sm_count(x2.device.index or 0))
    out = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    partial = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=x2.device) if splits > 1 else out)
    fn = _build.kernels.fn("qmatmul_grouped", "nst_qmatmul_grouped_gemv", 6, 5)
    code = fn(x2.data_ptr(), st.data[0].data_ptr(), st.scales.data_ptr(),
              row_expert.data_ptr(), partial.data_ptr(), out.data_ptr(), m, k,
              n, st.spec.effective_group(k), splits, _build.stream_handle())
    _build.check(code, "qmatmul_grouped")
    _build.launches["qmatmul_grouped"] += 1
    return out


# ---------------------------------------------------------------------------
# the grouped instances of kernels F and P
# ---------------------------------------------------------------------------


def _grouped_fp_args(x2: torch.Tensor, st: StackedExperts, what: str,
                     idx) -> tuple:
    """Checks of the grouped F/P instances; returns (library, pointers of
    the pack, ints of the pack)."""
    spec = st.spec
    tensors = (x2, st.data[0], st.scales) + tuple(idx) + (
        () if st.zeros is None else (st.zeros,))
    ok = (grouped_kernel_for(st) == "fp" and _grouped_fp_shape_ok(st)
          and x2.dtype == torch.bfloat16 and x2.shape[1] == st.shape[0]
          and all(t.is_cuda and t.device == x2.device and t.is_contiguous()
                  and t.data_ptr() % 16 == 0 for t in tensors))
    if not ok:
        raise ValueError(
            f"the grouped F/P instances ({what}) take contiguous, 16-byte "
            f"aligned CUDA tensors: bf16 x [M, K] and one-plane NF4 / FP4 / "
            f"INT 1/2/4/8 experts stacked [E, K*w/32, N] ([E, K, N] bytes "
            f"for INT8) with bf16 or float32 scales and no or uint8 zero "
            f"points, g % 8 == 0, N % 8 == 0; got x {x2.dtype} "
            f"{tuple(x2.shape)} on {x2.device}, pack {_describe_stack(st)} "
            f"on {st.data[0].device}")
    fmt = "lut4" if spec.is_lut else f"int{spec.bits}"
    table = 0
    if spec.is_lut:
        from .quantize import lut_values

        table = lut_values(spec, torch.float32, x2.device).data_ptr()
    zmode = 2 if st.zeros is not None else (0 if spec.is_lut else 1)
    ptrs = (st.data[0].data_ptr(), st.scales.data_ptr(),
            0 if st.zeros is None else st.zeros.data_ptr(), table)
    ints = (int(st.scales.dtype == torch.bfloat16), zmode)
    return f"qmatmul_grouped_fp_{fmt}", ptrs, ints


def grouped_qmatmul_fp_cuda(xs: torch.Tensor, st: StackedExperts,
                            block_expert: torch.Tensor, bm: int,
                            block_rows: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The grouped F/P GEMM on sorted rows `xs [M_pad, K]` bf16: row block
    i (of `bm` rows) times expert `block_expert[i]`; output float32.  With
    `block_rows`, rows of block i past `block_rows[i]` are written as zeros
    without being computed."""
    m = xs.shape[0]
    n_mb = m // bm if bm else 0
    idx = (block_expert,) + (() if block_rows is None else (block_rows,))
    lib, ptrs, ints = _grouped_fp_args(xs, st, "GEMM", idx)
    if bm not in GROUPED_BMS or m % bm or any(
            t.dtype != torch.int32 or t.shape != (n_mb,) for t in idx):
        raise ValueError(
            f"the grouped F/P GEMM takes bm in {GROUPED_BMS} dividing M and "
            f"int32 block maps [M / bm]; got bm {bm}, M {m}, maps "
            f"{[(t.dtype, tuple(t.shape)) for t in idx]}")
    k, n = st.shape
    xk = _band_major(xs, _bands(st.spec))
    out = torch.empty((m, n), dtype=torch.float32, device=xs.device)
    fn = _build.kernels.fn(lib, "nst_qmatmul_grouped_fp_gemm", 8, 7)
    code = fn(xk.data_ptr(), *ptrs, block_expert.data_ptr(),
              0 if block_rows is None else block_rows.data_ptr(),
              out.data_ptr(), m, k, n, st.spec.effective_group(k), bm, *ints,
              _build.stream_handle())
    _build.check(code, lib)
    _build.launches["qmatmul_grouped_fp"] += 1
    return out


def grouped_qmatmul_rows_fp_cuda(x2: torch.Tensor, st: StackedExperts,
                                 row_expert: torch.Tensor) -> torch.Tensor:
    """The grouped F/P GEMV: row m of `x2 [M, K]` bf16 (M <= 32) times
    expert `row_expert[m]`, split over K; float32 output."""
    m = x2.shape[0]
    lib, ptrs, ints = _grouped_fp_args(x2, st, "GEMV", (row_expert,))
    if not (1 <= m <= GEMV_MAX_M and row_expert.dtype == torch.int32
            and row_expert.shape == (m,)):
        raise ValueError(
            f"the grouped F/P GEMV takes 1..{GEMV_MAX_M} rows and an int32 "
            f"expert per row; got M {m}, experts {row_expert.dtype} "
            f"{tuple(row_expert.shape)}")
    k, n = st.shape
    splits = _gemv_splits(k, n, _sm_count(x2.device.index or 0),
                          _bands(st.spec))
    out = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    partial = (torch.empty((splits, m, n), dtype=torch.float32,
                           device=x2.device) if splits > 1 else out)
    fn = _build.kernels.fn(lib, "nst_qmatmul_grouped_fp_gemv", 8, 7)
    code = fn(x2.data_ptr(), *ptrs, row_expert.data_ptr(), partial.data_ptr(),
              out.data_ptr(), m, k, n, st.spec.effective_group(k), splits,
              *ints, _build.stream_handle())
    _build.check(code, lib)
    _build.launches["qmatmul_grouped_fp"] += 1
    return out


def _no_kernel(st: StackedExperts) -> ValueError:
    return ValueError(
        f"no CUDA kernel takes this expert stack yet (the JAX package runs "
        f"it through XLA): {_describe_stack(st)}; the grouped kernels take "
        f"one-plane NF4 / FP4 / INT 1/2/4/8 stacks in one K slab")


def _pad_k(x: torch.Tensor, st: StackedExperts) -> torch.Tensor:
    if x.shape[-1] != st.shape[0]:
        x = torch.nn.functional.pad(x, (0, st.shape[0] - x.shape[-1]))
    return x.contiguous()


def grouped_qmatmul(xs: torch.Tensor, st: StackedExperts,
                    block_expert: torch.Tensor, bm: int,
                    block_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sorted-rows grouped matmul: row block i uses expert
    `block_expert[i]`'s weights.  xs: [M, K] -> [M, N] float32.
    `block_rows` (optional, from `route_tokens`) lets the kernel skip the
    padding rows of each block; the plain version computes them (they
    read the zero row and give zeros)."""
    st = st.local_view()
    xs = _pad_k(xs, st)
    if xs.device.type == "cpu":
        _build.plain_dispatches["qmatmul_grouped"] += 1
        return grouped_qmatmul_plain(xs, st, block_expert, bm)
    route = grouped_kernel_for(st)
    if route == "11":
        return grouped_qmatmul_cuda(xs, st, block_expert, bm, block_rows)
    if route == "fp":
        return grouped_qmatmul_fp_cuda(xs, st, block_expert, bm, block_rows)
    raise _no_kernel(st)


def grouped_qmatmul_rows(x2: torch.Tensor, st: StackedExperts,
                         row_expert: torch.Tensor) -> torch.Tensor:
    """Per-row grouped matmul for at most 32 rows: row m uses expert
    `row_expert[m]` (read on the device).  [M, K] -> [M, N] float32."""
    st = st.local_view()
    x2 = _pad_k(x2, st)
    if x2.device.type == "cpu":
        _build.plain_dispatches["qmatmul_grouped"] += 1
        return grouped_qmatmul_rows_plain(x2, st, row_expert)
    route = grouped_kernel_for(st)
    if route == "11":
        return grouped_qmatmul_rows_cuda(x2, st, row_expert)
    if route == "fp":
        return grouped_qmatmul_rows_fp_cuda(x2, st, row_expert)
    raise _no_kernel(st)
