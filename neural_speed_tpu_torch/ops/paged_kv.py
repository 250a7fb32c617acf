"""Paged KV cache (port of `neural_speed_tpu/ops/paged_kv.py`).

A physical page pool shared by all slots, so memory follows the tokens in
flight rather than slots x max_len:

    k_pages / v_pages : [L, H_kv, P, page_size, D] bf16 (the default), or
                        int8 codes when quantized
    k_scale / v_scale : [L, H_kv, P, 1, page_size] bf16 or float32
                        (quantized only; `kv_cache.kv_scale_dtype`)
    page_tables       : [B, n_blocks] int32; logical block j of slot b lives
                        in physical page page_tables[b, j]
    lengths           : [B] int32 tokens stored per slot

The last physical page is the trash page: padding rows and inactive slots
park their writes on its last row, and no sequence is ever given it.  The
attention kernels read KV through the table (`flash.mha_paged`), so nothing
is gathered on the card.  Page allocation is host-side (`PageAllocator`),
owned by the engine.

JAX's scatters into a functional pool become in-place index writes here:
the appends mutate the cache they are given and return it.
`PrefixPageCache`, `copy_pages` and the unsafe `append_prefill` are not
ported.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from .kv_cache import kv_scale_dtype, quantize_kv


@dataclasses.dataclass
class PagedKVCache:
    k_pages: torch.Tensor
    v_pages: torch.Tensor
    k_scale: Optional[torch.Tensor]
    v_scale: Optional[torch.Tensor]
    page_tables: torch.Tensor    # [B, n_blocks] int32
    lengths: torch.Tensor        # [B] int32

    @property
    def quantized(self) -> bool:
        return self.k_pages.dtype == torch.int8

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[3]

    @property
    def n_pages(self) -> int:
        return self.k_pages.shape[2]

    @property
    def n_blocks(self) -> int:
        return self.page_tables.shape[1]

    @property
    def kv_heads(self) -> int:
        return self.k_pages.shape[1]

    @property
    def layers(self) -> int:
        return self.k_pages.shape[0]

    @property
    def batch(self) -> int:
        return self.page_tables.shape[0]

    @property
    def max_len(self) -> int:
        return self.n_blocks * self.page_size


def init_paged_cache(layers: int, batch: int, max_len: int, kv_heads: int,
                     head_dim: int, n_pages: int, page_size: int = 128,
                     dtype=torch.bfloat16, quantized: bool = False,
                     device=None, scale_dtype=None) -> PagedKVCache:
    """Zeroed pool on `device` (the card unless the CPU is asked for):
    `dtype` values (bf16 by default, or float32), or with `quantized`
    int8 codes and scales of `kv_scale_dtype(scale_dtype)` (bf16 unless
    asked or `NST_KV_SCALE_DTYPE=f32`).  `n_pages` counts the trash
    page."""
    from .._build import resolve_device

    if max_len % page_size:
        raise ValueError(f"max_len {max_len} is not a multiple of the page "
                         f"size {page_size}")
    dev = resolve_device(device)
    shape = (layers, kv_heads, n_pages, page_size, head_dim)
    sshape = shape[:3] + (1, page_size)
    tables = torch.zeros((batch, max_len // page_size), dtype=torch.int32,
                         device=dev)
    lengths = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if not quantized:
        return PagedKVCache(torch.zeros(shape, dtype=dtype, device=dev),
                            torch.zeros(shape, dtype=dtype, device=dev),
                            None, None, tables, lengths)
    sdt = kv_scale_dtype(scale_dtype)
    return PagedKVCache(
        torch.zeros(shape, dtype=torch.int8, device=dev),
        torch.zeros(shape, dtype=torch.int8, device=dev),
        torch.zeros(sshape, dtype=sdt, device=dev),
        torch.zeros(sshape, dtype=sdt, device=dev), tables, lengths)


class PageAllocator:
    """Host-side physical page manager with reference counts (a page
    returns to the free list when its count drops to zero)."""

    def __init__(self, n_pages: int):
        self.free: List[int] = list(range(n_pages))
        self.refs = {}  # page -> refcount (absent == in the free list)

    @property
    def available(self) -> int:
        return len(self.free)

    def alloc_run(self, n: int) -> Optional[int]:
        """Allocate `n` contiguous pages (first fit over the sorted free
        list); returns the first page or None."""
        self.free.sort()
        run = 1
        for i in range(1, len(self.free) + 1):
            if i < len(self.free) and self.free[i] == self.free[i - 1] + 1:
                run += 1
            else:
                if run >= n:
                    start_idx = i - run
                    first = self.free[start_idx]
                    del self.free[start_idx:start_idx + n]
                    for p in range(first, first + n):
                        self.refs[p] = 1
                    return first
                run = 1
        return None

    def alloc_page(self) -> Optional[int]:
        if not self.free:
            return None
        p = self.free.pop()
        self.refs[p] = 1
        return p

    def share_pages(self, pages: List[int]) -> None:
        for p in pages:
            self.refs[int(p)] = self.refs.get(int(p), 0) + 1

    def free_pages(self, pages: List[int]) -> None:
        for p in pages:
            p = int(p)
            if p not in self.refs:
                raise RuntimeError(
                    f"double free of page {p} (not allocated)")
            rc = self.refs[p] - 1
            if rc <= 0:
                self.refs.pop(p)
                self.free.append(p)
            else:
                self.refs[p] = rc


# ---------------------------------------------------------------------------
# appends
# ---------------------------------------------------------------------------


def physical_rows(tables: torch.Tensor, pos: torch.Tensor,
                  page_size: int) -> torch.Tensor:
    """Pool row (page * page_size + offset) of logical positions `pos`
    `[B, T]` through the page tables `[B, n_blocks]`."""
    page = torch.gather(tables, 1, (pos // page_size).long())
    return page * page_size + pos % page_size


def write_pool_rows(k_pages: torch.Tensor, v_pages: torch.Tensor,
                    k_scale, v_scale, layer: int, rows: torch.Tensor,
                    k_new: torch.Tensor, v_new: torch.Tensor) -> None:
    """Write k/v `[N, H, D]` at pool rows `rows [N]` of `layer`, in place:
    quantized over an int8 pool, cast to the pool's dtype over a float one
    (scales None).  Rows must be distinct except the trash row, which takes
    whichever write lands last."""
    h, p, ps, d = k_pages.shape[1:]
    idx = rows.reshape(-1).long()
    for pages, scales, x in ((k_pages, k_scale, k_new), (v_pages, v_scale,
                                                           v_new)):
        if scales is None:
            pages[layer].view(h, p * ps, d)[:, idx] = (
                x.transpose(0, 1).to(pages.dtype))
            continue
        codes, sc = quantize_kv(x)                     # [N, H, D], [N, H, 1]
        pages[layer].view(h, p * ps, d)[:, idx] = codes.transpose(0, 1)
        scales[layer].view(h, p * ps)[:, idx] = (
            sc[..., 0].transpose(0, 1).to(scales.dtype))


def append_span(cache: PagedKVCache, layer: int, k_new: torch.Tensor,
                v_new: torch.Tensor, positions: torch.Tensor,
                active: Optional[torch.Tensor] = None) -> PagedKVCache:
    """Multi-token write resolved row by row through the page table, in
    place: physical row = table[b, pos // ps] * ps + pos % ps.  Padding
    positions (>= max_len - 1) and inactive slots park on the trash row.
    k_new/v_new: [B, T, H, D]; positions [B, T]."""
    b, t = positions.shape
    pos = positions.clamp(0, cache.max_len - 1)
    row = physical_rows(cache.page_tables, pos, cache.page_size)
    trash = cache.n_pages * cache.page_size - 1
    valid = pos < cache.max_len - 1
    if active is not None:
        valid = valid & active[:, None]
    row = torch.where(valid, row, torch.full_like(row, trash))
    h, d = k_new.shape[2:]
    write_pool_rows(cache.k_pages, cache.v_pages, cache.k_scale,
                    cache.v_scale, layer, row, k_new.reshape(b * t, h, d),
                    v_new.reshape(b * t, h, d))
    return cache


def append_decode(cache: PagedKVCache, layer: int, k_new: torch.Tensor,
                  v_new: torch.Tensor, positions: torch.Tensor,
                  active: Optional[torch.Tensor] = None) -> PagedKVCache:
    """Single-token write through the page table, in place.  An inactive
    slot's write goes to the trash row: its table may still name pages that
    another slot owns now, and every page but the trash page keeps its
    bytes, as the JAX package's blend leaves them.
    k_new/v_new: [B, 1, H, D]; positions [B, 1]."""
    pos = positions[:, :1].clamp(0, cache.max_len - 1)
    row = physical_rows(cache.page_tables, pos, cache.page_size)[:, 0]
    if active is not None:
        trash = cache.n_pages * cache.page_size - 1
        row = torch.where(active, row, torch.full_like(row, trash))
    write_pool_rows(cache.k_pages, cache.v_pages, cache.k_scale,
                    cache.v_scale, layer, row, k_new[:, 0], v_new[:, 0])
    return cache


def gather_layer_codes(k_pages: torch.Tensor, v_pages: torch.Tensor,
                       k_scale, v_scale, tables: torch.Tensor, layer: int
                       ) -> Tuple[Optional[torch.Tensor], ...]:
    """One layer of the pool in the contiguous cache's logical layout:
    rows [B, H, S, D] and scales [B, H, S] (None for a float pool),
    S = n_blocks * page_size (exact copies: the plain versions of the paged
    kernels read these)."""
    def merge(a):                                  # [H, B, nb, ps, D]
        h, b, nb, ps, d = a.shape
        return a.permute(1, 0, 2, 3, 4).reshape(b, h, nb * ps, d)

    def merge_s(a):                                # [H, B, nb, 1, ps]
        h, b, nb, _, ps = a.shape
        return a.permute(1, 0, 2, 4, 3).reshape(b, h, nb * ps)

    t = tables.long()
    scales = (None, None) if k_scale is None else (
        merge_s(k_scale[layer][:, t]), merge_s(v_scale[layer][:, t]))
    return (merge(k_pages[layer][:, t]), merge(v_pages[layer][:, t]),
            *scales)


def gathered_layer(cache: PagedKVCache, layer: int,
                   dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """Materialize logical [B, Hkv, S, D] K/V of one layer, dequantized
    (the float32 reference route and the tests; the kernels never do
    this)."""
    kc, vc, ks, vs = gather_layer_codes(cache.k_pages, cache.v_pages,
                                        cache.k_scale, cache.v_scale,
                                        cache.page_tables, layer)
    if ks is None:
        return kc.to(dtype), vc.to(dtype)
    kf = kc.float() * ks.float()[..., None]
    vf = vc.float() * vs.float()[..., None]
    return kf.to(dtype), vf.to(dtype)
