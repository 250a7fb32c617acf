"""Flash attention over the int8 KV cache (port of `neural_speed_tpu/ops/flash.py`).

`mha` is the entry, with the JAX package's interface: q `[B, T, H, D]`, the
stacked cache `[L, B, Hkv, S, D]` with `layer`, per-(token, head) scales,
absolute query positions and per-slot kv lengths.  Two routes:

* decode with the current token's k/v as extra operands (`extra_kv`, one
  token per slot): kernel B (`csrc/flash_decode.cu`), which with
  `fused_append` also writes the quantized new row in place;
* everything else (prefill chunks; decode after a plain append): kernel C
  (`csrc/flash_prefill.cu`).

`mha_paged` is the same over one layer of the paged pool (`paged_kv.py`):
the paged twins of kernels B and C (`nst_flash_decode_paged`,
`nst_flash_prefill_paged`, in the same sources) resolve every cache row
through the slot's page table and otherwise do the same arithmetic in the
same order, so at equal logical contents they give the contiguous
kernels' outputs bit for bit.

CUDA tensors launch the kernel or raise; CPU tensors run the plain
versions below, which repeat each kernel's rounding points: q and
`P * v_scale` are rounded to bf16, the scores and sums are float32, and a
row with no valid column gives 0.  The port has no GQA row packing: the
kernels read q and write the output in the natural `[B, T, H, D]` layout.
"""

from __future__ import annotations

import torch

from .. import _build
from .kv_cache import quantize_kv
from .paged_kv import gather_layer_codes, physical_rows, write_pool_rows

DECODE_CHUNK = 256   # cache columns per block of kernel B


def extra_kv_eligible(t: int, n_heads: int, n_kv_heads: int) -> bool:
    """When the decode kernel's extra-kv column engages: one token per slot
    and at most 8 query heads per KV head (the JAX rule `t * n_rep <= 8`
    at t == 1)."""
    return t == 1 and n_heads // n_kv_heads <= 8


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _softmax_pv(sc: torch.Tensor, valid: torch.Tensor, vsc: torch.Tensor,
                vf: torch.Tensor, s0=None, valid0=None, v0=None):
    """Exact-max softmax with the kernels' rounding points.  sc/valid:
    [..., R, S]; vsc: [..., 1, S]; vf: [..., S, D]; optional seed column
    s0/valid0 [..., R] with value row v0 [..., 1, D].  Returns acc, l."""
    neg = sc.new_full((), float("-inf"))    # a fill: no host-device copy
    m = torch.where(valid, sc, neg).amax(dim=-1)
    if s0 is not None:
        m = torch.maximum(m, torch.where(valid0, s0, neg))
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.where(valid, torch.exp(sc - m[..., None]), torch.zeros_like(sc))
    l = p.sum(dim=-1)
    pw = (p * vsc).to(torch.bfloat16).float()
    acc = pw @ vf
    if s0 is not None:
        p0 = torch.where(valid0, torch.exp(s0 - m), torch.zeros_like(s0))
        l = l + p0
        acc = acc + p0[..., None] * v0
    return acc, l


def _normalize(acc: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    inv = torch.where(l == 0, torch.zeros_like(l), 1.0 / l)
    return acc * inv[..., None]


def decode_plain(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor, ks: torch.Tensor,
                 vs: torch.Tensor, layer: int, pos: torch.Tensor,
                 kv_lens: torch.Tensor, scale: float, fused_append: bool,
                 out_dtype) -> torch.Tensor:
    """Plain version of kernel B.  q [B, 1, H, D]; k_new/v_new [B, 1, Hkv, D];
    k/v/ks/vs the stacked cache; pos [B]; writes the new row in place when
    `fused_append`."""
    b, _, h, d = q.shape
    hkv, s = k.shape[2], k.shape[3]
    n_rep = h // hkv
    ok = pos == kv_lens - 1
    kvl_cache = kv_lens - ok.to(kv_lens.dtype)
    qg = q[:, 0].reshape(b, hkv, n_rep, d)
    kf, vf = k[layer].float(), v[layer].float()              # [B,Hkv,S,D]
    sc = (qg.to(torch.bfloat16).float() @ kf.transpose(-1, -2))
    sc = sc * ks[layer].float()[:, :, None, :] * scale        # [B,Hkv,R,S]
    col = torch.arange(s, device=q.device)
    valid = (col[None] < kvl_cache[:, None]) & (col[None] <= pos[:, None])
    valid = valid[:, None, None, :].expand_as(sc)
    kn = k_new[:, 0].float()                                  # [B, Hkv, D]
    vn = v_new[:, 0].float()
    s0 = (qg.float() * kn[:, :, None, :]).sum(-1) * scale     # [B,Hkv,R]
    valid0 = (ok & (pos >= 0))[:, None, None].expand_as(s0)
    acc, l = _softmax_pv(sc, valid, vs[layer].float()[:, :, None, :], vf,
                         s0, valid0, vn[:, :, None, :])
    out = _normalize(acc, l).reshape(b, 1, h, d).to(out_dtype)
    if fused_append:
        rows = (kv_lens - 1).clamp_min(0)[:, None]
        keep = ok[:, None]
        from .kv_cache import _write_rows

        for dst, dst_s, x in ((k, ks, k_new), (v, vs, v_new)):
            codes, sc_ = quantize_kv(x.transpose(1, 2))       # [B,Hkv,1,*]
            _write_rows(dst, layer, rows, codes, keep)
            _write_rows(dst_s, layer, rows, sc_[..., 0], keep)
    return out


def prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  ks: torch.Tensor, vs: torch.Tensor, layer: int,
                  q_positions: torch.Tensor, kv_lens: torch.Tensor,
                  scale: float, out_dtype) -> torch.Tensor:
    """Plain version of kernel C: q [B, T, H, D] over the stacked cache."""
    b, t, h, d = q.shape
    hkv, s = k.shape[2], k.shape[3]
    n_rep = h // hkv
    rep = lambda a: torch.repeat_interleave(a, n_rep, dim=1)
    kf, vf = rep(k[layer].float()), rep(v[layer].float())   # [B,H,S,D]
    qh = q.to(torch.bfloat16).float().permute(0, 2, 1, 3)   # [B,H,T,D]
    sc = (qh @ kf.transpose(-1, -2)) * rep(ks[layer].float())[:, :, None, :]
    sc = sc * scale
    col = torch.arange(s, device=q.device)
    valid = ((col[None, None] < kv_lens[:, None, None])
             & (col[None, None] <= q_positions[:, :, None]))  # [B,T,S]
    valid = valid[:, None].expand_as(sc)
    acc, l = _softmax_pv(sc, valid, rep(vs[layer].float())[:, :, None, :], vf)
    return _normalize(acc, l).permute(0, 2, 1, 3).to(out_dtype)


def decode_paged_plain(q: torch.Tensor, k_new: torch.Tensor,
                       v_new: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, ks: torch.Tensor,
                       vs: torch.Tensor, tables: torch.Tensor, layer: int,
                       pos: torch.Tensor, kv_lens: torch.Tensor, scale: float,
                       fused_append: bool, out_dtype) -> torch.Tensor:
    """Plain version of the paged decode kernel: `decode_plain` over the
    layer gathered through the tables; with `fused_append` the live slots'
    quantized rows go to the pool at table[b, (kv_len - 1) // ps]."""
    cache = [a[None] for a in gather_layer_codes(k_pages, v_pages, ks, vs,
                                                 tables, layer)]
    out = decode_plain(q, k_new, v_new, *cache, 0, pos, kv_lens, scale,
                       False, out_dtype)
    if fused_append:
        live = pos == kv_lens - 1
        ps = k_pages.shape[3]
        last = (kv_lens - 1).clamp(0, tables.shape[1] * ps - 1)
        row = physical_rows(tables, last[:, None], ps)[:, 0]
        trash = k_pages.shape[2] * ps - 1
        row = torch.where(live, row, torch.full_like(row, trash))
        write_pool_rows(k_pages, v_pages, ks, vs, layer, row, k_new[:, 0],
                        v_new[:, 0])
    return out


def prefill_paged_plain(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, ks: torch.Tensor,
                        vs: torch.Tensor, tables: torch.Tensor, layer: int,
                        q_positions: torch.Tensor, kv_lens: torch.Tensor,
                        scale: float, out_dtype) -> torch.Tensor:
    """Plain version of the paged prefill kernel: `prefill_plain` over the
    layer gathered through the tables."""
    cache = [a[None] for a in gather_layer_codes(k_pages, v_pages, ks, vs,
                                                 tables, layer)]
    return prefill_plain(q, *cache, 0, q_positions, kv_lens, scale,
                         out_dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_cache(k, v, ks, vs, layer, pos, kv_lens, q) -> None:
    """The cache, positions and lengths the attention kernels index."""
    b, t, _, d = q.shape
    ok = (k.dim() == 5 and k.shape == v.shape and k.shape[1] == b
          and k.shape[4] == d and ks.shape == vs.shape == k.shape[:4]
          and 0 <= layer < k.shape[0]
          and all(a.device == q.device and a.is_contiguous()
                  for a in (k, v, ks, vs))
          and k.dtype == torch.int8 and v.dtype == torch.int8
          and ks.dtype == torch.bfloat16 and vs.dtype == torch.bfloat16
          and d in (64, 128) and k.shape[3] % 64 == 0
          and pos.shape in ((b,), (b, t)) and kv_lens.shape == (b,)
          and pos.device == kv_lens.device == q.device)
    if not ok:
        raise ValueError(
            f"the attention kernels read a contiguous [L, B, Hkv, S, D] int8 "
            f"cache with bf16 [L, B, Hkv, S] scales on q's device, head_dim "
            f"64 or 128, S a multiple of 64, a layer index below L and "
            f"positions / kv_lens of the batch; got q {tuple(q.shape)} on "
            f"{q.device}, k {k.dtype} {tuple(k.shape)} on {k.device}, scales "
            f"{ks.dtype} {tuple(ks.shape)}, layer {layer}, positions "
            f"{tuple(pos.shape)}, kv_lens {tuple(kv_lens.shape)}")


def decode_cuda(q, k_new, v_new, k, v, ks, vs, layer, pos, kv_lens, scale,
                fused_append, out_dtype) -> torch.Tensor:
    """Kernel B.  Shapes as `decode_plain`."""
    b, t, h, d = q.shape
    hkv, s = k.shape[2], k.shape[3]
    dev = q.device
    _check_cache(k, v, ks, vs, layer, pos, kv_lens, q)
    if not (q.is_cuda and t == 1 and h % hkv == 0 and h // hkv <= 8
            and q.dtype == k_new.dtype == v_new.dtype == out_dtype
            == torch.bfloat16
            and k_new.shape == v_new.shape == (b, 1, hkv, d)):
        raise ValueError(
            "kernel B takes CUDA tensors: bf16 q [B, 1, H, D] with H / Hkv "
            "<= 8, bf16 k_new / v_new [B, 1, Hkv, D], and writes bf16; got q "
            f"{q.dtype} {tuple(q.shape)} on {q.device}, k_new {k_new.dtype} "
            f"{tuple(k_new.shape)}, out {out_dtype}")
    q3 = q.contiguous()
    kn, vn = k_new.contiguous(), v_new.contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    lens32 = kv_lens.to(torch.int32).contiguous()
    splits = -(-s // DECODE_CHUNK)
    part_m = torch.empty((b, h, splits), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, h, splits, d), dtype=torch.float32, device=dev)
    out = torch.empty((b, 1, h, d), dtype=torch.bfloat16, device=dev)
    fn = _build.kernels.fn("flash_decode", "nst_flash_decode", 13, 8, 1)
    code = fn(q3.data_ptr(), kn.data_ptr(), vn.data_ptr(), k.data_ptr(),
              v.data_ptr(), ks.data_ptr(), vs.data_ptr(), pos32.data_ptr(),
              lens32.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
              part_acc.data_ptr(), out.data_ptr(), b, h, hkv, s, d, layer,
              DECODE_CHUNK, int(fused_append), float(scale),
              _build.stream_handle())
    _build.check(code, "flash_decode")
    _build.launches["flash_decode"] += 1
    return out


def prefill_cuda(q, k, v, ks, vs, layer, q_positions, kv_lens, scale,
                 out_dtype) -> torch.Tensor:
    """Kernel C.  Shapes as `prefill_plain`."""
    b, t, h, d = q.shape
    hkv, s = k.shape[2], k.shape[3]
    dev = q.device
    _check_cache(k, v, ks, vs, layer, q_positions, kv_lens, q)
    if not (q.is_cuda and q_positions.shape == (b, t) and h % hkv == 0
            and q.dtype == out_dtype == torch.bfloat16):
        raise ValueError(
            f"kernel C takes CUDA tensors: bf16 q [B, T, H, D] with H a "
            f"multiple of Hkv and positions [B, T], and writes bf16; got q "
            f"{q.dtype} {tuple(q.shape)} on {q.device}, Hkv {hkv}, positions "
            f"{tuple(q_positions.shape)}, out {out_dtype}")
    q4 = q.contiguous()
    pos32 = q_positions.to(torch.int32).contiguous()
    lens32 = kv_lens.to(torch.int32).contiguous()
    out = torch.empty((b, t, h, d), dtype=torch.bfloat16, device=dev)
    fn = _build.kernels.fn("flash_prefill", "nst_flash_prefill", 8, 7, 1)
    code = fn(q4.data_ptr(), k.data_ptr(), v.data_ptr(), ks.data_ptr(),
              vs.data_ptr(), pos32.data_ptr(), lens32.data_ptr(),
              out.data_ptr(), b, t, h, hkv, s, d, layer, float(scale),
              _build.stream_handle())
    _build.check(code, "flash_prefill")
    _build.launches["flash_prefill"] += 1
    return out


def _check_pool(kp, vp, ks, vs, tables, layer, pos, kv_lens, q) -> None:
    """The page pool, tables, positions and lengths the paged kernels
    index."""
    b, t, _, d = q.shape
    ok = (kp.dim() == 5 and kp.shape == vp.shape and kp.shape[4] == d
          and ks.shape == vs.shape == kp.shape[:3] + (1, kp.shape[3])
          and 0 <= layer < kp.shape[0] and kp.shape[3] % 16 == 0
          and tables.dim() == 2 and tables.shape[0] == b
          and tables.dtype == torch.int32
          and all(a.device == q.device and a.is_contiguous()
                  for a in (kp, vp, ks, vs, tables))
          and kp.dtype == torch.int8 and vp.dtype == torch.int8
          and ks.dtype == torch.bfloat16 and vs.dtype == torch.bfloat16
          and d in (64, 128)
          and pos.shape in ((b,), (b, t)) and kv_lens.shape == (b,)
          and pos.device == kv_lens.device == q.device)
    if not ok:
        raise ValueError(
            f"the paged attention kernels read an int8 [L, Hkv, P, ps, D] "
            f"pool with bf16 [L, Hkv, P, 1, ps] scales and a page size that "
            f"is a multiple of 16, int32 page tables [B, n_blocks], all on "
            f"q's device, head_dim 64 or 128, a layer index below L and "
            f"positions / kv_lens of the batch; got q {tuple(q.shape)} on "
            f"{q.device}, pool {kp.dtype} {tuple(kp.shape)} on {kp.device} "
            f"(page size {kp.shape[3] if kp.dim() == 5 else None}), scales "
            f"{ks.dtype} {tuple(ks.shape)}, tables {tables.dtype} "
            f"{tuple(tables.shape)} on {tables.device}, layer {layer}, "
            f"positions {tuple(pos.shape)}, kv_lens {tuple(kv_lens.shape)}")


def decode_paged_cuda(q, k_new, v_new, kp, vp, ks, vs, tables, layer, pos,
                      kv_lens, scale, fused_append, out_dtype) -> torch.Tensor:
    """The paged decode kernel (paged twin of kernel B).  Shapes as
    `decode_paged_plain`."""
    b, t, h, d = q.shape
    hkv, n_pages, ps = kp.shape[1], kp.shape[2], kp.shape[3]
    n_blocks = tables.shape[1]
    dev = q.device
    _check_pool(kp, vp, ks, vs, tables, layer, pos, kv_lens, q)
    if not (q.is_cuda and t == 1 and h % hkv == 0 and h // hkv <= 8
            and q.dtype == k_new.dtype == v_new.dtype == out_dtype
            == torch.bfloat16
            and k_new.shape == v_new.shape == (b, 1, hkv, d)):
        raise ValueError(
            "the paged decode kernel takes CUDA tensors: bf16 q [B, 1, H, D] "
            "with H / Hkv <= 8, bf16 k_new / v_new [B, 1, Hkv, D], and writes "
            f"bf16; got q {q.dtype} {tuple(q.shape)} on {q.device}, k_new "
            f"{k_new.dtype} {tuple(k_new.shape)}, out {out_dtype}")
    q3 = q.contiguous()
    kn, vn = k_new.contiguous(), v_new.contiguous()
    pos32 = pos.to(torch.int32).contiguous()
    lens32 = kv_lens.to(torch.int32).contiguous()
    splits = -(-(n_blocks * ps) // DECODE_CHUNK)
    part_m = torch.empty((b, h, splits), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, h, splits, d), dtype=torch.float32, device=dev)
    out = torch.empty((b, 1, h, d), dtype=torch.bfloat16, device=dev)
    fn = _build.kernels.fn("flash_decode", "nst_flash_decode_paged", 14, 10,
                           1)
    code = fn(q3.data_ptr(), kn.data_ptr(), vn.data_ptr(), kp.data_ptr(),
              vp.data_ptr(), ks.data_ptr(), vs.data_ptr(), tables.data_ptr(),
              pos32.data_ptr(), lens32.data_ptr(), part_m.data_ptr(),
              part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(), b, h,
              hkv, n_pages, ps, n_blocks, d, layer, DECODE_CHUNK,
              int(fused_append), float(scale), _build.stream_handle())
    _build.check(code, "flash_decode_paged")
    _build.launches["flash_decode_paged"] += 1
    return out


def prefill_paged_cuda(q, kp, vp, ks, vs, tables, layer, q_positions,
                       kv_lens, scale, out_dtype) -> torch.Tensor:
    """The paged prefill kernel (paged twin of kernel C).  Shapes as
    `prefill_paged_plain`."""
    b, t, h, d = q.shape
    hkv, n_pages, ps = kp.shape[1], kp.shape[2], kp.shape[3]
    n_blocks = tables.shape[1]
    _check_pool(kp, vp, ks, vs, tables, layer, q_positions, kv_lens, q)
    if not (q.is_cuda and q_positions.shape == (b, t) and h % hkv == 0
            and q.dtype == out_dtype == torch.bfloat16):
        raise ValueError(
            f"the paged prefill kernel takes CUDA tensors: bf16 q "
            f"[B, T, H, D] with H a multiple of Hkv and positions [B, T], "
            f"and writes bf16; got q {q.dtype} {tuple(q.shape)} on "
            f"{q.device}, Hkv {hkv}, positions {tuple(q_positions.shape)}, "
            f"out {out_dtype}")
    q4 = q.contiguous()
    pos32 = q_positions.to(torch.int32).contiguous()
    lens32 = kv_lens.to(torch.int32).contiguous()
    out = torch.empty((b, t, h, d), dtype=torch.bfloat16, device=q.device)
    fn = _build.kernels.fn("flash_prefill", "nst_flash_prefill_paged", 9, 9,
                           1)
    code = fn(q4.data_ptr(), kp.data_ptr(), vp.data_ptr(), ks.data_ptr(),
              vs.data_ptr(), tables.data_ptr(), pos32.data_ptr(),
              lens32.data_ptr(), out.data_ptr(), b, t, h, hkv, n_pages, ps,
              n_blocks, d, layer, float(scale), _build.stream_handle())
    _build.check(code, "flash_prefill_paged")
    _build.launches["flash_prefill_paged"] += 1
    return out


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        k_scale: torch.Tensor, v_scale: torch.Tensor,
        q_positions: torch.Tensor, kv_lens: torch.Tensor, *, scale: float,
        causal: bool = True, alibi=None, logit_softcap: float = 0.0,
        out_dtype=None, layer: int, extra_kv=None,
        fused_append: bool = False):
    """Flash attention over the int8 cache.  Returns the output
    `[B, T, H, D]`, or `(out, (k, v, k_scale, v_scale))` with
    `fused_append` — the cache tensors are written in place and returned
    for the JAX interface's sake.  Returns None where the JAX entry does
    (extra_kv that the decode kernel cannot take)."""
    if not causal or alibi is not None or logit_softcap:
        raise NotImplementedError("only causal attention without ALiBi or "
                                  "softcap is ported")
    if k_scale is None:
        raise NotImplementedError("only the int8 KV cache is ported")
    b, t, h, d = q.shape
    hkv = k.shape[2]
    out_dtype = out_dtype or q.dtype
    if extra_kv is not None and not extra_kv_eligible(t, h, hkv):
        return None
    if fused_append and extra_kv is None:
        return None
    if extra_kv is not None:
        args = (q, extra_kv[0], extra_kv[1], k, v, k_scale, v_scale, layer,
                q_positions[:, 0], kv_lens, scale, fused_append, out_dtype)
        if q.device.type == "cpu":
            _build.plain_dispatches["flash_decode"] += 1
            out = decode_plain(*args)
        else:
            out = decode_cuda(*args)
    else:
        args = (q, k, v, k_scale, v_scale, layer, q_positions, kv_lens,
                scale, out_dtype)
        if q.device.type == "cpu":
            _build.plain_dispatches["flash_prefill"] += 1
            out = prefill_plain(*args)
        else:
            out = prefill_cuda(*args)
    if fused_append:
        return out, (k, v, k_scale, v_scale)
    return out


def mha_paged(q: torch.Tensor, cache, layer: int, q_positions: torch.Tensor,
              kv_lens: torch.Tensor, *, scale: float, causal: bool = True,
              alibi=None, logit_softcap: float = 0.0, out_dtype=None,
              extra_kv=None, fused_append: bool = False):
    """Flash attention over one layer of a `PagedKVCache`.  extra_kv (one
    token per slot) goes to the paged decode kernel, which with
    `fused_append` also writes the live slots' quantized rows through the
    table; everything else to the paged prefill kernel.  Returns the output
    `[B, T, H, D]`, or `(out, (k_pages, v_pages, k_scale, v_scale))` with
    `fused_append` (the pool written in place), or None where the JAX entry
    does (extra_kv the decode kernel cannot take).  Unlike the JAX entry,
    which leaves page sizes that are not a multiple of 128 to XLA, the
    kernels take any multiple of 16 and raise otherwise."""
    if not causal or alibi is not None or logit_softcap:
        raise NotImplementedError("only causal attention without ALiBi or "
                                  "softcap is ported")
    if not cache.quantized:
        raise NotImplementedError("only the int8 paged pool is ported")
    b, t, h, d = q.shape
    out_dtype = out_dtype or q.dtype
    if extra_kv is not None and not extra_kv_eligible(t, h, cache.kv_heads):
        return None
    if fused_append and extra_kv is None:
        return None
    pool = (cache.k_pages, cache.v_pages, cache.k_scale, cache.v_scale,
            cache.page_tables)
    if extra_kv is not None:
        args = (q, extra_kv[0], extra_kv[1], *pool, layer, q_positions[:, 0],
                kv_lens, scale, fused_append, out_dtype)
        if q.device.type == "cpu":
            _build.plain_dispatches["flash_decode_paged"] += 1
            out = decode_paged_plain(*args)
        else:
            out = decode_paged_cuda(*args)
    else:
        args = (q, *pool, layer, q_positions, kv_lens, scale, out_dtype)
        if q.device.type == "cpu":
            _build.plain_dispatches["flash_prefill_paged"] += 1
            out = prefill_paged_plain(*args)
        else:
            out = prefill_paged_cuda(*args)
    if fused_append:
        return out, pool[:4]
    return out
