"""Flash attention over the KV cache (port of `neural_speed_tpu/ops/flash.py`).

`mha` is the entry, with the JAX package's interface: q `[B, T, H, D]`, the
stacked cache `[L, B, Hkv, S, D]` with `layer` (int8 codes with
per-(token, head) bf16 or float32 scales, or bf16 / float32 values with
`k_scale=None`), absolute query positions, per-slot kv lengths, optional
ALiBi slopes `[H]` and grok's logit softcap.  Routes, as the JAX
launcher's:

* decode with the current token's k/v as extra operands (`extra_kv`, over
  the int8 cache), and bf16 / float32 decode after the plain append, each
  for one token per slot with at most 8 query heads per KV head and an
  even KV head count: kernel B (`csrc/flash_decode.cuh`), which with
  `fused_append` also writes the quantized new row in place; under the
  int8 score dot also the calls of several tokens per slot that `int8_dot`
  names;
* decode of one token per slot that B cannot take, with more query heads
  per KV head or an odd KV head count (Falcon-7B's 71 over 1, Gemma-2B's
  8 over 1, 12 over 3; up to `ROWS_MAX_REP`): the rows decode body
  (`csrc/flash_rows.cuh`), which packs a KV head's query heads as the rows
  of one MMA tile, splits the columns into chunks across blocks and merges
  them in a second kernel.  Here the port departs from the JAX launcher,
  which runs these calls through the prefill body: only the body differs
  (and with it the order of the float32 sums); the function, its rounding
  points and the plain version (`prefill_plain` at T = 1) are kernel C's;
* everything else (prefill chunks; int8 decode after a plain append that
  B could take): kernel C (`csrc/flash_prefill.cuh`).
  `decode_body` names the route of a call.

`mha_paged` is the same over one layer of the paged pool (`paged_kv.py`):
the paged twins of kernels B, C and the rows body (`nst_flash_decode_paged`,
`nst_flash_prefill_paged`, `nst_flash_rows_paged`) resolve every cache row
through the slot's page table and otherwise do the same arithmetic in the
same order, so at equal logical contents they give the contiguous
kernels' outputs bit for bit.

CUDA tensors launch the kernel or raise; CPU tensors run the plain
versions below, which repeat each kernel's rounding points: q and
`P * v_scale` (P over bf16 V) are rounded to bf16, the scores and sums are
float32, and a row with no valid column gives 0.  Each score is formed in
the JAX kernels' order: `(q . k) * k_scale * scale`, then the softcap
`softcap * tanh(s / softcap)` (IEEE division, `tanhf`; 0 = off), then the
ALiBi bias `slope * (col - pos)`, then the mask; the decode seed column
(the current token's own k) takes the softcap too.  The port has no GQA row
packing: the kernels read q and write the output in the natural
`[B, T, H, D]` layout.  K/V are int8 codes with bf16 or float32 scales,
or bf16 or float32 values without scales; the kernels and the plain versions round
float32 K and V to bf16 before both products, as the JAX kernels'
`astype(bfloat16)` does.  Head dims: 64, 80, 96, 128 and 256 have kernel
instances of their own; every other multiple of 8 up to 256 (the JAX
kernels' rule, `_head_dim_ok`) runs through the smallest instance above
it with the columns past D masked; other head dims raise.  `causal=False`
(whisper's encoder and cross attention) drops the `col <= pos` test: every
column below the slot's length is valid.  q may be bf16 or float32 (the
launchers round it to bf16, as the JAX launcher's `astype(bfloat16)`), and
the output bf16 or float32 (`out_dtype`: the kernels store the float32
result unrounded, as the JAX kernels store `o_ref.dtype`).  Launches are
counted per kernel, element type (`_SUFFIX`; int8 codes with float32
scales "_f32scale"), softcap ("_softcap") and mask ("_noncausal"), so a
run can show which variant ran.

`NST_FLASH_INT8=qk` (read once, at import, into `FLASH_INT8_DOT`, as the
JAX package's flag) turns on the int8 score dot of the JAX decode body
(`neural_speed_tpu/ops/flash.py:464-479`): each q row is quantized to
int8 codes with a per-row scale `max(max|q|, 1e-6) / 127` (IEEE division,
round half to even, clipped to +-127), the score is the exact int32 dot
of those codes with the K codes, times the q scale, then the K scale and
the softmax scale.  It runs where the JAX package's head-blocked Pallas
body runs it and nowhere else (`int8_dot`); there kernels B and 10 take
it as a compile-time variant of their int8 split kernels, counted with a
`_qk` suffix, and their plain versions take it too.  Over the contiguous
cache that body also takes t tokens per slot (t * n_rep <= 8, no extra
column: speculative decoding's verify steps), and so does kernel B,
counted `_qk_multi`, each row of a KV head (rep-major, row rep * t + ti)
masked and ALiBi-biased by its own position.
"""

from __future__ import annotations

import os

import torch

from .. import _build
from .kv_cache import quantize_kv
from .matmul import _sm_count
from .paged_kv import gather_layer_codes, physical_rows, write_pool_rows

# The split decode bodies (kernels B and 10, csrc/flash_decode.cuh, and the
# rows body, csrc/flash_rows.cuh) split the columns into chunks of whole
# tiles, enough of them for SPLIT_WAVES waves of the card's SMs where the
# columns allow (`split_columns`).
SPLIT_WAVES = 2
# Kernels B and 10: a warp walks DECODE_STEP columns a step, a block's warps
# a step together; splits of whole DECODE_TILE tiles (rows of up to a tile
# stay in one split, where P is rounded against their largest score), at
# most DECODE_MAX_SPLITS.
DECODE_STEP = 16
DECODE_TILE = 128
DECODE_MAX_SPLITS = 256
# The decode body of the MQA / odd-KV-head calls: column tiles of
# ROWS_TILE, and at most ROWS_MAX_REP query heads per KV head (eight row
# warps of 16; four at the 256 instance, whose tiles fill shared memory).
ROWS_TILE = 32
ROWS_WAVES = SPLIT_WAVES
ROWS_MAX_REP = {64: 128, 80: 128, 96: 128, 128: 128, 256: 64}
# Head dims with a kernel instance of their own (libraries per dim:
# csrc/flash_decode_d<D>.cu, flash_decode_paged_d<D>.cu,
# flash_prefill_d<D>.cu, flash_prefill_paged_d<D>.cu).
HEAD_DIMS = (64, 80, 96, 128, 256)
# Kernels C and 9 (csrc/flash_prefill.cuh): a block's (query rows, cache
# columns) per head-dim instance, and the call length up to which a block
# takes one consumer warpgroup (64 rows) instead.
PREFILL_TILES = {64: (128, 64), 80: (128, 64), 96: (128, 64),
                 128: (128, 64), 256: (64, 64)}
PREFILL_FEW_ROWS = 64


def prefill_tile(t: int, d: int) -> tuple:
    """The (rows, columns) tile of a block of kernel C / 9 for a call of
    `t` tokens per slot at head dim `d`."""
    rows, cols = PREFILL_TILES[instance_dim(d)]
    return (64 if t <= PREFILL_FEW_ROWS else rows), cols


# Counter suffix of each cache element type (int8 codes by their scales'
# dtype), and its code for the C entries.
_SUFFIX = {torch.int8: "", torch.bfloat16: "_bf16", torch.float32: "_f32"}
_SCALED = {torch.bfloat16: "", torch.float32: "_f32scale"}
_KV_TYPE = {"": 0, "_bf16": 1, "_f32": 2, "_f32scale": 3}
_SOFTCAP = "_softcap"
_NONCAUSAL = "_noncausal"
_QK = "_qk"
_MULTI = "_multi"     # kernel B over several tokens per slot (int8 dot)
# Output dtypes the kernels write, and q dtypes the launchers take.
_OUT_DTYPES = (torch.bfloat16, torch.float32)
# The int8 score dot in the decode kernels (NST_FLASH_INT8=qk), read once
# at import as the JAX package's FLASH_INT8_DOT.
FLASH_INT8_DOT = os.environ.get("NST_FLASH_INT8", "off") == "qk"


def extra_kv_eligible(t: int, n_heads: int, n_kv_heads: int) -> bool:
    """When the decode kernel's extra-kv column engages, and where a decode
    call goes to kernel B at all: one token per slot, at most 8 query heads
    per KV head and an even KV head count (the JAX rule `t * n_rep <= 8`
    with a head block of 2 or more, at t == 1)."""
    return t == 1 and n_heads // n_kv_heads <= 8 and n_kv_heads % 2 == 0


def decode_body(t: int, n_heads: int, n_kv_heads: int, d: int, *,
                extra: bool = False, qk: bool = False,
                quantized: bool = False) -> str:
    """Which kernel a call of `mha` or `mha_paged` takes (the same rule
    over the contiguous cache and the pool):
    "B" (kernel B or its paged twin 10: the extra column, the int8 score
    dot, or decode over values with at most 8 query heads per KV head and
    an even KV head count), "rows" (the decode body of
    csrc/flash_rows.cuh: one token per slot that B / 10 cannot take, more
    than 8 query heads per KV head or an odd KV head count, up to
    ROWS_MAX_REP of them), or "C" (kernel C or its paged twin 9: prefill,
    int8 decode after a plain append that B could take, and the rest).
    The JAX launcher sends the "rows" calls to the body of C; the function
    computed is the same."""
    if extra or qk or (not quantized and extra_kv_eligible(t, n_heads,
                                                           n_kv_heads)):
        return "B"
    if (t == 1 and not extra_kv_eligible(t, n_heads, n_kv_heads)
            and n_heads // n_kv_heads <= ROWS_MAX_REP[instance_dim(d)]):
        return "rows"
    return "C"


def split_columns(b: int, n_kv_heads: int, s: int, n_sm: int, tile: int,
                  max_splits: int = 0) -> tuple:
    """(chunk, chunks) of a split decode body over a cache of `s` columns
    for `b` slots: chunks of whole `tile`-column tiles, as many as
    b * Hkv * chunks >= SPLIT_WAVES * n_sm asks for and the columns allow,
    at most `max_splits` (0: no cap); chunk * chunks >= s.  The host cannot
    read the slots' lengths without a sync, so the count depends on `s`
    only: blocks past a slot's column end exit at once."""
    tiles = max(1, -(-s // tile))
    want = max(1, -(-SPLIT_WAVES * n_sm // (b * n_kv_heads)))
    per = max(1, tiles // want)
    if max_splits:
        per = max(per, -(-tiles // max_splits))
    chunk = per * tile
    return chunk, -(-s // chunk)


def rows_chunking(b: int, n_kv_heads: int, s: int, n_sm: int) -> tuple:
    """(chunk, chunks) of the rows body: `split_columns` over ROWS_TILE."""
    return split_columns(b, n_kv_heads, s, n_sm, ROWS_TILE)


def int8_dot(t: int, n_heads: int, n_kv_heads: int, d: int,
             quantized: bool, *, s=None, page_size=None,
             extra: bool = False) -> bool:
    """Whether a call runs the int8 score dot (`FLASH_INT8_DOT`): where the
    JAX package's head-blocked Pallas body `_mha_kernel_hblk` runs, over an
    int8 cache, and nowhere else.
    * A head dim the JAX kernels take (`_head_dim_ok`, flash.py:82).
    * Contiguous cache (`s`, its rows): S % 128 == 0 (`_supported`,
      flash.py:96) and the head-blocked launcher, t * n_rep <= 8 with an
      even KV head count (`rp <= 8 and hb > 1`, flash.py:732), with or
      without the extra column.
    * Page pool (`page_size`): the extra column (`extra_kv_eligible`) and
      page_size % 128 == 0 (`mha_paged`, flash.py:1371-1376, 1402); the
      pool's other calls go to the body of row 9, which has no int8 dot.
    Elsewhere the JAX package runs XLA or another body, without it."""
    if not (FLASH_INT8_DOT and quantized and d % 8 == 0 and 8 <= d <= 256):
        return False
    hblk = t * (n_heads // n_kv_heads) <= 8 and n_kv_heads % 2 == 0
    if page_size is None:
        return hblk and s % 128 == 0
    return extra and hblk and page_size % 128 == 0


def instance_dim(d: int) -> int:
    """The kernel instance that runs head dim `d`: the smallest of
    HEAD_DIMS at or above it, which masks the columns past `d`.  Raises
    for head dims that the JAX kernels do not take either."""
    if d % 8 or not 8 <= d <= 256:
        raise ValueError(
            f"head_dim {d}: the attention kernels take multiples of 8 up to "
            f"256, as the JAX package's (neural_speed_tpu/ops/flash.py::"
            f"_head_dim_ok)")
    return next(i for i in HEAD_DIMS if i >= d)


def _check_variant(logit_softcap: float) -> None:
    if not logit_softcap >= 0.0:
        raise ValueError(f"logit_softcap must be >= 0 (0 is off), got "
                         f"{logit_softcap}")


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _softmax_pv(sc: torch.Tensor, valid: torch.Tensor, vsc, vf: torch.Tensor,
                s0=None, valid0=None, v0=None):
    """Exact-max softmax with the kernels' rounding points.  sc/valid:
    [..., R, S]; vsc: V scales [..., 1, S] or None (bf16 V); vf: [..., S, D];
    optional seed column s0/valid0 [..., R] with value row v0 [..., 1, D].
    Returns acc, l."""
    neg = sc.new_full((), float("-inf"))    # a fill: no host-device copy
    m = torch.where(valid, sc, neg).amax(dim=-1)
    if s0 is not None:
        m = torch.maximum(m, torch.where(valid0, s0, neg))
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.where(valid, torch.exp(sc - m[..., None]), torch.zeros_like(sc))
    l = p.sum(dim=-1)
    pw = (p if vsc is None else p * vsc).to(torch.bfloat16).float()
    acc = pw @ vf
    if s0 is not None:
        p0 = torch.where(valid0, torch.exp(s0 - m), torch.zeros_like(s0))
        l = l + p0
        acc = acc + p0[..., None] * v0
    return acc, l


def _normalize(acc: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    inv = torch.where(l == 0, torch.zeros_like(l), 1.0 / l)
    return acc * inv[..., None]


def _kv_values(x: torch.Tensor) -> torch.Tensor:
    """Cache rows in float32 as the kernels read them: float32 K/V rounded
    to bf16 first (the JAX kernels' `astype(bfloat16)` before both
    products), int8 codes and bf16 values exactly."""
    if x.dtype == torch.float32:
        x = x.to(torch.bfloat16)
    return x.float()


def _softcap(s: torch.Tensor, softcap: float) -> torch.Tensor:
    """softcap * tanh(s / softcap), or s when softcap is 0.  Divided by a
    tensor: CUDA's division by a Python scalar multiplies by the
    reciprocal, and the kernels divide."""
    if not softcap:
        return s
    return softcap * torch.tanh(s / s.new_full((), softcap))


def _scores(qf: torch.Tensor, kf: torch.Tensor, ks, scale: float,
            softcap: float = 0.0) -> torch.Tensor:
    """(bf16(q) . k) * k_scale * scale, then the softcap, in the kernels'
    order; ks [..., S] or None (K values)."""
    sc = qf.to(torch.bfloat16).float() @ kf.transpose(-1, -2)
    if ks is not None:
        sc = sc * ks[..., None, :]
    return _softcap(sc * scale, softcap)


def _scores_qk(qf: torch.Tensor, kf: torch.Tensor, ks: torch.Tensor,
               scale: float, softcap: float = 0.0) -> torch.Tensor:
    """The int8 score dot (flash.py:464-479): each bf16(q) row quantized
    to int8 codes with the scale max(max|q|, 1e-6) / 127 (IEEE division,
    round half to even, clipped to +-127), the dot with the K codes, times
    the q scale, the K scale and the softmax scale, then the softcap.  The
    dot of int8 codes is exact in float32 (|sum| <= 127 * 127 * 256 <
    2**24), as the kernels' int32 sum."""
    qb = qf.to(torch.bfloat16).float()
    amax = qb.abs().amax(dim=-1, keepdim=True)
    qsc = torch.maximum(amax, amax.new_full((), 1e-6)) / amax.new_full(
        (), 127.0)
    qi = torch.clamp(torch.round(qb / qsc), -127.0, 127.0)
    sc = (qi @ kf.transpose(-1, -2)) * qsc
    sc = sc * ks[..., None, :]
    return _softcap(sc * scale, softcap)


def decode_plain(q: torch.Tensor, k_new, v_new, k: torch.Tensor,
                 v: torch.Tensor, ks, vs, layer: int, pos: torch.Tensor,
                 kv_lens: torch.Tensor, scale: float, fused_append: bool,
                 out_dtype, alibi=None, softcap: float = 0.0,
                 causal: bool = True, qk: bool = False) -> torch.Tensor:
    """Plain version of kernel B.  q [B, T, H, D] (rounded to bf16 first);
    k/v/ks/vs the stacked cache (ks/vs None for bf16 or float32 K/V); pos
    [B] (T = 1) or [B, T]; alibi: slopes [H] or None; softcap: 0 (off) or
    the logit softcap.  With k_new/v_new [B, 1, Hkv, D] (int8 cache only,
    T = 1) the current token is the seed column and the cache is read
    below kv_len - 1 for live slots; `fused_append` also writes its
    quantized row in place (the scales in the cache's scale dtype).
    Without them the cache is read below kv_len.  Causal: only columns
    c <= the row's position.  `qk` (int8 cache only): the cache columns'
    scores by the int8 score dot (`_scores_qk`); the seed column keeps the
    float product.  The T * n_rep rows of a KV head are ordered rep-major
    (row rep * T + ti: head hk * n_rep + rep at token ti), as the JAX
    launcher packs them; each row has its own position."""
    if qk and ks is None:
        raise ValueError("the int8 score dot (qk) reads the int8 cache only")
    q = q.to(torch.bfloat16)
    b, t, h, d = q.shape
    hkv, s = k.shape[2], k.shape[3]
    n_rep = h // hkv
    extra = k_new is not None
    if extra and t != 1:
        raise ValueError("the extra column takes one token per slot")
    prow = (pos[:, None] if pos.dim() == 1 else pos).repeat(1, n_rep)
    pos = prow[:, 0]                                          # [B] at T = 1
    ok = pos == kv_lens - 1
    kvl_cache = kv_lens - ok.to(kv_lens.dtype) if extra else kv_lens
    qg = q.reshape(b, t, hkv, n_rep, d).permute(0, 2, 3, 1, 4).reshape(
        b, hkv, n_rep * t, d)                                 # rep-major
    kf, vf = _kv_values(k[layer]), _kv_values(v[layer])      # [B,Hkv,S,D]
    score = _scores_qk if qk else _scores
    sc = score(qg, kf, None if ks is None else ks[layer].float(), scale,
               softcap)                                       # [B,Hkv,R,S]
    col = torch.arange(s, device=q.device)
    if alibi is not None:
        dist = col.float()[None, None] - prow.float()[:, :, None]  # [B,R,S]
        slope = alibi.float().reshape(hkv, n_rep, 1).expand(
            hkv, n_rep, t).reshape(1, hkv, n_rep * t, 1)
        sc = sc + slope * dist[:, None]
    valid = (col[None] < kvl_cache[:, None])[:, None]         # [B, 1, S]
    if causal:
        valid = valid & (col[None, None] <= prow[:, :, None])
    valid = valid[:, None].expand_as(sc)
    vsc = None if vs is None else vs[layer].float()[:, :, None, :]
    if not extra:
        acc, l = _softmax_pv(sc, valid, vsc, vf)
        out = _normalize(acc, l).reshape(b, hkv, n_rep, t, d)
        return out.permute(0, 3, 1, 2, 4).reshape(b, t, h, d).to(out_dtype)
    kn = k_new[:, 0].float()                                  # [B, Hkv, D]
    vn = v_new[:, 0].float()
    s0 = _softcap((qg.float() * kn[:, :, None, :]).sum(-1) * scale,
                  softcap)                                    # [B,Hkv,R]
    valid0 = (ok & (pos >= 0))[:, None, None].expand_as(s0)
    acc, l = _softmax_pv(sc, valid, vsc, vf, s0, valid0, vn[:, :, None, :])
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


def prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ks, vs,
                  layer: int, q_positions: torch.Tensor,
                  kv_lens: torch.Tensor, scale: float, out_dtype,
                  alibi=None, softcap: float = 0.0,
                  causal: bool = True) -> torch.Tensor:
    """Plain version of kernel C: q [B, T, H, D] over the stacked cache
    (ks/vs None for bf16 or float32 K/V); alibi: slopes [H] or None;
    softcap: 0 (off) or the logit softcap; causal: only columns
    c <= q_positions."""
    b, t, h, d = q.shape
    hkv, s = k.shape[2], k.shape[3]
    n_rep = h // hkv
    rep = lambda a: torch.repeat_interleave(a, n_rep, dim=1)
    kf = rep(_kv_values(k[layer]))                          # [B,H,S,D]
    vf = rep(_kv_values(v[layer]))
    qh = q.permute(0, 2, 1, 3)                              # [B,H,T,D]
    sc = _scores(qh, kf, None if ks is None else rep(ks[layer].float()),
                 scale, softcap)
    col = torch.arange(s, device=q.device)
    if alibi is not None:
        dist = col.float()[None, None] - q_positions.float()[:, :, None]
        sc = sc + alibi.float()[None, :, None, None] * dist[:, None]
    valid = (col[None, None] < kv_lens[:, None, None]).expand(b, t, s)
    if causal:
        valid = valid & (col[None, None] <= q_positions[:, :, None])
    valid = valid[:, None].expand_as(sc)                    # [B,H,T,S]
    vsc = None if vs is None else rep(vs[layer].float())[:, :, None, :]
    acc, l = _softmax_pv(sc, valid, vsc, vf)
    return _normalize(acc, l).permute(0, 2, 1, 3).to(out_dtype)


def _gathered_cache(k_pages, v_pages, ks, vs, tables, layer):
    """One pool layer gathered through the tables, as layer 0 of a stacked
    cache (scales None for a pool of values)."""
    return [None if a is None else a[None] for a in gather_layer_codes(
        k_pages, v_pages, ks, vs, tables, layer)]


def decode_paged_plain(q: torch.Tensor, k_new, v_new, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, ks, vs, tables: torch.Tensor,
                       layer: int, pos: torch.Tensor, kv_lens: torch.Tensor,
                       scale: float, fused_append: bool, out_dtype,
                       alibi=None, softcap: float = 0.0,
                       causal: bool = True, qk: bool = False) -> torch.Tensor:
    """Plain version of the paged decode kernel: `decode_plain` over the
    layer gathered through the tables; with `fused_append` the live slots'
    quantized rows go to the pool at table[b, (kv_len - 1) // ps]."""
    cache = _gathered_cache(k_pages, v_pages, ks, vs, tables, layer)
    out = decode_plain(q, k_new, v_new, *cache, 0, pos, kv_lens, scale,
                       False, out_dtype, alibi, softcap, causal, qk)
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
                        v_pages: torch.Tensor, ks, vs, tables: torch.Tensor,
                        layer: int, q_positions: torch.Tensor,
                        kv_lens: torch.Tensor, scale: float, out_dtype,
                        alibi=None, softcap: float = 0.0,
                        causal: bool = True) -> torch.Tensor:
    """Plain version of the paged prefill kernel: `prefill_plain` over the
    layer gathered through the tables."""
    cache = _gathered_cache(k_pages, v_pages, ks, vs, tables, layer)
    return prefill_plain(q, *cache, 0, q_positions, kv_lens, scale,
                         out_dtype, alibi, softcap, causal)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _kv_suffix(k, v, ks, vs):
    """The counter suffix of the cache's element type ('' for int8 codes
    with bf16 scales, '_f32scale' with float32 scales, '_bf16' / '_f32'
    for values without scales), or None for a cache that the kernels do
    not read."""
    if ks is None and vs is None:
        if k.dtype == v.dtype and k.dtype in (torch.bfloat16, torch.float32):
            return _SUFFIX[k.dtype]
        return None
    if (k.dtype == v.dtype == torch.int8 and ks is not None
            and vs is not None and ks.dtype == vs.dtype
            and ks.dtype in _SCALED):
        return _SCALED[ks.dtype]
    return None


def _quantized(suffix: str) -> bool:
    """Whether a cache suffix names int8 codes with scales."""
    return suffix in _SCALED.values()


def _counter(name: str, suffix: str, softcap: float, causal: bool,
             qk: bool = False) -> str:
    """The launch / dispatch counter of a kernel over a cache of `suffix`,
    with or without the softcap, causal or not, with or without the int8
    score dot."""
    return (name + suffix + (_SOFTCAP if softcap else "")
            + ("" if causal else _NONCAUSAL) + (_QK if qk else ""))


def _slopes(alibi, h: int, dev):
    """ALiBi slopes as a contiguous float32 [H] tensor on the card, or
    None."""
    if alibi is None:
        return None
    sl = alibi.to(torch.float32).contiguous()
    if sl.shape != (h,) or sl.device != dev:
        raise ValueError(f"ALiBi slopes must be [H] = ({h},) on {dev}; got "
                         f"{tuple(sl.shape)} on {sl.device}")
    return sl


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _check_cache(k, v, ks, vs, layer, pos, kv_lens, q) -> str:
    """The cache, positions and lengths the attention kernels index.
    Returns the cache's counter suffix."""
    b, t, _, d = q.shape
    instance_dim(d)                 # raises for a head dim no kernel takes
    suffix = _kv_suffix(k, v, ks, vs)
    ok = (suffix is not None and k.dim() == 5 and k.shape == v.shape
          and k.shape[1] == b and k.shape[4] == d
          and (not _quantized(suffix) or ks.shape == vs.shape == k.shape[:4])
          and 0 <= layer < k.shape[0]
          and all(a.device == q.device and a.is_contiguous()
                  for a in (k, v, ks, vs) if a is not None)
          and k.shape[3] % 64 == 0
          and pos.shape in ((b,), (b, t)) and kv_lens.shape == (b,)
          and pos.device == kv_lens.device == q.device)
    if not ok:
        raise ValueError(
            f"the attention kernels read a contiguous [L, B, Hkv, S, D] cache "
            f"of int8 codes with bf16 or float32 [L, B, Hkv, S] scales or of "
            f"bf16 or float32 values without scales, on q's device, S a "
            f"multiple of "
            f"64, a layer index below L and positions / kv_lens of the "
            f"batch; got q {tuple(q.shape)} on {q.device}, k {k.dtype} "
            f"{tuple(k.shape)} on {k.device}, v {v.dtype}, scales "
            f"{None if ks is None else (ks.dtype, tuple(ks.shape))}, layer "
            f"{layer}, positions {tuple(pos.shape)}, kv_lens "
            f"{tuple(kv_lens.shape)}")
    return suffix


def _check_decode(q, k_new, v_new, fused_append, out_dtype, hkv, suffix,
                  what: str, qk: bool = False, rows_ok: bool = False) -> None:
    """`rows_ok`: the kernel takes t > 1 tokens per slot (the int8 dot over
    the contiguous cache, without the extra column, t * n_rep <= 8)."""
    b, t, h, d = q.shape
    extra = k_new is not None
    if not (q.is_cuda and h % hkv == 0 and t * (h // hkv) <= 8
            and (t == 1 or (rows_ok and qk and not extra))
            and q.dtype in _OUT_DTYPES and out_dtype in _OUT_DTYPES
            and (not fused_append or extra)
            and (_quantized(suffix) or not (extra or qk))
            and (not extra or (k_new.dtype == v_new.dtype == torch.bfloat16
                               and k_new.shape == v_new.shape
                               == (b, 1, hkv, d)))):
        raise ValueError(
            f"{what} takes CUDA tensors: bf16 or float32 q [B, 1, H, D] with "
            f"H / Hkv <= 8 (q [B, T, H, D] with T * H / Hkv <= 8 for the "
            f"int8 dot without the extra column on the contiguous cache), "
            f"optional bf16 k_new / v_new [B, 1, Hkv, D] over "
            f"the int8 cache only (needed by fused_append), the int8 score "
            f"dot over the int8 cache only, and writes bf16 "
            f"or float32; got q "
            f"{q.dtype} {tuple(q.shape)} on {q.device}, k_new "
            f"{None if k_new is None else (k_new.dtype, tuple(k_new.shape))},"
            f" cache {'int8' if _quantized(suffix) else suffix[1:]}, "
            f"fused_append "
            f"{fused_append}, qk {qk}, out {out_dtype}")


def _check_prefill(q, q_positions, out_dtype, hkv, what: str) -> None:
    b, t, h, _ = q.shape
    if not (q.is_cuda and q_positions.shape == (b, t) and h % hkv == 0
            and q.dtype in _OUT_DTYPES and out_dtype in _OUT_DTYPES):
        raise ValueError(
            f"{what} takes CUDA tensors: bf16 or float32 q [B, T, H, D] with "
            f"H a multiple of Hkv and positions [B, T], and writes bf16 or "
            f"float32; got q "
            f"{q.dtype} {tuple(q.shape)} on {q.device}, Hkv {hkv}, positions "
            f"{tuple(q_positions.shape)}, out {out_dtype}")


def _launched(name: str, d: int, code: int) -> None:
    """Raise for a failed launch, else count it: per kernel, element type
    and softcap (`name`), and per head-dim instance."""
    di = instance_dim(d)
    _build.check(code, f"{name} (head dim {d}, instance {di})")
    _build.launches[name] += 1
    _build.instance_launches[f"{name} d{di}"] += 1


# Kernels B / 10's per-(slot, KV head) counters, per device: zeros, and
# left zero by every launch (the last block of a group resets its own), so
# a call needs no memset.  Calls on one stream share them; calls on two
# streams at once would not.
_COUNTERS = {}


def _decode_counters(dev, n: int) -> torch.Tensor:
    buf = _COUNTERS.get(dev)
    if buf is None or buf.numel() < n:
        buf = torch.zeros((max(n, 1024),), dtype=torch.int32, device=dev)
        _COUNTERS[dev] = buf
    return buf


def _decode_scratch(b, h, d, splits, dev, out_dtype, t: int = 1):
    part_m = torch.empty((b * t, h, splits), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b * t, h, splits, d), dtype=torch.float32,
                           device=dev)
    out = torch.empty((b, t, h, d), dtype=out_dtype, device=dev)
    return part_m, part_l, part_acc, out


def _flags(causal: bool, out_dtype) -> tuple:
    """The kernels' `causal` and `out_f32` int arguments."""
    return int(bool(causal)), int(out_dtype == torch.float32)


def decode_cuda(q, k_new, v_new, k, v, ks, vs, layer, pos, kv_lens, scale,
                fused_append, out_dtype, alibi=None, softcap: float = 0.0,
                causal: bool = True, qk: bool = False) -> torch.Tensor:
    """Kernel B: `flash_decode` over int8 K/V (`_f32scale` with float32
    scales), `flash_decode_bf16` / `flash_decode_f32` over values; each
    `_softcap` with a softcap, `_noncausal` without the mask, `_qk` with the
    int8 score dot (int8 K/V only), `_multi` over several tokens per slot
    (the int8 dot without the extra column; also counted per T in
    `_build.multi_launches`).  Shapes as `decode_plain`."""
    b, t, h, d = q.shape
    hkv, s = k.shape[2], k.shape[3]
    dev = q.device
    suffix = _check_cache(k, v, ks, vs, layer, pos, kv_lens, q)
    _check_decode(q, k_new, v_new, fused_append, out_dtype, hkv, suffix,
                  "kernel B", qk, rows_ok=True)
    extra = k_new is not None
    slopes = _slopes(alibi, h, dev)
    q3 = q.to(torch.bfloat16).contiguous()
    kn = k_new.contiguous() if extra else None
    vn = v_new.contiguous() if extra else None
    # [B] at t = 1, [B, t] above (a [B, 1] position at t = 1 as [B])
    pos32 = (pos.reshape(b) if t == 1 else pos).to(torch.int32).contiguous()
    lens32 = kv_lens.to(torch.int32).contiguous()
    chunk, splits = split_columns(b, hkv, s, _sm_count(dev.index or 0),
                                  DECODE_TILE, DECODE_MAX_SPLITS)
    part_m, part_l, part_acc, out = _decode_scratch(b, h, d, splits, dev,
                                                    out_dtype, t)
    counters = _decode_counters(dev, b * hkv)
    fn = _build.kernels.fn(f"flash_decode_d{instance_dim(d)}",
                           "nst_flash_decode", 15, 14, 2)
    code = fn(q3.data_ptr(), _ptr(kn), _ptr(vn), k.data_ptr(), v.data_ptr(),
              _ptr(ks), _ptr(vs), _ptr(slopes), pos32.data_ptr(),
              lens32.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
              part_acc.data_ptr(), counters.data_ptr(), out.data_ptr(), b, h,
              hkv, s, d, layer, chunk, int(extra), int(fused_append),
              _KV_TYPE[suffix],
              *_flags(causal, out_dtype), int(qk), t, float(scale),
              float(softcap), _build.stream_handle())
    name = _counter("flash_decode", suffix, softcap, causal, qk) + (
        _MULTI if t > 1 else "")
    _launched(name, d, code)
    if t > 1:
        _build.multi_launches[f"{name} t{t}"] += 1
    return out


def prefill_cuda(q, k, v, ks, vs, layer, q_positions, kv_lens, scale,
                 out_dtype, alibi=None, softcap: float = 0.0,
                 causal: bool = True) -> torch.Tensor:
    """Kernel C: `flash_prefill` over int8 K/V (`_f32scale` with float32
    scales), `flash_prefill_bf16` / `flash_prefill_f32` over values; each
    `_softcap` with a softcap, `_noncausal` without the mask.  Shapes as
    `prefill_plain`."""
    b, t, h, d = q.shape
    hkv, s = k.shape[2], k.shape[3]
    dev = q.device
    suffix = _check_cache(k, v, ks, vs, layer, q_positions, kv_lens, q)
    _check_prefill(q, q_positions, out_dtype, hkv, "kernel C")
    slopes = _slopes(alibi, h, dev)
    q4 = q.to(torch.bfloat16).contiguous()
    pos32 = q_positions.to(torch.int32).contiguous()
    lens32 = kv_lens.to(torch.int32).contiguous()
    out = torch.empty((b, t, h, d), dtype=out_dtype, device=dev)
    fn = _build.kernels.fn(f"flash_prefill_d{instance_dim(d)}",
                           "nst_flash_prefill", 9, 10, 2)
    code = fn(q4.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks), _ptr(vs),
              _ptr(slopes), pos32.data_ptr(), lens32.data_ptr(),
              out.data_ptr(), b, t, h, hkv, s, d, layer, _KV_TYPE[suffix],
              *_flags(causal, out_dtype), float(scale), float(softcap),
              _build.stream_handle())
    _launched(_counter("flash_prefill", suffix, softcap, causal), d, code)
    return out


def _rows_scratch(b, h, d, nch, dev, out_dtype):
    part_m = torch.empty((b, h, nch), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, h, nch, d), dtype=torch.float32, device=dev)
    out = torch.empty((b, 1, h, d), dtype=out_dtype, device=dev)
    return part_m, part_l, part_acc, out


def _check_rows(q, pos, hkv, out_dtype, what: str) -> None:
    b, t, h, d = q.shape
    if not (t == 1 and h % hkv == 0
            and h // hkv <= ROWS_MAX_REP[instance_dim(d)]):
        raise ValueError(
            f"{what} takes one token per slot and at most "
            f"{ROWS_MAX_REP[instance_dim(d)]} query heads per KV head at head "
            f"dim {d}; got q {tuple(q.shape)}, Hkv {hkv}")
    _check_prefill(q, pos, out_dtype, hkv, what)


def rows_cuda(q, k, v, ks, vs, layer, q_positions, kv_lens, scale,
              out_dtype, alibi=None, softcap: float = 0.0,
              causal: bool = True) -> torch.Tensor:
    """The decode body of csrc/flash_rows.cuh (kernel C's function at
    T = 1 for the calls B cannot take): `flash_rows` over int8 K/V
    (`_f32scale` with float32 scales), `flash_rows_bf16` / `flash_rows_f32`
    over values; each `_softcap` with a softcap, `_noncausal` without the
    mask.  Shapes as `prefill_plain` at T = 1."""
    b, t, h, d = q.shape
    hkv, s = k.shape[2], k.shape[3]
    dev = q.device
    suffix = _check_cache(k, v, ks, vs, layer, q_positions, kv_lens, q)
    _check_rows(q, q_positions, hkv, out_dtype, "the rows decode kernel")
    slopes = _slopes(alibi, h, dev)
    q4 = q.to(torch.bfloat16).contiguous()
    pos32 = q_positions.reshape(b).to(torch.int32).contiguous()
    lens32 = kv_lens.to(torch.int32).contiguous()
    chunk, nch = rows_chunking(b, hkv, s, _sm_count(dev.index or 0))
    part_m, part_l, part_acc, out = _rows_scratch(b, h, d, nch, dev,
                                                  out_dtype)
    fn = _build.kernels.fn(f"flash_rows_d{instance_dim(d)}",
                           "nst_flash_rows", 12, 11, 2)
    code = fn(q4.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(ks), _ptr(vs),
              _ptr(slopes), pos32.data_ptr(), lens32.data_ptr(),
              part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
              out.data_ptr(), b, h, hkv, s, d, layer, chunk, nch,
              _KV_TYPE[suffix], *_flags(causal, out_dtype), float(scale),
              float(softcap), _build.stream_handle())
    _launched(_counter("flash_rows", suffix, softcap, causal), d, code)
    return out


def _check_pool(kp, vp, ks, vs, tables, layer, pos, kv_lens, q) -> str:
    """The page pool, tables, positions and lengths the paged kernels
    index.  Returns the pool's counter suffix."""
    b, t, _, d = q.shape
    instance_dim(d)                 # raises for a head dim no kernel takes
    suffix = _kv_suffix(kp, vp, ks, vs)
    ok = (suffix is not None and kp.dim() == 5 and kp.shape == vp.shape
          and kp.shape[4] == d
          and (not _quantized(suffix) or ks.shape == vs.shape
               == kp.shape[:3] + (1, kp.shape[3]))
          and 0 <= layer < kp.shape[0] and kp.shape[3] % 16 == 0
          and tables.dim() == 2 and tables.shape[0] == b
          and tables.dtype == torch.int32
          and all(a.device == q.device and a.is_contiguous()
                  for a in (kp, vp, ks, vs, tables) if a is not None)
          and pos.shape in ((b,), (b, t)) and kv_lens.shape == (b,)
          and pos.device == kv_lens.device == q.device)
    if not ok:
        raise ValueError(
            f"the paged attention kernels read an [L, Hkv, P, ps, D] pool of "
            f"int8 codes with bf16 or float32 [L, Hkv, P, 1, ps] scales or of "
            f"bf16 or float32 values without scales, with a page size that "
            f"is a "
            f"multiple of 16, int32 page tables [B, n_blocks], all on q's "
            f"device, a layer index below L and positions / kv_lens of the "
            f"batch; got q {tuple(q.shape)} on {q.device}, pool {kp.dtype} "
            f"{tuple(kp.shape)} on {kp.device} (page size "
            f"{kp.shape[3] if kp.dim() == 5 else None}), scales "
            f"{None if ks is None else (ks.dtype, tuple(ks.shape))}, tables "
            f"{tables.dtype} {tuple(tables.shape)} on {tables.device}, layer "
            f"{layer}, positions {tuple(pos.shape)}, kv_lens "
            f"{tuple(kv_lens.shape)}")
    return suffix


def decode_paged_cuda(q, k_new, v_new, kp, vp, ks, vs, tables, layer, pos,
                      kv_lens, scale, fused_append, out_dtype,
                      alibi=None, softcap: float = 0.0,
                      causal: bool = True, qk: bool = False) -> torch.Tensor:
    """The paged decode kernel (paged twin of kernel B;
    `flash_decode_paged` and its `_f32scale` / `_bf16` / `_f32` element
    types, each `_softcap` with a softcap, `_noncausal` without the mask,
    `_qk` with the int8 score dot).  Shapes as `decode_paged_plain`."""
    b, t, h, d = q.shape
    hkv, n_pages, ps = kp.shape[1], kp.shape[2], kp.shape[3]
    n_blocks = tables.shape[1]
    dev = q.device
    suffix = _check_pool(kp, vp, ks, vs, tables, layer, pos, kv_lens, q)
    _check_decode(q, k_new, v_new, fused_append, out_dtype, hkv, suffix,
                  "the paged decode kernel", qk)
    extra = k_new is not None
    slopes = _slopes(alibi, h, dev)
    q3 = q.to(torch.bfloat16).contiguous()
    kn = k_new.contiguous() if extra else None
    vn = v_new.contiguous() if extra else None
    pos32 = pos.to(torch.int32).contiguous()
    lens32 = kv_lens.to(torch.int32).contiguous()
    chunk, splits = split_columns(b, hkv, n_blocks * ps,
                                  _sm_count(dev.index or 0), DECODE_TILE,
                                  DECODE_MAX_SPLITS)
    part_m, part_l, part_acc, out = _decode_scratch(b, h, d, splits, dev,
                                                    out_dtype)
    counters = _decode_counters(dev, b * hkv)
    fn = _build.kernels.fn(f"flash_decode_paged_d{instance_dim(d)}",
                           "nst_flash_decode_paged", 16, 15, 2)
    code = fn(q3.data_ptr(), _ptr(kn), _ptr(vn), kp.data_ptr(),
              vp.data_ptr(), _ptr(ks), _ptr(vs), _ptr(slopes),
              tables.data_ptr(), pos32.data_ptr(), lens32.data_ptr(),
              part_m.data_ptr(), part_l.data_ptr(), part_acc.data_ptr(),
              counters.data_ptr(), out.data_ptr(), b, h, hkv, n_pages, ps,
              n_blocks, d, layer, chunk, int(extra), int(fused_append),
              _KV_TYPE[suffix],
              *_flags(causal, out_dtype), int(qk), float(scale),
              float(softcap), _build.stream_handle())
    _launched(_counter("flash_decode_paged", suffix, softcap, causal, qk), d,
              code)
    return out


def prefill_paged_cuda(q, kp, vp, ks, vs, tables, layer, q_positions,
                       kv_lens, scale, out_dtype, alibi=None,
                       softcap: float = 0.0,
                       causal: bool = True) -> torch.Tensor:
    """The paged prefill kernel (paged twin of kernel C;
    `flash_prefill_paged` and its `_f32scale` / `_bf16` / `_f32` element
    types, each `_softcap` with a softcap, `_noncausal` without the mask).
    Shapes as `prefill_paged_plain`."""
    b, t, h, d = q.shape
    hkv, n_pages, ps = kp.shape[1], kp.shape[2], kp.shape[3]
    n_blocks = tables.shape[1]
    suffix = _check_pool(kp, vp, ks, vs, tables, layer, q_positions,
                         kv_lens, q)
    _check_prefill(q, q_positions, out_dtype, hkv, "the paged prefill kernel")
    slopes = _slopes(alibi, h, q.device)
    q4 = q.to(torch.bfloat16).contiguous()
    pos32 = q_positions.to(torch.int32).contiguous()
    lens32 = kv_lens.to(torch.int32).contiguous()
    out = torch.empty((b, t, h, d), dtype=out_dtype, device=q.device)
    fn = _build.kernels.fn(f"flash_prefill_paged_d{instance_dim(d)}",
                           "nst_flash_prefill_paged", 10, 12, 2)
    code = fn(q4.data_ptr(), kp.data_ptr(), vp.data_ptr(), _ptr(ks),
              _ptr(vs), _ptr(slopes), tables.data_ptr(), pos32.data_ptr(),
              lens32.data_ptr(), out.data_ptr(), b, t, h, hkv, n_pages, ps,
              n_blocks, d, layer, _KV_TYPE[suffix],
              *_flags(causal, out_dtype), float(scale), float(softcap),
              _build.stream_handle())
    _launched(_counter("flash_prefill_paged", suffix, softcap, causal), d,
              code)
    return out

def rows_paged_cuda(q, kp, vp, ks, vs, tables, layer, q_positions, kv_lens,
                    scale, out_dtype, alibi=None, softcap: float = 0.0,
                    causal: bool = True) -> torch.Tensor:
    """The paged twin of the rows decode body (`flash_rows_paged` and its
    `_f32scale` / `_bf16` / `_f32` element types, each `_softcap` with a
    softcap, `_noncausal` without the mask).  Shapes as
    `prefill_paged_plain` at T = 1."""
    b, t, h, d = q.shape
    hkv, n_pages, ps = kp.shape[1], kp.shape[2], kp.shape[3]
    n_blocks = tables.shape[1]
    dev = q.device
    suffix = _check_pool(kp, vp, ks, vs, tables, layer, q_positions,
                         kv_lens, q)
    _check_rows(q, q_positions, hkv, out_dtype,
                "the paged rows decode kernel")
    slopes = _slopes(alibi, h, dev)
    q4 = q.to(torch.bfloat16).contiguous()
    pos32 = q_positions.reshape(b).to(torch.int32).contiguous()
    lens32 = kv_lens.to(torch.int32).contiguous()
    chunk, nch = rows_chunking(b, hkv, n_blocks * ps,
                               _sm_count(dev.index or 0))
    part_m, part_l, part_acc, out = _rows_scratch(b, h, d, nch, dev,
                                                  out_dtype)
    fn = _build.kernels.fn(f"flash_rows_d{instance_dim(d)}",
                           "nst_flash_rows_paged", 13, 13, 2)
    code = fn(q4.data_ptr(), kp.data_ptr(), vp.data_ptr(), _ptr(ks),
              _ptr(vs), _ptr(slopes), tables.data_ptr(), pos32.data_ptr(),
              lens32.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
              part_acc.data_ptr(), out.data_ptr(), b, h, hkv, n_pages, ps,
              n_blocks, d, layer, chunk, nch, _KV_TYPE[suffix],
              *_flags(causal, out_dtype), float(scale), float(softcap),
              _build.stream_handle())
    _launched(_counter("flash_rows_paged", suffix, softcap, causal), d, code)
    return out


# ---------------------------------------------------------------------------
# entry
# ---------------------------------------------------------------------------


def _dispatch(q, cuda_fn, plain_fn, name: str, kv, args, alibi, softcap,
              causal, qk: bool = False, tail: str = ""):
    """CPU tensors run the plain version (counted per element type of the
    cache `kv` = (k, v, k_scale, v_scale), softcap, mask, int8 score dot
    and `tail`, as the kernels' launches), others the kernel.  `qk`
    reaches the decode kernels only."""
    kw = dict(alibi=alibi, softcap=softcap, causal=causal)
    if qk:
        kw["qk"] = True
    if q.device.type == "cpu":
        suffix = _kv_suffix(*kv)
        _build.plain_dispatches[_counter(
            name, "_other" if suffix is None else suffix, softcap,
            causal, qk) + tail] += 1
        return plain_fn(*args, **kw)
    return cuda_fn(*args, **kw)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, k_scale,
        v_scale, q_positions: torch.Tensor, kv_lens: torch.Tensor, *,
        scale: float, causal: bool = True, alibi=None,
        logit_softcap: float = 0.0, out_dtype=None, layer: int,
        extra_kv=None, fused_append: bool = False):
    """Flash attention over the stacked cache (int8 codes and bf16 or
    float32 scales, or bf16 / float32 values with `k_scale=None`), causal
    or not, with grok's `logit_softcap` (0 = off).  Returns the output
    `[B, T, H, D]`, or `(out, (k, v, k_scale, v_scale))` with
    `fused_append` — the cache tensors are written in place and returned
    for the JAX interface's sake.  Returns None where the JAX entry does
    (extra_kv that the decode kernel cannot take; `fused_append` without
    extra_kv or over K/V values).  Under `NST_FLASH_INT8=qk` (`int8_dot`)
    the int8 calls that the JAX package sends to its head-blocked decode
    body go to kernel B with the int8 score dot: one token per slot with or
    without the extra column, and t tokens per slot (t * n_rep <= 8, as
    speculative decoding's verify steps) without it, counted `_multi`."""
    _check_variant(logit_softcap)
    b, t, h, d = q.shape
    hkv = k.shape[2]
    out_dtype = out_dtype or q.dtype
    unscaled = k_scale is None
    if extra_kv is not None and (unscaled
                                 or not extra_kv_eligible(t, h, hkv)):
        return None
    if fused_append and extra_kv is None:
        return None
    qk = int8_dot(t, h, hkv, d, not unscaled, s=k.shape[3])
    body = decode_body(t, h, hkv, d, extra=extra_kv is not None, qk=qk,
                       quantized=not unscaled)
    if body == "B":
        # t > 1 only under qk (the extra column and bf16 decode take t = 1)
        kn, vn = extra_kv if extra_kv is not None else (None, None)
        args = (q, kn, vn, k, v, k_scale, v_scale, layer,
                q_positions[:, 0] if t == 1 else q_positions, kv_lens, scale,
                fused_append, out_dtype)
        out = _dispatch(q, decode_cuda, decode_plain, "flash_decode",
                        (k, v, k_scale, v_scale), args, alibi, logit_softcap,
                        causal, qk, _MULTI if t > 1 else "")
    else:
        args = (q, k, v, k_scale, v_scale, layer, q_positions, kv_lens,
                scale, out_dtype)
        cuda_fn, name = ((rows_cuda, "flash_rows") if body == "rows"
                         else (prefill_cuda, "flash_prefill"))
        out = _dispatch(q, cuda_fn, prefill_plain, name,
                        (k, v, k_scale, v_scale), args, alibi, logit_softcap,
                        causal)
    if fused_append:
        return out, (k, v, k_scale, v_scale)
    return out


def mha_paged(q: torch.Tensor, cache, layer: int, q_positions: torch.Tensor,
              kv_lens: torch.Tensor, *, scale: float, causal: bool = True,
              alibi=None, logit_softcap: float = 0.0, out_dtype=None,
              extra_kv=None, fused_append: bool = False):
    """Flash attention over one layer of a `PagedKVCache` (int8 codes with
    bf16 or float32 scales, bf16 or float32 values), causal or not, with
    grok's `logit_softcap` (0 = off).
    Decode calls go to the paged decode kernel, which over the int8 pool
    takes extra_kv (one token per slot) and with `fused_append` also writes
    the live slots' quantized rows through the table; everything else to
    the paged prefill kernel.  Returns the output `[B, T, H, D]`, or
    `(out, (k_pages, v_pages, k_scale, v_scale))` with `fused_append` (the
    pool written in place), or None where the JAX entry does (extra_kv the
    decode kernel cannot take).  Unlike the JAX entry, which leaves page
    sizes that are not a multiple of 128 to XLA, the kernels take any
    multiple of 16 and raise otherwise.  Under `NST_FLASH_INT8=qk`
    (`int8_dot`) the extra-column decode at page sizes that are multiples
    of 128 runs the int8 score dot."""
    _check_variant(logit_softcap)
    b, t, h, d = q.shape
    out_dtype = out_dtype or q.dtype
    unscaled = not cache.quantized
    eligible = extra_kv_eligible(t, h, cache.kv_heads)
    if extra_kv is not None and (unscaled or not eligible):
        return None
    if fused_append and extra_kv is None:
        return None
    pool = (cache.k_pages, cache.v_pages, cache.k_scale, cache.v_scale,
            cache.page_tables)
    qk = int8_dot(t, h, cache.kv_heads, d, not unscaled,
                  page_size=cache.page_size, extra=extra_kv is not None)
    body = decode_body(t, h, cache.kv_heads, d, extra=extra_kv is not None,
                       qk=qk, quantized=not unscaled)
    if body == "B":
        kn, vn = extra_kv if extra_kv is not None else (None, None)
        args = (q, kn, vn, *pool, layer, q_positions[:, 0], kv_lens, scale,
                fused_append, out_dtype)
        out = _dispatch(q, decode_paged_cuda, decode_paged_plain,
                        "flash_decode_paged", pool[:4], args, alibi,
                        logit_softcap, causal, qk)
    else:
        args = (q, *pool, layer, q_positions, kv_lens, scale, out_dtype)
        cuda_fn, name = ((rows_paged_cuda, "flash_rows_paged")
                         if body == "rows" else
                         (prefill_paged_cuda, "flash_prefill_paged"))
        out = _dispatch(q, cuda_fn, prefill_paged_plain, name, pool[:4],
                        args, alibi, logit_softcap, causal)
    if fused_append:
        return out, pool[:4]
    return out
