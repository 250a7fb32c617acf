"""Generation engine (port of `neural_speed_tpu/runtime/engine.py`: prefill,
decode and greedy generation over the KV cache — bf16 by default, int8 with
`kv_quantized=True`, as the JAX engines — `PagedEngine` over the paged
pool, and the serving steps that `runtime/scheduler.py`'s
`ContinuousBatchingScheduler` drives: `run_prefill`, `run_decode_chunk`,
`run_decode_window`, `supports_window`, which sends it to the window
path, and the joint steps' verify forwards `run_verify_rows` /
`run_verify_argmax`, over `runtime/speculative.py`).  StreamingLLM
eviction's settings (`n_keep`, `n_discard`, `shift_roped_k`,
`discard_count`) come with their reader, the scheduler's eviction (ROADMAP
section 1, item 6).

JAX's jitted steps with a donated cache become plain functions that write
the cache in place.  Prefill pads prompts to length buckets, as the JAX
package does, so the same shapes reach the kernels.  JAX's `lax.scan` and
`while_loop` over decode steps become Python loops over `forward`; the
tokens stay on the device, and the window loop reads one flag per step to
stop where JAX's loop condition does.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .._build import resolve_device
from ..models.arch import ArchConfig
from ..models.transformer import (COMP_MODES, forward, fuse_params,
                                  kv_append_mode)
from ..ops import kv_cache as kvc
from ..ops import paged_kv as pkv
from ..ops import sampling as smp


def pad_to_bucket(length: int, buckets: Tuple[int, ...]) -> int:
    """The padded prefill length (static-shape bucketing)."""
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


DEFAULT_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)


@torch.inference_mode()
def prefill_step(params: Dict[str, Any], cfg: ArchConfig, cache: kvc.KVCache,
                 token_ids: torch.Tensor, lengths: torch.Tensor,
                 start_pos: torch.Tensor, comp: Optional[str] = None
                 ) -> Tuple[torch.Tensor, kvc.KVCache]:
    """Evaluate a padded prompt chunk `[B, T]`; returns float32 logits at the
    last real token of each row `[B, vocab]` and the cache (written in
    place).  Slots with `lengths == 0` are untouched spectators.  Padding
    tokens take position `max_len - 1` (the trash slot)."""
    b, t = token_ids.shape
    dev = token_ids.device
    active = lengths > 0
    ar = torch.arange(t, device=dev)
    pos = start_pos[:, None] + ar[None, :]
    in_range = ar[None, :] < lengths[:, None]
    pos = torch.where(in_range, pos, torch.full_like(pos, cache.max_len - 1))
    kv_lens = torch.where(active, start_pos + lengths, cache.lengths)
    last = (lengths - 1).clamp(0, t - 1)
    logits, cache = forward(params, cfg, token_ids, pos, cache, kv_lens,
                            logits_positions=last[:, None], comp=comp)
    kvc.set_lengths(cache, kv_lens)
    return logits[:, 0], cache


@torch.inference_mode()
def decode_step(params: Dict[str, Any], cfg: ArchConfig, cache: kvc.KVCache,
                tokens: torch.Tensor, active: torch.Tensor,
                comp: Optional[str] = None
                ) -> Tuple[torch.Tensor, kvc.KVCache]:
    """One decode token for every active slot; logits `[B, vocab]`."""
    lens = cache.lengths
    pos = torch.where(active, lens, torch.full_like(lens, cache.max_len - 1))
    kv_lens = lens + active.to(torch.int32)
    logits, cache = forward(params, cfg, tokens[:, None], pos[:, None], cache,
                            kv_lens, comp=comp)
    kvc.set_lengths(cache, kv_lens)
    return logits[:, 0], cache


@torch.inference_mode()
def decode_n_steps(params: Dict[str, Any], cfg: ArchConfig,
                   cache: kvc.KVCache, tokens: torch.Tensor,
                   active: torch.Tensor, n_steps: int,
                   comp: Optional[str] = None
                   ) -> Tuple[torch.Tensor, kvc.KVCache]:
    """Greedy-decode `n_steps` tokens; the argmax stays on the device.
    Returns ids `[B, n_steps]`."""
    toks = []
    for _ in range(n_steps):
        logits, cache = decode_step(params, cfg, cache, tokens, active, comp)
        tokens = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(tokens)
    return torch.stack(toks, dim=1), cache


@torch.inference_mode()
def decode_sample_chunk(params: Dict[str, Any], cfg: ArchConfig, cache,
                        sampler: smp.SamplerState, tokens: torch.Tensor,
                        active: torch.Tensor, n_steps: int,
                        sp: smp.SamplingParams, comp: Optional[str] = None):
    """Decode and sample `n_steps` tokens for the active slots (inactive
    slots repeat their token).  Returns (tokens [B, n_steps], cache,
    sampler)."""
    toks, out = tokens.to(torch.int32), []
    for _ in range(n_steps):
        lens = cache.lengths
        pos = torch.where(active, lens,
                          torch.full_like(lens, cache.max_len - 1))
        kv_lens = lens + active.to(torch.int32)
        logits, cache = forward(params, cfg, toks[:, None], pos[:, None],
                                cache, kv_lens, comp=comp)
        kvc.set_lengths(cache, kv_lens)
        nxt, sampler = smp.sample(logits[:, 0], sampler, sp, active=active)
        toks = torch.where(active, nxt, toks)
        out.append(toks)
    return torch.stack(out, dim=1), cache, sampler


def decode_window(params: Dict[str, Any], cfg: ArchConfig, cache,
                  sampler: smp.SamplerState, tokens: torch.Tensor,
                  active: torch.Tensor, budget: torch.Tensor, n_steps: int,
                  cap: int, sp: smp.SamplingParams, eos_id: int,
                  comp: Optional[str] = None):
    """Decode and sample up to `n_steps` (<= cap) tokens with per-slot EOS
    and budget stops inside the loop (`run_window_loop`).  Returns
    (toks_buf [B, cap], emitted [B], last_tokens [B], active [B],
    budget [B], cache, sampler)."""
    def step_fn(cache, toks_2d, pos, kv_lens):
        return forward(params, cfg, toks_2d, pos, cache, kv_lens, comp=comp)

    return run_window_loop(step_fn, cache.max_len, cache, sampler, tokens,
                           active, budget, n_steps, cap, sp, eos_id)


@torch.inference_mode()
def run_window_loop(step_fn, max_len: int, cache, sampler, tokens, active,
                    budget, n_steps: int, cap: int, sp, eos_id: int):
    """The EOS-aware decode-window loop.  It runs while `i < n_steps` and
    any slot is active, exactly JAX's `while_loop` condition (one host read
    of that flag per step); each step writes column i of the buffer for
    every row, inactive rows included, as JAX's does.
    step_fn(cache, tokens [B, 1], pos [B, 1], kv_lens [B]) ->
    (logits [B, 1, V], cache)."""
    b = tokens.shape[0]
    dev = tokens.device
    toks = tokens.to(torch.int32)
    act = active.to(torch.bool)
    bud = budget.to(torch.int32)
    buf = torch.zeros((b, cap), dtype=torch.int32, device=dev)
    em = torch.zeros((b,), dtype=torch.int32, device=dev)
    i = 0
    while i < n_steps and bool(act.any()):
        lens = cache.lengths
        pos = torch.where(act, lens, torch.full_like(lens, max_len - 1))
        kv_lens = lens + act.to(torch.int32)
        logits, cache = step_fn(cache, toks[:, None], pos[:, None], kv_lens)
        kvc.set_lengths(cache, kv_lens)
        nxt, sampler = smp.sample(logits[:, 0], sampler, sp, active=act)
        nxt = torch.where(act, nxt, toks)
        buf[:, min(i, cap - 1)] = nxt       # JAX clamps the slice start
        step = act.to(torch.int32)
        em = em + step
        bud = bud - step
        done = (nxt == eos_id) | (bud <= 0)
        act = act & ~done
        toks = nxt
        i += 1
    return buf, em, toks, act, bud, cache, sampler


def _to_device(node, dev):
    if isinstance(node, dict):
        return {k: _to_device(v, dev) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_device(v, dev) for v in node]
    return node.to(dev) if hasattr(node, "to") else node


class Engine:
    """Owns params and the KV cache for one model instance, on `device` (the
    card unless the CPU is asked for).  The cache layout follows the JAX
    Engine's arguments: `kv_dtype` values (bf16 by default) or, with
    `kv_quantized=True`, int8 codes with bf16 scales, or float32 ones with
    `kv_scale_dtype=torch.float32` (None reads `NST_KV_SCALE_DTYPE` when
    the cache is built, as the JAX package).  A float32 cache
    (the JAX package's `memory_dtype="f32"`) runs through the attention
    kernels' float32 instances, which round K and V to bf16 as they read
    them, as the JAX kernels do.

    `comp` selects int8 compute for steps of at least 32 rows: None, "int8"
    (activation scales per token and K group) or "int8t" (per token).  The
    default "env" reads `NST_COMP` once, here, as the JAX package's switch."""

    def __init__(self, params: Dict[str, Any], cfg: ArchConfig,
                 max_batch: int = 1, max_len: int = 2048,
                 kv_dtype=torch.bfloat16, kv_quantized: bool = False,
                 buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
                 fuse: bool = True, device=None, comp: Optional[str] = "env",
                 kv_scale_dtype=None):
        self.device = resolve_device(device)
        self.kv_dtype = kv_dtype
        self.kv_quantized = kv_quantized
        self.kv_scale_dtype = kv_scale_dtype
        if comp == "env":
            comp = os.environ.get("NST_COMP")
            comp = comp if comp in ("int8", "int8t") else None
        if comp not in COMP_MODES:
            raise ValueError(f"comp must be one of {COMP_MODES}, got {comp!r}")
        self.comp = comp
        params = _to_device(params, self.device)
        if fuse:
            params = fuse_params(params, cfg)
        if cfg.kv_append == "env":
            cfg = dataclasses.replace(cfg, kv_append=kv_append_mode())
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.buckets = tuple(b for b in buckets if b <= max_len) or (max_len,)
        if self.buckets[-1] < max_len:
            self.buckets = self.buckets + (max_len,)
        self.cache = self.new_cache()

    # the EOS-aware decode window (run_decode_window): the scheduler takes
    # the window path on engines that have it, as in the JAX package
    supports_window = True

    def new_cache(self) -> kvc.KVCache:
        return kvc.init_cache(
            self.cfg.n_layers, self.max_batch, self.max_len,
            self.cfg.n_kv_heads, self.cfg.head_dim, self.kv_dtype,
            self.kv_quantized, device=self.device,
            scale_dtype=self.kv_scale_dtype)

    def prefill(self, prompts: List[List[int]]) -> torch.Tensor:
        """Prefill `prompts` into slots 0..B-1; returns last-token logits
        `[max_batch, vocab]`."""
        b = len(prompts)
        if b > self.max_batch:
            raise ValueError(f"{b} prompts for {self.max_batch} slots")
        t = pad_to_bucket(max(len(p) for p in prompts), self.buckets)
        ids = torch.zeros((self.max_batch, t), dtype=torch.int32)
        lens = torch.zeros((self.max_batch,), dtype=torch.int32)
        for i, p in enumerate(prompts):
            ids[i, :len(p)] = torch.tensor(p, dtype=torch.int32)
            lens[i] = len(p)
        zeros = torch.zeros((self.max_batch,), dtype=torch.int32,
                            device=self.device)
        kvc.set_lengths(self.cache, zeros)
        logits, self.cache = prefill_step(
            self.params, self.cfg, self.cache, ids.to(self.device),
            lens.to(self.device), zeros, self.comp)
        return logits

    def decode(self, tokens: torch.Tensor, active: torch.Tensor
               ) -> torch.Tensor:
        logits, self.cache = decode_step(self.params, self.cfg, self.cache,
                                         tokens.to(self.device),
                                         active.to(self.device), self.comp)
        return logits

    # -- the serving steps a continuous-batching scheduler drives ---------
    def run_prefill(self, ids: torch.Tensor, lens: torch.Tensor,
                    starts: torch.Tensor) -> torch.Tensor:
        """Padded prefill batch `[B, T]` from per-slot offsets `starts`;
        returns last-real-token logits `[B, V]`."""
        logits, self.cache = prefill_step(
            self.params, self.cfg, self.cache, ids.to(self.device),
            lens.to(self.device), starts.to(self.device), self.comp)
        return logits

    def run_decode_chunk(self, sampler: smp.SamplerState,
                         tokens: torch.Tensor, active: torch.Tensor,
                         chunk: int, sp: smp.SamplingParams):
        """`chunk` decode+sample steps; returns (tokens [B, chunk],
        sampler)."""
        toks, self.cache, sampler = decode_sample_chunk(
            self.params, self.cfg, self.cache, sampler,
            tokens.to(self.device), active.to(self.device), chunk, sp,
            self.comp)
        return toks, sampler

    def run_decode_window(self, sampler: smp.SamplerState, tokens, active,
                          budget, n_steps: int, cap: int,
                          sp: smp.SamplingParams, eos_id: Optional[int]):
        """Up to `n_steps` decode+sample steps with per-slot EOS / budget
        stops; returns (toks_buf [B, cap], emitted [B], last_tokens [B],
        active [B], budget [B], sampler)."""
        dev = self.device
        buf, em, toks, act, bud, self.cache, sampler = decode_window(
            self.params, self.cfg, self.cache, sampler,
            torch.as_tensor(tokens).to(dev), torch.as_tensor(active).to(dev),
            torch.as_tensor(budget).to(dev), int(n_steps), cap, sp,
            -1 if eos_id is None else int(eos_id), self.comp)
        return buf, em, toks, act, bud, sampler

    # -- the scheduler's joint steps (speculative / mixed prefill) ---------
    def _verify_args(self, *arrays):
        return [torch.as_tensor(np.ascontiguousarray(a)).to(self.device)
                for a in arrays]

    def run_verify_rows(self, ids, pos, kv_lens, row_idx) -> torch.Tensor:
        """Multi-token verify forward `[B, T]` at explicit positions and
        kv lengths; returns the logit rows `row_idx [B, R]`, `[B, R, V]`."""
        from .speculative import _verify_forward_rows

        rows, self.cache = _verify_forward_rows(
            self.params, self.cfg, self.cache,
            *self._verify_args(ids, pos, kv_lens, row_idx), comp=self.comp)
        return rows

    def run_verify_argmax(self, ids, pos, kv_lens) -> torch.Tensor:
        """The verify forward reduced to each position's argmax id
        `[B, T]`."""
        from .speculative import _verify_forward_argmax

        g, self.cache = _verify_forward_argmax(
            self.params, self.cfg, self.cache,
            *self._verify_args(ids, pos, kv_lens), comp=self.comp)
        return g

    def reorder_slots(self, src) -> None:
        raise NotImplementedError("beam search (reorder_slots) is not "
                                  "ported yet")

    def generate_greedy(self, prompt: List[int], max_new_tokens: int,
                        eos_id: Optional[int] = None) -> List[int]:
        """Single-sequence greedy decode (slot 0)."""
        logits = self.prefill([prompt])
        out = []
        tok = int(torch.argmax(logits[0]))
        active = torch.zeros((self.max_batch,), dtype=torch.bool)
        active[0] = True
        for _ in range(max_new_tokens):
            out.append(tok)
            if eos_id is not None and tok == eos_id:
                break
            logits = self.decode(
                torch.full((self.max_batch,), tok, dtype=torch.int32), active)
            tok = int(torch.argmax(logits[0]))
        return out


class PagedEngine(Engine):
    """Engine over the paged pool (`ops/paged_kv.py`; bf16 by default, int8
    with `kv_quantized=True`): memory follows
    the tokens in flight.  The engine owns the host-side `PageAllocator`:
    prefill reserves a contiguous page run per prompt, decode growth claims
    one page whenever a slot crosses a page boundary.  Windowed decode
    reserves the whole window per active slot (`prepare_decode`), and the
    scheduler snaps the host length mirror back to what was emitted
    (`commit_lens`); the overshoot pages stay mapped and free at
    `release_slot`.

    As in the JAX package, `prefill` reserves new runs without releasing a
    slot's old pages, so repeated `prefill` / `generate_greedy` calls on one
    engine leak pages; a caller that reuses slots calls `release_slot`
    first.  Prefix caching and beam forks (`reorder_slots`) are not ported
    yet."""

    def __init__(self, params: Dict[str, Any], cfg: ArchConfig,
                 max_batch: int = 1, max_len: int = 2048,
                 kv_dtype=torch.bfloat16, kv_quantized: bool = False,
                 buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
                 fuse: bool = True, n_pages: Optional[int] = None,
                 page_size: int = 128, prefix_cache: bool = False,
                 device=None, comp: Optional[str] = "env",
                 kv_scale_dtype=None):
        if prefix_cache:
            raise NotImplementedError("prefix caching is not ported yet")
        self.page_size = page_size
        # +1: the last physical page is the trash page that padding rows
        # and inactive slots write to; it is never allocated
        self.n_pages = (n_pages or (max_batch * max_len) // page_size) + 1
        self._alloc = pkv.PageAllocator(self.n_pages - 1)
        self._tables = np.zeros((max_batch, max_len // page_size), np.int32)
        self._lens = np.zeros((max_batch,), np.int64)
        # blocks actually mapped per slot: may exceed ceil(_lens / ps) after
        # commit_lens rolled a window back; freed at release_slot
        self._mapped = np.zeros((max_batch,), np.int64)
        super().__init__(params, cfg, max_batch, max_len, kv_dtype,
                         kv_quantized, buckets, fuse, device, comp,
                         kv_scale_dtype)

    def new_cache(self) -> pkv.PagedKVCache:
        return pkv.init_paged_cache(
            self.cfg.n_layers, self.max_batch, self.max_len,
            self.cfg.n_kv_heads, self.cfg.head_dim, self.n_pages,
            self.page_size, self.kv_dtype, self.kv_quantized,
            device=self.device, scale_dtype=self.kv_scale_dtype)

    def _sync_tables(self) -> None:
        """One host-to-device copy of the page tables."""
        self.cache.page_tables.copy_(torch.from_numpy(self._tables))

    def _ensure_pages(self, slot: int, new_len: int) -> None:
        """Claim the blocks past the slot's mapped high-water mark (a slot
        rolled back by commit_lens reuses its still-mapped pages)."""
        need = -(-new_len // self.page_size)
        for blk in range(int(self._mapped[slot]), need):
            page = self._alloc.alloc_page()
            if page is None:
                raise RuntimeError("paged KV pool exhausted")
            self._tables[slot, blk] = page
        self._mapped[slot] = max(self._mapped[slot], need)

    def prefill(self, prompts: List[List[int]]) -> torch.Tensor:
        b = len(prompts)
        if b > self.max_batch:
            raise ValueError(f"{b} prompts for {self.max_batch} slots")
        self.prepare_prefill(range(b), [len(p) for p in prompts])
        return super().prefill(prompts)

    def decode(self, tokens: torch.Tensor, active: torch.Tensor
               ) -> torch.Tensor:
        self.prepare_decode(np.asarray(torch.as_tensor(active).cpu()), 1)
        return super().decode(tokens, active)

    # -- scheduler hooks ------------------------------------------------
    def prepare_prefill(self, slots, lens, starts=None) -> None:
        """Reserve page runs and tables for prompts about to prefill."""
        ps = self.page_size
        for slot, ln in zip(slots, lens):
            start = 0 if starts is None else int(starts[slot])
            blk0 = start // ps
            n_blocks = -(-(start + int(ln)) // ps)
            run = n_blocks - blk0
            if run > 0:
                first = self._alloc.alloc_run(run)
                if first is None:
                    raise RuntimeError("paged KV pool exhausted (prefill)")
                self._tables[slot, blk0:n_blocks] = first + np.arange(run)
            self._lens[slot] = start + int(ln)
            self._mapped[slot] = max(int(self._mapped[slot]), n_blocks)
        self._sync_tables()

    def prepare_decode(self, active_np, chunk: int = 1) -> None:
        """Claim growth pages for the next `chunk` decode tokens."""
        for slot in np.nonzero(np.asarray(active_np))[0]:
            self._ensure_pages(int(slot), int(self._lens[slot]) + chunk)
            self._lens[slot] += chunk
        self._sync_tables()

    def prepare_rows(self, target_lens) -> None:
        """Reserve pages up to per-slot target lengths; provisional until
        commit_lens."""
        changed = False
        for slot, tgt in enumerate(target_lens):
            tgt = int(tgt)
            if tgt > int(self._lens[slot]):
                self._ensure_pages(slot, tgt)
                self._lens[slot] = tgt
                changed = True
        if changed:
            self._sync_tables()

    def commit_lens(self, lens) -> None:
        """Snap the host length mirror to the accepted lengths (pages stay
        mapped; see _ensure_pages)."""
        self._lens[:] = np.asarray(lens, np.int64)

    def release_slot(self, slot: int) -> None:
        """Free every mapped block of a finished slot."""
        n_blocks = int(self._mapped[slot])
        self._alloc.free_pages(self._tables[slot, :n_blocks].tolist())
        self._tables[slot, :n_blocks] = 0
        self._lens[slot] = 0
        self._mapped[slot] = 0


# -- scheduler hooks: no-ops on the contiguous engine --------------------

def _noop(*a, **k):
    return None


Engine.prepare_prefill = _noop
Engine.prepare_decode = _noop
Engine.prepare_rows = _noop
Engine.commit_lens = _noop
Engine.release_slot = _noop
