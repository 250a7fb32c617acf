"""Generation engine (port of `neural_speed_tpu/runtime/engine.py`: prefill,
decode and greedy generation over the int8 KV cache).

JAX's jitted steps with a donated cache become plain functions that write
the cache in place.  Prefill pads prompts to length buckets, as the JAX
package does, so the same shapes reach the kernels.  The decode loop is a
Python loop that keeps the argmax on the device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from .._build import resolve_device
from ..models.arch import ArchConfig
from ..models.transformer import (COMP_MODES, forward, fuse_params,
                                  kv_append_mode)
from ..ops import kv_cache as kvc


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


def _to_device(node, dev):
    if isinstance(node, dict):
        return {k: _to_device(v, dev) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_device(v, dev) for v in node]
    return node.to(dev) if hasattr(node, "to") else node


class Engine:
    """Owns params and the KV cache for one model instance, on `device` (the
    card unless the CPU is asked for).  The cache is always the int8 one with
    bf16 scales (the JAX Engine's `kv_quantized=True`).

    `comp` selects int8 compute for steps of at least 32 rows: None, "int8"
    (activation scales per token and K group) or "int8t" (per token).  The
    default "env" reads `NST_COMP` once, here, as the JAX package's switch."""

    def __init__(self, params: Dict[str, Any], cfg: ArchConfig,
                 max_batch: int = 1, max_len: int = 2048,
                 buckets: Tuple[int, ...] = DEFAULT_BUCKETS,
                 fuse: bool = True, device=None, comp: Optional[str] = "env"):
        self.device = resolve_device(device)
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
            cfg = dataclasses.replace(cfg, kv_append=kv_append_mode(cfg))
        self.params = params
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.buckets = tuple(b for b in buckets if b <= max_len) or (max_len,)
        if self.buckets[-1] < max_len:
            self.buckets = self.buckets + (max_len,)
        self.cache = self.new_cache()

    def new_cache(self) -> kvc.KVCache:
        return kvc.init_cache(
            self.cfg.n_layers, self.max_batch, self.max_len,
            self.cfg.n_kv_heads, self.cfg.head_dim, device=self.device)

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
