"""Sampling suite (port of `neural_speed_tpu/ops/sampling.py`): penalties,
temperature, top-k / top-p / tail-free / typical filters, mirostat v1 and
v2, greedy, over `[B, V]` logit batches on the logits' device.

The sampler state (penalty counts, last-token ring, mirostat mu) is carried
by the engine between steps as in the JAX package; a `torch.Generator` on
the logits' device takes the place of the PRNG key.  Categorical draws are
Gumbel-max, as `jax.random.categorical`: argmax(logits + Gumbel noise), the
noise drawn from the state's generator.  The numbers differ from JAX's for
the same seed, so only their distribution is held against the JAX package.
Sampling has no kernel: it is PyTorch on both devices.  The functions
return new state tensors and leave the ones they are given untouched.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

NEG_INF = -1e9


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """The JAX package's sampling fields and defaults."""

    temperature: float = 0.8
    top_k: int = 40           # <=0 => disabled
    top_p: float = 0.95       # >=1 => disabled
    tfs_z: float = 1.0        # tail-free sampling, 1 => disabled
    typical_p: float = 1.0    # locally-typical sampling, 1 => disabled
    repetition_penalty: float = 1.1
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    penalty_window: int = 64  # repeat_last_n
    mirostat: int = 0         # 0 off, 1 v1, 2 v2
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    do_sample: bool = True    # False => greedy


@dataclasses.dataclass
class SamplerState:
    generator: torch.Generator
    counts: torch.Tensor       # [B, V] int32 — generated-token counts
    last_tokens: torch.Tensor  # [B, W] int32 ring of recent ids (-1 = empty)
    ring_pos: torch.Tensor     # [B] int32
    mu: torch.Tensor           # [B] f32 mirostat state


def init_state(key: Union[int, torch.Generator], batch: int, vocab: int,
               window: int = 64, tau: float = 5.0,
               device=None) -> SamplerState:
    """`key`: a seed, or a generator on `device` (the card unless the CPU
    is asked for)."""
    from .._build import resolve_device

    dev = resolve_device(device)
    if isinstance(key, torch.Generator):
        gen = key
    else:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(key))
    return SamplerState(
        generator=gen,
        counts=torch.zeros((batch, vocab), dtype=torch.int32, device=dev),
        last_tokens=torch.full((batch, window), -1, dtype=torch.int32,
                               device=dev),
        ring_pos=torch.zeros((batch,), dtype=torch.int32, device=dev),
        mu=torch.full((batch,), 2.0 * tau, dtype=torch.float32, device=dev))


def _set_row(a: torch.Tensor, slot: int, value) -> torch.Tensor:
    out = a.clone()
    out[slot] = value
    return out


def reset_slot(state: SamplerState, slot: int,
               tau: float = 5.0) -> SamplerState:
    """Clear one batch slot's penalty/mirostat state (new request)."""
    return dataclasses.replace(
        state, counts=_set_row(state.counts, slot, 0),
        last_tokens=_set_row(state.last_tokens, slot, -1),
        ring_pos=_set_row(state.ring_pos, slot, 0),
        mu=_set_row(state.mu, slot, 2.0 * tau))


def observe_prompt_slot(state: SamplerState, slot: int,
                        tokens) -> SamplerState:
    """Bulk-record a prompt into one slot's penalty state (one shot)."""
    dev = state.counts.device
    toks = torch.as_tensor(tokens, dtype=torch.int32).to(dev)
    v = state.counts.shape[1]
    counts = state.counts.clone()
    counts[slot] += torch.bincount(toks.clamp(0, v - 1).long(),
                                   minlength=v).to(torch.int32)
    w = state.last_tokens.shape[1]
    tail = toks[-w:] if toks.numel() else toks
    m = tail.shape[0]
    last = state.last_tokens.clone()
    last[slot, :m] = tail
    return dataclasses.replace(
        state, counts=counts, last_tokens=last,
        ring_pos=_set_row(state.ring_pos, slot, m % w if m < w else 0))


def observe(state: SamplerState, tokens: torch.Tensor,
            active: Optional[torch.Tensor] = None) -> SamplerState:
    """Record sampled tokens into the penalty structures."""
    b = tokens.shape[0]
    rows = torch.arange(b, device=tokens.device)
    act = (torch.ones((b,), dtype=torch.bool, device=tokens.device)
           if active is None else active)
    tok = tokens.long()
    counts = state.counts.clone()
    counts[rows, tok] += act.to(torch.int32)
    w = state.last_tokens.shape[1]
    slot = (state.ring_pos % w).long()
    last = state.last_tokens.clone()
    last[rows, slot] = torch.where(act, tokens.to(torch.int32),
                                   state.last_tokens[rows, slot])
    return dataclasses.replace(state, counts=counts, last_tokens=last,
                               ring_pos=state.ring_pos + act.to(torch.int32))


# ---------------------------------------------------------------------------
# logit processors
# ---------------------------------------------------------------------------


def _scalar(like: torch.Tensor, value: float) -> torch.Tensor:
    """A 0-d float32 tensor on `like`'s device (a fill, no host-device copy):
    dividing by it is an IEEE division on both devices, where PyTorch's CUDA
    division by a Python scalar multiplies by the reciprocal."""
    return like.new_full((), value, dtype=torch.float32)


def apply_penalties(logits: torch.Tensor, state: SamplerState,
                    p: SamplingParams) -> torch.Tensor:
    """Repetition (CTRL-style, over the last-N window) + frequency/presence
    (OpenAI-style, full history)."""
    b, v = logits.shape
    out = logits
    if p.repetition_penalty != 1.0:
        tok = state.last_tokens.clamp(0, v - 1).long()
        valid = (state.last_tokens >= 0).to(torch.int32)
        in_window = torch.zeros((b, v), dtype=torch.int32,
                                device=logits.device)
        in_window.scatter_reduce_(1, tok, valid, reduce="amax")
        rp = _scalar(out, p.repetition_penalty)
        penalized = torch.where(out > 0, out / rp, out * rp)
        out = torch.where(in_window.bool(), penalized, out)
    if p.frequency_penalty != 0.0 or p.presence_penalty != 0.0:
        cnt = state.counts.float()
        out = out - cnt * p.frequency_penalty - (
            cnt > 0).float() * p.presence_penalty
    return out


def _neg_inf_like(x: torch.Tensor) -> torch.Tensor:
    return x.new_full((), NEG_INF)


def _sorted_desc(logits: torch.Tensor) -> torch.Tensor:
    return torch.sort(logits, dim=-1).values.flip(-1)


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.sort(logits, dim=-1).values[:, -k][:, None]
    return torch.where(logits < kth, _neg_inf_like(logits), logits)


def _cutoff_filter(logits: torch.Tensor, sorted_logits: torch.Tensor,
                   keep_sorted: torch.Tensor) -> torch.Tensor:
    """Drop logits below the smallest kept sorted logit."""
    cutoff = torch.where(keep_sorted, sorted_logits,
                         sorted_logits.new_full((), -NEG_INF)
                         ).amin(dim=-1, keepdim=True)
    return torch.where(logits < cutoff, _neg_inf_like(logits), logits)


def top_p_filter(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus sampling: keep tokens until the cumulative probability
    exceeds top_p (always the top-1)."""
    if top_p >= 1.0:
        return logits
    sorted_logits = _sorted_desc(logits)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = cum - probs < top_p
    keep_sorted[:, 0] = True
    return _cutoff_filter(logits, sorted_logits, keep_sorted)


def tail_free_filter(logits: torch.Tensor, z: float) -> torch.Tensor:
    """Tail-free sampling: filter by the normalized |second derivative| of
    the sorted probability curve."""
    if z >= 1.0:
        return logits
    b, v = logits.shape
    sorted_logits = _sorted_desc(logits)
    probs = torch.softmax(sorted_logits, dim=-1)
    d2 = (probs[:, :-2] - 2 * probs[:, 1:-1] + probs[:, 2:]).abs()
    d2 = d2 / d2.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    cum = torch.cumsum(d2, dim=-1)
    keep = torch.cat([torch.ones((b, 1), dtype=torch.bool,
                                 device=logits.device), cum < z,
                      torch.zeros((b, 1), dtype=torch.bool,
                                  device=logits.device)], dim=-1)
    return _cutoff_filter(logits, sorted_logits, keep)


def typical_filter(logits: torch.Tensor, typical_p: float) -> torch.Tensor:
    """Locally-typical sampling."""
    if typical_p >= 1.0:
        return logits
    probs = torch.softmax(logits, dim=-1)
    logp = torch.log_softmax(logits, dim=-1)
    ent = -(probs * logp).sum(dim=-1, keepdim=True)
    shifted = (-logp - ent).abs()
    order = torch.argsort(shifted, dim=-1, stable=True)
    probs_sorted = torch.gather(probs, 1, order)
    cum = torch.cumsum(probs_sorted, dim=-1)
    keep_sorted = cum - probs_sorted < typical_p
    keep_sorted[:, 0] = True
    keep = torch.zeros_like(keep_sorted).scatter_(1, order, keep_sorted)
    return torch.where(keep, logits, _neg_inf_like(logits))


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


def categorical(logits: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
    """One draw per row from softmax(logits): Gumbel-max with the noise
    drawn from `generator` (on the logits' device)."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1).to(
        torch.int32)


def _mirostat_mu(state, p, observed, active):
    mu = state.mu - p.mirostat_eta * (observed - p.mirostat_tau)
    if active is not None:
        mu = torch.where(active, mu, state.mu)
    return dataclasses.replace(state, mu=mu)


def sample(logits: torch.Tensor, state: SamplerState, p: SamplingParams,
           active: Optional[torch.Tensor] = None
           ) -> Tuple[torch.Tensor, SamplerState]:
    """Full pipeline: penalties -> temperature -> (mirostat | filters) ->
    categorical draw.  Returns (tokens [B] int32, new state).  Only rows in
    `active` observe into the penalty ring/counts and update mirostat's mu."""
    b, v = logits.shape
    logits = apply_penalties(logits.float(), state, p)

    if not p.do_sample or p.temperature <= 0.0:
        toks = greedy(logits)
        return toks, observe(state, toks, active)

    logits = logits / _scalar(logits, p.temperature)
    gen = state.generator
    ln2 = _scalar(logits, math.log(2.0))

    if p.mirostat == 2:
        logp = torch.log_softmax(logits, dim=-1)
        surprise = -logp / ln2
        neg = _neg_inf_like(logits)
        filt = torch.where(surprise > state.mu[:, None], neg, logits)
        # keep at least the argmax
        top = torch.where(logits >= logits.amax(-1, keepdim=True), logits,
                          neg)
        filt = torch.where(filt.amax(-1, keepdim=True) <= NEG_INF / 2, top,
                           filt)
        toks = categorical(filt, gen)
        observed = torch.gather(surprise, 1, toks[:, None].long())[:, 0]
        state = _mirostat_mu(state, p, observed, active)
        return toks, observe(state, toks, active)
    if p.mirostat == 1:
        # estimate s_hat from the top-100 log-probability decay, derive k
        m = min(100, v)
        logp = torch.log_softmax(logits, dim=-1)
        sorted_lp = _sorted_desc(logp)[:, :m]
        ti = torch.log(torch.arange(2, m + 1, dtype=torch.float32,
                                    device=logits.device))
        bi = sorted_lp[:, :1] - sorted_lp[:, 1:]
        s_hat = (ti * bi).sum(-1) / (ti * ti).sum()
        eps = s_hat - 1.0
        k = ((eps * torch.pow(2.0, state.mu))
             / (1 - torch.pow(float(v), -eps))) ** (
                 1.0 / s_hat.clamp_min(1e-3))
        k = k.clamp(1, v).to(torch.int32)
        ranks = torch.argsort(torch.argsort(-logits, dim=-1, stable=True),
                              dim=-1, stable=True)
        filt = torch.where(ranks < k[:, None], logits,
                           _neg_inf_like(logits))
        toks = categorical(filt, gen)
        observed = -torch.gather(logp, 1, toks[:, None].long())[:, 0] / ln2
        state = _mirostat_mu(state, p, observed, active)
        return toks, observe(state, toks, active)

    logits = top_k_filter(logits, p.top_k)
    logits = tail_free_filter(logits, p.tfs_z)
    logits = typical_filter(logits, p.typical_p)
    logits = top_p_filter(logits, p.top_p)
    toks = categorical(logits, gen)
    return toks, observe(state, toks, active)
