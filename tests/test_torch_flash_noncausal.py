"""The non-causal variant of the attention kernels' plain versions against
the JAX package's Pallas bodies (NST_FLASH=interpret) on the CPU.

`mha` / `mha_paged` with `causal=False` run the port's plain versions of
kernels B, C, 9 and 10 (CPU tensors) and the JAX entries the Pallas
kernels `_mha_kernel_hblk` / `_mha_kernel` in interpret mode, on the same
inputs: decode after a plain append (kernel B's bf16 / float32 instances;
int8 goes to kernel C, as the port routes it) and prefill, over int8, bf16
and float32 K/V, one ALiBi case each, float32 q with a float32 output
(whisper's dtypes), at n_rep 2, with kv_lens well below S (300 and 211 of
384: the Pallas kernels take S % 128 == 0, so `mha` returns None below
that).

Queries sit at positions where causal attention would mask most columns
(decode at position 0; prefill rows from 0 and from 50), and each output is
held more than 10 tolerances from the causal output of the same inputs, so
a version that kept the causal mask fails.  Held: the outputs within 2
bf16 ulps of the largest output (as `test_torch_flash_variants.py`: both
sides round q and P (times the V scale) to bf16 at the same points; the f32
summation order, the online-softmax rescale and the output rounding
differ), the output dtype, the `_noncausal` counters, and the paged plain
versions equal to the contiguous ones over the gathered layer.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu.ops import attention as jat
from neural_speed_tpu.ops import flash as jfl
from neural_speed_tpu.ops import paged_kv as jpk
from neural_speed_tpu_torch import _build
from neural_speed_tpu_torch.ops import attention as tat
from neural_speed_tpu_torch.ops import flash as tfl
from neural_speed_tpu_torch.ops import paged_kv as tpk

from tests.torch_port_util import (bf16_to_f32, jax_bf16, to_numpy,
                                   torch_bf16, torch_to_numpy)

torch.set_num_threads(1)
ULP = 2.0 ** -8
ULPS = 2
L, B, S, PS = 2, 2, 384, 128
H, HKV, D = 4, 2, 32
KV_LENS = np.array([300, 211], np.int32)
# (kind, K/V, ALiBi, q and output dtype)
CASES = [("decode", "int8", False, "bf16"), ("decode", "bf16", False, "f32"),
         ("decode", "f32", False, "f32"), ("decode", "bf16", True, "bf16"),
         ("prefill", "int8", False, "bf16"), ("prefill", "bf16", False, "bf16"),
         ("prefill", "f32", False, "f32"), ("prefill", "f32", True, "f32")]
IDS = ["-".join(str(x) for x in c) for c in CASES]


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    monkeypatch.setenv("NST_FLASH", "interpret")


def _t(a):
    """A JAX array as the port's tensor with the same bits."""
    if a.dtype == jnp.bfloat16:
        return torch_bf16(a)
    return torch.from_numpy(np.array(a))


def _rows(rng, shape, kv):
    if kv == "int8":
        return jnp.asarray(rng.integers(-127, 128, shape), jnp.int8)
    x = rng.standard_normal(shape).astype(np.float32)
    return jax_bf16(x) if kv == "bf16" else jnp.asarray(x)


def _scales(rng, shape, kv):
    if kv != "int8":
        return None
    return jax_bf16(rng.uniform(0.5, 1.5, shape).astype(np.float32) * 0.02)


def _case(kind, rng, io):
    """q, positions: decode at position 0 in both slots; prefill of 24 rows
    from position 0 (slot 0) and from 50 (slot 1)."""
    if kind == "decode":
        pos = np.zeros((B, 1), np.int32)
    else:
        ar = np.arange(24, dtype=np.int32)
        pos = np.stack([ar, 50 + ar])
    x = rng.standard_normal((B, pos.shape[1], H, D)).astype(np.float32)
    q = jnp.asarray(x) if io == "f32" else jax_bf16(x)
    return q, pos


def _f32(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.float32:
        return t.numpy()
    return bf16_to_f32(torch_to_numpy(t))


def _np(a) -> np.ndarray:
    a = to_numpy(a)
    return bf16_to_f32(a) if a.dtype == np.uint16 else a


def _tol(want: np.ndarray) -> float:
    return ULPS * ULP * np.abs(want).max()


def _hold(out_t, causal_t, out_j, io):
    """Within the tolerance of the Pallas body's output, of the asked dtype,
    and more than 10 tolerances from the causal output."""
    want = _np(out_j)
    assert out_t.dtype == (torch.float32 if io == "f32" else torch.bfloat16)
    np.testing.assert_allclose(_f32(out_t), want, rtol=0, atol=_tol(want))
    off = np.abs(_f32(out_t) - _f32(causal_t)).max()
    assert off > 10 * _tol(want), (off, _tol(want))


def _counter(kind, kv, paged=False):
    suffix = {"int8": "", "bf16": "_bf16", "f32": "_f32"}[kv]
    route = "flash_decode" if kind == "decode" and kv != "int8" else \
        "flash_prefill"
    return route + ("_paged" if paged else "") + suffix + "_noncausal"


@pytest.mark.parametrize("kind,kv,alibi,io", CASES, ids=IDS)
def test_contiguous_noncausal_matches_pallas(kind, kv, alibi, io):
    """`mha(causal=False)` over the stacked cache."""
    rng = np.random.default_rng(CASES.index((kind, kv, alibi, io)))
    kc, vc = (_rows(rng, (L, B, HKV, S, D), kv) for _ in range(2))
    ks, vs = (_scales(rng, (L, B, HKV, S), kv) for _ in range(2))
    q, pos = _case(kind, rng, io)
    slopes = jat.alibi_slopes(H) if alibi else None
    ta = None if slopes is None else torch.from_numpy(np.array(slopes))
    kw = dict(scale=1.0 / math.sqrt(D), layer=1)
    out_j = jfl.mha(q, kc, vc, ks, vs, jnp.asarray(pos),
                    jnp.asarray(KV_LENS), alibi=slopes, causal=False, **kw)
    assert out_j is not None
    args_t = (_t(q), *(None if a is None else _t(a) for a in (kc, vc, ks,
                                                              vs)),
              torch.from_numpy(pos), torch.from_numpy(KV_LENS))
    name = _counter(kind, kv)
    before = _build.plain_dispatches[name]
    out_t = tfl.mha(*args_t, alibi=ta, causal=False, **kw)
    assert _build.plain_dispatches[name] == before + 1
    _hold(out_t, tfl.mha(*args_t, alibi=ta, **kw), out_j, io)


def _pools(rng, kv):
    """A JAX pool and the port's with the same bytes; a shuffled table over
    every page but the trash page."""
    nb = S // PS
    n_pages = B * nb + 1
    kc, vc = (_rows(rng, (L, HKV, n_pages, PS, D), kv) for _ in range(2))
    ks, vs = (_scales(rng, (L, HKV, n_pages, 1, PS), kv) for _ in range(2))
    tables = rng.permutation(n_pages - 1).reshape(B, nb).astype(np.int32)
    lens = np.zeros((B,), np.int32)
    jc = jpk.PagedKVCache(kc, vc, ks, vs, jnp.asarray(tables),
                          jnp.asarray(lens))
    tc = tpk.PagedKVCache(
        *(None if a is None else _t(a) for a in (kc, vc, ks, vs)),
        torch.from_numpy(tables), torch.from_numpy(lens))
    return jc, tc


@pytest.mark.parametrize("kind,kv,alibi,io", CASES, ids=IDS)
def test_paged_noncausal_matches_pallas(kind, kv, alibi, io):
    """`mha_paged(causal=False)` (page size 128) as the contiguous cases;
    the paged plain versions equal the contiguous ones over the gathered
    layer bit for bit."""
    rng = np.random.default_rng(40 + CASES.index((kind, kv, alibi, io)))
    jc, tc = _pools(rng, kv)
    q, pos = _case(kind, rng, io)
    slopes = jat.alibi_slopes(H) if alibi else None
    ta = None if slopes is None else torch.from_numpy(np.array(slopes))
    scale, layer = 1.0 / math.sqrt(D), 1
    out_j = jfl.mha_paged(q, jc, layer, jnp.asarray(pos),
                          jnp.asarray(KV_LENS), scale=scale, alibi=slopes,
                          causal=False)
    assert out_j is not None
    args_t = (_t(q), tc, layer, torch.from_numpy(pos),
              torch.from_numpy(KV_LENS))
    name = _counter(kind, kv, paged=True)
    before = _build.plain_dispatches[name]
    out_t = tfl.mha_paged(*args_t, scale=scale, alibi=ta, causal=False)
    assert _build.plain_dispatches[name] == before + 1
    _hold(out_t, tfl.mha_paged(*args_t, scale=scale, alibi=ta), out_j, io)
    rows = [None if a is None else a[None] for a in tpk.gather_layer_codes(
        tc.k_pages, tc.v_pages, tc.k_scale, tc.v_scale, tc.page_tables,
        layer)]
    assert torch.equal(out_t, tfl.mha(
        _t(q), *rows, torch.from_numpy(pos), torch.from_numpy(KV_LENS),
        scale=scale, alibi=ta, causal=False, layer=0))


@pytest.mark.parametrize("io", ["bf16", "f32"])
def test_attention_pads_float_kv_for_the_kernels(io):
    """`attention(causal=False)` over float K/V of S = 300 rows (whisper's
    route): `kv_layout` pads them to 320 zero-filled rows, masked by the
    lengths; the output matches the Pallas body over the same K/V padded
    to 384 with large values in the padding (a leak would show), and the
    lengths are clipped to S as the reference masks."""
    rng = np.random.default_rng(90 + (io == "f32"))
    s = 300
    k, v = (rng.standard_normal((B, s, HKV, D)).astype(np.float32)
            for _ in range(2))
    q, pos = _case("prefill", rng, io)
    lens = np.array([300, 211], np.int32)
    pad = lambda a: np.concatenate(
        [a.transpose(0, 2, 1, 3),
         np.full((B, HKV, S - s, D), 1e4, np.float32)], axis=2)
    out_j = jfl.mha(q, jnp.asarray(pad(k)), jnp.asarray(pad(v)), None, None,
                    jnp.asarray(pos), jnp.asarray(lens),
                    scale=1.0 / math.sqrt(D), causal=False)
    kt = tat.kv_layout(torch.from_numpy(k))
    assert kt.shape == (1, B, HKV, 320, D) and not kt[0, :, :, s:].any()
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    out_t = tat.attention(_t(q), tk, tv, torch.from_numpy(pos),
                          torch.from_numpy(lens), causal=False)
    causal_t = tat.attention(_t(q), tk, tv, torch.from_numpy(pos),
                             torch.from_numpy(lens))
    _hold(out_t, causal_t, out_j, io)
    over = tat.attention(_t(q), tk, tv, torch.from_numpy(pos),
                         torch.from_numpy(lens + 50), causal=False)
    full = tat.attention(_t(q), tk, tv, torch.from_numpy(pos),
                         torch.from_numpy(np.minimum(lens + 50, s)),
                         causal=False)
    assert torch.equal(over, full)
