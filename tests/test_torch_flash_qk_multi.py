"""Kernel B's int8 score dot over several tokens per slot (`NST_FLASH_INT8=
qk`, t > 1, t * n_rep <= 8: speculative decoding's verify steps) in its
plain version, against the JAX package's head-blocked Pallas body
(`_mha_kernel_hblk` through `_mha_packed_hblk`, NST_FLASH=interpret) on
the CPU.

Both flags are set for the tests' duration and JAX's caches cleared before
and after (a cached trace keeps the flag it was traced with).  The slots
of each call: slot 0 verifies t real rows ending at kv_len - 1, slot 1 has
t // 2 real rows and the rest padded at max_len - 1 (as the scheduler's
joint step pads them), slot 2 is idle with all rows at max_len - 1 over
its stored rows, or with kv_len 0 (a free slot).  q rows carry one element
30x the rest (as `test_torch_flash_int8qk.py`), so the int8 dot moves the
output far from the float product's.  Held: the output within 2 bf16 ulps
of the largest output (the tolerance of `test_torch_flash_int8qk.py`),
more than 10 of those tolerances from the port's output without the int8
dot (which goes to kernel C), and the `_qk_multi` plain counter.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from neural_speed_tpu.ops import attention as jat
from neural_speed_tpu.ops import flash as jfl
from neural_speed_tpu_torch import _build
from neural_speed_tpu_torch.ops import flash as tfl

from tests.torch_port_util import bf16_to_f32, jax_bf16, to_numpy, torch_bf16
from tests.test_torch_flash_int8qk import _codes, _f32, _scales, _t

torch.set_num_threads(1)
ULP = 2.0 ** -8
ULPS = 2
L, B, S = 2, 3, 256
CAP = 30.0


@pytest.fixture(autouse=True)
def _qk_on(monkeypatch):
    monkeypatch.setenv("NST_FLASH", "interpret")
    jax.clear_caches()
    monkeypatch.setattr(jfl, "FLASH_INT8_DOT", True)
    monkeypatch.setattr(tfl, "FLASH_INT8_DOT", True)
    yield
    jax.clear_caches()


def _q(rng, t, h, d):
    """bf16 q [B, t, H, D]: each row twice N(0, 1) with one element +-60."""
    q = rng.standard_normal((B, t, h, d)).astype(np.float32)
    at = rng.integers(0, d, (B, t, h, 1))
    np.put_along_axis(q, at, 30.0 * np.where(
        rng.random((B, t, h, 1)) < 0.5, -1.0, 1.0), -1)
    return jax_bf16(2.0 * q)


def _rows(t, free_slot):
    """Positions [B, t] and kv_lens [B] of a joint step: slot 0 t real rows,
    slot 1 t // 2 real rows and padding at S - 1, slot 2 idle (kv_len 77,
    or 0 for a free slot)."""
    pos = np.full((B, t), S - 1, np.int32)
    pos[0] = np.arange(150 - t, 150)
    n1 = max(1, t // 2)
    pos[1, :n1] = np.arange(60, 60 + n1)
    kv_lens = np.array([150, 60 + n1, 0 if free_slot else 77], np.int32)
    return pos, kv_lens


# (t, H, Hkv, D, float32 scales, ALiBi, softcap, causal, free slot)
# t in {2, 4, 8} x n_rep in {1, 2, 4} with t * n_rep <= 8
GRID = [(t, h, hkv, 128, False, False, False, True, False)
        for t, h, hkv in ((2, 4, 4), (4, 4, 4), (8, 4, 4), (2, 8, 4),
                          (4, 8, 4), (2, 8, 2))]
VARIANTS = [
    (4, 8, 4, 128, False, False, True, True, False),     # softcap
    (4, 8, 4, 128, False, True, False, True, False),     # ALiBi
    (4, 8, 4, 128, True, False, False, True, False),     # float32 scales
    (4, 8, 4, 128, False, False, False, False, False),   # non-causal
    (4, 8, 4, 80, False, False, False, True, False),     # D = 80
    (4, 8, 4, 256, False, False, False, True, False),    # D = 256
    (4, 8, 4, 128, False, False, False, True, True),     # a free slot
]


def _id(case):
    t, h, hkv, d, f32, alibi, cap, causal, free = case
    return (f"t{t}-n_rep{h // hkv}-d{d}" + ("-f32scale" if f32 else "")
            + ("-alibi" if alibi else "") + ("-softcap" if cap else "")
            + ("" if causal else "-noncausal") + ("-free" if free else ""))


@pytest.mark.parametrize("case", GRID + VARIANTS, ids=_id)
def test_qk_rows_match_pallas(case):
    t, h, hkv, d, f32, alibi, softcap, causal, free = case
    assert t * (h // hkv) <= 8 and hkv % 2 == 0
    rng = np.random.default_rng(sum(map(int, case[:4])) + 7 * f32
                                + 11 * alibi + 13 * softcap + 17 * causal
                                + 19 * free)
    kc, vc = (_codes(rng, (L, B, hkv, S, d)) for _ in range(2))
    ks, vs = (_scales(rng, (L, B, hkv, S), f32) for _ in range(2))
    q = _q(rng, t, h, d)
    pos, kv_lens = _rows(t, free)
    slopes = jat.alibi_slopes(h) if alibi else None
    ta = None if slopes is None else torch.from_numpy(np.array(slopes))
    kw = dict(scale=1.0 / math.sqrt(d), layer=1, causal=causal,
              logit_softcap=CAP if softcap else 0.0)
    out_j = jfl.mha(q, kc, vc, ks, vs, jnp.asarray(pos),
                    jnp.asarray(kv_lens), alibi=slopes, **kw)
    assert out_j is not None
    args = lambda: (torch_bf16(q), _t(kc), _t(vc), _t(ks), _t(vs),
                    torch.from_numpy(pos), torch.from_numpy(kv_lens))
    suffix = (("_f32scale" if f32 else "") + ("_softcap" if softcap else "")
              + ("" if causal else "_noncausal"))
    name = "flash_decode" + suffix + "_qk_multi"
    before = _build.plain_dispatches[name]
    out_t = tfl.mha(*args(), alibi=ta, **kw)
    assert _build.plain_dispatches[name] == before + 1
    assert out_t.shape == (B, t, h, d)
    want = bf16_to_f32(to_numpy(out_j))
    tol = ULPS * ULP * np.abs(want).max()
    np.testing.assert_allclose(_f32(out_t), want, rtol=0, atol=tol)
    if free:
        assert not _f32(out_t)[2].any()     # no valid column: 0
    # without the int8 dot the call goes to kernel C, far from this one
    tfl.FLASH_INT8_DOT = False
    prefill = "flash_prefill" + suffix
    before = _build.plain_dispatches[prefill]
    off = tfl.mha(*args(), alibi=ta, **kw)
    assert _build.plain_dispatches[prefill] == before + 1
    assert np.abs(_f32(out_t) - _f32(off)).max() > 10 * tol


def test_rows_are_rep_major_and_per_row():
    """Each output row depends on its own (head, token) q row and position
    only: permuting the tokens of a slot (with their positions) permutes
    the output the same way, and a padded row does not change the real
    rows' outputs."""
    rng = np.random.default_rng(5)
    t, h, hkv, d = 4, 8, 4, 128
    kc, vc = (_codes(rng, (L, B, hkv, S, d)) for _ in range(2))
    ks, vs = (_scales(rng, (L, B, hkv, S), False) for _ in range(2))
    q = torch_bf16(_q(rng, t, h, d))
    pos, kv_lens = _rows(t, False)
    pos, kv_lens = torch.from_numpy(pos), torch.from_numpy(kv_lens)
    cache = [_t(a) for a in (kc, vc, ks, vs)]
    kw = dict(scale=1.0 / math.sqrt(d), layer=0)
    out = tfl.mha(q, *cache, pos, kv_lens, **kw)
    perm = torch.tensor([2, 0, 3, 1])
    out_p = tfl.mha(q[:, perm], *cache, pos[:, perm], kv_lens, **kw)
    assert torch.equal(out_p, out[:, perm])
    q2 = q.clone()
    q2[1, 3] = 7.0                                  # slot 1's padded row
    out2 = tfl.mha(q2, *cache, pos, kv_lens, **kw)
    keep = torch.ones((B, t), dtype=torch.bool)
    keep[1, 3] = False
    assert torch.equal(out2[keep], out[keep])


def test_kernel_b_wrapper_refuses_what_it_does_not_take():
    """The CUDA wrapper's checks run before any launch: several tokens per
    slot only with the int8 dot, without the extra column, and at most 8
    rows per KV head (the CPU tensors fail the device check first, so the
    rule is read through `_check_decode` on a tensor marked CUDA-like)."""
    class _Q:
        is_cuda = True
        dtype = torch.bfloat16
        device = "cuda"

        def __init__(self, shape):
            self.shape = shape

    ok = dict(fused_append=False, out_dtype=torch.bfloat16, hkv=4,
              suffix="", what="kernel B")
    tfl._check_decode(_Q((2, 4, 8, 128)), None, None, qk=True,
                      rows_ok=True, **ok)
    for q, qk, rows_ok, kn in ((_Q((2, 4, 8, 128)), False, True, None),
                               (_Q((2, 8, 8, 128)), True, True, None),
                               (_Q((2, 4, 8, 128)), True, False, None)):
        with pytest.raises(ValueError):
            tfl._check_decode(q, kn, kn, qk=qk, rows_ok=rows_ok, **ok)
