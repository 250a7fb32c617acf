"""RoPE and RMSNorm of the PyTorch port against the JAX package.

Both compute in float32 and round once to the input dtype.  cos/sin come
from different libm implementations (a few float32 ulps apart), so float32
results agree to 1e-6 relative and bf16 results within one bf16 ulp.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu.ops import norms as jn
from neural_speed_tpu.ops import rope as jr
from neural_speed_tpu_torch.ops import norms as tn
from neural_speed_tpu_torch.ops import rope as tr

from tests.torch_port_util import (bf16_to_f32, jax_bf16, to_numpy,
                                   torch_bf16, torch_to_numpy)

torch.set_num_threads(1)


@pytest.mark.parametrize("style", ["neox", "gptj"])
def test_rope_matches_jax(style):
    rng = np.random.default_rng(0)
    d, t, h = 32, 40, 4
    inv_j, _ = jr.rope_inv_freq(d, 10000.0)
    inv_t, _ = tr.rope_inv_freq(d, 10000.0)
    np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j), rtol=1e-6)
    pos = rng.integers(0, 2000, (2, t)).astype(np.int32)
    cj, sj = jr.rope_cos_sin(jnp.asarray(pos), inv_j)
    ct, st = tr.rope_cos_sin(torch.from_numpy(pos), inv_t)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=2e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=2e-6)
    x = jax_bf16(rng.standard_normal((2, t, h, d)).astype(np.float32))
    want = bf16_to_f32(to_numpy(jr.apply_rope(x, cj, sj, style)))
    got = bf16_to_f32(torch_to_numpy(tr.apply_rope(torch_bf16(x), ct, st,
                                                   style)))
    np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=1e-6)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(1)
    x = jax_bf16(rng.standard_normal((3, 5, 64)).astype(np.float32))
    w = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    want = bf16_to_f32(to_numpy(jn.rms_norm(x, jnp.asarray(w))))
    got = bf16_to_f32(torch_to_numpy(tn.rms_norm(torch_bf16(x),
                                                 torch.from_numpy(w))))
    np.testing.assert_allclose(got, want, rtol=2.0 ** -8, atol=0)


def test_linear_applies_act_order_perm():
    """A GPTQ act-order linear (`{"w", "perm"}` from `gptq_to_qtensor`, the
    tests/test_gptq.py fixture: seed 1, K = 128) through the port's and the
    JAX `linear`: x is gathered along K by `perm` before the matmul.  Both
    compute in float32 on the same dequantized weight, summed in another
    order: within 1e-5 of the largest |output|, and within 1e-4 of
    x @ W on the checkpoint's own row order."""
    from neural_speed_tpu.convert import gptq as JG
    from neural_speed_tpu.models.transformer import linear as jlinear
    from neural_speed_tpu_torch.models.transformer import linear as tlinear
    from tests.test_gptq import _make_gptq
    from tests.torch_port_util import port_qtensor

    qw, qz, sc, gi, w_deq = _make_gptq(seed=1, act_order=True)
    jqt, perm = JG.gptq_to_qtensor(qw, qz, sc, g_idx=gi, bits=4,
                                   zero_plus_one=True)
    assert perm is not None
    x = np.random.default_rng(2).standard_normal((3, 128)).astype(np.float32)
    want = np.asarray(jlinear(jnp.asarray(x), {"w": jqt, "perm": perm}))
    got = tlinear(torch.from_numpy(x),
                  {"w": port_qtensor(jqt),
                   "perm": torch.from_numpy(np.array(perm))}).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got, x @ w_deq, rtol=0, atol=1e-4 * scale)
