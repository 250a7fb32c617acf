"""The port's int8 KV cache against the JAX package, byte for byte.

The same bf16 keys/values (numpy, from a seed) are appended by both
packages' `append_layer`: a prefill window whose padding rows are written
too (their queries sit on the trash position `max_len - 1`), a window that
overhangs the cache end (clipped and rolled), an inactive slot, then decode
appends with a spectator slot.  Codes, scales and lengths must be identical
after every step.
"""

import numpy as np
import torch

import jax.numpy as jnp

from neural_speed_tpu.ops import kv_cache as jkv
from neural_speed_tpu_torch.ops import kv_cache as tkv

from tests.torch_port_util import assert_cache_equal, jax_bf16, torch_bf16

torch.set_num_threads(1)

L, B, H, S, D = 2, 3, 4, 64, 32


def _kv(rng, t):
    k = rng.standard_normal((B, t, H, D)).astype(np.float32) * 2.0
    v = rng.standard_normal((B, t, H, D)).astype(np.float32)
    return jax_bf16(k), jax_bf16(v)


def test_quantize_kv_bit_identical():
    rng = np.random.default_rng(0)
    x = jax_bf16(rng.standard_normal((5, 7, D)).astype(np.float32) * 3.0)
    jc, js = jkv.quantize_kv(x)
    tc, ts = tkv.quantize_kv(torch_bf16(x))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_append_layer_bit_identical():
    rng = np.random.default_rng(1)
    jc = jkv.init_cache(L, B, S, H, D, quantized=True,
                        scale_dtype=jnp.bfloat16)
    tc = tkv.init_cache(L, B, S, H, D, quantized=True, device="cpu")
    assert_cache_equal(jc, tc)

    # prefill window of T = 16 at layer 1: slot 0 has 11 real rows (5
    # padding rows parked on the trash position), slot 1 is inactive, slot 2
    # starts at S - 6 so its window overhangs the end and is rolled
    t = 16
    lens = np.array([11, 0, 6], np.int32)
    start = np.array([0, 0, S - 6], np.int32)
    ar = np.arange(t)[None]
    pos = np.where(ar < lens[:, None], start[:, None] + ar, S - 1)
    active = lens > 0
    k, v = _kv(rng, t)
    jc = jkv.append_layer(jc, 1, k, v, jnp.asarray(pos), jnp.asarray(active))
    tkv.append_layer(tc, 1, torch_bf16(k), torch_bf16(v),
                     torch.from_numpy(pos), torch.from_numpy(active))
    assert_cache_equal(jc, tc)
    # the padding rows of slot 0 were written too
    assert np.any(np.asarray(jc.k)[1, 0, :, 11:16] != 0)

    # decode appends: slot 1 is a spectator parked on the trash position
    lengths = np.array([11, 0, 6], np.int32)
    for step in range(3):
        k, v = _kv(rng, 1)
        act = np.array([True, False, True])
        pos = np.where(act, lengths, S - 1)[:, None].astype(np.int32)
        for layer in range(L):
            jc = jkv.append_layer(jc, layer, k, v, jnp.asarray(pos),
                                  jnp.asarray(act))
            tkv.append_layer(tc, layer, torch_bf16(k), torch_bf16(v),
                             torch.from_numpy(pos), torch.from_numpy(act))
        lengths = lengths + act
        jc = jkv.set_lengths(jc, jnp.asarray(lengths))
        tkv.set_lengths(tc, torch.from_numpy(lengths))
        assert_cache_equal(jc, tc)
    assert np.all(np.asarray(jc.k)[:, 1] == 0)  # the spectator stayed empty
