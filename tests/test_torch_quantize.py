"""Packed int planes of the PyTorch port against the JAX package, bit for bit.

Codes made with numpy from a seed go through `pack_codes` in both packages;
the port's int32 planes must equal the JAX uint32 planes viewed as int32,
and `unpack_codes`, `repad_k`, `repad_n`, `concat_n` and `dequantize` must
agree exactly (dequantize computes in float32 and rounds once in both).
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu.ops.qtypes import QSpec as JSpec, QType as JQType
from neural_speed_tpu_torch.models.params import params_from_numpy
from neural_speed_tpu_torch.ops import quantize as tq

from tests.torch_port_util import to_numpy, torch_to_numpy, tree_to_numpy

# `neural_speed_tpu.ops` re-exports a function named `quantize`
jq = importlib.import_module("neural_speed_tpu.ops.quantize")

torch.set_num_threads(1)


def _codes(k, n, bits, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2 ** bits, (k, n), dtype=np.uint8)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("k_shards", [1, 2])
def test_pack_codes_bit_identical(bits, k_shards):
    codes = _codes(128, 24, bits, seed=bits)
    want = jq.pack_codes(jnp.asarray(codes), bits, k_shards)
    got = tq.pack_codes(torch.from_numpy(codes), bits, k_shards)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(torch_to_numpy(g), to_numpy(w))
    back = tq.unpack_codes(got, bits, 128, k_shards)
    np.testing.assert_array_equal(back.numpy(), codes)


def _jax_qtensor(k, n, bits, g, seed, scale_dtype="bfloat16", sym=True):
    rng = np.random.default_rng(seed)
    spec = JSpec(JQType.INT, bits, g, sym, scale_dtype=scale_dtype)
    codes = rng.integers(0, 2 ** bits, (k, n), dtype=np.uint8)
    scales = jnp.asarray(rng.uniform(0.5, 1.5, (k // g, n)) * 0.02,
                         jnp.float32)
    if scale_dtype == "bfloat16":
        scales = scales.astype(jnp.bfloat16)
    zeros = None if sym else jnp.asarray(
        rng.integers(0, 2 ** bits, (k // g, n), dtype=np.uint8))
    return jq.QTensor(jq.pack_codes(jnp.asarray(codes), bits), scales, zeros,
                      None, spec, (k, n))


def _port(qt):
    return params_from_numpy({"w": tree_to_numpy(qt)}, device="cpu")["w"]


@pytest.mark.parametrize("bits,sym,scale_dtype", [
    (4, True, "bfloat16"), (4, False, "float32"), (2, True, "float32"),
    (1, True, "bfloat16"), (8, True, "bfloat16"), (3, True, "float32")])
def test_dequantize_exact(bits, sym, scale_dtype):
    jqt = _jax_qtensor(256, 40, bits, 64, seed=bits, scale_dtype=scale_dtype,
                       sym=sym)
    tqt = _port(jqt)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = to_numpy(jq.dequantize(jqt, jdt))
        np.testing.assert_array_equal(torch_to_numpy(tq.dequantize(tqt, tdt)),
                                      want)


def test_repad_k_and_concat_n_bit_identical():
    # llama's FFN-down shape in miniature: K = 448 is not a multiple of the
    # 8-band x 64-group period, so the pack is re-padded to K = 512
    a = _jax_qtensor(448, 24, 4, 64, seed=1)
    b = _jax_qtensor(448, 16, 4, 64, seed=2)
    want = jq.repad_k(jq.concat_n([a, b]), 8 * 64)
    got = tq.repad_k(tq.concat_n([_port(a), _port(b)]), 8 * 64)
    assert got.shape == want.shape == (512, 40)
    np.testing.assert_array_equal(torch_to_numpy(got.data[0]),
                                  to_numpy(want.data[0]))
    np.testing.assert_array_equal(torch_to_numpy(got.scales),
                                  to_numpy(want.scales))
    np.testing.assert_array_equal(
        torch_to_numpy(tq.dequantize(got)), to_numpy(jq.dequantize(want)))


def test_repad_n_bit_identical():
    a = _jax_qtensor(128, 40, 4, 64, seed=3)
    want = jq.repad_n(a, 64)
    got = tq.repad_n(_port(a), 64)
    assert got.shape == want.shape == (128, 64)
    np.testing.assert_array_equal(torch_to_numpy(got.data[0]),
                                  to_numpy(want.data[0]))
    np.testing.assert_array_equal(torch_to_numpy(got.scales),
                                  to_numpy(want.scales))
