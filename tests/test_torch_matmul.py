"""`qmatmul` of the PyTorch port (its plain version, on the CPU) against the
JAX package's `qmatmul_xla` and its Pallas kernel in interpret mode.

Activations are bf16 made with numpy from a seed; weights are int4 packs with
bf16 group scales (the main path's format).  Tolerances, in bf16 ulps
(2**-8 relative) of the largest output:

* where both sides dequantize to the same values — M = 40 (bf16 compute: the
  weight `s * (code - 8)` is rounded to bf16 in both) against `qmatmul_xla`,
  and M = 1 (exact f32 weights) against the Pallas kernel — the only
  differences are the f32 summation order and the bf16 output rounding:
  2 ulps;
* where they do not — M = 1 against `qmatmul_xla` (which rounds the weight to
  bf16 where the port's decode path keeps it exact in f32), and M = 40
  against the kernel (which dots raw codes and applies the scale after the
  dot) — the bf16 weight rounding adds up over K: 8 ulps.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu.ops import matmul as jm
from neural_speed_tpu.ops.qtypes import QSpec as JSpec, QType as JQType
from neural_speed_tpu_torch import _build
from neural_speed_tpu_torch.models.params import params_from_numpy
from neural_speed_tpu_torch.ops import matmul as tm

from tests.torch_port_util import (bf16_to_f32, jax_bf16, to_numpy,
                                   torch_bf16, torch_to_numpy, tree_to_numpy)

jq = importlib.import_module("neural_speed_tpu.ops.quantize")

torch.set_num_threads(1)
ULP = 2.0 ** -8


def _pack(k, n, g=64, seed=0, repad=None):
    rng = np.random.default_rng(seed)
    spec = JSpec(JQType.INT, 4, g, True, scale_dtype="bfloat16")
    codes = rng.integers(0, 16, (k, n), dtype=np.uint8)
    scales = jnp.asarray(rng.uniform(0.5, 1.5, (k // g, n)) * 0.05,
                         jnp.float32).astype(jnp.bfloat16)
    qt = jq.QTensor(jq.pack_codes(jnp.asarray(codes), 4), scales, None, None,
                    spec, (k, n))
    if repad:
        qt = jq.repad_k(qt, repad)
    return qt, params_from_numpy({"w": tree_to_numpy(qt)}, device="cpu")["w"]


@pytest.mark.parametrize("m,k,n,repad", [
    (1, 256, 192, None), (40, 256, 192, None), (1, 448, 128, 512),
    (40, 448, 128, 512)])
def test_qmatmul_matches_jax(monkeypatch, m, k, n, repad):
    jqt, tqt = _pack(k, n, seed=m + k, repad=repad)
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, k)).astype(np.float32)
    xj, xt = jax_bf16(x), torch_bf16(jax_bf16(x))

    before = _build.plain_dispatches["qmatmul"]
    got = bf16_to_f32(torch_to_numpy(tm.qmatmul(xt, tqt)))
    assert _build.plain_dispatches["qmatmul"] == before + 1
    assert got.shape == (m, n)

    if repad:  # the JAX entry zero-pads x for the K-repadded pack
        xj = jnp.pad(xj, ((0, 0), (0, repad - k)))
    xla = bf16_to_f32(to_numpy(jm.qmatmul_xla(xj, jqt)))
    kern = bf16_to_f32(to_numpy(jm.qmatmul(xj, jqt, interpret=True)))
    scale = np.abs(xla).max()
    tight, loose = 2 * ULP * scale, 8 * ULP * scale
    np.testing.assert_allclose(got, xla, rtol=0,
                               atol=tight if m > 32 else loose)
    np.testing.assert_allclose(got, kern, rtol=0,
                               atol=tight if m <= 32 else loose)


def test_compute_dtype_rule():
    assert tm.compute_dtype(torch.bfloat16, 32) == torch.float32
    assert tm.compute_dtype(torch.bfloat16, 33) == torch.bfloat16
    assert tm.compute_dtype(torch.float32, 33) == torch.float32


def test_kernel_eligibility():
    _, tqt = _pack(256, 192)
    assert tm.kernel_eligible(tqt)
    f32 = dataclasses.replace(tqt, scales=tqt.scales.float())
    assert not tm.kernel_eligible(f32)       # kernel A reads bf16 scales
    asym = dataclasses.replace(
        tqt, zeros=torch.zeros_like(tqt.scales, dtype=torch.uint8))
    assert not tm.kernel_eligible(asym)      # symmetric packs only


def test_qmatmul_off_the_cpu_goes_to_the_kernel_or_raises():
    """Only a CPU tensor runs the plain version: a tensor on another device
    (meta here, which no kernel takes) reaches kernel A's checks and raises,
    and no plain dispatch is counted."""
    _, tqt = _pack(256, 192)
    meta = dataclasses.replace(tqt, data=[w.to("meta") for w in tqt.data],
                               scales=tqt.scales.to("meta"))
    x = torch.zeros((4, 256), dtype=torch.bfloat16, device="meta")
    before = _build.plain_dispatches["qmatmul"]
    with pytest.raises(ValueError, match="kernel A"):
        tm.qmatmul(x, meta)
    assert _build.plain_dispatches["qmatmul"] == before
