"""The packs of the JAX package's int kernel that kernel A does not take
(INT 1/2/4/8 with uint8 zero points, float32 or double-quantized scales),
and float offsets at widths 2 and 8, through the port's `qmatmul` and
`grouped_qmatmul` (their plain versions, on the CPU) against the JAX
package's XLA paths (`qmatmul_xla`, `_grouped_xla`) and, where its gates
send the pack to Pallas, its kernels in interpret mode.

Tolerances, in bf16 ulps (2**-8 relative) of the largest output, as
tests/test_torch_matmul.py states them: 2 where both sides take the same
dequantized values (M > 32 against XLA: the weight rounded once to bf16;
M <= 32 against the kernel: exact float32 weights), 8 where one side
rounds the weight to bf16 and the other does not (M <= 32 against XLA;
M > 32 against the int kernel, which for g >= 128 dots raw codes and
applies `(d - xsum * z) * s` after the dot).  Grouped outputs are float32:
1e-5 of the largest output against `_grouped_xla` (the same bf16 weights,
float32 sums in another order), 2 bf16 ulps against the Pallas kernel
(its launcher rounds the scales to bf16 before use).
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu.ops import matmul as jm
from neural_speed_tpu.ops import moe as jmoe
from neural_speed_tpu.ops.qtypes import named_qspec as jax_named_qspec
from neural_speed_tpu_torch import _build
from neural_speed_tpu_torch.models.params import params_from_numpy
from neural_speed_tpu_torch.ops import matmul as tm
from neural_speed_tpu_torch.ops import moe as tmoe

from tests.torch_port_util import (bf16_to_f32, jax_bf16, port_qtensor,
                                   to_numpy, torch_bf16, torch_to_numpy,
                                   tree_to_numpy)

jq = importlib.import_module("neural_speed_tpu.ops.quantize")

torch.set_num_threads(1)
ULP = 2.0 ** -8
K, N = 4096, 64

# name: (width, symmetric, group, scale dtype, double-quant, float offsets)
FORMATS = {
    "int4-asym-f32 (GPTQ)": (4, False, 128, "float32", False, False),
    "int4-f32-g32 (Q4_0)": (4, True, 32, "float32", False, False),
    "int8-f32-g32 (Q8_0)": (8, True, 32, "float32", False, False),
    "int8-asym": (8, False, 128, "bfloat16", False, False),
    "int2": (2, True, 128, "bfloat16", False, False),
    "int2-asym": (2, False, 128, "float32", False, False),
    "int1": (1, True, 128, "bfloat16", False, False),
    "int4-dq": (4, True, 128, "float32", True, False),
    "int2-offsets-g16 (Q2_K)": (2, False, 16, "float32", False, True),
    "int2-offsets-g128": (2, False, 128, "float32", False, True),
    "int8-offsets-g16": (8, False, 16, "float32", False, True),
    "int8-offsets-g128": (8, False, 128, "float32", False, True),
}


def _pack(fmt, seed=0, k=K, n=N):
    bits, sym, g, sdt, dq, offsets = FORMATS[fmt]
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    jqt = jq.quantize(jnp.asarray(w), jax_named_qspec(
        f"int{bits}", g, sym, scale_dtype=sdt, double_quant=dq))
    if offsets:   # ggml convention: w = scale * code + m
        offs = rng.uniform(-0.1, 0.1, jqt.scales.shape).astype(np.float32)
        jqt = dataclasses.replace(jqt, zeros=jnp.asarray(offs))
    return jqt, port_qtensor(jqt)


@pytest.mark.parametrize("m", [1, 64])
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_qmatmul_int_formats_match_jax(fmt, m):
    jqt, tqt = _pack(fmt, seed=len(fmt))
    offsets = FORMATS[fmt][5]
    assert tm.kernel_for(tqt) == ("P" if offsets else "I")
    assert tm.kernel_takes(tqt)
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, K)).astype(np.float32)
    xj, xt = jax_bf16(x), torch_bf16(jax_bf16(x))
    before = _build.plain_dispatches["qmatmul"]
    got = bf16_to_f32(torch_to_numpy(tm.qmatmul(xt, tqt)))
    assert _build.plain_dispatches["qmatmul"] == before + 1
    xla = bf16_to_f32(to_numpy(jm.qmatmul_xla(xj, jqt)))
    scale = np.abs(xla).max()
    tight, loose = 2 * ULP * scale, 8 * ULP * scale
    np.testing.assert_allclose(got, xla, rtol=0,
                               atol=tight if m > 32 else loose)
    if jm._pallas_supported(jqt):
        kern = jm._qmatmul_pallas_2d(xj, jqt, interpret=True)
    elif jm._planar_supported(jqt):
        kern = jm._qmatmul_planar_2d(xj, jqt, interpret=True)
    else:   # Q2_K-style g = 16 offsets: the JAX package runs them on XLA
        assert offsets and FORMATS[fmt][2] < 128
        return
    kern = bf16_to_f32(to_numpy(kern))
    np.testing.assert_allclose(got, kern, rtol=0,
                               atol=tight if m <= 32 else loose)


STACKS = ["int4-asym-f32 (GPTQ)", "int4-f32-g32 (Q4_0)", "int8-asym", "int2",
          "int2-asym", "int1"]


@pytest.mark.parametrize("fmt", STACKS)
def test_grouped_int_stacks_match_jax(fmt):
    """`grouped_qmatmul` (bf16 rows) and `grouped_qmatmul_rows` on stacks of
    3 experts, against `_grouped_xla` and the Pallas kernel in interpret
    mode, and the per-row entry against each row's `qmatmul_xla` in
    float32 (exact weights)."""
    e, k, n, bm, n_blocks = 3, 1024, 128, 8, 6
    jqts = [_pack(fmt, seed=10 + i, k=k, n=n)[0] for i in range(e)]
    jst = jmoe.stack_experts(jqts)
    st = params_from_numpy({"s": tree_to_numpy(jst)}, device="cpu")["s"]
    assert tmoe.grouped_kernel_for(st) == "fp"
    assert tmoe.grouped_kernel_takes(st)
    assert jmoe._stack_kernel_ok(jst)
    rng = np.random.default_rng(3)
    be = rng.integers(0, e, n_blocks).astype(np.int32)
    xs = jax_bf16(rng.standard_normal((n_blocks * bm, k)).astype(np.float32))
    got = tmoe.grouped_qmatmul(torch_bf16(xs), st, torch.from_numpy(be),
                               bm).numpy()
    scale = np.abs(got).max()
    want = np.asarray(jmoe._grouped_xla(xs, jst, jnp.asarray(be), bm))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    pallas = np.asarray(jmoe.grouped_qmatmul(xs, jst, jnp.asarray(be), bm,
                                             interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=2 * ULP * scale)

    rows = rng.standard_normal((2, k)).astype(np.float32)
    row_e = np.array([2, 0], np.int32)
    got = tmoe.grouped_qmatmul_rows(torch_bf16(jax_bf16(rows)), st,
                                    torch.from_numpy(row_e)).numpy()
    want = np.stack([np.asarray(jm.qmatmul_xla(
        jax_bf16(rows[j:j + 1]).astype(jnp.float32), jqts[row_e[j]],
        jnp.float32))[0] for j in range(2)])
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
