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


# ---------------------------------------------------------------------------
# the other weight formats: NF4/FP4, odd widths, FP8, float offsets
# ---------------------------------------------------------------------------

from neural_speed_tpu.ops.qtypes import named_qspec as jax_named_qspec
from tests.torch_port_util import port_qtensor

_K, _N = 4096, 64      # K = 32 bands x 128: every plane's bands hold whole groups

FORMATS = {
    "nf4": ("nf4", True), "fp4": ("fp4", True),
    "int3": ("int3", True), "int3-asym": ("int3", False),
    "int5": ("int5", True), "int5-asym": ("int5", False),
    "int6": ("int6", True), "int6-asym": ("int6", False),
    "int7": ("int7", True), "int7-asym": ("int7", False),
    "fp8_e4m3": ("fp8_e4m3", True), "fp8_e5m2": ("fp8_e5m2", True),
    "int4-float-offset": ("int4", True),
}


def _quantized(fmt, scale_dtype="float32", seed=0, n=_N):
    """A JAX pack of random normal weights in format `fmt`, and the port's
    copy of it."""
    name, sym = FORMATS.get(fmt) or (fmt.removesuffix("-asym"),
                                     not fmt.endswith("-asym"))
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((_K, n)).astype(np.float32) * 0.05
    jqt = jq.quantize(jnp.asarray(w), jax_named_qspec(
        name, 128, sym, scale_dtype=scale_dtype))
    if fmt == "int4-float-offset":   # ggml convention: w = scale * code + m
        offs = rng.uniform(-0.1, 0.1, jqt.scales.shape).astype(np.float32)
        jqt = dataclasses.replace(jqt, zeros=jnp.asarray(offs))
    return jqt, port_qtensor(jqt)


@pytest.mark.parametrize("m", [1, 64])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_qmatmul_formats_match_jax(fmt, m):
    """The plain `qmatmul` against `qmatmul_xla` and the Pallas bodies
    (`_gemm_kernel_lut`, `_gemm_kernel_planar`) in interpret mode, with the
    tolerances of the module docstring: 2 bf16 ulps where both sides take
    the same dequantized values, 8 where one side rounds the weight to bf16
    and the other does not (at M > 32 the LUT body rounds table value, scale
    and product to bf16, and the planar body dots raw codes and scales after
    the dot)."""
    jqt, tqt = _quantized(fmt, seed=len(fmt))
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, _K)).astype(np.float32)
    xj, xt = jax_bf16(x), torch_bf16(jax_bf16(x))
    got = bf16_to_f32(torch_to_numpy(tm.qmatmul(xt, tqt)))
    xla = bf16_to_f32(to_numpy(jm.qmatmul_xla(xj, jqt)))
    launcher = (jm._qmatmul_pallas_2d if fmt in ("nf4", "fp4")
                else jm._qmatmul_planar_2d)
    assert (jm._pallas_supported(jqt) if fmt in ("nf4", "fp4")
            else jm._planar_supported(jqt))
    kern = bf16_to_f32(to_numpy(launcher(xj, jqt, interpret=True)))
    scale = np.abs(xla).max()
    tight, loose = 2 * ULP * scale, 8 * ULP * scale
    np.testing.assert_allclose(got, xla, rtol=0,
                               atol=tight if m > 32 else loose)
    np.testing.assert_allclose(got, kern, rtol=0,
                               atol=tight if m <= 32 else loose)


INT8_FORMATS = ["int4", "int4-asym", "int8", "int2", "int3", "int5-asym",
                "int6", "int7-asym"]


@pytest.mark.parametrize("per_token", [False, True])
@pytest.mark.parametrize("fmt", INT8_FORMATS)
def test_qmatmul_int8_matches_jax(fmt, per_token):
    """The plain `qmatmul_int8` on float32 activations against the Pallas
    bodies (`_int8_kernel`, `_int8_kernel_planar`) in interpret mode and,
    for symmetric packs, the XLA einsum.  Both sides quantize the
    activations to the same int8 values and their integer partials are
    exact, so only the order of the float32 sum over the K / 128 = 32 groups
    differs: 32 float32 ulps of the largest output."""
    name, _, asym = fmt.partition("-")
    rng = np.random.default_rng(len(fmt))
    w = rng.standard_normal((_K, _N)).astype(np.float32) * 0.05
    jqt = jq.quantize(jnp.asarray(w), jax_named_qspec(name, 128, not asym))
    tqt = port_qtensor(jqt)
    x = rng.standard_normal((64, _K)).astype(np.float32)
    before = _build.plain_dispatches["qmatmul_int8"]
    got = tm.qmatmul_int8(torch.from_numpy(x), tqt, per_token=per_token)
    assert _build.plain_dispatches["qmatmul_int8"] == before + 1
    assert got.dtype == torch.float32
    kern = np.asarray(jm.qmatmul_int8(jnp.asarray(x), jqt, interpret=True,
                                      per_token=per_token))
    tol = 32 * 2.0 ** -23 * np.abs(kern).max()
    np.testing.assert_allclose(got.numpy(), kern, rtol=0, atol=tol)
    if not asym:
        xla = np.asarray(jm.qmatmul_int8(jnp.asarray(x), jqt, force_xla=True,
                                         per_token=per_token))
        np.testing.assert_allclose(got.numpy(), xla, rtol=0, atol=tol)


@pytest.mark.parametrize("g", [128, 4096])
def test_act_quant_bit_identical(g):
    rng = np.random.default_rng(g)
    x = rng.standard_normal((40, _K)).astype(np.float32) * 3.0
    x[3] = 0.0                       # an all-zero row: the scale clamps
    xq_j, as_j = jm._act_quant(jnp.asarray(x), g)
    xq_t, as_t = tm._act_quant(torch.from_numpy(x), g)
    np.testing.assert_array_equal(xq_t.numpy(), np.asarray(xq_j))
    np.testing.assert_array_equal(as_t.numpy(), np.asarray(as_j))


def test_qmatmul_int8_routes_like_the_reference():
    """Non-INT packs, float offsets, 8-bit asymmetric (and 1-bit) go to
    `qmatmul`; widths 4 and 8 to kernel G, 2/3/5/6/7 to kernel H."""
    route = lambda fmt, **kw: tm.int8_kernel_for(_quantized(fmt, **kw)[1])
    assert route("nf4") == "" and route("fp8_e4m3") == ""
    assert route("int4-float-offset") == ""
    assert route("int4") == "G" and route("int8") == "G"
    assert [route(f"int{b}") for b in (2, 3, 5, 6, 7)] == ["H"] * 5
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal((256, 16)).astype(np.float32))
    asym8 = port_qtensor(jq.quantize(w, jax_named_qspec("int8", 128, False)))
    one = port_qtensor(jq.quantize(w, jax_named_qspec("int1", 128)))
    assert tm.int8_kernel_for(asym8) == "" and tm.int8_kernel_for(one) == ""
    x = torch.from_numpy(rng.standard_normal((40, 256)).astype(np.float32))
    torch.testing.assert_close(tm.qmatmul_int8(x, asym8), tm.qmatmul(x, asym8))


def test_kernel_choice_by_pack():
    pick = lambda fmt, **kw: tm.kernel_for(_quantized(fmt, **kw)[1])
    assert pick("int4", scale_dtype="bfloat16") == "A"
    # the rest of row 1: P's one-plane INT instances
    assert pick("int4") == "I"                      # float32 scales
    assert pick("int4-asym", scale_dtype="bfloat16") == "I"
    assert pick("int1") == pick("int2") == pick("int8") == "I"
    assert pick("int8-asym") == "I"
    assert pick("nf4") == "F" and pick("fp4", scale_dtype="bfloat16") == "F"
    for fmt in ("int3", "int5-asym", "int6", "int7", "fp8_e4m3", "fp8_e5m2",
                "int4-float-offset"):
        assert pick(fmt) == "P", fmt
    assert tm.kernel_k_multiple(_quantized("int5")[1].spec) == 32
    assert tm.kernel_k_multiple(_quantized("int6")[1].spec) == 16
    assert tm.kernel_k_multiple(_quantized("fp8_e4m3")[1].spec) == 1


def _to_meta(qt):
    mv = lambda t: None if t is None else t.to("meta")
    return dataclasses.replace(qt, data=tuple(d.to("meta") for d in qt.data),
                               scales=mv(qt.scales), zeros=mv(qt.zeros),
                               sscale=mv(qt.sscale))


@pytest.mark.parametrize("fmt,letter", [
    ("nf4", "kernel F"), ("int5-asym", "kernel P"), ("fp8_e4m3", "kernel P"),
    ("int4-float-offset", "kernel P"), ("int4", "kernel P \\(one-plane INT"),
    ("int8-asym", "kernel P \\(one-plane INT"), ("int1", "kernel P \\(one")])
def test_new_qmatmul_kernels_never_run_plain_off_the_cpu(fmt, letter):
    """A tensor on another device (meta, which no kernel takes) reaches the
    kernel's own checks and raises; no plain dispatch is counted."""
    meta = _to_meta(_quantized(fmt)[1])
    x = torch.zeros((4, _K), dtype=torch.bfloat16, device="meta")
    before = dict(_build.plain_dispatches)
    with pytest.raises(ValueError, match=letter):
        tm.qmatmul(x, meta)
    assert dict(_build.plain_dispatches) == before


@pytest.mark.parametrize("fmt", ["int4", "int3"])
@pytest.mark.parametrize("per_token", [False, True])
def test_int8_kernels_never_run_plain_off_the_cpu(fmt, per_token):
    meta = _to_meta(_quantized(fmt)[1])
    x = torch.zeros((64, _K), dtype=torch.bfloat16, device="meta")
    before = dict(_build.plain_dispatches)
    with pytest.raises(ValueError, match="kernels G and H"):
        tm.qmatmul_int8(x, meta, per_token=per_token)
    assert dict(_build.plain_dispatches) == before


@pytest.mark.parametrize("fmt,named", [
    ("int2", "int2 symmetric=True"), ("int4", "scales=float32"),
    ("int8", "int8 symmetric=True")])
def test_unsupported_pack_off_the_cpu_raises_naming_the_format(fmt, named):
    """A pack in K slabs (`k_shards > 1`, which the JAX package runs on
    XLA) has no kernel: off the CPU it raises naming the format."""
    jqt = _quantized(fmt)[0]
    meta = _to_meta(port_qtensor(jq.repack(jqt, 2)))
    x = torch.zeros((4, _K), dtype=torch.bfloat16, device="meta")
    before = dict(_build.plain_dispatches)
    with pytest.raises(ValueError, match="no CUDA kernel takes this pack") as e:
        tm.qmatmul(x, meta)
    assert named in str(e.value)
    assert dict(_build.plain_dispatches) == before
