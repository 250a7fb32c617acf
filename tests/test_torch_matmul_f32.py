"""`qmatmul` on float32 activations (the JAX kernels' float32 branch, the
path of quantized Whisper): the port's plain version on the CPU against the
JAX package's `qmatmul_xla` and its Pallas launchers in interpret mode
(`_qmatmul_pallas_2d` for the int and LUT packs, `_qmatmul_planar_2d` for
the planar ones), with float32 x drawn from a seed with numpy.

At float32 x every route computes in float32 at every M (`_compute_dtype`)
and writes float32.  The port and `qmatmul_xla` dot float32 x with the same
exact float32 dequantized weights; the Pallas bodies dot raw codes and
scale after the dot (the int body at g >= 128 takes the zero point through
the row sum of x).  So the outputs differ by where float32 rounds: the
order of the sums over K = 4096 and the place of the scale.  Measured at
most 24 float32 ulps (2**-23 relative) of max|out| over these cases (at
M = 1, where max|out| over 64 outputs is smallest); the tolerance is
F32_ULPS = 64 of them.  Rounding x through bf16 moves the output by 8,000
ulps or more, which each case checks against ten tolerances: a route that
rounded x to bf16 could not pass.
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from neural_speed_tpu.ops import matmul as jm
from neural_speed_tpu.ops.qtypes import named_qspec as jax_named_qspec
from neural_speed_tpu_torch import _build
from neural_speed_tpu_torch.ops import matmul as tm

from tests.torch_port_util import port_qtensor

jq = importlib.import_module("neural_speed_tpu.ops.quantize")

torch.set_num_threads(1)

ULP32 = 2.0 ** -23
F32_ULPS = 64
_K, _N = 4096, 64     # K = 32 bands x 128: every plane's bands hold whole groups

# name -> (format, symmetric, scale dtype, float offsets, JAX launcher)
FORMATS = {
    "int8-sym-f32": ("int8", True, "float32", False, "int"),
    "int4-sym-bf16": ("int4", True, "bfloat16", False, "int"),   # kernel A's pack
    "int4-asym": ("int4", False, "float32", False, "int"),
    "nf4": ("nf4", True, "float32", False, "int"),
    "fp4": ("fp4", True, "float32", False, "int"),
    "int5-asym": ("int5", False, "float32", False, "planar"),
    "int3": ("int3", True, "float32", False, "planar"),
    "fp8_e4m3": ("fp8_e4m3", True, "float32", False, "planar"),
    "int4-float-offset": ("int4", True, "float32", True, "planar"),
}


def _quantized(fmt: str, seed: int):
    name, sym, sdt, offsets, _ = FORMATS[fmt]
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((_K, _N)).astype(np.float32) * 0.05
    jqt = jq.quantize(jnp.asarray(w), jax_named_qspec(name, 128, sym,
                                                      scale_dtype=sdt))
    if offsets:          # ggml convention: w = scale * code + m
        offs = rng.uniform(-0.1, 0.1, jqt.scales.shape).astype(np.float32)
        jqt = dataclasses.replace(jqt, zeros=jnp.asarray(offs))
    return jqt, port_qtensor(jqt)


def _x(m: int, seed: int) -> np.ndarray:
    """float32 x whose low mantissa bits matter: normal draws times a
    factor that is not a power of two, so that no value is a bf16 one."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, _K)) * 1.37).astype(np.float32)


@pytest.mark.parametrize("m", [1, 4, 40])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_qmatmul_f32_matches_jax(fmt, m):
    jqt, tqt = _quantized(fmt, seed=len(fmt))
    x = _x(m, seed=m + len(fmt))
    assert tm.compute_dtype(torch.float32, m) == torch.float32
    before = _build.plain_dispatches["qmatmul"]
    got = tm.qmatmul(torch.from_numpy(x), tqt)
    assert _build.plain_dispatches["qmatmul"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (m, _N)
    got = got.numpy()

    xj = jnp.asarray(x)
    xla = jm.qmatmul_xla(xj, jqt)
    if FORMATS[fmt][4] == "int":
        assert jm._pallas_supported(jqt)
        kern = jm._qmatmul_pallas_2d(xj, jqt, interpret=True)
    else:
        assert jm._planar_supported(jqt)
        kern = jm._qmatmul_planar_2d(xj, jqt, interpret=True)
    assert xla.dtype == kern.dtype == jnp.float32
    xla, kern = np.asarray(xla), np.asarray(kern)
    scale = np.abs(xla).max()
    tol = F32_ULPS * ULP32 * scale
    np.testing.assert_allclose(got, xla, rtol=0, atol=tol)
    np.testing.assert_allclose(got, kern, rtol=0, atol=tol)

    # the tolerance sees a bf16 route: x rounded to bf16 moves the output
    # far beyond it
    xb = torch.from_numpy(x).to(torch.bfloat16).float()
    moved = np.abs(tm.qmatmul(xb, tqt).numpy() - got).max()
    assert moved > 10 * tol, moved / scale


def test_float32_x_routes_kernel_a_packs_to_p_int():
    """Float32 x sends kernel A's pack (int4 / symmetric / bf16 scales) to P's
    one-plane INT instances; bf16 x keeps kernel A; other packs keep their
    kernel at both dtypes."""
    _, a_pack = _quantized("int4-sym-bf16", seed=1)
    assert tm.kernel_for(a_pack) == "A"
    assert tm.kernel_route(a_pack, torch.bfloat16) == "A"
    assert tm.kernel_route(a_pack, torch.float32) == "I"
    # the INT instances' wrapper takes kernel A's pack as stored
    assert tm._planes_ok(a_pack) and tm._fp_shape_ok(a_pack)
    for fmt, letter in (("int8-sym-f32", "I"), ("int4-asym", "I"),
                        ("nf4", "F"), ("fp4", "F"), ("int5-asym", "P"),
                        ("int3", "P"), ("fp8_e4m3", "P"),
                        ("int4-float-offset", "P")):
        _, qt = _quantized(fmt, seed=1)
        assert tm.kernel_for(qt) == letter, fmt
        for dt in (torch.bfloat16, torch.float32):
            assert tm.kernel_route(qt, dt) == letter, (fmt, dt)


def _to_meta(qt):
    opt = lambda a: None if a is None else a.to("meta")
    return dataclasses.replace(qt, data=[d.to("meta") for d in qt.data],
                               scales=qt.scales.to("meta"),
                               zeros=opt(qt.zeros), sscale=opt(qt.sscale))


@pytest.mark.parametrize("fmt,what", [
    ("int4-sym-bf16", "kernel P \\(one-plane INT\\)"), ("nf4", "kernel F"),
    ("int5-asym", "kernel P ")])
def test_float32_x_off_the_cpu_reaches_the_kernel_wrappers(fmt, what):
    """Off the CPU, float32 x reaches the wrapper of `kernel_route`'s kernel
    (meta tensors: its device check raises, naming the kernel), never the
    plain version; float32 x with a bf16 output and float16 x raise there
    too, naming the dtypes."""
    _, qt = _quantized(fmt, seed=2)
    meta = _to_meta(qt)
    before = _build.plain_dispatches["qmatmul"]
    for dt, out in ((torch.float32, None), (torch.float32, torch.bfloat16),
                    (torch.float16, None)):
        x = torch.zeros((4, _K), dtype=dt, device="meta")
        # float16 x is no float32 x: kernel A's pack stays with kernel A
        name = "kernel A" if (dt, fmt) == (torch.float16,
                                           "int4-sym-bf16") else what
        with pytest.raises(ValueError, match=name) as err:
            tm.qmatmul(x, meta, out)
        assert str(dt) in str(err.value)
    assert _build.plain_dispatches["qmatmul"] == before
