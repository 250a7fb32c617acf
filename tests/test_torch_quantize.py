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

import jax
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


# ---------------------------------------------------------------------------
# RTN quantize and the load-time transforms, bit for bit
# ---------------------------------------------------------------------------

from neural_speed_tpu.convert.quant_config import (
    load_quant_config as jax_load_quant_config)
from neural_speed_tpu.ops.qtypes import named_qspec as jax_named_qspec
from neural_speed_tpu_torch.convert.quant_config import load_quant_config
from neural_speed_tpu_torch.ops.qtypes import QType, named_qspec

from tests.torch_port_util import assert_qtensor_equal, port_qtensor

_CUSTOM_LUT = tuple(float(v) for v in np.linspace(-1.0, 1.0, 16) ** 3)

# (dtype name, symmetric, extra QSpec fields, k_shards)
QUANT_CASES = (
    [(f"int{b}", True, {}, 1) for b in range(1, 9)]
    + [(f"int{b}", False, {}, 1) for b in range(2, 9)]
    + [("nf4", True, {}, 1), ("fp4", True, {}, 1),
       ("nf4", True, {"lut": _CUSTOM_LUT}, 1),
       ("fp8_e4m3", True, {}, 1), ("fp8_e5m2", True, {}, 1),
       ("int4", True, {"double_quant": True}, 1),
       ("nf4", True, {"double_quant": True}, 1),
       ("int4", True, {"scale_dtype": "bfloat16"}, 1),
       ("int5", False, {"scale_dtype": "bfloat16"}, 1),
       ("int4", True, {"group_size": -1}, 1),
       ("int3", False, {"group_size": -1}, 1),
       ("int4", True, {}, 2), ("int7", False, {}, 2), ("nf4", True, {}, 2)])


def _specs(name, sym, extra):
    import dataclasses

    kw = dict(group_size=extra.get("group_size", 64), symmetric=sym,
              scale_dtype=extra.get("scale_dtype", "float32"),
              double_quant=extra.get("double_quant", False))
    js, ts = jax_named_qspec(name, **kw), named_qspec(name, **kw)
    if "lut" in extra:
        js = dataclasses.replace(js, lut=extra["lut"])
        ts = dataclasses.replace(ts, lut=extra["lut"])
    return js, ts


def _weight(k, n, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.05
    w[0, 0] = 0.0          # an exact zero, and a column of one group that is
    w[:64, 1] = 0.0        # all zero (its scale clamps to the epsilon)
    return w


@pytest.mark.parametrize("name,sym,extra,k_shards", QUANT_CASES, ids=[
    f"{n}-{'sym' if s else 'asym'}-{'-'.join(map(str, e)) or 'plain'}-ks{ks}"
    for n, s, e, ks in QUANT_CASES])
def test_quantize_bit_identical(name, sym, extra, k_shards):
    """Planes, scales, zeros and sscale of `quantize` equal the JAX
    package's on the same float32 weight, and `dequantize` of the result is
    exact in float32 and bf16."""
    js, ts = _specs(name, sym, extra)
    w = _weight(256, 24, seed=len(name) + 7 * sym + k_shards)
    want = jq.quantize(jnp.asarray(w), js, k_shards)
    got = tq.quantize(torch.from_numpy(w), ts, k_shards)
    assert_qtensor_equal(want, got)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(
            torch_to_numpy(tq.dequantize(got, tdt)),
            to_numpy(jq.dequantize(want, jdt)))
    np.testing.assert_allclose(
        float(tq.quantization_error(torch.from_numpy(w), ts)),
        float(jq.quantization_error(jnp.asarray(w), js)), rtol=1e-5)


def test_lut_helpers_match():
    js, ts = _specs("nf4", True, {"lut": _CUSTOM_LUT})
    codes = np.arange(16, dtype=np.uint8)
    np.testing.assert_array_equal(
        tq.decode_lut(torch.from_numpy(codes), ts).numpy(),
        np.asarray(jq.decode_lut(jnp.asarray(codes), js)))
    np.testing.assert_array_equal(tq.lut_values(ts).numpy(),
                                  np.asarray(jq.lut_values(js)))
    # the table tensor is built once per (table, device)
    assert tq.lut_values(ts).data_ptr() == tq.lut_values(ts).data_ptr()


@pytest.mark.parametrize("name,sym", [("int4", True), ("int3", False),
                                      ("nf4", True), ("int8", True),
                                      ("fp8_e4m3", True)])
def test_repack_and_split_n_bit_identical(name, sym):
    js, ts = _specs(name, sym, {})
    w = _weight(256, 40, seed=3)
    want = jq.quantize(jnp.asarray(w), js)
    got = tq.quantize(torch.from_numpy(w), ts)
    assert_qtensor_equal(jq.repack(want, 2), tq.repack(got, 2))
    assert_qtensor_equal(jq.repack(jq.repack(want, 2), 1),
                         tq.repack(tq.repack(got, 2), 1))
    for jpart, tpart in zip(jq.split_n(want, (16, 24)),
                            tq.split_n(got, (16, 24))):
        assert_qtensor_equal(jpart, tpart)
        assert all(d.is_contiguous() for d in tpart.data)
    with pytest.raises(ValueError):
        tq.split_n(got, (16, 16))
    # concat_n is the inverse, for every family (zero points, fp8 rows)
    assert_qtensor_equal(want, tq.concat_n(list(tq.split_n(got, (16, 24)))))


@pytest.mark.parametrize("bits,sym", [(3, True), (5, False), (6, True),
                                      (7, False), (4, True)])
def test_widen_bits_bit_identical(bits, sym):
    js, ts = _specs(f"int{bits}", sym, {})
    w = _weight(256, 24, seed=bits)
    want = jq.widen_bits(jq.quantize(jnp.asarray(w), js))
    got_in = tq.quantize(torch.from_numpy(w), ts)
    got = tq.widen_bits(got_in)
    assert_qtensor_equal(want, got)
    np.testing.assert_array_equal(tq.dequantize(got).numpy(),
                                  tq.dequantize(got_in).numpy())


def test_carried_formats_dequantize_exact():
    """FP8 rows (as uint8 views), uint8 and float32 zeros, double-quantized
    scales and a custom table survive `params_from_numpy`."""
    w = _weight(256, 24, seed=11)
    for name, sym, extra in [("fp8_e4m3", True, {}), ("fp8_e5m2", True, {}),
                             ("int5", False, {}),
                             ("int4", True, {"double_quant": True}),
                             ("fp4", True, {"lut": _CUSTOM_LUT})]:
        js, _ = _specs(name, sym, extra)
        jqt = jq.quantize(jnp.asarray(w), js)
        assert_qtensor_equal(jqt, port_qtensor(jqt))
    # ggml float offsets: w = scale * code + m
    js, _ = _specs("int4", True, {})
    jqt = jq.quantize(jnp.asarray(w), js)
    import dataclasses as dc
    offs = np.random.default_rng(5).uniform(-0.1, 0.1, jqt.scales.shape)
    jqt = dc.replace(jqt, zeros=jnp.asarray(offs, jnp.float32))
    tqt = port_qtensor(jqt)
    assert tqt.zeros.dtype == torch.float32
    np.testing.assert_array_equal(tq.dequantize(tqt).numpy(),
                                  np.asarray(jq.dequantize(jqt)))


def test_quantize_tree_and_quant_config_decisions():
    """The docstring's policy (int4 default, int8 `ffn.down`, fp32
    `lm_head`): the same decision at every leaf, and the same bits."""
    cfg = {"default": {"weight_dtype": "int4", "group_size": 64, "alg": "sym"},
           "overrides": [
               {"pattern": r"ffn\.down$", "weight_dtype": "int8",
                "group_size": 64},
               {"pattern": "lm_head", "weight_dtype": "fp32"},
               {"pattern": r"layers\.1\.q$", "weight_dtype": "nf4",
                "group_size": 64, "scale_dtype": "bf16"},
               {"pattern": r"layers\.1\.k$", "weight_dtype": "int5",
                "group_size": 64, "alg": "asym"}]}
    jpol, tpol = jax_load_quant_config(cfg), load_quant_config(cfg)
    rng = np.random.default_rng(0)
    mat = lambda k, n: rng.standard_normal((k, n)).astype(np.float32) * 0.05
    tree = {"embed": {"weight": mat(32, 128)},
            "layers": [{"q": {"w": mat(128, 128)}, "k": {"w": mat(128, 64)},
                        "ffn": {"down": {"w": mat(192, 128), "b": mat(1, 128)[0]},
                                "gate": {"w": mat(128, 192)}},
                        "odd": {"w": mat(100, 16)}}       # 64 does not divide K
                       for _ in range(2)],
            "lm_head": {"w": mat(128, 32)}}
    to_jax = lambda t: jax.tree_util.tree_map(jnp.asarray, t)
    to_torch = lambda t: jax.tree_util.tree_map(torch.from_numpy, t)
    want = jq.quantize_tree(to_jax(tree), jpol)
    got = tq.quantize_tree(to_torch(tree), tpol)

    def walk(w, g, path):
        if isinstance(w, jq.QTensor):
            assert isinstance(g, tq.QTensor), path
            assert_qtensor_equal(w, g)
        elif isinstance(w, dict):
            assert set(w) == set(g), path
            for key in w:
                walk(w[key], g[key], f"{path}.{key}")
        elif isinstance(w, list):
            for i, (wi, gi) in enumerate(zip(w, g)):
                walk(wi, gi, f"{path}.{i}")
        else:
            assert not isinstance(g, tq.QTensor), path
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    walk(want, got, "")
    l1 = got["layers"][1]
    assert l1["q"]["w"].spec.qtype == QType.NF4
    assert l1["q"]["w"].scales.dtype == torch.bfloat16
    assert l1["k"]["w"].zeros is not None and l1["k"]["w"].spec.bits == 5
    assert got["layers"][0]["ffn"]["down"]["w"].spec.bits == 8
    assert isinstance(got["lm_head"]["w"], torch.Tensor)
    assert isinstance(got["layers"][0]["odd"]["w"], torch.Tensor)
    for d in ({"weight_dtype": "bf16"}, {"weight_dtype": "fp8", "alg": "asym"}):
        assert (load_quant_config({"default": d})("x") is None) == (
            jax_load_quant_config({"default": d})("x") is None)


def test_named_qspec_matches():
    import dataclasses as dc

    for name in ("int1", "int3", "INT8", "nf4", "fp4", "fp4_e2m1", "fp8",
                 "fp8_e4m3", "fp8_e5m2"):
        j = jax_named_qspec(name, 32, False if name.lower().startswith("int")
                            else True, "bfloat16", True)
        t = named_qspec(name, 32, False if name.lower().startswith("int")
                        else True, "bfloat16", True)
        jd, td = dc.asdict(j), dc.asdict(t)
        jd["qtype"], td["qtype"] = j.qtype.value, t.qtype.value
        assert jd == td
    with pytest.raises(ValueError, match="unknown quant dtype"):
        named_qspec("q4_0")
