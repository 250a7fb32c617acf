"""Helpers for the tests that hold the PyTorch port against the JAX package.

They turn JAX pytrees (params with `QTensor` leaves, `KVCache`s) into the
numpy trees that `neural_speed_tpu_torch.models.params.params_from_numpy`
takes, with its dtype conventions: bfloat16 as uint16 bit patterns, uint32
plane words as int32 views, fp8 rows as their uint8 bit patterns.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import jax.numpy as jnp


def to_numpy(a) -> np.ndarray:
    """A JAX / numpy array as numpy, bf16 as uint16 bits, uint32 as int32,
    fp8 as uint8 bits."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return a.view(np.uint16)
    if a.dtype in (jnp.float8_e4m3fn, jnp.float8_e5m2):
        return a.view(np.uint8)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    return a


def tree_to_numpy(node):
    """JAX params (dicts / lists / QTensors / StackedExperts / arrays) ->
    numpy tree.  A `StackedExperts` becomes a packed-weight dict with an
    `n_experts` key."""
    from neural_speed_tpu.ops.moe import StackedExperts
    from neural_speed_tpu.ops.quantize import QTensor

    if isinstance(node, StackedExperts):
        spec = dataclasses.asdict(node.spec)
        spec["qtype"] = node.spec.qtype.value
        return {"data": [to_numpy(p) for p in node.data],
                "scales": to_numpy(node.scales),
                "zeros": None if node.zeros is None else to_numpy(node.zeros),
                "spec": spec, "shape": tuple(node.shape),
                "n_experts": node.n_experts, "k_shards": node.k_shards}
    if isinstance(node, QTensor):
        spec = dataclasses.asdict(node.spec)
        spec["qtype"] = node.spec.qtype.value
        opt = lambda a: None if a is None else to_numpy(a)
        return {"data": [to_numpy(p) for p in node.data],
                "scales": to_numpy(node.scales), "zeros": opt(node.zeros),
                "sscale": opt(node.sscale), "spec": spec,
                "shape": tuple(node.shape), "k_shards": node.k_shards}
    if isinstance(node, dict):
        return {k: tree_to_numpy(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [tree_to_numpy(v) for v in node]
    return to_numpy(node)


def torch_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A port tensor as numpy in the same conventions as `to_numpy`."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def bf16_to_f32(a: np.ndarray) -> np.ndarray:
    """uint16 bf16 bit patterns -> float32 values."""
    return (a.astype(np.uint32) << 16).view(np.float32)


def jax_bf16(a: np.ndarray):
    """float32 numpy values -> a JAX bf16 array (rounded to nearest even)."""
    return jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)


def torch_bf16(a) -> torch.Tensor:
    """A JAX bf16 array -> the port's bf16 tensor with the same bits."""
    return torch.from_numpy(to_numpy(a).view(np.int16).copy()).view(
        torch.bfloat16)


def assert_cache_equal(jax_cache, port_cache) -> None:
    """Codes, scales and lengths of two caches, byte for byte."""
    for name in ("k", "v", "k_scale", "v_scale"):
        want = to_numpy(getattr(jax_cache, name))
        got = torch_to_numpy(getattr(port_cache, name))
        np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_array_equal(torch_to_numpy(port_cache.lengths),
                                  np.asarray(jax_cache.lengths))


def port_qtensor(jqt):
    """A JAX `QTensor` carried across to the port, on the CPU."""
    from neural_speed_tpu_torch.models.params import params_from_numpy

    return params_from_numpy({"w": tree_to_numpy(jqt)}, device="cpu")["w"]


def assert_qtensor_equal(jqt, tqt) -> None:
    """Planes, scales, zeros, sscale (bit for bit), spec fields, shape and
    k_shards of a JAX `QTensor` and a port `QTensor`."""
    assert tuple(tqt.shape) == tuple(jqt.shape)
    assert tqt.k_shards == jqt.k_shards
    want_spec = dataclasses.asdict(jqt.spec)
    want_spec["qtype"] = jqt.spec.qtype.value
    got_spec = dataclasses.asdict(tqt.spec)
    got_spec["qtype"] = tqt.spec.qtype.value
    assert got_spec == want_spec
    assert len(tqt.data) == len(jqt.data)
    for i, (g, w) in enumerate(zip(tqt.data, jqt.data)):
        np.testing.assert_array_equal(torch_to_numpy(g), to_numpy(w),
                                      err_msg=f"plane {i}")
    for name in ("scales", "zeros", "sscale"):
        g, w = getattr(tqt, name), getattr(jqt, name)
        assert (g is None) == (w is None), name
        if g is not None:
            got, want = torch_to_numpy(g), to_numpy(w)
            assert got.dtype == want.dtype, name
            np.testing.assert_array_equal(got, want, err_msg=name)


def assert_tree_equal(jnode, tnode, path="") -> None:
    """A JAX params tree and the port's, leaf for leaf: QTensors as
    `assert_qtensor_equal`, arrays bit for bit with equal dtypes."""
    from neural_speed_tpu.ops.quantize import QTensor

    if isinstance(jnode, QTensor):
        assert_qtensor_equal(jnode, tnode)
    elif isinstance(jnode, dict):
        assert set(jnode) == set(tnode), path
        for key in jnode:
            assert_tree_equal(jnode[key], tnode[key], f"{path}.{key}")
    elif isinstance(jnode, list):
        assert len(jnode) == len(tnode), path
        for i, (a, b) in enumerate(zip(jnode, tnode)):
            assert_tree_equal(a, b, f"{path}.{i}")
    else:
        want, got = to_numpy(jnode), torch_to_numpy(tnode)
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
