"""Carry parameters across from numpy (for example from a JAX pytree).

`params_from_numpy(tree)` takes nested dicts / lists of numpy arrays.  A
packed weight arrives as a dict with the keys
`{"data": [...], "scales", "zeros", "sscale", "spec": {...}, "shape"}`
(optionally `"k_shards"`); `spec` holds the `QSpec` fields with `qtype` as
its string value.  A stack of MoE experts arrives as the same dict with
`"n_experts"` added (planes `[E, KW, N]`, scales `[E, K/g, N]`) and becomes
a `StackedExperts`.  Dtype conventions:

* bfloat16 arrays arrive as their uint16 bit patterns and become
  `torch.bfloat16` views;
* uint32 plane words arrive as their int32 bit views and stay int32;
* fp8 rows arrive as their uint8 bit patterns and stay uint8 (the port's
  storage for FP8 codes);
* uint8 zero points, float32 offsets, int8 double-quantized scales with
  their float32 `sscale`, and a custom `spec["lut"]` carry across as they
  are.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .._build import resolve_device
from ..ops.moe import StackedExperts
from ..ops.qtypes import QSpec, QType
from ..ops.quantize import QTensor


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    if a.dtype == np.uint32:
        raise TypeError("pass uint32 plane words as their int32 view")
    return torch.from_numpy(a.copy()).to(device)


def qspec_from_dict(d: dict) -> QSpec:
    fields = dict(d)
    fields["qtype"] = QType(fields["qtype"])
    if fields.get("lut") is not None:
        fields["lut"] = tuple(fields["lut"])
    return QSpec(**fields)


def _is_qtensor(node: Any) -> bool:
    return isinstance(node, dict) and "data" in node and "spec" in node


def _is_stacked(node: Any) -> bool:
    return _is_qtensor(node) and "n_experts" in node


def params_from_numpy(tree: Any, device=None) -> Any:
    """The port's params for `tree`, on `device` (the card unless the CPU is
    asked for)."""
    dev = resolve_device(device)
    opt = lambda a: None if a is None else tensor_from_numpy(a, dev)

    def walk(node):
        if _is_stacked(node):  # before _is_qtensor, which it also passes
            return StackedExperts(
                tuple(tensor_from_numpy(p, dev) for p in node["data"]),
                tensor_from_numpy(node["scales"], dev), opt(node.get("zeros")),
                qspec_from_dict(node["spec"]),
                tuple(int(s) for s in node["shape"]), int(node["n_experts"]),
                int(node.get("k_shards", 1)))
        if _is_qtensor(node):
            return QTensor(
                tuple(tensor_from_numpy(p, dev) for p in node["data"]),
                tensor_from_numpy(node["scales"], dev), opt(node.get("zeros")),
                opt(node.get("sscale")), qspec_from_dict(node["spec"]),
                tuple(int(s) for s in node["shape"]),
                int(node.get("k_shards", 1)))
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        if isinstance(node, np.ndarray):
            return tensor_from_numpy(node, dev)
        return node

    return walk(tree)
