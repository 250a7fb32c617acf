"""Checkpoint loaders: local safetensors / torch bins -> state dict (port of
`neural_speed_tpu/convert/loaders.py`).

The safetensors format is read directly (an 8-byte little-endian header
length, a JSON header, then raw little-endian tensor data), so no
`safetensors` package is needed.  Tensors come back on the CPU with their
stored dtypes (bf16 as `torch.bfloat16`).  Only local directories are
read: the JAX package's `transformers` fallback fetches from the hub, which
the port leaves out.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from typing import Any, Dict

import numpy as np
import torch

# safetensors dtype tags -> (numpy dtype of the stored bytes, torch dtype)
_ST_DTYPES = {
    "F64": (np.float64, torch.float64), "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16), "BF16": (np.int16, torch.bfloat16),
    "I64": (np.int64, torch.int64), "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16), "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8), "BOOL": (np.bool_, torch.bool),
    "F8_E4M3": (np.uint8, torch.float8_e4m3fn),
    "F8_E5M2": (np.uint8, torch.float8_e5m2),
}


def load_state_dict(model_name_or_path: str) -> Dict[str, Any]:
    """Every tensor of the `*.safetensors` (or else `pytorch_model*.bin`)
    files of a local directory."""
    path = model_name_or_path
    if not os.path.isdir(path):
        raise FileNotFoundError(
            f"{path!r} is not a local directory: the port reads local "
            f"checkpoints only (no hub download)")
    st_files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if st_files:
        return _load_safetensors(st_files)
    pt_files = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
    if pt_files:
        return _load_torch_bins(pt_files)
    raise FileNotFoundError(f"no checkpoint files under {path}")


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """One `.safetensors` file -> {name: CPU tensor}.  Each tensor is a copy
    out of a read-only memory map of the file."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        np_dt, t_dt = _ST_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        a = np.array(data[begin:end]).view(np.dtype(np_dt).newbyteorder("<"))
        t = torch.from_numpy(a.astype(a.dtype.newbyteorder("="), copy=False))
        out[name] = t.view(t_dt).reshape(info["shape"])
    return out


def _load_safetensors(files) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for f in files:
        out.update(read_safetensors(f))
    return out


def _load_torch_bins(files) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for f in files:
        out.update(torch.load(f, map_location="cpu", weights_only=True))
    return out
