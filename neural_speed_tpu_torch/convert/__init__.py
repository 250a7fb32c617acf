"""Model conversion entry points (port of `neural_speed_tpu/convert/__init__.py`).

`convert_model` dispatches by source format into the port's packed-QTensor
params: a GGUF file, a local directory holding a float HF checkpoint
(quantized at load with `qspec`, through `convert/hf.py`), or one holding a
pre-quantized GPTQ / AWQ / AutoRound checkpoint (`use_quantized_model=True`).
The directory's `config.json` is read with `json`.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from .._build import resolve_device
from ..models.configs import arch_from_hf_config
from ..ops.qtypes import QSpec


def convert_model(model_path: str, qspec: Optional[QSpec] = None,
                  use_quantized_model: bool = False, device=None):
    """Convert `model_path` (a local HF directory or a .gguf file) ->
    (params, cfg), converted on `device` (the card unless the CPU is asked
    for)."""
    dev = resolve_device(device)
    if model_path.endswith(".gguf"):
        from .gguf import load_gguf_model

        params, cfg, _tok = load_gguf_model(model_path, device=dev)
        return params, cfg

    with open(os.path.join(model_path, "config.json")) as f:
        hf_cfg = json.load(f)
    cfg = arch_from_hf_config(hf_cfg)
    from . import loaders

    sd = loaders.load_state_dict(model_path)
    if use_quantized_model:
        from .gptq import params_from_quantized_state_dict

        return (params_from_quantized_state_dict(sd, cfg, hf_cfg,
                                                 device=dev), cfg)
    from .hf import params_from_state_dict

    return params_from_state_dict(sd, cfg, qspec, device=dev), cfg
