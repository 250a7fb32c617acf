"""Layer-wise quantization config (port of
`neural_speed_tpu/convert/quant_config.py`).

JSON shape:
    {"default": {"weight_dtype": "int4", "group_size": 128, "alg": "sym"},
     "overrides": [
        {"pattern": "ffn\\.down$", "weight_dtype": "int8"},
        {"pattern": "lm_head", "weight_dtype": "fp32"}]}

`pattern` is a regex searched against params-tree paths like
"layers.3.ffn.down".  weight_dtype "fp32" keeps the leaf unquantized.  The
policy feeds `ops.quantize.quantize_tree`.
"""

from __future__ import annotations

import json
import re
from typing import Any, Callable, Dict, Optional, Union

from ..ops.qtypes import QSpec, named_qspec


def _spec_of(d: Dict[str, Any]) -> Optional[QSpec]:
    wd = d.get("weight_dtype", "int4")
    if wd in ("fp32", "fp16", "bf16", None):
        return None
    return named_qspec(
        wd, group_size=int(d.get("group_size", 128)),
        symmetric=(d.get("alg", "sym") == "sym"),
        scale_dtype={"fp32": "float32", "bf16": "bfloat16"}.get(
            d.get("scale_dtype", "fp32"), "float32"),
    )


def load_quant_config(src: Union[str, Dict[str, Any]]
                      ) -> Callable[[str], Optional[QSpec]]:
    """Build a path -> QSpec policy from a JSON file path or a dict."""
    if isinstance(src, str):
        with open(src) as f:
            cfg = json.load(f)
    else:
        cfg = src
    default = _spec_of(cfg.get("default", {}))
    rules = [(re.compile(o["pattern"]), _spec_of(o))
             for o in cfg.get("overrides", [])]

    def policy(path: str) -> Optional[QSpec]:
        for rx, spec in rules:
            if rx.search(path):
                return spec
        return default

    return policy
