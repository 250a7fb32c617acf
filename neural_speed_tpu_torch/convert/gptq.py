"""Pre-quantized checkpoint ingestion: GPTQ / AWQ / AutoRound (port of
`neural_speed_tpu/convert/gptq.py`).

The unpackers and the repack into planar `QTensor`s are torch ops that run
on the device of their input tensors, so the card repacks a 7B checkpoint
itself.  The packs equal the JAX package's bit for bit (planes, zero
points, scales and the act-order `perm`).  Act-order becomes an explicit
K-permutation applied to activations before the matmul (`{"perm": ...}` in
the linear params, `models.transformer.linear`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.arch import ArchConfig
from ..ops.qtypes import QSpec, QType
from ..ops.quantize import QTensor, pack_codes

AWQ_ORDER = np.array([0, 4, 1, 5, 2, 6, 3, 7])


def _t(a, device=None) -> torch.Tensor:
    """A numpy array or tensor as a tensor (on `device` when given)."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t if device is None else t.to(device)


def _words(packed: torch.Tensor) -> torch.Tensor:
    """int32 (or uint32) words as int32: an arithmetic shift then the width
    mask gives the codes of the uint32 words."""
    if packed.dtype == torch.int32:
        return packed
    return packed.to(torch.int64).to(torch.int32)


def unpack_rows(packed, bits: int) -> torch.Tensor:
    """GPTQ qweight layout: int32 `[K*bits/32, N]`, codes packed along K
    (little-endian within the word).  -> uint8 `[K, N]`."""
    per = 32 // bits
    mask = (1 << bits) - 1
    p = _words(_t(packed))
    out = torch.stack([(p >> (bits * i)) & mask for i in range(per)], dim=1)
    return out.reshape(p.shape[0] * per, p.shape[1]).to(torch.uint8)


def unpack_cols(packed, bits: int, awq: bool = False) -> torch.Tensor:
    """qzeros / AWQ layout: int32 `[R, N*bits/32]`, codes packed along N.
    AWQ interleaves nibbles in order [0,4,1,5,2,6,3,7]."""
    per = 32 // bits
    mask = (1 << bits) - 1
    p = _words(_t(packed))
    out = torch.stack([(p >> (bits * i)) & mask for i in range(per)], dim=2)
    out = out.reshape(p.shape[0], p.shape[1] * per).to(torch.uint8)
    if awq and bits == 4:
        # undo the AWQ interleave within each group of 8
        r, c = out.shape
        inv = torch.from_numpy(np.argsort(AWQ_ORDER)).to(out.device)
        out = out.reshape(r, c // 8, 8).index_select(2, inv).reshape(r, c)
    return out


def gptq_to_qtensor(
    qweight, qzeros, scales, g_idx=None, bits: int = 4,
    awq: bool = False, zero_plus_one: bool = True,
    scale_dtype: str = "float32",
) -> Tuple[QTensor, Optional[torch.Tensor]]:
    """-> (QTensor `[K, N]`, int32 perm or None), on the device of `qweight`.

    zero_plus_one: GPTQ-v1 stores `zp - 1` in qzeros (the classic AutoGPTQ
    off-by-one); v2 and AWQ store zp directly.
    """
    qweight = _t(qweight)
    dev = qweight.device
    qzeros = _t(qzeros, dev)
    scales = _t(scales, dev).float()

    if awq:
        codes = unpack_cols(qweight, bits, awq=True)       # [K, N]
    else:
        codes = unpack_rows(qweight, bits)                 # [K, N]
    zeros = unpack_cols(qzeros, bits, awq=awq).to(torch.int32)  # [G, N]
    if zero_plus_one:
        zeros = zeros + 1
    k, n = codes.shape
    groups = zeros.shape[0]
    g = k // groups

    perm = None
    if g_idx is not None:
        g_idx = _t(g_idx, dev).to(torch.int64)
        contiguous = torch.arange(groups, device=dev).repeat_interleave(g)
        if not torch.equal(g_idx, contiguous[: len(g_idx)]):
            # act-order: permute K rows so groups are contiguous; the
            # runtime applies the same permutation to activations
            perm = torch.argsort(g_idx, stable=True)
            codes = codes.index_select(0, perm)

    maxcode = (1 << bits) - 1
    zeros = torch.clamp(zeros, 0, maxcode).to(torch.uint8)
    spec = QSpec(QType.INT, bits, g, symmetric=False,
                 scale_dtype=scale_dtype)
    data = pack_codes(codes, bits)
    if scale_dtype == "bfloat16":
        scales = scales.to(torch.bfloat16)
    qt = QTensor(data, scales, zeros, None, spec, (k, n))
    return qt, (perm.to(torch.int32) if perm is not None else None)


def is_quantized_state_dict(sd: Dict[str, Any]) -> bool:
    return any(k.endswith(".qweight") for k in sd)


def detect_quant_method(hf_cfg: Dict[str, Any]) -> Dict[str, Any]:
    """Read quantization_config (the converter's dispatch on quantized
    model configs)."""
    qc = hf_cfg.get("quantization_config", {}) or {}
    method = (qc.get("quant_method") or "gptq").lower()
    return {
        "bits": qc.get("bits", 4),
        "awq": method == "awq",
        # GPTQ v1 checkpoints store zp-1; v2 ("gptq_v2") and AWQ store zp
        "zero_plus_one": (
            method == "gptq"
            and qc.get("checkpoint_format", "gptq") != "gptq_v2"
        ),
        "desc_act": qc.get("desc_act", False),
    }


def quantized_linear(sd: Dict[str, Any], prefix: str,
                     qinfo: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Build a linear param dict from `<prefix>.{qweight,qzeros,scales,
    g_idx,bias}` entries, converted on `device` (default: where the
    entries lie)."""
    get = lambda key: (None if sd.get(key) is None
                       else _t(sd[key], device))
    qt, perm = gptq_to_qtensor(
        get(prefix + ".qweight"), get(prefix + ".qzeros"),
        get(prefix + ".scales"), get(prefix + ".g_idx"),
        bits=qinfo["bits"], awq=qinfo["awq"],
        zero_plus_one=qinfo["zero_plus_one"],
    )
    out: Dict[str, Any] = {"w": qt}
    if perm is not None:
        out["perm"] = perm
    b = get(prefix + ".bias")
    if b is not None:
        out["b"] = b.float()
    return out


def params_from_quantized_state_dict(
    sd: Dict[str, Any], cfg: ArchConfig, hf_cfg: Dict[str, Any],
    dtype=torch.bfloat16, device=None,
) -> Dict[str, Any]:
    """llama-family GPTQ/AWQ checkpoint -> params, converted on `device`
    (default: where the state dict's tensors lie; one linear at a time)."""
    qinfo = detect_quant_method(hf_cfg)

    def dense(key, dt):
        return _t(sd[key], device).float().to(dt)

    p: Dict[str, Any] = {
        "embed": {"weight": dense("model.embed_tokens.weight", dtype)},
        "layers": [],
        "final_norm": {"weight": dense("model.norm.weight", torch.float32)},
    }
    if "lm_head.weight" in sd:
        w = _t(sd["lm_head.weight"], device).float().t().contiguous()
        p["lm_head"] = {"w": w.to(dtype)}

    def lin(prefix):
        return quantized_linear(sd, prefix, qinfo, device)

    for i in range(cfg.n_layers):
        pre = f"model.layers.{i}."
        lp = {
            "attn_norm": {"weight": dense(pre + "input_layernorm.weight",
                                          torch.float32)},
            "ffn_norm": {"weight": dense(
                pre + "post_attention_layernorm.weight", torch.float32)},
            "q": lin(pre + "self_attn.q_proj"),
            "k": lin(pre + "self_attn.k_proj"),
            "v": lin(pre + "self_attn.v_proj"),
            "o": lin(pre + "self_attn.o_proj"),
            "ffn": {
                "gate": lin(pre + "mlp.gate_proj"),
                "up": lin(pre + "mlp.up_proj"),
                "down": lin(pre + "mlp.down_proj"),
            },
        }
        p["layers"].append(lp)
    return p


# ---------------------------------------------------------------------------
# synthetic GPTQ packers (tests + docs; inverse of the unpackers)
# ---------------------------------------------------------------------------


def pack_rows(codes, bits: int) -> torch.Tensor:
    """uint8 `[K, N]` codes -> GPTQ qweight int32 `[K*bits/32, N]`."""
    per = 32 // bits
    c = _t(codes).to(torch.int64)
    k, n = c.shape
    out = torch.zeros((k // per, n), dtype=torch.int64, device=c.device)
    for i in range(per):
        out |= c[i::per] << (bits * i)
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)


def pack_cols(codes, bits: int, awq: bool = False) -> torch.Tensor:
    """uint8 `[R, C]` codes -> int32 `[R, C*bits/32]` packed along C (AWQ:
    interleaved within each group of 8)."""
    per = 32 // bits
    c = _t(codes).to(torch.int64)
    r, cols = c.shape
    if awq and bits == 4:
        order = torch.from_numpy(AWQ_ORDER).to(c.device)
        c = c.reshape(r, cols // 8, 8).index_select(2, order).reshape(r, cols)
    out = torch.zeros((r, cols // per), dtype=torch.int64, device=c.device)
    for i in range(per):
        out |= c[:, i::per] << (bits * i)
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)
