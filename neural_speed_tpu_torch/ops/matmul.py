"""Quantized matmul `x @ dequant(W)` (port of `neural_speed_tpu/ops/matmul.py`).

`qmatmul` is the entry.  A CUDA tensor goes through kernel A
(`csrc/qmatmul.cu`, int4 / symmetric / bf16 scales, the format of the main
path) or raises; a CPU tensor goes through `qmatmul_plain`, the plain
PyTorch version of the same function.

Compute dtype (the TPU kernel's `_compute_dtype` rule): float32 when
M <= 32 (decode; the dequantized value `s * (code - offset)` is exact in
float32), bfloat16 above (prefill: the dequantized weight is rounded to
bf16 before a dot that accumulates in float32, as the JAX package's
`qmatmul_xla` does).  The output takes `out_dtype`, default x's dtype.
"""

from __future__ import annotations

import functools

import torch

from .. import _build
from .qtypes import QSpec, QType, plane_widths
from .quantize import QTensor, dequantize

GEMV_MAX_M = 32


def compute_dtype(x_dtype: torch.dtype, m: int) -> torch.dtype:
    if m <= GEMV_MAX_M:
        return torch.float32
    return torch.bfloat16 if x_dtype == torch.bfloat16 else torch.float32


def qmatmul_plain(x2: torch.Tensor, qt: QTensor, out_dtype=None) -> torch.Tensor:
    """Plain version: `x2 [M, K] @ dequantize(qt)` in the compute dtype, with
    float32 accumulation."""
    out_dtype = out_dtype or x2.dtype
    cdt = compute_dtype(x2.dtype, x2.shape[0])
    w = dequantize(qt, cdt).float()
    return (x2.to(cdt).float() @ w).to(out_dtype)


def kernel_k_multiple(spec: QSpec) -> int:
    """K must be a multiple of this x group for a fused kernel (the widest
    plane's pack period)."""
    if spec.is_fp8 or (spec.qtype == QType.INT and spec.bits == 8):
        return 1
    if spec.is_lut:
        return 8
    return max(32 // w for w in plane_widths(spec.bits))


def kernel_eligible(qt: QTensor) -> bool:
    """Formats kernel A takes: one int4 plane, symmetric, bf16 group scales
    with g a multiple of 8, K a multiple of 64 and N of 8."""
    spec = qt.spec
    k, n = qt.shape
    g = spec.effective_group(k)
    return (spec.qtype == QType.INT and spec.bits == 4 and spec.symmetric
            and qt.zeros is None and qt.sscale is None and qt.k_shards == 1
            and qt.scales.dtype == torch.bfloat16 and len(qt.data) == 1
            and k % 64 == 0 and n % 8 == 0 and g % 8 == 0 and k % g == 0)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _gemv_splits(k: int, n: int, n_sm: int) -> int:
    """K splits for the GEMV: about four blocks per SM, each over a multiple
    of 8 word rows and at most 160 (x's slice stays within 48 KB of shared
    memory at 8 rows of x)."""
    kw = k // 8
    col_blocks = -(-n // 512)
    rows = -(-kw // max(1, -(-4 * n_sm // col_blocks)))
    rows = min(max(8, -(-rows // 8) * 8), 160)
    return -(-kw // rows)


def qmatmul_cuda(x2: torch.Tensor, qt: QTensor, out_dtype=None) -> torch.Tensor:
    """Kernel A on `x2 [M, K]` bf16; output bf16."""
    out_dtype = out_dtype or x2.dtype
    words = qt.data[0]
    m, k = x2.shape
    n = qt.shape[1]
    g = qt.spec.effective_group(k)
    ok = (kernel_eligible(qt) and x2.dtype == torch.bfloat16
          and out_dtype == torch.bfloat16 and words.dtype == torch.int32
          and words.shape == (k // 8, n) and qt.scales.shape == (k // g, n)
          and all(t.is_cuda and t.device == x2.device and t.is_contiguous()
                  and t.data_ptr() % 16 == 0
                  for t in (x2, words, qt.scales)))
    if not ok:
        raise ValueError(
            f"kernel A takes contiguous, 16-byte aligned CUDA tensors: bf16 x "
            f"[M, K] and an int4/symmetric/bf16-scale pack with K % 64 == 0, "
            f"N % 8 == 0, g % 8 == 0, and writes bf16; got x {x2.dtype} "
            f"{tuple(x2.shape)} on {x2.device}, out {out_dtype}, pack "
            f"{qt.spec} {qt.shape} on {words.device}")
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    stream = _build.stream_handle()
    if m <= GEMV_MAX_M:
        splits = _gemv_splits(k, n, _sm_count(x2.device.index or 0))
        partial = (torch.empty((splits, m, n), dtype=torch.float32,
                               device=x2.device) if splits > 1 else out)
        fn = _build.kernels.fn("qmatmul", "nst_qmatmul_int4_gemv", 5, 5)
        code = fn(x2.data_ptr(), words.data_ptr(), qt.scales.data_ptr(),
                  partial.data_ptr(), out.data_ptr(), m, k, n, g, splits,
                  stream)
    else:
        fn = _build.kernels.fn("qmatmul", "nst_qmatmul_int4_gemm", 4, 4)
        code = fn(x2.data_ptr(), words.data_ptr(), qt.scales.data_ptr(),
                  out.data_ptr(), m, k, n, g, stream)
    _build.check(code, "qmatmul")
    _build.launches["qmatmul"] += 1
    return out


def qmatmul(x: torch.Tensor, qt: QTensor, out_dtype=None) -> torch.Tensor:
    """Quantized matmul `x @ dequant(qt)`: `[..., K] -> [..., N]`.  A K-padded
    pack (`quantize.repad_k`) gets its activations zero-padded."""
    if x.shape[-1] != qt.shape[0]:
        x = torch.nn.functional.pad(x, (0, qt.shape[0] - x.shape[-1]))
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    if x2.device.type == "cpu":
        _build.plain_dispatches["qmatmul"] += 1
        out = qmatmul_plain(x2, qt, out_dtype)
    else:
        out = qmatmul_cuda(x2, qt, out_dtype)
    return out.reshape(*lead, qt.shape[1])
