"""Quantized matmul `x @ dequant(W)` (port of `neural_speed_tpu/ops/matmul.py`).

`qmatmul` and `qmatmul_int8` are the entries.  A CPU tensor goes through the
plain PyTorch versions (`qmatmul_plain`, `qmatmul_int8_plain`).  A CUDA
tensor goes through the kernel that takes the pack, or raises naming the
format; it never runs a plain version:

* kernel A (`csrc/qmatmul.cu`): one int4 plane, symmetric, bf16 scales (its
  GEMM is the TMA + `wgmma` template of F and P, `csrc/qmm_fp.cuh`, with a
  bf16x2 dequantization of its own);
* kernel F (`csrc/qmatmul_lut.cu`): NF4 / FP4 codes through a 16-entry table
  (the canonical one or a converter's `spec.lut`);
* kernel P (`csrc/qmatmul_planar.cuh`, one library per format): INT 3/5/6/7
  as 4/2/1-bit planes, FP8 e4m3 / e5m2 rows, and ggml float offsets
  `w = s * code + m` at any width but 1;
* P's one-plane INT instances (INT1, INT2, INT4, INT8 rows; counted as
  `qmatmul_int`): the int kernel's packs that kernel A does not take, with
  the symmetric offset or uint8 zero points and bf16, float32 or
  double-quantized scales (GPTQ / AWQ, GGUF Q4_0 / Q8_0);
* kernel G (`csrc/qmatmul_int8.cu`): int8 activations x one-plane INT 4/8
  weights, int32 accumulation per K group, float32 rescale;
* kernel H (`csrc/qmatmul_int8_planar.cu`): the same over INT 2/3/5/6/7
  planes, with the zero-point correction through the row sum of the
  quantized activations.

F and P take bf16 or float32 scales (double-quantized scales decode to
float32 outside the kernel), any M >= 1, g a multiple of 8 that divides K,
K a multiple of the pack period x g (`kernel_k_multiple`) and N % 8 == 0.
`kernel_for` sends every pack the JAX package's Pallas gates
(`_pallas_supported`, `_planar_supported`) take to one of these kernels;
packs in K slabs (`k_shards > 1`), which the JAX package runs on XLA,
raise.

Float32 activations (the JAX kernels' float32 branch; quantized Whisper's
path): F, P and P's one-plane INT instances take float32 x and write float32
through their `_f32` entries (counted as `qmatmul_lut_f32`,
`qmatmul_planar_f32`, `qmatmul_int_f32`): the GEMV loads x as float32, the
GEMM is 3xTF32 on the tensor cores, within float32-level error (the
`check_f32_formats` contract of `chip_smoke.py`; no bf16 rounding).  `kernel_route` sends
kernel A's packs (int4 / symmetric / bf16 scales) to "I" for float32 x:
those instances take the symmetric offset and bf16 scales already, while
kernel A's bodies take bf16 x only.  A float32 x is never rounded to bf16 to reuse a bf16
kernel, and never handed to the plain version on the card.

Compute dtype of `qmatmul` (the TPU kernel's `_compute_dtype` rule): float32
when M <= 32 (decode; the dequantized value is exact in float32), bfloat16
above (prefill: the dequantized weight is computed in float32 and rounded
once to bf16 before a dot that accumulates in float32, as the JAX package's
`qmatmul_xla` does).  The output takes `out_dtype`, default x's dtype.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from .. import _build
from .qtypes import QSpec, QType, plane_widths
from .quantize import QTensor, dequantize, lut_values, unpack_codes

GEMV_MAX_M = 32
# Kernel A's GEMV reads the words once for every row: rows 1..8 on the
# CUDA cores, 9..32 on the tensor cores, 128 columns per block there
# (`csrc/qmm_int4.cuh`, MMA_BN).
GEMV_SIMT_MAX_M = 8
GEMV_MMA_COLS = 128


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


def _gemv_splits(k: int, n: int, n_sm: int, bands: int = 8,
                 block_cols: int = 512) -> int:
    """K splits for a GEMV over a pack whose words hold `bands` K sub-bands
    and whose blocks cover `block_cols` columns: about four blocks per SM,
    each over a multiple of 8 word rows and at most 1280 / bands (x's slice
    stays within 48 KB of shared memory at 8 rows of x)."""
    kw = k // bands
    col_blocks = -(-n // block_cols)
    rows = -(-kw // max(1, -(-4 * n_sm // col_blocks)))
    rows = min(max(8, -(-rows // 8) * 8), 1280 // bands // 8 * 8)
    return -(-kw // rows)


# The GEMV of kernels F, P and P's one-plane INT instances (`csrc/qmm_fp.cuh`):
# rows 1..8 with bf16 x, and every M <= 32 with float32 x, on the CUDA cores
# (one launch, K split over `_gemv_splits` blocks whose partials one reduce
# kernel sums); rows 9..32 with bf16 x on the tensor cores in one pass, 128
# columns a block, K split over a thread-block cluster of at most 8 blocks
# summed through distributed shared memory (no reduce).
FP_GEMV_MMA_COLS = 128
FP_GEMV_MAX_SPLITS = 8


def fp_gemv_body(m: int, x_dtype: torch.dtype) -> str:
    """The F / P GEMV body that takes `m <= 32` rows: "mma" (the tensor
    cores) or "simt" (the CUDA cores)."""
    if x_dtype == torch.bfloat16 and GEMV_SIMT_MAX_M < m <= GEMV_MAX_M:
        return "mma"
    return "simt"


def fp_gemv_simt_splits(k: int, n: int, bands: int, block_cols: int,
                        n_sm: int, per_sm: int = 4) -> int:
    """K splits of the CUDA-core GEMV of F and P: at most as many blocks as
    the SMs hold at once (`per_sm` each: the bodies' register caps),
    rounding the split count down so that the grid is one wave where
    `_gemv_splits`' rounding up would leave a second, short one; each
    split a multiple of 8 word rows and at most 1280 / bands of them (x's
    slice stays within 40 KB of shared memory at 8 rows of x)."""
    kw = k // bands
    col_blocks = -(-n // block_cols)
    per_col = max(1, per_sm * n_sm // col_blocks)
    rows = -(-kw // per_col)
    rows = min(max(8, -(-rows // 8) * 8), 1280 // bands // 8 * 8)
    return -(-kw // rows)


def fp_gemv_simt_per_sm(m: int, multi_plane: bool, table: bool) -> int:
    """Blocks an SM holds of the CUDA-core GEMV (`csrc/qmm_fp.cuh`'s register
    caps, `simt_min_blocks` / `simt1_min_blocks`): 4 at one row of x; above
    it 3 of the multi-plane body; of the one-plane body 4 at 5-8 rows, and
    at 2-4 rows 4 of the table's (5 fit) and 3 of the rest."""
    if m == 1:
        return 4
    if multi_plane:
        return 3
    return 4 if m > 4 or table else 3


def fp_gemv_mma_step(bands: int) -> int:
    """Word rows of the narrowest plane per step of the tensor-core GEMV
    (`MmaStep::SR`): 8 at 16 or 32 bands, 128 / bands below (byte rows:
    128), so a step holds 128 or 256 values of K."""
    return 8 if bands >= 16 else 128 // bands


def fp_gemv_mma_splits(k: int, n: int, bands: int, n_sm: int) -> int:
    """K splits (the cluster size, a power of 2 up to 8) of the tensor-core
    GEMV: doubled while its column blocks fill fewer than two blocks per SM
    and every split keeps at least one step of the narrowest plane."""
    col_blocks = -(-n // FP_GEMV_MMA_COLS)
    kw = k // bands
    step = fp_gemv_mma_step(bands)
    splits = 1
    while (splits < FP_GEMV_MAX_SPLITS and col_blocks * splits < 2 * n_sm
           and kw // (2 * splits) >= step):
        splits *= 2
    return splits


def fp_gemv_launches(m: int, k: int, n: int, bands: int, multi_plane: bool,
                     x_dtype: torch.dtype, n_sm: int, table: bool = False) -> list:
    """The kernels one F / P GEMV call launches, in order, as (kernel, grid)
    pairs, as the C entry `run_gemv` (`csrc/qmm_fp.cuh`) launches them for
    the splits `_fp_launch` hands it: one GEMV launch at every M <= 32,
    then the reduce of the CUDA-core body's splits."""
    if fp_gemv_body(m, x_dtype) == "mma":
        splits = fp_gemv_mma_splits(k, n, bands, n_sm)
        return [("gemv_mma_kernel",
                 (-(-n // FP_GEMV_MMA_COLS), splits, 1))]
    cols = 128 if multi_plane else 512
    splits = fp_gemv_simt_splits(k, n, bands, cols, n_sm,
                                 fp_gemv_simt_per_sm(m, multi_plane, table))
    mt = 8 if m > 4 else 4 if m > 1 else 1
    name = "gemv1_kernel" if multi_plane else "gemv_kernel"
    launches = [(name, (-(-n // cols), splits, -(-m // mt)))]
    if splits > 1:
        launches.append(("splitk_reduce_kernel", (-(-m * n // 256), 1, 1)))
    return launches


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
        splits = _gemv_splits(k, n, _sm_count(x2.device.index or 0), 8,
                              512 if m <= GEMV_SIMT_MAX_M else GEMV_MMA_COLS)
        partial = (torch.empty((splits, m, n), dtype=torch.float32,
                               device=x2.device) if splits > 1 else out)
        # the tensor-core body reads x in band-major order, as the GEMM
        xg = x2 if m <= GEMV_SIMT_MAX_M else _band_major(x2, 8)
        fn = _build.kernels.fn("qmatmul", "nst_qmatmul_int4_gemv", 5, 5)
        code = fn(xg.data_ptr(), words.data_ptr(), qt.scales.data_ptr(),
                  partial.data_ptr(), out.data_ptr(), m, k, n, g, splits,
                  stream)
    else:
        xk = _band_major(x2, 8)
        fn = _build.kernels.fn("qmatmul", "nst_qmatmul_int4_gemm", 4, 4)
        code = fn(xk.data_ptr(), words.data_ptr(), qt.scales.data_ptr(),
                  out.data_ptr(), m, k, n, g, stream)
    _build.check(code, "qmatmul")
    _build.launches["qmatmul"] += 1
    return out


def planes_of(spec: QSpec) -> tuple:
    """Widths of the pack's planes (one 8-bit plane for byte rows)."""
    if spec.is_fp8:
        return (8,)
    return (4,) if spec.is_lut else plane_widths(spec.bits)


def _byte_rows(spec: QSpec) -> bool:
    """One byte per weight in `[K, N]` rows: FP8 and INT8."""
    return spec.is_fp8 or (spec.qtype == QType.INT and spec.bits == 8)


def _finest_bands(spec: QSpec) -> int:
    """K sub-bands per word of the pack's narrowest plane (1 for byte rows)."""
    if _byte_rows(spec):
        return 1
    if spec.is_lut:
        return 8
    return 32 // min(plane_widths(spec.bits))


def _float_zeros(qt: QTensor) -> bool:
    return qt.zeros is not None and qt.zeros.is_floating_point()


def kernel_for(qt: QTensor) -> str:
    """Which `qmatmul` kernel takes the pack's format: "A", "F", "P" (multi-
    plane, FP8 and float-offset packs), "I" (P's one-plane INT instances),
    or "" for packs in K slabs (shapes and devices are the wrappers'
    checks).  1-bit packs go to "I" whatever their zeros: their value is
    2 * code - 1, as `dequantize` has it."""
    spec = qt.spec
    if qt.k_shards != 1:
        return ""
    if spec.is_lut:
        return "F"
    if spec.is_fp8 or spec.bits in (3, 5, 6, 7):
        return "P"
    if _float_zeros(qt) and spec.bits != 1:
        return "P"
    return "A" if kernel_eligible(qt) else "I"


def kernel_takes(qt: QTensor) -> bool:
    """Whether a kernel takes the pack as stored: its format (`kernel_for`)
    and its shapes (the checks of the kernel's wrapper, devices aside)."""
    letter = kernel_for(qt)
    if letter == "A":
        return True
    return bool(letter) and _planes_ok(qt) and _fp_shape_ok(qt)


def _describe(qt: QTensor) -> str:
    spec = qt.spec
    zeros = ("none" if qt.zeros is None else
             str(qt.zeros.dtype).replace("torch.", ""))
    return (f"{spec.qtype.value}{spec.bits} symmetric={spec.symmetric} "
            f"group={spec.group_size} scales="
            f"{str(qt.scales.dtype).replace('torch.', '')}"
            f"{'+sscale' if qt.sscale is not None else ''} zeros={zeros} "
            f"k_shards={qt.k_shards} shape={tuple(qt.shape)}")


def _kernel_scales(qt: QTensor) -> torch.Tensor:
    """The scales as a kernel reads them: bf16 or float32 as stored;
    double-quantized scales decode to float32 here."""
    if qt.sscale is not None or qt.scales.dtype not in (torch.bfloat16,
                                                        torch.float32):
        return qt.effective_scales(torch.float32).contiguous()
    return qt.scales


def _cuda_ok(*tensors) -> bool:
    dev = tensors[0].device
    return all(t.is_cuda and t.device == dev and t.is_contiguous()
               and t.data_ptr() % 16 == 0 for t in tensors)


def _planes_ok(qt: QTensor) -> bool:
    k, n = qt.shape
    widths = planes_of(qt.spec)
    if widths == (8,):
        return (len(qt.data) == 1 and qt.data[0].dtype == torch.uint8
                and qt.data[0].shape == (k, n))
    return (len(qt.data) == len(widths) and all(
        d.dtype == torch.int32 and d.shape == (k * w // 32, n)
        for d, w in zip(qt.data, widths)))


def _fp_shape_ok(qt: QTensor) -> bool:
    """Shapes kernels F and P take: g % 8 == 0 dividing K (or one group),
    N % 8 == 0, whole 8-row chunks per band.  A group may straddle a band
    (the kernels look the scale up per run of 8 rows, which lies inside one
    group), so the JAX kernel's subdivided group is not needed."""
    k, n = qt.shape
    g = qt.spec.effective_group(k)
    bands = _finest_bands(qt.spec)
    return (qt.k_shards == 1 and n % 8 == 0 and g % 8 == 0 and k % g == 0
            and k % (bands * 8) == 0
            and qt.scales.shape == (k // g, n)
            and (qt.zeros is None or qt.zeros.shape == (k // g, n)))


_FMT_FP8 = {QType.FP8_E4M3: "e4m3", QType.FP8_E5M2: "e5m2"}
_ZMODES = {"none": 0, "sym": 1, "int": 2, "float": 3}


def _band_major(x2: torch.Tensor, bands: int) -> torch.Tensor:
    """x with K reordered so that the `bands` values one word row feeds are
    adjacent (k' = row * bands + band): the GEMMs of kernels A, F, P and
    11 then read contiguous K tiles of x, whatever the pack's band
    stride."""
    if bands == 1:
        return x2
    m, k = x2.shape
    return x2.view(m, bands, k // bands).transpose(1, 2).reshape(m, k)


def _fp_launch(name: str, lib: str, x2: torch.Tensor, qt: QTensor, planes,
               extra_ptrs, extra_ints, counter: str = "") -> torch.Tensor:
    """Shared launch of kernels F and P (entries `nst_<name>_gemv/_gemm` of
    the library `lib`, `..._f32` for float32 x): the GEMV for M <= 32 (one
    launch: `fp_gemv_launches`), the GEMM above (bf16 tensor cores, or
    3xTF32 for float32 x).  The output takes x's dtype.  The launch counts under `counter` (default
    `name`), with `_f32` appended for float32 x."""
    m, k = x2.shape
    n = qt.shape[1]
    g = qt.spec.effective_group(k)
    scales = _kernel_scales(qt)
    bands = _finest_bands(qt.spec)
    f32 = "_f32" if x2.dtype == torch.float32 else ""
    out = torch.empty((m, n), dtype=x2.dtype, device=x2.device)
    s_bf16 = int(scales.dtype == torch.bfloat16)
    ptrs = [p.data_ptr() for p in planes] + [scales.data_ptr()] + extra_ptrs
    stream = _build.stream_handle()
    if m <= GEMV_MAX_M:
        n_sm = _sm_count(x2.device.index or 0)
        if fp_gemv_body(m, x2.dtype) == "mma":
            # the cluster's splits are summed in shared memory
            splits, partial = fp_gemv_mma_splits(k, n, bands, n_sm), out
        else:
            # multi-plane packs: one column per thread, 128 per block
            multi = len(planes_of(qt.spec)) > 1
            splits = fp_gemv_simt_splits(
                k, n, bands, 128 if multi else 512, n_sm,
                fp_gemv_simt_per_sm(m, multi, qt.spec.is_lut))
            partial = (torch.empty((splits, m, n), dtype=torch.float32,
                                   device=x2.device) if splits > 1 else out)
        fn = _build.kernels.fn(lib, f"nst_{name}_gemv{f32}", len(ptrs) + 3,
                               6 + len(extra_ints))
        code = fn(x2.data_ptr(), *ptrs, partial.data_ptr(), out.data_ptr(),
                  m, k, n, g, splits, s_bf16, *extra_ints, stream)
    else:
        xk = _band_major(x2, bands)
        fn = _build.kernels.fn(lib, f"nst_{name}_gemm{f32}", len(ptrs) + 2,
                               5 + len(extra_ints))
        code = fn(xk.data_ptr(), *ptrs, out.data_ptr(), m, k, n, g, s_bf16,
                  *extra_ints, stream)
    _build.check(code, name + f32)
    _build.launches[(counter or name) + f32] += 1
    return out


_FP_DTYPES = ((torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32))


def _fp_checks(letter: str, x2: torch.Tensor, qt: QTensor, out_dtype,
               tensors) -> None:
    ok = (kernel_route(qt, x2.dtype) == letter and _planes_ok(qt)
          and _fp_shape_ok(qt) and (x2.dtype, out_dtype) in _FP_DTYPES
          and x2.shape[1] == qt.shape[0] and _cuda_ok(x2, *tensors))
    if not ok:
        what = "P (one-plane INT)" if letter == "I" else letter
        raise ValueError(
            f"kernel {what} takes contiguous, 16-byte aligned CUDA "
            f"tensors: x [M, K] bf16 writing bf16 or float32 writing "
            f"float32, bf16 or float32 scales, g % 8 == 0, K a multiple of "
            f"the pack period x g, N % 8 == 0; got x {x2.dtype} "
            f"{tuple(x2.shape)} on {x2.device}, out {out_dtype}, pack "
            f"{_describe(qt)} on {qt.data[0].device}")


def qmatmul_lut_cuda(x2: torch.Tensor, qt: QTensor,
                     out_dtype=None) -> torch.Tensor:
    """Kernel F on `x2 [M, K]` bf16 or float32: NF4 / FP4 codes through the
    16-entry table, a kernel argument cached per (table, device); output in
    x's dtype."""
    out_dtype = out_dtype or x2.dtype
    scales = _kernel_scales(qt)
    _fp_checks("F", x2, qt, out_dtype, (*qt.data, scales))
    table = lut_values(qt.spec, torch.float32, x2.device)
    return _fp_launch("qmatmul_lut", "qmatmul_lut", x2, qt, qt.data,
                      [table.data_ptr()], [])


def _planar_launch(letter: str, x2: torch.Tensor, qt: QTensor,
                   out_dtype) -> torch.Tensor:
    out_dtype = out_dtype or x2.dtype
    scales = _kernel_scales(qt)
    zeros = qt.zeros
    if zeros is not None and zeros.dtype not in (torch.uint8, torch.float32):
        zeros = zeros.float().contiguous()
    _fp_checks(letter, x2, qt, out_dtype,
               (*qt.data, scales) + (() if zeros is None else (zeros,)))
    spec = qt.spec
    if zeros is None:
        zmode = "none" if spec.is_fp8 else "sym"
    else:
        zmode = "float" if zeros.is_floating_point() else "int"
    # one library per format: csrc/qmatmul_planar_<format>.cu
    fmt = _FMT_FP8[spec.qtype] if spec.is_fp8 else f"int{spec.bits}"
    planes = list(qt.data) + [qt.data[0]] * (3 - len(qt.data))
    return _fp_launch("qmatmul_planar", f"qmatmul_planar_{fmt}", x2, qt,
                      planes, [0 if zeros is None else zeros.data_ptr()],
                      [_ZMODES[zmode]],
                      counter="qmatmul_int" if letter == "I" else "")


def qmatmul_planar_cuda(x2: torch.Tensor, qt: QTensor,
                        out_dtype=None) -> torch.Tensor:
    """Kernel P on `x2 [M, K]` bf16 or float32: odd-width planes, FP8 rows,
    float offsets; output in x's dtype."""
    return _planar_launch("P", x2, qt, out_dtype)


def qmatmul_int_cuda(x2: torch.Tensor, qt: QTensor,
                     out_dtype=None) -> torch.Tensor:
    """P's one-plane INT instances on `x2 [M, K]` bf16 or float32: INT
    1/2/4/8 with the symmetric offset or uint8 zero points, bf16, float32
    or double-quantized scales (and kernel A's packs for float32 x); output
    in x's dtype."""
    return _planar_launch("I", x2, qt, out_dtype)


def kernel_route(qt: QTensor, x_dtype: torch.dtype) -> str:
    """The kernel `qmatmul` launches for the pack and x's dtype on the card:
    `kernel_for`'s letter, except that float32 x sends kernel A's packs to
    "I" (kernel A takes bf16 x only; see the module docstring)."""
    letter = kernel_for(qt)
    return "I" if letter == "A" and x_dtype == torch.float32 else letter


_QMATMUL_KERNELS = {"A": qmatmul_cuda, "F": qmatmul_lut_cuda,
                    "P": qmatmul_planar_cuda, "I": qmatmul_int_cuda}


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
        launch = _QMATMUL_KERNELS.get(kernel_route(qt, x2.dtype))
        if launch is None:
            raise ValueError(
                f"no CUDA kernel takes this pack yet: {_describe(qt)}; "
                f"the kernels take unsharded packs (k_shards == 1), as the "
                f"JAX package's Pallas kernels do")
        out = launch(x2, qt, out_dtype)
    return out.reshape(*lead, qt.shape[1])


# ---------------------------------------------------------------------------
# int8 compute: dynamic int8 activations x int weights, int32 accumulation
# ---------------------------------------------------------------------------


def _act_quant(xf: torch.Tensor, g: int):
    """Per-token, per-group symmetric int8 activation quantization:
    `[M, K]` float32 -> (int8 `[M, K]`, float32 scales `[M, K/g]`); g >= K
    gives one scale per token.  Divisions are by tensors (IEEE on the card
    too)."""
    m, k = xf.shape
    g = min(g, k)
    xg = xf.reshape(m, k // g, g)
    amax = xg.abs().amax(dim=-1).clamp_min(1e-8)
    ascale = amax / amax.new_full((), 127.0)
    xq = torch.clamp(torch.round(xg / ascale[..., None]), -127, 127).to(
        torch.int8).reshape(m, k)
    return xq, ascale


def int8_kernel_for(qt: QTensor) -> str:
    """"G" (one plane, widths 4 and 8), "H" (planes of 2/3/5/6/7) or "" when
    `qmatmul_int8` hands the pack to `qmatmul`: non-INT packs, float
    offsets, 8-bit asymmetric (code - zero point overflows int8) and 1-bit
    (values are 2 * code - 1, not code - offset)."""
    spec = qt.spec
    if (spec.qtype != QType.INT or _float_zeros(qt) or spec.bits == 1
            or (spec.bits == 8 and qt.zeros is not None)):
        return ""
    return "G" if spec.bits in (4, 8) else "H"


def qmatmul_int8_plain(xq: torch.Tensor, ascale: Optional[torch.Tensor],
                       qt: QTensor) -> torch.Tensor:
    """Plain version of kernels G and H: per K group, the integer product of
    `xq [M, K]` int8 with `code - zero point` (or `code - offset`), rescaled
    in float32 by `ascale[m, g] * wscale[g, n]` and summed over the groups
    in order.  `ascale=None` (one scale per token) leaves the activation
    scale to the caller.  The integer partials are exact: they are taken in
    float32 where every partial sum stays below 2**24, else in float64."""
    spec = qt.spec
    k, n = qt.shape
    g = spec.effective_group(k)
    m = xq.shape[0]
    codes = unpack_codes(qt.data, spec.bits, k, qt.k_shards).to(torch.int32)
    if qt.zeros is None:
        wvals = codes - spec.code_offset
    else:
        wvals = codes - torch.repeat_interleave(qt.zeros.to(torch.int32), g,
                                                dim=0)
    idt = torch.float32 if g * 127 * 255 < 2 ** 24 else torch.float64
    wv = wvals.to(idt).reshape(k // g, g, n)
    xg = xq.to(idt).reshape(m, k // g, g).transpose(0, 1).contiguous()
    wscale = qt.effective_scales(torch.float32)
    out = torch.zeros((m, n), dtype=torch.float32, device=xq.device)
    for gi in range(k // g):
        d = (xg[gi] @ wv[gi]).float()
        if ascale is None:
            out.addcmul_(d, wscale[gi][None, :])
        else:
            out.addcmul_(d, wscale[gi][None, :] * ascale[:, gi, None])
    return out


def _chunk_rows(g: int, kw: int) -> int:
    """Rows of one K chunk of kernels G and H: the largest multiple of 8, at
    most 128, that divides both the group and a band's rows, so a chunk
    lies inside one group.  0 when there is none."""
    import math

    common = math.gcd(g, kw)
    for rows in range(128, 0, -8):
        if common % rows == 0:
            return rows
    return 0


# The GEMV of kernels G and H: 128 columns a block, K split over the blocks
# of a cluster of at most 8 (`csrc/qmm_int8.cuh`, GEMV_COLS).
INT8_GEMV_COLS = 128
INT8_GEMV_MAX_SPLITS = 8


def int8_gemv_splits(k: int, n: int, widths, n_sm: int) -> int:
    """K splits (the cluster size, a power of 2 up to 8) of the int8 GEMV:
    doubled while the column blocks fill fewer than two blocks per SM and
    every split of the narrowest plane keeps at least one 32-row step."""
    col_blocks = -(-n // INT8_GEMV_COLS)
    kw = min(k * w // 32 if w < 8 else k for w in widths)
    splits = 1
    while (splits < INT8_GEMV_MAX_SPLITS and col_blocks * splits < 2 * n_sm
           and kw // (2 * splits) >= 32):
        splits *= 2
    return splits


def int8_xsum(xq: torch.Tensor, rows: int) -> torch.Tensor:
    """Row sums of `xq [M, K]` over K steps of `rows`, exact int32
    `[M, K / rows]`: the zero-point term of kernel H's GEMM."""
    m, k = xq.shape
    return xq.view(m, k // rows, rows).sum(-1, dtype=torch.int32)


def qmatmul_int8_cuda(xq: torch.Tensor, ascale: Optional[torch.Tensor],
                      qt: QTensor, out_dtype=torch.float32,
                      row_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel G or H on `xq [M, K]` int8 with `ascale [M, K/g]` float32 (or
    None: per token); output `[M, N]` in `out_dtype` (bf16 or float32),
    each row times `row_scale[m]` (float32 `[M]`, the per-token scale)
    where given, before the one rounding."""
    spec = qt.spec
    letter = int8_kernel_for(qt)
    m, k = xq.shape
    n = qt.shape[1]
    g = spec.effective_group(k)
    groups = max(k // max(g, 1), 1)
    scales = _kernel_scales(qt)
    widths = plane_widths(spec.bits) if letter else ()
    chunks = [_chunk_rows(g, k * w // 32 if w < 8 else k) for w in widths]
    tensors = (xq, *qt.data, scales) + tuple(
        t for t in (ascale, qt.zeros, row_scale) if t is not None)
    ok = (letter and _planes_ok(qt) and qt.k_shards == 1
          and xq.dtype == torch.int8 and k == qt.shape[0] and n % 8 == 0
          and g % 8 == 0 and k % g == 0 and all(chunks)
          and scales.shape == (groups, n)
          and out_dtype in (torch.bfloat16, torch.float32)
          and (qt.zeros is None or (qt.zeros.dtype == torch.uint8
                                    and qt.zeros.shape == (groups, n)))
          and (ascale is None or (ascale.dtype == torch.float32
                                  and ascale.shape == (m, groups)))
          and (row_scale is None or (row_scale.dtype == torch.float32
                                     and row_scale.numel() == m))
          and _cuda_ok(*tensors))
    if not ok:
        raise ValueError(
            f"kernels G and H take contiguous, 16-byte aligned CUDA tensors: "
            f"int8 x [M, K], float32 activation scales [M, K/g], an INT "
            f"2..8 pack with no or uint8 zero points (8-bit: symmetric), "
            f"g % 8 == 0 dividing K and the bands, N % 8 == 0, a bf16 or "
            f"float32 output; got x {xq.dtype} {tuple(xq.shape)} on "
            f"{xq.device}, pack {_describe(qt)} on {qt.data[0].device}, "
            f"output {out_dtype}")
    name = "qmatmul_int8" if letter == "G" else "qmatmul_int8_planar"
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    planes = list(qt.data) + [qt.data[0]] * (3 - len(qt.data))
    chunks += [0] * (3 - len(chunks))
    # the GEMM's TMA map of xq needs a row stride of a multiple of 16 bytes
    ldx = -(-k // 16) * 16
    xk = xq if ldx == k else torch.nn.functional.pad(xq, (0, ldx - k))
    route, splits, xsum = "gemm", 1, None
    if m <= GEMV_MAX_M:
        route = "gemv"
        splits = int8_gemv_splits(k, n, widths,
                                  _sm_count(xq.device.index or 0))
    elif letter == "H":
        xsum = int8_xsum(xq, chunks[0])
    fn = _build.kernels.fn(name, f"nst_{name}_{route}", 10, 12)
    code = fn(xk.data_ptr(), 0 if ascale is None else ascale.data_ptr(),
              0 if row_scale is None else row_scale.data_ptr(),
              0 if xsum is None else xsum.data_ptr(),
              *(p.data_ptr() for p in planes), scales.data_ptr(),
              0 if qt.zeros is None else qt.zeros.data_ptr(), out.data_ptr(),
              m, k, n, g, spec.bits, ldx, *chunks,
              int(scales.dtype == torch.bfloat16),
              int(out_dtype == torch.bfloat16), splits,
              _build.stream_handle())
    _build.check(code, name)
    _build.launches[name] += 1
    return out


def qmatmul_int8(x: torch.Tensor, qt: QTensor, out_dtype=None,
                 per_token: bool = False) -> torch.Tensor:
    """int8 compute: dynamic per-token int8 activation quantization (one
    scale per K group, or per token with `per_token`), then an int8 x
    int-weight product accumulated in int32 per group and rescaled in
    float32.  Packs the integer kernels do not take (`int8_kernel_for`) go
    to `qmatmul`."""
    if not int8_kernel_for(qt):
        return qmatmul(x, qt, out_dtype)
    out_dtype = out_dtype or x.dtype
    k, n = qt.shape
    g = qt.spec.effective_group(k)
    lead = x.shape[:-1]
    if x.shape[-1] != k:  # K-padded pack
        x = torch.nn.functional.pad(x, (0, k - x.shape[-1]))
    xq, ascale = _act_quant(x.reshape(-1, k).float(), k if per_token else g)
    grouped = None if per_token else ascale
    if xq.device.type == "cpu":
        _build.plain_dispatches["qmatmul_int8"] += 1
        out = qmatmul_int8_plain(xq, grouped, qt)
        if per_token:
            out = out * ascale
        return out.reshape(*lead, n).to(out_dtype)
    # the kernels write bf16 or float32 once, the per-token scale applied
    # before the rounding: the value of (out * ascale).to(out_dtype)
    kdt = out_dtype if out_dtype in (torch.bfloat16, torch.float32) \
        else torch.float32
    out = qmatmul_int8_cuda(xq, grouped, qt, kdt,
                            ascale if per_token else None)
    return out.reshape(*lead, n).to(out_dtype)
