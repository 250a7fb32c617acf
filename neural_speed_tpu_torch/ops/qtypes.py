"""Quantized dtype registry (a copy of `neural_speed_tpu/ops/qtypes.py`).

The port keeps its own copy so it never imports the JAX package: the
registry is pure numpy and defines the storage contract (bit widths,
group sizes, code offsets) that packed planes carry across.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import numpy as np


class QType(enum.Enum):
    """Weight quantization families (parity: bestla.h BTLA_DTYPE)."""

    INT = "int"          # signed b-bit integer, b in 1..8 (S1_CLIP..S8)
    NF4 = "nf4"          # "normal float" 4-bit lookup (F4_NF4)
    FP4 = "fp4"          # e2m1 4-bit float lookup (F4_E2M1)
    FP8_E4M3 = "fp8_e4m3"
    FP8_E5M2 = "fp8_e5m2"


NF4_LUT = np.array(
    [
        -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
        -0.28444138169288635, -0.18477343022823334, -0.09105003625154495,
        0.0, 0.07958029955625534, 0.16093020141124725, 0.24611230194568634,
        0.33791524171829224, 0.44070982933044434, 0.5626170039176941,
        0.7229568362236023, 1.0,
    ],
    dtype=np.float32,
)

_FP4_MAGS = np.array([0.0, 0.5, 1.0, 1.5, 2.0, 3.0, 4.0, 6.0],
                     dtype=np.float32) / 6.0
FP4_LUT = np.concatenate([_FP4_MAGS, -_FP4_MAGS]).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class QSpec:
    """Static description of a quantized weight tensor: bit width, group
    size, sym/asym, scale dtype (bestla_storage.h:697-835 header)."""

    qtype: QType = QType.INT
    bits: int = 4                      # 1..8 for INT; 4 for NF4/FP4; 8 for FP8
    group_size: int = 128              # -1 => one group spanning all of K
    symmetric: bool = True             # asym adds per-group zero points
    scale_dtype: str = "float32"       # "float32" | "bfloat16"
    double_quant: bool = False         # int8 scales + secondary f32 scale
    lut: Optional[Tuple[float, ...]] = None  # custom 16-entry LUT (NF4/FP4)

    def __post_init__(self):
        if self.qtype == QType.INT:
            if not 1 <= self.bits <= 8:
                raise ValueError(f"INT bits must be in 1..8, got {self.bits}")
        elif self.qtype in (QType.NF4, QType.FP4):
            if self.bits != 4:
                raise ValueError(f"{self.qtype} requires bits=4")
            if not self.symmetric:
                raise ValueError(f"{self.qtype} is inherently symmetric")
        else:  # FP8
            if self.bits != 8:
                raise ValueError("FP8 requires bits=8")
        if self.group_size != -1 and self.group_size <= 0:
            raise ValueError(f"bad group_size {self.group_size}")
        if self.lut is not None:
            if self.qtype not in (QType.NF4, QType.FP4):
                raise ValueError("custom lut is only valid for LUT qtypes")
            if len(self.lut) != 16:
                raise ValueError(f"lut must have 16 entries, got {len(self.lut)}")

    @property
    def is_lut(self) -> bool:
        return self.qtype in (QType.NF4, QType.FP4)

    @property
    def is_fp8(self) -> bool:
        return self.qtype in (QType.FP8_E4M3, QType.FP8_E5M2)

    @property
    def code_offset(self) -> int:
        """Offset mapping unsigned stored codes -> signed values (INT only)."""
        if self.bits == 1:
            return 0  # special-cased: value = 2*code - 1
        return 1 << (self.bits - 1)

    @property
    def maxq(self) -> int:
        return (1 << (self.bits - 1)) - 1

    @property
    def minq(self) -> int:
        return -(1 << (self.bits - 1))

    def groups(self, k: int) -> int:
        g = k if self.group_size == -1 else self.group_size
        if k % g != 0:
            raise ValueError(f"K={k} not divisible by group_size={g}")
        return k // g

    def effective_group(self, k: int) -> int:
        return k if self.group_size == -1 else self.group_size


def plane_widths(bits: int) -> tuple[int, ...]:
    """Decompose a bit width into power-of-two bit planes, most significant
    first (3 -> (2, 1), 7 -> (4, 2, 1)); 8-bit is stored natively."""
    if bits == 8:
        return (8,)
    out = []
    for w in (4, 2, 1):
        if bits >= w:
            out.append(w)
            bits -= w
    return tuple(out)


def named_qspec(name: str, group_size: int = 128, symmetric: bool = True,
                scale_dtype: str = "float32",
                double_quant: bool = False) -> QSpec:
    """Build a QSpec from a user-facing dtype string (int1..int8, nf4, fp4,
    fp8 / fp8_e4m3, fp8_e5m2)."""
    name = name.lower()
    if name.startswith("int"):
        return QSpec(QType.INT, int(name[3:]), group_size, symmetric,
                     scale_dtype, double_quant)
    if name == "nf4":
        return QSpec(QType.NF4, 4, group_size, True, scale_dtype, double_quant)
    if name in ("fp4", "fp4_e2m1"):
        return QSpec(QType.FP4, 4, group_size, True, scale_dtype, double_quant)
    if name in ("fp8", "fp8_e4m3"):
        return QSpec(QType.FP8_E4M3, 8, group_size, True, scale_dtype,
                     double_quant)
    if name == "fp8_e5m2":
        return QSpec(QType.FP8_E5M2, 8, group_size, True, scale_dtype,
                     double_quant)
    raise ValueError(f"unknown quant dtype {name!r}")
