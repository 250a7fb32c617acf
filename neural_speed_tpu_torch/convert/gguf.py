"""GGUF reader + writer and the ggml block decoders (port of the tensor path
of `neural_speed_tpu/convert/gguf.py`).

* reader: `GGUFReader` (KV metadata, tensor directory, a numpy memory map
  of the data section);
* decoders: every entry of `DECODERS` (Q4_0, Q4_1, Q5_0, Q5_1, Q8_0, Q6_K,
  Q4_K, Q5_K, Q2_K, Q3_K; layouts as ggml-quants.c defines them), torch ops
  on uint8 tensors that run on the device of their input and give the JAX
  package's numpy decoders' codes, scales and offsets bit for bit.  The JAX
  package's native C++ dispatch is not ported (ROADMAP section 1, item 8).
  Integer symmetric formats map losslessly onto planar int-b `QTensor`s
  (Q4_0 -> int4 symmetric g32, Q8_0 -> int8 symmetric g32); Q4_1 / Q5_1 and
  the asymmetric K-quants use a float32 offset per group (`w = scale *
  code + zeros`); Q3_K is symmetric around code 4, Q6_K around 32;
* `load_gguf_model` for the `llama` and `mixtral` archs (decoding on the
  card unless `device="cpu"`), returning no tokenizer yet (item 8);
* `GGUFWriter`, from ggml block bytes (`encode_ggml` waits for item 8).
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, BinaryIO, Dict, List, Tuple

import numpy as np
import torch

from .._build import resolve_device
from ..models.arch import ArchConfig
from ..ops.qtypes import QSpec, QType
from ..ops.quantize import QTensor, pack_codes

GGUF_MAGIC = 0x46554747  # 'GGUF'

# gguf value types
T_U8, T_I8, T_U16, T_I16, T_U32, T_I32, T_F32, T_BOOL, T_STR, T_ARR = range(10)
T_U64, T_I64, T_F64 = 10, 11, 12

# ggml tensor dtypes (ggml.h enum)
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q4_1 = 2, 3
GGML_Q5_0, GGML_Q5_1 = 6, 7
GGML_Q8_0, GGML_Q8_1 = 8, 9
GGML_Q2_K, GGML_Q3_K, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K, GGML_Q8_K = range(10, 16)

_SCALAR_FMT = {T_U8: "<B", T_I8: "<b", T_U16: "<H", T_I16: "<h",
               T_U32: "<I", T_I32: "<i", T_F32: "<f", T_U64: "<Q",
               T_I64: "<q", T_F64: "<d", T_BOOL: "<?"}

_ITEM_8 = "ROADMAP section 1, item 8"


# ---------------------------------------------------------------------------
# low-level reader
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GGUFTensorInfo:
    name: str
    shape: Tuple[int, ...]   # ggml ne order: ne[0]=innermost (row length)
    ggml_type: int
    offset: int


class GGUFReader:
    def __init__(self, path: str):
        self.path = path
        self.kv: Dict[str, Any] = {}
        self.tensors: Dict[str, GGUFTensorInfo] = {}
        with open(path, "rb") as f:
            magic, version = struct.unpack("<II", f.read(8))
            if magic != GGUF_MAGIC:
                raise ValueError(f"not a GGUF file: {path}")
            if version < 2:
                raise ValueError(f"GGUF v{version} unsupported (need >=2)")
            n_tensors, n_kv = struct.unpack("<QQ", f.read(16))
            for _ in range(n_kv):
                key = self._str(f)
                vt = struct.unpack("<I", f.read(4))[0]
                self.kv[key] = self._value(f, vt)
            for _ in range(n_tensors):
                name = self._str(f)
                nd = struct.unpack("<I", f.read(4))[0]
                dims = struct.unpack(f"<{nd}Q", f.read(8 * nd))
                ttype, off = struct.unpack("<IQ", f.read(12))
                self.tensors[name] = GGUFTensorInfo(name, tuple(dims),
                                                    ttype, off)
            align = self.kv.get("general.alignment", 32)
            pos = f.tell()
            self.data_start = (pos + align - 1) // align * align
        self._mm = np.memmap(path, mode="r")

    @staticmethod
    def _str(f: BinaryIO) -> str:
        n = struct.unpack("<Q", f.read(8))[0]
        return f.read(n).decode("utf-8", errors="replace")

    def _value(self, f: BinaryIO, vt: int):
        if vt == T_STR:
            return self._str(f)
        if vt == T_ARR:
            at, n = struct.unpack("<IQ", f.read(12))
            return [self._value(f, at) for _ in range(n)]
        fmt = _SCALAR_FMT[vt]
        return struct.unpack(fmt, f.read(struct.calcsize(fmt)))[0]

    def tensor_bytes(self, info: GGUFTensorInfo) -> np.ndarray:
        """The tensor's block bytes as a view of the memory map."""
        nbytes = ggml_nbytes(info.shape, info.ggml_type)
        start = self.data_start + info.offset
        return np.asarray(self._mm[start:start + nbytes])

    def tensor_data(self, info: GGUFTensorInfo, device=None) -> torch.Tensor:
        """The tensor's block bytes as a uint8 tensor on `device` (the card
        unless the CPU is asked for), copied out of the read-only map."""
        raw = torch.from_numpy(np.array(self.tensor_bytes(info)))
        return raw.to(resolve_device(device))


def ggml_block_info(ttype: int) -> Tuple[int, int]:
    """(elements per block, bytes per block)."""
    return {
        GGML_F32: (1, 4), GGML_F16: (1, 2),
        GGML_Q4_0: (32, 18), GGML_Q4_1: (32, 20),
        GGML_Q5_0: (32, 22), GGML_Q5_1: (32, 24),
        GGML_Q8_0: (32, 34), GGML_Q6_K: (256, 210),
        GGML_Q4_K: (256, 144), GGML_Q5_K: (256, 176),
        GGML_Q2_K: (256, 84), GGML_Q3_K: (256, 110),
    }[ttype]


def ggml_nbytes(shape: Tuple[int, ...], ttype: int) -> int:
    n = 1
    for d in shape:
        n *= d
    be, bb = ggml_block_info(ttype)
    assert n % be == 0, (shape, ttype)
    return n // be * bb


# ---------------------------------------------------------------------------
# block decoders: raw bytes [rows, row_len] -> (codes uint8, scales, offsets)
# rows = ggml ne[1] (out features), row_len = ne[0] (in features); torch ops
# on the raw bytes' device
# ---------------------------------------------------------------------------


def _u8(raw) -> torch.Tensor:
    if isinstance(raw, torch.Tensor):
        return raw.reshape(-1)
    return torch.from_numpy(np.array(raw, dtype=np.uint8).reshape(-1))


def _blocks(raw, rows: int, row_len: int, elems: int, nbytes: int):
    nb = rows * row_len // elems
    return nb, _u8(raw)[: nb * nbytes].reshape(nb, nbytes)


def _fp16(b: torch.Tensor) -> torch.Tensor:
    """[nb, 2] little-endian fp16 bytes -> float32 [nb]."""
    return b.contiguous().view(torch.float16)[:, 0].float()


def _nibbles(qs: torch.Tensor) -> torch.Tensor:
    return torch.cat([qs & 0xF, qs >> 4], dim=1)


def decode_q4_0(raw, rows: int, row_len: int):
    nb, blk = _blocks(raw, rows, row_len, 32, 18)
    d = _fp16(blk[:, :2])
    codes = _nibbles(blk[:, 2:])
    return codes.reshape(rows, row_len), d.reshape(rows, row_len // 32), None


def decode_q4_1(raw, rows, row_len):
    nb, blk = _blocks(raw, rows, row_len, 32, 20)
    d = _fp16(blk[:, :2])
    m = _fp16(blk[:, 2:4])
    codes = _nibbles(blk[:, 4:])
    return (codes.reshape(rows, row_len), d.reshape(rows, row_len // 32),
            m.reshape(rows, row_len // 32))


def _q5_codes(qs: torch.Tensor, qh: torch.Tensor) -> torch.Tensor:
    """5th bit from the packed little-endian u32 qh."""
    qh32 = qh.contiguous().view(torch.int32)                  # [nb, 1]
    shifts = torch.arange(32, dtype=torch.int32, device=qh.device)
    bits = ((qh32 >> shifts) & 1).to(torch.uint8)              # [nb, 32]
    return _nibbles(qs) | (bits << 4)


def decode_q5_0(raw, rows, row_len):
    nb, blk = _blocks(raw, rows, row_len, 32, 22)
    d = _fp16(blk[:, :2])
    codes = _q5_codes(blk[:, 6:], blk[:, 2:6])
    return codes.reshape(rows, row_len), d.reshape(rows, row_len // 32), None


def decode_q5_1(raw, rows, row_len):
    nb, blk = _blocks(raw, rows, row_len, 32, 24)
    d = _fp16(blk[:, :2])
    m = _fp16(blk[:, 2:4])
    codes = _q5_codes(blk[:, 8:], blk[:, 4:8])
    return (codes.reshape(rows, row_len), d.reshape(rows, row_len // 32),
            m.reshape(rows, row_len // 32))


def decode_q8_0(raw, rows, row_len):
    nb, blk = _blocks(raw, rows, row_len, 32, 34)
    d = _fp16(blk[:, :2])
    q = blk[:, 2:].contiguous().view(torch.int8).to(torch.int16) + 128
    return (q.to(torch.uint8).reshape(rows, row_len),
            d.reshape(rows, row_len // 32), None)


def decode_q6_k(raw, rows, row_len):
    """Q6_K (ggml-quants.c): 256-elem super-block = ql[128] qh[64]
    scales[16]i8 d[f16]; weight = d * scales[i//16] * (q - 32)."""
    nb, blk = _blocks(raw, rows, row_len, 256, 210)
    ql = blk[:, :128]
    qh = blk[:, 128:192]
    sc = blk[:, 192:208].contiguous().view(torch.int8).float()
    d = _fp16(blk[:, 208:210])
    codes = torch.zeros((nb, 256), dtype=torch.uint8, device=blk.device)
    # layout per ggml dequantize_row_q6_K: two 128-halves
    for half in range(2):
        lo = ql[:, half * 64:(half + 1) * 64]
        hi = qh[:, half * 32:(half + 1) * 32]
        for j in range(2):  # low/high nibble of ql
            q4 = (lo >> (4 * j)) & 0xF  # [nb, 64]
            b = (hi >> (2 * j)) & 3
            b2 = (hi >> (2 * j + 4)) & 3
            base = half * 128 + j * 64
            codes[:, base: base + 32] = q4[:, :32] | (b << 4)
            codes[:, base + 32: base + 64] = q4[:, 32:] | (b2 << 4)
    scales = d[:, None] * sc  # [nb, 16]
    return (codes.reshape(rows, row_len),
            scales.reshape(rows, row_len // 16), None)


def _k4_scale_min(scales: torch.Tensor):
    """Unpack the K-quant 12-byte 6-bit scale/min table (ggml
    get_scale_min_k4): 8 scales + 8 mins per 256-elem super-block.
    `scales` is [nb, 12] uint8 -> ([nb, 8], [nb, 8]) uint8."""
    sc = torch.cat([scales[:, :4] & 63,
                    (scales[:, 8:12] & 0xF) | ((scales[:, :4] >> 6) << 4)], 1)
    mn = torch.cat([scales[:, 4:8] & 63,
                    (scales[:, 8:12] >> 4) | ((scales[:, 4:8] >> 6) << 4)], 1)
    return sc, mn


def decode_q4_k(raw, rows, row_len):
    """Q4_K (ggml-quants.c dequantize_row_q4_K): 256-elem super-block =
    d[f16] dmin[f16] scales[12] qs[128]; 8 sub-blocks of 32 with 6-bit
    scale/min: w = d*sc[j]*q - dmin*m[j].  Returned as float per-sub-block
    scale + float offset (the Q4_1 convention: w = scale*code + m)."""
    nb, blk = _blocks(raw, rows, row_len, 256, 144)
    d = _fp16(blk[:, 0:2])
    dmin = _fp16(blk[:, 2:4])
    sc, mn = _k4_scale_min(blk[:, 4:16])
    qs = blk[:, 16:144]
    # 64-elem chunks: low nibbles then high nibbles
    codes = torch.cat([_nibbles(qs[:, 32 * c: 32 * c + 32])
                       for c in range(4)], dim=1)
    scales = d[:, None] * sc.float()          # [nb, 8]
    offs = -(dmin[:, None] * mn.float())      # [nb, 8]
    return (codes.reshape(rows, row_len),
            scales.reshape(rows, row_len // 32),
            offs.reshape(rows, row_len // 32))


def decode_q5_k(raw, rows, row_len):
    """Q5_K: d[f16] dmin[f16] scales[12] qh[32] qs[128]; the 5th bit of
    chunk c's low/high nibble comes from qh bit 2c / 2c+1."""
    nb, blk = _blocks(raw, rows, row_len, 256, 176)
    d = _fp16(blk[:, 0:2])
    dmin = _fp16(blk[:, 2:4])
    sc, mn = _k4_scale_min(blk[:, 4:16])
    qh = blk[:, 16:48]
    qs = blk[:, 48:176]
    parts = []
    for c in range(4):
        q = qs[:, 32 * c: 32 * c + 32]
        lo5 = ((qh >> (2 * c)) & 1) << 4
        hi5 = ((qh >> (2 * c + 1)) & 1) << 4
        parts += [(q & 0xF) | lo5, (q >> 4) | hi5]
    codes = torch.cat(parts, dim=1)
    scales = d[:, None] * sc.float()
    offs = -(dmin[:, None] * mn.float())
    return (codes.reshape(rows, row_len),
            scales.reshape(rows, row_len // 32),
            offs.reshape(rows, row_len // 32))


def _two_bit_planes(qs: torch.Tensor) -> torch.Tensor:
    """Q2_K / Q3_K low bits: two 128-elem halves, qs advancing 32 bytes;
    plane j of a half holds bits 2j..2j+1 -> [nb, 256]."""
    return torch.cat([(qs[:, 32 * outer: 32 * outer + 32] >> (2 * j)) & 3
                      for outer in range(2) for j in range(4)], dim=1)


def decode_q2_k(raw, rows, row_len):
    """Q2_K: scales[16] qs[64] d[f16] dmin[f16]; 16 sub-blocks of 16 with
    4-bit scale/min nibbles: w = d*(sc&0xF)*q - dmin*(sc>>4)."""
    nb, blk = _blocks(raw, rows, row_len, 256, 84)
    scq = blk[:, :16]
    d = _fp16(blk[:, 80:82])
    dmin = _fp16(blk[:, 82:84])
    codes = _two_bit_planes(blk[:, 16:80])
    scales = d[:, None] * (scq & 0xF).float()       # [nb, 16]
    offs = -(dmin[:, None] * (scq >> 4).float())
    return (codes.reshape(rows, row_len),
            scales.reshape(rows, row_len // 16),
            offs.reshape(rows, row_len // 16))


def _q3k_scales(scales: torch.Tensor) -> torch.Tensor:
    """Q3_K 12-byte -> 16 6-bit scales (ggml kmask unpack), returned as
    int (value range 0..63; subtract 32 for the signed scale)."""
    b = scales.to(torch.int32)
    cols = [None] * 16
    for i in range(4):
        cols[i] = (b[:, i] & 0xF) | ((b[:, 8 + i] & 3) << 4)
        cols[4 + i] = (b[:, 4 + i] & 0xF) | (((b[:, 8 + i] >> 2) & 3) << 4)
        cols[8 + i] = (b[:, i] >> 4) | (((b[:, 8 + i] >> 4) & 3) << 4)
        cols[12 + i] = (b[:, 4 + i] >> 4) | (((b[:, 8 + i] >> 6) & 3) << 4)
    return torch.stack(cols, dim=1).to(torch.uint8)


def decode_q3_k(raw, rows, row_len):
    """Q3_K: hmask[32] qs[64] scales[12] d[f16]; 16 sub-blocks of 16,
    6-bit scales - 32, w = d*(sc-32)*(q3 - 4) with q3 = 2-bit + hmask
    high bit (hmask bit index = outer*4 + plane)."""
    nb, blk = _blocks(raw, rows, row_len, 256, 110)
    hm = blk[:, :32]
    sc6 = _q3k_scales(blk[:, 96:108])
    d = _fp16(blk[:, 108:110])
    hbits = torch.cat([(hm >> (4 * outer + j)) & 1
                       for outer in range(2) for j in range(4)], dim=1)
    codes = _two_bit_planes(blk[:, 32:96]) | (hbits << 2)
    scales = d[:, None] * (sc6.float() - 32.0)      # [nb, 16]
    return (codes.reshape(rows, row_len),
            scales.reshape(rows, row_len // 16), None)


DECODERS = {
    GGML_Q4_0: (decode_q4_0, 4, 32, 8),
    GGML_Q4_1: (decode_q4_1, 4, 32, None),   # float offset
    GGML_Q5_0: (decode_q5_0, 5, 32, 16),
    GGML_Q5_1: (decode_q5_1, 5, 32, None),
    GGML_Q8_0: (decode_q8_0, 8, 32, 128),
    GGML_Q6_K: (decode_q6_k, 6, 16, 32),
    GGML_Q4_K: (decode_q4_k, 4, 32, None),
    GGML_Q5_K: (decode_q5_k, 5, 32, None),
    GGML_Q2_K: (decode_q2_k, 2, 16, None),
    GGML_Q3_K: (decode_q3_k, 3, 16, 4),
}


def gguf_tensor_to_qtensor(raw, shape, ttype: int) -> QTensor:
    """ggml 2-D tensor -> the port's `[K, N]` QTensor (transposed: ggml rows
    are out-features), on the device of `raw` (a uint8 tensor or a numpy
    array, which stays on the CPU).  Integer formats are mapped exactly."""
    row_len, rows = shape[0], shape[1]  # ne[0]=in(K), ne[1]=out(N)
    dec, bits, group, offset = DECODERS[ttype]
    codes, scales, m = dec(raw, rows, row_len)
    spec = QSpec(QType.INT, bits, group, symmetric=(m is None))
    data = pack_codes(codes.t().contiguous(), bits)       # [K, N]
    zeros = None
    if m is not None:
        # float per-group offset: w = scale*code + zeros_f
        zeros = m.t().contiguous()
    return QTensor(data, scales.t().contiguous(), zeros, None, spec,
                   (row_len, rows))


def gguf_tensor_to_array(reader: GGUFReader, info: GGUFTensorInfo,
                         dtype=torch.float32, device=None) -> torch.Tensor:
    """F32 / F16 / quantized ggml tensor -> a dense tensor in ggml
    orientation `[rows, row_len]`, decoded on `device` (the card unless the
    CPU is asked for)."""
    raw = reader.tensor_data(info, device)
    if info.ggml_type == GGML_F32:
        a = raw.view(torch.float32).reshape(info.shape[::-1])
    elif info.ggml_type == GGML_F16:
        a = raw.view(torch.float16).float().reshape(info.shape[::-1])
    else:
        dec, bits, group, offset = DECODERS[info.ggml_type]
        row_len = info.shape[0]
        rows = info.shape[1] if len(info.shape) > 1 else 1
        codes, scales, m = dec(raw, rows, row_len)
        sf = torch.repeat_interleave(scales, group, dim=1)
        if m is None:
            a = (codes.float() - offset) * sf
        else:
            a = codes.float() * sf + torch.repeat_interleave(m, group, dim=1)
        a = a.reshape(*([rows, row_len] if len(info.shape) > 1 else
                        [row_len]))
    return a.to(dtype)


# ---------------------------------------------------------------------------
# writer (ggml block bytes in, as the JAX package's GGUFWriter writes them)
# ---------------------------------------------------------------------------


def _vt_of(v) -> int:
    if isinstance(v, bool):
        return T_BOOL
    if isinstance(v, int):
        return T_U32 if 0 <= v < 2 ** 32 else T_I64
    if isinstance(v, float):
        return T_F32
    if isinstance(v, str):
        return T_STR
    raise TypeError(type(v))


class GGUFWriter:
    def __init__(self, path: str):
        self.path = path
        self.kv: List[Tuple[str, Any]] = []
        self.tensors: List[Tuple[str, Tuple[int, ...], int, np.ndarray]] = []

    def add(self, key: str, value: Any):
        self.kv.append((key, value))

    def add_tensor(self, name: str, data, ggml_type: int, raw=None):
        """`data` gives the shape in ggml orientation [rows(out),
        row_len(in)] (only its `.shape` is read); `raw` holds the tensor's
        block bytes (bytes, a numpy array or a tensor, copied here).
        Encoding floats into blocks (`encode_ggml`) is not ported yet."""
        if raw is None:
            raise NotImplementedError(
                f"encode_ggml is not ported yet ({_ITEM_8}): pass the "
                f"block bytes as raw=")
        if isinstance(raw, torch.Tensor):
            raw = raw.detach().cpu().contiguous().numpy()
        raw = np.frombuffer(raw, dtype=np.uint8) if isinstance(
            raw, (bytes, bytearray)) else np.ascontiguousarray(raw).view(
                np.uint8).reshape(-1)
        shape = (data.shape[-1],) + tuple(reversed(data.shape[:-1]))
        self.tensors.append((name, tuple(int(s) for s in shape), ggml_type,
                             raw))

    @staticmethod
    def _wstr(f: BinaryIO, s: str):
        b = s.encode("utf-8")
        f.write(struct.pack("<Q", len(b)))
        f.write(b)

    def _wvalue(self, f: BinaryIO, v):
        if isinstance(v, list):
            f.write(struct.pack("<I", T_ARR))
            assert v, "empty arrays unsupported"
            et = _vt_of(v[0])
            f.write(struct.pack("<IQ", et, len(v)))
            for item in v:
                self._wscalar(f, item, et)
        else:
            vt = _vt_of(v)
            f.write(struct.pack("<I", vt))
            self._wscalar(f, v, vt)

    def _wscalar(self, f: BinaryIO, v, vt: int):
        if vt == T_STR:
            self._wstr(f, v)
        else:
            f.write(struct.pack(_SCALAR_FMT[vt], v))

    def write(self):
        align = 32
        with open(self.path, "wb") as f:
            f.write(struct.pack("<IIQQ", GGUF_MAGIC, 3, len(self.tensors),
                                len(self.kv)))
            for k, v in self.kv:
                self._wstr(f, k)
                self._wvalue(f, v)
            offset = 0
            for name, shape, ttype, raw in self.tensors:
                self._wstr(f, name)
                f.write(struct.pack("<I", len(shape)))
                f.write(struct.pack(f"<{len(shape)}Q", *shape))
                f.write(struct.pack("<IQ", ttype, offset))
                offset += (raw.size + align - 1) // align * align
            pos = f.tell()
            pad = (pos + align - 1) // align * align - pos
            f.write(b"\0" * pad)
            for name, shape, ttype, raw in self.tensors:
                f.write(memoryview(raw))
                pad = (raw.size + align - 1) // align * align - raw.size
                f.write(b"\0" * pad)


# ---------------------------------------------------------------------------
# model loading (llama and mixtral)
# ---------------------------------------------------------------------------


def _arch_from_gguf(kv: Dict[str, Any], tensors=None) -> ArchConfig:
    """The `llama` (the JAX package's generic branch) and `mixtral` archs;
    the others raise (their knobs are not ported: ROADMAP section 1,
    item 1)."""
    arch = kv["general.architecture"]
    if arch not in ("llama", "mixtral"):
        raise NotImplementedError(
            f"GGUF arch {arch!r} is not ported yet (ROADMAP section 1, item "
            f"1: the HF archs)")
    pre = arch

    def g(key, default=None):
        return kv.get(f"{pre}.{key}", default)

    n_heads = g("attention.head_count")
    vocab = kv.get("tokenizer.ggml.tokens")
    vocab_size = (len(vocab) if vocab is not None
                  else g("vocab_size", kv.get("general.vocab_size")))
    e = g("embedding_length")
    if arch == "mixtral":
        from ..models.configs import mixtral_arch

        return mixtral_arch({
            "vocab_size": vocab_size,
            "hidden_size": e,
            "num_hidden_layers": g("block_count"),
            "num_attention_heads": n_heads,
            "num_key_value_heads": g("attention.head_count_kv", n_heads),
            "intermediate_size": g("feed_forward_length"),
            "max_position_embeddings": g("context_length", 4096),
            "rms_norm_eps": g("attention.layer_norm_rms_epsilon", 1e-5),
            "rope_theta": g("rope.freq_base", 10000.0),
            "num_local_experts": g("expert_count", 8),
            "num_experts_per_tok": g("expert_used_count", 2),
        })
    return ArchConfig(
        name=arch,
        vocab_size=vocab_size,
        hidden_size=e,
        n_layers=g("block_count"),
        n_heads=n_heads,
        n_kv_heads=g("attention.head_count_kv", n_heads),
        intermediate_size=g("feed_forward_length"),
        max_position_embeddings=g("context_length", 4096),
        norm="rms",
        norm_eps=g("attention.layer_norm_rms_epsilon", 1e-5),
        rope_style="neox",
        rope_base=g("rope.freq_base", 10000.0),
        act="silu",
    )


def load_gguf_model(path: str, device=None):
    """Returns (params, ArchConfig, None) for a `llama` or `mixtral` GGUF
    file, each tensor decoded on `device` (the card unless the CPU is asked
    for).  The tokenizer is not ported yet (ROADMAP section 1, item 8).
    As in the JAX package, a `llama` file that carries `ffn_gate_inp`
    tensors fails: its config has no MoE section."""
    dev = resolve_device(device)
    r = GGUFReader(path)
    cfg = _arch_from_gguf(r.kv, r.tensors)

    def lin(name):
        info = r.tensors[name]
        if info.ggml_type in DECODERS:
            return {"w": gguf_tensor_to_qtensor(
                r.tensor_data(info, dev), info.shape, info.ggml_type)}
        return {"w": gguf_tensor_to_array(r, info, torch.bfloat16,
                                          dev).t().contiguous()}

    def arr(name, dtype=torch.float32):
        return gguf_tensor_to_array(r, r.tensors[name], dtype, dev)

    def lin_b(base):
        out = lin(base + ".weight")
        if base + ".bias" in r.tensors:
            out["b"] = arr(base + ".bias")
        return out

    def norm_g(base):
        out = {"weight": arr(base + ".weight")}
        if base + ".bias" in r.tensors:
            out["bias"] = arr(base + ".bias")
        return out

    params: Dict[str, Any] = {
        "embed": {"weight": arr("token_embd.weight", torch.bfloat16)},
        "layers": [],
        "final_norm": norm_g("output_norm"),
    }
    if "output.weight" in r.tensors:
        params["lm_head"] = lin_b("output")
    for i in range(cfg.n_layers):
        b = f"blk.{i}."
        lp: Dict[str, Any] = {"attn_norm": norm_g(b + "attn_norm")}
        if b + "ffn_norm.weight" in r.tensors:
            lp["ffn_norm"] = norm_g(b + "ffn_norm")
        lp["q"] = lin_b(b + "attn_q")
        lp["k"] = lin_b(b + "attn_k")
        lp["v"] = lin_b(b + "attn_v")
        lp["o"] = lin_b(b + "attn_output")
        if b + "ffn_gate_inp.weight" in r.tensors:  # mixtral MoE
            lp["moe"] = {
                "router": {"w": arr(b + "ffn_gate_inp.weight").t()
                           .contiguous()},
                "experts": [{
                    "gate": lin(f"{b}ffn_gate.{ei}.weight"),
                    "up": lin(f"{b}ffn_up.{ei}.weight"),
                    "down": lin(f"{b}ffn_down.{ei}.weight"),
                } for ei in range(cfg.moe.num_experts)],
            }
        else:
            lp["ffn"] = {"up": lin_b(b + "ffn_up"),
                         "down": lin_b(b + "ffn_down")}
            if b + "ffn_gate.weight" in r.tensors:
                lp["ffn"]["gate"] = lin_b(b + "ffn_gate")
        params["layers"].append(lp)
    return params, cfg, None
