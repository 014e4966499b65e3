"""Minimal GGUF reader and writer (numpy, host side).

A copy of `qwen3_tts_tpu/assets/gguf.py`: the port keeps its own, because
importing any module of the JAX package imports JAX. GGUF v2/v3 header,
metadata key/values (arrays included), tensor infos, then 32-byte-aligned
tensor data. `GGUFFile.read_tensor` returns numpy arrays: F32 and F16 as
stored, llama.cpp's Q8_0 / Q4_K / Q5_K / Q6_K dequantised to f32 (the
dequantisers equal the JAX package's bit for bit). `write_gguf` writes an
F32 container, as the asset file and the llama.cpp decoder layout use.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Any, BinaryIO, Dict, List, Tuple

import numpy as np

GGUF_MAGIC = b"GGUF"
ALIGNMENT_KEY = "general.alignment"
DEFAULT_ALIGNMENT = 32

# GGUF metadata value types
_U8, _I8, _U16, _I16, _U32, _I32, _F32, _BOOL, _STR, _ARR, _U64, _I64, _F64 = range(13)

_SCALAR_FMT = {
    _U8: "<B", _I8: "<b", _U16: "<H", _I16: "<h", _U32: "<I", _I32: "<i",
    _F32: "<f", _BOOL: "<?", _U64: "<Q", _I64: "<q", _F64: "<d",
}

# GGML tensor dtypes we can materialise
_GGML_F32 = 0
_GGML_F16 = 1
_GGML_Q8_0 = 8
_GGML_Q4_K = 12
_GGML_Q5_K = 13
_GGML_Q6_K = 14
_GGML_DTYPES = {_GGML_F32: np.float32, _GGML_F16: np.float16}

_Q8_0_BLOCK = 32            # elements per Q8_0 block
_Q8_0_BYTES = 2 + _Q8_0_BLOCK   # f16 scale + 32 int8
QK_K = 256                  # k-quant super-block size
_KQ_BYTES = {_GGML_Q4_K: 144, _GGML_Q5_K: 176, _GGML_Q6_K: 210}


def dequant_q8_0(raw: bytes, count: int) -> np.ndarray:
    """llama.cpp Q8_0: blocks of 32 int8 values scaled by one f16,
    dequantised at load time to the model dtype."""
    n_blocks = count // _Q8_0_BLOCK
    buf = np.frombuffer(raw, np.uint8, count=n_blocks * _Q8_0_BYTES)
    blocks = buf.reshape(n_blocks, _Q8_0_BYTES)
    scales = blocks[:, :2].copy().view(np.float16).astype(np.float32)
    qs = blocks[:, 2:].copy().view(np.int8).astype(np.float32)
    return (qs * scales).reshape(-1)


def _kq_scale_min(scales: np.ndarray):
    """Unpack the 8 (scale, min) 6-bit pairs per super-block from the
    12-byte k-quant `scales` field (llama.cpp get_scale_min_k4)."""
    q = scales.astype(np.uint16)                    # [n, 12]
    sc = np.empty((q.shape[0], 8), np.float32)
    mn = np.empty((q.shape[0], 8), np.float32)
    for j in range(4):
        sc[:, j] = q[:, j] & 63
        mn[:, j] = q[:, j + 4] & 63
    for j in range(4, 8):
        sc[:, j] = (q[:, j + 4] & 0xF) | ((q[:, j - 4] >> 6) << 4)
        mn[:, j] = (q[:, j + 4] >> 4) | ((q[:, j] >> 6) << 4)
    return sc, mn


def dequant_q4_k(raw: bytes, count: int) -> np.ndarray:
    """llama.cpp Q4_K: 256-element super-blocks, 8 sub-blocks with 6-bit
    scales/mins against f16 super-scales, 4-bit quants."""
    n = count // QK_K
    b = np.frombuffer(raw, np.uint8, count=n * 144).reshape(n, 144)
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)[:, 0]
    dmin = b[:, 2:4].copy().view(np.float16).astype(np.float32)[:, 0]
    sc, mn = _kq_scale_min(b[:, 4:16])
    qs = b[:, 16:144]                               # [n, 128]
    out = np.empty((n, QK_K), np.float32)
    # layout: per 64 elements, two sub-blocks share 32 ql bytes (lo/hi nibble)
    for half in range(4):                           # j = 0, 64, 128, 192
        ql = qs[:, half * 32:(half + 1) * 32].astype(np.float32)
        s1, m1 = sc[:, 2 * half], mn[:, 2 * half]
        s2, m2 = sc[:, 2 * half + 1], mn[:, 2 * half + 1]
        lo = np.mod(ql, 16.0)
        hi = np.floor(ql / 16.0)
        base = half * 64
        out[:, base:base + 32] = (d * s1)[:, None] * lo - (dmin * m1)[:, None]
        out[:, base + 32:base + 64] = (d * s2)[:, None] * hi - (dmin * m2)[:, None]
    return out.reshape(-1)


def dequant_q5_k(raw: bytes, count: int) -> np.ndarray:
    """llama.cpp Q5_K: Q4_K layout plus a 32-byte high-bit plane (5-bit
    quants) — the reference's best-RTF release format (Q5_K_M)."""
    n = count // QK_K
    b = np.frombuffer(raw, np.uint8, count=n * 176).reshape(n, 176)
    d = b[:, 0:2].copy().view(np.float16).astype(np.float32)[:, 0]
    dmin = b[:, 2:4].copy().view(np.float16).astype(np.float32)[:, 0]
    sc, mn = _kq_scale_min(b[:, 4:16])
    qh = b[:, 16:48]                                # [n, 32]
    qs = b[:, 48:176]                               # [n, 128]
    out = np.empty((n, QK_K), np.float32)
    for half in range(4):                           # j = 0, 64, 128, 192
        ql = qs[:, half * 32:(half + 1) * 32]
        u1 = 1 << (2 * half)
        u2 = 2 << (2 * half)
        lo = (ql & 0xF).astype(np.float32) + \
            np.where(qh & u1, 16.0, 0.0).astype(np.float32)
        hi = (ql >> 4).astype(np.float32) + \
            np.where(qh & u2, 16.0, 0.0).astype(np.float32)
        s1, m1 = sc[:, 2 * half], mn[:, 2 * half]
        s2, m2 = sc[:, 2 * half + 1], mn[:, 2 * half + 1]
        base = half * 64
        out[:, base:base + 32] = (d * s1)[:, None] * lo - (dmin * m1)[:, None]
        out[:, base + 32:base + 64] = (d * s2)[:, None] * hi - (dmin * m2)[:, None]
    return out.reshape(-1)


def dequant_q6_k(raw: bytes, count: int) -> np.ndarray:
    """llama.cpp Q6_K: 6-bit quants (4-bit ql + 2-bit qh), 16 int8 scales,
    one f16 super-scale."""
    n = count // QK_K
    b = np.frombuffer(raw, np.uint8, count=n * 210).reshape(n, 210)
    ql = b[:, 0:128]
    qh = b[:, 128:192]
    sc = b[:, 192:208].copy().view(np.int8).astype(np.float32)
    d = b[:, 208:210].copy().view(np.float16).astype(np.float32)[:, 0]
    out = np.empty((n, QK_K), np.float32)
    for nblk in range(2):                           # n = 0, 128
        qlb = ql[:, nblk * 64:(nblk + 1) * 64]
        qhb = qh[:, nblk * 32:(nblk + 1) * 32]
        scb = sc[:, nblk * 8:(nblk + 1) * 8]
        l = np.arange(32)
        is_ = l // 16                               # [32] in {0,1}
        q1 = (qlb[:, :32] & 0xF).astype(np.int16) | (((qhb >> 0) & 3).astype(np.int16) << 4)
        q2 = (qlb[:, 32:] & 0xF).astype(np.int16) | (((qhb >> 2) & 3).astype(np.int16) << 4)
        q3 = (qlb[:, :32] >> 4).astype(np.int16) | (((qhb >> 4) & 3).astype(np.int16) << 4)
        q4 = (qlb[:, 32:] >> 4).astype(np.int16) | (((qhb >> 6) & 3).astype(np.int16) << 4)
        base = nblk * 128
        for qv, off, srow in ((q1, 0, 0), (q2, 32, 2), (q3, 64, 4), (q4, 96, 6)):
            scale = scb[:, srow + is_]              # [n, 32]
            out[:, base + off:base + off + 32] = \
                d[:, None] * scale * (qv.astype(np.float32) - 32.0)
    return out.reshape(-1)


_KQ_DEQUANT = {
    _GGML_Q4_K: dequant_q4_k,
    _GGML_Q5_K: dequant_q5_k,
    _GGML_Q6_K: dequant_q6_k,
}


def _read_str(f: BinaryIO) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8")


def _read_value(f: BinaryIO, vtype: int) -> Any:
    if vtype in _SCALAR_FMT:
        fmt = _SCALAR_FMT[vtype]
        (v,) = struct.unpack(fmt, f.read(struct.calcsize(fmt)))
        return v
    if vtype == _STR:
        return _read_str(f)
    if vtype == _ARR:
        (elem_type,) = struct.unpack("<I", f.read(4))
        (count,) = struct.unpack("<Q", f.read(8))
        return [_read_value(f, elem_type) for _ in range(count)]
    raise ValueError(f"unknown GGUF metadata value type {vtype}")


@dataclass
class TensorInfo:
    name: str
    shape: Tuple[int, ...]   # logical (row-major numpy) shape
    ggml_type: int
    offset: int              # relative to data section start


class GGUFFile:
    """Parsed GGUF container; tensor data is read lazily per tensor."""

    def __init__(self, path: str):
        self.path = path
        self.metadata: Dict[str, Any] = {}
        self.tensors: Dict[str, TensorInfo] = {}
        with open(path, "rb") as f:
            if f.read(4) != GGUF_MAGIC:
                raise ValueError(f"{path}: not a GGUF file")
            (version,) = struct.unpack("<I", f.read(4))
            if version < 2:
                raise ValueError(f"{path}: unsupported GGUF version {version}")
            (n_tensors,) = struct.unpack("<Q", f.read(8))
            (n_kv,) = struct.unpack("<Q", f.read(8))
            for _ in range(n_kv):
                key = _read_str(f)
                (vtype,) = struct.unpack("<I", f.read(4))
                self.metadata[key] = _read_value(f, vtype)
            infos: List[TensorInfo] = []
            for _ in range(n_tensors):
                name = _read_str(f)
                (n_dims,) = struct.unpack("<I", f.read(4))
                dims = struct.unpack(f"<{n_dims}Q", f.read(8 * n_dims))
                (ggml_type,) = struct.unpack("<I", f.read(4))
                (offset,) = struct.unpack("<Q", f.read(8))
                # GGUF stores dims innermost-first; numpy wants outermost-first.
                infos.append(TensorInfo(name, tuple(reversed(dims)), ggml_type, offset))
            align = int(self.metadata.get(ALIGNMENT_KEY, DEFAULT_ALIGNMENT))
            pos = f.tell()
            self.data_start = pos + (-pos) % align
            self.tensors = {t.name: t for t in infos}

    def read_tensor(self, name: str) -> np.ndarray:
        info = self.tensors[name]
        count = int(np.prod(info.shape)) if info.shape else 1
        if info.ggml_type == _GGML_Q8_0:
            n_bytes = (count // _Q8_0_BLOCK) * _Q8_0_BYTES
            with open(self.path, "rb") as f:
                f.seek(self.data_start + info.offset)
                raw = f.read(n_bytes)
            if len(raw) != n_bytes:
                raise ValueError(f"tensor {name!r}: truncated data")
            return dequant_q8_0(raw, count).reshape(info.shape)
        if info.ggml_type in _KQ_DEQUANT:
            n_bytes = (count // QK_K) * _KQ_BYTES[info.ggml_type]
            with open(self.path, "rb") as f:
                f.seek(self.data_start + info.offset)
                raw = f.read(n_bytes)
            if len(raw) != n_bytes:
                raise ValueError(f"tensor {name!r}: truncated data")
            return _KQ_DEQUANT[info.ggml_type](raw, count).reshape(info.shape)
        if info.ggml_type not in _GGML_DTYPES:
            raise ValueError(
                f"tensor {name!r}: unsupported ggml type {info.ggml_type} "
                "(F32/F16/Q8_0/Q4_K/Q5_K/Q6_K supported)"
            )
        dtype = _GGML_DTYPES[info.ggml_type]
        with open(self.path, "rb") as f:
            f.seek(self.data_start + info.offset)
            data = np.fromfile(f, dtype=dtype, count=count)
        if data.size != count:
            raise ValueError(f"tensor {name!r}: truncated data")
        return data.reshape(info.shape)


def write_gguf(path: str, tensors: Dict[str, np.ndarray],
               metadata: Dict[str, Any] | None = None) -> None:
    """Write an F32 GGUF container (used by tests and asset conversion)."""
    metadata = dict(metadata or {})
    with open(path, "wb") as f:
        f.write(GGUF_MAGIC)
        f.write(struct.pack("<I", 3))
        f.write(struct.pack("<Q", len(tensors)))
        f.write(struct.pack("<Q", len(metadata)))

        def w_str(s: str):
            b = s.encode("utf-8")
            f.write(struct.pack("<Q", len(b)))
            f.write(b)

        for key, val in metadata.items():
            w_str(key)
            if isinstance(val, bool):
                f.write(struct.pack("<I", _BOOL) + struct.pack("<?", val))
            elif isinstance(val, int):
                f.write(struct.pack("<I", _I64) + struct.pack("<q", val))
            elif isinstance(val, float):
                f.write(struct.pack("<I", _F64) + struct.pack("<d", val))
            elif isinstance(val, str):
                f.write(struct.pack("<I", _STR))
                w_str(val)
            elif isinstance(val, (list, tuple)) and all(isinstance(x, int) for x in val):
                f.write(struct.pack("<I", _ARR))
                f.write(struct.pack("<I", _I64))
                f.write(struct.pack("<Q", len(val)))
                for x in val:
                    f.write(struct.pack("<q", x))
            else:
                raise ValueError(f"unsupported metadata value for {key!r}: {val!r}")

        offset = 0
        ordered = list(tensors.items())
        for name, arr in ordered:
            shape = np.shape(arr)    # the copy to f32 is made once, below
            w_str(name)
            f.write(struct.pack("<I", len(shape)))
            for d in reversed(shape):
                f.write(struct.pack("<Q", d))
            f.write(struct.pack("<I", _GGML_F32))
            f.write(struct.pack("<Q", offset))
            offset += 4 * int(np.prod(shape))
            offset += (-offset) % DEFAULT_ALIGNMENT

        pos = f.tell()
        f.write(b"\x00" * ((-pos) % DEFAULT_ALIGNMENT))
        for name, arr in ordered:
            arr = np.ascontiguousarray(arr, dtype=np.float32)
            f.write(arr.tobytes())
            f.write(b"\x00" * ((-arr.nbytes) % DEFAULT_ALIGNMENT))
