"""Minimal ONNX reader and writer: the protobuf wire format, numpy only.

A copy of `qwen3_tts_tpu/assets/onnx.py`: the port keeps its own, because
importing any module of the JAX package imports JAX. The reference ships
its codec models (the vocoder and the two encoders) as ONNX graphs run by
ONNX Runtime; the port runs those architectures natively
(`models/vocoder.py`, `models/encoders.py`) and needs only the weights and
enough of the graph's structure to check the architecture, both of which
live in the GraphProto, plain protobuf.

  * `read_model(path)` -> OnnxModel(initializers {name: np.ndarray},
    nodes [OnnxNode], inputs / outputs [(name, elem_type, dims)]);
  * `write_model(path, ...)`, the inverse, for round trips and for writing
    graphs in the torch-export idiom (`tools/convert_weights.py`).

Field numbers follow the public onnx.proto3 schema (ModelProto.graph = 7,
GraphProto.{node=1, initializer=5, input=11, output=12}, NodeProto.{input=1,
output=2, name=3, op_type=4, attribute=5}, TensorProto.{dims=1, data_type=2,
float_data=4, int32_data=5, int64_data=7, name=8, raw_data=9},
AttributeProto.{name=1, f=2, i=3, s=4, floats=7, ints=8}).

The JAX package's refusals are kept as they are: externally hosted data
(TensorProto fields 13 / 14), data types outside `_DTYPES` (no bfloat16)
and payloads whose size does not match the dims. Both directions give
the JAX package's results (the written bytes equal, the parsed arrays
equal and read-only, as `np.frombuffer` makes them); they differ only in
memory: the reader maps the file instead of reading it into one bytes
object, and the writer streams the graph's pieces to the file instead of
growing one bytes object, so a 600 MiB graph is neither held twice nor
copied once per initializer.
"""

from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# TensorProto.DataType
_DTYPES = {
    1: np.dtype(np.float32), 2: np.dtype(np.uint8), 3: np.dtype(np.int8),
    4: np.dtype(np.uint16), 5: np.dtype(np.int16), 6: np.dtype(np.int32),
    7: np.dtype(np.int64), 9: np.dtype(np.bool_), 10: np.dtype(np.float16),
    11: np.dtype(np.float64), 12: np.dtype(np.uint32),
    13: np.dtype(np.uint64),
}
_DTYPE_CODES = {v: k for k, v in _DTYPES.items()}
FLOAT, INT64 = 1, 7


# --------------------------------------------------------------- wire format
def _read_varint(buf: memoryview, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 70:
            raise ValueError("corrupt varint")


def _fields(buf: memoryview):
    """Yield (field_number, wire_type, value) triples of one message."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        fnum, wire = key >> 3, key & 7
        if wire == 0:                      # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 1:                    # 64-bit
            val = bytes(buf[pos:pos + 8])
            pos += 8
        elif wire == 2:                    # length-delimited
            ln, pos = _read_varint(buf, pos)
            if pos + ln > n:
                raise ValueError("truncated length-delimited field")
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == 5:                    # 32-bit
            val = bytes(buf[pos:pos + 4])
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield fnum, wire, val


def _packed_varints(buf: memoryview) -> List[int]:
    out, pos = [], 0
    while pos < len(buf):
        v, pos = _read_varint(buf, pos)
        out.append(v)
    return out


def _zz(v: int, bits: int = 64) -> int:
    """Two's-complement interpretation of a varint (int64 fields)."""
    if v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


# ------------------------------------------------------------------- parsing
@dataclass
class OnnxNode:
    op_type: str
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    name: str = ""
    attrs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class OnnxModel:
    initializers: Dict[str, np.ndarray]
    nodes: List[OnnxNode]
    inputs: List[Tuple[str, int, Tuple[Optional[int], ...]]]
    outputs: List[Tuple[str, int, Tuple[Optional[int], ...]]]
    graph_name: str = ""

    def ops(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for n in self.nodes:
            out[n.op_type] = out.get(n.op_type, 0) + 1
        return out


def _parse_tensor(buf: memoryview) -> Tuple[str, np.ndarray]:
    dims: List[int] = []
    dtype_code = 1
    name = ""
    raw = None
    f32: List[float] = []
    i32: List[int] = []
    i64: List[int] = []
    f64: List[float] = []
    for fnum, wire, val in _fields(buf):
        if fnum == 1:
            dims.extend(_zz(v) for v in _packed_varints(val)) \
                if wire == 2 else dims.append(_zz(val))
        elif fnum == 2:
            dtype_code = val
        elif fnum == 4:
            f32.extend(struct.unpack(f"<{len(val)//4}f", bytes(val))
                       if wire == 2 else struct.unpack("<f", val))
        elif fnum == 5:
            i32.extend(_packed_varints(val) if wire == 2 else [val])
        elif fnum == 7:
            i64.extend(_zz(v) for v in _packed_varints(val)) \
                if wire == 2 else i64.append(_zz(val))
        elif fnum == 8:
            name = bytes(val).decode("utf-8")
        elif fnum == 9:
            raw = bytes(val)
        elif fnum == 10:
            f64.extend(struct.unpack(f"<{len(val)//8}d", bytes(val))
                       if wire == 2 else struct.unpack("<d", val))
        elif fnum == 13 or fnum == 14:
            raise ValueError(
                f"tensor {name or '?'}: externally-hosted data is not "
                "supported (re-export with embedded weights)")
    if dtype_code not in _DTYPES:
        raise ValueError(f"tensor {name}: unsupported data_type {dtype_code}")
    dt = _DTYPES[dtype_code]
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dt)
    elif f32:
        arr = np.asarray(f32, np.float32).astype(dt)
    elif i64:
        arr = np.asarray(i64, np.int64).astype(dt)
    elif i32:
        # int32_data also carries int8/16/bool/float16 payloads per the spec
        a = np.asarray(i32, np.int64)
        arr = a.view(np.uint64).astype(np.uint16).view(np.float16) \
            if dt == np.float16 else a.astype(dt)
    elif f64:
        arr = np.asarray(f64, np.float64).astype(dt)
    else:
        arr = np.zeros(0, dt)
    want = int(np.prod(dims)) if dims else arr.size
    if arr.size != want:
        raise ValueError(
            f"tensor {name}: payload has {arr.size} elements, dims {dims}")
    return name, arr.reshape(dims)


def _parse_attr(buf: memoryview) -> Tuple[str, Any]:
    name, value = "", None
    floats: List[float] = []
    ints: List[int] = []
    for fnum, wire, val in _fields(buf):
        if fnum == 1:
            name = bytes(val).decode("utf-8")
        elif fnum == 2:
            value = struct.unpack("<f", val)[0]
        elif fnum == 3:
            value = _zz(val)
        elif fnum == 4:
            value = bytes(val)
        elif fnum == 5:
            value = _parse_tensor(val)[1]
        elif fnum == 7:
            floats.extend(struct.unpack(f"<{len(val)//4}f", bytes(val))
                          if wire == 2 else struct.unpack("<f", val))
        elif fnum == 8:
            ints.extend(_zz(v) for v in _packed_varints(val)) \
                if wire == 2 else ints.append(_zz(val))
    if floats:
        value = floats
    if ints:
        value = ints
    return name, value


def _parse_node(buf: memoryview) -> OnnxNode:
    node = OnnxNode(op_type="")
    for fnum, wire, val in _fields(buf):
        if fnum == 1:
            node.inputs.append(bytes(val).decode("utf-8"))
        elif fnum == 2:
            node.outputs.append(bytes(val).decode("utf-8"))
        elif fnum == 3:
            node.name = bytes(val).decode("utf-8")
        elif fnum == 4:
            node.op_type = bytes(val).decode("utf-8")
        elif fnum == 5:
            k, v = _parse_attr(val)
            node.attrs[k] = v
    return node


def _parse_value_info(buf: memoryview):
    name, elem, dims = "", 0, []
    for fnum, _, val in _fields(buf):
        if fnum == 1:
            name = bytes(val).decode("utf-8")
        elif fnum == 2:                            # TypeProto
            for f2, _, v2 in _fields(val):
                if f2 != 1:                        # tensor_type
                    continue
                for f3, w3, v3 in _fields(v2):
                    if f3 == 1:
                        elem = v3
                    elif f3 == 2:                  # TensorShapeProto
                        for f4, _, v4 in _fields(v3):
                            if f4 != 1:            # Dimension
                                continue
                            dim_val = None
                            for f5, _, v5 in _fields(v4):
                                if f5 == 1:
                                    dim_val = _zz(v5)
                            dims.append(dim_val)
    return name, elem, tuple(dims)


def _parse_model(data, path: str) -> OnnxModel:
    graph = None
    for fnum, _, val in _fields(memoryview(data)):
        if fnum == 7:
            graph = val
    if graph is None:
        raise ValueError(f"{path}: no GraphProto (not an ONNX model?)")
    model = OnnxModel({}, [], [], [])
    for fnum, _, val in _fields(graph):
        if fnum == 1:
            model.nodes.append(_parse_node(val))
        elif fnum == 2:
            model.graph_name = bytes(val).decode("utf-8")
        elif fnum == 5:
            name, arr = _parse_tensor(val)
            model.initializers[name] = arr
        elif fnum == 11:
            model.inputs.append(_parse_value_info(val))
        elif fnum == 12:
            model.outputs.append(_parse_value_info(val))
    return model


def read_model(path: str) -> OnnxModel:
    with open(path, "rb") as f:
        if os.fstat(f.fileno()).st_size == 0:
            return _parse_model(b"", path)
        data = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
    try:
        # the parse copies every payload out (`bytes(val)`): no view of
        # the mapping outlives a parse that returns
        return _parse_model(data, path)
    finally:
        try:
            data.close()
        except BufferError:
            pass    # a failed parse's traceback still holds views; the
            # mapping closes when they go


# ------------------------------------------------------------------- writing
def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(fnum: int, wire: int) -> bytes:
    return _varint((fnum << 3) | wire)


def _ld(fnum: int, payload: bytes) -> bytes:
    return _tag(fnum, 2) + _varint(len(payload)) + payload


def _vi(fnum: int, v: int) -> bytes:
    return _tag(fnum, 0) + _varint(v & ((1 << 64) - 1))


def _tensor_bytes(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    if arr.dtype not in _DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {arr.dtype}")
    out = b""
    for d in arr.shape:
        out += _vi(1, d)
    out += _vi(2, _DTYPE_CODES[arr.dtype])
    out += _ld(8, name.encode("utf-8"))
    out += _ld(9, np.ascontiguousarray(arr).tobytes())
    return out


def _attr_bytes(name: str, val: Any) -> bytes:
    out = _ld(1, name.encode("utf-8"))
    if isinstance(val, bool):
        out += _vi(3, int(val)) + _vi(20, 2)                 # INT
    elif isinstance(val, int):
        out += _vi(3, val & ((1 << 64) - 1)) + _vi(20, 2)    # INT
    elif isinstance(val, float):
        out += _tag(2, 5) + struct.pack("<f", val) + _vi(20, 1)
    elif isinstance(val, bytes):
        out += _ld(4, val) + _vi(20, 3)                      # STRING
    elif isinstance(val, str):
        out += _ld(4, val.encode("utf-8")) + _vi(20, 3)
    elif isinstance(val, (list, tuple)) and all(
            isinstance(x, int) for x in val):
        payload = b"".join(_varint(x & ((1 << 64) - 1)) for x in val)
        out += _ld(8, payload) + _vi(20, 7)                  # INTS (packed)
    elif isinstance(val, (list, tuple)):
        payload = b"".join(struct.pack("<f", float(x)) for x in val)
        out += _ld(7, payload) + _vi(20, 6)                  # FLOATS
    else:
        raise ValueError(f"attr {name}: unsupported value {val!r}")
    return out


def _node_bytes(node: OnnxNode) -> bytes:
    out = b""
    for i in node.inputs:
        out += _ld(1, i.encode("utf-8"))
    for o in node.outputs:
        out += _ld(2, o.encode("utf-8"))
    if node.name:
        out += _ld(3, node.name.encode("utf-8"))
    out += _ld(4, node.op_type.encode("utf-8"))
    for k, v in node.attrs.items():
        out += _ld(5, _attr_bytes(k, v))
    return out


def _value_info_bytes(name: str, elem: int,
                      dims: Sequence[Optional[int]]) -> bytes:
    shape = b""
    for d in dims:
        dim = b"" if d is None else _vi(1, d)
        shape += _ld(1, dim)
    tensor_type = _vi(1, elem) + _ld(2, shape)
    return _ld(1, name.encode("utf-8")) + _ld(2, _ld(1, tensor_type))


def write_model(
    path: str,
    initializers: Dict[str, np.ndarray],
    nodes: Sequence[OnnxNode] = (),
    inputs: Sequence[Tuple[str, int, Sequence[Optional[int]]]] = (),
    outputs: Sequence[Tuple[str, int, Sequence[Optional[int]]]] = (),
    graph_name: str = "qwen3_tts",
) -> None:
    # the GraphProto as a list of its fields' bytes, in the JAX package's
    # order; its length prefix is their sum
    graph: List[bytes] = [_ld(1, _node_bytes(n)) for n in nodes]
    graph.append(_ld(2, graph_name.encode("utf-8")))
    for name, arr in initializers.items():
        graph.append(_ld(5, _tensor_bytes(name, arr)))
    for name, elem, dims in inputs:
        graph.append(_ld(11, _value_info_bytes(name, elem, dims)))
    for name, elem, dims in outputs:
        graph.append(_ld(12, _value_info_bytes(name, elem, dims)))
    with open(path, "wb") as f:
        f.write(_vi(1, 8))                              # ir_version
        f.write(_ld(2, b"qwen3_tts_tpu"))               # producer_name
        f.write(_tag(7, 2) + _varint(sum(len(p) for p in graph)))
        for piece in graph:
            f.write(piece)
        f.write(_ld(8, _ld(1, b"") + _vi(2, 17)))       # opset_import v17
