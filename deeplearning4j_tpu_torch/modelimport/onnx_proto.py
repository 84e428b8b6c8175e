"""A minimal ONNX protobuf wire-format codec (decode + encode) — the port's
copy of ``deeplearning4j_tpu/modelimport/onnx_proto.py``.

Reference parity: ``nd4j/samediff-import/samediff-import-onnx`` parses
ONNX ModelProtos through the generated protobuf classes. Neither package
imports ``onnx`` or ``google.protobuf``, so the subset of the (public,
stable) ``onnx.proto3`` schema an inference graph uses is decoded straight
from the protobuf wire format: ModelProto, GraphProto, NodeProto,
AttributeProto, TensorProto, ValueInfoProto.

As in the JAX module, fp16/bf16 tensors stored in ``int32_data`` hold raw
bit patterns and are reinterpreted, never value-cast. One difference:
numpy has no bfloat16 without ``ml_dtypes`` (which the card's machine
lacks), so a ``DT_BFLOAT16`` tensor decodes to a ``torch.bfloat16`` CPU
tensor and :func:`encode_tensor` takes one, as :mod:`.tf_proto` does.
Length-delimited fields are ``memoryview`` slices of the file's bytes, so
``raw_data`` becomes an ``np.frombuffer`` view without a copy.

The encoder builds well-formed ``.onnx`` files without the onnx package,
for the tests, :mod:`.onnx_fixtures` and ``chip_smoke.py``; the wire
format is standard protobuf, so files from real exporters decode the same
way.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.modelimport._wire import (fields, fixed, s64,
                                                     tag, utf8, varint,
                                                     varints)

# ONNX TensorProto.DataType values (public enum)
DT_FLOAT, DT_UINT8, DT_INT8, DT_UINT16, DT_INT16 = 1, 2, 3, 4, 5
DT_INT32, DT_INT64, DT_STRING, DT_BOOL, DT_FLOAT16 = 6, 7, 8, 9, 10
DT_DOUBLE, DT_UINT32, DT_UINT64 = 11, 12, 13
DT_BFLOAT16 = 16

_NP_OF = {DT_FLOAT: np.float32, DT_UINT8: np.uint8, DT_INT8: np.int8,
          DT_UINT16: np.uint16, DT_INT16: np.int16, DT_INT32: np.int32,
          DT_INT64: np.int64, DT_BOOL: np.bool_, DT_FLOAT16: np.float16,
          DT_DOUBLE: np.float64, DT_UINT32: np.uint32, DT_UINT64: np.uint64}
_DT_OF = {np.dtype(v): k for k, v in _NP_OF.items()}


def np_dtype(data_type: int) -> np.dtype:
    """The numpy dtype of an ONNX enum (``DT_BFLOAT16`` has none: see
    :func:`torch_dtype`)."""
    if data_type == DT_BFLOAT16:
        raise TypeError("numpy has no bfloat16: use onnx_proto.torch_dtype")
    return np.dtype(_NP_OF[data_type])


def torch_dtype(data_type: int) -> torch.dtype:
    """The torch dtype of an ONNX enum (bfloat16 included)."""
    if data_type == DT_BFLOAT16:
        return torch.bfloat16
    return torch.from_numpy(np.zeros(0, _NP_OF[data_type])).dtype


def onnx_dtype(dt) -> int:
    """numpy dtype (or type), or ``torch.bfloat16`` -> ONNX enum."""
    if dt is torch.bfloat16:
        return DT_BFLOAT16
    dt = np.dtype(dt)
    if dt.name == "bfloat16":
        return DT_BFLOAT16
    return _DT_OF[dt]


# ----------------------------------------------------------------- decoding

@dataclass
class TensorProto:
    name: str = ""
    data_type: int = DT_FLOAT
    dims: List[int] = field(default_factory=list)
    #: numpy, or a ``torch.bfloat16`` CPU tensor for ``DT_BFLOAT16``
    array: object = None

    @staticmethod
    def parse(buf) -> "TensorProto":
        t = TensorProto()
        float_data: List[float] = []
        int_data: List[int] = []
        raw = b""
        for fnum, wt, v in fields(buf):
            if fnum == 1:           # dims (int64, may be packed)
                varints(wt, v, t.dims)
            elif fnum == 2 and wt == 0:
                t.data_type = v
            elif fnum == 4:         # float_data (packed floats)
                fixed(wt, v, float_data, "f", 4)
            elif fnum in (5, 7, 11):  # int32/int64/uint64_data
                varints(wt, v, int_data)
            elif fnum == 8 and wt == 2:
                t.name = utf8(v)
            elif fnum == 9 and wt == 2:
                raw = v
            elif fnum == 10:        # double_data
                fixed(wt, v, float_data, "d", 8)
        shape = tuple(t.dims)
        if t.data_type == DT_BFLOAT16:
            if len(raw):
                bits = np.frombuffer(raw, np.uint16)
            elif int_data:
                # raw bit patterns in int32_data: reinterpret, never cast
                bits = np.asarray(int_data, np.int64).astype(np.uint16)
            elif float_data:
                t.array = torch.tensor(float_data, dtype=torch.float32
                                       ).to(torch.bfloat16).reshape(shape)
                return t
            else:
                bits = np.zeros(int(np.prod(shape, dtype=np.int64)),
                                np.uint16)
            t.array = torch.from_numpy(bits.reshape(shape).copy()).view(
                torch.bfloat16)
            return t
        dt = np_dtype(t.data_type)
        if len(raw):
            t.array = np.frombuffer(raw, dtype=dt).reshape(shape)
        elif float_data:
            t.array = np.asarray(float_data, dt).reshape(shape)
        elif int_data:
            if dt.name == "float16":
                # ONNX stores fp16 raw bit patterns in int32_data —
                # reinterpret the bits, never value-cast
                t.array = (np.asarray(int_data, np.uint16)
                           .view(dt).reshape(shape))
            else:
                t.array = np.asarray(int_data, dt).reshape(shape)
        else:
            t.array = np.zeros(shape, dt)
        return t


@dataclass
class AttributeProto:
    name: str = ""
    f: Optional[float] = None
    i: Optional[int] = None
    s: Optional[bytes] = None
    t: Optional[TensorProto] = None
    floats: List[float] = field(default_factory=list)
    ints: List[int] = field(default_factory=list)
    strings: List[bytes] = field(default_factory=list)

    @property
    def value(self):
        for v in (self.i, self.f, self.s, self.t):
            if v is not None:
                return v
        if self.ints:
            return self.ints
        if self.floats:
            return self.floats
        if self.strings:
            return self.strings
        return None

    @staticmethod
    def parse(buf) -> "AttributeProto":
        a = AttributeProto()
        for fnum, wt, v in fields(buf):
            if fnum == 1 and wt == 2:
                a.name = utf8(v)
            elif fnum == 2 and wt == 5:
                a.f = struct.unpack("<f", v)[0]
            elif fnum == 3 and wt == 0:
                a.i = s64(v)
            elif fnum == 4 and wt == 2:
                a.s = bytes(v)
            elif fnum == 5 and wt == 2:
                a.t = TensorProto.parse(v)
            elif fnum == 7:
                fixed(wt, v, a.floats, "f", 4)
            elif fnum == 8:
                varints(wt, v, a.ints)
            elif fnum == 9 and wt == 2:
                a.strings.append(bytes(v))
        return a


@dataclass
class NodeProto:
    op_type: str = ""
    name: str = ""
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    attrs: Dict[str, AttributeProto] = field(default_factory=dict)

    @staticmethod
    def parse(buf) -> "NodeProto":
        n = NodeProto()
        for fnum, wt, v in fields(buf):
            if fnum == 1 and wt == 2:
                n.inputs.append(utf8(v))
            elif fnum == 2 and wt == 2:
                n.outputs.append(utf8(v))
            elif fnum == 3 and wt == 2:
                n.name = utf8(v)
            elif fnum == 4 and wt == 2:
                n.op_type = utf8(v)
            elif fnum == 5 and wt == 2:
                a = AttributeProto.parse(v)
                n.attrs[a.name] = a
        return n

    def attr(self, name, default=None):
        a = self.attrs.get(name)
        return default if a is None else a.value


@dataclass
class ValueInfoProto:
    name: str = ""
    elem_type: int = DT_FLOAT
    shape: List[Optional[int]] = field(default_factory=list)

    @staticmethod
    def parse(buf) -> "ValueInfoProto":
        vi = ValueInfoProto()
        for fnum, wt, v in fields(buf):
            if fnum == 1 and wt == 2:
                vi.name = utf8(v)
            elif fnum == 2 and wt == 2:      # TypeProto
                for f2, w2, v2 in fields(v):
                    if f2 == 1 and w2 == 2:  # tensor_type
                        for f3, w3, v3 in fields(v2):
                            if f3 == 1 and w3 == 0:
                                vi.elem_type = v3
                            elif f3 == 2 and w3 == 2:  # shape
                                for f4, w4, v4 in fields(v3):
                                    if f4 == 1 and w4 == 2:  # dim
                                        dim = None
                                        for f5, w5, v5 in fields(v4):
                                            if f5 == 1 and w5 == 0:
                                                dim = s64(v5)
                                        vi.shape.append(dim)
        return vi


@dataclass
class GraphProto:
    name: str = ""
    nodes: List[NodeProto] = field(default_factory=list)
    initializers: List[TensorProto] = field(default_factory=list)
    inputs: List[ValueInfoProto] = field(default_factory=list)
    outputs: List[ValueInfoProto] = field(default_factory=list)

    @staticmethod
    def parse(buf) -> "GraphProto":
        g = GraphProto()
        for fnum, wt, v in fields(buf):
            if fnum == 1 and wt == 2:
                g.nodes.append(NodeProto.parse(v))
            elif fnum == 2 and wt == 2:
                g.name = utf8(v)
            elif fnum == 5 and wt == 2:
                g.initializers.append(TensorProto.parse(v))
            elif fnum == 11 and wt == 2:
                g.inputs.append(ValueInfoProto.parse(v))
            elif fnum == 12 and wt == 2:
                g.outputs.append(ValueInfoProto.parse(v))
        return g


@dataclass
class ModelProto:
    ir_version: int = 8
    opset_version: int = 17
    graph: Optional[GraphProto] = None

    @staticmethod
    def parse(buf) -> "ModelProto":
        m = ModelProto()
        for fnum, wt, v in fields(buf):
            if fnum == 1 and wt == 0:
                m.ir_version = v
            elif fnum == 7 and wt == 2:
                m.graph = GraphProto.parse(v)
            elif fnum == 8 and wt == 2:      # opset_import
                for f2, w2, v2 in fields(v):
                    if f2 == 2 and w2 == 0:
                        m.opset_version = v2
        return m


def load_model(path_or_bytes) -> ModelProto:
    """A ModelProto from a file's bytes or its path."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        return ModelProto.parse(path_or_bytes)
    with open(path_or_bytes, "rb") as f:
        return ModelProto.parse(f.read())


# ----------------------------------------------------------------- encoding
# (for tests/tools: build .onnx files without the onnx package)

def _w_bytes(out: bytearray, fnum: int, data: bytes):
    out += tag(fnum, 2) + varint(len(data))
    out.extend(data)


def _w_str(out, fnum, s: str):
    _w_bytes(out, fnum, s.encode("utf-8"))


def _w_int(out, fnum, v: int):
    out += tag(fnum, 0) + varint(v)


def encode_tensor(name: str, arr) -> bytes:
    """TensorProto of ``arr`` (numpy, or a ``torch.bfloat16`` tensor) in
    ``raw_data``."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype != torch.bfloat16:
            raise TypeError("encode_tensor takes numpy arrays or bf16 tensors")
        shape, dt = tuple(arr.shape), DT_BFLOAT16
        data = arr.detach().cpu().contiguous().view(torch.int16).numpy(
            ).tobytes()
    else:
        shape, dt = arr.shape, onnx_dtype(arr.dtype)
        data = np.ascontiguousarray(arr).tobytes()
    out = bytearray()
    for d in shape:
        _w_int(out, 1, d)
    _w_int(out, 2, dt)
    _w_str(out, 8, name)
    _w_bytes(out, 9, data)
    return bytes(out)


def encode_attr(name: str, value) -> bytes:
    out = bytearray()
    _w_str(out, 1, name)
    if isinstance(value, bool) or isinstance(value, (int, np.integer)):
        _w_int(out, 3, int(value))
        _w_int(out, 20, 2)       # type = INT
    elif isinstance(value, float):
        out += tag(2, 5)
        out.extend(struct.pack("<f", value))
        _w_int(out, 20, 1)       # FLOAT
    elif isinstance(value, str):
        _w_bytes(out, 4, value.encode())
        _w_int(out, 20, 3)       # STRING
    elif isinstance(value, (np.ndarray, torch.Tensor)):
        _w_bytes(out, 5, encode_tensor("", value))
        _w_int(out, 20, 4)       # TENSOR
    elif isinstance(value, (list, tuple)) and value and \
            isinstance(value[0], float):
        for f in value:
            out += tag(7, 5)
            out.extend(struct.pack("<f", f))
        _w_int(out, 20, 6)       # FLOATS
    elif isinstance(value, (list, tuple)):
        for i in value:
            _w_int(out, 8, int(i))
        _w_int(out, 20, 7)       # INTS
    else:
        raise TypeError(f"attr {name}: {type(value)}")
    return bytes(out)


def encode_node(op_type: str, inputs, outputs, name: str = "",
                **attrs) -> bytes:
    out = bytearray()
    for i in inputs:
        _w_str(out, 1, i)
    for o in outputs:
        _w_str(out, 2, o)
    _w_str(out, 3, name or f"{op_type}_{outputs[0]}")
    _w_str(out, 4, op_type)
    for k, v in attrs.items():
        _w_bytes(out, 5, encode_attr(k, v))
    return bytes(out)


def encode_value_info(name: str, dtype, shape) -> bytes:
    shp = bytearray()
    for d in (shape or ()):
        dim = bytearray()
        if d is not None:
            _w_int(dim, 1, d)
        _w_bytes(shp, 1, bytes(dim))
    tt = bytearray()
    _w_int(tt, 1, onnx_dtype(dtype))
    _w_bytes(tt, 2, bytes(shp))
    tp = bytearray()
    _w_bytes(tp, 1, bytes(tt))
    out = bytearray()
    _w_str(out, 1, name)
    _w_bytes(out, 2, bytes(tp))
    return bytes(out)


def encode_model(nodes: List[bytes], inputs: List[bytes],
                 outputs: List[bytes], initializers: List[bytes],
                 opset: int = 17, graph_name: str = "g") -> bytes:
    g = bytearray()
    for n in nodes:
        _w_bytes(g, 1, n)
    _w_str(g, 2, graph_name)
    for t in initializers:
        _w_bytes(g, 5, t)
    for i in inputs:
        _w_bytes(g, 11, i)
    for o in outputs:
        _w_bytes(g, 12, o)
    m = bytearray()
    _w_int(m, 1, 8)               # ir_version
    _w_bytes(m, 7, bytes(g))
    ops = bytearray()
    _w_str(ops, 1, "")            # default domain
    _w_int(ops, 2, opset)
    _w_bytes(m, 8, bytes(ops))
    return bytes(m)
