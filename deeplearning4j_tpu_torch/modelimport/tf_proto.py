"""A TensorFlow ``GraphDef`` wire-format codec (decode + encode) from the
stdlib and numpy.

The JAX package parses frozen graphs with TensorFlow's own classes
(``graph_pb2.GraphDef`` and ``tensor_util.MakeNdarray``). The port may not
import TensorFlow or ``google.protobuf``, so the subset of TF's (public,
stable) ``graph.proto``, ``node_def.proto``, ``attr_value.proto``,
``tensor.proto``, ``tensor_shape.proto`` and ``function.proto`` that a
frozen inference graph uses is decoded here straight from the protobuf
wire format, as ``modelimport/onnx_proto.py`` does for ONNX.

The decoded objects keep the surface the importer reads on TF's classes:
``graph_def.node``, ``graph_def.library.function``,
``graph_def.HasField("library")``, ``node.attr[name].WhichOneof("value")``,
``attr.list.i``, ``attr.func.name``, ``fdef.signature.input_arg``,
``fdef.ret`` and so on. :func:`make_ndarray` stands in for
``tensor_util.MakeNdarray``: ``tensor_content`` becomes an
``np.frombuffer`` view of the file's bytes (no per-element loop, no second
copy), a tensor holding fewer values than its shape has elements repeats
its last value (TF's rule for splat constants), strings stay numpy object
arrays, and ``DT_BFLOAT16`` decodes to a ``torch.bfloat16`` tensor (numpy
has no bfloat16).

The encoder (:func:`encode_node`, :func:`encode_const`,
:func:`encode_graph_def`, :func:`encode_function`) builds GraphDefs
without TensorFlow, for the tests and ``chip_smoke.py``; the wire format is
standard protobuf, so TensorFlow parses what it writes.
"""

from __future__ import annotations

import struct
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.modelimport._wire import (fields, fixed, s64,
                                                     tag, utf8, varint,
                                                     varints)

# TF DataType enum values (types.proto)
DT_FLOAT, DT_DOUBLE, DT_INT32, DT_UINT8, DT_INT16, DT_INT8 = 1, 2, 3, 4, 5, 6
DT_STRING, DT_INT64, DT_BOOL = 7, 9, 10
DT_BFLOAT16, DT_UINT16, DT_HALF, DT_UINT32, DT_UINT64 = 14, 17, 19, 22, 23

_NP_OF = {DT_FLOAT: np.float32, DT_DOUBLE: np.float64, DT_INT32: np.int32,
          DT_UINT8: np.uint8, DT_INT16: np.int16, DT_INT8: np.int8,
          DT_INT64: np.int64, DT_BOOL: np.bool_, DT_UINT16: np.uint16,
          DT_HALF: np.float16, DT_UINT32: np.uint32, DT_UINT64: np.uint64}
_DT_OF = {np.dtype(v): k for k, v in _NP_OF.items()}


def tf_dtype(dt) -> int:
    """numpy dtype (or type), ``torch.bfloat16`` or a TF enum -> TF enum."""
    if isinstance(dt, int):
        return dt
    if dt is torch.bfloat16:
        return DT_BFLOAT16
    if dt is str or dt is bytes or dt is object:
        return DT_STRING
    return _DT_OF[np.dtype(dt)]


# ----------------------------------------------------------------- decoding

class Dim:
    __slots__ = ("size", "name")

    def __init__(self, size: int = 0, name: str = ""):
        self.size = size
        self.name = name


class TensorShapeProto:
    __slots__ = ("dim", "unknown_rank")

    def __init__(self):
        self.dim: List[Dim] = []
        self.unknown_rank = False

    @staticmethod
    def parse(buf) -> "TensorShapeProto":
        s = TensorShapeProto()
        for fnum, wt, v in fields(buf):
            if fnum == 2 and wt == 2:
                d = Dim()
                for f2, w2, v2 in fields(v):
                    if f2 == 1 and w2 == 0:
                        d.size = s64(v2)
                    elif f2 == 2 and w2 == 2:
                        d.name = utf8(v2)
                s.dim.append(d)
            elif fnum == 3 and wt == 0:
                s.unknown_rank = bool(v)
        return s


class TensorProto:
    """TF ``TensorProto``: the dtype, the shape and one of its value
    fields (``tensor_content`` raw bytes, or a typed repeated field)."""

    __slots__ = ("dtype", "tensor_shape", "tensor_content", "float_val",
                 "double_val", "int_val", "string_val", "int64_val",
                 "bool_val", "half_val", "uint32_val", "uint64_val")

    def __init__(self):
        self.dtype = 0
        self.tensor_shape = TensorShapeProto()
        self.tensor_content = memoryview(b"")
        self.float_val: List[float] = []
        self.double_val: List[float] = []
        self.int_val: List[int] = []
        self.string_val: List[bytes] = []
        self.int64_val: List[int] = []
        self.bool_val: List[int] = []
        self.half_val: List[int] = []
        self.uint32_val: List[int] = []
        self.uint64_val: List[int] = []

    @staticmethod
    def parse(buf) -> "TensorProto":
        t = TensorProto()
        for fnum, wt, v in fields(buf):
            if fnum == 1 and wt == 0:
                t.dtype = v
            elif fnum == 2 and wt == 2:
                t.tensor_shape = TensorShapeProto.parse(v)
            elif fnum == 4 and wt == 2:
                t.tensor_content = v
            elif fnum == 5:
                fixed(wt, v, t.float_val, "f", 4)
            elif fnum == 6:
                fixed(wt, v, t.double_val, "d", 8)
            elif fnum == 7:
                varints(wt, v, t.int_val)
            elif fnum == 8 and wt == 2:
                t.string_val.append(bytes(v))
            elif fnum == 10:
                varints(wt, v, t.int64_val)
            elif fnum == 11:
                varints(wt, v, t.bool_val)
            elif fnum == 13:
                varints(wt, v, t.half_val)
            elif fnum == 16:
                varints(wt, v, t.uint32_val, signed=False)
            elif fnum == 17:
                varints(wt, v, t.uint64_val, signed=False)
        return t


def make_ndarray(t: TensorProto):
    """``tensor_util.MakeNdarray``: a numpy array (a read-only view of the
    file's bytes when the tensor holds ``tensor_content``), or a
    ``torch.bfloat16`` CPU tensor for ``DT_BFLOAT16``."""
    shape = tuple(d.size for d in t.tensor_shape.dim)
    n = int(np.prod(shape, dtype=np.int64))
    if t.dtype == DT_BFLOAT16:
        if len(t.tensor_content):
            bits = np.frombuffer(t.tensor_content, np.uint16)
        else:
            bits = _splat(np.asarray(t.half_val, np.int64).astype(np.uint16),
                          n, np.uint16)
        return torch.from_numpy(bits.reshape(shape).copy()).view(
            torch.bfloat16)
    if t.dtype == DT_STRING:
        vals = np.empty(len(t.string_val), object)
        vals[:] = t.string_val
        return _splat(vals, n, object).reshape(shape)
    if t.dtype not in _NP_OF:
        raise ValueError(f"TensorProto dtype {t.dtype} does not decode")
    dt = np.dtype(_NP_OF[t.dtype])
    if len(t.tensor_content):
        return np.frombuffer(t.tensor_content, dt).reshape(shape)
    if t.dtype == DT_HALF:
        # 16-bit patterns in half_val: reinterpret, never value-cast
        vals = np.asarray(t.half_val, np.int64).astype(np.uint16).view(dt)
    else:
        src = {DT_FLOAT: t.float_val, DT_DOUBLE: t.double_val,
               DT_INT64: t.int64_val, DT_BOOL: t.bool_val,
               DT_UINT32: t.uint32_val, DT_UINT64: t.uint64_val,
               }.get(t.dtype, t.int_val)
        vals = np.asarray(src).astype(dt) if src else np.zeros(0, dt)
    return _splat(vals, n, dt).reshape(shape)


def _splat(vals: np.ndarray, n: int, dt) -> np.ndarray:
    """TF's rule: fewer values than elements repeat the last one (none at
    all give zeros)."""
    if vals.size == n:
        return vals
    if vals.size == 0:
        return np.zeros(n, dt)
    if vals.size > n:
        raise ValueError(f"tensor holds {vals.size} values for {n} elements")
    return np.concatenate([vals, np.full(n - vals.size, vals[-1], dt)])


class NameAttrList:
    __slots__ = ("name", "attr")

    def __init__(self):
        self.name = ""
        self.attr: Dict[str, "AttrValue"] = {}

    @staticmethod
    def parse(buf) -> "NameAttrList":
        f = NameAttrList()
        for fnum, wt, v in fields(buf):
            if fnum == 1 and wt == 2:
                f.name = utf8(v)
            elif fnum == 2 and wt == 2:
                k, a = _parse_attr_entry(v)
                f.attr[k] = a
        return f


class ListValue:
    __slots__ = ("s", "i", "f", "b", "type", "shape", "tensor", "func")

    def __init__(self):
        self.s: List[bytes] = []
        self.i: List[int] = []
        self.f: List[float] = []
        self.b: List[bool] = []
        self.type: List[int] = []
        self.shape: List[TensorShapeProto] = []
        self.tensor: List[TensorProto] = []
        self.func: List[NameAttrList] = []

    @staticmethod
    def parse(buf) -> "ListValue":
        lv = ListValue()
        for fnum, wt, v in fields(buf):
            if fnum == 2 and wt == 2:
                lv.s.append(bytes(v))
            elif fnum == 3:
                varints(wt, v, lv.i)
            elif fnum == 4:
                fixed(wt, v, lv.f, "f", 4)
            elif fnum == 5:
                bs: list = []
                varints(wt, v, bs)
                lv.b.extend(bool(x) for x in bs)
            elif fnum == 6:
                varints(wt, v, lv.type)
            elif fnum == 7 and wt == 2:
                lv.shape.append(TensorShapeProto.parse(v))
            elif fnum == 8 and wt == 2:
                lv.tensor.append(TensorProto.parse(v))
            elif fnum == 9 and wt == 2:
                lv.func.append(NameAttrList.parse(v))
        return lv


class AttrValue:
    """TF ``AttrValue``: one field of the ``value`` oneof is set."""

    __slots__ = ("_which", "list", "s", "i", "f", "b", "type", "shape",
                 "tensor", "placeholder", "func")

    def __init__(self):
        self._which: Optional[str] = None
        self.list = ListValue()
        self.s = b""
        self.i = 0
        self.f = 0.0
        self.b = False
        self.type = 0
        self.shape = TensorShapeProto()
        self.tensor = TensorProto()
        self.placeholder = ""
        self.func = NameAttrList()

    def WhichOneof(self, group: str) -> Optional[str]:
        if group != "value":
            raise ValueError(f"AttrValue has no oneof '{group}'")
        return self._which

    @staticmethod
    def parse(buf) -> "AttrValue":
        a = AttrValue()
        for fnum, wt, v in fields(buf):
            if fnum == 1 and wt == 2:
                a.list, a._which = ListValue.parse(v), "list"
            elif fnum == 2 and wt == 2:
                a.s, a._which = bytes(v), "s"
            elif fnum == 3 and wt == 0:
                a.i, a._which = s64(v), "i"
            elif fnum == 4 and wt == 5:
                a.f, a._which = struct.unpack("<f", v)[0], "f"
            elif fnum == 5 and wt == 0:
                a.b, a._which = bool(v), "b"
            elif fnum == 6 and wt == 0:
                a.type, a._which = v, "type"
            elif fnum == 7 and wt == 2:
                a.shape, a._which = TensorShapeProto.parse(v), "shape"
            elif fnum == 8 and wt == 2:
                a.tensor, a._which = TensorProto.parse(v), "tensor"
            elif fnum == 9 and wt == 2:
                a.placeholder, a._which = utf8(v), "placeholder"
            elif fnum == 10 and wt == 2:
                a.func, a._which = NameAttrList.parse(v), "func"
        return a


def _parse_attr_entry(buf) -> Tuple[str, AttrValue]:
    """One ``map<string, AttrValue>`` entry (key 1, value 2)."""
    key, val = "", AttrValue()
    for fnum, wt, v in fields(buf):
        if fnum == 1 and wt == 2:
            key = utf8(v)
        elif fnum == 2 and wt == 2:
            val = AttrValue.parse(v)
    return key, val


class NodeDef:
    __slots__ = ("name", "op", "input", "device", "attr")

    def __init__(self):
        self.name = ""
        self.op = ""
        self.input: List[str] = []
        self.device = ""
        self.attr: Dict[str, AttrValue] = {}

    @staticmethod
    def parse(buf) -> "NodeDef":
        n = NodeDef()
        for fnum, wt, v in fields(buf):
            if fnum == 1 and wt == 2:
                n.name = utf8(v)
            elif fnum == 2 and wt == 2:
                n.op = utf8(v)
            elif fnum == 3 and wt == 2:
                n.input.append(utf8(v))
            elif fnum == 4 and wt == 2:
                n.device = utf8(v)
            elif fnum == 5 and wt == 2:
                k, a = _parse_attr_entry(v)
                n.attr[k] = a
        return n


class ArgDef:
    __slots__ = ("name", "type")

    def __init__(self):
        self.name = ""
        self.type = 0

    @staticmethod
    def parse(buf) -> "ArgDef":
        a = ArgDef()
        for fnum, wt, v in fields(buf):
            if fnum == 1 and wt == 2:
                a.name = utf8(v)
            elif fnum == 3 and wt == 0:
                a.type = v
        return a


class OpDef:
    __slots__ = ("name", "input_arg", "output_arg")

    def __init__(self):
        self.name = ""
        self.input_arg: List[ArgDef] = []
        self.output_arg: List[ArgDef] = []

    @staticmethod
    def parse(buf) -> "OpDef":
        o = OpDef()
        for fnum, wt, v in fields(buf):
            if fnum == 1 and wt == 2:
                o.name = utf8(v)
            elif fnum == 2 and wt == 2:
                o.input_arg.append(ArgDef.parse(v))
            elif fnum == 3 and wt == 2:
                o.output_arg.append(ArgDef.parse(v))
        return o


class FunctionDef:
    __slots__ = ("signature", "node_def", "ret")

    def __init__(self):
        self.signature = OpDef()
        self.node_def: List[NodeDef] = []
        self.ret: Dict[str, str] = {}

    @staticmethod
    def parse(buf) -> "FunctionDef":
        f = FunctionDef()
        for fnum, wt, v in fields(buf):
            if fnum == 1 and wt == 2:
                f.signature = OpDef.parse(v)
            elif fnum == 3 and wt == 2:
                f.node_def.append(NodeDef.parse(v))
            elif fnum == 4 and wt == 2:
                key = val = ""
                for f2, w2, v2 in fields(v):
                    if f2 == 1 and w2 == 2:
                        key = utf8(v2)
                    elif f2 == 2 and w2 == 2:
                        val = utf8(v2)
                f.ret[key] = val
        return f


class FunctionDefLibrary:
    __slots__ = ("function",)

    def __init__(self):
        self.function: List[FunctionDef] = []

    @staticmethod
    def parse(buf) -> "FunctionDefLibrary":
        lib = FunctionDefLibrary()
        for fnum, wt, v in fields(buf):
            if fnum == 1 and wt == 2:
                lib.function.append(FunctionDef.parse(v))
        return lib


class GraphDef:
    """TF ``GraphDef``: nodes, the function library, the versions."""

    __slots__ = ("node", "library", "versions", "_has_library")

    def __init__(self):
        self.node: List[NodeDef] = []
        self.library = FunctionDefLibrary()
        self.versions = memoryview(b"")
        self._has_library = False

    def HasField(self, name: str) -> bool:
        if name == "library":
            return self._has_library
        if name == "versions":
            return len(self.versions) > 0
        raise ValueError(f"GraphDef has no singular field '{name}'")

    @staticmethod
    def parse(buf) -> "GraphDef":
        g = GraphDef()
        for fnum, wt, v in fields(buf):
            if fnum == 1 and wt == 2:
                g.node.append(NodeDef.parse(v))
            elif fnum == 2 and wt == 2:
                g.library = FunctionDefLibrary.parse(v)
                g._has_library = True
            elif fnum == 4 and wt == 2:
                g.versions = v
        return g


def load_graph_def(src) -> GraphDef:
    """Bytes (or any buffer) or a path to a binary ``.pb`` -> GraphDef."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        return GraphDef.parse(src)
    with open(src, "rb") as f:
        return GraphDef.parse(f.read())


# ----------------------------------------------------------------- encoding
# (for tests and chip_smoke.py: build GraphDefs without TensorFlow)

def _len_field(fnum: int, data) -> List:
    """The pieces of one length-delimited field (joined once, later)."""
    return [tag(fnum, 2), varint(len(data)), data]


def _int_field(fnum: int, v: int) -> bytes:
    return tag(fnum, 0) + varint(int(v))


def _packed_varints(fnum: int, vals: Iterable[int], packed: bool) -> bytes:
    vals = list(vals)
    if packed:
        return b"".join(_len_field(fnum, b"".join(varint(int(x))
                                                  for x in vals)))
    return b"".join(_int_field(fnum, x) for x in vals)


def _packed_fixed(fnum: int, vals: Sequence[float], fmt: str,
                  packed: bool) -> bytes:
    wt = 5 if fmt == "f" else 1
    if packed:
        return b"".join(_len_field(
            fnum, struct.pack(f"<{len(vals)}{fmt}", *vals)))
    return b"".join(tag(fnum, wt) + struct.pack(f"<{fmt}", x) for x in vals)


def encode_shape(dims: Optional[Sequence[int]]) -> bytes:
    """TensorShapeProto; ``None`` is an unknown rank."""
    if dims is None:
        return _int_field(3, 1)
    return b"".join(b"".join(_len_field(2, _int_field(1, d) if d else b""))
                    for d in dims)


def encode_tensor(arr, *, as_values: bool = False, packed: bool = True,
                  splat: bool = False) -> bytes:
    """TensorProto of ``arr`` (numpy, or a ``torch.bfloat16`` tensor).
    Default: ``tensor_content``. ``as_values`` writes the typed repeated
    field instead (``packed`` or one tag a value); ``splat`` writes only
    the first value, which TF repeats over the shape."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype != torch.bfloat16:
            raise TypeError("encode_tensor takes numpy arrays or bf16 tensors")
        dt, shape = DT_BFLOAT16, tuple(arr.shape)
        bits = arr.detach().cpu().contiguous().view(torch.int16).numpy()
        flat = bits.astype(np.uint16).reshape(-1)
        content = flat.tobytes()
    else:
        arr = np.asarray(arr)
        dt, shape = tf_dtype(arr.dtype if arr.dtype != object else str), \
            arr.shape
        flat = arr.reshape(-1)
        content = None if dt == DT_STRING else \
            np.ascontiguousarray(flat).tobytes()
    parts = [_int_field(1, dt), *_len_field(2, encode_shape(shape))]
    if splat:
        flat = flat[:1]
    if dt == DT_STRING:
        for s in flat:
            parts += _len_field(8, s.encode() if isinstance(s, str) else s)
    elif not (as_values or splat):
        parts += _len_field(4, content)
    elif dt in (DT_BFLOAT16, DT_HALF):
        parts.append(_packed_varints(13, np.asarray(flat).view(np.uint16)
                                     if dt == DT_HALF else flat, packed))
    elif dt == DT_FLOAT:
        parts.append(_packed_fixed(5, flat.tolist(), "f", packed))
    elif dt == DT_DOUBLE:
        parts.append(_packed_fixed(6, flat.tolist(), "d", packed))
    elif dt == DT_INT64:
        parts.append(_packed_varints(10, flat.tolist(), packed))
    elif dt == DT_BOOL:
        parts.append(_packed_varints(11, flat.astype(int).tolist(), packed))
    elif dt == DT_UINT32:
        parts.append(_packed_varints(16, flat.tolist(), packed))
    elif dt == DT_UINT64:
        parts.append(_packed_varints(17, flat.tolist(), packed))
    else:
        parts.append(_packed_varints(7, flat.tolist(), packed))
    return b"".join(parts)


class Attr:
    """An attribute value the encoder cannot tell from a Python value:
    ``Attr.shape(dims)``, ``Attr.dtype(dt)``, ``Attr.func(name)``,
    ``Attr.types(dts)``, ``Attr.tensor(arr)``."""

    def __init__(self, kind: str, value):
        self.kind = kind
        self.value = value

    @staticmethod
    def shape(dims):
        return Attr("shape", dims)

    @staticmethod
    def dtype(dt):
        return Attr("type", dt)

    @staticmethod
    def func(name: str):
        return Attr("func", name)

    @staticmethod
    def types(dts):
        return Attr("types", list(dts))

    @staticmethod
    def tensor(arr, **kw):
        return Attr("tensor", (arr, kw))


def encode_attr_value(v) -> bytes:
    """AttrValue bytes from a Python value: bool -> b, int -> i, float ->
    f, str/bytes -> s, a numpy dtype (or ``torch.bfloat16``) -> type, a
    numpy array -> tensor, a list of ints/floats -> list.i/list.f, or an
    :class:`Attr`."""
    if isinstance(v, Attr):
        if v.kind == "shape":
            return b"".join(_len_field(7, encode_shape(v.value)))
        if v.kind == "type":
            return _int_field(6, tf_dtype(v.value))
        if v.kind == "func":
            return b"".join(_len_field(10, b"".join(_len_field(
                1, v.value.encode()))))
        if v.kind == "types":
            return b"".join(_len_field(1, _packed_varints(
                6, [tf_dtype(t) for t in v.value], True)))
        if v.kind == "tensor":
            arr, kw = v.value
            return b"".join(_len_field(8, encode_tensor(arr, **kw)))
        raise TypeError(f"unknown Attr kind {v.kind}")
    if isinstance(v, (bool, np.bool_)):
        return _int_field(5, int(v))
    if isinstance(v, (int, np.integer)):
        return _int_field(3, int(v))
    if isinstance(v, (float, np.floating)):
        return tag(4, 5) + struct.pack("<f", float(v))
    if isinstance(v, str):
        return b"".join(_len_field(2, v.encode()))
    if isinstance(v, bytes):
        return b"".join(_len_field(2, v))
    if isinstance(v, (np.ndarray, torch.Tensor)):
        return b"".join(_len_field(8, encode_tensor(v)))
    if isinstance(v, np.dtype) or v is torch.bfloat16 or (
            isinstance(v, type) and issubclass(v, np.generic)):
        return _int_field(6, tf_dtype(v))
    if isinstance(v, (list, tuple)):
        if any(isinstance(x, float) for x in v):
            lv = _packed_fixed(4, [float(x) for x in v], "f", True)
        else:
            lv = _packed_varints(3, [int(x) for x in v], True) if v else b""
        return b"".join(_len_field(1, lv))
    raise TypeError(f"cannot encode attribute value {v!r}")


def _attr_entries(fnum: int, attrs: Dict) -> List:
    parts: List = []
    for k in sorted(attrs):
        entry = b"".join(_len_field(1, k.encode())
                         + _len_field(2, encode_attr_value(attrs[k])))
        parts += _len_field(fnum, entry)
    return parts


def encode_node(name: str, op: str, inputs: Sequence[str] = (),
                device: str = "", **attrs) -> bytes:
    """NodeDef bytes. ``attrs`` go through :func:`encode_attr_value`."""
    parts = _len_field(1, name.encode()) + _len_field(2, op.encode())
    for i in inputs:
        parts += _len_field(3, i.encode())
    if device:
        parts += _len_field(4, device.encode())
    parts += _attr_entries(5, attrs)
    return b"".join(parts)


def encode_const(name: str, arr, **tensor_kw) -> bytes:
    """A ``Const`` NodeDef holding ``arr`` (``dtype`` and ``value``
    attrs, as TF writes them); ``tensor_kw`` go to :func:`encode_tensor`."""
    dt = torch.bfloat16 if isinstance(arr, torch.Tensor) else \
        (str if np.asarray(arr).dtype == object else np.asarray(arr).dtype)
    return encode_node(name, "Const", dtype=Attr.dtype(dt),
                       value=Attr.tensor(arr, **tensor_kw))


def encode_function(name: str, input_args: Sequence[Tuple[str, object]],
                    output_args: Sequence[Tuple[str, object]],
                    nodes: Sequence[bytes], ret: Dict[str, str]) -> bytes:
    """FunctionDef bytes: a signature of (name, dtype) args, the body's
    NodeDefs and the ``ret`` map from output arg to a body output ref
    (``node:field:k``)."""
    def argdef(n, dt):
        return b"".join(_len_field(1, n.encode())) + _int_field(3,
                                                                tf_dtype(dt))
    sig = _len_field(1, name.encode())
    for n, dt in input_args:
        sig += _len_field(2, argdef(n, dt))
    for n, dt in output_args:
        sig += _len_field(3, argdef(n, dt))
    parts = _len_field(1, b"".join(sig))
    for nd in nodes:
        parts += _len_field(3, nd)
    for k in sorted(ret):
        parts += _len_field(4, b"".join(_len_field(1, k.encode())
                                        + _len_field(2, ret[k].encode())))
    return b"".join(parts)


def encode_graph_def(nodes: Sequence[bytes],
                     functions: Sequence[bytes] = (),
                     producer: int = 1286) -> bytes:
    """GraphDef bytes from NodeDef (and FunctionDef) bytes, joined once."""
    parts: List = []
    for nd in nodes:
        parts += _len_field(1, nd)
    if functions:
        lib: List = []
        for f in functions:
            lib += _len_field(1, f)
        parts += _len_field(2, b"".join(lib))
    parts += _len_field(4, _int_field(1, producer))
    return b"".join(parts)
