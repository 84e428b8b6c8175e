"""The port's stdlib GraphDef codec (``modelimport/tf_proto.py``) against
TensorFlow's own classes (CPU).

Every GraphDef of the stored corpus (``tests/fixtures/tfgraphs``, 130
graphs) decodes to the nodes, ops, inputs, devices and attributes TF's
``graph_pb2`` parse gives, every const to the array
``tensor_util.MakeNdarray`` gives (bit for bit), and function libraries
to the same signatures, bodies and ret maps. The encoder's bytes parse
with TF to the graph that was meant. Tensor edge cases: ``half_val``
fp16 and bf16, ``tensor_content`` bf16, splat consts (fewer values than
elements), packed and unpacked repeated fields, strings, negative ints.
"""

import os

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")
from tensorflow.core.framework import graph_pb2, tensor_pb2  # noqa: E402
from tensorflow.python.framework import tensor_util  # noqa: E402

from deeplearning4j_tpu_torch.modelimport import tf_proto as P  # noqa: E402

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "tfgraphs")
FIXTURES = sorted(f for f in os.listdir(FIXTURE_DIR) if f.endswith(".npz"))


def _as_np(x):
    """A decoded const as numpy (bf16 tensors widened to fp32, exact)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return x


def _same_array(got, want, where):
    got = _as_np(got)
    want = np.asarray(want)
    assert got.shape == want.shape, where
    if want.dtype == object:
        assert list(got.ravel()) == list(want.ravel()), where
        return
    if str(want.dtype) == "bfloat16":
        want = want.astype(np.float32)
    else:
        assert got.dtype == want.dtype, (where, got.dtype, want.dtype)
    # bit for bit: compare the bytes (NaN payloads and -0.0 included)
    np.testing.assert_array_equal(
        np.frombuffer(np.ascontiguousarray(got).tobytes(), np.uint8),
        np.frombuffer(np.ascontiguousarray(want).tobytes(), np.uint8),
        err_msg=where)


def _same_attr(a, b, where):
    kind = b.WhichOneof("value")
    assert a.WhichOneof("value") == kind, where
    if kind in ("s", "i", "b", "type", "placeholder"):
        assert getattr(a, kind) == getattr(b, kind), where
    elif kind == "f":
        assert np.float32(a.f) == np.float32(b.f), where
    elif kind == "shape":
        assert [d.size for d in a.shape.dim] == [d.size for d in b.shape.dim]
        assert a.shape.unknown_rank == b.shape.unknown_rank, where
    elif kind == "tensor":
        _same_array(P.make_ndarray(a.tensor),
                    tensor_util.MakeNdarray(b.tensor), where)
    elif kind == "func":
        assert a.func.name == b.func.name, where
    elif kind == "list":
        for f in ("s", "i", "b", "type"):
            assert list(getattr(a.list, f)) == list(getattr(b.list, f)), where
        assert np.array_equal(np.float32(a.list.f), np.float32(b.list.f))
        assert [[d.size for d in s.dim] for s in a.list.shape] == \
            [[d.size for d in s.dim] for s in b.list.shape], where


def _same_nodes(got, want, where):
    assert len(got) == len(want), where
    for n, m in zip(got, want):
        assert (n.name, n.op, list(n.input), n.device) == \
            (m.name, m.op, list(m.input), m.device), where
        assert set(n.attr) == set(m.attr), (where, n.name)
        for k in m.attr:
            _same_attr(n.attr[k], m.attr[k], f"{where}:{n.name}:{k}")


def _same_graph(g, h, where):
    _same_nodes(g.node, h.node, where)
    assert g.HasField("library") == h.HasField("library"), where
    assert len(g.library.function) == len(h.library.function), where
    for fa, fb in zip(g.library.function, h.library.function):
        assert fa.signature.name == fb.signature.name
        for x, y in ((fa.signature.input_arg, fb.signature.input_arg),
                     (fa.signature.output_arg, fb.signature.output_arg)):
            assert [(a.name, a.type) for a in x] == \
                [(a.name, a.type) for a in y], where
        assert dict(fa.ret) == dict(fb.ret), where
        _same_nodes(fa.node_def, fb.node_def, f"{where}:{fa.signature.name}")


@pytest.mark.parametrize("fname", FIXTURES)
def test_corpus_decodes_as_tensorflow_does(fname):
    data = np.load(os.path.join(FIXTURE_DIR, fname), allow_pickle=False)
    raw = data["graph_def"].tobytes()
    want = graph_pb2.GraphDef()
    want.ParseFromString(raw)
    _same_graph(P.load_graph_def(raw), want, fname)


def test_corpus_has_130_graphs_and_a_function_library():
    assert len(FIXTURES) == 130
    libs = 0
    for fname in FIXTURES:
        raw = np.load(os.path.join(FIXTURE_DIR, fname))["graph_def"].tobytes()
        libs += P.load_graph_def(raw).HasField("library")
    assert libs == 5          # the StatelessWhile/StatelessIf graphs


def _tf_tensor(**fields):
    t = tensor_pb2.TensorProto(**fields)
    return t, P.TensorProto.parse(t.SerializeToString())


def _shape(*dims):
    from tensorflow.core.framework import tensor_shape_pb2
    return tensor_shape_pb2.TensorShapeProto(
        dim=[tensor_shape_pb2.TensorShapeProto.Dim(size=d) for d in dims])


@pytest.mark.parametrize("case", [
    "half_val_fp16", "half_val_bf16", "content_bf16", "splat_float",
    "splat_int64", "bool_val", "string_val", "negative_int_val",
    "double_val", "empty_values_zeros", "uint32_val", "scalar"])
def test_tensor_fields_decode_as_make_ndarray(case):
    rng = np.random.RandomState(0)
    f16 = rng.randn(6).astype(np.float16)
    bf_bits = (rng.randn(6).astype(np.float32).view(np.uint32) >> 16
               ).astype(np.uint16)
    fields = {
        "half_val_fp16": dict(dtype=P.DT_HALF, tensor_shape=_shape(2, 3),
                              half_val=f16.view(np.uint16).tolist()),
        "half_val_bf16": dict(dtype=P.DT_BFLOAT16, tensor_shape=_shape(2, 3),
                              half_val=bf_bits.tolist()),
        "content_bf16": dict(dtype=P.DT_BFLOAT16, tensor_shape=_shape(3, 2),
                             tensor_content=bf_bits.tobytes()),
        "splat_float": dict(dtype=P.DT_FLOAT, tensor_shape=_shape(4, 5),
                            float_val=[1.5]),
        "splat_int64": dict(dtype=P.DT_INT64, tensor_shape=_shape(7),
                            int64_val=[3, -9]),
        "bool_val": dict(dtype=P.DT_BOOL, tensor_shape=_shape(3),
                         bool_val=[True, False, True]),
        "string_val": dict(dtype=P.DT_STRING, tensor_shape=_shape(2),
                           string_val=[b"ab", b"\xffc"]),
        "negative_int_val": dict(dtype=P.DT_INT32, tensor_shape=_shape(3),
                                 int_val=[-1, 2 ** 31 - 1, -2 ** 31]),
        "double_val": dict(dtype=P.DT_DOUBLE, tensor_shape=_shape(2),
                           double_val=[np.pi, -1e300]),
        "empty_values_zeros": dict(dtype=P.DT_FLOAT,
                                   tensor_shape=_shape(2, 2)),
        "uint32_val": dict(dtype=P.DT_UINT32, tensor_shape=_shape(2),
                           uint32_val=[0, 2 ** 32 - 1]),
        "scalar": dict(dtype=P.DT_INT32, int_val=[42]),
    }[case]
    t, mine = _tf_tensor(**fields)
    got = P.make_ndarray(mine)
    want = tensor_util.MakeNdarray(t)
    if fields["dtype"] == P.DT_BFLOAT16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy().view(np.uint16).ravel(),
            np.asarray(want).view(np.uint16).ravel())
    _same_array(got, want, case)


def test_tensor_content_is_a_view_not_a_copy():
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    raw = P.encode_tensor(arr)
    got = P.make_ndarray(P.TensorProto.parse(raw))
    assert not got.flags.owndata and not got.flags.writeable
    np.testing.assert_array_equal(got, arr)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32,
                                   np.int64, np.bool_, np.float16, "bf16"])
def test_encoded_values_parse_with_tensorflow(dtype, packed):
    rng = np.random.RandomState(1)
    if dtype == "bf16":
        arr = torch.from_numpy(rng.randn(2, 3).astype(np.float32)).to(
            torch.bfloat16)
        want = arr.float().numpy()
    else:
        arr = (rng.randn(2, 3) * 100).astype(dtype)
        want = arr
    raw = P.encode_tensor(arr, as_values=True, packed=packed)
    t = tensor_pb2.TensorProto()
    t.ParseFromString(raw)
    np.testing.assert_array_equal(
        np.asarray(tensor_util.MakeNdarray(t)).astype(np.float32)
        if dtype == "bf16" else tensor_util.MakeNdarray(t), want)
    _same_array(P.make_ndarray(P.TensorProto.parse(raw)),
                tensor_util.MakeNdarray(t), str(dtype))


def test_encoded_splat_parses_with_tensorflow():
    raw = P.encode_tensor(np.full((3, 4), 2.5, np.float32), splat=True)
    t = tensor_pb2.TensorProto()
    t.ParseFromString(raw)
    assert list(t.float_val) == [2.5]
    np.testing.assert_array_equal(tensor_util.MakeNdarray(t),
                                  np.full((3, 4), 2.5, np.float32))
    np.testing.assert_array_equal(P.make_ndarray(P.TensorProto.parse(raw)),
                                  np.full((3, 4), 2.5, np.float32))


def _encoded_graph():
    f32, i32 = P.Attr.dtype(np.float32), P.Attr.dtype(np.int32)
    body = [P.encode_node("add", "AddV2", ["x", "one:output:0"], T=f32),
            P.encode_const("one", np.float32(1.0))]
    fn = P.encode_function("plus_one", [("x", np.float32)],
                           [("y", np.float32)], body, {"y": "add:z:0"})
    nodes = [
        P.encode_node("x", "Placeholder", dtype=f32,
                      shape=P.Attr.shape([-1, 4])),
        P.encode_node("u", "Placeholder", dtype=f32, shape=P.Attr.shape(None)),
        P.encode_const("w", np.arange(8, dtype=np.float32).reshape(4, 2)),
        P.encode_const("hb", np.arange(4, dtype=np.float16), as_values=True,
                       packed=False),
        P.encode_const("neg", np.asarray([-3, 7], np.int64), as_values=True),
        P.encode_const("s", np.asarray([b"a", b"bc"], object)),
        P.encode_node("mm", "MatMul", ["x", "w"], T=f32, transpose_a=False,
                      transpose_b=False),
        P.encode_node("ss", "StridedSlice", ["mm", "w", "w", "w"], T=f32,
                      Index=i32, begin_mask=5, shrink_axis_mask=0),
        P.encode_node("lr", "LeakyRelu", ["mm", "^x"], device="/CPU:0",
                      T=f32, alpha=0.25),
        P.encode_node("sq", "Squeeze", ["lr"], T=f32, squeeze_dims=[1, -2]),
        P.encode_node("lf", "Foo", [], floats=[0.5, -1.5], name_s="abc",
                      types=P.Attr.types([np.float32, np.int64])),
        P.encode_node("call", "PartitionedCall", ["x"],
                      f=P.Attr.func("plus_one"), Tin=P.Attr.types([np.float32]),
                      Tout=P.Attr.types([np.float32])),
    ]
    return P.encode_graph_def(nodes, functions=[fn])


def test_encoded_graph_parses_with_tensorflow_to_the_same_graph():
    raw = _encoded_graph()
    want = graph_pb2.GraphDef()
    want.ParseFromString(raw)
    mine = P.load_graph_def(raw)
    _same_graph(mine, want, "encoded")
    names = [n.name for n in want.node]
    assert names == ["x", "u", "w", "hb", "neg", "s", "mm", "ss", "lr", "sq",
                     "lf", "call"]
    by = {n.name: n for n in want.node}
    assert by["lr"].device == "/CPU:0" and list(by["lr"].input) == ["mm", "^x"]
    assert abs(by["lr"].attr["alpha"].f - 0.25) < 1e-7
    assert list(by["sq"].attr["squeeze_dims"].list.i) == [1, -2]
    assert [d.size for d in by["x"].attr["shape"].shape.dim] == [-1, 4]
    assert by["u"].attr["shape"].shape.unknown_rank
    assert by["ss"].attr["begin_mask"].i == 5
    np.testing.assert_array_equal(
        tensor_util.MakeNdarray(by["hb"].attr["value"].tensor),
        np.arange(4, dtype=np.float16))
    np.testing.assert_array_equal(
        tensor_util.MakeNdarray(by["neg"].attr["value"].tensor), [-3, 7])
    assert list(tensor_util.MakeNdarray(by["s"].attr["value"].tensor)) == \
        [b"a", b"bc"]
    fn = want.library.function[0]
    assert fn.signature.name == "plus_one" and dict(fn.ret) == {"y": "add:z:0"}
    assert by["call"].attr["f"].func.name == "plus_one"


def test_graph_def_object_and_path_load(tmp_path):
    raw = _encoded_graph()
    p = tmp_path / "g.pb"
    p.write_bytes(raw)
    a, b = P.load_graph_def(str(p)), P.load_graph_def(memoryview(raw))
    assert [n.name for n in a.node] == [n.name for n in b.node]
    assert a.HasField("versions") and not P.GraphDef().HasField("library")


def test_attr_value_oneof_and_errors():
    a = P.AttrValue.parse(P.encode_attr_value(3))
    assert a.WhichOneof("value") == "i" and a.i == 3
    assert P.AttrValue().WhichOneof("value") is None
    with pytest.raises(ValueError):
        a.WhichOneof("other")
    with pytest.raises(TypeError):
        P.encode_attr_value(object())
    with pytest.raises(ValueError, match="wire type"):
        P.GraphDef.parse(bytes([0x0B]))         # field 1, wire type 3
