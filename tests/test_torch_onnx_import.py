"""The port's ONNX importer (``modelimport/onnx.py``), its codec
(``onnx_proto.py``), the ONNX lints of ``analysis/imports.py`` and the
ResNet-50 writer (``onnx_fixtures.py``) against the JAX package (CPU).

- Every model ``tests/test_onnximport.py`` builds, one single-node graph
  per builder of ``_BUILDERS``, and the traps below import through
  ``deeplearning4j_tpu.modelimport.onnx.importOnnxModel`` and through the
  port's, with equal outputs: ``rtol=atol=1e-5`` and the same dtypes.
- Both packages give the same diagnostic codes and locations for every
  ``TestImportLints`` case (E161, E162, E163, W161, W162, W163).
- The codec writes the same bytes from the same calls, bf16 included.
- ``TestImportLints._resnet_ish`` and a ResNet-50 of 2 blocks a stage at
  narrow widths and 32^2: the port's import of the file against the JAX
  import of the same file and against the port's
  ``ComputationGraph`` (logits 1e-5, softmax against ``output()`` 1e-5).
- Imported graphs cross between the packages through ``save``/``load``.

Traps pinned: ``Gather`` with negative in-range indices (``jnp.take``
wraps them, ``index_select`` refuses them); ``Slice``'s ``1<<31`` end
sentinel and negative steps; ``Conv``'s asymmetric pads and
``SAME_UPPER`` as XLA's ``SAME``; pools padded with -inf or 0 and
``count_include_pad``; int64 initializers narrowed to int32 (x64 off).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.analysis import imports as JIMP
from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu.modelimport import onnx as jonnx
from deeplearning4j_tpu.modelimport import onnx_proto as JP
from deeplearning4j_tpu_torch.analysis import imports as TIMP
from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
from deeplearning4j_tpu_torch.modelimport import onnx as tonnx
from deeplearning4j_tpu_torch.modelimport import onnx_fixtures as fx
from deeplearning4j_tpu_torch.modelimport import onnx_proto as TP

torch.set_num_threads(2)

RTOL = ATOL = 1e-5
P = TP      # the port's encoder writes every fixture (bytes pinned below)


def _model(nodes, inputs, outputs, initializers=()):
    return P.encode_model(
        nodes=nodes,
        inputs=[P.encode_value_info(n, d, s) for n, d, s in inputs],
        outputs=[P.encode_value_info(n, d, s) for n, d, s in outputs],
        initializers=[P.encode_tensor(n, a) for n, a in initializers])


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v)


def _both(blob, feeds, outs):
    """Outputs of the JAX and the port import of ``blob``, as numpy."""
    jsd = jonnx.importOnnxModel(blob)
    tsd = tonnx.importOnnxModel(blob, device="cpu")
    j = jsd.output(feeds, outs)
    t = tsd.output(feeds, outs)
    return {k: _np(j[k]) for k in outs}, {k: _np(t[k]) for k in outs}


def _assert_equal_outputs(blob, feeds, outs, rtol=RTOL, atol=ATOL):
    j, t = _both(blob, feeds, outs)
    for k in outs:
        assert j[k].dtype == t[k].dtype, (k, j[k].dtype, t[k].dtype)
        assert j[k].shape == t[k].shape, (k, j[k].shape, t[k].shape)
        np.testing.assert_allclose(t[k], j[k], rtol=rtol, atol=atol,
                                   err_msg=k)
    return t


# ------------------------------------------- the models of test_onnximport
def _gemm_relu_mlp():
    rng = np.random.RandomState(0)
    w1 = rng.randn(6, 8).astype(np.float32)
    b1 = rng.randn(8).astype(np.float32)
    w2 = rng.randn(8, 3).astype(np.float32)
    blob = _model(
        nodes=[P.encode_node("Gemm", ["x", "w1", "b1"], ["h"], transB=0),
               P.encode_node("Relu", ["h"], ["hr"]),
               P.encode_node("MatMul", ["hr", "w2"], ["logits"]),
               P.encode_node("Softmax", ["logits"], ["probs"], axis=-1)],
        inputs=[("x", np.float32, [None, 6])],
        outputs=[("probs", np.float32, [None, 3])],
        initializers=[("w1", w1), ("b1", b1), ("w2", w2)])
    return blob, {"x": rng.randn(4, 6).astype(np.float32)}, ["probs"]


def _conv_pool_batchnorm():
    rng = np.random.RandomState(1)
    w = (rng.randn(4, 2, 3, 3) * 0.2).astype(np.float32)
    g = (rng.rand(4) + 0.5).astype(np.float32)
    be = rng.randn(4).astype(np.float32)
    mean = rng.randn(4).astype(np.float32)
    var = (rng.rand(4) + 0.5).astype(np.float32)
    blob = _model(
        nodes=[
            P.encode_node("Conv", ["x", "w"], ["c"], pads=[1, 1, 1, 1],
                          strides=[1, 1], kernel_shape=[3, 3]),
            P.encode_node("BatchNormalization",
                          ["c", "g", "be", "mean", "var"], ["bn"],
                          epsilon=1e-5),
            P.encode_node("Relu", ["bn"], ["r"]),
            P.encode_node("MaxPool", ["r"], ["p"], kernel_shape=[2, 2],
                          strides=[2, 2]),
            P.encode_node("GlobalAveragePool", ["p"], ["gap"]),
            P.encode_node("Flatten", ["gap"], ["y"], axis=1)],
        inputs=[("x", np.float32, [2, 2, 8, 8])],
        outputs=[("y", np.float32, [2, 4])],
        initializers=[("w", w), ("g", g), ("be", be), ("mean", mean),
                      ("var", var)])
    return blob, {"x": rng.randn(2, 2, 8, 8).astype(np.float32)}, ["y"]


def _shape_ops_and_const_folding():
    rng = np.random.RandomState(2)
    blob = _model(
        nodes=[P.encode_node("Transpose", ["x"], ["t"], perm=[0, 2, 1]),
               P.encode_node("Reshape", ["t", "shp"], ["r"]),
               P.encode_node("Concat", ["r", "r"], ["cc"], axis=1),
               P.encode_node("Slice", ["cc", "st", "en"], ["s"]),
               P.encode_node("Unsqueeze", ["s", "ax"], ["u"]),
               P.encode_node("Squeeze", ["u", "ax"], ["y"])],
        inputs=[("x", np.float32, [2, 3, 4])],
        outputs=[("y", np.float32, None)],
        initializers=[("shp", np.asarray([2, 12], np.int64)),
                      ("st", np.asarray([0, 2], np.int64)),
                      ("en", np.asarray([2, 10], np.int64)),
                      ("ax", np.asarray([0], np.int64))])
    return blob, {"x": rng.randn(2, 3, 4).astype(np.float32)}, ["y"]


def _reduce_and_elementwise():
    rng = np.random.RandomState(3)
    blob = _model(
        nodes=[P.encode_node("ReduceMean", ["x"], ["m"], axes=[1],
                             keepdims=1),
               P.encode_node("Sub", ["x", "m"], ["d"]),
               P.encode_node("Mul", ["d", "d"], ["sq"]),
               P.encode_node("ReduceSum", ["sq"], ["v"], axes=[1],
                             keepdims=0),
               P.encode_node("Sqrt", ["v"], ["y"])],
        inputs=[("x", np.float32, [3, 5])],
        outputs=[("y", np.float32, [3])])
    return blob, {"x": rng.randn(3, 5).astype(np.float32)}, ["y"]


def _constant_node_and_clip_cast():
    blob = _model(
        nodes=[P.encode_node("Constant", [], ["k"],
                             value=np.asarray([2.0], np.float32)),
               P.encode_node("Mul", ["x", "k"], ["m"]),
               P.encode_node("Clip", ["m"], ["c"], min=0.0, max=3.0),
               P.encode_node("Cast", ["c"], ["y"], to=P.DT_INT32)],
        inputs=[("x", np.float32, [4])],
        outputs=[("y", np.int32, [4])])
    return blob, {"x": np.asarray([-1.0, 0.5, 1.0, 5.0], np.float32)}, ["y"]


def _split_multi_output():
    blob = _model(
        nodes=[P.encode_node("Split", ["x"], ["a", "b"], axis=1)],
        inputs=[("x", np.float32, [2, 6])],
        outputs=[("a", np.float32, [2, 3]), ("b", np.float32, [2, 3])])
    return blob, {"x": np.arange(12, dtype=np.float32).reshape(2, 6)}, \
        ["a", "b"]


def _gemm_tanh():
    rng = np.random.RandomState(4)
    w = rng.randn(5, 2).astype(np.float32)
    blob = _model(
        nodes=[P.encode_node("Gemm", ["x", "w"], ["h"], transB=0, alpha=2.0),
               P.encode_node("Tanh", ["h"], ["y"])],
        inputs=[("x", np.float32, [3, 5])],
        outputs=[("y", np.float32, [3, 2])],
        initializers=[("w", w)])
    return blob, {"x": rng.randn(3, 5).astype(np.float32)}, ["y"]


def _relu():
    blob = _model(nodes=[P.encode_node("Relu", ["x"], ["y"])],
                  inputs=[("x", np.float32, [3])],
                  outputs=[("y", np.float32, [3])])
    return blob, {"x": np.asarray([-1.0, 0.0, 2.0], np.float32)}, ["y"]


def _resnet_ish(classes=260):
    """TestImportLints._resnet_ish: conv stem -> GAP -> classifier."""
    rng = np.random.RandomState(0)
    w = rng.randn(32, 3, 3, 3).astype(np.float32) * 0.1
    fcw = rng.randn(32, classes).astype(np.float32) * 0.1
    fcb = np.zeros((classes,), np.float32)
    blob = _model(
        nodes=[P.encode_node("Conv", ["x", "w"], ["c"], kernel_shape=[3, 3],
                             strides=[2, 2], pads=[1, 1, 1, 1]),
               P.encode_node("Relu", ["c"], ["r"]),
               P.encode_node("GlobalAveragePool", ["r"], ["g"]),
               P.encode_node("Flatten", ["g"], ["f"]),
               P.encode_node("Gemm", ["f", "fcw", "fcb"], ["y"], transB=0)],
        inputs=[("x", np.float32, [None, 3, 32, 32])],
        outputs=[("y", np.float32, [None, classes])],
        initializers=[("w", w), ("fcw", fcw), ("fcb", fcb)])
    x = np.random.RandomState(1).randn(3, 3, 32, 32).astype(np.float32)
    return blob, {"x": x}, ["y"]


MODELS = {"gemm_relu_mlp": _gemm_relu_mlp,
          "conv_pool_batchnorm": _conv_pool_batchnorm,
          "shape_ops_and_const_folding": _shape_ops_and_const_folding,
          "reduce_and_elementwise": _reduce_and_elementwise,
          "constant_node_and_clip_cast": _constant_node_and_clip_cast,
          "split_multi_output": _split_multi_output,
          "gemm_tanh": _gemm_tanh, "relu": _relu,
          "resnet_ish": _resnet_ish}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_models_of_the_jax_suite_match(name):
    _assert_equal_outputs(*MODELS[name]())


def test_constant_clip_cast_gives_int32():
    t = _assert_equal_outputs(*_constant_node_and_clip_cast())
    np.testing.assert_array_equal(t["y"], [0, 1, 2, 3])
    assert t["y"].dtype == np.int32


def test_file_roundtrip(tmp_path):
    blob, feeds, outs = _relu()
    p = str(tmp_path / "m.onnx")
    with open(p, "wb") as f:
        f.write(blob)
    got = _np(tonnx.importOnnxModel(p, device="cpu").output(feeds, outs)["y"])
    want = np.asarray(jonnx.importOnnxModel(p).output(feeds, outs)["y"])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [0.0, 0.0, 2.0])


def test_unmapped_op_raises_in_both():
    blob = _model(nodes=[P.encode_node("NonMaxSuppression", ["x"], ["y"])],
                  inputs=[("x", np.float32, [4])],
                  outputs=[("y", np.float32, [4])])
    with pytest.raises(jonnx.OnnxImportError, match="NonMaxSuppression"):
        jonnx.importOnnxModel(blob)
    with pytest.raises(tonnx.OnnxImportError, match="NonMaxSuppression"):
        tonnx.importOnnxModel(blob, device="cpu")


def test_entry_point_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tonnx.importOnnxModel(_relu()[0])


# ---------------------------------------------------- save/load, crossing
@pytest.mark.parametrize("name", ["gemm_tanh", "conv_pool_batchnorm",
                                  "split_multi_output"])
def test_save_load_crosses_between_the_packages(name, tmp_path):
    blob, feeds, outs = MODELS[name]()
    tsd = tonnx.importOnnxModel(blob, device="cpu")
    jsd = jonnx.importOnnxModel(blob)
    want = {k: _np(v) for k, v in tsd.output(feeds, outs).items()}
    pt, pj = str(tmp_path / "t.sdz"), str(tmp_path / "j.sdz")
    tsd.save(pt)
    jsd.save(pj)
    for k, v in SameDiff.load(pt, device="cpu").output(feeds, outs).items():
        np.testing.assert_array_equal(_np(v), want[k])      # bit-equal
    for k, v in JSameDiff.load(pt).output(feeds, outs).items():
        np.testing.assert_allclose(np.asarray(v), want[k], rtol=RTOL,
                                   atol=ATOL)
    for k, v in SameDiff.load(pj, device="cpu").output(feeds, outs).items():
        np.testing.assert_allclose(_np(v), want[k], rtol=RTOL, atol=ATOL)


# ------------------------------------------------- one graph per builder
def _rand(shape, seed, lo=-2.0, hi=2.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


_X = ("x", np.float32, [2, 3, 4])
_UNARY = ["Neg", "Abs", "Exp", "Floor", "Ceil", "Round", "Sign", "Relu",
          "Sigmoid", "Tanh", "Erf", "Softplus", "Softsign", "Selu",
          "Identity", "Sin", "Cos", "GlobalAveragePool", "GlobalMaxPool",
          "Dropout"]
_POSITIVE = ["Log", "Sqrt", "Reciprocal"]
_BINARY = ["Add", "Sub", "Mul", "Div", "Max", "Min"]
_COMPARE = ["Equal", "Greater", "GreaterOrEqual", "Less", "LessOrEqual"]


def _single(op, inputs, feeds, outs=("y",), out_types=None, inits=(),
            **attrs):
    names = [n for n, _, _ in inputs] + [n for n, _ in inits]
    blob = _model(nodes=[P.encode_node(op, names, list(outs), **attrs)],
                  inputs=inputs,
                  outputs=[(o, np.float32, None) for o in outs]
                  if out_types is None else out_types,
                  initializers=inits)
    return blob, feeds, list(outs)


def _builder_cases():
    x = _rand((2, 3, 4), 0)
    cases = {}
    for op in _UNARY:
        cases[op] = _single(op, [_X], {"x": x})
    for op in _POSITIVE:
        cases[op] = _single(op, [_X], {"x": _rand((2, 3, 4), 1, 0.1, 3.0)})
    y = ("y_in", np.float32, [2, 3, 4])
    for op in _BINARY + _COMPARE:
        cases[op] = _single(op, [_X, y], {"x": x, "y_in": np.round(
            _rand((2, 3, 4), 2))})
    cases["Pow"] = _single("Pow", [_X, y], {"x": _rand((2, 3, 4), 3, 0.1,
                                                       2.0),
                                            "y_in": _rand((2, 3, 4), 4)})
    b = ("b", np.bool_, [2, 3, 4])
    c = ("c", np.bool_, [2, 3, 4])
    bf = {"b": _rand((2, 3, 4), 5) > 0, "c": _rand((2, 3, 4), 6) > 0}
    cases["Not"] = _single("Not", [b], bf)
    cases["And"] = _single("And", [b, c], bf)
    cases["Or"] = _single("Or", [b, c], bf)
    cases["Where"] = _single("Where", [b, _X, y],
                             {"b": bf["b"], "x": x, "y_in": -x})
    cases["MatMul"] = _single("MatMul", [_X, ("w", np.float32, [4, 5])],
                              {"x": x, "w": _rand((4, 5), 7)})
    cases["Shape"] = _single("Shape", [_X], {"x": x})
    cases["Size"] = _single("Size", [_X], {"x": x})
    m = ("m", np.float32, [3, 4])
    mf = {"m": _rand((3, 4), 8)}
    cases["Gemm"] = _single("Gemm", [m, ("w", np.float32, [5, 4]),
                                     ("bias", np.float32, [5])],
                            {**mf, "w": _rand((5, 4), 9),
                             "bias": _rand((5,), 10)},
                            alpha=0.5, beta=2.0, transB=1)
    cases["Softmax"] = _single("Softmax", [_X], {"x": x}, axis=1)
    cases["LogSoftmax"] = _single("LogSoftmax", [_X], {"x": x}, axis=-1)
    cases["LeakyRelu"] = _single("LeakyRelu", [_X], {"x": x}, alpha=0.1)
    cases["Elu"] = _single("Elu", [_X], {"x": x}, alpha=0.7)
    cases["HardSigmoid"] = _single("HardSigmoid", [_X], {"x": x},
                                   alpha=0.3, beta=0.4)
    cases["Gelu"] = _single("Gelu", [_X], {"x": x}, approximate="tanh")
    cases["Clip"] = _single("Clip", [_X, ("lo", np.float32, []),
                                     ("hi", np.float32, [])],
                            {"x": x, "lo": np.float32(-0.5),
                             "hi": np.float32(0.5)})
    cases["Transpose"] = _single("Transpose", [_X], {"x": x})
    cases["Reshape"] = _single("Reshape", [_X], {"x": x},
                               inits=[("s", np.asarray([4, -1], np.int64))])
    cases["Flatten"] = _single("Flatten", [_X], {"x": x}, axis=2)
    cases["Concat"] = _single("Concat", [_X, y], {"x": x, "y_in": -x},
                              axis=-1)
    cases["Squeeze"] = _single("Squeeze", [("x", np.float32, [2, 1, 4])],
                               {"x": _rand((2, 1, 4), 11)})
    cases["Unsqueeze"] = _single("Unsqueeze", [_X], {"x": x},
                                 axes=[0, -1])
    cases["Cast"] = _single("Cast", [_X], {"x": x}, to=P.DT_INT64)
    cases["Expand"] = _single("Expand", [("x", np.float32, [3, 1])],
                              {"x": _rand((3, 1), 12)},
                              inits=[("s", np.asarray([2, 1, 4],
                                                      np.int64))])
    cases["Split"] = _single("Split", [_X], {"x": x}, outs=("p", "q"),
                             inits=[("sp", np.asarray([1, 3], np.int64))],
                             axis=2)
    cases["Pad"] = _single("Pad", [_X], {"x": x},
                           inits=[("pd", np.asarray([0, 1, 2, 0, 0, 1],
                                                    np.int64)),
                                  ("pv", np.asarray(1.5, np.float32))])
    cases["Pad_reflect"] = _single("Pad", [_X], {"x": x}, mode="reflect",
                                   inits=[("pd", np.asarray(
                                       [0, 1, 2, 0, 1, 1], np.int64))])
    cases["Pad_edge"] = _single("Pad", [_X], {"x": x}, mode="edge",
                                inits=[("pd", np.asarray(
                                    [1, 0, 0, 1, 2, 0], np.int64))])
    for op in ("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin",
               "ReduceProd"):
        cases[op] = _single(op, [_X], {"x": x}, axes=[0, 2], keepdims=0)
        cases[op + "_all"] = _single(op, [_X], {"x": x})
    img = ("x", np.float32, [2, 3, 7, 7])
    xf = {"x": _rand((2, 3, 7, 7), 13)}
    cases["Conv"] = _single("Conv", [img, ("w", np.float32, [4, 3, 3, 3]),
                                     ("bias", np.float32, [4])],
                            {**xf, "w": _rand((4, 3, 3, 3), 14),
                             "bias": _rand((4,), 15)},
                            kernel_shape=[3, 3], strides=[2, 1],
                            pads=[1, 0, 1, 2], dilations=[1, 2])
    cases["Conv_same_upper"] = _single(
        "Conv", [img, ("w", np.float32, [6, 1, 2, 2])],
        {**xf, "w": _rand((6, 1, 2, 2), 16)}, kernel_shape=[2, 2],
        strides=[2, 2], auto_pad="SAME_UPPER", group=3)
    cases["Conv1d"] = _single(
        "Conv", [("x", np.float32, [2, 3, 9]),
                 ("w", np.float32, [2, 3, 3])],
        {"x": _rand((2, 3, 9), 17), "w": _rand((2, 3, 3), 18)},
        kernel_shape=[3], pads=[2, 0])
    for kind in ("MaxPool", "AveragePool"):
        cases[kind] = _single(kind, [img], xf, kernel_shape=[3, 3],
                              strides=[2, 2], pads=[1, 1, 1, 1])
        cases[kind + "_asym"] = _single(kind, [img], xf, kernel_shape=[2, 3],
                                        strides=[1, 2], pads=[0, 1, 2, 1])
    cases["AveragePool_count_pad"] = _single(
        "AveragePool", [img], xf, kernel_shape=[3, 3], strides=[2, 2],
        pads=[1, 1, 1, 1], count_include_pad=1)
    cases["AveragePool_asym_count_pad"] = _single(
        "AveragePool", [img], xf, kernel_shape=[2, 3], strides=[1, 2],
        pads=[0, 1, 2, 1], count_include_pad=1)
    g = ("g", np.float32, [3])
    cases["BatchNormalization"] = _single(
        "BatchNormalization", [img, g, ("be", np.float32, [3]),
                               ("mu", np.float32, [3]),
                               ("var", np.float32, [3])],
        {**xf, "g": _rand((3,), 19), "be": _rand((3,), 20),
         "mu": _rand((3,), 21), "var": _rand((3,), 22, 0.5, 2.0)},
        epsilon=1e-3)
    table = ("t", np.float32, [5, 3])
    cases["Gather"] = _single("Gather", [table],
                              {"t": _rand((5, 3), 23)},
                              inits=[("i", np.asarray([[-1, 0], [2, -5]],
                                                      np.int64))])
    cases["Gather_axis1"] = _single("Gather", [table],
                                    {"t": _rand((5, 3), 24)}, axis=1,
                                    inits=[("i", np.asarray([-1, 1],
                                                            np.int64))])
    big = (1 << 62)
    cases["Slice"] = _single("Slice", [_X], {"x": x},
                             inits=[("st", np.asarray([1, -3], np.int64)),
                                    ("en", np.asarray([big, big],
                                                      np.int64)),
                                    ("ax", np.asarray([1, -1], np.int64))])
    cases["Slice_neg_step"] = _single(
        "Slice", [_X], {"x": x},
        inits=[("st", np.asarray([-1, 3], np.int64)),
               ("en", np.asarray([-(1 << 62), 0], np.int64)),
               ("ax", np.asarray([2, 1], np.int64)),
               ("sp", np.asarray([-2, -1], np.int64))])
    return cases


CASES = _builder_cases()


def test_every_builder_has_a_case():
    ops = {k.split("_")[0] for k in CASES if k != "Conv1d"} | {"Conv"}
    assert set(tonnx._BUILDERS) <= ops | {"Reduce" + r for r in
                                          ("Mean", "Sum", "Max", "Min",
                                           "Prod")}
    assert set(tonnx._BUILDERS) == set(jonnx._BUILDERS)


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_builder_matches(case):
    _assert_equal_outputs(*CASES[case])


# ------------------------------------------------------------ the traps
def test_gather_wraps_negative_in_range_indices():
    t = _assert_equal_outputs(*CASES["Gather"])
    table = CASES["Gather"][1]["t"]
    np.testing.assert_array_equal(t["y"], table[[[4, 0], [2, 0]]])


def test_slice_end_sentinel_reads_to_the_end():
    t = _assert_equal_outputs(*CASES["Slice"])
    x = CASES["Slice"][1]["x"]
    np.testing.assert_array_equal(t["y"], x[:, 1:, -3:])


def test_conv_asymmetric_pads_and_same_upper():
    for case in ("Conv", "Conv_same_upper"):
        t = _assert_equal_outputs(*CASES[case])
    # SAME_UPPER: ceil(7 / 2) = 4 outputs, the odd pad after
    assert t["y"].shape == (2, 6, 4, 4)


def test_pools_pad_with_minus_inf_or_zero():
    x = -np.ones((1, 1, 3, 3), np.float32) * 5.0
    img = ("x", np.float32, [1, 1, 3, 3])
    mp = _assert_equal_outputs(*_single("MaxPool", [img], {"x": x},
                                        kernel_shape=[2, 2],
                                        pads=[1, 1, 1, 1]))
    assert (mp["y"] == -5.0).all()      # never the pad's value
    ap = _assert_equal_outputs(*_single("AveragePool", [img], {"x": x},
                                        kernel_shape=[2, 2],
                                        pads=[1, 1, 1, 1]))
    assert (ap["y"] == -5.0).all()      # the pad counts for nothing
    ac = _assert_equal_outputs(*_single("AveragePool", [img], {"x": x},
                                        kernel_shape=[2, 2],
                                        pads=[1, 1, 1, 1],
                                        count_include_pad=1))
    assert ac["y"][0, 0, 0, 0] == -1.25     # one real value of four


def test_int64_initializers_narrow_to_int32():
    ids = np.asarray([3, -2, 7], np.int64)
    blob = _model(
        nodes=[P.encode_node("Identity", ["i"], ["a"]),
               P.encode_node("Mul", ["i", "i"], ["sq"]),
               P.encode_node("Add", ["x", "sq"], ["y"])],
        inputs=[("x", np.int64, [3])],
        outputs=[("a", np.int64, [3]), ("y", np.int64, [3])],
        initializers=[("i", ids)])
    t = _assert_equal_outputs(blob, {"x": np.asarray([1, 2, 3], np.int64)},
                              ["a", "y"])
    assert t["a"].dtype == np.int32 and t["y"].dtype == np.int32
    np.testing.assert_array_equal(t["y"], [10, 6, 52])


# ------------------------------------------------------------- the codec
def _same_bytes(fn_name, *args, **kw):
    a = getattr(JP, fn_name)(*args, **kw)
    b = getattr(TP, fn_name)(*args, **kw)
    assert a == b, fn_name
    return a


@pytest.mark.parametrize("arr", [
    np.arange(12, dtype=np.float32).reshape(3, 4),
    np.asarray([1, -2, 1 << 40], np.int64), np.asarray(7, np.int32),
    np.asarray([0.5, -1.5], np.float16), np.asarray([True, False]),
    np.zeros((0, 3), np.float64)], ids=lambda a: str(a.dtype))
def test_codec_encodes_the_same_tensor_bytes(arr):
    blob = _same_bytes("encode_tensor", "w", arr)
    t = TP.TensorProto.parse(blob)
    assert t.name == "w" and t.array.dtype == arr.dtype
    np.testing.assert_array_equal(t.array, arr)


def test_codec_bf16_bytes_and_int_data_bit_patterns():
    ml_dtypes = pytest.importorskip("ml_dtypes")
    vals = np.asarray([1.0, -3.5, 0.125], np.float32)
    jb = JP.encode_tensor("b", vals.astype(ml_dtypes.bfloat16))
    tb = TP.encode_tensor("b", torch.from_numpy(vals).to(torch.bfloat16))
    assert jb == tb
    back = TP.TensorProto.parse(tb).array
    assert back.dtype == torch.bfloat16
    np.testing.assert_array_equal(back.float().numpy(), vals)
    for dt, bits in ((P.DT_FLOAT16, np.asarray([1.5, -2.25, 0.0078125],
                                               np.float16)),
                     (P.DT_BFLOAT16, vals.astype(ml_dtypes.bfloat16))):
        buf = bytearray()
        TP._w_int(buf, 1, 3)
        TP._w_int(buf, 2, dt)
        for b in bits.view(np.uint16):      # int32_data as varints
            TP._w_int(buf, 5, int(b))
        j = JP.TensorProto.parse(bytes(buf)).array
        t = TP.TensorProto.parse(bytes(buf)).array
        t = t.float().numpy() if isinstance(t, torch.Tensor) else t
        np.testing.assert_array_equal(t, np.asarray(j, np.float32))


@pytest.mark.parametrize("value", [3, True, 0.25, "SAME_UPPER", [1, 2, -3],
                                   [0.5, 1.5], np.ones((2, 2), np.float32)],
                         ids=lambda v: type(v).__name__)
def test_codec_encodes_the_same_attribute_bytes(value):
    _same_bytes("encode_attr", "a", value)


def test_codec_encodes_the_same_node_value_info_and_model_bytes():
    n = _same_bytes("encode_node", "Conv", ["x", "w"], ["y"],
                    kernel_shape=[3, 3], pads=[1, 1, 1, 1], alpha=0.5)
    vi = _same_bytes("encode_value_info", "x", np.float32, [None, 3, 8])
    t = _same_bytes("encode_tensor", "w", np.ones((4, 3, 3, 3), np.float32))
    m = _same_bytes("encode_model", [n], [vi], [vi], [t], opset=13,
                    graph_name="g2")
    tm, jm = TP.load_model(m), JP.load_model(m)
    assert tm.opset_version == jm.opset_version == 13
    assert tm.graph.name == jm.graph.name == "g2"
    assert tm.graph.inputs[0].shape == jm.graph.inputs[0].shape \
        == [None, 3, 8]
    assert tm.graph.nodes[0].attr("pads") == jm.graph.nodes[0].attr("pads")
    assert tm.graph.nodes[0].attr("alpha") == jm.graph.nodes[0].attr("alpha")


# ------------------------------------------------------------- the lints
def _diags(report):
    return [(d.code, d.location) for d in report]


def _lint_cases():
    w = np.zeros((4, 3, 3, 3), np.float32)
    return {
        "e161_every_unmapped_op": _model(
            nodes=[P.encode_node("NonMaxSuppression", ["x"], ["y"]),
                   P.encode_node("StringNormalizer", ["y"], ["z"])],
            inputs=[("x", np.float32, [4])],
            outputs=[("z", np.float32, [4])]),
        "e162_ceil_mode_pool": _model(
            nodes=[P.encode_node("MaxPool", ["x"], ["y"],
                                 kernel_shape=[2, 2], strides=[2, 2],
                                 ceil_mode=1)],
            inputs=[("x", np.float32, [1, 3, 5, 5])],
            outputs=[("y", np.float32, [1, 3, 3, 3])]),
        "e162_same_lower_conv": _model(
            nodes=[P.encode_node("Conv", ["x", "w"], ["y"],
                                 kernel_shape=[3, 3],
                                 auto_pad="SAME_LOWER")],
            inputs=[("x", np.float32, [1, 3, 8, 8])],
            outputs=[("y", np.float32, [1, 4, 8, 8])],
            initializers=[("w", w)]),
        "e162_reflect_pad": _model(
            nodes=[P.encode_node("Pad", ["x", "p"], ["y"], mode="reflect")],
            inputs=[("x", np.float32, [1, 3, 8, 8])],
            outputs=[("y", np.float32, None)],
            initializers=[("p", np.asarray([0, 0, 1, 1, 0, 0, 1, 1],
                                           np.int64))]),
        "clean_pool": _model(
            nodes=[P.encode_node("MaxPool", ["x"], ["y"],
                                 kernel_shape=[2, 2], strides=[2, 2])],
            inputs=[("x", np.float32, [None, 3, 8, 8])],
            outputs=[("y", np.float32, [None, 3, 4, 4])]),
        "e163_float64_initializer": _model(
            nodes=[P.encode_node("MatMul", ["x", "w"], ["y"])],
            inputs=[("x", np.float32, [None, 3])],
            outputs=[("y", np.float32, [None, 3])],
            initializers=[("w", np.eye(3, dtype=np.float64))]),
        "e163_int64_initializer_out_of_range": _model(
            nodes=[P.encode_node("Identity", ["i"], ["y"])],
            inputs=[], outputs=[("y", np.int64, [2])],
            initializers=[("i", np.asarray([2 ** 40, 1], np.int64))]),
        "e163_int64_graph_input": _model(
            nodes=[P.encode_node("Identity", ["x"], ["y"])],
            inputs=[("x", np.int64, [None, 4])],
            outputs=[("y", np.int64, [None, 4])]),
        "w161_dynamic_dims": _model(
            nodes=[P.encode_node("Relu", ["x"], ["y"])],
            inputs=[("x", np.float32, [None, None, None])],
            outputs=[("y", np.float32, [None, None, None])]),
        "clean_rank0_input": _model(
            nodes=[P.encode_node("Relu", ["x"], ["y"])],
            inputs=[("x", np.float32, None)],
            outputs=[("y", np.float32, None)]),
        "resnet_ish": _resnet_ish()[0],
    }


LINTS = _lint_cases()


@pytest.mark.parametrize("case", sorted(LINTS))
def test_prescan_gives_the_same_codes_and_locations(case):
    blob = LINTS[case]
    j = _diags(JIMP.lint_onnx_model(JP.load_model(blob)))
    t = _diags(TIMP.lint_onnx_model(TP.load_model(blob)))
    assert t == j
    expect = case.split("_")[0].upper()
    if expect.startswith(("E", "W")):
        assert f"DL4J-{expect}" in {c for c, _ in t}, t
    else:
        assert not t


def test_e161_prescan_reports_every_unmapped_op():
    report = TIMP.lint_onnx_model(TP.load_model(
        LINTS["e161_every_unmapped_op"]))
    assert report.codes().count("DL4J-E161") == 2, report.format()
    assert "NonMaxSuppression" in report.format()
    assert "StringNormalizer" in report.format()


def test_supported_ops_pin_matches_both_importers():
    assert TIMP.SUPPORTED_ONNX_OPS == frozenset(tonnx._BUILDERS) | \
        {"Constant"} == JIMP.SUPPORTED_ONNX_OPS


def test_direct_lints_give_the_same_codes():
    for args in (((None, None, 224), "input 'x'"),
                 ((None, 3, 224), "input 'x'"), (None, "input 'x'")):
        assert _diags(TIMP.lint_placeholder_shape(*args)) == \
            _diags(JIMP.lint_placeholder_shape(*args))
    for arr in (np.asarray([2 ** 40], np.int64),
                np.asarray([1, 2, 3], np.int64), np.eye(2)):
        assert _diags(TIMP.lint_narrowed_array(arr, "initializer 'a'")) \
            == _diags(JIMP.lint_narrowed_array(arr, "initializer 'a'"))
    for arr in (np.asarray([np.inf], np.float32),
                np.asarray([2 ** 40], np.int64),
                np.asarray([1.0], np.float32)):
        assert _diags(TIMP.fold_overflow_diags("Add", "s", [arr])) == \
            _diags(JIMP.fold_overflow_diags("Add", "s", [arr]))


def test_w163_folded_inf_in_both_import_reports():
    a = np.asarray([3.0e38], np.float32)
    blob = _model(nodes=[P.encode_node("Add", ["a", "a"], ["s"]),
                         P.encode_node("Add", ["x", "s"], ["y"])],
                  inputs=[("x", np.float32, [None, 1])],
                  outputs=[("y", np.float32, [None, 1])],
                  initializers=[("a", a)])
    t = tonnx.importOnnxModel(blob, device="cpu").import_report
    j = jonnx.importOnnxModel(blob).import_report
    assert _diags(t) == _diags(j)
    assert "DL4J-W163" in t.codes(), t.format()


@pytest.mark.parametrize("case", ["clean", "resnet_ish"])
def test_import_reports_match(case):
    blob = _model(nodes=[P.encode_node("MatMul", ["x", "w"], ["y"])],
                  inputs=[("x", np.float32, [None, 4])],
                  outputs=[("y", np.float32, [None, 4])],
                  initializers=[("w", np.ones((4, 4), np.float32))]) \
        if case == "clean" else LINTS["resnet_ish"]
    t = tonnx.importOnnxModel(blob, device="cpu").import_report
    j = jonnx.importOnnxModel(blob).import_report
    assert _diags(t) == _diags(j) == []


def test_w162_frozen_weight_with_training_config():
    blob = _model(nodes=[P.encode_node("MatMul", ["x", "w"], ["y"])],
                  inputs=[("x", np.float32, [None, 4])],
                  outputs=[("y", np.float32, [None, 3])],
                  initializers=[("w", np.ones((4, 3), np.float32))])
    sd = tonnx.importOnnxModel(blob, device="cpu")
    jsd = jonnx.importOnnxModel(blob)
    assert not TIMP.lint_frozen_constants(sd)
    sd.setTrainingConfig(TrainingConfig())
    from deeplearning4j_tpu.autodiff.samediff import TrainingConfig as JTC
    jsd.setTrainingConfig(JTC())
    assert _diags(TIMP.lint_frozen_constants(sd)) == \
        _diags(JIMP.lint_frozen_constants(jsd))
    assert [c for c, _ in _diags(TIMP.lint_frozen_constants(sd))] == \
        ["DL4J-W162"]
    sd.convertToVariables("w")
    assert not TIMP.lint_frozen_constants(sd)


# ------------------------------------------- ResNet-50 through onnx_fixtures
@pytest.fixture(scope="module")
def small_resnet(tmp_path_factory):
    net = fx.SmallResNet50(num_classes=10, input_shape=(3, 32, 32)).init(
        device="cpu")
    fx.randomize_batch_norm(net, seed=0)
    path = fx.write_resnet50(net, str(tmp_path_factory.mktemp("onnx")
                                      / "resnet.onnx"))
    x = np.random.default_rng(0).standard_normal((4, 3, 32, 32),
                                                 dtype=np.float32)
    return net, path, x


def test_resnet_fixture_uses_the_zoo_node_kinds(small_resnet):
    net, path, _ = small_resnet
    m = TP.load_model(path)
    kinds = {n.op_type for n in m.graph.nodes}
    assert kinds == {"Conv", "BatchNormalization", "Relu", "MaxPool", "Add",
                     "ReduceMean", "Flatten", "Gemm"}
    n_conv = sum(n.op_type == "Conv" for n in m.graph.nodes)
    assert n_conv == 1 + 3 * 8 + 4            # stem, 8 blocks, 4 shortcuts
    n_init = sum(int(np.prod(t.array.shape)) for t in m.graph.initializers)
    n_state = sum(v.numel() for s in net._states.values() for v in s.values())
    assert n_init == net.numParams() + n_state


def test_resnet_import_matches_jax_and_the_graph(small_resnet):
    net, path, x = small_resnet
    sd = tonnx.importOnnxModel(path, device="cpu")
    assert not sd.import_report.diagnostics, sd.import_report.format()
    got = _np(sd.output({"input": x}, ["logits"])["logits"])
    jgot = np.asarray(jonnx.importOnnxModel(path).output(
        {"input": x}, ["logits"])["logits"])
    np.testing.assert_allclose(got, jgot, rtol=RTOL, atol=ATOL)
    xt = torch.from_numpy(x)
    want = _np(fx.resnet50_logits(net, xt))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    probs = _np(net.output(xt))
    np.testing.assert_allclose(_np(torch.softmax(torch.from_numpy(got), -1)),
                               probs, rtol=RTOL, atol=ATOL)


def test_resnet_import_saves_and_loads_bit_equal(small_resnet, tmp_path):
    _, path, x = small_resnet
    sd = tonnx.importOnnxModel(path, device="cpu")
    p = str(tmp_path / "resnet.sdz")
    sd.save(p)
    back = SameDiff.load(p, device="cpu")
    a = sd.output({"input": x}, ["logits"])["logits"]
    b = back.output({"input": x}, ["logits"])["logits"]
    assert torch.equal(a, b)
