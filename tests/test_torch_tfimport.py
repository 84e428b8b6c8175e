"""The port's TF GraphDef importer (``modelimport/tensorflow.py``) against
the stored TF goldens and the JAX package's importer (CPU).

- Every graph of the stored corpus (``tests/fixtures/tfgraphs``: 130
  frozen graphs with TF-computed goldens, the 7 control-flow graphs
  among them) imports through the port, parsed by its stdlib codec, and
  matches its goldens at ``rtol=1e-4, atol=1e-5`` (the tolerance of
  ``tests/test_tfimport.py``).
- The BERT-style attention block and 11 others also against the JAX
  ``importTensorflowGraph`` on the same feeds, at the same tolerance.
- The import report (E163, W161, a clean graph), ``save``/``load`` of
  imported graphs in both directions between the packages, the refusals
  (an unmapped op, a v1 conditional), W162, and the fine-tune of
  ``TestImportedGraphFinetune``: the port's losses against the JAX ones
  step for step over 10 Adam steps at 2e-4.
"""

import os

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")
from tensorflow.core.framework import graph_pb2  # noqa: E402
from tensorflow.python.framework.convert_to_constants import (  # noqa: E402
    convert_variables_to_constants_v2)

from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff  # noqa: E402,E501
from deeplearning4j_tpu.autodiff.samediff import TrainingConfig as JTC  # noqa: E402,E501
from deeplearning4j_tpu.modelimport import tensorflow as jtf  # noqa: E402
from deeplearning4j_tpu.train import updaters as jupd  # noqa: E402
from deeplearning4j_tpu_torch.analysis import imports as timp  # noqa: E402
from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig  # noqa: E402,E501
from deeplearning4j_tpu_torch.modelimport.tensorflow import (  # noqa: E402
    TFImportError, importTensorflowGraph)
from deeplearning4j_tpu_torch.train import updaters as tupd  # noqa: E402

torch.set_num_threads(2)

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "tfgraphs")
FIXTURES = sorted(f for f in os.listdir(FIXTURE_DIR) if f.endswith(".npz"))
CONTROL_FLOW = ["test_while_loop.npz", "test_while_loop_matmul_carry.npz",
                "test_lowered_while_imports.npz",
                "test_lowered_while_with_invariant_capture.npz",
                "test_nested_while_in_cond.npz",
                "test_stateless_if_true.npz", "test_stateless_if_false.npz"]
AGAINST_JAX = ["test_bert_style_attention_block.npz",
               "test_mlp_matmul_bias_relu_softmax.npz",
               "test_conv_pool_nhwc.npz",
               "test_strided_slice_newaxis_ellipsis.npz",
               "test_gather_slice_select.npz", "test_segment_ops.npz",
               "test_topk_onehot_cumsum.npz",
               "test_roll_broadcast_linspace.npz",
               "test_resize_bilinear_nearest.npz", "test_while_loop.npz",
               "test_lowered_while_with_invariant_capture.npz",
               "test_stateless_if_false.npz"]


def _fixture(fname):
    data = np.load(os.path.join(FIXTURE_DIR, fname), allow_pickle=False)
    ins = [str(n) for n in data["in_names"]]
    outs = [str(n) for n in data["out_names"]]
    feeds = dict(zip(ins, [data[f"feed_{i}"] for i in range(len(ins))]))
    goldens = [data[f"golden_{i}"] for i in range(len(outs))]
    return data["graph_def"].tobytes(), feeds, outs, goldens


def test_corpus_holds_130_graphs_and_the_control_flow_ones():
    assert len(FIXTURES) == 130
    assert set(CONTROL_FLOW) <= set(FIXTURES)


@pytest.mark.parametrize("fname", FIXTURES)
def test_fixture_matches_tf_golden(fname):
    raw, feeds, outs, goldens = _fixture(fname)
    sd = importTensorflowGraph(raw, device="cpu")
    res = sd.output(feeds, outs)
    for name, want in zip(outs, goldens):
        got = res[name].numpy()
        assert got.shape == want.shape, (name, got.shape, want.shape)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{fname}:{name}")


@pytest.mark.parametrize("fname", AGAINST_JAX)
def test_fixture_matches_jax_import(fname):
    raw, feeds, outs, _ = _fixture(fname)
    gd = graph_pb2.GraphDef()
    gd.ParseFromString(raw)
    want = JSameDiff.output(jtf.importTensorflowGraph(gd), feeds, outs)
    got = importTensorflowGraph(raw, device="cpu").output(feeds, outs)
    for name in outs:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-4, atol=1e-5,
                                   err_msg=f"{fname}:{name}")


def test_accepts_a_decoded_graph_def_a_path_and_a_tf_object(tmp_path):
    from deeplearning4j_tpu_torch.modelimport import tf_proto
    raw, feeds, outs, goldens = _fixture("test_mlp_matmul_bias_relu_softmax.npz")
    p = tmp_path / "g.pb"
    p.write_bytes(raw)
    tf_obj = graph_pb2.GraphDef()
    tf_obj.ParseFromString(raw)
    for src in (tf_proto.load_graph_def(raw), str(p), tf_obj):
        got = importTensorflowGraph(src, device="cpu").output(feeds, outs)
        np.testing.assert_allclose(got[outs[0]].numpy(), goldens[0],
                                   rtol=1e-4, atol=1e-5)


def test_import_raises_without_a_card_unless_given_the_cpu(monkeypatch):
    raw = _fixture("op_abs.npz")[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        importTensorflowGraph(raw)
    assert importTensorflowGraph(raw, device="cpu").device.type == "cpu"


def _frozen(fn, *specs, lower_cf=True):
    conc = tf.function(fn).get_concrete_function(*specs)
    frozen = convert_variables_to_constants_v2(
        conc, lower_control_flow=lower_cf)
    in_names = [t.name.split(":")[0] for t in frozen.inputs]
    out_names = [t.name.split(":")[0] for t in frozen.outputs]
    return frozen.graph.as_graph_def(), in_names, out_names


class TestImportReport:
    """JAX ``TestTFImportReport``: E163 for narrowed consts, W161 for
    dynamic-dim placeholders, a clean bill for a well-formed graph; the
    port's codes equal the JAX importer's."""

    def _both(self, gd):
        port = importTensorflowGraph(gd.SerializeToString(), device="cpu")
        jax_sd = jtf.importTensorflowGraph(gd)
        assert port.import_report.codes() == jax_sd.import_report.codes()
        return port.import_report

    def test_e163_float64_const(self):
        gd, _, _ = _frozen(lambda x: x + tf.cast(
            tf.constant(np.pi, tf.float64), tf.float32),
            tf.TensorSpec([2], tf.float32))
        assert "DL4J-E163" in self._both(gd).codes()

    def test_w161_dynamic_non_batch_dim(self):
        gd, _, _ = _frozen(tf.nn.relu, tf.TensorSpec([None, None, 8],
                                                     tf.float32))
        assert "DL4J-W161" in self._both(gd).codes()

    def test_clean_graph_attaches_empty_report(self):
        gd, _, _ = _frozen(lambda x: tf.nn.relu(tf.matmul(x, tf.ones((4, 2)))),
                           tf.TensorSpec([None, 4], tf.float32))
        report = self._both(gd)
        assert not report.diagnostics, report.format()


def test_w163_overflowing_fold_and_e163_big_int64():
    from deeplearning4j_tpu_torch.modelimport import tf_proto as P
    f32 = P.Attr.dtype(np.float32)
    nodes = [P.encode_node("x", "Placeholder", dtype=f32,
                           shape=P.Attr.shape([-1, 2])),
             P.encode_const("big", np.asarray([3e38, 1.0], np.float32)),
             P.encode_const("two", np.float32(2.0)),
             P.encode_node("over", "Mul", ["big", "two"], T=f32),
             P.encode_node("y", "AddV2", ["x", "over"], T=f32),
             P.encode_const("ids", np.asarray([2 ** 40], np.int64))]
    sd = importTensorflowGraph(P.encode_graph_def(nodes), device="cpu")
    assert sorted(sd.import_report.codes()) == ["DL4J-E163", "DL4J-W163"]


def test_save_load_both_ways_between_the_packages(tmp_path):
    """TF-imported nodes serialize via rebuild='tf' (a MatMul's
    transpose_b survives); the zip either package writes loads in the
    other."""
    rng = np.random.RandomState(13)
    w = tf.constant(rng.randn(5, 5).astype(np.float32))
    gd, (i,), (o,) = _frozen(
        lambda x: tf.nn.softmax(tf.transpose(
            tf.matmul(x, w, transpose_b=True), [1, 0]), axis=-1),
        tf.TensorSpec([3, 5], tf.float32))
    x = rng.randn(3, 5).astype(np.float32)
    sd = importTensorflowGraph(gd.SerializeToString(), device="cpu")
    want = sd.output({i: x}, [o])[o].numpy()
    p = str(tmp_path / "port.sdz")
    sd.save(p)
    np.testing.assert_array_equal(
        SameDiff.load(p, device="cpu").output({i: x}, [o])[o].numpy(), want)
    np.testing.assert_allclose(np.asarray(JSameDiff.load(p).output(
        {i: x}, [o])[o]), want, rtol=1e-5, atol=1e-6)
    pj = str(tmp_path / "jax.sdz")
    jtf.importTensorflowGraph(gd).save(pj)
    np.testing.assert_allclose(SameDiff.load(pj, device="cpu").output(
        {i: x}, [o])[o].numpy(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fname", ["test_while_loop.npz",
                                   "test_lowered_while_imports.npz",
                                   "test_stateless_if_true.npz"])
def test_control_flow_roundtrips_through_save_load(fname, tmp_path):
    raw, feeds, outs, _ = _fixture(fname)
    sd = importTensorflowGraph(raw, device="cpu")
    want = sd.output(feeds, outs)
    p = str(tmp_path / "cf.sdz")
    sd.save(p)
    got = SameDiff.load(p, device="cpu").output(feeds, outs)
    for name in outs:
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy())


def test_unmapped_op_raises():
    gd, _, _ = _frozen(lambda x: tf.raw_ops.Where(condition=x > 0),
                       tf.TensorSpec([4], tf.float32))
    with pytest.raises(TFImportError, match="Where"):
        importTensorflowGraph(gd.SerializeToString(), device="cpu")


def test_v1_cond_rejected_with_guidance():
    gd, _, _ = _frozen(lambda x: tf.cond(tf.reduce_sum(x) > 0.0,
                                         lambda: x * 2.0, lambda: -x),
                       tf.TensorSpec([2, 2], tf.float32))
    with pytest.raises(TFImportError, match="lower_control_flow=False"):
        importTensorflowGraph(gd.SerializeToString(), device="cpu")


def _frozen_cnn():
    rng = np.random.RandomState(30)
    w1 = tf.Variable(rng.randn(3, 3, 1, 4).astype(np.float32) * 0.2,
                     name="w1")
    w2 = tf.Variable(rng.randn(64, 3).astype(np.float32) * 0.2, name="w2")

    def f(x):
        h = tf.nn.relu(tf.nn.conv2d(x, w1, strides=2, padding="SAME"))
        return tf.matmul(tf.reshape(h, [-1, 64]), w2)
    gd, (i,), (o,) = _frozen(f, tf.TensorSpec([None, 8, 8, 1], tf.float32))
    x = rng.randn(16, 8, 8, 1).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 16)]
    return gd, i, o, x, y


def _unfreeze_and_fit(sd, i, o, x, y, tc, updater, steps):
    weights = [n for n in list(sd._constants)
               if sd._constants[n].ndim >= 2 and not n.endswith("/resource")]
    assert len(weights) == 2
    sd.convertToVariables(*weights)
    labels = sd.placeHolder("labels", shape=(None, 3), dtype=np.float32)
    sd.loss.softmaxCrossEntropy(labels, sd.getVariable(o), name="loss")
    sd.setLossVariables("loss")
    sd.setTrainingConfig(tc(updater=updater, data_set_feature_mapping=[i],
                            data_set_label_mapping=["labels"]))
    return sd.fit({i: x, "labels": y}, epochs=steps).lossCurve()


def test_finetune_losses_match_jax_step_for_step():
    """JAX ``TestImportedGraphFinetune``: a frozen CNN imported,
    unfrozen (convertToVariables), a softmax cross-entropy attached and
    fit with DL4J's Adam; 10 steps in both packages from the same
    graph."""
    gd, i, o, x, y = _frozen_cnn()
    got = _unfreeze_and_fit(
        importTensorflowGraph(gd.SerializeToString(), device="cpu"),
        i, o, x, y, TrainingConfig, tupd.Adam(1e-2), 10)
    want = _unfreeze_and_fit(jtf.importTensorflowGraph(gd), i, o, x, y, JTC,
                             jupd.Adam(1e-2), 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    assert got[-1] < got[0] and np.isfinite(got).all()


def test_w162_frozen_weights_under_a_training_config():
    gd, i, o, _, _ = _frozen_cnn()
    sd = importTensorflowGraph(gd.SerializeToString(), device="cpu")
    assert timp.lint_frozen_constants(sd) == []
    sd.setTrainingConfig(TrainingConfig(updater=tupd.Adam(1e-2)))
    diags = timp.lint_frozen_constants(sd)
    assert [d.code for d in diags] == ["DL4J-W162"] * 2
    from deeplearning4j_tpu.analysis import imports as jimp
    jsd = jtf.importTensorflowGraph(gd)
    jsd.setTrainingConfig(JTC(updater=jupd.Adam(1e-2)))
    assert [d.location for d in diags] == \
        [d.location for d in jimp.lint_frozen_constants(jsd)]
    weights = [n for n in list(sd._constants) if sd._constants[n].ndim >= 2
               and not n.endswith("/resource")]
    sd.convertToVariables(*weights)
    assert timp.lint_frozen_constants(sd) == []


def test_depthwise_channel_multiplier_follows_tensorflow():
    """DepthwiseConv2dNative with a channel multiplier of 2: output
    channel c*M + m, as TF computes it. (The JAX importer orders them
    m*C + c, which agrees with TF only at M = 1; ROADMAP, reference-side
    findings.)"""
    rng = np.random.RandomState(0)
    w = tf.constant(rng.randn(3, 3, 2, 2).astype(np.float32))
    gd, (i,), (o,) = _frozen(
        lambda x: tf.nn.depthwise_conv2d(x, w, [1, 1, 1, 1], "SAME"),
        tf.TensorSpec([1, 5, 5, 2], tf.float32))
    x = rng.randn(1, 5, 5, 2).astype(np.float32)
    with tf.Graph().as_default() as graph:
        tf.compat.v1.import_graph_def(gd, name="")
        with tf.compat.v1.Session(graph=graph) as s:
            want = s.run(o + ":0", {i + ":0": x})
    got = importTensorflowGraph(gd.SerializeToString(), device="cpu").output(
        {i: x}, [o])[o].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
