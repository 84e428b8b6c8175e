"""The port's evaluation classes and the networks' ``evaluate`` against
the JAX package (CPU).

Every class gets the same numpy arrays in both packages, in the same
batches, and every metric, curve and string must be equal (exact: the
port's module is a numpy copy). The networks' ``evaluate`` holds the
same parameters in both packages and pulls predictions in chunks; its
accuracy and confusion matrix must be equal too (the forwards agree to
1e-5, and on these inputs no argmax lies that close to a tie)."""

import numpy as np
import pytest

import jax
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.data.dataset import \
    ListDataSetIterator as JListIterator
from deeplearning4j_tpu.evaluation import evaluation as jev
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu_torch.data.dataset import DataSet, ListDataSetIterator
from deeplearning4j_tpu_torch.evaluation import evaluation as tev
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn import layers as tlayers
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.network import predict_batches

torch.set_num_threads(2)


def _probs(rng, n, c):
    z = rng.standard_normal((n, c))
    e = np.exp(z - z.max(1, keepdims=True))
    return (e / e.sum(1, keepdims=True)).astype(np.float32)


def _onehot(rng, n, c):
    return np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]


def _batches(seed=0, n_batches=3, n=40, c=5):
    rng = np.random.default_rng(seed)
    return [(_onehot(rng, n, c), _probs(rng, n, c)) for _ in range(n_batches)]


def _both(name, *args, **kw):
    return getattr(jev, name)(*args, **kw), getattr(tev, name)(*args, **kw)


def test_evaluation_equals_jax():
    j, t = _both("Evaluation")
    rng = np.random.default_rng(9)
    for labels, preds in _batches():
        mask = (rng.random(len(labels)) > 0.2).astype(np.float32)
        j.eval(labels, preds, mask=mask)
        t.eval(labels, preds, mask=mask)
    np.testing.assert_array_equal(t.confusion.matrix, j.confusion.matrix)
    assert t.accuracy() == j.accuracy()
    for cls in (None, 0, 3):
        assert t.precision(cls) == j.precision(cls)
        assert t.recall(cls) == j.recall(cls)
        assert t.f1(cls) == j.f1(cls)
    for cls in range(5):
        assert t.falsePositiveRate(cls) == j.falsePositiveRate(cls)
        assert t.matthewsCorrelation(cls) == j.matthewsCorrelation(cls)
    assert t.stats() == j.stats()
    j2, t2 = _both("Evaluation")
    labels, preds = _batches(1, 1)[0]
    j2.eval(labels.argmax(1), preds)
    t2.eval(labels.argmax(1), preds)
    j.merge(j2)
    t.merge(t2)
    np.testing.assert_array_equal(t.confusion.matrix, j.confusion.matrix)
    assert t.confusion.getCount(1, 2) == j.confusion.getCount(1, 2)


def test_time_series_evaluation_equals_jax():
    rng = np.random.default_rng(3)
    labels = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (6, 7))]
    labels = labels.transpose(0, 2, 1)                      # [N, C, T]
    preds = rng.random((6, 4, 7)).astype(np.float32)
    mask = (rng.random((6, 7)) > 0.3).astype(np.float32)
    j, t = _both("Evaluation")
    j.eval(labels, preds, mask=mask)
    t.eval(labels, preds, mask=mask)
    np.testing.assert_array_equal(t.confusion.matrix, j.confusion.matrix)


def test_evaluation_binary_equals_jax():
    rng = np.random.default_rng(4)
    j, t = _both("EvaluationBinary", threshold=0.4)
    for _ in range(2):
        labels = (rng.random((30, 3)) > 0.5).astype(np.float32)
        preds = rng.random((30, 3)).astype(np.float32)
        mask = (rng.random((30, 3)) > 0.1).astype(np.float32)
        j.eval(labels, preds, mask=mask)
        t.eval(labels, preds, mask=mask)
    assert t.accuracy() == j.accuracy()
    for o in range(3):
        assert t.accuracy(o) == j.accuracy(o)
        assert t.precision(o) == j.precision(o)
        assert t.recall(o) == j.recall(o)
    j.merge(j)
    t.merge(t)
    assert t.accuracy() == j.accuracy()


@pytest.mark.parametrize("steps", [0, 100])
def test_roc_equals_jax(steps):
    rng = np.random.default_rng(5)
    j, t = _both("ROC", threshold_steps=steps)
    for _ in range(3):
        labels = (rng.random(50) > 0.6).astype(np.float32)
        preds = np.clip(labels * 0.3 + rng.random(50) * 0.7, 0, 1)
        j.eval(labels, preds)
        t.eval(labels, preds)
    assert t.calculateAUC() == j.calculateAUC()
    assert t.calculateAUCPR() == j.calculateAUCPR()
    for a, b in zip(t.getRocCurve(), j.getRocCurve()):
        np.testing.assert_array_equal(a, b)
    j2, t2 = _both("ROC", threshold_steps=steps)
    j2.eval(np.array([1.0, 0.0]), np.array([0.7, 0.2]))
    t2.eval(np.array([1.0, 0.0]), np.array([0.7, 0.2]))
    j.merge(j2)
    t.merge(t2)
    assert t.calculateAUC() == j.calculateAUC()


def test_roc_binary_and_multiclass_equal_jax():
    jb, tb = _both("ROCBinary")
    jm, tm = _both("ROCMultiClass")
    for labels, preds in _batches(7, 2, 30, 4):
        jb.eval(labels, preds)
        tb.eval(labels, preds)
        jm.eval(labels, preds)
        tm.eval(labels, preds)
    assert tb.numLabels() == jb.numLabels()
    assert tb.calculateAverageAUC() == jb.calculateAverageAUC()
    for c in range(4):
        assert tb.calculateAUC(c) == jb.calculateAUC(c)
        assert tm.calculateAUC(c) == jm.calculateAUC(c)
    jb.merge(jb)
    tb.merge(tb)
    assert tb.calculateAverageAUC() == jb.calculateAverageAUC()


def test_calibration_equals_jax():
    j, t = _both("EvaluationCalibration", reliability_bins=8,
                 histogram_bins=6)
    for labels, preds in _batches(8):
        j.eval(labels, preds)
        t.eval(labels, preds)
    for a, b in zip(t.getReliabilityInfo(), j.getReliabilityInfo()):
        np.testing.assert_array_equal(a, b)
    assert t.expectedCalibrationError() == j.expectedCalibrationError()
    for a, b in zip(t.getResidualPlot(), j.getResidualPlot()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(t.getProbabilityHistogram(2),
                    j.getProbabilityHistogram(2)):
        np.testing.assert_array_equal(a, b)
    j.merge(j)
    t.merge(t)
    assert t.expectedCalibrationError() == j.expectedCalibrationError()


def test_regression_evaluation_equals_jax():
    rng = np.random.default_rng(10)
    j, t = _both("RegressionEvaluation")
    for _ in range(3):
        labels = rng.standard_normal((20, 3)).astype(np.float32)
        preds = (labels + 0.3 * rng.standard_normal((20, 3))).astype(
            np.float32)
        mask = (rng.random(20) > 0.2).astype(np.float32)
        j.eval(labels, preds, mask=mask)
        t.eval(labels, preds, mask=mask)
    for col in range(3):
        for m in ("meanSquaredError", "meanAbsoluteError",
                  "rootMeanSquaredError", "pearsonCorrelation", "rSquared"):
            assert getattr(t, m)(col) == getattr(j, m)(col), (m, col)
    assert t.stats() == j.stats()
    j.merge(j)
    t.merge(t)
    assert t.stats() == j.stats()


# ------------------------------------------------- the networks' evaluate
def _pair_lenet():
    j = jzoo.LeNet(num_classes=10).init()
    t = zoo.LeNet(num_classes=10).conf_builder()
    t.params_from_jax(jax.tree_util.tree_map(np.asarray, j._params),
                      j._states, device="cpu")
    return j, t


def _digits(n=70, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 784), dtype=np.float32),
            np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)])


@pytest.mark.parametrize("chunk", [1, 64])
def test_network_evaluate_equals_jax(chunk):
    j, t = _pair_lenet()
    x, y = _digits()
    want = j.evaluate(JListIterator(JDataSet(x, y), 16), prefetch=False)
    got = t.evaluate(ListDataSetIterator(DataSet(x, y), 16),
                     pull_chunk=chunk)
    np.testing.assert_array_equal(got.confusion.matrix,
                                  want.confusion.matrix)
    assert got.accuracy() == want.accuracy()
    reg = t.evaluateRegression([DataSet(x, y)])
    jreg = j.evaluateRegression([JDataSet(x, y)], prefetch=False)
    np.testing.assert_allclose(reg.meanSquaredError(3),
                               jreg.meanSquaredError(3), rtol=1e-5)


def test_predictions_are_pulled_a_chunk_at_a_time(monkeypatch):
    """A chunk of batches is dispatched before one gathered copy to the
    host; each batch's predictions come back with its labels and mask,
    in order."""
    x, y = _digits(10)
    batches = DataSet(x, y).batchBy(3)            # 3, 3, 3, 1 rows
    events = []
    cat = torch.cat

    def spy_cat(tensors, *a, **kw):
        events.append(f"pull {len(tensors)}")
        return cat(tensors, *a, **kw)
    monkeypatch.setattr(torch, "cat", spy_cat)

    def output(f):
        events.append("forward")
        return torch.from_numpy(np.asarray(f)[:, :2] * 2)
    got = list(predict_batches(output, batches, chunk=2))
    assert events == ["forward", "forward", "pull 2", "forward", "forward",
                      "pull 2"]
    assert [p.shape for _, p, _ in got] == [(3, 2), (3, 2), (3, 2), (1, 2)]
    for (labels, preds, mask), b in zip(got, batches):
        np.testing.assert_array_equal(labels, b.labels)
        np.testing.assert_array_equal(preds, b.features[:, :2] * 2)
        assert mask is None


def _graph(conf, Lm, it):
    return (conf.Builder().seed(3).graphBuilder().addInputs("in")
            .setInputTypes(it.feedForward(6))
            .addLayer("h", Lm.DenseLayer(nOut=8, activation="tanh"), "in")
            .addLayer("out", Lm.OutputLayer(nOut=3, lossFunction="mcxent"),
                      "h")
            .setOutputs("out").build())


def test_graph_evaluate_equals_jax():
    j = JCG(_graph(JConf, jlayers, JInputType)).init()
    t = ComputationGraph(_graph(NeuralNetConfiguration, tlayers, InputType))
    t.params_from_jax(jax.tree_util.tree_map(np.asarray, j._params),
                      j._states, device="cpu")
    rng = np.random.default_rng(1)
    data = [(rng.standard_normal((9, 6)).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.integers(0, 3, 9)])
            for _ in range(3)]
    want = j.evaluate([JDataSet(x, y) for x, y in data], prefetch=False)
    got = t.evaluate([DataSet(x, y) for x, y in data])
    np.testing.assert_array_equal(got.confusion.matrix,
                                  want.confusion.matrix)
