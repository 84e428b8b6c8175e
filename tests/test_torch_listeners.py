"""Training listeners in the port (``train/listeners.py``, the networks'
``setListeners``/``addListeners``) against the JAX package's, on the
CPU.

The same fit in both packages (JAX weights through ``params_from_jax``)
with a recording listener, one step a dispatch and four: the sequence of
``onIterationStart``/``iterationDone``/``onEpochEnd`` calls with their
iteration and epoch numbers is the JAX package's exactly, and each
step's score within 1e-5 (fp32, rtol and atol). Then the stock
listeners: the score log, throughput, ETA, archives every N iterations
and epochs, evaluation, and the metrics bridge.
"""

import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import dataset as jdata
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch.data.dataset import (DataSet,
                                                   ListDataSetIterator)
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.profiler.metrics import get_registry
from deeplearning4j_tpu_torch.train import listeners as lst
from deeplearning4j_tpu_torch.train import updaters

torch.set_num_threads(2)

TOL = 1e-5
NB, B = 10, 4


def _mlp(Conf, M, It, upd):
    return (Conf.Builder().seed(1).updater(upd.Adam(0.01)).list()
            .layer(M.DenseLayer(nOut=8, activation="relu"))
            .layer(M.OutputLayer(nOut=3, lossFunction="mcxent",
                                 activation="softmax"))
            .setInputType(It.feedForward(5)).build())


def _graph(Conf, M, It, upd):
    b = Conf.Builder().seed(2).updater(upd.Adam(0.01)).graphBuilder()
    b.addInputs("in").setInputTypes(It.feedForward(5))
    b.addLayer("d", M.DenseLayer(nOut=8, activation="relu"), "in")
    b.addLayer("out", M.OutputLayer(nOut=3, lossFunction="mcxent",
                                    activation="softmax"), "d")
    b.setOutputs("out")
    return b.build()


def _pair(kind):
    if kind == "graph":
        j = JGraph(_graph(JConf, jlayers, JInputType, jupd))
        j.init()
        t = ComputationGraph(_graph(NeuralNetConfiguration, L, InputType,
                                    updaters))
    else:
        j = JMLN(_mlp(JConf, jlayers, JInputType, jupd))
        j.init()
        t = MultiLayerNetwork(_mlp(NeuralNetConfiguration, L, InputType,
                                   updaters))
    return j, t.params_from_jax(j._params, j._states, device="cpu")


def _arrays():
    rng = np.random.RandomState(0)
    return (rng.randn(NB * B, 5).astype(np.float32),
            np.eye(3, dtype=np.float32)[rng.randint(0, 3, NB * B)])


class Recorder:
    def __init__(self):
        self.calls = []
        self.scores = []

    def onIterationStart(self, model, iteration):
        self.calls.append(("start", iteration))

    def iterationDone(self, model, iteration, epoch):
        self.calls.append(("done", iteration, epoch))
        self.scores.append(float(np.asarray(model.score())))

    def onEpochEnd(self, model):
        self.calls.append(("epoch", model._epoch))


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("kind", ["mlp", "graph"])
def test_listener_calls_and_scores_match_jax(kind, k):
    j, t = _pair(kind)
    rj, rt = Recorder(), Recorder()
    j.setListeners(rj)
    t.setListeners(rt)
    x, y = _arrays()
    j.fit(jdata.ListDataSetIterator(jdata.DataSet(x, y), B), epochs=2,
          steps_per_dispatch=k)
    t.fit(ListDataSetIterator(DataSet(x, y), B), epochs=2,
          steps_per_dispatch=k)
    assert rt.calls == rj.calls
    assert len(rt.calls) == 2 * (2 * NB + 1)
    np.testing.assert_allclose(rt.scores, rj.scores, rtol=TOL, atol=TOL)
    assert t.getListeners() == [rt]


def test_add_listeners_and_the_stock_ones(tmp_path):
    out = []
    x, y = _arrays()
    net = MultiLayerNetwork(_mlp(NeuralNetConfiguration, L, InputType,
                                 updaters)).init(device="cpu")
    score = lst.ScoreIterationListener(3, out=out.append)
    perf = lst.PerformanceListener(5, out=out.append)
    eta = lst.TimeIterationListener(2 * NB, out=out.append)
    ckpt = lst.CheckpointListener(str(tmp_path), save_every_n_iterations=4,
                                  save_every_n_epochs=1, keep_last=2)
    ev = lst.EvaluativeListener(ListDataSetIterator(DataSet(x, y), 20), 10,
                                out=out.append)
    metrics = lst.MetricsListener()
    net.setListeners(score).addListeners(perf, eta, ckpt, ev, metrics)
    reg = get_registry()
    epochs0 = reg.counter("dl4j_train_epochs_total").value
    iters0 = reg.counter("dl4j_listener_iterations_total").value
    net.fit(ListDataSetIterator(DataSet(x, y), B), epochs=2,
            steps_per_dispatch=2)
    assert len(score.history) == 2 * NB and np.isfinite(score.history).all()
    assert [m for m in out if m.startswith("Score at iteration")] == [
        f"Score at iteration {i} is {score.history[i - 1]}"
        for i in range(3, 2 * NB + 1, 3)]
    assert perf.samples_per_sec > 0 and perf.batches_per_sec > 0
    assert any(m.startswith(f"iter {2 * NB}/{2 * NB}, ETA") for m in out)
    assert sorted(os.listdir(tmp_path)) == ["checkpoint_epoch_2.zip",
                                            "checkpoint_iter_20.zip"]
    back = MultiLayerNetwork.load(str(tmp_path / "checkpoint_iter_20.zip"),
                                  device="cpu")
    assert torch.equal(back.params(), net.params())
    assert ev.last_evaluation is not None and \
        sum(m.startswith("iter 20: accuracy=") for m in out) == 1
    assert reg.counter("dl4j_train_epochs_total").value - epochs0 == 2
    assert reg.counter("dl4j_listener_iterations_total").value - iters0 \
        == 2 * NB
    assert reg.gauge("dl4j_train_score").value == score.history[-1]
