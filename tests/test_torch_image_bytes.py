"""uint8 image bytes into the port's ComputationGraph against the JAX
package's (CPU): the graph casts uint8 inputs on the device, to fp32
without a compute dtype (JAX nn/graph.py:474-476) and to the policy's
dtype at the first layer under the bf16 policy (``layers.policy_cast``).

A small conv graph (conv-BN-relu, a second conv, global average pool,
softmax output) on uint8 [N, 3, 8, 8] pixels in [0, 16), its weights
transplanted from the JAX init.

Tolerances (tests/test_torch_graph.py's): fp32 ``output()`` 1e-5; after
one Adam step params, BN statistics and score 2e-4, but the bias of the
conv that feeds the train-mode BN: its gradient is zero in exact
arithmetic, and Adam turns either package's rounding noise into a step of
up to the learning rate, so it is held within 2 x lr
(tests/test_torch_multilayer.py's bound). Under the bf16 policy
``output()`` within 2e-2 (a few bf16 ulps of probabilities: the packages
round at other places) and the loss of each of 3 steps within 10% of the
JAX one's (tests/test_torch_graph.py's bf16 bound).
"""

import numpy as np
import pytest

import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import graph as jgraph
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.nn import graph as tgraph
from deeplearning4j_tpu_torch.nn import layers as tlayers
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.train import updaters as tupd

torch.set_num_threads(2)

OUT_TOL = 1e-5
FIT_TOL = 2e-4
LR = 1e-2
BF16_OUT_TOL = 2e-2
BF16_LOSS_BOUND = 0.10
N_CLASSES = 3


def conv_graph(Conf, G, Lm, It, upd):
    """conv(3x3, 4)-BN-relu, conv(3x3, 6, relu), global average pool,
    softmax OutputLayer, on 3x8x8 input."""
    g = (Conf.Builder().seed(11).weightInit("relu").updater(upd.Adam(LR))
         .graphBuilder().addInputs("in")
         .setInputTypes(It.convolutional(8, 8, 3)))
    g.addLayer("c1", Lm.ConvolutionLayer(kernelSize=(3, 3), padding=(1, 1),
                                         nOut=4, activation="identity"), "in")
    g.addLayer("bn1", Lm.BatchNormalization(), "c1")
    g.addLayer("r1", Lm.ActivationLayer("relu"), "bn1")
    g.addLayer("c2", Lm.ConvolutionLayer(kernelSize=(3, 3), nOut=6,
                                         activation="relu"), "r1")
    g.addLayer("gap", Lm.GlobalPoolingLayer("avg"), "c2")
    g.addLayer("out", Lm.OutputLayer(nOut=N_CLASSES, lossFunction="mcxent",
                                     activation="softmax"), "gap")
    g.setOutputs("out")
    return G.ComputationGraph(g.build())


def conv_pair(bf16=False):
    """(JAX graph, port graph on the CPU) from the JAX init."""
    j = conv_graph(JConf, jgraph, jlayers, JInputType, jupd).init()
    t = conv_graph(NeuralNetConfiguration, tgraph, tlayers, InputType, tupd)
    t.params_from_jax(j._params, j._states, device="cpu")
    if bf16:
        for net in (j, t):
            net.setPrecisionPolicy("bf16")
    return j, t


def image_bytes(seed=0, n=4):
    r = np.random.default_rng(seed)
    x = r.integers(0, 16, (n, 3, 8, 8), dtype=np.uint8)
    y = np.eye(N_CLASSES, dtype=np.float32)[r.integers(0, N_CLASSES, n)]
    return x, y


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol, err_msg=what)


def test_fp32_graph_casts_uint8_as_jax_does():
    j, t = conv_pair()
    x, y = image_bytes()
    got = t.output(x)
    assert got.dtype == torch.float32
    _close(got.numpy(), np.asarray(j.output(x)), OUT_TOL, "output")
    # the bytes give what their fp32 values give
    assert torch.equal(got, t.output(x.astype(np.float32)))
    j.fit(JDataSet(x, y))
    t.fit(DataSet(x, y))
    _close(t.score(), float(j.score()), FIT_TOL, "score")
    for node, p in j._params.items():
        for k, v in p.items():
            tol = 2 * LR if (node, k) == ("c1", "b") else FIT_TOL
            _close(t._params[node][k].detach().numpy(), np.asarray(v),
                   tol, f"{node}.{k}")
    for node, s in j._states.items():
        for k, v in s.items():
            _close(t._states[node][k].numpy(), np.asarray(v), FIT_TOL,
                   f"{node}.{k}")


def test_bf16_graph_casts_uint8_as_jax_does():
    j, t = conv_pair(bf16=True)
    x, y = image_bytes(1)
    got = t.output(x)
    assert got.dtype == torch.float32
    _close(got.numpy(), np.asarray(j.output(x)), BF16_OUT_TOL, "output")
    for step in range(3):
        j.fit(JDataSet(x, y))
        t.fit(DataSet(x, y))
        lj, lt = float(j.score()), t.score()
        assert np.isfinite(lt)
        assert abs(lt - lj) <= BF16_LOSS_BOUND * abs(lj), (step, lt, lj)


@pytest.mark.parametrize("bf16", [False, True])
def test_uint8_megasteps_equal_single_steps(bf16):
    """K=2 steps a dispatch on uint8 bytes equal two single steps, on the
    prefetcher's path and on the synchronous one."""
    _, a = conv_pair(bf16)
    _, b = conv_pair(bf16)
    _, c = conv_pair(bf16)
    data = [DataSet(*image_bytes(s)) for s in (2, 3)]
    a.fit(data, steps_per_dispatch=2)
    b.fit(data, steps_per_dispatch=2, prefetch=0)
    for ds in data:
        c.fit(ds)
    for net in (a, b):
        assert net.getIterationCount() == 2
        for p, q in zip(net._dispatch_state(), c._dispatch_state()):
            assert torch.equal(p, q)
