"""Dynamic loss scaling in the port (``nn/precision.py``, the networks'
dynamic step) against the JAX package's, on the CPU.

- The grow/backoff automaton over a scripted ok/overflow sequence, and
  the all-finite test over gradient lists: exactly the JAX values.
- One fit of a tiny MultiLayerNetwork, of a tiny ComputationGraph (with
  a BatchNormalization, whose running statistics must be dropped too)
  and of a TBPTT LSTM network, each on batches one of which carries
  labels of 1e33 (the cross-entropy clips its probabilities, so huge
  features would not overflow), so the scaled loss and its gradients
  overflow: after
  that step the params, updater state and layer states are the ones
  before it, the scale has halved and the good-step count restarted, the
  reported loss is infinite, all as in the JAX net; every other step
  within 1e-5 (fp32, rtol and atol) of the JAX net, the scale state
  equal.
- A policy of another signature restarts the scale; an equal one keeps
  the step cache; ``PrecisionPolicy(loss_scale="dynamic")`` validates
  and crosses as config.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.data import dataset as jdata
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.nn.multilayer import (_dynamic_scale_next,
                                              _grads_all_finite)
from deeplearning4j_tpu.nn.precision import PrecisionPolicy as JPolicy
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.nn import layers as tlayers
from deeplearning4j_tpu_torch.nn import precision
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.precision import PrecisionPolicy
from deeplearning4j_tpu_torch.train import updaters as tupd

torch.set_num_threads(2)

TOL = 1e-5
POLICY = dict(compute="float32", loss_scale="dynamic",
              loss_scale_init=2.0 ** 20, growth_interval=2)


def test_the_automaton_follows_the_jax_rule():
    kw = dict(loss_scale_init=2.0 ** 10, growth_interval=3,
              max_loss_scale=2.0 ** 12, min_loss_scale=0.25)
    ours = PrecisionPolicy("fp16", loss_scale="dynamic", **kw)
    theirs = JPolicy("fp16", loss_scale="dynamic", **kw)
    rng = np.random.default_rng(0)
    flags = [bool(v) for v in rng.random(60) < 0.7] + [False] * 20 \
        + [True] * 48
    s = torch.tensor([ours.loss_scale_init, 0.0])
    js = jnp.asarray([theirs.loss_scale_init, 0.0], jnp.float32)
    seen = set()
    for ok in flags:
        s = precision.dynamic_scale_next(ours, s, torch.tensor(ok))
        js = _dynamic_scale_next(theirs, js, jnp.asarray(ok))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
        seen.add(float(s[0]))
    # it grew to the cap and backed off to the floor
    assert {0.25, 2.0 ** 12} <= seen


@pytest.mark.parametrize("case", ["finite", "nan", "inf", "-inf", "bf16"])
def test_all_finite_matches_jax(case):
    rng = np.random.default_rng(1)
    gs = [rng.standard_normal(s).astype(np.float32) for s in
          ((3, 4), (5,), (2, 2, 2))]
    if case in ("nan", "inf", "-inf"):
        gs[1][3] = float(case)
    ours = [torch.from_numpy(g) for g in gs]
    theirs = [jnp.asarray(g) for g in gs]
    if case == "bf16":
        ours = [g.bfloat16() for g in ours]
        theirs = [g.astype(jnp.bfloat16) for g in theirs]
    got = precision.grads_all_finite(ours)
    assert got.dtype == torch.bool and got.dim() == 0
    assert bool(got) == bool(_grads_all_finite(theirs))


def test_the_policy_validates_and_crosses_as_config():
    p = PrecisionPolicy("fp16", loss_scale="Dynamic", growth_interval=7)
    assert p.is_dynamic and p.loss_scale == "dynamic"
    assert JPolicy.from_config(p.to_config()) == JPolicy(
        "fp16", loss_scale="dynamic", growth_interval=7)
    assert PrecisionPolicy.from_config(
        JPolicy("fp16", loss_scale="dynamic").to_config()) == \
        PrecisionPolicy("fp16", loss_scale="dynamic")
    for bad in (dict(loss_scale="static"), dict(loss_scale="dynamic",
                                                growth_factor=1.0),
                dict(loss_scale="dynamic", backoff_factor=1.5)):
        with pytest.raises(ValueError):
            PrecisionPolicy("fp16", **bad)
    assert PrecisionPolicy(loss_scale=2.0).signature() == \
        ("float32", "float32", 2.0)


# ------------------------------------------------------------- the nets
def _mln_conf(Conf, M, It, upd):
    return (Conf.Builder().seed(3).updater(upd.Adam(1e-2)).list()
            .layer(M.DenseLayer(nOut=8, activation="relu"))
            .layer(M.DenseLayer(nOut=8, activation="relu"))
            .layer(M.OutputLayer(nOut=3, lossFunction="mcxent",
                                 activation="softmax"))
            .setInputType(It.feedForward(4)).build())


def _graph_conf(Conf, M, It, upd):
    b = (Conf.Builder().seed(4).updater(upd.Adam(1e-2)).graphBuilder())
    b.addInputs("in").setInputTypes(It.feedForward(4))
    b.addLayer("d1", M.DenseLayer(nOut=8, activation="relu"), "in")
    b.addLayer("bn", M.BatchNormalization(), "d1")
    b.addLayer("out", M.OutputLayer(nOut=3, lossFunction="mcxent",
                                    activation="softmax"), "bn")
    b.setOutputs("out")
    return b.build()


def _lstm_conf(Conf, M, It, upd):
    return (Conf.Builder().seed(5).updater(upd.Adam(1e-2)).list()
            .layer(M.LSTM(nOut=6))
            .layer(M.RnnOutputLayer(nOut=4, lossFunction="mcxent",
                                    activation="softmax"))
            .setInputType(It.recurrent(4, 8))
            .backpropType("tbptt", 4).build())


def _pair(kind):
    if kind == "graph":
        j = JGraph(_graph_conf(JConf, jlayers, JInputType, jupd))
        j.init()
        t = ComputationGraph(_graph_conf(NeuralNetConfiguration, tlayers,
                                         InputType, tupd))
    else:
        conf = _lstm_conf if kind == "tbptt" else _mln_conf
        j = JMLN(conf(JConf, jlayers, JInputType, jupd))
        j.init()
        t = MultiLayerNetwork(conf(NeuralNetConfiguration, tlayers,
                                   InputType, tupd))
    t.params_from_jax(j._params, j._states, device="cpu")
    j.setPrecisionPolicy(JPolicy(**POLICY))
    t.setPrecisionPolicy(PrecisionPolicy(**POLICY))
    return j, t


def _batches(kind, n=5, overflow_at=1):
    rng = np.random.default_rng(7)
    out = []
    for i in range(n):
        if kind == "tbptt":
            x = rng.standard_normal((3, 4, 8)).astype(np.float32)
            y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, (3, 8))]
            y = y.transpose(0, 2, 1).copy()
        else:
            x = rng.standard_normal((6, 4)).astype(np.float32)
            y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 6)]
        if i == overflow_at:
            y = y * np.float32(1e33)
        out.append((x, y))
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [v for t in tree for v in _leaves(t)]
    return [np.asarray(tree)]


def _state(net):
    """Params, layer states and updater state as host arrays, in the
    JAX pytree order (sorted keys)."""
    if isinstance(net, (JMLN, JGraph)):
        return _leaves([net._params, net._states, net._opt_state])

    def conv(tree):
        if isinstance(tree, torch.Tensor):
            return tree.detach().numpy()
        if isinstance(tree, dict):
            return {k: conv(v) for k, v in tree.items()}
        return [conv(v) for v in tree]
    return _leaves([conv(net._params), conv(net._states),
                    conv(net._opt_state)])


@pytest.mark.parametrize("kind", ["mln", "graph", "tbptt"])
def test_an_overflowing_step_is_dropped_as_in_jax(kind):
    j, t = _pair(kind)
    batches = _batches(kind)
    for i, (x, y) in enumerate(batches):
        before = _state(t) if t._opt_state is not None else None
        if kind == "tbptt":
            j.fit(jdata.DataSet(x, y))
            t.fit(DataSet(x, y))
            # the JAX window step's loss is the last window's
        else:
            j.fit(jdata.DataSet(x, y))
            t.fit(DataSet(x, y))
        js = np.asarray(j._scale_state)
        np.testing.assert_array_equal(t._scale_state.numpy(), js)
        ours, theirs = _state(t), _state(j)
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)
        if i == 1:
            # the overflow: every update dropped, the scale halved
            assert js.tolist() == [POLICY["loss_scale_init"] / 2, 0.0]
            for a, b in zip(ours, before):
                np.testing.assert_array_equal(a, b)
            if kind != "tbptt":
                assert not np.isfinite(t.score())
                assert not np.isfinite(float(j.score()))
        else:
            assert np.isfinite(t.score())
    assert t.current_loss_scale() == float(np.asarray(j._scale_state)[0])


def test_another_policy_restarts_the_scale_and_an_equal_one_keeps_the_step():
    _, t = _pair("mln")
    t.fit(DataSet(*_batches("mln")[0]))
    assert t._scale_state is not None and t._step_cache
    key = list(t._step_cache)
    t.setPrecisionPolicy(PrecisionPolicy(**POLICY))
    assert list(t._step_cache) == key and t._scale_state is not None
    t.setPrecisionPolicy(dict(POLICY, growth_interval=5))
    assert not t._step_cache and t._scale_state is None
    assert t.current_loss_scale() == POLICY["loss_scale_init"]
    t.fit(DataSet(*_batches("mln")[0]), precision="bf16")
    assert t._scale_state is None and t.current_loss_scale() is None
