"""The port's dropout: the op's semantics against the JAX op, the layers'
retain probability, and its own mask draws (CPU).

The JAX package draws masks from threefry keys, which torch cannot
reproduce; the port's masks are a counter-based hash of (seed, step
clock, layer, element) (``ops.normalization.dropout_mask``). So the op
is held to the JAX op on the same mask (exact: a select of ``x / keep``),
and the draws are held to what dropout needs: the keep rate (within 0.01
at 0.5 on 1.6M elements; five standard deviations are 0.002), the
``1 / keep`` scale, the identity outside training, new masks from step
to step, the same masks for the same (seed, step, layer), and the same
masks in K steps a dispatch as in K single steps and after a save and a
load (exact: the masks are the same bits, the arithmetic the same ops).
The graph's keys follow the JAX graph's splits (held with the JAX masks
injected).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.config import InputType as JIT
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JC
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.graph import MergeVertex as JMV
from deeplearning4j_tpu.ops import normalization as jnorm
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.nn import layers as tlayers
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph, MergeVertex
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import normalization as tnorm
from deeplearning4j_tpu_torch.train import updaters as tupd

torch.set_num_threads(2)

FC1 = (64, 25088)      # VGG16's first dropout: the flatten at B=64


def _mask(seed, t, layer, shape=FC1, keep=0.5):
    return tnorm.dropout_mask(tnorm.StepKey(seed, t).fold(layer), shape, keep,
                              "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_op_matches_jax_on_the_jax_mask(dtype, monkeypatch):
    key = jax.random.PRNGKey(7)
    x = np.random.default_rng(0).standard_normal((5, 33)).astype(np.float32)
    want = np.asarray(jnorm.dropout(jnp.asarray(x, dtype), 0.3, key)
                      .astype(jnp.float32))
    mask = np.asarray(jax.random.bernoulli(key, 0.7, x.shape))
    monkeypatch.setattr(tnorm, "dropout_mask",
                        lambda k, shape, keep, device: torch.from_numpy(mask))
    got = tnorm.dropout(torch.from_numpy(x).to(getattr(torch, dtype)), 0.3,
                        tnorm.StepKey(0, 0))
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("keep", [0.5, 0.8, 0.1])
def test_keep_rate_and_scale(keep):
    m = _mask(123, 3, 18, keep=keep)
    assert m.dtype == torch.bool and tuple(m.shape) == FC1
    assert abs(float(m.float().mean()) - keep) < 0.01
    x = torch.ones(FC1)
    y = tnorm.dropout(x, 1 - keep, tnorm.StepKey(123, 3).fold(18))
    assert set(torch.unique(y).tolist()) == {0.0, float(np.float32(1 / keep))}
    assert torch.equal(y != 0, m)


def test_identity_outside_training_and_at_rate_zero():
    x = torch.randn(4, 9)
    key = tnorm.StepKey(1, 0)
    assert tnorm.dropout(x, 0.5, key, train=False) is x
    assert tnorm.dropout(x, 0.0, key) is x


def test_masks_are_a_function_of_seed_step_and_layer_alone():
    a = _mask(123, 5, 18)
    assert torch.equal(a, _mask(123, 5, 18))
    assert torch.equal(a, _mask(123, torch.tensor(5, dtype=torch.int32), 18))
    for other in (_mask(123, 6, 18), _mask(123, 5, 19), _mask(124, 5, 18)):
        differ = float((a != other).float().mean())
        assert 0.49 < differ < 0.51          # independent: half differ
    # masks over the first few steps: each element kept about half the time
    steps = torch.stack([_mask(123, t, 18, (4096,)) for t in range(64)])
    assert abs(float(steps.float().mean()) - 0.5) < 0.01


def _net(drop=0.5, seed=11):
    return (NeuralNetConfiguration.Builder().seed(seed)
            .updater(tupd.Adam(1e-2)).list()
            .layer(tlayers.DenseLayer(nOut=16, activation="relu",
                                      dropOut=drop))
            .layer(tlayers.DropoutLayer(dropOut=0.7))
            .layer(tlayers.OutputLayer(nOut=3, lossFunction="mcxent",
                                       dropOut=0.9))
            .setInputType(InputType.feedForward(8)).build())


def _batches(n, seed=0):
    r = np.random.default_rng(seed)
    return [DataSet(r.standard_normal((6, 8)).astype(np.float32),
                    np.eye(3, dtype=np.float32)[r.integers(0, 3, 6)])
            for _ in range(n)]


def test_layers_take_the_retain_probability_on_their_input(monkeypatch):
    seen = []
    real = tnorm.dropout_mask

    def spy(key, shape, keep, device):
        seen.append((key.path, tuple(shape), keep))
        return real(key, shape, keep, device)
    monkeypatch.setattr(tnorm, "dropout_mask", spy)
    net = MultiLayerNetwork(_net()).init(device="cpu")
    net.fit(_batches(1))
    # the Dense layer's input [6, 8], the DropoutLayer's and the output
    # layer's [6, 16]; keep = dropOut
    assert seen == [((0,), (6, 8), 0.5), ((1,), (6, 16), 0.7),
                    ((2,), (6, 16), 0.9)]
    seen.clear()
    net.output(_batches(1)[0].features)
    assert seen == []                       # inference draws no mask
    # the dense layer's output is act((x * mask / keep) @ W + b)
    x = torch.randn(6, 8)
    key = tnorm.StepKey(11, 0).fold(0)
    layer = net.layers[0]
    got, _ = layer.apply(net._params[0], {}, x, True, key)
    m = real(key, (6, 8), 0.5, "cpu")
    want = torch.relu(torch.where(m, x / 0.5, 0.0) @ net._params[0]["W"]
                      + net._params[0]["b"])
    assert torch.equal(got, want)


def test_a_dispatch_of_k_steps_draws_what_k_steps_draw():
    data = _batches(8)
    a = MultiLayerNetwork(_net()).init(device="cpu")
    b = MultiLayerNetwork(_net()).init(device="cpu")
    a.fit(data)
    b.fit(data, steps_per_dispatch=4)
    for pa, pb in zip(a._params, b._params):
        for k in pa:
            assert torch.equal(pa[k], pb[k]), k
    assert a.score() == b.score()


def test_steps_draw_new_masks_and_a_loaded_net_the_same(tmp_path):
    data = _batches(4)
    a = MultiLayerNetwork(_net()).init(device="cpu")
    a.fit(data[:2])
    path = str(tmp_path / "m.zip")
    a.save(path)
    b = MultiLayerNetwork.load(path, device="cpu")
    assert b.getIterationCount() == 2
    a.fit(data[2:])
    b.fit(data[2:])
    for pa, pb in zip(a._params, b._params):
        for k in pa:
            assert torch.equal(pa[k], pb[k]), k
    # the same batch twice from one state: other masks, another loss
    c = MultiLayerNetwork(_net()).init(device="cpu")
    losses = []
    for _ in range(2):
        st = [{k: v.detach().clone() for k, v in p.items()}
              for p in c._params]
        c.fit(data[0])
        losses.append(c.score())
        with torch.no_grad():
            for p, s in zip(c._params, st):
                for k in p:
                    p[k].copy_(s[k])
    assert losses[0] != losses[1]


def _graph(conf, Lm, it, MV):
    return (conf.Builder().seed(21).graphBuilder().addInputs("in")
            .setInputTypes(it.feedForward(6))
            .addLayer("a", Lm.DenseLayer(nOut=5, activation="tanh",
                                         dropOut=0.5), "in")
            .addLayer("b", Lm.DenseLayer(nOut=4, activation="relu",
                                         dropOut=0.8), "in")
            .addVertex("m", MV(), "a", "b")
            .addLayer("out", Lm.OutputLayer(nOut=3, lossFunction="mcxent",
                                            dropOut=0.7), "m")
            .setOutputs("out").build())


def test_graph_layers_draw_the_jax_keys(monkeypatch):
    """The graph folds each layer node's ordinal in topological order
    (vertices take no key, as the JAX graph splits its key): with the
    JAX masks injected by those ordinals, loss and gradients match the
    JAX graph's at 2e-4 (the reference's gradient tolerance)."""
    j = JCG(_graph(JC, jlayers, JIT, JMV)).init()
    t = ComputationGraph(_graph(NeuralNetConfiguration, tlayers, InputType,
                                MergeVertex))
    t.params_from_jax(jax.tree_util.tree_map(np.asarray, j._params),
                      j._states, device="cpu")
    step = 3
    key = jax.random.fold_in(jax.random.PRNGKey(21), step)
    subs = []
    for _ in range(3):                       # a, b, out
        key, sub = jax.random.split(key)
        subs.append(sub)
    seen = []

    def jax_mask(k, shape, keep, device):
        seen.append((int(k.t), k.path, keep))
        return torch.from_numpy(np.array(
            jax.random.bernoulli(subs[k.path[0]], keep, tuple(shape))))
    monkeypatch.setattr(tnorm, "dropout_mask", jax_mask)
    r = np.random.default_rng(2)
    x = r.standard_normal((7, 6)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[r.integers(0, 3, 7)]

    def jloss(p):
        return j._loss_and_reg(p, j._states, {"in": jnp.asarray(x)},
                               [jnp.asarray(y)], True,
                               jax.random.fold_in(jax.random.PRNGKey(21),
                                                  step), None, None)[0]
    want, want_g = jax.value_and_grad(jloss)(j._params)
    loss, _ = t._loss_and_reg(t._params, t._states,
                              {"in": torch.from_numpy(x)},
                              [torch.from_numpy(y)], True, None,
                              tnorm.StepKey(21, torch.tensor(step)))
    assert sorted(seen) == [(3, (0,), 0.5), (3, (1,), 0.8), (3, (2,), 0.7)]
    names = [(n, k) for n in t._params for k in t._params[n]]
    grads = torch.autograd.grad(loss, [t._params[n][k] for n, k in names])
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=2e-4)
    for (n, k), g in zip(names, grads):
        ref = np.asarray(want_g[n][k])
        np.testing.assert_allclose(g.numpy(), ref, rtol=0,
                                   atol=2e-4 * float(np.abs(ref).max()),
                                   err_msg=f"{n}.{k}")
