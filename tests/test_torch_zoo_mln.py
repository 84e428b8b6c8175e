"""The port's zoo MultiLayerNetworks (LeNet, a narrowed VGG16, SimpleCNN,
Darknet19) against the JAX zoo nets (CPU).

Each pair holds the same parameters (one JAX init, transplanted with
``params_from_jax``). The narrowed VGG16 is the zoo's own ``_vgg_blocks``
plan at widths 4-16 with two ``DenseLayer(32, dropOut=0.5)`` and a 32x32
input; the others are the zoo's configurations at 32x32 (LeNet at its
28x28 flat rows). With dropout active, the JAX step's masks (its key
``fold_in(PRNGKey(seed), t)`` split once a layer) are rebuilt here and
handed to the port by replacing its ``ops.normalization.dropout_mask``.

Tolerances (the reference's, tests/test_pallas.py): fp32 forward 1e-5;
the loss, gradients and one Adam step 2e-4: gradients within 2e-4 of
each tensor's largest, the first moments within 2e-4 of theirs, the
params within 2e-4 but where the two gradients differ by a tenth of the
reference's or more (Adam's first step is about ``lr * sign(g)`` there,
as tests/test_torch_multilayer.py explains; those are held to ``2 * lr``).
bf16 / NHWC / fused forwards: relative L2 4e-3 (one bf16 rounding, as
the TinyYOLO test).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.data.iterators import MnistDataSetIterator
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn import layers as tlayers
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import normalization as tnorm
from deeplearning4j_tpu_torch.train import updaters as tupd

torch.set_num_threads(2)

FWD_TOL = 1e-5
FIT_TOL = 2e-4
LR = 1e-3
BF16_REL_L2 = 4e-3
HW = 32
N_CLASSES = 10
SEED = 123
VGG_PLAN = [(2, 4), (2, 8), (3, 8), (3, 16), (3, 16)]


def _vgg_small(zoo_mod, conf, Lm, it, updater):
    b = (conf.Builder().seed(SEED).updater(updater).weightInit("relu")
         .list())
    b = zoo_mod._vgg_blocks(b, VGG_PLAN)
    return (b.layer(Lm.DenseLayer(nOut=32, activation="relu", dropOut=0.5))
            .layer(Lm.DenseLayer(nOut=32, activation="relu", dropOut=0.5))
            .layer(Lm.OutputLayer(nOut=N_CLASSES, lossFunction="mcxent",
                                  activation="softmax"))
            .setInputType(it.convolutional(HW, HW, 3)).build())


def _build(name):
    """(JAX net initialized, port net holding its params on the CPU)."""
    if name == "vgg_small":
        j = JMLN(_vgg_small(jzoo, JConf, jlayers, JInputType,
                            jupd.Adam(LR))).init()
        t = MultiLayerNetwork(_vgg_small(zoo, NeuralNetConfiguration,
                                         tlayers, InputType, tupd.Adam(LR)))
    else:
        kw = {} if name == "LeNet" else {"input_shape": (3, HW, HW)}
        j = getattr(jzoo, name)(num_classes=N_CLASSES, **kw).init()
        t = getattr(zoo, name)(num_classes=N_CLASSES, **kw).conf_builder()
    t.params_from_jax(jax.tree_util.tree_map(np.asarray, j._params),
                      jax.tree_util.tree_map(np.asarray, j._states),
                      device="cpu")
    return j, t


def _data(name, seed=0, n=4):
    """Pixel-like [0, 1) rows for LeNet, zero-mean images for the rest:
    a train-mode BN's variance is ``E[x^2] - E[x]^2`` in fp32 in both
    packages, which on uncentered, nearly constant channels loses most of
    its digits, each package's differently (measured on SimpleCNN with
    [0, 1) inputs: gradients 5-25% apart below the 4x4 BN, the loss
    within 1e-6)."""
    r = np.random.default_rng(seed)
    if name == "LeNet":
        x = r.random((n, 784), dtype=np.float32)
    else:
        x = r.standard_normal((n, 3, HW, HW)).astype(np.float32)
    y = np.eye(N_CLASSES, dtype=np.float32)[r.integers(0, N_CLASSES, n)]
    return x, y


def jax_subkeys(seed: int, t: int, n_layers: int):
    """The JAX step's per-layer keys: ``fold_in(PRNGKey(seed), t)`` split
    once a layer, in order (JAX multilayer.py:300-330, :492)."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), t)
    subs = []
    for _ in range(n_layers):
        key, sub = jax.random.split(key)
        subs.append(sub)
    return subs


def inject_jax_masks(monkeypatch, seed, n_layers):
    """Replace the port's mask draw with the JAX step's masks; returns the
    list of ``(t, layer)`` each draw was asked for."""
    calls = []

    def jax_mask(key, shape, keep, device):
        t, (layer,) = int(key.t), key.path
        calls.append((t, layer))
        sub = jax_subkeys(seed, t, n_layers)[layer]
        return torch.from_numpy(np.array(
            jax.random.bernoulli(sub, keep, tuple(shape)))).to(device)
    monkeypatch.setattr(tnorm, "dropout_mask", jax_mask)
    return calls


def _zero_in_exact_arithmetic(net):
    """The conv biases that feed a train-mode BN: their gradient is 0 in
    exact arithmetic (the bias cancels against the batch mean) and each
    package's rounding noise otherwise; they are held to be ~0 beside
    their layer's weight gradient, not to each other."""
    return {(i, "b") for i, a in enumerate(net.layers[:-1])
            if type(a) is tlayers.ConvolutionLayer
            and isinstance(net.layers[i + 1], tlayers.BatchNormalization)}


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


MODELS = ["LeNet", "vgg_small", "SimpleCNN", "Darknet19"]
#: Darknet19 at 32x32 ends in 1x1 maps: its last BNs normalize over the
#: batch's 4 values a channel, where ``E[x^2] - E[x]^2`` leaves each
#: package a different handful of digits (measured: first-conv gradients
#: 5% apart, the loss within 1e-6). Its train path is SimpleCNN's layers
#: with a leaky slope, held below and in tests/test_torch_multilayer.py.
TRAINED = ["LeNet", "vgg_small", "SimpleCNN"]


_INITS = {}


def _init(name):
    """Each model's JAX init, once a module."""
    if name not in _INITS:
        _INITS[name] = _build(name)
    return name, _INITS[name]


@pytest.fixture(params=MODELS)
def pair_init(request):
    return _init(request.param)


@pytest.fixture(params=TRAINED)
def trained_init(request):
    return _init(request.param)


def _fresh(pair_init):
    name, (j, t) = pair_init
    params = jax.tree_util.tree_map(np.asarray, j._params)
    states = jax.tree_util.tree_map(np.asarray, j._states)
    j2 = JMLN(j.conf)
    j2._params = jax.tree_util.tree_map(jnp.asarray, params)
    j2._states = jax.tree_util.tree_map(jnp.asarray, states)
    j2._initialized = True
    t2 = MultiLayerNetwork(t.conf).params_from_jax(params, states,
                                                   device="cpu")
    return name, j2, t2


class TestForward:
    def test_builds_as_the_reference(self, pair_init):
        name, (j, t) = pair_init
        assert [type(a).__name__ for a in t.layers] == \
            [type(a).__name__ for a in j.layers]
        assert [(a.nIn, a.nOut) for a in t.layers] == \
            [(a.nIn, a.nOut) for a in j.layers]
        assert [a.dropout for a in t.layers] == [a.dropout for a in j.layers]
        assert {i: type(p).__name__ for i, p in t.conf.preprocessors.items()} \
            == {i: type(p).__name__ for i, p in j.conf.preprocessors.items()}
        assert t.numParams() == j.numParams()
        np.testing.assert_array_equal(t.params().numpy(),
                                      np.asarray(j.params()))

    def test_fp32_output_matches_jax(self, pair_init):
        name, j, t = _fresh(pair_init)
        x, _ = _data(name, 1)
        got = t.output(x)
        assert got.shape == (4, N_CLASSES)
        np.testing.assert_allclose(got.numpy(), np.asarray(j.output(x)),
                                   rtol=FWD_TOL, atol=FWD_TOL)

    @pytest.mark.parametrize("name", ["SimpleCNN", "Darknet19"])
    def test_bf16_nhwc_fused_output_matches_jax(self, name):
        j, t = _build(name)
        for net in (j, t):
            net.setPrecisionPolicy("bf16")
            net.setComputeLayout("NHWC")
            net.setEpilogueFusion(True)
        assert t._ensure_epilogue_plan() == j._ensure_epilogue_plan()
        x, _ = _data(name, 2)
        ck.install_platform_overrides()
        try:
            ck.reset_counts()
            got = t.output(x)
            assert ck.PLAIN_CALLS["scale_shift_act"] == \
                {"SimpleCNN": 6, "Darknet19": 18}[name]
        finally:
            ck.uninstall_platform_overrides()
        want = np.asarray(j.output(x)).astype(np.float32)
        assert _rel_l2(got.numpy(), want) < BF16_REL_L2


class TestTraining:
    def test_loss_and_gradients_match_jax_with_dropout(self, trained_init,
                                                       monkeypatch):
        name, j, t = _fresh(trained_init)
        n = len(t.layers)
        calls = inject_jax_masks(monkeypatch, SEED, n)
        x, y = _data(name, 3)
        key_j = jax.random.fold_in(jax.random.PRNGKey(SEED), 5)

        def jloss(p):
            return j._loss_and_reg(p, j._states, jnp.asarray(x),
                                   jnp.asarray(y), True, key_j, None, None)[0]
        want_loss, want_g = jax.value_and_grad(jloss)(j._params)
        loss, _ = t._loss_and_reg(t._params, t._states, torch.from_numpy(x),
                                  torch.from_numpy(y), True, None,
                                  tnorm.StepKey(SEED, torch.tensor(5)))
        names = [(i, k) for i, p in enumerate(t._params) for k in p]
        grads = torch.autograd.grad(loss, [t._params[i][k] for i, k in names],
                                    allow_unused=True)
        dropped = [i for i, a in enumerate(t.layers) if a.dropout]
        assert sorted(calls) == [(5, i) for i in dropped]
        np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                                   rtol=FIT_TOL)
        zero = _zero_in_exact_arithmetic(t)
        for (i, k), g in zip(names, grads):
            ref = np.asarray(want_g[i][k])
            got = np.zeros_like(ref) if g is None else g.numpy()
            if (i, k) in zero:
                scale = FIT_TOL * float(np.abs(want_g[i]["W"]).max())
                assert np.abs(got).max() <= scale >= np.abs(ref).max(), (i, k)
                continue
            bound = FIT_TOL * max(float(np.abs(ref).max()), 1e-30)
            np.testing.assert_allclose(got, ref, rtol=0, atol=bound,
                                       err_msg=f"{name} layer {i} {k}")

    def test_one_adam_step_matches_jax_with_dropout(self, trained_init,
                                                    monkeypatch):
        name, j, t = _fresh(trained_init)
        inject_jax_masks(monkeypatch, SEED, len(t.layers))
        x, y = _data(name, 4)
        j.fit(JDataSet(x, y))
        t.fit(DataSet(x, y))
        np.testing.assert_allclose(t.score(), j.score(), rtol=FIT_TOL)
        zero = _zero_in_exact_arithmetic(t)
        for i, (pj, pt) in enumerate(zip(j._params, t._params)):
            for k, v in pj.items():
                m_ref = np.asarray(j._opt_state[i][k]["m"])
                m_got = t._opt_state[i][k]["m"].numpy()
                if (i, k) in zero:
                    scale = FIT_TOL * float(np.abs(np.asarray(
                        j._opt_state[i]["W"]["m"])).max())
                    assert np.abs(m_got).max() <= scale >= \
                        np.abs(m_ref).max(), (i, k)
                else:
                    bound = FIT_TOL * max(float(np.abs(m_ref).max()), 1e-30)
                    np.testing.assert_allclose(
                        m_got, m_ref, rtol=0, atol=bound,
                        err_msg=f"layer {i} {k} moment")
                want = np.asarray(v)
                err = np.abs(pt[k].detach().numpy() - want)
                near0 = np.abs(m_ref) <= 10 * np.abs(m_got - m_ref)
                bad = (err > FIT_TOL + FIT_TOL * np.abs(want)) & ~near0
                assert not bad.any(), (i, k, int(bad.sum()))
                assert (err[near0] <= 2 * LR + FIT_TOL).all(), (i, k)
            for k, v in j._states[i].items():
                np.testing.assert_allclose(t._states[i][k].numpy(),
                                           np.asarray(v), rtol=FIT_TOL,
                                           atol=FIT_TOL)


class TestDarknet19:
    def test_fused_fit_takes_18_epilogues_a_step(self):
        net = zoo.Darknet19(num_classes=N_CLASSES,
                            input_shape=(3, HW, HW)).init(device="cpu")
        net.setPrecisionPolicy("bf16")
        net.setComputeLayout("NHWC")
        net.setEpilogueFusion(True)
        assert sorted(net._ensure_epilogue_plan()) == \
            [i for i, a in enumerate(net.layers)
             if type(a) is tlayers.ConvolutionLayer][:18]
        x, y = _data("Darknet19", 5, n=2)
        ck.install_platform_overrides()
        try:
            ck.reset_counts()
            net.fit(DataSet(x, y), steps_per_dispatch=1)
            assert ck.PLAIN_CALLS["scale_shift_act"] == 18
        finally:
            ck.uninstall_platform_overrides()
        assert np.isfinite(net.score())


class TestLeNet:
    def test_fits_and_evaluates_eager_and_k_steps_a_dispatch(self):
        """LeNet-5 from the zoo learns the seeded synthetic digits through
        the iterator, one epoch a step a dispatch and one at K=4."""
        net = zoo.LeNet(num_classes=10).init(device="cpu")
        train = MnistDataSetIterator(64, True, num_examples=512)
        net.fit(train)
        net.fit(train, steps_per_dispatch=4)
        assert net.getIterationCount() == 16 and net.getEpochCount() == 2
        ev = net.evaluate(MnistDataSetIterator(128, False, num_examples=256),
                          pull_chunk=1)
        assert ev.accuracy() >= 0.9, ev.stats()
        assert ev.confusion.matrix.sum() == 256

    def test_runs_on_the_card_unless_told(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        for cls in (zoo.LeNet, zoo.VGG16, zoo.VGG19, zoo.SimpleCNN,
                    zoo.Darknet19):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cls(num_classes=2).init()

    def test_vgg_full_configurations_build(self):
        for cls, n in ((zoo.VGG16, 138_357_544), (zoo.VGG19, 143_667_240)):
            net = cls(num_classes=1000).conf_builder()
            n_params = sum(int(np.prod(s)) for layer in net.layers
                           for s in _param_shapes(layer))
            assert n_params == n, cls.__name__
            assert [i for i, a in enumerate(net.layers) if a.dropout] == \
                [len(net.layers) - 3, len(net.layers) - 2]
            assert net.conf.layers[len(net.layers) - 3].nIn == 512 * 7 * 7


def _param_shapes(layer):
    if isinstance(layer, tlayers.ConvolutionLayer):
        return [(layer.nOut, layer.nIn) + layer.kernel, (layer.nOut,)]
    if isinstance(layer, (tlayers.DenseLayer, tlayers.OutputLayer)):
        return [(layer.nIn, layer.nOut), (layer.nOut,)]
    return []
