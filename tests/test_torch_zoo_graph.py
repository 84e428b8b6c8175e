"""The port's other zoo CNNs against the JAX zoo's (CPU): AlexNet (a
MultiLayerNetwork with LRN), SqueezeNet, UNet, Xception,
FaceNetNN4Small2, InceptionResNetV1 and NASNet (ComputationGraphs), each
at the JAX package's own CPU test size (tests/test_graph_zoo.py:127-164)
with 7 classes.

One seeded init a model (the port's; the JAX init draws the same shapes
and takes 7-15 s a model on the CPU) gives both nets their weights: the
JAX net holds them as its params and a fresh port net takes them through
``params_from_jax``. Inputs are zero-mean images from numpy with a seed.
With dropout active (AlexNet's dense layers, SqueezeNet's DropoutLayer)
the JAX step's masks are handed to the port
(``test_torch_zoo_mln.inject_jax_masks``).

Tolerances (tests/test_pallas.py's): fp32 forward 1e-5 (rtol and atol),
in NCHW and under the NHWC compute layout; the train-mode loss and every
gradient 2e-4 (gradients within 2e-4 of each tensor's largest).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops.normalization import StepKey
from test_torch_zoo_mln import inject_jax_masks

torch.set_num_threads(2)

FWD_TOL = 1e-5
FIT_TOL = 2e-4
N_CLASSES = 7
SEED = 123
SIZES = {"AlexNet": 96, "SqueezeNet": 64, "UNet": 32, "Xception": 71,
         "FaceNetNN4Small2": 64, "InceptionResNetV1": 96, "NASNet": 64}
MODELS = sorted(SIZES)

_WEIGHTS = {}


def _kw(name):
    return {"input_shape": (3, SIZES[name], SIZES[name])} if name == "UNet" \
        else {"num_classes": N_CLASSES,
              "input_shape": (3, SIZES[name], SIZES[name])}


def _weights(name):
    """The port's seeded init of ``name`` as numpy, once a module."""
    if name not in _WEIGHTS:
        net = getattr(zoo, name)(**_kw(name)).init(device="cpu")
        _WEIGHTS[name] = (
            net._map(net._params, lambda v: v.detach().numpy()),
            net._map(net._states, lambda v: v.numpy()))
    return _WEIGHTS[name]


def _pair(name, layout="NCHW"):
    params, states = _weights(name)
    j = getattr(jzoo, name)(**_kw(name)).conf_builder()
    j._params = jax.tree_util.tree_map(jnp.asarray, params)
    j._states = jax.tree_util.tree_map(jnp.asarray, states)
    j._initialized = True
    t = getattr(zoo, name)(**_kw(name)).conf_builder().params_from_jax(
        params, states, device="cpu")
    t.setComputeLayout(layout)
    return j, t


def _data(name, seed, n=2):
    r = np.random.default_rng(seed)
    hw = SIZES[name]
    x = r.standard_normal((n, 3, hw, hw)).astype(np.float32)
    if name == "UNet":
        y = (r.random((n, 1, hw, hw)) < 0.5).astype(np.float32)
    else:
        y = np.eye(N_CLASSES, dtype=np.float32)[r.integers(0, N_CLASSES, n)]
    return x, y


def _layer_nodes(net):
    if not hasattr(net.conf, "topo"):        # a MultiLayerNetwork of either
        return list(enumerate(net.layers))
    return [(n.name, n.obj) for n in net.conf.topo if n.kind == "layer"]


@pytest.mark.parametrize("name", MODELS)
def test_builds_as_the_reference(name):
    j = getattr(jzoo, name)(**_kw(name)).conf_builder()
    t = getattr(zoo, name)(**_kw(name)).conf_builder()
    if isinstance(t, MultiLayerNetwork):
        assert [(type(a).__name__, a.nIn, a.nOut) for a in t.layers] == \
            [(type(a).__name__, a.nIn, a.nOut) for a in j.layers]
    else:
        assert [(n.name, n.kind, type(n.obj).__name__, n.inputs)
                for n in t.conf.topo] == \
            [(n.name, n.kind, type(n.obj).__name__, n.inputs)
             for n in j.conf.topo]
        assert {k: dict(v.dims) for k, v in t.conf.types.items()} == \
            {k: dict(v.dims) for k, v in j.conf.types.items()}
    params, _ = _weights(name)
    for (key, layer), (_, jl) in zip(_layer_nodes(t), _layer_nodes(j)):
        assert {k: v.shape for k, v in params[key].items()} == \
            {k: tuple(v) for k, v in jl.param_shapes().items()}, key


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("name", MODELS)
def test_output_matches_jax(name, layout):
    j, t = _pair(name, layout)
    x, _ = _data(name, 1)
    want = np.asarray(j.output(x))
    got = t.output(x)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)
    if name == "UNet":
        assert want.shape == (2, 1, 32, 32)
        assert ((got >= 0) & (got <= 1)).all()
    else:
        np.testing.assert_allclose(got.sum(1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize("name", MODELS)
def test_loss_and_gradients_match_jax(name, monkeypatch):
    """Train mode (dropout on, with the JAX masks), NHWC on the port."""
    j, t = _pair(name, "NHWC")
    n_layers = len(_layer_nodes(t))
    calls = inject_jax_masks(monkeypatch, SEED, n_layers)
    x, y = _data(name, 2)
    key_j = jax.random.fold_in(jax.random.PRNGKey(SEED), 5)
    graph = not isinstance(t, MultiLayerNetwork)
    ins_j = {"input": jnp.asarray(x)} if graph else jnp.asarray(x)
    lab_j = [jnp.asarray(y)] if graph else jnp.asarray(y)

    def jloss(p):
        return j._loss_and_reg(p, j._states, ins_j, lab_j, True, key_j, None,
                               None)[0]
    want, want_g = jax.jit(jax.value_and_grad(jloss))(j._params)
    ins_t = {"input": torch.from_numpy(x)} if graph else torch.from_numpy(x)
    lab_t = [torch.from_numpy(y)] if graph else torch.from_numpy(y)
    loss, _ = t._loss_and_reg(t._params, t._states, ins_t, lab_t, True, None,
                              StepKey(SEED, torch.tensor(5)))
    dropped = {"AlexNet": 2, "SqueezeNet": 1}.get(name, 0)
    assert len(calls) == dropped
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=FIT_TOL)
    names = [(n, k) for n, p in t._items(t._params) for k in p]
    grads = torch.autograd.grad(loss, [t._params[n][k] for n, k in names])
    for (n, k), g in zip(names, grads):
        ref = np.asarray(want_g[n][k])
        np.testing.assert_allclose(
            g.numpy(), ref, rtol=0,
            atol=FIT_TOL * max(float(np.abs(ref).max()), 1e-30),
            err_msg=f"{name} {n}.{k}")


def test_the_zoo_lists_every_ported_model():
    assert sorted(zoo.ZOO_MODELS) == sorted(jzoo.ZOO_MODELS)
    for name, net in zoo.all_zoo_models():
        assert type(net).__name__ == \
            type(jzoo.ZOO_MODELS[name]().conf_builder()).__name__, name


def test_the_new_models_run_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in MODELS + ["YOLO2"]:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            getattr(zoo, name)(**_kw(name) if name in SIZES else {}).init()
