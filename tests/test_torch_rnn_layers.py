"""The port's recurrent layers against the JAX package's, on the CPU:
LSTM, GravesLSTM, GRU, SimpleRnn, Bidirectional (every merge mode),
BidirectionalLastStep, LastTimeStep, RnnOutputLayer (its masked loss) and
the masked GlobalPoolingLayer, each from the JAX layer's own init (its
params carried over as numpy, a Bidirectional's nested dict as the
port's flat ``fwd/``/``bwd/`` names) on the same seeded inputs, masked
and unmasked; ``apply_with_state`` from a given state; each layer's JSON
in both directions; and a masked ComputationGraph (LSTM -> LastTimeStep
-> OutputLayer) through its loss, gradients and one Adam step.

Tolerances (tests/test_pallas.py's): fp32 forward 1e-5 (rtol and atol);
gradients within 2e-4 of each gradient's largest magnitude; the Adam
step's params and moments within 2e-4.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.multilayer import _process_and_apply_grads
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.nn import layers as tlayers
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.train import updaters as tupd

torch.set_num_threads(2)

FWD_TOL = 1e-5
GRAD_TOL = 2e-4
N, C, T, H = 3, 5, 8, 6

LAYERS = {
    "LSTM": lambda M: M.LSTM(nOut=H),
    "GravesLSTM": lambda M: M.GravesLSTM(nOut=H),
    "GRU": lambda M: M.GRU(nOut=H),
    "SimpleRnn": lambda M: M.SimpleRnn(nOut=H),
    "Bidirectional-concat": lambda M: M.Bidirectional(M.LSTM(nOut=H)),
    "Bidirectional-add": lambda M: M.Bidirectional(M.GRU(nOut=H), "add"),
    "Bidirectional-mul": lambda M: M.Bidirectional(M.SimpleRnn(nOut=H),
                                                   "mul"),
    "Bidirectional-average": lambda M: M.Bidirectional(M.LSTM(nOut=H),
                                                       "average"),
    "BidirectionalLastStep": lambda M: M.BidirectionalLastStep(
        M.LSTM(nOut=H)),
    "LastTimeStep": lambda M: M.LastTimeStep(M.LSTM(nOut=H)),
    "LastTimeStep-SimpleRnn": lambda M: M.LastTimeStep(M.SimpleRnn(nOut=H)),
    "GlobalPooling-avg": lambda M: M.GlobalPoolingLayer("avg"),
    "GlobalPooling-max": lambda M: M.GlobalPoolingLayer("max"),
    "GlobalPooling-sum": lambda M: M.GlobalPoolingLayer("sum"),
    "GlobalPooling-pnorm": lambda M: M.GlobalPoolingLayer("pnorm"),
    "RnnOutputLayer": lambda M: M.RnnOutputLayer(nOut=4),
}


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _pair(name, seed=0):
    j, t = LAYERS[name](jlayers), LAYERS[name](tlayers)
    j.set_defaults(JConf())
    t.set_defaults(NeuralNetConfiguration())
    j.infer_nin(JInputType.recurrent(C, T))
    t.infer_nin(InputType.recurrent(C, T))
    jp, _ = j.initialize(jax.random.PRNGKey(seed))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in _flat(jp).items()}
    return j, t, jp, tp


def _inputs(seed=1):
    r = np.random.default_rng(seed)
    x = r.standard_normal((N, C, T)).astype(np.float32)
    m = np.ones((N, T), np.float32)
    m[0, 5:] = 0.0          # ragged lengths
    m[1, 2:4] = 0.0         # a hole
    return x, m


def _apply_j(j, jp, x, mask):
    key = jax.random.PRNGKey(0)
    if mask is None or isinstance(j, jlayers.RnnOutputLayer):
        if isinstance(j, jlayers.RnnOutputLayer):
            return j.apply(jp, {}, x, False, key)[0]
        return j.apply(jp, {}, x, False, key, mask=None)[0]
    return j.apply(jp, {}, x, False, key, mask=mask)[0]


def _apply_t(t, tp, x, mask):
    if isinstance(t, tlayers.RnnOutputLayer):
        return t.apply(tp, {}, x, False)[0]
    return t.apply(tp, {}, x, False, None, mask=mask)[0]


#: layers that take no feature mask (their own tests below)
NO_MASK = ("BidirectionalLastStep", "RnnOutputLayer")


@pytest.mark.parametrize("name,masked", [
    (n, m) for n in sorted(LAYERS) for m in (False, True)
    if not (m and n in NO_MASK)])
def test_layer_matches_jax(name, masked):
    j, t, jp, tp = _pair(name)
    x, m = _inputs()
    mask = m if masked else None
    out_j = _apply_j(j, jp, jnp.asarray(x),
                     None if mask is None else jnp.asarray(mask))
    r = np.random.default_rng(9)
    proj = r.standard_normal(np.shape(out_j)).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(_apply_j(j, p, xx, None if mask is None
                                else jnp.asarray(mask)) * proj)
    want_g = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    out_t = _apply_t(t, tp, tx, None if mask is None
                     else torch.from_numpy(mask))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=FWD_TOL, atol=FWD_TOL)
    names = sorted(tp)
    grads = torch.autograd.grad((out_t * torch.from_numpy(proj)).sum(),
                                [tp[k] for k in names] + [tx])
    wants = [_flat(want_g[0])[k] for k in names] + [want_g[1]]
    for k, g, ref in zip(names + ["x"], grads, wants):
        ref = np.asarray(ref)
        np.testing.assert_allclose(
            g.numpy(), ref, rtol=0,
            atol=GRAD_TOL * max(float(np.abs(ref).max()), 1e-30),
            err_msg=f"{name} d/d{k}")


@pytest.mark.parametrize("name", ["LSTM", "GRU", "SimpleRnn"])
def test_apply_with_state_matches_jax(name):
    j, t, jp, tp = _pair(name)
    x, m = _inputs(2)
    r = np.random.default_rng(3)
    h = r.standard_normal((N, H)).astype(np.float32)
    c = r.standard_normal((N, H)).astype(np.float32)
    js = (jnp.asarray(h), jnp.asarray(c)) if name == "LSTM" \
        else jnp.asarray(h)
    ts = (torch.from_numpy(h), torch.from_numpy(c)) if name == "LSTM" \
        else torch.from_numpy(h)
    for mask in (None, m):
        want, want_s = j.apply_with_state(
            jp, jnp.asarray(x), js,
            mask=None if mask is None else jnp.asarray(mask))
        with torch.no_grad():
            got, got_s = t.apply_with_state(
                tp, torch.from_numpy(x), ts,
                mask=None if mask is None else torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FWD_TOL, atol=FWD_TOL)
        for g, w in zip(jax.tree_util.tree_leaves(got_s),
                        jax.tree_util.tree_leaves(want_s)):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=FWD_TOL, atol=FWD_TOL)
    zeros = t.zero_state(N, torch.float32, "cpu")
    a, _ = t.apply_with_state(tp, torch.from_numpy(x), zeros)
    b, _ = t.apply_with_state(tp, torch.from_numpy(x), None)
    assert torch.equal(a, b)


def test_lstm_init_forget_gate_bias():
    _, t, _, _ = _pair("LSTM")
    p, _ = t.initialize(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {"W": (C, 4 * H), "RW": (H, 4 * H), "b": (4 * H,)}
    want = np.zeros(4 * H, np.float32)
    want[H:2 * H] = 1.0
    np.testing.assert_array_equal(p["b"].numpy(), want)


def test_bidirectional_last_step_refuses_a_mask():
    j, t, jp, tp = _pair("BidirectionalLastStep")
    x, m = _inputs()
    with pytest.raises(ValueError, match="masks"):
        j.apply(jp, {}, jnp.asarray(x), False, None, mask=jnp.asarray(m))
    with pytest.raises(ValueError, match="masks"):
        t.apply(tp, {}, torch.from_numpy(x), False, None,
                mask=torch.from_numpy(m))


@pytest.mark.parametrize("masked", [False, True])
def test_rnn_output_loss_matches_jax(masked):
    """Softmax over the classes at each step; the loss is the sum over
    time divided by N, over the active steps under a mask."""
    j, t, jp, tp = _pair("RnnOutputLayer")
    x, m = _inputs(4)
    r = np.random.default_rng(5)
    y = np.eye(4, dtype=np.float32)[r.integers(0, 4, (N, T))].transpose(
        0, 2, 1)
    mask = m if masked else None

    def jloss(p, xx):
        out, _ = j.apply(p, {}, xx, True, None)
        return j.compute_loss(jnp.asarray(y), out,
                              mask=None if mask is None
                              else jnp.asarray(mask))
    want, want_g = jax.value_and_grad(jloss, argnums=(0, 1))(
        jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    out, _ = t.apply(tp, {}, tx, True)
    np.testing.assert_allclose(out.detach().sum(dim=1).numpy(),
                               np.ones((N, T), np.float32), rtol=1e-6)
    loss = t.compute_loss(torch.from_numpy(y), out,
                          mask=None if mask is None
                          else torch.from_numpy(mask))
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=FWD_TOL)
    # a sum over time: about T (active steps) x ln(4) / 1 per example
    steps = m.sum() if masked else N * T
    assert 0.3 * steps * np.log(4) / N < float(loss.detach()) \
        < 3 * steps * np.log(4) / N
    grads = torch.autograd.grad(loss, [tp["W"], tp["b"], tx])
    for g, ref in zip(grads, [want_g[0]["W"], want_g[0]["b"], want_g[1]]):
        ref = np.asarray(ref)
        np.testing.assert_allclose(
            g.numpy(), ref, rtol=0,
            atol=GRAD_TOL * max(float(np.abs(ref).max()), 1e-30))


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_config_json_crosses_both_ways(name):
    j, t, _, _ = _pair(name)
    jd = json.loads(json.dumps(j.to_config()))
    td = json.loads(json.dumps(t.to_config()))
    assert td == jd
    assert tlayers.layer_from_config(jd).to_config() == jd
    assert jlayers.layer_from_config(td).to_config() == td


# ----------------------------------------------- the masked graph (CG)
def _graph(Conf, M, It, upd):
    return (Conf.Builder().seed(3).updater(upd.Adam(1e-2)).graphBuilder()
            .addInputs("in").setInputTypes(It.recurrent(C, T))
            .addLayer("lstm", M.LSTM(nOut=H), "in")
            .addLayer("last", M.LastTimeStep(M.LSTM(nOut=H)), "lstm")
            .addLayer("out", M.OutputLayer(nOut=3, lossFunction="mcxent"),
                      "last")
            .setOutputs("out").build())


def _graph_pair():
    j = JCG(_graph(JConf, jlayers, JInputType, jupd))
    j.init()
    t = ComputationGraph(_graph(NeuralNetConfiguration, tlayers, InputType,
                                tupd)).params_from_jax(j._params, j._states,
                                                       device="cpu")
    return j, t


def test_masked_graph_matches_jax():
    j, t = _graph_pair()
    x, m = _inputs(6)
    y = np.eye(3, dtype=np.float32)[np.random.default_rng(7).integers(
        0, 3, N)]
    np.testing.assert_allclose(t.output(x).numpy(), np.asarray(j.output(x)),
                               rtol=FWD_TOL, atol=FWD_TOL)
    key = jax.random.PRNGKey(0)

    def jloss(p):
        return j._loss_and_reg(p, j._states, {"in": jnp.asarray(x)},
                               [jnp.asarray(y)], True, key, jnp.asarray(m),
                               None)[0]
    want, want_g = jax.value_and_grad(jloss)(j._params)
    loss, _ = t._loss_and_reg(t._params, t._states, {"in": torch.from_numpy(x)},
                              [torch.from_numpy(y)], True, None,
                              fmask=torch.from_numpy(m))
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=FWD_TOL)
    unmasked, _ = t._loss_and_reg(t._params, t._states,
                                  {"in": torch.from_numpy(x)},
                                  [torch.from_numpy(y)], True, None)
    assert abs(float(unmasked.detach()) - float(loss.detach())) > 1e-4   # the mask matters
    # one Adam step through fit() against the JAX update of the same
    # gradients (the JAX graph's own train step passes no feature mask)
    j._ensure_opt_state()
    want_p, want_o = _process_and_apply_grads(
        j.conf.base, j.conf.base.updater, j._params, want_g, j._opt_state,
        jnp.float32(0))
    t.fit(DataSet(x, y, m))
    np.testing.assert_allclose(float(t.score()), float(want), rtol=FWD_TOL)
    for n in want_p:
        for k in want_p[n]:
            np.testing.assert_allclose(
                t._params[n][k].detach().numpy(), np.asarray(want_p[n][k]),
                rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=f"{n}.{k}")
            for s in ("m", "v"):
                ref = np.asarray(want_o[n][k][s])
                np.testing.assert_allclose(
                    t._opt_state[n][k][s].numpy(), ref, rtol=GRAD_TOL,
                    atol=GRAD_TOL * max(float(np.abs(ref).max()), 1e-30),
                    err_msg=f"{n}.{k}.{s}")
    assert set(t._step_cache) == {(True, False, 1)}


def test_graph_json_with_recurrent_layers_crosses():
    j, t = _graph_pair()
    assert json.loads(t.conf.to_json()) == json.loads(j.conf.to_json())
    back = type(t.conf).from_json(j.conf.to_json())
    assert [type(n.obj).__name__ for n in back.topo] == \
        ["LSTM", "LastTimeStep", "OutputLayer"]
