"""The port's provenance sanitizer (``profiler/sanitizer.py``) against the
JAX package's on the CPU: the same seeded data, the same transplanted
weights (``params_from_jax``) and the same NaN batch or ``FaultPlan`` go
through a JAX net and a port net under ``NAN_PANIC``/``INF_PANIC``, and
both raise ``NonfiniteAttributionError`` naming the same ``(layer, op,
step)``: an MLP one step and K=2 a dispatch, the graph, truncated BPTT,
a step beyond the snapshot interval, an overflowing MSE under
``INF_PANIC``; ``OFF`` pays nothing and raises nothing. Value-range
tracking records the same per-layer |max| in both (1e-5 relative).

Every test resets the profiling mode and the range tracking in a
fixture, so no mode leaks into another test of the worker.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import faults as jfaults
from deeplearning4j_tpu import profiler as jprof
from deeplearning4j_tpu.data import dataset as jdata
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JGraph
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.profiler import sanitizer as jsan
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch import profiler as prof
from deeplearning4j_tpu_torch.data import dataset as pdata
from deeplearning4j_tpu_torch.faults import FaultPlan
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.profiler import sanitizer as san
from deeplearning4j_tpu_torch.train import resilience
from deeplearning4j_tpu_torch.train import updaters

torch.set_num_threads(2)

JAX = dict(Conf=JConf, M=jlayers, It=JInputType, upd=jupd, Net=JMLN,
           Graph=JGraph, data=jdata, Plan=jfaults.FaultPlan, prof=jprof,
           san=jsan)
PORT = dict(Conf=NeuralNetConfiguration, M=L, It=InputType, upd=updaters,
            Net=MultiLayerNetwork, Graph=ComputationGraph, data=pdata,
            Plan=FaultPlan, prof=prof, san=san)


@pytest.fixture(autouse=True)
def _reset_modes():
    yield
    for pk in (JAX, PORT):
        pk["prof"].set_profiling_mode(None)
        pk["san"].track_value_ranges(False)


def _mlp_conf(pk, seed=7, hidden=16):
    C, M = pk["Conf"], pk["M"]
    return (C.Builder().seed(seed).updater(pk["upd"].Adam(0.01))
            .weightInit("xavier").list()
            .layer(M.DenseLayer(nOut=hidden, activation="relu"))
            .layer(M.DenseLayer(nOut=hidden, activation="relu"))
            .layer(M.OutputLayer(nOut=3, lossFunction="mcxent",
                                 activation="softmax"))
            .setInputType(pk["It"].feedForward(8)).build())


def _graph_conf(pk, seed=7):
    M = pk["M"]
    return (pk["Conf"].Builder().seed(seed).updater(pk["upd"].Adam(0.01))
            .graphBuilder().addInputs("in")
            .setInputTypes(pk["It"].feedForward(8))
            .addLayer("fc", M.DenseLayer(nOut=16, activation="relu"), "in")
            .addLayer("out", M.OutputLayer(nOut=3, lossFunction="mcxent",
                                           activation="softmax"), "fc")
            .setOutputs("out").build())


def _mse_conf(pk):
    M = pk["M"]
    return (pk["Conf"].Builder().seed(7).updater(pk["upd"].Adam(0.01))
            .list()
            .layer(M.DenseLayer(nOut=8, activation="identity"))
            .layer(M.LossLayer(lossFunction="mse"))
            .setInputType(pk["It"].feedForward(8)).build())


def _tbptt_conf(pk):
    M = pk["M"]
    return (pk["Conf"].Builder().seed(7).updater(pk["upd"].Adam(0.01))
            .weightInit("xavier").list()
            .layer(M.LSTM(nOut=6, activation="tanh"))
            .layer(M.RnnOutputLayer(nOut=2, lossFunction="mcxent",
                                    activation="softmax"))
            .setInputType(pk["It"].recurrent(3, 12))
            .backpropType("tbptt", 4).build())


def _data(n=32, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 8).astype(np.float32)
    y = np.zeros((n, 3), np.float32)
    y[np.arange(n), rng.randint(0, 3, n)] = 1.0
    return x, y


def _seq_data(n=5, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 3, 12).astype(np.float32)
    y = np.zeros((n, 2, 12), np.float32)
    y[np.arange(n), rng.randint(0, 2, n), :] = 1.0
    return x, y


def _nets(conf_fn, graph=False):
    """A JAX net and a port net on its transplanted weights."""
    jnet = (JAX["Graph"] if graph else JAX["Net"])(conf_fn(JAX)).init()
    pnet = (PORT["Graph"] if graph else PORT["Net"])(conf_fn(PORT))
    pnet.params_from_jax(jnet._params, jnet._states, device="cpu")
    return {"jax": jnet, "port": pnet}


def _site(pk, net, mode, fit):
    pk["prof"].set_profiling_mode(mode)
    try:
        with pytest.raises(pk["san"].NonfiniteAttributionError,
                           match=mode.name) as ei:
            fit(pk, net)
    finally:
        pk["prof"].set_profiling_mode(None)
    e = ei.value
    return e.layer, e.op, e.step


def _both(conf_fn, fit, mode_name="NAN_PANIC", graph=False):
    nets = _nets(conf_fn, graph)
    j = _site(JAX, nets["jax"], getattr(jprof.ProfilingMode, mode_name), fit)
    p = _site(PORT, nets["port"], getattr(prof.ProfilingMode, mode_name),
              fit)
    return j, p


def _nan_batch_one_step(pk, net):
    x, y = _data()
    x[3, 1] = np.nan
    net.fit(x, y, epochs=1)


def _nan_batch_k2(pk, net):
    x, y = _data()
    x[17, 2] = np.nan                      # third batch of 8: step 3
    it = pk["data"].ListDataSetIterator(pk["data"].DataSet(x, y),
                                        batch_size=8)
    net.fit(it, epochs=1, steps_per_dispatch=2, prefetch=0)


def _poison_one_step(pk, net):
    x, y = _data()
    net.fit(x, y, epochs=3, faults=pk["Plan"](nan_layer_params_at={2: 1}))


def _poison_mid_dispatch(pk, net):
    x, y = _data()
    it = pk["data"].ListDataSetIterator(pk["data"].DataSet(x, y),
                                        batch_size=8)
    net.fit(it, epochs=2, steps_per_dispatch=2, prefetch=0,
            faults=pk["Plan"](nan_layer_params_at={2: 1}))


def _beyond_snapshot(pk, net):
    x, y = _data(n=8)
    xb = x.copy()
    xb[0, 0] = np.nan
    batches = [pk["data"].DataSet(x, y) for _ in range(11)]
    batches.append(pk["data"].DataSet(xb, y))
    net.fit(batches, epochs=1)


def _nan_labels(pk, net):
    x, y = _data()
    y[5, 0] = np.nan
    net.fit(x, y, epochs=1)


MLP_CASES = {
    "nan_batch_one_step": (_nan_batch_one_step, ("<input>", "batch", 1)),
    "nan_batch_k2": (_nan_batch_k2, ("<input>", "batch", 3)),
    "poison_one_step": (_poison_one_step, ("1:DenseLayer", "params", 2)),
    "poison_mid_dispatch_k2": (_poison_mid_dispatch,
                               ("1:DenseLayer", "params", 3)),
    "beyond_snapshot_interval": (_beyond_snapshot, ("<input>", "batch", 12)),
    "nan_labels": (_nan_labels, ("2:OutputLayer", "loss:mcxent", 1)),
}


@pytest.mark.parametrize("case", sorted(MLP_CASES))
def test_mlp_names_the_same_site(case):
    fit, want = MLP_CASES[case]
    j, p = _both(_mlp_conf, fit)
    assert j == want
    assert p == j


def test_graph_poison_names_the_same_node():
    def fit(pk, net):
        x, y = _data()
        net.fit(x, y, epochs=3,
                faults=pk["Plan"](nan_layer_params_at={2: "fc"}))
    j, p = _both(_graph_conf, fit, graph=True)
    assert j == ("fc", "params", 2)
    assert p == j


def test_graph_nan_batch_names_the_input():
    j, p = _both(_graph_conf, _nan_batch_one_step, graph=True)
    assert j == ("<input:in>", "batch", 1)
    assert p == j


def test_tbptt_poison_through_the_window():
    def fit(pk, net):
        x, y = _seq_data()
        net.fit(pk["data"].DataSet(x, y), epochs=2,
                faults=pk["Plan"](nan_layer_params_at={4: 0}))
    j, p = _both(_tbptt_conf, fit)
    assert j == ("0:LSTM", "params", 4)
    assert p == j


def test_tbptt_nan_input_in_a_later_window():
    def fit(pk, net):
        x, y = _seq_data()
        x[1, 2, 5] = np.nan                  # window 2 of 3: step 2
        net.fit(pk["data"].DataSet(x, y), epochs=1)
    j, p = _both(_tbptt_conf, fit)
    assert j == ("<input>", "batch", 2)
    assert p == j


def test_inf_panic_on_an_overflowing_mse():
    def fit(pk, net):
        x = np.full((4, 8), 1e30, np.float32)
        net.fit(x, np.zeros((4, 8), np.float32), epochs=1)
    j, p = _both(_mse_conf, fit, mode_name="INF_PANIC")
    assert j == ("1:LossLayer", "loss:mse", 1)
    assert p == j


def test_nan_panic_lets_an_inf_loss_pass():
    x = np.full((4, 8), 1e30, np.float32)
    net = _nets(_mse_conf)["port"]
    prof.set_profiling_mode(prof.ProfilingMode.NAN_PANIC)
    net.fit(x, np.zeros((4, 8), np.float32), epochs=1)
    assert np.isinf(net.score())


@pytest.mark.parametrize("k", [1, 2])
def test_off_pays_nothing_and_raises_nothing(k, monkeypatch):
    x, y = _data()
    x[0, 0] = np.nan
    net = _nets(_mlp_conf)["port"]
    panics = prof.get_registry().get("dl4j_nonfinite_panics_total")
    before = panics.value
    monkeypatch.setattr(san, "_attribute", lambda *a: pytest.fail(
        "attribution ran with no panic mode on"))
    net.fit(pdata.ListDataSetIterator(pdata.DataSet(x, y), batch_size=8),
            epochs=1, steps_per_dispatch=k, prefetch=0)
    assert panics.value == before
    assert san._STATES.get(net) is None
    assert not np.isfinite(net.score())


@pytest.mark.parametrize("k", [1, 2])
def test_repair_an_all_nan_batch_raises_a_numerics_panic(k):
    """The fault this module repairs: a port fit under NAN_PANIC on an
    all-NaN batch returned with a NaN score; it raises now, one step and
    K steps a dispatch."""
    from deeplearning4j_tpu_torch.models import zoo
    net = zoo.LeNet(num_classes=3, input_shape=(1, 16, 16)).init(
        device="cpu")
    x = np.full((4 * k, 1, 16, 16), np.nan, np.float32)
    y = np.eye(3, dtype=np.float32)[np.arange(4 * k) % 3]
    prof.set_profiling_mode(prof.ProfilingMode.NAN_PANIC)
    with pytest.raises(resilience.NumericsPanicError, match="NAN_PANIC"):
        net.fit(pdata.ListDataSetIterator(pdata.DataSet(x, y),
                                          batch_size=4),
                steps_per_dispatch=k, prefetch=0)


def test_the_live_state_after_the_raise_is_the_failing_dispatchs():
    """The replay copies the snapshot into the live tensors and copies
    the live state back: after the raise the net holds what a net with
    the mode OFF holds after the same dispatches, in the same storage."""
    x, y = _data()
    x[20, 0] = np.nan                        # third batch of 8
    nets = [_nets(_mlp_conf)["port"] for _ in range(2)]
    for n in nets:
        n._ensure_step_state()
    ptrs = [t.data_ptr() for t in nets[0]._dispatch_state()]
    prof.set_profiling_mode(prof.ProfilingMode.NAN_PANIC)
    with pytest.raises(san.NonfiniteAttributionError) as ei:
        nets[0].fit(pdata.ListDataSetIterator(pdata.DataSet(x, y), 8),
                    steps_per_dispatch=2, prefetch=0)
    assert (ei.value.layer, ei.value.op, ei.value.step) == \
        ("<input>", "batch", 3)
    prof.set_profiling_mode(None)
    nets[1].fit(pdata.ListDataSetIterator(pdata.DataSet(x, y), 8),
                steps_per_dispatch=2, prefetch=0)
    a, b = nets[0]._dispatch_state(), nets[1]._dispatch_state()
    assert [t.data_ptr() for t in a] == ptrs
    assert len(a) == len(b)
    for t, u in zip(a, b):
        t, u = t.detach(), u.detach()
        assert torch.equal(torch.isnan(t), torch.isnan(u))
        assert torch.equal(torch.nan_to_num(t), torch.nan_to_num(u))


def test_a_restore_and_a_reinit_void_the_window():
    x, y = _data()
    net = _nets(_mlp_conf)["port"]
    prof.set_profiling_mode(prof.ProfilingMode.NAN_PANIC)
    net.fit(x, y, epochs=1)
    assert san._STATES.get(net) is not None
    net.init(device="cpu")
    assert san._STATES.get(net) is None


def _absmax_sums(pk, model_name):
    h = pk["prof"].get_registry().get("dl4j_tensor_absmax")
    if h is None:
        return {}
    return {k[1]: c.sum for k, c in h.children().items()
            if k[0] == model_name}


@pytest.mark.parametrize("graph", [False, True])
def test_value_ranges_match_per_layer(graph):
    """``track_value_ranges``: one |max| sample a layer after a step, the
    same in both packages within 1e-5 relative."""
    x, y = _data()
    nets = _nets(_graph_conf if graph else _mlp_conf, graph)
    deltas = {}
    for key, pk in (("jax", JAX), ("port", PORT)):
        name = type(nets[key]).__name__
        before = _absmax_sums(pk, name)
        pk["san"].track_value_ranges(True, every=1)
        pk["prof"].set_profiling_mode(pk["prof"].ProfilingMode.NAN_PANIC)
        nets[key].fit(x, y, epochs=1)
        pk["prof"].set_profiling_mode(None)
        after = _absmax_sums(pk, name)
        deltas[key] = {k: v - before.get(k, 0.0) for k, v in after.items()
                       if v - before.get(k, 0.0) > 0}
    assert set(deltas["port"]) == set(deltas["jax"]) and deltas["jax"]
    for k, v in deltas["jax"].items():
        assert deltas["port"][k] == pytest.approx(v, rel=1e-5), k


def test_overflow_proximity_under_bf16():
    x, y = _data()
    net = _nets(_mlp_conf)["port"]
    net.setPrecisionPolicy("bf16")
    san.track_value_ranges(True, every=1)
    prof.set_profiling_mode(prof.ProfilingMode.NAN_PANIC)
    net.fit(x, y, epochs=2)
    hist = prof.get_registry().get("dl4j_tensor_absmax")
    layers = {k[1] for k in hist.children() if k[0] == "MultiLayerNetwork"}
    assert {"0:DenseLayer", "1:DenseLayer", "2:OutputLayer"} <= layers
    prox = prof.get_registry().get("dl4j_overflow_proximity").value
    assert 0.0 < prox < 1.0


def test_nonfinite_attribution_error_is_the_ports_numerics_panic():
    assert issubclass(san.NonfiniteAttributionError,
                      resilience.NumericsPanicError)
    assert prof.get_registry().get("dl4j_nonfinite_first_site") is not None

