"""The port's per-layer device time (``profiler/devicetime.py``) on the
CPU: the FLOP model equals the JAX package's for every zoo configuration
both build; the trace attribution (kernel time to the innermost
``dl4j_L`` scope of the launching op) is held on a synthetic event list,
as no card is here; sync mode and the table's arithmetic, metrics export
and gating follow the JAX module; the per-layer scopes change nothing in
a forward and are off unless something records.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.profiler import devicetime as jdt
from deeplearning4j_tpu_torch import profiler as prof
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import (ComputationGraph,
                                               ElementWiseVertex)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.profiler import devicetime as dt

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _reset_mode():
    yield
    prof.set_profiling_mode(None)


def conv_net(bn=True, fused=False):
    b = (NeuralNetConfiguration.Builder().seed(9).weightInit("relu").list()
         .layer(L.ConvolutionLayer(kernelSize=(3, 3), padding=(1, 1), nOut=8,
                                   activation="identity")))
    if bn:
        b = b.layer(L.BatchNormalization()).layer(L.ActivationLayer("relu"))
    b = (b.layer(L.SubsamplingLayer(poolingType="max", kernelSize=(2, 2),
                                    stride=(2, 2)))
         .layer(L.DenseLayer(nOut=16, activation="relu"))
         .layer(L.OutputLayer(nOut=4, lossFunction="mcxent",
                              activation="softmax"))
         .setInputType(InputType.convolutional(12, 12, 3)))
    net = MultiLayerNetwork(b.build()).init(device="cpu")
    if fused:
        net.setEpilogueFusion(True)
    return net


def small_x(n=6):
    return np.random.RandomState(0).randn(n, 3, 12, 12).astype(np.float32)


# ------------------------------------------------------------- FLOP model
@pytest.mark.parametrize("name", sorted(zoo.ZOO_MODELS))
def test_flop_model_equals_the_jax_one(name):
    if not hasattr(jzoo, name):
        pytest.skip(f"the JAX zoo has no {name}")
    ours = dt.layer_flop_model(zoo.ZOO_MODELS[name]().conf_builder().conf)
    theirs = jdt.layer_flop_model(getattr(jzoo, name)().conf_builder().conf)
    assert ours == theirs
    assert any(f > 0 for _n, _o, f in ours)


def test_op_kinds_and_scope_names_equal_the_jax_ones():
    for layer in (L.ConvolutionLayer(nOut=2), L.BatchNormalization(),
                  L.DenseLayer(nOut=2), L.LSTM(nOut=2),
                  L.SubsamplingLayer(), L.OutputLayer(nOut=2)):
        assert dt.op_kind(layer) == jdt.op_kind(layer)
    for i, n in ((0, "conv1"), (33, "res2a_branch2a/bn"), (7, "a b")):
        assert dt.scope_name(i, n) == jdt.scope_name(i, n)


def test_default_peak_is_the_h100s():
    assert dt.default_peak_flops(torch.bfloat16) == 989e12
    assert dt.default_peak_flops(None) == 67e12


# --------------------------------------------------- trace attribution
class _Evt:
    def __init__(self, name, parent=None, kernels=()):
        self.name, self.cpu_parent = name, parent
        self.kernels = [_Kernel(n, d) for n, d in kernels]


class _Kernel:
    def __init__(self, name, duration):
        self.name, self.duration = name, duration      # µs


def test_kernels_go_to_the_innermost_scope_of_their_op():
    fwd = _Evt("forward")
    l0 = _Evt(dt.scope_name(0, "conv"), fwd)
    conv = _Evt("aten::convolution", l0)
    cudnn = _Evt("aten::cudnn_convolution", conv,
                 [("sm90_xmma_fprop", 120.0)])
    l1 = _Evt(dt.scope_name(1, "bn"), fwd,
              [("scale_shift_act_kernel", 30.0),      # launched by ctypes
               (dt.scope_name(1, "bn"), 55.0)])       # its device annotation
    mean = _Evt("aten::mean", l1, [("reduce_kernel", 10.0),
                                   ("reduce_kernel", 5.0)])
    outer = _Evt(dt.scope_name(2, "block"), fwd)
    inner = _Evt(dt.scope_name(3, "inner"), outer)
    mm = _Evt("aten::mm", inner, [("gemm", 40.0)])
    stray = _Evt("aten::add", fwd, [("elementwise", 7.0)])
    events = [fwd, l0, conv, cudnn, l1, mean, outer, inner, mm, stray]
    seconds, launches = dt.scope_seconds_from_events(events)
    assert seconds == pytest.approx({0: 120e-6, 1: 45e-6, 3: 40e-6})
    assert launches == {0: {"sm90_xmma_fprop": 1},
                        1: {"scale_shift_act_kernel": 1,
                            "reduce_kernel": 2},
                        3: {"gemm": 1}}
    assert dt.kernel_events(events) == 7


def test_trace_rows_per_forward_with_launches(monkeypatch):
    net = conv_net(bn=False)        # conv, pool, dense, out
    x = small_x()
    monkeypatch.setattr(dt, "_trace_layer_seconds", lambda run, warm: (
        {0: 3e-3, 2: 1e-3}, {0: {"conv_kernel": 6}}))
    table = dt.measure(net, x, reps=3, mode="trace", peak_flops=1e12)
    assert table.source == "trace"
    rows = {r.layer: r for r in table.rows}
    assert set(rows) == {"convolutionlayer_0", "denselayer_2"}
    assert rows["convolutionlayer_0"].seconds == pytest.approx(1e-3)
    assert table.launches == {"convolutionlayer_0": {"conv_kernel": 2.0}}
    flops = dict((n, f) for n, _o, f in dt.layer_flop_model(net.conf))
    conv = rows["convolutionlayer_0"]
    assert conv.mfu == pytest.approx(min(
        flops["convolutionlayer_0"] * 6 / (1e-3 * 1e12), 1.0))
    assert sum(r.share for r in table.rows) == pytest.approx(1.0)


def test_trace_mode_raises_without_kernel_events():
    with pytest.raises(RuntimeError, match="no CUDA kernel event"):
        dt.measure(conv_net(), small_x(), reps=1, mode="trace")


def test_a_caller_trace_run_is_not_divided_by_reps(monkeypatch):
    net = conv_net(bn=False)
    monkeypatch.setattr(dt, "_trace_layer_seconds",
                        lambda run, warm: ({0: 3e-3}, {}))
    table = dt.measure(net, small_x(), reps=3, mode="trace",
                       trace_run=lambda: None)
    assert table.rows[0].seconds == pytest.approx(3e-3)


# -------------------------------------------------------------- sync mode
def test_sync_attribution_matches_the_flop_model():
    net = conv_net(bn=False)
    x = small_x()
    table = dt.measure(net, x, reps=1, mode="auto")
    assert table.source == "sync"
    assert len(table.rows) == len(net.layers)
    assert sum(r.share for r in table.rows) == pytest.approx(1.0)
    model = {n: f for n, _o, f in dt.layer_flop_model(net.conf)}
    for r in table.rows:
        assert r.seconds > 0
        assert r.flops == model[r.layer] * x.shape[0] * 3.0
        if r.flops:
            assert r.mfu is not None and 0 <= r.mfu <= 1.0
    top = table.top_offenders(2)
    assert set(top[0]) == set(jdt.LayerTime("a", "b", 1.0, 1.0, 0.5,
                                             1.0).as_dict())
    assert top[0]["device_ms"] >= top[1]["device_ms"]


def test_sync_on_a_graph_names_layers_and_vertices():
    g = (NeuralNetConfiguration.Builder().seed(3).weightInit("relu")
         .graphBuilder().addInputs("in")
         .setInputTypes(InputType.convolutional(8, 8, 3)))
    g.addLayer("c1", L.ConvolutionLayer(kernelSize=(3, 3), padding=(1, 1),
                                        nOut=8, activation="relu"), "in")
    g.addLayer("c2", L.ConvolutionLayer(kernelSize=(1, 1), nOut=8,
                                        activation="identity"), "c1")
    g.addVertex("add", ElementWiseVertex("Add"), "c2", "c1")
    g.addLayer("gp", L.GlobalPoolingLayer("avg"), "add")
    g.addLayer("out", L.OutputLayer(nOut=3, lossFunction="mcxent",
                                    activation="softmax"), "gp")
    g.setOutputs("out")
    net = ComputationGraph(g.build()).init(device="cpu")
    x = np.random.RandomState(0).randn(4, 3, 8, 8).astype(np.float32)
    table = dt.measure(net, x, reps=1, mode="sync")
    ops = {r.layer: r.op for r in table.rows}
    assert {"c1", "c2", "gp", "out", "add"} <= set(ops)
    assert ops["add"] == "vertex" and ops["c1"] == "conv2d"
    assert table.total_seconds > 0


def test_fused_groups_time_the_conv_and_the_bn_apart():
    net = conv_net(fused=True)
    table = dt.measure(net, small_x(), reps=1, mode="sync")
    names = {r.layer for r in table.rows}
    assert {"convolutionlayer_0", "batchnormalization_1"} <= names
    assert "activationlayer_2" not in names      # folded into the BN


def test_transformer_rows_follow_its_scopes():
    cfg = ttr.TransformerConfig.tiny(dtype=torch.float32)
    lm = ttr.TransformerLM(cfg, device="cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 16))
    table = dt.measure(lm, tok, reps=1, mode="sync")
    assert [r.layer for r in table.rows] == \
        [n for n, _o in dt.transformer_scopes(cfg)]
    flops = dict((n, f) for n, _o, f in dt.transformer_flop_rows(cfg, 16))
    assert flops["b0.attn"] == 2 * 16 * 64 * 192 + 4 * 16 * 16 * 64 \
        + 2 * 16 * 64 * 64
    post = ttr.TransformerConfig.tiny(dtype=torch.float32,
                                      arch="postln_bert")
    assert [n for n, _o in dt.transformer_scopes(post)][:3] == \
        ["embed", "emb_norm", "b0.attn"]


# ---------------------------------------------------------- scopes, gating
def test_scopes_are_off_unless_recording_and_change_nothing():
    net = conv_net(fused=True)
    x = small_x()
    assert dt.recorder() is None
    plain = net.output(x)
    rec = dt._SyncRecorder(False)
    with dt.recording(rec) as r:
        assert dt.recorder() is r
        scoped = net.output(x)
        with dt.recording() as inner:
            assert isinstance(inner, dt._TraceRecorder)
        assert dt.recorder() is r
    assert dt.recorder() is None
    assert torch.equal(plain, scoped)
    assert set(rec.seconds) == {0, 1, 3, 4, 5}
    lm = ttr.TransformerLM(ttr.TransformerConfig.tiny(dtype=torch.float32),
                           device="cpu")
    tok = torch.randint(0, 1024, (2, 8))
    a = lm.logits(tok)
    with dt.recording(dt._SyncRecorder(False)):
        b = lm.logits(tok)
    assert torch.equal(a, b)


def test_off_mode_exports_nothing_basic_mode_exports_series():
    net = conv_net()
    table = dt.measure(net, small_x(), reps=1, mode="sync")
    prof.set_profiling_mode(prof.ProfilingMode.OFF)
    before = prof.get_registry().get("dl4j_op_device_seconds")
    assert table.export_metrics("fixture") is False
    assert prof.get_registry().get("dl4j_op_device_seconds") is before
    prof.set_profiling_mode(prof.ProfilingMode.BASIC)
    assert table.export_metrics("fixture") is True
    m = prof.get_registry().get("dl4j_op_device_seconds")
    assert any(k[0] == "fixture" and k[2] == "conv2d"
               for k in m.children())


def test_attribution_detail_payload_has_the_jax_keys():
    net = conv_net()
    d = dt.attribution_detail(net, small_x(), model_name="fixture", reps=1,
                              mode="sync")
    assert set(d) == {"source", "device_ms_total", "per_layer",
                      "top_offenders"}
    assert d["source"] == "sync" and len(d["top_offenders"]) == 3
