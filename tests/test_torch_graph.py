"""The port's ComputationGraph and ResNet-50 against the JAX package (CPU).

Parameters cross from the JAX package by transplant
(``ComputationGraph.params_from_jax``), so both sides start from the
same numbers; inputs come from numpy with a seed.

Tolerances:
- fp32 ``output()``: 1e-5, the JAX package's own fused-vs-unfused bound
  (tests/test_devicetime.py:505).
- fp32, after one ``fit`` step with Adam: params, BN running stats and
  score 2e-4, the reference's gradient tolerance (ROADMAP.md).
- bf16 policy: the losses of 4 steps within 10% of the first loss, the
  bound of tests/test_devicetime.py:450-469 (bf16 carries 8 bits; the
  two packages round at other places).
"""

import numpy as np
import pytest

import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn import graph as jgraph
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn import graph as tgraph
from deeplearning4j_tpu_torch.nn import layers as tlayers
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.train import updaters as tupd

# the test workers share the CPU: keep torch's intra-op pool small
torch.set_num_threads(2)

OUT_TOL = 1e-5
FIT_TOL = 2e-4
BF16_LOSS_BOUND = 0.10
N_CLASSES = 5


def _residual_graph(conf, G, Lm, inputs):
    """conv-BN-relu x2, conv-BN, a shortcut conv-BN, Add, relu, global
    avg pool, OutputLayer at 3-16 channels on 8x8 input, built the same
    way in either package."""
    g = (conf.Builder().seed(3).weightInit("relu")
         .l1(inputs.get("l1", 0.0)).l2(inputs.get("l2", 0.0))
         .updater(inputs["updater"]).graphBuilder().addInputs("in")
         .setInputTypes(inputs["InputType"].convolutional(8, 8, 3)))
    conv = Lm.ConvolutionLayer
    g.addLayer("c1", conv(kernelSize=(3, 3), padding=(1, 1), nOut=8,
                          activation="identity"), "in")
    g.addLayer("bn1", Lm.BatchNormalization(), "c1")
    g.addLayer("r1", Lm.ActivationLayer("relu"), "bn1")
    g.addLayer("c2", conv(kernelSize=(3, 3), stride=(2, 2), padding=(1, 1),
                          nOut=8, activation="identity"), "r1")
    g.addLayer("bn2", Lm.BatchNormalization(), "c2")
    g.addLayer("r2", Lm.ActivationLayer("relu"), "bn2")
    g.addLayer("c3", conv(kernelSize=(1, 1), nOut=16,
                          activation="identity"), "r2")
    g.addLayer("bn3", Lm.BatchNormalization(), "c3")
    g.addLayer("sc", conv(kernelSize=(1, 1), stride=(2, 2), nOut=16,
                          activation="identity"), "in")
    g.addLayer("scbn", Lm.BatchNormalization(), "sc")
    g.addVertex("add", G.ElementWiseVertex("Add"), "bn3", "scbn")
    g.addLayer("out_relu", Lm.ActivationLayer("relu"), "add")
    g.addLayer("gap", Lm.GlobalPoolingLayer("avg"), "out_relu")
    g.addLayer("out", Lm.OutputLayer(nOut=N_CLASSES, lossFunction="mcxent",
                                     activation="softmax"), "gap")
    g.setOutputs("out")
    return G.ComputationGraph(g.build())


def _pair(layout="NCHW", fused=False, bf16=False, **reg):
    """(JAX graph, port graph) with the JAX params transplanted; ``reg``
    sets the base config's l1/l2."""
    j = _residual_graph(JConf, jgraph, jlayers,
                        {"updater": jupd.Adam(1e-2),
                         "InputType": JInputType, **reg}).init()
    t = _residual_graph(NeuralNetConfiguration, tgraph, tlayers,
                        {"updater": tupd.Adam(1e-2),
                         "InputType": InputType, **reg})
    t.params_from_jax(j._params, j._states, device="cpu")
    for net in (j, t):
        net.setComputeLayout(layout)
        net.setEpilogueFusion(fused)
        if bf16:
            net.setPrecisionPolicy("bf16")
    return j, t


def _data(seed=0, n=4):
    r = np.random.default_rng(seed)
    x = r.standard_normal((n, 3, 8, 8)).astype(np.float32)
    y = np.eye(N_CLASSES, dtype=np.float32)[r.integers(0, N_CLASSES, n)]
    return x, y


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.fixture()
def torch_overrides():
    ck.install_platform_overrides()
    try:
        yield
    finally:
        ck.uninstall_platform_overrides()


class TestResidualGraph:
    @pytest.mark.parametrize("layout,fused", [("NCHW", False),
                                              ("NHWC", True)])
    def test_output_matches_jax(self, torch_overrides, layout, fused):
        j, t = _pair(layout, fused)
        x, _ = _data(1)
        ck.reset_counts()
        got = t.output(x)
        assert ck.PLAIN_CALLS["scale_shift_act"] == (2 if fused else 0)
        assert got.shape == (4, N_CLASSES) and got.dtype == torch.float32
        _close(got.numpy(), np.asarray(j.output(x)), OUT_TOL, "output")

    @pytest.mark.parametrize("layout,fused", [("NCHW", False),
                                              ("NHWC", True)])
    def test_one_adam_step_matches_jax(self, torch_overrides, layout, fused):
        j, t = _pair(layout, fused)
        x, y = _data(2)
        j.fit(JDataSet(x, y))
        t.fit(DataSet(x, y))
        _close(t.score(), j.score(), FIT_TOL, "score")
        folded = {c for _a, c, _al in t._ensure_epilogue_plan().values()} \
            if fused else set()
        for node, p in j._params.items():
            for k, v in p.items():
                if k == "b" and node in ("c1", "c2", "c3", "sc") \
                        and node not in folded:
                    # a conv bias feeding a train-mode BN: its gradient is
                    # zero in exact arithmetic, so Adam's normalized step
                    # follows each package's rounding noise. (A folded
                    # bias gets an exact 0 in both packages and is
                    # compared.) Carried over, so that the checks below
                    # see the same bias.
                    with torch.no_grad():
                        t._params[node][k].copy_(torch.from_numpy(
                            np.array(v)))
                    continue
                _close(t._params[node][k].detach().numpy(), np.asarray(v),
                       FIT_TOL, f"{node}.{k}")
        for node, s in j._states.items():
            for k, v in s.items():
                _close(t._states[node][k].numpy(), np.asarray(v), FIT_TOL,
                       f"{node} running {k}")
        # inference after the step reads the running statistics (and, fused,
        # un-shifts the folded biases from them)
        x2, _ = _data(3)
        _close(t.output(x2).numpy(), np.asarray(j.output(x2)), FIT_TOL,
               "output after fit")
        _close(t.params().numpy(), np.asarray(j.params()), FIT_TOL,
               "params()")

    def test_bf16_nhwc_fused_losses_within_bound(self, torch_overrides):
        pk.install_platform_overrides(interpret=True)
        try:
            j, t = _pair("NHWC", True, bf16=True)
            x, y = _data(4, n=8)
            lj, lt = [], []
            for _ in range(4):
                j.fit(JDataSet(x, y))
                lj.append(j.score())
                t.fit(DataSet(x, y))
                lt.append(t.score())
        finally:
            pk.uninstall_platform_overrides()
        assert all(np.isfinite(lt))
        scale = max(abs(lj[0]), 1e-6)
        assert max(abs(p - q) / scale for p, q in zip(lj, lt)) \
            < BF16_LOSS_BOUND, (lj, lt)
        assert lt[-1] < lt[0]

    def test_score_on_a_dataset_and_arrays_fit(self):
        j, t = _pair(l1=1e-3, l2=1e-2)
        x, y = _data(5)
        _close(t.score(DataSet(x, y)), j.score(JDataSet(x, y)), OUT_TOL,
               "score(ds)")
        t.fit(x, y)
        assert t._iteration == 1 and np.isfinite(t.score())


class TestUpdaters:
    @pytest.mark.parametrize("name", ["Sgd", "Adam"])
    def test_three_steps_match_jax(self, name):
        r = np.random.default_rng(7)
        p0 = r.standard_normal((4, 6)).astype(np.float32)
        grads = [r.standard_normal((4, 6)).astype(np.float32) * 10 ** -k
                 for k in range(3)]
        ju, tu = getattr(jupd, name)(3e-3), getattr(tupd, name)(3e-3)
        jp, tp = p0.copy(), torch.from_numpy(p0.copy())
        js, ts = ju.init_state(jp), tu.init_state(tp)
        for t, g in enumerate(grads):
            u, js = ju.apply(g, js, ju.lr_at(t), np.float32(t))
            jp = jp - np.asarray(u)
            u, ts = tu.apply(torch.from_numpy(g), ts, tu.lr_at(t), t)
            tp = tp - u
        _close(tp.numpy(), jp, 1e-6, name)

    @pytest.mark.parametrize("fn,arg", [("clip_by_value", 0.5),
                                        ("clip_by_norm", 1.0),
                                        ("clip_by_global_norm", 2.0),
                                        ("renormalize_l2", None)])
    def test_gradient_normalization_matches_jax(self, fn, arg):
        r = np.random.default_rng(8)
        gs = [r.standard_normal(s).astype(np.float32) * 2
              for s in ((3, 4), (5,))]
        extra = () if arg is None else (arg,)
        want = getattr(jupd, fn)({"a": gs[0], "b": gs[1]}, *extra)
        got = getattr(tupd, fn)([torch.from_numpy(g) for g in gs], *extra)
        for g, k in zip(got, ("a", "b")):
            _close(g.numpy(), np.asarray(want[k]), 1e-6, fn)


class TestResNet50:
    def test_plan_topology_and_params_equal_jax(self):
        jnet = jzoo.ResNet50(num_classes=1000).conf_builder()
        tnet = zoo.ResNet50(num_classes=1000).conf_builder()
        assert [n.name for n in tnet.conf.topo] == \
            [n.name for n in jnet.conf.topo]
        jnet.setEpilogueFusion(True)
        tnet.setEpilogueFusion(True)
        jplan = jnet._ensure_epilogue_plan()
        tplan = tnet._ensure_epilogue_plan()
        assert tplan == jplan
        assert len(tplan) == 33
        assert all(conv is not None for _a, conv, _al in tplan.values())
        assert tnet._epilogue_shared == jnet._epilogue_shared == set()
        tnet.init(device="cpu")
        for node in jnet.conf.topo:
            if node.kind != "layer":
                continue
            want = {k: tuple(v) for k, v in node.obj.param_shapes().items()}
            got = {k: tuple(v.shape)
                   for k, v in tnet._params[node.name].items()}
            assert got == want, node.name
        assert tnet.numParams() == 25_583_592

    def test_init_raises_without_a_card_and_runs_on_cpu(self, monkeypatch,
                                                        torch_overrides):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        model = zoo.ResNet50(num_classes=10, input_shape=(3, 32, 32))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            model.init()
        net = model.init(device="cpu")
        net.setPrecisionPolicy("bf16")
        net.setComputeLayout("NHWC")
        net.setEpilogueFusion(True)
        x = np.random.default_rng(6).standard_normal((2, 3, 32, 32)).astype(
            np.float32)
        y = np.eye(10, dtype=np.float32)[[1, 7]]
        ck.reset_counts()
        net.fit(DataSet(x, y))
        assert ck.PLAIN_CALLS["scale_shift_act"] == 33
        out = net.output(x)
        assert ck.PLAIN_CALLS["scale_shift_act"] == 66
        assert out.shape == (2, 10) and bool(torch.isfinite(out).all())
        assert np.isfinite(net.score())


def _dense_graph(conf, G, Lm, it, updater):
    """in -> dense(tanh) -> output, built the same way in either
    package."""
    return G.ComputationGraph(
        conf.Builder().seed(11).updater(updater).graphBuilder()
        .addInputs("in").setInputTypes(it.feedForward(4))
        .addLayer("fc", Lm.DenseLayer(nOut=6, activation="tanh"), "in")
        .addLayer("out", Lm.OutputLayer(nOut=3, lossFunction="mcxent",
                                        activation="softmax"), "fc")
        .setOutputs("out").build())


class TestAdamW:
    """AdamW's decoupled decay on the weights (``W*``/``RW*``), not on the
    biases, as the reference's shared step gates it (JAX
    multilayer.py:139-145, graph.py:748): one step against the JAX step
    within FIT_TOL; the decay term, lr * wd * W ~ 1e-3, is well above it."""

    LR, WD = 1e-2, 0.5

    def _fit(self, updater_j, updater_t):
        x, y = np.random.default_rng(4).standard_normal((8, 4)).astype(
            np.float32), np.eye(3, dtype=np.float32)[[0, 1, 2, 0, 1, 2, 0, 1]]
        j = _dense_graph(JConf, jgraph, jlayers, JInputType,
                         updater_j).init()
        t = _dense_graph(NeuralNetConfiguration, tgraph, tlayers, InputType,
                         updater_t)
        t.params_from_jax(j._params, j._states, device="cpu")
        w0 = {n: {k: np.asarray(v) for k, v in p.items()}
              for n, p in j._params.items()}
        j.fit(JDataSet(x, y))
        t.fit(DataSet(x, y))
        return j, t, w0

    def test_one_step_matches_jax(self):
        j, t, w0 = self._fit(jupd.AdamW(self.LR, weight_decay=self.WD),
                             tupd.AdamW(self.LR, weight_decay=self.WD))
        for n, p in j._params.items():
            for k, v in p.items():
                _close(t._params[n][k].detach().numpy(), np.asarray(v),
                       FIT_TOL, f"{n}.{k}")
        # the gate: against a plain Adam step from the same start, W moved
        # by the decay and b did not
        _, a, _ = self._fit(jupd.Adam(self.LR), tupd.Adam(self.LR))
        for n in ("fc", "out"):
            assert torch.equal(t._params[n]["b"], a._params[n]["b"])
            d = (a._params[n]["W"] - t._params[n]["W"]).detach().numpy()
            _close(d, self.LR * self.WD * w0[n]["W"], 1e-6, f"{n}.W decay")
