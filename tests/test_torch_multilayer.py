"""The port's MultiLayerNetwork, TinyYOLO and same-mode pooling against
the JAX package (CPU).

TinyYOLO (3 classes, 3x64x64, so a 2x2 grid) is initialized once by the
JAX package; each test builds fresh networks in both packages from those
parameters (``params_from_jax`` here, the same arrays there). Inputs and
labels come from numpy with a seed; the labels put three boxes on the
grid and leave five cells empty, so every loss term runs.

Tolerances:
- fp32 ``output()``: 1e-4 of max|ref| (the raw wh outputs reach ~1e4,
  ``anchors * exp``; the last BNs normalize over 8 values a channel).
  Measured: 5e-6 of max|ref|.
- the loss against JAX ``score()``: 1e-5 relative (measured 2e-6).
- one Adam step in the fused fp32 mode: the first moments (0.1 x the
  gradient) within 2e-4 of each tensor's max|m|, the reference's
  gradient tolerance (measured <= 2.5e-5); the params within 2e-4
  wherever the two gradients differ by less than a tenth of the
  reference's. Adam's first step is ``lr * g / (|g| + eps')``, about
  ``lr * sign(g)``: where the gradient is within ten times the two
  packages' rounding distance of 0, the step may differ by more than
  ``lr / 10`` and even take the other sign (measured: 92 of 15.8M
  elements beyond 2e-4, all with |m| < 2e-6 of their tensor's max;
  2,515 elements, 1.6e-4 of the params, inside that distance). Those are
  held to ``2 * lr`` and may be at most 1e-3 of the params.
  The folded conv biases get an exact 0 gradient in both packages and
  are compared with the rest.
- bf16 / NHWC / fused ``output()`` against the JAX package's:
  relative L2 4e-3 (one bf16 rounding, 2^-8; the two packages round
  ``x*scale + shift`` at other places). Measured: 3.2e-5.
- same-mode pooling: fp32 1e-6, bf16 one ulp (2^-7 relative; the JAX
  average sums in bf16, the port in fp32).
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import MultiLayerConfiguration as JMLC
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.ops import convolution as jconv
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn import layers as tlayers
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import convolution as tconv
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.train import updaters as tupd

# the test workers share the CPU: keep torch's intra-op pool small
torch.set_num_threads(2)

N_CLASSES = 3
HW = 64
OUT_TOL = 1e-4
SCORE_TOL = 1e-5
FIT_TOL = 2e-4
LR = 1e-3
BF16_REL_L2 = 4e-3


@pytest.fixture(scope="module")
def yolo_init():
    """TinyYOLO's parameters and BN states from one JAX init, as numpy."""
    j = jzoo.TinyYOLO(num_classes=N_CLASSES, input_shape=(3, HW, HW)).init()
    return (jax.tree_util.tree_map(np.asarray, j._params),
            jax.tree_util.tree_map(np.asarray, j._states))


def _pair(init):
    """(JAX net, port net) holding the same parameters."""
    params, states = init
    j = jzoo.TinyYOLO(num_classes=N_CLASSES,
                      input_shape=(3, HW, HW)).conf_builder()
    j._params = jax.tree_util.tree_map(jnp.asarray, params)
    j._states = jax.tree_util.tree_map(jnp.asarray, states)
    j._initialized = True
    t = zoo.TinyYOLO(num_classes=N_CLASSES,
                     input_shape=(3, HW, HW)).conf_builder()
    t.params_from_jax(params, states, device="cpu")
    return j, t


def _data(seed=0, n=2):
    r = np.random.default_rng(seed)
    x = r.standard_normal((n, 3, HW, HW)).astype(np.float32)
    g = HW // 32
    y = np.zeros((n, 4 + N_CLASSES, g, g), np.float32)
    y[0, :4, 1, 1] = [1.1, 1.2, 1.9, 1.95]
    y[0, 4 + 1, 1, 1] = 1
    y[1, :4, 0, 0] = [0.1, 0.2, 0.5, 0.9]
    y[1, 4 + 0, 0, 0] = 1
    y[1, :4, 0, 1] = [1.0, 0.1, 1.9, 1.7]
    y[1, 4 + 2, 0, 1] = 1
    return x, y


def _configure(nets, *, bf16=False, layout="NCHW", fused=False):
    for net in nets:
        net.setPrecisionPolicy("bf16" if bf16 else None)
        net.setComputeLayout(layout)
        net.setEpilogueFusion(fused)


class TestTinyYolo:
    def test_builds_as_the_reference(self, yolo_init):
        j, t = _pair(yolo_init)
        assert len(t.layers) == len(j.layers) == 32
        assert [type(a).__name__ for a in t.layers] == \
            [type(a).__name__ for a in j.layers]
        assert t.numParams() == j.numParams() == 15_777_704
        np.testing.assert_array_equal(t.params().numpy(),
                                      np.asarray(j.params()))
        assert t.getLayer(30).nOut == j.getLayer(30).nOut == 40
        assert t.conf.layer_input_types[31].height == 2
        np.testing.assert_array_equal(t.getParam(27, "W").detach().numpy(),
                                      np.asarray(j.getParam(27, "W")))
        fresh = zoo.TinyYOLO(num_classes=N_CLASSES,
                             input_shape=(3, HW, HW)).init(device="cpu")
        assert fresh.numParams() == t.numParams()
        fresh.setParams(t.params())
        np.testing.assert_array_equal(fresh.params().numpy(),
                                      t.params().numpy())

    def test_fp32_output_matches_jax(self, yolo_init):
        j, t = _pair(yolo_init)
        x, _ = _data(1)
        want = np.asarray(j.output(x))
        got = t.output(x)
        assert got.shape == (2, 40, 2, 2) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=OUT_TOL * np.abs(want).max())
        acts = t.feedForward(x)
        assert len(acts) == 33
        np.testing.assert_allclose(acts[-1].numpy(), got.numpy(), rtol=0,
                                   atol=1e-6 * np.abs(want).max())

    def test_loss_matches_jax_score(self, yolo_init):
        j, t = _pair(yolo_init)
        x, y = _data(2)
        want = j.score(JDataSet(x, y))
        got = t.score(DataSet(x, y))
        assert np.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=SCORE_TOL)

    def test_epilogue_plan_matches_jax(self, yolo_init):
        j, t = _pair(yolo_init)
        _configure((j, t), fused=True)
        plan = t._ensure_epilogue_plan()
        assert plan == j._ensure_epilogue_plan()
        assert sorted(plan) == [0, 4, 8, 12, 16, 20, 24, 27]
        assert set(plan.values()) == {(3, True, 0.01)}
        # an input preprocessor inside a block stops its fusion; one at
        # the block's start does not
        for pre in ({1}, {2}, {4}, {5, 26}, {28, 29}):
            assert tlayers.build_epilogue_plan(t.layers, pre) == \
                jlayers.build_epilogue_plan(j.layers, pre), pre

    def test_fused_adam_step_matches_jax(self, yolo_init):
        j, t = _pair(yolo_init)
        _configure((j, t), fused=True)
        x, y = _data(3)
        j.fit(JDataSet(x, y))
        t.fit(DataSet(x, y))
        np.testing.assert_allclose(t.score(), j.score(), rtol=FIT_TOL)
        noisy = 0
        for i, (pj, pt) in enumerate(zip(j._params, t._params)):
            for k, v in pj.items():
                m_ref = np.asarray(j._opt_state[i][k]["m"])
                m_got = t._opt_state[i][k]["m"].numpy()
                bound = FIT_TOL * max(np.abs(m_ref).max(), 1e-30)
                np.testing.assert_allclose(m_got, m_ref, rtol=0, atol=bound,
                                           err_msg=f"layer {i} {k} moment")
                want = np.asarray(v)
                got = pt[k].detach().numpy()
                err = np.abs(got - want)
                # where the two gradients differ by a tenth of the
                # reference's or more, Adam's step may differ by more than
                # lr / 10 (and takes either sign near 0)
                near0 = np.abs(m_ref) <= 10 * np.abs(m_got - m_ref)
                noisy += int((near0 & (m_ref != 0)).sum())
                bad = (err > FIT_TOL + FIT_TOL * np.abs(want)) & ~near0
                assert not bad.any(), \
                    f"layer {i} {k}: {int(bad.sum())} params beyond {FIT_TOL}"
                assert (err[near0] <= 2 * LR + FIT_TOL).all(), (i, k)
            for k, v in j._states[i].items():
                np.testing.assert_allclose(t._states[i][k].numpy(),
                                           np.asarray(v), rtol=FIT_TOL,
                                           atol=FIT_TOL,
                                           err_msg=f"layer {i} state {k}")
        assert noisy <= 1e-3 * t.numParams()

    def test_bf16_nhwc_fused_forward_matches_jax(self, yolo_init):
        j, t = _pair(yolo_init)
        _configure((j, t), bf16=True, layout="NHWC", fused=True)
        x, _ = _data(4)
        want = np.asarray(j.output(x)).astype(np.float32)
        ck.install_platform_overrides()
        try:
            ck.reset_counts()
            got = t.output(x)
            assert ck.PLAIN_CALLS["scale_shift_act"] == 8
        finally:
            ck.uninstall_platform_overrides()
        assert got.dtype == torch.float32      # the output layer's island
        rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert rel < BF16_REL_L2, rel

    def test_bf16_fit_counts_the_epilogues(self, yolo_init):
        _j, t = _pair(yolo_init)
        _configure((t,), bf16=True, layout="NHWC", fused=True)
        x, y = _data(5)
        ck.install_platform_overrides()
        try:
            ck.reset_counts()
            t.fit(DataSet(x, y))
            assert ck.PLAIN_CALLS["scale_shift_act"] == 8
            assert ck.LAUNCHES["scale_shift_act"] == 0
        finally:
            ck.uninstall_platform_overrides()
        assert np.isfinite(t.score())

    def test_runs_on_the_card_unless_told(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            zoo.TinyYOLO(num_classes=2, input_shape=(3, 32, 32)).init()


# --------------------------------------------------- configuration JSON
def _small_list(conf, Lm, it, updater):
    return (conf.Builder().seed(5).weightInit("relu").l2(1e-4)
            .updater(updater).list()
            .layer(Lm.ConvolutionLayer(kernelSize=(3, 3), padding=(1, 1),
                                       nOut=6, activation="identity"))
            .layer(Lm.BatchNormalization())
            .layer(Lm.ActivationLayer("leakyrelu"))
            .layer(Lm.SubsamplingLayer(poolingType="max", kernelSize=(3, 3),
                                       stride=(2, 2), convolutionMode="same"))
            .layer(Lm.ConvolutionLayer(kernelSize=(1, 1), nOut=4,
                                       activation="relu"))
            .layer(Lm.GlobalPoolingLayer("avg"))
            .layer(Lm.OutputLayer(nOut=3, lossFunction="mcxent",
                                  activation="softmax"))
            .setInputType(it.convolutional(9, 9, 2)))


class TestMultiLayerConfiguration:
    def test_list_builder_propagates_types_as_jax(self):
        j = _small_list(JConf, jlayers, JInputType, jupd.Adam(1e-2)).build()
        t = _small_list(NeuralNetConfiguration, tlayers, InputType,
                        tupd.Adam(1e-2)).build()
        assert [(a.nIn, a.nOut) for a in t.layers] == \
            [(a.nIn, a.nOut) for a in j.layers]
        assert [it.to_config() for it in t.layer_input_types] == \
            [it.to_config() for it in j.layer_input_types]

    def test_json_crosses_both_ways(self):
        jconf = _small_list(JConf, jlayers, JInputType,
                            jupd.Adam(1e-2)).build()
        jnet = JMLN(jconf).init()
        t = MultiLayerNetwork(MultiLayerConfiguration.from_json(
            jconf.to_json()))
        t.params_from_jax(jnet._params, jnet._states, device="cpu")
        x = np.random.default_rng(6).standard_normal(
            (4, 2, 9, 9)).astype(np.float32)
        np.testing.assert_allclose(t.output(x).numpy(),
                                   np.asarray(jnet.output(x)), rtol=1e-5,
                                   atol=1e-6)
        back = JMLC.from_json(t.conf.to_json())
        assert json.loads(back.to_json()) == json.loads(jconf.to_json())

    def test_unported_pieces_raise_by_name(self):
        # a conv -> dense step takes its preprocessor (ported); ff input
        # into a conv refuses as the reference does
        conf = (NeuralNetConfiguration.Builder().list()
                .layer(tlayers.ConvolutionLayer(nOut=2))
                .layer(tlayers.DenseLayer(nOut=2))
                .setInputType(InputType.convolutional(4, 4, 1)).build())
        assert type(conf.preprocessors[1]).__name__ == "CnnToFeedForward"
        with pytest.raises(ValueError, match="convolutionalFlat"):
            (NeuralNetConfiguration.Builder().list()
             .layer(tlayers.ConvolutionLayer(nOut=2))
             .setInputType(InputType.feedForward(16)).build())
        with pytest.raises(NotImplementedError, match="'causal'"):
            (NeuralNetConfiguration.Builder().list()
             .layer(tlayers.ConvolutionLayer(nOut=2,
                                             convolutionMode="causal"))
             .setInputType(InputType.convolutional(4, 4, 1)).build())
        bad = json.loads(_small_list(JConf, jlayers, JInputType,
                                     jupd.Adam(1e-2)).build().to_json())
        # a SameDiffLayer's fragment is code, not configuration: neither
        # package rebuilds one from JSON (the JAX registry lacks it)
        bad["layers"][0]["@class"] = "SameDiffLayer"
        with pytest.raises(KeyError, match="SameDiffLayer"):
            MultiLayerConfiguration.from_json(json.dumps(bad))
        with pytest.raises(KeyError, match="SameDiffLayer"):
            JMLC.from_json(json.dumps(bad))


# ------------------------------------------------------ same-mode pooling
@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("size", [(13, 13), (8, 7)])
@pytest.mark.parametrize("k,s", [(2, 1), (2, 2), (3, 1), (3, 2)])
def test_same_mode_pooling_matches_jax(kind, dtype, layout, size, k, s):
    h, w = size
    shape = (2, 3, h, w) if layout == "NCHW" else (2, h, w, 3)
    x = np.random.default_rng(h * 10 + k + s).standard_normal(
        shape).astype(np.float32)
    jfn = jconv.maxpool2d if kind == "max" else jconv.avgpool2d
    tfn = tconv.maxpool2d if kind == "max" else tconv.avgpool2d
    # the explicit padding is ignored in same mode, as by XLA's SAME
    kw = dict(kernel=(k, k), stride=(s, s), pad=(1, 1), mode="same",
              data_format=layout)
    want = np.asarray(jfn(jnp.asarray(x, dtype), **kw).astype(jnp.float32))
    got = tfn(torch.from_numpy(x).to(getattr(torch, dtype)), **kw)
    assert str(got.dtype) == f"torch.{dtype}"
    oh, ow = -(-h // s), -(-w // s)
    assert tuple(got.shape) == ((2, 3, oh, ow) if layout == "NCHW"
                                else (2, oh, ow, 3))
    tol = 1e-6 if dtype == "float32" else 2.0 ** -7
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_same_mode_output_size_and_padding():
    for n in (1, 7, 13, 26, 416):
        for k in (1, 2, 3):
            for s in (1, 2, 3):
                assert tconv.conv_output_size(n, k, s, 1, 1, "same") == \
                    jconv.conv_output_size(n, k, s, 1, 1, "same")
    # TinyYOLO's sixth pool: 13 -> 13, padded (0, 1)
    assert tconv.same_padding(13, 2, 1) == (0, 1)
    assert tconv.same_padding(13, 3, 2) == (1, 1)
    # a same-mode convolution (ported with the 2-D ops) keeps ceil(n/s)
    assert tconv.conv2d(torch.zeros(1, 1, 4, 4), torch.zeros(1, 1, 3, 3),
                        stride=2, mode="same").shape == (1, 1, 2, 2)
    with pytest.raises(NotImplementedError, match="'causal'"):
        tconv.conv2d(torch.zeros(1, 1, 4, 4), torch.zeros(1, 1, 3, 3),
                     mode="causal")


def _dense_list(conf, Lm, it, updater):
    return (conf.Builder().seed(11).updater(updater).list()
            .layer(Lm.DenseLayer(nOut=6, activation="tanh"))
            .layer(Lm.OutputLayer(nOut=3, lossFunction="mcxent",
                                  activation="softmax"))
            .setInputType(it.feedForward(4)).build())


class TestAdamW:
    """AdamW's decoupled decay on the weights (``W*``/``RW*``), not on the
    biases (JAX multilayer.py:139-145): one step against the JAX step
    within FIT_TOL (the decay term, lr * wd * W ~ 1e-3, is well above
    it), and the worked example of one W=1, b=1 with g=0.5, lr 0.1,
    wd 0.5: W -> 0.85000075 (Adam's step 0.09999925 plus the decay 0.05),
    b -> 0.90000075."""

    LR, WD = 1e-2, 0.5

    def _fit(self, updater_j, updater_t):
        x = np.random.default_rng(4).standard_normal((8, 4)).astype(
            np.float32)
        y = np.eye(3, dtype=np.float32)[[0, 1, 2, 0, 1, 2, 0, 1]]
        j = JMLN(_dense_list(JConf, jlayers, JInputType, updater_j)).init()
        t = MultiLayerNetwork(_dense_list(NeuralNetConfiguration, tlayers,
                                          InputType, updater_t))
        t.params_from_jax(j._params, j._states, device="cpu")
        w0 = [{k: np.asarray(v) for k, v in p.items()} for p in j._params]
        j.fit(JDataSet(x, y))
        t.fit(DataSet(x, y))
        return j, t, w0

    def test_one_step_matches_jax(self):
        j, t, w0 = self._fit(jupd.AdamW(self.LR, weight_decay=self.WD),
                             tupd.AdamW(self.LR, weight_decay=self.WD))
        for i, p in enumerate(j._params):
            for k, v in p.items():
                np.testing.assert_allclose(
                    t._params[i][k].detach().numpy(), np.asarray(v),
                    rtol=FIT_TOL, atol=FIT_TOL, err_msg=f"layer {i} {k}")
        _, a, _ = self._fit(jupd.Adam(self.LR), tupd.Adam(self.LR))
        for i in range(2):
            assert torch.equal(t._params[i]["b"], a._params[i]["b"])
            d = (a._params[i]["W"] - t._params[i]["W"]).detach().numpy()
            np.testing.assert_allclose(d, self.LR * self.WD * w0[i]["W"],
                                       rtol=1e-6, atol=1e-6)

    def test_worked_example(self):
        t = MultiLayerNetwork(_dense_list(
            NeuralNetConfiguration, tlayers, InputType,
            tupd.AdamW(0.1, weight_decay=0.5))).init(device="cpu")
        w = torch.ones(1, requires_grad=True)
        b = torch.ones(1, requires_grad=True)
        t._opt_state = {0: {"W": tupd.Adam().init_state(w.detach()),
                            "b": tupd.Adam().init_state(b.detach())}}
        t._ensure_clock()
        t._process_and_apply_grads([(0, "W"), (0, "b")], [w, b],
                                   [torch.full((1,), 0.5)] * 2)
        assert float(w.detach()) == np.float32(0.85000075)
        assert float(b.detach()) == np.float32(0.90000075)
