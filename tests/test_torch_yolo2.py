"""The port's YOLO2 (``zoo.YOLO2``: 21 conv-BN-leaky blocks, the
space-to-depth passthrough route, ``Yolo2OutputLayer`` with the COCO
anchors) against the JAX zoo's, at 64x64 with 4 classes (a 2x2 grid) on
the CPU.

One seeded init (the port's, at the full widths: 67,065,837 params)
gives both nets their weights: the JAX graph holds them as its params and
a fresh port graph takes them through ``params_from_jax``. (The JAX init
draws the same shapes and takes ~15 s on the CPU.) Inputs are zero-mean
images from numpy with a seed, labels ``yolo_labels`` on the 2x2 grid.

Tolerances:
- fp32 forward, the port in NHWC with fused epilogues against the JAX
  NCHW forward: 1e-5 relative to the largest output (``rtol`` and
  ``atol = 1e-5 * max|out|``): 22 convs of up to 9,216 products summed in
  another order; the wh outputs (anchors * exp) reach ~100 while the
  xy/conf/class outputs are below 1.
- bf16 / NHWC / fused against the JAX net so configured: relative L2
  2e-2, and no farther from the fp32 forward than the JAX bf16 forward
  is, plus a tenth. bf16 keeps 8 bits and the two packages' bf16 convs
  round in other places; over 22 convs that compounds (measured: each
  bf16 forward 1.5-1.6e-2 from the fp32 one, the two 1.2e-2 apart; the
  JAX package's own fused and unfused bf16 forwards are bit-equal).
- The train-mode loss: 2e-4 relative (the reference's gradient
  tolerance).
- One Adam step: the deep BNs normalize 8 values a channel (2x2 maps, 2
  images), where ``E[x^2] - E[x]^2`` in fp32 keeps few digits, each
  package's differently: measured here, the JAX package's own fused and
  unfused steps give first moments up to 27% apart (head_c's weights),
  the port's within 17% of the JAX one's. So the gradients are held
  where they agree: the output conv's first moments (past every BN)
  within 2e-4 of their largest; every param within 2e-4 of the JAX one
  but where the two first moments differ by a tenth of the JAX one's or
  more, where Adam's first step is about ``lr * sign(g)`` and the bound
  is ``2 * lr`` (tests/test_torch_zoo_mln.py's rule); the BN running
  statistics within 2e-4; the score within 2e-4.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu_torch import profile_fit
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn import layers as tlayers
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.objdetect import YoloUtils, yolo_labels
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(2)

FWD_TOL = 1e-5
FIT_TOL = 2e-4
BF16_REL_L2 = 2e-2
LR = 1e-3
HW, N_CLASSES, BATCH = 64, 4, 2
KW = dict(num_classes=N_CLASSES, input_shape=(3, HW, HW))
#: the 21 fused blocks, by their activation node
BLOCKS = ["c1", "c2", "p3a", "p3b", "p3c", "p4a", "p4b", "p4c", "s5a", "s5b",
          "s5c", "s5d", "s5e", "s6a", "s6b", "s6c", "s6d", "s6e", "det1",
          "det2", "head"]

_WEIGHTS = {}


def _weights():
    """The port's seeded init as numpy, once a module."""
    if not _WEIGHTS:
        net = zoo.YOLO2(**KW).init(device="cpu")
        _WEIGHTS["params"] = {n: {k: v.detach().numpy() for k, v in p.items()}
                              for n, p in net._params.items()}
        _WEIGHTS["states"] = {n: {k: v.numpy() for k, v in s.items()}
                              for n, s in net._states.items()}
    return _WEIGHTS["params"], _WEIGHTS["states"]


def _pair(layout="NCHW", fused=False, bf16=False):
    """(JAX YOLO2, port YOLO2) holding the same weights; the JAX net in
    NCHW unfused fp32 unless ``bf16`` (then both bf16 / NHWC / fused)."""
    params, states = _weights()
    j = jzoo.YOLO2(**KW).conf_builder()
    j._params = jax.tree_util.tree_map(jnp.asarray, params)
    j._states = jax.tree_util.tree_map(jnp.asarray, states)
    j._initialized = True
    t = zoo.YOLO2(**KW).conf_builder().params_from_jax(params, states,
                                                        device="cpu")
    t.setComputeLayout(layout)
    t.setEpilogueFusion(fused)
    if bf16:
        for net in (j, t):
            net.setPrecisionPolicy("bf16")
            net.setComputeLayout("NHWC")
            net.setEpilogueFusion(True)
    return j, t


def _data(seed):
    r = np.random.default_rng(seed)
    x = r.standard_normal((BATCH, 3, HW, HW)).astype(np.float32)
    return x, yolo_labels(r, BATCH, N_CLASSES, grid=HW // 32)


@pytest.fixture()
def torch_overrides():
    ck.install_platform_overrides()
    try:
        yield
    finally:
        ck.uninstall_platform_overrides()


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


class TestConfiguration:
    def test_builds_as_the_reference(self):
        j = jzoo.YOLO2(**KW).conf_builder()
        t = zoo.YOLO2(**KW).conf_builder()
        assert [(n.name, n.kind, type(n.obj).__name__, n.inputs)
                for n in t.conf.topo] == \
            [(n.name, n.kind, type(n.obj).__name__, n.inputs)
             for n in j.conf.topo]
        assert {k: dict(v.dims) for k, v in t.conf.types.items()} == \
            {k: dict(v.dims) for k, v in j.conf.types.items()}
        assert t.conf.types["passthrough"].dims == {"height": 2, "width": 2,
                                                    "channels": 2048}
        params, _ = _weights()
        for n in j.conf.topo:
            if n.kind == "layer":
                assert {k: tuple(v.shape) for k, v in params[n.name].items()} \
                    == {k: tuple(v) for k, v in n.obj.param_shapes().items()}
        assert sum(v.size for p in params.values() for v in p.values()) == \
            67_065_837

    def test_the_fused_plan_is_21_blocks_as_the_reference(self):
        j = jzoo.YOLO2(**KW).conf_builder()
        t = zoo.YOLO2(**KW).conf_builder()
        for net in (j, t):
            net.setEpilogueFusion(True)
        plan = t._ensure_epilogue_plan()
        assert plan == j._ensure_epilogue_plan()
        assert sorted(act for act, _c, _a in plan.values()) == sorted(BLOCKS)
        assert all(c == a[:-3] + "_c" and alpha == 0.01
                   for a, (_n, c, alpha) in plan.items())
        assert t._epilogue_shared == set()

    def test_full_configuration_counts(self):
        """The COCO configuration at 416^2: 13x13 grid, 425 channels, and
        the conv work of one forward (2 FLOP a MAC) that chip_smoke.py's
        MFU uses."""
        t = zoo.YOLO2().conf_builder()
        assert t.conf.types["conv_out"].dims == {"height": 13, "width": 13,
                                                 "channels": 425}
        assert sum(isinstance(n.obj, tlayers.ConvolutionLayer)
                   for n in t.conf.topo) == 22
        assert 34.9e9 < profile_fit.conv_flops(t) < 35.1e9


class TestForward:
    def test_fp32_nhwc_fused_matches_jax_nchw(self, torch_overrides):
        j, t = _pair("NHWC", fused=True)
        x, _ = _data(1)
        want = np.asarray(j.output(x))
        ck.reset_counts()
        got = t.output(x)
        assert ck.PLAIN_CALLS["scale_shift_act"] == 21
        assert got.shape == (BATCH, 5 * (5 + N_CLASSES), 2, 2)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=FWD_TOL,
                                   atol=FWD_TOL * float(np.abs(want).max()))
        nchw = _pair("NCHW")[1].output(x)
        np.testing.assert_allclose(nchw.numpy(), want, rtol=FWD_TOL,
                                   atol=FWD_TOL * float(np.abs(want).max()))
        objs = YoloUtils.getPredictedObjects(zoo.YOLO2.ANCHORS, got, 0.0)
        assert len(objs) == BATCH * 5 * 2 * 2

    def test_bf16_nhwc_fused_matches_jax(self, torch_overrides):
        j, t = _pair(bf16=True)
        x, _ = _data(2)
        got = t.output(x).numpy()
        want = np.asarray(j.output(x)).astype(np.float32)
        fp32 = np.asarray(_pair()[0].output(x))
        assert _rel_l2(got, want) < BF16_REL_L2
        assert _rel_l2(got, fp32) < 1.1 * _rel_l2(want, fp32)


class TestTraining:
    def test_loss_matches_jax(self):
        j, t = _pair("NHWC", fused=True)
        x, y = _data(3)
        key = jax.random.PRNGKey(0)
        want = j._loss_and_reg(j._params, j._states, {"input": jnp.asarray(x)},
                               [jnp.asarray(y)], True, key, None, None)[0]
        got, _ = t._loss_and_reg(t._params, t._states,
                                 {"input": torch.from_numpy(x)},
                                 [torch.from_numpy(y)], True, None)
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=FIT_TOL)

    def test_one_adam_step_matches_jax_where_gradients_agree(self):
        j, t = _pair("NHWC", fused=True)
        x, y = _data(4)
        j.fit(JDataSet(x, y))
        t.fit(DataSet(x, y))
        np.testing.assert_allclose(t.score(), j.score(), rtol=FIT_TOL)
        for k in ("W", "b"):
            m_ref = np.asarray(j._opt_state["conv_out"][k]["m"])
            np.testing.assert_allclose(
                t._opt_state["conv_out"][k]["m"].numpy(), m_ref, rtol=0,
                atol=FIT_TOL * float(np.abs(m_ref).max()))
        n_near = n_all = 0
        for n, pj in j._params.items():
            for k, v in pj.items():
                m_ref = np.asarray(j._opt_state[n][k]["m"])
                m_got = t._opt_state[n][k]["m"].numpy()
                want = np.asarray(v)
                err = np.abs(t._params[n][k].detach().numpy() - want)
                near0 = np.abs(m_ref) <= 10 * np.abs(m_got - m_ref)
                bad = (err > FIT_TOL + FIT_TOL * np.abs(want)) & ~near0
                assert not bad.any(), (n, k, int(bad.sum()))
                assert (err[near0] <= 2 * LR + FIT_TOL).all(), (n, k)
                n_near, n_all = n_near + int(near0.sum()), n_all + near0.size
            for k, v in j._states[n].items():
                np.testing.assert_allclose(t._states[n][k].numpy(),
                                           np.asarray(v), rtol=FIT_TOL,
                                           atol=FIT_TOL, err_msg=f"{n}.{k}")
        assert n_near < 0.1 * n_all      # measured 2.3% and 6.8%

    def test_bf16_fused_fit_eager_and_four_steps_a_dispatch(
            self, torch_overrides):
        """The chip's configuration at 64^2: 21 epilogues a step; two
        single steps and one dispatch of two from the same state agree
        to the bit (the CPU runs the megastep eagerly); finite scores."""
        _, a = _pair(bf16=True)
        b = ComputationGraph(a.conf).params_from_jax(*_weights(),
                                                     device="cpu")
        b.setPrecisionPolicy("bf16")
        b.setEpilogueFusion(True)
        assert b._compute_layout == "NHWC"
        x, y = _data(5)
        ck.reset_counts()
        a.fit([DataSet(x, y)] * 2)
        assert ck.PLAIN_CALLS["scale_shift_act"] == 2 * 21
        b.fit([DataSet(x, y)] * 2, steps_per_dispatch=2)
        assert np.isfinite(a.score()) and a.score() == b.score()
        for n in a._params:
            for k in a._params[n]:
                assert torch.equal(a._params[n][k], b._params[n][k]), (n, k)
