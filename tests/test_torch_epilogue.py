"""The port's fused conv epilogue (``scale_shift_act``) and the CNN ops
under it, against the JAX package (CPU).

On the CPU the kernel's wrapper takes its plain PyTorch version; that is
held here against the Pallas kernel itself, run under the Pallas
interpreter (``make_scale_shift_act_override(interpret=True)``, as
tests/test_devicetime.py runs it), and against the JAX generic op.
Inputs come from numpy with a seed.

Tolerances:
- fp32: 1e-6 (rtol and atol) forward, 1e-5 gradients: the same fp32
  arithmetic, with the channel sums of the gradient in another order.
- bf16: 1 ulp. The JAX kernel rounds ``x*scale`` to bf16 before adding
  the shift, the port's kernel rounds once at the end, so the ulp is
  that of the larger of |x*scale| and |y|.
- The ops: 1e-5 (conv 2e-5: sums of 27 products in another order).

The CUDA kernel itself is held against its plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops import convolution as jconv
from deeplearning4j_tpu.ops import losses as jloss
from deeplearning4j_tpu.ops import normalization as jnorm
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.ops import convolution as tconv
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import losses as tloss
from deeplearning4j_tpu_torch.ops import normalization as tnorm
from deeplearning4j_tpu_torch.ops import registry as treg

# the test workers share the CPU: keep torch's intra-op pool small
torch.set_num_threads(2)

FP32_FWD = 1e-6
FP32_GRAD = 1e-5
OP_TOL = 1e-5
CONV_TOL = 2e-5
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy().astype(np.float64)
    return np.asarray(a).astype(np.float64)


def _bf16_ulp(v):
    """The spacing of bf16 numbers at |v| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(v), 1e-30)))
    return 2.0 ** (e - 7)


def _assert_bf16_within_ulp(got, want, ref_mag=None):
    got, want = _np(got), _np(want)
    mag = np.abs(want) if ref_mag is None else np.maximum(np.abs(want),
                                                          ref_mag)
    err = np.abs(got - want)
    bad = err > _bf16_ulp(mag)
    assert not bad.any(), (f"{int(bad.sum())} element(s) beyond 1 bf16 ulp, "
                           f"max |err| {err.max():.3g}")


def _inputs(seed, shape, c):
    r = _rng(seed)
    return (r.standard_normal(shape).astype(np.float32),
            r.standard_normal(c).astype(np.float32),
            r.standard_normal(c).astype(np.float32))


@pytest.fixture()
def torch_overrides():
    ck.install_platform_overrides()
    try:
        yield
    finally:
        ck.uninstall_platform_overrides()


# ------------------------------------------------------------ the kernel
class TestScaleShiftAct:
    @pytest.mark.parametrize("alpha", [0.0, 0.01])
    @pytest.mark.parametrize("tdt,jdt", DTYPES)
    def test_plain_matches_pallas(self, tdt, jdt, alpha):
        x, sc, sh = _inputs(1, (32, 128), 128)
        pallas = pk.make_scale_shift_act_override(interpret=True)
        want = pallas(jnp.asarray(x, jdt), jnp.asarray(sc), jnp.asarray(sh),
                      alpha=alpha, axis=1)
        xt = _t(x, tdt)
        got = ck.scale_shift_act_plain(xt, _t(sc, tdt), _t(sh, tdt), alpha)
        assert got.dtype == tdt
        if tdt == torch.float32:
            np.testing.assert_allclose(_np(got), _np(want), rtol=FP32_FWD,
                                       atol=FP32_FWD)
        else:
            prod = np.abs(_np(xt) * _np(_t(sc, tdt)))
            _assert_bf16_within_ulp(got, want, prod)

    @pytest.mark.parametrize("alpha", [0.0, 0.01])
    @pytest.mark.parametrize("tdt,jdt", DTYPES)
    def test_override_and_backward_match_pallas(self, torch_overrides, tdt,
                                                jdt, alpha):
        x, sc, sh = _inputs(2, (32, 128), 128)
        ct = _rng(3).standard_normal((32, 128)).astype(np.float32)
        pallas = pk.make_scale_shift_act_override(interpret=True)
        jx, jsc, jsh = (jnp.asarray(a, jdt) for a in (x, sc, sh))
        want, vjp = jax.vjp(
            lambda a, b, c: pallas(a, b, c, alpha=alpha, axis=1), jx, jsc, jsh)
        wdx, wds, wdh = vjp(jnp.asarray(ct, jdt))

        ck.reset_counts()
        xt, st, ht = (_t(a, tdt).requires_grad_(True) for a in (x, sc, sh))
        y = treg.get("scale_shift_act")(xt, st, ht, alpha=alpha, axis=1)
        assert ck.PLAIN_CALLS["scale_shift_act"] == 1
        assert ck.LAUNCHES["scale_shift_act"] == 0
        np.testing.assert_array_equal(
            _np(y), _np(ck.scale_shift_act_plain(xt.detach(), st.detach(),
                                                 ht.detach(), alpha)))
        dx, ds, dh = torch.autograd.grad(y, (xt, st, ht), _t(ct, tdt))
        if tdt == torch.float32:
            np.testing.assert_allclose(_np(y), _np(want), rtol=FP32_FWD,
                                       atol=FP32_FWD)
            for g, w in ((dx, wdx), (ds, wds), (dh, wdh)):
                np.testing.assert_allclose(_np(g), _np(w), rtol=FP32_GRAD,
                                           atol=FP32_GRAD)
        else:
            prod = np.abs(_np(xt) * _np(st))
            _assert_bf16_within_ulp(y, want, prod)
            for g, w in ((dx, wdx), (ds, wds), (dh, wdh)):
                assert g.dtype == torch.bfloat16
                _assert_bf16_within_ulp(g, w)

    def test_relu_slope_at_zero_is_one(self, torch_overrides):
        # the kernel path's backward takes y >= 0 as the positive side
        # (pallas_kernels.py:257); the generic op's relu has slope 0 there
        x = torch.tensor([[0.0, 1.0], [-1.0, 2.0]], requires_grad=True)
        one, zero = torch.ones(2), torch.zeros(2)
        y = treg.get("scale_shift_act")(x, one, zero, alpha=0.0, axis=1)
        (gk,) = torch.autograd.grad(y.sum(), x)
        y = tnorm.scale_shift_act(x, one, zero, alpha=0.0, axis=1)
        (gg,) = torch.autograd.grad(y.sum(), x)
        assert gk[0, 0] == 1.0 and gg[0, 0] == 0.0
        assert torch.equal(gk[1], torch.tensor([0.0, 1.0]))

    @pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
    def test_plain_keeps_nan_and_clamps_inf(self, tdt):
        x = torch.tensor([[float("nan"), float("-inf"), -2.0, 3.0]], dtype=tdt)
        one, zero = torch.ones(4, dtype=tdt), torch.zeros(4, dtype=tdt)
        y = ck.scale_shift_act_plain(x, one, zero, 0.0).float()
        assert torch.isnan(y[0, 0]) and y[0, 1] == 0.0 and y[0, 2] == 0.0
        y = ck.scale_shift_act_plain(x, one, zero, 0.01).float()
        assert torch.isnan(y[0, 0]) and y[0, 1] == float("-inf")
        want = float(torch.tensor(0.01, dtype=tdt)) * -2.0
        assert abs(float(y[0, 2]) - want) <= abs(want) * 2.0 ** -7

    @pytest.mark.parametrize("tdt,jdt", DTYPES)
    def test_c64_takes_the_kernel_where_jax_takes_its_generic(
            self, torch_overrides, tdt, jdt):
        # C=64 (ResNet-50's stem and stage 0) is outside the TPU gate
        # (C % 128) and inside the port's
        x, sc, sh = _inputs(4, (2, 5, 5, 64), 64)
        assert not pk.epilogue_supported(jnp.asarray(x, jdt), 3)
        want = jnorm.scale_shift_act(jnp.asarray(x, jdt), jnp.asarray(sc),
                                     jnp.asarray(sh), alpha=0.0, axis=3)
        ck.reset_counts()
        xt = _t(x, tdt)
        got = treg.get("scale_shift_act")(xt, _t(sc), _t(sh), alpha=0.0,
                                          axis=3)
        assert ck.PLAIN_CALLS["scale_shift_act"] == 1
        if tdt == torch.float32:
            np.testing.assert_allclose(_np(got), _np(want), rtol=FP32_FWD,
                                       atol=FP32_FWD)
        else:
            prod = np.abs(_np(xt) * _np(_t(sc, tdt)))
            _assert_bf16_within_ulp(got, want, prod)

    @pytest.mark.parametrize("alpha", [0.0, 0.01])
    def test_nchw_takes_the_generic_op(self, torch_overrides, alpha):
        x, sc, sh = _inputs(5, (4, 8, 3, 3), 8)
        ck.reset_counts()
        xt = _t(x).requires_grad_(True)
        got = treg.get("scale_shift_act")(xt, _t(sc), _t(sh), alpha=alpha,
                                          axis=1)
        assert ck.PLAIN_CALLS["scale_shift_act"] == 0
        jx = jnp.asarray(x)
        want = jnorm.scale_shift_act(jx, jnp.asarray(sc), jnp.asarray(sh),
                                     alpha=alpha, axis=1)
        np.testing.assert_allclose(_np(got), _np(want), rtol=FP32_FWD,
                                   atol=FP32_FWD)
        (g,) = torch.autograd.grad((got ** 2).sum(), xt)
        wg = jax.grad(lambda a: jnp.sum(jnorm.scale_shift_act(
            a, jnp.asarray(sc), jnp.asarray(sh), alpha=alpha, axis=1) ** 2))(jx)
        np.testing.assert_allclose(_np(g), _np(wg), rtol=FP32_GRAD,
                                   atol=FP32_GRAD)

    def test_strided_view_takes_the_generic_op_without_a_copy(
            self, torch_overrides):
        x = _t(_rng(6).standard_normal((4, 6, 6, 16))).permute(0, 2, 1, 3)
        assert not x.is_contiguous()
        ck.reset_counts()
        treg.get("scale_shift_act")(x, torch.ones(16), torch.zeros(16),
                                    alpha=0.0, axis=3)
        assert ck.PLAIN_CALLS["scale_shift_act"] == 0

    def test_gate_contains_the_jax_gate(self):
        for rows in (8, 16, 100, 1024):
            for c in (64, 128, 256, 512, 4096, 8192):
                for tdt, jdt in DTYPES:
                    jx = jax.ShapeDtypeStruct((rows, c), jdt)
                    tx = torch.empty((rows, c), dtype=tdt, device="meta")
                    if pk.epilogue_supported(jx, 1):
                        assert ck.scale_shift_act_supported(tx, 1)
        assert ck.scale_shift_act_supported(torch.zeros((7, 33)), 1)
        assert not ck.scale_shift_act_supported(torch.zeros((4, 8, 3)), 1)
        assert not ck.scale_shift_act_supported(
            torch.zeros((4, 8), dtype=torch.float16), 1)
        assert not ck.scale_shift_act_supported(torch.zeros((4, 8192)), 1)

    def test_wrapper_raises_off_cpu_without_kernel(self):
        x = torch.empty((4, 8), device="meta")
        with pytest.raises(RuntimeError, match="no kernel"):
            ck.scale_shift_act_fwd(x, torch.ones(8), torch.zeros(8))

    def test_each_library_binds_by_name(self):
        assert ck._lib_path("scale_shift_act") != ck._lib_path("layer_norm")
        with pytest.raises(KeyError, match="no binding"):
            ck._bind("no_such_kernel", None)

    def test_install_and_uninstall(self):
        ck.install_platform_overrides()
        try:
            assert treg.get("scale_shift_act") is not tnorm.scale_shift_act
        finally:
            ck.uninstall_platform_overrides()
        assert treg.get("scale_shift_act") is tnorm.scale_shift_act


# --------------------------------------------------------------- the ops
class TestCnnOps:
    @pytest.mark.parametrize("stride,pad", [(1, 1), (2, 3), (2, 0)])
    @pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
    def test_conv2d(self, stride, pad, fmt):
        r = _rng(7)
        x = r.standard_normal((2, 3, 9, 9)).astype(np.float32)
        w = r.standard_normal((5, 3, 3, 3)).astype(np.float32)
        b = r.standard_normal(5).astype(np.float32)
        xin = x if fmt == "NCHW" else x.transpose(0, 2, 3, 1).copy()
        got = tconv.conv2d(_t(xin), _t(w), _t(b), stride=stride, pad=pad,
                           data_format=fmt)
        want = jconv.conv2d(jnp.asarray(xin), jnp.asarray(w), jnp.asarray(b),
                            stride=stride, pad=pad, data_format=fmt)
        assert got.shape == want.shape
        np.testing.assert_allclose(_np(got), _np(want), rtol=CONV_TOL,
                                   atol=CONV_TOL)
        if fmt == "NHWC":
            assert got.is_contiguous()      # channels-minor, no copy back

    @pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
    def test_maxpool_with_padding_and_avgpool_count(self, fmt):
        x = _rng(8).standard_normal((2, 4, 7, 7)).astype(np.float32) - 3.0
        xin = x if fmt == "NCHW" else x.transpose(0, 2, 3, 1).copy()
        for tf, jf in ((tconv.maxpool2d, jconv.maxpool2d),
                       (tconv.avgpool2d, jconv.avgpool2d)):
            got = tf(_t(xin), kernel=3, stride=2, pad=1, data_format=fmt)
            want = jf(jnp.asarray(xin), kernel=3, stride=2, pad=1,
                      data_format=fmt)
            np.testing.assert_allclose(_np(got), _np(want), rtol=OP_TOL,
                                       atol=OP_TOL)

    @pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
    def test_global_avg_pool(self, fmt):
        x = _rng(9).standard_normal((3, 5, 4, 6)).astype(np.float32)
        got = tconv.global_pool(_t(x), "avg", data_format=fmt)
        want = jconv.global_pool(jnp.asarray(x), "avg", data_format=fmt)
        np.testing.assert_allclose(_np(got), _np(want), rtol=OP_TOL,
                                   atol=OP_TOL)

    def test_conv_output_size(self):
        for args in ((224, 7, 2, 3), (56, 1, 2, 0), (112, 3, 2, 1)):
            assert tconv.conv_output_size(*args) == \
                jconv.conv_output_size(*args)
        with pytest.raises(ValueError):
            tconv.conv_output_size(2, 5, 1, 0)

    @pytest.mark.parametrize("axis", [1, 3])
    def test_batch_norm_train_and_running_stats(self, axis):
        r = _rng(10)
        x = (r.standard_normal((4, 6, 5, 6)) * 2 + 1.5).astype(np.float32)
        c = x.shape[axis]
        g = (r.standard_normal(c) * 0.5 + 1).astype(np.float32)
        b = r.standard_normal(c).astype(np.float32)
        rm = r.standard_normal(c).astype(np.float32)
        rv = (r.random(c) + 0.5).astype(np.float32)
        xt = _t(x).requires_grad_(True)
        out, m, v = tnorm.batch_norm_train(xt, _t(g), _t(b), _t(rm), _t(rv),
                                           decay=0.9, axis=axis)
        wout, wm, wv = jnorm.batch_norm_train(
            jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), jnp.asarray(rm),
            jnp.asarray(rv), decay=0.9, axis=axis)
        for got, want in ((out, wout), (m, wm), (v, wv)):
            np.testing.assert_allclose(_np(got), _np(want), rtol=OP_TOL,
                                       atol=OP_TOL)
        (gx,) = torch.autograd.grad((out ** 3).sum(), xt)
        wgx = jax.grad(lambda a: jnp.sum(jnorm.batch_norm_train(
            a, jnp.asarray(g), jnp.asarray(b), jnp.asarray(rm),
            jnp.asarray(rv), axis=axis)[0] ** 3))(jnp.asarray(x))
        np.testing.assert_allclose(_np(gx), _np(wgx), rtol=FP32_GRAD,
                                   atol=FP32_GRAD)

    def test_batch_norm_inference(self):
        r = _rng(11)
        x = r.standard_normal((3, 4, 2, 2)).astype(np.float32)
        g, b, m = (r.standard_normal(4).astype(np.float32) for _ in range(3))
        v = (r.random(4) + 0.1).astype(np.float32)
        got = tnorm.batch_norm(_t(x), _t(g), _t(b), _t(m), _t(v))
        want = jnorm.batch_norm(*(jnp.asarray(a) for a in (x, g, b, m, v)))
        np.testing.assert_allclose(_np(got), _np(want), rtol=OP_TOL,
                                   atol=OP_TOL)

    def test_mcxent_value_and_gradient(self):
        r = _rng(12)
        logits = (r.standard_normal((6, 5)) * 3).astype(np.float32)
        logits[0, 0] = 40.0       # a probability below the clip
        y = np.eye(5, dtype=np.float32)[r.integers(0, 5, 6)]
        y[0] = np.eye(5, dtype=np.float32)[1]
        lt = _t(logits).requires_grad_(True)
        loss = tloss.mcxent(_t(y), torch.softmax(lt, dim=-1))

        def jl(z):
            return jloss.mcxent(jnp.asarray(y), jax.nn.softmax(z, axis=-1))

        wl, wg = jax.value_and_grad(jl)(jnp.asarray(logits))
        np.testing.assert_allclose(float(loss.detach()), float(wl), rtol=OP_TOL)
        (g,) = torch.autograd.grad(loss, lt)
        np.testing.assert_allclose(_np(g), _np(wg), rtol=FP32_GRAD,
                                   atol=FP32_GRAD)
        assert tloss.get("MCXENT") is tloss.mcxent
