"""The op math the Keras importer's layers need, against the JAX ops on
the CPU: every activation of ``ops/activations.py`` (and ``prelu``, the
``Activation`` enum, the importer's activation map), ``conv1d`` in its
three modes, ``conv3d``, the 1-D and 3-D max/avg pools, the causal
output size, ``multi_head_attention`` and the reference-layout
``dot_product_attention_ncw``, and the noise ops. Inputs come from the
JAX nn case table (``ops/validation.py`` ``_build_nn_cases``) where it
has them.

The noise ops draw from the port's counter hash, the JAX ones from
threefry, so the parity tests hand the port JAX's draws
(``dropout_mask`` and ``normal_draw`` replaced) and the draws themselves
are held to their moments.

Tolerances: fp32 forward 1e-5 (rtol and atol), gradients within 2e-4 of
each gradient's largest magnitude (tests/test_pallas.py's).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.modelimport import keras as jkeras
from deeplearning4j_tpu.ops import activations as jact
from deeplearning4j_tpu.ops import attention as jattn
from deeplearning4j_tpu.ops import convolution as jconv
from deeplearning4j_tpu.ops import losses as jloss
from deeplearning4j_tpu.ops import normalization as jnorm
from deeplearning4j_tpu.ops import registry as jreg
from deeplearning4j_tpu.ops import validation as jval
from deeplearning4j_tpu_torch.modelimport import keras as tkeras
from deeplearning4j_tpu_torch.ops import activations as tact
from deeplearning4j_tpu_torch.ops import attention as tattn
from deeplearning4j_tpu_torch.ops import convolution as tconv
from deeplearning4j_tpu_torch.ops import losses as tloss
from deeplearning4j_tpu_torch.ops import normalization as tnorm
from deeplearning4j_tpu_torch.ops import registry as treg

torch.set_num_threads(2)

FWD_TOL = 1e-5
GRAD_TOL = 2e-4
NN_CASES = {c.op: c for c in jval._build_nn_cases()}


def _case_args(op, seed=0):
    return NN_CASES[op].args(np.random.RandomState(seed))


def _close(got, want, tol=FWD_TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol,
                               atol=tol, err_msg=msg)


def _grads_close(tgrads, jgrads, names):
    for name, g, ref in zip(names, tgrads, jgrads):
        ref = np.asarray(ref)
        np.testing.assert_allclose(
            g.numpy(), ref, rtol=0,
            atol=GRAD_TOL * max(float(np.abs(ref).max()), 1e-30),
            err_msg=f"d/d{name}")


def _both(jfn, tfn, arrays, grad_idx=(0,), seed=7, zero_grads=()):
    """``jfn``/``tfn`` on the same arrays: outputs, then the gradients
    of ``sum(out * proj)`` with respect to ``grad_idx``. Those in
    ``zero_grads`` are zero in exact arithmetic and rounding noise in
    both packages: each is held below 1e-4 of the largest gradient."""
    want = jfn(*[jnp.asarray(a) for a in arrays])
    ts = [torch.from_numpy(np.array(a)).requires_grad_(i in grad_idx)
          for i, a in enumerate(arrays)]
    got = tfn(*ts)
    _close(got.detach(), want)
    proj = np.random.default_rng(seed).standard_normal(
        np.shape(want)).astype(np.float32)

    def jloss(*xs):
        full = [jnp.asarray(a) for a in arrays]
        for i, x in zip(grad_idx, xs):
            full[i] = x
        return jnp.sum(jfn(*full) * proj)
    jg = jax.grad(jloss, argnums=tuple(range(len(grad_idx))))(
        *[jnp.asarray(arrays[i]) for i in grad_idx])
    tg = torch.autograd.grad((got * torch.from_numpy(proj)).sum(),
                             [ts[i] for i in grad_idx])
    top = max(float(np.abs(np.asarray(g)).max()) for g in jg)
    for i, g, ref in zip(grad_idx, tg, jg):
        if i in zero_grads:
            assert float(g.abs().max()) < 1e-4 * top
            assert float(np.abs(np.asarray(ref)).max()) < 1e-4 * top
        else:
            _grads_close([g], [ref], [str(i)])


# -------------------------------------------------------------- activations
def _act_input():
    x = np.random.default_rng(0).standard_normal((5, 7)).astype(
        np.float32) * 3
    x[0, :6] = [0.0, 1.0, -1.0, 6.0, 2.5, -2.5]   # kinks and thresholds
    return x


@pytest.mark.parametrize("name", sorted(jact.ACTIVATIONS))
def test_activation_matches_jax(name):
    x = _act_input()
    if name in ("relu", "relu6", "leakyrelu", "hardtanh", "hardsigmoid",
                "thresholdedrelu", "rectifiedtanh"):
        x[0, :6] += 1e-3        # the kinks' subgradients differ by package
    _both(jact.get(name), tact.get(name), [x])


def test_activation_surface_and_enum_match_jax():
    assert sorted(tact.ACTIVATIONS) == sorted(jact.ACTIVATIONS)
    jenum = {k: v for k, v in vars(jact.Activation).items()
             if k.isupper()}
    tenum = {k: v for k, v in vars(tact.Activation).items()
             if k.isupper()}
    assert tenum == jenum
    assert tkeras._ACTIVATION_MAP == jkeras._ACTIVATION_MAP
    for name in jact.ACTIVATIONS:
        assert treg.has(name)


def test_prelu_matches_jax():
    x = _act_input()
    a = np.random.default_rng(1).random(7).astype(np.float32)
    _both(jact.prelu, tact.prelu, [x, a], grad_idx=(0, 1))


# ----------------------------------------------------------------- 1-D conv
@pytest.mark.parametrize("mode,stride,dilation", [
    ("truncate", 1, 1), ("truncate", 2, 1), ("truncate", 1, 2),
    ("same", 1, 1), ("same", 2, 1), ("same", 1, 2),
    ("causal", 1, 1), ("causal", 1, 2), ("causal", 2, 1)])
def test_conv1d_matches_jax(mode, stride, dilation):
    x, w = _case_args("conv1d")
    b = np.random.default_rng(2).standard_normal(4).astype(np.float32)
    kw = dict(stride=stride, pad=1 if mode == "truncate" else 0,
              dilation=dilation, mode=mode)
    _both(lambda x, w, b: jconv.conv1d(x, w, b, **kw),
          lambda x, w, b: tconv.conv1d(x, w, b, **kw), [x, w, b],
          grad_idx=(0, 1, 2))
    n = jconv.conv_output_size(10, 3, stride, kw["pad"], dilation, mode)
    assert tconv.conv_output_size(10, 3, stride, kw["pad"], dilation,
                                  mode) == n


def test_causal_conv1d_sees_no_later_step():
    x, w = _case_args("conv1d")
    xt = torch.from_numpy(x)
    base = tconv.conv1d(xt, torch.from_numpy(w), mode="causal")
    x2 = x.copy()
    x2[:, :, 6:] += 100.0
    moved = tconv.conv1d(torch.from_numpy(x2), torch.from_numpy(w),
                         mode="causal")
    assert torch.equal(base[:, :, :6], moved[:, :, :6])
    assert not torch.equal(base[:, :, 6:], moved[:, :, 6:])


def test_causal_stays_refused_in_2d_and_3d():
    with pytest.raises(NotImplementedError, match="'causal'"):
        tconv.conv3d(torch.zeros(1, 1, 4, 4, 4), torch.zeros(1, 1, 2, 2, 2),
                     mode="causal")
    with pytest.raises(ValueError, match="data_format"):
        tconv.conv1d(torch.zeros(1, 4, 2), torch.zeros(1, 2, 3),
                     data_format="NWC")


# ----------------------------------------------------------------- 3-D conv
@pytest.mark.parametrize("mode,stride,pad", [
    ("truncate", 1, 0), ("truncate", 2, 1), ("same", 1, 0),
    ("same", 2, 0)])
def test_conv3d_matches_jax(mode, stride, pad):
    x, w = _case_args("conv3d")
    b = np.random.default_rng(3).standard_normal(3).astype(np.float32)
    kw = dict(stride=stride, pad=pad, mode=mode)
    _both(lambda x, w, b: jconv.conv3d(x, w, b, **kw),
          lambda x, w, b: tconv.conv3d(x, w, b, **kw), [x, w, b],
          grad_idx=(0, 1, 2))


# -------------------------------------------------------------------- pools
@pytest.mark.parametrize("kind", ["max", "avg"])
@pytest.mark.parametrize("kernel,stride,pad,mode", [
    (2, 2, 0, "truncate"), (3, 1, 1, "truncate"), (3, 2, 0, "same"),
    (2, 1, 0, "same")])
def test_pool1d_matches_jax(kind, kernel, stride, pad, mode):
    x, _ = _case_args("conv1d")
    jfn = jconv.maxpool1d if kind == "max" else jconv.avgpool1d
    tfn = tconv.maxpool1d if kind == "max" else tconv.avgpool1d
    kw = dict(kernel=kernel, stride=stride, pad=pad, mode=mode)
    _both(lambda x: jfn(x, **kw), lambda x: tfn(x, **kw), [x])


@pytest.mark.parametrize("op", ["maxpool3dnew", "avgpool3dnew"])
@pytest.mark.parametrize("extra", [{}, {"pad": 1, "kernel": 3,
                                        "stride": 1}, {"mode": "same",
                                                       "kernel": 3}])
def test_pool3d_matches_jax(op, extra):
    (x,) = _case_args(op)
    kw = {**NN_CASES[op].kwargs, **extra}
    kind = op[:3]
    jfn = jconv.maxpool3d if kind == "max" else jconv.avgpool3d
    tfn = tconv.maxpool3d if kind == "max" else tconv.avgpool3d
    _both(lambda x: jfn(x, **kw), lambda x: tfn(x, **kw), [x])


# ---------------------------------------------------------------- attention
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("biased", [False, True])
def test_multi_head_attention_matches_jax(masked, biased):
    args = list(_case_args("multi_head_dot_product_attention"))
    r = np.random.default_rng(4)
    extra, names = [], []
    if biased:
        extra = [r.standard_normal(8).astype(np.float32) for _ in range(4)]
        names = ["bq", "bk", "bv", "bo"]
    mask = None
    if masked:
        mask = np.ones((2, 1, 1, 5), np.float32)
        mask[0, ..., 3:] = 0.0

    def call(mod, to):
        def fn(*a):
            kw = dict(zip(names, a[6:]))
            return mod.multi_head_attention(
                *a[:6], num_heads=2, **kw,
                mask=None if mask is None else to(mask))
        return fn
    # the key bias shifts every score of a query alike: no gradient
    _both(call(jattn, jnp.asarray), call(tattn, torch.from_numpy),
          args + extra, grad_idx=tuple(range(len(args) + len(extra))),
          zero_grads=(7,) if biased else ())


@pytest.mark.parametrize("masked", [False, True])
def test_dot_product_attention_ncw_matches_jax(masked):
    r = np.random.default_rng(5)
    q = r.standard_normal((2, 6, 4)).astype(np.float32)
    k = r.standard_normal((2, 6, 7)).astype(np.float32)
    v = r.standard_normal((2, 6, 7)).astype(np.float32)
    m = np.ones((2, 7), np.float32)
    m[1, 4:] = 0.0
    mk = m if masked else None
    _both(lambda q, k, v: jattn.dot_product_attention_ncw(
              q, k, v, mask=None if mk is None else jnp.asarray(mk)),
          lambda q, k, v: tattn.dot_product_attention_ncw(
              q, k, v, mask=None if mk is None else torch.from_numpy(mk)),
          [q, k, v], grad_idx=(0, 1, 2))


# -------------------------------------------------------------------- noise
@pytest.fixture
def jax_draws(monkeypatch):
    """The port's noise ops fed JAX's draws for a key: the bernoulli mask
    and the standard normals ``jax.random`` gives ``PRNGKey(seed)``."""
    def mask(key, shape, keep, device):
        return torch.from_numpy(np.array(jax.random.bernoulli(
            jax.random.PRNGKey(key.seed), keep, tuple(shape))))

    def normal(key, shape, device):
        return torch.from_numpy(np.array(jax.random.normal(
            jax.random.PRNGKey(key.seed), tuple(shape), jnp.float32)))
    monkeypatch.setattr(tnorm, "dropout_mask", mask)
    monkeypatch.setattr(tnorm, "normal_draw", normal)


@pytest.mark.parametrize("op,arg", [("alpha_dropout", 0.2),
                                    ("gaussian_dropout", 0.3),
                                    ("gaussian_noise", 0.5)])
def test_noise_op_matches_jax_on_its_draws(jax_draws, op, arg):
    x = np.random.default_rng(6).standard_normal((40, 30)).astype(
        np.float32)
    key = jax.random.PRNGKey(11)
    want = getattr(jnorm, op)(jnp.asarray(x), arg, key)
    got = getattr(tnorm, op)(torch.from_numpy(x), arg, tnorm.StepKey(11, 0))
    _close(got, want)
    # the registry's (key, x, rate) form, as the layers call it
    want_r = jreg.get(op)(key, jnp.asarray(x), arg)
    got_r = treg.get(op)(tnorm.StepKey(11, 0), torch.from_numpy(x), arg)
    _close(got_r, want_r)


@pytest.mark.parametrize("op", ["alpha_dropout", "gaussian_dropout",
                                "gaussian_noise"])
def test_noise_op_is_identity_outside_training(op):
    x = torch.randn(4, 5)
    assert getattr(tnorm, op)(x, 0.3, None, train=False) is x
    assert getattr(tnorm, op)(x, 0.0, tnorm.StepKey(0, 0)) is x


def test_noise_draws_have_their_moments_and_are_keyed():
    key = tnorm.StepKey(3, 5, (2,))
    z = tnorm.normal_draw(key, (400, 500), "cpu")
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1) < 0.01
    assert torch.equal(z, tnorm.normal_draw(key, (400, 500), "cpu"))
    assert not torch.equal(z, tnorm.normal_draw(key.fold(0), (400, 500),
                                                "cpu"))
    # the clock may be a device tensor, read at run time
    zt = tnorm.normal_draw(tnorm.StepKey(3, torch.tensor(5), (2,)),
                           (400, 500), "cpu")
    assert torch.equal(z, zt)
    x = torch.ones(400, 500)
    y = tnorm.gaussian_dropout(x, 0.2, key)
    assert abs(float(y.mean()) - 1) < 0.01
    assert abs(float(y.var()) - 0.25) < 0.01      # rate / (1 - rate)
    # alpha dropout keeps a standard normal's mean and variance
    a = tnorm.alpha_dropout(z, 0.1, key.fold(7))
    assert abs(float(a.mean())) < 0.02 and abs(float(a.var()) - 1) < 0.03
    alpha_p, keep = -1.7580993408473766, 0.9
    scale = (keep + alpha_p ** 2 * keep * (1 - keep)) ** -0.5
    at_drop = scale * alpha_p - scale * alpha_p * (1 - keep)
    dropped = float(((a - at_drop).abs() < 1e-6).float().mean())
    assert abs(dropped - 0.1) < 0.01


def test_gelu_is_the_tanh_form_keras_computes_the_exact_one():
    """Keras's "gelu" maps to DL4J's gelu (the tanh approximation) in
    both importers; the exact erf form Keras computes differs from it by
    at most 4.73e-4 (at |x| = 2.70, over [-10, 10] in fp64)."""
    x = torch.linspace(-10, 10, 2_000_001, dtype=torch.float64)
    d = (tact.gelu(x) - torch.nn.functional.gelu(x)).abs()
    assert 4.73e-4 < float(d.max()) < 4.74e-4
    assert abs(abs(float(x[d.argmax()])) - 2.70) < 0.01
    assert tkeras._ACTIVATION_MAP["gelu"] == "gelu"


# ------------------------------------- rms_norm, im2col, LossFunction
@pytest.mark.parametrize("axis,eps,gain", [(-1, 1e-6, True), (-1, 1e-3, False),
                                           (0, 1e-6, True)])
def test_rms_norm_matches_jax(axis, eps, gain):
    """The nn case table's ``rms_norm`` inputs (and a random gain),
    through both registries: outputs and gradients."""
    x, g = _case_args("rms_norm")
    g = np.random.default_rng(1).standard_normal(
        x.shape[axis]).astype(np.float32)
    if axis == 0:
        g = g[:, None]
    if gain:
        _both(lambda a, b: jreg.get("rms_norm")(a, b, axis=axis, eps=eps),
              lambda a, b: treg.get("rms_norm")(a, b, axis=axis, eps=eps),
              [x, g], grad_idx=(0, 1))
    else:
        _both(lambda a: jnorm.rms_norm(a, None, axis=axis, eps=eps),
              lambda a: tnorm.rms_norm(a, None, axis=axis, eps=eps), [x])
    golden = NN_CASES["rms_norm"].golden(*_case_args("rms_norm"))
    _close(tnorm.rms_norm(*[torch.from_numpy(a) for a in
                            _case_args("rms_norm")]), golden)


@pytest.mark.parametrize("kernel,stride,pad,dilation", [
    (2, 1, 0, 1), (3, 2, 1, 1), ((2, 3), (1, 2), (1, 0), 1), (2, 1, 1, 2)])
def test_im2col_matches_jax(kernel, stride, pad, dilation):
    """The nn case table's ``im2col`` input (and a wider one),
    [N, C, H, W] -> [N, C, kH, kW, oH, oW] equal to the JAX op, its
    gradient too."""
    x = _case_args("im2col")[0]
    wide = np.random.default_rng(2).standard_normal((2, 3, 7, 6)).astype(
        np.float32)
    for arr in (x, wide):
        _both(lambda a: jconv.im2col(a, kernel, stride, pad, dilation),
              lambda a: tconv.im2col(a, kernel, stride, pad, dilation),
              [arr])


def test_loss_function_names_match_jax():
    """``LossFunction``'s enum names and values are the JAX ones, and each
    value names a loss both packages know."""
    def names(cls):
        return {k: v for k, v in vars(cls).items() if k.isupper()}
    assert names(tloss.LossFunction) == names(jloss.LossFunction)
    for v in names(tloss.LossFunction).values():
        assert tloss.get(v) is tloss.LOSSES[v]
        assert v in jloss.LOSSES

