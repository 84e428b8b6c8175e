"""The port's 2-D conv ops and the layers over them against the JAX
package (CPU): same-mode and grouped ``conv2d``, ``deconv2d``,
``depthwise_conv2d`` / ``separable_conv2d``, ``upsampling2d``,
``space_to_depth`` / ``depth_to_space``, ``zero_padding2d`` /
``cropping2d``, ``pnormpool2d`` and ``lrn``; then the layers
(LocalResponseNormalization, Deconvolution2D, DepthwiseConvolution2D,
SeparableConvolution2D, SpatialDropoutLayer, ZeroPaddingLayer,
Upsampling2D, Cropping2D, pnorm SubsamplingLayer) in both layouts and
through their JSON.

Inputs, weights and output cotangents come from numpy with a seed; each
case runs the forward and the vector-Jacobian product of the same
cotangent on both sides.

Tolerances (tests/test_pallas.py's): fp32 forward 1e-5 (rtol and atol),
gradients 2e-4. Permutations and paddings (space-to-depth, zero padding,
cropping, upsampling's forward) are exact.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.ops import convolution as jconv
from deeplearning4j_tpu.ops import normalization as jnorm
from deeplearning4j_tpu_torch.nn import layers as tlayers
from deeplearning4j_tpu_torch.nn.config import InputType
from deeplearning4j_tpu_torch.ops import convolution as tconv
from deeplearning4j_tpu_torch.ops import normalization as tnorm

torch.set_num_threads(2)

FWD_TOL = 1e-5
GRAD_TOL = 2e-4
LAYOUTS = ["NCHW", "NHWC"]


def _nhwc(shape, layout):
    n, c, h, w = shape
    return shape if layout == "NCHW" else (n, h, w, c)


def _vjp_both(jfn, tfn, arrays, seed=0, exact=False):
    """Forward and VJP of one cotangent through ``jfn`` (jnp arrays) and
    ``tfn`` (torch tensors), held at the file's tolerances."""
    want, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in arrays])
    ct = np.random.default_rng(seed + 99).standard_normal(
        want.shape).astype(np.float32)
    want_g = vjp(jnp.asarray(ct))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    got = tfn(*ts)
    assert tuple(got.shape) == tuple(want.shape)
    tol = 0.0 if exact else FWD_TOL
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)
    got_g = torch.autograd.grad(got, ts, torch.from_numpy(ct))
    for i, (g, w) in enumerate(zip(got_g, want_g)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"grad {i}")


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ------------------------------------------------------------------- conv2d
@pytest.mark.parametrize("k,s,d,layout", [
    (1, 1, 1, "NCHW"), (2, 1, 1, "NHWC"), (3, 1, 1, "NCHW"),
    (3, 2, 1, "NHWC"), (2, 2, 1, "NCHW"), (4, 3, 1, "NCHW"),
    (3, 1, 2, "NHWC"), (2, 2, 2, "NCHW")])
def test_conv2d_same_mode_matches_jax(layout, k, s, d):
    """XLA's SAME: ceil(n/s) outputs, the odd pad after."""
    rng = np.random.default_rng(k * 100 + s * 10 + d)
    x = _randn(rng, *_nhwc((2, 3, 9, 8), layout))
    w = _randn(rng, 4, 3, k, k)
    b = _randn(rng, 4)
    kw = dict(stride=s, dilation=d, pad=5, mode="same", data_format=layout)
    _vjp_both(lambda x, w, b: jconv.conv2d(x, w, b, **kw),
              lambda x, w, b: tconv.conv2d(x, w, b, **kw), [x, w, b])


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mode", ["truncate", "same"])
def test_grouped_conv2d_matches_jax(layout, mode):
    rng = np.random.default_rng(5)
    x = _randn(rng, *_nhwc((2, 6, 7, 7), layout))
    w = _randn(rng, 9, 2, 3, 3)
    kw = dict(stride=2, pad=1, mode=mode, data_format=layout, groups=3)
    _vjp_both(lambda x, w: jconv.conv2d(x, w, **kw),
              lambda x, w: tconv.conv2d(x, w, **kw), [x, w])


# ----------------------------------------------------------------- deconv2d
@pytest.mark.parametrize("mode", ["truncate", "same"])
@pytest.mark.parametrize("k,s,p,layout", [
    (2, 2, 0, "NCHW"), (3, 2, 1, "NHWC"), (4, 2, 1, "NCHW"),
    (3, 1, 1, "NCHW"), (1, 3, 0, "NHWC"), (5, 3, 2, "NCHW")])
def test_deconv2d_matches_jax(layout, mode, k, s, p):
    """The output size and the crop of both modes, and the weight's
    [O, I, kH, kW] against ``F.conv_transpose2d``'s [I, O, kH, kW]."""
    rng = np.random.default_rng(k * 100 + s * 10 + p)
    x = _randn(rng, *_nhwc((2, 3, 5, 6), layout))
    w = _randn(rng, 4, 3, k, k)
    b = _randn(rng, 4)
    kw = dict(stride=s, pad=p, mode=mode, data_format=layout)
    _vjp_both(lambda x, w, b: jconv.deconv2d(x, w, b, **kw),
              lambda x, w, b: tconv.deconv2d(x, w, b, **kw), [x, w, b])


# ------------------------------------------------- depthwise and separable
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("mult", [1, 2, 3])
@pytest.mark.parametrize("mode,s", [("truncate", 2), ("same", 1)])
def test_depthwise_conv2d_matches_jax(layout, mult, mode, s):
    """mult > 1 pins the output channel order c*mult + m."""
    rng = np.random.default_rng(mult * 10 + s)
    x = _randn(rng, *_nhwc((2, 4, 7, 6), layout))
    w = _randn(rng, mult, 4, 3, 3)
    b = _randn(rng, 4 * mult)
    kw = dict(stride=s, pad=1, mode=mode, data_format=layout)
    _vjp_both(lambda x, w, b: jconv.depthwise_conv2d(x, w, b, **kw),
              lambda x, w, b: tconv.depthwise_conv2d(x, w, b, **kw),
              [x, w, b])


@pytest.mark.parametrize("mult", [1, 2])
@pytest.mark.parametrize("k,s,p,d,layout", [(3, 1, 1, 1, "NHWC"),
                                            (5, 2, 2, 1, "NCHW"),
                                            (3, 1, 2, 2, "NCHW")])
def test_separable_conv2d_matches_jax(layout, mult, k, s, p, d):
    rng = np.random.default_rng(k + s + p + mult)
    x = _randn(rng, *_nhwc((2, 3, 8, 8), layout))
    wd = _randn(rng, mult, 3, k, k)
    wp = _randn(rng, 5, 3 * mult, 1, 1)
    b = _randn(rng, 5)
    kw = dict(stride=s, pad=p, dilation=d, data_format=layout)
    _vjp_both(lambda x, wd, wp, b: jconv.separable_conv2d(x, wd, wp, b, **kw),
              lambda x, wd, wp, b: tconv.separable_conv2d(x, wd, wp, b, **kw),
              [x, wd, wp, b])


# --------------------------------------------------------------- resampling
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("scale", [2, 3, (2, 3)])
def test_upsampling2d_matches_jax(layout, scale):
    x = _randn(np.random.default_rng(3), *_nhwc((2, 3, 4, 5), layout))
    _vjp_both(lambda x: jconv.upsampling2d(x, scale, data_format=layout),
              lambda x: tconv.upsampling2d(x, scale, data_format=layout),
              [x], exact=True)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("block", [2, 3])
@pytest.mark.parametrize("op", ["space_to_depth", "depth_to_space"])
def test_space_depth_moves_match_jax(layout, block, op):
    """Exact: the channel order is (bh, bw, c), not pixel_unshuffle's."""
    shape = (2, 3, 6, 12) if op == "space_to_depth" else \
        (2, 3 * block * block, 2, 3)
    x = _randn(np.random.default_rng(block), *_nhwc(shape, layout))
    _vjp_both(lambda x: getattr(jconv, op)(x, block, data_format=layout),
              lambda x: getattr(tconv, op)(x, block, data_format=layout),
              [x], exact=True)


def test_space_to_depth_is_not_pixel_unshuffle():
    """The passthrough's order: output channel (bh*b + bw)*C + c."""
    x = torch.arange(2 * 4 * 4, dtype=torch.float32).reshape(1, 2, 4, 4)
    y = tconv.space_to_depth(x, 2)
    for bh in range(2):
        for bw in range(2):
            for c in range(2):
                assert torch.equal(y[0, (bh * 2 + bw) * 2 + c],
                                   x[0, c, bh::2, bw::2])
    assert not torch.equal(y, torch.nn.functional.pixel_unshuffle(x, 2))
    assert torch.equal(tconv.depth_to_space(y, 2), x)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("edges", [1, (2, 1), ((1, 2), (0, 3))])
@pytest.mark.parametrize("op", ["zero_padding2d", "cropping2d"])
def test_padding_and_cropping_match_jax(layout, edges, op):
    x = _randn(np.random.default_rng(7), *_nhwc((2, 3, 7, 8), layout))
    _vjp_both(lambda x: getattr(jconv, op)(x, edges, data_format=layout),
              lambda x: getattr(tconv, op)(x, edges, data_format=layout),
              [x], exact=True)


# ------------------------------------------------------------- pnorm pooling
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("p", [2, 3])
@pytest.mark.parametrize("k,s,pad,mode", [(3, 2, 1, "truncate"),
                                          (3, 1, 0, "same"),
                                          (2, 2, 0, "same")])
def test_pnormpool2d_matches_jax(layout, p, k, s, pad, mode):
    x = _randn(np.random.default_rng(p * 7 + k), *_nhwc((2, 3, 7, 6), layout))
    kw = dict(kernel=k, stride=s, pad=pad, pnorm=p, mode=mode,
              data_format=layout)
    _vjp_both(lambda x: jconv.pnormpool2d(x, **kw),
              lambda x: tconv.pnormpool2d(x, **kw), [x])


# ---------------------------------------------------------------------- LRN
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("depth,alpha,beta,bias", [(5, 1e-4, 0.75, 2.0),
                                                   (3, 0.1, 0.5, 1.0),
                                                   (4, 0.3, 0.75, 1.0)])
def test_lrn_matches_jax(layout, depth, alpha, beta, bias):
    """An even depth pads depth//2 before and the rest after."""
    x = 3.0 * _randn(np.random.default_rng(depth), *_nhwc((2, 7, 4, 5),
                                                          layout))
    kw = dict(depth=depth, alpha=alpha, beta=beta, bias=bias,
              data_format=layout)
    _vjp_both(lambda x: jnorm.lrn(x, **kw), lambda x: tnorm.lrn(x, **kw), [x])


def test_lrn_is_not_torch_local_response_norm():
    """torch divides alpha by the window; the reference does not."""
    x = torch.from_numpy(_randn(np.random.default_rng(0), 1, 6, 3, 3))
    ours = tnorm.lrn(x, depth=5, alpha=0.5, beta=0.75, bias=1.0)
    theirs = torch.nn.functional.local_response_norm(x, 5, alpha=0.5,
                                                     beta=0.75, k=1.0)
    assert not torch.allclose(ours, theirs)
    again = torch.nn.functional.local_response_norm(x, 5, alpha=0.5 * 5,
                                                    beta=0.75, k=1.0)
    torch.testing.assert_close(ours, again, rtol=1e-5, atol=1e-6)


# -------------------------------------------------------------------- layers
def _layer_pair(name, kw):
    j, t = getattr(jlayers, name)(**kw), getattr(tlayers, name)(**kw)
    return j, t


LAYER_CASES = [
    ("LocalResponseNormalization", {}, (2, 6, 5, 5)),
    ("LocalResponseNormalization", {"n": 3, "alpha": 0.2, "beta": 0.5,
                                    "k": 1.0}, (2, 6, 5, 5)),
    ("Deconvolution2D", {"kernelSize": (3, 3), "stride": (2, 2),
                         "padding": (1, 1), "nOut": 4,
                         "activation": "relu"}, (2, 3, 5, 5)),
    ("Deconvolution2D", {"kernelSize": (4, 4), "stride": (2, 2), "nOut": 4,
                         "convolutionMode": "same",
                         "activation": "identity"}, (2, 3, 5, 5)),
    ("DepthwiseConvolution2D", {"kernelSize": (3, 3), "padding": (1, 1),
                                "depthMultiplier": 2,
                                "activation": "tanh"}, (2, 3, 6, 6)),
    ("SeparableConvolution2D", {"kernelSize": (3, 3), "stride": (2, 2),
                                "padding": (1, 1), "nOut": 5,
                                "depthMultiplier": 2,
                                "activation": "relu"}, (2, 3, 7, 7)),
    ("ZeroPaddingLayer", {"padding": ((1, 2), (0, 3))}, (2, 3, 4, 4)),
    ("ZeroPaddingLayer", {"padding": 2}, (2, 3, 4, 4)),
    ("Upsampling2D", {"size": (2, 3)}, (2, 3, 3, 4)),
    ("Cropping2D", {"crop": (1, 2)}, (2, 3, 6, 7)),
    ("SubsamplingLayer", {"poolingType": "pnorm", "kernelSize": (3, 3),
                          "stride": (2, 2), "padding": (1, 1), "pnorm": 3},
     (2, 3, 7, 7)),
]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("name,kw,shape", LAYER_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(LAYER_CASES)])
def test_layers_match_jax(name, kw, shape, layout):
    """Each layer on its inferred shapes, its params transplanted from the
    JAX layer's init, NCHW in and NHWC under the compute-layout stamp; the
    output type as the JAX layer's; the JAX JSON read by the port."""
    j, t = _layer_pair(name, kw)
    n, c, h, w = shape
    for layer, it in ((j, JInputType), (t, InputType)):
        layer.set_defaults(type("B", (), {"activation": "identity",
                                          "weight_init": "relu", "l1": 0.0,
                                          "l2": 0.0})())
        layer.infer_nin(it.convolutional(h, w, c))
    jt = j.output_type(JInputType.convolutional(h, w, c))
    tt = t.output_type(InputType.convolutional(h, w, c))
    assert (jt.kind, dict(jt.dims)) == (tt.kind, dict(tt.dims))
    jp, _ = j.initialize(jax.random.PRNGKey(3))
    names = sorted(jp)
    arrays = [np.array(jp[k]) for k in names]
    if layout == "NHWC":
        j.data_format = t.data_format = "NHWC"
    x = _randn(np.random.default_rng(11), *_nhwc(shape, layout))

    def jfn(x, *ps):
        return j.apply(dict(zip(names, ps)), {}, x, False, None)[0]

    def tfn(x, *ps):
        return t.apply(dict(zip(names, ps)), {}, x, False, None)[0]
    _vjp_both(jfn, tfn, [x] + arrays)
    back = tlayers.layer_from_config(json.loads(json.dumps(j.to_config())))
    assert type(back) is type(t)
    assert json.loads(json.dumps(back.to_config())) == \
        json.loads(json.dumps(t.to_config()))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spatial_dropout_drops_whole_maps_as_jax(layout, monkeypatch):
    """Train mode with the JAX layer's mask handed to the port: the same
    output; each [N, C] map kept whole or zeroed; the identity in
    inference."""
    j = jlayers.SpatialDropoutLayer(rate=0.4)
    t = tlayers.SpatialDropoutLayer(rate=0.4)
    x = _randn(np.random.default_rng(2), 4, 6, 5, 5)
    key = jax.random.PRNGKey(7)
    want = np.asarray(j.apply({}, {}, jnp.asarray(x), True, key)[0])

    def jax_mask(k, shape, keep, device):
        assert tuple(shape) == (4, 6, 1, 1) and k.path == (2,)
        return torch.from_numpy(np.array(jax.random.bernoulli(
            key, keep, tuple(shape))))
    monkeypatch.setattr(tnorm, "dropout_mask", jax_mask)
    xt = torch.from_numpy(x).requires_grad_(True)
    got, _ = t.apply({}, {}, xt, True, tnorm.StepKey(0, 0, (2,)))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=FWD_TOL,
                               atol=FWD_TOL)
    zero = (got.detach().reshape(4, 6, -1) == 0).all(dim=2)
    assert 0 < int(zero.sum()) < 24
    g, = torch.autograd.grad(got.sum(), xt)
    np.testing.assert_allclose(g.reshape(4, 6, -1).numpy(), np.broadcast_to(
        (~zero).float().numpy()[:, :, None] / 0.6, (4, 6, 25)), rtol=1e-6)
    assert t.apply({}, {}, xt, False, None)[0] is xt
    monkeypatch.undo()
    m = tnorm.dropout_mask(tnorm.StepKey(1, 0, (2,)), (64, 32, 1, 1), 0.6,
                           "cpu")
    assert abs(float(m.float().mean()) - 0.6) < 0.05


def test_conv_mode_outside_the_port_raises():
    with pytest.raises(NotImplementedError, match="'causal'"):
        tconv.conv2d(torch.zeros(1, 1, 4, 4), torch.zeros(1, 1, 3, 3),
                     mode="causal")
