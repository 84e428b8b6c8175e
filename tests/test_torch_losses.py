"""The port's loss table (``ops/losses.py``) and ``LossLayer`` against the
JAX package (CPU).

Every loss of the JAX table, each with no weights, with per-output
weights, and under a per-example and a per-element mask; the score and
its gradient with respect to the predictions (the labels too where the
JAX loss is differentiable in them). Predictions hold values past the
clips (exact 0 and 1 probabilities, values below -1 for MSLE, labels
near 0 for MAPE), where the clipped losses' gradients are 0 on both
sides. Inputs come from numpy with a seed.

Tolerances (tests/test_pallas.py's): fp32 score 1e-5 (rtol and atol),
gradients 2e-4.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.ops import losses as jloss
from deeplearning4j_tpu_torch.nn import layers as tlayers
from deeplearning4j_tpu_torch.ops import losses as tloss

torch.set_num_threads(2)

FWD_TOL = 1e-5
GRAD_TOL = 2e-4
N, C = 6, 5

#: each loss of the JAX table -> the kind of (labels, predictions) it takes
KINDS = {
    "mse": "real", "l2": "real", "mae": "real", "l1": "real",
    "xent": "binary", "xent_logits": "binary_logits", "mcxent": "onehot",
    "softmax_cross_entropy_logits": "onehot_logits",
    "negative_log_likelihood": "onehot", "hinge": "sign",
    "squared_hinge": "sign", "kl_divergence": "dist", "msle": "msle",
    "mape": "mape", "poisson": "counts", "cosine_proximity": "real",
    "wasserstein": "real",
}


def _data(kind, seed):
    r = np.random.default_rng(seed)
    z = r.standard_normal((N, C)).astype(np.float32)
    if kind == "real":
        return r.standard_normal((N, C)).astype(np.float32), z
    if kind in ("binary", "binary_logits"):
        y = (r.random((N, C)) < 0.5).astype(np.float32)
        if kind == "binary_logits":
            return y, 3.0 * z
        p = 1.0 / (1.0 + np.exp(-2.0 * z))
        p[0, :2], p[1, :2] = 0.0, 1.0          # past the clip
        return y, p.astype(np.float32)
    if kind in ("onehot", "onehot_logits", "dist"):
        y = np.eye(C, dtype=np.float32)[r.integers(0, C, N)]
        if kind == "dist":
            y = np.exp(r.standard_normal((N, C)))
            y = (y / y.sum(1, keepdims=True)).astype(np.float32)
            y[0, 0] = 0.0
        if kind == "onehot_logits":
            return y, 2.0 * z
        p = np.exp(2.0 * z)
        p = p / p.sum(1, keepdims=True)
        p[0] = 0.0
        p[0, 1] = 1.0                         # zeros below eps, one at 1
        return y, p.astype(np.float32)
    if kind == "sign":
        return np.sign(r.standard_normal((N, C))).astype(np.float32), z
    if kind == "msle":
        y = r.random((N, C)).astype(np.float32) * 3.0
        p = z * 2.0
        p[0, 0] = -1.5                        # below -1: clipped
        return y, p
    if kind == "mape":
        y = r.standard_normal((N, C)).astype(np.float32)
        y[0, 0] = 0.0
        y[1, 1] = 1e-9                        # divides by eps
        return y, z
    if kind == "counts":
        y = r.poisson(2.0, (N, C)).astype(np.float32)
        p = np.exp(z).astype(np.float32)
        p[0, 0] = 0.0
        return y, p
    raise ValueError(kind)


def _weights_and_masks(seed):
    r = np.random.default_rng(seed)
    return {
        "plain": (None, None),
        "weights": (r.random(C).astype(np.float32) + 0.5, None),
        "example_mask": (None, np.array([1, 0, 1, 1, 0, 1], np.float32)),
        "element_mask": (None, (r.random((N, C)) < 0.7).astype(np.float32)),
    }


def _both(jfn, tfn, arrays, grad_of):
    want, want_g = jax.value_and_grad(
        lambda *a: jfn(*a), argnums=grad_of)(*[jnp.asarray(a) for a in arrays])
    ts = [torch.from_numpy(np.array(a)).requires_grad_(i in grad_of)
          for i, a in enumerate(arrays)]
    got = tfn(*ts)
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=FWD_TOL, atol=FWD_TOL)
    got_g = torch.autograd.grad(got, [ts[i] for i in grad_of])
    for i, g, w in zip(grad_of, got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL, err_msg=f"argument {i}")
    return got_g


@pytest.mark.parametrize("variant", ["plain", "weights", "example_mask",
                                     "element_mask"])
@pytest.mark.parametrize("name", sorted(KINDS))
def test_loss_matches_jax(name, variant):
    y, p = _data(KINDS[name], len(name))
    w, m = _weights_and_masks(len(name))[variant]
    kw_j = {"weights": None if w is None else jnp.asarray(w),
            "mask": None if m is None else jnp.asarray(m)}
    kw_t = {"weights": None if w is None else torch.from_numpy(w),
            "mask": None if m is None else torch.from_numpy(m)}
    jfn, tfn = getattr(jloss, name), getattr(tloss, name)
    grad_of = (0, 1) if KINDS[name] in ("real", "sign") else (1,)
    _both(lambda y, p: jfn(y, p, **kw_j), lambda y, p: tfn(y, p, **kw_t),
          [y, p], grad_of)


@pytest.mark.parametrize("mask", [None, "example"])
def test_sparse_mcxent_matches_jax(mask):
    r = np.random.default_rng(3)
    idx = r.integers(0, C, N).astype(np.int32)
    z = (2.0 * r.standard_normal((N, C))).astype(np.float32)
    m = None if mask is None else np.array([1, 1, 0, 1, 0, 1], np.float32)
    want, want_g = jax.value_and_grad(lambda z: jloss.sparse_mcxent(
        jnp.asarray(idx), z, None if m is None else jnp.asarray(m)))(
            jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    got = tloss.sparse_mcxent(torch.from_numpy(idx), zt,
                              None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(float(got.detach()), float(want),
                               rtol=FWD_TOL, atol=FWD_TOL)
    g, = torch.autograd.grad(got, zt)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), rtol=GRAD_TOL,
                               atol=GRAD_TOL)


def test_the_table_names_the_same_losses():
    assert sorted(tloss.LOSSES) == sorted(jloss.LOSSES)
    for key, fn in jloss.LOSSES.items():
        assert tloss.get(key).__name__ == fn.__name__, key
    with pytest.raises(ValueError, match="Unknown loss"):
        tloss.get("nope")


def test_xent_clip_is_the_references_not_torchs():
    """At p = 0 and p = 1 the clip zeroes the gradient and bounds the
    loss by -log(eps); ``F.binary_cross_entropy`` clamps the log at -100
    instead."""
    y = torch.tensor([[1.0, 0.0]])
    p = torch.tensor([[0.0, 1.0]], requires_grad=True)
    loss = tloss.xent(y, p)
    g, = torch.autograd.grad(loss, p)
    assert torch.equal(g, torch.zeros_like(g))
    eps = np.float32(1e-7)
    want = -(np.log(eps) + np.log(np.float32(1) - (np.float32(1) - eps)))
    np.testing.assert_allclose(float(loss), want, rtol=1e-5)
    bce = torch.nn.functional.binary_cross_entropy(p.detach(), y,
                                                   reduction="sum")
    assert abs(float(bce) - float(loss)) > 100


@pytest.mark.parametrize("loss,act,kind", [("xent", "sigmoid", "binary"),
                                           ("mse", "identity", "real"),
                                           ("mcxent", "softmax", "onehot")])
def test_loss_layer_matches_jax(loss, act, kind):
    """The layer's activation on 4-D maps (UNet's head) and 2-D rows, then
    its loss, forward and gradient; its JSON read from the JAX layer's."""
    j = jlayers.LossLayer(lossFunction=loss, activation=act)
    t = tlayers.LossLayer(lossFunction=loss, activation=act)
    back = tlayers.layer_from_config(json.loads(json.dumps(j.to_config())))
    assert type(back) is tlayers.LossLayer and back.to_config() == \
        t.to_config()
    assert not t.has_params and t.input_kind is None
    r = np.random.default_rng(5)
    shape = (2, 1, 4, 4) if loss == "xent" else (N, C)
    y, _ = _data(kind, 9)
    y = (r.random(shape) < 0.5).astype(np.float32) if loss == "xent" else y
    x = r.standard_normal(shape).astype(np.float32)

    def jfn(x):
        out = j.apply({}, {}, x, True, None)[0]
        return j.compute_loss(jnp.asarray(y), out)

    def tfn(x):
        out = t.apply({}, {}, x, True, None)[0]
        return t.compute_loss(torch.from_numpy(y), out)
    _both(jfn, tfn, [x], (0,))
