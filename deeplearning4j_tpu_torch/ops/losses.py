"""Loss functions: the DL4J loss table of
``deeplearning4j_tpu/ops/losses.py`` (MSE, L2, MAE, L1, XENT, MCXENT,
sparse MCXENT, NLL, hinge, squared hinge, KLD, MSLE, MAPE, Poisson,
cosine proximity, Wasserstein, and the two logit forms).

As in the reference, every function takes ``(labels, predictions)``,
per-output ``weights`` multiply before the reduction, and the score is
the per-example sum over outputs averaged over the examples (over the
active ones under a ``mask``, :func:`_reduce`). No gradient is written
by hand: autograd differentiates the score, through the clips.

The clips are the reference's, not torch's: ``mcxent`` clips ``p`` to
``[eps, 1]`` before the log (``F.cross_entropy`` takes the log-softmax of
logits) and ``xent`` clips ``p`` to ``[eps, 1 - eps]`` (its gradient is 0
outside; ``F.binary_cross_entropy`` clamps the log at -100 instead).
Clips and floors are ``jnp.minimum``/``jnp.maximum`` as in the JAX
package, whose gradient at a tie (p exactly 1, say) is half, not the
whole of ``torch.clamp``'s (:func:`_max`, :func:`_min`).
The two logit losses take the log-softmax (and the stable sigmoid form)
of the logits, as the JAX ones do.
"""

from __future__ import annotations

import torch

_EPS = 1e-7


def _max(x, v: float):
    """``max(x, v)``, half the gradient to x at a tie (the jnp rule); v a
    host scalar (no copy to the card inside a capture)."""
    return torch.maximum(x, torch.full((), v, dtype=x.dtype))


def _min(x, v: float):
    return torch.minimum(x, torch.full((), v, dtype=x.dtype))


def _clip(x, lo: float, hi: float):
    return _min(_max(x, lo), hi)


def _apply_weights(per_elem, weights):
    if weights is not None:
        per_elem = per_elem * weights
    return per_elem


def _n_out(preds) -> int:
    return preds.shape[-1] if preds.dim() > 1 else 1


def _reduce(per_elem, mask):
    """Per-element loss [N, ...] -> scalar score: the sum over outputs,
    averaged over the examples (over the active ones under a mask)."""
    n = per_elem.shape[0]
    if mask is not None:
        m = mask
        while m.dim() < per_elem.dim():
            m = m.unsqueeze(-1)
        per_elem = per_elem * m
        per_ex = per_elem.reshape(n, -1).sum(dim=1)
        active = torch.broadcast_to(m, per_elem.shape).reshape(n, -1)
        n_active = torch.clamp_min(active.amax(dim=1).sum(), 1.0)
        return per_ex.sum() / n_active
    return per_elem.reshape(n, -1).sum(dim=1).mean()


def mse(labels, preds, weights=None, mask=None):
    """Mean squared error (ref: LossMSE = LossL2 / nOut)."""
    per = _apply_weights((preds - labels).square(), weights) / _n_out(preds)
    return _reduce(per, mask)


def l2(labels, preds, weights=None, mask=None):
    """Sum of squared errors per example (ref: LossL2)."""
    return _reduce(_apply_weights((preds - labels).square(), weights), mask)


def mae(labels, preds, weights=None, mask=None):
    """Mean absolute error (ref: LossMAE = LossL1 / nOut)."""
    per = _apply_weights((preds - labels).abs(), weights) / _n_out(preds)
    return _reduce(per, mask)


def l1(labels, preds, weights=None, mask=None):
    """Sum of absolute errors per example (ref: LossL1)."""
    return _reduce(_apply_weights((preds - labels).abs(), weights), mask)


def xent(labels, preds, weights=None, mask=None):
    """Binary cross-entropy on probabilities (ref: LossBinaryXENT), ``p``
    clipped to ``[eps, 1 - eps]``."""
    p = _clip(preds, _EPS, 1.0 - _EPS)
    per = -(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p))
    return _reduce(_apply_weights(per, weights), mask)


def xent_logits(labels, logits, weights=None, mask=None):
    """Sigmoid cross-entropy from logits, the stable form
    ``max(z, 0) - z*y + log1p(exp(-|z|))``."""
    per = _max(logits, 0.0) - logits * labels + \
        torch.log1p(torch.exp(-logits.abs()))
    return _reduce(_apply_weights(per, weights), mask)


def mcxent(labels, preds, weights=None, mask=None):
    """Multi-class cross-entropy on probabilities (ref: LossMCXENT): per
    example ``-sum_c y_c log(clip(p_c, eps, 1))``."""
    p = _clip(preds, _EPS, 1.0)
    per = -labels * torch.log(p)
    return _reduce(_apply_weights(per, weights), mask)


def softmax_cross_entropy_logits(labels, logits, weights=None, mask=None):
    """MCXENT from logits (ref: libnd4j ``softmax_cross_entropy_loss``):
    per example ``-sum_c y_c log_softmax(z)_c``."""
    per = -labels * torch.log_softmax(logits, dim=-1)
    return _reduce(_apply_weights(per, weights), mask)


def sparse_mcxent(label_idx, logits, mask=None):
    """Sparse MCXENT: integer class labels (ref: LossSparseMCXENT)."""
    logp = torch.log_softmax(logits, dim=-1)
    idx = label_idx.long()[..., None]
    per = -torch.take_along_dim(logp, idx, dim=-1)  # keeps an outputs axis
    return _reduce(per, mask)


def negative_log_likelihood(labels, preds, weights=None, mask=None):
    """ref: LossNegativeLogLikelihood, MCXENT's arithmetic."""
    return mcxent(labels, preds, weights, mask)


def hinge(labels, preds, weights=None, mask=None):
    """Hinge with +-1 labels (ref: LossHinge)."""
    per = _max(1.0 - labels * preds, 0.0)
    return _reduce(_apply_weights(per, weights), mask)


def squared_hinge(labels, preds, weights=None, mask=None):
    """ref: LossSquaredHinge."""
    per = _max(1.0 - labels * preds, 0.0).square()
    return _reduce(_apply_weights(per, weights), mask)


def kl_divergence(labels, preds, weights=None, mask=None):
    """ref: LossKLD, ``sum_c y log(y / p)`` with both clipped to
    ``[eps, 1]``."""
    y = _clip(labels, _EPS, 1.0)
    p = _clip(preds, _EPS, 1.0)
    per = y * (torch.log(y) - torch.log(p))
    return _reduce(_apply_weights(per, weights), mask)


def msle(labels, preds, weights=None, mask=None):
    """Mean squared logarithmic error (ref: LossMSLE)."""
    per = (torch.log1p(_max(preds, -1 + _EPS)) -
           torch.log1p(_max(labels, -1 + _EPS))).square() \
        / _n_out(preds)
    return _reduce(_apply_weights(per, weights), mask)


def mape(labels, preds, weights=None, mask=None):
    """Mean absolute percentage error (ref: LossMAPE); labels below eps
    in magnitude divide by eps."""
    den = torch.where(labels.abs() < _EPS, torch.full_like(labels, _EPS),
                      labels)
    per = 100.0 * ((labels - preds) / den).abs() / _n_out(preds)
    return _reduce(_apply_weights(per, weights), mask)


def poisson(labels, preds, weights=None, mask=None):
    """ref: LossPoisson, ``p - y log p`` with ``p`` at least eps."""
    p = _max(preds, _EPS)
    per = p - labels * torch.log(p)
    return _reduce(_apply_weights(per, weights), mask)


def cosine_proximity(labels, preds, weights=None, mask=None):
    """ref: LossCosineProximity, per example ``-cos(y, p)`` (each norm at
    least eps)."""
    yn = labels / _max(
        torch.linalg.vector_norm(labels, dim=-1, keepdim=True), _EPS)
    pn = preds / _max(
        torch.linalg.vector_norm(preds, dim=-1, keepdim=True), _EPS)
    per = -(yn * pn).sum(dim=-1, keepdim=True)
    return _reduce(_apply_weights(per, weights), mask)


def wasserstein(labels, preds, weights=None, mask=None):
    """ref: LossWasserstein, ``mean(y * p)`` (a WGAN critic's loss)."""
    per = labels * preds / _n_out(preds)
    return _reduce(_apply_weights(per, weights), mask)


LOSSES = {
    "mse": mse,
    "l2": l2,
    "mae": mae,
    "l1": l1,
    "xent": xent,
    "binary_crossentropy": xent,
    "mcxent": mcxent,
    "categorical_crossentropy": mcxent,
    "sparse_mcxent": sparse_mcxent,
    "negativeloglikelihood": negative_log_likelihood,
    "nll": negative_log_likelihood,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "kl_divergence": kl_divergence,
    "kld": kl_divergence,
    "msle": msle,
    "mape": mape,
    "poisson": poisson,
    "cosine_proximity": cosine_proximity,
    "wasserstein": wasserstein,
}


def get(name):
    if callable(name):
        return name
    key = str(name).lower()
    if key not in LOSSES:
        raise ValueError(f"Unknown loss '{name}'. Known: {sorted(LOSSES)}")
    return LOSSES[key]


class LossFunction:
    """Enum-style names mirroring ``LossFunctions.LossFunction``."""

    MSE = "mse"
    L1 = "l1"
    L2 = "l2"
    MAE = "mae"
    XENT = "xent"
    MCXENT = "mcxent"
    SPARSE_MCXENT = "sparse_mcxent"
    NEGATIVELOGLIKELIHOOD = "negativeloglikelihood"
    HINGE = "hinge"
    SQUARED_HINGE = "squared_hinge"
    KL_DIVERGENCE = "kl_divergence"
    MEAN_SQUARED_LOGARITHMIC_ERROR = "msle"
    MEAN_ABSOLUTE_PERCENTAGE_ERROR = "mape"
    POISSON = "poisson"
    COSINE_PROXIMITY = "cosine_proximity"
    WASSERSTEIN = "wasserstein"
