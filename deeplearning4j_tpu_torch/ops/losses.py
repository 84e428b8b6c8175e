"""Loss functions (the slice's subset of
``deeplearning4j_tpu/ops/losses.py``).

``mcxent`` is the reference's LossMCXENT on probabilities: it clips
``p`` to ``[eps, 1]`` before the log and autograd differentiates through
the clip and the softmax before it. It is not ``F.cross_entropy`` (log
softmax of logits), which differs where ``p < eps``.
All functions take ``(labels, predictions)``, like the reference; the two
logit losses take the log-softmax of the logits, as the JAX ones take
``jax.nn.log_softmax``.
"""

from __future__ import annotations

import torch

_EPS = 1e-7


def _apply_weights(per_elem, weights):
    if weights is not None:
        per_elem = per_elem * weights
    return per_elem


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


def mcxent(labels, preds, weights=None, mask=None):
    """Multi-class cross-entropy on probabilities (ref: LossMCXENT): per
    example ``-sum_c y_c log(clip(p_c, eps, 1))``."""
    p = torch.clamp(preds, _EPS, 1.0)
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


LOSSES = {
    "mcxent": mcxent,
    "categorical_crossentropy": mcxent,
    "negativeloglikelihood": mcxent,
    "nll": mcxent,
}


def get(name):
    if callable(name):
        return name
    key = str(name).lower()
    if key not in LOSSES:
        raise ValueError(f"Unknown loss '{name}'. Known: {sorted(LOSSES)}")
    return LOSSES[key]
