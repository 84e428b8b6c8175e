"""Normalization ops (the slice's subset of
``deeplearning4j_tpu/ops/normalization.py``)."""

from __future__ import annotations

import torch


def layer_norm(x, gain, bias=None, *, axis=-1, eps: float = 1e-5):
    """Layer norm (ref: libnd4j ``layer_norm``). The variance is the
    population variance (``jnp.var``), hence ``unbiased=False``."""
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    m = torch.mean(x, dim=axes, keepdim=True)
    v = torch.var(x, dim=axes, keepdim=True, unbiased=False)
    out = (x - m) * torch.rsqrt(v + eps)
    if gain is not None:
        out = out * gain
    if bias is not None:
        out = out + bias
    return out
