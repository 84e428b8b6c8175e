"""Normalization ops (the slice's subset of
``deeplearning4j_tpu/ops/normalization.py``).

Batch norm follows the JAX package, not ``F.batch_norm``: statistics
accumulate in fp32 over the input dtype, the variance is the biased
``max(E[x^2] - E[x]^2, 0)``, and the running statistics weight the OLD
value by ``decay`` (torch's ``momentum`` weights the new one and tracks
the unbiased variance).
"""

from __future__ import annotations

from typing import Tuple

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


class _ChannelMoments(torch.autograd.Function):
    """``(mean(x), mean(x^2))`` over ``axes``, accumulated in fp32. The
    fp32 copy of x lives only inside the forward; the backward rebuilds
    ``g_m/n + 2 x g_m2/n`` from x in its own dtype, so no fp32
    activation is kept for the backward."""

    @staticmethod
    def forward(ctx, x, axes):
        x32 = x.float()
        m = x32.mean(dim=axes)
        m2 = x32.square().mean(dim=axes)
        ctx.save_for_backward(x)
        ctx.axes = axes
        return m, m2

    @staticmethod
    def backward(ctx, gm, gm2):
        (x,) = ctx.saved_tensors
        shape = [1 if i in ctx.axes else s for i, s in enumerate(x.shape)]
        n = x.numel() // max(1, gm.numel())
        g = (2.0 / n) * gm2.reshape(shape) * x.float() + \
            gm.reshape(shape) / n
        return g.to(x.dtype), None


def channel_moments(x, axes) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``(E[x], E[x^2])`` over ``axes`` (differentiable)."""
    return _ChannelMoments.apply(x, tuple(axes))


def _bshape(x, axis: int):
    shape = [1] * x.dim()
    shape[axis] = -1
    return shape


def batch_norm(x, gamma, beta, mean, var, *, eps: float = 1e-5,
               axis: int = 1):
    """Inference-mode batchnorm (ref: libnd4j ``batchnorm``): one
    multiply-add in the INPUT dtype, with the per-channel scale/shift
    computed in fp32 and cast once."""
    g = gamma if gamma is not None else torch.ones_like(mean)
    b = beta if beta is not None else torch.zeros_like(mean)
    inv = torch.rsqrt(var.float() + eps)
    scale = (g * inv).to(x.dtype)
    shift = (b - g * mean * inv).to(x.dtype)
    shape = _bshape(x, axis)
    return x * scale.reshape(shape) + shift.reshape(shape)


def batch_norm_train(x, gamma, beta, running_mean, running_var, *,
                     eps: float = 1e-5, decay: float = 0.9, axis: int = 1):
    """Training-mode batchnorm: normalize by the batch statistics and
    return ``(out, new_running_mean, new_running_var)`` with
    ``new = decay * running + (1 - decay) * batch`` (DL4J's ``decay``).
    The running statistics carry no gradient."""
    axes = tuple(i for i in range(x.dim()) if i != axis)
    m, m2 = channel_moments(x, axes)
    v = torch.clamp_min(m2 - m.square(), 0.0)
    out = batch_norm(x, gamma, beta, m, v, eps=eps, axis=axis)
    new_mean = decay * running_mean + (1.0 - decay) * m.detach()
    new_var = decay * running_var + (1.0 - decay) * v.detach()
    return out, new_mean, new_var


def scale_shift_act(x, scale, shift, *, alpha: float = 0.0, axis: int = 1):
    """Fused per-channel multiply-add + relu/leaky epilogue,
    ``act(x*scale + shift)`` with scale/shift cast to x's dtype and
    broadcast along ``axis``; ``alpha`` is the negative slope (0 = relu).
    Bit-identical to ``batch_norm`` followed by the activation. The CUDA
    override (``ops.cuda_kernels.make_scale_shift_act_override``)
    shadows it on channels-minor inputs."""
    shape = _bshape(x, axis)
    y = x * scale.to(x.dtype).reshape(shape) \
        + shift.to(x.dtype).reshape(shape)
    if alpha == 0.0:
        return torch.relu(y)
    return torch.where(y >= 0, y, torch.tensor(alpha, dtype=y.dtype) * y)
