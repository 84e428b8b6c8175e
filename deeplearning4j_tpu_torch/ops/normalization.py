"""Normalization ops (layer norm, batch norm, LRN, dropout, the noise
ops and the fused BN epilogue of ``deeplearning4j_tpu/ops/
normalization.py``).

Dropout draws its masks from a counter-based hash (``dropout_mask``),
not a generator: see the note above ``StepKey``. The noise ops
(``alpha_dropout``, ``gaussian_dropout``, ``gaussian_noise``) draw the
same way: their masks from ``dropout_mask``, their normals from
``normal_draw``.

Batch norm follows the JAX package, not ``F.batch_norm``: statistics
accumulate in fp32 over the input dtype, the variance is the biased
``max(E[x^2] - E[x]^2, 0)``, and the running statistics weight the OLD
value by ``decay`` (torch's ``momentum`` weights the new one and tracks
the unbiased variance).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
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


def rms_norm(x, gain, *, axis=-1, eps: float = 1e-6):
    """RMSNorm (the JAX package's transformer-era extension):
    ``x * rsqrt(mean(x^2) + eps) * gain``."""
    ms = torch.mean(torch.square(x), dim=axis, keepdim=True)
    out = x * torch.rsqrt(ms + eps)
    return out * gain if gain is not None else out


def lrn(x, *, depth: int = 5, alpha: float = 1e-4, beta: float = 0.75,
        bias: float = 1.0, data_format: str = "NCHW"):
    """Local response normalization across channels (ref: libnd4j
    ``lrn``): ``x / (bias + alpha * s)^beta``, ``s`` the sum of x^2 over a
    window of ``depth`` channels (``depth // 2`` before each channel, the
    rest after, zeros past the ends). ``alpha`` is not divided by
    ``depth``, unlike ``F.local_response_norm``."""
    axis = 1 if data_format.upper().startswith("NC") else x.dim() - 1
    c = x.shape[axis]
    half = depth // 2
    pad = [0, 0] * (x.dim() - 1 - axis) + [half, depth - 1 - half]
    sq = torch.nn.functional.pad(x.square(), pad)
    summed = sq.narrow(axis, 0, c)
    for i in range(1, depth):
        summed = summed + sq.narrow(axis, i, c)
    return x / (bias + alpha * summed) ** beta


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


def channel_moments(x, axes, sync=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``(E[x], E[x^2])`` over ``axes`` (differentiable); ``sync``,
    when given, maps them to the global batch's (sync BN: a data-parallel
    step's ``StepKey.sync``)."""
    m, m2 = _ChannelMoments.apply(x, tuple(axes))
    return (m, m2) if sync is None else sync(m, m2)


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
                     eps: float = 1e-5, decay: float = 0.9, axis: int = 1,
                     sync=None):
    """Training-mode batchnorm: normalize by the batch statistics (the
    global batch's through ``sync``, see :func:`channel_moments`) and
    return ``(out, new_running_mean, new_running_var)`` with
    ``new = decay * running + (1 - decay) * batch`` (DL4J's ``decay``).
    The running statistics carry no gradient."""
    axes = tuple(i for i in range(x.dim()) if i != axis)
    m, m2 = channel_moments(x, axes, sync)
    v = torch.clamp_min(m2 - m.square(), 0.0)
    out = batch_norm(x, gamma, beta, m, v, eps=eps, axis=axis)
    new_mean = decay * running_mean + (1.0 - decay) * m.detach()
    new_var = decay * running_var + (1.0 - decay) * v.detach()
    return out, new_mean, new_var


# ------------------------------------------------------------------ dropout
# The JAX package draws a dropout mask from a threefry key split off
# ``fold_in(PRNGKey(seed), t)`` once a layer; threefry bits cannot be had
# in torch. The port's mask is a counter-based hash of (seed, the step
# clock t, the layer, the element index): a function of those alone, so a
# captured K-step graph draws what K eager steps draw, a resumed or loaded
# net draws what it would have drawn, and no generator state exists for a
# capture's warm-up runs to advance. The clock may be a 0-d device tensor,
# read at replay.

_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer hash (xorshift-multiply, multipliers below 2^31 so
    an int64 product of a 32-bit value never overflows) of a Python int or
    an int64 tensor of values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _M32
    return x ^ (x >> 15)


class StepKey:
    """The dropout key of one train step and one layer: the network's
    ``seed``, the step clock ``t`` (a Python int or a 0-d integer tensor)
    and a ``path`` of ints naming the layer (:meth:`fold`). A data-
    parallel step's key also carries the rank's first row in the global
    batch (``rows``: the draws index elements from it, so the ranks'
    masks together are the single device's) and the batch-moment
    reducer of sync BN (``sync``, see :func:`channel_moments`)."""

    __slots__ = ("seed", "t", "path", "rows", "sync")

    def __init__(self, seed: int, t, path: Tuple[int, ...] = (),
                 rows: int = 0, sync=None):
        self.seed, self.t, self.path = int(seed), t, tuple(path)
        self.rows, self.sync = int(rows), sync

    def fold(self, i: int) -> "StepKey":
        return StepKey(self.seed, self.t, self.path + (int(i),), self.rows,
                       self.sync)

    def __repr__(self):
        return f"StepKey(seed={self.seed}, t={self.t}, path={self.path})"


def hash24(key: StepKey, n: int, device, offset: int = 0) -> torch.Tensor:
    """``n`` int64 values in ``[0, 2^24)``, a function of ``key`` alone: two
    hash rounds over the element index (from ``offset``), keyed by words
    of (seed, path) and of t (the draws behind :func:`dropout_mask` and
    the device augmentation's)."""
    base = _mix32(key.seed & _M32)
    for p in key.path:
        base = _mix32(base ^ _mix32((p + 0x9E3779B9) & _M32))
    t = key.t
    if isinstance(t, torch.Tensor):
        t = t.to(device=device, dtype=torch.int64)
    else:
        t = torch.full((), int(t), dtype=torch.int64, device=device)
    k1 = _mix32((t & _M32) ^ base)
    k2 = _mix32(k1 ^ 0x5BD1E995)
    idx = torch.arange(int(offset), int(offset) + int(n),
                       dtype=torch.int64, device=device)
    return _mix32(_mix32(idx ^ k1) ^ k2) >> 8


def _row_offset(key: StepKey, shape) -> int:
    """The flat index of this rank's first element of a batch-major draw:
    the key's global row offset times the row size (0 outside a data-
    parallel step), so the ranks' draws are the single device's."""
    rows = key.rows
    if not rows or not shape:
        return 0
    per = 1
    for s in tuple(shape)[1:]:
        per *= int(s)
    return rows * per


def dropout_mask(key: StepKey, shape, keep: float, device) -> torch.Tensor:
    """Boolean keep-mask of ``shape``: True with probability ``keep`` (to
    2^-24), drawn from ``key`` alone (see above): the :func:`hash24` of
    each element compared with ``keep * 2^24``."""
    n = 1
    for s in shape:
        n *= int(s)
    h = hash24(key, n, device, _row_offset(key, shape))
    return (h < int(round(keep * (1 << 24)))).reshape(tuple(shape))


def dropout(x, rate: float, key: Optional[StepKey], *, train: bool = True):
    """Inverted dropout (ref: the JAX ``ops/normalization.py`` ``dropout``):
    ``rate`` is the DROP probability (a layer's ``dropOut`` is the retain
    probability; the layer adapts); kept values are scaled by ``1/keep``
    and the result is in x's dtype. The identity when not training or
    ``rate <= 0``. The mask comes from the module's ``dropout_mask``,
    looked up at each call."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = dropout_mask(key, x.shape, keep, x.device)
    return torch.where(mask, x / dtype_scalar(keep, x.dtype),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def normal_draw(key: StepKey, shape, device) -> torch.Tensor:
    """Standard normal fp32 draws of ``shape``, a function of ``key``
    alone: Box-Muller over two :func:`hash24` streams (``key`` folded with
    0 and with 1), the first shifted half a step off zero so its log is
    finite."""
    n = 1
    for s in shape:
        n *= int(s)
    step = 2.0 ** -24
    off = _row_offset(key, shape)
    u1 = (hash24(key.fold(0), n, device, off).float() + 0.5) * step
    u2 = hash24(key.fold(1), n, device, off).float() * step
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos((2.0 * math.pi) * u2)
    return z.reshape(tuple(shape))


#: SELU's ``-scale * alpha``: the value a dropped unit takes in alpha
#: dropout
_ALPHA_P = -1.7580993408473766


def alpha_dropout(x, rate: float, key: Optional[StepKey], *,
                  train: bool = True):
    """SELU-compatible alpha dropout (ref: DL4J ``AlphaDropout``): dropped
    units take ``alpha'``, then ``a * x + b`` restores the mean and
    variance. ``rate`` is the DROP probability."""
    if not train or rate <= 0.0:
        return x
    keep = 1.0 - rate
    mask = dropout_mask(key, x.shape, keep, x.device)
    a = (keep + _ALPHA_P ** 2 * keep * (1.0 - keep)) ** -0.5
    b = -a * _ALPHA_P * (1.0 - keep)
    kept = torch.where(mask, x, torch.full((), _ALPHA_P, dtype=x.dtype,
                                           device=x.device))
    return (a * kept + b).to(x.dtype)


def gaussian_dropout(x, rate: float, key: Optional[StepKey], *,
                     train: bool = True):
    """Multiplicative ``N(1, rate / (1 - rate))`` noise (ref: DL4J
    ``GaussianDropout``)."""
    if not train or rate <= 0.0:
        return x
    stddev = (rate / (1.0 - rate)) ** 0.5
    noise = normal_draw(key, x.shape, x.device).to(x.dtype)
    return x * (1.0 + stddev * noise)


def gaussian_noise(x, stddev: float, key: Optional[StepKey], *,
                   train: bool = True):
    """Additive ``N(0, stddev)`` noise (ref: DL4J ``GaussianNoise``)."""
    if not train or stddev <= 0.0:
        return x
    return x + stddev * normal_draw(key, x.shape, x.device).to(x.dtype)


def dtype_scalar(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as a host float: what jnp makes of a
    weakly typed Python scalar beside an array of that dtype (torch would
    keep it in fp32 beside a bf16 tensor). A host float, so no copy to
    the card inside a capture; rounded on the host with numpy (bf16:
    round to nearest even on the fp32 bits, as torch converts), so it
    makes no tensor."""
    if dtype in _NP_FLOATS:
        return float(_NP_FLOATS[dtype](v))
    if dtype == torch.bfloat16:
        bits = np.asarray(np.float32(v)).view(np.uint32).astype(np.uint64)
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
        return float(np.asarray(bits.astype(np.uint32)).view(np.float32))
    return float(torch.tensor(v, dtype=dtype, device="cpu"))


_NP_FLOATS = {torch.float32: np.float32, torch.float16: np.float16,
              torch.float64: np.float64}


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
