"""Op registry extension (the port of
``deeplearning4j_tpu/ops/registry_ext.py``): the scatter_nd family,
ctc_loss, in-graph updater ops, merge ops, the image resize/crop family,
absolute-value + entropy reductions, sparse ops, and the TF-import aliases
(add_n, select, stop_gradient, fused_batch_norm, squared_difference, ...).

Every op registered here has a validation case in
``ops/validation_ext.py``; the coverage gate fails otherwise.

Imported for its side effects at the bottom of ``ops/registry.py``; user
code keeps a single entry point (``registry``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import normalization as _norm
from deeplearning4j_tpu_torch.ops import recurrent as _rnn
from deeplearning4j_tpu_torch.ops.registry import (_colour, _dims, _fdt, _fl,
                                                   _long, _t, canonical_dtype,
                                                   image_resize_nd, register)
from deeplearning4j_tpu_torch.ops.registry import get as _get


# ---------------------------------------------------------------------------
# Family: scatter_nd (ref: generic/parity_ops/scatter_nd*.cpp, scatter_mul/div)
# ---------------------------------------------------------------------------
def _nd_index(indices, like):
    """[..., d] int index tensor -> tuple of d index tensors."""
    idx = _long(indices, like)
    return tuple(torch.movedim(idx, -1, 0))


@register("scatter_nd")
def _scatter_nd(indices, updates, shape):
    """ref: scatter_nd — build a zeros tensor of ``shape`` and ADD updates
    at ``indices`` (duplicate indices accumulate, matching the reference)."""
    out = torch.zeros(tuple(int(s) for s in shape), dtype=updates.dtype,
                      device=updates.device)
    return out.index_put(_nd_index(indices, updates), updates,
                         accumulate=True)


@register("scatter_nd_add")
def _scatter_nd_add(ref, indices, updates):
    return ref.index_put(_nd_index(indices, ref), updates.to(ref.dtype),
                         accumulate=True)


@register("scatter_nd_sub")
def _scatter_nd_sub(ref, indices, updates):
    return ref.index_put(_nd_index(indices, ref), -updates.to(ref.dtype),
                         accumulate=True)


@register("scatter_nd_update")
def _scatter_nd_update(ref, indices, updates):
    return ref.index_put(_nd_index(indices, ref), updates.to(ref.dtype))


def _scatter_rows(ref, indices, updates, how):
    idx = _long(indices, ref).reshape(-1)
    upd = _t(updates, ref).to(ref.dtype).reshape((idx.numel(),)
                                                 + tuple(ref.shape[1:]))
    if how == "prod":
        return ref.index_reduce(0, idx, upd, "prod", include_self=True)
    # x / u1 / u2 = x * (1/u1) * (1/u2): the reciprocal product
    return ref.index_reduce(0, idx, 1.0 / upd, "prod", include_self=True)


@register("scatter_mul")
def _scatter_mul(ref, indices, updates):
    """ref: scatter_mul — 1-D index form (rows of ``ref``)."""
    return _scatter_rows(ref, indices, updates, "prod")


@register("scatter_div")
def _scatter_div(ref, indices, updates):
    return _scatter_rows(ref, indices, updates, "div")


# ---------------------------------------------------------------------------
# Family: CTC (ref: generic/loss/ctcLoss.cpp; lstm-era ASR models)
# ---------------------------------------------------------------------------
_NEG = -1e30


def _shift(a, k, fill):
    """a shifted right by k along the last axis, ``fill`` in front."""
    pad = torch.full(a.shape[:-1] + (k,), fill, dtype=a.dtype,
                     device=a.device)
    return torch.cat([pad, a[..., :-k]], dim=-1)


@register("ctc_loss")
def _ctc_loss(labels, logits, label_lengths, logit_lengths,
              blank_index: int = 0):
    """Connectionist temporal classification loss (log-space forward
    algorithm over the blank-extended label sequence, stepped over time
    on the device).

    labels: [B, S] int (padded); logits: [B, T, C];
    label_lengths: [B]; logit_lengths: [B]. Returns [B] neg-log-lik.
    """
    labels = _long(labels, logits)
    B, S = labels.shape
    T = logits.shape[1]
    # fp32 as the JAX op computes it (fp64 kept for the gradient check)
    logp = torch.log_softmax(logits if logits.dtype == torch.float64
                             else logits.float(), dim=-1)
    label_lengths = _long(label_lengths, logits)
    logit_lengths = _long(logit_lengths, logits)
    L = 2 * S + 1
    # extended sequence: blank l1 blank l2 ... lS blank
    ext = torch.full((B, L), blank_index, dtype=torch.long,
                     device=logits.device)
    ext[:, 1::2] = labels
    ext_prev2 = _shift(ext, 2, -1)
    allow_skip = (ext != blank_index) & (ext != ext_prev2)          # [B, L]
    pos = torch.arange(L, device=logits.device)[None, :]
    pos_valid = pos <= 2 * label_lengths[:, None]
    neg = torch.full((), _NEG, dtype=logp.dtype, device=logp.device)

    emit0 = torch.gather(logp[:, 0], 1, ext)                        # [B, L]
    alpha = torch.where(pos < 2, emit0, neg)
    alpha = torch.where(pos_valid, alpha, neg)
    for t in range(1, T):
        prev1 = _shift(alpha, 1, _NEG)
        prev2 = torch.where(allow_skip, _shift(alpha, 2, _NEG), neg)
        trans = torch.logsumexp(torch.stack([alpha, prev1, prev2]), dim=0)
        emit = torch.gather(logp[:, t], 1, ext)
        new = torch.where(pos_valid, trans + emit, neg)
        # frames past this batch item's logit length carry alpha unchanged
        alpha = torch.where((t < logit_lengths)[:, None], new, alpha)
    end = 2 * label_lengths[:, None]                                # [B, 1]
    a_last = torch.gather(alpha, 1, end)[:, 0]
    a_prev = torch.gather(alpha, 1, torch.clamp_min(end - 1, 0))[:, 0]
    # empty label sequence: only the all-blank path exists; the "end-1" term
    # would double-count position 0
    a_prev = torch.where(label_lengths > 0, a_prev, neg)
    return -torch.logaddexp(a_last, a_prev)


@register("ctc_greedy_decoder")
def _ctc_greedy_decoder(logits, logit_lengths=None, blank_index: int = 0):
    """Best-path decoding: argmax per frame, collapse repeats, drop blanks.
    Returns (decoded [B, T] padded with -1, lengths [B]) — static shapes."""
    path = torch.argmax(logits, dim=-1).to(torch.int32)             # [B, T]
    B, T = path.shape
    prev = _shift(path, 1, -1)
    keep = (path != prev) & (path != blank_index)
    if logit_lengths is not None:
        keep = keep & (torch.arange(T, device=path.device)[None, :]
                       < _long(logit_lengths, path)[:, None])
    # stable compaction: target slot = cumsum(keep)-1 for kept symbols
    slots = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    slot_ok = torch.where(keep, slots, T - 1)
    vals = torch.where(keep, path, -1)
    decoded = torch.full((B, T), -1, dtype=torch.int32, device=path.device)
    decoded = decoded.scatter_reduce(1, slot_ok, vals, "amax",
                                     include_self=True)
    lengths = torch.sum(keep, dim=1, dtype=torch.int32)
    return decoded, lengths


# ---------------------------------------------------------------------------
# Family: in-graph updater ops (ref: generic/updaters/*.cpp — sgdUpdater,
# adamUpdater, ...). Single source of truth: train.updaters classes.
# ---------------------------------------------------------------------------
def _updater_ops():
    from deeplearning4j_tpu_torch.train import updaters as U

    @register("sgd_updater")
    def _sgd(grad, lr=0.1):
        return U.Sgd(lr).apply(grad, None, lr, 0)[0]

    @register("nesterovs_updater")
    def _nesterovs(grad, v, lr=0.1, momentum=0.9):
        u = U.Nesterovs(lr, momentum)
        upd, s = u.apply(grad, {"v": v}, lr, 0)
        return upd, s["v"]

    @register("adam_updater")
    def _adam(grad, m, v, lr=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
              iteration=0):
        u = U.Adam(lr, beta1, beta2, epsilon)
        upd, s = u.apply(grad, {"m": m, "v": v}, lr, iteration)
        return upd, s["m"], s["v"]

    @register("ams_grad_updater")
    def _ams(grad, m, v, vhat, lr=0.001, beta1=0.9, beta2=0.999,
             epsilon=1e-8, iteration=0):
        u = U.AMSGrad(lr, beta1, beta2, epsilon)
        upd, s = u.apply(grad, {"m": m, "v": v, "vhat": vhat}, lr, iteration)
        return upd, s["m"], s["v"], s["vhat"]

    @register("ada_max_updater")
    def _adamax(grad, m, u_, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, iteration=0):
        u = U.AdaMax(lr, beta1, beta2, epsilon)
        upd, s = u.apply(grad, {"m": m, "u": u_}, lr, iteration)
        return upd, s["m"], s["u"]

    @register("nadam_updater")
    def _nadam(grad, m, v, lr=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8,
               iteration=0):
        u = U.Nadam(lr, beta1, beta2, epsilon)
        upd, s = u.apply(grad, {"m": m, "v": v}, lr, iteration)
        return upd, s["m"], s["v"]

    @register("rms_prop_updater")
    def _rms(grad, g2, lr=0.1, rms_decay=0.95, epsilon=1e-8):
        u = U.RmsProp(lr, rms_decay, epsilon)
        upd, s = u.apply(grad, {"g2": g2}, lr, 0)
        return upd, s["g2"]

    @register("ada_grad_updater")
    def _adagrad(grad, h, lr=0.1, epsilon=1e-6):
        u = U.AdaGrad(lr, epsilon)
        upd, s = u.apply(grad, {"h": h}, lr, 0)
        return upd, s["h"]

    @register("ada_delta_updater")
    def _adadelta(grad, eg2, ex2, rho=0.95, epsilon=1e-6):
        u = U.AdaDelta(rho, epsilon)
        upd, s = u.apply(grad, {"Eg2": eg2, "Ex2": ex2}, 1.0, 0)
        return upd, s["Eg2"], s["Ex2"]


_updater_ops()


# ---------------------------------------------------------------------------
# Family: merge ops (ref: generic/transforms/merge*.cpp)
# ---------------------------------------------------------------------------
def _sum_list(xs):
    return sum(xs[1:], xs[0])


register("mergeadd", _sum_list)
register("mergeavg", lambda xs: _sum_list(xs) / len(xs))


@register("mergemax")
def _mergemax(xs):
    out = xs[0]
    for x in xs[1:]:
        out = torch.maximum(out, x)
    return out


@register("mergemaxindex")
def _mergemaxindex(xs):
    """ref: mergemaxindex — index of the input holding the max, per element."""
    return torch.argmax(torch.stack(list(xs), dim=0), dim=0).to(torch.int32)


register("add_n", _sum_list)        # TF name
register("accumulate_n", _sum_list)


# ---------------------------------------------------------------------------
# Family: pairwise extras + TF aliases
# ---------------------------------------------------------------------------
def _divide_no_nan(a, b):
    zero = torch.zeros((), dtype=torch.promote_types(a.dtype, b.dtype),
                       device=a.device)
    return torch.where(b == 0, zero, a / torch.where(b == 0,
                                                     torch.ones_like(b), b))


register("divide_no_nan", _divide_no_nan)
register("truncatediv", lambda a, b: torch.trunc(a / b))
register("floormod", torch.remainder)  # floor semantics, int-exact
register("squared_difference", _get("squared_subtract"))
register("select", lambda cond, a, b: torch.where(cond != 0, a, b))
register("stop_gradient", torch.Tensor.detach)
register("eps", lambda a, b, eps=1e-5: torch.abs(a - b) < eps)


@register("replace_nans")
def _replace_nans(x, value=0.0):
    return torch.where(torch.isnan(x), torch.tensor(
        value, dtype=x.dtype, device=x.device), x)


@register("compare_and_set")
def _compare_and_set(x, compare, set_value, eps=1e-6):
    """ref: compare_and_set — where |x - compare| < eps, write set_value."""
    return torch.where(torch.abs(x - compare) < eps, torch.tensor(
        set_value, dtype=x.dtype, device=x.device), x)


@register("match_condition")
def _match_condition(x, condition):
    """ref: match_condition (count matches); ``condition`` is a
    Conditions predicate from linalg.conditions or a plain callable.
    int32: the JAX op's int64 sum without x64."""
    fn = condition.mask if hasattr(condition, "mask") else condition
    return torch.sum(fn(x), dtype=torch.int32)


# ---------------------------------------------------------------------------
# Family: reduction extras (ref: reduce_variance/reduce_stdev, the
# absolute-value reduce3 family, entropy reductions)
# ---------------------------------------------------------------------------
def _rsum(x, axis=None, keepdims=False):
    return torch.sum(x, dim=_dims(x, axis), keepdim=keepdims)


register("reduce_variance", lambda x, axis=None, keepdims=False:
         torch.var(_fl(x), dim=_dims(x, axis), correction=0,
                   keepdim=keepdims))
register("reduce_stdev", lambda x, axis=None, keepdims=False:
         torch.std(_fl(x), dim=_dims(x, axis), correction=0,
                   keepdim=keepdims))
register("reduce_amax", lambda x, axis=None, keepdims=False:
         torch.amax(torch.abs(x), dim=_dims(x, axis), keepdim=keepdims))
register("reduce_amin", lambda x, axis=None, keepdims=False:
         torch.amin(torch.abs(x), dim=_dims(x, axis), keepdim=keepdims))
register("reduce_asum", lambda x, axis=None, keepdims=False:
         _rsum(torch.abs(x), axis, keepdims))
register("reduce_amean", lambda x, axis=None, keepdims=False:
         torch.mean(_fl(torch.abs(x)), dim=_dims(x, axis), keepdim=keepdims))
# entropy reductions over a probability-like tensor (ref: entropy,
# log_entropy, shannonentropy reduce ops)
register("entropy", lambda x, axis=None: -_rsum(x * torch.log(x), axis))
register("log_entropy", lambda x, axis=None:
         torch.log(-_rsum(x * torch.log(x), axis)))
register("shannonentropy", lambda x, axis=None:
         -_rsum(x * torch.log2(x), axis))


# ---------------------------------------------------------------------------
# Family: shape/build extras + aliases (reference names)
# ---------------------------------------------------------------------------
register("broadcast_to", lambda x, shape: torch.broadcast_to(
    x, tuple(int(s) for s in shape)))
register("zeros_as", _get("zeros_like"))
register("ones_as", _get("ones_like"))
register("lin_space", _get("linspace"))
register("tensormmul", _get("tensordot"))
register("multinomial", _get("random_multinomial"))
register("matrix_diag_part", _get("diag_part"))
register("parallel_stack", lambda xs, axis=0: torch.stack(list(xs), dim=axis))
register("precise_gelu", lambda x: 0.5 * x * (1.0 + torch.special.erf(
    x / float(np.sqrt(2.0).astype(np.float32)))))
register("softmin", lambda x, axis=-1: _get("softmax")(-x, axis=axis))
register("hardswish", lambda x: x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0))


@register("unique_with_counts")
def _unique_with_counts(x):
    """ref: unique_with_counts — a data-dependent output size like
    ``unique``/``listdiff`` (read back; the results stay on the device)."""
    vals, idx, counts = torch.unique(x, sorted=True, return_inverse=True,
                                     return_counts=True)
    return vals, idx.to(torch.int32).reshape(x.shape), counts.to(torch.int32)


@register("invert_permutation")
def _invert_permutation(p):
    p = p.long()
    out = torch.zeros_like(p, dtype=torch.int32)
    out[p] = torch.arange(p.shape[0], dtype=torch.int32, device=p.device)
    return out


register("bitcast", lambda x, dtype: x.view(canonical_dtype(dtype)))


@register("matrix_set_diag")
def _matrix_set_diag(x, diag):
    n = min(x.shape[-2], x.shape[-1])
    i = torch.arange(n, device=x.device)
    out = x.clone()
    out[..., i, i] = diag[..., :n].to(x.dtype)
    return out


@register("toggle_bits")
def _toggle_bits(x):
    return torch.bitwise_not(x)


def bit_pattern(x):
    """(the width-bit pattern of int tensor x as a nonnegative int64, the
    width): torch's ``>>`` on a signed type is arithmetic, so shifts act
    on this pattern instead."""
    width = x.element_size() * 8
    return x.to(torch.int64) & ((1 << width) - 1), width


def from_bit_pattern(u, dtype):
    """The inverse of :func:`bit_pattern` for a ``dtype`` of 8-32 bits."""
    width = torch.empty((), dtype=dtype).element_size() * 8
    if dtype.is_signed:
        u = torch.where(u >= (1 << (width - 1)), u - (1 << width), u)
    return u.to(dtype)


def _rotate_bits(x, n, left):
    """Bit rotation at the true width of x.dtype (8/16/32), n==0 safe."""
    u, width = bit_pattern(x)
    k = n % width
    comp = (width - k) % width
    lo, hi = (k, comp) if left else (comp, k)
    out = ((u << lo) | (u >> hi)) & ((1 << width) - 1)
    return from_bit_pattern(out, x.dtype)


register("cyclic_shift_bits", lambda x, n: _rotate_bits(x, n, left=True))
register("cyclic_rshift_bits", lambda x, n: _rotate_bits(x, n, left=False))


# ---------------------------------------------------------------------------
# Family: linalg extras
# ---------------------------------------------------------------------------
@register("lu_solve")
def _lu_solve(a, b):
    """Solve a x = b via the LU factorization path (ref: lu + solve pair)."""
    LU, piv = torch.linalg.lu_factor(a)
    vec = b.dim() == a.dim() - 1
    out = torch.linalg.lu_solve(LU, piv, b.unsqueeze(-1) if vec else b)
    return out.squeeze(-1) if vec else out


# ---------------------------------------------------------------------------
# Family: moments / normalization extras (ref: normalize_moments,
# sufficient_statistics, fused_batch_norm)
# ---------------------------------------------------------------------------
@register("normalize_moments")
def _normalize_moments(count, mean_ss, variance_ss, shift=None):
    shift_v = 0.0 if shift is None else shift
    mean = mean_ss / count + shift_v
    variance = variance_ss / count - torch.square(mean_ss / count)
    return mean, variance


@register("sufficient_statistics")
def _sufficient_statistics(x, axes, shift=None):
    axes = tuple(int(a) for a in np.atleast_1d(axes))
    count = float(np.prod([x.shape[a] for a in axes]))
    xs = x if shift is None else x - shift
    return (torch.tensor(count, dtype=torch.float32, device=x.device),
            torch.sum(xs, dim=axes), torch.sum(torch.square(xs), dim=axes))


@register("fused_batch_norm")
def _fused_batch_norm(x, scale, offset, mean=None, variance=None,
                      epsilon: float = 1e-3, training: bool = True,
                      data_format: str = "NHWC"):
    """ref/TF: FusedBatchNorm — returns (y, batch_mean, batch_var)."""
    ch_axis = -1 if data_format.upper() == "NHWC" else 1
    axes = tuple(i for i in range(x.dim()) if i != (x.dim() + ch_axis)
                 % x.dim())
    if training or mean is None:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = torch.mean(xf, dim=axes)
        variance = torch.mean(torch.square(xf), dim=axes) \
            - torch.square(mean)
    sh = [1] * x.dim()
    sh[ch_axis] = x.shape[ch_axis]
    y = (x - mean.reshape(sh)) * torch.rsqrt(
        variance.reshape(sh) + epsilon) * scale.reshape(sh) \
        + offset.reshape(sh)
    return y.to(x.dtype), mean, variance


# ---------------------------------------------------------------------------
# Family: conv/pool extras (ref: deconv3d, upsampling3d, dilation2d, col2im,
# max_pool_with_argmax, the 1-D pools)
# ---------------------------------------------------------------------------
def _conv_ops():
    from deeplearning4j_tpu_torch.ops import convolution as conv

    register("maxpool1d", conv.maxpool1d)
    register("avgpool1d", conv.avgpool1d)

    @register("upsampling3d")
    def _up3(x, scale=2, data_format="NCDHW"):
        s = (scale,) * 3 if isinstance(scale, int) else tuple(scale)
        axes = (2, 3, 4) if data_format.upper().startswith("NC") else (1, 2, 3)
        for ax, f in zip(axes, s):
            x = torch.repeat_interleave(x, f, dim=ax)
        return x

    @register("deconv3d")
    def _deconv3(x, w, b=None, stride=1, pad=0, data_format="NCDHW"):
        """Transposed 3-D conv (w: [outC, inC, kD, kH, kW], the JAX op's
        lhs-dilated correlation with the flipped kernel)."""
        s = (stride,) * 3 if isinstance(stride, int) else tuple(stride)
        p = (pad,) * 3 if isinstance(pad, int) else tuple(pad)
        cf = data_format.upper().startswith("NC")
        xt = x if cf else x.permute(0, 4, 1, 2, 3)
        out = torch.nn.functional.conv_transpose3d(
            xt, w.transpose(0, 1), None, stride=s, padding=p)
        if not cf:
            out = out.permute(0, 2, 3, 4, 1)
        if out.dtype != x.dtype:
            out = out.to(x.dtype)
        if b is not None:
            sh = [1] * 5
            sh[1 if cf else -1] = b.shape[0]
            out = out + b.reshape(sh)
        return out


_conv_ops()


@register("dilation2d")
def _dilation2d(x, filt, stride=1, rate=1):
    """Grayscale morphological dilation (TF semantics, NHWC, VALID):
    out[y,x,c] = max_{i,j} (in[y*s+i*r, x*s+j*r, c] + filt[i,j,c])."""
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    r = (rate, rate) if isinstance(rate, int) else tuple(rate)
    kh, kw, _ = filt.shape
    n, h, w, c = x.shape
    oh = (h - (kh - 1) * r[0] - 1) // s[0] + 1
    ow = (w - (kw - 1) * r[1] - 1) // s[1] + 1
    out = torch.full((n, oh, ow, c), -math.inf, dtype=x.dtype,
                     device=x.device)
    for i in range(kh):
        for j in range(kw):
            patch = x[:, i * r[0]:i * r[0] + oh * s[0]:s[0],
                      j * r[1]:j * r[1] + ow * s[1]:s[1], :]
            out = torch.maximum(out, patch + filt[i, j])
    return out


@register("col2im")
def _col2im(cols, h: int, w: int, stride=1, pad=0):
    """Inverse of ``im2col``: [N, C, kH, kW, oH, oW] -> [N, C, H, W] by
    scatter-add of overlapping patches (ref: helpers::col2im)."""
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    p = (pad, pad) if isinstance(pad, int) else tuple(pad)
    n, c, kh, kw, oh, ow = cols.shape
    hp, wp = h + 2 * p[0], w + 2 * p[1]
    out = torch.zeros((n, c, hp, wp), dtype=cols.dtype, device=cols.device)
    for i in range(kh):
        for j in range(kw):
            region = (slice(None), slice(None), slice(i, i + oh * s[0], s[0]),
                      slice(j, j + ow * s[1], s[1]))
            out = out.index_put(_grid_index(out, region), cols[:, :, i, j],
                                accumulate=True)
    return out[:, :, p[0]:hp - p[0], p[1]:wp - p[1]]


def _grid_index(t, region):
    """The advanced-index tuple of a basic-slice region of t (so an
    accumulating ``index_put`` keeps autograd)."""
    axes = [torch.arange(t.shape[d], device=t.device)[sl]
            for d, sl in enumerate(region)]
    return torch.meshgrid(*axes, indexing="ij")


@register("max_pool_with_argmax")
def _max_pool_with_argmax(x, kernel=2, stride=None, data_format="NHWC"):
    """NHWC max pool returning (pooled, argmax) with TF flat-index
    semantics (index into [H*W*C] per batch item)."""
    k = (kernel, kernel) if isinstance(kernel, int) else tuple(kernel)
    s = k if stride is None else (
        (stride, stride) if isinstance(stride, int) else tuple(stride))
    n, h, w, c = x.shape
    oh = (h - k[0]) // s[0] + 1
    ow = (w - k[1]) // s[1] + 1
    patches, flat_idx = [], []
    dev = x.device
    for i in range(k[0]):
        for j in range(k[1]):
            patch = x[:, i:i + oh * s[0]:s[0], j:j + ow * s[1]:s[1], :]
            patches.append(patch)
            ys = torch.arange(oh, device=dev) * s[0] + i
            xs = torch.arange(ow, device=dev) * s[1] + j
            fi = (ys[:, None] * w + xs[None, :])[None, :, :, None] * c \
                + torch.arange(c, device=dev)[None, None, None, :]
            flat_idx.append(torch.broadcast_to(fi, patch.shape))
    stacked = torch.stack(patches, dim=0)               # [k², N, oH, oW, C]
    pooled, which = torch.max(stacked, dim=0)
    argmax = torch.gather(torch.stack(flat_idx, dim=0), 0, which[None])[0]
    return pooled, argmax.to(torch.int32)


# ---------------------------------------------------------------------------
# Family: losses extra
# ---------------------------------------------------------------------------
@register("mean_pairwssqerr_loss")
def _mean_pairws(labels, predictions, weights=None):
    """ref: mean_pairwssqerr_loss — mean over pairwise squared differences
    of the per-element errors, per example row."""
    d = (predictions - labels).reshape(labels.shape[0], -1)
    m = d.shape[1]
    # sum_{i<j} (d_i - d_j)^2 = m*sum d² - (sum d)²   (per row, then / pairs)
    sum_d = torch.sum(d, dim=1)
    sum_d2 = torch.sum(torch.square(d), dim=1)
    pair = max(m * (m - 1) / 2.0, 1.0)
    per_ex = (m * sum_d2 - torch.square(sum_d)) / (2.0 * pair)
    if weights is not None:
        per_ex = per_ex * weights
    return torch.mean(per_ex)


# ---------------------------------------------------------------------------
# Family: sparse (ref: sparse_to_dense, sparse parity ops)
# ---------------------------------------------------------------------------
@register("sparse_to_dense")
def _sparse_to_dense(indices, shape, values, default_value=0):
    out = torch.full(tuple(int(s) for s in shape), default_value,
                     dtype=values.dtype, device=values.device)
    return out.index_put(_nd_index(indices, values), values)


@register("sparse_tensor_dense_matmul")
def _sparse_dense_matmul(indices, values, dense_shape, b):
    """COO [N,2] sparse a times dense b — rows gather + scatter-add
    (ref: sparse_tensor_dense_matmul; no dense materialization)."""
    rows = _long(indices[:, 0], b)
    cols = _long(indices[:, 1], b)
    contrib = values[:, None] * b[cols]
    out = torch.zeros((int(dense_shape[0]), b.shape[1]), dtype=contrib.dtype,
                      device=b.device)
    return out.index_add(0, rows, contrib)


# ---------------------------------------------------------------------------
# Family: image extras (ref: adjust_hue/adjust_saturation/resize_*/
# crop_and_resize/random_crop; channels-last)
# ---------------------------------------------------------------------------
def _image_ops():
    rgb_to_hsv = _get("rgb_to_hsv")
    hsv_to_rgb = _get("hsv_to_rgb")

    @register("adjust_hue")
    def _adjust_hue(x, delta):
        hsv = rgb_to_hsv(x)
        h = torch.remainder(hsv[..., 0] + delta, 1.0)
        return hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))

    @register("adjust_saturation")
    def _adjust_saturation(x, factor):
        hsv = rgb_to_hsv(x)
        s = torch.clamp(hsv[..., 1] * factor, 0.0, 1.0)
        return hsv_to_rgb(torch.stack([hsv[..., 0], s, hsv[..., 2]], dim=-1))


_image_ops()


@register("rgb_to_yiq")
def _rgb_to_yiq(x):
    return _colour(x, [[0.299, 0.59590059, 0.21153661],
                       [0.587, -0.27455667, -0.52273617],
                       [0.114, -0.32134392, 0.31119955]])


@register("yiq_to_rgb")
def _yiq_to_rgb(x):
    return _colour(x, [[1.0, 1.0, 1.0],
                       [0.95598634, -0.27201283, -1.10674021],
                       [0.6208248, -0.64720424, 1.70423049]])


def _resize(x, size, method):
    n, h, w, c = x.shape
    return image_resize_nd(x, (n, int(size[0]), int(size[1]), c), method)


register("resize_bicubic", lambda x, size: _resize(x, size, "cubic"))


def _area_weights(in_size: int, out_size: int, device) -> torch.Tensor:
    # W[i, j] = |[j, j+1) ∩ [i·s, (i+1)·s)| / s with s = in/out — each output
    # pixel is the mean of the source pixels its box overlaps (TF area
    # resampling), not a bilinear tap.
    s = in_size / out_size
    j = torch.arange(in_size, dtype=torch.float64, device=device)[None, :]
    lo = torch.arange(out_size, dtype=torch.float64, device=device)[:, None] \
        * s
    overlap = torch.clamp_min(torch.minimum(lo + s, j + 1.0)
                              - torch.maximum(lo, j), 0.0)
    return (overlap / s).float()


@register("resize_area")
def _resize_area(x, size):
    n, h, w, c = x.shape
    oh, ow = int(size[0]), int(size[1])
    dt = _fdt(x)
    wh = _area_weights(h, oh, x.device).to(dt)
    ww = _area_weights(w, ow, x.device).to(dt)
    return torch.einsum("ih,nhwc,jw->nijc", wh, x.to(dt), ww)


@register("image_resize")
def _image_resize(x, size, method: str = "bilinear"):
    if str(method).lower() == "area":
        return _resize_area(x, size)
    method = {"bilinear": "linear", "nearest": "nearest",
              "bicubic": "cubic",
              "lanczos3": "lanczos3", "lanczos5": "lanczos5"}.get(
                  str(method).lower(), str(method))
    return _resize(x, size, method)


@register("crop_and_resize")
def _crop_and_resize(image, boxes, box_indices, crop_size,
                     extrapolation_value: float = 0.0):
    """ref/TF: crop_and_resize — normalized boxes [n, 4] (y1,x1,y2,x2),
    bilinear sample to crop_size per box. TF sampling formula: crop dims of
    size 1 sample the box CENTER, and samples outside the image take
    ``extrapolation_value`` rather than clamping."""
    n, h, w, c = image.shape
    ch, cw = int(crop_size[0]), int(crop_size[1])
    boxes = boxes.to(device=image.device, dtype=torch.float32)
    bi = _long(box_indices, image)

    def coords(lo, hi, out, in_size):
        # lerp form: endpoints land EXACTLY on lo/hi
        if out > 1:
            t = torch.arange(out, dtype=torch.float32,
                             device=image.device) / (out - 1)
            return (lo[:, None] * (1 - t) + hi[:, None] * t) * (in_size - 1)
        return (0.5 * (lo + hi) * (in_size - 1))[:, None]

    y1, x1, y2, x2 = boxes.unbind(-1)
    ys = coords(y1, y2, ch, h)                              # [B, ch]
    xs = coords(x1, x2, cw, w)                              # [B, cw]
    in_y = (ys >= 0) & (ys <= h - 1)
    in_x = (xs >= 0) & (xs <= w - 1)
    y0 = torch.clamp(torch.floor(ys).long(), 0, h - 1)
    y1i = torch.clamp(y0 + 1, 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, w - 1)
    x1i = torch.clamp(x0 + 1, 0, w - 1)
    wy = torch.clamp(ys - y0, 0.0, 1.0)[:, :, None, None]
    wx = torch.clamp(xs - x0, 0.0, 1.0)[:, None, :, None]
    img = image[bi]                                         # [B, H, W, C]
    b = torch.arange(img.shape[0], device=image.device)[:, None, None]

    def at(yy, xx):
        return img[b, yy[:, :, None], xx[:, None, :]]       # [B, ch, cw, C]

    out = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1i) * (1 - wy) * wx
           + at(y1i, x0) * wy * (1 - wx) + at(y1i, x1i) * wy * wx)
    inside = (in_y[:, :, None] & in_x[:, None, :])[..., None]
    return torch.where(inside, out, torch.tensor(
        extrapolation_value, dtype=out.dtype, device=out.device))


@register("random_crop")
def _random_crop(gen, x, size):
    """ref: random_crop — uniform-offset crop to ``size`` (full-rank); the
    offsets are drawn from ``gen`` and read back to slice."""
    size = tuple(int(s) for s in size)
    starts = [int(torch.randint(0, x.shape[i] - size[i] + 1, (),
                                generator=gen, device=gen.device))
              for i in range(len(size))]
    return x[tuple(slice(s, s + n) for s, n in zip(starts, size))]


# ---------------------------------------------------------------------------
# Family: dropout variants (ref: alpha_dropout — SELU-preserving). The JAX
# ops take a Threefry key first; these take the port's dropout key there
# (a ``StepKey``: ``normalization.dropout_mask``'s counter hash), as the
# AlphaDropout/GaussianDropout/GaussianNoise layers draw them.
# ---------------------------------------------------------------------------
register("alpha_dropout", lambda key, x, rate: _norm.alpha_dropout(
    x, rate, key))
register("gaussian_dropout", lambda key, x, rate: _norm.gaussian_dropout(
    x, rate, key))
register("gaussian_noise", lambda key, x, stddev: _norm.gaussian_noise(
    x, stddev, key))


# ---------------------------------------------------------------------------
# Family: embeddings / nlp training-step ops (ref: generic/nlp/{cbow,
# skipgram}.cpp — device-side negative-sampling SGD step)
# ---------------------------------------------------------------------------
@register("skipgram")
def _skipgram(syn0, syn1neg, center, targets, labels, lr):
    """One skip-gram negative-sampling SGD step (ref: skipgram op).

    syn0: [V, D] input vectors; syn1neg: [V, D] output vectors;
    center: [] int; targets: [K] int (first = positive, rest = negatives);
    labels: [K] float (1 for positive, 0 negatives); returns updated
    (syn0, syn1neg).
    """
    center = int(center) if not isinstance(center, torch.Tensor) \
        else center.long()
    targets = _long(targets, syn0)
    v_in = syn0[center]                                   # [D]
    v_out = syn1neg[targets]                              # [K, D]
    score = torch.sigmoid(v_out @ v_in)                   # [K]
    g = (labels - score) * lr                             # [K]
    new_syn1 = syn1neg.index_put((targets,), g[:, None] * v_in[None, :],
                                 accumulate=True)
    c = torch.as_tensor(center, device=syn0.device).reshape(1)
    new_syn0 = syn0.index_put((c,), (g @ v_out)[None, :], accumulate=True)
    return new_syn0, new_syn1


@register("cbow")
def _cbow(syn0, syn1neg, context, targets, labels, lr):
    """One CBOW negative-sampling step: context mean predicts target
    (ref: cbow op). context: [C] int; targets/labels as in skipgram."""
    context = _long(context, syn0)
    targets = _long(targets, syn0)
    v_ctx = torch.mean(syn0[context], dim=0)              # [D]
    v_out = syn1neg[targets]                              # [K, D]
    score = torch.sigmoid(v_out @ v_ctx)
    g = (labels - score) * lr
    new_syn1 = syn1neg.index_put((targets,), g[:, None] * v_ctx[None, :],
                                 accumulate=True)
    grad_ctx = (g @ v_out) / context.shape[0]
    new_syn0 = syn0.index_put((context,), grad_ctx.expand(
        (context.shape[0],) + grad_ctx.shape), accumulate=True)
    return new_syn0, new_syn1


# ---------------------------------------------------------------------------
# Family: RNN sequence wrappers (ref: dynamic_rnn/static_rnn/
# static_bidirectional_rnn over BasicLSTMCell weights) + full lstmLayer
# ---------------------------------------------------------------------------
@register("dynamic_rnn")
def _dynamic_rnn(x, w_ih, w_hh, b, h0=None, c0=None, time_major=False):
    """LSTM over a full sequence (ref: dynamic_rnn). x: [N, T, C] (or
    [T, N, C] when time_major); returns (outputs, (hT, cT))."""
    if not time_major:
        x = torch.movedim(x, 0, 1)
    outs, hc = _rnn.lstm(x, w_ih, w_hh, b, h0=h0, c0=c0)
    if not time_major:
        outs = torch.movedim(outs, 0, 1)
    return outs, hc


register("static_rnn", lambda x, w_ih, w_hh, b, h0=None, c0=None:
         _rnn.lstm(x, w_ih, w_hh, b, h0=h0, c0=c0))


def _merge(out_f, out_b, merge):
    if merge == "concat":
        return torch.cat([out_f, out_b], dim=-1)
    if merge == "sum":
        return out_f + out_b
    if merge == "mul":
        return out_f * out_b
    if merge == "avg":
        return 0.5 * (out_f + out_b)
    raise ValueError(f"unknown merge mode '{merge}'")


@register("bidirectional_rnn")
def _bidirectional_rnn(x_tnc, w_ih_f, w_hh_f, b_f, w_ih_b, w_hh_b, b_b,
                       merge: str = "concat"):
    """Forward + backward LSTM over [T, N, C] (ref:
    static_bidirectional_rnn); merge: concat|sum|mul|avg."""
    out_f, _ = _rnn.lstm(x_tnc, w_ih_f, w_hh_f, b_f)
    out_b, _ = _rnn.lstm(x_tnc, w_ih_b, w_hh_b, b_b, reverse=True)
    return _merge(out_f, out_b, merge)


def _lstm_layer_full(x_tnc, w_ih, w_hh, b, h0=None, c0=None, mask_tn=None,
                     direction: str = "fwd", cell_clip: float = None,
                     w_proj=None, w_ih_b=None, w_hh_b=None, b_b=None,
                     merge: str = "concat"):
    """Full-featured lstmLayer (ref: generic/recurrent/lstmLayer.cpp):
    directions fwd/bwd/bidir (merge concat|sum|mul|avg), optional cell-state
    clipping, optional recurrent projection (w_proj: [H, P])."""

    def run(wi, wh, bb, reverse):
        if cell_clip is None and w_proj is None:
            return _rnn.lstm(x_tnc, wi, wh, bb, h0=h0, c0=c0,
                             mask_tn=mask_tn, reverse=reverse)
        T, N, _ = x_tnc.shape
        H = wh.shape[0]
        P = w_proj.shape[1] if w_proj is not None else H
        h = h0 if h0 is not None else x_tnc.new_zeros((N, P))
        c = c0 if c0 is not None else x_tnc.new_zeros((N, H))
        outs = [None] * T
        for t in (range(T - 1, -1, -1) if reverse else range(T)):
            gates = x_tnc[t] @ wi + h @ wh + bb
            i, f, g, o = torch.chunk(gates, 4, dim=-1)
            c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            if cell_clip is not None:
                c_new = torch.clamp(c_new, -cell_clip, cell_clip)
            h_new = torch.sigmoid(o) * torch.tanh(c_new)
            if w_proj is not None:
                h_new = h_new @ w_proj
            if mask_tn is not None:
                # masked steps carry state unchanged and emit zeros (same
                # contract as recurrent.lstm)
                m = mask_tn[t][:, None] > 0
                h_new = torch.where(m, h_new, h)
                c_new = torch.where(m, c_new, c)
                outs[t] = torch.where(m, h_new, torch.zeros_like(h_new))
            else:
                outs[t] = h_new
            h, c = h_new, c_new
        return torch.stack(outs), (h, c)

    if direction == "fwd":
        return run(w_ih, w_hh, b, False)
    if direction == "bwd":
        return run(w_ih, w_hh, b, True)
    if direction == "bidir":
        out_f, st_f = run(w_ih, w_hh, b, False)
        out_b, st_b = run(w_ih_b if w_ih_b is not None else w_ih,
                          w_hh_b if w_hh_b is not None else w_hh,
                          b_b if b_b is not None else b, True)
        return _merge(out_f, out_b, merge), (st_f, st_b)
    raise ValueError(f"unknown direction '{direction}'")


# shadow the basic registration with the full-featured op (the default
# arguments reproduce the original behavior exactly)
register("lstmLayer", _lstm_layer_full)
