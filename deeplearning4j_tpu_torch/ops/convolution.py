"""The convolution, pooling and resampling ops of
``deeplearning4j_tpu/ops/convolution.py``: 2-D in both layouts, 1-D
(``[N, C, T]``, with causal mode) and 3-D (``[N, C, D, H, W]``)
channels-first.

The JAX package leaves convolutions to XLA; the port leaves them to
``F.conv2d`` and ``F.conv_transpose2d`` (cuDNN on the card). Weights stay
``[O, I, kH, kW]``; a depthwise weight is ``[mult, I, kH, kW]``.

Layouts: ``data_format="NCHW"`` takes and returns ``[N, C, H, W]``;
``"NHWC"`` takes and returns ``[N, H, W, C]``. An NHWC tensor is handed
to torch as its NCHW-shaped permuted view, which is ``channels_last`` in
memory when the NHWC tensor is contiguous, so cuDNN runs channels-last
and the result permutes back to a contiguous NHWC tensor without a copy.

Padding follows DL4J's ``ConvolutionMode``: ``truncate`` (explicit
symmetric padding, floor-divided output), ``causal`` (1-D only: a left
pad of ``(k-1)*dilation``, so an output sees no later step; the 2-D ops
refuse it) and ``same``: XLA's SAME, which
ignores the explicit padding and pads ``max((ceil(n/s)-1)*s + k' - n,
0)`` per spatial dim (``k'`` the dilated kernel), half of it (rounded
down) before and the rest after. Torch pads only symmetrically, so an
odd total pads with ``F.pad`` first.
"""

from __future__ import annotations

import math

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

IntOrPair = Union[int, Sequence[int]]


def _pair(v: IntOrPair, n: int = 2) -> Tuple[int, ...]:
    if isinstance(v, (tuple, list)):
        if len(v) != n:
            raise ValueError(f"expected {n} values, got {v}")
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _channels_first(data_format: str) -> bool:
    fmt = data_format.upper()
    if fmt not in ("NCHW", "NHWC"):
        raise ValueError(f"data_format must be 'NCHW' or 'NHWC', got "
                         f"{data_format!r}")
    return fmt == "NCHW"


def _check_mode(mode: str, causal: bool = False) -> None:
    """Refuse a mode the op does not take; ``causal`` is the 1-D ops'."""
    ok = ("truncate", "strict", "same") + (("causal",) if causal else ())
    if mode.lower() not in ok:
        raise NotImplementedError(f"convolution mode {mode!r}: only "
                                  "'truncate', 'strict' and 'same' are "
                                  "ported for 2-D and 3-D (causal is 1-D)")


def _to_torch(x, cf: bool):
    """The NCHW-shaped tensor torch's conv/pool take (a view for NHWC)."""
    if cf:
        return x
    xc = x.permute(0, 3, 1, 2)
    if not xc.is_contiguous(memory_format=torch.channels_last):
        xc = xc.contiguous(memory_format=torch.channels_last)
    return xc


def _from_torch(y, cf: bool):
    return y if cf else y.permute(0, 2, 3, 1)


def _bias_reshape(b, ndim_spatial: int, data_format: str):
    if _channels_first(data_format):
        return b.reshape((1, -1) + (1,) * ndim_spatial)
    return b.reshape((1,) + (1,) * ndim_spatial + (-1,))


def _same_pad(xt, kernel, stride, dilation=None, value=0.0):
    """XLA's SAME padding of a channels-first tensor of any spatial rank:
    ``(xt, padding)``, the symmetric part left to the op's ``padding``
    and an odd remainder padded after with ``F.pad``."""
    dilation = dilation or (1,) * len(kernel)
    pads = [same_padding(n, (k - 1) * d + 1, s) for n, k, s, d
            in zip(xt.shape[2:], kernel, stride, dilation)]
    extra = []
    for lo, hi in reversed(pads):
        extra += [0, hi - lo]
    if any(extra):
        xt = F.pad(xt, extra, value=value)
    return xt, tuple(lo for lo, _ in pads)


def _channels_first_nd(data_format: str, names) -> None:
    if data_format.upper() not in names + ("CHANNELS_FIRST",):
        raise ValueError(f"data_format must be one of {names}, got "
                         f"{data_format!r} (channels-last 1-D/3-D is not "
                         "ported)")


#: calls whose shape contract held: (op, x shape, w shape, settings...)
_CHECKED: set = set()
_CHECKED_MAX = 4096


def _check_call(op, x, w, *, stride, pad, dilation, mode, data_format,
                groups=1):
    """The op's shape contract (``ops.shapes``): an input of the wrong
    rank, channel count or spatial size raises ``OpShapeError`` (or
    ``ValueError``) with the op's message, before torch would. The
    contract reads shapes and settings only, so each distinct call is
    checked once, as the JAX package checks once a trace, and a repeat
    costs one set lookup on the host."""
    key = None
    if hasattr(x, "shape") and hasattr(w, "shape"):
        # a torch.Size hashes and compares as the tuple it is
        key = (op, x.shape, w.shape, stride, pad, dilation, mode,
               data_format, groups)
        try:
            if key in _CHECKED:
                return
        except TypeError:           # a list among the settings
            key = None
    from deeplearning4j_tpu_torch.ops import shapes
    shapes.check_call(op, x, w, None, stride=stride, pad=pad,
                      dilation=dilation, mode=mode, data_format=data_format,
                      groups=groups)
    if key is not None and len(_CHECKED) < _CHECKED_MAX:
        _CHECKED.add(key)


def conv1d(x, w, b=None, *, stride: int = 1, pad: int = 0,
           dilation: int = 1, mode: str = "truncate",
           data_format: str = "NCW", groups: int = 1):
    """1D convolution (ref: ``conv1d``) of x [N, C, T] with w [O, C/groups,
    k]; causal mode left-pads ``(k-1)*dilation``."""
    _check_call("conv1d", x, w, stride=stride, pad=pad, dilation=dilation,
                mode=mode, data_format=data_format, groups=groups)
    _check_mode(mode, causal=True)
    _channels_first_nd(data_format, ("NCW",))
    k, s, d = int(w.shape[2]), int(stride), int(dilation)
    p = int(pad)
    if mode.lower() == "same":
        x, (p,) = _same_pad(x, (k,), (s,), (d,))
    elif mode.lower() == "causal":
        x, p = F.pad(x, ((k - 1) * d, 0)), 0
    out = F.conv1d(x, w, None, stride=s, padding=p, dilation=d,
                   groups=groups)
    if b is not None:
        out = out + b.reshape(1, -1, 1)
    return out


def conv3d(x, w, b=None, *, stride: IntOrPair = 1, pad: IntOrPair = 0,
           dilation: IntOrPair = 1, mode: str = "truncate",
           data_format: str = "NCDHW"):
    """3D convolution (ref: ``conv3dnew``) of x [N, C, D, H, W] with w
    [O, C, kD, kH, kW]."""
    _check_call("conv3d", x, w, stride=stride, pad=pad, dilation=dilation,
                mode=mode, data_format=data_format)
    _check_mode(mode)
    _channels_first_nd(data_format, ("NCDHW",))
    stride, pad, dilation = _pair(stride, 3), _pair(pad, 3), \
        _pair(dilation, 3)
    if mode.lower() == "same":
        x, pad = _same_pad(x, tuple(w.shape[2:]), stride, dilation)
    out = F.conv3d(x, w, None, stride=stride, padding=pad,
                   dilation=dilation)
    if b is not None:
        out = out + b.reshape(1, -1, 1, 1, 1)
    return out


def conv2d(x, w, b=None, *, stride: IntOrPair = 1, pad: IntOrPair = 0,
           dilation: IntOrPair = 1, mode: str = "truncate",
           data_format: str = "NCHW", groups: int = 1):
    """2D convolution (ref: libnd4j ``conv2d``), ``w`` in OIHW
    (``[O, I/groups, kH, kW]``). The bias is added after the convolution,
    as the JAX package does."""
    _check_call("conv2d", x, w, stride=stride, pad=pad, dilation=dilation,
                mode=mode, data_format=data_format, groups=groups)
    _check_mode(mode)
    cf = _channels_first(data_format)
    xt = _to_torch(x, cf)
    stride, dilation = _pair(stride), _pair(dilation)
    if mode.lower() == "same":
        xt, pad = _same_pad(xt, tuple(w.shape[2:]), stride, dilation)
    out = F.conv2d(xt, w, None, stride=stride, padding=_pair(pad),
                   dilation=dilation, groups=groups)
    out = _from_torch(out, cf)
    if b is not None:
        out = out + _bias_reshape(b, 2, data_format)
    return out


def deconv2d(x, w, b=None, *, stride: IntOrPair = 1, pad: IntOrPair = 0,
             mode: str = "truncate", data_format: str = "NCHW"):
    """Transposed convolution (ref: ``deconv2d``), ``w`` ``[O, I, kH,
    kW]`` as the JAX package's (its conv of the stride-dilated input with
    the flipped kernel is ``F.conv_transpose2d`` with the weight's two
    channel axes swapped). Truncate mode: ``(n-1)*s + k - 2p`` outputs.
    Same mode: ``n*s`` outputs where ``k >= s``; the JAX package crops
    ``max(k-s, 0)`` from the full ``(n-1)*s + k``, half (rounded down)
    before and the rest after."""
    _check_mode(mode)
    cf = _channels_first(data_format)
    stride = _pair(stride)
    wt = w.transpose(0, 1)
    if mode.lower() == "same":
        out = F.conv_transpose2d(_to_torch(x, cf), wt, None, stride=stride)
        crops = [max(k - s, 0) for k, s in zip(w.shape[2:], stride)]
        h, wd = out.shape[2:]
        out = out[:, :, crops[0] // 2:h - (crops[0] - crops[0] // 2),
                  crops[1] // 2:wd - (crops[1] - crops[1] // 2)]
    else:
        out = F.conv_transpose2d(_to_torch(x, cf), wt, None, stride=stride,
                                 padding=_pair(pad))
    out = _from_torch(out, cf)
    if b is not None:
        out = out + _bias_reshape(b, 2, data_format)
    return out


def depthwise_conv2d(x, w, b=None, *, stride: IntOrPair = 1,
                     pad: IntOrPair = 0, dilation: IntOrPair = 1,
                     mode: str = "truncate", data_format: str = "NCHW"):
    """Depthwise convolution (ref: ``depthwise_conv2d``), ``w`` ``[mult,
    I, kH, kW]``: a grouped conv with ``groups=I`` whose output channel
    ``c*mult + m`` is input channel c under multiplier m (the JAX
    package's ``feature_group_count`` order, which torch's groups share)."""
    mult, in_c = int(w.shape[0]), int(w.shape[1])
    w_g = w.transpose(0, 1).reshape((in_c * mult, 1) + tuple(w.shape[2:]))
    return conv2d(x, w_g, b, stride=stride, pad=pad, dilation=dilation,
                  mode=mode, data_format=data_format, groups=in_c)


def separable_conv2d(x, w_depth, w_point, b=None, *, stride: IntOrPair = 1,
                     pad: IntOrPair = 0, dilation: IntOrPair = 1,
                     mode: str = "truncate", data_format: str = "NCHW"):
    """Separable convolution (ref: ``sconv2d``): depthwise, then a 1x1
    pointwise ``w_point`` ``[O, I*mult, 1, 1]`` with the bias."""
    y = depthwise_conv2d(x, w_depth, None, stride=stride, pad=pad,
                         dilation=dilation, mode=mode,
                         data_format=data_format)
    return conv2d(y, w_point, b, data_format=data_format)


def maxpool2d(x, *, kernel: IntOrPair, stride: IntOrPair = None,
              pad: IntOrPair = 0, mode: str = "truncate",
              data_format: str = "NCHW"):
    """Max pooling (ref: ``maxpool2d``); padding counts as -inf."""
    return _pool(x, "max", kernel, stride, pad, mode, data_format)


def avgpool2d(x, *, kernel: IntOrPair, stride: IntOrPair = None,
              pad: IntOrPair = 0, mode: str = "truncate",
              data_format: str = "NCHW"):
    """Average pooling (ref: ``avgpool2d``); padding is left out of each
    window's count, as in the reference."""
    return _pool(x, "avg", kernel, stride, pad, mode, data_format)


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: ``(before, after)``."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pnormpool2d(x, *, kernel: IntOrPair, stride: IntOrPair = None,
                pad: IntOrPair = 0, pnorm: int = 2, mode: str = "truncate",
                data_format: str = "NCHW"):
    """P-norm pooling (ref: ``pnormpool2d``): ``(sum |x|^p)^(1/p)`` over
    each window, padding counting as zeros."""
    _check_mode(mode)
    cf = _channels_first(data_format)
    kernel = _pair(kernel)
    stride = _pair(stride if stride is not None else kernel)
    p = float(pnorm)
    xt = _to_torch(x, cf).abs() ** p
    if mode.lower() == "same":
        xt, pad = _same_pad(xt, kernel, stride)
    ph, pw = _pair(pad)
    if ph or pw:
        xt = F.pad(xt, (pw, pw, ph, ph))
    sums = F.avg_pool2d(xt, kernel, stride, divisor_override=1)
    return _from_torch(sums ** (1.0 / p), cf)


_MAX_POOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool(x, kind: str, kernel, stride, pad, mode, data_format,
          ndim: int = 2):
    _check_mode(mode)
    if ndim == 2:
        cf = _channels_first(data_format)
    else:
        _channels_first_nd(data_format, ("NCW",) if ndim == 1
                           else ("NCDHW",))
        cf = True
    kernel = _pair(kernel, ndim)
    stride = _pair(stride if stride is not None else kernel, ndim)
    pad = _pair(pad, ndim)
    xt = _to_torch(x, cf)
    if mode.lower() == "same":
        return _from_torch(_pool_same(xt, kind, kernel, stride), cf)
    if kind == "max":
        out = _MAX_POOL[ndim](xt, kernel, stride, pad)
    elif kind == "avg":
        out = _AVG_POOL[ndim](xt, kernel, stride, pad,
                              count_include_pad=False)
    else:
        raise ValueError(kind)
    return _from_torch(out, cf)


def _window_sum(xt, kernel, stride):
    """Each window's sum (no padding) of a channels-first tensor."""
    if xt.dim() == 3:       # avg_pool1d has no divisor_override
        return F.avg_pool2d(xt[:, :, None], (1, kernel[0]), (1, stride[0]),
                            divisor_override=1)[:, :, 0]
    return _AVG_POOL[xt.dim() - 2](xt, kernel, stride, divisor_override=1)


def _pool_same(xt, kind: str, kernel, stride):
    """Same-mode pooling of a channels-first tensor: pad (``-inf`` for
    max, zeros for avg), pool with no padding; avg divides each window's
    fp32 sum by its count of real elements."""
    pads = [same_padding(n, k, s) for n, k, s in
            zip(xt.shape[2:], kernel, stride)]
    spatial = [p for lo_hi in reversed(pads) for p in lo_hi]
    if kind == "max":
        return _MAX_POOL[len(kernel)](F.pad(xt, spatial, value=-math.inf),
                                      kernel, stride)
    if kind != "avg":
        raise ValueError(kind)
    sums = _window_sum(F.pad(xt.float(), spatial), kernel, stride)
    ones = torch.ones((1, 1) + tuple(xt.shape[2:]), dtype=torch.float32,
                      device=xt.device)
    counts = _window_sum(F.pad(ones, spatial), kernel, stride)
    return (sums / counts).to(xt.dtype)


def maxpool1d(x, *, kernel: int, stride: int = None, pad: int = 0,
              mode: str = "truncate", data_format: str = "NCW"):
    """Max pooling over T of [N, C, T]."""
    return _pool(x, "max", kernel, stride, pad, mode, data_format, 1)


def avgpool1d(x, *, kernel: int, stride: int = None, pad: int = 0,
              mode: str = "truncate", data_format: str = "NCW"):
    """Average pooling over T of [N, C, T]; padding is left out of each
    window's count."""
    return _pool(x, "avg", kernel, stride, pad, mode, data_format, 1)


def maxpool3d(x, *, kernel: IntOrPair, stride: IntOrPair = None,
              pad: IntOrPair = 0, mode: str = "truncate",
              data_format: str = "NCDHW"):
    """Max pooling of [N, C, D, H, W]."""
    return _pool(x, "max", kernel, stride, pad, mode, data_format, 3)


def avgpool3d(x, *, kernel: IntOrPair, stride: IntOrPair = None,
              pad: IntOrPair = 0, mode: str = "truncate",
              data_format: str = "NCDHW"):
    """Average pooling of [N, C, D, H, W]."""
    return _pool(x, "avg", kernel, stride, pad, mode, data_format, 3)


def global_pool(x, pooling_type: str = "avg", data_format: str = "NCHW",
                keepdims: bool = False, pnorm: int = 2, mask=None):
    """Global pooling over every spatial or time dim (ref:
    ``GlobalPoolingLayer``). A ``[N, T]`` mask of an ``[N, C, T]`` input
    pools the active steps only (avg, max and sum)."""
    cf = _channels_first(data_format)
    axes = tuple(range(2, x.dim())) if cf else tuple(range(1, x.dim() - 1))
    if mask is not None:
        m = mask
        while m.dim() < x.dim():
            m = m.unsqueeze(1 if cf else -1)
        if pooling_type == "avg":
            s = torch.sum(x * m, dim=axes, keepdim=keepdims)
            n = torch.sum(m, dim=axes, keepdim=keepdims)
            return s / torch.clamp_min(n, 1e-8)
        if pooling_type == "max":
            return torch.amax(torch.where(m > 0, x, -math.inf), dim=axes,
                              keepdim=keepdims)
        if pooling_type == "sum":
            return torch.sum(x * m, dim=axes, keepdim=keepdims)
    if pooling_type == "avg":
        return torch.mean(x, dim=axes, keepdim=keepdims)
    if pooling_type == "max":
        return torch.amax(x, dim=axes, keepdim=keepdims)
    if pooling_type == "sum":
        return torch.sum(x, dim=axes, keepdim=keepdims)
    if pooling_type == "pnorm":
        return torch.sum(x.abs() ** pnorm, dim=axes,
                         keepdim=keepdims) ** (1.0 / pnorm)
    raise ValueError(pooling_type)


# -------------------------------------------------------------- resampling
def upsampling2d(x, scale: IntOrPair = 2, data_format: str = "NCHW"):
    """Nearest-neighbour upsampling (ref: ``upsampling2d``): each pixel
    repeated ``scale`` times along H and W (a broadcast view, one copy)."""
    sh, sw = _pair(scale)
    if _channels_first(data_format):
        n, c, h, w = x.shape
        return x[:, :, :, None, :, None].expand(n, c, h, sh, w, sw) \
            .reshape(n, c, h * sh, w * sw)
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, sh, w, sw, c) \
        .reshape(n, h * sh, w * sw, c)


def space_to_depth(x, block_size: int, data_format: str = "NCHW"):
    """(ref: ``space_to_depth``) Output channel ``(bh*b + bw)*C + c`` holds
    input channel c at offset (bh, bw) of each block, the JAX package's
    (bh, bw, c) order in both layouts (``F.pixel_unshuffle`` gives
    (c, bh, bw))."""
    b = int(block_size)
    if _channels_first(data_format):
        n, c, h, w = x.shape
        x = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
        return x.reshape(n, c * b * b, h // b, w // b)
    n, h, w, c = x.shape
    x = x.reshape(n, h // b, b, w // b, b, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // b, w // b, c * b * b)


def depth_to_space(x, block_size: int, data_format: str = "NCHW"):
    """(ref: ``depth_to_space``) The inverse of :func:`space_to_depth`."""
    b = int(block_size)
    if _channels_first(data_format):
        n, c, h, w = x.shape
        x = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
        return x.reshape(n, c // (b * b), h * b, w * b)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, b, b, c // (b * b)).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * b, w * b, c // (b * b))


def _edges(v):
    """An int, ``(h, w)`` or ``((top, bottom), (left, right))`` as the
    latter."""
    if isinstance(v, int):
        return (v, v), (v, v)
    if isinstance(v[0], int):
        return (v[0], v[0]), (v[1], v[1])
    return tuple(v[0]), tuple(v[1])


def zero_padding2d(x, pad, data_format: str = "NCHW"):
    """(ref: ``ZeroPaddingLayer``) ``pad``: an int, ``(h, w)`` or
    ``((top, bottom), (left, right))``."""
    (t, bm), (l, r) = _edges(pad)
    if _channels_first(data_format):
        return F.pad(x, (l, r, t, bm))
    return F.pad(x, (0, 0, l, r, t, bm))


def cropping2d(x, crop, data_format: str = "NCHW"):
    """(ref: ``Cropping2D``) ``crop`` as :func:`zero_padding2d`'s pad."""
    (t, bm), (l, r) = _edges(crop)
    if _channels_first(data_format):
        h, w = x.shape[2], x.shape[3]
        return x[:, :, t:h - bm, l:w - r]
    h, w = x.shape[1], x.shape[2]
    return x[:, t:h - bm, l:w - r, :]


def im2col(x, kernel: IntOrPair, stride: IntOrPair = 1, pad: IntOrPair = 0,
           dilation: IntOrPair = 1):
    """(ref: libnd4j ``helpers::im2col``; kept for API parity, no conv
    path uses it) ``x`` [N, C, H, W] -> [N, C, kH, kW, oH, oW], zero
    padded, ``F.unfold``'s patches in the reference's layout."""
    k, s, p, d = (_pair(v) for v in (kernel, stride, pad, dilation))
    n, c, h, w = x.shape
    oh, ow = (conv_output_size(size, *args) for size, args in
              zip((h, w), zip(k, s, p, d)))
    cols = F.unfold(x, k, dilation=d, padding=p, stride=s)
    return cols.reshape(n, c, k[0], k[1], oh, ow)


def conv_output_size(size: int, kernel: int, stride: int, pad: int,
                     dilation: int = 1, mode: str = "truncate") -> int:
    """Shape inference for conv/pool (ref: ``ConvolutionUtils.
    getOutputSize``), which rejects a spatial output of zero; same mode
    gives ``ceil(size / stride)`` whatever the kernel and padding, and
    causal ``(size - 1) // stride + 1`` (the left pad keeps the length at
    stride 1)."""
    _check_mode(mode, causal=True)
    if mode.lower() == "same":
        return -(-size // stride)
    if mode.lower() == "causal":
        return (size - 1) // stride + 1
    eff_k = kernel + (kernel - 1) * (dilation - 1)
    out = (size + 2 * pad - eff_k) // stride + 1
    if out <= 0:
        raise ValueError(
            f"conv/pool output size {out} <= 0 for input size {size}, "
            f"kernel {kernel} (dilation {dilation}), stride {stride}, "
            f"pad {pad} — the layer cannot be applied to this input "
            f"(ref: ConvolutionUtils.getOutputSize validation)")
    return out
