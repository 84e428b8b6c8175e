"""Convolution and pooling ops (the slice's subset of
``deeplearning4j_tpu/ops/convolution.py``).

The JAX package leaves convolutions to XLA; the port leaves them to
``F.conv2d`` (cuDNN on the card). Weights stay ``[O, I, kH, kW]``.

Layouts: ``data_format="NCHW"`` takes and returns ``[N, C, H, W]``;
``"NHWC"`` takes and returns ``[N, H, W, C]``. An NHWC tensor is handed
to torch as its NCHW-shaped permuted view, which is ``channels_last`` in
memory when the NHWC tensor is contiguous, so cuDNN runs channels-last
and the result permutes back to a contiguous NHWC tensor without a copy.

Padding follows DL4J's ``ConvolutionMode``: ``truncate`` (explicit
symmetric padding, floor-divided output) for convolutions and pooling,
and ``same`` for pooling: XLA's SAME, which ignores the explicit padding
and pads ``max((ceil(n/s)-1)*s + k - n, 0)`` per spatial dim, half of it
(rounded down) before and the rest after. Torch's pools pad only
symmetrically, so same mode pads with ``F.pad`` first.
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


def _check_mode(mode: str, pooling: bool = False) -> None:
    ported = ("truncate", "strict", "same") if pooling \
        else ("truncate", "strict")
    if mode.lower() not in ported:
        raise NotImplementedError(
            f"{'pooling' if pooling else 'convolution'} mode {mode!r}: only "
            f"{', '.join(repr(m) for m in ported)} ported")


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


def conv2d(x, w, b=None, *, stride: IntOrPair = 1, pad: IntOrPair = 0,
           dilation: IntOrPair = 1, mode: str = "truncate",
           data_format: str = "NCHW"):
    """2D convolution (ref: libnd4j ``conv2d``), ``w`` in OIHW. The bias
    is added after the convolution, as the JAX package does."""
    _check_mode(mode)
    cf = _channels_first(data_format)
    out = F.conv2d(_to_torch(x, cf), w, None, stride=_pair(stride),
                   padding=_pair(pad), dilation=_pair(dilation))
    out = _from_torch(out, cf)
    if b is not None:
        out = out + _bias_reshape(b, 2, data_format)
    return out


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


def _pool(x, kind: str, kernel, stride, pad, mode, data_format):
    _check_mode(mode, pooling=True)
    cf = _channels_first(data_format)
    kernel = _pair(kernel)
    stride = _pair(stride if stride is not None else kernel)
    pad = _pair(pad)
    xt = _to_torch(x, cf)
    if mode.lower() == "same":
        return _from_torch(_pool_same(xt, kind, kernel, stride), cf)
    if kind == "max":
        out = F.max_pool2d(xt, kernel, stride, pad)
    elif kind == "avg":
        out = F.avg_pool2d(xt, kernel, stride, pad, count_include_pad=False)
    else:
        raise ValueError(kind)
    return _from_torch(out, cf)


def _pool_same(xt, kind: str, kernel, stride):
    """Same-mode pooling of an NCHW-shaped tensor: pad asymmetrically
    (``-inf`` for max, zeros for avg), pool with no padding; avg divides
    each window's fp32 sum by its count of real elements."""
    (pt, pb), (pl, pr) = (same_padding(n, k, s) for n, k, s in
                          zip(xt.shape[2:], kernel, stride))
    spatial = (pl, pr, pt, pb)
    if kind == "max":
        return F.max_pool2d(F.pad(xt, spatial, value=-math.inf), kernel,
                            stride)
    if kind != "avg":
        raise ValueError(kind)
    sums = F.avg_pool2d(F.pad(xt.float(), spatial), kernel, stride,
                        divisor_override=1)
    ones = torch.ones((1, 1) + tuple(xt.shape[2:]), dtype=torch.float32,
                      device=xt.device)
    counts = F.avg_pool2d(F.pad(ones, spatial), kernel, stride,
                          divisor_override=1)
    return (sums / counts).to(xt.dtype)


def global_pool(x, pooling_type: str = "avg", data_format: str = "NCHW",
                keepdims: bool = False):
    """Global pooling over every spatial dim (ref: ``GlobalPoolingLayer``)."""
    cf = _channels_first(data_format)
    axes = tuple(range(2, x.dim())) if cf else tuple(range(1, x.dim() - 1))
    if pooling_type == "avg":
        return torch.mean(x, dim=axes, keepdim=keepdims)
    if pooling_type == "max":
        return torch.amax(x, dim=axes, keepdim=keepdims)
    if pooling_type == "sum":
        return torch.sum(x, dim=axes, keepdim=keepdims)
    raise ValueError(pooling_type)


def conv_output_size(size: int, kernel: int, stride: int, pad: int,
                     dilation: int = 1, mode: str = "truncate") -> int:
    """Shape inference for conv/pool (ref: ``ConvolutionUtils.
    getOutputSize``), which rejects a spatial output of zero; same mode
    gives ``ceil(size / stride)`` whatever the kernel and padding."""
    _check_mode(mode, pooling=True)
    if mode.lower() == "same":
        return -(-size // stride)
    eff_k = kernel + (kernel - 1) * (dilation - 1)
    out = (size + 2 * pad - eff_k) // stride + 1
    if out <= 0:
        raise ValueError(
            f"conv/pool output size {out} <= 0 for input size {size}, "
            f"kernel {kernel} (dilation {dilation}), stride {stride}, "
            f"pad {pad}")
    return out
