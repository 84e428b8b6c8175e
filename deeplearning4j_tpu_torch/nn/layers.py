"""Layer configurations and their forward passes: the layers of
``deeplearning4j_tpu/nn/layers.py`` (feed-forward, embedding, 1-D, 2-D
and 3-D convolutional, recurrent, normalization, noise, attention and
wrapper layers, and ``SameDiffLayer``, a layer defined as a SameDiff
graph fragment).

The recurrent layers take DL4J's ``[N, C, T]`` and an optional ``[N, T]``
feature mask; those with a state (LSTM, GravesLSTM, GRU, SimpleRnn) also
run ``apply_with_state``, the carry of ``rnnTimeStep`` and truncated
BPTT, and make its zero start (``zero_state``). A wrapper's params
(Bidirectional) are the wrapped layers' under flat ``fwd/``/``bwd/``
names.

Weight layouts match the reference (dense W [nIn, nOut], conv W
[nOut, nIn, kH, kW]). Each layer is ``apply(params, state, x, train) ->
(out, new_state)`` over plain dicts of tensors; gradients are autograd's.
``key`` (an ``ops.normalization.StepKey``, None outside a train step)
feeds dropout: ``dropOut`` is the RETAIN probability, as in the
reference, applied to the layer's input by Dense, Convolution, Output and
``DropoutLayer``. ``to_config``
/ ``layer_from_config`` write and read the JAX package's per-layer JSON
(the layer's attributes under its class name, the same attribute names).

Also here, as in the JAX package: the dtype policy's casts
(``policy_cast``), the NHWC compute-layout seam (``layout_step``,
``stamp_layout``) and the fused conv-bias + BN + relu/leaky epilogue
(``fused_bn_act``), which dispatches ``scale_shift_act`` through the op
registry.
"""

from __future__ import annotations

import copy
import math
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.config import InputType
from deeplearning4j_tpu_torch.nn.precision import normalize_dtype
from deeplearning4j_tpu_torch.ops import activations as act
from deeplearning4j_tpu_torch.ops import attention as attn_ops
from deeplearning4j_tpu_torch.ops import convolution as conv_ops
from deeplearning4j_tpu_torch.ops import losses as loss_ops
from deeplearning4j_tpu_torch.ops import normalization as norm_ops
from deeplearning4j_tpu_torch.ops import recurrent as rnn_ops
from deeplearning4j_tpu_torch.ops import registry


def _pair(v):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def _initialize(shape, init: str, gen: torch.Generator) -> torch.Tensor:
    """Weight init (ref: org.deeplearning4j.nn.weights.WeightInit), fp32
    on the CPU from ``gen``: the JAX package's schemes and fans (conv
    OIHW fan_in = I*kH*kW, fan_out = O*kH*kW; OIDHW likewise), drawn from
    torch's stream, so the values differ from JAX's threefry draws."""
    shape = tuple(int(s) for s in shape)
    init = init.lower()
    fan_in = shape[0] if len(shape) >= 1 else 1
    fan_out = shape[-1] if len(shape) >= 2 else 1
    if len(shape) in (4, 5):
        rf = math.prod(shape[2:])
        fan_in, fan_out = shape[1] * rf, shape[0] * rf

    def uniform(limit):
        return torch.rand(shape, generator=gen) * (2 * limit) - limit

    def normal(std):
        return torch.randn(shape, generator=gen) * std

    if init == "zeros":
        return torch.zeros(shape)
    if init == "ones":
        return torch.ones(shape)
    if init in ("xavier", "glorot_uniform"):
        return uniform(math.sqrt(6.0 / (fan_in + fan_out)))
    if init in ("xavier_gaussian", "glorot_normal"):
        return normal(math.sqrt(2.0 / (fan_in + fan_out)))
    if init in ("relu", "he", "he_normal"):
        return normal(math.sqrt(2.0 / fan_in))
    if init in ("he_uniform", "relu_uniform"):
        return uniform(math.sqrt(6.0 / fan_in))
    if init == "lecun_normal":
        return normal(math.sqrt(1.0 / fan_in))
    if init == "uniform":
        return uniform(1.0 / math.sqrt(fan_in))
    if init in ("normal", "gaussian"):
        return normal(1.0 / math.sqrt(fan_in))
    raise ValueError(f"unknown weight init '{init}'")


class Layer:
    """Base layer config. Subclasses define params + forward."""

    input_kind: Optional[str] = "ff"
    has_params = True
    #: compute layout of spatial (4-D) input; ``setComputeLayout("NHWC")``
    #: stamps layout-aware layers with an instance attribute
    data_format = "NCHW"

    def __init__(self, nOut: int = None, nIn: int = None,
                 activation: str = None, weightInit: str = None,
                 biasInit: float = 0.0, dropOut: float = 0.0,
                 l1: float = None, l2: float = None, name: str = None,
                 tiedWith: str = None, dataType: str = None):
        self.nOut = nOut
        self.nIn = nIn
        self.activation = activation
        self.weight_init = weightInit
        self.bias_init = biasInit
        self.dropout = dropOut   # RETAIN probability (reference semantics)
        self.l1 = l1
        self.l2 = l2
        self.name = name or type(self).__name__
        # weight-tie group label: layers sharing one group must land on
        # the same pipeline stage (analysis/distribution.py E103)
        self.tied_with = tiedWith
        # "float32" declares an fp32 island under a PrecisionPolicy
        self.dtype_override = None if dataType is None \
            else normalize_dtype(dataType)

    def set_defaults(self, base):
        if self.activation is None:
            self.activation = base.activation
        if self.weight_init is None:
            self.weight_init = base.weight_init
        if self.l1 is None:
            self.l1 = base.l1
        if self.l2 is None:
            self.l2 = base.l2

    def infer_nin(self, it: InputType):
        if self.nIn is None and it.kind in ("ff", "cnn_flat"):
            self.nIn = it.arrayElementsPerExample()
        elif self.nIn is None and it.kind == "cnn":
            self.nIn = it.channels
        elif self.nIn is None and it.kind == "rnn":
            self.nIn = it.size

    def expected_nin(self, it: InputType) -> Optional[int]:
        """Declared-shape hook for ``analysis/``: the nIn this layer's
        ``infer_nin`` would derive from ``it``, computed on a throwaway
        copy so the static linter can compare a user-declared nIn against
        the propagated input without mutating the config. May raise —
        subclasses' infer_nin validates geometry (the analyzer maps the
        exception to a diagnostic)."""
        probe = copy.deepcopy(self)
        probe.nIn = None
        probe.infer_nin(it)
        return probe.nIn

    def gemm_lane_dims(self):
        """Declared-shape hook for the Hopper layout lint (W101): the N
        dims of this layer's tensor-core GEMMs, the dims that pad to the
        GEMM's CTA tile (the JAX package's ``mxu_lane_dims``, whose dims
        pad to the MXU's 128 lanes). Default: nOut for any param-bearing
        layer; elementwise param layers override to [] and gated
        recurrent layers report their fused gate width."""
        return [self.nOut] if self.has_params and self.nOut else []

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """Declared parameter shapes without allocating anything — the
        static hook ``analysis/`` sizes shards, HBM footprints, and FLOP
        estimates from. Equal to the shapes ``initialize`` makes (pinned
        for every class by ``tests/test_torch_analysis.py``). Dense
        default (W [nIn, nOut] + b [nOut] when the layer has a bias);
        other layers override. Returns {} while nIn/nOut are
        unresolved."""
        if not self.has_params or not self.nIn or not self.nOut:
            return {}
        shapes = {"W": (self.nIn, self.nOut)}
        if getattr(self, "has_bias", True):
            shapes["b"] = (self.nOut,)
        return shapes

    def output_type(self, it: InputType) -> InputType:
        return InputType.feedForward(self.nOut)

    def initialize(self, gen: torch.Generator) -> Tuple[Dict, Dict]:
        return {}, {}

    def _dense_init(self, gen):
        params = {"W": _initialize((self.nIn, self.nOut), self.weight_init,
                                   gen)}
        if self.has_bias:
            params["b"] = torch.full((self.nOut,), float(self.bias_init))
        return params, {}

    def apply(self, params, state, x, train: bool, key=None):
        raise NotImplementedError

    def _maybe_dropout(self, x, train, key):
        if self.dropout and self.dropout < 1.0:
            return norm_ops.dropout(x, 1.0 - self.dropout, key, train=train)
        return x

    def to_config(self):
        d = {"@class": type(self).__name__}
        for k, v in self.__dict__.items():
            d[k] = list(v) if isinstance(v, tuple) else v
        return d

    @classmethod
    def from_config(cls, d):
        obj = cls.__new__(cls)
        for k, v in d.items():
            if k == "@class":
                continue
            if isinstance(v, list) and k in ("kernel", "stride", "padding",
                                             "dilation", "scale", "crop",
                                             "dims"):
                v = tuple(v)
            setattr(obj, k, v)
        return obj

    def __repr__(self):
        return f"{type(self).__name__}(nIn={self.nIn}, nOut={self.nOut})"


class DenseLayer(Layer):
    """ref: DenseLayer — W [nIn, nOut], out = act(x W + b)."""

    def __init__(self, nOut=None, hasBias: bool = True, **kw):
        super().__init__(nOut=nOut, **kw)
        self.has_bias = hasBias

    def initialize(self, gen):
        return self._dense_init(gen)

    def apply(self, params, state, x, train, key=None):
        x = self._maybe_dropout(x, train, key)
        z = x @ params["W"]
        if self.has_bias:
            z = z + params["b"]
        return act.get(self.activation)(z), state


class ConvolutionLayer(Layer):
    """ref: ConvolutionLayer — W [nOut, nIn, kH, kW]."""

    input_kind = "cnn"

    def __init__(self, kernelSize=(3, 3), stride=(1, 1), padding=(0, 0),
                 nOut=None, dilation=(1, 1), convolutionMode: str = "truncate",
                 hasBias: bool = True, **kw):
        super().__init__(nOut=nOut, **kw)
        self.kernel = _pair(kernelSize)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.dilation = _pair(dilation)
        self.mode = convolutionMode
        self.has_bias = hasBias

    def param_shapes(self):
        if not self.nIn or not self.nOut:
            return {}
        shapes = {"W": (self.nOut, self.nIn) + tuple(self.kernel)}
        if self.has_bias:
            shapes["b"] = (self.nOut,)
        return shapes

    def initialize(self, gen):
        shape = (self.nOut, self.nIn) + self.kernel
        params = {"W": _initialize(shape, self.weight_init, gen)}
        if self.has_bias:
            params["b"] = torch.full((self.nOut,), float(self.bias_init))
        return params, {}

    def apply(self, params, state, x, train, key=None, *, skip_bias=False):
        x = self._maybe_dropout(x, train, key)
        out = conv_ops.conv2d(x, params["W"],
                              None if skip_bias else params.get("b"),
                              stride=self.stride, pad=self.padding,
                              dilation=self.dilation, mode=self.mode,
                              data_format=self.data_format)
        return act.get(self.activation)(out), state

    def output_type(self, it: InputType) -> InputType:
        conv_ops._check_mode(self.mode)          # causal is 1-D
        h = conv_ops.conv_output_size(it.height, self.kernel[0],
                                      self.stride[0], self.padding[0],
                                      self.dilation[0], self.mode)
        w = conv_ops.conv_output_size(it.width, self.kernel[1],
                                      self.stride[1], self.padding[1],
                                      self.dilation[1], self.mode)
        return InputType.convolutional(h, w, self.nOut)


class Deconvolution2D(ConvolutionLayer):
    """ref: Deconvolution2DLayer — W [nOut, nIn, kH, kW] (no dropout on
    its input, as in the JAX package)."""

    def apply(self, params, state, x, train, key=None):
        out = conv_ops.deconv2d(x, params["W"], params.get("b"),
                                stride=self.stride, pad=self.padding,
                                mode=self.mode, data_format=self.data_format)
        return act.get(self.activation)(out), state

    def output_type(self, it: InputType) -> InputType:
        (sh, sw), (kh, kw), (ph, pw) = self.stride, self.kernel, self.padding
        if self.mode.lower() == "same":
            h, w = it.height * sh, it.width * sw
        else:
            h = (it.height - 1) * sh + kh - 2 * ph
            w = (it.width - 1) * sw + kw - 2 * pw
        return InputType.convolutional(h, w, self.nOut)


class DepthwiseConvolution2D(ConvolutionLayer):
    """ref: DepthwiseConvolution2DLayer — W [mult, nIn, kH, kW], nOut
    ``nIn * mult``."""

    def __init__(self, depthMultiplier: int = 1, **kw):
        super().__init__(**kw)
        self.depth_multiplier = depthMultiplier

    def infer_nin(self, it):
        super().infer_nin(it)
        if self.nOut is None:
            self.nOut = self.nIn * self.depth_multiplier

    def param_shapes(self):
        if not self.nIn or not self.nOut:
            return {}
        shapes = {"W": (self.depth_multiplier, self.nIn)
                  + tuple(self.kernel)}
        if self.has_bias:
            shapes["b"] = (self.nOut,)
        return shapes

    def initialize(self, gen):
        shape = (self.depth_multiplier, self.nIn) + self.kernel
        params = {"W": _initialize(shape, self.weight_init, gen)}
        if self.has_bias:
            params["b"] = torch.full((self.nOut,), float(self.bias_init))
        return params, {}

    def apply(self, params, state, x, train, key=None):
        out = conv_ops.depthwise_conv2d(x, params["W"], params.get("b"),
                                        stride=self.stride, pad=self.padding,
                                        dilation=self.dilation, mode=self.mode,
                                        data_format=self.data_format)
        return act.get(self.activation)(out), state


class SeparableConvolution2D(ConvolutionLayer):
    """ref: SeparableConvolution2DLayer — depthwise ``Wd`` [mult, nIn, kH,
    kW], then pointwise ``Wp`` [nOut, nIn*mult, 1, 1] and the bias."""

    def __init__(self, depthMultiplier: int = 1, **kw):
        super().__init__(**kw)
        self.depth_multiplier = depthMultiplier

    def param_shapes(self):
        if not self.nIn or not self.nOut:
            return {}
        shapes = {"Wd": (self.depth_multiplier, self.nIn)
                  + tuple(self.kernel),
                  "Wp": (self.nOut, self.nIn * self.depth_multiplier, 1, 1)}
        if self.has_bias:
            shapes["b"] = (self.nOut,)
        return shapes

    def initialize(self, gen):
        params = {
            "Wd": _initialize((self.depth_multiplier, self.nIn) + self.kernel,
                              self.weight_init, gen),
            "Wp": _initialize((self.nOut, self.nIn * self.depth_multiplier,
                               1, 1), self.weight_init, gen)}
        if self.has_bias:
            params["b"] = torch.full((self.nOut,), float(self.bias_init))
        return params, {}

    def apply(self, params, state, x, train, key=None):
        out = conv_ops.separable_conv2d(x, params["Wd"], params["Wp"],
                                        params.get("b"), stride=self.stride,
                                        pad=self.padding,
                                        dilation=self.dilation,
                                        mode=self.mode,
                                        data_format=self.data_format)
        return act.get(self.activation)(out), state


class SubsamplingLayer(Layer):
    """ref: SubsamplingLayer (max/avg/pnorm pooling);
    ``convolutionMode="same"`` gives ``ceil(n / stride)`` outputs and
    ignores ``padding``, as XLA's SAME does."""

    input_kind = "cnn"
    has_params = False

    def __init__(self, poolingType: str = "max", kernelSize=(2, 2),
                 stride=(2, 2), padding=(0, 0),
                 convolutionMode: str = "truncate", pnorm: int = 2, **kw):
        super().__init__(**kw)
        self.pooling = poolingType.lower()
        self.kernel = _pair(kernelSize)
        self.stride = _pair(stride)
        self.padding = _pair(padding)
        self.mode = convolutionMode
        self.pnorm = pnorm

    def infer_nin(self, it):
        self.nIn = self.nOut = it.channels

    def apply(self, params, state, x, train, key=None):
        fn = {"max": conv_ops.maxpool2d, "avg": conv_ops.avgpool2d,
              "pnorm": conv_ops.pnormpool2d}[self.pooling]
        kw = {"kernel": self.kernel, "stride": self.stride,
              "pad": self.padding, "mode": self.mode,
              "data_format": self.data_format}
        if self.pooling == "pnorm":
            kw["pnorm"] = self.pnorm
        return fn(x, **kw), state

    def output_type(self, it: InputType) -> InputType:
        h = conv_ops.conv_output_size(it.height, self.kernel[0],
                                      self.stride[0], self.padding[0], 1,
                                      self.mode)
        w = conv_ops.conv_output_size(it.width, self.kernel[1],
                                      self.stride[1], self.padding[1], 1,
                                      self.mode)
        return InputType.convolutional(h, w, it.channels)


class BatchNormalization(Layer):
    """ref: BatchNormalization — running statistics in the layer state,
    ``decay`` 0.9 like the reference."""

    input_kind = None

    def __init__(self, decay: float = 0.9, eps: float = 1e-5, **kw):
        super().__init__(**kw)
        self.decay = decay
        self.eps = eps

    def infer_nin(self, it: InputType):
        if it.kind == "cnn":
            self.nIn = self.nOut = it.channels
        else:
            self.nIn = self.nOut = it.arrayElementsPerExample()

    def gemm_lane_dims(self):
        return []   # elementwise scale/shift — no GEMM

    def param_shapes(self):
        if not self.nIn:
            return {}
        return {"gamma": (self.nIn,), "beta": (self.nIn,)}

    def initialize(self, gen):
        n = self.nIn
        params = {"gamma": torch.ones(n), "beta": torch.zeros(n)}
        state = {"mean": torch.zeros(n), "var": torch.ones(n)}
        return params, state

    def _channel_axis(self, x) -> int:
        if x.dim() == 4 and self.data_format == "NHWC":
            return x.dim() - 1
        return 1 if x.dim() >= 3 else x.dim() - 1

    def apply(self, params, state, x, train, key=None):
        axis = self._channel_axis(x)
        if train:
            out, new_mean, new_var = norm_ops.batch_norm_train(
                x, params["gamma"], params["beta"], state["mean"],
                state["var"], eps=self.eps, decay=self.decay, axis=axis,
                sync=None if key is None else key.sync)
            return out, {"mean": new_mean, "var": new_var}
        out = norm_ops.batch_norm(x, params["gamma"], params["beta"],
                                  state["mean"], state["var"], eps=self.eps,
                                  axis=axis)
        return out, state

    def output_type(self, it: InputType) -> InputType:
        return it


class LocalResponseNormalization(Layer):
    """ref: LocalResponseNormalization — ``x / (k + alpha * sum x^2)^beta``
    over ``n`` neighbouring channels (alpha not divided by n, unlike
    ``F.local_response_norm``; ``k`` 2.0 as the reference's layer)."""

    input_kind = "cnn"
    has_params = False

    def __init__(self, n: int = 5, alpha: float = 1e-4, beta: float = 0.75,
                 k: float = 2.0, **kw):
        super().__init__(**kw)
        self.n = n
        self.alpha = alpha
        self.beta = beta
        self.k = k

    def infer_nin(self, it):
        self.nIn = self.nOut = it.channels

    def apply(self, params, state, x, train, key=None):
        return norm_ops.lrn(x, depth=self.n, alpha=self.alpha,
                            beta=self.beta, bias=self.k,
                            data_format=self.data_format), state

    def output_type(self, it):
        return it


class ActivationLayer(Layer):
    """ref: ActivationLayer."""

    input_kind = None
    has_params = False

    def __init__(self, activation="relu", **kw):
        super().__init__(activation=activation, **kw)

    def set_defaults(self, base):
        pass  # keeps its own activation

    def infer_nin(self, it):
        self.nIn = self.nOut = it.arrayElementsPerExample()

    def apply(self, params, state, x, train, key=None):
        return act.get(self.activation)(x), state

    def output_type(self, it):
        return it


class DropoutLayer(Layer):
    """ref: layers.DropoutLayer — ``dropOut`` is the RETAIN probability."""

    input_kind = None
    has_params = False

    def __init__(self, dropOut=0.5, **kw):
        super().__init__(dropOut=dropOut, **kw)

    def infer_nin(self, it):
        self.nIn = self.nOut = it.arrayElementsPerExample()

    def apply(self, params, state, x, train, key=None):
        return self._maybe_dropout(x, train, key), state

    def output_type(self, it):
        return it


class SpatialDropoutLayer(Layer):
    """Channel dropout (ref: SpatialDropout): whole feature maps of each
    example are zeroed, the rest scaled by ``1/keep``. ``rate`` is the
    DROP probability; the mask is ``dropout_mask`` over [N, C]. Input
    [N, C, *spatial]."""

    input_kind = None
    has_params = False

    def __init__(self, rate=0.5, **kw):
        super().__init__(**kw)
        self.rate = float(rate)

    def infer_nin(self, it):
        self.nIn = self.nOut = it.arrayElementsPerExample()

    def apply(self, params, state, x, train, key=None):
        if not train or self.rate <= 0.0:
            return x, state
        keep = 1.0 - self.rate
        shape = (x.shape[0], x.shape[1]) + (1,) * (x.dim() - 2)
        mask = norm_ops.dropout_mask(key, shape, keep, x.device).to(x.dtype)
        return x * mask / norm_ops.dtype_scalar(keep, x.dtype), state

    def output_type(self, it):
        return it


class ZeroPaddingLayer(Layer):
    """ref: ZeroPaddingLayer — ``padding`` an int, ``(h, w)`` or
    ``((top, bottom), (left, right))``."""

    input_kind = "cnn"
    has_params = False

    def __init__(self, padding=(1, 1), **kw):
        super().__init__(**kw)
        if isinstance(padding, int):
            self.pad = (padding, padding)
        elif all(isinstance(p, int) for p in padding):
            self.pad = tuple(int(p) for p in padding)
        else:
            self.pad = tuple(tuple(int(v) for v in p) for p in padding)

    def infer_nin(self, it):
        self.nIn = self.nOut = it.channels

    def apply(self, params, state, x, train, key=None):
        return conv_ops.zero_padding2d(x, self.pad,
                                       data_format=self.data_format), state

    def output_type(self, it):
        (t, b), (l, r) = conv_ops._edges(self.pad)
        return InputType.convolutional(it.height + t + b, it.width + l + r,
                                       it.channels)


class Upsampling2D(Layer):
    """ref: Upsampling2D (nearest neighbour)."""

    input_kind = "cnn"
    has_params = False

    def __init__(self, size=2, **kw):
        super().__init__(**kw)
        self.scale = _pair(size)

    def infer_nin(self, it):
        self.nIn = self.nOut = it.channels

    def apply(self, params, state, x, train, key=None):
        return conv_ops.upsampling2d(x, self.scale,
                                     data_format=self.data_format), state

    def output_type(self, it):
        return InputType.convolutional(it.height * self.scale[0],
                                       it.width * self.scale[1], it.channels)


class Cropping2D(Layer):
    """ref: Cropping2D — ``crop`` as ZeroPaddingLayer's ``padding``."""

    input_kind = "cnn"
    has_params = False

    def __init__(self, crop=(1, 1), **kw):
        super().__init__(**kw)
        self.crop = tuple(crop)

    def infer_nin(self, it):
        self.nIn = self.nOut = it.channels

    def apply(self, params, state, x, train, key=None):
        return conv_ops.cropping2d(x, self.crop,
                                   data_format=self.data_format), state

    def output_type(self, it):
        (t, b), (l, r) = conv_ops._edges(self.crop)
        return InputType.convolutional(it.height - t - b, it.width - l - r,
                                       it.channels)


class GlobalPoolingLayer(Layer):
    """ref: GlobalPoolingLayer — cnn [N, C, H, W] or rnn [N, C, T] ->
    [N, C]; a ``[N, T]`` mask of an rnn input pools the active steps
    only."""

    input_kind = None
    has_params = False

    def __init__(self, poolingType: str = "max", **kw):
        super().__init__(**kw)
        self.pooling = poolingType.lower()

    def infer_nin(self, it):
        self.nIn = self.nOut = self._pooled(it)

    @staticmethod
    def _pooled(it):
        return it.channels if it.kind in ("cnn", "cnn3d") \
            else it.size if it.kind == "rnn" else it.arrayElementsPerExample()

    def apply(self, params, state, x, train, key=None, mask=None):
        # the NHWC stamp applies to spatial input only; rnn [N, C, T]
        # stays channels-second
        fmt = self.data_format if x.dim() == 4 else "NCHW"
        return conv_ops.global_pool(x, self.pooling, data_format=fmt,
                                    mask=mask), state

    def output_type(self, it):
        return InputType.feedForward(self._pooled(it))


# ------------------------------------------------------------------ recurrent
def _sub_params(params, prefix: str):
    """A wrapped layer's params out of its wrapper's flat dict
    (``"fwd/W"`` -> ``"W"``)."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + "/")}


def _prefixed(params, prefix: str):
    return {f"{prefix}/{k}": v for k, v in params.items()}


class _Recurrent(Layer):
    """The shared plumbing of the recurrent layers: input [N, nIn, T] ->
    [N, nOut, T], the activation tanh unless given (an inherited
    ``identity`` becomes tanh, as in the reference)."""

    input_kind = "rnn"

    def __init__(self, nOut=None, **kw):
        super().__init__(nOut=nOut, **kw)
        if self.activation is None:
            self.activation = "tanh"

    def set_defaults(self, base):
        super().set_defaults(base)
        if self.activation == "identity":
            self.activation = "tanh"

    def apply(self, params, state, x, train, key=None, mask=None):
        out, _ = self.apply_with_state(params, x, None, mask=mask)
        return out, state

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.nOut, it.dims.get("timesteps", -1))


class LSTM(_Recurrent):
    """ref: layers.recurrent.LSTM — params ``W`` [nIn, 4H], ``RW`` [H, 4H],
    ``b`` [4H], gate order ``[i, f, g, o]``; the forget gate's bias starts
    at ``forgetGateBiasInit`` (1.0), as in the reference. Its state is
    ``(h, c)``."""

    def __init__(self, nOut=None, forgetGateBiasInit: float = 1.0, **kw):
        super().__init__(nOut=nOut, **kw)
        self.forget_bias = forgetGateBiasInit

    def gemm_lane_dims(self):
        return [4 * self.nOut] if self.nOut else []   # fused [i,f,g,o] gates

    def param_shapes(self):
        if not self.nIn or not self.nOut:
            return {}
        H = self.nOut
        return {"W": (self.nIn, 4 * H), "RW": (H, 4 * H), "b": (4 * H,)}

    def initialize(self, gen):
        H = self.nOut
        b = torch.zeros(4 * H)
        b[H:2 * H] = float(self.forget_bias)
        return {"W": _initialize((self.nIn, 4 * H), self.weight_init, gen),
                "RW": _initialize((H, 4 * H), self.weight_init, gen),
                "b": b}, {}

    def apply_with_state(self, params, x, rnn_state, mask=None):
        """The forward carrying ``(h, c)`` in and out (ref:
        MultiLayerNetwork.rnnTimeStep's state); None starts from zeros."""
        x_tnc, mask_tn = rnn_ops.time_major(x, mask)
        h0, c0 = rnn_state if rnn_state is not None else (None, None)
        outs, (hT, cT) = rnn_ops.lstm(x_tnc, params["W"], params["RW"],
                                      params["b"], h0=h0, c0=c0,
                                      mask_tn=mask_tn)
        return outs.permute(1, 2, 0), (hT, cT)

    def zero_state(self, n: int, dtype, device):
        z = torch.zeros((n, self.nOut), dtype=dtype, device=device)
        return (z, z.clone())


class GravesLSTM(LSTM):
    """ref: layers.recurrent.GravesLSTM — the JAX package's LSTM, without
    the reference's peephole connections."""


class GRU(_Recurrent):
    """ref: layers.recurrent.GRU — params ``W`` [nIn, 3H], ``RW`` [H, 3H],
    biases ``b`` and ``bR`` [3H], gate order ``[r, z, n]``. Its state is
    ``h``."""

    def gemm_lane_dims(self):
        return [3 * self.nOut] if self.nOut else []   # fused [r,z,n] gates

    def param_shapes(self):
        if not self.nIn or not self.nOut:
            return {}
        H = self.nOut
        return {"W": (self.nIn, 3 * H), "RW": (H, 3 * H),
                "b": (3 * H,), "bR": (3 * H,)}

    def initialize(self, gen):
        H = self.nOut
        return {"W": _initialize((self.nIn, 3 * H), self.weight_init, gen),
                "RW": _initialize((H, 3 * H), self.weight_init, gen),
                "b": torch.zeros(3 * H), "bR": torch.zeros(3 * H)}, {}

    def apply_with_state(self, params, x, rnn_state, mask=None):
        x_tnc, mask_tn = rnn_ops.time_major(x, mask)
        outs, hT = rnn_ops.gru(x_tnc, params["W"], params["RW"], params["b"],
                               params["bR"], h0=rnn_state, mask_tn=mask_tn)
        return outs.permute(1, 2, 0), hT

    def zero_state(self, n: int, dtype, device):
        return torch.zeros((n, self.nOut), dtype=dtype, device=device)


class SimpleRnn(_Recurrent):
    """ref: layers.recurrent.SimpleRnn — ``h = act(x W + h RW + b)``. Its
    state is ``h``."""

    def param_shapes(self):
        if not self.nIn or not self.nOut:
            return {}
        return {"W": (self.nIn, self.nOut), "RW": (self.nOut, self.nOut),
                "b": (self.nOut,)}

    def initialize(self, gen):
        return {"W": _initialize((self.nIn, self.nOut), self.weight_init, gen),
                "RW": _initialize((self.nOut, self.nOut), self.weight_init,
                                  gen),
                "b": torch.zeros(self.nOut)}, {}

    def apply_with_state(self, params, x, rnn_state, mask=None):
        x_tnc, mask_tn = rnn_ops.time_major(x, mask)
        outs, hT = rnn_ops.simple_rnn(x_tnc, params["W"], params["RW"],
                                      params["b"], h0=rnn_state,
                                      mask_tn=mask_tn,
                                      activation=act.get(self.activation))
        return outs.permute(1, 2, 0), hT

    def zero_state(self, n: int, dtype, device):
        return torch.zeros((n, self.nOut), dtype=dtype, device=device)


class Bidirectional(Layer):
    """ref: layers.recurrent.Bidirectional — a recurrent layer run forward
    and on the time-reversed input (its own weights), merged by
    ``concat``/``add``/``mul``/``average``. Params are the wrapped
    layers' under ``fwd/`` and ``bwd/`` (the JAX package's nested
    ``{"fwd": {...}, "bwd": {...}}``, flat here)."""

    input_kind = "rnn"

    def __init__(self, rnn_layer: Layer, mode: str = "concat", **kw):
        super().__init__(**kw)
        self.fwd = rnn_layer
        self.bwd = copy.deepcopy(rnn_layer)
        self.mode = mode.lower()

    def set_defaults(self, base):
        self.fwd.set_defaults(base)
        self.bwd.set_defaults(base)

    def infer_nin(self, it):
        self.fwd.infer_nin(it)
        self.bwd.infer_nin(it)
        self.nIn = self.fwd.nIn
        self.nOut = self.fwd.nOut * (2 if self.mode == "concat" else 1)

    def gemm_lane_dims(self):
        return self.fwd.gemm_lane_dims() + self.bwd.gemm_lane_dims()

    def param_shapes(self):
        out = {f"fwd/{k}": v for k, v in self.fwd.param_shapes().items()}
        out.update({f"bwd/{k}": v
                    for k, v in self.bwd.param_shapes().items()})
        return out

    def initialize(self, gen):
        pf, _ = self.fwd.initialize(gen)
        pb, _ = self.bwd.initialize(gen)
        return {**_prefixed(pf, "fwd"), **_prefixed(pb, "bwd")}, {}

    def _directions(self, params, x, train, key, mask):
        yf, _ = self.fwd.apply(_sub_params(params, "fwd"), {}, x, train, key,
                               mask=mask)
        yb, _ = self.bwd.apply(_sub_params(params, "bwd"), {},
                               torch.flip(x, dims=(2,)), train, key,
                               mask=None if mask is None
                               else torch.flip(mask, dims=(1,)))
        return yf, yb

    def _merge(self, f, b):
        if self.mode == "concat":
            return torch.cat([f, b], dim=1)
        if self.mode == "add":
            return f + b
        if self.mode == "mul":
            return f * b
        if self.mode == "average":
            return 0.5 * (f + b)
        raise ValueError(self.mode)

    def apply(self, params, state, x, train, key=None, mask=None):
        yf, yb = self._directions(params, x, train, key, mask)
        return self._merge(yf, torch.flip(yb, dims=(2,))), state

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.nOut, it.dims.get("timesteps", -1))

    def to_config(self):
        return {"@class": type(self).__name__, "mode": self.mode,
                "fwd": self.fwd.to_config(), "bwd": self.bwd.to_config(),
                "name": self.name, "nIn": self.nIn, "nOut": self.nOut}

    @classmethod
    def from_config(cls, d):
        obj = cls(layer_from_config(d["fwd"]), mode=d["mode"])
        if "bwd" in d:
            obj.bwd = layer_from_config(d["bwd"])
        obj.nIn, obj.nOut = d.get("nIn"), d.get("nOut")
        return obj


class BidirectionalLastStep(Bidirectional):
    """Bidirectional collapsed to one step with Keras semantics: the
    forward direction's last output merged with the backward direction's
    final state (input position 0) — unlike ``LastTimeStep(Bidirectional
    (...))``, which takes position T-1 of both. For Keras import parity;
    no sequence masks."""

    def apply(self, params, state, x, train, key=None, mask=None):
        if mask is not None:
            raise ValueError("BidirectionalLastStep does not support "
                             "sequence masks (imported-model inference "
                             "path); pad-free batches only")
        yf, yb = self._directions(params, x, train, key, None)
        if self.mode not in ("concat", "add", "mul"):
            return (yf[:, :, -1] + yb[:, :, -1]) / 2.0, state
        return self._merge(yf[:, :, -1], yb[:, :, -1]), state

    def output_type(self, it: InputType) -> InputType:
        return InputType.feedForward(self.nOut)


class LastTimeStep(Layer):
    """ref: layers.recurrent.LastTimeStep — the wrapped layer's output at
    each example's last active step (the last step without a mask), as
    feed-forward rows."""

    input_kind = "rnn"

    def __init__(self, rnn_layer: Layer, **kw):
        super().__init__(**kw)
        self.inner = rnn_layer

    def set_defaults(self, base):
        self.inner.set_defaults(base)

    def infer_nin(self, it):
        self.inner.infer_nin(it)
        self.nIn, self.nOut = self.inner.nIn, self.inner.nOut

    def gemm_lane_dims(self):
        return self.inner.gemm_lane_dims()

    def param_shapes(self):
        return self.inner.param_shapes()

    def initialize(self, gen):
        return self.inner.initialize(gen)

    def apply(self, params, state, x, train, key=None, mask=None):
        y, state = self.inner.apply(params, state, x, train, key, mask=mask)
        if mask is not None:
            # each example's last active step
            idx = torch.clamp_min((mask > 0).sum(dim=1) - 1, 0)
            return y[torch.arange(y.shape[0], device=y.device), :, idx], state
        return y[:, :, -1], state

    def output_type(self, it: InputType) -> InputType:
        return InputType.feedForward(self.inner.nOut)

    def to_config(self):
        return {"@class": "LastTimeStep", "inner": self.inner.to_config(),
                "name": self.name, "nIn": self.nIn, "nOut": self.nOut}

    @classmethod
    def from_config(cls, d):
        obj = LastTimeStep(layer_from_config(d["inner"]))
        obj.nIn, obj.nOut = d.get("nIn"), d.get("nOut")
        return obj


class BaseOutputLayer(Layer):
    """Common loss plumbing (ref: BaseOutputLayer)."""

    def __init__(self, lossFunction: str = "mcxent", **kw):
        super().__init__(**kw)
        self.loss_fn = lossFunction

    def compute_loss(self, labels, preds, mask=None):
        return loss_ops.get(self.loss_fn)(labels, preds, mask=mask)


class OutputLayer(BaseOutputLayer):
    """ref: OutputLayer — dense + activation + loss."""

    def __init__(self, nOut=None, lossFunction="mcxent", hasBias: bool = True,
                 **kw):
        super().__init__(lossFunction=lossFunction, nOut=nOut, **kw)
        self.has_bias = hasBias
        if self.activation is None:
            self.activation = "softmax"

    def set_defaults(self, base):
        super().set_defaults(base)
        if self.activation == "identity":
            self.activation = "softmax"

    def initialize(self, gen):
        return self._dense_init(gen)

    def apply(self, params, state, x, train, key=None):
        x = self._maybe_dropout(x, train, key)
        z = x @ params["W"]
        if self.has_bias:
            z = z + params["b"]
        return act.get(self.activation)(z), state


class LossLayer(BaseOutputLayer):
    """ref: LossLayer — the activation and the loss, no params."""

    has_params = False
    input_kind = None

    def __init__(self, lossFunction="mcxent", **kw):
        super().__init__(lossFunction=lossFunction, **kw)
        if self.activation is None:
            self.activation = "identity"

    def infer_nin(self, it):
        self.nIn = self.nOut = it.arrayElementsPerExample()

    def apply(self, params, state, x, train, key=None):
        return act.get(self.activation)(x), state

    def output_type(self, it):
        return it

class RnnOutputLayer(BaseOutputLayer):
    """ref: layers.recurrent.RnnOutputLayer — the dense projection at each
    step, [N, nIn, T] -> [N, nOut, T] (softmax over the classes), and the
    reference's loss: each example's per-step losses summed, divided by
    the minibatch size N (not N*T)."""

    input_kind = "rnn"

    def __init__(self, nOut=None, lossFunction="mcxent", **kw):
        super().__init__(lossFunction=lossFunction, nOut=nOut, **kw)
        if self.activation is None:
            self.activation = "softmax"

    def set_defaults(self, base):
        super().set_defaults(base)
        if self.activation == "identity":
            self.activation = "softmax"

    def param_shapes(self):
        if not self.nIn or not self.nOut:
            return {}
        return {"W": (self.nIn, self.nOut), "b": (self.nOut,)}

    def initialize(self, gen):
        return {"W": _initialize((self.nIn, self.nOut), self.weight_init,
                                 gen),
                "b": torch.zeros(self.nOut)}, {}

    def apply(self, params, state, x, train, key=None):
        z = torch.matmul(x.transpose(1, 2), params["W"]) + params["b"]
        fn = act.get(self.activation)
        a = fn(z, axis=-1) if self.activation in ("softmax", "logsoftmax") \
            else fn(z)
        return a.transpose(1, 2), state            # [N, T, V] -> [N, V, T]

    def compute_loss(self, labels, preds, mask=None):
        """labels/preds [N, C, T], mask [N, T]: time folds into the rows
        of the loss, whose mean over the (active) rows is scaled back to
        the sum over time divided by N."""
        n, c = labels.shape[0], labels.shape[1]
        lab = labels.transpose(1, 2).reshape(-1, c)
        pre = preds.transpose(1, 2).reshape(-1, preds.shape[1])
        m = mask.reshape(-1) if mask is not None else None
        per_row_mean = loss_ops.get(self.loss_fn)(lab, pre, mask=m)
        n_rows = torch.clamp_min(m.sum(), 1.0) if m is not None \
            else lab.shape[0]
        return per_row_mean * n_rows / n

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.nOut, it.dims.get("timesteps", -1))


# ----------------------------------------------------- embedding, 1-D
class EmbeddingLayer(Layer):
    """ref: EmbeddingLayer — int indices [N] (or [N, 1]) or one-hot rows
    [N, nIn] -> [N, nOut]."""

    def __init__(self, nOut=None, hasBias: bool = False, **kw):
        super().__init__(nOut=nOut, **kw)
        self.has_bias = hasBias

    def initialize(self, gen):
        return self._dense_init(gen)

    def apply(self, params, state, x, train, key=None):
        if x.is_floating_point() and x.dim() == 2 and x.shape[1] == self.nIn:
            out = x @ params["W"]                      # one-hot rows
        else:
            idx = x.long()
            if idx.dim() == 2 and idx.shape[1] == 1:
                idx = idx[:, 0]
            out = params["W"][idx]
        if self.has_bias:
            out = out + params["b"]
        return act.get(self.activation)(out), state


class EmbeddingSequenceLayer(Layer):
    """ref: EmbeddingSequenceLayer — int [N, T] (or [N, 1, T]) ->
    [N, nOut, T]."""

    input_kind = None

    def param_shapes(self):
        if not self.nIn or not self.nOut:
            return {}
        return {"W": (self.nIn, self.nOut)}

    def initialize(self, gen):
        return {"W": _initialize((self.nIn, self.nOut), self.weight_init,
                                 gen)}, {}

    def apply(self, params, state, x, train, key=None):
        idx = x.long()
        if idx.dim() == 3:
            idx = idx[:, 0, :]
        return params["W"][idx].transpose(1, 2), state

    def output_type(self, it: InputType) -> InputType:
        t = it.dims.get("timesteps", -1) if it.kind == "rnn" \
            else it.dims.get("size", -1)
        return InputType.recurrent(self.nOut, t)


def _first(v) -> int:
    return int(v[0] if isinstance(v, (tuple, list)) else v)


class Convolution1D(Layer):
    """ref: Convolution1DLayer — [N, nIn, T] -> [N, nOut, T'], W [nOut,
    nIn, k]; causal mode as the reference."""

    input_kind = "rnn"

    def __init__(self, kernelSize: int = 3, stride: int = 1,
                 padding: int = 0, nOut=None, dilation: int = 1,
                 convolutionMode: str = "same", hasBias: bool = True, **kw):
        super().__init__(nOut=nOut, **kw)
        self.kernel = _first(kernelSize)
        self.stride = _first(stride)
        self.padding = _first(padding)
        self.dilation = _first(dilation)
        self.mode = convolutionMode
        self.has_bias = hasBias

    def param_shapes(self):
        if not self.nIn or not self.nOut:
            return {}
        shapes = {"W": (self.nOut, self.nIn, self.kernel)}
        if self.has_bias:
            shapes["b"] = (self.nOut,)
        return shapes

    def initialize(self, gen):
        params = {"W": _initialize((self.nOut, self.nIn, self.kernel),
                                   self.weight_init, gen)}
        if self.has_bias:
            params["b"] = torch.full((self.nOut,), float(self.bias_init))
        return params, {}

    def apply(self, params, state, x, train, key=None, mask=None):
        out = conv_ops.conv1d(x, params["W"], params.get("b"),
                              stride=self.stride, pad=self.padding,
                              dilation=self.dilation, mode=self.mode)
        return act.get(self.activation)(out), state

    def output_type(self, it: InputType) -> InputType:
        t = it.dims.get("timesteps", -1)
        if t and t > 0:
            t = conv_ops.conv_output_size(t, self.kernel, self.stride,
                                          self.padding, self.dilation,
                                          self.mode)
        return InputType.recurrent(self.nOut, t)


class Subsampling1DLayer(Layer):
    """ref: Subsampling1DLayer — max/avg pooling over T of [N, C, T] (the
    mask is not downsampled, as in the JAX package)."""

    input_kind = "rnn"
    has_params = False

    def __init__(self, poolingType: str = "max", kernelSize: int = 2,
                 stride: int = None, padding: int = 0,
                 convolutionMode: str = "truncate", **kw):
        super().__init__(**kw)
        self.pooling = poolingType.lower()
        self.kernel = _first(kernelSize)
        self.stride = int(stride if stride is not None else self.kernel)
        self.padding = int(padding)
        self.mode = convolutionMode

    def infer_nin(self, it):
        self.nIn = self.nOut = it.size

    def apply(self, params, state, x, train, key=None, mask=None):
        fn = conv_ops.maxpool1d if self.pooling == "max" \
            else conv_ops.avgpool1d
        return fn(x, kernel=self.kernel, stride=self.stride,
                  pad=self.padding, mode=self.mode), state

    def output_type(self, it: InputType) -> InputType:
        t = it.dims.get("timesteps", -1)
        if t and t > 0:
            t = conv_ops.conv_output_size(t, self.kernel, self.stride,
                                          self.padding, 1, self.mode)
        return InputType.recurrent(it.size, t)


# ----------------------------------------------- elementwise, normalization
class PReLULayer(Layer):
    """ref: PReLULayer — ``alpha`` [nIn] (nIn the elements an example),
    per channel plane on 4-D input when it has C entries."""

    input_kind = None

    def infer_nin(self, it):
        self.nIn = self.nOut = it.arrayElementsPerExample()

    def gemm_lane_dims(self):
        return []   # elementwise slope — no GEMM

    def param_shapes(self):
        return {"alpha": (self.nIn,)} if self.nIn else {}

    def initialize(self, gen):
        return {"alpha": torch.full((self.nIn,), 0.25)}, {}

    def apply(self, params, state, x, train, key=None):
        a = params["alpha"]
        if x.dim() == 4:
            a = a.reshape(1, -1, 1, 1) if a.numel() == x.shape[1] \
                else a.reshape((1,) + tuple(x.shape[1:]))
        return act.prelu(x, a), state

    def output_type(self, it):
        return it


class LayerNorm(Layer):
    """ref: LayerNorm (Keras LayerNormalization) — per-example
    normalization of the feature axis with gain and bias: -1 of [N, D],
    the channel axis of [N, C, T]. It resolves ``layer_norm`` through the
    registry (the CUDA kernel when installed) on 2-D rows: an [N, C, T]
    input goes as its [N*T, C] rows, the same function."""

    input_kind = None

    def __init__(self, eps: float = 1e-5, **kw):
        super().__init__(**kw)
        self.eps = eps

    def infer_nin(self, it: InputType):
        if it.kind == "cnn":
            raise ValueError(
                "LayerNorm supports dense [N, D] and recurrent [N, C, T] "
                "inputs; 4-D CNN feature maps are not supported")
        self.nIn = self.nOut = it.size if it.kind == "rnn" \
            else it.arrayElementsPerExample()

    def gemm_lane_dims(self):
        return []   # elementwise gain/bias — no GEMM

    def param_shapes(self):
        return {"gamma": (self.nIn,), "beta": (self.nIn,)} if self.nIn \
            else {}

    def initialize(self, gen):
        return {"gamma": torch.ones(self.nIn),
                "beta": torch.zeros(self.nIn)}, {}

    def _ln(self, x, params):
        rows = x.reshape(-1, x.shape[-1])
        y = registry.get("layer_norm")(rows, params["gamma"],
                                       params["beta"], eps=self.eps)
        return y.reshape(x.shape)

    def apply(self, params, state, x, train, key=None, mask=None):
        if x.dim() == 3:               # [N, C, T]: the channel axis
            return self._ln(x.transpose(1, 2), params).transpose(1, 2), \
                state
        return self._ln(x, params), state

    def output_type(self, it: InputType) -> InputType:
        return it


def _channel_count(it: InputType) -> int:
    return it.channels if it.kind in ("cnn", "cnn3d") \
        else it.size if it.kind == "rnn" else it.arrayElementsPerExample()


class GroupNorm(Layer):
    """Group normalization (the Keras GroupNormalization import target):
    [N, C, *spatial], each of ``groups`` channel groups normalized with
    its spatial dims, in fp32, then gamma and beta a channel."""

    input_kind = None

    def __init__(self, groups: int = 32, eps: float = 1e-3, **kw):
        super().__init__(**kw)
        self.groups = int(groups)
        self.eps = eps

    def infer_nin(self, it: InputType):
        self.nIn = self.nOut = _channel_count(it)
        if self.groups == -1:            # Keras shorthand: instance norm
            self.groups = self.nIn
        if self.groups < 1 or self.nIn % self.groups:
            raise ValueError(f"GroupNorm: {self.nIn} channels not divisible "
                             f"by {self.groups} groups")

    def gemm_lane_dims(self):
        return []   # elementwise gain/bias — no GEMM

    def param_shapes(self):
        return {"gamma": (self.nIn,), "beta": (self.nIn,)} if self.nIn \
            else {}

    def initialize(self, gen):
        return {"gamma": torch.ones(self.nIn),
                "beta": torch.zeros(self.nIn)}, {}

    def apply(self, params, state, x, train, key=None):
        n, c = x.shape[0], x.shape[1]
        g = self.groups
        xg = x.reshape((n, g, c // g) + tuple(x.shape[2:])).float()
        axes = tuple(range(2, xg.dim()))
        m = xg.mean(dim=axes, keepdim=True)
        v = (xg - m).square().mean(dim=axes, keepdim=True)
        y = ((xg - m) * torch.rsqrt(v + self.eps)).reshape(x.shape)
        shape = (1, c) + (1,) * (x.dim() - 2)
        y = y * params["gamma"].reshape(shape) \
            + params["beta"].reshape(shape)
        return y.to(x.dtype), state

    def output_type(self, it: InputType) -> InputType:
        return it


class UnitNormLayer(Layer):
    """L2 normalization of the channel/feature axis (Keras
    UnitNormalization): the norm in fp32, floored at 1e-12."""

    input_kind = None
    has_params = False

    def infer_nin(self, it: InputType):
        self.nIn = self.nOut = _channel_count(it)

    def apply(self, params, state, x, train, key=None):
        axis = 1 if x.dim() > 2 else -1
        n = torch.sqrt(x.float().square().sum(dim=axis, keepdim=True))
        return x / torch.clamp_min(n, 1e-12).to(x.dtype), state

    def output_type(self, it: InputType) -> InputType:
        return it


class Permute(Layer):
    """ref: Keras Permute — reorder the non-batch axes (1-based dims)."""

    input_kind = None
    has_params = False

    def __init__(self, dims=(2, 1), **kw):
        super().__init__(**kw)
        self.dims = tuple(int(d) for d in dims)

    def infer_nin(self, it):
        self.nIn = self.nOut = None

    def apply(self, params, state, x, train, key=None):
        return x.permute((0,) + tuple(self.dims)), state

    def output_type(self, it: InputType) -> InputType:
        if it.kind == "rnn" and self.dims == (2, 1):
            return InputType.recurrent(it.dims.get("timesteps", -1), it.size)
        return it


class RepeatVector(Layer):
    """ref: Keras RepeatVector — [N, D] -> [N, D, n] (NCW)."""

    input_kind = "ff"
    has_params = False

    def __init__(self, n: int = 2, **kw):
        super().__init__(**kw)
        self.n = int(n)

    def infer_nin(self, it):
        self.nIn = self.nOut = it.arrayElementsPerExample()

    def apply(self, params, state, x, train, key=None):
        return x[:, :, None].expand(-1, -1, self.n).contiguous(), state

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.nOut, self.n)


# ---------------------------------------------------------------- attention
class SelfAttentionLayer(Layer):
    """ref: SelfAttentionLayer — multi-head dot-product self-attention
    over [N, nIn, T] -> [N, nOut, T]. With ``projectInput`` it learns Wq,
    Wk, Wv [nIn, nHeads*headSize] and Wo [nHeads*headSize, nOut] (and
    biases with ``useBias``); without, nHeads is 1 and nOut is nIn. A
    [N, T] mask blocks attention to padded keys and zeroes padded
    queries. An unmasked sequence of T >= 1024 goes through
    ``flash_attention`` (the CUDA kernel when installed), shorter or
    masked ones through ``dot_product_attention``, the JAX gate exactly."""

    input_kind = "rnn"

    def __init__(self, nOut=None, nHeads: int = 1, headSize: int = None,
                 projectInput: bool = True, useBias: bool = False, **kw):
        super().__init__(nOut=nOut, **kw)
        self.n_heads = nHeads
        self.head_size = headSize
        self.project = projectInput
        self.use_bias = useBias

    def infer_nin(self, it: InputType):
        super().infer_nin(it)
        if self.nOut is None:
            self.nOut = self.nIn
        if self.head_size is None:
            self.head_size = self.nOut // self.n_heads
        if not self.project and (self.n_heads != 1 or self.nOut != self.nIn):
            raise ValueError(
                "SelfAttentionLayer: projectInput=False requires nHeads=1 "
                f"and nOut==nIn (got nHeads={self.n_heads}, nIn={self.nIn}, "
                f"nOut={self.nOut})")

    def param_shapes(self):
        if not self.project or not self.nIn or not self.nOut \
                or not self.head_size:
            return {}
        E = self.n_heads * self.head_size
        shapes = {"Wq": (self.nIn, E), "Wk": (self.nIn, E),
                  "Wv": (self.nIn, E), "Wo": (E, self.nOut)}
        if getattr(self, "use_bias", False):
            shapes.update({"bq": (E,), "bk": (E,), "bv": (E,),
                           "bo": (self.nOut,)})
        return shapes

    def initialize(self, gen):
        if not self.project:
            return {}, {}
        e = self.n_heads * self.head_size
        params = {"Wq": _initialize((self.nIn, e), self.weight_init, gen),
                  "Wk": _initialize((self.nIn, e), self.weight_init, gen),
                  "Wv": _initialize((self.nIn, e), self.weight_init, gen),
                  "Wo": _initialize((e, self.nOut), self.weight_init, gen)}
        if getattr(self, "use_bias", False):
            params.update({"bq": torch.zeros(e), "bk": torch.zeros(e),
                           "bv": torch.zeros(e),
                           "bo": torch.zeros(self.nOut)})
        return params, {}

    def _project_attend(self, params, q_btc, kv_btc, m):
        """Projected multi-head attention (nIn need not be
        nHeads*headSize)."""
        b, tq = q_btc.shape[0], q_btc.shape[1]
        h, hs = self.n_heads, self.head_size

        def proj(x, w, bias):
            y = x @ w
            if bias is not None:
                y = y + bias
            return y.reshape(x.shape[0], x.shape[1], h, hs)
        qh = proj(q_btc, params["Wq"], params.get("bq"))
        kh = proj(kv_btc, params["Wk"], params.get("bk"))
        vh = proj(kv_btc, params["Wv"], params.get("bv"))
        if m is None and tq >= 1024:
            ctx = attn_ops.flash_attention(qh, kh, vh)
        else:
            ctx = attn_ops.dot_product_attention(qh, kh, vh, mask=m)
        out = ctx.reshape(b, tq, h * hs) @ params["Wo"]
        if params.get("bo") is not None:
            out = out + params["bo"]
        return out

    def apply(self, params, state, x, train, key=None, mask=None):
        x_btc = x.transpose(1, 2)
        m = mask[:, None, None, :] if mask is not None else None
        if self.project:
            y = self._project_attend(params, x_btc, x_btc, m)
        else:
            q = x_btc[:, :, None, :]
            y = attn_ops.dot_product_attention(q, q, q, mask=m)[:, :, 0]
        if mask is not None:
            y = y * mask[:, :, None]
        return y.transpose(1, 2), state

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.nOut, it.dims.get("timesteps", -1))


class LearnedSelfAttentionLayer(SelfAttentionLayer):
    """ref: LearnedSelfAttentionLayer — ``nQueries`` learned queries
    ``Q`` [nQueries, nIn] instead of one a step: [N, nIn, T] -> [N, nOut,
    nQueries]."""

    def __init__(self, nOut=None, nQueries: int = 1, **kw):
        super().__init__(nOut=nOut, **kw)
        self.n_queries = nQueries

    def param_shapes(self):
        shapes = super().param_shapes()
        if self.nIn:
            shapes["Q"] = (self.n_queries, self.nIn)
        return shapes

    def initialize(self, gen):
        params, state = super().initialize(gen)
        params["Q"] = _initialize((self.n_queries, self.nIn),
                                  self.weight_init, gen)
        return params, state

    def apply(self, params, state, x, train, key=None, mask=None):
        x_btc = x.transpose(1, 2)
        q_bqc = params["Q"][None].expand((x.shape[0],)
                                         + tuple(params["Q"].shape))
        m = mask[:, None, None, :] if mask is not None else None
        if self.project:
            y = self._project_attend(params, q_bqc, x_btc, m)
        else:
            kv = x_btc[:, :, None, :]
            y = attn_ops.dot_product_attention(q_bqc[:, :, None, :], kv, kv,
                                               mask=m)[:, :, 0]
        return y.transpose(1, 2), state

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.nOut, self.n_queries)


class RecurrentAttentionLayer(Layer):
    """ref: RecurrentAttentionLayer — a recurrent cell whose input at each
    step is joined by attention over the whole sequence, queried by the
    previous output: ``a_t = attention(y_{t-1} Wq, x)``, ``y_t = act(x_t W
    + a_t R + b)``; [N, nIn, T] -> [N, nOut, T], a Python loop over T."""

    input_kind = "rnn"

    def __init__(self, nOut=None, nHeads: int = 1, **kw):
        super().__init__(nOut=nOut, **kw)
        self.n_heads = nHeads
        if self.activation is None:
            self.activation = "tanh"

    def set_defaults(self, base):
        super().set_defaults(base)
        if self.activation == "identity":
            self.activation = "tanh"

    def param_shapes(self):
        if not self.nIn or not self.nOut:
            return {}
        return {"W": (self.nIn, self.nOut), "R": (self.nIn, self.nOut),
                "Wq": (self.nOut, self.nIn), "b": (self.nOut,)}

    def initialize(self, gen):
        return {"W": _initialize((self.nIn, self.nOut), self.weight_init,
                                 gen),
                "R": _initialize((self.nIn, self.nOut), self.weight_init,
                                 gen),
                "Wq": _initialize((self.nOut, self.nIn), self.weight_init,
                                  gen),
                "b": torch.zeros(self.nOut)}, {}

    def apply(self, params, state, x, train, key=None, mask=None):
        h = self.n_heads
        if self.nIn % h:
            raise ValueError(f"RecurrentAttentionLayer: nIn={self.nIn} not "
                             f"divisible by nHeads={h}")
        hd = self.nIn // h
        act_fn = act.get(self.activation)
        keys = x.transpose(1, 2).reshape(x.shape[0], x.shape[2], h, hd)
        scale = float(np.sqrt(hd).astype(np.float32))
        y = torch.zeros((x.shape[0], self.nOut), dtype=x.dtype,
                        device=x.device)
        ys = []
        for t in range(x.shape[2]):
            q = (y @ params["Wq"]).reshape(-1, h, hd)
            scores = torch.einsum("nhd,nthd->nht", q, keys) / scale
            if mask is not None:
                scores = torch.where(mask[:, None, :] > 0, scores, -1e30)
            w = torch.softmax(scores, dim=-1)
            a_t = torch.einsum("nht,nthd->nhd", w, keys).reshape(-1, self.nIn)
            y = act_fn(x[:, :, t] @ params["W"] + a_t @ params["R"]
                       + params["b"])
            ys.append(y)
        out = torch.stack(ys, dim=2)
        if mask is not None:
            out = out * mask[:, None, :]
        return out, state

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.nOut, it.dims.get("timesteps", -1))


# ------------------------------------------------------------- recurrent 2-D
class ConvLSTM2D(Layer):
    """Convolutional LSTM over image sequences (the Keras ConvLSTM2D import
    target): [N, C, T, H, W] -> [N, nOut, H', W'] (the last state) or
    [N, nOut, T, H', W'] with ``returnSequences``. The input convs take
    the configured stride and mode, all steps at once; the recurrent
    convs are SAME on the state grid. Gate order [i, f, g, o]."""

    input_kind = "cnn3d"

    def __init__(self, nOut=None, kernelSize=(3, 3), stride=(1, 1),
                 convolutionMode: str = "truncate",
                 returnSequences: bool = False,
                 forgetGateBiasInit: float = 1.0, **kw):
        super().__init__(nOut=nOut, **kw)
        self.kernel = _pair(kernelSize)
        self.stride = _pair(stride)
        self.mode = convolutionMode
        self.return_sequences = returnSequences
        self.forget_bias = forgetGateBiasInit

    def infer_nin(self, it: InputType):
        self.nIn = it.channels

    def gemm_lane_dims(self):
        return [4 * self.nOut] if self.nOut else []

    def param_shapes(self):
        if not self.nIn or not self.nOut:
            return {}
        H = self.nOut
        return {"W": (4 * H, self.nIn) + tuple(self.kernel),
                "RW": (4 * H, H) + tuple(self.kernel), "b": (4 * H,)}

    def initialize(self, gen):
        h = self.nOut
        b = torch.zeros(4 * h)
        b[h:2 * h] = float(self.forget_bias)
        return {"W": _initialize((4 * h, self.nIn) + self.kernel,
                                 self.weight_init, gen),
                "RW": _initialize((4 * h, h) + self.kernel,
                                  self.weight_init, gen),
                "b": b}, {}

    def apply(self, params, state, x, train, key=None):
        n, t = x.shape[0], x.shape[2]
        x_t = x.movedim(2, 0)                        # [T, N, C, H, W]
        xg = conv_ops.conv2d(x_t.reshape((t * n,) + tuple(x_t.shape[2:])),
                             params["W"], params["b"], stride=self.stride,
                             pad=(0, 0), mode=self.mode)
        xg = xg.reshape((t, n) + tuple(xg.shape[1:]))   # [T, N, 4H, H', W']
        h = torch.zeros((n, self.nOut) + tuple(xg.shape[3:]),
                        dtype=xg.dtype, device=xg.device)
        c = h
        hs = []
        for step in range(t):
            gates = xg[step] + conv_ops.conv2d(h, params["RW"], None,
                                               mode="same")
            i, f, g, o = torch.chunk(gates, 4, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            if self.return_sequences:
                hs.append(h)
        if self.return_sequences:
            return torch.stack(hs, dim=2), state
        return h, state

    def output_type(self, it: InputType) -> InputType:
        h = conv_ops.conv_output_size(it.height, self.kernel[0],
                                      self.stride[0], 0, 1, self.mode)
        w = conv_ops.conv_output_size(it.width, self.kernel[1],
                                      self.stride[1], 0, 1, self.mode)
        if self.return_sequences:
            return InputType.convolutional3D(it.depth, h, w, self.nOut)
        return InputType.convolutional(h, w, self.nOut)


# ------------------------------------------------------------------- 3-D
def _triple(v):
    return tuple(int(s) for s in v) if isinstance(v, (tuple, list)) \
        else (int(v),) * 3


class Convolution3D(Layer):
    """ref: Convolution3D — NCDHW, W [nOut, nIn, kD, kH, kW]."""

    input_kind = "cnn3d"

    def __init__(self, kernelSize=(3, 3, 3), stride=(1, 1, 1),
                 padding=(0, 0, 0), nOut=None,
                 convolutionMode: str = "truncate", hasBias: bool = True,
                 **kw):
        super().__init__(nOut=nOut, **kw)
        self.kernel = _triple(kernelSize)
        self.stride = _triple(stride)
        self.padding = _triple(padding)
        self.mode = convolutionMode
        self.has_bias = hasBias

    def infer_nin(self, it: InputType):
        if self.nIn is None:
            self.nIn = it.channels

    def param_shapes(self):
        if not self.nIn or not self.nOut:
            return {}
        shapes = {"W": (self.nOut, self.nIn) + tuple(self.kernel)}
        if self.has_bias:
            shapes["b"] = (self.nOut,)
        return shapes

    def initialize(self, gen):
        params = {"W": _initialize((self.nOut, self.nIn) + self.kernel,
                                   self.weight_init, gen)}
        if self.has_bias:
            params["b"] = torch.full((self.nOut,), float(self.bias_init))
        return params, {}

    def apply(self, params, state, x, train, key=None):
        x = self._maybe_dropout(x, train, key)
        out = conv_ops.conv3d(x, params["W"],
                              params.get("b") if self.has_bias else None,
                              stride=self.stride, pad=self.padding,
                              mode=self.mode)
        return act.get(self.activation)(out), state

    def output_type(self, it: InputType) -> InputType:
        d, h, w = (conv_ops.conv_output_size(s, k, st, p, 1, self.mode)
                   for s, k, st, p in zip((it.depth, it.height, it.width),
                                          self.kernel, self.stride,
                                          self.padding))
        return InputType.convolutional3D(d, h, w, self.nOut)


class Subsampling3DLayer(Layer):
    """ref: Subsampling3DLayer — NCDHW max/avg pooling."""

    input_kind = "cnn3d"
    has_params = False

    def __init__(self, poolingType: str = "max", kernelSize=(2, 2, 2),
                 stride=None, padding=(0, 0, 0), **kw):
        super().__init__(**kw)
        self.pooling = poolingType.lower()
        self.kernel = _triple(kernelSize)
        self.stride = tuple(stride) if stride is not None else self.kernel
        self.padding = _triple(padding)

    def infer_nin(self, it: InputType):
        self.nIn = self.nOut = it.channels

    def apply(self, params, state, x, train, key=None):
        fn = conv_ops.maxpool3d if self.pooling == "max" \
            else conv_ops.avgpool3d
        return fn(x, kernel=self.kernel, stride=self.stride,
                  pad=self.padding), state

    def output_type(self, it: InputType) -> InputType:
        d, h, w = (conv_ops.conv_output_size(s, k, st, p, 1, "truncate")
                   for s, k, st, p in zip((it.depth, it.height, it.width),
                                          self.kernel, self.stride,
                                          self.padding))
        return InputType.convolutional3D(d, h, w, it.channels)


def _triple_pads(spec):
    """int | (a, b, c) | ((lo, hi), ...) -> three (lo, hi) pairs."""
    if isinstance(spec, int):
        spec = (spec,) * 3
    return tuple((int(p), int(p)) if isinstance(p, int)
                 else (int(p[0]), int(p[1])) for p in spec)


class ZeroPadding3DLayer(Layer):
    """ref: ZeroPadding3DLayer — NCDHW."""

    input_kind = "cnn3d"
    has_params = False

    def __init__(self, padding=(1, 1, 1), **kw):
        super().__init__(**kw)
        self.pad = _triple_pads(padding)

    def infer_nin(self, it):
        self.nIn = self.nOut = it.channels

    def apply(self, params, state, x, train, key=None):
        flat = [p for lo_hi in reversed(self.pad) for p in lo_hi]
        return F.pad(x, flat), state

    def output_type(self, it):
        d, h, w = (s + sum(p) for s, p in
                   zip((it.depth, it.height, it.width), self.pad))
        return InputType.convolutional3D(d, h, w, it.channels)


class Cropping3D(Layer):
    """ref: Cropping3D — NCDHW."""

    input_kind = "cnn3d"
    has_params = False

    def __init__(self, crop=(1, 1, 1), **kw):
        super().__init__(**kw)
        self.crop = _triple_pads(crop)

    def infer_nin(self, it):
        self.nIn = self.nOut = it.channels

    def apply(self, params, state, x, train, key=None):
        (d0, d1), (h0, h1), (w0, w1) = self.crop
        d, h, w = x.shape[2:]
        return x[:, :, d0:d - d1, h0:h - h1, w0:w - w1], state

    def output_type(self, it):
        d, h, w = (s - sum(c) for s, c in
                   zip((it.depth, it.height, it.width), self.crop))
        return InputType.convolutional3D(d, h, w, it.channels)


class Upsampling3D(Layer):
    """ref: Upsampling3D — nearest repeat, NCDHW."""

    input_kind = "cnn3d"
    has_params = False

    def __init__(self, size=2, **kw):
        super().__init__(**kw)
        self.scale = _triple(size)

    def infer_nin(self, it):
        self.nIn = self.nOut = it.channels

    def apply(self, params, state, x, train, key=None):
        for ax, s in zip((2, 3, 4), self.scale):
            if s != 1:
                x = torch.repeat_interleave(x, s, dim=ax)
        return x, state

    def output_type(self, it):
        return InputType.convolutional3D(it.depth * self.scale[0],
                                         it.height * self.scale[1],
                                         it.width * self.scale[2],
                                         it.channels)


# ------------------------------------------------------ 1-D resampling
class Upsampling1D(Layer):
    """ref: Upsampling1D — [N, C, T] each step repeated ``size`` times."""

    input_kind = "rnn"
    has_params = False

    def __init__(self, size: int = 2, **kw):
        super().__init__(**kw)
        self.size = int(size)

    def infer_nin(self, it):
        self.nIn = self.nOut = it.size

    def apply(self, params, state, x, train, key=None):
        return torch.repeat_interleave(x, self.size, dim=2), state

    def output_type(self, it: InputType) -> InputType:
        t = it.dims.get("timesteps", -1)
        return InputType.recurrent(it.size, t * self.size if t > 0 else -1)


class ZeroPadding1DLayer(Layer):
    """ref: ZeroPadding1DLayer — zeros before and after along T."""

    input_kind = "rnn"
    has_params = False

    def __init__(self, padding=1, **kw):
        super().__init__(**kw)
        self.pad = tuple(padding) if isinstance(padding, (tuple, list)) \
            else (int(padding), int(padding))

    def infer_nin(self, it):
        self.nIn = self.nOut = it.size

    def apply(self, params, state, x, train, key=None):
        return F.pad(x, tuple(int(p) for p in self.pad)), state

    def output_type(self, it: InputType) -> InputType:
        t = it.dims.get("timesteps", -1)
        return InputType.recurrent(it.size,
                                   t + sum(self.pad) if t > 0 else -1)


class Cropping1D(Layer):
    """ref: Cropping1D — steps cut from the start and the end of T."""

    input_kind = "rnn"
    has_params = False

    def __init__(self, cropping=1, **kw):
        super().__init__(**kw)
        self.crop = tuple(cropping) if isinstance(cropping, (tuple, list)) \
            else (int(cropping), int(cropping))

    def infer_nin(self, it):
        self.nIn = self.nOut = it.size

    def apply(self, params, state, x, train, key=None):
        t = x.shape[2]
        return x[:, :, self.crop[0]:t - self.crop[1]], state

    def output_type(self, it: InputType) -> InputType:
        t = it.dims.get("timesteps", -1)
        return InputType.recurrent(it.size,
                                   t - sum(self.crop) if t > 0 else -1)


class MaskZeroLayer(Layer):
    """ref: MaskZeroLayer / Keras Masking — steps whose every feature
    equals ``maskValue`` are zeroed (the mask itself is not produced)."""

    input_kind = "rnn"
    has_params = False

    def __init__(self, maskValue: float = 0.0, **kw):
        super().__init__(**kw)
        self.mask_value = float(maskValue)

    def infer_nin(self, it):
        self.nIn = self.nOut = it.size

    def apply(self, params, state, x, train, key=None):
        keep = (x != self.mask_value).any(dim=1, keepdim=True)
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device)), state

    def output_type(self, it: InputType) -> InputType:
        return it


# -------------------------------------------------------------------- noise
class GaussianNoiseLayer(Layer):
    """Keras GaussianNoise — additive N(0, stddev) noise in training (the
    draws of ``norm_ops.gaussian_noise``), the identity otherwise."""

    input_kind = None
    has_params = False

    def __init__(self, stddev: float = 0.1, **kw):
        super().__init__(**kw)
        self.stddev = float(stddev)

    def infer_nin(self, it):
        self.nIn = self.nOut = it.arrayElementsPerExample()

    def apply(self, params, state, x, train, key=None):
        return norm_ops.gaussian_noise(x, self.stddev, key,
                                       train=train), state

    def output_type(self, it):
        return it


class GaussianDropoutLayer(GaussianNoiseLayer):
    """Keras GaussianDropout — multiplicative N(1, rate/(1-rate)) noise in
    training."""

    def __init__(self, rate: float = 0.1, **kw):
        Layer.__init__(self, **kw)
        self.rate = float(rate)

    def apply(self, params, state, x, train, key=None):
        return norm_ops.gaussian_dropout(x, self.rate, key,
                                         train=train), state


class AlphaDropoutLayer(GaussianNoiseLayer):
    """Keras AlphaDropout — SELU's self-normalizing dropout in training,
    through the registry's ``alpha_dropout``."""

    def __init__(self, rate: float = 0.1, **kw):
        Layer.__init__(self, **kw)
        self.rate = float(rate)

    def apply(self, params, state, x, train, key=None):
        if not train or self.rate <= 0:
            return x, state
        return registry.get("alpha_dropout")(key, x, self.rate), state


# ------------------------------------------------------------------ wrapper
class TimeDistributed(Layer):
    """Keras TimeDistributed(Dense) — the dense layer at every step of
    [N, C, T] -> [N, nOut, T] (one einsum)."""

    input_kind = "rnn"

    def __init__(self, inner: DenseLayer = None, nOut=None, **kw):
        if inner is not None and not isinstance(inner, DenseLayer):
            raise ValueError("TimeDistributed supports a Dense inner layer")
        super().__init__(nOut=nOut if nOut is not None
                         else (inner.nOut if inner else None), **kw)
        if inner is not None and self.activation is None:
            self.activation = inner.activation
        self.has_bias = inner.has_bias if inner is not None else True

    def initialize(self, gen):
        return self._dense_init(gen)

    def apply(self, params, state, x, train, key=None):
        z = torch.einsum("nct,ch->nht", x, params["W"])
        if self.has_bias:
            z = z + params["b"][None, :, None]
        fn = act.get(self.activation)
        a = fn(z, axis=1) if self.activation in ("softmax", "logsoftmax") \
            else fn(z)
        return a, state

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(self.nOut, it.dims.get("timesteps", -1))


class SameDiffLayer(Layer):
    """ref: nn.conf.layers.samediff.SameDiffLayer — a layer defined as a
    SameDiff graph fragment instead of a Layer subclass with its own
    forward.

    Subclass and override:

    - ``defineParameters() -> {name: shape}``
    - ``defineLayer(sd, layerInput, paramTable, mask) -> SDVariable``

    The fragment is recorded once, at the layer's first forward, into a
    private SameDiff on the input's device (placeholders ``layer_input``
    and one a param), as the JAX layer records it once at its first
    trace; a forward on another device or at another dtype records its
    own. Each forward then runs it eagerly on the layer's tensors, so
    autograd flows through it; it reads nothing on the host and makes no
    tensor from a host value, so a captured step replays it (a constant
    the fragment defines is made when it is recorded). The recorded
    fragments live in :data:`_SAMEDIFF_FRAGMENTS`, not on the layer: a
    copy of the layer (``TransferLearning``'s) records its own."""

    def defineParameters(self) -> Dict[str, Tuple[int, ...]]:
        raise NotImplementedError

    def defineLayer(self, sd, layerInput, paramTable, mask=None):
        raise NotImplementedError

    def infer_nin(self, it: InputType):
        super().infer_nin(it)
        if self.nOut is None:
            self.nOut = self.nIn

    def param_shapes(self):
        """The hook contract: the shapes ``defineParameters`` declares."""
        return {name: tuple(int(d) for d in shape)
                for name, shape in self.defineParameters().items()}

    def initialize(self, gen):
        shapes = self.defineParameters()
        params = {name: _initialize(tuple(shape), self.weight_init, gen)
                  for name, shape in shapes.items()}
        _SAMEDIFF_FRAGMENTS.pop(self, None)
        return params, {}

    def _fragment(self, params, x):
        frags = _SAMEDIFF_FRAGMENTS.setdefault(self, {})
        frag = frags.get((x.device, x.dtype))
        if frag is None:
            from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
            sd = SameDiff.create(device=x.device)
            xv = sd.placeHolder("layer_input", shape=tuple(x.shape),
                                dtype=x.dtype)
            pvs = {k: sd.placeHolder(k, shape=tuple(v.shape), dtype=v.dtype)
                   for k, v in params.items()}
            out = self.defineLayer(sd, xv, pvs, None)
            frag = frags[(x.device, x.dtype)] = (sd, out.name)
        return frag

    def apply(self, params, state, x, train, key=None):
        sd, out_name = self._fragment(params, x)
        res = sd._exec({}, {"layer_input": x, **params}, [out_name])
        return res[out_name], state

    @classmethod
    def from_config(cls, d):
        """A subclass rebuilds from its config (its fragment is its code);
        the base class does not, as the JAX package's layer registry holds
        no ``SameDiffLayer`` (``layer_from_config`` raises KeyError)."""
        if cls is SameDiffLayer:
            raise KeyError("SameDiffLayer: a config holds no graph "
                           "fragment; rebuild the subclass that defines it "
                           "(SubClass.from_config)")
        return super().from_config(d)


#: the recorded fragments of each live SameDiffLayer,
#: ``{(device, dtype): (SameDiff, output name)}``
_SAMEDIFF_FRAGMENTS: "weakref.WeakKeyDictionary[SameDiffLayer, Dict]" = \
    weakref.WeakKeyDictionary()


_LAYER_CLASSES = {cls.__name__: cls for cls in (
    DenseLayer, ConvolutionLayer, Deconvolution2D, DepthwiseConvolution2D,
    SeparableConvolution2D, SubsamplingLayer, BatchNormalization,
    LocalResponseNormalization, ActivationLayer, DropoutLayer,
    SpatialDropoutLayer, ZeroPaddingLayer, Upsampling2D, Cropping2D,
    GlobalPoolingLayer, LSTM, GravesLSTM, GRU, SimpleRnn, Bidirectional,
    BidirectionalLastStep, LastTimeStep, OutputLayer, LossLayer,
    RnnOutputLayer, EmbeddingLayer, EmbeddingSequenceLayer, Convolution1D,
    Subsampling1DLayer, PReLULayer, LayerNorm, GroupNorm, UnitNormLayer,
    Permute, RepeatVector, SelfAttentionLayer, LearnedSelfAttentionLayer,
    RecurrentAttentionLayer, ConvLSTM2D, Convolution3D, Subsampling3DLayer,
    ZeroPadding3DLayer, Cropping3D, Upsampling3D, Upsampling1D,
    ZeroPadding1DLayer, Cropping1D, MaskZeroLayer, GaussianNoiseLayer,
    GaussianDropoutLayer, AlphaDropoutLayer, TimeDistributed,
    SameDiffLayer)}


def layer_from_config(d: Dict) -> Layer:
    """A layer from its JSON dict (the JAX package's ``to_config``)."""
    name = d["@class"]
    if name not in _LAYER_CLASSES:
        raise NotImplementedError(f"layer class {name!r} is not ported "
                                  f"(known: {sorted(_LAYER_CLASSES)})")
    return _LAYER_CLASSES[name].from_config(d)


# ------------------------------------------------------------- dtype policy
# Master params stay fp32. BatchNorm and LRN keep fp32 params and cast
# inside their ops (activations stay in the compute dtype through them);
# the output layers get fp32 activations and fp32 params (softmax and
# loss).
_POLICY_FP32_PARAM_LAYERS = (BatchNormalization, LocalResponseNormalization,
                             BaseOutputLayer)


def compute_dtype_of(conf_dtype) -> Optional[torch.dtype]:
    """None = no policy (pure fp32); torch.bfloat16 = mixed precision."""
    if str(conf_dtype).lower() in ("bfloat16", "bf16"):
        return torch.bfloat16
    return None


def policy_cast(layer, params, x, compute_dt):
    """Cast (params, input) for one layer under the dtype policy. A
    per-layer ``dataType="float32"`` declares an fp32 island. uint8 image
    bytes are cast on the device: to the compute dtype, or to fp32 in an
    island (an output layer takes them as they are, as in the JAX
    package)."""
    if compute_dt is None:
        return params, x
    override = getattr(layer, "dtype_override", None)
    out_layer = isinstance(layer, BaseOutputLayer)
    if override == "float32" or out_layer:
        if (x.is_floating_point() and x.dtype != torch.float32) \
                or (x.dtype == torch.uint8 and not out_layer):
            x = x.float()
        return params, x
    if isinstance(layer, _POLICY_FP32_PARAM_LAYERS):
        return params, x
    if (x.is_floating_point() and x.dtype != compute_dt) \
            or x.dtype == torch.uint8:
        x = x.to(compute_dt)
    if params:
        params = {k: v.to(compute_dt) if v.dtype == torch.float32 else v
                  for k, v in params.items()}
    return params, x


# ----------------------------------------------------------- compute layout
# The networks' ``setComputeLayout("NHWC")`` keeps the PUBLIC layout NCHW
# (inputs, outputs, weights [O, I, kH, kW]) and moves to NHWC once at each
# layout boundary. On the card an NHWC tensor is the contiguous
# [N, H, W, C] tensor whose NCHW-shaped permuted view is channels_last,
# which is what cuDNN and ``scale_shift_act`` want.

#: layers whose apply computes natively in NHWC when stamped (the conv
#: family covers Deconvolution/Depthwise/Separable by subclassing)
LAYOUT_AWARE = (ConvolutionLayer, SubsamplingLayer, BatchNormalization,
                LocalResponseNormalization, ZeroPaddingLayer, Upsampling2D,
                Cropping2D, GlobalPoolingLayer)

#: elementwise layers that keep whatever layout flows in
LAYOUT_TRANSPARENT = (ActivationLayer,)


def to_nhwc(x):
    """[N, C, H, W] -> contiguous [N, H, W, C]: a view when x is
    channels_last in memory, the one boundary copy otherwise."""
    return x.permute(0, 2, 3, 1).contiguous()


def to_nchw(x):
    """[N, H, W, C] -> [N, C, H, W] as a view (channels_last memory)."""
    return x.permute(0, 3, 1, 2)


def layout_step(layer, x, cur_nhwc: bool, nhwc_active: bool):
    """The move-at-boundary rule, one layer at a time: returns ``(x,
    now_nhwc)``. Aware layers pull spatial input into NHWC, transparent
    layers keep whatever flows in, everything else forces NCHW back."""
    if x.dim() != 4:
        return x, False
    want = (nhwc_active and isinstance(layer, LAYOUT_AWARE)) or \
        (cur_nhwc and isinstance(layer, LAYOUT_TRANSPARENT))
    if want and not cur_nhwc:
        return to_nhwc(x), True
    if not want and cur_nhwc:
        return to_nchw(x), False
    return x, cur_nhwc


def stamp_layout(layers, fmt: str) -> None:
    """Stamp ``data_format`` on every layout-aware layer; ``"NCHW"``
    removes the stamp, restoring the class default."""
    if fmt not in ("NCHW", "NHWC"):
        raise ValueError(f"compute layout must be 'NCHW' or 'NHWC', "
                         f"got {fmt!r}")
    for layer in layers:
        if isinstance(layer, LAYOUT_AWARE):
            if fmt == "NHWC":
                layer.data_format = "NHWC"
            elif "data_format" in layer.__dict__:
                del layer.data_format


# --------------------------------------------------------- fused epilogues
# A BatchNormalization followed by a relu/leaky ActivationLayer becomes ONE
# ``scale_shift_act`` dispatch: the batch statistics are those of
# ``norm_ops.batch_norm_train`` and normalize + activation is one
# multiply-add + select. A preceding identity-activation conv's bias folds
# into the shift: in train mode it cancels against the batch mean and
# only shifts the recorded running mean; inference un-shifts it again.


def activation_alpha(layer) -> Optional[float]:
    """The epilogue slope of an ActivationLayer: 0.0 for relu, the leak
    for leakyrelu, None for anything else (not fusable)."""
    if type(layer) is not ActivationLayer:
        return None
    name = str(layer.activation or "").lower()
    if name == "relu":
        return 0.0
    if name == "leakyrelu":
        return 0.01      # ops.activations.leakyrelu default slope
    return None


def fusable_conv(layer) -> bool:
    """A plain ConvolutionLayer with an empty epilogue (identity
    activation), whose bias can fold into the BN's shift."""
    return (type(layer) is ConvolutionLayer
            and str(layer.activation or "identity").lower() == "identity")


def fusable_bn(layer) -> bool:
    return type(layer) is BatchNormalization


def fused_bn_act(bn, params, state, x, train, alpha: float, bias=None,
                 sync=None):
    """BatchNorm + relu/leaky (+ an optional folded conv bias) as one
    ``scale_shift_act`` dispatch. Returns ``(out, new_bn_state)``. With
    ``bias``, x is the bias-less conv output: the variance does not see
    the bias, the recorded running mean adds it back, and inference
    subtracts it from the running mean. ``sync`` is sync BN's moment
    reducer (``StepKey.sync``)."""
    axis = bn._channel_axis(x)
    gamma, beta = params["gamma"], params["beta"]
    b32 = bias.float() if bias is not None else None
    if train:
        axes = tuple(i for i in range(x.dim()) if i != axis)
        m, m2 = norm_ops.channel_moments(x, axes, sync)
        v = torch.clamp_min(m2 - m.square(), 0.0)
        m_rec = (m + b32 if b32 is not None else m).detach()
        new_state = {
            "mean": bn.decay * state["mean"] + (1.0 - bn.decay) * m_rec,
            "var": bn.decay * state["var"] + (1.0 - bn.decay) * v.detach()}
        mean_eff = m        # the folded bias cancels against the batch mean
    else:
        mean_eff = state["mean"] - b32 if b32 is not None else state["mean"]
        v = state["var"]
        new_state = state
    inv = torch.rsqrt(v.float() + bn.eps)
    scale = (gamma * inv).to(x.dtype)
    shift = (beta - gamma * mean_eff * inv).to(x.dtype)
    out = registry.get("scale_shift_act")(x, scale, shift, alpha=alpha,
                                          axis=axis)
    return out, new_state


def build_epilogue_plan(layers, preprocessors=()
                        ) -> Dict[int, Tuple[int, bool, float]]:
    """The sequential fusion plan (the JAX package's, nn/layers.py:1778):
    ``{start_index: (n_layers_consumed, conv_leads, alpha)}``, 3 for a
    conv(identity, bias) + BN + relu/leaky triple (the bias folds), 2 for
    a BN + act pair. A block with an input preprocessor at an interior
    index cannot fuse (the fused dispatch would skip it); one at the
    block's start runs before the block either way."""
    plan: Dict[int, Tuple[int, bool, float]] = {}
    pre = frozenset(preprocessors)
    i = 0
    while i < len(layers):
        if (i + 2 < len(layers) and fusable_conv(layers[i])
                and layers[i].has_bias and fusable_bn(layers[i + 1])
                and activation_alpha(layers[i + 2]) is not None
                and not (pre & {i + 1, i + 2})):
            plan[i] = (3, True, activation_alpha(layers[i + 2]))
            i += 3
            continue
        if (i + 1 < len(layers) and fusable_bn(layers[i])
                and activation_alpha(layers[i + 1]) is not None
                and i + 1 not in pre):
            plan[i] = (2, False, activation_alpha(layers[i + 1]))
            i += 2
            continue
        i += 1
    return plan


def conv_bias_add(layer, out, b):
    """Re-attach a conv bias to a ``skip_bias=True`` conv output,
    bit-identical to the unfused conv (``conv_ops.conv2d`` adds its bias
    as this same broadcast add after the convolution)."""
    return out + conv_ops._bias_reshape(b, 2, layer.data_format)
