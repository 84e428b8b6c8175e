"""Layer configurations and their forward passes (the feed-forward, 2-D
convolutional and recurrent layers of ``deeplearning4j_tpu/nn/layers.py``;
the 1-D/3-D, embedding and attention layers are not ported).

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
from typing import Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.config import InputType
from deeplearning4j_tpu_torch.nn.precision import normalize_dtype
from deeplearning4j_tpu_torch.ops import activations as act
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
    on the CPU from ``gen``. Fans as in the JAX package: conv OIHW has
    fan_in = I*kH*kW, fan_out = O*kH*kW."""
    shape = tuple(int(s) for s in shape)
    init = init.lower()
    fan_in = shape[0] if len(shape) >= 1 else 1
    fan_out = shape[-1] if len(shape) >= 2 else 1
    if len(shape) == 4:
        rf = shape[2] * shape[3]
        fan_in, fan_out = shape[1] * rf, shape[0] * rf
    if init in ("xavier", "glorot_uniform"):
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        return torch.rand(shape, generator=gen) * (2 * limit) - limit
    if init in ("relu", "he", "he_normal"):
        return torch.randn(shape, generator=gen) * math.sqrt(2.0 / fan_in)
    raise NotImplementedError(f"weight init {init!r}: only 'xavier' and "
                              "'relu' are ported")


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
                 dataType: str = None):
        self.nOut = nOut
        self.nIn = nIn
        self.activation = activation
        self.weight_init = weightInit
        self.bias_init = biasInit
        self.dropout = dropOut   # RETAIN probability (reference semantics)
        self.l1 = l1
        self.l2 = l2
        self.name = name or type(self).__name__
        self.tied_with = None   # likewise (a pipeline-stage lint's label)
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
                                             "dilation", "scale", "crop"):
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
                state["var"], eps=self.eps, decay=self.decay, axis=axis)
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


_LAYER_CLASSES = {cls.__name__: cls for cls in (
    DenseLayer, ConvolutionLayer, Deconvolution2D, DepthwiseConvolution2D,
    SeparableConvolution2D, SubsamplingLayer, BatchNormalization,
    LocalResponseNormalization, ActivationLayer, DropoutLayer,
    SpatialDropoutLayer, ZeroPaddingLayer, Upsampling2D, Cropping2D,
    GlobalPoolingLayer, LSTM, GravesLSTM, GRU, SimpleRnn, Bidirectional,
    BidirectionalLastStep, LastTimeStep, OutputLayer, LossLayer,
    RnnOutputLayer)}


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


def fused_bn_act(bn, params, state, x, train, alpha: float, bias=None):
    """BatchNorm + relu/leaky (+ an optional folded conv bias) as one
    ``scale_shift_act`` dispatch. Returns ``(out, new_bn_state)``. With
    ``bias``, x is the bias-less conv output: the variance does not see
    the bias, the recorded running mean adds it back, and inference
    subtracts it from the running mean."""
    axis = bn._channel_axis(x)
    gamma, beta = params["gamma"], params["beta"]
    b32 = bias.float() if bias is not None else None
    if train:
        axes = tuple(i for i in range(x.dim()) if i != axis)
        m, m2 = norm_ops.channel_moments(x, axes)
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
