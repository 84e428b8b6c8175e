"""Layer configurations and their forward passes (the feed-forward and
2-D convolutional layers of ``deeplearning4j_tpu/nn/layers.py``; the
recurrent, 1-D/3-D and attention layers are not ported).

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

import math
from typing import Dict, Optional, Tuple

import torch

from deeplearning4j_tpu_torch.nn.config import InputType
from deeplearning4j_tpu_torch.nn.precision import normalize_dtype
from deeplearning4j_tpu_torch.ops import activations as act
from deeplearning4j_tpu_torch.ops import convolution as conv_ops
from deeplearning4j_tpu_torch.ops import losses as loss_ops
from deeplearning4j_tpu_torch.ops import normalization as norm_ops
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
    """ref: GlobalPoolingLayer — cnn [N, C, H, W] -> [N, C]."""

    input_kind = None
    has_params = False

    def __init__(self, poolingType: str = "max", **kw):
        super().__init__(**kw)
        self.pooling = poolingType.lower()

    def infer_nin(self, it):
        self.nIn = self.nOut = it.channels if it.kind == "cnn" \
            else it.arrayElementsPerExample()

    def apply(self, params, state, x, train, key=None):
        fmt = self.data_format if x.dim() == 4 else "NCHW"
        return conv_ops.global_pool(x, self.pooling, data_format=fmt), state

    def output_type(self, it):
        return InputType.feedForward(it.channels if it.kind == "cnn"
                                     else it.arrayElementsPerExample())


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


_LAYER_CLASSES = {cls.__name__: cls for cls in (
    DenseLayer, ConvolutionLayer, Deconvolution2D, DepthwiseConvolution2D,
    SeparableConvolution2D, SubsamplingLayer, BatchNormalization,
    LocalResponseNormalization, ActivationLayer, DropoutLayer,
    SpatialDropoutLayer, ZeroPaddingLayer, Upsampling2D, Cropping2D,
    GlobalPoolingLayer, OutputLayer, LossLayer)}


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
    per-layer ``dataType="float32"`` declares an fp32 island."""
    if compute_dt is None:
        return params, x
    override = getattr(layer, "dtype_override", None)
    if override == "float32" or isinstance(layer, BaseOutputLayer):
        if x.is_floating_point() and x.dtype != torch.float32:
            x = x.float()
        return params, x
    if isinstance(layer, _POLICY_FP32_PARAM_LAYERS):
        return params, x
    if x.is_floating_point() and x.dtype != compute_dt:
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
