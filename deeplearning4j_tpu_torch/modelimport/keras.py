"""Keras ``.h5`` model import — the port of
``deeplearning4j_tpu/modelimport/keras.py`` (ref:
``org.deeplearning4j.nn.modelimport.keras``: ``KerasModelImport.
importKerasSequentialModelAndWeights`` / ``importKerasModelAndWeights``
and the per-layer ``KerasLayer`` mappers).

The file is read by :mod:`.hdf5` (stdlib and numpy; the card's machine
has no h5py): the ``model_config`` JSON attribute and the
``model_weights`` groups. A Sequential model rebuilds as a
``MultiLayerNetwork``, a Functional one as a ``ComputationGraph``, with
the JAX package's mappers, its ``_SKIP`` set, its ``_flatten_perm``
reorders and shape checks, so both packages build the same network from
one file. The import attaches a ``ValidationReport`` (``import_report``:
W161 on dynamic input dims, E163 on narrowed weights) from
``analysis.imports``.

Convention translation (the JAX package's):

- Keras is channels-last ([N, H, W, C], [N, T, C]); the rebuilt net takes
  DL4J's NCHW and [N, C, T]. Feed inputs accordingly.
- Conv kernels [kH, kW, cIn, cOut] -> [cOut, cIn, kH, kW].
- A Dense after a Flatten of a conv map has its kernel rows reordered
  from Keras's (h, w, c) flattening to (c, h, w).
- A ``MultiHeadAttention`` imports used self-attentively (query is value)
  as ``SelfAttentionLayer``; its [E, H, hd] kernels reshape to [E, H*hd].
- Keras ``"gelu"`` maps to DL4J's ``gelu``, the tanh approximation (Keras
  computes the exact erf form by default), as in the JAX package.
- A plain ``Dense`` over a sequence imports but cannot run (its
  preprocessor flattens time into the rows and nothing folds it back), as
  in the JAX package; wrap it in ``TimeDistributed``.

The network is built and initialized on the CPU, the imported weights
replace the initial ones, and then every tensor goes to ``device`` once:
the card unless the caller names another.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.analysis import imports as _imp
from deeplearning4j_tpu_torch.analysis.diagnostics import ValidationReport
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.modelimport.hdf5 import (Hdf5Archive,
                                                       Hdf5FormatError)
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn import preprocessors as pp
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.graph import (ComputationGraph,
                                               DotProductVertex,
                                               ElementWiseVertex, MergeVertex)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

__all__ = ["KerasImportError", "Hdf5FormatError", "KerasModelImport",
           "importKerasModelAndWeights",
           "importKerasSequentialModelAndWeights"]


class KerasImportError(ValueError):
    """ref: InvalidKerasConfigurationException /
    UnsupportedKerasConfigurationException."""


# --------------------------------------------------------------------------
# per-layer mapping (ref: the ~60 KerasLayer subclasses; one function each)
# --------------------------------------------------------------------------

_ACTIVATION_MAP = {
    "linear": "identity", "relu": "relu", "relu6": "relu6",
    "sigmoid": "sigmoid", "tanh": "tanh", "softmax": "softmax",
    "elu": "elu", "selu": "selu", "softplus": "softplus",
    "softsign": "softsign", "swish": "swish", "silu": "swish",
    "gelu": "gelu", "hard_sigmoid": "hardsigmoid", "mish": "mish",
    "leaky_relu": "leakyrelu", "exponential": None,
}


def _act(name) -> str:
    if name is None:
        return "identity"
    if isinstance(name, dict):  # serialized Activation object
        name = name.get("config", {}).get("name", "linear")
    mapped = _ACTIVATION_MAP.get(str(name).lower())
    if mapped is None:
        raise KerasImportError(f"unsupported Keras activation '{name}'")
    return mapped


def _pair(v):
    return tuple(v) if isinstance(v, (list, tuple)) else (int(v), int(v))


def _conv_mode(padding: str) -> Tuple[str, Tuple[int, int]]:
    p = str(padding).lower()
    if p == "same":
        return "same", (0, 0)
    if p == "valid":
        return "truncate", (0, 0)
    raise KerasImportError(f"unsupported Keras padding '{padding}'")


def _flatten_perm(c: int, h: int, w: int) -> np.ndarray:
    """Row permutation taking Keras's (h, w, c)-flattened feature index to
    our (c, h, w) flattening: perm[our_index] = keras_index."""
    return np.arange(h * w * c).reshape(h, w, c).transpose(2, 0, 1).reshape(-1)


def _flatten_perm3d(c: int, d: int, h: int, w: int) -> np.ndarray:
    """Same for volumes: Keras (d, h, w, c) -> our (c, d, h, w)."""
    return (np.arange(d * h * w * c).reshape(d, h, w, c)
            .transpose(3, 0, 1, 2).reshape(-1))


class _Imported:
    """One mapped layer: our layer object + how to fill its params/state."""

    def __init__(self, layer, kname: str, fill=None):
        self.layer = layer
        self.kname = kname          # keras layer name (weights group)
        self.fill = fill            # fn(kweights, pre_it) -> (params, state)


def _map_dense(cfg) -> _Imported:
    lay = L.DenseLayer(nOut=int(cfg["units"]), hasBias=bool(cfg.get("use_bias", True)),
                       activation=_act(cfg.get("activation")))

    def fill(kw, pre_it):
        W = kw["kernel"]
        if pre_it is not None and pre_it.kind == "cnn":
            perm = _flatten_perm(pre_it.channels, pre_it.height, pre_it.width)
            W = W[perm]
        elif pre_it is not None and pre_it.kind == "cnn3d":
            W = W[_flatten_perm3d(pre_it.channels, pre_it.depth,
                                  pre_it.height, pre_it.width)]
        params = {"W": np.asarray(W)}
        if "bias" in kw:
            params["b"] = np.asarray(kw["bias"])
        return params, None
    return _Imported(lay, cfg["name"], fill)


def _map_conv2d(cfg) -> _Imported:
    mode, pad = _conv_mode(cfg.get("padding", "valid"))
    if str(cfg.get("data_format", "channels_last")) == "channels_first":
        raise KerasImportError("channels_first Keras convs are not supported; "
                               "save the model channels_last")
    lay = L.ConvolutionLayer(
        kernelSize=_pair(cfg["kernel_size"]), stride=_pair(cfg.get("strides", 1)),
        padding=pad, dilation=_pair(cfg.get("dilation_rate", 1)),
        nOut=int(cfg["filters"]), convolutionMode=mode,
        hasBias=bool(cfg.get("use_bias", True)),
        activation=_act(cfg.get("activation")))

    def fill(kw, pre_it):
        params = {"W": np.asarray(kw["kernel"].transpose(3, 2, 0, 1))}
        if "bias" in kw:
            params["b"] = np.asarray(kw["bias"])
        return params, None
    return _Imported(lay, cfg["name"], fill)


def _map_conv2d_transpose(cfg) -> _Imported:
    mode, pad = _conv_mode(cfg.get("padding", "valid"))
    if cfg.get("output_padding") not in (None, [None, None]):
        raise KerasImportError(
            "Conv2DTranspose output_padding is not supported")
    if str(cfg.get("data_format", "channels_last")) == "channels_first":
        raise KerasImportError("channels_first Keras convs are not supported; "
                               "save the model channels_last")
    if _pair(cfg.get("dilation_rate", 1)) != (1, 1):
        raise KerasImportError(
            "dilated Conv2DTranspose does not import (deconv2d has no "
            "dilation path)")
    lay = L.Deconvolution2D(
        kernelSize=_pair(cfg["kernel_size"]),
        stride=_pair(cfg.get("strides", 1)), padding=pad,
        nOut=int(cfg["filters"]), convolutionMode=mode,
        hasBias=bool(cfg.get("use_bias", True)),
        activation=_act(cfg.get("activation")))

    def fill(kw, pre_it):
        # keras transposed-conv kernel [kH, kW, cOut, cIn] (out/in swapped
        # vs Conv2D) -> ours [cOut, cIn, kH, kW]
        params = {"W": np.asarray(kw["kernel"].transpose(2, 3, 0, 1))}
        if "bias" in kw:
            params["b"] = np.asarray(kw["bias"])
        return params, None
    return _Imported(lay, cfg["name"], fill)


def _map_depthwise_conv2d(cfg) -> _Imported:
    mode, pad = _conv_mode(cfg.get("padding", "valid"))
    lay = L.DepthwiseConvolution2D(
        kernelSize=_pair(cfg["kernel_size"]), stride=_pair(cfg.get("strides", 1)),
        padding=pad, depthMultiplier=int(cfg.get("depth_multiplier", 1)),
        convolutionMode=mode, hasBias=bool(cfg.get("use_bias", True)),
        activation=_act(cfg.get("activation")))

    def fill(kw, pre_it):
        # keras depthwise kernel [kH, kW, cIn, mult] -> ours [mult, cIn, kH, kW]
        params = {"W": np.asarray(kw["kernel"].transpose(3, 2, 0, 1))}
        if "bias" in kw:
            params["b"] = np.asarray(kw["bias"])
        return params, None
    return _Imported(lay, cfg["name"], fill)


def _map_pool2d(cfg, pooling: str) -> _Imported:
    mode, pad = _conv_mode(cfg.get("padding", "valid"))
    size = _pair(cfg.get("pool_size", 2))
    strides = cfg.get("strides")
    lay = L.SubsamplingLayer(poolingType=pooling, kernelSize=size,
                             stride=_pair(strides) if strides else size,
                             padding=pad, convolutionMode=mode)
    return _Imported(lay, cfg["name"])


def _map_batchnorm(cfg) -> _Imported:
    lay = L.BatchNormalization(decay=float(cfg.get("momentum", 0.99)),
                               eps=float(cfg.get("epsilon", 1e-3)))

    def fill(kw, pre_it):
        n = next(iter(kw.values())).shape[0]
        params = {"gamma": np.asarray(kw.get("gamma", np.ones(n, np.float32))),
                  "beta": np.asarray(kw.get("beta", np.zeros(n, np.float32)))}
        state = {"mean": np.asarray(kw["moving_mean"]),
                 "var": np.asarray(kw["moving_variance"])}
        return params, state
    return _Imported(lay, cfg["name"], fill)


def _map_embedding(cfg) -> _Imported:
    lay = L.EmbeddingSequenceLayer(nOut=int(cfg["output_dim"]))
    lay.nIn = int(cfg["input_dim"])

    def fill(kw, pre_it):
        return {"W": np.asarray(kw["embeddings"])}, None
    return _Imported(lay, cfg["name"], fill)


def _rnn_fill(kw, pre_it):
    params = {"W": np.asarray(kw["kernel"]),
              "RW": np.asarray(kw["recurrent_kernel"])}
    if "bias" in kw:
        b = kw["bias"]
        if b.ndim == 2:  # keras GRU/LSTM sometimes [2, 4u] (use_bias x2)
            b = b.sum(0)
        params["b"] = np.asarray(b)
    else:
        params["b"] = np.zeros(params["W"].shape[1], np.float32)
    return params, None


def _map_lstm(cfg) -> _Imported:
    if _act(cfg.get("recurrent_activation", "sigmoid")) != "sigmoid":
        raise KerasImportError("only sigmoid recurrent_activation LSTMs import")
    if _act(cfg.get("activation", "tanh")) != "tanh":
        # ops/recurrent.py lstm_cell hard-codes tanh; importing anything else
        # would silently compute the wrong function (advisor r2 low)
        raise KerasImportError("only tanh cell-activation LSTMs import")
    inner = L.LSTM(nOut=int(cfg["units"]), activation=_act(cfg.get("activation", "tanh")))
    lay = inner if cfg.get("return_sequences") else L.LastTimeStep(inner)
    return _Imported(lay, cfg["name"], _rnn_fill)


def _map_simple_rnn(cfg) -> _Imported:
    inner = L.SimpleRnn(nOut=int(cfg["units"]),
                        activation=_act(cfg.get("activation", "tanh")))
    lay = inner if cfg.get("return_sequences") else L.LastTimeStep(inner)
    return _Imported(lay, cfg["name"], _rnn_fill)


def _map_gru(cfg) -> _Imported:
    """Keras GRU: gate order [z, r, h] -> ours [r, z, n]; only the Keras-2
    default reset_after=True matches gruCell's bias-inside-reset form."""
    if not cfg.get("reset_after", True):
        raise KerasImportError(
            "GRU(reset_after=False) computes tanh(i_n + (r*h)Wn) which "
            "gruCell does not implement; re-save with reset_after=True")
    if _act(cfg.get("recurrent_activation", "sigmoid")) != "sigmoid":
        raise KerasImportError("only sigmoid recurrent_activation GRUs import")
    if _act(cfg.get("activation", "tanh")) != "tanh":
        raise KerasImportError("only tanh cell-activation GRUs import")
    inner = L.GRU(nOut=int(cfg["units"]))
    lay = inner if cfg.get("return_sequences") else L.LastTimeStep(inner)

    def fill(kw, pre_it):
        def reorder(m):   # [.., 3H] columns z,r,h -> r,z,h
            z, r, h = np.split(np.asarray(m), 3, axis=-1)
            return np.concatenate([r, z, h], axis=-1)
        W, RW = reorder(kw["kernel"]), reorder(kw["recurrent_kernel"])
        H3 = W.shape[-1]
        if "bias" in kw:
            b = np.asarray(kw["bias"])
            bi, br = (b[0], b[1]) if b.ndim == 2 else (b, np.zeros_like(b))
            bi, br = reorder(bi), reorder(br)
        else:
            bi = np.zeros(H3, np.float32)
            br = np.zeros(H3, np.float32)
        return {"W": np.asarray(W), "RW": np.asarray(RW),
                "b": np.asarray(bi), "bR": np.asarray(br)}, None
    return _Imported(lay, cfg["name"], fill)


def _map_bidirectional(cfg) -> _Imported:
    entry = cfg["layer"]
    icls, icfg = entry["class_name"], dict(entry["config"])
    if icls not in ("LSTM", "GRU", "SimpleRNN"):
        raise KerasImportError(
            f"Bidirectional wrapping '{icls}' is not supported")
    ret_seq = icfg.get("return_sequences", False)
    fwd = _MAPPERS[icls]({**icfg, "return_sequences": True,
                          "name": icfg.get("name", cfg["name"])})
    bwd = _MAPPERS[icls]({**icfg, "return_sequences": True,
                          "name": icfg.get("name", cfg["name"])})
    mode = {None: "concat", "concat": "concat", "sum": "add", "mul": "mul",
            "ave": "average"}.get(cfg.get("merge_mode", "concat"))
    if mode is None:
        raise KerasImportError(
            f"Bidirectional merge_mode '{cfg.get('merge_mode')}' unsupported")
    # return_sequences=False has KERAS step semantics: fwd last output +
    # bwd FINAL STATE (position 0) — not LastTimeStep(Bidirectional(...))
    cls = L.Bidirectional if ret_seq else L.BidirectionalLastStep
    lay = cls(fwd.layer, mode=mode)
    lay.bwd = bwd.layer         # independently-weighted backward direction

    def fill(kw, pre_it):
        fwd_kw = {k[4:]: v for k, v in kw.items() if k.startswith("fwd/")}
        bwd_kw = {k[4:]: v for k, v in kw.items() if k.startswith("bwd/")}
        if not fwd_kw or not bwd_kw:
            raise KerasImportError(
                "Bidirectional weights missing forward/backward groups")
        pf, _ = fwd.fill(fwd_kw, pre_it)
        pb, _ = bwd.fill(bwd_kw, pre_it)
        return {"fwd": pf, "bwd": pb}, None
    return _Imported(lay, cfg["name"], fill)


def _first(v) -> int:
    """Keras 1-D hyperparams arrive as [k] or k."""
    return int(v[0] if isinstance(v, (list, tuple)) else v)


def _map_conv1d(cfg) -> _Imported:
    p = str(cfg.get("padding", "valid")).lower()
    if p == "causal":
        mode, pad = "causal", 0
    else:
        mode, pad = _conv_mode(p)
        pad = 0
    lay = L.Convolution1D(
        kernelSize=_first(cfg["kernel_size"]),
        stride=_first(cfg.get("strides", 1)),
        padding=pad, nOut=int(cfg["filters"]), convolutionMode=mode,
        dilation=_first(cfg.get("dilation_rate", 1)),
        hasBias=bool(cfg.get("use_bias", True)),
        activation=_act(cfg.get("activation")))

    def fill(kw, pre_it):
        # keras [k, cIn, cOut] -> ours [cOut, cIn, k]
        params = {"W": np.asarray(np.transpose(kw["kernel"], (2, 1, 0)))}
        if "bias" in kw:
            params["b"] = np.asarray(kw["bias"])
        return params, None
    return _Imported(lay, cfg["name"], fill)


def _map_separable_conv2d(cfg) -> _Imported:
    mode, pad = _conv_mode(cfg.get("padding", "valid"))
    lay = L.SeparableConvolution2D(
        kernelSize=_pair(cfg["kernel_size"]),
        stride=_pair(cfg.get("strides", 1)), padding=pad,
        depthMultiplier=int(cfg.get("depth_multiplier", 1)),
        nOut=int(cfg["filters"]), convolutionMode=mode,
        dilation=_pair(cfg.get("dilation_rate", 1)),
        hasBias=bool(cfg.get("use_bias", True)),
        activation=_act(cfg.get("activation")))

    def fill(kw, pre_it):
        # depthwise [kH, kW, cIn, mult] -> [mult, cIn, kH, kW];
        # pointwise [1, 1, cIn*mult, cOut] -> [cOut, cIn*mult, 1, 1]
        params = {
            "Wd": np.asarray(kw["depthwise_kernel"].transpose(3, 2, 0, 1)),
            "Wp": np.asarray(kw["pointwise_kernel"].transpose(3, 2, 0, 1)),
        }
        if "bias" in kw:
            params["b"] = np.asarray(kw["bias"])
        return params, None
    return _Imported(lay, cfg["name"], fill)


def _norm_2d_spec(v):
    """Keras ((t, b), (l, r)) | (h, w) | int -> our layer's spec."""
    if isinstance(v, int):
        return (v, v)
    v = list(v)
    if all(isinstance(x, int) for x in v):
        return tuple(v)
    return tuple(tuple(x) for x in v)


def _map_zero_padding2d(cfg) -> _Imported:
    return _Imported(
        L.ZeroPaddingLayer(padding=_norm_2d_spec(cfg.get("padding", 1))),
        cfg["name"])


def _map_cropping2d(cfg) -> _Imported:
    return _Imported(
        L.Cropping2D(crop=_norm_2d_spec(cfg.get("cropping", 1))), cfg["name"])


def _map_upsampling2d(cfg) -> _Imported:
    if str(cfg.get("interpolation", "nearest")) != "nearest":
        raise KerasImportError("only nearest-neighbour UpSampling2D imports")
    return _Imported(L.Upsampling2D(size=_pair(cfg.get("size", 2))),
                     cfg["name"])


def _map_leaky_relu(cfg) -> _Imported:
    # any fixed slope maps exactly onto PReLULayer with constant alpha
    alpha = float(cfg.get("alpha", cfg.get("negative_slope", 0.3)))
    lay = L.PReLULayer()

    def fill(kw, pre_it):
        n = pre_it.arrayElementsPerExample() if pre_it is not None else 1
        return {"alpha": np.full((n,), alpha, np.float32)}, None
    return _Imported(lay, cfg["name"], fill)


def _map_activation(cfg) -> _Imported:
    return _Imported(L.ActivationLayer(_act(cfg.get("activation"))), cfg["name"])


def _map_dropout(cfg) -> _Imported:
    return _Imported(L.DropoutLayer(float(cfg.get("rate", 0.5))), cfg["name"])


def _map_global_pool(cfg, pooling: str) -> _Imported:
    return _Imported(L.GlobalPoolingLayer(pooling), cfg["name"])


def _map_pool1d(cfg, pooling: str) -> _Imported:
    p = str(cfg.get("padding", "valid")).lower()
    mode = "same" if p == "same" else "truncate"
    size = _first(cfg.get("pool_size", 2))
    strides = cfg.get("strides")
    lay = L.Subsampling1DLayer(
        poolingType=pooling, kernelSize=size,
        stride=_first(strides) if strides is not None else size,
        convolutionMode=mode)
    return _Imported(lay, cfg["name"])


def _map_layernorm(cfg) -> _Imported:
    axis = cfg.get("axis", -1)
    if isinstance(axis, (list, tuple)):
        if len(axis) != 1:
            raise KerasImportError(
                f"multi-axis LayerNormalization {axis} unsupported")
        axis = axis[0]
    # only the feature axis maps onto the NCW/ff convention: -1, or the
    # explicit channels axis 2 of a keras [N, T, C] input
    if int(axis) not in (-1, 2):
        raise KerasImportError(
            f"LayerNormalization axis {axis} unsupported (last/channel "
            f"axis only)")
    lay = L.LayerNorm(eps=float(cfg.get("epsilon", 1e-3)))

    def fill(kw, pre_it):
        n = kw["gamma"].shape[0] if "gamma" in kw else kw["beta"].shape[0]
        return {"gamma": np.asarray(kw.get("gamma", np.ones(n, np.float32))),
                "beta": np.asarray(kw.get("beta", np.zeros(n, np.float32)))
                }, None
    return _Imported(lay, cfg["name"], fill)


def _map_prelu(cfg) -> _Imported:
    shared = cfg.get("shared_axes")
    if shared:
        raise KerasImportError("PReLU shared_axes import not supported")
    lay = L.PReLULayer()

    def fill(kw, pre_it):
        alpha = np.asarray(kw["alpha"])
        if alpha.ndim != 1:
            # 2-D/3-D keras alphas are laid out (T,C)/(H,W,C); our PReLU
            # broadcast is (C,H,W)-flat — refusing beats silent mis-order
            raise KerasImportError(
                f"PReLU over non-dense input (alpha shape "
                f"{alpha.shape}) is not supported; only 1-D feature "
                f"alphas import")
        return {"alpha": np.asarray(alpha)}, None
    return _Imported(lay, cfg["name"], fill)


def _map_elu_layer(cfg) -> _Imported:
    if abs(float(cfg.get("alpha", 1.0)) - 1.0) > 1e-9:
        raise KerasImportError("ELU layer with alpha != 1.0 unsupported")
    return _Imported(L.ActivationLayer("elu"), cfg["name"])


def _map_permute(cfg) -> _Imported:
    # keras dims are 1-based over [T, C]; our layout is [C, T] — the only
    # meaningful permutation either layout supports is the (2, 1) swap
    dims = tuple(cfg.get("dims", (2, 1)))
    if dims != (2, 1):
        raise KerasImportError(f"Permute dims {dims} unsupported")
    return _Imported(L.Permute((2, 1)), cfg["name"])


def _map_repeat_vector(cfg) -> _Imported:
    return _Imported(L.RepeatVector(int(cfg["n"])), cfg["name"])


_SKIP = {"InputLayer", "Flatten", "Reshape"}  # handled by preprocessors

def _map_conv3d(cfg) -> _Imported:
    mode, _ = _conv_mode(cfg.get("padding", "valid"))
    if str(cfg.get("data_format", "channels_last")) == "channels_first":
        raise KerasImportError("channels_first Keras convs are not "
                               "supported; save the model channels_last")
    dil = cfg.get("dilation_rate", (1, 1, 1))
    if tuple(dil) != (1, 1, 1):
        raise KerasImportError("dilated Conv3D does not import "
                               "(Convolution3D has no dilation)")
    lay = L.Convolution3D(kernelSize=tuple(cfg["kernel_size"]),
                          stride=tuple(cfg.get("strides", (1, 1, 1))),
                          nOut=int(cfg["filters"]), convolutionMode=mode,
                          hasBias=bool(cfg.get("use_bias", True)),
                          activation=_act(cfg.get("activation")))

    def fill(kw, pre_it):
        # keras [kD, kH, kW, inC, outC] -> ours [outC, inC, kD, kH, kW]
        W = np.transpose(kw["kernel"], (4, 3, 0, 1, 2))
        params = {"W": np.asarray(W)}
        if "bias" in kw:
            params["b"] = np.asarray(kw["bias"])
        return params, None
    return _Imported(lay, cfg["name"], fill)


def _map_pool3d(cfg, pooling: str) -> _Imported:
    mode, _ = _conv_mode(cfg.get("padding", "valid"))
    if mode != "truncate":
        raise KerasImportError("SAME-padded 3D pooling does not import")
    lay = L.Subsampling3DLayer(poolingType=pooling,
                               kernelSize=tuple(cfg.get("pool_size",
                                                        (2, 2, 2))),
                               stride=tuple(cfg["strides"])
                               if cfg.get("strides") else None)
    return _Imported(lay, cfg["name"])


def _map_upsampling1d(cfg) -> _Imported:
    return _Imported(L.Upsampling1D(size=int(cfg.get("size", 2))),
                     cfg["name"])


def _map_zero_padding1d(cfg) -> _Imported:
    return _Imported(L.ZeroPadding1DLayer(padding=cfg.get("padding", 1)),
                     cfg["name"])


def _map_cropping1d(cfg) -> _Imported:
    return _Imported(L.Cropping1D(cropping=cfg.get("cropping", 1)),
                     cfg["name"])


def _map_masking(cfg) -> _Imported:
    return _Imported(L.MaskZeroLayer(maskValue=cfg.get("mask_value", 0.0)),
                     cfg["name"])


def _map_gaussian_noise(cfg) -> _Imported:
    return _Imported(L.GaussianNoiseLayer(stddev=cfg.get("stddev", 0.1)),
                     cfg["name"])


def _map_gaussian_dropout(cfg) -> _Imported:
    return _Imported(L.GaussianDropoutLayer(rate=cfg.get("rate", 0.1)),
                     cfg["name"])


def _map_alpha_dropout(cfg) -> _Imported:
    return _Imported(L.AlphaDropoutLayer(rate=cfg.get("rate", 0.1)),
                     cfg["name"])


def _map_softmax_layer(cfg) -> _Imported:
    if cfg.get("axis", -1) not in (-1, 1):
        raise KerasImportError("Softmax layer axis must be the feature axis")
    return _Imported(L.ActivationLayer("softmax"), cfg["name"])


def _map_thresholded_relu(cfg) -> _Imported:
    if abs(cfg.get("theta", 1.0) - 1.0) > 1e-9:
        raise KerasImportError("ThresholdedReLU imports with theta=1.0 only")
    return _Imported(L.ActivationLayer("thresholdedrelu"), cfg["name"])


def _map_relu_layer(cfg) -> _Imported:
    if cfg.get("max_value") is not None or cfg.get("threshold", 0.0):
        raise KerasImportError("ReLU layer with max_value/threshold "
                               "does not import")
    slope = cfg.get("negative_slope", 0.0) or 0.0
    if slope:
        return _map_leaky_relu({**cfg, "alpha": slope})
    return _Imported(L.ActivationLayer("relu"), cfg["name"])


def _map_time_distributed(cfg) -> _Imported:
    inner = cfg.get("layer", {})
    icls = inner.get("class_name")
    if icls != "Dense":
        raise KerasImportError(f"TimeDistributed({icls}) unsupported "
                               f"(Dense only)")
    icfg = dict(inner["config"])
    lay = L.TimeDistributed(nOut=int(icfg["units"]),
                            activation=_act(icfg.get("activation")))
    lay.has_bias = bool(icfg.get("use_bias", True))

    def fill(kw, pre_it):
        params = {"W": np.asarray(kw["kernel"])}
        if "bias" in kw:
            params["b"] = np.asarray(kw["bias"])
        return params, None
    return _Imported(lay, cfg["name"], fill)


def _map_multi_head_attention(cfg) -> _Imported:
    """Keras MultiHeadAttention used SELF-attentively (query is value).
    keras kernels [E, H, hd] reshape to our [nIn, H*hd] projections."""
    H = int(cfg["num_heads"])
    hd = int(cfg["key_dim"])
    if cfg.get("value_dim") not in (None, cfg["key_dim"]):
        raise KerasImportError("MultiHeadAttention with value_dim != "
                               "key_dim does not import")
    lay = L.SelfAttentionLayer(nHeads=H, headSize=hd, projectInput=True,
                               useBias=bool(cfg.get("use_bias", True)),
                               activation="identity")

    def fill(kw, pre_it):
        def proj(name):
            k = kw[f"{name}/kernel"]          # [E, H, hd]
            return np.asarray(k.reshape(k.shape[0], H * hd))
        params = {"Wq": proj("query"), "Wk": proj("key"),
                  "Wv": proj("value"),
                  "Wo": np.asarray(kw["attention_output/kernel"]
                                    .reshape(H * hd, -1))}
        if "query/bias" in kw:
            params.update({
                "bq": np.asarray(kw["query/bias"].reshape(-1)),
                "bk": np.asarray(kw["key/bias"].reshape(-1)),
                "bv": np.asarray(kw["value/bias"].reshape(-1)),
                "bo": np.asarray(kw["attention_output/bias"].reshape(-1))})
        return params, None
    return _Imported(lay, cfg["name"], fill)


def _map_spatial_dropout(cfg) -> _Imported:
    # channel dropout (whole feature maps), matching Keras training
    # semantics — NOT element-wise DropoutLayer
    return _Imported(L.SpatialDropoutLayer(float(cfg.get("rate", 0.5))),
                     cfg["name"])


def _map_group_norm(cfg) -> _Imported:
    if cfg.get("axis", -1) not in (-1, 3):
        raise KerasImportError(
            f"GroupNormalization axis {cfg.get('axis')} unsupported "
            f"(channels_last channel axis only)")
    lay = L.GroupNorm(groups=int(cfg.get("groups", 32)),
                      eps=float(cfg.get("epsilon", 1e-3)))

    def fill(kw, pre_it):
        n = lay.nIn
        return {"gamma": np.asarray(kw.get("gamma",
                                            np.ones(n, np.float32))),
                "beta": np.asarray(kw.get("beta",
                                           np.zeros(n, np.float32)))}, None
    if not (cfg.get("center", True) or cfg.get("scale", True)):
        fill = None      # weight-free layer: init gamma=1/beta=0 is exact
    return _Imported(lay, cfg["name"], fill)


def _map_unit_norm(cfg) -> _Imported:
    ax = cfg.get("axis", -1)
    if ax not in (-1, 3) and ax not in ([-1], [3]):
        raise KerasImportError(
            f"UnitNormalization axis {ax} unsupported (last/channel axis "
            f"only)")
    return _Imported(L.UnitNormLayer(), cfg["name"])


def _map_conv_lstm2d(cfg) -> _Imported:
    if _act(cfg.get("activation", "tanh")) != "tanh" or \
            _act(cfg.get("recurrent_activation", "sigmoid")) != "sigmoid":
        raise KerasImportError(
            "ConvLSTM2D imports with the default tanh/sigmoid activations "
            "only")
    if float(cfg.get("dropout", 0.0)) or float(
            cfg.get("recurrent_dropout", 0.0)):
        raise KerasImportError("ConvLSTM2D dropout variants do not import")
    if str(cfg.get("data_format", "channels_last")) == "channels_first":
        raise KerasImportError("channels_first Keras convs are not "
                               "supported; save the model channels_last")
    if _pair(cfg.get("dilation_rate", 1)) != (1, 1):
        raise KerasImportError("dilated ConvLSTM2D does not import")
    if cfg.get("go_backwards") or cfg.get("stateful"):
        raise KerasImportError(
            "ConvLSTM2D go_backwards/stateful variants do not import")
    mode, _pad0 = _conv_mode(cfg.get("padding", "valid"))
    lay = L.ConvLSTM2D(
        nOut=int(cfg["filters"]), kernelSize=_pair(cfg["kernel_size"]),
        stride=_pair(cfg.get("strides", 1)), convolutionMode=mode,
        returnSequences=bool(cfg.get("return_sequences", False)))

    def fill(kw, pre_it):
        # keras kernel [kh, kw, cIn, 4*out] -> ours [4*out, cIn, kh, kw];
        # recurrent_kernel [kh, kw, out, 4*out] -> [4*out, out, kh, kw]
        params = {"W": np.asarray(kw["kernel"].transpose(3, 2, 0, 1)),
                  "RW": np.asarray(
                      kw["recurrent_kernel"].transpose(3, 2, 0, 1))}
        if "bias" in kw:
            params["b"] = np.asarray(kw["bias"])
        return params, None
    return _Imported(lay, cfg["name"], fill)


def _map_zero_padding3d(cfg) -> _Imported:
    return _Imported(L.ZeroPadding3DLayer(padding=cfg.get("padding", 1)),
                     cfg["name"])


def _map_cropping3d(cfg) -> _Imported:
    return _Imported(L.Cropping3D(crop=cfg.get("cropping", 1)), cfg["name"])


def _map_upsampling3d(cfg) -> _Imported:
    return _Imported(L.Upsampling3D(size=cfg.get("size", 2)), cfg["name"])


def _map_activity_regularization(cfg) -> _Imported:
    # inference/structure no-op: the activity penalty only shifts training
    # loss; DL4J imports it the same way
    return _Imported(L.ActivationLayer("identity"), cfg["name"])


_MAPPERS = {
    "Dense": _map_dense,
    "Conv2DTranspose": _map_conv2d_transpose,
    "ZeroPadding3D": _map_zero_padding3d,
    "Cropping3D": _map_cropping3d,
    "UpSampling3D": _map_upsampling3d,
    "SpatialDropout1D": _map_spatial_dropout,
    "SpatialDropout3D": _map_spatial_dropout,
    "GlobalMaxPooling3D": lambda c: _map_global_pool(c, "max"),
    "GlobalAveragePooling3D": lambda c: _map_global_pool(c, "avg"),
    "ActivityRegularization": _map_activity_regularization,
    "GroupNormalization": _map_group_norm,
    "UnitNormalization": _map_unit_norm,
    "ConvLSTM2D": _map_conv_lstm2d,
    "Conv1D": _map_conv1d,
    "Conv2D": _map_conv2d,
    "DepthwiseConv2D": _map_depthwise_conv2d,
    "SeparableConv2D": _map_separable_conv2d,
    "MaxPooling1D": lambda c: _map_pool1d(c, "max"),
    "AveragePooling1D": lambda c: _map_pool1d(c, "avg"),
    "MaxPooling2D": lambda c: _map_pool2d(c, "max"),
    "AveragePooling2D": lambda c: _map_pool2d(c, "avg"),
    "GlobalMaxPooling2D": lambda c: _map_global_pool(c, "max"),
    "GlobalAveragePooling2D": lambda c: _map_global_pool(c, "avg"),
    "GlobalMaxPooling1D": lambda c: _map_global_pool(c, "max"),
    "GlobalAveragePooling1D": lambda c: _map_global_pool(c, "avg"),
    "ZeroPadding2D": _map_zero_padding2d,
    "Cropping2D": _map_cropping2d,
    "UpSampling2D": _map_upsampling2d,
    "BatchNormalization": _map_batchnorm,
    "Embedding": _map_embedding,
    "LSTM": _map_lstm,
    "GRU": _map_gru,
    "SimpleRNN": _map_simple_rnn,
    "Bidirectional": _map_bidirectional,
    "Activation": _map_activation,
    "LeakyReLU": _map_leaky_relu,
    "LayerNormalization": _map_layernorm,
    "PReLU": _map_prelu,
    "ELU": _map_elu_layer,
    "Permute": _map_permute,
    "RepeatVector": _map_repeat_vector,
    "Dropout": _map_dropout,
    "SpatialDropout2D": _map_spatial_dropout,
    "Conv3D": _map_conv3d,
    "MaxPooling3D": lambda c: _map_pool3d(c, "max"),
    "AveragePooling3D": lambda c: _map_pool3d(c, "avg"),
    "UpSampling1D": _map_upsampling1d,
    "ZeroPadding1D": _map_zero_padding1d,
    "Cropping1D": _map_cropping1d,
    "Masking": _map_masking,
    "GaussianNoise": _map_gaussian_noise,
    "GaussianDropout": _map_gaussian_dropout,
    "AlphaDropout": _map_alpha_dropout,
    "Softmax": _map_softmax_layer,
    "ThresholdedReLU": _map_thresholded_relu,
    "ReLU": _map_relu_layer,
    "TimeDistributed": _map_time_distributed,
    "MultiHeadAttention": _map_multi_head_attention,
}


def _layer_config(entry: Dict) -> Tuple[str, Dict]:
    """(class_name, config) from one entry of model_config['config']['layers'];
    tolerates both Keras 2 and Keras 3 JSON shapes."""
    return entry["class_name"], entry["config"]


def _input_type_from_batch_shape(shape: List) -> InputType:
    dims = [d for d in shape[1:]]
    if len(dims) == 4:    # keras NDHWC -> our convolutional3D(d, h, w, c)
        return InputType.convolutional3D(dims[0], dims[1], dims[2], dims[3])
    if len(dims) == 3:    # keras NHWC -> our convolutional(h, w, c)
        return InputType.convolutional(dims[0], dims[1], dims[2])
    if len(dims) == 2:    # keras [T, C] -> our recurrent(C, T)
        # a free time dim is Keras's variable-length convention; ours
        # is -1 (the W161 import lint flags the recompile cost)
        return InputType.recurrent(dims[1],
                                   -1 if dims[0] is None else dims[0])
    if len(dims) == 1:
        return InputType.feedForward(dims[0])
    raise KerasImportError(f"unsupported input rank {len(dims) + 1}")


_ELEMENTWISE = {"Add": "Add", "Subtract": "Subtract", "Multiply": "Product",
                "Average": "Average", "Maximum": "Max"}


def _layer_refs(spec) -> List[str]:
    """Layer names from input_layers/output_layers; Keras 3 flattens a
    single ref to ["name", 0, 0], Keras 2 always nests [["name", 0, 0], ...]."""
    if not spec:
        return []
    if isinstance(spec[0], str):
        return [spec[0]]
    return [x[0] for x in spec]


def _inbound_names(entry: Dict) -> List[str]:
    """Producer layer names for one functional-config entry; handles both the
    Keras 3 keras_history dicts and the Keras 2 nested-list form."""
    found: List[str] = []

    def walk(o):
        if isinstance(o, dict):
            hist = o.get("config", {}).get("keras_history") \
                if o.get("class_name") == "__keras_tensor__" else None
            if hist:
                found.append(hist[0])
                return
            for v in o.values():
                walk(v)
        elif isinstance(o, (list, tuple)):
            if (len(o) >= 3 and isinstance(o[0], str)
                    and isinstance(o[1], int) and isinstance(o[2], int)):
                found.append(o[0])  # keras 2 [name, node_idx, tensor_idx, {}]
                return
            for v in o:
                walk(v)
    walk(entry.get("inbound_nodes", []))
    return found


class KerasModelImport:
    """ref: modelimport.keras.KerasModelImport."""

    @staticmethod
    def importKerasModelAndWeights(path: str, device=None):
        """Import any full-model h5 onto ``device`` (the card unless the
        caller names another): Sequential -> MultiLayerNetwork,
        Functional -> ComputationGraph (ref: KerasModelImport entry
        point)."""
        dev = resolve_device(device)
        archive = Hdf5Archive(path)
        try:
            cls = archive.model_config().get("class_name")
            if cls == "Sequential":
                return KerasModelImport._import_sequential(archive, dev)
            if cls in ("Functional", "Model"):
                return KerasModelImport._import_functional(archive, dev)
        finally:
            archive.close()
        raise KerasImportError(f"unsupported model class '{cls}'")

    @staticmethod
    def _import_functional(archive: Hdf5Archive, device) -> ComputationGraph:
        report = ValidationReport(subject="Keras import")
        cfg = archive.model_config()["config"]
        entries = cfg["layers"]
        in_names = _layer_refs(cfg["input_layers"])
        out_names = _layer_refs(cfg["output_layers"])

        g = NeuralNetConfiguration.Builder().graphBuilder()
        alias: Dict[str, str] = {}     # keras name -> our producing node
        input_types: Dict[str, InputType] = {}
        imported: List[_Imported] = []

        for entry in entries:
            cls, lcfg = _layer_config(entry)
            name = lcfg.get("name") or entry.get("name")
            inbound = [alias.get(n, n) for n in _inbound_names(entry)]
            if cls == "InputLayer":
                shape = lcfg.get("batch_shape") or lcfg.get("batch_input_shape")
                report.extend(_imp.lint_placeholder_shape(
                    shape, f"input '{name}'"))
                input_types[name] = _input_type_from_batch_shape(shape)
                alias[name] = name
                continue
            if cls in _SKIP:  # Flatten/Reshape: auto-preprocessor handles it
                alias[name] = inbound[0]
                continue
            if cls in _ELEMENTWISE:
                g.addVertex(name, ElementWiseVertex(_ELEMENTWISE[cls]), *inbound)
                alias[name] = name
                continue
            if cls == "Dot":
                axes = lcfg.get("axes", -1)
                ok = axes in (-1, 1) or (isinstance(axes, (list, tuple))
                                         and all(a in (-1, 1)
                                                 for a in axes))
                if not ok:
                    raise KerasImportError(
                        f"Dot axes {axes} unsupported (last-axis dot "
                        f"of 2D inputs only)")
                g.addVertex(name, DotProductVertex(
                    normalize=bool(lcfg.get("normalize", False))),
                    *inbound)
                alias[name] = name
                continue
            if cls == "Concatenate":
                axis = lcfg.get("axis", -1)
                if axis not in (-1, 1, 3):
                    raise KerasImportError(
                        f"Concatenate axis {axis} unsupported (channel "
                        f"axis only)")
                g.addVertex(name, MergeVertex(), *inbound)
                alias[name] = name
                continue
            if cls not in _MAPPERS:
                raise KerasImportError(f"unsupported Keras layer '{cls}'")
            if cls == "MultiHeadAttention":
                # self-attention only: query/value/(key) must be the
                # same producer — collapses to one graph input
                if len(set(inbound)) != 1:
                    raise KerasImportError(
                        "MultiHeadAttention imports in self-attention "
                        "form only (query is value)")
                inbound = inbound[:1]
            imp = _MAPPERS[cls](lcfg)
            g.addLayer(name, imp.layer, *inbound)
            alias[name] = name
            imported.append(imp)

        g.addInputs(*in_names)
        g.setInputTypes(*[input_types[n] for n in in_names])
        g.setOutputs(*[alias.get(n, n) for n in out_names])
        net = ComputationGraph(g.build())
        net.init(device="cpu")

        types = net.conf.types
        node_by_name = net.conf.node_by_name
        for imp in imported:
            kw = archive.layer_weights(imp.kname)
            if imp.fill is None:
                continue
            if not kw:
                raise KerasImportError(f"no weights for layer '{imp.kname}'")
            node = node_by_name[imp.kname]
            src = node.inputs[0]
            pre_it = types.get(src, input_types.get(src))
            for wname, arr in kw.items():
                report.extend(_imp.lint_narrowed_array(
                    arr, f"layer '{imp.kname}' weight '{wname}'"))
            params, state = imp.fill(kw, pre_it)
            _install(net, imp.kname, params, state, f"layer {imp.kname}")
        _to_device(net, device)
        net.import_report = report
        return net

    @staticmethod
    def importKerasSequentialModelAndWeights(path: str, device=None
                                             ) -> MultiLayerNetwork:
        """Import a Sequential full-model h5 onto ``device`` (the card
        unless the caller names another)."""
        dev = resolve_device(device)
        archive = Hdf5Archive(path)
        try:
            return KerasModelImport._import_sequential(archive, dev)
        finally:
            archive.close()

    @staticmethod
    def _import_sequential(archive: Hdf5Archive, device
                           ) -> MultiLayerNetwork:
        report = ValidationReport(subject="Keras import")
        cfg = archive.model_config()
        if cfg.get("class_name") != "Sequential":
            raise KerasImportError(
                f"not a Sequential model ({cfg.get('class_name')}); use "
                f"importKerasModelAndWeights for functional models")
        entries = cfg["config"]["layers"]

        input_type: Optional[InputType] = None
        imported: List[_Imported] = []
        for entry in entries:
            cls, lcfg = _layer_config(entry)
            if cls == "InputLayer":
                shape = lcfg.get("batch_shape") or lcfg.get("batch_input_shape")
                input_type = _input_type_from_batch_shape(shape)
                continue
            if cls in _SKIP:
                continue
            if cls not in _MAPPERS:
                raise KerasImportError(f"unsupported Keras layer '{cls}'")
            if input_type is None and (
                    "batch_shape" in lcfg or "batch_input_shape" in lcfg):
                shape = lcfg.get("batch_shape") or lcfg.get("batch_input_shape")
                input_type = _input_type_from_batch_shape(shape)
            imported.append(_MAPPERS[cls](lcfg))
        if input_type is None:
            raise KerasImportError("model config declares no input shape")
        shape = None
        for entry in entries:
            _c, lcfg = _layer_config(entry)
            shape = (lcfg.get("batch_shape")
                     or lcfg.get("batch_input_shape"))
            if shape is not None:
                break
        if shape is not None:
            report.extend(_imp.lint_placeholder_shape(shape, "input"))

        b = NeuralNetConfiguration.Builder().list()
        for imp in imported:
            b.layer(imp.layer)
        b.setInputType(input_type)
        net = MultiLayerNetwork(b.build())
        net.init(device="cpu")

        # pre-preprocessor input types (for flatten-order weight fixes)
        pre_types = _pre_preprocessor_types(net.conf, input_type)
        for i, imp in enumerate(imported):
            if imp.fill is None:
                continue
            kw = archive.layer_weights(imp.kname)
            if not kw:
                raise KerasImportError(f"no weights for layer '{imp.kname}'")
            for wname, arr in kw.items():
                report.extend(_imp.lint_narrowed_array(
                    arr, f"layer '{imp.kname}' weight '{wname}'"))
            params, state = imp.fill(kw, pre_types[i])
            _install(net, i, params, state, f"layer {i}")
        _to_device(net, device)
        net.import_report = report
        return net


def _pre_preprocessor_types(conf, input_type: InputType) -> List[InputType]:
    """InputType seen at each layer BEFORE any auto-inserted preprocessor
    (the conv-shaped type a Flatten consumed, for dense-kernel reordering)."""
    out = []
    cur = input_type
    for layer in conf.layers:
        out.append(cur)
        pre = pp.preprocessor_for(cur, layer)
        if pre is not None:
            cur = pre.output_type(cur)
        cur = layer.output_type(cur)
    return out


def _flat(d: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """A wrapper's nested ``{"fwd": {"W": ..}}`` as the port's flat
    ``{"fwd/W": ..}``."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _check_shapes(target: Dict, holder: Dict, where: str):
    """Every imported array against the initialized net's tensor of the
    same name (names the net lacks are left out, as in the JAX
    package)."""
    for k, v in holder.items():
        if k in target and tuple(target[k].shape) != tuple(v.shape):
            raise KerasImportError(
                f"{where} param {k}: shape {tuple(v.shape)} from h5 vs "
                f"expected {tuple(target[k].shape)}")


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype != np.float32:
        a = a.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _install(net, key, params: Dict, state, where: str) -> None:
    """Imported arrays over the initialized (CPU) net's, shapes checked."""
    params = _flat(params)
    target = net._params[key]
    _check_shapes(target, params, where)
    net._params[key] = {**target, **{k: _tensor(v) for k, v in
                                     params.items()}}
    if state:
        net._states[key] = {**net._states[key],
                            **{k: _tensor(v) for k, v in state.items()}}


def _to_device(net, device) -> None:
    """Every param and state to ``device`` once, params trainable."""
    net._device = device
    net._params = net._map(net._params, lambda t: t.detach().to(device)
                           .requires_grad_(True))
    net._states = net._map(net._states, lambda t: t.to(device))
    net._reset_training_state()


importKerasSequentialModelAndWeights = \
    KerasModelImport.importKerasSequentialModelAndWeights
importKerasModelAndWeights = KerasModelImport.importKerasModelAndWeights
