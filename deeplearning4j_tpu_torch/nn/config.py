"""Network configuration (the slice's subset of
``deeplearning4j_tpu/nn/config.py``): ``InputType``,
``NeuralNetConfiguration.Builder`` with ``graphBuilder`` and ``list``,
``ListBuilder`` (with ``backpropType``/``tBPTTLength``) and
``MultiLayerConfiguration``.

``MultiLayerConfiguration.to_json``/``from_json`` write and read the JAX
package's JSON (each layer's attributes under its class name), so a
sequential configuration crosses between the packages as long as every
layer class in it is ported. Input preprocessors (``nn.preprocessors``)
are inserted while input types propagate, as in the JAX package, and are
derived again from the input types when a configuration is read from
JSON.
"""

from __future__ import annotations

import json
from typing import Any, List, Optional

from deeplearning4j_tpu_torch.train.updaters import IUpdater, Sgd


class InputType:
    """Shape metadata propagated through layers (ref: conf.inputs.
    InputType). Kinds: ``ff`` (size,), ``cnn`` (channels, height, width —
    NCHW like the reference), ``cnn_flat`` (flattened image rows),
    ``rnn`` (size, timesteps) and ``cnn3d``."""

    def __init__(self, kind: str, **dims):
        self.kind = kind
        self.dims = dims

    @staticmethod
    def feedForward(size: int) -> "InputType":
        return InputType("ff", size=int(size))

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType("cnn", height=int(height), width=int(width),
                         channels=int(channels))

    @staticmethod
    def convolutionalFlat(height: int, width: int, depth: int) -> "InputType":
        return InputType("cnn_flat", height=int(height), width=int(width),
                         channels=int(depth))

    @staticmethod
    def recurrent(size: int, timeseries_length: int = -1) -> "InputType":
        return InputType("rnn", size=int(size),
                         timesteps=int(timeseries_length))

    @staticmethod
    def convolutional3D(depth: int, height: int, width: int,
                        channels: int) -> "InputType":
        return InputType("cnn3d", depth=int(depth), height=int(height),
                         width=int(width), channels=int(channels))

    def __getattr__(self, item):
        try:
            return self.dims[item]
        except KeyError:
            raise AttributeError(item)

    def arrayElementsPerExample(self) -> int:
        if self.kind == "ff":
            return self.dims["size"]
        if self.kind in ("cnn", "cnn_flat"):
            return (self.dims["height"] * self.dims["width"]
                    * self.dims["channels"])
        if self.kind == "cnn3d":
            return (self.dims["depth"] * self.dims["height"]
                    * self.dims["width"] * self.dims["channels"])
        if self.kind == "rnn":
            return self.dims["size"] * max(self.dims["timesteps"], 1)
        raise ValueError(self.kind)

    def to_config(self):
        return {"kind": self.kind, **self.dims}

    @staticmethod
    def from_config(d):
        d = dict(d)
        return InputType(d.pop("kind"), **d)

    def __repr__(self):
        return f"InputType({self.kind}, {self.dims})"

    def __eq__(self, other):
        return isinstance(other, InputType) and self.kind == other.kind \
            and self.dims == other.dims


class NeuralNetConfiguration:
    """Global training defaults (ref: NeuralNetConfiguration)."""

    class Builder:
        def __init__(self):
            self._seed = 12345
            self._updater = None
            self._weight_init = "xavier"
            self._activation = "identity"
            self._l1 = 0.0
            self._l2 = 0.0
            self._grad_norm = None   # None | 'clip_value' | 'clip_l2' | 'clip_global' | 'renorm'
            self._grad_norm_threshold = 1.0
            self._dtype = "float32"
            self._compute_layout = "NCHW"

        def seed(self, s):
            self._seed = int(s)
            return self

        def updater(self, u):
            self._updater = u
            return self

        def weightInit(self, w):
            self._weight_init = w
            return self

        def activation(self, a):
            self._activation = a
            return self

        def l1(self, v):
            self._l1 = float(v)
            return self

        def l2(self, v):
            self._l2 = float(v)
            return self

        def dataType(self, dt):
            self._dtype = str(dt)
            return self

        def computeLayout(self, fmt: str):
            """Compute layout for spatial layers: "NHWC" runs conv/pool/BN
            channels-minor while the public NCHW API is unchanged."""
            fmt = str(fmt).upper()
            if fmt not in ("NCHW", "NHWC"):
                raise ValueError(f"computeLayout must be 'NCHW' or "
                                 f"'NHWC', got {fmt!r}")
            self._compute_layout = fmt
            return self

        def gradientNormalization(self, kind, threshold: float = 1.0):
            self._grad_norm = kind
            self._grad_norm_threshold = float(threshold)
            return self

        def list(self) -> "ListBuilder":
            return ListBuilder(self._freeze())

        def graphBuilder(self):
            from deeplearning4j_tpu_torch.nn.graph import GraphBuilder
            return GraphBuilder(self._freeze())

        def _freeze(self) -> "NeuralNetConfiguration":
            cfg = NeuralNetConfiguration()
            cfg.seed = self._seed
            cfg.updater = self._updater or Sgd(0.1)
            cfg.weight_init = self._weight_init
            cfg.activation = self._activation
            cfg.l1 = self._l1
            cfg.l2 = self._l2
            cfg.grad_norm = self._grad_norm
            cfg.grad_norm_threshold = self._grad_norm_threshold
            cfg.dtype = self._dtype
            cfg.compute_layout = self._compute_layout
            return cfg

    def __init__(self):
        self.seed = 12345
        self.updater = Sgd(0.1)
        self.weight_init = "xavier"
        self.activation = "identity"
        self.l1 = 0.0
        self.l2 = 0.0
        self.grad_norm = None
        self.grad_norm_threshold = 1.0
        self.dtype = "float32"
        self.compute_layout = "NCHW"

    def to_config(self):
        return {"seed": self.seed, "updater": self.updater.to_config(),
                "weight_init": self.weight_init, "activation": self.activation,
                "l1": self.l1, "l2": self.l2, "grad_norm": self.grad_norm,
                "grad_norm_threshold": self.grad_norm_threshold,
                "dtype": self.dtype, "compute_layout": self.compute_layout}

    @staticmethod
    def from_config(d):
        cfg = NeuralNetConfiguration()
        cfg.__dict__.update({k: v for k, v in d.items() if k != "updater"})
        cfg.updater = IUpdater.from_config(d["updater"])
        return cfg


class ListBuilder:
    """Sequential-network builder (ref: NeuralNetConfiguration.ListBuilder),
    with the truncated-BPTT declaration."""

    def __init__(self, base: NeuralNetConfiguration):
        self.base = base
        self.layers: List[Any] = []
        self.input_type: Optional[InputType] = None
        self.backprop_type: str = "standard"
        self.tbptt_length: Optional[int] = None

    def layer(self, *args):
        """.layer(conf) or .layer(idx, conf)"""
        self.layers.append(args[-1])
        return self

    def setInputType(self, it: InputType):
        self.input_type = it
        return self

    def inputType(self, it: InputType):
        return self.setInputType(it)

    def backpropType(self, kind: str, tbpttLength: int = None):
        """ref: ListBuilder.backpropType(BackpropType.TruncatedBPTT):
        ``fit()`` then splits each sequence batch into ``tBPTTLength``
        windows, as ``fitTBPTT(ds, length)`` does."""
        self.backprop_type = str(kind).lower()
        if tbpttLength is not None:
            self.tbptt_length = int(tbpttLength)
        return self

    def tBPTTLength(self, n: int):
        self.tbptt_length = int(n)
        return self

    def tBPTTForwardLength(self, n: int):
        return self.tBPTTLength(n)

    def tBPTTBackwardLength(self, n: int):
        return self.tBPTTLength(n)

    def build(self) -> "MultiLayerConfiguration":
        mlc = MultiLayerConfiguration(self.base, list(self.layers),
                                      self.input_type)
        mlc.backprop_type = self.backprop_type
        mlc.tbptt_length = self.tbptt_length
        return mlc


class MultiLayerConfiguration:
    """ref: org.deeplearning4j.nn.conf.MultiLayerConfiguration — the built
    model spec with propagated InputTypes: each layer takes the base
    config's defaults and infers its ``nIn`` from the type flowing in."""

    def __init__(self, base: NeuralNetConfiguration, layers: List[Any],
                 input_type: Optional[InputType]):
        self.base = base
        self.layers = layers
        self.input_type = input_type
        self.backprop_type: str = "standard"
        self.tbptt_length: Optional[int] = None
        #: layer index -> the input preprocessor that runs before it
        self.preprocessors = {}
        self.layer_input_types: List[InputType] = []
        if input_type is not None:
            self._propagate_input_types()

    def validate(self, batch_size: int = None, data_devices: int = None,
                 **kw):
        """Static lint of this configuration — shape/dtype propagation,
        structural diagnostics, and Hopper layout lints; returns a
        ``deeplearning4j_tpu_torch.analysis.ValidationReport`` (no tensor
        is made). Extra keywords pass through to ``analysis.analyze``:
        ``mesh=`` (enables the E1xx/W10x distribution lints),
        ``sharding=``, ``pipeline=``, ``hbm_gb=``, ``policy=``,
        ``data_range=``, ``cost=``, ``suppress=[codes]``,
        ``severity_overrides={code: severity}``."""
        from deeplearning4j_tpu_torch.analysis import analyze
        return analyze(self, batch_size=batch_size,
                       data_devices=data_devices, **kw)

    def _propagate_input_types(self):
        """InputType propagation with automatic preprocessor insertion
        (ref: MultiLayerConfiguration.Builder.setInputType)."""
        from deeplearning4j_tpu_torch.nn import preprocessors as pp
        cur = self.input_type
        self.preprocessors = {}
        self.layer_input_types = []
        for i, layer in enumerate(self.layers):
            pre = pp.preprocessor_for(cur, layer)
            if pre is not None:
                self.preprocessors[i] = pre
                cur = pre.output_type(cur)
            layer.set_defaults(self.base)
            layer.infer_nin(cur)
            self.layer_input_types.append(cur)
            cur = layer.output_type(cur)

    def to_json(self) -> str:
        return json.dumps({
            "base": self.base.to_config(),
            "layers": [layer.to_config() for layer in self.layers],
            "input_type": self.input_type.to_config()
            if self.input_type else None,
            "backprop_type": self.backprop_type,
            "tbptt_length": self.tbptt_length,
        })

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        from deeplearning4j_tpu_torch.nn import layers as L
        d = json.loads(s)
        base = NeuralNetConfiguration.from_config(d["base"])
        layers = [L.layer_from_config(lc) for lc in d["layers"]]
        it = InputType.from_config(d["input_type"]) \
            if d["input_type"] else None
        mlc = MultiLayerConfiguration(base, layers, it)
        mlc.backprop_type = d.get("backprop_type", "standard")
        mlc.tbptt_length = d.get("tbptt_length")
        return mlc
