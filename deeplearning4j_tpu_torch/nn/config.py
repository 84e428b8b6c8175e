"""Network configuration (the slice's subset of
``deeplearning4j_tpu/nn/config.py``): ``InputType`` and
``NeuralNetConfiguration.Builder`` with ``graphBuilder``."""

from __future__ import annotations

from deeplearning4j_tpu_torch.train.updaters import Sgd


class InputType:
    """Shape metadata propagated through layers (ref: conf.inputs.
    InputType). Kinds: ``ff`` (size,) and ``cnn`` (channels, height,
    width — NCHW like the reference)."""

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

    def __getattr__(self, item):
        try:
            return self.dims[item]
        except KeyError:
            raise AttributeError(item)

    def arrayElementsPerExample(self) -> int:
        if self.kind == "ff":
            return self.dims["size"]
        if self.kind == "cnn":
            return (self.dims["height"] * self.dims["width"]
                    * self.dims["channels"])
        raise ValueError(self.kind)

    def __repr__(self):
        return f"InputType({self.kind}, {self.dims})"


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
