"""Activation functions: the surface of
``deeplearning4j_tpu/ops/activations.py`` and its ``Activation`` enum.

Derivatives are autograd's. ``relu`` has slope 0 at 0 and propagates
NaN, as ``jax.nn.relu`` does; ``leakyrelu`` takes the slope in the
input's dtype, as JAX does with a weakly typed Python scalar; ``gelu`` is
the tanh approximation (the reference's ActivationGELU, JAX's
``approximate=True``), not ``F.gelu``'s default erf form.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["get", "Activation", "ACTIVATIONS"]


def identity(x):
    return x


def relu(x):
    return torch.relu(x)


def relu6(x):
    return torch.clamp(torch.relu(x), max=6.0)


def leakyrelu(x, alpha: float = 0.01):
    return torch.where(x >= 0, x, torch.tensor(alpha, dtype=x.dtype) * x)


def elu(x, alpha: float = 1.0):
    return F.elu(x, alpha)


def selu(x):
    return F.selu(x)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def sigmoid(x):
    return torch.sigmoid(x)


def hardsigmoid(x):
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def hardtanh(x):
    return torch.clamp(x, -1.0, 1.0)


def tanh(x):
    return torch.tanh(x)


def rationaltanh(x):
    # ref: ActivationRationalTanh, 1.7159 * tanh(2x/3)
    return 1.7159 * torch.tanh(2.0 * x / 3.0)


def rectifiedtanh(x):
    return torch.clamp_min(torch.tanh(x), 0.0)


def swish(x):
    return x * torch.sigmoid(x)


def softmax(x, axis: int = -1):
    return torch.softmax(x, dim=axis)


def logsoftmax(x, axis: int = -1):
    return torch.log_softmax(x, dim=axis)


def softplus(x):
    return F.softplus(x)


def softsign(x):
    return x / (1.0 + torch.abs(x))


def mish(x):
    return x * torch.tanh(F.softplus(x))


def cube(x):
    return x * x * x


def thresholdedrelu(x, theta: float = 1.0):
    return torch.where(x > theta, x, torch.zeros((), dtype=x.dtype,
                                                  device=x.device))


def prelu(x, alpha):
    """Parametric ReLU: ``alpha`` a learned tensor broadcast against x."""
    return torch.where(x >= 0, x, alpha * x)


ACTIVATIONS = {
    "identity": identity,
    "linear": identity,
    "relu": relu,
    "relu6": relu6,
    "leakyrelu": leakyrelu,
    "elu": elu,
    "selu": selu,
    "gelu": gelu,
    "sigmoid": sigmoid,
    "hardsigmoid": hardsigmoid,
    "hardtanh": hardtanh,
    "tanh": tanh,
    "rationaltanh": rationaltanh,
    "rectifiedtanh": rectifiedtanh,
    "softmax": softmax,
    "logsoftmax": logsoftmax,
    "softplus": softplus,
    "softsign": softsign,
    "swish": swish,
    "mish": mish,
    "cube": cube,
    "thresholdedrelu": thresholdedrelu,
}


def get(name):
    """Resolve an activation by name (case-insensitive) or pass a
    callable through."""
    if callable(name):
        return name
    key = str(name).lower()
    if key not in ACTIVATIONS:
        raise ValueError(f"Unknown activation '{name}'. Known: "
                         f"{sorted(ACTIVATIONS)}")
    return ACTIVATIONS[key]


class Activation:
    """Enum-style names (ref: ``org.nd4j.linalg.activations.Activation``)."""

    IDENTITY = "identity"
    RELU = "relu"
    RELU6 = "relu6"
    LEAKYRELU = "leakyrelu"
    ELU = "elu"
    SELU = "selu"
    GELU = "gelu"
    SIGMOID = "sigmoid"
    HARDSIGMOID = "hardsigmoid"
    HARDTANH = "hardtanh"
    TANH = "tanh"
    RATIONALTANH = "rationaltanh"
    RECTIFIEDTANH = "rectifiedtanh"
    SOFTMAX = "softmax"
    LOGSOFTMAX = "logsoftmax"
    SOFTPLUS = "softplus"
    SOFTSIGN = "softsign"
    SWISH = "swish"
    MISH = "mish"
    CUBE = "cube"
    THRESHOLDEDRELU = "thresholdedrelu"
