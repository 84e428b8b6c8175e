"""Activation functions (the slice's subset of
``deeplearning4j_tpu/ops/activations.py``).

Derivatives are autograd's. ``relu`` has slope 0 at 0 and propagates
NaN, as ``jax.nn.relu`` does; ``leakyrelu`` takes the slope in the
input's dtype, as JAX does with a weakly typed Python scalar; ``gelu`` is
the tanh approximation (the reference's ActivationGELU, JAX's
``approximate=True``), not ``F.gelu``'s default erf form.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["get", "ACTIVATIONS"]


def identity(x):
    return x


def relu(x):
    return torch.relu(x)


def leakyrelu(x, alpha: float = 0.01):
    return torch.where(x >= 0, x, torch.tensor(alpha, dtype=x.dtype) * x)


def gelu(x):
    return F.gelu(x, approximate="tanh")


def sigmoid(x):
    return torch.sigmoid(x)


def tanh(x):
    return torch.tanh(x)


def swish(x):
    return x * torch.sigmoid(x)


def softmax(x, axis: int = -1):
    return torch.softmax(x, dim=axis)


def logsoftmax(x, axis: int = -1):
    return torch.log_softmax(x, dim=axis)


ACTIVATIONS = {
    "identity": identity,
    "linear": identity,
    "relu": relu,
    "leakyrelu": leakyrelu,
    "gelu": gelu,
    "sigmoid": sigmoid,
    "tanh": tanh,
    "swish": swish,
    "softmax": softmax,
    "logsoftmax": logsoftmax,
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
