"""Transforms — the static math-helper surface (the port of
``deeplearning4j_tpu/linalg/transforms.py``; ref: ``org.nd4j.linalg.ops.
transforms.Transforms``): the utility entry point user code calls for
out-of-place math over INDArrays. Every function accepts an NDArray or a
tensor and returns an NDArray on the same device.

The activations, ``softmax`` and ``logSoftmax`` resolve the op registry
at each call, so a platform override applies: an NDArray softmax on the
card launches the softmax kernel (``ops/csrc/softmax.cu``) inside its
gate.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.linalg.ndarray import NDArray
from deeplearning4j_tpu_torch.linalg.ndarray import _unwrap as _unwrap_nd


def _unwrap(x):
    x = _unwrap_nd(x)
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _wrap1(fn):
    def f(x, dup: bool = True):
        res = fn(_unwrap(x))
        if not dup:
            # reference semantics: dup=False mutates the input in place
            if not isinstance(x, NDArray):
                raise TypeError("dup=False needs an NDArray input to mutate")
            return x._set_value(res)
        return NDArray(res)
    return f


def _registry():
    from deeplearning4j_tpu_torch.ops import registry as _r
    return _r


def _wrap_op(name):
    """Delegate through the registry so platform (CUDA) overrides apply
    and the activation surface keeps ONE source of truth."""
    return _wrap1(lambda v: _registry().get(name)(v))


sigmoid = _wrap_op("sigmoid")
tanh = _wrap_op("tanh")
relu = _wrap_op("relu")
relu6 = _wrap_op("relu6")
elu = _wrap_op("elu")
selu = _wrap_op("selu")
gelu = _wrap_op("gelu")
softPlus = _wrap_op("softplus")
softsign = _wrap_op("softsign")
sign = _wrap1(torch.sign)
abs = _wrap1(torch.abs)          # noqa: A001 (reference name)
exp = _wrap1(torch.exp)
expm1 = _wrap1(torch.expm1)
log = _wrap1(torch.log)
log1p = _wrap1(torch.log1p)
sqrt = _wrap1(torch.sqrt)
sin = _wrap1(torch.sin)
cos = _wrap1(torch.cos)
atan = _wrap1(torch.atan)
asin = _wrap1(torch.asin)
acos = _wrap1(torch.acos)
floor = _wrap1(torch.floor)
ceil = _wrap1(torch.ceil)
round = _wrap1(torch.round)      # noqa: A001
neg = _wrap1(torch.neg)
hardTanh = _wrap_op("hardtanh")
hardSigmoid = _wrap_op("hardsigmoid")
identity = _wrap1(lambda x: x)
stabilize = _wrap1(lambda x: torch.clamp(x, -1e6, 1e6))


def leakyRelu(x, alpha: float = 0.01):
    v = _unwrap(x)
    return NDArray(torch.where(v >= 0, v, alpha * v))


def softmax(x, axis: int = -1):
    return NDArray(_registry().get("softmax")(_unwrap(x), axis=axis))


def logSoftmax(x, axis: int = -1):
    return NDArray(_registry().get("log_softmax")(_unwrap(x), axis=axis))


def _pair(x, y):
    a = _unwrap(x)
    b = _unwrap_nd(y)
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(b, device=a.device) \
            if not isinstance(b, (int, float)) else b
    return a, b


def pow(x, p):                  # noqa: A001
    a, b = _pair(x, p)
    return NDArray(torch.pow(a, b))


def max(x, y):                  # noqa: A001
    a, b = _pair(x, y)
    return NDArray(torch.maximum(a, torch.as_tensor(b, dtype=a.dtype,
                                                    device=a.device)))


def min(x, y):                  # noqa: A001
    a, b = _pair(x, y)
    return NDArray(torch.minimum(a, torch.as_tensor(b, dtype=a.dtype,
                                                    device=a.device)))


def _norm(v, dim=None, keepdim=False):
    return torch.linalg.vector_norm(v, dim=dim, keepdim=keepdim)


def unitVec(x):
    v = _unwrap(x)
    return NDArray(v / torch.clamp_min(_norm(v), 1e-12))


def normalizeZeroMeanAndUnitVariance(x):
    v = _unwrap(x)
    return NDArray((v - torch.mean(v)) / torch.clamp_min(
        torch.std(v, correction=0), 1e-12))


def _flat2(a, b):
    va = _unwrap(a).reshape(-1)
    vb = _unwrap(b).to(va.device).reshape(-1)
    return va, vb


def cosineSim(a, b) -> float:
    va, vb = _flat2(a, b)
    return float(torch.dot(va, vb)
                 / torch.clamp_min(_norm(va) * _norm(vb), 1e-12))


def cosineDistance(a, b) -> float:
    return 1.0 - cosineSim(a, b)


def euclideanDistance(a, b) -> float:
    va, vb = _flat2(a, b)
    return float(_norm((va - vb).float()))


def manhattanDistance(a, b) -> float:
    va, vb = _flat2(a, b)
    return float(torch.sum(torch.abs(va - vb)))


def hammingDistance(a, b) -> float:
    va, vb = _flat2(a, b)
    return float(torch.sum(va != vb))


def jaccardDistance(a, b) -> float:
    va, vb = _flat2(a, b)
    mx = torch.sum(torch.maximum(va, vb))
    mn = torch.sum(torch.minimum(va, vb))
    return float(torch.where(mx == 0, torch.zeros_like(mx),
                             1.0 - mn / torch.clamp_min(mx, 1e-12)))


def allEuclideanDistances(x, y, dim: int = 1):
    """Pairwise distances between rows/cols of x and y (ref:
    Transforms.allEuclideanDistances)."""
    vx, vy = _unwrap(x), _unwrap(y)
    if dim == 0:
        vx, vy = vx.T, vy.T
    d = vx[:, None, :] - vy[None, :, :]
    return NDArray(torch.sqrt(torch.sum(d * d, dim=-1)))


def allCosineSimilarities(x, y, dim: int = 1):
    vx, vy = _unwrap(x), _unwrap(y)
    if dim == 0:
        vx, vy = vx.T, vy.T
    nx = vx / torch.clamp_min(_norm(vx, dim=1, keepdim=True), 1e-12)
    ny = vy / torch.clamp_min(_norm(vy, dim=1, keepdim=True), 1e-12)
    return NDArray(nx @ ny.T)


def dot(a, b) -> float:
    va, vb = _flat2(a, b)
    return float(torch.sum(va * vb))


class Transforms:
    """Class-style access (``Transforms.sigmoid(x)``) for reference-shaped
    call sites; the module-level functions are the same objects."""


for _name, _obj in list(globals().items()):
    if callable(_obj) and not _name.startswith("_") and \
            _name not in ("NDArray", "Transforms"):
        setattr(Transforms, _name, staticmethod(_obj))
