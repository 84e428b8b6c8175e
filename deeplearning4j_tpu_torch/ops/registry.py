"""Op registry — name -> callable dispatch with platform overrides.

The port's counterpart of ``deeplearning4j_tpu/ops/registry.py``: the
``register`` / ``register_platform_override`` / ``get`` / ``exec_op``
hooks and the ops a SameDiff graph records (``autodiff.samediff``),
under the JAX package's names and semantics. A platform override
shadows the generic op at dispatch time, the way libnd4j's
PlatformHelpers shadow its declarable ops: here the CUDA kernels of
:mod:`.cuda_kernels` shadow ``layer_norm``, ``scale_shift_act``,
``flash_attention`` and ``softmax``.

Semantics kept from ``jax.numpy``: ``transpose`` with no ``perm``
reverses the axes; reductions take ``axis`` None (all), an int or a
sequence; integer and bool sums are int32 (jnp's without x64), ``argmax``
gives int32 and ``reduce_mean`` of integers is fp32; ``cast`` takes a
dtype name.
The generic ``softmax`` is ``jax.nn.softmax``'s formula with the max and
the sum in fp32.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import activations as _act
from deeplearning4j_tpu_torch.ops import attention as _attn
from deeplearning4j_tpu_torch.ops import losses as _loss
from deeplearning4j_tpu_torch.ops import normalization as _norm

_REGISTRY: Dict[str, Callable] = {}
_PLATFORM_OVERRIDES: Dict[str, Callable] = {}


def register(name: str, fn: Callable = None):
    """Register an op (decorator or direct)."""
    if fn is None:
        def deco(f):
            _REGISTRY[name] = f
            return f
        return deco
    _REGISTRY[name] = fn
    return fn


def register_platform_override(name: str, fn: Callable) -> None:
    """Shadow a generic op with a platform-specific (CUDA kernel) impl."""
    if name not in _REGISTRY:
        raise KeyError(f"cannot override unknown op '{name}'")
    _PLATFORM_OVERRIDES[name] = fn


def clear_platform_override(name: str) -> None:
    _PLATFORM_OVERRIDES.pop(name, None)


def get(name: str) -> Callable:
    """Resolve an op by name, honouring platform overrides."""
    if name in _PLATFORM_OVERRIDES:
        return _PLATFORM_OVERRIDES[name]
    if name not in _REGISTRY:
        raise KeyError(f"Unknown op '{name}' ({len(_REGISTRY)} registered)")
    return _REGISTRY[name]


def has(name: str) -> bool:
    return name in _REGISTRY


def exec_op(name: str, *args, **kwargs):
    """Eager single-op execution (ref: ``Nd4j.exec(DynamicCustomOp)``),
    through the override if one is installed. The JAX package's
    profiling modes are not ported."""
    return get(name)(*args, **kwargs)


# ------------------------------------------------------------ torch dtypes
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) and dtype in _DTYPES \
        else np.dtype(dtype).name
    if name not in _DTYPES:
        raise TypeError(f"no torch dtype for {dtype!r}")
    return _DTYPES[name]


def dtype_name(dtype) -> str:
    """The numpy name of a torch or numpy dtype (what ``save`` writes)."""
    if isinstance(dtype, torch.dtype):
        for name, dt in _DTYPES.items():
            if dt == dtype:
                return name
        raise TypeError(f"no dtype name for {dtype}")
    return np.dtype(dtype).name


# ------------------------------------------------------ elementwise, binary
for _n, _f in {"abs": torch.abs, "neg": torch.neg, "exp": torch.exp,
               "log": torch.log, "sqrt": torch.sqrt,
               "square": torch.square, "identity": _act.identity}.items():
    register(_n, _f)
for _n, _f in _act.ACTIVATIONS.items():
    register(_n, _f)
for _n, _f in {"add": torch.add, "subtract": torch.sub,
               "multiply": torch.mul, "divide": torch.true_divide,
               "pow": torch.pow, "maximum": torch.maximum,
               "minimum": torch.minimum, "greater": torch.gt,
               "greater_equal": torch.ge, "less": torch.lt,
               "less_equal": torch.le, "equals": torch.eq,
               "not_equals": torch.ne}.items():
    register(_n, _f)


# -------------------------------------------------------------- reductions
def _dims(x, axis):
    if axis is None:
        return tuple(range(x.dim()))
    return (axis,) if isinstance(axis, int) else tuple(int(a) for a in axis)


def _reduce_sum(x, axis=None, keepdims=False):
    dt = None if x.is_floating_point() or x.is_complex() else torch.int32
    return torch.sum(x, dim=_dims(x, axis), keepdim=keepdims, dtype=dt)


def _reduce_mean(x, axis=None, keepdims=False):
    x = x if x.is_floating_point() else x.float()
    return torch.mean(x, dim=_dims(x, axis), keepdim=keepdims)


register("reduce_sum", _reduce_sum)
register("reduce_mean", _reduce_mean)
register("reduce_max", lambda x, axis=None, keepdims=False:
         torch.amax(x, dim=_dims(x, axis), keepdim=keepdims))
register("reduce_min", lambda x, axis=None, keepdims=False:
         torch.amin(x, dim=_dims(x, axis), keepdim=keepdims))
register("reduce_norm2", lambda x, axis=None, keepdims=False:
         torch.sqrt(torch.sum(x * x, dim=_dims(x, axis), keepdim=keepdims)))
register("argmax", lambda x, axis=None:
         torch.argmax(x, dim=axis).to(torch.int32))


# --------------------------------------------------------- shape, gather
def _transpose(x, perm=None):
    return x.permute(*(tuple(perm) if perm is not None
                       else range(x.dim() - 1, -1, -1)))


def _gather(x, idx, axis=0):
    """``jnp.take(x, idx, axis)``: the output's ``axis`` is replaced by
    idx's shape."""
    axis = axis % x.dim()
    idx = torch.as_tensor(idx, device=x.device)
    rows = torch.index_select(x, axis, idx.reshape(-1))
    return rows.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


register("reshape", lambda x, shape: torch.reshape(x, tuple(shape)))
register("transpose", _transpose)
register("permute", lambda x, perm: x.permute(*perm))
register("gather", _gather)
register("cast", lambda x, dtype: x.to(torch_dtype(dtype)))


# ------------------------------------------------------------------ linalg
def _matmul(a, b, transpose_a=False, transpose_b=False):
    return torch.matmul(a.transpose(-1, -2) if transpose_a else a,
                        b.transpose(-1, -2) if transpose_b else b)


def _xw_plus_b(x, w, b):
    if x.dim() == 2 and w.dim() == 2 and b.dim() == 1:
        return torch.addmm(b, x, w)       # one cuBLAS call with the bias
    return torch.matmul(x, w) + b


register("matmul", _matmul)
register("mmul", lambda *a, **k: get("matmul")(*a, **k))


# --------------------------------------------------------------- nn ops
def softmax(x, axis: int = -1):
    """The generic softmax: ``jax.nn.softmax``'s formula (max
    subtracted, exp, divided by the sum) with the max and the sum in
    fp32, cast back to x's dtype."""
    x32 = x.float()
    e = torch.exp(x32 - x32.amax(dim=axis, keepdim=True))
    return (e / e.sum(dim=axis, keepdim=True)).to(x.dtype)


register("layer_norm", _norm.layer_norm)
register("rms_norm", _norm.rms_norm)
register("scale_shift_act", _norm.scale_shift_act)
register("flash_attention", _attn.flash_attention)
register("multi_head_dot_product_attention", _attn.multi_head_attention)
# the JAX registry's argument order: (key, x, rate)
register("alpha_dropout", lambda key, x, rate: _norm.alpha_dropout(
    x, rate, key))
register("gaussian_dropout", lambda key, x, rate: _norm.gaussian_dropout(
    x, rate, key))
register("gaussian_noise", lambda key, x, stddev: _norm.gaussian_noise(
    x, stddev, key))
register("softmax", softmax)
register("log_softmax", lambda x, axis=-1: torch.log_softmax(x, dim=axis))
register("relu_layer", lambda x, w, b: torch.relu(_xw_plus_b(x, w, b)))
register("xw_plus_b", _xw_plus_b)
register("bias_add", lambda x, b: x + b)

# losses (ref: generic/loss)
register("softmax_cross_entropy_loss", _loss.softmax_cross_entropy_logits)
register("sparse_softmax_cross_entropy_loss", _loss.sparse_mcxent)
