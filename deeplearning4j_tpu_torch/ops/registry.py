"""Op registry — the declarable-op surface (the port of
``deeplearning4j_tpu/ops/registry.py`` with its two extensions,
:mod:`.registry_ext` and :mod:`.registry_r5`, imported at the bottom).

Reference parity: libnd4j's ``OpRegistrator`` over ~500 ``DeclarableOp``s
and the JVM mirror classes in ``org.nd4j.linalg.api.ops``. 505 ops under
the JAX package's names and semantics, every one a function of torch
tensors that runs on the device of its inputs (ops that make a tensor
from nothing take ``device=``, ``cuda`` unless the caller names another;
the random ops draw from the ``torch.Generator`` they are given, on its
device).

The registry serves three purposes:
1. name → callable dispatch for the graph engine (``autodiff.samediff``)
   and for eager :func:`exec_op` calls (the ``Nd4j.exec(DynamicCustomOp)``
   seam);
2. an auditable inventory of the op surface (:func:`all_ops`, checked
   against the JAX package's by the OpValidation coverage gate);
3. a ``PlatformHelper``-style override hook: a platform override shadows
   the generic op at dispatch time, the way libnd4j's PlatformHelpers
   shadow its declarable ops. The CUDA kernels of :mod:`.cuda_kernels`
   (``install_platform_overrides``) shadow ``layer_norm`` (also the
   forward of ``layer_norm_bp``), ``scale_shift_act``, ``flash_attention``
   and ``softmax`` (also ``linalg.Transforms.softmax``); a call outside a
   kernel's gate takes the generic op.

Semantics kept from ``jax.numpy`` without x64: ``transpose`` with no
``perm`` reverses the axes; reductions take ``axis`` None (all), an int
or a sequence; integer and bool sums, ``argmax``, ``count_nonzero``,
``bincount`` and ``arange`` of ints are int32, and a cast to a 64-bit type
gives its 32-bit one; ``reduce_mean`` of integers is fp32; sorts and
``top_k`` are stable (ties keep index order); ``round`` is half to even.
The generic ``softmax`` is ``jax.nn.softmax``'s formula with the max and
the sum in fp32. What the JAX package leaves to XLA is stock torch ops
here; decompositions go through ``torch.linalg``. No op copies its
operands to the host: ops whose output size depends on the data
(``unique``, ``where`` with one argument, ``boolean_mask``, ``listdiff``,
``dynamic_stitch``, segment ops without ``num_segments``) read that size
back, as the eager JAX ops do, and leave their results on the device.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.linalg.dtypes import canonical
from deeplearning4j_tpu_torch.ops import activations as _act
from deeplearning4j_tpu_torch.ops import attention as _attn
from deeplearning4j_tpu_torch.ops import convolution as _conv
from deeplearning4j_tpu_torch.ops import losses as _loss
from deeplearning4j_tpu_torch.ops import normalization as _norm
from deeplearning4j_tpu_torch.ops import recurrent as _rnn
from deeplearning4j_tpu_torch.profiler.modes import (ProfilingMode,
                                                     get_profiling_mode)
from deeplearning4j_tpu_torch.profiler.tracer import (get_tracer,
                                                      tracing_enabled)

_REGISTRY: Dict[str, Callable] = {}
_PLATFORM_OVERRIDES: Dict[str, Callable] = {}

# the segment and scatter max/min/prod ops stand on index_reduce, which
# warns once per process that its API is beta
warnings.filterwarnings("ignore", message=r"index_reduce\(\) is in beta")


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


def generic(name: str) -> Callable:
    """The generic op, platform overrides ignored (the shape functions run
    it on meta tensors)."""
    if name not in _REGISTRY:
        raise KeyError(f"Unknown op '{name}' ({len(_REGISTRY)} registered)")
    return _REGISTRY[name]


def has(name: str) -> bool:
    return name in _REGISTRY


def all_ops():
    return sorted(_REGISTRY)


def exec_op(name: str, *args, **kwargs):
    """Eager single-op execution (ref: ``Nd4j.exec(DynamicCustomOp)`` →
    OpExecutioner → execCustomOp2), through the override if one is
    installed.

    Dispatch is profiled per :class:`profiler.ProfilingMode` (ref:
    OpExecutioner.ProfilingMode): BASIC counts each dispatch in
    ``dl4j_op_dispatch_total{op=}`` and times it on the host clock in
    ``dl4j_op_dispatch_seconds{op=}`` (on the card: the enqueue time, not
    the device time); tracing on adds an ``op:<name>`` span;
    NAN_PANIC/INF_PANIC also read every floating output back and raise
    :class:`~deeplearning4j_tpu_torch.utils.environment.NumericsPanicError`
    naming the op on a NaN/Inf. OFF with tracing off is one enum read and
    one flag read over the bare call."""
    fn = get(name)
    mode = get_profiling_mode()
    if mode is ProfilingMode.OFF and not tracing_enabled():
        return fn(*args, **kwargs)
    return _exec_instrumented(name, fn, mode, args, kwargs)


def _op_dispatch_metrics():
    from deeplearning4j_tpu_torch.profiler.metrics import get_registry
    reg = get_registry()
    return (reg.counter("dl4j_op_dispatch_total",
                        "Eager op dispatches through the registry",
                        labelnames=("op",)),
            reg.histogram("dl4j_op_dispatch_seconds",
                          "Host-side dispatch latency per eager op "
                          "(async backends: enqueue time, not device time)",
                          labelnames=("op",)))


def _exec_instrumented(name, fn, mode, args, kwargs):
    tracer = get_tracer() if tracing_enabled() else None
    token = tracer.begin(f"op:{name}") if tracer is not None else None
    t0 = time.perf_counter()
    try:
        out = fn(*args, **kwargs)
    finally:
        dt = time.perf_counter() - t0
        if token is not None:
            tracer.end(token)
    if mode is not ProfilingMode.OFF:
        counts, lat = _op_dispatch_metrics()
        counts.labels(op=name).inc()
        lat.labels(op=name).observe(dt)
    if mode in (ProfilingMode.NAN_PANIC, ProfilingMode.INF_PANIC):
        _panic_scan(name, out, mode)
    return out


def tensor_leaves(out):
    """The tensors of an op's output: nested tuples, lists and dicts, and
    the arrays of a ``TensorList``."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    elif hasattr(out, "arrays") and isinstance(out.arrays, list):
        out = out.arrays
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in tensor_leaves(o)]
    return []


def _panic_scan(name, out, mode):
    """Numerics gate on op outputs (ref: OpExecutioner NAN_PANIC/INF_PANIC).
    Reads each floating output on the host — debug-mode semantics, off by
    default."""
    from deeplearning4j_tpu_torch.utils.environment import NumericsPanicError
    for leaf in tensor_leaves(out):
        if not (leaf.is_floating_point() or leaf.is_complex()):
            continue
        if mode is ProfilingMode.NAN_PANIC and bool(torch.isnan(leaf).any()):
            raise NumericsPanicError(
                f"NAN_PANIC: NaN detected in output of op '{name}'")
        if mode is ProfilingMode.INF_PANIC and bool(torch.isinf(leaf).any()):
            raise NumericsPanicError(
                f"INF_PANIC: Inf detected in output of op '{name}'")


# ------------------------------------------------------------ torch dtypes
_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "float16": torch.float16, "bfloat16": torch.bfloat16,
           "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
           "int64": torch.int64, "uint8": torch.uint8, "uint16": torch.uint16,
           "uint32": torch.uint32, "uint64": torch.uint64, "bool": torch.bool}


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) and dtype in _DTYPES \
        else np.dtype(dtype).name
    if name not in _DTYPES:
        raise TypeError(f"no torch dtype for {dtype!r}")
    return _DTYPES[name]


def canonical_dtype(dtype) -> torch.dtype:
    """The dtype the JAX package gives an array asked for as ``dtype``
    (x64 off: a 64-bit type narrows to its 32-bit one)."""
    return canonical(torch_dtype(dtype))


def dtype_name(dtype) -> str:
    """The numpy name of a torch or numpy dtype (what ``save`` writes)."""
    if isinstance(dtype, torch.dtype):
        for name, dt in _DTYPES.items():
            if dt == dtype:
                return name
        raise TypeError(f"no dtype name for {dtype}")
    return np.dtype(dtype).name


# ------------------------------------------------------------ shared helpers
def _t(x, like=None) -> torch.Tensor:
    """``x`` as a tensor (host data on ``like``'s device, with the JAX
    package's dtypes)."""
    if isinstance(x, torch.Tensor):
        return x
    dev = like.device if isinstance(like, torch.Tensor) else None
    if isinstance(x, (bool, int, float)):
        return torch.tensor(x, device=dev, dtype=torch.float32
                            if isinstance(x, float) else None)
    t = torch.as_tensor(np.asarray(x), device=dev)
    return t.to(canonical(t.dtype))


def _axes(axis):
    if axis is None:
        return None
    if isinstance(axis, int):
        return (axis,)
    return tuple(int(a) for a in axis)


def _dims(x, axis):
    if axis is None:
        return tuple(range(x.dim()))
    return (axis,) if isinstance(axis, int) else tuple(int(a) for a in axis)


def _fdt(x) -> torch.dtype:
    """x's dtype if floating, else fp32 (what jnp promotes ints to)."""
    return x.dtype if x.is_floating_point() or x.is_complex() \
        else torch.float32


def _fl(x):
    return x if x.is_floating_point() or x.is_complex() else x.float()


def _scalar(v, like):
    """A Python number or a 0-d tensor on like's device."""
    if isinstance(v, torch.Tensor):
        return v.to(like.device)
    if isinstance(v, np.ndarray):
        return _t(v, like)
    return v


def _sigmoid_derivative(x):
    s = torch.sigmoid(x)
    return s * (1 - s)


def _softplus(x):
    """``jax.nn.softplus`` = logaddexp(x, 0) (no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _cbrt(x):
    x = _fl(x)
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


# ---------------------------------------------------------------------------
# Family: elementwise transforms (ref: transform {same,strict,float,bool} loops)
# ---------------------------------------------------------------------------
_TRANSFORMS = {
    "abs": torch.abs, "neg": torch.neg, "exp": torch.exp,
    "expm1": torch.expm1, "log": torch.log, "log1p": torch.log1p,
    "log2": torch.log2, "log10": torch.log10, "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt, "square": torch.square,
    "cube": lambda x: x * x * x, "reciprocal": torch.reciprocal,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "asinh": torch.asinh, "acosh": torch.acosh, "atanh": torch.atanh,
    "erf": torch.special.erf, "erfc": torch.special.erfc,
    "floor": torch.floor, "ceil": torch.ceil, "round": torch.round,
    "rint": torch.round, "sign": torch.sign, "isnan": torch.isnan,
    "isinf": torch.isinf, "isfinite": torch.isfinite,
    "not": torch.logical_not,
    "sigmoid": torch.sigmoid, "sigmoid_derivative": _sigmoid_derivative,
    "softplus": _softplus, "softsign": F.softsign,
    "identity": _act.identity,
}
for _n, _f in _TRANSFORMS.items():
    register(_n, _f)
# the activation surface has ONE source of truth: activations.ACTIVATIONS
for _n, _f in _act.ACTIVATIONS.items():
    register(_n, _f)
register("hard_sigmoid", _act.hardsigmoid)
register("hard_tanh", _act.hardtanh)
register("rational_tanh", _act.rationaltanh)
register("rectified_tanh", _act.rectifiedtanh)


# ---------------------------------------------------------------------------
# Family: pairwise / broadcast binary (ref: pairwise + broadcast loops)
# ---------------------------------------------------------------------------
_PAIRWISE = {
    "add": torch.add, "subtract": torch.sub, "multiply": torch.mul,
    "divide": torch.true_divide, "reversesubtract": lambda a, b: b - a,
    "reversedivide": lambda a, b: b / a, "pow": torch.pow,
    "floordiv": torch.floor_divide, "mod": torch.remainder,
    "fmod": torch.fmod, "maximum": torch.maximum, "minimum": torch.minimum,
    "atan2": torch.atan2, "squared_subtract": lambda a, b: torch.square(a - b),
    "greater": torch.gt, "greater_equal": torch.ge, "less": torch.lt,
    "less_equal": torch.le, "equals": torch.eq, "not_equals": torch.ne,
    "boolean_and": torch.logical_and, "boolean_or": torch.logical_or,
    "boolean_xor": torch.logical_xor,
    "bitwise_and": torch.bitwise_and, "bitwise_or": torch.bitwise_or,
    "bitwise_xor": torch.bitwise_xor,
    "left_shift": torch.bitwise_left_shift,
    "right_shift": torch.bitwise_right_shift,
}
for _n, _f in _PAIRWISE.items():
    register(_n, _f)


# ---------------------------------------------------------------------------
# Family: reductions (ref: reduce {float,same,bool,long} + indexreduce +
# summarystats loops)
# ---------------------------------------------------------------------------
def _int_out(x):
    """int32 for integer/bool inputs (jnp's sums without x64)."""
    return None if x.is_floating_point() or x.is_complex() else torch.int32


def _reduce_sum(x, axis=None, keepdims=False):
    return torch.sum(x, dim=_dims(x, axis), keepdim=keepdims,
                     dtype=_int_out(x))


def _reduce_mean(x, axis=None, keepdims=False):
    return torch.mean(_fl(x), dim=_dims(x, axis), keepdim=keepdims)


def _reduce_prod(x, axis=None, keepdims=False):
    dims = _dims(x, axis)
    out = x if _int_out(x) is None else x.to(torch.int32)
    for d in sorted((d % x.dim() for d in dims), reverse=True):
        out = torch.prod(out, dim=d, keepdim=True)
    if not keepdims:
        out = out.reshape(tuple(s for i, s in enumerate(x.shape)
                                if i not in {d % x.dim() for d in dims}))
    return out.to(torch.int32) if _int_out(x) is not None else out


def _var(x, axis=None, keepdims=False):
    return torch.var(_fl(x), dim=_dims(x, axis), correction=0,
                     keepdim=keepdims)


def _std(x, axis=None, keepdims=False):
    return torch.std(_fl(x), dim=_dims(x, axis), correction=0,
                     keepdim=keepdims)


def _amax(x, axis=None, keepdims=False):
    return torch.amax(x, dim=_dims(x, axis), keepdim=keepdims)


def _amin(x, axis=None, keepdims=False):
    return torch.amin(x, dim=_dims(x, axis), keepdim=keepdims)


def _logsumexp(x, axis=None, keepdims=False):
    return torch.logsumexp(_fl(x), dim=_dims(x, axis), keepdim=keepdims)


def _count(mask, axis, keepdims):
    return torch.sum(mask, dim=_dims(mask, axis), keepdim=keepdims,
                     dtype=torch.int32)


_REDUCE = {
    "reduce_sum": _reduce_sum, "reduce_mean": _reduce_mean,
    "reduce_max": _amax, "reduce_min": _amin, "reduce_prod": _reduce_prod,
    "reduce_norm1": lambda x, axis=None, keepdims=False: _reduce_sum(
        torch.abs(x), axis, keepdims),
    "reduce_norm2": lambda x, axis=None, keepdims=False: torch.sqrt(
        _reduce_sum(x * x, axis, keepdims)),
    "reduce_norm_max": lambda x, axis=None, keepdims=False: _amax(
        torch.abs(x), axis, keepdims),
    "reduce_sqnorm": lambda x, axis=None, keepdims=False: _reduce_sum(
        x * x, axis, keepdims),
    "reduce_logsumexp": _logsumexp,
    "all": lambda x, axis=None, keepdims=False: torch.all(
        x.bool(), dim=_dims(x, axis), keepdim=keepdims),
    "any": lambda x, axis=None, keepdims=False: torch.any(
        x.bool(), dim=_dims(x, axis), keepdim=keepdims),
    "count_nonzero": lambda x, axis=None, keepdims=False: _count(
        x != 0, axis, keepdims),
    "count_zero": lambda x, axis=None, keepdims=False: _count(
        x == 0, axis, keepdims),
}


def _red(fn):
    def op(x, axis=None, keepdims=False):
        return fn(x, axis=_axes(axis), keepdims=keepdims)
    return op


for _n, _f in _REDUCE.items():
    register(_n, _red(_f))


def _argred(fn, x, axis):
    return fn(x, dim=axis).to(torch.int32)


register("argmax", lambda x, axis=None: _argred(torch.argmax, x, axis))
register("argmin", lambda x, axis=None: _argred(torch.argmin, x, axis))
register("argamax", lambda x, axis=None: _argred(torch.argmax,
                                                 torch.abs(x), axis))
register("argamin", lambda x, axis=None: _argred(torch.argmin,
                                                 torch.abs(x), axis))


@register("moments")
def _moments(x, axis=None, keepdims=False):
    """(ref: libnd4j ``moments`` — returns mean and variance)"""
    return _reduce_mean(x, _axes(axis), keepdims), \
        _var(x, _axes(axis), keepdims)


@register("standardize")
def _standardize(x, axis=-1):
    m = torch.mean(x, dim=axis, keepdim=True)
    s = torch.std(x, dim=axis, correction=0, keepdim=True)
    return (x - m) / torch.clamp_min(s, 1e-8)


# ---------------------------------------------------------------------------
# Family: shape / gather-scatter (ref: declarable generic/shape, parity_ops)
# ---------------------------------------------------------------------------
def _transpose(x, perm=None):
    return x.permute(*(tuple(perm) if perm is not None
                       else range(x.dim() - 1, -1, -1)))


def _long(idx, like):
    return _t(idx, like).to(device=like.device, dtype=torch.long)


def _gather(x, idx, axis=0):
    """``jnp.take(x, idx, axis)``: the output's ``axis`` is replaced by
    idx's shape."""
    axis = axis % x.dim()
    idx = _long(idx, x)
    rows = torch.index_select(x, axis, idx.reshape(-1))
    return rows.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])


def _expand_dims(x, axis):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    out_rank = x.dim() + len(axes)
    for a in sorted(a % out_rank for a in axes):
        x = x.unsqueeze(a)
    return x


def _squeeze(x, axis=None):
    if axis is None:
        return x.squeeze()
    return x.squeeze(axis if isinstance(axis, int) else tuple(axis))


def _split(x, num, axis=0):
    if isinstance(num, int):
        if x.shape[axis] % num:
            raise ValueError("array split does not result in an equal "
                             "division")
        return list(torch.tensor_split(x, num, dim=axis))
    return list(torch.tensor_split(x, [int(i) for i in num], dim=axis))


def _split_v(x, sizes, axis=0):
    cuts = np.cumsum([int(s) for s in sizes])[:-1]
    return list(torch.tensor_split(x, [int(c) for c in cuts], dim=axis))


def _index_list(n, spec):
    return list(range(n))[spec]


def _pad_indices(n, lo, hi, mode, device):
    """Source indices along one axis for numpy's pad modes, computed on
    ``device`` from the sizes alone."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return torch.clamp(i, 0, n - 1)
    if mode == "wrap":
        return torch.remainder(i, n)
    if mode == "reflect":
        if n == 1:
            return torch.zeros_like(i)
        period = 2 * (n - 1)
        m = torch.remainder(i, period)
        return torch.where(m < n, m, period - m)
    if mode == "symmetric":
        period = 2 * n
        m = torch.remainder(i, period)
        return torch.where(m < n, m, period - 1 - m)
    raise ValueError(f"unsupported pad mode '{mode}'")


def _pad(x, paddings, mode="constant", value=0.0):
    """``jnp.pad`` (constant, edge, wrap, reflect, symmetric)."""
    w = np.asarray(paddings, dtype=np.int64)
    widths = np.broadcast_to(w.reshape(-1, 2) if w.ndim else w, (x.dim(), 2))
    if mode == "constant":
        flat = []
        for lo, hi in reversed(widths.tolist()):
            flat += [lo, hi]
        return F.pad(x, flat, value=value)
    for ax, (lo, hi) in enumerate(widths.tolist()):
        if lo or hi:
            x = torch.index_select(x, ax, _pad_indices(x.shape[ax], lo, hi,
                                                       mode, x.device))
    return x


def _scatter(x, idx, upd, how):
    out = x.clone()
    idx = _long(idx, x)
    upd = _t(upd, x).to(x.dtype)
    if how == "set":
        out[idx] = upd
    elif how in ("add", "sub"):
        out.index_put_((idx,), -upd if how == "sub" else upd,
                       accumulate=True)
    else:
        flat = idx.reshape(-1)
        upd = torch.broadcast_to(upd, idx.shape + x.shape[1:]).reshape(
            (flat.numel(),) + tuple(x.shape[1:]))
        out.index_reduce_(0, flat, upd, how, include_self=True)
    return out


def _dynamic_slice(x, begin, size):
    """``lax.dynamic_slice``: starts clamped so the window fits."""
    out = x
    for ax, (b, s) in enumerate(zip(begin, size)):
        b = min(max(int(b), 0), x.shape[ax] - int(s))
        out = out.narrow(ax, b, int(s))
    return out


def _strided_slice(x, begin, end, strides):
    out = x
    for ax, (b, e, s) in enumerate(zip(begin, end, strides)):
        sl = slice(b, e, s)
        if s is None or s > 0:
            out = out[(slice(None),) * ax + (sl,)]
        else:
            idx = torch.as_tensor(_index_list(x.shape[ax], sl),
                                  dtype=torch.long, device=x.device)
            out = torch.index_select(out, ax, idx)
    return out


def _where(cond, x=None, y=None):
    if x is None:
        return torch.argwhere(cond).to(torch.int32)
    c = _t(cond)
    ref = x if isinstance(x, torch.Tensor) else (
        y if isinstance(y, torch.Tensor) else c)
    return torch.where(c.to(ref.device) != 0, _scalar(x, ref),
                       _scalar(y, ref))


def _one_hot(idx, depth, on=1.0, off=0.0, axis=-1):
    idx = _t(idx)
    hot = (idx.long().unsqueeze(-1) == torch.arange(
        depth, device=idx.device)).to(torch.float32)
    if axis != -1 and axis != idx.dim():
        hot = torch.movedim(hot, -1, axis)
    return hot * (on - off) + off


def _trace(x, offset=0, axis1=0, axis2=1):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1,
                                                       dtype=_int_out(x))


def _linspace(start, stop, num=50, endpoint=True, dtype=None, device=None):
    dev = resolve_device(device)
    n = int(num)
    div = (n - 1) if endpoint else n
    dt = canonical_dtype(dtype) if dtype is not None else torch.float32
    step = (stop - start) / div if div > 0 else 0.0
    out = start + step * torch.arange(n, dtype=torch.float64, device=dev)
    if endpoint and n > 1:
        out[-1] = stop
    return out.to(dt)


def _arange(start, stop=None, step=None, dtype=None, device=None):
    dev = resolve_device(device)
    if stop is None:
        start, stop = 0, start
    step = 1 if step is None else step
    if dtype is None:
        floaty = any(isinstance(v, float) for v in (start, stop, step))
        dt = torch.float32 if floaty else torch.int32
    else:
        dt = canonical_dtype(dtype)
    return torch.arange(start, stop, step, dtype=dt, device=dev)


def _fill(shape, value, dtype=None, device=None):
    shape = (int(shape),) if np.ndim(shape) == 0 else \
        tuple(int(s) for s in shape)
    if dtype is not None:
        dt = canonical_dtype(dtype)
    elif isinstance(value, bool):
        dt = torch.bool
    elif isinstance(value, int):
        dt = torch.int32
    elif isinstance(value, torch.Tensor):
        dt = value.dtype
    else:
        dt = torch.float32
    return torch.full(shape, value, dtype=dt, device=resolve_device(device))


def _cum(fn, x, axis, exclusive, reverse, init):
    if reverse:
        x = torch.flip(x, dims=(axis,))
    out = fn(x, dim=axis, dtype=_int_out(x))
    if exclusive:
        shape = list(x.shape)
        shape[axis] = 1
        head = torch.full(shape, init, dtype=out.dtype, device=x.device)
        out = torch.cat([head, out.narrow(axis, 0, x.shape[axis] - 1)],
                        dim=axis)
    if reverse:
        out = torch.flip(out, dims=(axis,))
    return out


register("reshape", lambda x, shape: torch.reshape(
    x, (int(shape),) if np.ndim(shape) == 0 else tuple(shape)))
register("transpose", _transpose)
register("permute", lambda x, perm: x.permute(*perm))
register("expand_dims", _expand_dims)
register("squeeze", _squeeze)
register("concat", lambda arrs, axis=0: torch.cat(list(arrs), dim=axis))
register("stack", lambda arrs, axis=0: torch.stack(list(arrs), dim=axis))
register("unstack", lambda x, axis=0: list(torch.unbind(x, dim=axis)))
register("split", _split)
register("split_v", _split_v)
register("tile", lambda x, reps: torch.tile(
    x, (int(reps),) if np.ndim(reps) == 0 else tuple(reps)))
register("repeat", lambda x, n, axis: torch.repeat_interleave(x, n, dim=axis))
register("flip", lambda x, axis: torch.flip(x, dims=_dims(x, axis)))
register("reverse", lambda x, axis: torch.flip(x, dims=_dims(x, axis)))
register("roll", lambda x, shift, axis=None: torch.roll(
    x, shift, dims=axis) if axis is not None else torch.roll(x, shift))
register("pad", _pad)
register("gather", _gather)
register("gather_nd", lambda x, idx: x[tuple(torch.movedim(
    _long(idx, x), -1, 0))])
register("scatter_update", lambda x, idx, upd: _scatter(x, idx, upd, "set"))
register("scatter_add", lambda x, idx, upd: _scatter(x, idx, upd, "add"))
register("scatter_sub", lambda x, idx, upd: _scatter(x, idx, upd, "sub"))
register("scatter_max", lambda x, idx, upd: _scatter(x, idx, upd, "amax"))
register("scatter_min", lambda x, idx, upd: _scatter(x, idx, upd, "amin"))
register("slice", _dynamic_slice)
register("strided_slice", _strided_slice)
register("where", _where)
register("boolean_mask", lambda x, m: x[_t(m, x).to(device=x.device,
                                                      dtype=torch.bool)])
register("one_hot", _one_hot)
register("eye", lambda n, m=None, device=None: torch.eye(
    n, n if m is None else m, dtype=torch.float32,
    device=resolve_device(device)))
register("diag", torch.diag)
register("diag_part", lambda x, offset=0: torch.diagonal(x, offset, 0, 1))
register("trace", _trace)
register("triu", lambda x, k=0: torch.triu(x, k))
register("tril", lambda x, k=0: torch.tril(x, k))
register("size", lambda x: x.numel())
register("shape_of", lambda x: torch.tensor(tuple(x.shape), dtype=torch.int32,
                                            device=x.device))
register("rank", lambda x: x.dim())
register("linspace", _linspace)
register("range", _arange)
register("cast", lambda x, dtype: x.to(canonical_dtype(dtype)))
register("fill", _fill)
register("zeros_like", torch.zeros_like)
register("ones_like", torch.ones_like)
register("cumsum", lambda x, axis=0, exclusive=False, reverse=False:
         _cum(torch.cumsum, x, axis, exclusive, reverse, 0))
register("cumprod", lambda x, axis=0, exclusive=False, reverse=False:
         _cum(torch.cumprod, x, axis, exclusive, reverse, 1))


def _stable_desc(x, dim=-1):
    """Descending sort with ties in index order (``lax.top_k``'s order)."""
    return torch.sort(x, dim=dim, descending=True, stable=True)


@register("top_k")
def _top_k(x, k, sorted=True):
    vals, idx = _stable_desc(x)
    return vals[..., :k], idx[..., :k].to(torch.int32)


@register("in_top_k")
def _in_top_k(predictions, targets, k):
    _, idx = _top_k(predictions, k)
    return torch.any(idx == _t(targets, predictions)[:, None].to(idx.device),
                     dim=-1)


@register("unique")
def _unique(x):
    """Sorted unique values padded with 0 to x's size, and the inverse
    index (``jnp.unique(..., size=x.size, fill_value=0)``)."""
    if x.is_meta:                 # the static shapes, for infer_shape
        return x.new_empty(x.numel()), x.new_empty(x.shape,
                                                   dtype=torch.int32)
    vals, inv = torch.unique(x, sorted=True, return_inverse=True)
    pad = x.numel() - vals.numel()
    vals = torch.cat([vals, vals.new_zeros(pad)]) if pad else vals
    return vals, inv.to(torch.int32).reshape(x.shape)


@register("confusion_matrix")
def _confusion_matrix(labels, pred, num_classes):
    n = int(num_classes)
    idx = labels.long() * n + _t(pred, labels).to(labels.device).long()
    cm = torch.zeros(n * n + 1, dtype=torch.int32, device=labels.device)
    ok = (idx >= 0) & (idx < n * n)
    cm.index_add_(0, torch.where(ok, idx, n * n).reshape(-1),
                  torch.ones(idx.numel(), dtype=torch.int32,
                             device=labels.device))
    return cm[:n * n].reshape(n, n)


@register("sequence_mask")
def _sequence_mask(lengths, maxlen):
    return torch.arange(int(maxlen), device=lengths.device)[None, :] \
        < lengths[:, None]


@register("reverse_sequence")
def _reverse_sequence(x, lengths, seq_axis=1, batch_axis=0):
    xm = torch.movedim(x, (batch_axis, seq_axis), (0, 1))
    T = xm.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    li = _t(lengths, x).to(x.device).long()[:, None]
    rev = torch.where(t < li, li - 1 - t, t)                   # [B, T]
    idx = rev.reshape(rev.shape + (1,) * (xm.dim() - 2)).expand(xm.shape)
    return torch.movedim(torch.gather(xm, 1, idx), (0, 1),
                         (batch_axis, seq_axis))


# ---------------------------------------------------------------------------
# Family: linalg (ref: generic/blas + helpers; GEMM → cuBLAS)
# ---------------------------------------------------------------------------
def _matmul(a, b, transpose_a=False, transpose_b=False):
    return torch.matmul(a.transpose(-1, -2) if transpose_a else a,
                        b.transpose(-1, -2) if transpose_b else b)


def _xw_plus_b(x, w, b):
    if x.dim() == 2 and w.dim() == 2 and b.dim() == 1:
        return torch.addmm(b, x, w)       # one cuBLAS call with the bias
    return torch.matmul(x, w) + b


def _tensordot(a, b, axes=2):
    if not isinstance(axes, int):
        axes = [list(np.atleast_1d(axes[0])), list(np.atleast_1d(axes[1]))]
    return torch.tensordot(a, b, dims=axes)


def _solve(a, b):
    if b.dim() == a.dim() - 1:
        return torch.linalg.solve(a, b.unsqueeze(-1)).squeeze(-1)
    return torch.linalg.solve(a, b)


def _triangular_solve(a, b, lower=True):
    vec = b.dim() == a.dim() - 1
    out = torch.linalg.solve_triangular(a, b.unsqueeze(-1) if vec else b,
                                        upper=not lower)
    return out.squeeze(-1) if vec else out


def _norm_op(x, ord=None, axis=None, keepdims=False):
    return torch.linalg.norm(_fl(x), ord=ord, dim=_axes(axis),
                             keepdim=keepdims)


register("matmul", _matmul)
register("mmul", lambda *a, **k: get("matmul")(*a, **k))
register("batched_gemm", lambda *a, **k: get("matmul")(*a, **k))
register("tensordot", _tensordot)
register("outer", lambda a, b: torch.outer(a.reshape(-1), b.reshape(-1)))
register("dot", lambda a, b: torch.vdot(a.reshape(-1), b.reshape(-1)))
register("cholesky", torch.linalg.cholesky)
register("qr", lambda x: tuple(torch.linalg.qr(x, mode="reduced")))
register("svd", lambda x, full_matrices=True: tuple(
    torch.linalg.svd(x, full_matrices=full_matrices)))
register("matrix_inverse", torch.linalg.inv)
register("matrix_determinant", torch.linalg.det)
register("log_matrix_determinant", lambda x: torch.linalg.slogdet(x)[1])
register("solve", _solve)
register("triangular_solve", _triangular_solve)
# the minimum-norm solution through the pseudo-inverse (jnp.linalg.lstsq's
# SVD answer, rcond = eps * max(M, N)): cuSOLVER's lstsq is QR-only
register("lstsq", lambda a, b: torch.linalg.pinv(a) @ b)
register("matrix_diag", torch.diag_embed)
register("norm", _norm_op)
register("cross", lambda a, b: torch.linalg.cross(a, b, dim=-1))


# ---------------------------------------------------------------------------
# Family: nn ops (conv/pool/norm/rnn/attention — defined in sibling modules)
# ---------------------------------------------------------------------------
def softmax(x, axis: int = -1):
    """The generic softmax: ``jax.nn.softmax``'s formula (max
    subtracted, exp, divided by the sum) with the max and the sum in
    fp32, cast back to x's dtype (fp64 stays fp64)."""
    xf = x if x.dtype == torch.float64 else x.float()
    e = torch.exp(xf - xf.amax(dim=axis, keepdim=True))
    return (e / e.sum(dim=axis, keepdim=True)).to(x.dtype)


register("conv1d", _conv.conv1d)
register("conv2d", _conv.conv2d)
register("conv3dnew", _conv.conv3d)
register("conv3d", _conv.conv3d)
register("deconv2d", _conv.deconv2d)
register("depthwise_conv2d", _conv.depthwise_conv2d)
register("sconv2d", _conv.separable_conv2d)
register("maxpool2d", _conv.maxpool2d)
register("avgpool2d", _conv.avgpool2d)
register("pnormpool2d", _conv.pnormpool2d)
register("maxpool3dnew", _conv.maxpool3d)
register("avgpool3dnew", _conv.avgpool3d)
register("upsampling2d", _conv.upsampling2d)
register("space_to_depth", _conv.space_to_depth)
register("depth_to_space", _conv.depth_to_space)
register("im2col", _conv.im2col)
register("batchnorm", _norm.batch_norm)
# SD-node variant with the SameDiff arg order (x, mean, var, gamma, beta)
register("batchnorm_sd", lambda x, m, v, g, b, eps=1e-5, axis=1:
         _norm.batch_norm(x, g, b, m, v, eps=eps, axis=axis))
register("layer_norm", _norm.layer_norm)
register("scale_shift_act", _norm.scale_shift_act)
register("rms_norm", _norm.rms_norm)
register("lrn", _norm.lrn)
register("dropout", _norm.dropout)
register("lstmLayer", _rnn.lstm)
register("lstmLayer_out", lambda x, wi, wh, b: _rnn.lstm(x, wi, wh, b)[0])
register("gru_out", lambda x, wi, wh, bi, bh: _rnn.gru(x, wi, wh, bi, bh)[0])
register("lstmCell", _rnn.lstm_cell)
register("gruCell", _rnn.gru_cell)
register("gru", _rnn.gru)
register("sru", _rnn.sru)
register("sruCell", _rnn.sru_cell)
register("simple_rnn", _rnn.simple_rnn)
register("dot_product_attention", _attn.dot_product_attention)
register("multi_head_dot_product_attention", _attn.multi_head_attention)
register("flash_attention", _attn.flash_attention)
register("softmax", softmax)
register("log_softmax", lambda x, axis=-1: torch.log_softmax(x, dim=axis))
register("prelu", _act.prelu)
register("relu_layer", lambda x, w, b: torch.relu(_xw_plus_b(x, w, b)))
register("xw_plus_b", _xw_plus_b)
register("bias_add", lambda x, b: x + b)
register("embedding_lookup", lambda table, ids: _gather(table, ids, 0))

# losses (ref: generic/loss)
register("softmax_cross_entropy_loss", _loss.softmax_cross_entropy_logits)
register("sigmoid_cross_entropy_loss", _loss.xent_logits)
register("sparse_softmax_cross_entropy_loss", _loss.sparse_mcxent)
register("mean_sqerr_loss", _loss.mse)
register("absolute_difference_loss", _loss.l1)
register("cosine_distance_loss", _loss.cosine_proximity)
register("hinge_loss", _loss.hinge)


@register("huber_loss")
def _huber(labels, preds, delta=1.0):
    d = torch.abs(preds - labels)
    return torch.mean(torch.where(d <= delta, 0.5 * torch.square(
        preds - labels), delta * d - 0.5 * delta ** 2))


register("log_loss", _loss.xent)
register("l2_loss", lambda x: 0.5 * torch.sum(x * x))


# ---------------------------------------------------------------------------
# Family: random (ref: declarable random ops). The JAX ops take a Threefry
# key first; these take a ``torch.Generator`` there and draw on its device.
# The streams differ from the JAX package's: parity is in distribution,
# shape and dtype (OpValidation's random checks), and a seed reproduces.
# ---------------------------------------------------------------------------
def _shape_of(shape):
    return (int(shape),) if np.ndim(shape) == 0 else \
        tuple(int(s) for s in shape)


def _rand(gen, shape, dtype=torch.float32):
    return torch.rand(_shape_of(shape), generator=gen, device=gen.device,
                      dtype=dtype)


def _randn(gen, shape, dtype=torch.float32):
    return torch.randn(_shape_of(shape), generator=gen, device=gen.device,
                       dtype=dtype)


def standard_gamma(gen, alpha, shape):
    """Gamma(alpha, 1) draws by Marsaglia-Tsang rejection (alpha < 1
    boosted through ``U^(1/alpha)``), from ``gen`` alone. Rounds repeat
    until every element is accepted (more than 95% are per round)."""
    shape = _shape_of(shape)
    a = torch.as_tensor(alpha, dtype=torch.float32, device=gen.device)
    a = torch.broadcast_to(a, shape)
    boost = a < 1
    d = torch.where(boost, a + 1, a) - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros(shape, device=gen.device)
    todo = torch.ones(shape, dtype=torch.bool, device=gen.device)
    while bool(todo.any()):
        x = _randn(gen, shape)
        u = _rand(gen, shape)
        v = (1 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp_min(v, 1e-30)))
        take = todo & ok
        out = torch.where(take, d * v, out)
        todo = todo & ~ok
    u = _rand(gen, shape)
    return torch.where(boost, out * u ** (1.0 / a), out)


@register("random_uniform")
def _random_uniform(gen, shape, minval=0.0, maxval=1.0, dtype=torch.float32):
    dt = canonical_dtype(dtype)
    return (_rand(gen, shape, dt) * (maxval - minval) + minval).to(dt)


@register("random_normal")
def _random_normal(gen, shape, mean=0.0, stddev=1.0, dtype=torch.float32):
    dt = canonical_dtype(dtype)
    return mean + stddev * _randn(gen, shape, dt)


register("random_bernoulli", lambda gen, shape, p=0.5:
         _rand(gen, shape) < p)
register("random_exponential", lambda gen, shape, lam=1.0:
         -torch.log1p(-_rand(gen, shape)) / lam)
register("random_gamma", lambda gen, shape, alpha=1.0:
         standard_gamma(gen, alpha, shape))
register("random_poisson", lambda gen, shape, lam=1.0: torch.poisson(
    torch.full(_shape_of(shape), float(lam), device=gen.device),
    generator=gen).to(torch.int32))


@register("random_shuffle")
def _random_shuffle(gen, x, axis=0):
    perm = torch.randperm(x.shape[axis], generator=gen, device=gen.device)
    return torch.index_select(x, axis, perm.to(x.device))


@register("random_multinomial")
def _random_multinomial(gen, logits, num_samples):
    p = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(p, int(num_samples), replacement=True,
                             generator=gen).to(torch.int32)


register("dropout_inverted", _norm.dropout)


# ---------------------------------------------------------------------------
# Family: image (ref: generic/parity_ops image ops; used by YOLO/zoo).
# ``jax.image.resize``'s sampling, exactly: nearest takes source pixel
# floor((i + 1/2) in/out); the interpolating methods multiply each spatial
# axis by a weight matrix (half-pixel centres, the kernel widened by
# in/out when downsampling, weights renormalised at the borders), built on
# the host from the shapes alone.
# ---------------------------------------------------------------------------
def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _lanczos(radius):
    def k(x):
        y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
        den = torch.where(x != 0, math.pi ** 2 * x * x, torch.ones_like(x))
        out = torch.where(x > 1e-3, y / den, torch.ones_like(x))
        return torch.where(x > radius, torch.zeros_like(x), out)
    return k


_RESIZE_KERNELS = {
    "linear": lambda x: torch.clamp_min(1.0 - torch.abs(x), 0.0),
    "bilinear": lambda x: torch.clamp_min(1.0 - torch.abs(x), 0.0),
    "cubic": _keys_cubic, "bicubic": _keys_cubic,
    "lanczos3": _lanczos(3.0), "lanczos5": _lanczos(5.0),
}


def resize_weights(in_size: int, out_size: int, method: str, device,
                   antialias: bool = True) -> torch.Tensor:
    """[out, in] fp32 weights of ``jax.image.scale_and_translate`` at
    scale out/in, no translation, computed on ``device`` from the sizes
    alone."""
    kernel = _RESIZE_KERNELS[method]
    inv_scale = in_size / out_size
    kscale = max(inv_scale, 1.0) if antialias else 1.0
    sample = (torch.arange(out_size, dtype=torch.float64, device=device)
              + 0.5) * inv_scale - 0.5
    src = torch.arange(in_size, dtype=torch.float64, device=device)
    w = kernel(torch.abs(sample[None, :] - src[:, None]) / kscale).float()
    tot = w.sum(dim=0, keepdim=True)
    w = torch.where(torch.abs(tot) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(tot != 0, tot, torch.ones_like(tot)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).T


def _resize_axis(x, axis, out_size, method):
    n = x.shape[axis]
    if n == out_size:
        return x
    if method == "nearest":
        idx = torch.floor((torch.arange(out_size, dtype=torch.float32,
                                        device=x.device) + 0.5)
                          * n / out_size).long()
        return torch.index_select(x, axis, idx)
    w = resize_weights(n, out_size, method, x.device).to(_fdt(x))
    xm = torch.movedim(_fl(x), axis, -1)
    return torch.movedim(torch.matmul(xm, w.T), -1, axis)


def image_resize_nd(x, shape, method):
    """``jax.image.resize(x, shape, method)`` for the methods above."""
    for ax, s in enumerate(shape):
        if s != x.shape[ax]:
            x = _resize_axis(x, ax, int(s), method)
    return x


def _resize_layout(x, size, data_format, method):
    if data_format.upper().startswith("NC"):
        shape = tuple(x.shape[:2]) + tuple(int(s) for s in size)
    else:
        shape = (x.shape[0],) + tuple(int(s) for s in size) + (x.shape[-1],)
    return image_resize_nd(x, shape, method)


register("resize_nearest_neighbor", lambda x, size, data_format="NHWC":
         _resize_layout(x, size, data_format, "nearest"))
register("resize_bilinear", lambda x, size, data_format="NHWC":
         _resize_layout(x, size, data_format, "linear"))


def _greedy_nms(overlap, scores, max_out, threshold, score_threshold):
    """Greedy selection over a precomputed [N, N] overlap matrix, on the
    device with no host read: ``max_out`` rounds of (first still-active
    box in score order, suppress its overlaps); -1 pads."""
    n = scores.shape[0]
    order = torch.sort(-scores, stable=True).indices
    active = scores[order] > score_threshold
    ar = torch.arange(n, device=scores.device)
    keep = []
    for _ in range(int(max_out)):
        any_active = active.any()
        cand = torch.argmax(active.to(torch.int32)).reshape(1)
        pick = order.index_select(0, cand)        # [1]: no host read
        keep.append(torch.where(any_active, pick, -1))
        ov = overlap.index_select(0, pick)[0].index_select(0, order)
        active = active & ~((ov > threshold) & any_active) & (ar != cand)
    if not keep:
        return torch.full((0,), -1, dtype=torch.int32, device=scores.device)
    return torch.cat(keep).to(torch.int32)


@register("non_max_suppression")
def _nms(boxes, scores, max_out, iou_threshold=0.5,
         score_threshold=-float("inf")):
    """Greedy NMS over [N,4] boxes (y1,x1,y2,x2) — fixed-size output with
    -1 padding (ref: libnd4j ``non_max_suppression``; YOLO postprocessing
    uses this)."""
    y1, x1, y2, x2 = boxes.unbind(-1)
    areas = torch.clamp_min(y2 - y1, 0) * torch.clamp_min(x2 - x1, 0)
    yy1 = torch.maximum(y1[:, None], y1[None, :])
    xx1 = torch.maximum(x1[:, None], x1[None, :])
    yy2 = torch.minimum(y2[:, None], y2[None, :])
    xx2 = torch.minimum(x2[:, None], x2[None, :])
    inter = torch.clamp_min(yy2 - yy1, 0) * torch.clamp_min(xx2 - xx1, 0)
    iou = inter / torch.clamp_min(areas[:, None] + areas[None, :] - inter,
                                  1e-9)
    return _greedy_nms(iou, scores, max_out, iou_threshold, score_threshold)


# ---------------------------------------------------------------------------
# Family: reduce3 (pairwise distance/similarity reductions)
# ref: libnd4j reduce3 loops {cosinesimilarity, cosinedistance, euclidean,
# manhattan, hamming, jaccard, dot}
# ---------------------------------------------------------------------------
def _sum_ax(v, axis):
    return torch.sum(v, dim=_dims(v, axis))


@register("cosine_similarity")
def _cosine_similarity(x, y, axis=None):
    if axis is None:
        x, y = x.reshape(-1), y.reshape(-1)
        axis = 0
    num = torch.sum(x * y, dim=axis)
    den = torch.linalg.vector_norm(x, dim=axis) \
        * torch.linalg.vector_norm(y, dim=axis)
    return num / torch.clamp_min(den, 1e-12)


register("cosine_distance", lambda x, y, axis=None:
         1.0 - _cosine_similarity(x, y, axis=axis))
register("euclidean_distance", lambda x, y, axis=None:
         torch.sqrt(_sum_ax(torch.square(x - y), axis)))
register("manhattan_distance", lambda x, y, axis=None:
         _sum_ax(torch.abs(x - y), axis))
register("hamming_distance", lambda x, y, axis=None:
         _sum_ax((x != y).to(torch.float32), axis))


@register("jaccard_distance")
def _jaccard_distance(x, y, axis=None):
    mn = _sum_ax(torch.minimum(x, y), axis)
    mx = _sum_ax(torch.maximum(x, y), axis)
    # both-empty sets are identical: distance 0, not the 0/0 fallback
    return torch.where(mx == 0, torch.zeros_like(mx),
                       1.0 - mn / torch.clamp_min(mx, 1e-12))


# ---------------------------------------------------------------------------
# Family: segment reductions (ref: libnd4j segment_* / unsorted_segment_*)
# ---------------------------------------------------------------------------
def _n_segments(ids, num_segments):
    # without num_segments the count is the data's (max id + 1), read back
    # as the eager JAX op reads it
    return int(num_segments) if num_segments is not None \
        else int(ids.max()) + 1


def _seg_init(data, how):
    if how == "amax":
        return -math.inf if data.is_floating_point() \
            else torch.iinfo(data.dtype).min
    if how == "amin":
        return math.inf if data.is_floating_point() \
            else torch.iinfo(data.dtype).max
    return 1 if how == "prod" else 0


def segment_reduce(data, ids, n, how):
    """``jax.ops.segment_{sum,prod,max,min}``: empty segments hold the
    reduction's identity; ids outside [0, n) are dropped."""
    ids = _long(ids, data).reshape(-1)
    out = torch.full((n + 1,) + tuple(data.shape[1:]), _seg_init(data, how),
                     dtype=data.dtype, device=data.device)
    ids = torch.where((ids >= 0) & (ids < n), ids, n)
    if how == "sum":
        out = out.index_add(0, ids, data)
    else:
        out = out.index_reduce(0, ids, data, how, include_self=True)
    return out[:n]


def _segment(how):
    def op(data, segment_ids, num_segments=None):
        n = _n_segments(segment_ids, num_segments)
        return segment_reduce(data, segment_ids, n, how)
    return op


register("segment_sum", _segment("sum"))
register("segment_prod", _segment("prod"))
register("segment_max", _segment("amax"))
register("segment_min", _segment("amin"))


@register("segment_mean")
def _segment_mean(data, segment_ids, num_segments=None):
    n = _n_segments(segment_ids, num_segments)
    s = segment_reduce(data, segment_ids, n, "sum")
    c = segment_reduce(torch.ones_like(data, dtype=torch.float32),
                       segment_ids, n, "sum")
    return s / torch.clamp_min(c, 1.0)


for _nm in ("sum", "prod", "max", "min", "mean"):
    register(f"unsorted_segment_{_nm}", _REGISTRY[f"segment_{_nm}"])


# ---------------------------------------------------------------------------
# Family: space/batch + band/diag utilities (ref: libnd4j parity_ops)
# ---------------------------------------------------------------------------
@register("matrix_band_part")
def _matrix_band_part(x, num_lower, num_upper):
    m, n = x.shape[-2], x.shape[-1]
    i = torch.arange(m, device=x.device)[:, None]
    j = torch.arange(n, device=x.device)[None, :]
    keep = torch.ones((m, n), dtype=torch.bool, device=x.device)
    if num_lower >= 0:
        keep &= (i - j) <= num_lower
    if num_upper >= 0:
        keep &= (j - i) <= num_upper
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


@register("space_to_batch")
def _space_to_batch(x, block_size, paddings=((0, 0), (0, 0))):
    """NHWC, uniform block (ref: space_to_batch); paddings per spatial dim."""
    b = int(block_size)
    x = _pad(x, [(0, 0), tuple(paddings[0]), tuple(paddings[1]), (0, 0)])
    n, h, w, c = x.shape
    x = x.reshape(n, h // b, b, w // b, b, c)
    x = x.permute(2, 4, 0, 1, 3, 5)
    return x.reshape(n * b * b, h // b, w // b, c)


@register("batch_to_space")
def _batch_to_space(x, block_size, crops=((0, 0), (0, 0))):
    b = int(block_size)
    nb, h, w, c = x.shape
    n = nb // (b * b)
    x = x.reshape(b, b, n, h, w, c)
    x = x.permute(2, 3, 0, 4, 1, 5).reshape(n, h * b, w * b, c)
    (ct, cb), (cl, cr) = crops
    return x[:, ct:h * b - cb, cl:w * b - cr]


def _bin_edges(lo, hi, bins):
    """``jnp.linspace(lo, hi, bins + 1)`` on lo/hi's device."""
    i = torch.arange(bins + 1, device=lo.device, dtype=lo.dtype)
    edges = lo + (hi - lo) / bins * i
    edges[-1] = hi
    return edges


def histogram_counts(x, edges):
    """``jnp.histogram``'s counts: bins closed on the left, the last also
    on the right, values outside dropped; in x's (floating) dtype as the
    JAX op's unit weights are, on x's device (bucketize and a scatter-add:
    no host round trip)."""
    x = x.reshape(-1)
    idx = torch.bucketize(x, edges, right=True)
    idx = torch.where(x == edges[-1], edges.numel() - 1, idx)
    counts = torch.zeros(edges.numel() + 1, dtype=x.dtype, device=x.device)
    counts.index_add_(0, idx, torch.ones_like(x))
    return counts[1:edges.numel()]


@register("histogram")
def _histogram(x, bins=10, range=None):
    x = _fl(x)
    if range is None:
        lo, hi = x.min(), x.max()
        same = lo == hi
        lo = torch.where(same, lo - 0.5, lo)
        hi = torch.where(same, hi + 0.5, hi)
    else:
        lo = torch.tensor(float(range[0]), dtype=x.dtype, device=x.device)
        hi = torch.tensor(float(range[1]), dtype=x.dtype, device=x.device)
    return histogram_counts(x, _bin_edges(lo, hi, int(bins)))


@register("histogram_fixed_width")
def _histogram_fixed_width(x, lo, hi, bins=100):
    return _histogram(x, bins=bins, range=(lo, hi))


@register("bincount")
def _bincount(x, weights=None, minlength=0, length=None):
    """``length`` defaults to max(x)+1 (read back, as the eager JAX op
    does) and to minlength for empty input; values past it are dropped."""
    xf = x.reshape(-1).long()
    if length is None:
        mx = int(xf.max()) + 1 if xf.numel() else 0
        length = max(mx, int(minlength), 1)
    n = int(length)
    if weights is None:
        w = torch.ones_like(xf, dtype=torch.int32)
    else:
        w = weights.reshape(-1)
        w = w.to(canonical(w.dtype))
    out = torch.zeros(n + 1, dtype=w.dtype, device=x.device)
    out.index_add_(0, torch.where((xf >= 0) & (xf < n), xf, n), w)
    return out[:n]


@register("meshgrid")
def _meshgrid(*xs, indexing="xy"):
    return list(torch.meshgrid(*xs, indexing=indexing))


@register("nth_element")
def _nth_element(x, n, reverse=False):
    s = torch.sort(x, dim=-1, stable=True).values
    if reverse:
        s = torch.flip(s, dims=(-1,))
    return s[..., n]


def _quantile(x, q, axis=None, interpolation="linear", keepdims=False):
    x = _fl(x)
    dims = _dims(x, axis)
    other = [d for d in range(x.dim()) if d not in {a % max(x.dim(), 1)
                                                    for a in dims}]
    moved = x.permute(*(other + [d % x.dim() for d in dims])) \
        if x.dim() else x.reshape(1)
    flat = moved.reshape(tuple(x.shape[d] for d in other) + (-1,))
    qt = torch.as_tensor(q, dtype=x.dtype, device=x.device)
    return torch.quantile(flat, qt, dim=-1, interpolation=interpolation)


@register("percentile")
def _percentile(x, q, axis=None, interpolation="linear"):
    q = np.asarray(q, dtype=np.float64) / 100.0
    return _quantile(x, q if q.ndim else float(q), axis, interpolation)


register("median", lambda x, axis=None: _quantile(x, 0.5, axis))


@register("dynamic_partition")
def _dynamic_partition(data, partitions, num_partitions):
    """ref: dynamic_partition — the static-shape form the JAX package
    keeps: masked copies (rows not in partition k are zero)."""
    p = _t(partitions, data).to(data.device)
    zero = torch.zeros((), dtype=data.dtype, device=data.device)
    return [torch.where((p == k).reshape(p.shape + (1,) * (data.dim()
                                                          - p.dim())),
                        data, zero)
            for k in range(int(num_partitions))]


@register("dynamic_stitch")
def _dynamic_stitch(indices, data):
    """ref: dynamic_stitch — output length = max(index)+1 (read back: the
    output shape depends on the data)."""
    n = max(int(i.max()) for i in indices) + 1
    row_shape = tuple(data[0].shape[indices[0].dim():])
    out = torch.zeros((n,) + row_shape, dtype=data[0].dtype,
                      device=data[0].device)
    for idx, d in zip(indices, data):
        out[idx.reshape(-1).long()] = d.reshape((-1,) + row_shape)
    return out


# ---------------------------------------------------------------------------
# Family: math specials (ref: libnd4j transforms {lgamma, digamma, ...})
# ---------------------------------------------------------------------------
def betainc(a, b, x, iters: int = 200):
    """The regularized incomplete beta I_x(a, b) in torch ops: Lentz's
    continued fraction (as scipy/Cephes evaluate it), on the side of
    x < (a+1)/(a+b+2) where it converges fast, with the symmetry
    I_x(a,b) = 1 - I_{1-x}(b,a) on the other; a fixed number of terms, so
    no host round trip."""
    dt = torch.promote_types(torch.promote_types(_fdt(_t(a)), _fdt(_t(b))),
                             _fdt(_t(x)))
    a, b, x = (v.to(dt) for v in torch.broadcast_tensors(
        _t(a), _t(b, a), _t(x, a)))
    flip = x > (a + 1.0) / (a + b + 2.0)
    aa = torch.where(flip, b, a)
    bb = torch.where(flip, a, b)
    xx = torch.where(flip, 1.0 - x, x)
    tiny = 1e-30
    lbeta = torch.lgamma(aa) + torch.lgamma(bb) - torch.lgamma(aa + bb)
    front = torch.exp(aa * torch.log(torch.clamp_min(xx, tiny))
                      + bb * torch.log1p(-xx) - lbeta) / aa
    f = torch.ones_like(xx)
    c = torch.ones_like(xx)
    d = torch.zeros_like(xx)
    for i in range(iters + 1):
        m = i // 2
        if i == 0:
            num = torch.ones_like(xx)
        elif i % 2 == 0:
            num = (m * (bb - m) * xx) / ((aa + 2.0 * m - 1.0)
                                         * (aa + 2.0 * m))
        else:
            num = -((aa + m) * (aa + bb + m) * xx) / ((aa + 2.0 * m)
                                                      * (aa + 2.0 * m + 1.0))
        d = 1.0 + num * d
        d = torch.where(torch.abs(d) < tiny, torch.full_like(d, tiny), d)
        d = 1.0 / d
        c = 1.0 + num / c
        c = torch.where(torch.abs(c) < tiny, torch.full_like(c, tiny), c)
        f = f * c * d
    res = front * (f - 1.0)
    res = torch.where(xx <= 0, torch.zeros_like(res), res)
    res = torch.where(xx >= 1, torch.ones_like(res), res)
    return torch.where(flip, 1.0 - res, res)


def polygamma(n, x):
    """psi^(n)(x) = (-1)^(n+1) n! zeta(n+1, x) for n >= 1, digamma at
    n = 0; n is a tensor (torch.polygamma takes one Python int)."""
    x = _fl(_t(x))
    n = _t(n, x).to(device=x.device, dtype=x.dtype)
    sign = torch.where(torch.remainder(n, 2) == 0, -1.0, 1.0).to(x.dtype)
    hi = sign * torch.exp(torch.lgamma(n + 1.0)) \
        * torch.special.zeta(n + 1.0, x)
    return torch.where(n == 0, torch.digamma(x), hi)


register("lgamma", torch.lgamma)
register("digamma", torch.digamma)
register("igamma", torch.special.gammainc)
register("igammac", torch.special.gammaincc)
register("erfinv", torch.erfinv)
register("betainc", betainc)
register("polygamma", polygamma)
register("zeta", torch.special.zeta)
register("log_sigmoid", F.logsigmoid)
register("logsumexp", lambda x, axis=None, keepdims=False:
         _logsumexp(x, _axes(axis), keepdims))


# single source of truth for clipping math: train/updaters.py (the
# gradientNormalization path uses the same helpers)
def _clip_ops():
    from deeplearning4j_tpu_torch.train import updaters as _upd
    register("clip_by_value", lambda x, lo, hi: torch.clamp(x, lo, hi))
    register("clip_by_norm",
             lambda x, clip_norm: _upd.clip_by_norm([x], clip_norm)[0])
    register("clip_by_global_norm",
             lambda xs, clip_norm: _upd.clip_by_global_norm(list(xs),
                                                            clip_norm))


_clip_ops()


register("is_max", lambda x: (x == torch.amax(x)).to(x.dtype))
register("listdiff", lambda x, y: x[~torch.isin(x, _t(y, x).to(x.device))])
register("square_distance", lambda x, y, axis=None:
         _sum_ax(torch.square(x - y), axis))


# ---------------------------------------------------------------------------
# Family: linalg decompositions (ref: libnd4j lup/eig/... parity_ops)
# ---------------------------------------------------------------------------
def _matrix_rank(x, tol=None):
    if tol is None:
        r = torch.linalg.matrix_rank(x)
    else:
        r = torch.linalg.matrix_rank(x, atol=float(tol), rtol=0.0)
    return r.to(torch.int32)


register("eigh", lambda x: tuple(torch.linalg.eigh(x)))
register("lu", lambda x: tuple(torch.linalg.lu(x)))
register("pinv", torch.linalg.pinv)
register("matrix_rank", _matrix_rank)
register("kron", torch.kron)
register("slogdet", lambda x: tuple(torch.linalg.slogdet(x)))
register("expm", torch.linalg.matrix_exp)
register("l2_normalize", lambda x, axis=None, eps=1e-12:
         x / torch.clamp_min(torch.sqrt(torch.sum(
             torch.square(x), dim=_dims(x, axis),
             keepdim=axis is not None)), eps))


@register("unsorted_segment_sqrt_n")
def _unsorted_segment_sqrt_n(data, segment_ids, num_segments=None):
    """sum / sqrt(count) per segment; same num_segments contract as the
    other segment ops."""
    n = _n_segments(segment_ids, num_segments)
    s_ = segment_reduce(data, segment_ids, n, "sum")
    c = segment_reduce(torch.ones(data.shape[:1], dtype=torch.float32,
                                  device=data.device), segment_ids, n, "sum")
    return s_ / torch.sqrt(torch.clamp_min(c, 1.0)).reshape(
        (-1,) + (1,) * (data.dim() - 1))


# ---------------------------------------------------------------------------
# Family: image ops (ref: libnd4j image parity_ops {adjust_contrast,
# adjust_hue, adjust_saturation, rgb_to_hsv, ...}; channels-LAST [..., 3])
# ---------------------------------------------------------------------------
def _colour(x, m):
    return x @ torch.tensor(m, dtype=x.dtype, device=x.device)


@register("adjust_contrast")
def _adjust_contrast(x, factor):
    m = torch.mean(x, dim=(-3, -2), keepdim=True)
    return (x - m) * factor + m


register("adjust_brightness", lambda x, delta: x + delta)
register("adjust_gamma", lambda x, gamma, gain=1.0:
         gain * torch.pow(x, gamma))


@register("rgb_to_grayscale")
def _rgb_to_grayscale(x):
    w = torch.tensor([0.2989, 0.587, 0.114], dtype=x.dtype, device=x.device)
    return torch.sum(x * w, dim=-1, keepdim=True)


@register("rgb_to_yuv")
def _rgb_to_yuv(x):
    return _colour(x, [[0.299, -0.14714119, 0.61497538],
                       [0.587, -0.28886916, -0.51496512],
                       [0.114, 0.43601035, -0.10001026]])


@register("yuv_to_rgb")
def _yuv_to_rgb(x):
    return _colour(x, [[1.0, 1.0, 1.0],
                       [0.0, -0.394642334, 2.03206185],
                       [1.13988303, -0.58062185, 0.0]])


@register("rgb_to_hsv")
def _rgb_to_hsv(x):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = torch.amax(x, dim=-1)
    mn = torch.amin(x, dim=-1)
    d = mx - mn
    one = torch.ones((), dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    safe = torch.where(d == 0, one, d)
    h = torch.where(
        mx == r, torch.remainder((g - b) / safe, 6.0),
        torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0)) / 6.0
    h = torch.where(d == 0, zero, h)
    s_ = torch.where(mx == 0, zero, d / torch.where(mx == 0, one, mx))
    return torch.stack([h, s_, mx], dim=-1)


def _select(conds, vals):
    """``jnp.select``: the value of the first true condition, else 0."""
    out = torch.zeros_like(vals[0])
    for c, v in zip(reversed(conds), reversed(vals)):
        out = torch.where(c, v, out)
    return out


@register("hsv_to_rgb")
def _hsv_to_rgb(x):
    h, s_, v = x[..., 0], x[..., 1], x[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s_)
    q = v * (1 - f * s_)
    t = v * (1 - (1 - f) * s_)
    i = torch.remainder(i, 6).to(torch.int32)
    cs = [i == k for k in range(6)]
    r = _select(cs, [v, q, p, p, t, v])
    g = _select(cs, [t, v, v, q, p, p])
    b = _select(cs, [p, p, t, v, v, q])
    return torch.stack([r, g, b], dim=-1)


@register("extract_image_patches")
def _extract_image_patches(x, ksize, stride=1, rate=1):
    """NHWC -> [N, oH, oW, kH*kW*C] (ref: extract_image_patches)."""
    kh, kw = (ksize, ksize) if isinstance(ksize, int) else ksize
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    n, h, w, c = x.shape
    oh = (h - (kh - 1) * rate - 1) // sh + 1
    ow = (w - (kw - 1) * rate - 1) // sw + 1
    patches = []
    for di in range(kh):
        for dj in range(kw):
            patches.append(x[:, di * rate:di * rate + oh * sh:sh,
                             dj * rate:dj * rate + ow * sw:sw, :])
    return torch.cat(patches, dim=-1)


# ---------------------------------------------------------------------------
# Family: quantization (ref: libnd4j fake_quant_with_min_max_vars etc.)
# ---------------------------------------------------------------------------
@register("fake_quant_with_min_max")
def _fake_quant(x, min_v, max_v, num_bits: int = 8):
    """ref: fake_quant_with_min_max_vars — includes the reference's range
    NUDGE so zero is exactly representable on the quantization grid
    (host-side scalar arithmetic on the Python range, as the JAX op
    traces it)."""
    levels = (1 << num_bits) - 1
    scale = (max_v - min_v) / levels
    zero_point = np.clip(np.round(np.float32(-min_v / scale)), 0, levels)
    nudged_min = float(np.float32(-zero_point * np.float32(scale)))
    nudged_max = float(np.float32((levels - zero_point) * np.float32(scale)))
    q = torch.round((torch.clamp(x, nudged_min, nudged_max) - nudged_min)
                    / scale)
    return q * scale + nudged_min


@register("quantize")
def _quantize(x, scale, zero_point=0, dtype=torch.int8):
    dt = canonical_dtype(dtype)
    info = torch.iinfo(dt)
    return torch.clamp(torch.round(x / scale) + zero_point, info.min,
                       info.max).to(dt)


register("dequantize", lambda q, scale, zero_point=0:
         (q.to(torch.float32) - zero_point) * scale)


# ---------------------------------------------------------------------------
# Family: extra losses (ref: weighted_cross_entropy_with_logits etc.)
# ---------------------------------------------------------------------------
@register("weighted_cross_entropy_with_logits")
def _weighted_ce(targets, logits, pos_weight):
    log_w = (1 + (pos_weight - 1) * targets)
    return ((1 - targets) * logits
            + log_w * (torch.log1p(torch.exp(-torch.abs(logits)))
                       + torch.clamp_min(-logits, 0)))


@register("log_poisson_loss")
def _log_poisson(targets, log_input, compute_full_loss: bool = False):
    loss = torch.exp(log_input) - log_input * targets
    if compute_full_loss:
        t1 = torch.clamp_min(targets, 1.0)
        stirling = (targets * torch.log(t1) - targets
                    + 0.5 * torch.log(2 * math.pi * t1))
        loss = loss + torch.where(targets > 1, stirling,
                                  torch.zeros_like(stirling))
    return loss


@register("batch_gather")
def _batch_gather(params, indices):
    """ref: batch_gather — indices [batch, m] of rank params.ndim-1 select
    along axis 1; trailing dims broadcast."""
    idx = _long(indices, params)
    while idx.dim() < params.dim():
        idx = idx[..., None]
    idx = idx.expand(tuple(idx.shape[:2]) + tuple(params.shape[2:]))
    return torch.gather(params, 1, idx)


@register("mirror_pad")
def _mirror_pad(x, paddings, mode: str = "REFLECT"):
    return _pad(x, [tuple(p) for p in paddings],
                mode="reflect" if str(mode).upper() == "REFLECT"
                else "symmetric")


# extension families (scatter_nd, ctc, updater ops, image extras, ...)
# registered for side effects — keeps this module the single entry point
from deeplearning4j_tpu_torch.ops import registry_ext as _ext  # noqa: E402,F401
from deeplearning4j_tpu_torch.ops import registry_r5 as _r5  # noqa: E402,F401


# meta info
def summary() -> str:
    return f"{len(_REGISTRY)} ops registered, {len(_PLATFORM_OVERRIDES)} platform overrides"
