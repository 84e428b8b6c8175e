"""Eager NDArray — the INDArray equivalent over a ``torch.Tensor`` (the
port of ``deeplearning4j_tpu/linalg/ndarray.py``).

Reference parity: ``org.nd4j.linalg.api.ndarray.INDArray`` /
``BaseNDArray`` (~300 methods; views, in-place ``*i`` variants,
broadcasting, ``mmul``).

The JAX class's semantics, kept on torch:

- **Buffers are values.** An NDArray never writes into a tensor: every
  "in-place" ``*i`` method computes a new tensor and installs it as the
  wrapper's buffer, so ``x.addi(y)`` mutates ``x`` as seen by every holder
  of the same NDArray object, and by nobody else. A tensor that torch
  returns as an alias of another (``reshape``, ``permute``, ``broadcast``,
  ``dup``) is therefore never observed changing: those methods give
  detached arrays, as the JAX ones do. :meth:`tensor` (also under the JAX
  class's name, :meth:`jax`) hands out the buffer itself; treat it as
  read-only.
- **Views** (``getRow``, ``getColumn``, ``slice_``, ``__getitem__``, the
  JAX class's write-back views) read through their base at every access
  and never snapshot; writing one installs a new base buffer with the
  region replaced (a functional ``index_put``, as the JAX ``.at[].set``).
- **dtypes are the JAX package's without x64**: a buffer of float64,
  int64, uint64 or complex128 is narrowed to its 32-bit type
  (``dtypes.canonical``), so sums of ints are int32, ``argMax`` is int32
  and ``castTo(DOUBLE)`` gives float32.
- **Device.** An array lives on the device of the tensor it was made
  from. One made from host data (numpy, lists, scalars) goes to
  ``device`` (``device.resolve_device``: ``cuda`` unless the caller names
  the CPU). Host operands of a binary op go to the array's device.
"""

from __future__ import annotations

import builtins
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.linalg.dtypes import DataType, canonical

Index = Union[int, slice, tuple, "NDArray", torch.Tensor]


def _canon(t: torch.Tensor) -> torch.Tensor:
    dt = canonical(t.dtype)
    return t if dt == t.dtype else t.to(dt)


def _host_tensor(value, device) -> torch.Tensor:
    """Host data (numpy, lists, scalars) as a tensor on ``device``, with
    the JAX package's dtypes."""
    if isinstance(value, np.generic):
        value = np.asarray(value)
    arr = np.asarray(value)
    if arr.dtype == object:
        raise TypeError(f"cannot make an array of {type(value).__name__}")
    return _canon(torch.as_tensor(arr, device=device))


def _unwrap(x):
    if isinstance(x, NDArray):
        return x._value
    return x


def _operand(o, like: torch.Tensor):
    """An operand for an op on ``like``: NDArrays and tensors as they are,
    Python scalars kept weakly typed, host arrays on ``like``'s device."""
    o = _unwrap(o)
    if isinstance(o, torch.Tensor) or isinstance(o, (bool, int, float)):
        return o
    if isinstance(o, np.generic):
        return o.item()
    return _host_tensor(o, like.device)


def _index(idx):
    if isinstance(idx, tuple):
        return tuple(_unwrap(i) for i in idx)
    return _unwrap(idx)


def _index_set(t: torch.Tensor, idx, value) -> torch.Tensor:
    """``t`` with ``t[idx]`` replaced by ``value``, as a new tensor (the
    JAX ``t.at[idx].set(value)``)."""
    out = t.clone(memory_format=torch.contiguous_format)
    out[idx] = value
    return out


def _axes(v: torch.Tensor, dims) -> Optional[Tuple[int, ...]]:
    if not dims:
        return None
    return tuple(d if d >= 0 else d + v.dim() for d in dims)


def _all(v: torch.Tensor, axis) -> Tuple[int, ...]:
    return tuple(range(v.dim())) if axis is None else tuple(axis)


def _as_float(v: torch.Tensor) -> torch.Tensor:
    return v if v.is_floating_point() or v.is_complex() else v.float()


def _flat_axes(v: torch.Tensor, axis):
    """Move ``axis`` (None = all) to the end and flatten it into one:
    (tensor [..., n], the kept shape)."""
    axis = _all(v, axis)
    other = tuple(d for d in range(v.dim()) if d not in axis)
    moved = v.permute(*(other + axis)) if v.dim() else v.reshape(1)
    kept = tuple(v.shape[d] for d in other)
    return moved.reshape(kept + (-1,)), kept


def _sum(v, axis=None, keepdims=False):
    return torch.sum(v, dim=_all(v, axis), keepdim=keepdims)


def _mean(v, axis=None, keepdims=False):
    return torch.mean(_as_float(v), dim=_all(v, axis), keepdim=keepdims)


def _amax(v, axis=None, keepdims=False):
    return torch.amax(v, dim=_all(v, axis), keepdim=keepdims)


def _amin(v, axis=None, keepdims=False):
    return torch.amin(v, dim=_all(v, axis), keepdim=keepdims)


def _prod(v, axis=None, keepdims=False):
    flat, kept = _flat_axes(v, axis)
    out = torch.prod(flat, dim=-1)
    if keepdims:
        out = out.reshape(tuple(1 if d in _all(v, axis) else s
                                for d, s in enumerate(v.shape)))
    return out


def _var(v, axis=None, keepdims=False, ddof=0):
    return torch.var(_as_float(v), dim=_all(v, axis), correction=ddof,
                     keepdim=keepdims)


def _std(v, axis=None, keepdims=False, ddof=0):
    return torch.std(_as_float(v), dim=_all(v, axis), correction=ddof,
                     keepdim=keepdims)


def _quantile(v, q: float, axis=None):
    """``jnp.percentile(v, 100 q, axis)`` with linear interpolation (also
    ``jnp.median`` at q = 0.5: the mean of the two middle values)."""
    flat, kept = _flat_axes(_as_float(v), axis)
    return torch.quantile(flat, float(q), dim=-1).reshape(kept)


def _cbrt(v):
    v = _as_float(v)
    return torch.sign(v) * torch.abs(v).pow(1.0 / 3.0)


class NDArray:
    """Device ndarray with INDArray-style API over a ``torch.Tensor``."""

    __slots__ = ("_buf", "_base", "_index")
    __array_priority__ = 100  # beat numpy in mixed binary ops

    def __init__(self, value, base: Optional["NDArray"] = None,
                 index: Optional[Index] = None, *, device=None):
        if base is None:
            if isinstance(value, NDArray):
                value = value._value
            if isinstance(value, torch.Tensor):
                value = value.detach()
                if device is not None:
                    value = value.to(resolve_device(device))
                self._buf = _canon(value)
            else:
                self._buf = _host_tensor(value, resolve_device(device))
        else:
            self._buf = None  # views read through to the base, never snapshot
        self._base = base
        self._index = index

    # ------------------------------------------------------------------ core
    @property
    def _value(self) -> torch.Tensor:
        if self._base is not None:
            return self._base._value[self._index]
        return self._buf

    def tensor(self) -> torch.Tensor:
        """The backing tensor (read-only by convention: see the module
        docstring)."""
        return self._value

    def numpy(self) -> np.ndarray:
        v = self._value.detach()
        if v.dtype == torch.bfloat16:
            v = v.float()
        return v.cpu().numpy()

    @property
    def device(self) -> torch.device:
        return self._value.device

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._value.shape)

    @property
    def dtype(self) -> DataType:
        return DataType.from_dtype(self._value.dtype)

    def dataType(self) -> DataType:
        return self.dtype

    def rank(self) -> int:
        return self._value.dim()

    def length(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    def size(self, dim: int) -> int:
        return self.shape[dim]

    def isView(self) -> bool:
        return self._base is not None

    def isScalar(self) -> bool:
        return self._value.dim() == 0 or self.length() == 1

    def isVector(self) -> bool:
        return self.rank() == 1 or (self.rank() == 2 and 1 in self.shape)

    def isMatrix(self) -> bool:
        return self.rank() == 2

    def rows(self) -> int:
        return self.shape[0]

    def columns(self) -> int:
        return self.shape[1]

    # --------------------------------------------------------- mutation core
    def _set_value(self, new) -> "NDArray":
        """Install a new buffer; propagate to the base if this is a view."""
        cur = self._value
        if not isinstance(new, torch.Tensor):
            new = _operand(new, cur)
            new = torch.as_tensor(new, device=cur.device)
        if new.dtype != cur.dtype:
            new = new.to(cur.dtype)
        if tuple(new.shape) != tuple(cur.shape):
            raise ValueError(
                f"in-place op cannot change shape: {tuple(cur.shape)} -> "
                f"{tuple(new.shape)}")
        if self._base is not None:
            self._base._set_value(_index_set(self._base._value, self._index,
                                             new))
        else:
            self._buf = new
        return self

    def _full(self, value) -> torch.Tensor:
        """``value`` as a tensor of self's dtype broadcast to its shape."""
        v = self._value
        o = _operand(value, v)
        o = torch.as_tensor(o, dtype=v.dtype, device=v.device) \
            if not isinstance(o, torch.Tensor) else o.to(v.dtype)
        return torch.broadcast_to(o, v.shape)

    def assign(self, other) -> "NDArray":
        """In-place overwrite (ref: INDArray.assign)."""
        return self._set_value(self._full(other))

    # -------------------------------------------------------------- elementwise
    def _binary(self, other, fn, inplace: bool = False) -> "NDArray":
        v = self._value
        res = fn(v, _operand(other, v))
        if inplace:
            return self._set_value(res)
        return NDArray(res)

    def add(self, o):  return self._binary(o, torch.add)
    def sub(self, o):  return self._binary(o, torch.sub)
    def mul(self, o):  return self._binary(o, torch.mul)
    def div(self, o):  return self._binary(o, torch.true_divide)
    def rsub(self, o): return self._binary(o, lambda a, b: b - a)
    def rdiv(self, o): return self._binary(o, lambda a, b: b / a)
    def addi(self, o): return self._binary(o, torch.add, inplace=True)
    def subi(self, o): return self._binary(o, torch.sub, inplace=True)
    def muli(self, o): return self._binary(o, torch.mul, inplace=True)
    def divi(self, o): return self._binary(o, torch.true_divide, inplace=True)

    __add__ = add
    __sub__ = sub
    __mul__ = mul
    __truediv__ = div
    __radd__ = add
    __rmul__ = mul
    def __rsub__(self, o): return self.rsub(o)
    def __rtruediv__(self, o): return self.rdiv(o)
    def __neg__(self): return NDArray(-self._value)
    def __pow__(self, p): return NDArray(self._value ** _operand(p, self._value))
    def __matmul__(self, o): return self.mmul(o)

    def neg(self): return NDArray(-self._value)
    def negi(self): return self._set_value(-self._value)

    # comparison → BOOL arrays (ref: INDArray.gt/lt/eq...)
    def gt(self, o): return self._binary(o, torch.gt)
    def gte(self, o): return self._binary(o, torch.ge)
    def lt(self, o): return self._binary(o, torch.lt)
    def lte(self, o): return self._binary(o, torch.le)
    def eq(self, o): return self._binary(o, torch.eq)
    def neq(self, o): return self._binary(o, torch.ne)

    # ------------------------------------------------------------- linalg
    def mmul(self, other, transpose_a: bool = False,
             transpose_b: bool = False) -> "NDArray":
        """Matrix multiply (ref: INDArray.mmul → BLAS GEMM): one
        ``torch.matmul``, cuBLAS on the card, in the operands' dtype."""
        a, b = self._value, _operand(other, self._value)
        if transpose_a:
            a = a.transpose(-1, -2)
        if transpose_b:
            b = b.transpose(-1, -2)
        return NDArray(torch.matmul(a, b))

    def dot(self, other) -> float:
        a = self._value.reshape(-1)
        b = torch.as_tensor(_operand(other, self._value)).reshape(-1)
        return float(torch.sum(a * b))

    def transpose(self, *axes) -> "NDArray":
        """No-args form reverses ALL dimensions (ref: INDArray.transpose)."""
        v = self._value
        if not axes:
            return NDArray(v.permute(*range(v.dim() - 1, -1, -1)))
        return NDArray(v.permute(*axes))

    def permute(self, *axes) -> "NDArray":
        return NDArray(self._value.permute(*axes))

    # ------------------------------------------------------------- reductions
    def _reduce(self, fn, dims, keepdims=False):
        v = self._value
        return NDArray(fn(v, axis=_axes(v, dims), keepdims=keepdims))

    def sum(self, *dims, keepdims=False):  return self._reduce(_sum, dims, keepdims)
    def mean(self, *dims, keepdims=False): return self._reduce(_mean, dims, keepdims)
    def max(self, *dims, keepdims=False):  return self._reduce(_amax, dims, keepdims)
    def min(self, *dims, keepdims=False):  return self._reduce(_amin, dims, keepdims)
    def prod(self, *dims, keepdims=False): return self._reduce(_prod, dims, keepdims)

    def std(self, *dims, keepdims=False):
        return self._reduce(lambda v, axis, keepdims: _std(
            v, axis, keepdims, ddof=1), dims, keepdims)

    def var(self, *dims, keepdims=False):
        return self._reduce(lambda v, axis, keepdims: _var(
            v, axis, keepdims, ddof=1), dims, keepdims)

    def _arg_reduce(self, fn, dims):
        """argMax/argMin over one or MORE dims (ref: INDArray.argMax(int...)):
        the given dims are flattened into one plane and the flat index within
        that plane is returned."""
        v = self._value
        if not dims:
            return NDArray(fn(v.reshape(-1), dim=0))
        dims = tuple(sorted(d if d >= 0 else d + v.dim() for d in dims))
        if len(dims) == 1:
            return NDArray(fn(v, dim=dims[0]))
        flat, _ = _flat_axes(v, dims)
        return NDArray(fn(flat, dim=-1))

    def argMax(self, *dims):
        return self._arg_reduce(torch.argmax, dims)

    def argMin(self, *dims):
        return self._arg_reduce(torch.argmin, dims)

    def norm1(self, *dims):
        return self._reduce(lambda v, axis, keepdims: _sum(
            torch.abs(v), axis, keepdims), dims)

    def norm2(self, *dims):
        return self._reduce(lambda v, axis, keepdims: torch.sqrt(
            _sum(v * v, axis, keepdims)), dims)

    def normMax(self, *dims):
        return self._reduce(lambda v, axis, keepdims: _amax(
            torch.abs(v), axis, keepdims), dims)

    def sumNumber(self) -> float:  return float(_sum(self._value))
    def meanNumber(self) -> float: return float(_mean(self._value))
    def maxNumber(self) -> float:  return float(_amax(self._value))
    def minNumber(self) -> float:  return float(_amin(self._value))

    def norm2Number(self) -> float:
        v = self._value
        return float(torch.sqrt(_sum(v * v)))

    def norm1Number(self) -> float:
        return float(_sum(torch.abs(self._value)))

    def cumsum(self, dim: int = 0):
        return NDArray(torch.cumsum(self._value, dim=dim))

    # ------------------------------------------------------------- shape ops
    def reshape(self, *shape) -> "NDArray":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return NDArray(torch.reshape(self._value, shape))

    def ravel(self) -> "NDArray":
        return NDArray(self._value.reshape(-1))

    def flatten(self) -> "NDArray":
        return self.ravel()

    def broadcast(self, *shape) -> "NDArray":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return NDArray(torch.broadcast_to(self._value, shape))

    def repeat(self, dim: int, n: int) -> "NDArray":
        return NDArray(torch.repeat_interleave(self._value, n, dim=dim))

    def tile(self, *reps) -> "NDArray":
        return NDArray(torch.tile(self._value, reps))

    def squeeze(self, axis=None) -> "NDArray":
        v = self._value
        return NDArray(v.squeeze() if axis is None else v.squeeze(axis))

    def expandDims(self, axis: int) -> "NDArray":
        return NDArray(self._value.unsqueeze(axis))

    def dup(self) -> "NDArray":
        """Detached copy (ref: INDArray.dup): the buffer is shared and,
        like every buffer, never written."""
        return NDArray(self._value)

    def castTo(self, dtype: DataType) -> "NDArray":
        return NDArray(self._value.to(dtype.torch))

    # ------------------------------------------------------------- indexing
    def __getitem__(self, idx) -> "NDArray":
        return NDArray(None, base=self, index=_index(idx))

    def __setitem__(self, idx, value) -> None:
        idx = _index(idx)
        v = self._value
        o = _operand(value, v)
        o = o.to(v.dtype) if isinstance(o, torch.Tensor) else torch.as_tensor(
            o, dtype=v.dtype, device=v.device)
        self._set_value(_index_set(v, idx, o))

    def getRow(self, i: int) -> "NDArray":
        return self[i]

    def getColumn(self, i: int) -> "NDArray":
        return self[:, i]

    def putRow(self, i: int, row) -> "NDArray":
        self[i] = row
        return self

    def putColumn(self, i: int, col) -> "NDArray":
        self[:, i] = col
        return self

    def getScalar(self, *indices) -> float:
        return float(self._value[tuple(indices)])

    def getDouble(self, *indices) -> float:
        return float(self._value[tuple(indices)])

    def getInt(self, *indices) -> int:
        return int(self._value[tuple(indices)])

    def putScalar(self, *args) -> "NDArray":
        *indices, value = args
        if len(indices) == 1 and isinstance(indices[0], (tuple, list)):
            indices = list(indices[0])
        self[tuple(indices)] = value
        return self

    def slice_(self, i: int, dim: int = 0) -> "NDArray":
        idx = (builtins.slice(None),) * dim + (i,)
        return self[idx]

    def tensorAlongDimension(self, index: int, *dims) -> "NDArray":
        """TAD equivalent — kept only for API familiarity; a permute +
        reshape + index giving a detached array, as the JAX class's."""
        v = self._value
        dims = tuple(d if d >= 0 else d + v.dim() for d in dims)
        other = tuple(d for d in range(v.dim()) if d not in dims)
        moved = v.permute(*(other + dims))
        lead = int(np.prod([v.shape[d] for d in other])) if other else 1
        moved = moved.reshape((lead,) + tuple(v.shape[d] for d in dims))
        return NDArray(moved[index])

    # ------------------------------------------------------------- misc math
    def _unary(self, fn, inplace=False):
        res = fn(self._value)
        return self._set_value(res) if inplace else NDArray(res)

    def abs(self):   return self._unary(torch.abs)
    def exp(self):   return self._unary(torch.exp)
    def log(self):   return self._unary(torch.log)
    def sqrt(self):  return self._unary(torch.sqrt)
    def tanh(self):  return self._unary(torch.tanh)
    def sigmoid(self): return self._unary(torch.sigmoid)
    def relu(self):  return self._unary(torch.relu)
    def sin(self):   return self._unary(torch.sin)
    def cos(self):   return self._unary(torch.cos)
    def floor(self): return self._unary(torch.floor)
    def ceil(self):  return self._unary(torch.ceil)
    def round(self): return self._unary(torch.round)
    def sign(self):  return self._unary(torch.sign)
    def clip(self, lo, hi): return self._unary(lambda v: torch.clamp(v, lo, hi))

    # ------------------------------------------------------------- protocol
    def __len__(self) -> int:
        return self.shape[0] if self.shape else 1

    def __float__(self) -> float:
        return float(self._value)

    def __int__(self) -> int:
        return int(self._value)

    def __bool__(self) -> bool:
        if self.length() != 1:
            raise ValueError("Truth value of multi-element NDArray is ambiguous")
        return bool(self._value)

    def __repr__(self) -> str:
        return (f"NDArray(shape={self.shape}, dtype={self.dtype.name}, "
                f"device={self.device})\n{self.numpy()!r}")

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def equalsWithEps(self, other, eps: float = 1e-5) -> bool:
        o = _operand(other, self._value)
        o = torch.as_tensor(o, device=self._value.device)
        if tuple(o.shape) != self.shape:
            return False
        return bool(torch.all(torch.abs(self._value.float() - o.float()) <= eps))

    def equals(self, other) -> bool:
        return self.equalsWithEps(other, 1e-5)


#: the JAX class's name for the buffer accessor
NDArray.jax = NDArray.tensor


# ---------------------------------------------------------------------------
# the rest of the INDArray surface: row/column-vector broadcast ops with
# i-variants, absolute reductions, distances, entropy family,
# cumulative/product ops, axis utilities, conversions. i-variants install
# the new buffer via _set_value (write-through for views).
# ---------------------------------------------------------------------------

def _rowvec(o, like):
    return torch.as_tensor(_operand(o, like), device=like.device).reshape(1, -1)


def _colvec(o, like):
    return torch.as_tensor(_operand(o, like), device=like.device).reshape(-1, 1)


def _like_self(v, res):
    """Broadcast results keep self's shape when sizes match (a 1-D row
    operand against a 1-D self must not grow a leading axis)."""
    return res.reshape(v.shape) if res.numel() == v.numel() else res


def _need2d(self):
    if self._value.dim() < 2:
        raise ValueError(
            "column-vector ops need a matrix self (a 1-D array against "
            "a column vector would outer-broadcast)")


def _vector_op(fn, vec, inplace, column):
    def m(self, o):
        if column:
            _need2d(self)
        v = self._value
        res = _like_self(v, fn(v, vec(o, v)))
        return self._set_value(res) if inplace else NDArray(res)
    return m


def _add_vector_methods():
    ops = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
           "div": torch.true_divide, "rsub": lambda a, b: b - a,
           "rdiv": lambda a, b: b / a}
    for name, fn in ops.items():
        setattr(NDArray, f"{name}RowVector", _vector_op(fn, _rowvec, False, False))
        setattr(NDArray, f"{name}iRowVector", _vector_op(fn, _rowvec, True, False))
        setattr(NDArray, f"{name}ColumnVector", _vector_op(fn, _colvec, False, True))
        setattr(NDArray, f"{name}iColumnVector", _vector_op(fn, _colvec, True, True))


_add_vector_methods()


def _extend(cls):
    """Install the function as a method of ``cls`` (and keep it out of the
    module namespace, where names like ``slice`` and ``all`` would shadow
    the builtins)."""
    def deco(fn):
        setattr(cls, fn.__name__, fn)
    return deco


@_extend(NDArray)
def mmuli(self, other):
    return self._set_value(self.mmul(other)._value)


@_extend(NDArray)
def rsubi(self, o):
    return self._binary(o, lambda a, b: b - a, inplace=True)


@_extend(NDArray)
def rdivi(self, o):
    return self._binary(o, lambda a, b: b / a, inplace=True)


@_extend(NDArray)
def fmod(self, o):
    return self._binary(o, torch.fmod)


@_extend(NDArray)
def fmodi(self, o):
    return self._binary(o, torch.fmod, inplace=True)


@_extend(NDArray)
def remainder(self, o):
    return self._binary(o, torch.remainder)


# absolute-value reductions (ref: amax/amin/amean + *Number variants)
@_extend(NDArray)
def amax(self, *dims):
    return self._reduce(lambda v, axis, keepdims: _amax(
        torch.abs(v), axis, keepdims), dims)


@_extend(NDArray)
def amin(self, *dims):
    return self._reduce(lambda v, axis, keepdims: _amin(
        torch.abs(v), axis, keepdims), dims)


@_extend(NDArray)
def amean(self, *dims):
    return self._reduce(lambda v, axis, keepdims: _mean(
        torch.abs(v), axis, keepdims), dims)


@_extend(NDArray)
def amaxNumber(self):
    return float(_amax(torch.abs(self._value)))


@_extend(NDArray)
def aminNumber(self):
    return float(_amin(torch.abs(self._value)))


@_extend(NDArray)
def ameanNumber(self):
    return float(_mean(torch.abs(self._value)))


@_extend(NDArray)
def prodNumber(self):
    return float(_prod(self._value))


@_extend(NDArray)
def stdNumber(self):
    return float(_std(self._value, ddof=1))


@_extend(NDArray)
def varNumber(self):
    return float(_var(self._value, ddof=1))


@_extend(NDArray)
def medianNumber(self):
    return float(_quantile(self._value, 0.5))


@_extend(NDArray)
def median(self, *dims):
    return self._reduce(lambda v, axis, keepdims: _quantile(v, 0.5, axis),
                        dims)


@_extend(NDArray)
def percentile(self, q, *dims):
    if not dims:
        return float(_quantile(self._value, q / 100.0))
    return self._reduce(lambda v, axis, keepdims: _quantile(
        v, q / 100.0, axis), dims)


def _diff(self, other):
    return self._value - _operand(other, self._value)


# distances (ref: INDArray.distance1/distance2/squaredDistance)
@_extend(NDArray)
def distance1(self, other) -> float:
    return float(_sum(torch.abs(_diff(self, other))))


@_extend(NDArray)
def distance2(self, other) -> float:
    d = _diff(self, other)
    return float(torch.sqrt(_sum(d * d)))


@_extend(NDArray)
def squaredDistance(self, other) -> float:
    d = _diff(self, other)
    return float(_sum(d * d))


# entropy family (ref: INDArray.entropy/shannonEntropy/logEntropy)
@_extend(NDArray)
def entropy(self) -> float:
    p = self._value
    return float(-_sum(p * torch.log(torch.clamp_min(p, 1e-12))))


@_extend(NDArray)
def shannonEntropy(self) -> float:
    p = self._value
    return float(-_sum(p * torch.log2(torch.clamp_min(p, 1e-12))))


@_extend(NDArray)
def logEntropy(self) -> float:
    return float(math.log(builtins.max(self.entropy(), 1e-12)))


@_extend(NDArray)
def cumprod(self, dim: int = 0):
    return NDArray(torch.cumprod(self._value, dim=dim))


@_extend(NDArray)
def cumsumi(self, dim: int = 0):
    return self._set_value(torch.cumsum(self._value, dim=dim))


@_extend(NDArray)
def swapAxes(self, a: int, b: int):
    return NDArray(self._value.transpose(a, b))


@_extend(NDArray)
def reverse(self, *dims):
    v = self._value
    return NDArray(torch.flip(v, dims=dims if dims else tuple(range(v.dim()))))


@_extend(NDArray)
def sort(self, dim: int = -1, ascending: bool = True):
    out = torch.sort(self._value, dim=dim, stable=True).values
    return NDArray(out if ascending else torch.flip(out, dims=(dim,)))


@_extend(NDArray)
def put(self, idx, value):
    """General indexed write (ref: INDArray.put)."""
    self[idx] = value
    return self


@_extend(NDArray)
def putWhere(self, mask, value):
    v = self._value
    m = torch.as_tensor(_operand(mask, v), device=v.device).to(torch.bool)
    return self._set_value(torch.where(m, self._full(value), v))


@_extend(NDArray)
def replaceWhere(self, replacement, condition):
    """ref: BooleanIndexing.replaceWhere(this, replacement, condition)."""
    from deeplearning4j_tpu_torch.linalg.conditions import Condition
    v = self._value
    m = condition.mask(v) if isinstance(condition, Condition) \
        else torch.as_tensor(_operand(condition, v),
                             device=v.device).to(torch.bool)
    return self._set_value(torch.where(m, self._full(replacement), v))


@_extend(NDArray)
def isNaN(self):
    return NDArray(torch.isnan(self._value))


@_extend(NDArray)
def isInfinite(self):
    return NDArray(torch.isinf(self._value))


@_extend(NDArray)
def any(self) -> bool:
    return bool(torch.any(self._value))


@_extend(NDArray)
def all(self) -> bool:
    return bool(torch.all(self._value))


@_extend(NDArray)
def none(self) -> bool:
    return not self.any()


# boolean combinators over condition masks / bool arrays
@_extend(NDArray)
def and_(self, o):
    return self._binary(o, torch.logical_and)


@_extend(NDArray)
def or_(self, o):
    return self._binary(o, torch.logical_or)


@_extend(NDArray)
def xor_(self, o):
    return self._binary(o, torch.logical_xor)


@_extend(NDArray)
def not_(self):
    return NDArray(torch.logical_not(self._value))


# host conversions (ref: toDoubleMatrix/toFloatVector/... )
@_extend(NDArray)
def toDoubleMatrix(self):
    return np.asarray(self.numpy(), np.float64)


@_extend(NDArray)
def toFloatMatrix(self):
    return np.asarray(self.numpy(), np.float32)


@_extend(NDArray)
def toDoubleVector(self):
    return np.asarray(self.numpy(), np.float64).reshape(-1)


@_extend(NDArray)
def toFloatVector(self):
    return np.asarray(self.numpy(), np.float32).reshape(-1)


@_extend(NDArray)
def toIntVector(self):
    return np.asarray(self.numpy(), np.int32).reshape(-1)


@_extend(NDArray)
def toIntMatrix(self):
    return np.asarray(self.numpy(), np.int32)


# layout: logical C-order (torch's strides of a view are not the array's)
@_extend(NDArray)
def stride(self, dim=None):
    """Logical C-order element strides (pure shape arithmetic, no host
    transfer)."""
    st = []
    acc = 1
    for d in reversed(self.shape):
        st.append(acc)
        acc *= d
    st = tuple(reversed(st))
    return st if dim is None else st[dim]


@_extend(NDArray)
def ordering(self) -> str:
    return "c"


@_extend(NDArray)
def maxIndex(self) -> int:
    return int(torch.argmax(self._value.reshape(-1)))


@_extend(NDArray)
def minIndex(self) -> int:
    return int(torch.argmin(self._value.reshape(-1)))


# ---------------------------------------------------------------------------
# the ~300-method INDArray interface: generated families (the inventory test
# holds the method list against the JAX class's)
# ---------------------------------------------------------------------------

def _hard_tanh(v):
    return torch.clamp(v, -1.0, 1.0)


def _leaky(v):
    return torch.where(v >= 0, v, 0.01 * v)


def _add_transform_methods():
    # -- elementwise transform family (ref: Transforms.* instance forms) --
    unaries = {
        "tan": torch.tan, "asin": torch.asin, "acos": torch.acos,
        "atan": torch.atan, "sinh": torch.sinh, "cosh": torch.cosh,
        "asinh": torch.asinh, "acosh": torch.acosh, "atanh": torch.atanh,
        "log10": torch.log10, "log2": torch.log2, "log1p": torch.log1p,
        "expm1": torch.expm1, "cbrt": _cbrt, "rsqrt": torch.rsqrt,
        "reciprocal": torch.reciprocal, "erf": torch.special.erf,
        "erfc": torch.special.erfc, "rint": torch.round,
        "trunc": torch.trunc, "square": torch.square,
        "cube": lambda v: v * v * v, "oneMinus": lambda v: 1.0 - v,
        "frac": lambda v: v - torch.trunc(v),
        "softplus": lambda v: torch.logaddexp(v, torch.zeros_like(v)),
        "softsign": F.softsign,
        "elu": F.elu, "selu": F.selu,
        "gelu": lambda v: F.gelu(v, approximate="tanh"),
        "swish": F.silu, "mish": F.mish,
        "hardSigmoid": F.hardsigmoid,
        "hardTanh": _hard_tanh,
        "leakyRelu": _leaky,
    }
    for name, fn in unaries.items():
        setattr(NDArray, name,
                (lambda _f: lambda self: self._unary(_f))(fn))
        setattr(NDArray, name + "i",
                (lambda _f: lambda self: self._unary(_f, inplace=True))(fn))

    # -- in-place comparison family (ref: eqi/neqi/gti/lti/gtei/ltei write
    # 0/1 into self, keeping self's dtype) --
    comps = {"eqi": torch.eq, "neqi": torch.ne, "gti": torch.gt,
             "gtei": torch.ge, "lti": torch.lt, "ltei": torch.le}
    for name, fn in comps.items():
        setattr(NDArray, name, (lambda _f: lambda self, o: self._set_value(
            _f(self._value, _operand(o, self._value))))(fn))


_add_transform_methods()


@_extend(NDArray)
def pow(self, p) -> "NDArray":
    return NDArray(self._value ** _operand(p, self._value))


@_extend(NDArray)
def powi(self, p) -> "NDArray":
    return self._set_value(self._value ** _operand(p, self._value))


@_extend(NDArray)
def remainderi(self, o) -> "NDArray":
    return self._binary(o, torch.remainder, inplace=True)


@_extend(NDArray)
def cumprodi(self, dim: int = 0) -> "NDArray":
    return self._set_value(torch.cumprod(self._value, dim=dim))


@_extend(NDArray)
def argsort(self, dim: int = -1, descending: bool = False) -> "NDArray":
    """Stable ascending order, reversed for ``descending`` (the JAX
    class's ``flip(argsort)``: among equal values the last comes first)."""
    idx = torch.argsort(self._value, dim=dim, stable=True)
    return NDArray(torch.flip(idx, dims=(dim,)) if descending else idx)


@_extend(NDArray)
def isMax(self) -> "NDArray":
    """1.0 where the (global) max lives (ref: isMax op)."""
    v = self._value
    return NDArray((v == _amax(v)).to(v.dtype))


@_extend(NDArray)
def logSumExp(self, *dims) -> "NDArray":
    v = self._value
    return NDArray(torch.logsumexp(_as_float(v), dim=_all(v, dims or None)))


# -- matrix helpers --
@_extend(NDArray)
def diag(self) -> "NDArray":
    """Vector -> diagonal matrix; matrix -> diagonal vector (ref: Nd4j.diag)."""
    return NDArray(torch.diag(self._value))


@_extend(NDArray)
def trace(self) -> float:
    return float(torch.trace(self._value))


@_extend(NDArray)
def outer(self, other) -> "NDArray":
    o = torch.as_tensor(_operand(other, self._value), device=self.device)
    return NDArray(torch.outer(self._value.reshape(-1), o.reshape(-1)))


def _moment(v, dims, power, shift):
    axis = tuple(dims) if dims else None
    v = _as_float(v)
    m = _mean(v, axis, keepdims=True)
    s = _std(v, axis, keepdims=True)
    return _mean(((v - m) / s) ** power, axis) - shift


# -- stats --
@_extend(NDArray)
def skewness(self, *dims) -> "NDArray":
    return NDArray(_moment(self._value, dims, 3, 0.0))


@_extend(NDArray)
def kurtosis(self, *dims) -> "NDArray":
    return NDArray(_moment(self._value, dims, 4, 3.0))


@_extend(NDArray)
def normMaxNumber(self) -> float:
    return float(_amax(torch.abs(self._value)))


# -- shape / layout --
def _reinstall(self, new) -> "NDArray":
    """Swap the buffer allowing a SHAPE change — only for non-views
    (reshapei/transposei/permutei; a view's footprint in its base is
    fixed)."""
    if self._base is not None:
        raise ValueError("cannot reshape/transpose a view in place")
    self._buf = new
    return self


@_extend(NDArray)
def reshapei(self, *shape) -> "NDArray":
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    return _reinstall(self, torch.reshape(self._value, shape))


@_extend(NDArray)
def transposei(self) -> "NDArray":
    v = self._value
    return _reinstall(self, v.permute(*range(v.dim() - 1, -1, -1)))


@_extend(NDArray)
def permutei(self, *axes) -> "NDArray":
    return _reinstall(self, self._value.permute(*axes))


@_extend(NDArray)
def moveAxis(self, src: int, dst: int) -> "NDArray":
    return NDArray(torch.movedim(self._value, src, dst))


@_extend(NDArray)
def repmat(self, *reps) -> "NDArray":
    """ref: INDArray.repmat — tile like MATLAB repmat."""
    return NDArray(torch.tile(self._value, reps))


@_extend(NDArray)
def broadcastTo(self, *shape) -> "NDArray":
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        shape = tuple(shape[0])
    return NDArray(torch.broadcast_to(self._value, shape))


# -- is-checks --
@_extend(NDArray)
def isRowVector(self) -> bool:
    return self.rank() == 1 or (self.rank() == 2 and self.shape[0] == 1)


@_extend(NDArray)
def isColumnVector(self) -> bool:
    return self.rank() == 2 and self.shape[1] == 1


@_extend(NDArray)
def isSquare(self) -> bool:
    return self.rank() == 2 and self.shape[0] == self.shape[1]


@_extend(NDArray)
def isEmpty(self) -> bool:
    return self.length() == 0


# -- scalar getters / conversions --
@_extend(NDArray)
def getFloat(self, *idx) -> float:
    return float(self._value[idx if len(idx) > 1 else idx[0]])


@_extend(NDArray)
def getLong(self, *idx) -> int:
    return int(self._value[idx if len(idx) > 1 else idx[0]])


@_extend(NDArray)
def toLongVector(self):
    return self.numpy().astype(np.int64).reshape(-1)


@_extend(NDArray)
def toLongMatrix(self):
    return self.numpy().astype(np.int64)


@_extend(NDArray)
def toByteVector(self):
    return self.numpy().astype(np.int8).reshape(-1)


@_extend(NDArray)
def data(self):
    """Flat host copy of the buffer (ref: INDArray.data())."""
    return self.numpy().reshape(-1)


# -- rows/columns/put --
def _index_tensor(ix, like):
    return torch.as_tensor(list(ix), dtype=torch.long, device=like.device)


@_extend(NDArray)
def getRows(self, *rows) -> "NDArray":
    v = self._value
    return NDArray(v[_index_tensor(rows, v)])


@_extend(NDArray)
def getColumns(self, *cols) -> "NDArray":
    v = self._value
    return NDArray(v[:, _index_tensor(cols, v)])


@_extend(NDArray)
def getWhere(self, comp, condition):
    """Elements matching ``condition`` as a flat array (ref: getWhere;
    ``comp`` is unused because linalg.conditions predicates already carry
    their comparison value). The output size is data-dependent: it syncs
    the card for it, as ``unique`` does; the result stays on the device."""
    fn = condition.mask if hasattr(condition, "mask") else condition
    v = self._value
    return NDArray(v[fn(v)].reshape(-1))


@_extend(NDArray)
def putWhereWithMask(self, mask, put) -> "NDArray":
    v = self._value
    m = torch.as_tensor(_operand(mask, v), device=v.device)
    return NDArray(torch.where(m > 0, torch.as_tensor(
        _operand(put, v), device=v.device), v))


@_extend(NDArray)
def putSlice(self, dim_0_index: int, value) -> "NDArray":
    """Write a slice along dim 0 in place (ref: putSlice)."""
    self[dim_0_index] = value
    return self


# -- allocation-alikes --
@_extend(NDArray)
def like(self) -> "NDArray":
    """Zeros with self's shape+dtype (ref: INDArray.like)."""
    return NDArray(torch.zeros_like(self._value))


@_extend(NDArray)
def ulike(self) -> "NDArray":
    """Uninitialized-alike: zeros, like :meth:`like` (the JAX class has no
    uninitialized allocation; neither does this one)."""
    return NDArray(torch.zeros_like(self._value))


# -- workspace API (ref: INDArray.detach/leverage/migrate). There are no
# workspaces: the caching allocator owns memory and buffers are never
# written, so these are documented identities kept for API parity. --
@_extend(NDArray)
def detach(self) -> "NDArray":
    return self


@_extend(NDArray)
def leverage(self) -> "NDArray":
    return self


@_extend(NDArray)
def migrate(self) -> "NDArray":
    return self


# -- the remaining INDArray names --
@_extend(NDArray)
def negative(self) -> "NDArray":
    return NDArray(-self._value)


@_extend(NDArray)
def negativei(self) -> "NDArray":
    return self._set_value(-self._value)


@_extend(NDArray)
def asum(self, *dims):
    """ref: INDArray.asum — sum of absolute values."""
    return self.norm1(*dims)


@_extend(NDArray)
def normmax(self, *dims):
    return self.normMax(*dims)


@_extend(NDArray)
def normmaxNumber(self) -> float:
    return float(_amax(torch.abs(self._value)))


@_extend(NDArray)
def percentileNumber(self, q: float) -> float:
    """ref: INDArray.percentileNumber(Number) — linear interpolation."""
    return float(_quantile(self._value.float(), q / 100.0))


@_extend(NDArray)
def cosineSim(self, other) -> float:
    """ref: Transforms.cosineSim companion on the array surface."""
    a = self._value.reshape(-1).float()
    b = torch.as_tensor(_operand(other, self._value),
                        device=self.device).reshape(-1).float()
    den = torch.clamp_min(torch.linalg.vector_norm(a)
                          * torch.linalg.vector_norm(b), 1e-12)
    return float(torch.dot(a, b) / den)


@_extend(NDArray)
def eps(self, other, eps_val: float = 1e-5) -> "NDArray":
    """ref: INDArray.eps — elementwise |a-b| < eps mask."""
    return NDArray(torch.abs(_diff(self, other)) < eps_val)


@_extend(NDArray)
def epsi(self, other, eps_val: float = 1e-5) -> "NDArray":
    return self._set_value(torch.abs(_diff(self, other)) < eps_val)


@_extend(NDArray)
def slice(self, i: int, dim: int = 0) -> "NDArray":
    """ref: INDArray.slice(i[, dim]) — one hyperplane along ``dim``
    (a VIEW in the reference; a value here — write-back views come from
    getRow/getColumn/slice_)."""
    return NDArray(torch.select(self._value, dim, i))


@_extend(NDArray)
def subArray(self, offsets, shape) -> "NDArray":
    """ref: INDArray.subArray(offsets, shape, strides=1)."""
    idx = tuple(builtins.slice(int(o), int(o) + int(s))
                for o, s in zip(offsets, shape))
    return NDArray(self._value[idx])


@_extend(NDArray)
def tensorsAlongDimension(self, *dims) -> int:
    """ref: INDArray.tensorsAlongDimension — how many sub-tensors the
    dimension set yields."""
    keep = int(np.prod([self.shape[d] for d in dims]))
    return int(self.length() // builtins.max(keep, 1))


@_extend(NDArray)
def vectorsAlongDimension(self, dim: int) -> int:
    return int(self.length() // builtins.max(self.shape[dim], 1))


@_extend(NDArray)
def sumAlongDimension(self, *dims) -> "NDArray":
    return self.sum(*dims)


@_extend(NDArray)
def meanAlongDimension(self, *dims) -> "NDArray":
    return self.mean(*dims)


@_extend(NDArray)
def cond(self, condition) -> "NDArray":
    """ref: INDArray.cond(Condition) — 1/0 mask of elements matching."""
    return NDArray(condition.mask(self._value).to(torch.float32))


@_extend(NDArray)
def close(self):
    """ref: INDArray.close — the caching allocator frees the buffer when
    the last reference goes; parity no-op."""
    return None
