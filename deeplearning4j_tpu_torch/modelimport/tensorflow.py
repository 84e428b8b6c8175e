"""TF frozen-GraphDef import into the port's SameDiff — the port of
``deeplearning4j_tpu/modelimport/tensorflow.py``.

Reference parity: ``nd4j/samediff-import/samediff-import-tensorflow``,
``TensorflowFrameworkImporter.runImport``, maps a TF GraphDef node by
node into SameDiff (this is how the reference's BERT enters).

The GraphDef is parsed by :mod:`.tf_proto` (stdlib + numpy), never by
TensorFlow. Design, as in the JAX package:

- Every TF op maps through a **builder**: ``_BUILDERS[tf_op](params) ->
  fn`` where ``params`` is a JSON-able dict taken at import time (static
  shapes, axes, masks, resolved from Const inputs). Imported nodes are
  recorded as ``tf.<Op>`` with ``rebuild="tf"``, so they serialize through
  ``SameDiff.save()``/``load()`` (load re-runs the builder from the stored
  params) in the JAX package's format: a graph either package imports and
  saves loads in the other.
- Const folding: a mapped node whose data inputs are all constants (and
  small) runs at import, on the CPU, and becomes a Const; the size of its
  result is bounded first on ``meta`` tensors. This collapses frozen-graph
  shape arithmetic into static operands.
- The builders are plain torch, run eagerly on the graph's device, with
  the dtypes the JAX package computes in (x64 off: int64 -> int32,
  float64 -> float32). ``Softmax`` is ``torch.softmax``, as the JAX
  importer's is ``jax.nn.softmax``: an imported graph launches no
  hand-written kernel.
- TF2 functional control flow (``StatelessWhile``/``While``,
  ``StatelessIf``/``If``, ``PartitionedCall``) imports over SameDiff
  subgraphs; TF1 while frames (Enter/Exit/Merge/Switch/NextIteration/
  LoopCond) are deframed into the same functional while. TF1 Switch/Merge
  conditionals and training-mode ops are refused with explanatory errors.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.analysis import imports as _imp
from deeplearning4j_tpu_torch.autodiff import samediff as _sdmod
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.modelimport import tf_proto
from deeplearning4j_tpu_torch.ops import convolution as _conv
from deeplearning4j_tpu_torch.ops import normalization as _norm
from deeplearning4j_tpu_torch.ops import registry as _R


class TFImportError(ValueError):
    pass


_DTYPES = {1: torch.float32, 2: torch.float64, 3: torch.int32,
           4: torch.uint8, 6: torch.int8, 7: str, 9: torch.int64,
           10: torch.bool, 14: torch.bfloat16, 19: torch.float16}

# elements threshold below which an all-const node is folded at import time
_FOLD_LIMIT = 1 << 20

#: the dtypes the JAX package computes in without x64
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def _attr(node, name, default=None):
    if name not in node.attr:
        return default
    a = node.attr[name]
    kind = a.WhichOneof("value")
    if kind == "i":
        return int(a.i)
    if kind == "f":
        return float(a.f)
    if kind == "b":
        return bool(a.b)
    if kind == "s":
        return a.s.decode("utf-8")
    if kind == "type":
        return _DTYPES.get(a.type)
    if kind == "shape":
        return [d.size for d in a.shape.dim]
    if kind == "list":
        if a.list.i:
            return [int(v) for v in a.list.i]
        if a.list.f:
            return [float(v) for v in a.list.f]
        return []
    return default


def _tensor_value(node):
    """A Const node's value: numpy (a bf16 tensor for DT_BFLOAT16)."""
    return tf_proto.make_ndarray(node.attr["value"].tensor)


def _conv_padding(node) -> str:
    p = _attr(node, "padding", "VALID")
    if p not in ("SAME", "VALID"):
        raise TFImportError(f"padding {p} unsupported ({node.name})")
    return p


def _np_dtype_name(dt) -> str:
    return _R.dtype_name(dt) if dt is not None else "float32"


def _to_torch(a) -> torch.Tensor:
    """A const (numpy or tensor) as the CPU tensor the fold computes with."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
        a = torch.from_numpy(np.array(a, copy=not a.flags.writeable))
    return a.to(_NARROW.get(a.dtype, a.dtype))


def _to_host(t):
    """A folded result as the consts table keeps it: numpy, bf16 as a
    CPU tensor (numpy has no bfloat16)."""
    if t.dtype == torch.bfloat16:
        return t.detach().cpu()
    return t.detach().cpu().numpy()


def _axes(axes, ndim: int) -> List[int]:
    return sorted({int(a) % ndim for a in axes}) if ndim else []


# ------------------------------------------------------------------ builders
# _BUILDERS[tf_op](params: JSON-able dict) -> executable fn(*data_inputs).
# Builders are the single source of truth for semantics: used at import
# time AND at SameDiff.load() (rebuild="tf").

_BUILDERS: Dict[str, Callable[[dict], Callable]] = {}


def _simple(tf_op: str, fn: Callable):
    _BUILDERS[tf_op] = lambda p, _f=fn: _f


def _float(x):
    return x if x.is_floating_point() else x.float()


def _select_v1(c, a, b):
    """TF1 Select: a rank-1 condition selects along the FIRST axis."""
    if c.dim() == 1 and a.dim() > 1:
        c = c.reshape((-1,) + (1,) * (a.dim() - 1))
    return torch.where(c, a, b)


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _sign(x):
    return torch.where(torch.isnan(x), x, torch.sign(x)) \
        if x.is_floating_point() else torch.sign(x)


def _reciprocal(x):
    if x.is_floating_point():
        return torch.reciprocal(x)
    return torch.div(torch.ones_like(x), x, rounding_mode="trunc")


_SIMPLE_OPS = {
    "Add": lambda a, b: a + b,
    "AddV2": lambda a, b: a + b,
    "Sub": lambda a, b: a - b,
    "Mul": lambda a, b: a * b,
    "RealDiv": lambda a, b: a / b,
    "Div": lambda a, b: a / b,
    "FloorDiv": lambda a, b: torch.div(a, b, rounding_mode="floor"),
    "FloorMod": torch.remainder,
    "Mod": torch.fmod,       # TF Mod is C-truncated; FloorMod is floored
    "Maximum": torch.maximum,
    "Minimum": torch.minimum,
    "Pow": torch.pow,
    "SquaredDifference": lambda a, b: torch.square(a - b),
    "Greater": lambda a, b: a > b,
    "GreaterEqual": lambda a, b: a >= b,
    "Less": lambda a, b: a < b,
    "LessEqual": lambda a, b: a <= b,
    "Equal": lambda a, b: a == b,
    "NotEqual": lambda a, b: a != b,
    "LogicalAnd": torch.logical_and,
    "LogicalOr": torch.logical_or,
    "LogicalNot": torch.logical_not,
    "Relu": torch.relu,
    "Relu6": lambda x: torch.clamp(x, 0, 6),
    "Elu": F.elu,
    "Selu": F.selu,
    "Sigmoid": torch.sigmoid,
    "Tanh": torch.tanh,
    "Erf": torch.erf,
    "Exp": torch.exp,
    "Log": torch.log,
    "Log1p": torch.log1p,
    "Sqrt": torch.sqrt,
    "Rsqrt": torch.rsqrt,
    "Square": torch.square,
    "Neg": torch.neg,
    "Abs": torch.abs,
    "Sign": _sign,
    "Floor": torch.floor,
    "Ceil": torch.ceil,
    "Round": torch.round,       # half to even, as TF and jnp.round
    "Rint": torch.round,
    "Sin": torch.sin,
    "Cos": torch.cos,
    "Tan": torch.tan,
    "Asin": torch.asin,
    "Acos": torch.acos,
    "Atan": torch.atan,
    "Atan2": torch.atan2,
    "Sinh": torch.sinh,
    "Cosh": torch.cosh,
    "Asinh": torch.asinh,
    "Acosh": torch.acosh,
    "Atanh": torch.atanh,
    "Reciprocal": _reciprocal,
    "Inv": _reciprocal,
    "Identity": lambda x: x,
    "Snapshot": lambda x: x,
    "StopGradient": torch.Tensor.detach,
    "PreventGradient": torch.Tensor.detach,
    "Softplus": _softplus,
    "Softsign": F.softsign,
    "ZerosLike": torch.zeros_like,
    "OnesLike": torch.ones_like,
    "Softmax": lambda x: torch.softmax(x, dim=-1),
    "LogSoftmax": lambda x: torch.log_softmax(x, dim=-1),
    "Shape": lambda x: torch.tensor(tuple(x.shape), dtype=torch.int32,
                                    device=x.device),
    "Rank": lambda x: torch.tensor(x.dim(), dtype=torch.int32,
                                   device=x.device),
    "Size": lambda x: torch.tensor(x.numel(), dtype=torch.int32,
                                   device=x.device),
    "IsNan": torch.isnan,
    "IsInf": torch.isinf,
    "IsFinite": torch.isfinite,
    "Select": _select_v1,
    "SelectV2": torch.where,
    "AddN": lambda *xs: sum(xs[1:], xs[0]),
    "InvertPermutation": lambda p: torch.argsort(p).to(torch.int32),
}
for _op, _fn in _SIMPLE_OPS.items():
    _simple(_op, _fn)


def _b(tf_op: str):
    def deco(fn):
        _BUILDERS[tf_op] = fn
        return fn
    return deco


@_b("LeakyRelu")
def _b_leaky_relu(p):
    alpha = p.get("alpha", 0.2)
    return lambda x: torch.where(x >= 0, x, alpha * x)


@_b("MatMul")
def _b_matmul(p):
    ta, tb = p.get("transpose_a", False), p.get("transpose_b", False)

    def fn(a, b):
        a = a.T if ta else a
        b = b.T if tb else b
        return a @ b
    return fn


def _b_batchmatmul(p):
    ta, tb = p.get("adj_x", False), p.get("adj_y", False)

    def fn(a, b):
        a = a.transpose(-1, -2) if ta else a
        b = b.transpose(-1, -2) if tb else b
        return torch.matmul(a, b)
    return fn


_BUILDERS["BatchMatMul"] = _b_batchmatmul
_BUILDERS["BatchMatMulV2"] = _b_batchmatmul


def _reduce_dims(x, axes, keep, one):
    """Reduce over each axis with a single-axis reducer ``one(x, d,
    keep)``, highest axis first; no axes is the identity (as jnp)."""
    for d in reversed(_axes(axes, x.dim())):
        x = one(x, d, keep)
    return x


def _mean(x, axes, keep):
    return torch.mean(_float(x), dim=_axes(axes, x.dim()), keepdim=keep) \
        if axes else _float(x)


def _sum(x, axes, keep):
    out_dt = torch.int32 if x.dtype == torch.bool else x.dtype
    if not axes:
        return x.to(out_dt)
    return torch.sum(x, dim=_axes(axes, x.dim()), keepdim=keep).to(out_dt)


def _prod(x, axes, keep):
    out_dt = torch.int32 if x.dtype == torch.bool else x.dtype
    return _reduce_dims(x, axes, keep, lambda t, d, k: torch.prod(
        t, dim=d, keepdim=k)).to(out_dt)


def _b_reduce(fn):
    def build(p):
        axes = tuple(p["axes"])
        keep = p.get("keep_dims", False)
        return lambda x: fn(x, axes, keep)
    return build


for _op, _rfn in [
        ("Mean", _mean), ("Sum", _sum), ("Prod", _prod),
        ("Max", lambda x, a, k: _reduce_dims(
            x, a, k, lambda t, d, kk: torch.amax(t, dim=d, keepdim=kk))),
        ("Min", lambda x, a, k: _reduce_dims(
            x, a, k, lambda t, d, kk: torch.amin(t, dim=d, keepdim=kk))),
        ("All", lambda x, a, k: _reduce_dims(
            x, a, k, lambda t, d, kk: torch.all(t, dim=d, keepdim=kk))),
        ("Any", lambda x, a, k: _reduce_dims(
            x, a, k, lambda t, d, kk: torch.any(t, dim=d, keepdim=kk)))]:
    _BUILDERS[_op] = _b_reduce(_rfn)


@_b("Reshape")
def _b_reshape(p):
    shape = tuple(p["shape"])
    return lambda x: torch.reshape(x, shape)


@_b("Transpose")
def _b_transpose(p):
    perm = tuple(p["perm"])
    return lambda x: x.permute(perm)


@_b("ConcatV2")
def _b_concat(p):
    axis = p["axis"]
    return lambda *xs: torch.cat(xs, dim=axis)


@_b("Split")
def _b_split(p):
    n, axis = p["num_split"], p["axis"]
    return lambda x: tuple(torch.split(x, x.shape[axis] // n, dim=axis))


@_b("SplitV")
def _b_splitv(p):
    sizes, axis = list(p["size_splits"]), p["axis"]
    return lambda x: tuple(torch.split(x, sizes, dim=axis))


@_b("Unpack")
def _b_unpack(p):
    axis = p.get("axis", 0)
    return lambda x: tuple(torch.unbind(x, dim=axis))


@_b("Squeeze")
def _b_squeeze(p):
    dims = p.get("squeeze_dims") or None
    if dims:
        return lambda x: torch.squeeze(x, dim=tuple(dims))
    return torch.squeeze


@_b("ExpandDims")
def _b_expand_dims(p):
    return lambda x: torch.unsqueeze(x, p["axis"])


@_b("Pack")
def _b_pack(p):
    axis = p.get("axis", 0)
    return lambda *xs: torch.stack(xs, dim=axis)


@_b("Cast")
def _b_cast(p):
    dst = _R.torch_dtype(p["dst"])
    dst = _NARROW.get(dst, dst)
    return lambda x: x.to(dst)


def _pad_list(pads) -> List[int]:
    """numpy-style [(before, after)] per dim -> F.pad's flat list, last
    dim first."""
    flat: List[int] = []
    for b, a in reversed([tuple(r) for r in pads]):
        flat += [int(b), int(a)]
    return flat


@_b("Pad")
def _b_pad(p):
    flat = _pad_list(p["paddings"])
    return lambda x: F.pad(x, flat)


@_b("PadV2")
def _b_padv2(p):
    flat = _pad_list(p["paddings"])

    def fn(x, c):
        # the pad value is a tensor: mask the border instead of reading it
        inside = F.pad(torch.ones_like(x, dtype=torch.bool), flat)
        return torch.where(inside, F.pad(x, flat), c.to(x.dtype))
    return fn


@_b("MirrorPad")
def _b_mirrorpad(p):
    pads = [tuple(int(v) for v in row) for row in p["paddings"]]
    symmetric = p.get("mode", "REFLECT") != "REFLECT"

    def fn(x):
        for d, (b, a) in enumerate(pads):
            if not (b or a):
                continue
            n = x.shape[d]
            k = 0 if symmetric else 1
            idx = (list(range(b - 1 + k, k - 1, -1)) + list(range(n))
                   + list(range(n - 1 - k, n - 1 - k - a, -1)))
            x = x.index_select(d, torch.tensor(idx, device=x.device))
        return x
    return fn


@_b("Fill")
def _b_fill(p):
    dims = tuple(p["dims"])
    return lambda v: v.reshape(()).expand(dims).clone()


@_b("Range")
def _b_range(p):
    dt = _R.torch_dtype(p["dtype"])
    dt = _NARROW.get(dt, dt)
    return lambda: torch.arange(p["start"], p["limit"], p["delta"], dtype=dt)


@_b("Tile")
def _b_tile(p):
    reps = tuple(p["multiples"])
    return lambda x: torch.tile(x, reps)


def _cum(op):
    def build(p):
        axis, excl = p["axis"], p.get("exclusive", False)
        rev = p.get("reverse", False)

        def fn(x):
            y = torch.flip(x, (axis,)) if rev else x
            if excl:
                ones = torch.ones_like(y.narrow(axis, 0, 1)) \
                    if op == "prod" else torch.zeros_like(y.narrow(axis, 0, 1))
                y = torch.cat([ones, y.narrow(axis, 0, y.shape[axis] - 1)],
                              dim=axis)
            c = (torch.cumprod if op == "prod" else torch.cumsum)(
                y, dim=axis, dtype=x.dtype)
            return torch.flip(c, (axis,)) if rev else c
        return fn
    return build


_BUILDERS["Cumsum"] = _cum("sum")
_BUILDERS["Cumprod"] = _cum("prod")


@_b("TopKV2")
def _b_topk(p):
    k = p["k"]

    def fn(x):
        v, i = torch.topk(x, k, dim=-1, largest=True, sorted=True)
        return v, i.to(torch.int32)
    return fn


@_b("OneHot")
def _b_onehot(p):
    depth, axis = p["depth"], p.get("axis", -1)
    on, off = p.get("on_value", 1.0), p.get("off_value", 0.0)

    def fn(idx):
        # out-of-range indices give all-off rows, as TF and jax.nn.one_hot
        oh = (idx.unsqueeze(-1) == torch.arange(
            depth, device=idx.device)).to(torch.float32)
        if axis != -1:
            oh = oh.movedim(-1, axis)
        return oh * (on - off) + off
    return fn


def _take(params, idx, ax):
    """jnp.take along ``ax`` (negative indices count from the end)."""
    idx = idx.long()
    n = params.shape[ax]
    idx = torch.where(idx < 0, idx + n, idx)
    out = params.index_select(ax, idx.reshape(-1))
    return out.reshape(params.shape[:ax] + idx.shape + params.shape[ax + 1:])


@_b("GatherV2")
def _b_gather(p):
    ax = p.get("axis", 0)
    bd = p.get("batch_dims", 0)
    if bd == 1:
        return lambda pp, ii: torch.stack([
            _take(pp[b], ii[b], (ax - 1) % (pp.dim() - 1))
            for b in range(pp.shape[0])])
    if bd:
        raise TFImportError("GatherV2 with batch_dims>1 not supported")
    return lambda params, indices: _take(params, indices, ax % params.dim())


_BUILDERS["Gather"] = _BUILDERS["GatherV2"]


@_b("GatherNd")
def _b_gather_nd(p):
    def fn(params, indices):
        return params[tuple(indices.long().movedim(-1, 0))]
    return fn


def _getitem(x, idx):
    """``x[idx]`` for a numpy-style basic index; slices with a negative
    step (which torch indexing refuses) become an index_select."""
    if not any(isinstance(s, slice) and s.step is not None and s.step < 0
               for s in idx):
        return x[idx]
    consumed = sum(1 for s in idx if s is not None and s is not Ellipsis)
    new_idx, flips = [], []
    in_dim = out_dim = 0
    for s in idx:
        if s is Ellipsis:
            k = x.dim() - consumed
            in_dim += k
            out_dim += k
            new_idx.append(s)
        elif s is None:
            out_dim += 1
            new_idx.append(s)
        elif isinstance(s, int):
            in_dim += 1
            new_idx.append(s)
        else:
            if s.step is not None and s.step < 0:
                flips.append((out_dim, list(range(*s.indices(
                    x.shape[in_dim])))))
                new_idx.append(slice(None))
            else:
                new_idx.append(s)
            in_dim += 1
            out_dim += 1
    y = x[tuple(new_idx)]
    for d, r in flips:
        y = y.index_select(d, torch.tensor(r, dtype=torch.long,
                                           device=x.device))
    return y


@_b("StridedSlice")
def _b_strided_slice(p):
    idx = tuple(_decode_ss_index(s) for s in p["index"])
    return lambda x: _getitem(x, idx)


def _decode_ss_index(s):
    if isinstance(s, (int, np.integer)):
        return int(s)
    if s == "new":
        return None
    if s == "...":
        return Ellipsis
    return slice(*[None if v is None else int(v) for v in s])


@_b("Slice")
def _b_slice(p):
    begin, size = list(p["begin"]), list(p["size"])
    idx = tuple(slice(b, None if s == -1 else b + s)
                for b, s in zip(begin, size))
    return lambda x: x[idx]


@_b("Reverse")
def _b_reverse(p):
    axes = tuple(p["axes"])
    return lambda x: torch.flip(x, axes)


_BUILDERS["ReverseV2"] = _BUILDERS["Reverse"]


@_b("ArgMax")
def _b_argmax(p):
    axis = p.get("axis", 0)
    return lambda x: torch.argmax(x, dim=axis).to(torch.int32)


@_b("ArgMin")
def _b_argmin(p):
    axis = p.get("axis", 0)
    return lambda x: torch.argmin(x, dim=axis).to(torch.int32)


@_b("BiasAdd")
def _b_bias_add(p):
    if p.get("data_format", "NHWC") == "NCHW":
        return lambda x, b: x + b.reshape((1, -1) + (1,) * (x.dim() - 2))
    return lambda x, b: x + b


def _same_pads(sizes, ksize, strides, dil=None) -> List[int]:
    """XLA/TF SAME padding of the spatial ``sizes`` as F.pad's flat list
    (last dim first): the odd remainder goes after."""
    dil = dil or [1] * len(sizes)
    flat: List[int] = []
    for n, k, s, d in reversed(list(zip(sizes, ksize, strides, dil))):
        eff = (k - 1) * d + 1
        out = -(-n // s)
        total = max((out - 1) * s + eff - n, 0)
        flat += [total // 2, total - total // 2]
    return flat


def _nhwc_conv(x, w_oihw, strides, pad, dil=None, groups=1):
    """Conv over channels-last ``x`` [N, *spatial, C] with a torch-layout
    weight; SAME/VALID as XLA pads them."""
    nd = x.dim() - 2
    xt = x.movedim(-1, 1)
    if pad == "SAME":
        xt = F.pad(xt, _same_pads(xt.shape[2:], w_oihw.shape[2:], strides,
                                  dil))
    conv = F.conv2d if nd == 2 else F.conv3d
    y = conv(xt, w_oihw, stride=tuple(strides),
             dilation=tuple(dil) if dil else 1, groups=groups)
    return y.movedim(1, -1)


@_b("Conv2D")
def _b_conv2d(p):
    strides, dil, pad = p["strides"], p["dilations"], p["padding"]

    def fn(x, w):  # x NHWC, w HWIO
        return _nhwc_conv(x, w.permute(3, 2, 0, 1), strides[1:3], pad,
                          dil[1:3])
    return fn


@_b("DepthwiseConv2dNative")
def _b_depthwise(p):
    strides, pad = p["strides"], p["padding"]

    def fn(x, w):  # w [H, W, C, M]: output channel c*M + m, as TF
        h, wd, c, m = w.shape
        wt = w.permute(2, 3, 0, 1).reshape(c * m, 1, h, wd)
        return _nhwc_conv(x, wt, strides[1:3], pad, groups=c)
    return fn


def _pool_nd(x, kind: str, ks, st, pad):
    """reduce_window over the spatial dims of channels-last ``x``: max
    pads with -inf; avg divides by the count of real elements (SAME) or
    the window size (VALID)."""
    nd = x.dim() - 2
    xt = x.movedim(-1, 1)
    flat = _same_pads(xt.shape[2:], ks, st) if pad == "SAME" else None
    if kind == "max":
        if flat:
            xt = F.pad(xt, flat, value=-float("inf"))
        mp = F.max_pool2d if nd == 2 else F.max_pool3d
        return mp(xt, tuple(ks), tuple(st)).movedim(1, -1)
    ap = F.avg_pool2d if nd == 2 else F.avg_pool3d
    if not flat:
        return ap(xt, tuple(ks), tuple(st)).movedim(1, -1)
    win = float(np.prod(ks))
    s = ap(F.pad(xt, flat), tuple(ks), tuple(st)) * win
    cnt = ap(F.pad(torch.ones_like(xt[:1, :1]), flat), tuple(ks),
             tuple(st)) * win
    return (s / cnt).movedim(1, -1)


def _b_pool(kind):
    def build(p):
        ks, st, pad = p["ksize"], p["strides"], p["padding"]
        return lambda x: _pool_nd(x, kind, ks[1:-1], st[1:-1], pad)
    return build


_BUILDERS["MaxPool"] = _b_pool("max")
_BUILDERS["AvgPool"] = _b_pool("avg")


def _b_fused_bn(p):
    eps = p.get("epsilon", 1e-3)

    def fn(x, gamma, beta, mean, var):
        inv = gamma * torch.rsqrt(var + eps)
        return x * inv + (beta - mean * inv)
    return fn


_BUILDERS["FusedBatchNorm"] = _b_fused_bn
_BUILDERS["FusedBatchNormV3"] = _b_fused_bn


@_b("ClipByValue")
def _b_clip(p):
    return lambda x, lo, hi: torch.minimum(torch.maximum(x, lo), hi)


@_b("SpaceToBatchND")
def _b_space_to_batch(p):
    bs, pads = list(p["block_shape"]), [tuple(r) for r in p["paddings"]]
    return lambda x: _space_to_batch_nd(x, bs, pads)


def _space_to_batch_nd(x, block_shape, paddings):
    pads = [(0, 0)] + list(paddings) + [(0, 0)] * (x.dim() - 1
                                                     - len(paddings))
    x = F.pad(x, _pad_list(pads))
    n = x.shape[0]
    spatial = x.shape[1:1 + len(block_shape)]
    rest = list(x.shape[1 + len(block_shape):])
    shp = [n]
    for s, b in zip(spatial, block_shape):
        shp += [s // b, b]
    x = x.reshape(shp + rest)
    perm = ([2 * i + 2 for i in range(len(block_shape))] + [0]
            + [2 * i + 1 for i in range(len(block_shape))]
            + list(range(1 + 2 * len(block_shape), x.dim())))
    x = x.permute(perm)
    out_n = n * int(np.prod(block_shape))
    return x.reshape([out_n] + [s // b for s, b in zip(spatial, block_shape)]
                     + rest)


def _tf_rebuild(attrs: dict) -> Callable:
    """``_FN_REBUILDERS['tf']``: reconstruct an imported node's callable
    from its serialized (tf_op, params); kwargs from attrs are swallowed."""
    fn = _BUILDERS[attrs["tf_op"]](dict(attrs.get("params") or {}))
    return lambda *a, **kw: fn(*a)


_sdmod._FN_REBUILDERS["tf"] = _tf_rebuild


# --------------------------------------------------------- the wider ops
# Special functions, scatter, image, segment, 3-D conv/pool, linalg,
# einsum (the JAX package's r4 breadth).

def _polygamma(n, x):
    """polygamma(n, x) elementwise in n: digamma at n = 0, else
    (-1)^(n+1) n! zeta(n+1, x)."""
    n = n.to(x.dtype)
    sign = torch.where(torch.remainder(n, 2) == 0, -1.0, 1.0).to(x.dtype)
    rest = sign * torch.exp(torch.lgamma(n + 1)) * torch.special.zeta(
        n + 1, x)
    return torch.where(n == 0, torch.digamma(x), rest)


def _betainc(a, b, x, iters: int = 300):
    """Regularized incomplete beta I_x(a, b) by Lentz's continued fraction,
    elementwise, on the symmetric side that converges."""
    a, b, x = torch.broadcast_tensors(a, b, x)
    swap = x > (a + 1) / (a + b + 2)
    aa, bb = torch.where(swap, b, a), torch.where(swap, a, b)
    xx = torch.where(swap, 1 - x, x)
    tiny = torch.finfo(x.dtype).tiny * 1e10
    c = torch.ones_like(xx)
    d = 1 - (aa + bb) * xx / (aa + 1)
    d = torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)
    d = 1 / d
    h = d
    for m in range(1, iters):
        m2 = 2 * m
        num = m * (bb - m) * xx / ((aa + m2 - 1) * (aa + m2))
        for step in (num, -(aa + m) * (aa + bb + m) * xx
                     / ((aa + m2) * (aa + m2 + 1))):
            d = 1 + step * d
            d = torch.where(d.abs() < tiny, torch.full_like(d, tiny), d)
            c = 1 + step / c
            c = torch.where(c.abs() < tiny, torch.full_like(c, tiny), c)
            d = 1 / d
            h = h * d * c
    lbeta = torch.lgamma(aa + bb) - torch.lgamma(aa) - torch.lgamma(bb)
    front = torch.exp(lbeta + aa * torch.log(xx) + bb * torch.log1p(-xx)) / aa
    res = front * h
    res = torch.where(swap, 1 - res, res)
    res = torch.where(x <= 0, torch.zeros_like(res), res)
    return torch.where(x >= 1, torch.ones_like(res), res)


def _rgb_to_hsv(x):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = torch.amax(x, dim=-1)
    mn = torch.amin(x, dim=-1)
    d = mx - mn
    safe = torch.where(d == 0, torch.ones_like(d), d)
    h = torch.where(
        mx == r, torch.remainder((g - b) / safe, 6.0),
        torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0)) / 6.0
    h = torch.where(d == 0, torch.zeros_like(h), h)
    s = torch.where(mx == 0, torch.zeros_like(mx),
                    d / torch.where(mx == 0, torch.ones_like(mx), mx))
    return torch.stack([h, s, mx], dim=-1)


def _hsv_to_rgb(x):
    h, s, v = x[..., 0], x[..., 1], x[..., 2]
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    i = torch.remainder(i, 6).to(torch.int32)

    def pick(*vals):
        out = vals[-1]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out
    return torch.stack([pick(v, q, p, p, t, v), pick(t, v, v, q, p, p),
                        pick(p, p, t, v, v, q)], dim=-1)


def _adjust_hue(x, delta):
    hsv = _rgb_to_hsv(x)
    h = torch.remainder(hsv[..., 0] + delta, 1.0)
    return _hsv_to_rgb(torch.stack([h, hsv[..., 1], hsv[..., 2]], dim=-1))


def _adjust_saturation(x, factor):
    hsv = _rgb_to_hsv(x)
    s = torch.clamp(hsv[..., 1] * factor, 0.0, 1.0)
    return _hsv_to_rgb(torch.stack([hsv[..., 0], s, hsv[..., 2]], dim=-1))


def _adjust_contrast(x, factor):
    m = torch.mean(x, dim=(-3, -2), keepdim=True)
    return (x - m) * factor + m


def _nd_index(indices):
    """[..., d] int indices -> a tuple of d index tensors."""
    return tuple(indices.long().movedim(-1, 0))


def _scatter_nd_into(ref, indices, updates, accumulate, negate=False):
    upd = -updates if negate else updates
    return ref.clone().index_put_(_nd_index(indices), upd.to(ref.dtype),
                                  accumulate=accumulate)


def _matrix_set_diag(x, diag):
    out = x.clone()
    n = min(x.shape[-2], x.shape[-1])
    torch.diagonal(out, dim1=-2, dim2=-1).copy_(diag[..., :n])
    return out


def _matrix_band_part(x, lo, hi):
    m, n = x.shape[-2], x.shape[-1]
    i = torch.arange(m, device=x.device)[:, None]
    j = torch.arange(n, device=x.device)[None, :]
    keep = torch.ones((m, n), dtype=torch.bool, device=x.device)
    if lo >= 0:
        keep &= (i - j) <= lo
    if hi >= 0:
        keep &= (j - i) <= hi
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


_SIMPLE_OPS_R4 = {
    "Erfc": torch.special.erfc,
    "Expm1": torch.expm1,
    "Lgamma": torch.lgamma,
    "Digamma": torch.digamma,
    "Igamma": torch.special.gammainc,
    "Igammac": torch.special.gammaincc,
    "Polygamma": _polygamma,
    "Zeta": torch.special.zeta,
    "Betainc": _betainc,
    "DivNoNan": lambda a, b: torch.where(
        b == 0, torch.zeros((), dtype=torch.result_type(a, b),
                            device=a.device),
        a / torch.where(b == 0, torch.ones_like(b), b)),
    "Xdivy": lambda a, b: torch.where(
        a == 0, torch.zeros_like(a), a / torch.where(a == 0,
                                                     torch.ones_like(b), b)),
    "Xlogy": lambda a, b: torch.where(
        a == 0, torch.zeros_like(a),
        a * torch.log(torch.where(a == 0, torch.ones_like(b), b))),
    "Xlog1py": lambda a, b: torch.where(
        a == 0, torch.zeros_like(a),
        a * torch.log1p(torch.where(a == 0, torch.zeros_like(b), b))),
    "L2Loss": lambda x: torch.sum(torch.square(x)) / 2.0,
    "Cholesky": torch.linalg.cholesky,
    "MatrixSolve": torch.linalg.solve,
    "MatrixDiag": torch.diag_embed,
    "MatrixDiagPart": lambda x: torch.diagonal(x, dim1=-2, dim2=-1),
    "RGBToHSV": _rgb_to_hsv,
    "HSVToRGB": _hsv_to_rgb,
    "AdjustContrastv2": _adjust_contrast,
    "AdjustHue": _adjust_hue,
    "AdjustSaturation": _adjust_saturation,
    "TensorScatterUpdate": lambda t, i, u: _scatter_nd_into(t, i, u, False),
    "TensorScatterAdd": lambda t, i, u: _scatter_nd_into(t, i, u, True),
    "TensorScatterSub": lambda t, i, u: _scatter_nd_into(t, i, u, True,
                                                         negate=True),
    "SquaredDifference": lambda a, b: torch.square(a - b),
}
for _op, _fn in _SIMPLE_OPS_R4.items():
    _simple(_op, _fn)


@_b("MatrixSetDiag")
def _b_matrix_set_diag(p):
    return _matrix_set_diag


_BUILDERS["MatrixSetDiagV3"] = _BUILDERS["MatrixSetDiag"]
_BUILDERS["MatrixDiagPartV3"] = _BUILDERS["MatrixDiagPart"]
_BUILDERS["MatrixDiagV3"] = _BUILDERS["MatrixDiag"]


@_b("BroadcastArgs")
def _b_broadcast_args(p):
    """Broadcast-shape arithmetic over two shape vectors (frozen
    tf.linspace/broadcast chains); its output length depends only on the
    input lengths, so the fold check sizes it and it folds to a Const."""
    def fn(s0, s1):
        s0, s1 = s0.to(torch.int32), s1.to(torch.int32)
        n = max(s0.shape[0], s1.shape[0])
        one = torch.ones((), dtype=torch.int32, device=s0.device)
        a = torch.cat([one.expand(n - s0.shape[0]), s0])
        b = torch.cat([one.expand(n - s1.shape[0]), s1])
        return torch.maximum(a, b)
    return fn


@_b("MatrixBandPart")
def _b_band_part(p):
    lo, hi = p["num_lower"], p["num_upper"]
    return lambda x: _matrix_band_part(x, lo, hi)


@_b("ScatterNd")
def _b_scatter_nd(p):
    shape = tuple(p["shape"])

    def fn(idx, upd):
        out = torch.zeros(shape, dtype=upd.dtype, device=upd.device)
        return out.index_put_(_nd_index(idx), upd, accumulate=True)
    return fn


def _resize(x, size, method):
    """jax.image.resize over the spatial dims of NHWC ``x``: half-pixel
    centers; bilinear antialiased when it shrinks; nearest picks
    floor((i + 0.5) * in / out)."""
    if method == "nearest":
        for d, n in zip((1, 2), size):
            m = x.shape[d]
            src = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5)
                              * m / n).to(torch.long).clamp_(0, m - 1)
            x = x.index_select(d, src.to(x.device))
        return x
    xt = x.movedim(-1, 1)
    shrink = any(n < m for n, m in zip(size, xt.shape[2:]))
    y = F.interpolate(xt, size=tuple(size), mode="bilinear",
                      align_corners=False, antialias=shrink)
    return y.movedim(1, -1)


@_b("ResizeBilinear")
def _b_resize_bilinear(p):
    size = tuple(p["size"])
    return lambda x: _resize(x, size, "bilinear")


@_b("ResizeNearestNeighbor")
def _b_resize_nn(p):
    size = tuple(p["size"])
    return lambda x: _resize(x, size, "nearest")


def _crop_and_resize(image, boxes, box_indices, crop_size, extrap):
    """TF crop_and_resize: normalized boxes [n, 4] (y1, x1, y2, x2)
    bilinear-sampled to crop_size; a crop dim of size 1 samples the box
    center, and samples outside the image take ``extrap``."""
    n, h, w, c = image.shape
    ch, cw = int(crop_size[0]), int(crop_size[1])
    boxes = boxes.to(torch.float32)

    def coords(lo, hi, out, in_size):
        # lerp form: endpoints land exactly on lo/hi
        if out > 1:
            t = torch.arange(out, dtype=torch.float32,
                             device=boxes.device) / (out - 1)
            return (lo[:, None] * (1 - t) + hi[:, None] * t) * (in_size - 1)
        return (0.5 * (lo + hi) * (in_size - 1))[:, None]

    ys = coords(boxes[:, 0], boxes[:, 2], ch, h)        # [nb, ch]
    xs = coords(boxes[:, 1], boxes[:, 3], cw, w)        # [nb, cw]
    in_y = (ys >= 0) & (ys <= h - 1)
    in_x = (xs >= 0) & (xs <= w - 1)
    img = image[box_indices.long()]                     # [nb, h, w, c]
    y0 = torch.floor(ys).long().clamp(0, h - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x0 = torch.floor(xs).long().clamp(0, w - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    wy = (ys - y0).clamp(0.0, 1.0)[:, :, None, None]
    wx = (xs - x0).clamp(0.0, 1.0)[:, None, :, None]
    bi = torch.arange(img.shape[0], device=img.device)[:, None, None]

    def at(yi, xi):
        return img[bi, yi[:, :, None], xi[:, None, :]]  # [nb, ch, cw, c]
    out = (at(y0, x0) * (1 - wy) * (1 - wx) + at(y0, x1) * (1 - wy) * wx
           + at(y1, x0) * wy * (1 - wx) + at(y1, x1) * wy * wx)
    inside = (in_y[:, :, None] & in_x[:, None, :])[..., None]
    return torch.where(inside, out, torch.full_like(out, extrap))


@_b("CropAndResize")
def _b_crop_and_resize(p):
    size = tuple(p["crop_size"])
    extrap = float(p.get("extrapolation_value", 0.0))
    return lambda img, boxes, bi: _crop_and_resize(img, boxes, bi, size,
                                                   extrap)


@_b("SpaceToDepth")
def _b_space_to_depth(p):
    bs, fmt = p["block_size"], p.get("data_format", "NHWC")
    return lambda x: _conv.space_to_depth(x, bs, data_format=fmt)


@_b("DepthToSpace")
def _b_depth_to_space(p):
    bs, fmt = p["block_size"], p.get("data_format", "NHWC")
    return lambda x: _conv.depth_to_space(x, bs, data_format=fmt)


@_b("BatchToSpaceND")
def _b_batch_to_space(p):
    bs, crops = p["block_shape"], p["crops"]
    if len(set(bs)) != 1:
        raise TFImportError("only uniform BatchToSpaceND block shapes import")
    b = int(bs[0])
    (ct, cb), (cl, cr) = crops

    def fn(x):
        nb, h, w, c = x.shape
        n = nb // (b * b)
        x = x.reshape(b, b, n, h, w, c).permute(2, 3, 0, 4, 1, 5)
        x = x.reshape(n, h * b, w * b, c)
        return x[:, ct:h * b - cb, cl:w * b - cr]
    return fn


@_b("Conv2DBackpropInput")
def _b_conv2d_backprop_input(p):
    """Deconvolution as TF frames it: the gradient of Conv2D (filter
    [kH, kW, inC, outC], SAME/VALID) with respect to its input."""
    strides = p["strides"][1:3]
    out_shape = tuple(p["input_sizes"])
    padding = p["padding"]

    def fn(w, dy):
        # dy [N, oH, oW, outC] -> [N, H, W, inC]
        full = F.conv_transpose2d(dy.movedim(-1, 1), w.permute(3, 2, 0, 1),
                                  stride=tuple(strides))
        h, wd = out_shape[1], out_shape[2]
        if padding == "SAME":
            pads = _same_pads((h, wd), w.shape[:2], strides)
            top, left = pads[2], pads[0]
        else:
            top = left = 0
        extra_h = max(top + h - full.shape[2], 0)
        extra_w = max(left + wd - full.shape[3], 0)
        if extra_h or extra_w:
            full = F.pad(full, (0, extra_w, 0, extra_h))
        return full[:, :, top:top + h, left:left + wd].movedim(1, -1)
    return fn


@_b("Conv3D")
def _b_conv3d(p):
    strides = p["strides"][1:4]
    padding = p["padding"]
    # x NDHWC, w [kD, kH, kW, inC, outC]
    return lambda x, w: _nhwc_conv(x, w.permute(4, 3, 0, 1, 2), strides,
                                   padding)


def _b_pool3d(kind):
    def build(p):
        ks, st, pad = p["ksize"][1:4], p["strides"][1:4], p["padding"]
        return lambda x: _pool_nd(x, kind, ks, st, pad)
    return build


_BUILDERS["MaxPool3D"] = _b_pool3d("max")
_BUILDERS["AvgPool3D"] = _b_pool3d("avg")


@_b("Dilation2D")
def _b_dilation2d(p):
    """Grayscale morphological dilation (TF semantics, NHWC):
    out[y, x, c] = max_{i,j} in[y*s + i*r, x*s + j*r, c] + filt[i, j, c]."""
    s = tuple(p["strides"][1:3])
    r = tuple(p["rates"][1:3])
    padding = p["padding"]

    def fn(x, f):
        kh, kw, _ = f.shape
        if padding == "SAME":
            pads = _same_pads(x.shape[1:3], (kh, kw), s, r)
            x = F.pad(x, (0, 0) + tuple(pads), value=-float("inf"))
        n, h, w, c = x.shape
        oh = (h - (kh - 1) * r[0] - 1) // s[0] + 1
        ow = (w - (kw - 1) * r[1] - 1) // s[1] + 1
        out = torch.full((n, oh, ow, c), -float("inf"), dtype=x.dtype,
                         device=x.device)
        for i in range(kh):
            for j in range(kw):
                patch = x[:, i * r[0]:i * r[0] + oh * s[0]:s[0],
                          j * r[1]:j * r[1] + ow * s[1]:s[1], :]
                out = torch.maximum(out, patch + f[i, j])
        return out
    return fn


def _segment(kind: str, n: int):
    """jax.ops.segment_* over the first axis with ``n`` segments; an empty
    segment holds the reduction's identity (0, 1, -inf, +inf)."""
    def fn(data, ids):
        ids = ids.long()
        shape = (n,) + tuple(data.shape[1:])
        idx = ids.reshape((-1,) + (1,) * (data.dim() - 1)).expand(data.shape)
        if kind in ("sum", "mean"):
            s = torch.zeros(shape, dtype=data.dtype,
                            device=data.device).index_add_(0, ids, data)
            if kind == "sum":
                return s
            c = torch.zeros(shape, dtype=torch.float32,
                            device=data.device).index_add_(
                0, ids, torch.ones_like(data, dtype=torch.float32))
            return s / torch.clamp_min(c, 1.0)
        if kind == "prod":
            base, red = torch.ones(shape, dtype=data.dtype,
                                   device=data.device), "prod"
        else:
            fill = (-float("inf") if kind == "max" else float("inf")) \
                if data.is_floating_point() else (
                torch.iinfo(data.dtype).min if kind == "max"
                else torch.iinfo(data.dtype).max)
            base = torch.full(shape, fill, dtype=data.dtype,
                              device=data.device)
            red = "amax" if kind == "max" else "amin"
        return base.scatter_reduce(0, idx, data, red, include_self=True)
    return fn


def _b_segment(kind):
    return lambda p: _segment(kind, p["num_segments"])


for _op, _kind in [("SegmentSum", "sum"), ("SegmentMean", "mean"),
                   ("SegmentMax", "max"), ("SegmentMin", "min"),
                   ("SegmentProd", "prod"),
                   ("UnsortedSegmentSum", "sum"),
                   ("UnsortedSegmentMean", "mean"),
                   ("UnsortedSegmentMax", "max"),
                   ("UnsortedSegmentMin", "min"),
                   ("UnsortedSegmentProd", "prod")]:
    _BUILDERS[_op] = _b_segment(_kind)


@_b("LRN")
def _b_lrn(p):
    return lambda x: _norm.lrn(x, depth=2 * p.get("depth_radius", 5) + 1,
                               alpha=p.get("alpha", 1.0),
                               beta=p.get("beta", 0.5),
                               bias=p.get("bias", 1.0), data_format="NHWC")


@_b("Einsum")
def _b_einsum(p):
    eq = p["equation"]
    return lambda *xs: torch.einsum(eq, *xs)


@_b("Roll")
def _b_roll(p):
    shift, axis = p["shift"], p["axis"]
    return lambda x: torch.roll(x, shift, dims=axis)


@_b("ReverseSequence")
def _b_reverse_sequence(p):
    sa, ba = p.get("seq_dim", 1), p.get("batch_dim", 0)

    def fn(x, lens):
        xb = x.movedim((ba, sa), (0, 1))               # [B, T, ...]
        t = torch.arange(xb.shape[1], device=x.device)[None, :]
        ln = lens.long()[:, None]
        rev = torch.where(t < ln, ln - 1 - t, t)        # [B, T]
        idx = rev.reshape(rev.shape + (1,) * (xb.dim() - 2)).expand(xb.shape)
        return torch.gather(xb, 1, idx).movedim((0, 1), (ba, sa))
    return fn


@_b("BroadcastTo")
def _b_broadcast_to(p):
    shape = tuple(p["shape"])
    return lambda x: x.broadcast_to(shape)


@_b("LinSpace")
def _b_linspace(p):
    n = p["num"]

    def fn(start, stop):
        start, stop = _float(start), _float(stop)
        if n == 1:
            return start.reshape(1)
        i = torch.arange(n, dtype=start.dtype, device=start.device)
        out = start + i * ((stop - start) / (n - 1))
        return torch.where(i == n - 1, stop, out)
    return fn


@_b("Bincount")
def _b_bincount(p):
    n = p["size"]

    def fn(arr, w):
        x = arr.reshape(-1).long().clamp_min(0)     # jnp: negatives -> 0
        keep = x < n
        x = torch.where(keep, x, torch.zeros_like(x))
        if w.numel() == 0:
            vals, dt = keep.to(torch.int32), torch.int32
        else:
            dt = w.dtype
            vals = torch.where(keep, w.reshape(-1), torch.zeros_like(
                w.reshape(-1)))
        return torch.zeros(n, dtype=dt, device=arr.device).index_add_(
            0, x, vals)
    return fn


_BUILDERS["DenseBincount"] = _BUILDERS["Bincount"]


# ------------------------------------------------------------------- mappers
# _MAPPERS[tf_op](ctx, node, data_ins) -> (params, used_inputs, n_out)
# ``params`` must be JSON-able; consts consumed into params are dropped
# from used_inputs.

class _Ctx:
    """Per-import state handed to each op mapper."""

    def __init__(self, sd: SameDiff, library: Dict = None):
        self.sd = sd
        self.consts: Dict[str, Any] = {}     # const folding table
        # FunctionDefs by name (graph_def.library): the bodies of
        # StatelessWhile/StatelessIf/PartitionedCall nodes
        self.library: Dict[str, Any] = library or {}
        self.report = None      # import-time lint sink (E16x/W16x), set
        #                         by importGraphDef; None inside functions

    def const_of(self, name: str):
        if name not in self.consts:
            raise TFImportError(
                f"'{name}' must resolve to a compile-time constant in a "
                f"frozen graph (shape/axis inputs are static). "
                f"Shape-dependent dynamism does not import; re-export the "
                f"graph with static shapes.")
        return self.consts[name]


def _passthrough(n_in: Optional[int] = None):
    def m(ctx, node, ins):
        return {}, ins if n_in is None else ins[:n_in], 1
    return m


def _m_with_attrs(*attr_names, defaults=None):
    defaults = defaults or {}

    def m(ctx, node, ins):
        p = {}
        for a in attr_names:
            v = _attr(node, a, defaults.get(a))
            if v is not None:
                p[a] = v
        return p, ins, 1
    return m


def _ints(v) -> List[int]:
    return [int(x) for x in np.atleast_1d(np.asarray(v))]


def _m_matmul(ctx, node, ins):
    return {"transpose_a": _attr(node, "transpose_a", False),
            "transpose_b": _attr(node, "transpose_b", False)}, ins, 1


def _m_batchmatmul(ctx, node, ins):
    return {"adj_x": _attr(node, "adj_x", False),
            "adj_y": _attr(node, "adj_y", False)}, ins, 1


def _m_reduce(ctx, node, ins):
    axes = _ints(ctx.const_of(ins[1]))
    return {"axes": axes, "keep_dims": _attr(node, "keep_dims", False)}, \
        ins[:1], 1


def _m_reshape(ctx, node, ins):
    return {"shape": _ints(ctx.const_of(ins[1]))}, ins[:1], 1


def _m_transpose(ctx, node, ins):
    return {"perm": _ints(ctx.const_of(ins[1]))}, ins[:1], 1


def _m_concat(ctx, node, ins):
    return {"axis": int(ctx.const_of(ins[-1]))}, ins[:-1], 1


def _m_split(ctx, node, ins):
    n = _attr(node, "num_split")
    return {"num_split": n, "axis": int(ctx.const_of(ins[0]))}, ins[1:], n


def _m_splitv(ctx, node, ins):
    # SplitV(value, size_splits, axis)
    n = _attr(node, "num_split")
    sizes = _ints(ctx.const_of(ins[1]))
    if -1 in sizes:
        raise TFImportError("SplitV with inferred (-1) split size needs the "
                            "input dim; re-export with explicit sizes")
    return ({"size_splits": sizes, "axis": int(ctx.const_of(ins[2]))},
            ins[:1], n)


def _m_unpack(ctx, node, ins):
    n = _attr(node, "num")
    return {"num": n, "axis": _attr(node, "axis", 0)}, ins, n


def _m_squeeze(ctx, node, ins):
    return {"squeeze_dims": _attr(node, "squeeze_dims", []) or []}, ins, 1


def _m_expand_dims(ctx, node, ins):
    return {"axis": int(ctx.const_of(ins[1]))}, ins[:1], 1


def _m_cast(ctx, node, ins):
    return {"dst": _np_dtype_name(_attr(node, "DstT"))}, ins, 1


def _pad_rows(v) -> List[List[int]]:
    return [[int(x) for x in row] for row in np.asarray(v)]


def _m_pad(ctx, node, ins):
    return {"paddings": _pad_rows(ctx.const_of(ins[1]))}, ins[:1], 1


def _m_padv2(ctx, node, ins):
    return {"paddings": _pad_rows(ctx.const_of(ins[1]))}, [ins[0], ins[2]], 1


def _m_mirrorpad(ctx, node, ins):
    return {"paddings": _pad_rows(ctx.const_of(ins[1])),
            "mode": _attr(node, "mode", "REFLECT")}, ins[:1], 1


def _m_fill(ctx, node, ins):
    return {"dims": _ints(ctx.const_of(ins[0]))}, ins[1:], 1


def _m_range(ctx, node, ins):
    start = np.asarray(ctx.const_of(ins[0]))
    limit = np.asarray(ctx.const_of(ins[1]))
    delta = np.asarray(ctx.const_of(ins[2]))
    dt = np.result_type(start, limit, delta).name
    return ({"start": float(start), "limit": float(limit),
             "delta": float(delta), "dtype": dt}, [], 1)


def _m_tile(ctx, node, ins):
    return {"multiples": _ints(ctx.const_of(ins[1]))}, ins[:1], 1


def _m_cum(ctx, node, ins):
    return ({"axis": int(ctx.const_of(ins[1])),
             "exclusive": _attr(node, "exclusive", False),
             "reverse": _attr(node, "reverse", False)}, ins[:1], 1)


def _m_topk(ctx, node, ins):
    return {"k": int(ctx.const_of(ins[1]))}, ins[:1], 2


def _m_onehot(ctx, node, ins):
    # OneHot(indices, depth, on_value, off_value)
    return ({"depth": int(ctx.const_of(ins[1])),
             "on_value": float(ctx.const_of(ins[2])),
             "off_value": float(ctx.const_of(ins[3])),
             "axis": _attr(node, "axis", -1)}, ins[:1], 1)


def _m_gather(ctx, node, ins):
    ax = int(ctx.const_of(ins[2])) if len(ins) > 2 else 0
    return ({"axis": ax, "batch_dims": _attr(node, "batch_dims", 0)},
            ins[:2], 1)


def _m_strided_slice(ctx, node, ins):
    begin = _ints(ctx.const_of(ins[1]))
    end = _ints(ctx.const_of(ins[2]))
    step = _ints(ctx.const_of(ins[3]))
    bm = _attr(node, "begin_mask", 0)
    em = _attr(node, "end_mask", 0)
    sm = _attr(node, "shrink_axis_mask", 0)
    nm = _attr(node, "new_axis_mask", 0)
    el = _attr(node, "ellipsis_mask", 0)
    index = []
    for i in range(len(begin)):
        if el & (1 << i):
            index.append("...")
        elif nm & (1 << i):
            index.append("new")
        elif sm & (1 << i):
            index.append(begin[i])
        else:
            b = None if bm & (1 << i) else begin[i]
            e = None if em & (1 << i) else end[i]
            index.append([b, e, step[i]])
    return {"index": index}, ins[:1], 1


def _m_slice(ctx, node, ins):
    return {"begin": _ints(ctx.const_of(ins[1])),
            "size": _ints(ctx.const_of(ins[2]))}, ins[:1], 1


def _m_reverse(ctx, node, ins):
    return {"axes": _ints(ctx.const_of(ins[1]))}, ins[:1], 1


def _m_arg(ctx, node, ins):
    ax = int(ctx.const_of(ins[1])) if len(ins) > 1 else 0
    return {"axis": ax}, ins[:1], 1


def _m_conv2d(ctx, node, ins):
    if _attr(node, "data_format", "NHWC") != "NHWC":
        raise TFImportError("only NHWC TF convs import")
    return ({"strides": _attr(node, "strides", [1, 1, 1, 1]),
             "dilations": _attr(node, "dilations", [1, 1, 1, 1]),
             "padding": _conv_padding(node)}, ins, 1)


def _m_depthwise(ctx, node, ins):
    return ({"strides": _attr(node, "strides", [1, 1, 1, 1]),
             "padding": _conv_padding(node)}, ins, 1)


def _m_pool(ctx, node, ins):
    return ({"ksize": _attr(node, "ksize", [1, 1, 1, 1]),
             "strides": _attr(node, "strides", [1, 1, 1, 1]),
             "padding": _conv_padding(node)}, ins, 1)


def _m_fused_bn(ctx, node, ins):
    if _attr(node, "is_training", True):
        raise TFImportError("only inference-mode FusedBatchNorm imports "
                            "(freeze the graph); import TRAINING checkpoints "
                            "via modelimport.bert instead")
    return {"epsilon": _attr(node, "epsilon", 1e-3)}, ins, 1


def _m_space_to_batch(ctx, node, ins):
    return {"block_shape": _ints(ctx.const_of(ins[1])),
            "paddings": _pad_rows(ctx.const_of(ins[2]))}, ins[:1], 1


def _m_set_diag_v3(ctx, node, ins):
    k = _ints(ctx.const_of(ins[2]))[0] if len(ins) > 2 else 0
    if k != 0:
        raise TFImportError("MatrixSetDiagV3 with k != 0 does not import")
    return {}, ins[:2], 1


def _m_diag_part_v3(ctx, node, ins):
    k = _ints(ctx.const_of(ins[1]))[0] if len(ins) > 1 else 0
    if k != 0:
        raise TFImportError("MatrixDiagPartV3 with k != 0 does not import")
    return {}, ins[:1], 1


def _m_matrix_diag_v3(ctx, node, ins):
    # inputs: (diagonal, k, num_rows, num_cols, padding_value): the main
    # diagonal with default sizing and padding only; anything else fails
    # loudly rather than silently dropping the sizing inputs
    if len(ins) > 1 and _ints(ctx.const_of(ins[1]))[0] != 0:
        raise TFImportError("MatrixDiagV3 with k != 0 does not import")
    if len(ins) > 2:
        nr = _ints(ctx.const_of(ins[2]))[0]
        nc = _ints(ctx.const_of(ins[3]))[0] if len(ins) > 3 else -1
        if nr != -1 or nc != -1:
            raise TFImportError(
                "MatrixDiagV3 with explicit num_rows/num_cols does not "
                "import (square main-diagonal form only)")
    if len(ins) > 4 and float(np.atleast_1d(
            np.asarray(ctx.const_of(ins[4])))[0]) != 0.0:
        raise TFImportError(
            "MatrixDiagV3 with non-zero padding_value does not import")
    return {}, ins[:1], 1


def _m_batch_to_space(ctx, node, ins):
    return {"block_shape": _ints(ctx.const_of(ins[1])),
            "crops": _pad_rows(ctx.const_of(ins[2]))}, ins[:1], 1


def _m_scatter_nd(ctx, node, ins):
    return {"shape": _ints(ctx.const_of(ins[2]))}, ins[:2], 1


def _m_resize(ctx, node, ins):
    if _attr(node, "align_corners", False) or \
            not _attr(node, "half_pixel_centers", False):
        raise TFImportError(
            "only half_pixel_centers resize imports (the TF2 default); "
            "align_corners / TF1 asymmetric scaling would silently produce "
            "different pixels — re-export with tf.image.resize (TF2)")
    return {"size": _ints(ctx.const_of(ins[1]))}, ins[:1], 1


def _m_crop_and_resize(ctx, node, ins):
    return ({"crop_size": _ints(ctx.const_of(ins[3])),
             "extrapolation_value": _attr(node, "extrapolation_value", 0.0)},
            ins[:3], 1)


def _m_band_part(ctx, node, ins):
    return ({"num_lower": int(ctx.const_of(ins[1])),
             "num_upper": int(ctx.const_of(ins[2]))}, ins[:1], 1)


def _m_conv3d(ctx, node, ins):
    if _attr(node, "data_format", "NDHWC") != "NDHWC":
        raise TFImportError("only NDHWC Conv3D imports")
    return ({"strides": _attr(node, "strides", [1] * 5),
             "padding": _conv_padding(node)}, ins, 1)


def _m_pool3d(ctx, node, ins):
    return ({"ksize": _attr(node, "ksize", [1] * 5),
             "strides": _attr(node, "strides", [1] * 5),
             "padding": _conv_padding(node)}, ins, 1)


def _m_conv2d_backprop(ctx, node, ins):
    # Conv2DBackpropInput(input_sizes, filter, out_backprop)
    return ({"input_sizes": _ints(ctx.const_of(ins[0])),
             "strides": _attr(node, "strides", [1, 1, 1, 1]),
             "padding": _conv_padding(node)}, ins[1:], 1)


def _m_dilation2d(ctx, node, ins):
    return ({"strides": _attr(node, "strides", [1, 1, 1, 1]),
             "rates": _attr(node, "rates", [1, 1, 1, 1]),
             "padding": _conv_padding(node)}, ins, 1)


def _m_segment(ctx, node, ins):
    ids = np.atleast_1d(np.asarray(ctx.const_of(ins[1])))
    return {"num_segments": int(ids.max()) + 1}, ins, 1


def _m_unsorted_segment(ctx, node, ins):
    return {"num_segments": int(ctx.const_of(ins[2]))}, ins[:2], 1


def _m_roll(ctx, node, ins):
    shift = _ints(ctx.const_of(ins[1]))
    axis = _ints(ctx.const_of(ins[2]))
    if len(shift) == 1:
        shift, axis = shift[0], axis[0]
    return {"shift": shift, "axis": axis}, ins[:1], 1


def _m_broadcast_to(ctx, node, ins):
    return {"shape": _ints(ctx.const_of(ins[1]))}, ins[:1], 1


def _m_linspace(ctx, node, ins):
    return {"num": int(ctx.const_of(ins[2]))}, ins[:2], 1


def _m_bincount(ctx, node, ins):
    return {"size": int(ctx.const_of(ins[1]))}, [ins[0], ins[2]], 1


_MAPPERS: Dict[str, Callable] = {
    "MatMul": _m_matmul,
    "BatchMatMul": _m_batchmatmul,
    "BatchMatMulV2": _m_batchmatmul,
    "BiasAdd": _m_with_attrs("data_format"),
    "LeakyRelu": _m_with_attrs("alpha", defaults={"alpha": 0.2}),
    "Mean": _m_reduce, "Sum": _m_reduce, "Max": _m_reduce,
    "Min": _m_reduce, "Prod": _m_reduce, "All": _m_reduce, "Any": _m_reduce,
    "Reshape": _m_reshape,
    "Transpose": _m_transpose,
    "ConcatV2": _m_concat,
    "Split": _m_split,
    "SplitV": _m_splitv,
    "Unpack": _m_unpack,
    "Squeeze": _m_squeeze,
    "ExpandDims": _m_expand_dims,
    "Pack": _m_with_attrs("axis", defaults={"axis": 0}),
    "Cast": _m_cast,
    "Pad": _m_pad,
    "PadV2": _m_padv2,
    "MirrorPad": _m_mirrorpad,
    "Fill": _m_fill,
    "Range": _m_range,
    "Tile": _m_tile,
    "Cumsum": _m_cum,
    "Cumprod": _m_cum,
    "TopKV2": _m_topk,
    "OneHot": _m_onehot,
    "Conv2D": _m_conv2d,
    "DepthwiseConv2dNative": _m_depthwise,
    "MaxPool": _m_pool,
    "AvgPool": _m_pool,
    "FusedBatchNorm": _m_fused_bn,
    "FusedBatchNormV3": _m_fused_bn,
    "GatherV2": _m_gather,
    "Gather": _m_gather,
    "GatherNd": _passthrough(2),
    "StridedSlice": _m_strided_slice,
    "Slice": _m_slice,
    "Reverse": _m_reverse,
    "ReverseV2": _m_reverse,
    "ArgMax": _m_arg,
    "ArgMin": _m_arg,
    "ClipByValue": _passthrough(3),
    "SpaceToBatchND": _m_space_to_batch,
    "MatrixBandPart": _m_band_part,
    "MatrixSetDiagV3": _m_set_diag_v3,
    "MatrixDiagPartV3": _m_diag_part_v3,
    "MatrixDiagV3": _m_matrix_diag_v3,
    "BroadcastArgs": _passthrough(2),
    "DenseBincount": _m_bincount,
    "ScatterNd": _m_scatter_nd,
    "TensorScatterUpdate": _passthrough(3),
    "TensorScatterAdd": _passthrough(3),
    "TensorScatterSub": _passthrough(3),
    "ResizeBilinear": _m_resize,
    "ResizeNearestNeighbor": _m_resize,
    "CropAndResize": _m_crop_and_resize,
    "SpaceToDepth": _m_with_attrs("block_size", "data_format"),
    "DepthToSpace": _m_with_attrs("block_size", "data_format"),
    "BatchToSpaceND": _m_batch_to_space,
    "Conv2DBackpropInput": _m_conv2d_backprop,
    "Conv3D": _m_conv3d,
    "MaxPool3D": _m_pool3d,
    "AvgPool3D": _m_pool3d,
    "Dilation2D": _m_dilation2d,
    "SegmentSum": _m_segment, "SegmentMean": _m_segment,
    "SegmentMax": _m_segment, "SegmentMin": _m_segment,
    "SegmentProd": _m_segment,
    "UnsortedSegmentSum": _m_unsorted_segment,
    "UnsortedSegmentMean": _m_unsorted_segment,
    "UnsortedSegmentMax": _m_unsorted_segment,
    "UnsortedSegmentMin": _m_unsorted_segment,
    "UnsortedSegmentProd": _m_unsorted_segment,
    "LRN": _m_with_attrs("depth_radius", "bias", "alpha", "beta"),
    "Einsum": _m_with_attrs("equation"),
    "Roll": _m_roll,
    "ReverseSequence": _m_with_attrs("seq_dim", "batch_dim"),
    "BroadcastTo": _m_broadcast_to,
    "LinSpace": _m_linspace,
    "Bincount": _m_bincount,
}
for _op in list(_SIMPLE_OPS) + list(_SIMPLE_OPS_R4):
    if _op not in _MAPPERS:
        _MAPPERS[_op] = _passthrough()


def _var_name(ref: str) -> str:
    """TF input ref 'name', 'name:0', 'name:k' -> our variable name."""
    if ":" in ref:
        base, idx = ref.rsplit(":", 1)
        return base if idx == "0" else f"{base}:{idx}"
    return ref


class TFGraphImport:
    """ref: TensorflowFrameworkImporter (samediff-import-tensorflow)."""

    @staticmethod
    def importGraphDef(graph_def, device=None) -> SameDiff:
        """A frozen GraphDef (bytes, a path to a binary ``.pb``, or a
        decoded :class:`.tf_proto.GraphDef`) -> SameDiff on ``device``
        (the card unless the caller asks for the CPU)."""
        if hasattr(graph_def, "SerializeToString"):
            graph_def = graph_def.SerializeToString()
        if not isinstance(graph_def, tf_proto.GraphDef):
            graph_def = tf_proto.load_graph_def(graph_def)

        sd = SameDiff.create(device)
        library = {f.signature.name: f
                   for f in graph_def.library.function} \
            if graph_def.HasField("library") else {}
        ctx = _Ctx(sd, library)
        ctx.report = _imp.ValidationReport(subject="TF import")
        nodes = list(graph_def.node)
        if any(n.op in _V1_CF_OPS for n in nodes):
            nodes = _topo_sort(nodes)
            skip, plans = _plan_deframe(nodes)
            # frame-collapsed order: every frame imports as ONE unit, after
            # all its outer inputs and before every consumer of its Exits
            for item in _collapsed_order(nodes, plans):
                if isinstance(item, str):
                    _apply_deframe_plan(ctx, plans[item])
                elif item.name not in skip:
                    _import_one(ctx, item, _var_name)
        else:
            for node in nodes:
                _import_one(ctx, node, _var_name)
        # W161 from the recorded placeholders, then the findings the
        # import loop itself collected (E163 consts, W163 folds)
        report = _imp.samediff_import_report(sd)
        report.extend(ctx.report.diagnostics)
        sd.import_report = report
        return sd


def _import_one(ctx: _Ctx, node, resolver):
    """Import one NodeDef into ctx.sd (shared by the GraphDef loop and
    FunctionDef bodies; ``resolver`` maps the container's input-ref syntax
    to variable names)."""
    data_ins = [resolver(i) for i in node.input if not i.startswith("^")]
    if node.op == "Const":
        val = _tensor_value(node)
        if ctx.report is not None:
            ctx.report.extend(_imp.lint_narrowed_array(
                val, f"const '{node.name}'"))
        ctx.consts[node.name] = val
        ctx.sd.constant(val, name=node.name)
    elif node.op == "Placeholder":
        shape = _attr(node, "shape")
        shape = tuple(None if d in (-1, 0) and i == 0 else
                      (None if d == -1 else d)
                      for i, d in enumerate(shape or []))
        dt = _attr(node, "dtype") or torch.float32
        ctx.sd.placeHolder(node.name, shape=shape or None, dtype=dt)
    elif node.op == "NoOp":
        return
    elif node.op in _MAPPERS:
        params, used, n_out = _MAPPERS[node.op](ctx, node, data_ins)
        _record_tf_node(ctx, node, params, used, n_out)
    else:
        raise TFImportError(
            f"unmapped TF op '{node.op}' (node '{node.name}') — add "
            f"a mapper to modelimport.tensorflow._MAPPERS. (TF1 "
            f"Enter/Exit/Merge control-flow frames and training-mode ops "
            f"intentionally do not import; TF2 functional control flow "
            f"(StatelessWhile/StatelessIf/While/If) does.)")


def _fn_var_name(ref: str) -> str:
    """FunctionDef-body input ref -> variable name: 'arg' stays, a
    'node:field:k' output ref collapses to the GraphDef ':k' convention."""
    parts = ref.split(":")
    if len(parts) == 1:
        return parts[0]
    if len(parts) == 3:
        return parts[0] if parts[2] == "0" else f"{parts[0]}:{parts[2]}"
    return _var_name(ref)


def _import_function(ctx: _Ctx, fname: str):
    """FunctionDef -> (sub-SameDiff, output names). Function args become
    placeholders in signature order: the subgraph call convention
    (autodiff.samediff.subgraph_fn)."""
    if fname not in ctx.library:
        raise TFImportError(f"function '{fname}' not in graph library")
    fdef = ctx.library[fname]
    sub = SameDiff.create("cpu")
    sctx = _Ctx(sub, ctx.library)
    for arg in fdef.signature.input_arg:
        sub.placeHolder(arg.name, shape=None,
                        dtype=_DTYPES.get(arg.type, torch.float32))
    for node in fdef.node_def:
        _import_one(sctx, node, _fn_var_name)
    outs = [_fn_var_name(fdef.ret[o.name])
            for o in fdef.signature.output_arg]
    return sub, outs


def _m_functional_while(ctx, node, ins):
    """TF2 functional while (ref: the interpreted Enter/Exit/Merge frame
    loop), a loop over SameDiff subgraph bodies."""
    cond_sd, cond_outs = _import_function(ctx, node.attr["cond"].func.name)
    body_sd, body_outs = _import_function(ctx, node.attr["body"].func.name)
    if len(body_outs) != len(ins):
        raise TFImportError(
            f"While '{node.name}': body returns {len(body_outs)} values "
            f"for {len(ins)} loop vars")
    params = {"cond": _sdmod.subgraph_spec(cond_sd, cond_outs),
              "body": _sdmod.subgraph_spec(body_sd, body_outs)}
    return params, ins, len(ins)


def _m_functional_if(ctx, node, ins):
    then_sd, then_outs = _import_function(
        ctx, node.attr["then_branch"].func.name)
    else_sd, else_outs = _import_function(
        ctx, node.attr["else_branch"].func.name)
    params = {"then": _sdmod.subgraph_spec(then_sd, then_outs),
              "else": _sdmod.subgraph_spec(else_sd, else_outs)}
    return params, ins, len(then_outs)


def _m_partitioned_call(ctx, node, ins):
    sub, outs = _import_function(ctx, node.attr["f"].func.name)
    return {"sub": _sdmod.subgraph_spec(sub, outs)}, ins, len(outs)


_MAPPERS["StatelessWhile"] = _m_functional_while
_MAPPERS["While"] = _m_functional_while
_MAPPERS["StatelessIf"] = _m_functional_if
_MAPPERS["If"] = _m_functional_if
_MAPPERS["PartitionedCall"] = _m_partitioned_call
_MAPPERS["StatefulPartitionedCall"] = _m_partitioned_call

_BUILDERS["StatelessWhile"] = lambda p: _sdmod._make_subwhile_fn(p)
_BUILDERS["While"] = lambda p: _sdmod._make_subwhile_fn(p)
_BUILDERS["StatelessIf"] = lambda p: _sdmod._make_subcond_fn(
    {"true": p["then"], "false": p["else"]})
_BUILDERS["If"] = _BUILDERS["StatelessIf"]
_BUILDERS["PartitionedCall"] = lambda p: _sdmod._make_subcall_fn(p)
_BUILDERS["StatefulPartitionedCall"] = _BUILDERS["PartitionedCall"]


# ---------------------------------------------------- v1 frame deframing
# The reference INTERPRETS Enter/Exit/Merge/Switch frames at runtime.
# Default-frozen graphs with loops are DEFRAMED here: each while frame is
# rebuilt into functional cond/body subgraphs and imported exactly like a
# StatelessWhile.

_V1_CF_OPS = {"Enter", "Exit", "Merge", "Switch", "NextIteration",
              "LoopCond"}


def _topo_sort(nodes):
    """Topological order by data edges (GraphDef order is not guaranteed
    topological once the lowering pass has rewritten control flow; the
    recorded SameDiff node order must be executable top-down). Merge's
    NextIteration back-edge is ignored: it is the one legal cycle."""
    by_name = {n.name: n for n in nodes}
    indeg = {n.name: 0 for n in nodes}
    consumers: Dict[str, List[str]] = {n.name: [] for n in nodes}
    for n in nodes:
        for ref in n.input:
            if ref.startswith("^"):
                continue
            p = ref.split(":")[0]
            if p in by_name and not (
                    n.op == "Merge" and by_name[p].op == "NextIteration"):
                indeg[n.name] += 1
                consumers[p].append(n.name)
    q = deque(n.name for n in nodes if indeg[n.name] == 0)
    out = []
    while q:
        name = q.popleft()
        out.append(by_name[name])
        for c in consumers[name]:
            indeg[c] -= 1
            if indeg[c] == 0:
                q.append(c)
    if len(out) != len(nodes):            # a real cycle: keep input order
        return list(nodes)
    return out


def _collapsed_order(nodes, plans):
    """Topological order with each frame collapsed to one super-node.
    Yields NodeDefs and frame keys (strings)."""
    member_of = {}
    for key, plan in plans.items():
        for m in plan["members"]:
            member_of[m] = key
    by_name = {n.name: n for n in nodes}
    items = [n.name for n in nodes if n.name not in member_of] + list(plans)
    indeg = {i: 0 for i in items}
    consumers = {i: [] for i in items}

    def item_of(name):
        return member_of.get(name, name)

    seen_edges = set()
    for n in nodes:
        dst = item_of(n.name)
        for ref in n.input:
            if ref.startswith("^"):      # control edges don't gate data
                continue
            p = ref.split(":")[0]
            if p not in by_name:
                continue
            src = item_of(p)
            if src == dst or (src, dst) in seen_edges:
                continue
            seen_edges.add((src, dst))
            indeg[dst] += 1
            consumers[src].append(dst)
    q = deque(i for i in items if indeg[i] == 0)
    out = []
    while q:
        i = q.popleft()
        out.append(i if i in plans else by_name[i])
        for c in consumers[i]:
            indeg[c] -= 1
            if indeg[c] == 0:
                q.append(c)
    if len(out) != len(items):
        raise TFImportError(
            "cyclic dependency between v1 control-flow frames — re-export "
            "with lower_control_flow=False")
    return out


def _plan_deframe(nodes):
    """Group v1 control-flow nodes into while-frame plans.

    Returns (skip: names the main loop must not import, plans: frame
    key -> plan); the import loop runs frames via _collapsed_order."""
    by_name = {n.name: n for n in nodes}

    def producer(ref):
        return by_name.get(ref.split(":")[0].lstrip("^"))

    frames: Dict[str, List] = {}
    for n in nodes:
        if n.op == "Enter":
            frames.setdefault(_attr(n, "frame_name"), []).append(n)
    # Merge/Switch outside any while frame = the v1 tf.cond idiom
    framed_merges = set()
    for f, enters in frames.items():
        for n in nodes:
            if n.op == "Merge" and any(
                    producer(i) in enters for i in n.input):
                framed_merges.add(n.name)
    framed_switches = set()
    for f, enters in frames.items():
        for n in nodes:
            if n.op == "Switch" and any(
                    producer(i) is not None
                    and producer(i).name in framed_merges
                    for i in n.input):
                framed_switches.add(n.name)
    for n in nodes:
        if (n.op == "Merge" and n.name not in framed_merges) or (
                n.op == "Switch" and n.name not in framed_switches):
            raise TFImportError(
                "v1 Switch/Merge conditional frames do not import "
                "(no static representation for them) — re-export "
                "with lower_control_flow=False, which keeps "
                "functional StatelessIf nodes")

    skip, plans = set(), {}
    for frame, enters in frames.items():
        plan = _plan_one_frame(frame, enters, nodes, by_name, producer)
        skip |= plan["members"]
        plans[frame] = plan
    return skip, plans


def _plan_one_frame(frame, enters, nodes, by_name, producer):
    merges = [n for n in nodes if n.op == "Merge"
              and any(producer(i) in enters for i in n.input)]
    loopconds = {producer(s.input[1]).name for s in nodes
                 if s.op == "Switch"
                 and producer(s.input[0]) in merges}
    if len(loopconds) != 1:
        raise TFImportError(
            f"while frame '{frame}': expected one LoopCond, found "
            f"{len(loopconds)} (nested/irregular frames do not import — "
            f"re-export with lower_control_flow=False)")
    loopcond = by_name[next(iter(loopconds))]

    carries = []          # (enter, merge, switch, nextit, exit_or_None)
    for m in merges:
        enter = next(producer(i) for i in m.input
                     if producer(i) in enters)
        nextit = next((producer(i) for i in m.input
                       if producer(i) is not None
                       and producer(i).op == "NextIteration"), None)
        switch = next((s for s in nodes if s.op == "Switch"
                       and producer(s.input[0]) is m), None)
        if nextit is None or switch is None:
            raise TFImportError(
                f"while frame '{frame}': irregular Merge "
                f"'{m.name}' (no NextIteration/Switch pair)")
        ex = next((e for e in nodes if e.op == "Exit"
                   and producer(e.input[0]) is switch), None)
        carries.append((enter, m, switch, nextit, ex))
    const_enters = [e for e in enters if _attr(e, "is_constant", False)]

    # interior sets: ancestors of the cond output / body outputs, stopping
    # at the frame boundary (merges for cond, switch:1 for body)
    def interior(seeds, stop_names):
        seen, out = set(), set()
        stack = [s.split(":")[0] for s in seeds]
        while stack:
            name = stack.pop()
            if name in seen or name in stop_names:
                continue
            seen.add(name)
            n = by_name.get(name)
            if n is None:
                continue
            if n.op in _V1_CF_OPS:
                if n in const_enters:
                    continue          # invariant: resolved at build time
                raise TFImportError(
                    f"while frame '{frame}': nested v1 control flow does "
                    f"not import — re-export with lower_control_flow=False")
            out.add(name)
            stack.extend(i.split(":")[0].lstrip("^") for i in n.input
                         if not i.startswith("^"))
        return out

    merge_names = {c[1].name for c in carries}
    switch_names = {c[2].name for c in carries}
    cond_nodes = interior([loopcond.input[0]], merge_names)
    body_nodes = interior([c[3].input[0] for c in carries], switch_names)
    members = ({n.name for n in enters} | merge_names | switch_names
               | {c[3].name for c in carries}
               | {c[4].name for c in carries if c[4] is not None}
               | {loopcond.name} | cond_nodes | body_nodes)
    return {"frame": frame, "carries": carries, "loopcond": loopcond,
            "cond_nodes": cond_nodes, "body_nodes": body_nodes,
            "const_enters": const_enters, "members": members,
            "nodes": nodes, "by_name": by_name}


def _apply_deframe_plan(ctx: _Ctx, plan):
    """Build cond/body subgraphs from the frame interior and record ONE
    functional while node in place of the whole frame."""
    carries = plan["carries"]
    base = f"{plan['frame']}_deframed"

    # carry list: loop vars first, then invariants (is_constant Enters +
    # any interior ref produced outside the frame), in the same order in
    # init/cond/body, the invariants carried through unchanged
    invariants: List[str] = []          # outer refs, discovery order

    def build_sub(node_names, boundary):
        """Import a frame interior into a fresh subgraph. Invariant
        placeholders are declared LATER (same order on both subs);
        _record_fn only stores input names, so forward references to the
        not-yet-declared ``inv{i}`` placeholders are fine."""
        sub = SameDiff.create("cpu")
        sctx = _Ctx(sub, ctx.library)
        ph = {ref: f"carry{i}" for i, ref in enumerate(boundary)}
        for i in range(len(boundary)):
            sub.placeHolder(f"carry{i}", shape=None, dtype=torch.float32)

        def resolve(ref):
            if ref in ph:
                return ph[ref]
            if ref.split(":")[0] in node_names:
                return _var_name(ref)
            # produced outside the frame: invariant carry
            for e in plan["const_enters"]:
                if ref.split(":")[0] == e.name:
                    ref = e.input[0]
                    break
            if ref not in invariants:
                invariants.append(ref)
            return f"inv{invariants.index(ref)}"

        for n in plan["nodes"]:
            if n.name in node_names:
                _import_one(sctx, n, resolve)
        return sub, resolve

    cond_boundary = [c[1].name for c in carries]
    body_boundary = [f"{c[2].name}:1" for c in carries]
    cond_sub, cond_resolve = build_sub(plan["cond_nodes"], cond_boundary)
    cond_out = cond_resolve(plan["loopcond"].input[0])
    body_sub, body_resolve = build_sub(plan["body_nodes"], body_boundary)
    body_outs = [body_resolve(c[3].input[0]) for c in carries]

    # invariants become trailing carries on BOTH subs, identical order
    for i in range(len(invariants)):
        iv = f"inv{i}"
        cond_sub.placeHolder(iv, shape=None, dtype=torch.float32)
        body_sub.placeHolder(iv, shape=None, dtype=torch.float32)
        body_outs.append(iv)

    params = {"cond": _sdmod.subgraph_spec(cond_sub, [cond_out]),
              "body": _sdmod.subgraph_spec(body_sub, body_outs)}
    init_refs = [_var_name(c[0].input[0]) for c in carries] \
        + [_var_name(r) for r in invariants]
    fn = _sdmod._make_subwhile_fn(params)
    n_out = len(init_refs)
    ctx.sd._record_fn("tf.While", lambda *a, _f=fn, **kw: _f(*a), init_refs,
                      name=base, n_out=n_out, rebuild="tf",
                      attrs={"tf_op": "While", "params": params})
    # route each Exit node's name onto the matching while output
    for i, c in enumerate(carries):
        if c[4] is not None:
            out_name = base if (i == 0 and n_out == 1) else f"{base}:{i}"
            ctx.sd._rename(out_name, c[4].name)


def _fold_output_size_ok(fn, ins: List) -> bool:
    """Bound the FOLDED result's size without materializing it (Fill, Tile
    and OneHot have tiny inputs but unbounded outputs): the builder runs on
    ``meta`` tensors, which carry shapes and no data."""
    try:
        metas = [torch.empty(tuple(t.shape), dtype=t.dtype, device="meta")
                 for t in ins]
        out = fn(*metas)
    except Exception:      # no meta kernel, or a data-dependent op
        return False
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return sum(o.numel() for o in outs) <= _FOLD_LIMIT


def _record_tf_node(ctx: _Ctx, node, params: dict, used: List[str],
                    n_out: int):
    fn = _BUILDERS[node.op](params)

    # const-fold: all data inputs known at import time, inputs AND outputs
    # bounded (collapses frozen-graph shape arithmetic into static operands)
    if used and all(u in ctx.consts and not (
            isinstance(ctx.consts[u], np.ndarray)
            and ctx.consts[u].dtype == object) for u in used) and \
            sum(ctx.consts[u].size if isinstance(ctx.consts[u], np.ndarray)
                else ctx.consts[u].numel() for u in used) <= _FOLD_LIMIT:
        ins = [_to_torch(ctx.consts[u]) for u in used]
        if _fold_output_size_ok(fn, ins):
            with torch.no_grad():
                res = fn(*ins)
            outs = [_to_host(r) for r in (res if n_out > 1 else (res,))]
            if ctx.report is not None:
                ctx.report.extend(_imp.fold_overflow_diags(
                    node.op, node.name, outs))
            for i, arr in enumerate(outs):
                name = node.name if (i == 0 and n_out == 1) \
                    else f"{node.name}:{i}"
                ctx.consts[name] = arr
                ctx.sd.constant(arr, name=name)
            if n_out > 1:   # downstream ':0' refs collapse to the bare name
                ctx.consts[node.name] = ctx.consts[f"{node.name}:0"]
                ctx.sd._rename(f"{node.name}:0", node.name)
            return

    if node.op == "Range" and not used:
        # all inputs const by construction; length bounded before folding
        n_elem = int(max(0, np.ceil((params["limit"] - params["start"])
                                    / params["delta"])))
        if n_elem > _FOLD_LIMIT:
            raise TFImportError(
                f"Range '{node.name}' would materialize {n_elem} elements")
        arr = fn().numpy()
        ctx.consts[node.name] = arr
        ctx.sd.constant(arr, name=node.name)
        return

    ctx.sd._record_fn(f"tf.{node.op}", lambda *a, _f=fn, **kw: _f(*a), used,
                      name=node.name, n_out=n_out, rebuild="tf",
                      attrs={"tf_op": node.op, "params": params})
    if n_out > 1:
        # TF refs 'name:0' collapse to the bare name in _var_name; align
        # output 0 with that convention (Split naming)
        ctx.sd._rename(f"{node.name}:0", node.name)


importTensorflowGraph = TFGraphImport.importGraphDef
