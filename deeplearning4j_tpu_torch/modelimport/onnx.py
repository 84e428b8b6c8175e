"""ONNX model import into the port's SameDiff — the port of
``deeplearning4j_tpu/modelimport/onnx.py``.

Reference parity: ``nd4j/samediff-import/samediff-import-onnx``,
``OnnxFrameworkImporter.runImport``, maps an ONNX GraphProto node by node
into SameDiff. The design is the JAX importer's and :mod:`.tensorflow`'s:

- Every ONNX op maps through a **builder** ``_BUILDERS[op](params) -> fn``
  whose ``params`` are JSON-able and taken at import time. Imported nodes
  record as ``onnx.<Op>`` with ``rebuild="onnx"``, so they serialize
  through ``SameDiff.save()``/``load()`` in the JAX package's format.
- Inputs that must be constants (a Reshape's shape, a Slice's bounds,
  ``_CONST_INPUTS``) are consumed into the params.
- A node whose inputs are all constants (and small, ``_FOLD_LIMIT``) is
  folded at import, on the CPU, into a constant; a fold that overflows
  adds a ``DL4J-W163`` to the report.
- The builders are plain torch, run eagerly on the graph's device, with
  the dtypes the JAX package computes in (x64 off: int64 -> int32,
  float64 -> float32). ``Softmax`` is ``torch.softmax`` and
  ``BatchNormalization`` inline math, as the JAX builders are
  ``jax.nn.softmax`` and inline math: an imported graph launches no
  hand-written kernel.

The model is parsed by :mod:`.onnx_proto` (no ``onnx`` package), and
:func:`importOnnxModel` attaches the pre-import lints of
``analysis.imports.lint_onnx_model`` (E161-E163, W161) and the fold
findings as ``sd.import_report``. Semantics follow opset 13+, as in the
JAX importer (Softmax axis-wise; Squeeze/Unsqueeze axes as inputs or
attributes).
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.analysis import imports as _imp
from deeplearning4j_tpu_torch.autodiff import samediff as _sdmod
from deeplearning4j_tpu_torch.autodiff.samediff import SameDiff
from deeplearning4j_tpu_torch.modelimport import onnx_proto as op_
from deeplearning4j_tpu_torch.modelimport import tensorflow as _tfi
from deeplearning4j_tpu_torch.modelimport.onnx_proto import (ModelProto,
                                                             NodeProto)


class OnnxImportError(ValueError):
    pass


_FOLD_LIMIT = 1 << 20

#: the dtypes the JAX package computes in without x64
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32,
           torch.uint64: torch.uint32}

# ------------------------------------------------------------------ builders

_BUILDERS: Dict[str, Callable[[dict], Callable]] = {}


def _simple(op: str, fn: Callable):
    _BUILDERS[op] = lambda p, _f=fn: _f


def _global_pool(reduce):
    def fn(x):
        return reduce(x, dim=tuple(range(2, x.dim())), keepdim=True)
    return fn


_SIMPLE_OPS = {
    "Add": lambda a, b: a + b,
    "Sub": lambda a, b: a - b,
    "Mul": lambda a, b: a * b,
    "Div": lambda a, b: a / b,
    "Pow": torch.pow,
    "Max": torch.maximum,
    "Min": torch.minimum,
    "Neg": torch.neg,
    "Abs": torch.abs,
    "Exp": torch.exp,
    "Log": torch.log,
    "Sqrt": torch.sqrt,
    "Reciprocal": _tfi._reciprocal,
    "Floor": torch.floor,
    "Ceil": torch.ceil,
    "Round": torch.round,       # half to even, as jnp.round
    "Sign": _tfi._sign,
    "Relu": torch.relu,
    "Sigmoid": torch.sigmoid,
    "Tanh": torch.tanh,
    "Erf": torch.erf,
    "Softplus": _tfi._softplus,
    "Softsign": F.softsign,
    "Selu": F.selu,
    "Identity": lambda x: x,
    "MatMul": torch.matmul,
    "Sin": torch.sin,
    "Cos": torch.cos,
    "Where": torch.where,
    "Equal": lambda a, b: a == b,
    "Greater": lambda a, b: a > b,
    "GreaterOrEqual": lambda a, b: a >= b,
    "Less": lambda a, b: a < b,
    "LessOrEqual": lambda a, b: a <= b,
    "Not": torch.logical_not,
    "And": torch.logical_and,
    "Or": torch.logical_or,
    "GlobalAveragePool": _global_pool(torch.mean),
    "GlobalMaxPool": _global_pool(torch.amax),
    # the JAX builder's jnp.int64 is int32 with x64 off
    "Shape": lambda x: torch.tensor(tuple(x.shape), dtype=torch.int32,
                                    device=x.device),
    "Size": lambda x: torch.tensor(x.numel(), dtype=torch.int32,
                                   device=x.device),
}
for _op, _fn in _SIMPLE_OPS.items():
    _simple(_op, _fn)


def _b(op):
    def deco(fn):
        _BUILDERS[op] = fn
        return fn
    return deco


@_b("Gemm")
def _b_gemm(p):
    alpha, beta = p.get("alpha", 1.0), p.get("beta", 1.0)
    ta, tb = p.get("transA", 0), p.get("transB", 0)

    def fn(a, b, c=None):
        a = a.T if ta else a
        b = b.T if tb else b
        y = alpha * (a @ b)
        if c is not None:
            y = y + beta * c
        return y
    return fn


@_b("Softmax")
def _b_softmax(p):
    axis = p.get("axis", -1)
    return lambda x: torch.softmax(x, dim=axis)


@_b("LogSoftmax")
def _b_logsoftmax(p):
    axis = p.get("axis", -1)
    return lambda x: torch.log_softmax(x, dim=axis)


@_b("LeakyRelu")
def _b_leaky(p):
    alpha = p.get("alpha", 0.01)
    return lambda x: torch.where(x >= 0, x, alpha * x)


@_b("Elu")
def _b_elu(p):
    alpha = p.get("alpha", 1.0)
    return lambda x: torch.where(x >= 0, x, alpha * (torch.exp(x) - 1.0))


@_b("HardSigmoid")
def _b_hardsigmoid(p):
    a, b = p.get("alpha", 0.2), p.get("beta", 0.5)
    return lambda x: torch.clamp(a * x + b, 0.0, 1.0)


@_b("Gelu")
def _b_gelu(p):
    approx = p.get("approximate", "none")
    if isinstance(approx, bytes):
        approx = approx.decode()
    mode = "tanh" if approx == "tanh" else "none"
    return lambda x: F.gelu(x, approximate=mode)


@_b("Clip")
def _b_clip(p):
    lo = p.get("min")
    hi = p.get("max")

    def fn(x, *mm):
        lo_v = mm[0] if len(mm) > 0 else lo
        hi_v = mm[1] if len(mm) > 1 else hi
        if lo_v is None and hi_v is None:
            return x                  # jnp.clip(x, None, None)
        return torch.clamp(x, lo_v, hi_v)
    return fn


@_b("Transpose")
def _b_transpose(p):
    perm = p.get("perm")

    def fn(x):
        return x.permute(tuple(perm) if perm
                         else tuple(reversed(range(x.dim()))))
    return fn


@_b("Reshape")
def _b_reshape(p):
    shape = tuple(p["shape"])
    return lambda x: torch.reshape(x, shape)


@_b("Flatten")
def _b_flatten(p):
    axis = p.get("axis", 1)

    def fn(x):
        lead = int(np.prod(x.shape[:axis])) if axis else 1
        return torch.reshape(x, (lead, -1))
    return fn


@_b("Concat")
def _b_concat(p):
    axis = p["axis"]
    return lambda *xs: torch.cat(xs, dim=axis)


@_b("Squeeze")
def _b_squeeze(p):
    axes = p.get("axes")

    def fn(x):
        if not axes:
            return torch.squeeze(x)
        return torch.squeeze(x, dim=tuple(a % x.dim() for a in axes))
    return fn


@_b("Unsqueeze")
def _b_unsqueeze(p):
    axes = sorted(p["axes"])

    def fn(x):
        for a in axes:
            x = torch.unsqueeze(x, a)
        return x
    return fn


@_b("Gather")
def _b_gather(p):
    axis = p.get("axis", 0)
    # jnp.take wraps a negative in-range index; index_select refuses one
    return lambda x, idx: _tfi._take(x, idx.to(torch.int32), axis % x.dim())


@_b("Slice")
def _b_slice(p):
    starts, ends = list(p["starts"]), list(p["ends"])
    axes = list(p.get("axes") or range(len(starts)))
    steps = list(p.get("steps") or [1] * len(starts))

    def fn(x):
        for s, e, a, st in zip(starts, ends, axes, steps):
            # ONNX uses INT64_MAX-ish sentinels for "to the end"
            e_ = None if e >= (1 << 31) else e
            s_ = None if (st > 0 and s == 0) else s
            a = a % x.dim()
            lo, hi, step = slice(s_, e_, st).indices(x.shape[a])
            if step > 0:
                x = x[(slice(None),) * a + (slice(lo, hi, step),)]
            else:                       # torch slices take no negative step
                idx = torch.arange(lo, hi, step, device=x.device)
                x = x.index_select(a, idx)
        return x
    return fn


def _cast_dtype(to: int) -> torch.dtype:
    dt = op_.torch_dtype(to)
    return _NARROW.get(dt, dt)


@_b("Cast")
def _b_cast(p):
    dt = _cast_dtype(p["to"])
    return lambda x: x.to(dt)


def _float(x):
    return x if x.is_floating_point() else x.float()


def _reduce_all(x, axes):
    return tuple(range(x.dim())) if not axes \
        else tuple(sorted({a % x.dim() for a in axes}))


def _r_mean(x, dims, keep):
    return torch.mean(_float(x), dim=dims, keepdim=keep)


def _r_sum(x, dims, keep):
    out_dt = torch.int32 if x.dtype == torch.bool else x.dtype
    return torch.sum(x, dim=dims, keepdim=keep).to(out_dt)


def _r_prod(x, dims, keep):
    out_dt = torch.int32 if x.dtype == torch.bool else x.dtype
    for d in reversed(dims):
        x = torch.prod(x, dim=d, keepdim=keep)
    return x.to(out_dt)


def _b_reduce(rfn):
    def build(p):
        axes = p.get("axes")
        keep = bool(p.get("keepdims", 1))

        def fn(x):
            dims = _reduce_all(x, axes)
            if x.dim() == 0:            # torch reads dim=() as "all"
                return x
            return rfn(x, dims, keep)
        return fn
    return build


for _op, _rfn in [("ReduceMean", _r_mean), ("ReduceSum", _r_sum),
                  ("ReduceMax", lambda x, d, k: torch.amax(x, dim=d,
                                                           keepdim=k)),
                  ("ReduceMin", lambda x, d, k: torch.amin(x, dim=d,
                                                           keepdim=k)),
                  ("ReduceProd", _r_prod)]:
    _BUILDERS[_op] = _b_reduce(_rfn)


def _flat_pads(pad_pairs):
    """[(lo, hi)] per spatial dim -> F.pad's flat list, last dim first."""
    out = []
    for lo, hi in reversed(pad_pairs):
        out += [lo, hi]
    return out


def _same_pairs(sizes, ks, strides, dil):
    """XLA's "SAME": the odd remainder after (``jax.lax`` SAME)."""
    flat = _tfi._same_pads(sizes, ks, strides, dil)
    pairs = [(flat[i], flat[i + 1]) for i in range(0, len(flat), 2)]
    return list(reversed(pairs))


@_b("Conv")
def _b_conv(p):
    strides = tuple(p.get("strides") or (1, 1))
    dil = tuple(p.get("dilations") or (1, 1))
    group = p.get("group", 1)
    pads = p.get("pads")
    auto = p.get("auto_pad", "NOTSET")
    if isinstance(auto, bytes):
        auto = auto.decode()
    same = auto in ("SAME_UPPER", "SAME_LOWER")   # both SAME, as in JAX
    if not same:
        pads = pads or [0] * (2 * len(strides))
        n = len(pads) // 2
        pairs = [(pads[i], pads[i + n]) for i in range(n)]

    def fn(x, w, b=None):
        nd = w.dim() - 2
        conv = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}[nd]
        pp = _same_pairs(x.shape[2:], w.shape[2:], strides[:nd], dil[:nd]) \
            if same else pairs[:nd]
        if all(lo == hi for lo, hi in pp):
            out = conv(x, w, None, stride=strides[:nd],
                       padding=tuple(lo for lo, _ in pp),
                       dilation=dil[:nd], groups=group)
        else:                             # asymmetric: pad first
            out = conv(F.pad(x, _flat_pads(pp)), w, None,
                       stride=strides[:nd], dilation=dil[:nd], groups=group)
        if b is not None:
            out = out + b.reshape((1, -1) + (1,) * nd)
        return out
    return fn


def _b_pool(max_pool: bool):
    def build(p):
        ks = tuple(p["kernel_shape"])
        strides = tuple(p.get("strides") or ks)
        pads = p.get("pads") or [0] * (2 * len(ks))
        n = len(ks)
        pairs = [(pads[i], pads[i + n]) for i in range(n)]
        count_include_pad = bool(p.get("count_include_pad", 0))
        # torch's own padding: symmetric, at most half the window
        native = all(lo == hi and 2 * lo <= k
                     for (lo, hi), k in zip(pairs, ks))

        def fn(x):
            nd = x.dim() - 2
            if max_pool:
                mp = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[nd]
                if native:
                    return mp(x, ks, strides,
                              padding=tuple(lo for lo, _ in pairs))
                return mp(F.pad(x, _flat_pads(pairs), value=-float("inf")),
                          ks, strides)
            ap = {1: F.avg_pool1d, 2: F.avg_pool2d, 3: F.avg_pool3d}[nd]
            if native:
                return ap(x, ks, strides,
                          padding=tuple(lo for lo, _ in pairs),
                          count_include_pad=count_include_pad)
            win = float(np.prod(ks))
            s = ap(F.pad(x, _flat_pads(pairs)), ks, strides) * win
            if count_include_pad:
                return s / win
            cnt = ap(F.pad(torch.ones_like(x[:1, :1]), _flat_pads(pairs)),
                     ks, strides) * win
            return s / cnt
        return fn
    return build


_BUILDERS["MaxPool"] = _b_pool(True)
_BUILDERS["AveragePool"] = _b_pool(False)


@_b("BatchNormalization")
def _b_batchnorm(p):
    eps = p.get("epsilon", 1e-5)

    def fn(x, gamma, beta, mean, var):
        shape = (1, -1) + (1,) * (x.dim() - 2)
        inv = gamma * torch.rsqrt(var + eps)
        return x * inv.reshape(shape) + (beta - mean * inv).reshape(shape)
    return fn


@_b("Pad")
def _b_pad(p):
    pads = list(p["pads"])
    mode = p.get("mode", "constant")
    if isinstance(mode, bytes):
        mode = mode.decode()
    value = p.get("value", 0.0)
    n = len(pads) // 2
    widths = [(pads[i], pads[i + n]) for i in range(n)]
    npmode = {"constant": "constant", "reflect": "reflect",
              "edge": "edge"}[mode]

    def fn(x):
        if npmode == "constant":
            return F.pad(x, _flat_pads(widths), value=value)
        for a, (lo, hi) in enumerate(widths):   # jnp.pad, one axis a time
            if lo or hi:
                idx = np.pad(np.arange(x.shape[a]), (lo, hi), mode=npmode)
                x = x.index_select(a, torch.from_numpy(idx).to(x.device))
        return x
    return fn


@_b("Expand")
def _b_expand(p):
    shape = tuple(p["shape"])
    return lambda x: torch.broadcast_to(
        x, torch.broadcast_shapes(tuple(x.shape), shape))


@_b("Split")
def _b_split(p):
    axis = p.get("axis", 0)
    sizes = p.get("split")
    n = p["n_out"]

    def fn(x):
        if sizes:
            return tuple(torch.split(x, list(sizes), dim=axis))
        if x.shape[axis] % n:
            raise ValueError(f"Split: axis {axis} of size {x.shape[axis]} "
                             f"does not divide into {n}")
        return tuple(torch.split(x, x.shape[axis] // n, dim=axis))
    return fn


@_b("Dropout")
def _b_dropout(p):
    return lambda x, *rest: x          # inference import


def _onnx_rebuild(attrs: dict) -> Callable:
    """``_FN_REBUILDERS['onnx']``: an imported node's callable from its
    serialized (onnx_op, params); kwargs from attrs are swallowed."""
    fn = _BUILDERS[attrs["onnx_op"]](dict(attrs.get("params") or {}))
    return lambda *a, **kw: fn(*a)


_sdmod._FN_REBUILDERS["onnx"] = _onnx_rebuild


# ------------------------------------------------------------------ importer

# inputs that must be compile-time constants, per op: (input_idx, param_key,
# transform). Consumed into params and dropped from the node's data inputs.
_CONST_INPUTS = {
    "Reshape": [(1, "shape", lambda a: [int(v) for v in a])],
    "Expand": [(1, "shape", lambda a: [int(v) for v in a])],
    "Squeeze": [(1, "axes", lambda a: [int(v) for v in a])],
    "Unsqueeze": [(1, "axes", lambda a: [int(v) for v in a])],
    "Slice": [(1, "starts", lambda a: [int(v) for v in a]),
              (2, "ends", lambda a: [int(v) for v in a]),
              (3, "axes", lambda a: [int(v) for v in a]),
              (4, "steps", lambda a: [int(v) for v in a])],
    "Pad": [(1, "pads", lambda a: [int(v) for v in a]),
            (2, "value", lambda a: float(np.asarray(a).reshape(()))),
            ],
    "ReduceSum": [(1, "axes", lambda a: [int(v) for v in a])],
    "ReduceMean": [(1, "axes", lambda a: [int(v) for v in a])],
    "Split": [(1, "split", lambda a: [int(v) for v in a])],
}


class OnnxGraphImport:
    """ref: OnnxFrameworkImporter (samediff-import-onnx)."""

    @staticmethod
    def importOnnxModel(src, device=None) -> SameDiff:
        """An ``.onnx`` path, its bytes or a parsed ModelProto -> SameDiff
        on ``device`` (the card unless the caller names another)."""
        model = src if isinstance(src, ModelProto) else op_.load_model(src)
        g = model.graph
        if g is None:
            raise OnnxImportError("model has no graph")
        report = _imp.lint_onnx_model(model, supported_ops=set(_BUILDERS)
                                      | {"Constant"})
        sd = SameDiff.create(device)
        consts: Dict[str, object] = {}
        for t in g.initializers:
            consts[t.name] = t.array
            sd.constant(t.array, name=t.name)
        init_names = set(consts)
        for vi in g.inputs:
            if vi.name in init_names:
                continue
            shape = tuple(vi.shape) if vi.shape else None
            sd.placeHolder(vi.name, shape=shape,
                           dtype=op_.torch_dtype(vi.elem_type))
        for node in g.nodes:
            _import_node(sd, consts, node, report)
        sd.import_report = report
        return sd


def _as_cpu_tensor(a) -> torch.Tensor:
    """A const (numpy, or a bf16 tensor) as the CPU tensor a fold computes
    with, at its own width: the JAX importer folds numpy consts, and its
    constants narrow only when they are recorded (so W163 sees an int64
    result past the int32 range)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    return torch.from_numpy(np.array(a, copy=not a.flags.writeable))


def _numel(a) -> int:
    return int(a.numel() if isinstance(a, torch.Tensor) else np.size(a))


def _import_node(sd: SameDiff, consts: Dict[str, object], node: NodeProto,
                 report=None):
    op = node.op_type
    if op == "Constant":
        t = node.attr("value")
        if t is None:
            raise OnnxImportError(f"Constant '{node.name}' without tensor")
        consts[node.outputs[0]] = t.array
        sd.constant(t.array, name=node.outputs[0])
        return
    if op not in _BUILDERS:
        raise OnnxImportError(
            f"unmapped ONNX op '{op}' (node '{node.name}') — add a builder "
            f"to modelimport.onnx._BUILDERS")

    params = {a.name: _attr_value(a) for a in node.attrs.values()}
    ins = [i for i in node.inputs if i]      # "" = absent optional input
    # consume const-only inputs into params
    for idx, key, conv in _CONST_INPUTS.get(op, []):
        if idx < len(node.inputs) and node.inputs[idx]:
            name = node.inputs[idx]
            if name not in consts:
                raise OnnxImportError(
                    f"{op} input '{name}' must be a constant/initializer "
                    f"(static shapes)")
            params[key] = conv(np.asarray(consts[name]))
            ins = [i for i in ins if i != name]
    n_out = len([o for o in node.outputs if o])
    if op == "Dropout":
        n_out = 1                            # optional mask output unused
    if op == "Split":
        params["n_out"] = n_out

    fn = _BUILDERS[op](params)

    # const folding (shape arithmetic over initializers), on the CPU
    if ins and all(i in consts for i in ins) and \
            sum(_numel(consts[i]) for i in ins) <= _FOLD_LIMIT:
        try:
            with torch.no_grad():
                res = fn(*[_as_cpu_tensor(consts[i]) for i in ins])
            outs = [_tfi._to_host(r)
                    for r in (res if n_out > 1 else (res,))]
            if sum(_numel(r) for r in outs) <= _FOLD_LIMIT:
                if report is not None:
                    report.extend(_imp.fold_overflow_diags(
                        op, node.outputs[0], outs))
                for name, arr in zip(node.outputs, outs):
                    consts[name] = arr
                    sd.constant(arr, name=name)
                return
        except Exception:
            pass                              # fall through to runtime node

    sd._record_fn(f"onnx.{op}", lambda *a, _f=fn, **kw: _f(*a), ins,
                  name=node.outputs[0], n_out=n_out, rebuild="onnx",
                  attrs={"onnx_op": op, "params": params})
    if n_out > 1:
        # _record_fn names outputs '<base>:i'; align with the graph's names
        for i, oname in enumerate(node.outputs[:n_out]):
            cur = f"{node.outputs[0]}:{i}"
            if cur != oname:
                sd._rename(cur, oname)


def _attr_value(a):
    v = a.value
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if hasattr(v, "array"):                  # TensorProto attr
        arr = v.array
        arr = arr.float().numpy() if isinstance(arr, torch.Tensor) \
            else np.asarray(arr)
        return arr.tolist() if arr.size < 64 else arr
    return v


importOnnxModel = OnnxGraphImport.importOnnxModel
