"""Analysis IR — typed tensor/op facts for lint parity across model kinds
(the port of ``deeplearning4j_tpu/analysis/graphir.py``).

Native configs get ~40 codes across five analyzer families because every
pass reads declared facts (``param_shapes``, ``output_type``, dtype
hooks).  Recorded SameDiff graphs — including everything the Keras/ONNX/
TF importers produce — only carried the structural E15x pass, because no
equivalent fact surface existed.  This module is that surface: a static
IR of

- :class:`TensorFact` — shape, dtype, kind (param / const / placeholder /
  activation), producer and consumer edges, weight-position flag;
- :class:`OpFact` — op name, operands, attrs, and a per-op FLOP estimate;

with two lowerings.  :func:`from_samediff` walks a recorded ``_Node``
graph, extending the E15x shape rules with rules for the importers'
namespaced ops (``onnx.Conv``, ``tf.MatMul``, ...) and per-op **dtype**
rules; unknown ops degrade gracefully to unknown facts, never to a
crash.  :func:`from_multilayer` lowers a native sequential config to the
same facts (the parity adapter: tests pin that both lowerings agree with
the distribution pass's own accounting).

The lint drivers at the bottom run the existing families over the IR —
layout (W101/W102/W103), distribution (E101/E102/E104/W104–W107 via
``distribution.lint_entries`` over per-op fact bundles), numerics
(E301–E303/W301–W303 via dtype-flow over IR edges) — so ``sd.validate
(mesh=..., policy=..., data_range=...)`` emits the same codes a native
config would.

Array facts are duck-typed off ``.shape``/``.dtype`` (torch and numpy
dtypes both map to their names); nothing here makes a tensor.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.analysis import distribution as _dist
from deeplearning4j_tpu_torch.analysis import layout as _layout
from deeplearning4j_tpu_torch.analysis.diagnostics import Diagnostic, Severity
from deeplearning4j_tpu_torch.analysis.numerics import (
    REDUCTION_AXIS_THRESHOLD, SOFTMAX_AXIS_THRESHOLD, UNNORMALIZED_THRESHOLD,
    _SATURATING, _SQUARING_UPDATERS, DataRangeSpec, _lint_loss_scaling)
from deeplearning4j_tpu_torch.analysis.samediff import (Shape, _infer,
                                                        _normalize_ph_shape)
from deeplearning4j_tpu_torch.nn.precision import (DTYPE_MAX, LOW_PRECISION,
                                                   PrecisionPolicy)

#: tensor kinds — ``param`` is trainable (SameDiff ``_variables`` / native
#: layer params), ``const`` covers initializers/frozen weights.
KINDS = ("param", "const", "placeholder", "activation")

#: operand positions that hold weights, per op: the classifier that makes
#: an IMPORTED graph's frozen initializers count as parameters for the
#: layout/distribution accounting (and feed the W162 frozen-variable
#: lint).  Index is into the recorded node's input list.
WEIGHT_POSITIONS: Dict[str, Tuple[int, ...]] = {
    "matmul": (1,), "xw_plus_b": (1, 2), "relu_layer": (1, 2),
    "onnx.MatMul": (1,), "onnx.Gemm": (1, 2), "onnx.Conv": (1, 2),
    "onnx.BatchNormalization": (1, 2, 3, 4),
    "tf.MatMul": (1,), "tf.Conv2D": (1,), "tf.DepthwiseConv2dNative": (1,),
    "tf.BiasAdd": (1,), "tf.FusedBatchNormV3": (1, 2, 3, 4),
}

#: conv-family ops: their weight lane dims get the conv-aware W101 text.
CONV_OPS = frozenset({"onnx.Conv", "tf.Conv2D", "tf.DepthwiseConv2dNative"})

_NORMALIZING_OPS = frozenset({
    "layer_norm", "batchnorm_sd", "onnx.BatchNormalization",
    "tf.FusedBatchNormV3", "tf.FusedBatchNorm",
})

_SOFTMAX_OPS = frozenset({"softmax", "log_softmax", "onnx.Softmax",
                          "onnx.LogSoftmax", "tf.Softmax"})

_REDUCTION_OPS = frozenset({
    "reduce_sum", "reduce_mean", "onnx.ReduceSum", "onnx.ReduceMean",
    "tf.Sum", "tf.Mean",
})

_LOSS_OPS = frozenset({
    "mean_sqerr_loss", "softmax_cross_entropy_loss",
    "sigmoid_cross_entropy_loss", "absolute_difference_loss",
    "cosine_distance_loss", "hinge_loss", "huber_loss", "log_loss",
    "sparse_softmax_cross_entropy_loss",
})

_CAST_OPS = frozenset({"cast", "onnx.Cast", "tf.Cast"})

#: activations recorded under their op name whose output magnitude
#: saturates to ~1 (mirrors numerics._SATURATING for the conf pass)
_SATURATING_OPS = frozenset(
    {n for n in _SATURATING} |
    {"onnx.Sigmoid", "onnx.Tanh", "onnx.Softmax", "onnx.HardSigmoid",
     "tf.Sigmoid", "tf.Tanh", "tf.Softmax"})

#: ONNX TensorProto data-type codes -> dtype names (local copy so this
#: module never imports modelimport; pinned against onnx_proto by test)
ONNX_DTYPE_NAMES = {
    1: "float32", 2: "uint8", 3: "int8", 4: "uint16", 5: "int16",
    6: "int32", 7: "int64", 9: "bool", 10: "float16", 11: "float64",
    12: "uint32", 13: "uint64", 16: "bfloat16",
}


class TensorFact:
    """Static facts about one graph tensor."""

    __slots__ = ("name", "shape", "dtype", "kind", "producer", "consumers",
                 "weight_of")

    def __init__(self, name: str, shape: Shape, dtype: Optional[str],
                 kind: str, producer: Optional[int] = None):
        self.name = name
        self.shape = shape
        self.dtype = dtype
        self.kind = kind
        self.producer = producer      # op index, None for graph inputs
        self.consumers: List[int] = []
        #: op index this tensor is a weight operand of (param-vs-activation
        #: classification for consts: frozen imported weights land here)
        self.weight_of: Optional[int] = None

    @property
    def is_weight(self) -> bool:
        return self.kind == "param" or self.weight_of is not None

    def size_known(self) -> bool:
        return self.shape is not None and None not in self.shape

    def __repr__(self):
        return (f"TensorFact({self.name!r}, shape={self.shape}, "
                f"dtype={self.dtype}, kind={self.kind})")


class OpFact:
    """Static facts about one graph op."""

    __slots__ = ("index", "op", "name", "inputs", "outputs", "attrs",
                 "flops")

    def __init__(self, index: int, op: str, name: str,
                 inputs: Tuple[str, ...], outputs: Tuple[str, ...],
                 attrs: Dict[str, Any], flops: int = 0):
        self.index = index
        self.op = op
        self.name = name
        self.inputs = tuple(inputs)
        self.outputs = tuple(outputs)
        self.attrs = dict(attrs or {})
        self.flops = int(flops)

    @property
    def location(self) -> str:
        return f"op '{self.name}' ({self.op})"

    def __repr__(self):
        return f"OpFact({self.index}, {self.op!r}, {self.name!r})"


class GraphIR:
    """The lowered graph: tensor facts + op facts + training context."""

    __slots__ = ("tensors", "ops", "subject", "batch_size", "updater",
                 "loss_variables")

    def __init__(self, subject: str, batch_size: int = 1):
        self.tensors: Dict[str, TensorFact] = {}
        self.ops: List[OpFact] = []
        self.subject = subject
        self.batch_size = int(batch_size or 1)
        self.updater = None           # the TrainingConfig's updater, if any
        self.loss_variables: List[str] = []

    def weights(self) -> List[TensorFact]:
        """Params + weight-position consts, in definition order."""
        return [t for t in self.tensors.values() if t.is_weight]

    def placeholders(self) -> List[TensorFact]:
        return [t for t in self.tensors.values()
                if t.kind == "placeholder"]

    def total_flops(self) -> int:
        return sum(op.flops for op in self.ops)


# ------------------------------------------------------- shape/dtype rules

def _attr_params(attrs: Dict) -> Dict:
    return dict(attrs.get("params") or {})


def _conv_spatial(dim, k, stride, pad_lo, pad_hi, dilation):
    if dim is None:
        return None
    eff = (k - 1) * dilation + 1
    return max((dim + pad_lo + pad_hi - eff) // stride + 1, 0)


def _rule_onnx_conv(ins: List[Shape], attrs: Dict):
    x, w = (list(ins) + [None, None])[:2]
    if w is None or x is None or len(x) < 3:
        return [None]
    p = _attr_params(attrs)
    n_spatial = len(x) - 2
    out = [x[0], w[0]]
    if str(p.get("auto_pad", "NOTSET")).startswith("SAME"):
        strides = list(p.get("strides") or [1] * n_spatial)
        for i in range(n_spatial):
            d = x[2 + i]
            out.append(None if d is None
                       else -(-d // strides[i]))      # ceil-div
        return [tuple(out)]
    kernel = list(p.get("kernel_shape") or
                  (list(w[2:]) if len(w) > 2 else []))
    if len(kernel) != n_spatial:
        return [tuple(out) + (None,) * n_spatial]
    strides = list(p.get("strides") or [1] * n_spatial)
    dil = list(p.get("dilations") or [1] * n_spatial)
    pads = list(p.get("pads") or [0] * (2 * n_spatial))
    for i in range(n_spatial):
        out.append(_conv_spatial(x[2 + i], kernel[i], strides[i],
                                 pads[i], pads[n_spatial + i], dil[i]))
    return [tuple(out)]


def _rule_onnx_pool(ins: List[Shape], attrs: Dict):
    x = ins[0] if ins else None
    if x is None or len(x) < 3:
        return [None]
    p = _attr_params(attrs)
    kernel = list(p.get("kernel_shape") or [])
    n_spatial = len(x) - 2
    out = [x[0], x[1]]
    if len(kernel) != n_spatial:
        return [tuple(out) + (None,) * n_spatial]
    strides = list(p.get("strides") or [1] * n_spatial)
    pads = list(p.get("pads") or [0] * (2 * n_spatial))
    for i in range(n_spatial):
        out.append(_conv_spatial(x[2 + i], kernel[i], strides[i],
                                 pads[i], pads[n_spatial + i], 1))
    return [tuple(out)]


def _rule_onnx_global_pool(ins: List[Shape], attrs: Dict):
    x = ins[0] if ins else None
    if x is None or len(x) < 3:
        return [None]
    return [tuple(x[:2]) + (1,) * (len(x) - 2)]


def _rule_onnx_gemm(ins: List[Shape], attrs: Dict):
    a, b = (list(ins) + [None, None])[:2]
    if a is None or b is None or len(a) != 2 or len(b) != 2:
        return [None]
    p = _attr_params(attrs)
    m = a[1] if p.get("transA") else a[0]
    n = b[0] if p.get("transB") else b[1]
    return [(m, n)]


def _rule_onnx_flatten(ins: List[Shape], attrs: Dict):
    x = ins[0] if ins else None
    if x is None:
        return [None]
    axis = int(_attr_params(attrs).get("axis", 1)) % (len(x) + 1)

    def prod(dims):
        r = 1
        for d in dims:
            if d is None:
                return None
            r *= d
        return r
    return [(prod(x[:axis]), prod(x[axis:]))]


def _rule_onnx_reshape(ins: List[Shape], attrs: Dict):
    shape = _attr_params(attrs).get("shape")
    if shape is None:
        return [None]
    return [tuple(None if int(d) in (-1, 0) else int(d) for d in shape)]


def _rule_onnx_transpose(ins: List[Shape], attrs: Dict):
    x = ins[0] if ins else None
    if x is None:
        return [None]
    perm = _attr_params(attrs).get("perm")
    if not perm:
        return [tuple(reversed(x))]
    if len(perm) != len(x):
        return [None]
    return [tuple(x[p] for p in perm)]


def _rule_onnx_concat(ins: List[Shape], attrs: Dict):
    known = [s for s in ins if s is not None]
    if not known or any(s is None for s in ins):
        return [None]
    axis = int(_attr_params(attrs).get("axis", 0)) % len(known[0])
    out = list(known[0])
    total = 0
    for s in known:
        if s[axis] is None:
            total = None
            break
        total += s[axis]
    out[axis] = total
    return [tuple(out)]


def _rule_onnx_reduce(ins: List[Shape], attrs: Dict):
    x = ins[0] if ins else None
    if x is None:
        return [None]
    p = _attr_params(attrs)
    axes = p.get("axes")
    keep = bool(p.get("keepdims", 1))
    if axes is None:
        return [((1,) * len(x)) if keep else ()]
    axes = [int(a) % len(x) for a in axes]
    if keep:
        return [tuple(1 if i in axes else d for i, d in enumerate(x))]
    return [tuple(d for i, d in enumerate(x) if i not in axes)]


def _rule_binary(ins: List[Shape], attrs: Dict):
    out, _err = _infer("add", list(ins[:2]), {})
    return out


def _rule_passthrough(ins: List[Shape], attrs: Dict):
    return [ins[0] if ins else None]


def _rule_tf_matmul(ins: List[Shape], attrs: Dict):
    p = _attr_params(attrs)
    out, _err = _infer("matmul", list(ins[:2]),
                       {"transpose_a": p.get("transpose_a"),
                        "transpose_b": p.get("transpose_b")})
    return out


def _rule_tf_conv2d(ins: List[Shape], attrs: Dict):
    # TF convs import NHWC-only; W is (kh, kw, C, M)
    x, w = (list(ins) + [None, None])[:2]
    if x is None or w is None or len(x) != 4 or len(w) != 4:
        return [None]
    p = _attr_params(attrs)
    strides = p.get("strides") or (1, 1)
    if isinstance(strides, (list, tuple)) and len(strides) == 4:
        strides = strides[1:3]
    same = str(p.get("padding", "SAME")).upper().startswith("SAME")
    out_sp = []
    for i in range(2):
        d = x[1 + i]
        if d is None:
            out_sp.append(None)
        elif same:
            out_sp.append(-(-d // strides[i]))
        else:
            out_sp.append(_conv_spatial(d, w[i], strides[i], 0, 0, 1))
    return [(x[0], out_sp[0], out_sp[1], w[3])]


_IMPORT_SHAPE_RULES = {
    "onnx.Conv": _rule_onnx_conv,
    "onnx.MaxPool": _rule_onnx_pool, "onnx.AveragePool": _rule_onnx_pool,
    "onnx.GlobalAveragePool": _rule_onnx_global_pool,
    "onnx.GlobalMaxPool": _rule_onnx_global_pool,
    "onnx.Gemm": _rule_onnx_gemm,
    "onnx.Flatten": _rule_onnx_flatten,
    "onnx.Reshape": _rule_onnx_reshape,
    "onnx.Transpose": _rule_onnx_transpose,
    "onnx.Concat": _rule_onnx_concat,
    "onnx.ReduceSum": _rule_onnx_reduce, "onnx.ReduceMean": _rule_onnx_reduce,
    "onnx.ReduceMax": _rule_onnx_reduce, "onnx.ReduceMin": _rule_onnx_reduce,
    "tf.MatMul": _rule_tf_matmul,
    "tf.Conv2D": _rule_tf_conv2d,
}

_IMPORT_PASSTHROUGH = frozenset({
    "onnx.Relu", "onnx.LeakyRelu", "onnx.Elu", "onnx.Sigmoid", "onnx.Tanh",
    "onnx.Softmax", "onnx.LogSoftmax", "onnx.HardSigmoid", "onnx.Gelu",
    "onnx.Clip", "onnx.Cast", "onnx.Identity", "onnx.Dropout", "onnx.Erf",
    "onnx.Sqrt", "onnx.Exp", "onnx.Log", "onnx.Neg", "onnx.Abs",
    "onnx.BatchNormalization",
    "tf.Relu", "tf.Relu6", "tf.Sigmoid", "tf.Tanh", "tf.Softmax",
    "tf.Identity", "tf.BiasAdd", "tf.Cast", "tf.FusedBatchNormV3",
    "tf.LeakyRelu", "tf.Elu", "tf.Sqrt", "tf.Exp", "tf.Log", "tf.Neg",
    "tf.Abs", "tf.Rsqrt",
})

_IMPORT_BINARY = frozenset({
    "onnx.Add", "onnx.Sub", "onnx.Mul", "onnx.Div", "onnx.Pow",
    "onnx.Min", "onnx.Max", "onnx.Greater", "onnx.Less", "onnx.Equal",
    "tf.Add", "tf.AddV2", "tf.Sub", "tf.Mul", "tf.RealDiv", "tf.Maximum",
    "tf.Minimum", "tf.Pow", "tf.Greater", "tf.Less", "tf.Equal",
    "tf.SquaredDifference",
})


def infer_shapes(op: str, in_shapes: List[Shape], attrs: Dict,
                 n_out: int = 1) -> List[Shape]:
    """Shape rule dispatch: native rules (analysis.samediff) for native
    ops, the import tables for namespaced ops, unknown degrades to
    ``[None] * n_out`` — never raises."""
    try:
        if "." in op:
            rule = _IMPORT_SHAPE_RULES.get(op)
            if rule is not None:
                out = rule(in_shapes, attrs)
            elif op in _IMPORT_PASSTHROUGH:
                out = _rule_passthrough(in_shapes, attrs)
            elif op in _IMPORT_BINARY:
                out = _rule_binary(in_shapes, attrs)
            else:
                out = [None]
        else:
            out, _err = _infer(op, list(in_shapes), attrs)
    except Exception:
        out = [None]
    out = list(out or [None])
    if len(out) < n_out:
        out += [out[0]] * (n_out - len(out))
    return out[:n_out]


_BOOL_OPS = frozenset({"greater", "less", "greater_equal", "less_equal",
                       "equals", "not_equals", "onnx.Greater", "onnx.Less",
                       "onnx.Equal", "tf.Greater", "tf.Less", "tf.Equal"})
_INDEX_OPS = frozenset({"argmax", "argmin", "onnx.ArgMax", "onnx.ArgMin",
                        "tf.ArgMax", "tf.ArgMin"})

_FLOAT_ORDER = ("float64", "float32", "bfloat16", "float16")


def infer_dtype(op: str, in_dtypes: List[Optional[str]],
                attrs: Dict) -> Optional[str]:
    """Per-op dtype rule: casts read their target,
    comparisons produce bool, arg-reductions produce int32, everything
    else promotes across its known operand dtypes; unknown stays
    unknown."""
    if op in _CAST_OPS:
        if op == "cast":
            return _dtype_name(attrs.get("dtype"))
        p = _attr_params(attrs)
        if op == "onnx.Cast":
            return ONNX_DTYPE_NAMES.get(int(p.get("to", -1)))
        target = p.get("dtype") or p.get("DstT")
        return str(target) if target is not None else None
    if op in _BOOL_OPS:
        return "bool"
    if op in _INDEX_OPS:
        return "int32"
    known = [d for d in in_dtypes if d]
    if not known:
        return None
    floats = [d for d in known if d in _FLOAT_ORDER]
    if floats:
        for name in _FLOAT_ORDER:     # widest float present wins
            if name in floats:
                return name
    return known[0]


def _op_flops(op: str, in_shapes: List[Shape], out_shape: Shape,
              attrs: Dict) -> int:
    """Per-op FLOP estimate: 2 FLOPs per MAC for the matmul/conv family,
    0 for everything else (the same dominant-term model the native
    distribution pass uses)."""
    def prod(dims):
        r = 1
        for d in dims or ():
            if d is None or d <= 0:
                return 0
            r *= d
        return r

    try:
        if op in ("matmul", "onnx.MatMul", "onnx.Gemm", "tf.MatMul",
                  "xw_plus_b", "relu_layer"):
            a, b = (list(in_shapes) + [None, None])[:2]
            if a is None or b is None or len(a) < 2 or len(b) < 2:
                return 0
            k = a[-1] or b[-2] or b[-1] or 0
            return 2 * prod(out_shape) * int(k)
        if op in CONV_OPS:
            w = in_shapes[1] if len(in_shapes) > 1 else None
            if w is None or out_shape is None:
                return 0
            # per output element: one MAC per kernel element x in-channels
            per_out = prod(w[1:]) if op == "onnx.Conv" else prod(w[:3])
            return 2 * prod(out_shape) * per_out
    except Exception:
        return 0
    return 0


# ------------------------------------------------------------- lowerings

def _arr_shape(arr) -> Shape:
    shape = getattr(arr, "shape", None)
    return tuple(int(d) for d in shape) if shape is not None else None


def _dtype_name(dt) -> Optional[str]:
    """A dtype's name: a torch dtype (``torch.float32`` -> ``"float32"``),
    a numpy dtype or type, or a name string; None stays None."""
    if dt is None:
        return None
    text = str(dt)
    if text.startswith("torch."):
        return text[len("torch."):]
    try:
        return np.dtype(dt).name
    except TypeError:
        return text


def _arr_dtype(arr) -> Optional[str]:
    return _dtype_name(getattr(arr, "dtype", None))


def from_samediff(sd, batch_size: int = 1) -> GraphIR:
    """Lower a recorded SameDiff graph (native or imported) to the IR.

    Creation order is execution order (the ``_record_fn`` contract), so
    one forward walk resolves every fact.  Unknown ops produce unknown
    shapes/dtypes; nothing here raises on a malformed graph — the E15x
    structural pass owns error reporting."""
    ir = GraphIR(subject="SameDiff", batch_size=batch_size)
    tc = getattr(sd, "training_config", None)
    ir.updater = getattr(tc, "updater", None) if tc is not None else None
    ir.loss_variables = list(getattr(sd, "_loss_variables", ()) or ())

    for name, arr in dict(getattr(sd, "_variables", {}) or {}).items():
        ir.tensors[name] = TensorFact(name, _arr_shape(arr),
                                      _arr_dtype(arr), "param")
    for name, arr in dict(getattr(sd, "_constants", {}) or {}).items():
        ir.tensors[name] = TensorFact(name, _arr_shape(arr),
                                      _arr_dtype(arr), "const")
    for name, (shape, dtype) in dict(
            getattr(sd, "_placeholders", {}) or {}).items():
        dt = _dtype_name(dtype)
        ir.tensors[name] = TensorFact(
            name, _normalize_ph_shape(shape, batch_size), dt, "placeholder")

    for idx, node in enumerate(getattr(sd, "_nodes", ()) or ()):
        attrs = dict(getattr(node, "attrs", {}) or {})
        in_shapes: List[Shape] = []
        in_dtypes: List[Optional[str]] = []
        for pos, ref in enumerate(node.inputs):
            t = ir.tensors.get(ref)
            if t is None:       # E151 territory — degrade, don't crash
                in_shapes.append(None)
                in_dtypes.append(None)
                continue
            t.consumers.append(idx)
            if t.kind in ("param", "const") and \
                    pos in WEIGHT_POSITIONS.get(node.op, ()) and \
                    t.weight_of is None:
                t.weight_of = idx
            in_shapes.append(t.shape)
            in_dtypes.append(t.dtype)
        out_shapes = infer_shapes(node.op, in_shapes, attrs,
                                  n_out=len(node.outputs))
        out_dtype = infer_dtype(node.op, in_dtypes, attrs)
        for i, out in enumerate(node.outputs):
            ir.tensors[out] = TensorFact(
                out, out_shapes[i] if i < len(out_shapes) else None,
                out_dtype, "activation", producer=idx)
        name = node.outputs[0] if node.outputs else f"#{idx}"
        ir.ops.append(OpFact(
            idx, node.op, name, tuple(node.inputs), tuple(node.outputs),
            attrs, flops=_op_flops(node.op, in_shapes,
                                   out_shapes[0] if out_shapes else None,
                                   attrs)))
    return ir


def _type_shape(it, batch_size: int) -> Shape:
    """``(batch,) + positive declared dims`` from an InputType, None when
    the type (or any dim) is unknown — the activation-byte fact the cost
    model's liveness pass reads."""
    if it is None:
        return None
    dims = [int(v) for v in getattr(it, "dims", {}).values()
            if isinstance(v, (int, float)) and v > 0]
    if not dims:
        return None
    return (int(batch_size),) + tuple(dims)


def from_multilayer(conf, batch_size: int = 1) -> GraphIR:
    """Lower a native sequential config to the same facts — the parity
    adapter: param names/shapes match ``distribution._param_facts`` and
    per-layer FLOPs match ``distribution._approx_flops``, pinned by
    test."""
    ir = GraphIR(subject="MultiLayerConfiguration", batch_size=batch_size)
    base = getattr(conf, "base", None)
    ir.updater = getattr(base, "updater", None)
    dtype = getattr(base, "dtype", None)
    dt = str(dtype) if dtype is not None else "float32"
    types = _dist._propagate_types(conf)
    prev_out = "input"
    it0 = getattr(conf, "input_type", None)
    ir.tensors["input"] = TensorFact(
        "input", _type_shape(it0, batch_size), dt, "placeholder")
    seen_names: Dict[str, int] = {}
    for idx, layer in enumerate(getattr(conf, "layers", ()) or ()):
        lname = getattr(layer, "name", None) or type(layer).__name__
        # repeated default-named layers must not collide in the tensor
        # dict (the liveness/byte accounting would silently drop them) —
        # disambiguate with the layer index, matching nothing less
        # specific than the class-name prefix sharding regexes target
        if lname in seen_names:
            lname = f"{lname}_{idx}"
        seen_names[lname] = idx
        shapes = getattr(layer, "param_shapes", lambda: {})()
        pnames = []
        for pname, shape in (shapes or {}).items():
            if not shape or any(not d or d < 0 for d in shape):
                continue
            full = f"{lname}/{pname}"
            t = TensorFact(full, tuple(int(d) for d in shape), dt, "param")
            t.weight_of = idx
            t.consumers.append(idx)
            ir.tensors[full] = t
            pnames.append(full)
        out_name = f"{lname}:act"
        it, out_it = types[idx]
        ir.tensors[out_name] = TensorFact(out_name,
                                          _type_shape(out_it, batch_size),
                                          dt, "activation", producer=idx)
        ir.tensors[prev_out].consumers.append(idx)
        ir.ops.append(OpFact(
            idx, type(layer).__name__, lname,
            tuple([prev_out] + pnames), (out_name,), {},
            flops=_dist._approx_flops(layer, it, out_it)))
        prev_out = out_name
    return ir


def from_graph(conf, batch_size: int = 1) -> GraphIR:
    """Lower a ComputationGraphConfiguration to the IR — layer nodes AND
    vertices become ops in topological order, so the cost model's
    liveness pass sees the same producer/consumer edges the sequential
    lowering gives (vertices carry no params and zero FLOPs; their
    output shapes stay unknown and the liveness pass degrades to the
    layer-activation facts)."""
    ir = GraphIR(subject="ComputationGraphConfiguration",
                 batch_size=batch_size)
    base = getattr(conf, "base", None)
    ir.updater = getattr(base, "updater", None)
    dtype = getattr(base, "dtype", None)
    dt = str(dtype) if dtype is not None else "float32"
    input_types = dict(getattr(conf, "input_types", {}) or {})
    for gi in getattr(conf, "graph_inputs", ()) or ():
        ir.tensors[gi] = TensorFact(
            gi, _type_shape(input_types.get(gi), batch_size), dt,
            "placeholder")
    types = _dist._propagate_graph_types(conf)
    nodes = _dist._graph_order_all(conf, list(getattr(conf, "nodes", ())))
    act_of = {}                      # node name -> its activation tensor
    for idx, n in enumerate(nodes):
        in_refs = []
        for r in n.inputs:
            ref = r if r in ir.tensors and r not in act_of else \
                act_of.get(r, f"{r}:act")
            in_refs.append(ref)
            t = ir.tensors.get(ref)
            if t is not None:
                t.consumers.append(idx)
        pnames = []
        flops = 0
        if getattr(n, "kind", None) == "layer":
            lname = getattr(n, "name", None) or type(n.obj).__name__
            for pname, shape in (getattr(n.obj, "param_shapes",
                                         lambda: {})() or {}).items():
                if not shape or any(not d or d < 0 for d in shape):
                    continue
                full = f"{lname}/{pname}"
                t = TensorFact(full, tuple(int(d) for d in shape), dt,
                               "param")
                t.weight_of = idx
                t.consumers.append(idx)
                ir.tensors[full] = t
                pnames.append(full)
            it, out_it = types.get(n.name, (None, None))
            flops = _dist._approx_flops(n.obj, it, out_it)
        else:
            out_it = None
        out_name = f"{n.name}:act"
        ir.tensors[out_name] = TensorFact(out_name,
                                          _type_shape(out_it, batch_size),
                                          dt, "activation", producer=idx)
        act_of[n.name] = out_name
        ir.ops.append(OpFact(
            idx, type(n.obj).__name__, n.name,
            tuple(in_refs + pnames), (out_name,), {}, flops=flops))
    return ir


# ---------------------------------------------------------- lint drivers

def lint_ir_layout(ir: GraphIR, batch_size: Optional[int] = None,
                   data_devices: Optional[int] = None) -> List[Diagnostic]:
    """W101/W102/W103 over IR facts: weight N dims against the Hopper
    tile grid (and, for 16-bit weights, TMA's row alignment), non-native
    tensor dtypes (once per distinct dtype), batch vs. data-mesh
    divisibility."""
    diags: List[Diagnostic] = []
    for t in ir.weights():
        if t.shape is None or not t.shape:
            continue
        conv = False
        loc = f"tensor '{t.name}'"
        if t.weight_of is not None and t.weight_of < len(ir.ops):
            op = ir.ops[t.weight_of]
            conv = op.op in CONV_OPS
            loc = f"tensor '{t.name}' ({op.location})"
        dims = [d for d in (t.shape[-1],) if d is not None] if not conv \
            else [d for d in t.shape[:2] if d is not None]
        for d in dims:
            diag = _layout.lint_lane_dim(int(d), loc, conv=conv,
                                         compute_dtype=t.dtype or "float32")
            if diag is not None:
                diags.append(diag)
    seen_dtypes = set()
    for t in ir.tensors.values():
        if t.dtype is None or t.dtype in seen_dtypes:
            continue
        found = _layout.lint_dtype(t.dtype, f"tensor '{t.name}'")
        if found:
            seen_dtypes.add(t.dtype)
            diags.extend(found)
    diags.extend(_layout.lint_batch_mesh(batch_size, data_devices,
                                         location="graph"))
    return diags


class _IRLayerFacts:
    """Declared-fact adapter: one op's weight tensors presented through
    the ``param_shapes()`` / ``name`` / ``tied_with`` / ``approx_flops``
    hooks the distribution pass reads — IR facts ride the existing
    ``lint_entries`` / ``_lint_pipeline`` machinery unchanged."""

    #: the IR tensor names are already the graph's own names — no layer
    #: prefix (sharding regexes must see the recorded names)
    qualified_params = True

    def __init__(self, name: str, params: Dict[str, Tuple[int, ...]],
                 flops: int):
        self._params = params
        self.name = name
        self.tied_with = None
        self._flops = int(flops)

    def param_shapes(self):
        return dict(self._params)

    def approx_flops(self):
        return self._flops


def _ir_entries(ir: GraphIR):
    """(location, facts, None, None) entries: one per op owning weight
    tensors (plus a trailing bundle for unconsumed params), FLOPs from
    the IR op facts."""
    by_op: Dict[int, Dict[str, Tuple[int, ...]]] = {}
    orphans: Dict[str, Tuple[int, ...]] = {}
    for t in ir.weights():
        if t.shape is None or None in t.shape or not t.shape:
            continue
        if t.weight_of is not None:
            by_op.setdefault(t.weight_of, {})[t.name] = t.shape
        else:
            orphans[t.name] = t.shape
    entries = []
    for op in ir.ops:
        params = by_op.get(op.index)
        if params is None and op.flops <= 0:
            continue
        facts = _IRLayerFacts(op.location, params or {}, op.flops)
        entries.append((op.location, facts, None, None))
    if orphans:
        entries.append(("unconsumed parameters",
                        _IRLayerFacts("unconsumed parameters", orphans, 0),
                        None, None))
    return entries


def _dominant_param_dtype(ir: GraphIR) -> Optional[str]:
    counts: Dict[str, int] = {}
    for t in ir.weights():
        if t.dtype:
            counts[t.dtype] = counts.get(t.dtype, 0) + 1
    if not counts:
        return None
    return max(counts.items(), key=lambda kv: kv[1])[0]


def lint_ir_distribution(ir: GraphIR, mesh, batch_size: Optional[int],
                         profile=None) -> List[Diagnostic]:
    """E101/E102/E104/W104–W107 (+E103/W105 under a declared pipeline)
    over IR param facts — the codes native configs get from
    ``distribution.lint_multilayer``, driven by the same machinery."""
    entries = _ir_entries(ir)
    diags = _dist.lint_entries(entries, mesh, batch_size,
                               _dominant_param_dtype(ir),
                               updater=ir.updater)
    diags.extend(_dist._lint_pipeline(entries, mesh, profile=profile))
    return diags


def _resolve_ir_policy(ir: GraphIR, policy) -> PrecisionPolicy:
    pol = PrecisionPolicy.coerce(policy)
    if pol is not None:
        return pol
    implied = PrecisionPolicy.from_config_dtype(_dominant_param_dtype(ir))
    return implied if implied is not None else PrecisionPolicy()


def _axis_len(shape: Shape, axis) -> Optional[int]:
    if shape is None:
        return None
    try:
        return shape[int(axis) % len(shape)]
    except Exception:
        return None


def _updater_name(updater) -> str:
    return type(updater).__name__ if updater is not None else ""


def lint_ir_numerics(ir: GraphIR, policy=None,
                     data_range=None) -> List[Diagnostic]:
    """E301–E303/W301–W303 via dtype-flow over IR edges — the numerics
    codes native configs get, decided from tensor dtypes, op kinds, and
    the declared policy/range."""
    pol = _resolve_ir_policy(ir, policy)
    rng = DataRangeSpec.coerce(data_range)
    diags: List[Diagnostic] = []
    upd = _updater_name(ir.updater)
    compute = pol.compute

    # E301: trainable params stored low-precision + a squaring updater —
    # the moments live in a dtype that cannot hold their dynamic range
    if upd in _SQUARING_UPDATERS:
        low_params = [t for t in ir.weights()
                      if t.kind == "param" and t.dtype in LOW_PRECISION]
        if pol.params in LOW_PRECISION or low_params:
            where = low_params[0].name if low_params else "policy"
            dt = low_params[0].dtype if low_params else pol.params
            diags.append(Diagnostic(
                "DL4J-E301", Severity.ERROR, f"'{where}'",
                f"trainable parameters live in {dt} while {upd} keeps "
                f"squared-gradient state — the moments round to zero or "
                f"overflow in a low-precision dtype",
                fix_hint="keep fp32 master params (params='float32' in "
                         "the PrecisionPolicy) and cast per-op instead"))

    # E302: softmax / large reductions / loss heads accumulating low
    if compute in LOW_PRECISION:
        for op in ir.ops:
            in_t = ir.tensors.get(op.inputs[0]) if op.inputs else None
            in_shape = in_t.shape if in_t is not None else None
            if op.op in _SOFTMAX_OPS:
                axis = _attr_params(op.attrs).get(
                    "axis", op.attrs.get("axis", -1))
                n = _axis_len(in_shape, axis if axis is not None else -1)
                if n is not None and n >= SOFTMAX_AXIS_THRESHOLD:
                    diags.append(Diagnostic(
                        "DL4J-E302", Severity.ERROR, op.location,
                        f"softmax over {n} elements accumulates in "
                        f"{compute} — the exponential sum loses the "
                        f"distribution's tail below {compute}'s mantissa",
                        fix_hint="compute the softmax in float32 (cast in "
                                 "/ cast out) or keep the policy's fp32 "
                                 "loss island"))
            elif op.op in _REDUCTION_OPS:
                p = _attr_params(op.attrs)
                axes = p.get("axes", p.get("axis",
                                           op.attrs.get("axis")))
                if axes is None and in_shape is not None \
                        and None not in in_shape:
                    n = 1
                    for d in in_shape:
                        n *= d
                else:
                    first = axes[0] if isinstance(axes, (list, tuple)) \
                        and axes else axes
                    n = _axis_len(in_shape, first) \
                        if first is not None else None
                if n is not None and n >= REDUCTION_AXIS_THRESHOLD:
                    diags.append(Diagnostic(
                        "DL4J-E302", Severity.ERROR, op.location,
                        f"reduction over {n} elements accumulates in "
                        f"{compute} — mean/variance over that many "
                        f"low-mantissa terms drifts",
                        fix_hint="accumulate in float32 (cast before the "
                                 "reduction)"))
            elif op.op in _LOSS_OPS and in_t is not None \
                    and in_t.dtype in LOW_PRECISION:
                diags.append(Diagnostic(
                    "DL4J-E302", Severity.ERROR, op.location,
                    f"loss accumulates in {in_t.dtype} — the loss head "
                    f"is the one reduction that must stay fp32",
                    fix_hint="cast predictions to float32 before the "
                             "loss op"))

    # E303: fp16 without loss scaling; declared-range overflow
    if compute == "float16" and pol.numeric_loss_scale() is None:
        diags.append(Diagnostic(
            "DL4J-E303", Severity.ERROR, "policy",
            "float16 compute with no loss scaling — small gradients "
            "underflow to zero below 2**-24 and training silently "
            "stalls",
            fix_hint="set loss_scale (2**15 static, or 'dynamic') on "
                     "the PrecisionPolicy, or use bfloat16"))
    if rng is not None:
        mag = rng.max_abs
        for op in ir.ops:
            if op.op in _SATURATING_OPS:
                mag = 1.0
            elif op.op in _NORMALIZING_OPS:
                mag = 3.0
        params_dt = pol.params
        if upd in _SQUARING_UPDATERS and \
                mag * mag > DTYPE_MAX.get(params_dt, float("inf")):
            diags.append(Diagnostic(
                "DL4J-E303", Severity.ERROR, "config",
                f"declared input range [{rng.lo:g}, {rng.hi:g}] drives "
                f"squared-gradient magnitude ~{mag * mag:.3g} past "
                f"{params_dt}'s max — {upd}'s second moment overflows "
                f"and every update zeroes",
                fix_hint="normalize the input (attach a scaler or "
                         "declare normalized=True) or keep fp32 "
                         "updater state"))
        scale = pol.numeric_loss_scale()
        if scale is not None and mag * scale > pol.compute_max():
            diags.append(Diagnostic(
                "DL4J-E303", Severity.ERROR, "policy",
                f"loss scale {scale:g} x activation magnitude ~{mag:g} "
                f"overflows {compute}",
                fix_hint="lower the loss scale or normalize the input"))

    # W301: explicit cast sandwich low -> fp32 -> same low dtype
    for op in ir.ops:
        if op.op not in _CAST_OPS or not op.outputs:
            continue
        src = ir.tensors.get(op.inputs[0]) if op.inputs else None
        out = ir.tensors.get(op.outputs[0])
        if src is None or out is None or src.dtype not in LOW_PRECISION \
                or out.dtype != "float32":
            continue
        for c in out.consumers:
            nxt = ir.ops[c]
            nxt_out = ir.tensors.get(nxt.outputs[0]) if nxt.outputs \
                else None
            if nxt.op in _CAST_OPS and nxt_out is not None \
                    and nxt_out.dtype == src.dtype:
                diags.append(Diagnostic(
                    "DL4J-W301", Severity.WARNING, op.location,
                    f"cast churn: {src.dtype} -> float32 -> {src.dtype} "
                    f"with no fp32 compute in between — both casts are "
                    f"pure memory traffic",
                    fix_hint="drop the round trip (stay in "
                             f"{src.dtype})"))
                break

    diags.extend(_lint_loss_scaling(pol))

    # W303: unnormalized declared range with no normalizer at the frontier
    if rng is not None and not rng.normalized \
            and rng.max_abs > UNNORMALIZED_THRESHOLD:
        normalized_first = False
        for ph in ir.placeholders():
            for c in ph.consumers:
                if ir.ops[c].op in _NORMALIZING_OPS:
                    normalized_first = True
        if not normalized_first and ir.ops:
            diags.append(Diagnostic(
                "DL4J-W303", Severity.WARNING, "graph",
                f"declared input range [{rng.lo:g}, {rng.hi:g}] is "
                f"unnormalized and no normalization op consumes the "
                f"placeholder — raw-pixel-scale inputs cost "
                f"{rng.max_abs:g}x dynamic-range headroom in every "
                f"activation (the raw-pixel Adam-overflow class)",
                fix_hint="normalize before the graph (or declare "
                         "DataRangeSpec(..., normalized=True) if a "
                         "normalizer is attached upstream)"))
    return diags
