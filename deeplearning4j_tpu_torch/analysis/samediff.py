"""SameDiff graph linter — static analysis of recorded op graphs (E15x/W15x).

``autodiff.samediff.SameDiff`` records ``_Node`` op graphs whose creation
order IS topological order; that makes the graph statically checkable the
same way layer configs are: propagate shapes node-by-node with pure
shape rules (no tensor, no trace), and report structural
problems — dangling placeholders, variables no loss depends on, loss
names that do not exist — as structured diagnostics before the first
compile.

Codes: ``E151`` undefined input name, ``E152`` shape conflict, ``E153``
bad loss variable, ``W151`` dangling placeholder, ``W152`` unused
trainable variable, ``W153`` training config with no loss marked.

Everything here is duck-typed off the recorded graph data (``_nodes`` /
``_placeholders`` / ``_variables`` / ``_constants`` / ``_loss_variables``
/ ``training_config``) and touches no tensor. Ops without a shape
rule simply propagate "unknown": structural lints still apply, shape
lints go as far as the rules reach (the same graceful degradation the
reference's -1 dims give its ``summary()``).

Entry points: ``sd.validate()`` and ``analyze(sd)``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.analysis.diagnostics import (
    Diagnostic, Severity, ValidationReport)

#: A static shape: tuple with None for unknown dims, or None when the
#: whole rank is unknown.
Shape = Optional[Tuple[Optional[int], ...]]


def analyze_samediff(sd, batch_size: int = 1) -> ValidationReport:
    report = ValidationReport(subject="SameDiff")
    nodes = list(getattr(sd, "_nodes", ()))
    placeholders = dict(getattr(sd, "_placeholders", {}) or {})
    variables = dict(getattr(sd, "_variables", {}) or {})
    constants = dict(getattr(sd, "_constants", {}) or {})
    loss_vars = list(getattr(sd, "_loss_variables", ()) or ())

    env: Dict[str, Shape] = {}
    for name, arr in list(variables.items()) + list(constants.items()):
        shape = getattr(arr, "shape", None)
        env[name] = tuple(int(d) for d in shape) if shape is not None else None
    for name, (shape, _dtype) in placeholders.items():
        env[name] = _normalize_ph_shape(shape, batch_size)

    consumed = set()
    produced = set()
    for node in nodes:
        loc = f"op '{node.outputs[0]}' ({node.op})" if node.outputs \
            else f"op ({node.op})"
        in_shapes: List[Shape] = []
        missing = False
        for ref in node.inputs:
            consumed.add(ref)
            if ref not in env:
                missing = True
                report.add(Diagnostic(
                    "DL4J-E151", Severity.ERROR, loc,
                    f"consumes '{ref}' but no variable, constant, "
                    f"placeholder, or earlier op output defines it",
                    fix_hint="define the input first (creation order is "
                             "execution order) or fix the name"))
            else:
                in_shapes.append(env[ref])
        if missing:
            for out in node.outputs:
                env[out] = None
                produced.add(out)
            continue
        out_shapes, err = _infer(node.op, in_shapes,
                                 dict(getattr(node, "attrs", {}) or {}))
        if err is not None:
            report.add(Diagnostic(
                "DL4J-E152", Severity.ERROR, loc, err,
                fix_hint="fix the operand shapes named in the message"))
        for i, out in enumerate(node.outputs):
            env[out] = out_shapes[i] if out_shapes and i < len(out_shapes) \
                else None
            produced.add(out)

    # W151: a placeholder nothing consumes still must be fed on every
    # output()/fit() call — almost always a leftover from refactoring
    if nodes:
        for name in placeholders:
            if name not in consumed:
                report.add(Diagnostic(
                    "DL4J-W151", Severity.WARNING, f"placeholder '{name}'",
                    "no recorded op consumes this placeholder (every "
                    "execution still requires feeding it)",
                    fix_hint="remove the placeholder or wire it into the "
                             "graph"))

    # E153 / W152 / W153: training-side structure
    known = set(env)
    for name in loss_vars:
        if name not in known:
            report.add(Diagnostic(
                "DL4J-E153", Severity.ERROR, f"loss '{name}'",
                f"setLossVariables names '{name}' but the graph has no "
                f"such variable",
                fix_hint="pass the op's output name (or the SDVariable) "
                         "to setLossVariables"))
    if loss_vars and variables:
        reachable = _ancestors(nodes, [n for n in loss_vars if n in known])
        for name in variables:
            if name not in reachable:
                report.add(Diagnostic(
                    "DL4J-W152", Severity.WARNING, f"variable '{name}'",
                    "no loss variable depends on this trainable variable "
                    "— its gradient is identically zero and the updater "
                    "still allocates state for it",
                    fix_hint="wire it into the loss, convertToConstants() "
                             "it, or drop it"))
    if getattr(sd, "training_config", None) is not None and not loss_vars:
        report.add(Diagnostic(
            "DL4J-W153", Severity.WARNING, "config",
            "a TrainingConfig is set but no loss variables are marked — "
            "fit() will raise 'call setLossVariables first'",
            fix_hint="call setLossVariables(<loss op output>) before fit"))
    return report


def _normalize_ph_shape(shape, batch_size) -> Shape:
    """Only the LEADING None/-1 dim is the batch substitution; any other
    unknown dim (sequence length, free spatial size) stays unknown —
    guessing there would fabricate shape conflicts."""
    if shape is None:
        return None
    out = []
    for i, d in enumerate(shape):
        if d is None or int(d) == -1:
            out.append(int(batch_size) if i == 0 and batch_size else None)
        else:
            out.append(int(d))
    return tuple(out)


def _ancestors(nodes, roots) -> set:
    producers = {}
    for node in nodes:
        for out in node.outputs:
            producers[out] = node
    seen, stack = set(), list(roots)
    while stack:
        name = stack.pop()
        if name in seen:
            continue
        seen.add(name)
        node = producers.get(name)
        if node is not None:
            stack.extend(node.inputs)
    return seen


# ------------------------------------------------------------- shape rules

def _infer(op: str, in_shapes: List[Shape], attrs: Dict):
    """-> (list of output shapes, error message or None). Unknown ops and
    unknown operand shapes degrade to ([None], None)."""
    rule = _SHAPE_RULES.get(op)
    if rule is None:
        if op in _PASSTHROUGH_OPS:
            return [in_shapes[0] if in_shapes else None], None
        return [None], None
    try:
        return rule(in_shapes, attrs)
    except _ShapeConflict as e:
        return [None], str(e)
    except Exception:
        return [None], None            # a rule must never crash the lint


class _ShapeConflict(ValueError):
    pass


def _broadcast(a: Shape, b: Shape, op: str) -> Shape:
    if a is None or b is None:
        return None
    out = []
    for da, db in zip(((None,) * max(0, len(b) - len(a)) + tuple(a)),
                      ((None,) * max(0, len(a) - len(b)) + tuple(b))):
        if da is None or db is None:
            out.append(da if db is None else db if da is None else None)
        elif da == db or db == 1:
            out.append(da)
        elif da == 1:
            out.append(db)
        else:
            raise _ShapeConflict(
                f"{op}: operand shapes {_fmt(a)} and {_fmt(b)} do not "
                f"broadcast (dims {da} vs {db})")
    return tuple(out)


def _fmt(s: Shape) -> str:
    if s is None:
        return "<unknown>"
    return "[" + ", ".join("?" if d is None else str(d) for d in s) + "]"


def _rule_binary(ins, attrs):
    a = ins[0] if len(ins) > 0 else None
    b = ins[1] if len(ins) > 1 else None
    return [_broadcast(a, b, "elementwise")], None


def _rule_matmul(ins, attrs):
    a, b = (ins + [None, None])[:2]
    if a is None or b is None or len(a) < 2 or len(b) < 2:
        return [None], None
    ta = bool(attrs.get("transpose_a"))
    tb = bool(attrs.get("transpose_b"))
    m, k = (a[-1], a[-2]) if ta else (a[-2], a[-1])
    k2, n = (b[-1], b[-2]) if tb else (b[-2], b[-1])
    if k is not None and k2 is not None and k != k2:
        raise _ShapeConflict(
            f"matmul: contracting dims disagree — {_fmt(a)}"
            f"{' (transposed)' if ta else ''} x {_fmt(b)}"
            f"{' (transposed)' if tb else ''} contracts {k} against {k2}")
    batch = _broadcast(a[:-2], b[:-2], "matmul batch dims")
    return [(tuple(batch) if batch else ()) + (m, n)], None


def _rule_xw_plus_b(ins, attrs):
    x, w = (ins + [None, None, None])[:2]
    b = ins[2] if len(ins) > 2 else None
    if x is not None and w is not None and len(x) >= 2 and len(w) == 2 \
            and x[-1] is not None and w[0] is not None and x[-1] != w[0]:
        raise _ShapeConflict(
            f"xw_plus_b: x features {_fmt(x)} do not match W rows {_fmt(w)}")
    if w is not None and b is not None and len(w) == 2 and len(b) == 1 \
            and None not in (w[1], b[0]) and w[1] != b[0]:
        raise _ShapeConflict(
            f"xw_plus_b: bias {_fmt(b)} does not match W cols {_fmt(w)}")
    if x is None or w is None or len(w) != 2:
        return [None], None
    return [tuple(x[:-1]) + (w[1],)], None


def _rule_reduce(ins, attrs):
    x = ins[0] if ins else None
    if x is None:
        return [None], None
    axis = attrs.get("axis")
    keep = bool(attrs.get("keepdims"))
    if axis is None:
        return [((1,) * len(x)) if keep else ()], None
    axes = [axis] if isinstance(axis, int) else list(axis)
    axes = [a % len(x) for a in axes]
    if keep:
        return [tuple(1 if i in axes else d for i, d in enumerate(x))], None
    return [tuple(d for i, d in enumerate(x) if i not in axes)], None


def _rule_reshape(ins, attrs):
    x = ins[0] if ins else None
    shape = attrs.get("shape")
    if shape is None:
        return [None], None
    shape = tuple(int(d) for d in shape)
    if x is not None and None not in x and -1 not in shape:
        n_in, n_out = 1, 1
        for d in x:
            n_in *= d
        for d in shape:
            n_out *= d
        if n_in != n_out:
            raise _ShapeConflict(
                f"reshape: cannot reshape {_fmt(x)} ({n_in} elements) to "
                f"{list(shape)} ({n_out} elements)")
    return [tuple(None if d == -1 else d for d in shape)], None


def _rule_transpose(ins, attrs):
    x = ins[0] if ins else None
    if x is None:
        return [None], None
    perm = attrs.get("perm")
    if not perm:
        return [tuple(reversed(x))], None
    if len(perm) != len(x):
        raise _ShapeConflict(
            f"transpose: perm {list(perm)} does not match rank of {_fmt(x)}")
    return [tuple(x[p] for p in perm)], None


def _rule_loss(ins, attrs):
    a = ins[0] if len(ins) > 0 else None
    b = ins[1] if len(ins) > 1 else None
    if a is not None and b is not None:
        _broadcast(a, b, "loss labels/predictions")
    return [()], None


#: ops whose output shape is their first input's (activations, casts,
#: dropout, normalizers over a known axis)
_PASSTHROUGH_OPS = frozenset({
    "neg", "abs", "exp", "log", "sqrt", "square", "tanh", "sigmoid",
    "relu", "gelu", "swish", "softmax", "log_softmax", "cast", "dropout",
    "sign", "floor", "ceil", "round", "erf", "softplus", "elu", "selu",
    "hard_sigmoid", "leaky_relu", "relu6", "cube", "rsqrt", "reciprocal",
    "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh", "identity",
    "layer_norm", "batchnorm_sd", "bias_add", "std", "variance",
})

_SHAPE_RULES = {
    "add": _rule_binary, "subtract": _rule_binary, "multiply": _rule_binary,
    "divide": _rule_binary, "pow": _rule_binary, "maximum": _rule_binary,
    "minimum": _rule_binary, "greater": _rule_binary, "less": _rule_binary,
    "greater_equal": _rule_binary, "less_equal": _rule_binary,
    "equals": _rule_binary, "not_equals": _rule_binary,
    "squared_difference": _rule_binary, "floordiv": _rule_binary,
    "floormod": _rule_binary, "atan2": _rule_binary,
    "matmul": _rule_matmul,
    "xw_plus_b": _rule_xw_plus_b, "relu_layer": _rule_xw_plus_b,
    "reduce_sum": _rule_reduce, "reduce_mean": _rule_reduce,
    "reduce_max": _rule_reduce, "reduce_min": _rule_reduce,
    "reduce_prod": _rule_reduce, "reduce_norm2": _rule_reduce,
    "argmax": _rule_reduce, "argmin": _rule_reduce,
    "reshape": _rule_reshape,
    "transpose": _rule_transpose,
    "mean_sqerr_loss": _rule_loss, "softmax_cross_entropy_loss": _rule_loss,
    "sigmoid_cross_entropy_loss": _rule_loss, "absolute_difference_loss":
    _rule_loss, "cosine_distance_loss": _rule_loss, "hinge_loss": _rule_loss,
    "huber_loss": _rule_loss, "log_loss": _rule_loss,
    "sparse_softmax_cross_entropy_loss": _rule_loss,
}
