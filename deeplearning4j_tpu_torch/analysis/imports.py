"""Import-time lints (E161-E163, W161-W163): what a model loses crossing
the border into the port — the port of
``deeplearning4j_tpu/analysis/imports.py`` (ONNX, TF and Keras).

The importers call in with what they have (const arrays, folded arrays,
the finished SameDiff; a Keras file's input shapes and weight arrays)
and attach the resulting :class:`~.diagnostics.ValidationReport` to the
graph or network as ``import_report``. Codes:

- ``E161`` unmapped op: the ONNX importer has no builder for it (the
  import raises; :func:`lint_onnx_model` pre-scans so every unmapped op
  surfaces at once).
- ``E162`` unhonored semantics: an ONNX attribute the builder silently
  approximates (``ceil_mode`` pools, ``SAME_LOWER`` padding, non-constant
  ``Pad``).
- ``E163`` lossy narrowing: fp64 consts demote to fp32 and int64 values
  past the int32 range truncate (the port feeds its graphs the dtypes the
  JAX package does with x64 off).
- ``W161`` dynamic-dim placeholder: a non-batch unknown dim.
- ``W162`` frozen variable: an imported weight left a constant while a
  TrainingConfig is attached.
- ``W163`` const-folding overflow: folding at import produced nonfinite
  floats or values past the int32 range.

"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.analysis.diagnostics import (Diagnostic,
                                                           Severity,
                                                           ValidationReport)
from deeplearning4j_tpu_torch.analysis.graphir import (ONNX_DTYPE_NAMES,
                                                       WEIGHT_POSITIONS)

_INT32_MAX = 2 ** 31 - 1
_INT32_MIN = -(2 ** 31)

#: ops ``modelimport.onnx._BUILDERS`` maps (plus ``Constant``, which the
#: importer handles inline): a mirror so the E161 pre-scan runs without
#: importing the importer, pinned against its registry by test
SUPPORTED_ONNX_OPS = frozenset({
    "Constant",
    # _SIMPLE_OPS
    "Add", "Sub", "Mul", "Div", "Pow", "Max", "Min", "Neg", "Abs", "Exp",
    "Log", "Sqrt", "Reciprocal", "Floor", "Ceil", "Round", "Sign", "Relu",
    "Sigmoid", "Tanh", "Erf", "Softplus", "Softsign", "Selu", "Identity",
    "MatMul", "Sin", "Cos", "Where", "Equal", "Greater", "GreaterOrEqual",
    "Less", "LessOrEqual", "Not", "And", "Or", "GlobalAveragePool",
    "GlobalMaxPool", "Shape", "Size",
    # decorated builders
    "Gemm", "Softmax", "LogSoftmax", "LeakyRelu", "Elu", "HardSigmoid",
    "Gelu", "Clip", "Transpose", "Reshape", "Flatten", "Concat", "Squeeze",
    "Unsqueeze", "Gather", "Slice", "Cast", "Conv", "BatchNormalization",
    "Pad", "Expand", "Split", "Dropout",
    # pools + reductions
    "MaxPool", "AveragePool", "ReduceMean", "ReduceSum", "ReduceMax",
    "ReduceMin", "ReduceProd",
})

#: dtype names that narrow at import (the dtypes the JAX package computes
#: in with x64 off)
_NARROWED = {"float64": "float32", "int64": "int32", "uint64": "uint32"}


def _attr_of(node, name):
    """A NodeProto attribute's value by name, None when absent (off the
    ``onnx_proto`` NodeProto: ``attrs`` maps names to objects with
    ``.value``)."""
    a = (getattr(node, "attrs", {}) or {}).get(name)
    if a is None:
        return None
    v = getattr(a, "value", a)
    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    return v


def lint_onnx_model(model, supported_ops: Optional[Iterable[str]] = None
                    ) -> ValidationReport:
    """Pre-import scan of a parsed ONNX ModelProto: E161, E162, E163 on
    initializers and graph inputs, W161 on graph inputs. It runs before
    (and apart from) the import, so an admission check can refuse a model
    without building it. ``supported_ops`` defaults to
    :data:`SUPPORTED_ONNX_OPS`; the importer passes its own registry."""
    report = ValidationReport(subject="ONNX import")
    supported = set(supported_ops) if supported_ops is not None \
        else SUPPORTED_ONNX_OPS
    g = getattr(model, "graph", model)
    if g is None:
        return report

    for node in getattr(g, "nodes", ()) or ():
        op = node.op_type
        loc = f"node '{node.name or node.outputs[0]}' ({op})"
        if op not in supported:
            report.add(Diagnostic(
                "DL4J-E161", Severity.ERROR, loc,
                f"unmapped ONNX op '{op}' — the importer has no builder "
                f"for it and importOnnxModel will raise",
                fix_hint="add a builder to modelimport.onnx._BUILDERS or "
                         "export the model without this op"))
            continue
        report.extend(_onnx_node_semantics(op, node, loc))

    init_names = set()
    for t in getattr(g, "initializers", ()) or ():
        init_names.add(t.name)
        report.extend(lint_narrowed_array(
            t.array, f"initializer '{t.name}'",
            dtype_name=ONNX_DTYPE_NAMES.get(
                getattr(t, "data_type", None))))
    for vi in getattr(g, "inputs", ()) or ():
        if vi.name in init_names:
            continue
        report.extend(lint_placeholder_shape(
            getattr(vi, "shape", None), f"graph input '{vi.name}'"))
        elem = ONNX_DTYPE_NAMES.get(getattr(vi, "elem_type", None))
        if elem in _NARROWED:
            report.add(Diagnostic(
                "DL4J-E163", Severity.ERROR, f"graph input '{vi.name}'",
                f"input dtype {elem} narrows to {_NARROWED[elem]} at "
                f"import — values past the narrow range truncate silently "
                f"at feed time",
                fix_hint=f"export the model with {_NARROWED[elem]} "
                         f"inputs (or re-quantize the feed)"))
    return report


def _onnx_node_semantics(op: str, node, loc: str) -> List[Diagnostic]:
    """E162: attributes the builders silently approximate."""
    diags: List[Diagnostic] = []
    if op in ("MaxPool", "AveragePool") and _attr_of(node, "ceil_mode"):
        diags.append(Diagnostic(
            "DL4J-E162", Severity.ERROR, loc,
            f"{op} ceil_mode=1 is not honored — the builder always "
            f"floor-divides the output size, so the last partial window "
            f"is dropped and shapes downstream shift",
            fix_hint="re-export with ceil_mode=0 (add explicit padding "
                     "to keep the output size)"))
    if op in ("Conv", "MaxPool", "AveragePool") and \
            _attr_of(node, "auto_pad") == "SAME_LOWER":
        diags.append(Diagnostic(
            "DL4J-E162", Severity.ERROR, loc,
            f"{op} auto_pad=SAME_LOWER imports as SAME_UPPER — odd "
            f"padding lands on the opposite edge, shifting every output "
            f"by one for even kernels",
            fix_hint="re-export with explicit pads (or SAME_UPPER if the "
                     "off-by-one is acceptable)"))
    if op == "Pad":
        mode = _attr_of(node, "mode")
        if mode and str(mode) not in ("constant",):
            diags.append(Diagnostic(
                "DL4J-E162", Severity.ERROR, loc,
                f"Pad mode '{mode}' is not honored (constant-mode "
                f"padding only)",
                fix_hint="re-export with constant padding"))
    return diags


def lint_placeholder_shape(shape, loc: str) -> List[Diagnostic]:
    """W161: unknown non-batch dims force one compile per runtime shape."""
    if shape is None:
        return [Diagnostic(
            "DL4J-W161", Severity.WARNING, loc,
            "input has no static shape at all — every distinct shape fed "
            "at runtime compiles a fresh executable",
            fix_hint="export with a static shape (batch may stay "
                     "dynamic), or serve through fixed bucket shapes")]
    dyn = [i for i, d in enumerate(shape)
           if i > 0 and (d is None or (isinstance(d, int) and d <= 0)
                         or isinstance(d, str))]
    if not dyn:
        return []
    return [Diagnostic(
        "DL4J-W161", Severity.WARNING, loc,
        f"non-batch dimension(s) {dyn} of shape "
        f"{[d if d else '?' for d in shape]} are dynamic — each distinct "
        f"value fed at runtime compiles a fresh executable "
        f"(recompile churn)",
        fix_hint="fix the free dims at export time, or pad inputs to a "
                 "bucket ladder before feeding")]


def lint_narrowed_array(arr, loc: str,
                        dtype_name: Optional[str] = None
                        ) -> List[Diagnostic]:
    """E163 for one source array: fp64 always loses mantissa; int64 only
    matters when values exceed the int32 range (shape constants stay
    clean)."""
    dt = dtype_name or str(getattr(arr, "dtype", ""))
    if dt in ("float64", "double"):
        return [Diagnostic(
            "DL4J-E163", Severity.ERROR, loc,
            "float64 weights narrow to float32 at import — the extra "
            "mantissa the exporter preserved is silently dropped",
            fix_hint="export weights as float32, or accept the rounding "
                     "and suppress this code")]
    if dt in ("int64", "uint64"):
        a = np.asarray(arr)
        if a.size and (int(a.max(initial=0)) > _INT32_MAX
                       or int(a.min(initial=0)) < _INT32_MIN):
            return [Diagnostic(
                "DL4J-E163", Severity.ERROR, loc,
                f"{dt} values exceed the int32 range and truncate at "
                f"import — indices/ids above 2**31 wrap to garbage",
                fix_hint="remap the id space below 2**31 or split the "
                         "embedding table")]
    return []


def fold_overflow_diags(op: str, name: str,
                        arrays: Sequence) -> List[Diagnostic]:
    """W163 for one const-folded node's outputs: nonfinite floats (the
    fold overflowed) or integer values past the int32 range."""
    diags: List[Diagnostic] = []
    for arr in arrays:
        try:
            a = np.asarray(arr)
        except (TypeError, ValueError):      # e.g. a bf16 tensor
            continue
        kind = getattr(a.dtype, "kind", "")
        if kind == "f" and a.size and not bool(np.isfinite(a).all()):
            diags.append(Diagnostic(
                "DL4J-W163", Severity.WARNING, f"folded '{name}' ({op})",
                "import-time const folding produced nonfinite values — "
                "the constant subgraph overflows before the model ever "
                "runs",
                fix_hint="check the exporter's constant arithmetic "
                         "(scale factors, epsilon placement)"))
            break
        if kind in ("i", "u") and a.dtype.itemsize > 4 and a.size and \
                (int(a.max(initial=0)) > _INT32_MAX
                 or int(a.min(initial=0)) < _INT32_MIN):
            diags.append(Diagnostic(
                "DL4J-W163", Severity.WARNING, f"folded '{name}' ({op})",
                "import-time const folding produced int64 values past "
                "the int32 range — they truncate when a consumer "
                "materializes them on device",
                fix_hint="keep the constant below 2**31 (shape math "
                         "rarely needs more)"))
            break
    return diags


def lint_frozen_constants(sd) -> List[Diagnostic]:
    """W162: weight-position constants (imported frozen weights) while a
    TrainingConfig is attached — ``fit()`` trains around them without
    ever updating them. Clean without a training config: serving a frozen
    import is the normal case."""
    if getattr(sd, "training_config", None) is None:
        return []
    constants = dict(getattr(sd, "_constants", {}) or {})
    diags: List[Diagnostic] = []
    seen = set()
    for node in getattr(sd, "_nodes", ()) or ():
        for pos in WEIGHT_POSITIONS.get(node.op, ()):
            if pos >= len(node.inputs):
                continue
            name = node.inputs[pos]
            if name not in constants or name in seen:
                continue
            seen.add(name)
            diags.append(Diagnostic(
                "DL4J-W162", Severity.WARNING,
                f"constant '{name}' (op '{node.outputs[0]}' ({node.op}))",
                "weight imported as a constant while a TrainingConfig is "
                "attached — fit() computes no gradient for it and it "
                "stays frozen at its imported value",
                fix_hint="convert it to a variable (sd.convertToVariables) "
                         "or drop the TrainingConfig if this model only "
                         "serves"))
    return diags


def samediff_import_report(sd) -> ValidationReport:
    """The graph-side import findings: W161 on the recorded placeholders
    that some node consumes (TF's lowered-while graphs ship dummy
    ``unused_control_flow_input`` feeds). Importers extend it with their
    format-specific findings."""
    report = ValidationReport(subject="import")
    consumed = set()
    for node in getattr(sd, "_nodes", []) or []:
        consumed.update(node.inputs)
    for name, (shape, _dtype) in dict(
            getattr(sd, "_placeholders", {}) or {}).items():
        if consumed and name not in consumed:
            continue
        report.extend(
            lint_placeholder_shape(shape, f"placeholder '{name}'"))
    return report
