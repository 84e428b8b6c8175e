"""Import-time lints (E163, W161-W163): what a model loses crossing the
border into the port — the TF and Keras halves of
``deeplearning4j_tpu/analysis/imports.py``.

The importers call in with what they have (const arrays, folded arrays,
the finished SameDiff; a Keras file's input shapes and weight arrays)
and attach the resulting :class:`~.diagnostics.ValidationReport` to the
graph or network as ``import_report``. Codes:

- ``E163`` lossy narrowing: fp64 consts demote to fp32 and int64 values
  past the int32 range truncate (the port feeds its graphs the dtypes the
  JAX package does with x64 off).
- ``W161`` dynamic-dim placeholder: a non-batch unknown dim.
- ``W162`` frozen variable: an imported weight left a constant while a
  TrainingConfig is attached.
- ``W163`` const-folding overflow: folding at import produced nonfinite
  floats or values past the int32 range.

Not ported yet: the ONNX lints (E161 pre-scan, E162), which wait for the
ONNX importer.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_tpu_torch.analysis.diagnostics import (Diagnostic,
                                                           Severity,
                                                           ValidationReport)

_INT32_MAX = 2 ** 31 - 1
_INT32_MIN = -(2 ** 31)

#: the input positions that hold weights, by op (the JAX package's
#: ``analysis/graphir.py`` WEIGHT_POSITIONS, without the ONNX ops the
#: port cannot import yet)
WEIGHT_POSITIONS: Dict[str, Tuple[int, ...]] = {
    "matmul": (1,), "xw_plus_b": (1, 2), "relu_layer": (1, 2),
    "tf.MatMul": (1,), "tf.Conv2D": (1,), "tf.DepthwiseConv2dNative": (1,),
    "tf.BiasAdd": (1,), "tf.FusedBatchNormV3": (1, 2, 3, 4),
}


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
