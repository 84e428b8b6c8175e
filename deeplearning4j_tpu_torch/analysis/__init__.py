"""Static model linter + runtime recapture-churn detector: the port of
``deeplearning4j_tpu/analysis/``, priced for the H100.

Catch misconfiguration before it allocates a parameter or captures a
step (TVM-style whole-graph analysis ahead of codegen; TensorFlow's
pre-session graph validation is the same shape of tool):

- :mod:`analyzer` — walks MultiLayerConfiguration /
  ComputationGraphConfiguration without touching a tensor, propagating
  InputType shapes layer-by-layer and vertex-by-vertex into structured
  ``Diagnostic(code, severity, location, message, fix_hint)`` findings
  (``DL4J-E001`` nIn mismatch, ``E002`` cycle, ``E003`` dangling vertex,
  ``E004`` duplicate name, ``E005`` missing CNN->Dense flatten, ``E006``
  merge-shape conflict, ``E007`` shape-inference failure, ``E008``
  missing loss head, ``W001`` loss/activation pairing, ``W002`` TBPTT
  without recurrence, ``W003`` frozen layers + stateful updater).
- :mod:`layout` — Hopper layout lints: ``W101`` tensor-core tile-padding
  waste (a GEMM's N dim against the 128-wide CTA tile), ``W102`` dtypes
  with no bf16-rate path (float64), ``W103`` batch vs. data-mesh
  divisibility.
- :mod:`distribution` — mesh/sharding/pipeline lints against a declared
  :class:`MeshSpec`: ``E101`` batch vs. data axis, ``E102`` absent mesh
  axis, ``E103`` pipeline-split weight tie, ``E104`` per-device HBM
  budget, ``W104`` replicated giant, ``W105`` pipeline FLOP imbalance,
  ``W106`` shard below one Hopper GEMM tile, ``W107`` per-layer
  collective volume.
- :mod:`pipeline` — input-pipeline feasibility against a declared
  :class:`InputPipelineSpec` (``analyze(..., input_pipeline=...)``, CLI
  ``--pipeline workers=8,batch=256,decode_ms=1.3``): ``W108`` host-bound
  decode/H2D img/s below the model's estimated device img/s — "this
  host cannot feed this chip", caught before any worker spawns.
- :mod:`numerics` — numerics & precision lints under a declared
  :class:`~deeplearning4j_tpu_torch.nn.precision.PrecisionPolicy` and an
  optional :class:`DataRangeSpec` (``analyze(..., policy="bf16",
  data_range="0..255")``, CLI ``--policy bf16 --data-range 0..255``):
  ``E301`` policy conflict, ``E302`` precision-unsafe accumulation,
  ``E303`` dynamic-range overflow (the raw-pixel Adam-overflow class,
  statically), ``W301`` redundant cast churn, ``W302`` loss-scaling
  misconfiguration, ``W303`` unnormalized input.
- :mod:`serving` — serving-config lints (``ModelServer.validate()`` /
  :func:`lint_serving`): ``E110`` bucket vs. data-axis divisibility,
  ``E111`` serving HBM budget (params + largest-bucket activations),
  ``W110`` pathological bucket ladder.
- :mod:`samediff` — recorded-op-graph lints (``sd.validate()``): shape
  propagation over ``_Node`` graphs plus ``E151`` undefined input,
  ``E152`` shape conflict, ``E153`` bad loss variable, ``W151`` dangling
  placeholder, ``W152`` unused variable, ``W153`` no training op.
- :mod:`graphir` — static analysis IR (typed tensor facts: shape,
  dtype, param-vs-activation, per-op FLOPs, producer/consumer edges)
  with two lowerings: :func:`~graphir.from_samediff` (recorded ``_Node``
  graphs, including imported ones) and :func:`~graphir.from_multilayer`
  (native configs — the parity proof). The layout / distribution /
  numerics families run over the IR, so ``sd.validate(mesh=...,
  policy=..., data_range=...)`` emits the same codes native configs get.
- :mod:`imports` — import-time lints shared by the Keras/ONNX/TF
  importers (each attaches a ``ValidationReport`` as ``import_report``
  on the returned model; ``analyze()`` folds it in): ``E161`` unmapped
  op, ``E162`` unhonored attribute semantics, ``E163`` lossy dtype
  narrowing, ``W161`` dynamic-dim placeholder recompile churn, ``W162``
  frozen-graph variable trained as constant, ``W163`` import-time
  const-folding overflow.
- :mod:`concurrency` — AST-level thread-safety lints over source files
  or modules (:func:`analyze_concurrency`, ``--concurrency`` on the
  CLI, which lints this package when given no target): ``E201`` unguarded
  cross-thread mutation, ``E202`` read-modify-write outside a lock,
  ``E203`` lock-order cycle, ``W210`` wall clock in deadline math,
  ``W211`` un-looped ``Condition.wait``, ``W212`` unjoined worker
  thread, ``W213`` double-checked initialization race.
- :mod:`cost` / :mod:`chipspec` — whole-program static cost model
  against a declared :class:`~chipspec.ChipSpec` (``analyze(...,
  cost=CostSpec(chip="h100-sxm"))``, CLI ``--cost --chip h100-sxm``): an
  activation-lifetime liveness pass over the :mod:`graphir` edges
  computes the true training-step HBM high-water mark (params, grads,
  fp32 masters, ZeRO-aware updater state, live activations held for
  backward, megastep staging, prefetch), a roofline estimator predicts
  step time / per-stage time / MFU, and a capacity planner sizes a
  serving fleet: ``E120`` step-peak HBM overflow, ``E121`` serving-
  bucket peak overflow, ``E122`` capacity shortfall, ``W120`` remat
  opportunity, ``W121`` comms-bound step, ``W122`` predicted MFU below
  target. When ``cost=`` is declared the exact plan supersedes the
  params-only ``E104``/``W109`` heuristics.
- :mod:`churn` — runtime detector behind the fit/capture dispatch seams:
  ``dl4j_recompiles_total{site=...}`` in the profiler registry plus a
  ``W201`` diagnostic when one site crosses the signature threshold.

Entry points: ``config.validate()`` / ``model.validate()`` /
``sd.validate()`` (all accept ``mesh=...``, ``suppress=[...]``,
``severity_overrides={...}``), ``init(strict=True)`` (raises
:class:`ModelValidationError` on E-codes), and ``python -m
deeplearning4j_tpu_torch.analysis [--zoo | <model-or-module>] [--mesh data=8]``.

Analysis is pure-static: it allocates no tensor and calls no ``init``,
so it runs wherever the configs import, with or without a card.
"""

from deeplearning4j_tpu_torch.analysis.analyzer import analyze
from deeplearning4j_tpu_torch.analysis.chipspec import CHIP_REGISTRY, ChipSpec
from deeplearning4j_tpu_torch.analysis.concurrency import analyze_concurrency
from deeplearning4j_tpu_torch.analysis.cost import (
    CostSpec, capacity, lint_cost, memory_plan, plan, step_time)
from deeplearning4j_tpu_torch.analysis.churn import (RecompileChurnDetector,
                                                     array_fingerprint,
                                                     get_churn_detector)
from deeplearning4j_tpu_torch.analysis.diagnostics import (
    DIAGNOSTIC_CODES, Diagnostic, ModelValidationError, Severity,
    ValidationReport, normalize_code)
from deeplearning4j_tpu_torch.analysis.distribution import (
    MeshSpec, PipelineSpec, StageProfile)
from deeplearning4j_tpu_torch.analysis.graphir import (
    GraphIR, from_multilayer, from_samediff, lint_ir_distribution,
    lint_ir_layout, lint_ir_numerics)
from deeplearning4j_tpu_torch.analysis.imports import (lint_narrowed_array,
                                                       lint_onnx_model,
                                                       lint_placeholder_shape,
                                                       samediff_import_report)
from deeplearning4j_tpu_torch.analysis.numerics import \
    DataRangeSpec, lint_numerics
from deeplearning4j_tpu_torch.analysis.pipeline import (InputPipelineSpec,
                                                        lint_input_pipeline)
from deeplearning4j_tpu_torch.analysis.samediff import analyze_samediff
from deeplearning4j_tpu_torch.analysis.serving import (lint_compile_cache,
                                                       lint_registry_roll,
                                                       lint_serving)

__all__ = [
    "analyze", "analyze_concurrency", "analyze_samediff", "Diagnostic",
    "Severity",
    "ValidationReport", "ModelValidationError", "DIAGNOSTIC_CODES",
    "MeshSpec", "PipelineSpec", "StageProfile", "InputPipelineSpec",
    "lint_input_pipeline",
    "ChipSpec", "CHIP_REGISTRY", "CostSpec", "memory_plan", "step_time",
    "capacity", "lint_cost", "plan",
    "DataRangeSpec", "lint_numerics",
    "normalize_code", "RecompileChurnDetector",
    "get_churn_detector", "array_fingerprint", "lint_serving",
    "lint_registry_roll", "lint_compile_cache",
    "GraphIR", "from_samediff", "from_multilayer", "lint_ir_layout",
    "lint_ir_distribution", "lint_ir_numerics",
    "lint_onnx_model", "lint_narrowed_array", "lint_placeholder_shape",
    "samediff_import_report",
]
