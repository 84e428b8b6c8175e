"""Diagnostic model for the static analyzer (the port of
``deeplearning4j_tpu/analysis/diagnostics.py``).

Reference parity: the pre-init validation DL4J scatters through
``MultiLayerConfiguration.Builder.build`` / ``ComputationGraphConfiguration
.validate`` (nIn/nOut checks, duplicate-name checks, dangling-vertex
checks) — unified here into one structured diagnostic stream the way
TVM's relay type-checker and TensorFlow's pre-session graph validation
report: every finding is a ``Diagnostic(code, severity, location,
message, fix_hint)`` instead of whichever exception happens to fire
first deep inside a forward pass.

The whole ``analysis`` package is static: it reads declared config
shapes, allocates no tensor and calls no ``init``, so it runs ahead of any
capture and where no card is present (``tests/test_torch_analysis_cli.py``
pins this).
"""

from __future__ import annotations

import enum
from typing import Iterable, List, Optional


class Severity(enum.IntEnum):
    """Ordered so reports can sort most-severe first."""

    INFO = 0
    WARNING = 1
    ERROR = 2


#: The documented diagnostic codes (the README table is generated from
#: the same source). E### = configuration errors (init(strict=True)
#: raises), W0## = training-semantics warnings, W1## = Hopper layout
#: lints, W2## = runtime recapture-churn findings.
DIAGNOSTIC_CODES = {
    "DL4J-E001": "nIn mismatch: a layer's declared nIn disagrees with the "
                 "propagated input size (or nIn is unresolvable because no "
                 "InputType was set)",
    "DL4J-E002": "cycle: the computation graph contains a dependency cycle",
    "DL4J-E003": "dangling/unreachable vertex: a node references an "
                 "undefined input, or does not lie on any input->output "
                 "path",
    "DL4J-E004": "duplicate name: two layers/vertices share an explicit "
                 "name",
    "DL4J-E005": "missing CNN->Dense preprocessor: a 4-D feature map feeds "
                 "a dense layer with no flatten step in between",
    "DL4J-E006": "merge-shape conflict: Merge/ElementWise vertex inputs "
                 "have incompatible shapes or kinds",
    "DL4J-E007": "shape inference failure: missing nOut, spatial underflow "
                 "(kernel larger than input), or an invalid layer geometry",
    "DL4J-E008": "missing loss head: the last layer / a graph output is "
                 "not an output or loss layer, so fit() cannot compute a "
                 "loss",
    "DL4J-W001": "loss/activation pairing: softmax with a regression loss, "
                 "or sigmoid with a multiclass cross-entropy",
    "DL4J-W002": "TBPTT configured on a network with no recurrent layers",
    "DL4J-W003": "frozen layers with a stateful updater (updater state is "
                 "allocated and carried for params that never update)",
    "DL4J-W101": "tensor-core tile padding waste: a GEMM's N dim is far "
                 "from the next multiple of the 128-wide Hopper CTA tile "
                 "(wgmma: 64 rows, N a multiple of 8 up to 256, K of 32 "
                 "bytes)",
    "DL4J-W102": "no bf16-rate path: float64 has no tensor-core path at "
                 "the bf16 rate on Hopper (float16 does, and is not "
                 "flagged)",
    "DL4J-W103": "batch size does not divide the data-parallel mesh axis, "
                 "so per-device batches would be ragged",
    "DL4J-W201": "recapture churn: one dispatch site captured more than N "
                 "distinct dispatch signatures (shifting shapes/dtypes)",
    # E1xx/W10x distribution lints (analysis/distribution.py): statically
    # decidable from config + mesh declaration alone, before any compile.
    "DL4J-E101": "batch/mesh mismatch: the global batch size does not "
                 "divide the declared data-parallel mesh axis",
    "DL4J-E102": "mesh axis mismatch: a sharding rule or parallel "
                 "declaration names a mesh axis that is absent (or sized "
                 "differently than the declaration requires)",
    "DL4J-E103": "pipeline tie split: a pipeline stage boundary separates "
                 "two weight-tied layers onto different stages",
    "DL4J-E104": "HBM budget exceeded: the per-device parameter footprint "
                 "(shards + replicated tensors) exceeds the configured "
                 "per-device HBM budget",
    "DL4J-W104": "replicated giant: a large parameter tensor is fully "
                 "replicated although the mesh declares a non-trivial "
                 "model axis it could shard over",
    "DL4J-W105": "pipeline imbalance: per-stage FLOP estimates differ "
                 "beyond tolerance, so the slowest stage gates every tick",
    "DL4J-W106": "sub-tile shard: a sharding rule splits a parameter's "
                 "N dim below one 128-wide Hopper GEMM tile, or its K dim "
                 "below one 16-element wgmma step, per device (or leaves "
                 "it non-divisible, forcing padding)",
    "DL4J-W107": "collective volume: a single layer's estimated gradient "
                 "allreduce payload per step exceeds the threshold",
    "DL4J-W108": "input pipeline cannot feed the chip: the declared "
                 "pipeline's decode- or H2D-bound img/s (workers x "
                 "per-core decode rate, bandwidth / image bytes) is below "
                 "the model's estimated device img/s — the accelerator "
                 "idles regardless of stage overlap",
    "DL4J-W109": "replicated optimizer state: a data-parallel mesh trains "
                 "with the full updater state (Adam moments etc.) "
                 "replicated on every replica above the size threshold "
                 "and no ZeRO plan declared — cross-replica weight-update "
                 "sharding (distributed.zero.ZeroPlan) cuts per-device "
                 "optimizer HBM ~n_data x with identical math",
    # E11x/W11x serving-config lints (analysis/serving.py): validate the
    # bucket ladder x mesh x HBM budget before warmup burns the compiles.
    "DL4J-E110": "serving bucket/mesh mismatch: a batch bucket does not "
                 "divide the serving mesh's data axis, so the sharded "
                 "dispatch cannot place it",
    "DL4J-E111": "serving HBM budget exceeded: replicated params plus the "
                 "largest bucket's activation estimate exceed the "
                 "per-device budget (OOM at peak coalesced load)",
    "DL4J-W110": "serving bucket ladder: duplicate buckets or more buckets "
                 "than the threshold — each bucket x input shape is one "
                 "compiled program (warmup time, executable-cache HBM)",
    "DL4J-W111": "registry roll without warmed buckets: the hot-swap "
                 "target version was never warmed (or misses shapes the "
                 "active version serves warm), so post-roll traffic "
                 "captures under live load",
    "DL4J-W112": "serving warmup without a persistent compile cache (or "
                 "with an unwritable directory): no warm-signature "
                 "manifest is replayed or written, so every fresh "
                 "process, rollout, and hot-swap staging captures what "
                 "an earlier run already named only as traffic arrives",
    "DL4J-W113": "lifecycle observation window shorter than the SLO fast "
                 "window: the canary judge's burn-rate lookback cannot "
                 "contain even one fast-window reference sample, so every "
                 "canary verdict reads a burn of ~0 and promotes blind",
    "DL4J-W114": "canary fraction below routing resolution: fraction x "
                 "expected-requests-per-tick rounds to zero canary-routed "
                 "requests per observation tick (or the fraction is so "
                 "small the smallest batch bucket never fills), so the "
                 "observation window measures the incumbent, not the "
                 "canary",
    # E12x/W12x static cost-model lints (analysis/cost.py): liveness-aware
    # HBM planning, roofline step-time/MFU prediction, fleet capacity.
    "DL4J-E120": "training step-peak HBM overflow: the liveness-aware "
                 "high-water mark (params + grads + fp32 masters + updater "
                 "state + live backward activations + megastep staging + "
                 "prefetch) exceeds the chip's per-device HBM — the "
                 "message names the dominating liveness component, which "
                 "params-only accounting (E104) would have missed",
    "DL4J-E121": "serving-bucket peak HBM overflow: replicated params plus "
                 "the largest bucket's liveness-aware activation peak "
                 "exceed the chip's per-device HBM at peak coalesced load",
    "DL4J-E122": "fleet capacity shortfall: at the predicted per-replica "
                 "throughput the declared replica count cannot sustain the "
                 "declared QPS (or the predicted per-request latency "
                 "already exceeds the p99 budget on an idle replica) — the "
                 "message names the minimal replica count that can",
    "DL4J-W120": "rematerialization opportunity: live backward activations "
                 "dominate the step-peak HBM high-water mark and the peak "
                 "sits near the chip's budget — recomputing activations "
                 "in the backward pass trades cheap FLOPs for the "
                 "dominating memory term",
    "DL4J-W121": "comms-bound step: predicted gradient-collective time "
                 "over the declared interconnect bandwidth exceeds half the "
                 "predicted step time, so scaling the data axis further "
                 "buys little — larger per-device batch, gradient "
                 "accumulation, or precision-reduced collectives move the "
                 "roofline",
    "DL4J-W122": "predicted MFU below target: the roofline step-time "
                 "estimate puts model FLOP utilization under the declared "
                 "mfu_target on the declared chip — the message names the "
                 "binding resource (compute, HBM bandwidth, or "
                 "collectives)",
    # E2xx/W21x concurrency lints (analysis/concurrency.py): AST-level
    # thread-safety analysis of the framework's own (or user) source.
    "DL4J-E201": "unguarded cross-thread mutation: an attribute (or a "
                 "module global shared via threading.Thread(target=fn)) "
                 "is assigned/mutated outside any lock, so other threads "
                 "can observe or clobber intermediate state",
    "DL4J-E202": "unguarded read-modify-write: `self.x += 1` (or an "
                 "equivalent read-then-assign, incl. on module globals) "
                 "on shared state outside any lock — two racing writers "
                 "lose one update (the lost-increment class)",
    "DL4J-E203": "lock-order cycle: the static lock-acquisition graph "
                 "contains a cycle, so two threads taking the locks in "
                 "opposite orders deadlock",
    "DL4J-W210": "wall clock in deadline arithmetic: time.time() (which "
                 "NTP can step) feeds timeout/deadline math — use "
                 "time.monotonic() for durations",
    "DL4J-W211": "Condition.wait() outside a predicate loop: spurious "
                 "wakeups / stolen notifications return with the "
                 "condition still false",
    "DL4J-W212": "unjoined worker thread: a stored thread is started but "
                 "no close/drain path joins it, racing shutdown against "
                 "its last writes",
    "DL4J-W213": "double-checked/lazy initialization race: `if self.x is "
                 "None: self.x = ...` without holding a lock (or without "
                 "re-checking under it) lets two threads both initialize",
    "DL4J-E299": "unparseable source: the concurrency analyzer could not "
                 "parse this file, so none of its classes were checked — "
                 "a distinct code so suppressing a real finding family "
                 "never hides a syntax error",
    # E3xx/W30x numerics & precision lints (analysis/numerics.py):
    # dtype-flow + dynamic-range analysis under a PrecisionPolicy and an
    # optional DataRangeSpec input declaration, before any compile.
    "DL4J-E301": "precision-policy conflict: a low-precision stateful "
                 "updater without fp32 master params (moments overflow "
                 "or round to nothing), or a per-layer dtype override "
                 "contradicting the declared policy",
    "DL4J-E302": "precision-unsafe accumulation: softmax / large-axis "
                 "mean-variance reductions / a loss head accumulating "
                 "in the low-precision compute dtype with no fp32 "
                 "island",
    "DL4J-E303": "dynamic-range overflow: float16 compute without loss "
                 "scaling, or a declared input range whose gradient / "
                 "second-moment magnitude estimate exceeds what the "
                 "dtype x updater combination tolerates (the raw-pixel "
                 "Adam-overflow class)",
    "DL4J-W301": "redundant cast churn: a non-island fp32 override "
                 "sandwiched between low-precision layers bounces "
                 "activations dtype->fp32->dtype at both boundaries "
                 "every step",
    "DL4J-W302": "loss-scaling misconfiguration: a scale where the "
                 "compute dtype does not need one (bf16/fp32), a scale "
                 "< 1, or one large enough to overflow the scaled loss "
                 "itself",
    "DL4J-W303": "unnormalized input: a declared [0, 255]-style range "
                 "with no normalizer attached and no normalization "
                 "layer first in the net",
    # E15x/W15x SameDiff graph lints (analysis/samediff.py).
    "DL4J-E151": "undefined graph input: an op node consumes a name no "
                 "variable, constant, placeholder, or node output defines",
    "DL4J-E152": "graph shape conflict: static shape propagation over the "
                 "recorded op graph found incompatible operand shapes",
    "DL4J-E153": "bad loss variable: setLossVariables names a variable "
                 "that does not exist in the graph",
    "DL4J-W151": "dangling placeholder: a placeholder no recorded op "
                 "consumes (every output() still requires feeding it)",
    "DL4J-W152": "unused variable: a trainable variable no loss output "
                 "depends on (it gets zero gradient every step)",
    "DL4J-W153": "no training op: a TrainingConfig is set but no loss "
                 "variables are marked, so fit() has nothing to minimize",
    # E16x/W16x import-time lints (analysis/imports.py, emitted by the
    # Keras/ONNX/TF importers into the returned model's import_report).
    "DL4J-E161": "unmapped import op: the source graph uses an op the "
                 "importer has no builder for — the import raises (or "
                 "the pre-scan reports every such op up front)",
    "DL4J-E162": "unhonored import semantics: an attribute/opset detail "
                 "the builder cannot reproduce exactly (ceil_mode pools, "
                 "SAME_LOWER asymmetric padding, ...) — results will "
                 "differ from the source framework",
    "DL4J-E163": "lossy import narrowing: an initializer or input dtype "
                 "is narrowed at import (fp64 weights -> fp32, int64 "
                 "indices -> int32) and large values would truncate",
    "DL4J-W161": "dynamic-dim placeholder: a non-batch dimension is "
                 "unknown at import, so every distinct shape fed at "
                 "runtime compiles a fresh executable (recompile churn)",
    "DL4J-W162": "frozen variable: a source-graph variable imported as a "
                 "constant while a TrainingConfig exists — fit() will "
                 "never update it",
    "DL4J-W163": "import const-folding overflow: folding constant "
                 "subgraphs at import produced nonfinite floats or "
                 "values past the target integer range",
}


def normalize_code(code: str) -> str:
    """Accept both spellings everywhere codes are configured:
    ``"W101"``/``"w101"`` and the full ``"DL4J-W101"``."""
    code = str(code).strip().upper()
    if not code.startswith("DL4J-"):
        code = "DL4J-" + code
    if code not in DIAGNOSTIC_CODES:
        raise ValueError(f"unknown diagnostic code {code!r} (documented: "
                         f"{', '.join(sorted(DIAGNOSTIC_CODES))})")
    return code


def _normalize_severity(value) -> "Severity":
    if isinstance(value, Severity):
        return value
    try:
        return Severity[str(value).strip().upper()]
    except KeyError:
        raise ValueError(f"unknown severity {value!r} (use one of "
                         f"{[s.name.lower() for s in Severity]})") from None


class Diagnostic:
    """One structured finding from the analyzer or the churn detector."""

    __slots__ = ("code", "severity", "location", "message", "fix_hint")

    def __init__(self, code: str, severity: Severity, location: str,
                 message: str, fix_hint: Optional[str] = None):
        if code not in DIAGNOSTIC_CODES:
            raise ValueError(f"undocumented diagnostic code {code!r}")
        self.code = code
        self.severity = Severity(severity)
        self.location = location
        self.message = message
        self.fix_hint = fix_hint

    def format(self) -> str:
        line = (f"{self.code} {self.severity.name.lower():<7} "
                f"[{self.location}] {self.message}")
        if self.fix_hint:
            line += f"\n    fix: {self.fix_hint}"
        return line

    def __repr__(self):
        return (f"Diagnostic({self.code}, {self.severity.name}, "
                f"{self.location!r}, {self.message!r})")


class ValidationReport:
    """Ordered collection of diagnostics with severity accessors."""

    def __init__(self, diagnostics: Iterable[Diagnostic] = (),
                 subject: str = ""):
        self.subject = subject
        self.diagnostics: List[Diagnostic] = list(diagnostics)

    def add(self, diag: Diagnostic) -> None:
        self.diagnostics.append(diag)

    def extend(self, diags: Iterable[Diagnostic]) -> None:
        self.diagnostics.extend(diags)

    def apply_config(self, suppress: Iterable[str] = None,
                     severity_overrides=None) -> "ValidationReport":
        """Per-code report shaping (the flake8-noqa equivalent for model
        lints): drop every diagnostic whose code is in ``suppress``, and
        re-grade codes named in ``severity_overrides`` ({code: severity},
        severity as a :class:`Severity` or its name). Codes accept both
        the short (``"W101"``) and full (``"DL4J-W101"``) spelling.
        Mutates and returns the report (so ``validate(...)`` chains)."""
        if suppress:
            if isinstance(suppress, str):
                suppress = [suppress]
            dropped = {normalize_code(c) for c in suppress}
            self.diagnostics = [d for d in self.diagnostics
                                if d.code not in dropped]
        if severity_overrides:
            remap = {normalize_code(c): _normalize_severity(s)
                     for c, s in dict(severity_overrides).items()}
            for d in self.diagnostics:
                if d.code in remap:
                    d.severity = remap[d.code]
        return self

    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity is Severity.ERROR]

    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity is Severity.WARNING]

    def codes(self) -> List[str]:
        return [d.code for d in self.diagnostics]

    def ok(self, warnings_as_errors: bool = False) -> bool:
        if self.errors():
            return False
        return not (warnings_as_errors and self.warnings())

    def raise_if_errors(self) -> "ValidationReport":
        if self.errors():
            raise ModelValidationError(self)
        return self

    def format(self) -> str:
        head = self.subject or "model"
        if not self.diagnostics:
            return f"{head}: clean (0 errors, 0 warnings)"
        lines = [f"{head}: {len(self.errors())} error(s), "
                 f"{len(self.warnings())} warning(s)"]
        for d in sorted(self.diagnostics, key=lambda d: -int(d.severity)):
            lines.append("  " + d.format().replace("\n", "\n  "))
        return "\n".join(lines)

    def __iter__(self):
        return iter(self.diagnostics)

    def __len__(self):
        return len(self.diagnostics)

    def __str__(self):
        return self.format()

    def __repr__(self):
        return (f"ValidationReport({self.subject!r}, "
                f"errors={len(self.errors())}, "
                f"warnings={len(self.warnings())})")


class ModelValidationError(ValueError):
    """Raised by ``init(strict=True)`` / ``raise_if_errors`` on E-codes."""

    def __init__(self, report: ValidationReport):
        self.report = report
        super().__init__(report.format())
