"""The diagnostic model (the slice's subset of
``deeplearning4j_tpu/analysis/diagnostics.py``): ``Severity``,
``Diagnostic``, ``ValidationReport`` and ``ModelValidationError``, with
the codes the port reports so far."""

from __future__ import annotations

import enum
from typing import Iterable, List, Optional


class Severity(enum.IntEnum):
    """Ordered so reports can sort most-severe first."""

    INFO = 0
    WARNING = 1
    ERROR = 2


#: the documented codes the port emits (the JAX package's text)
DIAGNOSTIC_CODES = {
    "DL4J-W111": "registry roll without warmed buckets: the hot-swap "
                 "target version was never warmed (or misses shapes the "
                 "active version serves warm), so post-roll traffic "
                 "captures under live load",
    # E16x/W16x import-time lints (analysis/imports.py, emitted by the
    # importers into the returned graph's import_report)
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
    "DL4J-W201": "recompile churn: one dispatch site compiled more than N "
                 "distinct jit signatures (shifting shapes/dtypes)",
}


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

    def __iter__(self):
        return iter(self.diagnostics)

    def __len__(self):
        return len(self.diagnostics)

    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity is Severity.ERROR]

    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity is Severity.WARNING]

    def codes(self) -> List[str]:
        return [d.code for d in self.diagnostics]

    def format(self) -> str:
        head = self.subject or "model"
        if not self.diagnostics:
            return f"{head}: clean (0 errors, 0 warnings)"
        lines = [f"{head}: {len(self.errors())} error(s), "
                 f"{len(self.warnings())} warning(s)"]
        for d in sorted(self.diagnostics, key=lambda d: -int(d.severity)):
            lines.append("  " + d.format().replace("\n", "\n  "))
        return "\n".join(lines)


class ModelValidationError(ValueError):
    """Raised by a strict check (``ModelRegistry.roll(strict=True)``)."""

    def __init__(self, report: ValidationReport):
        self.report = report
        super().__init__(report.format())
