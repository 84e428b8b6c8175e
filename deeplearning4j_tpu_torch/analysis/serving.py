"""Serving lints (the port's subset of
``deeplearning4j_tpu/analysis/serving.py``): the pre-roll registry lint
``DL4J-W111``. ``lint_serving`` (E110, E111, W110, W112) is not ported
yet (ROADMAP.md)."""

from __future__ import annotations

from typing import List

from deeplearning4j_tpu_torch.analysis.diagnostics import (Diagnostic,
                                                           Severity,
                                                           ValidationReport)


def lint_registry_roll(model_name: str, target, active=None
                       ) -> ValidationReport:
    """Pre-roll lint for a multi-model registry version swap: ``target``
    (and optionally the currently ``active`` version) are server-like
    objects exposing ``_warmed`` / ``_warm_shapes`` / ``buckets()`` —
    duck-typed, so the check runs before any traffic moves.

    - ``DL4J-W111`` when the target was never warmed at all, or when
      shapes the active version serves warm are missing from the
      target's warmed set (those requests are refused as unwarmed right
      after the roll).
    """
    diags: List[Diagnostic] = []
    loc = f"registry roll -> {model_name}"
    warmed = bool(getattr(target, "_warmed", False))
    t_shapes = [tuple(s) for s in getattr(target, "_warm_shapes", [])]
    if not warmed:
        diags.append(Diagnostic(
            "DL4J-W111", Severity.WARNING, loc,
            "roll planned onto a version with NO warmed buckets — every "
            "post-roll request runs uncaptured under live traffic (the "
            "cold start a zero-drop hot-swap must not pay)",
            fix_hint="warmup([...]) the new version on the serving card "
                     "BEFORE roll() (ModelRegistry.load does this when "
                     "shapes are known)"))
    elif active is not None:
        a_shapes = [tuple(s) for s in getattr(active, "_warm_shapes", [])]
        missing = [s for s in a_shapes if s not in t_shapes]
        if missing:
            diags.append(Diagnostic(
                "DL4J-W111", Severity.WARNING, loc,
                f"active version serves warmed shapes {missing} the roll "
                "target never captured — those requests are refused as "
                "unwarmed shapes right after the swap",
                fix_hint="warm the target with the active version's full "
                         "shape set before rolling"))
    return ValidationReport(diags, subject="registry roll")
