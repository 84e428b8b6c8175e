"""Lifecycle-plan lint: is the canary observation actually observable?

The lifecycle driver's promote/rollback verdicts are only as good as
the evidence its judge can collect during the observation window. Two
configurations silently produce evidence-free verdicts, and both are
statically decidable from the plan alone (no device — same contract as
the rest of ``analysis``):

- ``DL4J-W113``: the judge's burn-rate lookback
  (``observation_window``) is shorter than the SLO spec's FAST window.
  ``SLOEngine.burn_over`` references the newest sample at least
  window-seconds old; a lookback that cannot contain one fast-window
  reference reads a burn of ~0 on a fleet that is actively burning —
  the canary promotes blind.
- ``DL4J-W114``: the canary fraction is below routing resolution for
  the expected per-tick traffic — ``fraction x requests_per_tick``
  rounds to zero canary-routed requests (the credit accumulator never
  crosses 1.0 within a tick), so the "canary" metrics the judge reads
  are pure incumbent. Also fired when the per-tick canary volume
  cannot fill even the smallest batch bucket (the canary only ever
  measures the padded-out fringe).

Entry point: :func:`lint_lifecycle` (what ``python -m
deeplearning4j_tpu_torch.lifecycle`` and the driver's ``validate()`` call).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from deeplearning4j_tpu_torch.analysis.diagnostics import (
    Diagnostic, Severity, ValidationReport)


def lint_lifecycle(observation_window: float,
                   canary_fraction: float,
                   slo_windows: Optional[Sequence[float]] = None,
                   requests_per_tick: Optional[float] = None,
                   buckets: Optional[Sequence[int]] = None,
                   subject: str = "lifecycle") -> ValidationReport:
    """Lint one lifecycle plan. ``slo_windows`` is the (fast, slow)
    pair from the :class:`~deeplearning4j_tpu_torch.profiler.slo.SLOSpec`
    the judge consults; ``requests_per_tick`` the expected unpinned
    request volume per observation tick; ``buckets`` the serving
    bucket ladder of the canary's server."""
    diags: List[Diagnostic] = []
    if slo_windows:
        fast = float(min(slo_windows))
        if float(observation_window) < fast:
            diags.append(Diagnostic(
                "DL4J-W113", Severity.WARNING, subject,
                f"observation_window {observation_window:g}s is shorter "
                f"than the SLO fast window {fast:g}s — burn_over() "
                "cannot reference a sample one fast-window old, so "
                "every canary verdict reads ~0 burn",
                fix_hint="raise observation_window to at least the "
                         "fast window (or shrink the SLOSpec's "
                         "windows for the canary judge)"))
    if requests_per_tick is not None:
        expected = float(canary_fraction) * float(requests_per_tick)
        if expected < 1.0:
            diags.append(Diagnostic(
                "DL4J-W114", Severity.WARNING, subject,
                f"canary_fraction {canary_fraction:g} x "
                f"{requests_per_tick:g} requests/tick = {expected:.2f} "
                "canary-routed requests per observation tick — the "
                "judge is measuring the incumbent, not the canary",
                fix_hint="raise the fraction, lengthen the tick, or "
                         "drive more traffic during observation"))
        elif buckets:
            smallest = min(int(b) for b in buckets)
            if expected < smallest:
                diags.append(Diagnostic(
                    "DL4J-W114", Severity.WARNING, subject,
                    f"~{expected:.1f} canary requests/tick cannot fill "
                    f"the smallest batch bucket ({smallest}) — every "
                    "canary batch is mostly padding, so its latency "
                    "signal is the bucket's, not the model's",
                    fix_hint="raise the fraction or accept the padded "
                             "signal (occupancy shows up in "
                             "batch_occupancy_mean)"))
    return ValidationReport(diags, subject=subject)
