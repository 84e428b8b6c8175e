"""CLI: lint a lifecycle plan before it drives traffic.

Usage::

    python -m deeplearning4j_tpu_torch.lifecycle --observation-window 30 \\
        --canary-fraction 0.1 --slo-windows 60,600 \\
        --requests-per-tick 40 --buckets 8,16,32

Exit status 0 only when the plan is clean (DL4J-W113/W114 count as
failures unless ``--warnings-ok``). Purely static — no tensor, no
registry, no traffic.
"""

from __future__ import annotations

import argparse
import sys

from deeplearning4j_tpu_torch.analysis.lifecycle import lint_lifecycle


def _floats(csv: str):
    return [float(v) for v in csv.split(",") if v.strip()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.lifecycle",
        description="Static lint for a lifecycle driver plan "
                    "(DL4J-W113/W114)")
    ap.add_argument("--observation-window", type=float, required=True,
                    help="judge burn-rate lookback per tick, seconds")
    ap.add_argument("--canary-fraction", type=float, required=True,
                    help="fraction of unpinned traffic the canary takes")
    ap.add_argument("--slo-windows", type=_floats, default=None,
                    metavar="FAST,SLOW",
                    help="the SLOSpec windows the judge consults")
    ap.add_argument("--requests-per-tick", type=float, default=None,
                    help="expected unpinned requests per observation tick")
    ap.add_argument("--buckets", type=_floats, default=None,
                    metavar="B1,B2,...",
                    help="the canary server's batch bucket ladder")
    ap.add_argument("--warnings-ok", action="store_true",
                    help="exit 0 even when warnings fire")
    args = ap.parse_args(argv)

    report = lint_lifecycle(
        observation_window=args.observation_window,
        canary_fraction=args.canary_fraction,
        slo_windows=args.slo_windows,
        requests_per_tick=args.requests_per_tick,
        buckets=[int(b) for b in args.buckets] if args.buckets else None)
    if not report.diagnostics:
        print("lifecycle plan: clean")
        return 0
    for d in report.diagnostics:
        print(d.format())
    return 0 if args.warnings_ok else 1


if __name__ == "__main__":
    sys.exit(main())
