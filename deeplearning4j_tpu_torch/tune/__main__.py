"""``python -m deeplearning4j_tpu_torch.tune <zoo-model> --budget N`` —
tune a zoo architecture on the card and persist the winning plan.

The record lands in the store (``--dir`` / ``DL4J_TPU_TUNE_DIR``) under
the (model fingerprint, mesh, backend, runtime) key, where a later
process's ``fit(tune="auto")`` / ``warmup(tuned=True)`` / registry load
picks it up. With the compile cache's disk tier configured
(``--cache-dir`` / ``DL4J_TPU_COMPILE_CACHE_DIR``) every signature the
search captures enters the model's manifest, so a tuned fresh process
captures them before its first batch. ``--device cpu`` runs on the CPU;
``--cost CHIP`` prunes candidates the cost model predicts dominated.
"""

from __future__ import annotations

import argparse
import json
import sys


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch.tune",
        description="Autotune a zoo model over the optimization seams")
    p.add_argument("model", help="zoo architecture, case-insensitive "
                                 "(e.g. resnet50, tinyyolo, simplecnn)")
    p.add_argument("--budget", type=int, default=20,
                   help="max timing trials, baseline included")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--hw", type=int, default=None,
                   help="input H=W (default: the architecture's native "
                        "size)")
    p.add_argument("--classes", type=int, default=None,
                   help="output classes (default: architecture default)")
    p.add_argument("--reps", type=int, default=3,
                   help="timing reps per full-fidelity trial (min wins)")
    p.add_argument("--steps", type=int, default=8,
                   help="~update steps measured per rep")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", default=None,
                   help="mesh label keying the record (a plan tuned on "
                        "one mesh never auto-applies to another)")
    p.add_argument("--parity-steps", type=int, default=6,
                   help="loss-parity gate steps on the winner")
    p.add_argument("--dir", default=None,
                   help="tuning-record directory (default: "
                        "$DL4J_TPU_TUNE_DIR or the user cache)")
    p.add_argument("--cache-dir", default=None,
                   help="the compile cache's disk tier (every captured "
                        "signature enters the model's manifest)")
    p.add_argument("--peak-tflops", type=float, default=None,
                   help="peak FLOP/s (in TFLOP/s) for the MFU estimate "
                        "(default: the H100's dense bf16 989)")
    p.add_argument("--max-k", type=int, default=16,
                   help="cap the steps_per_dispatch axis")
    p.add_argument("--cost", default=None,
                   help="chip name for the cost model's static pruning "
                        "(e.g. h100-sxm)")
    p.add_argument("--device", default=None,
                   help="device to tune on (default: cuda)")
    p.add_argument("--device-timing", action="store_true",
                   help="measure per-layer device time first and seed "
                        "the refinement order from the top offenders")
    p.add_argument("--no-parity", action="store_true",
                   help="skip the loss-parity gate (NOT recommended)")
    p.add_argument("--no-persist", action="store_true",
                   help="search only — do not write a tuning record")
    p.add_argument("--json", action="store_true",
                   help="machine-readable result on stdout")
    return p


def _resolve_model(name: str):
    from deeplearning4j_tpu_torch.models.zoo import ZOO_MODELS
    want = name.replace("_", "").replace("-", "").lower()
    for reg_name, cls in ZOO_MODELS.items():
        if reg_name.lower() == want:
            return reg_name, cls
    raise SystemExit(f"unknown zoo model {name!r}; choose from: "
                     + ", ".join(sorted(ZOO_MODELS)))


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    reg_name, cls = _resolve_model(args.model)

    from deeplearning4j_tpu_torch.nn import compilecache as _cc
    from deeplearning4j_tpu_torch.tune import driver, records
    if args.dir is not None:
        records.configure(args.dir)
    if args.cache_dir is not None:
        _cc.configure(args.cache_dir)

    import numpy as np
    zoo_kw = {"seed": 11}
    if args.classes is not None:
        zoo_kw["num_classes"] = args.classes
    if args.hw is not None:
        zoo_kw["input_shape"] = (3, args.hw, args.hw)

    def factory():
        return cls(**zoo_kw).init(device=args.device)

    probe = factory()
    c, h, w = cls(**zoo_kw).input_shape
    rng = np.random.RandomState(args.seed)
    features = rng.randn(args.batch, c, h, w).astype(np.float32)
    out = probe.output(features[:1])
    if isinstance(out, (list, tuple)):
        out = out[0]
    if getattr(out, "ndim", 0) == 2:        # classifier: one-hot labels
        n = out.shape[1]
        labels = np.eye(n, dtype=np.float32)[rng.randint(0, n, args.batch)]
    else:                                   # detection grid: the empty one
        labels = np.zeros((args.batch,) + tuple(out.shape[1:]), np.float32)
    del probe, out

    timings = None
    if args.device_timing:
        from deeplearning4j_tpu_torch.profiler import devicetime as _dt
        try:
            timings = _dt.measure(factory(), features, reps=2)
        except Exception as e:
            print(f"device timing unavailable ({type(e).__name__}: {e}); "
                  f"refinement uses the canonical axis order",
                  file=sys.stderr)

    from deeplearning4j_tpu_torch.tune.space import TuningSpace
    space = TuningSpace.for_model(max_steps_per_dispatch=args.max_k)
    result = driver.tune(
        factory, features, labels, budget=args.budget, reps=args.reps,
        base_steps=args.steps, seed=args.seed, space=space,
        mesh=args.mesh, model_name=reg_name,
        persist=not args.no_persist, parity_guard=not args.no_parity,
        parity_steps=args.parity_steps, timings=timings,
        peak_flops=args.peak_tflops * 1e12 if args.peak_tflops else None,
        cost_spec=args.cost)

    if args.json:
        payload = {
            "model": reg_name,
            "best_plan": result.best_plan.to_config(),
            "signature": result.best_plan.signature(),
            "best_ms_per_step": result.best_cost_s * 1e3,
            "default_ms_per_step": result.default_cost_s * 1e3,
            "speedup": result.speedup,
            "mfu": result.mfu,
            "trials": len(result.trials),
            "trial_log": [{"phase": t.phase,
                           "signature": t.plan.signature(),
                           "ms_per_step": t.cost_s * 1e3 if t.ok
                           else None, "error": t.error}
                          for t in result.trials],
            "rejected": [[p.signature(), r] for p, r in result.rejected],
            "pruned": [[p.signature(), r] for p, r in result.pruned],
            "parity": None if args.no_parity else not any(
                p == result.best_plan for p, _ in result.rejected),
            "persisted": result.record is not None,
            "record_dir": records.record_dir(),
        }
        print(json.dumps(payload, indent=2, sort_keys=True))
    else:
        print(result.summary())
        if not args.no_parity:
            print(f"parity: winner {result.best_plan.signature()} within "
                  f"{driver.PARITY_TOL:.0%} of the default plan's loss "
                  f"curve; {len(result.rejected)} candidate(s) rejected")
        if result.record is not None:
            print(f"record persisted for {reg_name} "
                  f"(mesh={records.mesh_signature(args.mesh)}) in "
                  f"{records.record_dir()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
