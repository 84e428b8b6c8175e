"""The autotuner search driver — the port of
``deeplearning4j_tpu/tune/driver.py``.

Search shape, per the TVM loop: a cheap EXPLORE pass (seeded random
sample, 1 timing rep each), a SUCCESSIVE-HALVING pass (the top half
re-measured at full min-of-reps fidelity), then a GREEDY REFINEMENT walk
(single-axis mutations of the incumbent, axis order seeded by
``DeviceTimeTable.top_offenders`` so conv-dominated profiles try the
layout/fusion seams first). Every trial captures the candidate's step as
a CUDA graph before it times the public ``fit``, whose steps replay it
through ``CachedDispatch``, as the JAX trials time a compiled step; with
the compile cache's disk tier configured its signatures enter the model's
manifest.

The winner is gated by a LOSS-PARITY guard (same-seed loss curves,
deltas bounded at 10% of the curve's scale) before it is persisted or
left applied — a tuned plan never silently changes numerics; a candidate
that fails parity is discarded and the next-best one is gated instead,
down to the default plan. A plan that fails to apply or to run is a
failed trial (``Trial.ok`` False), never a skipped one.
"""

from __future__ import annotations

import math
import time
import warnings
from typing import Callable, Dict, List, Optional

from deeplearning4j_tpu_torch import profiler as _prof
from deeplearning4j_tpu_torch.profiler import metrics as _metrics
from deeplearning4j_tpu_torch.profiler.locks import InstrumentedLock
from deeplearning4j_tpu_torch.utils.concurrent import ErrorLatch
from deeplearning4j_tpu_torch.tune import records as _records
from deeplearning4j_tpu_torch.tune.space import (TuningPlan, TuningSpace,
                                                 axis_priority)

_REG = _metrics.get_registry()
TRIALS_TOTAL = _REG.counter(
    "dl4j_tune_trials_total",
    "Autotuner trials evaluated (one timing measurement per increment)",
    ("model",))
BEST_MFU = _REG.gauge(
    "dl4j_tune_best_mfu",
    "Best model FLOPs utilization found by the autotuner for a model",
    ("model",))

#: Default parity bound: per-step loss deltas under 10% of the curve's
#: scale count as "same training".
PARITY_TOL = 0.10


class Trial:
    """One timing measurement of one plan."""

    def __init__(self, plan: TuningPlan, cost_s: float, phase: str,
                 reps: int, error: Optional[str] = None):
        self.plan = plan
        self.cost_s = float(cost_s)
        self.phase = phase                 # default|explore|halving|refine
        self.reps = int(reps)
        self.error = error

    @property
    def ok(self) -> bool:
        return self.error is None and math.isfinite(self.cost_s)

    def __repr__(self):
        c = f"{self.cost_s * 1e3:.2f}ms" if self.ok else "FAILED"
        return f"Trial({self.phase}, {self.plan.signature()}, {c})"


class TuneResult:
    """What a tuning run produced: the gated winner, the baseline, the
    full trial log, and the persisted record (if any)."""

    def __init__(self, best_plan: TuningPlan, best_cost_s: float,
                 default_cost_s: float, trials: List[Trial],
                 record=None, model_fp: str = "",
                 rejected: Optional[List[tuple]] = None,
                 mfu: Optional[float] = None,
                 pruned: Optional[List[tuple]] = None):
        self.best_plan = best_plan
        self.best_cost_s = float(best_cost_s)
        self.default_cost_s = float(default_cost_s)
        self.trials = trials
        self.record = record
        self.model_fp = model_fp
        self.rejected = rejected or []     # [(plan, reason)]
        self.mfu = mfu
        self.pruned = pruned or []         # [(plan, reason)] — never measured

    @property
    def speedup(self) -> float:
        if self.best_cost_s <= 0:
            return 1.0
        return self.default_cost_s / self.best_cost_s

    def summary(self) -> str:
        lines = [f"{'phase':8} {'ms/step':>9}  plan"]
        for t in self.trials:
            c = f"{t.cost_s * 1e3:9.2f}" if t.ok else "   FAILED"
            lines.append(f"{t.phase:8} {c}  {t.plan.signature()}")
        lines.append(
            f"best: {self.best_plan.signature()}  "
            f"{self.best_cost_s * 1e3:.2f} ms/step "
            f"(default {self.default_cost_s * 1e3:.2f} ms/step, "
            f"{self.speedup:.2f}x)")
        for plan, reason in self.rejected:
            lines.append(f"rejected: {plan.signature()} — {reason}")
        if self.pruned:
            lines.append(f"statically pruned (cost model, no measurement "
                         f"spent): {len(self.pruned)} candidate(s)")
            for plan, reason in self.pruned:
                lines.append(f"pruned: {plan.signature()} — {reason}")
        return "\n".join(lines)


# ------------------------------------------------------------ measurement
def _on_card(model) -> bool:
    import torch
    dev = getattr(model, "_device", None)
    return dev is not None and torch.device(dev).type == "cuda"


def _sync(model):
    """Block until the model's card work drains — the timing fence (a
    no-op on the CPU)."""
    import torch
    if _on_card(model):
        torch.cuda.synchronize(model._device)


def _release_dropped(model):
    """Free what earlier trials captured before this one captures: the
    graphs of the steps a plan's seams dropped (a network and its
    dispatches can form a reference cycle) and the allocator's cached
    blocks, which a new graph's private pool cannot reuse."""
    import gc

    import torch
    gc.collect()
    if _on_card(model):
        torch.cuda.empty_cache()


def _measure_plan(model, plan: TuningPlan, features, labels, *,
                  reps: int, base_steps: int) -> float:
    """Min-of-reps per-step seconds for ``plan`` applied to ``model``.

    The plan's step is captured first (``compilecache.warmup``), so every
    trial times a replayed graph whatever its K and whether or not the
    disk tier is configured: a K=1 dispatch is otherwise eager until it is
    warmed. A step that fails to capture fails the trial: it is never
    timed eagerly. Then one unmeasured warm pass, and ``reps`` timed
    passes of ``k * m ~= base_steps`` real update steps through the public
    ``fit`` — megastep replay, prefetcher and host bookkeeping included,
    because those are what the K and prefetch axes trade against."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.nn import compilecache as _cc
    kw = plan.apply(model)
    k = kw["steps_per_dispatch"]
    m = max(1, int(round(base_steps / k)) or 1)
    n_steps = k * m
    batches = [DataSet(features, labels) for _ in range(n_steps)]
    fit_kw = dict(steps_per_dispatch=k, prefetch=kw["prefetch"])
    if hasattr(model, "_warm_dispatch"):
        _release_dropped(model)
        _cc.warmup(model, [(tuple(features.shape), tuple(labels.shape))],
                   steps_per_dispatch=k,
                   dtype=_cc._dtype_name(features.dtype),
                   label_dtype=_cc._dtype_name(labels.dtype))
    model.fit(batches, **fit_kw)           # warm (uncounted)
    _sync(model)
    if hasattr(model, "_step_for"):
        d = model._step_for(False, k)
        if d.captures() > d.warmed_signatures() or (
                _on_card(model) and not d.warmed_signatures()):
            raise RuntimeError(
                f"the step of plan {plan.signature()} was not captured; a "
                "trial times a captured step")
    best = math.inf
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        model.fit(batches, **fit_kw)
        _sync(model)
        best = min(best, (time.perf_counter() - t0) / n_steps)
    return best


def estimate_mfu(model, batch: int, cost_s: float,
                 peak_flops: Optional[float] = None,
                 train_factor: float = 3.0) -> Optional[float]:
    """Model FLOPs utilization of one tuned step from the FLOP model of
    ``profiler.devicetime`` (forward FLOPs x ~3 for the update step),
    against the card's dense bf16 peak (``analysis.chipspec``'s
    ``h100-sxm``, 989 TFLOP/s) unless ``peak_flops`` is given."""
    from deeplearning4j_tpu_torch.analysis.chipspec import ChipSpec
    from deeplearning4j_tpu_torch.profiler import devicetime as _dt
    try:
        flops = sum(f for _, _, f in _dt.layer_flop_model(model.conf))
    except Exception:
        return None
    if not flops or cost_s <= 0:
        return None
    peak = peak_flops if peak_flops else ChipSpec.coerce("h100-sxm") \
        .peak_flops
    return (flops * int(batch) * train_factor) / (cost_s * peak)


# ------------------------------------------------------------ parity guard
def loss_parity(factory: Callable[[], object], plan: TuningPlan,
                features, labels, *, steps: int = 6,
                tol: float = PARITY_TOL) -> bool:
    """Same-seed loss curves, default plan vs ``plan``, per-step deltas
    bounded at ``tol`` of the curve's own scale.  ``factory`` must
    return a fresh, deterministically-seeded network each call."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    ds = DataSet(features, labels)

    def curve(tuned: bool) -> List[float]:
        net = factory()
        if tuned:
            plan.apply(net)
        losses = []
        for _ in range(steps):
            net.fit(ds)
            losses.append(float(net.score()))
        return losses

    la, lb = curve(False), curve(True)
    scale = max(abs(la[0]), 1e-6)
    return max(abs(a - b) / scale for a, b in zip(la, lb)) < tol


# ------------------------------------------------------------------ search
def tune(model_or_factory, features, labels, *, budget: int = 20,
         reps: int = 3, base_steps: int = 8, seed: int = 0,
         space: Optional[TuningSpace] = None, mesh=None,
         backend: Optional[str] = None, model_name: Optional[str] = None,
         persist: bool = True, parity_guard: bool = True,
         parity_steps: int = 6, parity_tol: float = PARITY_TOL,
         timings=None, peak_flops: Optional[float] = None,
         trial_fn: Optional[Callable[[TuningPlan], float]] = None,
         parity_fn: Optional[Callable[[TuningPlan], bool]] = None,
         cost_spec=None, pruner=None, prune_bound: float = 3.0
         ) -> TuneResult:
    """Search ``space`` for the fastest plan on live hardware.

    ``model_or_factory``: a zero-arg callable returning a fresh,
    deterministically-seeded network (enables the parity guard), or a
    live network instance (parity is skipped with a warning — there is
    no way to rebuild the untuned twin).  ``budget`` caps the number of
    timing measurements, baseline included.  ``timings`` (a
    ``DeviceTimeTable``) seeds the refinement axis order from measured
    top offenders.  ``trial_fn``/``parity_fn`` replace the real
    measurement / parity check — the mock-cost harness used by the
    planted-optimum tests, and the seam a future learned cost model
    plugs into.

    ``cost_spec`` (a :class:`~deeplearning4j_tpu_torch.analysis.cost.CostSpec`,
    chip name, or dict) turns on STATIC PRUNING: before any non-default
    candidate is measured, the analysis.cost model predicts its step
    peak and step time — a candidate that OOMs the declared chip or
    predicts slower than ``prune_bound`` x the default plan's prediction
    is dropped without spending a measurement, recorded on
    ``TuneResult.pruned`` with the reason.  ``pruner`` overrides the
    auto-built one (any ``plan -> Optional[reason]`` callable).  The
    incumbent default plan is never offered for pruning.

    The model the search measured is left with the WINNING plan applied.
    The winner is persisted to the record store (``persist=True``) under
    the (model fingerprint, mesh, backend, runtime) key, where
    ``fit(tune="auto")`` / ``warmup(tuned=True)`` / the serving registry
    will find it.
    """
    factory = model_or_factory if callable(model_or_factory) else None
    model = factory() if factory is not None else model_or_factory
    if space is None:
        space = TuningSpace.for_model(model)
    budget = max(2, int(budget))
    label = model_name or type(model).__name__
    trials_counter = TRIALS_TOTAL.labels(model=label)

    book: Dict[str, Trial] = {}    # plan signature -> best trial so far
    log: List[Trial] = []
    book_lock = InstrumentedLock("tune:driver")
    latch = ErrorLatch()
    spent = [0]                    # measurements consumed against budget

    default = space.default_plan()
    pruned: List[tuple] = []       # [(plan, reason)] — dropped unmeasured
    pruned_sigs: set = set()
    if pruner is None and cost_spec is not None:
        from deeplearning4j_tpu_torch.analysis import cost as _cost
        try:
            pruner = _cost.plan_pruner(model, None if features is None
                                       else getattr(features, "shape",
                                                    (None,))[0],
                                       cost_spec, mesh=mesh,
                                       bound=prune_bound)
        except Exception as e:     # an unlowerable harness object: search
            warnings.warn(         # without pruning rather than die
                f"tune: static pruning disabled — the cost model cannot "
                f"lower this model ({type(e).__name__}: {e})",
                stacklevel=2)
            pruner = None

    def evaluate(plan: TuningPlan, phase: str, n_reps: int
                 ) -> Optional[Trial]:
        sig = plan.signature()
        with book_lock:
            prev = book.get(sig)
            if prev is not None and prev.reps >= n_reps:
                return prev        # already measured at >= this fidelity
        # static domination check — BEFORE the measurement is spent; the
        # default plan (the yardstick) is never offered for pruning
        if pruner is not None and plan != default:
            with book_lock:
                if sig in pruned_sigs:
                    return None
            try:
                reason = pruner(plan)
            except Exception:      # a pruner bug must not cost coverage
                reason = None
            if reason is not None:
                with book_lock:
                    pruned_sigs.add(sig)
                    pruned.append((plan, reason))
                return None
        spent[0] += 1
        trials_counter.inc()
        try:
            with _prof.trace_span("tune:trial", plan=sig, phase=phase):
                if trial_fn is not None:
                    cost = float(trial_fn(plan))
                else:
                    cost = _measure_plan(model, plan, features, labels,
                                         reps=n_reps,
                                         base_steps=base_steps)
            t = Trial(plan, cost, phase, n_reps)
        except Exception as e:  # one broken candidate must not kill the run
            latch.record(e)
            t = Trial(plan, math.inf, phase, n_reps,
                      error=f"{type(e).__name__}: {e}")
        with book_lock:
            log.append(t)
            if t.ok and (sig not in book or t.cost_s < book[sig].cost_s
                         or t.reps > book[sig].reps):
                book[sig] = t
        return t if t.ok else None

    # ---- baseline: the default plan is trial #0 and the yardstick
    base = evaluate(default, "default", reps)
    if base is None:
        # the DEFAULT plan failing is not a tuning result — re-raise
        err = latch.take()
        raise RuntimeError("autotuner baseline trial failed") from err
    default_cost = base.cost_s

    # ---- explore: seeded random sample at 1-rep fidelity
    explore_n = min(space.size - 1, max(1, (budget - spent[0]) * 2 // 3))
    sampled = [p for p in space.sample(explore_n + 1, seed)
               if p != default][:explore_n]
    for plan in sampled:
        if spent[0] >= budget:
            break
        evaluate(plan, "explore", 1)

    # ---- successive halving: survivors re-measured at full fidelity
    with book_lock:
        ranked = sorted((t for t in book.values() if t.plan != default),
                        key=lambda t: t.cost_s)
    for t in ranked[:max(1, math.ceil(len(ranked) / 2))]:
        if spent[0] >= budget:
            break
        evaluate(t.plan, "halving", reps)

    # ---- greedy refinement around the incumbent, offender-seeded order
    order = axis_priority(timings)

    def incumbent() -> Trial:
        with book_lock:
            return min(book.values(), key=lambda t: t.cost_s)

    improved = True
    while improved and spent[0] < budget:
        improved = False
        cur = incumbent()
        for _axis, nb in space.neighbors(cur.plan, order):
            if spent[0] >= budget:
                break
            with book_lock:
                seen = nb.signature() in book
            if seen:
                continue
            t = evaluate(nb, "refine", reps)
            if t is not None and t.cost_s < cur.cost_s:
                improved = True
                break              # re-anchor the walk on the new best

    # ---- parity gate, best-first, falling back toward the default
    with book_lock:
        candidates = sorted(book.values(), key=lambda t: t.cost_s)
    rejected: List[tuple] = []
    check = parity_fn
    if check is None and parity_guard:
        if factory is not None:
            check = lambda p: loss_parity(factory, p, features, labels,
                                          steps=parity_steps,
                                          tol=parity_tol)
        else:
            warnings.warn(
                "tune: parity guard skipped — pass a model FACTORY "
                "(not a live instance) so the default-plan twin can be "
                "rebuilt for the same-seed loss comparison", stacklevel=2)
    winner = base
    for t in candidates:
        if t.plan == default:
            winner = t
            break                  # the default trivially passes parity
        if check is not None and not check(t.plan):
            rejected.append((t.plan, "loss parity failed — plan changes "
                                     "numerics beyond the "
                                     f"{parity_tol:.0%} bound"))
            continue
        winner = t
        break

    # leave the measured model in the winning state (the search walked
    # it through arbitrary plans)
    if trial_fn is None:
        winner.plan.apply(model)

    mfu = None
    if features is not None and getattr(features, "shape", None):
        mfu = estimate_mfu(model, features.shape[0], winner.cost_s,
                           peak_flops=peak_flops)
        if mfu is not None:
            BEST_MFU.labels(model=label).set(mfu)

    record = None
    try:
        fp = _records.model_fingerprint(model)
    except Exception:
        fp = ""        # a trial_fn harness may tune a non-network object
    if persist and not fp:
        persist = False
        warnings.warn("tune: model has no config fingerprint — winner "
                      "not persisted", stacklevel=2)
    if persist:
        record = _records.TuningRecord(
            fp, winner.plan, cost_s=winner.cost_s,
            default_cost_s=default_cost, mfu=mfu, trials=spent[0],
            mesh=mesh, backend=backend, model_name=label)
        if _records.put(record) is None:
            record = None
    return TuneResult(winner.plan, winner.cost_s, default_cost, log,
                      record=record, model_fp=fp, rejected=rejected,
                      mfu=mfu, pruned=pruned)


#: The tuning report type the serving/bench surfaces name — the search
#: result IS the report (trials, rejections, static prunes, summary()).
TuningReport = TuneResult
