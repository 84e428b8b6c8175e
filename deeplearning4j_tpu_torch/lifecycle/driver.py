"""The lifecycle driver: continuous training as a service.

:class:`LifecycleDriver` closes the loop the rest of the stack left
open — the trainer (fit with async checkpoints, or a captured step) and
the serving registry already coexist on one card; this is the state
machine that moves candidates between them, round after round::

    train -> gate -> load -> canary -> observe -> promote -> confirm
                |                 \\                            |
                +-> quarantine     +-> abort_canary            +-> rollback

Every phase transition persists through a
:class:`~deeplearning4j_tpu_torch.train.resilience.DriverStateStore` (atomic
+ checksummed + quarantining), so a SIGKILL anywhere in the loop —
including mid-roll, the chaos-pinned case — leaves a successor driver
knowing exactly what was in flight: it aborts the stale canary (the
registry stays consistent at the incumbent throughout; abort is
idempotent), re-attempts the interrupted round's candidate, and
continues. The serving side never drops a request across any of this:
requests are owned by the server that admitted them (exactly-once
resolution), and both canary begin/abort and roll/rollback are pointer
swaps under the registry lock.

The failure ladder, cheapest exit first:

1. **gate** — a candidate with non-finite outputs or a regressed
   scorecard vs the serving incumbent is quarantined with a structured
   reason; it is NEVER ``load()``-ed (zero serving-side cost).
2. **canary observe** — the candidate takes a deterministic traffic
   fraction; the judge watches p99/shed/breaker via
   ``registry.load_hints()`` and burn rates via
   ``SLOEngine.burn_over(window)`` for ``observe_ticks``; unhealthy ->
   ``abort_canary`` (incumbent never stopped serving the rest).
3. **post-promote confirm** — the judge keeps watching for
   ``confirm_ticks`` after the roll; an SLO regression here ->
   automatic ``rollback()``, bit-identical to the pre-roll incumbent
   (the old server is still loaded and warmed).

Chaos seams (:class:`~deeplearning4j_tpu_torch.faults.FaultPlan`):
``bad_candidate_at`` poisons a round's candidate (NaN outputs or a
deterministic regression — the GATE does the rejecting),
``trainer_death_at_roll`` SIGKILLs the trainer subprocess mid-roll and
kills the driver loop (the resume path does the recovering), and
``slo_regression_during_canary`` induces a genuine judge failure in the
confirm window (the ROLLBACK path does the restoring).

The state machine, the persisted keys, the metrics and the recovery are
the JAX package's; a state file written by either package resumes in
the other. The driver holds no device logic: it drives whatever the
registry serves. Two things are the port's own:

- the eval rows go to the registry's device in the serving input dtype
  once, and the gate and :class:`_PoisonedCandidate` keep the outputs
  there (only scalars reach the host);
- a trainer whose step updates its parameters in place (a captured
  step) must hand over a *snapshot* (copies of its parameters): the
  registry serves the candidate object itself, so a live model would
  change under the served version and a rollback would no longer be
  bit-identical.

Each phase records one span (``lifecycle:train``, ``gate``, ``load``,
``canary``, ``roll``, ``confirm``) under the driver's trace while
tracing is on.
"""

from __future__ import annotations

import os
import signal as _signal
import subprocess
import sys
import time
from typing import Callable, Optional

import logging

import numpy as np
import torch

from deeplearning4j_tpu_torch import profiler as _prof
from deeplearning4j_tpu_torch.profiler import flightrec as _flightrec
from deeplearning4j_tpu_torch.profiler import tracecontext as _tracectx
from deeplearning4j_tpu_torch.train.resilience import DriverStateStore

from .capture import TrafficCapture
from .gate import EvalGate, GateVerdict, as_tensor

logger = logging.getLogger("deeplearning4j_tpu_torch")

_REG = _prof.get_registry()
ROUNDS = _REG.counter(
    "dl4j_lifecycle_rounds_total",
    "Lifecycle rounds completed, by how the round ended",
    labelnames=("outcome",))
PROMOTIONS = _REG.counter(
    "dl4j_lifecycle_promotions_total",
    "Candidates promoted to the active route after a clean confirm")
LC_ROLLBACKS = _REG.counter(
    "dl4j_lifecycle_rollbacks_total",
    "Automatic rollbacks on post-promote SLO regression")
QUARANTINES = _REG.counter(
    "dl4j_lifecycle_quarantines_total",
    "Candidates quarantined, by structured reason",
    labelnames=("reason",))
GATE_SECONDS = _REG.histogram(
    "dl4j_lifecycle_gate_seconds",
    "Wall time of one eval-gate evaluation")
ROLL_SECONDS = _REG.histogram(
    "dl4j_lifecycle_roll_seconds",
    "Wall time of one promote (registry roll) in the lifecycle loop")
TRAINER_DEATHS = _REG.counter(
    "dl4j_lifecycle_trainer_deaths_total",
    "Trainer processes killed at the trainer_death_at_roll chaos seam")
LC_RESUMES = _REG.counter(
    "dl4j_lifecycle_resumes_total",
    "Driver starts that resumed an interrupted round from persisted "
    "state")


class TrainerKilledError(RuntimeError):
    """The trainer process died (chaos seam: SIGKILL mid-roll). The
    driver's state machine was persisted BEFORE the death — construct a
    new driver over the same ``state_dir`` and ``run()`` resumes the
    interrupted round."""

    def __init__(self, round_index: int, roll_index: int):
        self.round_index = round_index
        self.roll_index = roll_index
        super().__init__(
            f"trainer killed mid-roll (round {round_index}, roll "
            f"{roll_index}) — resume by running a new driver over the "
            "same state_dir")


def spawn_trainer_process() -> subprocess.Popen:
    """A stand-in trainer subprocess for chaos tests: a sleep loop with
    no heavy imports, cheap to spawn and SIGKILL-able. A real
    deployment passes its actual training job's handle as
    ``trainer_process`` instead."""
    return subprocess.Popen(
        [sys.executable, "-c",
         "import time\nwhile True: time.sleep(3600)"],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


class _PoisonedCandidate:
    """Wrap a candidate model per the ``bad_candidate_at`` chaos kinds:
    ``"nan"`` makes every output NaN (the gate's finiteness check must
    reject it); ``"regressed"`` adds a constant offset (a genuine,
    deterministic scorecard/parity regression the gate must catch).
    Callable, so it composes with ``resolve_forward`` everywhere; the
    outputs stay on the model's device."""

    def __init__(self, model, kind: str):
        from deeplearning4j_tpu_torch.serving.server import resolve_forward
        self.model = model
        self.kind = kind
        self._fwd = resolve_forward(model)

    def __call__(self, x):
        out = as_tensor(self._fwd(x))
        if self.kind == "nan":
            return torch.full_like(out, float("nan"))
        return out + 1.0


class LifecycleDriver:
    """Drive continuous train -> gate -> canary -> promote/rollback
    rounds against a :class:`~deeplearning4j_tpu_torch.serving.registry.
    ModelRegistry` (module doc for the state machine).

    Parameters
    ----------
    registry : the serving registry (trainer and registry share one
        card — the zero-recapture pin holds across the whole loop).
    name : the model name the driver owns in the registry.
    trainer : ``trainer(round_index) -> candidate model`` — typically a
        closure over ``fit()`` (or a captured step) that returns the
        round's candidate: a snapshot, never the live trained model.
    state_dir : where the driver checkpoints its own state machine.
    eval_x / eval_y : held-out eval set for the gate. When ``eval_x``
        is None the driver reads the live-traffic capture at
        ``capture_path`` instead (production inputs as eval set).
    gate : an :class:`EvalGate` (default: one with default policy).
    canary_fraction : traffic fraction the canary takes while
        observing.
    observe_ticks / confirm_ticks : judge evaluations before promote /
        after promote; ``tick_interval`` seconds between them.
    observation_window : lookback (seconds) for
        ``SLOEngine.burn_over`` at each tick.
    slo_engine : optional :class:`~deeplearning4j_tpu_torch.profiler.
        slo.SLOEngine` consulted by the default judge.
    judge : ``judge(hints, burns, induced) -> bool`` overriding the
        default health check (truthy = healthy).
    max_shed_rate : default judge's ceiling on the model's shed rate.
    faults : a :class:`~deeplearning4j_tpu_torch.faults.FaultPlan` wiring the
        lifecycle chaos seams.
    shapes / load_kw : forwarded to ``registry.load`` for candidates.
    trainer_process : a live trainer process handle (``.pid``); the
        ``trainer_death_at_roll`` seam SIGKILLs it.
    """

    def __init__(self, registry, name: str, trainer: Callable,
                 state_dir: str, eval_x=None, eval_y=None,
                 capture_path: Optional[str] = None,
                 gate: Optional[EvalGate] = None,
                 canary_fraction: float = 0.25,
                 observe_ticks: int = 2, confirm_ticks: int = 2,
                 tick_interval: float = 0.0,
                 observation_window: float = 5.0,
                 slo_engine=None, judge: Optional[Callable] = None,
                 max_shed_rate: float = 0.5,
                 faults=None, shapes=None, load_kw: Optional[dict] = None,
                 trainer_process=None):
        self.registry = registry
        self.name = name
        self.trainer = trainer
        self.eval_x = eval_x
        self.eval_y = eval_y
        self.capture_path = capture_path
        self.gate = gate or EvalGate()
        self.canary_fraction = float(canary_fraction)
        self.observe_ticks = int(observe_ticks)
        self.confirm_ticks = int(confirm_ticks)
        self.tick_interval = float(tick_interval)
        self.observation_window = float(observation_window)
        self.slo_engine = slo_engine
        self.judge = judge
        self.max_shed_rate = float(max_shed_rate)
        self.faults = faults
        self.shapes = shapes
        self.load_kw = dict(load_kw or {})
        self.trainer_process = trainer_process
        self.store = DriverStateStore(state_dir)
        self._trace = _tracectx.TraceContext.new()
        self._state = self.store.load()
        self.resumed = False
        if self._state is None:
            self._state = {"round": 0, "phase": "idle", "in_round": None,
                           "roll_index": 0, "incumbent": None,
                           "candidate_version": None, "quarantined": [],
                           "promotions": 0, "rollbacks": 0}
            self.store.save(self._state)
        elif self._state.get("in_round") is not None:
            self.resumed = True

    # --------------------------------------------------------- state I/O
    def _persist(self, phase: Optional[str] = None, **updates) -> None:
        if phase is not None:
            self._state["phase"] = phase
        self._state.update(updates)
        self.store.save(self._state)

    @property
    def incumbent_version(self) -> Optional[int]:
        return self._state["incumbent"]

    @property
    def quarantined(self) -> list:
        return list(self._state["quarantined"])

    @property
    def promotions(self) -> int:
        return self._state["promotions"]

    @property
    def rollbacks(self) -> int:
        return self._state["rollbacks"]

    # ------------------------------------------------------------- spans
    def _span(self, which: str, t0_us: int, **args) -> None:
        _tracectx.record_span(
            f"lifecycle:{which}", self._trace.child(), t0_us,
            _prof.now_us() - t0_us, args=dict(args, model=self.name))

    # -------------------------------------------------------------- run
    def run(self, rounds: int) -> dict:
        """Execute rounds until ``state["round"] == rounds`` (so a
        resumed driver finishes the SAME total, never extra). Returns a
        summary dict. Raises :class:`TrainerKilledError` at the
        trainer-death chaos seam AFTER persisting — rerun to resume."""
        if self.resumed:
            self._recover()
        while self._state["round"] < rounds:
            r = self._state["round"] + 1
            self._run_round(r)
        summary = {"rounds": self._state["round"],
                   "incumbent": self._state["incumbent"],
                   "promotions": self._state["promotions"],
                   "rollbacks": self._state["rollbacks"],
                   "quarantined": self.quarantined}
        self._persist(phase="idle")
        return summary

    def _recover(self) -> None:
        """Pick up an interrupted round: the registry is left consistent
        (abort any stale canary — idempotent), then the interrupted
        candidate re-enters at the canary phase; an interruption before
        ``load`` just replays the round from ``train``."""
        st = self._state
        LC_RESUMES.inc()
        aborted = self.registry.abort_canary(self.name)
        _flightrec.get_flight_recorder().record(
            "lifecycle:resume", model=self.name,
            round=st["in_round"], phase=st["phase"],
            aborted_canary=aborted)
        logger.info("lifecycle: resumed %s at round %s phase %s "
                    "(aborted canary: %s)", self.name, st["in_round"],
                    st["phase"], aborted)
        r = st["in_round"]
        self.resumed = False
        if r is None:
            return
        if st["phase"] in ("canary", "observe", "promote", "confirm") \
                and st["candidate_version"] is not None:
            # the candidate is already loaded and warmed: re-attempt
            # its canary rather than retraining
            self._canary_and_promote(r, st["candidate_version"])
        else:
            # died before load: replay the round from train
            self._run_round(r)

    def _run_round(self, r: int) -> None:
        self._persist(phase="train", in_round=r, candidate_version=None)
        t0_us = _prof.now_us()
        candidate = self.trainer(r)
        self._span("train", t0_us, round=r)
        kind = self.faults.candidate_fault(r) if self.faults is not None \
            else None
        if kind is not None:
            candidate = _PoisonedCandidate(candidate, kind)
        verdict = self._gate(r, candidate)
        if not verdict:
            self._quarantine(r, None, f"gate:{verdict.reason}",
                             verdict.to_dict())
            self._complete_round(r, "gate_rejected")
            return
        version = self._load(r, candidate)
        if self._state["incumbent"] is None:
            # bootstrap: the first version has nothing to canary against
            self._persist(phase="promote")
            self.registry.roll(self.name, version)
            self._state["promotions"] += 1
            PROMOTIONS.inc()
            self._persist(incumbent=version)
            self._complete_round(r, "promoted")
            return
        self._canary_and_promote(r, version)

    # ------------------------------------------------------------ phases
    def _gate(self, r: int, candidate) -> GateVerdict:
        self._persist(phase="gate")
        eval_x, eval_y = self.eval_x, self.eval_y
        if eval_x is None and self.capture_path is not None:
            eval_x = TrafficCapture.eval_features(self.capture_path)
            eval_y = None
        incumbent = None
        if self._state["incumbent"] is not None:
            incumbent = self.registry.server(
                self.name, self._state["incumbent"]).model
        t0_us = _prof.now_us()
        t0 = time.perf_counter()
        verdict = self.gate.evaluate(candidate, incumbent,
                                     self._eval_rows(eval_x), eval_y)
        GATE_SECONDS.observe(time.perf_counter() - t0)
        self._span("gate", t0_us, round=r, passing=verdict.passing,
                   reason=verdict.reason)
        return verdict

    def _eval_rows(self, eval_x):
        """The eval rows as the served version sees them: on the
        registry's device, in the serving input dtype (float32 unless
        the registry or ``load_kw`` says otherwise)."""
        if eval_x is None or isinstance(eval_x, torch.Tensor):
            return eval_x
        dtype = self.load_kw.get(
            "input_dtype", getattr(self.registry, "_defaults", {}).get(
                "input_dtype", np.float32))
        x = np.ascontiguousarray(np.asarray(eval_x, dtype=dtype))
        return torch.from_numpy(x).to(self.registry.device)

    def _load(self, r: int, candidate) -> int:
        self._persist(phase="load")
        t0_us = _prof.now_us()
        version = self.registry.load(self.name, candidate, roll=False,
                                     shapes=self.shapes, **self.load_kw)
        self._span("load", t0_us, round=r, version=version)
        self._persist(candidate_version=version)
        return version

    def _kill_trainer(self) -> None:
        proc = self.trainer_process
        if proc is None:
            return
        pid = getattr(proc, "pid", None)
        if pid is None:
            return
        try:
            os.kill(pid, _signal.SIGKILL)
        except (OSError, AttributeError):
            pass
        if isinstance(proc, subprocess.Popen):
            try:
                proc.wait(timeout=5.0)
            except Exception:
                pass

    def _canary_and_promote(self, r: int, version: int) -> bool:
        st = self._state
        if st["phase"] not in ("observe", "promote", "confirm"):
            st["roll_index"] += 1
        roll_idx = st["roll_index"]
        if self.registry.active_version(self.name) == version:
            # resumed after the promote already landed: nothing to
            # canary — go straight to the confirm window
            self._persist(phase="confirm", in_round=r,
                          candidate_version=version)
            return self._confirm(r, version, roll_idx)
        self._persist(phase="canary", in_round=r,
                      candidate_version=version)
        t0_us = _prof.now_us()
        if self.registry.canary(self.name) is None:
            self.registry.begin_canary(self.name, version,
                                       fraction=self.canary_fraction)
        self._span("canary", t0_us, round=r, version=version,
                   fraction=self.canary_fraction)
        if self.faults is not None \
                and self.faults.trainer_dies_at_roll(roll_idx):
            # THE mid-roll death: the canary is live, the state machine
            # is persisted — kill the trainer and die. The successor
            # driver aborts the canary (registry consistent at the
            # incumbent) and re-attempts this candidate.
            self._kill_trainer()
            TRAINER_DEATHS.inc()
            _flightrec.get_flight_recorder().record(
                "lifecycle:trainer_death", model=self.name, round=r,
                roll_index=roll_idx)
            raise TrainerKilledError(r, roll_idx)
        self._persist(phase="observe")
        for _tick in range(self.observe_ticks):
            if not self._judge_tick(induced=False):
                self.registry.abort_canary(self.name)
                self._quarantine(r, version, "canary_unhealthy",
                                 {"tick": _tick})
                self._complete_round(r, "canary_aborted")
                return False
            if self.tick_interval:
                time.sleep(self.tick_interval)
        self._persist(phase="promote")
        t0_us = _prof.now_us()
        t0 = time.perf_counter()
        prev = self.registry.roll(self.name, version)
        ROLL_SECONDS.observe(time.perf_counter() - t0)
        self._span("roll", t0_us, round=r, version=version, previous=prev)
        self._persist(phase="confirm")
        return self._confirm(r, version, roll_idx)

    def _confirm(self, r: int, version: int, roll_idx: int) -> bool:
        t0_us = _prof.now_us()
        try:
            return self._confirm_ticks(r, version, roll_idx)
        finally:
            self._span("confirm", t0_us, round=r, version=version)

    def _confirm_ticks(self, r: int, version: int, roll_idx: int) -> bool:
        for _tick in range(self.confirm_ticks):
            induced = (self.faults is not None
                       and self.faults.canary_regression(roll_idx))
            if not self._judge_tick(induced=induced):
                self.registry.rollback(self.name)
                self._state["rollbacks"] += 1
                LC_ROLLBACKS.inc()
                self._quarantine(
                    r, version,
                    "slo_regression" if induced else "confirm_unhealthy",
                    {"tick": _tick, "induced": bool(induced)})
                self._complete_round(r, "rolled_back")
                return False
            if self.tick_interval:
                time.sleep(self.tick_interval)
        self._state["promotions"] += 1
        PROMOTIONS.inc()
        self._persist(incumbent=version)
        self._complete_round(r, "promoted")
        return True

    # ------------------------------------------------------------ judge
    def _judge_tick(self, induced: bool = False) -> bool:
        hints = self.registry.load_hints()
        burns = (self.slo_engine.burn_over(self.observation_window)
                 if self.slo_engine is not None else {})
        if self.judge is not None:
            return bool(self.judge(hints, burns, induced))
        if induced:
            return False
        model = hints["models"].get(self.name, {})
        for h in (model, model.get("canary") or {}):
            if h.get("shed_rate", 0.0) > self.max_shed_rate:
                return False
            if h.get("breaker") == "open":
                return False
        threshold = getattr(self.slo_engine, "threshold", 1.0)
        return all(b <= threshold for b in burns.values())

    # ------------------------------------------------------- bookkeeping
    def _quarantine(self, r: int, version: Optional[int], reason: str,
                    detail: dict) -> None:
        rec = {"round": r, "version": version, "reason": reason,
               "detail": detail}
        self._state["quarantined"].append(rec)
        QUARANTINES.labels(reason=reason).inc()
        _flightrec.get_flight_recorder().record(
            "lifecycle:quarantine", model=self.name, **rec)
        logger.warning("lifecycle: quarantined %s round %d (%s)",
                       self.name, r, reason)

    def _complete_round(self, r: int, outcome: str) -> None:
        ROUNDS.labels(outcome=outcome).inc()
        _flightrec.get_flight_recorder().record(
            "lifecycle:round", model=self.name, round=r, outcome=outcome)
        self._persist(phase="idle", round=r, in_round=None,
                      candidate_version=None)
