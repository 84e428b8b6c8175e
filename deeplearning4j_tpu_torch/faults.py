"""Deterministic fault injection — the port of the training and serving
kinds of ``deeplearning4j_tpu/faults.py``.

Training fault kinds (``fit(..., faults=plan)``, behind the seams of
``train.resilience``); step indices are 1-based update steps, and step k
is the k-th batch pulled, which is the k-th update applied:

- **NaN gradients at step k** (``nan_grads_at``) — the k-th pulled
  batch's features become NaN, so the step's loss and gradients go
  non-finite through the device, as a real blow-up does.
- **Data-pipeline errors at step k** (``data_error_at``) — the iterator
  raises on the k-th pull; marked transient (``TransientDataError``,
  ``data_error_transient``) the retry path must recover it, permanent
  it propagates.
- **Checkpoint write failure / corruption at step k** — the manager's
  write raises ``OSError`` once (the retry must succeed), or the
  finished checkpoint's archive has bytes flipped (resume must
  quarantine it).
- **Preemption at step k** (``preempt_at_step``) — a
  :class:`~deeplearning4j_tpu_torch.train.resilience.StepPreemption`
  that fires once step k has completed, standing in for SIGTERM.
- **A layer's params poisoned at step k** (``nan_layer_params_at``,
  ``{step: layer}``) — NaN written in place into the first float param
  of the layer just before the dispatch that holds step k (at the
  first dispatch boundary at or after k under K steps a dispatch); the
  provenance sanitizer must name that layer (``profiler.sanitizer``).

Serving fault kinds (the model server's degradation paths):

- **Replica fault at serving batch k** (``serve_fail_at``) — the k-th
  dispatched batch's forward raises once, standing in for a transient
  runtime error; the bounded-retry path must recover.
- **Replica loss mid-serve** (``serve_device_loss_at_batch``) — from
  batch k on, any forward touching the planned-dead devices raises.
- **Slow / hung forward** (``slow_replica_at`` / ``hung_dispatch_at``,
  the index meaning *serving batch*): the server's
  :class:`~deeplearning4j_tpu_torch.parallel.elastic.DispatchWatchdog`
  consumes them through the ``dispatch_hold`` seam.
- **Request bursts / deadline storms** — workload-side:
  :class:`ServingLoad` generates seeded arrival schedules (steady /
  burst / deadline-storm mixes).

Wire-level chaos (the HTTP ingress front door):

- **Slow clients** (``slow_frac``) and **mid-flight disconnects**
  (``disconnect_frac``) in :meth:`ServingLoad.replay_http`.
- **Swap under load** — :class:`SwapSchedule` fires seeded
  ``ModelRegistry.roll()``/``rollback()`` calls at planned offsets while
  a replay is in flight: every request must resolve exactly once against
  exactly one version.

Lifecycle fault kinds (the continuous-training loop's chaos pins,
consumed by :class:`~deeplearning4j_tpu_torch.lifecycle.driver.
LifecycleDriver`):

- **Trainer death mid-roll** (``trainer_death_at_roll=k``) — as the
  driver's k-th roll (1-based) is in flight (candidate loaded and
  canarying, not yet promoted), the trainer is killed: a subprocess
  trainer gets a real SIGKILL and the driver unwinds through
  :class:`~deeplearning4j_tpu_torch.lifecycle.driver.TrainerKilledError`.
  The registry keeps serving a consistent version and a new driver over
  the same state dir resumes from its persisted state machine.
- **Bad candidate at round k** (``bad_candidate_at={k: "nan" |
  "regressed"}``) — the k-th round's candidate is poisoned: ``"nan"``
  makes its outputs non-finite, ``"regressed"`` shifts them past the
  gate's parity bound. The eval gate must quarantine it; it is never
  loaded.
- **SLO regression during canary** (``slo_regression_during_canary=k``)
  — the k-th roll's post-promote confirmation reads as an SLO
  regression; the driver must ``rollback()`` (bit-identical to the
  pre-roll incumbent).
- :meth:`FaultPlan.seeded_lifecycle` draws a whole lifecycle plan from
  one seed.

Race kinds (``pytest -m races``):

- **Seeded deterministic interleavings** — :class:`InterleavingHarness`
  runs N thread bodies under a cooperative scheduler: exactly one
  thread executes at a time, and at every traced line/opcode boundary a
  seeded RNG decides whether to context-switch. The schedule is a pure
  function of the seed (the same decisions as the JAX package's harness
  for the same bodies), so a racy interleaving that loses an increment
  reproduces instead of flaking.
- **Preemptive stress** — :func:`preemptive_stress` drops
  ``sys.setswitchinterval`` to microseconds so real thread pools
  (serving, prefetch, async checkpoint writes) interleave far more
  often while a seeded workload hammers them.

Every fault fires exactly once per planned index (so a retried pull or
forward succeeds, like a real transient).

Not ported yet (ROADMAP.md): the multi-device kinds — device loss in
training (``device_loss_at_step``) and the coordinator's peer death
(``coord_peer_death``).
"""

from __future__ import annotations

import contextlib
import os
import random
import sys
import threading
import time
from typing import Callable, Iterable, List, Optional, Sequence, Set

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import (DataSet, DataSetIterator,
                                                   MultiDataSet,
                                                   TransientDataError)


def _as_step_set(steps) -> Set[int]:
    if steps is None:
        return set()
    if isinstance(steps, int):
        return {steps}
    return {int(s) for s in steps}


class FaultPlan:
    """A deterministic schedule of injected faults.

    Parameters name the failure mode and the 1-based update step(s) or
    serving batch index(es) it fires at; each planned (mode, index) fires
    exactly once. Pass the plan to ``fit(..., faults=plan)`` or
    ``ModelServer(..., faults=plan)``.
    """

    def __init__(self, seed: int = 0,
                 nan_grads_at: Iterable[int] = (),
                 data_error_at: Iterable[int] = (),
                 data_error_transient: bool = True,
                 checkpoint_write_fail_at: Iterable[int] = (),
                 checkpoint_corrupt_at: Iterable[int] = (),
                 preempt_at_step: Optional[int] = None,
                 lose_devices: Iterable[int] = (),
                 hung_dispatch_at: Iterable[int] = (),
                 hang_seconds: Optional[float] = 0.2,
                 slow_replica_at: Iterable[int] = (),
                 slow_seconds: float = 0.1,
                 serve_fail_at: Iterable[int] = (),
                 serve_device_loss_at_batch: Optional[int] = None,
                 nan_layer_params_at: Optional[dict] = None,
                 trainer_death_at_roll: Optional[int] = None,
                 bad_candidate_at: Optional[dict] = None,
                 slo_regression_during_canary: Optional[int] = None):
        self.seed = seed
        self.nan_grads_at = _as_step_set(nan_grads_at)
        self.data_error_at = _as_step_set(data_error_at)
        self.data_error_transient = bool(data_error_transient)
        self.checkpoint_write_fail_at = _as_step_set(checkpoint_write_fail_at)
        self.checkpoint_corrupt_at = _as_step_set(checkpoint_corrupt_at)
        self.preempt_at_step = preempt_at_step
        self.lose_devices = frozenset(int(d) for d in lose_devices)
        self.hung_dispatch_at = _as_step_set(hung_dispatch_at)
        self.hang_seconds = hang_seconds
        self.slow_replica_at = _as_step_set(slow_replica_at)
        self.slow_seconds = float(slow_seconds)
        self.serve_fail_at = _as_step_set(serve_fail_at)
        self.serve_device_loss_at_batch = serve_device_loss_at_batch
        #: {step: layer} (an index in a sequential net, a node name in a
        #: graph): NaN planted in that layer's params before step ``step``
        self.nan_layer_params_at = {int(k): v for k, v in
                                    (nan_layer_params_at or {}).items()}
        #: lifecycle kinds: the 1-based roll index at which the trainer
        #: dies mid-roll; {round: "nan"|"regressed"} candidate poisons;
        #: the 1-based roll index whose post-promote confirmation reads as
        #: an SLO regression
        self.trainer_death_at_roll = trainer_death_at_roll
        self.bad_candidate_at = {int(k): str(v) for k, v in
                                 (bad_candidate_at or {}).items()}
        for k, v in self.bad_candidate_at.items():
            if v not in ("nan", "regressed"):
                raise ValueError(
                    f"bad_candidate_at[{k}]={v!r}: kind must be "
                    "'nan' or 'regressed'")
        self.slo_regression_during_canary = slo_regression_during_canary
        # consumed-state: each fault fires once
        self._nan_pending = set(self.nan_grads_at)
        self._data_pending = set(self.data_error_at)
        self._ckpt_fail_pending = set(self.checkpoint_write_fail_at)
        self._ckpt_corrupt_pending = set(self.checkpoint_corrupt_at)
        self._pull_index = 0
        self._hang_pending = set(self.hung_dispatch_at)
        self._slow_pending = set(self.slow_replica_at)
        self._serve_fail_pending = set(self.serve_fail_at)
        self._layer_poison_pending = set(self.nan_layer_params_at)
        self._trainer_death_pending = trainer_death_at_roll is not None
        self._bad_candidate_pending = set(self.bad_candidate_at)
        self._slo_regression_pending = \
            slo_regression_during_canary is not None
        self._hang_release = threading.Event()

    @classmethod
    def seeded(cls, seed: int, horizon: int, n_nan: int = 1,
               n_data_errors: int = 1, preempt: bool = False,
               corrupt_checkpoint: bool = False) -> "FaultPlan":
        """A training plan from one seed: fault steps drawn without
        replacement from ``[2, horizon]`` (step 1 is left clean, so every
        run makes one good update first), as the JAX package draws them
        (without its device-loss kind)."""
        rng = np.random.RandomState(seed)
        n_faults = n_nan + n_data_errors + (1 if preempt else 0)
        lo = 2
        pool = rng.permutation(np.arange(lo, max(horizon + 1, lo + n_faults)))
        picks = [int(p) for p in pool[:n_faults]]
        pos = n_nan + n_data_errors
        return cls(seed=seed, nan_grads_at=picks[:n_nan],
                   data_error_at=picks[n_nan:pos],
                   preempt_at_step=picks[pos] if preempt else None,
                   checkpoint_corrupt_at=(
                       [int(rng.randint(lo, horizon + 1))]
                       if corrupt_checkpoint else ()))

    # ----------------------------------------------------------- data seams
    def wrap_iterator(self, iterator) -> "DataSetIterator":
        """Wrap a DataSetIterator so the data-side faults (NaN batches,
        iterator errors) fire at the planned pull indices."""
        return _FaultInjectionIterator(iterator, self)

    def _on_pull(self) -> bool:
        """One batch pull is about to be served: True when it must be
        poisoned; raises the planned iterator error (the pull index is
        not advanced, so the retry delivers the same batch)."""
        self._pull_index += 1
        k = self._pull_index
        if k in self._data_pending:
            self._data_pending.discard(k)
            self._pull_index -= 1
            if self.data_error_transient:
                raise TransientDataError(
                    f"injected transient data error at step {k} "
                    f"(FaultPlan seed={self.seed})")
            raise IOError(f"injected permanent data error at step {k} "
                          f"(FaultPlan seed={self.seed})")
        if k in self._nan_pending:
            self._nan_pending.discard(k)
            return True
        return False

    # ------------------------------------------------------ checkpoint seams
    def checkpoint_write_error(self, step: int) -> bool:
        """True exactly once for a step planned to fail its checkpoint
        write (the manager raises ``OSError``; its retry succeeds)."""
        if step in self._ckpt_fail_pending:
            self._ckpt_fail_pending.discard(step)
            return True
        return False

    def corrupt_checkpoint(self, step: int, directory: str) -> bool:
        """After the checkpoint of ``step`` is finished: flip 64 bytes in
        the middle of its model archive if planned, so its manifest
        checksum no longer matches. True when it did."""
        if step not in self._ckpt_corrupt_pending:
            return False
        self._ckpt_corrupt_pending.discard(step)
        target = os.path.join(directory, "model.zip")
        if not os.path.exists(target):
            return False
        size = os.path.getsize(target)
        with open(target, "r+b") as f:
            f.seek(size // 2)
            chunk = f.read(64)
            f.seek(size // 2)
            f.write(bytes(b ^ 0xFF for b in chunk))
        return True

    # ------------------------------------------------------ preemption seam
    def poison_layer_params(self, model, step: int) -> bool:
        """Fires once a planned layer poison: writes NaN into element 0 of
        the planned layer's first float param (sorted by name), in place
        (a captured step reads that storage), and voids the sanitizer's
        provenance window (an out-of-band mutation its replay cannot
        reproduce). The resilience session calls it before each step or
        dispatch with the dispatch's first step, so a poison planned
        inside a K-step dispatch lands at the next dispatch boundary."""
        due = sorted(s for s in self._layer_poison_pending if s <= step)
        if not due:
            return False
        fire_at = due[0]
        self._layer_poison_pending.discard(fire_at)
        entry = model._params[self.nan_layer_params_at[fire_at]]
        for name in sorted(entry):
            t = entry[name]
            if t.is_floating_point():
                with torch.no_grad():
                    t[(0,) * t.dim()] = float("nan")
                from deeplearning4j_tpu_torch.profiler import sanitizer
                sanitizer.invalidate(model)
                return True
        return False

    def preemption_signal(self):
        """A StepPreemption for the planned preemption, or None."""
        if self.preempt_at_step is None:
            return None
        from deeplearning4j_tpu_torch.train.resilience import StepPreemption
        return StepPreemption(self.preempt_at_step)

    @classmethod
    def seeded_serving(cls, seed: int, horizon: int, n_fail: int = 1,
                       n_slow: int = 0, n_hang: int = 0,
                       slow_seconds: float = 0.05,
                       hang_seconds: Optional[float] = 0.2,
                       device_loss: int = 0,
                       device_pool: Iterable[int] = ()) -> "FaultPlan":
        """A serving-side plan from one seed: fault *batch indices* are
        drawn without replacement from ``[2, horizon]`` (batch 1 is left
        clean so warmup-adjacent traffic always lands once). ``n_fail``
        injects transient replica faults, ``n_slow``/``n_hang`` stall
        forwards through the watchdog's dispatch_hold seam, and
        ``device_loss=n`` kills n devices from ``device_pool`` at a
        drawn batch (the mesh-shrink path)."""
        rng = np.random.RandomState(seed)
        n_faults = n_fail + n_slow + n_hang + (1 if device_loss else 0)
        lo = 2
        pool = rng.permutation(np.arange(lo, max(horizon + 1, lo + n_faults)))
        picks = [int(p) for p in pool[:n_faults]]
        fail_at = picks[:n_fail]
        slow_at = picks[n_fail:n_fail + n_slow]
        hang_at = picks[n_fail + n_slow:n_fail + n_slow + n_hang]
        loss_at, lose = None, ()
        if device_loss:
            loss_at = picks[n_fail + n_slow + n_hang]
            ids = sorted(int(d) for d in device_pool)
            if device_loss >= len(ids):
                raise ValueError(
                    f"device_loss={device_loss} would kill the whole "
                    f"device_pool ({len(ids)} devices)")
            lose = [ids[int(i)] for i in
                    rng.choice(len(ids), size=device_loss, replace=False)]
        return cls(seed=seed, serve_fail_at=fail_at,
                   slow_replica_at=slow_at, slow_seconds=slow_seconds,
                   hung_dispatch_at=hang_at, hang_seconds=hang_seconds,
                   serve_device_loss_at_batch=loss_at, lose_devices=lose)

    @classmethod
    def seeded_lifecycle(cls, seed: int, rounds: int, n_bad: int = 1,
                         bad_kind: Optional[str] = None,
                         trainer_death: bool = False,
                         slo_regression: bool = False) -> "FaultPlan":
        """A lifecycle plan from one seed: fault *round indices* are
        drawn without replacement from ``[2, rounds]`` (round 1 is left
        clean so every storm promotes at least one good candidate
        first). ``n_bad`` poisons that many candidates (``bad_kind``
        fixes the kind; default alternates nan/regressed per draw),
        ``trainer_death`` SIGKILLs the trainer mid-roll at a drawn roll
        index, and ``slo_regression`` plants one genuine SLO regression
        in a drawn roll's confirmation window. The same seed draws the
        same rounds as the JAX package's."""
        rng = np.random.RandomState(seed)
        n_faults = n_bad + (1 if trainer_death else 0) \
            + (1 if slo_regression else 0)
        lo = 2
        pool = rng.permutation(np.arange(lo, max(rounds + 1, lo + n_faults)))
        picks = [int(p) for p in pool[:n_faults]]
        kinds = ("nan", "regressed")
        bad = {picks[i]: (bad_kind if bad_kind is not None
                          else kinds[i % 2]) for i in range(n_bad)}
        pos = n_bad
        death = None
        if trainer_death:
            death = picks[pos]
            pos += 1
        regression = picks[pos] if slo_regression else None
        return cls(seed=seed, bad_candidate_at=bad,
                   trainer_death_at_roll=death,
                   slo_regression_during_canary=regression)

    # -------------------------------------------------------- serving seams
    def serving_forward(self, batch_index: int, device_ids) -> None:
        """Called by the model server as serving batch ``batch_index``
        (1-based) is about to forward on ``device_ids``: raises the
        planned replica fault (once) or the planned device-loss error
        (every forward that still touches a dead device — the server
        must shrink the mesh before forwards succeed again)."""
        if batch_index in self._serve_fail_pending:
            self._serve_fail_pending.discard(batch_index)
            raise RuntimeError(
                f"injected replica fault at serving batch {batch_index} "
                f"(FaultPlan seed={self.seed})")
        if self.serve_device_loss_at_batch is not None \
                and batch_index >= self.serve_device_loss_at_batch:
            dead = set(self.lose_devices) & {int(d) for d in device_ids}
            if dead:
                raise RuntimeError(
                    f"injected device loss at serving batch {batch_index}: "
                    f"device(s) {sorted(dead)} are dead "
                    f"(FaultPlan seed={self.seed})")

    def dispatch_hold(self, step: int) -> bool:
        """Called (in the dispatch thread) as update step ``step`` is
        about to dispatch: stalls for the planned hang/straggler delay.
        Returns False when the dispatch must be SKIPPED — a hard hang
        (``hang_seconds=None``) aborted by :meth:`release_hangs`, i.e.
        a dispatch that never completed."""
        if step in self._slow_pending:
            self._slow_pending.discard(step)
            time.sleep(self.slow_seconds)
        if step in self._hang_pending:
            self._hang_pending.discard(step)
            if self.hang_seconds is None:
                self._hang_release.wait()
                return False
            time.sleep(self.hang_seconds)
        return True

    def release_hangs(self):
        """Unblock any hard-hung dispatch (``hang_seconds=None``): the
        holder returns WITHOUT dispatching, modelling a dispatch the
        watchdog abandoned that never reaches the device."""
        self._hang_release.set()

    # ------------------------------------------------------ lifecycle seams
    def trainer_dies_at_roll(self, roll_index: int) -> bool:
        """True exactly once, when the driver's ``roll_index``-th roll
        (1-based) is the planned trainer-death point — the driver kills
        its trainer (SIGKILL for a subprocess) and unwinds; a later
        driver over the same state dir must resume."""
        if self._trainer_death_pending \
                and self.trainer_death_at_roll is not None \
                and int(roll_index) >= int(self.trainer_death_at_roll):
            self._trainer_death_pending = False
            return True
        return False

    def candidate_fault(self, round_index: int) -> Optional[str]:
        """The planned candidate poison for training round
        ``round_index`` (1-based): ``"nan"`` (non-finite outputs),
        ``"regressed"`` (outputs shifted past the gate's parity bound),
        or None. Fires once per planned round."""
        k = int(round_index)
        if k in self._bad_candidate_pending:
            self._bad_candidate_pending.discard(k)
            return self.bad_candidate_at[k]
        return None

    def canary_regression(self, roll_index: int) -> bool:
        """True exactly once, when roll ``roll_index``'s post-promote
        confirmation window is the planned SLO-regression point — the
        driver must roll back automatically."""
        if self._slo_regression_pending \
                and self.slo_regression_during_canary is not None \
                and int(roll_index) >= int(self.slo_regression_during_canary):
            self._slo_regression_pending = False
            return True
        return False

    def __repr__(self):
        return (f"FaultPlan(seed={self.seed}, "
                f"nan={sorted(self.nan_grads_at)}, "
                f"data={sorted(self.data_error_at)}"
                f"{' transient' if self.data_error_transient else ' permanent'}, "
                f"ckpt_fail={sorted(self.checkpoint_write_fail_at)}, "
                f"ckpt_corrupt={sorted(self.checkpoint_corrupt_at)}, "
                f"preempt={self.preempt_at_step}, "
                f"hung={sorted(self.hung_dispatch_at)}, "
                f"slow={sorted(self.slow_replica_at)}, "
                f"serve_fail={sorted(self.serve_fail_at)}, "
                f"serve_loss={self.serve_device_loss_at_batch}:"
                f"{sorted(self.lose_devices)}, "
                f"trainer_death_at_roll={self.trainer_death_at_roll}, "
                f"bad_candidate={sorted(self.bad_candidate_at.items())}, "
                f"slo_regression={self.slo_regression_during_canary})")


def _nan_like(a):
    """A float32 array (or tensor) of ``a``'s shape, all NaN: uint8 image
    bytes cannot hold one, so a poisoned batch is float, as in the JAX
    package."""
    if isinstance(a, torch.Tensor):
        return torch.full(a.shape, float("nan"), dtype=torch.float32,
                          device=a.device)
    return np.full(np.shape(a), np.nan, np.float32)


def _poison(ds):
    """A NaN-poisoned copy of a batch: features NaN, labels and masks
    kept, so the step's loss and gradients go non-finite through the
    device."""
    if isinstance(ds, MultiDataSet):
        out = MultiDataSet.__new__(MultiDataSet)
        out.features = [_nan_like(a) for a in ds.features]
        out.labels = list(ds.labels)
        out.features_masks = ds.features_masks
        out.labels_masks = ds.labels_masks
        return out
    out = DataSet.__new__(DataSet)
    out.features = _nan_like(ds.features)
    out.labels = ds.labels
    out.features_mask = ds.features_mask
    out.labels_mask = ds.labels_mask
    return out


class _FaultInjectionIterator(DataSetIterator):
    """A DataSetIterator wrapper running a FaultPlan's data faults: the
    planned iterator errors (the base not advanced, so a retry delivers
    the batch) and the NaN-poisoned batches."""

    def __init__(self, base, plan: FaultPlan):
        self.base = base
        self.plan = plan

    def hasNext(self) -> bool:
        return self.base.hasNext()

    def next(self):
        poison = self.plan._on_pull()          # may raise the planned error
        ds = self.base.next()
        return _poison(ds) if poison else ds

    def reset(self):
        self.base.reset()

    def batch(self):
        return self.base.batch()

    def cursor(self):
        return self.base.cursor()

    def seek(self, cursor):
        self.base.seek(cursor)


# ------------------------------------------------------------ serving load
class RequestSpec:
    """One planned serving request: ``at`` seconds after replay start,
    ``rows`` feature rows, optional ``deadline`` seconds. Wire-side
    behaviors (``replay_http`` only): ``slow_s`` dribbles the body over
    that many seconds, ``disconnect`` closes the socket without reading
    the response."""

    __slots__ = ("at", "rows", "deadline", "slow_s", "disconnect")

    def __init__(self, at: float, rows: int, deadline: Optional[float],
                 slow_s: float = 0.0, disconnect: bool = False):
        self.at = float(at)
        self.rows = int(rows)
        self.deadline = deadline
        self.slow_s = float(slow_s)
        self.disconnect = bool(disconnect)

    def __repr__(self):
        extra = ""
        if self.slow_s:
            extra += f", slow_s={self.slow_s:g}"
        if self.disconnect:
            extra += ", disconnect=True"
        return (f"RequestSpec(at={self.at:.4f}, rows={self.rows}, "
                f"deadline={self.deadline}{extra})")


class ServingLoad:
    """Seeded, deterministic request-arrival schedule for the model
    server — the workload half of the serving fault kinds, shared by the
    chaos tests and the chip smoke's front-door phase.

    Mixes:

    - ``steady``: exponential inter-arrival gaps at ``rps`` (a Poisson
      process), uniform row counts in ``[1, max_rows]``.
    - ``burst``: a quiet floor at ``rps`` punctuated by ``n_bursts``
      zero-gap volleys of ``burst_size`` requests — the admission-
      control stressor (a full queue must shed, not block).
    - ``deadline``: the steady process, but ``deadline_frac`` of the
      requests carry a tight ``tight_deadline`` and the rest a loose
      one — the deadline-storm stressor (expired requests must be shed
      before dispatch without rotting the batch for the rest).
    """

    MIXES = ("steady", "burst", "deadline")

    def __init__(self, specs):
        self.specs = list(specs)
        self.wire_seconds: list = []
        self.replay_started: Optional[float] = None

    def __len__(self):
        return len(self.specs)

    def __iter__(self):
        return iter(self.specs)

    def duration(self) -> float:
        return self.specs[-1].at if self.specs else 0.0

    @classmethod
    def seeded(cls, seed: int, mix: str = "steady", n: int = 200,
               rps: float = 500.0, max_rows: int = 4,
               n_bursts: int = 4, burst_size: int = 32,
               tight_deadline: float = 0.005, loose_deadline: float = 2.0,
               deadline_frac: float = 0.5, slow_frac: float = 0.0,
               slow_client_seconds: float = 0.05,
               disconnect_frac: float = 0.0) -> "ServingLoad":
        """``slow_frac``/``disconnect_frac`` mark a seeded fraction of
        the schedule with the wire-level client behaviors
        :meth:`replay_http` executes (the in-process :meth:`replay`
        ignores them — there is no wire to misbehave on)."""
        if mix not in cls.MIXES:
            raise ValueError(f"unknown mix {mix!r} (expected one of "
                             f"{cls.MIXES})")
        rng = np.random.RandomState(seed)
        specs = []
        t = 0.0
        if mix == "burst":
            # exactly n requests, always: an oversized volley plan is
            # clamped instead of silently generating more than n (and
            # collapsing every volley into one mega-burst at t~0)
            n_bursts = max(1, min(n_bursts, n))
            burst_size = min(burst_size, max(n // n_bursts, 1))
            floor = n - n_bursts * burst_size
            burst_at = sorted(rng.uniform(0.0, max(floor, n_bursts) / rps,
                                          size=n_bursts))
            for i in range(floor):
                t += rng.exponential(1.0 / rps)
                specs.append(RequestSpec(t, 1 + rng.randint(max_rows), None))
            for b in burst_at:
                for _ in range(burst_size):
                    specs.append(RequestSpec(
                        b, 1 + rng.randint(max_rows), None))
            specs.sort(key=lambda s: s.at)
        else:
            for i in range(n):
                t += rng.exponential(1.0 / rps)
                deadline = None
                if mix == "deadline":
                    deadline = tight_deadline \
                        if rng.uniform() < deadline_frac else loose_deadline
                specs.append(RequestSpec(t, 1 + rng.randint(max_rows),
                                         deadline))
        # wire-side behaviors drawn AFTER the arrival schedule, so a
        # given (seed, mix, n) keeps the same arrivals with or without
        # client chaos enabled
        for spec in specs:
            if slow_frac and rng.uniform() < slow_frac:
                spec.slow_s = slow_client_seconds
            if disconnect_frac and rng.uniform() < disconnect_frac:
                spec.disconnect = True
        return cls(specs)

    def features(self, feature_shape, dtype=np.float32, rng_seed: int = 0,
                 make: Optional[Callable] = None) -> list:
        """Each spec's request features, in schedule order: seeded
        normals cast to ``dtype`` (the reference's), or ``make(rng,
        spec)`` when given (e.g. token ids within a vocabulary). What
        :meth:`replay` and :meth:`replay_http` send."""
        rng = np.random.RandomState(rng_seed)
        if make is not None:
            return [np.asarray(make(rng, spec)) for spec in self.specs]
        return [rng.randn(spec.rows, *feature_shape).astype(dtype)
                for spec in self.specs]

    def replay(self, submit, feature_shape, dtype=np.float32,
               time_scale: float = 1.0, rng_seed: int = 0,
               make: Optional[Callable] = None,
               stop: Optional[threading.Event] = None):
        """Drive ``submit(x, deadline=...)`` honoring the arrival
        offsets (scaled by ``time_scale``). Returns the list of
        ``(spec, handle_or_exception)`` pairs — admission rejections are
        captured, not raised, so callers can assert on the outcome
        partition. Feature values are seeded for reproducibility
        (:meth:`features`). ``stop``, when set, ends the schedule early:
        nothing is submitted after it, and the submitted prefix is
        returned."""
        feats = self.features(feature_shape, dtype, rng_seed, make)
        t0 = time.monotonic()
        out = []
        for spec, x in zip(self.specs, feats):
            delay = spec.at * time_scale - (time.monotonic() - t0)
            if stop is not None:
                if stop.wait(max(delay, 0.0)):
                    break
            elif delay > 0:
                time.sleep(delay)
            try:
                out.append((spec, submit(x, deadline=spec.deadline)))
            except Exception as e:  # admission errors are outcomes here
                out.append((spec, e))
        return out

    def replay_http(self, url: str, model: str, feature_shape,
                    dtype=np.float32, time_scale: float = 1.0,
                    rng_seed: int = 0, timeout: float = 60.0,
                    make: Optional[Callable] = None,
                    stop: Optional[threading.Event] = None):
        """Replay the schedule over REAL sockets against an
        :class:`~deeplearning4j_tpu_torch.serving.ingress.HttpIngress`:
        ``POST {url}/v1/models/{model}:predict`` per spec, honoring
        arrival offsets, with the wire-level client chaos the specs
        carry — ``slow_s`` dribbles the JSON body in chunks, and
        ``disconnect`` closes the socket after sending without reading
        the response (the server must absorb both).

        Each request runs on its own thread (queueing belongs on the
        server, not in the generator). Returns ``[(spec, outcome)]`` in
        schedule order: ``(status_code, payload_dict)`` for answered
        requests, the string ``"disconnected"`` for planned
        disconnects, or the raised exception for transport failures.
        Feature values are seeded identically to :meth:`replay`.
        ``wire_seconds`` then holds each answered request's round trip
        on the client's clock, from the first byte sent to the response
        read (None for the others), and ``replay_started`` the
        ``time.perf_counter()`` at which the schedule's clock started,
        after the bodies were encoded.

        ``stop``, when set, ends the schedule early: no request is sent
        after it, those in flight are answered, and only the sent prefix
        of the schedule is returned. A caller whose own work sets the
        length of the traffic it needs gives a long schedule and sets
        ``stop`` when that work is done.
        """
        import http.client
        import json
        from urllib.parse import urlparse
        parsed = urlparse(url)
        host, port = parsed.hostname, parsed.port
        bodies = [json.dumps({"instances": x.tolist()}).encode()
                  for x in self.features(feature_shape, dtype, rng_seed,
                                         make)]
        out: list = [None] * len(self.specs)
        self.wire_seconds: list = [None] * len(self.specs)

        def one(i: int, spec: RequestSpec, body: bytes):
            conn = http.client.HTTPConnection(host, port, timeout=timeout)
            t0 = time.perf_counter()
            try:
                conn.putrequest("POST", f"/v1/models/{model}:predict")
                conn.putheader("Content-Type", "application/json")
                conn.putheader("Content-Length", str(len(body)))
                if spec.deadline is not None:
                    conn.putheader("deadline_ms",
                                   f"{spec.deadline * 1e3:g}")
                conn.endheaders()
                if spec.slow_s > 0:
                    # dribble: 4 chunks with stalls between them — the
                    # handler blocks on ONE thread reading this body
                    step = max(len(body) // 4, 1)
                    for pos in range(0, len(body), step):
                        conn.send(body[pos:pos + step])
                        time.sleep(spec.slow_s / 4.0)
                else:
                    conn.send(body)
                if spec.disconnect:
                    out[i] = "disconnected"
                    return          # finally closes the socket unread
                resp = conn.getresponse()
                out[i] = (resp.status, json.loads(resp.read()))
                self.wire_seconds[i] = time.perf_counter() - t0
            except Exception as e:
                out[i] = e
            finally:
                conn.close()

        t0 = time.monotonic()
        self.replay_started = time.perf_counter()
        threads = []
        for i, spec in enumerate(self.specs):
            delay = spec.at * time_scale - (time.monotonic() - t0)
            if delay > 0:
                if stop is None:
                    time.sleep(delay)
                else:
                    stop.wait(delay)
            if stop is not None and stop.is_set():
                break
            th = threading.Thread(target=one, args=(i, spec, bodies[i]),
                                  daemon=True)
            th.start()
            threads.append(th)
        for th in threads:
            th.join(timeout)
        return list(zip(self.specs[:len(threads)], out))


class SwapSchedule:
    """Seeded hot-swap-under-load schedule: planned
    ``ModelRegistry.roll()``/``rollback()`` calls fired from a
    background thread while a :class:`ServingLoad` replay is in flight
    — the workload half of the zero-drop hot-swap chaos pin.

    ``swaps`` is a list of ``(at_seconds, name, version_or_None)``;
    ``version=None`` means "roll to the newest staged version" and the
    literal string ``"rollback"`` rolls back instead.
    """

    def __init__(self, swaps):
        self.swaps = sorted(swaps, key=lambda s: s[0])
        self.performed: list = []
        self._thread: Optional[threading.Thread] = None

    @classmethod
    def seeded(cls, seed: int, name: str, duration: float,
               n_swaps: int = 2) -> "SwapSchedule":
        """``n_swaps`` swap points drawn uniformly from the middle 70%
        of ``duration`` (the edges prove nothing — traffic must be in
        flight), alternating roll -> rollback -> roll ..."""
        rng = np.random.RandomState(seed)
        at = np.sort(rng.uniform(0.15 * duration, 0.85 * duration,
                                 size=n_swaps))
        return cls([(float(t), name, None if i % 2 == 0 else "rollback")
                    for i, t in enumerate(at)])

    def start(self, registry, time_scale: float = 1.0) -> "SwapSchedule":
        """Fire the schedule against ``registry`` on a daemon thread;
        :meth:`join` collects ``performed`` — ``(at, name, action,
        result_or_exception)`` per swap."""
        def run():
            t0 = time.monotonic()
            for at, name, version in self.swaps:
                delay = at * time_scale - (time.monotonic() - t0)
                if delay > 0:
                    time.sleep(delay)
                try:
                    if version == "rollback":
                        result = registry.rollback(name)
                        action = "rollback"
                    else:
                        result = registry.roll(name, version)
                        action = "roll"
                except Exception as e:      # surfaced via performed
                    result, action = e, "error"
                self.performed.append((at, name, action, result))
        self._thread = threading.Thread(target=run, daemon=True,
                                        name="dl4j-swap-schedule")
        self._thread.start()
        return self

    def join(self, timeout: float = 30.0) -> list:
        if self._thread is not None:
            self._thread.join(timeout)
        return self.performed


# ------------------------------------------------- deterministic interleaving
class InterleavingHarness:
    """Seeded deterministic thread-interleaving executor.

    ``run(fn_a, fn_b, ...)`` executes the callables on real threads,
    but under a cooperative scheduler: exactly ONE thread holds the
    execution token at any time, and at every traced line (or, with
    ``opcode_level=True``, every bytecode opcode — fine enough to split
    ``self.x += 1`` between its LOAD and STORE) the running thread asks
    a seeded RNG whether to hand the token to another runnable thread.
    Because every switch decision is drawn from the seed and switch
    points execute in a total order, the interleaving — and therefore
    the outcome of any data race in the bodies — is a deterministic
    function of ``(seed, switch_prob, bodies)``.

    This is what makes the E201/E202 bug class *testable*: the
    lost-increment fixture loses the same increments on every run with
    the same seed, and the locked fix can be pinned to never lose any
    across a seed sweep (``pytest -m races``).

    Escape hatch for real blocking: if the token holder blocks in C
    (e.g. on a ``threading.Lock`` another thread holds), it cannot
    reach a switch point — a waiter that observes no scheduler progress
    for ``stall_timeout`` seconds steals the token so the run cannot
    deadlock. Bodies built purely from traced Python (the bad fixtures)
    never stall, so their schedules stay exactly deterministic; bodies
    taking real locks stay correct but may interleave through the
    (timing-based) steal path.

    Only code in the submitted bodies (their module, transitively
    called functions included) is traced; scheduler internals and the
    interpreter's ``threading`` machinery are exempt so the RNG stream
    is consumed by user code only.
    """

    def __init__(self, seed: int = 0, switch_prob: float = 0.35,
                 opcode_level: bool = True, stall_timeout: float = 0.01,
                 timeout: float = 30.0):
        self.seed = int(seed)
        self.switch_prob = float(switch_prob)
        self.opcode_level = bool(opcode_level)
        self.stall_timeout = float(stall_timeout)
        self.timeout = float(timeout)
        self._rng = random.Random(self.seed)
        self._cond = threading.Condition()
        self._active: Optional[int] = None
        self._runnable: List[int] = []
        self._progress = 0
        self._started = 0
        self._total = 0
        self._abort = False
        self._results: dict = {}
        self._errors: dict = {}
        self._tls = threading.local()

    # ------------------------------------------------------------ scheduling
    def _switch_point(self, idx: int) -> None:
        if self._abort or getattr(self._tls, "in_scheduler", False):
            return
        self._tls.in_scheduler = True
        try:
            with self._cond:
                self._progress += 1
                if self._active == idx and len(self._runnable) > 1 \
                        and self._rng.random() < self.switch_prob:
                    others = [i for i in self._runnable if i != idx]
                    self._active = self._rng.choice(others)
                    self._cond.notify_all()
                self._wait_for_token(idx)
        finally:
            self._tls.in_scheduler = False

    def _wait_for_token(self, idx: int) -> None:
        """Block (cond held) until this thread owns the token; steal it
        if the current owner is blocked outside traced code. A steal
        needs THREE consecutive empty stall windows: an owner that is
        merely descheduled (startup, a loaded box) usually progresses
        within one window, while one blocked in C on a real lock never
        does — a premature steal would diverge the seeded schedule."""
        stalls = 0
        while self._active != idx:
            if self._abort:
                return      # run() gave up: free-run to completion
            seen = self._progress
            if self._cond.wait(self.stall_timeout) \
                    or self._progress != seen:
                stalls = 0
                continue
            if idx not in self._runnable:
                stalls = 0
                continue
            stalls += 1
            if stalls >= 3:
                # owner is stuck in C (a real lock): take over.
                # every caller holds _cond around this method
                self._active = idx      # dl4j: noqa=E201
                self._cond.notify_all()
                return

    def _finish(self, idx: int) -> None:
        with self._cond:
            if idx in self._runnable:
                self._runnable.remove(idx)
            if self._runnable:
                self._active = (self._rng.choice(self._runnable)
                                if self._active == idx
                                else self._active)
            else:
                self._active = None
            self._cond.notify_all()

    # --------------------------------------------------------------- tracing
    #: exact source files never traced: the harness itself plus the
    #: stdlib modules its scheduler leans on — matched by identity, not
    #: substring, so a user file named e.g. random_search.py still gets
    #: its switch points
    _TRACE_EXCLUDED = frozenset({__file__, threading.__file__,
                                 random.__file__})

    def _tracer(self, idx: int):
        excluded = self._TRACE_EXCLUDED
        opcode_level = self.opcode_level

        def trace(frame, event, arg):
            code_file = frame.f_code.co_filename
            if code_file in excluded:
                return None
            if event == "call":
                if opcode_level:
                    frame.f_trace_opcodes = True
                return trace
            if event in ("line", "opcode"):
                self._switch_point(idx)
            return trace
        return trace

    def _body(self, idx: int, fn: Callable) -> None:
        # rendezvous: no body runs a user opcode until EVERY thread has
        # started, so a slow-to-schedule initial token owner can never
        # be stolen from before it has run at all
        with self._cond:
            self._started += 1
            self._cond.notify_all()
            while self._started < self._total:
                self._cond.wait()
            self._wait_for_token(idx)
        sys.settrace(self._tracer(idx))
        try:
            result = fn()
        except BaseException as e:
            sys.settrace(None)
            with self._cond:
                self._errors[idx] = e
            self._finish(idx)
        else:
            sys.settrace(None)
            with self._cond:
                self._results[idx] = result
            self._finish(idx)

    # ------------------------------------------------------------------- run
    def run(self, *fns: Callable) -> List:
        """Execute ``fns`` to completion under the seeded schedule;
        returns their results in order (re-raising the first body
        error). A harness instance is single-use — the RNG stream is
        part of the schedule."""
        if not fns:
            return []
        with self._cond:
            self._runnable = list(range(len(fns)))
            self._active = 0
            self._started = 0
            self._total = len(fns)
        threads = [threading.Thread(target=self._body, args=(i, fn),
                                    name=f"interleave-{i}", daemon=True)
                   for i, fn in enumerate(fns)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + self.timeout
        for t in threads:
            t.join(max(deadline - time.monotonic(), 0.0))
        alive = [t.name for t in threads if t.is_alive()]
        if alive:
            with self._cond:        # unwedge before reporting: parked
                self._abort = True  # threads return from _wait_for_token
                self._runnable = []  # and free-run (untraced switch
                self._active = None  # points) instead of spinning
                self._cond.notify_all()
            raise TimeoutError(
                f"interleaving harness: {alive} still running after "
                f"{self.timeout}s (seed={self.seed})")
        for i in range(len(fns)):
            if i in self._errors:
                raise self._errors[i]
        return [self._results.get(i) for i in range(len(fns))]

    @classmethod
    def sweep(cls, fns_factory: Callable[[], Sequence[Callable]],
              seeds: Iterable[int], **kw) -> List:
        """Run a fresh body set under each seed; returns the per-seed
        results list — the shape the ``-m races`` sweeps assert over."""
        out = []
        for s in seeds:
            out.append(cls(seed=s, **kw).run(*fns_factory()))
        return out


@contextlib.contextmanager
def preemptive_stress(seed: int = 0, switch_interval: float = 1e-5):
    """Maximize REAL thread preemption for the duration of the block:
    drops ``sys.setswitchinterval`` to ``switch_interval`` (the GIL
    hands off between bytecodes orders of magnitude more often) and
    yields a seeded ``random.Random`` for the workload so the request
    pattern is reproducible even though the schedule is not. The sweep
    mode for racing the *real* serving / elastic / async-checkpoint
    stacks (``pytest -m races``); :class:`InterleavingHarness` is the
    deterministic single-schedule mode."""
    prev = sys.getswitchinterval()
    sys.setswitchinterval(switch_interval)
    try:
        yield random.Random(seed)
    finally:
        sys.setswitchinterval(prev)
