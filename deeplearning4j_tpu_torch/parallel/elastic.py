"""Elastic multi-rank training — the port of
``deeplearning4j_tpu/parallel/elastic.py``: rank-loss detection,
dispatch watchdogs and the coordinated shrink.

A lost device is a lost rank (one process a device):

- :class:`DeviceMonitor` — between dispatches, classifies the mesh's
  ranks: this rank's own card is probed with a sentinel round trip (a
  probe that raises marks it dead, one slower than ``degraded_after``
  degraded); a :class:`~deeplearning4j_tpu_torch.faults.FaultPlan`
  injects planned rank losses (``device_loss_at_step``) at this seam, so
  every shrink path is a seeded deterministic test. A rank that finds
  ITSELF dead raises :class:`RankLostError` (its process is done).
- :class:`DispatchWatchdog` — a blocking dispatch on a supervised
  thread with a soft deadline (a recorded timeout; a straggler if it
  then completes) and a hard grace deadline (abandoned:
  :class:`DispatchTimeoutError`). The model server runs every forward
  through one (``replica_timeout``).
- :class:`CoordinationService` — the resume barrier's contract: every
  participant reports its last completed step and all agree on the
  minimum. :class:`InProcessCoordinator` serves threads of one process,
  :class:`StoreCoordinator` the ranks of one job over the process
  group's store (the default for more than one rank), and
  ``distributed.coordinator``'s socket and file coordinators OS
  processes across hosts (with heartbeats: a dead peer is named by
  :class:`~deeplearning4j_tpu_torch.distributed.coordinator.
  DeadPeerError`).
- :func:`fit_elastic` — the driver of ``ParallelWrapper.fit(elastic=)``:
  on a rank's loss (planned, or a failed collective the coordinator
  confirms by naming the dead peer) the survivors retire the dead peers
  from the coordinator, agree on the last globally completed step, the
  first survivor writes that step's checkpoint, the survivors form a new
  process group among themselves (``parallel.init.reform_group``: a
  fresh store prefix, ranks renumbered), revalidate the shrunk mesh
  statically, rescale the learning rate per
  :class:`ElasticConfig.lr_policy` and restore the agreed checkpoint.

Metrics: ``dl4j_device_lost_total``, ``dl4j_mesh_shrinks_total``,
``dl4j_dispatch_watchdog_timeouts_total``,
``dl4j_dispatch_straggler_seconds``, ``dl4j_device_probe_seconds``,
``dl4j_elastic_recovery_seconds``.
"""

from __future__ import annotations

import logging
import sys
import threading
import time
import warnings
from contextlib import ExitStack
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

import torch

from deeplearning4j_tpu_torch.profiler.locks import (InstrumentedCondition,
                                                     InstrumentedLock)
from deeplearning4j_tpu_torch.profiler.metrics import get_registry

logger = logging.getLogger("deeplearning4j_tpu_torch")

_REG = get_registry()
WATCHDOG_TIMEOUTS = _REG.counter(
    "dl4j_dispatch_watchdog_timeouts_total",
    "Dispatches that exceeded the watchdog's soft deadline")
STRAGGLER_SECONDS = _REG.histogram(
    "dl4j_dispatch_straggler_seconds",
    "Wall time of dispatches that exceeded the watchdog deadline but "
    "eventually completed (stragglers)")
DEVICE_LOST = _REG.counter(
    "dl4j_device_lost_total",
    "Mesh ranks classified dead by the elastic layer's health probes")
MESH_SHRINKS = _REG.counter(
    "dl4j_mesh_shrinks_total",
    "Elastic mesh shrinks performed (coordinated checkpoint + a new group "
    "among the survivors + resume)")
PROBE_SECONDS = _REG.histogram(
    "dl4j_device_probe_seconds",
    "Per-device sentinel health probe round-trip time")
RECOVERY_SECONDS = _REG.histogram(
    "dl4j_elastic_recovery_seconds",
    "Wall time from rank-loss detection to the resumed state on the "
    "shrunk mesh (barrier + checkpoint + new group + restore)")


class DeviceLossError(RuntimeError):
    """One or more devices are dead. Carries ``dead`` (device ids) and
    ``surviving`` (live devices) so a shrink path can rebuild, and
    ``named_by_coordinator``: the participant a coordinator barrier named
    dead (None when the health probe saw the loss)."""

    def __init__(self, dead: Set[int], surviving: List, step: int,
                 named_by_coordinator: Optional[str] = None):
        self.dead = set(dead)
        self.surviving = list(surviving)
        self.step = int(step)
        self.named_by_coordinator = named_by_coordinator
        super().__init__(
            f"device(s) {sorted(self.dead)} dead at step {step} "
            f"({len(self.surviving)} surviving)")


class RankLostError(DeviceLossError):
    """This rank's own device is among the dead: its process is done (the
    survivors shrink without it)."""


class DispatchTimeoutError(RuntimeError):
    """A dispatch exceeded the watchdog's hard grace deadline and was
    abandoned. The update for its step(s) never landed; model state is
    the last completed step's."""


class ElasticShrinkError(RuntimeError):
    """The mesh cannot shrink any further (too few survivors, a
    non-data-parallel mesh, the shrink budget spent, or the shrunk
    configuration fails static validation)."""


@dataclass
class DeviceHealth:
    """One probe sweep's classification."""

    dead: Set[int] = field(default_factory=set)
    degraded: Set[int] = field(default_factory=set)
    probe_seconds: Dict[int, float] = field(default_factory=dict)

    def healthy(self) -> bool:
        return not self.dead


def _my_rank() -> int:
    """This process's member id (its first rank: stable across a
    shrink, as a FaultPlan and the coordinator name it)."""
    from deeplearning4j_tpu_torch.parallel.init import member_id
    return member_id()


class DeviceMonitor:
    """Sentinel health prober over a mesh's ranks.

    ``probe(devices, step)`` marks the planned losses dead (a
    :class:`~deeplearning4j_tpu_torch.faults.FaultPlan`'s
    ``dead_devices(step)``), then probes this rank's own device with a
    host -> device -> host round trip of a small sentinel: a probe that
    raises (or comes back corrupt) marks it DEAD, one slower than
    ``degraded_after`` seconds DEGRADED (recorded, not acted on). Peer
    ranks are probed through the job's collectives: a failed collective
    is confirmed by the coordinator (:func:`fit_elastic`)."""

    def __init__(self, degraded_after: float = 0.25, plan=None):
        self.degraded_after = float(degraded_after)
        self.plan = plan
        self._sentinel = torch.ones(8, dtype=torch.float32)

    def probe(self, devices, step: Optional[int] = None) -> DeviceHealth:
        health = DeviceHealth()
        planned = set()
        if self.plan is not None:
            planned = self.plan.dead_devices(step)
        me = _my_rank()
        for d in devices:
            if d.id in planned:
                health.dead.add(d.id)
                continue
            if d.id != me:
                continue
            t0 = time.perf_counter()
            try:
                from deeplearning4j_tpu_torch.parallel.init import \
                    rank_device
                back = self._sentinel.to(rank_device()).cpu()
                if not torch.equal(back, self._sentinel):
                    raise RuntimeError(f"sentinel round trip corrupt on "
                                       f"rank {d.id}")
            except Exception:
                health.dead.add(d.id)
                continue
            dt = time.perf_counter() - t0
            health.probe_seconds[d.id] = dt
            PROBE_SECONDS.observe(dt)
            if dt > self.degraded_after:
                health.degraded.add(d.id)
        return health


def shrink_mesh_on_dead(mesh, plan=None, context: str = "serving"):
    """Probe ``mesh``'s ranks and return a data-parallel mesh over the
    survivors when some are dead (a new process group among them: every
    survivor calls this together) — or None when the mesh must stay as
    it is: no deaths, model/seq axes (an unreplicated shard would be
    lost), this rank dead, or no survivor. Emits the operator-facing
    warnings either way (``context`` prefixes them)."""
    from deeplearning4j_tpu_torch.parallel import init as _init
    from deeplearning4j_tpu_torch.parallel.mesh import DeviceMesh
    devices = mesh.devices
    health = DeviceMonitor(plan=plan).probe(devices)
    if not health.dead:
        return None
    if mesh.size() != mesh.size("data"):
        warnings.warn(
            f"{context}: rank(s) {sorted(health.dead)} are dead but the "
            "mesh has model/seq axes — cannot shrink a tensor-parallel "
            "mesh; retrying on the full mesh", stacklevel=3)
        return None
    surviving = [d.id for d in devices if d.id not in health.dead]
    if not surviving or _my_rank() not in surviving:
        warnings.warn(
            f"{context}: no survivor to shrink onto from this rank — "
            "keeping the mesh", stacklevel=3)
        return None
    DEVICE_LOST.inc(len(health.dead))
    warnings.warn(
        f"{context}: dropping dead rank(s) {sorted(health.dead)}; "
        f"continuing on {len(surviving)} replica(s)", stacklevel=3)
    if _init.distributed_info() is not None and \
            _init.distributed_info().process_count > 1:
        _init.reform_group([_init.rank_of_member(m) for m in surviving])
    return DeviceMesh.data_parallel()


class DispatchFence:
    """Commit fence between the elastic recovery path and abandoned
    dispatch threads. ``fit_elastic`` attaches one to the model as
    ``_dispatch_fence``; the fit functions read ``generation`` at entry
    and COMMIT their outputs (state assignment + bookkeeping) only if,
    under the lock, the generation is unchanged. The shrink path bumps
    the generation and performs its checkpoint-restore under the same
    lock — so a hung dispatch that un-hangs after the mesh shrank
    discards its result instead of overwriting the restored state (or
    checkpointing a stale step)."""

    def __init__(self):
        self.lock = InstrumentedLock("elastic:fence")
        self.generation = 0


class DispatchWatchdog:
    """Deadline supervision around a blocking device dispatch.

    ``run(fn, step)`` executes ``fn`` on a dispatch thread and waits:

    - within ``deadline`` s: normal completion.
    - past ``deadline`` but within ``grace`` (default ``4*deadline``):
      a TIMEOUT is recorded; if the dispatch then completes it counts
      as a straggler and its result is used — transient stalls do not
      kill training.
    - past ``grace``: the dispatch is abandoned (the thread is a
      daemon; a truly hung kernel cannot be interrupted from
      Python) and :class:`DispatchTimeoutError` is raised. The caller
      must treat the step as never applied.

    ``deadline=None`` disables supervision: the dispatch runs inline on
    the calling thread (fault-injection delays still honored).

    The first ``warmup`` dispatches after :meth:`begin_attempt` are
    UNSUPERVISED (no deadline): they may build kernels or capture a
    CUDA graph, whose wall time has nothing to do with device health —
    counting it against the deadline would flag every cold start as
    hung. Steady-state dispatches that capture (a new batch signature
    mid-run) should be covered by setting ``deadline`` above the
    worst-case capture time or raising ``grace``.
    """

    def __init__(self, deadline: Optional[float] = None,
                 grace: Optional[float] = None, plan=None, warmup: int = 2):
        self.deadline = deadline
        self.grace = grace if grace is not None else (
            None if deadline is None else deadline * 4)
        self.plan = plan
        self.warmup = int(warmup)
        self._lenient = self.warmup
        self.timeouts = 0
        self.stragglers = 0

    def begin_attempt(self, count: Optional[int] = None):
        """The next ``warmup`` dispatches will compile (fresh program):
        run them unsupervised. ``count`` overrides the leniency for
        callers whose steady-state ``warmup`` is 0 (the model server
        captures every bucket at warmup, but its pre-warmup traffic
        legitimately runs cold)."""
        self._lenient = max(self._lenient,
                            self.warmup if count is None else int(count))

    def _hold(self, step: int) -> bool:
        """Fault seam: returns False when the planned hang says the
        dispatch never completes."""
        if self.plan is None:
            return True
        return self.plan.dispatch_hold(step)

    def run(self, fn, step: int):
        lenient = self._lenient > 0
        if lenient:
            self._lenient -= 1
        if self.deadline is None or lenient:
            if self._hold(step):
                return fn()
            raise DispatchTimeoutError(
                f"dispatch for step {step} never completed (injected hang "
                "outside watchdog supervision)")
        done = threading.Event()
        result: list = []
        error: list = []

        def work():
            try:
                if self._hold(step):
                    result.append(fn())
            except BaseException as e:      # re-raised on the caller
                error.append(e)
            finally:
                done.set()

        t = threading.Thread(target=work, daemon=True,
                             name=f"dl4j-dispatch-{step}")
        t0 = time.perf_counter()
        t.start()
        timed_out = False
        if not done.wait(self.deadline):
            timed_out = True
            self.timeouts += 1
            WATCHDOG_TIMEOUTS.inc()
            logger.warning("dispatch watchdog: step %d exceeded the %.3gs "
                           "deadline", step, self.deadline)
            remaining = None if self.grace is None \
                else max(self.grace - self.deadline, 0.0)
            if not done.wait(remaining):
                if self.plan is not None:
                    # let an injected hard hang exit WITHOUT dispatching
                    self.plan.release_hangs()
                raise DispatchTimeoutError(
                    f"dispatch for step {step} still running after the "
                    f"{self.grace:.3g}s grace deadline — abandoning it "
                    "(state is the last completed step's)")
        if error:
            raise error[0]
        dt = time.perf_counter() - t0
        if not result:
            # the injected hang was released without dispatching: the
            # step never completed even though the thread exited
            raise DispatchTimeoutError(
                f"dispatch for step {step} never completed")
        if timed_out:
            self.stragglers += 1
            STRAGGLER_SECONDS.observe(dt)
            logger.warning("dispatch watchdog: step %d completed late "
                           "(%.3fs) — straggler recorded", step, dt)
        return result[0]


# ----------------------------------------------------------- coordination
class CoordinationService:
    """Pluggable rendezvous for the elastic resume barrier.

    ``resume_barrier(participant, step)`` blocks until every participant
    has reported its last locally completed step and returns the agreed
    step — the MINIMUM across participants, the last GLOBALLY completed
    step every survivor can restore. ``retire(peer)`` (optional) drops a
    dead participant so later barriers agree among the survivors."""

    def resume_barrier(self, participant: str, step: int,
                       timeout: float = 60.0) -> int:
        raise NotImplementedError


class InProcessCoordinator(CoordinationService):
    """Threading-based coordinator for one process (threads as
    participants). Reusable across successive barriers."""

    def __init__(self, participants: int = 1):
        self.participants = int(participants)
        self._cond = InstrumentedCondition("elastic:coordinator")
        self._round: Dict[str, int] = {}
        self._results: Dict[int, int] = {}
        self._generation = 0

    def resume_barrier(self, participant: str, step: int,
                       timeout: float = 60.0) -> int:
        with self._cond:
            gen = self._generation
            self._round[str(participant)] = int(step)
            if len(self._round) >= self.participants:
                self._results[gen] = min(self._round.values())
                self._round = {}
                self._generation += 1
                self._cond.notify_all()
                return self._results[gen]
            deadline = time.monotonic() + timeout
            while gen not in self._results:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    arrived = len(self._round)
                    self._round.pop(str(participant), None)
                    raise TimeoutError(
                        f"resume barrier: only {arrived}/"
                        f"{self.participants} participants arrived within "
                        f"{timeout}s")
                self._cond.wait(remaining)
            return self._results[gen]


class StoreCoordinator(CoordinationService):
    """The resume barrier over the job's ``torch.distributed`` store (the
    one ``initializeDistributed`` made, which outlives a group): each
    participant writes its step under the round's key and waits for the
    others' (``participants``, names of the live ones; ``retire`` drops
    one). No server and no heartbeats: the dead set is known before the
    barrier (planned, or named by a socket coordinator)."""

    def __init__(self, participants: List[str], store=None,
                 prefix: str = "dl4j_elastic"):
        from deeplearning4j_tpu_torch.parallel import init as _init
        self.participants = [str(p) for p in participants]
        self.store = store if store is not None else _init._store
        self.prefix = prefix
        self._generation = 0

    def retire(self, peer: str) -> int:
        if str(peer) in self.participants:
            self.participants.remove(str(peer))
        return len(self.participants)

    def resume_barrier(self, participant: str, step: int,
                       timeout: float = 60.0) -> int:
        import datetime
        gen = self._generation
        self._generation += 1
        key = f"{self.prefix}/{gen}/"
        self.store.set(key + str(participant), str(int(step)))
        keys = [key + p for p in self.participants]
        try:
            self.store.wait(keys, datetime.timedelta(seconds=timeout))
        except Exception as e:
            raise TimeoutError(
                f"resume barrier: not every one of {self.participants} "
                f"arrived within {timeout}s ({e})") from e
        return min(int(self.store.get(k)) for k in keys)


# ----------------------------------------------------------------- config
@dataclass
class ElasticConfig:
    """Tuning for :func:`fit_elastic` / ``ParallelWrapper.fit(elastic=)``.

    ``lr_policy`` governs the learning-rate rescale on shrink. The
    GLOBAL batch is unchanged by a shrink (each survivor's rows grow), so
    the linear-scaling rule says the LR should not change — ``"none"``
    (the default) keeps the shrunk run equal to a fresh small-mesh fit.
    ``"linear"``/``"sqrt"`` scale by the survivor fraction (or its square
    root). ``participant`` names this rank to the coordinator (default
    ``rank<r>``, ``r`` its rank in the job's group); a peer's name is
    ``rank<r>`` too.
    """

    watchdog_deadline: Optional[float] = None   # soft, seconds; None = off
    watchdog_grace: Optional[float] = None      # hard; default 4x deadline
    watchdog_warmup: int = 2      # unsupervised warm-up dispatches/attempt
    probe_every: int = 1          # dispatches between health probes; 0 = off
    degraded_after: float = 0.25  # probe slower than this -> degraded
    max_shrinks: int = 4
    min_devices: int = 1
    lr_policy: str = "none"       # none | linear | sqrt
    coordinator: Optional[CoordinationService] = None
    participant: Optional[str] = None
    barrier_timeout: float = 60.0


# ------------------------------------------------------------------ driver
def fit_elastic(wrapper, iterator, epochs: int = 1,
                steps_per_dispatch: int = 1, checkpoint=None,
                nan_policy=None, faults=None,
                config: Optional[ElasticConfig] = None):
    """Elastic data-parallel fit over ``wrapper.mesh`` (see the module
    note). Every rank calls it with the same arguments. Requires
    ``checkpoint=CheckpointConfig(...)`` on a directory every rank reads:
    the shrink resumes from the coordinated checkpoint. The resilience
    features (``nan_policy``, fault injection, preemption, periodic
    saves) compose unchanged. A rank whose own device is lost raises
    :class:`RankLostError`."""
    from deeplearning4j_tpu_torch.train import resilience as _res

    cfg = config or ElasticConfig()
    if checkpoint is None:
        raise ValueError(
            "elastic training requires checkpoint=CheckpointConfig(...): "
            "the mesh-shrink path resumes from the coordinated checkpoint")
    if cfg.lr_policy not in ("none", "linear", "sqrt"):
        raise ValueError(f"unknown lr_policy {cfg.lr_policy!r} (expected "
                         "none|linear|sqrt)")
    model = wrapper.model
    if getattr(model, "_tbptt_length", lambda: None)() is not None:
        # its loop steps each batch whole (``_fit_one``): it would train a
        # truncated-BPTT net on whole sequences, unlike every other fit
        raise NotImplementedError(
            "elastic training does not run truncated BPTT yet: fit the net "
            "through ParallelWrapper.fit without elastic= or GSPMDTrainer")
    wrapper._attach()
    ranks = [d.id for d in wrapper.mesh.devices]
    names = {r: f"rank{r}" for r in ranks}
    me = _my_rank()
    if cfg.participant is not None:
        names[me] = cfg.participant
    coordinator = cfg.coordinator
    if coordinator is None:
        coordinator = StoreCoordinator([names[r] for r in ranks]) \
            if len(ranks) > 1 else InProcessCoordinator(1)
    session, stream_iter = _res.begin_session(model, iterator, checkpoint,
                                              nan_policy, faults)
    session.manager.job = _job_id(len(ranks))
    monitor = DeviceMonitor(degraded_after=cfg.degraded_after, plan=faults)
    watchdog = DispatchWatchdog(cfg.watchdog_deadline, cfg.watchdog_grace,
                                plan=faults, warmup=cfg.watchdog_warmup)
    model._dispatch_fence = DispatchFence()
    k = max(int(steps_per_dispatch), 1)
    target_epochs = _res.epoch_target(session, model, epochs)
    shrinks = 0
    try:
        while True:
            try:
                _run_epochs(wrapper, model, session, stream_iter,
                            target_epochs, k, monitor, watchdog, cfg,
                            coordinator, names)
                return model
            except _res.PreemptionRequested:
                session.on_preempt()
                return model
            except RankLostError:
                raise
            except DeviceLossError as e:
                shrinks += 1
                if shrinks > cfg.max_shrinks:
                    raise ElasticShrinkError(
                        f"{shrinks} mesh shrinks exceed max_shrinks="
                        f"{cfg.max_shrinks} — giving up") from e
                names = _shrink_and_resume(wrapper, model, session,
                                           stream_iter, e, cfg,
                                           coordinator, names)
    finally:
        model._dispatch_fence = None
        session.close(raise_errors=sys.exc_info()[1] is None)


def _job_id(n_ranks: int) -> str:
    """One id for this fit's checkpoints on every rank (rank 0's, sent to
    the others): a save keeps another writer's checkpoint of its step
    only when it carries this id."""
    import uuid
    ids = [uuid.uuid4().hex]
    if n_ranks > 1 and torch.distributed.is_initialized():
        torch.distributed.broadcast_object_list(ids, src=0)
    return ids[0]


def _run_epochs(wrapper, model, session, iterator, epochs, k, monitor,
                watchdog, cfg, coordinator, names):
    """The supervised epoch loop over the CURRENT mesh: each global batch
    padded and cut to this rank's rows, grouped into K-step megabatches,
    staged (a prefetcher's staged items die with it on a shrink) and
    dispatched under the watchdog, the ranks probed every
    ``probe_every`` dispatches."""
    from deeplearning4j_tpu_torch.data.dataset import (DevicePrefetcher,
                                                       stage_item)
    from deeplearning4j_tpu_torch.train.resilience import \
        PreemptionRequested
    from deeplearning4j_tpu_torch.train.stepping import (
        MegaBatch, group_into_megabatches)

    mesh = wrapper.mesh
    plan = model._sharding_plan
    watchdog.begin_attempt()    # the first dispatches on this mesh warm up
    n_epochs = max(epochs - model._epoch, 0)
    for _ in range(n_epochs):
        if not session.consume_skip_reset():
            iterator.reset()

        def local():
            while iterator.hasNext():
                yield plan.localize(iterator.next())

        stream = session.wrap_batches(local())
        dispatches = 0
        with ExitStack() as stack:
            if wrapper.prefetch and wrapper.prefetch > 0:
                items = stack.enter_context(DevicePrefetcher(
                    stream, steps_per_dispatch=k, prefetch=wrapper.prefetch,
                    device=model._device))
            else:   # thread-affine sources: inline staging
                items = (stage_item(it, model._device)
                         for it in group_into_megabatches(stream, k))
            it = iter(items)
            while True:
                try:
                    item = next(it)
                except StopIteration:
                    break
                except (PreemptionRequested, DeviceLossError):
                    raise
                except Exception as e:
                    _check_health(monitor, mesh, model._iteration, cause=e,
                                  coordinator=coordinator, names=names)
                    raise
                step0 = model._iteration + 1

                def fn(i=item):
                    if isinstance(i, MegaBatch):
                        model._fit_mega(i)
                    else:
                        model._fit_one(i)
                try:
                    watchdog.run(fn, step0)
                except DispatchTimeoutError as e:
                    # a hung dispatch: a dead rank is the usual cause — a
                    # confirmed loss shrinks, a healthy mesh surfaces the
                    # timeout (the abandoned step may have landed)
                    _check_health(monitor, mesh, step0, cause=e)
                    raise
                except (PreemptionRequested, DeviceLossError):
                    raise
                except RuntimeError as e:
                    # a collective that failed: a peer may be dead — the
                    # coordinator names it (or the plan does)
                    _check_health(monitor, mesh, model._iteration, cause=e,
                                  coordinator=coordinator, names=names)
                    raise
                dispatches += 1
                if cfg.probe_every and dispatches % cfg.probe_every == 0:
                    _check_health(monitor, mesh, model._iteration)
        model._epoch += 1
        session.on_epoch_end()


def _check_health(monitor, mesh, step: int, cause=None, coordinator=None,
                  names=None):
    """Probe the mesh's ranks; raise RankLostError when this rank is
    among the dead, DeviceLossError when a peer is. After a failed
    collective (``cause``) with nothing planned, a coordinator barrier
    confirms: a socket or file coordinator names the dead peer."""
    devices = mesh.devices
    health = monitor.probe(devices, step)
    dead = set(health.dead)
    named = None
    if not dead and cause is not None and coordinator is not None \
            and len(devices) > 1:
        from deeplearning4j_tpu_torch.distributed.coordinator import \
            DeadPeerError
        me = _my_rank()
        try:
            coordinator.resume_barrier(names[me], step, timeout=30.0)
        except DeadPeerError as e:
            by_name = {v: r for r, v in names.items()}
            if e.peer in by_name:
                dead.add(by_name[e.peer])
                named = e.peer
        except Exception:
            pass
    if dead:
        surviving = [d for d in devices if d.id not in dead]
        if _my_rank() in dead:
            raise RankLostError(dead, surviving, step, named) from cause
        raise DeviceLossError(dead, surviving, step, named) from cause


def _shrink_and_resume(wrapper, model, session, iterator,
                       loss: DeviceLossError, cfg: ElasticConfig,
                       coordinator: CoordinationService, names):
    """The coordinated shrink: retire the dead -> barrier -> the agreed
    step's checkpoint -> a group among the survivors -> revalidate -> LR
    rescale -> restore + data-pipeline rebind. Returns the survivors'
    participant names by their new ranks; ``model._last_shrink`` keeps
    what the shrink saw and did (its seconds, the step the loss was seen
    at, the agreed and the restored step, the dead participants and the
    one a coordinator named)."""
    from deeplearning4j_tpu_torch.parallel import init as _init
    from deeplearning4j_tpu_torch.parallel.mesh import DeviceMesh
    t0 = time.perf_counter()
    DEVICE_LOST.inc(len(loss.dead))
    logger.warning("rank loss at step %d: %s dead, %d surviving — "
                   "starting coordinated mesh shrink", loss.step,
                   sorted(loss.dead), len(loss.surviving))
    mesh = wrapper.mesh
    if mesh.size() != mesh.size("data"):
        # each rank of a model/seq/pipe line holds a piece nobody else
        # does: dropping one loses it (the shrink guard of
        # shrink_mesh_on_dead, for training)
        raise ElasticShrinkError(
            f"cannot shrink a mesh with axes {mesh.shape} beyond data: a "
            "tensor/sequence/pipeline-parallel piece would be lost") from loss
    if len(loss.surviving) < max(cfg.min_devices, 1):
        raise ElasticShrinkError(
            f"only {len(loss.surviving)} devices survive (< min_devices="
            f"{cfg.min_devices})") from loss
    me = _my_rank()
    survivors = sorted(d.id for d in loss.surviving)
    retire = getattr(coordinator, "retire", None)
    if retire is not None:
        for r in sorted(loss.dead):
            retire(names[r])
    # 1. resume barrier: the survivors agree on the last GLOBALLY
    #    completed step before anyone restarts
    agreed = coordinator.resume_barrier(names[me], int(model._iteration),
                                        timeout=cfg.barrier_timeout)
    # 2. the agreed step's checkpoint, written by the first survivor when
    #    it stands at it (state is replicated); anyone ahead rolls back
    if agreed == int(model._iteration):
        if me == survivors[0]:
            session.checkpoint(status="elastic-shrink", writer=True)
    else:
        logger.warning("resume barrier agreed on step %d (local %d): "
                       "rolling back to the agreed checkpoint", agreed,
                       model._iteration)
    if session.manager is not None:
        session.manager.flush()     # the restore needs it on disk
    if len(survivors) > 1:
        # everyone reads what the first survivor wrote
        coordinator.resume_barrier(names[me], agreed,
                                   timeout=cfg.barrier_timeout)
    # 3. the survivors' group and mesh, revalidated statically
    old_data = mesh.size("data")
    info = _init.distributed_info()
    if info is not None and info.process_count > 1:
        _init.reform_group([_init.rank_of_member(m) for m in survivors])
    new_mesh = DeviceMesh.data_parallel()
    _revalidate_shrink(model, session, new_mesh)
    # 4. each survivor's rows grew (the global batch did not); rescale
    _rescale_lr(model, cfg, old_data, len(survivors))

    # 5. restore THE AGREED checkpoint under the fence (an abandoned
    #    dispatch that un-hangs later commits nothing) and rebind the
    #    data pipeline
    wrapper.mesh = new_mesh
    wrapper._attach()

    def _restore():
        return session.manager.restore(model, normalizer=session.normalizer,
                                       count_resume=False, step=agreed)
    fence = getattr(model, "_dispatch_fence", None)
    if fence is not None:
        with fence.lock:
            fence.generation += 1
            restored = _restore()
    else:
        restored = _restore()
    if restored is None:
        raise ElasticShrinkError(
            f"mesh shrink: no valid checkpoint for the agreed step "
            f"{agreed} (the coordinated checkpoint is missing or failed "
            "validation)") from loss
    session._cursors.clear()        # pulled-ahead cursors are stale
    cursor = restored.get("cursor")
    if cursor is not None and iterator is not None:
        try:
            iterator.seek(cursor)
            session._skip_reset = True
        except NotImplementedError:
            warnings.warn(
                "elastic resume: iterator does not support seek(); "
                "replaying the interrupted epoch from its start",
                stacklevel=2)
    session._arm_next_save()
    MESH_SHRINKS.inc()
    dt = time.perf_counter() - t0
    RECOVERY_SECONDS.observe(dt)
    model._last_shrink = {
        "seconds": dt, "at": loss.step, "agreed": int(agreed),
        "restored": int(model._iteration),
        "dead": sorted(names[r] for r in loss.dead),
        "named_by_coordinator": loss.named_by_coordinator}
    logger.info("mesh shrink complete in %.3fs: data axis %d -> %d, "
                "resuming from step %d", dt, old_data, len(survivors),
                model._iteration)
    return {i: names[r] for i, r in enumerate(survivors)}


def _revalidate_shrink(model, session, new_mesh) -> None:
    """Static E1xx/W10x pass over the shrunk mesh. Non-E101 errors abort
    the shrink; E101 (batch not divisible by the new data axis) only
    warns — the batches are padded with zero-weight rows."""
    batch = None
    it = session.iterator
    if it is not None:
        try:
            b = it.batch()
            if isinstance(b, int) and b > 0:
                batch = b
        except Exception:
            batch = None
    try:
        report = model.validate(batch_size=batch, mesh=new_mesh.spec())
    except Exception as e:          # analysis must never block recovery
        logger.warning("elastic shrink: static revalidation failed (%s) — "
                       "continuing without it", e)
        return
    errors = report.errors()
    hard = [d for d in errors if d.code != "DL4J-E101"]
    if hard:
        raise ElasticShrinkError(
            "shrunk mesh fails static validation: "
            + "; ".join(f"{d.code}: {d.message}" for d in hard))
    for d in errors:
        warnings.warn(f"elastic shrink: {d.code}: {d.message} "
                      "(tail shards will be zero-weight padded)",
                      stacklevel=2)


def _rescale_lr(model, cfg: ElasticConfig, old_n: int, new_n: int):
    if cfg.lr_policy == "none" or old_n == new_n:
        return
    frac = new_n / float(old_n)
    if cfg.lr_policy == "linear":
        factor = frac
    elif cfg.lr_policy == "sqrt":
        factor = frac ** 0.5
    else:
        raise ValueError(f"unknown lr_policy {cfg.lr_policy!r} "
                         "(expected none|linear|sqrt)")
    model._set_lr_scale(model.lr_scale() * factor)
    logger.info("elastic shrink: lr scale x%.3g (policy=%s, %d -> %d "
                "replicas)", factor, cfg.lr_policy, old_n, new_n)
