"""Multi-model registry with zero-drop hot-swap on one card — the port
of ``deeplearning4j_tpu/serving/registry.py``.

One process serves many named models, each with versioned
:class:`~deeplearning4j_tpu_torch.serving.server.ModelServer` instances
on one device. Model *rolls* are routine operations a live fleet
performs under traffic, so they must never drop a request — and the new
version's bucket ladder is captured (the zero-recompile pin) BEFORE the
route moves.

The swap protocol:

1. ``load("m", model_v2, version=2, shapes=[(128,)])`` builds v2's
   server on the same card and ``warmup()``s every bucket x shape — v1
   keeps taking 100% of the traffic while v2 captures its graphs (each
   capture is thread-local and in v2's own memory pool, so v1's replays
   and copies neither disturb it nor are disturbed).
2. ``roll("m")`` lints the plan (``DL4J-W111`` when v2's warmed shapes
   do not cover what v1 serves), then atomically moves the route
   pointer under the registry lock. Requests admitted before the swap
   sit in v1's queue and complete there; requests admitted after land
   in v2's queue — every request resolves exactly once against exactly
   one version, because a request is owned by whichever server admitted
   it (``ServingRequest.server`` records which).
3. v1 stays loaded (graphs and all): ``rollback("m")`` swaps the pointer
   straight back — bit-identical, nothing is captured again.
   ``retire("m", 1)`` waits for v1's queue to empty and in-flight work
   to finish, then closes it (zero-drop by construction: retire refuses
   the active version).

Canary rolls: ``begin_canary("m", 2, fraction=0.1)`` routes a
deterministic fraction of unpinned submits to the staged version (a
credit accumulator under the registry lock — exactly
``round(n * fraction)`` of any n requests, no sampling noise), while the
active version keeps the rest. ``roll("m", 2)`` (or
:meth:`~ModelRegistry.promote_canary`) promotes it; a ``roll`` to any
OTHER version while a canary observes raises
:class:`CanaryInProgressError`. ``abort_canary("m")`` sends the
fraction back to the incumbent.

Routing is one locked pointer read per submit; the submit itself runs
outside the registry lock, so a slow admission on one model never
blocks routing for another.

Metrics: ``dl4j_registry_rolls_total{model=}``,
``dl4j_registry_active_version{model=}``,
``dl4j_registry_models`` (loaded names),
``dl4j_registry_versions{model=}`` (loaded versions per name),
``dl4j_registry_canary_version{model=}`` /
``dl4j_registry_canary_fraction{model=}`` (0 when no canary).

``load(..., tuned=True)`` applies the model's tuning record
(``tune.records``) before its server is built, so the bucket ladder
captures the tuned forward.

Sharded staging: ``ModelRegistry(mesh=)`` serves every version over a
mesh, and ``load(..., plan=)`` places the version's params (not its
updater state) per a ``ShardedTrainingPlan`` first, its mesh overriding
the registry's (a ``TransformerLM`` takes the Megatron layout over the
plan's mesh). Over more than one rank every rank builds the registry and
loads the same versions; the mesh's first rank serves and routes, and
the others call :meth:`ModelRegistry.follow`.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

from deeplearning4j_tpu_torch import profiler as _prof
from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.profiler import flightrec as _flightrec
from deeplearning4j_tpu_torch.profiler import tracecontext as _tracectx
from deeplearning4j_tpu_torch.serving.server import ModelServer

logger = logging.getLogger("deeplearning4j_tpu_torch")

_REG = _prof.get_registry()
ROLLS = _REG.counter(
    "dl4j_registry_rolls_total",
    "Route swaps per model name (rolls + rollbacks)",
    labelnames=("model",))
ACTIVE_VERSION = _REG.gauge(
    "dl4j_registry_active_version",
    "The version number currently routed for each model name",
    labelnames=("model",))
MODELS_GAUGE = _REG.gauge(
    "dl4j_registry_models",
    "Model names currently loaded in the registry")
VERSIONS_GAUGE = _REG.gauge(
    "dl4j_registry_versions",
    "Loaded (not retired) versions per model name",
    labelnames=("model",))
CANARY_VERSION = _REG.gauge(
    "dl4j_registry_canary_version",
    "The version receiving canary traffic per model name (0 = none)",
    labelnames=("model",))
CANARY_FRACTION = _REG.gauge(
    "dl4j_registry_canary_fraction",
    "Fraction of unpinned traffic routed to the canary (0 = none)",
    labelnames=("model",))


class ModelNotFoundError(KeyError):
    """No such model name (or version) in the registry — the ingress
    maps this to HTTP 404."""

    def __init__(self, name: str, version: Optional[int] = None):
        self.model = name
        self.version = version
        at = f" version {version}" if version is not None else ""
        super().__init__(f"model {name!r}{at} is not loaded")


class CanaryInProgressError(RuntimeError):
    """A second :meth:`ModelRegistry.roll` / :meth:`begin_canary` while
    a canary is still observing — refused, never interleaved: two
    overlapping observation windows would make neither attributable.
    Promote (roll TO the canary version), :meth:`abort_canary`, or
    wait."""

    def __init__(self, name: str, canary: int, fraction: float,
                 target: Optional[int] = None):
        self.model = name
        self.canary = canary
        self.fraction = fraction
        self.target = target
        extra = (f" while rolling to v{target}" if target is not None
                 and target != canary else "")
        super().__init__(
            f"model {name!r} has a canary in progress (v{canary} at "
            f"{fraction:.0%} of traffic){extra} — promote it, "
            "abort_canary(), or wait; interleaving rolls would make the "
            "observation window unattributable")


class RollbackTargetGoneError(ValueError):
    """:meth:`ModelRegistry.rollback` when the pre-roll incumbent has
    since been retired/evicted — there is no previous version left to
    restore. Structured (model + version attributes) so the caller can
    report it; subclasses ValueError, not KeyError, because
    the route itself exists."""

    def __init__(self, name: str, version: int):
        self.model = name
        self.version = version
        super().__init__(
            f"model {name!r} has no previous version to roll back to: "
            f"v{version} was retired after the roll — load it again and "
            "roll explicitly instead")


class _Version:
    __slots__ = ("version", "server", "shapes", "retired")

    def __init__(self, version: int, server: ModelServer, shapes):
        self.version = int(version)
        self.server = server
        self.shapes = [tuple(int(d) for d in s) for s in (shapes or [])]
        self.retired = False


class _Route:
    __slots__ = ("name", "versions", "active", "previous", "decode",
                 "reserved", "canary", "canary_fraction", "canary_acc",
                 "evicted_previous")

    def __init__(self, name: str):
        self.name = name
        self.versions: Dict[int, _Version] = {}
        self.active: Optional[int] = None
        self.previous: Optional[int] = None
        self.decode = None      # ingress decode preset (raw-image bodies)
        self.reserved: set = set()  # versions being built/warmed: picked
        # under the lock, registered later — a concurrent load must not
        # hand out the same number while warmup runs unlocked
        self.canary: Optional[int] = None   # version observing under a
        self.canary_fraction: float = 0.0   # fraction of unpinned traffic
        self.canary_acc: float = 0.0        # credit accumulator: gains
        # `fraction` per unpinned submit, fires a canary-routed request
        # each time it crosses 1.0 — deterministic, no sampling noise
        self.evicted_previous: Optional[int] = None  # what `previous`
        # pointed at when retire() nulled it — rollback() turns this
        # into RollbackTargetGoneError instead of a bare "no previous"

    def _clear_canary(self) -> Optional[int]:
        # lock held by caller; returns the version that was canarying
        ver, self.canary = self.canary, None
        self.canary_fraction = 0.0
        self.canary_acc = 0.0
        if ver is not None:
            CANARY_VERSION.labels(model=self.name).set(0)
            CANARY_FRACTION.labels(model=self.name).set(0.0)
        return ver


class ModelRegistry:
    """Named, versioned model servers behind one routing table (module
    doc for the swap protocol).

    Parameters
    ----------
    device : the card every version's server dispatches on (default
        ``cuda``; raises without a card unless ``device="cpu"``).
    mesh : the serving mesh every version's server dispatches on
        (default: this rank's device alone).
    **server_defaults : forwarded to every :class:`ModelServer` built by
        :meth:`load` (``batch_limit``, ``max_queue``, ``coalesce_ms``,
        ``default_deadline``, ``head``, ...); per-load kwargs override.
    """

    def __init__(self, device=None, mesh=None, **server_defaults):
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None \
            else mesh.device
        self._defaults = dict(server_defaults)
        self._lock = _prof.InstrumentedRLock("serving:registry")
        self._routes: Dict[str, _Route] = {}
        self._closed = False

    # ------------------------------------------------------------- loading
    def load(self, name: str, model, version: Optional[int] = None,
             shapes=None, decode=None, warm: bool = True,
             roll: Optional[bool] = None, plan=None, tuned: bool = False,
             **server_kw) -> int:
        """Load ``model`` as a new version of ``name`` and capture its
        bucket ladder while any active version keeps taking traffic.

        ``version`` defaults to ``max(existing) + 1`` (1 for a fresh
        name); ``shapes`` are the per-request feature shapes to warm
        (default: whatever the active version warmed); ``decode`` sets
        the route's raw-image decode preset (ingress); ``warm=False``
        skips warmup (``roll`` will then lint DL4J-W111). ``roll``
        defaults to "only when this is the first version" — an upgrade
        stays staged until an explicit :meth:`roll`. ``plan`` (a
        ``ShardedTrainingPlan``) stages the version on a sharded mesh:
        params are placed per the plan (not the updater state: an
        inference load allocates no moments) before the server builds,
        and the plan's mesh overrides the registry's. ``tuned=True``
        applies the model's tuning record first. Returns the version
        number."""
        with self._lock:
            if self._closed:
                raise RuntimeError("registry is closed")
            route = self._routes.get(name)
            if route is None:
                route = self._routes[name] = _Route(name)
            if version is None:
                version = max(max(route.versions, default=0),
                              max(route.reserved, default=0)) + 1
            version = int(version)
            if version in route.versions or version in route.reserved:
                raise ValueError(
                    f"model {name!r} version {version} is already loaded "
                    "(or loading) — unload it first, or pick a new version")
            route.reserved.add(version)
            if shapes is None and route.active is not None:
                shapes = list(
                    route.versions[route.active].server._warm_shapes)
            if decode is not None:
                route.decode = decode
            first = route.active is None
        server = None
        try:
            kw = dict(self._defaults)
            kw.update(server_kw)
            if plan is not None:
                model.setShardingPlan(plan)
                if hasattr(model, "_items"):
                    plan.place_params(model)
                kw.setdefault("mesh", plan.mesh)
            if self.mesh is not None:
                kw.setdefault("mesh", self.mesh)
            kw.setdefault("device", self.device)
            if tuned:
                # before the server builds, outside the registry lock:
                # the ladder captures the tuned forward
                from deeplearning4j_tpu_torch.tune import records as _trec
                _trec.auto_apply(model, context="registry.load")
            server = ModelServer(model, name=f"{name}:v{version}", **kw)
            if warm and shapes:
                # the expensive step, deliberately OUTSIDE the registry
                # lock: v1 keeps routing and serving while v2 captures
                server.warmup(shapes)
        except BaseException:
            # a bad config/shape must not leak an unrouted serve thread
            # (the version was never registered) or a dead reservation
            if server is not None:
                server.close()
            with self._lock:
                route.reserved.discard(version)
            raise
        ver = _Version(version, server, shapes)
        with self._lock:
            route.reserved.discard(version)
            route.versions[version] = ver
            self._gauges(route)
        if roll if roll is not None else first:
            self.roll(name, version)
        logger.info("registry: loaded %s v%d (%swarmed)%s", name, version,
                    "" if server._warmed else "NOT ",
                    " [active]" if self.active_version(name) == version
                    else "")
        return version

    def follow(self) -> str:
        """A follower rank's part of serving over a mesh: join the
        dispatches of every version loaded here (load the same versions
        as the leader first) until the leader has closed them all
        (``"stopped"``) or the fault plan takes this rank (``"lost"``)."""
        from deeplearning4j_tpu_torch.parallel.leader import follow_all
        with self._lock:
            servers = [v.server for r in self._routes.values()
                       for v in r.versions.values()
                       if v.server._mesh_dispatch is not None]
        if not servers:
            raise RuntimeError("follow(): no version here serves over a "
                               "mesh of more than one rank")
        if servers[0].is_leader:
            raise RuntimeError("follow(): this rank leads the mesh")
        return follow_all(servers[0]._mesh_dispatch.mesh,
                          {s._mesh_dispatch.key: s._mesh_dispatch
                           for s in servers})

    # ------------------------------------------------------------- routing
    def _route(self, name: str) -> _Route:
        route = self._routes.get(name)
        if route is None:
            raise ModelNotFoundError(name)
        return route

    def _version(self, name: str, version: Optional[int] = None) -> _Version:
        with self._lock:
            route = self._route(name)
            v = route.active if version is None else int(version)
            if v is None:
                raise ModelNotFoundError(name)
            ver = route.versions.get(v)
            if ver is None or ver.retired:
                raise ModelNotFoundError(name, v)
            return ver

    def server(self, name: str, version: Optional[int] = None) -> ModelServer:
        """The routed (or explicitly versioned) server for ``name``."""
        return self._version(name, version).server

    def _pick_submit(self, name: str, version: Optional[int]):
        """Route one unpinned submit, canary-aware: under the lock the
        credit accumulator gains ``canary_fraction``; each time it
        crosses 1.0 one request is routed to the canary version —
        exactly ``round(n * fraction)`` of any n unpinned submits, a
        deterministic interleave rather than a coin flip. Pinned
        (``version=``) submits never count against the accumulator.
        Returns ``(server, is_canary)``."""
        with self._lock:
            route = self._route(name)
            if version is None and route.canary is not None:
                route.canary_acc += route.canary_fraction
                if route.canary_acc >= 1.0 - 1e-9:
                    route.canary_acc -= 1.0
                    ver = route.versions.get(route.canary)
                    if ver is not None and not ver.retired:
                        return ver.server, True
            v = route.active if version is None else int(version)
            if v is None:
                raise ModelNotFoundError(name)
            ver = route.versions.get(v)
            if ver is None or ver.retired:
                raise ModelNotFoundError(name, v)
            return ver.server, False

    def active_version(self, name: str) -> Optional[int]:
        with self._lock:
            return self._route(name).active

    def decode_preset(self, name: str):
        with self._lock:
            return self._route(name).decode

    def submit(self, name: str, x, deadline: Optional[float] = None,
               version: Optional[int] = None, trace=None):
        """Route one request: a locked pointer read picks the server,
        the admission itself runs outside the registry lock. The
        returned :class:`ServingRequest` is owned by exactly that
        server (``req.server`` says which ``name:vN``), so a roll
        racing this submit can never double-resolve or drop it.
        ``trace`` propagates the caller's trace context; the route
        decision records a ``serve:route`` span whose ``server`` arg
        makes a hot-swap re-route visible as a version change."""
        t0_us = _prof.now_us()
        ctx = (trace if trace is not None
               else _tracectx.TraceContext.new())
        server, is_canary = self._pick_submit(name, version)
        _tracectx.record_span(
            "serve:route", ctx.child(), t0_us, _prof.now_us() - t0_us,
            args={"model": name, "server": server.name,
                  "pinned_version": version, "canary": is_canary})
        return server.submit(x, deadline=deadline, trace=ctx)

    def output(self, name: str, x, timeout: float = 30.0,
               deadline: Optional[float] = None,
               version: Optional[int] = None):
        return self.submit(name, x, deadline=deadline,
                           version=version).get(timeout)

    # ------------------------------------------------------------- rolling
    def validate_roll(self, name: str, version: Optional[int] = None):
        """Static pre-roll lint (``DL4J-W111``): is the target warmed,
        and does its warmed shape set cover what the active version
        serves?"""
        from deeplearning4j_tpu_torch.analysis.serving import lint_registry_roll
        with self._lock:
            route = self._route(name)
            version = self._pick_roll_target(route, version)
            target = route.versions[version].server
            active = (route.versions[route.active].server
                      if route.active is not None
                      and route.active != version else None)
        return lint_registry_roll(f"{name} v{route.active}->v{version}",
                                  target, active=active)

    def _pick_roll_target(self, route: _Route, version) -> int:
        # lock held by caller
        if version is None:
            staged = [v for v, ver in route.versions.items()
                      if v != route.active and not ver.retired]
            if not staged:
                raise ValueError(
                    f"model {route.name!r} has no staged version to roll "
                    "to (load one first)")
            version = max(staged)
        version = int(version)
        ver = route.versions.get(version)
        if ver is None or ver.retired:
            raise ModelNotFoundError(route.name, version)
        return version

    def roll(self, name: str, version: Optional[int] = None,
             strict: bool = False) -> Optional[int]:
        """Atomically move ``name``'s route to ``version`` (default: the
        newest staged one). Runs :meth:`validate_roll` first —
        ``strict=True`` refuses a W111-flagged roll, otherwise findings
        surface as warnings. Returns the previously active version.
        In-flight and already-queued requests complete on the version
        that admitted them; nothing is drained or dropped. While a
        canary observes, only a roll TO the canary version is allowed
        (that is the promote: the swap clears the canary state in the
        same critical section); any other target raises
        :class:`CanaryInProgressError`."""
        with self._lock:
            # pin the target BEFORE linting: a concurrent load() staging
            # a newer (possibly unwarmed) version between the lint and
            # the swap must not silently become the rolled-to version
            route = self._route(name)
            version = self._pick_roll_target(route, version)
            if route.canary is not None and version != route.canary:
                raise CanaryInProgressError(
                    name, route.canary, route.canary_fraction,
                    target=version)
        report = self.validate_roll(name, version)
        if strict and report.diagnostics:
            from deeplearning4j_tpu_torch.analysis.diagnostics import \
                ModelValidationError
            raise ModelValidationError(report)
        import warnings as _warnings
        for d in report.diagnostics:
            _warnings.warn(f"registry roll: {d.code}: {d.message}",
                           stacklevel=2)
        with self._lock:
            route = self._route(name)
            version = self._pick_roll_target(route, version)
            if route.canary is not None and version != route.canary:
                raise CanaryInProgressError(
                    name, route.canary, route.canary_fraction,
                    target=version)
            prev = route.active
            route.previous = prev
            route.evicted_previous = None
            route.active = version
            promoted = route._clear_canary() is not None
            self._gauges(route)
        ROLLS.labels(model=name).inc()
        _flightrec.get_flight_recorder().record(
            "registry:roll", model=name, previous=prev, active=version,
            promoted_canary=promoted)
        logger.info("registry: rolled %s v%s -> v%d%s", name, prev, version,
                    " (canary promoted)" if promoted else "")
        return prev

    def rollback(self, name: str) -> int:
        """Swap the route back to the version active before the last
        :meth:`roll` — the old server is still loaded with its graphs, so
        the restored traffic is bit-identical to pre-roll. A canary in
        progress is aborted in the same critical section (its fraction
        returns to the restored incumbent). Raises
        :class:`RollbackTargetGoneError` when the pre-roll incumbent
        has since been retired."""
        with self._lock:
            route = self._route(name)
            prev = route.previous
            if prev is None:
                if route.evicted_previous is not None:
                    raise RollbackTargetGoneError(
                        name, route.evicted_previous)
                raise ValueError(f"model {name!r} has no previous version "
                                 "to roll back to")
            ver = route.versions.get(prev)
            if ver is None or ver.retired:
                raise RollbackTargetGoneError(name, prev)
            route.previous = route.active
            route.active = prev
            aborted = route._clear_canary()
            self._gauges(route)
        ROLLS.labels(model=name).inc()
        _flightrec.get_flight_recorder().record(
            "registry:rollback", model=name, active=prev,
            aborted_canary=aborted)
        logger.info("registry: rolled back %s -> v%d", name, prev)
        return prev

    # -------------------------------------------------------------- canary
    def begin_canary(self, name: str, version: Optional[int] = None,
                     fraction: float = 0.1, strict: bool = False) -> int:
        """Start routing ``fraction`` of ``name``'s unpinned traffic to
        ``version`` (default: newest staged) through the normal dispatch
        path, while the active version keeps the rest. The split is a
        deterministic credit accumulator, not sampling: any n submits
        send exactly ``round(n * fraction)`` to the canary. Runs the
        same pre-roll lint as :meth:`roll` (the canary serves real
        traffic — an unwarmed ladder would capture under it). Refuses
        (:class:`CanaryInProgressError`) while another canary observes.
        Promote with :meth:`roll`/:meth:`promote_canary`, abandon with
        :meth:`abort_canary`. Returns the canary version."""
        if not 0.0 < fraction < 1.0:
            raise ValueError(
                f"canary fraction must be in (0, 1), got {fraction!r} — "
                "1.0 is a roll, 0.0 is a no-op")
        with self._lock:
            route = self._route(name)
            if route.canary is not None:
                raise CanaryInProgressError(name, route.canary,
                                            route.canary_fraction)
            if route.active is None:
                raise ValueError(
                    f"model {name!r} has no active version to canary "
                    "against — the first version just rolls")
            version = self._pick_roll_target(route, version)
            if version == route.active:
                raise ValueError(
                    f"model {name!r} v{version} is already the active "
                    "version — nothing to canary")
        report = self.validate_roll(name, version)
        if strict and report.diagnostics:
            from deeplearning4j_tpu_torch.analysis.diagnostics import \
                ModelValidationError
            raise ModelValidationError(report)
        import warnings as _warnings
        for d in report.diagnostics:
            _warnings.warn(f"registry canary: {d.code}: {d.message}",
                           stacklevel=2)
        with self._lock:
            route = self._route(name)
            version = self._pick_roll_target(route, version)
            if route.canary is not None:
                raise CanaryInProgressError(name, route.canary,
                                            route.canary_fraction)
            route.canary = version
            route.canary_fraction = float(fraction)
            route.canary_acc = 0.0
            CANARY_VERSION.labels(model=name).set(version)
            CANARY_FRACTION.labels(model=name).set(float(fraction))
        _flightrec.get_flight_recorder().record(
            "registry:canary_begin", model=name, canary=version,
            fraction=float(fraction), incumbent=self.active_version(name))
        logger.info("registry: canary %s v%d at %.0f%% of traffic",
                    name, version, fraction * 100.0)
        return version

    def promote_canary(self, name: str, strict: bool = False) -> int:
        """Roll to the observing canary version (the canary state clears
        atomically with the swap). Returns the canary version now
        active."""
        with self._lock:
            route = self._route(name)
            if route.canary is None:
                raise ValueError(
                    f"model {name!r} has no canary in progress to promote")
            target = route.canary
        self.roll(name, target, strict=strict)
        return target

    def abort_canary(self, name: str) -> Optional[int]:
        """Stop a canary: its traffic fraction returns to the incumbent.
        The canary version STAYS loaded and warmed (quarantine/retire is
        the caller's policy call). Idempotent — returns the version that
        was observing, or None."""
        with self._lock:
            route = self._route(name)
            ver = route._clear_canary()
        if ver is not None:
            _flightrec.get_flight_recorder().record(
                "registry:canary_abort", model=name, canary=ver)
            logger.info("registry: canary aborted %s v%d", name, ver)
        return ver

    def canary(self, name: str) -> Optional[dict]:
        """The observing canary for ``name`` as ``{"version", "fraction"}``,
        or None."""
        with self._lock:
            route = self._route(name)
            if route.canary is None:
                return None
            return {"version": route.canary,
                    "fraction": route.canary_fraction}

    # ----------------------------------------------------------- retirement
    def retire(self, name: str, version: int, timeout: float = 30.0) -> None:
        """Close a non-active version AFTER its remaining work finishes:
        wait (bounded) for its queue to empty and in-flight batches to
        complete, then drain+close. Refuses the active version — that
        would drop routed traffic — and raises TimeoutError (leaving
        the version serving) if the queue has not emptied within
        ``timeout``: retire never fails a request."""
        with self._lock:
            route = self._route(name)
            if route.active == int(version):
                raise ValueError(
                    f"refusing to retire {name!r} v{version}: it is the "
                    "active route (roll first)")
            if route.canary == int(version):
                raise ValueError(
                    f"refusing to retire {name!r} v{version}: it is the "
                    "observing canary (promote or abort_canary first)")
            ver = route.versions.get(int(version))
            if ver is None:
                raise ModelNotFoundError(name, version)
            if ver.retired:
                return
        deadline = time.monotonic() + timeout
        server = ver.server
        while time.monotonic() < deadline and server.queue_depth() > 0:
            time.sleep(0.01)
        if server.queue_depth() > 0:
            # closing now would fail the queued requests — leave the
            # version serving instead; zero-drop beats fast retirement
            raise TimeoutError(
                f"retire {name!r} v{version}: {server.queue_depth()} "
                f"request(s) still queued after {timeout:g}s — retrying "
                "later keeps retire zero-drop")
        # drain() completes the in-flight batch; the queue is empty, so
        # nothing is failed — retire stays zero-drop
        server.close()
        with self._lock:
            ver.retired = True
            if route.previous == ver.version:
                # remember WHAT was evicted: a later rollback() raises
                # the structured RollbackTargetGoneError, not a bare
                # "no previous"
                route.previous = None
                route.evicted_previous = ver.version
            self._gauges(route)

    def unload(self, name: str) -> None:
        """Remove a model name entirely: close every version (draining
        each; queued requests fail with the retriable draining error)."""
        with self._lock:
            route = self._routes.pop(name, None)
            if route is None:
                raise ModelNotFoundError(name)
            MODELS_GAUGE.set(len(self._routes))
        for ver in route.versions.values():
            if not ver.retired:
                ver.server.close()

    # ---------------------------------------------------------- introspection
    def _gauges(self, route: _Route) -> None:
        # lock held by caller
        MODELS_GAUGE.set(len(self._routes))
        VERSIONS_GAUGE.labels(model=route.name).set(
            sum(1 for v in route.versions.values() if not v.retired))
        if route.active is not None:
            ACTIVE_VERSION.labels(model=route.name).set(route.active)

    def models(self) -> dict:
        """Snapshot for ``GET /v1/models``: per name — active version,
        loaded versions with state/readiness, decode preset presence."""
        with self._lock:
            routes = list(self._routes.values())
        out = {}
        for route in routes:
            with self._lock:
                vers = dict(route.versions)
                active, previous = route.active, route.previous
                canary, frac = route.canary, route.canary_fraction
                has_decode = route.decode is not None
            out[route.name] = {
                "active": active,
                "previous": previous,
                "canary": canary,
                "canary_fraction": frac,
                "accepts_images": has_decode,
                "versions": {
                    v: {"state": ver.server.state,
                        "ready": ver.server.ready,
                        "retired": ver.retired,
                        "warmed_shapes": [list(s) for s in
                                          ver.server._warm_shapes]}
                    for v, ver in sorted(vers.items())},
            }
        return out

    def load_hints(self) -> dict:
        """Aggregated autoscaling hints for ``GET /v1/load``: the active
        server's :meth:`~ModelServer.load_hints` per model plus fleet
        totals a load balancer can threshold on."""
        with self._lock:
            actives = [(r.name, r.versions[r.active],
                        r.versions.get(r.canary)
                        if r.canary is not None else None,
                        r.canary_fraction)
                       for r in self._routes.values()
                       if r.active is not None]
        per_model = {}
        for name, ver, canary_ver, frac in actives:
            hints = ver.server.load_hints()
            hints["version"] = ver.version
            if canary_ver is not None and not canary_ver.retired:
                # the canary's own hints ride along so whoever rolls
                # (and any load balancer) can watch its p99/shed-rate
                # separately from the incumbent's
                chints = canary_ver.server.load_hints()
                chints["version"] = canary_ver.version
                chints["fraction"] = frac
                hints["canary"] = chints
            per_model[name] = hints
        n = len(per_model)
        return {
            "models": per_model,
            "totals": {
                "queue_depth": sum(h["queue_depth"]
                                   for h in per_model.values()),
                "max_queue": sum(h["max_queue"]
                                 for h in per_model.values()),
                "shed_rate": (sum(h["shed_rate"]
                                  for h in per_model.values()) / n
                              if n else 0.0),
                "ready": all(h["ready"] for h in per_model.values())
                if n else False,
                "breakers_open": sum(1 for h in per_model.values()
                                     if h["breaker"] == "open"),
            },
        }

    @property
    def ready(self) -> bool:
        """Every routed model warmed and admitting (what /readyz
        aggregates)."""
        with self._lock:
            actives = [r.versions[r.active].server
                       for r in self._routes.values()
                       if r.active is not None]
        return bool(actives) and all(s.ready for s in actives)

    @property
    def healthy(self) -> bool:
        with self._lock:
            actives = [r.versions[r.active].server
                       for r in self._routes.values()
                       if r.active is not None]
        return all(s.healthy for s in actives)

    # -------------------------------------------------------------- teardown
    def close(self) -> None:
        """Close every loaded server (each drains; queued requests fail
        with the retriable draining error). Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            routes = list(self._routes.values())
        for route in routes:
            for ver in route.versions.values():
                if not ver.retired:
                    ver.server.close()

    def __enter__(self) -> "ModelRegistry":
        return self

    def __exit__(self, *exc):
        self.close()
