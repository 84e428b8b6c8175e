"""Multi-process coordination (tier 3): socket/file barrier service — the
port of ``deeplearning4j_tpu/distributed/coordinator.py`` (standard
library code over the port's profiler, flight recorder and trace
context).

The elastic resume barrier's contract
(:class:`~deeplearning4j_tpu_torch.parallel.elastic.CoordinationService`)
across OS processes and hosts, so ``fit_elastic`` coordinates real
multi-rank jobs:

- :class:`SocketCoordinatorServer` — a tiny TCP rendezvous (one
  JSON-line request/response per connection, no long-lived framing to
  get wrong) run by any one process (typically rank 0 or a sidecar).
  It implements the SAME barrier protocol the in-process coordinator
  pins: every participant reports its last locally completed step, the
  agreed step is the MINIMUM, barriers are reusable (generation
  counter), and a participant that stops heartbeating while a round is
  pending fails the round for everyone with a structured
  :class:`DeadPeerError` instead of letting the survivors block until
  their own timeouts.
- :class:`SocketCoordinator` — the client-side
  ``CoordinationService``: background heartbeat thread + one blocking
  barrier request. Plugs straight into ``ElasticConfig(coordinator=)``.
- :class:`FileCoordinator` — the shared-filesystem fallback for
  clusters where an extra port is harder than an NFS mount: barrier
  arrival files + heartbeat mtimes under one directory, same
  agreement/dead-peer semantics.

Wire protocol (one JSON object per line, UTF-8, one request per
connection)::

    -> {"op": "hello",     "participant": "p0"}
    <- {"ok": true, "generation": 0}
    -> {"op": "heartbeat", "participant": "p0"}
    <- {"ok": true}
    -> {"op": "barrier",   "participant": "p0", "step": 12, "timeout": 30}
    <- {"ok": true, "step": 7, "generation": 0}            # agreed min
    <- {"ok": false, "error": "dead_peer", "peer": "p1"}   # peer died
    <- {"ok": false, "error": "timeout", "arrived": 1, "expected": 2}
    -> {"op": "retire",    "participant": "p0", "peer": "p1"}
    <- {"ok": true, "participants": 1}                     # p1 dropped

``retire`` (the port's addition) is how the survivors of a rank's death
go on: the dead peer leaves the membership and the expected count, so
the next barrier agrees among the survivors.

Metrics: ``dl4j_coord_barrier_seconds`` (barrier wall time, labelled by
implementation), ``dl4j_coord_dead_peers_total``.

Fault injection: the server accepts a
:class:`~deeplearning4j_tpu_torch.faults.FaultPlan` whose
``coord_peer_death`` kind freezes a planned participant's heartbeats
from a planned barrier generation on — every dead-peer path is a
seeded deterministic chaos test, like the rest of the resilience
stack.
"""

from __future__ import annotations

import json
import os
import socket
import threading
import time
from typing import Dict, Tuple

from deeplearning4j_tpu_torch import profiler as _prof
from deeplearning4j_tpu_torch.parallel.elastic import CoordinationService
from deeplearning4j_tpu_torch.profiler import flightrec as _flightrec
from deeplearning4j_tpu_torch.profiler import tracecontext as _tracectx

BARRIER_SECONDS = _prof.get_registry().histogram(
    "dl4j_coord_barrier_seconds",
    "Resume-barrier wall time per participant (arrival to agreement)",
    labelnames=("impl",))
DEAD_PEERS = _prof.get_registry().counter(
    "dl4j_coord_dead_peers_total",
    "Barrier rounds failed because a participant stopped heartbeating")


class DeadPeerError(RuntimeError):
    """A barrier round failed because a participant stopped
    heartbeating. ``peer`` is the dead participant, ``generation`` the
    failed barrier round — the structured error the elastic layer (or
    an operator) acts on, instead of N independent timeouts."""

    def __init__(self, peer: str, generation: int):
        self.peer = str(peer)
        self.generation = int(generation)
        super().__init__(
            f"coordination barrier generation {generation} failed: "
            f"participant {peer!r} stopped heartbeating (dead peer)")


class BarrierProtocolError(RuntimeError):
    """Malformed/unexpected coordinator reply (wire-level failure)."""


# --------------------------------------------------------------- server
class SocketCoordinatorServer:
    """TCP rendezvous for ``participants`` processes (see module doc).

    ``heartbeat_timeout``: a participant that has contacted the server
    at least once and then goes silent longer than this while a barrier
    round is pending is declared dead — the round fails for every
    waiter with a structured ``dead_peer`` reply. ``plan`` injects the
    ``coord_peer_death`` fault kind deterministically.
    """

    def __init__(self, participants: int, host: str = "127.0.0.1",
                 port: int = 0, heartbeat_timeout: float = 5.0, plan=None):
        self.participants = int(participants)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.plan = plan
        self._cond = _prof.InstrumentedCondition("coord:server")
        self._generation = 0
        self._round: Dict[str, int] = {}
        self._results: Dict[int, int] = {}
        self._failures: Dict[int, Dict] = {}
        self._last_seen: Dict[str, float] = {}
        self._meta: Dict[str, Dict] = {}    # hello-advertised, per peer
        self._closed = False
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(16)
        self.host, self.port = self._sock.getsockname()[:2]
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="dl4j-coord-accept")
        self._accept_thread.start()
        self._monitor_thread = threading.Thread(
            target=self._monitor_loop, daemon=True, name="dl4j-coord-monitor")
        self._monitor_thread.start()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    def _is_closed(self) -> bool:
        with self._cond:
            return self._closed

    # ------------------------------------------------------------- wire
    def _accept_loop(self):
        while not self._is_closed():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return          # socket closed
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn: socket.socket):
        try:
            with conn:
                f = conn.makefile("rwb")
                line = f.readline()
                if not line:
                    return
                try:
                    msg = json.loads(line.decode("utf-8"))
                except json.JSONDecodeError:
                    self._reply(f, {"ok": False, "error": "bad_request"})
                    return
                op = msg.get("op")
                participant = str(msg.get("participant", ""))
                if op == "hello":
                    self._touch(participant)
                    meta = msg.get("meta")
                    with self._cond:
                        gen = self._generation
                        if isinstance(meta, dict):
                            # hello-advertised metadata (e.g. a
                            # metrics_url) — what FleetScraper reads
                            # off members() to build scrape targets
                            self._meta[participant] = dict(meta)
                    self._reply(f, {"ok": True, "generation": gen})
                elif op == "heartbeat":
                    self._touch(participant)
                    self._reply(f, {"ok": True})
                elif op == "barrier":
                    self._reply(f, self._barrier(
                        participant, int(msg.get("step", 0)),
                        float(msg.get("timeout", 60.0)),
                        trace=msg.get("trace")))
                elif op == "retire":
                    self._reply(f, {"ok": True, "participants":
                                    self.retire(str(msg.get("peer", "")))})
                else:
                    self._reply(f, {"ok": False, "error": "bad_op",
                                    "op": op})
        except (OSError, ValueError):
            pass                # client went away mid-reply

    @staticmethod
    def _reply(f, payload: Dict):
        f.write((json.dumps(payload) + "\n").encode("utf-8"))
        f.flush()

    def _touch(self, participant: str):
        if not participant:
            return
        with self._cond:
            if participant not in self._last_seen:
                # first contact always registers (the dead-peer detector
                # can only suspect peers it has seen); a planned-dead
                # peer's REFRESHES are what stop counting
                self._last_seen[participant] = time.monotonic()
            elif not self._peer_planned_dead(participant):
                self._last_seen[participant] = time.monotonic()

    def _prune(self, gen: int, keep: int = 8):
        """Drop result/failure entries no waiter can read anymore — a
        long-lived coordinator sidecar must not leak one entry per
        barrier generation. ``keep`` generations of history cover any
        waiter still draining out of an old round. Caller holds the
        lock."""
        for stale in [g for g in self._results if g <= gen - keep]:
            del self._results[stale]
        for stale in [g for g in self._failures if g <= gen - keep]:
            del self._failures[stale]

    def _peer_planned_dead(self, participant: str) -> bool:
        """The coord_peer_death fault seam: a planned-dead peer's
        heartbeats stop counting from its planned generation on."""
        plan = self.plan
        if plan is None:
            return False
        dead = getattr(plan, "coord_peer_dead", None)
        return bool(dead and dead(participant, self._generation))

    def retire(self, peer: str) -> int:
        """Drop a dead ``peer``: out of the membership, the pending round
        and the expected count (once). Returns the participants left."""
        with self._cond:
            if peer in self._last_seen:
                del self._last_seen[peer]
                self._meta.pop(peer, None)
                self._round.pop(peer, None)
                self.participants = max(self.participants - 1, 1)
                self._cond.notify_all()
            return self.participants

    def members(self, fresh_within: float = None) -> Dict[str, Dict]:
        """Membership snapshot: participant -> {"age": seconds since
        last contact, "meta": hello-advertised dict}. ``fresh_within``
        filters to peers heard from that recently (default: the
        heartbeat timeout) — dead hosts fall out of the view, and so
        out of any scrape-target list built from it."""
        bound = (self.heartbeat_timeout if fresh_within is None
                 else float(fresh_within))
        now = time.monotonic()
        with self._cond:
            return {p: {"age": now - seen,
                        "meta": dict(self._meta.get(p, {}))}
                    for p, seen in self._last_seen.items()
                    if now - seen <= bound}

    # ---------------------------------------------------------- barrier
    def _barrier(self, participant: str, step: int, timeout: float,
                 trace=None) -> Dict:
        """One participant's barrier arrival. ``trace`` is the client's
        traceparent riding the wire: the server-side round span becomes
        its child, so a multi-process barrier stitches into one trace."""
        ctx = _tracectx.TraceContext.from_traceparent(trace)
        t0_us = _prof.now_us()
        reply = self._barrier_inner(participant, step, timeout)
        _tracectx.record_span(
            "coord:round", ctx.child() if ctx is not None else None,
            t0_us, _prof.now_us() - t0_us,
            args={"participant": participant, "step": int(step),
                  "ok": bool(reply.get("ok")),
                  "generation": reply.get("generation")})
        return reply

    def _barrier_inner(self, participant: str, step: int,
                       timeout: float) -> Dict:
        t0 = time.perf_counter()
        with self._cond:
            if not self._peer_planned_dead(participant):
                self._last_seen[participant] = time.monotonic()
            gen = self._generation
            self._round[participant] = int(step)
            if len(self._round) >= self.participants:
                self._results[gen] = min(self._round.values())
                self._round = {}
                self._generation += 1
                self._prune(gen)
                self._cond.notify_all()
            else:
                deadline = time.monotonic() + timeout
                while (gen not in self._results
                       and gen not in self._failures):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        arrived = len(self._round)
                        self._round.pop(participant, None)
                        return {"ok": False, "error": "timeout",
                                "arrived": arrived,
                                "expected": self.participants,
                                "generation": gen}
                    self._cond.wait(min(remaining, 0.25))
            if gen in self._failures:
                return dict(self._failures[gen], ok=False)
            BARRIER_SECONDS.labels(impl="socket").observe(
                time.perf_counter() - t0)
            return {"ok": True, "step": self._results[gen],
                    "generation": gen}

    def _monitor_loop(self):
        """Dead-peer detection: while a round is pending, any participant
        the server has EVER seen whose heartbeat is stale fails the
        round for all waiters."""
        while not self._is_closed():
            time.sleep(min(self.heartbeat_timeout / 4.0, 0.25))
            died = None
            with self._cond:
                if not self._round:
                    continue
                gen = self._generation
                now = time.monotonic()
                for peer, seen in list(self._last_seen.items()):
                    if peer in self._round:
                        continue        # already arrived: not a suspect
                    stale = now - seen > self.heartbeat_timeout
                    if stale or self._peer_planned_dead(peer):
                        self._failures[gen] = {"error": "dead_peer",
                                               "peer": peer,
                                               "generation": gen}
                        self._round = {}
                        self._generation += 1
                        self._prune(gen)
                        DEAD_PEERS.inc()
                        self._cond.notify_all()
                        died = (peer, gen, now - seen)
                        break
            if died is not None:
                # outside the lock: the dump walks the metrics registry
                # and writes files — never under the barrier condvar
                rec = _flightrec.get_flight_recorder()
                rec.record("coord:dead_peer", peer=died[0],
                           generation=died[1], stale_seconds=died[2])
                rec.dump("dead_peer")

    def close(self):
        with self._cond:
            self._closed = True
            # fail any still-pending round so waiters unblock
            if self._round:
                self._failures[self._generation] = {
                    "error": "server_closed",
                    "generation": self._generation}
                self._round = {}
                self._generation += 1
            self._cond.notify_all()
        try:
            self._sock.close()      # unblocks the accept loop
        except OSError:
            pass
        self._accept_thread.join(timeout=2.0)
        self._monitor_thread.join(timeout=2.0)

    def __enter__(self) -> "SocketCoordinatorServer":
        return self

    def __exit__(self, *exc):
        self.close()


# --------------------------------------------------------------- client
def _parse_address(address) -> Tuple[str, int]:
    if isinstance(address, (tuple, list)):
        return str(address[0]), int(address[1])
    host, _, port = str(address).rpartition(":")
    return host or "127.0.0.1", int(port)


class SocketCoordinator(CoordinationService):
    """Client-side ``CoordinationService`` over the socket protocol.

    ``participant`` is this process's identity; a background thread
    heartbeats every ``heartbeat_interval`` seconds so the server's
    dead-peer detector can tell a slow participant from a dead one.
    Plugs into ``ElasticConfig(coordinator=...)`` unchanged — the
    resume-barrier contract is the in-process coordinator's.
    """

    def __init__(self, address, participant: str = None,
                 heartbeat_interval: float = 1.0, connect_timeout: float = 5.0):
        self.host, self.port = _parse_address(address)
        # hostname + pid: bare pids collide routinely ACROSS hosts, and
        # colliding participant names silently merge two workers into
        # one barrier slot
        self.participant = participant if participant is not None \
            else f"{socket.gethostname()}-{os.getpid()}"
        self.heartbeat_interval = float(heartbeat_interval)
        self.connect_timeout = float(connect_timeout)
        self._closed = threading.Event()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True,
            name=f"dl4j-coord-hb-{self.participant}")
        self._hb_thread.start()

    # ------------------------------------------------------------- wire
    def _request(self, payload: Dict, timeout: float) -> Dict:
        with socket.create_connection((self.host, self.port),
                                      timeout=self.connect_timeout) as conn:
            conn.settimeout(timeout)
            f = conn.makefile("rwb")
            f.write((json.dumps(payload) + "\n").encode("utf-8"))
            f.flush()
            line = f.readline()
        if not line:
            raise BarrierProtocolError(
                f"coordinator {self.host}:{self.port} closed the "
                "connection without replying")
        try:
            return json.loads(line.decode("utf-8"))
        except json.JSONDecodeError as e:
            raise BarrierProtocolError(
                f"unparseable coordinator reply: {line[:200]!r}") from e

    def _heartbeat_loop(self):
        while not self._closed.wait(self.heartbeat_interval):
            try:
                self._request({"op": "heartbeat",
                               "participant": self.participant},
                              timeout=self.connect_timeout)
            except OSError:
                continue        # transient: the next beat retries
            except BarrierProtocolError:
                continue

    def hello(self, timeout: float = 5.0, meta: Dict = None) -> int:
        """Register with the server (so dead-peer detection covers this
        participant even before its first barrier); returns the
        server's current barrier generation. ``meta`` advertises
        participant metadata — e.g. ``{"metrics_url": "http://..."}``
        — that the server exposes through ``members()`` (what
        ``FleetScraper`` builds scrape targets from)."""
        payload = {"op": "hello", "participant": self.participant}
        if meta:
            payload["meta"] = dict(meta)
        reply = self._request(payload, timeout)
        return int(reply.get("generation", 0))

    def retire(self, peer: str, timeout: float = 5.0) -> int:
        """Tell the server ``peer`` is dead (see the module note); returns
        the participants left."""
        reply = self._request({"op": "retire",
                               "participant": self.participant,
                               "peer": str(peer)}, timeout)
        return int(reply.get("participants", 0))

    # ---------------------------------------------------------- contract
    def resume_barrier(self, participant: str, step: int,
                       timeout: float = 60.0) -> int:
        t0 = time.perf_counter()
        t0_us = _prof.now_us()
        name = str(participant or self.participant)
        # the barrier rides the ambient trace when one is in scope
        # (e.g. a fit_elastic run span) so the server's coord:round span
        # stitches into the same flow; otherwise mint only if tracing —
        # an untraced barrier should not grow the wire payload
        ambient = _tracectx.current()
        wire_ctx = (ambient.child() if ambient is not None
                    else (_tracectx.TraceContext.new()
                          if _prof.tracing_enabled() else None))
        payload = {"op": "barrier", "participant": name,
                   "step": int(step), "timeout": float(timeout)}
        if wire_ctx is not None:
            payload["trace"] = wire_ctx.to_traceparent()

        def _span(**args):
            _tracectx.record_span(
                "coord:barrier", wire_ctx, t0_us,
                _prof.now_us() - t0_us,
                args=dict(args, participant=name, step=int(step)))

        try:
            reply = self._request(payload,
                                  timeout=timeout + self.connect_timeout)
        except socket.timeout as e:
            _span(error="TimeoutError")
            raise TimeoutError(
                f"resume barrier: no reply from coordinator "
                f"{self.host}:{self.port} within {timeout}s") from e
        if reply.get("ok"):
            BARRIER_SECONDS.labels(impl="socket").observe(
                time.perf_counter() - t0)
            _span(ok=True, generation=reply.get("generation"))
            return int(reply["step"])
        err = reply.get("error")
        if err == "dead_peer":
            _span(error="DeadPeerError", peer=reply.get("peer"))
            rec = _flightrec.get_flight_recorder()
            rec.record("coord:dead_peer", peer=reply.get("peer", "?"),
                       generation=reply.get("generation", -1),
                       participant=name)
            rec.dump("dead_peer")
            raise DeadPeerError(reply.get("peer", "?"),
                                reply.get("generation", -1))
        if err == "timeout":
            _span(error="TimeoutError", arrived=reply.get("arrived"))
            raise TimeoutError(
                f"resume barrier: only {reply.get('arrived')}/"
                f"{reply.get('expected')} participants arrived within "
                f"{timeout}s")
        _span(error="BarrierProtocolError")
        raise BarrierProtocolError(f"coordinator error: {reply}")

    def close(self):
        self._closed.set()
        self._hb_thread.join(timeout=self.connect_timeout + 1.0)

    def __enter__(self) -> "SocketCoordinator":
        return self

    def __exit__(self, *exc):
        self.close()


# ----------------------------------------------------------------- file
class FileCoordinator(CoordinationService):
    """Shared-filesystem ``CoordinationService``: barrier arrival files
    + heartbeat mtimes under ``directory``. Every participant runs the
    same code — there is no server process; the filesystem is the
    rendezvous (same trade as ``parallel/checkpoint.py``'s manifest
    merge). Suited to clusters where every host mounts one filesystem
    and opening a port is the harder thing.

    Layout::

        <dir>/hb_<participant>            (touched every heartbeat)
        <dir>/gen<k>_<participant>.json   ({"step": n})

    Each participant tracks its own generation counter (barriers are
    called in lockstep by construction — the elastic layer's contract);
    the agreed step is the min over the generation's arrival files.
    """

    def __init__(self, directory: str, participants: int,
                 participant: str = None, heartbeat_timeout: float = 5.0,
                 heartbeat_interval: float = 1.0):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.participants = int(participants)
        self.participant = participant if participant is not None \
            else f"{socket.gethostname()}-{os.getpid()}"  # see SocketCoordinator
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.heartbeat_interval = float(heartbeat_interval)
        self._generation = 0
        # freshness floor: arrival/heartbeat files older than this
        # coordinator's construction belong to a PREVIOUS run in a
        # reused directory — counting them would agree on a stale step
        # (gen files) or fail every barrier forever (dead hb files).
        # Wall clock by necessity: file mtimes are wall-clock.
        self._t0 = time.time() - 1.0  # dl4j: noqa=W210
        self._closed = threading.Event()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, daemon=True,
            name=f"dl4j-coord-fhb-{self.participant}")
        self._hb_thread.start()

    def _hb_path(self, participant: str) -> str:
        return os.path.join(self.directory, f"hb_{participant}")

    def _touch_hb(self):
        path = self._hb_path(self.participant)
        with open(path, "a"):
            os.utime(path, None)

    def _heartbeat_loop(self):
        self._touch_hb()
        while not self._closed.wait(self.heartbeat_interval):
            try:
                self._touch_hb()
            except OSError:
                continue

    def resume_barrier(self, participant: str, step: int,
                       timeout: float = 60.0) -> int:
        import glob as _glob
        t0 = time.perf_counter()
        name = str(participant or self.participant)
        gen = self._generation
        own = os.path.join(self.directory, f"gen{gen}_{name}.json")
        tmp = own + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": int(step)}, f)
        os.replace(tmp, own)
        # result-acceptance floor: OUR round's result is written after
        # every arrival, including this one — a previous run's result
        # file strictly predates it, however quickly a supervisor
        # restarted us into the reused directory (the construction-time
        # floor alone leaves a <slack hole there)
        try:
            result_floor = os.path.getmtime(own)
        except OSError:
            result_floor = self._t0
        deadline = time.monotonic() + timeout
        pattern = os.path.join(self.directory, f"gen{gen}_*.json")
        result_path = os.path.join(self.directory, f"result_gen{gen}.json")
        while True:
            # a durable agreement first: whoever completed the round
            # wrote the result (and may have cleanly closed since,
            # retiring its heartbeat — its arrival must still bind us).
            # Floored on our own arrival's mtime: OUR round's result is
            # always written after every arrival, so anything older is
            # a previous run's leftover in a reused directory.
            try:
                if os.path.getmtime(result_path) >= result_floor:
                    with open(result_path) as f:
                        agreed = int(json.load(f)["step"])
                    self._generation += 1
                    BARRIER_SECONDS.labels(impl="file").observe(
                        time.perf_counter() - t0)
                    return agreed
            except (OSError, json.JSONDecodeError, KeyError, ValueError):
                pass        # absent or mid-rename: fall through to census
            # liveness census first: an arrival only counts when its
            # peer's heartbeat is FRESH — this is what separates a
            # same-run peer that arrived before we even constructed
            # (still heartbeating: counted) from a previous run's ghost
            # files in a reused directory (stale heartbeat: ignored).
            # Heartbeat ages compare against file MTIMES, which are
            # wall-clock by nature — monotonic time is meaningless
            # across processes.
            now = time.time()   # dl4j: noqa=W210
            fresh = {self.participant}
            registered: Dict[str, float] = {}
            for hb in _glob.glob(os.path.join(self.directory, "hb_*")):
                peer = os.path.basename(hb)[len("hb_"):]
                try:
                    mtime = os.path.getmtime(hb)
                except OSError:
                    continue
                registered[peer] = mtime
                if now - mtime <= self.heartbeat_timeout:  # dl4j: noqa=W210
                    fresh.add(peer)
            arrivals = {}
            for path in _glob.glob(pattern):
                peer = os.path.basename(path)[len(f"gen{gen}_"):-len(".json")]
                if peer not in fresh:
                    continue
                try:
                    with open(path) as f:
                        arrivals[peer] = int(json.load(f)["step"])
                except (json.JSONDecodeError, OSError, KeyError, ValueError):
                    continue    # mid-rename on a non-atomic filesystem
            if len(arrivals) >= self.participants:
                agreed = min(arrivals.values())
                # persist the agreement before returning: peers that
                # poll after we (or others) close must still converge
                rtmp = result_path + ".tmp"
                try:
                    with open(rtmp, "w") as f:
                        json.dump({"step": agreed}, f)
                    os.replace(rtmp, result_path)
                except OSError:
                    pass    # best-effort: live peers agree via census
                self._generation += 1
                BARRIER_SECONDS.labels(impl="file").observe(
                    time.perf_counter() - t0)
                return agreed
            # dead-peer detection: a peer that registered during THIS
            # session (mtime past our construction floor) and stopped
            # heartbeating is dead, not slow — previous-run ghosts
            # (mtime < _t0) are ignored, they were never our peers
            for peer, mtime in registered.items():
                if peer in fresh or peer == self.participant:
                    continue
                if mtime >= self._t0:
                    self._generation += 1
                    DEAD_PEERS.inc()
                    rec = _flightrec.get_flight_recorder()
                    rec.record("coord:dead_peer", peer=peer,
                               generation=gen, impl="file")
                    rec.dump("dead_peer")
                    raise DeadPeerError(peer, gen)
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"resume barrier: only {len(arrivals)}/"
                    f"{self.participants} participants arrived within "
                    f"{timeout}s (generation {gen})")
            time.sleep(0.05)

    def close(self):
        self._closed.set()
        self._hb_thread.join(timeout=self.heartbeat_interval + 1.0)
        # a clean exit retires this participant: its heartbeat file must
        # not read as a dead peer to anyone still (or later) waiting
        try:
            os.remove(self._hb_path(self.participant))
        except OSError:
            pass

    def __enter__(self) -> "FileCoordinator":
        return self

    def __exit__(self, *exc):
        self.close()
