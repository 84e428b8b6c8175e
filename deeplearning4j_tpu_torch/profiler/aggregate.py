"""Cross-host metric federation: merge fleet members' /metrics.

A fleet router needs fleet-wide load/latency signals, and
every ``/metrics`` and ``/v1/load`` is one host's view. This
module federates them without a Prometheus server in the pod (the
environment is egress-free — same constraint that made
``profiler.metrics`` speak the text format natively):

- :func:`parse_exposition` — a small parser for the Prometheus text
  exposition (0.0.4 *and* the OpenMetrics dialect our registry renders:
  exemplar annotations after ``#`` are stripped, ``# EOF`` ignored).
- :class:`MetricsAggregator` — ingests per-host snapshots and merges
  by family with per-type rules:

  * **counters** sum across hosts (a fleet total),
  * **gauges** keep a ``host`` label (a gauge is a per-host instant;
    summing queue depths is meaningful only for some gauges, so the
    merged exposition preserves per-host values and lets the reader
    aggregate),
  * **histograms** bucket-merge: per-``le`` counts sum over the union
    of bucket layouts, so a *fleet* p99 is computable from
    :meth:`HistogramSnapshot.quantile` with exactly the
    ``histogram_quantile`` interpolation ``Histogram.quantile`` uses
    locally.

  Snapshots age out (``max_age``) so a dead host stops shaping fleet
  quantiles a bounded time after its last scrape.
- :class:`FleetScraper` — drives scrape targets from CoordinationService
  membership: participants advertise a ``metrics_url`` in their
  ``hello`` meta, a coordinator server exposes ``members()`` (any
  object with that method; :func:`members_from_coordinator` duck-types
  it), and the scraper pulls each fresh
  member's ``/metrics`` (and ``/v1/load``) over stdlib urllib. Dead
  hosts (stale heartbeat) are skipped and age out of the merge.

The ingress exposes the result at ``GET /v1/fleet/metrics`` (merged
exposition) and ``GET /v1/fleet/load`` (merged autoscaling hints).
Fleet-meta series rendered into the merged exposition:
``dl4j_fleet_members``, ``dl4j_fleet_snapshot_age_seconds{host=}``,
``dl4j_fleet_scrapes_total``, ``dl4j_fleet_scrape_errors_total``.
"""

from __future__ import annotations

import json
import re
import threading
import time
import urllib.request
from typing import Callable, Dict, List, Optional, Tuple

from deeplearning4j_tpu_torch.profiler import metrics as _metrics
from deeplearning4j_tpu_torch.profiler.locks import InstrumentedLock

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+(\S+)")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

_HIST_SUFFIXES = ("_bucket", "_sum", "_count")


def _unescape(v: str) -> str:
    return v.replace(r"\"", '"').replace(r"\n", "\n").replace("\\\\", "\\")


def _parse_value(raw: str) -> float:
    if raw == "+Inf":
        return float("inf")
    if raw == "-Inf":
        return float("-inf")
    return float(raw)


class Family:
    """One parsed metric family: ``samples`` maps
    ``(suffix, labels_tuple)`` -> value, where ``labels_tuple`` is a
    sorted tuple of (name, value) pairs."""

    __slots__ = ("name", "typ", "help", "samples")

    def __init__(self, name: str, typ: str = "untyped", help: str = ""):
        self.name = name
        self.typ = typ
        self.help = help
        self.samples: Dict[Tuple[str, Tuple], float] = {}


def parse_exposition(text: str) -> Dict[str, Family]:
    """Prometheus/OpenMetrics text -> {family name: :class:`Family`}.
    Histogram ``_bucket``/``_sum``/``_count`` series fold into their
    base family; exemplar annotations and ``# EOF`` are ignored."""
    families: Dict[str, Family] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 3 and parts[1] in ("TYPE", "HELP"):
                name = parts[2]
                fam = families.setdefault(name, Family(name))
                if parts[1] == "TYPE" and len(parts) >= 4:
                    fam.typ = parts[3].strip()
                elif parts[1] == "HELP":
                    fam.help = parts[3] if len(parts) >= 4 else ""
            continue
        # strip an OpenMetrics exemplar annotation (" # {...} v")
        if " # " in line:
            line = line.split(" # ", 1)[0].rstrip()
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue
        sample_name, label_blob, raw = m.group(1), m.group(2), m.group(3)
        try:
            value = _parse_value(raw)
        except ValueError:
            continue
        # a suffix only folds into a base family that was declared a
        # histogram — a counter legitimately named *_count keeps its own
        base, suffix = sample_name, ""
        for sfx in _HIST_SUFFIXES:
            if sample_name.endswith(sfx) \
                    and sample_name[:-len(sfx)] in families \
                    and families[sample_name[:-len(sfx)]].typ == "histogram":
                base, suffix = sample_name[:-len(sfx)], sfx
                break
        labels = tuple(sorted((n, _unescape(v)) for n, v in
                              _LABEL_RE.findall(label_blob or "")))
        fam = families.setdefault(base, Family(base))
        fam.samples[(suffix, labels)] = value
    return families


class HistogramSnapshot:
    """A merged (or single-host) cumulative histogram:
    ``bounds`` are finite upper bounds, ``cumulative`` the cumulative
    counts per bound, ``count``/``sum`` the totals. :meth:`quantile`
    matches :meth:`deeplearning4j_tpu_torch.profiler.metrics.Histogram.
    quantile` (linear interpolation within the owning bucket) so a
    fleet p99 is the same computation as a local one."""

    __slots__ = ("bounds", "cumulative", "count", "sum")

    def __init__(self, bounds: List[float], cumulative: List[float],
                 count: float, sum: float):
        self.bounds = list(bounds)
        self.cumulative = list(cumulative)
        self.count = count
        self.sum = sum

    def quantile(self, q: float) -> Optional[float]:
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        total = self.count
        if total <= 0:
            return None
        rank = q * total
        cum_prev = 0.0
        lo = 0.0
        for bound, cum in zip(self.bounds, self.cumulative):
            c = cum - cum_prev
            if c > 0 and cum >= rank:
                frac = (rank - cum_prev) / c
                return lo + (bound - lo) * max(min(frac, 1.0), 0.0)
            cum_prev = cum
            lo = bound
        return self.bounds[-1] if self.bounds else None


def _merge_histogram(per_host: List[Dict[Tuple[str, Tuple], float]],
                     labels: Tuple) -> Optional[HistogramSnapshot]:
    """Merge one labelset's cumulative buckets across hosts: convert
    each host's cumulative counts to per-bucket deltas keyed by ``le``,
    sum over the union grid, re-cumulate. Identical layouts merge
    exactly; differing layouts merge on the union of bounds (each
    host's mass stays at its own bound — the merged histogram is the
    histogram of the union of observations at each host's resolution)."""
    deltas: Dict[float, float] = {}
    total_count = 0.0
    total_sum = 0.0
    any_data = False
    for samples in per_host:
        bounds = []
        for (suffix, lbls), value in samples.items():
            if suffix != "_bucket":
                continue
            le = dict(lbls).get("le")
            rest = tuple(p for p in lbls if p[0] != "le")
            if le is None or rest != labels:
                continue
            bounds.append((_parse_value(le), value))
        if not bounds:
            continue
        any_data = True
        bounds.sort(key=lambda bv: bv[0])
        prev = 0.0
        for bound, cum in bounds:
            deltas[bound] = deltas.get(bound, 0.0) + (cum - prev)
            prev = cum
        total_count += samples.get(("_count", labels), bounds[-1][1])
        total_sum += samples.get(("_sum", labels), 0.0)
    if not any_data:
        return None
    finite = sorted(b for b in deltas if b != float("inf"))
    cumulative = []
    cum = 0.0
    for b in finite:
        cum += deltas[b]
        cumulative.append(cum)
    return HistogramSnapshot(finite, cumulative, total_count, total_sum)


class MetricsAggregator:
    """Merge per-host Prometheus snapshots into a fleet view (module
    doc for the per-type rules). ``max_age`` seconds after its last
    ingest a host's snapshot stops contributing (dead-host age-out);
    ``clock`` is injectable for deterministic tests."""

    def __init__(self, max_age: float = 30.0, clock=time.monotonic):
        self.max_age = float(max_age)
        self._clock = clock
        self._lock = InstrumentedLock("fleet:aggregator")
        self._snapshots: Dict[str, Tuple[float, Dict[str, Family]]] = {}
        self._loads: Dict[str, Tuple[float, dict]] = {}
        self._scrapes = 0
        self._scrape_errors = 0

    # ------------------------------------------------------------ ingest
    def ingest(self, host: str, text: str) -> None:
        """Store one host's exposition snapshot (parsed immediately so
        a malformed body fails the ingest, not a later read)."""
        families = parse_exposition(text)
        with self._lock:
            self._snapshots[str(host)] = (self._clock(), families)
            self._scrapes += 1

    def ingest_load(self, host: str, hints: dict) -> None:
        """Store one host's ``/v1/load`` payload for :meth:`fleet_load`."""
        with self._lock:
            self._loads[str(host)] = (self._clock(), dict(hints))

    def note_scrape_error(self) -> None:
        with self._lock:
            self._scrape_errors += 1

    def drop(self, host: str) -> None:
        with self._lock:
            self._snapshots.pop(str(host), None)
            self._loads.pop(str(host), None)

    def _fresh(self) -> Dict[str, Tuple[float, Dict[str, Family]]]:
        # caller holds the lock
        now = self._clock()
        return {h: (t, fams) for h, (t, fams) in self._snapshots.items()
                if now - t <= self.max_age}

    def hosts(self) -> List[str]:
        """Hosts currently contributing (ingested within ``max_age``)."""
        with self._lock:
            return sorted(self._fresh())

    # ------------------------------------------------------------- merge
    def fleet_histogram(self, name: str, labels: Optional[dict] = None
                        ) -> Optional[HistogramSnapshot]:
        """The merged fleet histogram for ``name`` (None when no fresh
        host exposes it). ``labels`` filters to one labelset (ignoring
        ``le``); default: the unlabelled series."""
        want = tuple(sorted((str(k), str(v))
                            for k, v in (labels or {}).items()))
        with self._lock:
            fresh = self._fresh()
        per_host = [fams[name].samples for _, fams in fresh.values()
                    if name in fams]
        return _merge_histogram(per_host, want)

    def quantile(self, name: str, q: float,
                 labels: Optional[dict] = None) -> Optional[float]:
        """Fleet quantile from the merged buckets (the number the
        fleet router thresholds on)."""
        snap = self.fleet_histogram(name, labels)
        return None if snap is None else snap.quantile(q)

    def counter_total(self, name: str,
                      labels: Optional[dict] = None) -> float:
        """Summed counter value across fresh hosts."""
        want = tuple(sorted((str(k), str(v))
                            for k, v in (labels or {}).items()))
        with self._lock:
            fresh = self._fresh()
        total = 0.0
        for _, fams in fresh.values():
            fam = fams.get(name)
            if fam is None:
                continue
            for (suffix, lbls), value in fam.samples.items():
                if suffix == "" and lbls == want:
                    total += value
        return total

    def exposition(self) -> str:
        """The merged fleet exposition (what ``GET /v1/fleet/metrics``
        serves): counters summed, gauges per-host under a ``host``
        label, histograms bucket-merged, plus the ``dl4j_fleet_*``
        meta-series."""
        with self._lock:
            fresh = self._fresh()
            scrapes, errors = self._scrapes, self._scrape_errors
            now = self._clock()
            ages = {h: now - t for h, (t, _) in self._snapshots.items()}
        names: Dict[str, Family] = {}
        for _, fams in fresh.values():
            for name, fam in fams.items():
                if name not in names:
                    names[name] = Family(name, fam.typ, fam.help)
        lines: List[str] = []
        for name in sorted(names):
            proto = names[name]
            lines.append(f"# HELP {name} {proto.help}")
            lines.append(f"# TYPE {name} {proto.typ}")
            if proto.typ == "histogram":
                lines.extend(self._render_histogram(name, fresh))
            elif proto.typ == "gauge":
                lines.extend(self._render_gauge(name, fresh))
            else:               # counter / untyped: sum across hosts
                lines.extend(self._render_counter(name, fresh))
        lines.append("# HELP dl4j_fleet_members Hosts contributing to "
                     "the merged fleet view (fresh within max_age)")
        lines.append("# TYPE dl4j_fleet_members gauge")
        lines.append(f"dl4j_fleet_members {len(fresh)}")
        lines.append("# HELP dl4j_fleet_snapshot_age_seconds Seconds "
                     "since each member's snapshot was ingested")
        lines.append("# TYPE dl4j_fleet_snapshot_age_seconds gauge")
        for h in sorted(ages):
            lines.append(f'dl4j_fleet_snapshot_age_seconds'
                         f'{{host="{_metrics._escape_label(h)}"}} '
                         f"{_metrics._format_value(ages[h])}")
        lines.append("# HELP dl4j_fleet_scrapes_total Snapshots "
                     "ingested into the aggregator")
        lines.append("# TYPE dl4j_fleet_scrapes_total counter")
        lines.append(f"dl4j_fleet_scrapes_total {scrapes}")
        lines.append("# HELP dl4j_fleet_scrape_errors_total Failed "
                     "member scrapes (host skipped that round)")
        lines.append("# TYPE dl4j_fleet_scrape_errors_total counter")
        lines.append(f"dl4j_fleet_scrape_errors_total {errors}")
        return "\n".join(lines) + "\n"

    def _labelsets(self, name: str, fresh, suffix: str = "") -> List[Tuple]:
        seen = []
        for _, fams in fresh.values():
            fam = fams.get(name)
            if fam is None:
                continue
            for (sfx, lbls) in fam.samples:
                if sfx != suffix:
                    continue
                key = tuple(p for p in lbls if p[0] != "le")
                if key not in seen:
                    seen.append(key)
        return sorted(seen)

    @staticmethod
    def _fmt(name: str, labels: Tuple, value: float,
             suffix: str = "", extra: Optional[Tuple] = None) -> str:
        pairs = list(labels) + list(extra or ())
        blob = ""
        if pairs:
            inner = ",".join(
                f'{n}="{_metrics._escape_label(v)}"' for n, v in pairs)
            blob = "{" + inner + "}"
        return f"{name}{suffix}{blob} {_metrics._format_value(value)}"

    def _render_counter(self, name: str, fresh) -> List[str]:
        out = []
        for labels in self._labelsets(name, fresh):
            total = 0.0
            for _, fams in fresh.values():
                fam = fams.get(name)
                if fam is not None:
                    total += fam.samples.get(("", labels), 0.0)
            out.append(self._fmt(name, labels, total))
        return out

    def _render_gauge(self, name: str, fresh) -> List[str]:
        out = []
        for labels in self._labelsets(name, fresh):
            for host in sorted(fresh):
                fam = fresh[host][1].get(name)
                if fam is None or ("", labels) not in fam.samples:
                    continue
                out.append(self._fmt(name, labels,
                                     fam.samples[("", labels)],
                                     extra=(("host", host),)))
        return out

    def _render_histogram(self, name: str, fresh) -> List[str]:
        out = []
        for labels in self._labelsets(name, fresh, suffix="_bucket"):
            per_host = [fams[name].samples for _, fams in fresh.values()
                        if name in fams]
            snap = _merge_histogram(per_host, labels)
            if snap is None:
                continue
            for bound, cum in zip(snap.bounds, snap.cumulative):
                out.append(self._fmt(
                    name, labels, cum, suffix="_bucket",
                    extra=(("le", _metrics._format_value(bound)),)))
            out.append(self._fmt(name, labels, snap.count,
                                 suffix="_bucket", extra=(("le", "+Inf"),)))
            out.append(self._fmt(name, labels, snap.sum, suffix="_sum"))
            out.append(self._fmt(name, labels, snap.count,
                                 suffix="_count"))
        return out

    # -------------------------------------------------------------- load
    def fleet_load(self) -> dict:
        """Merged autoscaling hints (``GET /v1/fleet/load``): per-host
        payloads under ``hosts`` plus fleet totals a router can
        threshold on — the fleet-wide twin of the per-host
        ``/v1/load``."""
        with self._lock:
            now = self._clock()
            loads = {h: hints for h, (t, hints) in self._loads.items()
                     if now - t <= self.max_age}
        totals = {"queue_depth": 0, "max_queue": 0, "breakers_open": 0,
                  "shed_rate": 0.0, "ready": bool(loads), "hosts": len(loads)}
        for hints in loads.values():
            t = hints.get("totals", hints)
            totals["queue_depth"] += int(t.get("queue_depth", 0))
            totals["max_queue"] += int(t.get("max_queue", 0))
            totals["breakers_open"] += int(t.get("breakers_open", 0))
            totals["shed_rate"] += float(t.get("shed_rate", 0.0))
            totals["ready"] = totals["ready"] and bool(t.get("ready", False))
        if loads:
            totals["shed_rate"] = round(totals["shed_rate"] / len(loads), 6)
        return {"hosts": loads, "totals": totals}


# ------------------------------------------------------------- scraping
def members_from_coordinator(server, fresh_within: Optional[float] = None
                             ) -> Dict[str, str]:
    """Scrape targets from CoordinationService membership: every fresh
    participant that advertised a ``metrics_url`` in its hello meta.
    Returns {participant: base_url}."""
    out = {}
    for name, info in server.members(fresh_within=fresh_within).items():
        url = (info.get("meta") or {}).get("metrics_url")
        if url:
            out[name] = str(url)
    return out


class FleetScraper:
    """Pull each member's ``/metrics`` (and ``/v1/load`` when present)
    into a :class:`MetricsAggregator`. ``members`` is a callable
    returning {host: base_url} — typically
    ``lambda: members_from_coordinator(coord_server)`` so scrape
    targets track heartbeat-fresh membership and dead hosts fall out.
    ``start()`` runs a background thread at ``interval``;
    :meth:`scrape_once` is the synchronous form tests drive."""

    def __init__(self, aggregator: MetricsAggregator,
                 members: Callable[[], Dict[str, str]],
                 interval: float = 5.0, timeout: float = 2.0):
        self.aggregator = aggregator
        self.members = members
        self.interval = float(interval)
        self.timeout = float(timeout)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._lifecycle = InstrumentedLock("fleet:scraper")

    def scrape_once(self) -> Dict[str, bool]:
        """One synchronous sweep; returns {host: succeeded}."""
        results = {}
        try:
            targets = dict(self.members())
        except Exception:
            return results
        for host, base in targets.items():
            base = base.rstrip("/")
            try:
                with urllib.request.urlopen(base + "/metrics",
                                            timeout=self.timeout) as r:
                    self.aggregator.ingest(host,
                                           r.read().decode("utf-8"))
                results[host] = True
            except Exception:
                self.aggregator.note_scrape_error()
                results[host] = False
                continue
            try:
                with urllib.request.urlopen(base + "/v1/load",
                                            timeout=self.timeout) as r:
                    self.aggregator.ingest_load(
                        host, json.loads(r.read().decode("utf-8")))
            except Exception:
                pass    # load hints are optional (e.g. a bare UIServer)
        return results

    def start(self) -> "FleetScraper":
        with self._lifecycle:
            if self._thread is None:
                self._stop.clear()
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name="dl4j-fleet-scraper")
                self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self.interval):
            self.scrape_once()

    def stop(self) -> None:
        self._stop.set()
        with self._lifecycle:
            if self._thread is not None:
                self._thread.join(timeout=self.timeout + 1.0)
                self._thread = None

    def __enter__(self) -> "FleetScraper":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
