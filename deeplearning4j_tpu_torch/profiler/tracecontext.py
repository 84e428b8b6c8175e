"""Distributed request tracing: W3C-``traceparent``-style context — a
copy of the JAX package's jax-free ``profiler/tracecontext.py``.

- :class:`TraceContext` — a (trace_id, span_id, parent_id) triple with
  W3C Trace Context wire form (``00-<32 hex>-<16 hex>-01``). The
  ingress honors an incoming ``traceparent`` header or mints a fresh
  context; IDs are always minted so every response can carry its
  ``trace_id`` even with tracing off, while span *recording* stays gated
  on :func:`~.tracer.tracing_enabled`.
- :func:`record_span` — records one completed span under a context on
  the process tracer: ``args`` carry ``trace_id``/``span_id``/
  ``parent_span_id`` plus optional ``links``. One coalesced batch
  serving N requests emits ONE dispatch span whose ``links`` name each
  request's root span — the fan-in edge.
- an ambient *current context* (contextvar): :func:`use` installs one
  for a code region and every span recorded meanwhile is stamped with
  its ``trace_id``.
- :func:`run_span` — the root span of a training run (``fit_scope``
  opens ``train:run``): its ``trace_id`` is the ``run_id`` every span of
  the fit carries; :func:`merge_chrome_traces` folds several processes'
  Chrome traces into one document.

Span vocabulary::

    ingress:request   wire recv -> response written (root per request)
    serve:route       registry route resolution (version pin)
    serve:admission   submit() admission decision
    serve:queue       enqueued -> popped into a batch (per request)
    serve:coalesce    batch build wait (per batch)
    serve:dispatch    forward dispatch (per batch; links fan-in)
    serve:retry       one failed dispatch attempt (per retry)
    serve:terminal    exactly-once resolution (per request; outcome arg)
    ingress:respond   response serialization + write
"""

from __future__ import annotations

import contextvars
import os
import re
from contextlib import contextmanager
from typing import Dict, Iterable, List, Optional

from deeplearning4j_tpu_torch.profiler import tracer as _tracer

_TRACEPARENT_RE = re.compile(
    r"^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")


def _hex(nbytes: int) -> str:
    return os.urandom(nbytes).hex()


class TraceContext:
    """One node of a distributed trace: ``trace_id`` names the whole
    request flow, ``span_id`` this hop, ``parent_id`` the hop that
    caused it (None at the root). Immutable by convention — derive with
    :meth:`child`."""

    __slots__ = ("trace_id", "span_id", "parent_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str] = None):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id

    @classmethod
    def new(cls) -> "TraceContext":
        """Mint a fresh root context (a new trace)."""
        return cls(_hex(16), _hex(8))

    def child(self) -> "TraceContext":
        """A child hop: same trace, new span id, parented here."""
        return TraceContext(self.trace_id, _hex(8), self.span_id)

    # ------------------------------------------------------------- wire
    def to_traceparent(self) -> str:
        """W3C Trace Context header value (version 00, sampled)."""
        return f"00-{self.trace_id}-{self.span_id}-01"

    @classmethod
    def from_traceparent(cls, header) -> Optional["TraceContext"]:
        """Parse a ``traceparent`` header; None when absent/malformed
        (a bad header must never fail the request — mint instead)."""
        if not header:
            return None
        m = _TRACEPARENT_RE.match(str(header).strip().lower())
        if m is None:
            return None
        version, trace_id, span_id = m.group(1), m.group(2), m.group(3)
        if version == "ff" or trace_id == "0" * 32 or span_id == "0" * 16:
            return None     # forbidden version / all-zero ids per spec
        return cls(trace_id, span_id)

    def args(self) -> Dict[str, str]:
        a = {"trace_id": self.trace_id, "span_id": self.span_id}
        if self.parent_id:
            a["parent_span_id"] = self.parent_id
        return a

    def __repr__(self):
        return (f"TraceContext({self.trace_id[:8]}…, span={self.span_id}"
                f"{', parent=' + self.parent_id if self.parent_id else ''})")


# ------------------------------------------------------ ambient context
_CURRENT: "contextvars.ContextVar[Optional[TraceContext]]" = \
    contextvars.ContextVar("dl4j_trace_context", default=None)


def current() -> Optional[TraceContext]:
    """The ambient trace context of the calling thread/task (None when
    no request/run is in scope)."""
    return _CURRENT.get()


@contextmanager
def use(ctx: Optional[TraceContext]):
    """Install ``ctx`` as the ambient context for the body — every span
    recorded meanwhile is stamped with its trace_id."""
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(token)


def _ambient_args() -> Optional[Dict[str, str]]:
    ctx = _CURRENT.get()
    if ctx is None:
        return None
    return {"trace_id": ctx.trace_id}


# installed at import (profiler/__init__ imports this module): ordinary
# spans recorded under an ambient context inherit its trace_id
_tracer.set_context_args_fn(_ambient_args)


# ---------------------------------------------------------- recording
def record_span(name: str, ctx: Optional[TraceContext], ts_us: float,
                dur_us: float, args: Optional[dict] = None,
                links: Optional[Iterable] = None, tracer=None) -> None:
    """Record one completed span under ``ctx`` (no-op when tracing is
    off or ``ctx`` is None). ``links`` is an iterable of
    :class:`TraceContext` (or ready-made dicts) naming spans this one
    fans in from — the coalesced-batch edge."""
    if ctx is None or not _tracer.tracing_enabled():
        return
    a = dict(args) if args else {}
    a.update(ctx.args())
    if links:
        a["links"] = [l.args() if isinstance(l, TraceContext) else dict(l)
                      for l in links]
    (tracer if tracer is not None else _tracer.get_tracer()).add_event(
        name, ts_us, dur_us, a)


@contextmanager
def span(name: str, parent: Optional[TraceContext] = None,
         links: Optional[Iterable] = None, **args):
    """Context manager: open a child span of ``parent`` (default: the
    ambient context; a fresh root when neither exists), make it ambient
    for the body, record it on exit. Yields the span's own
    :class:`TraceContext`. Exceptions are recorded
    (``error=<TypeName>``) and re-raised."""
    base = parent if parent is not None else _CURRENT.get()
    ctx = base.child() if base is not None else TraceContext.new()
    t0 = _tracer.now_us()
    token = _CURRENT.set(ctx)
    err = None
    try:
        yield ctx
    except BaseException as e:
        err = type(e).__name__
        raise
    finally:
        _CURRENT.reset(token)
        a = dict(args)
        if err is not None:
            a["error"] = err
        record_span(name, ctx, t0, _tracer.now_us() - t0, args=a,
                    links=links)


@contextmanager
def run_span(name: str = "train:run", **args):
    """Root span for a training run: mints a fresh trace whose
    ``trace_id`` doubles as the ``run_id``, installs it as the ambient
    context (so every step/op span recorded during the fit carries it),
    and records the root span at exit. Yields the run's
    :class:`TraceContext`."""
    ctx = TraceContext.new()
    t0 = _tracer.now_us()
    token = _CURRENT.set(ctx)
    try:
        yield ctx
    finally:
        _CURRENT.reset(token)
        record_span(name, ctx, t0, _tracer.now_us() - t0,
                    args=dict(args, run_id=ctx.trace_id))


# ------------------------------------------------------------- merging
def merge_chrome_traces(docs: Iterable) -> dict:
    """Fold several Chrome-trace documents (dicts with ``traceEvents``,
    or bare event lists — e.g. one per process of a multi-host job)
    into ONE Perfetto-loadable document: spans sharing a ``trace_id``
    across processes render as a single stitched flow. Duplicate
    thread-name metadata collapses to one entry per (pid, tid)."""
    events: List[dict] = []
    seen_meta = set()
    for doc in docs:
        evs = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
        for ev in evs:
            if ev.get("ph") == "M":
                key = (ev.get("name"), ev.get("pid"), ev.get("tid"))
                if key in seen_meta:
                    continue
                seen_meta.add(key)
            events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def spans_for_trace(trace_id: str, events: Optional[Iterable[dict]] = None
                    ) -> List[dict]:
    """Every recorded span stamped with ``trace_id`` (from ``events``
    or the process tracer's ring) — what the chaos/e2e pins assert on."""
    if events is None:
        events = _tracer.get_tracer().events()
    return [ev for ev in events
            if ev.get("args", {}).get("trace_id") == trace_id]
