"""Captured dispatch and the warmup API — the in-memory tier of
``deeplearning4j_tpu/nn/compilecache.py``.

On the card the counterpart of a compiled XLA program is a captured CUDA
graph: every launch of a step recorded once, replayed by one
``cudaGraphLaunch``, so the host no longer pays Python and launch time
per kernel.

- :class:`CachedDispatch` maps each argument signature (shapes, dtypes
  and devices, the reference's ``_leaf_signature``) to one captured
  ``torch.cuda.CUDAGraph`` with static input and output buffers; a call
  copies its arguments in, replays, and returns a copy of the outputs.
  The function's STATE (params, updater state, running statistics, the
  device clock) is not an argument: the function reads and writes it in
  place, at the addresses the graph recorded, which is why the port's
  steps never rebind a state tensor. A new signature is captured once —
  the port's "cold compile" — after a few eager warm-up runs on a side
  stream (the PyTorch whole-network-capture recipe), which do change
  state: the dispatch snapshots the tensors its ``state`` callable names
  and restores them, so capturing (and :meth:`CachedDispatch.warm`)
  leaves every piece of state as it found it. A capture that fails warns
  once and runs that signature eagerly from then on, as the reference's
  AOT fallback does; ``cache_stats()["capture_failures"]`` counts it. On
  the CPU a dispatch calls the function eagerly: the caller asked for
  the CPU.
- :func:`warmup` is the one entry point: ``warmup(net, [((64, 3, 224,
  224), (64, 1000))], steps_per_dispatch=K)`` captures the train step (K
  steps with K > 1) for that batch signature; ``warmup(server, shapes)``
  delegates to the serving bucket-ladder warmup, which captures the
  served forward and head of every bucket x shape (scope
  ``"serving:forward"``).

Kernel launch counts (``ops.cuda_kernels.LAUNCHES``) are bumped in
Python, so a graph's launches count once, while it is captured; each
entry keeps that count and every replay adds it to
``cuda_kernels.REPLAYS``.

Metrics: ``dl4j_compile_cache_{hits,misses}_total{scope=memory}``,
``dl4j_compile_seconds{state=cold}`` (warm-up runs and capture) and
``dl4j_capture_failures_total``.

Waits for a later PR (ROADMAP): the disk tier (``DiskCompileCache``,
``configure``, ``content_key``, ``runtime_fingerprint``): a CUDA graph
cannot be serialized.
"""

from __future__ import annotations

import contextlib
import gc
import time
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.profiler.metrics import get_registry

_REG = get_registry()
_HITS_MEM = _REG.counter(
    "dl4j_compile_cache_hits_total",
    "Compile-cache hits by tier: memory = an already-captured graph "
    "served a dispatch", labelnames=("scope",)).labels(scope="memory")
_MISS_MEM = _REG.counter(
    "dl4j_compile_cache_misses_total",
    "Compile-cache misses by tier: memory = first sight of a dispatch "
    "signature in this process", labelnames=("scope",)).labels(
        scope="memory")
_COLD = _REG.histogram(
    "dl4j_compile_seconds",
    "Program acquisition latency: cold = eager warm-up runs plus the "
    "CUDA-graph capture", labelnames=("state",),
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
             10.0, 30.0, 60.0)).labels(state="cold")
_FAILURES = _REG.counter(
    "dl4j_capture_failures_total",
    "Signatures whose CUDA-graph capture failed and that run eagerly")

#: per-process aggregates for cache_stats() (plain ints under the GIL)
_STATS = {"memory_hits": 0, "memory_misses": 0, "cold_seconds": 0.0,
          "cold_compiles": 0, "capture_failures": 0, "warmup_seconds": 0.0,
          "enter_seconds": 0.0, "capture_seconds": 0.0}

#: eager runs before a capture: cuBLAS/cuDNN handles and workspaces and
#: the allocator's blocks come into being outside the graph
WARMUP_RUNS = 2

#: sentinel parked for signatures whose capture failed: eager for good
_CAPTURE_FAILED = object()


def cache_stats() -> dict:
    """Per-process snapshot: memory-tier hits and misses, captures ("cold
    compiles") and their seconds, and failed captures. The cold seconds
    split into the eager warm-up runs (``warmup``), the capture's set-up
    before its first recorded launch (``enter``) and the recording itself
    (``capture``)."""
    return {"memory": {"hits": _STATS["memory_hits"],
                       "misses": _STATS["memory_misses"]},
            "compile_seconds": {"cold": _STATS["cold_seconds"],
                                "cold_compiles": _STATS["cold_compiles"],
                                "warmup": _STATS["warmup_seconds"],
                                "enter": _STATS["enter_seconds"],
                                "capture": _STATS["capture_seconds"]},
            "capture_failures": _STATS["capture_failures"]}


def reset_stats() -> None:
    for k in _STATS:
        _STATS[k] = 0.0 if k.endswith("seconds") else 0


def state_tensors(*trees) -> List[torch.Tensor]:
    """The tensors of nested dicts/lists/tuples, in order (None skipped)."""
    out: List[torch.Tensor] = []

    def walk(t):
        if isinstance(t, torch.Tensor):
            out.append(t)
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
    for tree in trees:
        walk(tree)
    return out


@contextlib.contextmanager
def preserved(tensors: List[torch.Tensor]):
    """Snapshot ``tensors`` and copy the snapshot back on exit, in place
    (the storage the captured graphs recorded stays the same)."""
    saved = [t.detach().clone() for t in tensors]
    try:
        yield
    finally:
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)


def _leaf_signature(a):
    """Identity of one argument: shape, dtype and device of a tensor, the
    value of anything else (a Python scalar is baked into a graph)."""
    if isinstance(a, torch.Tensor):
        return (tuple(a.shape), str(a.dtype), str(a.device))
    return ("value", a)


def _on_card(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


@contextlib.contextmanager
def _side_stream(args):
    """The stream the eager warm-up runs take: a side stream on the card
    (kept off the capture's), which the caller's stream waits for on the
    way out, so the state restored after the runs is written after them.
    That is an order on the card, not a wait of the host: a server on the
    same card replays meanwhile. Nothing on the CPU."""
    if not _on_card(args):
        yield
        return
    dev = next(a.device for a in args
               if isinstance(a, torch.Tensor) and a.is_cuda)
    current = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(current)
    try:
        with torch.cuda.stream(side):
            yield
    finally:
        current.wait_stream(side)


def _record(fn, static_args, *, pool, stream):
    """Capture ``fn(*static_args)`` into a new CUDA graph on ``stream``
    (which first waits for the caller's stream) into the memory ``pool``
    of :meth:`CachedDispatch._capture_options`; returns ``(graph, static
    outputs)``. The capture is thread-local: another thread's calls
    meanwhile (a server replaying its own graphs, its synchronous copies
    to and from the card) neither invalidate it nor raise there.

    ``torch.cuda.graph`` is not used: its entry synchronizes the whole
    card and empties the caching allocator, which hands every other
    server's cached blocks back to CUDA (``cudaFree`` waits for the card)
    and holds the interpreter lock while it does, so each capture stalled
    a server that was serving beside it.

    The cyclic garbage collector is off while the capture runs: a network
    and its dispatches form a reference cycle, so an older network's
    graphs are freed by a collection, and a collection that an allocation
    set off inside the capture would free them on this thread mid-capture,
    which invalidates the capture."""
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()
    try:
        t0 = time.perf_counter()
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.stream(stream):
            graph.capture_begin(pool, capture_error_mode="thread_local")
            t1 = time.perf_counter()
            try:
                out = fn(*static_args)
            finally:
                graph.capture_end()
        _STATS["enter_seconds"] += t1 - t0
        _STATS["capture_seconds"] += time.perf_counter() - t1
    finally:
        if collecting:
            gc.enable()
    return graph, out


def _capturing(args) -> bool:
    """Whether this thread is capturing a graph on the card right now."""
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args) \
        and torch.cuda.is_current_stream_capturing()


def _clone_out(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, (list, tuple)):
        return type(out)(_clone_out(o) for o in out)
    return out


class _Captured:
    """One signature's graph: static inputs and outputs, and the kernel
    launches recorded into it."""

    __slots__ = ("graph", "inputs", "outputs", "launches")

    def __init__(self, graph, inputs, outputs, launches):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.launches = launches

    def run(self, args):
        for static, a in zip(self.inputs, args):
            if isinstance(static, torch.Tensor) \
                    and static.data_ptr() != a.data_ptr():
                static.copy_(a)
        self.graph.replay()
        ck.count_replay(self.launches)
        return _clone_out(self.outputs)


class CachedDispatch:
    """A function of tensors that replays one captured CUDA graph per
    argument signature.

    ``fn(*args)`` reads and writes its state in place; ``state()`` lists
    that state (every tensor ``fn`` writes besides its outputs), which
    capturing leaves as it found it. With ``always_capture`` a new
    signature on the card is captured at its first call; without it the
    dispatch calls ``fn`` eagerly until :meth:`warm` has captured some
    signature (the reference's "plain jit until warmed"). On the CPU it
    always calls ``fn`` eagerly, and so does a call made while this thread
    captures another graph (a dispatch inside a captured function is
    recorded into that graph: captures do not nest).

    Each dispatch captures on a stream of its own, and its graphs share
    one memory pool (``torch.cuda.graph_pool_handle()``): a graph's
    intermediates may lie where another graph's did, which is safe
    because a call replays one graph and copies its outputs out before
    it returns; each entry keeps its own static inputs and outputs alive.
    """

    __slots__ = ("fn", "scope", "state", "always_capture", "_graphs",
                 "_warned", "_pool", "_stream")

    def __init__(self, fn: Callable, scope: str,
                 state: Optional[Callable[[], List[torch.Tensor]]] = None,
                 always_capture: bool = False):
        self.fn = fn
        self.scope = scope
        self.state = state if state is not None else list
        self.always_capture = always_capture
        self._graphs: Dict[tuple, object] = {}
        self._warned = False
        self._pool = None
        self._stream = None

    def _signature(self, args):
        return tuple(_leaf_signature(a) for a in args)

    def __call__(self, *args):
        if not _on_card(args) or (not self._graphs
                                  and not self.always_capture) \
                or _capturing(args):
            return self.fn(*args)
        sig = self._signature(args)
        entry = self._graphs.get(sig)
        if entry is _CAPTURE_FAILED:
            return self.fn(*args)
        if entry is not None:
            _STATS["memory_hits"] += 1
            _HITS_MEM.inc()
            return entry.run(args)
        _STATS["memory_misses"] += 1
        _MISS_MEM.inc()
        entry = self._acquire(args, sig)
        if entry is None:
            return self.fn(*args)
        return entry.run(args)

    def warm(self, *args) -> "CachedDispatch":
        """Capture the graph for this signature without changing any
        state (a no-op on the CPU)."""
        if _on_card(args) and not _capturing(args):
            sig = self._signature(args)
            if sig not in self._graphs:
                self._acquire(args, sig)
        return self

    def captures(self) -> int:
        """Captures attempted (successful or not): one per signature."""
        return len(self._graphs)

    def _capture_options(self, args) -> dict:
        """The stream and the pool of this dispatch's captures on the
        card; nothing on the CPU."""
        dev = next((a.device for a in args
                    if isinstance(a, torch.Tensor) and a.is_cuda), None)
        if dev is None:
            return {}
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
            self._pool = torch.cuda.graph_pool_handle()
        return {"stream": self._stream, "pool": self._pool}

    def warmed_signatures(self) -> int:
        return sum(1 for v in self._graphs.values()
                   if v is not _CAPTURE_FAILED)

    def launches_at_capture(self) -> List[Dict[str, int]]:
        """Each captured signature's kernel launches (what one replay
        runs)."""
        return [dict(v.launches) for v in self._graphs.values()
                if v is not _CAPTURE_FAILED]

    def _acquire(self, args, sig):
        """Warm-up runs under a state snapshot, then the capture. A
        failure in the warm-up runs is the function's own and raises; a
        failed capture parks the signature on the eager path."""
        t0 = time.perf_counter()
        static = tuple(a.detach().clone() if isinstance(a, torch.Tensor)
                       else a for a in args)
        with preserved(self.state()):
            with _side_stream(args):
                for _ in range(WARMUP_RUNS):
                    self.fn(*static)
        _STATS["warmup_seconds"] += time.perf_counter() - t0
        before = dict(ck.LAUNCHES)
        try:
            graph, out = _record(self.fn, static,
                                 **self._capture_options(args))
        except Exception as e:      # any capture error: eager from now on
            self._graphs[sig] = _CAPTURE_FAILED
            _STATS["capture_failures"] += 1
            _FAILURES.inc()
            if not self._warned:
                self._warned = True
                warnings.warn(
                    f"CUDA-graph capture [{self.scope}] failed "
                    f"({type(e).__name__}: {e}) — this signature runs "
                    "eagerly", stacklevel=3)
            return None
        launches = {k: v - before.get(k, 0) for k, v in ck.LAUNCHES.items()
                    if v != before.get(k, 0)}
        dt = time.perf_counter() - t0
        _STATS["cold_seconds"] += dt
        _STATS["cold_compiles"] += 1
        _COLD.observe(dt)
        entry = _Captured(graph, static, out, launches)
        self._graphs[sig] = entry
        return entry


# ----------------------------------------------------------------- warmup
def _is_shape(spec) -> bool:
    return isinstance(spec, (tuple, list)) \
        and all(isinstance(d, int) for d in spec)


def warmup(target, shapes, *, steps_per_dispatch: int = 1, dtype=None,
           label_dtype=None, tbptt_length: int = None):
    """Capture ahead of the first dispatch.

    ``target`` is a ``ModelServer`` (delegates to its bucket-ladder
    ``warmup``) or a network (``MultiLayerNetwork``/``ComputationGraph``).
    Each ``shapes`` entry is a ``(features_shape, labels_shape)`` pair:
    the train step for that per-batch signature is captured (K steps on
    ``[K, B, ...]`` buffers with ``steps_per_dispatch=K`` > 1), on zeros
    of ``dtype``/``label_dtype`` (fp32 by default). No state changes:
    params, updater state, running statistics and the clock come out as
    they went in. A bare feature shape warms a served forward: pass the
    ``ModelServer`` (a network's own ``output()`` is not captured yet).
    A ``MultiLayerNetwork`` under truncated BPTT (configured, or
    ``tbptt_length``) warms its window step for 3-D features instead."""
    if hasattr(target, "buckets") and hasattr(target, "submit"):
        return target.warmup(shapes)
    model = target
    fdt = np.dtype(dtype) if dtype is not None else np.float32
    ldt = np.dtype(label_dtype) if label_dtype is not None else np.float32
    k = max(int(steps_per_dispatch), 1)
    lead = (k,) if k > 1 else ()
    for spec in shapes:
        if _is_shape(spec):
            raise ValueError(
                f"warmup shape spec {spec!r}: a network's inference forward "
                "is captured through the server — warmup(ModelServer(net), "
                "shapes) — or pass a (features_shape, labels_shape) pair")
        if not (isinstance(spec, (tuple, list)) and len(spec) == 2):
            raise ValueError(
                f"warmup shape spec {spec!r}: expected a (features_shape, "
                "labels_shape) pair (train step)")
        fshape, lshape = spec
        extra = {} if tbptt_length is None else {"tbptt_length": tbptt_length}
        model._warm_dispatch(np.zeros(lead + tuple(fshape), fdt),
                             np.zeros(lead + tuple(lshape), ldt), steps=k,
                             **extra)
    return model


def warm_from_batch_signature(model, batch_sig: dict,
                              steps_per_dispatch: int = 1) -> bool:
    """Warm a train step from a recorded batch signature (``{"features":
    [shape, dtype], "labels": [...]}``, what :func:`describe_batch`
    gives). Best-effort: returns False (never raises) when the signature
    is absent or unusable."""
    if not batch_sig:
        return False
    try:
        f = batch_sig.get("features")
        lab = batch_sig.get("labels")
        if not f or not lab:
            return False
        warmup(model, [(tuple(f[0]), tuple(lab[0]))],
               steps_per_dispatch=steps_per_dispatch,
               dtype=f[1], label_dtype=lab[1])
        return True
    except Exception as e:
        warnings.warn(f"resume warmup skipped: {type(e).__name__}: {e}",
                      stacklevel=2)
        return False


def describe_batch(ds) -> Optional[dict]:
    """The batch signature :func:`warm_from_batch_signature` consumes:
    shapes and dtypes of a single-input DataSet without masks; None
    otherwise."""
    feats = getattr(ds, "features", None)
    labels = getattr(ds, "labels", None)
    if feats is None or labels is None \
            or isinstance(feats, (list, tuple)):
        return None
    try:
        sig = {"features": [list(feats.shape), _dtype_name(feats.dtype)],
               "labels": [list(labels.shape), _dtype_name(labels.dtype)]}
    except AttributeError:
        return None
    if getattr(ds, "features_mask", None) is not None \
            or getattr(ds, "labels_mask", None) is not None:
        return None                  # masked signatures: explicit warmup
    return sig


def _dtype_name(dt) -> str:
    """A numpy-readable dtype name for a numpy or torch dtype."""
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return str(dt)
