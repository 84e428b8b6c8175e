"""Per-layer DEVICE time — the port of ``deeplearning4j_tpu/profiler/
devicetime.py``: the bridge from host dispatch time to card time, with
two capture paths and one attribution model.

- **trace** — run the model's EAGER forward ``reps`` times under
  ``torch.profiler`` with CUDA activity, every layer inside a
  ``record_function`` scope named ``dl4j_L<i>_<name>`` (:func:`scope_name`;
  both network forwards and the transformer emit them). Each CUDA
  kernel's device time goes to the innermost ``dl4j_L`` scope of the CPU
  op that launched it (torch.profiler links a kernel to the op that was
  open at its launch, so a kernel launched through ctypes inside a
  scope lands on the scope itself). A captured CUDA graph's replay has
  no Python forward and so no scopes, which is why trace mode runs the
  eager forward (the JAX package traces its jitted forward; torch hands
  its events over directly, so the JAX xplane reader has no
  counterpart here).
- **sync** — every layer alone between ``torch.cuda.synchronize``
  fences, min over ``reps`` (the same scopes, timed on the host clock;
  on the CPU the fences are no-ops). It sees no overlap between layers:
  it measures each layer as if dispatched alone.

The scopes are entered only while :func:`measure` or a
``train.listeners.ProfilingListener`` records (:func:`recorder`, one
global read a forward); a plain or captured forward is unchanged.

Attribution: per-layer forward FLOPs come from the analyzer's declared
shape model (``analysis.distribution._approx_flops`` over the config's
propagated input types, :func:`layer_flop_model`; for a
``TransformerLM``, :func:`transformer_flop_rows`), times batch, times the
train factor (backward = 2x forward, so 3.0). MFU is against the card's
peak for the model's compute dtype (``analysis.chipspec`` ``h100-sxm``:
989 TFLOP/s bf16, 67 TFLOP/s fp32). :class:`DeviceTimeTable` rows carry
(layer, op, seconds, flops, mfu, share); :meth:`~DeviceTimeTable.
top_offenders` names the layers burning the most device time; in trace
mode ``table.launches`` counts each scope's kernels by name.

Metrics: :meth:`DeviceTimeTable.export_metrics` publishes
``dl4j_op_device_seconds{model,layer,op}``, gated on
``profiler.instrumentation_active()``.
"""

from __future__ import annotations

import contextlib
import re
import time
import warnings
from typing import Dict, List, Optional, Tuple

import torch

from deeplearning4j_tpu_torch import profiler as _prof

#: scope-name prefix of the per-layer ``record_function`` scopes
SCOPE_PREFIX = "dl4j_L"
_SCOPE_RE = re.compile(r"dl4j_L(\d+)_([A-Za-z0-9_.\-]+)")

#: what a forward enters per layer while nothing records
NULL = contextlib.nullcontext()


def scope_name(index: int, name: str) -> str:
    """The per-layer scope string: ``dl4j_L<i>_<sanitized-name>``."""
    safe = re.sub(r"[^A-Za-z0-9_.\-]", "-", str(name))
    return f"{SCOPE_PREFIX}{index}_{safe}"


def default_peak_flops(dtype=None) -> float:
    """The H100's dense peak for a compute dtype (``analysis.chipspec``
    ``h100-sxm``: bf16/fp16 on the tensor cores, fp32 otherwise)."""
    from deeplearning4j_tpu_torch.analysis.chipspec import ChipSpec
    spec = ChipSpec.coerce("h100-sxm")
    if dtype in (torch.bfloat16, torch.float16):
        return spec.peak_for("bf16")
    return spec.peak_for("fp32")


# --------------------------------------------------------------- scopes
class _TraceRecorder:
    """Scopes for torch.profiler: a ``record_function`` per layer."""

    def scope(self, index: int, name: str):
        return torch.profiler.record_function(scope_name(index, name))


class _SyncTimer:
    __slots__ = ("rec", "index", "t0")

    def __init__(self, rec, index):
        self.rec, self.index = rec, index

    def __enter__(self):
        self.rec.fence()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.rec.fence()
        dt = time.perf_counter() - self.t0
        best = self.rec.seconds.get(self.index)
        self.rec.seconds[self.index] = dt if best is None else min(best, dt)
        return False


class _SyncRecorder:
    """Scopes that time each layer between device fences; keeps the
    least time a scope index took over the runs."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.seconds: Dict[int, float] = {}

    def fence(self):
        if self.cuda:
            torch.cuda.synchronize()

    def scope(self, index: int, name: str):
        return _SyncTimer(self, index)


_RECORDER = None


def recorder():
    """The active scope recorder, or None (the forwards' one read)."""
    return _RECORDER


@contextlib.contextmanager
def recording(rec=None):
    """Enter per-layer scopes in every forward while the block runs
    (``rec`` defaults to ``record_function`` scopes); nests."""
    global _RECORDER
    prev = _RECORDER
    _RECORDER = rec if rec is not None else _TraceRecorder()
    try:
        yield _RECORDER
    finally:
        _RECORDER = prev


def layer_scope(rec, index: int, name: str):
    """``rec.scope(index, name)``, or the shared null context."""
    return NULL if rec is None else rec.scope(index, name)


# ------------------------------------------------------------ FLOP model
def op_kind(layer) -> str:
    """Coarse op family for the metric label / table row."""
    cls = type(layer).__name__
    kinds = (("Separable", "conv2d"), ("Depthwise", "conv2d"),
             ("Deconvolution", "conv2d"), ("Convolution3D", "conv3d"),
             ("Convolution1D", "conv1d"), ("Convolution", "conv2d"),
             ("Subsampling", "pool"), ("GlobalPooling", "pool"),
             ("BatchNormalization", "batch_norm"),
             ("LocalResponseNormalization", "lrn"),
             ("LayerNorm", "layer_norm"), ("GroupNorm", "group_norm"),
             ("Embedding", "gather"), ("LSTM", "rnn"), ("GRU", "rnn"),
             ("Rnn", "rnn"), ("Attention", "attention"),
             ("Activation", "activation"), ("Dropout", "dropout"),
             ("Output", "loss_head"), ("Loss", "loss_head"),
             ("Yolo2", "loss_head"), ("Dense", "matmul"))
    for frag, kind in kinds:
        if frag in cls:
            return kind
    return cls.lower()


def layer_flop_model(conf) -> List[Tuple[str, str, int]]:
    """Per-example forward FLOPs per layer from declared config shapes
    (the analyzer's W105 model) for a sequential or a graph config:
    ``[(layer_name, op_kind, flops), ...]`` in forward order; a layer
    whose type propagation failed reports 0."""
    from deeplearning4j_tpu_torch.analysis.distribution import _approx_flops
    rows: List[Tuple[str, str, int]] = []
    if hasattr(conf, "graph_inputs"):            # ComputationGraph config
        types = getattr(conf, "types", {}) or {}
        for node in conf.topo:
            if node.kind != "layer":
                continue
            it = types.get(node.inputs[0]) if node.inputs else None
            out = types.get(node.name)
            try:
                f = _approx_flops(node.obj, it, out)
            except Exception:
                f = 0
            rows.append((node.name, op_kind(node.obj), int(f)))
        return rows
    in_types = list(getattr(conf, "layer_input_types", []) or [])
    for i, layer in enumerate(conf.layers):
        it = in_types[i] if i < len(in_types) else None
        out = None
        try:
            out = layer.output_type(it) if it is not None else None
        except Exception:
            out = None
        try:
            f = _approx_flops(layer, it, out)
        except Exception:
            f = 0
        rows.append((_layer_row_name(i, layer), op_kind(layer), int(f)))
    return rows


def _layer_row_name(i: int, layer) -> str:
    name = getattr(layer, "name", None) or type(layer).__name__
    if name == type(layer).__name__:
        name = f"{name.lower()}_{i}"
    return name


def transformer_scopes(cfg) -> List[Tuple[str, str]]:
    """The scopes of ``models.transformer.forward`` in order, as
    ``(name, op)``: the embedding, each block's ``ln1``, ``attn``,
    ``ln2`` and ``mlp``, the final norm and the head (the post-LN
    encoder: the embedding norm, then ``attn``, ``ln1``, ``mlp``,
    ``ln2`` a block)."""
    rows = [("embed", "gather")]
    post = cfg.arch == "postln_bert"
    if post:
        rows.append(("emb_norm", "layer_norm"))
    for b in range(cfg.n_layers):
        block = [(f"b{b}.attn", "attention"), (f"b{b}.ln1", "layer_norm"),
                 (f"b{b}.mlp", "matmul"), (f"b{b}.ln2", "layer_norm")]
        if not post:
            block = [block[1], block[0], block[3], block[2]]
        rows.extend(block)
    if not post:
        rows.append(("final_norm", "layer_norm"))
    rows.append(("head", "matmul"))
    return rows


def transformer_flop_rows(cfg, seq_len: int) -> List[Tuple[str, str, int]]:
    """Per-example forward FLOPs of each :func:`transformer_scopes` scope
    at ``seq_len`` tokens: 2 per multiply-add of the projections, the
    scores and the context; 0 for norms and the gather."""
    T, E, F, V = seq_len, cfg.d_model, cfg.d_ff, cfg.vocab_size
    flops = {"attention": 2 * T * E * 3 * E + 2 * 2 * T * T * E
             + 2 * T * E * E,
             "matmul": 2 * T * E * F * 2}
    rows = []
    for name, op in transformer_scopes(cfg):
        f = flops.get(op, 0)
        if name == "head":
            f = 2 * T * E * V
        rows.append((name, op, int(f)))
    return rows


# --------------------------------------------------------------- results
class LayerTime:
    """One attribution row: device seconds + FLOP-model MFU for a layer."""

    __slots__ = ("layer", "op", "seconds", "flops", "mfu", "share")

    def __init__(self, layer: str, op: str, seconds: float, flops: float,
                 mfu: Optional[float], share: float):
        self.layer = layer
        self.op = op
        self.seconds = seconds
        self.flops = flops
        self.mfu = mfu
        self.share = share

    def as_dict(self) -> dict:
        return {"layer": self.layer, "op": self.op,
                "device_ms": round(self.seconds * 1e3, 4),
                "gflops": round(self.flops / 1e9, 3),
                "mfu": None if self.mfu is None else round(self.mfu, 4),
                "time_share": round(self.share, 4)}

    def __repr__(self):
        return (f"LayerTime({self.layer}, {self.op}, "
                f"{self.seconds * 1e3:.3f}ms, mfu={self.mfu})")


class DeviceTimeTable:
    """Per-layer device-time MFU attribution for one model + batch.
    ``launches`` (trace mode) maps a row's layer name to its kernels'
    launch counts a forward, by kernel name."""

    def __init__(self, rows: List[LayerTime], source: str,
                 batch: int, peak_flops: float, train_factor: float,
                 launches: Optional[Dict[str, Dict[str, float]]] = None):
        self.rows = rows
        self.source = source          # "trace" | "sync"
        self.batch = batch
        self.peak_flops = peak_flops
        self.train_factor = train_factor
        self.launches = launches or {}

    @property
    def total_seconds(self) -> float:
        return sum(r.seconds for r in self.rows)

    def top_offenders(self, n: int = 3) -> List[dict]:
        """The layers burning the most device time, worst first."""
        ranked = sorted(self.rows, key=lambda r: -r.seconds)
        return [r.as_dict() for r in ranked[:n]]

    def as_rows(self, n: Optional[int] = None) -> List[dict]:
        ranked = sorted(self.rows, key=lambda r: -r.seconds)
        if n is not None:
            ranked = ranked[:n]
        return [r.as_dict() for r in ranked]

    def export_metrics(self, model_name: str) -> bool:
        """Publish ``dl4j_op_device_seconds{model,layer,op}``. Gated on
        the profiling mode: OFF records nothing."""
        if not _prof.instrumentation_active():
            return False
        c = _prof.get_registry().counter(
            "dl4j_op_device_seconds",
            "Per-layer DEVICE seconds attributed by the devicetime "
            "bridge (torch.profiler kernel events by layer scope, or "
            "per-layer fenced timing on the CPU)",
            labelnames=("model", "layer", "op"))
        for r in self.rows:
            c.labels(model=model_name, layer=r.layer, op=r.op).inc(r.seconds)
        return True


# ------------------------------------------------------ trace attribution
def _scope_index(evt) -> Optional[int]:
    """The innermost ``dl4j_L`` scope at or above ``evt`` (a profiler
    FunctionEvent: ``name``, ``cpu_parent``), as its index."""
    seen = 0
    while evt is not None and seen < 10000:
        m = _SCOPE_RE.match(getattr(evt, "name", "") or "")
        if m is not None:
            return int(m.group(1))
        evt = getattr(evt, "cpu_parent", None)
        seen += 1
    return None


def scope_seconds_from_events(events) -> Tuple[Dict[int, float],
                                                Dict[int, Dict[str, int]]]:
    """``({scope index: device seconds}, {scope index: {kernel: launches}})``
    over profiler events: every CPU event's ``kernels`` (name, duration
    in µs, as torch.profiler links them) go to the innermost scope of the
    event. A device-side span of a scope itself (its user annotation on
    the card's timeline) is no kernel and is skipped."""
    seconds: Dict[int, float] = {}
    launches: Dict[int, Dict[str, int]] = {}
    for evt in events:
        kernels = getattr(evt, "kernels", None)
        if not kernels:
            continue
        idx = _scope_index(evt)
        if idx is None:
            continue
        for k in kernels:
            if str(k.name).startswith(SCOPE_PREFIX):
                continue
            seconds[idx] = seconds.get(idx, 0.0) + float(k.duration) * 1e-6
            per = launches.setdefault(idx, {})
            per[k.name] = per.get(k.name, 0) + 1
    return seconds, launches


def kernel_events(events) -> int:
    """How many device kernels torch.profiler linked to CPU events."""
    return sum(len(getattr(e, "kernels", None) or ()) for e in events)


def _trace_layer_seconds(run_fn, warm_fn):
    """Run ``run_fn()`` under torch.profiler (CPU + CUDA) with the
    per-layer scopes on, after one ``warm_fn()`` in the profiler's warm-up
    step (traced and dropped: the tracer's start-up stays out of the
    measured step); ``(seconds, launches)`` by scope index, or None when
    the profile holds no kernel event."""
    from torch.profiler import ProfilerActivity, profile, schedule
    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    got = []
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*clears events")
        with profile(activities=acts,
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                     on_trace_ready=lambda p: got.append(p.events())) as prof:
            with recording():
                for fn in (warm_fn, run_fn):
                    fn()
                    if cuda:
                        torch.cuda.synchronize()
                    prof.step()
    events = got[0] if got else []
    if not kernel_events(events):
        return None
    return scope_seconds_from_events(events)


# --------------------------------------------------------------- measure
def _forward_fn(model, features):
    """``(run once, batch, compute dtype, flop rows, row key)``: the
    model's eager forward on ``features`` and how its scope indices map
    to flop rows."""
    from deeplearning4j_tpu_torch.models.transformer import TransformerLM
    if isinstance(model, TransformerLM):
        x = features
        batch, seq = int(x.shape[0]), int(x.shape[1])
        rows = transformer_flop_rows(model.cfg, seq)

        def run():
            model.logits(x)
        return run, batch, model.cfg.dtype, dict(enumerate(rows)), \
            next(model.parameters()).is_cuda
    flops_rows = layer_flop_model(model.conf)
    if hasattr(model.conf, "graph_inputs"):
        x = model._as_input_dict(features)
        first = next(iter(x.values()))
        keyed, li = {}, 0
        for i, node in enumerate(model.conf.topo):
            if node.kind == "layer":
                keyed[i] = flops_rows[li]
                li += 1
            else:
                keyed[i] = (node.name, "vertex", 0)
    else:
        x = model._to_device(features)
        first = x
        keyed = dict(enumerate(flops_rows))

    def run_net():
        model.output(x)
    return run_net, int(first.shape[0]), model._compute_dtype(), keyed, \
        first.is_cuda


def measure(model, features, *, reps: int = 3, mode: str = "auto",
            peak_flops: Optional[float] = None, train_factor: float = 3.0,
            trace_run=None) -> DeviceTimeTable:
    """Per-layer device time of the model's eager forward on
    ``features`` (a ``MultiLayerNetwork``, a ``ComputationGraph`` or a
    ``TransformerLM`` on its tokens), with MFU per layer against the
    FLOP model.

    ``mode``: ``"trace"`` (torch.profiler, ``reps`` forwards, or
    ``trace_run()``; raises when the profile holds no CUDA kernel event),
    ``"sync"`` (each layer between fences, min of ``reps``), ``"auto"``
    (trace on the card, sync on the CPU). ``peak_flops`` defaults to the
    H100's peak for the model's compute dtype. ``train_factor`` turns
    forward FLOPs into the training convention (3.0; 1.0 for
    inference)."""
    run, batch, cdt, keyed, on_card = _forward_fn(model, features)
    if peak_flops is None:
        peak_flops = default_peak_flops(cdt)
    n_runs = max(1, int(reps))
    per_layer = None
    launches: Dict[int, Dict[str, int]] = {}
    source = "sync"
    if mode == "trace" or (mode == "auto" and on_card):
        with torch.no_grad():
            got = _trace_layer_seconds(
                trace_run or (lambda: [run() for _ in range(n_runs)]), run)
        if got is not None:
            per_layer, launches = got
            source = "trace"
            if trace_run is None:
                per_layer = {k: v / n_runs for k, v in per_layer.items()}
                launches = {k: {n: c / n_runs for n, c in v.items()}
                            for k, v in launches.items()}
        elif mode == "trace":
            raise RuntimeError(
                "the torch.profiler trace holds no CUDA kernel event (no "
                "card, or CUPTI gave none): use mode='sync' (or 'auto')")
    if per_layer is None:
        rec = _SyncRecorder(on_card)
        with torch.no_grad(), recording(rec):
            for _ in range(n_runs + 1):      # the first run warms
                run()
        per_layer = rec.seconds

    total = sum(per_layer.values()) or 1.0
    rows = []
    named_launches = {}
    for idx, secs in sorted(per_layer.items()):
        name, op, fl = keyed.get(idx, (f"layer_{idx}", "unknown", 0))
        fl_total = float(fl) * batch * train_factor
        mfu = (float(fl) * batch) / (secs * peak_flops) \
            if secs > 0 and fl else None
        rows.append(LayerTime(str(name), op, secs, fl_total,
                              None if mfu is None else min(mfu, 1.0),
                              secs / total))
        if idx in launches:
            named_launches[str(name)] = launches[idx]
    return DeviceTimeTable(rows, source, batch, peak_flops, train_factor,
                           named_launches)


def attribution_detail(model, features, *, model_name: str,
                       peak_flops: Optional[float] = None,
                       reps: int = 3, top: int = 8,
                       mode: str = "auto") -> dict:
    """The bench-row payload: the per-layer table (top-N by device time),
    ``top_offenders`` and the capture source; exports the
    ``dl4j_op_device_seconds`` series while instrumentation is active."""
    table = measure(model, features, reps=reps, mode=mode,
                    peak_flops=peak_flops)
    table.export_metrics(model_name)
    return {"source": table.source,
            "device_ms_total": round(table.total_seconds * 1e3, 3),
            "per_layer": table.as_rows(top),
            "top_offenders": table.top_offenders(3)}
