"""Nonfinite-provenance sanitizer — NAN_PANIC that names the culprit (the
port of ``deeplearning4j_tpu/profiler/sanitizer.py``).

Under ``ProfilingMode.NAN_PANIC`` (``INF_PANIC``) a fit raises
:class:`NonfiniteAttributionError` (a ``NumericsPanicError``) when a step's
loss comes back NaN (Inf), naming the FIRST non-finite as ``(layer, op,
step)``: ops ``batch``/``augment`` (the input, layer ``"<input>"`` or
``"<input:name>"``), ``params``, ``forward:<Layer>``/``vertex:<Vertex>``,
``loss:<fn>``, ``backward``, ``updater:<Updater>``, ``carried-state``
(TBPTT); layers are ``"<i>:<name>"`` in a sequential net and node names
in a graph. The site is also the ``dl4j_nonfinite_first_site{model,layer,
op}`` gauge (value: the 1-based step); ``dl4j_nonfinite_panics_total``
counts the panics.

- **Hot path.** With no panic mode on, :func:`snapshot` and :func:`check`
  cost one enum read each and the step is unchanged (eager or captured).
  Under a panic mode each model keeps a *provenance window*: a copy of
  its whole dispatch state (``_dispatch_state()``: params, layer states,
  updater state, the clock, the loss-scale and lr-scale tensors) taken
  every ``snapshot_every`` (8) update steps into buffers of the
  sanitizer's own (one ``torch._foreach_copy_``, no host read), plus the
  device arguments of every dispatch since (the fit stages each batch
  into fresh tensors, so a reference keeps it). The loss gate reads the
  dispatch's loss(es) on the host, as the panic modes always did.
- **Failure path.** The live tensors are saved, the snapshot is copied
  INTO them (a captured graph reads their storage, so they are never
  rebound), the retained steps are replayed one at a time through the
  model's own single-step dispatch (``_dispatch_for(sig, 1)``; the K-step
  body is K of those steps, so the replay reaches the failing step's
  state), the failing step is walked eagerly through the network's own
  forward (``visit=``; the kernels' overrides run in it as on the main
  path), and the saved live state is copied back: after the raise the
  net holds the state at the end of the failing dispatch, as it would
  without the sanitizer. A failed replay is reported as layer
  ``"<replay-failed>"`` rather than masking the panic.
- **Value ranges** (:func:`track_value_ranges`): under a panic mode,
  every N-th step runs one eager forward of the live params on the batch
  and records each layer's activation |max| into
  ``dl4j_tensor_absmax{model,layer}`` (:data:`ABSMAX_BUCKETS`) and, for a
  bf16/fp16 compute dtype, ``dl4j_overflow_proximity`` = the largest
  |max| / ``torch.finfo(compute).max``.

:func:`invalidate` voids a model's window after an out-of-band state
change (``init``, a checkpoint restore, a skipped dispatch's restore, a
planned layer poison); a gap in the iteration sequence does too.
"""

from __future__ import annotations

import weakref
from typing import List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.profiler.metrics import get_registry
from deeplearning4j_tpu_torch.profiler.modes import (ProfilingMode,
                                                     get_profiling_mode)
from deeplearning4j_tpu_torch.utils.environment import NumericsPanicError

#: |max| buckets for dl4j_tensor_absmax: decades up to fp16-max, then the
#: bf16/fp32 range — a histogram shaped for "how far from overflow"
ABSMAX_BUCKETS = (1e-4, 1e-2, 1.0, 1e1, 1e2, 1e3, 1e4, 65504.0,
                  1e6, 1e9, 1e12, 1e18, 1e24, 1e30, 1e38)

_FIRST_SITE = get_registry().gauge(
    "dl4j_nonfinite_first_site",
    "First nonfinite site attributed by the provenance sanitizer "
    "(value = 1-based update step; labels name the model, layer, op)",
    labelnames=("model", "layer", "op"))
_PANICS = get_registry().counter(
    "dl4j_nonfinite_panics_total",
    "Nonfinite losses caught (and attributed) by the panic sanitizer")
_ABSMAX = get_registry().histogram(
    "dl4j_tensor_absmax",
    "Per-layer activation |max| samples from opt-in value-range tracking",
    labelnames=("model", "layer"), buckets=ABSMAX_BUCKETS)
_PROXIMITY = get_registry().gauge(
    "dl4j_overflow_proximity",
    "max per-layer activation |max| / finfo(compute dtype).max from the "
    "most recent range-tracking walk (bf16/fp16; 1.0 = at the overflow "
    "ceiling)")

_TRACK_RANGES = False
_TRACK_EVERY = 1
_PROVENANCE = True
#: update steps between state snapshots: the copy is paid 1/N of the
#: time and attribution replays up to N steps from the last one
_SNAPSHOT_EVERY = 8

_PANIC_MODES = (ProfilingMode.NAN_PANIC, ProfilingMode.INF_PANIC)


def enable_provenance(enabled: bool = True,
                      snapshot_every: Optional[int] = None) -> None:
    """``enable_provenance(False)`` keeps the loss gate but takes no
    snapshot (the raise then carries no site); ``snapshot_every`` sets
    the snapshot cadence in update steps."""
    global _PROVENANCE, _SNAPSHOT_EVERY
    _PROVENANCE = bool(enabled)
    if snapshot_every is not None:
        _SNAPSHOT_EVERY = max(1, int(snapshot_every))


def track_value_ranges(enable: bool = True, every: int = 1) -> None:
    """Opt-in |max| tracking: while a panic mode is active, every
    ``every``-th update step runs one eager forward on the live batch and
    records ``dl4j_tensor_absmax`` per layer and the overflow-proximity
    gauge. A whole extra forward a sampled step: a diagnostic dial."""
    global _TRACK_RANGES, _TRACK_EVERY
    _TRACK_RANGES = bool(enable)
    _TRACK_EVERY = max(1, int(every))


class NonfiniteAttributionError(NumericsPanicError):
    """NAN_PANIC/INF_PANIC with provenance: carries the first-nonfinite
    (layer, op, step) the replay attributed."""

    def __init__(self, message: str, layer: str = "", op: str = "",
                 step: int = 0):
        super().__init__(message)
        self.layer = layer
        self.op = op
        self.step = step


def active() -> bool:
    """One enum read: True while a panic mode wants the sanitizer armed."""
    return get_profiling_mode() in _PANIC_MODES


class _ModelSan:
    """A model's provenance window: the snapshot buffers, the step they
    hold, and ``(kind, sig, args, start step, steps)`` of every dispatch
    since."""

    __slots__ = ("bufs", "snap_step", "expected_next", "ring")

    def __init__(self, bufs, snap_step):
        self.bufs = bufs
        self.snap_step = snap_step
        self.expected_next = snap_step
        self.ring: list = []


class _Token:
    """One dispatch's provenance handle: the window and this dispatch's
    place in its ring."""

    __slots__ = ("state", "ring_index", "step0", "kind", "sig", "args")

    def __init__(self, state, ring_index, step0, kind, sig, args):
        self.state = state
        self.ring_index = ring_index
        self.step0 = step0      # 0-based iteration count before dispatch
        self.kind = kind        # "single" | "mega" | "tbptt"
        self.sig = sig
        self.args = args


_STATES: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def invalidate(model) -> None:
    """Void the provenance window after an out-of-band state change the
    replay cannot reproduce (a re-init, a restore, a planned poison):
    the next dispatch takes a fresh snapshot."""
    _STATES.pop(model, None)


def _steps_of(kind: str, args) -> int:
    if kind == "mega":
        return int(next(a for a in args if a is not None).shape[0])
    return 1


def snapshot(model, kind: str, sig, args) -> Optional[_Token]:
    """Arm provenance for one dispatch of ``args`` (its device arguments;
    ``kind`` ``"single"``, ``"mega"`` (``[K, ...]`` arguments) or
    ``"tbptt"``, ``sig`` its dispatch signature). Returns None (one enum
    read) unless a panic mode is active. Every ``snapshot_every`` steps,
    and after a gap or :func:`invalidate`, the whole dispatch state is
    copied into the sanitizer's buffers; between copies only the
    arguments are kept."""
    if not (_PROVENANCE and active()):
        return None
    it = model._iteration
    st = _STATES.get(model)
    if st is None or st.expected_next != it \
            or it - st.snap_step >= _SNAPSHOT_EVERY:
        live = [t.detach() for t in model._dispatch_state()]
        bufs = [torch.empty_like(t) for t in live]
        torch._foreach_copy_(bufs, live)
        st = _ModelSan(bufs, it)
        _STATES[model] = st
    n = _steps_of(kind, args)
    st.ring.append((kind, sig, tuple(args), it, n))
    st.expected_next = it + n
    return _Token(st, len(st.ring) - 1, it, kind, sig, tuple(args))


def _host_values(losses) -> np.ndarray:
    if isinstance(losses, torch.Tensor):
        return losses.detach().float().reshape(-1).cpu().numpy()
    return np.asarray(losses, dtype=np.float64).reshape(-1)


def check(model, token: Optional[_Token], losses,
          context: str = "loss") -> None:
    """Post-dispatch numerics gate: under a panic mode, read the loss
    (vector) and raise on NaN (NAN_PANIC) or Inf (INF_PANIC), naming the
    first non-finite when ``token`` holds a window; a clean sampled step
    drives the value-range walk. With no panic mode on: one enum read,
    no device read."""
    mode = get_profiling_mode()
    if mode not in _PANIC_MODES:
        return
    vals = _host_values(losses)
    if mode is ProfilingMode.NAN_PANIC:
        bad, label = np.isnan(vals), "NAN_PANIC"
    else:
        bad, label = np.isinf(vals), "INF_PANIC"
    if not bad.any():
        if token is not None and _TRACK_RANGES \
                and token.step0 % _TRACK_EVERY == 0:
            _record_ranges(model, token)
        return
    _PANICS.inc()
    j = int(np.argmax(bad))                  # first bad step in the dispatch
    step = (token.step0 if token is not None else model._iteration) + j + 1
    site = None
    if token is not None:
        try:
            site = _attribute(model, token, j)
        except Exception as e:               # a diagnostic must not mask
            site = ("<replay-failed>", f"error:{type(e).__name__}")
    if site is None:
        raise NumericsPanicError(
            f"{label}: nonfinite detected in {context} "
            f"(step {step}; no provenance snapshot available)")
    layer, op = site
    _FIRST_SITE.labels(model=type(model).__name__, layer=layer,
                       op=op).set(step)
    raise NonfiniteAttributionError(
        f"{label}: nonfinite detected in {context} — first nonfinite "
        f"attributed to layer '{layer}', op '{op}', step {step}",
        layer=layer, op=op, step=step)


# ------------------------------------------------------------ attribution
def _slice(args, j):
    return tuple(None if a is None else a[j] for a in args)


def _roll(model, kind: str, sig, args, n: int) -> None:
    """Advance the live state ``n`` update steps through the model's own
    single-step dispatch (the TBPTT window step for a window)."""
    if n <= 0:
        return
    if kind == "tbptt":
        model._tbptt_for(sig)(*args)
        return
    d = model._dispatch_for(sig, 1)
    for i in range(n):
        d(*(_slice(args, i) if kind == "mega" else args))


def _attribute(model, token: _Token, j: int) -> Tuple[str, str]:
    """Replay step ``token.step0 + j`` from the window's snapshot and
    walk it eagerly; the live state is copied back afterwards."""
    st = token.state
    _STATES.pop(model, None)
    live = model._dispatch_state()
    if len(live) != len(st.bufs):
        raise RuntimeError("the dispatch state changed inside the window")
    with torch.no_grad():
        saved = [t.detach().clone() for t in live]
        torch._foreach_copy_(live, st.bufs)
    try:
        for kind_i, sig_i, args_i, _it, n_i in st.ring[:token.ring_index]:
            _roll(model, kind_i, sig_i, args_i, n_i)
        _roll(model, token.kind, token.sig, token.args, j)
        args = _slice(token.args, j) if token.kind == "mega" else token.args
        if token.kind == "tbptt":
            return _attribute_tbptt(model, token.sig, args)
        return _attribute_step(model, token.sig, args)
    finally:
        with torch.no_grad():
            torch._foreach_copy_(live, saved)


class _Sites:
    """Candidate sites in walk order, each with a device flag; one host
    read finds the first that is set."""

    def __init__(self):
        self.names: List[Tuple[str, str]] = []
        self.flags: List[torch.Tensor] = []

    def add(self, layer: str, op: str, *tensors) -> None:
        ts = [t for t in tensors if isinstance(t, torch.Tensor)
              and t.is_floating_point()]
        if not ts:
            return
        flag = torch.stack([~torch.isfinite(t.detach()).all() for t in ts]
                           ).any()
        self.names.append((layer, op))
        self.flags.append(flag)

    def first(self) -> Optional[Tuple[str, str]]:
        if not self.flags:
            return None
        idx = np.flatnonzero(torch.stack(self.flags).cpu().numpy())
        return self.names[int(idx[0])] if idx.size else None


def _unpack(model, sig, args):
    """``(ins, labels, masks, fmask)`` of one step's arguments, in the
    form the network's ``_loss_and_reg`` takes."""
    if sig[0] == "multi":
        _, n_in, n_out, masked = sig
        ins = dict(zip(model.conf.graph_inputs, args[:n_in]))
        labels = list(args[n_in:n_in + n_out])
        masks = list(args[n_in + n_out:]) if masked else None
        return ins, labels, masks, None
    x, y, lmask, fmask = args
    ins, labels, masks = model._pack(x, y, lmask, True)
    return ins, labels, masks, fmask


def _is_graph(model) -> bool:
    return hasattr(model.conf, "graph_inputs")


def _attribute_step(model, sig, args) -> Tuple[str, str]:
    """First non-finite of one plain (or K-step slice) step on the live,
    replayed state: the input, each layer's params and output, the loss,
    the gradients, the updater."""
    from deeplearning4j_tpu_torch.ops.normalization import StepKey
    ins, labels, masks, fmask = _unpack(model, sig, args)
    graph = _is_graph(model)
    sites = _Sites()
    with torch.no_grad():
        if graph:
            for k, v in ins.items():
                sites.add(f"<input:{k}>", "batch", v)
            aug = model._augment_ins(ins)
        else:
            sites.add("<input>", "batch", ins)
            aug = model._augment_ins(ins)
            if model._augment is not None:
                sites.add("<input>", "augment", aug)
        key = StepKey(model.conf.base.seed, model._t_dev)

        def visit(name, obj, p, out):
            if p:
                sites.add(name, "params", *p.values())
            kind = "forward"
            if graph and model.conf.node_by_name[name].kind != "layer":
                kind = "vertex"
            sites.add(name, f"{kind}:{type(obj).__name__}", out)
        out, _ = model._forward(model._params, model._states, aug, True,
                                key, fmask, visit=visit)
        if graph:
            for i, name in enumerate(model.conf.graph_outputs):
                head = model.conf.node_by_name[name].obj
                lm = masks[i] if masks is not None else None
                sites.add(name, f"loss:{getattr(head, 'loss_fn', '?')}",
                          head.compute_loss(labels[i], out[i], mask=lm))
        else:
            head = model.layers[-1]
            sites.add(f"{len(model.layers) - 1}:{head.name}",
                      f"loss:{getattr(head, 'loss_fn', '?')}",
                      head.compute_loss(labels, out, mask=masks))
    hit = sites.first()
    if hit is not None:
        return hit

    def loss_fn():
        return model._loss_and_reg(model._params, model._states, aug,
                                   labels, True, masks, key,
                                   fmask=fmask)[0]
    return _grad_site(model, loss_fn)


def _loss_scale(model):
    """The scale the step applies to its loss: the dynamic automaton's
    live (replayed) value, the static factor, or None."""
    pol = model._precision
    if pol is None:
        return None
    if pol.is_dynamic:
        return model._ensure_scale_state()[0]
    return pol.loss_scale


def _layer_names(model) -> List[Tuple[object, str]]:
    """``(key, name)`` of every layer in the JAX package's gradient-tree
    order: index order in a sequential net, sorted names in a graph."""
    if _is_graph(model):
        return [(n, n) for n in sorted(model._params)]
    return [(i, f"{i}:{layer.name}") for i, layer in enumerate(model.layers)]


def _grad_site(model, loss_fn) -> Tuple[str, str]:
    """The backward (scaled, as the step scales it) and then one updater
    step applied eagerly to the live state (restored by the caller): the
    first layer whose gradients, updater state or params go non-finite."""
    order = _layer_names(model)
    names = [(n, k) for n, _ in order for k in model._params[n]]
    leaves = [model._params[n][k] for n, k in names]
    scale = _loss_scale(model)
    with torch.enable_grad():
        loss = loss_fn()
        scaled = loss * scale if scale is not None else loss
        grads = torch.autograd.grad(scaled, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g.detach()
             for p, g in zip(leaves, grads)]
    by_layer = {}
    for (n, _k), g in zip(names, grads):
        by_layer.setdefault(n, []).append(g)
    sites = _Sites()
    for n, label in order:
        sites.add(label, "backward", *by_layer.get(n, ()))
    hit = sites.first()
    if hit is not None:
        return hit
    if scale is not None:
        grads = [g / scale for g in grads]
    upd_name = type(model.conf.base.updater).__name__
    model._process_and_apply_grads(names, leaves, grads)
    sites = _Sites()
    for n, label in order:
        opt = model._opt_state.get(n) or {}
        tensors = [t for st in opt.values() for t in st.values()]
        sites.add(label, f"updater:{upd_name}", *tensors)
    for n, label in order:
        sites.add(label, f"updater:{upd_name}", *model._params[n].values())
    hit = sites.first()
    if hit is not None:
        return hit
    return (order[-1][1] if order else "<model>"), "dispatch"


def _attribute_tbptt(model, sig, args) -> Tuple[str, str]:
    """First non-finite of one TBPTT window from its recorded carried
    state: the input, each layer's params, carried state and output, the
    loss, the gradients, the updater."""
    from deeplearning4j_tpu_torch.ops.normalization import StepKey
    x, y, lmask = args[:3]
    carry = args[3:]
    sites = _Sites()
    key = StepKey(model.conf.base.seed, model._t_dev)
    with torch.no_grad():
        sites.add("<input>", "batch", x)

        def visit(name, layer, p, out, carried):
            i = int(name.split(":", 1)[0])
            sites.add(name, "params", *model._params[i].values())
            if carried is not None:
                sites.add(name, "carried-state",
                          *(carried if isinstance(carried, tuple)
                            else (carried,)))
            sites.add(name, f"forward:{type(layer).__name__}", out)
        out, _ = model._tbptt_forward(x, carry, key, visit=visit)
        head = model.layers[-1]
        sites.add(f"{len(model.layers) - 1}:{head.name}",
                  f"loss:{getattr(head, 'loss_fn', '?')}",
                  head.compute_loss(y, out, mask=lmask))
    hit = sites.first()
    if hit is not None:
        return hit

    def loss_fn():
        cur, _ = model._tbptt_forward(x, carry, key)
        return head.compute_loss(y, cur, mask=lmask)
    return _grad_site(model, loss_fn)


# --------------------------------------------------- value-range tracking
def _record_ranges(model, token: _Token) -> None:
    """One eager forward of the live params on the dispatch's (first)
    batch, recording each layer's activation |max|."""
    try:
        sites = _collect_absmax(model, token)
    except Exception:
        return                              # diagnostics never break a fit
    if not sites:
        return
    mname = type(model).__name__
    peak = 0.0
    for layer, amax in sites:
        _ABSMAX.labels(model=mname, layer=layer).observe(amax)
        if np.isfinite(amax):
            peak = max(peak, amax)
    cdt = model._compute_dtype()
    if cdt in (torch.bfloat16, torch.float16):
        _PROXIMITY.set(peak / float(torch.finfo(cdt).max))


def _collect_absmax(model, token: _Token) -> List[Tuple[str, float]]:
    """``[(layer, |max|)]`` over the network's forward (inference mode)
    with one host read."""
    from deeplearning4j_tpu_torch.ops.normalization import StepKey
    if token.kind == "tbptt":
        return []
    args = _slice(token.args, 0) if token.kind == "mega" else token.args
    ins, _labels, _masks, fmask = _unpack(model, token.sig, args)
    names: List[str] = []
    amaxes: List[torch.Tensor] = []

    def visit(name, obj, p, out):
        names.append(name)
        amaxes.append(out.detach().abs().max().float() if out.numel()
                      else torch.zeros((), device=out.device))
    with torch.no_grad():
        model._forward(model._params, model._states, ins, False,
                       StepKey(0, token.step0), fmask, visit=visit)
    if not amaxes:
        return []
    vals = torch.stack(amaxes).cpu().numpy().astype(np.float64)
    return list(zip(names, vals.tolist()))
