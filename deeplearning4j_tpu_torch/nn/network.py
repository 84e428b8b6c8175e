"""What :class:`.graph.ComputationGraph` and
:class:`.multilayer.MultiLayerNetwork` share: the training step, the
dtype policy, the layout and fusion switches, and the flat parameter
views.

A subclass holds its params and layer states in ``_params``/``_states``
(a dict by node name in the graph, a list by layer index in the
sequential network) and supplies:

- ``_layers()``: ``[(key, layer)]`` of every layer, in order;
- ``_leaf_keys()``: the params' ``(key, name)`` in the JAX package's
  pytree order (what :meth:`params` flattens);
- ``_pack(x, y, lmask, train)``: device tensors of one batch as
  ``(inputs, labels, masks)`` in the form its ``_loss_and_reg`` takes;
- ``_loss_and_reg(params, states, inputs, labels, train, masks, key,
  fmask=None)`` (``fmask``, a ``[N, T]`` feature mask, goes to the
  mask-aware layers) and ``_ensure_epilogue_plan()``.

A train step's dropout key is ``StepKey(seed, t)`` on the device clock
``t`` (``ops.normalization``); each network folds in its layer's ordinal
(the JAX package's per-layer key split), so the masks are a function of
the seed, the step and the layer alone. ``evaluate`` keeps predictions
on the device and pulls them in chunks (:func:`predict_batches`).

The step (:meth:`BaseNetwork._train_step`) updates every piece of state
in place: the params, the updater state, the layers' running statistics
and the device clock ``_t_dev`` keep their storage, so the step can be
captured as a CUDA graph and replayed (:mod:`.compilecache`). It goes
through a :class:`~.compilecache.CachedDispatch`: one step a dispatch
runs eagerly until a signature is warmed (:func:`.compilecache.warmup`);
each mask signature (feature mask given, label mask given) has a
dispatch of its own, and so does each MultiDataSet arity in the graph;
``fit(steps_per_dispatch=K)`` runs K steps a dispatch
(:mod:`deeplearning4j_tpu_torch.train.stepping`), captured on the card
at a signature's first dispatch, fed by a ``DevicePrefetcher`` that
stages the next megabatch on a side stream while the current one runs
(``prefetch=2``, the reference's default; ``prefetch=0`` stages on the
calling thread). A staged pipeline iterator (``data.pipeline``) whose
``megabatch_steps`` is K hands the fit whole ``[K, B, ...]`` megabatches
(``dispatch_stream``). ``evaluate`` pulls its batches through an
``AsyncDataSetIterator`` unless ``prefetch=False``.

The dispatch and the data wait before it are timed while
instrumentation is active (``dl4j_train_step_seconds``,
``dl4j_train_data_wait_seconds``; ``profiler.data_overlap_ratio``).

Around the step (the JAX package's fit surroundings):

- ``setDeviceAugmentation`` / ``fit(augment=)``: a
  :class:`~.augment.DeviceAugmentation` runs as the step's prelude on
  every 4-D input; its ``signature()`` is part of the step-cache key.
- ``PrecisionPolicy(loss_scale="dynamic")``: ``[scale, good_steps]``
  (``_scale_state``) is a device tensor of the dispatch state; the step
  scales the loss, unscales the gradients, tests them all finite in one
  reduction, keeps or drops every update with ``torch.where`` (no host
  read) and ticks the automaton (``nn.precision``).
- The updater's ``_lr_scale``, once a device tensor
  (:meth:`BaseNetwork._ensure_lr_scale`), is dispatch state too: the
  ``NanPolicy.BACKOFF_LR`` recovery writes it in place.
- ``setListeners``/``addListeners``: ``onIterationStart`` and
  ``iterationDone`` around each step (after a K-step dispatch, once a
  step, with lazy device losses), ``onEpochEnd`` after each epoch.
- ``fit(checkpoint=, nan_policy=, faults=)`` runs the epochs under a
  :class:`~deeplearning4j_tpu_torch.train.resilience.TrainingSession`
  (``train.resilience``). A fit without them adds no host read and no
  launch.
- Under ``ProfilingMode.NAN_PANIC``/``INF_PANIC`` every dispatch (one
  step, K steps, a TBPTT window) goes through the provenance sanitizer
  (``profiler.sanitizer``: :func:`~deeplearning4j_tpu_torch.profiler.
  sanitizer.snapshot` before, :func:`~deeplearning4j_tpu_torch.profiler.
  sanitizer.check` after), which raises ``NonfiniteAttributionError``
  naming the first non-finite (layer, op, step); with no panic mode on
  each costs one enum read.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import profiler as _prof
from deeplearning4j_tpu_torch.analysis import churn
from deeplearning4j_tpu_torch.data.dataset import (AsyncDataSetIterator,
                                                   DataSet,
                                                   IterableDataSetIterator,
                                                   MultiDataSet, to_device)
from deeplearning4j_tpu_torch.evaluation.evaluation import Evaluation
from deeplearning4j_tpu_torch.nn import compilecache as cc
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn import precision
from deeplearning4j_tpu_torch.nn.augment import maybe_augment
from deeplearning4j_tpu_torch.ops import normalization as norm_ops
from deeplearning4j_tpu_torch.profiler import sanitizer as _san
from deeplearning4j_tpu_torch.train import resilience, stepping
from deeplearning4j_tpu_torch.train import updaters as upd

#: batches of predictions held on the device between pulls
EVAL_PULL_CHUNK = 64


def _epoch_of(iterator, steps: int = 1, session=None):
    """One epoch of a DataSetIterator-style object (reset first, unless a
    resumed session has just sought it): whole megabatches from its
    ``dispatch_stream()`` when
    :func:`~deeplearning4j_tpu_torch.train.stepping.use_dispatch_stream`
    holds for ``steps``, else its batches."""
    if session is None or not session.consume_skip_reset():
        iterator.reset()
    if stepping.use_dispatch_stream(iterator, steps, session):
        yield from iterator.dispatch_stream()
        return
    while iterator.hasNext():
        yield iterator.next()


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else a


def _eval_iterator(iterator, prefetch: bool = True):
    """``evaluate``'s source: ``(iterator, owned)``. A DataSetIterator-style
    object (or any iterable of DataSets, through IterableDataSetIterator)
    goes behind an AsyncDataSetIterator that this call owns and closes,
    unless ``prefetch`` is False (sources bound to one thread)."""
    if isinstance(iterator, AsyncDataSetIterator):
        return iterator, False
    base = iterator if hasattr(iterator, "hasNext") \
        else IterableDataSetIterator(iterator)
    if not prefetch:
        return base, False
    return AsyncDataSetIterator(base), True


def predict_batches(output_fn, iterator, chunk: int = EVAL_PULL_CHUNK,
                    prefetch: bool = True):
    """Yield ``(labels, preds, labels_mask)`` per batch, preds as host
    numpy, dispatching ``output_fn`` for every batch WITHOUT pulling each
    result (ref: the JAX ``_predict_batches``): predictions stay on the
    device and come back in one copy of up to ``chunk`` batches, so the
    host waits once a chunk, not once a batch, and at most ``chunk``
    batches of predictions are held on the device. With ``prefetch`` the
    batches are pulled by a background thread
    (:func:`_eval_iterator`)."""
    it, owned = _eval_iterator(iterator, prefetch)
    pending = []

    def drain():
        flat = torch.cat([p.detach().float().reshape(-1)
                          for _, p, _ in pending]).cpu().numpy()
        out, pos = [], 0
        for labels, p, mask in pending:
            n = p.numel()
            out.append((_host(labels), flat[pos:pos + n].reshape(
                tuple(p.shape)), _host(mask)))
            pos += n
        pending.clear()
        return out

    try:
        if not owned:
            it.reset()
        while it.hasNext():
            ds = it.next()
            pending.append((ds.labels, output_fn(ds.features),
                            ds.labels_mask))
            if len(pending) >= chunk:
                yield from drain()
        if pending:
            yield from drain()
    except BaseException:
        # already unwinding: close without letting a buffered worker
        # error mask this one
        if owned:
            try:
                it.close()
            except BaseException:
                pass
        raise
    else:
        if owned:
            it.close()      # raises a worker error nobody pulled


class BaseNetwork:

    def __init__(self, conf):
        self.conf = conf
        self._opt_state: Optional[Dict] = None
        self._iteration = 0
        self._epoch = 0
        self._score = float("nan")
        self._device: Optional[torch.device] = None
        self._precision = None  # PrecisionPolicy (see setPrecisionPolicy)
        self._initialized = False
        self._compute_layout = "NCHW"
        self._fuse_epilogues = False
        self._epilogue_plan = None
        self._t_dev: Optional[torch.Tensor] = None   # the device clock
        #: (feature mask given, label mask given, steps a dispatch), or
        #: ("multi", inputs, outputs, label masks given, steps a dispatch)
        #: -> CachedDispatch
        self._step_cache: Dict[tuple, cc.CachedDispatch] = {}
        self._listeners: List = []
        self._augment = None        # DeviceAugmentation
        self._scale_state: Optional[torch.Tensor] = None  # dynamic scale
        self._resilience = None     # the fit's TrainingSession
        self._last_batch_size = 0
        #: layer keys whose params and updater state the step keeps
        #: (transfer learning, ref FrozenLayer; ``nn.transfer``)
        self._frozen_layers: set = set()

    def validate(self, batch_size: int = None, data_devices: int = None,
                 **kw):
        """Static lint of this network: the configuration analysis
        (shape/dtype propagation, structural diagnostics, Hopper
        layout lints) plus model-level findings (frozen-layer/updater
        pairing W003, accumulated recapture-churn W201s). Returns a
        ``deeplearning4j_tpu_torch.analysis.ValidationReport``; makes no
        tensor, so it runs before ``init``. Extra keywords pass through
        to ``analysis.analyze``: ``mesh=``, ``sharding=``,
        ``pipeline=``, ``hbm_gb=``, ``policy=``, ``cost=``,
        ``suppress=``, ``severity_overrides=``."""
        from deeplearning4j_tpu_torch.analysis import analyze
        return analyze(self, batch_size=batch_size,
                       data_devices=data_devices, **kw)

    def _items(self, tree) -> List[Tuple]:
        return list(tree.items() if isinstance(tree, dict)
                    else enumerate(tree))

    def _to_device(self, a) -> torch.Tensor:
        return to_device(a, self._device)

    def _adopt_jax(self, params, states) -> None:
        """Take the JAX package's params and states (a dict or a list of
        dicts of arrays, each leaf through ``np.asarray`` as fp32) on
        ``self._device``; a wrapper's nested ``{"fwd": {"W": ..}}`` becomes
        the port's flat ``{"fwd/W": ..}``. The updater state and iteration
        start afresh."""
        def conv(a):
            return torch.from_numpy(np.array(np.asarray(a), np.float32)
                                    ).to(self._device)

        def flat(d, prefix=""):
            out = {}
            for k, v in d.items():
                if isinstance(v, dict):
                    out.update(flat(v, f"{prefix}{k}/"))
                else:
                    out[prefix + k] = v
            return out

        params = {n: flat(d) for n, d in params.items()} \
            if isinstance(params, dict) else [flat(d) for d in params]
        self._params = self._map(params,
                                 lambda a: conv(a).requires_grad_(True))
        self._states = self._map(states, conv)
        self._reset_training_state()
        self._initialized = True

    def _reset_training_state(self) -> None:
        """Fresh params and states: the updater state, the iteration and
        its device clock start afresh, and no captured step (which holds
        the old tensors' addresses) survives."""
        self._opt_state = None
        self._iteration = 0
        self._t_dev = None
        self._scale_state = None
        self._step_cache = {}
        _san.invalidate(self)

    def _require_init(self):
        if not self._initialized:
            raise RuntimeError("call init() (or params_from_jax()) first")

    def _compute_dtype(self):
        """The compute dtype: the attached PrecisionPolicy's, else the
        config's dataType."""
        if self._precision is not None:
            return self._precision.compute_torch()
        return L.compute_dtype_of(self.conf.base.dtype)

    @staticmethod
    def _regularization(pairs):
        """L1/L2 over ``(layer, params)`` pairs, on the weights (``W*``,
        ``RW*``) only, as the reference regularizes them."""
        reg = 0.0
        for layer, p in pairs:
            l1 = layer.l1 or 0.0
            l2 = layer.l2 or 0.0
            if not p or (l1 == 0.0 and l2 == 0.0):
                continue
            for name, w in p.items():
                if not name.startswith(("W", "RW")):
                    continue
                if l2:
                    reg = reg + 0.5 * l2 * torch.sum(w.square())
                if l1:
                    reg = reg + l1 * torch.sum(w.abs())
        return reg

    # ------------------------------------------------------------------- fit
    def _ensure_opt_state(self):
        if self._opt_state is None:
            updater = self.conf.base.updater
            self._opt_state = {
                n: {k: updater.init_state(v.detach()) for k, v in p.items()}
                for n, p in self._items(self._params)}

    def _ensure_clock(self) -> torch.Tensor:
        """The device-resident iteration counter (0-d int32, ref
        ``_ensure_clock``): the step reads it for the updater's bias
        correction and adds one in place, so no step uploads a host
        scalar and a captured step reads the current value at replay."""
        if self._t_dev is None:
            self._t_dev = torch.tensor(self._iteration, dtype=torch.int32,
                                       device=self._device)
        return self._t_dev

    def _ensure_step_state(self) -> None:
        """Everything a step reads and writes in place exists before the
        step runs (a tensor made inside a capture would be a copy from
        the host): the updater state, the clock and, under a dynamic
        policy, the loss-scale state."""
        self._ensure_opt_state()
        self._ensure_clock()
        if self._dynamic_scaling():
            self._ensure_scale_state()

    def _dynamic_scaling(self) -> bool:
        pol = self._precision
        return pol is not None and pol.is_dynamic

    def _ensure_scale_state(self) -> torch.Tensor:
        """The device ``[scale, good_steps]`` of dynamic loss scaling (ref
        ``_ensure_scale_state``), made at the policy's initial scale."""
        if self._scale_state is None:
            s = torch.zeros(2, dtype=torch.float32, device=self._device)
            s[0] = float(self._precision.loss_scale_init)
            self._scale_state = s
        return self._scale_state

    def current_loss_scale(self):
        """The live dynamic loss scale (a host float; reads the device),
        the static scale, or None when the policy scales nothing."""
        if self._dynamic_scaling():
            if self._scale_state is None:
                return float(self._precision.loss_scale_init)
            return float(self._scale_state[0])
        pol = self._precision
        return pol.loss_scale if pol is not None else None

    def _ensure_lr_scale(self) -> torch.Tensor:
        """The updater's ``_lr_scale`` as a 0-d fp32 tensor on this
        network's device (made once, from its current value), so
        recovery writes it in place and a captured step reads it at
        replay. The step-cache key changes once, when it is made."""
        upd_ = self.conf.base.updater
        s = upd_.__dict__.get("_lr_scale", 1.0)
        dev = torch.device(self._device)
        if not isinstance(s, torch.Tensor) or s.device.type != dev.type \
                or dev.index not in (None, s.device.index):
            # never rebound once made: a captured step reads its storage,
            # and the updater's reference is what keeps that alive
            upd_._lr_scale = torch.full((), float(s), dtype=torch.float32,
                                        device=self._device)
        return upd_._lr_scale

    def lr_scale(self) -> float:
        """The updater's learning-rate scale (1.0 unless
        ``NanPolicy.BACKOFF_LR`` backed it off); a read of the device
        once it is a tensor."""
        return float(self.conf.base.updater.__dict__.get("_lr_scale", 1.0))

    def _set_lr_scale(self, value: float) -> None:
        """Write the learning-rate scale in place (no new capture)."""
        with torch.no_grad():
            self._ensure_lr_scale().fill_(float(value))

    def _step_mode(self) -> tuple:
        """The part of a step's cache key that is not its arguments: the
        frozen layers, the augmentation's signature and whether the
        learning-rate scale is a device tensor (empty for a plain step).
        A step captured before a freeze is never replayed after it (JAX
        multilayer.py's ``_compile_key_parts``)."""
        mode = ()
        if self._frozen_layers:
            mode += (("frozen", tuple(sorted(self._frozen_layers))),)
        if self._augment is not None:
            mode += (("augment", self._augment.signature()),)
        if isinstance(self.conf.base.updater.__dict__.get("_lr_scale"),
                      torch.Tensor):
            mode += ("lr_scale",)
        return mode

    def _dispatch_state(self) -> List[torch.Tensor]:
        """Every tensor a step writes: params, layer states, updater state
        and the clock, and the dynamic loss-scale state and the
        learning-rate scale where they are tensors (what warming a
        captured step must leave as it found it)."""
        lr_scale = self.conf.base.updater.__dict__.get("_lr_scale")
        return cc.state_tensors(
            self._params, self._states, self._opt_state, self._t_dev,
            self._scale_state,
            lr_scale if isinstance(lr_scale, torch.Tensor) else None)

    def _snapshot_tensors(self) -> List[torch.Tensor]:
        """What a skipped or rolled-back step restores: params, layer
        states and updater state (not the clock, as in the JAX
        package)."""
        return cc.state_tensors(self._params, self._states, self._opt_state)

    def _batches(self, data, labels, steps: int = 1, session=None):
        """One epoch's batches: a DataSet or MultiDataSet, a list of them,
        a DataSetIterator-style object (``reset``/``hasNext``/``next``,
        reset at each epoch unless a resumed session just sought it;
        whole megabatches from a staged pipeline's ``dispatch_stream``
        when its ``megabatch_steps`` is ``steps`` and no session records
        cursors), or (features, labels) arrays."""
        if isinstance(data, (DataSet, MultiDataSet)):
            return [data]
        if isinstance(data, (list, tuple)) and data \
                and isinstance(data[0], (DataSet, MultiDataSet)):
            return list(data)
        if hasattr(data, "hasNext"):
            return _epoch_of(data, steps, session)
        return [DataSet(data, labels)]

    def fit(self, data, labels=None, epochs: int = 1,
            steps_per_dispatch: int = 1, prefetch: int = 2,
            checkpoint=None, nan_policy=None, faults=None, augment=None,
            precision=None):
        """Train on a DataSet (a MultiDataSet in the graph), a list of
        them, a DataSetIterator-style object, or (features, labels)
        arrays: one update step per batch, ``epochs`` times.
        ``steps_per_dispatch=K`` groups K consecutive same-signature
        batches into one dispatch of K steps (a CUDA graph on the card);
        signature changes and epoch tails fall back to single steps, so
        the result equals K single-step fits. With K > 1 a
        ``DevicePrefetcher`` stages each megabatch ``prefetch`` ahead on
        a worker thread and a side stream (``prefetch=0``: synchronously
        on this thread); a staged pipeline iterator whose
        ``megabatch_steps`` is K gives whole megabatches, one copy to the
        card a dispatch.

        ``augment=`` attaches a device augmentation
        (:meth:`setDeviceAugmentation`), ``precision=`` a precision
        policy (:meth:`setPrecisionPolicy`), for this fit and later ones.
        ``checkpoint=CheckpointConfig(...)``, ``nan_policy=NanPolicy...``
        and ``faults=FaultPlan(...)`` run the fit under a
        ``train.resilience`` session: periodic atomic checkpoints and
        resume, recovery from a non-finite loss, preemption at dispatch
        boundaries (a ``"preempted"`` checkpoint, then a clean return),
        injected faults."""
        if not self._initialized:
            self.init()
        k = int(steps_per_dispatch)
        if k < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {k}")
        if augment is not None:
            self.setDeviceAugmentation(augment)
        if precision is not None:
            self.setPrecisionPolicy(precision)
        session = None
        if checkpoint is not None or nan_policy is not None \
                or faults is not None:
            session, data = resilience.begin_session(
                self, data, checkpoint, nan_policy, faults)
        with resilience.fit_scope(session, self, epochs) as n_epochs:
            for _ in range(n_epochs):
                self._fit_epoch(data, labels, k, prefetch, session)
                self._epoch += 1
                for lst in self._listeners:
                    if hasattr(lst, "onEpochEnd"):
                        lst.onEpochEnd(self)
                if session is not None:
                    session.on_epoch_end()
        return self

    def _fit_epoch(self, data, labels, k: int, prefetch: int,
                   session=None) -> None:
        """One epoch of ``fit``: the batches (through the session, which
        records the iterator's cursor at each pull), K steps a dispatch
        for K > 1."""
        batches = self._batches(data, labels, k, session)
        if session is not None:
            batches = session.wrap_batches(batches)
        if k > 1:
            stepping.fit_epoch_multistep(self, batches, k, prefetch)
        else:
            for ds in _prof.iter_with_data_wait(batches):
                self._fit_one(ds)

    # ------------------------------------------------------ listeners
    def setListeners(self, *listeners):
        """ref: setListeners — replaces the training listeners."""
        self._listeners = list(listeners)
        return self

    def addListeners(self, *listeners):
        self._listeners.extend(listeners)
        return self

    def getListeners(self) -> List:
        return list(self._listeners)

    def _iteration_start(self) -> None:
        for lst in self._listeners:
            if hasattr(lst, "onIterationStart"):
                lst.onIterationStart(self, self._iteration + 1)

    def _iteration_done(self) -> None:
        for lst in self._listeners:
            if hasattr(lst, "iterationDone"):
                lst.iterationDone(self, self._iteration, self._epoch)

    def _step_for(self, masked: bool, steps: int = 1,
                  fmasked: bool = False) -> cc.CachedDispatch:
        """The dispatch of ``steps`` train steps for a DataSet signature's
        masks (label mask ``masked``, feature mask ``fmasked``): one step
        runs eagerly until warmed; K steps are captured at their first
        dispatch on the card."""
        return self._dispatch_for((fmasked, masked), steps)

    def _dispatch_for(self, sig: tuple, steps: int) -> cc.CachedDispatch:
        key = sig + (steps,) + self._step_mode()
        d = self._step_cache.get(key)
        if d is None:
            name = type(self).__name__
            fn = self._multi_step(*sig[1:]) if sig[0] == "multi" \
                else self._train_step
            if steps == 1:
                d = cc.CachedDispatch(fn, f"{name}.fit",
                                      state=self._dispatch_state)
            else:
                d = cc.CachedDispatch(
                    stepping.scan_megastep(fn), f"{name}.megastep",
                    state=self._dispatch_state, always_capture=True)
            self._step_cache[key] = d
        return d

    def _multi_step(self, n_in: int, n_out: int, masked: bool):
        raise TypeError(f"{type(self).__name__} trains on DataSets, not "
                        "MultiDataSets")

    def _step_args(self, item, multi: bool):
        """``(signature, args)`` of one batch or megabatch: the dispatch's
        signature and its arguments, on the device. A DataSet's are
        ``(x, y, labels_mask, features_mask)``; a MultiDataSet's its
        features, its labels and its label masks, flat."""
        dev = self._to_device

        def opt(a):
            return None if a is None else dev(a)
        if multi:
            lm = getattr(item, "labels_masks", None) \
                if isinstance(item, MultiDataSet) else item.labels_mask
            xs = [dev(a) for a in item.features]
            ys = [dev(a) for a in item.labels]
            lms = [opt(m) for m in lm] if lm else []
            return ("multi", len(xs), len(ys), bool(lms)), \
                tuple(xs + ys + lms)
        x, y, lmask, fmask = self._batch_tensors(
            item.features, item.labels, item.labels_mask,
            item.features_mask)
        return (fmask is not None, lmask is not None), (x, y, lmask, fmask)

    @staticmethod
    def _fingerprint(sig, args):
        if sig[0] == "multi":
            return churn.array_fingerprint(*args)
        x, y, lmask, fmask = args
        return churn.array_fingerprint(x, y, fmask, lmask)

    def _batch_tensors(self, features, labels, labels_mask,
                       features_mask=None):
        """``(x, y, lmask, fmask)`` on the device (masks None if absent)."""
        def dev(a):
            return None if a is None else self._to_device(a)
        return (self._to_device(features), self._to_device(labels),
                dev(labels_mask), dev(features_mask))

    def _fit_one(self, ds):
        """One step on one DataSet (or MultiDataSet); returns its loss (a
        device scalar). The listeners' hooks and the session's run around
        it."""
        self._ensure_step_state()
        sig, args = self._step_args(ds, isinstance(ds, MultiDataSet))
        churn.get_churn_detector().record(
            f"{type(self).__name__}.fit", self._fingerprint(sig, args),
            owner=self)
        res = self._resilience
        if res is not None:
            res.before_step()
        # after the session's hook, so a planned poison is in the window;
        # one enum read unless a panic mode is on
        tok = _san.snapshot(self, "single", sig, args)
        self._iteration_start()
        with _prof.timed_region(
                "train:step", "dl4j_train_step_seconds",
                "Train-step dispatch time per iteration",
                iteration=self._iteration + 1):
            loss = self._dispatch_for(sig, 1)(*args)
        stepping.STEPS_PER_DISPATCH.set(1)
        stepping.TRAIN_ITERATIONS.inc()
        # kept on the device; score() converts lazily
        self._score = loss
        _san.check(self, tok, loss,
                   context=f"loss at iteration {self._iteration}")
        self._iteration += 1
        self._last_batch_size = int(args[0].shape[0])
        self._iteration_done()
        if res is not None:
            res.after_step()
        return loss

    def _fit_mega(self, mb: stepping.MegaBatch):
        """K stacked batches through one K-step dispatch; returns the K
        losses as one device vector (ref ``_fit_mega``)."""
        self._ensure_step_state()
        k = mb.steps
        sig, args = self._step_args(mb, mb.multi)
        churn.get_churn_detector().record(
            f"{type(self).__name__}.megastep", self._fingerprint(sig, args),
            owner=self)
        res = self._resilience
        if res is not None:
            res.before_dispatch()
        tok = _san.snapshot(self, "mega", sig, args)   # see _fit_one
        with _prof.timed_region(
                "train:megastep", "dl4j_train_step_seconds",
                "Train-step dispatch time per iteration",
                iteration=self._iteration + 1, steps=k):
            losses = self._dispatch_for(sig, k)(*args)
        stepping.record_megastep(self, losses, k, int(args[0].shape[1]),
                                 san_token=tok)
        return losses

    def _warm_dispatch(self, x, y, lmask=None, steps: int = 1, fmask=None):
        """Capture the step (K steps for ``steps`` > 1, on ``[K, B, ...]``
        arrays) for this signature without changing any state."""
        if not self._initialized:
            self.init()
        self._ensure_step_state()
        x, y, lmask, fmask = self._batch_tensors(x, y, lmask, fmask)
        self._step_for(lmask is not None, steps, fmask is not None).warm(
            x, y, lmask, fmask)
        return self

    def _train_step(self, x, y, lmask, fmask=None):
        """One update step on the batch's device tensors, every piece of
        state updated in place (nothing is read on the host, so the step
        can be captured); returns the loss, a device scalar."""
        ins, labels, masks = self._pack(x, y, lmask, True)
        return self._step_on(ins, labels, masks, fmask)

    def _augment_ins(self, ins):
        """The augmentation prelude on the packed inputs (a tensor, or the
        graph's dict of them): every 4-D input, at the device clock."""
        aug = self._augment
        if aug is None:
            return ins
        if isinstance(ins, dict):
            return {k: maybe_augment(aug, v, self._t_dev)
                    for k, v in ins.items()}
        return maybe_augment(aug, ins, self._t_dev)

    def _step_on(self, ins, labels, masks, fmask=None):
        """The step on packed inputs (``_pack``'s form): the augmentation
        prelude, the loss, the update and the layer states (kept only
        where a dynamic policy's gradients were finite), the clock."""
        key = norm_ops.StepKey(self.conf.base.seed, self._t_dev)
        ins = self._augment_ins(ins)
        loss, new_states = self._loss_and_reg(
            self._params, self._states, ins, labels, True, masks, key,
            fmask=fmask)
        ok, loss = self._apply_loss(loss)
        with torch.no_grad():
            for n, s in self._items(new_states):
                cur = self._states[n]
                for k, v in (s or {}).items():
                    if v is not cur[k]:
                        cur[k].copy_(v if ok is None
                                     else torch.where(ok, v, cur[k]))
            self._t_dev.add_(1)
        return loss.detach()

    def _apply_loss(self, loss):
        """The backward of ``loss`` under the policy's loss scale and the
        update of every param and its updater state, in place. Under a
        dynamic policy the gradients are unscaled by the live scale, the
        update is kept only if they are all finite, and the automaton
        ticks. Returns ``(ok, loss)``: that device flag (None otherwise)
        and the loss to report, which under a dynamic policy is the
        scaled loss unscaled (infinite where the scaled loss overflowed),
        as in the JAX step."""
        pol = self._precision
        dynamic = pol is not None and pol.is_dynamic
        names = [(n, k) for n, p in self._items(self._params) for k in p]
        leaves = [self._params[n][k] for n, k in names]
        if dynamic:
            scale_state = self._ensure_scale_state()
            loss_scale = scale_state[0]
        else:
            loss_scale = pol.loss_scale if pol is not None else None
        scaled = loss * loss_scale if loss_scale is not None else loss
        # a folded conv bias takes no part in the train-mode loss (it
        # cancels against the batch mean): its gradient is zero
        grads = torch.autograd.grad(scaled, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        ok = None
        if loss_scale is not None:
            inv = 1.0 / loss_scale
            grads = [g * inv for g in grads]
        if dynamic:
            ok = precision.grads_all_finite(grads)
            loss = scaled * inv
        self._process_and_apply_grads(names, leaves, grads, ok)
        if dynamic:
            with torch.no_grad():
                scale_state.copy_(precision.dynamic_scale_next(
                    pol, scale_state, ok))
        return ok, loss

    def _process_and_apply_grads(self, names, leaves, grads, ok=None):
        """Gradient normalization, then the updater per leaf, with AdamW's
        decoupled decay on the weights (leaf names ``W*``, ``RW*``; a
        wrapper's ``fwd/W`` too) as the reference gates it (JAX
        multilayer.py:139-145); the fp32 master params and the updater
        state are updated in place, or, given the device flag ``ok``,
        keep their old values where it is False (ref
        ``_select_update``). A frozen layer's params and updater state
        keep their values; its gradients still enter the normalization,
        as the JAX step normalizes the whole tree before it restores the
        frozen layers (multilayer.py:124-136, :514-518)."""
        base = self.conf.base
        updater = base.updater
        if base.grad_norm == "clip_value":
            grads = upd.clip_by_value(grads, base.grad_norm_threshold)
        elif base.grad_norm == "clip_l2":
            grads = upd.clip_by_norm(grads, base.grad_norm_threshold)
        elif base.grad_norm == "clip_global":
            grads = upd.clip_by_global_norm(grads, base.grad_norm_threshold)
        elif base.grad_norm == "renorm":
            grads = upd.renormalize_l2(grads)
        t = self._t_dev
        lr = updater.lr_at(t)
        decay = isinstance(updater, upd.AdamW) and updater.weight_decay
        frozen = self._frozen_layers
        with torch.no_grad():
            for (n, k), p, g in zip(names, leaves, grads):
                if n in frozen:
                    continue
                state = self._opt_state[n][k]
                u, s2 = updater.apply(g, state, lr, t)
                if decay and k.rsplit("/", 1)[-1].startswith(("W", "RW")):
                    u = u + updater.weight_decay_update(p, lr)
                if ok is None:
                    p.sub_(u)
                    for sk, sv in s2.items():
                        state[sk].copy_(sv)
                else:
                    p.copy_(torch.where(ok, p - u, p))
                    for sk, sv in s2.items():
                        state[sk].copy_(torch.where(ok, sv, state[sk]))

    def score(self, ds: DataSet = None) -> float:
        """The last fit step's loss, or the loss on ``ds`` (inference
        mode)."""
        if ds is None:
            if isinstance(self._score, torch.Tensor):
                self._score = float(self._score)
            return self._score
        self._require_init()
        x, y, lmask, fmask = self._batch_tensors(
            ds.features, ds.labels, ds.labels_mask, ds.features_mask)
        ins, labels, masks = self._pack(x, y, lmask, False)
        with torch.no_grad():
            loss, _ = self._loss_and_reg(self._params, self._states, ins,
                                         labels, False, masks, fmask=fmask)
        return float(loss)

    # ------------------------------------------------------------ evaluation
    def evaluate(self, iterator, evaluation=None,
                 pull_chunk: int = EVAL_PULL_CHUNK,
                 prefetch: bool = True) -> Evaluation:
        """ref: evaluate(DataSetIterator); also any iterable of DataSets.
        ``pull_chunk`` bounds how many batches of predictions stay on the
        device between pulls; ``prefetch=False`` pulls the batches on the
        calling thread (:func:`predict_batches`)."""
        ev = evaluation or Evaluation()
        for labels, preds, mask in predict_batches(self.output, iterator,
                                                   pull_chunk, prefetch):
            ev.eval(labels, preds, mask=mask)
        return ev

    def getIterationCount(self) -> int:
        return self._iteration

    def getEpochCount(self) -> int:
        return self._epoch

    def _copy_into(self, net):
        """``net`` (a fresh network on the same configuration) takes
        copies of this one's params and states on this device (ref:
        clone; the updater state and the iteration start afresh)."""
        self._require_init()
        net._device = self._device
        net._params = self._map(self._params, lambda v: v.detach().clone()
                                .requires_grad_(True))
        net._states = self._map(self._states, lambda v: v.detach().clone())
        net._reset_training_state()
        net._initialized = True
        return net

    @staticmethod
    def _map(tree, fn):
        """``fn`` over each leaf of a list or dict of dicts of arrays."""
        if isinstance(tree, dict):
            return {n: {k: fn(v) for k, v in d.items()}
                    for n, d in tree.items()}
        return [{k: fn(v) for k, v in d.items()} for d in tree]

    # --------------------------------------------------------- configuration
    def setComputeLayout(self, fmt: str):
        """NHWC compute layout for the conv stacks: channels-minor conv/
        pool/BN between layout-aware layers, the public NCHW API
        unchanged."""
        if fmt not in ("NCHW", "NHWC"):
            raise ValueError(f"compute layout must be 'NCHW' or 'NHWC', "
                             f"got {fmt!r}")
        if fmt != self._compute_layout:
            self._step_cache = {}
        self._compute_layout = fmt
        self.conf.base.compute_layout = fmt
        L.stamp_layout([layer for _, layer in self._layers()], fmt)
        return self

    def setEpilogueFusion(self, enabled: bool = True):
        """Fuse conv-bias + BN + relu/leaky blocks (and BN + act pairs)
        into one ``scale_shift_act`` dispatch each; the plan is rebuilt
        when the switch changes."""
        enabled = bool(enabled)
        if enabled != self._fuse_epilogues:
            self._epilogue_plan = None
            self._step_cache = {}
        self._fuse_epilogues = enabled
        return self

    def setPrecisionPolicy(self, policy):
        """Attach (or detach with ``None``) a ``PrecisionPolicy`` or a
        dtype string such as ``"bf16"``: fp32 master params, the compute
        dtype in conv/dense layers, an optional static or dynamic loss
        scale. A policy with another ``signature()`` drops the captured
        steps and restarts a dynamic scale at its initial value; an equal
        one keeps them."""
        policy = precision.PrecisionPolicy.coerce(policy)
        if policy is not None:
            precision.runtime_check(policy)
        cur = self._precision
        if (policy.signature() if policy is not None else None) != \
                (cur.signature() if cur is not None else None):
            self._step_cache = {}
            self._scale_state = None
        self._precision = policy
        return self

    def setDeviceAugmentation(self, augment):
        """Attach (or detach with ``None``) a
        :class:`~deeplearning4j_tpu_torch.nn.augment.DeviceAugmentation`:
        the chain runs inside the train step on the uint8 (or float)
        images, eager or captured; its ``signature()`` is part of the
        step-cache key, so an equal chain reuses the captured step."""
        self._augment = augment
        return self

    # ------------------------------------------------------------ param views
    def params(self) -> torch.Tensor:
        """Every parameter flattened and concatenated in the JAX package's
        order (:meth:`_leaf_keys`)."""
        leaves = [self._params[n][k].detach().reshape(-1)
                  for n, k in self._leaf_keys()]
        if not leaves:
            return torch.zeros((0,))
        return torch.cat(leaves)

    def setParams(self, flat) -> None:
        """Write a flat vector (in :meth:`params` order) back into the
        parameters, in place."""
        flat = self._to_device(flat).reshape(-1)
        if flat.numel() != self.numParams():
            raise ValueError(f"setParams: {flat.numel()} values for "
                             f"{self.numParams()} parameters")
        pos = 0
        with torch.no_grad():
            for n, k in self._leaf_keys():
                p = self._params[n][k]
                p.copy_(flat[pos:pos + p.numel()].view_as(p))
                pos += p.numel()

    def numParams(self) -> int:
        return sum(v.numel() for _, p in self._items(self._params)
                   for v in p.values())
