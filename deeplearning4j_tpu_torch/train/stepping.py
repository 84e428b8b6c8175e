"""K training steps a dispatch (megasteps) — the port of
``deeplearning4j_tpu/train/stepping.py``.

The JAX package scans K same-signature minibatches through one compiled
``lax.scan`` program. On the card the counterpart is one captured CUDA
graph that runs K full update steps (forward, loss, backward, clip,
updater) on K slices of static ``[K, B, ...]`` buffers: one host
dispatch (a graph replay) per K steps instead of thousands of launches
per step.

- :class:`MegaBatch` — K stacked batches, ``[K, B, ...]`` per array.
- :func:`group_into_megabatches` — signature-aware grouping of a batch
  stream; signature changes and epoch tails fall back to single-step
  fits, so ``fit(steps_per_dispatch=K)`` equals K single-step fits.
- :func:`scan_megastep` — the K-step body: the single step, unchanged,
  in a loop over the K slices, its K losses stacked into one device
  vector; a network's ``_step_for`` captures it through
  :class:`~deeplearning4j_tpu_torch.nn.compilecache.CachedDispatch`.
- :func:`fit_epoch_multistep` — the epoch loop both networks' ``fit``
  delegates to for K > 1: the batch stream grouped into megabatches
  behind a :class:`~deeplearning4j_tpu_torch.data.dataset.DevicePrefetcher`
  (megabatch K+1 is staged on the card while K computes), or, with
  ``prefetch <= 0``, grouped and staged synchronously on the calling
  thread.
- :func:`use_dispatch_stream` — whether a fit pulls whole megabatches
  from a staged pipeline iterator (``dispatch_stream()``: one contiguous
  ``[K, B, ...]`` copy a dispatch instead of K batches and a stack).

- :func:`record_megastep` — the bookkeeping after a K-step dispatch:
  the iteration count, the listeners (once a step, each step's loss a
  lazy device slice) and the resilience session's ``after_dispatch``.

MultiDataSet batches group and stack as DataSets do (``MegaBatch.multi``).
Not ported: sharded staging (``stage_batch``,
``batch_placement``), the elastic fence (``dispatch_commit``) and
``apply_tuned_plan`` (``tune/``).
"""

from __future__ import annotations

from typing import Iterable, Iterator, List

import numpy as np
import torch

from deeplearning4j_tpu_torch import profiler as _prof
from deeplearning4j_tpu_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_tpu_torch.profiler import sanitizer as _sanitizer
from deeplearning4j_tpu_torch.profiler.metrics import get_registry

# How many update steps the most recent train dispatch performed.
STEPS_PER_DISPATCH = get_registry().gauge(
    "dl4j_steps_per_dispatch",
    "Update steps performed by the most recent train dispatch (1 = one "
    "step a dispatch, K = a K-step captured megastep)")
# Total update steps, advanced by K per megastep dispatch.
TRAIN_ITERATIONS = get_registry().counter(
    "dl4j_train_iterations_total",
    "Update steps performed by train dispatches (a K-step megastep "
    "advances this by K)")


class MegaBatch:
    """K same-signature training batches stacked along a leading axis:
    ``features``/``labels``/masks are ``[K, B, ...]`` arrays (lists of them
    when ``multi``, the MultiDataSet container; masks None when absent);
    ``steps`` is K."""

    __slots__ = ("features", "labels", "features_mask", "labels_mask",
                 "steps", "multi")

    def numExamples(self) -> int:
        a = self.features[0] if self.multi else self.features
        return int(a.shape[0] * a.shape[1])


def batch_signature(ds):
    """Grouping key: two batches share a megastep iff their arrays'
    shapes and dtypes and their masks' presence all match (the condition
    under which one captured step serves both)."""
    def sig(a):
        return None if a is None else (tuple(a.shape), str(a.dtype))
    if isinstance(ds, MultiDataSet):
        return ("multi",
                tuple(sig(a) for a in ds.features),
                tuple(sig(a) for a in ds.labels),
                tuple(sig(a) for a in (ds.features_masks or ())),
                tuple(sig(a) for a in (ds.labels_masks or ())))
    return ("single", sig(ds.features), sig(ds.labels),
            sig(ds.features_mask), sig(ds.labels_mask))


def _stack(arrs):
    if arrs[0] is None:
        return None
    if any(isinstance(a, torch.Tensor) for a in arrs):
        return torch.stack([torch.as_tensor(a) for a in arrs])
    return np.stack(arrs)


def stack_megabatch(group: List) -> MegaBatch:
    """Stack K same-signature DataSets or MultiDataSets into one MegaBatch
    (``np.stack`` on the host, ``torch.stack`` where a batch is already a
    tensor)."""
    first = group[0]
    mb = MegaBatch()
    mb.steps = len(group)
    mb.multi = isinstance(first, MultiDataSet)
    if mb.multi:
        def each(attr):
            lists = [getattr(d, attr) for d in group]
            if not lists[0]:
                return None
            return [_stack([xs[i] for xs in lists])
                    for i in range(len(lists[0]))]
        mb.features = each("features")
        mb.labels = each("labels")
        mb.features_mask = each("features_masks")
        mb.labels_mask = each("labels_masks")
        return mb
    mb.features = _stack([d.features for d in group])
    mb.labels = _stack([d.labels for d in group])
    mb.features_mask = _stack([d.features_mask for d in group])
    mb.labels_mask = _stack([d.labels_mask for d in group])
    return mb


def group_into_megabatches(batches: Iterable, steps: int) -> Iterator:
    """Yield MegaBatches of ``steps`` consecutive same-signature batches;
    batches stranded by a signature change or the epoch tail are yielded
    as plain DataSets (single-step fits). Items that arrive already
    stacked pass through."""
    if steps <= 1:
        yield from batches
        return
    pending, sig = [], None
    for ds in batches:
        if isinstance(ds, MegaBatch):
            yield from pending
            pending, sig = [], None
            yield ds
            continue
        s = batch_signature(ds)
        if pending and s != sig:
            yield from pending
            pending = []
        sig = s
        pending.append(ds)
        if len(pending) == steps:
            yield stack_megabatch(pending)
            pending = []
    yield from pending


def scan_megastep(body):
    """Wrap a single-step ``body(*xs) -> loss`` (state updated in place)
    into a K-step function over ``[K, ...]`` arrays (None passes through
    as None): the body runs on slice ``j`` for j in 0..K-1 and the K
    losses come back as ONE device vector. The body is the exact function
    the single step runs, so K steps here equal K single steps."""
    def megastep(*xs):
        k = next(a for a in xs if a is not None).shape[0]
        losses = [body(*(None if a is None else a[j] for a in xs))
                  for j in range(k)]
        return torch.stack(losses)
    return megastep


def use_dispatch_stream(data, steps: int, session=None) -> bool:
    """True when a fit can pull native megabatches from a staged pipeline
    iterator: K matches the iterator's declared staging
    (``megabatch_steps``), no resilience session (it records a cursor
    per pulled batch, which a K-batch pull would make dispatch-grained)
    and no per-batch preprocessor is set (those run on the per-batch
    path)."""
    return (steps > 1 and session is None
            and getattr(data, "megabatch_steps", 1) == steps
            and hasattr(data, "dispatch_stream")
            and getattr(data, "_pre", None) is None)


def record_megastep(model, losses, steps: int,
                    batch_size: int = None, san_token=None) -> None:
    """Bookkeeping after a K-step dispatch (both network classes): the
    numerics panic gate over the K losses (``profiler.sanitizer.check``,
    naming the first non-finite when ``san_token`` holds a provenance
    window; one enum read with no panic mode on), the iteration count
    and the score, which stays a lazy device slice until
    ``score()`` reads it; then each step's listener calls, after the
    dispatch, each ``losses[j]`` a lazy slice unless a listener reads
    ``score()`` (a listener that reads the model at iteration N sees the
    state at the end of the dispatch); then the session's
    ``after_dispatch`` (recovery, checkpoints and preemption act at
    dispatch boundaries)."""
    _sanitizer.check(
        model, san_token, losses,
        context=f"megastep losses at iterations "
                f"{model._iteration + 1}..{model._iteration + steps}")
    STEPS_PER_DISPATCH.set(steps)
    TRAIN_ITERATIONS.inc(steps)
    if batch_size is not None:
        model._last_batch_size = batch_size
    listeners = model._listeners
    if not listeners:
        model._iteration += steps
        model._score = losses[steps - 1]
    else:
        for j in range(steps):
            model._score = losses[j]
            model._iteration += 1
            for lst in listeners:
                if hasattr(lst, "onIterationStart"):
                    lst.onIterationStart(model, model._iteration)
                if hasattr(lst, "iterationDone"):
                    lst.iterationDone(model, model._iteration, model._epoch)
    if model._resilience is not None:
        model._resilience.after_dispatch(losses, steps)


def fit_epoch_multistep(model, batches: Iterable, steps: int,
                        prefetch: int = 2) -> None:
    """One epoch of K-step dispatch: group the batch stream into
    megabatches and run each through the model's captured megastep, the
    batches left over through its single step. With ``prefetch`` > 0 a
    :class:`~deeplearning4j_tpu_torch.data.dataset.DevicePrefetcher`
    groups and stages them on the model's device from a worker thread
    (``prefetch`` items ahead); ``prefetch <= 0`` does both synchronously
    on the calling thread (for sources bound to one thread). Each pull is
    timed as data wait (:func:`~deeplearning4j_tpu_torch.profiler.
    iter_with_data_wait`)."""
    from deeplearning4j_tpu_torch.data.dataset import (DevicePrefetcher,
                                                       stage_item)

    def drive(items):
        for item in _prof.iter_with_data_wait(items):
            if isinstance(item, MegaBatch):
                model._fit_mega(item)
            else:
                model._fit_one(item)

    if prefetch and prefetch > 0:
        with DevicePrefetcher(batches, steps_per_dispatch=steps,
                              prefetch=prefetch,
                              device=model._device) as pf:
            drive(pf)
    else:
        drive(stage_item(item, model._device)
              for item in group_into_megabatches(batches, steps))
