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
  delegates to, staging synchronously (the reference's ``prefetch <= 0``
  branch; ``DevicePrefetcher`` is not ported yet).

Not ported: MultiDataSet batches, listeners, the sanitizer and
resilience hooks, sharded staging.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet
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
    ``features``/``labels``/masks are ``[K, B, ...]`` arrays (masks None
    when absent); ``steps`` is K."""

    __slots__ = ("features", "labels", "features_mask", "labels_mask",
                 "steps")

    def numExamples(self) -> int:
        return int(self.features.shape[0] * self.features.shape[1])


def batch_signature(ds: DataSet):
    """Grouping key: two batches share a megastep iff their arrays'
    shapes and dtypes and their masks' presence all match (the condition
    under which one captured step serves both)."""
    def sig(a):
        return None if a is None else (tuple(a.shape), str(a.dtype))
    return ("single", sig(ds.features), sig(ds.labels),
            sig(ds.features_mask), sig(ds.labels_mask))


def _stack(arrs):
    if arrs[0] is None:
        return None
    if any(isinstance(a, torch.Tensor) for a in arrs):
        return torch.stack([torch.as_tensor(a) for a in arrs])
    return np.stack(arrs)


def stack_megabatch(group: List[DataSet]) -> MegaBatch:
    """Stack K same-signature batches into one MegaBatch (``np.stack`` on
    the host, ``torch.stack`` where a batch is already a tensor)."""
    mb = MegaBatch()
    mb.steps = len(group)
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


def record_megastep(model, losses, steps: int) -> None:
    """Bookkeeping after a K-step dispatch (both network classes): the
    iteration count and the score, which stays a lazy device slice until
    ``score()`` reads it."""
    STEPS_PER_DISPATCH.set(steps)
    TRAIN_ITERATIONS.inc(steps)
    model._iteration += steps
    model._score = losses[steps - 1]


def fit_epoch_multistep(model, batches: Iterable, steps: int) -> None:
    """One epoch of K-step dispatch: group the batch stream into
    megabatches and run each through the model's captured megastep, the
    batches left over (every batch when K is 1) through its single step.
    Staging is synchronous, on the calling thread."""
    for item in group_into_megabatches(batches, steps):
        if isinstance(item, MegaBatch):
            model._fit_mega(item)
        else:
            model._fit_one(item)
