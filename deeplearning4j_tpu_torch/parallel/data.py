"""Per-rank data sharding — the port of
``deeplearning4j_tpu/parallel/data.py``.

Each rank keeps 1/``process_count`` of every global batch
(:class:`ShardedDataSetIterator`, ref: Spark repartition + worker-local
iterators); :func:`make_global_view` tags a rank's local slice with its
place in the global batch, so the data stays distributed and only the
view is global. :func:`pad_to_data_axis` pads a batch to a multiple of
the data-axis width with zero-weight rows, shared by ``ParallelWrapper``
and the GSPMD trainer.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch import profiler as _prof
from deeplearning4j_tpu_torch.data.dataset import (DataSet, DataSetIterator,
                                                   MultiDataSet)
from deeplearning4j_tpu_torch.parallel.mesh import Placement, set_placement

# single family shared by every host->mesh staging site (wrapper batch
# sharding, multi-rank global views) — labelled by site
SHARD_BYTES = _prof.get_registry().counter(
    "dl4j_shard_transfer_bytes_total",
    "Bytes staged host->mesh by batch sharding",
    labelnames=("site",))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _zero_weight_mask(labels, b: int, pad: int, existing=None):
    """A labels mask whose ``pad`` tail rows weigh zero — shape per the
    output layer's loss contract: per-example [b] for ff labels,
    per-timestep [b, T] for time-series labels [N, C, T]."""
    lmask = None if existing is None else _np(existing)
    if lmask is None:
        if labels is not None and np.ndim(labels) == 3:
            lmask = np.ones((b, labels.shape[2]), np.float32)
        else:
            lmask = np.ones((b,), np.float32)
    return np.concatenate([lmask, np.zeros((pad,) + lmask.shape[1:],
                                           lmask.dtype)])


def pad_to_data_axis(ds, n: int):
    """Pad a batch up to a multiple of the data-shard count ``n`` with
    ZERO-WEIGHT examples (labels mask 0, the last row repeated), so the
    padded batch's gradients match the unpadded one's. Accepts a DataSet
    or a MultiDataSet (every array pads, every output gets a zero-weight
    tail mask)."""
    multi = isinstance(ds, MultiDataSet)
    b = int((ds.features[0] if multi else ds.features).shape[0])
    if n <= 1 or b % n == 0:
        return ds
    pad = n - b % n

    def rep(a):
        if a is None:
            return None
        a = _np(a)
        return np.concatenate([a, np.repeat(a[-1:], pad, 0)])
    if multi:
        lmasks = list(ds.labels_masks) if ds.labels_masks \
            else [None] * len(ds.labels)
        lmasks = [_zero_weight_mask(lab, b, pad, existing=m)
                  for lab, m in zip(ds.labels, lmasks)]
        return MultiDataSet(
            [rep(a) for a in ds.features],
            [rep(a) for a in ds.labels],
            [rep(a) for a in ds.features_masks]
            if ds.features_masks else None,
            lmasks)
    return DataSet(rep(ds.features), rep(ds.labels),
                   rep(ds.features_mask),
                   _zero_weight_mask(ds.labels, b, pad,
                                     existing=ds.labels_mask))


def _world():
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class ShardedDataSetIterator(DataSetIterator):
    """Wrap any DataSetIterator: each rank keeps its contiguous slice of
    every global batch (ref: Spark repartition + worker-local
    iterators). The count and index default to the default group's."""

    def __init__(self, base: DataSetIterator, process_count: int = None,
                 process_index: int = None):
        world, rank = _world()
        self.base = base
        self.process_count = (process_count if process_count is not None
                              else world)
        self.process_index = (process_index if process_index is not None
                              else rank)
        self._pending: Optional[DataSet] = None

    def _slice(self, a, lo, hi):
        return None if a is None else a[lo:hi]

    def _advance(self):
        # tail batches smaller than the process count are dropped (every
        # rank drops them symmetrically) rather than crashing mid-epoch
        while self._pending is None and self.base.hasNext():
            ds = self.base.next()
            if int(ds.features.shape[0]) >= self.process_count:
                self._pending = ds

    def next(self) -> DataSet:
        self._advance()
        if self._pending is None:
            raise StopIteration
        ds, self._pending = self._pending, None
        n = int(ds.features.shape[0])
        per = n // self.process_count
        lo = self.process_index * per
        hi = lo + per   # tail remainder dropped symmetrically on every rank
        with _prof.trace_span("parallel:process_shard",
                              rank=self.process_index, rows=per):
            return self._apply_pre(DataSet(
                self._slice(ds.features, lo, hi),
                self._slice(ds.labels, lo, hi),
                self._slice(ds.features_mask, lo, hi),
                self._slice(ds.labels_mask, lo, hi)))

    def hasNext(self) -> bool:
        self._advance()
        return self._pending is not None

    def reset(self):
        self._pending = None
        self.base.reset()

    def batch(self):
        b = self.base.batch()
        return None if b is None else b // self.process_count

    # -- checkpoint/resume cursor protocol (train.resilience) --
    def cursor(self):
        """Base cursor — but None while a batch sits buffered by
        ``hasNext()``'s look-ahead (the base has advanced past a batch
        this rank hasn't served; a cursor taken then would skip it on
        resume)."""
        if self._pending is not None:
            return None
        return self.base.cursor()

    def seek(self, cursor) -> None:
        self._pending = None
        self.base.seek(cursor)


def make_global_view(local_array, mesh, spec=("data",)):
    """A rank's local slice of a global batch, on its device, tagged with
    its place in the global array (dim 0 split over the mesh's data axis
    by default): the data stays distributed, only the view is global
    (ref: the conceptual inverse of Spark collect)."""
    local = _np(local_array)
    dim = next((d for d, e in enumerate(spec or ()) if e == "data"), 0)
    n = mesh.size("data")
    r = mesh.coordinate("data")
    gshape = list(local.shape)
    gshape[dim] *= n
    if _prof.instrumentation_active():
        SHARD_BYTES.labels(site="global_view").inc(local.nbytes)
    with _prof.trace_span("parallel:make_global_view",
                          bytes=int(local.nbytes)):
        t = torch.from_numpy(np.ascontiguousarray(local)).to(mesh.device)
    return set_placement(t, Placement(gshape, dim, n, r))
