"""DataSet containers and the iterator contract (the slice's subset of
``deeplearning4j_tpu/data/dataset.py``): ``DataSet`` with
``splitTestAndTrain``, ``shuffle``, ``batchBy`` and ``merge``,
``SplitTestAndTrain``, ``DataSetIterator`` (reset/hasNext/next, the
cursor/seek protocol, ``setPreProcessor``), ``ListDataSetIterator``, and
the normalizers ``NormalizerStandardize``, ``NormalizerMinMaxScaler``
and ``ImagePreProcessingScaler`` (``ModelSerializer.writeNormalizer`` /
``restoreNormalizer`` store them in the JAX package's file).

Host arrays stay numpy until a step moves a batch to the device; tensors
(on any device) are kept as they are. Not ported yet (ROADMAP.md):
``MultiDataSet``, the asynchronous and retrying iterators.
"""

from __future__ import annotations

from typing import Iterator, List, Sequence

import numpy as np
import torch


def _as_batch_array(a):
    """numpy for host data, untouched for tensors (on any device)."""
    if a is None or isinstance(a, torch.Tensor):
        return a
    return np.asarray(a)


class DataSet:
    """Features + labels (+ masks) batch container (ref: DataSet)."""

    _FIELDS = ("features", "labels", "features_mask", "labels_mask")

    def __init__(self, features=None, labels=None,
                 features_mask=None, labels_mask=None):
        self.features = _as_batch_array(features)
        self.labels = _as_batch_array(labels)
        self.features_mask = _as_batch_array(features_mask)
        self.labels_mask = _as_batch_array(labels_mask)

    def getFeatures(self):
        return self.features

    def getLabels(self):
        return self.labels

    def numExamples(self) -> int:
        return 0 if self.features is None else self.features.shape[0]

    def _rows(self, idx) -> "DataSet":
        return DataSet(*(None if a is None else a[idx]
                         for a in (getattr(self, f) for f in self._FIELDS)))

    def splitTestAndTrain(self, fraction_or_n) -> "SplitTestAndTrain":
        """The first ``n`` examples (a fraction of them for a float) to
        train, the rest to test."""
        n = self.numExamples()
        n_train = int(fraction_or_n * n) if isinstance(fraction_or_n, float) \
            else int(fraction_or_n)
        return SplitTestAndTrain(self._rows(slice(0, n_train)),
                                 self._rows(slice(n_train, n)))

    def shuffle(self, seed: int = None):
        """Permute the examples in place, ``np.random.RandomState(seed)``'s
        permutation."""
        perm = np.random.RandomState(seed).permutation(self.numExamples())
        for attr in self._FIELDS:
            a = getattr(self, attr)
            if a is not None:
                setattr(self, attr, a[perm])

    def batchBy(self, batch_size: int) -> List["DataSet"]:
        return [self._rows(slice(i, i + batch_size))
                for i in range(0, self.numExamples(), batch_size)]

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        def cat(attr):
            arrs = [getattr(d, attr) for d in datasets]
            if any(a is None for a in arrs):
                return None
            if any(isinstance(a, torch.Tensor) for a in arrs):
                return torch.cat([torch.as_tensor(a) for a in arrs])
            return np.concatenate(arrs, axis=0)
        return DataSet(*(cat(f) for f in DataSet._FIELDS))


class SplitTestAndTrain:
    def __init__(self, train: DataSet, test: DataSet):
        self.train = train
        self.test = test

    def getTrain(self):
        return self.train

    def getTest(self):
        return self.test


class DataSetIterator:
    """Iterator contract (ref: DataSetIterator): python-iterable over
    DataSet minibatches, restartable via reset()."""

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        return self

    def __next__(self) -> DataSet:
        if not self.hasNext():
            raise StopIteration
        return self.next()

    def hasNext(self) -> bool:
        raise NotImplementedError

    def next(self) -> DataSet:
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError

    def batch(self) -> int:
        raise NotImplementedError

    def cursor(self):
        """A JSON-able position token for checkpoint/resume, or None when
        the source cannot seek."""
        return None

    def seek(self, cursor) -> None:
        """Restore a position :meth:`cursor` returned."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support seek()")

    def setPreProcessor(self, pre):
        """``pre.transform(ds)`` runs on every batch :meth:`next`
        returns."""
        self._pre = pre

    def _apply_pre(self, ds: DataSet) -> DataSet:
        pre = getattr(self, "_pre", None)
        if pre is not None:
            pre.transform(ds)
        return ds


class ListDataSetIterator(DataSetIterator):
    """Iterate an in-memory DataSet in minibatches (ref:
    ListDataSetIterator); with ``shuffle`` each ``reset`` draws the order
    from ``np.random.RandomState(seed + epoch)``, as the JAX package
    does."""

    def __init__(self, data: DataSet, batch_size: int = 32,
                 shuffle: bool = False, seed: int = 12345):
        self.data = data
        self.batch_size = batch_size
        self._shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self.reset()

    def _order_for(self, epoch: int):
        if self._shuffle:
            return np.random.RandomState(self._seed + epoch).permutation(
                self.data.numExamples())
        return np.arange(self.data.numExamples())

    def reset(self):
        self._order = self._order_for(self._epoch)
        if self._shuffle:
            self._epoch += 1
        self._pos = 0

    def hasNext(self):
        return self._pos < self.data.numExamples()

    def next(self):
        idx = self._order[self._pos:self._pos + self.batch_size]
        self._pos += self.batch_size
        return self._apply_pre(self.data._rows(idx))

    def batch(self):
        return self.batch_size

    def cursor(self):
        """Position and epoch: enough to rebuild the seeded order."""
        return {"pos": int(self._pos), "epoch": int(self._epoch)}

    def seek(self, cursor) -> None:
        epoch = int(cursor["epoch"])
        # reset() drew the order for stored epoch e from seed + e - 1
        self._order = self._order_for(max(epoch - 1, 0))
        self._epoch = epoch
        self._pos = int(cursor["pos"])

    def totalOutcomes(self):
        return self.data.labels.shape[1] if self.data.labels is not None \
            else 0

    def inputColumns(self):
        return int(np.prod(self.data.features.shape[1:]))


# ------------------------------------------------------------------ normalizers
def _channel_shape(stat, feats):
    """A per-channel statistic broadcast over axis 1 of 3-D and 4-D
    features."""
    if feats.ndim > 2:
        shape = [1] * feats.ndim
        shape[1] = -1
        return stat.reshape(shape)
    return stat


def _features(data):
    return data.features if isinstance(data, DataSet) else data


def _set_features(data, out):
    if isinstance(data, DataSet):
        data.features = out
        return data
    return out


class NormalizerStandardize:
    """Zero mean, unit variance (ref: NormalizerStandardize): ``fit`` takes
    the mean and standard deviation of every feature column (of every
    channel, axis 1, of 3-D and 4-D features), a deviation below 1e-8
    counting as 1; ``transform`` and ``revert`` work on a DataSet (in
    place) or a numpy array."""

    def __init__(self):
        self.mean = None
        self.std = None

    def fit(self, data):
        feats = np.asarray(_features(data))
        axes = tuple(i for i in range(feats.ndim) if i != 1) \
            if feats.ndim > 2 else (0,)
        self.mean = feats.mean(axis=axes)
        std = feats.std(axis=axes)
        self.std = np.where(std < 1e-8, 1.0, std)

    def transform(self, data):
        feats = _features(data)
        return _set_features(data, (feats - _channel_shape(self.mean, feats))
                             / _channel_shape(self.std, feats))

    def revert(self, data):
        """The inverse of :meth:`transform`, per channel of 3-D and 4-D
        features too."""
        feats = _features(data)
        return _set_features(data, feats * _channel_shape(self.std, feats)
                             + _channel_shape(self.mean, feats))

    def state(self):
        return {"mean": self.mean, "std": self.std}

    def load_state(self, d):
        self.mean, self.std = d["mean"], d["std"]


class NormalizerMinMaxScaler:
    """Scale into ``[min_range, max_range]`` (ref: NormalizerMinMaxScaler)
    by the minimum and maximum over all of the fitted features, as the
    JAX package does."""

    def __init__(self, min_range: float = 0.0, max_range: float = 1.0):
        self.min_range, self.max_range = min_range, max_range
        self.data_min = None
        self.data_max = None

    def fit(self, data):
        feats = np.asarray(_features(data))
        self.data_min = feats.min()
        self.data_max = feats.max()

    def transform(self, data):
        feats = _features(data)
        denom = max(self.data_max - self.data_min, 1e-8)
        out = (feats - self.data_min) / denom \
            * (self.max_range - self.min_range) + self.min_range
        return _set_features(data, out)


class ImagePreProcessingScaler:
    """Pixels in [0, 255] to [a, b] (ref: ImagePreProcessingScaler)."""

    def __init__(self, a: float = 0.0, b: float = 1.0):
        self.a, self.b = a, b

    def fit(self, data):
        pass

    def transform(self, data):
        feats = _features(data)
        return _set_features(data, feats / 255.0 * (self.b - self.a)
                             + self.a)
