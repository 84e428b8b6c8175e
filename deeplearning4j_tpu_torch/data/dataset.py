"""DataSet — the features + labels (+ masks) batch container (the
slice's subset of ``deeplearning4j_tpu/data/dataset.py``)."""

from __future__ import annotations

import numpy as np
import torch


def _as_batch_array(a):
    """numpy for host data, untouched for tensors (on any device)."""
    if a is None or isinstance(a, torch.Tensor):
        return a
    return np.asarray(a)


class DataSet:
    """Features + labels (+ masks) batch container (ref: DataSet)."""

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
