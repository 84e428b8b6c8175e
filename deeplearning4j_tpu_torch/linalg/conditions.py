"""Conditions + BooleanIndexing (the port of
``deeplearning4j_tpu/linalg/conditions.py``; ref: ``org.nd4j.linalg.
indexing.conditions.Conditions`` and ``BooleanIndexing``).

A Condition is a predicate producing a boolean mask over a tensor;
BooleanIndexing applies them (replaceWhere / countOccurrences / and/or).
The masks are computed on the array's device; ``firstIndex`` and
``lastIndex`` read one index back."""

from __future__ import annotations

import torch


class Condition:
    def __init__(self, fn):
        self._fn = fn

    def mask(self, value) -> torch.Tensor:
        return self._fn(value)

    def __and__(self, other: "Condition") -> "Condition":
        return Condition(lambda v: torch.logical_and(self.mask(v),
                                                     other.mask(v)))

    def __or__(self, other: "Condition") -> "Condition":
        return Condition(lambda v: torch.logical_or(self.mask(v),
                                                    other.mask(v)))

    def __invert__(self) -> "Condition":
        return Condition(lambda v: torch.logical_not(self.mask(v)))


class Conditions:
    """ref: Conditions.{greaterThan, lessThan, ...} static factories."""

    @staticmethod
    def greaterThan(x): return Condition(lambda v: v > x)

    @staticmethod
    def greaterThanOrEqual(x): return Condition(lambda v: v >= x)

    @staticmethod
    def lessThan(x): return Condition(lambda v: v < x)

    @staticmethod
    def lessThanOrEqual(x): return Condition(lambda v: v <= x)

    @staticmethod
    def equals(x): return Condition(lambda v: v == x)

    @staticmethod
    def notEquals(x): return Condition(lambda v: v != x)

    @staticmethod
    def epsEquals(x, eps: float = 1e-5):
        return Condition(lambda v: torch.abs(v - x) <= eps)

    @staticmethod
    def epsNotEquals(x, eps: float = 1e-5):
        return Condition(lambda v: torch.abs(v - x) > eps)

    @staticmethod
    def isNan(): return Condition(torch.isnan)

    @staticmethod
    def isInfinite(): return Condition(torch.isinf)

    @staticmethod
    def isFinite(): return Condition(torch.isfinite)

    @staticmethod
    def notFinite(): return Condition(lambda v: ~torch.isfinite(v))

    @staticmethod
    def absGreaterThan(x): return Condition(lambda v: torch.abs(v) > x)

    @staticmethod
    def absLessThan(x): return Condition(lambda v: torch.abs(v) < x)


def _flat_hits(arr, condition: Condition) -> torch.Tensor:
    return torch.nonzero(condition.mask(arr.tensor()).reshape(-1)).reshape(-1)


class BooleanIndexing:
    """ref: org.nd4j.linalg.indexing.BooleanIndexing statics."""

    @staticmethod
    def replaceWhere(arr, replacement, condition: Condition):
        return arr.replaceWhere(replacement, condition)

    @staticmethod
    def countOccurrences(arr, condition: Condition) -> int:
        return int(torch.sum(condition.mask(arr.tensor())))

    @staticmethod
    def and_(arr, condition: Condition) -> bool:
        return bool(torch.all(condition.mask(arr.tensor())))

    @staticmethod
    def or_(arr, condition: Condition) -> bool:
        return bool(torch.any(condition.mask(arr.tensor())))

    @staticmethod
    def firstIndex(arr, condition: Condition) -> int:
        idx = _flat_hits(arr, condition)
        return int(idx[0]) if idx.numel() else -1

    @staticmethod
    def lastIndex(arr, condition: Condition) -> int:
        idx = _flat_hits(arr, condition)
        return int(idx[-1]) if idx.numel() else -1
