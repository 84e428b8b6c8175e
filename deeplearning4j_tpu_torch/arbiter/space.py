"""Parameter spaces — the port's copy of ``deeplearning4j_tpu/arbiter/
space.py`` (ref: org.deeplearning4j.arbiter.optimize.parameter.*)."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


class ParameterSpace:
    """One searchable hyperparameter dimension."""

    def sample(self, rng: np.random.RandomState):
        raise NotImplementedError

    def grid(self, n: int) -> List:
        """n representative values for grid search."""
        raise NotImplementedError


class ContinuousSpace(ParameterSpace):
    """Uniform (or log-uniform) float range (ref: ContinuousParameterSpace)."""

    def __init__(self, lo: float, hi: float, log: bool = False):
        self.lo, self.hi, self.log = float(lo), float(hi), log

    def sample(self, rng):
        if self.log:
            return float(np.exp(rng.uniform(np.log(self.lo), np.log(self.hi))))
        return float(rng.uniform(self.lo, self.hi))

    def grid(self, n):
        if self.log:
            return list(np.exp(np.linspace(np.log(self.lo), np.log(self.hi), n)))
        return list(np.linspace(self.lo, self.hi, n))


class IntegerSpace(ParameterSpace):
    """Inclusive integer range (ref: IntegerParameterSpace)."""

    def __init__(self, lo: int, hi: int):
        self.lo, self.hi = int(lo), int(hi)

    def sample(self, rng):
        return int(rng.randint(self.lo, self.hi + 1))

    def grid(self, n):
        return sorted({int(v) for v in
                       np.linspace(self.lo, self.hi, min(n, self.hi - self.lo + 1))})


class DiscreteSpace(ParameterSpace):
    """Fixed value set (ref: DiscreteParameterSpace)."""

    def __init__(self, values: Sequence):
        self.values = list(values)

    def sample(self, rng):
        return self.values[rng.randint(len(self.values))]

    def grid(self, n):
        return list(self.values)


CategoricalSpace = DiscreteSpace
