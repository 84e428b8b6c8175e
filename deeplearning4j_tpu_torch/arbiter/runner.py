"""Optimization runner — the port's copy of ``deeplearning4j_tpu/arbiter/
runner.py`` (numpy only; ref: org.deeplearning4j.arbiter.optimize.runner.
LocalOptimizationRunner + OptimizationConfiguration + CandidateGenerator
{RandomSearchGenerator, GridSearchCandidateGenerator} + termination
conditions {MaxCandidatesCondition, MaxTimeCondition}).

Candidates run one after another; each is scored by whatever the caller
trains (on the card, the port's networks), so one network at a time holds
the card's memory and its captured graphs."""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.arbiter.space import ParameterSpace


class CandidateGenerator:
    def __init__(self, spaces: Dict[str, ParameterSpace]):
        self.spaces = spaces

    def __iter__(self):
        raise NotImplementedError


class RandomSearchGenerator(CandidateGenerator):
    """ref: RandomSearchGenerator — i.i.d. samples from every space."""

    def __init__(self, spaces: Dict[str, ParameterSpace], seed: int = 42):
        super().__init__(spaces)
        self.seed = seed

    def __iter__(self):
        rng = np.random.RandomState(self.seed)
        while True:
            yield {k: s.sample(rng) for k, s in self.spaces.items()}


class GridSearchCandidateGenerator(CandidateGenerator):
    """ref: GridSearchCandidateGenerator — cartesian product with
    discretization count per continuous dimension."""

    def __init__(self, spaces: Dict[str, ParameterSpace],
                 discretization_count: int = 3, shuffle: bool = False,
                 seed: int = 42):
        super().__init__(spaces)
        self.n = discretization_count
        self.shuffle = shuffle
        self.seed = seed

    def __iter__(self):
        keys = list(self.spaces)
        axes = [self.spaces[k].grid(self.n) for k in keys]
        if self.shuffle:
            combos = list(itertools.product(*axes))
            np.random.RandomState(self.seed).shuffle(combos)
        else:
            combos = itertools.product(*axes)   # lazy: runners often take
            # only max_candidates of a huge product
        for combo in combos:
            yield dict(zip(keys, combo))


@dataclass
class OptimizationResult:
    """ref: OptimizationResult — one evaluated candidate."""
    index: int
    candidate: Dict[str, Any]
    score: float
    duration_sec: float
    model: Any = None


@dataclass
class OptimizationConfiguration:
    """ref: OptimizationConfiguration.Builder — candidateGenerator +
    scoreFunction + terminationConditions."""
    candidate_generator: CandidateGenerator
    score_function: Callable[[Dict[str, Any]], Any]
    # score_function(candidate) -> float score, or (score, model)
    max_candidates: int = 10
    max_time_sec: Optional[float] = None
    minimize: bool = True
    keep_models: bool = False


class OptimizationRunner:
    """ref: LocalOptimizationRunner.execute()."""

    def __init__(self, config: OptimizationConfiguration):
        self.config = config
        self.results: List[OptimizationResult] = []

    def execute(self) -> OptimizationResult:
        cfg = self.config
        self.results = []          # re-execution starts a fresh run
        start = time.monotonic()
        for i, cand in enumerate(cfg.candidate_generator):
            if i >= cfg.max_candidates:
                break
            if cfg.max_time_sec is not None and \
                    time.monotonic() - start > cfg.max_time_sec:
                break
            t0 = time.monotonic()
            out = cfg.score_function(cand)
            model = None
            if isinstance(out, tuple):
                score, model = out
            else:
                score = out
            self.results.append(OptimizationResult(
                index=i, candidate=dict(cand), score=float(score),
                duration_sec=time.monotonic() - t0,
                model=model if cfg.keep_models else None))
        if not self.results:
            raise RuntimeError("no candidates were evaluated")
        return self.bestResult()

    def bestResult(self) -> OptimizationResult:
        finite = [r for r in self.results if np.isfinite(r.score)]
        if not finite:
            raise RuntimeError(
                "every candidate produced a non-finite score (diverged?)")
        key = (lambda r: r.score) if self.config.minimize \
            else (lambda r: -r.score)
        return min(finite, key=key)

    def numCandidatesCompleted(self) -> int:
        return len(self.results)
