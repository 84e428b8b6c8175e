"""Arbiter — hyperparameter optimization, the port of
``deeplearning4j_tpu/arbiter`` (ref: the ``arbiter`` module of the
reference monorepo: ``ParameterSpace``, ``CandidateGenerator`` {Random,
GridSearch}, ``OptimizationConfiguration``, ``IOptimizationRunner`` with
score functions)."""

from deeplearning4j_tpu_torch.arbiter.space import (CategoricalSpace,
                                                    ContinuousSpace,
                                                    DiscreteSpace,
                                                    IntegerSpace,
                                                    ParameterSpace)
from deeplearning4j_tpu_torch.arbiter.runner import (
    CandidateGenerator, GridSearchCandidateGenerator,
    OptimizationConfiguration, OptimizationResult, OptimizationRunner,
    RandomSearchGenerator)

__all__ = ["ParameterSpace", "ContinuousSpace", "IntegerSpace",
           "DiscreteSpace", "CategoricalSpace", "CandidateGenerator",
           "RandomSearchGenerator", "GridSearchCandidateGenerator",
           "OptimizationConfiguration", "OptimizationResult",
           "OptimizationRunner"]
