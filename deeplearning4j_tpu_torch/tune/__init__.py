"""``tune/`` — a TVM-style autotuner over the optimization seams (the
port of ``deeplearning4j_tpu/tune/``).

- :mod:`~deeplearning4j_tpu_torch.tune.space` — :class:`TuningSpace`
  enumerates candidate :class:`TuningPlan`\\ s over the seams (conv
  compute layout, fused epilogues, megastep K, precision policy,
  prefetch depth, serving bucket ladder; the sharding axis stays
  ``None`` on one card), each plan reduced to a stable signature.
- :mod:`~deeplearning4j_tpu_torch.tune.driver` — :func:`tune` searches
  the space on the card (random + successive halving + offender-seeded
  greedy refinement; min-of-reps trials of the public ``fit``; a
  loss-parity gate on the winner; with ``cost_spec=`` the
  :mod:`analysis.cost` model prunes dominated candidates before any
  measurement is spent, each prune's reason on the result).
- :mod:`~deeplearning4j_tpu_torch.tune.records` — the persistent
  :class:`TuningRecord` store, keyed like the compile cache (model
  fingerprint x mesh x backend x runtime), consulted by
  ``fit(tune="auto")``, ``warmup(tuned=True)`` and the serving registry.

CLI: ``python -m deeplearning4j_tpu_torch.tune <zoo-model> --budget N``.
"""

from deeplearning4j_tpu_torch.tune.space import (AXES, K_CHOICES,
                                                 TuningPlan, TuningSpace,
                                                 axis_priority)
from deeplearning4j_tpu_torch.tune.driver import (Trial, TuneResult,
                                                  TuningReport,
                                                  estimate_mfu,
                                                  loss_parity, tune)
from deeplearning4j_tpu_torch.tune.records import (TuningRecord,
                                                   auto_apply, best_plan,
                                                   configure, lookup,
                                                   mesh_signature, put,
                                                   record_key,
                                                   reset_configuration)

__all__ = [
    "AXES", "K_CHOICES", "TuningPlan", "TuningSpace", "axis_priority",
    "Trial", "TuneResult", "TuningReport", "estimate_mfu", "loss_parity",
    "tune",
    "TuningRecord", "auto_apply", "best_plan", "configure", "lookup",
    "mesh_signature", "put", "record_key", "reset_configuration",
]
