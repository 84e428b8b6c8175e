"""Sharded training over ranks — the port of
``deeplearning4j_tpu/distributed/``.

- :mod:`.gspmd` — :class:`ShardedTrainingPlan` and :class:`GSPMDTrainer`:
  a declared plan changes the networks' own step (the data-parallel
  reduction, sync BN, ZeRO), with explicit collectives over the mesh's
  process groups.
- :mod:`.zero` — :class:`ZeroPlan`: each data rank keeps 1/n of every
  large updater-state tensor, measured per rank by
  :func:`updater_hbm_bytes`; :func:`gather_opt_state` all-gathers.
- :mod:`.coordinator` — the socket- and file-backed
  ``CoordinationService`` for the elastic resume barrier across OS
  processes, with dead-peer detection.
"""

from deeplearning4j_tpu_torch.distributed.coordinator import (
    DeadPeerError, FileCoordinator, SocketCoordinator,
    SocketCoordinatorServer)
from deeplearning4j_tpu_torch.distributed.gspmd import (GSPMDTrainer,
                                                        ShardedTrainingPlan,
                                                        hlo_collective_bytes)
from deeplearning4j_tpu_torch.distributed.zero import (ZeroPlan,
                                                       gather_opt_state,
                                                       updater_hbm_bytes)

__all__ = [
    "ShardedTrainingPlan", "GSPMDTrainer", "hlo_collective_bytes",
    "ZeroPlan", "gather_opt_state", "updater_hbm_bytes",
    "SocketCoordinator", "SocketCoordinatorServer", "FileCoordinator",
    "DeadPeerError",
]
