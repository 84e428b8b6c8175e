"""Parallelism over ranks — the port of ``deeplearning4j_tpu/parallel``:
multi-process initialization (:mod:`.init`), the rank mesh and sharding
declarations (:mod:`.mesh`), the collectives (:mod:`.collectives`),
per-rank data sharding (:mod:`.data`), ``ParallelWrapper``
(:mod:`.wrapper`), sharded checkpoints (:mod:`.checkpoint`) and elastic
training with the dispatch watchdog (:mod:`.elastic`).

Not ported yet (ROADMAP.md, the next slice): ``ring_attention``
(``parallel/sequence.py``), the pipeline (``parallel/pipeline.py``) and
``ParallelInference``."""

from deeplearning4j_tpu_torch.parallel.checkpoint import (load_sharded,
                                                          save_sharded)
from deeplearning4j_tpu_torch.parallel.data import (ShardedDataSetIterator,
                                                    make_global_view)
from deeplearning4j_tpu_torch.parallel.elastic import (
    CoordinationService, DeviceLossError, DeviceMonitor, DispatchFence,
    DispatchTimeoutError, DispatchWatchdog, ElasticConfig,
    ElasticShrinkError, InProcessCoordinator, RankLostError,
    StoreCoordinator)
from deeplearning4j_tpu_torch.parallel.init import (distributed_info,
                                                    initializeDistributed,
                                                    shutdownDistributed)
from deeplearning4j_tpu_torch.parallel.mesh import DeviceMesh, ShardingRule
from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper
