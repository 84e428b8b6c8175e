"""Parallelism over ranks — the port of ``deeplearning4j_tpu/parallel``:
multi-process initialization (:mod:`.init`), the rank mesh and sharding
declarations (:mod:`.mesh`), the collectives (:mod:`.collectives`),
per-rank data sharding (:mod:`.data`), ``ParallelWrapper`` and
``ParallelInference`` (:mod:`.wrapper`, the latter over the
leader/follower dispatch of :mod:`.leader`), sharded checkpoints
(:mod:`.checkpoint`), elastic training with the dispatch watchdog
(:mod:`.elastic`), ring attention over a ``seq`` axis (:mod:`.sequence`)
and the GPipe schedule over a ``pipe`` axis (:mod:`.pipeline`)."""

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
from deeplearning4j_tpu_torch.parallel.sequence import ring_attention
from deeplearning4j_tpu_torch.parallel.wrapper import (InferenceFailedError,
                                                       InferenceObservable,
                                                       InferenceShutdownError,
                                                       ParallelInference,
                                                       ParallelWrapper)
