"""Parallel (the port's subset of ``deeplearning4j_tpu/parallel``): the
dispatch watchdog and its errors (:mod:`.elastic`). Meshes, sharding and
mesh shrink are not ported yet."""

from deeplearning4j_tpu_torch.parallel.elastic import (DeviceLossError,
                                                       DispatchFence,
                                                       DispatchTimeoutError,
                                                       DispatchWatchdog)
