"""Training UI / stats dashboard (ref: deeplearning4j-ui-parent):
StatsListener (train.listeners) -> StatsStorage (ui.stats) -> UIServer
(ui.server)."""

from deeplearning4j_tpu_torch.ui.server import UIServer
from deeplearning4j_tpu_torch.ui.stats import (FileStatsStorage,
                                               InMemoryStatsStorage,
                                               StatsStorage,
                                               StatsStorageRouter)

__all__ = ["StatsStorage", "InMemoryStatsStorage", "FileStatsStorage",
           "StatsStorageRouter", "UIServer"]
