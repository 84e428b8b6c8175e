"""SameDiff: graph building, eager execution on one device, gradients,
training and serialization (ref: ``org.nd4j.autodiff.samediff``)."""

from deeplearning4j_tpu_torch.autodiff.samediff import (History, SameDiff,
                                                        SDVariable,
                                                        TrainingConfig)

__all__ = ["SameDiff", "SDVariable", "TrainingConfig", "History"]
