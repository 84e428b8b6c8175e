"""Metrics (ref: org.nd4j.evaluation)."""

from deeplearning4j_tpu_torch.evaluation.evaluation import (  # noqa: F401
    ConfusionMatrix,
    Evaluation,
    EvaluationBinary,
    EvaluationCalibration,
    RegressionEvaluation,
    ROC,
    ROCBinary,
    ROCMultiClass,
)
