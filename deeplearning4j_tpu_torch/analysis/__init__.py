"""Analysis (the slice's subset of ``deeplearning4j_tpu/analysis``): the
runtime recompile-churn detector (:mod:`.churn`) and the
``Diagnostic``/``Severity`` model its findings use
(:mod:`.diagnostics`). The static linter is not ported yet."""

from deeplearning4j_tpu_torch.analysis.churn import (RecompileChurnDetector,
                                                     array_fingerprint,
                                                     get_churn_detector)
from deeplearning4j_tpu_torch.analysis.diagnostics import (Diagnostic,
                                                           Severity)
