"""Analysis (the slice's subset of ``deeplearning4j_tpu/analysis``): the
runtime recompile-churn detector (:mod:`.churn`), the pre-roll registry
lint (:mod:`.serving`), the TF importer's import-time lints
(:mod:`.imports`) and the ``Diagnostic``/``Severity``/``ValidationReport``
model their findings use (:mod:`.diagnostics`). The static linter is not
ported yet."""

from deeplearning4j_tpu_torch.analysis.churn import (RecompileChurnDetector,
                                                     array_fingerprint,
                                                     get_churn_detector)
from deeplearning4j_tpu_torch.analysis.diagnostics import (
    Diagnostic, ModelValidationError, Severity, ValidationReport)
from deeplearning4j_tpu_torch.analysis.serving import lint_registry_roll
