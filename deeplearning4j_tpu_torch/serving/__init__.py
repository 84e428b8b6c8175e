"""Inference serving: continuous batching with deadlines, admission
control, bounded retry, a circuit breaker and drain
(``serving.server``), and the structured serving errors
(``serving.errors``).

Quickstart::

    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from deeplearning4j_tpu_torch.ops import cuda_kernels
    from deeplearning4j_tpu_torch.serving import ModelServer

    cuda_kernels.install_platform_overrides()   # flash attention + LN kernels
    lm = TransformerLM(TransformerConfig.bert_base(use_flash_attention=True))
    server = ModelServer(lm.logits, batch_limit=32, input_dtype=np.int32,
                         head="argmax")          # results-only D2H
    server.warmup([(128,), (512,)])             # every bucket x shape once
    labels = server.output(tokens)               # or submit(x).get()
    server.close()                               # drain
"""

from deeplearning4j_tpu_torch.serving.errors import (DeadlineExceededError,
                                                     ServerClosedError,
                                                     ServerDrainingError,
                                                     ServerOverloadedError,
                                                     ServerUnhealthyError,
                                                     ServingError)
from deeplearning4j_tpu_torch.serving.server import (CircuitBreaker,
                                                     InferenceFailedError,
                                                     ModelServer,
                                                     ServingRequest,
                                                     resolve_forward,
                                                     samediff_forward)
