"""Inference serving: continuous batching with deadlines, admission
control, a dispatch watchdog, bounded retry, a circuit breaker and drain
(``serving.server``), a multi-model registry with zero-drop hot-swap
(``serving.registry``), an HTTP ingress with deadline propagation and a
documented wire error taxonomy (``serving.ingress``), and the structured
serving errors (``serving.errors``).

Quickstart (network front door)::

    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from deeplearning4j_tpu_torch.ops import cuda_kernels
    from deeplearning4j_tpu_torch.serving import HttpIngress, ModelRegistry

    cuda_kernels.install_platform_overrides()   # flash attention + LN kernels
    cfg = TransformerConfig.bert_base(use_flash_attention=True)
    lm, lm_v2 = TransformerLM(cfg, seed=0), TransformerLM(cfg, seed=1)
    reg = ModelRegistry(batch_limit=32, input_dtype=np.int32,
                        head="argmax")           # results-only D2H
    reg.load("bert", lm.logits, shapes=[(128,)])  # v1: every bucket captured
    ingress = HttpIngress(reg, port=8500).start()
    # ... POST /v1/models/bert:predict  (deadline_ms header honored)
    reg.load("bert", lm_v2.logits)      # v2 captures while v1 keeps serving
    reg.roll("bert")                    # atomic, zero requests dropped
    reg.rollback("bert")                # v1 again, nothing captured again
    ingress.stop(); reg.close()         # drain

A bare ``ModelServer(lm.logits, input_dtype=np.int32, head="argmax")``
with ``warmup([(128,), (512,)])`` serves in process; every entry point
takes ``device="cpu"`` to run on the CPU.
"""

from deeplearning4j_tpu_torch.serving.errors import (DeadlineExceededError,
                                                     ServerClosedError,
                                                     ServerDrainingError,
                                                     ServerOverloadedError,
                                                     ServerUnhealthyError,
                                                     ServingError)

# server/registry/ingress pull in torch (and numpy); the error taxonomy
# above is part of the wire contract and must stay importable from thin
# clients, so the heavy symbols resolve lazily on first attribute access.
_LAZY_SYMBOLS = {
    "ModelServer": "server", "ServingRequest": "server",
    "CircuitBreaker": "server", "InferenceFailedError": "server",
    "samediff_forward": "server", "resolve_forward": "server",
    "ModelRegistry": "registry", "ModelNotFoundError": "registry",
    "CanaryInProgressError": "registry",
    "RollbackTargetGoneError": "registry",
    "HttpIngress": "ingress", "DecodePreset": "ingress",
}


def __getattr__(name):
    mod = _LAZY_SYMBOLS.get(name)
    if mod is not None:
        import importlib
        return getattr(importlib.import_module(
            f"deeplearning4j_tpu_torch.serving.{mod}"), name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ModelServer", "ServingRequest", "CircuitBreaker",
    "InferenceFailedError", "ServingError", "ServerOverloadedError",
    "DeadlineExceededError", "ServerDrainingError", "ServerClosedError",
    "ServerUnhealthyError", "ModelRegistry", "ModelNotFoundError",
    "CanaryInProgressError", "RollbackTargetGoneError", "HttpIngress",
    "DecodePreset", "samediff_forward", "resolve_forward",
]
