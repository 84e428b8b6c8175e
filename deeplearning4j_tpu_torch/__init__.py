"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of ``deeplearning4j_tpu``.

The JAX package beside it is the reference this package is held
against; this one imports ``torch``, numpy and the standard library
only. Its first slice is the serving path: a pre-LN BERT-base
(``models.transformer``) behind the continuous-batching
``serving.ModelServer``, with hand-written CUDA kernels for flash
attention and layer norm (``ops.cuda_kernels``) installed as platform
overrides over the generic ops (``ops.registry``).

Layout (module and public names follow the JAX package):

- ``ops``       — op registry, generic layer norm / attention, and the
                  CUDA kernels with their plain PyTorch twins
- ``models``    — the transformer (``TransformerConfig``, ``forward``,
                  ``encode``, ``TransformerLM``, ``params_from_jax``)
- ``serving``   — ``ModelServer``, ``ServingRequest``, ``CircuitBreaker``
                  and the structured serving errors
- ``profiler``  — the Counter/Gauge/Histogram metrics registry

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without an explicit device they raise.
"""

__version__ = "0.1.0"
