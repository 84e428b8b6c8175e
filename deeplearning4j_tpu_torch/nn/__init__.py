"""Networks: configuration, the input preprocessors, layers, the
ComputationGraph and the MultiLayerNetwork with their shared step
(``nn.network``), the ``PrecisionPolicy``, and captured dispatch
(``nn.compilecache``)."""
