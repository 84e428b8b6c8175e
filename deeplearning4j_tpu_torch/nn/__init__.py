"""Networks: configuration, layers, the ComputationGraph and the
``PrecisionPolicy``."""
