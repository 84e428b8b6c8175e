"""Training: the updaters (``Sgd``, ``Adam``, ``AdamW``), the constant
learning-rate schedule, K steps a dispatch (``train.stepping``), the
model archive (``train.serializer``) and the preemption signals
(``train.resilience``)."""
