"""Training: the updaters (``Sgd``, ``Adam``, ``AdamW``), the constant
learning-rate schedule, K steps a dispatch (``train.stepping``) and the
preemption signals (``train.resilience``)."""
