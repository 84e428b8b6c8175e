"""Training: the updaters (``Sgd``, ``Adam``, ``AdamW``), the constant
learning-rate schedule, and K steps a dispatch (``train.stepping``)."""
