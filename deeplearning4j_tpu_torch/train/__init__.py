"""Training: the updaters (``Sgd``, ``Adam``) and the constant
learning-rate schedule."""
