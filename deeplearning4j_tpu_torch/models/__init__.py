"""Models: the transformer and its training step (``models.transformer``)
and the model zoo (``models.zoo``: ``ResNet50``, ``TinyYOLO``)."""
