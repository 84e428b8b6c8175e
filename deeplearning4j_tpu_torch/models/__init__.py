"""Models: the transformer and its training step (``models.transformer``)
and the model zoo (``models.zoo``: ``LeNet``, ``SimpleCNN``, ``VGG16``,
``VGG19``, ``Darknet19``, ``TinyYOLO``, ``ResNet50``)."""
