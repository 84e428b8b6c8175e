"""Models: the transformer (``models.transformer``) and the model zoo
(``models.zoo``: ``ResNet50``)."""
