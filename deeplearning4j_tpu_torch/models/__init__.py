"""Models: the transformer (``models.transformer``)."""
