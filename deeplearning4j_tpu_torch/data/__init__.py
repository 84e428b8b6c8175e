"""Data: the ``DataSet`` batch container."""
