"""Data: ``DataSet`` and the iterator contract (``data.dataset``), and
the MNIST, EMNIST, Iris and TinyImageNet iterators (``data.iterators``)."""
