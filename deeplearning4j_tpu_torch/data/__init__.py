"""Data: ``DataSet``/``MultiDataSet``, the iterator contract, the
asynchronous and retrying iterators and the device prefetcher
(``data.dataset``); the MNIST, EMNIST, Iris, TinyImageNet and CIFAR-10
iterators (``data.iterators``); DataVec's ``Writable``/``RecordReader``
base (``data.records``); the image loader, transforms and record readers
(``data.image``); and the staged multi-process image pipeline
(``data.pipeline``, its worker in ``data.decode``)."""
