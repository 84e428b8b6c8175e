"""Data: ``DataSet``/``MultiDataSet``, the iterator contract, the
asynchronous and retrying iterators and the device prefetcher
(``data.dataset``); the MNIST, EMNIST, Iris, TinyImageNet and CIFAR-10
iterators (``data.iterators``); DataVec — the ``Writable`` types, the CSV,
line, collection and sequence readers, ``Schema``, ``TransformProcess``,
``Reducer``, ``Join`` and the reader-to-``DataSet`` iterators
(``data.records``); the image loader, transforms and record readers
(``data.image``); WAV audio and its spectrogram, mel and MFCC features
(``data.audio``); and the staged multi-process image pipeline
(``data.pipeline``, its worker in ``data.decode``)."""

# the decode worker (``data.decode``) is imported by spawn workers that
# must not load torch, and importing it runs this file: the names below
# resolve on first attribute access.
_LAZY_SYMBOLS = {
    **{n: "audio" for n in ("AudioDataSetIterator", "WavFileRecordReader",
                            "mel_spectrogram", "mfcc", "read_wav",
                            "spectrogram", "write_wav")},
    **{n: "records" for n in (
        "CollectionRecordReader", "CollectionSequenceRecordReader",
        "ColumnType", "CSVRecordReader", "CSVSequenceRecordReader", "Join",
        "LineRecordReader", "RecordReaderDataSetIterator", "Reducer",
        "Schema", "SequenceRecordReaderDataSetIterator", "TransformProcess",
        "executeJoin")},
}


def __getattr__(name):
    mod = _LAZY_SYMBOLS.get(name)
    if mod is not None:
        import importlib
        return getattr(importlib.import_module(
            f"deeplearning4j_tpu_torch.data.{mod}"), name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")


__all__ = sorted(_LAZY_SYMBOLS)
