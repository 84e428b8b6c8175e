"""The port's DataSet, iterators and dataset iterators against the JAX
package (CPU): the synthetic MNIST, EMNIST, Iris and TinyImageNet
batches, the IDX reader, the shuffled orders of each epoch, the cursor,
and the DataSet operations give the same arrays, bit for bit."""

import gzip
import struct

import numpy as np
import pytest

from deeplearning4j_tpu.data import dataset as jds
from deeplearning4j_tpu.data import iterators as jit
from deeplearning4j_tpu_torch.data import dataset as tds
from deeplearning4j_tpu_torch.data import iterators as tit


@pytest.fixture(autouse=True)
def no_data_dir(monkeypatch, tmp_path):
    """Neither package finds real files unless a test writes them."""
    monkeypatch.delenv("DL4J_TPU_DATA_DIR", raising=False)
    monkeypatch.delenv("DL4J_TPU_TINYIMAGENET_DIR", raising=False)
    monkeypatch.setenv("HOME", str(tmp_path / "home"))


def _assert_same_batches(a, b, epochs=2):
    for _ in range(epochs):
        a.reset()
        b.reset()
        n = 0
        while b.hasNext():
            assert a.hasNext()
            da, db = a.next(), b.next()
            np.testing.assert_array_equal(da.features, db.features)
            np.testing.assert_array_equal(da.labels, db.labels)
            assert da.features.dtype == db.features.dtype
            n += 1
        assert not a.hasNext() and n > 0


@pytest.mark.parametrize("train", [True, False])
def test_synthetic_mnist_is_the_jax_packages(train):
    a = tit.MnistDataSetIterator(64, train, num_examples=300)
    b = jit.MnistDataSetIterator(64, train, num_examples=300)
    assert a.synthetic and b.synthetic
    assert a.data.features.shape == (300, 784)
    _assert_same_batches(a, b)


@pytest.mark.parametrize("split", ["LETTERS", "DIGITS", "BALANCED"])
def test_emnist_is_the_jax_packages(split):
    a = tit.EmnistDataSetIterator(split, 32, True, num_examples=100)
    b = jit.EmnistDataSetIterator(split, 32, True, num_examples=100)
    assert a.num_classes == b.num_classes
    _assert_same_batches(a, b)
    with pytest.raises(ValueError, match="unknown EMNIST split"):
        tit.EmnistDataSetIterator("NOPE", 8, True)


def test_iris_and_tiny_imagenet_are_the_jax_packages():
    _assert_same_batches(tit.IrisDataSetIterator(40, 150),
                         jit.IrisDataSetIterator(40, 150), epochs=1)
    a = tit.TinyImageNetDataSetIterator(16, False, num_examples=40)
    b = jit.TinyImageNetDataSetIterator(16, False, num_examples=40)
    assert a.data.features.shape == (40, 3, 64, 64)
    _assert_same_batches(a, b, epochs=1)


def _write_idx(path, arr):
    arr = np.asarray(arr, np.uint8)
    head = struct.pack(">I", 0x0800 | arr.ndim) + b"".join(
        struct.pack(">I", d) for d in arr.shape)
    with gzip.open(path, "wb") as f:
        f.write(head + arr.tobytes())


def test_idx_files_are_read_as_the_jax_package_reads_them(monkeypatch,
                                                          tmp_path):
    rng = np.random.default_rng(0)
    (tmp_path / "mnist").mkdir()
    _write_idx(tmp_path / "mnist" / "t10k-images-idx3-ubyte.gz",
               rng.integers(0, 256, (50, 28, 28)))
    _write_idx(tmp_path / "mnist" / "t10k-labels-idx1-ubyte.gz",
               rng.integers(0, 10, 50))
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    a = tit.MnistDataSetIterator(16, False)
    b = jit.MnistDataSetIterator(16, False)
    assert not a.synthetic and not b.synthetic
    assert a.data.features.shape == (50, 784)
    _assert_same_batches(a, b, epochs=1)


def test_list_iterator_orders_and_cursor():
    x = np.arange(60, dtype=np.float32).reshape(20, 3)
    y = np.eye(4, dtype=np.float32)[np.arange(20) % 4]
    a = tds.ListDataSetIterator(tds.DataSet(x, y), 6, shuffle=True, seed=3)
    b = jds.ListDataSetIterator(jds.DataSet(x, y), 6, shuffle=True, seed=3)
    _assert_same_batches(a, b, epochs=3)
    a.reset()
    b.reset()
    a.next()
    b.next()
    assert a.cursor() == b.cursor()
    c = tds.ListDataSetIterator(tds.DataSet(x, y), 6, shuffle=True, seed=3)
    c.seek(a.cursor())
    np.testing.assert_array_equal(c.next().features, a.next().features)
    assert a.totalOutcomes() == 4 and a.inputColumns() == 3
    assert list(iter(a))[0].features.shape == (6, 3)

    class Scale:
        def transform(self, ds):
            ds.features = ds.features * 2

    a.setPreProcessor(Scale())
    a.reset()
    np.testing.assert_array_equal(a.next().features,
                                  x[a._order[:6]] * 2)


def test_dataset_operations_are_the_jax_packages():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((11, 3)).astype(np.float32)
    y = rng.standard_normal((11, 2)).astype(np.float32)
    m = (rng.random(11) > 0.5).astype(np.float32)
    a, b = tds.DataSet(x, y, labels_mask=m), jds.DataSet(x, y, labels_mask=m)
    for frac in (0.6, 4):
        sa, sb = a.splitTestAndTrain(frac), b.splitTestAndTrain(frac)
        for u, v in ((sa.getTrain(), sb.getTrain()),
                     (sa.getTest(), sb.getTest())):
            np.testing.assert_array_equal(u.features, v.features)
            np.testing.assert_array_equal(u.labels_mask, v.labels_mask)
    a.shuffle(5)
    b.shuffle(5)
    np.testing.assert_array_equal(a.features, b.features)
    np.testing.assert_array_equal(a.labels_mask, b.labels_mask)
    ba, bb = a.batchBy(4), b.batchBy(4)
    assert [d.numExamples() for d in ba] == [d.numExamples() for d in bb] \
        == [4, 4, 3]
    ma, mb = tds.DataSet.merge(ba), jds.DataSet.merge(bb)
    np.testing.assert_array_equal(ma.features, mb.features)
    np.testing.assert_array_equal(ma.labels, mb.labels)
    assert ma.features_mask is None
