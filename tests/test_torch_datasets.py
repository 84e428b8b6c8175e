"""The port's CIFAR-10 and TinyImageNet iterators against the JAX
package's (CPU), to the bit: CIFAR-10's python-pickle batches and
TinyImageNet's class-per-directory tree, both written by the test under a
temporary ``DL4J_TPU_DATA_DIR`` / ``DL4J_TPU_TINYIMAGENET_DIR`` (the real
sets are not in the repository and are never fetched), and the seeded
synthetic stand-ins when no files are there.
"""

import os
import pickle

import numpy as np
import pytest

from deeplearning4j_tpu.data import iterators as jit
from deeplearning4j_tpu_torch.data import iterators as tit


def _epoch(it):
    it.reset()
    out = []
    while it.hasNext():
        ds = it.next()
        out.append((np.asarray(ds.features), np.asarray(ds.labels)))
    return out


def _same(a, b):
    assert len(a) == len(b) and a
    for (fa, la), (fb, lb) in zip(a, b):
        assert fa.dtype == fb.dtype and np.array_equal(fa, fb)
        assert np.array_equal(la, lb)


def _write_cifar(base, rows=6, seed=0):
    r = np.random.default_rng(seed)
    os.makedirs(base)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        d = {b"data": r.integers(0, 256, (rows, 3 * 32 * 32),
                                 dtype=np.uint8),
             b"labels": r.integers(0, 10, rows).tolist(),
             b"batch_label": name.encode()}
        with open(os.path.join(base, name), "wb") as f:
            pickle.dump(d, f)


@pytest.mark.parametrize("sub", ["cifar10", "cifar-10-batches-py",
                                 os.path.join("cifar10",
                                              "cifar-10-batches-py")])
@pytest.mark.parametrize("train", [True, False])
def test_cifar10_pickles_equal_jax(tmp_path, monkeypatch, sub, train):
    _write_cifar(os.path.join(tmp_path, sub))
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    a = tit.Cifar10DataSetIterator(4, train=train, seed=5)
    b = jit.Cifar10DataSetIterator(4, train=train, seed=5)
    assert a.real_data and b.real_data
    assert a.data.numExamples() == (30 if train else 6)
    _same(_epoch(a), _epoch(b))
    _same(_epoch(a), _epoch(b))          # the next shuffled epoch too
    x, y = tit._find_cifar10(train)
    assert x.shape == ((30 if train else 6), 3, 32, 32) and x.dtype == np.uint8


def test_cifar10_synthetic_equals_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))    # no files
    for train in (True, False):
        a = tit.Cifar10DataSetIterator(16, train=train, num_examples=48)
        b = jit.Cifar10DataSetIterator(16, train=train, num_examples=48)
        assert not a.real_data and not b.real_data
        _same(_epoch(a), _epoch(b))
    monkeypatch.delenv("DL4J_TPU_DATA_DIR")
    assert tit._find_cifar10(True) is None


def _write_tree(root, classes=4, per=5):
    from PIL import Image
    r = np.random.RandomState(8)
    for c in range(classes):
        d = os.path.join(root, f"n0{c}")
        os.makedirs(d)
        for i in range(per):
            Image.fromarray(r.randint(0, 255, (24, 20, 3), dtype=np.uint8)
                            ).save(os.path.join(d, f"{i}.png"))
    return str(root)


@pytest.mark.parametrize("train,num", [(True, None), (False, None),
                                       (True, 7)])
def test_tiny_imagenet_files_equal_jax(tmp_path, monkeypatch, train, num):
    monkeypatch.setenv("DL4J_TPU_TINYIMAGENET_DIR", _write_tree(tmp_path))
    a = tit.TinyImageNetDataSetIterator(4, train=train, num_examples=num)
    b = jit.TinyImageNetDataSetIterator(4, train=train, num_examples=num)
    assert not a.synthetic and not b.synthetic
    assert a.data.features.shape[1:] == (3, 64, 64)
    assert a.data.labels.shape[1] == 4
    _same(_epoch(a), _epoch(b))


def test_tiny_imagenet_without_files_is_the_synthetic_set(monkeypatch):
    monkeypatch.delenv("DL4J_TPU_TINYIMAGENET_DIR", raising=False)
    a = tit.TinyImageNetDataSetIterator(8, num_examples=16)
    b = jit.TinyImageNetDataSetIterator(8, num_examples=16)
    assert a.synthetic and b.synthetic
    _same(_epoch(a), _epoch(b))
