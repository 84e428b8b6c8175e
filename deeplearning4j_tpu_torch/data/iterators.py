"""Built-in dataset iterators (the port of
``deeplearning4j_tpu/data/iterators.py``): ``MnistDataSetIterator``,
``EmnistDataSetIterator``, ``IrisDataSetIterator``,
``TinyImageNetDataSetIterator`` and ``Cifar10DataSetIterator``.

ref: ``org.deeplearning4j.datasets.iterator.impl.*``. Nothing is
downloaded. The real sets are read where they already lie on disk:
MNIST's IDX files under ``$DL4J_TPU_DATA_DIR/mnist``, CIFAR-10's python
batches under ``$DL4J_TPU_DATA_DIR/cifar10`` (or
``cifar-10-batches-py``), TinyImageNet's class-per-directory tree under
``$DL4J_TPU_TINYIMAGENET_DIR`` (decoded through the image record
reader). Otherwise (and for EMNIST always) the batches come from the JAX
package's seeded synthetic generators, copied here bit for bit (the same
seeds give the same arrays): blocky class templates with shift and
noise, or CIFAR's coloured blobs — learnable stand-ins, NOT the real
images. Unlike the JAX package the port reads no directory in the home
directory: only the variables name data. The iris data is the canonical
150-row Fisher set.
"""

from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet, ListDataSetIterator


def _read_idx(path: str) -> np.ndarray:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        magic = struct.unpack(">I", f.read(4))[0]
        ndim = magic & 0xFF
        dims = [struct.unpack(">I", f.read(4))[0] for _ in range(ndim)]
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(dims)



def _find_mnist(train: bool) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The IDX images and labels under ``$DL4J_TPU_DATA_DIR/mnist``, or
    None (no variable, or no files)."""
    root = os.environ.get("DL4J_TPU_DATA_DIR")
    if not root:
        return None
    base = os.path.join(root, "mnist")
    img_names = ["train-images-idx3-ubyte", "train-images.idx3-ubyte"] \
        if train else ["t10k-images-idx3-ubyte", "t10k-images.idx3-ubyte"]
    lab_names = ["train-labels-idx1-ubyte", "train-labels.idx1-ubyte"] \
        if train else ["t10k-labels-idx1-ubyte", "t10k-labels.idx1-ubyte"]
    for img, lab in zip(img_names, lab_names):
        for suffix in ("", ".gz"):
            ip = os.path.join(base, img + suffix)
            lp = os.path.join(base, lab + suffix)
            if os.path.exists(ip) and os.path.exists(lp):
                return _read_idx(ip), _read_idx(lp)
    return None


def _synthetic_digits(n: int, seed: int, image_hw: int = 28):
    """Deterministic learnable digit-like dataset: one blocky template per
    class, augmented with shift + noise. NOT MNIST — a stand-in where the
    real IDX files are absent; the JAX package's generator, bit for bit,
    whose bytes back the pinned LeNet >= 99% bar."""
    rng = np.random.RandomState(seed)
    tmpl_rng = np.random.RandomState(1234)  # templates fixed across splits
    templates = []
    for c in range(10):
        t = np.zeros((image_hw, image_hw), np.float32)
        cells = tmpl_rng.choice(16, size=6 + c % 4, replace=False)
        for cell in cells:
            r, cc = divmod(cell, 4)
            sz = image_hw // 4
            t[r * sz:(r + 1) * sz, cc * sz:(cc + 1) * sz] = 1.0
        templates.append(t)
    labels = rng.randint(0, 10, n)
    imgs = np.zeros((n, image_hw, image_hw), np.float32)
    for i, c in enumerate(labels):
        img = templates[c].copy()
        dx, dy = rng.randint(-2, 3, 2)
        img = np.roll(np.roll(img, dx, axis=0), dy, axis=1)
        img += 0.25 * rng.randn(image_hw, image_hw).astype(np.float32)
        imgs[i] = np.clip(img, 0, 1)
    return (imgs.reshape(n, -1) * 255).astype(np.float32), labels



class MnistDataSetIterator(ListDataSetIterator):
    """ref: MnistDataSetIterator(batch, train) — features [N, 784] fp32
    scaled to [0, 1], labels one-hot [N, 10]; shuffled each epoch when
    ``train``. ``synthetic`` says which source was read."""

    def __init__(self, batch_size: int, train: bool, seed: int = 12345,
                 num_examples: int = None):
        found = _find_mnist(train)
        if found is not None:
            imgs, labels = found
            feats = imgs.reshape(imgs.shape[0], -1).astype(np.float32)
            self.synthetic = False
        else:
            n = num_examples or (6000 if train else 1000)
            feats, labels = _synthetic_digits(n, seed + (0 if train else 777))
            self.synthetic = True
        if num_examples:
            feats, labels = feats[:num_examples], labels[:num_examples]
        feats = feats / 255.0
        onehot = np.eye(10, dtype=np.float32)[labels.astype(np.int64)]
        super().__init__(DataSet(feats, onehot), batch_size,
                         shuffle=train, seed=seed)


class EmnistDataSetIterator(ListDataSetIterator):
    """ref: EmnistDataSetIterator(dataSet, batch, train) — EMNIST splits
    (LETTERS 26 classes, BALANCED 47, DIGITS 10, ...), from the seeded
    synthetic class generator with the split's class count."""

    SPLITS = {"LETTERS": 26, "BALANCED": 47, "DIGITS": 10, "MNIST": 10,
              "COMPLETE": 62, "BYCLASS": 62, "BYMERGE": 47}

    def __init__(self, data_set: str, batch_size: int, train: bool,
                 seed: int = 12345, num_examples: int = None):
        split = str(data_set).upper()
        if split not in self.SPLITS:
            raise ValueError(f"unknown EMNIST split '{data_set}' "
                             f"(one of {sorted(self.SPLITS)})")
        self.num_classes = self.SPLITS[split]
        n = num_examples or (4096 if train else 512)
        feats, labels = _synthetic_classes(
            n, self.num_classes, seed + (0 if train else 777))
        self.synthetic = True
        feats = feats / 255.0
        onehot = np.eye(self.num_classes, dtype=np.float32)[
            labels.astype(np.int64)]
        super().__init__(DataSet(feats, onehot), batch_size,
                         shuffle=train, seed=seed)


class TinyImageNetDataSetIterator(ListDataSetIterator):
    """ref: TinyImageNetDataSetIterator — 200 classes, 64x64 RGB, NCHW
    fp32 in [0, 1]. The real images when ``$DL4J_TPU_TINYIMAGENET_DIR``
    names a class-per-directory tree (a fixed 90/10 train/test split of
    ``RandomState(20481)``'s permutation of the files, every class in the
    label map), else the seeded synthetic class generator."""

    NUM_CLASSES = 200
    HW = 64

    def __init__(self, batch_size: int, train: bool = True,
                 seed: int = 12345, num_examples: int = None):
        root = os.environ.get("DL4J_TPU_TINYIMAGENET_DIR")
        if root and os.path.isdir(root):
            feats, labels, n_cls = _tiny_imagenet_files(root, train,
                                                        num_examples, self.HW)
            self.synthetic = False
        else:
            n = num_examples or (2048 if train else 256)
            flat, labels = _synthetic_classes(
                n, self.NUM_CLASSES, seed + (0 if train else 777),
                image_hw=self.HW, channels=3)
            feats = flat.reshape(n, 3, self.HW, self.HW) / 255.0
            n_cls = self.NUM_CLASSES
            self.synthetic = True
        onehot = np.eye(n_cls, dtype=np.float32)[labels.astype(np.int64)]
        super().__init__(DataSet(feats, onehot), batch_size,
                         shuffle=train, seed=seed)


def _tiny_imagenet_files(root: str, train: bool, num_examples, hw: int):
    """``(features [n, 3, hw, hw] in [0, 1], labels, classes)`` of the
    image tree under ``root`` (the JAX package's real-data branch): a
    deterministic 90/10 split over a fixed permutation, since a sorted
    class-per-directory walk would give train == test and class-skewed
    truncation."""
    from deeplearning4j_tpu_torch.data.image import (ImageRecordReader,
                                                     _list_images)
    files = _list_images(root)
    perm = np.random.RandomState(20481).permutation(len(files))
    cut = int(len(files) * 0.9)
    chosen = perm[:cut] if train else perm[cut:]
    if num_examples is not None:
        chosen = chosen[:num_examples]
    rr = ImageRecordReader(hw, hw, 3)
    names = sorted({rr.label_generator.getLabelForPath(f) for f in files})
    feats = np.stack([rr.loader.asMatrix(files[i]) / 255.0
                      for i in chosen]).astype(np.float32)
    labels = np.asarray([names.index(rr.label_generator.getLabelForPath(
        files[i])) for i in chosen])
    return feats, labels, len(names)


def _synthetic_classes(n: int, num_classes: int, seed: int,
                       image_hw: int = 28, channels: int = 1):
    """Deterministic learnable stand-in with an arbitrary class count:
    per-class blocky template (+ per-channel tint) + shift + noise; the
    JAX package's generator, bit for bit."""
    rng = np.random.RandomState(seed)
    tmpl_rng = np.random.RandomState(4321)
    templates = []
    for c in range(num_classes):
        t = np.zeros((image_hw, image_hw), np.float32)
        cells = tmpl_rng.choice(16, size=4 + c % 8, replace=False)
        sz = image_hw // 4
        for cell in cells:
            r, cc = divmod(cell, 4)
            t[r * sz:(r + 1) * sz, cc * sz:(cc + 1) * sz] = 1.0
        templates.append(t)
    tints = tmpl_rng.rand(num_classes, channels).astype(np.float32) * 0.5 \
        + 0.5
    labels = rng.randint(0, num_classes, n)
    out = np.zeros((n, channels, image_hw, image_hw), np.float32)
    for i, c in enumerate(labels):
        img = templates[c].copy()
        dx, dy = rng.randint(-2, 3, 2)
        img = np.roll(np.roll(img, dx, axis=0), dy, axis=1)
        for ch in range(channels):
            plane = img * tints[c, ch] \
                + 0.2 * rng.randn(image_hw, image_hw).astype(np.float32)
            out[i, ch] = np.clip(plane, 0, 1)
    if channels == 1:
        return (out[:, 0].reshape(n, -1) * 255).astype(np.float32), labels
    return (out.reshape(n, -1) * 255).astype(np.float32), labels



class IrisDataSetIterator(ListDataSetIterator):
    """ref: IrisDataSetIterator — the canonical 150-row Fisher iris data."""

    def __init__(self, batch_size: int = 150, total: int = 150):
        feats, labels = _iris_data()
        onehot = np.eye(3, dtype=np.float32)[labels]
        super().__init__(DataSet(feats[:total], onehot[:total]), batch_size)


def _iris_data():
    raw = np.array([
        [5.1,3.5,1.4,0.2,0],[4.9,3.0,1.4,0.2,0],[4.7,3.2,1.3,0.2,0],[4.6,3.1,1.5,0.2,0],
        [5.0,3.6,1.4,0.2,0],[5.4,3.9,1.7,0.4,0],[4.6,3.4,1.4,0.3,0],[5.0,3.4,1.5,0.2,0],
        [4.4,2.9,1.4,0.2,0],[4.9,3.1,1.5,0.1,0],[5.4,3.7,1.5,0.2,0],[4.8,3.4,1.6,0.2,0],
        [4.8,3.0,1.4,0.1,0],[4.3,3.0,1.1,0.1,0],[5.8,4.0,1.2,0.2,0],[5.7,4.4,1.5,0.4,0],
        [5.4,3.9,1.3,0.4,0],[5.1,3.5,1.4,0.3,0],[5.7,3.8,1.7,0.3,0],[5.1,3.8,1.5,0.3,0],
        [5.4,3.4,1.7,0.2,0],[5.1,3.7,1.5,0.4,0],[4.6,3.6,1.0,0.2,0],[5.1,3.3,1.7,0.5,0],
        [4.8,3.4,1.9,0.2,0],[5.0,3.0,1.6,0.2,0],[5.0,3.4,1.6,0.4,0],[5.2,3.5,1.5,0.2,0],
        [5.2,3.4,1.4,0.2,0],[4.7,3.2,1.6,0.2,0],[4.8,3.1,1.6,0.2,0],[5.4,3.4,1.5,0.4,0],
        [5.2,4.1,1.5,0.1,0],[5.5,4.2,1.4,0.2,0],[4.9,3.1,1.5,0.2,0],[5.0,3.2,1.2,0.2,0],
        [5.5,3.5,1.3,0.2,0],[4.9,3.6,1.4,0.1,0],[4.4,3.0,1.3,0.2,0],[5.1,3.4,1.5,0.2,0],
        [5.0,3.5,1.3,0.3,0],[4.5,2.3,1.3,0.3,0],[4.4,3.2,1.3,0.2,0],[5.0,3.5,1.6,0.6,0],
        [5.1,3.8,1.9,0.4,0],[4.8,3.0,1.4,0.3,0],[5.1,3.8,1.6,0.2,0],[4.6,3.2,1.4,0.2,0],
        [5.3,3.7,1.5,0.2,0],[5.0,3.3,1.4,0.2,0],[7.0,3.2,4.7,1.4,1],[6.4,3.2,4.5,1.5,1],
        [6.9,3.1,4.9,1.5,1],[5.5,2.3,4.0,1.3,1],[6.5,2.8,4.6,1.5,1],[5.7,2.8,4.5,1.3,1],
        [6.3,3.3,4.7,1.6,1],[4.9,2.4,3.3,1.0,1],[6.6,2.9,4.6,1.3,1],[5.2,2.7,3.9,1.4,1],
        [5.0,2.0,3.5,1.0,1],[5.9,3.0,4.2,1.5,1],[6.0,2.2,4.0,1.0,1],[6.1,2.9,4.7,1.4,1],
        [5.6,2.9,3.6,1.3,1],[6.7,3.1,4.4,1.4,1],[5.6,3.0,4.5,1.5,1],[5.8,2.7,4.1,1.0,1],
        [6.2,2.2,4.5,1.5,1],[5.6,2.5,3.9,1.1,1],[5.9,3.2,4.8,1.8,1],[6.1,2.8,4.0,1.3,1],
        [6.3,2.5,4.9,1.5,1],[6.1,2.8,4.7,1.2,1],[6.4,2.9,4.3,1.3,1],[6.6,3.0,4.4,1.4,1],
        [6.8,2.8,4.8,1.4,1],[6.7,3.0,5.0,1.7,1],[6.0,2.9,4.5,1.5,1],[5.7,2.6,3.5,1.0,1],
        [5.5,2.4,3.8,1.1,1],[5.5,2.4,3.7,1.0,1],[5.8,2.7,3.9,1.2,1],[6.0,2.7,5.1,1.6,1],
        [5.4,3.0,4.5,1.5,1],[6.0,3.4,4.5,1.6,1],[6.7,3.1,4.7,1.5,1],[6.3,2.3,4.4,1.3,1],
        [5.6,3.0,4.1,1.3,1],[5.5,2.5,4.0,1.3,1],[5.5,2.6,4.4,1.2,1],[6.1,3.0,4.6,1.4,1],
        [5.8,2.6,4.0,1.2,1],[5.0,2.3,3.3,1.0,1],[5.6,2.7,4.2,1.3,1],[5.7,3.0,4.2,1.2,1],
        [5.7,2.9,4.2,1.3,1],[6.2,2.9,4.3,1.3,1],[5.1,2.5,3.0,1.1,1],[5.7,2.8,4.1,1.3,1],
        [6.3,3.3,6.0,2.5,2],[5.8,2.7,5.1,1.9,2],[7.1,3.0,5.9,2.1,2],[6.3,2.9,5.6,1.8,2],
        [6.5,3.0,5.8,2.2,2],[7.6,3.0,6.6,2.1,2],[4.9,2.5,4.5,1.7,2],[7.3,2.9,6.3,1.8,2],
        [6.7,2.5,5.8,1.8,2],[7.2,3.6,6.1,2.5,2],[6.5,3.2,5.1,2.0,2],[6.4,2.7,5.3,1.9,2],
        [6.8,3.0,5.5,2.1,2],[5.7,2.5,5.0,2.0,2],[5.8,2.8,5.1,2.4,2],[6.4,3.2,5.3,2.3,2],
        [6.5,3.0,5.5,1.8,2],[7.7,3.8,6.7,2.2,2],[7.7,2.6,6.9,2.3,2],[6.0,2.2,5.0,1.5,2],
        [6.9,3.2,5.7,2.3,2],[5.6,2.8,4.9,2.0,2],[7.7,2.8,6.7,2.0,2],[6.3,2.7,4.9,1.8,2],
        [6.7,3.3,5.7,2.1,2],[7.2,3.2,6.0,1.8,2],[6.2,2.8,4.8,1.8,2],[6.1,3.0,4.9,1.8,2],
        [6.4,2.8,5.6,2.1,2],[7.2,3.0,5.8,1.6,2],[7.4,2.8,6.1,1.9,2],[7.9,3.8,6.4,2.0,2],
        [6.4,2.8,5.6,2.2,2],[6.3,2.8,5.1,1.5,2],[6.1,2.6,5.6,1.4,2],[7.7,3.0,6.1,2.3,2],
        [6.3,3.4,5.6,2.4,2],[6.4,3.1,5.5,1.8,2],[6.0,3.0,4.8,1.8,2],[6.9,3.1,5.4,2.1,2],
        [6.7,3.1,5.6,2.4,2],[6.9,3.1,5.1,2.3,2],[5.8,2.7,5.1,1.9,2],[6.8,3.2,5.9,2.3,2],
        [6.7,3.3,5.7,2.5,2],[6.7,3.0,5.2,2.3,2],[6.3,2.5,5.0,1.9,2],[6.5,3.0,5.2,2.0,2],
        [6.2,3.4,5.4,2.3,2],[5.9,3.0,5.1,1.8,2]], dtype=np.float32)
    return raw[:, :4], raw[:, 4].astype(np.int64)


def _find_cifar10(train: bool):
    """CIFAR-10's python batches (``data_batch_1..5`` or ``test_batch``)
    under ``$DL4J_TPU_DATA_DIR/cifar10``, ``.../cifar10/cifar-10-batches-py``
    or ``.../cifar-10-batches-py``, as ``(uint8 [n, 3, 32, 32], labels)``;
    None without the variable or the files. The batches are pickles, as
    the reference's download ships them: read only files you trust."""
    import pickle
    root = os.environ.get("DL4J_TPU_DATA_DIR")
    if not root:
        return None
    names = [f"data_batch_{i}" for i in range(1, 6)] if train \
        else ["test_batch"]
    for sub in ("cifar10", os.path.join("cifar10", "cifar-10-batches-py"),
                "cifar-10-batches-py"):
        base = os.path.join(root, sub)
        if not all(os.path.exists(os.path.join(base, n)) for n in names):
            continue
        xs, ys = [], []
        for n in names:
            with open(os.path.join(base, n), "rb") as f:
                d = pickle.load(f, encoding="bytes")
            xs.append(np.asarray(d[b"data"], np.uint8))
            ys.append(np.asarray(d[b"labels"], np.int64))
        return np.concatenate(xs).reshape(-1, 3, 32, 32), np.concatenate(ys)
    return None


def _synthetic_cifar(n: int, seed: int):
    """Class-dependent coloured blobs standing in for CIFAR-10 (the JAX
    package's generator, bit for bit)."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, 10, n)
    x = rng.rand(n, 3, 32, 32).astype(np.float32) * 0.25
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32)
    for i in range(n):
        c = y[i]
        cx, cy = 8 + 2 * (c % 4), 8 + 2 * (c // 4)
        blob = np.exp(-(((xx - cx * 1.5) ** 2 + (yy - cy * 1.5) ** 2)
                        / (2.0 * (3 + c % 3) ** 2)))
        x[i, c % 3] += blob
        x[i, (c + 1) % 3] += 0.5 * blob.T
    return (np.clip(x, 0, 1) * 255).astype(np.uint8), y


class Cifar10DataSetIterator(ListDataSetIterator):
    """ref: Cifar10DataSetIterator — 10 classes, 32x32 RGB, NCHW fp32 in
    [0, 1]: the real python batches when :func:`_find_cifar10` finds them,
    else the seeded synthetic blobs (``real_data`` says which)."""

    NUM_CLASSES = 10

    def __init__(self, batch_size: int, train: bool = True,
                 num_examples: int = None, seed: int = 123,
                 shuffle: bool = True):
        found = _find_cifar10(train)
        self.real_data = found is not None
        if found is not None:
            x, y = found
        else:
            # a split-dependent seed: the synthetic test set is not the
            # training set
            x, y = _synthetic_cifar(num_examples or 2048,
                                    seed + (0 if train else 777))
        if num_examples is not None:
            x, y = x[:num_examples], y[:num_examples]
        feats = x.astype(np.float32) / 255.0
        labels = np.eye(self.NUM_CLASSES, dtype=np.float32)[y]
        super().__init__(DataSet(feats, labels), batch_size=batch_size,
                         shuffle=shuffle, seed=seed)
