"""The port's image readers (``data/image.py``, ``data/records.py``)
against the JAX package's (CPU), to the bit: ``NativeImageLoader`` (a
path, a PIL image, an HWC array; RGB and grayscale; resized or not), every
``ImageTransform`` with the same seeded ``RandomState``, the box mapping of
the geometric ones, ``ImageRecordReader`` with ``ParentPathLabelGenerator``
and a transform, ``ImageRecordReaderDataSetIterator`` (uint8 pixels in,
fp32 batches out), and ``ObjectDetectionRecordReader`` /
``ObjectDetectionDataSetIterator`` labels. The tree is class-per-directory
PNGs and a few JPEGs that the test writes with PIL.
"""

import os

import numpy as np
import pytest

from deeplearning4j_tpu.data import image as jimage
from deeplearning4j_tpu.data import records as jrecords
from deeplearning4j_tpu_torch.data import image as timage
from deeplearning4j_tpu_torch.data import records as trecords


def _tree(root, classes=3, per=5):
    from PIL import Image
    r = np.random.RandomState(3)
    for c in range(classes):
        d = os.path.join(root, f"cls{c}")
        os.makedirs(d)
        for i in range(per):
            img = Image.fromarray(r.randint(0, 255, (14, 11, 3),
                                            dtype=np.uint8))
            name = f"{i}.jpg" if i == 1 else f"{i}.png"
            img.save(os.path.join(d, name), quality=90)
    return str(root)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _tree(tmp_path_factory.mktemp("images"))


def _files(tree):
    return jimage._list_images(tree)


def test_file_listing_and_labels_equal(tree):
    assert timage._list_images(tree) == jimage._list_images(tree)
    f = _files(tree)[0]
    assert timage.ParentPathLabelGenerator().getLabelForPath(f) == \
        jimage.ParentPathLabelGenerator().getLabelForPath(f) == "cls0"


@pytest.mark.parametrize("hw,c", [((14, 11), 3), ((8, 8), 3), ((6, 9), 1)])
def test_loader_equals_jax(tree, hw, c):
    from PIL import Image
    a, b = timage.NativeImageLoader(*hw, c), jimage.NativeImageLoader(*hw, c)
    for f in _files(tree)[:4]:
        got, want = a.asMatrix(f), b.asMatrix(f)
        assert got.dtype == np.float32 and got.shape == (c,) + hw
        assert np.array_equal(got, want)
        with Image.open(f) as im:
            assert np.array_equal(a.asMatrix(im), want)
        arr = np.asarray(Image.open(f).convert("RGB"))
        assert np.array_equal(a.asMatrix(arr), b.asMatrix(arr))


def _transforms(mod):
    return [mod.ResizeImageTransform(7, 9), mod.CropImageTransform(2),
            mod.FlipImageTransform(1), mod.FlipImageTransform(0),
            mod.FlipImageTransform(-1), mod.FlipImageTransform(None),
            mod.RotateImageTransform(15.0), mod.RotateImageTransform(
                30.0, random=True), mod.ScaleImageTransform(0.5),
            mod.BrightnessTransform(20.0), mod.BrightnessTransform(
                30.0, random=True), mod.ColorConversionTransform(),
            mod.PipelineImageTransform([mod.FlipImageTransform(1),
                                        (mod.CropImageTransform(1), 0.5)],
                                       shuffle=True)]


def test_transforms_equal_jax(tree):
    img = jimage.NativeImageLoader(14, 11, 3).asMatrix(_files(tree)[0])
    for a, b in zip(_transforms(timage), _transforms(jimage)):
        ra, rb = np.random.RandomState(5), np.random.RandomState(5)
        for _ in range(3):
            got, want = a.transform(img.copy(), ra), b.transform(img.copy(),
                                                                 rb)
            assert np.array_equal(got, want), type(a).__name__


def test_box_mapping_equals_jax():
    boxes = [(1.0, 2.0, 5.0, 9.0, "a"), (0.0, 0.0, 3.0, 3.0, "b")]
    for a, b in ((timage.FlipImageTransform(-1),
                  jimage.FlipImageTransform(-1)),
                 (timage.PipelineImageTransform([timage.FlipImageTransform(
                     1), timage.ScaleImageTransform(2.0)]),
                  jimage.PipelineImageTransform([jimage.FlipImageTransform(
                      1), jimage.ScaleImageTransform(2.0)]))):
        assert a.transform_boxes(boxes, (3, 12, 10), None) == \
            b.transform_boxes(boxes, (3, 12, 10), None)
    with pytest.raises(ValueError, match="random FlipImageTransform"):
        timage.FlipImageTransform(None).transform_boxes(boxes, (3, 4, 4),
                                                        None)


def test_record_reader_equals_jax(tree):
    readers = []
    for mod in (timage, jimage):
        rr = mod.ImageRecordReader(8, 8, 3, transform=mod.FlipImageTransform(
            None), seed=4).initialize(tree)
        readers.append(rr)
    a, b = readers
    assert a.labels == b.labels and a.numLabels() == 3
    ra, rb = list(a), list(b)
    assert len(ra) == len(rb) == 15
    for (ia, la), (ib, lb) in zip(ra, rb):
        assert isinstance(la, trecords.IntWritable)
        assert la.value == lb.value and la.toInt() == lb.toInt()
        assert np.array_equal(ia.value, ib.value)
    with pytest.raises(FileNotFoundError):
        timage.ImageRecordReader(8, 8).initialize(os.path.dirname(tree)
                                                  + "/nowhere")


def test_record_reader_iterator_equals_jax(tree):
    its = [mod.ImageRecordReaderDataSetIterator(
        mod.ImageRecordReader(10, 10, 3).initialize(tree), 4)
        for mod in (timage, jimage)]
    for _ in range(2):
        got, want = [], []
        for it, out in zip(its, (got, want)):
            it.reset()
            while it.hasNext():
                out.append(it.next())
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            assert a.features.dtype == np.float32
            assert np.array_equal(a.features, np.asarray(b.features))
            assert np.array_equal(a.labels, np.asarray(b.labels))
    assert its[0].totalOutcomes() == 3 and its[0].batch() == 4


def test_writables_equal_jax():
    for name in ("Writable", "DoubleWritable", "IntWritable", "Text",
                 "FloatWritable"):
        a, b = getattr(trecords, name)("7.5"), getattr(jrecords, name)("7.5")
        assert (a.toDouble(), a.toInt(), a.toString(), repr(a)) == \
            (b.toDouble(), b.toInt(), b.toString(), repr(b))
        assert a == getattr(trecords, name)("7.5")
    assert issubclass(timage.ImageRecordReader, trecords.RecordReader)


def _boxes(path):
    """Two boxes an image, in pixels of the 14x11 original, by index."""
    i = int(os.path.basename(path).split(".")[0])
    return [(1.0 + i, 2.0, 6.0 + i, 9.0, "cat"),
            (0.0, 7.0, 4.0, 13.0, "dog" if i % 2 else "cat")]


def test_object_detection_reader_equals_jax(tree):
    made = []
    for mod in (timage, jimage):
        rr = mod.ObjectDetectionRecordReader(
            12, 12, 3, 3, 3, _boxes, ["cat", "dog"],
            transform=mod.FlipImageTransform(1)).initialize(tree)
        made.append(mod.ObjectDetectionDataSetIterator(rr, 4))
    a, b = made
    n = 0
    while b.hasNext():
        x, y = a.next(), b.next()
        assert np.array_equal(x.features, np.asarray(y.features))
        assert x.labels.shape[1:] == (6, 3, 3)
        assert np.array_equal(x.labels, np.asarray(y.labels))
        n += x.features.shape[0]
    assert n == 15 and not a.hasNext()
