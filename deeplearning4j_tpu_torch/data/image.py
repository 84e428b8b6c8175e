"""DataVec's image readers (the port of ``deeplearning4j_tpu/data/
image.py``): ``NativeImageLoader``, the ``ImageTransform`` family (crop,
flip, rotate, scale, brightness, grayscale, pipeline), ``ImageRecordReader``
with ``ParentPathLabelGenerator``, ``ImageRecordReaderDataSetIterator``,
and ``ObjectDetectionRecordReader`` / ``ObjectDetectionDataSetIterator``
emitting the YOLO2 label layout.

ref: ``datavec-data-image``. Decoding and augmentation are host work,
through PIL (imported inside the functions that decode) and numpy, as in
the JAX package; the batches are NCHW float32 host arrays that a fit
stages on the device. The staged, multi-process path for training from
files is :mod:`.pipeline`.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet, DataSetIterator
from deeplearning4j_tpu_torch.data.records import (IntWritable,
                                                   RecordReader, Writable)

_IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".gif", ".ppm")


class NDArrayWritable(Writable):
    """ref: org.datavec.api.writable.NDArrayWritable."""

    def __init__(self, value: np.ndarray):
        self.value = np.asarray(value)


# ------------------------------------------------------------------ loaders

class NativeImageLoader:
    """Decode + resize an image file/array to CHW float32
    (ref: org.datavec.image.loader.NativeImageLoader)."""

    def __init__(self, height: int, width: int, channels: int = 3):
        self.height = int(height)
        self.width = int(width)
        self.channels = int(channels)

    def asMatrix(self, src) -> np.ndarray:
        """Image path / PIL image / HWC array -> [C, H, W] float32."""
        from PIL import Image
        if isinstance(src, (str, os.PathLike)):
            img = Image.open(src)
        elif isinstance(src, np.ndarray):
            arr = src
            if arr.ndim == 2:
                arr = arr[:, :, None]
            img = Image.fromarray(
                arr.astype(np.uint8).squeeze() if arr.shape[2] == 1
                else arr.astype(np.uint8))
        else:
            img = src
        img = img.convert("L" if self.channels == 1 else "RGB")
        if img.size != (self.width, self.height):
            img = img.resize((self.width, self.height), Image.BILINEAR)
        arr = np.asarray(img, np.float32)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return np.transpose(arr, (2, 0, 1))   # HWC -> CHW


# --------------------------------------------------------------- transforms

class ImageTransform:
    """Host-side augmentation op on a CHW float array (ref:
    org.datavec.image.transform.ImageTransform). Chainable; each transform
    also maps box coordinates so object-detection labels stay aligned."""

    def transform(self, img: np.ndarray, rng: np.random.RandomState
                  ) -> np.ndarray:
        raise NotImplementedError

    def transform_boxes(self, boxes, img_shape, rng):
        """Default: geometry-preserving transform — boxes unchanged."""
        return boxes

    def __call__(self, img, rng=None):
        return self.transform(img, rng or np.random.RandomState())


class ResizeImageTransform(ImageTransform):
    def __init__(self, height: int, width: int):
        self.height, self.width = height, width

    def transform(self, img, rng):
        from PIL import Image
        c = img.shape[0]
        out = np.empty((c, self.height, self.width), np.float32)
        for i in range(c):
            out[i] = np.asarray(Image.fromarray(img[i]).resize(
                (self.width, self.height), Image.BILINEAR), np.float32)
        return out


class CropImageTransform(ImageTransform):
    """Random crop by up to crop pixels from each border (ref:
    CropImageTransform)."""

    def __init__(self, crop: int):
        self.crop = int(crop)

    def transform(self, img, rng):
        c, h, w = img.shape
        t = rng.randint(0, self.crop + 1)
        l = rng.randint(0, self.crop + 1)
        b = rng.randint(0, self.crop + 1)
        r = rng.randint(0, self.crop + 1)
        return img[:, t:h - b, l:w - r]


class FlipImageTransform(ImageTransform):
    """mode: 0 = vertical, 1 = horizontal, -1 = both, None = random
    (ref: FlipImageTransform's OpenCV flip codes)."""

    def __init__(self, mode: Optional[int] = 1):
        self.mode = mode

    def transform(self, img, rng):
        mode = rng.choice([0, 1, -1]) if self.mode is None else self.mode
        if mode in (1, -1):
            img = img[:, :, ::-1]
        if mode in (0, -1):
            img = img[:, ::-1, :]
        return np.ascontiguousarray(img)

    def transform_boxes(self, boxes, img_shape, rng):
        if self.mode is None:
            raise ValueError(
                "random FlipImageTransform cannot be used with object-"
                "detection labels (the image flip and the box flip would "
                "draw different random modes); use a fixed mode")
        _, h, w = img_shape
        out = []
        for (x1, y1, x2, y2, cls) in boxes:
            if self.mode in (1, -1):
                x1, x2 = w - x2, w - x1
            if self.mode in (0, -1):
                y1, y2 = h - y2, h - y1
            out.append((x1, y1, x2, y2, cls))
        return out


class RotateImageTransform(ImageTransform):
    """Rotate by a fixed or random angle in degrees (ref:
    RotateImageTransform)."""

    def __init__(self, angle: float, random: bool = False):
        self.angle = float(angle)
        self.random = random

    def transform(self, img, rng):
        from PIL import Image
        a = rng.uniform(-self.angle, self.angle) if self.random else self.angle
        c = img.shape[0]
        out = np.empty_like(img)
        for i in range(c):
            out[i] = np.asarray(Image.fromarray(img[i]).rotate(
                a, Image.BILINEAR), np.float32)
        return out


class ScaleImageTransform(ImageTransform):
    """Multiply pixel values (ref: ScaleImageTransform)."""

    def __init__(self, scale: float):
        self.scale = float(scale)

    def transform(self, img, rng):
        return img * self.scale


class BrightnessTransform(ImageTransform):
    def __init__(self, delta: float, random: bool = False):
        self.delta = float(delta)
        self.random = random

    def transform(self, img, rng):
        d = rng.uniform(-self.delta, self.delta) if self.random else self.delta
        return np.clip(img + d, 0.0, 255.0)


class ColorConversionTransform(ImageTransform):
    """RGB -> grayscale, kept 3-channel (ref: ColorConversionTransform)."""

    def transform(self, img, rng):
        if img.shape[0] != 3:
            return img
        g = 0.299 * img[0] + 0.587 * img[1] + 0.114 * img[2]
        return np.stack([g, g, g])


class PipelineImageTransform(ImageTransform):
    """Chain transforms, each applied with a probability
    (ref: PipelineImageTransform)."""

    def __init__(self, steps: Sequence, shuffle: bool = False):
        # steps: [(transform, prob)] or [transform, ...]
        self.steps = [(s, 1.0) if isinstance(s, ImageTransform) else s
                      for s in steps]
        self.shuffle = shuffle

    def transform(self, img, rng):
        steps = list(self.steps)
        if self.shuffle:
            rng.shuffle(steps)
        for t, p in steps:
            if rng.rand() < p:
                img = t.transform(img, rng)
        return img

    def transform_boxes(self, boxes, img_shape, rng):
        # box mapping is only well-defined for an unconditional, unshuffled
        # chain (probabilistic steps would transform image and boxes with
        # different coin flips)
        if self.shuffle or any(p < 1.0 for _, p in self.steps):
            raise ValueError(
                "PipelineImageTransform with shuffle/probabilistic steps "
                "cannot map object-detection boxes; use p=1.0 steps")
        for t, _ in self.steps:
            boxes = t.transform_boxes(boxes, img_shape, rng)
        return boxes


# ------------------------------------------------------------ label sources

class ParentPathLabelGenerator:
    """Label = name of the file's parent directory (ref:
    org.datavec.api.io.labels.ParentPathLabelGenerator)."""

    def getLabelForPath(self, path: str) -> str:
        return os.path.basename(os.path.dirname(os.path.abspath(path)))


class PathLabelGenerator(ParentPathLabelGenerator):
    pass


def _list_files(root: str, exts) -> List[str]:
    out = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.lower().endswith(tuple(exts)):
                out.append(os.path.join(dirpath, f))
    return sorted(out)


def _list_images(root: str) -> List[str]:
    return _list_files(root, _IMG_EXTS)


# ----------------------------------------------------------- record readers

class ImageRecordReader(RecordReader):
    """Directory-of-class-directories image reader
    (ref: org.datavec.image.recordreader.ImageRecordReader).

    Records are ``[NDArrayWritable(CHW float32), IntWritable(label)]``;
    label classes are the sorted parent-directory names."""

    def __init__(self, height: int, width: int, channels: int = 3,
                 label_generator=None, transform: ImageTransform = None,
                 seed: int = 12345):
        self.loader = NativeImageLoader(height, width, channels)
        self.label_generator = label_generator or ParentPathLabelGenerator()
        self.transform = transform
        self._rng = np.random.RandomState(seed)
        self._files: List[str] = []
        self.labels: List[str] = []
        self._pos = 0

    def initialize(self, path: str):
        """path: root directory (FileSplit equivalent)."""
        self._files = _list_images(path)
        if not self._files:
            raise FileNotFoundError(f"no images under {path}")
        self.labels = sorted({self.label_generator.getLabelForPath(f)
                              for f in self._files})
        self._pos = 0
        return self

    def numLabels(self) -> int:
        return len(self.labels)

    def hasNext(self):
        return self._pos < len(self._files)

    def next(self):
        f = self._files[self._pos]
        self._pos += 1
        img = self.loader.asMatrix(f)
        if self.transform is not None:
            img = self.transform.transform(img, self._rng)
        label = self.labels.index(self.label_generator.getLabelForPath(f))
        return [NDArrayWritable(img), IntWritable(label)]

    def reset(self):
        self._pos = 0


class ImageRecordReaderDataSetIterator(DataSetIterator):
    """ImageRecordReader -> NCHW DataSet batches (the image case of
    RecordReaderDataSetIterator — ref: same class, NDArrayWritable
    branch)."""

    def __init__(self, reader: ImageRecordReader, batch_size: int,
                 num_classes: int = None):
        self.reader = reader
        self.batch_size = batch_size
        self.num_classes = num_classes or reader.numLabels()

    def reset(self):
        self.reader.reset()

    def hasNext(self):
        return self.reader.hasNext()

    def next(self) -> DataSet:
        feats, labels = [], []
        while self.reader.hasNext() and len(feats) < self.batch_size:
            img_w, lab_w = self.reader.next()
            feats.append(img_w.value)
            labels.append(lab_w.value)
        x = np.stack(feats).astype(np.float32)
        y = np.eye(self.num_classes, dtype=np.float32)[
            np.asarray(labels, np.int64)]
        return self._apply_pre(DataSet(x, y))

    def batch(self):
        return self.batch_size

    def totalOutcomes(self):
        return self.num_classes


class ObjectDetectionRecordReader(RecordReader):
    """Images + bounding boxes -> YOLO2 training records
    (ref: org.datavec.image.recordreader.objdetect.ObjectDetectionRecordReader).

    ``label_provider(path) -> [(x1, y1, x2, y2, class_name)]`` in PIXEL
    coordinates of the ORIGINAL image (ref: ImageObjectLabelProvider).
    Records are ``[NDArrayWritable(CHW image), NDArrayWritable(label)]``
    where the label tensor is ``[4 + C, gridH, gridW]`` — channels 0..3 =
    (x1, y1, x2, y2) in GRID units stored at the box-center cell, then a
    one-hot class plane — exactly ``nn/objdetect.Yolo2OutputLayer``'s
    ``compute_loss`` label format."""

    def __init__(self, height: int, width: int, channels: int,
                 grid_h: int, grid_w: int, label_provider: Callable,
                 classes: Sequence[str], transform: ImageTransform = None,
                 seed: int = 12345):
        self.loader = NativeImageLoader(height, width, channels)
        self.grid_h, self.grid_w = int(grid_h), int(grid_w)
        self.label_provider = label_provider
        self.classes = list(classes)
        self.transform = transform
        self._rng = np.random.RandomState(seed)
        self._files: List[str] = []
        self._pos = 0

    def initialize(self, path: str):
        self._files = _list_images(path)
        if not self._files:
            raise FileNotFoundError(f"no images under {path}")
        self._pos = 0
        return self

    def hasNext(self):
        return self._pos < len(self._files)

    def reset(self):
        self._pos = 0

    def _label_tensor(self, boxes, orig_hw) -> np.ndarray:
        C = len(self.classes)
        lab = np.zeros((4 + C, self.grid_h, self.grid_w), np.float32)
        oh, ow = orig_hw
        sx = self.grid_w / float(ow)
        sy = self.grid_h / float(oh)
        for (x1, y1, x2, y2, cls) in boxes:
            gx1, gy1, gx2, gy2 = x1 * sx, y1 * sy, x2 * sx, y2 * sy
            cx = min(int((gx1 + gx2) / 2.0), self.grid_w - 1)
            cy = min(int((gy1 + gy2) / 2.0), self.grid_h - 1)
            lab[0, cy, cx] = gx1
            lab[1, cy, cx] = gy1
            lab[2, cy, cx] = gx2
            lab[3, cy, cx] = gy2
            lab[4 + self.classes.index(cls), cy, cx] = 1.0
        return lab

    def next(self):
        from PIL import Image
        f = self._files[self._pos]
        self._pos += 1
        with Image.open(f) as im:
            orig_hw = (im.size[1], im.size[0])
            img = self.loader.asMatrix(im)  # single open+decode per record
        boxes = [(x1, y1, x2, y2, c)
                 for (x1, y1, x2, y2, c) in self.label_provider(f)]
        if self.transform is not None:
            boxes = self.transform.transform_boxes(
                boxes, (img.shape[0],) + orig_hw, self._rng)
            img = self.transform.transform(img, self._rng)
        return [NDArrayWritable(img),
                NDArrayWritable(self._label_tensor(boxes, orig_hw))]


class ObjectDetectionDataSetIterator(DataSetIterator):
    """ObjectDetectionRecordReader -> (images, YOLO label grid) batches."""

    def __init__(self, reader: ObjectDetectionRecordReader, batch_size: int):
        self.reader = reader
        self.batch_size = batch_size

    def reset(self):
        self.reader.reset()

    def hasNext(self):
        return self.reader.hasNext()

    def next(self) -> DataSet:
        feats, labs = [], []
        while self.reader.hasNext() and len(feats) < self.batch_size:
            f, l = self.reader.next()
            feats.append(f.value)
            labs.append(l.value)
        return self._apply_pre(DataSet(np.stack(feats).astype(np.float32),
                                       np.stack(labs).astype(np.float32)))

    def batch(self):
        return self.batch_size
