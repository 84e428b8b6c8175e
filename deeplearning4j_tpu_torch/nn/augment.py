"""On-device image augmentation inside the train step — the port of
``deeplearning4j_tpu/nn/augment.py``.

The staged pipeline (``data.pipeline``) ships decoded uint8 NCHW; the
crop/flip/normalize work runs here, as the prelude of the train step
(``BaseNetwork._step_on``), in NCHW before the network's NHWC seam, so
on the card it is part of the captured step and the host never pays a
float conversion or an augmentation pass.

Fixed shapes: every op maps ``[B, C, H, W]`` to a fixed output shape
(the random crop takes a random OFFSET into a fixed ``[H-c, W-c]``
window), so one captured graph serves every step. The crop is one
batched gather whatever B is, never a loop over images.

Random draws: the JAX package's ``fold_in(PRNGKey(seed), t)`` is
threefry and is not reproduced. Each op draws from the port's
counter-based hash (:func:`~deeplearning4j_tpu_torch.ops.normalization.
hash24`) keyed by :meth:`DeviceAugmentation.step_key` on the device
clock ``t``, folded with the op's index: a function of the seed, the
step and the op alone, so the draws are the same eagerly, in a captured
replay and after a resume, and each step of a K-step dispatch takes its
own. :func:`draw` makes every draw; the parity tests replace it with the
JAX package's.

Deterministic ops (fixed flip, ``scale``, ``scale_to``, ``normalize``,
``grayscale``) equal the JAX ones on uint8 input, and ``rotate`` follows
its inverse-mapped bilinear gather. ``resize`` is
``F.interpolate(bilinear, antialias=True)``, the family of
``jax.image.resize(..., "linear")`` but not its border weights
(``tests/test_torch_augment.py`` states the tolerance). Crop and flips
run on the uint8 bytes (exact there); the cast to fp32 comes before the
first op that does arithmetic.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.ops.normalization import StepKey, hash24

_UNIT = float(1 << 24)
#: the first fold of every augmentation key (dropout keys fold layers)
_AUG_PATH = 0x61756701


#: per-channel constants on the device, by (values, device, dtype): made
#: once and never freed, so a captured step that reads them stays valid
#: whichever equal augmentation object is attached later
_CONSTS = {}


def _channel_consts(values, like: torch.Tensor):
    """``values`` (tuples of per-channel floats) as ``[1, C, 1, 1]``
    tensors on ``like``'s device. A copy from the host inside a captured
    step would break the capture: the eager warm-up runs before a capture
    make them."""
    k = (values, str(like.device), like.dtype)
    got = _CONSTS.get(k)
    if got is None:
        got = tuple(torch.tensor(v, dtype=like.dtype).reshape(1, -1, 1, 1)
                    .to(like.device) for v in values)
        _CONSTS[k] = got
    return got


def draw(kind: str, key: StepKey, b: int, device, **kw) -> torch.Tensor:
    """The random draw of one op on a batch of ``b`` images: ``crop``
    offsets ``[b, 2]`` int64 in ``[0, high)``, ``random_flip`` modes
    ``[b]`` in ``{0, 1, 2}``, ``brightness`` deltas ``[b]`` uniform in
    ``[-delta, delta]``, ``rotate`` angles ``[b]`` (degrees) uniform in
    ``[-angle, angle]``."""
    if kind == "crop":
        h = hash24(key, 2 * b, device)
        return ((h * int(kw["high"])) >> 24).reshape(b, 2)
    if kind == "random_flip":
        return (hash24(key, b, device) * 3) >> 24
    u = hash24(key, b, device).float() / _UNIT
    lim = float(kw["delta"] if kind == "brightness" else kw["angle"])
    return u * (2 * lim) - lim


class DeviceAugmentation:
    """A chain of fixed-shape ops applied inside the train step; a
    chainable builder. :meth:`signature` is its identity in the
    networks' step-cache key (an equal chain reuses the captured step)."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        #: (signature, fn(x, key), exact on uint8 bytes)
        self._ops: List[Tuple[Tuple, object, bool]] = []

    # ------------------------------------------------------------ builders
    def flip(self, mode: int = 1) -> "DeviceAugmentation":
        """Deterministic flip (the host ``FlipImageTransform`` codes):
        1 = horizontal, 0 = vertical, -1 = both."""
        if mode not in (0, 1, -1):
            raise ValueError(f"flip mode must be 0, 1 or -1, got {mode}")
        dims = {1: (-1,), 0: (-2,), -1: (-2, -1)}[mode]
        self._ops.append((("flip", mode), lambda x, key: x.flip(dims), True))
        return self

    def random_flip(self) -> "DeviceAugmentation":
        """Per-image random flip: one of {vertical, horizontal, both},
        uniformly (host ``FlipImageTransform(None)``)."""

        def op(x, key):
            mode = draw("random_flip", key, x.shape[0], x.device)
            hor = ((mode == 1) | (mode == 2))[:, None, None, None]
            ver = ((mode == 0) | (mode == 2))[:, None, None, None]
            x = torch.where(hor, x.flip(-1), x)
            return torch.where(ver, x.flip(-2), x)
        self._ops.append((("random_flip",), op, True))
        return self

    def crop(self, crop: int) -> "DeviceAugmentation":
        """Per-image random crop to the fixed ``[H-crop, W-crop]`` (an
        offset in ``[0, crop]`` on each axis), as one gather."""
        c = int(crop)
        if c < 0:
            raise ValueError("crop must be >= 0")

        def op(x, key):
            b, ch, h, w = x.shape
            dev = x.device
            off = draw("crop", key, b, dev, high=c + 1)
            rows = off[:, 0:1] + torch.arange(h - c, device=dev)
            cols = off[:, 1:2] + torch.arange(w - c, device=dev)
            bi = torch.arange(b, device=dev)[:, None, None, None]
            ci = torch.arange(ch, device=dev)[None, :, None, None]
            return x[bi, ci, rows[:, None, :, None], cols[:, None, None, :]]
        self._ops.append((("crop", c), op, True))
        return self

    def scale(self, factor: float) -> "DeviceAugmentation":
        """Multiply pixel values (host ``ScaleImageTransform``)."""
        f = float(factor)
        self._ops.append((("scale", f), lambda x, key: x * f, False))
        return self

    def scale_to(self, a: float = 0.0, b: float = 1.0
                 ) -> "DeviceAugmentation":
        """Pixels ``[0, 255] -> [a, b]`` (host ``ImagePreProcessingScaler``
        on the device)."""
        a, b = float(a), float(b)
        self._ops.append((("scale_to", a, b),
                          lambda x, key: x / 255.0 * (b - a) + a, False))
        return self

    def normalize(self, mean: Sequence[float],
                  std: Sequence[float]) -> "DeviceAugmentation":
        """Per-channel ``(x - mean) / std``."""
        m = tuple(float(v) for v in mean)
        s = tuple(float(v) for v in std)

        def op(x, key):
            mm, ss = _channel_consts((m, s), x)
            return (x - mm) / ss
        self._ops.append((("normalize", m, s), op, False))
        return self

    def brightness(self, delta: float,
                   random: bool = False) -> "DeviceAugmentation":
        """Add ``delta`` (or a per-image uniform draw in ``[-delta,
        delta]``) and clip to ``[0, 255]`` (host ``BrightnessTransform``)."""
        d = float(delta)

        def op(x, key):
            dd = draw("brightness", key, x.shape[0], x.device,
                      delta=d)[:, None, None, None] if random else d
            return torch.clamp(x + dd, 0.0, 255.0)
        self._ops.append((("brightness", d, bool(random)), op, False))
        return self

    def resize(self, height: int, width: int) -> "DeviceAugmentation":
        """Bilinear resize to a fixed ``[height, width]``, antialiased when
        it scales down."""
        h, w = int(height), int(width)
        if h <= 0 or w <= 0:
            raise ValueError("resize dims must be positive")
        self._ops.append((("resize", h, w), lambda x, key: F.interpolate(
            x, size=(h, w), mode="bilinear", align_corners=False,
            antialias=True), False))
        return self

    def rotate(self, angle: float, random: bool = False
               ) -> "DeviceAugmentation":
        """Rotate about the image centre by ``angle`` degrees (or a
        per-image uniform draw in ``[-angle, angle]``), counter-clockwise
        as PIL: each output pixel inverse-mapped into the source, a
        bilinear gather of its four neighbours, 0 outside (PIL's fill).
        The shape is unchanged."""
        a = float(angle)

        def op(x, key):
            b, c, h, w = x.shape
            dev = x.device
            deg = draw("rotate", key, b, dev, angle=a) if random \
                else torch.full((b,), a, dtype=torch.float32, device=dev)
            rad = -deg * (math.pi / 180.0)
            cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
            yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] \
                - cy
            xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] \
                - cx
            cos = torch.cos(rad)[:, None, None]
            sin = torch.sin(rad)[:, None, None]
            sy = cos * yy - sin * xx + cy                     # [B, H, W]
            sx = sin * yy + cos * xx + cx
            y0, x0 = torch.floor(sy), torch.floor(sx)
            wy, wx = sy - y0, sx - x0
            y0i, x0i = y0.long(), x0.long()
            flat = x.reshape(b, c, h * w)

            def corner(yi, xi):
                inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
                at = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)) \
                    .reshape(b, 1, h * w).expand(b, c, h * w)
                g = torch.gather(flat, 2, at).reshape(b, c, h, w)
                return torch.where(inb[:, None], g, torch.zeros_like(g))
            tl, tr = corner(y0i, x0i), corner(y0i, x0i + 1)
            bl, br = corner(y0i + 1, x0i), corner(y0i + 1, x0i + 1)
            wx, wy = wx[:, None], wy[:, None]
            top = tl * (1 - wx) + tr * wx
            bot = bl * (1 - wx) + br * wx
            return (top * (1 - wy) + bot * wy).to(x.dtype)
        self._ops.append((("rotate", a, bool(random)), op, False))
        return self

    def grayscale(self) -> "DeviceAugmentation":
        """RGB -> luma, kept 3-channel (host ``ColorConversionTransform``)."""

        def op(x, key):
            if x.shape[1] != 3:
                return x
            g = 0.299 * x[:, 0] + 0.587 * x[:, 1] + 0.114 * x[:, 2]
            return torch.stack([g, g, g], dim=1)
        self._ops.append((("grayscale",), op, False))
        return self

    # ----------------------------------------------------- host-preset map
    @classmethod
    def from_transforms(cls, transforms, seed: int = 0
                        ) -> "DeviceAugmentation":
        """The host ``ImageTransform`` presets (and
        ``ImagePreProcessingScaler``) as a device chain; ``ValueError``
        for one without a device op (keep it on the host path)."""
        from deeplearning4j_tpu_torch.data import image as img
        from deeplearning4j_tpu_torch.data.dataset import (
            ImagePreProcessingScaler)
        aug = cls(seed=seed)

        def add(t):
            if isinstance(t, img.PipelineImageTransform):
                if t.shuffle or any(p < 1.0 for _, p in t.steps):
                    raise ValueError(
                        "PipelineImageTransform with shuffle/probabilistic "
                        "steps has no device op (the device chain is "
                        "unconditional); keep it on the host path")
                for sub, _ in t.steps:
                    add(sub)
            elif isinstance(t, img.FlipImageTransform):
                if t.mode is None:
                    aug.random_flip()
                else:
                    aug.flip(t.mode)
            elif isinstance(t, img.CropImageTransform):
                aug.crop(t.crop)
            elif isinstance(t, img.ResizeImageTransform):
                aug.resize(t.height, t.width)
            elif isinstance(t, img.RotateImageTransform):
                aug.rotate(t.angle, t.random)
            elif isinstance(t, img.ScaleImageTransform):
                aug.scale(t.scale)
            elif isinstance(t, img.BrightnessTransform):
                aug.brightness(t.delta, t.random)
            elif isinstance(t, img.ColorConversionTransform):
                aug.grayscale()
            elif isinstance(t, ImagePreProcessingScaler):
                aug.scale_to(t.a, t.b)
            else:
                raise ValueError(f"{type(t).__name__} has no device op; "
                                 "keep it on the host path")
        for t in (transforms if isinstance(transforms, (list, tuple))
                  else [transforms]):
            add(t)
        return aug

    # --------------------------------------------------------------- apply
    def signature(self) -> Tuple:
        """Hashable identity: the seed and the op chain."""
        return (self.seed,) + tuple(sig for sig, _, _ in self._ops)


    def apply(self, x: torch.Tensor, key: StepKey) -> torch.Tensor:
        """The chain on one batch: op i draws from ``key.fold(i)``; uint8
        bytes become fp32 before the first op that is not exact on them
        (and at the end)."""
        for i, (_, op, exact) in enumerate(self._ops):
            if x.dtype == torch.uint8 and not exact:
                x = x.float()
            x = op(x, key.fold(i))
        return x.float() if x.dtype == torch.uint8 else x

    def step_key(self, t) -> StepKey:
        """The step's augmentation key on the device clock ``t``: a path
        of its own, so it draws apart from the dropout keys of a network
        with the same seed."""
        return StepKey(self.seed, t, (_AUG_PATH,))

    def output_hw(self, height: int, width: int) -> Tuple[int, int]:
        """The output spatial dims for declared input dims."""
        for sig, _, _ in self._ops:
            if sig[0] == "crop":
                height, width = height - sig[1], width - sig[1]
            elif sig[0] == "resize":
                height, width = sig[1], sig[2]
        return height, width

    def __repr__(self):
        ops = ", ".join(".".join(map(str, sig)) for sig, _, _ in self._ops)
        return f"DeviceAugmentation(seed={self.seed}, ops=[{ops}])"


def maybe_augment(augment, x, t):
    """The train step's prelude: identity without an augmentation, else
    the seeded chain on a 4-D (NCHW image) input; other inputs pass
    through."""
    if augment is None or not isinstance(x, torch.Tensor) or x.dim() != 4:
        return x
    return augment.apply(x, augment.step_key(t))
