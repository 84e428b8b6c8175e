"""The staged image pipeline's decode worker and its one-file decode
(``_decode_one`` and ``_worker_main`` of ``deeplearning4j_tpu/data/
pipeline.py``).

This module imports numpy and the standard library only (cv2 or PIL
inside :func:`decode_one`), so a ``spawn`` worker that starts here loads
neither torch nor anything that could initialize CUDA; it also hides the
card from itself (``CUDA_VISIBLE_DEVICES``) before it unpickles a host
transform, whose module imports torch.
"""

from __future__ import annotations

import os
import time
from multiprocessing import shared_memory as _shm
from typing import List, Optional

import numpy as np


def decode_one(path: str, height: int, width: int, channels: int
               ) -> np.ndarray:
    """Decode and resize one file to CHW uint8: cv2 (libjpeg-turbo) when
    it imports, else PIL, as the JAX package does (the two give different
    pixels; one machine always takes the same branch)."""
    try:
        import cv2
        flag = cv2.IMREAD_GRAYSCALE if channels == 1 else cv2.IMREAD_COLOR
        img = cv2.imread(path, flag)
        if img is None:
            raise ValueError(f"cv2 failed to decode {path}")
        if img.shape[:2] != (height, width):
            img = cv2.resize(img, (width, height),
                             interpolation=cv2.INTER_LINEAR)
        if channels == 1:
            img = img[:, :, None]
        else:
            img = img[:, :, ::-1]                    # BGR -> RGB (PIL parity)
        return np.ascontiguousarray(np.transpose(img, (2, 0, 1)))
    except ImportError:
        from PIL import Image
        img = Image.open(path).convert("L" if channels == 1 else "RGB")
        if img.size != (width, height):
            img = img.resize((width, height), Image.BILINEAR)
        arr = np.asarray(img, np.uint8)
        if arr.ndim == 2:
            arr = arr[:, :, None]
        return np.transpose(arr, (2, 0, 1))


def codec() -> str:
    """The decoder :func:`decode_one` takes in this process: "cv2" or
    "PIL"."""
    try:
        import cv2  # noqa: F401
        return "cv2"
    except ImportError:
        return "PIL"


def worker_main(shm_name: str, ring_shape, slot_dtype: str,
                files: List[str], hw, task_q, ready_q,
                transform_bytes: Optional[bytes]):
    """Decode-worker loop: pull a sub-batch task ``(mega_id, k, slot,
    idxs, task_seed)``, decode into ``ring[slot][k]``, report ``("ok",
    mega_id, k, slot, decode_s, idle_s)`` (or ``("error", ..., message)``:
    a decode failure must reach the consumer, not end the worker
    silently). Runs until the ``None`` sentinel. The transform's RNG is
    seeded per task, not per worker, so what it draws does not depend on
    which worker took the task."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""     # a worker never uses the card
    try:
        import cv2
        cv2.setNumThreads(1)        # one decode stream per worker process
    except ImportError:
        pass
    height, width, channels = hw
    transform = None
    if transform_bytes is not None:
        import pickle
        # the parent pickled it (ImagePipeline.decode(transform=...))
        transform = pickle.loads(transform_bytes)
    # the parent owns the ring: this process must not register (and later
    # unlink) it with the resource tracker; Python < 3.13 has no
    # track=False, so stub the register call around the attach
    from multiprocessing import resource_tracker
    register = resource_tracker.register
    resource_tracker.register = lambda *a, **kw: None
    try:
        shm = _shm.SharedMemory(name=shm_name)
    finally:
        resource_tracker.register = register
    ring = np.ndarray(tuple(ring_shape), dtype=np.dtype(slot_dtype),
                      buffer=shm.buf)
    buf = None
    try:
        while True:
            t_idle = time.perf_counter()
            task = task_q.get()
            if task is None:
                break
            idle_s = time.perf_counter() - t_idle
            mega_id, k, slot, idxs, task_seed = task
            t0 = time.perf_counter()
            try:
                rng = np.random.RandomState(task_seed) \
                    if transform is not None else None
                buf = ring[slot][k]
                for row, i in enumerate(idxs):
                    img = decode_one(files[i], height, width, channels)
                    if transform is not None:
                        img = transform.transform(img.astype(np.float32), rng)
                        img = np.clip(img, 0, 255)
                    buf[row] = img      # implicit cast to the slot dtype
            except Exception as e:
                ready_q.put(("error", mega_id, k, slot,
                             f"{type(e).__name__}: {e}"))
            else:
                ready_q.put(("ok", mega_id, k, slot,
                             time.perf_counter() - t0, idle_s))
    finally:
        ring = buf = None       # drop the views before the mapping closes
        shm.close()
