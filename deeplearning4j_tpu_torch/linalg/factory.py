"""Array factory — the ``Nd4j`` static-factory equivalent (the port of
``deeplearning4j_tpu/linalg/factory.py``).

Reference parity: ``org.nd4j.linalg.factory.Nd4j`` (create/zeros/ones/
rand/randn/arange/linspace/eye/concat/...) plus the default RNG seam
(``Nd4j.getRandom()``; ref: org.nd4j.linalg.api.rng, counter-based RNG with
saveable state).

Every creation function takes ``device=``: ``cuda`` unless the caller
names another (``device.resolve_device``; without a card it raises
rather than drop to the CPU). Combining functions keep their inputs'
device.

:class:`Random` keeps the JAX class's contract, a (seed, counter) pair
with ``getState``/``setState``: draw ``i`` of a stream comes from a
``torch.Generator`` on the array's device seeded with a 63-bit mix of
(seed, i), so a stream is deterministic, forkable and restorable. It is
the port's own stream (Philox on the card, Mersenne Twister on the
CPU), not bit-compatible with the JAX package's Threefry.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.linalg.dtypes import DataType
from deeplearning4j_tpu_torch.linalg.ndarray import (NDArray, _host_tensor,
                                                     _unwrap)
from deeplearning4j_tpu_torch.profiler.locks import InstrumentedLock

_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64's finalizer."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _M64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _M64
    return x ^ (x >> 31)


class Random:
    """Stateful, saveable counter-based RNG over torch Generators."""

    def __init__(self, seed: int = 0):
        self._seed = int(seed)
        self._counter = 0
        self._lock = InstrumentedLock("linalg:random")

    def setSeed(self, seed: int) -> None:
        with self._lock:
            self._seed = int(seed)
            self._counter = 0

    def getSeed(self) -> int:
        return self._seed

    def next_seed(self) -> int:
        """The seed of the stream's next draw (advances the counter)."""
        with self._lock:
            s = _mix64(_mix64(self._seed & _M64) ^ self._counter) >> 1
            self._counter += 1
            return s

    def next_generator(self, device) -> torch.Generator:
        """A generator on ``device`` seeded for the next draw."""
        return torch.Generator(device=device).manual_seed(self.next_seed())

    # state save/restore (ref: saveable RNG state)
    def getState(self):
        return {"seed": self._seed, "counter": self._counter}

    def setState(self, state) -> None:
        with self._lock:
            self._seed = int(state["seed"])
            self._counter = int(state["counter"])


_default_random = Random(seed=np.random.SeedSequence().entropy % (2**31))


def getRandom() -> Random:
    return _default_random


def setSeed(seed: int) -> None:
    _default_random.setSeed(seed)


def _shape(args) -> tuple:
    if len(args) == 1 and isinstance(args[0], (tuple, list)):
        return tuple(int(s) for s in args[0])
    return tuple(int(s) for s in args)


# ----------------------------------------------------------------- creation
def create(data, shape=None, dtype: DataType = DataType.FLOAT,
           device=None) -> NDArray:
    dev = resolve_device(device)
    if isinstance(data, (NDArray, torch.Tensor)):
        t = _unwrap(data).to(dev)
    else:
        t = _host_tensor(data, dev)
    t = t.to(dtype.torch)
    if shape is not None:
        t = t.reshape(tuple(shape))
    return NDArray(t)


def zeros(*shape, dtype: DataType = DataType.FLOAT, device=None) -> NDArray:
    return NDArray(torch.zeros(_shape(shape), dtype=dtype.torch,
                               device=resolve_device(device)))


def ones(*shape, dtype: DataType = DataType.FLOAT, device=None) -> NDArray:
    return NDArray(torch.ones(_shape(shape), dtype=dtype.torch,
                              device=resolve_device(device)))


def valueArrayOf(shape, value, dtype: DataType = DataType.FLOAT,
                 device=None) -> NDArray:
    return NDArray(torch.full(tuple(shape), value, dtype=dtype.torch,
                              device=resolve_device(device)))


def full(shape, value, dtype: DataType = DataType.FLOAT,
         device=None) -> NDArray:
    return valueArrayOf(shape, value, dtype, device)


def zerosLike(arr) -> NDArray:
    return NDArray(torch.zeros_like(_unwrap(arr)))


def onesLike(arr) -> NDArray:
    return NDArray(torch.ones_like(_unwrap(arr)))


def eye(n: int, dtype: DataType = DataType.FLOAT, device=None) -> NDArray:
    return NDArray(torch.eye(n, dtype=dtype.torch,
                             device=resolve_device(device)))


def arange(*args, dtype: DataType = DataType.FLOAT, device=None) -> NDArray:
    return NDArray(torch.arange(*args, dtype=dtype.torch,
                                device=resolve_device(device)))


def linspace(start, stop, num, dtype: DataType = DataType.FLOAT,
             device=None) -> NDArray:
    return NDArray(torch.linspace(start, stop, int(num), dtype=dtype.torch,
                                  device=resolve_device(device)))


def scalar(value, dtype: DataType = DataType.FLOAT, device=None) -> NDArray:
    return NDArray(torch.tensor(value, dtype=dtype.torch,
                                device=resolve_device(device)))


def empty(dtype: DataType = DataType.FLOAT, device=None) -> NDArray:
    return NDArray(torch.zeros((0,), dtype=dtype.torch,
                               device=resolve_device(device)))


# ------------------------------------------------------------------- random
def _gen(rng: Optional[Random], device) -> torch.Generator:
    return (rng or _default_random).next_generator(device)


def rand(*shape, rng: Optional[Random] = None,
         dtype: DataType = DataType.FLOAT, device=None) -> NDArray:
    dev = resolve_device(device)
    return NDArray(torch.rand(_shape(shape), generator=_gen(rng, dev),
                              dtype=dtype.torch, device=dev))


def randn(*shape, rng: Optional[Random] = None,
          dtype: DataType = DataType.FLOAT, device=None) -> NDArray:
    dev = resolve_device(device)
    return NDArray(torch.randn(_shape(shape), generator=_gen(rng, dev),
                               dtype=dtype.torch, device=dev))


def randint(low: int, high: int, shape, rng: Optional[Random] = None,
            dtype: DataType = DataType.INT32, device=None) -> NDArray:
    dev = resolve_device(device)
    return NDArray(torch.randint(low, high, tuple(shape),
                                 generator=_gen(rng, dev), dtype=dtype.torch,
                                 device=dev))


def bernoulli(p: float, shape, rng: Optional[Random] = None,
              device=None) -> NDArray:
    dev = resolve_device(device)
    u = torch.rand(tuple(shape), generator=_gen(rng, dev), device=dev)
    return NDArray((u < p).to(torch.float32))


def shuffle(arr: NDArray, rng: Optional[Random] = None) -> NDArray:
    """IN-PLACE row shuffle (ref: Nd4j.shuffle mutates its argument)."""
    v = arr.tensor()
    perm = torch.randperm(v.shape[0], generator=_gen(rng, v.device),
                          device=v.device)
    arr._set_value(v[perm])
    return arr


# ----------------------------------------------------------------- combining
def _ts(arrs):
    return [_unwrap(a) for a in arrs]


def concat(dim: int, *arrs) -> NDArray:
    return NDArray(torch.cat(_ts(arrs), dim=dim))


def stack(dim: int, *arrs) -> NDArray:
    return NDArray(torch.stack(_ts(arrs), dim=dim))


def vstack(*arrs) -> NDArray:
    ts = [t.reshape(1, -1) if t.dim() == 1 else t for t in _ts(arrs)]
    return NDArray(torch.cat(ts, dim=0))


def hstack(*arrs) -> NDArray:
    ts = _ts(arrs)
    return NDArray(torch.cat(ts, dim=0 if ts[0].dim() == 1 else 1))


def pile(*arrs) -> NDArray:
    return stack(0, *arrs)


def where(cond, x, y) -> NDArray:
    c = _unwrap(cond)
    return NDArray(torch.where(c, torch.as_tensor(_unwrap(x), device=c.device),
                               torch.as_tensor(_unwrap(y), device=c.device)))


def gather(arr, indices, axis: int = 0) -> NDArray:
    v = _unwrap(arr)
    idx = torch.as_tensor(np.asarray(_unwrap(indices)) if not isinstance(
        _unwrap(indices), torch.Tensor) else _unwrap(indices),
        device=v.device).long()
    out = torch.index_select(v, axis, idx.reshape(-1))
    axis %= v.dim()
    return NDArray(out.reshape(v.shape[:axis] + idx.shape
                               + v.shape[axis + 1:]))


def sortWithIndices(arr, dim: int = -1, ascending: bool = True):
    v = _unwrap(arr)
    idx = torch.argsort(v, dim=dim, stable=True)
    if not ascending:
        idx = torch.flip(idx, dims=(dim,))
    return NDArray(torch.take_along_dim(v, idx, dim=dim)), NDArray(idx)


def oneHot(indices, depth: int, dtype: DataType = DataType.FLOAT,
           device=None) -> NDArray:
    idx = _unwrap(indices)
    if not isinstance(idx, torch.Tensor):
        idx = _host_tensor(idx, resolve_device(device))
    return NDArray(F.one_hot(idx.long(), depth).to(dtype.torch))
