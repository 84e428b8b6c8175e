"""Device mesh + sharding declarations — the port of
``deeplearning4j_tpu/parallel/mesh.py``.

A :class:`DeviceMesh` is a ``(data, model, seq)`` grid of ranks, one
device a rank: a ``torch.distributed.device_mesh.DeviceMesh`` (what
``init_device_mesh`` builds over every rank) in the default process
group (``parallel.init.initializeDistributed``), whose per-axis groups
carry the collectives (``parallel.collectives``). A process with no
group has the one-rank mesh, on which every collective is the
identity.

Axes convention (the JAX package's):

- ``data``  — the batch dim (data parallelism: gradients all-reduced)
- ``model`` — tensor parallelism, and ``seq`` — sequence parallelism;
  their rules wait for the next slice (ROADMAP.md): a mesh may name
  them, a rule or a plan that shards over one of size above 1 raises.

A sharded tensor is a rank's local piece of a global array, tagged with
its :class:`Placement` (global shape, the dim it is split along, the
number of pieces and this rank's piece); an untagged tensor is
replicated. A spec is a tuple of axis names (or None) a dim — the
port has no ``PartitionSpec``.
"""

from __future__ import annotations

import re
from collections import namedtuple
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.parallel.init import rank_device

AXES = ("data", "model", "seq")

#: a mesh member: ``id`` is its member id (``parallel.init.member_id``:
#: its first rank, stable across a shrink — the JAX device id's role)
RankDevice = namedtuple("RankDevice", ["id", "device"])

SLICE_24 = ("tensor and sequence parallelism (a 'model' or 'seq' axis "
            "of size above 1) are not ported yet; they come with the "
            "next slice of the port (ROADMAP.md queue 1)")


class Placement:
    """Where a tensor's values sit in its global array: piece ``index`` of
    ``parts`` equal pieces along ``dim`` of ``global_shape``."""

    __slots__ = ("global_shape", "dim", "parts", "index")

    def __init__(self, global_shape, dim: int, parts: int, index: int):
        self.global_shape = tuple(int(s) for s in global_shape)
        self.dim, self.parts, self.index = int(dim), int(parts), int(index)

    def slices(self) -> Tuple[slice, ...]:
        """This piece's global index, one slice a dim."""
        c = self.global_shape[self.dim] // self.parts
        return tuple(slice(self.index * c, (self.index + 1) * c)
                     if d == self.dim else slice(0, s)
                     for d, s in enumerate(self.global_shape))

    def spec(self, axis: str = "data") -> Tuple:
        return tuple(axis if d == self.dim else None
                     for d in range(len(self.global_shape)))

    def __repr__(self):
        return (f"Placement({self.global_shape}, dim={self.dim}, "
                f"{self.index}/{self.parts})")


def placement_of(t) -> Optional[Placement]:
    """A tensor's :class:`Placement`, or None (replicated)."""
    return getattr(t, "_dl4j_placement", None)


def global_shape(t) -> Tuple[int, ...]:
    """The shape of the global array a tensor is (a piece of)."""
    p = placement_of(t)
    return p.global_shape if p is not None else tuple(t.shape)


def set_placement(t: torch.Tensor, placement: Optional[Placement]):
    t._dl4j_placement = placement
    return t


def local_piece(full, placement: Optional[Placement]):
    """This rank's piece of a full (host or device) array."""
    if placement is None:
        return full
    return full[placement.slices()]


def spec_of(t) -> Tuple:
    """The tensor's spec: the data axis on its split dim, else all None
    (replicated)."""
    p = placement_of(t)
    if p is None:
        return tuple(None for _ in range(getattr(t, "ndim", 0)))
    return p.spec()


class DeviceMesh:
    """Named-axis mesh of ranks (see the module note)."""

    def __init__(self, mesh, shape: Dict[str, int], ranks: Sequence[int],
                 device_type: str):
        self.mesh = mesh                    # torch DeviceMesh or None
        self.shape = dict(shape)
        self.ranks = [int(r) for r in ranks]
        self.device_type = device_type

    @staticmethod
    def create(data: int = -1, model: int = 1, seq: int = 1,
               devices: Sequence = None) -> "DeviceMesh":
        """Build a (data, model, seq) mesh over ``devices`` (ranks or
        :data:`RankDevice` s; default every rank of the default group).
        ``data=-1`` takes all remaining."""
        world = dist.get_world_size() if dist.is_initialized() else 1
        from deeplearning4j_tpu_torch.parallel.init import rank_of_member
        ranks = [rank_of_member(d.id) if isinstance(d, RankDevice)
                 else int(d) for d in devices] \
            if devices is not None else list(range(world))
        n = len(ranks)
        if data == -1:
            if n % (model * seq):
                raise ValueError(f"{n} devices not divisible by model*seq")
            data = n // (model * seq)
        if data * model * seq != n:
            raise ValueError(f"mesh {data}x{model}x{seq} != {n} devices")
        shape = {"data": data, "model": model, "seq": seq}
        dev = rank_device()
        if not dist.is_initialized():
            if n != 1:
                raise RuntimeError(
                    f"a mesh of {n} ranks needs a process group: call "
                    "parallel.initializeDistributed in every rank first")
            return DeviceMesh(None, shape, ranks, dev.type)
        from torch.distributed.device_mesh import DeviceMesh as _TorchMesh
        mesh = _TorchMesh(dev.type, torch.tensor(ranks).reshape(
            data, model, seq), mesh_dim_names=AXES)
        return DeviceMesh(mesh, shape, ranks, dev.type)

    @staticmethod
    def data_parallel(devices: Sequence = None) -> "DeviceMesh":
        return DeviceMesh.create(data=-1, model=1, seq=1, devices=devices)

    @property
    def axis_names(self):
        return AXES

    @property
    def devices(self) -> list:
        """The mesh's members, axis-major (the set the elastic layer
        probes and shrinks from), by member id."""
        from deeplearning4j_tpu_torch.parallel.init import member_id
        return [RankDevice(member_id(r), self.device_type)
                for r in self.ranks]

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return rank_device()

    def group(self, axis: str = "data"):
        """The process group of this rank's line along ``axis`` (None on
        a mesh without torch.distributed: collectives over it are the
        identity)."""
        if self.mesh is None:
            return None
        return self.mesh.get_group(axis)

    def coordinate(self, axis: str = "data") -> int:
        """This rank's index along ``axis``."""
        if self.mesh is None:
            return 0
        return int(self.mesh.get_local_rank(axis))

    def is_writer(self) -> bool:
        """True on the mesh's first rank (the one that writes what every
        rank holds alike)."""
        if self.mesh is None:
            return True
        return dist.get_rank() == self.ranks[0]

    def spec(self, **kw):
        """The declaration of this mesh for the static distribution
        analyzer (:class:`analysis.distribution.MeshSpec`); keywords
        forward to it. The rank count is declared as the device count
        (E102)."""
        kw.setdefault("devices", self.size())
        from deeplearning4j_tpu_torch.analysis.distribution import MeshSpec
        return MeshSpec(dict(self.shape), **kw)

    def size(self, axis: str = None) -> int:
        if axis is None:
            return int(np.prod([self.shape[a] for a in AXES]))
        return self.shape[axis]

    def require_data_only(self, what: str) -> None:
        if self.size("model") * self.size("seq") > 1:
            raise NotImplementedError(f"{what}: {SLICE_24}")

    # ------------------------------------------------------------ staging
    def shard_rows(self, a, dim: int = 0):
        """This rank's rows of a global host or device array (``dim`` is
        the batch dim), on this rank's device, tagged with its
        :class:`Placement`; an array already tagged passes through."""
        if a is None:
            return None
        if isinstance(a, torch.Tensor) and placement_of(a) is not None:
            return a
        n = self.size("data")
        b = int(a.shape[dim])
        if b % n:
            raise ValueError(f"batch of {b} rows does not split over a "
                             f"data axis of {n} (pad it first)")
        r = self.coordinate("data")
        c = b // n
        idx = tuple(slice(r * c, (r + 1) * c) if d == dim else slice(None)
                    for d in range(np.ndim(a)))
        piece = a[idx]
        if not isinstance(piece, torch.Tensor):
            piece = torch.from_numpy(np.ascontiguousarray(piece))
        t = piece.to(self.device)
        return set_placement(t, Placement(a.shape, dim, n, r))

    def shard_batch(self, tree):
        """A host batch onto the mesh: each leaf's dim 0 split over the
        data axis (this rank keeps its rows)."""
        return _tree_map(self.shard_rows, tree)

    def replicate(self, tree):
        """Each leaf on this rank's device, whole (every rank is handed the
        same value)."""
        dev = self.device

        def put(a):
            if isinstance(a, torch.Tensor):
                return a.to(dev)
            return torch.as_tensor(np.asarray(a)).to(dev)
        return _tree_map(put, tree)

    def __enter__(self):
        # the JAX mesh's context scopes its jit; the port's collectives
        # name their group, so the context only hands the mesh back
        return self

    def __exit__(self, *exc):
        return False

    def __repr__(self):
        return f"DeviceMesh({self.shape}, ranks={self.ranks})"


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


class ShardingRule:
    """Regex-based parameter sharding rules: ``{param-name-regex:
    spec-tuple}``; the first match wins, unmatched params replicate."""

    def __init__(self, rules: Dict[str, Tuple]):
        self.rules = [(re.compile(k), tuple(v)) for k, v in rules.items()]

    def spec_for(self, name: str, ndim: int) -> Tuple:
        for pat, spec in self.rules:
            if pat.search(name):
                return tuple(spec)
        return ()

    def shard_params(self, mesh: DeviceMesh, named_params: Dict):
        """Apply the rules to a flat ``{name: array}`` dict: a dim ruled
        over ``data`` keeps this rank's piece (tagged); a ``model`` or
        ``seq`` axis of size above 1 raises (next slice)."""
        out = {}
        for name, arr in named_params.items():
            t = arr if isinstance(arr, torch.Tensor) \
                else torch.as_tensor(np.asarray(arr))
            out[name] = place_by_spec(mesh, t, self.spec_for(name, t.dim()))
        return out


def check_spec(mesh: DeviceMesh, spec: Tuple, what: str) -> Optional[int]:
    """The dim a spec shards over ``data`` (None if none); raises for a
    model/seq axis of size above 1 (next slice) or an unknown axis."""
    dim = None
    for d, e in enumerate(spec or ()):
        for a in (e if isinstance(e, (tuple, list)) else (e,)):
            if a is None:
                continue
            if a not in AXES:
                raise ValueError(f"{what}: {a!r} is not a mesh axis {AXES}")
            if a != "data":
                if mesh.size(a) > 1:
                    raise NotImplementedError(f"{what}: {SLICE_24}")
                continue
            dim = d
    return dim


def place_by_spec(mesh: DeviceMesh, t: torch.Tensor, spec: Tuple):
    """``t`` (a global value, the same on every rank) placed per
    ``spec``: whole on this rank's device, or this rank's piece of the
    dim ``spec`` splits over ``data``."""
    dim = check_spec(mesh, spec, "sharding rule")
    n = mesh.size("data")
    if dim is None or n == 1:
        return t.to(mesh.device)
    if t.shape[dim] % n:
        raise ValueError(f"dim {dim} ({t.shape[dim]}) does not split over "
                         f"a data axis of {n}")
    r = mesh.coordinate("data")
    p = Placement(t.shape, dim, n, r)
    return set_placement(local_piece(t, p).contiguous().to(mesh.device), p)
