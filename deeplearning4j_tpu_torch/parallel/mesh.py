"""Device mesh + sharding declarations — the port of
``deeplearning4j_tpu/parallel/mesh.py``.

A :class:`DeviceMesh` is a grid of ranks with named axes, one device a
rank: a ``torch.distributed.device_mesh.DeviceMesh`` (what
``init_device_mesh`` builds over every rank) in the default process
group (``parallel.init.initializeDistributed``), whose per-axis groups
carry the collectives (``parallel.collectives``). A process with no
group has the one-rank mesh, on which every collective is the
identity.

Axes convention (the JAX package's):

- ``data``  — the batch dim (data parallelism: gradients all-reduced)
- ``model`` — tensor parallelism (Megatron: activations all-reduced)
- ``seq``   — sequence parallelism (ring attention over the axis)

:meth:`DeviceMesh.create` builds the ``(data, model, seq)`` grid;
:meth:`DeviceMesh.from_axes` any other, e.g. ``{"data": 2, "pipe": 4}``
for the pipeline (``parallel.pipeline``), as the JAX tests build
``Mesh(devices.reshape(2, 4), ("data", "pipe"))``. An axis a mesh does
not name has size 1 there.

A sharded tensor is a rank's local piece of a global array, tagged with
its :class:`Placement` (global shape, the dim it is split along, the
mesh axes that split it, the number of pieces and this rank's piece); an
untagged tensor is replicated. A spec is a tuple of axis names (or None,
or a tuple of names) a dim — the port has no ``PartitionSpec``. A dim
named by two axes splits over their product, the first one major.
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


class Placement:
    """Where a tensor's values sit in its global array: piece ``index`` of
    ``parts`` pieces along ``dim`` of ``global_shape``, split over the
    mesh ``axes`` (major first). A dim the parts do not divide splits as
    ``torch.chunk`` does (pieces of ``ceil(n / parts)``, the last ones
    shorter), as GSPMD pads an uneven split. With ``groups`` above 1 the
    dim is ``groups`` equal blocks, each split alike (evenly), and the
    piece is the blocks' pieces joined (a fused ``[q | k | v]``
    projection split by heads)."""

    __slots__ = ("global_shape", "dim", "parts", "index", "axes", "groups")

    def __init__(self, global_shape, dim: int, parts: int, index: int,
                 axes: Tuple[str, ...] = ("data",), groups: int = 1):
        self.global_shape = tuple(int(s) for s in global_shape)
        self.dim, self.parts, self.index = int(dim), int(parts), int(index)
        self.axes = tuple(axes)
        self.groups = int(groups)

    def slices(self) -> Tuple[slice, ...]:
        """This piece's global index, one slice a dim (one block: a
        grouped placement has no single index)."""
        if self.groups != 1:
            raise ValueError(f"{self!r}: a grouped piece is not one slice")
        n = self.global_shape[self.dim]
        c = self.chunk()
        lo = min(self.index * c, n)
        return tuple(slice(lo, min(lo + c, n)) if d == self.dim
                     else slice(0, s)
                     for d, s in enumerate(self.global_shape))

    def chunk(self) -> int:
        """The length of a whole piece along ``dim`` (the last ones of an
        uneven split are shorter)."""
        return -(-self.global_shape[self.dim] // self.parts)

    def spec(self, axis: str = None) -> Tuple:
        entry = axis if axis is not None else (
            self.axes[0] if len(self.axes) == 1 else self.axes)
        return tuple(entry if d == self.dim else None
                     for d in range(len(self.global_shape)))

    def __repr__(self):
        g = f", groups={self.groups}" if self.groups != 1 else ""
        return (f"Placement({self.global_shape}, dim={self.dim}, "
                f"{self.index}/{self.parts} over {self.axes}{g})")


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
    if placement.groups == 1:
        return full[placement.slices()]
    p = placement
    n = p.global_shape[p.dim] // p.groups
    c = n // p.parts
    idx = [slice(None)] * len(p.global_shape)
    blocks = []
    for g in range(p.groups):
        idx[p.dim] = slice(g * n + p.index * c, g * n + (p.index + 1) * c)
        blocks.append(full[tuple(idx)])
    if isinstance(full, torch.Tensor):
        return torch.cat(blocks, dim=p.dim)
    return np.concatenate(blocks, axis=p.dim)


def assemble(pieces, placement: Placement):
    """The whole array from every rank's piece (``pieces``: a list in
    piece order, or a tensor whose dim 0 runs over them): the inverse of
    :func:`local_piece`."""
    pieces = list(pieces.unbind(0)) if isinstance(pieces, torch.Tensor) \
        else list(pieces)
    d, g = placement.dim, placement.groups
    if g == 1:
        whole = torch.cat(pieces, dim=d)
        return whole.narrow(d, 0, placement.global_shape[d])
    chunks = [pc.chunk(g, dim=d) for pc in pieces]
    return torch.cat([chunks[r][b] for b in range(g)
                      for r in range(len(pieces))], dim=d)


def spec_of(t) -> Tuple:
    """The tensor's spec: its split axes on its split dim, else all None
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
        self.shape = dict(shape)            # axis -> size, in mesh order
        self.ranks = [int(r) for r in ranks]
        self.device_type = device_type

    @staticmethod
    def create(data: int = -1, model: int = 1, seq: int = 1,
               devices: Sequence = None) -> "DeviceMesh":
        """Build a (data, model, seq) mesh over ``devices`` (ranks or
        :data:`RankDevice` s; default every rank of the default group).
        ``data=-1`` takes all remaining."""
        return DeviceMesh.from_axes({"data": data, "model": model,
                                     "seq": seq}, devices)

    @staticmethod
    def from_axes(axes: Dict[str, int],
                  devices: Sequence = None) -> "DeviceMesh":
        """A mesh of any named axes, ``{axis: size}`` in major-to-minor
        order (one size may be -1: all remaining), e.g. ``{"data": 2,
        "pipe": 4}``. Every rank of the default group calls it alike: it
        forms a process group a line of each axis."""
        world = dist.get_world_size() if dist.is_initialized() else 1
        from deeplearning4j_tpu_torch.parallel.init import rank_of_member
        ranks = [rank_of_member(d.id) if isinstance(d, RankDevice)
                 else int(d) for d in devices] \
            if devices is not None else list(range(world))
        n = len(ranks)
        shape = {str(a): int(v) for a, v in axes.items()}
        free = [a for a, v in shape.items() if v == -1]
        if len(free) > 1:
            raise ValueError(f"mesh {shape}: at most one axis may be -1")
        known = int(np.prod([v for v in shape.values() if v != -1]))
        if free:
            if n % known:
                names = "*".join(a for a in shape if a not in free)
                raise ValueError(f"{n} devices not divisible by {names}")
            shape[free[0]] = n // known
        if int(np.prod(list(shape.values()))) != n:
            raise ValueError("mesh " + "x".join(str(v) for v in
                                                shape.values())
                             + f" != {n} devices")
        dev = rank_device()
        if not dist.is_initialized():
            if n != 1:
                raise RuntimeError(
                    f"a mesh of {n} ranks needs a process group: call "
                    "parallel.initializeDistributed in every rank first")
            return DeviceMesh(None, shape, ranks, dev.type)
        from torch.distributed.device_mesh import DeviceMesh as _TorchMesh
        mesh = _TorchMesh(dev.type, torch.tensor(ranks).reshape(
            tuple(shape.values())), mesh_dim_names=tuple(shape))
        return DeviceMesh(mesh, shape, ranks, dev.type)

    @staticmethod
    def data_parallel(devices: Sequence = None) -> "DeviceMesh":
        return DeviceMesh.create(data=-1, model=1, seq=1, devices=devices)

    @property
    def axis_names(self):
        return tuple(self.shape)

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
        a mesh without torch.distributed, or for an axis it does not
        name: collectives over it are the identity)."""
        if self.mesh is None or axis not in self.shape:
            return None
        return self.mesh.get_group(axis)

    def coordinate(self, axis: str = "data") -> int:
        """This rank's index along ``axis`` (0 for an axis the mesh does
        not name)."""
        if self.mesh is None or axis not in self.shape:
            return 0
        return int(self.mesh.get_local_rank(axis))

    def group_over(self, axes: Sequence[str]):
        """The process group of this rank's line over the product of
        ``axes`` (the first one major, so its group rank is
        :meth:`index_over`); one axis's own group for a single axis.
        A product group is formed at its first request, by every rank of
        the default group alike (``new_group`` is collective), and kept."""
        axes = tuple(axes)
        big = tuple(a for a in axes if self.size(a) > 1)
        if len(big) <= 1:
            return self.group(big[0] if big else axes[0])
        if self.mesh is None:
            return None
        cache = self.__dict__.setdefault("_product_groups", {})
        if big not in cache:
            names = self.axis_names
            grid = np.asarray(self.ranks).reshape(tuple(self.shape.values()))
            rest = [i for i, a in enumerate(names) if a not in big]
            order = rest + [names.index(a) for a in big]
            lines = grid.transpose(order).reshape(-1, self.size(big))
            me = dist.get_rank()
            for line in lines.tolist():
                g = dist.new_group(ranks=line)
                if me in line:
                    cache[big] = g
        return cache[big]

    def index_over(self, axes: Sequence[str]) -> int:
        """This rank's index over the product of ``axes``, the first one
        major."""
        i = 0
        for a in axes:
            i = i * self.size(a) + self.coordinate(a)
        return i

    def leader(self) -> int:
        """The global rank of the mesh's first member."""
        return self.ranks[0]

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
            return int(np.prod(list(self.shape.values())))
        if isinstance(axis, (tuple, list)):
            return int(np.prod([self.size(a) for a in axis]))
        return self.shape.get(axis, 1)

    # ------------------------------------------------------------ staging
    def shard_rows(self, a, dim: int = 0, axes: Sequence[str] = ("data",)):
        """This rank's rows of a global host or device array (``dim`` is
        the batch dim, split over ``axes``), on this rank's device,
        tagged with its :class:`Placement`; an array already tagged
        passes through."""
        if a is None:
            return None
        if isinstance(a, torch.Tensor) and placement_of(a) is not None:
            return a
        axes = tuple(axes)
        n = self.size(axes)
        b = int(a.shape[dim])
        if b % n:
            raise ValueError(f"batch of {b} rows does not split over "
                             f"{'x'.join(axes)} of {n} (pad it first)")
        r = self.index_over(axes)
        c = b // n
        idx = tuple(slice(r * c, (r + 1) * c) if d == dim else slice(None)
                    for d in range(np.ndim(a)))
        piece = a[idx]
        if not isinstance(piece, torch.Tensor):
            piece = torch.from_numpy(np.ascontiguousarray(piece))
        t = piece.to(self.device)
        return set_placement(t, Placement(a.shape, dim, n, r, axes))

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

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole array of a placed tensor: its pieces all-gathered
        over its split axes (the minor axis first; a collective every
        rank of those lines enters); an untagged tensor as it is."""
        from deeplearning4j_tpu_torch.parallel import collectives
        p = placement_of(t)
        if p is None:
            return t
        piece = t.detach()
        short = p.chunk() - piece.shape[p.dim] if p.groups == 1 else 0
        if short:       # an uneven split: every rank gathers a whole chunk
            pad = list(piece.shape)
            pad[p.dim] = short
            piece = torch.cat([piece, piece.new_zeros(pad)], dim=p.dim)
        pieces = piece.contiguous().unsqueeze(0)
        for a in reversed(p.axes):
            g = collectives.all_gather(pieces, self.group(a))
            pieces = g.reshape((-1,) + tuple(pieces.shape[1:]))
        return assemble(pieces, p)

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
        """Apply the rules to a flat ``{name: array}`` dict: each value
        placed per its spec (:func:`place_by_spec`): this rank's piece of
        a dim a rule splits over any mesh axes, tagged; whole where no
        rule splits it."""
        out = {}
        for name, arr in named_params.items():
            t = arr if isinstance(arr, torch.Tensor) \
                else torch.as_tensor(np.asarray(arr))
            out[name] = place_by_spec(mesh, t, self.spec_for(name, t.dim()))
        return out


def _entry_axes(e) -> Tuple[str, ...]:
    if e is None:
        return ()
    return tuple(e) if isinstance(e, (tuple, list)) else (e,)


def split_of(mesh: DeviceMesh, spec: Tuple, what: str
             ) -> Optional[Tuple[int, Tuple[str, ...]]]:
    """``(dim, axes)``: the dim a spec splits and the mesh axes of size
    above 1 that split it (None when it splits nothing here). An axis the
    mesh does not name raises; so does a spec splitting two dims."""
    found = None
    for d, e in enumerate(spec or ()):
        axes = []
        for a in _entry_axes(e):
            if a not in mesh.shape:
                raise ValueError(f"{what}: {a!r} is not a mesh axis "
                                 f"{mesh.axis_names}")
            if mesh.size(a) > 1:
                axes.append(a)
        if not axes:
            continue
        if found is not None:
            raise ValueError(f"{what}: spec {tuple(spec)} splits dims "
                             f"{found[0]} and {d}; a tensor splits along "
                             "one dim (name both axes on it instead)")
        found = (d, tuple(axes))
    return found


def placement_for(mesh: DeviceMesh, shape, spec: Tuple,
                  what: str = "sharding rule", groups: int = 1
                  ) -> Optional[Placement]:
    """This rank's :class:`Placement` of an array of ``shape`` under
    ``spec`` (None: whole)."""
    sp = split_of(mesh, spec, what)
    if sp is None:
        return None
    dim, axes = sp
    n = mesh.size(axes)
    even = groups > 1 or axes == ("data",)
    if shape[dim] < n or (even and shape[dim] % (n * groups)):
        raise ValueError(f"{what}: dim {dim} ({shape[dim]}) does not split "
                         f"over {'x'.join(axes)} of {n}")
    return Placement(shape, dim, n, mesh.index_over(axes), axes, groups)


def place_by_spec(mesh: DeviceMesh, t: torch.Tensor, spec: Tuple,
                  groups: int = 1):
    """``t`` (a global value, the same on every rank) placed per
    ``spec``: whole on this rank's device, or this rank's piece of the
    dim ``spec`` splits (over one axis or the product of several)."""
    p = placement_for(mesh, tuple(t.shape), spec, groups=groups)
    if p is None:
        return t.to(mesh.device)
    return set_placement(local_piece(t, p).contiguous().to(mesh.device), p)
