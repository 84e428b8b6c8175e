"""ZeRO-style sharded updater state — the port of
``deeplearning4j_tpu/distributed/zero.py``.

The weight update is element-wise in the gradient and the updater state,
so each data rank can keep 1/n of every large moment tensor and update
only its 1/n of the parameter ("Automatic Cross-Replica Sharding of
Weight Update in Data-Parallel Training", PAPERS.md): the step reduces
the gradient as plain data parallelism does, each rank applies the
updater to its piece of (gradient, state, parameter), and the new
pieces are all-gathered into the full parameter (one flat all-gather a
step, ``nn.network``). The math is the replicated update's, element for
element.

:class:`ZeroPlan` declares the axis and the minimum tensor size worth
sharding; :meth:`ZeroPlan.state_spec` picks the first unsharded dim the
axis divides (the JAX package's rule). A rank's state tensors are its
pieces, tagged with their :class:`~deeplearning4j_tpu_torch.parallel.
mesh.Placement`; :func:`updater_hbm_bytes` measures what a rank holds
(the ``dl4j_updater_hbm_bytes{device}`` gauge) and
:func:`gather_opt_state` all-gathers full host copies.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch import profiler as _prof
from deeplearning4j_tpu_torch.parallel.mesh import placement_of

#: below this many bytes a state tensor stays with its param's sharding —
#: sharding tiny tensors buys nothing and costs collective latency
DEFAULT_MIN_BYTES = 65536

UPDATER_HBM = _prof.get_registry().gauge(
    "dl4j_updater_hbm_bytes",
    "Updater (optimizer) state bytes resident per device, measured from "
    "the tensors this rank holds",
    labelnames=("device",))


class ZeroPlan:
    """Declaration of cross-replica updater-state sharding.

    ``axis``: the mesh axis to partition state tensors over (the data
    axis — each data rank keeps 1/n of every moment tensor).
    ``min_bytes``: tensors smaller than this keep their parameter's
    sharding (default 64 KiB).
    """

    def __init__(self, axis: str = "data",
                 min_bytes: int = DEFAULT_MIN_BYTES):
        self.axis = str(axis)
        self.min_bytes = int(min_bytes)

    @staticmethod
    def coerce(obj) -> Optional["ZeroPlan"]:
        """ZeroPlan | True (defaults) | an axis name | {"axis", "min_bytes"}"""
        if obj is None or isinstance(obj, ZeroPlan):
            return obj
        if obj is True:
            return ZeroPlan()
        if obj is False:
            return None
        if isinstance(obj, str):
            return ZeroPlan(axis=obj)
        if isinstance(obj, dict):
            return ZeroPlan(**obj)
        raise TypeError(f"cannot interpret {obj!r} as a ZeRO plan "
                        "(use ZeroPlan, True, an axis name, or a dict)")

    def signature(self):
        return ("zero", self.axis, self.min_bytes)

    def declare(self) -> Dict:
        """The mirror for the static analyzer (``MeshSpec(zero=...)``)."""
        return {"axis": self.axis, "min_bytes": self.min_bytes}

    def state_spec(self, param_spec, shape, itemsize: int,
                   n_axis: int) -> Tuple:
        """The spec of one param-shaped state tensor: the param's own spec
        with ``self.axis`` at the first unsharded dim the axis divides.
        Tensors below ``min_bytes``, or with no divisible free dim, keep
        the param spec; a param already sharded over the axis (FSDP
        style) passes its spec on."""
        shape = tuple(int(d) for d in shape)
        entries = list(tuple(param_spec) if param_spec is not None else ())
        entries += [None] * (len(shape) - len(entries))
        nbytes = int(np.prod(shape)) * itemsize if shape else itemsize
        if n_axis <= 1 or nbytes < self.min_bytes:
            return tuple(entries)
        used = {a for e in entries if e is not None
                for a in (e if isinstance(e, (tuple, list)) else (e,))}
        if self.axis in used:
            return tuple(entries)
        for d, e in enumerate(entries):
            if e is None and shape[d] >= n_axis and shape[d] % n_axis == 0:
                entries[d] = self.axis
                return tuple(entries)
        return tuple(param_spec) if param_spec is not None else ()

    def __repr__(self):
        return f"ZeroPlan(axis={self.axis!r}, min_bytes={self.min_bytes})"


def _tensor_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensor_leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def updater_hbm_bytes(opt_state, record: bool = True) -> Dict[str, int]:
    """Measured updater-state residency of THIS rank: ``{device: bytes}``
    over every state tensor it holds (a replicated tensor counts whole on
    every rank; a ZeRO piece counts its own bytes). ``record=True`` also
    publishes ``dl4j_updater_hbm_bytes{device}``."""
    per_device: Dict[str, int] = {}
    for t in _tensor_leaves(opt_state):
        key = str(t.device)
        per_device[key] = per_device.get(key, 0) + \
            t.numel() * t.element_size()
    if record:
        for dev, nbytes in per_device.items():
            UPDATER_HBM.labels(device=dev).set(float(nbytes))
    return per_device


def full_value(t: torch.Tensor, group=None) -> torch.Tensor:
    """The full value of a (possibly ZeRO-sharded) tensor: a piece is
    all-gathered over ``group`` (the data group; a collective every rank
    of it must enter), an untagged tensor is returned as it is."""
    import torch.distributed as dist
    from deeplearning4j_tpu_torch.parallel import collectives
    p = placement_of(t)
    if p is None:
        return t
    if group is None and dist.is_initialized():
        group = dist.group.WORLD
    pieces = collectives.all_gather(t.detach(), group)
    return torch.cat(list(pieces.unbind(0)), dim=p.dim)


def gather_opt_state(opt_state, group=None):
    """The all-gather-on-demand seam: full host (numpy) copies of every
    state tensor, whatever its sharding (a collective over ``group``,
    the data group of the plan that sharded it — the default group
    unless named — when any is sharded)."""
    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        if isinstance(tree, torch.Tensor):
            return full_value(tree, group).detach().cpu().numpy()
        return tree
    return walk(opt_state)
