"""The port's collectives: every cross-rank operation of the data-
parallel path goes through this module, over one mesh axis's process
group (``DeviceMesh.group(axis)``).

- :func:`all_reduce`, :func:`all_gather`, :func:`reduce_scatter`,
  :func:`broadcast`, :func:`ppermute` (the neighbour exchange of JAX's
  ``lax.ppermute``):
  ``torch.distributed`` calls on a group; without a group they are the
  identity and issue nothing (a group of one rank still issues them:
  NCCL makes its communicator, a capture records them). Each call
  records its kind and bytes (:func:`record`), the measured counterpart
  of the JAX package's ``hlo_collective_bytes`` over a compiled step.
- gloo with a CUDA tensor: the tensor is staged through pinned host
  memory, the collective runs on the host copy and the result is copied
  back (counted in ``HOST_STAGED``); NCCL takes card tensors directly.
- :class:`DataParallelStep`: one train step's data-parallel facts,
  which the networks' step hands down explicitly when a sharding plan
  is attached: :meth:`~DataParallelStep.key` puts the rank's global row
  offset (the dropout and noise hashes index from it) and the sync-BN
  moment reducer (:meth:`~DataParallelStep.sync_moments`: the global
  batch's statistics, as the JAX step sees them) on the step's
  ``StepKey``; :meth:`~DataParallelStep.scale_loss` weighs a rank's loss
  by its share of the global count of real rows; ``regularize`` adds
  the L1/L2 term on data rank 0 only (the gradients are summed).
- Differentiable forms for the tensor, sequence and pipeline axes:
  :func:`all_reduce_sum_grad` (backward: the sum of the gradients),
  :func:`ppermute_grad` (backward: the reverse shift) and
  :func:`all_gather_grad` along a dim (backward: a reduce-scatter). They
  follow one convention: the objective is the sum of the ranks' own
  objectives, so a rank whose loss every rank of a group computes alike
  divides it by the group's size.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.profiler.metrics import get_registry

HOST_STAGED = get_registry().counter(
    "dl4j_collective_host_staged_total",
    "Collectives on card tensors staged through pinned host memory "
    "(gloo takes no card tensors)")
COLLECTIVE_BYTES = get_registry().counter(
    "dl4j_collective_bytes_total",
    "Bytes handed to collectives by this rank, by kind",
    labelnames=("kind",))

_local = threading.local()


# ----------------------------------------------------------- recording
class _Record:
    def __init__(self):
        self.bytes: Dict[str, int] = {}
        self.calls: Dict[str, int] = {}


@contextmanager
def record():
    """Collect ``{kind: bytes}`` of every collective this thread issues
    inside the block (``.bytes``; ``.calls`` counts them). Kinds are the
    JAX package's HLO names: ``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``collective-permute``; bytes are each call's
    output tensor bytes on this rank."""
    rec = _Record()
    stack = getattr(_local, "records", None)
    if stack is None:
        stack = _local.records = []
    stack.append(rec)
    try:
        yield rec
    finally:
        stack.remove(rec)


def _note(kind: str, nbytes: int) -> None:
    COLLECTIVE_BYTES.labels(kind=kind).inc(nbytes)
    for rec in getattr(_local, "records", None) or ():
        rec.bytes[kind] = rec.bytes.get(kind, 0) + int(nbytes)
        rec.calls[kind] = rec.calls.get(kind, 0) + 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def group_size(group) -> int:
    if group is None or not dist.is_initialized():
        return 1
    return dist.get_world_size(group)


def _skip(group) -> bool:
    """No group (a one-rank mesh without torch.distributed): collectives
    are the identity. A group of one rank still issues them (NCCL's
    communicator is made, and a captured step records them)."""
    return group is None or not dist.is_initialized()


def group_rank(group) -> int:
    if group is None or not dist.is_initialized():
        return 0
    return dist.get_rank(group)


def _staged(group, t: torch.Tensor) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def stages_on_host(group, t: torch.Tensor) -> bool:
    """Whether a collective over ``group`` on ``t`` goes through pinned
    host memory (gloo with a card tensor): a step that issues one is not
    captured."""
    return not _skip(group) and _staged(group, t)


def _host(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    HOST_STAGED.inc()
    return h


# ----------------------------------------------------------- collectives
def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place; returns ``t``."""
    if _skip(group):
        return t
    _note("all-reduce", _nbytes(t))
    if _staged(group, t):
        h = _host(t)
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``[n, *t.shape]``: every rank's ``t``, in group-rank order."""
    if _skip(group):
        return t.unsqueeze(0)
    n = group_size(group)
    _note("all-gather", _nbytes(t) * n)
    src = t.contiguous()
    if _staged(group, src):
        src = _host(src)
        out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype)
        dist.all_gather(list(out.unbind(0)), src, group=group)
        return out.to(t.device)
    out = torch.empty(n * t.numel(), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, src.reshape(-1), group=group)
    return out.view((n,) + tuple(t.shape))


def reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` of ``[n, *s]`` summed over ``group``; this rank gets its row
    of the sum (``[*s]``), ``n`` the group's size."""
    if _skip(group):
        return t[0]
    n = group_size(group)
    _note("reduce-scatter", _nbytes(t) // n)
    src = t.contiguous()
    if _staged(group, src):
        src = _host(src)
    out = torch.empty(t[0].numel(), dtype=t.dtype, device=src.device)
    dist.reduce_scatter_tensor(out, src.reshape(-1), group=group)
    return out.to(t.device).view(tuple(t.shape[1:]))


def broadcast(t: torch.Tensor, group, src_rank: int = 0) -> torch.Tensor:
    """``t`` from group rank ``src_rank`` to every rank, in place."""
    if _skip(group):
        return t
    _note("collective-permute", _nbytes(t))
    src = dist.get_global_rank(group, src_rank)
    if _staged(group, t):
        h = _host(t)
        dist.broadcast(h, src, group=group)
        t.copy_(h)
    else:
        dist.broadcast(t, src, group=group)
    return t


def _peers(group, shift: int, wrap: bool):
    """``(dst, src)``: the global ranks this rank sends to and receives
    from under a shift of ``shift`` along ``group`` (None where a rank
    has no partner: the ends of an unwrapped line)."""
    n, r = group_size(group), group_rank(group)
    d, s = r + shift, r - shift
    if wrap:
        d, s = d % n, s % n
    dst = dist.get_global_rank(group, d) if 0 <= d < n else None
    src = dist.get_global_rank(group, s) if 0 <= s < n else None
    return dst, src


def ppermute(t: torch.Tensor, group, shift: int = 1,
             wrap: bool = True) -> torch.Tensor:
    """JAX's ``lax.ppermute`` along ``group``: group rank ``r`` sends
    ``t`` to rank ``r + shift`` and returns what rank ``r - shift`` sent
    (modulo the group's size under ``wrap``, the ring; without it a rank
    with no source receives zeros, as in JAX). Built from ``isend`` and
    ``irecv``; under gloo a card tensor is staged through pinned host
    memory. Recorded as ``collective-permute``."""
    n = group_size(group)
    if n == 1 or _skip(group):
        return t.clone() if wrap or shift == 0 else torch.zeros_like(t)
    dst, src = _peers(group, shift, wrap)
    src_t = t.contiguous()
    staged = _staged(group, src_t)
    if staged:
        src_t = _host(src_t)
    out = torch.empty(src_t.shape, dtype=t.dtype, device=src_t.device,
                      pin_memory=staged)
    ops = []
    if dst is not None:
        _note("collective-permute", _nbytes(t))
        ops.append(dist.P2POp(dist.isend, src_t, dst, group))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, out, src, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if src is None:
        return torch.zeros_like(t)
    return out.to(t.device, non_blocking=False) if staged else out


class _PPermute(torch.autograd.Function):
    """:func:`ppermute` whose backward sends each gradient back the way
    its value came: the same exchange with ``-shift``."""

    @staticmethod
    def forward(ctx, x, group, shift, wrap):
        ctx.group, ctx.shift, ctx.wrap = group, shift, wrap
        return ppermute(x, group, shift, wrap)

    @staticmethod
    def backward(ctx, g):
        return ppermute(g.contiguous(), ctx.group, -ctx.shift,
                        ctx.wrap), None, None, None


def ppermute_grad(x: torch.Tensor, group, shift: int = 1,
                  wrap: bool = True) -> torch.Tensor:
    """Differentiable :func:`ppermute` (backward: the reverse shift)."""
    return _PPermute.apply(x, group, int(shift), bool(wrap))


class _AllGatherDim(torch.autograd.Function):
    """Every rank's ``x`` joined along ``dim`` in group-rank order; the
    backward sums the incoming gradients over the group and hands each
    rank its own piece (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        parts = all_gather(x.contiguous(), group)
        return torch.cat(list(parts.unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        n = group_size(ctx.group)
        rows = torch.stack([c.contiguous()
                            for c in g.chunk(n, dim=ctx.dim)])
        return reduce_scatter(rows, ctx.group), None, None


def all_gather_grad(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Differentiable all-gather of ``x`` along ``dim`` (backward: a
    reduce-scatter of the gradient)."""
    if _skip(group):
        return x
    return _AllGatherDim.apply(x, group, dim % x.dim())


class _AllReduceSum(torch.autograd.Function):
    """A sum over the group whose backward is the sum of the incoming
    gradients over the group: the gradient of a quantity every rank
    shares (the global batch moments) reaches each rank's inputs."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


def all_reduce_sum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``group`` (see
    :class:`_AllReduceSum`)."""
    if _skip(group):
        return x
    return _AllReduceSum.apply(x, group)


# ----------------------------------------------------- the step context
def _denominator(layer, labels, mask) -> torch.Tensor:
    """The count a loss layer's mean divides by: the examples, or under a
    label mask the examples with any active entry (``ops.losses._reduce``);
    a layer with its own ``compute_loss`` divides by the examples."""
    from deeplearning4j_tpu_torch.nn import layers as L
    n = labels.shape[0]
    own = type(layer).compute_loss is not L.BaseOutputLayer.compute_loss
    if mask is None or own:
        return torch.full((), float(n), dtype=torch.float32,
                          device=labels.device)
    active = (mask.reshape(n, -1) != 0).any(dim=1)
    return active.sum().to(torch.float32)


class DataParallelStep:
    """The data-parallel facts of one train step on one rank: the data
    group, this rank's place in it and its batch rows. The networks'
    step makes one when a sharding plan is attached and hands it down:
    to the layers on the step's key (:meth:`key`), to the loss
    (:meth:`scale_loss`, ``regularize``)."""

    __slots__ = ("group", "rank", "size", "rows")

    def __init__(self, group, rows: int):
        self.group = group
        self.rank = group_rank(group)
        self.size = group_size(group)
        self.rows = int(rows)

    @property
    def row_offset(self) -> int:
        """This rank's first row in the global batch."""
        return self.rank * self.rows

    @property
    def regularize(self) -> bool:
        """True on data rank 0 only: the L1/L2 term enters the summed
        gradient once."""
        return self.rank == 0

    def key(self, seed: int, t):
        """The step's ``StepKey`` with this rank's row offset and the
        sync-BN reducer (None on one rank without a group)."""
        from deeplearning4j_tpu_torch.ops.normalization import StepKey
        return StepKey(seed, t, rows=self.row_offset,
                       sync=None if _skip(self.group) else self.sync_moments)

    def sync_moments(self, m: torch.Tensor, m2: torch.Tensor):
        """Sync BN: a rank's ``(E[x], E[x^2])`` over its rows -> the
        global batch's (every rank holds the same number of rows, so the
        global moment is the mean of the ranks'); differentiable."""
        both = torch.cat([m.reshape(-1), m2.reshape(-1)]) * (1.0 / self.size)
        both = all_reduce_sum_grad(both, self.group)
        n = m.numel()
        return both[:n].reshape(m.shape), both[n:].reshape(m2.shape)

    def scale_loss(self, layer, loss, labels, mask):
        """A rank's share of the global mean loss: its loss times its
        count of real rows over the global count (all-reduced), so that
        the sum over ranks of the scaled losses (and of their gradients)
        is the loss of the whole batch, whatever rows each rank holds. On
        one rank the factor is exactly 1."""
        d = _denominator(layer, labels, mask)
        total = all_reduce(d.clone(), self.group)
        return loss * (d / torch.clamp_min(total, 1.0))


def flat_all_reduce(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """Sum a list of tensors over ``group`` as one flat buffer a dtype
    (one collective each); returns the reduced tensors."""
    if _skip(group):
        return list(tensors)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        all_reduce(flat, group)
        pos = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[pos:pos + n].view(tensors[i].shape)
            pos += n
    return out


def flat_all_gather(pieces: List[Tuple[torch.Tensor, int]], group
                    ) -> List[torch.Tensor]:
    """``[(piece, dim)]`` -> each whole tensor, the ranks' pieces joined
    along ``dim`` in group-rank order (one flat all-gather a dtype)."""
    out: List[Optional[torch.Tensor]] = [None] * len(pieces)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, (t, _) in enumerate(pieces):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([pieces[i][0].detach().reshape(-1) for i in idx])
        gathered = all_gather(flat, group)
        pos = 0
        for i in idx:
            t, dim = pieces[i]
            m = t.numel()
            parts = gathered[:, pos:pos + m].reshape(
                (gathered.shape[0],) + tuple(t.shape))
            out[i] = torch.cat(list(parts.unbind(0)), dim=dim)
            pos += m
    return out


def flat_reduce_scatter(tensors: List[Tuple[torch.Tensor, int]], group
                        ) -> List[torch.Tensor]:
    """``[(whole, dim)]`` -> this rank's piece along ``dim`` of each
    tensor summed over ``group`` (one flat reduce-scatter a dtype)."""
    n = group_size(group)
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, (t, _) in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        chunks = [[c.reshape(-1) for c in t.chunk(n, dim=dim)]
                  for t, dim in (tensors[i] for i in idx)]
        rows = torch.stack([torch.cat([ch[r] for ch in chunks])
                            for r in range(n)])
        mine = reduce_scatter(rows, group)
        pos = 0
        for i in idx:
            t, dim = tensors[i]
            shape = list(t.shape)
            shape[dim] //= n
            m = t.numel() // n
            out[i] = mine[pos:pos + m].view(shape)
            pos += m
    return out
