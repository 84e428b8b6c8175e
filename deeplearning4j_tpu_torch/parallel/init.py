"""Multi-process initialization — the port of
``deeplearning4j_tpu/parallel/init.py``.

One process a rank and one device a rank: ``initializeDistributed``
wires the processes into one ``torch.distributed`` default process
group (NCCL when the rank's device is a card, gloo when it is the CPU),
sets the rank's card as the current one (so ``resolve_device(None)`` is
the rank's own card) and keeps the group's store, from which
:func:`reform_group` builds a smaller group among survivors after a
rank's death (``parallel.elastic``).

Environment-variable driven, as in the JAX package:

- ``DL4J_TPU_COORDINATOR``   — ``host:port`` of rank 0's store (a
  ``file:///path`` address uses a shared-file store instead)
- ``DL4J_TPU_NUM_PROCESSES`` — world size
- ``DL4J_TPU_PROCESS_ID``    — this process's rank

Nothing quietly degrades a configured multi-process job to one process:
with no coordinator configured, a world size above 1 (here or in the
launcher's ``WORLD_SIZE``) raises.
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

#: seconds every process group waits on a collective before it fails
#: (a dead peer fails the caller instead of stalling it)
DEFAULT_TIMEOUT_S = 300.0


@dataclass
class DistributedInfo:
    process_index: int
    process_count: int
    local_device_count: int
    global_device_count: int
    coordinator: Optional[str]
    backend: Optional[str] = None
    device: str = "cpu"


_initialized: Optional[DistributedInfo] = None
_store = None            # the base store, kept for reform_group
_generation = 0          # groups formed on it so far
#: each current rank's member id: its rank in the first group, which
#: stays its identity (a FaultPlan's, a coordinator's) across reforms
_members: List[int] = [0]


def _make_store(address: str, world: int, rank: int, timeout_s: float):
    if address.startswith("file://"):
        return dist.FileStore(address[len("file://"):], world)
    if address.startswith("tcp://"):
        address = address[len("tcp://"):]
    host, _, port = address.rpartition(":")
    return dist.TCPStore(host or "127.0.0.1", int(port), world,
                         is_master=(rank == 0),
                         timeout=datetime.timedelta(seconds=timeout_s))


def initializeDistributed(coordinator_address: str = None,
                          num_processes: int = None,
                          process_id: int = None,
                          local_device_ids: Sequence[int] = None, *,
                          device=None, backend: str = None,
                          timeout: float = DEFAULT_TIMEOUT_S
                          ) -> DistributedInfo:
    """ref: the SharedTrainingMaster bootstrap, collapsed to one call.

    Pass (or set through the ``DL4J_TPU_*`` variables) the coordinator
    address, the world size and this process's rank. The rank's device
    is ``cuda:<local rank>`` (``local_device_ids[0]``, else the rank
    modulo the visible cards) unless ``device="cpu"``; the backend is
    NCCL on a card and gloo on the CPU unless ``backend=`` names one.
    Every group waits ``timeout`` seconds on a collective. With nothing
    configured the process runs alone (world 1, no group). Idempotent
    per process."""
    global _initialized, _store, _generation, _members
    if _initialized is not None:
        return _initialized
    coordinator_address = coordinator_address or os.environ.get(
        "DL4J_TPU_COORDINATOR")
    if num_processes is None and "DL4J_TPU_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["DL4J_TPU_NUM_PROCESSES"])
    if process_id is None and "DL4J_TPU_PROCESS_ID" in os.environ:
        process_id = int(os.environ["DL4J_TPU_PROCESS_ID"])
    dev = torch.device("cuda" if device is None else device)
    if coordinator_address is None:
        launcher_world = int(os.environ.get("WORLD_SIZE", "1") or 1)
        if (num_processes or 1) > 1 or launcher_world > 1:
            # a configured multi-process job must not degrade silently to
            # isolated single-process training (wrong gradients)
            raise RuntimeError(
                "initializeDistributed: a world size above 1 is configured "
                "but no coordinator address (DL4J_TPU_COORDINATOR)")
        _initialized = DistributedInfo(0, 1, 1, 1, None, None,
                                       str(dev) if dev.type == "cpu"
                                       else "cuda")
        return _initialized
    world = int(num_processes if num_processes is not None else 1)
    rank = int(process_id if process_id is not None else 0)
    if dev.type == "cuda":
        local = int(local_device_ids[0]) if local_device_ids \
            else (dev.index if dev.index is not None
                  else rank % max(torch.cuda.device_count(), 1))
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    _store = _make_store(coordinator_address, world, rank, timeout)
    _generation = 0
    _members = list(range(world))
    dist.init_process_group(backend, store=_store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    _initialized = DistributedInfo(
        process_index=rank, process_count=world, local_device_count=1,
        global_device_count=world, coordinator=coordinator_address,
        backend=backend, device=str(dev))
    return _initialized


def reform_group(survivors: Sequence[int],
                 timeout: float = DEFAULT_TIMEOUT_S) -> DistributedInfo:
    """Replace the default group by one among ``survivors`` (their ranks
    in the current group, this process's among them): the old group is
    torn down, the new one forms on the same store under a fresh key
    prefix, and the survivors are renumbered in order. Every survivor
    calls it with the same list (their member ids stay theirs:
    :func:`member_id`)."""
    global _initialized, _generation, _members
    info = _initialized
    if info is None or _store is None:
        raise RuntimeError("reform_group: no process group to reform")
    survivors = [int(r) for r in survivors]
    if info.process_index not in survivors:
        raise RuntimeError(f"reform_group: rank {info.process_index} is "
                           f"not among the survivors {survivors}")
    new_rank = survivors.index(info.process_index)
    backend = info.backend
    if dist.is_initialized():
        dist.destroy_process_group()
    _generation += 1
    store = dist.PrefixStore(f"dl4j_group{_generation}/", _store)
    dist.init_process_group(backend, store=store, rank=new_rank,
                            world_size=len(survivors),
                            timeout=datetime.timedelta(seconds=timeout))
    _members = [_members[r] for r in survivors]
    _initialized = DistributedInfo(
        process_index=new_rank, process_count=len(survivors),
        local_device_count=1, global_device_count=len(survivors),
        coordinator=info.coordinator, backend=backend, device=info.device)
    return _initialized


def shutdownDistributed():
    global _initialized, _store
    if _initialized is not None:
        if dist.is_initialized():
            try:
                dist.destroy_process_group()
            except Exception:
                pass
        _initialized = None
        _store = None


def distributed_info() -> Optional[DistributedInfo]:
    return _initialized


def member_id(rank: Optional[int] = None) -> int:
    """The member id of ``rank`` (this process's by default) in the
    current group: its rank in the group ``initializeDistributed``
    formed, kept across ``reform_group``."""
    if rank is None:
        rank = _initialized.process_index if _initialized else 0
    return _members[rank] if rank < len(_members) else rank


def rank_of_member(member: int) -> int:
    """The current rank of member id ``member``."""
    return _members.index(int(member))


def rank_device() -> torch.device:
    """This rank's device: the one ``initializeDistributed`` chose, else
    the default entry-point device (the card)."""
    info = _initialized
    if info is not None:
        return torch.device(info.device)
    return torch.device("cuda")
