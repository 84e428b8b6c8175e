"""Rank processes on one host: :class:`RankPool` starts ``world``
processes with the ``spawn`` method (a fresh interpreter each: safe from
a parent that holds a CUDA context), wires them into one process group
(``initializeDistributed`` over a shared-file store, so no port is
fixed) and runs functions on them.

    with RankPool(2, tmp, device="cpu") as pool:  # the CPU: gloo
        results = pool.run(train_fn, cfg)    # [rank 0's, rank 1's]

Without ``device=`` the ranks take the card (rank r on card ``r %
cards``), as every entry point of the port does; without a card that
raises unless ``device="cpu"`` is passed.

``fn(*args)`` must be importable by name (a module-level function of an
importable module: the children import it); it runs in every rank (or
``ranks=``) and its return value comes back pickled. An exception in a
rank is raised in the parent as :class:`RankError`; a rank whose
process exits mid-task (``os._exit``, a crash) reads as ``None`` when
``allow_exit`` names it, else raises. Each rank calls
``torch.set_num_threads(threads)``; every group waits ``timeout``
seconds on a collective. :meth:`RankPool.regroup` puts every live rank
back into one fresh group of the whole pool (after a task shrank the
group, say).
"""

from __future__ import annotations

import importlib
import multiprocessing as mp
import os
import sys
import traceback
from typing import Iterable, List, Optional


class RankError(RuntimeError):
    """A task raised in a rank: ``rank`` and the remote ``trace``."""

    def __init__(self, rank: int, trace: str):
        self.rank, self.trace = rank, trace
        super().__init__(f"rank {rank} failed:\n{trace}")


def _resolve(ref: str):
    mod, _, name = ref.partition(":")
    obj = importlib.import_module(mod)
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _rank_main(rank: int, world: int, address: str, device: str,
               backend: Optional[str], timeout: float, threads: int,
               paths: List[str], env: dict, conn) -> None:
    os.environ.update(env)
    for p in reversed(paths):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    torch.set_num_threads(threads)
    from deeplearning4j_tpu_torch.parallel.init import (initializeDistributed,
                                                        shutdownDistributed)
    dev = device
    if device.startswith("cuda") and ":" not in device:
        dev = f"cuda:{rank % max(torch.cuda.device_count(), 1)}"

    def join(addr):
        try:
            shutdownDistributed()
            initializeDistributed(addr, world, rank, device=dev,
                                  backend=backend, timeout=timeout)
            conn.send(("ready", None))
            return True
        except BaseException:
            conn.send(("error", traceback.format_exc()))
            return False
    if not join(address):
        return
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            return
        if msg is None:
            break
        if msg[0] == "regroup":
            if not join(msg[1]):
                return
            continue
        ref, path, args, kwargs = msg
        if path and path not in sys.path:
            sys.path.append(path)
        try:
            out = _resolve(ref)(*args, **kwargs)
            conn.send(("ok", out))
        except BaseException:
            conn.send(("error", traceback.format_exc()))
    from deeplearning4j_tpu_torch.parallel.init import shutdownDistributed
    shutdownDistributed()
    conn.close()


def _ref(fn) -> str:
    mod = fn.__module__
    if mod == "__main__":
        # a script's functions: import the script by its module name
        path = getattr(sys.modules["__main__"], "__file__", None)
        if path is None:
            raise ValueError("RankPool: functions of an interactive "
                             "__main__ cannot be imported by the ranks")
        mod = os.path.splitext(os.path.basename(path))[0]
    return f"{mod}:{fn.__qualname__}"


def _module_dir(fn) -> Optional[str]:
    mod = sys.modules.get(fn.__module__)
    path = getattr(mod, "__file__", None)
    return os.path.dirname(os.path.abspath(path)) if path else None


class RankPool:
    """``world`` spawned rank processes in one group (see the module
    note). ``device``: ``"cuda"`` (the default: rank r on card ``r %
    cards``; NCCL unless ``backend=`` says otherwise — two ranks on one
    card need ``backend="gloo"``) or ``"cpu"`` (gloo). Without a card
    the default raises before any rank starts."""

    def __init__(self, world: int, store_dir: str, device: str = None,
                 backend: Optional[str] = None, timeout: float = 120.0,
                 threads: int = 1, env: Optional[dict] = None,
                 start_timeout: float = 120.0):
        if device is None:
            from deeplearning4j_tpu_torch.device import resolve_device
            device = str(resolve_device(None))   # the card, or raise
        self.world = int(world)
        os.makedirs(store_dir, exist_ok=True)
        self._store_dir = store_dir
        self._groups = 0
        self.address = self._new_address()
        ctx = mp.get_context("spawn")
        paths = [os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))] + list(sys.path)
        self._conns, self._procs = [], []
        for r in range(self.world):
            parent, child = ctx.Pipe()
            proc = ctx.Process(
                target=_rank_main, daemon=True,
                args=(r, self.world, self.address, device, backend,
                      float(timeout), int(threads), paths,
                      dict(env or {}), child))
            proc.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(proc)
        self.alive = set(range(self.world))
        self._await_ready(start_timeout)

    def _new_address(self) -> str:
        self._groups += 1
        store = os.path.join(self._store_dir, f"store_{os.getpid()}_"
                             f"{id(self)}_{self._groups}")
        if os.path.exists(store):
            os.remove(store)
        return "file://" + store

    def _await_ready(self, timeout: float) -> None:
        for r in sorted(self.alive):
            conn = self._conns[r]
            if not conn.poll(timeout):
                self.close()
                raise RuntimeError(f"rank {r} did not join within "
                                   f"{timeout}s")
            kind, payload = conn.recv()
            if kind != "ready":
                self.close()
                raise RankError(r, payload)

    def regroup(self, timeout: float = 120.0) -> None:
        """Every rank leaves its group and joins a fresh one of the whole
        pool (a new store): the pool is as it started, whatever group a
        task left behind. Every rank must still be alive."""
        if self.alive != set(range(self.world)):
            raise RuntimeError(f"regroup: ranks "
                               f"{sorted(set(range(self.world)) - self.alive)}"
                               " have exited")
        self.address = self._new_address()
        for conn in self._conns:
            conn.send(("regroup", self.address))
        self._await_ready(timeout)

    def run(self, fn, *args, ranks: Iterable[int] = None,
            allow_exit: Iterable[int] = (), timeout: float = 600.0,
            **kwargs) -> List:
        """``fn(*args, **kwargs)`` on each rank of ``ranks`` (default: all
        live ones); returns the results in rank order (``None`` for a
        rank of ``allow_exit`` whose process exited)."""
        ranks = sorted(self.alive if ranks is None else ranks)
        allow_exit = set(allow_exit)
        path, ref = _module_dir(fn), _ref(fn)
        for r in ranks:
            self._conns[r].send((ref, path, args, kwargs))
        out = {}
        errors = []
        for r in ranks:
            conn = self._conns[r]
            try:
                if not conn.poll(timeout):
                    errors.append(RankError(r, f"no reply in {timeout}s"))
                    continue
                kind, payload = conn.recv()
            except (EOFError, ConnectionResetError, BrokenPipeError):
                self._procs[r].join(5.0)
                self.alive.discard(r)
                if r in allow_exit:
                    out[r] = None
                    continue
                errors.append(RankError(
                    r, f"process exited (code {self._procs[r].exitcode})"))
                continue
            if kind == "ok":
                out[r] = payload
            else:
                errors.append(RankError(r, payload))
        if errors:
            raise errors[0]
        return [out.get(r) for r in ranks]

    def close(self) -> None:
        for r, conn in enumerate(self._conns):
            if r in self.alive:
                try:
                    conn.send(None)
                except (OSError, BrokenPipeError):
                    pass
        for p in self._procs:
            p.join(10.0)
            if p.is_alive():
                p.kill()
                p.join(5.0)
        for conn in self._conns:
            conn.close()
        self.alive = set()

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc):
        self.close()
