"""Multi-rank sharded checkpointing — the port of
``deeplearning4j_tpu/parallel/checkpoint.py``, on the JAX package's
on-disk layout, so a checkpoint written by either package loads in the
other::

    <dir>/manifest.json                  (rank 0, merged)
    <dir>/shards_p<K>.npz                (rank K: the pieces it holds)

Every rank writes the pieces it holds (a ZeRO piece or a batch view,
tagged with its :class:`~deeplearning4j_tpu_torch.parallel.mesh.
Placement`), and rank 0 also what every rank holds alike (an untagged
tensor is written once globally); each piece is keyed by its global
index (``"0:4;0:8"``, :func:`_index_key`) and carries a SHA-256 in the
manifest. With more than one rank each writes a step-stamped
sub-manifest and rank 0 merges them atomically (:func:`_merge_manifests`).
Loading is the mirror: each rank reads only the pieces its target needs,
stitched from whatever pieces the checkpoint holds when the topology
changed (elastic shrink/grow), and fails loudly when they do not cover
the request.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Optional, Tuple
from zipfile import BadZipFile as zipfile_BadZipFile

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_tpu_torch.parallel.mesh import (Placement,
                                                    placement_for,
                                                    placement_of,
                                                    set_placement)
from deeplearning4j_tpu_torch.train.resilience import CorruptCheckpointError

# One deadline governs BOTH rank 0's sub-manifest merge and every reader's
# wait for the merged manifest — a shorter reader wait can race a
# legitimately slow merge.
MANIFEST_TIMEOUT_S = 60.0


def _rank() -> Tuple[int, int]:
    """(this rank, world size) of the default group (0, 1 without one)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _flatten(tree, prefix=(), seqs=(list, tuple)):
    """``[(name, leaf)]`` of a nest of dicts and ``seqs``: names are the
    JAX package's (``"params/0/W"``: dict keys and list indices joined
    by ``/``). A spec tree's tuples are leaves (``seqs=(list,)``)."""
    out = []
    if isinstance(tree, dict):
        for k, v in tree.items():
            out += _flatten(v, prefix + (str(k),), seqs)
    elif isinstance(tree, seqs):
        for i, v in enumerate(tree):
            out += _flatten(v, prefix + (str(i),), seqs)
    else:
        out.append(("/".join(prefix), tree))
    return out


def _unflatten(tree, values, prefix=()):
    if isinstance(tree, dict):
        return {k: _unflatten(v, values, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, values, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return values["/".join(prefix)]


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _index_key(index: Tuple[slice, ...], shape: Tuple[int, ...]) -> str:
    """Canonical key for a shard's global index: explicit starts/stops."""
    return ";".join(
        f"{s.start or 0}:{s.stop if s.stop is not None else dim}"
        for s, dim in zip(index, shape))



def save_sharded(directory: str, tree, step: int = 0):
    """Each rank writes the pieces it holds; rank 0 also the replicated
    leaves and the manifest. Barrier-free (the filesystem is the
    rendezvous: with more than one rank, rank 0's merge waits for every
    rank's sub-manifest of this step)."""
    os.makedirs(directory, exist_ok=True)
    pidx, pcount = _rank()
    local: Dict[str, np.ndarray] = {}
    manifest: Dict[str, Any] = {"step": step, "leaves": {}}
    for name, leaf in _flatten(tree):
        p = placement_of(leaf) if isinstance(leaf, torch.Tensor) else None
        data = _host(leaf)
        shape = p.global_shape if p is not None else tuple(data.shape)
        entry: Dict[str, Any] = {"shape": list(shape),
                                 "dtype": str(data.dtype), "shards": {}}
        if not isinstance(leaf, (torch.Tensor, np.ndarray)) \
                and np.ndim(leaf) == 0:
            # plain Python scalar leaf: restore with the original type
            entry["pytype"] = type(leaf).__name__
        if p is not None or pidx == 0:
            # a replicated leaf is written exactly once globally
            index = p.slices() if p is not None else \
                tuple(slice(0, s) for s in shape)
            key = _index_key(index, shape)
            local[f"{name}::{key}"] = data
            entry["shards"][key] = {"file": f"shards_p{pidx}.npz",
                                    "sha256": _shard_digest(data)}
        manifest["leaves"][name] = entry
    np.savez(os.path.join(directory, f"shards_p{pidx}.npz"), **local)
    if pcount > 1:
        _atomic_json(os.path.join(directory, f"manifest_p{pidx}.json"),
                     manifest)
        _merge_manifests(directory, step)
    else:
        import glob as _glob
        for stale in _glob.glob(os.path.join(directory, "manifest_p*.json")):
            try:
                os.remove(stale)
            except OSError:
                pass
        _atomic_json(os.path.join(directory, "manifest.json"), manifest)


def _shard_digest(data: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(data).tobytes()).hexdigest()



def _parse_key(key: str) -> Tuple[Tuple[int, int], ...]:
    """Inverse of :func:`_index_key`: ``"0:4;0:8"`` -> ((0, 4), (0, 8))."""
    return tuple(tuple(int(x) for x in part.split(":"))
                 for part in key.split(";"))



def _assemble_slice(name: str, entry: Dict[str, Any],
                    index: Tuple[slice, ...], shape: Tuple[int, ...],
                    shard_data) -> np.ndarray:
    """Stitch the requested global slice from whatever shards the
    checkpoint holds — the RESHARD path: a checkpoint saved under one
    mesh layout loads under another (elastic shrink: 8-way batch shards
    reassemble into 4 wider ones; grow: wide shards slice down). Raises
    FileNotFoundError when the saved shards don't cover the request."""
    want = tuple((s.start or 0, s.stop if s.stop is not None else dim)
                 for s, dim in zip(index, shape))
    out = np.empty(tuple(hi - lo for lo, hi in want),
                   dtype=np.dtype(entry["dtype"]))
    covered = 0
    for key in entry["shards"]:
        have = _parse_key(key)
        inter = tuple((max(wl, hl), min(wh, hh))
                      for (wl, wh), (hl, hh) in zip(want, have))
        if any(lo >= hi for lo, hi in inter):
            continue
        src = shard_data(name, key)
        src_idx = tuple(slice(lo - hl, hi - hl)
                        for (lo, hi), (hl, _hh) in zip(inter, have))
        dst_idx = tuple(slice(lo - wl, hi - wl)
                        for (lo, hi), (wl, _wh) in zip(inter, want))
        out[dst_idx] = src[src_idx]
        vol = 1
        for lo, hi in inter:
            vol *= hi - lo
        covered += vol
    total = 1
    for lo, hi in want:
        total *= hi - lo
    if covered != total:
        # shards are disjoint boxes, so covered volume == requested volume
        # iff the request is fully tiled
        raise FileNotFoundError(
            f"checkpoint shards for {name} cover only {covered}/{total} "
            f"elements of requested slice {want} (saved under an "
            f"incompatible sharding/topology)")
    return out



def _shard_entry(entry_shards: Dict[str, Any], key: str):
    """(file, sha256-or-None) for a manifest shard entry — tolerates the
    pre-checksum manifest format where the value was a bare filename."""
    v = entry_shards[key]
    if isinstance(v, str):
        return v, None
    return v["file"], v.get("sha256")



def _atomic_json(path: str, payload):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, path)



def _merge_manifests(directory: str, step: int,
                     timeout_s: float = MANIFEST_TIMEOUT_S):
    import glob as _glob
    import time
    if _rank()[0] != 0:
        return
    expect = _rank()[1]
    deadline = time.monotonic() + timeout_s
    merged: Optional[Dict] = None
    while True:
        subs = sorted(_glob.glob(os.path.join(directory, "manifest_p*.json")))
        current = []
        for p in subs:
            try:
                with open(p) as f:
                    m = json.load(f)
            except (json.JSONDecodeError, OSError):
                continue       # mid-rename from a non-atomic filesystem
            if m.get("step") == step:
                current.append(m)
        if len(current) >= expect:
            merged = current[0]
            for m in current[1:]:
                for name, entry in m["leaves"].items():
                    merged["leaves"][name]["shards"].update(entry["shards"])
            break
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"checkpoint merge: only {len(current)}/{expect} rank "
                f"manifests for step {step} appeared in {directory} within "
                f"{timeout_s}s")
        time.sleep(0.05)
    _atomic_json(os.path.join(directory, "manifest.json"), merged)


def _target_placement(leaf, mesh, spec) -> Optional[Placement]:
    if spec is None:
        return placement_of(leaf) if isinstance(leaf, torch.Tensor) \
            else None
    shape = tuple(placement_of(leaf).global_shape) \
        if placement_of(leaf) is not None else tuple(leaf.shape)
    return placement_for(mesh, shape, spec, "load_sharded")


def load_sharded(directory: str, target_tree, mesh=None, specs=None):
    """Load into the placement of ``target_tree`` (a nest of tensors: a
    tagged one takes this rank's piece, an untagged one the whole array,
    on the target's device; numpy leaves take the whole host array), or
    — given ``mesh`` and ``specs`` (the same nest of spec tuples) — into
    fresh tensors on this rank's device placed per the specs.

    Returns (tree, step)."""
    import time
    if not os.path.isdir(directory):
        raise FileNotFoundError(
            f"load_sharded: checkpoint directory {directory!r} does not "
            "exist")
    man_path = os.path.join(directory, "manifest.json")
    deadline = time.monotonic() + MANIFEST_TIMEOUT_S
    while not os.path.exists(man_path):
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"load_sharded: {man_path} did not appear within "
                f"{MANIFEST_TIMEOUT_S}s — rank 0's manifest merge may have "
                f"failed or the directory is not a completed checkpoint")
        time.sleep(0.05)
    with open(man_path) as f:
        manifest = json.load(f)
    # a sub-manifest for a NEWER step than the merged manifest: a later
    # save started (and overwrote shard files) but never finished merging
    import glob as _glob
    for sub_path in sorted(_glob.glob(os.path.join(directory,
                                                   "manifest_p*.json"))):
        try:
            with open(sub_path) as f:
                sub = json.load(f)
        except (json.JSONDecodeError, OSError):
            continue
        if (isinstance(sub.get("step"), int)
                and sub["step"] > manifest.get("step", 0)):
            raise CorruptCheckpointError(
                f"{directory}: rank sub-manifest "
                f"{os.path.basename(sub_path)} is for step {sub.get('step')} "
                f"but the merged manifest is for step {manifest.get('step')} "
                "— a newer partial overlapping save corrupted this "
                "checkpoint")
    spec_of = dict(_flatten(specs, seqs=(list,))) \
        if specs is not None else {}
    files: Dict[str, Any] = {}

    def shard_data(name: str, key: str) -> np.ndarray:
        fname, digest = _shard_entry(manifest["leaves"][name]["shards"], key)
        if fname not in files:
            try:
                files[fname] = np.load(os.path.join(directory, fname))
            except (ValueError, OSError, EOFError) as e:
                raise CorruptCheckpointError(
                    f"{directory}/{fname}: unloadable shard archive "
                    f"({e})") from e
        try:
            data = files[fname][f"{name}::{key}"]
        except (KeyError, ValueError, zipfile_BadZipFile) as e:
            raise CorruptCheckpointError(
                f"{directory}/{fname}: missing/unreadable shard "
                f"{name}::{key} ({e})") from e
        if digest is not None and _shard_digest(data) != digest:
            raise CorruptCheckpointError(
                f"{directory}/{fname}: checksum mismatch for shard "
                f"{name}::{key} (truncated or bit-flipped write)")
        return data

    values: Dict[str, Any] = {}
    for name, leaf in _flatten(target_tree):
        entry = manifest["leaves"][name]
        shape = tuple(entry["shape"])
        p = _target_placement(leaf, mesh, spec_of.get(name)) \
            if specs is not None else (placement_of(leaf)
                                       if isinstance(leaf, torch.Tensor)
                                       else None)
        index = p.slices() if p is not None else \
            tuple(slice(0, s) for s in shape)
        key = _index_key(index, shape)
        if key in entry["shards"]:
            data = shard_data(name, key)
        else:
            # the layout changed since the save (elastic shrink/grow, a
            # replicated target of sharded pieces): stitch this slice
            data = _assemble_slice(name, entry, index, shape, shard_data)
        if isinstance(leaf, torch.Tensor) or specs is not None:
            dev = leaf.device if isinstance(leaf, torch.Tensor) \
                else mesh.device
            t = torch.from_numpy(np.array(data)).to(dev)
            values[name] = set_placement(t, p) if p is not None else t
            continue
        pytype = entry.get("pytype")
        if pytype in ("int", "float", "bool"):
            values[name] = {"int": int, "float": float,
                            "bool": bool}[pytype](np.asarray(data).item())
        else:
            values[name] = np.array(data)
    return _unflatten(target_tree, values), manifest.get("step", 0)
