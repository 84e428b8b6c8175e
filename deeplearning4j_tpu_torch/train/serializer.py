"""Model archives — the port of ``deeplearning4j_tpu/train/serializer.py``
(ref: ``org.deeplearning4j.util.ModelSerializer``).

The format is the JAX package's, unchanged, so an archive written by
either package loads in the other: a zip of ``conf.json`` (the
configuration's JSON), ``meta.json`` (``type``, ``iteration``, ``epoch``,
``save_updater``) and ``arrays.npz``, which holds the params
(``p{i}::name`` for layer i of a ``MultiLayerNetwork``, ``p::node::name``
in a ``ComputationGraph``), the layer states (``s{i}::name``,
``s::node::name``) and the updater state as ``u::{j}``.

``u::{j}`` is the j-th leaf of the JAX package's updater-state pytree in
``jax.tree_util.tree_flatten`` order: layers (a list) in order, or nodes
(a dict) by sorted name, then each layer's param names sorted, then each
param's state keys sorted (Adam: ``m``, ``v``). The port keeps its
updater state by the same names (:func:`updater_leaves`), so it writes
and reads that order.

Every write goes to a temp file in the target directory finalized by one
``os.replace``: a crash mid-write never leaves a truncated archive under
the real name. Every restore failure raises :class:`CorruptModelError`
naming the bad entry.

A wrapper layer's params are stored under their flat names
(``p{i}::fwd/W`` for a ``Bidirectional``). The JAX package stores its
nested dict as one pickled object array a wrapper, which neither its own
reader nor this one loads (both refuse pickles): such an entry raises
:class:`CorruptModelError` naming it.

``writeNormalizer``/``restoreNormalizer`` store a normalizer as the JAX
package does: an ``.npz`` of its state and ``__class__``, its class
name in ``data.dataset``.
"""

from __future__ import annotations

import io
import json
import os
import zipfile
from contextlib import contextmanager
from typing import Dict, List, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.parallel.mesh import (global_shape, local_piece,
                                                    placement_of)


class CorruptModelError(Exception):
    """A model archive failed to restore: truncated zip, missing entry,
    CRC mismatch, or unparseable metadata. ``entry`` names the offending
    archive member (None for damage to the container)."""

    def __init__(self, path: str, entry, detail: str):
        self.path = path
        self.entry = entry
        where = f"{path}[{entry}]" if entry else path
        super().__init__(f"corrupt model archive {where}: {detail}")


@contextmanager
def atomic_write(path: str):
    """Yield a temp path in ``path``'s directory; on a clean exit
    ``os.replace`` it over ``path`` (readers see the old file or the new
    one, never a partial one). On error the temp file is removed and the
    original is untouched."""
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        yield tmp
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass
        raise


def write_model_zip(path: str, conf_json: str, meta: dict,
                    arrays: Dict[str, np.ndarray]) -> None:
    """The shared atomic writer of the archive format."""
    with atomic_write(path) as tmp:
        with zipfile.ZipFile(tmp, "w") as z:
            z.writestr("conf.json", conf_json)
            z.writestr("meta.json", json.dumps(meta))
            buf = io.BytesIO()
            np.savez(buf, **arrays) if arrays else np.savez(
                buf, __empty__=np.zeros(1))
            z.writestr("arrays.npz", buf.getvalue())


def read_model_zip(path: str):
    """The shared validating reader: ``(conf_json, meta, npz arrays)``,
    raising CorruptModelError naming the bad entry."""
    try:
        z = zipfile.ZipFile(path)
    except FileNotFoundError:
        raise
    except (zipfile.BadZipFile, OSError) as e:
        raise CorruptModelError(path, None,
                                f"not a readable zip ({e})") from e
    with z:
        names = set(z.namelist())
        for req in ("conf.json", "meta.json", "arrays.npz"):
            if req not in names:
                raise CorruptModelError(path, req, "entry missing")
        try:
            bad = z.testzip()
        except (zipfile.BadZipFile, OSError) as e:
            raise CorruptModelError(path, None,
                                    f"CRC scan failed ({e})") from e
        if bad is not None:
            raise CorruptModelError(path, bad, "CRC mismatch (truncated or "
                                    "bit-flipped write)")
        conf_json = z.read("conf.json").decode()
        try:
            meta = json.loads(z.read("meta.json"))
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise CorruptModelError(path, "meta.json",
                                    f"unparseable ({e})") from e
        try:
            arrays = np.load(io.BytesIO(z.read("arrays.npz")))
        except (ValueError, OSError) as e:
            raise CorruptModelError(path, "arrays.npz",
                                    f"unloadable npz ({e})") from e
    return conf_json, meta, arrays


def require_array(arrays, key: str, path: str):
    """One npz member, or CorruptModelError (not KeyError) naming it."""
    if key not in arrays.files:
        raise CorruptModelError(path, f"arrays.npz::{key}", "entry missing")
    return arrays[key]


def updater_leaves(model) -> List[Tuple]:
    """``(layer key, param name, state key)`` of every updater-state
    tensor, in the JAX pytree's flatten order (see the module note)."""
    return [(n, k, sk) for n, k in model._leaf_keys()
            for sk in sorted(model._opt_state[n][k])]


def archive_arrays(model, params_key, save_updater: bool):
    """``(meta, arrays)`` of a network: ``params_key(kind, layer, name)``
    spells an entry's name (``p``/``s`` for params and states)."""
    meta = {"type": type(model).__name__, "iteration": model._iteration,
            "epoch": model._epoch,
            "save_updater": bool(save_updater
                                 and model._opt_state is not None)}
    arrays: Dict[str, np.ndarray] = {}
    for kind, tree in (("p", model._params), ("s", model._states)):
        for n, d in model._items(tree):
            for name, t in d.items():
                if placement_of(t) is not None:
                    raise ValueError(
                        "saving a model whose params are split over the "
                        "data axis: save its plan's checkpoint_view(model) "
                        "(every rank gathers), or detach the plan first")
                arrays[params_key(kind, n, name)] = \
                    t.detach().cpu().numpy()
    if meta["save_updater"]:
        for j, (n, k, sk) in enumerate(updater_leaves(model)):
            t = model._opt_state[n][k][sk]
            if placement_of(t) is not None:
                raise ValueError(
                    "saving a model whose updater state is ZeRO-split: "
                    "save its plan's checkpoint_view(model) (every rank "
                    "gathers), or detach the plan first")
            arrays[f"u::{j}"] = t.detach().cpu().numpy()
    return meta, arrays


def restore_into(net, path: str, meta, arrays, entries,
                 load_updater: bool) -> None:
    """Fill an initialized ``net`` from an archive: ``entries`` yields
    ``(kind, layer key, name, array name)`` for its params (``p``) and
    states (``s``); then the counters and, if asked and saved, the
    updater state in the JAX flatten order."""
    with torch.no_grad():
        for kind, n, name, key in entries:
            if kind == "p" and name not in net._params[n]:
                raise CorruptModelError(
                    path, f"arrays.npz::{key}",
                    f"names no parameter of layer {n!r} (its params: "
                    f"{sorted(net._params[n])}; a JAX package archive "
                    "stores a wrapper's nested params as a pickle, which "
                    "is not read)")
            t = torch.from_numpy(np.array(arrays[key])).to(net._device)
            if kind == "p":
                net._params[n][name] = t.float().requires_grad_(True)
            else:
                net._states[n][name] = t
    net._reset_training_state()
    net._iteration = int(meta["iteration"])
    net._epoch = int(meta["epoch"])
    if load_updater and meta.get("save_updater"):
        net._ensure_opt_state()
        with torch.no_grad():
            for j, (n, k, sk) in enumerate(updater_leaves(net)):
                a = require_array(arrays, f"u::{j}", path)
                dst = net._opt_state[n][k][sk]
                dst.copy_(local_piece(torch.from_numpy(np.array(a)),
                                      placement_of(dst)))


def _archive_entries(net, arrays):
    """``(kind, layer key, name, array name)`` of an archive's params
    (``p``) and states (``s``), spelled as ``net``'s class writes them
    (``p0::W`` in the sequential network, ``p::node::W`` in the graph)."""
    graph = isinstance(net._params, dict)
    for k in arrays.files:
        if graph:
            parts = k.split("::")
            if parts[0] in ("p", "s") and len(parts) == 3:
                yield parts[0], parts[1], parts[2], k
        else:
            kind, _, name = k.partition("::")
            if kind[:1] in ("p", "s") and kind[1:].isdigit():
                yield kind[:1], int(kind[1:]), name, k


def load_into(net, path: str, load_updater: bool = True) -> dict:
    """Copy an archive of either package into ``net``'s own tensors: every
    param, layer state and (if saved and asked) updater-state tensor, in
    place, so their storage and any captured step over it stay valid;
    then the step and epoch counters and the device clock. The archive
    must be of this network (each entry names one of its tensors, and
    each of its params is in the archive). Returns the archive's meta."""
    _conf_json, meta, arrays = read_model_zip(path)
    seen = set()
    with torch.no_grad():
        for kind, n, name, key in _archive_entries(net, arrays):
            tree = net._params if kind == "p" else net._states
            try:
                dst = tree[n][name]
            except (KeyError, IndexError, TypeError):
                raise CorruptModelError(
                    path, f"arrays.npz::{key}",
                    "names no tensor of this network") from None
            src = torch.from_numpy(np.array(arrays[key]))
            if tuple(src.shape) != global_shape(dst):
                raise CorruptModelError(
                    path, f"arrays.npz::{key}",
                    f"shape {tuple(src.shape)}, the network's "
                    f"{global_shape(dst)}")
            dst.copy_(local_piece(src, placement_of(dst)))
            if kind == "p":
                seen.add((n, name))
    missing = [f"{n}/{k}" for n, k in net._leaf_keys() if (n, k) not in seen]
    if missing:
        raise CorruptModelError(path, "arrays.npz",
                                f"no entry for params {missing[:4]}")
    net._iteration = int(meta["iteration"])
    net._epoch = int(meta["epoch"])
    if net._t_dev is not None:
        with torch.no_grad():
            net._t_dev.fill_(net._iteration)
    if load_updater and meta.get("save_updater"):
        net._ensure_opt_state()
        with torch.no_grad():
            for j, (n, k, sk) in enumerate(updater_leaves(net)):
                a = require_array(arrays, f"u::{j}", path)
                dst = net._opt_state[n][k][sk]
                dst.copy_(local_piece(torch.from_numpy(np.array(a)),
                                      placement_of(dst)))
    return meta


class ModelSerializer:
    """ref: ModelSerializer — ``writeModel``, ``restoreMultiLayerNetwork``,
    ``writeNormalizer`` and ``restoreNormalizer``."""

    @staticmethod
    def writeModel(model, path: str, save_updater: bool = True):
        model._require_init()
        meta, arrays = archive_arrays(
            model, lambda kind, i, name: f"{kind}{i}::{name}", save_updater)
        write_model_zip(path, model.conf.to_json(), meta, arrays)

    @staticmethod
    def restoreMultiLayerNetwork(path: str, load_updater: bool = True,
                                 device=None):
        """The network on ``device`` (the card unless the caller names
        another)."""
        from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        conf_json, meta, arrays = read_model_zip(path)
        try:
            conf = MultiLayerConfiguration.from_json(conf_json)
        except Exception as e:
            raise CorruptModelError(path, "conf.json",
                                    f"unparseable configuration ({e})") from e
        net = MultiLayerNetwork(conf).init(device=device)
        restore_into(net, path, meta, arrays, _archive_entries(net, arrays),
                     load_updater)
        return net

    # normalizer (ref: NormalizerSerializer)
    @staticmethod
    def writeNormalizer(norm, path: str):
        """The normalizer's state (``state()``, else its attributes) and
        ``__class__`` as an ``.npz``, written atomically."""
        state = norm.state() if hasattr(norm, "state") else norm.__dict__
        with atomic_write(path) as tmp:
            # a file object: np.savez(path) would append ".npz" to an
            # extension-less path and break the final replace
            with open(tmp, "wb") as f:
                np.savez(f, __class__=np.asarray(type(norm).__name__),
                         **{k: np.asarray(v) for k, v in state.items()
                            if v is not None})

    @staticmethod
    def restoreNormalizer(path: str):
        """A normalizer file of either package."""
        from deeplearning4j_tpu_torch.data import dataset as D
        try:
            data = np.load(path, allow_pickle=False)
        except FileNotFoundError:
            raise
        except (ValueError, OSError) as e:
            raise CorruptModelError(path, None,
                                    f"unloadable normalizer npz ({e})") from e
        if "__class__" not in data.files:
            raise CorruptModelError(path, "__class__", "entry missing")
        name = str(data["__class__"])
        cls = getattr(D, name, None)
        if cls is None or not hasattr(cls, "transform"):
            raise CorruptModelError(path, "__class__",
                                    f"unknown normalizer class {name!r}")
        norm = cls()
        for k in data.files:
            if k != "__class__":
                setattr(norm, k, data[k])
        return norm
