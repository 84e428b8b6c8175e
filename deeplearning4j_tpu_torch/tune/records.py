"""Persistent tuning-record store — the port of
``deeplearning4j_tpu/tune/records.py``.

Winning :class:`~deeplearning4j_tpu_torch.tune.space.TuningPlan`\\ s are
durable: one record file per (model architecture fingerprint x mesh x
backend x runtime) key, written atomically, checksummed, and quarantined
on content damage — the discipline of ``nn.compilecache.
DiskCompileCache``, so the two stores can share a filesystem and a
failure model. The runtime is the compile cache's
:func:`~deeplearning4j_tpu_torch.nn.compilecache.runtime_fingerprint`
(torch and CUDA versions, the card and its compute capability, the kernel
sources), where the JAX package keys by its jax version: a plan tuned on
one card or kernel build never applies to another. A record that survives
:func:`lookup` is what ``fit(tune="auto")`` / ``warmup(tuned=True)`` /
``ModelRegistry.load(tuned=True)`` apply.

Layout of a record file (``tr_<sha256>.json``)::

    DL4JTR1\\n
    {"format": 1, "sha256": <payload sha>, "created": <ts>}\\n
    <record JSON payload>

An OSError on read is a transient miss; a bad magic, a truncated header
or a checksum mismatch renames the file to ``quarantine_*``.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import warnings
from typing import Optional

from deeplearning4j_tpu_torch.profiler.locks import InstrumentedLock
from deeplearning4j_tpu_torch.tune.space import TuningPlan

_MAGIC = b"DL4JTR1\n"
_FORMAT = 1

#: Environment override for the record directory.
ENV_DIR = "DL4J_TPU_TUNE_DIR"
_DEFAULT_DIR = os.path.join("~", ".cache", "deeplearning4j_tpu_torch", "tune")

_CONFIGURED_DIR: Optional[str] = os.environ.get(ENV_DIR)
_ENABLED = True


def configure(directory: Optional[str]) -> None:
    """Set the record directory for this process (overriding
    ``DL4J_TPU_TUNE_DIR``); ``configure(None)`` disables the store —
    lookups miss, puts are dropped with a warning."""
    global _CONFIGURED_DIR, _ENABLED
    _CONFIGURED_DIR = directory
    _ENABLED = directory is not None


def reset_configuration() -> None:
    """Restore env/default resolution."""
    global _CONFIGURED_DIR, _ENABLED
    _CONFIGURED_DIR = os.environ.get(ENV_DIR)
    _ENABLED = True


def record_dir(create: bool = False) -> Optional[str]:
    """The active record directory (configured > env > user cache), or
    None when the store is disabled."""
    if not _ENABLED:
        return None
    d = _CONFIGURED_DIR if _CONFIGURED_DIR is not None \
        else os.environ.get(ENV_DIR)
    if d is None:
        d = os.path.expanduser(_DEFAULT_DIR)
    if create:
        try:
            os.makedirs(d, exist_ok=True)
        except OSError:
            return None
    return d


# ------------------------------------------------------------------ keys
def mesh_signature(mesh) -> str:
    """Stable identity of the mesh a plan was tuned under: None (one
    card), an object with ``signature()``, a label string (the CLI's
    ``--mesh``), or an object whose ``shape`` maps axis -> size."""
    if mesh is None:
        return "none"
    sig = getattr(mesh, "signature", None)
    if callable(sig):
        try:
            return str(sig())
        except Exception:
            pass
    if isinstance(mesh, str):
        return mesh
    for m in (mesh, getattr(mesh, "mesh", None)):
        shape = getattr(m, "shape", None)
        if shape is not None:
            try:
                return "x".join(f"{k}={v}" for k, v in dict(shape).items())
            except (TypeError, ValueError):
                continue
    return type(mesh).__name__


def _backend(backend: Optional[str]) -> str:
    if backend is not None:
        return str(backend)
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


def _runtime() -> str:
    from deeplearning4j_tpu_torch.nn import compilecache as _cc
    return _cc.runtime_fingerprint()


def record_key(model_fp: str, mesh=None, backend: Optional[str] = None
               ) -> str:
    """SHA-256 key over (model fingerprint, mesh signature, backend,
    runtime): one best plan per deployment context."""
    parts = (str(model_fp), mesh_signature(mesh), _backend(backend),
             _runtime())
    return hashlib.sha256("|".join(parts).encode()).hexdigest()


#: Config keys a plan writes when applied: the model's identity is
#: computed modulo these, or applying the winner would change the
#: fingerprint and the record would stop matching the model it tuned.
_SEAM_KEYS = frozenset({"compute_layout", "data_format"})


def _scrub_seams(node):
    if isinstance(node, dict):
        return {k: _scrub_seams(v) for k, v in node.items()
                if k not in _SEAM_KEYS}
    if isinstance(node, list):
        return [_scrub_seams(v) for v in node]
    return node


def model_fingerprint(model) -> str:
    """Stable identity of the model architecture: the config JSON hashed
    with the tunable-seam keys scrubbed at every depth, so a plan's
    ``apply()`` is fingerprint-neutral. Falls back to the compile cache's
    raw fingerprint when the config does not serialize."""
    from deeplearning4j_tpu_torch.nn import compilecache as _cc
    conf = getattr(model, "conf", model)
    try:
        cfg = _scrub_seams(json.loads(conf.to_json()))
    except Exception:
        return _cc.model_fingerprint(model)
    return hashlib.sha256(
        json.dumps(cfg, sort_keys=True).encode()).hexdigest()[:16]


# --------------------------------------------------------------- records
class TuningRecord:
    """One persisted tuning result: the winning plan with its costs, trial
    count and provenance."""

    def __init__(self, model_fp: str, plan: TuningPlan, *,
                 cost_s: float, default_cost_s: Optional[float] = None,
                 mfu: Optional[float] = None, trials: int = 0,
                 mesh=None, backend: Optional[str] = None,
                 model_name: Optional[str] = None,
                 created: Optional[float] = None):
        self.model_fp = str(model_fp)
        self.plan = plan
        self.cost_s = float(cost_s)
        self.default_cost_s = None if default_cost_s is None \
            else float(default_cost_s)
        self.mfu = None if mfu is None else float(mfu)
        self.trials = int(trials)
        self.mesh_sig = mesh_signature(mesh)
        self.backend = _backend(backend)
        self.model_name = model_name
        self.created = time.time() if created is None else float(created)

    @property
    def speedup(self) -> Optional[float]:
        if not self.default_cost_s or self.cost_s <= 0:
            return None
        return self.default_cost_s / self.cost_s

    def to_json(self) -> dict:
        return {"model_fp": self.model_fp,
                "plan": self.plan.to_config(),
                "signature": self.plan.signature(),
                "cost_s": self.cost_s,
                "default_cost_s": self.default_cost_s,
                "mfu": self.mfu,
                "trials": self.trials,
                "mesh": self.mesh_sig,
                "backend": self.backend,
                "runtime": _runtime(),
                "model_name": self.model_name,
                "created": self.created}

    @classmethod
    def from_json(cls, d: dict) -> "TuningRecord":
        return cls(d["model_fp"], TuningPlan.from_config(d["plan"]),
                   cost_s=d["cost_s"],
                   default_cost_s=d.get("default_cost_s"),
                   mfu=d.get("mfu"), trials=d.get("trials", 0),
                   mesh=d.get("mesh"), backend=d.get("backend"),
                   model_name=d.get("model_name"),
                   created=d.get("created"))


def _path(key: str) -> Optional[str]:
    d = record_dir()
    if d is None:
        return None
    return os.path.join(d, f"tr_{key}.json")


def _quarantine(path: str, reason: str) -> None:
    dst = os.path.join(os.path.dirname(path),
                       "quarantine_" + os.path.basename(path))
    try:
        os.replace(path, dst)
    except OSError:
        return
    warnings.warn(f"tuning records: quarantined corrupt entry {path}: "
                  f"{reason}", stacklevel=3)


def put(record: TuningRecord) -> Optional[str]:
    """Atomically persist ``record`` under its deployment key (temp +
    ``os.replace``). Returns the path, or None when the store is
    disabled or unwritable (a tuning run never dies on a read-only
    share)."""
    d = record_dir(create=True)
    if d is None:
        if not _ENABLED:
            warnings.warn("tuning records: store is disabled "
                          "(configure(None)) — winner not persisted",
                          stacklevel=2)
        return None
    key = record_key(record.model_fp, record.mesh_sig, record.backend)
    path = os.path.join(d, f"tr_{key}.json")
    payload = json.dumps(record.to_json(), sort_keys=True).encode()
    header = {"format": _FORMAT,
              "sha256": hashlib.sha256(payload).hexdigest(),
              "created": time.time()}
    tmp = os.path.join(d, f".tmp_tr_{key[:16]}_{os.getpid()}_"
                          f"{threading.get_ident()}")
    try:
        with open(tmp, "wb") as f:
            f.write(_MAGIC)
            f.write(json.dumps(header).encode() + b"\n")
            f.write(payload)
        os.replace(tmp, path)
    except OSError as e:
        try:
            os.remove(tmp)
        except OSError:
            pass
        warnings.warn(f"tuning records: write failed ({e}) — winner not "
                      f"persisted", stacklevel=2)
        return None
    return path


def lookup(model, mesh=None, backend: Optional[str] = None
           ) -> Optional[TuningRecord]:
    """The record for (model, mesh, backend, this runtime), or None.
    ``model`` may be a network/config (fingerprinted here) or a
    fingerprint string."""
    fp = model if isinstance(model, str) else model_fingerprint(model)
    key = record_key(fp, mesh, backend)
    path = _path(key)
    if path is None:
        return None
    try:
        with open(path, "rb") as f:
            magic = f.read(len(_MAGIC))
            if magic != _MAGIC:
                raise ValueError(f"bad magic {magic!r}")
            header = json.loads(f.readline().decode())
            payload = f.read()
    except FileNotFoundError:
        return None
    except OSError:
        return None             # transient I/O is not corruption
    except (ValueError, UnicodeDecodeError) as e:
        _quarantine(path, str(e))
        return None
    if header.get("format") != _FORMAT:
        return None
    digest = hashlib.sha256(payload).hexdigest()
    if digest != header.get("sha256"):
        _quarantine(path, f"payload checksum mismatch (header "
                          f"{str(header.get('sha256'))[:12]}..., actual "
                          f"{digest[:12]}...)")
        return None
    try:
        return TuningRecord.from_json(json.loads(payload.decode()))
    except (ValueError, KeyError, TypeError, UnicodeDecodeError) as e:
        _quarantine(path, f"undecodable record: {e}")
        return None


def best_plan(model, mesh=None, backend: Optional[str] = None
              ) -> Optional[TuningPlan]:
    """The winning plan for this deployment context, or None."""
    rec = lookup(model, mesh=mesh, backend=backend)
    return rec.plan if rec is not None else None


# ------------------------------------------------------------ auto-apply
# one fallback warning per deployment key a process: fit() runs every
# epoch loop, and a warning storm is worse than none
_WARNED = set()
_WARNED_LOCK = InstrumentedLock("tune:records")


def auto_apply(model, mesh=None, backend: Optional[str] = None,
               context: str = "fit") -> Optional[TuningPlan]:
    """Consult the store and apply the winning plan to ``model`` — the
    ``tune="auto"`` / ``tuned=True`` entry point. Returns the applied
    plan, or None (with one warning a deployment key) when no record
    exists; the defaults then stand."""
    fp = model_fingerprint(model)
    rec = lookup(fp, mesh=mesh, backend=backend)
    if rec is None:
        key = record_key(fp, mesh, backend)
        with _WARNED_LOCK:
            first = key not in _WARNED
            _WARNED.add(key)
        if first:
            warnings.warn(
                f"tune: no tuning record for this (model, mesh, backend) "
                f"— {context} falls back to default plan settings; run "
                f"`python -m deeplearning4j_tpu_torch.tune <model>` to "
                f"tune and persist one", stacklevel=3)
        return None
    rec.plan.apply(model)
    return rec.plan


def reset_warned() -> None:
    """Forget which deployment keys already warned."""
    with _WARNED_LOCK:
        _WARNED.clear()
