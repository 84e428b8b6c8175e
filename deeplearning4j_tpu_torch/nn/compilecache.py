"""Captured dispatch, its disk tier and the warmup API — the port of
``deeplearning4j_tpu/nn/compilecache.py``.

On the card the counterpart of a compiled XLA program is a captured CUDA
graph: every launch of a step recorded once, replayed by one
``cudaGraphLaunch``, so the host no longer pays Python and launch time
per kernel.

- :class:`CachedDispatch` maps each argument signature (shapes, dtypes
  and devices, the reference's ``_leaf_signature``) to one captured
  ``torch.cuda.CUDAGraph`` with static input and output buffers; a call
  copies its arguments in, replays, and returns a copy of the outputs.
  The function's STATE (params, updater state, running statistics, the
  device clock) is not an argument: the function reads and writes it in
  place, at the addresses the graph recorded, which is why the port's
  steps never rebind a state tensor. A new signature is captured once —
  the port's "cold compile" — after a few eager warm-up runs on a side
  stream (the PyTorch whole-network-capture recipe), which do change
  state: the dispatch snapshots the tensors its ``state`` callable names
  and restores them, so capturing (and :meth:`CachedDispatch.warm`)
  leaves every piece of state as it found it. A capture that fails warns
  once and runs that signature eagerly from then on, as the reference's
  AOT fallback does; ``cache_stats()["capture_failures"]`` counts it. On
  the CPU a dispatch calls the function eagerly: the caller asked for
  the CPU.
- The disk tier. A CUDA graph cannot be serialized, so what persists is
  a **warm-signature manifest**: for each model (its configuration's
  fingerprint, compute layout, epilogue fusion and precision policy) and
  scope, the signatures its dispatches captured — the batch signature,
  K, layout, fusion, policy and scope. :class:`DiskCompileCache` stores
  one manifest a file, in the JAX package's entry format: magic line,
  JSON header (format, :func:`runtime_fingerprint`, payload SHA-256,
  scope), payload; atomic writes by temp file and ``os.replace``;
  corrupt entries quarantined, entries of another runtime ignored and
  rewritten; LRU eviction past ``max_entries``. At start-up ``fit`` and
  :func:`warmup` replay a model's manifest through
  :func:`warm_from_batch_signature`, so every signature it names is
  captured before the first batch; a served model's warmup adds its
  manifest's shapes. With the tier configured, a dispatch also captures
  at its first call (the reference goes AOT once the cache is on).
  Enable it with :func:`configure` or ``DL4J_TPU_COMPILE_CACHE_DIR``.
- :func:`warmup` is the one entry point: ``warmup(net, [((64, 3, 224,
  224), (64, 1000))], steps_per_dispatch=K)`` captures the train step (K
  steps with K > 1) for that batch signature; ``warmup(server, shapes)``
  delegates to the serving bucket-ladder warmup, which captures the
  served forward and head of every bucket x shape (scope
  ``"serving:forward"``). ``tuned=True`` applies the model's tuning
  record first (``tune.records``).

Kernel launch counts (``ops.cuda_kernels.LAUNCHES``) are bumped in
Python, so a graph's launches count once, while it is captured; each
entry keeps that count and every replay adds it to
``cuda_kernels.REPLAYS``.

Metrics: ``dl4j_compile_cache_{hits,misses}_total{scope=memory|disk}``,
``dl4j_compile_cache_evictions_total{scope=disk}``,
``dl4j_compile_cache_quarantined_total``, ``dl4j_compile_seconds{state=
cold|warm}`` and ``dl4j_capture_failures_total``. A disk hit is a
capture the manifest named, made at warm start: its seconds are
``warm`` (the capture is still paid, before traffic); a disk miss is a
signature the manifest did not name, captured ``cold`` and added.
"""

from __future__ import annotations

import contextlib
import gc
import glob
import hashlib
import json
import os
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.profiler.metrics import get_registry

_REG = get_registry()
CACHE_HITS = _REG.counter(
    "dl4j_compile_cache_hits_total",
    "Compile-cache hits by tier: memory = an already-captured graph "
    "served a dispatch, disk = a signature the persistent manifest named "
    "was captured at warm start, before traffic", labelnames=("scope",))
CACHE_MISSES = _REG.counter(
    "dl4j_compile_cache_misses_total",
    "Compile-cache misses by tier: memory = first sight of a dispatch "
    "signature in this process, disk = a captured signature the "
    "persistent manifest did not name (it is added)",
    labelnames=("scope",))
COMPILE_SECONDS = _REG.histogram(
    "dl4j_compile_seconds",
    "Program acquisition latency: cold = eager warm-up runs plus the "
    "CUDA-graph capture of a signature no manifest named, warm = the same "
    "for a manifest signature at warm start", labelnames=("state",),
    buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
             10.0, 30.0, 60.0))
_HITS_MEM = CACHE_HITS.labels(scope="memory")
_MISS_MEM = CACHE_MISSES.labels(scope="memory")
_HITS_DISK = CACHE_HITS.labels(scope="disk")
_MISS_DISK = CACHE_MISSES.labels(scope="disk")
_COLD = COMPILE_SECONDS.labels(state="cold")
_WARM = COMPILE_SECONDS.labels(state="warm")
_FAILURES = _REG.counter(
    "dl4j_capture_failures_total",
    "Signatures whose CUDA-graph capture failed and that run eagerly")
CACHE_EVICTIONS = _REG.counter(
    "dl4j_compile_cache_evictions_total",
    "Entries evicted from a compile-cache tier (disk: LRU past "
    "max_entries; memory: never — graphs live with their model)",
    labelnames=("scope",))
_EVICT_DISK = CACHE_EVICTIONS.labels(scope="disk")
CACHE_EVICTIONS.labels(scope="memory")
CACHE_QUARANTINED = _REG.counter(
    "dl4j_compile_cache_quarantined_total",
    "Corrupt persistent-cache entries (bad magic/header/checksum) "
    "renamed aside at read time instead of trusted")

ENV_DIR = "DL4J_TPU_COMPILE_CACHE_DIR"
ENV_MAX_ENTRIES = "DL4J_TPU_COMPILE_CACHE_MAX_ENTRIES"

_UNSET = object()
_LOCK = threading.RLock()
_CONFIGURED_DIR = _UNSET            # explicit configure() overrides the env
_CONFIGURED_MAX: Optional[int] = None
_DISK: Optional["DiskCompileCache"] = None

#: per-process aggregates for cache_stats() (plain ints under the GIL)
_STATS = {"memory_hits": 0, "memory_misses": 0, "cold_seconds": 0.0,
          "cold_compiles": 0, "capture_failures": 0, "warmup_seconds": 0.0,
          "enter_seconds": 0.0, "capture_seconds": 0.0,
          "disk_hits": 0, "disk_misses": 0, "warm_seconds": 0.0,
          "warm_loads": 0, "eager_by_design": 0}

#: eager runs before a capture: cuBLAS/cuDNN handles and workspaces and
#: the allocator's blocks come into being outside the graph
WARMUP_RUNS = 2

#: sentinel parked for signatures whose capture failed: eager for good
_CAPTURE_FAILED = object()
#: the warm-up runs' side stream, one a device (``_side_stream``)
_WARMUP_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def configure(directory: Optional[str], max_entries: Optional[int] = None
              ) -> None:
    """Set (or clear, with ``None``) the persistent cache directory for
    this process, overriding ``DL4J_TPU_COMPILE_CACHE_DIR``."""
    global _CONFIGURED_DIR, _CONFIGURED_MAX, _DISK
    with _LOCK:
        _CONFIGURED_DIR = directory
        _CONFIGURED_MAX = max_entries
        _DISK = None                     # rebuilt lazily at the new path


def reset_configuration() -> None:
    """Drop the explicit configure() override (env resolution returns)."""
    global _CONFIGURED_DIR, _CONFIGURED_MAX, _DISK
    with _LOCK:
        _CONFIGURED_DIR = _UNSET
        _CONFIGURED_MAX = None
        _DISK = None


def cache_dir() -> Optional[str]:
    """The resolved persistent-cache directory (explicit configure()
    wins, else the env var), or None when the disk tier is disabled."""
    with _LOCK:
        if _CONFIGURED_DIR is not _UNSET:
            return _CONFIGURED_DIR
    return os.environ.get(ENV_DIR) or None


def cache_dir_status():
    """(directory, writable) — what the DL4J-W112 serving lint checks:
    ``(None, False)`` means no persistent cache is configured."""
    d = cache_dir()
    if d is None:
        return None, False
    try:
        os.makedirs(d, exist_ok=True)
        probe = os.path.join(
            d, f".wprobe_{os.getpid()}_{threading.get_ident()}")
        with open(probe, "w") as f:
            f.write("w")
        os.remove(probe)
        return d, True
    except OSError:
        return d, False


_DISK_WARNED: set = set()


def disk_cache() -> Optional["DiskCompileCache"]:
    """The process-wide disk tier at the resolved directory (None when
    disabled or when the directory cannot be created: an unusable cache
    degrades to no cache, never to a failed dispatch; W112 names it)."""
    global _DISK
    d = cache_dir()
    if d is None:
        return None
    with _LOCK:
        if _DISK is None or _DISK.dir != d:
            max_entries = _CONFIGURED_MAX
            if max_entries is None:
                max_entries = int(os.environ.get(ENV_MAX_ENTRIES, "512"))
            try:
                _DISK = DiskCompileCache(d, max_entries=max_entries)
            except OSError as e:
                if d not in _DISK_WARNED:
                    _DISK_WARNED.add(d)
                    warnings.warn(
                        f"persistent compile cache at {d!r} unusable "
                        f"({e}) — running without the disk tier "
                        "(DL4J-W112 territory)", stacklevel=2)
                return None
        return _DISK


def cache_stats() -> dict:
    """Per-process snapshot: memory-tier hits and misses, the disk tier's
    hits (manifest signatures captured at warm start), misses and
    entries, captures ("cold compiles") and their seconds, warm-start
    captures (``warm``), failed captures, and the steps run eagerly by
    design (``eager_by_design``: a SameDiff graph with host control
    flow). The cold seconds split into the eager warm-up runs
    (``warmup``), the capture's set-up before its first recorded launch
    (``enter``) and the recording itself (``capture``)."""
    disk = None
    d = cache_dir()
    if d is not None and os.path.isdir(d):
        disk = disk_cache()
    return {"memory": {"hits": _STATS["memory_hits"],
                       "misses": _STATS["memory_misses"]},
            "disk": {"enabled": d is not None, "dir": d,
                     "hits": _STATS["disk_hits"],
                     "misses": _STATS["disk_misses"],
                     "entries": disk.entry_count() if disk is not None
                     else 0},
            "compile_seconds": {"cold": _STATS["cold_seconds"],
                                "warm": _STATS["warm_seconds"],
                                "cold_compiles": _STATS["cold_compiles"],
                                "warm_loads": _STATS["warm_loads"],
                                "warmup": _STATS["warmup_seconds"],
                                "enter": _STATS["enter_seconds"],
                                "capture": _STATS["capture_seconds"]},
            "capture_failures": _STATS["capture_failures"],
            "eager_by_design": _STATS["eager_by_design"]}


def reset_stats() -> None:
    for k in _STATS:
        _STATS[k] = 0.0 if k.endswith("seconds") else 0


# ------------------------------------------------ shared event accounting
def note_disk_hit(seconds: float) -> None:
    _STATS["disk_hits"] += 1
    _STATS["warm_seconds"] += seconds
    _STATS["warm_loads"] += 1
    _HITS_DISK.inc()
    _WARM.observe(seconds)


def note_disk_miss() -> None:
    _STATS["disk_misses"] += 1
    _MISS_DISK.inc()


def note_cold_compile(seconds: float) -> None:
    _STATS["cold_seconds"] += seconds
    _STATS["cold_compiles"] += 1
    _COLD.observe(seconds)


def note_eager_by_design() -> None:
    """One step run eagerly on purpose (it reads a value on the host)."""
    _STATS["eager_by_design"] += 1


# ------------------------------------------------------------------- keys
_RUNTIME_FP = None
_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "ops", "csrc")


def kernel_sources_digest() -> str:
    """SHA-256 (16 hex) over the hand-written kernels' ``.cu`` sources."""
    h = hashlib.sha256()
    for path in sorted(glob.glob(os.path.join(_CSRC, "*.cu"))):
        h.update(os.path.basename(path).encode() + b"\x00")
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def runtime_fingerprint() -> str:
    """The runtime identity baked into every key and entry: torch and
    CUDA versions, the card's name and compute capability, and the
    kernel sources' digest. A manifest written under one runtime is
    never replayed under another."""
    global _RUNTIME_FP
    if _RUNTIME_FP is None:
        name, cap = "cpu", "-"
        if torch.cuda.is_available():
            name = torch.cuda.get_device_name(0)
            cap = "%d.%d" % torch.cuda.get_device_capability(0)
        _RUNTIME_FP = (f"torch={torch.__version__};"
                       f"cuda={torch.version.cuda};device={name};cc={cap};"
                       f"kernels={kernel_sources_digest()}")
    return _RUNTIME_FP


def content_key(scope: str, content: bytes, key_parts=()) -> str:
    """SHA-256 hex over (runtime fingerprint, scope, explicit key parts,
    content)."""
    h = hashlib.sha256()
    h.update(runtime_fingerprint().encode())
    h.update(b"\x00" + scope.encode() + b"\x00")
    h.update(repr(tuple(key_parts)).encode())
    h.update(b"\x00")
    h.update(content)
    return h.hexdigest()


# -------------------------------------------------------------- disk tier
_MAGIC = b"DL4JCC1\n"
_FORMAT = 1


class DiskCompileCache:
    """Content-addressed store of manifests (module doc).

    One entry = one file ``cc_<sha256>.bin``: magic line, one JSON
    header line (format, runtime fingerprint, payload SHA-256, scope,
    creation time), then the payload. Readers validate magic, header
    and checksum; corrupt entries are quarantined (renamed
    ``quarantine_cc_...``), entries of another runtime ignored (the
    caller rewrites them). Writes are atomic: temp file +
    ``os.replace``."""

    def __init__(self, directory: str, max_entries: int = 512):
        self.dir = directory
        self.max_entries = int(max_entries)
        os.makedirs(directory, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, f"cc_{key}.bin")

    def entry_count(self) -> int:
        try:
            return sum(1 for n in os.listdir(self.dir)
                       if n.startswith("cc_") and n.endswith(".bin"))
        except OSError:
            return 0

    def get(self, key: str) -> Optional[bytes]:
        """Payload bytes for ``key``, or None (absent, of another
        runtime, transiently unreadable, or quarantined-corrupt)."""
        path = self._path(key)
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
            # an I/O error is not evidence of corruption: miss, retry later
            return None
        except (ValueError, UnicodeDecodeError) as e:
            self._quarantine(path, str(e))
            return None
        if header.get("format") != _FORMAT \
                or header.get("runtime") != runtime_fingerprint():
            return None
        digest = hashlib.sha256(payload).hexdigest()
        if digest != header.get("sha256"):
            self._quarantine(
                path, f"payload checksum mismatch (header "
                      f"{str(header.get('sha256'))[:12]}..., actual "
                      f"{digest[:12]}...)")
            return None
        try:                # LRU clock for eviction ordering
            os.utime(path, None)
        except OSError:
            pass
        return payload

    def put(self, key: str, payload: bytes, scope: str = "") -> str:
        """Atomic write (temp + ``os.replace``): a crash mid-write never
        leaves a half-entry under the real name, and concurrent writers
        of one key land whole either way."""
        path = self._path(key)
        header = {"format": _FORMAT, "runtime": runtime_fingerprint(),
                  "sha256": hashlib.sha256(payload).hexdigest(),
                  "scope": scope, "created": time.time()}
        tmp = os.path.join(
            self.dir, f".tmp_cc_{key[:16]}_{os.getpid()}_"
                      f"{threading.get_ident()}")
        try:
            with open(tmp, "wb") as f:
                f.write(_MAGIC)
                f.write(json.dumps(header).encode() + b"\n")
                f.write(payload)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        self._evict()
        return path

    #: temp files older than this were abandoned by a killed writer
    _TMP_MAX_AGE_S = 3600.0

    #: entries younger than this are never evicted, whatever the count:
    #: another process on a shared directory may not have read its own
    #: fresh entry yet
    _EVICT_GRACE_S = 300.0

    def _evict(self) -> None:
        """Best-effort LRU (mtime: ``get`` touches entries) over the
        directory, tolerant of concurrent evictors: a file that vanished
        is skipped, entries inside the grace window are kept."""
        try:
            names = os.listdir(self.dir)
        except OSError:
            return
        now = time.time()       # compared with file mtimes (wall clock)
        entries = []
        for n in names:
            p = os.path.join(self.dir, n)
            if n.startswith(".tmp_cc_"):
                try:
                    age = now - os.path.getmtime(p)  # dl4j: noqa=W210
                    if age > self._TMP_MAX_AGE_S:
                        os.remove(p)
                except OSError:
                    pass
                continue
            if n.startswith("cc_") and n.endswith(".bin"):
                try:
                    entries.append((os.path.getmtime(p), n))
                except OSError:
                    continue
        entries.sort()
        excess = len(entries) - max(1, self.max_entries)
        for mtime, name in entries:
            if excess <= 0:
                break
            if now - mtime < self._EVICT_GRACE_S:  # dl4j: noqa=W210
                break       # sorted: everything after is younger still
            try:
                os.remove(os.path.join(self.dir, name))
                _EVICT_DISK.inc()
            except OSError:
                pass        # a concurrent evictor got it first
            excess -= 1

    def _quarantine(self, path: str, reason: str) -> None:
        dst = os.path.join(os.path.dirname(path),
                           "quarantine_" + os.path.basename(path))
        try:
            os.replace(path, dst)
        except OSError:
            return
        CACHE_QUARANTINED.inc()
        warnings.warn(
            f"compile cache: quarantined corrupt entry {path}: {reason}",
            stacklevel=3)


def model_fingerprint(model) -> str:
    """Stable cross-process identity of a model's architecture: SHA-256
    of the configuration JSON when the config serializes, else a
    process-local id (no cross-process sharing for that model)."""
    conf = getattr(model, "conf", model)
    try:
        return hashlib.sha256(conf.to_json().encode()).hexdigest()[:16]
    except Exception:
        return f"pid{os.getpid()}-id{id(conf):x}"


# --------------------------------------------------------------- manifests
def _policy_signature(model) -> str:
    pol = getattr(model, "_precision", None)
    return pol.signature() if pol is not None else "fp32"


def _manifest_fingerprint(model) -> str:
    """The model's fingerprint with the layout stamps scrubbed (the
    tuning records' identity): the layout is a key part of its own, so a
    net that went NHWC and back keys as a fresh NCHW one."""
    from deeplearning4j_tpu_torch.tune.records import model_fingerprint
    return model_fingerprint(model)


def manifest_key(model, scope: str) -> str:
    """The key of ``model``'s manifest for ``scope`` (``"train"`` or
    ``"serving:forward"``): its fingerprint, compute layout, epilogue
    fusion and precision policy."""
    parts = (getattr(model, "_compute_layout", "NCHW"),
             bool(getattr(model, "_fuse_epilogues", False)),
             _policy_signature(model))
    return content_key("manifest:" + scope,
                       _manifest_fingerprint(model).encode(), parts)


def read_manifest(model, scope: str = "train",
                  key: Optional[str] = None) -> Optional[List[dict]]:
    """The entries of ``model``'s manifest (under ``key`` when the caller
    has it), or None (no disk tier, no manifest, or a quarantined one)."""
    disk = disk_cache()
    if disk is None:
        return None
    blob = disk.get(key or manifest_key(model, scope))
    if blob is None:
        return None
    try:
        return list(json.loads(blob.decode())["entries"])
    except (ValueError, KeyError, TypeError, UnicodeDecodeError):
        return None


def _manifest_record(model, scope: str, entry: dict) -> bool:
    """Add ``entry`` to the manifest; True when the manifest named it
    already (a disk hit)."""
    disk = disk_cache()
    if disk is None:
        return False
    key = manifest_key(model, scope)
    with _LOCK:
        entries = read_manifest(model, scope, key) or []
        if entry in entries:
            return True
        entries.append(entry)
        payload = json.dumps({
            "model": _manifest_fingerprint(model), "scope": scope,
            "layout": getattr(model, "_compute_layout", "NCHW"),
            "fusion": bool(getattr(model, "_fuse_epilogues", False)),
            "policy": _policy_signature(model),
            "entries": entries}, sort_keys=True).encode()
        try:
            disk.put(key, payload, scope=scope)
        except OSError as e:
            warnings.warn(f"compile cache: manifest write failed ({e})",
                          stacklevel=3)
    return False


def warm_from_manifest(model) -> int:
    """Capture every train-step signature ``model``'s manifest names
    (once a model, directory, layout, fusion and policy; a no-op without
    the disk tier). Returns the signatures warmed. The once-check comes
    first and reads only attributes, so a ``fit`` per batch pays no
    serialization, hashing or disk read after its first."""
    d = cache_dir()
    if d is None:
        return 0
    seen = (d, getattr(model, "_compute_layout", "NCHW"),
            bool(getattr(model, "_fuse_epilogues", False)),
            _policy_signature(model))
    done = model.__dict__.setdefault("_manifest_warmed", set())
    if seen in done:
        return 0
    done.add(seen)
    entries = read_manifest(model, "train", manifest_key(model, "train"))
    if not entries:
        return 0
    n = 0
    for e in entries:
        if warm_from_batch_signature(model, e.get("batch"),
                                     steps_per_dispatch=e.get("steps", 1)):
            n += 1
    return n


def served_manifest_shapes(model) -> List[tuple]:
    """The per-request feature shapes a served ``model``'s manifest
    names (what a fresh server adds to its warmup)."""
    out = []
    for e in read_manifest(model, "serving:forward") or []:
        s = tuple(int(d) for d in e.get("shape", ()))
        if s not in out:
            out.append(s)
    return out


def state_tensors(*trees) -> List[torch.Tensor]:
    """The tensors of nested dicts/lists/tuples, in order (None skipped)."""
    out: List[torch.Tensor] = []

    def walk(t):
        if isinstance(t, torch.Tensor):
            out.append(t)
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
    for tree in trees:
        walk(tree)
    return out


@contextlib.contextmanager
def preserved(tensors: List[torch.Tensor]):
    """Snapshot ``tensors`` and copy the snapshot back on exit, in place
    (the storage the captured graphs recorded stays the same)."""
    saved = [t.detach().clone() for t in tensors]
    try:
        yield
    finally:
        with torch.no_grad():
            for t, s in zip(tensors, saved):
                t.copy_(s)


def _leaf_signature(a):
    """Identity of one argument: shape, dtype and device of a tensor, the
    value of anything else (a Python scalar is baked into a graph)."""
    if isinstance(a, torch.Tensor):
        return (tuple(a.shape), str(a.dtype), str(a.device))
    return ("value", a)


def _on_card(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args)


@contextlib.contextmanager
def _side_stream(args):
    """The stream the eager warm-up runs take: a side stream on the card
    (kept off the capture's), which the caller's stream waits for on the
    way out, so the state restored after the runs is written after them.
    That is an order on the card, not a wait of the host: a server on the
    same card replays meanwhile. Nothing on the CPU.

    Every dispatch's warm-up runs share one side stream a device: cuBLAS
    gives each stream its own workspace, which PyTorch keeps for the life
    of the process, so a fresh stream a capture left one workspace a
    bucket behind every served version a registry loaded, after the
    version was retired."""
    if not _on_card(args):
        yield
        return
    dev = next(a.device for a in args
               if isinstance(a, torch.Tensor) and a.is_cuda)
    current = torch.cuda.current_stream(dev)
    side = _WARMUP_STREAMS.get(dev)
    if side is None:
        side = _WARMUP_STREAMS.setdefault(dev, torch.cuda.Stream(dev))
    side.wait_stream(current)
    try:
        with torch.cuda.stream(side):
            yield
    finally:
        current.wait_stream(side)


def _record(fn, static_args, *, pool, stream):
    """Capture ``fn(*static_args)`` into a new CUDA graph on ``stream``
    (which first waits for the caller's stream) into the memory ``pool``
    of :meth:`CachedDispatch._capture_options`; returns ``(graph, static
    outputs)``. The capture is thread-local: another thread's calls
    meanwhile (a server replaying its own graphs, its synchronous copies
    to and from the card) neither invalidate it nor raise there.

    ``torch.cuda.graph`` is not used: its entry synchronizes the whole
    card and empties the caching allocator, which hands every other
    server's cached blocks back to CUDA (``cudaFree`` waits for the card)
    and holds the interpreter lock while it does, so each capture stalled
    a server that was serving beside it.

    The cyclic garbage collector is off while the capture runs: a network
    and its dispatches form a reference cycle, so an older network's
    graphs are freed by a collection, and a collection that an allocation
    set off inside the capture would free them on this thread mid-capture,
    which invalidates the capture."""
    graph = torch.cuda.CUDAGraph()
    collecting = gc.isenabled()
    gc.disable()
    try:
        t0 = time.perf_counter()
        stream.wait_stream(torch.cuda.current_stream(stream.device))
        with torch.cuda.stream(stream):
            graph.capture_begin(pool, capture_error_mode="thread_local")
            t1 = time.perf_counter()
            try:
                out = fn(*static_args)
            finally:
                graph.capture_end()
        _STATS["enter_seconds"] += t1 - t0
        _STATS["capture_seconds"] += time.perf_counter() - t1
    finally:
        if collecting:
            gc.enable()
    return graph, out


def _capturing(args) -> bool:
    """Whether this thread is capturing a graph on the card right now."""
    return any(isinstance(a, torch.Tensor) and a.is_cuda for a in args) \
        and torch.cuda.is_current_stream_capturing()


def _clone_out(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, (list, tuple)):
        return type(out)(_clone_out(o) for o in out)
    return out


class _Captured:
    """One signature's graph: static inputs and outputs, and the kernel
    launches recorded into it."""

    __slots__ = ("graph", "inputs", "outputs", "launches")

    def __init__(self, graph, inputs, outputs, launches):
        self.graph, self.inputs, self.outputs = graph, inputs, outputs
        self.launches = launches

    def run(self, args):
        for static, a in zip(self.inputs, args):
            if isinstance(static, torch.Tensor) \
                    and static.data_ptr() != a.data_ptr():
                static.copy_(a)
        self.graph.replay()
        ck.count_replay(self.launches)
        return _clone_out(self.outputs)


class CachedDispatch:
    """A function of tensors that replays one captured CUDA graph per
    argument signature.

    ``fn(*args)`` reads and writes its state in place; ``state()`` lists
    that state (every tensor ``fn`` writes besides its outputs), which
    capturing leaves as it found it. With ``always_capture`` a new
    signature on the card is captured at its first call; without it the
    dispatch calls ``fn`` eagerly until :meth:`warm` has captured some
    signature (the reference's "plain jit until warmed"), or until the
    disk tier is configured. On the CPU it
    always calls ``fn`` eagerly, and so does a call made while this thread
    captures another graph (a dispatch inside a captured function is
    recorded into that graph: captures do not nest).

    ``manifest(args)`` (optional) names a capture for the disk tier:
    ``(model, scope, entry)`` or None. With the tier configured, a
    capture whose entry the model's manifest names counts as a disk hit
    (``warm``); any other is a disk miss (``cold``) and is added.

    Each dispatch captures on a stream of its own, and its graphs share
    one memory pool (``torch.cuda.graph_pool_handle()``): a graph's
    intermediates may lie where another graph's did, which is safe
    because a call replays one graph and copies its outputs out before
    it returns; each entry keeps its own static inputs and outputs alive.
    """

    __slots__ = ("fn", "scope", "state", "always_capture", "manifest",
                 "_graphs", "_warned", "_pool", "_stream")

    def __init__(self, fn: Callable, scope: str,
                 state: Optional[Callable[[], List[torch.Tensor]]] = None,
                 always_capture: bool = False,
                 manifest: Optional[Callable] = None):
        self.fn = fn
        self.scope = scope
        self.state = state if state is not None else list
        self.always_capture = always_capture
        self.manifest = manifest
        self._graphs: Dict[tuple, object] = {}
        self._warned = False
        self._pool = None
        self._stream = None

    def _signature(self, args):
        return tuple(_leaf_signature(a) for a in args)

    def __call__(self, *args):
        if not _on_card(args) or _capturing(args) or (
                not self._graphs and not self.always_capture
                and cache_dir() is None):
            return self.fn(*args)
        sig = self._signature(args)
        entry = self._graphs.get(sig)
        if entry is _CAPTURE_FAILED:
            return self.fn(*args)
        if entry is not None:
            _STATS["memory_hits"] += 1
            _HITS_MEM.inc()
            return entry.run(args)
        _STATS["memory_misses"] += 1
        _MISS_MEM.inc()
        entry = self._acquire(args, sig)
        if entry is None:
            return self.fn(*args)
        return entry.run(args)

    def warm(self, *args) -> "CachedDispatch":
        """Capture the graph for this signature without changing any
        state (a no-op on the CPU)."""
        if _on_card(args) and not _capturing(args):
            sig = self._signature(args)
            if sig not in self._graphs:
                self._acquire(args, sig)
        return self

    def captures(self) -> int:
        """Captures attempted (successful or not): one per signature."""
        return len(self._graphs)

    def release(self) -> int:
        """Drop every captured graph, with its static buffers and the
        pool they share, so their memory goes back to the allocator (a
        pool lives until its graphs are dropped). Returns how many
        signatures were held; a later call captures again."""
        n = len(self._graphs)
        self._graphs.clear()
        self._pool = None
        self._stream = None
        return n

    def _capture_options(self, args) -> dict:
        """The stream and the pool of this dispatch's captures on the
        card; nothing on the CPU."""
        dev = next((a.device for a in args
                    if isinstance(a, torch.Tensor) and a.is_cuda), None)
        if dev is None:
            return {}
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
            self._pool = torch.cuda.graph_pool_handle()
        return {"stream": self._stream, "pool": self._pool}

    def warmed_signatures(self) -> int:
        return sum(1 for v in self._graphs.values()
                   if v is not _CAPTURE_FAILED)

    def launches_at_capture(self) -> List[Dict[str, int]]:
        """Each captured signature's kernel launches (what one replay
        runs)."""
        return [dict(v.launches) for v in self._graphs.values()
                if v is not _CAPTURE_FAILED]

    def _acquire(self, args, sig):
        """Warm-up runs under a state snapshot, then the capture. A
        failure in the warm-up runs is the function's own and raises; a
        failed capture parks the signature on the eager path."""
        t0 = time.perf_counter()
        static = tuple(a.detach().clone() if isinstance(a, torch.Tensor)
                       else a for a in args)
        with preserved(self.state()):
            with _side_stream(args):
                for _ in range(WARMUP_RUNS):
                    self.fn(*static)
        _STATS["warmup_seconds"] += time.perf_counter() - t0
        before = dict(ck.LAUNCHES)
        try:
            graph, out = _record(self.fn, static,
                                 **self._capture_options(args))
        except Exception as e:      # any capture error: eager from now on
            self._graphs[sig] = _CAPTURE_FAILED
            _STATS["capture_failures"] += 1
            _FAILURES.inc()
            if not self._warned:
                self._warned = True
                warnings.warn(
                    f"CUDA-graph capture [{self.scope}] failed "
                    f"({type(e).__name__}: {e}) — this signature runs "
                    "eagerly", stacklevel=3)
            return None
        launches = {k: v - before.get(k, 0) for k, v in ck.LAUNCHES.items()
                    if v != before.get(k, 0)}
        dt = time.perf_counter() - t0
        named = self.manifest(args) if self.manifest is not None \
            and disk_cache() is not None else None
        if named is None:
            note_cold_compile(dt)
        elif _manifest_record(*named):
            note_disk_hit(dt)
        else:
            note_disk_miss()
            note_cold_compile(dt)
        entry = _Captured(graph, static, out, launches)
        self._graphs[sig] = entry
        return entry


# ----------------------------------------------------------------- warmup
def _is_shape(spec) -> bool:
    return isinstance(spec, (tuple, list)) \
        and all(isinstance(d, int) for d in spec)


def warmup(target, shapes, *, steps_per_dispatch: int = 1, dtype=None,
           label_dtype=None, tbptt_length: int = None,
           strict: bool = False, cost=None, tuned: bool = False):
    """Capture ahead of the first dispatch.

    ``target`` is a ``ModelServer`` (delegates to its bucket-ladder
    ``warmup(shapes, strict=, cost=)``) or a network
    (``MultiLayerNetwork``/``ComputationGraph``).
    Each ``shapes`` entry is a ``(features_shape, labels_shape)`` pair:
    the train step for that per-batch signature is captured (K steps on
    ``[K, B, ...]`` buffers with ``steps_per_dispatch=K`` > 1), on zeros
    of ``dtype``/``label_dtype`` (fp32 by default). No state changes:
    params, updater state, running statistics and the clock come out as
    they went in. A bare feature shape warms a served forward: pass the
    ``ModelServer`` (a network's own ``output()`` is not captured yet).
    A ``MultiLayerNetwork`` under truncated BPTT (configured, or
    ``tbptt_length``) warms its window step for 3-D features instead.

    With the disk tier configured, a network's manifest is replayed
    first (every signature an earlier process captured). ``tuned=True``
    applies the tuning record for the model first (``tune.records``), so
    the captured steps are those the tuned fit dispatches; the plan's K
    takes over where the caller left the default."""
    if hasattr(target, "buckets") and hasattr(target, "submit"):
        if tuned:
            from deeplearning4j_tpu_torch.tune import records as _trecords
            m = getattr(target, "model", None)
            if m is not None:
                _trecords.auto_apply(m, context="warmup")
        kw = {}
        if strict:
            kw["strict"] = True
        if cost is not None:
            kw["cost"] = cost
        return target.warmup(shapes, **kw)
    model = target
    if tuned:
        from deeplearning4j_tpu_torch.tune import records as _trecords
        plan = _trecords.auto_apply(model, context="warmup")
        if plan is not None and steps_per_dispatch == 1:
            steps_per_dispatch = plan.steps_per_dispatch
    fdt = np.dtype(dtype) if dtype is not None else np.float32
    ldt = np.dtype(label_dtype) if label_dtype is not None else np.float32
    k = max(int(steps_per_dispatch), 1)
    lead = (k,) if k > 1 else ()
    for spec in shapes:
        if _is_shape(spec):
            raise ValueError(
                f"warmup shape spec {spec!r}: a network's inference forward "
                "is captured through the server — warmup(ModelServer(net), "
                "shapes) — or pass a (features_shape, labels_shape) pair")
        if not (isinstance(spec, (tuple, list)) and len(spec) == 2):
            raise ValueError(
                f"warmup shape spec {spec!r}: expected a (features_shape, "
                "labels_shape) pair (train step)")
    if hasattr(model, "_warm_dispatch"):
        warm_from_manifest(model)
    for fshape, lshape in shapes:
        extra = {} if tbptt_length is None else {"tbptt_length": tbptt_length}
        model._warm_dispatch(np.zeros(lead + tuple(fshape), fdt),
                             np.zeros(lead + tuple(lshape), ldt), steps=k,
                             **extra)
    return model


def warm_from_batch_signature(model, batch_sig: dict,
                              steps_per_dispatch: int = 1) -> bool:
    """Warm a train step from a recorded batch signature (``{"features":
    [shape, dtype], "labels": [...]}``, what :func:`describe_batch`
    gives). Best-effort: returns False (never raises) when the signature
    is absent or unusable."""
    if not batch_sig:
        return False
    try:
        f = batch_sig.get("features")
        lab = batch_sig.get("labels")
        if not f or not lab:
            return False
        warmup(model, [(tuple(f[0]), tuple(lab[0]))],
               steps_per_dispatch=steps_per_dispatch,
               dtype=f[1], label_dtype=lab[1])
        return True
    except Exception as e:
        warnings.warn(f"resume warmup skipped: {type(e).__name__}: {e}",
                      stacklevel=2)
        return False


def describe_batch(ds) -> Optional[dict]:
    """The batch signature :func:`warm_from_batch_signature` consumes:
    shapes and dtypes of a single-input DataSet without masks; None
    otherwise."""
    feats = getattr(ds, "features", None)
    labels = getattr(ds, "labels", None)
    if feats is None or labels is None \
            or isinstance(feats, (list, tuple)):
        return None
    try:
        sig = {"features": [list(feats.shape), _dtype_name(feats.dtype)],
               "labels": [list(labels.shape), _dtype_name(labels.dtype)]}
    except AttributeError:
        return None
    if getattr(ds, "features_mask", None) is not None \
            or getattr(ds, "labels_mask", None) is not None:
        return None                  # masked signatures: explicit warmup
    return sig


def _dtype_name(dt) -> str:
    """A numpy-readable dtype name for a numpy or torch dtype."""
    if isinstance(dt, torch.dtype):
        return str(dt).replace("torch.", "")
    return str(dt)
