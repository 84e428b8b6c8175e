"""Recompile-churn detector — the port of
``deeplearning4j_tpu/analysis/churn.py``.

On the card a new dispatch signature costs one CUDA-graph capture (warm-up
steps, then the capture: :mod:`deeplearning4j_tpu_torch.nn.compilecache`),
as a new jit signature costs one XLA compile in the JAX package. A
training loop whose batch shapes drift recaptures over and over. The
networks' ``_fit_one``/``_fit_mega`` report each dispatch's fingerprint
here; the detector counts distinct signatures per site into the metrics
registry (``dl4j_recompiles_total{site=...}``) and emits a ``DL4J-W201``
diagnostic (plus one Python warning) the first time a site crosses the
threshold (``DL4J_TPU_RECOMPILE_CHURN_THRESHOLD``, default 8, read when
the detector is built).

Fingerprints are built from duck-typed ``.shape``/``.dtype`` (and, for a
tensor, ``.device``) so numpy arrays and tensors both work.
"""

from __future__ import annotations

import os
import threading
import warnings
from typing import Dict, List, Optional, Set, Tuple

from deeplearning4j_tpu_torch.analysis.diagnostics import Diagnostic, Severity


def _default_threshold() -> int:
    """Read at detector construction, not at import."""
    return int(os.environ.get("DL4J_TPU_RECOMPILE_CHURN_THRESHOLD", "8"))


def array_fingerprint(*arrays) -> Tuple:
    """Dispatch-cache-equivalent signature of a positional argument list:
    (shape, dtype, weak_type, device) per array, None passed through,
    lists and tuples nested. Two calls with equal fingerprints replay the
    same captured step; a new fingerprint is a new capture."""
    out = []
    for a in arrays:
        if a is None:
            out.append(None)
        elif isinstance(a, (list, tuple)):
            out.append(array_fingerprint(*a))
        else:
            dev = getattr(a, "device", None)
            out.append((tuple(getattr(a, "shape", ())),
                        str(getattr(a, "dtype", type(a).__name__)),
                        bool(getattr(a, "weak_type", False)),
                        None if dev is None else str(dev)))
    return tuple(out)


class RecompileChurnDetector:
    """Counts distinct dispatch signatures per site.

    ``record(site, fingerprint, owner=...)`` is the hot-path call: one
    set lookup when the signature was already seen. ``owner`` scopes the
    threshold bookkeeping (two models sharing a site string do not pool
    their signatures); the metrics label stays the coarse ``site`` name.
    """

    def __init__(self, threshold: int = None, registry=None):
        from deeplearning4j_tpu_torch.profiler.metrics import get_registry
        self.threshold = _default_threshold() if threshold is None \
            else int(threshold)
        self._counter = (registry or get_registry()).counter(
            "dl4j_recompiles_total",
            "Distinct dispatch signatures captured per dispatch site (a "
            "value that keeps growing during steady-state training is "
            "churn)", labelnames=("site",))
        self._lock = threading.Lock()
        self._seen: Dict[Tuple[str, int], Set] = {}
        self._flagged: Set[Tuple[str, int]] = set()
        self._diags: List[Tuple[Optional[int], Diagnostic]] = []

    def record(self, site: str, fingerprint,
               owner=None) -> Optional[Diagnostic]:
        """Report one dispatch signature; returns the W201 diagnostic the
        first time ``site`` (scoped to ``owner``) crosses the threshold."""
        key = (site, id(owner) if owner is not None else 0)
        # lock-free fast path: a GIL-safe dict/set read suffices once the
        # signature has been seen (the steady-state case)
        seen = self._seen.get(key)
        if seen is not None and fingerprint in seen:
            return None
        with self._lock:
            seen = self._seen.get(key)
            if seen is None:
                seen = self._seen[key] = set()
            if fingerprint in seen:
                return None
            seen.add(fingerprint)
            n = len(seen)
            crossed = n > self.threshold and key not in self._flagged
            if crossed:
                self._flagged.add(key)
        self._counter.labels(site=site).inc()
        if not crossed:
            return None
        diag = Diagnostic(
            "DL4J-W201", Severity.WARNING, site,
            f"{n} distinct dispatch signatures at this site (threshold "
            f"{self.threshold}) — shifting batch shapes/dtypes are forcing "
            f"repeated captures",
            fix_hint="pad or bucket batches to a fixed shape (e.g. drop/pad "
                     "the ragged final batch) and pin input dtypes")
        with self._lock:
            self._diags.append((key[1] or None, diag))
        warnings.warn(f"{diag.code} [{site}]: {diag.message}",
                      RuntimeWarning, stacklevel=2)
        return diag

    def signature_count(self, site: str, owner=None) -> int:
        key = (site, id(owner) if owner is not None else 0)
        with self._lock:
            return len(self._seen.get(key, ()))

    def diagnostics_for(self, owner=None) -> List[Diagnostic]:
        """Findings scoped to ``owner`` (plus unscoped sites when
        ``owner`` is None)."""
        oid = None if owner is None else id(owner)
        with self._lock:
            return [d for o, d in self._diags
                    if o == oid or (owner is not None and o is None)]

    def reset(self) -> None:
        with self._lock:
            self._seen.clear()
            self._flagged.clear()
            self._diags.clear()


_DETECTOR: Optional[RecompileChurnDetector] = None
_DETECTOR_LOCK = threading.Lock()


def get_churn_detector() -> RecompileChurnDetector:
    """Process-wide detector the dispatch seams report into."""
    global _DETECTOR
    if _DETECTOR is None:
        with _DETECTOR_LOCK:
            if _DETECTOR is None:
                _DETECTOR = RecompileChurnDetector()
    return _DETECTOR
