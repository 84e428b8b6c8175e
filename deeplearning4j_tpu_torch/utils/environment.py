"""Central runtime environment / flag registry (the port of
``deeplearning4j_tpu/utils/environment.py``).

Reference parity: ND4J centralises every ``-D``/env knob in
``org.nd4j.common.config.{ND4JSystemProperties,ND4JEnvironmentVars}`` and
bridges JVM state to libnd4j's ``include/system/Environment.h`` via
``Nd4j.getEnvironment()``.

One process-wide :class:`Environment` singleton. Every knob has (a) a
typed attribute, (b) an environment-variable override (``DL4J_TPU_*``,
the JAX package's names, parsed the same way) and (c) a row in
:data:`KNOBS` saying what it steers in the port, so the registry is
introspectable (``Environment.describe()``). Knobs that name a setting
of the TPU runtime stay readable and steer nothing here; their rows say
so.

:class:`NumericsPanicError` lives here, as in the JAX package: the one
class that the NAN_PANIC/INF_PANIC gates (:func:`panic_check`,
``ops.registry.exec_op``, the fit loops of ``train.resilience`` and the
provenance sanitizer) raise.
"""

from __future__ import annotations

import os
import tempfile
import threading
from dataclasses import dataclass, field, fields
from typing import Any


def _env(name: str, default: Any, typ: type) -> Any:
    raw = os.environ.get(name)
    if raw is None:
        return default
    if typ is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    return typ(raw)


def _default_profile_dir() -> str:
    # the JAX package's /tmp/dl4j_tpu_profile, under the process's own
    # temporary directory (train.listeners.default_profile_dir)
    return os.path.join(tempfile.gettempdir(), "dl4j_tpu_profile")


@dataclass
class Environment:
    """Process-wide runtime flags (singleton via :meth:`get`)."""

    # -- debug / verbosity (ref: libnd4j Environment::setDebug/setVerbose) --
    debug: bool = field(default_factory=lambda: _env("DL4J_TPU_DEBUG", False, bool))
    verbose: bool = field(default_factory=lambda: _env("DL4J_TPU_VERBOSE", False, bool))

    # -- numerics (ref: OpExecutioner ProfilingMode NAN_PANIC/INF_PANIC) --
    nan_panic: bool = field(default_factory=lambda: _env("DL4J_TPU_NAN_PANIC", False, bool))
    inf_panic: bool = field(default_factory=lambda: _env("DL4J_TPU_INF_PANIC", False, bool))

    # -- the TPU runtime's MXU pass precision; read, steers nothing here --
    matmul_precision: str = field(
        default_factory=lambda: _env("DL4J_TPU_MATMUL_PRECISION", "bfloat16", str)
    )

    # -- profiling (ref: OpProfiler / ProfilingListener) --
    profiling: bool = field(default_factory=lambda: _env("DL4J_TPU_PROFILING", False, bool))
    profile_dir: str = field(
        default_factory=lambda: _env("DL4J_TPU_PROFILE_DIR", _default_profile_dir(), str))

    # -- the XLA compile cache; read, steers nothing here --
    compile_cache_dir: str = field(
        default_factory=lambda: _env("DL4J_TPU_COMPILE_CACHE", "", str)
    )

    # -- data pipeline --
    prefetch_buffer: int = field(default_factory=lambda: _env("DL4J_TPU_PREFETCH", 2, int))
    loader_threads: int = field(default_factory=lambda: _env("DL4J_TPU_LOADER_THREADS", 4, int))

    _instance = None
    _lock = threading.Lock()

    @classmethod
    def get(cls) -> "Environment":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def reset(cls) -> None:
        with cls._lock:
            cls._instance = None

    def describe(self) -> str:
        """Human-readable registry of every knob and its current value."""
        rows = []
        for f in fields(self):
            if f.name.startswith("_"):
                continue
            env_var = "DL4J_TPU_" + f.name.upper()
            rows.append(f"{f.name:<22} {env_var:<28} = {getattr(self, f.name)!r}")
        return "\n".join(rows)


KNOBS = {
    "debug": "Verbose per-op debug logging (ref: libnd4j Environment::setDebug): "
             "read, steers nothing in the port",
    "verbose": "Extra execution logging (ref: Environment::setVerbose): read, "
               "steers nothing in the port",
    "nan_panic": "Raise if any op output contains NaN (ref: ProfilingMode.NAN_PANIC; "
                 "profiler.modes reads it)",
    "inf_panic": "Raise if any op output contains Inf (ref: ProfilingMode.INF_PANIC; "
                 "profiler.modes reads it)",
    "matmul_precision": "The TPU's MXU pass precision (bfloat16|tensorfloat32|float32): "
                        "read, steers nothing in the port; a matmul computes in its "
                        "operands' dtype, TF32 only where torch.backends allows it",
    "profiling": "Enable per-op profiling (ref: OpProfiler; profiler.modes reads "
                 "it as ProfilingMode.BASIC)",
    "profile_dir": "Directory for Chrome-trace profiles (ref: ProfilingListener; "
                   "train.listeners.default_profile_dir reads it)",
    "compile_cache_dir": "The XLA persistent compile cache: read, steers nothing in the "
                         "port (CUDA kernels build under deeplearning4j_tpu_torch/_build)",
    "prefetch_buffer": "Async iterator prefetch depth (ref: AsyncDataSetIterator): "
                       "read, steers nothing in the port (the iterators take "
                       "their depth as an argument)",
    "loader_threads": "Host data-loading threads (ref: libnd4j Threads, data only): "
                      "read, steers nothing in the port",
}


class NumericsPanicError(ArithmeticError):
    """Raised by NAN_PANIC/INF_PANIC debug modes (ref: OpExecutioner
    ProfilingMode.NAN_PANIC / INF_PANIC) and by a non-finite loss the run
    cannot recover from (``train.resilience``)."""


def panic_check(value, context: str = "loss"):
    """Debug-mode numerics gate: under ``ProfilingMode.NAN_PANIC`` /
    ``INF_PANIC`` (set via ``profiler.set_profiling_mode`` or the
    ``DL4J_TPU_{NAN,INF}_PANIC`` env knobs — one unified mode, ref:
    OpExecutioner.ProfilingMode), read ``value`` on the host and raise on
    NaN/Inf with the training context. Costs a host sync per call — a
    DEBUG mode, off by default."""
    from deeplearning4j_tpu_torch.profiler.modes import (ProfilingMode,
                                                         get_profiling_mode)
    mode = get_profiling_mode()
    check_nan = mode is ProfilingMode.NAN_PANIC
    check_inf = mode is ProfilingMode.INF_PANIC
    if not (check_nan or check_inf):
        return
    import torch
    v = value.detach() if isinstance(value, torch.Tensor) \
        else torch.as_tensor(value)
    if not (v.is_floating_point() or v.is_complex()):
        return
    if check_nan and bool(torch.isnan(v).any()):
        raise NumericsPanicError(f"NAN_PANIC: NaN detected in {context}")
    if check_inf and bool(torch.isinf(v).any()):
        raise NumericsPanicError(f"INF_PANIC: Inf detected in {context}")
