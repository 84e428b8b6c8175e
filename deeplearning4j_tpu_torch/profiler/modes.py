"""ProfilingMode — unified op-execution profiling levels, the port of
``deeplearning4j_tpu/profiler/modes.py``.

Reference parity: ``org.nd4j.linalg.api.ops.executioner.OpExecutioner
.ProfilingMode`` (OFF / BASIC / NAN_PANIC / INF_PANIC). The instrumented
locks (:mod:`.locks`) record their wait/hold series whenever the mode is
not OFF.

Resolution order: an explicit ``set_profiling_mode(...)`` override wins;
otherwise the mode comes from the same environment knobs the JAX
package's ``Environment`` reads (``DL4J_TPU_NAN_PANIC``,
``DL4J_TPU_INF_PANIC``, ``DL4J_TPU_PROFILING``), read once at the first
query and again after ``set_profiling_mode(None)``.
"""

from __future__ import annotations

import enum
import os
from typing import Optional


class ProfilingMode(enum.Enum):
    OFF = "off"            # no per-op instrumentation
    BASIC = "basic"        # per-op dispatch timing + counters
    NAN_PANIC = "nan_panic"  # BASIC + raise on NaN in op outputs/loss
    INF_PANIC = "inf_panic"  # BASIC + raise on Inf in op outputs/loss


_OVERRIDE: Optional[ProfilingMode] = None
_FROM_ENV: Optional[ProfilingMode] = None


def _flag(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in ("1", "true", "yes",
                                                        "on")


def _env_mode() -> ProfilingMode:
    if _flag("DL4J_TPU_NAN_PANIC"):
        return ProfilingMode.NAN_PANIC
    if _flag("DL4J_TPU_INF_PANIC"):
        return ProfilingMode.INF_PANIC
    if _flag("DL4J_TPU_PROFILING"):
        return ProfilingMode.BASIC
    return ProfilingMode.OFF


def set_profiling_mode(mode: Optional[ProfilingMode]) -> None:
    """Set the process-wide mode; ``None`` reverts to the environment."""
    global _OVERRIDE, _FROM_ENV
    if mode is not None and not isinstance(mode, ProfilingMode):
        mode = ProfilingMode(str(mode).lower())
    _OVERRIDE = mode
    _FROM_ENV = None


def get_profiling_mode() -> ProfilingMode:
    global _FROM_ENV
    if _OVERRIDE is not None:
        return _OVERRIDE
    if _FROM_ENV is None:
        _FROM_ENV = _env_mode()
    return _FROM_ENV
