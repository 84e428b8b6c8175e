"""ProfilingMode — unified op-execution profiling levels, the port of
``deeplearning4j_tpu/profiler/modes.py``.

Reference parity: ``org.nd4j.linalg.api.ops.executioner.OpExecutioner
.ProfilingMode`` (OFF / BASIC / NAN_PANIC / INF_PANIC). The instrumented
locks (:mod:`.locks`) record their wait/hold series whenever the mode is
not OFF.

Resolution order: an explicit ``set_profiling_mode(...)`` override wins;
otherwise the mode is derived from the
:class:`~deeplearning4j_tpu_torch.utils.environment.Environment` knobs
(``nan_panic``, ``inf_panic``, ``profiling``, from ``DL4J_TPU_NAN_PANIC``,
``DL4J_TPU_INF_PANIC``, ``DL4J_TPU_PROFILING``) on every read, so setting
``Environment.get().nan_panic`` or ``Environment.reset()`` after a change
of the environment takes effect at the next query.
"""

from __future__ import annotations

import enum
from typing import Optional

from deeplearning4j_tpu_torch.utils.environment import Environment


class ProfilingMode(enum.Enum):
    OFF = "off"            # no per-op instrumentation
    BASIC = "basic"        # per-op dispatch timing + counters
    NAN_PANIC = "nan_panic"  # BASIC + raise on NaN in op outputs/loss
    INF_PANIC = "inf_panic"  # BASIC + raise on Inf in op outputs/loss


_OVERRIDE: Optional[ProfilingMode] = None


def set_profiling_mode(mode: Optional[ProfilingMode]) -> None:
    """Set the process-wide mode; ``None`` reverts to Environment-derived."""
    global _OVERRIDE
    if mode is not None and not isinstance(mode, ProfilingMode):
        mode = ProfilingMode(str(mode).lower())
    _OVERRIDE = mode


def get_profiling_mode() -> ProfilingMode:
    if _OVERRIDE is not None:
        return _OVERRIDE
    # lock-free fast path: this sits on every eager dispatch, and reset()
    # swaps the instance (worst case one call reads the old one)
    env = Environment._instance
    if env is None:
        env = Environment.get()
    if env.nan_panic:
        return ProfilingMode.NAN_PANIC
    if env.inf_panic:
        return ProfilingMode.INF_PANIC
    if env.profiling:
        return ProfilingMode.BASIC
    return ProfilingMode.OFF
