"""Continuous training as a service — the port of
``deeplearning4j_tpu/lifecycle/``.

The closed loop over the rest of the stack: a
:class:`~deeplearning4j_tpu_torch.lifecycle.driver.LifecycleDriver` runs
the trainer alongside the serving registry on one card, moving each
candidate through eval gate -> canary roll -> promote-or-rollback, with
its own state machine checkpointed
(:class:`~deeplearning4j_tpu_torch.train.resilience.DriverStateStore`)
so a SIGKILL anywhere resumes cleanly and the registry never serves an
inconsistent version. :class:`TrafficCapture` records served requests
(``ModelServer(capture=)``) into the eval set the gate scores on.
``python -m deeplearning4j_tpu_torch.lifecycle`` lints a lifecycle plan
(DL4J-W113/W114) before it runs.
"""

from .capture import TrafficCapture
from .driver import (LifecycleDriver, TrainerKilledError,
                     spawn_trainer_process)
from .gate import EvalGate, GatePolicy, GateVerdict

__all__ = [
    "EvalGate",
    "GatePolicy",
    "GateVerdict",
    "LifecycleDriver",
    "TrafficCapture",
    "TrainerKilledError",
    "spawn_trainer_process",
]
