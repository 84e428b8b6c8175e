"""Learning-rate (and value) schedules — the port of
``deeplearning4j_tpu/train/schedules.py``: ``FixedSchedule``,
``StepSchedule``, ``ExponentialSchedule``, ``InverseSchedule``,
``PolySchedule``, ``SigmoidSchedule``, ``MapSchedule``,
``CycleSchedule`` and ``RampSchedule``, with the JAX package's config
JSON (``{"@class": "StepSchedule", ...}``), so a configuration saved by
either package loads in the other.

``valueAt(iteration, epoch)`` runs inside the train step, where the
iteration is the networks' 0-d int32 device clock: on a tensor it is
fp32 torch math on the clock's device (``torch.floor``, ``torch.pow``,
``torch.where`` chains for ``MapSchedule``/``CycleSchedule``/
``RampSchedule``), never a host read, so a captured step evaluates the
schedule at every replay. On a Python int it returns the same fp32 value
as a Python float (the tensor path on a CPU scalar). ``FixedSchedule``
returns its Python float either way, so a constant rate adds no launch.

The train step passes no epoch (the JAX step's ``lr_at(t)``): a schedule
with ``schedule_type="epoch"`` stays at epoch 0 there, in both packages.
"""

from __future__ import annotations

import torch


class ISchedule:
    """``valueAt(iteration, epoch) -> value``. Subclasses are stateless
    and define ``_at(t)`` on a 0-d fp32 tensor ``t``."""

    def valueAt(self, iteration, epoch=0):
        t = iteration if getattr(self, "schedule_type", "iteration") \
            == "iteration" else epoch
        if isinstance(t, torch.Tensor):
            return self._at(t.float())
        return float(self._at(torch.tensor(float(t), dtype=torch.float32)))

    def __call__(self, iteration, epoch=0):
        return self.valueAt(iteration, epoch)

    def _at(self, t: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def to_config(self):
        return {"@class": type(self).__name__, **self.__dict__}

    @staticmethod
    def from_config(d):
        d = dict(d)
        name = d.pop("@class")
        if name == "RampSchedule":
            return RampSchedule(ISchedule.from_config(d["base"]),
                                d["num_iter"])
        if name == "MapSchedule":
            # through __init__ so JSON string keys come back as ints
            return MapSchedule(d["schedule_type"], d["values"])
        if name not in _SCHEDULES:
            raise ValueError(f"unknown schedule {name!r} (known: "
                             f"{sorted(_SCHEDULES)})")
        obj = _SCHEDULES[name].__new__(_SCHEDULES[name])
        obj.__dict__.update(d)
        return obj


class FixedSchedule(ISchedule):
    def __init__(self, value: float):
        self.value = float(value)

    def valueAt(self, iteration, epoch=0):
        return self.value


class StepSchedule(ISchedule):
    """value * decayRate^floor(t/step) (ref: StepSchedule)."""

    def __init__(self, schedule_type: str = "iteration",
                 initial_value: float = 0.1, decay_rate: float = 0.5,
                 step: float = 1000):
        self.schedule_type = schedule_type
        self.initial_value = float(initial_value)
        self.decay_rate = float(decay_rate)
        self.step = float(step)

    def _at(self, t):
        return self.initial_value * torch.pow(
            self.decay_rate, torch.floor(t / self.step))


class ExponentialSchedule(ISchedule):
    """value * gamma^t (ref: ExponentialSchedule)."""

    def __init__(self, schedule_type: str = "iteration",
                 initial_value: float = 0.1, gamma: float = 0.999):
        self.schedule_type = schedule_type
        self.initial_value = float(initial_value)
        self.gamma = float(gamma)

    def _at(self, t):
        return self.initial_value * torch.pow(self.gamma, t)


class InverseSchedule(ISchedule):
    """value / (1 + gamma*t)^power (ref: InverseSchedule)."""

    def __init__(self, schedule_type: str = "iteration",
                 initial_value: float = 0.1, gamma: float = 0.001,
                 power: float = 1.0):
        self.schedule_type = schedule_type
        self.initial_value = float(initial_value)
        self.gamma = float(gamma)
        self.power = float(power)

    def _at(self, t):
        return self.initial_value / torch.pow(1.0 + self.gamma * t,
                                              self.power)


class PolySchedule(ISchedule):
    """value * (1 - t/maxIter)^power (ref: PolySchedule)."""

    def __init__(self, schedule_type: str = "iteration",
                 initial_value: float = 0.1, power: float = 1.0,
                 max_iter: int = 10000):
        self.schedule_type = schedule_type
        self.initial_value = float(initial_value)
        self.power = float(power)
        self.max_iter = int(max_iter)

    def _at(self, t):
        frac = torch.clamp(t / self.max_iter, 0.0, 1.0)
        return self.initial_value * torch.pow(1.0 - frac, self.power)


class SigmoidSchedule(ISchedule):
    """value / (1 + exp(gamma*(t - stepSize))) (ref: SigmoidSchedule)."""

    def __init__(self, schedule_type: str = "iteration",
                 initial_value: float = 0.1, gamma: float = 0.01,
                 step_size: int = 1000):
        self.schedule_type = schedule_type
        self.initial_value = float(initial_value)
        self.gamma = float(gamma)
        self.step_size = int(step_size)

    def _at(self, t):
        return self.initial_value / (
            1.0 + torch.exp(self.gamma * (t - self.step_size)))


class MapSchedule(ISchedule):
    """Piecewise constant from ``{iteration: value}`` (ref: MapSchedule):
    a chain of ``torch.where`` over the sorted keys."""

    def __init__(self, schedule_type: str = "iteration", values: dict = None):
        self.schedule_type = schedule_type
        self.values = {int(k): float(v) for k, v in (values or {}).items()}
        if 0 not in self.values:
            raise ValueError("MapSchedule requires a value for t=0")

    def _at(self, t):
        out = torch.full_like(t, self.values[0])
        for k in sorted(self.values):
            out = torch.where(t >= k, torch.full_like(t, self.values[k]),
                              out)
        return out


class CycleSchedule(ISchedule):
    """1cycle policy (ref: CycleSchedule): ramp up to maxLR, down to
    initial, then anneal to initial * annealing_decay over the final
    annealing_length steps."""

    def __init__(self, schedule_type: str = "iteration",
                 initial_value: float = 0.01, max_value: float = 0.1,
                 cycle_length: int = 1000, annealing_length: int = 100,
                 annealing_decay: float = 0.01):
        self.schedule_type = schedule_type
        self.initial_value = float(initial_value)
        self.max_value = float(max_value)
        self.cycle_length = int(cycle_length)
        self.annealing_length = int(annealing_length)
        self.annealing_decay = float(annealing_decay)

    def _at(self, t):
        ramp = (self.cycle_length - self.annealing_length) / 2
        span = float(max(ramp, 1))
        pos = torch.remainder(t, self.cycle_length)
        rise = self.max_value - self.initial_value
        up = self.initial_value + rise * (pos / span)
        down = self.max_value - rise * ((pos - ramp) / span)
        anneal_pos = (pos - 2 * ramp) / float(max(self.annealing_length, 1))
        anneal = self.initial_value * (
            1.0 - (1.0 - self.annealing_decay) * anneal_pos)
        return torch.where(pos < ramp, up,
                           torch.where(pos < 2 * ramp, down, anneal))


class RampSchedule(ISchedule):
    """Linear warmup wrapper (ref: RampSchedule): the base schedule
    scaled by (t+1)/numIter for the first numIter steps."""

    def __init__(self, base: ISchedule, num_iter: int):
        self.base = base
        self.num_iter = int(num_iter)

    def valueAt(self, iteration, epoch=0):
        if not isinstance(iteration, torch.Tensor):
            return float(self.valueAt(
                torch.tensor(float(iteration), dtype=torch.float32), epoch))
        scale = torch.clamp((iteration.float() + 1) / self.num_iter,
                            0.0, 1.0)
        return scale * self.base.valueAt(iteration, epoch)

    def to_config(self):
        return {"@class": "RampSchedule", "base": self.base.to_config(),
                "num_iter": self.num_iter}


_SCHEDULES = {c.__name__: c for c in
              (FixedSchedule, StepSchedule, ExponentialSchedule,
               InverseSchedule, PolySchedule, SigmoidSchedule, MapSchedule,
               CycleSchedule, RampSchedule)}


def resolve(lr) -> ISchedule:
    """Accept a float or an ISchedule."""
    if isinstance(lr, ISchedule):
        return lr
    return FixedSchedule(float(lr))
