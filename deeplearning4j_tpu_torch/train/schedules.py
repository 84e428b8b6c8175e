"""Learning-rate schedules (the slice's subset of
``deeplearning4j_tpu/train/schedules.py``): the constant schedule that
``resolve`` gives a plain float."""

from __future__ import annotations


class ISchedule:
    """``valueAt(iteration, epoch) -> value``. Subclasses are stateless."""

    def valueAt(self, iteration, epoch=0):
        raise NotImplementedError


class FixedSchedule(ISchedule):
    def __init__(self, value: float):
        self.value = float(value)

    def valueAt(self, iteration, epoch=0):
        return self.value


def resolve(lr) -> ISchedule:
    """Accept a float or an ISchedule."""
    if isinstance(lr, ISchedule):
        return lr
    return FixedSchedule(float(lr))
