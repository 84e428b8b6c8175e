"""Learning-rate schedules (the slice's subset of
``deeplearning4j_tpu/train/schedules.py``): the constant schedule that
``resolve`` gives a plain float, with the JAX package's config JSON
(``{"@class": "FixedSchedule", "value": ...}``)."""

from __future__ import annotations


class ISchedule:
    """``valueAt(iteration, epoch) -> value``. Subclasses are stateless."""

    def valueAt(self, iteration, epoch=0):
        raise NotImplementedError

    def to_config(self):
        return {"@class": type(self).__name__, **self.__dict__}

    @staticmethod
    def from_config(d):
        d = dict(d)
        name = d.pop("@class")
        if name not in _SCHEDULES:
            raise ValueError(f"schedule {name!r} is not ported (known: "
                             f"{sorted(_SCHEDULES)})")
        obj = _SCHEDULES[name].__new__(_SCHEDULES[name])
        obj.__dict__.update(d)
        return obj


class FixedSchedule(ISchedule):
    def __init__(self, value: float):
        self.value = float(value)

    def valueAt(self, iteration, epoch=0):
        return self.value


_SCHEDULES = {c.__name__: c for c in (FixedSchedule,)}


def resolve(lr) -> ISchedule:
    """Accept a float or an ISchedule."""
    if isinstance(lr, ISchedule):
        return lr
    return FixedSchedule(float(lr))
