"""The port's learning-rate schedules (``train/schedules.py``) against the
JAX package's, on the CPU.

Each of the nine schedules over t in [0, 200), on Python ints and on 0-d
int32 tensors (the networks' device clock), within rtol 1e-6 of the JAX
step's value (the JAX step hands its schedule the clock as fp32; a
Python int gives the port's tensor value, as a float). Against the JAX
schedule evaluated on Python ints the tolerance is 3e-6: there
``ExponentialSchedule`` stays in Python's float64 (``gamma ** t``),
while its fp32 path raises gamma rounded to fp32, which differs by up
to 1.96e-6 at gamma=0.99, t=199 in the JAX package itself. Their config
JSON crosses both ways. The train step passes no epoch in either
package, so an ``schedule_type="epoch"`` schedule stays at epoch 0
there (pinned on both sides).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.train import schedules as jsch
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch.train import schedules as sch
from deeplearning4j_tpu_torch.train import updaters as upd

T = range(200)

#: (name, constructor arguments) for both packages; Ramp wraps a Step
CASES = [
    ("FixedSchedule", (0.05,)),
    ("StepSchedule", ("iteration", 0.1, 0.5, 16)),
    ("ExponentialSchedule", ("iteration", 0.1, 0.99)),
    ("InverseSchedule", ("iteration", 0.1, 0.01, 2.0)),
    ("PolySchedule", ("iteration", 0.1, 2.0, 150)),
    ("SigmoidSchedule", ("iteration", 0.1, 0.05, 100)),
    ("MapSchedule", ("iteration", {0: 0.1, 50: 0.05, 120: 0.01})),
    ("CycleSchedule", ("iteration", 0.01, 0.1, 100, 20, 0.01)),
    ("RampSchedule", None),
]


def make(mod, name, args):
    if name == "RampSchedule":
        return mod.RampSchedule(mod.StepSchedule("iteration", 0.2, 0.5, 40),
                                30)
    return getattr(mod, name)(*args)


def jax_values(s, ts, as_f32: bool):
    return np.asarray([float(np.asarray(s.valueAt(
        jnp.float32(t) if as_f32 else t))) for t in ts], np.float64)


@pytest.mark.parametrize("name,args", CASES, ids=[c[0] for c in CASES])
def test_schedule_matches_jax(name, args):
    ours, theirs = make(sch, name, args), make(jsch, name, args)
    py = np.asarray([ours.valueAt(t) for t in T])
    dev = [ours.valueAt(torch.tensor(t, dtype=torch.int32)) for t in T]
    assert all(isinstance(v, float) for v in py)
    if name != "FixedSchedule":
        # the step's clock: fp32 tensor math, no host read
        assert all(isinstance(v, torch.Tensor) and v.dtype == torch.float32
                   for v in dev)
    dev = np.asarray([float(v) for v in dev])
    # a Python int gives the tensor path's fp32 value
    np.testing.assert_array_equal(py, dev)
    np.testing.assert_allclose(dev, jax_values(theirs, T, True), rtol=1e-6)
    np.testing.assert_allclose(py, jax_values(theirs, T, False), rtol=3e-6)

    # the config JSON, both ways
    ours_back = jsch.ISchedule.from_config(
        json.loads(json.dumps(ours.to_config())))
    theirs_back = sch.ISchedule.from_config(
        json.loads(json.dumps(theirs.to_config())))
    assert type(ours_back).__name__ == type(theirs_back).__name__ == name
    np.testing.assert_allclose(jax_values(ours_back, T, True), py,
                               rtol=1e-6)
    np.testing.assert_array_equal(
        [theirs_back.valueAt(t) for t in T], py)


def test_updater_config_carries_the_schedule_both_ways():
    ours = upd.Nesterovs(sch.StepSchedule("iteration", 0.1, 0.1, 16),
                         momentum=0.9)
    theirs = jupd.IUpdater.from_config(json.loads(json.dumps(
        ours.to_config())))
    assert isinstance(theirs, jupd.Nesterovs) and theirs.momentum == 0.9
    back = upd.IUpdater.from_config(json.loads(json.dumps(
        theirs.to_config())))
    for t in (0, 15, 16, 40):
        assert back.lr_at(t) == ours.lr_at(t)
        assert abs(float(np.asarray(theirs.lr_at(t))) - ours.lr_at(t)) \
            <= 1e-6 * ours.lr_at(t)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_an_epoch_schedule_stays_at_epoch_0_in_the_train_step(pkg):
    """Both packages' steps call ``updater.lr_at(t)`` with no epoch, so
    a schedule on epochs never leaves its initial value there."""
    mod, umod = (sch, upd) if pkg == "port" else (jsch, jupd)
    u = umod.Sgd(mod.StepSchedule("epoch", 0.1, 0.5, 1))
    t = torch.tensor(500, dtype=torch.int32) if pkg == "port" \
        else jnp.float32(500)
    assert float(np.asarray(u.lr_at(t))) == pytest.approx(0.1, rel=1e-7)
    # given an epoch, the schedule itself does decay
    assert float(np.asarray(u.learning_rate.valueAt(0, 3))) == \
        pytest.approx(0.0125, rel=1e-6)


def test_map_schedule_needs_t0_and_ramp_warms_up():
    with pytest.raises(ValueError):
        sch.MapSchedule("iteration", {5: 0.1})
    r = sch.RampSchedule(sch.FixedSchedule(1.0), 4)
    assert [r.valueAt(t) for t in range(6)] == [0.25, 0.5, 0.75, 1.0, 1.0,
                                                1.0]
