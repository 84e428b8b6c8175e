"""The port's eleven updaters (``train/updaters.py``) against the JAX
package's, on the CPU.

Each updater takes 5 steps on the same gradients from the same params,
the port with the clock as a 0-d int32 tensor (the networks' device
clock) and the JAX one with it as fp32 (what the JAX step hands it):
updates, states and params within rtol 1e-6 (atol 1e-9) in fp32. A
schedule-driven rate and the ``_lr_scale`` knob ride along; the scale
of a network's step, once a device tensor, changes in place and the
step's dispatch stays the one captured.
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

from test_torch_compilecache import fake_capture  # noqa: F401
from test_torch_stepping import make_batches, mlp

torch.set_num_threads(2)

#: (name, constructor arguments) — the same in both packages
CASES = [
    ("Sgd", (0.1,)),
    ("NoOp", ()),
    ("Adam", (0.01,)),
    ("AdamW", (0.01, 0.9, 0.999, 1e-8, 0.05)),
    ("AMSGrad", (0.02, 0.8, 0.99)),
    ("AdaMax", (0.02,)),
    ("Nadam", (0.01,)),
    ("Nesterovs", (0.05, 0.9)),
    ("RmsProp", (0.01, 0.9)),
    ("AdaGrad", (0.1,)),
    ("AdaDelta", (0.9, 1e-6)),
]


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("name,args", CASES, ids=[c[0] for c in CASES])
def test_updater_matches_jax_for_five_steps(name, args):
    ours, theirs = getattr(upd, name)(*args), getattr(jupd, name)(*args)
    rng = np.random.default_rng(3)
    p0 = rng.standard_normal((7, 5)).astype(np.float32)
    p, jp = torch.from_numpy(p0.copy()), jnp.asarray(p0)
    s, js = ours.init_state(p), theirs.init_state(jp)
    for t in range(5):
        g0 = rng.standard_normal((7, 5)).astype(np.float32)
        t_dev = torch.tensor(t, dtype=torch.int32)
        u, s = ours.apply(torch.from_numpy(g0), s, ours.lr_at(t_dev), t_dev)
        ju, js = theirs.apply(jnp.asarray(g0), js,
                              theirs.lr_at(jnp.float32(t)), jnp.float32(t))
        if name == "AdamW":
            u = u + ours.weight_decay_update(p, ours.lr_at(t_dev))
            ju = ju + theirs.weight_decay_update(jp, theirs.lr_at(t))
        assert u.dtype == torch.float32
        _close(u, ju)
        assert sorted(s) == sorted(js)
        for k in s:
            _close(s[k], js[k])
        p, jp = p - u, jp - ju
        _close(p, jp)
    # the configuration crosses both ways
    back = jupd.IUpdater.from_config(json.loads(json.dumps(
        ours.to_config())))
    assert type(back).__name__ == name
    again = upd.IUpdater.from_config(json.loads(json.dumps(
        theirs.to_config())))
    assert again.to_config() == ours.to_config()


def test_a_scheduled_and_scaled_rate_matches_jax():
    ours = upd.Nesterovs(sch.StepSchedule("iteration", 0.1, 0.1, 2), 0.9)
    theirs = jupd.Nesterovs(jsch.StepSchedule("iteration", 0.1, 0.1, 2), 0.9)
    ours._lr_scale = torch.tensor(0.25)
    theirs._lr_scale = 0.25
    for t in range(5):
        got = float(ours.lr_at(torch.tensor(t, dtype=torch.int32)))
        want = float(np.asarray(theirs.lr_at(jnp.float32(t))))
        assert got == pytest.approx(want, rel=1e-6)
    assert "_lr_scale" not in ours.to_config()


def test_the_lr_scale_changes_in_place_without_a_new_capture(fake_capture):
    batches = make_batches(4)
    net = mlp(updater=upd.Sgd(0.1))
    net._ensure_step_state()
    scale = net._ensure_lr_scale()
    net.fit(batches[:2], steps_per_dispatch=2)      # captured at once
    assert len(fake_capture) == 1
    ptr = scale.data_ptr()
    net._set_lr_scale(0.5)
    assert net.lr_scale() == 0.5 and float(scale) == 0.5
    assert net._ensure_lr_scale() is scale and scale.data_ptr() == ptr
    net.fit(batches[2:], steps_per_dispatch=2)      # replayed
    assert len(fake_capture) == 1 and fake_capture[0].replays == 2
    assert list(net._step_cache) == [(False, False, 2, "lr_scale")]
    # half the rate from then on: a net that took the first two steps at
    # 0.1 and the next two at 0.05
    ref = mlp(updater=upd.Sgd(0.1))
    ref.fit(batches[:2], steps_per_dispatch=2)
    ref.conf.base.updater.learning_rate = sch.FixedSchedule(0.05)
    ref._step_cache = {}
    ref.fit(batches[2:], steps_per_dispatch=2)
    for a, b in zip(net._snapshot_tensors(), ref._snapshot_tensors()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
