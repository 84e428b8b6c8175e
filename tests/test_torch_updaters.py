"""The port's updaters with the step counter on the device (CPU).

A captured step reads ``t`` at replay, so ``lr_at``/``apply`` also take
``t`` as a 0-d tensor; on the CPU that gives the same bits as a Python
``t`` (both round the fp32 bias correction through ``powf``), and a
Python ``t`` gives what it gave before the device counter existed (the
numpy fp32 arithmetic, pinned here by recomputing it).
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.train import updaters as upd

T_VALUES = (0, 1, 2, 7, 99, 1000, 123456)


def _grad_state(seed=0, n=257):
    r = np.random.default_rng(seed)
    g = torch.from_numpy(r.standard_normal(n).astype(np.float32))
    m = torch.from_numpy(r.standard_normal(n).astype(np.float32) * 0.1)
    v = torch.from_numpy(np.abs(r.standard_normal(n)).astype(np.float32)
                         * 0.01)
    return g, {"m": m, "v": v}


@pytest.mark.parametrize("t", T_VALUES)
@pytest.mark.parametrize("make", [
    lambda: upd.Adam(1e-3), lambda: upd.Adam(0.05, beta1=0.8, beta2=0.99),
    lambda: upd.AdamW(1e-4, weight_decay=0.01), lambda: upd.Sgd(0.1)],
    ids=["adam", "adam_betas", "adamw", "sgd"])
def test_device_t_gives_the_bits_of_a_python_t(make, t):
    u = make()
    g, s = _grad_state(t % 5)
    t_dev = torch.tensor(t, dtype=torch.int32)
    lr_py, lr_dev = u.lr_at(t), u.lr_at(t_dev)
    up, sp = u.apply(g, s, lr_py, t)
    ud, sd = u.apply(g, s, lr_dev, t_dev)
    assert up.dtype == ud.dtype == torch.float32
    assert torch.equal(up, ud)
    for k in sp:
        assert torch.equal(sp[k], sd[k])


@pytest.mark.parametrize("t", T_VALUES)
def test_python_t_keeps_the_numpy_fp32_bias_correction(t):
    u = upd.Adam(1e-3)
    g, s = _grad_state(1)
    t1 = np.float32(t) + np.float32(1)
    one = np.float32(1)
    alpha = np.float32(1e-3) * np.sqrt(one - np.float32(0.999) ** t1) \
        / (one - np.float32(0.9) ** t1)
    m = 0.9 * s["m"] + (1 - 0.9) * g
    v = 0.999 * s["v"] + (1 - 0.999) * g.square()
    want = float(alpha) * m / (torch.sqrt(v) + 1e-8)
    got, _ = u.apply(g, s, 1e-3, t)
    assert torch.equal(got, want)
    assert u.alpha(1e-3, t) == float(alpha)
    a_dev = u.alpha(1e-3, torch.tensor(t, dtype=torch.int32))
    assert a_dev.dtype == torch.float32 and float(a_dev) == float(alpha)


def test_adamw_decay_is_lr_times_decay_times_param():
    u = upd.AdamW(0.1, weight_decay=0.5)
    p = torch.ones(3)
    assert torch.equal(u.weight_decay_update(p, 0.1), 0.1 * 0.5 * p)


def test_unported_updater_raises_by_name():
    # every updater of the JAX package is ported: an unknown class name
    # (none of the eleven) is what raises, by name
    with pytest.raises(ValueError, match="Lion"):
        upd.IUpdater.from_config({"@class": "Lion", "learning_rate": 0.1})


def test_device_alpha_is_computed_once_a_step():
    u = upd.Adam(1e-3)
    t = torch.tensor(3, dtype=torch.int32)
    a1 = u.alpha(1e-3, t)
    assert u.alpha(1e-3, t) is a1             # the same step: reused
    t.add_(1)
    a2 = u.alpha(1e-3, t)
    assert a2 is not a1 and float(a2) == u.alpha(1e-3, 4)
    assert "_alpha_memo" not in u.to_config()
    assert upd.IUpdater.from_config(u.to_config()).to_config() \
        == u.to_config()
