"""Seeded elastic sweeps over ranks (the chaos half of the JAX package's
``tests/test_elastic.py``, split from ``test_torch_elastic_mesh.py`` so
neither file runs long): whatever step and rank the seed draws for a
rank's loss, with a NaN batch riding along under each NaN policy, a
checkpointed elastic ``ParallelWrapper`` fit over 2 spawned gloo ranks
shrinks, finishes and ends finite; a seeded hung dispatch is a
straggler. The draws are ``FaultPlan.seeded``'s, the JAX package's. The
cases share one pool, put back into a whole group before each case."""

import numpy as np
import pytest

from deeplearning4j_tpu_torch.parallel.launch import RankPool

from test_torch_elastic_mesh import DEADLINE, NBATCH, rank_elastic


@pytest.fixture(scope="module")
def _pool(tmp_path_factory):
    with RankPool(2, str(tmp_path_factory.mktemp("store")),
                  device="cpu") as p:
        yield p


@pytest.fixture()
def pool(_pool):
    _pool.regroup()
    return _pool


# ===================================================================== chaos
@pytest.mark.chaos
class TestElasticChaosSweep:
    """Seeded sweeps: whatever step and rank the seed draws for the loss,
    with a NaN batch riding along, a checkpointed elastic fit shrinks,
    finishes and ends finite."""

    @pytest.mark.parametrize("policy", ["SKIP_STEP", "BACKOFF_LR",
                                        "ROLLBACK"])
    @pytest.mark.parametrize("seed", range(2))
    def test_device_loss_times_nan_policy(self, pool, seed, policy,
                                          tmp_path):
        from deeplearning4j_tpu_torch.faults import FaultPlan
        plan = FaultPlan.seeded(seed, horizon=NBATCH - 1, n_nan=1,
                                n_data_errors=0, device_loss=1,
                                device_pool=range(2))
        lost = sorted(plan.lose_devices)
        kw = {"nan_grads_at": sorted(plan.nan_grads_at),
              "device_loss_at_step": plan.device_loss_at_step,
              "lose_devices": lost}
        res = pool.run(rank_elastic, str(tmp_path / "c"), kw,
                       ck_kw={"every_steps": 2, "io_backoff": 0.01},
                       nan_policy=policy)
        assert [res[r] for r in lost] == [{"lost": True}]
        (out,) = [o for o in res if o != {"lost": True}]
        if policy == "ROLLBACK":
            assert NBATCH - 3 <= out["iteration"] <= NBATCH
        else:
            assert out["iteration"] == NBATCH
        assert np.isfinite(out["params"]).all() and out["data"] == 1

    def test_the_writers_of_one_fit_share_its_job_id(self, pool, tmp_path):
        # rank 0 writes every step until its loss, the survivor the shrink's
        # checkpoint and the rest: one job id over both, so neither's save
        # of the agreed step deletes the other's
        from deeplearning4j_tpu_torch.train.resilience import (
            CheckpointConfig, CheckpointManager)
        d = str(tmp_path / "c")
        res = pool.run(rank_elastic, d, {"device_loss_at_step": 5,
                                         "lose_devices": [0]},
                       ck_kw={"every_steps": 1, "keep_last": 2 * NBATCH,
                              "io_backoff": 0.01})
        assert res[0] == {"lost": True} and res[1]["iteration"] == NBATCH
        mgr = CheckpointManager(CheckpointConfig(d))
        steps = [s for s, _ in mgr.checkpoints()]
        assert steps[0] < 5 and steps[-1] == NBATCH
        assert len({mgr.validate(p)["job"]
                    for _, p in mgr.checkpoints()}) == 1

    @pytest.mark.parametrize("seed", range(2))
    def test_hung_dispatch_sweep(self, pool, seed, tmp_path):
        rng = np.random.RandomState(seed)
        step = int(rng.randint(3, NBATCH))
        res = pool.run(rank_elastic, str(tmp_path / "c"),
                       {"hung_dispatch_at": [step],
                        "hang_seconds": 2 * DEADLINE},
                       cfg_kw={"watchdog_deadline": DEADLINE,
                               "watchdog_grace": 30.0})
        for o in res:
            assert o["iteration"] == NBATCH and o["timeouts"] == 1
            assert np.isfinite(o["params"]).all()
