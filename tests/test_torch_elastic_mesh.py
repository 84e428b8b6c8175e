"""Elastic training over ranks (``deeplearning4j_tpu_torch.parallel.
elastic``) held against the JAX package's ``tests/test_elastic.py``.

A lost device is a lost rank: the port's cases run on spawned gloo
ranks on the CPU, and a planned ``FaultPlan(device_loss_at_step=k,
lose_devices=[r])`` (given to every rank, as the JAX test gives its plan
to the one process) makes rank r raise ``RankLostError`` at step k (its
task returns, where a real one would exit: chip_smoke's phase 42 and
``test_torch_multihost.py`` exit the process); the survivors agree on
the step, form a smaller group and resume. The cases share one pool of
2 ranks and one of 4, put back into a whole group before each case
(``RankPool.regroup``).
Where the JAX test compares with a fresh small-mesh fit resumed from the
coordinated checkpoint, the port's reference runs on the survivors' new
group (or, at one rank, in this process). Bit-equal where the JAX test
pins it. The watchdog and coordinator cases run in this process against
the JAX classes on the same inputs. ``TestParallelInferenceRobustness``
serves over the 2 ranks through the leader/follower dispatch (rank 0
serves, rank 1 follows; each rank wraps its own copy of the net in the
JAX test's flaky model, so a fault is every rank's): the JAX tests' 8
devices become 2 ranks, the dead devices 4-7 rank 1, and the tensor-
parallel ``data=4 x model=2`` mesh ``data=1 x model=2``; outputs within
the JAX tests' ``rtol=1e-4, atol=1e-5`` of the JAX net's.
"""

import threading
import time

import numpy as np
import pytest

from deeplearning4j_tpu_torch.parallel.launch import RankPool

NIN, NOUT, BATCH, NBATCH = 6, 3, 8, 10
#: the watchdog's soft and hard deadlines, s: the JAX test's 0.1 and 0.3
#: scaled up, since a rank's step here runs gloo collectives on a CPU the
#: whole suite shares (a slow healthy step must not read as a hang)
DEADLINE, GRACE = 0.5, 1.5


@pytest.fixture(scope="module")
def _pools(tmp_path_factory):
    pools = {}
    yield pools, tmp_path_factory
    for p in pools.values():
        p.close()


def _regrouped(pools_factory, world):
    pools, factory = pools_factory
    p = pools.get(world)
    if p is None:
        p = pools[world] = RankPool(world, str(factory.mktemp("store")),
                                   device="cpu")
    else:
        p.regroup()
    return p


@pytest.fixture()
def pool(_pools):
    """The module's 2 ranks in one whole group."""
    return _regrouped(_pools, 2)


@pytest.fixture()
def pool4(_pools):
    """The module's 4 ranks in one whole group."""
    return _regrouped(_pools, 4)


@pytest.fixture(scope="module", autouse=True)
def _cpu_rank():
    """This process plays rank 0 of 1 on the CPU for the in-process
    references."""
    from deeplearning4j_tpu_torch.parallel import init
    prev = init._initialized
    if prev is None:
        init.initializeDistributed(device="cpu")
    yield
    if prev is None:
        init._initialized = None


def _mlp_conf(pkg, seed=42, lr=0.01):
    import importlib
    base = "deeplearning4j_tpu" if pkg == "jax" else "deeplearning4j_tpu_torch"
    cfg = importlib.import_module(f"{base}.nn.config")
    L = importlib.import_module(f"{base}.nn.layers")
    U = importlib.import_module(f"{base}.train.updaters")
    return (cfg.NeuralNetConfiguration.Builder().seed(seed)
            .updater(U.Adam(lr)).list()
            .layer(L.DenseLayer(nOut=8, activation="relu"))
            .layer(L.OutputLayer(nOut=NOUT, lossFunction="mcxent",
                                 activation="softmax"))
            .setInputType(cfg.InputType.feedForward(NIN)).build())


def mlp(seed=42, lr=0.01):
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    return MultiLayerNetwork(_mlp_conf("torch", seed, lr)).init(device="cpu")


def _arrays(seed=5):
    rng = np.random.RandomState(seed)
    x = rng.randn(NBATCH * BATCH, NIN).astype(np.float32)
    y = np.eye(NOUT, dtype=np.float32)[rng.randint(0, NOUT, NBATCH * BATCH)]
    return x, y


def iterator(seed=5):
    from deeplearning4j_tpu_torch.data.dataset import (DataSet,
                                                       ListDataSetIterator)
    return ListDataSetIterator(DataSet(*_arrays(seed)), batch_size=BATCH)


def _metrics():
    from deeplearning4j_tpu_torch.parallel import elastic as el
    return {"lost": el.DEVICE_LOST.value, "shrinks": el.MESH_SHRINKS.value,
            "timeouts": el.WATCHDOG_TIMEOUTS.value,
            "stragglers": el.STRAGGLER_SECONDS.count}


class Lagging:
    """A coordinator two steps behind everyone (another participant
    lags): the agreed step is the caller's minus 2."""

    def resume_barrier(self, participant, step, timeout=60.0):
        return step - 2


class _FlakyOutputModel:
    """model.output raises for the first ``fail`` calls (or, with
    ``sleep``, stalls that long and answers), then delegates: the JAX
    test's."""

    def __init__(self, base, fail=1, sleep=0.0):
        self.base = base
        self._fail = fail
        self._sleep = sleep

    def output(self, x):
        if self._fail > 0:
            self._fail -= 1
            if self._sleep:
                time.sleep(self._sleep)
                return self.base.output(x)
            raise RuntimeError("injected replica failure")
        return self.base.output(x)


def _pi_conf(pkg):
    import importlib
    base = "deeplearning4j_tpu" if pkg == "jax" else "deeplearning4j_tpu_torch"
    cfg = importlib.import_module(f"{base}.nn.config")
    L = importlib.import_module(f"{base}.nn.layers")
    U = importlib.import_module(f"{base}.train.updaters")
    return (cfg.NeuralNetConfiguration.Builder().seed(1)
            .updater(U.Sgd(0.1)).list()
            .layer(L.DenseLayer(nOut=8, activation="relu"))
            .layer(L.OutputLayer(nOut=3, lossFunction="mcxent",
                                 activation="softmax"))
            .setInputType(cfg.InputType.feedForward(4)).build())


def rank_inference(p0, s0, x, axes=None, fail=1, sleep=0.0, retries=2,
                   replica_timeout=None, plan_kw=None):
    """``ParallelInference`` over the ranks (``axes``: the mesh, else
    data-parallel): the leader submits ``x`` and reports its answer or
    error, the warnings it saw, the failure count and the mesh after;
    the follower follows and reports how it left."""
    import warnings
    from deeplearning4j_tpu_torch.faults import FaultPlan
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import (DeviceMesh,
                                                   ParallelInference)
    from deeplearning4j_tpu_torch.parallel import wrapper
    net = MultiLayerNetwork(_pi_conf("torch")).params_from_jax(
        p0, s0, device="cpu")
    mesh = DeviceMesh.create(**axes) if axes else DeviceMesh.data_parallel()
    before = wrapper._INFERENCE_REPLICA_FAILURES.value
    pi = ParallelInference(_FlakyOutputModel(net, fail=fail, sleep=sleep),
                           mesh, max_retries=retries,
                           replica_timeout=replica_timeout,
                           faults=FaultPlan(**plan_kw) if plan_kw else None)
    if replica_timeout:
        pi._watchdog._lenient = 0       # nothing to build on the CPU
    if not pi.is_leader:
        return {"follower": pi.follow()}
    out, err = None, None
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        try:
            out = pi.output(x, timeout=30)
        except Exception as e:
            err = f"{type(e).__name__}: {e}"
    if sleep:
        time.sleep(2 * sleep)   # the abandoned forward finishes cleanly
    pi.shutdown()
    return {"out": out, "err": err,
            "warnings": [str(w.message) for w in seen],
            "failures": wrapper._INFERENCE_REPLICA_FAILURES.value - before,
            "data": pi.mesh.size("data"), "model": pi.mesh.size("model"),
            "members": sorted(d.id for d in pi.mesh.devices)}


# ------------------------------------------------------- rank functions
def rank_elastic(d, plan_kw, k=1, cfg_kw=None, ck_kw=None, lr=0.01,
                 nan_policy=None, coordinator=None):
    """One ``ParallelWrapper.fit(elastic=...)`` on every rank; a rank whose
    device is lost returns ``{"lost": True}``. Returns what the JAX test
    reads."""
    from deeplearning4j_tpu_torch.faults import FaultPlan
    from deeplearning4j_tpu_torch.parallel import (ElasticConfig,
                                                   ParallelWrapper,
                                                   RankLostError)
    from deeplearning4j_tpu_torch.train.resilience import (CheckpointConfig,
                                                           NanPolicy)
    before = _metrics()
    net = mlp(lr=lr)
    w = ParallelWrapper(net)
    cfg = ElasticConfig(**(cfg_kw or {}))
    if coordinator == "lagging":
        cfg.coordinator = Lagging()
    try:
        w.fit(iterator(), epochs=1, steps_per_dispatch=k,
              checkpoint=CheckpointConfig(d, **(ck_kw or {})),
              elastic=cfg, faults=FaultPlan(**plan_kw),
              nan_policy=None if nan_policy is None
              else NanPolicy[nan_policy])
    except RankLostError:
        return {"lost": True}
    except Exception as e:
        return {"error": type(e).__name__, "message": str(e)}
    after = _metrics()
    return {"iteration": net._iteration, "data": w.mesh.size("data"),
            "ranks": [dev.id for dev in w.mesh.devices],
            "params": net.params().numpy(), "lr_scale": net.lr_scale(),
            "preempted": getattr(net, "_preempted", False),
            **{k: after[k] - before[k] for k in after}}


def rank_resume(d, k=1):
    """A fresh wrapper fit over the current group resumed from ``d``."""
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.train.resilience import CheckpointConfig
    net = mlp()
    w = ParallelWrapper(net)
    w.fit(iterator(), epochs=1, steps_per_dispatch=k,
          checkpoint=CheckpointConfig(d, resume=True))
    return net._iteration, w.mesh.size("data"), net.params().numpy()


def rank_plain(d):
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.train.resilience import CheckpointConfig
    net = mlp()
    ParallelWrapper(net).fit(iterator(), epochs=1,
                             checkpoint=CheckpointConfig(d))
    return net.params().numpy()


def rank_probe(plan_kw, degraded_after=0.25, steps=(None,)):
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.faults import FaultPlan
    from deeplearning4j_tpu_torch.parallel import DeviceMesh, DeviceMonitor
    mesh = DeviceMesh.data_parallel()
    mon = DeviceMonitor(degraded_after=degraded_after,
                        plan=FaultPlan(**plan_kw) if plan_kw else None)
    out = []
    for s in steps:
        h = mon.probe(mesh.devices, step=s)
        out.append((sorted(h.dead), sorted(h.degraded),
                    sorted(h.probe_seconds), h.healthy()))
    return dist.get_rank(), out


def rank_shrink_mesh():
    """``shrink_mesh_on_dead`` with rank 1 planned dead: rank 0 gets a
    one-rank mesh over a new group; rank 1 (dead) keeps nothing."""
    import warnings

    from deeplearning4j_tpu_torch.faults import FaultPlan
    from deeplearning4j_tpu_torch.parallel import DeviceMesh
    from deeplearning4j_tpu_torch.parallel.elastic import shrink_mesh_on_dead
    plan = FaultPlan(device_loss_at_step=1, lose_devices=[1])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = shrink_mesh_on_dead(DeviceMesh.data_parallel(), plan=plan)
    return (None if out is None else (out.size("data"),
                                      [d.id for d in out.devices]),
            [str(w.message) for w in caught])


def _checkpoints(d):
    from deeplearning4j_tpu_torch.train.resilience import (CheckpointConfig,
                                                           CheckpointManager)
    mgr = CheckpointManager(CheckpointConfig(d))
    return mgr, mgr.checkpoints()


# ============================================================ device monitor
class TestDeviceMonitor:
    def test_all_healthy(self, pool, devices):
        """Every rank healthy; each probes its own device (the JAX
        monitor, one process, probes all 8)."""
        from deeplearning4j_tpu.parallel.elastic import DeviceMonitor as JMon
        jh = JMon().probe(devices)
        assert jh.healthy() and set(jh.probe_seconds) == \
            {d.id for d in devices}
        for r, [(dead, _deg, probed, ok)] in pool.run(rank_probe, None):
            assert ok and dead == [] and probed == [r]

    def test_planned_loss_classified_dead(self, pool, devices):
        """The planned loss reads dead from its step on, persistently and
        "as of now", and is not probed: the same sets the JAX monitor
        gives for the same plan."""
        from deeplearning4j_tpu.faults import FaultPlan as JPlan
        from deeplearning4j_tpu.parallel.elastic import DeviceMonitor as JMon
        plan = {"device_loss_at_step": 3, "lose_devices": [1]}
        jm = JMon(plan=JPlan(**plan))
        want = [sorted(jm.probe(devices, step=s).dead)
                for s in (2, 3, 9, None)]
        assert want == [[], [1], [1], [1]]
        for r, res in pool.run(rank_probe, plan, steps=(2, 3, 9, None)):
            assert [x[0] for x in res] == want
            assert 1 not in res[1][2]

    def test_degraded_classification(self, pool, devices):
        from deeplearning4j_tpu.parallel.elastic import DeviceMonitor as JMon
        jh = JMon(degraded_after=0.0).probe(devices)
        assert jh.degraded == {d.id for d in devices} and not jh.dead
        for r, [(dead, degraded, _p, _ok)] in pool.run(
                rank_probe, None, degraded_after=0.0):
            assert degraded == [r] and dead == []


    def test_shrink_mesh_on_dead(self, pool):
        """The serving-side shrink: the survivor gets a data-parallel mesh
        of the live ranks (a new group), warned about; the dead rank keeps
        none. The JAX helper on the same plan drops the same device."""
        from deeplearning4j_tpu.faults import FaultPlan as JPlan
        from deeplearning4j_tpu.parallel import DeviceMesh as JMesh
        from deeplearning4j_tpu.parallel.elastic import \
            shrink_mesh_on_dead as jshrink
        import jax
        with pytest.warns(UserWarning, match="dropping dead"):
            jm = jshrink(JMesh.create(data=2, devices=jax.devices()[:2]),
                         plan=JPlan(device_loss_at_step=1, lose_devices=[1]))
        assert jm.size("data") == 1
        (mesh0, warned0), (mesh1, _) = pool.run(rank_shrink_mesh)
        assert mesh0 == (1, [0]) and any("dropping dead" in w
                                         for w in warned0)
        assert mesh1 is None


# ================================================================= watchdog
def _both_watchdogs():
    from deeplearning4j_tpu.parallel.elastic import DispatchWatchdog as JW
    from deeplearning4j_tpu_torch.parallel import DispatchWatchdog
    return (JW, DispatchWatchdog)


class TestDispatchWatchdog:
    """The port's watchdog and the JAX one on the same dispatches."""

    def test_returns_result_inline_and_supervised(self):
        for W in _both_watchdogs():
            assert W(warmup=0).run(lambda: 41 + 1, 1) == 42
            wd = W(deadline=5.0, warmup=0)
            assert wd.run(lambda: "ok", 1) == "ok" and wd.timeouts == 0

    def test_soft_timeout_records_straggler(self):
        from deeplearning4j_tpu_torch.parallel import elastic as el
        for W in _both_watchdogs():
            wd = W(deadline=0.05, grace=10.0, warmup=0)
            before = (el.WATCHDOG_TIMEOUTS.value, el.STRAGGLER_SECONDS.count)
            assert wd.run(lambda: time.sleep(0.2) or "late", 7) == "late"
            assert wd.timeouts == 1 and wd.stragglers == 1
            if W is el.DispatchWatchdog:
                assert el.WATCHDOG_TIMEOUTS.value == before[0] + 1
                assert el.STRAGGLER_SECONDS.count == before[1] + 1

    def test_hard_timeout_abandons_and_raises(self):
        for W in _both_watchdogs():
            release = threading.Event()
            wd = W(deadline=0.05, grace=0.15, warmup=0)
            with pytest.raises(Exception, match="grace deadline") as ei:
                wd.run(lambda: release.wait(10.0), 3)
            assert type(ei.value).__name__ == "DispatchTimeoutError"
            release.set()

    def test_warmup_dispatches_unsupervised(self):
        for W in _both_watchdogs():
            wd = W(deadline=0.05, grace=10.0, warmup=1)
            assert wd.run(lambda: time.sleep(0.2) or 1, 1) == 1
            assert wd.timeouts == 0
            wd.run(lambda: time.sleep(0.2) or 2, 2)
            assert wd.timeouts == 1
            wd.begin_attempt()
            assert wd._lenient == 1

    def test_dispatch_error_reraised_on_caller(self):
        for W in _both_watchdogs():
            wd = W(deadline=5.0, warmup=0)
            with pytest.raises(ValueError, match="boom"):
                wd.run(lambda: (_ for _ in ()).throw(ValueError("boom")), 1)


# ============================================================== coordinator
def _both_coordinators():
    from deeplearning4j_tpu.parallel.elastic import InProcessCoordinator as J
    from deeplearning4j_tpu_torch.parallel import InProcessCoordinator
    return (J, InProcessCoordinator)


class TestInProcessCoordinator:
    def test_single_participant(self):
        for C in _both_coordinators():
            c = C(1)
            assert c.resume_barrier("p0", 17) == 17
            assert c.resume_barrier("p0", 23) == 23

    def test_agreement_is_min_across_participants(self):
        for C in _both_coordinators():
            c = C(3)
            results = {}

            def arrive(pid, step):
                results[pid] = c.resume_barrier(pid, step, timeout=10.0)
            ts = [threading.Thread(target=arrive, args=(f"p{i}", s))
                  for i, s in enumerate((7, 5, 6))]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            assert results == {"p0": 5, "p1": 5, "p2": 5}

    def test_missing_participant_times_out(self):
        for C in _both_coordinators():
            with pytest.raises(TimeoutError, match="1/2 participants"):
                C(2).resume_barrier("alone", 4, timeout=0.1)


# ============================================================ elastic shrink
class TestElasticShrink:
    def test_loss_of_half_the_mesh_matches_fresh_small_fit(self, pool,
                                                           tmp_path):
        """THE acceptance pin: 2 ranks lose rank 1 at step 5 -> the
        coordinated checkpoint of step 5 -> rank 0 alone finishes; its
        params equal a fresh one-rank fit resumed from that checkpoint,
        bit-equal (the JAX pin: 8 devices lose 4)."""
        d = str(tmp_path / "c")
        out, gone = pool.run(rank_elastic, d, {
            "device_loss_at_step": 5, "lose_devices": [1]})
        assert gone == {"lost": True}
        assert out["iteration"] == NBATCH and out["data"] == 1
        assert out["ranks"] == [0]
        assert out["lost"] == 1 and out["shrinks"] == 1
        mgr, [(step, path)] = _checkpoints(d)
        assert step == 5
        assert mgr.validate(path)["status"] == "elastic-shrink"
        it, data, params = rank_resume(d)
        assert it == NBATCH and data == 1
        np.testing.assert_array_equal(out["params"], params)

    def test_shrink_composes_with_megasteps(self, pool4, tmp_path):
        """4 ranks at K=2 lose ranks 2 and 3 at step 4; the 2 survivors
        finish, equal to a fresh 2-rank fit (on their new group) resumed
        from the coordinated checkpoint, bit-equal."""
        d = str(tmp_path / "c")
        res = pool4.run(rank_elastic, d, {"device_loss_at_step": 4,
                                          "lose_devices": [2, 3]}, k=2)
        assert res[2:] == [{"lost": True}] * 2
        for o in res[:2]:
            assert o["iteration"] == NBATCH and o["data"] == 2
        ref = pool4.run(rank_resume, d, 2, ranks=[0, 1])
        for it, data, params in ref:
            assert it == NBATCH and data == 2
            np.testing.assert_array_equal(res[0]["params"], params)

    def test_hard_hang_with_device_loss_shrinks(self, pool, tmp_path):
        """Dispatch 6 hangs for ever AND rank 1 is dead: the watchdog
        abandons it, the probe confirms the loss, the mesh shrinks, and
        batch 6 replays from the step-5 checkpoint."""
        d = str(tmp_path / "c")
        out, _ = pool.run(rank_elastic, d, {
            "hung_dispatch_at": [6], "hang_seconds": None,
            "device_loss_at_step": 6, "lose_devices": [1]},
            cfg_kw={"watchdog_deadline": DEADLINE, "watchdog_grace": GRACE})
        assert out["iteration"] == NBATCH and out["data"] == 1
        assert [s for s, _ in _checkpoints(d)[1]] == [5]

    def test_soft_hang_is_a_straggler_not_a_failure(self, pool, tmp_path):
        d = str(tmp_path / "c")
        res = pool.run(rank_elastic, d, {"hung_dispatch_at": [4],
                                         "hang_seconds": 2 * DEADLINE},
                       cfg_kw={"watchdog_deadline": DEADLINE,
                               "watchdog_grace": 30.0})
        ref = pool.run(rank_plain, str(tmp_path / "x"))
        for o, p in zip(res, ref):
            assert o["iteration"] == NBATCH and o["data"] == 2
            assert o["timeouts"] == 1
            np.testing.assert_array_equal(o["params"], p)

    def test_slow_replica_recorded_as_straggler(self, pool, tmp_path):
        res = pool.run(rank_elastic, str(tmp_path / "c"),
                       {"slow_replica_at": [5], "slow_seconds": 2 * DEADLINE},
                       cfg_kw={"watchdog_deadline": DEADLINE,
                               "watchdog_grace": 30.0})
        for o in res:
            assert o["iteration"] == NBATCH and o["stragglers"] == 1

    def test_hard_hang_on_healthy_mesh_surfaces(self, pool, tmp_path):
        """No dead rank behind the hang: retrying could double-apply a
        step that landed, so DispatchTimeoutError surfaces on every
        rank."""
        res = pool.run(rank_elastic, str(tmp_path / "c"),
                       {"hung_dispatch_at": [4], "hang_seconds": None},
                       cfg_kw={"watchdog_deadline": DEADLINE,
                               "watchdog_grace": GRACE})
        assert [o.get("error") for o in res] == ["DispatchTimeoutError"] * 2

    def test_elastic_requires_checkpoint(self):
        from deeplearning4j_tpu_torch.parallel import (ElasticConfig,
                                                       ParallelWrapper)
        with pytest.raises(ValueError, match="requires checkpoint"):
            ParallelWrapper(mlp()).fit(iterator(), elastic=ElasticConfig())

    def test_too_few_survivors_raises(self, pool, tmp_path):
        out, _ = pool.run(rank_elastic, str(tmp_path / "c"), {
            "device_loss_at_step": 3, "lose_devices": [1]},
            cfg_kw={"min_devices": 2})
        assert out["error"] == "ElasticShrinkError"
        assert "min_devices" in out["message"]

    def test_lr_policy_linear_rescales(self, pool, tmp_path):
        out, _ = pool.run(rank_elastic, str(tmp_path / "c"), {
            "device_loss_at_step": 5, "lose_devices": [1]},
            cfg_kw={"lr_policy": "linear"})
        assert out["lr_scale"] == 0.5 and out["iteration"] == NBATCH

    def test_lagging_barrier_restores_agreed_step_not_newest(self, pool,
                                                            tmp_path):
        """A participant AHEAD of the agreement rolls back to the agreed
        checkpoint and writes no ahead-of-agreement one; steps 4 and 5
        are replayed (and saved again) on the shrunk mesh."""
        d = str(tmp_path / "c")
        out, _ = pool.run(rank_elastic, d, {
            "device_loss_at_step": 5, "lose_devices": [1]},
            ck_kw={"every_steps": 1, "keep_last": 50},
            coordinator="lagging")
        assert out["iteration"] == NBATCH and out["data"] == 1
        mgr, cps = _checkpoints(d)
        statuses = {s: mgr.validate(path)["status"] for s, path in cps}
        assert "elastic-shrink" not in statuses.values()
        assert {4, 5}.issubset(statuses)

    def test_dispatch_fence_discards_abandoned_commit(self):
        """A dispatch that ends after the fence moved commits no
        bookkeeping (iteration, iterationDone, the session's hooks); once
        the fence is cleared training goes on."""
        from deeplearning4j_tpu_torch.parallel.elastic import DispatchFence
        net = mlp()
        ds = next(iter(iterator()))
        net._fit_one(ds)
        fence = DispatchFence()
        net._dispatch_fence = fence
        done = []

        class BumpMidDispatch:
            def onIterationStart(self, model, iteration):
                fence.generation += 1

            def iterationDone(self, model, iteration, epoch):
                done.append(iteration)
        net.setListeners(BumpMidDispatch())
        before = net._iteration
        net._fit_one(ds)
        assert net._iteration == before and done == []
        net._dispatch_fence = None
        net.setListeners()
        net._fit_one(ds)
        assert net._iteration == before + 1

    def test_bad_lr_policy_rejected_up_front(self, tmp_path):
        from deeplearning4j_tpu_torch.parallel import (ElasticConfig,
                                                       ParallelWrapper)
        from deeplearning4j_tpu_torch.train.resilience import \
            CheckpointConfig
        with pytest.raises(ValueError, match="lr_policy"):
            ParallelWrapper(mlp()).fit(
                iterator(), checkpoint=CheckpointConfig(str(tmp_path)),
                elastic=ElasticConfig(lr_policy="Linear"))

    def test_restore_specific_step(self, tmp_path):
        from deeplearning4j_tpu_torch.train.resilience import (
            CheckpointConfig, CheckpointManager)
        d = str(tmp_path / "c")
        mlp().fit(iterator(), checkpoint=CheckpointConfig(
            d, every_steps=2, keep_last=50))
        mgr = CheckpointManager(CheckpointConfig(d))
        assert [s for s, _ in mgr.checkpoints()] == [2, 4, 6, 8, 10]
        target = mlp()
        info = mgr.restore(target, step=4)
        assert info["manifest"]["step"] == 4 and target._iteration == 4
        assert mgr.restore(mlp(), step=5) is None

    def test_preemption_composes_with_elastic(self, pool, tmp_path):
        d = str(tmp_path / "c")
        res = pool.run(rank_elastic, d, {"preempt_at_step": 6})
        for o in res:
            assert o["preempted"] and o["iteration"] == 6
        _, manifest = _checkpoints(d)[0].latest_valid()
        assert manifest["status"] == "preempted"


# ===================================================== data-pipeline rebind
class TestPrefetcherRebindAfterShrink:
    """A shrink discards batches staged for the old mesh; a new
    prefetcher with the new mesh's rows serves the rest."""

    def _pulls(self, it):
        while it.hasNext():
            yield it.next()

    def test_staged_items_discarded_then_rebind(self):
        from deeplearning4j_tpu_torch.data.dataset import DevicePrefetcher
        from deeplearning4j_tpu_torch.parallel.data import \
            ShardedDataSetIterator
        base = iterator()
        two = ShardedDataSetIterator(base, process_count=2, process_index=0)
        pf = DevicePrefetcher(self._pulls(two), steps_per_dispatch=1,
                              prefetch=4, device="cpu")
        first = next(iter(pf))
        assert first.features.shape[0] == BATCH // 2     # rank 0's rows
        time.sleep(0.2)                 # let the worker stage ahead
        pf.close()                      # shrink: staged items discarded
        assert base.cursor()["pos"] > BATCH     # it really pulled ahead
        base.seek({"pos": BATCH, "epoch": 0})
        with DevicePrefetcher(self._pulls(base), steps_per_dispatch=1,
                              prefetch=2, device="cpu") as pf2:
            rest = list(pf2)
        assert len(rest) == NBATCH - 1
        assert all(b.features.shape[0] == BATCH for b in rest)

    def test_sharded_iterator_cursor_protocol(self):
        from deeplearning4j_tpu.data.dataset import (DataSet as JDS,
                                                     ListDataSetIterator as
                                                     JIt)
        from deeplearning4j_tpu.parallel.data import \
            ShardedDataSetIterator as JSharded
        from deeplearning4j_tpu_torch.parallel.data import \
            ShardedDataSetIterator
        jit = JSharded(JIt(JDS(*_arrays()), batch_size=BATCH),
                       process_count=2, process_index=0)
        it = ShardedDataSetIterator(iterator(), process_count=2,
                                    process_index=0)
        for x in (it, jit):
            x.next()
        c = it.cursor()
        assert c == jit.cursor() == {"pos": BATCH, "epoch": 0}
        nxt = it.next()
        np.testing.assert_array_equal(np.asarray(nxt.features),
                                      np.asarray(jit.next().features))
        it2 = ShardedDataSetIterator(iterator(), process_count=2,
                                     process_index=0)
        it2.seek(c)
        np.testing.assert_array_equal(it2.next().features, nxt.features)
        it.hasNext()
        assert it.cursor() is None


def _pi_net():
    """The JAX test's net, and its params and states as numpy."""
    import jax
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
    net = MultiLayerNetwork(_pi_conf("jax")).init()
    state = jax.tree_util.tree_map(lambda a: np.array(np.asarray(a)),
                                   (net._params, net._states))
    return net, state


class TestParallelInferenceRobustness:
    def _net(self):
        return _pi_net()

    @staticmethod
    def _warned(res, text):
        return any(text in w for w in res["warnings"])

    def test_flaky_replica_retried(self, pool):
        net, (p0, s0) = self._net()
        x = np.random.RandomState(0).randn(4, 4).astype(np.float32)
        lead, follow = pool.run(rank_inference, p0, s0, x)
        assert follow == {"follower": "stopped"}
        assert lead["err"] is None and self._warned(lead, "replica failure")
        np.testing.assert_allclose(lead["out"], np.asarray(net.output(x)),
                                   rtol=1e-4, atol=1e-5)
        assert lead["failures"] == 1

    def test_exhausted_retries_structured_error(self, pool):
        net, (p0, s0) = self._net()
        x = np.zeros((2, 4), np.float32)
        lead, follow = pool.run(rank_inference, p0, s0, x, fail=99,
                                retries=1)
        assert follow == {"follower": "stopped"}
        assert self._warned(lead, "replica failure")
        assert lead["err"].startswith("InferenceFailedError") and \
            "after 2 attempt" in lead["err"]

    def test_timed_out_replica_retried(self, pool):
        """The leader's watchdog abandons the first forward after 0.2 s
        (every rank stalls 0.6 s in it, then answers); the retry waits for
        it outside its own deadline and answers."""
        net, (p0, s0) = self._net()
        x = np.random.RandomState(1).randn(2, 4).astype(np.float32)
        lead, follow = pool.run(rank_inference, p0, s0, x, sleep=0.6,
                                replica_timeout=0.2)
        assert follow == {"follower": "stopped"}
        assert lead["err"] is None and self._warned(lead, "replica failure")
        np.testing.assert_allclose(lead["out"], np.asarray(net.output(x)),
                                   rtol=1e-4, atol=1e-5)
        assert lead["failures"] >= 1

    def test_tensor_parallel_mesh_not_flattened(self, pool):
        """A tensor-parallel serving mesh cannot drop a rank (each holds a
        shard): the failure retries on the FULL mesh, rank 1 (the "lost"
        one) included."""
        net, (p0, s0) = self._net()
        x = np.random.RandomState(3).randn(4, 4).astype(np.float32)
        lead, follow = pool.run(
            rank_inference, p0, s0, x, axes={"data": 1, "model": 2},
            plan_kw={"device_loss_at_step": 1, "lose_devices": [1]})
        assert follow == {"follower": "stopped"}
        assert self._warned(lead, "cannot shrink a tensor-parallel")
        np.testing.assert_allclose(lead["out"], np.asarray(net.output(x)),
                                   rtol=1e-4, atol=1e-5)
        assert lead["model"] == 2           # mesh untouched

    def test_dead_devices_dropped_from_serving_mesh(self, pool):
        net, (p0, s0) = self._net()
        x = np.random.RandomState(2).randn(4, 4).astype(np.float32)
        lead, follow = pool.run(
            rank_inference, p0, s0, x,
            plan_kw={"device_loss_at_step": 1, "lose_devices": [1]})
        assert follow == {"follower": "lost"}
        assert self._warned(lead, "dropping dead rank")
        np.testing.assert_allclose(lead["out"], np.asarray(net.output(x)),
                                   rtol=1e-4, atol=1e-5)
        assert lead["data"] == 1 and lead["members"] == [0]


def rank_serve_mesh(p0, s0, xs, plan_kw=None):
    """``ModelServer`` over a data=2 mesh: the leader warms, answers
    ``xs`` one request each and reports the answers, the buckets before
    and after, the mesh after and the shrink's seconds; the follower
    follows and reports how it left."""
    from deeplearning4j_tpu_torch.faults import FaultPlan
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import DeviceMesh
    from deeplearning4j_tpu_torch.serving.server import ModelServer
    net = MultiLayerNetwork(_pi_conf("torch")).params_from_jax(
        p0, s0, device="cpu")
    server = ModelServer(net, mesh=DeviceMesh.data_parallel(), batch_limit=4,
                         coalesce_ms=0.5, name="mesh-server",
                         faults=FaultPlan(**plan_kw) if plan_kw else None)
    server.warmup([(4,)])
    if not server.is_leader:
        return {"follower": server.follow()}
    buckets = server.buckets()
    outs = [server.output(x, timeout=60) for x in xs]
    server.close()
    return {"outs": outs, "buckets": (buckets, server.buckets()),
            "data": server.mesh.size("data"),
            "shrink_s": server.last_shrink_seconds,
            "recompiles": server.recompiles_after_warmup()}


class TestServingOnMesh:
    """``ModelServer(mesh=)`` over 2 ranks (rank 0 leads): answers equal
    to the unsharded net's (``rtol=1e-4, atol=1e-5``), buckets multiples
    of the data width, and a rank lost mid-stream shrinks the mesh, the
    buckets re-warm on the survivor and the batch is retried there."""

    def _net(self):
        return _pi_net()

    def test_data_mesh_answers_as_one_device(self, pool):
        net, (p0, s0) = self._net()
        rng = np.random.RandomState(4)
        xs = [rng.randn(n, 4).astype(np.float32) for n in (1, 3, 4)]
        lead, follow = pool.run(rank_serve_mesh, p0, s0, xs)
        assert follow == {"follower": "stopped"}
        assert lead["buckets"] == ([2, 4], [2, 4]) and lead["data"] == 2
        for x, out in zip(xs, lead["outs"]):
            np.testing.assert_allclose(out, np.asarray(net.output(x)),
                                       rtol=1e-4, atol=1e-5)
        assert lead["shrink_s"] is None and lead["recompiles"] == 0

    def test_lost_rank_shrinks_rewarms_and_retries(self, pool):
        net, (p0, s0) = self._net()
        rng = np.random.RandomState(5)
        xs = [rng.randn(2, 4).astype(np.float32) for _ in range(3)]
        lead, follow = pool.run(
            rank_serve_mesh, p0, s0, xs,
            plan_kw={"serve_device_loss_at_batch": 2, "lose_devices": [1]})
        assert follow == {"follower": "lost"}
        assert lead["buckets"] == ([2, 4], [1, 2, 4]) and lead["data"] == 1
        assert lead["shrink_s"] is not None and lead["shrink_s"] > 0
        for x, out in zip(xs, lead["outs"]):
            np.testing.assert_allclose(out, np.asarray(net.output(x)),
                                       rtol=1e-4, atol=1e-5)
