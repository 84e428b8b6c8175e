"""Fault-tolerant training in the port (``train/resilience.py``,
``faults.py``) on the CPU: the cases of the JAX package's
``tests/test_resilience.py`` that need no mesh and no lifecycle, and the
checkpoint crossing between the packages.

The guarantee under test: ``fit(N)`` equals ``fit(k)`` + preemption +
resume to the bit (params, updater state, the clock), for the
sequential network, the graph, K steps a dispatch and truncated BPTT;
every restore writes into the tensors it replaces (their storage, and
any captured step over it, stays). A checkpoint the JAX package wrote
resumes in the port and the next step lands within 1e-6 (rtol and atol)
of the JAX next step; the reverse too.
"""

import json
import os
import shutil
import signal
import zipfile

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import dataset as jdata
from deeplearning4j_tpu import faults as jfaults
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.train import resilience as jres
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch.data.dataset import (AsyncDataSetIterator,
                                                   DataSet,
                                                   ListDataSetIterator,
                                                   NormalizerStandardize,
                                                   TransientDataError)
from deeplearning4j_tpu_torch.faults import FaultPlan
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.train import resilience as res
from deeplearning4j_tpu_torch.train import updaters
from deeplearning4j_tpu_torch.train.resilience import (CheckpointConfig,
                                                       CheckpointManager,
                                                       CorruptCheckpointError,
                                                       NanPolicy, NanRecovery,
                                                       NumericsPanicError)

from test_torch_compilecache import fake_capture  # noqa: F401

torch.set_num_threads(2)

NIN, NOUT, BATCH, NBATCH = 6, 3, 4, 10


def _mlp_conf(Conf, M, It, upd, seed=42, dropout=False):
    b = (Conf.Builder().seed(seed).updater(upd.Adam(0.01)).list()
         .layer(M.DenseLayer(nOut=8, activation="relu")))
    if dropout:
        b = b.layer(M.DropoutLayer(0.5))
    return (b.layer(M.OutputLayer(nOut=NOUT, lossFunction="mcxent",
                                  activation="softmax"))
            .setInputType(It.feedForward(NIN)).build())


def mlp(seed=42, dropout=False):
    return MultiLayerNetwork(_mlp_conf(NeuralNetConfiguration, L, InputType,
                                       updaters, seed, dropout)
                             ).init(device="cpu")


def graph_net(seed=7):
    b = (NeuralNetConfiguration.Builder().seed(seed)
         .updater(updaters.Adam(0.01)).graphBuilder())
    b.addInputs("in").setInputTypes(InputType.feedForward(NIN))
    b.addLayer("d1", L.DenseLayer(nOut=8, activation="relu"), "in")
    b.addLayer("out", L.OutputLayer(nOut=NOUT, lossFunction="mcxent",
                                    activation="softmax"), "d1")
    b.setOutputs("out")
    return ComputationGraph(b.build()).init(device="cpu")


def arrays(n=NBATCH * BATCH, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, NIN).astype(np.float32)
    y = np.eye(NOUT, dtype=np.float32)[rng.randint(0, NOUT, n)]
    return x, y


def iterator(seed=0, shuffle=False):
    return ListDataSetIterator(DataSet(*arrays(seed=seed)), BATCH,
                               shuffle=shuffle)


def state(net):
    return [t.detach().clone() for t in net._dispatch_state()]


def assert_training_state_equal(a, b):
    assert a._iteration == b._iteration
    sa, sb = a._snapshot_tensors(), b._snapshot_tensors()
    assert len(sa) == len(sb)
    for x, y in zip(sa, sb):
        assert torch.equal(x, y)
    assert int(a._ensure_clock()) == int(b._ensure_clock())


# ===================================================================== resume
class TestResumeEquivalence:
    def _run(self, build, tmp_path, k=1, preempt_at=6, **ck):
        straight = build()
        straight.fit(iterator(), epochs=1, steps_per_dispatch=k)
        d = str(tmp_path / "ckpts")
        pre = build()
        pre.fit(iterator(), epochs=1, steps_per_dispatch=k,
                checkpoint=CheckpointConfig(d, every_steps=2, **ck),
                faults=FaultPlan(preempt_at_step=preempt_at))
        assert pre._preempted and pre._iteration == preempt_at
        resumed = build()
        resumed.fit(iterator(), epochs=1, steps_per_dispatch=k,
                    checkpoint=CheckpointConfig(d, resume=True))
        assert resumed._iteration == NBATCH
        return straight, resumed

    @pytest.mark.parametrize("case", ["mlp", "dropout", "graph", "k2",
                                      "k2_async"])
    def test_bit_exact(self, tmp_path, case):
        build = {"graph": graph_net,
                 "dropout": lambda: mlp(dropout=True)}.get(case, mlp)
        a, b = self._run(build, tmp_path, k=2 if "k2" in case else 1,
                         async_write=case == "k2_async")
        assert_training_state_equal(a, b)

    def test_preempted_manifest_status_and_cursor(self, tmp_path):
        d = str(tmp_path / "c")
        net = mlp()
        net.fit(iterator(), epochs=1,
                checkpoint=CheckpointConfig(d, every_steps=3),
                faults=FaultPlan(preempt_at_step=7))
        mgr = CheckpointManager(CheckpointConfig(d))
        path, manifest = mgr.latest_valid()
        assert manifest["status"] == "preempted" and manifest["step"] == 7
        with open(os.path.join(path, "extra.json")) as f:
            extra = json.load(f)
        assert extra["cursor"] == {"pos": 7 * BATCH, "epoch": 0}
        assert extra["extra"]["resilience"]["lr_scale"] == 1.0
        assert sorted(manifest["files"]) == ["extra.json", "model.zip"]

    def test_shuffled_iterator_and_several_epochs(self, tmp_path):
        d = str(tmp_path / "c")
        a = mlp()
        a.fit(iterator(shuffle=True), epochs=3)
        pre = mlp()
        pre.fit(iterator(shuffle=True), epochs=3,
                checkpoint=CheckpointConfig(d, every_steps=5),
                faults=FaultPlan(preempt_at_step=15))     # mid-epoch 1
        assert pre._iteration == 15
        b = mlp()
        b.fit(iterator(shuffle=True), epochs=3,
              checkpoint=CheckpointConfig(d, resume=True))
        assert b._iteration == 3 * NBATCH and b.getEpochCount() == 3
        assert_training_state_equal(a, b)

    def test_resume_with_empty_dir_is_fresh_run(self, tmp_path):
        a = mlp()
        a.fit(iterator(), checkpoint=CheckpointConfig(str(tmp_path / "no"),
                                                      resume=True))
        b = mlp()
        b.fit(iterator())
        assert_training_state_equal(a, b)

    def test_epoch_boundary_resume_trains_all_remaining_epochs(self,
                                                              tmp_path):
        d = str(tmp_path / "c")
        a = mlp()
        a.fit(iterator(), epochs=3)
        partial = mlp()
        partial.fit(iterator(), epochs=1,
                    checkpoint=CheckpointConfig(d, every_epochs=1))
        b = mlp()
        b.fit(iterator(), epochs=3, checkpoint=CheckpointConfig(d,
                                                                resume=True))
        assert b._iteration == 3 * NBATCH
        assert_training_state_equal(a, b)

    def test_a_restore_keeps_the_storage_and_captures_nothing_again(
            self, tmp_path, fake_capture):
        d = str(tmp_path / "c")
        cfg = CheckpointConfig(d, every_steps=4, keep_last=5)
        net = mlp()
        net.fit(iterator(), steps_per_dispatch=2, checkpoint=cfg)
        assert len(fake_capture) == 1
        ptrs = [t.data_ptr() for t in net._dispatch_state()]
        saved = state(net)
        CheckpointManager(cfg).save(net)          # step 10
        net.fit(iterator(), steps_per_dispatch=2, checkpoint=cfg,
                nan_policy=NanPolicy.ROLLBACK,
                faults=FaultPlan(nan_grads_at=[2]))
        assert net._iteration == NBATCH + 8      # rolled 12 back to 10
        assert [t.data_ptr() for t in net._dispatch_state()] == ptrs
        assert len(fake_capture) == 1
        # a restore INTO the net: the checkpoint's state, in place
        CheckpointManager(cfg).restore(net, step=NBATCH)
        assert [t.data_ptr() for t in net._dispatch_state()] == ptrs
        for x, y in zip(state(net), saved):
            assert torch.equal(x, y)


class TestTbptt:
    SEGS = 3            # T=12, windows of 4

    def _net(self, seed=11):
        conf = (NeuralNetConfiguration.Builder().seed(seed)
                .updater(updaters.Sgd(0.05)).list()
                .layer(L.LSTM(nOut=6))
                .layer(L.RnnOutputLayer(nOut=2, lossFunction="mcxent"))
                .setInputType(InputType.recurrent(3, 12))
                .backpropType("tbptt", 4).build())
        return MultiLayerNetwork(conf).init(device="cpu")

    def _iter(self, n=24):
        rng = np.random.RandomState(0)
        feats = rng.rand(n, 3, 12).astype(np.float32)
        labs = np.zeros((n, 2, 12), np.float32)
        labs[::2, 0] = 1.0
        labs[1::2, 1] = 1.0
        return ListDataSetIterator(DataSet(feats, labs), 4)

    def test_resume_bit_exact_on_batch_boundaries(self, tmp_path):
        d = str(tmp_path / "c")
        straight = self._net()
        straight.fit(self._iter())
        pre = self._net()
        pre.fit(self._iter(), checkpoint=CheckpointConfig(d, every_steps=2,
                                                          keep_last=99),
                faults=FaultPlan(preempt_at_step=9))
        assert pre._preempted and pre._iteration == 9
        mgr = CheckpointManager(CheckpointConfig(d))
        steps = [s for s, _ in mgr.checkpoints()]
        assert steps and all(s % self.SEGS == 0 for s in steps)
        for step, path in mgr.checkpoints():
            with open(os.path.join(path, "extra.json")) as f:
                assert json.load(f)["cursor"]["pos"] == \
                    step // self.SEGS * 4
        resumed = self._net()
        resumed.fit(self._iter(), checkpoint=CheckpointConfig(d,
                                                              resume=True))
        assert resumed._iteration == 6 * self.SEGS
        assert_training_state_equal(straight, resumed)

    def test_skip_drops_the_whole_batch(self):
        net = self._net()
        before = None

        class Keep:
            def onIterationStart(self, model, iteration):
                nonlocal before
                if iteration == 4:
                    before = state(model)[:-1]
        net.setListeners(Keep())
        seen = []
        orig = res.TrainingSession._handle_nonfinite

        def spy(session, k, bad):
            orig(session, k, bad)
            seen.append((k, bad, state(session.model)[:-1]))
        res.TrainingSession._handle_nonfinite = spy
        try:
            net.fit(self._iter(), nan_policy=NanPolicy.SKIP_STEP,
                    faults=FaultPlan(nan_grads_at=[2]))
        finally:
            res.TrainingSession._handle_nonfinite = orig
        assert [(k, b) for k, b, _ in seen] == [(3, 3)]
        for x, y in zip(seen[0][2], before):
            assert torch.equal(x, y)
        assert net._iteration == 6 * self.SEGS
        assert torch.isfinite(net.params()).all()


# ============================================================== NaN policies
class TestNanPolicies:
    def test_raise(self):
        with pytest.raises(NumericsPanicError, match="iteration 3"):
            mlp().fit(iterator(), nan_policy=NanPolicy.RAISE,
                      faults=FaultPlan(nan_grads_at=[3]))

    def test_skip_step_bit_exact_vs_manual_skip(self):
        x, y = arrays()
        a = mlp()
        a.fit(iterator(), nan_policy=NanPolicy.SKIP_STEP,
              faults=FaultPlan(nan_grads_at=[3]))
        assert a._iteration == NBATCH
        b = mlp()
        for j in range(NBATCH):
            sl = slice(j * BATCH, (j + 1) * BATCH)
            if j == 2:                  # batch 3 never lands...
                b._ensure_step_state()
                b._iteration += 1       # ...but its step number is spent
                b._t_dev.add_(1)
                continue
            b.fit(DataSet(x[sl], y[sl]))
        assert_training_state_equal(a, b)

    def test_skip_step_drops_the_whole_dispatch(self):
        a = mlp()
        a.fit(iterator(), steps_per_dispatch=2,
              nan_policy=NanPolicy.SKIP_STEP,
              faults=FaultPlan(nan_grads_at=[3]))
        assert a._iteration == NBATCH and torch.isfinite(a.params()).all()

    def test_backoff_lr_halves_then_recovers(self):
        net = mlp()
        net.fit(iterator(), nan_policy=NanRecovery(NanPolicy.BACKOFF_LR,
                                                   cooldown_steps=100),
                faults=FaultPlan(nan_grads_at=[3]))
        assert net.lr_scale() == 0.5
        assert float(net.conf.base.updater._lr_scale) == 0.5
        net2 = mlp()
        net2.fit(iterator(), nan_policy=NanRecovery(NanPolicy.BACKOFF_LR,
                                                    cooldown_steps=3),
                 faults=FaultPlan(nan_grads_at=[3]))
        assert net2.lr_scale() == 1.0     # 7 clean steps > the cooldown

    def test_backoff_replays_the_same_capture(self, fake_capture):
        net = mlp()
        net.fit(iterator(), steps_per_dispatch=2,
                nan_policy=NanRecovery(NanPolicy.BACKOFF_LR,
                                       cooldown_steps=100),
                faults=FaultPlan(nan_grads_at=[5]))
        scale = net.conf.base.updater._lr_scale
        assert net.lr_scale() == 0.5 and float(scale) == 0.5
        assert len(fake_capture) == 1 and fake_capture[0].replays == 5
        assert list(net._step_cache) == [(False, False, 2, "lr_scale")]
        assert any(t is scale for t in net._dispatch_state())

    def test_backoff_lr_scale_survives_resume(self, tmp_path):
        d = str(tmp_path / "c")
        pre = mlp()
        pre.fit(iterator(), checkpoint=CheckpointConfig(d, every_steps=2),
                nan_policy=NanRecovery(NanPolicy.BACKOFF_LR,
                                       cooldown_steps=100),
                faults=FaultPlan(nan_grads_at=[3], preempt_at_step=6))
        assert pre.lr_scale() == 0.5
        b = mlp()
        b.fit(iterator(), checkpoint=CheckpointConfig(d, resume=True),
              nan_policy=NanRecovery(NanPolicy.BACKOFF_LR,
                                     cooldown_steps=100))
        assert b.lr_scale() == 0.5

    def test_rollback_restores_last_checkpoint(self, tmp_path):
        d = str(tmp_path / "c")
        net = mlp()
        net.fit(iterator(), checkpoint=CheckpointConfig(d, every_steps=2),
                nan_policy=NanPolicy.ROLLBACK,
                faults=FaultPlan(nan_grads_at=[5]))
        assert net._iteration == 9      # rolled 5 -> 4, then 5 batches
        assert torch.isfinite(net.params()).all()
        with pytest.raises(NumericsPanicError, match="ROLLBACK requires"):
            mlp().fit(iterator(), nan_policy=NanPolicy.ROLLBACK,
                      faults=FaultPlan(nan_grads_at=[3]))

    def test_nonfinite_metric_counted(self):
        before = res.NONFINITE_STEPS.value
        mlp().fit(iterator(), nan_policy=NanPolicy.SKIP_STEP,
                  faults=FaultPlan(nan_grads_at=[2, 6]))
        assert res.NONFINITE_STEPS.value - before == 2

    def test_no_policy_no_read(self, monkeypatch):
        """Without a policy the session reads no loss on the host."""
        monkeypatch.setattr(res, "_host_losses", None)
        net = mlp()
        net.fit(iterator(), faults=FaultPlan(preempt_at_step=4))
        assert net._iteration == 4


# =============================================================== preemption
class TestPreemption:
    def test_mid_megastep_finishes_the_dispatch(self, tmp_path):
        d = str(tmp_path / "c")
        net = mlp()
        net.fit(iterator(), steps_per_dispatch=4,
                checkpoint=CheckpointConfig(d),
                faults=FaultPlan(preempt_at_step=2))
        assert net._iteration == 4
        _, manifest = CheckpointManager(CheckpointConfig(d)).latest_valid()
        assert manifest["status"] == "preempted" and manifest["step"] == 4

    def test_sigterm_checkpoints_and_returns(self, tmp_path):
        d = str(tmp_path / "c")
        net = mlp()

        class Bomb:
            def iterationDone(self, model, iteration, epoch):
                if iteration == 3:
                    os.kill(os.getpid(), signal.SIGTERM)
        net.setListeners(Bomb())
        net.fit(iterator(), checkpoint=CheckpointConfig(d))
        assert net._preempted and net._iteration < NBATCH
        _, manifest = CheckpointManager(CheckpointConfig(d)).latest_valid()
        assert manifest["status"] == "preempted"
        assert signal.getsignal(signal.SIGTERM) in (signal.SIG_DFL,
                                                    signal.Handlers.SIG_DFL)


# ============================================================== checkpoints
class TestCheckpointManager:
    def test_rotation_every_epochs_and_validation(self, tmp_path):
        d = str(tmp_path / "c")
        mlp().fit(iterator(), checkpoint=CheckpointConfig(d, every_steps=2,
                                                          keep_last=2))
        mgr = CheckpointManager(CheckpointConfig(d))
        assert [s for s, _ in mgr.checkpoints()] == [8, 10]
        assert not [e for e in os.listdir(d) if e.startswith(".tmp_")]
        path = mgr.checkpoints()[-1][1]
        with open(os.path.join(path, "model.zip"), "ab") as f:
            f.write(b"garbage")
        with pytest.raises(CorruptCheckpointError, match="model.zip"):
            mgr.validate(path)
        d2 = str(tmp_path / "e")
        mlp().fit(iterator(), epochs=2,
                  checkpoint=CheckpointConfig(d2, every_epochs=1))
        assert [s for s, _ in CheckpointManager(
            CheckpointConfig(d2)).checkpoints()] == [NBATCH, 2 * NBATCH]

    def test_corrupt_checkpoint_quarantined_resume_uses_older(self,
                                                              tmp_path):
        d = str(tmp_path / "c")
        a = mlp()
        a.fit(iterator())
        pre = mlp()
        pre.fit(iterator(), checkpoint=CheckpointConfig(d, every_steps=2,
                                                        keep_last=10),
                faults=FaultPlan(checkpoint_corrupt_at=[6],
                                 preempt_at_step=6))
        target = os.path.join(d, "ckpt_0000000006", "model.zip")
        with open(target, "r+b") as f:
            f.seek(os.path.getsize(target) // 2)
            f.write(b"\x00" * 64)
        with pytest.warns(UserWarning, match="quarantined corrupt"):
            b = mlp()
            b.fit(iterator(), checkpoint=CheckpointConfig(d, resume=True))
        assert any(e.startswith("quarantine_ckpt_0000000006")
                   for e in os.listdir(d))
        assert_training_state_equal(a, b)      # resumed from step 4

    def test_another_writer_of_the_job_keeps_its_checkpoint(self, tmp_path):
        # the old writer and the first survivor of a rank's loss both save
        # the agreed step: the one landed first stands and stays readable
        d = str(tmp_path / "c")
        a, b = mlp(seed=1), mlp(seed=2)
        a.fit(iterator())
        b.fit(iterator())
        first = CheckpointManager(CheckpointConfig(d))
        second = CheckpointManager(CheckpointConfig(d))
        second.job = first.job
        path = first.save(a)
        assert second.save(b) == path
        back = mlp(seed=3)
        got = second.restore(back, count_resume=False, step=NBATCH)
        assert got["manifest"]["job"] == first.job
        assert_training_state_equal(a, back)
        assert not [e for e in os.listdir(d) if e.startswith(".tmp_")]
        # the writer's own re-save of the step (preemption right after a
        # save) replaces its checkpoint
        first.save(a, status="preempted")
        assert first.validate(path)["status"] == "preempted"

    def test_a_fresh_run_replaces_an_old_runs_checkpoints(self, tmp_path):
        # a second fit into the same directory saves the same steps: its
        # own state lands, as in the JAX package, and a resume reads it
        d = str(tmp_path / "c")
        mlp(seed=1).fit(iterator(seed=1),
                        checkpoint=CheckpointConfig(d, every_steps=2))
        fresh = mlp()
        fresh.fit(iterator(), checkpoint=CheckpointConfig(d, every_steps=2))
        mgr = CheckpointManager(CheckpointConfig(d))
        assert [s for s, _ in mgr.checkpoints()] == [6, 8, 10]
        assert len({mgr.validate(p)["job"]
                    for _, p in mgr.checkpoints()}) == 1
        back = mlp(seed=3)
        mgr.restore(back, count_resume=False)
        assert_training_state_equal(fresh, back)

    def test_write_failure_retried_and_retry_io(self, tmp_path):
        d = str(tmp_path / "c")
        mlp().fit(iterator(), checkpoint=CheckpointConfig(
            d, every_steps=4, io_backoff=0.01),
            faults=FaultPlan(checkpoint_write_fail_at=[4]))
        mgr = CheckpointManager(CheckpointConfig(d))
        assert 4 in [s for s, _ in mgr.checkpoints()]
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("transient")
            return "done"
        assert res.retry_io(flaky, retries=3, backoff=0.001) == "done"
        with pytest.raises(OSError):
            res.retry_io(lambda: (_ for _ in ()).throw(OSError("x")),
                         retries=1, backoff=0.001)

    def test_normalizer_round_trip(self, tmp_path):
        d = str(tmp_path / "c")
        it = iterator()
        norm = NormalizerStandardize()
        norm.fit(it.data)
        it.setPreProcessor(norm)
        mlp().fit(it, checkpoint=CheckpointConfig(d, every_steps=5))
        path = CheckpointManager(CheckpointConfig(d)).checkpoints()[-1][1]
        assert os.path.exists(os.path.join(path, "normalizer.npz"))
        it2 = iterator()
        norm2 = NormalizerStandardize()
        it2.setPreProcessor(norm2)
        mlp().fit(it2, checkpoint=CheckpointConfig(d, resume=True))
        np.testing.assert_array_equal(norm2.mean, norm.mean)
        np.testing.assert_array_equal(norm2.std, norm.std)

    def test_transient_data_error_retried_permanent_propagates(self):
        a = mlp()
        a.fit(iterator(), faults=FaultPlan(data_error_at=[3]))
        b = mlp()
        b.fit(iterator())
        assert_training_state_equal(a, b)
        with pytest.raises(IOError, match="permanent"):
            mlp().fit(iterator(), faults=FaultPlan(
                data_error_at=[3], data_error_transient=False))
        assert issubclass(TransientDataError, IOError)

    def test_an_async_source_warns_of_approximate_cursors(self, tmp_path):
        with pytest.warns(UserWarning, match="APPROXIMATE"):
            it = AsyncDataSetIterator(iterator())
            try:
                mlp().fit(it, checkpoint=CheckpointConfig(str(tmp_path)))
            finally:
                it.close()


class TestAsyncCheckpointing:
    def test_validate_rotate_and_meta(self, tmp_path):
        d = str(tmp_path / "c")
        net = mlp()
        net.fit(iterator(), checkpoint=CheckpointConfig(
            d, every_steps=2, keep_last=2, async_write=True))
        mgr = CheckpointManager(CheckpointConfig(d))
        assert [s for s, _ in mgr.checkpoints()] == [8, 10]
        for _, p in mgr.checkpoints():
            mgr.validate(p)
        with zipfile.ZipFile(os.path.join(mgr.checkpoints()[-1][1],
                                          "model.zip")) as z:
            assert json.loads(z.read("meta.json"))["type"] == \
                "MultiLayerNetwork"
        assert res.CKPT_ASYNC_QUEUE.value == 0

    def test_the_snapshot_is_the_state_at_its_step(self, tmp_path):
        d = str(tmp_path / "c")
        net = mlp()
        kept = {}

        class Keep:
            def iterationDone(self, model, iteration, epoch):
                if iteration == 4:
                    kept["s"] = [t.detach().clone()
                                 for t in model._snapshot_tensors()]
        net.setListeners(Keep())
        net.fit(iterator(), checkpoint=CheckpointConfig(
            d, every_steps=4, keep_last=5, async_write=True))
        back = mlp()
        back._ensure_step_state()
        CheckpointManager(CheckpointConfig(d)).restore(back, step=4)
        for x, y in zip(back._snapshot_tensors(), kept["s"]):
            assert torch.equal(x, y)

    def test_writer_failure_surfaces_in_fit(self, tmp_path):
        with pytest.raises(res.AsyncCheckpointError,
                           match="background checkpoint write"):
            mlp().fit(iterator(), checkpoint=CheckpointConfig(
                str(tmp_path / "c"), every_steps=2, io_retries=0,
                async_write=True),
                faults=FaultPlan(checkpoint_write_fail_at=[2]))

    def test_write_failure_retried_in_the_writer(self, tmp_path):
        d = str(tmp_path / "c")
        mlp().fit(iterator(), checkpoint=CheckpointConfig(
            d, every_steps=4, io_backoff=0.01, async_write=True),
            faults=FaultPlan(checkpoint_write_fail_at=[4]))
        assert 4 in [s for s, _ in CheckpointManager(
            CheckpointConfig(d)).checkpoints()]


# ====================================================== across the packages
def _jax_pair():
    j = JMLN(_mlp_conf(JConf, jlayers, JInputType, jupd))
    j.init()
    t = MultiLayerNetwork(_mlp_conf(NeuralNetConfiguration, L, InputType,
                                    updaters)).init(device="cpu")
    return j, t


def _jax_iterator(shuffle=True):
    return jdata.ListDataSetIterator(jdata.DataSet(*arrays()), BATCH,
                                     shuffle=shuffle)


def _close(port_net, jax_net):
    np.testing.assert_allclose(port_net.params().numpy(),
                               np.asarray(jax_net.params()),
                               rtol=1e-6, atol=1e-6)
    for (n, k), u in zip(port_net._leaf_keys(),
                         [jax_net._opt_state[n][k] for n, k in
                          port_net._leaf_keys()]):
        for sk, v in u.items():
            np.testing.assert_allclose(
                port_net._opt_state[n][k][sk].numpy(), np.asarray(v),
                rtol=1e-6, atol=1e-6)
    assert port_net._iteration == jax_net._iteration
    assert int(port_net._t_dev) == int(np.asarray(jax_net._t_dev))


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path):
    d = str(tmp_path / "c")
    j, _ = _jax_pair()
    j.fit(_jax_iterator(), epochs=2,
          checkpoint=jres.CheckpointConfig(d, every_steps=3),
          faults=jfaults.FaultPlan(preempt_at_step=7))
    assert j._iteration == 7
    # each resume writes its own "preempted" checkpoint: one copy each
    shutil.copytree(d, d + "_port")
    jn, t = _jax_pair()
    jn.fit(_jax_iterator(), epochs=2,
           checkpoint=jres.CheckpointConfig(d, resume=True),
           faults=jfaults.FaultPlan(preempt_at_step=8))
    t.fit(iterator(shuffle=True), epochs=2,
          checkpoint=CheckpointConfig(d + "_port", resume=True),
          faults=FaultPlan(preempt_at_step=8))
    assert t._iteration == jn._iteration == 8
    _close(t, jn)


def test_a_port_checkpoint_resumes_in_jax(tmp_path):
    d = str(tmp_path / "c")
    _, t = _jax_pair()
    t.fit(iterator(shuffle=True), epochs=2,
          checkpoint=CheckpointConfig(d, every_steps=3),
          faults=FaultPlan(preempt_at_step=13))
    assert t._iteration == 13
    shutil.copytree(d, d + "_jax")
    j, tn = _jax_pair()
    tn.fit(iterator(shuffle=True), epochs=2,
           checkpoint=CheckpointConfig(d, resume=True),
           faults=FaultPlan(preempt_at_step=14))
    j.fit(_jax_iterator(), epochs=2,
          checkpoint=jres.CheckpointConfig(d + "_jax", resume=True),
          faults=jfaults.FaultPlan(preempt_at_step=14))
    assert tn._iteration == j._iteration == 14
    assert tn.getEpochCount() == j._epoch == 1
    _close(tn, j)
