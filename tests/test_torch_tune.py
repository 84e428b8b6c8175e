"""The port's ``tune/`` autotuner (CPU): twins of the JAX package's
``tests/test_tune.py`` — the search space, the persistent records, the
driver's search phases on ``trial_fn``/``parity_fn`` mocks with planted
optima, the loss-parity gate, ``fit(tune="auto")`` / ``warmup(tuned=
True)`` / registry load, the conv-stack lint's pointer at the tuner, and
the CLI (``main(argv)`` with ``--json`` on LeNet, then a fresh process
that applies the record). Each JAX case's counterpart is named in a
comment. ``TestHeldAgainstJax`` runs the same inputs through the JAX
package's ``tune/`` and the port's: the space's enumeration, seeded draws
and moves, the seam-scrubbed fingerprint, the record key under one
runtime string, and the whole search on the same mock costs and seed
(trial logs, pruned and rejected plans and winners equal). Those that
count captures on the CPU take the ``fake_capture`` stand-in graph of
``test_torch_compilecache.py``; the fresh child interpreter installs the
same stand-in. The JAX package's slow ResNet-50
case needs the card here (marked ``cuda``)."""

import json
import os
import subprocess
import sys
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.analysis import churn as _churn
from deeplearning4j_tpu_torch.analysis import layout as _layout
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.nn import compilecache as cc
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import (ConvolutionLayer, DenseLayer,
                                                OutputLayer, SubsamplingLayer)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.train import stepping
from deeplearning4j_tpu_torch.tune import driver as tdriver
from deeplearning4j_tpu_torch.tune import records as trecords
from deeplearning4j_tpu_torch.tune.space import (AXES, TuningPlan,
                                                 TuningSpace, axis_priority)

from deeplearning4j_tpu.tune import driver as jdriver
from deeplearning4j_tpu.tune import records as jrecords
from deeplearning4j_tpu.tune import space as jspace
from test_torch_compilecache import fake_capture  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def store(tmp_path):
    """A per-test tuning-record directory, warned-set cleared."""
    trecords.configure(str(tmp_path))
    trecords.reset_warned()
    yield str(tmp_path)
    trecords.reset_configuration()
    trecords.reset_warned()


@pytest.fixture(autouse=True)
def _no_disk_tier():
    cc.configure(None)
    cc.reset_stats()
    yield
    cc.reset_configuration()
    cc.reset_stats()


def tiny_net(seed=7):
    conf = (NeuralNetConfiguration.Builder().seed(seed).weightInit("relu")
            .list()
            .layer(ConvolutionLayer(kernelSize=(3, 3), padding=(1, 1),
                                    nOut=8, activation="relu"))
            .layer(SubsamplingLayer(poolingType="max", kernelSize=(2, 2),
                                    stride=(2, 2)))
            .layer(DenseLayer(nOut=16, activation="relu"))
            .layer(OutputLayer(nOut=4, lossFunction="mcxent",
                               activation="softmax"))
            .setInputType(InputType.convolutional(8, 8, 3))
            .build())
    return MultiLayerNetwork(conf).init(device="cpu")


def tiny_data(n=4):
    rng = np.random.RandomState(0)
    x = rng.randn(n, 3, 8, 8).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, n)]
    return x, y


# ------------------------------------------------------------- the space
class TestTuningSpace:

    # twin of TestTuningSpace::test_for_model_enumeration_deterministic
    def test_for_model_enumeration_deterministic(self):
        space = TuningSpace.for_model(max_steps_per_dispatch=16)
        assert space.size == 96
        a = [p.signature() for p in space.enumerate_plans()]
        b = [p.signature() for p in space.enumerate_plans()]
        assert a == b
        assert len(set(a)) == 96

    # twin of TestTuningSpace::test_sample_deterministic_across_seeds
    def test_sample_deterministic_across_seeds(self):
        space = TuningSpace.for_model(max_steps_per_dispatch=16)
        s1 = [p.signature() for p in space.sample(10, seed=3)]
        s2 = [p.signature() for p in space.sample(10, seed=3)]
        s3 = [p.signature() for p in space.sample(10, seed=4)]
        assert s1 == s2
        assert s1 != s3
        assert len(set(s1)) == 10

    # twin of TestTuningSpace::test_plan_config_roundtrip_and_replace
    def test_plan_config_roundtrip_and_replace(self):
        plan = TuningPlan(compute_layout="NHWC", fuse_epilogues=True,
                          steps_per_dispatch=4, precision="bf16",
                          prefetch=0)
        back = TuningPlan.from_config(plan.to_config())
        assert back.signature() == plan.signature()
        assert back == plan
        other = plan.replace(precision=None)
        assert other.precision is None
        assert other.compute_layout == "NHWC"
        assert other != plan

    # twin of TestTuningSpace::test_plan_validation
    def test_plan_validation(self):
        with pytest.raises(ValueError):
            TuningPlan(compute_layout="NCWH")
        with pytest.raises(ValueError):
            TuningPlan(steps_per_dispatch=0)
        with pytest.raises(ValueError):
            TuningPlan(prefetch=-1)
        with pytest.raises(ValueError):
            TuningSpace({"bogus_axis": (1, 2)})

    # twin of TestTuningSpace::test_neighbors_differ_in_exactly_one_axis
    def test_neighbors_differ_in_exactly_one_axis(self):
        space = TuningSpace.for_model(max_steps_per_dispatch=16)
        base = space.default_plan()
        base_cfg = base.to_config()
        for axis, nb in space.neighbors(base, list(AXES)):
            diff = [k for k, v in nb.to_config().items()
                    if base_cfg.get(k) != v]
            assert diff == [axis]

    # twin of TestTuningSpace::test_axis_priority_offender_seeded
    def test_axis_priority_offender_seeded(self):
        assert axis_priority(None) == list(AXES)
        conv = SimpleNamespace(
            top_offenders=lambda n: ["conv2d_nchw fwd", "maxpool"])
        order = axis_priority(conv)
        assert order[0] == "compute_layout"
        mm = SimpleNamespace(top_offenders=lambda n: ["dense matmul"])
        assert axis_priority(mm)[0] == "precision"


# ----------------------------------------------------------- the records
class TestTuningRecords:

    # twin of TestTuningRecords::test_put_lookup_roundtrip
    def test_put_lookup_roundtrip(self, store):
        plan = TuningPlan(compute_layout="NHWC", steps_per_dispatch=4)
        rec = trecords.TuningRecord("fp-abc", plan, cost_s=0.010,
                                    default_cost_s=0.015, trials=12,
                                    model_name="tiny")
        path = trecords.put(rec)
        assert path is not None and os.path.exists(path)
        assert os.path.basename(path).startswith("tr_")
        got = trecords.lookup("fp-abc")
        assert got is not None
        assert got.plan.signature() == plan.signature()
        assert got.speedup == pytest.approx(1.5)
        assert got.model_name == "tiny"

    # twin of TestTuningRecords::test_key_isolation_mesh_backend_fp
    def test_key_isolation_mesh_backend_fp(self, store):
        plan = TuningPlan()
        trecords.put(trecords.TuningRecord("fp-a", plan, cost_s=0.01))
        assert trecords.lookup("fp-a") is not None
        assert trecords.lookup("fp-a", mesh="data=8") is None
        assert trecords.lookup("fp-a", backend="tpu") is None
        assert trecords.lookup("fp-b") is None

    # twin of TestTuningRecords::test_corrupt_record_quarantined
    def test_corrupt_record_quarantined(self, store):
        plan = TuningPlan(precision="bf16")
        path = trecords.put(
            trecords.TuningRecord("fp-q", plan, cost_s=0.01))
        raw = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(raw[:-8] + b"XXXXXXXX")
        with pytest.warns(UserWarning, match="quarantine"):
            assert trecords.lookup("fp-q") is None
        names = os.listdir(store)
        assert any(n.startswith("quarantine_") for n in names)
        assert not any(n.startswith("tr_") for n in names)

    # twin of TestTuningRecords::test_disabled_store_is_inert
    def test_disabled_store_is_inert(self, store):
        trecords.configure(None)
        with pytest.warns(UserWarning, match="disabled"):
            assert trecords.put(
                trecords.TuningRecord("fp-x", TuningPlan(),
                                      cost_s=0.01)) is None
        assert trecords.lookup("fp-x") is None
        assert trecords.record_dir() is None

    # twin of TestTuningRecords::test_mesh_signature_forms (no port mesh
    # yet: an object whose shape maps axis -> size stands in for one)
    def test_mesh_signature_forms(self):
        assert trecords.mesh_signature(None) == "none"
        assert trecords.mesh_signature("data=8") == "data=8"
        mesh = SimpleNamespace(shape={"data": 8, "model": 1})
        sig = trecords.mesh_signature(mesh)
        assert "=" in sig
        assert sig == trecords.mesh_signature(
            SimpleNamespace(shape={"data": 8, "model": 1}))
        assert trecords.mesh_signature(
            SimpleNamespace(signature=lambda: "plan-x")) == "plan-x"

    # twin of TestTuningRecords::test_fingerprint_is_seam_neutral
    def test_fingerprint_is_seam_neutral(self):
        net = tiny_net()
        fp = trecords.model_fingerprint(net)
        TuningPlan(compute_layout="NHWC", fuse_epilogues=True,
                   precision="bf16").apply(net)
        assert trecords.model_fingerprint(net) == fp
        other = MultiLayerNetwork(
            (NeuralNetConfiguration.Builder().seed(7).weightInit("relu")
             .list()
             .layer(DenseLayer(nOut=16, activation="relu"))
             .layer(OutputLayer(nOut=4, lossFunction="mcxent",
                                activation="softmax"))
             .setInputType(InputType.feedForward(8)).build())
        ).init(device="cpu")
        assert trecords.model_fingerprint(other) != fp

    # twin of TestTuningRecords::test_auto_apply_warns_once_per_key
    def test_auto_apply_warns_once_per_key(self, store):
        net = tiny_net()
        with pytest.warns(UserWarning, match="no tuning record"):
            assert trecords.auto_apply(net) is None
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            assert trecords.auto_apply(net) is None
        assert not [x for x in w
                    if "no tuning record" in str(x.message)]
        trecords.reset_warned()
        with pytest.warns(UserWarning, match="no tuning record"):
            trecords.auto_apply(net)

    # port only: the record key carries the runtime identity (torch,
    # CUDA, the card, the kernel sources) where JAX keys its version
    def test_key_carries_the_runtime(self, monkeypatch):
        k = trecords.record_key("fp")
        monkeypatch.setattr(cc, "_RUNTIME_FP", cc.runtime_fingerprint()
                            + "-another-card")
        assert trecords.record_key("fp") != k


# ---------------------------------------------------- the search driver
TARGET = TuningPlan(compute_layout="NHWC", fuse_epilogues=True,
                    steps_per_dispatch=4, precision="bf16", prefetch=0)
_COST_AXES = ("compute_layout", "fuse_epilogues", "steps_per_dispatch",
              "precision", "prefetch")


def planted_cost(plan):
    """Every axis matching TARGET shaves 12%: greedy refinement climbs to
    the optimum."""
    matches = sum(getattr(plan, a) == getattr(TARGET, a)
                  for a in _COST_AXES)
    return 1.0 - 0.12 * matches


class TestDriver:

    # twin of TestDriver::test_finds_planted_optimum
    def test_finds_planted_optimum(self):
        space = TuningSpace({"compute_layout": ("NCHW", "NHWC"),
                             "fuse_epilogues": (False, True),
                             "steps_per_dispatch": (1, 4),
                             "precision": (None, "bf16"),
                             "prefetch": (0, 2)})
        calls = []

        def trial(plan):
            calls.append(plan.signature())
            return planted_cost(plan)

        res = tdriver.tune(object(), None, None, budget=48, reps=1,
                           space=space, trial_fn=trial,
                           parity_fn=lambda p: True, persist=False)
        assert res.best_plan == TARGET
        assert res.best_cost_s == pytest.approx(0.4)
        assert res.default_cost_s == pytest.approx(1.0)
        assert res.speedup == pytest.approx(2.5)
        assert len(calls) <= 48
        assert len(calls) == len(set(calls))

    # twin of TestDriver::test_budget_respected_and_refinement_runs
    def test_budget_respected_and_refinement_runs(self):
        space = TuningSpace.for_model(max_steps_per_dispatch=16)
        calls = []

        def trial(plan):
            calls.append(plan.signature())
            return planted_cost(plan)

        res = tdriver.tune(object(), None, None, budget=24, reps=1,
                           space=space, trial_fn=trial,
                           parity_fn=lambda p: True, persist=False)
        assert len(calls) <= 24
        assert len(calls) == len(set(calls))
        assert res.best_cost_s < res.default_cost_s
        phases = {t.phase for t in res.trials}
        assert "default" in phases and "explore" in phases
        assert "refine" in phases

    # twin of TestDriver::test_parity_gate_rejects_back_to_default
    def test_parity_gate_rejects_back_to_default(self):
        space = TuningSpace({"precision": (None, "bf16")})
        res = tdriver.tune(object(), None, None, budget=4, reps=1,
                           space=space, trial_fn=planted_cost,
                           parity_fn=lambda p: False, persist=False)
        assert res.best_plan == space.default_plan()
        assert res.rejected
        plan, reason = res.rejected[0]
        assert "loss parity" in reason
        assert plan.precision == "bf16"

    # twin of TestDriver::test_baseline_failure_raises
    def test_baseline_failure_raises(self):
        def broken(plan):
            raise ValueError("no device")
        with pytest.raises(RuntimeError, match="baseline"):
            tdriver.tune(object(), None, None, budget=4,
                         space=TuningSpace({"prefetch": (0, 2)}),
                         trial_fn=broken, persist=False)

    # twin of TestDriver::test_real_search_persists_record
    def test_real_search_persists_record(self, store):
        x, y = tiny_data()
        space = TuningSpace({"steps_per_dispatch": (1, 2)})
        res = tdriver.tune(lambda: tiny_net(), x, y, budget=3, reps=1,
                           base_steps=2, space=space,
                           parity_guard=False, model_name="tiny")
        assert res.record is not None
        assert any(n.startswith("tr_") for n in os.listdir(store))
        got = trecords.lookup(tiny_net())
        assert got is not None
        assert got.plan.signature() == res.best_plan.signature()
        assert got.trials == len(res.trials)

    # twin of TestDriver::test_loss_parity_gate_real_curves
    def test_loss_parity_gate_real_curves(self):
        x, y = tiny_data()
        factory = lambda: tiny_net(seed=5)    # noqa: E731
        assert tdriver.loss_parity(factory, TuningPlan("NHWC"), x, y,
                                   steps=3)

        class BrokenPlan(TuningPlan):
            """A plan whose apply() perturbs the weights."""
            def apply(self, model):
                ds = DataSet(x, y)
                for _ in range(4):
                    model.fit(ds)
                return super().apply(model)

        assert not tdriver.loss_parity(factory, BrokenPlan(), x, y,
                                       steps=3)

    # port only: a plan that fails to apply is a failed trial, never a
    # skipped one, and the search carries on
    def test_a_plan_that_fails_is_a_failed_trial(self):
        def trial(plan):
            if plan.precision == "bf16":
                raise RuntimeError("cannot apply")
            return planted_cost(plan)
        res = tdriver.tune(object(), None, None, budget=4, reps=1,
                           space=TuningSpace({"precision": (None, "bf16"),
                                              "prefetch": (0, 2)}),
                           trial_fn=trial, parity_fn=lambda p: True,
                           persist=False)
        failed = [t for t in res.trials if not t.ok]
        assert failed and all(t.plan.precision == "bf16" for t in failed)
        assert "cannot apply" in failed[0].error
        assert res.best_plan.precision is None

    # port only: every trial times a captured step, as the JAX trials
    # time a compiled one; a K=1 plan without the disk tier included
    @pytest.mark.parametrize("k", [1, 2])
    def test_a_trial_times_a_captured_step(self, fake_capture, k):
        x, y = tiny_data()
        net = tiny_net()
        cc.reset_stats()
        cost = tdriver._measure_plan(net, TuningPlan(steps_per_dispatch=k),
                                     x, y, reps=2, base_steps=2)
        assert np.isfinite(cost) and cost > 0
        assert len(fake_capture) == 1
        assert net._step_for(False, k).warmed_signatures() == 1
        # captured before the warm pass: it and both timed passes replay
        # (3 passes of 2 / k dispatches), none misses
        assert cc.cache_stats()["memory"] == {"hits": 3 * 2 // k,
                                              "misses": 0}
        assert cc.cache_stats()["compile_seconds"]["cold_compiles"] == 1

    # port only: a plan whose step fails to capture is a failed trial,
    # never one timed eagerly
    def test_a_step_that_fails_to_capture_is_a_failed_trial(
            self, fake_capture, monkeypatch):
        record = cc._record

        def second_fails(fn, static, **kw):
            if fake_capture:
                raise RuntimeError("out of memory")
            return record(fn, static, **kw)

        monkeypatch.setattr(cc, "_record", second_fails)
        x, y = tiny_data()
        with pytest.warns(UserWarning, match="capture .* failed"):
            res = tdriver.tune(lambda: tiny_net(), x, y, budget=3, reps=1,
                               base_steps=2, persist=False,
                               parity_guard=False,
                               space=TuningSpace({"steps_per_dispatch":
                                                  (1, 2)}))
        assert [t.plan.steps_per_dispatch for t in res.trials if t.ok] == [1]
        failed = [t for t in res.trials if not t.ok]
        assert failed and all(t.plan.steps_per_dispatch == 2
                              and "was not captured" in t.error
                              for t in failed)
        assert res.best_plan.steps_per_dispatch == 1

    # port only: static pruning by the H100 cost model records reasons
    def test_cost_pruner_records_reasons(self):
        x, y = tiny_data()
        res = tdriver.tune(lambda: tiny_net(), x, y, budget=3, reps=1,
                           base_steps=1, persist=False, parity_guard=False,
                           space=TuningSpace({"prefetch": (0, 2)}),
                           pruner=lambda p: "dominated" if p.prefetch == 0
                           else None)
        assert [(p.prefetch, r) for p, r in res.pruned] == \
            [(0, "dominated")]
        assert all(t.plan.prefetch == 2 for t in res.trials)


# ------------------------------------------ held against the JAX package
# The same inputs through the JAX package's tune/ and the port's: the
# space's enumeration, draws and moves, the seam-scrubbed fingerprint and
# the record key, and the whole search on the same mock costs and seed.
_SPACES = {
    "for_model_k16": lambda S: S.for_model(max_steps_per_dispatch=16),
    "for_model_k4": lambda S: S.for_model(max_steps_per_dispatch=4),
    "for_model_k1_serving": lambda S: S.for_model(max_steps_per_dispatch=1,
                                                  serving=True),
    "custom": lambda S: S({"compute_layout": ("NCHW", "NHWC"),
                           "steps_per_dispatch": (1, 2, 8),
                           "precision": (None, "bf16")}),
}


def _both_spaces(name):
    return _SPACES[name](TuningSpace), _SPACES[name](jspace.TuningSpace)


def _sigs(plans):
    return [p.signature() for p in plans]


def _as_jax(plan):
    return jspace.TuningPlan.from_config(plan.to_config())


class TestHeldAgainstJax:

    @pytest.mark.parametrize("name", sorted(_SPACES))
    def test_enumeration_and_configs(self, name):
        ps, js = _both_spaces(name)
        assert ps.size == js.size
        assert _sigs(ps.enumerate_plans()) == _sigs(js.enumerate_plans())
        assert [p.to_config() for p in ps.enumerate_plans()] == \
            [p.to_config() for p in js.enumerate_plans()]
        assert ps.default_plan().signature() == \
            js.default_plan().signature()

    @pytest.mark.parametrize("name", sorted(_SPACES))
    @pytest.mark.parametrize("seed", [0, 3, 17])
    def test_sample(self, name, seed):
        ps, js = _both_spaces(name)
        for n in (1, 5, ps.size - 1, ps.size + 3):
            assert _sigs(ps.sample(n, seed=seed)) == \
                _sigs(js.sample(n, seed=seed))

    @pytest.mark.parametrize("offenders", [
        None, ["conv2d_nchw fwd", "maxpool"], ["dense matmul"],
        ["batch_norm"], "raises"])
    def test_axis_priority_and_neighbors(self, offenders):
        if offenders is None:
            timings = None
        elif offenders == "raises":
            def boom(n):
                raise RuntimeError("no table")
            timings = SimpleNamespace(top_offenders=boom)
        else:
            timings = SimpleNamespace(top_offenders=lambda n: offenders)
        order = axis_priority(timings)
        assert order == jspace.axis_priority(timings)
        ps, js = _both_spaces("for_model_k16")
        for plan in ps.sample(6, seed=1) + [ps.default_plan()]:
            mine = [(a, p.signature()) for a, p in ps.neighbors(plan, order)]
            theirs = [(a, p.signature())
                      for a, p in js.neighbors(_as_jax(plan), order)]
            assert mine == theirs

    @pytest.mark.parametrize("zoo_name", ["LeNet", "SimpleCNN", "ResNet50"])
    def test_zoo_fingerprints(self, zoo_name):
        from deeplearning4j_tpu.models import zoo as jzoo
        from deeplearning4j_tpu_torch.models import zoo as pzoo
        mine = getattr(pzoo, zoo_name)(num_classes=10).conf_builder().conf
        theirs = getattr(jzoo, zoo_name)(num_classes=10).conf_builder().conf
        assert trecords.model_fingerprint(mine) == \
            jrecords.model_fingerprint(theirs)

    def test_scrubbed_fingerprint_of_one_json(self):
        doc = {"seed": 7, "compute_layout": "NHWC",
               "layers": [{"type": "conv", "data_format": "NHWC",
                           "nOut": [8, {"compute_layout": "NCHW"}]},
                          {"type": "dense", "nOut": 4}],
               "nested": {"data_format": "NCHW", "keep": [1, 2.5, None]}}
        for d in (doc, {k: v for k, v in doc.items()
                        if k != "compute_layout"}):
            conf = SimpleNamespace(to_json=lambda d=d: json.dumps(d))
            assert trecords._scrub_seams(d) == jrecords._scrub_seams(d)
            assert trecords.model_fingerprint(conf) == \
                jrecords.model_fingerprint(conf)

    @pytest.mark.parametrize("mesh", [
        None, "data=8", SimpleNamespace(shape={"data": 4, "model": 2}),
        SimpleNamespace(signature=lambda: "plan-x")])
    @pytest.mark.parametrize("backend", ["cuda", "tpu"])
    def test_record_key_with_one_runtime(self, monkeypatch, mesh, backend):
        monkeypatch.setattr(trecords, "_runtime", lambda: "runtime-1")
        monkeypatch.setattr(jrecords, "_jax_version", lambda: "runtime-1")
        assert trecords.mesh_signature(mesh) == \
            jrecords.mesh_signature(mesh)
        assert trecords.record_key("fp-abc", mesh, backend) == \
            jrecords.record_key("fp-abc", mesh, backend)

    @pytest.mark.parametrize("case", [
        "planted_k16_seed0", "planted_k16_seed5", "planted_custom",
        "parity_rejects_bf16", "pruned_nchw", "failing_k8"])
    def test_search_on_mock_costs(self, case):
        name = "custom" if case == "planted_custom" else "for_model_k16"
        seed = 5 if case.endswith("seed5") else 0
        kw = dict(budget=16 if case == "planted_custom" else 24, reps=2,
                  seed=seed, persist=False)

        def cost(plan):
            if case == "failing_k8" and plan.steps_per_dispatch == 8:
                raise RuntimeError("cannot apply")
            return planted_cost(plan)

        def parity(plan):
            return not (case == "parity_rejects_bf16"
                        and plan.precision == "bf16")

        def pruner(plan):
            if case == "pruned_nchw" and plan.compute_layout == "NCHW":
                return "dominated: predicted slower"
            return None

        runs = []
        for drv, space in ((tdriver, _SPACES[name](TuningSpace)),
                             (jdriver, _SPACES[name](jspace.TuningSpace))):
            res = drv.tune(object(), None, None, space=space, trial_fn=cost,
                           parity_fn=parity, pruner=pruner, **kw)
            runs.append({
                "trials": [(t.phase, t.plan.signature(), t.cost_s, t.reps,
                            t.ok, t.error) for t in res.trials],
                "pruned": [(p.signature(), r) for p, r in res.pruned],
                "rejected": [(p.signature(), r) for p, r in res.rejected],
                "best": (res.best_plan.signature(), res.best_cost_s,
                         res.default_cost_s, res.speedup)})
        assert runs[0] == runs[1]
        got = runs[0]
        assert got["trials"]
        assert bool(got["pruned"]) == (case == "pruned_nchw")
        assert bool(got["rejected"]) == (case == "parity_rejects_bf16")
        assert any(not t[4] for t in got["trials"]) == (case == "failing_k8")


# -------------------------------------------------- fit-level auto-apply
class TestApplyTunedPlan:

    # twin of TestApplyTunedPlan::test_plan_instance_applies_direct
    def test_plan_instance_applies_direct(self):
        net = tiny_net()
        plan = TuningPlan(compute_layout="NHWC", fuse_epilogues=True,
                          steps_per_dispatch=4, prefetch=0)
        k, p = stepping.apply_tuned_plan(net, plan, 1, 2)
        assert (k, p) == (4, 0)
        assert net._compute_layout == "NHWC"
        assert net._fuse_epilogues is True

    # twin of TestApplyTunedPlan::test_caller_overrides_win
    def test_caller_overrides_win(self):
        net = tiny_net()
        plan = TuningPlan(steps_per_dispatch=4, prefetch=0)
        k, p = stepping.apply_tuned_plan(net, plan, 2, 2)
        assert (k, p) == (2, 0)
        k, p = stepping.apply_tuned_plan(net, plan, 1, 4)
        assert (k, p) == (4, 4)

    # twin of TestApplyTunedPlan::test_bad_value_raises
    def test_bad_value_raises(self):
        with pytest.raises(ValueError, match="TuningPlan"):
            stepping.apply_tuned_plan(tiny_net(), "bogus", 1, 2)

    # twin of TestApplyTunedPlan::test_auto_consults_store
    def test_auto_consults_store(self, store):
        net = tiny_net()
        plan = TuningPlan(compute_layout="NHWC", steps_per_dispatch=2)
        trecords.put(trecords.TuningRecord(
            trecords.model_fingerprint(net), plan, cost_s=0.01))
        k, p = stepping.apply_tuned_plan(net, "auto", 1, 2)
        assert k == 2
        assert net._compute_layout == "NHWC"


# --------------------------------------------- end-to-end apply surfaces
class TestAutoApplyEndToEnd:

    def _seed_record(self, net, mesh=None, k=2):
        plan = TuningPlan(compute_layout="NHWC", fuse_epilogues=True,
                          steps_per_dispatch=k, prefetch=0)
        trecords.put(trecords.TuningRecord(
            trecords.model_fingerprint(net), plan, cost_s=0.005,
            default_cost_s=0.010, mesh=mesh))
        return plan

    # twin of TestAutoApplyEndToEnd::test_fit_auto_applies_with_zero_churn
    def test_fit_auto_applies_with_zero_churn(self, store):
        net = tiny_net()
        plan = self._seed_record(net)
        x, y = tiny_data()
        batches = [DataSet(x, y)] * plan.steps_per_dispatch
        net.fit(batches, tune="auto")
        assert net._compute_layout == "NHWC"
        assert net._fuse_epilogues is True
        det = _churn.get_churn_detector()
        det.reset()
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            net.fit(batches, tune="auto")
            net.fit(batches, tune="auto")
        assert not [x for x in w if "no tuning record" in str(x.message)]
        counts = [det.signature_count(s, owner=net)
                  for s in ("MultiLayerNetwork.fit",
                            "MultiLayerNetwork.megastep")]
        assert all(c <= 1 for c in counts)
        assert any(c == 1 for c in counts)

    # twin of TestAutoApplyEndToEnd::test_warmup_tuned_applies_plan
    def test_warmup_tuned_applies_plan(self, store):
        net = tiny_net()
        self._seed_record(net)
        cc.warmup(net, [((4, 3, 8, 8), (4, 4))], tuned=True)
        assert net._compute_layout == "NHWC"
        assert net._fuse_epilogues is True

    # twin of TestAutoApplyEndToEnd::test_registry_load_tuned_applies_plan
    def test_registry_load_tuned_applies_plan(self, store):
        from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
        reg = ModelRegistry(device="cpu")
        try:
            net = tiny_net()
            self._seed_record(net)
            with pytest.warns(UserWarning, match="W111"):
                ver = reg.load("tuned-model", net, warm=False, tuned=True)
            assert ver == 1
            assert net._compute_layout == "NHWC"
            assert net._fuse_epilogues is True
        finally:
            reg.close()


# --------------------------------------------- proactive conv-stack lint
class TestConvStackLint:

    def _located(self, n=3, fmt=None):
        out = []
        for i in range(n):
            layer = ConvolutionLayer(kernelSize=(3, 3), nOut=8,
                                     activation="relu")
            if fmt is not None:
                layer.data_format = fmt
            out.append((f"layer[{i}]", layer))
        return out

    # twin of TestConvStackLint::test_fires_on_tpu_backend (the port's
    # channels-last device is the card)
    def test_fires_on_a_cuda_device(self):
        diags = _layout.lint_conv_stack(self._located(3), "NCHW", "cuda")
        assert len(diags) == 1
        d = diags[0]
        assert d.code == "DL4J-W101"
        assert "3 conv layers" in d.message
        assert "relayout" in d.message
        assert "tune" in d.fix_hint

    # twin of TestConvStackLint::test_silent_off_tpu_and_when_nhwc
    def test_silent_off_the_card_and_when_nhwc(self):
        located = self._located(3)
        assert _layout.lint_conv_stack(located, "NCHW", "cpu") == []
        assert _layout.lint_conv_stack(located, "NCHW", None) == []
        assert _layout.lint_conv_stack(located, "NHWC", "cuda") == []
        assert _layout.lint_conv_stack(self._located(3, fmt="NHWC"),
                                       "NCHW", "cuda") == []
        assert _layout.lint_conv_stack(self._located(1), "NCHW",
                                       "cuda") == []

    # twin of TestConvStackLint::test_validate_flags_then_clean_after_seam
    def test_validate_flags_then_clean_after_seam(self, monkeypatch):
        from deeplearning4j_tpu_torch.analysis import analyzer
        net = MultiLayerNetwork(
            (NeuralNetConfiguration.Builder().seed(7).weightInit("relu")
             .list()
             .layer(ConvolutionLayer(kernelSize=(3, 3), padding=(1, 1),
                                     nOut=8, activation="relu"))
             .layer(ConvolutionLayer(kernelSize=(3, 3), padding=(1, 1),
                                     nOut=8, activation="relu"))
             .layer(OutputLayer(nOut=4, lossFunction="mcxent",
                                activation="softmax"))
             .setInputType(InputType.convolutional(8, 8, 3))
             .build())).init(device="cpu")
        monkeypatch.setattr(analyzer, "_device_type", lambda t: "cuda")
        report = net.validate()
        hits = [d for d in report if d.code == "DL4J-W101"
                and "relayout" in d.message]
        assert hits
        net.setComputeLayout("NHWC")
        report = net.validate()
        assert not [d for d in report if d.code == "DL4J-W101"
                    and "relayout" in d.message]


# ------------------------------------------------------ CLI + acceptance
_FRESH = r"""
import contextlib, sys
import numpy as np
import torch
from deeplearning4j_tpu_torch.nn import compilecache as cc
from deeplearning4j_tpu_torch.tune import records
from deeplearning4j_tpu_torch.models.zoo import LeNet
from deeplearning4j_tpu_torch.data.dataset import DataSet


# the CPU stand-in for a CUDA graph (test_torch_compilecache.fake_capture)
class FakeGraph:
    def __init__(self, fn, args, out):
        self.fn, self.args, self.out = fn, args, out

    def replay(self):
        res = self.fn(*self.args)
        with torch.no_grad():
            if isinstance(res, torch.Tensor):
                self.out.copy_(res)
            else:
                for o, r in zip(self.out, res):
                    o.copy_(r)


current = {}


def record(fn, static):
    with cc.preserved(current["fn"]()):
        out = fn(*static)
    return FakeGraph(fn, static, out), out


orig_acquire = cc.CachedDispatch._acquire


def acquire(self, args, sig):
    current["fn"] = self.state
    return orig_acquire(self, args, sig)


cc._on_card = lambda args: any(isinstance(a, torch.Tensor) for a in args)
cc._side_stream = lambda args: contextlib.nullcontext()
cc._record = record
cc.CachedDispatch._acquire = acquire

records.configure(sys.argv[1])
cc.configure(sys.argv[2])
net = LeNet(seed=11, num_classes=10, input_shape=(3, 32, 32)).init(
    device="cpu")
plan = records.best_plan(net)
assert plan is not None, "fresh process found no tuning record"
rng = np.random.RandomState(0)
x = rng.randn(4, 3, 32, 32).astype(np.float32)
y = np.eye(10, dtype=np.float32)[rng.randint(0, 10, 4)]
batches = [DataSet(x, y)] * max(1, plan.steps_per_dispatch)
net.fit(batches, tune="auto")
assert net._compute_layout == plan.compute_layout
stats = cc.cache_stats()
assert stats["compile_seconds"]["cold_compiles"] == 0, stats
assert stats["disk"]["hits"] >= 1, stats
print("FRESH-OK", plan.signature())
"""


class TestCLI:

    # twin of TestCLI::test_cli_tunes_persists_and_fresh_process_applies
    # (the search runs in-process through main(argv), under the CPU
    # capture stand-in, so its captures enter the manifest)
    def test_cli_tunes_persists_and_fresh_process_applies(
            self, tmp_path, capsys, fake_capture):
        from deeplearning4j_tpu_torch.tune.__main__ import main
        rdir, cdir = str(tmp_path / "records"), str(tmp_path / "cc")
        try:
            assert main(["lenet", "--budget", "8", "--batch", "4", "--hw",
                         "32", "--classes", "10", "--reps", "1",
                         "--steps", "2", "--dir", rdir, "--cache-dir",
                         cdir, "--no-parity", "--json", "--device",
                         "cpu"]) == 0
        finally:
            trecords.reset_configuration()
        payload = json.loads(capsys.readouterr().out)
        assert payload["model"] == "LeNet"
        assert payload["trials"] == 8
        assert payload["best_ms_per_step"] <= payload["default_ms_per_step"]
        assert payload["speedup"] >= 1.0
        assert payload["persisted"] is True
        assert len(payload["trial_log"]) == 8
        assert any(n.startswith("tr_") for n in os.listdir(rdir))
        assert any(n.startswith("cc_") for n in os.listdir(cdir))

        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env.pop("DL4J_TPU_COMPILE_CACHE_DIR", None)
        proc2 = subprocess.run([sys.executable, "-c", _FRESH, rdir, cdir],
                               cwd=REPO, env=env, capture_output=True,
                               text=True, timeout=240)
        assert proc2.returncode == 0, \
            proc2.stderr[-2000:] + proc2.stdout[-500:]
        assert "FRESH-OK " + payload["signature"] in proc2.stdout

    # twin of TestCLI::test_resnet50_budget_20_reduces_step_time (slow in
    # the JAX package; here it needs the card), with the JAX case's flags
    @pytest.mark.cuda
    def test_resnet50_budget_20_reduces_step_time(self, tmp_path):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
        rdir, cdir = str(tmp_path / "records"), str(tmp_path / "cc")
        proc = subprocess.run(
            [sys.executable, "-m", "deeplearning4j_tpu_torch.tune",
             "resnet50", "--budget", "20", "--batch", "2", "--hw", "32",
             "--classes", "10", "--reps", "1", "--steps", "2",
             "--dir", rdir, "--cache-dir", cdir, "--no-parity", "--json"],
            cwd=REPO, capture_output=True, text=True, timeout=1800)
        assert proc.returncode == 0, proc.stderr[-2000:]
        payload = json.loads(proc.stdout)
        log = payload["trial_log"]
        assert all(t["error"] is None for t in log), log
        # the budget is spent unless the search converged first: its one
        # early exit is a refinement sweep that measured every neighbour
        # of the incumbent without beating it (the JAX case's "== 20"
        # assumes no such sweep; trials that replay captured steps can
        # converge at B=2)
        assert payload["trials"] <= 20
        if payload["trials"] < 20:
            best = TuningPlan.from_config(payload["best_plan"])
            seen = {t["signature"] for t in log}
            assert all(nb.signature() in seen for _, nb in
                       TuningSpace.for_model().neighbors(best)), log
        assert payload["persisted"] is True
        assert payload["best_ms_per_step"] < payload["default_ms_per_step"]
        assert payload["speedup"] > 1.0


# port only: the CLI (like every entry point) runs on the card unless told
# --device cpu, and raises without one
def test_cli_raises_without_a_card(monkeypatch):
    from deeplearning4j_tpu_torch.tune.__main__ import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["lenet", "--budget", "2", "--no-persist", "--no-parity"])


# ------------------------------------------------ the sharding axis
class TestShardingAxis:
    """The sharding axis with live plans (JAX space.py:142-144,
    :175-194): ``for_model(sharding_variants=)`` enumerates them beside
    ``None`` as the JAX space does, and ``TuningPlan.apply`` attaches the
    variant. A one-rank mesh in this process (the plans only declare)."""

    def test_sharding_variants_enumerate_and_apply(self):
        from deeplearning4j_tpu.distributed import ShardedTrainingPlan as JP
        from deeplearning4j_tpu.parallel import DeviceMesh as JMesh
        from deeplearning4j_tpu_torch.distributed import (ShardedTrainingPlan,
                                                          ZeroPlan)
        from deeplearning4j_tpu_torch.parallel import DeviceMesh
        mesh = DeviceMesh.create(data=1, model=1)
        rules = {r"/W$": (None, "model")}
        variants = [ShardedTrainingPlan(mesh, rules=rules),
                    ShardedTrainingPlan(mesh, zero=ZeroPlan(min_bytes=0))]
        jmesh = JMesh.create(data=2, model=4)
        jvariants = [JP(jmesh, rules=rules), JP(jmesh, zero=True)]
        space = TuningSpace.for_model(None, sharding_variants=variants)
        jsp = jspace.TuningSpace.for_model(None, sharding_variants=jvariants)
        assert space.size == jsp.size
        assert len(space.axes["sharding"]) == len(jsp.axes["sharding"]) == 3
        assert space.axes["sharding"][0] is None
        net = tiny_net()
        plan = TuningPlan(sharding=variants[0])
        plan.apply(net)
        assert net._sharding_plan is variants[0]
        assert str(variants[0].signature()) in plan.signature()
        assert TuningPlan.from_config(plan.to_config()).signature() == \
            plan.signature()
