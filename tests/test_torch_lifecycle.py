"""The port's ``lifecycle/`` against the JAX package's on the CPU: the
cases of ``tests/test_lifecycle.py`` run through the port (capture, gate,
state store, registry canary, ``burn_over``, the lints and the CLI, the
driver's happy path, bad and regressed candidates, trainer death and
resume, the chaos storm), each held against the JAX module on the same
inputs:

- capture: both packages' ``TrafficCapture`` under one injected clock
  write the same records, and a file written by either loads in the
  other;
- gate: both gates score the same numpy callables on the same rows and
  give the same verdicts, reasons and scores (1e-6 relative); on a
  2-layer ``TransformerLM`` (E=64) transplanted from JAX the port's gate
  keeps the outputs on their device and agrees with the JAX gate given
  the same outputs as numpy;
- state: a driver-state file written by either package loads in the
  other;
- driver and storm: the same plan gives the same sequence of persisted
  states (round, phase, in-flight round, candidate, incumbent), the same
  quarantine reasons, promotions, rollbacks and final versions.

A captured training step updates its parameters in place, so a trainer
hands the driver a snapshot: the last test shows a loaded snapshot's
outputs stay bit-equal across a further training step.
"""

import itertools
import json
import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch

import jax

from deeplearning4j_tpu import faults as jfaults
from deeplearning4j_tpu import lifecycle as jlc
from deeplearning4j_tpu.analysis.lifecycle import lint_lifecycle as jlint
from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu.serving.registry import ModelRegistry as JRegistry
from deeplearning4j_tpu.train.resilience import DriverStateStore as JStore
from deeplearning4j_tpu_torch.analysis.lifecycle import lint_lifecycle
from deeplearning4j_tpu_torch.faults import FaultPlan, ServingLoad
from deeplearning4j_tpu_torch.lifecycle import (EvalGate, GatePolicy,
                                                LifecycleDriver,
                                                TrafficCapture,
                                                TrainerKilledError,
                                                spawn_trainer_process)
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.serving.registry import (CanaryInProgressError,
                                                       ModelRegistry,
                                                       RollbackTargetGoneError)
from deeplearning4j_tpu_torch.train import updaters
from deeplearning4j_tpu_torch.train.resilience import DriverStateStore

torch.set_num_threads(2)

NIN, NOUT = 4, 3
W0 = np.random.RandomState(0).randn(NIN, NOUT).astype(np.float32)
REL = 1e-6


def linear_model(delta: float):
    """Deterministic candidate: x @ (W0 + delta) — bit-identical math
    is assertable across promote/rollback. A numpy callable, so both
    packages serve (and gate) the very same function."""
    W = (W0 + np.float32(delta)).astype(np.float32)
    return lambda x: np.asarray(x, np.float32) @ W


def feats(rows, seed=0):
    return np.random.RandomState(seed).randn(rows, NIN).astype(np.float32)


def quiet_registry(**kw):
    kw.setdefault("batch_limit", 8)
    kw.setdefault("coalesce_ms", 0.5)
    return ModelRegistry(device="cpu", **kw)


def jax_registry(**kw):
    kw.setdefault("batch_limit", 8)
    kw.setdefault("coalesce_ms", 0.5)
    return JRegistry(**kw)


def ticking(step=0.25):
    c = itertools.count()
    return lambda: next(c) * step


def _close(a, b):
    if a is None or b is None:
        return a is None and b is None
    return abs(a - b) <= REL * max(abs(a), abs(b), 1e-30)


def assert_same_verdict(got, want):
    assert got.passing == want.passing and got.reason == want.reason
    assert _close(got.candidate_score, want.candidate_score)
    assert _close(got.incumbent_score, want.incumbent_score)
    assert set(got.detail) == set(want.detail)
    for k, v in want.detail.items():
        if isinstance(v, float):
            assert _close(got.detail[k], v), k
        else:
            assert got.detail[k] == v, k


# --------------------------------------------------------------- capture
class TestTrafficCapture:
    def test_sampling_is_deterministic_and_replayable(self, tmp_path):
        path = str(tmp_path / "cap.jsonl")
        jpath = str(tmp_path / "jcap.jsonl")
        cap = TrafficCapture(path, sample_rate=0.5, clock=ticking())
        jcap = jlc.TrafficCapture(jpath, sample_rate=0.5, clock=ticking())
        for i in range(10):
            cap.record(feats(2, seed=i), deadline=1.5)
            jcap.record(feats(2, seed=i), deadline=1.5)
        # credit accumulator: exactly round(10 * 0.5) records
        assert cap.captured == jcap.captured == 5
        recs = TrafficCapture.load(path)
        assert len(recs) == 5
        assert all(r["rows"] == 2 and r["deadline"] == 1.5 for r in recs)
        assert recs == jlc.TrafficCapture.load(jpath)
        load = TrafficCapture.to_serving_load(path)
        assert len(load) == 5
        assert [s.rows for s in load.specs] == [2] * 5
        jload = jlc.TrafficCapture.to_serving_load(jpath)
        assert [(s.at, s.rows, s.deadline) for s in load.specs] == \
            [(s.at, s.rows, s.deadline) for s in jload.specs]
        ev = TrafficCapture.eval_features(path)
        assert ev.shape == (10, NIN)
        np.testing.assert_array_equal(
            ev, jlc.TrafficCapture.eval_features(jpath))

    def test_truncated_tail_loads_cleanly(self, tmp_path):
        path = str(tmp_path / "cap.jsonl")
        cap = TrafficCapture(path)
        cap.record(feats(2, seed=0))
        cap.record(feats(3, seed=1))
        with open(path, "a") as f:
            f.write('{"at": 0.5, "rows": 4, "deadl')   # torn record
        recs = TrafficCapture.load(path)
        assert [r["rows"] for r in recs] == [2, 3]
        assert TrafficCapture.eval_features(path).shape == (5, NIN)
        assert len(TrafficCapture.to_serving_load(path)) == 2
        assert jlc.TrafficCapture.load(path) == recs

    def test_capture_failure_never_raises(self, tmp_path):
        cap = TrafficCapture(str(tmp_path / "no" / "such" / "dir" / "c.jl"))
        assert cap.record(feats(2)) is False
        assert cap.dropped == 1

    def test_max_records_bound(self, tmp_path):
        path = str(tmp_path / "cap.jsonl")
        cap = TrafficCapture(path, max_records=3)
        for i in range(6):
            cap.record(feats(1, seed=i))
        assert cap.captured == 3 and cap.dropped == 3
        assert len(TrafficCapture.load(path)) == 3

    def test_server_capture_hook(self, tmp_path):
        path = str(tmp_path / "cap.jsonl")
        cap = TrafficCapture(path)
        with quiet_registry(capture=cap) as reg:
            reg.load("m", linear_model(0.0), shapes=[(NIN,)])
            reg.output("m", feats(4))
            reg.output("m", feats(2))
        assert cap.captured == 2
        assert [r["rows"] for r in TrafficCapture.load(path)] == [4, 2]
        np.testing.assert_array_equal(TrafficCapture.eval_features(path),
                                      np.concatenate([feats(4), feats(2)]))

    @pytest.mark.parametrize("writer", ["torch", "jax"])
    def test_capture_files_cross_both_ways(self, tmp_path, writer):
        path = str(tmp_path / "cap.jsonl")
        Cap = TrafficCapture if writer == "torch" else jlc.TrafficCapture
        cap = Cap(path, sample_rate=0.75, clock=ticking(0.1))
        for i in range(8):
            cap.record(feats(1 + i % 3, seed=i), deadline=0.5 * i or None)
        with open(path, "a") as f:
            f.write('{"at": 9.0, "ro')                     # torn tail
        mine, theirs = TrafficCapture, jlc.TrafficCapture
        assert mine.load(path) == theirs.load(path)
        assert len(mine.load(path)) == 6
        np.testing.assert_array_equal(mine.eval_features(path, max_rows=7),
                                      theirs.eval_features(path, max_rows=7))
        assert [(s.at, s.rows, s.deadline)
                for s in mine.to_serving_load(path).specs] == \
            [(s.at, s.rows, s.deadline)
             for s in theirs.to_serving_load(path).specs]


# ------------------------------------------------------------ fault plan
class TestLifecycleFaultPlan:
    @pytest.mark.parametrize("kw", [
        dict(rounds=5, n_bad=1, trainer_death=True, slo_regression=True),
        dict(rounds=8, n_bad=2),
        dict(rounds=6, n_bad=1, bad_kind="regressed", trainer_death=True),
        dict(rounds=3, n_bad=3, slo_regression=True)])
    def test_seeded_lifecycle_draws_the_jax_rounds(self, kw):
        for seed in range(20):
            got = FaultPlan.seeded_lifecycle(seed=seed, **kw)
            want = jfaults.FaultPlan.seeded_lifecycle(seed=seed, **kw)
            assert (got.bad_candidate_at, got.trainer_death_at_roll,
                    got.slo_regression_during_canary) == \
                (want.bad_candidate_at, want.trainer_death_at_roll,
                 want.slo_regression_during_canary)
            assert "trainer_death_at_roll=" in repr(got)
            assert repr(got).split("trainer_death_at_roll=")[1] == \
                repr(want).split("trainer_death_at_roll=")[1]

    def test_consumers_fire_once_and_a_bad_kind_is_refused(self):
        for Plan in (FaultPlan, jfaults.FaultPlan):
            plan = Plan(trainer_death_at_roll=2,
                        bad_candidate_at={3: "nan", 4: "regressed"},
                        slo_regression_during_canary=2)
            assert [plan.trainer_dies_at_roll(r) for r in (1, 2, 3)] == \
                [False, True, False]
            assert [plan.candidate_fault(r) for r in (3, 3, 4, 5)] == \
                ["nan", None, "regressed", None]
            assert [plan.canary_regression(r) for r in (1, 3, 3)] == \
                [False, True, False]
            with pytest.raises(ValueError, match="'nan' or 'regressed'"):
                Plan(bad_candidate_at={2: "slow"})


# ------------------------------------------------------------------ gate
def both_gates(policy_kw=None, **gate_kw):
    pol = policy_kw or {}
    return (EvalGate(GatePolicy(**pol), device="cpu", **gate_kw),
            jlc.EvalGate(jlc.GatePolicy(**pol), **gate_kw))


class TestEvalGate:
    def test_pass_and_parity_rejection(self):
        gate, jgate = both_gates({"parity_bound": 0.05})
        x = feats(16)
        ok = gate.evaluate(linear_model(1e-4), linear_model(0.0), x)
        assert ok and ok.reason is None
        assert_same_verdict(ok, jgate.evaluate(linear_model(1e-4),
                                               linear_model(0.0), x))
        bad = gate.evaluate(linear_model(5.0), linear_model(0.0), x)
        assert not bad and bad.reason == "parity_violation"
        assert bad.to_dict()["detail"]["parity_rel"] > 0.05
        assert_same_verdict(bad, jgate.evaluate(linear_model(5.0),
                                                linear_model(0.0), x))

    def test_nan_candidate_rejected(self):
        gate, jgate = both_gates()

        def nan_model(x):
            return np.full((len(x), NOUT), np.nan)
        verdict = gate.evaluate(nan_model, linear_model(0.0), feats(8))
        assert not verdict
        assert verdict.reason == "non_finite_outputs"
        assert verdict.detail["non_finite_values"] == 8 * NOUT
        assert_same_verdict(verdict, jgate.evaluate(
            nan_model, linear_model(0.0), feats(8)))

    def test_scorecard_regression_with_labels(self):
        x = feats(16)
        y = x @ W0     # ground truth IS the incumbent's function
        gate, jgate = both_gates({"max_regression": 0.05})
        good = gate.evaluate(linear_model(1e-4), linear_model(0.0), x, y)
        assert good
        assert_same_verdict(good, jgate.evaluate(
            linear_model(1e-4), linear_model(0.0), x, y))
        bad = gate.evaluate(linear_model(1.0), linear_model(0.0), x, y)
        assert not bad and bad.reason == "scorecard_regression"
        assert bad.candidate_score > bad.incumbent_score
        assert_same_verdict(bad, jgate.evaluate(
            linear_model(1.0), linear_model(0.0), x, y))

    def test_empty_eval_fails_closed(self):
        verdict = EvalGate(device="cpu").evaluate(linear_model(0.0), None,
                                                  None)
        assert not verdict and verdict.reason == "insufficient_eval"
        assert_same_verdict(verdict, jlc.EvalGate().evaluate(
            linear_model(0.0), None, None))

    @pytest.mark.parametrize("case", ["pass", "parity_violation",
                                      "non_finite", "labeled"])
    def test_gate_on_a_transformer_against_jax(self, case):
        """A 2-layer TransformerLM (E=64) from JAX weights: the port's
        gate runs both models on token rows as tensors and keeps the
        logits there; the JAX gate, given those logits as numpy, gives
        the same verdict and scores."""
        jcfg = jtr.TransformerConfig.tiny()
        cfg = ttr.TransformerConfig.tiny()
        jp = jax.tree_util.tree_map(
            np.asarray, jtr.init_params(jcfg, jax.random.PRNGKey(0)))
        rng = np.random.RandomState(1)
        scale = {"pass": 1e-3, "parity_violation": 0.5, "non_finite": 1e-3,
                 "labeled": 1e-3}[case]
        jc = jax.tree_util.tree_map(
            lambda a: (a + scale * rng.randn(*a.shape)).astype(a.dtype), jp)
        inc = ttr.TransformerLM(cfg, device="cpu",
                                params=ttr.params_from_jax(jp, cfg, "cpu"))
        cand = ttr.TransformerLM(cfg, device="cpu",
                                 params=ttr.params_from_jax(jc, cfg, "cpu"))
        if case == "non_finite":
            with torch.no_grad():
                cand.params["embed"]["tok"][7, 3] = float("nan")
        tok = np.random.RandomState(2).randint(0, cfg.vocab_size, (6, 16))
        tok[:, 0] = 7
        x = torch.from_numpy(tok.astype(np.int32))
        y = None
        if case == "labeled":
            y = np.random.RandomState(3).randn(6, 16, cfg.vocab_size)
        pol = {"parity_bound": 0.05} if case == "parity_violation" else {}
        gate, jgate = both_gates(pol)
        got = gate.evaluate(cand, inc, x, y)
        assert got.reason == (None if case in ("pass", "labeled")
                              else ("non_finite_outputs"
                                    if case == "non_finite" else case))
        with torch.inference_mode():
            c_np, i_np = cand(x).numpy(), inc(x).numpy()
        want = jgate.evaluate(lambda _x: c_np, lambda _x: i_np, tok, y)
        assert_same_verdict(got, want)


# ----------------------------------------------------------- state store
class TestDriverStateStore:
    def test_roundtrip_atomic(self, tmp_path):
        store = DriverStateStore(str(tmp_path))
        state = {"round": 3, "phase": "observe", "quarantined": []}
        store.save(state)
        assert DriverStateStore(str(tmp_path)).load() == state
        assert not os.path.exists(store.path + ".tmp")

    def test_corrupt_state_quarantined_not_trusted(self, tmp_path):
        store = DriverStateStore(str(tmp_path))
        store.save({"round": 1})
        with open(store.path) as f:
            doc = json.load(f)
        doc["state"]["round"] = 99          # tampered: checksum now wrong
        with open(store.path, "w") as f:
            json.dump(doc, f)
        assert store.load() is None
        assert os.path.exists(os.path.join(
            str(tmp_path), "quarantine_" + DriverStateStore.FILENAME))
        # and a fresh store starts clean, not from garbage
        assert store.load() is None

    @pytest.mark.parametrize("writer", ["torch", "jax"])
    def test_state_files_cross_both_ways(self, tmp_path, writer):
        assert DriverStateStore.FILENAME == JStore.FILENAME
        state = {"round": 2, "phase": "canary", "in_round": 3,
                 "roll_index": 2, "incumbent": 2, "candidate_version": 3,
                 "quarantined": [{"round": 1, "version": None,
                                  "reason": "gate:non_finite_outputs",
                                  "detail": {"rows": 16}}],
                 "promotions": 2, "rollbacks": 0}
        Writer, Reader = ((DriverStateStore, JStore) if writer == "torch"
                          else (JStore, DriverStateStore))
        Writer(str(tmp_path)).save(state)
        assert Reader(str(tmp_path)).load() == state
        with open(os.path.join(str(tmp_path), DriverStateStore.FILENAME),
                  "rb") as f:
            written = f.read()
        other = tmp_path / "other"
        Reader(str(other)).save(state)
        with open(os.path.join(str(other), DriverStateStore.FILENAME),
                  "rb") as f:
            assert f.read() == written          # the same bytes


# -------------------------------------------------------- registry canary
class TestRegistryCanary:
    def test_fraction_is_deterministic(self):
        with quiet_registry() as reg:
            v1 = reg.load("m", linear_model(0.0), shapes=[(NIN,)])
            v2 = reg.load("m", linear_model(0.1), shapes=[(NIN,)])
            reg.begin_canary("m", v2, fraction=0.25)
            handles = [reg.submit("m", feats(2, seed=i)) for i in range(40)]
            for h in handles:
                h.get(10)
            on_canary = sum(1 for h in handles
                            if h.server == f"m:v{v2}")
            # credit accumulator: EXACTLY round(40 * 0.25), no noise
            assert on_canary == 10
            assert sum(1 for h in handles
                       if h.server == f"m:v{v1}") == 30
            # pinned submits never count against the accumulator
            assert reg.submit("m", feats(2), version=v1).get(10) is not None
            assert reg.canary("m") == {"version": v2, "fraction": 0.25}

    def test_roll_refused_while_canary_observing(self):
        with quiet_registry() as reg:
            reg.load("m", linear_model(0.0), shapes=[(NIN,)])
            v2 = reg.load("m", linear_model(0.1), shapes=[(NIN,)])
            v3 = reg.load("m", linear_model(0.2), shapes=[(NIN,)])
            reg.begin_canary("m", v2, fraction=0.5)
            with pytest.raises(CanaryInProgressError) as ei:
                reg.roll("m", v3)
            assert ei.value.canary == v2 and ei.value.target == v3
            with pytest.raises(CanaryInProgressError):
                reg.begin_canary("m", v3, fraction=0.5)
            # roll TO the canary version IS the promote, and clears it
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                reg.roll("m", v2)
            assert reg.active_version("m") == v2
            assert reg.canary("m") is None
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                reg.roll("m", v3)
            assert reg.active_version("m") == v3

    def test_promote_and_abort(self):
        with quiet_registry() as reg:
            reg.load("m", linear_model(0.0), shapes=[(NIN,)])
            v2 = reg.load("m", linear_model(0.1), shapes=[(NIN,)])
            reg.begin_canary("m", v2, fraction=0.5)
            assert reg.abort_canary("m") == v2
            assert reg.canary("m") is None
            assert reg.abort_canary("m") is None      # idempotent
            # the aborted version stays loaded and warmed
            reg.begin_canary("m", v2, fraction=0.5)
            assert reg.promote_canary("m") == v2
            assert reg.active_version("m") == v2
            assert reg.canary("m") is None

    def test_rollback_aborts_canary(self):
        with quiet_registry() as reg:
            reg.load("m", linear_model(0.0), shapes=[(NIN,)])
            v2 = reg.load("m", linear_model(0.1), shapes=[(NIN,)])
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                reg.roll("m", v2)
            v3 = reg.load("m", linear_model(0.2), shapes=[(NIN,)])
            reg.begin_canary("m", v3, fraction=0.5)
            assert reg.rollback("m") == 1
            assert reg.canary("m") is None

    def test_retire_refuses_observing_canary(self):
        with quiet_registry() as reg:
            reg.load("m", linear_model(0.0), shapes=[(NIN,)])
            v2 = reg.load("m", linear_model(0.1), shapes=[(NIN,)])
            reg.begin_canary("m", v2, fraction=0.5)
            with pytest.raises(ValueError, match="observing canary"):
                reg.retire("m", v2, timeout=1.0)

    def test_rollback_after_eviction_structured_error(self):
        with quiet_registry() as reg:
            v1 = reg.load("m", linear_model(0.0), shapes=[(NIN,)])
            v2 = reg.load("m", linear_model(0.1), shapes=[(NIN,)])
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                reg.roll("m", v2)
            reg.retire("m", v1, timeout=5.0)
            with pytest.raises(RollbackTargetGoneError) as ei:
                reg.rollback("m")
            assert not isinstance(ei.value, KeyError)
            assert isinstance(ei.value, ValueError)
            assert ei.value.model == "m" and ei.value.version == v1
            assert "no previous" in str(ei.value)

    def test_hints_and_models_carry_canary(self):
        with quiet_registry() as reg:
            reg.load("m", linear_model(0.0), shapes=[(NIN,)])
            v2 = reg.load("m", linear_model(0.1), shapes=[(NIN,)])
            assert reg.models()["m"]["canary"] is None
            reg.begin_canary("m", v2, fraction=0.2)
            m = reg.models()["m"]
            assert m["canary"] == v2 and m["canary_fraction"] == 0.2
            hints = reg.load_hints()["models"]["m"]
            assert hints["canary"]["version"] == v2
            assert hints["canary"]["fraction"] == 0.2
            assert "shed_rate" in hints["canary"]


# -------------------------------------------------------------- SLO layer
class TestBurnOver:
    def test_burn_over_does_not_perturb_the_ring(self):
        from deeplearning4j_tpu.profiler import metrics as jmetrics
        from deeplearning4j_tpu.profiler import slo as jslo
        from deeplearning4j_tpu_torch.profiler import metrics as _metrics
        from deeplearning4j_tpu_torch.profiler import slo as _slo
        burns = []
        for metrics, slo in ((_metrics, _slo), (jmetrics, jslo)):
            reg = metrics.MetricsRegistry()
            req = reg.counter("dl4j_serving_requests_total", "t",
                              labelnames=("outcome",))
            spec = slo.SLOSpec("serve", shed_rate=0.1, windows=(10.0, 100.0))
            t = [0.0]
            eng = slo.SLOEngine([spec], registry=reg, clock=lambda: t[0])
            req.labels(outcome="completed").inc(100)
            eng.evaluate()
            n = len(eng._samples)
            t[0] = 30.0
            req.labels(outcome="shed_overload").inc(50)
            burns.append(eng.burn_over(20.0))
            assert len(eng._samples) == n       # no sample appended
        # delta vs the 30s-old reference: 50 shed of 50 new -> 1.0/0.1
        assert burns[0]["serve"] == pytest.approx(10.0)
        assert burns[0] == burns[1]


# ------------------------------------------------------------------ lints
def _codes(rep):
    return [d.code for d in rep.diagnostics]


class TestLifecycleLints:
    def test_w113_window_shorter_than_fast(self):
        kw = dict(observation_window=5.0, canary_fraction=0.2,
                  slo_windows=(60.0, 600.0))
        assert _codes(lint_lifecycle(**kw)) == ["DL4J-W113"] \
            == _codes(jlint(**kw))

    def test_w114_fraction_below_resolution(self):
        kw = dict(observation_window=120.0, canary_fraction=0.01,
                  slo_windows=(60.0, 600.0), requests_per_tick=50)
        assert _codes(lint_lifecycle(**kw)) == ["DL4J-W114"] \
            == _codes(jlint(**kw))

    def test_w114_bucket_underfill(self):
        kw = dict(observation_window=120.0, canary_fraction=0.1,
                  requests_per_tick=40, buckets=[8, 16, 32])
        rep = lint_lifecycle(**kw)
        assert _codes(rep) == ["DL4J-W114"] == _codes(jlint(**kw))
        assert "bucket" in rep.diagnostics[0].message

    def test_clean_plan(self):
        kw = dict(observation_window=120.0, canary_fraction=0.25,
                  slo_windows=(60.0, 600.0), requests_per_tick=100,
                  buckets=[8, 16])
        assert lint_lifecycle(**kw).diagnostics == [] \
            == jlint(**kw).diagnostics

    def test_cli(self, capsys):
        from deeplearning4j_tpu.lifecycle.__main__ import main as jmain
        from deeplearning4j_tpu_torch.lifecycle.__main__ import main
        argv = ["--observation-window", "5", "--canary-fraction", "0.2",
                "--slo-windows", "60,600"]
        assert main(argv) == 1
        out = capsys.readouterr().out
        assert "DL4J-W113" in out
        assert jmain(argv) == 1
        assert capsys.readouterr().out == out
        argv = ["--observation-window", "120", "--canary-fraction", "0.25"]
        assert main(argv) == 0 == jmain(argv)
        assert main(["--observation-window", "5", "--canary-fraction",
                     "0.2", "--slo-windows", "60,600",
                     "--warnings-ok"]) == 0


# ----------------------------------------------------------------- driver
def make_trainer():
    def trainer(r):
        return linear_model(0.001 * r)
    return trainer


def recorded_states(monkeypatch, Store):
    """Every state each package's store persists, in order: (round,
    phase, in-flight round, candidate, incumbent, roll index)."""
    seen = []
    save = Store.save

    def recording(self, state):
        seen.append((state.get("round"), state.get("phase"),
                     state.get("in_round"), state.get("candidate_version"),
                     state.get("incumbent"), state.get("roll_index")))
        return save(self, state)
    monkeypatch.setattr(Store, "save", recording)
    return seen


def _summary_core(summary):
    return {k: ([(q["round"], q["version"], q["reason"]) for q in v]
                if k == "quarantined" else v) for k, v in summary.items()}


def run_both(tmp_path, monkeypatch, rounds, plan_kw, gate_policy=None):
    """The same driver plan through each package; returns, per package,
    the summary, the persisted states and the registry's versions."""
    out = {}
    for side in ("torch", "jax"):
        if side == "torch":
            Reg, Driver, Plan, Store = (quiet_registry, LifecycleDriver,
                                        FaultPlan, DriverStateStore)
            gate = EvalGate(GatePolicy(**gate_policy)) if gate_policy \
                else None
        else:
            Reg, Driver, Plan, Store = (jax_registry, jlc.LifecycleDriver,
                                        jfaults.FaultPlan, JStore)
            gate = jlc.EvalGate(jlc.GatePolicy(**gate_policy)) \
                if gate_policy else None
        seen = recorded_states(monkeypatch, Store)
        with Reg() as reg:
            drv = Driver(reg, "m", make_trainer(),
                         str(tmp_path / side / "state"), eval_x=feats(16),
                         shapes=[(NIN,)], observe_ticks=1, confirm_ticks=1,
                         gate=gate, faults=Plan(**plan_kw))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                summary = drv.run(rounds)
            out[side] = (summary, list(seen), set(reg.models()["m"]
                                                  ["versions"].keys()),
                         reg.active_version("m"))
        monkeypatch.undo()
    (s, states, versions, active), (js, jstates, jversions, jactive) = \
        out["torch"], out["jax"]
    assert _summary_core(s) == _summary_core(js)
    assert states == jstates
    assert versions == jversions and active == jactive
    return s, versions, active


class TestLifecycleDriver:
    def test_happy_path_promotes_each_round(self, tmp_path, monkeypatch):
        summary, _, active = run_both(tmp_path, monkeypatch, 3, {})
        assert summary["promotions"] == 3
        assert summary["rollbacks"] == 0
        assert summary["quarantined"] == []
        assert active == 3
        # driver resumable state is idle/clean
        st = DriverStateStore(str(tmp_path / "torch" / "state")).load()
        assert st["phase"] == "idle" and st["in_round"] is None

    def test_bad_candidate_quarantined_never_loaded(self, tmp_path,
                                                    monkeypatch):
        summary, versions, _ = run_both(
            tmp_path, monkeypatch, 3, {"bad_candidate_at": {2: "nan"}})
        assert summary["promotions"] == 2
        q = summary["quarantined"]
        assert len(q) == 1 and q[0]["reason"] == "gate:non_finite_outputs"
        assert q[0]["version"] is None      # NEVER loaded
        # versions 1 and 2 exist; the poisoned round produced none
        assert versions == {1, 2}

    def test_regressed_candidate_quarantined(self, tmp_path, monkeypatch):
        summary, _, _ = run_both(
            tmp_path, monkeypatch, 2, {"bad_candidate_at": {2: "regressed"}},
            gate_policy={"parity_bound": 0.05})
        assert [q["reason"] for q in summary["quarantined"]] \
            == ["gate:parity_violation"]

    def test_trainer_death_mid_roll_then_resume(self, tmp_path):
        plan = FaultPlan(trainer_death_at_roll=1)
        proc = spawn_trainer_process()
        state_dir = str(tmp_path / "state")
        try:
            with quiet_registry() as reg:
                drv = LifecycleDriver(reg, "m", make_trainer(), state_dir,
                                      eval_x=feats(16), shapes=[(NIN,)],
                                      observe_ticks=1, confirm_ticks=1,
                                      faults=plan, trainer_process=proc)
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    with pytest.raises(TrainerKilledError):
                        drv.run(2)
                # the trainer subprocess is DEAD (SIGKILL)
                assert proc.poll() is not None and proc.returncode == -9
                # the registry is consistent: the incumbent serving
                assert reg.active_version("m") == 1
                np.testing.assert_array_equal(
                    reg.output("m", feats(4)),
                    linear_model(0.001)(feats(4)))
                # the state file a JAX driver would resume from
                st = JStore(state_dir).load()
                assert st["phase"] == "canary" and st["in_round"] == 2
                drv2 = LifecycleDriver(reg, "m", make_trainer(), state_dir,
                                       eval_x=feats(16), shapes=[(NIN,)],
                                       observe_ticks=1, confirm_ticks=1,
                                       faults=plan)
                assert drv2.resumed
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    summary = drv2.run(2)
                assert summary["rounds"] == 2
                assert reg.active_version("m") == 2
                assert reg.canary("m") is None
                # the interrupted candidate was NOT retrained or reloaded
                assert reg.models()["m"]["versions"].keys() == {1, 2}
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait(5)


# ------------------------------------------------------------- THE storm
def storm_net():
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                    NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.Builder().seed(7)
            .updater(updaters.Sgd(0.05)).list()
            .layer(L.DenseLayer(nOut=8, activation="relu"))
            .layer(L.OutputLayer(nOut=NOUT, lossFunction="mcxent",
                                 activation="softmax"))
            .setInputType(InputType.feedForward(NIN))
            .build())
    return MultiLayerNetwork(conf).init(device="cpu")


def jax_storm_net():
    from deeplearning4j_tpu.nn import (InputType, MultiLayerNetwork,
                                       NeuralNetConfiguration)
    from deeplearning4j_tpu.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu.train import updaters as jupd
    conf = (NeuralNetConfiguration.Builder().seed(7)
            .updater(jupd.Sgd(0.05)).list()
            .layer(DenseLayer(nOut=8, activation="relu"))
            .layer(OutputLayer(nOut=NOUT, lossFunction="mcxent",
                               activation="softmax"))
            .setInputType(InputType.feedForward(NIN))
            .build())
    return MultiLayerNetwork(conf).init()


def run_storm(side, tmp_path, monkeypatch):
    """The JAX storm test's run through one package: seed 23 fires all
    three chaos kinds (trainer SIGKILLed at roll 2, a NaN candidate at
    round 3, an SLO regression at roll 4) across 5 rounds under live
    traffic, with a real trainer fitting on the device the registry
    serves from. Returns what both packages must agree on."""
    if side == "torch":
        from deeplearning4j_tpu_torch.analysis.churn import \
            get_churn_detector
        from deeplearning4j_tpu_torch.serving import ServingError
        from deeplearning4j_tpu_torch.serving.registry import \
            ModelNotFoundError
        Reg, Driver, Plan, Store, Killed, spawn, net = (
            quiet_registry, LifecycleDriver, FaultPlan, DriverStateStore,
            TrainerKilledError, spawn_trainer_process, storm_net())
    else:
        from deeplearning4j_tpu.analysis.churn import get_churn_detector
        from deeplearning4j_tpu.serving import ServingError
        from deeplearning4j_tpu.serving.registry import ModelNotFoundError
        Reg, Driver, Plan, Store, Killed, spawn, net = (
            jax_registry, jlc.LifecycleDriver, jfaults.FaultPlan, JStore,
            jlc.TrainerKilledError, jlc.spawn_trainer_process,
            jax_storm_net())
    plan = Plan.seeded_lifecycle(seed=23, rounds=5, n_bad=1,
                                 trainer_death=True, slo_regression=True)
    assert plan.trainer_death_at_roll == 2
    assert plan.bad_candidate_at == {3: "nan"}
    assert plan.slo_regression_during_canary == 4

    det = get_churn_detector()
    fit_x = feats(8, seed=3)
    fit_y = np.eye(NOUT, dtype=np.float32)[
        np.random.RandomState(4).randint(NOUT, size=8)]

    def trainer(r):
        net.fit(fit_x, fit_y)       # the real trainer, every round
        return linear_model(0.001 * r)

    # warm the fit path once, then pin its signature count
    trainer(0)
    fit_sigs = det.signature_count("MultiLayerNetwork.fit", owner=net)

    seen = recorded_states(monkeypatch, Store)
    proc = spawn()
    state_dir = str(tmp_path / side / "state")
    stop = threading.Event()
    handles, submit_errors = [], []
    reg = Reg()
    try:
        def traffic():
            i = 0
            while not stop.is_set():
                try:
                    if reg.active_version("m") is not None:
                        handles.append(reg.submit("m", feats(2, seed=i)))
                except ModelNotFoundError:
                    pass            # nothing loaded yet
                except Exception as e:   # admission shed = outcome
                    submit_errors.append(e)
                i += 1
                time.sleep(0.02)

        t = threading.Thread(target=traffic, daemon=True)
        t.start()

        def driver(faults):
            return Driver(reg, "m", trainer, state_dir, eval_x=feats(16),
                          shapes=[(NIN,)], canary_fraction=0.25,
                          observe_ticks=2, confirm_ticks=1,
                          tick_interval=0.05, faults=faults,
                          trainer_process=proc)

        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            drv = driver(plan)
            with pytest.raises(Killed):
                drv.run(5)
            # mid-roll SIGKILL: trainer dead, registry consistent
            assert proc.poll() is not None and proc.returncode == -9
            assert reg.active_version("m") == 2

            drv2 = driver(plan)
            assert drv2.resumed
            drv2.run(4)             # finish the interrupted round 4
            assert reg.active_version("m") == 3
            probe = feats(8, seed=99)
            pre_roll = np.asarray(reg.output("m", probe))
            drv2.run(5)             # promote v4 -> regression -> rollback
        stop.set()
        t.join(5.0)

        # (1) registry serves the LAST GOOD version
        assert reg.active_version("m") == 3
        assert drv2.incumbent_version == 3
        assert drv2.rollbacks == 1
        assert [q["reason"] for q in drv2.quarantined] == \
            ["gate:non_finite_outputs", "slo_regression"]
        # (2) rollback is bit-identical to the pre-roll incumbent
        post_roll = np.asarray(reg.output("m", probe))
        np.testing.assert_array_equal(pre_roll, post_roll)
        np.testing.assert_array_equal(post_roll,
                                      linear_model(0.004)(probe))
        # (3) every admitted request resolved exactly once; every
        # rejection a structured outcome
        assert handles, "traffic thread never submitted"
        for h in handles:
            try:
                h.get(15.0)
            except Exception:
                pass
            assert h.resolutions == 1
        assert all(isinstance(e, ServingError) for e in submit_errors)
        # (4) no signature after warmup, trainer and registry alike
        assert det.signature_count("MultiLayerNetwork.fit",
                                   owner=net) == fit_sigs
        versions = sorted(reg.models()["m"]["versions"])
        for v in versions:
            assert reg.server("m", v).recompiles_after_warmup() == 0
        assert not det.diagnostics_for(net)
        # (5) the driver's state machine ends clean and idle
        st = Store(state_dir).load()
        assert st["phase"] == "idle" and st["in_round"] is None
        assert st["round"] == 5
        return {"states": list(seen), "quarantined": drv2.quarantined,
                "promotions": drv2.promotions, "rollbacks": drv2.rollbacks,
                "versions": versions, "active": reg.active_version("m"),
                "final": st}
    finally:
        stop.set()
        if proc.poll() is None:
            proc.kill()
            proc.wait(5)
        reg.close()
        monkeypatch.undo()


@pytest.mark.chaos
class TestChaosStorm:
    def test_train_gate_roll_rollback_storm(self, tmp_path, monkeypatch):
        """THE pin, through both packages: the same persisted states in
        the same order, the same quarantines, promotions, rollbacks and
        versions."""
        got = run_storm("torch", tmp_path, monkeypatch)
        want = run_storm("jax", tmp_path, monkeypatch)
        assert len(got["states"]) > 30
        assert got["states"] == want["states"]
        assert [(q["round"], q["version"], q["reason"])
                for q in got["quarantined"]] == \
            [(q["round"], q["version"], q["reason"])
             for q in want["quarantined"]]
        for key in ("promotions", "rollbacks", "versions", "active"):
            assert got[key] == want[key], key
        assert {k: v for k, v in got["final"].items()
                if k != "quarantined"} == \
            {k: v for k, v in want["final"].items() if k != "quarantined"}

    def test_capture_doubles_as_chaos_input(self, tmp_path):
        """Captured live traffic replays as a deterministic ServingLoad
        against a fresh registry — the capture IS the chaos input."""
        path = str(tmp_path / "cap.jsonl")
        cap = TrafficCapture(path, sample_rate=1.0)
        with quiet_registry(capture=cap) as reg:
            reg.load("m", linear_model(0.0), shapes=[(NIN,)])
            load = ServingLoad.seeded(11, mix="steady", n=30, rps=400.0,
                                      max_rows=4)
            outcomes = load.replay(
                lambda x, deadline=None:
                reg.submit("m", x, deadline=deadline), (NIN,))
            for _spec, out in outcomes:
                assert not isinstance(out, Exception)
                out.get(10.0)
        assert cap.captured == 30
        replay = TrafficCapture.to_serving_load(path)
        assert [s.rows for s in replay.specs] == \
            [s.rows for s in load.specs]
        with quiet_registry() as reg2:
            reg2.load("m", linear_model(0.5), shapes=[(NIN,)])
            outcomes = replay.replay(
                lambda x, deadline=None:
                reg2.submit("m", x, deadline=deadline), (NIN,),
                time_scale=0.5)
            for _spec, out in outcomes:
                assert not isinstance(out, Exception)
                assert out.get(10.0) is not None
                assert out.resolutions == 1


# -------------------------------------------------------------- snapshot
def test_a_loaded_snapshot_stays_bit_equal_across_training(tmp_path):
    """The trainer updates its parameters in place (as a captured step
    does): what it hands the driver is a snapshot, so the version the
    registry serves, and a rollback to it, stay bit-equal while the
    trainer goes on."""
    cfg = ttr.TransformerConfig.tiny()
    upd = updaters.Adam(1e-2)
    params = ttr.init_params(cfg, seed=0, device="cpu")
    opt = ttr.init_opt_state(params, upd)
    t = torch.zeros((), dtype=torch.int32)
    step = ttr.make_train_step(cfg, upd)
    rng = np.random.RandomState(0)
    tok = torch.from_numpy(rng.randint(0, cfg.vocab_size, (4, 16)))
    tgt = torch.from_numpy(rng.randint(0, cfg.vocab_size, (4, 16)))
    mask = torch.ones((4, 16))

    def trainer(r):
        step(params, opt, t, tok, tgt, mask)
        return ttr.TransformerLM(cfg, device="cpu",
                                 params=ttr.copy_params(params))

    live = ttr.TransformerLM(cfg, device="cpu", params=params)
    probe = rng.randint(0, cfg.vocab_size, (3, 16)).astype(np.int32)
    with quiet_registry(input_dtype=np.int32) as reg:
        drv = LifecycleDriver(reg, "lm", trainer, str(tmp_path / "state"),
                              eval_x=probe, shapes=[(16,)],
                              observe_ticks=1, confirm_ticks=1)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            drv.run(1)
        served = reg.output("lm", probe)
        direct = reg.server("lm", 1).model.logits(probe).numpy()
        before = live.logits(probe).numpy()
        step(params, opt, t, tok, tgt, mask)      # the trainer goes on
        assert not np.array_equal(live.logits(probe).numpy(), before)
        np.testing.assert_array_equal(reg.output("lm", probe), served)
        np.testing.assert_array_equal(
            reg.server("lm", 1).model.logits(probe).numpy(), direct)
