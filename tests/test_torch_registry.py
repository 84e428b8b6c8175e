"""The port's ModelRegistry (CPU) against the JAX ModelRegistry: one
script of ``load``/``roll``/``rollback``/``begin_canary``/``retire``/
``unload`` runs on both, with equal version attribution request by
request, canary counts of exactly ``round(n * fraction)``, the same
``DL4J-W111`` findings, and no request dropped while a seeded
``SwapSchedule`` rolls the route under load. Each version's forward
answers a constant (its version number), so attribution is exact."""

import sys
import threading
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu import faults as jfaults
from deeplearning4j_tpu.analysis.diagnostics import \
    ModelValidationError as JaxModelValidationError
from deeplearning4j_tpu.parallel.mesh import DeviceMesh
from deeplearning4j_tpu.serving import registry as jreg
from deeplearning4j_tpu_torch import faults as tfaults
from deeplearning4j_tpu_torch.analysis.diagnostics import ModelValidationError
from deeplearning4j_tpu_torch.serving import registry as treg

torch.set_num_threads(2)

NIN = 4


def _const_j(v):
    return lambda x: jnp.full((x.shape[0], 1), float(v))


def _const_t(v):
    return lambda x: torch.full((x.shape[0], 1), float(v))


SIDES = {
    "jax": (jreg, _const_j, jfaults, JaxModelValidationError,
            lambda **kw: jreg.ModelRegistry(
                mesh=DeviceMesh.data_parallel(jax.devices()[:1]), **kw)),
    "torch": (treg, _const_t, tfaults, ModelValidationError,
              lambda **kw: treg.ModelRegistry(device="cpu", **kw)),
}


def _x(rows=1, seed=0):
    return np.random.RandomState(seed).randn(rows, NIN).astype(np.float32)


def _script(side):
    """The lifecycle script; returns what both packages must agree on."""
    mod, const, _, verr, make = SIDES[side]
    log = []

    def ask(n, tag):
        for i in range(n):
            req = reg.submit("m", _x(1 + i % 2, seed=i))
            out = np.asarray(req.get(30))
            log.append((tag, req.server, float(out[0, 0]), req.resolutions))

    reg = make(batch_limit=4, coalesce_ms=0.5)
    try:
        assert reg.load("m", const(1), shapes=[(NIN,)]) == 1
        ask(3, "v1 only")
        assert reg.load("m", const(2)) == 2      # staged, inherits shapes
        ask(2, "v2 staged")
        assert reg.roll("m") == 1
        ask(2, "rolled")
        assert reg.rollback("m") == 1
        ask(2, "rolled back")
        assert reg.begin_canary("m", 2, fraction=0.25) == 2
        with pytest.raises(mod.CanaryInProgressError):
            reg.begin_canary("m", 2, fraction=0.5)
        ask(8, "canary 1/4")
        canary = dict(reg.canary("m"))
        hints = reg.load_hints()["models"]["m"]
        assert hints["canary"]["version"] == 2
        assert reg.promote_canary("m") == 2
        ask(2, "promoted")
        # W111: an unwarmed target, then one missing the served shape
        assert reg.load("m", const(3), warm=False) == 3
        w_unwarmed = reg.validate_roll("m", 3).codes()
        assert reg.load("m", const(4), shapes=[(NIN + 1,)]) == 4
        w_missing = reg.validate_roll("m", 4).codes()
        with pytest.raises(verr):
            reg.roll("m", 4, strict=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            reg.roll("m", 4)
        rolled_warning = [str(w.message).split(":")[1].strip()
                          for w in caught if "registry roll" in
                          str(w.message)]
        reg.rollback("m")
        reg.retire("m", 1)
        with pytest.raises(mod.ModelNotFoundError):
            reg.server("m", 1)
        models = reg.models()["m"]
        snapshot = (models["active"], models["previous"],
                    sorted(models["versions"]),
                    [models["versions"][v]["retired"]
                     for v in sorted(models["versions"])],
                    sorted(models))
        with pytest.raises(ValueError, match="active"):
            reg.retire("m", 2)
        reg.unload("m")
        with pytest.raises(mod.ModelNotFoundError):
            reg.submit("m", _x())
    finally:
        reg.close()
    return {"log": log, "canary": canary, "w_unwarmed": w_unwarmed,
            "w_missing": w_missing, "rolled_warning": rolled_warning,
            "snapshot": snapshot}


@pytest.fixture(scope="module")
def scripts():
    return {side: _script(side) for side in SIDES}


class TestLifecycleScript:
    def test_attribution_equal_request_by_request(self, scripts):
        j, t = scripts["jax"]["log"], scripts["torch"]["log"]
        assert t == j
        assert all(n == 1 for *_, n in t)
        for tag, server, val, _ in t:
            assert server == f"m:v{int(val)}"

    def test_canary_counts_are_exact(self, scripts):
        for side in SIDES:
            log = scripts[side]["log"]
            canary = [s for tag, s, *_ in log if tag == "canary 1/4"]
            assert canary.count("m:v2") == round(8 * 0.25) == 2
            assert scripts[side]["canary"] == {"version": 2,
                                               "fraction": 0.25}
        j = [s for tag, s, *_ in scripts["jax"]["log"]
             if tag == "canary 1/4"]
        t = [s for tag, s, *_ in scripts["torch"]["log"]
             if tag == "canary 1/4"]
        assert t == j == ["m:v1"] * 3 + ["m:v2"] + ["m:v1"] * 3 + ["m:v2"]

    def test_w111_codes_equal(self, scripts):
        for key in ("w_unwarmed", "w_missing", "rolled_warning"):
            assert scripts["torch"][key] == scripts["jax"][key] \
                == ["DL4J-W111"], key

    def test_models_snapshot_equal(self, scripts):
        assert scripts["torch"]["snapshot"] == scripts["jax"]["snapshot"]
        active, previous, versions, retired, keys = \
            scripts["torch"]["snapshot"]
        assert (active, previous, versions) == (2, 4, [1, 2, 3, 4])
        assert retired == [True, False, False, False]


class TestSwapStorm:
    @pytest.mark.parametrize("side", list(SIDES))
    def test_no_request_dropped_under_a_seeded_swap_schedule(self, side):
        _, const, faults, _, make = SIDES[side]
        reg = make(batch_limit=8, max_queue=256, coalesce_ms=0.5)
        try:
            reg.load("c", const(1), shapes=[(NIN,)])
            reg.load("c", const(2))
            load = faults.ServingLoad.seeded(11, mix="steady", n=80,
                                             rps=400.0, max_rows=2)
            handles = []

            def submit(x, deadline=None):
                h = reg.submit("c", x, deadline=deadline)
                handles.append(h)
                return h
            swaps = faults.SwapSchedule.seeded(
                7, "c", load.duration(), n_swaps=3).start(reg)
            results = load.replay(submit, (NIN,), rng_seed=5)
            performed = swaps.join(30.0)
            assert [a for _, _, a, _ in performed] == \
                ["roll", "rollback", "roll"]
            assert len(handles) == len(results) == len(load)
            seen = set()
            for spec, h in results:
                out = np.asarray(h.get(30.0))
                assert h.resolutions == 1
                assert out.shape == (spec.rows, 1)
                v = int(out[0, 0])
                assert h.server == f"c:v{v}"
                seen.add(v)
            assert seen == {1, 2}
            for v in (1, 2):
                assert reg.server("c", v).recompiles_after_warmup() == 0
        finally:
            reg.close()


class TestStress:
    def test_rolls_against_many_submitters_lose_no_request(self):
        """8 submitting threads against a thread that rolls and rolls
        back, with the interpreter switching threads every 10 us: every
        request resolves once, on the version its answer names, and the
        two servers' completed counts add up to the requests made.

        A serve loop counts a request completed just after it resolves
        the request's handle, so the counts are read once ``close()`` has
        joined both serve loops, not as soon as the last handle resolves
        (that read raced the last batch's counting)."""
        reg = treg.ModelRegistry(device="cpu", batch_limit=8, max_queue=512,
                                 coalesce_ms=0.2)
        old = sys.getswitchinterval()
        try:
            reg.load("s", _const_t(1), shapes=[(NIN,)])
            reg.load("s", _const_t(2))
            servers = [reg.server("s", v) for v in (1, 2)]
            stop = threading.Event()
            handles, errors = [], []

            def roller():
                while not stop.is_set():
                    reg.roll("s", 2)
                    reg.rollback("s")

            def submitter(k):
                try:
                    for i in range(40):
                        handles.append(reg.submit("s", _x(1 + i % 3, k)))
                except Exception as e:
                    errors.append(e)
            sys.setswitchinterval(1e-5)
            threads = [threading.Thread(target=submitter, args=(k,))
                       for k in range(8)]
            rolls = threading.Thread(target=roller)
            rolls.start()
            for th in threads:
                th.start()
            for th in threads:
                th.join(60)
            stop.set()
            rolls.join(60)
            assert not any(th.is_alive() for th in threads + [rolls])
            assert not errors and len(handles) == 320
            for h in handles:
                v = int(np.asarray(h.get(60))[0, 0])
                assert h.resolutions == 1 and h.server == f"s:v{v}"
            reg.close()
            assert not any(srv._worker.is_alive() for srv in servers)
            done = sum(srv.counts["completed"] for srv in servers)
            assert done == 320
        finally:
            sys.setswitchinterval(old)
            reg.close()


class TestPortSurface:
    def test_needs_a_device_or_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            treg.ModelRegistry()

    def test_concurrent_loads_reserve_distinct_versions(self):
        reg = treg.ModelRegistry(device="cpu", batch_limit=2)
        got = {}
        try:
            threads = [threading.Thread(target=lambda v=v: got.setdefault(
                reg.load("m", _const_t(v), shapes=[(NIN,)], roll=False), v))
                for v in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(30)
            assert sorted(got) == [1, 2, 3, 4]
            with pytest.raises(treg.ModelNotFoundError):
                reg.submit("m", _x())        # nothing rolled yet
            reg.roll("m", 3)
            assert reg.output("m", _x(), timeout=30)[0, 0] == got[3]
        finally:
            reg.close()
