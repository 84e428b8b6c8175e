"""The port's ModelServer front half (CPU) against the JAX ModelServer on
the same transplanted weights and traffic: argmax answers, outcome
counts, batch buckets and zero recompiles after warmup; a callable head
and an explicit ``forward=``; ``StepPreemption`` drains; a hung forward
under ``replica_timeout`` times out and is retried; one traced request's
spans and links; and the captured served forward (one capture per
bucket x shape, none after warmup) driven by the stand-in graph of
``test_torch_compilecache.py``.

Both bucket ladders are ``[1, 2, 4]``: the JAX servers run on a
one-device mesh. Tolerances: argmax equal; float heads 1e-5 absolute."""

import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu import faults as jfaults
from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu.parallel.mesh import DeviceMesh
from deeplearning4j_tpu.profiler import tracecontext as jtc
from deeplearning4j_tpu.profiler import tracer as jtracer
from deeplearning4j_tpu.serving import ModelServer as JaxModelServer
from deeplearning4j_tpu.train import resilience as jres
from deeplearning4j_tpu_torch import faults as tfaults
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.nn import compilecache as cc
from deeplearning4j_tpu_torch.profiler import flightrec as tfr
from deeplearning4j_tpu_torch.profiler import tracecontext as ttc
from deeplearning4j_tpu_torch.profiler import tracer as ttracer
from deeplearning4j_tpu_torch.serving import ModelServer, ServerDrainingError
from deeplearning4j_tpu_torch.train import resilience as tres
from test_torch_compilecache import fake_capture  # noqa: F401 (fixture)

torch.set_num_threads(2)

T = 128
SMALL = dict(d_model=128, n_heads=2, n_layers=2, d_ff=256, vocab_size=1024,
             max_len=T)
TRACE = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"


@pytest.fixture(scope="module")
def lms():
    jcfg = jtr.TransformerConfig.tiny(dtype=jnp.float32, **SMALL)
    tcfg = ttr.TransformerConfig.tiny(dtype=torch.float32, **SMALL)
    jlm = jtr.TransformerLM(jcfg, seed=0)
    params = ttr.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jlm.params), tcfg, "cpu")
    return jlm, ttr.TransformerLM(tcfg, device="cpu", params=params)


def _mesh():
    return DeviceMesh.data_parallel(jax.devices()[:1])


def _rows(seed, sizes):
    r = np.random.default_rng(seed)
    return [r.integers(0, 1024, (n, T), dtype=np.int32) for n in sizes]


def _recording(fn, seen):
    def forward(x):
        seen.append(int(x.shape[0]))
        return fn(x)
    return forward


def _pair(lms, jkw, tkw):
    """The same server in both packages: (jax, torch)."""
    jlm, tlm = lms
    return (JaxModelServer(jlm, mesh=_mesh(), batch_limit=4,
                           input_dtype=np.int32, **jkw),
            ModelServer(tlm, device="cpu", batch_limit=4,
                        input_dtype=np.int32, **tkw))


class TestServedParity:
    def test_answers_counts_buckets_and_zero_recompiles(self, lms):
        jlm, tlm = lms
        reqs = _rows(1, [1, 3, 2, 4, 1])
        seen = {"jax": [], "torch": []}
        outs = {}
        for key, cls, kw, fwd in (
                ("jax", JaxModelServer, {"mesh": _mesh()}, jlm.logits),
                ("torch", ModelServer, {"device": "cpu"}, tlm.logits)):
            sv = cls(fwd, batch_limit=4, input_dtype=np.int32,
                     head="argmax", forward=_recording(fwd, seen[key]), **kw)
            try:
                sv.warmup([(T,)])
                assert sv.buckets() == [1, 2, 4]
                outs[key] = [np.asarray(sv.output(r, timeout=120))
                             for r in reqs]
                outs[key + "_counts"] = dict(sv.counts)
                assert sv.recompiles_after_warmup() == 0
                assert sv.stats()["recompiles_after_warmup"] == 0
            finally:
                sv.close()
        assert seen["torch"] == seen["jax"] == [1, 2, 4, 1, 4, 2, 4, 1]
        assert outs["torch_counts"] == outs["jax_counts"] == {"completed": 5}
        for g, w in zip(outs["torch"], outs["jax"]):
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)

    def test_callable_head_and_forward_agree_with_jax(self, lms):
        jlm, tlm = lms
        reqs = _rows(2, [2, 3])

        def jhead(y):
            return jnp.max(y, axis=-1), jnp.argmax(y, axis=-1)

        def thead(y):
            vals, idx = torch.max(y, dim=-1)
            return vals, idx.to(torch.int32)
        j, t = _pair(lms, {"forward": jlm.logits, "head": jhead},
                     {"forward": tlm.logits, "head": thead})
        try:
            for sv in (j, t):
                sv.warmup([(T,)])
            for r in reqs:
                (jv, ji), (tv, ti) = j.output(r, timeout=120), \
                    t.output(r, timeout=120)
                np.testing.assert_allclose(tv, np.asarray(jv), rtol=0,
                                           atol=1e-5)
                np.testing.assert_array_equal(ti, np.asarray(ji))
        finally:
            j.close()
            t.close()

    def test_softmax_head_agrees_with_jax(self, lms):
        jlm, tlm = lms
        r = _rows(3, [2])[0]
        j, t = _pair(lms, {"forward": jlm.logits, "head": "softmax"},
                     {"forward": tlm.logits, "head": "softmax"})
        try:
            np.testing.assert_allclose(t.output(r, timeout=120),
                                       np.asarray(j.output(r, timeout=120)),
                                       rtol=0, atol=1e-5)
        finally:
            j.close()
            t.close()


def _echo_j(x):
    return x * 2.0


def _echo_t(x):
    return x.float() * 2.0


class TestDegradation:
    def test_step_preemption_drains_after_the_same_batches(self):
        outcomes = {}
        for key, cls, res, fwd, kw in (
                ("jax", JaxModelServer, jres, _echo_j, {"mesh": _mesh()}),
                ("torch", ModelServer, tres, _echo_t, {"device": "cpu"})):
            sv = cls(fwd, batch_limit=2, coalesce_ms=0.0,
                     preemption=res.StepPreemption(2), **kw)
            got = []
            try:
                for i in range(4):
                    try:
                        sv.output(np.full((1, 3), i, np.float32),
                                  timeout=30)
                        got.append("ok")
                    except Exception as e:
                        got.append(type(e).__name__)
                outcomes[key] = (got, dict(sv.counts), sv.state)
            finally:
                sv.close()
        assert outcomes["torch"] == outcomes["jax"]
        got, counts, state = outcomes["torch"]
        assert got == ["ok", "ok", "ServerDrainingError",
                       "ServerDrainingError"]
        assert counts == {"completed": 2, "shed_draining": 2}
        assert state == "draining"
        assert ServerDrainingError.__name__ == got[2]

    def test_hung_forward_times_out_and_is_retried(self, tmp_path,
                                                   monkeypatch):
        monkeypatch.setenv("DL4J_FLIGHTREC_DIR", str(tmp_path))
        results = {}
        for key, cls, faults, fwd, kw in (
                ("jax", JaxModelServer, jfaults, _echo_j, {"mesh": _mesh()}),
                ("torch", ModelServer, tfaults, _echo_t, {"device": "cpu"})):
            plan = faults.FaultPlan(hung_dispatch_at=[2], hang_seconds=None)
            sv = cls(fwd, batch_limit=2, coalesce_ms=0.0,
                     replica_timeout=0.1, faults=plan, name=f"hung-{key}",
                     **kw)
            try:
                sv.warmup([(3,)])
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    outs = [np.asarray(sv.output(
                        np.full((1, 3), i, np.float32), timeout=30))
                        for i in range(3)]
                msgs = [str(w.message) for w in caught
                        if "attempt 1" in str(w.message)]
                results[key] = (outs, dict(sv.counts), len(msgs),
                                sv._watchdog.timeouts,
                                sv.breaker.state)
            finally:
                sv.close()
        (j_out, *j_rest), (t_out, *t_rest) = results["jax"], results["torch"]
        assert t_rest == j_rest
        assert t_rest[:2] == [{"completed": 3}, 1] and t_rest[2] == 1
        for a, b in zip(t_out, j_out):
            np.testing.assert_array_equal(a, b)
        fails = [e for e in tfr.get_flight_recorder().events()
                 if e["kind"] == "serving:dispatch_failure"
                 and e.get("server") == "hung-torch"]
        assert fails and fails[-1]["error"] == "DispatchTimeoutError"

    @pytest.mark.parametrize("seed", [0, 7])
    def test_seeded_serving_plan_equals_jax(self, seed):
        kw = dict(horizon=20, n_fail=2, n_slow=1, n_hang=1)
        j = jfaults.FaultPlan.seeded_serving(seed, **kw)
        t = tfaults.FaultPlan.seeded_serving(seed, **kw)
        for key in ("serve_fail_at", "slow_replica_at", "hung_dispatch_at",
                    "slow_seconds", "hang_seconds"):
            assert getattr(t, key) == getattr(j, key), key

    def test_injected_replica_fault_is_retried_as_in_jax(self):
        results = {}
        for key, cls, faults, fwd, kw in (
                ("jax", JaxModelServer, jfaults, _echo_j, {"mesh": _mesh()}),
                ("torch", ModelServer, tfaults, _echo_t, {"device": "cpu"})):
            plan = faults.FaultPlan(serve_fail_at=[2])
            sv = cls(fwd, batch_limit=2, coalesce_ms=0.0, faults=plan,
                     **kw)
            try:
                sv.warmup([(3,)])
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    outs = [np.asarray(sv.output(
                        np.full((1, 3), i, np.float32), timeout=30))
                        for i in range(3)]
                results[key] = (outs, dict(sv.counts), sv.breaker.state)
            finally:
                sv.close()
        (j_out, *j_rest), (t_out, *t_rest) = results["jax"], results["torch"]
        assert t_rest == j_rest == [{"completed": 3}, "closed"]
        for a, b in zip(t_out, j_out):
            np.testing.assert_array_equal(a, b)

    def test_preemption_true_installs_and_close_releases(self):
        import signal
        before = signal.getsignal(signal.SIGTERM)
        sv = ModelServer(_echo_t, device="cpu", preemption=True)
        try:
            assert sv._preemption_installed
            assert signal.getsignal(signal.SIGTERM) is not before
        finally:
            sv.close()
        assert signal.getsignal(signal.SIGTERM) is before


class TestTracing:
    def test_one_traced_request_same_spans_and_links(self):
        names = {}
        for key, cls, tc, tr, fwd, kw in (
                ("jax", JaxModelServer, jtc, jtracer, _echo_j,
                 {"mesh": _mesh()}),
                ("torch", ModelServer, ttc, ttracer, _echo_t,
                 {"device": "cpu"})):
            sv = cls(fwd, batch_limit=2, **kw)
            try:
                sv.warmup([(3,)])
                tr.get_tracer().clear()
                tr.enable_tracing()
                ctx = tc.TraceContext.from_traceparent(TRACE).child()
                req = sv.submit(np.ones((1, 3), np.float32), trace=ctx)
                req.get(30)
                sv.close()
            finally:
                tr.disable_tracing()
                sv.close()
            spans = [e for e in tc.spans_for_trace(ctx.trace_id)
                     if e["name"].startswith("serve:")]
            tr.get_tracer().clear()
            disp = [e for e in spans if e["name"] == "serve:dispatch"]
            names[key] = (sorted(e["name"] for e in spans),
                          [[lk["span_id"] for lk in e["args"]["links"]]
                           for e in disp],
                          ctx.span_id)
        assert names["torch"][0] == names["jax"][0] == [
            "serve:admission", "serve:coalesce", "serve:dispatch",
            "serve:queue", "serve:terminal"]
        for key in ("jax", "torch"):
            links, root = names[key][1], names[key][2]
            assert links == [[root]]


class TestCapturedServing:
    def test_one_capture_per_bucket_and_shape_none_after(self, lms,
                                                         fake_capture):
        _, tlm = lms
        cc.reset_stats()
        with ModelServer(tlm.logits, device="cpu", batch_limit=4,
                         input_dtype=np.int32, head="argmax") as sv:
            sv.warmup([(T,), (64,)])
            assert len(fake_capture) == sv._dispatch.captures() == 6
            assert sv._dispatch.warmed_signatures() == 6
            reqs = _rows(4, [1, 3, 2]) + [np.zeros((2, 64), np.int32)]
            got = [sv.output(r, timeout=120) for r in reqs]
            assert sv.captures_after_warmup() == 0
            assert sv.recompiles_after_warmup() == 0
            assert sum(g.replays for g in fake_capture) == 6 + len(reqs)
            st = cc.cache_stats()
            assert st["capture_failures"] == 0
            assert st["compile_seconds"]["cold_compiles"] == 6
        for r, g in zip(reqs, got):
            want = tlm.logits(r).argmax(-1).to(torch.int32).numpy()
            np.testing.assert_array_equal(g, want)

    def test_before_warmup_the_forward_runs_eagerly(self, fake_capture):
        with ModelServer(_echo_t, device="cpu", batch_limit=2) as sv:
            out = sv.output(np.ones((1, 3), np.float32), timeout=30)
            np.testing.assert_array_equal(out, np.full((1, 3), 2.0))
            assert not fake_capture and sv._dispatch.captures() == 0
            sv.warmup([(3,)])
            assert len(fake_capture) == 2
            with pytest.raises(ValueError, match="not warmed"):
                sv.submit(np.ones((1, 4), np.float32))
