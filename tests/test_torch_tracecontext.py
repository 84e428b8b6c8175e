"""The port's tracing layer (CPU) against the JAX package's on the same
inputs: ``traceparent`` parse and format, ``span``/``record_span`` and
the span tracer's Chrome-trace export, the flight recorder's ring and
dump, the instrumented locks and the lock-order witness, the dispatch
watchdog and the preemption signals."""

import json
import os
import threading
import time

import pytest

from deeplearning4j_tpu.parallel import elastic as jel
from deeplearning4j_tpu.profiler import flightrec as jfr
from deeplearning4j_tpu.profiler import locks as jlk
from deeplearning4j_tpu.profiler import tracecontext as jtc
from deeplearning4j_tpu.profiler import tracer as jtr
from deeplearning4j_tpu.train import resilience as jres
from deeplearning4j_tpu_torch import faults as tfaults
from deeplearning4j_tpu_torch.parallel import elastic as tel
from deeplearning4j_tpu_torch.profiler import flightrec as tfr
from deeplearning4j_tpu_torch.profiler import locks as tlk
from deeplearning4j_tpu_torch.profiler import tracecontext as ttc
from deeplearning4j_tpu_torch.profiler import tracer as ttr
from deeplearning4j_tpu_torch.train import resilience as tres

HEADERS = [
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-4BF92F3577B34DA6A3CE929D0E0E4736-00F067AA0BA902B7-00",
    " 00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01 ",
    "ff-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01",
    "00-00000000000000000000000000000000-00f067aa0ba902b7-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-0000000000000000-01",
    "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7",
    "garbage", "", None,
]


@pytest.fixture()
def tracing():
    """Tracing on in both packages, their rings empty; off after."""
    for mod in (jtr, ttr):
        mod.get_tracer().clear()
        mod.enable_tracing()
    yield
    for mod in (jtr, ttr):
        mod.disable_tracing()
        mod.get_tracer().clear()


def _shape(ev):
    """A span without its ids and clock: what two runs can agree on."""
    args = {k: v for k, v in ev.get("args", {}).items()
            if k not in ("trace_id", "span_id", "parent_span_id", "links")}
    return ev["name"], ev["ph"], sorted(args.items()), \
        len(ev.get("args", {}).get("links", ()))


class TestTraceparent:
    @pytest.mark.parametrize("header", HEADERS)
    def test_parse_equals_jax(self, header):
        j = jtc.TraceContext.from_traceparent(header)
        t = ttc.TraceContext.from_traceparent(header)
        assert (j is None) == (t is None)
        if t is not None:
            assert (t.trace_id, t.span_id, t.parent_id) == \
                (j.trace_id, j.span_id, j.parent_id)
            assert t.to_traceparent() == j.to_traceparent()
            assert t.args() == j.args()

    def test_child_and_wire_form(self):
        root = ttc.TraceContext.new()
        kid = root.child()
        assert kid.trace_id == root.trace_id and kid.parent_id == \
            root.span_id and kid.span_id != root.span_id
        back = ttc.TraceContext.from_traceparent(kid.to_traceparent())
        assert (back.trace_id, back.span_id) == (kid.trace_id, kid.span_id)
        assert jtc.TraceContext.from_traceparent(
            kid.to_traceparent()).args() == back.args()


class TestSpans:
    def _drive(self, tc, tr):
        root = tc.TraceContext.from_traceparent(HEADERS[0])
        with tc.span("serve:route", parent=root, model="m") as ctx:
            tc.record_span("serve:admission", ctx.child(), tr.now_us(), 5.0,
                           args={"outcome": "admitted", "rows": 2})
            with tr.trace_span("op:inner", size=3):
                pass
        kids = [root.child() for _ in range(3)]
        tc.record_span("serve:dispatch", kids[0], tr.now_us(), 7.0,
                       args={"requests": 3}, links=kids)
        with pytest.raises(KeyError):
            with tc.span("serve:fail", parent=root):
                raise KeyError("x")
        tc.record_span("untraced", None, 0.0, 1.0)
        return root, tr.get_tracer().events()

    def test_same_spans_as_jax(self, tracing):
        jroot, jev = self._drive(jtc, jtr)
        troot, tev = self._drive(ttc, ttr)
        assert [_shape(e) for e in tev] == [_shape(e) for e in jev]
        assert len(ttc.spans_for_trace(troot.trace_id)) == \
            len(jtc.spans_for_trace(jroot.trace_id)) == 5
        disp = [e for e in tev if e["name"] == "serve:dispatch"][0]
        assert len(disp["args"]["links"]) == 3
        doc = ttr.get_tracer().to_chrome_trace()
        assert json.loads(json.dumps(doc))["traceEvents"][0]["ph"] == "M"
        assert len(doc["traceEvents"]) == len(tev) + 1

    def test_nothing_recorded_while_tracing_is_off(self):
        ttr.get_tracer().clear()
        with ttc.span("serve:x"):
            ttc.record_span("serve:y", ttc.TraceContext.new(), 0.0, 1.0)
        assert len(ttr.get_tracer()) == 0


class TestFlightRecorder:
    def _drive(self, mod, directory, clock):
        rec = mod.FlightRecorder(capacity=4, directory=str(directory),
                                 min_dump_interval=5.0, clock=clock)
        for i in range(6):
            rec.record("serving:dispatch", rows=i, bucket=8)
        first = rec.dump("dispatch_timeout", exc=RuntimeError("hung"))
        again = rec.dump("dispatch_timeout")
        return rec, first, again

    def test_ring_and_dump_equal_jax(self, tmp_path):
        clock = iter(range(1000)).__next__
        jrec, jpath, jagain = self._drive(jfr, tmp_path / "jax", clock)
        clock = iter(range(1000)).__next__
        trec, tpath, tagain = self._drive(tfr, tmp_path / "torch", clock)
        assert trec.events() == jrec.events()
        assert [e["rows"] for e in trec.events()] == [2, 3, 4, 5]
        assert tagain is None and jagain is None
        assert sorted(os.listdir(tpath)) == sorted(os.listdir(jpath)) == [
            "config.json", "events.json", "metrics.txt", "reason.txt",
            "trace.json"]
        with open(os.path.join(tpath, "events.json")) as f:
            t_events = json.load(f)
        with open(os.path.join(jpath, "events.json")) as f:
            assert json.load(f) == t_events
        with open(os.path.join(tpath, "reason.txt")) as f:
            assert f.read().startswith(
                "reason: dispatch_timeout\nexception: RuntimeError: hung")
        with open(os.path.join(tpath, "config.json")) as f:
            cfg = json.load(f)
        assert "torch" in cfg and "stats" in cfg["compile_cache"]

    def test_configure_keeps_events(self):
        rec = tfr.get_flight_recorder()
        rec.record("probe:configure")
        before = rec.capacity
        try:
            assert tfr.configure(capacity=8) is rec
            assert rec.events()[-1]["kind"] == "probe:configure"
        finally:
            tfr.configure(capacity=before)


class TestLocks:
    @pytest.mark.parametrize("mod", [jlk, tlk], ids=["jax", "torch"])
    def test_witness_raises_on_inversion(self, mod):
        a, b = mod.InstrumentedLock("probe:a"), mod.InstrumentedLock(
            "probe:b")
        mod.enable_lock_order_witness(raise_on_inversion=True)
        try:
            with a:
                with b:
                    pass
            assert ("probe:a", "probe:b") in mod.lock_order_edges()
            with b:
                with pytest.raises(mod.LockOrderInversionError):
                    a.acquire()
            assert not a.locked()
        finally:
            mod.disable_lock_order_witness()

    def test_condition_and_wait_hold_series(self):
        from deeplearning4j_tpu_torch.profiler import metrics, modes
        modes.set_profiling_mode(modes.ProfilingMode.BASIC)
        try:
            cond = tlk.InstrumentedCondition("probe:cond")
            hits = []

            def waiter():
                with cond:
                    cond.wait_for(lambda: hits, timeout=5)
            th = threading.Thread(target=waiter)
            th.start()
            time.sleep(0.02)
            with cond:
                hits.append(1)
                cond.notify_all()
            th.join(5)
            assert not th.is_alive()
            hold = metrics.get_registry().get("dl4j_lock_hold_seconds")
            assert hold.labels(lock="probe:cond").count >= 2
        finally:
            modes.set_profiling_mode(None)
        assert modes.get_profiling_mode() is modes.ProfilingMode.OFF


class TestWatchdogAndPreemption:
    @pytest.mark.parametrize("hang", [0.3, None])
    def test_watchdog_outcomes_equal_jax(self, hang):
        outcomes = []
        for el, mk in ((jel, None), (tel, tfaults.FaultPlan)):
            from deeplearning4j_tpu import faults as jfaults
            plan = (mk or jfaults.FaultPlan)(hung_dispatch_at=[2],
                                             hang_seconds=hang)
            wd = el.DispatchWatchdog(0.05, grace=0.15, plan=plan, warmup=0)
            got = [wd.run(lambda: "ok", 1)]
            try:
                got.append(wd.run(lambda: "ok", 2))
            except el.DispatchTimeoutError:
                got.append("timeout")
            outcomes.append((got, wd.timeouts, wd.stragglers))
        assert outcomes[0] == outcomes[1]
        assert outcomes[1][0] == ["ok", "timeout"]

    def test_step_and_signal_preemption(self):
        for res in (jres, tres):
            p = res.StepPreemption(3)
            assert [p.requested(s) for s in range(5)] == \
                [False, False, False, True, True]
        fired = []
        sig = tres.SignalPreemption(on_request=lambda: fired.append(1))
        assert sig.install() is True
        try:
            os.kill(os.getpid(), 15)
            time.sleep(0.05)
            assert sig.requested(0) and fired == [1]
        finally:
            sig.uninstall()
