"""The port's fleet observability against the JAX package's on the CPU:
``profiler/aggregate.py`` (the same exposition text gives equal families
and fleet quantiles, counters and merged expositions),
``profiler/slo.py`` (``SLOEngine`` gives equal burn rates under an
injected clock; the default metric names are series the port emits) and
the front door's ``GET /v1/fleet/metrics``, ``/v1/fleet/load`` and
``/v1/slo`` (a ``FleetScraper`` feeding a ``MetricsAggregator`` from two
members, the ingress's own ``/metrics`` and a ``UIServer``'s; an
``SLOGate`` over a short replay) with the JAX ingress's status and keys.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from deeplearning4j_tpu import profiler as jprof
from deeplearning4j_tpu.parallel.mesh import DeviceMesh
from deeplearning4j_tpu.profiler.metrics import MetricsRegistry as JRegistry
from deeplearning4j_tpu.serving import HttpIngress as JIngress
from deeplearning4j_tpu.serving import ModelRegistry as JModelRegistry
from deeplearning4j_tpu.ui import UIServer as JUIServer
from deeplearning4j_tpu_torch import profiler as prof
from deeplearning4j_tpu_torch.faults import ServingLoad
from deeplearning4j_tpu_torch.profiler import aggregate, slo
from deeplearning4j_tpu_torch.profiler.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.serving import HttpIngress, ModelRegistry
from deeplearning4j_tpu_torch.ui import UIServer

torch.set_num_threads(2)

NIN, NOUT = 4, 3
W = np.random.RandomState(0).randn(NIN, NOUT).astype(np.float32)

HOST_A = """\
# HELP dl4j_serving_latency_seconds Request latency
# TYPE dl4j_serving_latency_seconds histogram
dl4j_serving_latency_seconds_bucket{le="0.1"} 5
dl4j_serving_latency_seconds_bucket{le="0.5"} 8
dl4j_serving_latency_seconds_bucket{le="+Inf"} 10
dl4j_serving_latency_seconds_sum 2.0
dl4j_serving_latency_seconds_count 10
# TYPE dl4j_serving_requests_total counter
dl4j_serving_requests_total{outcome="completed"} 10
# TYPE dl4j_serving_queue_depth gauge
dl4j_serving_queue_depth 3
# TYPE h histogram
h_bucket{le="1.0"} 4 # {trace_id="abc"} 0.73
h_bucket{le="+Inf"} 5
h_sum 2.5
h_count 5
# EOF
"""
HOST_B = """\
# TYPE dl4j_serving_latency_seconds histogram
dl4j_serving_latency_seconds_bucket{le="0.1"} 1
dl4j_serving_latency_seconds_bucket{le="0.25"} 3
dl4j_serving_latency_seconds_bucket{le="0.5"} 5
dl4j_serving_latency_seconds_bucket{le="+Inf"} 9
dl4j_serving_latency_seconds_sum 3.0
dl4j_serving_latency_seconds_count 9
# TYPE dl4j_serving_requests_total counter
dl4j_serving_requests_total{outcome="completed"} 7
dl4j_serving_requests_total{outcome="shed_deadline"} 2
# TYPE dl4j_serving_queue_depth gauge
dl4j_serving_queue_depth 1
"""


def _families(parse, text):
    return {name: (fam.typ, dict(fam.samples))
            for name, fam in parse(text).items()}


@pytest.mark.parametrize("text", [HOST_A, HOST_B], ids=["a", "b"])
def test_parse_exposition_gives_equal_families(text):
    assert _families(aggregate.parse_exposition, text) == \
        _families(jprof.parse_exposition, text)


def _aggs(clock):
    out = []
    for A in (aggregate.MetricsAggregator, jprof.MetricsAggregator):
        agg = A(max_age=30.0, clock=clock)
        agg.ingest("a", HOST_A)
        agg.ingest("b", HOST_B)
        agg.ingest_load("a", {"totals": {"queue_depth": 3, "max_queue": 8,
                                         "breakers_open": 0,
                                         "shed_rate": 0.2, "ready": True}})
        agg.ingest_load("b", {"totals": {"queue_depth": 1, "max_queue": 8,
                                         "breakers_open": 1,
                                         "shed_rate": 0.0, "ready": True}})
        out.append(agg)
    return out


def test_fleet_merge_and_quantiles_equal():
    now = [5.0]
    ours, theirs = _aggs(lambda: now[0])
    for q in (0.1, 0.5, 0.9, 0.99):
        assert ours.quantile("dl4j_serving_latency_seconds", q) == \
            theirs.quantile("dl4j_serving_latency_seconds", q)
    a = ours.fleet_histogram("dl4j_serving_latency_seconds")
    b = theirs.fleet_histogram("dl4j_serving_latency_seconds")
    assert (a.bounds, a.cumulative, a.count, a.sum) == \
        (b.bounds, b.cumulative, b.count, b.sum)
    for labels in ({"outcome": "completed"}, {"outcome": "shed_deadline"}):
        assert ours.counter_total("dl4j_serving_requests_total", labels) \
            == theirs.counter_total("dl4j_serving_requests_total", labels)
    assert ours.exposition() == theirs.exposition()
    assert ours.fleet_load() == theirs.fleet_load()
    now[0] = 40.0                                # both hosts age out
    assert ours.hosts() == theirs.hosts() == []


def _slo_run(pk_metrics, pk_slo):
    reg = pk_metrics()
    lat = reg.histogram("dl4j_serving_latency_seconds", "lat",
                        buckets=(0.1, 0.25, 1.0))
    outcomes = reg.counter("dl4j_serving_requests_total", "req",
                           labelnames=("outcome",))
    step = reg.histogram("dl4j_train_iteration_seconds", "step",
                         buckets=(0.1, 1.0))
    clock = [0.0]
    engine = pk_slo.SLOEngine(
        [pk_slo.SLOSpec("serve", objective=0.9, latency_bound=0.25,
                        shed_rate=0.2, availability=0.99,
                        windows=(60.0, 600.0)),
         pk_slo.SLOSpec("train", step_time_baseline=0.1)],
        registry=reg, clock=lambda: clock[0])
    gate = pk_slo.SLOGate(engine)
    verdicts = []
    for t, n, latency, outcome, st in (
            (0.0, 20, 0.05, "completed", 0.1),
            (30.0, 20, 0.9, "shed_deadline", 0.3),
            (100.0, 20, 0.05, "completed", 0.1),
            (700.0, 5, 0.3, "failed", 0.05)):
        clock[0] = t
        for _ in range(n):
            lat.observe(latency)
            outcomes.labels(outcome=outcome).inc()
            step.observe(st)
        v = gate()
        verdicts.append((v.passing, v.failures, v.detail))
    burn = {k: c.value for k, c in reg.get("dl4j_slo_burn_rate")
            .children().items()}
    return verdicts, burn


def test_slo_engine_gives_equal_burn_rates():
    from deeplearning4j_tpu.profiler import slo as jslo
    ours = _slo_run(MetricsRegistry, slo)
    theirs = _slo_run(JRegistry, jslo)
    assert ours == theirs
    passing = [v[0] for v in ours[0]]
    assert passing == [True, False, True, False]


def test_the_default_slo_metrics_are_series_the_port_emits():
    from deeplearning4j_tpu_torch.serving import server  # noqa: F401
    from deeplearning4j_tpu_torch.train.listeners import MetricsListener
    MetricsListener()
    reg = prof.get_registry()
    assert isinstance(reg.get(slo.DEFAULT_LATENCY_METRIC), prof.Histogram)
    assert isinstance(reg.get(slo.DEFAULT_REQUESTS_METRIC), prof.Counter)
    assert isinstance(reg.get(slo.DEFAULT_STEP_METRIC), prof.Histogram)
    assert "outcome" in reg.get(slo.DEFAULT_REQUESTS_METRIC).labelnames
    assert set(slo.SHED_OUTCOMES) <= _port_outcomes()


def _port_outcomes():
    import inspect
    from deeplearning4j_tpu_torch.serving import server
    src = inspect.getsource(server)
    return {o for o in ("shed_overload", "shed_deadline", "shed_draining",
                        "rejected_unhealthy") if f'"{o}"' in src}


def test_members_from_a_coordinator_are_duck_typed():
    class Coordinator:
        def members(self, fresh_within=None):
            return {"w0": {"meta": {"metrics_url": "http://h0:1"}},
                    "w1": {"meta": {}}, "w2": {"meta": None}}
    assert aggregate.members_from_coordinator(Coordinator()) == \
        jprof.members_from_coordinator(Coordinator()) == \
        {"w0": "http://h0:1"}


# ------------------------------------------------------------ front door
def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _front_door(side):
    """The fleet and SLO endpoints of one package's ingress, fed by a
    scraper of two members: the ingress's own /metrics and a UIServer's."""
    if side == "jax":
        reg = JModelRegistry(batch_limit=8, coalesce_ms=0.5,
                             mesh=DeviceMesh.data_parallel(
                                 jax.devices()[:1]))
        fwd = lambda x: x @ jnp.asarray(W)           # noqa: E731
        P, Ing, UI = jprof, JIngress, JUIServer
    else:
        reg = ModelRegistry(batch_limit=8, coalesce_ms=0.5, device="cpu")
        fwd = lambda x: x.float() @ torch.from_numpy(W)  # noqa: E731
        P, Ing, UI = prof, HttpIngress, UIServer
    reg.load("m", fwd, shapes=[(NIN,)])
    agg = P.MetricsAggregator(max_age=60.0)
    gate = P.SLOGate(P.SLOEngine([P.SLOSpec(
        "serve", objective=0.99, latency_bound=0.25, availability=0.99)]))
    ing = Ing(reg, port=0, fleet=agg, slo=gate).start()
    ui_server = UI(port=0)
    ui_server.attach_serving(None)
    out = {}
    try:
        scraper = P.FleetScraper(agg, lambda: {
            "ingress": ing.url, "ui": ui_server.url.rstrip("/")})
        load = ServingLoad.seeded(3, mix="steady", n=24, rps=150.0)
        load.replay_http(ing.url, "m", (NIN,))
        out["scrape"] = scraper.scrape_once()
        out["fleet/metrics"] = _get(ing.url + "/v1/fleet/metrics")
        out["fleet/load"] = _get(ing.url + "/v1/fleet/load")
        out["slo"] = _get(ing.url + "/v1/slo")
    finally:
        ing.stop()
        ui_server.stop()
        reg.close()
    return out


@pytest.fixture(scope="module")
def front_doors():
    return {side: _front_door(side) for side in ("jax", "port")}


def test_both_members_are_scraped(front_doors):
    assert front_doors["port"]["scrape"] == {"ingress": True, "ui": True}
    assert front_doors["jax"]["scrape"] == front_doors["port"]["scrape"]


def test_fleet_metrics_answer_with_both_hosts(front_doors):
    code, text = front_doors["port"]["fleet/metrics"]
    assert code == 200
    assert "dl4j_fleet_members 2" in text
    assert 'host="ingress"' in text and 'host="ui"' in text
    fams = aggregate.parse_exposition(text)
    assert "dl4j_serving_latency_seconds" in fams
    jcode, jtext = front_doors["jax"]["fleet/metrics"]
    assert jcode == code and "dl4j_fleet_members 2" in jtext


def test_fleet_load_answers_with_both_hosts(front_doors):
    code, body = front_doors["port"]["fleet/load"]
    jcode, jbody = front_doors["jax"]["fleet/load"]
    assert code == jcode == 200
    body, jbody = json.loads(body), json.loads(jbody)
    assert sorted(body) == sorted(jbody)
    assert sorted(body["totals"]) == sorted(jbody["totals"])
    assert set(body["hosts"]) == {"ingress"}     # the UIServer has no load


def test_slo_answers_a_verdict(front_doors):
    code, body = front_doors["port"]["slo"]
    jcode, jbody = front_doors["jax"]["slo"]
    assert code == jcode == 200
    body, jbody = json.loads(body), json.loads(jbody)
    assert sorted(body) == sorted(jbody)
    assert body["passing"] is True and body["failing"] == []
    assert sorted(body["specs"]["serve"]["windows"]) == ["fast", "slow"]


def test_an_engine_attaches_as_a_gate():
    ing = HttpIngress.__new__(HttpIngress)
    ing.attach_slo(prof.SLOEngine([prof.SLOSpec("s", latency_bound=1.0)],
                                  registry=MetricsRegistry()))
    assert isinstance(ing.slo, prof.SLOGate)


# ====================================== run spans, merging, crash bundles
@pytest.fixture()
def traced_both():
    """Tracing on in both packages with clean rings; restored after."""
    tracers = (prof.get_tracer(), jprof.get_tracer())
    for t in tracers:
        t.clear()
    prof.enable_tracing()
    jprof.enable_tracing()
    try:
        yield tracers
    finally:
        prof.disable_tracing()
        jprof.disable_tracing()
        for t in tracers:
            t.clear()


def test_run_span_stamps_ambient_spans(traced_both):
    shapes = []
    for p in (prof, jprof):
        with p.run_span("train:run", model="T") as ctx:
            with p.trace_span("train:step"):
                pass
        spans = p.spans_for_trace(ctx.trace_id)
        names = [s["name"] for s in spans]
        assert "train:run" in names and "train:step" in names
        root = next(s for s in spans if s["name"] == "train:run")
        assert root["args"]["run_id"] == ctx.trace_id
        assert root["args"]["model"] == "T"
        shapes.append(sorted((s["name"], sorted(s["args"]))
                             for s in spans))
    assert shapes[0] == shapes[1]


def test_merge_chrome_traces_equals_jax():
    meta = {"name": "thread_name", "ph": "M", "pid": 1, "tid": 2,
            "args": {"name": "w"}}
    meta2 = dict(meta, tid=3)
    ev = {"name": "x", "ph": "X", "pid": 1, "tid": 2, "ts": 0, "dur": 1,
          "args": {"trace_id": "ab" * 16}}
    docs = [{"traceEvents": [meta, ev]}, [dict(meta), dict(ev), meta2],
            {"traceEvents": []}]
    merged = prof.merge_chrome_traces(docs)
    assert merged == jprof.merge_chrome_traces(docs)
    metas = [e for e in merged["traceEvents"] if e.get("ph") == "M"]
    assert len(metas) == 2
    assert len(merged["traceEvents"]) == 4
    json.dumps(merged)    # Perfetto-loadable = valid JSON document


def _reset_recorders():
    from deeplearning4j_tpu.profiler import flightrec as jflightrec
    from deeplearning4j_tpu_torch.profiler import flightrec
    for rec in (flightrec.get_flight_recorder(),
                jflightrec.get_flight_recorder()):
        rec._last_dump = {}              # reset the rate limit


def _bundles(root):
    out = {}
    for b in sorted(root.glob("flightrec-*")):
        out[(b / "reason.txt").read_text().splitlines()[0]] = b
    return out


def test_fit_crash_dumps_a_bundle(tmp_path, monkeypatch):
    from deeplearning4j_tpu.train.resilience import fit_scope as jfit_scope
    from deeplearning4j_tpu_torch.train.resilience import fit_scope

    class Model:
        _epoch = 0

    for side, scope in (("torch", fit_scope), ("jax", jfit_scope)):
        d = tmp_path / side
        monkeypatch.setenv("DL4J_FLIGHTREC_DIR", str(d))
        _reset_recorders()
        with pytest.raises(RuntimeError, match="boom"):
            with scope(None, Model(), epochs=1):
                raise RuntimeError("boom")
        bundles = list(d.glob("flightrec-*"))
        assert len(bundles) == 1, f"{side}: {bundles}"
        reason = (bundles[0] / "reason.txt").read_text()
        assert "fit:RuntimeError" in reason and "boom" in reason
        assert bundles[0].name.endswith("-fit-RuntimeError")


def _crashing_net(kind, jax_side):
    if jax_side:
        from deeplearning4j_tpu.nn import NeuralNetConfiguration
        from deeplearning4j_tpu.nn import layers as L
        from deeplearning4j_tpu.nn.graph import ComputationGraph
        from deeplearning4j_tpu.nn.config import InputType as It
        from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as M
        from deeplearning4j_tpu.train import updaters as U
        init = {}
    else:
        from deeplearning4j_tpu_torch.nn import layers as L
        from deeplearning4j_tpu_torch.nn.config import InputType as It
        from deeplearning4j_tpu_torch.nn.config import \
            NeuralNetConfiguration
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        from deeplearning4j_tpu_torch.nn.multilayer import \
            MultiLayerNetwork as M
        from deeplearning4j_tpu_torch.train import updaters as U
        init = {"device": "cpu"}
    base = NeuralNetConfiguration.Builder().seed(3).updater(U.Sgd(0.1))
    if kind == "MultiLayerNetwork":
        conf = (base.list().layer(L.DenseLayer(nOut=5, activation="relu"))
                .layer(L.OutputLayer(nOut=NOUT, lossFunction="mcxent",
                                     activation="softmax"))
                .setInputType(It.feedForward(NIN)).build())
        return M(conf).init(**init)
    b = base.graphBuilder()
    b.addInputs("in").setInputTypes(It.feedForward(NIN))
    b.addLayer("d", L.DenseLayer(nOut=5, activation="relu"), "in")
    b.addLayer("out", L.OutputLayer(nOut=NOUT, lossFunction="mcxent",
                                    activation="softmax"), "d")
    b.setOutputs("out")
    return ComputationGraph(b.build()).init(**init)


@pytest.mark.parametrize("kind", ["MultiLayerNetwork", "ComputationGraph"])
def test_a_crashing_fit_dumps_one_bundle_with_its_run(tmp_path, monkeypatch,
                                                      traced_both, kind):
    """A real fit of either engine dies on a permanent data error at its
    third pull: one ``fit:OSError`` bundle, as the JAX fit leaves, whose
    trace holds the run's ``train:run`` span and the steps stamped with
    its run id."""
    from deeplearning4j_tpu import faults as jfaults
    from deeplearning4j_tpu.data import dataset as jds
    from deeplearning4j_tpu_torch.data import dataset as tds
    from deeplearning4j_tpu_torch.faults import FaultPlan
    rng = np.random.RandomState(0)
    x = rng.randn(16, NIN).astype(np.float32)
    y = np.eye(NOUT, dtype=np.float32)[rng.randint(0, NOUT, 16)]
    names = {}
    for side in ("torch", "jax"):
        jax_side = side == "jax"
        ds_mod = jds if jax_side else tds
        plan = (jfaults.FaultPlan if jax_side else FaultPlan)(
            data_error_at=[3], data_error_transient=False)
        it = ds_mod.ListDataSetIterator(ds_mod.DataSet(x, y), 4)
        net = _crashing_net(kind, jax_side)
        d = tmp_path / side
        monkeypatch.setenv("DL4J_FLIGHTREC_DIR", str(d))
        _reset_recorders()
        with pytest.raises(OSError, match="permanent data error"):
            net.fit(it, faults=plan)
        bundles = _bundles(d)
        assert list(bundles) == ["reason: fit:OSError"], bundles
        names[side] = list(bundles)
        if jax_side:
            continue
        trace = json.loads((bundles["reason: fit:OSError"]
                            / "trace.json").read_text())["traceEvents"]
        runs = [e for e in trace if e.get("name") == "train:run"]
        assert len(runs) == 1
        run_id = runs[0]["args"]["run_id"]
        assert runs[0]["args"]["trace_id"] == run_id
        assert runs[0]["args"]["model"] == kind
        steps = [e for e in trace if e.get("name") == "train:step"]
        assert len(steps) == 2
        assert all(e["args"]["trace_id"] == run_id for e in steps)
    assert names["torch"] == names["jax"]
