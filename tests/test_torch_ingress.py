"""The port's HttpIngress (CPU) against the JAX HttpIngress: the same
bodies go to both over loopback sockets. JSON and octet-stream requests
get equal predictions; statuses, JSON keys, ``Retry-After`` and the
returned ``traceparent`` are equal for every answer of the wire
taxonomy (200, 400, 404, 413, 415, 429, 503 draining and breaker, 504
deadline while queued); the GET surface answers with the reference's
keys. One subprocess serves a tiny forward through the port's ingress,
takes SIGTERM under load, drains and exits 0."""

import json
import os
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import warnings
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.parallel.mesh import DeviceMesh
from deeplearning4j_tpu.serving import HttpIngress as JaxIngress
from deeplearning4j_tpu.serving import ModelRegistry as JaxRegistry
from deeplearning4j_tpu.serving import ModelServer as JaxServer
from deeplearning4j_tpu_torch.serving import (DecodePreset, HttpIngress,
                                              ModelRegistry, ModelServer)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
NIN, NOUT = 4, 3
W = np.random.RandomState(0).randn(NIN, NOUT).astype(np.float32)
TRACE = "00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01"


def _fwd_j(x):
    return x @ jnp.asarray(W)


def _fwd_t(x):
    return x.float() @ torch.from_numpy(W)


def _mesh():
    return DeviceMesh.data_parallel(jax.devices()[:1])


SIDES = {
    "jax": (JaxServer, JaxRegistry, JaxIngress, _fwd_j,
            lambda: {"mesh": _mesh()}),
    "torch": (ModelServer, ModelRegistry, HttpIngress, _fwd_t,
              lambda: {"device": "cpu"}),
}


def _feats(rows, seed=0):
    return np.random.RandomState(seed).randn(rows, NIN).astype(np.float32)


def _post(url, path, body, headers=None, timeout=30.0):
    req = urllib.request.Request(f"{url}{path}", data=body,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _post_json(url, path, payload, headers=None, timeout=30.0):
    h = {"Content-Type": "application/json"}
    h.update(headers or {})
    return _post(url, path, json.dumps(payload).encode(), h, timeout)


def _get(url, path):
    try:
        with urllib.request.urlopen(f"{url}{path}", timeout=10) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _wire(answer):
    """What both ingresses must agree on for one answer."""
    code, payload, hdrs = answer
    return (code, sorted(payload), payload.get("type"),
            payload.get("retriable"), "Retry-After" in hdrs,
            "traceparent" in hdrs)


def _until(cond, timeout=10.0):
    end = time.monotonic() + timeout
    while not cond() and time.monotonic() < end:
        time.sleep(0.005)
    assert cond()


class _Gate:
    """A forward that blocks while the gate is shut (open at warmup)."""

    def __init__(self, fn):
        self.fn = fn
        self.open = threading.Event()
        self.open.set()
        self.entered = threading.Event()

    def __call__(self, x):
        self.entered.set()
        self.open.wait(30)
        return self.fn(x)


def _registry_answers(side):
    server_cls, reg_cls, ing_cls, fwd, kw = SIDES[side]
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        reg = reg_cls(batch_limit=4, coalesce_ms=0.5, **kw())
        reg.load("m", fwd, shapes=[(NIN,)])
        reg.load("m", fwd, shapes=[(NIN,)], head="argmax", roll=False)
    ing = ing_cls(reg, port=0, max_body_mb=0.001).start()
    try:
        url, path = ing.url, "/v1/models/m:predict"
        x = _feats(3, seed=1)
        out["json"] = _post_json(url, path, {"instances": x.tolist()},
                                 {"traceparent": TRACE})
        out["octet"] = _post(url, path, x.tobytes(), {
            "Content-Type": "application/octet-stream",
            "X-Tensor-Shape": "3,4", "X-Tensor-Dtype": "float32"})
        out["argmax"] = _post_json(url, path + "?version=2",
                                   {"instances": x.tolist()})
        out["malformed"] = _post(url, path, b"{not json",
                                 {"Content-Type": "application/json"})
        out["bad deadline"] = _post_json(url, path,
                                         {"instances": x.tolist()},
                                         {"deadline_ms": "-5"})
        out["unwarmed"] = _post_json(url, path,
                                     {"instances": _feats(1)[:, :3].tolist()})
        out["oversize batch"] = _post_json(url, path, {
            "instances": _feats(6).tolist()})
        out["tensor size"] = _post(url, path, b"\0" * 12, {
            "Content-Type": "application/octet-stream",
            "X-Tensor-Shape": "1,4"})
        out["unknown model"] = _post_json(url, "/v1/models/nope:predict",
                                          {"instances": x.tolist()})
        out["unknown version"] = _post_json(url, path + "?version=7",
                                            {"instances": x.tolist()})
        out["unknown endpoint"] = _get(url, "/v1/nothing")
        out["fleet"] = _get(url, "/v1/fleet/metrics")
        out["slo"] = _get(url, "/v1/slo")
        out["too large"] = _post_json(url, path, {
            "instances": _feats(4).tolist(), "pad": "x" * 2000})
        out["image"] = _post(url, path, b"\xff\xd8\xff\xe0" + b"\0" * 16,
                             {"Content-Type": "image/jpeg"})
        for p in ("/v1/models", "/v1/models/m", "/v1/load", "/healthz",
                  "/readyz"):
            out[p] = _get(url, p)
        status, text = 0, ""
        with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
            status, text = r.status, r.read().decode()
        out["metrics"] = (status, "dl4j_ingress_requests_total" in text)
    finally:
        ing.stop()
        reg.close()
    return out


@pytest.fixture(scope="module")
def answers():
    return {side: _registry_answers(side) for side in SIDES}


class TestWireParity:
    @pytest.mark.parametrize("case", [
        "json", "octet", "argmax", "malformed", "bad deadline", "unwarmed",
        "oversize batch", "tensor size", "unknown model", "unknown version",
        "unknown endpoint", "fleet", "slo", "too large", "image",
        "/v1/models", "/v1/models/m", "/v1/load", "/healthz", "/readyz"])
    def test_status_and_keys_equal(self, answers, case):
        j, t = answers["jax"][case], answers["torch"][case]
        assert _wire(t) == _wire(j)
        want = {"json": 200, "octet": 200, "argmax": 200, "malformed": 400,
                "bad deadline": 400, "unwarmed": 400, "oversize batch": 400,
                "tensor size": 400, "unknown model": 404,
                "unknown version": 404, "unknown endpoint": 404,
                "fleet": 404, "slo": 404, "too large": 413, "image": 415
                }.get(case, 200)
        assert t[0] == want

    def test_predictions_equal(self, answers):
        for case in ("json", "octet"):
            t, j = answers["torch"][case][1], answers["jax"][case][1]
            np.testing.assert_allclose(t["predictions"], j["predictions"],
                                       rtol=0, atol=1e-5)
            assert t["version"] == j["version"] == 1
        np.testing.assert_array_equal(answers["torch"]["octet"][1][
            "predictions"], answers["torch"]["json"][1]["predictions"])
        t, j = answers["torch"]["argmax"][1], answers["jax"]["argmax"][1]
        assert t["predictions"] == j["predictions"] and t["version"] == 2

    def test_traceparent_comes_back(self, answers):
        for side in SIDES:
            code, payload, hdrs = answers[side]["json"]
            incoming = TRACE.split("-")[1]
            assert payload["trace_id"] == incoming
            assert hdrs["traceparent"].split("-")[1] == incoming
            assert hdrs["traceparent"].split("-")[2] != TRACE.split("-")[2]

    def test_get_surface_keys(self, answers):
        for side in SIDES:
            a = answers[side]
            assert set(a["/v1/models"][1]["models"]["m"]) == {
                "active", "previous", "canary", "canary_fraction",
                "accepts_images", "versions"}
            assert set(a["/v1/load"][1]) == {"models", "totals"}
            assert a["/healthz"][1] == {"status": "ok"}
            assert a["/readyz"][1] == {"ready": True}
            assert a["metrics"] == (200, True)
        assert sorted(answers["torch"]["/v1/load"][1]["models"]["m"]) == \
            sorted(answers["jax"]["/v1/load"][1]["models"]["m"])


def _gated_answers(side):
    """429, 504 and both 503s from a single-slot server whose forward is
    held shut while the queue fills."""
    server_cls, _, ing_cls, fwd, kw = SIDES[side]
    out = {}
    gate = _Gate(fwd)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sv = server_cls(gate, batch_limit=1, max_queue=2, coalesce_ms=0.0,
                        **kw())
        sv.warmup([(NIN,)])
    ing = ing_cls(sv, port=0).start()
    path = "/v1/models/default:predict"
    try:
        def bg(seed, headers=None):
            res = []
            th = threading.Thread(target=lambda: res.append(_post_json(
                ing.url, path, {"instances": _feats(1, seed).tolist()},
                headers, timeout=60)))
            th.start()
            return th, res
        gate.open.clear()
        gate.entered.clear()
        first = [bg(0)]
        _until(gate.entered.is_set)
        first += [bg(1), bg(2)]
        _until(lambda: sv.queue_depth() == 2)
        out["overload"] = _post_json(ing.url, path,
                                     {"instances": _feats(1, 3).tolist()})
        gate.open.set()
        for th, _ in first:
            th.join(30)
        out["admitted"] = [res[0][0] for _, res in first]
        gate.open.clear()
        gate.entered.clear()
        blocker = bg(4)
        _until(gate.entered.is_set)
        late = bg(5, {"deadline_ms": "30"})
        _until(lambda: sv.queue_depth() == 1)
        time.sleep(0.1)
        gate.open.set()
        for th, _ in (blocker, late):
            th.join(30)
        out["deadline"] = late[1][0]
        out["blocker"] = blocker[1][0][0]
        sv.drain()
        out["draining"] = _post_json(ing.url, path,
                                     {"instances": _feats(1).tolist()})
        out["readyz draining"] = _get(ing.url, "/readyz")
    finally:
        ing.stop()
        sv.close()

    class Failing:
        arm = False

    def failing(x):
        if Failing.arm:
            raise RuntimeError("injected dispatch failure")
        return fwd(x)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sv = server_cls(failing, batch_limit=2, coalesce_ms=0.0,
                        breaker_threshold=1, breaker_cooldown=30.0,
                        max_retries=0, **kw())
        sv.warmup([(NIN,)])
        ing = ing_cls(sv, port=0).start()
        try:
            Failing.arm = True
            out["failed"] = _post_json(ing.url, path,
                                       {"instances": _feats(1).tolist()})
            _until(lambda: sv.breaker.state == "open")
            out["breaker"] = _post_json(ing.url, path,
                                        {"instances": _feats(1).tolist()})
            out["healthz open"] = _get(ing.url, "/healthz")
        finally:
            ing.stop()
            sv.close()
    return out


@pytest.fixture(scope="module")
def gated():
    return {side: _gated_answers(side) for side in SIDES}


class TestWireTaxonomy:
    @pytest.mark.parametrize("case,code", [
        ("overload", 429), ("deadline", 504), ("draining", 503),
        ("readyz draining", 503), ("failed", 500), ("breaker", 503),
        ("healthz open", 503)])
    def test_status_keys_and_retry_after_equal(self, gated, case, code):
        j, t = gated["jax"][case], gated["torch"][case]
        assert _wire(t) == _wire(j)
        assert t[0] == code

    def test_retriable_errors_carry_retry_after(self, gated):
        for side in SIDES:
            g = gated[side]
            assert g["admitted"] == [200, 200, 200] and g["blocker"] == 200
            for case in ("overload", "draining", "breaker"):
                code, payload, hdrs = g[case]
                assert payload["retriable"] is True
                assert float(hdrs["Retry-After"]) > 0
            code, payload, hdrs = g["deadline"]
            assert payload["type"] == "DeadlineExceededError"
            assert payload["retriable"] is False
            assert payload["latency_ms"] >= 30.0
            assert "Retry-After" not in hdrs
            assert 0 < float(g["breaker"][2]["Retry-After"]) <= 30.0


class TestPortOnly:
    def test_decode_preset_scales_a_png(self):
        pil = pytest.importorskip("PIL.Image")
        import io
        buf = io.BytesIO()
        pil.fromarray(np.full((6, 5, 3), 200, np.uint8)).save(buf, "PNG")
        x = DecodePreset(4, 4, scale=1 / 255.0).decode(buf.getvalue())
        assert x.shape == (1, 3, 4, 4) and x.dtype == np.float32
        np.testing.assert_allclose(x, 200 / 255.0, rtol=1e-6)

    def test_http_replay_stops_when_its_event_is_set(self):
        """A long schedule ends at ``stop``: the sent prefix comes back,
        every request of it answered 200, and nothing after it is sent."""
        from deeplearning4j_tpu_torch.faults import ServingLoad
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            reg = ModelRegistry(batch_limit=4, device="cpu")
            reg.load("m", _fwd_t, shapes=[(NIN,)])
        ing = HttpIngress(reg, port=0).start()
        try:
            load = ServingLoad.seeded(seed=3, mix="steady", n=2000, rps=100,
                                      max_rows=2)
            stop = threading.Event()
            threading.Timer(0.5, stop.set).start()
            t0 = time.perf_counter()
            res = load.replay_http(ing.url, "m", (NIN,), stop=stop)
            took = time.perf_counter() - t0
        finally:
            ing.stop()
            reg.close()
        assert 0 < len(res) < len(load) and took < 0.5 * load.duration()
        assert t0 <= load.replay_started <= t0 + took
        assert [spec for spec, _ in res] == load.specs[:len(res)]
        assert all(out[0] == 200 for _, out in res)
        assert all(w is None for w in load.wire_seconds[len(res):])

    def test_entry_points_need_a_card_or_the_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            HttpIngress(ModelRegistry(batch_limit=2))

    def test_sigterm_through_the_ingress_exits_zero(self, tmp_path):
        """A real process serving HTTP takes SIGTERM under load: queued
        requests fail as retriable 503, in-flight work completes, exit
        code 0."""
        script = tmp_path / "ingress_sigterm.py"
        script.write_text(
            "import json, os, threading, time, urllib.error\n"
            "import urllib.request\n"
            "import numpy as np\n"
            "import torch\n"
            "from deeplearning4j_tpu_torch.serving import (HttpIngress,\n"
            "    ModelServer)\n"
            "torch.set_num_threads(1)\n"
            "def slow(x):\n"
            "    time.sleep(0.1)\n"
            "    return x.float() * 2.0\n"
            "sv = ModelServer(slow, device='cpu', batch_limit=1,\n"
            "                 max_queue=64, coalesce_ms=0.0, preemption=True)\n"
            "sv.warmup([(4,)])\n"
            "ing = HttpIngress(sv, port=0).start()\n"
            "body = json.dumps({'instances': [[0.0, 0.0, 0.0, 0.0]]})"
            ".encode()\n"
            "results = []\n"
            "def one():\n"
            "    req = urllib.request.Request(\n"
            "        ing.url + '/v1/models/default:predict', data=body,\n"
            "        headers={'Content-Type': 'application/json'})\n"
            "    try:\n"
            "        with urllib.request.urlopen(req, timeout=60) as r:\n"
            "            results.append((r.status, json.loads(r.read())))\n"
            "    except urllib.error.HTTPError as e:\n"
            "        results.append((e.code, json.loads(e.read())))\n"
            "threads = [threading.Thread(target=one) for _ in range(16)]\n"
            "for t in threads:\n"
            "    t.start()\n"
            "end = time.monotonic() + 60\n"
            "while (sv.stats()['batches'] < 1 or sv.queue_depth() < 2)\\\n"
            "        and time.monotonic() < end:\n"
            "    time.sleep(0.01)  # until some dispatched, more queued\n"
            "os.kill(os.getpid(), 15)  # SIGTERM mid-load\n"
            "for t in threads:\n"
            "    t.join(90)\n"
            "codes = [c for c, _ in results]\n"
            "assert len(codes) == 16, codes\n"
            "ok = codes.count(200)\n"
            "drained = [p for c, p in results if c == 503]\n"
            "assert ok >= 1, codes\n"
            "assert drained, codes\n"
            "assert all(p['type'] == 'ServerDrainingError'\n"
            "           and p['retriable'] is True for p in drained)\n"
            "assert ok + len(drained) == 16, codes\n"
            "sv.close()\n"
            "ing.stop()\n"
            "print('DRAINED', ok, len(drained), flush=True)\n")
        env = dict(os.environ, PYTHONPATH=str(ROOT))
        r = subprocess.run([sys.executable, str(script)], env=env,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        assert "DRAINED" in r.stdout
