"""The port's training observability against the JAX package's on the
CPU: ``StatsListener`` (the same record keys, and values within 1e-5 on
a transplanted LeNet after one step), ``ui.stats`` storage (the same
behavior), ``ui.server.UIServer`` (the same JSON shapes from its
endpoints), ``ProfilingListener`` (a Chrome trace that parses as JSON,
with the per-layer scopes of an eager step in it) and the NAN_PANIC gate
of the fit loop, set through the mode or the environment.

Every test that sets a mode resets it in a fixture.
"""

import glob
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from deeplearning4j_tpu import profiler as jprof
from deeplearning4j_tpu import ui as jui
from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.train import listeners as jlst
from deeplearning4j_tpu_torch import profiler as prof
from deeplearning4j_tpu_torch import ui
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.train import listeners as lst
from deeplearning4j_tpu_torch.train.resilience import NumericsPanicError
from deeplearning4j_tpu_torch.utils.environment import Environment

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _reset_modes():
    yield
    os.environ.pop("DL4J_TPU_NAN_PANIC", None)
    Environment.reset()
    prof.set_profiling_mode(None)
    jprof.set_profiling_mode(None)


def _data(seed=0, n=8):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 16 * 16).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)]
    return x, y


def _pair():
    """A JAX LeNet and its port twin on the transplanted weights."""
    j = jzoo.LeNet(num_classes=3, input_shape=(1, 16, 16)).init()
    p = _port_net().params_from_jax(j._params, j._states, device="cpu")
    return j, p


def _port_net():
    return zoo.LeNet(num_classes=3, input_shape=(1, 16, 16)).init(
        device="cpu")


# ------------------------------------------------------------- StatsListener
@pytest.mark.parametrize("hist", [False, True])
def test_stats_records_match_after_one_step(hist):
    j, p = _pair()
    x, y = _data()
    js, ps = jui.InMemoryStatsStorage(), ui.InMemoryStatsStorage()
    j.setListeners(jlst.StatsListener(js, session_id="s",
                                      with_histograms=hist, hist_bins=10))
    p.setListeners(lst.StatsListener(ps, session_id="s",
                                     with_histograms=hist, hist_bins=10))
    j.fit(JDataSet(x, y))
    p.fit(DataSet(x, y))
    ju, pu = js.getLatestUpdate("s"), ps.getLatestUpdate("s")
    assert set(pu) == set(ju)
    assert set(pu["layers"]) == set(ju["layers"])
    assert pu["iteration"] == ju["iteration"] == 1
    assert pu["minibatch_size"] == ju["minibatch_size"] == 8
    assert pu["score"] == pytest.approx(ju["score"], rel=1e-5)
    for leaf, jrec in ju["layers"].items():
        prec = pu["layers"][leaf]
        assert set(prec) == set(jrec), leaf
        for k in ("param_mean", "param_std", "param_norm"):
            assert prec[k] == pytest.approx(jrec[k], rel=1e-5, abs=1e-7), \
                (leaf, k)
        for k in ("update_norm", "update_ratio"):
            # an Adam step of lr over rounding-level gradient differences
            assert prec[k] == pytest.approx(jrec[k], rel=1e-4, abs=1e-7), \
                (leaf, k)
        if hist:
            assert prec["hist_range"] == pytest.approx(jrec["hist_range"],
                                                       rel=1e-5, abs=1e-7)
            assert sum(prec["hist_counts"]) == sum(jrec["hist_counts"])
            assert np.abs(np.subtract(prec["hist_counts"],
                                      jrec["hist_counts"])).sum() <= 2
    jst, pst = js.getStaticInfo("s"), ps.getStaticInfo("s")
    assert set(pst) == set(jst)
    assert pst["n_parameters"] == jst["n_parameters"]
    assert pst["model_class"] == jst["model_class"]


def test_stats_frequency_sampling():
    x, y = _data()
    net = _port_net()
    st = ui.InMemoryStatsStorage()
    net.setListeners(lst.StatsListener(st, frequency=2, session_id="t2"))
    for _ in range(4):
        net.fit(DataSet(x, y))
    assert [u["iteration"] for u in st.getAllUpdates("t2")] == [2, 4]


def test_stats_under_k_steps_a_dispatch():
    """The hooks run after the dispatch, as in the JAX package: every
    sampled iteration is recorded, each seeing end-of-dispatch params."""
    x, y = _data(n=32)
    net = _port_net()
    st = ui.InMemoryStatsStorage()
    net.setListeners(lst.StatsListener(st, session_id="k"))
    from deeplearning4j_tpu_torch.data.dataset import ListDataSetIterator
    net.fit(ListDataSetIterator(DataSet(x, y), 8), steps_per_dispatch=2,
            prefetch=0)
    ups = st.getAllUpdates("k")
    assert [u["iteration"] for u in ups] == [1, 2, 3, 4]
    assert all(np.isfinite(u["score"]) for u in ups)


def test_stats_on_a_computation_graph():
    g = zoo.SqueezeNet(num_classes=3, input_shape=(3, 32, 32)).init(
        device="cpu")
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 32, 32).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 2)]
    st = ui.InMemoryStatsStorage()
    g.setListeners(lst.StatsListener(st, session_id="g1"))
    g.fit(DataSet(x, y))
    u = st.getLatestUpdate("g1")
    assert u is not None and u["layers"]
    assert any(r["update_norm"] > 0 for r in u["layers"].values())


# ---------------------------------------------------------------- storage
@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_storage_behaves_the_same(pkg, tmp_path):
    U = jui if pkg == "jax" else ui
    st = U.InMemoryStatsStorage()
    events = []
    st.registerStatsStorageListener(lambda e: events.append(e.kind))
    st.putStaticInfo({"session_id": "a", "model_class": "X"})
    st.putUpdate({"session_id": "a", "iteration": 1, "score": 1.0})
    st.putUpdate({"session_id": "a", "iteration": 2, "score": 0.5})
    assert st.listSessionIDs() == ["a"]
    assert st.getStaticInfo("a")["model_class"] == "X"
    assert [u["iteration"] for u in st.getAllUpdates("a")] == [1, 2]
    assert st.getLatestUpdate("a")["score"] == 0.5
    assert st.getAllUpdatesAfter("a", 1)[0]["iteration"] == 2
    assert "new_session" in events and "update" in events
    p = str(tmp_path / "stats.jsonl")
    fs = U.FileStatsStorage(p)
    fs.putStaticInfo({"session_id": "s1", "n_parameters": 7})
    fs.putUpdate({"session_id": "s1", "iteration": 3, "score": 0.1})
    fs.close()
    fs2 = U.FileStatsStorage(p)
    assert fs2.listSessionIDs() == ["s1"]
    assert fs2.getStaticInfo("s1")["n_parameters"] == 7
    assert fs2.getLatestUpdate("s1")["iteration"] == 3
    fs2.close()
    a, b = U.InMemoryStatsStorage(), U.InMemoryStatsStorage()
    U.StatsStorageRouter(a, b).putUpdate({"session_id": "x", "iteration": 1})
    assert a.getAllUpdates("x") and b.getAllUpdates("x")


def test_a_file_written_by_one_package_reads_in_the_other(tmp_path):
    p = str(tmp_path / "stats.jsonl")
    fs = jui.FileStatsStorage(p)
    fs.putStaticInfo({"session_id": "j", "n_parameters": 3})
    fs.putUpdate({"session_id": "j", "iteration": 5, "score": 0.25})
    fs.close()
    back = ui.FileStatsStorage(p)
    assert back.getLatestUpdate("j") == jui.FileStatsStorage(
        p).getLatestUpdate("j")
    back.close()


# --------------------------------------------------------------- UIServer
def _shape(v):
    """A JSON value's shape: dict keys (recursively), list of the first
    element's shape, the type of a scalar."""
    if isinstance(v, dict):
        return {k: _shape(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_shape(v[0])] if v else []
    return "num" if isinstance(v, (int, float)) and not isinstance(
        v, bool) else type(v).__name__


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _ui_answers(pkg):
    j, p = _pair()
    x, y = _data()
    U, L, net, DS = (jui, jlst, j, JDataSet) if pkg == "jax" \
        else (ui, lst, p, DataSet)
    st = U.InMemoryStatsStorage()
    net.setListeners(L.StatsListener(st, session_id="ui1",
                                     with_histograms=True, hist_bins=12))
    net.fit(DS(x, y))
    net.fit(DS(x, y))
    server = U.UIServer(port=0)
    out = {}
    try:
        out["no storage"] = _get(server.attach_serving(None).url
                                 + "api/sessions")
        server.attach(st)
        for path in ("api/sessions", "api/static?session=ui1",
                     "api/overview?session=ui1", "api/model?session=ui1",
                     "api/histograms?session=ui1", "healthz", "readyz",
                     "trace", "nothing"):
            out[path] = _get(server.url + path)
        out["page"] = _get(server.url)
        out["metrics"] = _get(server.url + "metrics")
    finally:
        server.stop()
    return out


@pytest.fixture(scope="module")
def ui_answers():
    return {pkg: _ui_answers(pkg) for pkg in ("jax", "port")}


@pytest.mark.parametrize("path", [
    "no storage", "api/sessions", "api/static?session=ui1",
    "api/overview?session=ui1", "api/model?session=ui1",
    "api/histograms?session=ui1", "healthz", "readyz", "nothing"])
def test_ui_endpoints_answer_the_same_json_shapes(ui_answers, path):
    (jc, jb), (pc, pb) = ui_answers["jax"][path], ui_answers["port"][path]
    assert pc == jc
    assert _shape(json.loads(pb)) == _shape(json.loads(jb))


def test_ui_page_trace_and_metrics(ui_answers):
    code, page = ui_answers["port"]["page"]
    assert code == 200 and "Score vs iteration" in page
    code, trace = ui_answers["port"]["trace"]
    assert code == 200 and "traceEvents" in json.loads(trace)
    code, text = ui_answers["port"]["metrics"]
    assert code == 200 and "# TYPE" in text


# ------------------------------------------------------- ProfilingListener
def test_profiling_listener_writes_a_chrome_trace(tmp_path):
    x, y = _data()
    net = _port_net()
    d = str(tmp_path / "trace")
    pl = lst.ProfilingListener(d, start_iter=2, n_iters=2)
    net.setListeners(pl)
    for _ in range(4):
        net.fit(DataSet(x, y))
    assert pl.trace_path and os.path.isfile(pl.trace_path)
    assert glob.glob(os.path.join(d, "*.json")) == [pl.trace_path]
    with open(pl.trace_path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    # the eager steps' layers ran inside their devicetime scopes
    assert any(n.startswith("dl4j_L0_") for n in names)
    from deeplearning4j_tpu_torch.profiler import devicetime
    assert devicetime.recorder() is None       # scopes off after the window


def test_profiling_listener_default_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("DL4J_TPU_PROFILE_DIR", str(tmp_path / "p"))
    Environment.reset()                        # re-read the environment
    assert lst.ProfilingListener().log_dir == str(tmp_path / "p")
    monkeypatch.delenv("DL4J_TPU_PROFILE_DIR")
    Environment.reset()
    assert lst.ProfilingListener().log_dir.endswith("dl4j_tpu_profile")


# -------------------------------------------------------------- panic gate
def _nan_batch():
    x, y = _data()
    return DataSet(np.full_like(x, np.nan), y)


def test_nan_panic_through_the_environment():
    os.environ["DL4J_TPU_NAN_PANIC"] = "1"
    Environment.reset()                        # re-read the environment
    prof.set_profiling_mode(None)
    with pytest.raises(NumericsPanicError, match="NAN_PANIC"):
        _port_net().fit(_nan_batch())


def test_no_panic_when_disabled():
    net = _port_net()
    net.fit(_nan_batch())
    assert np.isnan(net.score())


def test_unified_mode_panics_the_fit_loop():
    prof.set_profiling_mode(prof.ProfilingMode.NAN_PANIC)
    with pytest.raises(NumericsPanicError, match="NAN_PANIC"):
        _port_net().fit(_nan_batch())
