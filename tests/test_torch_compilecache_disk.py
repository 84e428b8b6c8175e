"""The compile cache's disk tier in the port (CPU).

Twins of the JAX package's ``tests/test_compilecache.py`` classes
``TestDiskStore``, ``TestResumeWarmup``, ``TestCrossProcess`` (one child
interpreter a run), ``TestConcurrentWriters`` and ``TestW112``. Those JAX
cases serialize XLA executables, which some jaxlib builds refuse, so each
twin holds the port to the JAX test's own assertions, not to a JAX run. The port persists a
warm-signature manifest where the JAX package persists serialized
executables (a CUDA graph cannot be serialized): a "disk hit" is a
signature the manifest named, captured at warm start (``warm`` seconds),
and a miss one it did not (``cold``). On the CPU a dispatch runs eagerly,
so the twins that count captures take the ``fake_capture`` stand-in
graph of ``test_torch_compilecache.py`` (the child interpreters install
the same stand-in).
"""

import json
import os
import subprocess
import sys
import threading
import warnings

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.nn import compilecache as cc
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.serving.server import ModelServer
from deeplearning4j_tpu_torch.train.updaters import Adam

from test_torch_compilecache import fake_capture  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean_cache_config():
    """Every test starts with the tier disabled and zeroed stats, and
    cannot leak its configuration into the rest of the suite."""
    cc.configure(None)
    cc.reset_stats()
    yield
    cc.reset_configuration()
    cc.reset_stats()


def _mlp_conf(seed=7, hidden=16):
    return (NeuralNetConfiguration.Builder().seed(seed).updater(Adam(0.01))
            .weightInit("xavier").list()
            .layer(DenseLayer(nOut=hidden, activation="relu"))
            .layer(OutputLayer(nOut=3, lossFunction="mcxent",
                               activation="softmax"))
            .setInputType(InputType.feedForward(8))
            .build())


def _net():
    return MultiLayerNetwork(_mlp_conf()).init(device="cpu")


def _data(n=16, seed=0):
    rng = np.random.RandomState(seed)
    return DataSet(rng.randn(n, 8).astype(np.float32),
                   np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)])


def _iterator(seed=0, n=48, batch=8):
    from deeplearning4j_tpu_torch.data.dataset import ListDataSetIterator
    return ListDataSetIterator(_data(n, seed), batch_size=batch)


# ------------------------------------------------------------- disk store
class TestDiskStore:
    # twin of TestDiskStore::test_roundtrip
    def test_roundtrip(self, tmp_path):
        store = cc.DiskCompileCache(str(tmp_path))
        key = cc.content_key("t", b"program-bytes", ("part",))
        assert store.get(key) is None
        store.put(key, b"payload", scope="t")
        assert store.get(key) == b"payload"
        assert store.entry_count() == 1

    # twin of TestDiskStore::test_corrupt_entry_quarantined
    def test_corrupt_entry_quarantined(self, tmp_path):
        store = cc.DiskCompileCache(str(tmp_path))
        key = cc.content_key("t", b"p", ())
        path = store.put(key, b"payload")
        with open(path, "r+b") as f:
            f.seek(-3, os.SEEK_END)
            f.write(b"zzz")
        with pytest.warns(UserWarning, match="quarantined corrupt"):
            assert store.get(key) is None
        assert not os.path.exists(path)
        quarantined = [n for n in os.listdir(tmp_path)
                       if n.startswith("quarantine_")]
        assert len(quarantined) == 1
        store.put(key, b"payload")
        assert store.get(key) == b"payload"

    # twin of TestDiskStore::test_truncated_entry_quarantined
    def test_truncated_entry_quarantined(self, tmp_path):
        store = cc.DiskCompileCache(str(tmp_path))
        key = cc.content_key("t", b"p2", ())
        path = store.put(key, b"payload-bytes")
        with open(path, "wb") as f:
            f.write(b"DL4")
        with pytest.warns(UserWarning, match="quarantined"):
            assert store.get(key) is None

    # twin of TestDiskStore::test_version_mismatch_ignored_and_rewritten
    def test_version_mismatch_ignored_and_rewritten(self, tmp_path):
        store = cc.DiskCompileCache(str(tmp_path))
        key = cc.content_key("t", b"p3", ())
        path = store.put(key, b"payload")
        with open(path, "rb") as f:
            f.readline()
            header = json.loads(f.readline().decode())
            payload = f.read()
        header["runtime"] = ("torch=0.0.1;cuda=None;device=cpu;cc=-;"
                             "kernels=0")
        with open(path, "wb") as f:
            f.write(b"DL4JCC1\n")
            f.write(json.dumps(header).encode() + b"\n")
            f.write(payload)
        assert store.get(key) is None
        assert os.path.exists(path)
        store.put(key, b"payload")
        assert store.get(key) == b"payload"

    # twin of TestDiskStore::test_eviction_lru
    def test_eviction_lru(self, tmp_path):
        store = cc.DiskCompileCache(str(tmp_path), max_entries=3)
        keys = [cc.content_key("t", f"p{i}".encode(), ()) for i in range(5)]
        for i, k in enumerate(keys):
            store.put(k, b"x")
            os.utime(store._path(k), (1000 + i, 1000 + i))
        store.put(keys[0], b"x")
        assert store.entry_count() == 3

    # twin of TestDiskStore::test_eviction_grace_window
    def test_eviction_grace_window(self, tmp_path):
        store = cc.DiskCompileCache(str(tmp_path), max_entries=2)
        keys = [cc.content_key("t", f"g{i}".encode(), ()) for i in range(4)]
        for k in keys:
            store.put(k, b"x")
        assert store.entry_count() == 4
        for k in keys[:2]:
            os.utime(store._path(k), (1000, 1000))
        store._evict()
        assert store.entry_count() == 2
        assert store.get(keys[3]) == b"x"
        assert store.get(keys[2]) == b"x"
        assert store.get(keys[0]) is None

    # twin of TestDiskStore::test_eviction_survives_vanishing_entry
    def test_eviction_survives_vanishing_entry(self, tmp_path, monkeypatch):
        store = cc.DiskCompileCache(str(tmp_path), max_entries=1)
        keys = [cc.content_key("t", f"v{i}".encode(), ()) for i in range(3)]
        for k in keys:
            store.put(k, b"x")
        for i, k in enumerate(keys):
            os.utime(store._path(k), (1000 + i, 1000 + i))
        ghost = store._path(keys[1])
        real_getmtime = os.path.getmtime

        def getmtime(p):
            if p == ghost:
                raise OSError("vanished")
            return real_getmtime(p)
        monkeypatch.setattr(cc.os.path, "getmtime", getmtime)
        store._evict()
        monkeypatch.undo()
        assert store.entry_count() == 2
        assert store.get(keys[0]) is None

    # twin of TestDiskStore::test_eviction_survives_concurrent_remove
    def test_eviction_survives_concurrent_remove(self, tmp_path,
                                                 monkeypatch):
        store = cc.DiskCompileCache(str(tmp_path), max_entries=1)
        keys = [cc.content_key("t", f"r{i}".encode(), ()) for i in range(3)]
        for k in keys:
            store.put(k, b"x")
        for i, k in enumerate(keys):
            os.utime(store._path(k), (1000 + i, 1000 + i))
        real_remove = os.remove
        raced = []

        def remove(p):
            real_remove(p)
            if not raced:
                raced.append(p)
                raise OSError("already gone")
        monkeypatch.setattr(cc.os, "remove", remove)
        store._evict()
        monkeypatch.undo()
        assert raced
        assert store.entry_count() == 1
        assert store.get(keys[2]) == b"x"

    # twin of TestDiskStore::test_concurrent_put_same_key_atomic
    def test_concurrent_put_same_key_atomic(self, tmp_path):
        store = cc.DiskCompileCache(str(tmp_path))
        key = cc.content_key("t", b"race", ())
        payload = b"P" * 4096
        errors = []
        barrier = threading.Barrier(4)

        def writer():
            try:
                barrier.wait()
                for _ in range(20):
                    store.put(key, payload)
                    assert store.get(key) == payload
            except BaseException as e:          # noqa: B017
                errors.append(e)
        threads = [threading.Thread(target=writer) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        assert store.get(key) == payload

    # twin of TestDiskStore::test_cache_dir_status
    def test_cache_dir_status(self, tmp_path):
        assert cc.cache_dir_status() == (None, False)
        cc.configure(str(tmp_path))
        d, writable = cc.cache_dir_status()
        assert d == str(tmp_path) and writable
        blocker = tmp_path / "blocker"
        blocker.write_text("x")
        cc.configure(str(blocker / "sub"))
        d, writable = cc.cache_dir_status()
        assert not writable

    # twin of TestDiskStore::test_env_var_resolution
    def test_env_var_resolution(self, tmp_path, monkeypatch):
        cc.reset_configuration()
        monkeypatch.setenv(cc.ENV_DIR, str(tmp_path))
        assert cc.cache_dir() == str(tmp_path)
        cc.configure(None)
        assert cc.cache_dir() is None

    # port only: the runtime identity names torch, CUDA, the card and the
    # kernel sources; a kernel source change changes every key
    def test_runtime_fingerprint_names_the_kernels(self, monkeypatch):
        fp = cc.runtime_fingerprint()
        for part in ("torch=", "cuda=", "device=", "cc=", "kernels="):
            assert part in fp
        assert f"kernels={cc.kernel_sources_digest()}" in fp
        key = cc.content_key("s", b"x")
        monkeypatch.setattr(cc, "_RUNTIME_FP", fp + "-other")
        assert cc.content_key("s", b"x") != key


# ----------------------------------------------------------------- resume
class TestResumeWarmup:
    # twin of TestResumeWarmup::test_checkpoint_records_batch_signature
    def test_checkpoint_records_batch_signature(self, tmp_path):
        from deeplearning4j_tpu_torch.train.resilience import \
            CheckpointConfig
        net = _net()
        ck = str(tmp_path / "ck")
        net.fit([_data(), _data(16, 1)], epochs=1,
                checkpoint=CheckpointConfig(ck, every_steps=1))
        cps = sorted(d for d in os.listdir(ck) if d.startswith("ckpt_"))
        with open(os.path.join(ck, cps[-1], "extra.json")) as f:
            extra = json.load(f)
        sig = extra["extra"]["resilience"]["batch_signature"]
        assert sig["features"] == [[16, 8], "float32"]
        assert sig["labels"] == [[16, 3], "float32"]

    # twin of TestResumeWarmup::test_resume_warms_from_recorded_signature
    def test_resume_warms_from_recorded_signature(self, tmp_path,
                                                  fake_capture):
        from deeplearning4j_tpu_torch.train.resilience import \
            CheckpointConfig
        cc.configure(str(tmp_path / "cache"))
        ck = str(tmp_path / "ck")
        a = _net()
        a.fit([_data(), _data(16, 1)], epochs=1,
              checkpoint=CheckpointConfig(ck, every_steps=1))
        assert cc.cache_stats()["disk"]["misses"] == 1
        cc.reset_stats()
        b = _net()
        b.fit([_data(), _data(16, 1)], epochs=2,
              checkpoint=CheckpointConfig(ck, resume=True))
        s = cc.cache_stats()
        assert s["compile_seconds"]["cold_compiles"] == 0
        assert s["disk"]["hits"] >= 1 and s["disk"]["misses"] == 0
        # the resumed fit replayed what warm start captured
        assert s["memory"]["misses"] == 0 and s["memory"]["hits"] >= 1

    # twin of TestResumeWarmup::test_resume_warm_noop_without_cache
    def test_resume_warm_noop_without_cache(self, tmp_path):
        from deeplearning4j_tpu_torch.faults import FaultPlan
        from deeplearning4j_tpu_torch.train.resilience import \
            CheckpointConfig
        ck = str(tmp_path / "ck")
        full = _net()
        full.fit(_iterator(), epochs=1)
        part = _net()
        part.fit(_iterator(), epochs=1,
                 checkpoint=CheckpointConfig(ck, every_steps=1),
                 faults=FaultPlan(preempt_at_step=2))
        resumed = _net()
        resumed.fit(_iterator(), epochs=1,
                    checkpoint=CheckpointConfig(ck, resume=True))
        assert np.array_equal(np.asarray(full.params()),
                              np.asarray(resumed.params()))
        assert cc.cache_stats()["disk"] == {
            "enabled": False, "dir": None, "hits": 0, "misses": 0,
            "entries": 0}


# ---------------------------------------------------------- cross-process
_XPROC = r"""
import contextlib, json, sys, warnings
warnings.simplefilter("ignore")
import numpy as np
import torch
from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration, InputType
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn import compilecache as cc
from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.train.updaters import Adam
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.serving.server import ModelServer


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

cc.configure(sys.argv[1])
conf = (NeuralNetConfiguration.Builder().seed(7).updater(Adam(0.01))
        .weightInit("xavier").list()
        .layer(DenseLayer(nOut=16, activation="relu"))
        .layer(OutputLayer(nOut=3, lossFunction="mcxent",
                           activation="softmax"))
        .setInputType(InputType.feedForward(8)).build())
net = MultiLayerNetwork(conf).init(device="cpu")
rng = np.random.RandomState(0)
ds = DataSet(rng.randn(16, 8).astype(np.float32),
             np.eye(3, dtype=np.float32)[rng.randint(0, 3, 16)])
net.fit(ds, epochs=2)
sv = ModelServer(net, batch_limit=8, name="xproc", device="cpu")
sv.warmup([(8,)])
sv.close()
print("PARAMS0=%.9e" % float(np.asarray(net.params())[0]))
print(json.dumps(cc.cache_stats()))
"""


def _run_xproc(cache_dir):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("DL4J_TPU_COMPILE_CACHE_DIR", None)
    proc = subprocess.run([sys.executable, "-c", _XPROC, cache_dir],
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = proc.stdout.strip().splitlines()
    return lines[-2], json.loads(lines[-1])


class TestCrossProcess:
    # twin of TestCrossProcess::
    # test_second_process_zero_misses_and_no_cold_compiles
    def test_second_process_zero_misses_and_no_cold_compiles(self, tmp_path):
        d = str(tmp_path)
        p1, s1 = _run_xproc(d)
        assert s1["disk"]["misses"] >= 1
        assert s1["compile_seconds"]["cold"] > 0
        p2, s2 = _run_xproc(d)
        assert s2["disk"]["misses"] == 0
        assert s2["disk"]["hits"] >= 2            # train step + forward
        assert s2["compile_seconds"]["cold"] == 0.0
        # the port still pays each capture, before traffic: its seconds
        # are warm (the JAX pin's warm < cold compares deserialization
        # with compilation, which the port does not have)
        assert s2["compile_seconds"]["warm"] > 0
        assert s2["compile_seconds"]["warm_loads"] == s2["disk"]["hits"]
        assert p1 == p2                           # same math


# ------------------------------------------------------------------ races
class _Owner:
    """A model stand-in: a config that serializes (one fingerprint)."""

    class conf:
        @staticmethod
        def to_json():
            return '{"races": "onekey"}'


@pytest.mark.races
class TestConcurrentWriters:
    # twin of TestConcurrentWriters::test_many_threads_one_key
    def test_many_threads_one_key(self, tmp_path, fake_capture):
        cc.configure(str(tmp_path))
        errors = []
        barrier = threading.Barrier(6)
        owner = _Owner()

        def named(args):
            return owner, "train", {"batch": {
                "features": [list(args[0].shape), "float32"]}, "steps": 1}

        def work(i):
            try:
                d = cc.CachedDispatch(lambda x: x * 2 + 1, "races:onekey",
                                      manifest=named)
                barrier.wait()
                out = d(torch.full((4,), float(i)))
                assert float(out[0]) == 2.0 * i + 1
            except BaseException as e:              # noqa: B017
                errors.append(e)
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors
        disk = cc.disk_cache()
        assert disk.entry_count() == 1
        assert len(cc.read_manifest(owner)) == 1
        cc.reset_stats()
        cc.CachedDispatch(lambda x: x * 2 + 1, "races:onekey",
                          manifest=named).warm(torch.zeros((4,)))
        assert cc.cache_stats()["disk"]["hits"] == 1


# ------------------------------------------------------------------- W112
class TestW112:
    def _server(self):
        return ModelServer(_net(), batch_limit=8, name="w112", device="cpu")

    # twin of TestW112::test_warmup_without_cache_warns_w112
    def test_warmup_without_cache_warns_w112(self):
        sv = self._server()
        try:
            with pytest.warns(UserWarning, match="DL4J-W112"):
                sv.warmup([(8,)])
        finally:
            sv.close()

    # twin of TestW112::test_warmup_with_cache_no_w112
    def test_warmup_with_cache_no_w112(self, tmp_path):
        cc.configure(str(tmp_path))
        sv = self._server()
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                sv.warmup([(8,)])
            assert not any("W112" in str(w.message) for w in caught)
        finally:
            sv.close()

    # twin of TestW112::test_unwritable_dir_warns_w112
    def test_unwritable_dir_warns_w112(self, tmp_path):
        blocker = tmp_path / "blocker"
        blocker.write_text("x")
        cc.configure(str(blocker / "cache"))
        sv = self._server()
        try:
            with pytest.warns(UserWarning, match="writable"):
                sv.warmup([(8,)])
        finally:
            sv.close()

    # twin of TestW112::test_static_validate_stays_silent
    def test_static_validate_stays_silent(self):
        sv = self._server()
        try:
            assert "DL4J-W112" not in sv.validate().codes()
            assert "DL4J-W112" in sv.validate(check_cache=True).codes()
        finally:
            sv.close()

    # twin of TestW112::test_lint_compile_cache_direct
    def test_lint_compile_cache_direct(self, tmp_path):
        from deeplearning4j_tpu_torch.analysis import lint_compile_cache
        diags = lint_compile_cache()
        assert diags and diags[0].code == "DL4J-W112"
        cc.configure(str(tmp_path))
        assert lint_compile_cache() == []

    # twin of TestW112::test_w112_suppressible
    def test_w112_suppressible(self):
        sv = self._server()
        try:
            report = sv.validate(check_cache=True)
            assert "DL4J-W112" in report.codes()
            report2 = report.apply_config(suppress=["DL4J-W112"])
            assert "DL4J-W112" not in report2.codes()
        finally:
            sv.close()

    # twin of TestW112::test_w112_documented
    def test_w112_documented(self):
        from deeplearning4j_tpu_torch.analysis.diagnostics import \
            DIAGNOSTIC_CODES
        assert "DL4J-W112" in DIAGNOSTIC_CODES


# ---------------------------------------------------- the manifest itself
class TestManifest:
    # port only: a K-step capture writes (batch, K) and a fresh net's fit
    # warms it before its first batch; a quarantined manifest still fits
    def test_megastep_manifest_replays_and_survives_corruption(
            self, tmp_path, fake_capture):
        cc.configure(str(tmp_path))
        batches = [_data(seed=s) for s in range(4)]
        a = _net()
        a.fit(batches, steps_per_dispatch=2)
        entries = cc.read_manifest(a)
        assert entries == [{"batch": {"features": [[16, 8], "float32"],
                                      "labels": [[16, 3], "float32"]},
                            "steps": 2}]
        cc.reset_stats()
        b = _net()
        b.fit(batches, steps_per_dispatch=2)
        s = cc.cache_stats()
        assert s["disk"] == {"enabled": True, "dir": str(tmp_path),
                             "hits": 1, "misses": 0, "entries": 1}
        assert s["memory"]["misses"] == 0
        np.testing.assert_array_equal(np.asarray(a.params()),
                                      np.asarray(b.params()))
        # corrupt the manifest: quarantined, the fit captures cold and
        # rewrites it
        path = cc.disk_cache()._path(cc.manifest_key(a, "train"))
        with open(path, "r+b") as f:
            f.seek(-3, os.SEEK_END)
            f.write(b"zzz")
        cc.reset_stats()
        c = _net()
        with pytest.warns(UserWarning, match="quarantined"):
            c.fit(batches, steps_per_dispatch=2)
        s = cc.cache_stats()
        assert s["disk"]["hits"] == 0 and s["disk"]["misses"] == 1
        assert any(n.startswith("quarantine_") for n in os.listdir(tmp_path))
        assert cc.read_manifest(c) == entries
        np.testing.assert_array_equal(np.asarray(a.params()),
                                      np.asarray(c.params()))

    # port only: a fit per batch reads the manifest once; a later fit
    # serializes, hashes and reads nothing until a seam changes
    def test_a_fit_per_batch_replays_the_manifest_once(
            self, tmp_path, monkeypatch):
        cc.configure(str(tmp_path))
        reads, keys = [], []
        read, key = cc.read_manifest, cc.manifest_key
        monkeypatch.setattr(cc, "read_manifest",
                            lambda *a, **k: reads.append(1) or read(*a, **k))
        monkeypatch.setattr(cc, "manifest_key",
                            lambda *a, **k: keys.append(1) or key(*a, **k))
        net = _net()
        for s in range(4):
            net.fit(_data(seed=s))
        assert (len(reads), len(keys)) == (1, 1)
        net.setPrecisionPolicy("bf16")
        net.fit(_data())
        assert (len(reads), len(keys)) == (2, 2)

    # port only: layout, fusion and policy key the manifest
    def test_seams_key_the_manifest(self, tmp_path):
        cc.configure(str(tmp_path))
        net = _net()
        k0 = cc.manifest_key(net, "train")
        net.setPrecisionPolicy("bf16")
        assert cc.manifest_key(net, "train") != k0
        assert cc.manifest_key(_net(), "train") == k0
        assert cc.manifest_key(net, "serving:forward") != \
            cc.manifest_key(net, "train")


# ------------------------------------------- warmup(strict=, cost=) (9.2)
class TestStrictWarmup:
    def _sd_server(self):
        from deeplearning4j_tpu_torch.autodiff import SameDiff
        from deeplearning4j_tpu_torch.serving import samediff_forward
        rng = np.random.RandomState(0)
        sd = SameDiff.create(device="cpu")
        x = sd.placeHolder("x", shape=(None, 8))
        w = sd.var("w", rng.randn(8, 3).astype(np.float32))
        sd.nn.softmax(x @ w, name="probs")
        return ModelServer(samediff_forward(sd, ["probs"]), batch_limit=4,
                           name="strict", device="cpu")

    # the JAX ModelServer.warmup(strict=True, cost=...): E121 refuses to
    # warm, a chip that holds the ladder passes
    def test_strict_cost_warmup_passes_then_refuses_a_tiny_chip(
            self, tmp_path):
        from deeplearning4j_tpu_torch.analysis.diagnostics import \
            ModelValidationError
        cc.configure(str(tmp_path))
        sv = self._sd_server()
        try:
            sv.warmup([(8,)], strict=True, cost="h100-sxm")
            assert sv._warmed
            tiny = {"chip": {"name": "tiny", "peak_flops": 1e12,
                             "hbm_gb": 1e-9, "hbm_gbps": 1.0,
                             "ici_gbps": 1.0}}
            with pytest.raises(ModelValidationError, match="E121"):
                sv.warmup([(8,)], strict=True, cost=tiny)
            with pytest.warns(UserWarning, match="E121"):
                sv.warmup([(8,)], cost=tiny)
        finally:
            sv.close()

    # a served SameDiff graph is priced and linted as its graph
    def test_samediff_forward_carries_its_graph(self):
        sv = self._sd_server()
        try:
            assert sv.model._samediff is not None
            report = sv.validate(cost="h100-sxm")
            assert not report.errors()
        finally:
            sv.close()
