"""Captured dispatch (``nn/compilecache.py``): ``CachedDispatch``, the
warmup API and the captured steps of both networks and the transformer.

On the CPU a dispatch calls its function eagerly; the capture path is
exercised here with a stand-in for ``torch.cuda.CUDAGraph`` (``fake_capture``):
"capture" runs the function once under a snapshot of the state (as a real
capture executes nothing) and "replay" runs it again into the same
static outputs. That drives the real bookkeeping — signature keying,
statistics, static input buffers, the warm-up runs under ``preserved``,
the failure fallback — and the same checks run against real CUDA graphs
in the tests marked ``cuda`` (skipped without a card).

Exact equality everywhere: a captured step must replay the eager step's
arithmetic, and warming must leave every piece of state bit-equal.
"""

import contextlib
import threading
import warnings

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.nn import compilecache as cc
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.train.updaters import Adam

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _stats():
    cc.reset_stats()
    yield
    cc.reset_stats()


class _FakeGraph:
    def __init__(self, fn, args, out):
        self.fn, self.args, self.out = fn, args, out
        self.replays = 0

    def replay(self):
        self.replays += 1
        res = self.fn(*self.args)
        with torch.no_grad():
            if isinstance(res, torch.Tensor):
                self.out.copy_(res)
            else:
                for o, r in zip(self.out, res):
                    o.copy_(r)


@pytest.fixture()
def fake_capture(monkeypatch):
    """CPU tensors take the capture path, with _FakeGraph as the graph.
    Returns the list of the fake graphs captured."""
    made = []
    current_state = {}

    def record(fn, static):
        # a real capture executes nothing: run once under a snapshot
        with cc.preserved(current_state["fn"]()):
            out = fn(*static)
        g = _FakeGraph(fn, static, out)
        made.append(g)
        return g, out

    orig_acquire = cc.CachedDispatch._acquire

    def acquire(self, args, sig):
        current_state["fn"] = self.state
        return orig_acquire(self, args, sig)

    monkeypatch.setattr(cc, "_on_card", lambda args: any(
        isinstance(a, torch.Tensor) for a in args))
    monkeypatch.setattr(cc, "_side_stream",
                        lambda args: contextlib.nullcontext())
    monkeypatch.setattr(cc, "_record", record)
    monkeypatch.setattr(cc.CachedDispatch, "_acquire", acquire)
    return made


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return "cuda"


def _mlp_conf(seed=7):
    return (NeuralNetConfiguration.Builder().seed(seed).updater(Adam(0.01))
            .list()
            .layer(L.DenseLayer(nOut=16, activation="relu"))
            .layer(L.OutputLayer(nOut=3, lossFunction="mcxent",
                                 activation="softmax"))
            .setInputType(InputType.feedForward(8)).build())


def _cnn_conf(seed=3):
    return (NeuralNetConfiguration.Builder().seed(seed).weightInit("relu")
            .updater(Adam(1e-2)).list()
            .layer(L.ConvolutionLayer(kernelSize=(3, 3), padding=(1, 1),
                                      nOut=6, activation="identity"))
            .layer(L.BatchNormalization())
            .layer(L.ActivationLayer("relu"))
            .layer(L.GlobalPoolingLayer("avg"))
            .layer(L.OutputLayer(nOut=3, lossFunction="mcxent",
                                 activation="softmax"))
            .setInputType(InputType.convolutional(8, 8, 2)).build())


def _graph_conf(seed=7):
    return (NeuralNetConfiguration.Builder().seed(seed).updater(Adam(0.01))
            .graphBuilder().addInputs("in")
            .setInputTypes(InputType.feedForward(8))
            .addLayer("fc", L.DenseLayer(nOut=16, activation="relu"), "in")
            .addLayer("out", L.OutputLayer(nOut=3, lossFunction="mcxent",
                                           activation="softmax"), "fc")
            .setOutputs("out").build())


def _data(n=16, seed=0, nin=8):
    rng = np.random.RandomState(seed)
    return DataSet(rng.randn(n, nin).astype(np.float32),
                   np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)])


def _images(n=4, seed=0):
    rng = np.random.RandomState(seed)
    return DataSet(rng.randn(n, 2, 8, 8).astype(np.float32),
                   np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)])


def _snapshot(net):
    return [t.detach().clone() for t in net._dispatch_state()]


def _assert_state_equal(net, snap):
    now = net._dispatch_state()
    assert len(now) == len(snap)
    for a, b in zip(now, snap):
        assert torch.equal(a, b)


# ------------------------------------------------------------ the dispatch
class TestCachedDispatch:
    def test_cpu_calls_eagerly(self):
        calls = []

        def f(x):
            calls.append(1)
            return x * 2
        for always in (False, True):
            d = cc.CachedDispatch(f, "test:cpu", always_capture=always)
            assert float(d(torch.ones(4))[0]) == 2.0
            d.warm(torch.ones(4))
            assert d.warmed_signatures() == 0
        assert len(calls) == 2
        assert cc.cache_stats() == {
            "memory": {"hits": 0, "misses": 0},
            "disk": {"enabled": False, "dir": None, "hits": 0,
                     "misses": 0, "entries": 0},
            "compile_seconds": {"cold": 0.0, "warm": 0.0,
                                "cold_compiles": 0, "warm_loads": 0,
                                "warmup": 0.0, "enter": 0.0,
                                "capture": 0.0},
            "capture_failures": 0, "eager_by_design": 0}

    def test_cpu_dispatch_equals_eager_and_keeps_its_state(self):
        """On the CPU a dispatch, whatever its options, is the eager
        function: the same outputs and the same writes to its state,
        with nothing captured and no stream touched."""
        def step(state, x):
            state.mul_(0.5).add_(x)
            return state.sum() * x

        x = torch.arange(6, dtype=torch.float32)
        for always in (False, True):
            s_eager = torch.ones(6)
            s_disp = torch.ones(6)
            d = cc.CachedDispatch(lambda a: step(s_disp, a), "test:cpu_eq",
                                  state=lambda: [s_disp],
                                  always_capture=always)
            d.warm(x)
            assert torch.equal(s_disp, s_eager)
            for _ in range(3):
                assert torch.equal(d(x), step(s_eager, x))
                assert torch.equal(s_disp, s_eager)
            assert d.captures() == 0
        with cc._side_stream((x,)):
            pass
        assert cc.cache_stats()["compile_seconds"]["cold_compiles"] == 0

    def test_signature_keying_and_stats(self, fake_capture):
        d = cc.CachedDispatch(lambda x, s: x * s, "test:keys",
                              always_capture=True)
        a = torch.ones(4)
        d(a, 2.0)
        d(a + 1, 2.0)                         # same signature: a hit
        d(torch.ones(5), 2.0)                 # shape
        d(torch.ones(4, dtype=torch.float64), 2.0)   # dtype
        out = d(a, 3.0)                       # a Python value is baked in
        assert torch.equal(out, a * 3.0)
        st = cc.cache_stats()
        assert st["memory"] == {"hits": 1, "misses": 4}
        assert st["compile_seconds"]["cold_compiles"] == 4
        assert st["capture_failures"] == 0
        assert d.warmed_signatures() == 4

    def test_eager_until_warmed(self, fake_capture):
        d = cc.CachedDispatch(lambda x: x + 1, "test:lazy")
        d(torch.ones(3))
        assert cc.cache_stats()["memory"] == {"hits": 0, "misses": 0}
        d.warm(torch.zeros(3))
        assert cc.cache_stats()["compile_seconds"]["cold_compiles"] == 1
        assert torch.equal(d(torch.ones(3)), torch.full((3,), 2.0))
        assert cc.cache_stats()["memory"]["hits"] == 1
        d(torch.ones(2))                      # engaged: a new one captures
        assert cc.cache_stats()["compile_seconds"]["cold_compiles"] == 2

    def test_outputs_are_copies(self, fake_capture):
        d = cc.CachedDispatch(lambda x: x * 2, "test:out",
                              always_capture=True)
        first = d(torch.ones(2))
        d(torch.full((2,), 5.0))
        assert torch.equal(first, torch.full((2,), 2.0))

    def test_failed_capture_warns_once_and_runs_eagerly(self, fake_capture,
                                                       monkeypatch):
        def boom(fn, static):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        monkeypatch.setattr(cc, "_record", boom)
        d = cc.CachedDispatch(lambda x: x - 1, "test:fail",
                              always_capture=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            assert torch.equal(d(torch.ones(2)), torch.zeros(2))
            assert torch.equal(d(torch.ones(2)), torch.zeros(2))
            d(torch.ones(3))
        assert sum("capture" in str(w.message) for w in caught) == 1
        st = cc.cache_stats()
        assert st["capture_failures"] == 2
        assert st["memory"]["misses"] == 2
        assert d.warmed_signatures() == 0

    def test_warm_up_runs_leave_the_state(self, fake_capture):
        t = torch.zeros((), dtype=torch.int32)
        acc = torch.zeros(3)

        def step(x):
            acc.add_(x)
            t.add_(1)
            return acc.sum()
        d = cc.CachedDispatch(step, "test:state", state=lambda: [acc, t],
                              always_capture=True)
        d.warm(torch.ones(3))
        assert int(t) == 0 and not acc.any()
        for i in range(3):
            assert float(d(torch.ones(3))) == 3.0 * (i + 1)
        assert int(t) == 3
        assert fake_capture[0].replays == 3


    def test_captures_count_and_no_pool_on_the_cpu(self, fake_capture):
        d = cc.CachedDispatch(lambda x: x + 1, "test:pool",
                              always_capture=True)
        assert d._capture_options((torch.ones(2),)) == {}
        d(torch.ones(2))
        d(torch.ones(3))
        assert torch.equal(d(torch.ones(3)), torch.full((3,), 2.0))
        assert d.captures() == d.warmed_signatures() == len(fake_capture) == 2
        assert d._pool is None and d._stream is None
        assert not cc._capturing((torch.ones(2),))


# ------------------------------------------------------- the networks' step
class TestCapturedNetworks:
    @pytest.mark.parametrize("make", ["mlp", "graph", "cnn"])
    def test_three_replays_equal_three_eager_megasteps(self, fake_capture,
                                                       make):
        conf, data = {"mlp": (_mlp_conf, _data), "graph": (_graph_conf, _data),
                      "cnn": (_cnn_conf, _images)}[make]
        cls = ComputationGraph if make == "graph" else MultiLayerNetwork
        batches = [data(seed=i) for i in range(6)]
        a = cls(conf()).init(device="cpu")
        a.fit(batches, steps_per_dispatch=2)
        assert len(fake_capture) == 1 and fake_capture[0].replays == 3
        b = cls(conf()).init(device="cpu")
        for ds in batches:
            b.fit(ds)
        assert a._iteration == b._iteration == 6
        for x, y in zip(a._dispatch_state(), b._dispatch_state()):
            assert torch.equal(x, y)
        assert a.score() == b.score()
        st = cc.cache_stats()
        assert st["memory"] == {"hits": 2, "misses": 1}

    def test_warmup_leaves_state_and_captures_once(self, fake_capture):
        net = MultiLayerNetwork(_cnn_conf()).init(device="cpu")
        net.fit(_images(seed=9))              # moments and BN stats nonzero
        snap = _snapshot(net)
        cc.warmup(net, [((4, 2, 8, 8), (4, 3))])
        cc.warmup(net, [((4, 2, 8, 8), (4, 3))], steps_per_dispatch=2)
        _assert_state_equal(net, snap)
        assert net._iteration == 1
        assert cc.cache_stats()["compile_seconds"]["cold_compiles"] == 2
        cc.reset_stats()
        net.fit([_images(seed=i) for i in range(2)], steps_per_dispatch=2)
        net.fit(_images(seed=3))
        st = cc.cache_stats()
        assert st["compile_seconds"]["cold_compiles"] == 0
        assert st["memory"] == {"hits": 2, "misses": 0}

    def test_warm_from_batch_signature(self, fake_capture):
        net = MultiLayerNetwork(_mlp_conf()).init(device="cpu")
        sig = cc.describe_batch(_data())
        assert sig == {"features": [[16, 8], "float32"],
                       "labels": [[16, 3], "float32"]}
        assert cc.describe_batch(DataSet(np.ones((2, 8), np.float32),
                                         np.ones((2, 3), np.float32),
                                         labels_mask=np.ones(2))) is None
        assert cc.warm_from_batch_signature(net, {}) is False
        assert cc.warm_from_batch_signature(net, sig, steps_per_dispatch=2)
        assert cc.cache_stats()["compile_seconds"]["cold_compiles"] == 1
        t_sig = cc.describe_batch(DataSet(torch.ones(2, 8), torch.ones(2, 3)))
        assert t_sig["features"] == [[2, 8], "float32"]

    def test_warmup_specs(self):
        net = MultiLayerNetwork(_mlp_conf()).init(device="cpu")
        with pytest.raises(ValueError, match="warmup shape spec"):
            cc.warmup(net, [((1, 2), (3, 4), (5, 6))])
        with pytest.raises(ValueError, match="forward"):
            cc.warmup(net, [(16, 8)])

    def test_warmup_delegates_to_a_server(self):
        class Server:
            def buckets(self):
                return [1]

            def submit(self, x):
                raise AssertionError

            def warmup(self, shapes):
                self.warmed = shapes
                return self
        sv = Server()
        assert cc.warmup(sv, [(8,)]).warmed == [(8,)]

    def test_config_changes_drop_captured_steps(self):
        net = MultiLayerNetwork(_cnn_conf()).init(device="cpu")
        net.fit(_images())
        assert net._step_cache
        for change in (lambda: net.setPrecisionPolicy("bf16"),
                       lambda: net.setComputeLayout("NHWC"),
                       lambda: net.setEpilogueFusion(True)):
            net.fit(_images())
            assert net._step_cache
            change()
            assert not net._step_cache
        net.init(device="cpu")
        assert net._t_dev is None and net._opt_state is None


# ---------------------------------------------------------- the BERT step
class TestCapturedTransformerStep:
    def test_three_replays_equal_three_eager_steps(self, fake_capture):
        cfg = ttr.TransformerConfig.tiny(dtype=torch.float32, d_model=64,
                                         n_heads=2, n_layers=1, d_ff=128,
                                         vocab_size=256, max_len=32,
                                         use_flash_attention=True)
        r = np.random.RandomState(0)
        batches = [(torch.from_numpy(r.randint(0, 256, (2, 32))),
                    torch.from_numpy(r.randint(0, 256, (2, 32))),
                    torch.ones(2, 32)) for _ in range(3)]

        def run(captured):
            params = ttr.init_params(cfg, seed=0, device="cpu")
            opt = ttr.init_opt_state(params, Adam(1e-3))
            t = torch.zeros((), dtype=torch.int32)
            step = ttr.make_train_step(cfg, Adam(1e-3))
            fn = (lambda tok, tgt, m: step(params, opt, t, tok, tgt, m))
            if captured:
                fn = cc.CachedDispatch(
                    fn, "bert.train_step", always_capture=True,
                    state=lambda: cc.state_tensors(params, opt, t))
            losses = [float(fn(*b)) for b in batches]
            return losses, cc.state_tensors(params, opt, t)
        ck.install_platform_overrides()
        try:
            le, se = run(False)
            lc, sc = run(True)
        finally:
            ck.uninstall_platform_overrides()
        assert lc == le
        for a, b in zip(sc, se):
            assert torch.equal(a, b)
        assert int(sc[-1]) == 3
        assert fake_capture[0].replays == 3


# ------------------------------------------------------- real CUDA graphs
@pytest.mark.cuda
class TestOnTheCard:
    def test_one_signature_one_capture(self, card):
        net = MultiLayerNetwork(_mlp_conf()).init(device=card)
        batches = [_data(seed=i) for i in range(4)]
        net.fit(batches, steps_per_dispatch=2)
        net.fit(batches, steps_per_dispatch=2)
        st = cc.cache_stats()
        assert st["compile_seconds"]["cold_compiles"] == 1
        assert st["memory"] == {"hits": 3, "misses": 1}
        assert st["capture_failures"] == 0

    def test_three_replays_equal_three_eager_megasteps(self, card):
        batches = [_images(seed=i) for i in range(6)]
        a = MultiLayerNetwork(_cnn_conf()).init(device=card)
        a.fit(batches, steps_per_dispatch=2)
        b = MultiLayerNetwork(_cnn_conf()).init(device=card)
        for ds in batches:
            b.fit(ds)
        assert cc.cache_stats()["capture_failures"] == 0
        for x, y in zip(a._dispatch_state(), b._dispatch_state()):
            torch.testing.assert_close(x, y, rtol=1e-5, atol=1e-6)

    def test_warm_and_warmup_leave_the_state(self, card):
        net = MultiLayerNetwork(_cnn_conf()).init(device=card)
        net.fit(_images(seed=9))
        snap = _snapshot(net)
        cc.warmup(net, [((4, 2, 8, 8), (4, 3))])
        cc.warmup(net, [((4, 2, 8, 8), (4, 3))], steps_per_dispatch=2)
        _assert_state_equal(net, snap)
        st = cc.cache_stats()
        assert st["compile_seconds"]["cold_compiles"] == 2
        assert st["capture_failures"] == 0
        cc.reset_stats()
        net.fit(_images(seed=3))
        assert cc.cache_stats()["memory"] == {"hits": 1, "misses": 0}

    def test_a_capture_beside_another_dispatchs_replays(self, card):
        """A thread-local capture into a shared pool while another thread
        replays another dispatch's graph: both answer right."""
        w = torch.randn(64, 64, device=card)
        a = cc.CachedDispatch(lambda x: torch.relu(x @ w), "test:a")
        b = cc.CachedDispatch(lambda x: torch.tanh(x @ w) * 2, "test:b")
        x = torch.randn(32, 64, device=card)
        a.warm(x)
        want_a = a(x).cpu()
        torch.testing.assert_close(want_a, torch.relu(x @ w).cpu())
        stop, errors, n = [False], [], [0]

        def replays():
            try:
                while not stop[0]:
                    if not torch.equal(a(x).cpu(), want_a):
                        errors.append("a answered wrong")
                    n[0] += 1
            except Exception as e:
                errors.append(repr(e))
        th = threading.Thread(target=replays)
        th.start()
        for rows in (1, 2, 4, 8, 16):
            b.warm(x[:rows])
        stop[0] = True
        th.join(30)
        assert not errors and n[0] > 0
        assert cc.cache_stats()["capture_failures"] == 0
        assert b.captures() == 5 and b._pool is not None
        for rows in (1, 2, 4, 8, 16):
            torch.testing.assert_close(b(x[:rows]),
                                       torch.tanh(x[:rows] @ w) * 2)
