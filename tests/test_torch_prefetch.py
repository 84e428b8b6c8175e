"""The port's asynchronous, retrying and iterable iterators, its
``DevicePrefetcher`` and ``fit(prefetch=...)`` against the JAX package's
(CPU).

Iterators: the same seeded batches through both packages' wrappers give
the same batches in the same order (to the bit), the same retry counts
for the same seeded transient failures, and raise the same errors at the
same batch. ``DevicePrefetcher``: order and grouping, a worker error
surfacing at its batch, ``close()`` while the worker is busy. ``fit``:
with ``prefetch=2`` equal to the bit to ``prefetch=0`` and to single
steps; from the staged image pipeline's uint8 megabatches within 2e-4 of
the JAX graph's fit on the same images from transplanted weights
(tests/test_torch_graph.py's train-step tolerance, the conv bias that
feeds a train-mode BN within 2 x lr as in tests/test_torch_image_bytes.py);
a MultiDataSet through ``ComputationGraph.fit`` at K=1 and K=2 within
2e-4 of the JAX graph.
"""

import os
import threading
import time

import numpy as np
import pytest

import torch

from deeplearning4j_tpu import profiler as jprof
from deeplearning4j_tpu.data import dataset as jdata
from deeplearning4j_tpu.nn import graph as jgraph
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch import profiler as tprof
from deeplearning4j_tpu_torch.data import dataset as tdata
from deeplearning4j_tpu_torch.data.pipeline import MultiWorkerImageIterator
from deeplearning4j_tpu_torch.nn import graph as tgraph
from deeplearning4j_tpu_torch.nn import layers as tlayers
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.train import stepping
from deeplearning4j_tpu_torch.train import updaters as tupd

from test_torch_image_bytes import LR, conv_pair, image_bytes

torch.set_num_threads(2)

FIT_TOL = 2e-4


def _batches(n=7, rows=3, seed=0):
    r = np.random.default_rng(seed)
    x = r.standard_normal((n * rows, 4)).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[r.integers(0, 2, n * rows)]
    return x, y


def _pulled(it):
    out = []
    while it.hasNext():
        ds = it.next()
        out.append((np.asarray(ds.features), np.asarray(ds.labels)))
    return out


def _same(a, b):
    assert len(a) == len(b)
    for (fa, la), (fb, lb) in zip(a, b):
        assert np.array_equal(fa, fb) and np.array_equal(la, lb)


class _Flaky:
    """A list iterator that raises ``error`` on the pulls the seed picks
    (each pull fails at most ``fails`` times in a row), in either
    package."""

    def __init__(self, pkg, x, y, error, seed=0, fails=1, at=None):
        self.base = pkg.ListDataSetIterator(pkg.DataSet(x, y), 3)
        r = np.random.default_rng(seed)
        n = -(-len(x) // 3)
        self.bad = set(r.choice(n, size=3, replace=False).tolist()) \
            if at is None else {at}
        self.error, self.fails = error, fails
        self.tries = {}
        self.pulls = 0

    def hasNext(self):
        return self.base.hasNext()

    def next(self):
        i = self.pulls
        if i in self.bad and self.tries.get(i, 0) < self.fails:
            self.tries[i] = self.tries.get(i, 0) + 1
            raise self.error(f"pull {i} failed")
        self.pulls += 1
        return self.base.next()

    def reset(self):
        self.base.reset()
        self.pulls = 0
        self.tries = {}

    def batch(self):
        return 3


def _retries(prof):
    c = prof.get_registry().get("dl4j_data_retries_total")
    return 0.0 if c is None else c.value


# ------------------------------------------------------------- iterators
def test_async_iterator_matches_jax():
    x, y = _batches()
    got = []
    for pkg in (jdata, tdata):
        it = pkg.AsyncDataSetIterator(
            pkg.ListDataSetIterator(pkg.DataSet(x, y), 3, shuffle=True,
                                    seed=4), prefetch=2)
        got.append(_pulled(it) + [None] + _pulled(it) + [None])
        it.reset()
        got[-1] += _pulled(it)
        it.close()
        it.close()                          # a second close does nothing
        assert not it.hasNext()
    a, b = got
    assert len(a) == len(b) == 7 + 1 + 0 + 1 + 7
    for p, q in zip(a, b):
        assert (p is None) == (q is None)
        if p is not None:
            _same([p], [q])


@pytest.mark.parametrize("transient", [True, False])
def test_async_iterator_retries_and_errors_match_jax(transient):
    x, y = _batches(n=6)
    err_j = jdata.TransientDataError if transient else ValueError
    err_t = tdata.TransientDataError if transient else ValueError
    outcomes = []
    for pkg, prof, err in ((jdata, jprof, err_j), (tdata, tprof, err_t)):
        before = _retries(prof)
        src = _Flaky(pkg, x, y, err, seed=1)
        it = pkg.AsyncDataSetIterator(src, prefetch=2, max_retries=2,
                                      retry_backoff=0.001)
        got = []
        with pytest.raises(err) if not transient else _nothing():
            while it.hasNext():
                got.append(np.asarray(it.next().features))
        it.close()
        outcomes.append((len(got), [g.tobytes() for g in got],
                         _retries(prof) - before))
    assert outcomes[0] == outcomes[1]
    if transient:
        assert outcomes[1][0] == 6 and outcomes[1][2] == 3


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_async_close_raises_an_error_nobody_pulled():
    x, y = _batches(n=4)
    for pkg in (jdata, tdata):
        src = _Flaky(pkg, x, y, ValueError, at=2)
        it = pkg.AsyncDataSetIterator(src, prefetch=4)
        time.sleep(0.2)                  # the worker reaches the failure
        with pytest.raises(ValueError, match="pull 2"):
            it.close()
        it.close()


@pytest.mark.parametrize("fails,ok", [(2, True), (3, False)])
def test_retrying_iterator_matches_jax(fails, ok):
    x, y = _batches(n=5)
    outcomes = []
    for pkg, prof in ((jdata, jprof), (tdata, tprof)):
        before = _retries(prof)
        src = _Flaky(pkg, x, y, pkg.TransientDataError, seed=2, fails=fails)
        it = pkg.RetryingDataSetIterator(src, max_retries=2, backoff=0.0)
        got, raised = [], None
        try:
            while it.hasNext():
                got.append(np.asarray(it.next().features).tobytes())
        except pkg.TransientDataError as e:
            raised = str(e)
        outcomes.append((got, raised, _retries(prof) - before))
    assert outcomes[0] == outcomes[1]
    assert (outcomes[1][1] is None) == ok
    assert tdata.is_transient_error(tdata.TransientDataError("x"))
    assert not tdata.is_transient_error(ValueError("x"))


def test_iterable_iterator_matches_jax():
    x, y = _batches(n=3)
    for make in (lambda pkg: [pkg.DataSet(x[i:i + 3], y[i:i + 3])
                              for i in range(0, 9, 3)],
                 lambda pkg: (pkg.DataSet(x[i:i + 3], y[i:i + 3])
                              for i in range(0, 9, 3))):
        got = []
        for pkg in (jdata, tdata):
            it = pkg.IterableDataSetIterator(make(pkg))
            first = _pulled(it)
            it.reset()
            got.append((first, _pulled(it), it.batch()))
        _same(got[0][0], got[1][0])
        _same(got[0][1], got[1][1])
        assert got[0][2] == got[1][2] == -1


# ------------------------------------------------------- DevicePrefetcher
@pytest.mark.parametrize("k", [1, 2, 3])
def test_prefetcher_order_and_grouping(k):
    x, y = _batches(n=7)
    src = [tdata.DataSet(x[i:i + 3], y[i:i + 3]) for i in range(0, 21, 3)]
    with tdata.DevicePrefetcher(src, steps_per_dispatch=k, prefetch=2,
                                device="cpu") as pf:
        items = list(pf)
    want = list(stepping.group_into_megabatches(src, k))
    assert [type(a) for a in items] == [type(b) for b in want]
    for a, b in zip(items, want):
        assert isinstance(a.features, torch.Tensor)
        assert np.array_equal(a.features.numpy(), np.asarray(b.features))
        assert np.array_equal(a.labels.numpy(), np.asarray(b.labels))
    assert sum(a.numExamples() for a in items) == 21


def test_prefetcher_error_surfaces_at_its_batch():
    x, y = _batches(n=5)

    def source():
        for i in range(0, 15, 3):
            if i == 9:
                raise ValueError("batch 3 is bad")
            yield tdata.DataSet(x[i:i + 3], y[i:i + 3])
    pf = tdata.DevicePrefetcher(source(), prefetch=2, device="cpu")
    got = []
    with pytest.raises(ValueError, match="batch 3"):
        for item in pf:
            got.append(item)
    assert len(got) == 3
    pf.close()                           # delivered: close raises nothing


def test_prefetcher_close_while_busy():
    x, y = _batches(n=3)
    started = threading.Event()

    def slow():
        for i in range(1000):
            started.set()
            time.sleep(0.01)
            yield tdata.DataSet(x[:3], y[:3])
    pf = tdata.DevicePrefetcher(slow(), prefetch=1, device="cpu")
    assert started.wait(5)
    next(pf)
    t0 = time.perf_counter()
    pf.close()
    assert time.perf_counter() - t0 < 5
    assert pf._thread is None
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()


def test_prefetcher_close_raises_an_undelivered_error():
    def bad():
        yield tdata.DataSet(np.zeros((2, 4), np.float32),
                            np.zeros((2, 2), np.float32))
        raise KeyError("lost")
    pf = tdata.DevicePrefetcher(bad(), prefetch=4, device="cpu")
    time.sleep(0.2)
    with pytest.raises(KeyError, match="lost"):
        pf.close()


# -------------------------------------------------------------------- fit
def _image_tree(root, classes=3, per=6, hw=(10, 12)):
    from PIL import Image
    r = np.random.RandomState(5)
    for c in range(classes):
        d = os.path.join(root, f"class{c}")
        os.makedirs(d)
        for i in range(per):
            Image.fromarray(r.randint(0, 16, hw + (3,), dtype=np.uint8)
                            ).save(os.path.join(d, f"{i}.png"))
    return str(root)


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    root = _image_tree(tmp_path_factory.mktemp("images"))
    it = MultiWorkerImageIterator(root, 8, 8, batch_size=4, workers=2,
                                  shuffle=True, seed=7, steps_per_dispatch=2)
    yield it
    it.close()


def test_fit_from_the_pipeline_prefetch_equals_sync_and_jax(pipeline):
    """ComputationGraph.fit(iterator, K=2) from the staged pipeline's uint8
    megabatches: prefetch=2 and prefetch=0 equal to the bit; both within
    the tolerance of the JAX graph fed the same images."""
    nets = []
    for prefetch in (2, 0):
        _, t = conv_pair()
        pipeline.seek({"batch": 0, "epoch": 0})
        t.fit(pipeline, epochs=2, steps_per_dispatch=2, prefetch=prefetch)
        nets.append(t)
    a, b = nets
    assert a.getIterationCount() == b.getIterationCount() == 8
    for p, q in zip(a._dispatch_state(), b._dispatch_state()):
        assert torch.equal(p, q)
    # the JAX graph on the same batches (pipeline.py's are bit-equal to
    # the JAX pipeline's, tests/test_torch_pipeline.py)
    j, _ = conv_pair()
    pipeline.seek({"batch": 0, "epoch": 0})
    for _ in range(2):
        pipeline.reset()
        for mb in pipeline.dispatch_stream():
            assert isinstance(mb, stepping.MegaBatch)
            assert mb.features.dtype == np.uint8
            j.fit([jdata.DataSet(mb.features[i], mb.labels[i])
                   for i in range(mb.steps)], steps_per_dispatch=2)
    assert j._iteration == 8
    for node, p in j._params.items():
        for k, v in p.items():
            tol = 2 * LR if (node, k) == ("c1", "b") else FIT_TOL
            np.testing.assert_allclose(
                a._params[node][k].detach().numpy(), np.asarray(v),
                rtol=tol, atol=tol, err_msg=f"{node}.{k}")


def test_fit_takes_the_dispatch_stream(pipeline, monkeypatch):
    """K matching the pipeline's staging: the fit pulls whole megabatches
    (no per-batch next()); another K takes the per-batch path."""
    calls = []
    real_next = type(pipeline).next
    monkeypatch.setattr(type(pipeline), "next",
                        lambda self: calls.append(1) or real_next(self))
    _, t = conv_pair()
    seen = []
    real = t._fit_mega
    t._fit_mega = lambda mb: seen.append(mb.steps) or real(mb)
    t.fit(pipeline, steps_per_dispatch=2)
    assert seen == [2, 2] and not calls
    assert stepping.use_dispatch_stream(pipeline, 2)
    assert not stepping.use_dispatch_stream(pipeline, 3)
    seen.clear()
    t.fit(pipeline, steps_per_dispatch=4)
    assert seen == [4] and len(calls) == 4


def test_evaluate_prefetch_equals_the_calling_thread(tmp_path):
    root = _image_tree(tmp_path)
    it = MultiWorkerImageIterator(root, 8, 8, batch_size=4, workers=2,
                                  drop_last=False)
    try:
        _, t = conv_pair()
        a = t.evaluate(it, prefetch=True)
        b = t.evaluate(it, prefetch=False)
    finally:
        it.close()
    assert a.accuracy() == b.accuracy()
    assert a.stats() == b.stats()


# ------------------------------------------------------------ MultiDataSet
def _two_way(Conf, G, Lm, It, upd):
    """Two inputs (merged), two softmax outputs."""
    g = (Conf.Builder().seed(9).weightInit("xavier").updater(upd.Adam(1e-2))
         .graphBuilder().addInputs("a", "b")
         .setInputTypes(It.feedForward(4), It.feedForward(3)))
    g.addVertex("m", G.MergeVertex(), "a", "b")
    g.addLayer("h", Lm.DenseLayer(nOut=6, activation="tanh"), "m")
    g.addLayer("o1", Lm.OutputLayer(nOut=2, lossFunction="mcxent",
                                    activation="softmax"), "h")
    g.addLayer("o2", Lm.OutputLayer(nOut=3, lossFunction="mcxent",
                                    activation="softmax"), "h")
    g.setOutputs("o1", "o2")
    return G.ComputationGraph(g.build())


def _multi_data(seed, n=5):
    r = np.random.default_rng(seed)
    return ([r.standard_normal((n, 4)).astype(np.float32),
             r.standard_normal((n, 3)).astype(np.float32)],
            [np.eye(2, dtype=np.float32)[r.integers(0, 2, n)],
             np.eye(3, dtype=np.float32)[r.integers(0, 3, n)]])


@pytest.mark.parametrize("k", [1, 2])
def test_multi_dataset_fit_matches_jax(k):
    j = _two_way(JConf, jgraph, jlayers, JInputType, jupd).init()
    t = _two_way(NeuralNetConfiguration, tgraph, tlayers, InputType, tupd)
    t.params_from_jax(j._params, j._states, device="cpu")
    data = [_multi_data(s) for s in (0, 1, 2)]
    j.fit([jdata.MultiDataSet(f, l) for f, l in data],
          steps_per_dispatch=k)
    t.fit([tdata.MultiDataSet(f, l) for f, l in data],
          steps_per_dispatch=k)
    assert t.getIterationCount() == j._iteration == 3
    np.testing.assert_allclose(t.score(), float(j.score()), rtol=FIT_TOL)
    for node, p in j._params.items():
        for name, v in p.items():
            np.testing.assert_allclose(
                t._params[node][name].detach().numpy(), np.asarray(v),
                rtol=FIT_TOL, atol=FIT_TOL, err_msg=f"{node}.{name}")
    f, l = _multi_data(3)
    np.testing.assert_allclose(
        t.score(tdata.MultiDataSet(f, l)),
        float(j.score(jdata.MultiDataSet(f, l))), rtol=FIT_TOL)
    # K=2 over 3 batches: one megastep and a single step for the tail
    assert set(t._step_cache) == {("multi", 2, 2, False, n)
                                  for n in sorted({k, 1})}


def test_a_multilayer_network_refuses_a_multi_dataset():
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    b = (NeuralNetConfiguration.Builder().seed(1).list()
         .layer(tlayers.OutputLayer(nOut=2, lossFunction="mcxent",
                                    activation="softmax"))
         .setInputType(InputType.feedForward(4)))
    net = MultiLayerNetwork(b.build()).init(device="cpu")
    f, l = _multi_data(0)
    with pytest.raises(TypeError, match="MultiDataSet"):
        net.fit(tdata.MultiDataSet(f[:1], l[:1]))


def test_data_wait_and_dispatch_are_timed():
    """With instrumentation on, a fit records its data wait and its
    dispatches, and data_overlap_ratio reads them."""
    from deeplearning4j_tpu_torch.profiler.modes import (ProfilingMode,
                                                         set_profiling_mode)
    reg = tprof.get_registry()

    def total(name):
        h = reg.get(name)
        return (0, 0.0) if h is None else (h.count, h.sum)
    _, t = conv_pair()
    data = [tdata.DataSet(*image_bytes(s)) for s in range(4)]
    w0, s0 = total("dl4j_train_data_wait_seconds"), \
        total("dl4j_train_step_seconds")
    set_profiling_mode(ProfilingMode.BASIC)
    try:
        t.fit(data, steps_per_dispatch=2)
        t.fit(data)
    finally:
        set_profiling_mode(ProfilingMode.OFF)
    w1, s1 = total("dl4j_train_data_wait_seconds"), \
        total("dl4j_train_step_seconds")
    assert w1[0] - w0[0] == 2 + 4 and s1[0] - s0[0] == 2 + 4
    ratio = tprof.data_overlap_ratio()
    assert ratio is not None and 0.0 < ratio <= 1.0


def test_the_prefetcher_runs_on_the_card_unless_told(monkeypatch):
    """No quiet fallback: without a card and without ``device`` the
    prefetcher raises; ``device="cpu"`` stages on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdata.DevicePrefetcher([], steps_per_dispatch=2)
    with tdata.DevicePrefetcher([], device="cpu") as pf:
        assert list(pf) == [] and not pf._stager.cuda
