"""The port's concurrency tooling against the JAX package's on the CPU:
the cases of ``tests/test_concurrency.py`` over the port's seeded
``InterleavingHarness`` (lost increments on the bad fixture, determinism,
the locked clean bill), its instrumented locks and queue, and the
``-m races`` regressions over the port's error latch, async iterator,
server, async checkpoint writer, stats storage and UI server.

The harness is a copy of the JAX package's pure-Python scheduler
(``sys.settrace``, ``random.Random(seed)``): for seeds 0-19 it loses the
same increments on the ``UnsafeCounter`` fixture as the JAX harness. The
determinism cases use bodies built from traced Python only, with no
real lock, so they never reach the timing-based token steal.

Under CPython 3.12 the first traced call of a code object in a while
reports no opcode events (``UnsafeCounter.inc``'s first call loses its
8), so the first schedule of a fresh body differs from every later one
with the same seed, in both packages' harnesses (seed 0, two threads of
40: 66 increments kept on the first run, 62 on each later one). The
``warm_fixtures`` fixture traces the fixtures' code once before each
case, so every schedule compared is one of the repeatable ones. The
``UnsafeCounter`` runs give both harnesses a 1 s stall window: with the
default 10 ms one, a loaded test run (6 workers) once descheduled a token
owner for three windows, a waiter stole the token, and seed 6 of three
threads kept 49 increments under one harness and 51 under the other.
"""

import gc
import threading
import time

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.faults import InterleavingHarness as JHarness
from deeplearning4j_tpu_torch import profiler as prof
from deeplearning4j_tpu_torch.faults import (InterleavingHarness,
                                             preemptive_stress)

torch.set_num_threads(2)

races = pytest.mark.races


# ----------------------------------------------------------- bad fixtures
class UnsafeCounter:
    """The E202 bad fixture: bare read-modify-write on shared state."""

    def __init__(self):
        self.value = 0

    def inc(self):
        self.value += 1


class LockedCounter:
    """The fix: the same increment under a lock."""

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def inc(self):
        with self._lock:
            self.value += 1


#: the stall window for bodies of traced Python only: such a body never
#: blocks outside the tracer, so a token steal there only means the OS did
#: not run the owner for three windows, which the default 10 ms window
#: sees under a loaded test run (module doc)
TRACED_STALL = 1.0


def _hammer(counter_cls, seed, n=40, threads=2, harness=InterleavingHarness):
    c = counter_cls()

    def body():
        for _ in range(n):
            c.inc()
    # the locked fixture blocks on a real lock: it needs the steal
    kw = {} if counter_cls is LockedCounter else {
        "stall_timeout": TRACED_STALL}
    harness(seed=seed, **kw).run(*([body] * threads))
    return c.value, n * threads


@pytest.fixture(autouse=True)
def warm_fixtures():
    """One traced run of the fixtures' code before each case (module
    doc: the first traced call of a code object reports no opcodes), and
    no cyclic collection during the case: with JAX and torch loaded a
    full collection can hold the token owner longer than the harness's
    three stall windows (3 x 10 ms), and a waiter then steals the token
    off the seeded schedule."""
    for counter in (UnsafeCounter, LockedCounter):
        _hammer(counter, 0, n=2)
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


@races
class TestInterleavingHarness:
    def test_reproduces_lost_increment_on_bad_fixture(self):
        lost_seeds = [s for s in range(6)
                      if _hammer(UnsafeCounter, s)[0] < _hammer(
                          UnsafeCounter, s)[1]]
        assert lost_seeds, "no seed lost an increment — harness is not " \
                           "interleaving inside the read-modify-write"
        seed = lost_seeds[0]
        first, expected = _hammer(UnsafeCounter, seed)
        assert first < expected

    def test_schedule_is_deterministic(self):
        for seed in range(4):
            a, _ = _hammer(UnsafeCounter, seed)
            b, _ = _hammer(UnsafeCounter, seed)
            assert a == b, f"seed {seed} produced two different schedules"

    def test_different_seeds_differ(self):
        outcomes = {_hammer(UnsafeCounter, s)[0] for s in range(6)}
        assert len(outcomes) > 1

    def test_locked_fixture_never_loses(self):
        for seed in range(3):
            got, expected = _hammer(LockedCounter, seed, n=15)
            assert got == expected

    def test_three_way_interleaving(self):
        got, expected = _hammer(UnsafeCounter, seed=1, n=25, threads=3)
        assert got <= expected
        again, _ = _hammer(UnsafeCounter, seed=1, n=25, threads=3)
        assert got == again

    def test_results_and_errors_propagate(self):
        h = InterleavingHarness(seed=0)

        def ok():
            return 41 + 1

        def boom():
            raise RuntimeError("body failed")
        assert InterleavingHarness(seed=0).run(ok, ok) == [42, 42]
        with pytest.raises(RuntimeError, match="body failed"):
            h.run(ok, boom)

    def test_sweep_shapes(self):
        out = InterleavingHarness.sweep(
            lambda: [lambda: 1, lambda: 2], seeds=range(2))
        assert out == [[1, 2], [1, 2]]

    def test_timeout_releases_surviving_threads(self):
        gate = threading.Event()
        done = []

        def stuck():
            gate.wait()             # blocked outside the harness
            done.append("stuck")

        def quick():
            done.append("quick")
        h = InterleavingHarness(seed=0, timeout=1.0)
        with pytest.raises(TimeoutError):
            h.run(stuck, quick)
        gate.set()
        deadline = time.monotonic() + 5.0
        while "stuck" not in done and time.monotonic() < deadline:
            time.sleep(0.01)
        assert "stuck" in done

    def test_bodies_in_randomly_named_files_still_interleave(self, tmp_path):
        import importlib.util
        src = tmp_path / "my_random_threading_util.py"
        src.write_text("class Counter:\n"
                       "    def __init__(self):\n"
                       "        self.n = 0\n"
                       "    def bump(self):\n"
                       "        for _ in range(60):\n"
                       "            self.n += 1\n")
        spec = importlib.util.spec_from_file_location("my_rt_util", src)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        lost = False
        for seed in range(10):
            c = mod.Counter()
            InterleavingHarness(seed=seed).run(c.bump, c.bump)
            if c.n < 120:
                lost = True
                break
        assert lost, "no interleaving inside a stdlib-lookalike filename"

    @pytest.mark.parametrize("threads,n", [(2, 40), (3, 25)])
    def test_lost_increments_equal_the_jax_harness(self, threads, n):
        """Seeds 0-19: the same bodies and switch probability lose the
        same increments under either package's harness."""
        mine = [_hammer(UnsafeCounter, s, n=n, threads=threads)[0]
                for s in range(20)]
        theirs = [_hammer(UnsafeCounter, s, n=n, threads=threads,
                          harness=JHarness)[0] for s in range(20)]
        assert mine == theirs
        assert min(mine) < n * threads


@races
class TestErrorLatchRace:
    def test_first_record_wins_and_take_is_exactly_once(self):
        from deeplearning4j_tpu_torch.data.dataset import _ErrorLatch
        e1, e2 = RuntimeError("first"), RuntimeError("second")
        for seed in range(4):
            latch = _ErrorLatch()
            taken = []

            def writer(e):
                def body():
                    latch.record(e)
                return body

            def taker():
                taken.append(latch.take())
            InterleavingHarness(seed=seed).run(
                writer(e1), writer(e2), taker)
            leftovers = latch.take()
            observed = [x for x in taken + [leftovers] if x is not None]
            assert 1 <= len(observed) <= 2
            assert len(set(map(id, observed))) == len(observed)
            assert all(x in (e1, e2) for x in observed)
            assert latch.take() is None

    def test_delivered_clears_only_its_own_error(self):
        from deeplearning4j_tpu_torch.data.dataset import _ErrorLatch
        latch = _ErrorLatch()
        kept, stale = RuntimeError("kept"), RuntimeError("stale")
        latch.record(kept)
        latch.delivered(stale)      # not the latched one: no-op
        assert latch.take() is kept
        assert latch.take() is None


@races
class TestAsyncIteratorErrorRace:
    """A worker error surfaces exactly once — via next() OR close() —
    while close() races the worker."""

    def _failing_iter(self, n_good, err):
        from deeplearning4j_tpu_torch.data.dataset import (
            DataSet, ListDataSetIterator)

        class Failing(ListDataSetIterator):
            def __init__(self):
                x = np.zeros((n_good + 1, 2), np.float32)
                super().__init__(DataSet(x, x), batch_size=1)
                self._served = 0
                self.raised = False

            def next(self):
                if self._served >= n_good:
                    self.raised = True
                    raise err
                self._served += 1
                return super().next()
        return Failing()

    def test_exactly_once_error_under_stress(self):
        from deeplearning4j_tpu_torch.data.dataset import AsyncDataSetIterator
        err = IOError("worker blew up")
        with preemptive_stress(seed=7) as rng:
            for trial in range(20):
                source = self._failing_iter(2, err)
                it = AsyncDataSetIterator(source, prefetch=1)
                surfaced = 0
                try:
                    pulls = rng.randint(0, 3)
                    for _ in range(pulls):
                        if not it.hasNext():
                            break
                        it.next()
                except IOError:
                    surfaced += 1
                time.sleep(rng.random() * 0.002)
                try:
                    it.close()
                except IOError:
                    surfaced += 1
                it.close()
                want = 1 if source.raised else 0
                assert surfaced == want, \
                    f"trial {trial}: {surfaced} != {want}"


class _EchoModel:
    """Fake model for ModelServer: output == input."""

    def output(self, x):
        return x


@races
class TestServingStatsRace:
    def test_counts_and_batches_consistent_under_stress(self):
        from deeplearning4j_tpu_torch.serving import ModelServer
        n_threads, per_thread = 4, 25
        with preemptive_stress(seed=3):
            server = ModelServer(_EchoModel(), device="cpu", batch_limit=8,
                                 max_queue=1024, coalesce_ms=0.5)
            server.warmup([(3,)])
            results = [0] * n_threads

            def client(i):
                ok = 0
                for _ in range(per_thread):
                    try:
                        server.submit(np.ones((1, 3), np.float32)).get(10.0)
                        ok += 1
                    except Exception:
                        pass
                results[i] = ok
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60.0)
            server.drain()
            stats = server.stats()
            server.close()
        assert sum(stats["counts"].values()) == n_threads * per_thread
        assert stats["counts"].get("completed", 0) == sum(results)
        assert stats["batches"] >= 1
        assert stats["recompiles_after_warmup"] == 0

    def test_warmup_flags_visible_after_racing_submits(self):
        from deeplearning4j_tpu_torch.serving import ModelServer
        server = ModelServer(_EchoModel(), device="cpu", batch_limit=4,
                             coalesce_ms=0.5)
        server.warmup([(2,)])
        out = server.output(np.ones((1, 2), np.float32), timeout=10.0)
        assert out.shape == (1, 2)
        server.close()


class _Snap:
    """The writer releases each job's snapshot buffers after writing."""

    def release(self):
        pass


@races
class TestAsyncWriterErrorRace:
    def test_take_error_exactly_once(self):
        from deeplearning4j_tpu_torch.train.resilience import _AsyncWriter

        class Boom:
            def _write(self, *a, **kw):
                raise OSError("disk gone")
        w = _AsyncWriter(Boom(), depth=2)
        try:
            w.submit((_Snap(), "s", None, None, None))
            w.flush()
            takes = [w.take_error() for _ in range(3)]
            errs = [e for e in takes if e is not None]
            assert len(errs) == 1 and isinstance(errs[0], OSError)
        finally:
            w.close()

    def test_first_of_racing_failures_wins(self):
        from deeplearning4j_tpu_torch.train.resilience import _AsyncWriter

        class Boom:
            def __init__(self):
                self.n = 0

            def _write(self, *a, **kw):
                self.n += 1
                raise OSError(f"failure {self.n}")
        w = _AsyncWriter(Boom(), depth=2)
        try:
            for _ in range(3):
                w.submit((_Snap(), "s", None, None, None))
            w.flush()
            err = w.take_error()
            assert str(err) == "failure 1"       # FIRST failure is kept
        finally:
            w.close()


@races
class TestStatsStorageRace:
    def test_concurrent_puts_and_reads(self):
        from deeplearning4j_tpu_torch.ui.stats import InMemoryStatsStorage
        storage = InMemoryStatsStorage()
        seen = []
        n_writers, per_writer = 3, 30

        def writer(wid):
            for i in range(per_writer):
                storage.putUpdate({"session_id": "s", "iteration": i,
                                   "worker_id": str(wid)})

        def reader():
            for _ in range(50):
                storage.listSessionIDs()
                storage.getAllUpdates("s")
                storage.getStaticInfo("s")
                storage.registerStatsStorageListener(seen.append)
        with preemptive_stress(seed=11):
            threads = [threading.Thread(target=writer, args=(w,))
                       for w in range(n_writers)] \
                + [threading.Thread(target=reader)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30.0)
        assert len(storage.getAllUpdates("s")) == n_writers * per_writer

    def test_uiserver_stop_joins_thread(self):
        from deeplearning4j_tpu_torch.ui.server import UIServer
        ui = UIServer(port=0)
        ui.attach_serving(None)         # starts the HTTP thread
        thread = ui._thread
        assert thread is not None and thread.is_alive()
        ui.stop()
        assert not thread.is_alive()    # stop() joins


@races
class TestInstrumentedLocks:
    def setup_method(self):
        prof.set_profiling_mode(None)
        prof.disable_lock_order_witness()

    teardown_method = setup_method

    def _hist_count(self, name, label):
        m = prof.get_registry().get(name)
        if m is None:
            return 0
        child = m.children().get((label,))
        return child.count if child is not None else 0

    def test_wait_hold_contention_recorded_under_profiling(self):
        prof.set_profiling_mode(prof.ProfilingMode.BASIC)
        lock = prof.InstrumentedLock("test:contended")
        before_hold = self._hist_count("dl4j_lock_hold_seconds",
                                       "test:contended")
        entered = threading.Event()

        def holder():
            with lock:
                entered.set()
                time.sleep(0.05)
        t = threading.Thread(target=holder)
        t.start()
        entered.wait(5.0)
        with lock:                      # must block on the holder
            pass
        t.join(5.0)
        assert self._hist_count("dl4j_lock_hold_seconds",
                                "test:contended") == before_hold + 2
        assert self._hist_count("dl4j_lock_wait_seconds",
                                "test:contended") >= 1
        cont = prof.get_registry().get("dl4j_lock_contention_total")
        assert cont.children()[("test:contended",)].value >= 1

    def test_off_mode_records_nothing(self):
        lock = prof.InstrumentedLock("test:off")
        with lock:
            pass
        assert self._hist_count("dl4j_lock_hold_seconds", "test:off") == 0

    def test_rlock_locked_probe(self):
        rl = prof.InstrumentedRLock("test:rlock")
        assert rl.locked() is False
        with rl:
            assert rl.locked() is True      # owned by us
            seen = []
            t = threading.Thread(target=lambda: seen.append(rl.locked()))
            t.start()
            t.join(5.0)
            assert seen == [True]           # held by another thread
        assert rl.locked() is False

    def test_rlock_reentry_and_condition_wait(self):
        prof.set_profiling_mode(prof.ProfilingMode.BASIC)
        cond = prof.InstrumentedCondition("test:cond")
        got = []

        def waiter():
            with cond:
                while not got:
                    if not cond.wait(5.0):
                        return
                got.append("woke")
        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.02)
        with cond:
            with cond:                  # re-entrant
                got.append("sent")
                cond.notify_all()
        t.join(5.0)
        assert got == ["sent", "woke"]

    def test_witness_raises_on_inversion_and_releases(self):
        prof.enable_lock_order_witness()
        a = prof.InstrumentedLock("test:A")
        b = prof.InstrumentedLock("test:B")
        with a:
            with b:
                pass
        with pytest.raises(prof.LockOrderInversionError):
            with b:
                with a:
                    pass
        # the failed acquire must not strand either lock
        assert not a.locked() and not b.locked()
        assert ("test:A", "test:B") in prof.lock_order_edges()

    def test_witness_disable_while_held_leaves_no_stale_entry(self):
        a = prof.InstrumentedLock("test:stale-A")
        b = prof.InstrumentedLock("test:stale-B")
        prof.enable_lock_order_witness()
        a.acquire()
        prof.disable_lock_order_witness()
        a.release()
        prof.enable_lock_order_witness()
        with b:
            with a:                     # only-ever order b->a: clean
                pass

    def test_witness_warn_mode_and_consistent_order_clean(self):
        prof.enable_lock_order_witness(raise_on_inversion=False)
        a = prof.InstrumentedLock("test:C")
        b = prof.InstrumentedLock("test:D")
        for _ in range(3):              # one order only: no warning
            with a:
                with b:
                    pass
        with pytest.warns(RuntimeWarning, match="lock-order inversion"):
            with b:
                with a:
                    pass

    def test_serving_condition_is_instrumented(self):
        from deeplearning4j_tpu_torch.serving.server import ModelServer
        server = ModelServer(_EchoModel(), device="cpu", batch_limit=4)
        try:
            assert isinstance(server._cond, prof.InstrumentedCondition)
            assert isinstance(server.breaker._lock, prof.InstrumentedLock)
        finally:
            server.close()


class TestInstrumentedQueue:
    def setup_method(self):
        prof.set_profiling_mode(None)
        prof.disable_lock_order_witness()

    teardown_method = setup_method

    def _hold_count(self, label):
        m = prof.get_registry().get("dl4j_lock_hold_seconds")
        if m is None:
            return 0
        child = m.children().get((label,))
        return child.count if child is not None else 0

    def test_drop_in_queue_semantics(self):
        import queue
        q = prof.InstrumentedQueue(maxsize=2, name="test:q")
        q.put(1)
        q.put(2)
        with pytest.raises(queue.Full):
            q.put_nowait(3)
        assert q.get() == 1 and q.get() == 2
        with pytest.raises(queue.Empty):
            q.get_nowait()
        assert q.qsize() == 0 and q.empty()

    def test_blocking_handoff_across_threads(self):
        q = prof.InstrumentedQueue(maxsize=1, name="test:q_handoff")
        got = []

        def consumer():
            for _ in range(20):
                got.append(q.get())
        t = threading.Thread(target=consumer)
        t.start()
        for i in range(20):
            q.put(i)
        t.join(10.0)
        assert got == list(range(20))

    def test_records_under_profiling_free_when_off(self):
        before_off = self._hold_count("test:q_metrics")
        q = prof.InstrumentedQueue(name="test:q_metrics")
        q.put(1)
        q.get()
        assert self._hold_count("test:q_metrics") == before_off
        prof.set_profiling_mode(prof.ProfilingMode.BASIC)
        q.put(2)
        q.get()
        assert self._hold_count("test:q_metrics") > before_off

    @races
    def test_prefetcher_queue_instrumented_end_to_end(self):
        """The port's DevicePrefetcher runs on an InstrumentedQueue and
        still delivers every staged batch under preemptive stress."""
        from deeplearning4j_tpu_torch.data.dataset import (DataSet,
                                                           DevicePrefetcher)
        prof.set_profiling_mode(prof.ProfilingMode.BASIC)
        rng = np.random.RandomState(0)
        batches = [DataSet(rng.randn(4, 3).astype(np.float32),
                           np.eye(2, dtype=np.float32)[rng.randint(0, 2, 4)])
                   for _ in range(16)]
        before = self._hold_count("prefetch_queue")
        with preemptive_stress(seed=5):
            with DevicePrefetcher(iter(batches), device="cpu",
                                  prefetch=2) as pf:
                seen = sum(1 for _ in pf)
        assert seen == 16
        assert isinstance(pf._queue, prof.InstrumentedQueue)
        assert self._hold_count("prefetch_queue") > before

    def test_registry_lock_is_instrumented(self):
        reg = prof.get_registry()
        assert isinstance(reg._lock, prof.InstrumentedLock)
        assert reg._lock.name == "metrics_registry"
        prof.set_profiling_mode(prof.ProfilingMode.BASIC)
        before = self._hold_count("metrics_registry")
        reg.gauge("dl4j_test_registry_lock_probe", "probe")
        assert self._hold_count("metrics_registry") > before
