"""The port's ModelServer (CPU): parity with the JAX ModelServer on the
same transplanted weights and requests (fp32, argmax labels equal),
exactly-once resolution, deadline shedding, overload rejection, drain,
bounded retry and the power-of-two bucket ladder."""

import threading
import time

import numpy as np
import pytest

import jax
import torch

from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu.serving import ModelServer as JaxModelServer
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.serving import (CircuitBreaker,
                                              DeadlineExceededError,
                                              InferenceFailedError,
                                              ModelServer,
                                              ServerClosedError,
                                              ServerDrainingError,
                                              ServerOverloadedError,
                                              ServerUnhealthyError,
                                              ServingRequest,
                                              resolve_forward)

# the test workers share the CPU: keep torch's intra-op pool small
torch.set_num_threads(2)

T = 128
SMALL = dict(d_model=128, n_heads=2, n_layers=2, d_ff=256, vocab_size=1024,
             max_len=T)


@pytest.fixture(scope="module")
def lms():
    jcfg = jtr.TransformerConfig.tiny(dtype=jax.numpy.float32, **SMALL)
    tcfg = ttr.TransformerConfig.tiny(dtype=torch.float32,
                                      use_flash_attention=True, **SMALL)
    jlm = jtr.TransformerLM(jcfg, seed=0)
    params = ttr.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jlm.params), tcfg, "cpu")
    return jlm, ttr.TransformerLM(tcfg, device="cpu", params=params)


def _requests(n, seed=0):
    r = np.random.default_rng(seed)
    return [r.integers(0, 1024, (int(r.integers(1, 4)), T), dtype=np.int32)
            for _ in range(n)]


def _slow(fn, seconds):
    def forward(x):
        time.sleep(seconds)
        return fn(x)
    return forward


def _echo(x):
    return x.float() * 2.0


class TestParityWithJax:
    def test_served_argmax_equals_jax_server(self, lms):
        jlm, tlm = lms
        reqs = _requests(4, seed=1)
        ck.install_platform_overrides()
        try:
            with ModelServer(tlm.logits, device="cpu", batch_limit=4,
                             input_dtype=np.int32, head="argmax") as sv:
                sv.warmup([(T,)])
                ck.reset_counts()
                handles = [sv.submit(r) for r in reqs]
                got = [h.get(60) for h in handles]
                n_fwd = sv.stats()["batches"]
            assert ck.PLAIN_CALLS == {"layer_norm": 5 * n_fwd,
                                      "flash_attention": 2 * n_fwd}
        finally:
            ck.uninstall_platform_overrides()
        jsv = JaxModelServer(jlm.logits, batch_limit=4, input_dtype=np.int32,
                             head="argmax")
        try:
            jsv.warmup([(T,)])
            want = [jsv.output(r, timeout=60) for r in reqs]
        finally:
            jsv.close()
        for g, w in zip(got, want):
            assert g.dtype == np.int32 and g.shape == w.shape
            np.testing.assert_array_equal(g, np.asarray(w))

    def test_top_k_and_softmax_heads(self, lms):
        _, tlm = lms
        tok = _requests(1, seed=2)[0]
        logits = tlm.logits(tok)
        with ModelServer(tlm.logits, device="cpu", batch_limit=4,
                         input_dtype=np.int32, head="top_k:3") as sv:
            vals, idx = sv.output(tok, timeout=60)
        want_v, want_i = torch.topk(logits, 3, dim=-1)
        np.testing.assert_allclose(vals, want_v.numpy(), rtol=1e-5,
                                   atol=1e-5)
        assert idx.dtype == np.int32
        np.testing.assert_array_equal(idx, want_i.numpy())
        with ModelServer(tlm.logits, device="cpu", batch_limit=4,
                         input_dtype=np.int32, head="softmax") as sv:
            probs = sv.output(tok, timeout=60)
        np.testing.assert_allclose(probs.sum(-1), 1.0, rtol=1e-5)


class TestResolution:
    def test_exactly_once(self):
        req = ServingRequest(np.zeros((1, 3), np.float32), None, 0.0)
        assert req._resolve(result=np.ones(3))
        assert not req._resolve(error=RuntimeError("late"))
        assert req.resolutions == 1
        np.testing.assert_array_equal(req.get(1.0), np.ones(3))

    def test_concurrent_clients_each_resolved_once(self):
        rows = [np.full((1 + i % 3, 4), i, np.float32) for i in range(48)]
        handles = [None] * len(rows)
        with ModelServer(_echo, device="cpu", batch_limit=8, max_queue=64,
                         coalesce_ms=1.0) as sv:
            sv.warmup([(4,)])

            def client(idx):
                for i in idx:
                    handles[i] = sv.submit(rows[i])
            threads = [threading.Thread(target=client,
                                        args=(range(j, 48, 6),))
                       for j in range(6)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(30)
            assert not any(t.is_alive() for t in threads)
            for i, h in enumerate(handles):
                np.testing.assert_array_equal(h.get(30), rows[i] * 2)
        assert all(h.resolutions == 1 for h in handles)
        assert sv.counts["completed"] == 48


class TestAdmissionAndShedding:
    def test_expired_deadline_is_shed(self):
        with ModelServer(_slow(_echo, 0.2), device="cpu", batch_limit=1,
                         max_queue=8, coalesce_ms=0.0) as sv:
            sv.warmup([(2,)])
            first = sv.submit(np.ones((1, 2), np.float32))
            late = sv.submit(np.ones((1, 2), np.float32), deadline=0.01)
            with pytest.raises(DeadlineExceededError) as ei:
                late.get(10)
            assert not ei.value.retriable
            first.get(10)
        assert sv.counts["shed_deadline"] == 1
        assert late.resolutions == 1

    def test_full_queue_rejects(self):
        with ModelServer(_slow(_echo, 0.2), device="cpu", batch_limit=1,
                         max_queue=2, coalesce_ms=0.0) as sv:
            sv.warmup([(2,)])
            admitted, shed = [], 0
            for _ in range(10):
                try:
                    admitted.append(sv.submit(np.ones((1, 2), np.float32)))
                except ServerOverloadedError as e:
                    shed += 1
                    assert e.retriable and e.max_queue == 2
            assert shed > 0 and sv.counts["shed_overload"] == shed
            for r in admitted:
                assert r.get(30).shape == (1, 2)

    def test_drain_fails_queued_requests(self):
        sv = ModelServer(_slow(_echo, 0.3), device="cpu", batch_limit=1,
                         max_queue=16, coalesce_ms=0.0)
        sv.warmup([(2,)])
        reqs = [sv.submit(np.ones((1, 2), np.float32)) for _ in range(5)]
        t_end = time.monotonic() + 10
        while sv.queue_depth() == 5 and time.monotonic() < t_end:
            time.sleep(0.005)        # until the first is in flight
        sv.drain()
        outcomes = []
        for r in reqs:
            try:
                r.get(10)
                outcomes.append("ok")
            except ServerDrainingError as e:
                assert e.retriable
                outcomes.append("drained")
        assert outcomes[0] == "ok" and "drained" in outcomes
        assert all(r.resolutions == 1 for r in reqs)
        with pytest.raises(ServerDrainingError):
            sv.submit(np.ones((1, 2), np.float32))
        sv.close()
        with pytest.raises(ServerClosedError):
            sv.submit(np.ones((1, 2), np.float32))

    def test_unwarmed_shape_and_oversize_rejected(self):
        with ModelServer(_echo, device="cpu", batch_limit=2) as sv:
            sv.warmup([(3,)])
            with pytest.raises(ValueError, match="not warmed"):
                sv.submit(np.ones((1, 4), np.float32))
            with pytest.raises(ValueError, match="batch_limit"):
                sv.submit(np.ones((3, 3), np.float32))


class TestBucketsAndRetry:
    def test_bucket_ladder_pads_each_batch(self):
        seen = []

        def forward(x):
            seen.append(int(x.shape[0]))
            return x.float()
        with ModelServer(forward, device="cpu", batch_limit=8,
                         coalesce_ms=0.0) as sv:
            assert sv.buckets() == [1, 2, 4, 8]
            sv.warmup([(2,)])
            assert seen == [1, 2, 4, 8]
            seen.clear()
            out = sv.output(np.ones((3, 2), np.float32), timeout=10)
            assert out.shape == (3, 2) and seen == [4]
        assert ModelServer(_echo, device="cpu", batch_limit=5).buckets() \
            == [1, 2, 4, 8]

    def test_retry_then_success(self):
        calls = {"n": 0}

        def flaky(x):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected failure")
            return x.float()
        with ModelServer(flaky, device="cpu", batch_limit=1,
                         max_retries=2) as sv:
            with pytest.warns(UserWarning, match="attempt 1"):
                out = sv.output(np.ones((1, 2), np.float32), timeout=10)
            np.testing.assert_array_equal(out, np.ones((1, 2)))
            assert sv.breaker.state == CircuitBreaker.CLOSED

    def test_breaker_opens_after_failures(self):
        def broken(x):
            raise RuntimeError("down")
        with ModelServer(broken, device="cpu", batch_limit=1, max_retries=0,
                         breaker_threshold=2, breaker_cooldown=60.0) as sv:
            with pytest.warns(UserWarning):
                for _ in range(2):
                    with pytest.raises(InferenceFailedError):
                        sv.output(np.ones((1, 2), np.float32), timeout=10)
            assert not sv.healthy
            with pytest.raises(ServerUnhealthyError) as ei:
                sv.submit(np.ones((1, 2), np.float32))
            assert ei.value.retry_after is not None
        assert sv.counts["failed"] == 2
        assert sv.counts["rejected_unhealthy"] == 1


class TestSurface:
    def test_needs_a_device_or_a_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ModelServer(_echo)

    def test_resolve_forward(self):
        class Net:
            def output(self, x):
                return x
        net = Net()
        assert resolve_forward(net) == net.output
        assert resolve_forward(_echo) is _echo
        with pytest.raises(TypeError):
            resolve_forward(object())

    def test_stats_and_load_hints(self):
        with ModelServer(_echo, device="cpu", batch_limit=4,
                         name="hints-test") as sv:
            sv.warmup([(2,)])
            sv.output(np.ones((2, 2), np.float32), timeout=10)
            st = sv.stats()
            assert st["state"] == "serving" and st["ready"]
            assert st["counts"] == {"completed": 1}
            hints = sv.load_hints()
            assert hints["server"] == "hints-test"
            assert hints["batch_occupancy_mean"] == 1.0
            assert hints["shed_rate"] == 0.0
        assert sv.state == "closed"
