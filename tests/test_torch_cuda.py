"""The port's CUDA kernels and served forward on the card.

Every test here needs a CUDA card (marker ``cuda``) and skips without
one. The file imports neither JAX nor the JAX package, so it also runs on
a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: fp32 rtol=atol=2e-5 (as tests/test_pallas.py), bf16 2e-2 (a
few bf16 ulps: both sides round the same fp32 value), lse 1e-5 absolute;
scale_shift_act 1e-6 relative in fp32 and one ulp in bf16 (both sides
round the exact value once).
"""

import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn import compilecache as cc
from deeplearning4j_tpu_torch.nn import layers as tlayers
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import normalization as norm_ops
from deeplearning4j_tpu_torch.serving import ModelRegistry, ModelServer
from deeplearning4j_tpu_torch.train import stepping
from deeplearning4j_tpu_torch.train.updaters import Adam

pytestmark = pytest.mark.cuda

FP32_TOL = 2e-5
BF16_TOL = 2e-2


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(dev, *shape, dtype=torch.float32, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(dev, dtype)


def _tol(dtype):
    return FP32_TOL if dtype == torch.float32 else BF16_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1000, 768), (7, 33), (64, 4096)] + [
    (1001, d) for d in (33, 768, 1000, 1024, 1025, 4096, 8192)])
def test_layer_norm_kernel_matches_plain(dev, dtype, shape):
    # a warp a row up to D=1024 (16-byte loads where D allows, scalar
    # otherwise), a block a row above; N off the 8 rows of a warp block
    x = _randn(dev, *shape, dtype=dtype, seed=1) * 2 + 0.5
    g = _randn(dev, shape[1], seed=2)
    b = _randn(dev, shape[1], seed=3)
    ck.reset_counts()
    y = ck.layer_norm_fwd(x, g, b)
    assert ck.LAUNCHES["layer_norm"] == 1 and y.dtype == dtype
    torch.testing.assert_close(y, ck.layer_norm_plain(x, g, b),
                               rtol=_tol(dtype), atol=_tol(dtype))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,D", [(200, 64), (128, 128), (70, 192),
                                 (64, 256)])
def test_flash_kernel_matches_plain(dev, causal, dtype, T, D):
    q, k, v = (_randn(dev, 2, T, 3, D, dtype=dtype, seed=s)
               for s in (4, 5, 6))
    o, lse = ck.flash_attention_fwd(q, k, v, causal)
    po, plse = ck.flash_attention_plain(q, k, v, causal)
    torch.testing.assert_close(o, po, rtol=_tol(dtype), atol=_tol(dtype))
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-5)


def _flash_against_plain(q, k, v, causal, route):
    """The wrapper's call takes ``route`` and matches the plain version."""
    ck.reset_counts()
    o, lse = ck.flash_attention_fwd(q, k, v, causal)
    assert ck.FLASH_ROUTES == {"tensor_core": int(route == "tensor_core"),
                               "cuda_core": int(route == "cuda_core")}
    po, plse = ck.flash_attention_plain(q.contiguous(), k.contiguous(),
                                        v.contiguous(), causal)
    torch.testing.assert_close(o, po, rtol=_tol(q.dtype), atol=_tol(q.dtype))
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-5)


@pytest.mark.parametrize("T", [1, 63, 64, 65, 200, 512])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("D", [64, 128, 192, 256])
def test_flash_tensor_core_route_matches_plain(dev, D, causal, T):
    q, k, v = (_randn(dev, 2, T, 3, D, dtype=torch.bfloat16, seed=s)
               for s in (24, 25, 26))
    _flash_against_plain(q, k, v, causal, "tensor_core")


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("tq,tk", [(100, 300), (300, 100)])
def test_flash_tensor_core_route_tq_ne_tk(dev, tq, tk, causal):
    q = _randn(dev, 2, tq, 3, 64, dtype=torch.bfloat16, seed=27)
    k, v = (_randn(dev, 2, tk, 3, 64, dtype=torch.bfloat16, seed=s)
            for s in (28, 29))
    _flash_against_plain(q, k, v, causal, "tensor_core")


def test_flash_kernel_reads_strided_views(dev):
    # q, k, v as the QKV projection leaves them: thirds of one [B, T, 3E]
    B, T, H, D = 2, 96, 4, 64
    qkv = _randn(dev, B, T, 3 * H * D, dtype=torch.bfloat16, seed=7)
    q, k, v = (t.reshape(B, T, H, D) for t in qkv.split(H * D, dim=-1))
    assert not q.is_contiguous()
    _flash_against_plain(q, k, v, False, "tensor_core")


def test_flash_unaligned_bf16_takes_the_cuda_cores(dev):
    # the last H*D columns of a [B, T, H*D + 1] buffer: 2-byte offset and
    # an odd t stride, which the 16-byte copies cannot take
    B, T, H, D = 2, 150, 3, 64
    buf = _randn(dev, B, T, H * D + 1, dtype=torch.bfloat16, seed=30)
    q = buf[..., 1:].reshape(B, T, H, D)
    for causal in (False, True):
        _flash_against_plain(q, q, q, causal, "cuda_core")


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    with pytest.raises(ValueError):
        ck.layer_norm_fwd(_randn(dev, 4, 8).t(), torch.ones(4, device=dev),
                          torch.zeros(4, device=dev))
    q = _randn(dev, 1, 8, 1, 32)
    with pytest.raises(ValueError):
        ck.flash_attention_fwd(q, q, q)


def test_served_tiny_lm_launches_the_kernels(dev):
    cfg = ttr.TransformerConfig.tiny(d_model=128, n_heads=2,
                                     use_flash_attention=True)
    lm = ttr.TransformerLM(cfg, seed=0)
    ck.install_platform_overrides()
    try:
        with ModelServer(lm.logits, batch_limit=4, input_dtype=np.int32,
                         head="argmax") as sv:
            ck.reset_counts()
            sv.warmup([(64,)])
            # one graph a bucket, each recording the kernels' launches
            assert sv._dispatch.launches_at_capture() == [
                {"flash_attention": 2, "layer_norm": 5}] * 3
            assert ck.FLASH_ROUTES["cuda_core"] == 0
            ck.reset_counts()
            tok = np.random.default_rng(8).integers(0, 1024, (3, 64),
                                                    dtype=np.int32)
            got = sv.output(tok, timeout=60)
            n_fwd = sv.stats()["batches"]
            assert sv.recompiles_after_warmup() == 0
            assert sv.captures_after_warmup() == 0
        assert not any(ck.LAUNCHES.values())
        assert ck.REPLAYS == {"layer_norm": 5 * n_fwd,
                              "flash_attention": 2 * n_fwd,
                              "scale_shift_act": 0, "softmax": 0,
                              "bn_stats": 0, "bn_apply_leaky": 0}
        assert ck.PLAIN_CALLS == {"layer_norm": 0, "flash_attention": 0,
                                  "scale_shift_act": 0, "softmax": 0,
                                  "bn_stats": 0, "bn_apply_leaky": 0}
        want = lm.logits(tok).argmax(-1).to(torch.int32).cpu().numpy()
        assert (got == want).mean() >= 0.99
    finally:
        ck.uninstall_platform_overrides()


@pytest.mark.parametrize("alpha", [0.0, 0.01])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,c", [(64 * 28 * 28, 128), (999, 36)])
def test_scale_shift_act_kernel_matches_plain(dev, alpha, dtype, rows, c):
    x = _randn(dev, rows, c, dtype=dtype, seed=9) * 2
    sc = _randn(dev, c, dtype=dtype, seed=10)
    sh = _randn(dev, c, dtype=dtype, seed=11)
    ck.reset_counts()
    y = ck.scale_shift_act_fwd(x, sc, sh, alpha)
    assert ck.LAUNCHES["scale_shift_act"] == 1 and y.dtype == dtype
    want = ck.scale_shift_act_plain(x, sc, sh, alpha)
    # kernel and plain round the exact x*scale+shift once: 1e-6 relative
    # in fp32, one ulp (at most 2^-7 relative) in bf16
    rel = 1e-6 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(y, want, rtol=rel, atol=0)
    # backward: the override's autograd Function against the generic
    # op's, which differs only at y == 0 (slope 1 there, 0 for relu)
    fused = ck.make_scale_shift_act_override()
    xg = x.float().requires_grad_(True)
    ct = _randn(dev, rows, c, seed=12)
    (g,) = torch.autograd.grad(fused(xg, sc.float(), sh.float(),
                                     alpha=alpha, axis=1), xg, ct)
    slope = torch.where(xg.detach() * sc.float() + sh.float() >= 0, 1.0,
                        alpha)
    torch.testing.assert_close(g, ct * slope * sc.float(), rtol=FP32_TOL,
                               atol=FP32_TOL)


def test_scale_shift_act_kernel_keeps_nan(dev):
    x = _randn(dev, 256, 64, dtype=torch.bfloat16, seed=13)
    x[::7, ::3] = float("nan")
    one = torch.ones(64, device=dev, dtype=torch.bfloat16)
    zero = torch.zeros(64, device=dev, dtype=torch.bfloat16)
    for alpha in (0.0, 0.01):
        y = ck.scale_shift_act_fwd(x, one, zero, alpha)
        assert bool(torch.isnan(y[::7, ::3]).all())
        assert int(torch.isnan(y).sum()) == int(torch.isnan(x).sum())


# softmax: fp32 rtol 1e-5 / atol 1e-6 (tests/test_pallas.py); bf16 one ulp
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(49152, 128), (32, 2), (100, 100),
                                   (64, 1000), (16, 4096), (8, 5000)])
def test_softmax_kernel_matches_plain(dev, dtype, shape):
    x = _randn(dev, *shape, dtype=dtype, seed=14) * 4
    ck.reset_counts()
    y = ck.softmax_fwd(x)
    assert ck.LAUNCHES["softmax"] == 1 and y.dtype == dtype
    rtol, atol = (1e-5, 1e-6) if dtype == torch.float32 else (2.0 ** -7,
                                                              1e-6)
    torch.testing.assert_close(y, ck.softmax_plain(x), rtol=rtol, atol=atol)


def test_softmax_kernel_nan_and_minus_inf_rows(dev):
    for d in (128, 2000):              # the warp and the block kernels
        x = _randn(dev, 4, d, seed=15)
        x[1, 3] = float("nan")
        x[2] = -float("inf")
        y = ck.softmax_fwd(x)
        assert bool(torch.isnan(y[1:3]).all())
        assert not bool(torch.isnan(y[0]).any()) and not bool(
            torch.isnan(y[3]).any())


def test_override_gradients_flow_on_the_card(dev):
    ck.install_platform_overrides()
    try:
        from deeplearning4j_tpu_torch.ops import registry
        x = (_randn(dev, 64, 768, seed=16) * 2).requires_grad_(True)
        g = (_randn(dev, 768, seed=17) + 1).requires_grad_(True)
        b = _randn(dev, 768, seed=18).requires_grad_(True)
        w = _randn(dev, 64, 768, seed=19)
        got = torch.autograd.grad(
            (registry.get("layer_norm")(x, g, b) * w).sum(), (x, g, b))
        want = torch.autograd.grad(
            (ck.layer_norm_plain(x, g, b) * w).sum(), (x, g, b))
        for a, e in zip(got, want):
            torch.testing.assert_close(a, e, rtol=2e-4, atol=2e-4)
        q, k, v = (_randn(dev, 2, 200, 3, 64, seed=s).requires_grad_(True)
                   for s in (20, 21, 22))
        w = _randn(dev, 2, 200, 3, 64, seed=23)
        for causal in (False, True):
            got = torch.autograd.grad(
                (registry.get("flash_attention")(q, k, v, is_causal=causal)
                 * w).sum(), (q, k, v))
            want = torch.autograd.grad(
                (ck.flash_attention_plain(q, k, v, causal)[0] * w).sum(),
                (q, k, v))
            for a, e in zip(got, want):
                torch.testing.assert_close(a, e, rtol=2e-4, atol=2e-4)
    finally:
        ck.uninstall_platform_overrides()


# the BN+leaky probe's kernels: the sums against an fp64 sum within 1e-5
# of sum|x| (sum of squares: 1e-5 relative), the same bits on a second
# run; the apply within 1e-6 relative in fp32 and one ulp in bf16 (both
# round the exact x*scale+shift once), NaN where the plain version has it
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,m", [(1, 1), (16, 7), (3, 4099),
                                 (16, 1_000_003), (1024, 5000)])
def test_bn_stats_kernel_matches_fp64(dev, dtype, c, m):
    x = _randn(dev, c, m, dtype=dtype, seed=24) * 1.5 + 0.25
    ck.reset_counts()
    s, q = ck.bn_stats(x)
    assert ck.LAUNCHES["bn_stats"] == 1
    assert s.dtype == q.dtype == torch.float32 and s.shape == (c,)
    x64 = x.double()
    s64, q64 = x64.sum(1), x64.square().sum(1)
    assert bool(((s.double() - s64).abs()
                 <= 1e-5 * x64.abs().sum(1)).all())
    assert bool(((q.double() - q64).abs() <= 1e-5 * q64).all())
    s2, q2 = ck.bn_stats(x)
    assert torch.equal(s, s2) and torch.equal(q, q2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,m", [(1, 1), (16, 7), (3, 4099),
                                 (16, 1_000_003)])
def test_bn_apply_leaky_kernel_matches_plain(dev, dtype, c, m):
    x = _randn(dev, c, m, dtype=dtype, seed=25) * 2
    sc = _randn(dev, c, seed=26) + 1
    sh = _randn(dev, c, seed=27)
    ck.reset_counts()
    y = ck.bn_apply_leaky(x, sc, sh, 0.1)
    assert ck.LAUNCHES["bn_apply_leaky"] == 1 and y.dtype == dtype
    rel = 1e-6 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(y, ck.bn_apply_leaky_plain(x, sc, sh, 0.1),
                               rtol=rel, atol=0)
    # x and y at different offsets modulo 16 bytes: the one-element path
    xs = x.reshape(-1)[1:].reshape(-1)[: c * m - 1]
    if xs.numel():
        xs = xs.reshape(1, -1)
        torch.testing.assert_close(
            ck.bn_apply_leaky(xs, sc[:1], sh[:1], 0.1),
            ck.bn_apply_leaky_plain(xs, sc[:1], sh[:1], 0.1), rtol=rel,
            atol=0)


def test_bn_kernels_keep_nan(dev):
    x = _randn(dev, 4, 10_000, dtype=torch.bfloat16, seed=28)
    x[2, 1234] = float("nan")
    s, q = ck.bn_stats(x)
    assert bool(torch.isnan(s[2])) and bool(torch.isnan(q[2]))
    assert bool(torch.isfinite(s[[0, 1, 3]]).all())
    y = ck.bn_apply_leaky(x, torch.ones(4, device=dev),
                          torch.zeros(4, device=dev), 0.1)
    assert int(torch.isnan(y).sum()) == 1 and bool(torch.isnan(y[2, 1234]))
    with pytest.raises(ValueError, match="float32"):
        ck.bn_apply_leaky(x, torch.ones(4, device=dev, dtype=torch.bfloat16),
                          torch.zeros(4, device=dev), 0.1)
    with pytest.raises(ValueError, match="contiguous"):
        ck.bn_stats(x.t())


def test_a_capture_leaves_another_servers_replays_right(dev):
    """v2 of a registry captures its graphs while v1 serves from its own
    (thread-local captures, one pool a server): v1's answers during the
    capture, and v2's after the roll, equal a direct argmax."""
    cfg = ttr.TransformerConfig.tiny(d_model=128, n_heads=2,
                                     use_flash_attention=True)
    lms = {1: ttr.TransformerLM(cfg, seed=0), 2: ttr.TransformerLM(cfg,
                                                                   seed=1)}
    ck.install_platform_overrides()
    cc.reset_stats()
    reg = ModelRegistry(batch_limit=8, input_dtype=np.int32, head="argmax")
    rng = np.random.default_rng(3)
    reqs = [rng.integers(0, 1024, (1 + i % 4, 64), dtype=np.int32)
            for i in range(200)]
    try:
        reg.load("m", lms[1].logits, shapes=[(64,)])
        served = []
        stop = threading.Event()

        def traffic():
            after = 0
            for i in range(100000):
                r = reqs[i % len(reqs)]
                req = reg.submit("m", r)
                served.append((r, req.server, req.get(60)))
                after += stop.is_set()
                if after > 20:
                    return
        th = threading.Thread(target=traffic)
        th.start()
        reg.load("m", lms[2].logits)             # captures under traffic
        reg.roll("m")
        stop.set()
        th.join(120)
        assert not th.is_alive()
        assert {s for _, s, _ in served} == {"m:v1", "m:v2"}
        for r, server, got in served:
            lm = lms[int(server[-1])]
            want = lm.logits(r).argmax(-1).to(torch.int32).cpu().numpy()
            assert (got == want).mean() >= 0.99, server
        for v in (1, 2):
            assert reg.server("m", v).recompiles_after_warmup() == 0
            assert reg.server("m", v).captures_after_warmup() == 0
        assert cc.cache_stats()["capture_failures"] == 0
    finally:
        reg.close()
        ck.uninstall_platform_overrides()


def test_a_capture_does_not_wait_for_the_card(dev):
    """Capturing a signature (warm-up runs on a side stream, then the
    recording) while another stream runs a long spin returns before the
    spin ends: nothing in it synchronizes the card. The replay equals the
    eager call to the bit."""
    w = _randn(dev, 256, 256, seed=1) * 0.1
    x = _randn(dev, 32, 256, seed=2)

    def fn(a):
        return torch.tanh(a @ w) * 2 + a

    want = fn(x)
    d = cc.CachedDispatch(fn, "test:no_sync", always_capture=True)
    torch.cuda.synchronize()
    busy = torch.cuda.Stream(dev)
    spun = torch.cuda.Event()
    with torch.cuda.stream(busy):
        torch.cuda._sleep(2_000_000_000)      # about a second
        spun.record()
    try:
        d.warm(x)
        assert not spun.query(), "the capture waited for the spin"
        assert d.warmed_signatures() == 1
    finally:
        spun.synchronize()
    got = d(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert cc.cache_stats()["capture_failures"] == 0


# ----------------------------------------- dropout, VGG-like and Darknet19
def test_dropout_masks_drawn_in_a_graph_equal_eager(dev):
    """The mask is a function of (seed, clock, layer): a captured draw
    replayed on an advancing device clock gives the eager masks, new ones
    each step, and the CPU's bits."""
    clock = torch.zeros((), dtype=torch.int32, device=dev)

    def draw():
        return norm_ops.dropout_mask(norm_ops.StepKey(9, clock).fold(3),
                                     (33, 1000), 0.5, dev)
    eager = []
    for t in range(4):
        clock.fill_(t)
        eager.append(draw())
    clock.zero_()
    out = torch.empty((33, 1000), dtype=torch.bool, device=dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out.copy_(draw())
        clock.add_(1)
    for t in range(4):
        graph.replay()
        assert torch.equal(out, eager[t]), t
    assert not any(torch.equal(a, b) for a, b in zip(eager, eager[1:]))
    cpu = norm_ops.dropout_mask(norm_ops.StepKey(9, 2).fold(3), (33, 1000),
                                0.5, "cpu")
    assert torch.equal(eager[2].cpu(), cpu)


def _vgg_like():
    b = (NeuralNetConfiguration.Builder().seed(5).updater(Adam(1e-3))
         .weightInit("relu").list())
    b = zoo._vgg_blocks(b, [(1, 8), (2, 16)])
    return MultiLayerNetwork(
        b.layer(tlayers.DenseLayer(nOut=64, activation="relu", dropOut=0.5))
        .layer(tlayers.DenseLayer(nOut=64, activation="relu", dropOut=0.5))
        .layer(tlayers.OutputLayer(nOut=10, lossFunction="mcxent"))
        .setInputType(InputType.convolutional(16, 16, 3)).build())


def test_captured_vgg_like_fit_with_dropout_equals_eager(dev):
    """Two K=4 captured dispatches equal 8 eager steps to the bit, the
    dropout masks included: the second dispatch draws the masks of steps
    5-8, not the first dispatch's again."""
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        net = _vgg_like().init()
        net.setPrecisionPolicy("bf16")
        net.setComputeLayout("NHWC")
        rng = np.random.default_rng(0)
        batches = [DataSet(
            torch.from_numpy(rng.standard_normal((8, 3, 16, 16)).astype(
                np.float32)).to(dev),
            torch.from_numpy(np.eye(10, dtype=np.float32)[
                rng.integers(0, 10, 8)]).to(dev)) for _ in range(8)]
        net._ensure_opt_state()
        net._ensure_clock()
        s0 = [t.detach().clone() for t in net._dispatch_state()]
        eager = []
        for ds in batches:
            net.fit(ds)
            eager.append(net.score())
        want = [t.detach().clone() for t in net._dispatch_state()]
        with torch.no_grad():
            for t, v in zip(net._dispatch_state(), s0):
                t.copy_(v)
        cc.reset_stats()
        cc.warmup(net, [((8, 3, 16, 16), (8, 10))], steps_per_dispatch=4)
        losses = []
        for k in (0, 4):
            losses += net._fit_mega(
                stepping.stack_megabatch(batches[k:k + 4])).tolist()
        assert cc.cache_stats()["capture_failures"] == 0
        assert cc.cache_stats()["compile_seconds"]["cold_compiles"] == 1
        assert losses == eager
        got = net._dispatch_state()
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(a, b), i
    finally:
        torch.backends.cudnn.deterministic = deterministic


def test_darknet19_takes_18_epilogue_launches_a_forward(dev):
    ck.install_platform_overrides()
    try:
        net = zoo.Darknet19(num_classes=10, input_shape=(3, 64, 64)).init()
        net.setPrecisionPolicy("bf16")
        net.setComputeLayout("NHWC")
        net.setEpilogueFusion(True)
        x = _randn(dev, 4, 3, 64, 64, seed=30)
        ck.reset_counts()
        out = net.output(x)
        assert ck.LAUNCHES["scale_shift_act"] == 18
        assert not any(ck.PLAIN_CALLS.values())
        assert out.shape == (4, 10) and bool(torch.isfinite(out).all())
        cc.warmup(net, [((4, 3, 64, 64), (4, 10))], steps_per_dispatch=4)
        assert net._step_for(False, 4).launches_at_capture() == \
            [{"scale_shift_act": 72}]
    finally:
        ck.uninstall_platform_overrides()


def test_a_collection_during_a_capture_frees_no_graph(dev):
    """A captured graph kept alive only by a reference cycle (as a network
    and its dispatches are) is freed by the cyclic collector; a collection
    that an allocation sets off inside another capture would free it
    there, and freeing a graph on the capturing thread invalidates the
    capture. Here the old graph's last holder becomes a young garbage
    cycle inside the capture while collections are due at every
    allocation: captures run with the collector off, so the new graph
    captures."""
    import gc
    old = cc.CachedDispatch(lambda x: x * 2, "old", always_capture=True)
    old(torch.ones(8, device=dev))
    assert old.warmed_signatures() == 1
    box = [old]
    del old

    def step(x):
        if torch.cuda.is_current_stream_capturing() and box:
            cycle = {"dispatch": box.pop()}     # the old graph's last holder
            cycle["self"] = cycle
            del cycle
        junk = [[i] for i in range(2000)]       # allocations: collections due
        return x + len(junk)
    new = cc.CachedDispatch(step, "new", always_capture=True)
    cc.reset_stats()
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        out = new(torch.ones(8, device=dev))
    finally:
        gc.set_threshold(*thresholds)
    assert not box and gc.isenabled()
    assert cc.cache_stats()["capture_failures"] == 0
    assert new.warmed_signatures() == 1
    assert torch.equal(out, torch.full((8,), 2001.0, device=dev))
    gc.collect()


def test_captured_tbptt_windows_equal_eager(dev):
    """A small TextGenerationLSTM: three windows a batch through the
    captured window step give the eager run's params, Adam moments and
    carried state to the bit; streaming equals output()."""
    r = np.random.default_rng(31)
    idx = r.integers(0, 11, (4, 25))
    eye = np.eye(11, dtype=np.float32)
    x = torch.from_numpy(eye[idx[:, :-1]].transpose(0, 2, 1).copy()).to(dev)
    y = torch.from_numpy(eye[idx[:, 1:]].transpose(0, 2, 1).copy()).to(dev)
    net = zoo.TextGenerationLSTM(vocab_size=11, input_shape=(11, 24)).init()
    net._ensure_opt_state()
    net._ensure_clock()
    s0 = [t.detach().clone() for t in net._dispatch_state()]
    runs = []
    for captured in (False, True):
        with torch.no_grad():
            for t, v in zip(net._dispatch_state(), s0):
                t.copy_(v)
        if captured:
            cc.reset_stats()
            cc.warmup(net, [(tuple(x.shape), tuple(y.shape))],
                      tbptt_length=8)
            assert all(torch.equal(a, b)
                       for a, b in zip(net._dispatch_state(), s0))
        carry, losses = net._zero_carry(x), []
        for start in range(0, 24, 8):
            out = net._fit_window(x[:, :, start:start + 8],
                                  y[:, :, start:start + 8], None, carry)
            losses.append(float(out[0]))
            carry = out[1:]
        runs.append((losses, [t.detach().clone()
                              for t in net._dispatch_state()],
                     [c.clone() for c in carry]))
    stats = cc.cache_stats()
    assert stats["capture_failures"] == 0
    assert stats["compile_seconds"]["cold_compiles"] == 1
    assert stats["memory"]["hits"] == 3
    (l1, s1, c1), (l2, s2, c2) = runs
    assert l1 == l2
    assert all(torch.equal(a, b) for a, b in zip(s1, s2))
    assert all(torch.equal(a, b) for a, b in zip(c1, c2))
    full = net.output(x)
    net.rnnClearPreviousState()
    parts = [net.rnnTimeStep(x[:, :, i:i + 7]) for i in range(0, 24, 7)]
    torch.testing.assert_close(torch.cat(parts, dim=2), full, rtol=1e-5,
                               atol=1e-5)


def test_prefetcher_stages_host_batches_on_a_side_stream(dev):
    """Host megabatches through the DevicePrefetcher on the card: each
    arrives whole although the compute stream is busy when it is taken
    and the page-locked ring (depth 2) is reused across 8 items; the
    staging ran on a stream of its own."""
    from deeplearning4j_tpu_torch.data.dataset import (DevicePrefetcher,
                                                       reset_h2d_counts,
                                                       H2D_COPIES)
    r = np.random.default_rng(0)
    host = [DataSet(r.integers(0, 255, (4, 3, 32, 32), dtype=np.uint8),
                    r.standard_normal((4, 5)).astype(np.float32))
            for _ in range(16)]
    reset_h2d_counts()
    pf = DevicePrefetcher(host, steps_per_dispatch=2, prefetch=2,
                          device=dev)
    got = []
    for mb in pf:
        torch.cuda._sleep(2_000_000)        # the compute stream is busy
        got.append((mb.features.clone(), mb.labels.clone()))
    pf.close()
    assert pf._stager._stream is not None
    assert pf._stager._stream != torch.cuda.current_stream(dev)
    assert H2D_COPIES == {((2, 4, 3, 32, 32), "uint8"): 8,
                          ((2, 4, 5), "float32"): 8}
    for j, (f, y) in enumerate(got):
        want = stepping.stack_megabatch(host[2 * j:2 * j + 2])
        assert f.is_cuda and f.dtype == torch.uint8
        assert np.array_equal(f.cpu().numpy(), want.features)
        assert np.array_equal(y.cpu().numpy(), want.labels)


def test_fit_with_prefetch_equals_sync_staging_on_the_card(dev):
    """ComputationGraph.fit(K=2) on uint8 batches with prefetch=2 (side
    stream, pinned buffers, captured megastep) equals prefetch=0 to the
    bit (cuDNN held to deterministic algorithms)."""
    from deeplearning4j_tpu_torch.nn import graph as tgraph
    r = np.random.default_rng(1)
    data = [DataSet(r.integers(0, 255, (8, 3, 16, 16), dtype=np.uint8),
                    np.eye(3, dtype=np.float32)[r.integers(0, 3, 8)])
            for _ in range(6)]

    def net():
        g = (NeuralNetConfiguration.Builder().seed(2).weightInit("relu")
             .updater(Adam(1e-2)).graphBuilder().addInputs("in")
             .setInputTypes(InputType.convolutional(16, 16, 3)))
        g.addLayer("c", tlayers.ConvolutionLayer(
            kernelSize=(3, 3), nOut=8, activation="identity"), "in")
        g.addLayer("bn", tlayers.BatchNormalization(), "c")
        g.addLayer("r", tlayers.ActivationLayer("relu"), "bn")
        g.addLayer("p", tlayers.GlobalPoolingLayer("avg"), "r")
        g.addLayer("o", tlayers.OutputLayer(nOut=3, lossFunction="mcxent",
                                            activation="softmax"), "p")
        g.setOutputs("o")
        n = tgraph.ComputationGraph(g.build()).init(device=dev)
        n.setPrecisionPolicy("bf16")
        n.setComputeLayout("NHWC")
        n.setEpilogueFusion(True)
        return n
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        states = []
        for prefetch in (2, 0):
            n = net()
            n.fit(data, epochs=2, steps_per_dispatch=2, prefetch=prefetch)
            assert n.getIterationCount() == 12
            states.append([t.clone() for t in n._dispatch_state()])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    assert all(torch.equal(a, b) for a, b in zip(*states))


def _small_bert_files(tmp_path):
    from deeplearning4j_tpu_torch.modelimport import tf_fixtures as fx
    w = fx.bert_weights(0, V=99, E=128, L=2, F=256, P=64)
    paths = {}
    for fmt, state in (("hf", fx.hf_state(w)), ("tf", w)):
        paths[fmt] = str(tmp_path / f"{fmt}.bin")
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                    for k, v in state.items()}, paths[fmt])
    return w, paths


def test_imported_bert_runs_the_fp32_kernels_on_the_card(dev, tmp_path):
    """Path A: a checkpoint import's encode launches 2L+1 layer norms and
    L fp32 flash kernels (the CUDA-core route), and agrees with the plain
    versions and with the same import on the CPU."""
    from deeplearning4j_tpu_torch.modelimport.bert import (
        importBertModelAndWeights)
    _, paths = _small_bert_files(tmp_path)
    ck.install_platform_overrides()
    cfg, params = importBertModelAndWeights(paths["tf"], n_heads=2,
                                            use_flash_attention=True)
    _, params_hf = importBertModelAndWeights(paths["hf"], n_heads=2,
                                             use_flash_attention=True)
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        ttr._leaf_paths(params), ttr._leaf_paths(params_hf)))
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, 99, (4, 64))).to(dev)
    ck.reset_counts()
    with torch.no_grad():
        x = ttr.encode(params, tok, cfg)
    assert ck.LAUNCHES["layer_norm"] == 5 and \
        ck.FLASH_ROUTES == {"tensor_core": 0, "cuda_core": 2}
    cfg_c, params_c = importBertModelAndWeights(paths["tf"], device="cpu",
                                                n_heads=2)
    with torch.no_grad():
        want = ttr.encode(params_c, tok.cpu(), cfg_c)
    torch.testing.assert_close(x.cpu(), want, rtol=1e-4, atol=1e-4)


def test_imported_graph_def_on_the_card_equals_the_cpu(dev, tmp_path):
    """Path B: the frozen GraphDef imports onto the card and gives the
    CPU import's logits; it launches no hand-written kernel."""
    from deeplearning4j_tpu_torch.modelimport import tf_fixtures as fx
    from deeplearning4j_tpu_torch.modelimport.tensorflow import (
        importTensorflowGraph)
    w, _ = _small_bert_files(tmp_path)
    gd = fx.bert_graph_def(w, T=64, H=2)
    ids = np.random.default_rng(0).integers(0, 99, (4, 64)).astype(np.int32)
    ck.install_platform_overrides()
    ck.reset_counts()
    got = importTensorflowGraph(gd).output({"input_ids": ids}, ["logits"])
    assert not any(ck.LAUNCHES.values())
    want = importTensorflowGraph(gd, device="cpu").output(
        {"input_ids": ids}, ["logits"])
    torch.testing.assert_close(got["logits"].cpu(), want["logits"],
                               rtol=1e-4, atol=1e-5)


# ------------------------------------------------- a long run's surroundings
def _small_mlp(updater=None):
    conf = (NeuralNetConfiguration.Builder().seed(3)
            .updater(updater or Adam(1e-2)).list()
            .layer(tlayers.DenseLayer(nOut=16, activation="relu"))
            .layer(tlayers.OutputLayer(nOut=3, lossFunction="mcxent",
                                       activation="softmax"))
            .setInputType(InputType.feedForward(8)).build())
    return MultiLayerNetwork(conf).init()


def _list_iterator(dev, n=40, b=4):
    from deeplearning4j_tpu_torch.data.dataset import ListDataSetIterator
    rng = np.random.default_rng(1)
    x = rng.standard_normal((n, 8)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, n)]
    return ListDataSetIterator(DataSet(x, y), b)


def test_a_restore_keeps_the_storage_and_captures_nothing_again(dev,
                                                                 tmp_path):
    from deeplearning4j_tpu_torch.faults import FaultPlan
    from deeplearning4j_tpu_torch.train import resilience as res
    net = _small_mlp()
    cfg = res.CheckpointConfig(str(tmp_path), every_steps=4, keep_last=5)
    cc.reset_stats()
    net.fit(_list_iterator(dev), steps_per_dispatch=2, checkpoint=cfg)
    ptrs = [t.data_ptr() for t in net._dispatch_state()]
    saved = [t.detach().clone() for t in net._dispatch_state()]
    res.CheckpointManager(cfg).save(net)
    captures = cc.cache_stats()["compile_seconds"]["cold_compiles"]
    net.fit(_list_iterator(dev), steps_per_dispatch=2, checkpoint=cfg,
            nan_policy=res.NanPolicy.ROLLBACK,
            faults=FaultPlan(nan_grads_at=[2]))
    res.CheckpointManager(cfg).restore(net, step=10)
    assert [t.data_ptr() for t in net._dispatch_state()] == ptrs
    for a, b in zip(net._dispatch_state(), saved):
        assert torch.equal(a, b)
    stats = cc.cache_stats()
    assert stats["capture_failures"] == 0
    assert stats["compile_seconds"]["cold_compiles"] == captures


def test_backoff_lr_replays_the_same_graph(dev):
    from deeplearning4j_tpu_torch.faults import FaultPlan
    from deeplearning4j_tpu_torch.train import resilience as res
    from deeplearning4j_tpu_torch.train.updaters import Sgd
    net = _small_mlp(Sgd(0.1))
    cc.reset_stats()
    net.fit(_list_iterator(dev), steps_per_dispatch=2,
            nan_policy=res.NanRecovery(res.NanPolicy.BACKOFF_LR,
                                       cooldown_steps=100),
            faults=FaultPlan(nan_grads_at=[5]))
    scale = net.conf.base.updater._lr_scale
    ptr = scale.data_ptr()
    assert scale.is_cuda and float(scale) == 0.5 and net.lr_scale() == 0.5
    d = net._step_cache[(False, False, 2, "lr_scale")]
    assert d.captures() == 1
    # the graph reads the scale in place: half the rate from here on
    p0 = [t.detach().clone() for t in net._snapshot_tensors()]
    ref = _small_mlp(Sgd(0.05))
    with torch.no_grad():
        for t, v in zip(ref._snapshot_tensors(), p0):
            t.copy_(v)
    batches = _list_iterator(dev, n=8)
    net.fit(batches, steps_per_dispatch=2)
    ref.fit(batches, steps_per_dispatch=2)
    assert d.captures() == 1 and scale.data_ptr() == ptr
    for a, b in zip(net._snapshot_tensors(), ref._snapshot_tensors()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    assert cc.cache_stats()["capture_failures"] == 0


def test_a_dynamic_scale_megastep_captures(dev):
    from deeplearning4j_tpu_torch.nn.precision import PrecisionPolicy
    net = _small_mlp()
    net.setPrecisionPolicy(PrecisionPolicy(
        "fp16", loss_scale="dynamic", loss_scale_init=2.0 ** 30,
        growth_interval=2))
    rng = np.random.default_rng(2)
    batches = [DataSet(torch.from_numpy(rng.standard_normal(
        (4, 8)).astype(np.float32)).to(dev), torch.from_numpy(np.eye(
            3, dtype=np.float32)[rng.integers(0, 3, 4)]).to(dev))
        for _ in range(8)]
    cc.reset_stats()
    net.fit(batches, steps_per_dispatch=4)
    stats = cc.cache_stats()
    assert stats["capture_failures"] == 0
    assert stats["compile_seconds"]["cold_compiles"] == 1
    scale = net.current_loss_scale()
    assert scale < 2.0 ** 30 and np.isfinite(net.score())
    # the same steps eagerly give the same automaton
    eager = _small_mlp()
    eager.setPrecisionPolicy(net._precision)
    for ds in batches:
        eager.fit(ds)
    assert eager.current_loss_scale() == scale
    assert torch.equal(eager._scale_state, net._scale_state)


def test_the_crop_launches_a_fixed_number_of_kernels(dev):
    """The kernel launches of one crop + flip call, counted where the CUDA
    runtime reports them on the launching thread (``cudaLaunchKernel``
    events of the CPU activity). The device activity records lose some of
    a call's kernels in a few calls of 300 (23 to all 122 of them, at
    either batch: ``benchmarks/probe_crop_events.py``), while the runtime
    reports 122 launches in every call; counting those keeps the
    equality and drops the profiler's losses."""
    from deeplearning4j_tpu_torch.nn.augment import DeviceAugmentation
    a = DeviceAugmentation(7).crop(32).random_flip()
    t = torch.tensor(3, dtype=torch.int32, device=dev)
    counts = []
    for b in (2, 64):
        x = torch.randint(0, 256, (b, 3, 256, 256), dtype=torch.uint8,
                          device=dev)
        a.apply(x, a.step_key(t))
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU,
                            torch.profiler.ProfilerActivity.CUDA]) as prof:
            out = a.apply(x, a.step_key(t))
            torch.cuda.synchronize()
        assert out.shape == (b, 3, 224, 224) and out.dtype == torch.float32
        counts.append(sum(
            e.device_type == torch.autograd.DeviceType.CPU
            and e.name.startswith(("cudaLaunchKernel", "cuLaunchKernel"))
            for e in prof.events()))
    assert 0 < counts[0] == counts[1], counts


def test_imported_keras_encoder_on_the_card(dev, tmp_path):
    """The fixture Keras encoder (E=64, L=2, T=16) imported onto the card
    with the kernels installed: 5 layer-norm launches a forward (1 + 2 a
    block; no flash below T=1024), output within 1e-4 of the same file
    imported on the CPU."""
    from deeplearning4j_tpu_torch.modelimport import keras_fixtures as kf
    from deeplearning4j_tpu_torch.modelimport.keras import \
        importKerasModelAndWeights
    path = str(tmp_path / "enc.h5")
    kf.encoder_h5(path, 0, V=100, P=16, E=64, H=1, L=2, F=128)
    rng = np.random.default_rng(0)
    tok = rng.integers(0, 100, (4, 16)).astype(np.int32)
    pos = np.tile(np.arange(16, dtype=np.int32), (4, 1))
    cpu = importKerasModelAndWeights(path, device="cpu")
    want = cpu.output([tok, pos]).numpy()
    ck.install_platform_overrides()
    try:
        net = importKerasModelAndWeights(path)
        ck.reset_counts()
        got = net.output([tok, pos])
        torch.cuda.synchronize()
        assert ck.LAUNCHES["layer_norm"] == 5
        assert ck.LAUNCHES["flash_attention"] == 0
        assert not any(ck.PLAIN_CALLS.values())
    finally:
        ck.uninstall_platform_overrides()
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-4, atol=1e-4)


# ------------------------------------- ONNX import and transfer learning
def test_imported_onnx_resnet_on_the_card_equals_the_cpu(dev, tmp_path):
    """A narrow ResNet-50 (2 blocks a stage, 32^2) written as ONNX,
    imported onto the card: logits within 1e-4 of the CPU import's (fp32,
    TF32 off), no hand-written kernel launched, and a served capture that
    replays them."""
    from deeplearning4j_tpu_torch.modelimport import onnx_fixtures as fx
    from deeplearning4j_tpu_torch.modelimport.onnx import importOnnxModel
    from deeplearning4j_tpu_torch.serving import samediff_forward
    net = fx.SmallResNet50(num_classes=10, input_shape=(3, 32, 32)).init(
        device="cpu")
    fx.randomize_batch_norm(net, seed=0)
    path = fx.write_resnet50(net, str(tmp_path / "r.onnx"))
    x = np.random.default_rng(0).standard_normal(
        (4, 3, 32, 32)).astype(np.float32)
    want = importOnnxModel(path, device="cpu").output(
        {"input": x}, ["logits"])["logits"].numpy()
    sd = importOnnxModel(path)
    ck.reset_counts()
    got = sd.output({"input": x}, ["logits"])["logits"]
    assert not any(ck.LAUNCHES.values())
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=1e-4,
                               atol=1e-4)
    server = ModelServer(samediff_forward(sd, ["logits"]), batch_limit=4,
                         input_dtype=np.float32)
    try:
        cc.reset_stats()
        server.warmup([(3, 32, 32)])
        assert not cc.cache_stats()["capture_failures"]
        served = server.output(x)
    finally:
        server.close()
    np.testing.assert_allclose(served, want, rtol=1e-4, atol=1e-4)


def test_frozen_tiny_yolo_captured_equals_eager(dev):
    """A transfer-learned TinyYOLO (64^2, 3 -> 2 classes, the prefix
    frozen, bf16/NHWC/fused): 8 scale_shift_act launches a forward, the
    K=2 capture records 16, the frozen params and Adam moments keep their
    bits, and 2 captured steps equal 2 eager ones (deterministic cuDNN)."""
    from deeplearning4j_tpu_torch.nn.objdetect import (Yolo2OutputLayer,
                                                       yolo_labels)
    from deeplearning4j_tpu_torch.nn.transfer import (FineTuneConfiguration,
                                                      TransferLearning)
    ck.install_platform_overrides()
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        src = zoo.TinyYOLO(num_classes=3, input_shape=(3, 64, 64)).init()
        src.setComputeLayout("NHWC")
        net = (TransferLearning.Builder(src)
               .fineTuneConfiguration(FineTuneConfiguration.Builder()
                                      .updater(Adam(1e-3)).build())
               .setFeatureExtractor(len(src.layers) - 3)
               .removeLayersFromOutput(2)
               .addLayer(tlayers.ConvolutionLayer(kernelSize=(1, 1),
                                                  nOut=5 * 7))
               .addLayer(Yolo2OutputLayer(
                   boundingBoxPriors=zoo.TinyYOLO.ANCHORS)).build())
        net.setPrecisionPolicy("bf16")
        net.setEpilogueFusion(True)
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal(
            (4, 3, 64, 64)).astype(np.float32)).to(dev)
        y = torch.from_numpy(yolo_labels(rng, 4, 2, grid=2)).to(dev)
        ds = DataSet(x, y)
        net._ensure_opt_state()
        net._ensure_clock()
        frozen = [t for i in net._frozen_layers
                  for t in list(net._params[i].values())
                  + [v for st in net._opt_state[i].values()
                     for v in st.values()]]
        f0 = [t.detach().clone() for t in frozen]
        s0 = [t.detach().clone() for t in net._dispatch_state()]
        ck.reset_counts()
        net.fit(ds)
        assert ck.LAUNCHES["scale_shift_act"] == 8
        net.fit(ds)
        eager = [t.detach().clone() for t in net._dispatch_state()]
        with torch.no_grad():
            for t, v in zip(net._dispatch_state(), s0):
                t.copy_(v)
        cc.warmup(net, [(tuple(x.shape), tuple(y.shape))],
                  steps_per_dispatch=2)
        assert net._step_for(False, 2).launches_at_capture() == \
            [{"scale_shift_act": 16}]
        net._fit_mega(stepping.stack_megabatch([ds, ds]))
        for a, b in zip(net._dispatch_state(), eager):
            assert torch.equal(a, b)
        assert all(torch.equal(a, b) for a, b in zip(frozen, f0))
    finally:
        torch.backends.cudnn.deterministic = det
        ck.uninstall_platform_overrides()


def test_samediff_layer_captured_equals_eager(dev):
    """The gated dense SameDiffLayer (64 -> 64) in a network: one captured
    dispatch of 2 steps equals 2 eager steps to the bit, no failure."""
    class Gated(tlayers.SameDiffLayer):
        def defineParameters(self):
            return {"W": (self.nIn, self.nOut), "Wg": (self.nIn, self.nOut)}

        def defineLayer(self, sd, layerInput, paramTable, mask=None):
            return layerInput.mmul(paramTable["W"]).tanh() * \
                layerInput.mmul(paramTable["Wg"]).sigmoid()

    net = MultiLayerNetwork(
        NeuralNetConfiguration.Builder().seed(1).updater(Adam(1e-3))
        .weightInit("xavier").list().layer(Gated(nOut=64))
        .layer(tlayers.OutputLayer(nOut=4, lossFunction="mcxent",
                                   activation="softmax"))
        .setInputType(InputType.feedForward(64)).build()).init()
    x = _randn(dev, 16, 64)
    y = torch.eye(4, device=dev)[torch.arange(16, device=dev) % 4]
    ds = DataSet(x, y)
    net._ensure_opt_state()
    net._ensure_clock()
    s0 = [t.detach().clone() for t in net._dispatch_state()]
    net.fit(ds)
    net.fit(ds)
    eager = [t.detach().clone() for t in net._dispatch_state()]
    with torch.no_grad():
        for t, v in zip(net._dispatch_state(), s0):
            t.copy_(v)
    cc.reset_stats()
    cc.warmup(net, [(tuple(x.shape), tuple(y.shape))], steps_per_dispatch=2)
    net._fit_mega(stepping.stack_megabatch([ds, ds]))
    assert not cc.cache_stats()["capture_failures"]
    for a, b in zip(net._dispatch_state(), eager):
        assert torch.equal(a, b)


def _fused_conv_net(dev):
    net = MultiLayerNetwork(
        NeuralNetConfiguration.Builder().seed(3).updater(Adam(1e-3))
        .weightInit("relu").list()
        .layer(tlayers.ConvolutionLayer(kernelSize=(3, 3), padding=(1, 1),
                                        nOut=16, activation="identity"))
        .layer(tlayers.BatchNormalization())
        .layer(tlayers.ActivationLayer("relu"))
        .layer(tlayers.ConvolutionLayer(kernelSize=(3, 3), padding=(1, 1),
                                        nOut=16, activation="identity"))
        .layer(tlayers.BatchNormalization())
        .layer(tlayers.ActivationLayer("relu"))
        .layer(tlayers.GlobalPoolingLayer("avg"))
        .layer(tlayers.OutputLayer(nOut=4, lossFunction="mcxent",
                                   activation="softmax"))
        .setInputType(InputType.convolutional(16, 16, 3)).build()).init()
    net.setPrecisionPolicy("bf16")
    net.setComputeLayout("NHWC")
    net.setEpilogueFusion(True)
    return net


def test_devicetime_trace_puts_the_epilogues_in_the_bn_scopes(dev):
    """torch.profiler on the card: every layer's kernels land in its
    dl4j_L scope; the two fused epilogues' scale_shift_act launches in
    the BN scopes, once a forward."""
    from deeplearning4j_tpu_torch.profiler import devicetime
    ck.install_platform_overrides()
    try:
        net = _fused_conv_net(dev)
        x = _randn(dev, 8, 3, 16, 16)
        table = devicetime.measure(net, x, reps=2, mode="trace")
    finally:
        ck.uninstall_platform_overrides()
    assert table.source == "trace"
    rows = {r.layer: r for r in table.rows}
    assert rows["convolutionlayer_0"].seconds > 0
    bn = [r.layer for r in table.rows if r.op == "batch_norm"]
    assert len(bn) == 2
    got = sum(c for n in bn for k, c in table.launches.get(n, {}).items()
              if "scale_shift_act" in k)
    assert got == 2


def test_nan_panic_names_a_nan_batch_under_capture(dev):
    """K=2 captured dispatches under NAN_PANIC: a NaN batch at step 3 is
    named (<input>, batch, 3) by the replay, and the live state after the
    raise is a twin's with the mode off, to the bit."""
    from deeplearning4j_tpu_torch import profiler as prof
    from deeplearning4j_tpu_torch.profiler import sanitizer as san
    ck.install_platform_overrides()
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        x = _randn(dev, 8, 3, 16, 16)
        y = torch.eye(4, device=dev)[torch.arange(8, device=dev) % 4]
        xn = x.clone()
        xn[0, 0, 0, 0] = float("nan")
        batches = [DataSet(x, y)] * 2 + [DataSet(xn, y)] + [DataSet(x, y)]
        net, twin = _fused_conv_net(dev), _fused_conv_net(dev)
        prof.set_profiling_mode(prof.ProfilingMode.NAN_PANIC)
        try:
            with pytest.raises(san.NonfiniteAttributionError) as ei:
                net.fit(batches, steps_per_dispatch=2, prefetch=0)
        finally:
            prof.set_profiling_mode(None)
        assert (ei.value.layer, ei.value.op, ei.value.step) == \
            ("<input>", "batch", 3)
        twin.fit(batches, steps_per_dispatch=2, prefetch=0)
        for a, b in zip(net._dispatch_state(), twin._dispatch_state()):
            if a.is_floating_point():
                it = {2: torch.int16, 4: torch.int32}[a.element_size()]
                assert torch.equal(a.detach().view(it), b.detach().view(it))
            else:
                assert torch.equal(a, b)
    finally:
        torch.backends.cudnn.deterministic = det
        ck.uninstall_platform_overrides()


# ------------------------------------------- the eager arrays and op surface
def test_ndarray_softmax_launches_the_softmax_kernel_once(dev):
    from deeplearning4j_tpu_torch.linalg import Transforms, nd
    from deeplearning4j_tpu_torch.ops import registry
    ck.install_platform_overrides()
    try:
        a = nd.create(np.random.default_rng(0).standard_normal(
            (64, 128)).astype(np.float32), device=dev)
        ck.reset_counts()
        y = Transforms.softmax(a)
        assert ck.LAUNCHES["softmax"] == 1
        assert y.device.type == "cuda"
        torch.testing.assert_close(y.tensor(), ck.softmax_plain(a.tensor()),
                                   rtol=1e-5, atol=1e-6)
        ck.reset_counts()
        registry.exec_op("softmax", a.tensor())
        assert ck.LAUNCHES["softmax"] == 1
    finally:
        ck.uninstall_platform_overrides()


def test_exec_op_results_stay_on_the_card(dev):
    from deeplearning4j_tpu_torch.ops import registry, validation
    for case in validation.all_cases():
        out = validation.run_case(case, device=dev, grad=False)
        for t in registry.tensor_leaves(out):
            assert t.device.type == "cuda", case.op


def test_nd_factory_defaults_to_the_card(dev):
    from deeplearning4j_tpu_torch.linalg import nd
    assert nd.zeros(3).device.type == "cuda"
    assert nd.rand(2, 2, rng=nd.Random(1)).device.type == "cuda"
    a = nd.create([1.0, 2.0])
    assert a.mmul(a.reshape(2, 1)).device.type == "cuda"


def _sd_mlp(rate=0.0, seed=0, lr=1e-2, width=1024):
    """A SameDiff MLP on the card: x [N, 32] -> width -> 4 (dropout at
    ``rate`` after the hidden relu), softmax cross-entropy, Adam."""
    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.train import updaters as tupd
    rng = np.random.default_rng(seed)
    sd = SameDiff.create()
    x = sd.placeHolder("x", shape=(None, 32))
    y = sd.placeHolder("y", shape=(None, 4))
    w1 = sd.var("w1", (rng.standard_normal((32, width)) * 0.1)
                .astype(np.float32))
    b1 = sd.var("b1", np.zeros(width, np.float32))
    w2 = sd.var("w2", (rng.standard_normal((width, 4)) * 0.1)
                .astype(np.float32))
    b2 = sd.var("b2", np.zeros(4, np.float32))
    h = sd.nn.relu(sd.nn.linear(x, w1, b1))
    if rate:
        h = sd.nn.dropout(h, rate)
    loss = sd.loss.softmaxCrossEntropy(y, sd.nn.linear(h, w2, b2),
                                       name="loss")
    sd.setLossVariables(loss)
    updater = tupd.Adam(lr) if lr else tupd.Sgd(0.0)
    sd.setTrainingConfig(TrainingConfig(updater=updater,
                                        data_set_feature_mapping=["x"],
                                        data_set_label_mapping=["y"]))
    return sd


def _sd_batches(n=4, b=64):
    rng = np.random.default_rng(7)
    return [{"x": rng.standard_normal((b, 32)).astype(np.float32),
             "y": np.eye(4, dtype=np.float32)[rng.integers(0, 4, b)]}
            for _ in range(n)]


def test_samediff_captured_fit_equals_eager_to_the_bit(dev):
    """One captured step replayed 4 times equals 4 eager steps from the
    same state: losses, variables, Adam moments and the clock."""
    batches = _sd_batches()
    eager = _sd_mlp(rate=0.5)
    eager._prepare_fit()
    e_losses = []
    for b in batches:
        e_losses.append(eager._train_step(eager._feed(b)))
        eager._step += 1
    cap = _sd_mlp(rate=0.5)
    cc.reset_stats()
    hist = cap.fit(batches)
    st = cc.cache_stats()
    assert st["capture_failures"] == 0 and st["eager_by_design"] == 0
    assert [d.captures() for d in cap.fit_dispatches()] == [1]
    assert st["memory"] == {"hits": 3, "misses": 1}
    assert hist.lossCurve() == torch.stack(e_losses).cpu().tolist()
    for k, v in eager._variables.items():
        assert torch.equal(cap._variables[k], v), k
        for m, s in eager._updater_state[k].items():
            assert torch.equal(cap._updater_state[k][m], s), (k, m)
    assert int(cap._t_dev) == int(eager._t_dev) == 4


def test_samediff_dropout_masks_differ_between_replays(dev):
    """With lr 0 the loss is a function of the step's mask alone: each
    replay draws a new mask (keep 0.5), and a replay from the same clock
    draws the same one."""
    sd = _sd_mlp(rate=0.5, lr=0.0, width=4096)
    x = sd.placeHolder("ones", shape=(None, 4096))
    kept = sd.nn.dropout(x, 0.5, name="kept").sum()
    sd.setLossVariables("loss", kept)
    b = _sd_batches(1)[0]
    batch = {**b, "ones": np.ones((64, 4096), np.float32)}
    first = sd.fit([batch] * 4).lossCurve()
    assert len(set(first)) == 4
    sd._step = 0
    replay = sd.fit([batch] * 4).lossCurve()
    assert replay == first
    assert [d.captures() for d in sd.fit_dispatches()] == [1]
    total = 64 * 4096
    for loss in first:
        # the kept sum is 2 x (kept count); the CE term is below 10
        keep = (loss - 10) / (2 * total)
        assert 0.49 < keep < 0.51 + 10 / (2 * total)


def test_a_manifest_written_and_replayed_in_process(dev, tmp_path):
    """A K=2 fit writes its signature; a fresh net captures it at warm
    start (a disk hit), its fit misses nothing in memory, and both nets
    train to the same bits."""
    rng = np.random.default_rng(1)
    batches = [DataSet(rng.standard_normal((16, 8)).astype(np.float32),
                       np.eye(3, dtype=np.float32)[rng.integers(0, 3, 16)])
               for _ in range(4)]
    cc.configure(str(tmp_path))
    try:
        cc.reset_stats()
        a = _small_mlp()
        a.fit(batches, steps_per_dispatch=2)
        s = cc.cache_stats()
        assert s["disk"]["misses"] == 1 and s["disk"]["entries"] == 1
        assert cc.read_manifest(a)[0]["steps"] == 2
        cc.reset_stats()
        b = _small_mlp()
        b.fit(batches, steps_per_dispatch=2)
        s = cc.cache_stats()
        assert s["disk"]["hits"] == 1 and s["disk"]["misses"] == 0
        assert s["memory"]["misses"] == 0
        assert s["compile_seconds"]["cold_compiles"] == 0
        for p, q in zip(a._dispatch_state(), b._dispatch_state()):
            assert torch.equal(p, q)
    finally:
        cc.reset_configuration()
