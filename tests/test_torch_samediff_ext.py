"""The rest of the port's SameDiff against the JAX package's (CPU).

Every op namespace method and loss records the same registry op in both
packages; each case feeds both graphs the same constants (the port's
OpValidation args for that op, from ``numpy.random.RandomState(0)``)
and compares the outputs (1e-5 fp32; 1e-4 for the linalg factorizations,
whose LAPACK paths differ). ``std``/``variance``, multi-head attention
with and without a mask, ``rename`` and listeners follow; then graphs
that cross between the packages through ``save``/``load`` with every
closure rebuilder (``std``, ``variance``, MHA) and RNG node (dropout,
``random_*``).

Random draws: the JAX package splits threefry keys, the port hashes a
counter key (``StepKey``), so the streams differ. Dropout is held by
injecting the JAX masks into the port's ``dropout_mask``; the random
ops by their moments (20,000 draws: mean within 0.02, spread within
0.02 of the distribution's).

The fit runs through the captured dispatch path (the ``fake_capture``
stand-in graph of ``test_torch_compilecache.py``) and is held against
the JAX fit over 3 Adam steps: losses 1e-5, params 1e-5 (lr 1e-2).
"""

import numpy as np
import pytest

import jax
import torch

from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu.autodiff.samediff import TrainingConfig as JTC
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
from deeplearning4j_tpu_torch.nn import compilecache as cc
from deeplearning4j_tpu_torch.ops import normalization as norm_ops
from deeplearning4j_tpu_torch.ops import validation as tval
from deeplearning4j_tpu_torch.train import updaters as tupd

from test_torch_compilecache import fake_capture  # noqa: F401

torch.set_num_threads(2)

TOL = 1e-5
LINALG_TOL = 1e-4
_CASES = {}
for _c in tval.all_cases():
    _CASES.setdefault(_c.op, _c)


def _args(op):
    c = _CASES[op]
    return list(c.args(np.random.RandomState(0))), dict(c.kwargs)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _both(arrays, build):
    """``build(sd, vars)`` on a JAX graph and a port graph over the same
    constants; returns (jax outputs, port outputs) as numpy lists."""
    res = []
    for sd in (JSameDiff.create(), SameDiff.create(device="cpu")):
        vs = [sd.constant(a, name=f"in{i}") for i, a in enumerate(arrays)]
        out = build(sd, vs)
        outs = out if isinstance(out, tuple) else (out,)
        got = sd.output({}, [o.name for o in outs])
        res.append([_np(got[o.name]) for o in outs])
    return res


def _ns(ns, method, *extra, **fixed):
    """A builder calling ``sd.<ns>.<method>(*vars, *extra, **fixed)``."""
    return lambda sd, vs: getattr(getattr(sd, ns), method)(*vs, *extra,
                                                           **fixed)


# (id, op whose validation args feed it, builder)
NAMESPACE = [
    ("nn.batchNorm", "batchnorm_sd", _ns("nn", "batchNorm", eps=1e-3)),
    ("cnn.conv2d", "conv2d", _ns("cnn", "conv2d", pad=1)),
    ("cnn.conv1d", "conv1d", _ns("cnn", "conv1d")),
    ("cnn.deconv2d", "deconv2d", _ns("cnn", "deconv2d", stride=2)),
    ("cnn.depthWiseConv2d", "depthwise_conv2d",
     _ns("cnn", "depthWiseConv2d")),
    ("cnn.separableConv2d", "sconv2d", _ns("cnn", "separableConv2d")),
    ("cnn.maxPooling2d", "maxpool2d",
     _ns("cnn", "maxPooling2d", kernel=2, stride=2)),
    ("cnn.avgPooling2d", "avgpool2d",
     _ns("cnn", "avgPooling2d", kernel=2, stride=2)),
    ("cnn.upsampling2d", "upsampling2d", _ns("cnn", "upsampling2d", scale=2)),
    ("cnn.im2Col", "im2col", _ns("cnn", "im2Col", kernel=2)),
    ("cnn.spaceToDepth", "space_to_depth", _ns("cnn", "spaceToDepth", 2)),
    ("cnn.depthToSpace", "depth_to_space", _ns("cnn", "depthToSpace", 2)),
    ("rnn.lstmLayer", "lstmLayer_out", _ns("rnn", "lstmLayer")),
    ("rnn.gru", "gru_out", _ns("rnn", "gru")),
    ("loss.mse", "mean_sqerr_loss", _ns("loss", "mse")),
    ("loss.meanSquaredError", "mean_sqerr_loss",
     _ns("loss", "meanSquaredError")),
    ("loss.softmaxCrossEntropy", "softmax_cross_entropy_loss",
     _ns("loss", "softmaxCrossEntropy")),
    ("loss.sigmoidCrossEntropy", "sigmoid_cross_entropy_loss",
     _ns("loss", "sigmoidCrossEntropy")),
    ("loss.sparseSoftmaxCrossEntropy", "sparse_softmax_cross_entropy_loss",
     _ns("loss", "sparseSoftmaxCrossEntropy")),
    ("loss.absoluteDifference", "absolute_difference_loss",
     _ns("loss", "absoluteDifference")),
    ("loss.cosineDistance", "cosine_distance_loss",
     _ns("loss", "cosineDistance")),
    ("loss.hingeLoss", "hinge_loss", _ns("loss", "hingeLoss")),
    ("loss.huberLoss", "huber_loss", _ns("loss", "huberLoss", delta=0.5)),
    ("loss.logLoss", "log_loss", _ns("loss", "logLoss")),
    ("loss.l2Loss", "l2_loss", _ns("loss", "l2Loss")),
    ("linalg.mmul", "matmul", _ns("linalg", "mmul")),
    ("linalg.cholesky", "cholesky", _ns("linalg", "cholesky")),
    ("linalg.qr", "qr", _ns("linalg", "qr")),
    ("linalg.inverse", "matrix_inverse", _ns("linalg", "inverse")),
    ("linalg.det", "matrix_determinant", _ns("linalg", "det")),
    ("linalg.solve", "solve", _ns("linalg", "solve")),
    ("bitwise.and_", "bitwise_and", _ns("bitwise", "and_")),
    ("bitwise.or_", "bitwise_or", _ns("bitwise", "or_")),
    ("bitwise.xor", "bitwise_xor", _ns("bitwise", "xor")),
    ("bitwise.leftShift", "left_shift", _ns("bitwise", "leftShift")),
    ("bitwise.rightShift", "right_shift", _ns("bitwise", "rightShift")),
    ("image.resizeBiLinear", "resize_bilinear",
     _ns("image", "resizeBiLinear", 8, 8)),
    ("image.resizeNearestNeighbor", "resize_nearest_neighbor",
     _ns("image", "resizeNearestNeighbor", 8, 8)),
    ("image.nonMaxSuppression", "non_max_suppression",
     _ns("image", "nonMaxSuppression", 2)),
    ("nn.multiHeadDotProductAttention", "multi_head_dot_product_attention",
     _ns("nn", "multiHeadDotProductAttention", num_heads=2)),
]


@pytest.mark.parametrize("case", NAMESPACE, ids=[c[0] for c in NAMESPACE])
def test_namespace_method_matches_jax(case):
    _id, op, build = case
    args, _ = _args(op)
    jouts, touts = _both(args, build)
    tol = LINALG_TOL if _id.startswith("linalg") else TOL
    assert len(jouts) == len(touts)
    for j, t in zip(jouts, touts):
        assert j.shape == t.shape, _id
        if j.dtype == bool or np.issubdtype(j.dtype, np.integer):
            np.testing.assert_array_equal(t, j, err_msg=_id)
        else:
            np.testing.assert_allclose(t, j, rtol=tol, atol=tol,
                                       err_msg=_id)


def test_svd_matches_jax_by_values_and_reconstruction():
    (a,), _ = _args("svd")
    (ju, js, jv), (tu, ts, tv) = _both(
        [a], lambda sd, vs: sd.linalg.svd(vs[0]))
    np.testing.assert_allclose(ts, js, rtol=LINALG_TOL, atol=LINALG_TOL)
    k = ts.shape[-1]
    np.testing.assert_allclose((tu[:, :k] * ts) @ tv[:k], a,
                               rtol=LINALG_TOL, atol=LINALG_TOL)


@pytest.mark.parametrize("axes", [(), (1,), (0, 1)])
@pytest.mark.parametrize("kind", ["std", "variance", "sdvariable.std"])
def test_std_and_variance_are_bessel_corrected_as_in_jax(kind, axes):
    x = np.random.RandomState(1).randn(4, 5).astype(np.float32)
    if kind == "sdvariable.std":
        build = lambda sd, vs: vs[0].std(*axes)          # noqa: E731
    else:
        build = lambda sd, vs: getattr(sd.math, kind)(vs[0], *axes)  # noqa
    (j,), (t,) = _both([x], build)
    ref = np.std(x, axis=axes or None, ddof=1) if "std" in kind \
        else np.var(x, axis=axes or None, ddof=1)
    np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(t, ref, rtol=1e-5, atol=1e-6)


def test_mha_with_a_mask_matches_jax():
    args, kw = _args("multi_head_dot_product_attention")
    mask = np.ones((2, 1, 1, 5), np.float32)
    mask[0, ..., 3:] = 0.0
    mask[1, ..., :1] = 0.0
    (j,), (t,) = _both(
        args + [mask], lambda sd, vs: sd.nn.multiHeadDotProductAttention(
            *vs[:6], num_heads=2, mask=vs[6]))
    np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)
    (unmasked,), _ = _both(args, lambda sd, vs:
                           sd.nn.multiHeadDotProductAttention(
                               *vs, num_heads=2))
    assert not np.allclose(j, unmasked)      # the mask took effect


def test_rename_moves_a_name_everywhere():
    sd = SameDiff.create(device="cpu")
    x = sd.placeHolder("x", shape=(None, 3))
    w = sd.var("w", np.eye(3, dtype=np.float32))
    y = (x @ w).rename("projected")
    z = y.sum(1)
    sd.setLossVariables(z)
    assert y.name == "projected" and sd.hasVariable("projected")
    assert z.name in sd.output({"x": np.ones((2, 3), np.float32)},
                               [z.name])
    w.rename("weights")
    assert "weights" in sd._variables and "w" not in sd._variables
    got = sd.output({"x": np.ones((2, 3), np.float32)}, ["projected"])
    np.testing.assert_array_equal(_np(got["projected"]), np.ones((2, 3)))


# ------------------------------------------------------------ a small MLP
def _mlp(sdmod, sd, rate=0.25, seed=0, updater=None):
    rng = np.random.RandomState(seed)
    x = sd.placeHolder("x", shape=(None, 6))
    y = sd.placeHolder("y", shape=(None, 3))
    w1 = sd.var("w1", (rng.randn(6, 16) * 0.3).astype(np.float32))
    b1 = sd.var("b1", np.zeros(16, np.float32))
    w2 = sd.var("w2", (rng.randn(16, 3) * 0.3).astype(np.float32))
    b2 = sd.var("b2", np.zeros(3, np.float32))
    h = sd.nn.relu(sd.nn.linear(x, w1, b1))
    if rate:
        h = sd.nn.dropout(h, rate, name="drop")
    logits = sd.nn.linear(h, w2, b2, name="logits")
    loss = sd.loss.softmaxCrossEntropy(y, logits, name="loss")
    sd.setLossVariables(loss)
    sd.setTrainingConfig(sdmod.TrainingConfig(
        updater=updater, data_set_feature_mapping=["x"],
        data_set_label_mapping=["y"]))
    return sd


def _batch(seed=3, n=8):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(n, 6).astype(np.float32),
            "y": np.eye(3, dtype=np.float32)[rng.randint(0, 3, n)]}


class _JaxMod:
    TrainingConfig = JTC


class _TorchMod:
    TrainingConfig = TrainingConfig


def _jax_fit_masks(steps, keep, shape):
    """The dropout masks the JAX fit draws at steps 0..steps-1: key
    fold_in(PRNGKey(0), t), split once for the graph's one RNG node."""
    out = {}
    for t in range(steps):
        key = jax.random.fold_in(jax.random.PRNGKey(0), t)
        _, sub = jax.random.split(key)
        out[t] = np.asarray(jax.random.bernoulli(sub, keep, shape))
    return out


def _inject(monkeypatch, masks):
    """The port's dropout draws the JAX mask of the key's step."""
    def mask(key, shape, keep, device):
        return torch.from_numpy(masks[int(key.t)]).to(device)
    monkeypatch.setattr(norm_ops, "dropout_mask", mask)


def test_dropout_by_injected_mask_matches_jax_output(monkeypatch):
    jsd = _mlp(_JaxMod, JSameDiff.create())
    tsd = _mlp(_TorchMod, SameDiff.create(device="cpu"))
    b = _batch()
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    _inject(monkeypatch, {0: np.asarray(
        jax.random.bernoulli(sub, 0.75, (8, 16)))})
    j = np.asarray(jsd.output(b, ["logits"], train=True)["logits"])
    t = _np(tsd.output(b, ["logits"], train=True)["logits"])
    np.testing.assert_allclose(t, j, rtol=TOL, atol=TOL)
    # inference: dropout is the identity in both
    j0 = np.asarray(jsd.output(b, ["logits"])["logits"])
    t0 = _np(tsd.output(b, ["logits"])["logits"])
    np.testing.assert_allclose(t0, j0, rtol=TOL, atol=TOL)
    assert not np.allclose(j, j0)


def test_the_port_s_own_dropout_masks_keep_their_rate_and_move():
    tsd = _mlp(_TorchMod, SameDiff.create(device="cpu"), rate=0.5)
    x = tsd.placeHolder("big", shape=(None, 4096))
    d = tsd.nn.dropout(x, 0.5)
    ones = {"big": np.ones((8, 4096), np.float32)}
    a = _np(tsd.output(ones, [d.name], train=True)[d.name])
    tsd._step = 1
    b = _np(tsd.output(ones, [d.name], train=True)[d.name])
    assert abs((a > 0).mean() - 0.5) < 0.01
    assert set(np.unique(a)) <= {0.0, 2.0}
    assert (a != b).any()


@pytest.mark.parametrize("kind,params,moments", [
    ("uniform", (-1.0, 3.0), (1.0, 4.0 / np.sqrt(12.0))),
    ("normal", (2.0, 0.5), (2.0, 0.5)),
    ("bernoulli", (0.3,), (0.3, np.sqrt(0.3 * 0.7))),
])
def test_random_ops_draw_their_moments(kind, params, moments):
    sd = SameDiff.create(device="cpu")
    v = getattr(sd.random, kind)(*params, (20000,))
    a = _np(sd.output({}, [v.name])[v.name]).astype(np.float64)
    mean, std = moments
    assert abs(a.mean() - mean) < 0.02
    assert abs(a.std() - std) < 0.02
    if kind == "uniform":
        assert a.min() >= -1.0 and a.max() < 3.0
    # the same step draws the same numbers; the next step others
    again = _np(sd.output({}, [v.name])[v.name])
    np.testing.assert_array_equal(again, a.astype(again.dtype))
    sd._step += 1
    assert (_np(sd.output({}, [v.name])[v.name]) != again).any()


# ------------------------------------------ graphs crossing the packages
def _rebuilder_graph(sd):
    """std, variance, MHA (with a mask), dropout and random_* nodes over
    placeholders q [2, 5, 8] and x [4, 6]."""
    args, _ = _args("multi_head_dot_product_attention")
    q = sd.placeHolder("q", shape=(None, 5, 8))
    x = sd.placeHolder("x", shape=(None, 6))
    ws = [sd.var(f"w{i}", a) for i, a in enumerate(args[2:])]
    mask = np.ones((2, 1, 1, 5), np.float32)
    mask[0, ..., 4:] = 0.0
    m = sd.constant(mask, name="mask")
    sd.nn.multiHeadDotProductAttention(q, q, *ws, num_heads=2, mask=m,
                                       name="attn")
    sd.nn.multiHeadDotProductAttention(q, q, *ws, num_heads=2,
                                       name="attn_nomask")
    sd.math.std(x, 1, name="sd1")
    sd.math.variance(x, 0, name="var0")
    sd.nn.dropout(x, 0.5, name="drop")
    sd.random.uniform(0.0, 1.0, (4, 6), name="u")
    sd.random.normal(0.0, 1.0, (4, 6), name="n")
    sd.random.bernoulli(0.5, (4, 6), name="b")
    return sd


DETERMINISTIC = ["attn", "attn_nomask", "sd1", "var0", "drop"]
DRAWN = ["u", "n", "b"]


def _feed():
    args, _ = _args("multi_head_dot_product_attention")
    return {"q": args[0],
            "x": np.random.RandomState(5).randn(4, 6).astype(np.float32)}


def test_a_jax_saved_graph_with_every_rebuilder_loads_in_the_port(tmp_path):
    jsd = _rebuilder_graph(JSameDiff.create())
    path = str(tmp_path / "jax.zip")
    jsd.save(path)
    tsd = SameDiff.load(path, device="cpu")
    feed = _feed()
    j = jsd.output(feed, DETERMINISTIC + DRAWN)
    t = tsd.output(feed, DETERMINISTIC + DRAWN)
    for k in DETERMINISTIC:
        np.testing.assert_allclose(_np(t[k]), np.asarray(j[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
    for k in DRAWN:
        assert tuple(t[k].shape) == tuple(j[k].shape), k
        assert t[k].dtype == (torch.bool if k == "b" else torch.float32)
    rebuilt = {n.outputs[0]: n for n in tsd._nodes}
    assert rebuilt["sd1"].rebuild == "std"
    assert rebuilt["var0"].rebuild == "variance"
    assert rebuilt["attn"].rebuild == "multi_head_dot_product_attention"
    assert all(rebuilt[k].attrs.get("__rng__") for k in ["drop"] + DRAWN)


def test_the_port_s_saved_graph_loads_in_jax(tmp_path):
    tsd = _rebuilder_graph(SameDiff.create(device="cpu"))
    path = str(tmp_path / "port.zip")
    tsd.save(path)
    jsd = JSameDiff.load(path)
    feed = _feed()
    j = jsd.output(feed, DETERMINISTIC + DRAWN)
    t = tsd.output(feed, DETERMINISTIC + DRAWN)
    for k in DETERMINISTIC:
        np.testing.assert_allclose(np.asarray(j[k]), _np(t[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
    for k in DRAWN:
        assert tuple(j[k].shape) == tuple(t[k].shape), k
    # and back: the JAX re-save reloads in the port, outputs unchanged
    path2 = str(tmp_path / "again.zip")
    jsd.save(path2)
    back = SameDiff.load(path2, device="cpu").output(feed, DETERMINISTIC)
    for k in DETERMINISTIC:
        np.testing.assert_array_equal(_np(back[k]), _np(t[k]), err_msg=k)


# ------------------------------------------------------------- the fit
def test_fit_through_the_dispatch_matches_the_jax_fit(monkeypatch,
                                                      fake_capture):
    jsd = _mlp(_JaxMod, JSameDiff.create(), updater=jupd.Adam(1e-2))
    tsd = _mlp(_TorchMod, SameDiff.create(device="cpu"),
               updater=tupd.Adam(1e-2))
    steps = 3
    _inject(monkeypatch, _jax_fit_masks(steps + 1, 0.75, (8, 16)))
    batches = [_batch(seed=s) for s in range(steps)]
    w1_before = _np(tsd._variables["w1"]).copy()
    caller_w1 = tsd._variables["w1"]
    seen = []

    class Listener:
        def iterationDone(self, sd, step, loss):
            seen.append((step, float(loss)))
    tsd.setListeners(Listener())
    cc.reset_stats()
    jh = jsd.fit(batches)
    th = tsd.fit(batches)
    np.testing.assert_allclose(th.lossCurve(), jh.lossCurve(), rtol=TOL,
                               atol=TOL)
    for k in jsd._variables:
        np.testing.assert_allclose(_np(tsd._variables[k]),
                                   np.asarray(jsd._variables[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    for k, s in jsd._updater_state.items():
        for name in ("m", "v"):
            np.testing.assert_allclose(
                _np(tsd._updater_state[k][name]), np.asarray(s[name]),
                rtol=1e-4, atol=1e-7, err_msg=f"{k}/{name}")
    # one captured graph for the signature, its replays did the steps
    assert len(fake_capture) == 1
    assert [d.captures() for d in tsd.fit_dispatches()] == [1]
    st = cc.cache_stats()
    assert st["memory"]["misses"] == 1 and st["memory"]["hits"] == 2
    assert st["eager_by_design"] == 0
    # listeners: once a step, the step's loss
    assert [s for s, _ in seen] == [1, 2, 3]
    np.testing.assert_allclose([l for _, l in seen], th.lossCurve())
    # the array the caller passed to var() survives the in-place updates
    np.testing.assert_array_equal(_np(caller_w1), w1_before)
    assert int(tsd._t_dev) == steps == tsd._step
    # a second fit replays the same graph: no new capture
    tsd.fit([_batch(seed=9)])
    assert len(fake_capture) == 1


def test_a_graph_change_drops_the_captured_step(fake_capture):
    tsd = _mlp(_TorchMod, SameDiff.create(device="cpu"), rate=0.0)
    tsd.fit([_batch()])
    assert len(tsd.fit_dispatches()) == 1
    tsd.setLossVariables("loss")
    assert tsd.fit_dispatches() == []
    tsd.fit([_batch()])
    tsd.getVariable("w1").setArray(np.zeros((6, 16), np.float32))
    tsd.fit([_batch()])           # a replaced array: a fresh capture
    assert len(fake_capture) == 3


def test_a_while_loop_graph_is_marked_eager_when_recorded(fake_capture):
    sd = SameDiff.create(device="cpu")
    x = sd.placeHolder("x", shape=(None, 3))
    w = sd.var("w", np.full((3,), 0.5, np.float32))
    h = x * w
    c0 = sd.constant(np.zeros((), np.int32), name="c0")
    out, _ = sd.while_loop(lambda a, i: i < 2,
                           lambda a, i: (a * 2.0, i + 1), [h, c0])
    loss = out.sum()
    sd.setLossVariables(loss)
    sd.setTrainingConfig(TrainingConfig(updater=tupd.Sgd(0.1),
                                        data_set_feature_mapping=["x"]))
    loop = sd._producers[out.name]
    assert loop.host and not sd._producers[h.name].host
    assert sd.host_control_nodes() == [out.name]
    cc.reset_stats()
    hist = sd.fit([{"x": np.ones((2, 3), np.float32)}] * 2)
    assert sd.fit_dispatches() == [] and fake_capture == []
    assert cc.cache_stats()["eager_by_design"] == 2
    # d(sum(4 * x * w))/dw = 4 * 2 = 8 a component: w = 0.5 - 0.1 * 8
    np.testing.assert_allclose(hist.lossCurve()[0], 12.0, rtol=1e-6)
    np.testing.assert_allclose(_np(sd._variables["w"]),
                               np.full(3, 0.5 - 2 * 0.8, np.float32),
                               rtol=1e-6)
