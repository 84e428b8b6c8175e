"""The port's SameDiff against the JAX package's (CPU).

One BERT sequence classifier written op by op through the public
SameDiff API (:func:`build_bert`, a copy of the builder in
``chip_smoke.py``) runs in both packages at a small size: E=128, H=2,
2 layers, d_ff=256, T=128, V=64, B=2, fp32, weights N(0, 0.02) from
``numpy.random.default_rng(0)``. The JAX graph is recorded with the
Pallas softmax override installed (``interpret=True``), so its attention
softmax runs the Pallas kernel; its layer norms take the generic op,
because the JAX layer-norm override fails under ``jit`` (its kernel
closes over the traced eps; ROADMAP queue 3). The port's graph is
recorded with the CUDA overrides installed, which take their plain
versions on the CPU. Graphs cross between the packages through
``save``/``load``.

Tolerances: probs and loss 1e-4, gradients 2e-4 (fp32, the same
arithmetic summed in another order through 2 layers), params after 3
Adam steps 1e-5 absolute at lr 1e-3 (see ``test_fit_matches_jax``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu.autodiff.samediff import TrainingConfig as JTC
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu.ops import registry as jreg
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import registry as treg
from deeplearning4j_tpu_torch.serving import ModelServer, samediff_forward
from deeplearning4j_tpu_torch.train import updaters as tupd

torch.set_num_threads(2)

CFG = dict(V=64, E=128, H=2, L=2, F=256, T=128, max_len=128, n_labels=2)
B = 2
OUT_TOL = 1e-4
GRAD_TOL = 2e-4
FIT_LR = 1e-3
FIT_STEPS = 3


def build_bert(sd, dtype=np.float32, *, V, E, H, L, F, T, max_len,
               n_labels, eps=1e-12, seed=0):
    """A BERT sequence classifier (post-LN, tanh gelu, tanh pooler)
    written op by op in SameDiff, as an imported BERT graph runs.
    Placeholders ``input_ids`` [None, T] and ``labels`` [None], int32;
    outputs ``probs`` [B, n_labels] and ``loss``. Activations stay on the
    2-D [B*T, E] view, so every layer norm and the attention softmax
    (on [B*H*T, T]) take 2-D inputs. Weights N(0, 0.02), biases 0, LN
    gains 1, from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    D = E // H

    def w(name, *shape):
        return sd.var(name, (rng.standard_normal(shape) * 0.02)
                      .astype(dtype))

    def zeros(name, n):
        return sd.var(name, np.zeros(n, dtype))

    def ln(x, name):
        # BERT's eps through the registry op: SDNN.layerNorm has no eps
        return sd.math.layer_norm(x, sd.var(name + "_g", np.ones(E, dtype)),
                                  zeros(name + "_b", E), eps=eps)

    def linear(x, name, n_in, n_out):
        return sd.nn.linear(x, w(name + "_w", n_in, n_out),
                            zeros(name + "_b", n_out))

    ids = sd.placeHolder("input_ids", shape=(None, T), dtype=np.int32)
    labels = sd.placeHolder("labels", shape=(None,), dtype=np.int32)
    tok = sd.math.gather(w("tok_emb", V, E), ids, axis=0)       # [B, T, E]
    pos = sd.math.gather(w("pos_emb", max_len, E),
                         np.arange(T, dtype=np.int32), axis=0)  # [T, E]
    typ = sd.math.gather(w("type_emb", 2, E),
                         np.zeros(T, np.int32), axis=0)         # [T, E]
    h = ln((tok + pos + typ).reshape(-1, E), "emb_ln")          # [B*T, E]
    for i in range(L):
        p = f"l{i}_"

        def heads(x):
            return x.reshape(-1, T, H, D).transpose(0, 2, 1, 3)  # [B,H,T,D]
        q = heads(linear(h, p + "q", E, E))
        k = heads(linear(h, p + "k", E, E))
        v = heads(linear(h, p + "v", E, E))
        s = q.mmul(k, transpose_b=True) * float(1.0 / np.sqrt(D))
        a = sd.nn.softmax(s.reshape(-1, T)).reshape(-1, H, T, T)
        ctx = a.mmul(v).transpose(0, 2, 1, 3).reshape(-1, E)
        h = ln(h + linear(ctx, p + "o", E, E), p + "ln1")
        ff = linear(sd.nn.gelu(linear(h, p + "ff1", E, F)), p + "ff2", F, E)
        h = ln(h + ff, p + "ln2")
    cls = h.reshape(-1, T, E).get((slice(None), 0))             # [B, E]
    pooled = sd.nn.tanh(linear(cls, "pool", E, E))
    logits = linear(pooled, "cls", E, n_labels)
    sd.nn.softmax(logits, name="probs")
    sd.loss.sparseSoftmaxCrossEntropy(labels, logits, name="loss")
    sd.setLossVariables("loss")
    return sd


def _batch(seed=1, b=B):
    r = np.random.default_rng(seed)
    return {"input_ids": r.integers(0, CFG["V"], (b, CFG["T"]),
                                    dtype=np.int32),
            "labels": r.integers(0, CFG["n_labels"], b, dtype=np.int32)}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.fixture()
def torch_overrides():
    ck.install_platform_overrides()
    try:
        yield
    finally:
        ck.uninstall_platform_overrides()


@pytest.fixture(scope="module")
def jax_graph(tmp_path_factory):
    """The JAX graph, recorded over the Pallas softmax (interpreted),
    saved; its probs, loss and gradients on one batch; and the params
    and loss curve after FIT_STEPS Adam steps of ``fit``, saved too."""
    d = tmp_path_factory.mktemp("sd")
    jreg.register_platform_override(
        "softmax", pk.make_softmax_override(interpret=True))
    try:
        jsd = build_bert(JSameDiff.create(), **CFG)
    finally:
        jreg.clear_platform_override("softmax")
    jsd.setTrainingConfig(JTC(updater=jupd.Adam(FIT_LR),
                              data_set_feature_mapping=["input_ids"],
                              data_set_label_mapping=["labels"]))
    path = str(d / "jax.zip")
    jsd.save(path)
    batch = _batch()
    out = jsd.output(batch, ["probs", "loss"])
    # the JAX calculateGradients differentiates the int32 placeholders too
    # and jax.grad refuses them (ROADMAP queue 3): take the same total
    # loss's gradient with respect to the variables only
    total = jsd._total_loss_fn()
    phs = {k: jnp.asarray(v) for k, v in batch.items()}
    grads = jax.grad(total)(jsd._variables, jsd._constants, phs,
                            jax.random.PRNGKey(0), False)
    hist = jsd.fit([batch] * FIT_STEPS)
    fitted = str(d / "jax_fitted.zip")
    jsd.save(fitted)
    return {"path": path, "fitted": fitted, "batch": batch,
            "probs": np.asarray(out["probs"]),
            "loss": float(out["loss"]),
            "grads": {k: np.asarray(v) for k, v in grads.items()},
            "losses": hist.lossCurve(),
            "params": {k: np.asarray(v) for k, v in jsd._variables.items()}}


def test_graph_counts_13_softmax_and_25_layer_norm_at_full_depth():
    sd = build_bert(SameDiff.create(device="cpu"),
                    **dict(CFG, L=12, E=64, F=64, T=8, max_len=8))
    ops = [n.op for n in sd._needed_nodes(["probs"])]
    assert ops.count("softmax") == 13 and ops.count("layer_norm") == 25


def test_output_matches_jax(jax_graph, torch_overrides):
    sd = SameDiff.load(jax_graph["path"], device="cpu")
    ck.reset_counts()
    out = sd.output(jax_graph["batch"], ["probs", "loss"])
    # 2 attention softmaxes + the head's [2, 2] (outside the JAX gate),
    # 5 layer norms, all on the plain versions on the CPU
    assert ck.PLAIN_CALLS == {"layer_norm": 5, "softmax": 3,
                              "flash_attention": 0, "scale_shift_act": 0,
                              "bn_stats": 0, "bn_apply_leaky": 0}
    assert tuple(out["probs"].shape) == (B, CFG["n_labels"])
    np.testing.assert_allclose(_np(out["probs"]), jax_graph["probs"],
                               rtol=OUT_TOL, atol=OUT_TOL)
    np.testing.assert_allclose(float(out["loss"]), jax_graph["loss"],
                               rtol=OUT_TOL, atol=OUT_TOL)


def test_gradients_match_jax(jax_graph, torch_overrides):
    sd = SameDiff.load(jax_graph["path"], device="cpu")
    grads = sd.calculateGradients(jax_graph["batch"])
    assert set(grads) == set(jax_graph["grads"])
    for k, g in grads.items():
        np.testing.assert_allclose(_np(g), jax_graph["grads"][k],
                                   rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=k)


def test_fit_matches_jax(jax_graph, torch_overrides):
    sd = SameDiff.load(jax_graph["path"], device="cpu")
    assert isinstance(sd.training_config.updater, tupd.Adam)
    assert sd.training_config.updater.lr_at(0) == FIT_LR
    hist = sd.fit([jax_graph["batch"]] * FIT_STEPS)
    np.testing.assert_allclose(hist.lossCurve(), jax_graph["losses"],
                               rtol=OUT_TOL, atol=OUT_TOL)
    assert sd._step == FIT_STEPS
    # Adam's first steps move each weight by ~lr * sign(g) whatever |g|
    # is, so a gradient within rounding of 0 could move a weight either
    # way in the two packages: the bound is 1% of lr, far below that
    # step, and holds every param of the 3-step run
    for k, v in sd._variables.items():
        np.testing.assert_allclose(_np(v), jax_graph["params"][k],
                                   rtol=0, atol=1e-2 * FIT_LR, err_msg=k)
    # the updater state and the step travel in the zip too
    jfit = SameDiff.load(jax_graph["fitted"], device="cpu")
    assert jfit._step == FIT_STEPS
    for k, s in jfit._updater_state.items():
        for name in ("m", "v"):
            np.testing.assert_allclose(
                _np(s[name]), _np(sd._updater_state[k][name]),
                rtol=1e-3, atol=1e-9, err_msg=f"{k}/{name}")


def test_port_saves_and_jax_loads(jax_graph, torch_overrides, tmp_path):
    sd = build_bert(SameDiff.create(device="cpu"), **CFG)
    sd.setTrainingConfig(TrainingConfig(
        updater=tupd.Adam(FIT_LR), data_set_feature_mapping=["input_ids"],
        data_set_label_mapping=["labels"]))
    sd.fit([jax_graph["batch"]])
    path = str(tmp_path / "port.zip")
    sd.save(path)
    jsd = JSameDiff.load(path)
    assert jsd._step == 1
    assert type(jsd.training_config.updater).__name__ == "Adam"
    assert set(jsd._updater_state) == set(sd._variables)
    batch = _batch(seed=2)
    want = sd.output(batch, ["probs", "loss"])
    got = jsd.output(batch, ["probs", "loss"])
    np.testing.assert_allclose(np.asarray(got["probs"]),
                               _np(want["probs"]), rtol=OUT_TOL,
                               atol=OUT_TOL)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=OUT_TOL, atol=OUT_TOL)
    assert jsd._placeholders["input_ids"][1] == np.dtype("int32")


def test_server_serves_the_graph_as_sd_output(torch_overrides):
    sd = build_bert(SameDiff.create(device="cpu"), **CFG)
    fwd = samediff_forward(sd, ["probs"], input_name="input_ids")
    server = ModelServer(fwd, device="cpu", batch_limit=4,
                         input_dtype=np.int32)
    try:
        server.warmup([(CFG["T"],)])
        reqs = [_batch(seed=s, b=1 + s % 3)["input_ids"] for s in range(5)]
        handles = [server.submit(r) for r in reqs]
        served = [h.get(60) for h in handles]
    finally:
        server.close()
    assert all(h.resolutions == 1 for h in handles)
    for r, got in zip(reqs, served):
        want = _np(sd.output({"input_ids": r}, ["probs"])["probs"])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_samediff_forward_needs_an_input_name_with_two_placeholders():
    sd = build_bert(SameDiff.create(device="cpu"),
                    **dict(CFG, L=1, T=4, max_len=4))
    with pytest.raises(ValueError, match="input_name"):
        samediff_forward(sd, ["probs"])
    with pytest.raises(TypeError, match="samediff_forward"):
        ModelServer(sd, device="cpu")


def test_samediff_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SameDiff.create()
    assert SameDiff.create(device="cpu").device.type == "cpu"


def test_overrides_are_resolved_at_record_time():
    ck.install_platform_overrides()
    try:
        sd = SameDiff.create(device="cpu")
        x = sd.placeHolder("x", shape=(None, 4))
        sd.nn.softmax(x, name="y")
    finally:
        ck.uninstall_platform_overrides()
    ck.reset_counts()
    sd.output({"x": np.ones((3, 4), np.float32)}, ["y"])
    assert ck.PLAIN_CALLS["softmax"] == 1
    # recorded after the uninstall: the generic op
    sd.nn.softmax(x, name="z")
    sd.output({"x": np.ones((3, 4), np.float32)}, ["z"])
    assert ck.PLAIN_CALLS["softmax"] == 1
    assert sd._producers["z"].fn is treg.softmax


class TestGraphApi:
    def _sd(self):
        return SameDiff.create(device="cpu")

    def test_arithmetic_reductions_and_casts_match_jax(self):
        x = np.random.default_rng(3).standard_normal((3, 4)) \
            .astype(np.float32)
        outs = {}
        for name, sd in (("t", self._sd()), ("j", JSameDiff.create())):
            a = sd.placeHolder("a", shape=(None, 4), dtype=np.float32)
            w = sd.var("w", np.arange(8, dtype=np.float32).reshape(4, 2))
            y = ((a * 2.0 - 1.0) / 3.0).mmul(w).sum(1, keepdims=True)
            z = (a.mean(0) + a.max() - a.min(1).sum()).castTo(np.int32)
            r = a.reshape(2, 6).transpose().get((slice(1, 4), [0, 1]))
            ex = (a.abs().sqrt() + a.square().exp().log()).norm2(0)
            am = a.argmax(1)
            outs[name] = sd.output({"a": x}, [y, z, r, ex, am])
        for k in outs["j"]:
            want = np.asarray(outs["j"][k])
            got = _np(outs["t"][k])
            assert got.dtype == want.dtype, k
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       err_msg=k)

    def test_calculate_gradients_wrt_a_float_placeholder(self):
        sd = self._sd()
        a = sd.placeHolder("a", shape=(None, 3))
        w = sd.var("w", np.ones(3, np.float32))
        u = sd.var("unused", np.ones(2, np.float32))
        sd.setLossVariables(sd.nn.tanh(a * w).sum().name)
        x = np.full((2, 3), 0.5, np.float32)
        g = sd.calculateGradients({"a": x}, ["a", "w", u.name])
        np.testing.assert_allclose(_np(g["a"]),
                                   1 - np.tanh(0.5) ** 2 * np.ones((2, 3)),
                                   rtol=1e-6)
        np.testing.assert_allclose(_np(g["w"]),
                                   2 * 0.5 * (1 - np.tanh(0.5) ** 2),
                                   rtol=1e-6)
        assert not _np(g["unused"]).any()
        with pytest.raises(ValueError, match="neither"):
            sd.calculateGradients({"a": x}, ["nope"])

    def test_convert_to_constants_freezes_a_weight(self):
        sd = self._sd()
        a = sd.placeHolder("a", shape=(None, 2))
        w = sd.var("w", np.ones((2, 2), np.float32))
        b = sd.var("b", np.zeros(2, np.float32))
        sd.setLossVariables(sd.nn.linear(a, w, b).square().sum().name)
        sd.setTrainingConfig(TrainingConfig(
            updater=tupd.Sgd(0.1), data_set_feature_mapping=["a"],
            data_set_label_mapping=[]))
        sd.convertToConstants("w")
        hist = sd.fit([(np.ones((1, 2), np.float32), [])] * 2)
        assert len(hist.lossCurve()) == 2
        np.testing.assert_array_equal(_np(sd._constants["w"]), np.ones((2, 2)))
        assert _np(sd._variables["b"]).max() < 0
        sd.convertToVariables("w")
        assert sd.getVariable("w").var_type == "VARIABLE"
        assert sd._updater_state is None

    def test_training_config_round_trips_through_jax_json(self):
        tc = TrainingConfig(updater=tupd.AdamW(3e-4, weight_decay=0.01),
                            l2=1e-4, clip_global_norm=1.0)
        jtc = JTC.from_config(tc.to_config())
        assert isinstance(jtc.updater, jupd.AdamW)
        assert jtc.updater.weight_decay == 0.01
        back = TrainingConfig.from_config(jtc.to_config())
        assert back.to_config() == tc.to_config()
        # Nesterovs is ported now: it crosses too; an unknown class raises
        nest = tupd.IUpdater.from_config(jupd.Nesterovs().to_config())
        assert isinstance(nest, tupd.Nesterovs) and nest.momentum == 0.9
        with pytest.raises(ValueError, match="unknown updater"):
            tupd.IUpdater.from_config({"@class": "Lion"})

    def test_var_init_needs_a_generator(self):
        sd = self._sd()
        with pytest.raises(ValueError, match="generator"):
            sd.var("w", shape=(3, 4))
        g = torch.Generator().manual_seed(0)
        w = sd.var("w", shape=(3, 4), init="xavier", generator=g)
        assert w.shape == (3, 4)
        lim = np.sqrt(6.0 / 7)
        assert np.abs(_np(w.getArr())).max() <= lim
