"""The layers the Keras importer builds, against the JAX package's on the
CPU: the embedding, 1-D, 3-D, normalization, attention, noise, mask and
wrapper layers and ConvLSTM2D, each from the JAX layer's own init (its
params carried over as numpy) on the same seeded input, forward and the
gradients of every param and of a float input, masked where the layer
takes a mask; each layer's JSON in both directions and the param names
and shapes of the port's own init; JAX configuration JSON holding each
of the eight layer classes the port lacked (``_LAYER_CLASSES``) read by
the port's ``from_json``, with one SGD step through ``params_from_jax``;
``SelfAttentionLayer``'s masked route and its unmasked T >= 1024 route
(the port's plain flash on the CPU against the JAX Pallas kernel under
the interpreter, as tests/test_pallas.py runs it); the noise layers in
training on JAX's draws; and the weight inits the port added, by their
moments (threefry and Philox streams cannot match).

Tolerances (tests/test_pallas.py's): fp32 forward 1e-5 (rtol and atol);
gradients and SGD steps within 2e-4 of the largest magnitude of each;
the attention key bias's gradient, zero in exact arithmetic, below 1e-4
of the layer's largest gradient in both packages.
"""

import copy
import json
import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.ops import registry as jreg
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.nn import layers as tlayers
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                MultiLayerConfiguration,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import normalization as tnorm
from deeplearning4j_tpu_torch.ops import registry as treg
from deeplearning4j_tpu_torch.train import updaters as tupd

torch.set_num_threads(2)

FWD_TOL = 1e-5
GRAD_TOL = 2e-4
N, C, T, D, V = 3, 5, 8, 6, 10


def _inputs(kind, seed=1):
    """``(x, InputType kwargs)`` for an input kind."""
    r = np.random.default_rng(seed)
    if kind == "rnn":
        return r.standard_normal((N, C, T)).astype(np.float32), \
            ("recurrent", (C, T))
    if kind == "ff":
        return r.standard_normal((N, D)).astype(np.float32), \
            ("feedForward", (D,))
    if kind == "cnn":
        return r.standard_normal((N, 4, 6, 6)).astype(np.float32), \
            ("convolutional", (6, 6, 4))
    if kind == "cnn3d":
        return r.standard_normal((N, 2, 4, 5, 5)).astype(np.float32), \
            ("convolutional3D", (4, 5, 5, 2))
    if kind == "ids":
        return r.integers(0, V, (N,)).astype(np.int32), ("feedForward", (1,))
    if kind == "ids_seq":
        return r.integers(0, V, (N, T)).astype(np.int32), \
            ("feedForward", (T,))
    if kind == "onehot":
        return np.eye(V, dtype=np.float32)[r.integers(0, V, N)], \
            ("feedForward", (V,))
    if kind == "zero_steps":
        x = r.standard_normal((N, C, T)).astype(np.float32)
        x[0, :, 5:] = 0.0
        x[2, :, 1] = 0.0
        return x, ("recurrent", (C, T))
    raise ValueError(kind)


#: name -> (builder over a layers module, input kind, takes a mask)
LAYERS = {
    "EmbeddingLayer": (lambda M: M.EmbeddingLayer(nOut=D, nIn=V), "ids",
                       False),
    "EmbeddingLayer-onehot-bias": (lambda M: M.EmbeddingLayer(
        nOut=D, nIn=V, hasBias=True, activation="tanh"), "onehot", False),
    "EmbeddingSequenceLayer": (lambda M: M.EmbeddingSequenceLayer(
        nOut=D, nIn=V), "ids_seq", False),
    "Convolution1D-same": (lambda M: M.Convolution1D(
        kernelSize=3, nOut=4, activation="tanh"), "rnn", False),
    "Convolution1D-truncate": (lambda M: M.Convolution1D(
        kernelSize=3, stride=2, padding=1, nOut=4,
        convolutionMode="truncate"), "rnn", False),
    "Convolution1D-causal": (lambda M: M.Convolution1D(
        kernelSize=3, dilation=2, nOut=4, convolutionMode="causal"), "rnn",
        False),
    "Subsampling1DLayer-max": (lambda M: M.Subsampling1DLayer(
        "max", kernelSize=3, stride=2), "rnn", False),
    "Subsampling1DLayer-avg-same": (lambda M: M.Subsampling1DLayer(
        "avg", kernelSize=3, stride=2, convolutionMode="same"), "rnn",
        False),
    "PReLULayer": (lambda M: M.PReLULayer(), "ff", False),
    "LayerNorm-ff": (lambda M: M.LayerNorm(eps=1e-3), "ff", False),
    "LayerNorm-rnn": (lambda M: M.LayerNorm(eps=1e-12), "rnn", False),
    "GroupNorm": (lambda M: M.GroupNorm(groups=2), "cnn", False),
    "GroupNorm-instance-3d": (lambda M: M.GroupNorm(groups=-1), "cnn3d",
                              False),
    "UnitNormLayer-cnn": (lambda M: M.UnitNormLayer(), "cnn", False),
    "UnitNormLayer-ff": (lambda M: M.UnitNormLayer(), "ff", False),
    "Permute": (lambda M: M.Permute((2, 1)), "rnn", False),
    "RepeatVector": (lambda M: M.RepeatVector(3), "ff", False),
    "SelfAttentionLayer": (lambda M: M.SelfAttentionLayer(
        nOut=D, nHeads=2, headSize=3, useBias=True), "rnn", True),
    "SelfAttentionLayer-noproj": (lambda M: M.SelfAttentionLayer(
        projectInput=False), "rnn", True),
    "LearnedSelfAttentionLayer": (lambda M: M.LearnedSelfAttentionLayer(
        nOut=D, nHeads=2, headSize=3, nQueries=2), "rnn", True),
    "RecurrentAttentionLayer": (lambda M: M.RecurrentAttentionLayer(
        nOut=D), "rnn", True),
    "ConvLSTM2D-last": (lambda M: M.ConvLSTM2D(nOut=3, kernelSize=3),
                        "cnn3d", False),
    "ConvLSTM2D-seq-same": (lambda M: M.ConvLSTM2D(
        nOut=3, kernelSize=3, convolutionMode="same",
        returnSequences=True), "cnn3d", False),
    "Convolution3D": (lambda M: M.Convolution3D(kernelSize=2, nOut=3,
                                                activation="relu"),
                      "cnn3d", False),
    "Convolution3D-same-strided": (lambda M: M.Convolution3D(
        kernelSize=3, stride=2, nOut=3, convolutionMode="same"), "cnn3d",
        False),
    "Subsampling3DLayer-max": (lambda M: M.Subsampling3DLayer("max"),
                               "cnn3d", False),
    "Subsampling3DLayer-avg": (lambda M: M.Subsampling3DLayer(
        "avg", kernelSize=(2, 3, 3), stride=(1, 2, 2)), "cnn3d", False),
    "ZeroPadding3DLayer": (lambda M: M.ZeroPadding3DLayer(
        ((1, 0), 2, (0, 1))), "cnn3d", False),
    "Cropping3D": (lambda M: M.Cropping3D((1, (0, 1), 2)), "cnn3d", False),
    "Upsampling3D": (lambda M: M.Upsampling3D((2, 1, 3)), "cnn3d", False),
    "Upsampling1D": (lambda M: M.Upsampling1D(3), "rnn", False),
    "ZeroPadding1DLayer": (lambda M: M.ZeroPadding1DLayer((1, 2)), "rnn",
                           False),
    "Cropping1D": (lambda M: M.Cropping1D((2, 1)), "rnn", False),
    "MaskZeroLayer": (lambda M: M.MaskZeroLayer(), "zero_steps", False),
    "GaussianNoiseLayer": (lambda M: M.GaussianNoiseLayer(0.5), "ff",
                           False),
    "GaussianDropoutLayer": (lambda M: M.GaussianDropoutLayer(0.3), "ff",
                             False),
    "AlphaDropoutLayer": (lambda M: M.AlphaDropoutLayer(0.2), "ff", False),
    "TimeDistributed": (lambda M: M.TimeDistributed(nOut=4,
                                                    activation="tanh"),
                        "rnn", False),
    "TimeDistributed-softmax": (lambda M: M.TimeDistributed(
        nOut=4, activation="softmax"), "rnn", False),
}


def _flat(d, prefix=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _pair(name, seed=0):
    build, kind, _ = LAYERS[name]
    j, t = build(jlayers), build(tlayers)
    x, (ctor, args) = _inputs(kind)
    j.set_defaults(JConf())
    t.set_defaults(NeuralNetConfiguration())
    j.infer_nin(getattr(JInputType, ctor)(*args))
    t.infer_nin(getattr(InputType, ctor)(*args))
    jp, js = j.initialize(jax.random.PRNGKey(seed))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in _flat(jp).items()}
    ts = {k: torch.from_numpy(np.array(v)) for k, v in _flat(js).items()}
    return j, t, jp, js, tp, ts, x


def _mask():
    m = np.ones((N, T), np.float32)
    m[0, 5:] = 0.0          # ragged lengths
    m[1, 2:4] = 0.0         # a hole
    return m


@pytest.mark.parametrize("name,masked", [
    (n, m) for n in sorted(LAYERS) for m in (False, True)
    if not m or LAYERS[n][2]])
def test_layer_matches_jax(name, masked):
    j, t, jp, js, tp, ts, x = _pair(name)
    mask = _mask() if masked else None
    kw_j = {"mask": jnp.asarray(mask)} if masked else {}
    kw_t = {"mask": torch.from_numpy(mask)} if masked else {}
    floating = x.dtype == np.float32

    def jfwd(p, xx):
        return j.apply(p, js, xx, False, jax.random.PRNGKey(0), **kw_j)[0]
    want = jfwd(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(floating)
    got, _ = t.apply(tp, ts, tx, False, None, **kw_t)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=FWD_TOL, atol=FWD_TOL)
    names = sorted(tp)
    targets = [tp[k] for k in names] + ([tx] if floating else [])
    if not targets:
        return
    proj = np.random.default_rng(9).standard_normal(
        np.shape(want)).astype(np.float32)
    if floating:
        jg = jax.grad(lambda p, xx: jnp.sum(jfwd(p, xx) * proj),
                      argnums=(0, 1))(jp, jnp.asarray(x))
        wants = [_flat(jg[0])[k] for k in names] + [jg[1]]
    else:
        jg = jax.grad(lambda p: jnp.sum(jfwd(p, jnp.asarray(x)) * proj))(jp)
        wants = [_flat(jg)[k] for k in names]
    grads = torch.autograd.grad((got * torch.from_numpy(proj)).sum(),
                                targets)
    top = max(float(np.abs(np.asarray(r)).max()) for r in wants)
    for k, g, ref in zip(names + ["x"], grads, wants):
        ref = np.asarray(ref)
        if k == "bk":
            # the key bias shifts every score of a query alike: its
            # gradient is zero but for rounding, in both packages
            assert float(g.abs().max()) < 1e-4 * top
            assert float(np.abs(ref).max()) < 1e-4 * top
            continue
        np.testing.assert_allclose(
            g.numpy(), ref, rtol=0,
            atol=GRAD_TOL * max(float(np.abs(ref).max()), 1e-30),
            err_msg=f"{name} d/d{k}")


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_config_json_and_init_shapes_cross(name):
    j, t, jp, js, _, _, _ = _pair(name)
    jd = json.loads(json.dumps(j.to_config()))
    td = json.loads(json.dumps(t.to_config()))
    assert td == jd
    assert tlayers.layer_from_config(jd).to_config() == jd
    if jd["@class"] in jlayers._LAYER_CLASSES:   # the JAX reader's classes
        assert jlayers.layer_from_config(td).to_config() == td
    p, s = t.initialize(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: tuple(np.shape(v)) for k, v in _flat(jp).items()}
    assert {k: tuple(v.shape) for k, v in s.items()} == \
        {k: tuple(np.shape(v)) for k, v in _flat(js).items()}


def test_every_jax_layer_class_but_samediff_is_registered():
    """Every JAX layer class reads back in the port, and SameDiffLayer is
    a ported class too. It builds from config as the JAX one does: a
    subclass through its own ``from_config``, while the registry lookup of
    the base class refuses (the JAX registry holds no SameDiffLayer: a
    config holds no graph fragment)."""
    assert set(jlayers._LAYER_CLASSES) <= set(tlayers._LAYER_CLASSES)
    assert tlayers._LAYER_CLASSES["SameDiffLayer"] is tlayers.SameDiffLayer
    d = _TGated(nOut=4, nIn=5, weightInit="xavier").to_config()
    jd = _JGated(nOut=4, nIn=5, weightInit="xavier").to_config()
    assert {k: v for k, v in d.items() if k not in ("@class", "name")} == \
        {k: v for k, v in jd.items() if k not in ("@class", "name")}
    back = _TGated.from_config(d)
    assert type(back) is _TGated and back.to_config() == d
    assert _JGated.from_config(jd).to_config() == jd
    base = dict(d, **{"@class": "SameDiffLayer"})
    with pytest.raises(KeyError, match="SameDiffLayer"):
        tlayers.layer_from_config(base)
    with pytest.raises(KeyError, match="SameDiffLayer"):
        jlayers.layer_from_config(base)


# --------------------------- the eight classes through a JAX config JSON
def _seq_conf(Conf, M, It, upd):
    """[N, T] ids through EmbeddingSequenceLayer, Convolution1D,
    Subsampling1DLayer, Permute and LayerNorm."""
    return (Conf.Builder().seed(4).updater(upd.Sgd(0.1)).list()
            .layer(M.EmbeddingSequenceLayer(nIn=V, nOut=D))
            .layer(M.Convolution1D(kernelSize=3, nOut=5,
                                   convolutionMode="causal",
                                   activation="tanh"))
            .layer(M.Subsampling1DLayer("avg", kernelSize=2))
            .layer(M.Permute((2, 1)))
            .layer(M.LayerNorm(eps=1e-5))
            .layer(M.GlobalPoolingLayer("avg"))
            .layer(M.OutputLayer(nOut=3, lossFunction="mcxent"))
            .setInputType(It.feedForward(T)).build())


def _ff_conf(Conf, M, It, upd):
    """[N] ids through EmbeddingLayer, PReLULayer and RepeatVector."""
    return (Conf.Builder().seed(5).updater(upd.Sgd(0.1)).list()
            .layer(M.EmbeddingLayer(nIn=V, nOut=D))
            .layer(M.PReLULayer())
            .layer(M.RepeatVector(4))
            .layer(M.Convolution1D(kernelSize=2, nOut=4,
                                   activation="tanh"))
            .layer(M.GlobalPoolingLayer("max"))
            .layer(M.OutputLayer(nOut=3, lossFunction="mcxent"))
            .setInputType(It.feedForward(1)).build())


@pytest.mark.parametrize("builder,kind", [(_seq_conf, "ids_seq"),
                                          (_ff_conf, "ids")])
def test_jax_config_json_of_the_new_classes_reads_and_steps(builder, kind):
    jconf = builder(JConf, jlayers, JInputType, jupd)
    jnet = JMLN(jconf).init()
    tconf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert json.loads(tconf.to_json()) == json.loads(jconf.to_json())
    t = MultiLayerNetwork(tconf).params_from_jax(jnet._params, jnet._states,
                                                 device="cpu")
    x, _ = _inputs(kind, 3)
    np.testing.assert_allclose(t.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=FWD_TOL,
                               atol=FWD_TOL)
    y = np.eye(3, dtype=np.float32)[np.random.default_rng(4).integers(
        0, 3, N)]
    before = [{k: np.array(v) for k, v in _flat(p).items()}
              for p in jnet._params]
    jnet.fit(JDataSet(x, y))
    t.fit(DataSet(x, y))
    for i, p in enumerate(jnet._params):
        for k, v in _flat(p).items():
            step_j = np.asarray(v) - before[i][k]
            step_t = t._params[i][k].detach().numpy() - before[i][k]
            # each updated param rounds to its own ulp in both packages
            bound = GRAD_TOL * max(float(np.abs(step_j).max()), 1e-30) \
                + 2 * np.spacing(np.abs(before[i][k]))
            err = np.abs(step_t - step_j)
            assert (err <= bound).all(), \
                f"layer {i} {k}: max |err| {err.max():.3g}"


#: the trainable layers, each in a net built in code in both packages:
#: name -> (LAYERS key, whether the batch carries a feature mask)
FIT_CASES = {n: (n, False) for n in (
    "EmbeddingLayer", "EmbeddingSequenceLayer", "Convolution1D-causal",
    "PReLULayer", "LayerNorm-ff", "LayerNorm-rnn", "GroupNorm",
    "SelfAttentionLayer", "LearnedSelfAttentionLayer",
    "RecurrentAttentionLayer", "ConvLSTM2D-seq-same", "Convolution3D",
    "TimeDistributed")}
FIT_CASES.update({"SelfAttentionLayer-masked": ("SelfAttentionLayer", True),
                  "RecurrentAttentionLayer-masked": (
                      "RecurrentAttentionLayer", True)})


def _fit_conf(Conf, M, It, name):
    build, kind, _ = LAYERS[name]
    _, (ctor, args) = _inputs(kind)
    b = Conf.Builder().seed(7).weightInit("xavier").updater(
        (jupd if M is jlayers else tupd).Sgd(0.1)).list().layer(build(M))
    if kind not in ("ff", "ids", "onehot"):
        b = b.layer(M.GlobalPoolingLayer("avg"))
    return (b.layer(M.OutputLayer(nOut=3, lossFunction="mcxent"))
            .setInputType(getattr(It, ctor)(*args)).build())


@pytest.mark.parametrize("case", sorted(FIT_CASES))
def test_one_sgd_step_through_params_from_jax_matches(case):
    """A net with the layer, built in code in both packages, the JAX
    init carried over by ``params_from_jax``: the loss and every param's
    step after one SGD fit step."""
    name, masked = FIT_CASES[case]
    jnet = JMLN(_fit_conf(JConf, jlayers, JInputType, name)).init()
    t = MultiLayerNetwork(_fit_conf(NeuralNetConfiguration, tlayers,
                                    InputType, name))
    t.params_from_jax(jnet._params, jnet._states, device="cpu")
    x, _ = _inputs(LAYERS[name][1], 5)
    y = np.eye(3, dtype=np.float32)[np.random.default_rng(6).integers(
        0, 3, N)]
    fm = _mask() if masked else None
    np.testing.assert_allclose(t.output(x).numpy(),
                               np.asarray(jnet.output(x)), rtol=FWD_TOL,
                               atol=FWD_TOL)
    before = [{k: np.array(v) for k, v in _flat(p).items()}
              for p in jnet._params]
    jnet.fit(JDataSet(x, y, features_mask=fm))
    t.fit(DataSet(x, y, features_mask=fm))
    np.testing.assert_allclose(t.score(), float(jnet.score()), rtol=FWD_TOL)
    for i, p in enumerate(jnet._params):
        steps = {k: (np.asarray(v) - before[i][k],
                     t._params[i][k].detach().numpy() - before[i][k])
                 for k, v in _flat(p).items()}
        top = max([float(np.abs(sj).max()) for sj, _ in steps.values()]
                  + [1e-30])
        for k, (step_j, step_t) in steps.items():
            ulp = 2 * np.spacing(np.abs(before[i][k]))
            if k == "bk":       # zero in exact arithmetic (see above)
                for st in (step_j, step_t):
                    assert (np.abs(st) <= 1e-4 * top + ulp).all(), k
                continue
            bound = GRAD_TOL * max(float(np.abs(step_j).max()), 1e-30) + ulp
            err = np.abs(step_t - step_j)
            assert (err <= bound).all(), \
                f"{case} layer {i} {k}: max |err| {err.max():.3g}"


def test_mask_reaches_the_attention_layers_in_both_engines():
    from deeplearning4j_tpu_torch.nn import graph as tgraph
    from deeplearning4j_tpu_torch.nn import multilayer as tml
    for mod in (tml, tgraph):
        assert issubclass(tlayers.LearnedSelfAttentionLayer, mod._MASK_AWARE)
        assert isinstance(tlayers.SelfAttentionLayer(), mod._MASK_AWARE)
        assert isinstance(tlayers.RecurrentAttentionLayer(),
                          mod._MASK_AWARE)
    conf = (NeuralNetConfiguration.Builder().seed(1).list()
            .layer(tlayers.SelfAttentionLayer(nHeads=1))
            .layer(tlayers.RnnOutputLayer(nOut=2, lossFunction="mcxent"))
            .setInputType(InputType.recurrent(C, T)).build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    x, _ = _inputs("rnn")
    m = torch.from_numpy(_mask())
    out, _ = net._forward(net._params, net._states, torch.from_numpy(x),
                          False, fmask=m)
    # a padded query's attention output is zeroed: the output layer sees
    # zeros there, and its zero bias gives an even softmax
    assert torch.equal(out[0, :, 5:], torch.full((2, 3), 0.5))
    assert not torch.equal(out[0, :, :5], torch.full((2, 5), 0.5))


# --------------------------------------------------- SelfAttention routes
def test_self_attention_long_unmasked_route_takes_flash():
    """T >= 1024 unmasked: the port's flash override (its plain version
    on the CPU) against JAX's Pallas kernel under the interpreter; a
    masked or shorter call takes dot_product_attention in both."""
    from deeplearning4j_tpu.ops.pallas_kernels import \
        make_flash_attention_override
    j = jlayers.SelfAttentionLayer(nHeads=1, headSize=64, nOut=8)
    t = tlayers.SelfAttentionLayer(nHeads=1, headSize=64, nOut=8)
    for lay in (j, t):
        lay.set_defaults(JConf() if lay is j else NeuralNetConfiguration())
    j.infer_nin(JInputType.recurrent(16, 1024))
    t.infer_nin(InputType.recurrent(16, 1024))
    jp, _ = j.initialize(jax.random.PRNGKey(2))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(3).standard_normal((1, 16, 1024)).astype(
        np.float32)
    jreg.register_platform_override(
        "flash_attention",
        make_flash_attention_override(interpret=True, bq=128, bk=128))
    treg.register_platform_override("flash_attention",
                                    ck.make_flash_attention_override())
    try:
        want = j.apply(jp, {}, jnp.asarray(x), False, None)[0]
        ck.reset_counts()
        got = t.apply(tp, {}, torch.from_numpy(x), False, None)[0]
        assert ck.PLAIN_CALLS["flash_attention"] == 1
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FWD_TOL, atol=FWD_TOL)
        ck.reset_counts()
        short = t.apply(tp, {}, torch.from_numpy(x[:, :, :1023]), False,
                        None)[0]
        m = np.ones((1, 1024), np.float32)
        m[0, 900:] = 0.0
        masked = t.apply(tp, {}, torch.from_numpy(x), False, None,
                         mask=torch.from_numpy(m))[0]
        assert ck.PLAIN_CALLS["flash_attention"] == 0
        want_m = j.apply(jp, {}, jnp.asarray(x), False, None,
                         mask=jnp.asarray(m))[0]
        np.testing.assert_allclose(masked.numpy(), np.asarray(want_m),
                                   rtol=FWD_TOL, atol=FWD_TOL)
        np.testing.assert_allclose(
            short.numpy(),
            np.asarray(j.apply(jp, {}, jnp.asarray(x[:, :, :1023]), False,
                               None)[0]), rtol=FWD_TOL, atol=FWD_TOL)
    finally:
        jreg.clear_platform_override("flash_attention")
        treg.clear_platform_override("flash_attention")


# ------------------------------------------------- noise layers, training
@pytest.fixture
def jax_draws(monkeypatch):
    def mask(key, shape, keep, device):
        return torch.from_numpy(np.array(jax.random.bernoulli(
            jax.random.PRNGKey(key.seed), keep, tuple(shape))))

    def normal(key, shape, device):
        return torch.from_numpy(np.array(jax.random.normal(
            jax.random.PRNGKey(key.seed), tuple(shape), jnp.float32)))
    monkeypatch.setattr(tnorm, "dropout_mask", mask)
    monkeypatch.setattr(tnorm, "normal_draw", normal)


@pytest.mark.parametrize("name", ["GaussianNoiseLayer",
                                  "GaussianDropoutLayer",
                                  "AlphaDropoutLayer"])
def test_noise_layer_in_training_matches_jax_on_its_draws(jax_draws, name):
    j, t, _, _, _, _, x = _pair(name)
    want = j.apply({}, {}, jnp.asarray(x), True, jax.random.PRNGKey(13))[0]
    got = t.apply({}, {}, torch.from_numpy(x), True,
                  tnorm.StepKey(13, 0))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_TOL,
                               atol=FWD_TOL)


def test_noise_layers_draw_per_key():
    x = torch.zeros(64, 64)
    layer = tlayers.GaussianNoiseLayer(1.0)
    a = layer.apply({}, {}, x, True, tnorm.StepKey(1, 0, (3,)))[0]
    b = layer.apply({}, {}, x, True, tnorm.StepKey(1, 1, (3,)))[0]
    assert abs(float(a.std()) - 1) < 0.05 and not torch.equal(a, b)
    assert layer.apply({}, {}, x, False, None)[0] is x


# ------------------------------------------------------------ weight inits
@pytest.mark.parametrize("init,mean,std", [
    ("zeros", 0.0, 0.0), ("ones", 1.0, 0.0),
    ("xavier_gaussian", 0.0, math.sqrt(2.0 / (64 + 96))),
    ("he_uniform", 0.0, math.sqrt(6.0 / 64) / math.sqrt(3)),
    ("lecun_normal", 0.0, math.sqrt(1.0 / 64)),
    ("uniform", 0.0, 1.0 / math.sqrt(64) / math.sqrt(3)),
    ("normal", 0.0, 1.0 / math.sqrt(64)),
    ("xavier", 0.0, math.sqrt(6.0 / (64 + 96)) / math.sqrt(3)),
    ("relu", 0.0, math.sqrt(2.0 / 64))])
def test_weight_init_moments(init, mean, std):
    w = tlayers._initialize((64, 96), init,
                            torch.Generator().manual_seed(0))
    assert w.shape == (64, 96) and w.dtype == torch.float32
    assert abs(float(w.mean()) - mean) < 0.05 * max(std, 1e-3) * 4 + 1e-7
    assert abs(float(w.std()) - std) < 0.03 * std + 1e-7
    again = tlayers._initialize((64, 96), init,
                                torch.Generator().manual_seed(0))
    assert torch.equal(w, again)


def test_weight_init_conv3d_fans_and_unknown_name():
    # OIDHW: fan_in = I*kD*kH*kW, as the JAX package's
    w = tlayers._initialize((8, 4, 3, 3, 3), "lecun_normal",
                            torch.Generator().manual_seed(1))
    assert abs(float(w.std()) - math.sqrt(1.0 / (4 * 27))) < 0.01
    with pytest.raises(ValueError, match="unknown weight init"):
        tlayers._initialize((2, 2), "bogus", torch.Generator())


def test_a_jax_config_naming_a_new_init_initializes():
    jconf = (JConf.Builder().seed(1).weightInit("lecun_normal").list()
             .layer(jlayers.DenseLayer(nOut=4))
             .layer(jlayers.OutputLayer(nOut=2, weightInit="he_uniform"))
             .setInputType(JInputType.feedForward(3)).build())
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(
        jconf.to_json())).init(device="cpu")
    assert net.layers[0].weight_init == "lecun_normal"
    assert float(net._params[1]["W"].detach().abs().max()) <= \
        math.sqrt(6.0 / 4)


# ------------------------------------------------------------ SameDiffLayer
class _JGated(jlayers.SameDiffLayer):
    """tests/test_attention_layers.py's gated dense,
    y = sigmoid(x Wg) * tanh(x W), in the JAX package."""

    def defineParameters(self):
        return {"W": (self.nIn, self.nOut), "Wg": (self.nIn, self.nOut)}

    def defineLayer(self, sd, layerInput, paramTable, mask=None):
        h = layerInput.mmul(paramTable["W"]).tanh()
        g = layerInput.mmul(paramTable["Wg"]).sigmoid()
        return h * g


class _TGated(tlayers.SameDiffLayer):
    """The same fragment in the port."""

    def defineParameters(self):
        return {"W": (self.nIn, self.nOut), "Wg": (self.nIn, self.nOut)}

    def defineLayer(self, sd, layerInput, paramTable, mask=None):
        h = layerInput.mmul(paramTable["W"]).tanh()
        g = layerInput.mmul(paramTable["Wg"]).sigmoid()
        return h * g


def _gated_conf(Conf, M, Gated, It, upd):
    return (Conf.Builder().seed(9).updater(upd.Adam(5e-3))
            .weightInit("xavier").list()
            .layer(Gated(nOut=16))
            .layer(M.OutputLayer(nOut=3, lossFunction="mcxent",
                                 activation="softmax"))
            .setInputType(It.feedForward(10)).build())


def test_samediff_layer_trains_in_stack_like_jax():
    """test_attention_layers.py's first case through both packages from
    the JAX init: forward 1e-5, every param after each of 5 Adam steps
    within 2e-4 of its largest magnitude, and the port's loss halves over
    81 steps as the JAX one does."""
    jnet = JMLN(_gated_conf(JConf, jlayers, _JGated, JInputType,
                            jupd)).init()
    tnet = MultiLayerNetwork(_gated_conf(NeuralNetConfiguration, tlayers,
                                         _TGated, InputType, tupd))
    tnet.params_from_jax(jnet._params, jnet._states, device="cpu")
    rng = np.random.RandomState(0)
    x = rng.randn(32, 10).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 32)]
    out = tnet.output(x).numpy()
    assert out.shape == (32, 3)
    np.testing.assert_allclose(out, np.asarray(jnet.output(x)),
                               rtol=FWD_TOL, atol=FWD_TOL)
    for _ in range(5):
        jnet.fit(JDataSet(x, y))
        tnet.fit(DataSet(x, y))
        for jp, tp in zip(jnet._params, tnet._params):
            for k in jp:
                a = np.asarray(jp[k])
                np.testing.assert_allclose(
                    tp[k].detach().numpy(), a, rtol=0,
                    atol=GRAD_TOL * float(np.abs(a).max()), err_msg=k)
    first = tnet.score()
    np.testing.assert_allclose(first, float(jnet.score()), rtol=1e-5)
    for _ in range(76):
        tnet.fit(DataSet(x, y))
    assert tnet.score() < first * 0.5, (first, tnet.score())


def test_samediff_layer_records_a_fragment_per_dtype():
    """A forward at another dtype records its own fragment (its
    placeholders and constants at that dtype), kept off the layer's
    config: the bf16 forward is bf16 and within bf16 rounding of the
    fp32 one, and ``to_config`` and a copy of the layer carry no graph."""
    tl = _TGated(nOut=4, nIn=5, weightInit="xavier")
    p, _ = tl.initialize(torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.RandomState(0).randn(3, 5).astype(
        np.float32))
    y32, _ = tl.apply(p, {}, x, False)
    y16, _ = tl.apply({k: v.bfloat16() for k, v in p.items()}, {},
                      x.bfloat16(), False)
    cpu = torch.device("cpu")
    assert set(tlayers._SAMEDIFF_FRAGMENTS[tl]) == {
        (cpu, torch.float32), (cpu, torch.bfloat16)}
    assert y32.dtype == torch.float32 and y16.dtype == torch.bfloat16
    np.testing.assert_allclose(y16.float().numpy(), y32.numpy(), rtol=0,
                               atol=2e-2)
    json.dumps(tl.to_config())          # plain configuration, no graph
    assert copy.deepcopy(tl) not in tlayers._SAMEDIFF_FRAGMENTS


def test_samediff_layer_gradients_flow_through_fragment():
    """test_attention_layers.py's second case: the gradient of
    sum(y^2) reaches both params, equal to the JAX layer's within 2e-4 of
    the largest; the forward within 1e-5."""
    jl = _JGated(nOut=4, nIn=5, weightInit="xavier")
    tl = _TGated(nOut=4, nIn=5, weightInit="xavier")
    jp, _ = jl.initialize(jax.random.PRNGKey(0))
    tl.initialize(torch.Generator().manual_seed(0))
    tp = {k: torch.from_numpy(np.array(v)).requires_grad_(True)
          for k, v in jp.items()}
    xn = np.random.RandomState(0).randn(3, 5).astype(np.float32)
    x = jnp.asarray(xn)

    def loss(p):
        y, _ = jl.apply(p, {}, x, False, jax.random.PRNGKey(0))
        return jnp.sum(jnp.square(y))
    jg = jax.grad(loss)(jp)
    y, _ = tl.apply(tp, {}, torch.from_numpy(xn), False)
    np.testing.assert_allclose(
        y.detach().numpy(),
        np.asarray(jl.apply(jp, {}, x, False, jax.random.PRNGKey(0))[0]),
        rtol=FWD_TOL, atol=FWD_TOL)
    tg = torch.autograd.grad(y.square().sum(), [tp["W"], tp["Wg"]])
    for name, g in zip(("W", "Wg"), tg):
        assert float(g.abs().sum()) > 0
        want = np.asarray(jg[name])
        np.testing.assert_allclose(g.numpy(), want, rtol=0,
                                   atol=GRAD_TOL * float(np.abs(want).max()))
