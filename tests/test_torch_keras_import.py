"""Keras ``.h5`` import in the port against the JAX package's importer and
against Keras's own ``predict``, on the CPU: every Keras case of
``tests/test_modelimport.py`` (TestSequentialImport, TestFunctionalImport,
TestR4Mappers, TestR5Mappers, TestKerasImportReport; TestBertImport is
``tests/test_torch_bert_import.py``'s), each model generated live by
Keras, saved once, and imported by both packages; then the BERT-shaped
encoder of ``modelimport.keras_fixtures`` at E=32, L=2 as the slice as a
whole (both importers, Keras's ``predict``, and ``feedForward`` against
the JAX one node by node), and ``ZooModel.initPretrained`` from an ``.h5``.

Tolerances: the port against the JAX importer 1e-5 (fp32 forward, rtol
and atol); both against Keras the JAX tests' ``rtol=1e-4, atol=1e-5``.
"""

import numpy as np
import pytest
import torch

keras = pytest.importorskip("keras")
from keras import layers as KL  # noqa: E402

from deeplearning4j_tpu.modelimport import keras as jk  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import keras as tk  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import keras_fixtures as kf  # noqa: E402,E501
from test_torch_compilecache import fake_capture  # noqa: E402,F401 (fixture)

torch.set_num_threads(2)

JAX_TOL = 1e-5
KERAS_RTOL, KERAS_ATOL = 1e-4, 1e-5


def _nchw(x):
    return np.transpose(x, (0, 3, 1, 2))


def _ncw(x):
    return np.transpose(x, (0, 2, 1))


def _ncdhw(x):
    return np.transpose(x, (0, 4, 1, 2, 3))


def _rand(seed, *shape, normal=True):
    r = np.random.RandomState(seed)
    return (r.randn(*shape) if normal else r.rand(*shape)).astype(np.float32)


def _seq(*layers):
    return keras.Sequential(list(layers))


# ------------------------------------------------------------------ models
def _two_branch():
    inp = keras.Input(shape=(8, 8, 3), name="in0")
    a = KL.Conv2D(4, 3, padding="same", activation="relu", name="ca")(inp)
    b = KL.Conv2D(4, 5, padding="same", activation="relu", name="cb")(inp)
    c = KL.Concatenate(name="cat")([KL.Add(name="add")([a, b]), a])
    g = KL.GlobalAveragePooling2D(name="gap")(c)
    return keras.Model(inp, KL.Dense(3, activation="softmax", name="d")(g))


def _flatten_dense():
    inp = keras.Input(shape=(6, 6, 2), name="in0")
    c = KL.Conv2D(3, 3, padding="valid", activation="relu", name="c")(inp)
    return keras.Model(inp, KL.Dense(4, name="d")(KL.Flatten(name="f")(c)))


def _mha():
    inp = keras.Input((5, 8))
    y = KL.MultiHeadAttention(num_heads=2, key_dim=4, name="mha")(inp, inp)
    y = KL.GlobalAveragePooling1D()(y)
    return keras.Model(inp, KL.Dense(3, activation="softmax")(y))


def _add_concat_multibranch():
    inp = keras.Input((4, 4, 3))
    a = KL.Conv2D(4, 3, padding="same", activation="relu")(inp)
    b = KL.Conv2D(4, 1, activation="relu")(inp)
    c = KL.Concatenate()([KL.Add()([a, b]), a])
    y = KL.GlobalAveragePooling2D()(c)
    return keras.Model(inp, KL.Dense(2, activation="softmax")(y))


def _dot_merge():
    inp = keras.Input(shape=(6,), name="in0")
    a = KL.Dense(4, activation="tanh", name="da")(inp)
    b = KL.Dense(4, activation="tanh", name="db")(inp)
    dot = KL.Dot(axes=1, normalize=True, name="dot")([a, b])
    return keras.Model(inp, KL.Dense(2, activation="softmax",
                                     name="out")(dot))


def _masked_tail(x):
    x = x.copy()
    x[:, 4:] = 0.0
    return x


#: name -> (model builder, keras input, port/JAX input from it, compare
#: on: a function of (ours, keras's) returning the pair held equal)
CASES = {
    # TestSequentialImport
    "mlp": (lambda: _seq(keras.Input(shape=(6,)),
                         KL.Dense(8, activation="relu", name="d1"),
                         KL.Dense(3, activation="softmax", name="d2")),
            lambda: _rand(0, 4, 6), None),
    "cnn": (lambda: _seq(keras.Input(shape=(8, 8, 3)),
                         KL.Conv2D(4, 3, padding="same", activation="relu",
                                   name="c1"),
                         KL.MaxPooling2D(2, name="p1"),
                         KL.BatchNormalization(name="bn1"),
                         KL.Conv2D(6, 3, padding="valid", strides=2,
                                   activation="tanh", name="c2"),
                         KL.Flatten(name="f1"),
                         KL.Dense(5, activation="softmax", name="d1")),
            lambda: _rand(1, 2, 8, 8, 3), _nchw),
    "avgpool_depthwise": (lambda: _seq(
        keras.Input(shape=(6, 6, 4)),
        KL.DepthwiseConv2D(3, padding="same", depth_multiplier=2,
                           activation="relu", name="dw"),
        KL.AveragePooling2D(2, name="ap"),
        KL.GlobalAveragePooling2D(name="gap"), KL.Dense(3, name="d")),
        lambda: _rand(2, 2, 6, 6, 4), _nchw),
    "lstm": (lambda: _seq(keras.Input(shape=(5, 3)),
                          KL.LSTM(7, return_sequences=True, name="l1"),
                          KL.LSTM(4, return_sequences=False, name="l2"),
                          KL.Dense(2, activation="softmax", name="d")),
             lambda: _rand(3, 2, 5, 3), _ncw),
    "simple_rnn": (lambda: _seq(keras.Input(shape=(4, 2)),
                                KL.SimpleRNN(5, name="r1"),
                                KL.Dense(2, name="d")),
                   lambda: _rand(4, 3, 4, 2), _ncw),
    "gru": (lambda: _seq(keras.Input(shape=(5, 4)),
                         KL.GRU(6, return_sequences=True, name="g1"),
                         KL.GRU(3, name="g2")),
            lambda: _rand(1, 2, 5, 4), _ncw),
    "bidirectional_lstm": (lambda: _seq(
        keras.Input(shape=(6, 3)),
        KL.Bidirectional(KL.LSTM(5, return_sequences=True), name="bi1"),
        KL.Bidirectional(KL.LSTM(4), merge_mode="sum", name="bi2")),
        lambda: _rand(2, 2, 6, 3), _ncw),
    "conv1d": (lambda: _seq(keras.Input(shape=(10, 3)),
                            KL.Conv1D(8, 3, padding="causal",
                                      activation="relu", name="c1"),
                            KL.Conv1D(4, 3, padding="same", name="c2"),
                            KL.GlobalAveragePooling1D(name="gp")),
               lambda: _rand(3, 2, 10, 3), _ncw),
    "separable_pad_crop_upsample": (lambda: _seq(
        keras.Input(shape=(8, 8, 3)),
        KL.ZeroPadding2D(((1, 2), (0, 1)), name="zp"),
        KL.SeparableConv2D(6, (3, 3), padding="valid", activation="relu",
                           name="sc"),
        KL.UpSampling2D((2, 2), name="up"),
        KL.Cropping2D(((1, 1), (2, 2)), name="cr"),
        KL.GlobalAveragePooling2D(name="gp")),
        lambda: _rand(4, 2, 8, 8, 3, normal=False), _nchw),
    "pool1d_layernorm": (lambda: _seq(
        keras.Input(shape=(12, 6)),
        KL.Conv1D(8, 3, padding="same", activation="relu", name="c"),
        KL.MaxPooling1D(2, name="mp"), KL.LayerNormalization(name="ln"),
        KL.AveragePooling1D(2, name="ap"),
        KL.GlobalAveragePooling1D(name="gp")),
        lambda: _rand(6, 2, 12, 6), _ncw),
    "prelu_elu_repeat": (lambda: _seq(
        keras.Input(shape=(5,)), KL.Dense(6, name="d"), KL.PReLU(name="pr"),
        KL.ELU(name="el"), KL.RepeatVector(3, name="rv"),
        KL.GRU(4, name="g")), lambda: _rand(7, 3, 5), None),
    # TestFunctionalImport
    "two_branch": (_two_branch, lambda: _rand(5, 2, 8, 8, 3), _nchw),
    "functional_flatten_dense": (_flatten_dense,
                                 lambda: _rand(6, 2, 6, 6, 2), _nchw),
    "sequential_routes_through_entry_point": (
        lambda: _seq(keras.Input(shape=(4,)), KL.Dense(2, name="d")),
        lambda: _rand(7, 2, 4), None),
    # TestR4Mappers
    "conv3d_pool3d": (lambda: _seq(
        keras.Input((4, 4, 4, 2)), KL.Conv3D(3, 2, activation="relu"),
        KL.MaxPooling3D(1), KL.AveragePooling3D(1), KL.Flatten(),
        KL.Dense(5, activation="softmax")),
        lambda: _rand(0, 3, 4, 4, 4, 2, normal=False), _ncdhw),
    "1d_spatial_ops": (lambda: _seq(
        keras.Input((8, 3)), KL.ZeroPadding1D(1),
        KL.Conv1D(4, 3, activation="relu"), KL.UpSampling1D(2),
        KL.Cropping1D((1, 2)), KL.GlobalAveragePooling1D(), KL.Dense(2)),
        lambda: _rand(1, 2, 8, 3, normal=False), _ncw),
    "masking_and_time_distributed": (lambda: _seq(
        keras.Input((6, 3)), KL.Masking(mask_value=0.0),
        KL.TimeDistributed(KL.Dense(4, activation="tanh"))),
        lambda: _masked_tail(_rand(2, 2, 6, 3, normal=False)), _ncw,
        lambda ours, want: (_ncw(ours)[:, :4], want[:, :4])),
    "noise_layers_inference_identity": (lambda: _seq(
        keras.Input((5,)), KL.GaussianNoise(0.5), KL.GaussianDropout(0.3),
        KL.AlphaDropout(0.2), KL.Dense(3)),
        lambda: _rand(3, 4, 5, normal=False), None),
    "relu_softmax_thresholded_layers": (lambda: _seq(
        keras.Input((6,)), KL.Dense(8), KL.ReLU(), KL.Dense(4),
        KL.Softmax()), lambda: _rand(4, 3, 6), None),
    "multi_head_attention": (_mha, lambda: _rand(5, 2, 5, 8, normal=False),
                             _ncw),
    "functional_add_concat_multibranch": (
        _add_concat_multibranch, lambda: _rand(6, 2, 4, 4, 3, normal=False),
        _nchw),
    # TestR5Mappers
    **{f"conv2d_transpose_{pad}{s}": (
        lambda pad=pad, s=s: _seq(
            keras.Input(shape=(5, 5, 3)),
            KL.Conv2DTranspose(4, 3, strides=s, padding=pad,
                               activation="relu", name=f"dc_{pad}{s}")),
        lambda: _rand(7, 2, 5, 5, 3), _nchw,
        lambda ours, want: (ours, _nchw(want)))
       for pad, s in (("same", 2), ("valid", 1), ("valid", 2))},
    "3d_pad_crop_upsample_globalpool": (lambda: _seq(
        keras.Input(shape=(4, 4, 4, 2)), KL.ZeroPadding3D(1, name="zp"),
        KL.Conv3D(3, 3, activation="relu", name="c3"),
        KL.UpSampling3D(2, name="up"), KL.Cropping3D(1, name="cr"),
        KL.GlobalAveragePooling3D(name="gap")),
        lambda: _rand(8, 2, 4, 4, 4, 2), _ncdhw),
    "spatial_dropout_activity_reg_inference_identity": (lambda: _seq(
        keras.Input(shape=(6, 3)), KL.SpatialDropout1D(0.4, name="sd1"),
        KL.ActivityRegularization(l2=0.01, name="ar"),
        KL.GlobalAveragePooling1D(name="gp")),
        lambda: _rand(9, 2, 6, 3), _ncw),
    "functional_dot_merge": (_dot_merge, lambda: _rand(10, 3, 6), None),
    "group_and_unit_normalization": (lambda: _seq(
        keras.Input(shape=(6, 6, 8)),
        KL.GroupNormalization(groups=4, name="gn"), KL.Conv2D(4, 3, name="c"),
        KL.GlobalAveragePooling2D(name="gp"),
        KL.UnitNormalization(name="un")),
        lambda: _rand(11, 2, 6, 6, 8), _nchw),
    "group_norm_instance_and_weightfree_variants": (lambda: _seq(
        keras.Input(shape=(5, 5, 6)),
        KL.GroupNormalization(groups=-1, name="inst"),
        KL.GroupNormalization(groups=3, center=False, scale=False,
                              name="nw"),
        KL.GlobalAveragePooling2D(name="gp")),
        lambda: _rand(12, 2, 5, 5, 6), _nchw),
    "conv_lstm2d": (lambda: _seq(
        keras.Input(shape=(4, 8, 8, 2)),
        KL.ConvLSTM2D(3, 3, padding="same", return_sequences=False,
                      name="cl"), KL.GlobalAveragePooling2D(name="gp")),
        lambda: _rand(13, 2, 4, 8, 8, 2), _ncdhw),
    "conv_lstm2d_sequences_valid_padding": (lambda: _seq(
        keras.Input(shape=(3, 6, 6, 2)),
        KL.ConvLSTM2D(2, 3, padding="valid", return_sequences=True,
                      name="cl"), KL.GlobalAveragePooling3D(name="gp")),
        lambda: _rand(14, 2, 3, 6, 6, 2), _ncdhw),
}


def _save(tmp_path, model, name="m.h5"):
    p = str(tmp_path / name)
    model.save(p)
    return p


def _import_both(path, sequential: bool):
    """The JAX importer's net and the port's (on the CPU), from one file,
    through the entry point the JAX test uses."""
    if sequential:
        return (jk.importKerasSequentialModelAndWeights(path),
                tk.importKerasSequentialModelAndWeights(path, device="cpu"))
    return (jk.importKerasModelAndWeights(path),
            tk.importKerasModelAndWeights(path, device="cpu"))


@pytest.mark.parametrize("name", list(CASES))
def test_keras_model_imports_as_jax_and_keras(tmp_path, name):
    build, make_x, to_ours, *pick = CASES[name]
    model = build()
    x = make_x()
    want = model.predict(x, verbose=0)
    path = _save(tmp_path, model)
    sequential = isinstance(model, keras.Sequential) and \
        name != "sequential_routes_through_entry_point"
    jnet, tnet = _import_both(path, sequential)
    ours_x = to_ours(x) if to_ours else x
    got = tnet.output(ours_x).numpy()
    np.testing.assert_allclose(got, np.asarray(jnet.output(ours_x)),
                               rtol=JAX_TOL, atol=JAX_TOL,
                               err_msg="port vs the JAX importer")
    a, b = pick[0](got, want) if pick else (got, want)
    np.testing.assert_allclose(a, b, rtol=KERAS_RTOL, atol=KERAS_ATOL,
                               err_msg="port vs Keras predict")
    assert type(tnet).__name__ == type(jnet).__name__
    jlayers = jnet.layers if type(jnet).__name__ == "MultiLayerNetwork" \
        else [n.obj for n in jnet.conf.topo if n.kind == "layer"]
    assert [type(lay).__name__ for _, lay in tnet._layers()] == \
        [type(lay).__name__ for lay in jlayers]


def test_unsupported_layer_reported(tmp_path):
    m = _seq(keras.Input(shape=(8, 8, 3)),
             KL.RandomRotation(0.2, name="weird"), KL.Conv2D(4, 3, name="c"))
    path = _save(tmp_path, m)
    for imp in (jk.importKerasSequentialModelAndWeights,
                lambda p: tk.importKerasSequentialModelAndWeights(
                    p, device="cpu")):
        with pytest.raises(ValueError, match="RandomRotation"):
            imp(path)
    with pytest.raises(tk.KerasImportError, match="RandomRotation"):
        tk.importKerasSequentialModelAndWeights(path, device="cpu")


def test_init_pretrained_from_h5(tmp_path, monkeypatch):
    from deeplearning4j_tpu.models.zoo import LeNet as JLeNet
    from deeplearning4j_tpu_torch.models.zoo import LeNet
    m = _seq(keras.Input(shape=(6,)), KL.Dense(4, activation="relu"),
             KL.Dense(2, activation="softmax"))
    p = _save(tmp_path, m, "pre.h5")
    net = LeNet().initPretrained(path=p, device="cpu")
    x = _rand(5, 3, 6)
    want = m.predict(x, verbose=0)
    np.testing.assert_allclose(net.output(x).numpy(), want,
                               rtol=KERAS_RTOL, atol=KERAS_ATOL)
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(JLeNet().initPretrained(path=p)
                                          .output(x)),
                               rtol=JAX_TOL, atol=JAX_TOL)
    # the data-directory lookup and its error text
    monkeypatch.setenv("DL4J_TPU_DATA_DIR", str(tmp_path))
    (tmp_path / "pretrained").mkdir()
    with pytest.raises(FileNotFoundError, match="lenet_imagenet.zip"):
        LeNet().initPretrained(device="cpu")
    (tmp_path / "pretrained" / "lenet_mnist.h5").write_bytes(
        (tmp_path / "pre.h5").read_bytes())
    net = LeNet().initPretrained("MNIST", device="cpu")
    np.testing.assert_allclose(net.output(x).numpy(), want,
                               rtol=KERAS_RTOL, atol=KERAS_ATOL)


# --------------------------------------------------------- import report
def test_clean_model_attaches_empty_report(tmp_path):
    m = _seq(keras.Input(shape=(6,)), KL.Dense(4, activation="relu",
                                               name="d1"))
    net = tk.importKerasSequentialModelAndWeights(_save(tmp_path, m),
                                                  device="cpu")
    assert not net.import_report.diagnostics, net.import_report.format()


def test_w161_on_dynamic_sequence_length(tmp_path):
    m = _seq(keras.Input(shape=(None, 6)), KL.LSTM(4, name="l1"))
    path = _save(tmp_path, m)
    net = tk.importKerasSequentialModelAndWeights(path, device="cpu")
    jnet = jk.importKerasSequentialModelAndWeights(path)
    assert "DL4J-W161" in net.import_report.codes()
    assert net.import_report.codes() == [d.code for d in jnet.import_report]


def test_functional_import_attaches_report(tmp_path):
    inp = keras.Input(shape=(6,))
    m = keras.Model(inp, KL.Dense(3, name="d")(inp))
    net = tk.importKerasModelAndWeights(_save(tmp_path, m), device="cpu")
    assert hasattr(net, "import_report")
    assert net.import_report.subject == "Keras import"


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    m = _seq(keras.Input(shape=(4,)), KL.Dense(2, name="d"))
    path = _save(tmp_path, m)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for imp in (tk.importKerasModelAndWeights,
                tk.importKerasSequentialModelAndWeights):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            imp(path)


# ----------------------------------------- the encoder, the slice whole
ENC = dict(V=50, P=16, E=32, H=2, L=2, F=64, n_classes=2)


@pytest.fixture(scope="module")
def encoder(tmp_path_factory):
    """The fixture encoder (E=32, L=2) written once, with both imports
    and a batch."""
    path = str(tmp_path_factory.mktemp("enc") / "encoder.h5")
    n = kf.encoder_h5(path, seed=0, **ENC)
    rng = np.random.default_rng(1)
    tok = rng.integers(0, ENC["V"], (3, ENC["P"])).astype(np.int32)
    pos = np.tile(np.arange(ENC["P"], dtype=np.int32), (3, 1))
    return (path, n, jk.importKerasModelAndWeights(path),
            tk.importKerasModelAndWeights(path, device="cpu"), tok, pos)


def test_encoder_imports_as_jax_and_keras(encoder):
    path, n, jnet, tnet, tok, pos = encoder
    assert n == tnet.numParams() == 19330
    got = tnet.output([tok, pos]).numpy()
    np.testing.assert_allclose(got, np.asarray(jnet.output([tok, pos])),
                               rtol=JAX_TOL, atol=JAX_TOL)
    model = keras.models.load_model(path)
    np.testing.assert_allclose(got, model.predict([tok, pos], verbose=0),
                               rtol=KERAS_RTOL, atol=KERAS_ATOL)
    kinds = [type(lay).__name__ for _, lay in tnet._layers()]
    assert kinds.count("LayerNorm") == 1 + 2 * ENC["L"]
    assert kinds.count("SelfAttentionLayer") == ENC["L"]
    assert kinds.count("TimeDistributed") == 2 * ENC["L"]


def test_encoder_feed_forward_matches_jax_node_by_node(encoder):
    _, _, jnet, tnet, tok, pos = encoder
    want = jnet.feedForward([tok, pos])
    got = tnet.feedForward([tok, pos])
    assert list(got) == list(want)
    for name in want:           # the first node that parts names itself
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=JAX_TOL, atol=JAX_TOL, err_msg=name)
    np.testing.assert_array_equal(got["head"].numpy(),
                                  tnet.output([tok, pos]).numpy())


def test_encoder_layer_norms_take_the_registry_kernel(encoder):
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.ops import registry as treg
    _, _, _, tnet, tok, pos = encoder
    want = tnet.output([tok, pos])
    treg.register_platform_override("layer_norm",
                                    ck.make_layer_norm_override())
    try:
        ck.reset_counts()
        got = tnet.output([tok, pos])
        assert ck.PLAIN_CALLS["layer_norm"] == 1 + 2 * ENC["L"]
        assert ck.PLAIN_CALLS["flash_attention"] == 0    # T < 1024
    finally:
        treg.clear_platform_override("layer_norm")
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=JAX_TOL,
                               atol=JAX_TOL)


def test_encoder_weights_are_views_of_one_read(encoder):
    from deeplearning4j_tpu_torch.modelimport.hdf5 import Hdf5Archive
    path = encoder[0]
    arch = Hdf5Archive(path)
    try:
        kw = arch.layer_weights("mha_0")
        buf = arch._f._buf.data
        lo = np.frombuffer(buf, np.uint8).__array_interface__["data"][0]
        for a in kw.values():          # inside the one buffer, no copy
            p = a.__array_interface__["data"][0]
            assert not a.flags.owndata and lo <= p < lo + len(buf)
        assert sorted(kw) == sorted(
            f"{p}/{w}" for p in ("query", "key", "value", "attention_output")
            for w in ("kernel", "bias"))
        assert arch.keras_version() == kf.KERAS_VERSION
    finally:
        arch.close()


def test_encoder_serves_captured_as_the_card_path_does(encoder,
                                                       fake_capture):
    """Phase 28's serving function on the CPU: the position ids made
    from the request's shape on its device, the forward taken by the
    server's capture (the stand-in graph), every request equal to a
    direct ``output()``."""
    from deeplearning4j_tpu_torch.serving import ModelServer
    _, _, _, tnet, tok, _ = encoder

    def classify(tokens):
        pos = torch.arange(tokens.shape[1], device=tokens.device,
                           dtype=torch.int32).expand(tokens.shape[0], -1)
        return tnet.output([tokens, pos])

    with ModelServer(classify, device="cpu", batch_limit=4,
                     input_dtype=np.int32) as sv:
        sv.warmup([(ENC["P"],)])
        assert len(fake_capture) == len(sv.buckets())
        got = [sv.output(tok[:n], timeout=60) for n in (1, 3)]
        assert sv.recompiles_after_warmup() == 0
    for n, g in zip((1, 3), got):
        want = classify(torch.from_numpy(tok[:n])).numpy()
        np.testing.assert_allclose(g, want, rtol=JAX_TOL, atol=1e-6)
