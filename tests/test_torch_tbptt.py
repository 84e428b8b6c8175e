"""Sequence training and streaming in the port's MultiLayerNetwork
against the JAX package's, on the CPU: ``fitTBPTT`` (windows, carried
state, the label mask), ``fit()`` under ``backpropType("tbptt", L)``,
``fit()`` with a feature mask, ``rnnTimeStep`` in chunks against
``output()``, a small TextGenerationLSTM, the configuration JSON with
``backprop_type``, the archives of recurrent nets, and the normalizers
with their files — each in both directions where the packages meet.

The JAX net's init gives both nets their weights (``params_from_jax``);
inputs are one-hot characters or normals from numpy with a seed.
Parity runs are dropout-free (the JAX window step's dropout key is
``fold_in(PRNGKey(seed), t)``; the port's counter-based masks differ).

Tolerances (tests/test_pallas.py's): fp32 forward 1e-5 (rtol and atol);
params and Adam moments after 1 and 3 windows within 2e-4 (rtol and
atol, the moments' atol scaled to each one's largest magnitude).
"""

import io
import json
import os
import zipfile

import numpy as np
import pytest

import torch

from deeplearning4j_tpu.data import dataset as jdata
from deeplearning4j_tpu.models import zoo as jzoo
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.train import serializer as jser
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch.analysis import churn
from deeplearning4j_tpu_torch.data import dataset as tdata
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn import compilecache as cc
from deeplearning4j_tpu_torch.nn import layers as tlayers
from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                MultiLayerConfiguration,
                                                NeuralNetConfiguration)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.train import serializer as tser
from deeplearning4j_tpu_torch.train import updaters as tupd

torch.set_num_threads(2)

FWD_TOL = 1e-5
FIT_TOL = 2e-4
V, H, N, L = 7, 8, 3, 4


def _conf(Conf, M, It, upd, tbptt=None, bidi=False):
    b = (Conf.Builder().seed(5).updater(upd.Adam(1e-2)).weightInit("xavier")
         .gradientNormalization("clip_value", 5.0).list())
    b.layer(M.Bidirectional(M.LSTM(nOut=H)) if bidi else M.LSTM(nOut=H))
    b.layer(M.GravesLSTM(nOut=H))
    b.layer(M.RnnOutputLayer(nOut=V, lossFunction="mcxent",
                             activation="softmax"))
    b.setInputType(It.recurrent(V, 3 * L))
    if tbptt:
        b.backpropType("tbptt", tbptt)
    return b.build()


def _pair(tbptt=None, bidi=False):
    j = JMLN(_conf(JConf, jlayers, JInputType, jupd, tbptt, bidi))
    j.init()
    t = MultiLayerNetwork(_conf(NeuralNetConfiguration, tlayers, InputType,
                                tupd, tbptt, bidi)).params_from_jax(
        j._params, j._states, device="cpu")
    return j, t


def _k_conf(Conf, M, It, upd):
    b = (Conf.Builder().seed(7).updater(upd.Adam(1e-2)).weightInit("xavier")
         .list())
    b.layer(M.LSTM(nOut=8))
    b.layer(M.RnnOutputLayer(nOut=5, lossFunction="mcxent",
                             activation="softmax"))
    b.setInputType(It.recurrent(5, 12))
    b.backpropType("tbptt", 4)
    return b.build()


def _k_pair():
    """The LSTM(8) + RnnOutputLayer net under ``backpropType("tbptt", 4)``
    in both packages, from the JAX init."""
    j = JMLN(_k_conf(JConf, jlayers, JInputType, jupd))
    j.init()
    t = MultiLayerNetwork(_k_conf(NeuralNetConfiguration, tlayers, InputType,
                                  tupd)).params_from_jax(
        j._params, j._states, device="cpu")
    return j, t


def _chars(seed, T=3 * L, n=N):
    """One-hot characters [n, V, T] and the next character as labels."""
    r = np.random.default_rng(seed)
    idx = r.integers(0, V, (n, T + 1))
    eye = np.eye(V, dtype=np.float32)
    return (eye[idx[:, :-1]].transpose(0, 2, 1),
            eye[idx[:, 1:]].transpose(0, 2, 1))


def _ragged(T=3 * L):
    m = np.ones((N, T), np.float32)
    m[0, T - 3:] = 0.0
    m[1, 5:] = 0.0
    return m


def _assert_state(j, t, tol=FIT_TOL):
    for i, p in enumerate(j._params):
        for k, want in p.items():
            np.testing.assert_allclose(
                t._params[i][k].detach().numpy(), np.asarray(want),
                rtol=tol, atol=tol, err_msg=f"param {i}.{k}")
            for s, ref in j._opt_state[i][k].items():
                ref = np.asarray(ref)
                np.testing.assert_allclose(
                    t._opt_state[i][k][s].numpy(), ref, rtol=tol,
                    atol=tol * max(float(np.abs(ref).max()), 1e-30),
                    err_msg=f"moment {i}.{k}.{s}")
    assert t.getIterationCount() == j._iteration
    if t._t_dev is not None and getattr(j, "_t_dev", None) is not None:
        assert int(t._t_dev) == int(np.asarray(j._t_dev))


@pytest.mark.parametrize("labels_mask", [False, True])
@pytest.mark.parametrize("windows", [1, 3])
def test_fit_tbptt_matches_jax(windows, labels_mask):
    j, t = _pair()
    x, y = _chars(1, T=windows * L)
    lm = _ragged(windows * L) if labels_mask else None
    j.fitTBPTT(jdata.DataSet(x, y, None, lm), L)
    t.fitTBPTT(tdata.DataSet(x, y, None, lm), L)
    np.testing.assert_allclose(t.score(), float(j.score()), rtol=FWD_TOL)
    _assert_state(j, t)


def test_a_window_ignores_the_feature_mask():
    """The JAX window step passes ``mask=None`` to the layers."""
    _, a = _pair()
    _, b = _pair()
    x, y = _chars(2)
    a.fitTBPTT(tdata.DataSet(x, y), L)
    b.fitTBPTT(tdata.DataSet(x, y, _ragged()), L)
    for pa, pb in zip(a._params, b._params):
        for k in pa:
            assert torch.equal(pa[k], pb[k])


def test_fit_under_the_tbptt_configuration_matches_jax():
    j, t = _pair(tbptt=L)
    _, ref = _pair()
    assert t._tbptt_length() == L
    data = [_chars(s) for s in (3, 4)]
    j.fit([jdata.DataSet(x, y) for x, y in data])
    t.fit([tdata.DataSet(x, y) for x, y in data])
    for x, y in data:
        ref.fitTBPTT(tdata.DataSet(x, y), L)
    _assert_state(j, t)
    assert t.getIterationCount() == 6
    for pa, pb in zip(t._params, ref._params):
        for k in pa:
            assert torch.equal(pa[k], pb[k])
    assert set(t._step_cache) == {("tbptt", False)}
    # one churn signature: every window, the first included, has the same
    # arguments (the first starts from zeros, not from None)
    assert churn.get_churn_detector().signature_count(
        "MultiLayerNetwork.tbptt", owner=t) == 1
    # fit(steps_per_dispatch=2) under TBPTT ignores K, as the JAX fit does
    # (JAX multilayer.py:907-913): an LSTM(8) + RnnOutputLayer net with
    # backpropType("tbptt", 4), two [2, 5, 12] batches, 6 window updates
    jk, tk = _k_pair()
    x, y = _chars(6, T=12, n=2)
    x, y = x[:, :5], y[:, :5]
    jk.fit([jdata.DataSet(x, y)] * 2, steps_per_dispatch=2)
    tk.fit([tdata.DataSet(x, y)] * 2, steps_per_dispatch=2)
    assert jk._iteration == 6
    _assert_state(jk, tk)
    assert set(tk._step_cache) == {("tbptt", False)}


def test_fit_with_a_feature_mask_matches_jax():
    """The plain step (no TBPTT) gives the mask to the mask-aware layers;
    both masks give a signature and a dispatch of their own."""
    j, t = _pair()
    x, y = _chars(5)
    m = _ragged()
    j.fit(jdata.DataSet(x, y, m, m))
    t.fit(tdata.DataSet(x, y, m, m))
    np.testing.assert_allclose(t.score(), float(j.score()), rtol=FWD_TOL)
    _assert_state(j, t)
    np.testing.assert_allclose(
        t.score(tdata.DataSet(x, y, m, m)),
        float(j.score(jdata.DataSet(x, y, m, m))), rtol=FWD_TOL)
    t.fit(tdata.DataSet(x, y, m))
    t.fit(tdata.DataSet(x, y))
    assert set(t._step_cache) == {(True, True, 1), (True, False, 1),
                                  (False, False, 1)}


def test_rnn_time_step_in_chunks_equals_output():
    j, t = _pair()
    x, _ = _chars(6, T=12)
    full = t.output(x)
    np.testing.assert_allclose(full.numpy(), np.asarray(j.output(x)),
                               rtol=FWD_TOL, atol=FWD_TOL)
    for chunk in (1, 2, 5):
        t.rnnClearPreviousState()
        parts = [t.rnnTimeStep(x[:, :, i:i + chunk])
                 for i in range(0, 12, chunk)]
        np.testing.assert_allclose(torch.cat(parts, dim=2).numpy(),
                                   full.numpy(), rtol=FWD_TOL, atol=FWD_TOL)
    t.rnnClearPreviousState()
    j.rnnClearPreviousState()
    for i in range(3):                      # [N, C] steps -> [N, C_out]
        got = t.rnnTimeStep(x[:, :, i])
        want = j.rnnTimeStep(x[:, :, i])
        assert got.shape == (N, V)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FWD_TOL, atol=FWD_TOL)
    h, c = t.rnnGetPreviousState(0)
    jh, jc = j.rnnGetPreviousState(0)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=FWD_TOL,
                               atol=FWD_TOL)
    cont = t.rnnTimeStep(x[:, :, :2])
    t.rnnClearPreviousState()
    assert t.rnnGetPreviousState(0) is None
    fresh = t.rnnTimeStep(x[:, :, :2])
    assert not torch.allclose(cont, fresh)
    np.testing.assert_allclose(fresh.numpy(), full[:, :, :2].numpy(),
                               rtol=FWD_TOL, atol=FWD_TOL)


def test_rnn_time_step_runs_stateless_layers_on_the_chunk():
    j, t = _pair(bidi=True)
    x, _ = _chars(7, T=6)
    for i in (0, 3):
        np.testing.assert_allclose(
            t.rnnTimeStep(x[:, :, i:i + 3]).numpy(),
            np.asarray(j.rnnTimeStep(x[:, :, i:i + 3])),
            rtol=FWD_TOL, atol=FWD_TOL)


def test_text_generation_lstm_matches_jax():
    """A small TextGenerationLSTM (vocab 30, T=12): the forward and one
    fitTBPTT window."""
    kw = {"vocab_size": 30, "input_shape": (30, 12)}
    j = jzoo.TextGenerationLSTM(**kw).init()
    t = zoo.TextGenerationLSTM(**kw).conf_builder().params_from_jax(
        j._params, j._states, device="cpu")
    assert [(type(a).__name__, a.nIn, a.nOut) for a in t.layers] == \
        [(type(a).__name__, a.nIn, a.nOut) for a in j.layers] == \
        [("LSTM", 30, 256), ("LSTM", 256, 256), ("RnnOutputLayer", 256, 30)]
    assert t.conf.base.grad_norm == "clip_value" \
        and t.conf.base.grad_norm_threshold == 5.0
    r = np.random.default_rng(8)
    idx = r.integers(0, 30, (2, 13))
    eye = np.eye(30, dtype=np.float32)
    x, y = eye[idx[:, :-1]].transpose(0, 2, 1), eye[idx[:, 1:]].transpose(
        0, 2, 1)
    np.testing.assert_allclose(t.output(x).numpy(), np.asarray(j.output(x)),
                               rtol=FWD_TOL, atol=FWD_TOL)
    j.fitTBPTT(jdata.DataSet(x, y), 12)
    t.fitTBPTT(tdata.DataSet(x, y), 12)
    np.testing.assert_allclose(t.score(), float(j.score()), rtol=FWD_TOL)
    _assert_state(j, t)


def test_warmup_keeps_state_and_fits_eagerly_on_the_cpu():
    _, t = _pair(tbptt=L)
    x, y = _chars(9)
    t._ensure_opt_state()
    t._ensure_clock()
    before = [v.clone() for v in t._dispatch_state()]
    cc.warmup(t, [(x.shape, y.shape)])
    assert all(torch.equal(a, b) for a, b in zip(before, t._dispatch_state()))
    t.fit(tdata.DataSet(x, y))
    assert t.getIterationCount() == 3


def test_warmup_of_k_steps_under_tbptt_warms_the_megastep():
    """As the JAX ``warmup``: K > 1 steps warm the plain K-step megastep
    (here, on the CPU, its dispatch), whatever the configuration's
    backprop type; the state is left as it was."""
    _, t = _k_pair()
    before = [v.clone() for v in t._params[0].values()]
    cc.warmup(t, [((2, 5, 12), (2, 5, 12))], steps_per_dispatch=2)
    cc.warmup(t, [((2, 5), (2, 5))], steps_per_dispatch=2)
    assert (False, False, 2) in t._step_cache
    assert ("tbptt", False) not in t._step_cache
    for a, b in zip(before, t._params[0].values()):
        assert torch.equal(a, b)
    assert t.getIterationCount() == 0


def test_config_json_with_tbptt_crosses_both_ways():
    jc = _conf(JConf, jlayers, JInputType, jupd, tbptt=L)
    tc = _conf(NeuralNetConfiguration, tlayers, InputType, tupd, tbptt=L)
    assert json.loads(tc.to_json()) == json.loads(jc.to_json())
    back = MultiLayerConfiguration.from_json(jc.to_json())
    assert (back.backprop_type, back.tbptt_length) == ("tbptt", L)
    jback = type(jc).from_json(tc.to_json())
    assert (jback.backprop_type, jback.tbptt_length) == ("tbptt", L)
    b = NeuralNetConfiguration.Builder().list().tBPTTForwardLength(7)
    assert b.tbptt_length == 7
    b.tBPTTBackwardLength(9)
    assert b.backpropType("TruncatedBPTT").build().tbptt_length == 9


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_archive_of_a_tbptt_net_crosses(tmp_path, direction):
    j, t = _pair(tbptt=L)
    x, y = _chars(10)
    j.fit(jdata.DataSet(x, y))
    t.fit(tdata.DataSet(x, y))
    path = str(tmp_path / "net.zip")
    if direction == "port_to_jax":
        t.save(path)
        back = JMLN.load(path)
        assert (back.conf.backprop_type, back.conf.tbptt_length) == \
            ("tbptt", L)
        np.testing.assert_allclose(np.asarray(back.output(x)),
                                   t.output(x).numpy(), rtol=FWD_TOL,
                                   atol=FWD_TOL)
        _assert_state(back, MultiLayerNetwork.load(path, device="cpu"),
                      tol=0)
    else:
        j.save(path)
        back = MultiLayerNetwork.load(path, device="cpu")
        assert back._tbptt_length() == L
        np.testing.assert_allclose(back.output(x).numpy(),
                                   np.asarray(j.output(x)), rtol=FWD_TOL,
                                   atol=FWD_TOL)
        _assert_state(j, back, tol=0)


def test_archive_and_clone_of_a_bidirectional_net(tmp_path):
    """The port stores a wrapper's params by their flat names and reads
    them back; the JAX package's archive of one holds a pickled dict,
    which the port refuses by name."""
    j, t = _pair(bidi=True)
    x, y = _chars(11)
    t.fit(tdata.DataSet(x, y))
    path = str(tmp_path / "bidi.zip")
    t.save(path)
    back = MultiLayerNetwork.load(path, device="cpu")
    assert torch.equal(back.output(x), t.output(x))
    assert torch.equal(t.clone().output(x), t.output(x))
    with zipfile.ZipFile(path) as z:
        names = np.load(io.BytesIO(z.read("arrays.npz"))).files
    assert {"p0::fwd/W", "p0::bwd/RW", "p1::W"} <= set(names)
    jpath = str(tmp_path / "jbidi.zip")
    j.save(jpath)
    with pytest.raises(tser.CorruptModelError, match="p0::"):
        MultiLayerNetwork.load(jpath, device="cpu")


# ------------------------------------------------------------ normalizers
def _features3d(seed=12):
    r = np.random.default_rng(seed)
    return (3.0 + 2.0 * r.standard_normal((5, 4, 6))).astype(np.float32)


@pytest.mark.parametrize("shape", [(6, 4), (5, 4, 6), (2, 3, 4, 4)])
def test_standardize_matches_jax(shape):
    r = np.random.default_rng(13)
    x = (1.5 + 2.0 * r.standard_normal(shape)).astype(np.float32)
    jn, tn = jdata.NormalizerStandardize(), tdata.NormalizerStandardize()
    jn.fit(jdata.DataSet(x, None))
    tn.fit(tdata.DataSet(x, None))
    np.testing.assert_array_equal(tn.mean, jn.mean)
    np.testing.assert_array_equal(tn.std, jn.std)
    np.testing.assert_array_equal(tn.transform(x), jn.transform(x))
    out = tn.transform(tdata.DataSet(x, None)).features
    axes = tuple(i for i in range(len(shape)) if i != 1) \
        if len(shape) > 2 else (0,)
    np.testing.assert_allclose(out.mean(axis=axes), 0.0, atol=1e-5)
    np.testing.assert_allclose(out.std(axis=axes), 1.0, atol=1e-4)
    np.testing.assert_allclose(tn.revert(out), x, rtol=1e-5, atol=1e-5)
    if len(shape) == 2:
        np.testing.assert_array_equal(tn.revert(out), jn.revert(out))


def test_minmax_and_image_scalers_match_jax():
    x = _features3d()
    for jn, tn in ((jdata.NormalizerMinMaxScaler(-1.0, 1.0),
                    tdata.NormalizerMinMaxScaler(-1.0, 1.0)),
                   (jdata.ImagePreProcessingScaler(0.0, 2.0),
                    tdata.ImagePreProcessingScaler(0.0, 2.0))):
        jn.fit(x)
        tn.fit(x)
        np.testing.assert_array_equal(tn.transform(x), jn.transform(x))
    out = tdata.NormalizerMinMaxScaler(-1.0, 1.0)
    out.fit(x)
    y = out.transform(x)
    assert float(y.min()) == -1.0 and abs(float(y.max()) - 1.0) < 1e-6


@pytest.mark.parametrize("name", ["NormalizerStandardize",
                                  "NormalizerMinMaxScaler",
                                  "ImagePreProcessingScaler"])
@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_normalizer_files_cross(tmp_path, name, direction):
    x = _features3d(14)
    src_mod, dst_mod = (tdata, jdata) if direction == "port_to_jax" \
        else (jdata, tdata)
    src_ser = tser.ModelSerializer if direction == "port_to_jax" \
        else jser.ModelSerializer
    dst_ser = jser.ModelSerializer if direction == "port_to_jax" \
        else tser.ModelSerializer
    norm = getattr(src_mod, name)()
    norm.fit(x)
    path = str(tmp_path / "norm")
    src_ser.writeNormalizer(norm, path)
    assert os.listdir(tmp_path) == ["norm"]
    back = dst_ser.restoreNormalizer(path)
    assert type(back) is getattr(dst_mod, name)
    np.testing.assert_allclose(np.asarray(back.transform(x)),
                               np.asarray(norm.transform(x)), rtol=1e-6,
                               atol=1e-6)


def test_a_bad_normalizer_file_raises_by_name(tmp_path):
    path = str(tmp_path / "bad.npz")
    np.savez(path, __class__=np.asarray("DataSet"))
    with pytest.raises(tser.CorruptModelError, match="DataSet"):
        tser.ModelSerializer.restoreNormalizer(path)
    np.savez(path, mean=np.zeros(2))
    with pytest.raises(tser.CorruptModelError, match="__class__"):
        tser.ModelSerializer.restoreNormalizer(path)


def test_the_char_rnn_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        zoo.TextGenerationLSTM(vocab_size=5, input_shape=(5, 4)).init()
