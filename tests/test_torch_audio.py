"""The port's DataVec audio (``deeplearning4j_tpu_torch/data/audio.py``)
against the JAX package's on the CPU, case for case with
``tests/test_audio.py``: the WAV files both write are the same bytes and
read back the same samples; spectrogram, mel filterbank, mel spectrogram
and MFCC agree within 1e-5 (relative to each array's largest magnitude:
both are the same float64 numpy, so they agree far closer); the reader's
labels and features and the iterator's batches are bit-equal; and the
Conv1D classifier learns from the port's batches. Then the clips
``chip_smoke.py`` phase 32 (c) writes, at 16 kHz and 124 frames.
"""

import os

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import audio as J
from deeplearning4j_tpu.data.dataset import NormalizerStandardize as JNorm
from deeplearning4j_tpu_torch.data import audio as T
from deeplearning4j_tpu_torch.data import datavec_fixtures as fx
from deeplearning4j_tpu_torch.data.dataset import DataSet, NormalizerStandardize

torch.set_num_threads(2)

TOL = 1e-5


def _tone(freq, rate=8000, dur=0.25, amp=0.5):
    t = np.arange(int(rate * dur)) / rate
    return (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * max(float(np.abs(want).max()), 1.0))


class TestWavIO:
    def test_roundtrip_16bit(self, tmp_path):
        x = _tone(440)
        T.write_wav(str(tmp_path / "t.wav"), x, 8000)
        J.write_wav(str(tmp_path / "j.wav"), x, 8000)
        assert (tmp_path / "t.wav").read_bytes() == \
            (tmp_path / "j.wav").read_bytes()
        y, rate = T.read_wav(str(tmp_path / "j.wav"))
        want, jrate = J.read_wav(str(tmp_path / "j.wav"))
        assert rate == jrate == 8000 and np.array_equal(y, want)
        np.testing.assert_allclose(y, x, atol=1e-3)

    def test_stereo(self, tmp_path):
        x = np.stack([_tone(300), _tone(600)], axis=1)
        T.write_wav(str(tmp_path / "t.wav"), x, 8000)
        J.write_wav(str(tmp_path / "j.wav"), x, 8000)
        assert (tmp_path / "t.wav").read_bytes() == \
            (tmp_path / "j.wav").read_bytes()
        y, _ = T.read_wav(str(tmp_path / "t.wav"))
        assert y.shape == x.shape
        assert np.array_equal(y, J.read_wav(str(tmp_path / "t.wav"))[0])


class TestFeatures:
    def test_spectrogram_peak_tracks_frequency(self):
        rate, n_fft = 8000, 256
        for freq in (500.0, 1500.0):
            s = T.spectrogram(_tone(freq, rate), n_fft, 128)
            _close(s, J.spectrogram(_tone(freq, rate), n_fft, 128))
            peak_bin = int(s.mean(0).argmax())
            assert abs(peak_bin - round(freq * n_fft / rate)) <= 1

    def test_mel_filterbank_partitions_spectrum(self):
        fb = T.mel_filterbank(20, 256, 8000)
        _close(fb, J.mel_filterbank(20, 256, 8000))
        assert fb.shape == (20, 129)
        assert (fb >= 0).all() and fb.max() <= 1.0
        assert (fb.sum(1) > 0).all()
        assert not fb.flags.writeable

    def test_mfcc_shape_and_finite(self):
        m = T.mfcc(_tone(700), 8000, n_mfcc=13)
        _close(m, J.mfcc(_tone(700), 8000, n_mfcc=13))
        assert m.shape[1] == 13 and np.isfinite(m).all()

    def test_mel_distinguishes_tones(self):
        lo = T.mel_spectrogram(_tone(300), 8000)
        hi = T.mel_spectrogram(_tone(3000), 8000)
        _close(lo, J.mel_spectrogram(_tone(300), 8000))
        _close(hi, J.mel_spectrogram(_tone(3000), 8000))
        assert lo.mean(0).argmax() < hi.mean(0).argmax()


def _make_tree(root):
    rng = np.random.RandomState(0)
    for cls, freq in (("low", 400), ("high", 2500)):
        for i in range(6):
            x = _tone(freq + rng.uniform(-50, 50), dur=0.3)
            x += rng.randn(len(x)).astype(np.float32) * 0.02
            J.write_wav(os.path.join(root, cls, f"{i}.wav"), x, 8000)


class TestReaderAndTraining:
    def test_reader_labels_and_shapes(self, tmp_path):
        _make_tree(str(tmp_path))
        for feature in ("mfcc", "mel", "spectrogram", "raw"):
            tr = T.WavFileRecordReader(feature=feature, n_frames=16) \
                .initialize(str(tmp_path))
            jr = J.WavFileRecordReader(feature=feature, n_frames=16) \
                .initialize(str(tmp_path))
            assert tr.labels == jr.labels == ["high", "low"]
            while jr.hasNext():
                (f, lab), (jf, jlab) = tr.next(), jr.next()
                _close(f.value, jf.value)
                assert type(lab).__name__ == "IntWritable"
                assert lab.value == jlab.value
            assert not tr.hasNext()
        assert f.value.shape == (16, 128) and f.value.dtype == np.float32

    def test_conv1d_classifier_trains_from_wavs(self, tmp_path):
        """On-disk WAVs -> MFCC NCW batches (equal to the JAX iterator's,
        standardized alike) -> the Conv1D net of test_audio.py."""
        from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                        NeuralNetConfiguration)
        from deeplearning4j_tpu_torch.nn.layers import (Convolution1D,
                                                        GlobalPoolingLayer,
                                                        OutputLayer)
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        from deeplearning4j_tpu_torch.train import updaters
        _make_tree(str(tmp_path))
        its = {}
        for M, Norm in ((T, NormalizerStandardize), (J, JNorm)):
            it = M.AudioDataSetIterator(M.WavFileRecordReader(
                feature="mfcc", n_frames=16).initialize(str(tmp_path)), 12)
            norm = Norm()
            norm.fit(it.next())
            it.reset()
            it.setPreProcessor(norm)
            its[M] = it
        got, want = list(its[T]), list(its[J])
        assert len(got) == len(want) == 1 and isinstance(got[0], DataSet)
        _close(got[0].features, np.asarray(want[0].features))
        assert np.array_equal(got[0].labels, np.asarray(want[0].labels))
        assert got[0].features.shape == (12, 13, 16)
        conf = (NeuralNetConfiguration.Builder().seed(3)
                .updater(updaters.Adam(3e-3)).list()
                .layer(Convolution1D(kernelSize=3, nOut=8, activation="relu",
                                     convolutionMode="same"))
                .layer(GlobalPoolingLayer("avg"))
                .layer(OutputLayer(nOut=2, lossFunction="mcxent",
                                   activation="softmax"))
                .setInputType(InputType.recurrent(13, 16))
                .build())
        net = MultiLayerNetwork(conf).init(device="cpu")
        first = None
        it = its[T]
        for _ in range(20):
            it.reset()
            net.fit(it)
            if first is None:
                first = net.score()
        assert np.isfinite(net.score())
        assert net.score() < first * 0.7, (first, net.score())


def test_speech_command_clips_at_phase_32s_shape(tmp_path):
    """Phase 32 (c)'s clips at a small count: 16 files in 8 word
    directories, 1 s at 16 kHz; MFCC [13, 124] batches bit-equal to the
    JAX iterator's."""
    fx.write_speech_commands(str(tmp_path), 16, seed=0)
    x, rate = T.read_wav(str(tmp_path / "yes" / "0000.wav"))
    assert rate == fx.CLIP_RATE and x.shape == (fx.CLIP_RATE,)
    batches = {}
    for M in (T, J):
        rr = M.WavFileRecordReader(feature="mfcc", n_frames=124) \
            .initialize(str(tmp_path))
        assert rr.labels == sorted(fx.WORDS)
        batches[M] = list(M.AudioDataSetIterator(rr, 8))
    for g, w in zip(batches[T], batches[J]):
        assert g.features.shape == (8, 13, 124)
        _close(g.features, np.asarray(w.features))
        assert np.array_equal(g.labels, np.asarray(w.labels))


def test_batch_norm_after_conv1d_needs_unknown_timesteps():
    """Both packages size a ``BatchNormalization`` over a recurrent input
    type as size x timesteps (JAX ``InputType.arrayElementsPerExample``)
    and apply it per channel, so after a ``Convolution1D`` it fails when
    the input type names its timesteps and works when it does not (phase
    32 (c) leaves them out). Pinned on both sides."""
    from deeplearning4j_tpu.nn import config as jconfig
    from deeplearning4j_tpu.nn import layers as jlayers
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    from deeplearning4j_tpu.train import updaters as jupd
    from deeplearning4j_tpu_torch.nn import config as tconfig
    from deeplearning4j_tpu_torch.nn import layers as tlayers
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.train import updaters as tupd
    x = np.random.RandomState(0).randn(4, 5, 12).astype(np.float32)

    def net(C, M, upd, Net, steps, **init):
        it = C.InputType.recurrent(5, steps) if steps else \
            C.InputType.recurrent(5)
        conf = (C.NeuralNetConfiguration.Builder().seed(1)
                .updater(upd.Adam(1e-3)).list()
                .layer(M.Convolution1D(kernelSize=3, nOut=8,
                                       activation="relu",
                                       convolutionMode="same"))
                .layer(M.BatchNormalization())
                .layer(M.GlobalPoolingLayer("avg"))
                .layer(M.OutputLayer(nOut=3, activation="softmax",
                                     lossFunction="mcxent"))
                .setInputType(it).build())
        return Net(conf).init(**init)
    sides = ((jconfig, jlayers, jupd, JMLN, {}),
             (tconfig, tlayers, tupd, MultiLayerNetwork, {"device": "cpu"}))
    for C, M, upd, Net, init in sides:
        sized = net(C, M, upd, Net, 12, **init)
        assert tuple(sized._params[1]["gamma"].shape) == (96,)
        with pytest.raises((TypeError, RuntimeError)):
            sized.output(x)
    j = net(*sides[0][:4], None)
    t = MultiLayerNetwork(net(*sides[1][:4], None, device="cpu").conf)
    t.params_from_jax(j._params, j._states, device="cpu")
    assert tuple(t._params[1]["gamma"].shape) == (8,)
    np.testing.assert_allclose(t.output(x).numpy(), np.asarray(j.output(x)),
                               rtol=TOL, atol=TOL)

