"""DataVec audio: WAV read and write, spectrogram, mel and MFCC features,
``WavFileRecordReader`` and ``AudioDataSetIterator`` —
``deeplearning4j_tpu/data/audio.py`` whole.

Reference parity: ``datavec-data-audio`` (``WavFileRecordReader``,
``AudioRecordReader`` with windowed FFT features). Decode and feature
extraction are host numpy, as in the JAX package and the image pipeline:
a per-file loop of small device ops would cost more in launches than the
features are worth. The iterator's batches are the port's ``DataSet``
([N, coefficients, frames], ready for Conv1D and recurrent layers); a
network's ``fit`` moves them to the card.
"""

from __future__ import annotations

import functools
import os
import wave
from typing import List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.data.dataset import DataSet, DataSetIterator
from deeplearning4j_tpu_torch.data.image import (NDArrayWritable,
                                                 ParentPathLabelGenerator,
                                                 _list_files)
from deeplearning4j_tpu_torch.data.records import IntWritable, RecordReader


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """WAV file -> (float32 samples in [-1, 1] shaped [T] or [T, C], rate).
    Supports 8/16/32-bit PCM (ref: WavFileLoader)."""
    with wave.open(path, "rb") as w:
        rate = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if ch > 1:
        x = x.reshape(-1, ch)
    return x, rate


def write_wav(path: str, samples: np.ndarray, rate: int):
    """float [-1, 1] -> 16-bit PCM WAV (test fixture / export helper)."""
    s = np.clip(np.asarray(samples), -1.0, 1.0)
    pcm = (s * 32767.0).astype(np.int16)
    ch = 1 if pcm.ndim == 1 else pcm.shape[1]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with wave.open(path, "wb") as w:
        w.setnchannels(ch)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


# ----------------------------------------------------------------- features

def frame_signal(x, frame_length: int, hop: int):
    """[T] -> [n_frames, frame_length] (drops the tail remainder)."""
    x = np.asarray(x)
    n = 1 + (x.shape[0] - frame_length) // hop if x.shape[0] >= frame_length \
        else 0
    idx = (np.arange(n)[:, None] * hop + np.arange(frame_length)[None, :])
    return x[idx]


def spectrogram(x, frame_length: int = 256, hop: int = 128,
                window: str = "hann"):
    """Magnitude STFT [n_frames, frame_length//2 + 1]; multi-channel
    input is downmixed to mono first."""
    x = np.asarray(x)
    if x.ndim > 1:
        x = x.mean(axis=1)
    frames = frame_signal(x, frame_length, hop)
    if window == "hann":
        w = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(frame_length)
                               / frame_length)
        frames = frames * w
    return np.abs(np.fft.rfft(frames, axis=-1))


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


@functools.lru_cache(maxsize=16)
def mel_filterbank(n_mels: int, n_fft: int, rate: int,
                   fmin: float = 0.0, fmax: Optional[float] = None):
    """[n_mels, n_fft//2 + 1] triangular filters (HTK-style mel scale).

    Triangles are evaluated on CONTINUOUS bin-center frequencies (not
    floored bin indices), so no filter degenerates to all-zero even when
    adjacent mel points fall inside one FFT bin (e.g. n_mels=40,
    n_fft=256 at 16 kHz). Cached per configuration; returned read-only.
    """
    fmax = fmax if fmax is not None else rate / 2.0
    n_bins = n_fft // 2 + 1
    hz_pts = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                    n_mels + 2))
    bin_freqs = np.arange(n_bins)[None, :] * (rate / n_fft)
    lo = hz_pts[:-2, None]
    c = hz_pts[1:-1, None]
    hi = hz_pts[2:, None]
    up = (bin_freqs - lo) / np.maximum(c - lo, 1e-6)
    down = (hi - bin_freqs) / np.maximum(hi - c, 1e-6)
    fb = np.clip(np.minimum(up, down), 0.0, 1.0)
    # guarantee support: the peak bin of a narrow filter gets weight 1
    peak = np.clip(np.round(c[:, 0] * n_fft / rate).astype(np.int64),
                   0, n_bins - 1)
    fb[np.arange(n_mels), peak] = np.maximum(fb[np.arange(n_mels), peak],
                                             1.0)
    fb.setflags(write=False)
    return fb


def mel_spectrogram(x, rate: int, n_mels: int = 40, frame_length: int = 256,
                    hop: int = 128):
    s = spectrogram(x, frame_length, hop)
    fb = mel_filterbank(n_mels, frame_length, rate)
    return (s ** 2) @ fb.T


@functools.lru_cache(maxsize=16)
def _dct_ii(n_out: int, n_in: int):
    k = np.arange(n_out)[:, None]
    i = np.arange(n_in)[None, :]
    m = np.cos(np.pi * k * (2 * i + 1) / (2 * n_in)) * np.sqrt(2.0 / n_in)
    m.setflags(write=False)   # cached: callers must not mutate
    return m


def mfcc(x, rate: int, n_mfcc: int = 13, n_mels: int = 40,
         frame_length: int = 256, hop: int = 128):
    """[n_frames, n_mfcc] mel-frequency cepstral coefficients."""
    m = mel_spectrogram(x, rate, n_mels, frame_length, hop)
    logm = np.log(np.maximum(m, 1e-10))
    return logm @ _dct_ii(n_mfcc, n_mels).T


# ------------------------------------------------------------------ readers

class WavFileRecordReader(RecordReader):
    """Directory-of-class-directories WAV reader (ref: datavec-data-audio
    WavFileRecordReader + ParentPathLabelGenerator labels); records are
    [feature ndarray, IntWritable(label)]."""

    def __init__(self, feature: str = "mfcc", n_frames: int = 32,
                 frame_length: int = 256, hop: int = 128, n_mfcc: int = 13,
                 n_mels: int = 40):
        self.feature = feature
        self.n_frames = n_frames
        self.frame_length = frame_length
        self.hop = hop
        self.n_mfcc = n_mfcc
        self.n_mels = n_mels
        self._files: List[str] = []
        self.labels: List[str] = []
        self._pos = 0

    def initialize(self, path: str):
        out = _list_files(path, (".wav",))
        if not out:
            raise FileNotFoundError(f"no .wav files under {path}")
        self._files = out
        self._label_gen = ParentPathLabelGenerator()
        self.labels = sorted({self._label_gen.getLabelForPath(f)
                              for f in self._files})
        self._pos = 0
        return self

    def numLabels(self) -> int:
        return len(self.labels)

    def hasNext(self):
        return self._pos < len(self._files)

    def reset(self):
        self._pos = 0

    def _features(self, x: np.ndarray, rate: int) -> np.ndarray:
        if x.ndim > 1:
            x = x.mean(axis=1)                # downmix to mono
        if self.feature == "mfcc":
            f = np.asarray(mfcc(x, rate, self.n_mfcc, self.n_mels,
                                self.frame_length, self.hop))
        elif self.feature == "mel":
            f = np.asarray(mel_spectrogram(x, rate, self.n_mels,
                                           self.frame_length, self.hop))
        elif self.feature == "spectrogram":
            f = np.asarray(spectrogram(x, self.frame_length, self.hop))
        elif self.feature == "raw":
            need = self.n_frames * self.hop
            buf = np.zeros(need, np.float32)   # zero-pad/truncate like the
            n = min(len(x), need)              # other feature branches
            buf[:n] = x[:n]
            f = buf.reshape(self.n_frames, self.hop)
        else:
            raise ValueError(self.feature)
        # fix the time dimension (pad with zeros / truncate)
        if f.shape[0] < self.n_frames:
            f = np.pad(f, ((0, self.n_frames - f.shape[0]), (0, 0)))
        return f[:self.n_frames].astype(np.float32)

    def next(self):
        path = self._files[self._pos]
        self._pos += 1
        x, rate = read_wav(path)
        label = self.labels.index(self._label_gen.getLabelForPath(path))
        return [NDArrayWritable(self._features(x, rate)), IntWritable(label)]


class AudioDataSetIterator(DataSetIterator):
    """WavFileRecordReader -> DataSet batches: features [N, C(=coeffs), T]
    (NCW, ready for Conv1D/RNN layers)."""

    def __init__(self, reader: WavFileRecordReader, batch_size: int):
        self.reader = reader
        self.batch_size = batch_size

    def reset(self):
        self.reader.reset()

    def hasNext(self):
        return self.reader.hasNext()

    def next(self) -> DataSet:
        feats, labels = [], []
        while self.reader.hasNext() and len(feats) < self.batch_size:
            f, l = self.reader.next()
            feats.append(f.value.T)           # [T, C] -> [C, T]
            labels.append(l.value)
        x = np.stack(feats).astype(np.float32)
        y = np.eye(self.reader.numLabels(), dtype=np.float32)[
            np.asarray(labels, np.int64)]
        return self._apply_pre(DataSet(x, y))

    def batch(self):
        return self.batch_size
