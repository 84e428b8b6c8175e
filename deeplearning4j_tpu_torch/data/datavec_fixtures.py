"""Seeded DataVec datasets in the shapes of three public ones, written to
a directory at run time (no file is downloaded or kept in the repo), and
the transaction pipeline that runs over the first.

- :func:`write_transactions`: the transaction table of dl4j-examples'
  ``BasicDataVecExample`` — DateTimeString, CustomerID, MerchantID,
  NumItemsInTransaction, MerchantCountryCode (USA, CAN, FR, MX),
  TransactionAmountUSD and FraudLabel (0/1) — one CSV without a header.
  The fraud label depends on the amount, the hour and the country, so a
  net can learn it.
- :func:`transaction_process`: the example's ``TransactionProcess`` over
  that schema: remove the IDs, keep the USA and CAN rows, country to
  one-hot, the date string to a time, its hour of day derived, the time
  dropped, the amount standardized.
- :func:`write_control_charts`: the UCI synthetic control chart set in
  its published shape (600 sequences of 60 steps, 100 of each of 6
  classes: normal, cyclic, increasing and decreasing trend, upward and
  downward shift) from the pattern formulas of Alcock & Manolopoulos
  (1999), one CSV a sequence with rows ``value,label`` (dl4j-examples'
  ``UCISequenceClassification`` input).
- :func:`write_speech_commands`: clips in Speech Commands' format (1 s,
  16 kHz, 16-bit mono WAV) in one directory per word: each word a seeded
  mixture of a few tones over noise.

Each writer takes a ``numpy.random.RandomState`` seed; the same seed
writes the same bytes.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

#: the example's MerchantCountryCode states
COUNTRIES = ("USA", "CAN", "FR", "MX")
#: eight of Speech Commands' core words: one class each
WORDS = ("yes", "no", "up", "down", "left", "right", "on", "off")
#: the control chart classes, in the UCI file's order
CHART_CLASSES = ("normal", "cyclic", "increasing", "decreasing", "upward",
                 "downward")
#: the UCI set: 100 sequences of each class, 60 steps each
CHART_PER_CLASS = 100
CHART_LENGTH = 60
#: Speech Commands' clip: one second at 16 kHz
CLIP_RATE = 16000


def write_transactions(path: str, n: int, seed: int = 0) -> None:
    """``n`` rows of the transaction table as one CSV at ``path``."""
    rng = np.random.RandomState(seed)
    seconds = rng.randint(0, 30 * 86400, n)
    stamps = np.datetime64("2026-01-01T00:00:00") + seconds.astype(
        "timedelta64[s]")
    when = np.char.replace(np.datetime_as_string(stamps, unit="s"), "T", " ")
    customer = rng.randint(0, 100000, n)
    merchant = rng.randint(0, 5000, n)
    items = rng.randint(1, 12, n)
    country = rng.choice(len(COUNTRIES), n, p=(0.6, 0.2, 0.1, 0.1))
    amount = np.round(np.exp(rng.normal(3.5, 1.1, n)), 2)
    hour = (seconds // 3600) % 24
    logit = -3.0 + 1.6 * (amount > 150) + 1.4 * (hour < 5) \
        + 0.8 * (country == 1) + 0.1 * items
    fraud = (rng.random_sample(n) < 1.0 / (1.0 + np.exp(-logit))).astype(
        np.int64)
    names = np.asarray(COUNTRIES)[country]
    lines = [f"{w},C{c:06d},M{m:05d},{k},{cc},{a:.2f},{f}"
             for w, c, m, k, cc, a, f in zip(
                 when.tolist(), customer.tolist(), merchant.tolist(),
                 items.tolist(), names.tolist(), amount.tolist(),
                 fraud.tolist())]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def transaction_schema(records):
    """The input schema, built with ``records`` (a DataVec records
    module)."""
    return (records.Schema.Builder()
            .addColumnString("DateTimeString")
            .addColumnString("CustomerID")
            .addColumnString("MerchantID")
            .addColumnInteger("NumItemsInTransaction")
            .addColumnCategorical("MerchantCountryCode", *COUNTRIES)
            .addColumnDouble("TransactionAmountUSD")
            .addColumnInteger("FraudLabel")
            .build())


def _foreign(row) -> bool:
    return row["MerchantCountryCode"] not in ("USA", "CAN")


def transaction_process(records):
    """The six-step ``TransformProcess`` over :func:`transaction_schema`,
    built with ``records``."""
    return (records.TransformProcess.Builder(transaction_schema(records))
            .removeColumns("CustomerID", "MerchantID")
            .filter(_foreign)
            .categoricalToOneHot("MerchantCountryCode")
            .stringToTimeTransform("DateTimeString", "%Y-%m-%d %H:%M:%S")
            .renameColumn("DateTimeString", "DateTime")
            .deriveColumnsFromTime("DateTime", "hourOfDay")
            .removeColumns("DateTime")
            .normalize("TransactionAmountUSD", "Standardize")
            .build())


def control_chart(rng: np.random.RandomState, cls: int,
                  n: int = CHART_LENGTH) -> np.ndarray:
    """One sequence of class ``cls`` (Alcock & Manolopoulos 1999: mean 30,
    noise 2 * U(-3, 3); cycles of amplitude U(10, 15) and period U(10,
    15); trends of slope U(0.2, 0.5); shifts of U(7.5, 20) from a step in
    U(n/3, 2n/3))."""
    t = np.arange(n, dtype=np.float64)
    y = 30.0 + 2.0 * rng.uniform(-3.0, 3.0, n)
    if cls == 1:
        y += rng.uniform(10, 15) * np.sin(2 * np.pi * t / rng.uniform(10, 15))
    elif cls in (2, 3):
        y += (1 if cls == 2 else -1) * rng.uniform(0.2, 0.5) * t
    elif cls in (4, 5):
        step = rng.uniform(n / 3, 2 * n / 3)
        y += (1 if cls == 4 else -1) * rng.uniform(7.5, 20) * (t >= step)
    return y


def write_control_charts(root: str, seed: int = 0,
                         per_class: int = CHART_PER_CLASS) -> List[str]:
    """``6 * per_class`` sequences as ``root/NNN.csv`` (rows
    ``value,label``) in a seeded shuffled order; returns the paths in
    that order."""
    rng = np.random.RandomState(seed)
    classes = np.repeat(np.arange(len(CHART_CLASSES)), per_class)
    seqs = [control_chart(rng, int(c)) for c in classes]
    os.makedirs(root, exist_ok=True)
    paths = []
    for i, j in enumerate(rng.permutation(len(seqs))):
        p = os.path.join(root, f"{i:04d}.csv")
        with open(p, "w") as fh:
            fh.write("".join(f"{v:.4f},{classes[j]}\n" for v in seqs[j]))
        paths.append(p)
    return paths


def write_speech_commands(root: str, n: int, seed: int = 0) -> None:
    """``n`` one-second clips, ``n // 8`` a word, as
    ``root/<word>/NNNN.wav``; word ``k`` sounds three partials around
    ``220 * 1.35**k`` Hz, each clip shifted by up to 3% and set in noise
    of a random level."""
    from deeplearning4j_tpu_torch.data.audio import write_wav
    rng = np.random.RandomState(seed)
    rate = CLIP_RATE
    t = np.arange(rate) / rate
    for i in range(n):
        k = i % len(WORDS)
        base = 220.0 * 1.35 ** k * (1 + rng.uniform(-0.03, 0.03))
        x = sum(a * np.sin(2 * np.pi * base * h * t + rng.uniform(0, 6.3))
                for h, a in ((1, 0.4), (2, 0.2), (3, 0.1)))
        x = x * np.minimum(1.0, 8 * np.minimum(t, 1 - t))
        x = x + rng.normal(0, rng.uniform(0.01, 0.1), rate)
        write_wav(os.path.join(root, WORDS[k], f"{i:04d}.wav"),
                  x.astype(np.float32), rate)
