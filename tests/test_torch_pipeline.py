"""The port's staged image pipeline (``data/pipeline.py``) against the JAX
package's (CPU): ``MultiWorkerImageIterator`` / ``StagedImageIterator``
with 2 ``spawn`` workers at 16x16 give the JAX iterator's batches to the
bit (same seed, same shuffle order, K=2 megabatches through
``dispatch_stream`` and per-batch ``next()``, the host-decoded tail,
interleave); ``cursor``/``seek`` mid-epoch; a killed worker and a corrupt
file raise ``DataPipelineError`` instead of hanging (each wait bounded by
the test's own time limit); the decode worker imports no torch.

The tree holds PNGs and a few JPEGs that the test writes with PIL. Both
packages decode with cv2 where it imports and with PIL otherwise; the
decode test holds each branch to the JAX package's, the PIL one with cv2
hidden.
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from deeplearning4j_tpu.data import pipeline as jpipe
from deeplearning4j_tpu_torch.data import decode as tdecode
from deeplearning4j_tpu_torch.data import pipeline as tpipe
from deeplearning4j_tpu_torch.train.stepping import MegaBatch

#: seconds a pipeline call may take before the test calls it a hang
LIMIT = 60.0


def _tree(root, classes=3, per=7):
    from PIL import Image
    r = np.random.RandomState(11)
    for c in range(classes):
        d = os.path.join(root, f"k{c}")
        os.makedirs(d)
        for i in range(per):
            img = Image.fromarray(r.randint(0, 255, (20, 17, 3),
                                            dtype=np.uint8))
            if i % 3 == 0:
                img.save(os.path.join(d, f"{i}.jpg"), quality=85)
            else:
                img.save(os.path.join(d, f"{i}.png"))
    return str(root)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _tree(tmp_path_factory.mktemp("tree"))


def _bounded(fn):
    """``fn()`` on a thread, failing the test if it outlives LIMIT."""
    out = {}

    def run():
        try:
            out["value"] = fn()
        except BaseException as e:      # handed to the test's thread
            out["error"] = e
    th = threading.Thread(target=run, daemon=True)
    th.start()
    th.join(LIMIT)
    assert not th.is_alive(), "the pipeline hung"
    if "error" in out:
        raise out["error"]
    return out.get("value")


def _items(it, mega=True):
    stream = it.dispatch_stream() if mega else iter(it)
    out = []
    for item in stream:
        out.append((type(item).__name__, np.asarray(item.features).copy(),
                    np.asarray(item.labels).copy()))
    return out


def _same(a, b):
    assert [x[0] for x in a] == [x[0] for x in b]
    for (_, fa, la), (_, fb, lb) in zip(a, b):
        assert fa.dtype == fb.dtype == np.uint8
        assert np.array_equal(fa, fb) and np.array_equal(la, lb)


KW = dict(batch_size=4, workers=2, shuffle=True, seed=7,
          steps_per_dispatch=2)


@pytest.fixture(scope="module")
def jax_epochs(tree):
    """Two epochs of the JAX iterator: megabatches, then per batch."""
    it = jpipe.MultiWorkerImageIterator(tree, 16, 16, drop_last=False, **KW)
    try:
        return _bounded(lambda: (_items(it), _items(it, mega=False),
                                 it.labels))
    finally:
        it.close()


def test_batches_equal_the_jax_iterator(tree, jax_epochs):
    it = tpipe.MultiWorkerImageIterator(tree, 16, 16, drop_last=False, **KW)
    try:
        mega, per_batch = _bounded(lambda: (_items(it), _items(it, False)))
        assert it.labels == jax_epochs[2]
    finally:
        it.close()
    _same(mega, jax_epochs[0])
    _same(per_batch, jax_epochs[1])
    # 21 files, B=4: 5 full batches -> 2 megabatches of 2, one single
    # batch, and the host-decoded tail of 1
    assert [x[0] for x in mega] == ["MegaBatch", "MegaBatch", "DataSet",
                                    "DataSet"]
    assert mega[0][1].shape == (2, 4, 3, 16, 16)
    assert mega[-1][1].shape == (1, 3, 16, 16)
    assert len(per_batch) == 6


def test_interleave_and_the_builder_equal_the_jax_pipeline(tree):
    def build(mod):
        return (mod.ImagePipeline.list(tree).shuffle(seed=3).interleave(2)
                .decode(16, 16, workers=2).batch(3).stage(2).prefetch(2)
                .build())
    ours = build(tpipe)
    theirs = build(jpipe)
    try:
        assert [repr(s) for s in (tpipe.ImagePipeline.list(tree)
                                  .decode(16, 16).batch(3).describe())] == \
            [repr(s) for s in (jpipe.ImagePipeline.list(tree)
                               .decode(16, 16).batch(3).describe())]
        a, b = _bounded(lambda: (_items(ours), _items(theirs)))
    finally:
        ours.close()
        theirs.close()
    _same(a, b)


def test_cursor_and_seek_mid_epoch(tree, jax_epochs):
    it = tpipe.MultiWorkerImageIterator(tree, 16, 16, drop_last=False, **KW)
    try:
        def run():
            # a fresh iterator is at epoch 1, as the fixture's first pass
            head = [it.next() for _ in range(3)]
            cur = it.cursor()
            it.seek({"batch": 0, "epoch": 0})   # elsewhere in between
            it.next()
            it.seek(cur)
            rest = []
            while it.hasNext():
                rest.append(it.next())
            return cur, head, rest
        cur, head, rest = _bounded(run)
    finally:
        it.close()
    assert cur == {"batch": 3, "epoch": 1}
    want = jax_epochs[0]
    flat = [(f[i], l[i]) for name, f, l in want if name == "MegaBatch"
            for i in range(len(f))] + \
        [(f, l) for name, f, l in want if name == "DataSet"]
    got = [(np.asarray(d.features), np.asarray(d.labels))
           for d in head + rest]
    assert len(got) == len(flat) == 6
    for (fa, la), (fb, lb) in zip(got, flat):
        assert np.array_equal(fa, fb) and np.array_equal(la, lb)


def test_a_killed_worker_raises_instead_of_hanging(tree):
    it = tpipe.MultiWorkerImageIterator(tree, 16, 16, batch_size=4,
                                        workers=2, liveness_poll=0.1)
    try:
        for p in it._procs:              # before either could decode
            p.kill()
            p.join(LIMIT)

        def drain():
            while it.hasNext():
                it.next()
        with pytest.raises(tpipe.DataPipelineError, match="worker died"):
            _bounded(drain)
        assert not tpipe.DataPipelineError("x").transient
        it.reset()                       # rebuilds the pool
        assert len(_bounded(lambda: _items(it, mega=False))) == 5
    finally:
        it.close()


def test_a_corrupt_file_raises_until_reset(tmp_path):
    root = _tree(tmp_path, classes=2, per=4)
    bad = os.path.join(root, "k0", "2.png")
    with open(bad, "wb") as f:
        f.write(b"not an image")
    it = tpipe.MultiWorkerImageIterator(root, 16, 16, batch_size=2,
                                        workers=2)
    try:
        with pytest.raises(tpipe.DataPipelineError, match="decode failed"):
            _bounded(lambda: [it.next() for _ in range(4)])
        with pytest.raises(tpipe.DataPipelineError):    # latched
            _bounded(it.next)
    finally:
        it.close()


@pytest.mark.parametrize("codec", ["cv2", "PIL"])
def test_decode_one_equals_jax_and_imports_no_torch(tree, codec,
                                                    monkeypatch):
    """Both branches of the decode against the JAX package's: cv2 where it
    imports, PIL with cv2 hidden (a None entry in ``sys.modules`` makes
    its import fail in both packages)."""
    if codec == "PIL":
        monkeypatch.setitem(sys.modules, "cv2", None)
    else:
        pytest.importorskip("cv2")
    assert tdecode.codec() == codec
    files = sorted(os.path.join(d, f) for d, _, fs in os.walk(tree)
                   for f in fs)
    for f in files[:6]:
        for hw, c in (((16, 16), 3), ((9, 13), 1), ((20, 17), 3)):
            want = jpipe._decode_one(f, *hw, c)
            got = tdecode.decode_one(f, *hw, c)
            assert got.dtype == np.uint8 and np.array_equal(got, want)
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys, deeplearning4j_tpu_torch.data.decode; "
         "print(sorted(m for m in ('torch', 'jax') if m in sys.modules))"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_dispatch_stream_hands_over_whole_megabatches(tree):
    it = tpipe.MultiWorkerImageIterator(tree, 16, 16, batch_size=4,
                                        workers=2, steps_per_dispatch=2)
    try:
        items = _bounded(lambda: list(it.dispatch_stream()))
    finally:
        it.close()
    assert [type(i) for i in items] == [MegaBatch, MegaBatch,
                                        type(items[2])]
    assert items[0].features.flags["C_CONTIGUOUS"]
    assert items[0].labels.shape == (2, 4, 3)
    assert not items[0].multi and it.megabatch_steps == 2
