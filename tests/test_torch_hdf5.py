"""The port's HDF5 reader (``modelimport/hdf5.py``) and writer
(``modelimport/keras_fixtures.py``) against h5py, on the CPU.

Files written by h5py (every structure the reader reads: variable-length
and fixed-length strings, scalars and arrays of them, f16/f32/f64 and
integer data of both byte orders, a compact dataset, nested paths with
``:0`` names, enough attributes for continuation blocks and enough links
for several symbol nodes), by Keras (a Sequential save, a Bidirectional
and a MultiHeadAttention save, the BERT-shaped encoder built in Keras),
and by the port's own writer: every attribute and dataset read by the
reader equals h5py's read bit for bit, and the tree of names is h5py's.
What the reader does not read raises ``Hdf5FormatError``: chunked and
compressed datasets, a superblock past version 1, a file that is not
HDF5. The Keras view (``Hdf5Archive``) equals the JAX package's h5py one
(config, version, every layer's weights by basename). Files the writer
makes open in h5py and in ``keras.models.load_model``, whose ``predict``
equals the port's import.
"""

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from deeplearning4j_tpu_torch.modelimport import hdf5  # noqa: E402
from deeplearning4j_tpu_torch.modelimport import keras_fixtures as kf  # noqa: E402,E501


def _same(a, b) -> bool:
    """h5py's value and the reader's: equal type family, shape, dtype and
    bytes (object arrays element by element)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype == object or b.dtype == object:
            return a.shape == b.shape and a.dtype == b.dtype and all(
                type(x) is type(y) and x == y
                for x, y in zip(a.ravel(), b.ravel()))
        return a.shape == b.shape and a.dtype == b.dtype and \
            a.tobytes() == b.tobytes()
    if isinstance(a, np.generic):
        return isinstance(b, np.generic) and a.dtype == b.dtype and \
            a.tobytes() == b.tobytes()
    return type(a) is type(b) and a == b


def _compare(path) -> int:
    """Every attribute and dataset of ``path`` through h5py and the
    reader; returns the count of values compared."""
    n = 0
    with h5py.File(path, "r") as f:
        ours = hdf5.Hdf5File(path)
        names, our_names = [], []
        f.visititems(lambda k, o: names.append(k))
        ours.visititems(lambda k, o: our_names.append(k))
        assert sorted(our_names) == sorted(names)
        for name in ["/"] + names:
            h, o = f[name], ours[name]
            assert isinstance(o, hdf5.Dataset) == isinstance(h, h5py.Dataset)
            assert sorted(o.attrs) == sorted(h.attrs), name
            for k in h.attrs:
                assert _same(h.attrs[k], o.attrs[k]), (name, k)
                n += 1
            if isinstance(h, h5py.Dataset):
                assert o.shape == h.shape and o.dtype == h.dtype, name
                assert _same(h[()], o.read()), name
                n += 1
        ours.close()
    return n


def _rich_h5py(path):
    rng = np.random.default_rng(0)
    with h5py.File(path, "w") as f:
        f.attrs["vstr"] = "héllo " * 2000          # 12 kB in the heap
        f.attrs["vstrs"] = np.array(["a", "bcd", "", "x" * 300],
                                    dtype=h5py.string_dtype())
        f.attrs["fstr"] = np.bytes_(b"fixed")
        f.attrs["fstrs"] = np.array([b"k1", b"kernel:0", b"a/b/c"],
                                    dtype="S8")
        f.attrs["f64"] = np.float64(3.25)
        f.attrs["i32s"] = np.arange(5, dtype=np.int32)
        f.attrs["empty"] = np.zeros((0,), np.float64)
        for i in range(40):                     # continuation blocks
            f.attrs[f"many{i}"] = np.full((i + 1,), i, np.int64)
        g = f.create_group("a/b:0/c")
        g.attrs["u16"] = np.uint16(7)
        g.create_dataset("f16", data=rng.standard_normal((3, 5)).astype(
            np.float16))
        g.create_dataset("f64", data=rng.standard_normal((7,)))
        g.create_dataset("big_endian", data=np.arange(6, dtype=">i4")
                         .reshape(2, 3))
        g.create_dataset("u8", data=np.arange(10, dtype=np.uint8))
        g.create_dataset("i64", data=np.arange(-3, 3, dtype=np.int64))
        g.create_dataset("scalar", data=np.float32(1.5))
        g.create_dataset("strs", data=np.array([b"ab", b"cdef"], dtype="S4"))
        g.create_dataset("vstrs", data=np.array(
            ["q", "rs"], dtype=h5py.string_dtype()))
        g.create_dataset("empty", data=np.zeros((0, 4), np.float32))
        for i in range(30):                     # several symbol nodes
            f.create_dataset(f"w/layer_{i:02d}/kernel:0",
                             data=rng.standard_normal((4, i + 1)).astype(
                                 np.float32))
        dcpl = h5py.h5p.create(h5py.h5p.DATASET_CREATE)
        dcpl.set_layout(h5py.h5d.COMPACT)
        arr = np.arange(12, dtype=np.float32).reshape(3, 4)
        did = h5py.h5d.create(f.id, b"compact", h5py.h5t.IEEE_F32LE,
                              h5py.h5s.create_simple(arr.shape), dcpl=dcpl)
        did.write(h5py.h5s.ALL, h5py.h5s.ALL, arr)


def test_h5py_file_reads_bit_equal(tmp_path):
    path = tmp_path / "rich.h5"
    _rich_h5py(path)
    assert _compare(path) >= 80
    f = hdf5.Hdf5File(path)
    assert f["a/b:0/c/f16"].dtype == np.float16
    assert f["compact"].read().tolist() == np.arange(12).reshape(3, 4)\
        .tolist()
    assert "a/b:0" in f and "a/b:1" not in f
    assert isinstance(f.attrs["vstr"], str) and \
        f.attrs["fstrs"].dtype == np.dtype("S8")
    # the continuation blocks and the symbol nodes were exercised
    assert sum(1 for m in f._msgs if m[0] == 0x10) >= 1
    assert len(f["w"].keys()) == 30


@pytest.mark.parametrize("what", ["chunked", "gzip"])
def test_unread_dataset_layouts_raise(tmp_path, what):
    path = tmp_path / "c.h5"
    with h5py.File(path, "w") as f:
        kw = {"chunks": (4, 4)} if what == "chunked" else \
            {"compression": "gzip"}
        f.create_dataset("x", data=np.ones((8, 8), np.float32), **kw)
        f.create_dataset("ok", data=np.ones((2,), np.float32))
    r = hdf5.Hdf5File(path)
    assert r["ok"].read().tolist() == [1.0, 1.0]
    with pytest.raises(hdf5.Hdf5FormatError,
                       match="chunked" if what == "chunked" else "filtered"):
        r["x"].read()


def test_newer_format_bounds_and_non_hdf5_raise(tmp_path):
    path = tmp_path / "latest.h5"
    with h5py.File(path, "w", libver="latest") as f:
        f.create_dataset("x", data=np.ones(3, np.float32))
    with pytest.raises(hdf5.Hdf5FormatError, match="superblock version"):
        hdf5.Hdf5File(path)
    bad = tmp_path / "bad.h5"
    bad.write_bytes(b"not an hdf5 file" * 600)
    with pytest.raises(hdf5.Hdf5FormatError, match="signature"):
        hdf5.Hdf5File(bad)


# -------------------------------------------------------------- Keras files
keras = pytest.importorskip("keras")
from keras import layers as KL  # noqa: E402


def _keras_models():
    inp = keras.Input((6, 8))
    y = KL.MultiHeadAttention(num_heads=2, key_dim=4, name="mha")(inp, inp)
    y = KL.Bidirectional(KL.LSTM(3, return_sequences=True), name="bi")(y)
    y = KL.LayerNormalization(name="ln")(y)
    mha_bi = keras.Model(inp, KL.GlobalAveragePooling1D()(y))
    seq = keras.Sequential([keras.Input((8, 8, 3)),
                            KL.Conv2D(4, 3, name="c"),
                            KL.BatchNormalization(name="bn"),
                            KL.Flatten(), KL.Dense(3, name="d")])
    return {"mha_bidirectional": mha_bi, "sequential_cnn": seq}


@pytest.fixture(scope="module")
def keras_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("keras")
    out = {}
    for name, model in _keras_models().items():
        out[name] = str(d / f"{name}.h5")
        model.save(out[name])
    out["fixture_encoder"] = str(d / "fixture_encoder.h5")
    kf.encoder_h5(out["fixture_encoder"], 0, V=50, P=16, E=32, H=2, L=2,
                  F=64)
    return out


@pytest.mark.parametrize("name", ["mha_bidirectional", "sequential_cnn",
                                  "fixture_encoder"])
def test_keras_file_reads_bit_equal(keras_files, name):
    assert _compare(keras_files[name]) > 5


@pytest.mark.parametrize("name", ["mha_bidirectional", "sequential_cnn",
                                  "fixture_encoder"])
def test_archive_matches_the_jax_one(keras_files, name):
    from deeplearning4j_tpu.modelimport.keras import Hdf5Archive as JArchive
    path = keras_files[name]
    j, t = JArchive(path), hdf5.Hdf5Archive(path)
    try:
        assert t.model_config() == j.model_config()
        assert t.keras_version() == j.keras_version()
        layers = [e["config"]["name"] for e in
                  j.model_config()["config"]["layers"]]
        assert layers
        for layer in layers + ["no_such_layer"]:
            jw, tw = j.layer_weights(layer), t.layer_weights(layer)
            assert sorted(tw) == sorted(jw), layer
            for k in jw:
                assert _same(jw[k], tw[k]), (layer, k)
    finally:
        j.close()
        t.close()


def test_archive_names_wrapper_weights(keras_files):
    t = hdf5.Hdf5Archive(keras_files["mha_bidirectional"])
    assert {k.split("/")[0] for k in t.layer_weights("bi")} == {"fwd",
                                                                "bwd"}
    assert "attention_output/kernel" in t.layer_weights("mha")


def test_writer_output_loads_in_keras_as_the_port_imports(keras_files):
    import torch

    from deeplearning4j_tpu_torch.modelimport.keras import \
        importKerasModelAndWeights
    path = keras_files["fixture_encoder"]
    model = keras.models.load_model(path)
    net = importKerasModelAndWeights(path, device="cpu")
    rng = np.random.default_rng(2)
    tok = rng.integers(0, 50, (4, 16)).astype(np.int32)
    pos = np.tile(np.arange(16, dtype=np.int32), (4, 1))
    with torch.no_grad():
        got = net.output([tok, pos]).numpy()
    np.testing.assert_allclose(got, model.predict([tok, pos], verbose=0),
                               rtol=1e-4, atol=1e-5)
    assert model.count_params() == net.numParams()


def test_writer_attribute_kinds_round_trip(tmp_path):
    w = kf.H5Writer()
    w.group("g/h")
    w.attr("/", "text", "über " * 5000)
    w.attr("/", "texts", ["a", "", "kernel:0"])
    w.attr("/", "fixed", np.bytes_(b"abc"))
    w.attr("/", "fixed_arr", np.array([b"x", b"yz"], dtype="S2"))
    w.attr("g", "f64", np.float64(2.5))
    w.attr("g", "ints", np.arange(4, dtype=np.int16))
    w.attr("g/h", "empty", np.zeros((0,), np.float64))
    rng = np.random.default_rng(0)
    for i in range(2 * kf.LEAF_K * 3 + 1):     # several symbol nodes
        w.dataset(f"many/d{i:03d}", rng.standard_normal((2, 3)).astype(
            np.float32))
    w.dataset("g/h/f16", np.arange(6, dtype=np.float16).reshape(2, 3))
    w.dataset("g/h/u8", np.arange(5, dtype=np.uint8))
    path = tmp_path / "w.h5"
    w.write(path)
    assert _compare(path) > 100
    with h5py.File(path, "r") as f:
        assert f.attrs["texts"].tolist() == ["a", "", "kernel:0"]
        assert len(f["many"]) == 2 * kf.LEAF_K * 3 + 1
