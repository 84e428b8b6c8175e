"""The model archive between the packages (CPU): an archive written by
either package's ``save`` loads in the other's ``load`` with the same
configuration, params, layer states, updater moments (the ``u::{j}``
leaves in the JAX pytree's flatten order) and counters — all exact, the
arrays cross as they are — and outputs within 1e-5 (the reference's
forward tolerance; the two packages' forwards round differently).
A damaged archive raises ``CorruptModelError`` naming the bad entry."""

import os
import zipfile

import numpy as np
import pytest

import jax
import torch

from deeplearning4j_tpu.data.dataset import DataSet as JDataSet
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.graph import ElementWiseVertex as JEW
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.nn import layers as tlayers
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.graph import ElementWiseVertex as TEW
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.train import serializer as tser
from deeplearning4j_tpu_torch.train import updaters as tupd

torch.set_num_threads(2)

OUT_TOL = 1e-5


def _mln_conf(conf, Lm, it, upd):
    return (conf.Builder().seed(4).updater(upd.Adam(1e-2)).list()
            .layer(Lm.ConvolutionLayer(kernelSize=(3, 3), nOut=4,
                                       activation="identity"))
            .layer(Lm.BatchNormalization())
            .layer(Lm.ActivationLayer("relu"))
            .layer(Lm.SubsamplingLayer(kernelSize=(2, 2), stride=(2, 2)))
            .layer(Lm.DenseLayer(nOut=6, activation="tanh", dropOut=0.8))
            .layer(Lm.OutputLayer(nOut=3, lossFunction="mcxent"))
            .setInputType(it.convolutional(6, 6, 2)).build())


def _graph_conf(conf, Lm, it, upd, EW):
    return (conf.Builder().seed(6).updater(upd.Adam(1e-2)).graphBuilder()
            .addInputs("in").setInputTypes(it.convolutional(5, 5, 2))
            .addLayer("c1", Lm.ConvolutionLayer(kernelSize=(3, 3),
                                                padding=(1, 1), nOut=3,
                                                activation="identity"), "in")
            .addLayer("bn", Lm.BatchNormalization(), "c1")
            .addLayer("r", Lm.ActivationLayer("relu"), "bn")
            .addLayer("c2", Lm.ConvolutionLayer(kernelSize=(1, 1), nOut=3,
                                                activation="identity"), "in")
            .addVertex("add", EW("Add"), "r", "c2")
            .addLayer("pool", Lm.GlobalPoolingLayer("avg"), "add")
            .addLayer("out", Lm.OutputLayer(nOut=2, lossFunction="mcxent"),
                      "pool")
            .setOutputs("out").build())


def _data(shape, n_out, seed=0, n=5):
    r = np.random.default_rng(seed)
    return (r.standard_normal((n,) + shape).astype(np.float32),
            np.eye(n_out, dtype=np.float32)[r.integers(0, n_out, n)])


def _jax_leaves(tree):
    return [np.asarray(v) for v in jax.tree_util.tree_leaves(tree)]


def _assert_same_state(j, t, graph=False):
    """Params, states and updater moments equal, leaf for leaf in the JAX
    flatten order, and the counters."""
    t_params = [t._params[n][k].detach().numpy() for n, k in t._leaf_keys()]
    for a, b in zip(t_params, _jax_leaves(j._params), strict=True):
        np.testing.assert_array_equal(a, b)
    t_states = [v.numpy() for n, s in (sorted(t._states.items()) if graph
                                       else enumerate(t._states))
                for _, v in sorted(s.items())]
    for a, b in zip(t_states, _jax_leaves(j._states), strict=True):
        np.testing.assert_array_equal(a, b)
    t_opt = [t._opt_state[n][k][sk].numpy()
             for n, k, sk in tser.updater_leaves(t)]
    for a, b in zip(t_opt, _jax_leaves(j._opt_state), strict=True):
        np.testing.assert_array_equal(a, b)
    assert t._iteration == j._iteration and t._epoch == j._epoch


class TestMultiLayerArchive:
    def test_jax_archive_loads_in_the_port(self, tmp_path):
        j = JMLN(_mln_conf(JConf, jlayers, JInputType, jupd)).init()
        x, y = _data((2, 6, 6), 3)
        j.fit(JDataSet(x, y), epochs=2)
        path = str(tmp_path / "jax.zip")
        j.save(path)
        t = MultiLayerNetwork.load(path, device="cpu")
        _assert_same_state(j, t)
        np.testing.assert_allclose(t.output(x).numpy(),
                                   np.asarray(j.output(x)), rtol=OUT_TOL,
                                   atol=OUT_TOL)
        assert t.layers[4].dropout == 0.8
        assert sorted(t.conf.preprocessors) == [4]

    def test_port_archive_loads_in_jax(self, tmp_path):
        t = MultiLayerNetwork(_mln_conf(NeuralNetConfiguration, tlayers,
                                        InputType, tupd)).init(device="cpu")
        x, y = _data((2, 6, 6), 3, seed=1)
        t.fit(DataSet(x, y), epochs=3)
        path = str(tmp_path / "port.zip")
        t.save(path)
        j = JMLN.load(path)
        _assert_same_state(j, t)
        np.testing.assert_allclose(np.asarray(j.output(x)),
                                   t.output(x).numpy(), rtol=OUT_TOL,
                                   atol=OUT_TOL)
        # and back: the JAX package writes the same arrays
        j.save(str(tmp_path / "again.zip"))
        t2 = MultiLayerNetwork.load(str(tmp_path / "again.zip"),
                                    device="cpu")
        _assert_same_state(j, t2)

    def test_without_updater_and_bit_equal_round_trip(self, tmp_path):
        t = MultiLayerNetwork(_mln_conf(NeuralNetConfiguration, tlayers,
                                        InputType, tupd)).init(device="cpu")
        x, y = _data((2, 6, 6), 3, seed=2)
        t.fit(DataSet(x, y))
        path = str(tmp_path / "m.zip")
        t.save(path, save_updater=False)
        with zipfile.ZipFile(path) as z:
            assert sorted(z.namelist()) == ["arrays.npz", "conf.json",
                                            "meta.json"]
        assert [f for f in os.listdir(tmp_path)] == ["m.zip"]
        back = MultiLayerNetwork.load(path, device="cpu")
        assert back._opt_state is None and back.getIterationCount() == 1
        assert torch.equal(back.output(x), t.output(x))
        assert torch.equal(t.clone().output(x), t.output(x))

    def test_clone_is_independent(self):
        t = MultiLayerNetwork(_mln_conf(NeuralNetConfiguration, tlayers,
                                        InputType, tupd)).init(device="cpu")
        x, y = _data((2, 6, 6), 3, seed=3)
        c = t.clone()
        before = t.params().clone()
        c.fit(DataSet(x, y))
        assert torch.equal(t.params(), before)
        assert not torch.equal(c.params(), before)
        assert c.getIterationCount() == 1 and t.getIterationCount() == 0


class TestGraphArchive:
    def test_both_ways(self, tmp_path):
        j = JCG(_graph_conf(JConf, jlayers, JInputType, jupd, JEW)).init()
        x, y = _data((2, 5, 5), 2, seed=4)
        j.fit(JDataSet(x, y), epochs=2)
        j.save(str(tmp_path / "jax.zip"))
        t = ComputationGraph.load(str(tmp_path / "jax.zip"), device="cpu")
        _assert_same_state(j, t, graph=True)
        np.testing.assert_allclose(t.output(x).numpy(),
                                   np.asarray(j.output(x)), rtol=OUT_TOL,
                                   atol=OUT_TOL)
        t.fit(DataSet(x, y))
        t.save(str(tmp_path / "port.zip"))
        j2 = JCG.load(str(tmp_path / "port.zip"))
        _assert_same_state(j2, t, graph=True)
        assert t.summary().splitlines()[-1] == j2.summary().splitlines()[-1]

    def test_port_round_trip_is_bit_equal(self, tmp_path):
        t = ComputationGraph(_graph_conf(NeuralNetConfiguration, tlayers,
                                         InputType, tupd, TEW)
                             ).init(device="cpu")
        t.setComputeLayout("NHWC")
        t.setEpilogueFusion(True)
        x, y = _data((2, 5, 5), 2, seed=5)
        t.fit(DataSet(x, y))
        path = str(tmp_path / "g.zip")
        t.save(path)
        back = ComputationGraph.load(path, device="cpu")
        back.setEpilogueFusion(True)
        assert back._compute_layout == "NHWC"
        assert torch.equal(back.output(x), t.output(x))
        assert torch.equal(t.clone().output(x), t.output(x))

    def test_an_unported_vertex_is_named(self, tmp_path):
        import json
        conf = _graph_conf(NeuralNetConfiguration, tlayers, InputType, tupd,
                           TEW)
        d = json.loads(conf.to_json())
        d["nodes"][4]["conf"]["@class"] = "LastTimeStepVertex"
        from deeplearning4j_tpu_torch.nn.graph import \
            ComputationGraphConfiguration
        with pytest.raises(NotImplementedError, match="LastTimeStepVertex"):
            ComputationGraphConfiguration.from_json(json.dumps(d))


class TestCorruptArchives:
    def _saved(self, tmp_path):
        t = MultiLayerNetwork(_mln_conf(NeuralNetConfiguration, tlayers,
                                        InputType, tupd)).init(device="cpu")
        t.fit(DataSet(*_data((2, 6, 6), 3)))
        path = str(tmp_path / "m.zip")
        t.save(path)
        return path

    def test_truncated_zip(self, tmp_path):
        path = self._saved(tmp_path)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 2)
        with pytest.raises(tser.CorruptModelError, match="not a readable"):
            MultiLayerNetwork.load(path, device="cpu")
        with pytest.raises(tser.CorruptModelError):
            ComputationGraph.load(path, device="cpu")

    def test_missing_entries_are_named(self, tmp_path):
        path = str(tmp_path / "m.zip")
        with zipfile.ZipFile(path, "w") as z:
            z.writestr("conf.json", "{}")
            z.writestr("meta.json", "{}")
        with pytest.raises(tser.CorruptModelError,
                           match=r"m\.zip\[arrays\.npz\]") as e:
            MultiLayerNetwork.load(path, device="cpu")
        assert e.value.entry == "arrays.npz"
        (tmp_path / "good").mkdir()
        good = self._saved(tmp_path / "good")
        conf_json, meta, arrays = tser.read_model_zip(good)
        kept = {k: arrays[k] for k in arrays.files if k != "u::3"}
        tser.write_model_zip(path, conf_json, meta, kept)
        with pytest.raises(tser.CorruptModelError) as e:
            MultiLayerNetwork.load(path, device="cpu")
        assert e.value.entry == "arrays.npz::u::3"

    def test_crc_damage(self, tmp_path):
        path = self._saved(tmp_path)
        size = os.path.getsize(path)
        with open(path, "r+b") as f:
            f.seek(size // 2)
            chunk = f.read(32)
            f.seek(size // 2)
            f.write(bytes(b ^ 0xFF for b in chunk))
        with pytest.raises(tser.CorruptModelError):
            MultiLayerNetwork.load(path, device="cpu")

    def test_a_failed_write_leaves_the_old_archive(self, tmp_path):
        path = self._saved(tmp_path)
        before = open(path, "rb").read()
        with pytest.raises(RuntimeError):
            with tser.atomic_write(path) as tmp:
                open(tmp, "wb").write(b"partial")
                raise RuntimeError("crash mid-write")
        assert open(path, "rb").read() == before
        assert os.listdir(tmp_path) == ["m.zip"]
