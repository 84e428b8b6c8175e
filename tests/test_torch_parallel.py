"""The port's data parallelism over ranks (``deeplearning4j_tpu_torch.
parallel``) held against the JAX package's ``tests/test_parallel.py``
mesh and data-parallel cases, and a sync-BN case.

Each port case runs on spawned gloo ranks on the CPU (one module-scoped
``RankPool`` of 4, ``torch.set_num_threads(1)`` in each, a file store
under the test's temporary directory, a timeout on every group); the
JAX function runs on the same seeded numpy inputs over a JAX mesh of the
same size cut from conftest's 8 CPU devices (``jax.devices()[:n]``).
The port nets start from the JAX nets' params (``params_from_jax``): the
two packages' initial draws differ. Tolerances: the JAX tests' own
(``rtol=2e-3, atol=1e-4`` on outputs, test_parallel.py:120-121).

The rank functions are module-level so the ranks import them; JAX is
imported only inside the tests (the ranks never import it). The twins
of the ring-attention and sharded-transformer cases are in
``test_torch_sequence.py`` and ``test_torch_tensor_parallel.py``.
"""

import numpy as np
import pytest

from deeplearning4j_tpu_torch.parallel.launch import RankPool

WORLD = 4
RTOL, ATOL = 2e-3, 1e-4


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(WORLD, str(tmp_path_factory.mktemp("store")),
                  device="cpu") as p:
        yield p


def _modules(pkg: str):
    """(NeuralNetConfiguration, InputType, layers, updaters,
    MultiLayerNetwork) of ``pkg`` (``"jax"`` or ``"torch"``)."""
    import importlib
    base = "deeplearning4j_tpu" if pkg == "jax" else "deeplearning4j_tpu_torch"
    cfg = importlib.import_module(f"{base}.nn.config")
    return (cfg.NeuralNetConfiguration, cfg.InputType,
            importlib.import_module(f"{base}.nn.layers"),
            importlib.import_module(f"{base}.train.updaters"),
            importlib.import_module(f"{base}.nn.multilayer").MultiLayerNetwork)


def _dp_conf(pkg):
    C, It, L, U, _ = _modules(pkg)
    return (C.Builder().seed(42).updater(U.Adam(0.05)).list()
            .layer(L.DenseLayer(nOut=16, activation="relu"))
            .layer(L.OutputLayer(nOut=3, lossFunction="mcxent",
                                 activation="softmax"))
            .setInputType(It.feedForward(4)).build())


def _bn_conf(pkg):
    """A ResNet-style block: conv -> BN -> relu, twice, then a global
    average pool and the output layer."""
    C, It, L, U, _ = _modules(pkg)
    return (C.Builder().seed(3).updater(U.Sgd(0.1)).list()
            .layer(L.ConvolutionLayer(nOut=8, kernelSize=(3, 3),
                                      padding=(1, 1), activation="identity"))
            .layer(L.BatchNormalization())
            .layer(L.ActivationLayer(activation="relu"))
            .layer(L.ConvolutionLayer(nOut=8, kernelSize=(3, 3),
                                      padding=(1, 1), activation="identity"))
            .layer(L.BatchNormalization())
            .layer(L.ActivationLayer(activation="relu"))
            .layer(L.GlobalPoolingLayer(poolingType="avg"))
            .layer(L.OutputLayer(nOut=3, lossFunction="mcxent",
                                 activation="softmax"))
            .setInputType(It.convolutional(8, 8, 3)).build())


def _host_tree(tree):
    import jax
    return jax.tree_util.tree_map(lambda a: np.array(np.asarray(a)), tree)


# ------------------------------------------------------- rank functions
def rank_mesh_shapes():
    from deeplearning4j_tpu_torch.parallel import DeviceMesh
    m = DeviceMesh.create(data=2, model=2, seq=1)
    m2 = DeviceMesh.create(data=-1, model=2)
    return (m.size(), m.size("data"), m.size("model"), m.size("seq"),
            m2.size("data"))


def rank_shard_batch(x):
    from deeplearning4j_tpu_torch.parallel import DeviceMesh
    from deeplearning4j_tpu_torch.parallel.mesh import placement_of
    m = DeviceMesh.data_parallel()
    sx = m.shard_batch(x)
    p = placement_of(sx)
    return sx.numpy(), p.global_shape, p.index, p.parts


def rank_sharding_rule(params):
    from deeplearning4j_tpu_torch.parallel import DeviceMesh, ShardingRule
    from deeplearning4j_tpu_torch.parallel.mesh import spec_of
    m = DeviceMesh.create(data=2, model=2)
    tp = ShardingRule({r"w1": (None, "model"),
                       r"w2": ("model", None)}).shard_params(m, params)
    tp = {k: (v.numpy(), spec_of(v)) for k, v in tp.items()}
    dm = DeviceMesh.data_parallel()
    out = ShardingRule({r"w2": ("data", None)}).shard_params(dm, params)
    return tp, {k: (v.numpy(), spec_of(v)) for k, v in out.items()}


def rank_dp_fit(conf_name, params, states, x, y, batch, epochs, probe):
    from deeplearning4j_tpu_torch.data.dataset import (DataSet,
                                                       ListDataSetIterator)
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    conf = {"dp": _dp_conf, "bn": _bn_conf}[conf_name]("torch")
    net = _modules("torch")[4](conf).params_from_jax(params, states,
                                                     device="cpu")
    ParallelWrapper(net).fit(ListDataSetIterator(DataSet(x, y), batch),
                             epochs=epochs)
    out = net.output(probe).detach().numpy()
    return (out, net.params().numpy(), float(net.score()),
            [{k: v.numpy() for k, v in s.items()} for s in net._states])


# ================================================================ mesh
class TestMesh:
    def test_create_shapes(self, pool, devices):
        """(data=2, model=2) and (data=-1, model=2) over 4 ranks: the
        sizes the JAX mesh has over 4 devices."""
        from deeplearning4j_tpu.parallel import DeviceMesh as JMesh
        jm = JMesh.create(data=2, model=2, seq=1, devices=devices[:4])
        jm2 = JMesh.create(data=-1, model=2, devices=devices[:4])
        want = (jm.size(), jm.size("data"), jm.size("model"),
                jm.size("seq"), jm2.size("data"))
        assert want == (4, 2, 2, 1, 2)
        assert pool.run(rank_mesh_shapes) == [want] * WORLD

    def test_shard_batch_places(self, pool, devices):
        """A host batch onto a data=4 mesh: rank r holds the rows the JAX
        mesh puts on device r, tagged with their place (bit-equal)."""
        from deeplearning4j_tpu.parallel import DeviceMesh as JMesh
        x = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
        jm = JMesh.create(data=4, devices=devices[:4])
        sx = jm.shard_batch(x)
        by_dev = {sh.device.id: np.asarray(sh.data)
                  for sh in sx.addressable_shards}
        for r, (piece, gshape, index, parts) in enumerate(
                pool.run(rank_shard_batch, x)):
            assert (gshape, index, parts) == ((8, 3), r, 4)
            np.testing.assert_array_equal(piece, by_dev[devices[r].id])

    def test_sharding_rule(self, pool, devices):
        """A rule over the model axis of a data=2 x model=2 mesh and one
        over the data axis keep each rank's piece of the dim, the JAX
        sharding's shard on that device; unmatched params replicate."""
        from deeplearning4j_tpu.parallel import DeviceMesh as JMesh
        from deeplearning4j_tpu.parallel import ShardingRule as JRule
        params = {"w1": np.arange(32, dtype=np.float32).reshape(4, 8),
                  "w2": np.arange(32, dtype=np.float32).reshape(8, 4),
                  "b": np.ones((4,), np.float32)}
        jm = JMesh.create(data=4, devices=devices[:4])
        jout = JRule({r"w2": ("data", None)}).shard_params(jm, params)
        shards = {sh.device.id: np.asarray(sh.data)
                  for sh in jout["w2"].addressable_shards}
        jtp = JRule({r"w1": (None, "model"), r"w2": ("model", None)}
                    ).shard_params(JMesh.create(data=2, model=2,
                                                devices=devices[:4]),
                                   params)
        for r, (tp, out) in enumerate(pool.run(rank_sharding_rule,
                                               params)):
            for k in ("w1", "w2"):
                want = {sh.device.id: np.asarray(sh.data)
                        for sh in jtp[k].addressable_shards}
                assert tp[k][1] == tuple(jtp[k].sharding.spec)
                np.testing.assert_array_equal(tp[k][0], want[devices[r].id])
            assert tp["b"][1] == (None,)
            piece, spec = out["w2"]
            assert spec == ("data", None)
            assert tuple(jout["w2"].sharding.spec) == ("data", None)
            np.testing.assert_array_equal(piece, shards[devices[r].id])
            np.testing.assert_array_equal(out["b"][0], params["b"])
            assert out["b"][1] == (None,)


# ========================================================= data parallel
class TestDataParallelTraining:
    def test_dp_training_matches_single_device(self, pool, devices):
        """Iris, 5 epochs of batches of 40 (the last of 30, padded to 32
        with zero-weight rows): the port's ParallelWrapper over 4 ranks
        against the JAX ParallelWrapper over 4 devices and the JAX single
        device fit, on outputs (test_parallel.py's tolerance)."""
        from deeplearning4j_tpu.data import (IrisDataSetIterator,
                                             ListDataSetIterator,
                                             NormalizerStandardize)
        from deeplearning4j_tpu.parallel import DeviceMesh as JMesh
        from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
        ds = IrisDataSetIterator(150).next()
        ds.shuffle(seed=0)
        norm = NormalizerStandardize()
        norm.fit(ds)
        norm.transform(ds)
        x, y = np.asarray(ds.features), np.asarray(ds.labels)
        MLN = _modules("jax")[4]
        single = MLN(_dp_conf("jax")).init()
        p0 = _host_tree(single._params)
        s0 = _host_tree(single._states)
        single.fit(ListDataSetIterator(ds, 40), epochs=5)
        dp = MLN(_dp_conf("jax")).init()
        JPW(dp, JMesh.create(data=4, devices=devices[:4])).fit(
            ListDataSetIterator(ds, 40), epochs=5)
        out = pool.run(rank_dp_fit, "dp", p0, s0, x, y, 40, 5, x[:16])
        for o, p, *_ in out[1:]:
            np.testing.assert_array_equal(p, out[0][1])   # replicas agree
        port = out[0][0]
        np.testing.assert_allclose(port, np.asarray(dp.output(x[:16])),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(port, np.asarray(single.output(x[:16])),
                                   rtol=RTOL, atol=ATOL)

    def test_dp_handles_uneven_batch(self, pool, devices):
        """13 rows over 4 ranks (padded to 16 with zero-weight rows): the
        port's loss equals the JAX wrapper's on 4 devices (the same
        mean over 13 real rows) within the tolerance, and is finite."""
        from deeplearning4j_tpu.data import DataSet as JDataSet
        from deeplearning4j_tpu.data import ListDataSetIterator
        from deeplearning4j_tpu.parallel import DeviceMesh as JMesh
        from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
        rng = np.random.RandomState(0)
        x = rng.randn(13, 4).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 13)]
        net = _modules("jax")[4](_dp_conf("jax")).init()
        p0, s0 = _host_tree(net._params), _host_tree(net._states)
        JPW(net, JMesh.create(data=4, devices=devices[:4])).fit(
            ListDataSetIterator(JDataSet(x, y), 13), epochs=1)
        out = pool.run(rank_dp_fit, "dp", p0, s0, x, y, 13, 1, x)
        assert all(np.isfinite(o[2]) for o in out)
        assert {o[2] for o in out} == {out[0][2]}
        np.testing.assert_allclose(out[0][2], float(net.score()),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(out[0][0], np.asarray(net.output(x)),
                                   rtol=RTOL, atol=ATOL)


class TestSyncBatchNorm:
    def test_bn_block_over_four_ranks_equals_one_device(self, pool):
        """A ResNet-style conv/BN/relu block trained over 4 ranks (8 rows
        each of a global 32) with sync BN equals the JAX single-device fit
        on the whole batch: the same batch statistics (the running mean
        and variance, decay 0.9, biased variance, equal on every rank) and
        the same params, SGD so no normalization amplifies rounding;
        rtol 1e-4, atol 1e-5."""
        from deeplearning4j_tpu.data import DataSet as JDataSet
        from deeplearning4j_tpu.data import ListDataSetIterator
        rng = np.random.RandomState(1)
        x = rng.randn(64, 3, 8, 8).astype(np.float32)
        y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, 64)]
        net = _modules("jax")[4](_bn_conf("jax")).init()
        p0, s0 = _host_tree(net._params), _host_tree(net._states)
        net.fit(ListDataSetIterator(JDataSet(x, y), 32), epochs=2)
        out = pool.run(rank_dp_fit, "bn", p0, s0, x, y, 32, 2, x[:8])
        for o in out[1:]:
            for a, b in zip(o[3], out[0][3]):
                for k in a:
                    np.testing.assert_array_equal(a[k], b[k])
        _, params, score, states = out[0]
        np.testing.assert_allclose(params, np.asarray(net.params()),
                                   rtol=1e-4, atol=1e-5)
        for i in (1, 4):
            for k in ("mean", "var"):
                np.testing.assert_allclose(
                    states[i][k], np.asarray(net._states[i][k]),
                    rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(score, float(net.score()), rtol=1e-4)


def test_rank_pool_defaults_to_the_card(tmp_path, monkeypatch):
    """``RankPool`` without ``device=`` takes the card, as every entry
    point does: without one it raises before any rank starts, and the
    CPU is used only when asked for."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RankPool(2, str(tmp_path))
    assert not any(tmp_path.iterdir())
