"""The port's sharded fit (``deeplearning4j_tpu_torch.distributed``:
``ShardedTrainingPlan``, ``GSPMDTrainer``, ZeRO) held against the JAX
package's ``tests/test_distributed.py``.

The port runs on 2 spawned gloo ranks on the CPU (one module-scoped
``RankPool``); the JAX function on the same seeded numpy inputs over a
2-device JAX mesh cut from conftest's 8 CPU devices, or, for its
declarations, on the meshes of the JAX test. Port nets start from the
JAX nets' params. Tolerances: bit-equal where the JAX test pins bit-
equality (the wrapper against the plan, K steps a dispatch against one,
ZeRO against replicated state, a resumed run against the uninterrupted
one); ``atol=2e-6`` against the single-device fit (the JAX test's);
``rtol=2e-3, atol=1e-4`` between the packages (test_parallel.py's).

The port's dropout masks are its own counter hash, not JAX's threefry,
so runs with dropout are held within the port (data-parallel against its
own single device) and the cross-package comparison runs without it.
The model-axis cases (``TestModelAxis``, ``TestServingOnShardedMesh``)
cut the JAX tests' ``data=2 x model=4`` mesh to ``data=1 x model=2`` (2
ranks) and, for the graph with ZeRO, ``data=2 x model=2`` (4 ranks):
each rank holds its slice of every matched weight at rest, gathers it
whole for the step and keeps its slice of the summed gradient; the JAX
tests' ``atol=2e-6`` against the single-device fit, and serving
``rtol=1e-4, atol=1e-5``.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.parallel.launch import RankPool

WORLD = 2
RTOL, ATOL = 2e-3, 1e-4


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(WORLD, str(tmp_path_factory.mktemp("store")),
                  device="cpu") as p:
        yield p


def _mods(pkg):
    import importlib
    base = "deeplearning4j_tpu" if pkg == "jax" else "deeplearning4j_tpu_torch"
    cfg = importlib.import_module(f"{base}.nn.config")
    return (cfg.NeuralNetConfiguration, cfg.InputType,
            importlib.import_module(f"{base}.nn.layers"),
            importlib.import_module(f"{base}.train.updaters"))


def _conf(pkg, dropout=False, seed=7):
    C, It, L, U = _mods(pkg)
    b = (C.Builder().seed(seed).updater(U.Adam(0.01)).list()
         .layer(L.DenseLayer(nOut=32, activation="relu")))
    if dropout:
        b = b.layer(L.DropoutLayer(0.25))
    return (b.layer(L.DenseLayer(nOut=16, activation="relu"))
            .layer(L.OutputLayer(nOut=4, lossFunction="mcxent",
                                 activation="softmax"))
            .setInputType(It.feedForward(16)).build())


def _graph_conf(pkg):
    C, It, L, U = _mods(pkg)
    g = (C.Builder().seed(4).updater(U.Adam(0.01)).graphBuilder()
         .addInputs("in").setInputTypes(It.feedForward(16)))
    g.addLayer("fc", L.DenseLayer(nOut=32, activation="relu"), "in")
    g.addLayer("out", L.OutputLayer(nOut=4, lossFunction="mcxent",
                                    activation="softmax"), "fc")
    g.setOutputs("out")
    return g.build()


def _data(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 16).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.randint(0, 4, n)]
    return x, y


def _jnet(dropout=False, seed=7, graph=False):
    if graph:
        from deeplearning4j_tpu.nn.graph import ComputationGraph
        return ComputationGraph(_graph_conf("jax")).init()
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork
    return MultiLayerNetwork(_conf("jax", dropout, seed)).init()


def _host(tree):
    import jax
    return jax.tree_util.tree_map(lambda a: np.array(np.asarray(a)), tree)


def _jstate(net):
    return _host(net._params), _host(net._states)


def _jit(n=64, bs=16, seed=0):
    from deeplearning4j_tpu.data import DataSet, ListDataSetIterator
    return ListDataSetIterator(DataSet(*_data(n, seed)), bs)


def _jmesh(devices, n=WORLD):
    from deeplearning4j_tpu.parallel import DeviceMesh
    return DeviceMesh.create(data=n, devices=devices[:n])


# ------------------------------------------------------- rank functions
def _pnet(p0=None, s0=None, dropout=False, graph=False, seed=7):
    if graph:
        from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
        net = ComputationGraph(_graph_conf("torch"))
    else:
        from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
        net = MultiLayerNetwork(_conf("torch", dropout, seed))
    if p0 is None:
        return net.init(device="cpu")
    return net.params_from_jax(p0, s0, device="cpu")


def _pit(n=64, bs=16, seed=0):
    from deeplearning4j_tpu_torch.data.dataset import (DataSet,
                                                       ListDataSetIterator)
    return ListDataSetIterator(DataSet(*_data(n, seed)), bs)


def _plan(zero=None, rules=None):
    from deeplearning4j_tpu_torch.distributed import ShardedTrainingPlan
    from deeplearning4j_tpu_torch.parallel import DeviceMesh
    return ShardedTrainingPlan(DeviceMesh.data_parallel(), zero=zero,
                               rules=rules)


def rank_train(how, p0, s0, dropout=False, n=64, bs=16, epochs=2, k=1,
               zero_min=None, graph=False, seed=0):
    """One fit of the port net from the JAX params: ``how`` is single,
    wrapper or gspmd (ZeRO with ``zero_min`` bytes)."""
    from deeplearning4j_tpu_torch.analysis import churn
    from deeplearning4j_tpu_torch.distributed import (GSPMDTrainer, ZeroPlan,
                                                      updater_hbm_bytes)
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.parallel.mesh import spec_of
    net = _pnet(p0, s0, dropout, graph)
    it = _pit(n, bs, seed)
    if how == "single":
        net.fit(it, epochs=epochs, steps_per_dispatch=k)
    elif how == "wrapper":
        ParallelWrapper(net).fit(it, epochs=epochs, steps_per_dispatch=k)
    else:
        zero = None if zero_min is None else ZeroPlan(min_bytes=zero_min)
        GSPMDTrainer(net, _plan(zero)).fit(it, epochs=epochs,
                                           steps_per_dispatch=k)
    first = "fc" if graph else 0
    site = f"{type(net).__name__}.fit"
    return {"params": net.params().numpy(), "score": float(net.score()),
            "hbm": sum(updater_hbm_bytes(net._opt_state).values()),
            "m_spec": spec_of(net._opt_state[first]["W"]["m"]),
            "churn": churn.get_churn_detector().signature_count(
                site, owner=net)}


def rank_model_axis(x):
    from deeplearning4j_tpu_torch.distributed import ShardedTrainingPlan
    from deeplearning4j_tpu_torch.parallel import DeviceMesh
    from deeplearning4j_tpu_torch.parallel.mesh import placement_of
    mesh = DeviceMesh.create(data=2, model=2)
    wide = ShardedTrainingPlan(mesh, batch_axes=("data", "model"))
    wx = wide.place(x)
    wide_rows = (wx.numpy(), placement_of(wx).index, wide.data_shards())
    plan = ShardedTrainingPlan(mesh)
    px = plan.place(x)
    mx = plan.place(np.stack([x, x, x]), mega=True)
    return (wide_rows, px.numpy(), placement_of(px).index, mx.numpy(),
            mesh.coordinate("data"))


def rank_fsdp(p0, s0, k=1, grad_norm=None):
    """A fit with every weight split over the data axis at rest (FSDP
    style) and ZeRO: what each rank holds, the specs, the collective
    kinds of the fit, the whole params and a K=1 twin's for K>1."""
    from deeplearning4j_tpu_torch.distributed import GSPMDTrainer, ZeroPlan
    from deeplearning4j_tpu_torch.parallel import collectives
    from deeplearning4j_tpu_torch.parallel.mesh import spec_of
    net = _pnet(p0, s0)
    if grad_norm is not None:
        net.conf.base.grad_norm, net.conf.base.grad_norm_threshold = \
            grad_norm
    plan = _plan(ZeroPlan(min_bytes=0), rules={r"/W$": ("data", None)})
    with collectives.record() as rec:
        GSPMDTrainer(net, plan).fit(_pit(64, 16), epochs=2,
                                    steps_per_dispatch=k)
    w = net._params[0]["W"]
    out = {"params": net.params().numpy(), "score": float(net.score()),
           "w_local": tuple(w.shape), "w_spec": spec_of(w),
           "m_spec": spec_of(net._opt_state[0]["W"]["m"]),
           "param_specs": plan.param_specs(net),
           "opt_spec": plan.opt_specs(net)[(0, "W", "m")],
           "kinds": sorted(rec.bytes)}
    net.setShardingPlan(None)
    out["detached"] = tuple(net._params[0]["W"].shape)
    return out


def rank_signature_caches():
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    net = _pnet()
    plan = _plan()
    net.setShardingPlan(plan)
    plan.apply(net)
    net._fit_one(DataSet(*_data(16)))
    out = [bool(net._step_cache)]
    net.setShardingPlan(_plan())
    out.append(bool(net._step_cache))
    net.setShardingPlan(_plan(zero=True))
    out.append(bool(net._step_cache))
    return out


def rank_warmup(p0, s0):
    from deeplearning4j_tpu_torch.distributed import GSPMDTrainer
    net = _pnet(p0, s0)
    tr = GSPMDTrainer(net, _plan())
    tr.warmup([((16, 16), (16, 4))])
    warmed = dict(net._step_cache)
    tr.fit(_pit(16, 16), epochs=1)
    same = list(net._step_cache.items()) == list(warmed.items())
    return list(warmed), same, float(net.score())


def rank_resume(d, p0, s0):
    from deeplearning4j_tpu_torch.distributed import GSPMDTrainer, ZeroPlan
    from deeplearning4j_tpu_torch.train.resilience import CheckpointConfig
    a = _pnet(p0, s0)
    GSPMDTrainer(a, _plan(ZeroPlan(min_bytes=0))).fit(
        _pit(64, 16), epochs=2, checkpoint=CheckpointConfig(d, every_steps=4))
    b = _pnet(seed=99)
    GSPMDTrainer(b, _plan(ZeroPlan(min_bytes=0))).fit(
        _pit(64, 16), epochs=2, checkpoint=CheckpointConfig(d, resume=True))
    return a.params().numpy(), b.params().numpy(), b._iteration


def rank_gather(p0, s0):
    from deeplearning4j_tpu_torch.distributed import (GSPMDTrainer, ZeroPlan,
                                                      gather_opt_state)
    net = _pnet(p0, s0)
    plan = _plan(ZeroPlan(min_bytes=0))
    GSPMDTrainer(net, plan).fit(_pit(16, 16), epochs=1)
    host = gather_opt_state(net._opt_state, plan.group)
    leaves = [v for st in host.values() for sd in st.values()
              for v in sd.values()]
    return (all(isinstance(v, np.ndarray) for v in leaves),
            host[0]["W"]["m"], net._opt_state[0]["W"]["m"].numpy())


def _fit_steps(trainer, n_batches):
    trainer.fit(_pit(16 * n_batches, 16, seed=3), epochs=1)


def rank_zero_resume(d, p0, s0):
    """save_sharded at step 4 -> a differently initialized net restores it
    in place -> 4 more steps == the uninterrupted 8."""
    from deeplearning4j_tpu_torch.distributed import GSPMDTrainer, ZeroPlan
    from deeplearning4j_tpu_torch.parallel import checkpoint as ckpt
    a = _pnet(p0, s0)
    ta = GSPMDTrainer(a, _plan(ZeroPlan(min_bytes=0)))
    _fit_steps(ta, 4)
    ckpt.save_sharded(d, {"params": a._params, "opt": a._opt_state},
                      step=a._iteration)
    _fit_steps(ta, 4)
    ref = a.params().numpy()
    b = _pnet(seed=99)
    tb = GSPMDTrainer(b, _plan(ZeroPlan(min_bytes=0)))
    tb.plan.apply(b)
    restored, step = ckpt.load_sharded(d, {"params": b._params,
                                           "opt": b._opt_state})
    _copy_into(b, restored, step)
    _fit_steps(tb, 4)
    return ref, b.params().numpy(), step


def _copy_into(net, restored, step):
    """The port's restore idiom: loaded values copied into the network's
    own tensors (captured steps keep their storage)."""
    with torch.no_grad():
        for n, p in net._items(net._params):
            for k, v in p.items():
                v.copy_(restored["params"][n][k])
        for n, st in net._items(net._opt_state):
            for k, sd in st.items():
                for sk, sv in sd.items():
                    sv.copy_(restored["opt"][n][k][sk])
    net._iteration, net._t_dev = step, None


def rank_zero_save(d, p0, s0):
    from deeplearning4j_tpu_torch.distributed import (GSPMDTrainer, ZeroPlan,
                                                      gather_opt_state)
    from deeplearning4j_tpu_torch.parallel import checkpoint as ckpt
    a = _pnet(p0, s0)
    plan = _plan(ZeroPlan(min_bytes=0))
    _fit_steps(GSPMDTrainer(a, plan), 4)
    ckpt.save_sharded(d, {"params": a._params, "opt": a._opt_state},
                      step=a._iteration)
    return (gather_opt_state(a._opt_state, plan.group)[0]["W"]["m"],
            a._params[0]["W"].detach().numpy())


def rank_collectives(p0, s0):
    from deeplearning4j_tpu_torch.distributed.gspmd import (
        hlo_collective_bytes, step_collective_bytes)
    net = _pnet(p0, s0)
    plan = _plan()
    net.setShardingPlan(plan)
    plan.apply(net)
    x, y = _data(64)
    return hlo_collective_bytes(step_collective_bytes(net, x, y))


def rank_model_axis_fit(p0, s0, axes, rules, graph=False, zero_min=None,
                        k=2):
    """A fit over ``axes`` with ``rules`` splitting weights over
    ``model``: the whole params, what this rank holds of the first
    matched W and its spec, and the moment's spec."""
    from deeplearning4j_tpu_torch.distributed import (GSPMDTrainer,
                                                      ShardedTrainingPlan,
                                                      ZeroPlan)
    from deeplearning4j_tpu_torch.parallel import DeviceMesh
    from deeplearning4j_tpu_torch.parallel.mesh import spec_of
    net = _pnet(p0, s0, graph=graph)
    zero = None if zero_min is None else ZeroPlan(min_bytes=zero_min)
    plan = ShardedTrainingPlan(DeviceMesh.create(**axes), rules=rules,
                               zero=zero)
    GSPMDTrainer(net, plan).fit(_pit(64, 16), epochs=2,
                                steps_per_dispatch=k)
    first = "fc" if graph else 0
    w = net._params[first]["W"]
    return {"params": net.params().numpy(), "w_local": tuple(w.shape),
            "w_spec": spec_of(w),
            "m_spec": spec_of(net._opt_state[first]["W"]["m"]),
            "score": float(net.score())}


def rank_serve_on_plan(p0, s0, x):
    """``ModelRegistry.load(..., plan=)`` over data=1 x model=2: the
    leader's answer (None on the follower) and the spec of the first W
    on this rank."""
    from deeplearning4j_tpu_torch.distributed import ShardedTrainingPlan
    from deeplearning4j_tpu_torch.parallel import DeviceMesh
    from deeplearning4j_tpu_torch.parallel.mesh import spec_of
    from deeplearning4j_tpu_torch.serving.registry import ModelRegistry
    net = _pnet(p0, s0)
    plan = ShardedTrainingPlan(DeviceMesh.create(data=1, model=2),
                               rules={r"/W$": (None, "model")})
    reg = ModelRegistry(device="cpu", batch_limit=8, coalesce_ms=0.5)
    reg.load("m", net, shapes=[(16,)], plan=plan)
    spec = spec_of(net._params[0]["W"])
    out = None
    server = reg._version("m").server
    if server.is_leader:
        out = reg.output("m", x, timeout=30)
        reg.close()
    else:
        assert reg.follow() == "stopped"
        reg.close()
    return out, spec, server.buckets()


# ===================================================== ShardedTrainingPlan
class TestShardedTrainingPlan:
    def test_batch_spec_shards_dim0_and_mega_dim1(self, devices):
        from deeplearning4j_tpu.distributed import ShardedTrainingPlan as JP
        from deeplearning4j_tpu.parallel import DeviceMesh as JMesh
        jplan = JP(JMesh.data_parallel())
        plan = _plan()
        for nd, mega in ((2, False), (2, True), (1, False), (1, True)):
            assert plan.batch_spec(nd, mega) == \
                tuple(jplan.batch_spec(nd, mega))
        assert plan.batch_spec(2) == ("data", None)
        assert plan.batch_spec(2, mega=True) == (None, "data")

    def test_model_axis_mesh_replicates_batch_over_model(self, devices,
                                                         tmp_path):
        """On data=2 x model=2 ranks the batch splits 2 ways and
        replicates over the model axis: each rank holds the rows the JAX
        sharding puts on the device at its coordinate (a megabatch's dim
        1 likewise); batch axes ``("data", "model")`` split it over
        their product, 4 ways, as the JAX plan's placement does."""
        from deeplearning4j_tpu.distributed import ShardedTrainingPlan as JP
        from deeplearning4j_tpu.parallel import DeviceMesh as JMesh
        x = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
        jmesh = JMesh.create(data=2, model=2, devices=devices[:4])
        jx = JP(jmesh).place(x)
        assert len(jx.sharding.device_set) == 4
        rows = {sh.device.id: np.asarray(sh.data)
                for sh in jx.addressable_shards}
        jw = JP(jmesh, batch_axes=("data", "model")).place(x)
        wide = {sh.device.id: np.asarray(sh.data)
                for sh in jw.addressable_shards}
        with RankPool(4, str(tmp_path), device="cpu") as pool4:
            out = pool4.run(rank_model_axis, x)
        for r, ((wx, windex, shards), px, index, mx, coord) in \
                enumerate(out):
            assert shards == 4 and windex == r
            np.testing.assert_array_equal(wx, wide[devices[r].id])
            np.testing.assert_array_equal(px, rows[devices[r].id])
            assert index == coord
            np.testing.assert_array_equal(mx[1], px)

    def test_param_rules_and_names(self, devices):
        """Rule matching on ``"<layer>/<param>"`` names (a size-1 model
        axis): the specs the JAX plan gives."""
        from deeplearning4j_tpu.distributed import ShardedTrainingPlan as JP
        from deeplearning4j_tpu.parallel import DeviceMesh as JMesh
        jnet = _jnet()
        jsh = JP(JMesh.create(data=2, model=4),
                 rules={r"/W$": (None, "model")}).param_shardings(jnet)
        plan = _plan(rules={r"/W$": (None, "model")})
        specs = plan.param_specs(_pnet(*_jstate(jnet)))
        assert specs[(0, "W")] == tuple(jsh[0]["W"].spec) == \
            (None, "model")
        assert specs[(0, "b")] == tuple(jsh[0]["b"].spec) == ()

    def test_zero_state_spec_composes_with_param_spec(self):
        from deeplearning4j_tpu.distributed import ZeroPlan as JZ
        from deeplearning4j_tpu_torch.distributed import ZeroPlan
        cases = [((None, "model"), (16, 32), 4, 8, 0),
                 (("model", None), (16, 32), 4, 8, 0),
                 ((None,), (3,), 4, 8, 0),
                 ((None, None), (16, 32), 4, 8, 10 ** 9),
                 (("data", None), (16, 32), 4, 8, 0)]
        for spec, shape, item, n, mb in cases:
            got = ZeroPlan(min_bytes=mb).state_spec(spec, shape, item, n)
            want = tuple(JZ(min_bytes=mb).state_spec(spec, shape, item, n))
            assert got == want
        assert ZeroPlan(min_bytes=0).state_spec(
            (None, "model"), (16, 32), 4, 8) == ("data", "model")

    @pytest.mark.parametrize("k, grad_norm", [
        (1, None), (2, None), (1, ("clip_global", 0.05))])
    def test_fsdp_style_data_axis_params_train(self, pool, devices, k,
                                               grad_norm):
        """Param sharding over the DATA axis (FSDP style) + ZeRO: each
        rank holds half of every weight at rest, all-gathered before the
        step and its gradient reduce-scattered; the state inherits the
        param's spec; the params (K steps a dispatch, or a global-norm
        clip whose norm sums the pieces') equal the JAX plan's on 2
        devices within the JAX tests' tolerance."""
        from deeplearning4j_tpu.distributed import (GSPMDTrainer,
                                                    ShardedTrainingPlan,
                                                    ZeroPlan)
        from jax.sharding import PartitionSpec as P
        net = _jnet()
        if grad_norm is not None:
            net.conf.base.grad_norm, net.conf.base.grad_norm_threshold = \
                grad_norm
        plan = ShardedTrainingPlan(
            _jmesh(devices), rules={r"/W$": ("data", None)},
            zero=ZeroPlan(min_bytes=0))
        p0, s0 = _jstate(net)
        GSPMDTrainer(net, plan).fit(_jit(64, 16), epochs=2,
                                    steps_per_dispatch=k)
        assert net._opt_state[0]["W"]["m"].sharding.spec == P("data", None)
        jspecs = plan.param_shardings(net)
        got = pool.run(rank_fsdp, p0, s0, k, grad_norm)
        for r in got:
            assert r["w_local"] == (16 // WORLD, 32) and r["detached"] == \
                (16, 32)
            assert r["w_spec"] == r["m_spec"] == r["opt_spec"] == \
                tuple(net._opt_state[0]["W"]["m"].sharding.spec)
            for (n, key), spec in r["param_specs"].items():
                assert spec == tuple(jspecs[n][key].spec)
            assert {"all-gather", "reduce-scatter", "all-reduce"} <= \
                set(r["kinds"])
            np.testing.assert_array_equal(r["params"], got[0]["params"])
            assert np.isfinite(r["score"])
        np.testing.assert_allclose(got[0]["params"],
                                   np.asarray(net.params()),
                                   rtol=RTOL, atol=ATOL)

    def test_signature_busts_step_caches(self, pool, devices):
        from deeplearning4j_tpu.distributed import ShardedTrainingPlan as JP
        from deeplearning4j_tpu.data import DataSet as JDataSet
        net = _jnet()
        plan = JP(_jmesh(devices))
        net.setShardingPlan(plan)
        plan.apply(net)
        net._fit_one(JDataSet(*_data(16)))
        want = [bool(net._train_step_cache)]
        net.setShardingPlan(JP(_jmesh(devices)))
        want.append(bool(net._train_step_cache))
        net.setShardingPlan(JP(_jmesh(devices), zero=True))
        want.append(bool(net._train_step_cache))
        assert want == [True, True, False]
        assert pool.run(rank_signature_caches) == [want] * WORLD

    def test_bad_batch_axis_rejected(self):
        from deeplearning4j_tpu.distributed import ShardedTrainingPlan as JP
        from deeplearning4j_tpu.parallel import DeviceMesh as JMesh
        with pytest.raises(ValueError, match="batch axis"):
            JP(JMesh.data_parallel(), batch_axes=("nope",))
        from deeplearning4j_tpu_torch.distributed import ShardedTrainingPlan
        from deeplearning4j_tpu_torch.parallel import DeviceMesh
        with pytest.raises(ValueError, match="batch axis"):
            ShardedTrainingPlan(DeviceMesh.data_parallel(),
                                batch_axes=("nope",))


# ============================================================ GSPMD parity
class TestGSPMDParity:
    def test_bit_exact_vs_wrapper_ulp_close_to_single(self, pool, devices):
        """The plan's fit is bit-equal to ParallelWrapper's and within
        2e-6 of the single-device fit, with dropout (the port's masks at
        each rank's global row offset); without dropout, the port's
        data-parallel params against the JAX plan's on 2 devices."""
        from deeplearning4j_tpu.distributed import (GSPMDTrainer,
                                                    ShardedTrainingPlan)
        from deeplearning4j_tpu.parallel import ParallelWrapper as JPW
        p0, s0 = _jstate(_jnet(dropout=True))
        single = pool.run(rank_train, "single", p0, s0, dropout=True)[0]
        wrap = pool.run(rank_train, "wrapper", p0, s0, dropout=True)
        gspmd = pool.run(rank_train, "gspmd", p0, s0, dropout=True)
        for w, g in zip(wrap, gspmd):
            np.testing.assert_array_equal(g["params"], w["params"])
            assert g["score"] == w["score"]
        np.testing.assert_allclose(gspmd[0]["params"], single["params"],
                                   rtol=0, atol=2e-6)
        jw = _jnet(dropout=True)
        JPW(jw, _jmesh(devices)).fit(_jit(), epochs=2)
        jg = _jnet(dropout=True)
        GSPMDTrainer(jg, ShardedTrainingPlan(_jmesh(devices))).fit(
            _jit(), epochs=2)
        np.testing.assert_array_equal(np.asarray(jg.params()),
                                      np.asarray(jw.params()))
        jn = _jnet()
        GSPMDTrainer(jn, ShardedTrainingPlan(_jmesh(devices))).fit(
            _jit(), epochs=2)
        port = pool.run(rank_train, "gspmd", *_jstate(_jnet()))[0]
        np.testing.assert_allclose(port["params"], np.asarray(jn.params()),
                                   rtol=RTOL, atol=ATOL)

    def test_megastep_bit_exact_and_zero_recompiles(self, pool, devices):
        """K=3 steps a dispatch through the plan == K=1, bit-equal, with
        dropout; the K=1 run's churn detector sees one signature."""
        from deeplearning4j_tpu.distributed import (GSPMDTrainer,
                                                    ShardedTrainingPlan)
        p0, s0 = _jstate(_jnet(dropout=True))
        a = pool.run(rank_train, "gspmd", p0, s0, dropout=True, n=96)
        b = pool.run(rank_train, "gspmd", p0, s0, dropout=True, n=96, k=3)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x["params"], y["params"])
            assert x["churn"] == 1
        ja, jb = _jnet(dropout=True), _jnet(dropout=True)
        GSPMDTrainer(ja, ShardedTrainingPlan(_jmesh(devices))).fit(
            _jit(96), epochs=2)
        GSPMDTrainer(jb, ShardedTrainingPlan(_jmesh(devices))).fit(
            _jit(96), epochs=2, steps_per_dispatch=3)
        np.testing.assert_array_equal(np.asarray(ja.params()),
                                      np.asarray(jb.params()))

    def test_computation_graph_same_hooks(self, pool, devices):
        """The graph gets the same plan: ZeRO and K=2 dispatches over 2
        ranks within 2e-6 of its plain fit, the fc moments split over the
        data axis on dim 0; against the JAX graph's plan on 2 devices."""
        from deeplearning4j_tpu.distributed import (GSPMDTrainer,
                                                    ShardedTrainingPlan,
                                                    ZeroPlan)
        p0, s0 = _jstate(_jnet(graph=True))
        plain = pool.run(rank_train, "single", p0, s0, graph=True)[0]
        z = pool.run(rank_train, "gspmd", p0, s0, graph=True, k=2,
                     zero_min=0)
        np.testing.assert_allclose(z[0]["params"], plain["params"],
                                   rtol=0, atol=2e-6)
        assert z[0]["m_spec"] == ("data", None)
        jg = _jnet(graph=True)
        GSPMDTrainer(jg, ShardedTrainingPlan(
            _jmesh(devices), zero=ZeroPlan(min_bytes=0))).fit(
            _jit(), epochs=2, steps_per_dispatch=2)
        assert tuple(jg._opt_state["fc"]["W"]["m"].sharding.spec)[0] == \
            "data"
        np.testing.assert_allclose(z[0]["params"], np.asarray(jg.params()),
                                   rtol=RTOL, atol=ATOL)

    def test_uneven_batch_pads_with_zero_weight(self, pool, devices):
        """13 rows over 2 ranks: finite, and the JAX plan's loss."""
        from deeplearning4j_tpu.distributed import (GSPMDTrainer,
                                                    ShardedTrainingPlan)
        p0, s0 = _jstate(_jnet())
        out = pool.run(rank_train, "gspmd", p0, s0, n=13, bs=13, epochs=1)
        j = _jnet()
        GSPMDTrainer(j, ShardedTrainingPlan(_jmesh(devices))).fit(
            _jit(13, 13), epochs=1)
        assert np.isfinite(out[0]["score"])
        np.testing.assert_allclose(out[0]["score"], float(j.score()),
                                   rtol=RTOL, atol=ATOL)

    def test_pad_to_data_axis_handles_multidataset(self):
        """Every array grows to the shard multiple and every output gets a
        zero-weight tail mask: the port's arrays equal the JAX ones."""
        from deeplearning4j_tpu.data.dataset import MultiDataSet as JMDS
        from deeplearning4j_tpu.parallel.data import pad_to_data_axis as jpad
        from deeplearning4j_tpu_torch.data.dataset import MultiDataSet
        from deeplearning4j_tpu_torch.parallel.data import pad_to_data_axis
        rng = np.random.RandomState(0)
        f = [rng.randn(13, 4).astype(np.float32),
             rng.randn(13, 6).astype(np.float32)]
        lab = [np.eye(3, dtype=np.float32)[rng.randint(0, 3, 13)]]
        out = pad_to_data_axis(MultiDataSet(f, lab), 8)
        ref = jpad(JMDS(f, lab), 8)
        assert out.features[0].shape == (16, 4)
        for a, b in zip(out.features + out.labels + out.labels_masks,
                        ref.features + ref.labels + ref.labels_masks):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_array_equal(out.labels_masks[0][13:], 0.0)

    def test_warmup_precompiles_the_dispatched_program(self, pool, devices):
        """warmup over the plan makes the dispatch fit then runs: one
        step (each rank's 8 rows of the padded 16), the one the fit
        dispatches (on the CPU nothing is captured: the JAX side counts
        its warmed signature)."""
        from deeplearning4j_tpu.distributed import (GSPMDTrainer,
                                                    ShardedTrainingPlan)
        net = _jnet()
        tr = GSPMDTrainer(net, ShardedTrainingPlan(_jmesh(devices)))
        tr.warmup([((16, 16), (16, 4))])
        assert net._train_step_cache[(False, False)].warmed_signatures() == 1
        for keys, same, score in pool.run(rank_warmup, *_jstate(_jnet())):
            assert keys == [(False, False, 1)] and same
            assert np.isfinite(score)

    def test_resilience_checkpoint_resume_replaces_onto_plan(
            self, pool, devices, tmp_path):
        """checkpoint= composes with ZeRO: rank 0 writes (the split
        moments gathered), a differently initialized net resumes the
        newest checkpoint onto the plan (each rank keeps its pieces) and
        ends bit-equal to the donor; the JAX pin on 2 devices too."""
        from deeplearning4j_tpu.distributed import (GSPMDTrainer,
                                                    ShardedTrainingPlan,
                                                    ZeroPlan)
        from deeplearning4j_tpu.train.resilience import CheckpointConfig
        d = str(tmp_path / "port")
        for a, b, it in pool.run(rank_resume, d, *_jstate(_jnet())):
            np.testing.assert_array_equal(a, b)
            assert it == 8
        jd = str(tmp_path / "jax")
        ja, jb = _jnet(), _jnet(seed=99)
        for net, ck in ((ja, CheckpointConfig(jd, every_steps=4)),
                        (jb, CheckpointConfig(jd, resume=True))):
            GSPMDTrainer(net, ShardedTrainingPlan(
                _jmesh(devices), zero=ZeroPlan(min_bytes=0))).fit(
                _jit(), epochs=2, checkpoint=ck)
        np.testing.assert_array_equal(np.asarray(ja.params()),
                                      np.asarray(jb.params()))

    def test_validate_carries_plan_declaration(self, devices):
        from deeplearning4j_tpu.distributed import (GSPMDTrainer,
                                                    ShardedTrainingPlan,
                                                    ZeroPlan)
        from deeplearning4j_tpu_torch.distributed import GSPMDTrainer as PT
        from deeplearning4j_tpu_torch.distributed import ZeroPlan as PZ
        jr = GSPMDTrainer(_jnet(), ShardedTrainingPlan(
            _jmesh(devices), zero=ZeroPlan())).validate(batch_size=16)
        pr = PT(_pnet(), _plan(PZ())).validate(batch_size=16)
        assert "DL4J-E102" not in jr.codes()
        assert "DL4J-E102" not in pr.codes()


class TestModelAxis:
    def test_model_axis_mesh_one_code_path(self, pool, devices):
        """data=1 x model=2 with a W rule: the same fit() (K=2 a
        dispatch), within 2e-6 of the single-device fit (the JAX test's
        data=2 x model=4); each rank holds half of every W's columns."""
        from deeplearning4j_tpu.distributed import (GSPMDTrainer,
                                                    ShardedTrainingPlan)
        from deeplearning4j_tpu.parallel import DeviceMesh as JMesh
        p0, s0 = _jstate(_jnet())
        single = pool.run(rank_train, "single", p0, s0)[0]
        out = pool.run(rank_model_axis_fit, p0, s0,
                       {"data": 1, "model": 2}, {r"/W$": (None, "model")})
        for o in out:
            np.testing.assert_allclose(o["params"], single["params"],
                                       rtol=0, atol=2e-6)
            assert o["w_spec"] == (None, "model")
            assert o["w_local"] == (16, 16)
        jt = _jnet()
        GSPMDTrainer(jt, ShardedTrainingPlan(
            JMesh.create(data=2, model=4),
            rules={r"/W$": (None, "model")})).fit(_jit(), epochs=2,
                                                  steps_per_dispatch=2)
        assert tuple(jt._params[0]["W"].sharding.spec) == (None, "model")
        np.testing.assert_allclose(out[0]["params"],
                                   np.asarray(jt.params()),
                                   rtol=RTOL, atol=ATOL)

    def test_computation_graph_model_axis_same_hooks(self, pool, devices,
                                                     tmp_path):
        """The graph on data=2 x model=2 (4 ranks; JAX: 2 x 4) with the
        fc rule, ZeRO and K=2: within 2e-6 of the plain graph fit; fc/W
        split over model at rest, its moments with it."""
        from deeplearning4j_tpu.distributed import (GSPMDTrainer,
                                                    ShardedTrainingPlan,
                                                    ZeroPlan)
        from deeplearning4j_tpu.parallel import DeviceMesh as JMesh
        p0, s0 = _jstate(_jnet(graph=True))
        plain = pool.run(rank_train, "single", p0, s0, graph=True)[0]
        with RankPool(4, str(tmp_path), device="cpu") as pool4:
            out = pool4.run(rank_model_axis_fit, p0, s0,
                            {"data": 2, "model": 2},
                            {r"fc/W$": (None, "model")}, graph=True,
                            zero_min=0)
        for o in out:
            np.testing.assert_allclose(o["params"], plain["params"],
                                       rtol=0, atol=2e-6)
            assert o["w_spec"] == (None, "model")
            assert o["m_spec"] == (None, "model")
            assert o["w_local"] == (16, 16)
        jg = _jnet(graph=True)
        GSPMDTrainer(jg, ShardedTrainingPlan(
            JMesh.create(data=2, model=4), rules={r"fc/W$": (None, "model")},
            zero=ZeroPlan(min_bytes=0))).fit(_jit(), epochs=2,
                                             steps_per_dispatch=2)
        assert tuple(jg._params["fc"]["W"].sharding.spec) == \
            (None, "model")
        np.testing.assert_allclose(out[0]["params"],
                                   np.asarray(jg.params()),
                                   rtol=RTOL, atol=ATOL)


class TestServingOnShardedMesh:
    def test_registry_stages_version_on_plan_mesh(self, pool, devices):
        """The registry stages the version on the plan's data=1 x
        model=2 mesh (the JAX test's data=2 x model=4): W split over
        model on each rank; the leader answers as the unsharded net."""
        from deeplearning4j_tpu.distributed import ShardedTrainingPlan as JP
        from deeplearning4j_tpu.parallel import DeviceMesh as JMesh
        from deeplearning4j_tpu.serving.registry import ModelRegistry as JR
        jnet = _jnet()
        x = _data(8)[0]
        ref = np.asarray(jnet.output(x))
        out = pool.run(rank_serve_on_plan, *_jstate(jnet), x)
        np.testing.assert_allclose(out[0][0], ref, rtol=1e-4, atol=1e-5)
        assert out[1][0] is None
        for _, spec, buckets in out:
            assert spec == (None, "model") and buckets == [1, 2, 4, 8]
        plan = JP(JMesh.create(data=2, model=4),
                  rules={r"/W$": (None, "model")})
        with JR(batch_limit=8, coalesce_ms=0.5) as reg:
            reg.load("m", jnet, shapes=[(16,)], plan=plan)
            np.testing.assert_allclose(
                np.asarray(reg.output("m", x, timeout=30)), out[0][0],
                rtol=1e-4, atol=1e-5)


# ================================================================== ZeRO
class TestZeroShardedUpdaterState:
    def test_opt_state_sharded_and_hbm_measured(self, pool, devices):
        """Each rank's measured updater bytes under ZeRO at <= 0.6 of the
        replicated path's over 2 ranks (the small output-layer tensors
        split too at min_bytes=0; the JAX ratio on 2 devices alike), the
        moments split over the data axis, the gauge published."""
        from deeplearning4j_tpu.distributed import (GSPMDTrainer,
                                                    ShardedTrainingPlan,
                                                    ZeroPlan,
                                                    updater_hbm_bytes)
        p0, s0 = _jstate(_jnet())
        rep = pool.run(rank_train, "gspmd", p0, s0, epochs=1)
        zero = pool.run(rank_train, "gspmd", p0, s0, epochs=1, zero_min=0)
        for r, z in zip(rep, zero):
            assert z["m_spec"] == ("data", None)
            assert z["hbm"] / r["hbm"] <= 0.6
        jr, jz = _jnet(), _jnet()
        GSPMDTrainer(jr, ShardedTrainingPlan(_jmesh(devices))).fit(
            _jit(), epochs=1)
        GSPMDTrainer(jz, ShardedTrainingPlan(
            _jmesh(devices), zero=ZeroPlan(min_bytes=0))).fit(
            _jit(), epochs=1)
        ratio = sum(updater_hbm_bytes(jz._opt_state, record=False).values()) \
            / sum(updater_hbm_bytes(jr._opt_state, record=False).values())
        assert ratio <= 0.6
        from deeplearning4j_tpu_torch import profiler
        from deeplearning4j_tpu_torch.distributed import \
            updater_hbm_bytes as port_hbm
        assert port_hbm({"m": torch.zeros(4)}) == {"cpu": 16}
        assert "dl4j_updater_hbm_bytes" in \
            profiler.get_registry().exposition()

    def test_zero_math_bit_exact(self, pool, devices):
        p0, s0 = _jstate(_jnet())
        a = pool.run(rank_train, "gspmd", p0, s0)
        b = pool.run(rank_train, "gspmd", p0, s0, zero_min=0)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x["params"], y["params"])
        from deeplearning4j_tpu.distributed import (GSPMDTrainer,
                                                    ShardedTrainingPlan,
                                                    ZeroPlan)
        ja, jb = _jnet(), _jnet()
        GSPMDTrainer(ja, ShardedTrainingPlan(_jmesh(devices))).fit(
            _jit(), epochs=2)
        GSPMDTrainer(jb, ShardedTrainingPlan(
            _jmesh(devices), zero=ZeroPlan(min_bytes=0))).fit(
            _jit(), epochs=2)
        np.testing.assert_array_equal(np.asarray(ja.params()),
                                      np.asarray(jb.params()))

    def test_gather_opt_state_seam(self, pool):
        out = pool.run(rank_gather, *_jstate(_jnet()))
        full = out[0][1]
        for r, (all_np, m, piece) in enumerate(out):
            assert all_np
            np.testing.assert_array_equal(m, full)
            half = full.shape[0] // WORLD
            np.testing.assert_array_equal(piece,
                                          full[r * half:(r + 1) * half])


class TestZeroCheckpointReshard:
    def test_same_mesh_resume_bit_exact(self, pool, tmp_path):
        for ref, got, step in pool.run(rank_zero_resume, str(tmp_path / "z"),
                                       *_jstate(_jnet())):
            assert step == 4
            np.testing.assert_array_equal(ref, got)

    def test_reshard_to_smaller_mesh_restores_bit_exact(self, pool,
                                                        tmp_path):
        """A checkpoint of ZeRO pieces written by 2 ranks loads at world 1
        (this process): every restored leaf bit-equal to the ranks'
        gathered values, and training goes on."""
        from deeplearning4j_tpu_torch.distributed import GSPMDTrainer, ZeroPlan
        from deeplearning4j_tpu_torch.parallel import checkpoint as ckpt
        d = str(tmp_path / "z2")
        saved_m, saved_w = pool.run(rank_zero_save, d, *_jstate(_jnet()))[0]
        b = _pnet(seed=99)
        tb = GSPMDTrainer(b, _plan(ZeroPlan(min_bytes=0)))
        tb.plan.apply(b)
        restored, step = ckpt.load_sharded(d, {"params": b._params,
                                               "opt": b._opt_state})
        np.testing.assert_array_equal(restored["opt"][0]["W"]["m"].numpy(),
                                      saved_m)
        np.testing.assert_array_equal(restored["params"][0]["W"].numpy(),
                                      saved_w)
        _copy_into(b, restored, step)
        _fit_steps(tb, 2)
        assert np.isfinite(float(b.score()))


# ==================================================== analysis satellites
class TestDistributionAnalysis:
    def _big(self, pkg, upd="adam"):
        C, It, L, U = _mods(pkg)
        u = U.Adam(1e-3) if upd == "adam" else U.Sgd(0.1)
        return (C.Builder().seed(1).updater(u).list()
                .layer(L.DenseLayer(nOut=4096, activation="relu"))
                .layer(L.OutputLayer(nOut=8))
                .setInputType(It.feedForward(4096)).build())

    def test_w109_replicated_optimizer_state(self):
        for pkg in ("jax", "torch"):
            report = self._big(pkg).validate(mesh="data=8")
            w109 = [d for d in report if d.code == "DL4J-W109"]
            assert w109 and "optimizer" in w109[0].message
            assert "DL4J-W109" not in self._big(pkg).validate(
                mesh="data=8", zero=True).codes()
            assert "DL4J-W109" not in self._big(pkg).validate(
                mesh="data=1,model=8").codes()

    def test_w109_quiet_for_stateless_updater(self):
        for pkg in ("jax", "torch"):
            assert "DL4J-W109" not in self._big(pkg, "sgd").validate(
                mesh="data=8").codes()

    def test_e104_counts_zero_sharded_updater_state(self):
        for pkg in ("jax", "torch"):
            ok = self._big(pkg).validate(mesh="data=8", hbm_gb=0.09,
                                         zero=True)
            assert "DL4J-E104" not in ok.codes()
            tight = self._big(pkg).validate(mesh="data=1", hbm_gb=0.09,
                                            zero=True)
            e = [d for d in tight if d.code == "DL4J-E104"]
            assert e and "ZeRO" in e[0].message
            assert "DL4J-E104" not in self._big(pkg).validate(
                mesh="data=8", hbm_gb=0.09).codes()

    def test_collective_estimate_matches_recorded_step(self, pool, devices):
        """The W107 ring model within 2x of one recorded step's all-reduce
        bytes on 2 ranks (the JAX pin reads the compiled HLO's on 2
        devices)."""
        from deeplearning4j_tpu.analysis.distribution import (
            estimate_gradient_collectives as jest)
        from deeplearning4j_tpu.distributed import ShardedTrainingPlan
        from deeplearning4j_tpu.distributed.gspmd import (
            compiled_train_step_hlo, hlo_collective_bytes)
        from deeplearning4j_tpu_torch.analysis.distribution import (
            estimate_gradient_collectives)
        ring = 2.0 * (WORLD - 1) / WORLD
        coll = pool.run(rank_collectives, *_jstate(_jnet()))[0]
        measured = ring * sum(coll.get(k, 0) for k in
                              ("all-reduce", "reduce-scatter", "all-gather"))
        est = sum(estimate_gradient_collectives(
            _conf("torch"), _plan_spec()).values())
        assert measured > 0 and 0.5 <= est / measured <= 2.0
        net = _jnet()
        mesh = _jmesh(devices)
        plan = ShardedTrainingPlan(mesh)
        net.setShardingPlan(plan)
        plan.apply(net)
        x, y = _data(64)
        jcoll = hlo_collective_bytes(compiled_train_step_hlo(net, x, y))
        jm = ring * sum(jcoll.get(k, 0) for k in
                        ("all-reduce", "reduce-scatter", "all-gather"))
        assert 0.5 <= sum(jest(net.conf, mesh.spec()).values()) / jm <= 2.0


def _plan_spec():
    from deeplearning4j_tpu_torch.analysis.distribution import MeshSpec
    return MeshSpec({"data": WORLD, "model": 1, "seq": 1}, devices=WORLD)
