"""The port's multi-process pieces held against the JAX package's
``tests/test_multihost.py``: ranks wired by ``initializeDistributed``
(gloo over a file store), per-rank data sharding with global views, the
sharded checkpoint layout (crossing both ways: a JAX-written checkpoint
loads into the port's ranks and the port's into the JAX package), and
the socket and file coordinators across OS processes.

The port's ranks are spawned ``RankPool`` processes on the CPU; the
coordinator workers are fresh interpreters that import only the port's
``distributed`` package. The JAX reference runs on conftest's 8 CPU
devices in this process (the JAX multi-process test's global step is
the same computation on one process's 4-device mesh). Tolerances:
bit-equal for checkpoints; ``rtol=1e-5`` for the global losses of the
hand-written step (fp32 sums in another order).
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.parallel.launch import RankPool

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(2, str(tmp_path_factory.mktemp("store")),
                  device="cpu") as p:
        yield p


def _pieces_of(full, rank, world, dim=0):
    c = full.shape[dim] // world
    idx = [slice(None)] * full.ndim
    idx[dim] = slice(rank * c, (rank + 1) * c)
    return full[tuple(idx)]


# ------------------------------------------------------- rank functions
def rank_train_and_checkpoint(ckpt_dir):
    """The JAX worker's loop in the port's idiom: each rank's half of
    every global batch (ShardedDataSetIterator), a global view of it, a
    hand-written step whose gradient and loss are summed over the data
    group, then the sharded checkpoint written and read back."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.data.dataset import (DataSet,
                                                       ListDataSetIterator)
    from deeplearning4j_tpu_torch.parallel import (DeviceMesh,
                                                   ShardedDataSetIterator,
                                                   distributed_info,
                                                   make_global_view)
    from deeplearning4j_tpu_torch.parallel import checkpoint as ckpt
    from deeplearning4j_tpu_torch.parallel import collectives
    info = distributed_info()
    assert info.process_count == 2
    mesh = DeviceMesh.data_parallel()
    rng = np.random.RandomState(0)
    x = rng.randn(16, 8).astype(np.float32)
    w_true = rng.randn(8, 1).astype(np.float32)
    it = ShardedDataSetIterator(ListDataSetIterator(DataSet(x, x @ w_true),
                                                    batch_size=16))
    assert it.batch() == 8
    params = {"W": torch.zeros((8, 1))}
    group = mesh.group("data")
    losses = []
    for _ in range(12):
        it.reset()
        while it.hasNext():
            ds = it.next()
            gx = make_global_view(ds.features, mesh)
            gy = make_global_view(ds.labels, mesh)
            n = gx._dl4j_placement.global_shape[0]
            w = params["W"].requires_grad_(True)
            part = ((gx @ w - gy) ** 2).sum() / n
            (g,) = torch.autograd.grad(part, w)
            g = collectives.all_reduce(g.clone(), group)
            loss = collectives.all_reduce(part.detach().clone(), group)
            params = {"W": (w - 0.1 * g).detach()}
            losses.append(float(loss))
    ckpt.save_sharded(ckpt_dir, params, step=12)
    restored, step = ckpt.load_sharded(ckpt_dir, params)
    assert step == 12 and torch.equal(restored["W"], params["W"])
    return {"rank": dist.get_rank(), "losses": losses,
            "w": params["W"].numpy()}


def rank_save_tree(d, full):
    """A piece of ``W`` (dim 0) a rank, ``b`` replicated, a Python int."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import checkpoint as ckpt
    from deeplearning4j_tpu_torch.parallel.mesh import (Placement,
                                                        placement_of,
                                                        set_placement)
    r = dist.get_rank()
    p = Placement(full.shape, 0, 2, r)
    w = set_placement(torch.from_numpy(_pieces_of(full, r, 2).copy()), p)
    tree = {"W": w, "b": torch.ones(8), "step_count": 7}
    ckpt.save_sharded(d, tree, step=3)
    restored, step = ckpt.load_sharded(d, tree)
    return (step, restored["W"].numpy(),
            placement_of(restored["W"]).index, restored["b"].numpy(),
            restored["step_count"])


def rank_load(d, shape, how):
    """Load ``W`` of ``shape`` as a piece split over dim 0 or 1, or
    replicated (``how``)."""
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import checkpoint as ckpt
    from deeplearning4j_tpu_torch.parallel.mesh import (Placement,
                                                        set_placement)
    r = dist.get_rank()
    t = torch.zeros(shape)
    if how == "spec":
        from deeplearning4j_tpu_torch.parallel import DeviceMesh
        restored, step = ckpt.load_sharded(
            d, {"W": t}, mesh=DeviceMesh.data_parallel(),
            specs={"W": (None, "data")})
        return restored["W"].numpy(), step
    if how in (0, 1):
        p = Placement(shape, how, 2, r)
        t = set_placement(torch.zeros(tuple(
            s // 2 if d == how else s for d, s in enumerate(shape))), p)
    try:
        restored, step = ckpt.load_sharded(d, {"W": t})
    except FileNotFoundError as e:
        return str(e)
    return restored["W"].numpy(), step


def rank_elastic_socket(d, addr):
    """``ParallelWrapper.fit(elastic=...)`` with the socket coordinator:
    rank 3's device is lost at step 3 (planned on every rank, as the JAX
    test plans its devices); the survivors shrink through the barrier
    over TCP."""
    import os as _os

    import torch.distributed as dist

    from deeplearning4j_tpu_torch.data.dataset import (DataSet,
                                                       ListDataSetIterator)
    from deeplearning4j_tpu_torch.distributed import SocketCoordinator
    from deeplearning4j_tpu_torch.faults import FaultPlan
    from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                    NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import (ElasticConfig,
                                                   ParallelWrapper,
                                                   RankLostError)
    from deeplearning4j_tpu_torch.train import updaters
    from deeplearning4j_tpu_torch.train.resilience import CheckpointConfig
    r = dist.get_rank()
    conf = (NeuralNetConfiguration.Builder().seed(3)
            .updater(updaters.Sgd(0.05)).list()
            .layer(DenseLayer(nOut=16, activation="relu"))
            .layer(OutputLayer(nOut=2, lossFunction="mcxent",
                               activation="softmax"))
            .setInputType(InputType.feedForward(8)).build())
    net = MultiLayerNetwork(conf).init(device="cpu")
    rng = np.random.RandomState(0)
    ds = DataSet(rng.randn(64, 8).astype(np.float32),
                 np.eye(2, dtype=np.float32)[rng.randint(0, 2, 64)])
    coord = SocketCoordinator(addr, participant=f"rank{r}",
                              heartbeat_interval=0.2)
    coord.hello()
    w = ParallelWrapper(net)
    try:
        w.fit(ListDataSetIterator(ds, 8), epochs=1,
              checkpoint=CheckpointConfig(d),
              elastic=ElasticConfig(coordinator=coord),
              faults=FaultPlan(device_loss_at_step=3, lose_devices=[3]))
    except RankLostError:
        _os._exit(0)
    coord.close()
    sh = net._last_shrink
    return (w.mesh.size("data"), net._iteration, float(net.score()),
            (sh["at"], sh["agreed"], sh["restored"], sh["dead"]))


# ================================================= train + checkpoint
@pytest.mark.multihost
def test_two_process_train_and_checkpoint(pool, tmp_path, devices):
    """Two ranks train the global problem (identical losses and params on
    both), equal to the JAX global step on a 4-device mesh within 1e-5
    relative, converge, and write one shard file each and one merged
    manifest."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    d = str(tmp_path / "ckpt")
    res = pool.run(rank_train_and_checkpoint, d)
    assert {r["rank"] for r in res} == {0, 1}
    assert res[0]["losses"] == res[1]["losses"]
    np.testing.assert_array_equal(res[0]["w"], res[1]["w"])
    mesh = Mesh(np.asarray(devices[:4]).reshape(4), ("data",))
    rng = np.random.RandomState(0)
    x = rng.randn(16, 8).astype(np.float32)
    y = x @ rng.randn(8, 1).astype(np.float32)
    gx = jax.device_put(x, NamedSharding(mesh, P("data")))
    gy = jax.device_put(y, NamedSharding(mesh, P("data")))

    @jax.jit
    def step(p, x, y):
        l, g = jax.value_and_grad(
            lambda p: jnp.mean((x @ p["W"] - y) ** 2))(p)
        return jax.tree_util.tree_map(lambda a, b: a - 0.1 * b, p, g), l
    params = {"W": jnp.zeros((8, 1), jnp.float32)}
    ref = []
    for _ in range(12):
        params, l = step(params, gx, gy)
        ref.append(float(l))
    np.testing.assert_allclose(res[0]["losses"], ref, rtol=1e-5)
    assert res[0]["losses"][-1] < res[0]["losses"][0] * 0.1
    files = os.listdir(d)
    assert "manifest.json" in files
    assert "shards_p0.npz" in files and "shards_p1.npz" in files


def test_configured_world_without_coordinator_raises(monkeypatch):
    """The JAX rule kept: a world size above 1 with no coordinator is a
    misconfigured job, never one process training alone."""
    from deeplearning4j_tpu_torch.parallel import init
    monkeypatch.setattr(init, "_initialized", None)
    monkeypatch.delenv("DL4J_TPU_COORDINATOR", raising=False)
    monkeypatch.setenv("DL4J_TPU_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="no coordinator"):
        init.initializeDistributed(device="cpu")
    monkeypatch.delenv("DL4J_TPU_NUM_PROCESSES")
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(RuntimeError, match="no coordinator"):
        init.initializeDistributed(device="cpu")
    assert init._initialized is None


class TestShardedCheckpointMultiRank:
    """The layout on 2 ranks: a piece a rank, a replicated leaf written
    once, a Python scalar with its type; loads assemble, reshard, and
    fail loudly on what they cannot cover; the JAX package reads and
    writes the same files."""

    def test_sharded_params_roundtrip(self, pool, tmp_path, devices):
        import jax
        import jax.numpy as jnp
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        from deeplearning4j_tpu.parallel import checkpoint as jck
        full = np.arange(64, dtype=np.float32).reshape(8, 8)
        for r, (step, w, index, b, sc) in enumerate(
                pool.run(rank_save_tree, str(tmp_path / "ck"), full)):
            assert step == 3 and index == r and sc == 7
            assert isinstance(sc, int)
            np.testing.assert_array_equal(w, _pieces_of(full, r, 2))
            np.testing.assert_array_equal(b, np.ones(8, np.float32))
        mesh = Mesh(np.array(devices).reshape(8), ("data",))
        tree = {"W": jax.device_put(jnp.asarray(full),
                                    NamedSharding(mesh, P("data"))),
                "b": jax.device_put(jnp.ones((8,)),
                                    NamedSharding(mesh, P())),
                "step_count": 7}
        jck.save_sharded(str(tmp_path / "j"), tree, step=3)
        restored, step = jck.load_sharded(str(tmp_path / "j"), tree)
        assert step == 3 and restored["step_count"] == 7
        assert restored["W"].sharding.spec == P("data")

    def test_sharded_save_into_host_tree_assembles_all_shards(
            self, pool, tmp_path):
        """A checkpoint of pieces loaded into a plain numpy tree (here, at
        world 1) is the FULL array, not one piece."""
        from deeplearning4j_tpu_torch.parallel import checkpoint as ckpt
        full = np.arange(64, dtype=np.float32).reshape(8, 8)
        d = str(tmp_path / "ck3")
        pool.run(rank_save_tree, d, full)
        restored, step = ckpt.load_sharded(d, {"W": np.zeros((8, 8),
                                                            np.float32)})
        assert step == 3
        np.testing.assert_array_equal(restored["W"], full)

    def test_topology_change_reshards_on_load(self, pool, tmp_path):
        """Pieces split over dim 0 load whole (a replicated target) and
        split over dim 1 instead (a tagged target, or ``mesh`` and
        ``specs``), each stitched from the saved pieces."""
        rng = np.random.RandomState(3)
        full = rng.randn(8, 8).astype(np.float32)
        d = str(tmp_path / "ck2")
        pool.run(rank_save_tree, d, full)
        for w, _ in pool.run(rank_load, d, (8, 8), None):
            np.testing.assert_array_equal(w, full)
        for r, (w, _) in enumerate(pool.run(rank_load, d, (8, 8), 1)):
            np.testing.assert_array_equal(w, _pieces_of(full, r, 2, dim=1))
        # the same layout declared by a mesh and a spec tuple
        for r, (w, _) in enumerate(pool.run(rank_load, d, (8, 8), "spec")):
            np.testing.assert_array_equal(w, _pieces_of(full, r, 2, dim=1))

    def test_uncoverable_topology_still_fails_loudly(self, pool, tmp_path):
        d = str(tmp_path / "ck4")
        pool.run(rank_save_tree, d, np.zeros((8, 8), np.float32))
        man = os.path.join(d, "manifest.json")
        with open(man) as f:
            manifest = json.load(f)
        manifest["leaves"]["W"]["shards"].pop("0:4;0:8")
        with open(man, "w") as f:
            json.dump(manifest, f)
        for msg in pool.run(rank_load, d, (8, 8), None):
            assert isinstance(msg, str) and "cover only" in msg

    def test_jax_checkpoint_loads_into_port_ranks(self, pool, tmp_path,
                                                  devices):
        """The JAX package's save_sharded from a 4-device mesh (four row
        shards) loads into the port's 2 ranks: each rank's piece (two
        JAX shards stitched) bit-equal, and whole on a replicated
        target."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        from deeplearning4j_tpu.parallel import checkpoint as jck
        rng = np.random.RandomState(7)
        full = rng.randn(8, 4).astype(np.float32)
        mesh = Mesh(np.array(devices[:4]).reshape(4), ("data",))
        d = str(tmp_path / "from_jax")
        jck.save_sharded(d, {"W": jax.device_put(
            jnp.asarray(full), NamedSharding(mesh, P("data")))}, step=5)
        for r, (w, step) in enumerate(pool.run(rank_load, d, (8, 4), 0)):
            assert step == 5
            np.testing.assert_array_equal(w, _pieces_of(full, r, 2))
        for w, _ in pool.run(rank_load, d, (8, 4), None):
            np.testing.assert_array_equal(w, full)

    def test_port_checkpoint_loads_into_jax(self, pool, tmp_path, devices):
        """The port's 2-rank checkpoint loads into the JAX package: whole
        into a host tree, and as 4 row shards on a 4-device mesh, bit-
        equal; the scalar keeps its type."""
        import jax
        import jax.numpy as jnp
        from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
        from deeplearning4j_tpu.parallel import checkpoint as jck
        full = np.arange(64, dtype=np.float32).reshape(8, 8) / 7.0
        d = str(tmp_path / "from_port")
        pool.run(rank_save_tree, d, full)
        host, step = jck.load_sharded(d, {"W": np.zeros((8, 8), np.float32),
                                          "b": np.zeros(8, np.float32),
                                          "step_count": 0})
        assert step == 3 and host["step_count"] == 7
        np.testing.assert_array_equal(np.asarray(host["W"]), full)
        np.testing.assert_array_equal(np.asarray(host["b"]), np.ones(8))
        mesh = Mesh(np.array(devices[:4]).reshape(4), ("data",))
        tgt = jax.device_put(jnp.zeros((8, 8)),
                             NamedSharding(mesh, P("data")))
        sharded, _ = jck.load_sharded(d, {"W": tgt})
        np.testing.assert_array_equal(np.asarray(sharded["W"]), full)
        assert len(sharded["W"].sharding.device_set) == 4


# ===================================================== socket coordinator
_BARRIER_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ["DL4J_REPO"])
from deeplearning4j_tpu_torch.distributed import SocketCoordinator

rank = os.environ["COORD_RANK"]
steps = json.loads(os.environ["COORD_STEPS"])
c = SocketCoordinator(os.environ["COORD_ADDR"], participant=f"p{rank}",
                      heartbeat_interval=0.2)
agreed = [c.resume_barrier(f"p{rank}", s, timeout=20.0) for s in steps]
c.close()
print("RESULT " + json.dumps({"rank": rank, "agreed": agreed}))
"""

_DEAD_PEER_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ["DL4J_REPO"])
from deeplearning4j_tpu_torch.distributed import (DeadPeerError,
                                                  SocketCoordinator)

c = SocketCoordinator(os.environ["COORD_ADDR"], participant="alive",
                      heartbeat_interval=0.2)
try:
    c.resume_barrier("alive", 5, timeout=20.0)
    out = {"error": None}
except DeadPeerError as e:
    out = {"error": "dead_peer", "peer": e.peer,
           "generation": e.generation}
c.close()
print("RESULT " + json.dumps(out))
"""

_FILE_WORKER = r"""
import json, os, sys
sys.path.insert(0, os.environ["DL4J_REPO"])
from deeplearning4j_tpu_torch.distributed import FileCoordinator
c = FileCoordinator(os.environ["COORD_DIR"], participants=2,
                    participant=os.environ["COORD_RANK"])
agreed = c.resume_barrier(os.environ["COORD_RANK"],
                          int(os.environ["COORD_STEP"]), timeout=20.0)
c.close()
print("RESULT " + json.dumps({"agreed": agreed}))
"""


def _spawn(script_path, extra_env):
    env = dict(os.environ)
    env["DL4J_REPO"] = _REPO
    env.update(extra_env)
    return subprocess.Popen([sys.executable, script_path],
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, env=env, text=True)


def _result(proc, timeout=90):
    out, _ = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, f"worker failed:\n{out[-2000:]}"
    line = [ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


def _script(tmp_path, text, name="worker.py"):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        f.write(text)
    return path


@pytest.mark.multihost
class TestSocketCoordinatorMultiProcess:
    def test_two_process_barrier_agrees_with_in_process(self, tmp_path):
        """2 OS processes over the port's socket coordinator agree on the
        steps the JAX package's in-process coordinator agrees on for the
        same arrivals (min a round; barriers reusable)."""
        from deeplearning4j_tpu.parallel.elastic import InProcessCoordinator
        from deeplearning4j_tpu_torch.distributed import \
            SocketCoordinatorServer
        steps = {"0": [12, 20], "1": [7, 25]}
        ref = InProcessCoordinator(2)
        ref_agreed = {r: [] for r in steps}

        def arrive(rank):
            for s in steps[rank]:
                ref_agreed[rank].append(
                    ref.resume_barrier(f"p{rank}", s, timeout=10.0))
        ts = [threading.Thread(target=arrive, args=(r,)) for r in steps]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        worker = _script(tmp_path, _BARRIER_WORKER)
        with SocketCoordinatorServer(participants=2) as srv:
            procs = [_spawn(worker, {"COORD_RANK": r,
                                     "COORD_ADDR": srv.address,
                                     "COORD_STEPS": json.dumps(steps[r])})
                     for r in steps]
            results = {res["rank"]: res["agreed"]
                       for res in (_result(p) for p in procs)}
        assert results == ref_agreed == {"0": [7, 20], "1": [7, 20]}

    def test_dead_peer_surfaces_structured_error(self, tmp_path):
        from deeplearning4j_tpu_torch.distributed import (
            SocketCoordinator, SocketCoordinatorServer)
        worker = _script(tmp_path, _DEAD_PEER_WORKER)
        with SocketCoordinatorServer(participants=2,
                                     heartbeat_timeout=0.6) as srv:
            doomed = SocketCoordinator(srv.address, participant="doomed",
                                       heartbeat_interval=0.2)
            doomed.hello()
            doomed.close()
            res = _result(_spawn(worker, {"COORD_ADDR": srv.address}))
        assert res == {"error": "dead_peer", "peer": "doomed",
                       "generation": 0}

    def test_coord_peer_death_fault_kind(self):
        """A planned peer death fires the dead-peer path while the peer
        keeps heartbeating, in the port's server as in the JAX one."""
        from deeplearning4j_tpu.distributed import (
            DeadPeerError as JDead, SocketCoordinator as JClient,
            SocketCoordinatorServer as JServer)
        from deeplearning4j_tpu.faults import FaultPlan as JPlan
        from deeplearning4j_tpu_torch.distributed import (
            DeadPeerError, SocketCoordinator, SocketCoordinatorServer)
        from deeplearning4j_tpu_torch.faults import FaultPlan
        peers = {}
        for Server, Client, Dead, Plan in (
                (JServer, JClient, JDead, JPlan),
                (SocketCoordinatorServer, SocketCoordinator, DeadPeerError,
                 FaultPlan)):
            plan = Plan(coord_peer_death={"participant": "zombie",
                                          "generation": 0})
            with Server(participants=2, heartbeat_timeout=0.5,
                        plan=plan) as srv:
                zombie = Client(srv.address, participant="zombie",
                                heartbeat_interval=0.1)
                zombie.hello()
                alive = Client(srv.address, participant="alive")
                with pytest.raises(Dead) as ei:
                    alive.resume_barrier("alive", 3, timeout=10.0)
                peers[Server.__module__] = (ei.value.peer,
                                            ei.value.generation)
                zombie.close()
                alive.close()
        assert set(peers.values()) == {("zombie", 0)}

    def test_barrier_timeout_when_peer_never_registers(self):
        from deeplearning4j_tpu_torch.distributed import (
            SocketCoordinator, SocketCoordinatorServer)
        with SocketCoordinatorServer(participants=2) as srv:
            c = SocketCoordinator(srv.address, participant="alone")
            with pytest.raises(TimeoutError, match="1/2 participants"):
                c.resume_barrier("alone", 4, timeout=0.4)
            c.close()


@pytest.mark.multihost
class TestFileCoordinator:
    def test_two_process_file_barrier(self, tmp_path):
        script = _script(tmp_path, _FILE_WORKER, "fworker.py")
        d = str(tmp_path / "coord")
        procs = [_spawn(script, {"COORD_DIR": d, "COORD_RANK": f"p{i}",
                                 "COORD_STEP": str(s)})
                 for i, s in enumerate((9, 4))]
        assert [_result(p)["agreed"] for p in procs] == [4, 4]

    def test_file_dead_peer(self, tmp_path):
        from deeplearning4j_tpu_torch.distributed import (DeadPeerError,
                                                          FileCoordinator)
        d = str(tmp_path / "coord2")
        dead = FileCoordinator(d, participants=2, participant="dead",
                               heartbeat_timeout=0.5,
                               heartbeat_interval=0.1)
        dead._closed.set()          # a crash: the heartbeats just stop
        dead._hb_thread.join(timeout=2.0)
        alive = FileCoordinator(d, participants=2, participant="alive",
                                heartbeat_timeout=0.5)
        with pytest.raises(DeadPeerError) as ei:
            alive.resume_barrier("alive", 3, timeout=10.0)
        assert ei.value.peer == "dead"
        alive.close()

    def test_reused_directory_ignores_previous_runs_files(self, tmp_path):
        import time as _time
        from deeplearning4j_tpu_torch.distributed import FileCoordinator
        d = str(tmp_path / "coord3")
        os.makedirs(d)
        past = _time.time() - 60
        for fname in ("gen0_ghost.json", "hb_ghost"):
            path = os.path.join(d, fname)
            with open(path, "w") as f:
                f.write('{"step": 1}')
            os.utime(path, (past, past))
        results = {}

        def arrive(name, step):
            c = FileCoordinator(d, participants=2, participant=name,
                                heartbeat_timeout=5.0)
            results[name] = c.resume_barrier(name, step, timeout=10.0)
            c.close()
        ts = [threading.Thread(target=arrive, args=(n, s))
              for n, s in (("a", 9), ("b", 6))]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert results == {"a": 6, "b": 6}

    def test_quick_restart_ignores_previous_runs_result(self, tmp_path):
        from deeplearning4j_tpu_torch.distributed import FileCoordinator
        d = str(tmp_path / "coord5")
        os.makedirs(d)
        with open(os.path.join(d, "result_gen0.json"), "w") as f:
            f.write('{"step": 999}')
        c = FileCoordinator(d, participants=2, participant="a")
        with pytest.raises(TimeoutError):
            c.resume_barrier("a", 5, timeout=1.0)
        c.close()

    def test_staggered_construction_still_agrees(self, tmp_path):
        import time as _time
        from deeplearning4j_tpu_torch.distributed import FileCoordinator
        d = str(tmp_path / "coord4")
        results = {}
        early = FileCoordinator(d, participants=2, participant="early",
                                heartbeat_interval=0.2)

        def arrive_early():
            results["early"] = early.resume_barrier("early", 11,
                                                    timeout=20.0)
        t = threading.Thread(target=arrive_early)
        t.start()
        _time.sleep(1.5)
        late = FileCoordinator(d, participants=2, participant="late",
                               heartbeat_interval=0.2)
        results["late"] = late.resume_barrier("late", 4, timeout=20.0)
        t.join()
        early.close()
        late.close()
        assert results == {"early": 4, "late": 4}


@pytest.mark.multihost
class TestElasticOverSocketCoordinator:
    def test_fit_elastic_shrinks_through_the_socket_barrier(self, tmp_path):
        """4 ranks; rank 3's device is lost at step 3: its process exits,
        the 3 survivors retire it from the TCP coordinator, agree on the
        step, form a group of 3 and finish all 8 steps (the JAX test: 8
        devices, 2 lost, 6 left)."""
        from deeplearning4j_tpu_torch.distributed import \
            SocketCoordinatorServer
        with SocketCoordinatorServer(participants=4) as srv, \
                RankPool(4, str(tmp_path / "store"),
                         device="cpu") as pool4:
            res = pool4.run(rank_elastic_socket, str(tmp_path / "ck"),
                            srv.address, allow_exit=[3])
        assert res[3] is None
        for data, it, score, shrink in res[:3]:
            assert data == 3 and it == 8 and np.isfinite(score)
            assert shrink == (3, 3, 3, ["rank3"])
