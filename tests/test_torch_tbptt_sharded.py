"""Truncated BPTT under a sharding plan: the port's data-parallel window
step on two gloo ranks against the JAX package's fit on the whole
(padded) batch, on the CPU.

The net is two LSTM(16) and an RnnOutputLayer over V=11 symbols, T=24
steps in windows of L=8 (three updates a batch), Adam 1e-3 with
``clip_value`` 5.0 (TextGenerationLSTM's settings, cut narrow). The JAX
net's init gives both packages their weights (``params_from_jax``); the
characters are one-hot rows from numpy with a seed.

- The JAX side runs ``GSPMDTrainer(net, ShardedTrainingPlan(mesh)).fit``
  and ``setShardingPlan`` + ``fit`` on a data=2 mesh cut from conftest's
  CPU devices: every 3-D batch goes to ``fitTBPTT`` whole, and the
  trainer pads an odd batch first with zero-weight rows
  (``pad_to_data_axis``). The RnnOutputLayer divides its loss by the
  batch's rows, padding included, so on an odd batch the padded fit is
  not the unpadded one; the port pads in ``fit`` under any plan and
  matches the padded fit.
- The port side runs the same entry points in two ``RankPool`` ranks
  (``device="cpu"``): each rank trains its rows through the window step,
  the loss weighed by the rank's share of the rows and the gradients
  summed over the data group; the carried (h, c) stays on its rank.
- ``ParallelWrapper``: the JAX wrapper at K=1 trains each batch as one
  whole-sequence step (``_fit_one``, no windows); the port's runs
  truncated BPTT, as DL4J's ParallelWrapper and both packages'
  GSPMDTrainer do. Both sides are pinned.

Tolerance: window losses, params, Adam moments (atol scaled to each
moment's largest magnitude) and the final carry within rtol = atol =
1e-5 (fp32; two ranks sum the gradients in another order than one
device). A data=1 plan is bit-equal to the plain ``fitTBPTT``, and a
two-rank resume from a checkpoint at a batch boundary is bit-equal to
the two-rank fit that was not stopped.
"""

import numpy as np
import pytest

from deeplearning4j_tpu_torch.parallel.launch import RankPool

WORLD = 2
TOL = 1e-5
V, H, T, L = 11, 16, 24, 8
WINDOWS = T // L
#: ZeRO over every moment tensor (the default leaves those under 64 KiB,
#: all of this narrow net's, whole)
ZERO = {"min_bytes": 0}
#: FSDP style: the recurrent weights [16, 64] split over data at rest
FSDP = {r"/RW$": ("data", None)}


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(WORLD, str(tmp_path_factory.mktemp("store")),
                  device="cpu") as p:
        yield p


def _conf(pkg: str):
    import importlib
    base = "deeplearning4j_tpu" if pkg == "jax" else "deeplearning4j_tpu_torch"
    cfg = importlib.import_module(f"{base}.nn.config")
    M = importlib.import_module(f"{base}.nn.layers")
    U = importlib.import_module(f"{base}.train.updaters")
    b = (cfg.NeuralNetConfiguration.Builder().seed(5).updater(U.Adam(1e-3))
         .weightInit("xavier").gradientNormalization("clip_value", 5.0)
         .list())
    b.layer(M.LSTM(nOut=H))
    b.layer(M.LSTM(nOut=H))
    b.layer(M.RnnOutputLayer(nOut=V, lossFunction="mcxent",
                             activation="softmax"))
    b.setInputType(cfg.InputType.recurrent(V, T))
    b.backpropType("tbptt", L)
    return b.build()


def _chars(seed: int, n: int, masked: bool = False):
    """One-hot characters [n, V, T], the next ones as labels, and with
    ``masked`` a ragged label mask [n, T]."""
    r = np.random.default_rng(seed)
    idx = r.integers(0, V, (n, T + 1))
    eye = np.eye(V, dtype=np.float32)
    x = eye[idx[:, :-1]].transpose(0, 2, 1)
    y = eye[idx[:, 1:]].transpose(0, 2, 1)
    m = None
    if masked:
        m = np.ones((n, T), np.float32)
        m[0, T - 5:] = 0.0
        m[n - 1, 3:] = 0.0      # rank 1's last row: most windows empty
    return x, y, m


def _batches(n: int, count: int = 2, masked: bool = False):
    return [_chars(seed, n, masked) for seed in range(1, count + 1)]


def _recorder(net, fit_window: str):
    """Wrap ``net``'s window step to keep each window's loss and the
    carry it hands on (the port's ``_fit_window``; the JAX package's
    ``_fit_one_tbptt``)."""
    losses, carry = [], []
    inner = getattr(net, fit_window)

    def port_window(*a):
        out = inner(*a)
        losses.append(float(out[0]))
        carry[:] = [np.array(c.detach().cpu().numpy()) for c in out[1:]]
        return out

    def jax_window(ds, seg):
        seg = inner(ds, seg)
        losses.append(float(np.asarray(net._score)))
        carry[:] = [np.array(np.asarray(a)) for s in seg if s is not None
                    for a in (s if isinstance(s, tuple) else (s,))]
        return seg
    setattr(net, fit_window,
            port_window if fit_window == "_fit_window" else jax_window)
    return losses, carry


# ------------------------------------------------------- rank functions
def _port_state(net) -> dict:
    """The whole params and Adam moments (gathered where the plan split
    them) as numpy, a dict a layer."""
    from deeplearning4j_tpu_torch.distributed import gather_opt_state
    plan = net._sharding_plan
    return {"params": [{k: v.detach().numpy() for k, v in p.items()}
                       for p in net._whole_params()],
            "opt": gather_opt_state(net._opt_state,
                                    None if plan is None else plan.group),
            "iteration": net._iteration}


def rank_fit(params, states, batches, entry: str, zero: bool = False,
             ckpt: str = None, preempt_at: int = None, rules=None):
    """One rank's fit of ``batches`` through ``entry`` (``"gspmd"``,
    ``"plan"``: setShardingPlan + fit, ``"wrapper"``), under a checkpoint
    session over an iterator of the same batches when ``ckpt`` is given
    (``preempt_at``: the step a planned preemption stops it); ``rules``
    split params over the data axis at rest. Returns the window losses, this rank's final
    carry, the state and the updater bytes on this rank."""
    from deeplearning4j_tpu_torch.data.dataset import (DataSet,
                                                       ListDataSetIterator)
    from deeplearning4j_tpu_torch.distributed import (GSPMDTrainer,
                                                      ShardedTrainingPlan,
                                                      updater_hbm_bytes)
    from deeplearning4j_tpu_torch.faults import FaultPlan
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import DeviceMesh, ParallelWrapper
    from deeplearning4j_tpu_torch.train.resilience import CheckpointConfig
    net = MultiLayerNetwork(_conf("torch")).params_from_jax(
        params, states, device="cpu")
    losses, carry = _recorder(net, "_fit_window")
    data = [DataSet(x, y, None, m) for x, y, m in batches]
    kw = {}
    if ckpt is not None:
        # an iterator: a resumed session seeks its cursor
        data = ListDataSetIterator(DataSet(
            np.concatenate([b[0] for b in batches]),
            np.concatenate([b[1] for b in batches])), len(batches[0][0]))
        kw["checkpoint"] = CheckpointConfig(ckpt, every_steps=2,
                                            keep_last=99,
                                            resume=preempt_at is None)
        if preempt_at is not None:
            kw["faults"] = FaultPlan(preempt_at_step=preempt_at)
    plan = ShardedTrainingPlan(DeviceMesh.data_parallel(), rules=rules,
                               zero=ZERO if zero else None)
    if entry == "gspmd":
        GSPMDTrainer(net, plan).fit(data, **kw)
    elif entry == "plan":
        net.setShardingPlan(plan)
        net.fit(data, **kw)
    else:
        ParallelWrapper(net).fit(data, **kw)
    out = _port_state(net)
    out.update(losses=losses, carry=carry,
               hbm=sum(updater_hbm_bytes(net._opt_state).values()),
               preempted=bool(getattr(net, "_preempted", False)))
    return out


def rank_warmup(batch: int, entry: str):
    """The window steps a rank's ``warmup`` made under a data=2 plan (on
    the CPU a dispatch is made but nothing is captured): their label-mask
    flags."""
    from deeplearning4j_tpu_torch.distributed import (GSPMDTrainer,
                                                      ShardedTrainingPlan)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import DeviceMesh, ParallelWrapper
    net = MultiLayerNetwork(_conf("torch")).init(device="cpu")
    shapes = [((batch, V, T), (batch, V, T))]
    if entry == "gspmd":
        GSPMDTrainer(net, ShardedTrainingPlan(
            DeviceMesh.data_parallel())).warmup(shapes)
    else:
        ParallelWrapper(net).warmup(shapes)
    return sorted(key[1] for key in net._step_cache if key[0] == "tbptt")


# ------------------------------------------------------------ the JAX side
def _jax_net():
    from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
    j = JMLN(_conf("jax"))
    j.init()
    return j


def _host(tree):
    import jax
    return jax.tree_util.tree_map(lambda a: np.array(np.asarray(a)), tree)


def _jax_fit(devices, batches, entry: str, zero: bool = False,
             rules=None):
    """The JAX net fitted through ``entry`` (``"gspmd"``, ``"plan"``,
    ``"wrapper"``, ``"plain"``: ``fitTBPTT`` a batch, no plan) on a
    data=2 mesh; returns (net, initial params, initial states, window
    losses, final carry)."""
    from deeplearning4j_tpu.data.dataset import DataSet
    from deeplearning4j_tpu.distributed.gspmd import (GSPMDTrainer,
                                                      ShardedTrainingPlan)
    from deeplearning4j_tpu.parallel import DeviceMesh, ParallelWrapper
    from deeplearning4j_tpu.data.dataset import ListDataSetIterator
    j = _jax_net()
    p0, s0 = _host(j._params), _host(j._states)
    losses, carry = _recorder(j, "_fit_one_tbptt")
    data = [DataSet(x, y, None, m) for x, y, m in batches]
    mesh = DeviceMesh.create(data=WORLD, devices=devices[:WORLD])
    if entry == "gspmd":
        GSPMDTrainer(j, ShardedTrainingPlan(
            mesh, rules=rules, zero=ZERO if zero else None)).fit(data)
    elif entry == "plan":
        j.setShardingPlan(ShardedTrainingPlan(mesh))
        j.fit(data)
    elif entry == "wrapper":
        it = ListDataSetIterator(data[0], int(data[0].features.shape[0]))
        ParallelWrapper(j, mesh=mesh).fit(it)
    else:
        for ds in data:
            j.fitTBPTT(ds, L)
    return j, p0, s0, losses, carry


def _close(got, want, what: str, tol: float = TOL):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _assert_matches_jax(j, outs, losses, carry, windows: int):
    """Every rank's window losses, params and Adam moments against the
    JAX net's, and the ranks' carries, joined by rows, against the JAX
    final carry."""
    for r, out in enumerate(outs):
        assert out["iteration"] == j._iteration == windows
        assert len(out["losses"]) == windows
        _close(out["losses"], losses, f"rank {r} window losses")
        for i, p in enumerate(j._params):
            for k, want in p.items():
                _close(out["params"][i][k], np.asarray(want),
                       f"rank {r} param {i}.{k}")
                for s, ref in j._opt_state[i][k].items():
                    ref = np.asarray(ref)
                    scale = max(float(np.abs(ref).max()), 1e-30)
                    np.testing.assert_allclose(
                        out["opt"][i][k][s], ref, rtol=TOL, atol=TOL * scale,
                        err_msg=f"rank {r} moment {i}.{k}.{s}")
    joined = [np.concatenate([o["carry"][c] for o in outs])
              for c in range(len(carry))]
    assert len(joined) == len(carry) == 4           # (h, c) of two LSTMs
    for c, (got, want) in enumerate(zip(joined, carry)):
        _close(got, want, f"carry {c}")


# ================================================================ tests
@pytest.mark.parametrize("zero,rules", [(False, None), (True, None),
                                        (False, FSDP)])
def test_gspmd_trainer_matches_jax(pool, devices, zero, rules):
    """GSPMDTrainer.fit at data=2 (ZeRO off and on; the recurrent weights
    split over the data axis at rest, gathered whole for each window),
    two batches of B=6: six windows on each rank equal the JAX trainer's
    at 1e-5; under ZeRO each rank keeps about half of the updater's bytes
    (the output bias's 11 entries do not split)."""
    batches = _batches(6)
    j, p0, s0, losses, carry = _jax_fit(devices, batches, "gspmd", zero,
                                        rules)
    outs = pool.run(rank_fit, p0, s0, batches, "gspmd", zero, rules=rules)
    _assert_matches_jax(j, outs, losses, carry, 2 * WINDOWS)
    if zero:
        whole = pool.run(rank_fit, p0, s0, batches[:1], "gspmd", False)
        for out in outs:
            assert 0.45 <= out["hbm"] / whole[0]["hbm"] <= 0.55


def test_set_sharding_plan_fit_matches_jax(pool, devices):
    """``setShardingPlan`` + ``fit`` at data=2: the JAX fit sends every
    batch whole to ``fitTBPTT``; the port's ranks train their rows."""
    batches = _batches(6)
    j, p0, s0, losses, carry = _jax_fit(devices, batches, "plan")
    outs = pool.run(rank_fit, p0, s0, batches, "plan")
    _assert_matches_jax(j, outs, losses, carry, 2 * WINDOWS)


def test_odd_batch_pads_with_zero_weight_rows(pool, devices):
    """B=5 over two ranks: the batch pads to 6 with a zero-weight row
    (rank 1 holds it), the windows take the masked signature, and both
    port entry points equal the JAX trainer's padded fit. The JAX
    ``setShardingPlan`` + ``fit`` does not pad: its fit is the unpadded
    one, which the RnnOutputLayer's division by the rows sets apart."""
    batches = _batches(5)
    j, p0, s0, losses, carry = _jax_fit(devices, batches, "gspmd")
    for entry in ("gspmd", "plan"):
        outs = pool.run(rank_fit, p0, s0, batches, entry)
        _assert_matches_jax(j, outs, losses, carry, 2 * WINDOWS)
    unpadded, _, _, plain_losses, _ = _jax_fit(devices, batches, "plain")
    jplan = _jax_fit(devices, batches, "plan")[0]
    for a, b in zip(_host(jplan._params), _host(unpadded._params)):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    # the first window starts from the same params: the padded loss is
    # the unpadded one times 5/6
    np.testing.assert_allclose(losses[0], plain_losses[0] * 5 / 6,
                               rtol=TOL)


def test_label_mask_matches_jax(pool, devices):
    """A ragged label mask (rank 1's last row active in the first window
    only): each window weighs a rank's loss by its active rows."""
    batches = _batches(6, masked=True)
    j, p0, s0, losses, carry = _jax_fit(devices, batches, "gspmd")
    outs = pool.run(rank_fit, p0, s0, batches, "gspmd")
    _assert_matches_jax(j, outs, losses, carry, 2 * WINDOWS)


def test_parallel_wrapper_runs_tbptt_where_jax_runs_one_step(pool, devices):
    """The pin of the two wrappers. The JAX ParallelWrapper at K=1 calls
    ``_fit_one`` on the batch: one whole-sequence step, equal to the
    plain step on the batch. The port's ParallelWrapper runs the windows:
    three steps, equal to the JAX ``fitTBPTT``."""
    from deeplearning4j_tpu.data.dataset import DataSet
    batches = _batches(6, count=1)
    jw = _jax_fit(devices, batches, "wrapper")[0]
    one = _jax_net()
    x, y, _ = batches[0]
    one._fit_one(DataSet(x, y))
    assert jw._iteration == one._iteration == 1
    for a, b in zip(_host(jw._params), _host(one._params)):
        for k in a:
            _close(a[k], b[k], f"JAX wrapper param {k}")
    j, p0, s0, losses, carry = _jax_fit(devices, batches, "plain")
    outs = pool.run(rank_fit, p0, s0, batches, "wrapper")
    _assert_matches_jax(j, outs, losses, carry, WINDOWS)


def test_resume_at_a_batch_boundary(pool, devices, tmp_path):
    """Two ranks checkpointing every 2 steps and preempted after the
    second batch: data rank 0 wrote the checkpoints, on batch boundaries
    only (one batch's windows are one recovery unit); the resumed fit is
    bit-equal to the two-rank fit that was not stopped and equals the
    JAX fit at 1e-5."""
    batches = _batches(6, count=3)
    j, p0, s0, losses, carry = _jax_fit(devices, batches, "plain")
    straight = pool.run(rank_fit, p0, s0, batches, "gspmd")
    ckpt = str(tmp_path / "ckpt")
    pre = pool.run(rank_fit, p0, s0, batches, "gspmd", False, ckpt,
                   2 * WINDOWS)
    assert all(o["preempted"] and o["iteration"] == 2 * WINDOWS
               for o in pre)
    from deeplearning4j_tpu_torch.train.resilience import (CheckpointConfig,
                                                           CheckpointManager)
    steps = [s for s, _ in CheckpointManager(
        CheckpointConfig(ckpt)).checkpoints()]
    assert steps and all(s % WINDOWS == 0 for s in steps)
    resumed = pool.run(rank_fit, p0, s0, batches, "gspmd", False, ckpt)
    for a, b in zip(resumed, straight):
        assert a["iteration"] == b["iteration"] == 3 * WINDOWS
        for i, p in enumerate(a["params"]):
            for k, v in p.items():
                np.testing.assert_array_equal(v, b["params"][i][k])
                for s, m in a["opt"][i][k].items():
                    np.testing.assert_array_equal(m, b["opt"][i][k][s])
        assert a["losses"] == b["losses"][-len(a["losses"]):]
    _assert_matches_jax(j, straight, losses, carry, 3 * WINDOWS)


def test_data_one_plan_is_bit_equal_to_plain_fit():
    """A data=1 plan (one rank, no group) through GSPMDTrainer with ZeRO
    and through setShardingPlan + fit: window losses, params, moments and
    the carry bit-equal to the plain ``fitTBPTT``."""
    import torch

    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.distributed import (GSPMDTrainer,
                                                      ShardedTrainingPlan)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import DeviceMesh
    j = _jax_net()
    p0, s0 = _host(j._params), _host(j._states)
    batches = [DataSet(x, y, None, m) for x, y, m in _batches(4)]

    def fit(how):
        net = MultiLayerNetwork(_conf("torch")).params_from_jax(
            p0, s0, device="cpu")
        rec = _recorder(net, "_fit_window")
        plan = ShardedTrainingPlan(DeviceMesh.data_parallel(),
                                   zero=how == "gspmd")
        if how == "plain":
            for ds in batches:
                net.fitTBPTT(ds, L)
        elif how == "gspmd":
            GSPMDTrainer(net, plan).fit(batches)
        else:
            net.setShardingPlan(plan)
            net.fit(batches)
        return net, rec
    ref, (ref_losses, ref_carry) = fit("plain")
    for how in ("gspmd", "plan"):
        net, (losses, carry) = fit(how)
        assert losses == ref_losses and len(losses) == 2 * WINDOWS
        for a, b in zip(carry, ref_carry):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(net._dispatch_state(), ref._dispatch_state()):
            assert torch.equal(a, b)


@pytest.mark.parametrize("entry", ["gspmd", "wrapper"])
def test_warmup_makes_the_masked_window_step_of_a_padded_batch(pool, entry):
    """``warmup`` of a batch that pads (B=5 over two ranks) makes the
    window step that ``fit`` runs on it, the masked one, beside the plain
    one; a batch that splits evenly makes the plain one only."""
    assert pool.run(rank_warmup, 5, entry) == [[False, True]] * WORLD
    assert pool.run(rank_warmup, 6, entry) == [[False]] * WORLD


def test_data_one_resume_is_bit_exact(tmp_path):
    """Under a data=1 plan, a fit with checkpoints every 2 steps,
    preempted after the second batch, resumes bit-exact: the checkpoints
    land on batch boundaries only, and the resumed state equals the plain
    ``fit`` that was not stopped."""
    import torch

    from deeplearning4j_tpu_torch.data.dataset import (DataSet,
                                                       ListDataSetIterator)
    from deeplearning4j_tpu_torch.distributed import (GSPMDTrainer,
                                                      ShardedTrainingPlan)
    from deeplearning4j_tpu_torch.faults import FaultPlan
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import DeviceMesh
    from deeplearning4j_tpu_torch.train.resilience import (CheckpointConfig,
                                                           CheckpointManager)
    j = _jax_net()
    p0, s0 = _host(j._params), _host(j._states)
    batches = _batches(4, count=3)

    def data():
        return ListDataSetIterator(DataSet(
            np.concatenate([b[0] for b in batches]),
            np.concatenate([b[1] for b in batches])), 4)

    def net():
        return MultiLayerNetwork(_conf("torch")).params_from_jax(
            p0, s0, device="cpu")
    straight = net()
    straight.fit(data())
    d = str(tmp_path / "ckpt")
    pre = net()
    GSPMDTrainer(pre, ShardedTrainingPlan(DeviceMesh.data_parallel())).fit(
        data(), checkpoint=CheckpointConfig(d, every_steps=2, keep_last=99),
        faults=FaultPlan(preempt_at_step=2 * WINDOWS))
    assert pre._preempted and pre._iteration == 2 * WINDOWS
    steps = [s for s, _ in CheckpointManager(
        CheckpointConfig(d)).checkpoints()]
    assert steps and all(s % WINDOWS == 0 for s in steps)
    resumed = net()
    GSPMDTrainer(resumed, ShardedTrainingPlan(
        DeviceMesh.data_parallel())).fit(
        data(), checkpoint=CheckpointConfig(d, resume=True))
    assert resumed._iteration == straight._iteration == 3 * WINDOWS
    for a, b in zip(resumed._dispatch_state(), straight._dispatch_state()):
        assert torch.equal(a, b)


def test_elastic_fit_refuses_truncated_bptt(tmp_path):
    """``ParallelWrapper.fit(elastic=)`` steps each batch whole; on a
    truncated-BPTT net it raises instead of training whole sequences."""
    from deeplearning4j_tpu_torch.data.dataset import (DataSet,
                                                       ListDataSetIterator)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import ParallelWrapper
    from deeplearning4j_tpu_torch.train.resilience import CheckpointConfig
    net = MultiLayerNetwork(_conf("torch")).init(device="cpu")
    x, y, _ = _chars(1, 4)
    with pytest.raises(NotImplementedError, match="truncated BPTT"):
        ParallelWrapper(net).fit(ListDataSetIterator(DataSet(x, y), 4),
                                 checkpoint=CheckpointConfig(
                                     str(tmp_path / "c")),
                                 elastic=True)
    assert net._iteration == 0
