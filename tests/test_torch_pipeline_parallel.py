"""The port's GPipe schedule (``deeplearning4j_tpu_torch.parallel.
pipeline``) against the JAX package's (``tests/test_pipeline_parallel.
py``): pipelined execution matches single-device execution — the loss
and the parameters after one train step.

The port runs on 2 spawned gloo ranks on the CPU over
``DeviceMesh.from_axes({"data": d, "pipe": p})``; the JAX functions run
on the same seeded numpy inputs and the same parameters (the JAX
``init_params`` tree) over the JAX test's meshes. Cuts to 2 ranks: the
``data=2 x pipe=4`` mesh becomes ``data=1 x pipe=2`` (n_micro 4 kept),
and the validation case's ``1 x 8`` becomes ``1 x 2`` with 1
microbatch. Tolerances are the JAX tests': the loss ``rtol=2e-5``, the
params after a step ``rtol=1e-4, atol=1e-5``.

The JAX train-step test holds the params after one pipelined Adam step
against the single device's; here they are held after an Sgd step, and
under Adam the losses of two steps (the second one after the update)
are. Adam's first step is ``lr * g / (|g| + eps)``: for the few weights
whose gradient is within a few eps of zero, a reordered sum (the
microbatches' gradients added up, or another package's kernels) moves
the update by a visible share of ``lr`` — 1 weight in 32,768 here, by
1.2e-5 between the port's own pipelined and unpipelined steps — while
the Sgd update is linear in the gradient and shows any fault in it.
"""

import numpy as np
import pytest

from deeplearning4j_tpu_torch.parallel.launch import RankPool

WORLD = 2


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(WORLD, str(tmp_path_factory.mktemp("store")),
                  device="cpu") as p:
        yield p


@pytest.fixture(scope="module")
def devices8():
    import jax
    ds = jax.devices()
    if len(ds) < 8:
        pytest.skip("needs 8 virtual devices")
    return ds


def _setup(n_layers=4):
    """The JAX test's config, params (as numpy) and batch."""
    import jax
    import jax.numpy as jnp
    from deeplearning4j_tpu.models import transformer as jtfm
    cfg = jtfm.TransformerConfig.tiny(dtype=jnp.float32, causal=True,
                                      n_layers=n_layers)
    params = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    B, T = 8, 16
    tokens = rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)
    targets = rng.randint(0, cfg.vocab_size, (B, T)).astype(np.int32)
    host = jax.tree_util.tree_map(lambda a: np.array(np.asarray(a)), params)
    return cfg, host, tokens, targets


# ------------------------------------------------------- rank functions
def _port(params, n_layers, axes):
    import torch
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.parallel import DeviceMesh
    from deeplearning4j_tpu_torch.parallel import pipeline as pp
    cfg = tfm.TransformerConfig.tiny(dtype=torch.float32, causal=True,
                                     n_layers=n_layers)
    mesh = DeviceMesh.from_axes(axes)
    whole = pp.to_pipeline_params(tfm.params_from_jax(params, cfg,
                                                      device="cpu"))
    return cfg, mesh, pp.shard_pipeline_params(whole, cfg, mesh)


def rank_pipeline_loss(params, tokens, targets, n_layers, axes, n_micro):
    import torch
    from deeplearning4j_tpu_torch.parallel import pipeline as pp
    cfg, mesh, p = _port(params, n_layers, axes)
    with torch.no_grad():
        return float(pp.pipeline_loss_fn(p, torch.from_numpy(tokens),
                                         torch.from_numpy(targets), cfg,
                                         mesh, n_micro))


def rank_pipeline_step(params, tokens, targets, axes, n_micro,
                       updater="Adam", steps=1):
    """``steps`` steps (lr 1e-2): the losses, the params gathered whole
    (in the pipeline layout), what this stage holds of the blocks and the
    clock."""
    import torch
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.parallel import pipeline as pp
    from deeplearning4j_tpu_torch.train import updaters
    cfg, mesh, p = _port(params, 4, axes)
    up = getattr(updaters, updater)(1e-2)
    opt = tfm.init_opt_state(p, up)
    t = torch.zeros((), dtype=torch.int32)
    step = pp.make_pipeline_train_step(cfg, up, mesh, n_micro)
    losses = [float(step(p, opt, t, torch.from_numpy(tokens),
                         torch.from_numpy(targets))) for _ in range(steps)]
    whole = tfm._tree_apply(p, lambda a: mesh.gather(a).detach().numpy())
    return losses, whole, tuple(p["blocks"]["wqkv"].shape), int(t)


def rank_depth_check():
    import torch
    from deeplearning4j_tpu_torch.parallel import DeviceMesh
    from deeplearning4j_tpu_torch.parallel import pipeline as pp
    mesh = DeviceMesh.from_axes({"data": 1, "pipe": WORLD})
    try:
        pp.pipeline_apply(lambda p, a: a, torch.zeros((8, 1)),
                          torch.zeros((1, 1, 4)), mesh)
    except ValueError as e:
        return str(e)
    return None


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k], prefix + (k,))]
    return [(prefix, tree)]


# ---------------------------------------------------------------- tests
class TestPipelineParallel:
    def test_pipeline_loss_matches_single_device(self, pool, devices8):
        import jax
        import jax.numpy as jnp
        from deeplearning4j_tpu.models import transformer as jtfm
        cfg, params, tokens, targets = _setup()
        want = float(jtfm.loss_fn(
            jax.tree_util.tree_map(jnp.asarray, params),
            jnp.asarray(tokens), jnp.asarray(targets), cfg))
        got = pool.run(rank_pipeline_loss, params, tokens, targets, 4,
                       {"data": 1, "pipe": WORLD}, 4)
        for g in got:
            np.testing.assert_allclose(g, want, rtol=2e-5)

    @pytest.mark.parametrize("updater", ["Sgd", "Adam"])
    def test_pipeline_train_step_matches_single_device(self, pool,
                                                       devices8, updater):
        """The port's 2-stage pipeline (4 microbatches) against the JAX
        package's 1-stage pipeline on one device (1 microbatch), the
        JAX test's reference: the loss, and the params after an Sgd
        step; under Adam the losses of two steps (the module note)."""
        import jax
        import jax.numpy as jnp
        from deeplearning4j_tpu.parallel import DeviceMesh as JMesh
        from deeplearning4j_tpu.parallel import pipeline as jpp
        from deeplearning4j_tpu.train import updaters as jup
        cfg, params, tokens, targets = _setup()
        steps = 2 if updater == "Adam" else 1
        updater_ = getattr(jup, updater)(1e-2)
        mesh = JMesh(jax.sharding.Mesh(
            np.asarray(devices8[:1]).reshape(1, 1), ("data", "pipe")))
        jp = jpp.to_pipeline_params(jax.tree_util.tree_map(jnp.asarray,
                                                           params))
        opt = jax.tree_util.tree_map(
            lambda p: updater_.init_state(p.astype(jnp.float32)), jp,
            is_leaf=lambda x: isinstance(x, jax.Array))
        step = jpp.make_pipeline_train_step(cfg, updater_, mesh, 1)
        t = jnp.asarray(0, jnp.int32)
        want_losses = []
        with mesh.mesh:
            for _ in range(steps):
                jp, opt, t, loss = step(jp, opt, t, jnp.asarray(tokens),
                                        jnp.asarray(targets))
                want_losses.append(float(loss))
        want = {path: np.asarray(v) for path, v in _flat(
            jax.tree_util.tree_map(np.asarray, jp))}
        out = pool.run(rank_pipeline_step, params, tokens, targets,
                       {"data": 1, "pipe": WORLD}, 4, updater, steps)
        for losses, whole, local, t in out:
            np.testing.assert_allclose(losses, want_losses, rtol=2e-5)
            assert local[0] == cfg.n_layers // WORLD and t == steps
            if updater == "Adam":
                continue
            got = dict(_flat(whole))
            assert set(got) == set(want)
            for path, v in want.items():
                np.testing.assert_allclose(got[path], v, rtol=1e-4,
                                           atol=1e-5, err_msg=str(path))

    def test_pipeline_vs_unpipelined_forward_math(self, pool, devices8):
        """The stage math (the stacked blocks) equals the layer loop of
        ``models.transformer`` (JAX: 2 layers on a 1 x 2 mesh, 2
        microbatches; the same here)."""
        import jax
        import jax.numpy as jnp
        from deeplearning4j_tpu.models import transformer as jtfm
        cfg, params, tokens, targets = _setup(n_layers=2)
        want = float(jtfm.loss_fn(
            jax.tree_util.tree_map(jnp.asarray, params),
            jnp.asarray(tokens), jnp.asarray(targets), cfg))
        got = pool.run(rank_pipeline_loss, params, tokens, targets, 2,
                       {"data": 1, "pipe": WORLD}, 2)
        for g in got:
            np.testing.assert_allclose(g, want, rtol=2e-5)

    def test_microbatch_roundtrip_and_validation(self, pool, devices8):
        import torch
        from deeplearning4j_tpu.parallel import pipeline as jpp
        from deeplearning4j_tpu_torch.parallel import pipeline as pp
        x = torch.arange(24.0).reshape(8, 3)
        m = pp.microbatch(x, 4)
        assert tuple(m.shape) == tuple(jpp.microbatch(x.numpy(), 4).shape) \
            == (4, 2, 3)
        np.testing.assert_allclose(pp.unmicrobatch(m).numpy(), x.numpy())
        with pytest.raises(ValueError, match="not divisible"):
            pp.microbatch(x, 3)
        for msg in pool.run(rank_depth_check):
            assert msg is not None and "pipeline depth" in msg
