"""The port's transformer over a mesh (``models.transformer`` with
``mesh=``: the Megatron layout over ``model``, ring attention over
``seq``) against the JAX package's (``tests/test_parallel.py::
TestShardedTransformer``).

The port runs on 2 spawned gloo ranks on the CPU; the JAX functions run
on the same seeded numpy inputs and the same parameters (the JAX
``init_params`` tree, carried over by ``params_from_jax(..., mesh=)``,
which places each rank's pieces) over JAX meshes cut from conftest's 8
CPU devices. The JAX tests' ``data=2 x model=2 x seq=2`` mesh becomes
``model=2`` alone and ``seq=2`` alone (at most 2 ranks), each held
against the JAX function on the same cut mesh. Tolerances are the JAX
tests': ``rtol=2e-3, atol=2e-4``.
"""

import numpy as np
import pytest

from deeplearning4j_tpu_torch.parallel.launch import RankPool

WORLD = 2
RTOL, ATOL = 2e-3, 2e-4
#: the two cuts of the JAX data=2 x model=2 x seq=2 mesh
CUTS = [{"data": 1, "model": 2, "seq": 1}, {"data": 1, "model": 1, "seq": 2}]


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(WORLD, str(tmp_path_factory.mktemp("store")),
                  device="cpu") as p:
        yield p


@pytest.fixture(scope="module")
def devices():
    import jax
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return jax.devices()


def _jcfg(**kw):
    import jax.numpy as jnp
    from deeplearning4j_tpu.models import transformer as jtfm
    return jtfm.TransformerConfig.tiny(dtype=jnp.float32, **kw)


def _jparams(cfg):
    import jax
    from deeplearning4j_tpu.models import transformer as jtfm
    p = jtfm.init_params(cfg, jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(lambda a: np.array(np.asarray(a)), p)


# ------------------------------------------------------- rank functions
def _tcfg(kw):
    import torch
    from deeplearning4j_tpu_torch.models import transformer as tfm
    return tfm.TransformerConfig.tiny(dtype=torch.float32, **kw)


def rank_forward(params, tokens, axes, kw):
    """The global logits of ``forward(..., mesh)`` from this rank's
    pieces, and what this rank holds of ``wqkv`` and ``embed.tok``."""
    import torch
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.parallel import DeviceMesh
    cfg = _tcfg(kw)
    mesh = DeviceMesh.create(**axes)
    p = tfm.params_from_jax(params, cfg, mesh=mesh)
    with torch.no_grad():
        out = tfm.forward(p, torch.from_numpy(tokens), cfg, mesh)
    return (out.numpy(), tuple(p["layers"][0]["wqkv"].shape),
            tuple(p["embed"]["tok"].shape))


def rank_train(params, tokens, targets, mask, axes, kw, steps):
    """``steps`` Adam steps of ``make_train_step(..., mesh)``: the
    losses, the collective bytes of the first step by kind, and the
    params gathered whole after the last."""
    import torch
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.parallel import DeviceMesh, collectives
    from deeplearning4j_tpu_torch.train import updaters
    cfg = _tcfg(kw)
    mesh = DeviceMesh.create(**axes)
    p = tfm.params_from_jax(params, cfg, mesh=mesh)
    up = updaters.Adam(1e-3)
    opt = tfm.init_opt_state(p, up)
    t = torch.zeros((), dtype=torch.int32)
    step = tfm.make_train_step(cfg, up, mesh)
    args = [torch.from_numpy(a) for a in (tokens, targets, mask)]
    losses, calls = [], None
    for i in range(steps):
        with collectives.record() as rec:
            losses.append(float(step(p, opt, t, *args)))
        if i == 0:
            calls = dict(rec.calls)
    whole = tfm.gather_params(p, mesh)
    return losses, calls, {"wo": whole["layers"][0]["wo"].detach().numpy(),
                           "tok": whole["embed"]["tok"].detach().numpy()}


# ---------------------------------------------------------------- tests
class TestShardedTransformer:
    @pytest.mark.parametrize("axes", CUTS, ids=["model2", "seq2"])
    def test_tp_sp_dp_train_step(self, pool, devices, axes):
        """3 Adam steps (lr 1e-3, causal, ring attention) on 4 x 32
        tokens: the losses are finite, fall, and match the JAX step's on
        the same cut mesh; the params after them match too."""
        import jax
        import jax.numpy as jnp
        from deeplearning4j_tpu.models import transformer as jtfm
        from deeplearning4j_tpu.parallel import DeviceMesh as JMesh
        from deeplearning4j_tpu.train import updaters as jup
        kw = dict(use_ring_attention=True, causal=True)
        cfg = _jcfg(**kw)
        params = _jparams(cfg)
        rng = np.random.RandomState(0)
        tokens = rng.randint(0, cfg.vocab_size, (4, 32)).astype(np.int32)
        targets = rng.randint(0, cfg.vocab_size, (4, 32)).astype(np.int32)
        mask = np.ones((4, 32), np.float32)
        jmesh = JMesh.create(**axes, devices=devices[:WORLD])
        with jmesh:
            jp = jax.tree_util.tree_map(
                jax.device_put, jax.tree_util.tree_map(jnp.asarray, params),
                jtfm.param_shardings(cfg, jmesh),
                is_leaf=lambda x: isinstance(x, jax.Array))
            up = jup.Adam(1e-3)
            opt = jtfm.init_opt_state(jp, up)
            step = jtfm.make_train_step(cfg, up, jmesh)
            t = jnp.asarray(0, jnp.int32)
            want = []
            for _ in range(3):
                jp, opt, t, loss = step(jp, opt, t, jnp.asarray(tokens),
                                        jnp.asarray(targets),
                                        jnp.asarray(mask))
                want.append(float(loss))
        out = pool.run(rank_train, params, tokens, targets, mask, axes, kw,
                       3)
        for losses, calls, whole in out:
            assert all(np.isfinite(losses)) and losses[-1] < losses[0]
            np.testing.assert_allclose(losses, want, rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(
                whole["wo"], np.asarray(jp["layers"][0]["wo"]),
                rtol=RTOL, atol=ATOL)
            np.testing.assert_allclose(
                whole["tok"], np.asarray(jp["embed"]["tok"]),
                rtol=RTOL, atol=ATOL)
        calls = out[0][1]
        if axes["model"] == 2:
            # forward: the embedding's and 2 a block (attention, MLP);
            # backward: the same again; then the gradient sum over model
            assert calls["all-reduce"] == 2 * (1 + 2 * cfg.n_layers) + 1
            assert calls["all-gather"] == 1          # the head's logits
        else:
            # a block: k and v one hop forward (one message); backward
            # k, v and dk, dv one hop each, then dk, dv one hop home
            assert calls["collective-permute"] == 4 * cfg.n_layers

    @pytest.mark.parametrize("axes", CUTS, ids=["model2", "seq2"])
    def test_sharded_forward_matches_unsharded(self, pool, devices, axes):
        import jax.numpy as jnp
        from deeplearning4j_tpu.models import transformer as jtfm
        cfg = _jcfg()
        params = _jparams(cfg)
        rng = np.random.RandomState(0)
        tokens = rng.randint(0, cfg.vocab_size, (2, 16)).astype(np.int32)
        ref = np.asarray(jtfm.forward(
            {k: v for k, v in params.items()}, jnp.asarray(tokens), cfg,
            mesh=None))
        out = pool.run(rank_forward, params, tokens, axes, {})
        m = axes["model"]
        for logits, wqkv, tok in out:
            np.testing.assert_allclose(logits, ref, rtol=RTOL, atol=ATOL)
            assert wqkv == (cfg.d_model, 3 * cfg.d_model // m)
            assert tok == (cfg.vocab_size // m, cfg.d_model)


def test_param_shardings_are_the_jax_specs(devices):
    """The Megatron layout leaf by leaf, an untied head and the post-LN
    BERT's extra leaves included."""
    import jax
    import torch
    from deeplearning4j_tpu.models import transformer as jtfm
    from deeplearning4j_tpu.parallel import DeviceMesh as JMesh
    from deeplearning4j_tpu_torch.models import transformer as tfm
    for kw in ({}, {"tie_embeddings": False, "arch": "postln_bert",
                    "type_vocab_size": 2}):
        jcfg = _jcfg(**kw)
        tcfg = tfm.TransformerConfig.tiny(dtype=torch.float32, **kw)
        jm = JMesh.create(data=2, model=4)
        want = jax.tree_util.tree_map(
            lambda s: tuple(s.spec), jtfm.param_shardings(jcfg, jm),
            is_leaf=lambda x: hasattr(x, "spec"))
        got = tfm.param_shardings(tcfg)

        def norm(t):
            if isinstance(t, dict):
                return {k: norm(v) for k, v in t.items()}
            if isinstance(t, list):
                return [norm(v) for v in t]
            return tuple(t)
        assert norm(got) == norm(want)
