"""The port's transformer training step against the JAX package's (CPU).

JAX ``init_params`` weights are carried over with ``params_from_jax``;
the same tokens, targets and masks (numpy, seeded) go through both
packages' ``loss_fn`` and ``make_train_step``. The JAX side runs its
generic ops (its layer-norm override fails under ``jit`` on jax 0.9.0,
so no JAX override is installed); the port runs its LN and flash
overrides, which on the CPU take the kernels' plain versions forward
and the composed backwards of ``ops.cuda_kernels``.

Tolerances:
- fp32 loss (a forward value): 1e-5.
- fp32 params after 1 and 3 Adam steps at lr 1e-4: 2e-4, the reference's
  gradient tolerance. Adam's first steps are about ``lr * sign(g)``, so
  even a gradient within rounding of 0 moves a param by at most
  ``2 * lr`` = 2e-4 between the packages.
- Adam's ``m`` and ``v``: 2e-4 of each tensor's largest magnitude (they
  are linear and quadratic in the gradients, held to 2e-4).
- bf16 (params in bf16, no fp32 masters): each of 3 losses within 0.01
  of the JAX loss (the forward test's bound; bf16 keeps 8 bits and the
  two packages round activations at other places).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.train import updaters as tupd

# the test workers share the CPU: keep torch's intra-op pool small
torch.set_num_threads(2)

LOSS_TOL = 1e-5
PARAM_TOL = 2e-4
BF16_LOSS_TOL = 0.01
LR = 1e-4
B, T = 2, 64


def _tiny(jdtype=jnp.float32, **kw):
    base = dict(d_model=128, n_heads=2, n_layers=2, d_ff=256,
                vocab_size=512, max_len=64)
    base.update(kw)
    jcfg = jtr.TransformerConfig.tiny(dtype=jdtype, **base)
    tdtype = torch.float32 if jdtype == jnp.float32 else torch.bfloat16
    tcfg = ttr.TransformerConfig.tiny(dtype=tdtype, **base)
    return jcfg, tcfg


def _batch(seed=0, vocab=512, masked=True):
    r = np.random.RandomState(seed)
    tokens = r.randint(0, vocab, (B, T)).astype(np.int32)
    targets = r.randint(0, vocab, (B, T)).astype(np.int32)
    mask = (r.rand(B, T) < 0.3).astype(np.float32) if masked \
        else np.ones((B, T), np.float32)
    return tokens, targets, mask


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _paths(tree):
    """{path: numpy leaf} of a JAX or a port tree."""
    out = {}

    def walk(t, p):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], p + (k,))
        elif isinstance(t, (list, tuple)):
            for i, v in enumerate(t):
                walk(v, p + (i,))
        else:
            a = t.detach().float().numpy() if isinstance(t, torch.Tensor) \
                else np.asarray(t, np.float32)
            out[p] = a
    walk(tree, ())
    return out


@pytest.fixture()
def overrides():
    ck.install_platform_overrides()
    try:
        yield
    finally:
        ck.uninstall_platform_overrides()


def _torch_in(tokens, targets, mask):
    return (torch.from_numpy(tokens).long(), torch.from_numpy(targets).long(),
            torch.from_numpy(mask))


class TestLossFn:
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("flash", [False, True])
    def test_matches_jax(self, overrides, flash, masked):
        jcfg, tcfg = _tiny(use_flash_attention=flash)
        jp = jtr.init_params(jcfg, jax.random.PRNGKey(1))
        tokens, targets, mask = _batch(2)
        tp = ttr.params_from_jax(_np_tree(jp), tcfg, device="cpu")
        want = float(jtr.loss_fn(jp, jnp.asarray(tokens), jnp.asarray(targets),
                                 jcfg, target_mask=jnp.asarray(mask)
                                 if masked else None))
        tok, tgt, m = _torch_in(tokens, targets, mask)
        with torch.no_grad():
            got = float(ttr.loss_fn(tp, tok, tgt, tcfg,
                                    target_mask=m if masked else None))
        assert got == pytest.approx(want, rel=LOSS_TOL, abs=LOSS_TOL)

    def test_empty_mask_divides_by_one(self):
        _, tcfg = _tiny()
        tp = ttr.init_params(tcfg, seed=0, device="cpu")
        tok, tgt, m = _torch_in(*_batch(3))
        with torch.no_grad():
            got = ttr.loss_fn(tp, tok, tgt, tcfg,
                              target_mask=torch.zeros_like(m))
        assert float(got) == 0.0


class TestTrainStep:
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("flash", [False, True])
    def test_fp32_params_and_adam_state_after_1_and_3_steps(
            self, overrides, flash, masked):
        jcfg, tcfg = _tiny(use_flash_attention=flash)
        jp = jtr.init_params(jcfg, jax.random.PRNGKey(0))
        tp = ttr.params_from_jax(_np_tree(jp), tcfg, device="cpu")
        jstep = jtr.make_train_step(jcfg, jupd.Adam(LR))
        jopt = jtr.init_opt_state(jp, jupd.Adam(LR))
        tstep = ttr.make_train_step(tcfg, tupd.Adam(LR))
        topt = ttr.init_opt_state(tp, tupd.Adam(LR))
        jt = jnp.asarray(0, jnp.int32)
        tt = torch.zeros((), dtype=torch.int32)
        ck.reset_counts()
        for i in range(3):
            tokens, targets, mask = _batch(10 + i, masked=masked)
            jp, jopt, jt, jloss = jstep(jp, jopt, jt, jnp.asarray(tokens),
                                        jnp.asarray(targets),
                                        jnp.asarray(mask))
            tloss = tstep(tp, topt, tt, *_torch_in(tokens, targets, mask))
            assert float(tloss) == pytest.approx(float(jloss), rel=LOSS_TOL,
                                                 abs=LOSS_TOL)
            assert int(tt) == int(jt) == i + 1
            if i in (0, 2):
                want, got = _paths(jp), _paths(tp)
                assert got.keys() == want.keys()
                for p in want:
                    np.testing.assert_allclose(got[p], want[p], rtol=0,
                                               atol=PARAM_TOL,
                                               err_msg=f"param {p}")
                wo, go = _paths(jopt), _paths(topt)
                assert go.keys() == wo.keys()
                for p in wo:
                    scale = max(float(np.abs(wo[p]).max()), 1e-30)
                    np.testing.assert_allclose(
                        go[p], wo[p], rtol=0, atol=PARAM_TOL * scale,
                        err_msg=f"opt state {p} after step {i + 1}")
        # the wrappers ran: 2 flash (if on) and 5 LN calls a forward
        assert ck.PLAIN_CALLS["layer_norm"] == 3 * 5
        assert ck.PLAIN_CALLS["flash_attention"] == (3 * 2 if flash else 0)

    def test_updates_in_place(self, overrides):
        _, tcfg = _tiny()
        tp = ttr.init_params(tcfg, seed=0, device="cpu")
        topt = ttr.init_opt_state(tp, tupd.Adam(LR))
        tt = torch.zeros((), dtype=torch.int32)
        ptrs = [t.data_ptr() for t in _leaves(tp) + _leaves(topt) + [tt]]
        before = tp["layers"][0]["wqkv"].detach().clone()
        ttr.make_train_step(tcfg, tupd.Adam(LR))(
            tp, topt, tt, *_torch_in(*_batch(4)))
        assert [t.data_ptr() for t in _leaves(tp) + _leaves(topt) + [tt]] \
            == ptrs
        assert not torch.equal(tp["layers"][0]["wqkv"], before)
        assert int(tt) == 1

    def test_bf16_losses_within_bound(self, overrides):
        jcfg, tcfg = _tiny(jnp.bfloat16, use_flash_attention=True)
        jp = jtr.init_params(jcfg, jax.random.PRNGKey(0))
        tp = ttr.params_from_jax(_np_tree(jp), tcfg, device="cpu")
        jstep = jtr.make_train_step(jcfg, jupd.Adam(1e-3))
        jopt = jtr.init_opt_state(jp, jupd.Adam(1e-3))
        tstep = ttr.make_train_step(tcfg, tupd.Adam(1e-3))
        topt = ttr.init_opt_state(tp, tupd.Adam(1e-3))
        jt = jnp.asarray(0, jnp.int32)
        tt = torch.zeros((), dtype=torch.int32)
        tokens, targets, mask = _batch(5, masked=False)
        for _ in range(3):
            jp, jopt, jt, jloss = jstep(jp, jopt, jt, jnp.asarray(tokens),
                                        jnp.asarray(targets),
                                        jnp.asarray(mask))
            tloss = tstep(tp, topt, tt, *_torch_in(tokens, targets, mask))
            assert abs(float(tloss) - float(jloss)) < BF16_LOSS_TOL
        # bf16 params stay bf16; the updater state is fp32
        assert all(p.dtype == torch.bfloat16 for p in _leaves(tp))
        assert all(s.dtype == torch.float32 for s in _leaves(topt))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


class TestInitOptState:
    def test_tree_matches_jax(self):
        jcfg, tcfg = _tiny(jnp.bfloat16)
        jp = jtr.init_params(jcfg, jax.random.PRNGKey(0))
        tp = ttr.params_from_jax(_np_tree(jp), tcfg, device="cpu")
        want = jtr.init_opt_state(jax.tree_util.tree_map(
            lambda p: p.astype(jnp.float32), jp), jupd.Adam(LR))
        got = ttr.init_opt_state(tp, tupd.Adam(LR))
        w, g = _paths(want), _paths(got)
        assert w.keys() == g.keys()
        for p in w:
            assert g[p].shape == w[p].shape and not g[p].any()
        assert all(s.dtype == torch.float32 for s in _leaves(got))
        assert ttr.init_opt_state(tp, tupd.Sgd(0.1))["embed"]["tok"] == {}
