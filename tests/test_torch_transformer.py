"""The port's transformer against the JAX package's (CPU).

JAX ``init_params`` weights are carried over with ``params_from_jax``;
the same tokens (numpy, seeded) go through both ``forward``s. With flash
attention on, the JAX side runs the Pallas kernels under the interpreter
(``install_platform_overrides(interpret=True)``) and the port runs its
overrides, which take the kernels' plain versions on the CPU.

Tolerances: fp32 logits 1e-4 (the same fp32 arithmetic through two
layers, summed in another order). bf16: every logit within 0.05 of the
JAX logit and the mean cross-entropy within 0.01 — bf16 keeps 8
significant bits, the logits here are of order 0.3, and the two
frameworks round activations at different points (e.g. a bias add fused
or not), so single logits may differ by a few ulps.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.models import transformer as jtr
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck

# the test workers share the CPU: keep torch's intra-op pool small
torch.set_num_threads(2)

FP32_TOL = 1e-4
BF16_LOGIT_TOL = 0.05
BF16_LOSS_TOL = 0.01
T, B = 128, 2


def _tiny(jdtype=jnp.float32, **kw):
    base = dict(d_model=128, n_heads=2, n_layers=2, d_ff=256,
                vocab_size=1024, max_len=128)
    base.update(kw)
    jcfg = jtr.TransformerConfig.tiny(dtype=jdtype, **base)
    tdtype = torch.float32 if jdtype == jnp.float32 else torch.bfloat16
    tcfg = ttr.TransformerConfig.tiny(dtype=tdtype, **base)
    return jcfg, tcfg


def _tokens(seed=0, vocab=1024):
    return np.random.default_rng(seed).integers(0, vocab, (B, T),
                                                dtype=np.int32)


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture()
def overrides():
    pk.install_platform_overrides(interpret=True)
    ck.install_platform_overrides()
    try:
        yield
    finally:
        pk.uninstall_platform_overrides()
        ck.uninstall_platform_overrides()


def _both(jcfg, tcfg, tokens, seed=0):
    jp = jtr.init_params(jcfg, jax.random.PRNGKey(seed))
    want = np.asarray(jtr.forward(jp, jnp.asarray(tokens), jcfg))
    tp = ttr.params_from_jax(_np_tree(jp), tcfg, device="cpu")
    with torch.inference_mode():
        got = ttr.forward(tp, torch.from_numpy(tokens).long(), tcfg)
    return got.numpy(), want


class TestForwardParity:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("flash", [False, True])
    def test_preln_fp32(self, overrides, flash, causal):
        jcfg, tcfg = _tiny(use_flash_attention=flash, causal=causal)
        ck.reset_counts()
        got, want = _both(jcfg, tcfg, _tokens(1))
        assert got.shape == (B, T, 1024) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)
        # the port routes every LayerNorm (2 per block + final) through
        # the registry, and attention through the kernel when flash is on
        assert ck.PLAIN_CALLS["layer_norm"] == 2 * 2 + 1
        assert ck.PLAIN_CALLS["flash_attention"] == (2 if flash else 0)

    @pytest.mark.parametrize("flash", [False, True])
    def test_postln_bert_fp32(self, overrides, flash):
        jcfg, tcfg = _tiny(use_flash_attention=flash, arch="postln_bert",
                           type_vocab_size=2, layer_norm_eps=1e-12)
        got, want = _both(jcfg, tcfg, _tokens(2))
        np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)

    def test_encode_with_token_types_and_mask(self):
        jcfg, tcfg = _tiny(arch="postln_bert", type_vocab_size=2,
                           layer_norm_eps=1e-12)
        jp = jtr.init_params(jcfg, jax.random.PRNGKey(3))
        tp = ttr.params_from_jax(_np_tree(jp), tcfg, device="cpu")
        tok = _tokens(3)
        tt = np.random.default_rng(4).integers(0, 2, (B, T), dtype=np.int32)
        mask = np.ones((B, T), np.float32)
        mask[1, 100:] = 0
        want = jtr.encode(jp, jnp.asarray(tok), jcfg,
                          token_type_ids=jnp.asarray(tt),
                          attn_mask=jnp.asarray(mask))
        got = ttr.encode(tp, torch.from_numpy(tok).long(), tcfg,
                         token_type_ids=torch.from_numpy(tt).long(),
                         attn_mask=torch.from_numpy(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FP32_TOL, atol=FP32_TOL)

    def test_preln_bf16_within_bound(self, overrides):
        jcfg, tcfg = _tiny(jnp.bfloat16, use_flash_attention=True)
        tok = _tokens(5)
        got, want = _both(jcfg, tcfg, tok)
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= BF16_LOGIT_TOL
        targets = np.random.default_rng(6).integers(0, 1024, (B, T))

        def xent(logits):
            z = logits - logits.max(-1, keepdims=True)
            logp = z - np.log(np.exp(z).sum(-1, keepdims=True))
            return -np.take_along_axis(logp, targets[..., None], -1).mean()
        assert abs(xent(got) - xent(want)) <= BF16_LOSS_TOL


class TestParams:
    def test_init_params_tree_matches_jax(self):
        for kw in ({}, dict(arch="postln_bert", type_vocab_size=2),
                   dict(tie_embeddings=False)):
            jcfg, tcfg = _tiny(**kw)
            jp = jtr.init_params(jcfg, jax.random.PRNGKey(0))
            tp = ttr.init_params(tcfg, seed=0, device="cpu")
            jl, jdef = jax.tree_util.tree_flatten(jp)
            tl, tdef = jax.tree_util.tree_flatten(tp)
            assert str(jdef) == str(tdef)
            assert [tuple(a.shape) for a in jl] == [tuple(t.shape)
                                                    for t in tl]
            w = tp["layers"][0]["wqkv"]
            assert abs(float(w.std()) - 0.02) < 2e-3

    def test_bf16_transplant_is_exact(self):
        jcfg, tcfg = _tiny(jnp.bfloat16)
        jp = jtr.init_params(jcfg, jax.random.PRNGKey(7))
        tp = ttr.params_from_jax(_np_tree(jp), tcfg, device="cpu")
        a = np.asarray(jp["layers"][1]["w1"]).astype(np.float32)
        b = tp["layers"][1]["w1"]
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(b.float().numpy(), a)

    def test_lm_logits_and_module_surface(self):
        jcfg, tcfg = _tiny()
        jlm = jtr.TransformerLM(jcfg, seed=0)
        tlm = ttr.TransformerLM(
            tcfg, device="cpu",
            params=ttr.params_from_jax(_np_tree(jlm.params), tcfg, "cpu"))
        tok = _tokens(8)
        np.testing.assert_allclose(tlm.logits(tok).numpy(),
                                   np.asarray(jlm.logits(tok)),
                                   rtol=FP32_TOL, atol=FP32_TOL)
        assert tlm.n_params() == jlm.n_params()
        assert all(not p.requires_grad for p in tlm.parameters())
        assert "tree.layers.0.wqkv" in tlm.state_dict()

    def test_bert_base_config(self):
        cfg = ttr.TransformerConfig.bert_base(use_flash_attention=True)
        assert (cfg.vocab_size, cfg.d_model, cfg.n_heads, cfg.n_layers,
                cfg.d_ff, cfg.max_len) == (30522, 768, 12, 12, 3072, 512)
        assert cfg.dtype == torch.bfloat16 and cfg.arch == "preln"
