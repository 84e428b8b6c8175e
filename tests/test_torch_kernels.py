"""The port's kernels and ops against the JAX package (CPU).

On the CPU the CUDA kernels' wrappers take their plain PyTorch versions;
those are held here against the Pallas kernels themselves, run under the
Pallas interpreter as tests/test_pallas.py runs them, and against the
JAX generic ops. Inputs come from numpy with a seed.

Tolerances: fp32 layer norm 1e-5 and fp32 flash attention 2e-5 (those of
tests/test_pallas.py: the same fp32 arithmetic summed in another order);
bf16 2e-2 (a few bf16 ulps of values of order one).

The CUDA kernels themselves are held against their plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops import attention as jattn
from deeplearning4j_tpu.ops import normalization as jnorm
from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu_torch.ops import attention as tattn
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import normalization as tnorm
from deeplearning4j_tpu_torch.ops import registry as treg

# the test workers share the CPU: keep torch's intra-op pool small
torch.set_num_threads(2)

LN_TOL = 1e-5
FLASH_TOL = 2e-5
BF16_TOL = 2e-2


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


@pytest.fixture()
def torch_overrides():
    ck.install_platform_overrides()
    try:
        yield
    finally:
        ck.uninstall_platform_overrides()


# ---------------------------------------------------------------- layer norm
class TestLayerNorm:
    @pytest.mark.parametrize("shape", [(64, 256), (16, 768), (8, 1024)])
    def test_plain_matches_pallas_and_generic(self, shape):
        r = _rng(1)
        x = (r.standard_normal(shape) * 2 + 0.5).astype(np.float32)
        g = (r.standard_normal(shape[1]) * 0.5 + 1).astype(np.float32)
        b = (r.standard_normal(shape[1]) * 0.1).astype(np.float32)
        got = ck.layer_norm_plain(_t(x), _t(g), _t(b)).numpy()
        pallas = pk.make_layer_norm_override(interpret=True)
        want_k = np.asarray(pallas(jnp.asarray(x), jnp.asarray(g),
                                   jnp.asarray(b)))
        want_g = np.asarray(jnorm.layer_norm(jnp.asarray(x), jnp.asarray(g),
                                             jnp.asarray(b)))
        np.testing.assert_allclose(got, want_k, rtol=LN_TOL, atol=LN_TOL)
        np.testing.assert_allclose(got, want_g, rtol=LN_TOL, atol=LN_TOL)

    def test_plain_bf16_matches_pallas(self):
        r = _rng(2)
        x = r.standard_normal((32, 256)).astype(np.float32)
        g = (r.standard_normal(256) * 0.5 + 1).astype(np.float32)
        b = (r.standard_normal(256) * 0.1).astype(np.float32)
        got = ck.layer_norm_plain(_t(x, torch.bfloat16), _t(g), _t(b))
        assert got.dtype == torch.bfloat16
        pallas = pk.make_layer_norm_override(interpret=True)
        want = pallas(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g),
                      jnp.asarray(b))
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=BF16_TOL, atol=BF16_TOL)

    @pytest.mark.parametrize("axis", [-1, 1, (1, 2)])
    def test_generic_matches_jax_generic(self, axis):
        r = _rng(3)
        x = (r.standard_normal((2, 5, 12)) * 3 + 1).astype(np.float32)
        g = r.standard_normal(12).astype(np.float32)
        got = tnorm.layer_norm(_t(x), _t(g) if axis == -1 else None,
                               axis=axis, eps=1e-6).numpy()
        want = jnorm.layer_norm(jnp.asarray(x),
                                jnp.asarray(g) if axis == -1 else None,
                                axis=axis, eps=1e-6)
        np.testing.assert_allclose(got, np.asarray(want), rtol=LN_TOL,
                                   atol=LN_TOL)

    def test_override_routes_plain_on_cpu(self, torch_overrides):
        ck.reset_counts()
        x = _t(_rng(4).standard_normal((6, 10)))
        ln = treg.get("layer_norm")
        y = ln(x, torch.ones(10), torch.zeros(10))
        np.testing.assert_allclose(
            y.numpy(), tnorm.layer_norm(x, torch.ones(10),
                                        torch.zeros(10)).numpy(),
            rtol=LN_TOL, atol=LN_TOL)
        ln(x.reshape(2, 3, 10), torch.ones(10), torch.zeros(10))  # 3-D: generic
        ln(x, torch.ones(10), None)                               # no bias
        assert ck.PLAIN_CALLS["layer_norm"] == 1
        assert ck.LAUNCHES["layer_norm"] == 0

    def test_gate_contains_the_jax_gate(self):
        for n in (8, 16, 1000, 4096):
            for d in (128, 256, 768, 1024, 4096):
                for dt, jdt in ((torch.float32, jnp.float32),
                                (torch.bfloat16, jnp.bfloat16)):
                    if pk.supported(jnp.zeros((n, d), jdt)):
                        assert ck.supported(torch.zeros((n, d), dtype=dt))
        assert ck.supported(torch.zeros((3, 33)))           # ragged: wider
        assert not ck.supported(torch.zeros((2, 3, 4)))
        assert not ck.supported(torch.zeros((4, 8), dtype=torch.float16))


# ---------------------------------------------------------- flash attention
def _qkv(seed, B, T, H, D):
    r = _rng(seed)
    return [r.standard_normal((B, T, H, D)).astype(np.float32)
            for _ in range(3)]


def _pallas_flash(q, k, v, causal, dtype):
    B, T, H, D = q.shape
    to_bh = lambda a: jnp.asarray(a, dtype).transpose(0, 2, 1, 3).reshape(
        B * H, T, D)
    o, lse = pk._flash_fwd_pallas(to_bh(q), to_bh(k), to_bh(v),
                                  causal=causal, bq=128, bk=128,
                                  interpret=True)
    o = np.asarray(o, np.float32).reshape(B, H, T, D).transpose(0, 2, 1, 3)
    return o, np.asarray(lse).reshape(B, H, T)


class TestFlashAttention:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("D", [64, 128])
    def test_plain_matches_pallas_fp32(self, causal, D):
        q, k, v = _qkv(5, 2, 256, 2, D)
        o, lse = ck.flash_attention_plain(_t(q), _t(k), _t(v), causal)
        want_o, want_lse = _pallas_flash(q, k, v, causal, jnp.float32)
        np.testing.assert_allclose(o.numpy(), want_o, rtol=FLASH_TOL,
                                   atol=FLASH_TOL)
        np.testing.assert_allclose(lse.numpy(), want_lse, rtol=FLASH_TOL,
                                   atol=FLASH_TOL)

    @pytest.mark.parametrize("causal", [False, True])
    def test_plain_matches_pallas_bf16(self, causal):
        q, k, v = _qkv(6, 2, 128, 2, 64)
        qb, kb, vb = (_t(a, torch.bfloat16) for a in (q, k, v))
        o, lse = ck.flash_attention_plain(qb, kb, vb, causal)
        assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
        want_o, want_lse = _pallas_flash(q, k, v, causal, jnp.bfloat16)
        np.testing.assert_allclose(o.float().numpy(), want_o, rtol=BF16_TOL,
                                   atol=BF16_TOL)
        np.testing.assert_allclose(lse.numpy(), want_lse, rtol=BF16_TOL,
                                   atol=BF16_TOL)

    @pytest.mark.parametrize("causal", [False, True])
    def test_plain_ragged_matches_exact(self, causal):
        # lengths off the kernel's tiles: the ragged k tile is masked
        q, k, v = _qkv(7, 1, 100, 3, 192)
        o, _ = ck.flash_attention_plain(_t(q), _t(k), _t(v), causal)
        want = jattn.dot_product_attention(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), is_causal=causal)
        np.testing.assert_allclose(o.numpy(), np.asarray(want),
                                   rtol=FLASH_TOL, atol=FLASH_TOL)

    def test_masked_call_takes_generic_scan(self, torch_overrides):
        q, k, v = _qkv(8, 2, 128, 2, 64)
        mask = (_rng(9).random((2, 1, 1, 128)) > 0.3).astype(np.float32)
        ck.reset_counts()
        got = tattn.flash_attention(_t(q), _t(k), _t(v), mask=_t(mask))
        assert ck.PLAIN_CALLS["flash_attention"] == 0
        want = jattn._flash_attention_scan(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            mask=jnp.asarray(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FLASH_TOL, atol=FLASH_TOL)
        want_dpa = jattn.dot_product_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            mask=jnp.asarray(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want_dpa),
                                   rtol=FLASH_TOL, atol=FLASH_TOL)

    @pytest.mark.parametrize("causal", [False, True])
    def test_t100_matches_jax_scan(self, torch_overrides, causal):
        q, k, v = _qkv(10, 2, 100, 2, 64)
        ck.reset_counts()
        got = tattn.flash_attention(_t(q), _t(k), _t(v), is_causal=causal)
        assert ck.PLAIN_CALLS["flash_attention"] == 1   # the gate takes T=100
        jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
        want = jattn._flash_attention_scan(jq, jk, jv, is_causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FLASH_TOL, atol=FLASH_TOL)
        want_dpa = jattn.dot_product_attention(jq, jk, jv, is_causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want_dpa),
                                   rtol=FLASH_TOL, atol=FLASH_TOL)

    @pytest.mark.parametrize("block", [32, 512])
    def test_generic_scan_matches_jax_scan(self, block):
        q, k, v = _qkv(11, 2, 100, 2, 16)   # D outside the kernel gate
        mask = (_rng(12).random((2, 2, 100, 100)) > 0.2).astype(np.float32)
        got = tattn._flash_attention_scan(_t(q), _t(k), _t(v), mask=_t(mask),
                                          is_causal=True, block_size=block)
        want = jattn._flash_attention_scan(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            mask=jnp.asarray(mask), is_causal=True, block_size=block)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FLASH_TOL, atol=FLASH_TOL)

    def test_dot_product_attention_matches_jax(self):
        q, k, v = _qkv(13, 2, 24, 3, 8)
        mask = (_rng(14).random((2, 1, 1, 24)) > 0.3).astype(np.float32)
        got = tattn.dot_product_attention(_t(q), _t(k), _t(v), mask=_t(mask),
                                          is_causal=True)
        want = jattn.dot_product_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            mask=jnp.asarray(mask), is_causal=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FLASH_TOL, atol=FLASH_TOL)

    def test_gate_contains_the_jax_gate(self):
        for T in (8, 64, 100, 128, 256, 512):
            for D in (32, 64, 128, 192, 256, 320):
                for dt, jdt in ((torch.float32, jnp.float32),
                                (torch.bfloat16, jnp.bfloat16),
                                (torch.float16, jnp.float16)):
                    jq = jax.ShapeDtypeStruct((2, T, 2, D), jdt)
                    tq = torch.empty((2, T, 2, D), dtype=dt, device="meta")
                    if pk.flash_supported(jq, jq, 256, 256):
                        assert ck.flash_supported(tq, tq), (T, D, dt)
                    if dt == torch.float16 or D not in (64, 128, 192, 256):
                        assert not ck.flash_supported(tq, tq)


# ---------------------------------------------------------------- plumbing
class TestWrappersAndBuild:
    def test_wrappers_raise_off_cpu_without_kernel(self):
        q = torch.empty((1, 8, 1, 64), device="meta")
        with pytest.raises(RuntimeError, match="no kernel"):
            ck.flash_attention_fwd(q, q, q)
        with pytest.raises(RuntimeError, match="no kernel"):
            ck.layer_norm_fwd(torch.empty((4, 8), device="meta"),
                              torch.ones(8), torch.zeros(8))

    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setattr(ck.shutil, "which", lambda _: None)
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.delenv("CUDA_PATH", raising=False)
        monkeypatch.setattr(ck, "BUILD_DIR", tmp_path / "build")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            ck.build()

    def test_library_key_follows_the_source(self):
        p = ck._lib_path("flash_attention")
        assert p.parent == ck.BUILD_DIR and p.name.endswith(".so")
        assert p != ck._lib_path("layer_norm")
        assert p == ck._lib_path("flash_attention")

    def test_registry_semantics(self):
        assert treg.has("layer_norm") and treg.has("flash_attention")
        with pytest.raises(KeyError):
            treg.register_platform_override("no_such_op", lambda: None)
        with pytest.raises(KeyError):
            treg.get("no_such_op")
        sentinel = lambda *a, **k: "override"
        treg.register_platform_override("layer_norm", sentinel)
        try:
            assert treg.get("layer_norm") is sentinel
        finally:
            treg.clear_platform_override("layer_norm")
        assert treg.get("layer_norm") is tnorm.layer_norm

    def test_install_and_uninstall(self):
        ck.install_platform_overrides()
        try:
            assert treg.get("layer_norm") is not tnorm.layer_norm
            assert "flash_attention" in treg._PLATFORM_OVERRIDES
        finally:
            ck.uninstall_platform_overrides()
        assert treg.get("layer_norm") is tnorm.layer_norm
        assert "flash_attention" not in treg._PLATFORM_OVERRIDES
