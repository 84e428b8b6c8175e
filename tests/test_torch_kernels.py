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


def _tf32(a):
    """a rounded to TF32 (10 mantissa bits): to nearest on the low 13
    bits, ties away from zero, as ``cvt.rna.tf32.f32``."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_rz(a):
    """a cut to TF32 (its low 13 bits dropped), as the tensor core reads
    an fp32 operand."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_matmul(a, b, products):
    """a @ b as the 3xTF32 route's ``mma.sync`` products give it: each
    operand split into big = tf32(x) and small = x - big (which the
    tensor core cuts to TF32), then a_small.b_big + a_big.b_small +
    a_big.b_big summed in fp32, the small terms first (``products=3``);
    ``products=1`` keeps a_big.b_big."""
    ab, bb = _tf32(a), _tf32(b)
    if products == 1:
        return ab @ bb
    a_s, b_s = _tf32_rz(a - ab), _tf32_rz(b - bb)
    return (a_s @ bb + ab @ b_s) + ab @ bb


def _tf32x3_flash(q, k, v, causal, products=3):
    """The 3xTF32 route's arithmetic in numpy fp32 (k tiles of
    ``flash_k_tile``, the kernel's online softmax, both products through
    :func:`_tf32_matmul`) over q, k, v [B, T, H, D] -> (o [B, T, H, D],
    lse [B, H, T])."""
    B, T, H, D = q.shape
    bk = ck.flash_k_tile(D, torch.float32)
    scale = np.float32(1.0 / np.sqrt(D))
    qf, kf, vf = (np.ascontiguousarray(a.transpose(0, 2, 1, 3), np.float32)
                  for a in (q, k, v))
    rows = np.arange(T)[:, None]
    m = np.full((B, H, T), -np.inf, np.float32)
    l = np.zeros((B, H, T), np.float32)
    acc = np.zeros((B, H, T, D), np.float32)
    with np.errstate(invalid="ignore"):
        for k0 in range(0, T, bk):
            kb, vb = kf[:, :, k0:k0 + bk], vf[:, :, k0:k0 + bk]
            s = _tf32_matmul(qf, kb.transpose(0, 1, 3, 2), products) * scale
            if causal:
                s = np.where(k0 + np.arange(kb.shape[2])[None, :] > rows,
                             np.float32(-np.inf), s)
            m_new = np.maximum(m, s.max(axis=-1))
            m_use = np.where(m_new == -np.inf, np.float32(0), m_new)
            alpha = np.exp(m - m_use)
            p = np.exp(s - m_use[..., None])
            l = l * alpha + p.sum(axis=-1)
            acc = acc * alpha[..., None] + _tf32_matmul(p, vb, products)
            m = m_new
    lc = np.maximum(l, np.float32(1e-30))
    return (acc / lc[..., None]).transpose(0, 2, 1, 3), m + np.log(lc)


class TestFlashAttention:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("D", [64, 128, 192, 256])
    def test_tf32x3_route_matches_pallas_fp32(self, causal, D):
        # the route's three TF32 products a product meet the fp32 route's
        # tolerance against the Pallas kernel at every D
        q, k, v = _qkv(16, 2, 256, 2, D)
        o, lse = _tf32x3_flash(q, k, v, causal)
        want_o, want_lse = _pallas_flash(q, k, v, causal, jnp.float32)
        np.testing.assert_allclose(o, want_o, rtol=FLASH_TOL, atol=FLASH_TOL)
        np.testing.assert_allclose(lse, want_lse, rtol=FLASH_TOL,
                                   atol=FLASH_TOL)

    @pytest.mark.parametrize("causal", [False, True])
    def test_one_tf32_product_misses_the_fp32_tolerance(self, causal):
        # why the route takes three products: one keeps 11 bits of each
        # operand, and both o and lse leave the fp32 tolerance
        q, k, v = _qkv(16, 2, 256, 2, 64)
        o, lse = _tf32x3_flash(q, k, v, causal, products=1)
        want_o, want_lse = _pallas_flash(q, k, v, causal, jnp.float32)
        assert np.abs(o - want_o).max() > 10 * FLASH_TOL
        assert np.abs(lse - want_lse).max() > 10 * FLASH_TOL

    def test_tf32_rounding_is_to_nearest_ties_away(self):
        one = np.float32(1.0)
        ulp = np.float32(2.0 ** -10)     # TF32's spacing at 1
        x = np.array([one + ulp / 4, one + ulp / 2, one + 3 * ulp / 4,
                      -(one + ulp / 2), one + ulp + ulp / 2], np.float32)
        np.testing.assert_array_equal(
            _tf32(x), np.array([one, one + ulp, one + ulp, -(one + ulp),
                                one + 2 * ulp], np.float32))
        r = _rng(17).standard_normal(1000).astype(np.float32)
        big = _tf32(r)
        assert not (big.view(np.uint32) & 0x1FFF).any()
        np.testing.assert_array_less(np.abs(r - big - _tf32_rz(r - big)),
                                     np.abs(r) * 2.0 ** -20)

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
    @pytest.mark.parametrize("D", [64, 128])
    def test_plain_tensor_core_tile_matches_pallas_bf16(self, causal, D):
        # the plain version at the k tile the tensor-core route takes for
        # bf16 (P rounds to bf16 at that tile's running max)
        assert ck.flash_k_tile(D, torch.bfloat16) == 64
        q, k, v = _qkv(15, 2, 256, 2, D)
        qb, kb, vb = (_t(a, torch.bfloat16) for a in (q, k, v))
        o, lse = ck.flash_attention_plain(qb, kb, vb, causal)
        want_o, want_lse = _pallas_flash(q, k, v, causal, jnp.bfloat16)
        np.testing.assert_allclose(o.float().numpy(), want_o, rtol=BF16_TOL,
                                   atol=BF16_TOL)
        np.testing.assert_allclose(lse.numpy(), want_lse, rtol=BF16_TOL,
                                   atol=BF16_TOL)

    @pytest.mark.parametrize("case,route", [
        ("contiguous", "tensor_core"), ("fp32", "tf32x3"),
        ("qkv_thirds", "tensor_core"), ("two_byte_offset", "cuda_core"),
        ("odd_t_stride", "cuda_core"), ("size_one_dims", "tensor_core"),
        ("fp32_qkv_thirds", "tf32x3"), ("fp32_odd_t_stride", "cuda_core"),
        ("fp32_unaligned_base", "cuda_core"),
        ("fp32_t_stride_of_two_chunks", "tf32x3")])
    def test_route_gate(self, case, route):
        # decided on strides and addresses alone, which CPU tensors have
        B, T, H, D = 2, 40, 3, 64
        if case == "contiguous":
            q = torch.zeros((B, T, H, D), dtype=torch.bfloat16)
            k = v = q
        elif case == "fp32":
            q = k = v = torch.zeros((B, T, H, D))
        elif case == "qkv_thirds":   # [B, T, 3E]: strides (T*3E, 3E, D)
            qkv = torch.zeros((B, T, 3 * H * D), dtype=torch.bfloat16)
            q, k, v = (t.reshape(B, T, H, D)
                       for t in qkv.split(H * D, dim=-1))
        elif case == "fp32_qkv_thirds":   # the served fp32 path's views
            qkv = torch.zeros((B, T, 3 * H * D))
            q, k, v = (t.reshape(B, T, H, D)
                       for t in qkv.split(H * D, dim=-1))
        elif case == "fp32_odd_t_stride":   # aligned base, t stride H*D + 1
            buf = torch.zeros((B, T, H * D + 1))
            q = buf[..., :H * D].reshape(B, T, H, D)
            k = v = torch.zeros((B, T, H, D))
        elif case == "fp32_unaligned_base":   # a 4-byte offset
            buf = torch.zeros((B, T, H * D + 4))
            k = buf[..., 1:H * D + 1].reshape(B, T, H, D)
            q = v = torch.zeros((B, T, H, D))
        elif case == "fp32_t_stride_of_two_chunks":   # t stride H*D + 8
            buf = torch.zeros((B, T, H * D + 8))
            v = buf[..., :H * D].reshape(B, T, H, D)
            q = k = torch.zeros((B, T, H, D))
        elif case == "two_byte_offset":
            buf = torch.zeros((B, T, H * D + 8), dtype=torch.bfloat16)
            q = buf[..., 1:H * D + 1].reshape(B, T, H, D)
            k = v = torch.zeros((B, T, H, D), dtype=torch.bfloat16)
        elif case == "odd_t_stride":   # aligned base, t stride H*D + 1
            buf = torch.zeros((B, T, H * D + 1), dtype=torch.bfloat16)
            q = buf[..., :H * D].reshape(B, T, H, D)
            k = v = torch.zeros((B, T, H, D), dtype=torch.bfloat16)
        else:   # B = T = H = 1: those strides are never used
            buf = torch.zeros((1, 1, D + 3), dtype=torch.bfloat16)
            q = k = v = buf[..., :D].reshape(1, 1, 1, D)
        assert q.data_ptr() % 16 == 0 or case == "two_byte_offset"
        assert k.data_ptr() % 16 == 0 or case == "fp32_unaligned_base"
        assert ck.flash_route(q, k, v) == route

    def test_k_tile_is_the_same_on_both_routes(self):
        # the plain version rounds P at the running max of this tile
        for D in (64, 128, 192, 256):
            assert ck.flash_k_tile(D, torch.bfloat16) == ck.flash_k_tile(
                D, torch.float32) == (64 if D <= 128 else 32)

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

    def test_ptxas_report_reads_the_build_log(self, monkeypatch, tmp_path):
        monkeypatch.setattr(ck, "BUILD_DIR", tmp_path)
        assert ck.ptxas_report("flash_attention") == []
        ck._lib_path("flash_attention").with_suffix(".log").write_text(
            "ptxas info    : Compiling entry function '_Z3fooPf' for "
            "'sm_90a'\n"
            "ptxas info    : Function properties for _Z3fooPf\n"
            "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
            "loads\n"
            "ptxas info    : Used 128 registers, used 1 barriers\n"
            "ptxas info    : Compiling entry function '_Z3barPf' for "
            "'sm_90a'\n"
            "ptxas info    : Used 40 registers, used 0 barriers\n")
        assert ck.ptxas_report("flash_attention") == [
            ("_Z3fooPf", 128, 8, 4), ("_Z3barPf", 40, 0, 0)]

    def test_reset_counts_clears_the_flash_routes(self):
        ck.FLASH_ROUTES["tensor_core"] += 3
        ck.FLASH_ROUTES["tf32x3"] += 2
        ck.reset_counts()
        assert ck.FLASH_ROUTES == {"tensor_core": 0, "tf32x3": 0,
                                   "cuda_core": 0}

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
