"""The port's CUDA kernels and served forward on the card.

Every test here needs a CUDA card (marker ``cuda``) and skips without
one. The file imports neither JAX nor the JAX package, so it also runs on
a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: fp32 rtol=atol=2e-5 (as tests/test_pallas.py), bf16 2e-2 (a
few bf16 ulps: both sides round the same fp32 value), lse 1e-5 absolute.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.models import transformer as ttr
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.serving import ModelServer

pytestmark = pytest.mark.cuda

FP32_TOL = 2e-5
BF16_TOL = 2e-2


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(dev, *shape, dtype=torch.float32, seed=0):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(a).to(dev, dtype)


def _tol(dtype):
    return FP32_TOL if dtype == torch.float32 else BF16_TOL


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(1000, 768), (7, 33), (64, 4096)])
def test_layer_norm_kernel_matches_plain(dev, dtype, shape):
    x = _randn(dev, *shape, dtype=dtype, seed=1) * 2 + 0.5
    g = _randn(dev, shape[1], seed=2)
    b = _randn(dev, shape[1], seed=3)
    ck.reset_counts()
    y = ck.layer_norm_fwd(x, g, b)
    assert ck.LAUNCHES["layer_norm"] == 1 and y.dtype == dtype
    torch.testing.assert_close(y, ck.layer_norm_plain(x, g, b),
                               rtol=_tol(dtype), atol=_tol(dtype))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T,D", [(200, 64), (128, 128), (70, 192),
                                 (64, 256)])
def test_flash_kernel_matches_plain(dev, causal, dtype, T, D):
    q, k, v = (_randn(dev, 2, T, 3, D, dtype=dtype, seed=s)
               for s in (4, 5, 6))
    o, lse = ck.flash_attention_fwd(q, k, v, causal)
    po, plse = ck.flash_attention_plain(q, k, v, causal)
    torch.testing.assert_close(o, po, rtol=_tol(dtype), atol=_tol(dtype))
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-5)


def test_flash_kernel_reads_strided_views(dev):
    # q, k, v as the QKV projection leaves them: thirds of one [B, T, 3E]
    B, T, H, D = 2, 96, 4, 64
    qkv = _randn(dev, B, T, 3 * H * D, dtype=torch.bfloat16, seed=7)
    q, k, v = (t.reshape(B, T, H, D) for t in qkv.split(H * D, dim=-1))
    assert not q.is_contiguous()
    o, _ = ck.flash_attention_fwd(q, k, v)
    po, _ = ck.flash_attention_plain(q.contiguous(), k.contiguous(),
                                     v.contiguous())
    torch.testing.assert_close(o, po, rtol=BF16_TOL, atol=BF16_TOL)


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    with pytest.raises(ValueError):
        ck.layer_norm_fwd(_randn(dev, 4, 8).t(), torch.ones(4, device=dev),
                          torch.zeros(4, device=dev))
    q = _randn(dev, 1, 8, 1, 32)
    with pytest.raises(ValueError):
        ck.flash_attention_fwd(q, q, q)


def test_served_tiny_lm_launches_the_kernels(dev):
    cfg = ttr.TransformerConfig.tiny(d_model=128, n_heads=2,
                                     use_flash_attention=True)
    lm = ttr.TransformerLM(cfg, seed=0)
    ck.install_platform_overrides()
    try:
        with ModelServer(lm.logits, batch_limit=4, input_dtype=np.int32,
                         head="argmax") as sv:
            sv.warmup([(64,)])
            ck.reset_counts()
            tok = np.random.default_rng(8).integers(0, 1024, (3, 64),
                                                    dtype=np.int32)
            got = sv.output(tok, timeout=60)
            n_fwd = sv.stats()["batches"]
        assert ck.LAUNCHES == {"layer_norm": 5 * n_fwd,
                               "flash_attention": 2 * n_fwd}
        assert ck.PLAIN_CALLS == {"layer_norm": 0, "flash_attention": 0}
        want = lm.logits(tok).argmax(-1).to(torch.int32).cpu().numpy()
        assert (got == want).mean() >= 0.99
    finally:
        ck.uninstall_platform_overrides()
