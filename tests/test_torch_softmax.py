"""The port's softmax kernel module, and the gradients of the layer-norm
and flash-attention overrides, against the JAX package (CPU).

On the CPU the wrappers take their kernels' plain PyTorch versions;
those are held against the Pallas softmax under the interpreter (as
tests/test_pallas.py runs it) and against ``jax.nn.softmax``. The
overrides run under ``torch.autograd.Function``s whose backwards are
composed torch; those are held against ``jax.grad`` through the JAX
overrides (custom VJPs over the Pallas kernels, interpreted). Inputs
come from numpy with a seed.

Tolerances: softmax forward rtol 1e-5, atol 1e-6 and its gradient rtol
1e-4, atol 1e-5 (those of tests/test_pallas.py); layer-norm and flash
gradients 2e-4 (fp32, the same formulas summed in another order); bf16
one ulp (2^-7 relative: both sides round the same fp32 value once).

The CUDA kernel itself is held against its plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops import pallas_kernels as pk
from deeplearning4j_tpu.ops import registry as jreg
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import registry as treg

torch.set_num_threads(2)

SM_RTOL, SM_ATOL = 1e-5, 1e-6
SM_GRAD_RTOL, SM_GRAD_ATOL = 1e-4, 1e-5
GRAD_TOL = 2e-4
BF16_RTOL = 2.0 ** -7


def _x(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.fixture()
def torch_overrides():
    ck.install_platform_overrides()
    try:
        yield
    finally:
        ck.uninstall_platform_overrides()


# ----------------------------------------------------------------- forward
class TestSoftmaxForward:
    @pytest.mark.parametrize("shape", [(32, 128), (512, 128), (16, 256)])
    def test_plain_matches_pallas_and_jax(self, shape):
        x = _x(shape, 1, scale=5.0)
        got = ck.softmax_plain(torch.from_numpy(x)).numpy()
        pallas = pk.make_softmax_override(interpret=True)
        assert pk.supported(jnp.asarray(x))
        np.testing.assert_allclose(got, np.asarray(pallas(x)),
                                   rtol=SM_RTOL, atol=SM_ATOL)
        np.testing.assert_allclose(got, np.asarray(jax.nn.softmax(x, -1)),
                                   rtol=SM_RTOL, atol=SM_ATOL)

    @pytest.mark.parametrize("shape", [(7, 100), (3, 1000), (2, 4096),
                                       (4, 13000), (2, 3, 5, 128), (32, 2),
                                       (6,)])
    def test_override_matches_jax_outside_the_jax_gate(self, shape,
                                                       torch_overrides):
        x = _x(shape, 2, scale=3.0)
        ck.reset_counts()
        got = treg.get("softmax")(torch.from_numpy(x))
        want = np.asarray(jax.nn.softmax(x, axis=-1))
        np.testing.assert_allclose(got.numpy(), want, rtol=SM_RTOL,
                                   atol=SM_ATOL)
        # the port's gate takes every one but D > 12288; rank 4 and 1 go
        # through the [rows, D] view
        taken = shape[-1] <= 12288
        assert ck.PLAIN_CALLS["softmax"] == int(taken)
        assert tuple(got.shape) == shape

    def test_bf16_plain_matches_pallas(self):
        x = _x((64, 128), 3, scale=4.0)
        got = ck.softmax_plain(torch.from_numpy(x).to(torch.bfloat16))
        assert got.dtype == torch.bfloat16
        pallas = pk.make_softmax_override(interpret=True)
        want = np.asarray(pallas(jnp.asarray(x, jnp.bfloat16)), np.float32)
        np.testing.assert_allclose(got.float().numpy(), want,
                                   rtol=BF16_RTOL, atol=SM_ATOL)

    def test_nan_and_minus_inf_rows_as_jnp(self):
        x = _x((4, 16), 4)
        x[1, 3] = np.nan
        x[2, :] = -np.inf
        x[3, 5] = np.inf
        got = ck.softmax_plain(torch.from_numpy(x)).numpy()
        want = np.asarray(jax.nn.softmax(x, -1))
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        assert np.isnan(got[1:]).all() and not np.isnan(got[0]).any()
        np.testing.assert_allclose(got[0], want[0], rtol=SM_RTOL,
                                   atol=SM_ATOL)

    def test_axis_not_last_takes_the_generic_op(self, torch_overrides):
        x = _x((5, 8), 5)
        ck.reset_counts()
        got = treg.get("softmax")(torch.from_numpy(x), axis=0).numpy()
        np.testing.assert_allclose(got, np.asarray(jax.nn.softmax(x, 0)),
                                   rtol=SM_RTOL, atol=SM_ATOL)
        view = torch.from_numpy(_x((8, 5), 6)).t()        # not contiguous
        treg.get("softmax")(view)
        assert ck.PLAIN_CALLS["softmax"] == 0

    def test_gate_contains_the_jax_gate(self):
        for n in (8, 16, 49152):
            for d in (128, 256, 1024, 4096):
                for dt, jdt in ((torch.float32, jnp.float32),
                                (torch.bfloat16, jnp.bfloat16)):
                    if pk.supported(jnp.zeros((n, d), jdt)):
                        assert ck.softmax_supported(
                            torch.zeros((n, d), dtype=dt))
        assert not ck.softmax_supported(torch.zeros(4, 8, dtype=torch.half))
        assert not ck.softmax_supported(torch.zeros(4, 8), axis=0)

    def test_cuda_wrapper_refuses_other_devices(self):
        with pytest.raises(RuntimeError, match="no kernel"):
            ck.softmax_fwd(torch.zeros(2, 4, device="meta"))


class TestRegistryDispatch:
    def test_exec_op_takes_the_override(self, torch_overrides):
        x = _x((8, 128), 7)
        ck.reset_counts()
        got = treg.exec_op("softmax", torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(jreg.exec_op("softmax",
                                                                x)),
                                   rtol=SM_RTOL, atol=SM_ATOL)
        assert ck.PLAIN_CALLS["softmax"] == 1
        assert treg.get("softmax") is not treg.softmax

    def test_uninstall_restores_the_generic_op(self):
        ck.install_platform_overrides()
        ck.uninstall_platform_overrides()
        assert treg.get("softmax") is treg.softmax
        x = _x((3, 9), 8)
        np.testing.assert_allclose(
            treg.exec_op("softmax", torch.from_numpy(x)).numpy(),
            np.asarray(jax.nn.softmax(x, -1)), rtol=SM_RTOL, atol=SM_ATOL)

    @pytest.mark.parametrize("name,args,kwargs", [
        ("matmul", [(2, 3, 4), (2, 5, 4)], {"transpose_b": True}),
        ("mmul", [(4, 3), (4, 5)], {"transpose_a": True}),
        ("xw_plus_b", [(3, 4), (4, 5), (5,)], {}),
        ("bias_add", [(3, 4), (4,)], {}),
        ("gelu", [(3, 4)], {}), ("tanh", [(3, 4)], {}),
        ("sigmoid", [(3, 4)], {}), ("relu", [(3, 4)], {}),
        ("log_softmax", [(3, 4)], {}),
        ("reduce_sum", [(3, 4)], {"axis": (1,), "keepdims": True}),
        ("reduce_mean", [(3, 4)], {"axis": None}),
        ("transpose", [(2, 3, 4)], {}),
        ("permute", [(2, 3, 4)], {"perm": (1, 0, 2)}),
        ("reshape", [(2, 3, 4)], {"shape": (-1, 4)}),
        ("subtract", [(3, 4), (4,)], {}), ("divide", [(3, 4), (3, 1)], {}),
        ("neg", [(3,)], {}),
    ])
    def test_ops_match_jax(self, name, args, kwargs):
        arrays = [_x(s, 10 + i) for i, s in enumerate(args)]
        got = treg.exec_op(name, *map(torch.from_numpy, arrays), **kwargs)
        want = jreg.exec_op(name, *arrays, **kwargs)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)

    def test_gather_cast_and_losses_match_jax(self):
        table = _x((6, 3), 20)
        idx = np.array([[1, 5], [0, 2]], np.int32)
        t = treg.exec_op("gather", torch.from_numpy(table),
                         torch.from_numpy(idx), axis=0)
        np.testing.assert_array_equal(
            t.numpy(), np.asarray(jreg.exec_op("gather", table, idx, axis=0)))
        c = treg.exec_op("cast", torch.from_numpy(table), dtype="int32")
        assert c.dtype == torch.int32
        logits = _x((4, 3), 21, scale=2.0)
        labels = np.array([0, 2, 1, 2], np.int32)
        onehot = np.eye(3, dtype=np.float32)[labels]
        for name, lab in (("sparse_softmax_cross_entropy_loss", labels),
                          ("softmax_cross_entropy_loss", onehot)):
            got = treg.exec_op(name, torch.from_numpy(lab),
                               torch.from_numpy(logits))
            np.testing.assert_allclose(
                float(got), float(jreg.exec_op(name, lab, logits)),
                rtol=1e-6, err_msg=name)


# ---------------------------------------------------------------- gradients
def _jax_grads(fn, args, weight):
    argnums = tuple(range(len(args)))
    return jax.grad(lambda *a: jnp.sum(fn(*a) * weight), argnums)(*args)


def _torch_grads(fn, args, weight):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    (fn(*leaves) * torch.from_numpy(weight)).sum().backward()
    return [t.grad.numpy() for t in leaves]


class TestGradients:
    @pytest.mark.parametrize("shape", [(16, 128), (256, 256)])
    def test_softmax_override_matches_jax_grad(self, shape,
                                               torch_overrides):
        x = _x(shape, 30, scale=3.0)
        w = _x(shape, 31)
        pallas = pk.make_softmax_override(interpret=True)
        ck.reset_counts()
        got = _torch_grads(treg.get("softmax"), [x], w)
        assert ck.PLAIN_CALLS["softmax"] == 1
        want = _jax_grads(pallas, [jnp.asarray(x)], w)
        np.testing.assert_allclose(got[0], np.asarray(want[0]),
                                   rtol=SM_GRAD_RTOL, atol=SM_GRAD_ATOL)

    def test_softmax_backward_on_a_4d_view(self, torch_overrides):
        x = _x((2, 3, 4, 16), 32)
        w = _x((2, 3, 4, 16), 33)
        got = _torch_grads(treg.get("softmax"), [x], w)
        want = _jax_grads(lambda v: jax.nn.softmax(v, -1), [jnp.asarray(x)],
                          w)
        np.testing.assert_allclose(got[0], np.asarray(want[0]),
                                   rtol=SM_GRAD_RTOL, atol=SM_GRAD_ATOL)

    @pytest.mark.parametrize("shape", [(64, 256), (16, 768)])
    def test_layer_norm_override_matches_jax_grad(self, shape,
                                                  torch_overrides):
        x = _x(shape, 40, scale=2.0) + 0.5
        g = _x(shape[1:], 41, scale=0.5) + 1.0
        b = _x(shape[1:], 42, scale=0.1)
        w = _x(shape, 43)
        pallas = pk.make_layer_norm_override(interpret=True)
        ck.reset_counts()
        got = _torch_grads(lambda *a: treg.get("layer_norm")(*a, eps=1e-5),
                           [x, g, b], w)
        assert ck.PLAIN_CALLS["layer_norm"] == 1
        want = _jax_grads(lambda *a: pallas(*a, eps=1e-5),
                          [jnp.asarray(a) for a in (x, g, b)], w)
        for name, a, e in zip("x gain bias".split(), got, want):
            np.testing.assert_allclose(a, np.asarray(e), rtol=GRAD_TOL,
                                       atol=GRAD_TOL, err_msg=name)

    @pytest.mark.parametrize("causal", [False, True])
    def test_flash_override_matches_jax_grad(self, causal, torch_overrides):
        shape = (2, 128, 2, 64)               # inside the JAX gate: T % 128
        q, k, v = (_x(shape, s) for s in (50, 51, 52))
        w = _x(shape, 53)
        pallas = pk.make_flash_attention_override(interpret=True)
        ck.reset_counts()
        got = _torch_grads(
            lambda *a: treg.get("flash_attention")(*a, is_causal=causal),
            [q, k, v], w)
        assert ck.PLAIN_CALLS["flash_attention"] == 1
        want = _jax_grads(lambda *a: pallas(*a, is_causal=causal),
                          [jnp.asarray(a) for a in (q, k, v)], w)
        for name, a, e in zip("qkv", got, want):
            np.testing.assert_allclose(a, np.asarray(e), rtol=GRAD_TOL,
                                       atol=GRAD_TOL, err_msg=name)

    @pytest.mark.parametrize("causal", [False, True])
    def test_flash_backward_with_a_ragged_last_block(self, causal):
        # Tq=100, Tk=300: k blocks of 256 and 44; against autograd through
        # the plain forward
        q = _x((1, 100, 2, 64), 60)
        k, v = (_x((1, 300, 2, 64), s) for s in (61, 62))
        w = _x((1, 100, 2, 64), 63)
        got = _torch_grads(
            lambda *a: ck._FlashAttentionKernel.apply(*a, causal), [q, k, v],
            w)
        want = _torch_grads(
            lambda *a: ck.flash_attention_plain(*a, causal)[0], [q, k, v], w)
        for name, a, e in zip("qkv", got, want):
            np.testing.assert_allclose(a, e, rtol=GRAD_TOL, atol=GRAD_TOL,
                                       err_msg=name)
