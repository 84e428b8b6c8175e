"""The port's ring attention (``deeplearning4j_tpu_torch.parallel.
sequence``) against the JAX package's (``tests/test_parallel.py::
TestRingAttention``), and the collectives and mesh it stands on.

The port runs on spawned gloo ranks on the CPU (one module-scoped
``RankPool`` of 2); the JAX ``ring_attention`` runs on the same seeded
numpy inputs over a JAX mesh of the same shape cut from conftest's 8 CPU
devices, and so does ``ring_attention_reference``. Each rank attends its
``T/seq`` rows through the flash kernel's plain version (the CPU path of
``flash_attention_fwd``); the pieces are joined in the parent.

Cuts of the JAX meshes to at most 2 ranks: ``data=2, seq=4`` becomes
``seq=2`` (both batch rows on each rank); ``seq=8`` (causal) becomes
``seq=2``; the gradient case's ``seq=4`` becomes ``seq=2``. Shapes and
seeds are the JAX tests'. Tolerances are theirs: ``rtol=2e-4,
atol=2e-5`` on outputs, ``rtol=1e-3, atol=1e-4`` on gradients.

The differentiable ``ppermute`` and ``all_gather`` are held against a
central finite difference of a loss summed over the ranks, and a mesh
of named axes (``DeviceMesh.from_axes``) against the JAX
``Mesh(devices.reshape(...), names)`` it stands for.
"""

import numpy as np
import pytest

from deeplearning4j_tpu_torch.parallel.launch import RankPool

WORLD = 2
RTOL, ATOL = 2e-4, 2e-5
G_RTOL, G_ATOL = 1e-3, 1e-4


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


def _qkv(seed, shape):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(3)]


def _jring(q, k, v, devices, seq, causal=False):
    import jax.numpy as jnp
    from deeplearning4j_tpu.parallel import DeviceMesh as JMesh
    from deeplearning4j_tpu.parallel.sequence import (
        ring_attention, ring_attention_reference)
    m = JMesh.create(data=1, model=1, seq=seq, devices=devices[:seq])
    q, k, v = (jnp.asarray(a) for a in (q, k, v))
    return (np.asarray(ring_attention(q, k, v, m.mesh, is_causal=causal)),
            np.asarray(ring_attention_reference(q, k, v, is_causal=causal)))


# ------------------------------------------------------- rank functions
def rank_ring(q, k, v, causal):
    """This rank's rows of the ring's output, and its flash launches
    (plain calls on the CPU)."""
    import torch
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.parallel import DeviceMesh
    from deeplearning4j_tpu_torch.parallel.sequence import ring_attention
    mesh = DeviceMesh.create(data=1, model=1, seq=WORLD)
    r, t = mesh.coordinate("seq"), q.shape[1] // WORLD
    piece = [torch.from_numpy(a[:, r * t:(r + 1) * t]) for a in (q, k, v)]
    ck.reset_counts()
    out = ring_attention(*piece, mesh, is_causal=causal)
    return out.numpy(), ck.PLAIN_CALLS["flash_attention"]


def rank_ring_grad(q):
    """``d/dq sum(ring(q, q, q)**2)`` summed over the ranks: this rank's
    rows of it."""
    import torch
    from deeplearning4j_tpu_torch.parallel import DeviceMesh
    from deeplearning4j_tpu_torch.parallel.sequence import ring_attention
    mesh = DeviceMesh.create(data=1, model=1, seq=WORLD)
    r, t = mesh.coordinate("seq"), q.shape[1] // WORLD
    ql = torch.from_numpy(q[:, r * t:(r + 1) * t].copy()).requires_grad_()
    (ring_attention(ql, ql, ql, mesh) ** 2).sum().backward()
    return ql.grad.numpy()


def rank_ppermute(x, shift, wrap, probe):
    """The differentiable ``ppermute`` of this rank's row ``x[r]``: what
    arrives, and the gradient of ``sum_r probe[r] . out_r`` (the loss
    summed over the ranks) with respect to the row."""
    import torch
    from deeplearning4j_tpu_torch.parallel import collectives as C
    from deeplearning4j_tpu_torch.parallel import DeviceMesh
    mesh = DeviceMesh.data_parallel()
    r = mesh.coordinate("data")
    xr = torch.from_numpy(x[r].copy()).requires_grad_()
    out = C.ppermute_grad(xr, mesh.group("data"), shift, wrap)
    (out * torch.from_numpy(probe[r])).sum().backward()
    return out.detach().numpy(), xr.grad.numpy()


def rank_all_gather(x, probe):
    """The differentiable all-gather of this rank's piece along dim 1,
    and the gradient of ``sum_r probe[r] . whole_r``."""
    import torch
    from deeplearning4j_tpu_torch.parallel import collectives as C
    from deeplearning4j_tpu_torch.parallel import DeviceMesh
    mesh = DeviceMesh.data_parallel()
    r = mesh.coordinate("data")
    c = x.shape[1] // WORLD
    xr = torch.from_numpy(x[:, r * c:(r + 1) * c].copy()).requires_grad_()
    whole = C.all_gather_grad(xr, mesh.group("data"), 1)
    (whole * torch.from_numpy(probe[r])).sum().backward()
    return whole.detach().numpy(), xr.grad.numpy()


def rank_named_mesh(axes):
    from deeplearning4j_tpu_torch.parallel import DeviceMesh
    from deeplearning4j_tpu_torch.parallel import collectives as C
    mesh = DeviceMesh.from_axes(axes)
    coords = {a: mesh.coordinate(a) for a in mesh.axis_names}
    sizes = {a: C.group_size(mesh.group(a)) for a in mesh.axis_names}
    return (mesh.axis_names, mesh.size(), coords, sizes,
            mesh.size("model"), [d.id for d in mesh.devices])


# ---------------------------------------------------------------- tests
class TestRingAttention:
    def test_matches_exact(self, pool, devices):
        """JAX: data=2, seq=4 at B, T, H, D = 2, 32, 2, 8; here seq=2."""
        q, k, v = _qkv(0, (2, 32, 2, 8))
        jring, exact = _jring(q, k, v, devices, WORLD)
        out = pool.run(rank_ring, q, k, v, False)
        ring = np.concatenate([o for o, _ in out], axis=1)
        np.testing.assert_allclose(ring, exact, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ring, jring, rtol=RTOL, atol=ATOL)
        assert [n for _, n in out] == [WORLD] * WORLD

    def test_causal_matches_exact(self, pool, devices):
        """JAX: seq=8 at B, T, H, D = 1, 64, 2, 4; here seq=2. Rank r
        attends r + 1 blocks (the later ones are skipped)."""
        q, k, v = _qkv(1, (1, 64, 2, 4))
        jring, exact = _jring(q, k, v, devices, WORLD, causal=True)
        out = pool.run(rank_ring, q, k, v, True)
        ring = np.concatenate([o for o, _ in out], axis=1)
        np.testing.assert_allclose(ring, exact, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ring, jring, rtol=RTOL, atol=ATOL)
        assert [n for _, n in out] == [1, 2]

    def test_grads_flow_through_ring(self, pool, devices):
        """JAX: seq=4 at B, T, H, D = 1, 16, 1, 4; here seq=2."""
        import jax
        import jax.numpy as jnp
        from deeplearning4j_tpu.parallel import DeviceMesh as JMesh
        from deeplearning4j_tpu.parallel.sequence import (
            ring_attention, ring_attention_reference)
        q = np.random.RandomState(2).randn(1, 16, 1, 4).astype(np.float32)
        m = JMesh.create(data=1, model=1, seq=WORLD, devices=devices[:WORLD])
        g_ring = np.asarray(jax.grad(
            lambda a: jnp.sum(ring_attention(a, a, a, m.mesh) ** 2))(
                jnp.asarray(q)))
        g_exact = np.asarray(jax.grad(
            lambda a: jnp.sum(ring_attention_reference(a, a, a) ** 2))(
                jnp.asarray(q)))
        got = np.concatenate(pool.run(rank_ring_grad, q), axis=1)
        np.testing.assert_allclose(got, g_exact, rtol=G_RTOL, atol=G_ATOL)
        np.testing.assert_allclose(got, g_ring, rtol=G_RTOL, atol=G_ATOL)


def _fd(loss, x, eps=1e-3):
    g = np.zeros_like(x, dtype=np.float64)
    flat = x.reshape(-1)
    for i in range(flat.size):
        keep = flat[i]
        flat[i] = keep + eps
        up = loss(x)
        flat[i] = keep - eps
        down = loss(x)
        flat[i] = keep
        g.reshape(-1)[i] = (up - down) / (2 * eps)
    return g


class TestDifferentiableCollectives:
    @pytest.mark.parametrize("shift,wrap", [(1, True), (-1, True),
                                            (1, False)])
    def test_ppermute_backward_is_the_reverse_shift(self, pool, shift,
                                                    wrap):
        """The forward moves rank r's row to rank r + shift (a rank with
        no source receives zeros, as JAX's ``ppermute``); the gradient of
        the loss summed over the ranks matches its finite difference."""
        rng = np.random.RandomState(3)
        x = rng.randn(WORLD, 3).astype(np.float64)
        probe = rng.randn(WORLD, 3).astype(np.float64)

        def moved(a):
            out = np.zeros_like(a)
            for r in range(WORLD):
                d = r + shift
                if wrap:
                    d %= WORLD
                if 0 <= d < WORLD:
                    out[d] = a[r]
            return out

        got = pool.run(rank_ppermute, x.astype(np.float32), shift, wrap,
                       probe.astype(np.float32))
        np.testing.assert_allclose(np.stack([o for o, _ in got]), moved(x),
                                   rtol=1e-6)
        fd = _fd(lambda a: float((moved(a) * probe).sum()), x.copy())
        np.testing.assert_allclose(np.stack([g for _, g in got]), fd,
                                   rtol=1e-4, atol=1e-5)

    def test_all_gather_backward_is_a_reduce_scatter(self, pool):
        rng = np.random.RandomState(4)
        x = rng.randn(2, 4).astype(np.float64)
        probe = rng.randn(WORLD, 2, 4).astype(np.float64)
        got = pool.run(rank_all_gather, x.astype(np.float32),
                       probe.astype(np.float32))
        for whole, _ in got:
            np.testing.assert_allclose(whole, x, rtol=1e-6)
        fd = _fd(lambda a: float(sum((a * p).sum() for p in probe)),
                 x.copy())
        grad = np.concatenate([g for _, g in got], axis=1)
        np.testing.assert_allclose(grad, fd, rtol=1e-4, atol=1e-5)


class TestNamedMesh:
    def test_axes_from_a_dict(self, pool, devices):
        """``DeviceMesh.from_axes({"data": 1, "pipe": 2})`` is the JAX
        ``Mesh(devices.reshape(1, 2), ("data", "pipe"))``: its axes,
        size and each rank's coordinate; an axis it does not name has
        size 1."""
        import jax
        jm = jax.sharding.Mesh(np.asarray(devices[:2]).reshape(1, 2),
                               ("data", "pipe"))
        out = pool.run(rank_named_mesh, {"data": 1, "pipe": 2})
        for r, (names, size, coords, sizes, model, members) in \
                enumerate(out):
            assert names == tuple(jm.axis_names)
            assert size == jm.devices.size
            assert sizes == dict(jm.shape)
            assert coords == {"data": 0, "pipe": r}
            assert model == 1
            assert members == [0, 1]

    def test_minus_one_takes_the_rest(self, pool):
        out = pool.run(rank_named_mesh, {"pipe": -1, "data": 1})
        assert out[0][0] == ("pipe", "data") and out[0][3]["pipe"] == 2
