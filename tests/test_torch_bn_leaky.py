"""The BN+leaky probe's kernels and composed version against the JAX
probe, ``benchmarks/probe_bn_leaky.py`` (CPU).

On the CPU the port's wrappers (``cuda_kernels.bn_stats`` and
``bn_apply_leaky``) take their plain PyTorch versions; those are held
here against the probe's two Pallas kernels themselves, run under the
Pallas interpreter: ``pallas_call`` is wrapped with ``interpret=True``
inside the test (the probe file is unchanged), and each kernel's inputs
and output are captured on their way through. Small blocks
(``rows=8, cols=128``) keep the interpreter quick. Inputs come from
numpy with a seed.

Tolerances: the sums 1e-5 relative (fp32 sums in another order); y one
bf16 ulp (the JAX kernel multiplies and then adds in fp32, the port's
plain version rounds ``x*scale + shift`` once, as the kernel's FMA
does); NaN wherever the probe has NaN. The CUDA kernels themselves are
held against the plain versions on the card by tests/test_torch_cuda.py
and chip_smoke.py.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from jax.experimental import pallas as pl

from deeplearning4j_tpu_torch.benchmarks import probe_bn_leaky as tprobe
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(2)

_PROBE = Path(__file__).resolve().parent.parent / "benchmarks" / \
    "probe_bn_leaky.py"
SUM_TOL = 1e-5
ROWS, COLS = 8, 128


@pytest.fixture(scope="module")
def jprobe():
    spec = importlib.util.spec_from_file_location("_jax_probe_bn_leaky",
                                                  _PROBE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def interpreted(monkeypatch):
    """Runs every ``pallas_call`` under the interpreter and records each
    call's inputs and output, in order."""
    calls = []
    orig = pl.pallas_call

    def spy(*args, **kwargs):
        fn = orig(*args, **kwargs, interpret=True)

        def run(*ins):
            out = fn(*ins)
            calls.append((ins, out))
            return out
        return run

    monkeypatch.setattr(pl, "pallas_call", spy)
    return calls


def _x(seed, c=4, m=2048, nan=False):
    x = np.random.default_rng(seed).standard_normal((c, m)) * 1.5 + 0.3
    if nan:
        x[1, 77] = np.nan
    return x.astype(np.float32)


def _params(seed, c=4):
    r = np.random.default_rng(seed)
    return (r.uniform(0.5, 1.5, c).astype(np.float32),
            r.standard_normal(c).astype(np.float32))


def _ulp_close(got, want, what):
    """|got - want| within one bf16 ulp of want, NaN where want is NaN."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
    g, w = got[~nan], want[~nan]
    _, e = np.frexp(w)
    ulp = np.where(w == 0, 0.0, np.ldexp(1.0, e - 8))
    bad = np.abs(g - w) > ulp
    assert not bad.any(), f"{what}: {int(bad.sum())} beyond one bf16 ulp"


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


@pytest.mark.parametrize("nan", [False, True])
def test_plain_versions_match_the_pallas_kernels(jprobe, interpreted, nan):
    x = _x(0, nan=nan)
    gamma, beta = _params(1)
    jnp_x = jnp.asarray(x, jnp.bfloat16)
    y_jax = jprobe.pallas_bn_leaky(jnp_x, jnp.asarray(gamma),
                                   jnp.asarray(beta), rows=ROWS, cols=COLS)
    (_, sums), ((_, sc, sh), y_apply) = interpreted
    sums = np.asarray(sums)
    c = x.shape[0]
    xt = _bf16(x)
    s, q = ck.bn_stats_plain(xt)
    for got, want in ((s, sums[:c, 0]), (q, sums[c:, 0])):
        want = want.astype(np.float64)
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
        fin = ~np.isnan(want)
        np.testing.assert_allclose(got.numpy()[fin], want[fin],
                                   rtol=SUM_TOL, atol=0)
    if nan:
        assert np.isnan(s[1]) and np.isnan(q[1])
        assert np.isfinite(s.numpy()[[0, 2, 3]]).all()
    y = ck.bn_apply_leaky_plain(xt, torch.from_numpy(
        np.asarray(sc)[:, 0].copy()), torch.from_numpy(
        np.asarray(sh)[:, 0].copy()), 0.1)
    assert y.dtype == torch.bfloat16
    _ulp_close(y.float().numpy(),
               np.asarray(y_apply, np.float32).reshape(x.shape), "apply")
    ck.reset_counts()
    yk = tprobe.bn_leaky_kernels(xt, torch.from_numpy(gamma),
                                 torch.from_numpy(beta))
    assert ck.PLAIN_CALLS["bn_stats"] == ck.PLAIN_CALLS["bn_apply_leaky"] == 1
    _ulp_close(yk.float().numpy(), np.asarray(y_jax, np.float32),
               "bn_leaky_kernels")
    if nan:
        assert torch.isnan(yk[1].float()).all()


def test_composed_matches_the_probe(jprobe):
    x = np.random.default_rng(2).standard_normal((2, 4, 8, 16)).astype(
        np.float32) * 2 - 0.5
    gamma, beta = _params(3)
    want = jprobe.bn_leaky(jnp.asarray(x, jnp.bfloat16), jnp.asarray(gamma),
                           jnp.asarray(beta))
    got = tprobe.bn_leaky(_bf16(x), torch.from_numpy(gamma),
                          torch.from_numpy(beta))
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    _ulp_close(got.float().numpy(), np.asarray(want, np.float32),
               "bn_leaky")
    # the kernels' route over the channel-major view agrees within the
    # probe's own check (0.05)
    x2d = _bf16(x).transpose(0, 1).reshape(4, -1)
    yk = tprobe.bn_leaky_kernels(x2d, torch.from_numpy(gamma),
                                 torch.from_numpy(beta))
    back = yk.reshape(4, 2, 8, 16).transpose(0, 1).float()
    assert float((back - got.float()).abs().max()) < 0.05


def test_probe_semantics():
    # slope 0.1 with y > 0 (0 and -0 take the slope), fp32 scale/shift,
    # the variance unclamped: a constant channel gives var 0 (rsqrt(eps))
    x = torch.tensor([[-2.0, 0.0, 3.0, 1.0], [5.0, 5.0, 5.0, 5.0]])
    y = ck.bn_apply_leaky_plain(x, torch.tensor([1.0, 2.0]),
                                torch.tensor([0.0, -10.0]), 0.1)
    assert y.tolist() == [[float(np.float32(-0.2)), 0.0, 3.0, 1.0],
                          [0.0, 0.0, 0.0, 0.0]]
    s, q = ck.bn_stats_plain(x.to(torch.bfloat16))
    assert s.dtype == q.dtype == torch.float32
    assert s.tolist() == [2.0, 20.0] and q.tolist() == [14.0, 100.0]
    assert tprobe.two_pass_bytes(torch.zeros(2, 3, 4, 5,
                                             dtype=torch.bfloat16)) == 720
    line, frac, speedup = tprobe.verdict(1000.0, 3.0, 2.9, 2_400_000_000)
    assert line.startswith("verdict: PHYSICS") and frac == pytest.approx(0.8)
    assert tprobe.verdict(1000.0, 3.0, 2.0, 10 ** 9)[0].startswith(
        "verdict: LOWERING")
    assert tprobe.verdict(1000.0, 3.0, 2.9, 10 ** 9)[0].startswith(
        "verdict: INCONCLUSIVE")


def test_wrappers_refuse_what_they_cannot_take(monkeypatch):
    with pytest.raises(RuntimeError, match="no kernel"):
        ck.bn_stats(torch.empty((4, 8), device="meta"))
    with pytest.raises(RuntimeError, match="no kernel"):
        ck.bn_apply_leaky(torch.empty((4, 8), device="meta"),
                          torch.ones(4), torch.zeros(4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        tprobe.main()
    assert tprobe._cli([]) == 1
