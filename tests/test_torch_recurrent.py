"""The port's recurrent ops (``deeplearning4j_tpu_torch.ops.recurrent``)
against the JAX package's (``deeplearning4j_tpu.ops.recurrent``), on the
CPU: each cell, and each sequence op with and without a ragged ``[T, N]``
mask, forward and reversed, from the same numpy inputs (seeded).

Tolerances (tests/test_pallas.py's): fp32 forward 1e-5 (rtol and atol);
gradients of a fixed random projection of the outputs and the final
state, with respect to the input, the weights and the initial state,
within 2e-4 of each gradient's largest magnitude.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.ops import recurrent as jrnn
from deeplearning4j_tpu_torch.ops import recurrent as trnn

torch.set_num_threads(2)

FWD_TOL = 1e-5
GRAD_TOL = 2e-4
T, N, C, H = 7, 3, 5, 4


def _arrays(seed, shapes):
    r = np.random.default_rng(seed)
    return [(0.5 * r.standard_normal(s)).astype(np.float32) for s in shapes]


def _mask(seed):
    """Ragged lengths, and one example with a hole in the middle."""
    m = np.ones((T, N), np.float32)
    m[5:, 0] = 0.0
    m[2:4, 1] = 0.0
    m[0, 2] = 0.0
    return m


# op name -> (weight shapes, jax fn, torch fn, carry names)
OPS = {
    "lstm": ([(C, 4 * H), (H, 4 * H), (4 * H,)], jrnn.lstm, trnn.lstm,
             ("h0", "c0")),
    "gru": ([(C, 3 * H), (H, 3 * H), (3 * H,), (3 * H,)], jrnn.gru, trnn.gru,
            ("h0",)),
    "sru": ([(C, C), (C, C), (C,), (C, C), (C,)], jrnn.sru, trnn.sru,
            ("c0",)),
    "simple_rnn": ([(C, H), (H, H), (H,)], jrnn.simple_rnn, trnn.simple_rnn,
                   ("h0",)),
}


def _width(op):
    return C if op == "sru" else H


def _run_jax(op, x, ws, carry, mask, reverse):
    _, jfn, _, names = OPS[op]
    kw = dict(zip(names, carry))
    outs, fin = jfn(x, *ws, mask_tn=mask, reverse=reverse, **kw)
    return outs, fin


def _run_torch(op, x, ws, carry, mask, reverse):
    _, _, tfn, names = OPS[op]
    kw = dict(zip(names, carry))
    outs, fin = tfn(x, *ws, mask_tn=mask, reverse=reverse, **kw)
    return outs, fin


def _flat(fin):
    return list(fin) if isinstance(fin, tuple) else [fin]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("op", sorted(OPS))
def test_sequence_op_matches_jax(op, masked, reverse):
    wshapes, _, _, names = OPS[op]
    w = _width(op)
    x, *ws = _arrays(1, [(T, N, C)] + wshapes)
    carry = _arrays(2, [(N, w)] * len(names))
    mask = _mask(3) if masked else None
    proj_o, *proj_f = _arrays(4, [(T, N, w)] + [(N, w)] * len(names))

    def jloss(x, ws, carry):
        outs, fin = _run_jax(op, x, ws, carry,
                             None if mask is None else jnp.asarray(mask),
                             reverse)
        return jnp.sum(outs * proj_o) + sum(
            jnp.sum(f * p) for f, p in zip(_flat(fin), proj_f))

    jx, jws, jc = jnp.asarray(x), [jnp.asarray(a) for a in ws], \
        [jnp.asarray(a) for a in carry]
    want_outs, want_fin = _run_jax(
        op, jx, jws, jc, None if mask is None else jnp.asarray(mask), reverse)
    want_g = jax.grad(jloss, argnums=(0, 1, 2))(jx, jws, jc)

    tx = torch.from_numpy(x).requires_grad_(True)
    tws = [torch.from_numpy(a).requires_grad_(True) for a in ws]
    tc = [torch.from_numpy(a).requires_grad_(True) for a in carry]
    outs, fin = _run_torch(op, tx, tws, tc,
                           None if mask is None else torch.from_numpy(mask),
                           reverse)
    np.testing.assert_allclose(outs.detach().numpy(), np.asarray(want_outs),
                               rtol=FWD_TOL, atol=FWD_TOL)
    for got, want in zip(_flat(fin), _flat(want_fin)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=FWD_TOL, atol=FWD_TOL)
    if mask is not None:                  # a masked step emits zeros
        assert not outs.detach().numpy()[mask == 0].any()
    loss = (outs * torch.from_numpy(proj_o)).sum() + sum(
        (f * torch.from_numpy(p)).sum() for f, p in zip(_flat(fin), proj_f))
    grads = torch.autograd.grad(loss, [tx] + tws + tc)
    wants = [want_g[0]] + list(want_g[1]) + list(want_g[2])
    for i, (g, ref) in enumerate(zip(grads, wants)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(
            g.numpy(), ref, rtol=0,
            atol=GRAD_TOL * max(float(np.abs(ref).max()), 1e-30),
            err_msg=f"{op} gradient {i}")


def test_zero_initial_state_is_the_default():
    wshapes = OPS["lstm"][0]
    x, *ws = _arrays(5, [(T, N, C)] + wshapes)
    tx, tws = torch.from_numpy(x), [torch.from_numpy(a) for a in ws]
    a, (ha, ca) = trnn.lstm(tx, *tws)
    z = torch.zeros(N, H)
    b, (hb, cb) = trnn.lstm(tx, *tws, h0=z, c0=z)
    assert torch.equal(a, b) and torch.equal(ha, hb) and torch.equal(ca, cb)


@pytest.mark.parametrize("cell", ["lstm_cell", "gru_cell", "sru_cell"])
def test_cells_match_jax(cell):
    if cell == "lstm_cell":
        shapes = [(N, C), (N, H), (N, H), (C, 4 * H), (H, 4 * H), (4 * H,)]
    elif cell == "gru_cell":
        shapes = [(N, C), (N, H), (C, 3 * H), (H, 3 * H), (3 * H,), (3 * H,)]
    else:
        shapes = [(N, C), (N, C), (C, C), (C, C), (C,), (C, C), (C,)]
    args = _arrays(6, shapes)
    want = getattr(jrnn, cell)(*[jnp.asarray(a) for a in args])
    got = getattr(trnn, cell)(*[torch.from_numpy(a) for a in args])
    for g, w in zip(_flat(got), _flat(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=FWD_TOL,
                                   atol=FWD_TOL)


def test_a_chunked_sequence_equals_the_whole():
    """Carrying the final state into the next chunk gives the whole
    sequence's outputs (what rnnTimeStep and TBPTT rely on)."""
    wshapes = OPS["lstm"][0]
    x, *ws = _arrays(7, [(T, N, C)] + wshapes)
    tx, tws = torch.from_numpy(x), [torch.from_numpy(a) for a in ws]
    whole, _ = trnn.lstm(tx, *tws)
    a, (h, c) = trnn.lstm(tx[:3], *tws)
    b, _ = trnn.lstm(tx[3:], *tws, h0=h, c0=c)
    np.testing.assert_allclose(torch.cat([a, b]).numpy(), whole.numpy(),
                               rtol=FWD_TOL, atol=FWD_TOL)
