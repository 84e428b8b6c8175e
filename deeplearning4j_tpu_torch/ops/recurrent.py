"""Recurrent ops: LSTM, GRU, SRU and Elman cells and their sequence loops
(the port of ``deeplearning4j_tpu/ops/recurrent.py``).

Time-major ``[T, N, C]`` inside, as in the JAX package; the layers in
``nn.layers`` move DL4J's ``[N, C, T]`` to it and back. The JAX package
scans a step function with ``lax.scan``; here the loop over T is Python,
which a captured CUDA graph records launch by launch. The input
projection ``x @ w_ih`` (with its bias) of all T steps does not depend
on the carry, so it is one GEMM before the loop; only ``h @ w_hh`` stays
in it, fused with the add as one ``addmm``.

``reverse=True`` walks the steps from T-1 down to 0, as
``lax.scan(reverse=True)`` does: outputs stay in input order. Under a
``[T, N]`` mask a masked step carries the state through unchanged and
emits 0 (the reference's semantics: masked steps do not update state).

Gate orders are the JAX package's: LSTM ``[i, f, g, o]``, GRU ``[r, z,
n]``. ``torch.nn.LSTM`` is not used: it has two biases, and cuDNN's
packed sequences model only masks aligned to the left.
"""

from __future__ import annotations

from typing import Callable

import torch


def _order(T: int, reverse: bool):
    return range(T - 1, -1, -1) if reverse else range(T)


def _zeros(x_tnc, width: int):
    return torch.zeros((x_tnc.shape[1], width), dtype=x_tnc.dtype,
                       device=x_tnc.device)


def _masked(keep, new, old):
    """(the state carried through a masked step, the step's output);
    ``keep`` is the step's ``[N, 1]`` boolean mask."""
    new = torch.where(keep, new, old)
    return new, torch.where(keep, new, 0.0)


def _lstm_gates(gates, c):
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    c_new = f * c + i * torch.tanh(g)
    return o * torch.tanh(c_new), c_new


def lstm_cell(x, h, c, w_ih, w_hh, b):
    """One LSTM step, gate order ``[i, f, g, o]`` in the fused ``[.., 4H]``
    weights (ref: libnd4j ``lstmLayerCell``)."""
    return _lstm_gates(x @ w_ih + h @ w_hh + b, c)


def lstm(x_tnc, w_ih, w_hh, b, h0=None, c0=None, mask_tn=None,
         reverse: bool = False):
    """The LSTM over a sequence: ``x_tnc`` [T, N, C] -> (outputs [T, N,
    H], (hT, cT)); ``mask_tn`` [T, N] optional."""
    T = x_tnc.shape[0]
    H = w_hh.shape[0]
    h = h0 if h0 is not None else _zeros(x_tnc, H)
    c = c0 if c0 is not None else _zeros(x_tnc, H)
    xw = torch.matmul(x_tnc, w_ih) + b            # [T, N, 4H], hoisted
    outs = [None] * T
    for t in _order(T, reverse):
        h_new, c_new = _lstm_gates(torch.addmm(xw[t], h, w_hh), c)
        if mask_tn is not None:
            keep = mask_tn[t, :, None] > 0
            c = torch.where(keep, c_new, c)
            h, outs[t] = _masked(keep, h_new, h)
        else:
            h, c = h_new, c_new
            outs[t] = h
    return torch.stack(outs), (h, c)


def gru_cell(x, h, w_ih, w_hh, b_ih, b_hh):
    """One GRU step, gate order ``[r, z, n]`` (ref: libnd4j ``gruCell``)."""
    return _gru_gates(x @ w_ih + b_ih, torch.addmm(b_hh, h, w_hh), h)


def _gru_gates(gi, gh, h):
    i_r, i_z, i_n = gi.chunk(3, dim=-1)
    h_r, h_z, h_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(i_r + h_r)
    z = torch.sigmoid(i_z + h_z)
    n = torch.tanh(i_n + r * h_n)
    return (1.0 - z) * n + z * h


def gru(x_tnc, w_ih, w_hh, b_ih, b_hh, h0=None, mask_tn=None,
        reverse: bool = False):
    """The GRU over a sequence; the same mask semantics as :func:`lstm`.
    Returns (outputs [T, N, H], hT)."""
    T = x_tnc.shape[0]
    h = h0 if h0 is not None else _zeros(x_tnc, w_hh.shape[0])
    gi = torch.matmul(x_tnc, w_ih) + b_ih         # hoisted
    outs = [None] * T
    for t in _order(T, reverse):
        h_new = _gru_gates(gi[t], torch.addmm(b_hh, h, w_hh), h)
        if mask_tn is not None:
            h, outs[t] = _masked(mask_tn[t, :, None] > 0, h_new, h)
        else:
            h = outs[t] = h_new
    return torch.stack(outs), h


def sru_cell(x, c, w, w_f, b_f, w_r, b_r):
    """One SRU step (Lei et al. 2018; ref: libnd4j ``sru``)::

        x~ = x @ w;  f = sigmoid(x @ w_f + b_f);  r = sigmoid(x @ w_r + b_r)
        c' = f * c + (1 - f) * x~;  h = r * tanh(c') + (1 - r) * x
    """
    f = torch.sigmoid(x @ w_f + b_f)
    r = torch.sigmoid(x @ w_r + b_r)
    c_new = f * c + (1.0 - f) * (x @ w)
    return r * torch.tanh(c_new) + (1.0 - r) * x, c_new


def sru(x_tnc, w, w_f, b_f, w_r, b_r, c0=None, mask_tn=None,
        reverse: bool = False):
    """The SRU over a sequence: every projection is time-parallel, so all
    three are computed before the elementwise loop. Returns (outputs
    [T, N, H], cT)."""
    T = x_tnc.shape[0]
    c = c0 if c0 is not None else _zeros(x_tnc, w.shape[1])
    x_tilde = torch.matmul(x_tnc, w)
    f = torch.sigmoid(torch.matmul(x_tnc, w_f) + b_f)
    r = torch.sigmoid(torch.matmul(x_tnc, w_r) + b_r)
    outs = [None] * T
    for t in _order(T, reverse):
        c_new = f[t] * c + (1.0 - f[t]) * x_tilde[t]
        h = r[t] * torch.tanh(c_new) + (1.0 - r[t]) * x_tnc[t]
        if mask_tn is not None:
            keep = mask_tn[t, :, None] > 0
            c = torch.where(keep, c_new, c)
            outs[t] = torch.where(keep, h, 0.0)
        else:
            c, outs[t] = c_new, h
    return torch.stack(outs), c


def simple_rnn(x_tnc, w_ih, w_hh, b, h0=None, mask_tn=None,
               activation: Callable = torch.tanh, reverse: bool = False):
    """The Elman RNN over a sequence (ref: DL4J ``SimpleRnn``):
    ``h = act(x @ w_ih + h @ w_hh + b)``. Returns (outputs [T, N, H],
    hT)."""
    T = x_tnc.shape[0]
    h = h0 if h0 is not None else _zeros(x_tnc, w_hh.shape[0])
    xw = torch.matmul(x_tnc, w_ih) + b            # hoisted
    outs = [None] * T
    for t in _order(T, reverse):
        h_new = activation(torch.addmm(xw[t], h, w_hh))
        if mask_tn is not None:
            h, outs[t] = _masked(mask_tn[t, :, None] > 0, h_new, h)
        else:
            h = outs[t] = h_new
    return torch.stack(outs), h


def time_major(x, mask=None):
    """DL4J's ``[N, C, T]`` (and a ``[N, T]`` mask) as ``[T, N, C]`` (and
    ``[T, N]``); outputs go back with ``permute(1, 2, 0)``."""
    return x.permute(2, 0, 1), (None if mask is None else mask.t())
