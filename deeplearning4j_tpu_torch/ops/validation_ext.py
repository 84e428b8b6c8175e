"""Validation cases for the op-registry extension (``registry_ext``; the
port of ``deeplearning4j_tpu/ops/validation_ext.py``, case for case).

Same contract as ``validation._build_cases``: every op registered in
``registry_ext`` appears here with an independent numpy/scipy golden
where one exists, plus a float64 gradcheck for differentiable ops.
"""

from __future__ import annotations

from typing import List

import numpy as np

from deeplearning4j_tpu_torch.ops.normalization import StepKey
from deeplearning4j_tpu_torch.ops.validation import (Key, OpCase, _r, _r2,
                                                     _r2pos, host_op)


def _np_ctc_loss(labels, logits, label_lengths, logit_lengths, blank=0):
    """Reference DP (numpy, per batch item, O(T·L) like the op)."""
    def softmax(z):
        e = np.exp(z - z.max(-1, keepdims=True))
        return e / e.sum(-1, keepdims=True)

    out = []
    for b in range(labels.shape[0]):
        lab = labels[b][:label_lengths[b]]
        T = logit_lengths[b]
        p = softmax(logits[b].astype(np.float64))[:T]
        ext = [blank]
        for l in lab:
            ext += [int(l), blank]
        L = len(ext)
        alpha = np.zeros((T, L))
        alpha[0, 0] = p[0, blank]
        if L > 1:
            alpha[0, 1] = p[0, ext[1]]
        for t in range(1, T):
            for s in range(L):
                a = alpha[t - 1, s]
                if s >= 1:
                    a += alpha[t - 1, s - 1]
                if s >= 2 and ext[s] != blank and ext[s] != ext[s - 2]:
                    a += alpha[t - 1, s - 2]
                alpha[t, s] = a * p[t, ext[s]]
        tot = alpha[T - 1, L - 1] + (alpha[T - 1, L - 2] if L > 1 else 0.0)
        out.append(-np.log(max(tot, 1e-300)))
    return np.asarray(out, np.float32)


def _np_scatter_nd(indices, updates, shape):
    out = np.zeros(shape, updates.dtype)
    for j in range(indices.shape[0]):
        out[tuple(indices[j])] += updates[j]
    return out


def _np_adam(g, m, v, lr=0.001, b1=0.9, b2=0.999, eps=1e-8, t=0):
    m2 = b1 * m + (1 - b1) * g
    v2 = b2 * v + (1 - b2) * g * g
    alpha = lr * np.sqrt(1 - b2 ** (t + 1)) / (1 - b1 ** (t + 1))
    return alpha * m2 / (np.sqrt(v2) + eps), m2, v2


def build_ext_cases() -> List[OpCase]:
    C: List[OpCase] = []

    def add(op, args, golden=None, grad=False, **kw):
        C.append(OpCase(op=op, args=args, golden=golden, grad=grad, **kw))

    # ---- scatter_nd family ----
    def snd_args(rng):
        idx = rng.randint(0, 5, (6, 1)).astype(np.int32)
        upd = rng.randn(6, 3).astype(np.float32)
        return (idx, upd, (5, 3))
    add("scatter_nd", snd_args,
        golden=lambda idx, upd, shape: _np_scatter_nd(idx, upd, shape),
        grad=True, grad_arg_idx=(1,))

    def sref_args(rng):
        ref = rng.randn(5, 3).astype(np.float32)
        idx = rng.randint(0, 5, (4, 1)).astype(np.int32)
        upd = rng.randn(4, 3).astype(np.float32)
        return (ref, idx, upd)

    def np_nd(mode):
        def g(ref, idx, upd):
            out = ref.copy()
            for j in range(idx.shape[0]):
                i = tuple(idx[j])
                if mode == "add":
                    out[i] += upd[j]
                elif mode == "sub":
                    out[i] -= upd[j]
                else:
                    out[i] = upd[j]
            return out
        return g
    add("scatter_nd_add", sref_args, golden=np_nd("add"), grad=True,
        grad_arg_idx=(0, 2))
    add("scatter_nd_sub", sref_args, golden=np_nd("sub"), grad=True,
        grad_arg_idx=(0, 2))

    def sset_args(rng):
        ref = rng.randn(5, 3).astype(np.float32)
        idx = np.asarray([[0], [2], [4]], np.int32)   # unique (set semantics)
        upd = rng.randn(3, 3).astype(np.float32)
        return (ref, idx, upd)
    add("scatter_nd_update", sset_args, golden=np_nd("set"))

    def smul_args(rng):
        ref = rng.randn(5, 3).astype(np.float32)
        idx = np.asarray([0, 2, 4], np.int32)
        upd = rng.rand(3, 3).astype(np.float32) + 0.5
        return (ref, idx, upd)

    def np_rowwise(fn):
        def g(ref, idx, upd):
            out = ref.copy()
            for j, i in enumerate(idx):
                out[i] = fn(out[i], upd[j])
            return out
        return g
    add("scatter_mul", smul_args, golden=np_rowwise(lambda a, b: a * b))
    add("scatter_div", smul_args, golden=np_rowwise(lambda a, b: a / b))

    # ---- CTC ----
    def ctc_args(rng):
        labels = rng.randint(1, 5, (3, 3)).astype(np.int32)
        logits = rng.randn(3, 8, 6).astype(np.float32)
        # last item has an EMPTY label sequence (all-blank path only)
        lab_len = np.asarray([3, 2, 0], np.int32)
        log_len = np.asarray([8, 6, 5], np.int32)
        return (labels, logits, lab_len, log_len)
    add("ctc_loss", ctc_args, golden=_np_ctc_loss, grad=True,
        grad_arg_idx=(1,), rtol=1e-3)

    def ctc_dec_args(rng):
        return (rng.randn(2, 7, 5).astype(np.float32),
                np.asarray([7, 5], np.int32))

    def np_ctc_greedy(logits, lens, blank=0):
        B, T, _ = logits.shape
        dec = np.full((B, T), -1, np.int32)
        out_lens = np.zeros((B,), np.int32)
        for b in range(B):
            path = logits[b].argmax(-1)[:lens[b]]
            prev, res = -1, []
            for s in path:
                if s != prev and s != blank:
                    res.append(s)
                prev = s
            dec[b, :len(res)] = res
            out_lens[b] = len(res)
        return dec, out_lens
    add("ctc_greedy_decoder", ctc_dec_args, golden=np_ctc_greedy)

    # ---- updater ops (numpy goldens = the published formulas) ----
    add("sgd_updater", _r(4, 3), kwargs={"lr": 0.1},
        golden=lambda g, lr=0.1: lr * g)
    add("nesterovs_updater", _r2(4, 3), kwargs={"lr": 0.1, "momentum": 0.9},
        golden=lambda g, v, lr=0.1, momentum=0.9:
        (-(momentum * (momentum * v - lr * g) - lr * g),
         momentum * v - lr * g))

    def adam_args(rng):
        return (rng.randn(4, 3).astype(np.float32),
                np.abs(rng.randn(4, 3)).astype(np.float32) * 0.1,
                np.abs(rng.randn(4, 3)).astype(np.float32) * 0.1)
    add("adam_updater", adam_args, golden=lambda g, m, v: _np_adam(g, m, v),
        rtol=1e-3)

    def ams_args(rng):
        a = adam_args(rng)
        return a + (np.abs(rng.randn(4, 3)).astype(np.float32) * 0.1,)

    def np_ams(g, m, v, vh, lr=0.001, b1=0.9, b2=0.999, eps=1e-8):
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        vh2 = np.maximum(vh, v2)
        alpha = lr * np.sqrt(1 - b2) / (1 - b1)
        return alpha * m2 / (np.sqrt(vh2) + eps), m2, v2, vh2
    add("ams_grad_updater", ams_args, golden=np_ams, rtol=1e-3)

    def np_adamax(g, m, u, lr=0.001, b1=0.9, b2=0.999, eps=1e-8):
        m2 = b1 * m + (1 - b1) * g
        u2 = np.maximum(b2 * u, np.abs(g))
        return (lr / (1 - b1)) * m2 / (u2 + eps), m2, u2
    add("ada_max_updater", adam_args, golden=np_adamax, rtol=1e-3)

    def np_nadam(g, m, v, lr=0.001, b1=0.9, b2=0.999, eps=1e-8):
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        mh = m2 / (1 - b1)
        vh = v2 / (1 - b2)
        upd = lr * (b1 * mh + (1 - b1) * g / (1 - b1)) / (np.sqrt(vh) + eps)
        return upd, m2, v2
    add("nadam_updater", adam_args, golden=np_nadam, rtol=1e-3)

    add("rms_prop_updater",
        lambda rng: (rng.randn(4, 3).astype(np.float32),
                     np.abs(rng.randn(4, 3)).astype(np.float32) * 0.1),
        golden=lambda g, g2, lr=0.1, d=0.95, eps=1e-8:
        (lr * g / (np.sqrt(d * g2 + (1 - d) * g * g) + eps),
         d * g2 + (1 - d) * g * g), rtol=1e-3)
    add("ada_grad_updater",
        lambda rng: (rng.randn(4, 3).astype(np.float32),
                     np.abs(rng.randn(4, 3)).astype(np.float32) * 0.1),
        golden=lambda g, h, lr=0.1, eps=1e-6:
        (lr * g / (np.sqrt(h + g * g) + eps), h + g * g), rtol=1e-3)
    add("ada_delta_updater",
        lambda rng: (rng.randn(4, 3).astype(np.float32),
                     np.abs(rng.randn(4, 3)).astype(np.float32) * 0.1,
                     np.abs(rng.randn(4, 3)).astype(np.float32) * 0.1),
        golden=lambda g, eg2, ex2, rho=0.95, eps=1e-6:
        (g * np.sqrt(ex2 + eps) / np.sqrt(rho * eg2 + (1 - rho) * g * g + eps),
         rho * eg2 + (1 - rho) * g * g,
         rho * ex2 + (1 - rho) * (g * np.sqrt(ex2 + eps)
                                  / np.sqrt(rho * eg2 + (1 - rho) * g * g
                                            + eps)) ** 2), rtol=1e-3)

    # ---- merge ops ----
    def merge_args(rng):
        return ([rng.randn(3, 4).astype(np.float32) for _ in range(3)],)
    add("mergeadd", merge_args, golden=lambda xs: np.sum(xs, axis=0),
        grad=False)
    add("mergeavg", merge_args, golden=lambda xs: np.mean(xs, axis=0))
    add("mergemax", merge_args, golden=lambda xs: np.max(xs, axis=0))
    add("mergemaxindex", merge_args,
        golden=lambda xs: np.argmax(np.stack(xs), axis=0).astype(np.int32))
    add("add_n", merge_args, golden=lambda xs: np.sum(xs, axis=0))
    add("accumulate_n", merge_args, golden=lambda xs: np.sum(xs, axis=0))

    # ---- pairwise extras ----
    add("divide_no_nan",
        lambda rng: (rng.randn(3, 4).astype(np.float32),
                     np.concatenate([np.zeros((1, 4), np.float32),
                                     rng.rand(2, 4).astype(np.float32) + 0.5])),
        golden=lambda a, b: np.where(b == 0, 0.0,
                                     a / np.where(b == 0, 1.0, b)))
    add("truncatediv", _r2pos(3, 4),
        golden=lambda a, b: np.trunc(a / b))
    add("floormod", _r2pos(3, 4), golden=np.mod, grad=False)
    add("floormod",
        lambda rng: (np.asarray([7, -7, 9 ** 9], np.int64),
                     np.asarray([3, 3, 7], np.int64)),
        golden=np.mod, grad=False,
        note="integer inputs stay integral (exact for large ints)")
    add("squared_difference", _r2(3, 4), golden=lambda a, b: (a - b) ** 2,
        grad=True)
    add("select", lambda rng: (rng.rand(3, 4) > 0.5,
                               rng.randn(3, 4).astype(np.float32),
                               rng.randn(3, 4).astype(np.float32)),
        golden=np.where)
    add("stop_gradient", _r(3, 4), golden=lambda x: x)
    add("eps", lambda rng: (np.asarray([1.0, 2.0, 3.0], np.float32),
                            np.asarray([1.0, 2.0000001, 4.0], np.float32)),
        golden=lambda a, b, eps=1e-5: np.abs(a - b) < eps)
    add("replace_nans",
        lambda rng: (np.asarray([1.0, np.nan, 3.0], np.float32),),
        kwargs={"value": 7.0},
        golden=lambda x, value=7.0: np.where(np.isnan(x), value, x))
    add("compare_and_set", lambda rng: (np.asarray([1., 2., 3.], np.float32),),
        kwargs={"compare": 2.0, "set_value": 9.0},
        golden=lambda x, compare=2.0, set_value=9.0:
        np.where(np.abs(x - compare) < 1e-6, set_value, x))

    def mc_args(rng):
        from deeplearning4j_tpu_torch.linalg.conditions import Conditions
        return (rng.randn(5, 5).astype(np.float32), Conditions.greaterThan(0.0))
    add("match_condition", mc_args,
        golden=lambda x, cond: np.sum(x > 0.0).astype(np.int64))

    # ---- reductions ----
    add("reduce_variance", _r(3, 4), kwargs={"axis": 1},
        golden=lambda x, axis=1: np.var(x, axis=axis), grad=True)
    add("reduce_stdev", _r(3, 4), kwargs={"axis": 1},
        golden=lambda x, axis=1: np.std(x, axis=axis), grad=True)
    add("reduce_amax", _r(3, 4), kwargs={"axis": 1},
        golden=lambda x, axis=1: np.max(np.abs(x), axis=axis))
    add("reduce_amin", _r(3, 4), kwargs={"axis": 1},
        golden=lambda x, axis=1: np.min(np.abs(x), axis=axis))
    add("reduce_asum", _r(3, 4), kwargs={"axis": 1},
        golden=lambda x, axis=1: np.sum(np.abs(x), axis=axis), grad=True)
    add("reduce_amean", _r(3, 4), kwargs={"axis": 1},
        golden=lambda x, axis=1: np.mean(np.abs(x), axis=axis), grad=True)

    def prob_args(rng):
        p = rng.rand(3, 4).astype(np.float32) + 0.1
        return (p / p.sum(-1, keepdims=True),)
    add("entropy", prob_args, kwargs={"axis": 1},
        golden=lambda x, axis=1: -np.sum(x * np.log(x), axis=axis), grad=True)
    add("log_entropy", prob_args, kwargs={"axis": 1},
        golden=lambda x, axis=1: np.log(-np.sum(x * np.log(x), axis=axis)))
    add("shannonentropy", prob_args, kwargs={"axis": 1},
        golden=lambda x, axis=1: -np.sum(x * np.log2(x), axis=axis))

    # ---- shape/build extras ----
    add("broadcast_to", lambda rng: (rng.randn(1, 4).astype(np.float32),),
        kwargs={"shape": (3, 4)},
        golden=lambda x, shape=(3, 4): np.broadcast_to(x, shape))
    add("zeros_as", _r(3, 4), golden=np.zeros_like)
    add("ones_as", _r(3, 4), golden=np.ones_like)
    add("lin_space", lambda rng: (0.0, 1.0, 5),
        golden=lambda a, b, n: np.linspace(a, b, n, dtype=np.float32))
    add("tensormmul", _r2(4, 4),
        golden=lambda a, b: np.tensordot(a, b, axes=2), grad=True)
    add("multinomial",
        lambda rng: (Key(0),
                     np.log(np.asarray([[0.2, 0.3, 0.5]], np.float32)), 64))
    add("matrix_diag_part", _r(4, 4), golden=np.diagonal)
    add("parallel_stack", merge_args, golden=lambda xs: np.stack(xs))
    import scipy.special as sp
    add("precise_gelu", _r(3, 4),
        golden=lambda x: 0.5 * x * (1 + sp.erf(x / np.sqrt(2))), grad=True)
    add("softmin", _r(3, 4),
        golden=lambda x: (lambda e: e / e.sum(-1, keepdims=True))(
            np.exp(-x + (-x).max(-1, keepdims=True) * 0)), rtol=1e-3,
        grad=True)
    add("hardswish", _r(3, 4),
        golden=lambda x: x * np.clip(x / 6 + 0.5, 0, 1), grad=True)
    add("unique_with_counts",
        lambda rng: (np.asarray([3, 1, 3, 2, 1, 3], np.int32),),
        golden=lambda x: tuple(
            a.astype(b) for a, b in zip(
                np.unique(x, return_inverse=True, return_counts=True),
                (np.int32, np.int32, np.int32))))
    add("invert_permutation", lambda rng: (np.asarray([2, 0, 1, 3], np.int32),),
        golden=lambda p: np.argsort(p).astype(np.int32))
    add("bitcast", lambda rng: (np.asarray([1.0, -2.0], np.float32),),
        kwargs={"dtype": np.int32},
        golden=lambda x, dtype=None: x.view(np.int32))
    add("matrix_set_diag", lambda rng: (rng.randn(4, 4).astype(np.float32),
                                        rng.randn(4).astype(np.float32)),
        golden=lambda x, d: x - np.diag(np.diag(x)) + np.diag(d), grad=True,
        grad_arg_idx=(0, 1))
    add("toggle_bits", lambda rng: (np.asarray([0, 1, 255], np.int32),),
        golden=np.invert)
    def np_rot(x, n, left):
        width = x.dtype.itemsize * 8
        ux = x.astype(np.dtype(f"uint{width}"))
        n = n % width
        comp = (width - n) % width
        lo, hi = (n, comp) if left else (comp, n)
        return np.bitwise_or(np.left_shift(ux, lo),
                             np.right_shift(ux, hi)).astype(x.dtype)
    add("cyclic_shift_bits",
        lambda rng: (np.asarray([1, 2, 4], np.int32), 3),
        golden=lambda x, n: np_rot(x, n, True))
    add("cyclic_rshift_bits",
        lambda rng: (np.asarray([8, 16, 32], np.int32), 3),
        golden=lambda x, n: np_rot(x, n, False))
    add("cyclic_shift_bits",
        lambda rng: (np.asarray([1, -128, 77], np.int8), 2),
        golden=lambda x, n: np_rot(x, n, True),
        note="width derived from dtype (8-bit rotation, not 32)")
    add("cyclic_rshift_bits",
        lambda rng: (np.asarray([1, 1000, -5], np.int16), 0),
        golden=lambda x, n: np_rot(x, n, False),
        note="n==0 is identity, no out-of-range shift")

    # ---- linalg ----
    def spd_args(rng):
        a = rng.randn(4, 4).astype(np.float32)
        return (a @ a.T + 4 * np.eye(4, dtype=np.float32),
                rng.randn(4, 2).astype(np.float32))
    add("lu_solve", spd_args, golden=lambda a, b: np.linalg.solve(a, b),
        rtol=1e-3)

    # ---- moments/norm ----
    add("normalize_moments",
        lambda rng: (np.float32(10.0), rng.randn(4).astype(np.float32) * 10,
                     np.abs(rng.randn(4)).astype(np.float32) * 100 + 50),
        golden=lambda c, ms, vs: (ms / c, vs / c - (ms / c) ** 2))
    add("sufficient_statistics", lambda rng: (rng.randn(3, 4, 5)
                                              .astype(np.float32),),
        kwargs={"axes": (0, 1)},
        golden=lambda x, axes=(0, 1): (np.float32(12.0),
                                       np.sum(x, axis=axes),
                                       np.sum(x * x, axis=axes)))

    def fbn_args(rng):
        return (rng.randn(2, 4, 4, 3).astype(np.float32),
                rng.rand(3).astype(np.float32) + 0.5,
                rng.randn(3).astype(np.float32))

    def np_fbn(x, scale, offset, epsilon=1e-3):
        m = x.mean(axis=(0, 1, 2))
        v = x.var(axis=(0, 1, 2))
        y = (x - m) / np.sqrt(v + epsilon) * scale + offset
        return y, m, v
    add("fused_batch_norm", fbn_args, golden=np_fbn, rtol=1e-3,
        grad=True, grad_arg_idx=(0, 1, 2))

    # ---- conv/pool extras ----
    add("maxpool1d", lambda rng: (rng.randn(2, 3, 8).astype(np.float32),),
        kwargs={"kernel": 2},
        golden=lambda x, kernel=2: x.reshape(2, 3, 4, 2).max(-1), grad=True)
    add("avgpool1d", lambda rng: (rng.randn(2, 3, 8).astype(np.float32),),
        kwargs={"kernel": 2},
        golden=lambda x, kernel=2: x.reshape(2, 3, 4, 2).mean(-1), grad=True)
    add("upsampling3d", lambda rng: (rng.randn(1, 2, 2, 3, 4)
                                     .astype(np.float32),),
        kwargs={"scale": 2},
        golden=lambda x, scale=2: x.repeat(2, 2).repeat(2, 3).repeat(2, 4),
        grad=True)

    def deconv3_args(rng):
        return (rng.randn(1, 2, 3, 3, 3).astype(np.float32),
                rng.randn(4, 2, 2, 2, 2).astype(np.float32) * 0.1)
    add("deconv3d", deconv3_args, grad=True, grad_arg_idx=(0, 1),
        note="shape+grad check; conv3d itself carries the numeric golden")

    def dil_args(rng):
        return (rng.randn(1, 6, 6, 2).astype(np.float32),
                rng.randn(3, 3, 2).astype(np.float32) * 0.1)

    def np_dilation2d(x, f):
        n, h, w, c = x.shape
        kh, kw, _ = f.shape
        oh, ow = h - kh + 1, w - kw + 1
        out = np.full((n, oh, ow, c), -np.inf, np.float32)
        for i in range(kh):
            for j in range(kw):
                out = np.maximum(out, x[:, i:i + oh, j:j + ow, :] + f[i, j])
        return out
    add("dilation2d", dil_args, golden=np_dilation2d, grad=True)

    def col2im_args(rng):
        x = rng.randn(1, 2, 6, 6).astype(np.float32)
        cols = host_op("im2col")(x, kernel=3, stride=1)
        return (cols,)
    add("col2im", col2im_args, kwargs={"h": 6, "w": 6},
        note="roundtrip: im2col -> col2im scatter-adds patch overlaps",
        golden=None, grad=True)

    def mpa_args(rng):
        return (rng.randn(1, 4, 4, 2).astype(np.float32),)

    def np_mpa(x):
        n, h, w, c = x.shape
        oh, ow = h // 2, w // 2
        pooled = np.zeros((n, oh, ow, c), np.float32)
        arg = np.zeros((n, oh, ow, c), np.int32)
        for y in range(oh):
            for xx in range(ow):
                win = x[:, 2 * y:2 * y + 2, 2 * xx:2 * xx + 2, :]
                pooled[:, y, xx] = win.max((1, 2))
                for b in range(n):
                    for ch in range(c):
                        i = np.argmax(win[b, :, :, ch])
                        yy, xj = divmod(i, 2)
                        arg[b, y, xx, ch] = ((2 * y + yy) * w
                                             + (2 * xx + xj)) * c + ch
        return pooled, arg
    add("max_pool_with_argmax", mpa_args, golden=np_mpa)

    # ---- losses ----
    def mpw_args(rng):
        return (rng.randn(3, 4).astype(np.float32),
                rng.randn(3, 4).astype(np.float32))

    def np_mpw2(labels, preds):
        d = (preds - labels).reshape(labels.shape[0], -1)
        per = []
        for row in d:
            m = len(row)
            s = sum((row[i] - row[j]) ** 2
                    for i in range(m) for j in range(i + 1, m))
            per.append(s / (2.0 * (m * (m - 1) / 2)))
        return np.float32(np.mean(per))
    add("mean_pairwssqerr_loss", mpw_args, golden=np_mpw2, grad=True,
        grad_arg_idx=(1,), rtol=1e-3)

    # ---- sparse ----
    add("sparse_to_dense",
        lambda rng: (np.asarray([[0, 1], [2, 3]], np.int32), (3, 4),
                     np.asarray([5.0, 7.0], np.float32)),
        golden=lambda idx, shape, vals: (
            lambda o: (o.__setitem__((0, 1), 5.0),
                       o.__setitem__((2, 3), 7.0), o)[-1])(
            np.zeros(shape, np.float32)))

    def stdm_args(rng):
        idx = np.asarray([[0, 0], [1, 2], [2, 1]], np.int32)
        vals = rng.randn(3).astype(np.float32)
        b = rng.randn(3, 4).astype(np.float32)
        return (idx, vals, (3, 3), b)

    def np_stdm(idx, vals, shape, b):
        a = np.zeros(shape, np.float32)
        for (i, j), v in zip(idx, vals):
            a[i, j] += v
        return a @ b
    add("sparse_tensor_dense_matmul", stdm_args, golden=np_stdm, grad=True,
        grad_arg_idx=(1, 3))

    # ---- image extras ----
    def img_args(rng):
        return (rng.rand(2, 4, 4, 3).astype(np.float32),)
    add("adjust_hue", lambda rng: img_args(rng) + (0.25,),
        note="hsv roundtrip; rgb_to_hsv/hsv_to_rgb carry the goldens")
    add("adjust_saturation", lambda rng: img_args(rng) + (0.5,))
    add("rgb_to_yiq", img_args,
        golden=lambda x: x @ np.asarray(
            [[0.299, 0.59590059, 0.21153661],
             [0.587, -0.27455667, -0.52273617],
             [0.114, -0.32134392, 0.31119955]], np.float32))
    add("yiq_to_rgb", img_args,
        golden=lambda x: x @ np.asarray(
            [[1.0, 1.0, 1.0],
             [0.95598634, -0.27201283, -1.10674021],
             [0.6208248, -0.64720424, 1.70423049]], np.float32), rtol=1e-3)
    add("resize_bicubic", lambda rng: (rng.rand(1, 4, 4, 2)
                                       .astype(np.float32), (8, 8)))
    add("resize_area", lambda rng: (rng.rand(1, 4, 4, 2)
                                    .astype(np.float32), (2, 2)),
        golden=lambda x, size: x.reshape(1, 2, 2, 2, 2, 2).mean((2, 4)),
        note="true area averaging: 2x downscale == 2x2 mean pooling")
    add("image_resize", lambda rng: (rng.rand(1, 4, 4, 2)
                                     .astype(np.float32), (8, 8)),
        kwargs={"method": "nearest"},
        golden=lambda x, size, method=None: x.repeat(2, 1).repeat(2, 2))

    def car_args(rng):
        img = rng.rand(2, 8, 8, 1).astype(np.float32)
        boxes = np.asarray([[0.0, 0.0, 1.0, 1.0], [0.25, 0.25, 0.75, 0.75]],
                           np.float32)
        return (img, boxes, np.asarray([0, 1], np.int32), (4, 4))
    add("crop_and_resize", car_args,
        note="identity box = bilinear resample of the full image")

    def car_tf_args(rng):
        img = rng.rand(1, 8, 8, 1).astype(np.float32)
        # box 0: crop dim 1 → TF samples the box CENTER; box 1: fully
        # outside the image → every sample takes extrapolation_value
        boxes = np.asarray([[0.25, 0.25, 0.75, 0.75],
                            [1.5, 1.5, 2.0, 2.0]], np.float32)
        return (img, boxes, np.asarray([0, 0], np.int32), (1, 1))

    def np_car_tf(img, boxes, bi, size):
        h, w = img.shape[1:3]
        out = np.zeros((len(boxes), 1, 1, img.shape[-1]), np.float32)
        for k, (y1, x1, y2, x2) in enumerate(boxes):
            y = 0.5 * (y1 + y2) * (h - 1)
            x = 0.5 * (x1 + x2) * (w - 1)
            if 0 <= y <= h - 1 and 0 <= x <= w - 1:
                y0, x0 = int(np.floor(y)), int(np.floor(x))
                y1i, x1i = min(y0 + 1, h - 1), min(x0 + 1, w - 1)
                wy, wx = y - y0, x - x0
                im = img[bi[k]]
                out[k, 0, 0] = (im[y0, x0] * (1 - wy) * (1 - wx)
                                + im[y0, x1i] * (1 - wy) * wx
                                + im[y1i, x0] * wy * (1 - wx)
                                + im[y1i, x1i] * wy * wx)
        return out
    add("crop_and_resize", car_tf_args, golden=np_car_tf,
        note="TF formula: dim-1 crops sample box center; out-of-image "
             "boxes take extrapolation_value")

    add("random_crop", lambda rng: (Key(3),
                                    rng.rand(6, 6, 3).astype(np.float32),
                                    (4, 4, 3)))

    # ---- dropout variants / noise ----
    add("alpha_dropout", lambda rng: (StepKey(0, 0),
                                      rng.randn(64, 64).astype(np.float32),
                                      0.3))
    add("gaussian_dropout", lambda rng: (StepKey(0, 0),
                                         rng.randn(64, 64).astype(np.float32),
                                         0.3))
    add("gaussian_noise", lambda rng: (StepKey(0, 0),
                                       rng.randn(64, 64).astype(np.float32),
                                       0.1))

    # ---- nlp step ops ----
    def sg_args(rng):
        syn0 = rng.randn(10, 4).astype(np.float32) * 0.1
        syn1 = rng.randn(10, 4).astype(np.float32) * 0.1
        center = np.int32(2)
        targets = np.asarray([5, 1, 7], np.int32)
        labels = np.asarray([1.0, 0.0, 0.0], np.float32)
        return (syn0, syn1, center, targets, labels, 0.05)

    def np_skipgram(syn0, syn1, center, targets, labels, lr):
        s0, s1 = syn0.copy(), syn1.copy()
        v_in = s0[center]
        v_out = s1[targets]
        score = 1 / (1 + np.exp(-(v_out @ v_in)))
        g = (labels - score) * lr
        for k, t in enumerate(targets):
            s1[t] += g[k] * v_in
        s0[center] += g @ v_out
        return s0, s1
    add("skipgram", sg_args, golden=np_skipgram, rtol=1e-4)

    def cbow_args(rng):
        syn0 = rng.randn(10, 4).astype(np.float32) * 0.1
        syn1 = rng.randn(10, 4).astype(np.float32) * 0.1
        ctx = np.asarray([1, 3, 4], np.int32)
        targets = np.asarray([5, 2, 8], np.int32)
        labels = np.asarray([1.0, 0.0, 0.0], np.float32)
        return (syn0, syn1, ctx, targets, labels, 0.05)

    def np_cbow(syn0, syn1, ctx, targets, labels, lr):
        s0, s1 = syn0.copy(), syn1.copy()
        v_ctx = s0[ctx].mean(0)
        v_out = s1[targets]
        score = 1 / (1 + np.exp(-(v_out @ v_ctx)))
        g = (labels - score) * lr
        for k, t in enumerate(targets):
            s1[t] += g[k] * v_ctx
        gc = (g @ v_out) / len(ctx)
        for c in ctx:
            s0[c] += gc
        return s0, s1
    add("cbow", cbow_args, golden=np_cbow, rtol=1e-4)

    # ---- RNN wrappers ----
    def rnn_args(rng):
        T, N, C, H = 5, 2, 3, 4
        return (rng.randn(N, T, C).astype(np.float32),
                rng.randn(C, 4 * H).astype(np.float32) * 0.3,
                rng.randn(H, 4 * H).astype(np.float32) * 0.3,
                np.zeros((4 * H,), np.float32))
    add("dynamic_rnn", rnn_args, grad=True, grad_arg_idx=(0, 1, 2),
        note="lstm core carries the cell golden; batch-major wrapper")

    def srnn_args(rng):
        a = rnn_args(rng)
        return (np.moveaxis(a[0], 0, 1),) + a[1:]
    add("static_rnn", srnn_args, grad=True, grad_arg_idx=(0,))

    def birnn_args(rng):
        a = srnn_args(rng)
        rng2 = np.random.RandomState(7)
        return a + (rng2.randn(*a[1].shape).astype(np.float32) * 0.3,
                    rng2.randn(*a[2].shape).astype(np.float32) * 0.3,
                    np.zeros_like(a[3]))
    add("bidirectional_rnn", birnn_args, grad=True, grad_arg_idx=(0,))

    return C
