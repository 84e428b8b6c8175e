"""Validation cases for the round-5 registry extension (``registry_r5``;
the port of ``deeplearning4j_tpu/ops/validation_r5.py``, case for case).
Same contract as ``validation._build_cases``: every op gets an
independent numpy golden where one exists + the float64 gradcheck where
differentiable."""

from __future__ import annotations

from typing import List

import numpy as np

from deeplearning4j_tpu_torch.ops import registry as R
from deeplearning4j_tpu_torch.ops.validation import (Key, OpCase, _r, _r2,
                                                     host_op)


def build_r5_cases() -> List[OpCase]:
    C: List[OpCase] = []

    def add(op, args, golden=None, grad=False, **kw):
        C.append(OpCase(op=op, args=args, golden=golden, grad=grad, **kw))

    # ---- legacy derivatives: FD-check against the registered forward ----
    def fd_of(fwd_name, eps=1e-3):
        fwd = host_op(fwd_name)

        def golden(x):
            return (np.asarray(fwd(x + eps), np.float64)
                    - np.asarray(fwd(x - eps), np.float64)) / (2 * eps)
        return golden

    for name, src in [
            ("tanh_derivative", "tanh"), ("relu_derivative", "relu"),
            ("softsign_derivative", "softsign"),
            ("softplus_derivative", "softplus"),
            ("elu_derivative", "elu"), ("selu_derivative", "selu"),
            ("cube_derivative", "cube"),
            ("rational_tanh_derivative", "rationaltanh"),
            ("rectified_tanh_derivative", "rectifiedtanh"),
            ("swish_derivative", "swish"), ("mish_derivative", "mish"),
            ("gelu_derivative", "gelu"),
            ("thresholdedrelu_derivative", "thresholdedrelu")]:
        # offset keeps FD probes away from the kink at 0
        add(name, lambda rng: (rng.randn(4, 5).astype(np.float32) * 2
                               + np.float32(0.13),),
            golden=fd_of(src), rtol=2e-2, atol=2e-3,
            note=f"central FD of the registered '{src}' forward")
    add("hardtanh_derivative",
        lambda rng: (np.asarray([[-2.0, -0.5, 0.5, 2.0]], np.float32),),
        golden=lambda x: np.where(np.abs(x) < 1, 1.0, 0.0).astype(np.float32))
    add("relu6_derivative",
        lambda rng: (np.asarray([[-1.0, 3.0, 7.0]], np.float32),),
        golden=lambda x: ((x > 0) & (x < 6)).astype(np.float32))
    add("leakyrelu_derivative",
        lambda rng: (np.asarray([[-2.0, 3.0]], np.float32),),
        kwargs={"alpha": 0.1},
        golden=lambda x, alpha=0.1: np.where(x > 0, 1.0, alpha)
        .astype(np.float32))
    add("sigm_derivative", _r(3, 4),
        golden=lambda x: (1 / (1 + np.exp(-x))) * (1 - 1 / (1 + np.exp(-x))),
        rtol=1e-3)
    add("softmax_derivative", _r(3, 4),
        golden=lambda x: (lambda s: s * (1 - s))(
            np.exp(x - x.max(-1, keepdims=True))
            / np.exp(x - x.max(-1, keepdims=True)).sum(-1, keepdims=True)),
        rtol=1e-3)
    add("pow_derivative", lambda rng: (rng.rand(3, 4).astype(np.float32)
                                       + 0.5, 3.0),
        golden=lambda x, p: p * x ** (p - 1), rtol=1e-3)

    # ---- legacy scalar transforms ----
    add("step", lambda rng: (np.asarray([-1.0, 0.0, 2.0], np.float32),),
        golden=lambda x: (x > 0).astype(np.float32))
    add("oneminus", _r(3, 4), golden=lambda x: 1 - x, grad=True)
    add("timesoneminus", _r(3, 4), golden=lambda x: x * (1 - x), grad=True)
    add("halve", _r(3, 4), golden=lambda x: x / 2, grad=True)
    add("twice", _r(3, 4), golden=lambda x: x * 2, grad=True)
    add("cbrt", lambda rng: (np.asarray([-8.0, 1.0, 27.0], np.float32),),
        golden=np.cbrt)
    add("log_x", lambda rng: (rng.rand(3, 4).astype(np.float32) + 0.5, 10.0),
        golden=lambda x, b: np.log(x) / np.log(np.float32(b)), rtol=1e-3)
    add("max_pairwise", _r2(3, 4), golden=np.maximum, grad=True)
    add("min_pairwise", _r2(3, 4), golden=np.minimum, grad=True)
    add("amax_pairwise", _r2(3, 4),
        golden=lambda a, b: np.where(np.abs(a) > np.abs(b), a, b))
    add("amin_pairwise", _r2(3, 4),
        golden=lambda a, b: np.where(np.abs(a) < np.abs(b), a, b))
    add("crelu", _r(3, 4),
        golden=lambda x: np.concatenate([np.maximum(x, 0),
                                         np.maximum(-x, 0)], -1), grad=True)
    add("crelu_bp", lambda rng: (rng.randn(3, 4).astype(np.float32) + 0.13,
                                 rng.randn(3, 8).astype(np.float32)),
        golden=lambda x, g: np.where(x > 0, g[:, :4], 0)
        - np.where(-x > 0, g[:, 4:], 0))
    add("clip_by_average_norm",
        lambda rng: (np.full((4, 4), 2.0, np.float32), 0.1),
        golden=lambda x, c: x * c / (np.sqrt((x ** 2).sum()) / x.size))

    # ---- shape / creation ----
    add("zeros", lambda rng: ((2, 3),),
        golden=lambda s: np.zeros(s, np.float32))
    add("ones", lambda rng: ((2, 3),),
        golden=lambda s: np.ones(s, np.float32))
    add("empty", lambda rng: ((2, 3),),
        golden=lambda s: np.zeros(s, np.float32),
        note="XLA has no uninitialized alloc; empty == zeros")
    add("size_at", lambda rng: (rng.randn(5, 7), 1),
        golden=lambda x, d: np.int64(x.shape[d]))
    add("batch_matmul", lambda rng: (rng.randn(2, 3, 4).astype(np.float32),
                                     rng.randn(2, 4, 5).astype(np.float32)),
        golden=np.matmul, grad=True, grad_arg_idx=(0, 1), rtol=1e-3)
    add("batched_matmul", lambda rng: (rng.randn(2, 3, 4).astype(np.float32),
                                       rng.randn(2, 4, 5).astype(np.float32)),
        golden=np.matmul, rtol=1e-3)
    add("matrix_exp", lambda rng: (rng.randn(3, 3).astype(np.float32) * 0.3,),
        golden=None, note="goldens live on the expm case (alias)")
    add("space_to_batch_nd", lambda rng: (rng.randn(1, 4, 4, 1)
                                          .astype(np.float32), 2),
        note="alias of space_to_batch (goldens there)")
    add("batch_to_space_nd", lambda rng: (rng.randn(4, 2, 2, 1)
                                          .astype(np.float32), 2),
        note="alias of batch_to_space (goldens there)")
    add("flatten", lambda rng: ([rng.randn(2, 3).astype(np.float32),
                                 rng.randn(4).astype(np.float32)],),
        golden=lambda xs: np.concatenate([xs[0].ravel(), xs[1].ravel()]))
    add("flatten", lambda rng: ([rng.randn(2, 3).astype(np.float32)],),
        kwargs={"order": "f"},
        golden=lambda xs, order="f": xs[0].ravel(order="F"))
    add("tile_to_shape", lambda rng: (rng.randn(1, 3).astype(np.float32),
                                      (4, 3)),
        golden=lambda x, s: np.broadcast_to(x, s))
    add("assign", lambda rng: (rng.randn(3, 4).astype(np.float32), 2.5),
        golden=lambda x, y: np.full_like(x, y))
    add("broadcast_dynamic_shape",
        lambda rng: (np.asarray([2, 1, 3], np.int64),
                     np.asarray([4, 1], np.int64)),
        golden=lambda a, b: np.asarray([2, 4, 3], np.int64))

    # ---- predicates ----
    add("is_non_decreasing",
        lambda rng: (np.asarray([1.0, 1.0, 2.0], np.float32),),
        golden=lambda x: np.bool_(True))
    add("is_strictly_increasing",
        lambda rng: (np.asarray([1.0, 1.0, 2.0], np.float32),),
        golden=lambda x: np.bool_(False))
    add("is_numeric_tensor", _r(2, 2), golden=lambda x: np.bool_(True))

    def choose_args(rng):
        return (np.asarray([3.0, -1.0, 5.0, 0.5], np.float32), 1.0)
    add("choose", choose_args,
        golden=lambda x, c: (np.asarray([3.0, 5.0, 0.0, 0.0], np.float32),
                             np.int64(2)),
        note="kept values compact to the front, zero padding, + count")

    # ---- image ----
    add("adjust_contrast_v2",
        lambda rng: (rng.rand(2, 4, 4, 3).astype(np.float32), 2.0),
        golden=lambda x, f: (x - x.mean((-3, -2), keepdims=True)) * f
        + x.mean((-3, -2), keepdims=True), rtol=1e-3)

    def dbb_args(rng):
        img = np.zeros((1, 8, 8, 3), np.float32)
        boxes = np.asarray([[[0.25, 0.25, 0.75, 0.75]]], np.float32)
        return (img, boxes)

    def np_dbb(img, boxes):
        # 0.25*(8-1)=1.75 -> edge pixel 2; 0.75*7=5.25 -> edge pixel 5
        out = img.copy()
        out[0, 2, 2:6, :] = 1.0
        out[0, 5, 2:6, :] = 1.0
        out[0, 2:6, 2, :] = 1.0
        out[0, 2:6, 5, :] = 1.0
        return out
    add("draw_bounding_boxes", dbb_args, golden=np_dbb)

    def nmso_args(rng):
        overlaps = np.asarray([[1.0, 0.9, 0.1],
                               [0.9, 1.0, 0.2],
                               [0.1, 0.2, 1.0]], np.float32)
        scores = np.asarray([0.9, 0.8, 0.7], np.float32)
        return (overlaps, scores, 3)
    add("non_max_suppression_overlaps", nmso_args,
        golden=lambda o, s, m: np.asarray([0, 2, -1], np.int32),
        note="box 1 suppressed by overlap 0.9 with box 0")

    # ---- random ----
    add("truncated_normal", lambda rng: (Key(0), (4000,)),
        golden=None,
        note="moment check: |mean| small, all samples within 2 sigma")
    add("random_truncated_normal",
        lambda rng: (Key(1), (64,)))
    add("binomial", lambda rng: (Key(2), (512,), 10, 0.5))
    add("random_binomial", lambda rng: (Key(3), (64,), 5, 0.3))
    add("log_normal", lambda rng: (Key(4), (512,)))
    add("random_lognormal", lambda rng: (Key(5), (64,)))

    # ---- linalg ----
    def spd_args(rng):
        a = rng.randn(4, 4).astype(np.float32)
        return (a @ a.T + 4 * np.eye(4, dtype=np.float32),)
    add("logdet", spd_args,
        golden=lambda a: np.linalg.slogdet(a.astype(np.float64))[1],
        rtol=1e-3)
    add("cholesky_solve", lambda rng: (spd_args(rng)[0],
                                       rng.randn(4, 2).astype(np.float32)),
        golden=lambda a, b: np.linalg.solve(a.astype(np.float64),
                                            b.astype(np.float64)),
        rtol=1e-2, atol=1e-3)

    # ---- casts ----
    for name, dt in [("to_double", np.float64), ("to_float16", np.float16),
                     ("to_float32", np.float32), ("to_int32", np.int32),
                     ("to_int64", np.int64), ("to_uint8", np.uint8)]:
        add(name, lambda rng: (np.asarray([1.0, 2.0, 3.9], np.float32),),
            golden=(lambda d: lambda x: x.astype(d))(dt))

    # ---- bitwise / hash ----
    add("bitwise_not", lambda rng: (np.asarray([0, 1, 255], np.int32),),
        golden=np.invert)
    add("bits_hamming_distance",
        lambda rng: (np.asarray([0b1010, 0b0001], np.int32),
                     np.asarray([0b0110, 0b0011], np.int32)),
        golden=lambda a, b: np.int64(3))
    add("hashcode", lambda rng: (np.asarray([1, 2, 3], np.int32),),
        golden=lambda x: np.int32((17 * 31 + 1) * 31 * 31
                                  + 2 * 31 + 3),
        note="Java-style h=31h+v over the flattened int32 view")

    # ---- recurrent aliases ----
    def lstm_cell_args(rng):
        N, C, H = 2, 3, 4
        return (rng.randn(N, C).astype(np.float32),
                rng.randn(N, H).astype(np.float32),
                rng.randn(N, H).astype(np.float32),
                rng.randn(C, 4 * H).astype(np.float32) * 0.3,
                rng.randn(H, 4 * H).astype(np.float32) * 0.3,
                np.zeros(4 * H, np.float32))
    add("lstmBlockCell", lstm_cell_args,
        note="alias of the lstmCell body (goldens on lstmCell)")

    def lstm_layer_args(rng):
        T, N, C, H = 3, 2, 3, 4
        return (rng.randn(T, N, C).astype(np.float32),
                rng.randn(C, 4 * H).astype(np.float32) * 0.3,
                rng.randn(H, 4 * H).astype(np.float32) * 0.3,
                np.zeros(4 * H, np.float32))
    add("lstm", lstm_layer_args, note="alias of lstmLayer")
    add("lstmBlock", lstm_layer_args, note="alias of lstmLayer")

    def sru_bi_args(rng):
        T, N, C = 3, 2, 4
        mk = lambda *s: rng.randn(*s).astype(np.float32) * 0.3
        one = lambda: (mk(C, C), mk(C, C), np.zeros(C, np.float32),
                       mk(C, C), np.zeros(C, np.float32))
        return (mk(T, N, C),) + one() + one()

    def np_sru_bi(x, *ws):
        got_f, _ = host_op("sru")(x, *ws[:5])
        got_b, _ = host_op("sru")(x, *ws[5:], reverse=True)
        return np.concatenate([np.asarray(got_f), np.asarray(got_b)], -1)
    add("sruBiDirectional", sru_bi_args, golden=np_sru_bi,
        note="fwd+reverse sru concat; sru itself carries the numpy golden")

    # ---- updater / norm bp ----
    add("apply_sgd", lambda rng: (rng.randn(3, 4).astype(np.float32),
                                  rng.randn(3, 4).astype(np.float32), 0.1),
        golden=lambda p, g, lr: p - lr * g)

    def fd_vjp(fwd, x, g, eps=1e-3):
        out = np.zeros_like(x)
        for i in range(x.size):
            xp = x.copy().ravel()
            xp[i] += eps
            fp = np.asarray(fwd(xp.reshape(x.shape)), np.float64)
            xp[i] -= 2 * eps
            fm = np.asarray(fwd(xp.reshape(x.shape)), np.float64)
            out.ravel()[i] = np.sum((fp - fm) / (2 * eps) * g)
        return out
    add("standardize_bp",
        lambda rng: (rng.randn(2, 6).astype(np.float32),
                     rng.randn(2, 6).astype(np.float32)),
        golden=lambda x, g: fd_vjp(
            lambda v: host_op("standardize")(v), x, g),
        rtol=2e-2, atol=2e-3)
    add("layer_norm_bp",
        lambda rng: (rng.randn(2, 6).astype(np.float32),
                     rng.rand(6).astype(np.float32) + 0.5,
                     rng.randn(6).astype(np.float32),
                     rng.randn(2, 6).astype(np.float32)),
        golden=None, note="vjp of the registered layer_norm; covered by "
                          "the layer_norm gradcheck")

    # ---- TensorList family (eager host-side VM state, like the ref) ----
    def _mk_list(rng):
        tl = R.get("create_list")()
        R.get("write_list")(tl, 0, rng.randn(2, 3).astype(np.float32))
        R.get("write_list")(tl, 1, rng.randn(2, 3).astype(np.float32))
        return tl

    add("create_list", lambda rng: (),
        golden=None, note="constructor; exercised by every other list case")
    add("write_list", lambda rng: (_mk_list(rng), 2,
                                   rng.randn(2, 3).astype(np.float32)))
    add("read_list", lambda rng: (_mk_list(rng), 1))
    add("size_list", lambda rng: (_mk_list(rng),),
        golden=lambda tl: np.int32(2))
    add("stack_list", lambda rng: (_mk_list(rng),))
    add("unstack_list", lambda rng: (rng.randn(3, 2).astype(np.float32),))
    add("split_list", lambda rng: (rng.randn(5, 2).astype(np.float32),
                                   [2, 3]))
    add("gather_list", lambda rng: (_mk_list(rng), [1, 0]))
    add("pick_list", lambda rng: (_mk_list(rng), [0, 0, 1]))
    add("scatter_list", lambda rng: ([1, 0],
                                     rng.randn(2, 4).astype(np.float32)))
    add("clone_list", lambda rng: (_mk_list(rng),))

    # late-r5 aliases: pinned to their primary op's behavior with one
    # direct case each (the primaries carry the full goldens)
    add("biasadd", lambda rng: (rng.randn(3, 4).astype(np.float32),
                                rng.randn(4).astype(np.float32)),
        golden=lambda x, b: x + b)
    add("norm1", _r(3, 4), golden=lambda x: np.abs(x).sum())
    add("norm2", _r(3, 4), golden=lambda x: np.sqrt((x ** 2).sum()),
        rtol=1e-3)
    add("normmax", _r(3, 4), golden=lambda x: np.abs(x).max())
    add("shift_bits", lambda rng: (np.asarray([1, 2], np.int32), 2),
        golden=np.left_shift)
    add("rshift_bits", lambda rng: (np.asarray([8, 16], np.int32), 2),
        golden=np.right_shift)
    add("solve_ls", lambda rng: (rng.randn(5, 3).astype(np.float32),
                                 rng.randn(5, 2).astype(np.float32)),
        golden=lambda a, b: np.linalg.lstsq(
            a.astype(np.float64), b.astype(np.float64), rcond=None)[0],
        rtol=1e-2, atol=1e-3)

    def bidir_args(rng):
        T, N, C, H = 3, 2, 3, 4
        mk = lambda *s: rng.randn(*s).astype(np.float32) * 0.3
        return (mk(T, N, C), mk(C, H), mk(H, H), np.zeros(H, np.float32),
                mk(C, H), mk(H, H), np.zeros(H, np.float32))
    add("static_bidirectional_rnn", bidir_args,
        note="alias of bidirectional_rnn (goldens there)")
    add("dynamic_bidirectional_rnn", bidir_args,
        note="alias of bidirectional_rnn (goldens there)")
    add("softmax_cross_entropy_loss_with_logits",
        lambda rng: (np.eye(3, dtype=np.float32)[[0, 2]],
                     rng.randn(2, 3).astype(np.float32)),
        note="alias of softmax_cross_entropy_loss")
    add("sigmoid_cross_entropy_loss_with_logits",
        lambda rng: (rng.randint(0, 2, (2, 3)).astype(np.float32),
                     rng.randn(2, 3).astype(np.float32)),
        note="alias of sigmoid_cross_entropy_loss")

    add("check_numerics", _r(3, 4), golden=lambda x: x)

    # ---- gradient-compression codecs (ref: threshold/bitmap encoding) ----
    def thresh_golden(x, t):
        """Round-trip semantic golden: decode(encode(x)) + residual == x
        and the count matches; returns the op's own outputs on success."""
        idx, signs, count, residual = host_op("encode_threshold")(x, t)
        dec = host_op("decode_threshold")(idx, signs, t, x.shape)
        np.testing.assert_allclose(dec + residual, x, rtol=1e-5, atol=1e-6)
        assert count == (np.abs(x) >= t).sum()
        return idx, signs, count, residual
    add("encode_threshold",
        lambda rng: (rng.randn(4, 5).astype(np.float32), 1.0),
        golden=thresh_golden)
    add("encode_threshold",
        lambda rng: (rng.randn(2, 2).astype(np.float32), 0.5),
        kwargs={"max_elements": 9},
        golden=lambda x, t, max_elements=None: thresh_golden(x, t),
        note="max_elements larger than the tensor clamps, not crashes")
    add("decode_threshold",
        lambda rng: tuple(host_op("encode_threshold")(
            rng.randn(4, 5).astype(np.float32), 1.0)[:2]) + (1.0, (4, 5)),
        golden=None,
        note="semantics pinned by thresh_golden on the encode cases")
    add("encode_bitmap",
        lambda rng: (rng.randn(4, 5).astype(np.float32), 0.7),
        golden=lambda x, t: (
            np.where(x.ravel() >= t, 1,
                     np.where(x.ravel() <= -t, 2, 0)).astype(np.uint8),
            (x.ravel() - np.where(x.ravel() >= t, t,
                                  np.where(x.ravel() <= -t, -t, 0.0))
             ).reshape(x.shape)))
    add("decode_bitmap",
        lambda rng: (np.asarray([0, 1, 2, 1], np.uint8), 0.5, (2, 2)),
        golden=lambda c, t, s: np.asarray([[0.0, 0.5], [-0.5, 0.5]],
                                          np.float32))

    return C
