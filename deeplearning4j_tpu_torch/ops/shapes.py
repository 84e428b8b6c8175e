"""Per-op shape functions + argument validation (the port of
``deeplearning4j_tpu/ops/shapes.py``).

Reference parity: every libnd4j ``DeclarableOp`` carries a shape function
(``calculateOutputShape``) used for (a) op-level input validation with
readable errors and (b) graph shape inference without executing kernels.

Two tiers, as in the JAX package:
- ``SHAPE_FNS`` — hand-written shape rules for the families where
  op-level error messages matter (conv/pool/rnn/linalg/nn): they verify
  ranks/dims and raise :class:`OpShapeError` with the op's own contract
  in the message (``Conv2D: expected NCHW [N,C,H,W], got rank 3``), the
  JAX package's messages word for word.
- everything else — the generic registry op run on ``torch.device("meta")``
  tensors: shape propagation only, no memory, no kernel, no device (the
  JAX package's ``jax.eval_shape``). The generic op, not a platform
  override: a kernel has no meta implementation, and the shape is the
  generic op's. An op whose output shape depends on the data (``unique``,
  one-argument ``where``) cannot answer on meta tensors and raises, as
  ``jax.eval_shape`` does.

API:
    infer_shape(op, *arg_shapes, **kwargs) -> shape or tuple of shapes
    check_call(op, *args, **kwargs)        -> validates real arrays cheaply
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import registry as R
from deeplearning4j_tpu_torch.ops.convolution import conv_output_size


class OpShapeError(ValueError):
    """Bad input rank/dims for an op — the message carries the op's
    input contract (ref: libnd4j REQUIRE_TRUE messages in shape fns)."""


Shape = Tuple[int, ...]


def _as_shape(x) -> Shape:
    if hasattr(x, "shape"):
        return tuple(x.shape)
    return tuple(int(d) for d in x)


def _require(cond, op, msg):
    if not cond:
        raise OpShapeError(f"{op}: {msg}")


# --------------------------------------------------------------- conv family

def _conv2d_shape(x, w, b=None, *, stride=1, pad=0, dilation=1,
                  mode="truncate", data_format="NCHW", groups=1, **_):
    x, w = _as_shape(x), _as_shape(w)
    fmt = data_format.upper()
    cf = fmt.startswith("NC")
    _require(len(x) == 4, "Conv2D",
             f"expected {'NCHW' if cf else 'NHWC'} "
             f"[N,{'C,H,W' if cf else 'H,W,C'}], got rank {len(x)}")
    _require(len(w) == 4, "Conv2D",
             f"weights must be [outC, inC/groups, kH, kW], got rank {len(w)}")
    c_in = x[1] if cf else x[3]
    _require(w[1] * groups == c_in, "Conv2D",
             f"input has {c_in} channels but weights expect "
             f"{w[1] * groups} (w[1]={w[1]} x groups={groups})")
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    p = (pad, pad) if isinstance(pad, int) else tuple(pad)
    d = (dilation, dilation) if isinstance(dilation, int) else tuple(dilation)
    h, wd = (x[2], x[3]) if cf else (x[1], x[2])
    oh = conv_output_size(h, w[2], s[0], p[0], d[0], mode)
    ow = conv_output_size(wd, w[3], s[1], p[1], d[1], mode)
    return (x[0], w[0], oh, ow) if cf else (x[0], oh, ow, w[0])


def _conv1d_shape(x, w, b=None, *, stride=1, pad=0, dilation=1,
                  mode="truncate", data_format="NCW", groups=1, **_):
    x, w = _as_shape(x), _as_shape(w)
    cf = data_format.upper().startswith("NC")
    _require(len(x) == 3, "Conv1D",
             f"expected {'NCW' if cf else 'NWC'} rank-3 input, got rank {len(x)}")
    c_in = x[1] if cf else x[2]
    _require(w[1] * groups == c_in, "Conv1D",
             f"input has {c_in} channels but weights expect "
             f"{w[1] * groups} (w[1]={w[1]} x groups={groups})")
    t = x[2] if cf else x[1]
    ot = conv_output_size(t, w[2], stride, pad, dilation, mode)
    return (x[0], w[0], ot) if cf else (x[0], ot, w[0])


def _conv3d_shape(x, w, b=None, *, stride=1, pad=0, dilation=1,
                  mode="truncate", data_format="NCDHW", **_):
    x, w = _as_shape(x), _as_shape(w)
    cf = data_format.upper().startswith("NC")
    _require(len(x) == 5, "Conv3D",
             f"expected {'NCDHW' if cf else 'NDHWC'} rank-5 input, "
             f"got rank {len(x)}")
    c_in = x[1] if cf else x[4]
    _require(w[1] == c_in, "Conv3D",
             f"input has {c_in} channels but weights expect {w[1]}")
    s = (stride,) * 3 if isinstance(stride, int) else tuple(stride)
    p = (pad,) * 3 if isinstance(pad, int) else tuple(pad)
    d = (dilation,) * 3 if isinstance(dilation, int) else tuple(dilation)
    sp = x[2:5] if cf else x[1:4]
    out = tuple(conv_output_size(sp[i], w[2 + i], s[i], p[i], d[i], mode)
                for i in range(3))
    return (x[0], w[0]) + out if cf else (x[0],) + out + (w[0],)


def _pool2d_shape(op_name):
    def fn(x, *, kernel, stride=None, pad=0, mode="truncate",
           data_format="NCHW", **_):
        x = _as_shape(x)
        cf = data_format.upper().startswith("NC")
        _require(len(x) == 4, op_name,
                 f"expected {'NCHW' if cf else 'NHWC'} rank-4 input, "
                 f"got rank {len(x)}")
        k = (kernel, kernel) if isinstance(kernel, int) else tuple(kernel)
        s = k if stride is None else (
            (stride, stride) if isinstance(stride, int) else tuple(stride))
        p = (pad, pad) if isinstance(pad, int) else tuple(pad)
        h, w = (x[2], x[3]) if cf else (x[1], x[2])
        oh = conv_output_size(h, k[0], s[0], p[0], 1, mode)
        ow = conv_output_size(w, k[1], s[1], p[1], 1, mode)
        return (x[0], x[1], oh, ow) if cf else (x[0], oh, ow, x[3])
    return fn


def _deconv2d_shape(x, w, b=None, *, stride=1, pad=0, mode="truncate",
                    data_format="NCHW", **_):
    x, w = _as_shape(x), _as_shape(w)
    cf = data_format.upper().startswith("NC")
    _require(len(x) == 4, "Deconv2D",
             f"expected rank-4 input, got rank {len(x)}")
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    p = (pad, pad) if isinstance(pad, int) else tuple(pad)
    h, wd = (x[2], x[3]) if cf else (x[1], x[2])
    if mode.lower() == "same":
        oh, ow = h * s[0], wd * s[1]
    else:
        oh = (h - 1) * s[0] + w[2] - 2 * p[0]
        ow = (wd - 1) * s[1] + w[3] - 2 * p[1]
    return (x[0], w[0], oh, ow) if cf else (x[0], oh, ow, w[0])


# ---------------------------------------------------------------- nn family

def _matmul_shape(a, b, transpose_a=False, transpose_b=False, **_):
    a, b = _as_shape(a), _as_shape(b)
    _require(len(a) >= 2 and len(b) >= 2, "MatMul",
             f"needs rank>=2 operands, got ranks {len(a)}, {len(b)}")
    am = a[:-2] + ((a[-1], a[-2]) if transpose_a else (a[-2], a[-1]))
    bm = b[:-2] + ((b[-1], b[-2]) if transpose_b else (b[-2], b[-1]))
    _require(am[-1] == bm[-2], "MatMul",
             f"inner dims mismatch: [...,{am[-2]},{am[-1]}] x "
             f"[...,{bm[-2]},{bm[-1]}]")
    batch = np.broadcast_shapes(am[:-2], bm[:-2])
    return tuple(batch) + (am[-2], bm[-1])


def _xw_plus_b_shape(x, w, b, **_):
    x, w, b = _as_shape(x), _as_shape(w), _as_shape(b)
    _require(x[-1] == w[0], "XwPlusB",
             f"x feature dim {x[-1]} != w rows {w[0]}")
    _require(b[-1] == w[1], "XwPlusB", f"bias dim {b[-1]} != w cols {w[1]}")
    return x[:-1] + (w[1],)


def _batchnorm_shape(x, mean, var, gamma=None, beta=None, **_):
    x, m = _as_shape(x), _as_shape(mean)
    _require(len(x) >= 2, "BatchNorm", f"needs rank>=2 input, got {len(x)}")
    return x


def _layer_norm_shape(x, gamma=None, beta=None, **_):
    return _as_shape(x)


def _softmax_shape(x, axis=-1, **_):
    return _as_shape(x)


# --------------------------------------------------------------- rnn family

def _lstm_layer_shape(x, w_ih, w_hh, b, *args, direction="fwd",
                      merge="concat", w_proj=None, **_):
    x, wi, wh = _as_shape(x), _as_shape(w_ih), _as_shape(w_hh)
    _require(len(x) == 3, "LstmLayer",
             f"expected [T,N,C] rank-3 input, got rank {len(x)}")
    _require(wi[1] == 4 * wh[0], "LstmLayer",
             f"w_ih cols {wi[1]} != 4*hidden ({4 * wh[0]})")
    _require(x[2] == wi[0], "LstmLayer",
             f"input feature dim {x[2]} != w_ih rows {wi[0]}")
    H = wh[0] if w_proj is None else _as_shape(w_proj)[1]
    out_h = 2 * H if (direction == "bidir" and merge == "concat") else H
    return ((x[0], x[1], out_h), ((x[1], H), (x[1], wh[0])))


def _gru_shape(x, w_ih, w_hh, b_ih, b_hh, *args, **_):
    x, wi, wh = _as_shape(x), _as_shape(w_ih), _as_shape(w_hh)
    _require(len(x) == 3, "GRU",
             f"expected [T,N,C] rank-3 input, got rank {len(x)}")
    _require(wi[1] == 3 * wh[0], "GRU",
             f"w_ih cols {wi[1]} != 3*hidden ({3 * wh[0]})")
    H = wh[0]
    return ((x[0], x[1], H), (x[1], H))


# ------------------------------------------------------------ linalg family

def _require_square(a, op):
    _require(len(a) >= 2 and a[-1] == a[-2], op,
             f"needs square matrices, got [...,{a[-2] if len(a) >= 2 else '?'}"
             f",{a[-1]}]")


def _cholesky_shape(a, **_):
    a = _as_shape(a)
    _require_square(a, "Cholesky")
    return a


def _solve_shape(a, b, **_):
    a, b = _as_shape(a), _as_shape(b)
    _require_square(a, "Solve")
    _require(a[-1] == b[-2] if len(b) >= 2 else a[-1] == b[-1], "Solve",
             f"a cols {a[-1]} != b rows {b[-2] if len(b) >= 2 else b[-1]}")
    return b


def _svd_shape(a, **_):
    a = _as_shape(a)
    _require(len(a) >= 2, "Svd", f"needs rank>=2 input, got rank {len(a)}")
    m, n = a[-2], a[-1]
    k = min(m, n)
    return (a[:-2] + (m, k), a[:-2] + (k,), a[:-2] + (k, n))


# ------------------------------------------------------------------- table

SHAPE_FNS: Dict[str, Callable] = {
    "conv2d": _conv2d_shape,
    "conv1d": _conv1d_shape,
    "conv3d": _conv3d_shape,
    "conv3dnew": _conv3d_shape,
    "deconv2d": _deconv2d_shape,
    "maxpool2d": _pool2d_shape("MaxPool2D"),
    "avgpool2d": _pool2d_shape("AvgPool2D"),
    "pnormpool2d": _pool2d_shape("PNormPool2D"),
    "matmul": _matmul_shape,
    "mmul": _matmul_shape,
    "xw_plus_b": _xw_plus_b_shape,
    "batchnorm": _batchnorm_shape,
    "layer_norm": _layer_norm_shape,
    "rms_norm": _layer_norm_shape,
    "softmax": _softmax_shape,
    "log_softmax": _softmax_shape,
    "logsoftmax": _softmax_shape,
    "lstmLayer": _lstm_layer_shape,
    "gru": _gru_shape,
    "cholesky": _cholesky_shape,
    "solve": _solve_shape,
    "lu_solve": _solve_shape,
    "svd": _svd_shape,
}


def infer_shape(op: str, *arg_shapes, **kwargs):
    """Output shape(s) for ``op`` given input SHAPES (tuples or arrays).

    Table ops validate and answer from the shapes alone; the long tail is
    answered by the generic registry op over float32 ``meta`` tensors,
    with ``meta`` the default device (no allocation, no execution)."""
    if op in SHAPE_FNS:
        return SHAPE_FNS[op](*arg_shapes, **kwargs)
    fn = R.generic(op)
    with torch.device("meta"):       # scalars an op makes land there too
        specs = [torch.empty(_as_shape(s), dtype=torch.float32)
                 for s in arg_shapes]
        out = fn(*specs, **kwargs)
    leaves = R.tensor_leaves(out)
    if len(leaves) == 1:
        return tuple(leaves[0].shape)
    return tuple(tuple(t.shape) for t in leaves)


def check_call(op: str, *args, **kwargs):
    """Validate real arrays against ``op``'s shape contract (no-op for
    ops outside the table). Returns the expected output shape(s)."""
    if op not in SHAPE_FNS:
        return None
    return SHAPE_FNS[op](*[_as_shape(a) if hasattr(a, "shape") else a
                           for a in args], **kwargs)
