"""Op registry round-5 extension (the port of
``deeplearning4j_tpu/ops/registry_r5.py``): the last reference op names.

Families here:
- legacy transform derivatives (``tanh_derivative`` & co — the
  reference's old TransformOp derivative classes). Each is the EXACT
  elementwise grad of the registered forward, taken by autograd, so
  forward and derivative can never drift apart.
- legacy scalar/pairwise transforms (step, oneminus, timesoneminus,
  halve, twice, amax/amin pairwise, log_x, pow_derivative)
- shape/array utilities (flatten, size_at, tile_to_shape, assign,
  broadcast_dynamic_shape, *_nd aliases, zeros/ones/empty)
- validation predicates (is_non_decreasing, is_strictly_increasing,
  is_numeric_tensor, choose)
- image extras (adjust_contrast_v2, draw_bounding_boxes,
  non_max_suppression_overlaps)
- random extras (truncated_normal, binomial, log_normal), drawn from a
  ``torch.Generator`` as the registry's random family
- linalg extras (logdet, cholesky_solve, matrix_exp alias)
- casts (to_double/to_float32/...: the JAX package's dtypes without x64,
  so ``to_double`` gives float32 and ``to_int64`` int32), bitwise
  (bitwise_not, bits_hamming_distance), recurrent aliases
  (lstmBlock/lstmBlockCell/sruBiDirectional), updater op (apply_sgd),
  norm bp ops, hashcode
- the TensorList / TensorArray family (``create_list`` .. ``clone_list``
  — ref: ops/declarable/generic/list/*.cpp). Lists are HOST-side VM
  state in the reference too; here they are host containers of device
  tensors.
- the gradient-compression codecs (threshold and bitmap encoding)

Every op has a validation case in ``ops/validation_r5.py``.
"""

from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.ops import recurrent as _rnn
from deeplearning4j_tpu_torch.ops.registry import (_fdt, _fl, _rand, _randn,
                                                   _shape_of, _t,
                                                   canonical_dtype, register)
from deeplearning4j_tpu_torch.ops.registry import get as _get
from deeplearning4j_tpu_torch.ops.registry import softmax as _softmax
from deeplearning4j_tpu_torch.ops.registry_ext import bit_pattern


# ------------------------------------------------------ legacy derivatives
def _elementwise_derivative(fwd):
    """Exact elementwise d/dx of a registered forward op."""
    def deriv(x):
        x = _fl(x)
        with torch.enable_grad():
            v = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(fwd(v).sum(), v)
        return g
    return deriv


for _name, _src in [
    ("tanh_derivative", "tanh"), ("relu_derivative", "relu"),
    ("hardtanh_derivative", "hardtanh"),
    ("softsign_derivative", "softsign"),
    ("softplus_derivative", "softplus"), ("elu_derivative", "elu"),
    ("selu_derivative", "selu"), ("cube_derivative", "cube"),
    ("rational_tanh_derivative", "rationaltanh"),
    ("rectified_tanh_derivative", "rectifiedtanh"),
    ("swish_derivative", "swish"), ("mish_derivative", "mish"),
    ("gelu_derivative", "gelu"), ("relu6_derivative", "relu6"),
    ("thresholdedrelu_derivative", "thresholdedrelu"),
]:
    register(_name, _elementwise_derivative(_get(_src)))

register("sigm_derivative", _get("sigmoid_derivative"))


@register("softmax_derivative")
def _softmax_derivative(x, axis: int = -1):
    """ref: legacy SoftMaxDerivative — s * (1 - s) along ``axis`` (the
    generic softmax, as the JAX op calls ``jax.nn.softmax``: no kernel)."""
    s = _softmax(x, axis=axis)
    return s * (1.0 - s)


@register("pow_derivative")
def _pow_derivative(x, p):
    """ref: Pow_bp's input grad — p * x^(p-1)."""
    return p * torch.pow(x, p - 1.0)


@register("leakyrelu_derivative")
def _leakyrelu_derivative(x, alpha: float = 0.01):
    return torch.where(x > 0, torch.ones_like(x), torch.full_like(x, alpha))


# ----------------------------------------------- legacy scalar transforms
register("step", lambda x: (x > 0).to(_fdt(x)))
register("oneminus", lambda x: 1.0 - x)
register("timesoneminus", lambda x: x * (1.0 - x))
register("halve", lambda x: x / 2)
register("twice", lambda x: x * 2)
register("cbrt", lambda x: torch.sign(_fl(x)) * torch.abs(_fl(x)).pow(
    1.0 / 3.0))
register("log_x", lambda x, base: torch.log(x) / torch.log(torch.tensor(
    base, dtype=_fdt(x), device=x.device)))
register("max_pairwise", torch.maximum)
register("min_pairwise", torch.minimum)
register("amax_pairwise", lambda a, b: torch.where(
    torch.abs(a) > torch.abs(b), a, b))
register("amin_pairwise", lambda a, b: torch.where(
    torch.abs(a) < torch.abs(b), a, b))


@register("crelu")
def _crelu(x):
    """ref/TF: concatenated ReLU — [relu(x), relu(-x)] on the last axis."""
    return torch.cat([torch.relu(x), torch.relu(-x)], dim=-1)


@register("crelu_bp")
def _crelu_bp(x, grad):
    with torch.enable_grad():
        v = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(_crelu(v), v, grad)
    return g


@register("clip_by_average_norm")
def _clip_by_average_norm(x, clip: float):
    """ref: clipbyavgnorm — clip by (L2 norm / numElements)."""
    avg = torch.sqrt(torch.sum(x * x)) / x.numel()
    scale = torch.where(avg > clip, clip / torch.clamp_min(avg, 1e-12),
                        torch.ones_like(avg))
    return x * scale


# ------------------------------------------------------- shape / creation
def _creator(fill):
    def op(shape, dtype=torch.float32, device=None):
        from deeplearning4j_tpu_torch.device import resolve_device
        return torch.full(_shape_of(shape), fill, dtype=canonical_dtype(dtype),
                          device=resolve_device(device))
    return op


register("zeros", _creator(0))
register("ones", _creator(1))
# no uninitialized alloc, as in the JAX package: empty == zeros
register("empty", _creator(0))
register("size_at", lambda x, dim: torch.tensor(x.shape[int(dim)],
                                                dtype=torch.int32,
                                                device=x.device))
register("batch_matmul", torch.matmul)
register("batched_matmul", torch.matmul)
register("matrix_exp", _get("expm"))
register("space_to_batch_nd", _get("space_to_batch"))
register("batch_to_space_nd", _get("batch_to_space"))
register("bitwise_not", _get("toggle_bits"))


@register("flatten")
def _flatten(xs, order: str = "c"):
    """ref: flatten(order, arrays...) — concat of raveled inputs."""
    if not isinstance(xs, (list, tuple)):
        xs = [xs]
    o = str(order).upper()
    outs = [x.permute(*range(x.dim() - 1, -1, -1)).reshape(-1) if o == "F"
            else x.reshape(-1) for x in xs]
    return torch.cat(outs) if len(outs) > 1 else outs[0]


@register("tile_to_shape")
def _tile_to_shape(x, shape):
    """ref: tile_to_shape — tile x up to ``shape`` (broadcast-compatible)."""
    return torch.broadcast_to(x, tuple(int(s) for s in shape))


@register("assign")
def _assign(x, y):
    """ref: pairwise ``assign`` — y broadcast onto x's shape."""
    y = y.to(device=x.device, dtype=x.dtype) if isinstance(y, torch.Tensor) \
        else torch.tensor(y, dtype=x.dtype, device=x.device)
    return torch.broadcast_to(y, x.shape)


@register("broadcast_dynamic_shape")
def _broadcast_dynamic_shape(s1, s2):
    """ref/TF: broadcast two shape VECTORS under numpy rules; incompatible
    shapes raise (like TF; the shapes are read back to check, except on
    meta tensors, which have no values: the JAX op skips the check under
    tracing)."""
    s1 = _t(s1).to(torch.int32)
    s2 = _t(s2, s1).to(device=s1.device, dtype=torch.int32)
    if not s1.is_meta:
        np.broadcast_shapes(tuple(int(v) for v in s1.tolist()),
                            tuple(int(v) for v in s2.tolist()))
    n = max(s1.shape[0], s2.shape[0])
    one = torch.ones((), dtype=torch.int32, device=s1.device)
    a = torch.cat([one.expand(n - s1.shape[0]), s1])
    b = torch.cat([one.expand(n - s2.shape[0]), s2])
    return torch.where(a == 1, b, torch.where(b == 1, a, torch.maximum(a, b)))


# ------------------------------------------------------------- predicates
register("is_non_decreasing", lambda x: torch.all(
    torch.diff(x.reshape(-1)) >= 0))
register("is_strictly_increasing", lambda x: torch.all(
    torch.diff(x.reshape(-1)) > 0))
register("is_numeric_tensor", lambda x: torch.tensor(
    x.dtype != torch.bool, device=x.device))


@register("choose")
def _choose(x, comp, mode: str = "gt"):
    """ref: choose — elements of x passing the comparison, compacted to
    the front with -0 padding, plus the match count (the static-shape form
    the JAX package keeps)."""
    x = x.reshape(-1)
    comp = _t(comp, x).to(x.device)
    opmap = {"gt": x > comp, "lt": x < comp, "gte": x >= comp,
             "lte": x <= comp, "eq": x == comp, "neq": x != comp}
    keep = opmap[mode]
    idx = torch.argsort((~keep).to(torch.int8), stable=True)  # kept first
    n = torch.sum(keep, dtype=torch.int32)
    vals = torch.where(torch.arange(x.numel(), device=x.device) < n, x[idx],
                       torch.zeros((), dtype=x.dtype, device=x.device))
    return vals, n


# ------------------------------------------------------------ image extras
@register("adjust_contrast_v2")
def _adjust_contrast_v2(x, factor):
    """ref/TF AdjustContrastv2: (x - mean_hw) * factor + mean_hw."""
    m = torch.mean(x, dim=(-3, -2), keepdim=True)
    return (x - m) * factor + m


@register("draw_bounding_boxes")
def _draw_bounding_boxes(images, boxes, colors=None):
    """ref/TF: 1px box outlines onto [B, H, W, C] images; boxes [B, N, 4]
    normalized (y1, x1, y2, x2); colors [M, C] cycled per box."""
    boxes = boxes.to(torch.float32)
    B, H, W, C = images.shape
    N = boxes.shape[1]
    if colors is None:
        colors = torch.ones((1, C), dtype=images.dtype, device=images.device)
    colors = _t(colors, images).to(device=images.device, dtype=images.dtype)
    ys = torch.arange(H, dtype=torch.float32,
                      device=images.device)[None, :, None]      # [1, H, 1]
    xs = torch.arange(W, dtype=torch.float32,
                      device=images.device)[None, None, :]      # [1, 1, W]
    out = images
    for k in range(N):
        y1, x1, y2, x2 = (boxes[:, k, i][:, None, None] for i in range(4))
        ya, yb = y1 * (H - 1), y2 * (H - 1)
        xa, xb = x1 * (W - 1), x2 * (W - 1)
        inside = ((ys >= ya - 0.5) & (ys <= yb + 0.5)
                  & (xs >= xa - 0.5) & (xs <= xb + 0.5))
        edge = inside & ((torch.abs(ys - ya) <= 0.5)
                         | (torch.abs(ys - yb) <= 0.5)
                         | (torch.abs(xs - xa) <= 0.5)
                         | (torch.abs(xs - xb) <= 0.5))
        col = colors[k % colors.shape[0]]
        out = torch.where(edge[..., None], col[None, None, None, :], out)
    return out


@register("non_max_suppression_overlaps")
def _nms_overlaps(overlaps, scores, max_out, overlap_threshold=0.5,
                  score_threshold=-float("inf")):
    """ref/TF: greedy NMS driven by a PRECOMPUTED [N, N] overlap matrix
    (arbitrary overlap measure) — fixed-size output, -1 padded."""
    from deeplearning4j_tpu_torch.ops.registry import _greedy_nms
    return _greedy_nms(overlaps, scores, max_out, overlap_threshold,
                       score_threshold)


# ----------------------------------------------------------- random extras
def _truncated_std_normal(gen, shape):
    """Standard normal truncated to (-2, 2) by the inverse CDF of a
    uniform draw on the truncated range (as ``jax.random.truncated_normal``
    samples it)."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    u = _rand(gen, shape) * (hi - lo) + lo
    z = math.sqrt(2.0) * torch.erfinv(u)
    return torch.clamp(z, math.nextafter(-2.0, 0.0), math.nextafter(2.0, 0.0))


@register("truncated_normal")
def _truncated_normal(gen, shape, mean=0.0, stddev=1.0):
    """ref/TF: normal truncated to +-2 sigma."""
    return mean + stddev * _truncated_std_normal(gen, _shape_of(shape))


register("random_truncated_normal", _get("truncated_normal"))


@register("binomial")
def _binomial(gen, shape, n, p):
    """ref: random binomial(n, p) as the JAX op draws it: the sum of n
    Bernoulli(p) draws."""
    return torch.sum(_rand(gen, (int(n),) + _shape_of(shape)) < p,
                     dim=0).to(torch.float32)


register("random_binomial", _get("binomial"))


@register("log_normal")
def _log_normal(gen, shape, mean=0.0, stddev=1.0):
    return torch.exp(mean + stddev * _randn(gen, _shape_of(shape)))


register("random_lognormal", _get("log_normal"))


# ------------------------------------------------------------ linalg extras
@register("logdet")
def _logdet(a):
    """ref: logdet (SPD input) — 2*sum(log(diag(chol(a))))."""
    L = torch.linalg.cholesky(a)
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)),
                           dim=-1)


@register("cholesky_solve")
def _cholesky_solve(a, b):
    """Solve a x = b for SPD a via the Cholesky factorization."""
    L = torch.linalg.cholesky(a)
    vec = b.dim() == a.dim() - 1
    out = torch.cholesky_solve(b.unsqueeze(-1) if vec else b, L)
    return out.squeeze(-1) if vec else out


# ------------------------------------------------------------------- casts
for _name, _dt in [("to_double", torch.float64), ("to_float16", torch.float16),
                   ("to_float32", torch.float32), ("to_int32", torch.int32),
                   ("to_int64", torch.int64), ("to_uint8", torch.uint8)]:
    register(_name, (lambda dt: lambda x: x.to(canonical_dtype(dt)))(_dt))


# ----------------------------------------------------------------- bitwise
@register("bits_hamming_distance")
def _bits_hamming_distance(a, b):
    """ref: bits_hamming_distance — total popcount(a XOR b) (int32: the
    JAX op's int64 without x64)."""
    u, width = bit_pattern(torch.bitwise_xor(a, b.to(a.device)))
    cnt = torch.zeros_like(u)
    for i in range(width):
        cnt = cnt + ((u >> i) & 1)
    return torch.sum(cnt).to(torch.int32)


_M32 = 1 << 32


@register("hashcode")
def _hashcode(x):
    """ref: hashcode — order-dependent 32-bit polynomial hash (Java-style
    h = 31*h + v) over the int32 bit pattern of the flattened tensor, in
    closed form on the device: h = 17*31^n + sum_i v_i 31^(n-1-i) mod 2^32
    (the powers from the length alone; 16-bit halves keep every product
    inside int64)."""
    if x.is_meta:                 # the static shape, for infer_shape
        return x.new_empty((), dtype=torch.int32)
    if x.element_size() != 4:
        x = x.to(torch.float32) if x.is_floating_point() \
            else x.to(torch.int32)
    v = x.reshape(-1).view(torch.int32).to(torch.int64) & (_M32 - 1)
    n = v.numel()
    pw = np.ones(n + 1, dtype=np.uint64)
    for i in range(1, n + 1):
        pw[i] = (pw[i - 1] * np.uint64(31)) % np.uint64(_M32)
    p = torch.as_tensor(pw[:n][::-1].astype(np.int64).copy(),
                        device=x.device)
    lo, hi = v & 0xFFFF, v >> 16
    terms = (lo * p + (((hi * p) & 0xFFFF) << 16)) & (_M32 - 1)
    h = (torch.sum(terms) + 17 * int(pw[n])) & (_M32 - 1)
    return torch.where(h >= (1 << 31), h - _M32, h).to(torch.int32)


# -------------------------------------------------------- recurrent aliases
register("lstmBlockCell", _rnn.lstm_cell)
register("lstm", _get("lstmLayer"))
register("lstmBlock", _get("lstmLayer"))


@register("sruBiDirectional")
def _sru_bi(x_tnc, w_fwd, wf_fwd, bf_fwd, wr_fwd, br_fwd,
            w_bwd, wf_bwd, bf_bwd, wr_bwd, br_bwd):
    """ref: sru_bi — forward + reversed SRU passes, concat on features."""
    h_f, _ = _rnn.sru(x_tnc, w_fwd, wf_fwd, bf_fwd, wr_fwd, br_fwd)
    h_b, _ = _rnn.sru(x_tnc, w_bwd, wf_bwd, bf_bwd, wr_bwd, br_bwd,
                      reverse=True)
    return torch.cat([h_f, h_b], dim=-1)


# ---------------------------------------------------------- updater / norm
@register("apply_sgd")
def _apply_sgd(params, grads, lr):
    """ref: apply_sgd — p - lr * g."""
    return params - lr * grads


def _vjp(fn, primals, ct):
    with torch.enable_grad():
        vs = [p.detach().requires_grad_(True) for p in primals]
        return torch.autograd.grad(fn(*vs), vs, ct)


@register("standardize_bp")
def _standardize_bp(x, grad, axis=-1):
    std = _get("standardize")
    return _vjp(lambda v: std(v, axis=axis), [x], grad)[0]


@register("layer_norm_bp")
def _layer_norm_bp(x, gain, bias, grad, axis=-1, eps: float = 1e-5):
    """The vjp of the registered ``layer_norm`` (its platform override,
    the layer-norm kernel, inside its gate)."""
    ln = _get("layer_norm")
    return _vjp(lambda v, g, b: ln(v, g, b, axis=axis, eps=eps),
                [x, gain, bias], grad)


# --------------------------------------------- TensorList / TensorArray ops
# ref: ops/declarable/generic/list/*.cpp — the reference's list ops hold VM
# state on the host; here TensorList is a host container of device tensors.
class TensorList:
    """ref: NDArrayList — growable host-side list of same-shape tensors."""

    def __init__(self, arrays: Optional[List] = None):
        self.arrays: List = list(arrays or [])

    def __len__(self):
        return len(self.arrays)


register("create_list", lambda *a, **kw: TensorList())


@register("write_list")
def _write_list(tl: TensorList, idx: int, value):
    idx = int(idx)
    while len(tl.arrays) <= idx:
        tl.arrays.append(None)
    tl.arrays[idx] = _t(value)
    return tl


@register("read_list")
def _read_list(tl: TensorList, idx: int):
    return tl.arrays[int(idx)]


@register("size_list")
def _size_list(tl: TensorList):
    dev = tl.arrays[0].device if tl.arrays else None
    return torch.tensor(len(tl.arrays), dtype=torch.int32, device=dev)


@register("stack_list")
def _stack_list(tl: TensorList):
    return torch.stack(list(tl.arrays))


@register("unstack_list")
def _unstack_list(x):
    return TensorList(list(torch.unbind(x, dim=0)))


@register("split_list")
def _split_list(x, sizes):
    out, pos = [], 0
    for s in sizes:
        out.append(x[pos:pos + int(s)])
        pos += int(s)
    return TensorList(out)


def _host_indices(indices):
    """List indices are host state (positions in a host list): a tensor
    of them is read back."""
    if isinstance(indices, torch.Tensor):
        return [int(i) for i in indices.reshape(-1).tolist()]
    return [int(i) for i in np.asarray(indices).reshape(-1)]


@register("gather_list")
def _gather_list(tl: TensorList, indices):
    return torch.stack([tl.arrays[i] for i in _host_indices(indices)])


@register("scatter_list")
def _scatter_list(indices, x):
    tl = TensorList()
    for row, i in enumerate(_host_indices(indices)):
        _write_list(tl, i, x[row])
    return tl


@register("pick_list")
def _pick_list(tl: TensorList, indices):
    return _gather_list(tl, indices)


@register("clone_list")
def _clone_list(tl: TensorList):
    return TensorList(list(tl.arrays))


# --------------------------------------------------- late-round-5 aliases
# Remaining reference op NAMES that alias surfaces already implemented
# (ref: libnd4j exposes these as distinct declarable-op names).
register("biasadd", _get("bias_add"))
register("norm1", _get("reduce_norm1"))
register("norm2", _get("reduce_norm2"))
register("normmax", _get("reduce_norm_max"))
register("shift_bits", _get("left_shift"))
register("rshift_bits", _get("right_shift"))
register("solve_ls", _get("lstsq"))
register("static_bidirectional_rnn", _get("bidirectional_rnn"))
register("dynamic_bidirectional_rnn", _get("bidirectional_rnn"))
register("softmax_cross_entropy_loss_with_logits",
         _get("softmax_cross_entropy_loss"))
register("sigmoid_cross_entropy_loss_with_logits",
         _get("sigmoid_cross_entropy_loss"))


@register("check_numerics")
def _check_numerics(x, message: str = ""):
    """ref/TF: CheckNumerics — identity that fails on NaN/Inf (reads one
    flag back; a meta tensor, which has no values, passes through as a
    traced one does in the JAX op; pair with the NAN_PANIC executioner
    mode to check every op)."""
    if x.is_floating_point() and not x.is_meta \
            and not bool(torch.all(torch.isfinite(x))):
        raise FloatingPointError(
            f"check_numerics: NaN/Inf detected. {message}")
    return x


# ----------------------------------------- gradient compression codecs
# ref: libnd4j encode_threshold/decode_threshold + encode_bitmap/
# decode_bitmap — the reference's gradient-sharing wire codecs
# (EncodedGradientsAccumulator), in the JAX package's static-shape form:
# the encoded buffer is fixed-capacity, the count returned alongside.
@register("encode_threshold")
def _encode_threshold(x, threshold: float, max_elements: Optional[int] = None):
    """Values with |v| >= threshold -> (indices [K], signs [K], count),
    compacted to the front and -1/0 padded; the residual (x minus what
    was encoded) is returned too, like the reference's in-place update."""
    flat = x.reshape(-1)
    K = min(int(max_elements), flat.numel()) if max_elements is not None \
        else flat.numel()
    hit = torch.abs(flat) >= threshold
    order = torch.argsort((~hit).to(torch.int8), stable=True)
    count = torch.clamp_max(torch.sum(hit, dtype=torch.int32), K)
    take = order[:K]
    valid = torch.arange(K, device=x.device) < count
    zero = torch.zeros((), dtype=flat.dtype, device=x.device)
    idx = torch.where(valid, take, -1).to(torch.int32)
    sgn = torch.sign(flat[take])
    signs = torch.where(valid, sgn, zero).to(torch.float32)
    encoded = torch.zeros_like(flat).index_add(
        0, take, torch.where(valid, sgn * threshold, zero))
    residual = (flat - encoded).reshape(x.shape)
    return idx, signs, count, residual


@register("decode_threshold")
def _decode_threshold(idx, signs, threshold: float, shape):
    """Inverse of encode_threshold: scatter sign*threshold into zeros."""
    shape = tuple(int(s) for s in shape)
    n = int(np.prod(shape))
    idx = idx.long()
    safe = torch.where(idx >= 0, idx, 0)
    vals = torch.where(idx >= 0, signs.to(torch.float32) * threshold,
                       torch.zeros((), device=idx.device))
    return torch.zeros((n,), dtype=torch.float32,
                       device=idx.device).index_add(0, safe,
                                                    vals).reshape(shape)


def _bitmap_values(codes, threshold, dtype):
    zero = torch.zeros((), dtype=dtype, device=codes.device)
    t = torch.tensor(threshold, dtype=dtype, device=codes.device)
    return torch.where(codes == 1, t, torch.where(codes == 2, -t, zero))


@register("encode_bitmap")
def _encode_bitmap(x, threshold: float):
    """2-bit-per-element bitmap codec (ref: encode_bitmap): code 1 where
    v >= t, 2 where v <= -t, 0 otherwise; returns (codes uint8 [n],
    residual). The reference packs 16 codes/int32 on the wire; the code
    array here is the unpacked semantic form."""
    flat = x.reshape(-1)
    codes = torch.where(flat >= threshold, 1, torch.where(
        flat <= -threshold, 2, 0)).to(torch.uint8)
    residual = (flat - _bitmap_values(codes, threshold, flat.dtype)
                ).reshape(x.shape)
    return codes, residual


@register("decode_bitmap")
def _decode_bitmap(codes, threshold: float, shape):
    return _bitmap_values(codes, threshold, torch.float32).reshape(
        tuple(int(s) for s in shape))
