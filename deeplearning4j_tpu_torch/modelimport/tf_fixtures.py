"""Fixture writers: seeded BERT weights in each checkpoint format's own
layout, and a frozen BERT GraphDef built from them with
:mod:`.tf_proto`'s encoder.

No BERT checkpoint or frozen GraphDef ships with the repository and none
is downloaded, so the tests and ``chip_smoke.py`` make them here from a
seed: :func:`bert_weights` draws the weights under google-research's TF
names (dense kernels ``[in, out]``, ``gamma``/``beta``, the pooler and a
``run_classifier.py`` head), :func:`hf_state` lays the same numbers out
under HuggingFace ``BertForSequenceClassification`` keys (Linear weights
``[out, in]``), and :func:`bert_graph_def` emits the op structure
google-research ``modeling.py`` freezes to:

- ``GatherV2`` over the word and position tables, the token types as a
  one-hot ``MatMul`` (all token types 0: ``ZerosLike`` of the ids);
- the ``[B*T, E]`` matrix view, dense layers as ``MatMul`` + ``BiasAdd``;
- heads by ``Reshape`` + ``Transpose``; scores by ``BatchMatMulV2``
  (``adj_y``) scaled by a ``Mul`` of 1/sqrt(D), ``Softmax``, then
  ``BatchMatMulV2`` with the values;
- each LayerNorm as ``tf.nn.batch_normalization`` freezes it (``Mean``,
  ``SquaredDifference``, ``AddV2`` eps, ``Rsqrt``, ``Mul``, ``Sub``);
- the exact-erf GELU (``RealDiv`` by sqrt 2, ``Erf``);
- the ``[CLS]`` row by ``StridedSlice`` + ``Squeeze``, the ``Tanh``
  pooler, the classifier ``MatMul(transpose_b)`` + ``BiasAdd``.

One int32 ``Placeholder`` ``input_ids`` of shape ``[-1, T]``; outputs
``pooled_output`` [B, E] and ``logits`` [B, n_labels]. Nothing on the
port's main path imports this module.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from deeplearning4j_tpu_torch.modelimport import tf_proto as P

#: BERT-base as modelimport/bert.py infers it, with a 2-label head
BERT_BASE = dict(V=30522, E=768, L=12, F=3072, P=512, TV=2, n_labels=2)


def bert_weights(seed: int = 0, *, V: int, E: int, L: int, F: int, P: int,
                 TV: int = 2, n_labels: int = 2) -> Dict[str, np.ndarray]:
    """Seeded fp32 BERT weights under google-research TF names: dense
    kernels and tables N(0, 0.02), biases N(0, 0.02), LayerNorm gammas
    1 + N(0, 0.1) and betas N(0, 0.1), from ``numpy.random.default_rng``."""
    rng = np.random.default_rng(seed)

    def normal(shape, std):
        return (rng.standard_normal(shape, dtype=np.float32)
                * np.float32(std))

    w: Dict[str, np.ndarray] = {}

    def dense(name, n_in, n_out):
        w[f"{name}/kernel"] = normal((n_in, n_out), 0.02)
        w[f"{name}/bias"] = normal((n_out,), 0.02)

    def norm(name):
        w[f"{name}/gamma"] = 1.0 + normal((E,), 0.1)
        w[f"{name}/beta"] = normal((E,), 0.1)

    w["bert/embeddings/word_embeddings"] = normal((V, E), 0.02)
    w["bert/embeddings/token_type_embeddings"] = normal((TV, E), 0.02)
    w["bert/embeddings/position_embeddings"] = normal((P, E), 0.02)
    norm("bert/embeddings/LayerNorm")
    for i in range(L):
        p = f"bert/encoder/layer_{i}/"
        for part in ("query", "key", "value"):
            dense(p + "attention/self/" + part, E, E)
        dense(p + "attention/output/dense", E, E)
        norm(p + "attention/output/LayerNorm")
        dense(p + "intermediate/dense", E, F)
        dense(p + "output/dense", F, E)
        norm(p + "output/LayerNorm")
    dense("bert/pooler/dense", E, E)
    w["output_weights"] = normal((n_labels, E), 0.02)
    w["output_bias"] = normal((n_labels,), 0.02)
    return w


def hf_state(weights: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The same numbers under HuggingFace ``BertForSequenceClassification``
    keys: ``bert.``-prefixed, dots, Linear weights ``[out, in]``,
    LayerNorm ``weight``/``bias``, the head as ``classifier``."""
    out = {}
    for k, v in weights.items():
        if k == "output_weights":
            out["classifier.weight"] = v
            continue
        if k == "output_bias":
            out["classifier.bias"] = v
            continue
        hk = k.replace("encoder/layer_", "encoder/layer/").replace("/", ".")
        if hk.endswith(".kernel"):
            hk, v = hk[:-len(".kernel")] + ".weight", np.ascontiguousarray(v.T)
        elif hk.endswith("_embeddings"):
            hk += ".weight"
        elif hk.endswith(".gamma"):
            hk = hk[:-len(".gamma")] + ".weight"
        elif hk.endswith(".beta"):
            hk = hk[:-len(".beta")] + ".bias"
        out[hk] = v
    return out


class _Graph:
    """NodeDef bytes in order, with unique names for the helper consts."""

    def __init__(self):
        self.nodes: List[bytes] = []
        self._n = 0

    def const(self, arr, name=None) -> str:
        if name is None:
            self._n += 1
            name = f"const_{self._n}"
        self.nodes.append(P.encode_const(name, np.asarray(arr)))
        return name

    def op(self, name, op, *inputs, **attrs) -> str:
        self.nodes.append(P.encode_node(name, op, inputs, **attrs))
        return name


def bert_graph_def(weights: Dict[str, np.ndarray], *, T: int, H: int,
                   eps: float = 1e-12) -> bytes:
    """A frozen BERT sequence classifier over ``weights`` (from
    :func:`bert_weights`) for sequences of ``T`` tokens and ``H`` heads,
    as GraphDef bytes (module docstring)."""
    g = _Graph()
    V, E = weights["bert/embeddings/word_embeddings"].shape
    TV = weights["bert/embeddings/token_type_embeddings"].shape[0]
    D = E // H
    L = len({k.split("/")[2] for k in weights
             if k.startswith("bert/encoder/layer_")})
    f32 = P.Attr.dtype(np.float32)
    i32 = P.Attr.dtype(np.int32)
    for name, arr in weights.items():
        g.const(arr, name)
    ids = g.op("input_ids", "Placeholder", dtype=i32,
               shape=P.Attr.shape([-1, T]))
    axis0 = g.const(np.int32(0))
    last = g.const(np.asarray([-1], np.int32))
    flat = g.const(np.asarray([-1], np.int32))
    to_bte = g.const(np.asarray([-1, T, E], np.int32))
    to_mat = g.const(np.asarray([-1, E], np.int32))
    heads = g.const(np.asarray([-1, T, H, D], np.int32))
    perm = g.const(np.asarray([0, 2, 1, 3], np.int32))

    def layer_norm(x, scope):
        mean = g.op(f"{scope}/moments/mean", "Mean", x, last,
                    T=f32, Tidx=i32, keep_dims=True)
        sq = g.op(f"{scope}/moments/SquaredDifference", "SquaredDifference",
                  x, mean, T=f32)
        var = g.op(f"{scope}/moments/variance", "Mean", sq, last,
                   T=f32, Tidx=i32, keep_dims=True)
        add = g.op(f"{scope}/batchnorm/add", "AddV2", var,
                   g.const(np.float32(eps)), T=f32)
        rs = g.op(f"{scope}/batchnorm/Rsqrt", "Rsqrt", add, T=f32)
        mul = g.op(f"{scope}/batchnorm/mul", "Mul", rs, f"{scope}/gamma",
                   T=f32)
        mul1 = g.op(f"{scope}/batchnorm/mul_1", "Mul", x, mul, T=f32)
        mul2 = g.op(f"{scope}/batchnorm/mul_2", "Mul", mean, mul, T=f32)
        sub = g.op(f"{scope}/batchnorm/sub", "Sub", f"{scope}/beta", mul2,
                   T=f32)
        return g.op(f"{scope}/batchnorm/add_1", "AddV2", mul1, sub, T=f32)

    def dense(x, scope, transpose_b=False, kernel=None, bias=None):
        mm = g.op(f"{scope}/MatMul", "MatMul", x, kernel or f"{scope}/kernel",
                  T=f32, transpose_a=False, transpose_b=transpose_b)
        return g.op(f"{scope}/BiasAdd", "BiasAdd", mm,
                    bias or f"{scope}/bias", T=f32, data_format="NHWC")

    # embeddings
    e = "bert/embeddings"
    flat_ids = g.op(f"{e}/Reshape", "Reshape", ids, flat, T=i32, Tshape=i32)
    words = g.op(f"{e}/GatherV2", "GatherV2", f"{e}/word_embeddings",
                 flat_ids, axis0, Tparams=f32, Tindices=i32, Taxis=i32,
                 batch_dims=0)
    x = g.op(f"{e}/Reshape_1", "Reshape", words, to_bte, T=f32, Tshape=i32)
    types = g.op(f"{e}/ZerosLike", "ZerosLike", ids, T=i32)
    types = g.op(f"{e}/Reshape_2", "Reshape", types, flat, T=i32, Tshape=i32)
    one_hot = g.op(f"{e}/one_hot", "OneHot", types, g.const(np.int32(TV)),
                   g.const(np.float32(1.0)), g.const(np.float32(0.0)),
                   T=f32, TI=i32, axis=-1)
    tt = g.op(f"{e}/MatMul", "MatMul", one_hot,
              f"{e}/token_type_embeddings", T=f32, transpose_a=False,
              transpose_b=False)
    tt = g.op(f"{e}/Reshape_3", "Reshape", tt, to_bte, T=f32, Tshape=i32)
    x = g.op(f"{e}/add", "AddV2", x, tt, T=f32)
    pos = g.op(f"{e}/GatherV2_1", "GatherV2", f"{e}/position_embeddings",
               g.const(np.arange(T, dtype=np.int32)), axis0, Tparams=f32,
               Tindices=i32, Taxis=i32, batch_dims=0)
    pos = g.op(f"{e}/Reshape_4", "Reshape", pos,
               g.const(np.asarray([1, T, E], np.int32)), T=f32, Tshape=i32)
    x = g.op(f"{e}/add_1", "AddV2", x, pos, T=f32)
    x = layer_norm(x, f"{e}/LayerNorm")
    x = g.op("bert/encoder/Reshape", "Reshape", x, to_mat, T=f32,
             Tshape=i32)

    scale = g.const(np.float32(1.0 / np.sqrt(D)))
    half, one = g.const(np.float32(0.5)), g.const(np.float32(1.0))
    sqrt2 = g.const(np.float32(np.sqrt(2.0)))
    for i in range(L):
        p = f"bert/encoder/layer_{i}"
        a = f"{p}/attention/self"
        qkv = []
        for part in ("query", "key", "value"):
            h = dense(x, f"{a}/{part}")
            h = g.op(f"{a}/{part}/Reshape", "Reshape", h, heads, T=f32,
                     Tshape=i32)
            qkv.append(g.op(f"{a}/{part}/transpose", "Transpose", h, perm,
                            T=f32, Tperm=i32))
        s = g.op(f"{a}/MatMul", "BatchMatMulV2", qkv[0], qkv[1], T=f32,
                 adj_x=False, adj_y=True)
        s = g.op(f"{a}/Mul", "Mul", s, scale, T=f32)
        s = g.op(f"{a}/Softmax", "Softmax", s, T=f32)
        c = g.op(f"{a}/MatMul_1", "BatchMatMulV2", s, qkv[2], T=f32,
                 adj_x=False, adj_y=False)
        c = g.op(f"{a}/transpose_3", "Transpose", c, perm, T=f32, Tperm=i32)
        c = g.op(f"{a}/Reshape_3", "Reshape", c, to_mat, T=f32, Tshape=i32)
        o = dense(c, f"{p}/attention/output/dense")
        o = g.op(f"{p}/attention/output/add", "AddV2", o, x, T=f32)
        x = layer_norm(o, f"{p}/attention/output/LayerNorm")
        h = dense(x, f"{p}/intermediate/dense")
        gd = f"{p}/intermediate/gelu"
        z = g.op(f"{gd}/truediv", "RealDiv", h, sqrt2, T=f32)
        z = g.op(f"{gd}/Erf", "Erf", z, T=f32)
        z = g.op(f"{gd}/add", "AddV2", one, z, T=f32)
        z = g.op(f"{gd}/mul", "Mul", half, z, T=f32)
        h = g.op(f"{gd}/mul_1", "Mul", h, z, T=f32)
        o = dense(h, f"{p}/output/dense")
        o = g.op(f"{p}/output/add", "AddV2", o, x, T=f32)
        x = layer_norm(o, f"{p}/output/LayerNorm")

    seq = g.op("bert/encoder/Reshape_1", "Reshape", x, to_bte, T=f32,
               Tshape=i32)
    first = g.op("bert/pooler/strided_slice", "StridedSlice", seq,
                 g.const(np.asarray([0, 0, 0], np.int32)),
                 g.const(np.asarray([0, 1, 0], np.int32)),
                 g.const(np.asarray([1, 1, 1], np.int32)), T=f32, Index=i32,
                 begin_mask=5, end_mask=5, ellipsis_mask=0,
                 new_axis_mask=0, shrink_axis_mask=0)
    first = g.op("bert/pooler/Squeeze", "Squeeze", first, T=f32,
                 squeeze_dims=[1])
    pooled = g.op("bert/pooler/dense/Tanh", "Tanh",
                  dense(first, "bert/pooler/dense"), T=f32)
    g.op("pooled_output", "Identity", pooled, T=f32)
    logits = dense(pooled, "output", transpose_b=True,
                   kernel="output_weights", bias="output_bias")
    g.op("logits", "Identity", logits, T=f32)
    return P.encode_graph_def(g.nodes)
