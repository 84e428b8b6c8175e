"""Transformer encoder/decoder — the port of
``deeplearning4j_tpu/models/transformer.py`` (single device).

Layouts are the JAX package's: the parameter tree has the same keys,
weights are stored ``[in, out]`` and applied as ``x @ W``, attention
works on ``[B, T, H, D]``. So :func:`params_from_jax` is a plain copy
and the tests compare like with like.

Every LayerNorm resolves ``layer_norm`` through :mod:`ops.registry` on
the ``[B*T, E]`` view, and attention goes through
``ops.attention.flash_attention`` when ``use_flash_attention`` is set,
so :func:`ops.cuda_kernels.install_platform_overrides` routes both
through the CUDA kernels. The pre-LN ``forward`` runs 12 flash-attention
and 25 layer-norm calls for BERT-base.

Training (the BertBench step): :func:`loss_fn`, :func:`make_train_step`
and :func:`init_opt_state`. The JAX step donates params, updater state
and its step counter and returns new ones; the port's counterpart of
donation is an update in place, so every state tensor keeps its storage
and the step can be captured as a CUDA graph
(``nn.compilecache.CachedDispatch``) and replayed.

Over a mesh (``forward``/``encode``/``loss_fn``/``make_train_step``
with ``mesh=``, ``TransformerLM(cfg, mesh=)``) the parameters take the
Megatron layout of :func:`param_shardings` (:func:`shard_params` cuts
each rank's pieces): ``wqkv`` and ``w1`` split by columns and ``wo`` and
``w2`` by rows over ``model``, so each rank runs ``H/model`` heads
through the flash kernel and one differentiable all-reduce over
``model`` follows attention and one the MLP; ``embed.tok`` is split by
vocabulary rows: the lookup takes the rank's range and an all-reduce
joins them, and the tied head's logits are all-gathered over ``model``
(JAX ``forward`` returns the whole ``[B, T, V]``). Activations are split
``[data, seq, -]`` between blocks; ``pos`` is sliced at the rank's
offset along ``seq``, and attention over a ``seq`` axis of more than one
rank is the ring (``parallel.sequence.ring_attention``, the flash kernel
on each block). The collectives follow one convention: the objective is
the sum of the ranks' own, so the step backpropagates the global loss
over the mesh's size and sums each gradient over the axes its param is
whole on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.ops import attention as attn_ops
from deeplearning4j_tpu_torch.ops import registry
from deeplearning4j_tpu_torch.parallel import collectives as _coll
from deeplearning4j_tpu_torch.parallel import mesh as _mesh
from deeplearning4j_tpu_torch.profiler import devicetime as _dt


@dataclass
class TransformerConfig:
    vocab_size: int = 30522          # bert-base vocab
    d_model: int = 768
    n_heads: int = 12
    n_layers: int = 12
    d_ff: int = 3072
    max_len: int = 512
    causal: bool = False             # False = BERT-style encoder, True = GPT-style
    dtype: Any = torch.bfloat16
    # attention over a ``seq`` axis of the mesh: the ring (the port runs
    # it whenever the axis has more than one rank)
    use_ring_attention: bool = False
    # fused flash-attention path (CUDA kernel override when installed;
    # blockwise formulation otherwise) — no [T, T] score matrix
    use_flash_attention: bool = False
    tie_embeddings: bool = True
    # "preln" = pre-LN, tanh gelu; "postln_bert" = faithful BERT layout
    # (post-LN residuals, embedding LayerNorm, token types, exact-erf gelu)
    arch: str = "preln"
    type_vocab_size: int = 0
    layer_norm_eps: float = 1e-5     # BERT checkpoints use 1e-12

    @staticmethod
    def bert_base(**kw):
        return TransformerConfig(**kw)

    @staticmethod
    def tiny(**kw):
        d = dict(vocab_size=1024, d_model=64, n_heads=4, n_layers=2,
                 d_ff=128, max_len=128)
        d.update(kw)
        return TransformerConfig(**d)


def init_params(cfg: TransformerConfig, seed: int = 0,
                device=None) -> Dict:
    """Initialize parameters (N(0, 0.02) weights, unit gains, zero
    biases) from a seeded ``torch.Generator``. The draws differ from the
    JAX package's; :func:`params_from_jax` carries its weights over."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    E, F, V = cfg.d_model, cfg.d_ff, cfg.vocab_size
    dt = cfg.dtype

    def norm(*shape):
        w = torch.randn(shape, generator=gen, dtype=torch.float32) * 0.02
        return w.to(device=dev, dtype=dt)

    def ones(n):
        return torch.ones(n, dtype=dt, device=dev)

    def zeros(n):
        return torch.zeros(n, dtype=dt, device=dev)

    params = {
        "embed": {"tok": norm(V, E), "pos": norm(cfg.max_len, E)},
        "final_norm": {"g": ones(E), "b": zeros(E)},
        "layers": [],
    }
    if cfg.type_vocab_size:
        params["embed"]["type"] = norm(cfg.type_vocab_size, E)
    if cfg.arch == "postln_bert":
        params["emb_norm"] = {"g": ones(E), "b": zeros(E)}
    if not cfg.tie_embeddings:
        params["lm_head"] = norm(E, V)
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "ln1": {"g": ones(E), "b": zeros(E)},
            "wqkv": norm(E, 3 * E),
            "bqkv": zeros(3 * E),
            "wo": norm(E, E),
            "bo": zeros(E),
            "ln2": {"g": ones(E), "b": zeros(E)},
            "w1": norm(E, F),
            "b1": zeros(F),
            "w2": norm(F, E),
            "b2": zeros(E),
        })
    return params


def params_from_jax(tree, cfg: TransformerConfig, device=None,
                    mesh=None) -> Dict:
    """Carry a JAX ``init_params`` tree (leaves as numpy arrays) over to
    torch tensors of ``cfg.dtype`` on ``device``. bf16 leaves arrive as
    ``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` rejects;
    they go through float32, which holds every bf16 value exactly. With
    ``mesh`` each leaf is placed per :func:`param_shardings` (this
    rank's piece, on the rank's device)."""
    dev = resolve_device(device) if mesh is None else mesh.device

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        a = np.asarray(t).astype(np.float32)
        return torch.from_numpy(a).to(dtype=cfg.dtype)

    tree = conv(tree)
    if mesh is not None:
        return shard_params(tree, cfg, mesh)
    return _tree_apply(tree, lambda t: t.to(dev))


def _tree_apply(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree_apply(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_apply(v, fn) for v in tree]
    return fn(tree)


# ------------------------------------------------------------ the mesh
def param_shardings(cfg: TransformerConfig, mesh=None):
    """The specs of :func:`init_params`'s tree (JAX transformer.py:110-
    137, the Megatron layout): column-parallel ``wqkv``/``w1`` (and
    their biases), row-parallel ``wo``/``w2``, the vocabulary split of
    ``embed.tok`` and of an untied ``lm_head``; the rest replicated
    (``()``). ``mesh`` is accepted for the JAX signature; a spec names
    axes, which any mesh resolves."""
    del mesh
    rep = ()
    layer = {
        "ln1": {"g": rep, "b": rep},
        "wqkv": (None, "model"),       # column parallel
        "bqkv": ("model",),
        "wo": ("model", None),         # row parallel
        "bo": rep,
        "ln2": {"g": rep, "b": rep},
        "w1": (None, "model"),
        "b1": ("model",),
        "w2": ("model", None),
        "b2": rep,
    }
    out = {
        "embed": {"tok": ("model", None), "pos": rep},
        "final_norm": {"g": rep, "b": rep},
        "layers": [layer] * cfg.n_layers,
    }
    if cfg.type_vocab_size:
        out["embed"]["type"] = rep
    if cfg.arch == "postln_bert":
        out["emb_norm"] = {"g": rep, "b": rep}
    if not cfg.tie_embeddings:
        out["lm_head"] = (None, "model")
    return out


#: leaves holding the fused ``[q | k | v]`` projection: split by heads,
#: each third alike
_QKV = ("wqkv", "bqkv")


def _specs_by_path(cfg) -> Dict:
    return {path: spec for path, spec in
            _leaf_paths(param_shardings(cfg), tuple_leaves=True)}


def shard_params(params, cfg: TransformerConfig, mesh) -> Dict:
    """Each leaf of a whole parameter tree (the same values on every
    rank) placed per :func:`param_shardings` on ``mesh``: this rank's
    piece, tagged with its ``Placement``, on the rank's device. The
    ``wqkv``/``bqkv`` piece is the rank's heads of each of q, k and v."""
    specs = _specs_by_path(cfg)
    flat = dict(_leaf_paths(params))
    out = {p: _mesh.place_by_spec(mesh, t.detach(), specs[p],
                                  groups=3 if p[-1] in _QKV else 1)
           for p, t in flat.items()}
    return _rebuild(params, out)


def gather_params(params, mesh) -> Dict:
    """The whole tree from this rank's pieces (a collective over each
    split axis; the inverse of :func:`shard_params`)."""
    return _tree_apply(params, mesh.gather)


def _rebuild(tree, flat: Dict, prefix=()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, flat, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_rebuild(v, flat, prefix + (i,)) for i, v in enumerate(tree)]
    return flat[prefix]


class _Par:
    """What a forward over a mesh reads of it: the groups, sizes and
    this rank's coordinates along ``data``, ``model`` and ``seq``."""

    def __init__(self, mesh):
        for a in mesh.axis_names:
            if a not in _mesh.AXES and mesh.size(a) > 1:
                raise ValueError(
                    f"transformer over a mesh: axis {a!r} is not one of "
                    f"{_mesh.AXES} (the pipeline is parallel.pipeline)")
        self.mesh = mesh
        self.gm, self.nm = mesh.group("model"), mesh.size("model")
        self.rm = mesh.coordinate("model")
        self.gs, self.ns = mesh.group("seq"), mesh.size("seq")
        self.rs = mesh.coordinate("seq")
        self.gd, self.nd = mesh.group("data"), mesh.size("data")
        self.rd = mesh.coordinate("data")

    def local(self, a, seq: bool = True):
        """This rank's rows (over ``data``) and, for ``seq``, its
        positions (over ``seq``) of a global ``[B, T, ...]`` array."""
        B = a.shape[0]
        if B % self.nd:
            raise ValueError(f"batch of {B} does not split over a data "
                             f"axis of {self.nd}")
        b = B // self.nd
        a = a[self.rd * b:(self.rd + 1) * b]
        if seq and a.dim() > 1:
            T = a.shape[1]
            if T % self.ns:
                raise ValueError(f"sequence of {T} does not split over a "
                                 f"seq axis of {self.ns}")
            t = T // self.ns
            a = a[:, self.rs * t:(self.rs + 1) * t]
        return a

    def whole(self, x):
        """A local ``[b, t, ...]`` result joined over ``seq`` and
        ``data`` (differentiable all-gathers)."""
        x = _coll.all_gather_grad(x, self.gs, 1) if self.ns > 1 else x
        return _coll.all_gather_grad(x, self.gd, 0) if self.nd > 1 else x

    def t_offset(self, t_local: int) -> int:
        return self.rs * t_local


def _layer_norm(x, p, eps: float = 1e-5):
    """fp32 LayerNorm over the last axis of x [B, T, E], resolved
    through the registry on the [B*T, E] view."""
    B, T, E = x.shape
    y = registry.get("layer_norm")(x.float().reshape(B * T, E),
                                   p["g"].float(), p["b"].float(), eps=eps)
    return y.reshape(B, T, E)


def _attention(x, lp, cfg: TransformerConfig, attn_mask=None,
               par: Optional[_Par] = None):
    """Self-attention of x [B, T, E]: all heads, or over a mesh this
    rank's ``H/model`` heads on its ``T/seq`` positions (the ring when
    the ``seq`` axis splits T), then the row-parallel output projection
    and its all-reduce over ``model``."""
    B, T, E = x.shape
    H = cfg.n_heads
    D = E // H
    nm = par.nm if par is not None else 1
    El, Hl = E // nm, H // nm
    qkv = x @ lp["wqkv"] + lp["bqkv"]
    q, k, v = qkv.split(El, dim=-1)   # [q | k | v] thirds, strided views
    q = q.reshape(B, T, Hl, D)
    k = k.reshape(B, T, Hl, D)
    v = v.reshape(B, T, Hl, D)
    if par is not None and par.ns > 1:
        if attn_mask is not None:
            raise ValueError("padding masks are not supported on the "
                             "ring-attention path (as in the JAX package)")
        from deeplearning4j_tpu_torch.parallel.sequence import ring_attention
        ctx = ring_attention(q, k, v, par.mesh, axis_name="seq",
                             is_causal=cfg.causal, batch_axis="data",
                             head_axis="model" if nm > 1 else None)
    elif cfg.use_flash_attention and attn_mask is None:
        ctx = attn_ops.flash_attention(q, k, v, is_causal=cfg.causal)
    else:
        m = attn_mask[:, None, None, :] if attn_mask is not None else None
        ctx = attn_ops.dot_product_attention(q, k, v, mask=m,
                                             is_causal=cfg.causal)
    out = ctx.reshape(B, T, El) @ lp["wo"]
    if par is not None:
        out = _coll.all_reduce_sum_grad(out, par.gm)
    return out + lp["bo"]


def _mlp(h, lp, approximate: str, par: Optional[_Par] = None):
    """``gelu(h @ w1 + b1) @ w2 + b2``; over a mesh the column/row split
    pair and its all-reduce over ``model``."""
    h = nn.functional.gelu(h @ lp["w1"] + lp["b1"], approximate=approximate)
    h = h @ lp["w2"]
    if par is not None:
        h = _coll.all_reduce_sum_grad(h, par.gm)
    return h + lp["b2"]


def _embed_tokens(emb, tokens, par: Optional[_Par] = None):
    """``embed.tok`` rows of ``tokens``: over a vocabulary split, each
    rank looks up the ids in its range (zeros elsewhere) and an
    all-reduce over ``model`` joins them."""
    tok = emb["tok"]
    if par is None or par.nm == 1:
        return tok[tokens]
    vl = tok.shape[0]
    ids = tokens - par.rm * vl
    inside = (ids >= 0) & (ids < vl)
    x = tok[ids.clamp(0, vl - 1)] * inside[..., None].to(tok.dtype)
    return _coll.all_reduce_sum_grad(x, par.gm)


def _head(params, cfg: TransformerConfig):
    w = params["embed"]["tok"].t() if cfg.tie_embeddings else params["lm_head"]
    return w.to(cfg.dtype)


def _logits(x, params, cfg: TransformerConfig, par: Optional[_Par] = None):
    """fp32 logits of x; over a vocabulary split each rank's columns,
    all-gathered over ``model``."""
    out = (x.to(cfg.dtype) @ _head(params, cfg)).float()
    if par is not None and par.nm > 1:
        out = _coll.all_gather_grad(out, par.gm, -1)
    return out


def _encode(params, tokens, cfg: TransformerConfig, token_type_ids=None,
            attn_mask=None, par: Optional[_Par] = None):
    rec = _dt.recorder()
    B, T = tokens.shape
    emb = params["embed"]
    eps = cfg.layer_norm_eps
    t0 = par.t_offset(T) if par is not None else 0
    with _dt.layer_scope(rec, 0, "embed"):
        x = _embed_tokens(emb, tokens, par) + emb["pos"][t0:t0 + T][None]
        if "type" in emb:
            tt = token_type_ids if token_type_ids is not None \
                else torch.zeros((B, T), dtype=torch.long,
                                 device=tokens.device)
            x = x + emb["type"][tt]
    with _dt.layer_scope(rec, 1, "emb_norm"):
        x = _layer_norm(x, params["emb_norm"], eps).to(cfg.dtype)
    for b, lp in enumerate(params["layers"]):
        i = 2 + 4 * b
        with _dt.layer_scope(rec, i, f"b{b}.attn"):
            a = _attention(x, lp, cfg, attn_mask=attn_mask, par=par)
        with _dt.layer_scope(rec, i + 1, f"b{b}.ln1"):
            x = _layer_norm(x + a, lp["ln1"], eps).to(cfg.dtype)
        with _dt.layer_scope(rec, i + 2, f"b{b}.mlp"):
            h = _mlp(x, lp, "none", par)
        with _dt.layer_scope(rec, i + 3, f"b{b}.ln2"):
            x = _layer_norm(x + h, lp["ln2"], eps).to(cfg.dtype)
    return x.float()


def encode(params, tokens, cfg: TransformerConfig, token_type_ids=None,
           attn_mask=None, mesh=None):
    """Faithful post-LN BERT encoder: tokens [B, T] -> hidden [B, T, E]
    (fp32): embedding LayerNorm, post-LN residuals, exact-erf gelu. While
    ``profiler.devicetime`` records, each sublayer runs in its scope
    (``devicetime.transformer_scopes``). With ``mesh`` the params are
    this rank's pieces (:func:`shard_params`), ``tokens`` (and the
    masks) the global batch, and the result is the global hidden state,
    gathered."""
    if mesh is None:
        return _encode(params, tokens, cfg, token_type_ids, attn_mask)
    par = _Par(mesh)
    x = _encode(params, par.local(tokens), cfg,
                None if token_type_ids is None
                else par.local(token_type_ids),
                None if attn_mask is None else par.local(attn_mask), par)
    return par.whole(x)


def _forward(params, tokens, cfg: TransformerConfig,
             par: Optional[_Par] = None):
    """Logits of ``tokens`` (this rank's rows and positions over a
    mesh: ``par``)."""
    rec = _dt.recorder()
    if cfg.arch == "postln_bert":
        x = _encode(params, tokens, cfg, par=par)
        with _dt.layer_scope(rec, 2 + 4 * cfg.n_layers, "head"):
            return _logits(x, params, cfg, par)
    B, T = tokens.shape
    emb = params["embed"]
    t0 = par.t_offset(T) if par is not None else 0
    with _dt.layer_scope(rec, 0, "embed"):
        x = (_embed_tokens(emb, tokens, par)
             + emb["pos"][t0:t0 + T][None]).to(cfg.dtype)
    for b, lp in enumerate(params["layers"]):
        i = 1 + 4 * b
        with _dt.layer_scope(rec, i, f"b{b}.ln1"):
            h = _layer_norm(x, lp["ln1"]).to(cfg.dtype)
        with _dt.layer_scope(rec, i + 1, f"b{b}.attn"):
            x = x + _attention(h, lp, cfg, par=par)
        with _dt.layer_scope(rec, i + 2, f"b{b}.ln2"):
            h = _layer_norm(x, lp["ln2"]).to(cfg.dtype)
        with _dt.layer_scope(rec, i + 3, f"b{b}.mlp"):
            # jax.nn.gelu defaults to the tanh approximation
            x = x + _mlp(h, lp, "tanh", par)
    n = 1 + 4 * cfg.n_layers
    with _dt.layer_scope(rec, n, "final_norm"):
        x = _layer_norm(x, params["final_norm"])
    with _dt.layer_scope(rec, n + 1, "head"):
        return _logits(x, params, cfg, par)


def forward(params, tokens, cfg: TransformerConfig, mesh=None):
    """tokens [B, T] int -> logits [B, T, V] (fp32). Scoped per sublayer
    while ``profiler.devicetime`` records, as :func:`encode`. With
    ``mesh`` the params are this rank's pieces, ``tokens`` the global
    batch (the same on every rank) and the logits the global ``[B, T,
    V]``, gathered over ``data`` and ``seq`` (JAX transformer.py:140-
    220)."""
    if mesh is None:
        return _forward(params, tokens, cfg)
    par = _Par(mesh)
    return par.whole(_forward(params, par.local(tokens), cfg, par))


def _nll(logits, targets):
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0]


def loss_fn(params, tokens, targets, cfg: TransformerConfig, mesh=None,
            target_mask=None):
    """Masked-LM / causal-LM token cross-entropy in fp32: the NLL of
    ``log_softmax(logits)`` at ``targets``, averaged over
    ``max(sum(target_mask), 1)`` tokens (a plain mean without a mask).
    With ``mesh`` (global ``tokens``/``targets``/``target_mask``, this
    rank's param pieces) each rank sums its rows' and positions' NLL
    over the global count and a differentiable all-reduce over ``data``
    and ``seq`` makes the global loss, the same on every rank."""
    if mesh is None:
        nll = _nll(_forward(params, tokens, cfg), targets)
        if target_mask is not None:
            mask = target_mask.float()
            return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
        return nll.mean()
    par = _Par(mesh)
    nll = _nll(_forward(params, par.local(tokens), cfg, par),
               par.local(targets))
    if target_mask is not None:
        count = torch.clamp_min(target_mask.float().sum(), 1.0)
        part = (nll * par.local(target_mask).float()).sum() / count
    else:
        part = nll.sum() / float(targets.numel())
    for g, n in ((par.gd, par.nd), (par.gs, par.ns)):
        if n > 1:
            part = _coll.all_reduce_sum_grad(part, g)
    return part


def _leaf_paths(tree, prefix=(), tuple_leaves: bool = False
                ) -> List[Tuple]:
    """``(path, leaf)`` in the JAX pytree order (dict keys sorted); a
    spec tree's tuples are leaves under ``tuple_leaves``."""
    seqs = list if tuple_leaves else (list, tuple)
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _leaf_paths(tree[k], prefix + (k,), tuple_leaves)]
    if isinstance(tree, seqs):
        return [pl for i, v in enumerate(tree)
                for pl in _leaf_paths(v, prefix + (i,), tuple_leaves)]
    return [(prefix, tree)]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def make_train_step(cfg: TransformerConfig, updater, mesh=None):
    """One training step, ``step(params, opt_state, t, tokens, targets,
    target_mask=None) -> loss`` (JAX transformer.py:241-265).

    ``t`` is the step counter, a 0-d int32 tensor on the params' device.
    The step takes ``torch.autograd.grad`` of :func:`loss_fn` over every
    leaf of ``params`` (each becomes an autograd leaf), runs the updater
    per leaf in fp32 (``lr_at`` and the bias correction from ``t`` on the
    device) and writes ``(p.float() - u)`` back in the param's dtype: bf16
    params stay bf16, with no fp32 masters. Params, updater state and
    ``t`` (incremented) are updated in place; nothing is read on the host,
    so the step can be captured. Returns the loss, a device scalar.

    With ``mesh`` the params (and their updater state) are this rank's
    pieces and ``tokens``/``targets`` the global batch: the step
    backpropagates the global loss over the mesh's size and sums each
    gradient over the mesh axes its param is whole on (one flat
    all-reduce an axis; :func:`reduce_mesh_grads`). It captures at world
    1; over gloo its host-staged collectives cannot be captured, so there
    it runs eagerly."""

    def step(params, opt_state, t, tokens, targets, target_mask=None):
        paths = _leaf_paths(params)
        leaves = [p for _, p in paths]
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        loss = loss_fn(params, tokens, targets, cfg, mesh=mesh,
                       target_mask=target_mask)
        obj = loss if mesh is None else loss / float(mesh.size())
        # a leaf the loss does not reach (a post-LN BERT's final_norm)
        # gets zeros, as jax.grad gives
        grads = torch.autograd.grad(obj, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        if mesh is not None:
            grads = reduce_mesh_grads(leaves, grads, mesh)
        apply_updates(paths, grads, opt_state, updater, t)
        return loss.detach()

    return step


def reduce_mesh_grads(leaves, grads, mesh) -> List[torch.Tensor]:
    """Each gradient summed over every mesh axis of size above 1 its
    param is not split over (a piece's gradient is already whole within
    its line): one flat all-reduce an axis over the leaves it covers."""
    grads = list(grads)
    for axis in mesh.axis_names:
        if mesh.size(axis) == 1:
            continue
        idx = [i for i, p in enumerate(leaves)
               if axis not in getattr(_mesh.placement_of(p), "axes", ())]
        summed = _coll.flat_all_reduce([grads[i] for i in idx],
                                       mesh.group(axis))
        for i, g in zip(idx, summed):
            grads[i] = g
    return grads


def apply_updates(paths, grads, opt_state, updater, t) -> None:
    """The updater per leaf in fp32, written back in place in the param's
    dtype, then ``t += 1``."""
    lr = updater.lr_at(t)
    with torch.no_grad():
        for (path, p), g in zip(paths, grads):
            state = _at(opt_state, path)
            # optimizer math in fp32 even for bf16 params
            u, s2 = updater.apply(g.float(), state, lr, t)
            p.copy_((p.float() - u).to(p.dtype))
            for k, v in s2.items():
                state[k].copy_(v)
        t.add_(1)


def init_opt_state(params, updater):
    """The updater's state for every leaf, in fp32, in the params' tree
    shape."""
    if isinstance(params, dict):
        return {k: init_opt_state(v, updater) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [init_opt_state(v, updater) for v in params]
    return updater.init_state(params.detach().float())


def copy_params(tree):
    """Detached copies of every tensor of a parameter tree: the snapshot a
    trainer hands over (a served ``TransformerLM(cfg, params=
    copy_params(params))``), which the trainer's in-place updates (a
    captured step's) do not reach."""
    if isinstance(tree, dict):
        return {k: copy_params(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [copy_params(v) for v in tree]
    return tree.detach().clone()


def _as_module(tree) -> nn.Module:
    """Register a parameter tree's leaves (same tensor objects) on a
    module tree, so ``state_dict``/``parameters`` see them."""
    if isinstance(tree, list):
        return nn.ModuleList([_as_module(t) for t in tree])
    mod = nn.Module()
    for key, val in tree.items():
        if isinstance(val, nn.Parameter):
            mod.register_parameter(key, val)
        else:
            mod.add_module(key, _as_module(val))
    return mod


def _frozen(tree):
    if isinstance(tree, dict):
        return {k: _frozen(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_frozen(v) for v in tree]
    return _mesh.set_placement(nn.Parameter(tree, requires_grad=False),
                               _mesh.placement_of(tree))


class TransformerLM(nn.Module):
    """The model the zoo and the server use: ``logits(tokens)`` runs
    :func:`forward` under ``torch.inference_mode()``. Parameters come
    from ``seed`` (:func:`init_params`) unless ``params`` is given (e.g.
    from :func:`params_from_jax`).

    With ``mesh`` (or after :meth:`setShardingPlan`) each rank holds its
    pieces of the Megatron layout (:func:`param_shardings`) and
    ``logits(tokens)`` takes this rank's rows of the batch (what a
    serving rank is handed): the positions split over ``seq`` and the
    heads over ``model`` inside, the logits of those rows come back
    whole."""

    def __init__(self, cfg: TransformerConfig, seed: int = 0, device=None,
                 params: Optional[Dict] = None, mesh=None):
        super().__init__()
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device) if mesh is None \
            else mesh.device
        if params is None:
            params = init_params(cfg, seed, self.device)
        self._set_params(params)

    def _set_params(self, params) -> None:
        if self.mesh is not None and not any(
                _mesh.placement_of(p) is not None
                for _, p in _leaf_paths(params)):
            params = shard_params(params, self.cfg, self.mesh)
        self.params = _frozen(params)
        self.tree = _as_module(self.params)

    def setShardingPlan(self, plan):
        """Place the params per :func:`param_shardings` over ``plan``'s
        mesh (a ``ShardedTrainingPlan``'s, or a ``DeviceMesh``; None:
        gathered whole onto this rank). The plan's rules do not apply:
        the layout is the model's own."""
        mesh = getattr(plan, "mesh", plan)
        whole = self.params
        if self.mesh is not None:
            whole = gather_params(self.params, self.mesh)
        self.mesh = mesh
        if mesh is not None:
            self.device = mesh.device
        self._set_params(_tree_apply(whole, lambda t: t.detach()))
        return self

    def forward(self, tokens):
        tokens = torch.as_tensor(np.asarray(tokens) if not isinstance(
            tokens, torch.Tensor) else tokens).to(self.device, torch.long)
        if self.mesh is None:
            return _forward(self.params, tokens, self.cfg)
        par = _Par(self.mesh)
        T = tokens.shape[1]
        if T % par.ns:
            raise ValueError(f"sequence of {T} does not split over a seq "
                             f"axis of {par.ns}")
        t = T // par.ns
        out = _forward(self.params, tokens[:, par.rs * t:(par.rs + 1) * t],
                       self.cfg, par)
        if par.ns > 1:
            out = _coll.all_gather_grad(out, par.gs, 1)
        return out

    def logits(self, tokens):
        with torch.inference_mode():
            return self.forward(tokens)

    def collective(self) -> bool:
        """Whether a forward runs collectives (a mesh with more than one
        rank on ``model`` or ``seq``): a server then runs it eagerly on
        every rank together."""
        return self.mesh is not None and \
            self.mesh.size("model") * self.mesh.size("seq") > 1

    def n_params(self) -> int:
        return sum(int(np.prod(_mesh.global_shape(p)))
                   for p in self.parameters())
