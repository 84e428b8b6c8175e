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

Not ported yet (ROADMAP.md): ``param_shardings`` and ring attention over
a mesh.
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


def params_from_jax(tree, cfg: TransformerConfig, device=None) -> Dict:
    """Carry a JAX ``init_params`` tree (leaves as numpy arrays) over to
    torch tensors of ``cfg.dtype`` on ``device``. bf16 leaves arrive as
    ``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` rejects;
    they go through float32, which holds every bf16 value exactly."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        a = np.asarray(t).astype(np.float32)
        return torch.from_numpy(a).to(device=dev, dtype=cfg.dtype)

    return conv(tree)


def _layer_norm(x, p, eps: float = 1e-5):
    """fp32 LayerNorm over the last axis of x [B, T, E], resolved
    through the registry on the [B*T, E] view."""
    B, T, E = x.shape
    y = registry.get("layer_norm")(x.float().reshape(B * T, E),
                                   p["g"].float(), p["b"].float(), eps=eps)
    return y.reshape(B, T, E)


def _attention(x, lp, cfg: TransformerConfig, attn_mask=None):
    B, T, E = x.shape
    H = cfg.n_heads
    D = E // H
    qkv = x @ lp["wqkv"] + lp["bqkv"]
    q, k, v = qkv.split(E, dim=-1)     # [q | k | v] thirds, strided views
    q = q.reshape(B, T, H, D)
    k = k.reshape(B, T, H, D)
    v = v.reshape(B, T, H, D)
    if cfg.use_flash_attention and attn_mask is None:
        ctx = attn_ops.flash_attention(q, k, v, is_causal=cfg.causal)
    else:
        m = attn_mask[:, None, None, :] if attn_mask is not None else None
        ctx = attn_ops.dot_product_attention(q, k, v, mask=m,
                                             is_causal=cfg.causal)
    return ctx.reshape(B, T, E) @ lp["wo"] + lp["bo"]


def _head(params, cfg: TransformerConfig):
    w = params["embed"]["tok"].t() if cfg.tie_embeddings else params["lm_head"]
    return w.to(cfg.dtype)


def encode(params, tokens, cfg: TransformerConfig, token_type_ids=None,
           attn_mask=None):
    """Faithful post-LN BERT encoder: tokens [B, T] -> hidden [B, T, E]
    (fp32): embedding LayerNorm, post-LN residuals, exact-erf gelu."""
    B, T = tokens.shape
    emb = params["embed"]
    x = emb["tok"][tokens] + emb["pos"][:T][None]
    if "type" in emb:
        tt = token_type_ids if token_type_ids is not None \
            else torch.zeros((B, T), dtype=torch.long, device=tokens.device)
        x = x + emb["type"][tt]
    eps = cfg.layer_norm_eps
    x = _layer_norm(x, params["emb_norm"], eps).to(cfg.dtype)
    for lp in params["layers"]:
        a = _attention(x, lp, cfg, attn_mask=attn_mask)
        x = _layer_norm(x + a, lp["ln1"], eps).to(cfg.dtype)
        h = nn.functional.gelu(x @ lp["w1"] + lp["b1"], approximate="none")
        h = h @ lp["w2"] + lp["b2"]
        x = _layer_norm(x + h, lp["ln2"], eps).to(cfg.dtype)
    return x.float()


def forward(params, tokens, cfg: TransformerConfig):
    """tokens [B, T] int -> logits [B, T, V] (fp32)."""
    if cfg.arch == "postln_bert":
        x = encode(params, tokens, cfg)
        return (x.to(cfg.dtype) @ _head(params, cfg)).float()
    B, T = tokens.shape
    emb = params["embed"]
    x = (emb["tok"][tokens] + emb["pos"][:T][None]).to(cfg.dtype)
    for lp in params["layers"]:
        h = _layer_norm(x, lp["ln1"]).to(cfg.dtype)
        x = x + _attention(h, lp, cfg)
        h = _layer_norm(x, lp["ln2"]).to(cfg.dtype)
        # jax.nn.gelu defaults to the tanh approximation
        h = nn.functional.gelu(h @ lp["w1"] + lp["b1"], approximate="tanh")
        x = x + (h @ lp["w2"] + lp["b2"])
    x = _layer_norm(x, params["final_norm"])
    return (x.to(cfg.dtype) @ _head(params, cfg)).float()


def loss_fn(params, tokens, targets, cfg: TransformerConfig,
            target_mask=None):
    """Masked-LM / causal-LM token cross-entropy in fp32: the NLL of
    ``log_softmax(logits)`` at ``targets``, averaged over
    ``max(sum(target_mask), 1)`` tokens (a plain mean without a mask)."""
    logits = forward(params, tokens, cfg)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets.long()[..., None])[..., 0]
    if target_mask is not None:
        mask = target_mask.float()
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()


def _leaf_paths(tree, prefix=()) -> List[Tuple]:
    """``(path, leaf)`` in the JAX pytree order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _leaf_paths(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in _leaf_paths(v, prefix + (i,))]
    return [(prefix, tree)]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def make_train_step(cfg: TransformerConfig, updater):
    """One training step, ``step(params, opt_state, t, tokens, targets,
    target_mask=None) -> loss`` (JAX transformer.py:241-265).

    ``t`` is the step counter, a 0-d int32 tensor on the params' device.
    The step takes ``torch.autograd.grad`` of :func:`loss_fn` over every
    leaf of ``params`` (each becomes an autograd leaf), runs the updater
    per leaf in fp32 (``lr_at`` and the bias correction from ``t`` on the
    device) and writes ``(p.float() - u)`` back in the param's dtype: bf16
    params stay bf16, with no fp32 masters. Params, updater state and
    ``t`` (incremented) are updated in place; nothing is read on the host,
    so the step can be captured. Returns the loss, a device scalar."""

    def step(params, opt_state, t, tokens, targets, target_mask=None):
        paths = _leaf_paths(params)
        leaves = [p for _, p in paths]
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        loss = loss_fn(params, tokens, targets, cfg, target_mask)
        # a leaf the loss does not reach (a post-LN BERT's final_norm)
        # gets zeros, as jax.grad gives
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        apply_updates(paths, grads, opt_state, updater, t)
        return loss.detach()

    return step


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
    return nn.Parameter(tree, requires_grad=False)


class TransformerLM(nn.Module):
    """The model the zoo and the server use: ``logits(tokens)`` runs
    :func:`forward` under ``torch.inference_mode()``. Parameters come
    from ``seed`` (:func:`init_params`) unless ``params`` is given (e.g.
    from :func:`params_from_jax`)."""

    def __init__(self, cfg: TransformerConfig, seed: int = 0, device=None,
                 params: Optional[Dict] = None):
        super().__init__()
        self.cfg = cfg
        self.device = resolve_device(device)
        if params is None:
            params = init_params(cfg, seed, self.device)
        self.params = _frozen(params)
        self.tree = _as_module(self.params)

    def forward(self, tokens):
        tokens = torch.as_tensor(np.asarray(tokens) if not isinstance(
            tokens, torch.Tensor) else tokens).to(self.device, torch.long)
        return forward(self.params, tokens, self.cfg)

    def logits(self, tokens):
        with torch.inference_mode():
            return self.forward(tokens)

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())
