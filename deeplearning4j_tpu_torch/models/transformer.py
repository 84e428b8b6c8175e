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

Not ported yet (ROADMAP.md): ``param_shardings``, ring attention over a
mesh, ``loss_fn`` and ``make_train_step``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

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
