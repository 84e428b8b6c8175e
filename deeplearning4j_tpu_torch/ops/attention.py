"""Attention ops over ``[B, T, H, D]`` tensors (the slice's subset of
``deeplearning4j_tpu/ops/attention.py``).

``flash_attention`` dispatches to the installed platform override (the
CUDA kernel of :mod:`.cuda_kernels`) and otherwise runs the blockwise
formulation ``_flash_attention_scan``, which is also the generic op for
masked calls and for shapes outside the kernel's gate.
"""

from __future__ import annotations

import math

import torch

_NEG = -1e30


def dot_product_attention(q, k, v, *, mask=None, scaled: bool = True,
                          is_causal: bool = False):
    """Scaled dot-product attention over [B, T, H, D] tensors.

    mask: broadcastable to [B, H, Tq, Tk]; 1 = attend, 0 = block.
    """
    B, Tq, H, D = q.shape
    scale = torch.tensor(1.0 / math.sqrt(D) if scaled else 1.0,
                         dtype=q.dtype, device=q.device)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    neg = torch.tensor(_NEG, dtype=scores.dtype, device=scores.device)
    if mask is not None:
        scores = torch.where(mask > 0, scores, neg)
    if is_causal:
        causal = torch.tril(torch.ones((Tq, k.shape[1]), dtype=torch.bool,
                                       device=q.device))
        scores = torch.where(causal[None, None], scores, neg)
    weights = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def flash_attention(q, k, v, *, mask=None, is_causal: bool = False,
                    block_size: int = 512):
    """Blockwise attention with online softmax — O(T) memory.

    Dispatch: the ``flash_attention`` platform override (the CUDA kernel,
    ``ops.cuda_kernels.make_flash_attention_override``) takes the call
    when installed; otherwise the blockwise formulation below runs.
    Shapes: q [B, Tq, H, D]; k, v [B, Tk, H, D]; mask broadcastable to
    [B, H, Tq, Tk].
    """
    from deeplearning4j_tpu_torch.ops import registry as _reg
    ov = _reg._PLATFORM_OVERRIDES.get("flash_attention")
    if ov is not None:
        return ov(q, k, v, mask=mask, is_causal=is_causal,
                  block_size=block_size)
    return _flash_attention_scan(q, k, v, mask=mask, is_causal=is_causal,
                                 block_size=block_size)


def _flash_attention_scan(q, k, v, *, mask=None, is_causal: bool = False,
                          block_size: int = 512):
    """The portable blockwise formulation (fp32 accumulation; Tk padded
    to a multiple of the block) — also the generic op for masks and
    shapes the kernel rejects."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    blk = min(block_size, Tk)
    pad = (-Tk) % blk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    nblk = (Tk + pad) // blk
    scale = 1.0 / math.sqrt(D)
    dev = q.device

    qf = q.float() * scale
    kf = k.float()
    vf = v.float()
    q_pos = torch.arange(Tq, device=dev)
    neg = torch.tensor(_NEG, dtype=torch.float32, device=dev)
    full = None
    if mask is not None:
        full = torch.broadcast_to(mask > 0, (B, H, Tq, Tk))
        if pad:
            full = torch.cat([full, full.new_zeros((B, H, Tq, pad))], dim=-1)

    m_run = torch.full((B, H, Tq), _NEG, device=dev)
    l_run = torch.zeros((B, H, Tq), device=dev)
    acc = torch.zeros((B, H, Tq, D), device=dev)
    for bidx in range(nblk):
        kb = kf[:, bidx * blk:(bidx + 1) * blk]
        vb = vf[:, bidx * blk:(bidx + 1) * blk]
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kb)
        k_pos = bidx * blk + torch.arange(blk, device=dev)
        s = torch.where((k_pos < Tk)[None, None, None, :], s, neg)
        if is_causal:
            cm = q_pos[:, None] >= k_pos[None, :]
            s = torch.where(cm[None, None], s, neg)
        if full is not None:
            mb = full[..., bidx * blk:(bidx + 1) * blk]
            s = torch.where(mb, s, neg)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        alpha = torch.exp(m_run - m_new)
        p = torch.exp(s - m_new[..., None])
        l_run = l_run * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)
