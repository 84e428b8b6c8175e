"""Sequence (context) parallelism: ring attention over a mesh axis — the
port of ``deeplearning4j_tpu/parallel/sequence.py``.

Each rank of the ``seq`` axis owns ``T/seq`` rows of q, k and v
(``[B, T_local, H, D]``, its piece of a ``[B, T, H, D]`` array split on
dim 1). The keys and values travel around the ring (``ppermute`` over
the axis's group, one message a hop holding both) while each rank
accumulates its queries' attention against every block it holds.

Where the JAX function runs jnp einsums over a ``[B, H, T/seq, T/seq]``
fp32 score block, the port runs its flash kernel on each block
(``ops.cuda_kernels.flash_attention_fwd``, which returns the output and
its log-sum-exp) and merges the blocks in fp32 by their ``lse``: the
same online-softmax accumulation as JAX's ``_block_attend``, with an
O(T/seq * D) working set. Under ``is_causal`` the diagonal block runs
causal, earlier blocks run whole and later blocks are skipped, which is
exact: JAX masks them to -1e30 under a finite row max, so they add
nothing. Rank ``r`` of ``n`` thus launches ``r + 1`` flash kernels a
causal call and ``n`` a full one.

The backward (:class:`_RingAttention`) is the reverse ring: every block
runs ``flash_attention_bwd`` with the global ``o`` and ``lse``, which
is exact per block; ``dq`` accumulates locally while ``dk`` and ``dv``
travel with their block and reach their owner after the last hop.

On the CPU the wrappers take the kernel's plain version
(``flash_attention_plain``), as everywhere else.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.parallel import collectives


def _merge(o_acc, lse_acc, o_b, lse_b):
    """Fold one block's ``(o, lse)`` into the fp32 accumulators: the
    online-softmax update, by log-sum-exp weights."""
    lse_new = torch.logaddexp(lse_acc, lse_b)               # [B,H,T]
    w_old = torch.exp(lse_acc - lse_new).permute(0, 2, 1)[..., None]
    w_new = torch.exp(lse_b - lse_new).permute(0, 2, 1)[..., None]
    return o_acc * w_old + o_b.float() * w_new, lse_new


def _blocks(group, causal: bool) -> dict:
    """``{hop: causal}`` of the blocks this rank attends to: at hop ``i``
    it holds the block that started on rank ``r - i``; under ``causal``
    only those at or before its own, the diagonal one causal."""
    n, r = collectives.group_size(group), collectives.group_rank(group)
    return {i: causal and i == 0 for i in range(n)
            if not (causal and (r - i) % n > r)}


def _ring_forward(q, k, v, group, causal: bool):
    n = collectives.group_size(group)
    B, T, H, D = q.shape
    o_acc = torch.zeros((B, T, H, D), dtype=torch.float32, device=q.device)
    lse = torch.full((B, H, T), -float("inf"), dtype=torch.float32,
                     device=q.device)
    todo = _blocks(group, causal)
    kv = torch.stack([k, v])
    for i in range(n):
        if i in todo:
            o_b, lse_b = ck.flash_attention_fwd(q, kv[0], kv[1], todo[i])
            o_acc, lse = _merge(o_acc, lse, o_b, lse_b)
        if i < n - 1:
            kv = collectives.ppermute(kv, group, 1)
    return o_acc.to(q.dtype), lse


class _RingAttention(torch.autograd.Function):
    """The ring forward, saving ``(q, k, v, o, lse)``; the backward is
    the reverse ring through ``flash_attention_bwd`` (module note)."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal):
        o, lse = _ring_forward(q, k, v, group, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.causal = group, causal
        return o

    @staticmethod
    def backward(ctx, ct):
        q, k, v, o, lse = ctx.saved_tensors
        group, causal = ctx.group, ctx.causal
        n = collectives.group_size(group)
        todo = _blocks(group, causal)
        # fp32 operands: each block's gradients come back in fp32 and
        # accumulate there, whatever the inputs' dtype
        qf, of, cf = q.float(), o.float(), ct.float()
        kv = torch.stack([k, v]).float()
        dq = torch.zeros_like(qf)
        dkv = torch.zeros_like(kv)
        for i in range(n):
            if i in todo:
                dq_b, dk_b, dv_b = ck.flash_attention_bwd(
                    qf, kv[0], kv[1], of, lse, cf, todo[i])
                dq += dq_b
                dkv[0] += dk_b
                dkv[1] += dv_b
            if i < n - 1:
                kv = collectives.ppermute(kv, group, 1)
                dkv = collectives.ppermute(dkv, group, 1)
        # after n - 1 hops a rank holds block r + 1's gradients: one more
        # hop hands them to their owner
        dkv = collectives.ppermute(dkv, group, 1)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None)


def ring_attention(q, k, v, mesh, *, axis_name: str = "seq",
                   is_causal: bool = False, batch_axis: str = "data",
                   head_axis: str = None):
    """Ring attention over this rank's pieces ``q, k, v`` ``[B_local,
    T_local, H_local, D]`` of ``[B, T, H, D]`` arrays whose T is split
    over ``axis_name`` (this rank's block is ``coordinate(axis_name)``),
    B over ``batch_axis`` and, under tensor parallelism, H over
    ``head_axis`` (``"model"``): the heads stay split and each rank runs
    its own. Returns this rank's rows of the output, ``[B_local,
    T_local, H_local, D]``, differentiable. ``batch_axis`` and
    ``head_axis`` only name the layout: rows and heads never cross
    ranks. On a mesh whose ``axis_name`` has one rank this is the flash
    kernel alone."""
    del batch_axis, head_axis
    group = mesh.group(axis_name) if mesh is not None else None
    if q.stride(-1) != 1:
        q = q.contiguous()
    k, v = k.contiguous(), v.contiguous()
    return _RingAttention.apply(q, k, v, group, bool(is_causal))


def ring_attention_reference(q, k, v, is_causal: bool = False):
    """Single-device reference for tests: exact attention."""
    from deeplearning4j_tpu_torch.ops.attention import dot_product_attention
    return dot_product_attention(q, k, v, is_causal=is_causal)
