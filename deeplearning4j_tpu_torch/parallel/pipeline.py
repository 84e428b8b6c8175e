"""Pipeline parallelism: GPipe-style microbatched stage execution over a
``pipe`` mesh axis — the port of ``deeplearning4j_tpu/parallel/
pipeline.py``.

Stage weights are the ``[L, ...]`` stacked blocks split over the
``pipe`` axis of the same :class:`~deeplearning4j_tpu_torch.parallel.
mesh.DeviceMesh` every other strategy uses (``DeviceMesh.from_axes(
{"data": d, "pipe": p})``); stage-to-stage transfer is ``ppermute``
over the axis's group.

Schedule (P stages, M microbatches, M + P - 1 ticks):

    tick t: stage 0 injects microbatch t (while t < M); every stage s
    runs its block on the activation it holds; results move s -> s+1;
    stage P-1's result for microbatch t-(P-1) lands in the output
    buffer; a masked all-reduce over ``pipe`` ends the schedule, so
    every stage holds the outputs.

The bubble fraction is (P-1)/(M+P-1), exactly GPipe's. JAX runs the
schedule as a ``scan`` and gets the backward by differentiating it,
every stage computing every tick (bubble ticks on zeros). The port runs
the schedule in :class:`_Pipeline`, a ``torch.autograd.Function`` whose
backward is the reverse schedule written out: tick by tick from the
last, each stage backpropagates the graph its tick built from the
gradient the next stage sent back, and sends its input's gradient to the
previous stage (the reverse ``ppermute``), summing its parameters'
gradients. A stage skips its bubble ticks (it computes only while it
holds a real microbatch, ticks ``s .. s+M-1``): that is exact, since a
bubble tick's output never reaches the output buffer, and it is the
same exchange on every rank, so the ranks' messages stay matched.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch

from deeplearning4j_tpu_torch.parallel import collectives
from deeplearning4j_tpu_torch.parallel.mesh import DeviceMesh


def microbatch(x, n_micro: int):
    """[B, ...] -> [n_micro, B/n_micro, ...]."""
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by n_micro={n_micro}")
    return x.reshape((n_micro, B // n_micro) + tuple(x.shape[1:]))


def unmicrobatch(x):
    return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))


def _stack(xs):
    first = xs[0]
    if isinstance(first, dict):
        return {k: _stack([x[k] for x in xs]) for k in first}
    return torch.stack(list(xs))


def stack_stage_params(layer_params_list):
    """List of per-layer trees (identical structure) -> one tree whose
    leaves gain a leading layer dim [L, ...] — the shape ``pipe``
    splits."""
    return _stack(list(layer_params_list))


def _flatten(tree, out: List):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _flatten(v, out)
    else:
        out.append(tree)
    return out


def _unflatten(tree, it):
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_unflatten(v, it) for v in tree]
    return next(it)


class _Pipeline(torch.autograd.Function):
    """The GPipe schedule on this stage (module note). Inputs: the stage
    function, the params' tree, the axis's group, the microbatches
    ``xs [M, mb, ...]`` and the params' leaves; output: the last stage's
    outputs ``[M, mb, ...]`` (zeros on the other stages)."""

    @staticmethod
    def forward(ctx, stage_fn, tree, group, xs, *leaves):
        n_pipe = collectives.group_size(group)
        stage = collectives.group_rank(group)
        n_micro = xs.shape[0]
        last = stage == n_pipe - 1
        ticks = n_micro + n_pipe - 1
        state = torch.zeros_like(xs[0])
        outs = torch.zeros_like(xs)
        tapes = []      # (tick, input leaf, output) of each computed tick
        with torch.enable_grad():
            params = [p.detach().requires_grad_(p.requires_grad)
                      for p in leaves]
            local = _unflatten(tree, iter(params))
            for t in range(ticks):
                act = xs[min(t, n_micro - 1)] if stage == 0 else state
                if stage <= t < stage + n_micro:
                    a = act.detach().requires_grad_(True)
                    y = stage_fn(local, a)
                    tapes.append((t, a, y))
                    if last and t >= n_pipe - 1:
                        outs[t - (n_pipe - 1)] = y.detach()
                    y_send = y.detach()
                else:
                    y_send = torch.zeros_like(xs[0])
                if t < ticks - 1:
                    state = collectives.ppermute(y_send, group, 1,
                                                 wrap=False)
        ctx.tapes, ctx.params, ctx.group = tapes, params, group
        ctx.meta = (n_pipe, stage, n_micro, ticks)
        ctx.x_shape = xs.shape
        return outs

    @staticmethod
    def backward(ctx, g_outs):
        n_pipe, stage, n_micro, ticks = ctx.meta
        group = ctx.group
        last = stage == n_pipe - 1
        tapes = {t: (a, y) for t, a, y in ctx.tapes}
        params = ctx.params
        want = [p for p in params if p.requires_grad]
        g_params = [torch.zeros_like(p) if p.requires_grad else None
                    for p in params]
        g_xs = torch.zeros(ctx.x_shape, dtype=g_outs.dtype,
                           device=g_outs.device)
        g_state = None      # gradient of what this stage sent at tick t
        for t in reversed(range(ticks)):
            if t < ticks - 1:
                # the reverse exchange of tick t's ppermute
                g_state = collectives.ppermute(g_state, group, -1,
                                               wrap=False)
            else:
                g_state = torch.zeros(ctx.x_shape[1:], dtype=g_outs.dtype,
                                      device=g_outs.device)
            g_in = torch.zeros_like(g_state)
            if t in tapes:
                a, y = tapes[t]
                g_y = g_state
                if last and t >= n_pipe - 1:
                    g_y = g_y + g_outs[t - (n_pipe - 1)]
                got = torch.autograd.grad(y, [a] + want, g_y,
                                          allow_unused=True)
                g_in = got[0] if got[0] is not None else g_in
                it = iter(got[1:])
                for i, p in enumerate(params):
                    if p.requires_grad:
                        g = next(it)
                        if g is not None:
                            g_params[i] += g
            if stage == 0:
                g_xs[min(t, n_micro - 1)] += g_in
                g_state = torch.zeros_like(g_in)
            else:
                g_state = g_in
        ctx.tapes = None
        return (None, None, None, g_xs, *g_params)


def pipeline_apply(stage_fn: Callable, stage_params: Any, x,
                   mesh: DeviceMesh, axis: str = "pipe",
                   data_axis: Optional[str] = "data"):
    """Run ``x`` through all pipeline stages.

    ``stage_fn(local_params, act) -> act``: applied once per stage; it
    receives this stage's piece of ``stage_params`` (leading layer dim
    L/P — loop over it for multi-layer stages) and must preserve
    ``act``'s shape. ``stage_params`` leaves are this rank's ``[L/P,
    ...]`` pieces of the ``pipe`` split. ``x`` is ``[n_micro, mb,
    ...]``: this rank's rows (``mb`` split over ``data_axis``; callers
    microbatch their rows first); returns the same shape on every stage.
    Differentiable end to end."""
    del data_axis
    n_pipe = mesh.size(axis)
    n_micro = x.shape[0]
    if n_micro < n_pipe:
        raise ValueError(f"n_micro={n_micro} < pipeline depth {n_pipe}: "
                         f"every stage needs at least one microbatch")
    group = mesh.group(axis)
    leaves = _flatten(stage_params, [])
    outs = _Pipeline.apply(stage_fn, stage_params, group, x, *leaves)
    # only the last stage holds real outputs; summed over the axis so
    # the head and loss see them everywhere
    return collectives.all_reduce_sum_grad(outs, group)


# --------------------------------------------------------- flagship wiring
def pipeline_param_shardings(cfg, mesh: DeviceMesh = None,
                             axis: str = "pipe"):
    """The specs of :func:`to_pipeline_params`'s tree: blocks ``[L,
    ...]`` split over the pipe axis, embeddings and the final norm
    replicated (they run outside the pipeline region)."""
    del mesh
    s = (axis,)
    blocks = {
        "ln1": {"g": s, "b": s},
        "wqkv": s, "bqkv": s,
        "wo": s, "bo": s,
        "ln2": {"g": s, "b": s},
        "w1": s, "b1": s,
        "w2": s, "b2": s,
    }
    return {"embed": {"tok": (), "pos": ()},
            "final_norm": {"g": (), "b": ()},
            "blocks": blocks}


def to_pipeline_params(params):
    """``models.transformer.init_params`` layout -> pipeline layout: the
    per-layer list becomes stacked ``[L, ...]`` leaves."""
    out = {k: v for k, v in params.items() if k != "layers"}
    out["blocks"] = stack_stage_params(params["layers"])
    return out


def shard_pipeline_params(params, cfg, mesh: DeviceMesh, axis: str = "pipe"):
    """A whole pipeline-layout tree placed per
    :func:`pipeline_param_shardings`: this stage's blocks, tagged."""
    from deeplearning4j_tpu_torch.parallel.mesh import place_by_spec
    specs = pipeline_param_shardings(cfg, mesh, axis)

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        return place_by_spec(mesh, tree.detach(), spec)
    return walk(params, specs)


def _block(lp, x, cfg):
    """One pre-LN transformer block on a microbatch: the body
    ``models.transformer.forward`` runs per layer, through the same
    layer-norm and attention seams (the kernels on the card)."""
    from deeplearning4j_tpu_torch.models import transformer as tfm
    h = tfm._layer_norm(x, lp["ln1"]).to(cfg.dtype)
    x = x + tfm._attention(h, lp, cfg)
    h = tfm._layer_norm(x, lp["ln2"]).to(cfg.dtype)
    return x + tfm._mlp(h, lp, "tanh")


def _stage_fn(cfg):
    def stage_fn(local_blocks, act):
        n = next(iter(_flatten(local_blocks, []))).shape[0]
        for i in range(n):
            act = _block(_index(local_blocks, i), act, cfg)
        return act
    return stage_fn


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def pipeline_loss_fn(params, tokens, targets, cfg, mesh: DeviceMesh,
                     n_micro: int, axis: str = "pipe"):
    """Transformer LM loss with the L blocks run as a pipeline over
    ``axis``; the embedding and head run outside it, on every stage
    alike. ``tokens``/``targets`` are the global batch; each rank takes
    its rows of the ``data`` axis. Returns the global mean loss (the same
    on every rank; differentiable, summed over ``data`` by the
    convention of ``parallel.collectives``)."""
    from deeplearning4j_tpu_torch.models import transformer as tfm
    nd, rd = mesh.size("data"), mesh.coordinate("data")
    B, T = tokens.shape
    if B % nd:
        raise ValueError(f"batch of {B} does not split over a data axis "
                         f"of {nd}")
    b = B // nd
    tokens, targets = tokens[rd * b:(rd + 1) * b], targets[rd * b:(rd + 1) * b]
    emb = params["embed"]
    x = (emb["tok"][tokens] + emb["pos"][:T][None]).to(cfg.dtype)
    xm = microbatch(x, n_micro)
    ym = pipeline_apply(_stage_fn(cfg), params["blocks"], xm, mesh,
                        axis=axis)
    x = tfm._layer_norm(unmicrobatch(ym), params["final_norm"])
    logits = (x.to(cfg.dtype) @ emb["tok"].t().to(cfg.dtype)).float()
    part = tfm._nll(logits, targets).sum() / float(B * T)
    return collectives.all_reduce_sum_grad(part, mesh.group("data")) \
        if nd > 1 else part


def make_pipeline_train_step(cfg, updater, mesh: DeviceMesh, n_micro: int,
                             axis: str = "pipe"):
    """fwd + bwd + update with pipelined blocks (the GPipe backward is
    :class:`_Pipeline`'s reverse schedule): ``step(params, opt_state, t,
    tokens, targets) -> loss``, params (this rank's pieces) and updater
    state updated in place and ``t`` incremented, as
    ``models.transformer.make_train_step``. Each gradient is summed over
    the mesh axes its param is whole on (the blocks' over ``data``; the
    embeddings' and final norm's over ``data`` and ``pipe``)."""
    from deeplearning4j_tpu_torch.models import transformer as tfm

    def step(params, opt_state, t, tokens, targets):
        paths = tfm._leaf_paths(params)
        leaves = [p for _, p in paths]
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        loss = pipeline_loss_fn(params, tokens, targets, cfg, mesh,
                                n_micro, axis)
        grads = torch.autograd.grad(loss / float(mesh.size()), leaves,
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        grads = tfm.reduce_mesh_grads(leaves, grads, mesh)
        tfm.apply_updates(paths, grads, opt_state, updater, t)
        return loss.detach()

    return step
