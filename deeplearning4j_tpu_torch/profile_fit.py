"""Where one training step of ResNet-50, VGG16, Darknet19, TinyYOLO, YOLO2,
the BertBench BERT-base or TextGenerationLSTM spends its time on the
card, eager and captured.

Usage (on a machine with a CUDA card, from the root of a checkout)::

    python3 -m deeplearning4j_tpu_torch.profile_fit
        [--model vgg16|darknet19|tiny_yolo|yolo2|bert|textgen|resnet50_disk]
        [--captured K]

Builds ``zoo.ResNet50(num_classes=1000)`` (the default; a
``ComputationGraph``, one [64, 3, 224, 224] batch of one-hot labels),
``zoo.VGG16(num_classes=1000)`` (``--model vgg16``; a
``MultiLayerNetwork`` with two dropouts, the same batch shape),
``zoo.Darknet19(num_classes=1000)`` (``--model darknet19``; a
``MultiLayerNetwork``, one [32, 3, 224, 224] batch) or
``zoo.TinyYOLO(num_classes=20)`` (``--model tiny_yolo``; a
``MultiLayerNetwork``, one [32, 3, 416, 416] batch whose YOLO labels hold
1-3 boxes an image) or ``zoo.YOLO2(num_classes=80)`` (``--model yolo2``;
a ``ComputationGraph``, the same batch with the COCO classes), random
weights from the zoo's seed, in the bf16 /
NHWC / fused-epilogue configuration with the CUDA kernels installed;
times ``net.fit`` on that batch (host clock around the step and the
``score()`` that waits for it, median of 5 after 2 warm steps) and
traces one more step with ``torch.profiler``. The trace's device time is
summed by kernel name and by group, each kernel going to the first group
its launching op or one of that op's callers names: the
``scale_shift_act`` kernel, its composed backward, the BN statistics
(``channel_moments``, forward and backward), the optimizer
(``_process_and_apply_grads``), dropout's forward (the mask draw and the
select; its backward lands in "rest"), the YOLO loss's forward
(``Yolo2OutputLayer.compute_loss``; its backward runs as generic autograd
ops and lands in "rest"), cuDNN convolutions (forward and backward) and
the rest.

``--model bert`` runs the BertBench step instead (bench.py:224-265):
``TransformerConfig.bert_base`` in bf16 with flash attention, B=64,
T=128, Adam 1e-4, tokens and targets from ``np.random.RandomState(0)``,
an all-ones mask, through ``models.transformer.make_train_step``; its
groups are the flash forward kernel, the composed flash backward, the LN
forward kernel, the composed LN backward, the optimizer
(``apply_updates``), GEMMs, casts and the rest, each kernel going to the
first of those (in that order) that it or a caller names. It also prints
samples/s, tokens/s and MFU (FLOPs a token as bench.py counts them,
against the dense bf16 peak of the card ``torch.cuda.get_device_name()``
names); VGG16's and YOLO2's runs print MFU too (``vgg16_flops``, or
``conv_flops`` of the configuration, x 3 an image).

``--model textgen`` runs one truncated-BPTT window of the char-RNN
(``zoo.TextGenerationLSTM()``: vocabulary 77, two LSTM(256), fp32, Adam
1e-3, clip 5.0) on B=32 sequences of :func:`markov_chars` (seed 0),
window 50 of T=1000, through ``MultiLayerNetwork._fit_window`` (the
window step ``fitTBPTT`` dispatches; the carry is the previous window's);
its groups are the optimizer (``_process_and_apply_grads``, the clip
included), the loss's forward (``RnnOutputLayer.compute_loss``), the
backward (any op under an autograd ``*Backward`` node), the forward
GEMMs (``addmm``/``mm``/``matmul``: the hoisted input projection and the
recurrent ``h @ RW`` of each step) and the gates' forward elementwise
ops (sigmoid, tanh, mul, add, where), each kernel going to the first of
those (in that order) that it or a caller names. With ``--captured K``
the window step is captured (``compilecache.warmup(...,
tbptt_length=50)``) and K windows are timed and traced, one replay each
(K windows a dispatch are not ported). It prints launches a window and
characters/s.

``--model resnet50_disk`` trains ResNet-50 (8 classes, 224², the same
bf16 / NHWC / fused configuration) from JPEG files on disk: the
:func:`noise_jpegs` of bench.py's DataPipelineBench (1024 images of 256²
uniform noise, quality 85, 8 class directories, ``RandomState(42)``,
written to a temporary directory and removed at the end) through
``MultiWorkerImageIterator(workers=os.cpu_count(), batch_size=64,
steps_per_dispatch=4)`` and ``fit(steps_per_dispatch=4, prefetch=2)``
(the megastep captured by ``compilecache.warmup`` first, then one
untraced epoch). It traces one more epoch ending in a host read: the
card's busy share, device ms by kernel name and kind, and, with the
profiling mode on for that epoch, the host's data wait against its
dispatch time and the pipeline's decode, ring-copy and consumer-stall
seconds; it also prints the epoch's images/s and the decode ms an image
on one core. ``--captured`` does not apply to it.

``--captured K`` adds the same model with K steps a dispatch, captured as
one CUDA graph (``fit(steps_per_dispatch=K)`` after
``compilecache.warmup``; for BERT the step through
``stepping.scan_megastep`` and a ``CachedDispatch``), timed per step
(dispatch time / K) and traced over one dispatch. A replayed graph's
kernels have no launching op on the host, so its trace is grouped by
kernel name alone; every trace also sums its device time by kernel kind
(GEMMs, elementwise, reductions, other: by the kernel's own name). Both
runs share one process and one card. It prints one JSON object. Without
a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models import transformer as tfm
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn import compilecache as cc
from deeplearning4j_tpu_torch.nn import network as network_mod
from deeplearning4j_tpu_torch.nn.layers import (ConvolutionLayer,
                                                RnnOutputLayer)
from deeplearning4j_tpu_torch.nn.objdetect import Yolo2OutputLayer, yolo_labels
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
from deeplearning4j_tpu_torch.ops import normalization as norm_ops
from deeplearning4j_tpu_torch.train import stepping
from deeplearning4j_tpu_torch.train.updaters import Adam

BATCH = {"resnet50": 64, "vgg16": 64, "darknet19": 32, "tiny_yolo": 32,
         "yolo2": 32, "bert": 64, "textgen": 32, "resnet50_disk": 64}
#: the from-disk run: bench.py's DataPipelineBench data, K steps a dispatch
DISK_IMAGES = 1024
DISK_SIDE = 256
DISK_HW = 224
DISK_CLASSES = 8
DISK_K = 4
#: TextGenerationLSTM's run: dl4j-examples' LSTMCharModellingExample
#: (sequences of 1000 characters, TBPTT windows of 50, vocabulary 77)
TEXT_LEN = 1000
TEXT_WINDOW = 50
TEXT_VOCAB = 77
#: the YOLO detectors, by ``--model``: (zoo class, classes)
DETECTORS = {"tiny_yolo": (zoo.TinyYOLO, 20), "yolo2": (zoo.YOLO2, 80)}
#: the 224x224 ImageNet classifiers, by ``--model``
CLASSIFIERS = {"resnet50": zoo.ResNet50, "vgg16": zoo.VGG16,
               "darknet19": zoo.Darknet19}
BERT_SEQ = 128
WARM = 2
ITERS = 5

_LABEL = "dl4j::"
#: (group, substring of an op name on the launching op's caller chain)
_SCOPES = (("scale_shift_act backward (composed)", "ScaleShiftAct"),
           ("bn_stats", "ChannelMoments"),
           ("bn_stats", _LABEL + "bn_stats"),
           ("optimizer", _LABEL + "optimizer"),
           ("dropout (forward)", _LABEL + "dropout"),
           ("yolo loss (forward)", _LABEL + "yolo_loss"),
           ("conv (cuDNN)", "convolution"))
#: the BERT step's groups, in priority order: a kernel goes to the first
#: group whose needle names its launching op or any caller (so a GEMM of
#: the composed flash backward is the backward's)
_BERT_SCOPES = (("flash backward (composed)", "_FlashAttentionKernelBackward"),
                ("layer_norm backward (composed)", "_LayerNormKernelBackward"),
                ("optimizer", _LABEL + "optimizer"),
                ("GEMMs", "aten::mm"), ("GEMMs", "aten::addmm"),
                ("GEMMs", "aten::bmm"), ("GEMMs", "aten::matmul"),
                ("casts", "aten::_to_copy"), ("casts", "aten::copy_"))
#: the char-RNN window's groups, in priority order (see the module note)
_TEXTGEN_SCOPES = (("optimizer", _LABEL + "optimizer"),
                   ("loss (forward)", _LABEL + "rnn_loss"),
                   ("backward", "Backward"),
                   ("recurrent GEMMs (forward)", "aten::addmm"),
                   ("recurrent GEMMs (forward)", "aten::mm"),
                   ("recurrent GEMMs (forward)", "aten::matmul"),
                   ("gates (forward)", "aten::sigmoid"),
                   ("gates (forward)", "aten::tanh"),
                   ("gates (forward)", "aten::mul"),
                   ("gates (forward)", "aten::add"),
                   ("gates (forward)", "aten::where"))
#: kernels grouped by their own name (substring of the kernel's name)
_KERNEL_GROUPS = {"resnet50": (("scale_shift_act", "scale_shift_act_kernel"),),
                  "vgg16": (),
                  "darknet19": (("scale_shift_act",
                                 "scale_shift_act_kernel"),),
                  "tiny_yolo": (("scale_shift_act",
                                 "scale_shift_act_kernel"),),
                  "yolo2": (("scale_shift_act", "scale_shift_act_kernel"),),
                  "bert": (("flash forward (kernel)", "flash_fwd_kernel"),
                           ("layer_norm forward (kernel)",
                            "layer_norm_fwd_kernel")),
                  "textgen": (),
                  "resnet50_disk": (("scale_shift_act",
                                     "scale_shift_act_kernel"),)}


#: kernel kinds by the kernel's own name (what a replay's trace can
#: group by): GEMMs (cuBLAS/CUTLASS), elementwise, reductions
_KERNEL_KINDS = (("gemm", ("gemm", "xmma", "cutlass")),
                 ("elementwise", ("elementwise",)),
                 ("reduction", ("reduce",)))


def _scoped(fn, label):
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return fn(*args, **kwargs)
    return wrapped


def _group_of(event, scopes=_SCOPES) -> str:
    """The first group whose needle names the event or one of its
    callers, walking up from the launching op; "rest" if none does."""
    e = event
    while e is not None:
        for group, needle in scopes:
            if needle in e.name:
                return group
        e = e.cpu_parent
    return "rest"


def _group_by_priority(event, scopes=_BERT_SCOPES) -> str:
    """The first group, in ``scopes`` order, whose needle names the event
    or any of its callers; "rest" if none does."""
    chain = []
    e = event
    while e is not None:
        chain.append(e.name)
        e = e.cpu_parent
    for group, needle in scopes:
        if any(needle in name for name in chain):
            return group
    return "rest"


def _device_us(ev) -> float:
    us = getattr(ev, "device_time_total", None)
    if us is None:
        us = getattr(ev, "cuda_time_total", 0.0)
    return us


def profile(run, model: str, captured: bool) -> dict:
    """Trace one call of ``run`` (a step, or a K-step dispatch, ending in
    a host read); device time by kernel name and by group."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    # label the BN statistics, dropout, the optimizer and the YOLO loss
    # for the trace only
    patches = [(norm_ops, "channel_moments", "bn_stats"),
               (norm_ops, "dropout", "dropout"),
               (network_mod.BaseNetwork, "_process_and_apply_grads",
                "optimizer"),
               (tfm, "apply_updates", "optimizer"),
               (Yolo2OutputLayer, "compute_loss", "yolo_loss"),
               (RnnOutputLayer, "compute_loss", "rnn_loss")]
    saved = [(owner, name, getattr(owner, name))
             for owner, name, _ in patches]
    for owner, name, label in patches:
        setattr(owner, name, _scoped(getattr(owner, name), _LABEL + label))
    try:
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            run()
            traced_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    by_kernel, n_kernels = {}, 0
    for ev in prof.key_averages():
        us = _device_us(ev)
        # the labels also show up as ranges on the device's timeline: they
        # are spans, not kernels
        if not us or ev.device_type != torch.autograd.DeviceType.CUDA \
                or ev.key.startswith(_LABEL):
            continue
        n_kernels += ev.count
        by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + us / 1e3
    total = sum(by_kernel.values())
    by_group = {}
    named = _KERNEL_GROUPS[model]
    for group, needle in named:
        by_group[group] = sum(v for k, v in by_kernel.items() if needle in k)
    if not captured:
        for ev in prof.events():
            for k in getattr(ev, "kernels", ()):
                if any(needle in k.name for _, needle in named) \
                        or k.name.startswith(_LABEL):
                    continue
                g = _group_by_priority(ev) if model == "bert" \
                    else _group_by_priority(ev, _TEXTGEN_SCOPES) \
                    if model == "textgen" else _group_of(ev)
                by_group[g] = by_group.get(g, 0.0) + k.duration / 1e3
    attributed = sum(v for g, v in by_group.items() if g != "rest")
    by_group["rest"] = max(total - attributed, 0.0)
    by_kind = {}
    for name, ms in by_kernel.items():
        kind = next((k for k, needles in _KERNEL_KINDS
                     if any(n in name.lower() for n in needles)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + ms
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    return {"traced_ms": traced_ms,
            "traced_device_ms": total,
            "device_busy_share_traced": total / traced_ms,
            "device_kernels": n_kernels,
            "device_ms_by_group": by_group,
            "device_ms_by_kernel_kind": by_kind,
            "top_kernels_ms": [[k[:90], v] for k, v in top]}


def train_flops_per_token(cfg, seq_len: int) -> float:
    """bench.py's count (``transformer_train_flops_per_token``): per
    layer the QKV, output and two FFN products and the attention scores
    and weighted values, plus the LM head; backward twice the forward."""
    L, E, F, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    proj = 2 * E * (3 * E) + 2 * E * E + 2 * (2 * E * F)
    attn = 2 * (2 * seq_len * E)
    head = 2 * E * V
    return 3.0 * (L * (proj + attn) + head)


def vgg16_flops(hw: int = 224, n_classes: int = 1000) -> int:
    """Forward FLOPs an image of VGG16, bench.py's count (``vgg16_flops``:
    the 13 3x3 convs and the three dense layers, ~30.9 GFLOP at 224^2); a
    train step is three times the forward."""
    f, c_in, size = 0, 3, hw
    for n_convs, c_out in [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]:
        for _ in range(n_convs):
            f += 2 * 9 * c_in * c_out * size * size
            c_in = c_out
        size //= 2
    feat = c_in * size * size
    return f + 2 * feat * 4096 + 2 * 4096 * 4096 + 2 * 4096 * n_classes


def conv_flops(net) -> int:
    """Forward FLOPs an image (2 a multiply-add) of a graph's plain
    convolutions, from its configuration's propagated types: YOLO2's
    22 convs at 416^2 come to ~35.0 GFLOP (the BN, pool and activation
    work is left out); a train step is three times the forward."""
    types = net.conf.types
    return sum(2 * n.obj.kernel[0] * n.obj.kernel[1] * n.obj.nIn
               * n.obj.nOut * types[n.name].height * types[n.name].width
               for n in net.conf.topo
               if type(n.obj) is ConvolutionLayer)


def dense_bf16_peak(name: str) -> float:
    """The dense bf16 tensor-core peak (FLOP/s) of the card ``name``
    names (NVIDIA's data sheets; the SXM part unless it says PCIe)."""
    if "H100" in name or "H200" in name:
        return 756e12 if "PCIe" in name else 989e12
    raise ValueError(f"no dense bf16 peak on record for {name!r}")


class BertBench:
    """The BertBench training state on the card: bf16 BERT-base with
    flash attention, params from ``seed`` 0, Adam 1e-4, B=64, T=128,
    tokens and targets from ``np.random.RandomState(0)``, an all-ones
    mask; ``step()`` is one eager ``make_train_step`` call."""

    def __init__(self, batch: int = BATCH["bert"], seq: int = BERT_SEQ,
                 device="cuda"):
        self.cfg = tfm.TransformerConfig.bert_base(
            dtype=torch.bfloat16, use_flash_attention=True)
        self.batch, self.seq = batch, seq
        self.params = tfm.init_params(self.cfg, seed=0, device=device)
        updater = Adam(1e-4)
        self.opt = tfm.init_opt_state(self.params, updater)
        self.t = torch.zeros((), dtype=torch.int32, device=device)
        self.train_step = tfm.make_train_step(self.cfg, updater)
        rng = np.random.RandomState(0)
        V = self.cfg.vocab_size
        self.tokens = torch.from_numpy(
            rng.randint(0, V, (batch, seq))).to(device)
        self.targets = torch.from_numpy(
            rng.randint(0, V, (batch, seq))).to(device)
        self.mask = torch.ones((batch, seq), dtype=torch.float32,
                               device=device)
        self.n_params = sum(p.numel() for p in cc.state_tensors(self.params))

    def step_fn(self, tokens, targets, mask):
        return self.train_step(self.params, self.opt, self.t, tokens,
                               targets, mask)

    def step(self):
        return self.step_fn(self.tokens, self.targets, self.mask)

    def state(self):
        return cc.state_tensors(self.params, self.opt, self.t)

    def captured(self, k: int = 1) -> cc.CachedDispatch:
        """The step (K steps on ``[K, B, T]`` buffers for k > 1) as a
        captured dispatch."""
        fn = self.step_fn if k == 1 else stepping.scan_megastep(self.step_fn)
        return cc.CachedDispatch(fn, f"bert.train_step.k{k}",
                                 state=self.state, always_capture=True)

    def stacked(self, k: int):
        return tuple(a.expand(k, *a.shape).contiguous()
                     for a in (self.tokens, self.targets, self.mask))


def build(model: str):
    """(net, DataSet) for ``model`` on the card, in the bench's
    bf16 / NHWC / fused configuration."""
    rng = np.random.default_rng(0)
    batch = BATCH[model]
    if model in CLASSIFIERS:
        net = CLASSIFIERS[model](num_classes=1000).init()
        x = rng.standard_normal((batch, 3, 224, 224), dtype=np.float32)
        y = np.eye(1000, dtype=np.float32)[rng.integers(0, 1000, batch)]
    else:
        cls, classes = DETECTORS[model]
        net = cls(num_classes=classes).init()
        x = rng.standard_normal((batch, 3, 416, 416), dtype=np.float32)
        y = yolo_labels(rng, batch, classes)
    net.setPrecisionPolicy("bf16")
    net.setComputeLayout("NHWC")
    net.setEpilogueFusion(True)
    return net, DataSet(torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda())


def _timed(call, n: int):
    """Host ms of ``n`` calls, each ending in a host read."""
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def _stats(times, steps: int, batch: int, what: str) -> dict:
    med = float(np.median(times)) / steps
    return {"step_ms_median": med,
            "step_ms_min": float(np.min(times)) / steps,
            "step_ms_max": float(np.max(times)) / steps,
            f"{what}_per_s": batch / (med / 1e3)}


def run_network(model: str, k: int) -> dict:
    net, ds = build(model)
    batch = BATCH[model]
    per_image = {"vgg16": vgg16_flops, "yolo2": lambda: conv_flops(net)}
    flops = 3 * batch * per_image[model]() if model in per_image else None

    def mfu(st):
        if flops is None:
            return {}
        peak = dense_bf16_peak(torch.cuda.get_device_name(0))
        return {"mfu": flops / (st["step_ms_median"] / 1e3) / peak}
    for _ in range(WARM):
        net.fit(ds)
    net.score()
    torch.cuda.reset_peak_memory_stats()
    ck.reset_counts()
    times = _timed(lambda: (net.fit(ds), net.score()), ITERS)
    out = {"eager": {"launches_per_step": {
        k_: v // ITERS for k_, v in ck.LAUNCHES.items()},
        **_stats(times, 1, batch, "images"), "loss": net.score(),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9}}
    out["eager"].update(mfu(out["eager"]))
    out["eager"].update(profile(lambda: (net.fit(ds), net.score()), model,
                                False))
    if k > 1:
        cc.reset_stats()
        torch.cuda.reset_peak_memory_stats()
        cc.warmup(net, [(tuple(ds.features.shape), tuple(ds.labels.shape))],
                  steps_per_dispatch=k)
        group = [ds] * k
        ck.reset_counts()
        times = _timed(lambda: (net.fit(group, steps_per_dispatch=k),
                                net.score()), ITERS)
        out["captured"] = {
            "steps_per_dispatch": k,
            "launches_at_capture": net._step_for(False, k)
            .launches_at_capture(),
            "replayed_launches_per_step": {
                k_: v // (ITERS * k) for k_, v in ck.REPLAYS.items()},
            **_stats(times, k, batch, "images"), "loss": net.score(),
            "cache_stats": cc.cache_stats(),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        out["captured"].update(mfu(out["captured"]))
        out["captured"].update(profile(
            lambda: (net.fit(group, steps_per_dispatch=k), net.score()),
            model, True))
    return out


def run_bert(k: int) -> dict:
    bench = BertBench()
    batch, seq = bench.batch, bench.seq
    for _ in range(WARM):
        float(bench.step())
    torch.cuda.reset_peak_memory_stats()
    ck.reset_counts()
    times = _timed(lambda: float(bench.step()), ITERS)
    flops = train_flops_per_token(bench.cfg, seq)
    peak = dense_bf16_peak(torch.cuda.get_device_name(0))

    def rates(st):
        toks = batch * seq / (st["step_ms_median"] / 1e3)
        return {"tokens_per_s": toks, "mfu": flops * toks / peak}
    eager = {"launches_per_step": {k_: v // ITERS
                                   for k_, v in ck.LAUNCHES.items()},
             **_stats(times, 1, batch, "samples"),
             "loss": float(bench.step()),
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    eager.update(rates(eager))
    eager.update(profile(lambda: float(bench.step()), "bert", False))
    out = {"params": bench.n_params, "seq": seq, "flops_per_token": flops,
           "peak_flops": peak, "eager": eager}
    if k >= 1:
        cc.reset_stats()
        torch.cuda.reset_peak_memory_stats()
        disp = bench.captured(k)
        args = (bench.tokens, bench.targets, bench.mask) if k == 1 \
            else bench.stacked(k)
        disp.warm(*args)
        ck.reset_counts()
        times = _timed(lambda: disp(*args).float().sum().item(), ITERS)
        cap = {"steps_per_dispatch": k,
               "launches_at_capture": disp.launches_at_capture(),
               **_stats(times, k, batch, "samples"),
               "cache_stats": cc.cache_stats(),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        cap.update(rates(cap))
        cap.update(profile(lambda: disp(*args).float().sum().item(), "bert",
                           True))
        out["captured"] = cap
    return out


def markov_chars(seed: int, n: int, length: int, vocab: int = TEXT_VOCAB,
                 concentration: float = 20.0):
    """A seeded synthetic corpus: ``n`` sequences of ``length + 1``
    symbols of an order-2 Markov chain over ``vocab`` symbols, as int64
    ``[n, length + 1]``. Each pair's next-symbol distribution is drawn
    from a Dirichlet around Zipf's law (symbol r's weight ``1/(r+1)``,
    ``concentration`` in all), so the symbols' frequencies are skewed as
    a text's characters are and each pair adds structure of its own: a
    model has something to learn at every order. One-hot features are
    ``[:, :-1]``, labels the next symbol ``[:, 1:]``."""
    rng = np.random.default_rng(seed)
    zipf = 1.0 / np.arange(1, vocab + 1)
    alpha = concentration * zipf / zipf.sum()
    cdf = np.cumsum(rng.dirichlet(alpha, (vocab, vocab)), axis=-1)
    out = np.empty((n, length + 1), np.int64)
    out[:, :2] = rng.integers(0, vocab, (n, 2))
    for t in range(2, length + 1):
        u = rng.random(n)[:, None]
        nxt = (cdf[out[:, t - 2], out[:, t - 1]] < u).sum(axis=1)
        out[:, t] = np.minimum(nxt, vocab - 1)
    return out


def noise_jpegs(root: str, n: int = DISK_IMAGES, side: int = DISK_SIDE,
                classes: int = DISK_CLASSES, seed: int = 42) -> list:
    """bench.py's DataPipelineBench data under ``root``: ``n`` images of
    uniform noise, ``side``² RGB, JPEG quality 85, ``n / classes`` in each
    of ``classes`` directories ``class{c}``, from ``RandomState(seed)``.
    Returns the files, sorted."""
    from PIL import Image

    from deeplearning4j_tpu_torch.data.image import _list_images
    rng = np.random.RandomState(seed)
    for c in range(classes):
        d = os.path.join(root, f"class{c}")
        os.makedirs(d, exist_ok=True)
        for i in range(n // classes):
            arr = rng.randint(0, 255, (side, side, 3), dtype=np.uint8)
            Image.fromarray(arr).save(os.path.join(d, f"{i}.jpg"),
                                      quality=85)
    return _list_images(root)


def host_seconds() -> dict:
    """The fit's data-wait and dispatch seconds and the staged pipeline's
    decode, ring-copy and consumer-stall seconds, cumulative."""
    from deeplearning4j_tpu_torch import profiler as prof
    reg = prof.get_registry()

    def child(name, stage, attr):
        m = reg.get(name)
        return 0.0 if m is None else getattr(m.labels(stage=stage), attr)
    out = {}
    for key, name in (("data_wait", "dl4j_train_data_wait_seconds"),
                      ("dispatch", "dl4j_train_step_seconds")):
        h = reg.get(name)
        out[key] = h.sum if h is not None else 0.0
    out["decode"] = child("dl4j_pipeline_stage_seconds", "decode", "sum")
    out["ring_copy"] = child("dl4j_pipeline_stage_seconds", "stage", "sum")
    out["consumer_stall"] = child("dl4j_pipeline_stall_seconds", "consume",
                                  "value")
    return out


def run_from_disk() -> dict:
    """ResNet-50 from JPEGs on disk, one traced epoch (module note)."""
    import tempfile

    from deeplearning4j_tpu_torch.data.decode import codec, decode_one
    from deeplearning4j_tpu_torch.data.pipeline import (
        MultiWorkerImageIterator)
    from deeplearning4j_tpu_torch.profiler.modes import (ProfilingMode,
                                                         set_profiling_mode)
    b, k, hw = BATCH["resnet50_disk"], DISK_K, DISK_HW
    with tempfile.TemporaryDirectory() as root:
        files = noise_jpegs(root)
        t0 = time.perf_counter()
        for f in files[:64]:
            decode_one(f, hw, hw, 3)
        decode_ms = (time.perf_counter() - t0) / 64 * 1e3
        net = zoo.ResNet50(num_classes=DISK_CLASSES,
                           input_shape=(3, hw, hw)).init()
        net.setPrecisionPolicy("bf16")
        net.setComputeLayout("NHWC")
        net.setEpilogueFusion(True)
        cc.warmup(net, [((b, 3, hw, hw), (b, DISK_CLASSES))],
                  steps_per_dispatch=k, dtype=np.uint8)
        it = MultiWorkerImageIterator(root, hw, hw, batch_size=b,
                                      workers=os.cpu_count(),
                                      drop_last=True, steps_per_dispatch=k)
        try:
            def epoch():
                net.fit(it, steps_per_dispatch=k, prefetch=2)
                return net.score()
            epoch()                                 # untraced
            torch.cuda.reset_peak_memory_stats()
            ck.reset_counts()
            before = host_seconds()
            set_profiling_mode(ProfilingMode.BASIC)
            try:
                out = profile(epoch, "resnet50_disk", True)
            finally:
                set_profiling_mode(ProfilingMode.OFF)
            after = host_seconds()
        finally:
            it.close()
    n = DISK_IMAGES // b * b
    out.update({
        "images": n, "steps_per_dispatch": k, "codec": codec(),
        "host_cores": os.cpu_count(), "decode_ms_per_image_one_core":
            decode_ms,
        "images_per_s_traced_epoch": n / (out["traced_ms"] / 1e3),
        "host_seconds": {key: after[key] - before[key] for key in after},
        "replayed_launches": dict(ck.REPLAYS), "loss": net.score(),
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
    return out


def one_hot_ncw(idx, vocab: int = TEXT_VOCAB, device="cuda"):
    """Symbols ``[n, T]`` as one-hot fp32 ``[n, vocab, T]`` on ``device``
    (the one-hot made there: a host copy of the indices only)."""
    t = torch.as_tensor(idx, device=device)
    return torch.nn.functional.one_hot(t, vocab).float().permute(
        0, 2, 1).contiguous()


def run_textgen(k: int) -> dict:
    """One TBPTT window of TextGenerationLSTM, eager and (``k`` >= 1)
    captured, timed and traced (module note)."""
    net = zoo.TextGenerationLSTM().init()
    idx = markov_chars(0, BATCH["textgen"], TEXT_LEN)
    x = one_hot_ncw(idx[:, :-1])
    y = one_hot_ncw(idx[:, 1:])
    w = TEXT_WINDOW
    state = {"window": 0, "carry": None}

    def one():
        """The next window of the batch (the first from zero state)."""
        s = state["window"] % (TEXT_LEN // w) * w
        state["window"] += 1
        carry = net._zero_carry(x) if s == 0 else state["carry"]
        out = net._fit_window(x[:, :, s:s + w], y[:, :, s:s + w], None,
                              carry)
        state["carry"] = out[1:]
        return float(out[0])
    chars = BATCH["textgen"] * w
    for _ in range(WARM):
        one()
    torch.cuda.reset_peak_memory_stats()
    times = _timed(one, ITERS)
    eager = {**_stats(times, 1, chars, "chars"),
             "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    eager.update(profile(one, "textgen", False))
    out = {"params": net.numParams(), "window": w, "seq": TEXT_LEN,
           "eager": eager}
    if k >= 1:
        cc.reset_stats()
        torch.cuda.reset_peak_memory_stats()
        cc.warmup(net, [(tuple(x.shape), tuple(y.shape))], tbptt_length=w)

        def k_windows():
            for _ in range(k):
                one()
        times = _timed(k_windows, ITERS)
        cap = {"windows_traced": k, **_stats(times, k, chars, "chars"),
               "cache_stats": cc.cache_stats(),
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        cap.update(profile(k_windows, "textgen", True))
        cap["device_kernels_per_window"] = cap["device_kernels"] / k
        out["captured"] = cap
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", choices=sorted(BATCH), default="resnet50")
    ap.add_argument("--captured", type=int, default=0, metavar="K",
                    help="also K steps a dispatch, captured (0: eager only)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_fit: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    ck.install_platform_overrides()
    out = {"card": smi, "model": args.model, "batch": BATCH[args.model]}
    if args.model == "bert":
        out.update(run_bert(args.captured))
    elif args.model == "textgen":
        out.update(run_textgen(args.captured))
    elif args.model == "resnet50_disk":
        out.update(run_from_disk())
    else:
        out.update(run_network(args.model, args.captured))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
