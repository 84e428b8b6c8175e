"""Fixture writer: ResNet-50 v1 as an ONNX graph, from the weights of the
port's own ``zoo.ResNet50`` network, written with :mod:`.onnx_proto`'s
encoder.

No ONNX file ships with the repository and none is downloaded, so the
tests and ``chip_smoke.py`` write one here from a seeded network; the
same weights then run through both paths (the ``ComputationGraph`` and
the ONNX import into SameDiff). It is a writer of this one topology, not
an exporter API (the JAX package has none).

The graph uses the ONNX model zoo's ``resnet50-v1`` node kinds: ``Conv``
(with its bias), ``BatchNormalization`` (inference form), ``Relu``,
``MaxPool``, ``Add``, ``ReduceMean`` over H and W (for the zoo's
``GlobalAveragePool``, which the JAX importer has no builder for),
``Flatten`` and ``Gemm``. One float32 input ``input`` ``[N, 3, H, W]``
(a dynamic batch), one output ``logits`` ``[N, classes]`` (the
``ComputationGraph``'s ``fc`` before its softmax). Nothing on the port's
main path imports this module.
"""

from __future__ import annotations

import re
from typing import Dict, List

import numpy as np
import torch

from deeplearning4j_tpu_torch.modelimport import onnx_proto as P
from deeplearning4j_tpu_torch.models import zoo

_BLOCK = re.compile(r"s(\d+)b(\d+)_c1$")


class SmallResNet50(zoo.ResNet50):
    """ResNet-50's topology at 2 blocks a stage and narrow widths (8-64
    channels), for the tests' small copies."""

    STAGES = ((2, 8, 16, 1), (2, 8, 32, 2), (2, 16, 32, 2), (2, 16, 64, 2))


def randomize_batch_norm(net, seed: int = 0) -> None:
    """Give every BatchNormalization of ``net`` seeded statistics and
    affine params, as a trained network has (gamma 1 + N(0, 0.1), beta,
    mean N(0, 0.1), var 1 + U(0, 0.5)), in place."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name in sorted(net._states):
            st = net._states[name]
            if "mean" not in st:
                continue
            c = st["mean"].numel()
            p = net._params[name]
            for t, v in ((p["gamma"], 1 + 0.1 * rng.standard_normal(c)),
                         (p["beta"], 0.1 * rng.standard_normal(c)),
                         (st["mean"], 0.1 * rng.standard_normal(c)),
                         (st["var"], 1 + 0.5 * rng.random(c))):
                t.copy_(torch.from_numpy(v.astype(np.float32)))


def _np(t) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def resnet50_onnx(net) -> bytes:
    """The ONNX ModelProto bytes of a ``zoo.ResNet50`` network (fp32, any
    ``STAGES``): every conv, BN, pool and the classifier with ``net``'s
    weights and BN statistics."""
    layers = {n.name: n.obj for n in net.conf.topo if n.kind == "layer"}
    params, states = net._params, net._states
    nodes: List[bytes] = []
    inits: Dict[str, np.ndarray] = {}

    def conv(name, x):
        layer, p = layers[name], params[name]
        ins = [x, f"{name}_W"]
        inits[f"{name}_W"] = _np(p["W"])
        if "b" in p:
            ins.append(f"{name}_b")
            inits[f"{name}_b"] = _np(p["b"])
        ph, pw = layer.padding
        nodes.append(P.encode_node(
            "Conv", ins, [name], name=name,
            kernel_shape=list(p["W"].shape[2:]), strides=list(layer.stride),
            pads=[ph, pw, ph, pw]))
        return name

    def bn(name, x):
        ins = [x]
        for k, src in (("gamma", params), ("beta", params),
                       ("mean", states), ("var", states)):
            inits[f"{name}_{k}"] = _np(src[name][k])
            ins.append(f"{name}_{k}")
        nodes.append(P.encode_node("BatchNormalization", ins, [name],
                                   name=name,
                                   epsilon=float(layers[name].eps)))
        return name

    def relu(name, x):
        nodes.append(P.encode_node("Relu", [x], [name], name=name))
        return name

    x = relu("stem_relu", bn("stem_bn", conv("stem_conv", "input")))
    pool = layers["stem_pool"]
    ph, pw = pool.padding
    nodes.append(P.encode_node(
        "MaxPool", [x], ["stem_pool"], name="stem_pool",
        kernel_shape=list(pool.kernel), strides=list(pool.stride),
        pads=[ph, pw, ph, pw]))
    last = "stem_pool"
    blocks = sorted((int(m.group(1)), int(m.group(2)))
                    for m in map(_BLOCK.match, layers) if m)
    for si, bi in blocks:
        pref = f"s{si}b{bi}"
        h = relu(f"{pref}_r1", bn(f"{pref}_bn1", conv(f"{pref}_c1", last)))
        h = relu(f"{pref}_r2", bn(f"{pref}_bn2", conv(f"{pref}_c2", h)))
        h = bn(f"{pref}_bn3", conv(f"{pref}_c3", h))
        sc = bn(f"{pref}_scbn", conv(f"{pref}_sc", last)) \
            if f"{pref}_sc" in layers else last
        nodes.append(P.encode_node("Add", [h, sc], [f"{pref}_add"],
                                   name=f"{pref}_add"))
        last = relu(f"{pref}_out", f"{pref}_add")
    nodes.append(P.encode_node("ReduceMean", [last], ["avgpool"],
                               name="avgpool", axes=[2, 3], keepdims=1))
    nodes.append(P.encode_node("Flatten", ["avgpool"], ["flatten"],
                               name="flatten", axis=1))
    inits["fc_W"], inits["fc_b"] = _np(params["fc"]["W"]), \
        _np(params["fc"]["b"])
    nodes.append(P.encode_node("Gemm", ["flatten", "fc_W", "fc_b"],
                               ["logits"], name="fc"))
    it = net.conf.input_types["input"]
    c, h, w = it.channels, it.height, it.width
    n_cls = int(params["fc"]["W"].shape[1])
    return P.encode_model(
        nodes=nodes,
        inputs=[P.encode_value_info("input", np.float32, [None, c, h, w])],
        outputs=[P.encode_value_info("logits", np.float32, [None, n_cls])],
        initializers=[P.encode_tensor(k, v) for k, v in inits.items()],
        graph_name="resnet50_v1")


def write_resnet50(net, path: str) -> str:
    """Write :func:`resnet50_onnx` of ``net`` to ``path``; returns it."""
    with open(path, "wb") as f:
        f.write(resnet50_onnx(net))
    return path


def resnet50_logits(net, x) -> torch.Tensor:
    """The ``ComputationGraph``'s logits on ``x``: its ``avgpool``
    activation through the ``fc`` layer's weights, before the softmax
    ``output()`` applies."""
    pooled = net.feedForward(x)["avgpool"]
    p = net._params["fc"]
    with torch.no_grad():
        return pooled @ p["W"] + p["b"]
