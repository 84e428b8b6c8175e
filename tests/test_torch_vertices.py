"""The port's graph vertices against the JAX package (CPU): DotProduct,
Subset, L2Normalize, Scale, Shift, Stack, Unstack and Preprocessor (with
Merge and ElementWise, ported earlier, in the graph below).

Each vertex alone: forward and the vector-Jacobian product of one
cotangent, its output type and its JSON (the port writes the JAX
package's and reads it). Scale and Shift on bf16 round their scalar to
bf16 first, as jnp does with a weakly typed scalar: bit-equal to the JAX
vertex. Then one graph that runs every vertex, built the same way in
both packages with the JAX params transplanted: its output in NCHW and
NHWC, the loss and every gradient, and the layout rule (JAX
nn/graph.py:537-558): Scale and Shift take an NHWC activation as it
flows in, every other vertex is handed NCHW.

Tolerances (tests/test_pallas.py's): fp32 forward 1e-5 (rtol and atol),
gradients 2e-4.
"""

import json

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from deeplearning4j_tpu.nn import graph as jgraph
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn import preprocessors as jpp
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch.nn import graph as tgraph
from deeplearning4j_tpu_torch.nn import layers as tlayers
from deeplearning4j_tpu_torch.nn import preprocessors as tpp
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.train import updaters as tupd

torch.set_num_threads(2)

FWD_TOL = 1e-5
GRAD_TOL = 2e-4

#: (vertex class, constructor args, input shapes, input type of the first)
VERTEX_CASES = [
    ("DotProductVertex", (), [(4, 6), (4, 6)], ("feedForward", (6,))),
    ("DotProductVertex", (True,), [(4, 6), (4, 6)], ("feedForward", (6,))),
    ("SubsetVertex", (1, 3), [(2, 5, 3, 3)], ("convolutional", (3, 3, 5))),
    ("SubsetVertex", (0, 2), [(4, 6)], ("feedForward", (6,))),
    ("L2NormalizeVertex", (), [(3, 4, 2, 2)], ("convolutional", (2, 2, 4))),
    ("L2NormalizeVertex", (1e-3,), [(3, 5)], ("feedForward", (5,))),
    ("ScaleVertex", (0.17,), [(2, 3, 4, 4)], ("convolutional", (4, 4, 3))),
    ("ShiftVertex", (-0.3,), [(4, 6)], ("feedForward", (6,))),
    ("StackVertex", (), [(2, 3, 4, 4), (2, 3, 4, 4)],
     ("convolutional", (4, 4, 3))),
    ("UnstackVertex", (1, 3), [(6, 5)], ("feedForward", (5,))),
]


def _vertex(mod, name, args, pp_mod):
    if name == "PreprocessorVertex":
        return mod.PreprocessorVertex(pp_mod.CnnToFeedForward())
    return getattr(mod, name)(*args)


@pytest.mark.parametrize("name,args,shapes,it", VERTEX_CASES,
                         ids=[f"{c[0]}-{i}" for i, c in
                              enumerate(VERTEX_CASES)])
def test_vertex_matches_jax(name, args, shapes, it):
    jv = _vertex(jgraph, name, args, jpp)
    tv = _vertex(tgraph, name, args, tpp)
    r = np.random.default_rng(len(name) + len(args))
    xs = [r.standard_normal(s).astype(np.float32) for s in shapes]
    if name == "L2NormalizeVertex":
        xs[0][0] *= 1e-5                    # a norm under eps
    want, vjp = jax.vjp(lambda *a: jv.apply(*a), *[jnp.asarray(a)
                                                   for a in xs])
    ct = r.standard_normal(want.shape).astype(np.float32)
    want_g = vjp(jnp.asarray(ct))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in xs]
    got = tv.apply(*ts)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=FWD_TOL, atol=FWD_TOL)
    for g, w in zip(torch.autograd.grad(got, ts, torch.from_numpy(ct)),
                    want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=GRAD_TOL,
                                   atol=GRAD_TOL)
    kind, dims = it
    jt = jv.output_type(*[getattr(JInputType, kind)(*dims)] * len(xs))
    tt = tv.output_type(*[getattr(InputType, kind)(*dims)] * len(xs))
    assert (jt.kind, dict(jt.dims)) == (tt.kind, dict(tt.dims))
    conf = json.loads(json.dumps(jv.to_config()))
    assert json.loads(json.dumps(tv.to_config())) == conf
    back = tgraph._VERTEX_CLASSES[conf["@class"]].from_config(conf)
    assert back.to_config() == tv.to_config()


@pytest.mark.parametrize("name,value", [("ScaleVertex", 0.17),
                                        ("ShiftVertex", -0.3)])
def test_scalar_vertices_round_their_scalar_to_bf16(name, value):
    """0.17 is not a bf16 value: the product with the scalar rounded first
    differs from the product with the fp32 scalar; the JAX vertex rounds
    first."""
    x = np.random.default_rng(0).standard_normal((64, 64)).astype(
        np.float32) * 0.01          # small: the shift's rounding shows
    want = np.asarray(getattr(jgraph, name)(value).apply(
        jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = getattr(tgraph, name)(value).apply(xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    op = torch.mul if name == "ScaleVertex" else torch.add
    unrounded = op(xt.float(), value).to(torch.bfloat16)
    assert not torch.equal(unrounded, got)


def test_preprocessor_vertex_matches_jax_and_its_json():
    jv = jgraph.PreprocessorVertex(jpp.CnnToFeedForward())
    tv = tgraph.PreprocessorVertex(tpp.CnnToFeedForward())
    x = np.random.default_rng(4).standard_normal((2, 3, 4, 5)).astype(
        np.float32)
    np.testing.assert_array_equal(tv.apply(torch.from_numpy(x)).numpy(),
                                  np.asarray(jv.apply(jnp.asarray(x))))
    assert tv.to_config() == jv.to_config()
    assert type(tgraph.PreprocessorVertex.from_config(
        jv.to_config()).preproc) is tpp.CnnToFeedForward
    s2d = tgraph.PreprocessorVertex(tpp.SpaceToDepth(2))
    back = tgraph.PreprocessorVertex.from_config(
        json.loads(json.dumps(s2d.to_config())))
    assert back.preproc.block_size == 2
    it = back.output_type(InputType.convolutional(26, 26, 512))
    assert (it.height, it.width, it.channels) == (13, 13, 2048)


# ------------------------------------------------------- one graph of them
def _vertex_graph(conf, G, Lm, P, it, updater):
    """Every vertex on one path: conv -> Subset -> Scale -> Shift -> conv,
    a second conv off the Subset, Stack and two Unstacks, a
    PreprocessorVertex flatten into dense on each, L2Normalize, a
    DotProduct, a Merge and an ElementWise add into an MSE output."""
    g = (conf.Builder().seed(7).weightInit("xavier").updater(updater)
         .graphBuilder().addInputs("in")
         .setInputTypes(it.convolutional(6, 6, 3)))
    conv = Lm.ConvolutionLayer
    g.addLayer("c1", conv(kernelSize=(3, 3), padding=(1, 1), nOut=8,
                          activation="identity"), "in")
    g.addVertex("sub", G.SubsetVertex(2, 5), "c1")
    g.addVertex("sc", G.ScaleVertex(0.3), "sub")
    g.addVertex("sh", G.ShiftVertex(-0.2), "sc")
    g.addLayer("c2", conv(kernelSize=(1, 1), nOut=4, activation="relu"), "sh")
    g.addLayer("c3", conv(kernelSize=(1, 1), nOut=4, activation="tanh"),
               "sub")
    g.addVertex("st", G.StackVertex(), "c2", "c3")
    g.addVertex("u0", G.UnstackVertex(0, 2), "st")
    g.addVertex("u1", G.UnstackVertex(1, 2), "st")
    g.addVertex("f0", G.PreprocessorVertex(P.CnnToFeedForward()), "u0")
    g.addVertex("f1", G.PreprocessorVertex(P.CnnToFeedForward()), "u1")
    g.addLayer("d0", Lm.DenseLayer(nOut=6, activation="identity"), "f0")
    g.addLayer("d1", Lm.DenseLayer(nOut=6, activation="identity"), "f1")
    g.addVertex("l2", G.L2NormalizeVertex(), "d0")
    g.addVertex("dot", G.DotProductVertex(True), "l2", "d1")
    g.addVertex("add", G.ElementWiseVertex("Add"), "l2", "d1")
    g.addVertex("cat", G.MergeVertex(), "dot", "add")
    g.addLayer("out", Lm.OutputLayer(nOut=3, lossFunction="mse",
                                     activation="identity"), "cat")
    g.setOutputs("out")
    return G.ComputationGraph(g.build())


def _pair(layout):
    j = _vertex_graph(JConf, jgraph, jlayers, jpp, JInputType,
                      jupd.Adam(1e-3)).init()
    t = _vertex_graph(NeuralNetConfiguration, tgraph, tlayers, tpp,
                      InputType, tupd.Adam(1e-3))
    t.params_from_jax(jax.tree_util.tree_map(np.asarray, j._params),
                      jax.tree_util.tree_map(np.asarray, j._states),
                      device="cpu")
    for net in (j, t):
        net.setComputeLayout(layout)
    return j, t


def _data(seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((4, 3, 6, 6)).astype(np.float32),
            r.standard_normal((4, 3)).astype(np.float32))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_vertex_graph_output_matches_jax(layout):
    j, t = _pair(layout)
    x, _ = _data(1)
    got = t.output(x)
    assert got.shape == (4, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(j.output(x)),
                               rtol=FWD_TOL, atol=FWD_TOL)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_vertex_graph_loss_and_gradients_match_jax(layout):
    j, t = _pair(layout)
    x, y = _data(2)
    key = jax.random.PRNGKey(0)

    def jloss(p):
        return j._loss_and_reg(p, j._states, {"in": jnp.asarray(x)},
                               [jnp.asarray(y)], True, key, None, None)[0]
    want, want_g = jax.value_and_grad(jloss)(j._params)
    loss, _ = t._loss_and_reg(t._params, t._states,
                              {"in": torch.from_numpy(x)},
                              [torch.from_numpy(y)], True, None)
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=FWD_TOL, atol=FWD_TOL)
    names = [(n, k) for n in sorted(t._params) for k in t._params[n]]
    grads = torch.autograd.grad(loss, [t._params[n][k] for n, k in names])
    for (n, k), g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g[n][k]),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=f"{n}.{k}")


def test_scale_and_shift_keep_nhwc_every_other_vertex_gets_nchw(
        monkeypatch):
    """Under NHWC: in the vertex graph the Subset after a conv is handed
    NCHW [4, 8, 6, 6] (it slices channels), and Scale then sees the
    Subset's NCHW output; Stack is handed NCHW from two NHWC convs. In a
    graph where a conv feeds Scale directly, Scale and Shift keep its
    NHWC [2, 5, 5, 3] and the Merge after them is handed NCHW; the
    output equals the NCHW run's."""
    seen = {}
    for cls in (tgraph.SubsetVertex, tgraph.ScaleVertex, tgraph.ShiftVertex,
                tgraph.StackVertex, tgraph.MergeVertex):
        orig = cls.apply

        def spy(self, *xs, _orig=orig, _name=cls.__name__):
            seen.setdefault(_name, []).append(tuple(xs[0].shape))
            return _orig(self, *xs)
        monkeypatch.setattr(cls, "apply", spy)
    _, t = _pair("NHWC")
    x, _ = _data(3)
    t.output(x)
    assert seen["SubsetVertex"] == [(4, 8, 6, 6)]
    assert seen["ScaleVertex"] == [(4, 4, 6, 6)]
    assert seen["StackVertex"] == [(4, 4, 6, 6)]
    # a conv straight into Scale, and an Add of two NHWC convs: kept NHWC
    seen.clear()
    g = (NeuralNetConfiguration.Builder().seed(1).graphBuilder()
         .addInputs("in").setInputTypes(InputType.convolutional(5, 5, 2)))
    g.addLayer("a", tlayers.ConvolutionLayer(kernelSize=(1, 1), nOut=3,
                                             activation="identity"), "in")
    g.addVertex("sc", tgraph.ScaleVertex(2.0), "a")
    g.addVertex("sh", tgraph.ShiftVertex(1.0), "sc")
    g.addVertex("cat", tgraph.MergeVertex(), "sh", "a")
    g.addLayer("gap", tlayers.GlobalPoolingLayer("avg"), "cat")
    g.addLayer("out", tlayers.OutputLayer(nOut=2), "gap")
    g.setOutputs("out")
    net = tgraph.ComputationGraph(g.build()).init(device="cpu")
    want = net.output(np.ones((2, 2, 5, 5), np.float32))
    net.setComputeLayout("NHWC")
    got = net.output(np.ones((2, 2, 5, 5), np.float32))
    assert seen["ScaleVertex"][-1] == (2, 5, 5, 3)      # NHWC kept
    assert seen["ShiftVertex"][-1] == (2, 5, 5, 3)
    assert seen["MergeVertex"][-1] == (2, 3, 5, 5)      # handed NCHW
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_the_graph_json_crosses_both_ways():
    """The JAX graph's JSON (every vertex) read by the port builds the
    same topology and types; the port's JSON is the JAX one's."""
    j, t = _pair("NCHW")
    back = tgraph.ComputationGraphConfiguration.from_json(j.conf.to_json())
    assert [(n.name, n.kind, type(n.obj).__name__, n.inputs)
            for n in back.topo] == \
        [(n.name, n.kind, type(n.obj).__name__, n.inputs) for n in t.conf.topo]
    assert {k: dict(v.dims) for k, v in back.types.items()} == \
        {k: dict(v.dims) for k, v in j.conf.types.items()}
    assert json.loads(t.conf.to_json())["nodes"] == \
        json.loads(j.conf.to_json())["nodes"]
