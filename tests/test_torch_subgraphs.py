"""The port's SameDiff control flow (``while_loop``, ``cond``,
``invoke_subgraph``) and subgraph specs against the JAX package's (CPU).

Python-callable bodies run as eager Python control flow; SameDiff
subgraph bodies serialize to the JAX package's self-contained spec, so a
graph either package saves loads in the other with the same results
(fp32, 1e-6).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu.autodiff.samediff import SameDiff as JSameDiff
from deeplearning4j_tpu_torch.autodiff import SameDiff
from deeplearning4j_tpu_torch.autodiff import samediff as tsd


def _new(pkg):
    return SameDiff.create(device="cpu") if pkg is SameDiff \
        else JSameDiff.create()


def test_while_loop_with_callables():
    sd = _new(SameDiff)
    i0 = sd.constant(np.float32(0.0), name="i0")
    acc0 = sd.constant(np.float32(1.0), name="acc0")
    _, acc = sd.while_loop(lambda i, a: i < 5, lambda i, a: (i + 1, a * 2),
                           [i0, acc0])
    assert float(acc.eval()) == 32.0
    one = sd.while_loop(lambda i: i < 5, lambda i: (i + 1,),
                        [sd.constant(np.float32(0.0), name="j0")])
    assert float(one.eval()) == 5.0


def test_cond_with_callables():
    sd = _new(SameDiff)
    p = sd.constant(np.bool_(True), name="p")
    a = sd.constant(np.float32(2.0), name="a")
    assert float(sd.cond(p, lambda v: v * 10, lambda v: v - 1,
                         [a]).eval()) == 20.0


def _loop_graphs(pkg):
    cond = _new(pkg)
    ci = cond.placeHolder("i", shape=(), dtype=np.int32)
    cond.placeHolder("a", shape=(2, 3), dtype=np.float32)
    ci.lt(5.0)                      # recorded: the last output is the pred
    body = _new(pkg)
    bi = body.placeHolder("i", shape=(), dtype=np.int32)
    ba = body.placeHolder("a", shape=(2, 3), dtype=np.float32)
    body.setOutputs(bi.add(1), ba.mul(1.5))
    return cond, body


def _cond_graphs(pkg):
    tg, fg = _new(pkg), _new(pkg)
    tg.setOutputs(tg.placeHolder("a", shape=(3,), dtype=np.float32).mul(2.0))
    fg.setOutputs(fg.placeHolder("a", shape=(3,), dtype=np.float32).sub(1.0))
    return tg, fg


def _build(pkg, kind):
    sd = _new(pkg)
    if kind == "while":
        x = sd.placeHolder("x", shape=(2, 3), dtype=np.float32)
        i0 = sd.constant(np.int32(0), name="i0")
        out = sd.while_loop(*_loop_graphs(pkg), [i0, x], name="loop")[1]
        return sd, out.name, [{"x": np.ones((2, 3), np.float32)}]
    x = sd.placeHolder("x", shape=(3,), dtype=np.float32)
    pred = sd.placeHolder("p", shape=(), dtype=np.bool_)
    out = sd.cond(pred, *_cond_graphs(pkg), [x], name="branch")
    xs = np.asarray([1., 2., 3.], np.float32)
    return sd, out.name, [{"x": xs, "p": np.bool_(True)},
                          {"x": xs, "p": np.bool_(False)}]


@pytest.mark.parametrize("kind", ["while", "cond"])
def test_subgraph_bodies_match_jax_and_cross_save_load(kind, tmp_path):
    sd, name, feeds = _build(SameDiff, kind)
    jsd, jname, _ = _build(JSameDiff, kind)
    assert name == jname
    want = [np.asarray(jsd.output(f, [name])[name]) for f in feeds]
    got = [sd.output(f, [name])[name].numpy() for f in feeds]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6)
    if kind == "while":
        np.testing.assert_allclose(got[0], np.full((2, 3), 1.5 ** 5),
                                   rtol=1e-6)
    p, pj = str(tmp_path / "port.sdz"), str(tmp_path / "jax.sdz")
    sd.save(p)
    jsd.save(pj)
    for f, w in zip(feeds, want):
        np.testing.assert_allclose(
            SameDiff.load(p, device="cpu").output(f, [name])[name].numpy(),
            w, rtol=1e-6)
        np.testing.assert_allclose(
            SameDiff.load(pj, device="cpu").output(f, [name])[name].numpy(),
            w, rtol=1e-6)
        np.testing.assert_allclose(np.asarray(JSameDiff.load(p).output(
            f, [name])[name]), w, rtol=1e-6)


def test_invoke_subgraph_is_differentiable():
    sub = _new(SameDiff)
    a = sub.placeHolder("a", shape=(2, 2), dtype=np.float32)
    sub.setOutputs(a.mul(a))
    sd = _new(SameDiff)
    w = sd.var("w", np.ones((2, 2), np.float32) * 3.0)
    y = sd.invoke_subgraph(sub, [w], name="sq")
    sd.setLossVariables(y.name)
    g = sd.calculateGradients({}, ["w"])["w"]
    np.testing.assert_allclose(g.numpy(), np.full((2, 2), 6.0))
    jsub = JSameDiff.create()
    ja = jsub.placeHolder("a", shape=(2, 2), dtype=np.float32)
    jsub.setOutputs(ja.mul(ja))
    jsd = JSameDiff.create()
    jw = jsd.var("w", jnp.ones((2, 2), jnp.float32) * 3.0)
    assert jsd.invoke_subgraph(jsub, [jw], name="sq").name == y.name


def test_raw_callable_bodies_refuse_save(tmp_path):
    sd = _new(SameDiff)
    x = sd.placeHolder("x", shape=(2,), dtype=np.float32)
    sd.while_loop(lambda i, a: i < 3, lambda i, a: (i + 1, a * 2.0),
                  [sd.constant(np.int32(0)), x], name="rawloop")
    with pytest.raises(ValueError, match="SameDiff subgraphs"):
        sd.save(str(tmp_path / "raw.sdz"))


def test_subgraph_spec_is_the_jax_format():
    cond, body = _loop_graphs(SameDiff)
    jcond, jbody = _loop_graphs(JSameDiff)
    from deeplearning4j_tpu.autodiff import samediff as jsd_mod
    for mine, theirs in ((cond, jcond), (body, jbody)):
        a = tsd.subgraph_spec(mine, mine._default_outputs(1 if mine is cond
                                                          else 2))
        b = jsd_mod.subgraph_spec(theirs, theirs._default_outputs(
            1 if theirs is jcond else 2))
        assert a["ph_order"] == b["ph_order"]
        assert a["placeholders"] == b["placeholders"]
        assert a["outputs"] == b["outputs"]
        assert [n["op"] for n in a["nodes"]] == [n["op"] for n in b["nodes"]]


def test_subgraph_runs_on_the_device_of_its_arguments():
    spec = tsd.subgraph_spec(*[(s, s._default_outputs(1))
                               for s in [_cond_graphs(SameDiff)[0]]][0])
    call = tsd.subgraph_fn(spec)
    (out,) = call(torch.ones(3))
    assert out.device.type == "cpu" and torch.equal(out, torch.full((3,), 2.))


def test_rename_moves_every_reference():
    sd = _new(SameDiff)
    x = sd.placeHolder("x", shape=(2,), dtype=np.float32)
    y = x.mul(2.0)
    z = y.add(1.0)
    sd.setLossVariables(z.name)
    sd._rename(y.name, "doubled")
    sd._rename(z.name, "out")
    assert sd._loss_variables == ["out"]
    got = sd.output({"x": np.ones(2, np.float32)}, ["doubled", "out"])
    assert torch.equal(got["out"], torch.full((2,), 3.0))
    assert sd.getVariable("doubled").name == "doubled"
