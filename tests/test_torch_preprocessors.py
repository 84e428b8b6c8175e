"""The port's input preprocessors and their insertion against the JAX
package (CPU).

Each preprocessor maps the same numpy input to the same array (a reshape
or a permute: exact). The automatic choice, the inserted preprocessors
and the propagated input types of a configuration equal the JAX ones,
also after a JSON round trip either way. Forwards that run through a
preprocessor: fp32 within 1e-5 (as the reference's forward tolerance);
the NHWC compute layout flattens in the same ``[c, h, w]`` order as NCHW
(bit-equal in fp32 on the CPU: the same products in the same order)."""

import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn import preprocessors as jpp
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import MultiLayerConfiguration as JMLC
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.graph import ComputationGraph as JCG
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu_torch.nn import layers as tlayers
from deeplearning4j_tpu_torch.nn import preprocessors as tpp
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

torch.set_num_threads(2)

FWD_TOL = 1e-5


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("name,args,shape", [
    ("FeedForwardToCnn", (3, 4, 2), (5, 24)),
    ("CnnToFeedForward", (), (5, 2, 3, 4)),
    ("CnnToFeedForward", (), (5, 2, 3, 4, 2)),
    ("RnnToFeedForward", (), (5, 6, 7)),
    ("FeedForwardToRnn", (7,), (35, 6)),
    ("CnnToRnn", (), (5, 2, 3, 4)),
])
def test_each_preprocessor_matches_jax(name, args, shape):
    x = _x(shape)
    want = np.asarray(getattr(jpp, name)(*args)(jnp.asarray(x)))
    got = getattr(tpp, name)(*args)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


_TYPES = [("feedForward", (12,)), ("convolutional", (4, 5, 3)),
          ("convolutionalFlat", (4, 5, 3)), ("recurrent", (6, 7)),
          ("convolutional3D", (2, 4, 5, 3))]


@pytest.mark.parametrize("kind,dims", _TYPES)
@pytest.mark.parametrize("layer", ["DenseLayer", "ConvolutionLayer",
                                   "BatchNormalization"])
def test_automatic_choice_matches_jax(kind, dims, layer):
    jt, tt = getattr(JInputType, kind)(*dims), getattr(InputType, kind)(*dims)
    assert jt.to_config() == tt.to_config()
    assert tt.arrayElementsPerExample() == jt.arrayElementsPerExample()
    jl, tl = getattr(jlayers, layer)(nOut=2), getattr(tlayers, layer)(nOut=2)
    try:
        want = jpp.preprocessor_for(jt, jl)
    except ValueError as e:
        with pytest.raises(ValueError, match="convolutionalFlat"):
            tpp.preprocessor_for(tt, tl)
        assert "convolutionalFlat" in str(e)
        return
    got = tpp.preprocessor_for(tt, tl)
    assert type(got).__name__ == type(want).__name__
    if want is not None:
        assert got.output_type(tt).to_config() == \
            want.output_type(jt).to_config()
        assert vars(got) == vars(want)


def _lenet_like(conf, Lm, it):
    return (conf.Builder().seed(5).list()
            .layer(Lm.ConvolutionLayer(kernelSize=(3, 3), nOut=3,
                                       activation="relu"))
            .layer(Lm.SubsamplingLayer(kernelSize=(2, 2), stride=(2, 2)))
            .layer(Lm.DenseLayer(nOut=7, activation="tanh"))
            .layer(Lm.OutputLayer(nOut=4, lossFunction="mcxent"))
            .setInputType(it.convolutionalFlat(10, 8, 2)).build())


def _pair():
    jconf = _lenet_like(JConf, jlayers, JInputType)
    j = JMLN(jconf).init()
    t = MultiLayerNetwork(_lenet_like(NeuralNetConfiguration, tlayers,
                                      InputType))
    t.params_from_jax(j._params, j._states, device="cpu")
    return j, t


def test_configuration_inserts_what_jax_inserts():
    jconf = _lenet_like(JConf, jlayers, JInputType)
    tconf = _lenet_like(NeuralNetConfiguration, tlayers, InputType)
    assert sorted(tconf.preprocessors) == sorted(jconf.preprocessors) == [0, 2]
    for i, pre in tconf.preprocessors.items():
        assert type(pre).__name__ == type(jconf.preprocessors[i]).__name__
        assert vars(pre) == vars(jconf.preprocessors[i])
    assert [t.to_config() for t in tconf.layer_input_types] == \
        [t.to_config() for t in jconf.layer_input_types]
    assert [layer.nIn for layer in tconf.layers] == \
        [layer.nIn for layer in jconf.layers] == [2, 3, 3 * 4 * 3, 7]


def test_preprocessors_come_back_from_json_both_ways():
    jconf = _lenet_like(JConf, jlayers, JInputType)
    tconf = MultiLayerConfiguration.from_json(jconf.to_json())
    assert {i: type(p).__name__ for i, p in tconf.preprocessors.items()} == \
        {0: "FeedForwardToCnn", 2: "CnnToFeedForward"}
    assert "preprocessor" not in tconf.to_json()
    back = JMLC.from_json(tconf.to_json())
    assert json.loads(back.to_json()) == json.loads(jconf.to_json())
    assert sorted(back.preprocessors) == [0, 2]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_forward_through_preprocessors_matches_jax(layout):
    j, t = _pair()
    for net in (j, t):
        net.setComputeLayout(layout)
    x = _x((6, 2 * 10 * 8), 1)
    np.testing.assert_allclose(t.output(x).numpy(), np.asarray(j.output(x)),
                               rtol=FWD_TOL, atol=FWD_TOL)
    acts_t = t.feedForward(x)
    acts_j = j.feedForward(x)
    assert len(acts_t) == len(acts_j)
    for a, b in zip(acts_t, acts_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=FWD_TOL,
                                   atol=FWD_TOL)


def test_nhwc_flattens_in_nchw_order():
    """The flatten under NHWC reads [c, h, w] row-major, so the dense W
    of an archive or a transplant is not permuted."""
    _, t = _pair()
    x = _x((3, 2 * 10 * 8), 2)
    want = t.output(x)
    t.setComputeLayout("NHWC")
    assert torch.equal(t.output(x), want)


def test_ff_input_into_a_conv_raises_as_jax():
    for conf, Lm, it in ((JConf, jlayers, JInputType),
                         (NeuralNetConfiguration, tlayers, InputType)):
        with pytest.raises(ValueError, match="convolutionalFlat"):
            (conf.Builder().list()
             .layer(Lm.ConvolutionLayer(nOut=2))
             .setInputType(it.feedForward(16)).build())


def _graph(conf, Lm, it):
    return (conf.Builder().seed(2).graphBuilder().addInputs("in")
            .setInputTypes(it.convolutional(6, 6, 2))
            .addLayer("c", Lm.ConvolutionLayer(kernelSize=(3, 3), nOut=3,
                                               activation="relu"), "in")
            .addLayer("d", Lm.DenseLayer(nOut=5, activation="tanh"), "c")
            .addLayer("out", Lm.OutputLayer(nOut=3, lossFunction="mcxent"),
                      "d")
            .setOutputs("out").build())


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_graph_inserts_and_applies_preprocessors_as_jax(layout):
    jconf = _graph(JConf, jlayers, JInputType)
    tconf = _graph(NeuralNetConfiguration, tlayers, InputType)
    assert {k: type(v).__name__ for k, v in tconf.preprocessors.items()} \
        == {k: type(v).__name__ for k, v in jconf.preprocessors.items()} \
        == {"d": "CnnToFeedForward"}
    j = JCG(jconf).init()
    t = ComputationGraph(tconf)
    t.params_from_jax(j._params, j._states, device="cpu")
    for net in (j, t):
        net.setComputeLayout(layout)
    x = _x((4, 2, 6, 6), 3)
    np.testing.assert_allclose(t.output(x).numpy(), np.asarray(j.output(x)),
                               rtol=FWD_TOL, atol=FWD_TOL)
