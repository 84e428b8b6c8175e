"""The port's static analyzer (``deeplearning4j_tpu_torch/analysis``) held
against the JAX package's.

Every seeded misconfiguration of ``tests/test_analysis.py`` (the seeded,
distribution, SameDiff, input-pipeline, numerics, graph-vertex and
graph-IR cases) is built by the same builder calls in both packages and
analyzed by both: the ``(code, severity, location)`` findings must be
equal, and so must the numbers in each message. The cases a Hopper rule
replaces (W101's tile, W102's float16, W106's K step, the peaks and the
default HBM budget) are pinned one by one below, each beside the JAX
verdict it replaces. Also here: the port's zoo lints clean, every layer
class's ``param_shapes()`` equals the shapes ``initialize`` makes, and
``init(strict=True)`` raises before any parameter exists.

Exact comparison: both packages run the same Python arithmetic on the
same declared shapes.
"""

import re
import types

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.analysis as ja
import deeplearning4j_tpu_torch.analysis as ta
from deeplearning4j_tpu.analysis import distribution as j_dist
from deeplearning4j_tpu.analysis import graphir as j_gir
from deeplearning4j_tpu.autodiff import samediff as j_sd
from deeplearning4j_tpu.models import zoo as j_zoo
from deeplearning4j_tpu.nn import config as j_config
from deeplearning4j_tpu.nn import graph as j_graph
from deeplearning4j_tpu.nn import layers as j_layers
from deeplearning4j_tpu.nn import multilayer as j_mln
from deeplearning4j_tpu.nn import precision as j_prec
from deeplearning4j_tpu.train import updaters as j_upd
from deeplearning4j_tpu_torch.analysis import distribution as t_dist
from deeplearning4j_tpu_torch.analysis import graphir as t_gir
from deeplearning4j_tpu_torch.analysis import layout as t_layout
from deeplearning4j_tpu_torch.autodiff import samediff as t_sd
from deeplearning4j_tpu_torch.models import zoo as t_zoo
from deeplearning4j_tpu_torch.nn import config as t_config
from deeplearning4j_tpu_torch.nn import graph as t_graph
from deeplearning4j_tpu_torch.nn import layers as t_layers
from deeplearning4j_tpu_torch.nn import multilayer as t_mln
from deeplearning4j_tpu_torch.nn import precision as t_prec
from deeplearning4j_tpu_torch.train import updaters as t_upd


def _pkg(an, config, layers, mln, graph, upd, prec, sd, dist, gir, zoo,
         sd_kw):
    return types.SimpleNamespace(
        an=an, L=layers, InputType=config.InputType,
        NNC=config.NeuralNetConfiguration, MLN=mln.MultiLayerNetwork,
        CG=graph.ComputationGraph, MergeVertex=graph.MergeVertex,
        ElementWiseVertex=graph.ElementWiseVertex, Adam=upd.Adam,
        Sgd=upd.Sgd, Policy=prec.PrecisionPolicy, dist=dist, gir=gir,
        zoo=zoo, TrainingConfig=sd.TrainingConfig,
        sd=lambda: sd.SameDiff.create(**sd_kw))


JAX = _pkg(ja, j_config, j_layers, j_mln, j_graph, j_upd, j_prec, j_sd,
           j_dist, j_gir, j_zoo, {})
TORCH = _pkg(ta, t_config, t_layers, t_mln, t_graph, t_upd, t_prec, t_sd,
             t_dist, t_gir, t_zoo, {"device": "cpu"})

_PR_TAG = re.compile(r"PR[- ]\d+")
_NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def _facts(report):
    """(code, severity, location, numbers in the message) per finding,
    sorted. Some JAX package messages name the pull request that found
    a bug; that history is not a number of the finding."""
    return sorted((d.code, d.severity.name, d.location,
                   tuple(_NUMBER.findall(_PR_TAG.sub("", d.message))))
                  for d in report)


# ---------------------------------------------------------------- builders
def _builder(P, updater=None):
    return (P.NNC.Builder().seed(7).updater(updater or P.Sgd(0.1))
            .weightInit("xavier"))


def _mlp_conf(P, n_in=4, hidden=8, n_out=2, updater=None):
    return (_builder(P, updater).list()
            .layer(P.L.DenseLayer(nOut=hidden, activation="relu"))
            .layer(P.L.OutputLayer(nOut=n_out, lossFunction="mcxent",
                                   activation="softmax"))
            .setInputType(P.InputType.feedForward(n_in))
            .build())


def _graph_builder(P):
    return (_builder(P).graphBuilder().addInputs("in")
            .setInputTypes(P.InputType.feedForward(4)))


def _wide_mlp(P, n_in=4096, hidden=4096, n_out=2):
    return (_builder(P).list()
            .layer(P.L.DenseLayer(nOut=hidden, activation="relu"))
            .layer(P.L.OutputLayer(nOut=n_out))
            .setInputType(P.InputType.feedForward(n_in))
            .build())


def _dense_stack(P, widths, n_in, out=None, updater=None):
    lb = _builder(P, updater).list()
    for w in widths:
        lb = lb.layer(P.L.DenseLayer(nOut=w, activation="relu"))
    if out is not None:
        lb = lb.layer(P.L.OutputLayer(nOut=out))
    return lb.setInputType(P.InputType.feedForward(n_in)).build()


def _conv_conf(P):
    return (P.NNC.Builder().list()
            .layer(P.L.ConvolutionLayer(nOut=64, kernelSize=(3, 3)))
            .layer(P.L.ConvolutionLayer(nOut=128, kernelSize=(3, 3)))
            .layer(P.L.DenseLayer(nOut=64, activation="relu"))
            .layer(P.L.OutputLayer(nOut=8))
            .setInputType(P.InputType.convolutional(64, 64, 3))
            .build())


def _num_mlp(P, updater=None, **layer_kw):
    return (_builder(P, updater).list()
            .layer(P.L.DenseLayer(nOut=16, activation="relu", **layer_kw))
            .layer(P.L.OutputLayer(nOut=3, lossFunction="mcxent",
                                   activation="softmax"))
            .setInputType(P.InputType.feedForward(8))
            .build())


def _sd_mlp(P):
    sd = P.sd()
    x = sd.placeHolder("x", shape=(None, 3))
    labels = sd.placeHolder("labels", shape=(None, 2))
    rng = np.random.RandomState(0)
    w = sd.var("w", rng.randn(3, 2))
    b = sd.var("b", np.zeros(2))
    z = sd.nn.linear(x, w, b, name="z")
    sd.loss.softmaxCrossEntropy(labels, z, name="loss")
    sd.setLossVariables("loss")
    return sd


def _sd_linear(P):
    sd = P.sd()
    x = sd.placeHolder("x", shape=(None, 4))
    w = sd.var("w", np.zeros((4, 2), np.float32))
    x.mmul(w)
    return sd


# ------------------------------------------------------------------- cases
#: name -> (build(P) -> ValidationReport, codes the JAX report must hold,
#: codes it must not hold)
CASES = {}


def case(want=(), absent=()):
    def register(fn):
        CASES[fn.__name__] = (fn, set(want), set(absent))
        return fn
    return register


# TestSeededDiagnostics
@case(want={"DL4J-E001"})
def e001_nin_mismatch(P):
    return (_builder(P).list()
            .layer(P.L.DenseLayer(nIn=300, nOut=16))
            .layer(P.L.OutputLayer(nOut=4))
            .setInputType(P.InputType.feedForward(128))
            .build()).validate()


@case(want={"DL4J-E001"})
def e001_unresolvable_nin(P):
    return (_builder(P).list()
            .layer(P.L.DenseLayer(nOut=16))
            .layer(P.L.OutputLayer(nOut=4, nIn=16))
            .build()).validate()


@case(want={"DL4J-E002"})
def e002_cycle(P):
    return (_graph_builder(P)
            .addLayer("a", P.L.DenseLayer(nIn=4, nOut=4), "b")
            .addLayer("b", P.L.DenseLayer(nIn=4, nOut=4), "a")
            .addLayer("out", P.L.OutputLayer(nIn=4, nOut=2), "b")
            .setOutputs("out")).validate()


@case(want={"DL4J-E003"})
def e003_undefined_input(P):
    return (_graph_builder(P)
            .addLayer("out", P.L.OutputLayer(nIn=4, nOut=2), "nonexistent")
            .setOutputs("out")).validate()


@case(want={"DL4J-E003"})
def e003_dangling_vertex(P):
    return P.an.analyze(
        _graph_builder(P)
        .addLayer("used", P.L.DenseLayer(nOut=4), "in")
        .addLayer("orphan", P.L.DenseLayer(nOut=4), "in")
        .addLayer("out", P.L.OutputLayer(nOut=2), "used")
        .setOutputs("out").build())


@case(want={"DL4J-E004"})
def e004_duplicate_graph_name(P):
    return (_graph_builder(P)
            .addLayer("fc", P.L.DenseLayer(nOut=4), "in")
            .addLayer("fc", P.L.DenseLayer(nOut=4), "in")
            .addLayer("out", P.L.OutputLayer(nOut=2), "fc")
            .setOutputs("out")).validate()


@case(want={"DL4J-E004"})
def e004_duplicate_explicit_layer_name(P):
    return (_builder(P).list()
            .layer(P.L.DenseLayer(nOut=8, name="fc"))
            .layer(P.L.DenseLayer(nOut=8, name="fc"))
            .layer(P.L.OutputLayer(nOut=2))
            .setInputType(P.InputType.feedForward(4))
            .build()).validate()


@case(want={"DL4J-E005"})
def e005_missing_cnn_to_dense_flatten(P):
    return (_builder(P).list()
            .layer(P.L.ConvolutionLayer(nIn=1, nOut=8, kernelSize=(3, 3)))
            .layer(P.L.DenseLayer(nIn=800, nOut=10))
            .layer(P.L.OutputLayer(nIn=10, nOut=2))
            .build()).validate()


def _two_conv_graph(P, vertex, stride_b=(1, 1), n_b=8):
    return (_builder(P).graphBuilder()
            .addInputs("in")
            .setInputTypes(P.InputType.convolutional(8, 8, 3))
            .addLayer("a", P.L.ConvolutionLayer(nOut=4, kernelSize=(1, 1)),
                      "in")
            .addLayer("b", P.L.ConvolutionLayer(nOut=n_b, kernelSize=(1, 1),
                                                stride=stride_b), "in")
            .addVertex("v", vertex, "a", "b")
            .addLayer("out", P.L.OutputLayer(nOut=2), "v")
            .setOutputs("out"))


@case(want={"DL4J-E006"})
def e006_elementwise_shape_conflict(P):
    return P.an.analyze(_two_conv_graph(P, P.ElementWiseVertex("Add"))
                        .build())


@case(want={"DL4J-E006"})
def e006_merge_spatial_conflict(P):
    return P.an.analyze(_two_conv_graph(P, P.MergeVertex(), stride_b=(2, 2),
                                        n_b=4).build())


@case(want={"DL4J-E007"})
def e007_shape_inference_failure(P):
    return P.an.analyze(_builder(P).list()
                        .layer(P.L.DenseLayer())
                        .layer(P.L.OutputLayer(nOut=2))
                        .setInputType(P.InputType.feedForward(4)))


@case(want={"DL4J-E008"})
def e008_missing_loss_head(P):
    return (_builder(P).list()
            .layer(P.L.DenseLayer(nOut=8))
            .layer(P.L.DenseLayer(nOut=2))
            .setInputType(P.InputType.feedForward(4))
            .build()).validate()


@case(want={"DL4J-W001"})
def w001_softmax_mse(P):
    return (_builder(P).list()
            .layer(P.L.OutputLayer(nOut=4, lossFunction="mse",
                                   activation="softmax"))
            .setInputType(P.InputType.feedForward(4))
            .build()).validate()


@case(want={"DL4J-W001"})
def w001_sigmoid_multiclass(P):
    return (_builder(P).list()
            .layer(P.L.OutputLayer(nOut=4, lossFunction="mcxent",
                                   activation="sigmoid"))
            .setInputType(P.InputType.feedForward(4))
            .build()).validate()


def _tbptt(P, recurrent):
    lb = _builder(P).list()
    if recurrent:
        lb = (lb.layer(P.L.LSTM(nOut=8)).layer(P.L.RnnOutputLayer(nOut=2))
              .setInputType(P.InputType.recurrent(4, 10)))
    else:
        lb = (lb.layer(P.L.DenseLayer(nOut=8))
              .layer(P.L.OutputLayer(nOut=2))
              .setInputType(P.InputType.feedForward(4)))
    return lb.backpropType("tbptt", 16).build().validate()


@case(want={"DL4J-W002"})
def w002_tbptt_without_recurrence(P):
    return _tbptt(P, False)


@case(absent={"DL4J-W002"})
def w002_absent_on_recurrent_net(P):
    return _tbptt(P, True)


def _frozen(P, updater):
    net = P.MLN(_mlp_conf(P, updater=updater))
    net._frozen_layers = {0}
    return net.validate()


@case(want={"DL4J-W003"})
def w003_frozen_with_stateful_updater(P):
    return _frozen(P, P.Adam(1e-3))


@case(absent={"DL4J-W003"})
def w003_absent_with_sgd(P):
    return _frozen(P, P.Sgd(0.1))


@case(absent={"DL4J-W101"})
def w101_clean_at_512(P):
    return _mlp_conf(P, hidden=512).validate()


@case(want={"DL4J-W103"})
def w103_batch_mesh_divisibility(P):
    return _mlp_conf(P).validate(batch_size=6, data_devices=4)


@case(absent={"DL4J-W103"})
def w103_clean_batch(P):
    return _mlp_conf(P).validate(batch_size=8, data_devices=4)


# TestDistributionDiagnostics
@case(want={"DL4J-E101"}, absent={"DL4J-W103"})
def e101_batch_not_divisible(P):
    return _mlp_conf(P).validate(batch_size=6, mesh="data=4")


@case(absent={"DL4J-E101"})
def e101_clean(P):
    return _mlp_conf(P).validate(batch_size=8, mesh="data=4")


@case(want={"DL4J-E102"})
def e102_absent_axis_in_sharding_rule(P):
    return _mlp_conf(P).validate(mesh="data=4",
                                 sharding={r"/W$": (None, "model")})


@case(absent={"DL4J-E102"})
def e102_clean_axis(P):
    return _mlp_conf(P).validate(mesh="data=4,model=1",
                                 sharding={r"/W$": (None, "model")})


@case(want={"DL4J-E102"})
def e102_pipeline_axis_absent(P):
    return _mlp_conf(P).validate(mesh="data=4",
                                 pipeline=P.an.PipelineSpec(2))


@case(want={"DL4J-E102"})
def e102_pipeline_axis_mismatched(P):
    return _mlp_conf(P).validate(mesh="data=2,pipe=4",
                                 pipeline=P.an.PipelineSpec(2))


@case(want={"DL4J-E102"})
def e102_axes_product_vs_declared_devices(P):
    return _mlp_conf(P).validate(mesh=P.an.MeshSpec({"data": 8}, devices=4))


@case(absent={"DL4J-E102"})
def e102_devices_clean(P):
    return _mlp_conf(P).validate(mesh=P.an.MeshSpec({"data": 4}, devices=4))


def _tied(P, order):
    lb = _builder(P).list()
    for kind, tie in order:
        cls = P.L.OutputLayer if kind == "out" else P.L.DenseLayer
        lb = lb.layer(cls(nOut=8, tiedWith=tie) if tie else cls(nOut=8))
    return (lb.setInputType(P.InputType.feedForward(8)).build())


@case(want={"DL4J-E103"})
def e103_tie_split_across_stages(P):
    conf = _tied(P, [("dense", "emb"), ("dense", None), ("dense", None),
                     ("out", "emb")])
    return conf.validate(mesh="pipe=2,data=1",
                         pipeline=P.an.PipelineSpec(2))


@case(absent={"DL4J-E103"})
def e103_tie_within_one_stage(P):
    conf = _tied(P, [("dense", "emb"), ("out", "emb"), ("dense", None),
                     ("dense", None)])
    return P.an.analyze(conf, mesh="pipe=2,data=1",
                        pipeline=P.an.PipelineSpec(2))


@case(want={"DL4J-E104"})
def e104_hbm_budget(P):
    return _wide_mlp(P).validate(mesh="data=8", hbm_gb=0.01)


@case(absent={"DL4J-E104"})
def e104_clean_budget(P):
    return _wide_mlp(P).validate(mesh="data=8", hbm_gb=16.0)


@case(want={"DL4J-W104"})
def w104_replicated_giant_with_idle_model_axis(P):
    return _wide_mlp(P).validate(mesh="data=4,model=2")


@case(absent={"DL4J-W104"})
def w104_pure_dp_mesh(P):
    return _wide_mlp(P).validate(mesh="data=8")


@case(absent={"DL4J-W104"})
def w104_sharded_by_rule(P):
    return _wide_mlp(P).validate(mesh="data=4,model=2",
                                 sharding={r"/W$": (None, "model")})


@case(want={"DL4J-W105"})
def w105_pipeline_flop_imbalance(P):
    return _dense_stack(P, [2048, 8, 8], 2048, out=2).validate(
        mesh="pipe=2,data=1", pipeline=P.an.PipelineSpec(2))


@case(absent={"DL4J-W105"})
def w105_balanced(P):
    return P.an.analyze(_dense_stack(P, [512] * 4, 512),
                        mesh="pipe=2,data=1", pipeline=P.an.PipelineSpec(2))


@case(want={"DL4J-W106"})
def w106_non_divisible_shard(P):
    return _dense_stack(P, [4096], 4100, out=2).validate(
        mesh="data=1,model=8", sharding={r"/W$": ("model", None)})


@case(absent={"DL4J-W106"})
def w106_healthy_shard(P):
    return _wide_mlp(P).validate(mesh="data=1,model=8",
                                 sharding={r"DenseLayer/W$": (None, "model")})


@case(want={"DL4J-W107"})
def w107_collective_volume(P):
    return _dense_stack(P, [16384], 16384, out=2).validate(mesh="data=8")


@case(absent={"DL4J-W107"})
def w107_clean(P):
    return _mlp_conf(P).validate(mesh="data=8")


@case(want={"DL4J-W104"})
def graph_config_gets_distribution_lints(P):
    g = (_graph_builder(P)
         .addLayer("fc", P.L.DenseLayer(nOut=4096, nIn=4096), "in")
         .addLayer("out", P.L.OutputLayer(nOut=2), "fc")
         .setOutputs("out"))
    return P.an.analyze(g.build(), mesh="data=4,model=2")


@case(want={"DL4J-W109"})
def zoo_w109_without_zero_declaration(P):
    return P.an.analyze(P.zoo.VGG16().conf_builder(), mesh="data=8")


# TestSuppressionConfig
@case(absent={"DL4J-W101"})
def suppress_w101(P):
    return _mlp_conf(P, hidden=300).validate(suppress=["w101"])


@case(want={"DL4J-E101"})
def severity_override_upgrades(P):
    report = _mlp_conf(P).validate(batch_size=6, mesh="data=4",
                                   severity_overrides={"E101": "warning"})
    assert report.ok()
    return report


# TestSameDiffLint
@case()
def sd_clean_bill(P):
    report = _sd_mlp(P).validate()
    assert report.ok(warnings_as_errors=True), report.format()
    return report


@case(want={"DL4J-E151"})
def sd_e151_undefined_input(P):
    sd = _sd_mlp(P)
    sd._nodes[0].inputs[0] = "ghost"
    return sd.validate()


@case(want={"DL4J-E152"})
def sd_e152_matmul_conflict(P):
    sd = P.sd()
    a = sd.var("a", np.zeros((3, 4)))
    b = sd.var("b", np.zeros((5, 6)))
    a.mmul(b)
    return sd.validate()


@case(want={"DL4J-E152"})
def sd_e152_broadcast_conflict(P):
    sd = P.sd()
    p = sd.var("p", np.zeros((3, 4)))
    q = sd.var("q", np.zeros((3, 5)))
    p.add(q)
    return sd.validate()


@case(want={"DL4J-E153"})
def sd_e153_bad_loss_variable(P):
    sd = _sd_mlp(P)
    sd.setLossVariables("loss", "no_such_var")
    return sd.validate()


@case(want={"DL4J-W151"})
def sd_w151_dangling_placeholder(P):
    sd = _sd_mlp(P)
    sd.placeHolder("ghost", shape=(None, 3))
    return sd.validate()


@case(want={"DL4J-W152"})
def sd_w152_unused_variable(P):
    sd = _sd_mlp(P)
    sd.var("dead", np.zeros((4, 4)))
    return sd.validate()


@case(absent={"DL4J-W152"})
def sd_suppress_applies(P):
    sd = _sd_mlp(P)
    sd.var("dead", np.zeros((4, 4)))
    return sd.validate(suppress=["W152"])


@case(want={"DL4J-W153"})
def sd_w153_training_config_without_loss(P):
    sd = P.sd()
    sd.var("v", np.zeros((2, 2)))
    sd.setTrainingConfig(P.TrainingConfig())
    return sd.validate()


@case(absent={"DL4J-W153"})
def sd_w153_clean_with_loss(P):
    sd = _sd_mlp(P)
    sd.setTrainingConfig(P.TrainingConfig())
    return sd.validate()


# TestReviewRegressions
@case(absent={"DL4J-E152"})
def sd_unknown_nonbatch_placeholder_dim(P):
    sd = P.sd()
    x = sd.placeHolder("x", shape=(None, None))
    w = sd.var("w", np.zeros((3, 2)))
    b = sd.var("b", np.zeros(2))
    sd.nn.linear(x, w, b, name="z")
    return sd.validate(batch_size=4)


def _two_4096(P):
    return _dense_stack(P, [4096, 4096], 4096)


@case(absent={"DL4J-E104"})
def e104_heaviest_stage_passes(P):
    return P.an.analyze(_two_4096(P), mesh="pipe=2,data=1",
                        pipeline=P.an.PipelineSpec(2), hbm_gb=0.1)


@case(want={"DL4J-E104"})
def e104_flat_fails(P):
    return P.an.analyze(_two_4096(P), mesh="data=1", hbm_gb=0.1)


@case(want={"DL4J-E104"})
def e104_tight_stage(P):
    return P.an.analyze(_two_4096(P), mesh="pipe=2,data=1",
                        pipeline=P.an.PipelineSpec(2), hbm_gb=0.05)


@case(want={"DL4J-W107"})
def w107_on_model_mesh(P):
    return _dense_stack(P, [16384], 16384, out=2).validate(
        mesh="data=8,model=4")


@case(absent={"DL4J-W107"})
def w107_clears_when_sharded(P):
    return _dense_stack(P, [16384], 16384, out=2).validate(
        mesh="data=8,model=4",
        sharding={r"DenseLayer/W$": (None, "model")})


@case(want={"DL4J-E101"})
def sd_mesh_kwargs_run_distribution_lints(P):
    return _sd_linear(P).validate(batch_size=12, mesh="data=8")


# TestInputPipelineLint (the measured-rate cases; the FLOP-model estimate
# reads the card's peak and is pinned below)
def _pipe(P, **kw):
    return P.an.InputPipelineSpec(workers=2, batch_size=64,
                                  decode_ms_per_img=1.0, dtype="uint8", **kw)


@case(absent={"DL4J-W108"})
def w108_measured_rate_clean(P):
    return P.an.analyze(_conv_conf(P),
                        input_pipeline=_pipe(P, device_img_per_sec=1000))


@case(want={"DL4J-W108"})
def w108_measured_rate_hot(P):
    return P.an.analyze(_conv_conf(P),
                        input_pipeline=_pipe(P, device_img_per_sec=10000))


def _pipe_graph(P):
    return (P.NNC.Builder().graphBuilder()
            .addInputs("in")
            .addLayer("c", P.L.ConvolutionLayer(nOut=8, kernelSize=(3, 3)),
                      "in")
            .addLayer("d", P.L.DenseLayer(nOut=16, activation="relu"), "c")
            .addLayer("out", P.L.OutputLayer(nOut=4), "d")
            .setOutputs("out")
            .setInputTypes(P.InputType.convolutional(16, 16, 3)))


@case(absent={"DL4J-W108"})
def w108_graph_config_needs_measured_rate(P):
    return P.an.analyze(_pipe_graph(P), input_pipeline=P.an.InputPipelineSpec(
        workers=1, batch_size=64, decode_ms_per_img=50.0, height=16,
        width=16))


@case(want={"DL4J-W108"})
def w108_graph_config_measured(P):
    return P.an.analyze(_pipe_graph(P), input_pipeline=P.an.InputPipelineSpec(
        workers=1, batch_size=64, decode_ms_per_img=50.0, height=16,
        width=16, device_img_per_sec=10000))


# TestNumericsDiagnostics
def _fp16_state(P, scale=1024):
    return P.Policy("float16", params="float16", loss_scale=scale)


@case(want={"DL4J-E301"})
def e301_low_precision_updater_state(P):
    return P.an.analyze(_num_mlp(P, updater=P.Adam(1e-3)),
                        policy=_fp16_state(P))


@case(absent={"DL4J-E301"})
def e301_fp32_masters_clean(P):
    return P.an.analyze(_num_mlp(P, updater=P.Adam(1e-3)), policy="fp16",
                        suppress=["E303"])


@case(absent={"DL4J-E301"})
def e301_stateless_sgd_clean(P):
    return P.an.analyze(_num_mlp(P), policy=_fp16_state(P))


@case(want={"DL4J-E301"})
def e301_contradicting_layer_override(P):
    return P.an.analyze(_num_mlp(P, dataType="float16"), policy="bf16")


@case(absent={"DL4J-E301"})
def e301_matching_override(P):
    return P.an.analyze(_num_mlp(P, dataType="bf16"), policy="bf16")


@case(absent={"DL4J-E301"})
def e301_fp32_island(P):
    return P.an.analyze(_num_mlp(P, dataType="float32"), policy="bf16")


def _softmax_dense(P, n, **kw):
    return (_builder(P).list()
            .layer(P.L.DenseLayer(nOut=n, activation="softmax", **kw))
            .layer(P.L.OutputLayer(nOut=3))
            .setInputType(P.InputType.feedForward(8)).build())


@case(want={"DL4J-E302"})
def e302_large_softmax_axis(P):
    return P.an.analyze(_softmax_dense(P, 1024), policy="bf16")


@case(absent={"DL4J-E302"})
def e302_fp32_policy(P):
    return P.an.analyze(_softmax_dense(P, 1024))


@case(absent={"DL4J-E302"})
def e302_small_axis(P):
    return P.an.analyze(_softmax_dense(P, 64), policy="bf16")


@case(absent={"DL4J-E302"})
def e302_island(P):
    return P.an.analyze(_softmax_dense(P, 1024, dataType="float32"),
                        policy="bf16")


@case(want={"DL4J-E302"})
def e302_loss_head_dragged_low(P):
    conf = (_builder(P).list()
            .layer(P.L.DenseLayer(nOut=16))
            .layer(P.L.OutputLayer(nOut=3, dataType="bf16"))
            .setInputType(P.InputType.feedForward(8)).build())
    return P.an.analyze(conf, policy="bf16")


def _attention(P, t):
    return (_builder(P).list()
            .layer(P.L.SelfAttentionLayer(nOut=64, nHeads=4, headSize=16))
            .layer(P.L.RnnOutputLayer(nOut=3, lossFunction="mcxent"))
            .setInputType(P.InputType.recurrent(64, t)).build())


@case(want={"DL4J-E302"})
def e302_attention_timestep_axis(P):
    return P.an.analyze(_attention(P, 2048), policy="bf16")


@case(absent={"DL4J-E302"})
def e302_short_attention(P):
    return P.an.analyze(_attention(P, 128), policy="bf16")


@case(want={"DL4J-E303"})
def e303_fp16_without_loss_scaling(P):
    return P.an.analyze(_num_mlp(P), policy="fp16")


@case(absent={"DL4J-E303"})
def e303_fp16_scaled(P):
    return P.an.analyze(_num_mlp(P),
                        policy=P.Policy("float16", loss_scale=2 ** 15))


def _yolo_like(P, updater=None):
    return (_builder(P, updater).list()
            .layer(P.L.DenseLayer(nOut=32, activation="relu"))
            .layer(P.L.LossLayer(lossFunction="mse"))
            .setInputType(P.InputType.feedForward(16)).build())


@case(want={"DL4J-E303"})
def e303_yolo_overflow_fixture(P):
    return _yolo_like(P, P.Adam(1e-3)).validate(
        policy=_fp16_state(P, 2 ** 15), data_range="0..255")


@case(want={"DL4J-W303"}, absent={"DL4J-E303"})
def w303_fp32_state_holds_the_moment(P):
    return _yolo_like(P, P.Adam(1e-3)).validate(data_range="0..255")


@case(absent={"DL4J-E303", "DL4J-W303"})
def e303_normalized_input(P):
    return _yolo_like(P, P.Adam(1e-3)).validate(
        policy=_fp16_state(P, 2 ** 15), data_range="0..1")


@case(want={"DL4J-E303"})
def e303_scaled_gradient_overflow(P):
    return P.an.analyze(_yolo_like(P),
                        policy=P.Policy("float16", loss_scale=2 ** 15),
                        data_range="0..255")


@case(absent={"DL4J-E303"})
def e303_scaled_normalized_clean(P):
    return P.an.analyze(_yolo_like(P),
                        policy=P.Policy("float16", loss_scale=2 ** 15),
                        data_range="0..1")


def _sandwich(P, layers):
    lb = _builder(P).list()
    for dt in layers:
        lb = lb.layer(P.L.DenseLayer(nOut=16, dataType=dt) if dt
                      else P.L.DenseLayer(nOut=16))
    return (lb.layer(P.L.OutputLayer(nOut=3))
            .setInputType(P.InputType.feedForward(8)).build())


@case(want={"DL4J-W301"})
def w301_fp32_sandwich(P):
    return P.an.analyze(_sandwich(P, [None, "float32", None]), policy="bf16")


@case(absent={"DL4J-W301"})
def w301_island_at_the_edge(P):
    return P.an.analyze(_sandwich(P, [None, "float32"]), policy="bf16")


@case(absent={"DL4J-W301"})
def w301_sequential_only(P):
    g = (_graph_builder(P)
         .addLayer("a", P.L.DenseLayer(nOut=16), "in")
         .addLayer("b", P.L.DenseLayer(nOut=16, dataType="float32"), "in")
         .addLayer("c", P.L.DenseLayer(nOut=16), "in")
         .addLayer("m", P.L.DenseLayer(nOut=16), "a", "b")
         .addLayer("out", P.L.OutputLayer(nOut=2), "m")
         .setOutputs("out"))
    return P.an.analyze(g.build(), policy="bf16", suppress=["E003"])


@case(want={"DL4J-W302"})
def w302_scale_on_bf16(P):
    return P.an.analyze(_num_mlp(P),
                        policy=P.Policy("bfloat16", loss_scale=1024))


@case(want={"DL4J-W302"})
def w302_scale_below_one(P):
    return P.an.analyze(_num_mlp(P),
                        policy=P.Policy("float16", loss_scale=0.5))


@case(want={"DL4J-W302"})
def w302_scale_overflows(P):
    return P.an.analyze(_num_mlp(P),
                        policy=P.Policy("float16", loss_scale=2.0 ** 30))


@case(absent={"DL4J-W302"})
def w302_clean(P):
    return P.an.analyze(_num_mlp(P),
                        policy=P.Policy("float16", loss_scale=2 ** 15))


@case(want={"DL4J-W303"})
def w303_unnormalized_input(P):
    return P.an.analyze(_num_mlp(P, updater=P.Adam(1e-3)),
                        data_range="0..255")


@case(absent={"DL4J-W303"})
def w303_declared_normalized(P):
    return P.an.analyze(_num_mlp(P, updater=P.Adam(1e-3)),
                        data_range="0..255,normalized")


@case(absent={"DL4J-W303"})
def w303_leading_batchnorm(P):
    bn = (_builder(P, P.Adam(1e-3)).list()
          .layer(P.L.BatchNormalization())
          .layer(P.L.DenseLayer(nOut=16, activation="relu"))
          .layer(P.L.OutputLayer(nOut=3))
          .setInputType(P.InputType.feedForward(8)).build())
    return P.an.analyze(bn, data_range="0..255")


@case(want={"DL4J-E302"})
def attached_policy_feeds_validate(P):
    net = P.MLN(_softmax_dense(P, 1024))
    assert "DL4J-E302" not in net.validate().codes()
    net.setPrecisionPolicy("bf16")
    return net.validate()


@case(want={"DL4J-E301"})
def graph_config_numerics(P):
    g = (_graph_builder(P)
         .addLayer("fc", P.L.DenseLayer(nOut=16, dataType="float16"), "in")
         .addLayer("out", P.L.OutputLayer(nOut=2), "fc")
         .setOutputs("out"))
    return P.an.analyze(g.build(), policy="bf16")


@case(want={"DL4J-W303"})
def sd_numerics_kwargs_run_numerics_lints(P):
    return P.an.analyze(_sd_linear(P), batch_size=8, policy="bf16",
                        data_range="0..255")


# TestFlopModelExtensions
@case(want={"DL4J-W105"})
def w105_counts_attention_stage(P):
    lb = _builder(P).list()
    for _ in range(3):
        lb = lb.layer(P.L.SelfAttentionLayer(nOut=512, nHeads=8,
                                             headSize=64))
    conf = (lb.layer(P.L.RnnOutputLayer(nOut=2, lossFunction="mcxent"))
            .setInputType(P.InputType.recurrent(512, 256)).build())
    return P.an.analyze(conf, mesh={"data": 2, "pipe": 2}, pipeline=2)


# TestGraphVertexPropagation
def _graph_chain(P, widths, out):
    g = _graph_builder(P).setInputTypes(P.InputType.feedForward(64))
    prev = "in"
    for name, w in zip("abc", widths):
        g = g.addLayer(name, P.L.DenseLayer(nOut=w), prev)
        prev = name
    return (g.addLayer("out", P.L.OutputLayer(nOut=out), prev)
            .setOutputs("out").build())


@case(want={"DL4J-W105"})
def w105_graph_pipeline_imbalance(P):
    return P.an.analyze(_graph_chain(P, [4096, 4096, 16], 4), batch_size=32,
                        mesh="data=2,pipe=2", pipeline=2)


@case(absent={"DL4J-W105"})
def w105_balanced_graph(P):
    return P.an.analyze(_graph_chain(P, [256] * 3, 256), batch_size=32,
                        mesh="data=2,pipe=2", pipeline=2)


def _merge_graph(P):
    return (_graph_builder(P)
            .addLayer("a", P.L.DenseLayer(nOut=32), "in")
            .addLayer("b", P.L.DenseLayer(nOut=32), "in")
            .addVertex("m", P.MergeVertex(), "a", "b")
            .addLayer("c", P.L.DenseLayer(nOut=16), "m")
            .addLayer("out", P.L.OutputLayer(nOut=4), "c")
            .setOutputs("out").build())


@case()
def merge_graph_clean_under_data_mesh(P):
    report = P.an.analyze(_merge_graph(P), batch_size=32, mesh={"data": 2})
    assert report.ok()
    return report


# TestGraphIRParity
@case(want={"DL4J-E101"})
def graphir_from_multilayer_distribution(P):
    ir = P.gir.from_multilayer(_wide_mlp(P), batch_size=6)
    mesh = P.an.MeshSpec({"data": 8, "model": 2}, hbm_gb=0.05)
    return P.an.ValidationReport(P.gir.lint_ir_distribution(ir, mesh, 6))


@pytest.mark.parametrize("name", sorted(CASES))
def test_same_findings_as_the_jax_package(name):
    build, want, absent = CASES[name]
    j, t = build(JAX), build(TORCH)
    codes = set(j.codes())
    assert want <= codes and not absent & codes, j.format()
    assert _facts(t) == _facts(j), (t.format(), j.format())


def test_graphir_lowering_agrees_with_the_native_pass():
    dist = {"DL4J-E101", "DL4J-E102", "DL4J-E103", "DL4J-E104",
            "DL4J-W104", "DL4J-W105", "DL4J-W106", "DL4J-W107"}
    conf = _wide_mlp(TORCH)
    mesh = ta.MeshSpec({"data": 8, "model": 2}, hbm_gb=0.05)
    native = {d.code for d in ta.analyze(conf, batch_size=6,
                                         mesh=mesh)} & dist
    ir = t_gir.from_multilayer(conf, batch_size=6)
    lowered = {d.code for d in t_gir.lint_ir_distribution(ir, mesh, 6)}
    assert native == lowered & dist and "DL4J-E101" in native


def test_merge_vertex_types_propagate_as_in_jax():
    want = j_dist._propagate_graph_types(_merge_graph(JAX))["c"]
    got = t_dist._propagate_graph_types(_merge_graph(TORCH))["c"]
    assert (got[0].size, got[1].size) == (want[0].size, want[1].size) \
        == (64, 16)


def test_attention_flops_equal_the_jax_estimate():
    def flops(P, mod):
        conf = (_builder(P).list()
                .layer(P.L.SelfAttentionLayer(nOut=768, nHeads=12,
                                              headSize=64))
                .layer(P.L.RnnOutputLayer(nOut=2, lossFunction="mcxent"))
                .setInputType(P.InputType.recurrent(768, 128)).build())
        types_ = mod._propagate_types(conf)
        return mod._approx_flops(conf.layers[0], *types_[0])
    assert flops(TORCH, t_dist) == flops(JAX, j_dist) > 0


# ------------------------------------------------------ Hopper rules, pinned
def _only(report, code):
    return [d for d in report if d.code == code]


def test_w101_pads_to_the_hopper_cta_tile():
    """Hopper rule: a GEMM's N dim pads to the 128-wide CTA tile of two
    64-row wgmma warpgroups; the MXU rule padded lanes to 128 as well, so
    the verdicts agree (nOut=300 pads to 384, 22% dead in both) and the
    message names the Hopper tile; under a bf16 policy it also names the
    16-byte TMA row alignment 300 misses (fp32's 1200-byte rows keep it).
    JAX verdict replaced: its text, "8x128 MXU tile grid"."""
    t = _only(_mlp_conf(TORCH, hidden=300).validate(), "DL4J-W101")
    j = _only(_mlp_conf(JAX, hidden=300).validate(), "DL4J-W101")
    assert [d.location for d in t] == [d.location for d in j]
    assert "MXU" in j[0].message and "384" in j[0].message
    assert "128x128 Hopper" in t[0].message and "384" in t[0].message
    assert "22%" in t[0].message and "multiple of 8" not in t[0].message
    bf16 = _only(ta.analyze(_mlp_conf(TORCH, hidden=300), policy="bf16"),
                 "DL4J-W101")
    assert "22%" in bf16[0].message and "multiple of 8" in bf16[0].message
    assert t_layout.padded_dim(296) == 384 and t_layout.padded_dim(304) == 384
    assert round(t_layout.padding_waste(296), 3) == 0.229


@pytest.mark.parametrize("hidden,policy,fires", [
    (425, "bf16", True), (425, "fp16", True), (425, None, False),
    (424, "bf16", False), (500, "bf16", True), (504, "bf16", False),
    (250, "bf16", False)])
def test_w101_flags_misaligned_16_bit_rows(hidden, policy, fires):
    """Hopper rule: under a bf16 or fp16 policy an N dim >= 256 that is
    not a multiple of 8 misses TMA's 16-byte row alignment and runs on a
    slower kernel (chip_smoke.py phase 33 (e) times a bf16 matmul and
    YOLO2's head conv at 425 against 424); fp32, off the tensor cores,
    is not flagged for it. JAX verdict replaced: the MXU rule never
    flags 425, 500 (17% and 2% padding) under any policy."""
    t = _only(ta.analyze(_mlp_conf(TORCH, hidden=hidden), policy=policy),
              "DL4J-W101")
    j = _only(ja.analyze(_mlp_conf(JAX, hidden=hidden), policy=policy),
              "DL4J-W101")
    assert not j
    assert bool(t) is fires
    if fires:
        assert t[0].location == "layer 0 (DenseLayer)"
        assert f"{hidden} is not a multiple of 8" in t[0].message
        assert "multiple of 8" in t[0].fix_hint


def test_w101_severity_override_and_suppression_still_apply():
    conf = _mlp_conf(TORCH, hidden=300)
    up = conf.validate(severity_overrides={"W101": "error"})
    assert _only(up, "DL4J-W101")[0].severity is ta.Severity.ERROR
    with pytest.raises(ta.ModelValidationError):
        up.raise_if_errors()
    assert conf.validate(severity_overrides={"W101": ta.Severity.INFO}).ok(
        warnings_as_errors=True)


def test_w102_float16_runs_at_the_bf16_rate_on_hopper():
    """Hopper rule: float16 runs on the tensor cores at the bf16 rate, so
    it is not flagged; float64 still is. JAX verdict replaced: W102 on
    float16 ("upcast to float32 on the MXU")."""
    def conf(P, dt):
        return (_builder(P).dataType(dt).list()
                .layer(P.L.OutputLayer(nOut=2))
                .setInputType(P.InputType.feedForward(4)).build())
    assert "DL4J-W102" in conf(JAX, "float16").validate().codes()
    assert "DL4J-W102" not in conf(TORCH, "float16").validate().codes()
    assert "bf16-rate" in _only(conf(TORCH, "float64").validate(),
                                "DL4J-W102")[0].message


def test_w106_k_dim_shards_against_the_wgmma_step():
    """Hopper rule: a weight's K (contraction) dim sharded below one
    16-element wgmma K step pads back up; the MXU rule's floor there was
    its 8 sublanes. 4096 over model=512 leaves 8 rows a device: JAX
    clean, the port W106."""
    def report(P):
        return _wide_mlp(P).validate(
            mesh="data=1,model=512",
            sharding={r"DenseLayer/W$": ("model", None)})
    assert "DL4J-W106" not in report(JAX).codes()
    w = _only(report(TORCH), "DL4J-W106")
    assert w and "16-element wgmma step" in w[0].message


def test_w106_n_dim_shards_against_the_cta_tile():
    """Both flag 4096/64 = 64 columns a device (below 128); the port's
    message names the Hopper GEMM tile instead of the MXU tile."""
    rule = {r"DenseLayer/W$": (None, "model")}
    j = _only(_wide_mlp(JAX).validate(mesh="data=1,model=64", sharding=rule),
              "DL4J-W106")
    t = _only(_wide_mlp(TORCH).validate(mesh="data=1,model=64",
                                        sharding=rule), "DL4J-W106")
    assert [d.location for d in t] == [d.location for d in j]
    assert "MXU" in j[0].message and "Hopper GEMM tile" in t[0].message


def test_default_hbm_budget_is_an_h100():
    """The E104 default per-device budget: the H100's 74.5 GiB, where the
    JAX package assumed a 16 GiB TPU."""
    assert t_dist.DEFAULT_HBM_GB == ta.CHIP_REGISTRY["h100-sxm"].hbm_gb \
        == 74.5
    assert j_dist.DEFAULT_HBM_GB == 16.0
    assert ta.MeshSpec({"data": 8}).hbm_gb == 74.5


def test_w108_estimate_uses_the_h100_peak():
    """W108's FLOP-model device rate reads the H100's dense bf16 peak
    (989 TFLOP/s) where the JAX package read the v5e's 197: the verdicts
    on the seeded starved and fed pipelines agree, and the port's
    estimated device rate is the JAX one times 989/197."""
    from deeplearning4j_tpu.analysis import pipeline as j_pipe
    from deeplearning4j_tpu_torch.analysis import pipeline as t_pipe
    assert t_pipe.PEAK_TFLOPS == 989.0 and j_pipe.PEAK_TFLOPS == 197.0
    starved = dict(workers=1, batch_size=256, decode_ms_per_img=50.0,
                   h2d_mbps=6.2, dtype="float32")
    fed = dict(workers=256, batch_size=256, decode_ms_per_img=1.0,
               h2d_mbps=100000, dtype="uint8")
    for spec, fires in ((starved, True), (fed, False)):
        for P in (JAX, TORCH):
            rep = P.an.analyze(_conv_conf(P),
                               input_pipeline=P.an.InputPipelineSpec(**spec))
            assert ("DL4J-W108" in rep.codes()) is fires
    j_rate = j_pipe._estimate_device_rate(
        _conv_conf(JAX), j_pipe.InputPipelineSpec(**starved))
    t_rate = t_pipe._estimate_device_rate(
        _conv_conf(TORCH), t_pipe.InputPipelineSpec(**starved))
    assert t_rate == pytest.approx(j_rate * 989.0 / 197.0, rel=1e-9)
    w = _only(ta.analyze(_conv_conf(TORCH),
                         input_pipeline=ta.InputPipelineSpec(**starved)),
              "DL4J-W108")[0]
    assert "cannot feed this chip" in w.message and "uint8" in w.fix_hint


@pytest.mark.parametrize("name", ["TinyYOLO", "ResNet50"])
def test_conv_stack_lint_fires_for_a_network_on_cuda(name):
    """Hopper rule: cuDNN's tensor-core convolutions run NHWC, so an NCHW
    conv stack in a network whose parameters live on the card gets W101
    from ``validate()``, on both engines. A configuration, or a network
    before ``init`` or on the CPU, names no such device and stays silent
    (the JAX package reads the live jax backend instead); so does the
    NHWC compute layout."""
    net = t_zoo.ZOO_MODELS[name]().conf_builder()
    assert not _only(net.conf.validate(), "DL4J-W101")
    assert not _only(net.validate(), "DL4J-W101")
    net._device = torch.device("cpu")
    assert not _only(net.validate(), "DL4J-W101")
    # what init(device="cuda") leaves behind; the analysis makes no tensor
    net._device = torch.device("cuda")
    w = _only(net.validate(), "DL4J-W101")
    assert len(w) == 1 and "NCHW compute layout on a 'cuda' device" \
        in w[0].message and "setComputeLayout" in w[0].fix_hint
    net.setComputeLayout("NHWC")
    assert not _only(net.validate(), "DL4J-W101")


# ------------------------------------------------------------ the zoo, clean
#: the zoo's findings under a bf16 policy: widths whose bf16 rows miss
#: TMA's 16-byte alignment (LeNet's 500-wide dense, YOLO2's 425-channel
#: head, anchors x (5 + classes)); the JAX package lints both clean
ZOO_BF16_W101 = {"LeNet": ["layer 4 (DenseLayer)"],
                 "YOLO2": ["'conv_out' (ConvolutionLayer)"]}


@pytest.mark.parametrize("name", sorted(t_zoo.ZOO_MODELS))
def test_zoo_model_lints_clean(name):
    conf = t_zoo.ZOO_MODELS[name]().conf_builder()
    for kw in ({}, {"mesh": "data=8", "zero": True}):
        report = ta.analyze(conf, **kw)
        assert report.ok(warnings_as_errors=True), (kw, report.format())
    report = ta.analyze(conf, policy="bf16")
    assert report.ok() and [d.code for d in report.warnings()] == \
        ["DL4J-W101"] * len(ZOO_BF16_W101.get(name, [])), report.format()
    assert [d.location for d in report.warnings()] == \
        ZOO_BF16_W101.get(name, [])


def test_fixture_configs_are_clean():
    P = TORCH
    fixtures = [
        _mlp_conf(P),
        (_builder(P).list()
         .layer(P.L.ConvolutionLayer(nOut=8, kernelSize=(3, 3)))
         .layer(P.L.SubsamplingLayer(kernelSize=(2, 2), stride=(2, 2)))
         .layer(P.L.DenseLayer(nOut=16, activation="relu"))
         .layer(P.L.OutputLayer(nOut=2))
         .setInputType(P.InputType.convolutional(12, 12, 1))
         .build()),
        (_builder(P).list()
         .layer(P.L.LSTM(nOut=8))
         .layer(P.L.RnnOutputLayer(nOut=3))
         .setInputType(P.InputType.recurrent(5, 7))
         .build()),
    ]
    for conf in fixtures:
        report = conf.validate()
        assert report.ok(warnings_as_errors=True), report.format()


def test_code_table_and_exports_match_the_jax_package():
    assert set(ta.DIAGNOSTIC_CODES) == set(ja.DIAGNOSTIC_CODES)
    assert set(ta.__all__) == set(ja.__all__)
    for name in ja.__all__:
        assert hasattr(ta, name), name
    with pytest.raises(ValueError):
        ta.Diagnostic("DL4J-E999", ta.Severity.ERROR, "x", "undocumented")
    assert ta.normalize_code("w101") == "DL4J-W101"
    with pytest.raises(ValueError, match="unknown diagnostic code"):
        _mlp_conf(TORCH).validate(suppress=["W999"])
    with pytest.raises(ValueError, match="unknown severity"):
        _mlp_conf(TORCH).validate(severity_overrides={"W101": "loud"})


# ------------------------------------------------- param_shapes == initialize
class _Fragment(t_layers.SameDiffLayer):
    def defineParameters(self):
        return {"W": (self.nIn, self.nOut), "b": (1, self.nOut)}

    def defineLayer(self, sd, x, params, mask=None):
        return x.mmul(params["W"]).add(params["b"])


L = t_layers
IT = t_config.InputType
#: class -> (layer, the input type it infers nIn from)
LAYER_CASES = {
    "DenseLayer": (lambda: L.DenseLayer(nOut=5), IT.feedForward(4)),
    "ConvolutionLayer": (lambda: L.ConvolutionLayer(nOut=5),
                         IT.convolutional(8, 8, 3)),
    "Deconvolution2D": (lambda: L.Deconvolution2D(nOut=5, hasBias=False),
                        IT.convolutional(8, 8, 3)),
    "DepthwiseConvolution2D": (
        lambda: L.DepthwiseConvolution2D(depthMultiplier=2),
        IT.convolutional(8, 8, 3)),
    "SeparableConvolution2D": (
        lambda: L.SeparableConvolution2D(nOut=6, depthMultiplier=2),
        IT.convolutional(8, 8, 3)),
    "SubsamplingLayer": (lambda: L.SubsamplingLayer(),
                         IT.convolutional(8, 8, 3)),
    "BatchNormalization": (lambda: L.BatchNormalization(),
                           IT.convolutional(8, 8, 3)),
    "LocalResponseNormalization": (lambda: L.LocalResponseNormalization(),
                                   IT.convolutional(8, 8, 3)),
    "ActivationLayer": (lambda: L.ActivationLayer(), IT.feedForward(4)),
    "DropoutLayer": (lambda: L.DropoutLayer(), IT.feedForward(4)),
    "SpatialDropoutLayer": (lambda: L.SpatialDropoutLayer(),
                            IT.convolutional(8, 8, 3)),
    "ZeroPaddingLayer": (lambda: L.ZeroPaddingLayer(),
                         IT.convolutional(8, 8, 3)),
    "Upsampling2D": (lambda: L.Upsampling2D(), IT.convolutional(8, 8, 3)),
    "Cropping2D": (lambda: L.Cropping2D(), IT.convolutional(8, 8, 3)),
    "GlobalPoolingLayer": (lambda: L.GlobalPoolingLayer(),
                           IT.convolutional(8, 8, 3)),
    "LSTM": (lambda: L.LSTM(nOut=5), IT.recurrent(4, 6)),
    "GravesLSTM": (lambda: L.GravesLSTM(nOut=5), IT.recurrent(4, 6)),
    "GRU": (lambda: L.GRU(nOut=5), IT.recurrent(4, 6)),
    "SimpleRnn": (lambda: L.SimpleRnn(nOut=5), IT.recurrent(4, 6)),
    "Bidirectional": (lambda: L.Bidirectional(L.GRU(nOut=5)),
                      IT.recurrent(4, 6)),
    "BidirectionalLastStep": (
        lambda: L.BidirectionalLastStep(L.LSTM(nOut=5)), IT.recurrent(4, 6)),
    "LastTimeStep": (lambda: L.LastTimeStep(L.LSTM(nOut=5)),
                     IT.recurrent(4, 6)),
    "OutputLayer": (lambda: L.OutputLayer(nOut=3), IT.feedForward(4)),
    "LossLayer": (lambda: L.LossLayer(), IT.feedForward(4)),
    "RnnOutputLayer": (lambda: L.RnnOutputLayer(nOut=3), IT.recurrent(4, 6)),
    "EmbeddingLayer": (lambda: L.EmbeddingLayer(nIn=10, nOut=4),
                       IT.feedForward(1)),
    "EmbeddingSequenceLayer": (
        lambda: L.EmbeddingSequenceLayer(nIn=10, nOut=4), IT.recurrent(1, 6)),
    "Convolution1D": (lambda: L.Convolution1D(nOut=5), IT.recurrent(4, 6)),
    "Subsampling1DLayer": (lambda: L.Subsampling1DLayer(),
                           IT.recurrent(4, 6)),
    "PReLULayer": (lambda: L.PReLULayer(), IT.feedForward(4)),
    "LayerNorm": (lambda: L.LayerNorm(), IT.feedForward(4)),
    "GroupNorm": (lambda: L.GroupNorm(groups=2),
                  IT.convolutional(8, 8, 4)),
    "UnitNormLayer": (lambda: L.UnitNormLayer(), IT.feedForward(4)),
    "Permute": (lambda: L.Permute(), IT.recurrent(4, 6)),
    "RepeatVector": (lambda: L.RepeatVector(), IT.feedForward(4)),
    "SelfAttentionLayer": (
        lambda: L.SelfAttentionLayer(nOut=8, nHeads=2, headSize=4,
                                     useBias=True), IT.recurrent(4, 6)),
    "LearnedSelfAttentionLayer": (
        lambda: L.LearnedSelfAttentionLayer(nOut=8, nHeads=2, headSize=4,
                                            nQueries=3), IT.recurrent(4, 6)),
    "RecurrentAttentionLayer": (lambda: L.RecurrentAttentionLayer(nOut=5),
                                IT.recurrent(4, 6)),
    "ConvLSTM2D": (lambda: L.ConvLSTM2D(nOut=5),
                   IT.convolutional3D(4, 8, 8, 3)),
    "Convolution3D": (lambda: L.Convolution3D(nOut=5),
                      IT.convolutional3D(6, 8, 8, 3)),
    "Subsampling3DLayer": (lambda: L.Subsampling3DLayer(),
                           IT.convolutional3D(6, 8, 8, 3)),
    "ZeroPadding3DLayer": (lambda: L.ZeroPadding3DLayer(),
                           IT.convolutional3D(6, 8, 8, 3)),
    "Cropping3D": (lambda: L.Cropping3D(), IT.convolutional3D(6, 8, 8, 3)),
    "Upsampling3D": (lambda: L.Upsampling3D(),
                     IT.convolutional3D(6, 8, 8, 3)),
    "Upsampling1D": (lambda: L.Upsampling1D(), IT.recurrent(4, 6)),
    "ZeroPadding1DLayer": (lambda: L.ZeroPadding1DLayer(),
                           IT.recurrent(4, 6)),
    "Cropping1D": (lambda: L.Cropping1D(), IT.recurrent(4, 6)),
    "MaskZeroLayer": (lambda: L.MaskZeroLayer(), IT.recurrent(4, 6)),
    "GaussianNoiseLayer": (lambda: L.GaussianNoiseLayer(), IT.feedForward(4)),
    "GaussianDropoutLayer": (lambda: L.GaussianDropoutLayer(),
                             IT.feedForward(4)),
    "AlphaDropoutLayer": (lambda: L.AlphaDropoutLayer(), IT.feedForward(4)),
    "TimeDistributed": (lambda: L.TimeDistributed(L.DenseLayer(nOut=5)),
                        IT.recurrent(4, 6)),
    "SameDiffLayer": (lambda: _Fragment(nOut=5), IT.feedForward(4)),
}


def _layer_classes():
    out, stack = set(), [t_layers.Layer]
    while stack:
        for sub in stack.pop().__subclasses__():
            stack.append(sub)
            if sub.__module__ == t_layers.__name__ \
                    and not sub.__name__.startswith("_") \
                    and sub.__name__ != "BaseOutputLayer":
                out.add(sub.__name__)
    return out


def test_every_layer_class_has_a_param_shapes_case():
    assert _layer_classes() == set(LAYER_CASES)
    assert len(LAYER_CASES) == 53


@pytest.mark.parametrize("name", sorted(LAYER_CASES))
def test_param_shapes_equal_what_initialize_makes(name):
    make, it = LAYER_CASES[name]
    layer = make()
    declared_nin = layer.nIn
    layer.set_defaults(types.SimpleNamespace(activation="identity",
                                             weight_init="xavier", l1=None,
                                             l2=None))
    layer.infer_nin(it)
    declared = layer.param_shapes()
    params, _ = layer.initialize(torch.Generator().manual_seed(0))
    assert declared == {k: tuple(v.shape) for k, v in params.items()}
    assert bool(declared) == layer.has_params or name == "SelfAttentionLayer"
    lanes = layer.gemm_lane_dims()
    assert all(isinstance(d, int) and d > 0 for d in lanes)
    if declared_nin is None:        # embeddings declare their vocabulary
        assert layer.expected_nin(it) == layer.nIn


# ------------------------------------------------------------ entry points
def test_strict_init_raises_before_any_parameter_exists():
    P = TORCH
    conf = (_builder(P).list()
            .layer(P.L.DenseLayer(nIn=300, nOut=16))
            .layer(P.L.OutputLayer(nOut=4))
            .setInputType(P.InputType.feedForward(128)).build())
    net = P.MLN(conf)
    with pytest.raises(ta.ModelValidationError) as ei:
        net.init(strict=True, device="cpu")
    assert "DL4J-E001" in str(ei.value)
    assert net._params == [] and not net._initialized
    assert net._device is None
    g = (_graph_builder(P)
         .addLayer("fc", P.L.DenseLayer(nOut=8), "in")
         .addLayer("out", P.L.DenseLayer(nOut=2), "fc")
         .setOutputs("out"))
    cg = P.CG(g.build())
    with pytest.raises(ta.ModelValidationError):
        cg.init(strict=True, device="cpu")
    assert cg._params == {} and not cg._initialized


def test_strict_init_passes_a_clean_model_and_validate_makes_no_tensor():
    net = TORCH.MLN(_mlp_conf(TORCH))
    assert net.validate().ok(warnings_as_errors=True)
    assert not net._initialized and net._params == []
    net.init(strict=True, device="cpu")
    assert net._initialized


def test_samediff_infer_shapes_and_summary_match_the_jax_package():
    j, t = _sd_mlp(JAX), _sd_mlp(TORCH)
    assert t.infer_shapes(batch_size=5) == j.infer_shapes(batch_size=5)
    assert t.infer_shapes(batch_size=5)["z"] == (5, 2)
    assert t.summary(5) == j.summary(5)
    assert t.validate().subject == "SameDiff"


def test_serving_lint_matches_the_jax_package():
    from deeplearning4j_tpu.analysis.serving import lint_serving as j_lint
    from deeplearning4j_tpu_torch.analysis.serving import \
        lint_serving as t_lint
    for kw in ({"buckets": [1, 2, 4, 4]},
               {"buckets": list(range(1, 11))},
               {"buckets": [1, 2, 4], "hbm_gb": 1e-7, "shapes": [(4,)]},
               {"buckets": [2, 6], "mesh": "data=4"}):
        j = j_lint(_mlp_conf(JAX), **kw)
        t = t_lint(_mlp_conf(TORCH), **kw)
        assert _facts(t) == _facts(j) and t.codes(), kw


def test_model_server_validate():
    from deeplearning4j_tpu_torch.serving.server import ModelServer
    net = TORCH.MLN(_mlp_conf(TORCH)).init(device="cpu")
    srv = ModelServer(net, device="cpu", batch_limit=512)
    try:
        rep = srv.validate(shapes=[(4,)])
        assert rep.codes() == ["DL4J-W110"]          # 10 buckets > 8
        assert "DL4J-E111" in srv.validate(shapes=[(4,)],
                                           hbm_gb=1e-6).codes()
        tiny = {"name": "tiny", "peak_flops": 1e12, "hbm_gb": 1e-6,
                "hbm_gbps": 10.0, "ici_gbps": 1.0}
        codes = set(srv.validate(cost={"chip": tiny}).codes())
        assert "DL4J-E121" in codes
        assert codes <= {"DL4J-W110", "DL4J-E121", "DL4J-E122"}
        assert not {"DL4J-E111", "DL4J-E121", "DL4J-E122"} & set(
            srv.validate(cost="h100-sxm").codes())
    finally:
        srv.close()


def _jax_init_shapes(layer):
    import jax
    params, _ = layer.initialize(jax.random.PRNGKey(0))

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            else:
                out[prefix + k] = tuple(v.shape)
        return out
    return flat(params)


class _JFragment(j_layers.SameDiffLayer):
    def defineParameters(self):
        return {"W": (self.nIn, self.nOut), "b": (1, self.nOut)}


@pytest.mark.parametrize("name", ["LearnedSelfAttentionLayer",
                                  "RecurrentAttentionLayer", "LastTimeStep",
                                  "SameDiffLayer"])
def test_param_shapes_follow_initialize_where_the_jax_hooks_do_not(name):
    """A JAX-side finding: these JAX ``param_shapes()`` leave out or
    misshape params their ``initialize`` makes (``Q``; ``R`` and ``Wq``;
    the wrapped LSTM's gates; the fragment's declared shapes), so the
    JAX cost and FLOP estimates miscount them. The port's hooks equal
    what both packages' ``initialize`` make."""
    def make(P):
        L_ = P.L
        return {"SameDiffLayer": lambda: (
                    (_JFragment if P is JAX else _Fragment)(nOut=5),
                    P.InputType.feedForward(4)),
                "LearnedSelfAttentionLayer": lambda: (
                    L_.LearnedSelfAttentionLayer(nOut=8, nHeads=2,
                                                 headSize=4, nQueries=3),
                    P.InputType.recurrent(4, 6)),
                "RecurrentAttentionLayer": lambda: (
                    L_.RecurrentAttentionLayer(nOut=5),
                    P.InputType.recurrent(4, 6)),
                "LastTimeStep": lambda: (L_.LastTimeStep(L_.LSTM(nOut=5)),
                                         P.InputType.recurrent(4, 6))}[name]()
    base = types.SimpleNamespace(activation="identity", weight_init="xavier",
                                 l1=None, l2=None)
    layers = {}
    for P in (JAX, TORCH):
        layer, it = make(P)
        layer.set_defaults(base)
        layer.infer_nin(it)
        layers[P is JAX] = layer
    j, t = layers[True], layers[False]
    j_init = _jax_init_shapes(j)
    assert {k: tuple(v) for k, v in j.param_shapes().items()} != j_init
    assert t.param_shapes() == j_init
