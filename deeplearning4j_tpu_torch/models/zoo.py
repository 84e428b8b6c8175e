"""Model zoo: every model of ``deeplearning4j_tpu/models/zoo.py`` —
LeNet, SimpleCNN, AlexNet, VGG16, VGG19, Darknet19, TinyYOLO and the
char-RNN TextGenerationLSTM (``MultiLayerNetwork``s), ResNet50,
SqueezeNet, UNet, Xception, FaceNetNN4Small2, YOLO2, InceptionResNetV1
and NASNet (``ComputationGraph``s) — with the JAX package's node names,
layer order and defaults, so its params transplant one to one — and
``ZooModel.initPretrained``, which loads a local archive or Keras
``.h5`` (there is no download)."""

from __future__ import annotations

import os
from typing import Tuple

from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import (ComputationGraph,
                                               ElementWiseVertex,
                                               L2NormalizeVertex, MergeVertex,
                                               PreprocessorVertex,
                                               ScaleVertex)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.objdetect import Yolo2OutputLayer
from deeplearning4j_tpu_torch.nn.layers import (ActivationLayer,
                                                BatchNormalization,
                                                ConvolutionLayer, DenseLayer,
                                                DropoutLayer,
                                                GlobalPoolingLayer,
                                                LocalResponseNormalization,
                                                LossLayer, LSTM, OutputLayer,
                                                RnnOutputLayer,
                                                SeparableConvolution2D,
                                                SubsamplingLayer,
                                                Upsampling2D)
from deeplearning4j_tpu_torch.nn.preprocessors import SpaceToDepth
from deeplearning4j_tpu_torch.train import updaters


class ZooModel:
    """Base (ref: org.deeplearning4j.zoo.ZooModel)."""

    def __init__(self, num_classes: int = 1000, seed: int = 123,
                 input_shape: Tuple[int, int, int] = None, updater=None,
                 dtype: str = "float32"):
        self.num_classes = num_classes
        self.seed = seed
        self.input_shape = input_shape or self.default_input_shape()
        self.updater = updater or updaters.Adam(1e-3)
        self.dtype = dtype  # "bfloat16" enables the mixed-precision policy

    def default_input_shape(self):
        return (3, 224, 224)  # (channels, H, W)

    def init(self, device=None):
        """The initialized network on ``device``: the card unless the
        caller names another (``device="cpu"``)."""
        net = self.conf_builder()
        net.conf.base.dtype = self.dtype
        net.init(device=device)
        return net

    def conf_builder(self):
        raise NotImplementedError

    def initPretrained(self, pretrained_type: str = "IMAGENET",
                       path: str = None, device=None):
        """ref: ZooModel.initPretrained — the reference downloads a
        checksummed file; here it loads a local one onto ``device`` (the
        card unless the caller names another): ``path``, or
        ``$DL4J_TPU_DATA_DIR/pretrained/<model>_<type>.zip|.h5``. A zip
        is the JAX package's model archive; a ``.h5``/``.hdf5``/
        ``.keras`` file is a Keras full-model save, imported through
        ``modelimport.keras``."""
        if path is None:
            base = os.path.join(
                os.environ.get("DL4J_TPU_DATA_DIR",
                               os.path.expanduser("~/.deeplearning4j_tpu")),
                "pretrained",
                f"{type(self).__name__.lower()}_{pretrained_type.lower()}")
            for cand in (base + ".zip", base + ".h5"):
                if os.path.exists(cand):
                    path = cand
                    break
            if path is None:
                raise FileNotFoundError(
                    f"pretrained weights not found at {base}.zip|.h5 (no "
                    f"network egress; place the checkpoint there manually)")
        if not os.path.exists(path):
            raise FileNotFoundError(path)
        if path.endswith((".h5", ".hdf5", ".keras")):
            from deeplearning4j_tpu_torch.modelimport.keras import \
                KerasModelImport
            return KerasModelImport.importKerasModelAndWeights(path, device)
        try:
            return MultiLayerNetwork.load(path, device=device)
        except Exception:
            return ComputationGraph.load(path, device=device)


class LeNet(ZooModel):
    """ref: zoo.model.LeNet — the canonical MNIST configuration: flat
    [N, 784] rows in (``InputType.convolutionalFlat``)."""

    def default_input_shape(self):
        return (1, 28, 28)

    def conf_builder(self) -> MultiLayerNetwork:
        c, h, w = self.input_shape
        conf = (NeuralNetConfiguration.Builder()
                .seed(self.seed).updater(self.updater).weightInit("xavier")
                .list()
                .layer(ConvolutionLayer(kernelSize=(5, 5), stride=(1, 1),
                                        nOut=20, activation="identity"))
                .layer(SubsamplingLayer(poolingType="max", kernelSize=(2, 2),
                                        stride=(2, 2)))
                .layer(ConvolutionLayer(kernelSize=(5, 5), stride=(1, 1),
                                        nOut=50, activation="identity"))
                .layer(SubsamplingLayer(poolingType="max", kernelSize=(2, 2),
                                        stride=(2, 2)))
                .layer(DenseLayer(nOut=500, activation="relu"))
                .layer(OutputLayer(nOut=self.num_classes,
                                   lossFunction="mcxent",
                                   activation="softmax"))
                .setInputType(InputType.convolutionalFlat(h, w, c))
                .build())
        return MultiLayerNetwork(conf)


class SimpleCNN(ZooModel):
    """ref: zoo.model.SimpleCNN — six conv-BN-relu blocks, a global
    average pool and a dropout before the classifier."""

    def default_input_shape(self):
        return (3, 48, 48)

    def conf_builder(self) -> MultiLayerNetwork:
        c, h, w = self.input_shape
        b = (NeuralNetConfiguration.Builder()
             .seed(self.seed).updater(self.updater).weightInit("relu")
             .list())
        for n_out in (16, 16, 32, 32, 64, 64):
            b = b.layer(ConvolutionLayer(kernelSize=(3, 3), nOut=n_out,
                                         padding=(1, 1),
                                         activation="identity"))
            b = b.layer(BatchNormalization())
            b = b.layer(ActivationLayer("relu"))
            if n_out in (16, 32):
                b = b.layer(SubsamplingLayer(poolingType="max",
                                             kernelSize=(2, 2), stride=(2, 2)))
        b = (b.layer(GlobalPoolingLayer("avg"))
             .layer(DropoutLayer(dropOut=0.5))
             .layer(OutputLayer(nOut=self.num_classes, lossFunction="mcxent",
                                activation="softmax"))
             .setInputType(InputType.convolutional(h, w, c)))
        return MultiLayerNetwork(b.build())


class AlexNet(ZooModel):
    """ref: zoo.model.AlexNet (the one-tower variant with LRN after the
    first two convs)."""

    def conf_builder(self) -> MultiLayerNetwork:
        c, h, w = self.input_shape
        conf = (NeuralNetConfiguration.Builder()
                .seed(self.seed).updater(self.updater).weightInit("relu")
                .list()
                .layer(ConvolutionLayer(kernelSize=(11, 11), stride=(4, 4),
                                        padding=(3, 3), nOut=96,
                                        activation="relu"))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(poolingType="max", kernelSize=(3, 3),
                                        stride=(2, 2)))
                .layer(ConvolutionLayer(kernelSize=(5, 5), padding=(2, 2),
                                        nOut=256, activation="relu"))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(poolingType="max", kernelSize=(3, 3),
                                        stride=(2, 2)))
                .layer(ConvolutionLayer(kernelSize=(3, 3), padding=(1, 1),
                                        nOut=384, activation="relu"))
                .layer(ConvolutionLayer(kernelSize=(3, 3), padding=(1, 1),
                                        nOut=384, activation="relu"))
                .layer(ConvolutionLayer(kernelSize=(3, 3), padding=(1, 1),
                                        nOut=256, activation="relu"))
                .layer(SubsamplingLayer(poolingType="max", kernelSize=(3, 3),
                                        stride=(2, 2)))
                .layer(DenseLayer(nOut=4096, activation="relu", dropOut=0.5))
                .layer(DenseLayer(nOut=4096, activation="relu", dropOut=0.5))
                .layer(OutputLayer(nOut=self.num_classes,
                                   lossFunction="mcxent",
                                   activation="softmax"))
                .setInputType(InputType.convolutional(h, w, c))
                .build())
        return MultiLayerNetwork(conf)


def _vgg_blocks(b, plan):
    """``(n_convs, n_out)`` blocks of 3x3 relu convs, each closed by a 2x2
    max pool."""
    for n_convs, n_out in plan:
        for _ in range(n_convs):
            b = b.layer(ConvolutionLayer(kernelSize=(3, 3), padding=(1, 1),
                                         nOut=n_out, activation="relu"))
        b = b.layer(SubsamplingLayer(poolingType="max", kernelSize=(2, 2),
                                     stride=(2, 2)))
    return b


class VGG16(ZooModel):
    """ref: zoo.model.VGG16 — 13 convs in five blocks, then two
    ``DenseLayer(4096, dropOut=0.5)`` (a retain probability) and the
    classifier."""

    PLAN = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]

    def conf_builder(self) -> MultiLayerNetwork:
        c, h, w = self.input_shape
        b = (NeuralNetConfiguration.Builder()
             .seed(self.seed).updater(self.updater).weightInit("relu")
             .list())
        b = _vgg_blocks(b, self.PLAN)
        b = (b.layer(DenseLayer(nOut=4096, activation="relu", dropOut=0.5))
             .layer(DenseLayer(nOut=4096, activation="relu", dropOut=0.5))
             .layer(OutputLayer(nOut=self.num_classes, lossFunction="mcxent",
                                activation="softmax"))
             .setInputType(InputType.convolutional(h, w, c)))
        return MultiLayerNetwork(b.build())


class VGG19(VGG16):
    """ref: zoo.model.VGG19."""

    PLAN = [(2, 64), (2, 128), (4, 256), (4, 512), (4, 512)]


class ResNet50(ZooModel):
    """ref: zoo.model.ResNet50 — bottleneck residual blocks as a
    ComputationGraph with ElementWiseVertex adds."""

    #: ``(blocks, mid, out, first stride)`` of the four stages
    STAGES = ((3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 2),
              (3, 512, 2048, 2))

    def conf_builder(self) -> ComputationGraph:
        c, h, w = self.input_shape
        g = (NeuralNetConfiguration.Builder()
             .seed(self.seed).updater(self.updater).weightInit("relu")
             .graphBuilder()
             .addInputs("input")
             .setInputTypes(InputType.convolutional(h, w, c)))

        # stem
        g.addLayer("stem_conv", ConvolutionLayer(kernelSize=(7, 7),
                                                 stride=(2, 2),
                                                 padding=(3, 3), nOut=64,
                                                 activation="identity"),
                   "input")
        g.addLayer("stem_bn", BatchNormalization(), "stem_conv")
        g.addLayer("stem_relu", ActivationLayer("relu"), "stem_bn")
        g.addLayer("stem_pool", SubsamplingLayer(poolingType="max",
                                                 kernelSize=(3, 3),
                                                 stride=(2, 2),
                                                 padding=(1, 1)), "stem_relu")
        last = "stem_pool"
        for si, (blocks, mid, out, first_stride) in enumerate(self.STAGES):
            for bi in range(blocks):
                stride = first_stride if bi == 0 else 1
                pref = f"s{si}b{bi}"
                # main path: 1x1 -> 3x3 -> 1x1 with BN
                g.addLayer(f"{pref}_c1",
                           ConvolutionLayer(kernelSize=(1, 1),
                                            stride=(stride, stride),
                                            nOut=mid, activation="identity"),
                           last)
                g.addLayer(f"{pref}_bn1", BatchNormalization(), f"{pref}_c1")
                g.addLayer(f"{pref}_r1", ActivationLayer("relu"),
                           f"{pref}_bn1")
                g.addLayer(f"{pref}_c2",
                           ConvolutionLayer(kernelSize=(3, 3), padding=(1, 1),
                                            nOut=mid, activation="identity"),
                           f"{pref}_r1")
                g.addLayer(f"{pref}_bn2", BatchNormalization(), f"{pref}_c2")
                g.addLayer(f"{pref}_r2", ActivationLayer("relu"),
                           f"{pref}_bn2")
                g.addLayer(f"{pref}_c3",
                           ConvolutionLayer(kernelSize=(1, 1), nOut=out,
                                            activation="identity"),
                           f"{pref}_r2")
                g.addLayer(f"{pref}_bn3", BatchNormalization(), f"{pref}_c3")
                # shortcut
                if bi == 0:
                    g.addLayer(f"{pref}_sc",
                               ConvolutionLayer(kernelSize=(1, 1),
                                                stride=(stride, stride),
                                                nOut=out,
                                                activation="identity"),
                               last)
                    g.addLayer(f"{pref}_scbn", BatchNormalization(),
                               f"{pref}_sc")
                    shortcut = f"{pref}_scbn"
                else:
                    shortcut = last
                g.addVertex(f"{pref}_add", ElementWiseVertex("Add"),
                            f"{pref}_bn3", shortcut)
                g.addLayer(f"{pref}_out", ActivationLayer("relu"),
                           f"{pref}_add")
                last = f"{pref}_out"
        g.addLayer("avgpool", GlobalPoolingLayer("avg"), last)
        g.addLayer("fc", OutputLayer(nOut=self.num_classes,
                                     lossFunction="mcxent",
                                     activation="softmax"), "avgpool")
        g.setOutputs("fc")
        return ComputationGraph(g.build())


class Darknet19(ZooModel):
    """ref: zoo.model.Darknet19 (the YOLOv2 backbone): 18 conv-BN-leaky
    blocks, a 1x1 conv to the classes, a global average pool and the
    classifier."""

    def conf_builder(self) -> MultiLayerNetwork:
        c, h, w = self.input_shape
        b = (NeuralNetConfiguration.Builder()
             .seed(self.seed).updater(self.updater).weightInit("relu")
             .list())

        def conv_bn(b, n_out, k):
            b = b.layer(ConvolutionLayer(kernelSize=(k, k),
                                         padding=(k // 2, k // 2),
                                         nOut=n_out, activation="identity"))
            b = b.layer(BatchNormalization())
            return b.layer(ActivationLayer("leakyrelu"))

        def maxpool(b):
            return b.layer(SubsamplingLayer(poolingType="max",
                                            kernelSize=(2, 2), stride=(2, 2)))

        b = maxpool(conv_bn(b, 32, 3))
        b = maxpool(conv_bn(b, 64, 3))
        for big, small in ((128, 64), (256, 128)):
            b = conv_bn(conv_bn(conv_bn(b, big, 3), small, 1), big, 3)
            b = maxpool(b)
        for big, small in ((512, 256), (1024, 512)):
            for n_out, k in ((big, 3), (small, 1), (big, 3), (small, 1),
                             (big, 3)):
                b = conv_bn(b, n_out, k)
            if big == 512:
                b = maxpool(b)
        b = b.layer(ConvolutionLayer(kernelSize=(1, 1), nOut=self.num_classes,
                                     activation="identity"))
        b = (b.layer(GlobalPoolingLayer("avg"))
             .layer(OutputLayer(nOut=self.num_classes, lossFunction="mcxent",
                                activation="softmax"))
             .setInputType(InputType.convolutional(h, w, c)))
        return MultiLayerNetwork(b.build())


class TextGenerationLSTM(ZooModel):
    """ref: zoo.model.TextGenerationLSTM — the char-RNN of dl4j-examples'
    LSTMCharModellingExample: two LSTM(256) over one-hot characters
    [N, vocab, T] and an RnnOutputLayer (softmax, mcxent); xavier, Adam
    1e-3, gradients clipped element-wise at 5.0."""

    def __init__(self, vocab_size: int = 77, **kw):
        self.vocab_size = vocab_size
        super().__init__(num_classes=vocab_size, **kw)

    def default_input_shape(self):
        return (self.vocab_size, 60)

    def conf_builder(self) -> MultiLayerNetwork:
        n_in, t = self.input_shape
        conf = (NeuralNetConfiguration.Builder()
                .seed(self.seed).updater(self.updater).weightInit("xavier")
                .gradientNormalization("clip_value", 5.0)
                .list()
                .layer(LSTM(nOut=256))
                .layer(LSTM(nOut=256))
                .layer(RnnOutputLayer(nOut=self.vocab_size,
                                      lossFunction="mcxent",
                                      activation="softmax"))
                .setInputType(InputType.recurrent(n_in, t))
                .build())
        return MultiLayerNetwork(conf)


class TinyYOLO(ZooModel):
    """ref: zoo.model.TinyYOLO — the darknet-tiny backbone (six conv-BN-
    leaky blocks with max pools, the sixth pool 2x2 stride 1 in same
    mode, two 1024-channel blocks) and a ``Yolo2OutputLayer`` with the
    reference's VOC anchor priors, as a ``MultiLayerNetwork``."""

    ANCHORS = [[1.08, 1.19], [3.42, 4.41], [6.63, 11.38], [9.42, 5.11],
               [16.62, 10.52]]

    def __init__(self, num_classes: int = 20, **kw):
        super().__init__(num_classes=num_classes, **kw)

    def default_input_shape(self):
        return (3, 416, 416)

    def conf_builder(self) -> MultiLayerNetwork:
        c, h, w = self.input_shape
        n_boxes = len(self.ANCHORS)
        b = (NeuralNetConfiguration.Builder()
             .seed(self.seed).updater(self.updater).weightInit("relu")
             .list())

        def conv_bn(b, n_out):
            b = b.layer(ConvolutionLayer(kernelSize=(3, 3), padding=(1, 1),
                                         nOut=n_out, activation="identity"))
            b = b.layer(BatchNormalization())
            return b.layer(ActivationLayer("leakyrelu"))

        for n_out in (16, 32, 64, 128, 256):
            b = conv_bn(b, n_out)
            b = b.layer(SubsamplingLayer(poolingType="max", kernelSize=(2, 2),
                                         stride=(2, 2)))
        b = conv_bn(b, 512)
        b = b.layer(SubsamplingLayer(poolingType="max", kernelSize=(2, 2),
                                     stride=(1, 1), padding=(1, 1),
                                     convolutionMode="same"))
        b = conv_bn(b, 1024)
        b = conv_bn(b, 1024)
        b = b.layer(ConvolutionLayer(kernelSize=(1, 1),
                                     nOut=n_boxes * (5 + self.num_classes),
                                     activation="identity"))
        b = (b.layer(Yolo2OutputLayer(boundingBoxPriors=self.ANCHORS))
             .setInputType(InputType.convolutional(h, w, c)))
        return MultiLayerNetwork(b.build())


def _graph(model, c, h, w):
    """A graph builder on the zoo's defaults with one input ``input``."""
    return (NeuralNetConfiguration.Builder()
            .seed(model.seed).updater(model.updater).weightInit("relu")
            .graphBuilder()
            .addInputs("input")
            .setInputTypes(InputType.convolutional(h, w, c)))


def _conv(k, n_out, stride=1, pad=0, activation="relu"):
    return ConvolutionLayer(kernelSize=(k, k), stride=(stride, stride),
                            padding=(pad, pad), nOut=n_out,
                            activation=activation)


def _sep(k, n_out, pad, stride=1, activation="relu"):
    return SeparableConvolution2D(kernelSize=(k, k), stride=(stride, stride),
                                  padding=(pad, pad), nOut=n_out,
                                  activation=activation)


def _maxpool(k, stride, pad=0):
    return SubsamplingLayer(poolingType="max", kernelSize=(k, k),
                            stride=(stride, stride), padding=(pad, pad))


def _classifier(g, inp, n_classes):
    g.addLayer("gap", GlobalPoolingLayer("avg"), inp)
    g.addLayer("out", OutputLayer(nOut=n_classes, lossFunction="mcxent",
                                  activation="softmax"), "gap")
    g.setOutputs("out")


class SqueezeNet(ZooModel):
    """ref: zoo.model.SqueezeNet — fire modules (1x1 squeeze, 1x1 and 3x3
    expands merged)."""

    def conf_builder(self) -> ComputationGraph:
        g = _graph(self, *self.input_shape)
        g.addLayer("stem", _conv(3, 64, stride=2), "input")
        g.addLayer("pool0", _maxpool(3, 2), "stem")

        def fire(name, inp, squeeze, expand):
            g.addLayer(f"{name}_sq", _conv(1, squeeze), inp)
            g.addLayer(f"{name}_e1", _conv(1, expand), f"{name}_sq")
            g.addLayer(f"{name}_e3", _conv(3, expand, pad=1), f"{name}_sq")
            g.addVertex(f"{name}_cat", MergeVertex(), f"{name}_e1",
                        f"{name}_e3")
            return f"{name}_cat"

        last = fire("fire2", "pool0", 16, 64)
        last = fire("fire3", last, 16, 64)
        g.addLayer("pool3", _maxpool(3, 2), last)
        last = fire("fire4", "pool3", 32, 128)
        last = fire("fire5", last, 32, 128)
        g.addLayer("pool5", _maxpool(3, 2), last)
        last = fire("fire6", "pool5", 48, 192)
        last = fire("fire7", last, 48, 192)
        last = fire("fire8", last, 64, 256)
        last = fire("fire9", last, 64, 256)
        g.addLayer("drop", DropoutLayer(dropOut=0.5), last)
        g.addLayer("conv10", _conv(1, self.num_classes), "drop")
        _classifier(g, "conv10", self.num_classes)
        return ComputationGraph(g.build())


class UNet(ZooModel):
    """ref: zoo.model.UNet — a three-level encoder/decoder with skip
    merges; the output is a per-pixel sigmoid map under an ``xent``
    LossLayer."""

    def default_input_shape(self):
        return (3, 128, 128)

    def conf_builder(self) -> ComputationGraph:
        g = _graph(self, *self.input_shape)

        def double_conv(name, inp, n):
            g.addLayer(f"{name}_c1", _conv(3, n, pad=1), inp)
            g.addLayer(f"{name}_c2", _conv(3, n, pad=1), f"{name}_c1")
            return f"{name}_c2"

        enc_outs, last = [], "input"
        for i, n in enumerate([32, 64, 128]):
            last = double_conv(f"enc{i}", last, n)
            enc_outs.append(last)
            g.addLayer(f"pool{i}", _maxpool(2, 2), last)
            last = f"pool{i}"
        last = double_conv("bottom", last, 256)
        for i, n in zip(reversed(range(3)), [128, 64, 32]):
            g.addLayer(f"up{i}", Upsampling2D(size=2), last)
            g.addVertex(f"cat{i}", MergeVertex(), f"up{i}", enc_outs[i])
            last = double_conv(f"dec{i}", f"cat{i}", n)
        g.addLayer("head", _conv(1, 1, activation="sigmoid"), last)
        g.addLayer("out", LossLayer(lossFunction="xent",
                                    activation="identity"), "head")
        g.setOutputs("out")
        return ComputationGraph(g.build())


class Xception(ZooModel):
    """ref: zoo.model.Xception — separable-conv stacks with residual adds
    (the JAX zoo's middle flow of 4 blocks)."""

    def conf_builder(self) -> ComputationGraph:
        g = _graph(self, *self.input_shape)
        g.addLayer("stem1", _conv(3, 32, stride=2), "input")
        g.addLayer("stem2", _conv(3, 64), "stem1")
        last = "stem2"
        for i, n in enumerate([128, 256, 728]):
            pref = f"entry{i}"
            g.addLayer(f"{pref}_s1", _sep(3, n, 1), last)
            g.addLayer(f"{pref}_s2", _sep(3, n, 1, activation="identity"),
                       f"{pref}_s1")
            g.addLayer(f"{pref}_pool", _maxpool(3, 2, 1), f"{pref}_s2")
            g.addLayer(f"{pref}_sc", _conv(1, n, stride=2,
                                           activation="identity"), last)
            g.addVertex(f"{pref}_add", ElementWiseVertex("Add"),
                        f"{pref}_pool", f"{pref}_sc")
            last = f"{pref}_add"
        for i in range(4):
            pref, cur = f"mid{i}", last
            for j in range(3):
                g.addLayer(f"{pref}_s{j}", _sep(3, 728, 1), cur)
                cur = f"{pref}_s{j}"
            g.addVertex(f"{pref}_add", ElementWiseVertex("Add"), cur, last)
            last = f"{pref}_add"
        g.addLayer("exit_s1", _sep(3, 1024, 1), last)
        g.addLayer("exit_s2", _sep(3, 1536, 1), "exit_s1")
        _classifier(g, "exit_s2", self.num_classes)
        return ComputationGraph(g.build())


class FaceNetNN4Small2(ZooModel):
    """ref: zoo.model.FaceNetNN4Small2 — an inception-style embedding net
    whose 128-wide embedding is L2-normalized before the classifier."""

    def default_input_shape(self):
        return (3, 96, 96)

    def conf_builder(self) -> ComputationGraph:
        g = _graph(self, *self.input_shape)
        g.addLayer("c1", _conv(7, 64, stride=2, pad=3), "input")
        g.addLayer("p1", _maxpool(3, 2, 1), "c1")
        g.addLayer("c2", _conv(1, 64), "p1")
        g.addLayer("c3", _conv(3, 192, pad=1), "c2")
        g.addLayer("p2", _maxpool(3, 2, 1), "c3")
        last = "p2"
        for i, (n1, n3r, n3) in enumerate([(64, 96, 128), (64, 96, 128),
                                           (128, 128, 256)]):
            pref = f"inc{i}"
            g.addLayer(f"{pref}_1", _conv(1, n1), last)
            g.addLayer(f"{pref}_3r", _conv(1, n3r), last)
            g.addLayer(f"{pref}_3", _conv(3, n3, pad=1), f"{pref}_3r")
            g.addVertex(f"{pref}_cat", MergeVertex(), f"{pref}_1",
                        f"{pref}_3")
            last = f"{pref}_cat"
        g.addLayer("gap", GlobalPoolingLayer("avg"), last)
        g.addLayer("embed", DenseLayer(nOut=128, activation="identity"),
                   "gap")
        g.addVertex("l2", L2NormalizeVertex(), "embed")
        g.addLayer("out", OutputLayer(nOut=self.num_classes,
                                      lossFunction="mcxent",
                                      activation="softmax"), "l2")
        g.setOutputs("out")
        return ComputationGraph(g.build())


class YOLO2(ZooModel):
    """ref: zoo.model.YOLO2 — the Darknet19 backbone as 21 conv-BN-leaky
    blocks, the passthrough route (s5e's 26x26x512 through space-to-depth
    to 13x13x2048, merged with det2) and a ``Yolo2OutputLayer`` with the
    COCO anchor priors."""

    ANCHORS = [[0.57273, 0.677385], [1.87446, 2.06253], [3.33843, 5.47434],
               [7.88282, 3.52778], [9.77052, 9.16828]]

    def __init__(self, num_classes: int = 80, **kw):
        super().__init__(num_classes=num_classes, **kw)

    def default_input_shape(self):
        return (3, 416, 416)

    def conf_builder(self) -> ComputationGraph:
        n_boxes = len(self.ANCHORS)
        g = _graph(self, *self.input_shape)

        def conv_bn(name, inp, n_out, k=3):
            g.addLayer(f"{name}_c", _conv(k, n_out, pad=k // 2,
                                          activation="identity"), inp)
            g.addLayer(f"{name}_bn", BatchNormalization(), f"{name}_c")
            g.addLayer(name, ActivationLayer("leakyrelu"), f"{name}_bn")
            return name

        last = conv_bn("c1", "input", 32)
        g.addLayer("p1", _maxpool(2, 2), last)
        last = conv_bn("c2", "p1", 64)
        g.addLayer("p2", _maxpool(2, 2), last)
        inp = "p2"
        for big, small, pool in [(128, 64, "p3"), (256, 128, "p4")]:
            a = conv_bn(f"{pool}a", inp, big)
            bmid = conv_bn(f"{pool}b", a, small, k=1)
            cend = conv_bn(f"{pool}c", bmid, big)
            g.addLayer(pool, _maxpool(2, 2), cend)
            inp = pool
        # stage 5 ends at 26x26 with 512 channels: the passthrough source
        last = "p4"
        for name, n_out, k in (("s5a", 512, 3), ("s5b", 256, 1),
                               ("s5c", 512, 3), ("s5d", 256, 1),
                               ("s5e", 512, 3)):
            last = conv_bn(name, last, n_out, k)
        route = last
        g.addLayer("p5", _maxpool(2, 2), route)
        last = "p5"
        for name, n_out, k in (("s6a", 1024, 3), ("s6b", 512, 1),
                               ("s6c", 1024, 3), ("s6d", 512, 1),
                               ("s6e", 1024, 3), ("det1", 1024, 3),
                               ("det2", 1024, 3)):
            last = conv_bn(name, last, n_out, k)
        g.addVertex("passthrough", PreprocessorVertex(SpaceToDepth(2)), route)
        g.addVertex("route_cat", MergeVertex(), "passthrough", last)
        last = conv_bn("head", "route_cat", 1024)
        g.addLayer("conv_out", _conv(1, n_boxes * (5 + self.num_classes),
                                     activation="identity"), last)
        g.addLayer("yolo", Yolo2OutputLayer(boundingBoxPriors=self.ANCHORS),
                   "conv_out")
        g.setOutputs("yolo")
        return ComputationGraph(g.build())


class InceptionResNetV1(ZooModel):
    """ref: zoo.model.InceptionResNetV1 (the FaceNet backbone) — the stem,
    residual inception blocks A/B/C scaled by a ScaleVertex (the JAX zoo's
    2/3/2 blocks) with reductions between, and an L2-normalized 128-wide
    embedding before the classifier."""

    def default_input_shape(self):
        return (3, 160, 160)

    def _scaled_residual(self, g, pref, inp, branches, n_out, scale):
        outs = []
        for bi, branch in enumerate(branches):
            cur = inp
            for li, (k, n, s, p) in enumerate(branch):
                g.addLayer(f"{pref}_b{bi}_c{li}", _conv(k, n, stride=s,
                                                        pad=p), cur)
                cur = f"{pref}_b{bi}_c{li}"
            outs.append(cur)
        g.addVertex(f"{pref}_cat", MergeVertex(), *outs)
        g.addLayer(f"{pref}_up", _conv(1, n_out, activation="identity"),
                   f"{pref}_cat")
        g.addVertex(f"{pref}_scale", ScaleVertex(scale), f"{pref}_up")
        g.addVertex(f"{pref}_add", ElementWiseVertex("Add"), inp,
                    f"{pref}_scale")
        g.addLayer(f"{pref}_out", ActivationLayer("relu"), f"{pref}_add")
        return f"{pref}_out"

    def _reduction(self, g, name, inp, n_out):
        g.addLayer(f"{name}_c", _conv(3, n_out, stride=2), inp)
        g.addLayer(f"{name}_p", _maxpool(3, 2), inp)
        g.addVertex(name, MergeVertex(), f"{name}_c", f"{name}_p")
        return name

    def conf_builder(self) -> ComputationGraph:
        g = _graph(self, *self.input_shape)
        g.addLayer("s1", _conv(3, 32, stride=2), "input")
        g.addLayer("s2", _conv(3, 32), "s1")
        g.addLayer("s3", _conv(3, 64, pad=1), "s2")
        g.addLayer("s_pool", _maxpool(3, 2), "s3")
        g.addLayer("s4", _conv(1, 80), "s_pool")
        g.addLayer("s5", _conv(3, 192), "s4")
        g.addLayer("s6", _conv(3, 256, stride=2), "s5")
        last = "s6"
        for i in range(2):
            last = self._scaled_residual(
                g, f"irA{i}", last,
                [[(1, 32, 1, 0)], [(1, 32, 1, 0), (3, 32, 1, 1)],
                 [(1, 32, 1, 0), (3, 32, 1, 1), (3, 32, 1, 1)]], 256, 0.17)
        last = self._reduction(g, "redA", last, 384)
        for i in range(3):
            last = self._scaled_residual(
                g, f"irB{i}", last,
                [[(1, 128, 1, 0)], [(1, 128, 1, 0), (7, 128, 1, 3)]], 640,
                0.10)
        last = self._reduction(g, "redB", last, 256)
        for i in range(2):
            last = self._scaled_residual(
                g, f"irC{i}", last,
                [[(1, 192, 1, 0)], [(1, 192, 1, 0), (3, 192, 1, 1)]], 896,
                0.20)
        g.addLayer("gap", GlobalPoolingLayer("avg"), last)
        g.addLayer("bottleneck", DenseLayer(nOut=128, activation="identity"),
                   "gap")
        g.addVertex("embeddings", L2NormalizeVertex(), "bottleneck")
        g.addLayer("out", OutputLayer(nOut=self.num_classes,
                                      lossFunction="mcxent",
                                      activation="softmax"), "embeddings")
        g.setOutputs("out")
        return ComputationGraph(g.build())


class NASNet(ZooModel):
    """ref: zoo.model.NASNet (NASNet-A mobile) as the JAX zoo simplifies
    it: normal cells of stacked separable convs with residual adds and
    reduction cells between 2/2/2 stages."""

    PENULTIMATE = 1056

    def _normal_cell(self, g, pref, inp, filters):
        g.addLayer(f"{pref}_adj", _conv(1, filters), inp)
        a = f"{pref}_adj"
        g.addLayer(f"{pref}_s1a", _sep(5, filters, 2), a)
        g.addLayer(f"{pref}_s1b", _sep(3, filters, 1, activation="identity"),
                   f"{pref}_s1a")
        g.addVertex(f"{pref}_add1", ElementWiseVertex("Add"), f"{pref}_s1b",
                    a)
        g.addLayer(f"{pref}_s2a", _sep(3, filters, 1), f"{pref}_add1")
        g.addVertex(f"{pref}_add2", ElementWiseVertex("Add"), f"{pref}_s2a",
                    f"{pref}_add1")
        g.addLayer(f"{pref}_out", ActivationLayer("relu"), f"{pref}_add2")
        return f"{pref}_out"

    def _reduction_cell(self, g, pref, inp, filters):
        g.addLayer(f"{pref}_s5", _sep(5, filters, 2, stride=2), inp)
        g.addLayer(f"{pref}_s7", _sep(7, filters, 3, stride=2), inp)
        g.addLayer(f"{pref}_mp", _maxpool(3, 2, 1), inp)
        g.addLayer(f"{pref}_mpc", _conv(1, filters), f"{pref}_mp")
        g.addVertex(f"{pref}_add", ElementWiseVertex("Add"), f"{pref}_s5",
                    f"{pref}_s7")
        g.addVertex(f"{pref}_cat", MergeVertex(), f"{pref}_add",
                    f"{pref}_mpc")
        return f"{pref}_cat"

    def conf_builder(self) -> ComputationGraph:
        g = _graph(self, *self.input_shape)
        g.addLayer("stem", _conv(3, 32, stride=2), "input")
        g.addLayer("stem_bn", BatchNormalization(), "stem")
        last, filters = "stem_bn", 44
        for stage in range(3):
            for i in range(2):
                last = self._normal_cell(g, f"n{stage}_{i}", last, filters)
            if stage < 2:
                last = self._reduction_cell(g, f"r{stage}", last,
                                            filters * 2)
                filters *= 2
        g.addLayer("head", _conv(1, self.PENULTIMATE), last)
        _classifier(g, "head", self.num_classes)
        return ComputationGraph(g.build())


#: Name -> class of every architecture of the JAX zoo (ref: the zoo's
#: selection by name)
ZOO_MODELS = {cls.__name__: cls for cls in
              (LeNet, SimpleCNN, AlexNet, VGG16, VGG19, ResNet50, Darknet19,
               SqueezeNet, UNet, Xception, FaceNetNN4Small2,
               TextGenerationLSTM, TinyYOLO, YOLO2, InceptionResNetV1,
               NASNet)}


def all_zoo_models():
    """[(name, uninitialized network)] for every ported architecture, with
    default constructors: configurations only, no parameters."""
    return [(name, cls().conf_builder()) for name, cls in ZOO_MODELS.items()]
