"""Model zoo (the slice's subset of ``deeplearning4j_tpu/models/zoo.py``):
``ZooModel``, ``LeNet``, ``SimpleCNN``, ``VGG16``, ``VGG19``,
``Darknet19`` and ``TinyYOLO`` (``MultiLayerNetwork``s) and ``ResNet50``
(a ``ComputationGraph``), with the JAX package's node names, layer order
and defaults, so its params transplant one to one. Not ported yet:
AlexNet (it needs LocalResponseNormalization) and the other zoo models
(ROADMAP.md)."""

from __future__ import annotations

from typing import Tuple

from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import (ComputationGraph,
                                               ElementWiseVertex)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.objdetect import Yolo2OutputLayer
from deeplearning4j_tpu_torch.nn.layers import (ActivationLayer,
                                                BatchNormalization,
                                                ConvolutionLayer, DenseLayer,
                                                DropoutLayer,
                                                GlobalPoolingLayer,
                                                OutputLayer, SubsamplingLayer)
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
        stages = [(3, 64, 256, 1), (4, 128, 512, 2), (6, 256, 1024, 2),
                  (3, 512, 2048, 2)]
        for si, (blocks, mid, out, first_stride) in enumerate(stages):
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
