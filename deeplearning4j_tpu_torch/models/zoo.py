"""Model zoo (the slice's subset of ``deeplearning4j_tpu/models/zoo.py``):
``ZooModel`` and ``ResNet50``, with the JAX package's node names and
topological order, so its params transplant one to one."""

from __future__ import annotations

from typing import Tuple

from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import (ComputationGraph,
                                               ElementWiseVertex)
from deeplearning4j_tpu_torch.nn.layers import (ActivationLayer,
                                                BatchNormalization,
                                                ConvolutionLayer,
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
