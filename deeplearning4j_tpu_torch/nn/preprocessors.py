"""Input preprocessors — layout adapters inserted between layers (the
port of ``deeplearning4j_tpu/nn/preprocessors.py``, and YOLO2's
space-to-depth).

ref: ``org.deeplearning4j.nn.conf.preprocessor.{FeedForwardToCnn,
CnnToFeedForward, RnnToFeedForward, FeedForwardToRnn, CnnToRnn}
PreProcessor`` and the automatic choice of one while input types
propagate (``preprocessor_for``). Each one works on the public NCHW
layout: the networks move an NHWC activation back to NCHW before it, so
a flatten reads ``[c, h, w]`` row-major, as the reference does.
"""

from __future__ import annotations

from typing import Optional

import torch

from deeplearning4j_tpu_torch.nn.config import InputType
from deeplearning4j_tpu_torch.ops.convolution import space_to_depth


class Preprocessor:
    def __call__(self, x):
        raise NotImplementedError

    def output_type(self, it: InputType) -> InputType:
        raise NotImplementedError


class FeedForwardToCnn(Preprocessor):
    """[N, c*h*w] -> [N, c, h, w] (ref: FeedForwardToCnnPreProcessor).
    The reference's flattened order is [c, h, w] row-major."""

    def __init__(self, height, width, channels):
        self.height, self.width, self.channels = height, width, channels

    def __call__(self, x):
        return torch.reshape(x, (x.shape[0], self.channels, self.height,
                                 self.width))

    def output_type(self, it: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width, self.channels)


class CnnToFeedForward(Preprocessor):
    """[N, c, *spatial] -> [N, c*prod(spatial)] (ref:
    CnnToFeedForwardPreProcessor)."""

    def __call__(self, x):
        return torch.reshape(x, (x.shape[0], -1))

    def output_type(self, it: InputType) -> InputType:
        return InputType.feedForward(it.arrayElementsPerExample())


class RnnToFeedForward(Preprocessor):
    """[N, size, T] -> [N*T, size] (ref: RnnToFeedForwardPreProcessor)."""

    def __call__(self, x):
        return torch.reshape(x.permute(0, 2, 1), (-1, x.shape[1]))

    def output_type(self, it: InputType) -> InputType:
        return InputType.feedForward(it.size)


class FeedForwardToRnn(Preprocessor):
    """[N*T, size] -> [N, size, T] (ref: FeedForwardToRnnPreProcessor);
    ``timesteps`` is the original sequence length."""

    def __init__(self, timesteps):
        self.timesteps = timesteps

    def __call__(self, x):
        n = x.shape[0] // self.timesteps
        return torch.reshape(x, (n, self.timesteps, x.shape[1])).permute(
            0, 2, 1)

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(it.size, self.timesteps)


class CnnToRnn(Preprocessor):
    """[N, c, h, w] -> [N, c*h, w as time] (ref: CnnToRnnPreProcessor)."""

    def __call__(self, x):
        n, c, h, w = x.shape
        return torch.reshape(x, (n, c * h, w))

    def output_type(self, it: InputType) -> InputType:
        return InputType.recurrent(it.channels * it.height, it.width)


class SpaceToDepth(Preprocessor):
    """[N, c, h, w] -> [N, c*b*b, h/b, w/b] (``ops.convolution.
    space_to_depth``, channels in (bh, bw, c) order): YOLO2's passthrough
    route, which the JAX zoo defines inside ``YOLO2.conf_builder``."""

    def __init__(self, block_size: int = 2):
        self.block_size = block_size

    def __call__(self, x):
        return space_to_depth(x, self.block_size)

    def output_type(self, it: InputType) -> InputType:
        b = self.block_size
        return InputType.convolutional(it.height // b, it.width // b,
                                       it.channels * b * b)


def preprocessor_for(input_type: InputType, layer) -> Optional[Preprocessor]:
    """The automatic choice (ref: each layer conf's
    getPreProcessorForInputType): None where the layer takes what flows
    in."""
    need = getattr(layer, "input_kind", None)
    if need is None or input_type.kind == need:
        return None
    if input_type.kind == "cnn_flat" and need == "cnn":
        return FeedForwardToCnn(input_type.height, input_type.width,
                                input_type.channels)
    if input_type.kind == "cnn_flat" and need == "ff":
        return None  # already flat rows
    if input_type.kind == "cnn" and need == "ff":
        return CnnToFeedForward()
    if input_type.kind == "cnn3d" and need == "ff":
        return CnnToFeedForward()  # the flatten works for any spatial rank
    if input_type.kind == "ff" and need == "cnn":
        raise ValueError("feedForward input into a conv layer needs explicit "
                         "InputType.convolutionalFlat(...)")
    if input_type.kind == "rnn" and need == "ff":
        return RnnToFeedForward()
    if input_type.kind == "cnn" and need == "rnn":
        return CnnToRnn()
    return None
