"""Transfer learning: freeze and replace layers of a pretrained network —
the port of ``deeplearning4j_tpu/nn/transfer.py``.

Reference parity: ``org.deeplearning4j.nn.transferlearning.{
TransferLearning, TransferLearningHelper, FineTuneConfiguration}``.

Freezing is a property of the train step (``nn.network``): a frozen
layer's params and updater state keep their values in every step, eager
or captured, while its gradients still flow to the layers before it and
still enter gradient normalization, and it still runs in train mode (its
BN running statistics move in ``fit``), as in the JAX step. The frozen
set is part of the step's cache key, so a network captured before a
freeze takes a new dispatch after it.

The new network's params and states are **clones** of the source's: the
port updates params in place, so an alias would train the source network
too (the JAX package copies for its own reason: its step donates the
buffers). :class:`TransferLearningHelper` runs the frozen prefix once per
dataset (``featurize``) and trains a network of the unfrozen layers alone
(``fitFeaturized``).
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


def _clone_param(t):
    return t.detach().clone().requires_grad_(True)


def _clone_state(t):
    return t.detach().clone()


class FineTuneConfiguration:
    """ref: FineTuneConfiguration — overrides applied to all layers."""

    def __init__(self, updater=None, l1: float = None, l2: float = None,
                 seed: int = None):
        self.updater = updater
        self.l1 = l1
        self.l2 = l2
        self.seed = seed

    class Builder:
        def __init__(self):
            self._kw = {}

        def updater(self, u):
            self._kw["updater"] = u
            return self

        def l1(self, v):
            self._kw["l1"] = v
            return self

        def l2(self, v):
            self._kw["l2"] = v
            return self

        def seed(self, s):
            self._kw["seed"] = s
            return self

        def build(self):
            return FineTuneConfiguration(**self._kw)


class TransferLearning:
    """ref: TransferLearning.Builder for MultiLayerNetwork."""

    class Builder:
        def __init__(self, net: MultiLayerNetwork):
            self.net = net
            self._ftc: Optional[FineTuneConfiguration] = None
            self._freeze_until: Optional[int] = None
            self._n_removed = 0
            self._added = []
            self._nout_replaced = {}

        def fineTuneConfiguration(self, ftc: FineTuneConfiguration):
            self._ftc = ftc
            return self

        def setFeatureExtractor(self, layer_idx: int):
            """Freeze layers [0..layer_idx] inclusive (ref semantics)."""
            self._freeze_until = layer_idx
            return self

        def removeOutputLayer(self):
            self._n_removed += 1
            return self

        def removeLayersFromOutput(self, n: int):
            self._n_removed += n
            return self

        def addLayer(self, layer):
            self._added.append(layer)
            return self

        def nOutReplace(self, layer_idx: int, n_out: int,
                        weight_init="xavier"):
            """Replace layer_idx's nOut (and re-init it and the next
            layer's nIn) — ref: nOutReplace."""
            self._nout_replaced[layer_idx] = (n_out, weight_init)
            return self

        def build(self) -> MultiLayerNetwork:
            """The new network on the source's device: the retained
            layers' params and states cloned from the source (a replaced
            layer and any whose shapes changed keep their fresh init),
            the fine-tune overrides on the base configuration, and the
            feature extractor frozen."""
            src = self.net
            src._require_init()
            conf = src.conf
            keep = len(conf.layers) - self._n_removed
            new_layers = [copy.deepcopy(l) for l in conf.layers[:keep]]
            for idx, (n_out, w_init) in self._nout_replaced.items():
                new_layers[idx].nOut = n_out
                new_layers[idx].weight_init = w_init
                if idx + 1 < len(new_layers):
                    new_layers[idx + 1].nIn = None  # re-infer
            new_layers.extend(copy.deepcopy(l) for l in self._added)

            base = copy.deepcopy(conf.base)
            if self._ftc:
                if self._ftc.updater is not None:
                    base.updater = self._ftc.updater
                if self._ftc.l1 is not None:
                    base.l1 = self._ftc.l1
                if self._ftc.l2 is not None:
                    base.l2 = self._ftc.l2
                if self._ftc.seed is not None:
                    base.seed = self._ftc.seed

            new_conf = MultiLayerConfiguration(base, new_layers,
                                               conf.input_type)
            net = MultiLayerNetwork(new_conf)
            net.init(device=src._device)
            for i in range(keep):
                if i in self._nout_replaced:
                    continue
                for name, arr in src._params[i].items():
                    cur = net._params[i].get(name)
                    if cur is not None and cur.shape == arr.shape:
                        net._params[i][name] = _clone_param(arr)
                for name, arr in src._states[i].items():
                    cur = net._states[i].get(name)
                    if cur is not None and cur.shape == arr.shape:
                        net._states[i][name] = _clone_state(arr)
            if self._freeze_until is not None:
                net._frozen_layers = set(range(self._freeze_until + 1))
            return net


class TransferLearningHelper:
    """ref: TransferLearningHelper — featurize the frozen prefix once,
    train only the unfrozen head."""

    def __init__(self, net: MultiLayerNetwork, frozen_until: int):
        self.net = net
        self.frozen_until = frozen_until

    def featurize(self, ds: DataSet) -> DataSet:
        """Run the inputs through the frozen prefix (ref: featurize): the
        activation of layer ``frozen_until`` from ``feedForward`` in
        inference mode, on the network's device."""
        acts = self.net.feedForward(ds.features, train=False)
        # activation index: acts[0] is the input; +1 per layer
        feat = acts[self.frozen_until + 1]
        return DataSet(feat, ds.labels, ds.features_mask, ds.labels_mask)

    def unfrozenMLN(self) -> MultiLayerNetwork:
        """A network of only the unfrozen layers, with copies of their
        params and states. As in the JAX package it has no input type and
        no preprocessors: it takes the featurized activations as they
        come."""
        conf = self.net.conf
        head_layers = conf.layers[self.frozen_until + 1:]
        new_conf = MultiLayerConfiguration.__new__(MultiLayerConfiguration)
        new_conf.base = conf.base
        new_conf.layers = head_layers
        new_conf.input_type = None
        new_conf.preprocessors = {}
        new_conf.layer_input_types = []
        new_conf.backprop_type = "standard"
        new_conf.tbptt_length = None
        net = MultiLayerNetwork(new_conf)
        net._device = self.net._device
        net._params = [{k: _clone_param(v) for k, v in d.items()}
                       for d in self.net._params[self.frozen_until + 1:]]
        net._states = [{k: _clone_state(v) for k, v in d.items()}
                       for d in self.net._states[self.frozen_until + 1:]]
        net._initialized = True
        return net

    def fitFeaturized(self, featurized: DataSet, epochs: int = 1):
        """Train the unfrozen head on featurized data and write its params
        back into the network, in place (the JAX helper writes back the
        params only, not the head's layer states)."""
        head = self.unfrozenMLN()
        head.fit(featurized, epochs=epochs)
        with torch.no_grad():
            for off, p in enumerate(head._params):
                dst = self.net._params[self.frozen_until + 1 + off]
                for k, v in p.items():
                    dst[k].copy_(v)
        return self.net
