"""K steps a dispatch (``train/stepping.py``) on the CPU, following the
cases of ``tests/test_multistep.py`` that apply to the port.

The guarantee under test: ``fit(steps_per_dispatch=K)`` produces the
same params, updater state, layer states and per-step losses as K
single-step ``fit`` calls, bit for bit (on the CPU a megastep is the
single step's code in a loop; on the card the loop is one captured CUDA
graph, held against eager steps in ``chip_smoke.py``). Signature changes
and epoch tails fall back to single steps. Plus the grouping edge cases
and the two counters.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.graph import (ComputationGraph,
                                               ElementWiseVertex)
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.nn.compilecache import state_tensors
from deeplearning4j_tpu_torch.train import stepping
from deeplearning4j_tpu_torch.train.updaters import Adam, AdamW

torch.set_num_threads(2)


def mlp(seed=42, lr=0.05, updater=None):
    conf = (NeuralNetConfiguration.Builder().seed(seed)
            .updater(updater or Adam(lr)).list()
            .layer(L.DenseLayer(nOut=16, activation="relu"))
            .layer(L.DenseLayer(nOut=16, activation="relu"))
            .layer(L.OutputLayer(nOut=3, lossFunction="mcxent",
                                 activation="softmax"))
            .setInputType(InputType.feedForward(4)).build())
    return MultiLayerNetwork(conf).init(device="cpu")


def cnn(seed=3):
    """conv + BN + leaky (a fused epilogue when fusion is on), max pool,
    conv, global pool, output: running statistics live in the state."""
    conf = (NeuralNetConfiguration.Builder().seed(seed).weightInit("relu")
            .updater(Adam(1e-2)).list()
            .layer(L.ConvolutionLayer(kernelSize=(3, 3), padding=(1, 1),
                                      nOut=6, activation="identity"))
            .layer(L.BatchNormalization())
            .layer(L.ActivationLayer("leakyrelu"))
            .layer(L.SubsamplingLayer(poolingType="max", kernelSize=(2, 2),
                                      stride=(2, 2)))
            .layer(L.ConvolutionLayer(kernelSize=(1, 1), nOut=4,
                                      activation="relu"))
            .layer(L.GlobalPoolingLayer("avg"))
            .layer(L.OutputLayer(nOut=3, lossFunction="mcxent",
                                 activation="softmax"))
            .setInputType(InputType.convolutional(8, 8, 2)).build())
    return MultiLayerNetwork(conf).init(device="cpu")


def graph(seed=7):
    b = (NeuralNetConfiguration.Builder().seed(seed)
         .updater(Adam(0.02)).graphBuilder())
    b.addInputs("in").setInputTypes(InputType.feedForward(4))
    b.addLayer("d1", L.DenseLayer(nOut=8, activation="relu"), "in")
    b.addLayer("d2", L.DenseLayer(nOut=8, activation="relu"), "d1")
    b.addVertex("add", ElementWiseVertex("Add"), "d1", "d2")
    b.addLayer("out", L.OutputLayer(nOut=3, lossFunction="mcxent",
                                    activation="softmax"), "add")
    b.setOutputs("out")
    return ComputationGraph(b.build()).init(device="cpu")


def make_batches(n, batch=16, nin=4, nout=3, seed=0, masked=False):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rng.randn(batch, nin).astype(np.float32)
        y = np.eye(nout, dtype=np.float32)[rng.randint(0, nout, batch)]
        m = (rng.rand(batch) < 0.7).astype(np.float32) if masked else None
        out.append(DataSet(x, y, labels_mask=m))
    return out


def image_batches(n, batch=4, seed=0):
    rng = np.random.RandomState(seed)
    return [DataSet(rng.randn(batch, 2, 8, 8).astype(np.float32),
                    np.eye(3, dtype=np.float32)[rng.randint(0, 3, batch)])
            for _ in range(n)]


class ListIterator:
    """A DataSetIterator-style source (reset/hasNext/next)."""

    def __init__(self, batches):
        self.batches, self.i = list(batches), 0

    def reset(self):
        self.i = 0

    def hasNext(self):
        return self.i < len(self.batches)

    def next(self):
        self.i += 1
        return self.batches[self.i - 1]


def fit_singly(net, batches):
    for ds in batches:
        net.fit(ds)
    return net


def assert_same_state(a, b):
    """Params, layer states, updater state and clock equal to the bit."""
    sa, sb = a._dispatch_state(), b._dispatch_state()
    assert len(sa) == len(sb)
    for x, y in zip(sa, sb):
        assert torch.equal(x, y)
    assert a._iteration == b._iteration


class TestMultiStepEquivalence:
    @pytest.mark.parametrize("k", [2, 4])
    def test_params_and_state_match_k_single_steps(self, k):
        batches = make_batches(8)
        a = mlp().fit(batches, steps_per_dispatch=k)
        b = fit_singly(mlp(), batches)
        assert a._iteration == b._iteration == 8
        assert_same_state(a, b)
        assert a.score() == b.score()

    def test_per_step_losses_match(self):
        batches = make_batches(6)
        a = mlp()
        a._ensure_opt_state()
        losses = []
        for item in stepping.group_into_megabatches(batches, 3):
            losses += a._fit_mega(item).tolist()
        b = mlp()
        want = [float(b._fit_one(ds)) for ds in batches]
        assert losses == want

    def test_masked_signature_equivalence(self):
        batches = make_batches(4, masked=True)
        a = mlp().fit(batches, steps_per_dispatch=4)
        b = fit_singly(mlp(), batches)
        assert_same_state(a, b)

    @pytest.mark.parametrize("fused", [False, True])
    def test_bn_running_stats_and_bf16_policy(self, fused):
        batches = image_batches(6)

        def build():
            net = cnn()
            net.setPrecisionPolicy("bf16")
            net.setComputeLayout("NHWC")
            net.setEpilogueFusion(fused)
            return net
        a = build().fit(batches, steps_per_dispatch=3)
        b = fit_singly(build(), batches)
        assert_same_state(a, b)
        # the running statistics moved
        assert not torch.equal(a._states[1]["mean"],
                               cnn()._states[1]["mean"])

    def test_adamw_matches_single_steps(self):
        batches = make_batches(4)
        up = AdamW(0.05, weight_decay=0.1)
        a = mlp(updater=up).fit(batches, steps_per_dispatch=2)
        b = fit_singly(mlp(updater=up), batches)
        assert_same_state(a, b)

    def test_tail_and_signature_change_fall_back_to_single(self):
        # 5 batches at K=4 -> one megastep + one single step; then a batch
        # with a different shape -> single step. All equivalent.
        batches = make_batches(5) + make_batches(1, batch=12, seed=9)
        a = mlp()
        calls = []
        mega, one = a._fit_mega, a._fit_one
        a._fit_mega = lambda mb: calls.append(("mega", mb.steps)) or mega(mb)
        a._fit_one = lambda ds: calls.append(("one", 1)) or one(ds)
        a.fit(batches, steps_per_dispatch=4)
        assert calls == [("mega", 4), ("one", 1), ("one", 1)]
        b = fit_singly(mlp(), batches)
        assert a._iteration == 6
        assert_same_state(a, b)

    def test_iterator_input_and_epochs(self):
        batches = make_batches(8)
        a = mlp()
        a.fit(ListIterator(batches), epochs=2, steps_per_dispatch=4)
        b = mlp()
        b.fit(ListIterator(batches), epochs=2)
        assert a._iteration == b._iteration == 16
        assert a._epoch == b._epoch == 2
        assert_same_state(a, b)

    def test_graph_equivalence(self):
        batches = make_batches(6, batch=8)
        a = graph().fit(batches, steps_per_dispatch=3)
        b = fit_singly(graph(), batches)
        assert_same_state(a, b)

    def test_k1_is_the_single_step(self):
        batches = make_batches(3)
        a = mlp().fit(batches, steps_per_dispatch=1)
        b = fit_singly(mlp(), batches)
        assert_same_state(a, b)
        assert list(a._step_cache) == [(False, False, 1)]

    def test_bad_k_refused(self):
        with pytest.raises(ValueError, match="steps_per_dispatch"):
            mlp().fit(make_batches(1), steps_per_dispatch=0)


class TestInPlaceState:
    def test_storage_is_kept_across_steps(self):
        net = cnn()
        net.fit(image_batches(1))
        ptrs = [t.data_ptr() for t in net._dispatch_state()]
        net.fit(image_batches(4, seed=1), steps_per_dispatch=2)
        net.fit(image_batches(1, seed=2))
        assert [t.data_ptr() for t in net._dispatch_state()] == ptrs
        assert int(net._t_dev) == net._iteration == 6

    def test_state_list_covers_params_states_updater_and_clock(self):
        net = cnn()
        net.fit(image_batches(1))
        st = net._dispatch_state()
        n_params = sum(len(p) for p in net._params)
        n_states = sum(len(s) for s in net._states)
        assert len(st) == n_params + n_states + 2 * n_params + 1
        assert st[-1] is net._t_dev
        assert len(state_tensors(net._opt_state)) == 2 * n_params


class TestMegabatchGrouping:
    def test_group_counts(self):
        batches = make_batches(7)
        items = list(stepping.group_into_megabatches(iter(batches), 3))
        megas = [i for i in items if isinstance(i, stepping.MegaBatch)]
        singles = [i for i in items if isinstance(i, DataSet)]
        assert len(megas) == 2 and len(singles) == 1
        assert all(m.steps == 3 for m in megas)
        assert megas[0].features.shape == (3, 16, 4)
        assert megas[0].numExamples() == 48
        assert megas[0].labels_mask is None

    def test_k1_passthrough(self):
        batches = make_batches(3)
        assert list(stepping.group_into_megabatches(iter(batches), 1)) \
            == batches

    def test_signature_change_flushes_pending(self):
        batches = make_batches(2) + make_batches(2, batch=8, seed=5)
        items = list(stepping.group_into_megabatches(iter(batches), 3))
        # no group reaches 3: everything falls through as singles
        assert all(isinstance(i, DataSet) for i in items)
        assert len(items) == 4

    def test_mask_presence_is_part_of_the_signature(self):
        plain, masked = make_batches(1), make_batches(1, masked=True)
        assert stepping.batch_signature(plain[0]) \
            != stepping.batch_signature(masked[0])

    def test_stacked_items_pass_through(self):
        mb = stepping.stack_megabatch(make_batches(2))
        items = list(stepping.group_into_megabatches(
            iter(make_batches(1) + [mb]), 2))
        assert isinstance(items[0], DataSet) and items[1] is mb

    def test_tensors_stack_as_tensors(self):
        batches = [DataSet(torch.ones(2, 4), torch.zeros(2, 3))
                   for _ in range(2)]
        mb = stepping.stack_megabatch(batches)
        assert isinstance(mb.features, torch.Tensor)
        assert tuple(mb.features.shape) == (2, 2, 4)


class TestCounters:
    def test_steps_per_dispatch_and_iterations_total(self):
        a = mlp()
        before = stepping.TRAIN_ITERATIONS.value
        a.fit(make_batches(5), steps_per_dispatch=4)
        # one megastep of 4, then the tail's single step
        assert stepping.TRAIN_ITERATIONS.value - before == 5
        assert stepping.STEPS_PER_DISPATCH.value == 1
        a.fit(make_batches(4), steps_per_dispatch=4)
        assert stepping.STEPS_PER_DISPATCH.value == 4
        assert stepping.TRAIN_ITERATIONS.value - before == 9
