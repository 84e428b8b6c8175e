"""The port's recompile-churn detector (``analysis/churn.py``), following
``tests/test_analysis.py::TestChurnDetector``; on the card a new
signature is a new CUDA-graph capture."""

import warnings

import numpy as np
import torch

from deeplearning4j_tpu_torch.analysis import (Diagnostic,
                                               RecompileChurnDetector,
                                               Severity, array_fingerprint,
                                               get_churn_detector)
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.profiler.metrics import MetricsRegistry
from deeplearning4j_tpu_torch.train.updaters import Adam

torch.set_num_threads(2)


def _mlp():
    conf = (NeuralNetConfiguration.Builder().seed(1).updater(Adam(1e-2))
            .list()
            .layer(L.DenseLayer(nOut=8, activation="relu"))
            .layer(L.OutputLayer(nOut=3, lossFunction="mcxent",
                                 activation="softmax"))
            .setInputType(InputType.feedForward(4)).build())
    return MultiLayerNetwork(conf).init(device="cpu")


def _one_hot(n):
    return np.eye(3, dtype=np.float32)[np.arange(n) % 3]


class TestChurnDetector:
    def test_w201_fires_past_threshold(self):
        reg = MetricsRegistry()
        det = RecompileChurnDetector(threshold=3, registry=reg)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            results = [det.record("test.site", (("shape", i),))
                       for i in range(5)]
        assert results[:3] == [None, None, None]
        assert isinstance(results[3], Diagnostic)       # 4th distinct > 3
        assert results[3].code == "DL4J-W201"
        assert results[3].severity == Severity.WARNING
        assert results[4] is None                       # flagged once
        assert any("DL4J-W201" in str(w.message) for w in caught)
        # repeats are free
        assert det.record("test.site", (("shape", 0),)) is None
        assert det.signature_count("test.site") == 5
        child = reg.get("dl4j_recompiles_total").children()[("test.site",)]
        assert child.value == 5
        assert [d.code for d in det.diagnostics_for(None)] == ["DL4J-W201"]
        det.reset()
        assert det.signature_count("test.site") == 0

    def test_owners_do_not_pool_signatures(self):
        det = RecompileChurnDetector(threshold=1, registry=MetricsRegistry())
        a, b = object(), object()
        assert det.record("s", (1,), owner=a) is None
        assert det.record("s", (2,), owner=b) is None
        assert det.signature_count("s", owner=a) == 1
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            d = det.record("s", (3,), owner=a)
        assert d is not None and det.diagnostics_for(a) == [d]
        assert det.diagnostics_for(b) == []

    def test_fingerprint_shape_dtype_device_sensitivity(self):
        a = np.zeros((4, 3), np.float32)
        b = np.zeros((5, 3), np.float32)
        c = np.zeros((4, 3), np.float64)
        assert array_fingerprint(a) != array_fingerprint(b)
        assert array_fingerprint(a) != array_fingerprint(c)
        assert array_fingerprint(a, None) == array_fingerprint(a, None)
        ta = torch.zeros((4, 3))
        assert array_fingerprint(ta) == array_fingerprint(torch.ones((4, 3)))
        assert array_fingerprint(ta) != array_fingerprint(
            torch.zeros((4, 3), dtype=torch.bfloat16))
        assert array_fingerprint(ta)[0][3] == "cpu"
        assert array_fingerprint([ta, None]) == ((array_fingerprint(ta)[0],
                                                  None),)

    def test_undocumented_code_refused(self):
        try:
            Diagnostic("DL4J-X999", Severity.INFO, "here", "msg")
        except ValueError as e:
            assert "undocumented" in str(e)
        else:
            raise AssertionError("an undocumented code was accepted")

    def test_model_fit_churn_is_recorded(self):
        det = get_churn_detector()
        old = det.threshold
        det.threshold = 3
        try:
            net = _mlp()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                for n in (1, 2, 3, 4, 5):        # 5 distinct batch shapes
                    net.fit(DataSet(np.random.RandomState(n).rand(n, 4)
                                    .astype(np.float32), _one_hot(n)))
            site = "MultiLayerNetwork.fit"
            assert det.signature_count(site, owner=net) == 5
            assert [d.code for d in det.diagnostics_for(net)] \
                == ["DL4J-W201"]
            assert any("DL4J-W201" in str(w.message) for w in caught)
            # steady state: one signature, no new entries
            fresh = _mlp()
            for _ in range(4):
                fresh.fit(DataSet(np.ones((2, 4), np.float32), _one_hot(2)))
            assert det.signature_count(site, owner=fresh) == 1
            assert det.diagnostics_for(fresh) == []
        finally:
            det.threshold = old
