"""The port's interop runners (``modelimport/interop.py``) on the CPU.

- ``GraphRunner`` runs stored ``tests/fixtures/tfgraphs`` graphs with
  TensorFlow itself (from the GraphDef's bytes on disk and from a parsed
  GraphDef) and equals the port's import of each at ``rtol=1e-4,
  atol=1e-5`` (the tolerance of ``tests/test_tfimport.py``), and the JAX
  package's runner on the same feeds to the bit.
- Each runner raises ``GraphRunnerError``, with the JAX package's advice,
  when its engine is missing (onnxruntime is not installed here; a
  missing TensorFlow is simulated).
"""

import os
import sys

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.modelimport import interop as jinterop
from deeplearning4j_tpu_torch.modelimport import interop as tinterop
from deeplearning4j_tpu_torch.modelimport.tensorflow import \
    importTensorflowGraph

torch.set_num_threads(2)

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "tfgraphs")
GRAPHS = ["test_mlp_matmul_bias_relu_softmax.npz", "test_conv_pool_nhwc.npz",
          "test_bert_style_attention_block.npz"]


def _fixture(fname):
    data = np.load(os.path.join(FIXTURE_DIR, fname), allow_pickle=False)
    ins = [str(n) for n in data["in_names"]]
    outs = [str(n) for n in data["out_names"]]
    feeds = dict(zip(ins, [data[f"feed_{i}"] for i in range(len(ins))]))
    return data["graph_def"].tobytes(), feeds, ins, outs


@pytest.mark.parametrize("fname", GRAPHS)
def test_graph_runner_equals_the_ports_import(fname, tmp_path):
    pytest.importorskip("tensorflow")
    raw, feeds, ins, outs = _fixture(fname)
    path = str(tmp_path / "graph.pb")
    with open(path, "wb") as f:
        f.write(raw)
    runner = tinterop.GraphRunner(path=path, input_names=ins)
    via_tf = runner.run(feeds, outs)
    again = runner.run(feeds, outs)             # the cached function
    via_port = importTensorflowGraph(raw, device="cpu").output(feeds, outs)
    via_jax = jinterop.GraphRunner(path=path, input_names=ins).run(feeds,
                                                                   outs)
    for name in outs:
        assert isinstance(via_tf[name], np.ndarray)
        np.testing.assert_array_equal(again[name], via_tf[name])
        np.testing.assert_array_equal(via_jax[name], via_tf[name])
        np.testing.assert_allclose(via_port[name].numpy(), via_tf[name],
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_graph_runner_takes_a_graph_def_and_finds_placeholders():
    pytest.importorskip("tensorflow")
    from tensorflow.core.framework import graph_pb2
    raw, feeds, ins, outs = _fixture(GRAPHS[0])
    gd = graph_pb2.GraphDef()
    gd.ParseFromString(raw)
    runner = tinterop.GraphRunner(gd, output_names=outs)
    assert runner.input_names == [n.name for n in gd.node
                                  if n.op == "Placeholder"]
    got = runner.run(feeds)
    want = importTensorflowGraph(raw, device="cpu").output(feeds, outs)
    for name in outs:
        np.testing.assert_allclose(want[name].numpy(), got[name], rtol=1e-4,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="no output names"):
        tinterop.GraphRunner(gd).run(feeds)
    with pytest.raises(ValueError, match="graph_def or path"):
        tinterop.GraphRunner()


def test_graph_runner_raises_without_tensorflow(monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    for mod in (tinterop, jinterop):
        with pytest.raises(mod.GraphRunnerError, match="needs tensorflow"):
            mod.GraphRunner(path="/nonexistent.pb")


def test_onnxruntime_runner_raises_without_onnxruntime(monkeypatch):
    monkeypatch.setitem(sys.modules, "onnxruntime", None)
    with pytest.raises(tinterop.GraphRunnerError,
                       match="onnxruntime") as port:
        tinterop.OnnxRuntimeRunner("/nonexistent.onnx")
    with pytest.raises(jinterop.GraphRunnerError, match="onnxruntime"):
        jinterop.OnnxRuntimeRunner("/nonexistent.onnx")
    assert "importOnnxModel" in str(port.value)
    assert isinstance(port.value, RuntimeError)
