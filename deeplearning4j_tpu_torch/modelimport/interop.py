"""Interop runtimes: run foreign graphs with their own engines — the port's
copy of ``deeplearning4j_tpu/modelimport/interop.py``.

Reference parity: ``nd4j-tensorflow`` ``GraphRunner`` (runs a frozen TF
GraphDef through libtensorflow) and ``nd4j-onnxruntime``
``OnnxRuntimeRunner``: the reference's escape hatch for graphs its
importer cannot map, and the oracle its conformance tests check against.

The importers (:mod:`.tensorflow`, :mod:`.onnx`) are the port's path onto
the card; these runners exist for graphs with unmapped ops and for
checking an import against the source framework. Each engine is imported
only inside its runner's constructor, which raises
:class:`GraphRunnerError` with the same advice as the JAX package's when
the engine is missing: neither TensorFlow nor onnxruntime is installed on
the card's machine, and the rest of the port never needs them.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


class GraphRunnerError(RuntimeError):
    pass


class GraphRunner:
    """Run a frozen TF GraphDef with TensorFlow itself
    (ref: org.nd4j.tensorflow.conversion.graphrunner.GraphRunner).

    ``run`` takes and returns numpy arrays keyed by tensor names, the
    reference's contract (which moves INDArray <-> TF_Tensor)."""

    def __init__(self, graph_def=None, path: str = None,
                 input_names: Sequence[str] = None,
                 output_names: Sequence[str] = None):
        try:
            import tensorflow as tf
        except ImportError as e:
            raise GraphRunnerError(
                "GraphRunner needs tensorflow (the reference's "
                "nd4j-tensorflow needs libtensorflow the same way); it is "
                "not importable here") from e
        self._tf = tf
        if graph_def is None:
            if path is None:
                raise ValueError("need graph_def or path")
            from tensorflow.core.framework import graph_pb2
            gd = graph_pb2.GraphDef()
            with open(path, "rb") as f:
                gd.ParseFromString(f.read())
            graph_def = gd
        self.graph_def = graph_def
        self.input_names = list(input_names) if input_names else \
            [n.name for n in graph_def.node if n.op == "Placeholder"]
        self.output_names = list(output_names) if output_names else None
        # the GraphDef wrapped into a callable concrete function, per
        # output set
        self._fn = None

    def _build(self, out_names: Sequence[str]):
        tf = self._tf
        gd = self.graph_def

        @tf.function
        def runner(*args):
            name_map = {f"{n}:0": a for n, a in zip(self.input_names, args)}
            return tf.graph_util.import_graph_def(
                gd, input_map=name_map,
                return_elements=[f"{n}:0" for n in out_names])
        return runner

    def run(self, feeds: Dict[str, np.ndarray],
            output_names: Sequence[str] = None) -> Dict[str, np.ndarray]:
        out_names = list(output_names or self.output_names or [])
        if not out_names:
            raise ValueError("no output names given")
        tf = self._tf
        args = [tf.constant(feeds[n]) for n in self.input_names]
        key = tuple(out_names)
        if self._fn is None or self._fn[0] != key:
            self._fn = (key, self._build(out_names))
        res = self._fn[1](*args)
        if not isinstance(res, (list, tuple)):
            res = [res]
        return {n: np.asarray(r) for n, r in zip(out_names, res)}


class OnnxRuntimeRunner:
    """Run an ONNX model through onnxruntime
    (ref: org.nd4j.onnxruntime.runner.OnnxRuntimeRunner)."""

    def __init__(self, path: str):
        try:
            import onnxruntime as ort
        except ImportError as e:
            raise GraphRunnerError(
                "OnnxRuntimeRunner needs the onnxruntime package, which is "
                "not available in this environment — use "
                "modelimport.onnx.importOnnxModel (the port's importer) "
                "instead") from e
        self._sess = ort.InferenceSession(path)

    def run(self, feeds: Dict[str, np.ndarray],
            output_names: Sequence[str] = None) -> Dict[str, np.ndarray]:
        outs = self._sess.run(output_names, feeds)
        names = output_names or [o.name for o in self._sess.get_outputs()]
        return {n: np.asarray(r) for n, r in zip(names, outs)}
