"""Model import, the port of ``deeplearning4j_tpu/modelimport``: BERT
checkpoints onto the transformer (:mod:`.bert`), frozen TF GraphDefs
(:mod:`.tf_proto`, :mod:`.tensorflow`) and ONNX models (:mod:`.onnx_proto`,
:mod:`.onnx`) into SameDiff, Keras ``.h5`` saves into the networks
(:mod:`.hdf5`, :mod:`.keras`), and the interop runners that run a foreign
graph with its own engine (:mod:`.interop`). :mod:`.tf_fixtures`,
:mod:`.keras_fixtures` and :mod:`.onnx_fixtures` write seeded fixtures in
those formats."""
