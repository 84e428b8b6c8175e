"""Model import, the port of ``deeplearning4j_tpu/modelimport``: BERT
checkpoints onto the transformer (:mod:`.bert`) and frozen TF GraphDefs
into SameDiff (:mod:`.tf_proto`, :mod:`.tensorflow`); :mod:`.tf_fixtures`
writes seeded fixtures in those formats. Not ported yet (ROADMAP.md queue
1 item 2): ONNX, Keras and the interop runners."""
