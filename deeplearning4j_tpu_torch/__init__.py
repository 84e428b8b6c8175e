"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of ``deeplearning4j_tpu``.

The JAX package beside it is the reference this package is held
against; this one imports ``torch``, numpy and the standard library
only. The paths that run: serving a pre-LN BERT-base
(``models.transformer``) behind the continuous-batching
``serving.ModelServer``, its forward captured as CUDA graphs, and behind
the network front door (``serving.ModelRegistry``, ``serving.
HttpIngress``), and training it (``make_train_step``); training
every CNN of the JAX zoo (``models.zoo``: ResNet-50, YOLO2, LeNet-5,
VGG16, Darknet19, TinyYOLO, AlexNet, SqueezeNet, UNet, Xception,
FaceNetNN4Small2, InceptionResNetV1, NASNet and the rest) through
``nn.graph.ComputationGraph`` and
``nn.multilayer.MultiLayerNetwork``, one step or K steps a dispatch
captured as a CUDA graph (``nn.compilecache``, ``train.stepping``),
dropout drawn on the device clock, scored with ``evaluate`` and kept in
the JAX package's model archive (``train.serializer``), with device
augmentation in the step (``nn.augment``), dynamic loss scaling,
listeners, early stopping, and checkpoints, resume, preemption and NaN
recovery (``train.resilience``); and serving and
fine-tuning graphs recorded in SameDiff (``autodiff``). Hand-written CUDA
kernels for flash attention, layer norm, the fused conv epilogue and the
row softmax (``ops.cuda_kernels``) are installed as platform overrides
over the generic ops (``ops.registry``).

Layout (module and public names follow the JAX package):

- ``autodiff``  — ``SameDiff``, ``SDVariable``, ``TrainingConfig``
- ``ops``       — op registry, the generic ops (normalization,
                  attention, convolution/pooling, activations, losses),
                  and the CUDA kernels with their plain PyTorch twins
- ``nn``        — ``NeuralNetConfiguration``/``InputType``, the input
                  preprocessors, the layers,
                  ``ComputationGraph``, ``MultiLayerNetwork``,
                  ``PrecisionPolicy``, ``DeviceAugmentation`` and
                  ``compilecache`` (``CachedDispatch``, ``warmup``)
- ``train``     — the eleven updaters, the nine schedules, ``stepping``
                  (megasteps), the model archive (``serializer``),
                  checkpoints, resume and recovery (``resilience``),
                  ``listeners`` and ``earlystopping``
- ``evaluation``— ``Evaluation``, ``ROC`` and the other metrics
- ``analysis``  — the recompile-churn detector and the registry roll
                  lint (DL4J-W111)
- ``data``      — ``DataSet``, ``ListDataSetIterator`` and the MNIST,
                  EMNIST, Iris and TinyImageNet iterators
- ``models``    — the transformer and the model zoo (``LeNet``,
                  ``SimpleCNN``, ``VGG16``, ``VGG19``, ``Darknet19``,
                  ``TinyYOLO``, ``ResNet50``)
- ``serving``   — ``ModelServer``, ``ModelRegistry``, ``HttpIngress``,
                  ``DecodePreset``, ``samediff_forward``,
                  ``ServingRequest``, ``CircuitBreaker`` and the
                  structured serving errors
- ``parallel``  — the dispatch watchdog (``parallel.elastic``)
- ``faults``    — training and serving fault plans, seeded traffic,
                  swap schedules
- ``profiler``  — the metrics registry, span tracer, ``traceparent``
                  tracing, flight recorder, ``ProfilingMode`` and the
                  instrumented locks

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card and without an explicit device they raise.
"""

__version__ = "0.1.0"
