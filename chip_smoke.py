#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/H100 port (``deeplearning4j_tpu_torch``).

Run from the root of a checkout on a machine with one CUDA card::

    python3 chip_smoke.py

Phases (each one fails the run with a non-zero exit):

1. Environment: card name and power limit, torch/CUDA versions, and the
   build of every CUDA kernel from ``deeplearning4j_tpu_torch/ops/csrc``
   (one ``nvcc`` per source, all started together), with the registers and
   spills ``ptxas`` reports for the flash-attention, layer-norm and
   BN+leaky kernels.
2. Each kernel against its plain PyTorch version on the card, at the
   listed shapes, with the tolerances below: layer norm on both routes
   (a warp per row up to D=1024, a block above; 16-byte and scalar loads;
   row counts off the block's 8), flash attention on both routes (the
   tensor-core route for bf16 at every D, causal or not, T in 1, 63, 64,
   65, 200, 512, Tq != Tk, the strided thirds of a QKV product; the
   CUDA-core route for fp32 and an unaligned bf16 view), each call's route
   read from ``FLASH_ROUTES``; then each one timed (CUDA
   events, median of 30 launches, L2 flushed before each and each queued
   behind a short device spin, so the host's launch time is not counted)
   beside its
   plain version, its roofline bound, and one PyTorch library call that
   computes the same function (a yardstick only; the port never calls it);
   layer norm and flash attention at T=128 and T=512 (B=32) and at the
   BertBench train step's B=64, T=128, then both at phase 23's shapes: LN
   on [4096, 768] fp32 with BERT's eps 1e-12 (phase 28's rows too) and
   flash on q, k, v [32, 128, 12, 64] fp32 (the CUDA-core route, beside
   fp32 SDPA), and flash at phase 28's [4, 1024, 12, 64] fp32. The BN+leaky
   probe's kernels (``bn_stats``, ``bn_apply_leaky``) at C in {1, 16,
   1024} x M in {1, 7, 4099, 1,000,003, 5,537,792}, fp32 and bf16, and
   with a NaN, then timed at the probe's [16, 5,537,792] bf16 beside
   their bounds and library calls (and the pair beside
   ``F.batch_norm(training=True)`` + ``F.leaky_relu``);
   ``scale_shift_act`` also at TinyYOLO's first epilogue, [5,537,792, 16]
   bf16, alpha 0.01, at Darknet19's, [1,605,632, 32] bf16, alpha 0.01,
   and at YOLO2's, [5,537,792, 32] bf16, alpha 0.01.
3. Serve BERT-base (full width, bf16, random weights from a seed) through
   ``ModelServer(lm.logits, head="argmax")`` with the kernels installed,
   the forward and head captured as one CUDA graph a bucket x shape:
   warmup must capture 12 graphs (6 buckets x T in 128, 512), each
   recording 12 flash-attention launches, all on the tensor-core route,
   and 25 layer-norm launches, with no capture failure; then 64 requests
   of 1-8 rows at T=128 and T=512 from four threads. Every request must
   resolve exactly once and agree with a direct ``lm.logits`` on >= 99.9%
   of tokens; during the traffic no kernel is launched eagerly, each
   dispatched batch replays 12 flash + 25 layer-norm launches
   (``REPLAYS``), and ``recompiles_after_warmup()`` and the captures
   after warmup stay 0. It prints, at B=32 and T in 128, 512, one eager
   forward+head against one replay (host clock, median of 10, each from
   the host batch to the host answer). Direct forwards at T=128 and T=512
   take 12 tensor-core flash launches each, and one forward with the
   kernels is held against the same forward on the plain versions.
4. Train ResNet-50 (full width, 1000 classes, 3x224x224, random weights
   from a seed) through ``ComputationGraph.fit`` in the bf16 / NHWC /
   fused-epilogue configuration, B=64: one warm step, then 5 timed steps
   on the same batch. Every loss must be finite, the last below the
   first, and the counters must read 33 ``scale_shift_act`` launches per
   step and no plain call.
5. ResNet-50 ``output()`` (33 launches) held against the same forward on
   the plain ``scale_shift_act``; the trained net is then saved with
   ``ComputationGraph.save`` (phase 18 loads it).
6. Serve a BERT-base sequence classifier written op by op in SameDiff
   (full width, fp32, post-LN, 2 labels, random weights from
   ``numpy.random.default_rng(0)``; :func:`build_bert`, a copy of the
   builder in ``tests/test_torch_samediff.py``) through the same captured
   ``ModelServer(samediff_forward(sd, ["probs"]))``: warmup must capture
   6 graphs, each recording 13 softmax and 25 layer-norm launches, with
   no capture failure; then 64 requests of 1-8 rows at T=128 from four
   threads. Every request must resolve exactly once, its probs equal a
   direct ``sd.output`` (1e-4 absolute: the served batch pads to a
   bucket, so cuBLAS may sum in another order); during the traffic no
   kernel is launched eagerly, each batch replays 13 softmax + 25
   layer-norm launches, and ``recompiles_after_warmup()`` stays 0.
7. Fine-tune that graph: Adam 1e-4, 6 steps on one B=32 batch, from one
   saved state three ways: the step run eagerly twice (every loss
   finite, the last below the first, 12 softmax (the loss takes the
   logits, not the head's probs) and 25 layer-norm launches per step,
   no plain call), then 6 calls of the public ``sd.fit`` on the captured
   dispatch (scope ``samediff:fit``): one capture recording 12 softmax
   and 25 layer-norm launches, every step a replay, no capture failure
   and no recapture; the loss, the variables, the Adam moments and the
   clock held by the captured-against-eager rule below (the three runs
   under PyTorch's deterministic algorithms: the embeddings' backward
   accumulates with atomics otherwise). Then, without them, 12 eager
   steps and a fresh capture's 6 replays are timed: it prints the eager
   (steps 7-12) and captured ms a step (each ending in a host read of
   its loss).
8. ``save`` the graph, uninstall the kernels and ``load`` the file, so
   its nodes resolve the generic ops; the two graphs' probs must agree
   within 1e-5, and their ``calculateGradients`` on one batch within a
   relative L2 distance of 1e-4 with every element within 1e-4 of the
   largest gradient (some gradients, like the key biases', are zero in
   exact arithmetic and pure rounding in both, so no per-tensor relative
   bound holds for them).

9. Train TinyYOLO (full width: 20 classes, 3x416x416, random weights
   from seed 123, Adam 1e-3) through ``MultiLayerNetwork.fit`` in the
   bf16 / NHWC / fused-epilogue configuration, B=32, on one batch whose
   labels hold 1-3 boxes an image (``numpy.random.default_rng(0)``): one
   warm step, then 5 timed steps. Every loss finite, 8 ``scale_shift_act``
   launches per step and no plain call; the first two losses within 2e-2
   relative of a fresh net from the same seed on the plain
   ``scale_shift_act``. (The loss need not fall: the reference's TinyYOLO
   loss spikes after its first steps.)
10. TinyYOLO ``output()`` at B=32 (8 launches) on a fresh net from the
   seed (the trained one's wh outputs, anchors * exp, may overflow after
   the loss's spike) against the same net on the plain
   ``scale_shift_act``: relative L2 distance <= 1e-2 (both sides run
   bf16 through 8 epilogues; kernel and plain agree to the bit but for
   double-rounding ties, which the 1024-channel layers may carry on);
   then ``YoloUtils.getPredictedObjects`` on it.
11. The BN+leaky probe (``deeplearning4j_tpu_torch.benchmarks.
   probe_bn_leaky.main``) at [32, 16, 416, 416] bf16: the kernels within
   the probe's 0.05 of the composed version, one ``bn_stats`` and one
   ``bn_apply_leaky`` launch per call and no plain call; it prints the
   measured stream, both times, their shares of it and the verdict (no
   speed threshold fails the run).

12. Train the BertBench BERT-base (``profile_fit.BertBench``: full width,
   bf16, flash attention, random weights from seed 0, Adam 1e-4, B=64,
   T=128, tokens from ``np.random.RandomState(0)``, an all-ones mask)
   through ``models.transformer.make_train_step``, eagerly: 2 warm steps,
   then 5 timed (host clock around a step that ends in a host read of
   its loss). Losses finite; 12 flash launches a step, all on the tensor
   cores, and 25 layer-norm launches; no plain call. It prints MFU (FLOPs
   a token as bench.py counts them, against the dense bf16 peak of the
   card), then step ms, samples/s, tokens/s, peak GB and the losses.
13. The same step through ``CachedDispatch``, captured once: first the
   eager step runs twice from one state (restored in place), then the
   captured step from that state; every tensor of the state (params,
   Adam moments, the clock) and the loss are held against the first eager
   run by the rule below; then 5 replays are timed. The capture must
   record 12 flash and 25 layer-norm launches, each replay adds them to
   ``REPLAYS`` and launches nothing eagerly; 0 capture failures and, after
   the capture, 0 new captures and one churn signature.
14. ResNet-50 (B=64) and TinyYOLO (B=32, 416²) in their phase 4 and 9
   configurations, ``fit(steps_per_dispatch=4)``: from one state (restored
   in place), 8 single eager steps twice, then ``compilecache.warmup``
   (which must leave the state bit-equal) and 2 captured megasteps of 4;
   params, BN statistics, Adam moments, the clock and the 8 per-step
   losses held against the first eager run by the rule below; then 8
   steps each way timed. The capture must record 4 x 33 (ResNet-50) and 4
   x 8 (TinyYOLO) ``scale_shift_act`` launches and nothing else; 0
   capture failures, 0 new captures after warmup, one churn signature.

15. The front door: ``ModelRegistry(batch_limit=32, head="argmax",
   input_dtype=np.int32)`` loads the phase-3 BERT-base (seed 0) as
   ``"bert"`` v1 with ``shapes=[(128,)]`` and ``HttpIngress(reg, port=0)``
   puts it on loopback. ``ServingLoad.seeded(seed=0, mix="steady",
   n=1024, rps=150, max_rows=8)`` replays over real sockets
   (``replay_http``, JSON bodies of int32 tokens, T=128, ``deadline_ms``
   5000); meanwhile ``reg.load("bert", v2)`` (the same configuration from
   seed 1) captures v2's 6 graphs while v1 serves, then a
   ``SwapSchedule`` fires roll, rollback, roll. Every request must be
   answered exactly once with 200 by the version routed at its admission
   (read under the registry lock with the admission, keyed by trace id),
   and agree with a direct argmax of that version on >= 99.9% of tokens;
   v1 must dispatch while v2 captures; both servers keep
   ``recompiles_after_warmup()`` and their captures after warmup at 0;
   no capture fails; the only eager launches during the traffic are v2's
   warmup's (its warm-up runs, captures and one replay a bucket);
   ``GET /v1/models``, ``/v1/load``, ``/healthz`` and ``/readyz`` answer
   200 with the reference's keys; and a request with ``deadline_ms`` 1
   behind 64 queued requests comes back 504. It prints tokens/s, the wire
   latency p50/p99 (client clock, first byte sent to response read), v2's
   load and capture seconds, and the memory with two versions loaded;
   and what the load costs v1: v2's load split into its eager warm-up
   runs, the captures' entry (``compilecache.cache_stats()``) and the
   recording, v1's longest gap between two batches while v2 loads (and
   the stretch of the load it falls in) beside its longest while it
   serves alone (between the rollback and the second roll), and v1's
   peak queue depth.

16. LeNet-5 (``zoo.LeNet``: widths 20/50/500, flat 1x28x28 rows through
   its ``convolutionalFlat`` preprocessor, xavier, Adam 1e-3, random
   weights from seed 123, fp32 as dl4j-examples runs it) through
   ``MultiLayerNetwork.fit`` on ``MnistDataSetIterator(64, True,
   num_examples=2048)`` (the seeded synthetic digits unless
   ``DL4J_TPU_DATA_DIR`` holds the IDX files): 4 epochs a step a
   dispatch, then 4 at ``steps_per_dispatch=4`` (one capture, no
   failure). ``evaluate(MnistDataSetIterator(256, False,
   num_examples=512))`` must reach accuracy >= 0.99 (the JAX package's
   pinned bar); ``save`` -> ``load`` -> ``output()`` and
   ``clone().output()`` must equal ``output()`` to the bit.
17. VGG16 (``zoo.VGG16``: 1000 classes, 3x224x224, 138,357,544 params,
   two ``DenseLayer(4096, dropOut=0.5)``, Adam 1e-3, random weights from
   seed 123) at B=64 in the bf16 / NHWC / fused configuration, with
   cuDNN held to deterministic algorithms for the phase: one warm step
   (its mask draws counted: fc1's [64, 25088] and fc2's [64, 4096]; an
   eval-mode ``output()`` draws none), then 5 eager timed steps; then
   phase 14's comparison (8 eager steps twice, ``warmup``, 2 captured
   dispatches of 4, from one state), here to the bit on every tensor and
   loss, dropout masks included (the masks are a function of the seed,
   the device clock and the layer); fc1's masks over 8 steps keep 0.5 +-
   0.01 and change from step to step, and a CUDA graph replaying the mask
   draw on its clock gives the eager masks. It prints step ms eager and
   captured, images/s, MFU (``vgg16_flops(224)`` x 3 a step, bench.py's
   count, against the card's dense bf16 peak), peak memory and the card's
   busy share of one eager step and one captured dispatch (the traces of
   ``profile_fit.py --model vgg16``).
18. Darknet19 (``zoo.Darknet19``: 1000 classes, 224^2, random weights
   from seed 123) at B=32, bf16 / NHWC / fused: 18 ``scale_shift_act``
   launches (leaky 0.01) a step and no plain call over 3 eager steps;
   phase 14's comparison with 4 x 18 launches recorded at capture; the
   busy share of one traced eager step and one captured dispatch;
   ``output()`` (18 launches) against the same net on the plain
   ``scale_shift_act`` within phase 5's bound. Then
   ``ComputationGraph.load`` of phase 5's archive gives the trained
   ResNet-50 back, whose ``output()`` must equal phase 5's to the bit.
19. YOLO2 (``zoo.YOLO2``: 80 classes, 3x416x416, the COCO anchors, Adam
   1e-3, random weights from seed 123) through ``ComputationGraph.fit``
   at B=32, bf16 / NHWC / fused, labels of 1-3 boxes an image on the
   13x13 grid (``yolo_labels``, ``numpy.random.default_rng(0)``): 21
   fused conv-BN-leaky blocks; one warm step, then 3 eager timed steps
   (21 ``scale_shift_act`` launches a step, no plain call, finite
   losses; step ms, images/s, MFU against the card's dense bf16 peak
   from ``profile_fit.conv_flops``, 35.0 GFLOP an image forward x 3 a
   step; peak memory); phase 14's comparison to the bit
   (``captured_fit(..., exact=True)``, cuDNN held to deterministic
   algorithms for it) with 4 x 21 launches recorded at capture; a traced
   eager step and a traced captured dispatch by group
   (``profile_fit.profile``); then ``output()`` of a fresh net (21
   launches, finite fp32 [32, 425, 13, 13]) against the same net on the
   plain ``scale_shift_act`` within phase 18's bound (max 5%, mean 0.2%
   of max|out|), decoded with ``YoloUtils.getPredictedObjects``.
20. The other zoo CNNs (AlexNet, SqueezeNet, UNet, Xception,
   FaceNetNN4Small2, InceptionResNetV1, NASNet), each at its default
   input shape and classes, B=16, bf16 / NHWC / fused: a warm step and 3
   eager steps (finite losses; launches: its fused blocks'
   ``scale_shift_act`` a step, none in these seven, and no other kernel
   or plain call), ``output()`` finite of the right shape; step ms and
   images/s.
21. TextGenerationLSTM (``zoo.TextGenerationLSTM()``: 77 symbols, two
   LSTM(256), fp32, xavier, Adam 1e-3, clip_value 5.0, random weights
   from seed 123) on the seeded synthetic corpus of
   ``profile_fit.markov_chars`` (an order-2 Markov chain, Zipf-skewed,
   seed 0): 3 batches of B=32 sequences of T=1000 one-hot characters
   through ``fitTBPTT(ds, 50)`` (20 window updates a batch), twice
   eagerly and once through the captured window step
   (``compilecache.warmup(..., tbptt_length=50)``, which must leave the
   state bit-equal), all from one snapshot; params, Adam moments, the
   clock and the carried (h, c) after every batch and every window loss
   held by the rule below; one capture, 60 hits, no failure, one churn
   signature. Every loss finite; the first window's loss within 1e-4
   relative of the same net's on the CPU; the last batch's mean window
   loss below the first's. It prints ms a window and characters/s each
   way. Then 4 samples of 300 characters through ``rnnTimeStep``, one
   [4, 77] step at a time, drawn from the softmax with a seeded
   ``torch.Generator`` on the card (ms a character); ``rnnTimeStep`` over
   the samples in chunks of 1, 7 and 50 within 1e-5 of ``output()`` over
   the whole sequence, and ``rnnClearPreviousState`` restarting it. A
   batch with ragged lengths 500-1000 (features and labels masked)
   through ``fit()`` on the configuration read back from JSON with
   ``backpropType("tbptt", 50)``, at learning rate 0: its 20 window
   losses must sum to the plain forward's masked loss over the whole
   sequence within 1e-5 relative (the windows carry state and slice the
   label mask), the params unchanged. ``save``/``load`` must give a
   bit-equal ``output()``, and none of the six kernels may launch (the
   recurrences are stock torch ops, as the JAX ones are jnp).
22. ResNet-50 from JPEG files on disk: bench.py's DataPipelineBench data
   (``profile_fit.noise_jpegs``: 1024 images of 256^2 uniform noise,
   JPEG quality 85, 8 class directories, ``RandomState(42)``, in a
   temporary directory removed at the end) through
   ``MultiWorkerImageIterator(root, 224, 224, batch_size=64,
   workers=os.cpu_count(), drop_last=True, steps_per_dispatch=4)`` into
   ``zoo.ResNet50(num_classes=8, input_shape=(3, 224, 224))`` in phase
   14's bf16 / NHWC / fused configuration, cuDNN held to deterministic
   algorithms: ``compilecache.warmup`` captures the uint8 megastep (4 x
   33 ``scale_shift_act`` launches, no failure, the state unchanged),
   then 2 epochs of ``fit(it, steps_per_dispatch=4, prefetch=2)`` and,
   from the same initial state, of ``prefetch=0``. Each run must see
   every image once an epoch (the label histogram of its megabatches
   equals the tree's) in 8 megasteps and no single step, make one uint8
   [4, 64, 3, 224, 224] copy to the card and one of its labels a dispatch
   and no other (``data.dataset.H2D_COPIES``), replay 4 x 33
   ``scale_shift_act`` a dispatch and launch nothing eagerly, and give
   finite losses; the two runs' state (params, BN statistics, Adam
   moments, the clock) and losses must be equal to the bit;
   ``evaluate(it, prefetch=True)`` must give ``prefetch=False``'s
   accuracy. It prints images/s and ms a step from disk beside phase
   14's in-memory captured step, the host's data wait against its
   dispatch time and ``data_overlap_ratio()``, the pipeline's decode,
   ring-copy and consumer-stall seconds, the decode ms an image on one
   core (and the codec: cv2 where it imports, else PIL) with the host
   cores, the pinned copy rate of one megabatch and the peak memory.
23. BERT-base by checkpoint import (path A; BASELINE config #3): the
   full-width weights (V=30522, E=768, H=12, L=12, F=3072, 512 positions,
   2 token types, the pooler and a 2-label classifier; fp32, about 110M
   parameters, drawn from ``numpy.random.default_rng(0)`` by
   ``modelimport.tf_fixtures.bert_weights``) saved with ``torch.save``
   under HuggingFace keys and under google-research TF names in a
   temporary directory; ``importBertModelAndWeights(path,
   use_flash_attention=True)`` of the two files must give bit-equal
   params. A sequence classifier over ``models.transformer.encode`` (the
   pooler and head applied to the [CLS] row) is served through
   ``ModelServer`` captured a bucket x shape: each capture records 25
   ``layer_norm`` launches (the [B*T, 768] fp32 view) and 12 flash
   launches, all on the fp32 CUDA-core route (``FLASH_ROUTES``); then 64
   requests of 1-8 rows at T=128, each resolved once, replaying 12 + 25 a
   forward and launching nothing eagerly, and equal to a direct call
   within 1e-4. One forward with the kernels against the same forward on
   their plain versions (fp32, 1e-4). Then ``make_train_step`` with Adam
   1e-4, 5 steps at B=32, T=128 (12 flash and 25 LN launches a step):
   finite losses, the last below the first. It prints the import
   seconds, the served latency and tokens/s, one captured replay at
   B=32, and the train-step ms.
24. The same weights as a frozen BERT-base GraphDef (path B), written by
   ``tf_fixtures.bert_graph_def`` in google-research ``modeling.py``'s
   frozen op structure (one int32 ``input_ids`` placeholder [-1, 128]),
   parsed by ``modelimport.tf_proto`` and imported by
   ``importTensorflowGraph`` onto the card: its ``pooled_output`` and
   ``logits`` within 1e-3 absolute of phase 23's ``encode`` + pooler +
   head on the same batch (taken before phase 23 trained), with no kernel
   launched (the importer's softmax is plain torch, as the JAX one's is
   ``jax.nn.softmax``); served through ``ModelServer(samediff_forward(sd,
   ["logits"]))`` (eager SameDiff under the server's capture, as phase
   6): 64 requests, each resolved once and equal to a direct
   ``sd.output`` within 1e-4; fine-tuned as the JAX
   ``TestImportedGraphFinetune`` does (``convertToVariables`` on the
   weight constants the graph consumes, ``loss.softmaxCrossEntropy`` on a
   ``labels`` placeholder, ``TrainingConfig(Adam(1e-4))``, 6 steps at
   B=32 as phase 7 runs them: eagerly twice, then captured through
   ``sd.fit``, held by the rule, no kernel launched; finite, falling
   losses; the eager and captured ms a step); ``save`` then ``load`` gives
   bit-equal logits. It prints the GraphDef's MB, the write, parse and
   import seconds (the import twice: the first in a process also loads
   torch's meta kernels for the fold check), the node count, the served
   tokens/s and the ms a fit step.
25. A long ResNet-50 run from disk (``ComputationGraph``): phase 22's
   1024 noise JPEGs decoded at 256^2 by
   ``MultiWorkerImageIterator(shuffle=True, steps_per_dispatch=4)``;
   ``DeviceAugmentation(seed=7).crop(32).random_flip().normalize(ImageNet
   mean, std)`` to 224^2 inside the captured step; ResNet-50 (8 classes)
   bf16 / NHWC / fused, B=64, K=4, ``Nesterovs(StepSchedule("iteration",
   0.1, 0.1, 16), momentum=0.9)``, 2 epochs (32 steps), cuDNN
   deterministic. ``warmup`` captures the augmented uint8 megastep (4 x 33
   ``scale_shift_act``, the state unchanged); the schedule read on the
   card at steps 1, 17 and 32 is the host's (1e-6 relative). Run A:
   ``CheckpointConfig(every_steps=8, keep_last=2, async_write=True)`` with
   ``ScoreIterationListener(8)`` and ``PerformanceListener(8)``: 32 finite
   losses, 4 checkpoints, the last two kept; the same run with the
   checkpoints alone and with neither (no session: the dispatch stream)
   must end bit-equal to it. Run B: ``FaultPlan(preempt_at_step=12)``
   stops with a ``"preempted"`` checkpoint at step 12; a fresh net
   resumed from it (``resume=True``) must end at step 32 bit-equal to run
   A (params, updater state, BN statistics, the clock). Run C, from the
   same start, a NaN batch at step 20 (``nan_grads_at={20}``, stopping at
   24): under ``SKIP_STEP`` one non-finite step and the state after it
   bit-equal to the state before the dropped dispatch; under
   ``BACKOFF_LR`` the scale 0.5 on the host and on the card in the same
   storage, one capture (the lr-scaled megastep, before the backoff) and
   none after; under ``ROLLBACK`` the state of run A's step 16, and
   each run's state at step 16 equal to run A's. It prints the ms a step
   of the three runs, the checkpoint's MB and write seconds, and the
   copies to the card a dispatch under the session.
26. Dynamic loss scaling (``MultiLayerNetwork``): TinyYOLO at B=32,
   416^2, fp16 / NHWC / fused (fp16 takes the generic epilogue: the
   kernel's gate is fp32 and bf16), ``PrecisionPolicy("fp16",
   loss_scale="dynamic", loss_scale_init=2**24, growth_interval=4)``,
   captured at K=4 for 32 steps: each step's finite flag recorded on the
   card (a spy on ``precision.grads_all_finite`` writing at the clock's
   index inside the graph), the first step overflowing, the scale after
   each dispatch equal to the automaton's rule run on the CPU from those
   flags, an all-overflow first dispatch leaving the state as it was; one
   capture, no failure, a finite last loss.
27. Early stopping: LeNet-5 on phase 16's digits through
   ``EarlyStoppingTrainer(steps_per_dispatch=4)``,
   ``DataSetLossCalculator`` on the 512 held-out digits,
   ``ScoreImprovementEpochTerminationCondition(2)``,
   ``MaxEpochsTerminationCondition(10)`` and ``LocalFileModelSaver``: the
   best model reloaded from its file scores the recorded best score
   exactly, and its accuracy is at least 0.99.
28. A Keras model enters by import: ``modelimport.keras_fixtures.
   encoder_h5`` writes a Keras 3 functional full-model ``.h5`` (stock
   Keras layers in keras.io's Transformer block, post-LN: token and
   position ``Embedding``s, 12 blocks of ``MultiHeadAttention`` -> ``Add``
   -> ``LayerNormalization`` -> ``TimeDistributed(Dense(3072, gelu))`` ->
   ``TimeDistributed(Dense(768))`` -> ``Add`` -> ``LayerNormalization``,
   ``GlobalAveragePooling1D``, ``Dense(2, softmax)``; BERT-base's widths,
   108,891,650 fp32 parameters from ``numpy.random.default_rng(0)``) to a
   temporary directory; ``modelimport.hdf5`` parses it and
   ``importKerasModelAndWeights`` imports it onto the card as a
   ``ComputationGraph``. Served through ``ModelServer`` (captured, the
   position ids made on the card) at T=128, B <= 32: each capture records
   25 ``layer_norm`` launches and no flash (the JAX gate sends T < 1024
   to ``dot_product_attention``); 64 requests of 1-8 rows, each resolved
   once, replaying 25 a forward, launching nothing eagerly, equal to a
   direct ``output()`` within 1e-4, with ``recompiles_after_warmup()``
   0; one forward against the plain versions within 1e-4. Then a depth-2
   copy with 1024 positions, served one unmasked [4, 1024] batch: 2 fp32
   flash launches on the CUDA-core route and 5 ``layer_norm`` a forward,
   captured and direct, kernels against plain versions within 1e-4. It
   prints the file's MB, the parse and import seconds, tokens/s, p50/p99
   and the captured B=32 replay beside phase 23's path A.
29. ResNet-50 v1 from an ONNX file: ``zoo.ResNet50`` (1000 classes,
   224^2, seed 0, fp32, no policy) with seeded BN statistics
   (``onnx_fixtures.randomize_batch_norm``) written by
   ``onnx_fixtures.write_resnet50`` to a temporary directory (the ONNX
   model zoo's resnet50-v1 node kinds, ~102 MB), parsed by
   ``onnx_proto`` and imported onto the card by ``importOnnxModel``; the
   import report holds no E16x. On one [32, 3, 224, 224] batch the
   imported logits are within ``ONNX_LOGIT_TOL`` of the largest logit of
   the ``ComputationGraph``'s (``onnx_fixtures.resnet50_logits``) and
   their softmax within ``ONNX_PROB_TOL`` of ``output()``, with no kernel
   launched. Served through ``ModelServer`` over ``sd.output`` (captured
   per bucket, B <= 32): 64 requests of 1-8 images, each resolved once,
   equal to a direct call within the same bound, nothing launched or
   replayed of the kernels, no recompile; images/s, p50/p99 and the
   captured B=32 replay. ``SameDiff.save``/``load`` through the
   ``"onnx"`` rebuild gives the logits back to the bit.
30. Transfer learning: phase 9's TinyYOLO (20 classes, 416^2, B=32, bf16
   policy, NHWC, fused epilogues) through ``TransferLearning.Builder``
   (``FineTuneConfiguration`` with Adam 1e-4, ``setFeatureExtractor`` on
   the last leaky activation, ``removeLayersFromOutput(2)``, a new 1x1
   conv of 5 * (5 + 10) and a ``Yolo2OutputLayer`` with the same anchors)
   into a 10-class detector on seeded label grids: 8 eager steps twice
   and 2 captured dispatches of K=4 from one state, cuDNN deterministic,
   held to the bit (the rule with ``exact``); every frozen param and its
   Adam moments bit-equal after each run, every head param moved, 8
   ``scale_shift_act`` launches a forward (the frozen prefix's 8 fused
   blocks) and 32 recorded at capture, finite losses (not required to
   fall: TinyYOLO's loss spikes). Then ``TransferLearningHelper``:
   ``featurize`` over 4 batches ([32, 1024, 13, 13]) and
   ``fitFeaturized`` for one epoch; the source TinyYOLO's params are
   untouched.
31. ``SameDiffLayer``: the gated dense fragment of
   ``tests/test_attention_layers.py`` (``sigmoid(x Wg) * tanh(x W)``) at
   768 -> 768 in a ``MultiLayerNetwork``, B=256, fp32, Adam: 4 eager
   steps twice and one captured dispatch of K=4 from one state, held to
   the bit, no capture failure.
32. DataVec feeds nets on the card (``data.records``, ``data.audio``; the
   datasets written to a temporary directory by
   ``data.datavec_fixtures`` from ``numpy.random.RandomState`` seeds).
   (a) 262,144 rows of dl4j-examples' ``BasicDataVecExample`` transaction
   table (~13 MB of CSV) through ``CSVRecordReader``, the example's
   ``TransformProcess`` (the IDs removed, a filter keeping USA and CAN,
   the country one-hot, the date string to a time, ``hourOfDay``
   derived, the time removed, the amount standardized),
   ``CollectionRecordReader`` and ``RecordReaderDataSetIterator(B=1024,
   FraudLabel, 2 classes)`` into an MLP (three ``DenseLayer(256, relu)``,
   ``OutputLayer(2, softmax, mcxent)``, Adam 1e-3): one epoch eager twice
   and one at ``steps_per_dispatch=4`` from one state, held by the rule
   below, then a second epoch at K=4. (b) the UCI synthetic control
   charts (600 sequences x 60 steps, 6 classes; one ``value,label`` CSV
   a sequence) through ``CSVSequenceRecordReader`` and
   ``SequenceRecordReaderDataSetIterator(B=10, label -1, 6 classes)``,
   standardized by ``NormalizerStandardize``, into dl4j-examples'
   ``UCISequenceClassification`` net (``LSTM(10, tanh)``,
   ``RnnOutputLayer(6, softmax, mcxent)``, Adam 5e-3), 5 epochs (the
   example's 40 cut), the first eager and the rest at K=4 (one capture). (c) 1,024 clips in Speech Commands' format (1 s, 16
   kHz, 16-bit mono, 8 word directories) through
   ``WavFileRecordReader(feature="mfcc", n_frames=124)`` and
   ``AudioDataSetIterator(B=64)``, standardized, shuffled once into
   batches of 64 (the reader lists the files a directory at a time),
   into ``Convolution1D(3, 64, same)`` -> ``BatchNormalization`` ->
   ``Convolution1D(3, 64, same)`` -> ``BatchNormalization`` ->
   ``GlobalPoolingLayer("avg")`` -> ``OutputLayer(8)``, 2 epochs. Each
   path: the net's parameters on the card, every loss finite, the last
   epoch's mean loss below the first's, the first step's loss within
   1e-4 of the same net's first step on the CPU from the same parameters
   and batch (relative). It prints the rows/s of reading, transforming and
   iterating, the clips/s of decoding and MFCC, and the step ms.
33. The analyzer against the card (``deeplearning4j_tpu_torch.analysis``,
   static: no tensor, no ``init``). (a) The CLI in-process:
   ``main(["--zoo"])`` exits 0 with "16 model(s) linted: 16 clean", and
   ``main(["--cost", "--chip", "h100-sxm", "ResNet50"])`` exits 0. (b) For
   ResNet-50 (B=64, bf16), TinyYOLO (B=32, bf16), LeNet-5 (B=64, fp32),
   VGG16 (B=64, bf16), Darknet19 (B=32, bf16) and YOLO2 (B=32, bf16),
   their phases' configurations at K=4: ``analyze(conf, batch_size=B,
   cost=CostSpec(chip="h100-sxm", precision=..., steps_per_dispatch=4))``
   must hold no E-code (each of them ran); then the cost model's
   predicted step ms and planned peak bytes beside the captured step ms
   and the ``max_memory_allocated()`` their phases measured (14, 16, 17,
   18, 19; less the bytes already live before each net was built, which
   the process's earlier phases hold), with ``cost_model_ratio`` =
   measured / predicted. Every ratio
   finite and every step ratio >= 1: a roofline the card beats has a
   wrong FLOP or byte count, or a wrong peak. The other zoo CNNs of
   phase 20 (eager steps) are printed beside theirs, not gated. (c)
   Phase 22's pipeline as an ``InputPipelineSpec`` (its workers, B=64,
   K=4, uint8, its measured decode ms an image and pinned H2D MB/s, and
   phase 14's in-memory ResNet-50 rate as the device rate): whether W108
   fires, printed beside phase 22's from-disk and in-memory rates (not
   gated). (d) ``init(strict=True)`` on a seeded E001 configuration
   raises ``ModelValidationError`` and ``torch.cuda.memory_allocated()``
   does not move. (e) The Hopper W101 rule measured: CUDA-event medians
   (L2 flushed) of a bf16 ``torch.matmul`` [8192, 4096] x [4096, N] at N
   in 296, 300, 304, 384, 424, 425 and 512, beside the padded N and the
   waste the rule computes and whether it fires; and of YOLO2's head, a
   1x1 bf16 NHWC conv over [32, 1024, 13, 13], forward and forward +
   backward, at 424, 425 and 432 output channels; and of LeNet's dense,
   bf16 [64, 800] x [800, N] at N in 496, 500 and 504 (the rule judges
   each under bf16). (f) ``ModelServer.validate(shapes=,
   hbm_gb=74.5, cost="h100-sxm")`` on a served ResNet-50 (fp32, 1000
   classes, B <= 32, warmed, answering 8 requests): its report holds no
   E111, E121 or E122; the net's own ``validate()`` (on the card, NCHW)
   gives the conv-stack W101, and none after ``setComputeLayout("NHWC")``.
34. Observability (:func:`observability`; cuDNN held to deterministic
   algorithms). (a) TinyYOLO (phase 9's: bf16, 416², B=32) K=4 captured
   under ``NAN_PANIC``: ``FaultPlan(nan_layer_params_at={5: <the first
   conv after the input>})`` must raise ``NonfiniteAttributionError``
   naming that conv, op ``params``, step 5 (a poison lands at a dispatch
   boundary: steps 1, 5, 9), and a NaN batch at step 7, mid-dispatch,
   ``<input>``, ``batch``, step 7 (the replay rolls the step-0 snapshot 6
   steps); after each raise every state tensor equals, to the bit, a
   twin's that ran the same dispatches with the mode OFF; each raise
   leaves exactly one flight-recorder bundle, ``fit:NonfiniteAttribution
   Error``, whose trace (tracing on for the fit) holds the ``train:run``
   span with the run's ``run_id`` and the fit's spans stamped with it;
   the replay's
   seconds and ``scale_shift_act`` launches are printed. (b) ResNet-50
   B=64 K=4 captured, ms a step over ``OBS_DISPATCHES`` dispatches in
   turns OFF, NAN_PANIC, NAN_PANIC, OFF from one state; the losses of all
   four bit-equal; the overhead printed. (c) TextGenerationLSTM (phase
   21's) through ``fitTBPTT``: a NaN in window 3 names ``<input>``,
   ``batch``, step 3. (d) ``track_value_ranges(True)`` on TinyYOLO bf16:
   one ``dl4j_tensor_absmax`` sample a layer for a step,
   ``dl4j_overflow_proximity`` in (0, 1). (e)
   ``devicetime.measure(mode="trace")`` on ResNet-50 B=64 (bf16, NHWC,
   fused) and on BERT-base as served (B=32, T=128, bf16, flash): every
   conv and BN (attention and LN) layer has a row with seconds > 0; the
   kernels in BN scopes count exactly 33 ``scale_shift_act`` a forward
   (12 flash in attention scopes and 25 LN in LN scopes on BERT) and
   none elsewhere; the rows sum to no more than the eager forward's
   CUDA-event time; ``top_offenders`` with MFU against 989 TFLOP/s and
   sync mode beside trace mode. (f) ``ProfilingListener`` over three
   captured ResNet-50 steps (one step a dispatch) writes a Chrome trace
   that parses as JSON; its kernel events under replay are counted. (g)
   LeNet-5 (phase 16's data) with ``StatsListener`` into
   ``InMemoryStatsStorage`` at frequency 1 (a record a step, finite
   scores) and a ``UIServer``: ``/api/sessions``, ``/api/overview``,
   ``/api/model``, ``/metrics``, ``/trace`` answer 200; ms a step with
   and without the listener. (h) BERT-base behind ``HttpIngress`` +
   ``ModelRegistry`` (phase 15's front door, v1) with a
   ``MetricsAggregator`` fed by a ``FleetScraper`` from the ingress's
   ``/metrics`` and a ``UIServer``'s, and an ``SLOGate`` (p99 under 250
   ms, availability 0.99): 300 requests at 150 requests/s
   (``ServingLoad.seeded``), all 200; ``/v1/fleet/metrics`` (merging both
   hosts), ``/v1/fleet/load`` and ``/v1/slo`` answer 200; the verdict and
   its burn rates are printed.
35. The op surface on the card (:func:`op_surface`). (a) Every one of
   ``ops.validation``'s 514 OpCases (505 ops) with its args on ``cuda``
   through ``run_case``: its golden, finite outputs all on the card, the
   random statistics, and the 151 float64 gradchecks on the card; each
   non-random case held to the same case on the CPU at its own tolerance
   (decompositions by what they reconstruct and their spectra). Every failing case is listed before
   the phase fails. (b) bench.py's GemmBench through ``NDArray.mmul``:
   bf16, n=16384, 30 chained products, CUDA-event medians of 3, TFLOP/s
   against the 989 dense bf16 peak beside the card's name and power
   limit (and a ``torch.matmul`` chain). (c) The kernels through the new
   surface at phase 2's shapes: ``Transforms.softmax`` of an NDArray
   [49152, 128] fp32, ``exec_op`` of ``layer_norm`` [16384, 768] fp32,
   ``scale_shift_act`` [802816, 64] bf16 relu and ``flash_attention``
   q,k,v [32, 512, 12, 64] bf16: each launches its kernel exactly once
   (``ndarray_launches``/``exec_op_launches`` on the kernels line) and
   matches its plain version at phase 2's tolerances. (d) ``exec_op``
   under NAN_PANIC raises ``NumericsPanicError`` naming ``log`` and
   ``softmax`` (through the kernel); µs a call for a 16-float ``add``
   OFF, BASIC and bare: under OFF no call reaches the instrumented
   dispatch (under BASIC every one does), and OFF's extra over the bare
   call is under half of BASIC's. (e) ``shapes.infer_shape`` over every
   case with array args: tensors on ``meta`` only, card memory
   unchanged, no kernel launched. (f) The conv ops' shape contract
   (``ops.shapes.check_call``, checked once per distinct call) on the
   eager path: ResNet-50 B=64 bf16 NHWC fused, ms an eager ``output()``
   and an eager ``fit`` step in turns with the contract as shipped and
   stubbed out, alternating call by call (on/off/off/on; 24 forwards
   and 8 steps each), the checks a forward counted, and µs a check
   cached and uncached; printed, not gated on time.
36. SameDiff's draws under capture, the compile cache's disk tier, the
   autotuner and strict serving warmup (:func:`rng_disk_tune`). (a) A
   SameDiff MLP ([64, 1024] + ``random.normal`` noise -> 4096 relu ->
   ``nn.dropout(0.5)`` -> 10, Adam 1e-3) fit 6 steps through the captured
   dispatch: one capture; the hidden masks (copied out inside the graph
   by probes around ``dropout_mask`` and ``normal_draw``) keep 0.5 +-
   0.01 and change every step, the noise keeps N(0, 1) within 0.01, and
   a refit from the saved state draws the same masks and losses. (b)
   Two fresh interpreters fit ResNet-50 (bf16, NHWC, fused, B=64, K=4, 8
   steps) over one ``compilecache.configure`` directory: the first
   writes the manifest (one disk miss), the second captures its
   signature at warm start (4 x 33 ``scale_shift_act`` launches
   recorded), misses nothing in memory and counts one disk hit; a
   corrupted manifest is quarantined and a fresh net still fits; W112
   fires without a directory and not with one. (c) ``python -m
   deeplearning4j_tpu_torch.tune`` on ResNet-50 (B=64, 224^2) through its
   ``main(argv)`` (budget 8, 2 reps of 8 steps, K <= 4, pruned by the
   H100 cost model; every trial's step captured before it is timed):
   each trial's plan and ms a step, the pruned plans,
   the winner's speed-up over the fp32 NCHW default and the parity
   verdict; a fresh net's ``fit(tune="auto")`` then applies the recorded
   plan (a fused NHWC winner's ``scale_shift_act`` launches counted). (d)
   ``ModelServer.warmup(strict=True, cost="h100-sxm")`` on phase 6's
   SameDiff BERT-base passes; on a chip of 1 MB it raises E121 or E122.
37. Continuous training (``lifecycle/``): BERT-base (pre-LN, bf16,
   flash) v1 served captured by ``ModelRegistry(batch_limit=32,
   head="argmax")`` whose servers record every request into a
   ``TrafficCapture``; what the capture costs a submit (200 each way,
   one server); one thread submits ``ServingLoad.seeded(0, "steady",
   rps=150, max_rows=8)`` for the whole phase; a BertBench-shaped step
   (B=64, T=128, Adam at ``LC_LR``) from v1's parameters, captured once
   before the traffic, trains 4 steps a round and hands over a snapshot
   (``transformer.copy_params``); ``EvalGate()`` in parity mode on 64
   captured rows; ``FaultPlan(trainer_death_at_roll=2,
   bad_candidate_at={3: "nan"}, slo_regression_during_canary=4)`` over 5
   rounds from a state naming v1 the incumbent, the trainer a
   ``spawn_trainer_process()`` SIGKILLed at roll 2 and a second driver
   over the same state directory resuming. Checks: v5 served at the end,
   the resumed driver ``resumed``, quarantines ``gate:non_finite_outputs``
   (never loaded) then ``slo_regression``, one rollback whose served ids,
   restored logits and parameters equal the pre-roll ones to the bit,
   every request resolved once (errors ``ServingError`` kinds), no
   capture or recompile after warmup in any version and one capture of
   the train step, 12 flash and 25 layer-norm launches in every replay,
   the state file idle at round 5, memory after round 5 within a
   version's footprint of round 2's (spent versions retired, their
   graphs dropped). Printed: each round's seconds (train, gate, load and
   capture, canary and confirm) and memory, the gate and roll histograms,
   each verdict's ``parity_rel``, request latency p50/p99, the
   incumbent's longest gap between batches during each load.

The captured-against-eager rule: where the two eager runs agree to the
bit on a tensor (and on the params' group: the param and its Adam
moments), the captured run must too; where they do not (atomics in a
backward sum in another order each run), the phase names the tensors and
holds the captured run within twice the eager-against-eager max
difference of each, and at least one unit in the last place of the
tensor's dtype at its largest magnitude (a rounding flip the two eager
runs happened not to make).

Tolerances: layer norm and flash fp32 ``rtol=atol=2e-5`` (as
``tests/test_pallas.py``), bf16 ``rtol=atol=2e-2`` (a few bf16 ulps: both
sides round the same fp32 value, summed in another order), lse 1e-5
absolute in fp32. ``scale_shift_act``: fp32 1e-6 relative, bf16 1 ulp
(kernel and plain both round the exact ``x*scale+shift`` once to fp32,
then once to bf16, so they agree to the bit but for double-rounding
ties), a NaN in must come out NaN. Softmax: fp32 ``rtol=1e-5, atol=1e-6``
(as ``tests/test_pallas.py``), bf16 one ulp (2^-7 relative), NaN where
the plain version has NaN. Gradients through the layer-norm and flash
overrides (composed backwards) against autograd through their plain
versions: 2e-4 absolute (fp32 values of order one). ``bn_stats``: fp32
sums against an fp64 sum, |d sum| <= 1e-5 sum|x| and |d sumsq| <= 1e-5
sumsq, NaN where the fp64 sum is NaN; ``bn_apply_leaky`` as
``scale_shift_act`` (fp32 1e-6 relative, bf16 one ulp, NaN kept).

Output: progress lines, then a JSON line ``{"kernels": [...]}`` (the
flash and layer-norm ``launches`` are phase 3's warmup launches plus its
replays, softmax's phase 6's; ``replays`` counts the replayed ones;
``scale_shift_act``'s are phase 4's, its TinyYOLO row phase 9's, its
Darknet19 row phase 18's and its YOLO2 row phase 19's eager steps;
``from_disk_launches`` and ``from_disk_replays`` are phase 22's capture
and replays; ``import_launches`` and ``import_train_launches`` are phase
23's served launches (warmup and replays) and its train steps';
``long_run_launches`` phase 25's capture; ``keras_launches`` phase 28's:
layer norm's served at T=128 and at T=1024, flash's at T=1024;
``transfer_launches`` phase 30's recorded at its K=4 capture;
``sanitizer_launches`` phase 34 (a)'s replays and walks;
``ndarray_launches`` and ``exec_op_launches`` phase 35 (c)'s;
``samediff_capture_launches`` phase 7's capture (softmax and layer
norm); ``disk_warm_launches`` phase 36 (b)'s warm start;
``tune_launches`` phase 36 (c)'s tuned fit (``scale_shift_act``);
``lifecycle_launches`` and ``lifecycle_replays`` phase 37's flash and
layer norm, launched (the gate's forwards, the candidates' warm-up runs
and captures) and replayed (served batches and train steps)), the
``nvidia-smi`` name/power-limit line, and as the last line
``{"ok": true, "device": {...}}``. Without a card, or outside a
checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOPS = 989e12            # dense bf16 tensor-core peak
FP32_FLOPS = 67e12             # fp32 outside the tensor cores
TIMED_RUNS = 30
#: device spin before each timed launch (~0.5 ms at 1.98 GHz): the card is
#: still busy when the host has queued the events and the launch, so the
#: wrapper's Python time never lands between the two events
SPIN_CYCLES = 1_000_000
RESNET_BATCH = 64
RESNET_STEPS = 5
#: BERT-base as modelimport/bert.py infers it, with a 2-label head
BERT_SD = dict(V=30522, E=768, H=12, L=12, F=3072, T=128, max_len=512,
               n_labels=2)
SD_BATCH = 32
SD_STEPS = 6
YOLO_BATCH = 32
YOLO_STEPS = 5
YOLO_CLASSES = 20
BERT_STEPS = 5
MEGA_K = 4
VGG_BATCH = 64
VGG_STEPS = 5
DARKNET_BATCH = 32
DARKNET_STEPS = 3
YOLO2_BATCH = 32
YOLO2_STEPS = 3
YOLO2_CLASSES = 80
#: phase 20's zoo CNNs, each at its default input shape and classes
ZOO_CNNS = ("AlexNet", "SqueezeNet", "UNet", "Xception", "FaceNetNN4Small2",
            "InceptionResNetV1", "NASNet")
ZOO_BATCH = 16
ZOO_STEPS = 3
LENET_EPOCHS = 4
#: phase 21: dl4j-examples' LSTMCharModellingExample (minibatches of 32
#: sequences of 1000 characters, TBPTT windows of 50, 4 samples of 300)
TEXT_BATCH = 32
TEXT_BATCHES = 3
TEXT_SAMPLES = 4
TEXT_SAMPLE_LEN = 300
TEXT_SEED = 0
#: phase 22: bench.py's DataPipelineBench data (1024 noise JPEGs, 256^2,
#: quality 85, 8 classes) decoded to 224^2, B=64, K=MEGA_K, 2 epochs
DISK_IMAGES = 1024
DISK_SIDE = 256
DISK_HW = 224
DISK_CLASSES = 8
DISK_BATCH = 64
DISK_EPOCHS = 2
#: phases 23-24: BERT-base by import, served at T=128, trained at B=32
IMPORT_T = 128
IMPORT_BATCH = 32
IMPORT_STEPS = 5
IMPORT_FIT_STEPS = 6
#: phase 25: a long ResNet-50 run from disk: phase 22's JPEGs decoded at
#: 256^2, a random 32-pixel crop to 224^2, a random flip and ImageNet's
#: normalization on the card, Nesterovs (momentum 0.9) under a step decay
#: of 0.1 every 16 steps from 0.1, B=64, K=4, 2 epochs (32 steps)
LONG_SIDE = 256
LONG_CROP = 32
LONG_EPOCHS = 2
LONG_EVERY = 8
LONG_PREEMPT = 12
LONG_NAN = 20
LONG_STOP = 24
IMAGENET_MEAN = (123.675, 116.28, 103.53)     # 255 * (0.485, 0.456, 0.406)
IMAGENET_STD = (58.395, 57.12, 57.375)        # 255 * (0.229, 0.224, 0.225)
#: phase 28: the Keras encoder at BERT-base's widths, 108,891,650
#: parameters (the encoder's 108,890,112 and a 2-class head), served at
#: T=128, B <= 32; its depth-2 copy with 1024 positions at [4, 1024]
KERAS_T = 128
KERAS_BATCH = 32
KERAS_PARAMS = 108_891_650
KERAS_LONG_T = 1024
KERAS_LONG_B = 4
#: phase 26: TinyYOLO under fp16 dynamic loss scaling, 8 dispatches of 4
#: (from 2^24 its first 14 steps overflow on the H100: 12 steps would
#: show the backoff but no update)
DYN_STEPS = 32
#: phase 27: LeNet-5 under early stopping
ES_MAX_EPOCHS = 10
ES_PATIENCE = 2
#: phase 29: ResNet-50 v1 from an ONNX file, served at B <= 32, 224^2, fp32;
#: the imported logits against the ComputationGraph's within ONNX_LOGIT_TOL
#: of the largest logit, its softmax against output() within ONNX_PROB_TOL
#: (the first card run measured 5.6e-7 of the largest logit and 3.4e-10)
ONNX_BATCH = 32
ONNX_REQUESTS = 64
ONNX_LOGIT_TOL = 1e-5
ONNX_PROB_TOL = 1e-6
#: phase 30: TinyYOLO fine-tuned into a 10-class detector (HouseNumber-
#: Detection's shape of transfer), 8 eager steps and 2 dispatches of K=4,
#: then TransferLearningHelper over 4 featurized batches
TRANSFER_CLASSES = 10
TRANSFER_STEPS = 8
TRANSFER_FEATURIZE = 4
#: phase 31: the gated dense SameDiffLayer at 768 -> 768, B=256
SDL_WIDTH = 768
SDL_BATCH = 256
#: phase 32: DataVec. (a) transactions at B=1024 into a 3 x 256 MLP;
#: (b) the 600 UCI control charts at B=10, 5 epochs; (c) 1024 clips of
#: 1 s at 16 kHz (124 MFCC frames) at B=64, 2 epochs
DV_ROWS = 262144
DV_BATCH = 1024
DV_WIDTH = 256
DV_CHART_BATCH = 10
DV_CHART_EPOCHS = 5
DV_CLIPS = 1024
DV_CLIP_BATCH = 64
DV_CLIP_FRAMES = 124
DV_CLIP_EPOCHS = 2
#: a path's first step on the card against the CPU's (relative)
DV_CPU_TOL = 1e-4
#: phase 34 (b): K=4 dispatches in each of the four timed runs
OBS_DISPATCHES = 8
#: phase 33: (phase name, zoo class, its kwargs, batch, policy) of the nets
#: whose captured K=4 steps the cost model is held against
ANALYZER_NETS = (
    ("ResNet-50", "ResNet50", {"num_classes": 1000}, RESNET_BATCH, "bf16"),
    ("TinyYOLO", "TinyYOLO", {"num_classes": YOLO_CLASSES}, YOLO_BATCH,
     "bf16"),
    ("LeNet-5", "LeNet", {"num_classes": 10}, 64, None),
    ("VGG16", "VGG16", {"num_classes": 1000}, VGG_BATCH, "bf16"),
    ("Darknet19", "Darknet19", {"num_classes": 1000}, DARKNET_BATCH, "bf16"),
    ("YOLO2", "YOLO2", {"num_classes": YOLO2_CLASSES}, YOLO2_BATCH, "bf16"))
#: phase 33 (e): the bf16 GEMM [M, K] x [K, N] the W101 rule is timed on
LAYOUT_M, LAYOUT_K = 8192, 4096
#: (424 and 425: the widths of YOLO2's 425-channel head)
LAYOUT_NS = (296, 300, 304, 384, 424, 425, 512)
#: phase 33 (e): YOLO2's head conv (1x1, 1024 in) at its 425 channels
#: and the aligned neighbours
HEAD_CONV_CIN, HEAD_CONV_NS = 1024, (424, 425, 432)
#: phase 33 (e): LeNet's 500-wide dense at B=64 (800 in) and neighbours
LENET_DENSE_M, LENET_DENSE_K, LENET_DENSE_NS = 64, 800, (496, 500, 504)
#: phase 37: tokens a request row, train steps a round, the steady
#: schedule's length (150/s; the phase stops it when its rounds are done),
#: submits timed each way, seconds between the judge's ticks
LC_SEQ, LC_STEPS, LC_REQUESTS, LC_SUBMIT_SAMPLES, LC_TICK_S = \
    128, 4, 150 * 240, 200, 0.5
#: phase 37's fine-tuning rate: 4 Adam steps of 1e-4 (BertBench's) from
#: v1 put a healthy candidate at parity_rel 1.29, over the gate's 0.25
#: (PERF.md §6); 1e-5, a BERT fine-tuning rate, keeps 0.02-0.03
LC_LR = 1e-5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi exited {out.returncode}: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "deeplearning4j_tpu_torch")):
        fail(f"no deeplearning4j_tpu_torch package beside {__file__}: run "
             "from the root of a checkout")
    sys.path.insert(0, root)
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.benchmarks import probe_bn_leaky
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn import compilecache as cc
    from deeplearning4j_tpu_torch.nn.objdetect import YoloUtils, yolo_labels
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.serving import (ModelServer,
                                                  samediff_forward)
    from deeplearning4j_tpu_torch.train.updaters import Adam

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()

    # ------------------------------------------------------ 1. environment
    log(f"card: {smi}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    paths = ck.build()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s for "
        f"{', '.join(p.name for p in paths.values())}")
    for name in ("flash_attention", "layer_norm", "bn_leaky"):
        for fn, regs, st, ld in ck.ptxas_report(name):
            log(f"ptxas {name}: {fn}: {regs} registers, spill stores {st} B, "
                f"spill loads {ld} B")

    # ------------------------------------------- 2. kernels against plain
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def rand(*shape, dtype=torch.float32, scale=1.0, shift=0.0):
        x = torch.randn(shape, generator=gen, device=dev) * scale + shift
        return x.to(dtype)

    def tol(dtype):
        return 2e-5 if dtype == torch.float32 else 2e-2

    def check(name, got, want, dtype, atol=None):
        a = tol(dtype) if atol is None else atol
        r = tol(dtype) if atol is None else 0.0
        err = (got.float() - want.float()).abs()
        bad = err > a + r * want.float().abs()
        if bool(bad.any()):
            fail(f"{name}: max |err| {err.max().item():.3g} over "
                 f"atol={a:g} rtol={r:g} at {int(bad.sum())} element(s)")
        return float(err.max().item())

    def time_ms(fn):
        for _ in range(3):
            fn()
        ts = []
        for _ in range(TIMED_RUNS):
            flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return float(np.median(ts))

    # the serving path's LN rows are B*T for T in (128, 512), B <= 32;
    # then both routes (a warp per row up to D=1024, a block above), 16-byte
    # and scalar loads, and row counts off the 8 rows of a warp-route block
    ln_cases = [(4096, 768), (16384, 768), (1000, 1024), (4093, 768)]
    ln_cases += [(1001, d) for d in (33, 768, 1000, 1024, 1025, 4096, 8192)]
    for n, d in ln_cases:
        for dt in (torch.float32, torch.bfloat16):
            x = rand(n, d, dtype=dt, scale=2.0, shift=0.5)
            g, b = rand(d, scale=0.5, shift=1.0), rand(d, scale=0.1)
            y = ck.layer_norm_fwd(x, g, b, 1e-5)
            torch.cuda.synchronize()
            e = check(f"layer_norm [{n},{d}] {dt}", y,
                      ck.layer_norm_plain(x, g, b, 1e-5), dt)
            log(f"layer_norm [{n}, {d}] {str(dt)[6:]}: max|err| {e:.3g}")

    flash_cases = [(2, T, 12, 64, dt, c) for T in (128, 512)
                   for dt in (torch.float32, torch.bfloat16)
                   for c in (False, True)]
    flash_cases.append((32, 512, 12, 64, torch.bfloat16, False))
    flash_cases.append((2, 256, 6, 128, torch.bfloat16, False))
    flash_cases.append((2, 256, 6, 128, torch.float32, True))
    # the tensor-core route's edges: every D, causal or not, ragged T
    flash_cases += [(2, T, 3, D, torch.bfloat16, c) for D in (64, 128, 192, 256)
                    for c in (False, True) for T in (1, 63, 64, 65, 200, 512)]

    def check_flash(name, q, k, v, causal, route):
        """The wrapper's call, which must take ``route``, against the plain
        version."""
        ck.reset_counts()
        o, lse = ck.flash_attention_fwd(q, k, v, causal)
        if ck.FLASH_ROUTES[route] != 1:
            fail(f"{name}: took {ck.FLASH_ROUTES}, want the {route} route")
        torch.cuda.synchronize()
        op, lp = ck.flash_attention_plain(q.contiguous(), k.contiguous(),
                                          v.contiguous(), causal)
        e = check(name, o, op, q.dtype)
        el = check(name + " lse", lse, lp, q.dtype, atol=1e-5)
        log(f"{name} [{route}]: max|err| o {e:.3g}, lse {el:.3g}")
        return e

    for B, T, H, D, dt, causal in flash_cases:
        q, k, v = (rand(B, T, H, D, dtype=dt) for _ in range(3))
        check_flash(f"flash_attention B={B} T={T} H={H} D={D} {dt} "
                    f"causal={causal}", q, k, v, causal,
                    "tensor_core" if dt == torch.bfloat16 else "cuda_core")
    for tq, tk in ((100, 300), (300, 100)):
        for causal in (False, True):
            q = rand(2, tq, 3, 64, dtype=torch.bfloat16)
            k, v = (rand(2, tk, 3, 64, dtype=torch.bfloat16) for _ in range(2))
            check_flash(f"flash_attention Tq={tq} Tk={tk} causal={causal}",
                        q, k, v, causal, "tensor_core")
    # q, k, v as the QKV projection leaves them: thirds of one [B, T, 3E]
    qkv = rand(2, 200, 3 * 12 * 64, dtype=torch.bfloat16)
    q, k, v = (t.reshape(2, 200, 12, 64) for t in qkv.split(768, dim=-1))
    check_flash("flash_attention strided thirds", q, k, v, False,
                "tensor_core")
    # an unaligned bf16 view (2-byte offset, odd t stride): the CUDA cores
    buf = rand(2, 200, 3 * 64 + 1, dtype=torch.bfloat16)
    q = buf[..., 1:].reshape(2, 200, 3, 64)
    check_flash("flash_attention unaligned view", q, q, q, True, "cuda_core")

    def timed_row(shape, err, kernel, plain, library, nbytes, ops, peak):
        row = {"shape": shape, "max_abs_err": err, "ms": time_ms(kernel),
               "plain_ms": time_ms(plain), "library_ms": time_ms(library)}
        row.update(bound(nbytes, ops, peak))
        return row

    # timing at the serving path's shapes, B=32 and T in (128, 512), and
    # the BertBench train step's, B=64 and T=128: LN on [B*T, E] fp32;
    # flash on H=12, D=64 bf16, non-causal (the first row of each is the
    # kernels line's; the others go under other_shapes)
    ln_rows = []
    for N in (32 * 128, 32 * 512, 64 * 128):
        E = 768
        x = rand(N, E, scale=2.0, shift=0.5)
        g, b = rand(E, scale=0.5, shift=1.0), rand(E, scale=0.1)
        err = check(f"layer_norm [{N}, {E}]", ck.layer_norm_fwd(x, g, b, 1e-5),
                    ck.layer_norm_plain(x, g, b, 1e-5), torch.float32)
        ln_rows.append(timed_row(
            f"x [{N}, {E}] float32", err,
            lambda: ck.layer_norm_fwd(x, g, b, 1e-5),
            lambda: ck.layer_norm_plain(x, g, b, 1e-5),
            lambda: F.layer_norm(x, (E,), g, b, 1e-5),
            2 * N * E * 4 + 2 * E * 4, 8 * N * E, FP32_FLOPS))
        del x
    # phase 23's LN: the imported BERT-base's [B*T, E] fp32 rows, eps 1e-12
    N, E = IMPORT_BATCH * IMPORT_T, 768
    x = rand(N, E, scale=2.0, shift=0.5)
    g, b = rand(E, scale=0.5, shift=1.0), rand(E, scale=0.1)
    err = check(f"layer_norm [{N}, {E}] eps 1e-12",
                ck.layer_norm_fwd(x, g, b, 1e-12),
                ck.layer_norm_plain(x, g, b, 1e-12), torch.float32)
    ln_rows.append(timed_row(
        f"x [{N}, {E}] float32, eps 1e-12 (phase 23's imported BERT-base, "
        f"B={IMPORT_BATCH}, T={IMPORT_T})", err,
        lambda: ck.layer_norm_fwd(x, g, b, 1e-12),
        lambda: ck.layer_norm_plain(x, g, b, 1e-12),
        lambda: F.layer_norm(x, (E,), g, b, 1e-12),
        2 * N * E * 4 + 2 * E * 4, 8 * N * E, FP32_FLOPS))
    del x
    ln = {"name": "layer_norm", "route": "cuda",
          "source": "deeplearning4j_tpu_torch/ops/csrc/layer_norm.cu",
          "replaces": "deeplearning4j_tpu/ops/pallas_kernels.py:72",
          **ln_rows[0], "other_shapes": ln_rows[1:]}

    fa_rows = []
    for B, T in ((32, 128), (32, 512), (64, 128)):
        H, D = 12, 64
        q, k, v = (rand(B, T, H, D, dtype=torch.bfloat16) for _ in range(3))
        ck.reset_counts()
        err = check(f"flash_attention [{B}, {T}, {H}, {D}]",
                    ck.flash_attention_fwd(q, k, v, False)[0],
                    ck.flash_attention_plain(q, k, v, False)[0],
                    torch.bfloat16)
        if ck.FLASH_ROUTES["tensor_core"] != 1:
            fail(f"flash at the main shape took {ck.FLASH_ROUTES}")
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        fa_rows.append(timed_row(
            f"q, k, v [{B}, {T}, {H}, {D}] bfloat16, non-causal", err,
            lambda: ck.flash_attention_fwd(q, k, v, False),
            lambda: ck.flash_attention_plain(q, k, v, False),
            lambda: F.scaled_dot_product_attention(qh, kh, vh),
            4 * B * T * H * D * 2 + B * H * T * 4, 4 * B * H * T * T * D,
            BF16_FLOPS))
        del q, k, v, qh, kh, vh
    # phase 23's flash: fp32 on the CUDA-core route, against fp32 SDPA
    B, T, H, D = IMPORT_BATCH, IMPORT_T, 12, 64
    q, k, v = (rand(B, T, H, D) for _ in range(3))
    ck.reset_counts()
    err = check(f"flash_attention [{B}, {T}, {H}, {D}] float32",
                ck.flash_attention_fwd(q, k, v, False)[0],
                ck.flash_attention_plain(q, k, v, False)[0], torch.float32)
    if ck.FLASH_ROUTES["cuda_core"] != 1:
        fail(f"fp32 flash at phase 23's shape took {ck.FLASH_ROUTES}")
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    fa_rows.append(timed_row(
        f"q, k, v [{B}, {T}, {H}, {D}] float32, non-causal (phase 23's "
        "imported BERT-base, the CUDA-core route)", err,
        lambda: ck.flash_attention_fwd(q, k, v, False),
        lambda: ck.flash_attention_plain(q, k, v, False),
        lambda: F.scaled_dot_product_attention(qh, kh, vh),
        4 * B * T * H * D * 4 + B * H * T * 4, 4 * B * H * T * T * D,
        FP32_FLOPS))
    del q, k, v, qh, kh, vh
    # phase 28's flash: the Keras encoder's depth-2 copy at T=1024, fp32
    B, T, H, D = KERAS_LONG_B, KERAS_LONG_T, 12, 64
    q, k, v = (rand(B, T, H, D) for _ in range(3))
    ck.reset_counts()
    err = check(f"flash_attention [{B}, {T}, {H}, {D}] float32",
                ck.flash_attention_fwd(q, k, v, False)[0],
                ck.flash_attention_plain(q, k, v, False)[0], torch.float32)
    if ck.FLASH_ROUTES["cuda_core"] != 1:
        fail(f"fp32 flash at phase 28's shape took {ck.FLASH_ROUTES}")
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    fa_rows.append(timed_row(
        f"q, k, v [{B}, {T}, {H}, {D}] float32, non-causal (phase 28's "
        "imported Keras encoder at T=1024, the CUDA-core route)", err,
        lambda: ck.flash_attention_fwd(q, k, v, False),
        lambda: ck.flash_attention_plain(q, k, v, False),
        lambda: F.scaled_dot_product_attention(qh, kh, vh),
        4 * B * T * H * D * 4 + B * H * T * 4, 4 * B * H * T * T * D,
        FP32_FLOPS))
    del q, k, v, qh, kh, vh
    fa = {"name": "flash_attention", "route": "cuda",
          "source": "deeplearning4j_tpu_torch/ops/csrc/flash_attention.cu",
          "replaces": "deeplearning4j_tpu/ops/pallas_kernels.py:341",
          **fa_rows[0], "other_shapes": fa_rows[1:]}
    for kr in (ln, fa):
        for row in [kr] + kr["other_shapes"]:
            log(f"{kr['name']} at {row['shape']}: kernel {row['ms']:.4f} ms, "
                f"plain {row['plain_ms']:.4f} ms, library "
                f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']}) [{smi}]")

    # scale_shift_act at ResNet-50's epilogue shapes at B=64 (stem, then
    # the fused BNs of stages 0-3), a ragged row count, and C % 8 != 0
    def check_ssa(name, got, want, dtype):
        nan_w, nan_g = torch.isnan(want), torch.isnan(got)
        if not torch.equal(nan_w, nan_g):
            fail(f"{name}: NaN positions differ ({int(nan_w.sum())} want, "
                 f"{int(nan_g.sum())} got)")
        g = got.float().masked_fill(nan_w, 0.0)
        w = want.float().masked_fill(nan_w, 0.0)
        if not torch.equal(torch.isinf(g), torch.isinf(w)):
            fail(f"{name}: inf positions differ")
        fin = torch.isfinite(w)
        err = (g - w).abs().masked_fill(~fin, 0.0)
        if dtype == torch.float32:
            allowed = 1e-6 * w.abs()
        else:          # one bf16 ulp: 2^(exponent - 7); exact at zero
            allowed = torch.ldexp(torch.ones_like(w),
                                  torch.frexp(w)[1] - 8).masked_fill(w == 0, 0)
        bad = err > allowed
        if bool(bad.any()):
            fail(f"{name}: {int(bad.sum())} element(s) beyond the bound, "
                 f"max |err| {err.max().item():.3g}")
        return float(err.max().item())

    ssa_shapes = [(64 * 112 * 112, 64), (64 * 56 * 56, 64), (64 * 28 * 28, 128),
                  (64 * 14 * 14, 256), (64 * 7 * 7, 512), (1001, 72),
                  (997, 33)]
    for rows, c in ssa_shapes:
        for dt in (torch.float32, torch.bfloat16):
            x = rand(rows, c, dtype=dt, scale=2.0)
            sc, sh = rand(c, dtype=dt, scale=0.5, shift=1.0), rand(c, dtype=dt)
            for alpha in (0.0, 0.01):
                y = ck.scale_shift_act_fwd(x, sc, sh, alpha)
                torch.cuda.synchronize()
                e = check_ssa(f"scale_shift_act [{rows},{c}] {dt} "
                              f"alpha={alpha}", y,
                              ck.scale_shift_act_plain(x, sc, sh, alpha), dt)
                log(f"scale_shift_act [{rows}, {c}] {str(dt)[6:]} "
                    f"alpha={alpha}: max|err| {e:.3g}")
            del x
    for dt in (torch.float32, torch.bfloat16):
        x = rand(4096, 64, dtype=dt)
        x[::97, ::5] = float("nan")
        x[1::89, 3] = float("inf")
        x[2::89, 7] = -float("inf")
        sc, sh = rand(64, dtype=dt), rand(64, dtype=dt)
        for alpha in (0.0, 0.01):
            y = ck.scale_shift_act_fwd(x, sc, sh, alpha)
            torch.cuda.synchronize()
            if not bool(torch.isnan(y[::97, ::5]).all()):
                fail(f"scale_shift_act {dt} alpha={alpha}: a NaN input did "
                     "not come out NaN")
            check_ssa(f"scale_shift_act NaN/inf input {dt} alpha={alpha}", y,
                      ck.scale_shift_act_plain(x, sc, sh, alpha), dt)
        log(f"scale_shift_act {str(dt)[6:]}: NaN in -> NaN out at alpha 0 "
            "and 0.01, inf as the plain version")

    # timing at the stem epilogue, the largest of the fit step's 33
    rows, c = 64 * 112 * 112, 64
    x = rand(rows, c, dtype=torch.bfloat16, scale=2.0)
    sc = rand(c, dtype=torch.bfloat16, scale=0.5, shift=1.0)
    sh = rand(c, dtype=torch.bfloat16)
    ssa_err = check_ssa("scale_shift_act main shape",
                        ck.scale_shift_act_fwd(x, sc, sh, 0.0),
                        ck.scale_shift_act_plain(x, sc, sh, 0.0),
                        torch.bfloat16)
    ssa = {
        "name": "scale_shift_act", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/ops/csrc/scale_shift_act.cu",
        "replaces": "deeplearning4j_tpu/ops/pallas_kernels.py:203",
        "shape": f"x [{rows}, {c}] bfloat16, relu (ResNet-50 stem, B=64)",
        "max_abs_err": ssa_err,
        "ms": time_ms(lambda: ck.scale_shift_act_fwd(x, sc, sh, 0.0)),
        "plain_ms": time_ms(lambda: ck.scale_shift_act_plain(x, sc, sh, 0.0)),
        # no single PyTorch call computes it: two calls, the port never
        # makes them
        "library_ms": time_ms(lambda: torch.relu_(torch.addcmul(sh, x, sc))),
    }
    # an fp32 FMA per element on the CUDA cores
    ssa.update(bound(2 * rows * c * 2 + 2 * c * 2, 2 * rows * c,
                     FP32_FLOPS))
    del x
    # and at TinyYOLO's first epilogue at B=32: [32*416*416, 16] bf16, leaky
    rows, c = 32 * 416 * 416, 16
    x = rand(rows, c, dtype=torch.bfloat16, scale=2.0)
    sc = rand(c, dtype=torch.bfloat16, scale=0.5, shift=1.0)
    sh = rand(c, dtype=torch.bfloat16)
    err = check_ssa("scale_shift_act TinyYOLO shape",
                    ck.scale_shift_act_fwd(x, sc, sh, 0.01),
                    ck.scale_shift_act_plain(x, sc, sh, 0.01), torch.bfloat16)
    ssa["other_shapes"] = [timed_row(
        f"x [{rows}, {c}] bfloat16, leaky 0.01 (TinyYOLO's first block, "
        f"B={YOLO_BATCH})", err,
        lambda: ck.scale_shift_act_fwd(x, sc, sh, 0.01),
        lambda: ck.scale_shift_act_plain(x, sc, sh, 0.01),
        lambda: F.leaky_relu(torch.addcmul(sh, x, sc), 0.01),
        2 * rows * c * 2 + 2 * c * 2, 2 * rows * c, FP32_FLOPS)]
    del x
    # and at Darknet19's first epilogue at B=32: [32*224*224, 32] bf16, leaky
    rows, c = DARKNET_BATCH * 224 * 224, 32
    x = rand(rows, c, dtype=torch.bfloat16, scale=2.0)
    sc = rand(c, dtype=torch.bfloat16, scale=0.5, shift=1.0)
    sh = rand(c, dtype=torch.bfloat16)
    err = check_ssa("scale_shift_act Darknet19 shape",
                    ck.scale_shift_act_fwd(x, sc, sh, 0.01),
                    ck.scale_shift_act_plain(x, sc, sh, 0.01), torch.bfloat16)
    ssa["other_shapes"].append(timed_row(
        f"x [{rows}, {c}] bfloat16, leaky 0.01 (Darknet19's first block, "
        f"B={DARKNET_BATCH})", err,
        lambda: ck.scale_shift_act_fwd(x, sc, sh, 0.01),
        lambda: ck.scale_shift_act_plain(x, sc, sh, 0.01),
        lambda: F.leaky_relu(torch.addcmul(sh, x, sc), 0.01),
        2 * rows * c * 2 + 2 * c * 2, 2 * rows * c, FP32_FLOPS))
    del x
    # and at YOLO2's first epilogue at B=32: [32*416*416, 32] bf16, leaky
    rows, c = YOLO2_BATCH * 416 * 416, 32
    x = rand(rows, c, dtype=torch.bfloat16, scale=2.0)
    sc = rand(c, dtype=torch.bfloat16, scale=0.5, shift=1.0)
    sh = rand(c, dtype=torch.bfloat16)
    err = check_ssa("scale_shift_act YOLO2 shape",
                    ck.scale_shift_act_fwd(x, sc, sh, 0.01),
                    ck.scale_shift_act_plain(x, sc, sh, 0.01), torch.bfloat16)
    ssa["other_shapes"].append(timed_row(
        f"x [{rows}, {c}] bfloat16, leaky 0.01 (YOLO2's first block, "
        f"B={YOLO2_BATCH})", err,
        lambda: ck.scale_shift_act_fwd(x, sc, sh, 0.01),
        lambda: ck.scale_shift_act_plain(x, sc, sh, 0.01),
        lambda: F.leaky_relu(torch.addcmul(sh, x, sc), 0.01),
        2 * rows * c * 2 + 2 * c * 2, 2 * rows * c, FP32_FLOPS))
    del x

    # the BN+leaky probe's two kernels: the sums against an fp64 sum and
    # the apply against its plain version, row block by row block (C=1024
    # x M=5,537,792 fp32 is 22.7 GB), at every C x M and both dtypes, then
    # with a NaN
    def check_bn(c, m, dtype, nan=False):
        x = torch.randn((c, m), generator=gen, device=dev)
        x = x.mul_(1.5).add_(0.25).to(dtype)
        if nan:
            x[c // 2, m // 3] = float("nan")
        s, q = ck.bn_stats(x)
        sc = rand(c, scale=0.5, shift=1.0)
        sh = rand(c)
        y = ck.bn_apply_leaky(x, sc, sh, 0.1)
        torch.cuda.synchronize()
        name = f"bn [{c}, {m}] {str(dtype)[6:]}{' NaN' if nan else ''}"
        es = ey = 0.0
        step = max(1, (1 << 27) // m)
        for r0 in range(0, c, step):
            r1 = min(c, r0 + step)
            x64 = x[r0:r1].double()
            s64, q64 = x64.sum(1), x64.square().sum(1)
            for got, want, scale, what in (
                    (s[r0:r1], s64, x64.abs().sum(1), "sum"),
                    (q[r0:r1], q64, q64, "sum of squares")):
                nan_w = torch.isnan(want)
                if not torch.equal(nan_w, torch.isnan(got)):
                    fail(f"{name}: {what} NaN where the fp64 sum is not, "
                         "or the reverse")
                d = (got.double() - want).abs().masked_fill(nan_w, 0.0)
                if bool((d > 1e-5 * scale.masked_fill(nan_w, 0.0)).any()):
                    fail(f"{name}: {what} beyond 1e-5 of the fp64 sum's "
                         f"scale, max |err| {float(d.max()):.3g}")
                es = max(es, float((d / scale.clamp_min(1e-30)).max()))
            del x64
            ey = max(ey, check_ssa(
                f"{name} apply rows {r0}-{r1}", y[r0:r1],
                ck.bn_apply_leaky_plain(x[r0:r1], sc[r0:r1], sh[r0:r1], 0.1),
                dtype))
        return x, es, ey

    for c in (1, 16, 1024):
        for m in (1, 7, 4099, 1_000_003, 5_537_792):
            for dt in (torch.float32, torch.bfloat16):
                x, es, ey = check_bn(c, m, dt)
                del x
                log(f"bn_stats / bn_apply_leaky [{c}, {m}] {str(dt)[6:]}: "
                    f"sums max|err|/scale {es:.3g}, apply max|err| {ey:.3g}")
    for dt in (torch.float32, torch.bfloat16):
        x, _, _ = check_bn(16, 4099, dt, nan=True)
        s, q = ck.bn_stats(x)
        if not (bool(torch.isnan(s[8])) and bool(torch.isnan(q[8]))
                and int(torch.isnan(s).sum()) == 1):
            fail(f"bn_stats {dt}: a NaN did not give NaN sums in its "
                 "channel alone")
        s2, q2 = ck.bn_stats(x)
        if not (torch.equal(s.nan_to_num(), s2.nan_to_num())
                and torch.equal(q.nan_to_num(), q2.nan_to_num())):
            fail(f"bn_stats {dt}: two runs gave different sums")
        del x
    log("bn_stats: a NaN gives NaN sums in its channel alone; two runs give "
        "the same bits")

    # timing at the probe's shape, [C, N*H*W] = [16, 5,537,792] bf16
    n_, c, h_, w_ = probe_bn_leaky.SHAPE
    m = n_ * h_ * w_
    x4 = torch.randn(probe_bn_leaky.SHAPE, generator=gen, device=dev).to(
        torch.bfloat16)
    x2d = x4.transpose(0, 1).reshape(c, m)
    s, q = ck.bn_stats(x2d)
    x64 = x2d.double()
    es = max(float((s.double() - x64.sum(1)).abs().max()),
             float((q.double() - x64.square().sum(1)).abs().max()))
    del x64
    gamma = rand(c, scale=0.2, shift=1.0)
    beta = rand(c, scale=0.2)
    mean = s / m
    sc = (gamma * torch.rsqrt(q / m - mean * mean + 1e-5)).contiguous()
    sh = (beta - mean * sc).contiguous()
    ey = check_ssa("bn_apply_leaky probe shape",
                   ck.bn_apply_leaky(x2d, sc, sh, 0.1),
                   ck.bn_apply_leaky_plain(x2d, sc, sh, 0.1), torch.bfloat16)
    shape = f"x [{c}, {m}] bfloat16 (the probe's [32, 16, 416, 416])"
    bn_st = {
        "name": "bn_stats", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/ops/csrc/bn_leaky.cu",
        "replaces": "benchmarks/probe_bn_leaky.py:89",
        "shape": shape, "max_abs_err": es,
        "ms": time_ms(lambda: ck.bn_stats(x2d)),
        "plain_ms": time_ms(lambda: ck.bn_stats_plain(x2d)),
        # two calls, each one pass over x in fp32: the sum, and the
        # 2-norm whose square is the sum of squares
        "library_ms": time_ms(lambda: (
            torch.sum(x2d, 1, dtype=torch.float32),
            torch.linalg.vector_norm(x2d, 2, 1, dtype=torch.float32)
            .square())),
    }
    # add, multiply, add an element in fp32
    bn_st.update(bound(c * m * 2 + 2 * c * 4, 3 * c * m, FP32_FLOPS))
    scb, shb = sc.to(torch.bfloat16), sh.to(torch.bfloat16)
    bn_ap = {
        "name": "bn_apply_leaky", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/ops/csrc/bn_leaky.cu",
        "replaces": "benchmarks/probe_bn_leaky.py:114",
        "shape": shape + ", slope 0.1", "max_abs_err": ey,
        "ms": time_ms(lambda: ck.bn_apply_leaky(x2d, sc, sh, 0.1)),
        "plain_ms": time_ms(lambda: ck.bn_apply_leaky_plain(x2d, sc, sh,
                                                            0.1)),
        # two calls in x's dtype: the port never makes them
        "library_ms": time_ms(lambda: F.leaky_relu(
            torch.addcmul(shb[:, None], x2d, scb[:, None]), 0.1)),
    }
    # an FMA and a select (a multiply) an element in fp32
    bn_ap.update(bound(2 * c * m * 2 + 2 * c * 4, 3 * c * m, FP32_FLOPS))
    gb, bb = gamma.to(torch.bfloat16), beta.to(torch.bfloat16)
    pair = {
        "what": "bn_stats + bn_apply_leaky through probe_bn_leaky."
                "bn_leaky_kernels, and F.batch_norm(training=True) + "
                "F.leaky_relu on the NCHW tensor",
        "ms": time_ms(lambda: probe_bn_leaky.bn_leaky_kernels(
            x2d, gamma, beta)),
        "library_ms": time_ms(lambda: F.leaky_relu(F.batch_norm(
            x4, None, None, gb, bb, training=True, eps=1e-5), 0.1)),
    }
    pair.update(bound(3 * c * m * 2, 6 * c * m, FP32_FLOPS))
    bn_ap["pair"] = pair
    del x4, x2d
    for kr in (bn_st, bn_ap, pair):
        log(f"{kr.get('name', 'bn pair')}: kernel {kr['ms']:.4f} ms, "
            f"plain {kr.get('plain_ms', float('nan')):.4f} ms, library "
            f"{kr['library_ms']:.4f} ms, bound {kr['bound_ms']:.4f} ms "
            f"({kr['bound_by']}) [{smi}]")
    for row in ssa["other_shapes"]:
        log(f"scale_shift_act at {row['shape']}: kernel {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} "
            f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}) [{smi}]")

    # softmax at the SameDiff BERT-base rows at B=32, T=128 (attention
    # [B*H*T, T] and the [B, 2] head), ragged D, the block kernel
    # (D > 1024), a 4-D input through the override, NaN and -inf rows
    def check_sm(name, got, want, dtype):
        nan_w = torch.isnan(want)
        if not torch.equal(nan_w, torch.isnan(got)):
            fail(f"{name}: NaN positions differ")
        g = got.float().masked_fill(nan_w, 0.0)
        w = want.float().masked_fill(nan_w, 0.0)
        rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
        err = (g - w).abs()
        bad = err > 1e-6 + rtol * w.abs()
        if bool(bad.any()):
            fail(f"{name}: {int(bad.sum())} element(s) beyond rtol={rtol:g} "
                 f"atol=1e-6, max |err| {err.max().item():.3g}")
        return float(err.max().item())

    for n, d in ((49152, 128), (32, 2), (1000, 100), (500, 1000),
                 (64, 4096), (37, 5000)):
        for dt in (torch.float32, torch.bfloat16):
            x = rand(n, d, dtype=dt, scale=4.0)
            y = ck.softmax_fwd(x)
            torch.cuda.synchronize()
            e = check_sm(f"softmax [{n},{d}] {dt}", y, ck.softmax_plain(x), dt)
            log(f"softmax [{n}, {d}] {str(dt)[6:]}: max|err| {e:.3g}")
    sm_override = ck.make_softmax_override()
    x4 = rand(4, 12, 128, 128, scale=4.0)
    e = check_sm("softmax override [4,12,128,128]", sm_override(x4),
                 ck.softmax_plain(x4.view(-1, 128)).view(x4.shape),
                 torch.float32)
    log(f"softmax override on a 4-D input: max|err| {e:.3g}")
    for d in (128, 2000):                      # warp and block kernels
        for dt in (torch.float32, torch.bfloat16):
            x = rand(8, d, dtype=dt)
            x[1, 5] = float("nan")
            x[2] = -float("inf")
            x[3, 7] = float("inf")
            y = ck.softmax_fwd(x)
            torch.cuda.synchronize()
            if not bool(torch.isnan(y[1:4]).all()) or \
                    bool(torch.isnan(y[0]).any()):
                fail(f"softmax D={d} {dt}: NaN/-inf/inf rows not NaN, or a "
                     "finite row NaN")
            check_sm(f"softmax NaN/inf rows D={d} {dt}", y,
                     ck.softmax_plain(x), dt)
    log("softmax: a NaN, +inf or all--inf row gives a NaN row, as jnp")

    N, D = SD_BATCH * 12 * 128, 128
    x = rand(N, D, scale=4.0)
    sm = {
        "name": "softmax", "route": "cuda",
        "source": "deeplearning4j_tpu_torch/ops/csrc/softmax.cu",
        "replaces": "deeplearning4j_tpu/ops/pallas_kernels.py:144",
        "shape": f"x [{N}, {D}] float32 (SameDiff BERT-base attention, "
                 f"B={SD_BATCH}, T=128)",
        "max_abs_err": check_sm("softmax main shape", ck.softmax_fwd(x),
                                ck.softmax_plain(x), torch.float32),
        "ms": time_ms(lambda: ck.softmax_fwd(x)),
        "plain_ms": time_ms(lambda: ck.softmax_plain(x)),
        "library_ms": time_ms(lambda: torch.softmax(x, -1)),
    }
    # max, subtract, exp, add, divide per element on the CUDA cores
    sm.update(bound(2 * N * D * 4, 5 * N * D, FP32_FLOPS))
    del x

    # the layer-norm and flash overrides carry gradients (composed
    # backwards) on the card, equal to autograd through the plain versions
    ck.install_platform_overrides()
    xg = rand(64, 768, scale=2.0).requires_grad_(True)
    gg = rand(768, shift=1.0).requires_grad_(True)
    bg = rand(768).requires_grad_(True)
    wg = rand(64, 768)
    got = torch.autograd.grad((registry.get("layer_norm")(xg, gg, bg)
                               * wg).sum(), (xg, gg, bg))
    want = torch.autograd.grad((ck.layer_norm_plain(xg, gg, bg) * wg).sum(),
                               (xg, gg, bg))
    errs = [check(f"layer_norm grad {n}", a, b, None, atol=2e-4)
            for n, a, b in zip(("x", "gain", "bias"), got, want)]
    qg, kg, vg = (rand(2, 200, 3, 64).requires_grad_(True) for _ in range(3))
    wg = rand(2, 200, 3, 64)
    for causal in (False, True):
        got = torch.autograd.grad(
            (registry.get("flash_attention")(qg, kg, vg, is_causal=causal)
             * wg).sum(), (qg, kg, vg))
        want = torch.autograd.grad(
            (ck.flash_attention_plain(qg, kg, vg, causal)[0] * wg).sum(),
            (qg, kg, vg))
        errs += [check(f"flash grad d{n} causal={causal}", a, b, None,
                       atol=2e-4) for n, a, b in zip("qkv", got, want)]
    log(f"gradients through the layer_norm and flash overrides equal "
        f"autograd through the plain versions: max|err| {max(errs):.3g}")
    for kr in (ssa, sm):
        log(f"{kr['name']} at {kr['shape']}: kernel {kr['ms']:.4f} ms, "
            f"plain {kr['plain_ms']:.4f} ms, library {kr['library_ms']:.4f} "
            f"ms, bound {kr['bound_ms']:.4f} ms ({kr['bound_by']}) [{smi}]")
    log("scale_shift_act library = torch.relu_(torch.addcmul(shift, x, "
        "scale)): two calls")
    del flush

    # ------------------------------------------------- 3. serve BERT-base
    served = serve_bert(smi)

    # ------------------------------------------------ 4. ResNet-50 fit
    ck.install_platform_overrides()
    t0 = time.perf_counter()
    net = zoo.ResNet50(num_classes=1000).init()
    net.setPrecisionPolicy("bf16")
    net.setComputeLayout("NHWC")
    net.setEpilogueFusion(True)
    log(f"ResNet-50: {net.numParams()} parameters, bf16 policy, NHWC, fused "
        f"epilogues, built in {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    xr = torch.from_numpy(rng.standard_normal(
        (RESNET_BATCH, 3, 224, 224), dtype=np.float32)).to(dev)
    yr = torch.from_numpy(np.eye(1000, dtype=np.float32)[
        rng.integers(0, 1000, RESNET_BATCH)]).to(dev)
    ds = DataSet(xr, yr)
    t0 = time.perf_counter()
    net.fit(ds)
    losses = [net.score()]
    log(f"warm step: loss {losses[0]:.5f} in {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    ck.reset_counts()
    step_ms = []
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        net.fit(ds)
        losses.append(net.score())       # a float: waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
    fit_launches = dict(ck.LAUNCHES)
    fit_plain = dict(ck.PLAIN_CALLS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(losses)):
        fail(f"ResNet-50 losses not finite: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"ResNet-50 loss did not fall: {losses}")
    if fit_launches["scale_shift_act"] != 33 * RESNET_STEPS \
            or any(fit_plain.values()):
        fail(f"ResNet-50 fit launch counts {fit_launches} (plain "
             f"{fit_plain}) over {RESNET_STEPS} steps: want 33 "
             "scale_shift_act launches per step and no plain call")
    med = float(np.median(step_ms))
    log(f"ResNet-50 fit B={RESNET_BATCH}: losses "
        f"{', '.join(f'{v:.5f}' for v in losses)}; step ms median {med:.2f} "
        f"(min {min(step_ms):.2f}, max {max(step_ms):.2f}), "
        f"{RESNET_BATCH / (med / 1e3):.1f} images/s, peak {peak_gb:.2f} GB, "
        f"launches {fit_launches} [{smi}]")

    # ----------------------------------- 5. ResNet-50 output against plain
    ck.reset_counts()
    probs = net.output(xr)
    out_launches = ck.LAUNCHES["scale_shift_act"]

    registry.register_platform_override("scale_shift_act", ssa_plain)
    probs_plain = net.output(xr)
    ck.install_platform_overrides()
    if out_launches != 33:
        fail(f"ResNet-50 output ran {out_launches} scale_shift_act launches, "
             "want 33")
    if probs.shape != (RESNET_BATCH, 1000) or \
            not bool(torch.isfinite(probs).all()) or \
            float((probs.sum(-1) - 1).abs().max()) > 1e-3:
        fail(f"ResNet-50 output not finite softmax rows of shape "
             f"{tuple(probs.shape)}")
    dp = (probs - probs_plain).abs()
    pmax = float(probs_plain.max())
    log(f"ResNet-50 output kernel vs plain: max|diff| {float(dp.max()):.4g}, "
        f"mean|diff| {float(dp.mean()):.4g}, max p {pmax:.4g}; argmax agree "
        f"{float((probs.argmax(-1) == probs_plain.argmax(-1)).float().mean()):.4f}")
    # bound: kernel and plain agree to the bit but for rare double-rounding
    # ties; a tie moves one bf16 activation by an ulp, and ~50 layers may
    # carry that on, as in phase 3
    if float(dp.max()) > 0.05 * pmax or float(dp.mean()) > 2e-3 * pmax:
        fail("kernel and plain ResNet-50 forwards disagree beyond the bound "
             "(max 5%, mean 0.2% of max p)")
    # the trained net's archive, for phase 18
    archive_dir = tempfile.TemporaryDirectory()
    resnet_zip = os.path.join(archive_dir.name, "resnet50.zip")
    t0 = time.perf_counter()
    net.save(resnet_zip)
    log(f"ResNet-50 saved: {os.path.getsize(resnet_zip) / 1e6:.1f} MB in "
        f"{time.perf_counter() - t0:.2f} s")
    resnet_out = (xr, probs)
    del net, ds, yr, probs_plain
    torch.cuda.empty_cache()

    # --------------------------------------- 6. serve a SameDiff BERT-base
    ck.install_platform_overrides()       # before recording: nodes bind ops
    t0 = time.perf_counter()
    sd = build_bert(SameDiff.create(), **BERT_SD)
    n_params = sum(v.numel() for v in sd._variables.values())
    log(f"SameDiff BERT-base: {n_params} parameters, {len(sd._nodes)} ops, "
        f"fp32, built in {time.perf_counter() - t0:.2f} s")
    T = BERT_SD["T"]
    server = ModelServer(samediff_forward(sd, ["probs"],
                                          input_name="input_ids"),
                         batch_limit=32, input_dtype=np.int32,
                         coalesce_ms=5.0, max_queue=256)
    try:
        cc.reset_stats()
        ck.reset_counts()
        t0 = time.perf_counter()
        server.warmup([(T,)])
        sd_warm = dict(ck.LAUNCHES)
        at_capture = server._dispatch.launches_at_capture()
        stats = cc.cache_stats()
        log(f"warmup: buckets {server.buckets()} x T={T}: "
            f"{len(at_capture)} graphs captured in "
            f"{time.perf_counter() - t0:.2f} s (cache_stats {stats})")
        if stats["capture_failures"] or \
                len(at_capture) != len(server.buckets()) or \
                any(a != {"softmax": 13, "layer_norm": 25}
                    for a in at_capture):
            fail(f"SameDiff serving captures {at_capture}, cache_stats "
                 f"{stats}: want {len(server.buckets())} graphs of 13 "
                 "softmax and 25 layer_norm launches and no failure")
        rng = np.random.default_rng(1)
        sd_reqs = [rng.integers(0, BERT_SD["V"], (int(rng.integers(1, 9)), T),
                                dtype=np.int32) for _ in range(64)]
        sd_handles, sd_served, sd_wall, sd_launches, sd_plain, sd_fwd = \
            serve_burst(server, sd_reqs)
        sd_replays = dict(ck.REPLAYS)
        sd_recompiles = server.recompiles_after_warmup()
    finally:
        server.close()
    if any(h.resolutions != 1 for h in sd_handles) or \
            server.counts["completed"] != 64:
        fail(f"SameDiff serving: a request not resolved exactly once, "
             f"counts {dict(server.counts)}")
    want_replays = {k: 0 for k in ck.KERNELS}
    want_replays.update(softmax=13 * sd_fwd, layer_norm=25 * sd_fwd)
    if any(sd_launches.values()) or any(sd_plain.values()) \
            or sd_replays != want_replays or sd_recompiles \
            or cc.cache_stats()["capture_failures"]:
        fail(f"SameDiff serving ran launches {sd_launches} eagerly (plain "
             f"{sd_plain}), replayed {sd_replays} over {sd_fwd} forwards, "
             f"recompiles_after_warmup {sd_recompiles}: want none eagerly, "
             "13 softmax + 25 layer_norm replayed a forward, 0 recompiles")
    log(f"served 64 SameDiff requests in {sd_fwd} captured forwards: no "
        f"eager launch, replayed {sd_replays}")
    log_latency(sd_handles, sd_reqs, sd_wall, smi)
    worst = 0.0
    for r, got in zip(sd_reqs, sd_served):
        want = sd.output({"input_ids": r}, ["probs"])["probs"].cpu().numpy()
        if got.shape != want.shape or not np.isfinite(got).all():
            fail(f"served probs of shape {got.shape}, direct {want.shape}, "
                 "or not finite")
        worst = max(worst, float(np.abs(got - want).max()))
    log(f"served probs vs direct sd.output: max|diff| {worst:.3g}")
    if worst > 1e-4:
        fail("served and direct SameDiff probs differ by more than 1e-4")

    # ----------------------------------------- 7. fine-tune it with fit
    sd.setTrainingConfig(TrainingConfig(
        updater=Adam(1e-4), data_set_feature_mapping=["input_ids"],
        data_set_label_mapping=["labels"]))
    rng = np.random.default_rng(2)
    batch = {"input_ids": torch.from_numpy(rng.integers(
                 0, BERT_SD["V"], (SD_BATCH, T), dtype=np.int32)).to(dev),
             "labels": torch.from_numpy(rng.integers(
                 0, BERT_SD["n_labels"], SD_BATCH, dtype=np.int32)).to(dev)}
    torch.cuda.reset_peak_memory_stats()
    # the loss takes the logits, not the head's probs: 12 softmax a step
    sd7 = samediff_fit_held("SameDiff BERT-base", sd, batch, SD_STEPS, smi,
                            {"softmax": 12, "layer_norm": 25})
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"SameDiff BERT-base fit B={SD_BATCH}, T={T}, Adam 1e-4: "
        f"{SD_BATCH * T / (sd7['captured_ms'] / 1e3):.1f} tokens/s "
        f"captured ({SD_BATCH * T / (sd7['eager_ms'] / 1e3):.1f} eager), "
        f"peak {peak_gb:.2f} GB [{smi}]")

    # ------------------------ 8. the kernels' graph against the generic one
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "bert_samediff.zip")
        sd.save(path, save_updater_state=False)
        ck.uninstall_platform_overrides()
        generic = SameDiff.load(path)        # nodes resolve the generic ops
        ck.install_platform_overrides()
    ck.reset_counts()
    p_gen = generic.output(batch, ["probs"])["probs"]
    g_gen = generic.calculateGradients(batch)
    if any(ck.LAUNCHES.values()):
        fail(f"the generic graph launched kernels: {ck.LAUNCHES}")
    p_ker = sd.output(batch, ["probs"])["probs"]
    g_ker = sd.calculateGradients(batch)
    dprob = float((p_ker - p_gen).abs().max())
    flat_k = torch.cat([g_ker[k].flatten() for k in g_gen])
    flat_g = torch.cat([g_gen[k].flatten() for k in g_gen])
    rel_l2 = float((flat_k - flat_g).norm() / flat_g.norm())
    gmax = float(flat_g.abs().max())
    emax = float((flat_k - flat_g).abs().max())
    log(f"kernel vs generic SameDiff graph: probs max|diff| {dprob:.3g}; "
        f"gradients over {len(g_gen)} variables: relative L2 {rel_l2:.3g}, "
        f"max|diff| {emax:.3g} (max|g| {gmax:.3g})")
    if not bool(torch.isfinite(flat_k).all()) or dprob > 1e-5 \
            or rel_l2 > 1e-4 or emax > 1e-4 * gmax:
        fail("kernel and generic SameDiff graphs disagree beyond the bound "
             "(probs 1e-5; gradients relative L2 1e-4, elements 1e-4 of "
             "max|g|)")

    # phase 6's server holds the graph (its forward closes over it), and
    # with it the captured fit step's pool
    del sd, server, generic, batch, p_gen, g_gen, p_ker, g_ker, flat_k, \
        flat_g
    gc.collect()
    torch.cuda.empty_cache()

    # ------------------------------------------------ 9. TinyYOLO fit
    ck.install_platform_overrides()
    rng = np.random.default_rng(0)
    xy = torch.from_numpy(rng.standard_normal(
        (YOLO_BATCH, 3, 416, 416), dtype=np.float32)).to(dev)
    yy = torch.from_numpy(yolo_labels(rng, YOLO_BATCH, YOLO_CLASSES)).to(dev)
    yds = DataSet(xy, yy)

    def tiny_yolo():
        net = zoo.TinyYOLO(num_classes=YOLO_CLASSES).init()
        net.setPrecisionPolicy("bf16")
        net.setComputeLayout("NHWC")
        net.setEpilogueFusion(True)
        return net

    # the reference for the first two losses: a fresh net from the same
    # seed on the plain scale_shift_act
    registry.register_platform_override("scale_shift_act", ssa_plain)
    net = tiny_yolo()
    plain_losses = []
    for _ in range(2):
        net.fit(yds)
        plain_losses.append(net.score())
    del net
    ck.install_platform_overrides()
    t0 = time.perf_counter()
    net = tiny_yolo()
    log(f"TinyYOLO: {net.numParams()} parameters, {len(net.layers)} layers, "
        f"{YOLO_CLASSES} classes, 3x416x416, bf16 policy, NHWC, fused "
        f"epilogues {sorted(net._ensure_epilogue_plan())}, built in "
        f"{time.perf_counter() - t0:.2f} s; {int(yy[:, 4:].sum())} boxes in "
        f"{YOLO_BATCH} images")
    t0 = time.perf_counter()
    net.fit(yds)
    y_losses = [net.score()]
    log(f"warm step: loss {y_losses[0]:.5f} in "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    ck.reset_counts()
    y_ms = []
    for _ in range(YOLO_STEPS):
        t0 = time.perf_counter()
        net.fit(yds)
        y_losses.append(net.score())     # a float: waits for the step
        y_ms.append((time.perf_counter() - t0) * 1e3)
    yolo_launches = dict(ck.LAUNCHES)
    yolo_plain = dict(ck.PLAIN_CALLS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(y_losses)):
        fail(f"TinyYOLO losses not finite: {y_losses}")
    want = {k: 0 for k in ck.KERNELS}
    want["scale_shift_act"] = 8 * YOLO_STEPS
    if yolo_launches != want or any(yolo_plain.values()):
        fail(f"TinyYOLO fit launch counts {yolo_launches} (plain "
             f"{yolo_plain}) over {YOLO_STEPS} steps: want 8 scale_shift_act "
             "launches per step and nothing else")
    rel = [abs(a - b) / abs(b) for a, b in zip(y_losses[:2], plain_losses)]
    med = float(np.median(y_ms))
    log(f"TinyYOLO fit B={YOLO_BATCH}: losses "
        f"{', '.join(f'{v:.5f}' for v in y_losses)}; step ms median {med:.2f} "
        f"(min {min(y_ms):.2f}, max {max(y_ms):.2f}), "
        f"{YOLO_BATCH / (med / 1e3):.1f} images/s, peak {peak_gb:.2f} GB, "
        f"launches {yolo_launches} [{smi}]")
    log(f"first two losses {y_losses[:2]} vs the plain scale_shift_act's "
        f"{plain_losses}: relative {rel}")
    if max(rel) > 2e-2:
        fail("TinyYOLO's first two losses differ from the plain version's "
             "by more than 2e-2 relative")

    # --------------------------- 10. TinyYOLO output against plain
    # on a fresh net from the seed: after the loss's spike the trained
    # net's wh outputs (anchors * exp) may overflow to inf
    del net
    net = tiny_yolo()
    xo = xy[:YOLO_BATCH]
    ck.reset_counts()
    out = net.output(xo)
    out_launches = ck.LAUNCHES["scale_shift_act"]
    registry.register_platform_override("scale_shift_act", ssa_plain)
    out_plain = net.output(xo)
    ck.install_platform_overrides()
    n_ch = 5 * (5 + YOLO_CLASSES)
    if out_launches != 8:
        fail(f"TinyYOLO output ran {out_launches} scale_shift_act launches, "
             "want 8")
    if tuple(out.shape) != (YOLO_BATCH, n_ch, 13, 13) or \
            out.dtype != torch.float32 or not bool(torch.isfinite(out).all()):
        fail(f"TinyYOLO output not finite fp32 of shape [{YOLO_BATCH}, "
             f"{n_ch}, 13, 13]: {tuple(out.shape)} {out.dtype}")
    rel_l2 = float((out - out_plain).norm() / out_plain.norm())
    objs = YoloUtils.getPredictedObjects(zoo.TinyYOLO.ANCHORS, out)
    log(f"TinyYOLO output kernel vs plain: relative L2 {rel_l2:.3g}, max|diff| "
        f"{float((out - out_plain).abs().max()):.4g} (max|out| "
        f"{float(out_plain.abs().max()):.4g}); getPredictedObjects: "
        f"{len(objs)} objects in {YOLO_BATCH} images")
    if rel_l2 > 1e-2:
        fail("TinyYOLO kernel and plain outputs differ by more than 1e-2 "
             "relative L2")
    del net, xy, yy, yds, out, out_plain
    torch.cuda.empty_cache()

    # ------------------------------------------ 11. the BN+leaky probe
    ck.reset_counts()
    probe = probe_bn_leaky.main()
    probe_launches = dict(ck.LAUNCHES)
    want = {k: 0 for k in ck.KERNELS}
    want["bn_stats"] = want["bn_apply_leaky"] = probe["calls"]
    if probe_launches != want or any(ck.PLAIN_CALLS.values()):
        fail(f"probe launch counts {probe_launches} (plain "
             f"{dict(ck.PLAIN_CALLS)}) over {probe['calls']} calls: want one "
             "bn_stats and one bn_apply_leaky launch per call")
    log(f"probe: {probe['calls']} calls, one bn_stats and one bn_apply_leaky "
        f"launch each [{smi}]")

    # ------------------------ 12-13. the BertBench step, eager and captured
    bert_train(smi)
    torch.cuda.empty_cache()

    # -------------------- 14. ResNet-50 and TinyYOLO, 4 steps a dispatch
    rng = np.random.default_rng(0)
    x_r = torch.from_numpy(rng.standard_normal(
        (RESNET_BATCH, 3, 224, 224), dtype=np.float32)).to(dev)
    y_r = torch.from_numpy(np.eye(1000, dtype=np.float32)[
        rng.integers(0, 1000, RESNET_BATCH)]).to(dev)

    def resnet():
        net = zoo.ResNet50(num_classes=1000).init()
        net.setPrecisionPolicy("bf16")
        net.setComputeLayout("NHWC")
        net.setEpilogueFusion(True)
        return net
    rng = np.random.default_rng(0)
    x_y = torch.from_numpy(rng.standard_normal(
        (YOLO_BATCH, 3, 416, 416), dtype=np.float32)).to(dev)
    y_y = torch.from_numpy(yolo_labels(rng, YOLO_BATCH, YOLO_CLASSES)).to(dev)
    r14 = {}
    for name, build, ds, per_step in (
            ("ResNet-50", resnet, DataSet(x_r, y_r), 33),
            ("TinyYOLO", tiny_yolo, DataSet(x_y, y_y), 8)):
        live = torch.cuda.memory_allocated()
        r14[name] = captured_fit(name, build(), ds, per_step, smi,
                                 live_before=live)
    del x_r, y_r, x_y, y_y
    torch.cuda.empty_cache()

    # ------------------------------------------------ 15. the front door
    front_door(smi)

    # ------------------------------------------------------ 16. LeNet-5
    measured = {name: r14[name] for name in ("ResNet-50", "TinyYOLO")}
    measured["LeNet-5"] = lenet(smi)
    torch.cuda.empty_cache()

    # ------------------------------------------------------- 17. VGG16
    measured["VGG16"] = vgg16(smi)
    torch.cuda.empty_cache()

    # ------------------- 18. Darknet19, and the ResNet-50 archive back
    dk_launches, measured["Darknet19"] = darknet19(smi)
    resnet_back(resnet_zip, *resnet_out)
    archive_dir.cleanup()
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 19. YOLO2
    y2_launches, measured["YOLO2"] = yolo2(smi)
    torch.cuda.empty_cache()

    # ------------------------------------------- 20. the other zoo CNNs
    zoo_eager = zoo_cnns(smi)
    torch.cuda.empty_cache()

    # ---------------------------------- 21. TextGenerationLSTM, TBPTT
    textgen(smi)
    torch.cuda.empty_cache()

    # ------------------------------- 22. ResNet-50 from JPEGs on disk
    disk = from_disk(smi, r14["ResNet-50"]["captured_ms"])
    torch.cuda.empty_cache()

    # ----------------------- 23-24. BERT-base by checkpoint and by GraphDef
    imported = import_bert(smi)
    torch.cuda.empty_cache()

    # ------------------- 25. a long ResNet-50 run: checkpoints, recovery
    long = long_run(smi)
    torch.cuda.empty_cache()

    # ----------------------------------- 26. dynamic loss scaling (fp16)
    dynamic_scaling(smi)
    torch.cuda.empty_cache()

    # ------------------------------------------------ 27. early stopping
    early_stopping(smi)
    torch.cuda.empty_cache()

    # ------------------------------ 28. a Keras encoder enters by import
    keras = keras_encoder(smi, imported["path_a"])
    torch.cuda.empty_cache()

    # ------------------------ 29. ResNet-50 from an ONNX file, served
    onnx_resnet(smi)
    torch.cuda.empty_cache()

    # ------------- 30. transfer learning: TinyYOLO into 10 classes
    transfer_launches = transfer_tinyyolo(smi)
    torch.cuda.empty_cache()

    # -------------------------------------------- 31. SameDiffLayer
    samediff_layer(smi)
    torch.cuda.empty_cache()

    # ----------------------------------- 32. DataVec feeds nets on the card
    datavec(smi)
    torch.cuda.empty_cache()

    # ------------------------------------- 33. the analyzer against the card
    analyzer_vs_card(smi, measured, zoo_eager, disk,
                     r14["ResNet-50"]["captured_ms"])
    torch.cuda.empty_cache()

    # --------------------------------------------- 34. observability
    obs = observability(smi)
    torch.cuda.empty_cache()

    # ----------------------------------------- 35. the op surface on the card
    surf = op_surface(smi)
    torch.cuda.empty_cache()

    # ------------- 36. SameDiff RNG captured, the disk tier, tune, strict
    p36 = rng_disk_tune(smi)
    torch.cuda.empty_cache()

    # -------------------- 37. continuous training: the lifecycle storm
    lc = lifecycle_storm(smi)
    torch.cuda.empty_cache()

    ln.update(served["layer_norm"])
    fa.update(served["flash_attention"])
    for kr in (ln, fa):
        kr["import_launches"] = imported["served"][kr["name"]]
        kr["import_train_launches"] = imported["train"][kr["name"]]
    ln["keras_launches"] = keras["served_layer_norm"] \
        + keras["long_layer_norm"]
    fa["keras_launches"] = keras["long_flash"]
    ssa["launches"] = fit_launches["scale_shift_act"]
    ssa["other_shapes"][0]["launches"] = yolo_launches["scale_shift_act"]
    ssa["other_shapes"][1]["launches"] = dk_launches
    ssa["other_shapes"][2]["launches"] = y2_launches
    ssa["from_disk_launches"] = disk["at_capture"]
    ssa["from_disk_replays"] = disk["replays"]
    ssa["long_run_launches"] = long["at_capture"]
    ssa["transfer_launches"] = transfer_launches
    ssa["sanitizer_launches"] = obs["sanitizer_launches"]
    ssa["disk_warm_launches"] = p36["disk_warm_launches"]
    ssa["tune_launches"] = p36["tune_launches"]
    for kr in (sm, ln):
        kr["samediff_capture_launches"] = sd7["at_capture"][kr["name"]]
    sm["launches"] = sd_warm["softmax"] + sd_replays["softmax"]
    sm["replays"] = sd_replays["softmax"]
    sm["ndarray_launches"] = surf["softmax"]
    for kr in (ln, ssa, fa):
        kr["exec_op_launches"] = surf[kr["name"]]
    for kr in (ln, fa):
        kr["lifecycle_launches"] = lc["launches"][kr["name"]]
        kr["lifecycle_replays"] = lc["replays"][kr["name"]]
    bn_st["launches"] = probe_launches["bn_stats"]
    bn_ap["launches"] = probe_launches["bn_apply_leaky"]
    keys = ("name", "route", "source", "replaces", "launches", "replays",
            "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "other_shapes", "pair", "from_disk_launches",
            "from_disk_replays", "import_launches", "import_train_launches",
            "long_run_launches", "keras_launches", "transfer_launches",
            "sanitizer_launches", "ndarray_launches", "exec_op_launches",
            "samediff_capture_launches", "disk_warm_launches",
            "tune_launches", "lifecycle_launches", "lifecycle_replays")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{k: kr[k] for k in keys if k in kr}
                                  for kr in (ln, fa, ssa, sm, bn_st, bn_ap)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def serve_bert(smi: str) -> dict:
    """Phase 3: BERT-base served captured. Returns the flash and layer-norm
    launches of the run (captures and eager warm-up runs of the warmup,
    then the replays of the traffic) and the replays alone."""
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from deeplearning4j_tpu_torch.nn import compilecache as cc
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.serving import ModelServer
    dev = torch.device("cuda")
    ck.install_platform_overrides()
    cfg = TransformerConfig.bert_base(use_flash_attention=True)
    t0 = time.perf_counter()
    lm = TransformerLM(cfg, seed=0)
    log(f"BERT-base: {lm.n_params()} parameters, {cfg.n_layers} layers, "
        f"E={cfg.d_model}, H={cfg.n_heads}, dtype {cfg.dtype}, built in "
        f"{time.perf_counter() - t0:.2f} s")
    server = ModelServer(lm.logits, batch_limit=32, input_dtype=np.int32,
                         head="argmax", coalesce_ms=5.0, max_queue=256)
    try:
        cc.reset_stats()
        ck.reset_counts()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        server.warmup([(128,), (512,)])
        warm_s = time.perf_counter() - t0
        warm_launches = dict(ck.LAUNCHES)
        warm_routes = dict(ck.FLASH_ROUTES)
        at_capture = server._dispatch.launches_at_capture()
        warm_stats = cc.cache_stats()
        graph_gb = (torch.cuda.memory_allocated() - mem0) / 1e9
        warm_peak_gb = (torch.cuda.max_memory_allocated() - mem0) / 1e9
        n_caps = len(server.buckets()) * 2
        log(f"warmup: buckets {server.buckets()} x T in (128, 512): "
            f"{server._dispatch.warmed_signatures()} graphs captured in "
            f"{warm_s:.2f} s (cache_stats {warm_stats}); graphs hold "
            f"{graph_gb:.3f} GB, warmup peak {warm_peak_gb:.3f} GB above "
            f"the weights [{smi}]")
        if warm_stats["capture_failures"] or len(at_capture) != n_caps \
                or any(a != {"flash_attention": 12, "layer_norm": 25}
                       for a in at_capture) \
                or warm_routes["cuda_core"]:
            fail(f"served BERT-base captures: {at_capture}, routes "
                 f"{warm_routes}, cache_stats {warm_stats}: want {n_caps} "
                 "graphs of 12 tensor-core flash and 25 layer_norm launches "
                 "and no failure")

        rng = np.random.default_rng(0)
        reqs_in = [rng.integers(0, cfg.vocab_size,
                                (int(rng.integers(1, 9)),
                                 128 if i % 2 == 0 else 512), dtype=np.int32)
                   for i in range(64)]
        handles, served, wall, launches, plain, n_fwd = serve_burst(
            server, reqs_in)
        replays = dict(ck.REPLAYS)
        recompiles = server.recompiles_after_warmup()
        new_caps = server.captures_after_warmup()

        if any(h.resolutions != 1 for h in handles):
            fail("a request was not resolved exactly once")
        if server.counts["completed"] != 64:
            fail(f"expected 64 completed requests, counts "
                 f"{dict(server.counts)}")
        want = {k: 0 for k in ck.KERNELS}
        want.update(flash_attention=12 * n_fwd, layer_norm=25 * n_fwd)
        if any(launches.values()) or any(plain.values()) or replays != want:
            fail(f"traffic ran launches {launches} eagerly (plain {plain}) "
                 f"and replayed {replays} over {n_fwd} forwards: want none "
                 "eagerly and 12 flash_attention + 25 layer_norm replayed "
                 "a forward")
        if recompiles or new_caps or cc.cache_stats()["capture_failures"]:
            fail(f"recompiles_after_warmup {recompiles}, captures after "
                 f"warmup {new_caps}, cache_stats {cc.cache_stats()}: want "
                 "0, 0 and no capture failure")
        log(f"served 64 requests in {n_fwd} captured forwards: no eager "
            f"launch, replayed {replays}; recompiles_after_warmup 0, "
            "captures after warmup 0")
        log_latency(handles, reqs_in, wall, smi)

        agree = total = 0
        for r, got in zip(reqs_in, served):
            want_a = lm.logits(r).argmax(-1).to(torch.int32).cpu().numpy()
            if got.shape != want_a.shape:
                fail(f"served shape {got.shape} != direct {want_a.shape}")
            agree += int((got == want_a).sum())
            total += want_a.size
        frac = agree / total
        log(f"served argmax agrees with direct lm.logits on {agree}/{total} "
            f"tokens ({frac:.5f})")
        if frac < 0.999:
            fail(f"served/direct argmax agreement {frac:.5f} < 0.999")

        # one dispatch of the eager forward+head against one replay, each
        # from the host batch to the host answer
        for T in (128, 512):
            x = rng.integers(0, cfg.vocab_size, (32, T), dtype=np.int32)

            def eager():
                xt = torch.from_numpy(x).to(dev)
                with torch.inference_mode():
                    return server._device_forward(xt).cpu().numpy()

            def replay():
                return server._forward_raw(x)
            for fn in (eager, replay):
                fn()
            times = {}
            for name, fn in (("eager", eager), ("replay", replay)):
                ts = []
                for _ in range(10):
                    t0 = time.perf_counter()
                    out = fn()
                    ts.append((time.perf_counter() - t0) * 1e3)
                times[name] = (float(np.median(ts)), out)
            same = float((times["eager"][1] == times["replay"][1]).mean())
            log(f"B=32, T={T} forward+argmax, host batch to host answer "
                f"(host clock, median of 10): eager {times['eager'][0]:.3f} "
                f"ms, captured replay {times['replay'][0]:.3f} ms, "
                f"{times['eager'][0] / times['replay'][0]:.2f}x; "
                f"{32 * T / (times['replay'][0] / 1e3):.0f} tokens/s "
                f"replayed; answers agree on {same:.5f} [{smi}]")
            if same < 0.999:
                fail(f"eager and replayed argmax agree on {same:.5f} < "
                     "0.999 of tokens")
        if server.captures_after_warmup() or server.recompiles_after_warmup():
            fail("the timed replays captured a graph")
    finally:
        server.close()

    for T in (128, 512):
        ck.reset_counts()
        with torch.inference_mode():
            lm.logits(rng.integers(0, cfg.vocab_size, (2, T), dtype=np.int32))
        if ck.FLASH_ROUTES != {"tensor_core": 12, "cuda_core": 0}:
            fail(f"a direct forward at T={T} took flash routes "
                 f"{ck.FLASH_ROUTES}: want 12 on the tensor cores")
    log("direct forwards at T=128 and T=512: 12 flash launches each, all "
        "on the tensor cores")

    # the same forward with the plain versions of both kernels
    tok = reqs_in[0]
    with torch.inference_mode():
        kern = lm.logits(tok)
        registry.register_platform_override(
            "layer_norm", lambda x, g, b=None, *, axis=-1, eps=1e-5:
            ck.layer_norm_plain(x, g, b, eps))
        registry.register_platform_override(
            "flash_attention", lambda q, k, v, *, mask=None, is_causal=False,
            block_size=512: ck.flash_attention_plain(q, k, v, is_causal)[0])
        plain_logits = lm.logits(tok)
        ck.install_platform_overrides()
    if not bool(torch.isfinite(kern).all()) or \
            kern.shape != (tok.shape[0], tok.shape[1], cfg.vocab_size):
        fail(f"logits not finite or of shape {tuple(kern.shape)}")
    dl = (kern - plain_logits).abs()
    scale = float(plain_logits.abs().max())
    log(f"kernel vs plain forward logits: max|diff| {float(dl.max()):.4g}, "
        f"mean|diff| {float(dl.mean()):.4g}, max|logit| {scale:.4g}")
    # bound: bf16 activations carry 8 significant bits; the two forwards
    # round the same values after sums in another order, so each layer
    # may move a value by an ulp or two and 12 layers compound that
    if float(dl.max()) > 0.05 * scale or float(dl.mean()) > 2e-3 * scale:
        fail("kernel and plain forwards disagree beyond the bf16 bound "
             "(max 5%, mean 0.2% of max|logit|)")
    del server, lm, kern, plain_logits
    torch.cuda.empty_cache()
    return {k: {"launches": warm_launches[k] + replays[k],
                "replays": replays[k]}
            for k in ("flash_attention", "layer_norm")}


def front_door(smi: str) -> None:
    """Phase 15: BERT-base behind ``HttpIngress`` and ``ModelRegistry``:
    a steady replay over real sockets while v2 loads (and captures) and
    the route rolls, rolls back and rolls again."""
    import gc
    import http.client
    import urllib.request

    import torch

    from deeplearning4j_tpu_torch.faults import ServingLoad, SwapSchedule
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from deeplearning4j_tpu_torch.nn import compilecache as cc
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.serving import HttpIngress, ModelRegistry
    ck.install_platform_overrides()
    cfg = TransformerConfig.bert_base(use_flash_attention=True)
    gc.collect()        # what earlier phases left is freed now, not later
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    lms = {1: TransformerLM(cfg, seed=0), 2: TransformerLM(cfg, seed=1)}
    T = 128
    cc.reset_stats()
    reg = ModelRegistry(batch_limit=32, head="argmax", input_dtype=np.int32)
    ingress = None
    try:
        t0 = time.perf_counter()
        reg.load("bert", lms[1].logits, shapes=[(T,)])
        log(f"front door: bert v1 loaded and captured in "
            f"{time.perf_counter() - t0:.2f} s")
        ingress = HttpIngress(reg, port=0).start()

        # what v2's load costs v1: the end of each of v1's batches and
        # its queue depth after each admission
        v1 = reg.server("bert", 1)
        v1_ends, v1_depth = [], [0]
        v1_dispatch, v1_submit = v1._dispatch_batch, v1.submit

        def dispatch_timed(batch):
            v1_dispatch(batch)
            v1_ends.append(time.perf_counter())

        def submit_depth(*a, **kw):
            req = v1_submit(*a, **kw)
            v1_depth[0] = max(v1_depth[0], len(v1._dq))
            return req
        v1._dispatch_batch, v1.submit = dispatch_timed, submit_depth

        # the route's version at each admission, read under the registry
        # lock together with the admission itself (a roll takes the same
        # lock), keyed by the request's trace id
        admitted = {}
        submit = reg.submit

        def submit_recorded(name, x, deadline=None, version=None,
                            trace=None):
            with reg._lock:
                active = reg.active_version(name)
                req = submit(name, x, deadline=deadline, version=version,
                             trace=trace)
            admitted[req.trace.trace_id] = active
            return req
        reg.submit = submit_recorded

        # the replay lasts as long as the phase needs it: v2's load,
        # then SWAP_S s in which the route rolls, rolls back and rolls
        # again, and then it stops. v2's load took 0.6-2.5 s on a quiet
        # host and 4.2, 10.6, 13.0 and 22.1 s on contended ones, whose
        # GIL v2's eager warm-up forwards share with v1's server and the
        # HTTP threads, so the schedule holds 8192 requests (54.6 s at
        # 150 requests/s) and is cut when the swaps are done
        SWAP_S = 5.0
        load = ServingLoad.seeded(seed=0, mix="steady", n=8192, rps=150,
                                  max_rows=8)
        for spec in load.specs:
            spec.deadline = 5.0

        def tokens(rng, spec):
            return rng.randint(0, cfg.vocab_size, (spec.rows, T)).astype(
                np.int32)
        feats = load.features((T,), make=tokens)
        out, stop = {}, threading.Event()
        ck.reset_counts()
        launches0 = dict(ck.LAUNCHES)
        t_start = time.perf_counter()
        replay = threading.Thread(target=lambda: out.setdefault(
            "res", load.replay_http(ingress.url, "bert", (T,), make=tokens,
                                    stop=stop)))
        replay.start()
        # v2's load starts under traffic: once the replay has encoded its
        # bodies (about a second for 4096) and sent for 0.3 s
        while load.replay_started is None and replay.is_alive():
            time.sleep(0.01)
        time.sleep(0.3)
        b0 = v1.stats()["batches"]
        split0 = cc.cache_stats()["compile_seconds"]
        # each bucket's capture, timed: its warm-up runs lie before it
        captures, record = [], cc._record

        def record_timed(*a, **kw):
            t = time.perf_counter()
            try:
                return record(*a, **kw)
            finally:
                captures.append((t, time.perf_counter()))
        cc._record = record_timed
        t0 = time.perf_counter()
        try:
            reg.load("bert", lms[2].logits)
        finally:
            cc._record = record
        t1 = time.perf_counter()
        load_s = t1 - t0
        split = {k: cc.cache_stats()["compile_seconds"][k] - split0[k]
                 for k in ("warmup", "enter", "capture")}
        v1_batches = v1.stats()["batches"] - b0
        v2 = reg.server("bert", 2)
        # the split goes out before any check, so a long load that fails
        # the phase still says which stretch took the time
        log(f"v2's load [{smi}]: {load_s:.3f} s = eager warm-up "
            f"{split['warmup']:.3f} s + capture entry {split['enter']:.3f} s "
            f"+ capture {split['capture']:.3f} s (+ "
            f"{load_s - sum(split.values()):.3f} s besides) over "
            f"{len(captures)} buckets")
        left = load.duration() - (time.perf_counter()
                                  - (load.replay_started or t_start))
        if left < SWAP_S + 0.3:
            stop.set()
            fail(f"v2's load took {load_s:.2f} s: the replay's schedule "
                 f"of {load.duration():.2f} s ends before the swaps")
        t_sw = time.perf_counter()
        swaps = SwapSchedule([(0.15 * SWAP_S, "bert", 2),
                              (0.5 * SWAP_S, "bert", "rollback"),
                              (0.85 * SWAP_S, "bert", 2)]).start(reg)
        performed = swaps.join(60)
        stop.wait(max(0.0, t_sw + SWAP_S - time.perf_counter()))
        stop.set()
        replay.join(120)
        wall = time.perf_counter() - load.replay_started
        if replay.is_alive():
            fail("the HTTP replay did not finish within 120 s")
        traffic = {k: ck.LAUNCHES[k] - launches0[k] for k in ck.KERNELS}
        torch.cuda.synchronize()
        both_gb = (torch.cuda.memory_allocated() - base) / 1e9
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        res = out["res"]
        log(f"v2 loaded and captured {v2._dispatch.warmed_signatures()} "
            f"graphs in {load_s:.2f} s while v1 served {v1_batches} "
            f"batches; swaps {[(round(a, 3), act, r) for a, _, act, r in performed]}")
        ends = np.asarray(v1_ends)
        during = np.concatenate([ends[ends < t0][-1:],
                                 ends[(ends >= t0) & (ends <= t1)],
                                 ends[ends > t1][:1]])
        gaps = np.diff(during)
        # v1 alone on the card: between the rollback and the second roll
        alone = np.diff(ends[(ends > t_sw + 0.5 * SWAP_S + 0.05)
                             & (ends < t_sw + 0.85 * SWAP_S - 0.05)])
        # the stretch of the load that overlaps the longest gap most
        stretches, prev = [], t0
        for i, (a, b) in enumerate(captures):
            stretches += [(f"bucket {i}'s warm-up", prev, a),
                          (f"bucket {i}'s capture", a, b)]
            prev = b
        worst = ""
        if len(gaps):
            g0, g1 = during[int(gaps.argmax())], during[int(gaps.argmax()) + 1]
            worst = max(stretches, key=lambda st: min(st[2], g1)
                        - max(st[1], g0))[0] if stretches else ""
        log(f"v2's load [{smi}]: v1's longest gap between two batches "
            f"while v2 loads {1e3 * gaps.max(initial=0.0):.2f} ms (over "
            f"{len(gaps)} gaps, mostly in {worst or 'none'}), while it "
            f"serves alone after the rollback "
            f"{1e3 * alone.max(initial=0.0):.2f} ms (over {len(alone)} "
            f"gaps); v1's peak queue depth {v1_depth[0]} of {v1.max_queue}")
        if v1_batches == 0:
            fail("v1 dispatched no batch while v2 captured")
        if v2._dispatch.warmed_signatures() != len(v2.buckets()):
            fail(f"v2 captured {v2._dispatch.warmed_signatures()} graphs, "
                 f"want {len(v2.buckets())}")
        if [p[2] for p in performed] != ["roll", "rollback", "roll"]:
            fail(f"swaps {performed}: want roll, rollback, roll")

        # every request answered exactly once, with 200, by the version
        # that was routed at its admission
        codes = [o[0] if isinstance(o, tuple) else o for _, o in res]
        if codes.count(200) != len(res):
            fail(f"{len(res) - codes.count(200)} of {len(res)} requests "
                 f"not answered 200: {sorted(set(map(str, codes)))}")
        by_version = {1: [], 2: []}
        for i, (spec, (code, payload)) in enumerate(res):
            want_v = admitted.get(payload["trace_id"])
            if payload["version"] != want_v:
                fail(f"request {i} answered by v{payload['version']}, "
                     f"routed to v{want_v} at admission")
            by_version[payload["version"]].append(
                (feats[i], np.asarray(payload["predictions"])))
        if len(admitted) != len(res):
            fail(f"{len(admitted)} admissions for {len(res)} requests")
        for sv in (v1, v2):
            n_done = sv.counts["completed"]
            if sv.recompiles_after_warmup() or sv.captures_after_warmup():
                fail(f"{sv.name}: recompiles_after_warmup "
                     f"{sv.recompiles_after_warmup()}, captures after warmup "
                     f"{sv.captures_after_warmup()}: want 0")
            if n_done != len(by_version[int(sv.name[-1])]):
                fail(f"{sv.name} completed {n_done} requests, the wire "
                     f"says {len(by_version[int(sv.name[-1])])}")
        stats = cc.cache_stats()
        if stats["capture_failures"]:
            fail(f"capture failures: {stats}")
        # during traffic only v2's load ran kernels eagerly: its warm-up
        # runs, its captures and one replay a bucket
        per = (cc.WARMUP_RUNS + 1) * len(v2.buckets())
        want = {k: 0 for k in ck.KERNELS}
        want.update(flash_attention=12 * per, layer_norm=25 * per)
        if traffic != want:
            fail(f"launches during traffic {traffic}: want {want} (v2's "
                 "warmup alone), i.e. no eager launch by v1")

        agree = total = 0
        for v, items in by_version.items():
            if not items:
                continue
            x = np.concatenate([f for f, _ in items])
            got = np.concatenate([p for _, p in items])
            want_a = np.concatenate([
                lms[v].logits(x[i:i + 32]).argmax(-1).to(
                    torch.int32).cpu().numpy()
                for i in range(0, len(x), 32)])
            agree += int((got == want_a).sum())
            total += want_a.size
        frac = agree / total
        log(f"front door: {len(res)} requests over HTTP, all 200, v1 "
            f"{len(by_version[1])} / v2 {len(by_version[2])}; answers agree "
            f"with a direct argmax of their version on {agree}/{total} "
            f"tokens ({frac:.5f})")
        if frac < 0.999:
            fail(f"front-door argmax agreement {frac:.5f} < 0.999")

        wire = sorted(s for s in load.wire_seconds if s is not None)
        n_tok = sum(spec.rows for spec, _ in res) * T
        log(f"front door [{smi}]: {n_tok / wall:.1f} tokens/s over "
            f"{wall:.2f} s ({n_tok} tokens, offered {res[-1][0].at:.2f} s "
            f"at 150 requests/s); wire latency p50 "
            f"{1e3 * float(np.percentile(wire, 50)):.2f} ms, p99 "
            f"{1e3 * float(np.percentile(wire, 99)):.2f} ms; v2 load and "
            f"capture {load_s:.2f} s; two versions loaded hold "
            f"{both_gb:.3f} GB (weights, graphs, the allocator's blocks), "
            f"peak {peak_gb:.3f} GB, over the phase's start")

        for path, keys in (("/v1/models", {"models"}),
                           ("/v1/load", {"models", "totals"}),
                           ("/healthz", {"status"}),
                           ("/readyz", {"ready"})):
            with urllib.request.urlopen(ingress.url + path,
                                        timeout=30) as r:
                body = json.loads(r.read())
                if r.status != 200 or set(body) != keys:
                    fail(f"GET {path}: {r.status} {sorted(body)}")
        route = reg.models()["bert"]
        if set(route) != {"active", "previous", "canary", "canary_fraction",
                          "accepts_images", "versions"} \
                or route["active"] != 2:
            fail(f"/v1/models route {route}")

        # a 1 ms deadline behind a full queue comes back 504
        active = reg.server("bert")
        backlog = [active.submit(np.zeros((8, T), np.int32))
                   for _ in range(64)]
        conn = http.client.HTTPConnection("127.0.0.1", ingress.port,
                                          timeout=30)
        body = json.dumps({"instances": np.zeros((1, T), int).tolist(),
                           "deadline_ms": 1}).encode()
        conn.request("POST", "/v1/models/bert:predict", body,
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        late = json.loads(r.read())
        conn.close()
        for h in backlog:
            h.get(60)
        if r.status != 504 or late.get("type") != "DeadlineExceededError":
            fail(f"a 1 ms deadline behind a full queue answered {r.status} "
                 f"{late}")
        log(f"a 1 ms deadline behind 64 queued requests: 504 "
            f"{late['type']}, latency_ms {late.get('latency_ms')}")
    finally:
        if ingress is not None:
            ingress.stop()
        reg.close()
    del lms
    torch.cuda.empty_cache()


def bert_train(smi: str) -> None:
    """Phases 12 and 13: the BertBench step eagerly, then captured."""
    import torch

    from deeplearning4j_tpu_torch.analysis import churn
    from deeplearning4j_tpu_torch.nn import compilecache as cc
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.profile_fit import (BertBench,
                                                      dense_bf16_peak,
                                                      train_flops_per_token)
    # -------------------------------- 12. the BertBench training step
    bench = BertBench()
    log(f"BertBench BERT-base: {bench.n_params} parameters, bf16, flash, "
        f"B={bench.batch}, T={bench.seq}, Adam 1e-4")
    b_losses = [float(bench.step()) for _ in range(2)]
    torch.cuda.reset_peak_memory_stats()
    ck.reset_counts()
    b_ms = []
    for _ in range(BERT_STEPS):
        t0 = time.perf_counter()
        b_losses.append(float(bench.step()))     # a float: waits for it
        b_ms.append((time.perf_counter() - t0) * 1e3)
    b_launches, b_routes = dict(ck.LAUNCHES), dict(ck.FLASH_ROUTES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not all(np.isfinite(b_losses)):
        fail(f"BertBench losses not finite: {b_losses}")
    want = {k: 0 for k in ck.KERNELS}
    want.update(flash_attention=12 * BERT_STEPS, layer_norm=25 * BERT_STEPS)
    if b_launches != want or any(ck.PLAIN_CALLS.values()) \
            or b_routes != {"tensor_core": 12 * BERT_STEPS, "cuda_core": 0}:
        fail(f"BertBench launch counts {b_launches}, routes {b_routes} "
             f"(plain {dict(ck.PLAIN_CALLS)}) over {BERT_STEPS} steps: want "
             "12 tensor-core flash and 25 layer_norm launches a step")
    eager_ms = float(np.median(b_ms))
    tokens = bench.batch * bench.seq
    flops = train_flops_per_token(bench.cfg, bench.seq)
    peak = dense_bf16_peak(torch.cuda.get_device_name(0))
    log(f"BertBench MFU {flops * tokens / (eager_ms / 1e3) / peak:.4f} "
        f"({flops:.4g} FLOPs a token, bench.py's count, against "
        f"{peak / 1e12:.0f} TFLOP/s dense bf16) [{smi}]")
    log(f"BertBench eager step ms median {eager_ms:.2f} (min "
        f"{min(b_ms):.2f}, max {max(b_ms):.2f}), "
        f"{bench.batch / (eager_ms / 1e3):.1f} samples/s, "
        f"{tokens / (eager_ms / 1e3):.1f} tokens/s, peak {peak_gb:.2f} GB; "
        f"losses {', '.join(f'{v:.5f}' for v in b_losses)}; launches a step "
        f"12 flash (tensor cores), 25 layer_norm [{smi}]")

    # ------------------------------- 13. the BertBench step, captured
    s0 = snapshot(bench.state())
    held = {}
    for run in ("eager 1", "eager 2"):
        restore(bench.state(), s0)
        held[run] = (float(bench.step()), snapshot(bench.state()))
    restore(bench.state(), s0)
    cc.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    disp = bench.captured()
    args = (bench.tokens, bench.targets, bench.mask)
    t0 = time.perf_counter()
    disp.warm(*args)
    capture_s = time.perf_counter() - t0
    same_after_warm = all(torch.equal(a, b)
                          for a, b in zip(bench.state(), s0))
    ck.reset_counts()
    c_loss = float(disp(*args))
    held["captured"] = (c_loss, snapshot(bench.state()))
    names = tree_names(bench.params) + tree_names(bench.opt) + ["t"]
    hold_captured("BertBench", held, names,
                  [n.rsplit(".", 1)[0] if n.endswith((".m", ".v")) else n
                   for n in names])
    churn.get_churn_detector().record(
        "bert.train_step", churn.array_fingerprint(*args), owner=disp)
    c_ms = []
    for _ in range(BERT_STEPS):
        t0 = time.perf_counter()
        loss = float(disp(*args))
        c_ms.append((time.perf_counter() - t0) * 1e3)
        churn.get_churn_detector().record(
            "bert.train_step", churn.array_fingerprint(*args), owner=disp)
        if not np.isfinite(loss):
            fail(f"captured BertBench loss not finite: {loss}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    stats = cc.cache_stats()
    n_sig = churn.get_churn_detector().signature_count("bert.train_step",
                                                       owner=disp)
    at_capture = disp.launches_at_capture()
    replays = dict(ck.REPLAYS)
    if not same_after_warm:
        fail("capturing the BertBench step changed its state")
    if at_capture != [{"flash_attention": 12, "layer_norm": 25}]:
        fail(f"the captured BertBench step recorded {at_capture}: want 12 "
             "flash_attention and 25 layer_norm launches")
    if any(ck.LAUNCHES.values()) or replays["flash_attention"] != \
            12 * (BERT_STEPS + 1) or replays["layer_norm"] != \
            25 * (BERT_STEPS + 1):
        fail(f"replays ran launches {dict(ck.LAUNCHES)} eagerly and "
             f"{replays} replayed over {BERT_STEPS + 1} replays")
    if stats["capture_failures"] or stats["compile_seconds"][
            "cold_compiles"] != 1 or n_sig != 1 \
            or stats["memory"]["hits"] != BERT_STEPS + 1:
        fail(f"captured BertBench: cache stats {stats}, {n_sig} churn "
             "signatures: want one capture, no failure, every call a hit")
    cap_ms = float(np.median(c_ms))
    log(f"BertBench captured step ms median {cap_ms:.2f} (min "
        f"{min(c_ms):.2f}, max {max(c_ms):.2f}), "
        f"{bench.batch / (cap_ms / 1e3):.1f} samples/s, MFU "
        f"{flops * tokens / (cap_ms / 1e3) / peak:.4f}, speed-up over eager "
        f"{eager_ms / cap_ms:.3f}x; capture {capture_s:.2f} s; peak "
        f"{peak_gb:.2f} GB; cache_stats {stats}; churn signatures {n_sig}; "
        f"replayed launches {replays} [{smi}]")



def lenet(smi: str) -> dict:
    """Phase 16: LeNet-5 fit through the iterator, eager then K=4,
    evaluated, and its archive and clone held to the bit. Returns the
    K=4 ms a step, the peak bytes of that fit and the bytes allocated
    before the net was built."""
    import torch

    from deeplearning4j_tpu_torch.data.iterators import MnistDataSetIterator
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn import compilecache as cc
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    train = MnistDataSetIterator(64, True, num_examples=2048)
    test = MnistDataSetIterator(256, False, num_examples=512)
    live_before = torch.cuda.memory_allocated()
    net = zoo.LeNet(num_classes=10).init()
    log(f"LeNet-5: {net.numParams()} parameters, preprocessors "
        f"{ {i: type(p).__name__ for i, p in net.conf.preprocessors.items()} }"
        f", {'synthetic' if train.synthetic else 'IDX'} digits, "
        f"{train.data.numExamples()} to train, fp32")
    per_epoch = -(-train.data.numExamples() // 64)
    t0 = time.perf_counter()
    net.fit(train, epochs=LENET_EPOCHS)
    first = net.score()
    eager_s = time.perf_counter() - t0
    cc.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    net.fit(train, epochs=LENET_EPOCHS, steps_per_dispatch=MEGA_K)
    last = net.score()
    cap_s = time.perf_counter() - t0
    peak_bytes = torch.cuda.max_memory_allocated()
    stats = cc.cache_stats()
    if stats["capture_failures"] or \
            stats["compile_seconds"]["cold_compiles"] != 1:
        fail(f"LeNet K={MEGA_K} fit: cache stats {stats}: want one capture "
             "and no failure")
    if not (np.isfinite(first) and np.isfinite(last)) or \
            net.getIterationCount() != 2 * LENET_EPOCHS * per_epoch:
        fail(f"LeNet: losses {first}, {last}, {net.getIterationCount()} "
             "iterations")
    t0 = time.perf_counter()
    ev = net.evaluate(test)
    eval_s = time.perf_counter() - t0
    acc = ev.accuracy()
    steps = LENET_EPOCHS * per_epoch
    log(f"LeNet fit: {LENET_EPOCHS} epochs a step a dispatch in "
        f"{eager_s:.2f} s ({1e3 * eager_s / steps:.2f} ms a step, loss "
        f"{first:.5f}), {LENET_EPOCHS} at K={MEGA_K} in {cap_s:.2f} s "
        f"({1e3 * cap_s / steps:.2f} ms a step, loss {last:.5f}; capture "
        f"{stats['compile_seconds']['cold']:.2f} s); evaluate on "
        f"{test.data.numExamples()}: accuracy {acc:.4f} in {eval_s:.3f} s "
        f"[{smi}]")
    if acc < 0.99:
        fail(f"LeNet accuracy {acc:.4f} < 0.99\n{ev.stats()}")
    x = test.data.features
    out = net.output(x)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "lenet.zip")
        net.save(path)
        back = MultiLayerNetwork.load(path)
    if back.getIterationCount() != net.getIterationCount() or \
            not torch.equal(back.output(x), out) or \
            not torch.equal(net.clone().output(x), out):
        fail("LeNet: save -> load -> output() or clone().output() is not "
             "bit-equal to output()")
    log("LeNet save -> load -> output() and clone().output(): bit-equal")
    return {"captured_ms": 1e3 * cap_s / steps, "peak_bytes": peak_bytes,
            "live_before": live_before}


def vgg16(smi: str) -> dict:
    """Phase 17: VGG16 at full width, dropout drawn on the device clock,
    eager against captured to the bit. Returns the captured fit's
    numbers (``captured_fit``)."""
    import torch

    from deeplearning4j_tpu_torch import profile_fit
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.ops import normalization as norm_ops
    dev = torch.device("cuda")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        live_before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        net = zoo.VGG16(num_classes=1000).init()
        net.setPrecisionPolicy("bf16")
        net.setComputeLayout("NHWC")
        net.setEpilogueFusion(True)
        n_params = net.numParams()
        dropped = [i for i, a in enumerate(net.layers) if a.dropout]
        log(f"VGG16: {n_params} parameters, dropout (retain 0.5) on the "
            f"inputs of layers {dropped}, bf16 policy, NHWC, built in "
            f"{time.perf_counter() - t0:.2f} s")
        if n_params != 138_357_544:
            fail(f"VGG16 has {n_params} parameters, want 138,357,544")
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal(
            (VGG_BATCH, 3, 224, 224), dtype=np.float32)).to(dev)
        y = torch.from_numpy(np.eye(1000, dtype=np.float32)[
            rng.integers(0, 1000, VGG_BATCH)]).to(dev)
        ds = DataSet(x, y)
        fc1 = dropped[0]
        n_in = net.layers[fc1].nIn
        # the warm step, its mask draws counted; an eval-mode output draws
        # none
        draws, real = [], norm_ops.dropout_mask

        def counted(key, shape, keep, device):
            draws.append((key.path, tuple(shape), keep))
            return real(key, shape, keep, device)
        norm_ops.dropout_mask = counted
        try:
            t0 = time.perf_counter()
            net.fit(ds)
            losses = [net.score()]
            warm_s = time.perf_counter() - t0
            want = [((fc1,), (VGG_BATCH, n_in), 0.5),
                    ((dropped[1],), (VGG_BATCH, 4096), 0.5)]
            if draws != want:
                fail(f"VGG16 train step drew masks {draws}, want {want}")
            draws.clear()
            probs = net.output(x[:8])
            if draws:
                fail(f"VGG16 output() drew dropout masks: {draws}")
        finally:
            norm_ops.dropout_mask = real
        if tuple(probs.shape) != (8, 1000) or \
                not bool(torch.isfinite(probs).all()):
            fail(f"VGG16 output of shape {tuple(probs.shape)}, or not finite")
        torch.cuda.reset_peak_memory_stats()
        step_ms = []
        for _ in range(VGG_STEPS):
            t0 = time.perf_counter()
            net.fit(ds)
            losses.append(net.score())
            step_ms.append((time.perf_counter() - t0) * 1e3)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        if not all(np.isfinite(losses)):
            fail(f"VGG16 losses not finite: {losses}")
        flops = 3 * profile_fit.vgg16_flops(224) * VGG_BATCH
        peak = profile_fit.dense_bf16_peak(torch.cuda.get_device_name(0))
        med = float(np.median(step_ms))
        log(f"VGG16 fit B={VGG_BATCH}: warm step {warm_s:.2f} s; losses "
            f"{', '.join(f'{v:.5f}' for v in losses)}; eager step ms median "
            f"{med:.2f} (min {min(step_ms):.2f}, max {max(step_ms):.2f}), "
            f"{VGG_BATCH / (med / 1e3):.1f} images/s, MFU "
            f"{flops / (med / 1e3) / peak:.4f} ({flops / 1e12:.3f} TFLOP a "
            f"step), peak {peak_gb:.2f} GB [{smi}]")
        # fc1's masks over 8 steps, and drawn inside a CUDA graph on its clock
        seed = net.conf.base.seed
        clock = torch.zeros((), dtype=torch.int32, device=dev)
        masks = []
        for t in range(2 * MEGA_K):
            clock.fill_(t)
            masks.append(real(norm_ops.StepKey(seed, clock).fold(fc1),
                              (VGG_BATCH, n_in), 0.5, dev))
        keep = [float(m.float().mean()) for m in masks]
        change = [float((a != b).float().mean())
                  for a, b in zip(masks, masks[1:])]
        clock.zero_()
        drawn = torch.empty((VGG_BATCH, n_in), dtype=torch.bool, device=dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            drawn.copy_(real(norm_ops.StepKey(seed, clock).fold(fc1),
                             (VGG_BATCH, n_in), 0.5, dev))
            clock.add_(1)
        replayed = []
        for _ in range(2 * MEGA_K):
            graph.replay()
            replayed.append(torch.equal(drawn, masks[len(replayed)]))
        log(f"VGG16 fc1 masks [{VGG_BATCH}, {n_in}] at t = 0-7: kept "
            f"{', '.join(f'{k:.4f}' for k in keep)}; changed between steps "
            f"{', '.join(f'{c:.4f}' for c in change)}; a graph's replays equal "
            f"the eager draws: {replayed}")
        if any(abs(k - 0.5) > 0.01 for k in keep) or \
                any(not 0.45 < c < 0.55 for c in change) or not all(replayed):
            fail("VGG16 fc1 masks: keep rate off 0.5 +- 0.01, masks not "
                 "changing between steps, or a replay unequal to eager")
        del graph, drawn, masks
        res = captured_fit("VGG16", net, ds, 0, smi, exact=True,
                           live_before=live_before)
        log(f"VGG16 captured K={MEGA_K}: step ms {res['captured_ms']:.2f}, "
            f"{VGG_BATCH / (res['captured_ms'] / 1e3):.1f} images/s, MFU "
            f"{flops / (res['captured_ms'] / 1e3) / peak:.4f}; eager step "
            f"ms {res['eager_ms']:.2f} in that comparison [{smi}]")
        eager = profile_fit.profile(lambda: (net.fit(ds), net.score()),
                                    "vgg16", False)
        group = [ds] * MEGA_K
        captured = profile_fit.profile(
            lambda: (net.fit(group, steps_per_dispatch=MEGA_K), net.score()),
            "vgg16", True)
        for what, tr, steps in (("eager step", eager, 1),
                                (f"captured dispatch of {MEGA_K}", captured,
                                 MEGA_K)):
            log(f"VGG16 traced {what}: {tr['traced_ms']:.2f} ms host, "
                f"{tr['traced_device_ms']:.2f} ms device in "
                f"{tr['device_kernels']} kernels ({tr['traced_device_ms'] / steps:.2f} "
                f"ms a step), busy {tr['device_busy_share_traced']:.3f}; by "
                f"group {json.dumps(tr['device_ms_by_group'])} [{smi}]")
        del net, ds, x, y
        return res
    finally:
        torch.backends.cudnn.deterministic = deterministic


def darknet19(smi: str) -> tuple:
    """Phase 18: Darknet19 on the ``scale_shift_act`` kernel; returns the
    kernel's launches over the eager steps and the captured fit's
    numbers (``captured_fit``)."""
    import torch

    from deeplearning4j_tpu_torch import profile_fit
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.ops import registry
    dev = torch.device("cuda")
    ck.install_platform_overrides()

    def build():
        net = zoo.Darknet19(num_classes=1000).init()
        net.setPrecisionPolicy("bf16")
        net.setComputeLayout("NHWC")
        net.setEpilogueFusion(True)
        return net
    live_before = torch.cuda.memory_allocated()
    net = build()
    plan = net._ensure_epilogue_plan()
    log(f"Darknet19: {net.numParams()} parameters, {len(net.layers)} layers, "
        f"{len(plan)} fused conv-BN-leaky blocks, bf16 policy, NHWC")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (DARKNET_BATCH, 3, 224, 224), dtype=np.float32)).to(dev)
    y = torch.from_numpy(np.eye(1000, dtype=np.float32)[
        rng.integers(0, 1000, DARKNET_BATCH)]).to(dev)
    ds = DataSet(x, y)
    net.fit(ds)
    losses = [net.score()]
    ck.reset_counts()
    step_ms = []
    for _ in range(DARKNET_STEPS):
        t0 = time.perf_counter()
        net.fit(ds)
        losses.append(net.score())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(ck.LAUNCHES)
    want = {k: 0 for k in ck.KERNELS}
    want["scale_shift_act"] = 18 * DARKNET_STEPS
    if launches != want or any(ck.PLAIN_CALLS.values()) or \
            not all(np.isfinite(losses)):
        fail(f"Darknet19 fit: launches {launches} (plain "
             f"{dict(ck.PLAIN_CALLS)}) over {DARKNET_STEPS} steps, losses "
             f"{losses}: want 18 scale_shift_act launches a step, finite")
    med = float(np.median(step_ms))
    log(f"Darknet19 fit B={DARKNET_BATCH}: losses "
        f"{', '.join(f'{v:.5f}' for v in losses)}; eager step ms median "
        f"{med:.2f} (min {min(step_ms):.2f}, max {max(step_ms):.2f}), "
        f"{DARKNET_BATCH / (med / 1e3):.1f} images/s; launches {launches} "
        f"[{smi}]")
    res = captured_fit("Darknet19", net, ds, 18, smi,
                       live_before=live_before)
    group = [ds] * MEGA_K
    for what, tr, steps in (
            ("eager step", profile_fit.profile(
                lambda: (net.fit(ds), net.score()), "darknet19", False), 1),
            (f"captured dispatch of {MEGA_K}", profile_fit.profile(
                lambda: (net.fit(group, steps_per_dispatch=MEGA_K),
                         net.score()), "darknet19", True), MEGA_K)):
        log(f"Darknet19 traced {what}: {tr['traced_ms']:.2f} ms host, "
            f"{tr['traced_device_ms']:.2f} ms device in "
            f"{tr['device_kernels']} kernels "
            f"({tr['traced_device_ms'] / steps:.2f} ms a step), busy "
            f"{tr['device_busy_share_traced']:.3f}; by group "
            f"{json.dumps(tr['device_ms_by_group'])} [{smi}]")
    del net
    net = build()
    ck.reset_counts()
    probs = net.output(x)
    out_launches = ck.LAUNCHES["scale_shift_act"]
    registry.register_platform_override("scale_shift_act", ssa_plain)
    probs_plain = net.output(x)
    ck.install_platform_overrides()
    if out_launches != 18 or tuple(probs.shape) != (DARKNET_BATCH, 1000) or \
            not bool(torch.isfinite(probs).all()):
        fail(f"Darknet19 output: {out_launches} launches, shape "
             f"{tuple(probs.shape)}: want 18 and finite [{DARKNET_BATCH}, "
             "1000]")
    dp = (probs - probs_plain).abs()
    pmax = float(probs_plain.max())
    log(f"Darknet19 output kernel vs plain: max|diff| {float(dp.max()):.4g}, "
        f"mean|diff| {float(dp.mean()):.4g}, max p {pmax:.4g}")
    if float(dp.max()) > 0.05 * pmax or float(dp.mean()) > 2e-3 * pmax:
        fail("kernel and plain Darknet19 forwards disagree beyond the bound "
             "(max 5%, mean 0.2% of max p)")
    return launches["scale_shift_act"], res


def resnet_back(path: str, x, probs) -> None:
    """Phase 18's end: phase 5's ResNet-50 archive through
    ``ComputationGraph.load``, its output to the bit."""
    import torch

    from deeplearning4j_tpu_torch.nn.graph import ComputationGraph
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    ck.install_platform_overrides()
    t0 = time.perf_counter()
    net = ComputationGraph.load(path)
    net.setPrecisionPolicy("bf16")
    net.setComputeLayout("NHWC")
    net.setEpilogueFusion(True)
    load_s = time.perf_counter() - t0
    out = net.output(x)
    if not torch.equal(out, probs):
        fail(f"ResNet-50 loaded from its archive: output differs from "
             f"phase 5's, max|diff| {float((out - probs).abs().max()):.3g}")
    log(f"ResNet-50 ComputationGraph.load in {load_s:.2f} s (iteration "
        f"{net.getIterationCount()}): output() bit-equal to phase 5's")


def yolo2(smi: str) -> tuple:
    """Phase 19: YOLO2 at full width through ``ComputationGraph.fit``;
    returns the ``scale_shift_act`` launches of its eager steps and the
    captured fit's numbers (``captured_fit``)."""
    import torch

    from deeplearning4j_tpu_torch import profile_fit
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.objdetect import YoloUtils, yolo_labels
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.ops import registry
    dev = torch.device("cuda")
    ck.install_platform_overrides()

    model = zoo.YOLO2(num_classes=YOLO2_CLASSES)
    c, h, w = model.input_shape
    grid = h // 32

    def build():
        net = model.init()
        net.setPrecisionPolicy("bf16")
        net.setComputeLayout("NHWC")
        net.setEpilogueFusion(True)
        return net
    live_before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    net = build()
    plan = net._ensure_epilogue_plan()
    per_image = profile_fit.conv_flops(net)
    log(f"YOLO2: {net.numParams()} parameters, {len(net.conf.topo)} nodes, "
        f"{len(plan)} fused conv-BN-leaky blocks, {YOLO2_CLASSES} classes, "
        f"{c}x{h}x{w}, bf16 policy, NHWC, built in "
        f"{time.perf_counter() - t0:.2f} s; the convs' forward "
        f"{per_image / 1e9:.3f} GFLOP an image")
    if len(plan) != 21:
        fail(f"YOLO2 fuses {len(plan)} blocks, want 21")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (YOLO2_BATCH, c, h, w), dtype=np.float32)).to(dev)
    y = torch.from_numpy(yolo_labels(rng, YOLO2_BATCH, YOLO2_CLASSES,
                                     grid)).to(dev)
    ds = DataSet(x, y)
    t0 = time.perf_counter()
    net.fit(ds)
    losses = [net.score()]
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ck.reset_counts()
    step_ms = []
    for _ in range(YOLO2_STEPS):
        t0 = time.perf_counter()
        net.fit(ds)
        losses.append(net.score())
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = dict(ck.LAUNCHES)
    plain = dict(ck.PLAIN_CALLS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {k: 0 for k in ck.KERNELS}
    want["scale_shift_act"] = 21 * YOLO2_STEPS
    if launches != want or any(plain.values()) or \
            not all(np.isfinite(losses)):
        fail(f"YOLO2 fit: launches {launches} (plain {plain}) over "
             f"{YOLO2_STEPS} steps, losses {losses}: want 21 scale_shift_act "
             "launches a step, finite")
    flops = 3 * per_image * YOLO2_BATCH
    peak = profile_fit.dense_bf16_peak(torch.cuda.get_device_name(0))
    med = float(np.median(step_ms))
    log(f"YOLO2 fit B={YOLO2_BATCH}: warm step {warm_s:.2f} s; losses "
        f"{', '.join(f'{v:.5f}' for v in losses)}; eager step ms median "
        f"{med:.2f} (min {min(step_ms):.2f}, max {max(step_ms):.2f}), "
        f"{YOLO2_BATCH / (med / 1e3):.1f} images/s, MFU "
        f"{flops / (med / 1e3) / peak:.4f} ({flops / 1e12:.3f} TFLOP a step), "
        f"peak {peak_gb:.2f} GB; launches {launches} [{smi}]")
    # eager against captured to the bit: cuDNN held to deterministic
    # algorithms for the comparison
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        res = captured_fit("YOLO2", net, ds, 21, smi, exact=True,
                           live_before=live_before)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log(f"YOLO2 captured K={MEGA_K} (deterministic cuDNN): step ms "
        f"{res['captured_ms']:.2f}, "
        f"{YOLO2_BATCH / (res['captured_ms'] / 1e3):.1f} images/s, MFU "
        f"{flops / (res['captured_ms'] / 1e3) / peak:.4f}; eager step ms "
        f"{res['eager_ms']:.2f} in that comparison [{smi}]")
    group = [ds] * MEGA_K
    for what, tr, steps in (
            ("eager step", profile_fit.profile(
                lambda: (net.fit(ds), net.score()), "yolo2", False), 1),
            (f"captured dispatch of {MEGA_K}", profile_fit.profile(
                lambda: (net.fit(group, steps_per_dispatch=MEGA_K),
                         net.score()), "yolo2", True), MEGA_K)):
        log(f"YOLO2 traced {what}: {tr['traced_ms']:.2f} ms host, "
            f"{tr['traced_device_ms']:.2f} ms device in "
            f"{tr['device_kernels']} kernels "
            f"({tr['traced_device_ms'] / steps:.2f} ms a step), busy "
            f"{tr['device_busy_share_traced']:.3f}; by group "
            f"{json.dumps(tr['device_ms_by_group'])} [{smi}]")
    # output() on a fresh net from the seed (a trained YOLO's wh outputs,
    # anchors * exp, may overflow), kernel against plain, then decoded
    del net
    net = build()
    ck.reset_counts()
    out = net.output(x)
    out_launches = ck.LAUNCHES["scale_shift_act"]
    registry.register_platform_override("scale_shift_act", ssa_plain)
    out_plain = net.output(x)
    ck.install_platform_overrides()
    n_ch = 5 * (5 + YOLO2_CLASSES)
    if out_launches != 21 or \
            tuple(out.shape) != (YOLO2_BATCH, n_ch, grid, grid) or \
            out.dtype != torch.float32 or not bool(torch.isfinite(out).all()):
        fail(f"YOLO2 output: {out_launches} launches, {tuple(out.shape)} "
             f"{out.dtype}: want 21 and finite fp32 [{YOLO2_BATCH}, {n_ch}, "
             f"{grid}, {grid}]")
    dp = (out - out_plain).abs()
    pmax = float(out_plain.abs().max())
    objs = YoloUtils.getPredictedObjects(zoo.YOLO2.ANCHORS, out)
    log(f"YOLO2 output kernel vs plain: max|diff| {float(dp.max()):.4g}, "
        f"mean|diff| {float(dp.mean()):.4g}, max|out| {pmax:.4g}; "
        f"getPredictedObjects: {len(objs)} objects in {YOLO2_BATCH} images")
    if float(dp.max()) > 0.05 * pmax or float(dp.mean()) > 2e-3 * pmax:
        fail("kernel and plain YOLO2 forwards disagree beyond the bound "
             "(max 5%, mean 0.2% of max|out|)")
    return launches["scale_shift_act"], res


def zoo_cnns(smi: str) -> dict:
    """Phase 20: each of ``ZOO_CNNS`` at its default input shape and
    classes, bf16 / NHWC / fused: a warm step, ``ZOO_STEPS`` eager steps
    (finite losses, its fused blocks' ``scale_shift_act`` launches and
    nothing else), ``output()`` of the right shape, finite. Returns each
    model's median eager step ms, the peak bytes of its eager steps and
    the bytes allocated before it was built."""
    import torch

    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    dev = torch.device("cuda")
    ck.install_platform_overrides()
    t_phase = time.perf_counter()
    measured = {}
    for name in ZOO_CNNS:
        model = getattr(zoo, name)()
        live_before = torch.cuda.memory_allocated()
        net = model.init()
        net.setPrecisionPolicy("bf16")
        net.setComputeLayout("NHWC")
        net.setEpilogueFusion(True)
        blocks = len(net._ensure_epilogue_plan())
        c, h, w = model.input_shape
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal(
            (ZOO_BATCH, c, h, w), dtype=np.float32)).to(dev)
        if name == "UNet":
            y = (rng.random((ZOO_BATCH, 1, h, w)) < 0.5).astype(np.float32)
            out_shape = (ZOO_BATCH, 1, h, w)
        else:
            y = np.eye(model.num_classes, dtype=np.float32)[
                rng.integers(0, model.num_classes, ZOO_BATCH)]
            out_shape = (ZOO_BATCH, model.num_classes)
        ds = DataSet(x, torch.from_numpy(y).to(dev))
        t0 = time.perf_counter()
        net.fit(ds)
        losses = [net.score()]
        warm_s = time.perf_counter() - t0
        ck.reset_counts()
        torch.cuda.reset_peak_memory_stats()
        step_ms = []
        for _ in range(ZOO_STEPS):
            t0 = time.perf_counter()
            net.fit(ds)
            losses.append(net.score())
            step_ms.append((time.perf_counter() - t0) * 1e3)
        peak_bytes = torch.cuda.max_memory_allocated()
        launches = dict(ck.LAUNCHES)
        want = {k: 0 for k in ck.KERNELS}
        want["scale_shift_act"] = blocks * ZOO_STEPS
        out = net.output(x)
        if launches != want or any(ck.PLAIN_CALLS.values()) or \
                not all(np.isfinite(losses)) or \
                tuple(out.shape) != out_shape or \
                not bool(torch.isfinite(out).all()):
            fail(f"{name}: launches {launches} (plain "
                 f"{dict(ck.PLAIN_CALLS)}), losses {losses}, output "
                 f"{tuple(out.shape)}: want {blocks} scale_shift_act launches "
                 f"a step, finite losses and a finite {out_shape} output")
        med = float(np.median(step_ms))
        log(f"{name} fit B={ZOO_BATCH} at {c}x{h}x{w}: {net.numParams()} "
            f"parameters, {blocks} fused blocks; warm step {warm_s:.2f} s; "
            f"losses {', '.join(f'{v:.5f}' for v in losses)}; eager step ms "
            f"median {med:.2f} (min {min(step_ms):.2f}, max "
            f"{max(step_ms):.2f}), {ZOO_BATCH / (med / 1e3):.1f} images/s; "
            f"output {tuple(out.shape)} [{smi}]")
        measured[name] = {"eager_ms": med, "peak_bytes": peak_bytes,
                          "live_before": live_before}
        del net, ds, x, out
    log(f"zoo CNNs: {len(ZOO_CNNS)} models in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return measured


def textgen(smi: str) -> None:
    """Phase 21: TextGenerationLSTM trained with truncated BPTT, eager and
    captured, then sampled through ``rnnTimeStep``; a masked batch
    through ``fit()`` under ``backpropType("tbptt", 50)``; the archive."""
    import torch

    from deeplearning4j_tpu_torch import profile_fit as pf
    from deeplearning4j_tpu_torch.analysis import churn
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn import compilecache as cc
    from deeplearning4j_tpu_torch.nn.config import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.train.updaters import Adam
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    B, T, W, V = TEXT_BATCH, pf.TEXT_LEN, pf.TEXT_WINDOW, pf.TEXT_VOCAB
    n_win = T // W
    idx = pf.markov_chars(TEXT_SEED, TEXT_BATCHES * B, T)
    batches = [DataSet(pf.one_hot_ncw(idx[b * B:(b + 1) * B, :-1]),
                       pf.one_hot_ncw(idx[b * B:(b + 1) * B, 1:]))
               for b in range(TEXT_BATCHES)]
    ck.reset_counts()
    net = zoo.TextGenerationLSTM().init()
    cpu = zoo.TextGenerationLSTM().init(device="cpu")
    x0c, y0c = batches[0].features.cpu(), batches[0].labels.cpu()
    cpu_first = float(cpu._fit_window(x0c[:, :, :W], y0c[:, :, :W], None,
                                      cpu._zero_carry(x0c))[0])
    del cpu

    # every window's output (loss, carry), read off the window step
    windows = []
    fit_window = net._fit_window

    def recording(*args):
        out = fit_window(*args)
        windows.append(out)
        return out
    net._fit_window = recording
    net._ensure_opt_state()
    net._ensure_clock()
    names = [f"{n}.{p}" for n, ps in net._items(net._params) for p in ps]
    names += [f"{n}.{p}.{m}" for n, ps in net._items(net._opt_state)
              for p, st in ps.items() for m in st]
    names.append("t")
    s0 = snapshot(net._dispatch_state())

    def train():
        """The three batches through fitTBPTT from the snapshot: the
        window losses, the state and the carry after every batch, and
        ms a window of each batch."""
        restore(net._dispatch_state(), s0)
        net._iteration = 0
        windows.clear()
        held, ms = [], []
        for ds in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            net.fitTBPTT(ds, W)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3 / n_win)
            held += snapshot(net._dispatch_state()) + \
                snapshot(list(windows[-1][1:]))
        return [float(w[0]) for w in windows], held, ms

    held, ms = {}, {}
    for run in ("eager 1", "eager 2"):
        losses, tensors, ms[run] = train()
        held[run] = (losses, tensors)
    restore(net._dispatch_state(), s0)
    cc.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9   # earlier phases' too
    t0 = time.perf_counter()
    cc.warmup(net, [(tuple(batches[0].features.shape),
                     tuple(batches[0].labels.shape))], tbptt_length=W)
    capture_s = time.perf_counter() - t0
    if not all(torch.equal(a, b) for a, b in zip(net._dispatch_state(), s0)):
        fail("textgen: compilecache.warmup changed the network's state")
    losses, tensors, ms["captured"] = train()
    held["captured"] = (losses, tensors)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - held_gb
    per_batch = [f"b{b}.{n}" for b in range(TEXT_BATCHES)
                 for n in names + ["carry.h0", "carry.c0", "carry.h1",
                                   "carry.c1"]]
    groups = [n.rsplit(".", 1)[0] if n.endswith((".m", ".v")) else n
              for n in per_batch]
    hold_captured("TextGenerationLSTM TBPTT", held, per_batch, groups)
    stats = cc.cache_stats()
    n_sig = churn.get_churn_detector().signature_count(
        "MultiLayerNetwork.tbptt", owner=net)
    if stats["capture_failures"] or stats["compile_seconds"][
            "cold_compiles"] != 1 or stats["memory"]["hits"] != \
            TEXT_BATCHES * n_win or n_sig != 1:
        fail(f"textgen: cache stats {stats}, {n_sig} churn signatures: want "
             f"one capture, no failure, {TEXT_BATCHES * n_win} hits")
    losses = held["eager 1"][0]
    if not all(np.isfinite(v) for run in held.values() for v in run[0]):
        fail(f"textgen: a loss is not finite: {losses}")
    rel = abs(losses[0] - cpu_first) / abs(cpu_first)
    if not rel <= 1e-4:
        fail(f"textgen: the first window's loss {losses[0]!r} on the card "
             f"is {rel:.3g} relative from the CPU's {cpu_first!r}")
    first = float(np.mean(losses[:n_win]))
    last = float(np.mean(losses[-n_win:]))
    if not last < first:
        fail(f"textgen: the last batch's mean window loss {last} is not "
             f"below the first batch's {first}")
    for run in ("eager 1", "captured"):
        w_ms = float(np.median(ms[run]))
        log(f"TextGenerationLSTM fitTBPTT {run}: {TEXT_BATCHES} batches of "
            f"B={B} x T={T}, window {W}: ms a window "
            f"{', '.join(f'{v:.2f}' for v in ms[run])} (median {w_ms:.2f}), "
            f"{B * W / (w_ms / 1e3):.0f} characters/s; window losses "
            f"{' '.join(f'{v:.2f}' for v in held[run][0])} [{smi}]")
    log(f"TextGenerationLSTM: {net.numParams()} parameters; first window "
        f"loss {losses[0]:.6f} (CPU {cpu_first:.6f}, {rel:.2g} relative); "
        f"mean window loss batch 1 {first:.4f} -> batch {TEXT_BATCHES} "
        f"{last:.4f}; capture {capture_s:.2f} s; peak {peak_gb:.3f} GB "
        f"over the {held_gb:.3f} GB held when the capture began; "
        f"cache_stats {stats} [{smi}]")
    del net._fit_window

    # --------------------------------------- generate through rnnTimeStep
    g = torch.Generator(device="cuda").manual_seed(TEXT_SEED)
    cur = torch.nn.functional.one_hot(
        torch.as_tensor(idx[:TEXT_SAMPLES, 0], device="cuda"), V).float()
    net.rnnClearPreviousState()
    sampled = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TEXT_SAMPLE_LEN):
        probs = net.rnnTimeStep(cur)
        nxt = torch.multinomial(probs, 1, generator=g)[:, 0]
        sampled.append(nxt)
        cur = torch.nn.functional.one_hot(nxt, V).float()
    torch.cuda.synchronize()
    gen_ms = (time.perf_counter() - t0) * 1e3 / TEXT_SAMPLE_LEN
    seq = torch.stack(sampled, dim=1)                       # [4, 300]
    if tuple(probs.shape) != (TEXT_SAMPLES, V) or \
            not bool(torch.isfinite(probs).all()):
        fail(f"textgen: rnnTimeStep gave {tuple(probs.shape)} "
             f"(finite: {bool(torch.isfinite(probs).all())})")
    xs = pf.one_hot_ncw(seq)
    full = net.output(xs)
    errs = {}
    for chunk in (1, 7, 50):
        net.rnnClearPreviousState()
        parts = [net.rnnTimeStep(xs[:, :, i:i + chunk])
                 for i in range(0, TEXT_SAMPLE_LEN, chunk)]
        errs[chunk] = float((torch.cat(parts, dim=2) - full).abs().max())
    cont = net.rnnTimeStep(xs[:, :, :7])
    net.rnnClearPreviousState()
    fresh = net.rnnTimeStep(xs[:, :, :7])
    restart = float((fresh - full[:, :, :7]).abs().max())
    if not max(errs.values()) <= 1e-5 or not restart <= 1e-5 or \
            torch.equal(cont, fresh):
        fail(f"textgen: rnnTimeStep in chunks against output(): max|diff| "
             f"{errs}, after rnnClearPreviousState {restart}, continuing "
             f"equals fresh: {torch.equal(cont, fresh)}")
    text = ["".join(chr(33 + int(c)) for c in row) for row in seq.tolist()]
    log(f"TextGenerationLSTM generate: {TEXT_SAMPLES} x {TEXT_SAMPLE_LEN} "
        f"characters through rnnTimeStep, {gen_ms:.3f} ms a character "
        f"({TEXT_SAMPLES * 1e3 / gen_ms:.0f} characters/s); streaming "
        f"against output() max|diff| by chunk {errs}, restart {restart:.3g}; "
        f"samples (symbol i as chr(33+i)): "
        f"{' | '.join(t[:60] for t in text)} [{smi}]")

    # ------------------ a masked batch through fit() under TBPTT, lr 0
    d = json.loads(net.conf.to_json())
    d["backprop_type"], d["tbptt_length"] = "tbptt", W
    conf = MultiLayerConfiguration.from_json(json.dumps(d))
    conf.base.updater = Adam(0.0)
    masked = MultiLayerNetwork(conf).init()
    masked.setParams(net.params())
    lengths = np.random.default_rng(TEXT_SEED).integers(500, T + 1, B)
    m = torch.from_numpy((np.arange(T)[None, :] < lengths[:, None]).astype(
        np.float32)).cuda()
    ds = DataSet(batches[0].features, batches[0].labels, m, m)
    plain = masked.score(ds)
    before = masked.params().clone()
    seen = []
    fit_window = masked._fit_window
    masked._fit_window = lambda *a: seen.append(fit_window(*a)) or seen[-1]
    masked.fit(ds)
    del masked._fit_window
    total = float(sum(float(w[0]) for w in seen))
    if len(seen) != n_win or not abs(total - plain) <= 1e-5 * abs(plain) \
            or not torch.equal(masked.params(), before):
        fail(f"textgen: the masked batch's {len(seen)} windows sum to "
             f"{total!r}, the plain forward's masked loss is {plain!r} "
             f"(want {n_win} windows within 1e-5 relative; params "
             f"unchanged at lr 0: {torch.equal(masked.params(), before)})")
    log(f"TextGenerationLSTM masked batch (lengths {int(lengths.min())}-"
        f"{int(lengths.max())}) through fit() under backpropType('tbptt', "
        f"{W}), lr 0: {n_win} window losses sum to {total:.6f}, the plain "
        f"forward's masked loss {plain:.6f} ({abs(total - plain) / plain:.2g} "
        f"relative)")

    # ------------------------------------------------------- the archive
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "textgen.zip")
        net.save(path)
        back = MultiLayerNetwork.load(path)
        x0 = batches[0].features
        if not torch.equal(back.output(x0), net.output(x0)):
            fail("textgen: save/load changed output()")
    if any(ck.LAUNCHES.values()) or any(ck.PLAIN_CALLS.values()):
        fail(f"textgen: a kernel ran on this path: {dict(ck.LAUNCHES)} "
             f"(plain {dict(ck.PLAIN_CALLS)})")
    log(f"textgen: save/load output() bit-equal; no kernel launched; phase "
        f"{time.perf_counter() - t_phase:.1f} s [{smi}]")


def from_disk(smi: str, inmem_ms: float) -> dict:
    """Phase 22: ResNet-50 trained from JPEG files on disk through the
    staged pipeline, ``dispatch_stream`` and ``fit(K=4, prefetch=2)``,
    held to the bit against ``prefetch=0``. Returns the
    ``scale_shift_act`` launches at capture and the replays of the two
    runs."""
    import torch

    from deeplearning4j_tpu_torch import profile_fit
    from deeplearning4j_tpu_torch import profiler as prof
    from deeplearning4j_tpu_torch.data import dataset as dsmod
    from deeplearning4j_tpu_torch.data.decode import codec, decode_one
    from deeplearning4j_tpu_torch.data.pipeline import (
        MultiWorkerImageIterator)
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn import compilecache as cc
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.profiler.modes import (ProfilingMode,
                                                         set_profiling_mode)
    t_phase = time.perf_counter()
    k, b, hw = MEGA_K, DISK_BATCH, DISK_HW
    tmp = tempfile.TemporaryDirectory()
    it = None
    deterministic = torch.backends.cudnn.deterministic
    try:
        # bench.py's DataPipelineBench dataset: uniform noise, 256^2,
        # JPEG quality 85, RandomState(42), 8 class directories
        t0 = time.perf_counter()
        files = profile_fit.noise_jpegs(tmp.name, DISK_IMAGES, DISK_SIDE,
                                        DISK_CLASSES)
        mb_on_disk = sum(os.path.getsize(f) for f in files) / 1e6
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for f in files[:64]:
            decode_one(f, hw, hw, 3)
        decode_ms = (time.perf_counter() - t0) / 64 * 1e3
        cores = os.cpu_count() or 1
        log(f"from disk: {len(files)} JPEGs ({DISK_SIDE}^2, quality 85, "
            f"{DISK_CLASSES} classes, {mb_on_disk:.1f} MB) written in "
            f"{write_s:.2f} s; decode with {codec()}: {decode_ms:.3f} ms an "
            f"image to {hw}^2 on one core; {cores} host cores")

        # pinned host-to-device rate for one uint8 megabatch, fresh
        # device buffers each copy
        mega = (k, b, 3, hw, hw)
        pinned = torch.empty(mega, dtype=torch.uint8, pin_memory=True)
        pinned.fill_(7)
        bufs = [torch.empty(mega, dtype=torch.uint8, device="cuda")
                for _ in range(3)]
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        torch.cuda.synchronize()
        start.record()
        for buf in bufs:
            buf.copy_(pinned, non_blocking=True)
        end.record()
        torch.cuda.synchronize()
        copy_ms = start.elapsed_time(end) / len(bufs)
        h2d_mbps = pinned.numel() / (copy_ms / 1e3) / 1e6
        del pinned, bufs

        it = MultiWorkerImageIterator(tmp.name, hw, hw, batch_size=b,
                                      workers=cores, drop_last=True,
                                      steps_per_dispatch=k)
        tree = np.bincount([it.labels.index(os.path.basename(
            os.path.dirname(f))) for f in files], minlength=DISK_CLASSES)
        # the two runs are held to the bit: cuDNN's deterministic
        # algorithms, chosen before the capture
        torch.backends.cudnn.deterministic = True
        net = zoo.ResNet50(num_classes=DISK_CLASSES,
                           input_shape=(3, hw, hw)).init()
        net.setPrecisionPolicy("bf16")
        net.setComputeLayout("NHWC")
        net.setEpilogueFusion(True)
        net._ensure_opt_state()
        net._ensure_clock()
        s0 = snapshot(net._dispatch_state())
        torch.cuda.reset_peak_memory_stats()
        ck.reset_counts()
        cc.reset_stats()
        t0 = time.perf_counter()
        cc.warmup(net, [((b, 3, hw, hw), (b, DISK_CLASSES))],
                  steps_per_dispatch=k, dtype=np.uint8)
        capture_s = time.perf_counter() - t0
        at_capture = net._step_for(False, k).launches_at_capture()
        if at_capture != [{"scale_shift_act": k * 33}] or \
                cc.cache_stats()["capture_failures"]:
            fail(f"from disk: the uint8 megastep recorded {at_capture}, "
                 f"cache_stats {cc.cache_stats()}: want {k} x 33 "
                 "scale_shift_act launches and no failure")
        if not all(torch.equal(x, y)
                   for x, y in zip(net._dispatch_state(), s0)):
            fail("from disk: compilecache.warmup changed the state")

        def run(prefetch: int):
            restore(net._dispatch_state(), s0)
            net._iteration = 0
            net._epoch = 0
            seen = {"hist": [torch.zeros(DISK_CLASSES, device="cuda")
                             for _ in range(DISK_EPOCHS)],
                    "losses": [], "dispatches": 0, "singles": 0}
            mega_fit, one_fit = net._fit_mega, net._fit_one

            def fit_mega(mb):
                seen["dispatches"] += 1
                seen["hist"][net._epoch] += mb.labels.sum(dim=(0, 1))
                losses = mega_fit(mb)
                seen["losses"].append(losses)
                return losses

            def fit_one(ds):
                seen["singles"] += 1
                return one_fit(ds)
            net._fit_mega, net._fit_one = fit_mega, fit_one
            dsmod.reset_h2d_counts()
            ck.reset_counts()
            before = profile_fit.host_seconds()
            set_profiling_mode(ProfilingMode.BASIC)
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                net.fit(it, epochs=DISK_EPOCHS, steps_per_dispatch=k,
                        prefetch=prefetch)
                last = net.score()                  # waits for the card
                wall = time.perf_counter() - t0
            finally:
                set_profiling_mode(ProfilingMode.OFF)
                del net._fit_mega, net._fit_one
            after = profile_fit.host_seconds()
            seen.update(wall=wall, last=last,
                        h2d=dict(dsmod.H2D_COPIES),
                        launches=dict(ck.LAUNCHES), replays=dict(ck.REPLAYS),
                        delta={key: after[key] - before[key]
                               for key in after},
                        state=snapshot(net._dispatch_state()))
            return seen

        runs = {p: run(p) for p in (2, 0)}
        ratio = prof.data_overlap_ratio()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        n_disp = DISK_EPOCHS * DISK_IMAGES // (k * b)
        want_h2d = {(mega, "uint8"): n_disp,
                    ((k, b, DISK_CLASSES), "float32"): n_disp}
        for p, r in runs.items():
            hist = [h.cpu().numpy() for h in r["hist"]]
            if any(not np.array_equal(h, tree) for h in hist) \
                    or r["singles"] or r["dispatches"] != n_disp:
                fail(f"from disk prefetch={p}: label histograms {hist} "
                     f"against the tree's {tree.tolist()}, {r['dispatches']} "
                     f"megasteps and {r['singles']} single steps: want every "
                     f"image once an epoch in {n_disp} megasteps")
            if r["h2d"] != want_h2d:
                fail(f"from disk prefetch={p}: host-to-device copies "
                     f"{r['h2d']}: want one uint8 {list(mega)} megabatch and "
                     "its labels a dispatch, nothing else")
            if any(r["launches"].values()) or any(ck.PLAIN_CALLS.values()) \
                    or r["replays"]["scale_shift_act"] != n_disp * k * 33:
                fail(f"from disk prefetch={p}: launched {r['launches']} "
                     f"eagerly, replayed {r['replays']}: want {n_disp} "
                     f"replays of {k} x 33 scale_shift_act")
            losses = torch.cat(r["losses"]).float().cpu().numpy()
            if losses.shape != (DISK_EPOCHS * DISK_IMAGES // b,) or \
                    not np.isfinite(losses).all():
                fail(f"from disk prefetch={p}: losses {losses}")
            r["losses"] = losses
        same = [torch.equal(x, y) for x, y in zip(runs[2]["state"],
                                                  runs[0]["state"])]
        if not all(same) or not np.array_equal(runs[2]["losses"],
                                               runs[0]["losses"]):
            fail(f"from disk: prefetch=2 and prefetch=0 differ in "
                 f"{same.count(False)} of {len(same)} state tensors (losses "
                 f"{runs[2]['losses'].tolist()} / "
                 f"{runs[0]['losses'].tolist()})")
        acc = {}
        for p in (True, False):
            t0 = time.perf_counter()
            acc[p] = (net.evaluate(it, prefetch=p).accuracy(),
                      time.perf_counter() - t0)
        if acc[True][0] != acc[False][0]:
            fail(f"from disk: evaluate accuracy {acc[True][0]} with "
                 f"prefetch, {acc[False][0]} without")
        cap = cc.cache_stats()
        if cap["capture_failures"] or \
                cap["compile_seconds"]["cold_compiles"] != 1:
            fail(f"from disk: cache stats {cap}: want the one capture")
        n_img = DISK_EPOCHS * DISK_IMAGES
        for p, r in runs.items():
            d = r["delta"]
            log(f"from disk fit(K={k}, prefetch={p}), {DISK_EPOCHS} epochs of "
                f"{DISK_IMAGES}: {r['wall']:.3f} s, {n_img / r['wall']:.1f} "
                f"images/s, {r['wall'] * 1e3 / (n_img / b):.2f} ms a step "
                f"(in memory, phase 14: {inmem_ms:.2f} ms a step, "
                f"{b / (inmem_ms / 1e3):.1f} images/s); data wait "
                f"{d['data_wait']:.3f} s against dispatch "
                f"{d['dispatch']:.3f} s; pipeline: decode "
                f"{d['decode']:.3f} worker-s, ring copy {d['ring_copy']:.3f} "
                f"s, consumer stall {d['consumer_stall']:.3f} s; last loss "
                f"{r['last']:.5f} [{smi}]")
        log(f"from disk: data_overlap_ratio {ratio:.4f} (prefetch=2 and 0); "
            f"pinned H2D {h2d_mbps:.1f} MB/s ({copy_ms:.3f} ms a "
            f"{int(np.prod(mega)) / 1e6:.1f} MB megabatch); capture "
            f"{capture_s:.2f} s; peak {peak_gb:.2f} GB; decode bound "
            f"{cores * 1e3 / decode_ms:.0f} images/s on {cores} cores with "
            f"{codec()}; {n_disp} dispatches a run, copies "
            f"{runs[2]['h2d']}; state bit-equal across prefetch=2/0 "
            f"({len(same)} tensors, {len(runs[2]['losses'])} losses); "
            f"evaluate accuracy {acc[True][0]:.4f} both ways "
            f"({acc[True][1]:.2f} s / {acc[False][1]:.2f} s); phase "
            f"{time.perf_counter() - t_phase:.1f} s [{smi}]")
        return {"at_capture": k * 33,
                "replays": sum(r["replays"]["scale_shift_act"]
                               for r in runs.values()),
                "workers": cores, "decode_ms": decode_ms,
                "h2d_mbps": h2d_mbps,
                "img_s": {p: n_img / r["wall"] for p, r in runs.items()}}
    finally:
        torch.backends.cudnn.deterministic = deterministic
        if it is not None:
            it.close()
        tmp.cleanup()


def long_run(smi: str) -> dict:
    """Phase 25: ResNet-50 for 2 epochs from JPEGs on disk with the
    augmentation in the captured step, Nesterovs under a step schedule,
    async checkpoints and listeners; then a preempted run resumed into a
    fresh net, held to the bit against the uninterrupted one; then a NaN
    batch under SKIP_STEP, BACKOFF_LR and ROLLBACK. Returns the
    ``scale_shift_act`` launches recorded at the capture."""
    import torch

    from deeplearning4j_tpu_torch import profile_fit
    from deeplearning4j_tpu_torch.data import dataset as dsmod
    from deeplearning4j_tpu_torch.data.pipeline import (
        MultiWorkerImageIterator)
    from deeplearning4j_tpu_torch.faults import FaultPlan
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn import compilecache as cc
    from deeplearning4j_tpu_torch.nn.augment import DeviceAugmentation
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.profiler.modes import (ProfilingMode,
                                                         set_profiling_mode)
    from deeplearning4j_tpu_torch.train import resilience as res
    from deeplearning4j_tpu_torch.train.listeners import (
        PerformanceListener, ScoreIterationListener, TrainingListener)
    from deeplearning4j_tpu_torch.train.schedules import StepSchedule
    from deeplearning4j_tpu_torch.train.updaters import Nesterovs
    t_phase = time.perf_counter()
    k, b, side = MEGA_K, DISK_BATCH, LONG_SIDE
    hw = side - LONG_CROP
    steps = LONG_EPOCHS * DISK_IMAGES // b
    n_disp = steps // k
    tmp = tempfile.TemporaryDirectory()
    it = None
    deterministic = torch.backends.cudnn.deterministic

    def make_net():
        net = zoo.ResNet50(
            num_classes=DISK_CLASSES, input_shape=(3, hw, hw),
            updater=Nesterovs(StepSchedule("iteration", 0.1, 0.1, 16),
                              momentum=0.9)).init()
        net.setPrecisionPolicy("bf16")
        net.setComputeLayout("NHWC")
        net.setEpilogueFusion(True)
        net.setDeviceAugmentation(
            DeviceAugmentation(seed=7).crop(LONG_CROP).random_flip()
            .normalize(IMAGENET_MEAN, IMAGENET_STD))
        net._ensure_step_state()
        return net

    def state_of(net):
        return snapshot(net._snapshot_tensors() + [net._t_dev])

    def equal(a, b):
        return len(a) == len(b) and all(torch.equal(x, y)
                                        for x, y in zip(a, b))

    def differ(a, b):
        """Where two states differ: the count, and the first few names
        with their max |diff|."""
        names = tree_names([net._params, net._states, net._opt_state])
        bad = [(n, float((x.float() - y.float()).abs().max()))
               for n, x, y in zip(names, a, b) if not torch.equal(x, y)]
        return f"{len(bad)} of {len(a)} tensors differ, e.g. {bad[:6]}"

    class AtStep(TrainingListener):
        """Keeps the state at one iteration (a dispatch boundary)."""

        def __init__(self, step):
            self.step, self.state = step, None

        def iterationDone(self, model, iteration, epoch):
            if iteration == self.step:
                self.state = state_of(model)

    host = {}

    def fit(net, timed=None, **kw):
        """One run from the start of the data; a ``timed`` run records the
        host's data wait, dispatch and pipeline seconds under it."""
        it.seek({"batch": 0, "epoch": 0})
        if timed:
            set_profiling_mode(ProfilingMode.BASIC)
            before = profile_fit.host_seconds()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            net.fit(it, epochs=LONG_EPOCHS, steps_per_dispatch=k, **kw)
            torch.cuda.synchronize()
        finally:
            set_profiling_mode(ProfilingMode.OFF)
        if timed:
            after = profile_fit.host_seconds()
            host[timed] = {key: after[key] - before[key] for key in after}
        return time.perf_counter() - t0

    def ckpt(d, **kw):
        return res.CheckpointConfig(os.path.join(tmp.name, d), **kw)

    try:
        files = profile_fit.noise_jpegs(os.path.join(tmp.name, "jpegs"),
                                        DISK_IMAGES, DISK_SIDE, DISK_CLASSES)
        it = MultiWorkerImageIterator(
            os.path.join(tmp.name, "jpegs"), side, side, batch_size=b,
            workers=os.cpu_count(), drop_last=True, shuffle=True,
            steps_per_dispatch=k)
        torch.backends.cudnn.deterministic = True
        cc.reset_stats()
        ck.reset_counts()
        net = make_net()
        s0 = snapshot(net._dispatch_state())
        cc.warmup(net, [((b, 3, side, side), (b, DISK_CLASSES))],
                  steps_per_dispatch=k, dtype=np.uint8)
        at_capture = net._step_for(False, k).launches_at_capture()
        if at_capture != [{"scale_shift_act": k * 33}] or \
                not equal(snapshot(net._dispatch_state()), s0):
            fail(f"long run: the augmented uint8 megastep recorded "
                 f"{at_capture} (want {k} x 33 scale_shift_act), or warmup "
                 "changed the state")
        upd = net.conf.base.updater
        for t, want in ((0, 0.1), (16, 0.01), (31, 0.01)):
            got = float(upd.lr_at(torch.tensor(t, dtype=torch.int32,
                                               device="cuda")))
            if abs(got - float(np.float32(want))) > 1e-6 * want:
                fail(f"long run: the lr read on the card at step {t + 1} "
                     f"is {got!r}, the schedule's {want}")

        # run A: uninterrupted, async checkpoints every 8 steps, listeners
        score = ScoreIterationListener(LONG_EVERY, out=log)
        perf = PerformanceListener(LONG_EVERY, out=log)
        at16 = AtStep(16)
        net.setListeners(score, perf, at16)
        dsmod.reset_h2d_counts()
        c_n, c_s = res.CKPT_SECONDS.count, res.CKPT_SECONDS.sum
        wall_a = fit(net, timed="all", checkpoint=ckpt(
            "a", every_steps=LONG_EVERY, keep_last=2, async_write=True))
        h2d_a = dict(dsmod.H2D_COPIES)
        n_ck = res.CKPT_SECONDS.count - c_n
        ck_s = (res.CKPT_SECONDS.sum - c_s) / max(n_ck, 1)
        state_a = state_of(net)
        kept = sorted(os.listdir(os.path.join(tmp.name, "a")))
        ck_mb = sum(os.path.getsize(os.path.join(r, f))
                    for r, _, fs in os.walk(os.path.join(tmp.name, "a",
                                                         kept[-1]))
                    for f in fs) / 1e6
        losses = np.asarray(score.history)
        if net.getIterationCount() != steps or len(losses) != steps or \
                not np.isfinite(losses).all() or n_ck != steps // LONG_EVERY \
                or kept != [f"ckpt_{s:010d}" for s in (steps - LONG_EVERY,
                                                       steps)]:
            fail(f"long run A: {net.getIterationCount()} steps, losses "
                 f"{losses.tolist()}, {n_ck} checkpoints, kept {kept}")

        # the same run with checkpoints and no listeners, then with
        # neither (no session: the dispatch stream)
        walls = {}
        net.setListeners()
        for name, kw in (("checkpoints", {"checkpoint": ckpt(
                "a2", every_steps=LONG_EVERY, keep_last=2,
                async_write=True)}), ("plain", {})):
            restore(net._dispatch_state(), s0)
            net._iteration = net._epoch = 0
            walls[name] = fit(net, timed=name, **kw)
            if not equal(state_of(net), state_a):
                fail(f"long run: the run with {name} differs from run A")

        # run B: preempted at step 12, resumed into a fresh net
        net_b = make_net()
        fit(net_b, checkpoint=ckpt("b", every_steps=LONG_EVERY, keep_last=2,
                                   async_write=True),
            faults=FaultPlan(preempt_at_step=LONG_PREEMPT))
        man_path = os.path.join(tmp.name, "b", f"ckpt_{LONG_PREEMPT:010d}",
                                "manifest.json")
        with open(man_path) as f:
            status = json.load(f)["status"]
        if net_b.getIterationCount() != LONG_PREEMPT or \
                status != "preempted":
            fail(f"long run B: stopped at {net_b.getIterationCount()}, "
                 f"checkpoint status {status!r}")
        del net_b
        net_r = make_net()
        fit(net_r, checkpoint=ckpt("b", resume=True))
        same = [torch.equal(x, y) for x, y in zip(state_of(net_r), state_a)]
        if net_r.getIterationCount() != steps or not all(same):
            fail(f"long run B: resumed to {net_r.getIterationCount()} steps;"
                 f" {same.count(False)} of {len(same)} state tensors differ "
                 "from the uninterrupted run")
        del net_r

        # run C: a NaN batch at step 20 under each policy
        seen = []
        orig = res.TrainingSession._handle_nonfinite

        def lr_ptr(m):
            s = m.conf.base.updater.__dict__.get("_lr_scale")
            return s.data_ptr() if isinstance(s, torch.Tensor) else None

        def spy(session, n_steps, bad):
            before = snapshot(session._snap_bufs or [])
            ptr = lr_ptr(session.model)
            orig(session, n_steps, bad)
            m = session.model
            seen.append({"before": before, "after": state_of(m)[:-1],
                         "same_scale": lr_ptr(m) == ptr,
                         "clock": int(m._t_dev), "iteration": m._iteration,
                         "scale": m.lr_scale(),
                         "scale_dev": float(m.conf.base.updater.__dict__.get(
                             "_lr_scale", 1.0))})
        policy_runs = {}
        res.TrainingSession._handle_nonfinite = spy
        try:
            for policy in (res.NanPolicy.SKIP_STEP, res.NanPolicy.BACKOFF_LR,
                           res.NanPolicy.ROLLBACK):
                restore(net._snapshot_tensors() + [net._t_dev],
                        s0[:len(net._snapshot_tensors()) + 1])
                net._iteration = net._epoch = 0
                if policy is res.NanPolicy.ROLLBACK:
                    net._set_lr_scale(1.0)
                counts = (res.NONFINITE_STEPS.value, res.LR_BACKOFFS.value,
                          res.ROLLBACKS.value,
                          cc.cache_stats()["compile_seconds"]["cold_compiles"])
                del seen[:]
                kw = {"checkpoint": ckpt("c", every_steps=LONG_EVERY,
                                         keep_last=2)} \
                    if policy is res.NanPolicy.ROLLBACK else {}
                c16 = AtStep(16)
                net.setListeners(c16)
                wall = fit(net, nan_policy=policy, faults=FaultPlan(
                    nan_grads_at={LONG_NAN}, preempt_at_step=LONG_STOP), **kw)
                after = (res.NONFINITE_STEPS.value, res.LR_BACKOFFS.value,
                         res.ROLLBACKS.value,
                         cc.cache_stats()["compile_seconds"]["cold_compiles"])
                policy_runs[policy.name] = (
                    [a - c for a, c in zip(after, counts)], list(seen), wall)
                if not equal(c16.state, at16.state):
                    fail(f"long run {policy.name}: the state at step 16, "
                         "before the NaN batch, is not run A's: "
                         + differ(c16.state[:-1], at16.state[:-1]))
        finally:
            res.TrainingSession._handle_nonfinite = orig
        deltas, ev, _ = policy_runs["SKIP_STEP"]
        if deltas[0] != 1 or len(ev) != 1 or \
                not equal(ev[0]["before"], ev[0]["after"]):
            fail(f"long run SKIP_STEP: nonfinite {deltas[0]}, {len(ev)} "
                 "events; want one, the state after it bit-equal to the "
                 "state before the dropped dispatch")
        deltas, ev, _ = policy_runs["BACKOFF_LR"]
        if deltas[:2] != [1, 1] or len(ev) != 1 or ev[0]["scale"] != 0.5 \
                or ev[0]["scale_dev"] != 0.5 or deltas[3] != 1 or \
                not ev[0]["same_scale"] or \
                not equal(ev[0]["before"], ev[0]["after"]):
            fail(f"long run BACKOFF_LR: counts {deltas}, events "
                 f"{[(e['scale'], e['scale_dev']) for e in ev]}; want one "
                 "backoff to 0.5 on the host and the card, one capture (the "
                 "lr-scaled megastep, before the backoff) and the update "
                 "dropped")
        deltas, ev, _ = policy_runs["ROLLBACK"]
        if deltas[0] != 1 or deltas[2] != 1 or len(ev) != 1 or \
                ev[0]["iteration"] != 16 or ev[0]["clock"] != 16 or \
                not equal(ev[0]["after"], at16.state[:-1]):
            fail(f"long run ROLLBACK: counts {deltas}, events "
                 f"{[(e['iteration'], e['clock']) for e in ev]}; want the "
                 "state of run A's step-16 checkpoint back: "
                 + (differ(ev[0]["after"], at16.state[:-1]) if ev else ""))
        stats = cc.cache_stats()
        if stats["capture_failures"]:
            fail(f"long run: cache stats {stats}: a capture failed")
        ms = {name: wall * 1e3 / steps for name, wall in
              dict(walls, all=wall_a).items()}
        log(f"long run: ResNet-50 B={b}, {side}^2 JPEGs cropped to {hw}^2 "
            f"and flipped and normalized in the captured step, K={k}, "
            f"Nesterovs 0.9 under StepSchedule(0.1, x0.1 / 16): {steps} "
            f"steps, losses {losses[0]:.5f} .. {losses[-1]:.5f}; ms a step: "
            f"{ms['all']:.2f} with async checkpoints every {LONG_EVERY} "
            f"steps and the score and performance listeners, "
            f"{ms['checkpoints']:.2f} with the checkpoints alone, "
            f"{ms['plain']:.2f} with neither (no session: the dispatch "
            f"stream); {n_ck} checkpoints of {ck_mb:.1f} MB, {ck_s:.3f} s "
            f"each on the writer thread; "
            f"{sum(h2d_a.values()) / n_disp:.1f} copies to the card a "
            f"dispatch under the session ({h2d_a}); capture {at_capture} "
            f"[{smi}]")
        log("long run, host seconds of each run (data wait, dispatch; "
            "pipeline decode, ring copy, consumer stall): " + "; ".join(
                f"{name} " + ", ".join(f"{v:.3f}" for v in (
                    h["data_wait"], h["dispatch"], h["decode"],
                    h["ring_copy"], h["consumer_stall"]))
                for name, h in host.items()))
        log(f"long run: preempted at step {LONG_PREEMPT} and resumed in a "
            f"fresh net: {len(same)} state tensors bit-equal at step "
            f"{steps}; run A again with checkpoints alone and with neither: "
            f"bit-equal; NaN batch "
            f"at step {LONG_NAN}: " + "; ".join(
                f"{name} counts (nonfinite, backoffs, rollbacks, captures) "
                f"{d} in {w:.2f} s" for name, (d, _, w) in
                policy_runs.items()) +
            f"; phase {time.perf_counter() - t_phase:.1f} s [{smi}]")
        return {"at_capture": k * 33}
    finally:
        torch.backends.cudnn.deterministic = deterministic
        if it is not None:
            it.close()
        tmp.cleanup()


def dynamic_scaling(smi: str) -> None:
    """Phase 26: TinyYOLO under fp16 dynamic loss scaling, captured K=4:
    each step's finite flag recorded on the card, the scale after each
    dispatch held to the automaton's rule run on the CPU from those
    flags."""
    import torch

    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn import compilecache as cc
    from deeplearning4j_tpu_torch.nn import precision
    from deeplearning4j_tpu_torch.nn.objdetect import yolo_labels
    t_phase = time.perf_counter()
    k, b = MEGA_K, YOLO_BATCH
    pol = precision.PrecisionPolicy("fp16", loss_scale="dynamic",
                                    loss_scale_init=2.0 ** 24,
                                    growth_interval=4)
    rng = np.random.default_rng(1)
    ds = DataSet(torch.from_numpy(rng.standard_normal(
        (b, 3, 416, 416), dtype=np.float32)).cuda(),
        torch.from_numpy(yolo_labels(rng, b, YOLO_CLASSES)).cuda())
    net = zoo.TinyYOLO(num_classes=YOLO_CLASSES).init()
    net.setPrecisionPolicy(pol)
    net.setComputeLayout("NHWC")
    net.setEpilogueFusion(True)
    net._ensure_step_state()
    flags = torch.zeros(DYN_STEPS, dtype=torch.float32, device="cuda")
    orig = precision.grads_all_finite

    def spy(grads):
        ok = orig(grads)
        flags.index_copy_(0, net._t_dev.long().reshape(1),
                          ok.float().reshape(1))
        return ok
    cc.reset_stats()
    scales, states, losses = [], [snapshot(net._dispatch_state())], []
    precision.grads_all_finite = spy
    try:
        for _ in range(DYN_STEPS // k):
            net.fit([ds] * k, steps_per_dispatch=k)
            scales.append(net._scale_state.detach().cpu())
            states.append(snapshot(net._dispatch_state()))
            losses.append(float(net.score()))
    finally:
        precision.grads_all_finite = orig
    ok = flags.cpu().numpy() > 0.5
    s = torch.tensor([pol.loss_scale_init, 0.0])
    want = []
    for j in range(DYN_STEPS):
        s = precision.dynamic_scale_next(pol, s, torch.tensor(bool(ok[j])))
        if (j + 1) % k == 0:
            want.append(s.clone())
    stats = cc.cache_stats()
    if ok[0] or not all(torch.equal(g, w) for g, w in zip(scales, want)):
        fail(f"dynamic scaling: finite flags {ok.tolist()}, scale after "
             f"each dispatch {[v.tolist() for v in scales]}, the rule's "
             f"{[v.tolist() for v in want]}: want the first step to "
             "overflow and the card to follow the rule")
    if not ok[:k].any():
        n_p = len(net._snapshot_tensors())
        if not all(torch.equal(x, y) for x, y in zip(states[0][:n_p],
                                                     states[1][:n_p])):
            fail("dynamic scaling: the first dispatch overflowed at every "
                 "step but its updates were not all dropped")
    if stats["capture_failures"] or \
            stats["compile_seconds"]["cold_compiles"] != 1 or \
            not np.isfinite(losses[-1]):
        fail(f"dynamic scaling: cache stats {stats}, losses {losses}")
    log(f"dynamic loss scaling: TinyYOLO B={b} fp16 NHWC, K={k}, "
        f"{DYN_STEPS} steps from 2^24: finite flags "
        f"{''.join('1' if v else '0' for v in ok)}, scale after each "
        f"dispatch {[float(v[0]) for v in scales]} (the rule's), losses "
        f"{[round(v, 5) for v in losses]}; one capture, no failure; phase "
        f"{time.perf_counter() - t_phase:.1f} s [{smi}]")


def early_stopping(smi: str) -> None:
    """Phase 27: LeNet-5 under ``EarlyStoppingTrainer``; the best model
    reloaded from its file scores what was recorded."""
    import torch

    from deeplearning4j_tpu_torch.data.iterators import MnistDataSetIterator
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.train import earlystopping as es
    t_phase = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        train = MnistDataSetIterator(64, True, num_examples=2048)
        held = MnistDataSetIterator(256, False, num_examples=512)
        net = zoo.LeNet(num_classes=10).init()
        with tempfile.TemporaryDirectory() as d:
            cfg = (es.EarlyStoppingConfiguration.Builder()
                   .scoreCalculator(es.DataSetLossCalculator(held))
                   .epochTerminationConditions(
                       es.MaxEpochsTerminationCondition(ES_MAX_EPOCHS),
                       es.ScoreImprovementEpochTerminationCondition(
                           ES_PATIENCE))
                   .modelSaver(es.LocalFileModelSaver(d)).build())
            result = es.EarlyStoppingTrainer(cfg, net, train,
                                             steps_per_dispatch=MEGA_K).fit()
            best = result.getBestModel()
            again = es.DataSetLossCalculator(held).calculateScore(best)
        acc = best.evaluate(held).accuracy()
        if best is net or again != result.best_score or acc < 0.99:
            fail(f"early stopping: best model {type(best).__name__} scores "
                 f"{again!r} against the recorded {result.best_score!r}, "
                 f"accuracy {acc:.4f}")
        log(f"early stopping: LeNet-5 K={MEGA_K}, {result.total_epochs} "
            f"epochs ({result.termination_reason}: "
            f"{result.termination_details}), best epoch "
            f"{result.best_epoch} at held-out loss {result.best_score:.6f}, "
            f"reloaded from its file: the same score, accuracy {acc:.4f}; "
            f"scores {[f'{v:.3g}' for v in result.score_vs_epoch.values()]};"
            f" phase {time.perf_counter() - t_phase:.1f} s [{smi}]")
    finally:
        torch.backends.cudnn.deterministic = deterministic


def analyzer_vs_card(smi: str, measured: dict, zoo_eager: dict, disk: dict,
                     inmem_ms: float) -> None:
    """Phase 33: the static analyzer's verdicts and predictions against
    what the earlier phases measured on the card; see the module
    docstring."""
    import contextlib
    import io

    import torch

    from deeplearning4j_tpu_torch.analysis import (CHIP_REGISTRY, CostSpec,
                                                   InputPipelineSpec,
                                                   ModelValidationError,
                                                   analyze)
    from deeplearning4j_tpu_torch.analysis import cost as C
    from deeplearning4j_tpu_torch.analysis import layout
    from deeplearning4j_tpu_torch.analysis.__main__ import main as lint
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                    NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.serving import ModelServer
    t_phase = time.perf_counter()
    h100 = CHIP_REGISTRY["h100-sxm"]

    # (a) the CLI, in-process
    for argv, want in ((["--zoo"], "16 model(s) linted: 16 clean"),
                       (["--cost", "--chip", "h100-sxm", "ResNet50"],
                        "1 model(s) linted: 1 clean")):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = lint(argv)
        if rc != 0 or want not in out.getvalue():
            fail(f"analysis CLI {argv}: exit {rc}\n{out.getvalue()}")
        log(f"analysis CLI {' '.join(argv)}: exit 0, {want!r}")

    # (b) the cost model against the captured steps and their peaks
    def predict(cls, kwargs, batch, precision):
        conf = getattr(zoo, cls)(**kwargs).conf_builder()
        spec = CostSpec(chip="h100-sxm", precision=precision,
                        steps_per_dispatch=MEGA_K)
        report = analyze(conf, batch_size=batch, cost=spec)
        est = C.step_time(conf, cost=spec, batch_size=batch)
        mem = C.memory_plan(conf, cost=spec, batch_size=batch)
        return report, est, mem

    rows = []
    for name, cls, kwargs, batch, precision in ANALYZER_NETS:
        report, est, mem = predict(cls, kwargs, batch, precision)
        if report.errors():
            fail(f"{name}: the analyzer reports errors for a net that ran "
                 f"on the card:\n{report.format()}")
        m = measured[name]
        pred_ms = est.step_s * 1e3
        ratio = m["captured_ms"] / pred_ms
        own = m["peak_bytes"] - m["live_before"]
        mem_ratio = own / mem.peak_bytes
        dom = mem.dominating()[0]
        rows.append({"net": name, "batch": batch,
                     "precision": precision or "float32",
                     "predicted_step_ms": pred_ms, "bound": est.bound,
                     "predicted_mfu": est.mfu,
                     "measured_step_ms": m["captured_ms"],
                     "cost_model_ratio": ratio,
                     "planned_peak_bytes": mem.peak_bytes,
                     "plan_dominated_by": dom,
                     "measured_peak_bytes": m["peak_bytes"],
                     "live_before_bytes": m["live_before"],
                     "peak_ratio": mem_ratio,
                     "codes": report.codes()})
        log(f"cost model {name} B={batch} {precision or 'float32'} K="
            f"{MEGA_K}: predicted step {pred_ms:.3f} ms ({est.bound}-bound, "
            f"MFU {est.mfu:.3f}), measured captured {m['captured_ms']:.2f} "
            f"ms, cost_model_ratio {ratio:.3f}; planned peak "
            f"{mem.peak_bytes / 1e9:.3f} GB ({dom} dominates), measured "
            f"{own / 1e9:.3f} GB above the {m['live_before'] / 1e9:.3f} GB "
            f"live before the net was built ({m['peak_bytes'] / 1e9:.3f} "
            f"GB in all), ratio {mem_ratio:.3f}; codes {report.codes()} "
            f"[{smi}]")
        if not (np.isfinite(ratio) and np.isfinite(mem_ratio)) or ratio < 1:
            fail(f"{name}: cost_model_ratio {ratio}, peak ratio "
                 f"{mem_ratio}: want both finite and the step ratio >= 1 "
                 "(the card beat the roofline)")
    for name, m in zoo_eager.items():
        model = getattr(zoo, name)()
        _, est, mem = predict(name, {}, ZOO_BATCH, "bf16")
        log(f"cost model {name} B={ZOO_BATCH} bf16 (phase 20, eager, not "
            f"gated): predicted step {est.step_s * 1e3:.3f} ms, measured "
            f"eager {m['eager_ms']:.2f} ms, ratio "
            f"{m['eager_ms'] / (est.step_s * 1e3):.3f}; planned peak "
            f"{mem.peak_bytes / 1e9:.3f} GB at K={MEGA_K}, measured "
            f"{(m['peak_bytes'] - m['live_before']) / 1e9:.3f} GB above "
            f"what was live before ({model.input_shape})")
    print(json.dumps({"cost_model": rows}))

    # (c) W108 against phase 22
    conf = zoo.ResNet50(num_classes=DISK_CLASSES).conf_builder()
    device_rate = RESNET_BATCH / (inmem_ms / 1e3)
    spec = InputPipelineSpec(
        workers=disk["workers"], batch_size=DISK_BATCH,
        decode_ms_per_img=disk["decode_ms"], h2d_mbps=disk["h2d_mbps"],
        height=DISK_HW, width=DISK_HW, dtype="uint8",
        steps_per_dispatch=MEGA_K, device_img_per_sec=device_rate)
    w108 = [d for d in analyze(conf, input_pipeline=spec)
            if d.code == "DL4J-W108"]
    decode_bound = disk["workers"] * 1e3 / disk["decode_ms"]
    h2d_bound = disk["h2d_mbps"] * 1e6 / (3 * DISK_HW * DISK_HW)
    log(f"W108 on phase 22's pipeline ({disk['workers']} workers, "
        f"B={DISK_BATCH}, K={MEGA_K}, uint8, decode {disk['decode_ms']:.3f} "
        f"ms an image, H2D {disk['h2d_mbps']:.1f} MB/s; device "
        f"{device_rate:.1f} images/s from phase 14): "
        f"{'fires' if w108 else 'silent'}; its bounds: decode "
        f"{decode_bound:.1f}, H2D {h2d_bound:.1f} images/s; measured from "
        f"disk {', '.join(f'{v:.1f}' for v in disk['img_s'].values())} "
        f"images/s (prefetch {', '.join(str(p) for p in disk['img_s'])}), "
        f"in memory {device_rate:.1f} [{smi}]")
    if w108:
        log(f"W108: {w108[0].message}")

    # (d) init(strict=True) raises before anything is allocated
    bad = (NeuralNetConfiguration.Builder().list()
           .layer(DenseLayer(nIn=300, nOut=16))
           .layer(OutputLayer(nOut=4))
           .setInputType(InputType.feedForward(128)).build())
    net = MultiLayerNetwork(bad)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    try:
        net.init(strict=True)
        fail("init(strict=True) on a seeded E001 configuration did not raise")
    except ModelValidationError as e:
        if "DL4J-E001" not in str(e):
            fail(f"init(strict=True) raised without E001: {e}")
    after = torch.cuda.memory_allocated()
    if after != before or net._initialized or net._params:
        fail(f"init(strict=True) allocated: memory {before} -> {after} "
             f"bytes, initialized {net._initialized}")
    log(f"init(strict=True) on the seeded E001 configuration: "
        f"ModelValidationError, memory_allocated {before} -> {after} bytes")

    # (e) the Hopper W101 rule, measured: a bf16 GEMM's N dim
    gen = torch.Generator(device="cuda").manual_seed(0)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def timed(fn):
        for _ in range(3):
            fn()
        ts = []
        for _ in range(TIMED_RUNS):
            flush.zero_()
            torch.cuda._sleep(SPIN_CYCLES)
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            ts.append(t0.elapsed_time(t1))
        return float(np.median(ts))

    a = torch.randn((LAYOUT_M, LAYOUT_K), generator=gen, device="cuda").to(
        torch.bfloat16)
    sweep = []
    for n in LAYOUT_NS:
        b = torch.randn((LAYOUT_K, n), generator=gen, device="cuda").to(
            torch.bfloat16)
        ms = timed(lambda: torch.matmul(a, b))
        fires = layout.lint_lane_dim(n, "sweep",
                                     compute_dtype="bfloat16") is not None
        sweep.append({"n": n, "ms": ms,
                      "tflops": 2 * LAYOUT_M * LAYOUT_K * n / (ms / 1e3) / 1e12,
                      "padded_n": layout.padded_dim(n),
                      "waste": layout.padding_waste(n), "w101": fires})
        del b
    base = sweep[LAYOUT_NS.index(384)]["ms"]
    for r in sweep:
        log(f"bf16 matmul [{LAYOUT_M}, {LAYOUT_K}] x [{LAYOUT_K}, {r['n']}]: "
            f"{r['ms']:.4f} ms ({r['tflops']:.1f} TFLOP/s, "
            f"{r['ms'] / base:.3f} of N=384's), the rule pads N to "
            f"{r['padded_n']} ({r['waste']:.1%} dead), W101 "
            f"{'fires' if r['w101'] else 'silent'} [{smi}]")
    del a
    # YOLO2's head: its 1x1 conv_out over [B, 1024, 13, 13], bf16 NHWC as
    # phase 19 runs it, at its 425 channels and the aligned 424 and 432
    x = torch.randn((YOLO2_BATCH, HEAD_CONV_CIN, 13, 13), generator=gen,
                    device="cuda").to(torch.bfloat16).contiguous(
                        memory_format=torch.channels_last)
    x.requires_grad_(True)
    conv = []
    for n in HEAD_CONV_NS:
        w = (torch.randn((n, HEAD_CONV_CIN, 1, 1), generator=gen,
                         device="cuda") / HEAD_CONV_CIN ** 0.5).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        bias = torch.zeros(n, dtype=torch.bfloat16, device="cuda")
        w.requires_grad_(True)
        fwd = timed(lambda: torch.nn.functional.conv2d(x, w, bias))

        def step():
            y = torch.nn.functional.conv2d(x, w, bias)
            torch.autograd.grad(y, (x, w), torch.ones_like(y))
        conv.append({"n": n, "fwd_ms": fwd, "fwd_bwd_ms": timed(step),
                     "w101": layout.lint_lane_dim(
                         n, "head", conv=True, compute_layout="NHWC",
                         compute_dtype="bfloat16") is not None})
        del w, bias
    base = conv[HEAD_CONV_NS.index(424)]
    y2_ms = measured["YOLO2"]["captured_ms"]
    for r in conv:
        log(f"YOLO2 head conv 1x1 [{YOLO2_BATCH}, {HEAD_CONV_CIN}, 13, 13] "
            f"-> {r['n']} bf16 NHWC: forward {r['fwd_ms']:.4f} ms "
            f"({r['fwd_ms'] / base['fwd_ms']:.3f} of N=424's), forward + "
            f"backward {r['fwd_bwd_ms']:.4f} ms "
            f"({r['fwd_bwd_ms'] / base['fwd_bwd_ms']:.3f} of N=424's, "
            f"{(r['fwd_bwd_ms'] - base['fwd_bwd_ms']) / y2_ms:.2%} of "
            f"YOLO2's {y2_ms:.2f} ms step above it), W101 "
            f"{'fires' if r['w101'] else 'silent'} [{smi}]")
    # LeNet's 500-wide dense (B=64, 800 in) in bf16, against 496 and 504
    x = torch.randn((LENET_DENSE_M, LENET_DENSE_K), generator=gen,
                    device="cuda").to(torch.bfloat16)
    dense = []
    for n in LENET_DENSE_NS:
        b = torch.randn((LENET_DENSE_K, n), generator=gen, device="cuda").to(
            torch.bfloat16)
        dense.append({"n": n, "ms": timed(lambda: torch.matmul(x, b)),
                      "w101": layout.lint_lane_dim(
                          n, "dense", compute_dtype="bfloat16") is not None})
        del b
    base = dense[LENET_DENSE_NS.index(496)]["ms"]
    for r in dense:
        log(f"LeNet dense bf16 [{LENET_DENSE_M}, {LENET_DENSE_K}] x "
            f"[{LENET_DENSE_K}, {r['n']}]: {r['ms']:.4f} ms "
            f"({r['ms'] / base:.3f} of N=496's), W101 "
            f"{'fires' if r['w101'] else 'silent'} [{smi}]")
    print(json.dumps({"w101_sweep": sweep, "w101_head_conv": conv,
                      "w101_lenet_dense": dense}))
    del x, flush

    # (f) a served ResNet-50's serving lint at the card's 80 GB
    net = zoo.ResNet50(num_classes=1000).init()
    server = ModelServer(net, batch_limit=32)
    try:
        server.warmup([(3, 224, 224)])
        rng = np.random.default_rng(0)
        reqs = [server.submit(rng.standard_normal((n, 3, 224, 224),
                                                  dtype=np.float32))
                for n in (1, 2, 3, 4, 5, 6, 7, 8)]
        outs = [r.get(timeout=60) for r in reqs]
        if [tuple(o.shape) for o in outs] != \
                [(n, 1000) for n in (1, 2, 3, 4, 5, 6, 7, 8)]:
            fail(f"served ResNet-50 answered {[o.shape for o in outs]}")
        report = server.validate(shapes=[(3, 224, 224)], hbm_gb=h100.hbm_gb,
                                 cost="h100-sxm")
    finally:
        server.close()
    log(f"ModelServer.validate(hbm_gb={h100.hbm_gb}, cost='h100-sxm') on "
        f"the served ResNet-50 (buckets {server.buckets()}): "
        f"{report.format()}")
    if {"DL4J-E111", "DL4J-E121", "DL4J-E122"} & set(report.codes()):
        fail(f"served ResNet-50: the serving lint reports "
             f"{report.codes()} at the card's {h100.hbm_gb} GiB")
    # its params live on the card and its convs run NCHW: the conv-stack
    # W101 fires from validate(), and the NHWC layout silences it
    stack = [d for d in net.validate() if d.code == "DL4J-W101"]
    net.setComputeLayout("NHWC")
    nhwc = [d for d in net.validate() if d.code == "DL4J-W101"]
    log(f"validate() on the served ResNet-50 (on the card, NCHW): "
        f"{[d.message for d in stack]}; after setComputeLayout('NHWC'): "
        f"{len(nhwc)} W101")
    if len(stack) != 1 or "NCHW compute layout" not in stack[0].message \
            or nhwc:
        fail(f"the conv-stack W101 on the card: {len(stack)} under NCHW, "
             f"{len(nhwc)} under NHWC; want 1 and 0")
    del net
    log(f"phase 33: {time.perf_counter() - t_phase:.1f} s")


def ssa_plain(x, scale, shift, *, alpha=0.0, axis=1):
    """The ``scale_shift_act`` override on the kernel's plain version: the
    fused epilogues' reference (channels-minor inputs only, as the
    kernel's gate)."""
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    if axis % x.dim() != x.dim() - 1 or not x.is_contiguous():
        fail("a fused epilogue reached the plain version off the gate")
    c = x.shape[-1]
    return ck.scale_shift_act_plain(x.view(-1, c), scale.to(x.dtype),
                                    shift.to(x.dtype), alpha).view(x.shape)


def tree_names(tree, prefix=""):
    """Dotted names of a tree's tensors, in ``state_tensors`` order."""
    import torch
    if isinstance(tree, torch.Tensor):
        return [prefix]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [n for k, v in items
            for n in tree_names(v, f"{prefix}.{k}" if prefix else str(k))]


def snapshot(tensors):
    return [t.detach().clone() for t in tensors]


def restore(tensors, saved) -> None:
    import torch
    with torch.no_grad():
        for t, v in zip(tensors, saved):
            t.copy_(v)


def _ulp(t) -> float:
    """One unit in the last place of ``t``'s dtype at its largest
    magnitude."""
    import torch
    m = float(t.detach().abs().max()) if t.numel() else 0.0
    if m == 0.0 or not np.isfinite(m):
        return 0.0
    bits = {torch.float32: 23, torch.bfloat16: 7, torch.float16: 10}.get(
        t.dtype, 0)
    return float(np.ldexp(1.0, int(np.frexp(m)[1]) - 1 - bits))


def hold_captured(name, held, names, groups=None, exact=False) -> None:
    """The captured-against-eager rule (module docstring) over ``held``:
    ``{"eager 1"|"eager 2"|"captured": (losses, [tensors])}``. ``groups``
    maps a tensor index to its group key (a param and its Adam moments);
    a group where the eager runs differ anywhere is nondeterministic.
    ``exact``: every tensor and loss of the three runs must agree to the
    bit (no group may be nondeterministic)."""
    import torch
    l1, e1 = held["eager 1"]
    l2, e2 = held["eager 2"]
    lc, c = held["captured"]
    groups = groups or list(range(len(e1)))
    noisy = {groups[i] for i, (a, b) in enumerate(zip(e1, e2))
             if not torch.equal(a, b)}
    if exact and (noisy or list(l1) != list(l2) or list(l1) != list(lc)):
        fail(f"{name}: the runs are not bit-equal: eager runs differ in "
             f"{sorted(noisy)[:10]}, losses {list(l1)} / {list(l2)} / "
             f"{list(lc)}")
    bad, differ = [], []
    for i, (a, b, x) in enumerate(zip(e1, e2, c)):
        if groups[i] not in noisy:
            if not torch.equal(a, x):
                bad.append(f"{names[i]} (eager runs agree to the bit, "
                           f"captured max|diff| "
                           f"{float((a.float() - x.float()).abs().max()):.3g})")
            continue
        d_ee = float((a.float() - b.float()).abs().max())
        d_ce = float((a.float() - x.float()).abs().max())
        bound = max(2 * d_ee, _ulp(a))
        differ.append(f"{names[i]} {d_ee:.3g}/{d_ce:.3g}")
        if not d_ce <= bound:
            bad.append(f"{names[i]} (captured {d_ce:.3g} > {bound:.3g})")
    l1, l2, lc = (np.atleast_1d(np.asarray(v, np.float64))
                  for v in (l1, l2, lc))
    d_ee, d_ce = float(np.abs(l1 - l2).max()), float(np.abs(l1 - lc).max())
    if d_ce > 2 * d_ee:
        bad.append(f"losses (captured {d_ce:.3g} > 2 x eager {d_ee:.3g}: "
                   f"{l1.tolist()} / {lc.tolist()})")
    log(f"{name} captured vs eager: {len(e1)} state tensors, "
        f"{len(e1) - len(differ)} bit-equal in all three runs; "
        f"{len(differ)} differ between the eager runs "
        f"(eager-eager/captured-eager max|diff|: "
        f"{'; '.join(differ[:12])}{' ...' if len(differ) > 12 else ''}); "
        f"losses eager-eager {d_ee:.3g}, captured-eager {d_ce:.3g}")
    if bad:
        fail(f"{name}: captured run beyond the rule: {'; '.join(bad[:10])}")


def state_names(net):
    """The names of a network's ``_dispatch_state()`` tensors and their
    groups for :func:`hold_captured` (a param with its Adam moments);
    the updater state and the clock are made first."""
    net._ensure_opt_state()
    net._ensure_clock()
    names = [f"{n}.{p}" for n, ps in net._items(net._params) for p in ps]
    names += [f"{n}.{s}" for n, ss in net._items(net._states) for s in ss]
    names += [f"{n}.{p}.{m}" for n, ps in net._items(net._opt_state)
              for p, st in ps.items() for m in st]
    names.append("t")
    groups = [nm.rsplit(".", 1)[0] if nm.endswith((".m", ".v")) else nm
              for nm in names]
    return names, groups


def captured_fit(name, net, ds, per_step: int, smi: str,
                 exact: bool = False, live_before: int = None) -> dict:
    """Phase 14 for one network: 8 eager steps twice and 2 captured
    megasteps of 4 from one state, held by the rule (to the bit with
    ``exact``); then timed. ``per_step`` is the ``scale_shift_act``
    launches a step. Returns the eager and captured step ms, the capture
    seconds, the peak (GB and bytes, ``max_memory_allocated`` from the
    warmup on) and ``live_before``: the bytes allocated before the net was
    built (the caller's reading, else the bytes live on entry), which
    the peak holds too."""
    import torch

    from deeplearning4j_tpu_torch.analysis import churn
    from deeplearning4j_tpu_torch.nn import compilecache as cc
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.train import stepping
    k, steps = MEGA_K, 2 * MEGA_K
    if live_before is None:
        live_before = torch.cuda.memory_allocated()
    names, groups = state_names(net)
    s0 = snapshot(net._dispatch_state())

    def start():
        restore(net._dispatch_state(), s0)
        net._iteration = 0

    held, eager_ms = {}, []
    for run in ("eager 1", "eager 2"):
        start()
        losses = []
        for _ in range(steps):
            t0 = time.perf_counter()
            net.fit(ds)
            losses.append(net.score())
            eager_ms.append((time.perf_counter() - t0) * 1e3)
        held[run] = (losses, snapshot(net._dispatch_state()))
    start()
    cc.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cc.warmup(net, [(tuple(ds.features.shape), tuple(ds.labels.shape))],
              steps_per_dispatch=k)
    capture_s = time.perf_counter() - t0
    if not all(torch.equal(a, b) for a, b in zip(net._dispatch_state(), s0)):
        fail(f"{name}: compilecache.warmup changed the network's state")
    ck.reset_counts()
    mb = stepping.stack_megabatch([ds] * k)
    losses = []
    for _ in range(steps // k):
        losses += net._fit_mega(mb).tolist()
    held["captured"] = (losses, snapshot(net._dispatch_state()))
    hold_captured(name, held, names, groups, exact)
    cap_ms = []
    start()
    group = [ds] * steps
    for _ in range(2):
        t0 = time.perf_counter()
        net.fit(group, steps_per_dispatch=k)
        last = net.score()
        cap_ms.append((time.perf_counter() - t0) * 1e3 / steps)
    peak_bytes = torch.cuda.max_memory_allocated()
    peak_gb = peak_bytes / 1e9
    disp = net._step_for(False, k)
    at_capture = disp.launches_at_capture()
    stats = cc.cache_stats()
    site = f"{type(net).__name__}.megastep"
    n_sig = churn.get_churn_detector().signature_count(site, owner=net)
    n_disp = 3 * steps // k
    if at_capture != [{"scale_shift_act": k * per_step} if per_step else {}]:
        fail(f"{name}: the megastep recorded {at_capture}: want "
             f"{k} x {per_step} scale_shift_act launches")
    if any(ck.LAUNCHES.values()) or any(ck.PLAIN_CALLS.values()) \
            or ck.REPLAYS["scale_shift_act"] != n_disp * k * per_step:
        fail(f"{name}: {n_disp} replays ran {dict(ck.LAUNCHES)} eagerly, "
             f"replayed {dict(ck.REPLAYS)}")
    if stats["capture_failures"] or stats["compile_seconds"][
            "cold_compiles"] != 1 or stats["memory"]["hits"] != n_disp \
            or n_sig != 1:
        fail(f"{name}: cache stats {stats}, {n_sig} churn signatures: want "
             "one capture (at warmup), no failure, every dispatch a hit")
    e_med, c_med = float(np.median(eager_ms)), float(np.median(cap_ms))
    log(f"{name} fit B={int(ds.features.shape[0])}: eager step ms median "
        f"{e_med:.2f} (min {min(eager_ms):.2f}, max {max(eager_ms):.2f}); "
        f"captured K={k} step ms {', '.join(f'{v:.2f}' for v in cap_ms)} "
        f"(dispatch of {steps} steps / {steps}, with a host read at the "
        f"end), speed-up {e_med / c_med:.3f}x; capture {capture_s:.2f} s; "
        f"peak {peak_gb:.2f} GB; last loss {last:.5f}; launches at capture "
        f"{at_capture}, replayed {dict(ck.REPLAYS)}; cache_stats {stats} "
        f"[{smi}]")
    del s0, held
    return {"eager_ms": e_med, "captured_ms": c_med, "capture_s": capture_s,
            "peak_gb": peak_gb, "peak_bytes": peak_bytes,
            "live_before": live_before}


def samediff_fit_held(name, sd, batch, steps: int, smi: str,
                      per_step: dict) -> dict:
    """A SameDiff fit from one state three ways: ``steps`` eager steps
    twice (the step itself, ``sd._train_step``, as ``fit`` ran it before
    the capture) and ``steps`` calls of the public ``sd.fit`` on the
    captured dispatch, held by the captured-against-eager rule. Each
    eager run launches ``per_step`` kernels a step and no plain call; the
    captured fit captures once (``per_step`` recorded), replays every
    step, recaptures nothing and fails no capture. Losses finite, the
    last below the first. The three runs use PyTorch's deterministic
    algorithms (an embedding's backward accumulates with atomics
    otherwise, which makes every later step differ between two eager
    runs). Returns the median eager and captured ms of steps
    2-``steps`` (each ending in a host read of its loss) and the
    launches recorded at the capture."""
    import torch

    from deeplearning4j_tpu_torch.nn import compilecache as cc
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        held = _samediff_fit_held(name, sd, batch, steps, smi, per_step)
    finally:
        torch.use_deterministic_algorithms(was)
    # the times without deterministic algorithms: eager steps, then a
    # fresh capture and its replays, on from the held runs' state
    sd._invalidate()
    gc.collect()
    sd._prepare_fit()
    eager_ms, cap_ms = [], []
    for _ in range(2 * steps):      # the first round settles the allocator
        t0 = time.perf_counter()
        float(sd._train_step(sd._feed(batch)))
        sd._step += 1
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    eager_ms = eager_ms[steps:]
    torch.cuda.empty_cache()
    cc.reset_stats()
    for _ in range(steps):
        t0 = time.perf_counter()
        losses = sd.fit([batch]).lossCurve()
        cap_ms.append((time.perf_counter() - t0) * 1e3)
    st = cc.cache_stats()
    if st["capture_failures"] or st["compile_seconds"]["cold_compiles"] \
            != 1 or not np.isfinite(losses[-1]):
        fail(f"{name}: the timed capture: {st}, last loss {losses}")
    e_med, c_med = float(np.median(eager_ms)), float(np.median(cap_ms[1:]))
    log(f"{name} sd.fit timed (default algorithms): eager step ms median "
        f"{e_med:.2f} (min {min(eager_ms):.2f}, max {max(eager_ms):.2f}; "
        f"steps {steps + 1}-{2 * steps}), captured {c_med:.2f} (min "
        f"{min(cap_ms[1:]):.2f}, max {max(cap_ms[1:]):.2f}; with the "
        f"capture {cap_ms[0]:.2f}), speed-up {e_med / c_med:.3f}x [{smi}]")
    return {**held, "eager_ms": e_med, "captured_ms": c_med}


def _samediff_fit_held(name, sd, batch, steps: int, smi: str,
                       per_step: dict) -> dict:
    import torch

    from deeplearning4j_tpu_torch.nn import compilecache as cc
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    sd._prepare_fit()
    names = [f"var:{k}" for k in sd._variables]
    groups = list(sd._variables)
    for k, st in sd._updater_state.items():
        names += [f"upd:{k}.{m}" for m in st]
        groups += [k] * len(st)
    names.append("t")
    groups.append("t")
    if len(names) != len(sd._fit_state()):
        fail(f"{name}: {len(names)} state names for "
             f"{len(sd._fit_state())} state tensors")
    s0 = snapshot(sd._fit_state())

    def start():
        restore(sd._fit_state(), s0)
        sd._step = 0

    want = {k: 0 for k in ck.LAUNCHES}
    want.update({k: v * steps for k, v in per_step.items()})
    held, eager_ms = {}, []
    for run in ("eager 1", "eager 2"):
        start()
        sd._prepare_fit()
        ck.reset_counts()
        losses, ms = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            losses.append(float(sd._train_step(sd._feed(batch))))
            sd._step += 1
            ms.append((time.perf_counter() - t0) * 1e3)
        if dict(ck.LAUNCHES) != want or any(ck.PLAIN_CALLS.values()):
            fail(f"{name} eager fit launches {dict(ck.LAUNCHES)} (plain "
                 f"{dict(ck.PLAIN_CALLS)}) over {steps} steps: want "
                 f"{per_step} a step")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            fail(f"{name} eager fit losses not finite and falling: {losses}")
        held[run] = (losses, snapshot(sd._fit_state()))
        eager_ms += ms[1:]
    start()
    # the eager runs' cached blocks back to the card: the capture's pool
    # cannot use them
    torch.cuda.empty_cache()
    cc.reset_stats()
    ck.reset_counts()
    losses, cap_ms = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses += sd.fit([batch]).lossCurve()      # floats: waits for it
        cap_ms.append((time.perf_counter() - t0) * 1e3)
    held["captured"] = (losses, snapshot(sd._fit_state()))
    stats = cc.cache_stats()
    disps = sd.fit_dispatches()
    at_capture = disps[0].launches_at_capture() if len(disps) == 1 else []
    replays = {k: v * steps for k, v in per_step.items()}
    if len(disps) != 1 or disps[0].captures() != 1 \
            or at_capture != [dict(per_step)] \
            or stats["capture_failures"] or stats["eager_by_design"] \
            or stats["compile_seconds"]["cold_compiles"] != 1 \
            or stats["memory"] != {"hits": steps - 1, "misses": 1} \
            or {k: v for k, v in ck.REPLAYS.items() if v} != replays:
        fail(f"{name} captured fit: {len(disps)} dispatch(es), launches at "
             f"capture {at_capture}, replayed {dict(ck.REPLAYS)}, "
             f"cache_stats {stats}: want one capture recording {per_step}, "
             f"{steps} replays, no failure, no recapture")
    hold_captured(name, held, names, groups)
    e_med, c_med = float(np.median(eager_ms)), float(np.median(cap_ms[1:]))
    log(f"{name} sd.fit (deterministic algorithms): losses {', '.join(f'{v:.5f}' for v in losses)}; "
        f"eager step ms median {e_med:.2f} (min {min(eager_ms):.2f}, max "
        f"{max(eager_ms):.2f}), captured step ms median {c_med:.2f} (min "
        f"{min(cap_ms[1:]):.2f}, max {max(cap_ms[1:]):.2f}; the first, "
        f"with the capture, {cap_ms[0]:.2f}), speed-up {e_med / c_med:.3f}x"
        f"; launches at capture {at_capture[0]}, capture "
        f"{stats['compile_seconds']['cold']:.2f} s [{smi}]")
    del s0, held
    return {"eager_ms": e_med, "captured_ms": c_med,
            "at_capture": at_capture[0]}


def import_bert(smi: str) -> dict:
    """Phases 23 and 24: BERT-base enters by checkpoint import (path A)
    and by frozen GraphDef import (path B), each served and fine-tuned.
    Returns phase 23's layer-norm and flash launches, served (warmup and
    replays) and in its train steps."""
    import shutil

    import torch

    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.modelimport import tf_fixtures as fx
    from deeplearning4j_tpu_torch.modelimport import tf_proto
    from deeplearning4j_tpu_torch.modelimport.bert import (
        importBertModelAndWeights)
    from deeplearning4j_tpu_torch.modelimport.tensorflow import (
        importTensorflowGraph)
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.nn import compilecache as cc
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.serving import (ModelServer,
                                                  samediff_forward)
    from deeplearning4j_tpu_torch.train.updaters import Adam
    dev = torch.device("cuda")
    T, B = IMPORT_T, IMPORT_BATCH
    ck.install_platform_overrides()
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    w = fx.bert_weights(0, **fx.BERT_BASE)
    n_params = sum(a.size for a in w.values())
    log(f"BERT-base weights: {n_params} parameters ({4 * n_params / 1e6:.1f} "
        f"MB fp32) drawn in {time.perf_counter() - t0:.2f} s")
    tmp = tempfile.mkdtemp(prefix="bert_import_")
    try:
        # ------------------------------------------- 23. the checkpoint
        paths = {}
        t0 = time.perf_counter()
        for fmt, state in (("hf", fx.hf_state(w)), ("tf", w)):
            paths[fmt] = os.path.join(tmp, f"bert_{fmt}.bin")
            torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in state.items()}, paths[fmt])
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cfg, params = importBertModelAndWeights(paths["hf"],
                                                use_flash_attention=True)
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        cfg_tf, params_tf = importBertModelAndWeights(
            paths["tf"], use_flash_attention=True)
        leaves = tfm._leaf_paths(params)
        if cfg_tf != cfg or any(
                not torch.equal(a, b) for (_, a), (_, b) in
                zip(leaves, tfm._leaf_paths(params_tf))):
            fail("the HF-keyed and TF-named checkpoints imported to "
                 "different configs or params")
        del params_tf
        if (cfg.vocab_size, cfg.d_model, cfg.n_heads, cfg.n_layers,
                cfg.d_ff, cfg.max_len, cfg.type_vocab_size) != \
                (30522, 768, 12, 12, 3072, 512, 2) or \
                cfg.dtype != torch.float32 or cfg.arch != "postln_bert":
            fail(f"imported config {cfg}")
        log(f"path A: two checkpoints ({os.path.getsize(paths['hf']) / 1e6:.1f}"
            f" MB each) written in {save_s:.2f} s; importBertModelAndWeights "
            f"{import_s:.2f} s; HF-keyed and TF-named params bit-equal; "
            f"{sum(p.numel() for _, p in leaves)} parameters on the card")
        head = {k: torch.from_numpy(w[k]).to(dev) for k in (
            "bert/pooler/dense/kernel", "bert/pooler/dense/bias",
            "output_weights", "output_bias")}

        def classify(tokens):
            """The sequence classifier over the imported encoder: the
            pooler and head on the [CLS] row (run_classifier.py's)."""
            with torch.inference_mode():
                x = tfm.encode(params, tokens.long(), cfg)
                pooled = torch.tanh(x[:, 0] @ head["bert/pooler/dense/kernel"]
                                    + head["bert/pooler/dense/bias"])
                return pooled, pooled @ head["output_weights"].T \
                    + head["output_bias"]

        rng = np.random.default_rng(3)
        ref_ids = rng.integers(0, cfg.vocab_size, (8, T), dtype=np.int32)
        ref_pooled, ref_logits = classify(torch.from_numpy(ref_ids).to(dev))

        server = ModelServer(lambda x: classify(x)[1], batch_limit=B,
                             input_dtype=np.int32, coalesce_ms=5.0,
                             max_queue=256)
        try:
            cc.reset_stats()
            ck.reset_counts()
            t0 = time.perf_counter()
            server.warmup([(T,)])
            warm_s = time.perf_counter() - t0
            warm = dict(ck.LAUNCHES)
            routes = dict(ck.FLASH_ROUTES)
            at_capture = server._dispatch.launches_at_capture()
            if cc.cache_stats()["capture_failures"] or \
                    len(at_capture) != len(server.buckets()) or \
                    any(a != {"flash_attention": 12, "layer_norm": 25}
                        for a in at_capture) or routes["tensor_core"]:
                fail(f"imported BERT-base captures {at_capture}, routes "
                     f"{routes}, cache_stats {cc.cache_stats()}: want "
                     f"{len(server.buckets())} graphs of 12 fp32 CUDA-core "
                     "flash and 25 layer_norm launches and no failure")
            log(f"path A warmup: {len(at_capture)} graphs (buckets "
                f"{server.buckets()} x T={T}) captured in {warm_s:.2f} s, "
                f"each 12 flash (fp32, CUDA-core route) + 25 layer_norm")
            reqs = [rng.integers(0, cfg.vocab_size, (int(rng.integers(1, 9)), T),
                                 dtype=np.int32) for _ in range(64)]
            handles, got, wall, launches, plain, n_fwd = serve_burst(
                server, reqs)
            replays = dict(ck.REPLAYS)
            want = {k: 0 for k in ck.KERNELS}
            want.update(flash_attention=12 * n_fwd, layer_norm=25 * n_fwd)
            if any(h.resolutions != 1 for h in handles) or \
                    server.counts["completed"] != 64 or \
                    any(launches.values()) or any(plain.values()) or \
                    replays != want or server.recompiles_after_warmup():
                fail(f"path A serving: counts {dict(server.counts)}, eager "
                     f"launches {launches} (plain {plain}), replays "
                     f"{replays} over {n_fwd} forwards: want every request "
                     "once, none eagerly, 12 + 25 replayed a forward")
            worst = max(float(np.abs(g - classify(torch.from_numpy(r).to(
                dev))[1].cpu().numpy()).max()) for r, g in zip(reqs, got))
            if worst > 1e-4:
                fail(f"served and direct logits differ by {worst:.3g}")
            log(f"path A served 64 requests in {n_fwd} captured forwards: "
                f"replayed {replays}; served vs direct max|diff| {worst:.3g}")
            path_a = log_latency(handles, reqs, wall, smi)
            x32 = rng.integers(0, cfg.vocab_size, (B, T), dtype=np.int32)
            server._forward_raw(x32)
            ts = []
            for _ in range(10):
                t0 = time.perf_counter()
                server._forward_raw(x32)
                ts.append((time.perf_counter() - t0) * 1e3)
            rep_ms = path_a["replay_ms"] = float(np.median(ts))
            log(f"path A B={B}, T={T} forward+head, host batch to host "
                f"answer, captured replay (median of 10): {rep_ms:.3f} ms, "
                f"{B * T / (rep_ms / 1e3):.0f} tokens/s [{smi}]")
        finally:
            server.close()
        served = {k: warm[k] + replays[k]
                  for k in ("flash_attention", "layer_norm")}

        # the same forward on the plain versions of both kernels
        plain_overrides(registry, ck)
        plain_pooled, plain_logits = classify(torch.from_numpy(ref_ids).to(dev))
        ck.install_platform_overrides()
        dk = max(float((ref_pooled - plain_pooled).abs().max()),
                 float((ref_logits - plain_logits).abs().max()))
        log(f"path A kernels vs plain forward (fp32): max|diff| {dk:.3g}")
        if dk > 1e-4 or not bool(torch.isfinite(ref_logits).all()):
            fail("path A's kernels and plain versions disagree beyond 1e-4")

        # fine-tune: the BertBench-style MLM step on the imported params
        updater = Adam(1e-4)
        opt = tfm.init_opt_state(params, updater)
        step = tfm.make_train_step(cfg, updater)
        t_dev = torch.zeros((), dtype=torch.int32, device=dev)
        tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T))).to(dev)
        tgt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T))).to(dev)
        step(params, opt, t_dev, tok, tgt)         # warm
        torch.cuda.synchronize()
        ck.reset_counts()
        losses, step_ms = [], []
        for _ in range(IMPORT_STEPS):
            t0 = time.perf_counter()
            losses.append(float(step(params, opt, t_dev, tok, tgt)))
            step_ms.append((time.perf_counter() - t0) * 1e3)
        train = dict(ck.LAUNCHES)
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0] or \
                train["flash_attention"] != 12 * IMPORT_STEPS or \
                train["layer_norm"] != 25 * IMPORT_STEPS or \
                any(ck.PLAIN_CALLS.values()):
            fail(f"path A training: losses {losses}, launches {train} "
                 f"(plain {dict(ck.PLAIN_CALLS)}) over {IMPORT_STEPS} steps")
        med = float(np.median(step_ms))
        log(f"path A make_train_step B={B}, T={T}, Adam 1e-4: losses "
            f"{', '.join(f'{v:.5f}' for v in losses)}; step ms median "
            f"{med:.2f} (min {min(step_ms):.2f}, max {max(step_ms):.2f}), "
            f"{B * T / (med / 1e3):.0f} tokens/s; 12 flash + 25 LN launches "
            f"a step [{smi}]")
        del params, opt, head
        torch.cuda.empty_cache()

        # -------------------------------------------- 24. the GraphDef
        t0 = time.perf_counter()
        gd = fx.bert_graph_def(w, T=T, H=cfg.n_heads)
        write_s = time.perf_counter() - t0
        names = list(w)
        del w
        t0 = time.perf_counter()
        graph = tf_proto.load_graph_def(gd)
        parse_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sd = importTensorflowGraph(graph)
        torch.cuda.synchronize()
        gimport_s = time.perf_counter() - t0
        # again in the same process: the first import also pays torch's
        # one-time load of its meta kernels (the fold check's first meta op)
        t0 = time.perf_counter()
        again = importTensorflowGraph(graph)
        torch.cuda.synchronize()
        again_s = time.perf_counter() - t0
        del again
        log(f"path B: GraphDef {len(gd) / 1e6:.1f} MB, {len(graph.node)} "
            f"nodes, written in {write_s:.2f} s, parsed in {parse_s:.3f} s, "
            f"imported in {gimport_s:.2f} s (again in the process: "
            f"{again_s:.2f} s): {len(sd._nodes)} ops, {len(sd._constants)} "
            f"constants; import report {sd.import_report.codes()} [{smi}]")
        del graph, gd
        ck.reset_counts()
        out = sd.output({"input_ids": ref_ids}, ["pooled_output", "logits"])
        if any(ck.LAUNCHES.values()):
            fail(f"the imported graph launched kernels {dict(ck.LAUNCHES)}")
        dp = float((out["pooled_output"] - ref_pooled).abs().max())
        dl = float((out["logits"] - ref_logits).abs().max())
        log(f"path B vs path A on one [8, {T}] batch: pooled max|diff| "
            f"{dp:.3g}, logits max|diff| {dl:.3g}")
        if max(dp, dl) > 1e-3 or out["logits"].shape != (8, 2):
            fail("path B's outputs differ from path A's by more than 1e-3")

        server = ModelServer(samediff_forward(sd, ["logits"],
                                              input_name="input_ids"),
                             batch_limit=B, input_dtype=np.int32,
                             coalesce_ms=5.0, max_queue=256)
        try:
            cc.reset_stats()
            t0 = time.perf_counter()
            server.warmup([(T,)])
            warm_s = time.perf_counter() - t0
            stats = cc.cache_stats()
            reqs = [rng.integers(0, cfg.vocab_size, (int(rng.integers(1, 9)), T),
                                 dtype=np.int32) for _ in range(64)]
            handles, got, wall, launches, _, n_fwd = serve_burst(server, reqs)
            if any(h.resolutions != 1 for h in handles) or \
                    server.counts["completed"] != 64 or \
                    any(launches.values()) or stats["capture_failures"]:
                fail(f"path B serving: counts {dict(server.counts)}, "
                     f"launches {launches}, cache_stats {stats}")
            worst = max(float(np.abs(g - sd.output(
                {"input_ids": r}, ["logits"])["logits"].cpu().numpy()).max())
                for r, g in zip(reqs, got))
            if worst > 1e-4:
                fail(f"path B served and direct logits differ by {worst:.3g}")
            log(f"path B warmup {warm_s:.2f} s ({stats}); served 64 "
                f"requests in {n_fwd} forwards, served vs direct max|diff| "
                f"{worst:.3g}")
            log_latency(handles, reqs, wall, smi)
        finally:
            server.close()
        # the served graphs' pool and the second import go before the fit
        # captures its step (a server and its dispatch form a cycle)
        del server
        gc.collect()
        torch.cuda.empty_cache()

        consumed = {i for node in sd._nodes for i in node.inputs}
        trained = [n for n in names if n in consumed]
        sd.convertToVariables(*trained)
        labels = sd.placeHolder("labels", shape=(None, 2), dtype=np.float32)
        sd.loss.softmaxCrossEntropy(labels, sd.getVariable("logits"),
                                    name="loss")
        sd.setLossVariables("loss")
        sd.setTrainingConfig(TrainingConfig(
            updater=Adam(1e-4), data_set_feature_mapping=["input_ids"],
            data_set_label_mapping=["labels"]))
        batch = {"input_ids": torch.from_numpy(rng.integers(
                     0, cfg.vocab_size, (B, T), dtype=np.int32)).to(dev),
                 "labels": torch.from_numpy(np.eye(2, dtype=np.float32)[
                     rng.integers(0, 2, B)]).to(dev)}
        # no kernel: the importer's softmax is plain torch
        fb = samediff_fit_held("path B", sd, batch, IMPORT_FIT_STEPS, smi,
                               {})
        log(f"path B sd.fit B={B}, T={T}, Adam 1e-4 over {len(trained)} "
            f"unfrozen weights: eager {fb['eager_ms']:.2f} ms a step, "
            f"captured {fb['captured_ms']:.2f}; "
            f"{B * T / (fb['captured_ms'] / 1e3):.0f} tokens/s captured "
            f"[{smi}]")

        p = os.path.join(tmp, "bert_graph.sdz")
        t0 = time.perf_counter()
        sd.save(p, save_updater_state=False)
        back = SameDiff.load(p)
        rt_s = time.perf_counter() - t0
        a = sd.output({"input_ids": ref_ids}, ["logits"])["logits"]
        b = back.output({"input_ids": ref_ids}, ["logits"])["logits"]
        if not torch.equal(a, b):
            fail(f"path B save/load: logits differ by "
                 f"{float((a - b).abs().max()):.3g}")
        log(f"path B save + load ({os.path.getsize(p) / 1e6:.1f} MB) in "
            f"{rt_s:.2f} s through the 'tf' rebuild: logits bit-equal; "
            f"phases 23-24 {time.perf_counter() - t_phase:.1f} s")
        del sd, back
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"served": served, "path_a": path_a,
            "train": {k: train[k] for k in ("flash_attention", "layer_norm")}}


def keras_encoder(smi: str, path_a: dict = None) -> dict:
    """Phase 28: the BERT-base-shaped Keras encoder enters by import.
    Returns its layer-norm launches served at T=128 (warmup and replays)
    and its flash and layer-norm launches at T=1024."""
    import shutil

    import torch

    from deeplearning4j_tpu_torch.modelimport import keras_fixtures as kf
    from deeplearning4j_tpu_torch.modelimport.hdf5 import Hdf5Archive
    from deeplearning4j_tpu_torch.modelimport.keras import (
        importKerasModelAndWeights)
    from deeplearning4j_tpu_torch.nn import compilecache as cc
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.ops import registry
    from deeplearning4j_tpu_torch.serving import ModelServer
    dev = torch.device("cuda")
    T, B = KERAS_T, KERAS_BATCH
    ck.install_platform_overrides()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="keras_import_")
    try:
        path = os.path.join(tmp, "encoder.h5")
        t0 = time.perf_counter()
        n = kf.encoder_h5(path, 0, T=T)
        write_s = time.perf_counter() - t0
        if n != KERAS_PARAMS:
            fail(f"the Keras encoder has {n} parameters, want {KERAS_PARAMS}")
        t0 = time.perf_counter()
        arch = Hdf5Archive(path)
        layers = [e["name"] for e in arch.model_config()["config"]["layers"]]
        n_read = sum(a.size for name in layers
                     for a in arch.layer_weights(name).values())
        arch.close()
        parse_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        net = importKerasModelAndWeights(path)
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        kinds = [type(layer).__name__ for _, layer in net._layers()]
        if n_read != n or net.numParams() != n or \
                kinds.count("LayerNorm") != 25 or \
                kinds.count("SelfAttentionLayer") != 12 or \
                any(p.device.type != "cuda" for d in net._params.values()
                    for p in d.values()):
            fail(f"imported encoder: {n_read} weights read, "
                 f"{net.numParams()} params, layers {kinds}")
        log(f"phase 28: Keras encoder .h5 {os.path.getsize(path) / 1e6:.1f} MB"
            f" ({n} parameters) written in {write_s:.2f} s; parse (the model "
            f"config and every weight view) {parse_s:.3f} s; "
            f"importKerasModelAndWeights {import_s:.2f} s onto the card: "
            f"{len(kinds)} layers, import report "
            f"{net.import_report.codes()} [{smi}]")

        def classify(tokens):
            """The imported encoder's class probabilities; the position
            ids are made on the card, so a request carries tokens only."""
            pos = torch.arange(tokens.shape[1], device=tokens.device,
                               dtype=torch.int32).expand(tokens.shape[0], -1)
            return net.output([tokens, pos])

        server = ModelServer(classify, batch_limit=B, input_dtype=np.int32,
                             coalesce_ms=5.0, max_queue=256)
        rng = np.random.default_rng(28)
        try:
            cc.reset_stats()
            ck.reset_counts()
            t0 = time.perf_counter()
            server.warmup([(T,)])
            warm_s = time.perf_counter() - t0
            warm = dict(ck.LAUNCHES)
            at_capture = server._dispatch.launches_at_capture()
            if cc.cache_stats()["capture_failures"] or \
                    len(at_capture) != len(server.buckets()) or \
                    any(a != {"layer_norm": 25} for a in at_capture):
                fail(f"imported Keras encoder captures {at_capture}, "
                     f"cache_stats {cc.cache_stats()}: want "
                     f"{len(server.buckets())} graphs of 25 layer_norm "
                     "launches (no flash below T=1024) and no failure")
            log(f"phase 28 warmup: {len(at_capture)} graphs (buckets "
                f"{server.buckets()} x T={T}) captured in {warm_s:.2f} s, "
                "each 25 layer_norm launches and no flash (T < 1024)")
            reqs = [rng.integers(0, 30522, (int(rng.integers(1, 9)), T),
                                 dtype=np.int32) for _ in range(64)]
            handles, got, wall, launches, plain, n_fwd = serve_burst(
                server, reqs)
            replays = dict(ck.REPLAYS)
            want = {k: 0 for k in ck.KERNELS}
            want["layer_norm"] = 25 * n_fwd
            if any(h.resolutions != 1 for h in handles) or \
                    server.counts["completed"] != 64 or \
                    any(launches.values()) or any(plain.values()) or \
                    replays != want or server.recompiles_after_warmup():
                fail(f"Keras encoder serving: counts {dict(server.counts)}, "
                     f"eager launches {launches} (plain {plain}), replays "
                     f"{replays} over {n_fwd} forwards, recompiles "
                     f"{server.recompiles_after_warmup()}")
            worst = max(float(np.abs(g - classify(torch.from_numpy(r).to(
                dev)).cpu().numpy()).max()) for r, g in zip(reqs, got))
            if worst > 1e-4 or not all(np.isfinite(g).all() and
                                       g.shape == (r.shape[0], 2)
                                       for r, g in zip(reqs, got)):
                fail(f"served and direct probabilities differ by "
                     f"{worst:.3g}, or are not finite [N, 2]")
            log(f"phase 28 served 64 requests in {n_fwd} captured forwards: "
                f"replayed {replays}; served vs direct max|diff| "
                f"{worst:.3g}; recompiles_after_warmup 0")
            lat = log_latency(handles, reqs, wall, smi)
            x32 = rng.integers(0, 30522, (B, T), dtype=np.int32)
            server._forward_raw(x32)
            ts = []
            for _ in range(10):
                t0 = time.perf_counter()
                server._forward_raw(x32)
                ts.append((time.perf_counter() - t0) * 1e3)
            rep_ms = float(np.median(ts))
            a = path_a or {}
            log(f"phase 28 B={B}, T={T}, host batch to host answer, "
                f"captured replay (median of 10): {rep_ms:.3f} ms, "
                f"{B * T / (rep_ms / 1e3):.0f} tokens/s; served "
                f"{lat['tokens_per_s']:.1f} tokens/s, p99 "
                f"{lat['p99_ms']:.2f} ms; beside phase 23's path A (the same "
                f"widths through transformer.encode): replay "
                f"{a.get('replay_ms', float('nan')):.3f} ms, served "
                f"{a.get('tokens_per_s', float('nan')):.1f} tokens/s, p99 "
                f"{a.get('p99_ms', float('nan')):.2f} ms [{smi}]")
        finally:
            server.close()
        served = warm["layer_norm"] + replays["layer_norm"]

        # the kernels against their plain versions on one batch
        xb = torch.from_numpy(rng.integers(0, 30522, (8, T),
                                           dtype=np.int32)).to(dev)
        ref = classify(xb)
        plain_overrides(registry, ck)
        plain = classify(xb)
        ck.install_platform_overrides()
        dk = float((ref - plain).abs().max())
        log(f"phase 28 kernels vs plain forward (fp32, [8, {T}]): max|diff| "
            f"{dk:.3g}")
        if dk > 1e-4:
            fail("phase 28's kernels and plain versions disagree beyond 1e-4")
        del net, server, ref, plain
        torch.cuda.empty_cache()

        # the flash route: a depth-2 copy with 1024 positions at T=1024
        path2 = os.path.join(tmp, "encoder_1024.h5")
        kf.encoder_h5(path2, 1, P=KERAS_LONG_T, L=2, T=KERAS_LONG_T)
        net2 = importKerasModelAndWeights(path2)

        def classify2(tokens):
            pos = torch.arange(tokens.shape[1], device=tokens.device,
                               dtype=torch.int32).expand(tokens.shape[0], -1)
            return net2.output([tokens, pos])

        xl = rng.integers(0, 30522, (KERAS_LONG_B, KERAS_LONG_T),
                          dtype=np.int32)
        server = ModelServer(classify2, batch_limit=KERAS_LONG_B,
                             input_dtype=np.int32, coalesce_ms=5.0)
        try:
            cc.reset_stats()
            ck.reset_counts()
            server.warmup([(KERAS_LONG_T,)])
            long_warm = dict(ck.LAUNCHES)
            routes = dict(ck.FLASH_ROUTES)
            at_capture = server._dispatch.launches_at_capture()
            ck.reset_counts()
            got = server.submit(xl).get(300)
            long_replays = dict(ck.REPLAYS)
            if cc.cache_stats()["capture_failures"] or any(
                    a != {"flash_attention": 2, "layer_norm": 5}
                    for a in at_capture) or routes["tensor_core"] or \
                    long_replays["flash_attention"] != 2 or \
                    long_replays["layer_norm"] != 5 or \
                    any(ck.LAUNCHES.values()):
                fail(f"T={KERAS_LONG_T}: captures {at_capture}, routes "
                     f"{routes}, replays {long_replays}, eager "
                     f"{dict(ck.LAUNCHES)}: want 2 fp32 CUDA-core flash + 5 "
                     "layer_norm a forward")
        finally:
            server.close()
        xt = torch.from_numpy(xl).to(dev)
        ck.reset_counts()
        ref = classify2(xt)
        direct = dict(ck.LAUNCHES)
        direct_routes = dict(ck.FLASH_ROUTES)
        plain_overrides(registry, ck)
        plain = classify2(xt)
        ck.install_platform_overrides()
        dk2 = max(float((ref - plain).abs().max()),
                  float(np.abs(got - ref.cpu().numpy()).max()))
        if direct["flash_attention"] != 2 or direct["layer_norm"] != 5 or \
                direct_routes["cuda_core"] != 2 or dk2 > 1e-4:
            fail(f"T={KERAS_LONG_T} direct forward: launches {direct}, "
                 f"routes {direct_routes}; kernels vs plain and served vs "
                 f"direct {dk2:.3g} (want 2 CUDA-core flash, 5 LN, 1e-4)")
        log(f"phase 28 depth-2 copy at [{KERAS_LONG_B}, {KERAS_LONG_T}]: "
            f"served (captures of {at_capture[0]}), a direct forward "
            f"{direct['flash_attention']} fp32 flash on the CUDA-core route "
            f"+ {direct['layer_norm']} LN; kernels vs plain and served vs "
            f"direct max|diff| {dk2:.3g}; phase 28 "
            f"{time.perf_counter() - t_phase:.1f} s [{smi}]")
        del net2
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"served_layer_norm": served,
            "long_flash": long_warm["flash_attention"]
            + long_replays["flash_attention"] + direct["flash_attention"],
            "long_layer_norm": long_warm["layer_norm"]
            + long_replays["layer_norm"] + direct["layer_norm"]}


def onnx_resnet(smi: str) -> None:
    """Phase 29: ResNet-50 v1 enters from an ONNX file and is served."""
    import shutil

    import torch

    from deeplearning4j_tpu_torch.autodiff import SameDiff
    from deeplearning4j_tpu_torch.modelimport import onnx_fixtures as fx
    from deeplearning4j_tpu_torch.modelimport import onnx_proto
    from deeplearning4j_tpu_torch.modelimport.onnx import importOnnxModel
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn import compilecache as cc
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.serving import (ModelServer,
                                                  samediff_forward)
    dev = torch.device("cuda")
    B = ONNX_BATCH
    t_phase = time.perf_counter()
    net = zoo.ResNet50(num_classes=1000, seed=0,
                       input_shape=(3, 224, 224)).init()
    fx.randomize_batch_norm(net, seed=0)
    tmp = tempfile.mkdtemp(prefix="onnx_import_")
    try:
        path = os.path.join(tmp, "resnet50-v1.onnx")
        t0 = time.perf_counter()
        fx.write_resnet50(net, path)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        model = onnx_proto.load_model(path)
        parse_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sd = importOnnxModel(model)
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        kinds = sorted({n.op_type for n in model.graph.nodes})
        n_nodes = len(model.graph.nodes)
        del model
        codes = sd.import_report.codes()
        log(f"phase 29: ResNet-50 v1 ONNX {os.path.getsize(path) / 1e6:.1f} "
            f"MB ({net.numParams()} parameters, {n_nodes} nodes of "
            f"{kinds}) written in {write_s:.2f} s; parsed in {parse_s:.3f} "
            f"s, imported onto the card in {import_s:.2f} s: "
            f"{len(sd._nodes)} ops, {len(sd._constants)} constants; import "
            f"report {codes} [{smi}]")
        if any(c.startswith("DL4J-E16") for c in codes) or \
                any(t.device.type != "cuda"
                    for t in sd._constants.values()):
            fail(f"the ONNX import: report {sd.import_report.format()}")

        # the gate: one B=32 batch against the ComputationGraph
        rng = np.random.default_rng(3)
        x32 = rng.standard_normal((B, 3, 224, 224), dtype=np.float32)
        xt = torch.from_numpy(x32).to(dev)
        ck.reset_counts()
        logits = sd.output({"input": xt}, ["logits"])["logits"]
        imported_launches = dict(ck.LAUNCHES)
        ref = fx.resnet50_logits(net, xt)
        probs = net.output(xt)
        lmax = float(ref.abs().max())
        dl = float((logits - ref).abs().max())
        dp = float((torch.softmax(logits, -1) - probs).abs().max())
        log(f"phase 29 ONNX import vs ComputationGraph on one [{B}, 3, 224, "
            f"224] batch (fp32): logits max|diff| {dl:.3g} (max|logit| "
            f"{lmax:.4g}, relative {dl / lmax:.3g}), softmax vs output() "
            f"max|diff| {dp:.3g}")
        if tuple(logits.shape) != (B, 1000) or \
                not bool(torch.isfinite(logits).all()) or \
                dl > ONNX_LOGIT_TOL * lmax or dp > ONNX_PROB_TOL or \
                any(imported_launches.values()):
            fail(f"the imported ResNet-50 differs from the graph beyond "
                 f"{ONNX_LOGIT_TOL:g} of max|logit| (or softmax beyond "
                 f"{ONNX_PROB_TOL:g}), or launched {imported_launches}")
        del probs, ref
        net_params = net.numParams()
        del net
        torch.cuda.empty_cache()

        server = ModelServer(samediff_forward(sd, ["logits"],
                                              input_name="input"),
                             batch_limit=B, input_dtype=np.float32,
                             coalesce_ms=5.0, max_queue=256)
        try:
            cc.reset_stats()
            t0 = time.perf_counter()
            server.warmup([(3, 224, 224)])
            warm_s = time.perf_counter() - t0
            stats = cc.cache_stats()
            at_capture = server._dispatch.launches_at_capture()
            reqs = [rng.standard_normal((int(rng.integers(1, 9)), 3, 224,
                                         224), dtype=np.float32)
                    for _ in range(ONNX_REQUESTS)]
            handles, got, wall, launches, plain, n_fwd = \
                serve_burst(server, reqs)
            replays = dict(ck.REPLAYS)
            recompiles = server.recompiles_after_warmup()
            if any(h.resolutions != 1 for h in handles) or \
                    server.counts["completed"] != ONNX_REQUESTS or \
                    any(launches.values()) or any(plain.values()) or \
                    any(replays.values()) or recompiles or \
                    stats["capture_failures"] or \
                    len(at_capture) != len(server.buckets()):
                fail(f"ONNX serving: counts {dict(server.counts)}, "
                     f"launches {launches}, replays {replays}, "
                     f"recompiles {recompiles}, captures {at_capture}, "
                     f"cache_stats {stats}")
            worst = 0.0
            for r, g in zip(reqs, got):
                want = sd.output({"input": r}, ["logits"])["logits"]
                worst = max(worst, float(np.abs(
                    g - want.cpu().numpy()).max()))
            if worst > ONNX_LOGIT_TOL * lmax:
                fail(f"ONNX served and direct logits differ by {worst:.3g}")
            images = sum(int(r.shape[0]) for r in reqs)
            lat = sorted(h.resolved_at - h.enqueued_at for h in handles)
            log(f"phase 29 warmup {warm_s:.2f} s: {len(at_capture)} graphs "
                f"(buckets {server.buckets()}), no kernel; served "
                f"{ONNX_REQUESTS} requests ({images} images) in {n_fwd} "
                f"captured forwards, each resolved once, served vs direct "
                f"max|diff| {worst:.3g}; {images / wall:.1f} images/s, "
                f"latency p50 {1e3 * float(np.percentile(lat, 50)):.2f} ms, "
                f"p99 {1e3 * float(np.percentile(lat, 99)):.2f} ms [{smi}]")
            server._forward_raw(x32)
            ts = []
            for _ in range(10):
                t0 = time.perf_counter()
                server._forward_raw(x32)
                ts.append((time.perf_counter() - t0) * 1e3)
            rep_ms = float(np.median(ts))
            log(f"phase 29 B={B} 224^2 fp32 forward, host batch to host "
                f"answer, captured replay (median of 10): {rep_ms:.3f} ms, "
                f"{B / (rep_ms / 1e3):.1f} images/s [{smi}]")
        finally:
            server.close()

        p = os.path.join(tmp, "resnet50_onnx.sdz")
        t0 = time.perf_counter()
        sd.save(p, save_updater_state=False)
        back = SameDiff.load(p)
        rt_s = time.perf_counter() - t0
        a = sd.output({"input": xt}, ["logits"])["logits"]
        b = back.output({"input": xt}, ["logits"])["logits"]
        if not torch.equal(a, b):
            fail(f"ONNX save/load: logits differ by "
                 f"{float((a - b).abs().max()):.3g}")
        log(f"phase 29 save + load ({os.path.getsize(p) / 1e6:.1f} MB, "
            f"{net_params} parameters) in {rt_s:.2f} s through the 'onnx' "
            f"rebuild: logits bit-equal; phase 29 "
            f"{time.perf_counter() - t_phase:.1f} s")
        del sd, back
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def transfer_tinyyolo(smi: str) -> int:
    """Phase 30: TinyYOLO fine-tuned into a 10-class detector with its
    feature extractor frozen. Returns the ``scale_shift_act`` launches its
    K=4 capture recorded."""
    import torch

    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.nn import compilecache as cc
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.objdetect import (Yolo2OutputLayer,
                                                       yolo_labels)
    from deeplearning4j_tpu_torch.nn.transfer import (FineTuneConfiguration,
                                                      TransferLearning,
                                                      TransferLearningHelper)
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.train import stepping
    from deeplearning4j_tpu_torch.train.updaters import Adam
    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    ck.install_platform_overrides()
    src = zoo.TinyYOLO(num_classes=YOLO_CLASSES).init()
    src.setPrecisionPolicy("bf16")
    src.setComputeLayout("NHWC")
    src.setEpilogueFusion(True)
    src0 = snapshot([t for d in src._params for t in d.values()])
    head_at = len(src.layers) - 2          # the 1x1 conv before the output
    frozen_until = head_at - 1
    if not (isinstance(src.layers[head_at], L.ConvolutionLayer)
            and isinstance(src.layers[frozen_until], L.ActivationLayer)
            and src.layers[frozen_until].activation == "leakyrelu"):
        fail(f"TinyYOLO's layers {frozen_until}-{head_at}: "
             f"{src.layers[frozen_until:]}")
    n_out = 5 * (5 + TRANSFER_CLASSES)
    t0 = time.perf_counter()
    net = (TransferLearning.Builder(src)
           .fineTuneConfiguration(FineTuneConfiguration.Builder()
                                  .updater(Adam(1e-4)).build())
           .setFeatureExtractor(frozen_until)
           .removeLayersFromOutput(2)
           .addLayer(L.ConvolutionLayer(kernelSize=(1, 1), nOut=n_out,
                                        activation="identity"))
           .addLayer(Yolo2OutputLayer(boundingBoxPriors=zoo.TinyYOLO.ANCHORS))
           .build())
    net.setPrecisionPolicy("bf16")
    net.setEpilogueFusion(True)
    build_s = time.perf_counter() - t0
    frozen = sorted(net._frozen_layers)
    if net._compute_layout != "NHWC" or frozen != list(range(head_at)):
        fail(f"the new net: layout {net._compute_layout}, frozen {frozen}")
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(
        (YOLO_BATCH, 3, 416, 416), dtype=np.float32)).to(dev)
    y = torch.from_numpy(yolo_labels(rng, YOLO_BATCH,
                                     TRANSFER_CLASSES)).to(dev)
    ds = DataSet(x, y)
    log(f"phase 30: TinyYOLO ({src.numParams()} parameters, "
        f"{YOLO_CLASSES} classes) -> {TRANSFER_CLASSES}-class detector "
        f"({net.numParams()} parameters, layers 0-{frozen_until} frozen: "
        f"{sum(net._params[i][k].numel() for i in frozen for k in net._params[i])}"
        f" parameters), built in {build_s:.2f} s; bf16 policy, NHWC, fused "
        f"epilogues {sorted(net._ensure_epilogue_plan())}")
    net._ensure_opt_state()
    net._ensure_clock()
    frozen_t = [net._params[i][k] for i in frozen for k in net._params[i]]
    frozen_t += [v for i in frozen for st in net._opt_state[i].values()
                 for v in st.values()]
    head_t = [t for i in range(head_at, len(net.layers))
              for t in net._params[i].values()]
    frozen0, head0 = snapshot(frozen_t), snapshot(head_t)
    names = [f"{n}.{p}" for n, ps in net._items(net._params) for p in ps]
    names += [f"{n}.{s}" for n, ss in net._items(net._states) for s in ss]
    names += [f"{n}.{p}.{m}" for n, ps in net._items(net._opt_state)
              for p, st in ps.items() for m in st]
    names.append("t")
    s0 = snapshot(net._dispatch_state())

    def start():
        restore(net._dispatch_state(), s0)
        net._iteration = 0

    def frozen_held(what):
        bad = [i for i, (a, b) in enumerate(zip(frozen_t, frozen0))
               if not torch.equal(a, b)]
        if bad:
            fail(f"phase 30 {what}: {len(bad)} frozen params or updater "
                 f"state tensors moved")

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        held, eager_ms, per_step = {}, [], []
        for run in ("eager 1", "eager 2"):
            start()
            losses = []
            for _ in range(TRANSFER_STEPS):
                ck.reset_counts()
                t0 = time.perf_counter()
                net.fit(ds)
                losses.append(net.score())
                eager_ms.append((time.perf_counter() - t0) * 1e3)
                per_step.append(ck.LAUNCHES["scale_shift_act"])
            held[run] = (losses, snapshot(net._dispatch_state()))
            frozen_held(run)
            moved = [i for i, (a, b) in enumerate(zip(head_t, head0))
                     if torch.equal(a, b)]
            if moved:
                fail(f"phase 30 {run}: head params {moved} did not move")
        start()
        cc.reset_stats()
        t0 = time.perf_counter()
        cc.warmup(net, [(tuple(x.shape), tuple(y.shape))],
                  steps_per_dispatch=MEGA_K)
        capture_s = time.perf_counter() - t0
        if not all(torch.equal(a, b)
                   for a, b in zip(net._dispatch_state(), s0)):
            fail("phase 30: compilecache.warmup changed the network's state")
        at_capture = net._step_for(False, MEGA_K).launches_at_capture()
        mb = stepping.stack_megabatch([ds] * MEGA_K)
        losses, cap_ms = [], []
        ck.reset_counts()
        for _ in range(TRANSFER_STEPS // MEGA_K):
            t0 = time.perf_counter()
            losses += net._fit_mega(mb).tolist()
            cap_ms.append((time.perf_counter() - t0) * 1e3 / MEGA_K)
        cap_launches, cap_replays = dict(ck.LAUNCHES), dict(ck.REPLAYS)
        held["captured"] = (losses, snapshot(net._dispatch_state()))
        frozen_held("captured")
        stats = cc.cache_stats()
        hold_captured("phase 30 transfer", held, names, exact=True)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    n_disp = TRANSFER_STEPS // MEGA_K
    want = {k: 0 for k in ck.KERNELS}
    if set(per_step) != {8} or \
            at_capture != [{"scale_shift_act": 8 * MEGA_K}] or \
            cap_launches != want or \
            cap_replays["scale_shift_act"] != 8 * MEGA_K * n_disp or \
            stats["capture_failures"] or \
            not all(np.isfinite(held["eager 1"][0] + losses)):
        fail(f"phase 30: scale_shift_act launches a step {set(per_step)}, "
             f"at capture {at_capture}, captured dispatches launched "
             f"{cap_launches} and replayed {cap_replays}, cache_stats "
             f"{stats}, losses {held['eager 1'][0]} / {losses}: want 8 a "
             f"forward, {8 * MEGA_K} recorded, finite")
    e_med, c_med = float(np.median(eager_ms)), float(np.median(cap_ms))
    log(f"phase 30 fine-tune B={YOLO_BATCH}, Adam 1e-4 (deterministic "
        f"cuDNN): losses {', '.join(f'{v:.5f}' for v in held['eager 1'][0])}"
        f"; eager step ms median {e_med:.2f} (min {min(eager_ms):.2f}, max "
        f"{max(eager_ms):.2f}), captured K={MEGA_K} step ms "
        f"{', '.join(f'{v:.2f}' for v in cap_ms)} (capture {capture_s:.2f} "
        f"s); {8} scale_shift_act launches a forward, {at_capture} at "
        f"capture; frozen params and updater state bit-equal, every head "
        f"param moved [{smi}]")

    # the helper: the frozen prefix once a batch, then the head alone
    helper = TransferLearningHelper(net, frozen_until=frozen_until)
    t0 = time.perf_counter()
    feats = []
    for k in range(TRANSFER_FEATURIZE):
        xb = torch.from_numpy(rng.standard_normal(
            (YOLO_BATCH, 3, 416, 416), dtype=np.float32)).to(dev)
        yb = torch.from_numpy(yolo_labels(rng, YOLO_BATCH,
                                          TRANSFER_CLASSES)).to(dev)
        feats.append(helper.featurize(DataSet(xb, yb)))
    torch.cuda.synchronize()
    feat_s = time.perf_counter() - t0
    shape = tuple(feats[0].features.shape)
    head0 = snapshot(head_t)
    t0 = time.perf_counter()
    helper.fitFeaturized(feats, epochs=1)
    head_loss = net.score(DataSet(x, y))
    fit_s = time.perf_counter() - t0
    frozen_held("fitFeaturized")
    if any(torch.equal(a, b) for a, b in zip(head_t, head0)):
        fail("phase 30: fitFeaturized left a head param where it was")
    if shape != (YOLO_BATCH, 1024, 13, 13) or not np.isfinite(head_loss):
        fail(f"phase 30 featurize: {shape}, head loss {head_loss}")
    if not all(torch.equal(a, b) for a, b in zip(
            [t for d in src._params for t in d.values()], src0)):
        fail("phase 30: the source TinyYOLO's params changed")
    log(f"phase 30 TransferLearningHelper: featurized {TRANSFER_FEATURIZE} "
        f"batches of {YOLO_BATCH} to {list(shape)} in {feat_s:.2f} s; "
        f"fitFeaturized (the head alone, one epoch of them) in {fit_s:.2f} "
        f"s, then the whole net's score on the first batch "
        f"{head_loss:.5f}; the source TinyYOLO's params untouched; phase 30 "
        f"{time.perf_counter() - t_phase:.1f} s [{smi}]")
    return at_capture[0]["scale_shift_act"]


def samediff_layer(smi: str) -> None:
    """Phase 31: the gated dense SameDiffLayer in a MultiLayerNetwork,
    eager and captured."""
    import torch

    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.nn import compilecache as cc
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                    NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.train import stepping
    from deeplearning4j_tpu_torch.train.updaters import Adam

    class GatedDense(L.SameDiffLayer):
        """y = sigmoid(x Wg) * tanh(x W)"""

        def defineParameters(self):
            return {"W": (self.nIn, self.nOut), "Wg": (self.nIn, self.nOut)}

        def defineLayer(self, sd, layerInput, paramTable, mask=None):
            h = layerInput.mmul(paramTable["W"]).tanh()
            g = layerInput.mmul(paramTable["Wg"]).sigmoid()
            return h * g

    dev = torch.device("cuda")
    E, B, n_cls = SDL_WIDTH, SDL_BATCH, 10
    net = MultiLayerNetwork(
        NeuralNetConfiguration.Builder().seed(9).updater(Adam(5e-3))
        .weightInit("xavier").list()
        .layer(GatedDense(nOut=E))
        .layer(L.OutputLayer(nOut=n_cls, lossFunction="mcxent",
                             activation="softmax"))
        .setInputType(InputType.feedForward(E)).build()).init()
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((B, E), dtype=np.float32)
                         ).to(dev)
    y = torch.from_numpy(np.eye(n_cls, dtype=np.float32)[
        rng.integers(0, n_cls, B)]).to(dev)
    ds = DataSet(x, y)
    net._ensure_opt_state()
    net._ensure_clock()
    names = [f"{n}.{p}" for n, ps in net._items(net._params) for p in ps]
    names += [f"{n}.{p}.{m}" for n, ps in net._items(net._opt_state)
              for p, st in ps.items() for m in st]
    names.append("t")
    s0 = snapshot(net._dispatch_state())
    held, eager_ms = {}, []
    for run in ("eager 1", "eager 2"):
        restore(net._dispatch_state(), s0)
        net._iteration = 0
        losses = []
        for _ in range(MEGA_K):
            t0 = time.perf_counter()
            net.fit(ds)
            losses.append(net.score())
            eager_ms.append((time.perf_counter() - t0) * 1e3)
        held[run] = (losses, snapshot(net._dispatch_state()))
    restore(net._dispatch_state(), s0)
    net._iteration = 0
    cc.reset_stats()
    cc.warmup(net, [(tuple(x.shape), tuple(y.shape))],
              steps_per_dispatch=MEGA_K)
    mb = stepping.stack_megabatch([ds] * MEGA_K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = net._fit_mega(mb).tolist()
    cap_ms = (time.perf_counter() - t0) * 1e3 / MEGA_K
    held["captured"] = (losses, snapshot(net._dispatch_state()))
    stats = cc.cache_stats()
    if stats["capture_failures"] or stats["memory"]["hits"] != 1 or \
            not all(np.isfinite(held["eager 1"][0] + losses)):
        fail(f"phase 31: cache_stats {stats}, losses {losses}")
    hold_captured("phase 31 SameDiffLayer", held, names, exact=True)
    log(f"phase 31 SameDiffLayer (gated dense {E}->{E}, fp32) in a "
        f"MultiLayerNetwork, B={B}, Adam 5e-3: losses "
        f"{', '.join(f'{v:.5f}' for v in held['eager 1'][0])}; eager step ms "
        f"median {float(np.median(eager_ms)):.2f}, captured K={MEGA_K} "
        f"{cap_ms:.2f} a step; captured bit-equal to eager, no capture "
        f"failure [{smi}]")


def datavec(smi: str) -> None:
    """Phase 32: DataVec feeds nets on the card: (a) a transaction table
    through a ``TransformProcess`` into an MLP, eager and captured; (b)
    the UCI control charts through the sequence reader into an LSTM; (c)
    Speech Commands-shaped WAVs through MFCC into a Conv1D net."""
    import shutil

    import torch

    from deeplearning4j_tpu_torch.data import datavec_fixtures as fx
    from deeplearning4j_tpu_torch.data import records as R
    from deeplearning4j_tpu_torch.data.audio import (AudioDataSetIterator,
                                                     WavFileRecordReader,
                                                     read_wav)
    from deeplearning4j_tpu_torch.data.dataset import (DataSet,
                                                       NormalizerStandardize)
    from deeplearning4j_tpu_torch.nn import compilecache as cc
    from deeplearning4j_tpu_torch.nn import layers as L
    from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                    NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.train.listeners import \
        ScoreIterationListener
    from deeplearning4j_tpu_torch.train.updaters import Adam
    t_phase = time.perf_counter()

    def cpu_first(conf, net, ds):
        """The first step's loss of the same net on the CPU, from the card
        net's initial parameters (the same seeded draws) and batch."""
        cpu = MultiLayerNetwork(conf).init(device="cpu")
        for a, b in zip(cpu._params, net._params):
            if any(not torch.equal(a[k], b[k].detach().cpu()) for k in a):
                fail("the CPU net's initial params differ from the card's")
        cpu.fit(DataSet(*(None if v is None else np.asarray(v)
                          for v in (ds.features, ds.labels,
                                    ds.features_mask, ds.labels_mask))))
        return cpu.score()

    def epochs(net, batches, n, k=1):
        """``n`` epochs of ``fit`` (K steps a dispatch); each epoch's
        losses and ms a step (host clock, a host read of each loss)."""
        lst = ScoreIterationListener(1 << 30, out=lambda msg: None)
        net.setListeners(lst)
        out = []
        for _ in range(n):
            lst.history = []
            t0 = time.perf_counter()
            net.fit(batches, steps_per_dispatch=k)
            ms = (time.perf_counter() - t0) * 1e3 / len(batches)
            out.append((list(lst.history), ms))
        net.setListeners()
        return out

    def checks(name, net, runs, first_cpu):
        """The path's gates over its epochs' losses."""
        losses = [v for ls, _ in runs for v in ls]
        card = all(p.is_cuda for ps in net._params for p in ps.values())
        first, last = np.mean(runs[0][0]), np.mean(runs[-1][0])
        d_cpu = abs(runs[0][0][0] - first_cpu) / abs(first_cpu)
        if not card or not np.isfinite(losses).all() or not last < first \
                or not d_cpu <= DV_CPU_TOL:
            fail(f"{name}: params on the card {card}, {len(losses)} losses "
                 f"finite {bool(np.isfinite(losses).all())}, epoch mean "
                 f"loss first {first:.6f} last {last:.6f}, first step "
                 f"{runs[0][0][0]!r} against the CPU's {first_cpu!r} "
                 f"({d_cpu:.3g} relative, bound {DV_CPU_TOL:g})")
        return first, last, d_cpu

    tmp = tempfile.mkdtemp(prefix="datavec_")
    try:
        # -------------------------------------- (a) a table into an MLP
        path = os.path.join(tmp, "transactions.csv")
        t0 = time.perf_counter()
        fx.write_transactions(path, DV_ROWS, seed=0)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        rows = list(R.CSVRecordReader().initialize(path))
        read_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tp = fx.transaction_process(R)
        out = tp.execute(rows)
        tf_s = time.perf_counter() - t0
        schema = tp.getFinalSchema()
        label = schema.getIndexOfColumn("FraudLabel")
        t0 = time.perf_counter()
        batches = list(R.RecordReaderDataSetIterator(
            R.CollectionRecordReader(out), DV_BATCH, label, 2))
        iter_s = time.perf_counter() - t0
        n_in = schema.numColumns() - 1
        kept = sum(b.features.shape[0] for b in batches)
        if kept != len(out) or not 0.7 * DV_ROWS < kept < 0.9 * DV_ROWS \
                or batches[0].features.shape != (DV_BATCH, n_in):
            fail(f"transactions: {kept} rows batched of {len(out)} kept of "
                 f"{DV_ROWS}, first batch {batches[0].features.shape}")
        host_s = read_s + tf_s + iter_s
        del rows, out
        conf = (NeuralNetConfiguration.Builder().seed(11)
                .updater(Adam(1e-3)).list()
                .layer(L.DenseLayer(nOut=DV_WIDTH, activation="relu"))
                .layer(L.DenseLayer(nOut=DV_WIDTH, activation="relu"))
                .layer(L.DenseLayer(nOut=DV_WIDTH, activation="relu"))
                .layer(L.OutputLayer(nOut=2, activation="softmax",
                                     lossFunction="mcxent"))
                .setInputType(InputType.feedForward(n_in)).build())
        net = MultiLayerNetwork(conf).init()
        first_cpu = cpu_first(conf, net, batches[0])
        names, groups = state_names(net)
        s0 = snapshot(net._dispatch_state())
        held, runs = {}, {}
        for run, k in (("eager 1", 1), ("eager 2", 1), ("captured", MEGA_K)):
            restore(net._dispatch_state(), s0)
            net._iteration = 0
            cc.reset_stats()
            runs[run] = epochs(net, batches, 1, k)[0]
            held[run] = (runs[run][0], snapshot(net._dispatch_state()))
        stats = cc.cache_stats()
        hold_captured("transactions MLP", held, names, groups)
        if stats["capture_failures"] or \
                stats["compile_seconds"]["cold_compiles"] != 1:
            fail(f"transactions K={MEGA_K} epoch: cache stats {stats}: want "
                 "one capture and no failure")
        second = epochs(net, batches, 1, MEGA_K)[0]
        first, last, d_cpu = checks("transactions MLP", net,
                                    [runs["captured"], second], first_cpu)
        cap_s = stats["compile_seconds"]["cold"]
        cap_ms = (runs["captured"][1] * len(batches) - cap_s * 1e3) \
            / len(batches)
        log(f"DataVec (a) [{smi}]: {DV_ROWS} transactions "
            f"({os.path.getsize(path) / 1e6:.1f} MB of CSV, written in "
            f"{write_s:.2f} s): read {DV_ROWS / read_s:,.0f} rows/s, "
            f"transformed {DV_ROWS / tf_s:,.0f} rows/s ({kept} kept, "
            f"{schema.numColumns()} columns), iterated {kept / iter_s:,.0f} "
            f"rows/s into {len(batches)} batches; host {host_s:.2f} s. MLP "
            f"{n_in}->{DV_WIDTH}x3->2 ({net.numParams()} params): eager "
            f"{runs['eager 1'][1]:.3f} ms a step, K={MEGA_K} "
            f"{second[1]:.3f} ms (the first K={MEGA_K} epoch "
            f"{cap_ms:.3f} ms past its {cap_s:.2f} s capture); epoch mean "
            f"loss {first:.5f} -> {last:.5f}; first step vs CPU "
            f"{d_cpu:.3g} relative")
        del net, batches

        # ----------------------------------- (b) sequences into an LSTM
        t0 = time.perf_counter()
        paths = fx.write_control_charts(os.path.join(tmp, "charts"), seed=0)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        seq = list(R.SequenceRecordReaderDataSetIterator(
            R.CSVSequenceRecordReader().initialize(paths), DV_CHART_BATCH,
            -1, len(fx.CHART_CLASSES)))
        read_s = time.perf_counter() - t0
        norm = NormalizerStandardize()
        norm.fit(np.concatenate([b.features for b in seq]))
        for b in seq:
            norm.transform(b)
        if len(seq) != 600 // DV_CHART_BATCH or seq[0].features.shape != \
                (DV_CHART_BATCH, 1, fx.CHART_LENGTH) \
                or seq[0].features_mask is not None:
            fail(f"control charts: {len(seq)} batches of "
                 f"{seq[0].features.shape}")
        conf = (NeuralNetConfiguration.Builder().seed(12)
                .updater(Adam(5e-3)).list()
                .layer(L.LSTM(nOut=10, activation="tanh"))
                .layer(L.RnnOutputLayer(nOut=len(fx.CHART_CLASSES),
                                        activation="softmax",
                                        lossFunction="mcxent"))
                .setInputType(InputType.recurrent(1, fx.CHART_LENGTH))
                .build())
        net = MultiLayerNetwork(conf).init()
        first_cpu = cpu_first(conf, net, seq[0])
        cc.reset_stats()
        runs_b = epochs(net, seq, 1) + epochs(net, seq, DV_CHART_EPOCHS - 1,
                                              MEGA_K)
        stats = cc.cache_stats()
        if stats["capture_failures"] or \
                stats["compile_seconds"]["cold_compiles"] != 1:
            fail(f"control-chart LSTM K={MEGA_K}: cache stats {stats}: want "
                 "one capture and no failure")
        first, last, d_cpu = checks("control-chart LSTM", net, runs_b,
                                    first_cpu)
        log(f"DataVec (b) [{smi}]: 600 control charts x {fx.CHART_LENGTH} "
            f"steps written in {write_s:.2f} s, read and batched in "
            f"{read_s:.2f} s ({600 * fx.CHART_LENGTH / read_s:,.0f} rows/s); "
            f"LSTM(10) {DV_CHART_EPOCHS} epochs of {len(seq)} steps, the "
            f"first eager, then K={MEGA_K} (capture "
            f"{stats['compile_seconds']['cold']:.2f} s): "
            f"{', '.join(f'{ms:.2f}' for _, ms in runs_b)} ms a step; epoch "
            f"mean loss {first:.5f} -> {last:.5f}; first step vs CPU "
            f"{d_cpu:.3g} relative")
        del net, seq

        # --------------------------------------- (c) audio into a Conv1D
        root = os.path.join(tmp, "speech")
        t0 = time.perf_counter()
        fx.write_speech_commands(root, DV_CLIPS, seed=0)
        write_s = time.perf_counter() - t0
        rr = WavFileRecordReader(feature="mfcc", n_frames=DV_CLIP_FRAMES)
        rr.initialize(root)
        t0 = time.perf_counter()
        for f in rr._files:
            read_wav(f)
        decode_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        clips = DataSet.merge(list(AudioDataSetIterator(rr, DV_CLIP_BATCH)))
        feat_s = time.perf_counter() - t0
        norm = NormalizerStandardize()
        norm.fit(clips)
        norm.transform(clips)
        clips.shuffle(seed=0)
        audio = clips.batchBy(DV_CLIP_BATCH)
        n_cls = rr.numLabels()
        if clips.features.shape != (DV_CLIPS, 13, DV_CLIP_FRAMES) or \
                n_cls != 8:
            fail(f"speech clips: features {clips.features.shape}, {n_cls} "
                 "labels")
        conf = (NeuralNetConfiguration.Builder().seed(13)
                .updater(Adam(3e-3)).list()
                .layer(L.Convolution1D(kernelSize=3, nOut=64,
                                       activation="relu",
                                       convolutionMode="same"))
                .layer(L.BatchNormalization())
                .layer(L.Convolution1D(kernelSize=3, nOut=64,
                                       activation="relu",
                                       convolutionMode="same"))
                .layer(L.BatchNormalization())
                .layer(L.GlobalPoolingLayer("avg"))
                .layer(L.OutputLayer(nOut=n_cls, activation="softmax",
                                     lossFunction="mcxent"))
                # no timesteps: with them BatchNormalization sizes its
                # params as channels x steps (a JAX package finding)
                .setInputType(InputType.recurrent(13))
                .build())
        net = MultiLayerNetwork(conf).init()
        first_cpu = cpu_first(conf, net, audio[0])
        runs_c = epochs(net, audio, DV_CLIP_EPOCHS)
        first, last, d_cpu = checks("speech Conv1D", net, runs_c, first_cpu)
        log(f"DataVec (c) [{smi}]: {DV_CLIPS} clips (1 s, 16 kHz) written "
            f"in {write_s:.2f} s; decode {decode_s:.2f} s "
            f"({DV_CLIPS / decode_s:,.0f} clips/s), decode + MFCC "
            f"{feat_s:.2f} s ({DV_CLIPS / feat_s:,.0f} clips/s, "
            f"{1e3 * feat_s / len(audio):.1f} ms a batch of "
            f"{DV_CLIP_BATCH}); Conv1D x2 + BN ({net.numParams()} params) "
            f"{DV_CLIP_EPOCHS} epochs of {len(audio)} steps: "
            f"{', '.join(f'{ms:.2f}' for _, ms in runs_c)} ms a step; epoch "
            f"mean loss {first:.5f} -> {last:.5f}; first step vs CPU "
            f"{d_cpu:.3g} relative")
        del net, clips, audio
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"DataVec: phase {time.perf_counter() - t_phase:.1f} s")


def bits_equal(a, b) -> bool:
    """``a`` and ``b`` hold the same bits (NaN payloads included)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        as_int = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        return torch.equal(a.detach().view(as_int), b.detach().view(as_int))
    return torch.equal(a, b)


def observability(smi: str) -> dict:
    """Phase 34: observability on the card. (a) NAN_PANIC names the first
    non-finite under TinyYOLO's K=4 captured steps, and the live state
    after the raise is an OFF twin's to the bit; (b) the armed gate's cost
    on ResNet-50 K=4; (c) a TBPTT window's site; (d) value ranges; (e)
    per-layer device time from torch.profiler on ResNet-50 and served
    BERT-base; (f) ``ProfilingListener`` over captured steps; (g)
    ``StatsListener`` + ``UIServer`` on LeNet-5; (h) the front door's
    fleet and SLO endpoints. Returns the ``scale_shift_act`` launches the
    sanitizer's replays and walks made (``sanitizer_launches``)."""
    import torch

    from deeplearning4j_tpu_torch import profiler as prof
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.profiler import sanitizer as san
    ck.install_platform_overrides()
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.perf_counter()
    deterministic = torch.backends.cudnn.deterministic
    # the raises are held to the bit against twins: one cuDNN algorithm
    torch.backends.cudnn.deterministic = True
    try:
        launches = obs_attribution(smi)
        obs_tbptt(smi)
        obs_ranges(smi)
        net, ds = obs_gate_cost(smi)
        obs_devicetime(smi, net, ds)
        obs_profiling_listener(smi, net, ds)
        del net, ds
        torch.cuda.empty_cache()
        obs_stats_ui(smi)
        obs_fleet(smi)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        prof.set_profiling_mode(None)
        san.track_value_ranges(False)
    log(f"observability: phase {time.perf_counter() - t_phase:.1f} s")
    return {"sanitizer_launches": launches}


def tiny_yolo_bf16():
    from deeplearning4j_tpu_torch.models import zoo
    net = zoo.TinyYOLO(num_classes=YOLO_CLASSES).init()
    net.setPrecisionPolicy("bf16")
    net.setComputeLayout("NHWC")
    net.setEpilogueFusion(True)
    return net


def obs_attribution(smi: str) -> int:
    """Phase 34 (a): a planned conv poison and a NaN batch mid-dispatch
    under TinyYOLO's K=4 captured steps; returns the sanitizer's
    ``scale_shift_act`` launches."""
    import torch

    from deeplearning4j_tpu_torch import profiler as prof
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.faults import FaultPlan
    from deeplearning4j_tpu_torch.nn.objdetect import yolo_labels
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.profiler import sanitizer as san
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (YOLO_BATCH, 3, 416, 416), dtype=np.float32)).to(dev)
    y = torch.from_numpy(yolo_labels(rng, YOLO_BATCH, YOLO_CLASSES)).to(dev)
    xnan = x.clone()
    xnan[1, 1, 100, 200] = float("nan")
    probe = tiny_yolo_bf16()
    conv = next(i for i, layer in enumerate(probe.layers)
                if i > 0 and type(layer).__name__ == "ConvolutionLayer")
    conv_name = f"{conv}:{probe.layers[conv].name}"
    del probe
    # a poison lands at a dispatch boundary (steps 1, 5, 9 under K=4):
    # planned for step 5, it is in place before that dispatch runs
    clean = [DataSet(x, y)] * (3 * MEGA_K)
    cases = (
        ("a conv's params poisoned at step 5", clean,
         lambda: {"faults": FaultPlan(nan_layer_params_at={5: conv})},
         (conv_name, "params", 5)),
        ("a NaN batch at step 7", clean[:6] + [DataSet(xnan, y)]
         + clean[:5], dict, ("<input>", "batch", 7)))
    timed, attribute = [], san._attribute

    def attribute_timed(model, token, j):
        a = ck.LAUNCHES["scale_shift_act"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return attribute(model, token, j)
        finally:
            torch.cuda.synchronize()
            timed.append((time.perf_counter() - t0,
                          ck.LAUNCHES["scale_shift_act"] - a, token.step0,
                          j, token.state.snap_step))
    from deeplearning4j_tpu_torch.profiler import flightrec
    recorder = flightrec.get_flight_recorder()
    total = 0
    for what, batches, kw, want in cases:
        net, twin = tiny_yolo_bf16(), tiny_yolo_bf16()
        if not all(bits_equal(a, b) for a, b in zip(net._dispatch_state(),
                                                    twin._dispatch_state())):
            fail("phase 34 (a): two TinyYOLO inits from one seed differ")
        timed.clear()
        san._attribute = attribute_timed
        # the crash bundle: a directory of its own, the rate limit reset,
        # the fit's spans traced
        bundle_dir = tempfile.mkdtemp(prefix="dl4j-flightrec-")
        recorder.directory = bundle_dir
        recorder._last_dump.pop("fit:NonfiniteAttributionError", None)
        prof.get_tracer().clear()
        prof.enable_tracing()
        prof.set_profiling_mode(prof.ProfilingMode.NAN_PANIC)
        try:
            net.fit(batches, steps_per_dispatch=MEGA_K, **kw())
        except san.NonfiniteAttributionError as e:
            site = (e.layer, e.op, e.step)
        else:
            fail(f"phase 34 (a) {what}: NAN_PANIC raised nothing")
        finally:
            prof.set_profiling_mode(None)
            prof.disable_tracing()
            recorder.directory = None
            san._attribute = attribute
        if site != want:
            fail(f"phase 34 (a) {what}: named {site}, want {want}")
        bundle_check(what, bundle_dir, "fit:NonfiniteAttributionError",
                     "MultiLayerNetwork", smi)
        prof.get_tracer().clear()
        twin.fit(batches[:2 * MEGA_K], steps_per_dispatch=MEGA_K, **kw())
        a, b = net._dispatch_state(), twin._dispatch_state()
        same = sum(bits_equal(u, v) for u, v in zip(a, b))
        if len(a) != len(b) or same != len(a):
            fail(f"phase 34 (a) {what}: after the raise {same} of {len(a)} "
                 "state tensors equal the OFF twin's to the bit")
        secs, n_ssa, step0, j, snap = timed[0]
        total += n_ssa
        log(f"phase 34 (a) TinyYOLO B={YOLO_BATCH} bf16 K={MEGA_K} captured, "
            f"{what}: NonfiniteAttributionError {site}; the replay rolled "
            f"{step0 + j - snap} step(s) from the snapshot of step {snap} "
            f"and walked step {step0 + j + 1} in {secs:.3f} s ({n_ssa} "
            f"scale_shift_act launches); the live state after the raise "
            f"equals an OFF twin's to the bit ({len(a)} tensors) [{smi}]")
        del net, twin
        torch.cuda.empty_cache()
    return total


def bundle_check(what: str, bundle_dir: str, reason: str, model: str,
                 smi: str) -> None:
    """Phase 34 (a): the crashed fit left exactly one flight-recorder
    bundle, named ``reason``, whose trace holds the fit's ``train:run``
    span (its ``run_id`` the trace's id) and steps stamped with it."""
    import shutil
    try:
        bundles = sorted(os.listdir(bundle_dir))
        safe = reason.replace(":", "-")
        if len(bundles) != 1 or not bundles[0].endswith("-" + safe):
            fail(f"phase 34 (a) {what}: bundles {bundles}, want one "
                 f"{reason}")
        path = os.path.join(bundle_dir, bundles[0])
        with open(os.path.join(path, "reason.txt")) as f:
            head = f.readline().strip()
        with open(os.path.join(path, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
        runs = [e for e in events if e.get("name") == "train:run"]
        run_id = runs[0]["args"].get("run_id") if len(runs) == 1 else None
        stamped = [e for e in events if e.get("name") != "train:run"
                   and e.get("args", {}).get("trace_id") == run_id]
        if head != f"reason: {reason}" or run_id is None \
                or runs[0]["args"].get("trace_id") != run_id \
                or runs[0]["args"].get("model") != model or not stamped:
            fail(f"phase 34 (a) {what}: bundle {bundles[0]} says {head!r}, "
                 f"train:run spans {runs}, {len(stamped)} spans stamped "
                 "with the run id")
        log(f"phase 34 (a) {what}: one flight-recorder bundle "
            f"{bundles[0]} ({head}); its trace holds train:run (run_id "
            f"{run_id}) and {len(stamped)} spans of that run "
            f"({sorted({e['name'] for e in stamped})}) [{smi}]")
    finally:
        shutil.rmtree(bundle_dir, ignore_errors=True)


def obs_tbptt(smi: str) -> None:
    """Phase 34 (c): a NaN in the third window of a TextGenerationLSTM
    TBPTT batch is named with that window's step."""
    from deeplearning4j_tpu_torch import profile_fit as pf
    from deeplearning4j_tpu_torch import profiler as prof
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.profiler import sanitizer as san
    W = pf.TEXT_WINDOW
    idx = pf.markov_chars(TEXT_SEED, TEXT_BATCH, pf.TEXT_LEN)
    x, y = pf.one_hot_ncw(idx[:, :-1]), pf.one_hot_ncw(idx[:, 1:])
    x[0, 5, 2 * W + 20] = float("nan")          # window 3
    net = zoo.TextGenerationLSTM().init()
    prof.set_profiling_mode(prof.ProfilingMode.NAN_PANIC)
    t0 = time.perf_counter()
    try:
        net.fitTBPTT(DataSet(x, y), W)
    except san.NonfiniteAttributionError as e:
        site = (e.layer, e.op, e.step)
    else:
        fail("phase 34 (c): NAN_PANIC raised nothing in the TBPTT windows")
    finally:
        prof.set_profiling_mode(None)
    if site != ("<input>", "batch", 3):
        fail(f"phase 34 (c): named {site}, want ('<input>', 'batch', 3)")
    log(f"phase 34 (c) TextGenerationLSTM B={TEXT_BATCH} T={pf.TEXT_LEN} "
        f"TBPTT {W}: a NaN in window 3 named {site} (kind tbptt) after "
        f"{time.perf_counter() - t0:.2f} s of windows [{smi}]")


def obs_ranges(smi: str) -> None:
    """Phase 34 (d): ``track_value_ranges`` on TinyYOLO bf16: one
    ``dl4j_tensor_absmax`` sample a layer, the proximity in (0, 1)."""
    import torch

    from deeplearning4j_tpu_torch import profiler as prof
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.objdetect import yolo_labels
    from deeplearning4j_tpu_torch.profiler import sanitizer as san
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(
        (YOLO_BATCH, 3, 416, 416), dtype=np.float32)).cuda()
    y = torch.from_numpy(yolo_labels(rng, YOLO_BATCH, YOLO_CLASSES)).cuda()
    net = tiny_yolo_bf16()
    hist = prof.get_registry().get("dl4j_tensor_absmax")

    def counts():
        return {k[1]: c.count for k, c in hist.children().items()
                if k[0] == "MultiLayerNetwork"}
    before = counts()
    san.track_value_ranges(True, every=1)
    prof.set_profiling_mode(prof.ProfilingMode.NAN_PANIC)
    try:
        net.fit(DataSet(x, y))
    finally:
        prof.set_profiling_mode(None)
        san.track_value_ranges(False)
    added = {k: v - before.get(k, 0) for k, v in counts().items()}
    want = {f"{i}:{layer.name}": 1 for i, layer in enumerate(net.layers)}
    prox = prof.get_registry().get("dl4j_overflow_proximity").value
    if added != want:
        fail(f"phase 34 (d): absmax samples {added}, want one a layer")
    if not 0.0 < prox < 1.0:
        fail(f"phase 34 (d): dl4j_overflow_proximity {prox}")
    sums = {k[1]: c.sum for k, c in hist.children().items()
            if k[0] == "MultiLayerNetwork"}
    top = ", ".join(f"{k} {sums[k]:.4g}"
                    for k in sorted(want, key=lambda k: -sums[k])[:3])
    log(f"phase 34 (d) TinyYOLO bf16 value ranges: {len(want)} layers one "
        f"sample each; largest |max| {top}; dl4j_overflow_proximity "
        f"{prox:.4g} [{smi}]")
    del net, x, y
    torch.cuda.empty_cache()


def resnet50_bf16():
    from deeplearning4j_tpu_torch.models import zoo
    net = zoo.ResNet50(num_classes=1000).init()
    net.setPrecisionPolicy("bf16")
    net.setComputeLayout("NHWC")
    net.setEpilogueFusion(True)
    return net


def obs_gate_cost(smi: str):
    """Phase 34 (b): ResNet-50 B=64 K=4 captured, ms a step over 8
    dispatches in turns OFF, NAN_PANIC, NAN_PANIC, OFF from one state,
    the losses bit-equal. Returns the net and its batch."""
    import torch

    from deeplearning4j_tpu_torch import profiler as prof
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.nn import compilecache as cc
    from deeplearning4j_tpu_torch.profiler import sanitizer as san
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (RESNET_BATCH, 3, 224, 224), dtype=np.float32)).to(dev)
    y = torch.from_numpy(np.eye(1000, dtype=np.float32)[
        rng.integers(0, 1000, RESNET_BATCH)]).to(dev)
    ds = DataSet(x, y)
    net = resnet50_bf16()
    net._ensure_step_state()
    s0 = snapshot(net._dispatch_state())
    cc.warmup(net, [(tuple(x.shape), tuple(y.shape))],
              steps_per_dispatch=MEGA_K)
    n_disp = OBS_DISPATCHES
    group = [ds] * (n_disp * MEGA_K)
    kept = []
    fit_mega = net._fit_mega

    def fit_mega_kept(mb):
        losses = fit_mega(mb)
        kept.append(losses)
        return losses
    net._fit_mega = fit_mega_kept
    runs = []
    try:
        for mode in ("OFF", "NAN_PANIC", "NAN_PANIC", "OFF"):
            restore(net._dispatch_state(), s0)
            net._iteration = 0
            san.invalidate(net)
            kept.clear()
            prof.set_profiling_mode(getattr(prof.ProfilingMode, mode))
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                net.fit(group, steps_per_dispatch=MEGA_K)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / len(group)
            finally:
                prof.set_profiling_mode(None)
            runs.append((mode, ms, torch.cat(kept).float().cpu()))
    finally:
        del net._fit_mega
    ref = runs[0][2]
    for mode, _ms, losses in runs:
        if not bits_equal(losses, ref) or not bool(torch.isfinite(
                losses).all()):
            fail(f"phase 34 (b): the {mode} losses {losses.tolist()} are not "
                 f"the OFF run's {ref.tolist()} to the bit, or not finite")
    off = [ms for mode, ms, _ in runs if mode == "OFF"]
    on = [ms for mode, ms, _ in runs if mode == "NAN_PANIC"]
    extra = np.mean(on) - np.mean(off)
    over = extra / np.mean(off)
    log(f"phase 34 (b) ResNet-50 B={RESNET_BATCH} bf16 K={MEGA_K} captured, "
        f"{n_disp} dispatches a run, turns OFF/NAN_PANIC/NAN_PANIC/OFF: ms a "
        f"step {', '.join(f'{m} {ms:.3f}' for m, ms, _ in runs)}; the armed "
        f"gate's overhead {100 * over:+.2f}% ({extra:+.3f} ms a step); "
        f"{len(ref)} losses bit-equal in all four [{smi}]")
    return net, ds


def obs_devicetime(smi: str, net, ds) -> None:
    """Phase 34 (e): ``devicetime.measure(mode="trace")`` on ResNet-50
    (B=64, bf16, NHWC, fused) and on BERT-base as served (B=32, T=128,
    bf16, flash), beside sync mode and the eager forward's CUDA-event
    time."""
    import torch

    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.profiler import devicetime

    def event_ms(fn):
        fn()
        ts = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return float(np.median(ts))

    def launches_in(table, ops, fragment):
        return sum(c for r in table.rows if r.op in ops
                   for k, c in table.launches.get(r.layer, {}).items()
                   if fragment in k)

    def launches_out(table, ops, fragment):
        return sum(c for r in table.rows if r.op not in ops
                   for k, c in table.launches.get(r.layer, {}).items()
                   if fragment in k)

    lm = TransformerLM(TransformerConfig.bert_base(use_flash_attention=True),
                       seed=0)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, lm.cfg.vocab_size, (32, 128)).astype(np.int64)).cuda()
    x = ds.features
    for name, model, feats, fwd, want_ops, counts in (
            ("ResNet-50 B=64 bf16 NHWC fused", net, x,
             lambda: net.output(x), {"conv2d", "batch_norm"},
             ((("batch_norm",), "scale_shift_act", 33),)),
            ("BERT-base B=32 T=128 bf16 flash", lm, tokens,
             lambda: lm.logits(tokens), {"attention", "layer_norm"},
             ((("attention",), "flash_fwd_kernel", 12),
              (("layer_norm",), "layer_norm_fwd_kernel", 25)))):
        fwd_ms = event_ms(fwd)
        ck.reset_counts()
        t0 = time.perf_counter()
        tr = devicetime.measure(model, feats, reps=3, mode="trace")
        trace_s = time.perf_counter() - t0
        # the wrappers' own count over the traced step's 3 forwards and
        # the profiler's warm-up step's one
        counted = {k: v / 4 for k, v in ck.LAUNCHES.items() if v}
        sy = devicetime.measure(model, feats, reps=3, mode="sync")
        missing = [r.layer for r in tr.rows if r.op in want_ops
                   and not r.seconds > 0]
        want_rows = {r.layer for r in sy.rows if r.op in want_ops}
        have = {r.layer for r in tr.rows if r.op in want_ops
                and r.seconds > 0}
        if missing or want_rows - have:
            fail(f"phase 34 (e) {name}: no device time for "
                 f"{sorted(set(missing) | (want_rows - have))[:8]}")
        seen = []
        for ops, frag, n in counts:
            got_in = launches_in(tr, ops, frag)
            got_out = launches_out(tr, ops, frag)
            seen.append(f"{got_in:g} {frag} in {'/'.join(ops)} scopes")
            if got_in != n or got_out:
                fail(f"phase 34 (e) {name}: {got_in} {frag} launches a "
                     f"forward in {ops} scopes and {got_out} elsewhere, "
                     f"want {n} and 0 (the wrappers counted {counted} a "
                     f"forward)")
        total_ms = tr.total_seconds * 1e3
        if total_ms > fwd_ms:
            fail(f"phase 34 (e) {name}: the rows sum to {total_ms:.3f} ms, "
                 f"above the eager forward's {fwd_ms:.3f} ms")
        by_op = {}
        for r in sorted(tr.rows, key=lambda r: r.op):
            by_op[r.op] = by_op.get(r.op, 0.0) + r.seconds * 1e3
        by_op = {k: round(v, 3) for k, v in sorted(by_op.items(),
                                                   key=lambda kv: -kv[1])}
        sync = {r.layer: r.seconds * 1e3 for r in sy.rows}
        top = tr.top_offenders(5)
        log(f"phase 34 (e) {name}: {len(tr.rows)} rows, device {total_ms:.3f} "
            f"ms of an eager forward of {fwd_ms:.3f} ms (CUDA events; the "
            f"trace took {trace_s:.2f} s); by op "
            f"{by_op}; a forward: {', '.join(seen)} [{smi}]")
        log(f"phase 34 (e) {name} top offenders (MFU against "
            f"{tr.peak_flops / 1e12:.0f} TFLOP/s): " + "; ".join(
                f"{o['layer']} ({o['op']}) {o['device_ms']} ms trace / "
                f"{sync.get(o['layer'], float('nan')):.4f} ms sync, MFU "
                f"{o['mfu']}" for o in top))
        log(f"phase 34 (e) {name} trace vs sync, ms a layer: total "
            f"{total_ms:.3f} / {sy.total_seconds * 1e3:.3f}; median row "
            f"{1e3 * float(np.median([r.seconds for r in tr.rows])):.4f} / "
            f"{1e3 * float(np.median([r.seconds for r in sy.rows])):.4f}")
    del lm, tokens
    torch.cuda.empty_cache()


def obs_profiling_listener(smi: str, net, ds) -> None:
    """Phase 34 (f): ``ProfilingListener`` over three captured ResNet-50
    iterations (one captured step a dispatch) writes a Chrome trace that
    parses as JSON; which kernel events it holds under replay."""
    import torch

    from deeplearning4j_tpu_torch.nn import compilecache as cc
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.train.listeners import ProfilingListener
    cc.warmup(net, [(tuple(ds.features.shape), tuple(ds.labels.shape))])
    with tempfile.TemporaryDirectory() as d:
        pl = ProfilingListener(d, start_iter=2, n_iters=3)
        net.setListeners(pl)
        ck.reset_counts()
        try:
            net.fit([ds] * 5)
        finally:
            net.setListeners()
        replays = ck.REPLAYS["scale_shift_act"]
        if ck.LAUNCHES["scale_shift_act"] or replays != 5 * 33:
            fail(f"phase 34 (f): {dict(ck.LAUNCHES)} launched, "
                 f"{dict(ck.REPLAYS)} replayed: want 5 replays of 33")
        if not pl.trace_path or not os.path.isfile(pl.trace_path):
            fail("phase 34 (f): ProfilingListener wrote no trace")
        size = os.path.getsize(pl.trace_path)
        with open(pl.trace_path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    names = {}
    for e in kernels:
        names[e["name"]] = names.get(e["name"], 0) + 1
    graph_launches = sum(1 for e in events
                         if "cudaGraphLaunch" in str(e.get("name", "")))
    scopes = sum(1 for e in events
                 if str(e.get("name", "")).startswith("dl4j_L"))
    ssa = sum(c for k, c in names.items() if "scale_shift_act" in k)
    top = sorted(names.items(), key=lambda kv: -kv[1])[:4]
    log(f"phase 34 (f) ProfilingListener over 3 captured ResNet-50 "
        f"iterations: {size / 1e6:.1f} MB Chrome trace, {len(events)} "
        f"events; under replay it holds {len(kernels)} kernel events "
        f"({len(names)} names, {ssa} scale_shift_act; most: "
        f"{'; '.join(f'{n[:60]} x{c}' for n, c in top)}), "
        f"{graph_launches} cudaGraphLaunch events and {scopes} dl4j_L "
        f"scopes [{smi}]")
    torch.cuda.synchronize()


def obs_stats_ui(smi: str) -> None:
    """Phase 34 (g): LeNet-5 (phase 16's data) with a ``StatsListener``
    into ``InMemoryStatsStorage`` at frequency 1, served by a
    ``UIServer``; ms a step with and without the listener."""
    import urllib.request

    import torch

    from deeplearning4j_tpu_torch.data.iterators import MnistDataSetIterator
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.train.listeners import StatsListener
    from deeplearning4j_tpu_torch.ui import InMemoryStatsStorage, UIServer
    train = MnistDataSetIterator(64, True, num_examples=2048)
    net = zoo.LeNet(num_classes=10).init()
    net.fit(train)                       # warm
    steps = -(-train.data.numExamples() // 64)

    def epoch_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        net.fit(train)
        net.score()
        return (time.perf_counter() - t0) * 1e3 / steps
    bare = epoch_ms()
    st = InMemoryStatsStorage()
    net.setListeners(StatsListener(st, frequency=1, session_id="lenet"))
    with_stats = epoch_ms()
    net.setListeners()
    bare2 = epoch_ms()
    ups = st.getAllUpdates("lenet")
    if len(ups) != steps or not all(np.isfinite(u["score"]) for u in ups):
        fail(f"phase 34 (g): {len(ups)} StatsListener records for {steps} "
             "steps, or a score not finite")
    server = UIServer(port=0).attach(st)
    codes = {}
    try:
        for path in ("api/sessions", "api/overview?session=lenet",
                     "api/model?session=lenet", "metrics", "trace"):
            with urllib.request.urlopen(server.url + path, timeout=30) as r:
                codes[path] = r.status
                body = r.read()
            if path.startswith("api/"):
                json.loads(body)
    finally:
        server.stop()
    if set(codes.values()) != {200}:
        fail(f"phase 34 (g): UIServer answered {codes}")
    leaf = ups[-1]["layers"]
    log(f"phase 34 (g) LeNet-5 B=64 fp32, {steps} eager steps an epoch: "
        f"{bare:.3f} / {bare2:.3f} ms a step without StatsListener, "
        f"{with_stats:.3f} with it (frequency 1, {len(leaf)} leaves a "
        f"record, update_ratio of {next(iter(leaf))} "
        f"{leaf[next(iter(leaf))]['update_ratio']:.3g}); UIServer "
        f"{codes} [{smi}]")


def obs_fleet(smi: str) -> None:
    """Phase 34 (h): phase 15's front door (BERT-base v1 behind
    ``HttpIngress`` + ``ModelRegistry``) with a ``MetricsAggregator`` fed by
    a ``FleetScraper`` from the ingress's /metrics and a ``UIServer``'s,
    and an ``SLOGate`` (p99 under 250 ms, availability 0.99) over a short
    ``ServingLoad.seeded`` replay at 150 requests/s."""
    import urllib.request

    import torch

    from deeplearning4j_tpu_torch import profiler as prof
    from deeplearning4j_tpu_torch.faults import ServingLoad
    from deeplearning4j_tpu_torch.models.transformer import (
        TransformerConfig, TransformerLM)
    from deeplearning4j_tpu_torch.serving import HttpIngress, ModelRegistry
    from deeplearning4j_tpu_torch.ui import UIServer
    cfg = TransformerConfig.bert_base(use_flash_attention=True)
    lm = TransformerLM(cfg, seed=0)
    T = 128
    reg = ModelRegistry(batch_limit=32, head="argmax", input_dtype=np.int32)
    agg = prof.MetricsAggregator(max_age=120.0)
    gate = prof.SLOGate(prof.SLOEngine([prof.SLOSpec(
        "serve", objective=0.99, latency_bound=0.25, availability=0.99)]))
    ingress = ui_server = None
    try:
        reg.load("bert", lm.logits, shapes=[(T,)])
        ingress = HttpIngress(reg, port=0, fleet=agg, slo=gate).start()
        ui_server = UIServer(port=0).attach_serving(reg.server("bert"))
        scraper = prof.FleetScraper(agg, lambda: {
            "ingress": ingress.url, "ui": ui_server.url.rstrip("/")})
        gate()                           # the window's first sample
        load = ServingLoad.seeded(seed=34, mix="steady", n=300, rps=150,
                                  max_rows=8)
        for spec in load.specs:
            spec.deadline = 5.0

        def tokens(rng, spec):
            return rng.randint(0, cfg.vocab_size, (spec.rows, T)).astype(
                np.int32)
        res = load.replay_http(ingress.url, "bert", (T,), make=tokens)
        codes = [o[0] if isinstance(o, tuple) else o for _, o in res]
        if codes.count(200) != len(res):
            fail(f"phase 34 (h): {len(res) - codes.count(200)} of "
                 f"{len(res)} requests not answered 200")
        scraped = scraper.scrape_once()
        if scraped != {"ingress": True, "ui": True}:
            fail(f"phase 34 (h): scrape {scraped}")
        answers = {}
        for path in ("/v1/fleet/metrics", "/v1/fleet/load", "/v1/slo"):
            with urllib.request.urlopen(ingress.url + path,
                                        timeout=30) as r:
                answers[path] = (r.status, r.read().decode())
        if {c for c, _ in answers.values()} != {200}:
            fail(f"phase 34 (h): {[(p, c) for p, (c, _) in answers.items()]}")
        text = answers["/v1/fleet/metrics"][1]
        if "dl4j_fleet_members 2" not in text or 'host="ingress"' not in \
                text or 'host="ui"' not in text:
            fail("phase 34 (h): /v1/fleet/metrics does not merge both hosts")
        fleet_load = json.loads(answers["/v1/fleet/load"][1])
        verdict = json.loads(answers["/v1/slo"][1])
        win = verdict["specs"]["serve"]["windows"]
        wire = sorted(s for s in load.wire_seconds if s is not None)
        log(f"phase 34 (h) front door: {len(res)} requests at 150/s, all "
            f"200 (wire p99 {1e3 * float(np.percentile(wire, 99)):.2f} ms); "
            f"fleet p99 {agg.quantile('dl4j_serving_latency_seconds', 0.99)}"
            f" s over {agg.hosts()}; /v1/fleet/load hosts "
            f"{sorted(fleet_load['hosts'])} (the UIServer serves no "
            f"/v1/load); SLO passing {verdict['passing']}, burn rates fast "
            f"{win['fast']['burn']:.4g} {win['fast']['criteria']}, slow "
            f"{win['slow']['burn']:.4g} [{smi}]")
    finally:
        if ingress is not None:
            ingress.stop()
        if ui_server is not None:
            ui_server.stop()
        reg.close()
    del lm
    torch.cuda.empty_cache()


#: phase 36 (a): a SameDiff MLP [B, 1024] + N(0, 1) noise -> 4096 relu
#: -> dropout 0.5 -> 10, Adam 1e-3, captured
RNG_BATCH, RNG_IN, RNG_HIDDEN, RNG_STEPS = 64, 1024, 4096, 6
#: phase 36 (b): ResNet-50 bf16/NHWC/fused, B=64, K=4, 8 steps, in two
#: fresh interpreters over one disk tier
DISK_TIER_STEPS = 8
#: phase 36 (c): the tune CLI on ResNet-50 at B=64, 224^2
TUNE_ARGV = ("resnet50", "--batch", "64", "--classes", "1000", "--budget",
             "8", "--reps", "2", "--steps", "8", "--max-k", "4", "--cost",
             "h100-sxm")

_DISK_CHILD = r"""
import json, sys, time, warnings
root, cache_dir, steps, k = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    int(sys.argv[4])
sys.path.insert(0, root)
import numpy as np
import torch
from deeplearning4j_tpu_torch.data.dataset import DataSet
from deeplearning4j_tpu_torch.models import zoo
from deeplearning4j_tpu_torch.nn import compilecache as cc
from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
ck.build()
ck.install_platform_overrides()
cc.configure(cache_dir)
net = zoo.ResNet50(num_classes=1000).init()
net.setPrecisionPolicy("bf16")
net.setComputeLayout("NHWC")
net.setEpilogueFusion(True)
rng = np.random.default_rng(0)
x = torch.from_numpy(rng.standard_normal((64, 3, 224, 224),
                                         dtype=np.float32)).cuda()
y = torch.from_numpy(np.eye(1000, dtype=np.float32)[
    rng.integers(0, 1000, 64)]).cuda()
cc.reset_stats()
ck.reset_counts()
t0 = time.perf_counter()
net.fit([DataSet(x, y)] * steps, steps_per_dispatch=k)
loss = float(net.score())
fit_s = time.perf_counter() - t0
print(json.dumps({"stats": cc.cache_stats(), "loss": loss, "fit_s": fit_s,
                  "at_capture": net._step_for(False, k)
                  .launches_at_capture(),
                  "manifest": len(cc.read_manifest(net) or [])}))
"""


def samediff_rng(smi: str) -> None:
    """Phase 36 (a): a SameDiff MLP with ``nn.dropout(0.5)`` and a
    ``random.normal`` node, fit through the captured dispatch. Probes
    wrapped around ``dropout_mask`` and ``normal_draw`` copy each step's
    hidden mask and the noise's moments into tensors of their own inside
    the graph, so every replay leaves its draws there: the masks keep
    0.5 +- 0.01 and change from step to step, the noise keeps N(0, 1)
    within 0.01, and a refit from the saved state (clock included) draws
    the same masks, step for step."""
    import torch

    from deeplearning4j_tpu_torch.autodiff import SameDiff, TrainingConfig
    from deeplearning4j_tpu_torch.nn import compilecache as cc
    from deeplearning4j_tpu_torch.ops import normalization as norm_ops
    from deeplearning4j_tpu_torch.train.updaters import Adam
    dev = torch.device("cuda")
    B, D, H = RNG_BATCH, RNG_IN, RNG_HIDDEN
    mask_probe = torch.zeros((B, H), dtype=torch.bool, device=dev)
    noise_probe = torch.zeros(2, device=dev)
    mask_fn, normal_fn = norm_ops.dropout_mask, norm_ops.normal_draw

    def probed_mask(key, shape, keep, device):
        m = mask_fn(key, shape, keep, device)
        if tuple(shape) == (B, H):
            mask_probe.copy_(m)
        return m

    def probed_normal(key, shape, device):
        z = normal_fn(key, shape, device)
        noise_probe.copy_(torch.stack([z.mean(), z.std()]))
        return z

    norm_ops.dropout_mask, norm_ops.normal_draw = probed_mask, probed_normal
    try:
        rng = np.random.default_rng(3)
        sd = SameDiff.create()
        x = sd.placeHolder("x", shape=(None, D))
        y = sd.placeHolder("y", shape=(None, 10))
        w1 = sd.var("w1", (rng.standard_normal((D, H)) / np.sqrt(D))
                    .astype(np.float32))
        b1 = sd.var("b1", np.zeros(H, np.float32))
        w2 = sd.var("w2", (rng.standard_normal((H, 10)) / np.sqrt(H))
                    .astype(np.float32))
        b2 = sd.var("b2", np.zeros(10, np.float32))
        noisy = x + sd.random.normal(0.0, 1.0, (B, D), name="noise")
        h = sd.nn.dropout(sd.nn.relu(sd.nn.linear(noisy, w1, b1)), 0.5)
        loss = sd.loss.softmaxCrossEntropy(y, sd.nn.linear(h, w2, b2),
                                           name="loss")
        sd.setLossVariables(loss)
        sd.setTrainingConfig(TrainingConfig(
            updater=Adam(1e-3), data_set_feature_mapping=["x"],
            data_set_label_mapping=["y"]))
        batch = {"x": torch.from_numpy(rng.standard_normal(
                     (B, D)).astype(np.float32)).to(dev),
                 "y": torch.from_numpy(np.eye(10, dtype=np.float32)[
                     rng.integers(0, 10, B)]).to(dev)}
        sd._prepare_fit()
        s0 = snapshot(sd._fit_state())

        def run():
            masks, noise, losses = [], [], []
            for _ in range(RNG_STEPS):
                losses += sd.fit([batch]).lossCurve()
                masks.append(mask_probe.clone())
                noise.append(noise_probe.tolist())
            return masks, noise, losses
        cc.reset_stats()
        masks, noise, losses = run()
        restore(sd._fit_state(), s0)
        sd._step = 0
        again, noise2, losses2 = run()
        stats = cc.cache_stats()
    finally:
        norm_ops.dropout_mask, norm_ops.normal_draw = mask_fn, normal_fn
    keeps = [float(m.float().mean()) for m in masks]
    changed = all(not torch.equal(a, b) for a, b in zip(masks, masks[1:]))
    same = all(torch.equal(a, b) for a, b in zip(masks, again))
    log(f"SameDiff RNG under capture: keep fractions "
        f"{', '.join(f'{v:.4f}' for v in keeps)}; noise mean/std "
        f"{'; '.join(f'{m:.4f}/{sdv:.4f}' for m, sdv in noise)}; masks "
        f"change every step: {changed}; a refit from the saved state "
        f"draws the same masks: {same}, losses equal: {losses == losses2}"
        f"; captures {[d.captures() for d in sd.fit_dispatches()]}, "
        f"failures {stats['capture_failures']} [{smi}]")
    if stats["capture_failures"] or [d.captures() for d in
                                     sd.fit_dispatches()] != [1]:
        fail(f"phase 36 (a): the RNG graph did not capture once: {stats}")
    if not all(abs(k - 0.5) <= 0.01 for k in keeps) or not changed \
            or not same or losses != losses2 or noise != noise2:
        fail("phase 36 (a): dropout masks under capture: keep 0.5 +- 0.01, "
             "a new mask each step, the same masks from the same state")
    if not all(abs(m) <= 0.01 and abs(sdv - 1.0) <= 0.01
               for m, sdv in noise) or len({tuple(v) for v in noise}) \
            != RNG_STEPS or not all(np.isfinite(losses)):
        fail(f"phase 36 (a): random.normal draws {noise}: want N(0, 1) "
             "within 0.01, new each step, finite losses")


def disk_tier(smi: str) -> int:
    """Phase 36 (b): two fresh interpreters fit ResNet-50 (bf16, NHWC,
    fused, B=64, K=4, 8 steps) over one disk tier. The first writes the
    manifest (one disk miss); the second captures the manifest's
    signature at warm start (4 x 33 ``scale_shift_act`` launches
    recorded), misses nothing in memory during its fit, and counts one
    disk hit a manifest entry. Then, in this process, the manifest is
    corrupted: it is quarantined and a fresh net still fits (captured
    cold, the manifest rewritten); W112 fires without a directory and is
    silent with one. Returns the launches the warm start recorded."""
    import shutil
    import warnings

    import torch

    from deeplearning4j_tpu_torch.analysis import lint_compile_cache
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.nn import compilecache as cc
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="dl4j_disk_tier_")
    try:
        cache = os.path.join(tmp, "cache")
        script = os.path.join(tmp, "child.py")
        with open(script, "w") as f:
            f.write(_DISK_CHILD)
        runs = []
        for n in (1, 2):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, script, root, cache, str(DISK_TIER_STEPS),
                 str(MEGA_K)], capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                fail(f"phase 36 (b): child {n} exited {proc.returncode}: "
                     f"{proc.stderr[-2000:]}")
            out = json.loads(proc.stdout.strip().splitlines()[-1])
            out["wall_s"] = time.perf_counter() - t0
            runs.append(out)
            log(f"disk tier, process {n}: {out['wall_s']:.1f} s (fit "
                f"{out['fit_s']:.2f} s), loss {out['loss']:.5f}, manifest "
                f"entries {out['manifest']}, launches at capture "
                f"{out['at_capture']}, cache_stats {out['stats']} [{smi}]")
        first, second = runs
        want = [{"scale_shift_act": MEGA_K * 33}]
        if first["stats"]["disk"]["misses"] != 1 \
                or first["stats"]["disk"]["hits"] or first["manifest"] != 1:
            fail(f"phase 36 (b): the first process wrote {first}")
        s2 = second["stats"]
        if second["at_capture"] != want or s2["memory"]["misses"] \
                or s2["disk"]["hits"] != second["manifest"] \
                or s2["disk"]["misses"] \
                or s2["compile_seconds"]["cold_compiles"] \
                or not np.isfinite(second["loss"]):
            fail(f"phase 36 (b): the second process {second}: want the "
                 f"manifest's signature captured at warm start ({want}), "
                 "one disk hit an entry, no miss")
        # a corrupted entry: quarantined, and the fit still runs
        entries = [n for n in os.listdir(cache) if n.startswith("cc_")]
        with open(os.path.join(cache, entries[0]), "r+b") as f:
            f.seek(-4, os.SEEK_END)
            f.write(b"zzzz")
        cc.configure(cache)
        net = resnet50_bf16()
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal(
            (64, 3, 224, 224), dtype=np.float32)).cuda()
        y = torch.from_numpy(np.eye(1000, dtype=np.float32)[
            rng.integers(0, 1000, 64)]).cuda()
        cc.reset_stats()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            net.fit([DataSet(x, y)] * DISK_TIER_STEPS,
                    steps_per_dispatch=MEGA_K)
        loss = float(net.score())
        st = cc.cache_stats()
        quarantined = [n for n in os.listdir(cache)
                       if n.startswith("quarantine_")]
        if not any("quarantined" in str(w.message) for w in caught) \
                or len(quarantined) != 1 or st["disk"]["hits"] \
                or st["disk"]["misses"] != 1 or not np.isfinite(loss) \
                or cc.read_manifest(net) is None:
            fail(f"phase 36 (b): a corrupted manifest: quarantined "
                 f"{quarantined}, stats {st}, loss {loss}")
        cc.configure(None)
        without = [d.code for d in lint_compile_cache()]
        cc.configure(cache)
        with_dir = [d.code for d in lint_compile_cache()]
        log(f"disk tier, corrupted manifest: quarantined {quarantined}, "
            f"the fit captured cold (loss {loss:.5f}, {st['disk']}); W112 "
            f"without a directory {without}, with one {with_dir} [{smi}]")
        if without != ["DL4J-W112"] or with_dir:
            fail("phase 36 (b): W112 must fire without a cache directory "
                 "and stay silent with a writable one")
        del net, x, y
        return second["at_capture"][0]["scale_shift_act"]
    finally:
        cc.reset_configuration()
        shutil.rmtree(tmp, ignore_errors=True)


def tune_resnet(smi: str) -> int:
    """Phase 36 (c): ``python -m deeplearning4j_tpu_torch.tune`` on
    ResNet-50 (B=64, 224^2, 1000 classes) through its ``main(argv)``:
    budget 8, 2 reps of 8 steps, K up to 4, the H100 cost model pruning.
    The CLI prints each trial's plan and ms a step, the pruned plans with
    their reasons, the winner's speed-up over the fp32 NCHW default and
    the parity verdict. Then a fresh ResNet-50's ``fit(tune="auto")``
    applies the recorded plan; a fused winner's ``scale_shift_act``
    launches are counted (at its capture for K > 1; 33 a step in NHWC,
    none in NCHW, whose epilogues take the generic op). Returns them."""
    import contextlib
    import io
    import shutil

    import torch

    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.models import zoo
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.tune import records
    from deeplearning4j_tpu_torch.tune.__main__ import main as tune_main
    tmp = tempfile.mkdtemp(prefix="dl4j_tune_")
    try:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = tune_main(list(TUNE_ARGV) + ["--dir", tmp])
        tune_s = time.perf_counter() - t0
        lines = buf.getvalue().splitlines()
        for line in lines:
            log(f"tune: {line}")
        # every trial times its plan's captured step: one whose capture
        # failed is a failed trial
        failed = [line for line in lines if " FAILED " in line]
        fresh = zoo.ResNet50(seed=11, num_classes=1000).init()
        rec = records.lookup(fresh)
        if rc != 0 or rec is None or rec.trials != 8 or failed:
            fail(f"phase 36 (c): the tune CLI returned {rc}, record {rec}, "
                 f"failed trials {failed}")
        plan = rec.plan
        rng = np.random.default_rng(0)
        x = torch.from_numpy(rng.standard_normal(
            (64, 3, 224, 224), dtype=np.float32)).cuda()
        y = torch.from_numpy(np.eye(1000, dtype=np.float32)[
            rng.integers(0, 1000, 64)]).cuda()
        ck.reset_counts()
        fresh.fit([DataSet(x, y)] * 8, tune="auto")
        k = plan.steps_per_dispatch
        applied = (fresh._compute_layout, fresh._fuse_epilogues,
                   fresh._precision is not None)
        want = (plan.compute_layout, plan.fuse_epilogues,
                plan.precision is not None)
        if k > 1:
            at = fresh._step_for(False, k).launches_at_capture()
            launches = sum(a.get("scale_shift_act", 0) for a in at)
        else:
            launches = ck.LAUNCHES["scale_shift_act"]
        loss = float(fresh.score())
        # the kernel takes channels-last epilogues: fused NCHW blocks take
        # the generic op (the JAX Pallas gate's rule)
        per = 33 * (k if k > 1 else 8) if plan.fuse_epilogues \
            and plan.compute_layout == "NHWC" else 0
        log(f"tune: {tune_s:.1f} s; winner {plan.signature()} "
            f"({rec.speedup:.3f}x the default's "
            f"{rec.default_cost_s * 1e3:.2f} ms a step, "
            f"{rec.cost_s * 1e3:.2f} ms); a fresh net's fit(tune=\"auto\") "
            f"applied layout/fusion/policy {applied}, K={k}, loss "
            f"{loss:.5f}, scale_shift_act launches {launches} [{smi}]")
        if applied != want or not np.isfinite(loss) \
                or launches != per:
            fail(f"phase 36 (c): fit(tune='auto') applied {applied}, "
                 f"{launches} launches: want {plan.signature()}")
        del fresh, x, y
        return launches
    finally:
        records.reset_configuration()
        shutil.rmtree(tmp, ignore_errors=True)


def strict_warmup(smi: str) -> None:
    """Phase 36 (d): ``ModelServer.warmup(shapes, strict=True,
    cost="h100-sxm")`` on the SameDiff BERT-base of phase 6 (full width,
    served through ``samediff_forward``, which the cost model prices as
    its graph; a ``TransformerLM``'s forward is not lowered by it) passes;
    the same warmup on a chip of 1 MB of memory raises E121 or E122."""
    import torch

    from deeplearning4j_tpu_torch.analysis.diagnostics import \
        ModelValidationError
    from deeplearning4j_tpu_torch.autodiff import SameDiff
    from deeplearning4j_tpu_torch.serving import (ModelServer,
                                                  samediff_forward)
    sd = build_bert(SameDiff.create(), **BERT_SD)
    server = ModelServer(samediff_forward(sd, ["probs"],
                                          input_name="input_ids"),
                         batch_limit=8, input_dtype=np.int32)
    try:
        t0 = time.perf_counter()
        server.warmup([(BERT_SD["T"],)], strict=True, cost="h100-sxm")
        ok_s = time.perf_counter() - t0
        tiny = {"chip": {"name": "h100-1mb", "peak_flops": 989e12,
                         "hbm_gb": 1.0 / 1024, "hbm_gbps": 3350.0,
                         "ici_gbps": 450.0}}
        try:
            server.warmup([(BERT_SD["T"],)], strict=True, cost=tiny)
            raised = None
        except ModelValidationError as e:
            raised = sorted({d.code for d in e.report.errors()})
        log(f"strict warmup: h100-sxm passed ({server.buckets()} x "
            f"T={BERT_SD['T']}, {ok_s:.2f} s, "
            f"{server._dispatch.warmed_signatures()} graphs); a 1 MB chip "
            f"raised {raised} [{smi}]")
        if not raised or not {"DL4J-E121", "DL4J-E122"} & set(raised):
            fail(f"phase 36 (d): warmup(strict=True) on a 1 MB chip raised "
                 f"{raised}: want E121 or E122")
    finally:
        server.close()
    del sd
    torch.cuda.empty_cache()


def rng_disk_tune(smi: str) -> dict:
    """Phase 36: (a) SameDiff RNG under capture, (b) the disk tier across
    processes, (c) tune on ResNet-50, (d) strict serving warmup."""
    import torch
    t0 = time.perf_counter()
    samediff_rng(smi)
    torch.cuda.empty_cache()
    disk = disk_tier(smi)
    torch.cuda.empty_cache()
    tuned = tune_resnet(smi)
    torch.cuda.empty_cache()
    strict_warmup(smi)
    log(f"phase 36 {time.perf_counter() - t0:.1f} s")
    return {"disk_warm_launches": disk, "tune_launches": tuned}


def plain_overrides(registry, ck) -> None:
    """Register the layer-norm and flash kernels' plain PyTorch versions
    in the kernels' place."""
    registry.register_platform_override(
        "layer_norm", lambda x, g, b=None, *, axis=-1, eps=1e-5:
        ck.layer_norm_plain(x, g, b, eps))
    registry.register_platform_override(
        "flash_attention", lambda q, k, v, *, mask=None, is_causal=False,
        block_size=512: ck.flash_attention_plain(q, k, v, is_causal)[0])


def serve_burst(server, reqs):
    """Submit ``reqs`` from four threads, 2 ms apart in each, with the
    launch counters set to 0 just before; wait for every answer. Returns
    (handles, answers, wall s, launches, plain calls, forwards)."""
    import torch

    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    handles = [None] * len(reqs)
    errors = []
    batches0 = server.stats()["batches"]

    def client(idx):
        try:
            for i in idx:
                handles[i] = server.submit(reqs[i])
                time.sleep(0.002)
        except Exception as e:     # reported below, fails the run
            errors.append(e)

    ck.reset_counts()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client,
                                args=(range(j, len(reqs), 4),))
               for j in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    if errors or any(t.is_alive() for t in threads):
        fail(f"client threads failed: {errors}")
    served = [h.get(300) for h in handles]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (handles, served, wall, dict(ck.LAUNCHES), dict(ck.PLAIN_CALLS),
            server.stats()["batches"] - batches0)


def log_latency(handles, reqs, wall: float, smi: str) -> dict:
    lat = sorted(h.resolved_at - h.enqueued_at for h in handles)
    tokens = sum(int(r.size) for r in reqs)
    out = {"p50_ms": 1e3 * float(np.percentile(lat, 50)),
           "p99_ms": 1e3 * float(np.percentile(lat, 99)),
           "tokens_per_s": tokens / wall}
    log(f"latency p50 {out['p50_ms']:.2f} ms, p99 {out['p99_ms']:.2f} ms, "
        f"{out['tokens_per_s']:.1f} tokens/s ({tokens} tokens in "
        f"{wall:.3f} s) [{smi}]")
    return out


def build_bert(sd, dtype=np.float32, *, V, E, H, L, F, T, max_len,
               n_labels, eps=1e-12, seed=0):
    """A BERT sequence classifier (post-LN, tanh gelu, tanh pooler)
    written op by op in SameDiff, as an imported BERT graph runs (a copy
    of the builder in tests/test_torch_samediff.py). Placeholders
    ``input_ids`` [None, T] and ``labels`` [None], int32; outputs
    ``probs`` [B, n_labels] and ``loss``. Activations stay on the 2-D
    [B*T, E] view, so every layer norm and the attention softmax (on
    [B*H*T, T]) take 2-D inputs. Weights N(0, 0.02), biases 0, LN gains
    1, from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    D = E // H

    def w(name, *shape):
        return sd.var(name, (rng.standard_normal(shape) * 0.02)
                      .astype(dtype))

    def zeros(name, n):
        return sd.var(name, np.zeros(n, dtype))

    def ln(x, name):
        # BERT's eps through the registry op: SDNN.layerNorm has no eps
        return sd.math.layer_norm(x, sd.var(name + "_g", np.ones(E, dtype)),
                                  zeros(name + "_b", E), eps=eps)

    def linear(x, name, n_in, n_out):
        return sd.nn.linear(x, w(name + "_w", n_in, n_out),
                            zeros(name + "_b", n_out))

    ids = sd.placeHolder("input_ids", shape=(None, T), dtype=np.int32)
    labels = sd.placeHolder("labels", shape=(None,), dtype=np.int32)
    tok = sd.math.gather(w("tok_emb", V, E), ids, axis=0)       # [B, T, E]
    pos = sd.math.gather(w("pos_emb", max_len, E),
                         np.arange(T, dtype=np.int32), axis=0)  # [T, E]
    typ = sd.math.gather(w("type_emb", 2, E),
                         np.zeros(T, np.int32), axis=0)         # [T, E]
    h = ln((tok + pos + typ).reshape(-1, E), "emb_ln")          # [B*T, E]
    for i in range(L):
        p = f"l{i}_"

        def heads(x):
            return x.reshape(-1, T, H, D).transpose(0, 2, 1, 3)  # [B,H,T,D]
        q = heads(linear(h, p + "q", E, E))
        k = heads(linear(h, p + "k", E, E))
        v = heads(linear(h, p + "v", E, E))
        s = q.mmul(k, transpose_b=True) * float(1.0 / np.sqrt(D))
        a = sd.nn.softmax(s.reshape(-1, T)).reshape(-1, H, T, T)
        ctx = a.mmul(v).transpose(0, 2, 1, 3).reshape(-1, E)
        h = ln(h + linear(ctx, p + "o", E, E), p + "ln1")
        ff = linear(sd.nn.gelu(linear(h, p + "ff1", E, F)), p + "ff2", F, E)
        h = ln(h + ff, p + "ln2")
    cls = h.reshape(-1, T, E).get((slice(None), 0))             # [B, E]
    pooled = sd.nn.tanh(linear(cls, "pool", E, E))
    logits = linear(pooled, "cls", E, n_labels)
    sd.nn.softmax(logits, name="probs")
    sd.loss.sparseSoftmaxCrossEntropy(labels, logits, name="loss")
    sd.setLossVariables("loss")
    return sd


#: phase 35: the kernels through the new surface, at phase 2's shapes
SURF_SOFTMAX = (49152, 128)                 # Transforms.softmax, fp32
SURF_LN = (16384, 768)                      # exec_op("layer_norm"), fp32
SURF_SSA = (802816, 64)                     # exec_op("scale_shift_act"), bf16
SURF_FLASH = (32, 512, 12, 64)              # exec_op("flash_attention"), bf16
#: phase 35 (b): bench.py's GemmBench at full size, through NDArray.mmul
GEMM_N, GEMM_ITERS = 16384, 30
#: phase 35 (f): rounds of on/off/off/on eager ResNet-50 forwards, and of
#: steps
CONV_CHECK_FORWARDS, CONV_CHECK_STEPS = 12, 4


def _card_vs_cpu(case, out, cpu, V):
    """A case's outputs on the card against the same case on the CPU, at
    the case's own tolerance (TF32 off: cuBLAS, cuDNN and cuSOLVER stay
    inside it); decompositions by what they reconstruct. Returns the max
    |difference|."""
    got = V.leaves(V.to_host(out))
    want = V.leaves(V.to_host(cpu))
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} outputs on the card, "
                             f"{len(want)} on the CPU")
    if case.op in ("qr", "svd", "eigh", "lu"):
        args = case.args(np.random.RandomState(0))
        V._check_structure(case.op, args, out)
        if case.op in ("svd", "eigh"):       # the spectra are unique
            idx = 1 if case.op == "svd" else 0
            got, want = [got[idx]], [want[idx]]
        else:
            return 0.0
    err = 0.0
    for g, w in zip(got, want):
        g, w = np.asarray(g, np.float64), np.asarray(w, np.float64)
        if g.shape != w.shape:
            raise AssertionError(f"shape {g.shape} on the card, {w.shape} "
                                 f"on the CPU")
        np.testing.assert_allclose(g, w, rtol=case.rtol, atol=case.atol)
        if g.size:
            err = max(err, float(np.max(np.abs(g - w))))
    return err


def op_surface(smi: str) -> dict:
    """Phase 35: the op surface on the card. (a) every OpCase of
    ``ops.validation`` with its args on ``cuda`` (golden, finite outputs
    all on the card, random statistics, the float64 gradcheck on the
    card) and held to the same case on the CPU; (b) bench.py's GemmBench
    through ``NDArray.mmul``; (c) the softmax, layer-norm,
    scale_shift_act and flash kernels through ``Transforms.softmax`` and
    ``exec_op`` at full width, one launch each, against their plain
    versions; (d) ``exec_op`` under NAN_PANIC, and OFF against BASIC per
    call; (e) ``shapes.infer_shape`` over every case with no card memory
    and no kernel. Returns the launches of (c)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from deeplearning4j_tpu_torch import profiler as prof
    from deeplearning4j_tpu_torch.linalg import DataType, Transforms, nd
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.ops import registry, shapes
    from deeplearning4j_tpu_torch.ops import validation as V
    from deeplearning4j_tpu_torch.utils.environment import NumericsPanicError
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    # fp32 convolutions and GEMMs in fp32, as on the CPU (main() sets
    # both too; the phase also runs alone)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ck.install_platform_overrides()

    # (a) every case on the card
    cases = V.all_cases()
    failures, ops_run, worst = [], set(), []
    n_grad = sum(c.grad for c in cases)
    ck.reset_counts()
    t0 = time.perf_counter()
    for case in cases:
        try:
            out = V.run_case(case, device=dev)
            if case.op not in V.RANDOM_OPS:
                cpu = V.call(case, case.args(np.random.RandomState(0)),
                             "cpu")
                worst.append((_card_vs_cpu(case, out, cpu, V), case.op))
            ops_run.add(case.op)
        except Exception as e:          # every failure listed, then fail
            failures.append(f"{case.op}: {type(e).__name__}: "
                            f"{' '.join(str(e).split())[:300]}")
    torch.cuda.synchronize()
    case_s = time.perf_counter() - t0
    case_launches = {k: v for k, v in ck.LAUNCHES.items() if v}
    for f in failures:
        log(f"op surface FAIL {f}")
    if failures:
        fail(f"op surface: {len(failures)} of {len(cases)} cases failed "
             f"on the card")
    if len(cases) != 514 or len(ops_run) != 505:
        fail(f"op surface: {len(cases)} cases over {len(ops_run)} ops, "
             "want 514 over 505")
    worst.sort(reverse=True)
    log(f"op surface (a): {len(cases)} cases passed on cuda over "
        f"{len(ops_run)} ops ({n_grad} float64 gradchecks on the card), "
        f"{case_s:.1f} s; kernel launches {case_launches}; largest "
        f"card-vs-CPU differences "
        + ", ".join(f"{op} {e:.3g}" for e, op in worst[:6]) + f" [{smi}]")

    # (b) GemmBench through NDArray.mmul
    n, iters = GEMM_N, GEMM_ITERS
    g = torch.Generator(device=dev).manual_seed(0)
    a = nd.create(torch.randn(n, n, generator=g, device=dev),
                  dtype=DataType.BFLOAT16, device=dev)
    # b scaled by 1/sqrt(n): the chain's values stay of order one
    b = nd.create(torch.randn(n, n, generator=g, device=dev) / n ** 0.5,
                  dtype=DataType.BFLOAT16, device=dev)

    def chain():
        c = a
        for _ in range(iters):
            c = c.mmul(b)
        return c

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(3):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn()
            e1.record()
            e1.synchronize()
            ts.append(e0.elapsed_time(e1))
        return float(np.median(ts)), out

    gemm_ms, c = timed(chain)
    if not bool(torch.isfinite(c.tensor()).all()):
        fail("GemmBench: non-finite values in the chained product")
    at, bt = a.tensor(), b.tensor()

    def torch_chain():
        x = at
        for _ in range(iters):
            x = torch.matmul(x, bt)
        return x

    lib_ms, _ = timed(torch_chain)
    tflops = iters * 2.0 * n ** 3 / (gemm_ms / 1e3) / 1e12
    log(f"op surface (b): GemmBench through NDArray.mmul, bf16 n={n}, "
        f"{iters} chained: {gemm_ms:.2f} ms, {tflops:.1f} TFLOP/s = "
        f"{tflops / (BF16_FLOPS / 1e12):.3f} of the {BF16_FLOPS / 1e12:.0f} "
        f"TFLOP/s dense bf16 peak (torch.matmul chain {lib_ms:.2f} ms) "
        f"[{smi}]")
    del a, b, c, at, bt
    torch.cuda.empty_cache()

    # (c) the kernels through the new surface, one launch each
    launched = {}

    def once(kernel, fn):
        torch.cuda.synchronize()
        ck.reset_counts()
        out = fn()
        torch.cuda.synchronize()
        if ck.LAUNCHES[kernel] != 1 or sum(ck.LAUNCHES.values()) != 1:
            fail(f"op surface: {kernel} launches {ck.LAUNCHES}, want one")
        launched[kernel] = ck.LAUNCHES[kernel]
        return out

    def close(name, got, want, rtol, atol):
        err = (got.float() - want.float()).abs()
        bad = err > atol + rtol * want.float().abs()
        if bool(bad.any()):
            fail(f"op surface {name}: {int(bad.sum())} element(s) beyond "
                 f"rtol={rtol:g} atol={atol:g}, max |err| "
                 f"{err.max().item():.3g}")
        return float(err.max().item())

    x = torch.randn(SURF_SOFTMAX, generator=g, device=dev) * 4.0
    y = once("softmax", lambda: Transforms.softmax(nd.create(
        x, device=dev))).tensor()
    e_sm = close("Transforms.softmax", y, ck.softmax_plain(x), 1e-5, 1e-6)
    rows, width = SURF_LN
    x = torch.randn(SURF_LN, generator=g, device=dev) * 2.0 + 0.5
    gain = torch.randn(width, generator=g, device=dev) * 0.5 + 1.0
    bias = torch.randn(width, generator=g, device=dev) * 0.1
    y = once("layer_norm", lambda: registry.exec_op("layer_norm", x, gain,
                                                    bias))
    e_ln = close("exec_op layer_norm", y,
                 ck.layer_norm_plain(x, gain, bias, 1e-5), 2e-5, 2e-5)
    rows, ch = SURF_SSA
    x = torch.randn(SURF_SSA, generator=g, device=dev).to(torch.bfloat16)
    sc = torch.randn(ch, generator=g, device=dev).to(torch.bfloat16)
    sh = torch.randn(ch, generator=g, device=dev).to(torch.bfloat16)
    y = once("scale_shift_act", lambda: registry.exec_op(
        "scale_shift_act", x, sc, sh, alpha=0.0, axis=-1))
    want = ck.scale_shift_act_plain(x, sc, sh, 0.0)
    ulp = torch.ldexp(torch.ones_like(want.float()),
                      torch.frexp(want.float())[1] - 8)
    err = (y.float() - want.float()).abs()
    if bool((err > ulp.masked_fill(want == 0, 0)).any()):
        fail(f"op surface exec_op scale_shift_act: beyond one bf16 ulp, max "
             f"|err| {err.max().item():.3g}")
    e_ssa = float(err.max().item())
    q, k, v = (torch.randn(SURF_FLASH, generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    y = once("flash_attention", lambda: registry.exec_op(
        "flash_attention", q, k, v))
    e_fa = close("exec_op flash_attention", y,
                 ck.flash_attention_plain(q, k, v, False)[0], 2e-2, 2e-2)
    log(f"op surface (c): Transforms.softmax {list(SURF_SOFTMAX)} fp32 "
        f"(max|err| {e_sm:.3g}), exec_op layer_norm {list(SURF_LN)} fp32 "
        f"({e_ln:.3g}), scale_shift_act {list(SURF_SSA)} bf16 relu "
        f"({e_ssa:.3g}), flash_attention {list(SURF_FLASH)} bf16 "
        f"({e_fa:.3g}): one kernel launch each")
    del x, y, q, k, v, want, ulp, err

    # (d) exec_op's profiling modes
    prof.set_profiling_mode(prof.ProfilingMode.NAN_PANIC)
    try:
        for op, arg in (("log", torch.tensor([-1.0], device=dev)),
                        ("softmax", torch.tensor([[0.0, float("nan")]],
                                                 device=dev))):
            try:
                registry.exec_op(op, arg)
            except NumericsPanicError as e:
                if f"op '{op}'" not in str(e):
                    fail(f"NAN_PANIC raised without naming '{op}': {e}")
            else:
                fail(f"exec_op('{op}') under NAN_PANIC did not raise")
    finally:
        prof.set_profiling_mode(None)
    small = torch.ones(16, device=dev)

    def per_call_us(fn, n_calls=5000):
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(5):
            t = time.perf_counter()
            for _ in range(n_calls):
                fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) / n_calls * 1e6)
        return float(np.median(ts))

    instrumented = registry._exec_instrumented
    n_instr = {"OFF": 0, "BASIC": 0}

    def counting(mode_name):
        def call(*a, **k):
            n_instr[mode_name] += 1
            return instrumented(*a, **k)
        return call

    bare_us = per_call_us(lambda: torch.add(small, small))
    registry._exec_instrumented = counting("OFF")
    try:
        off_us = per_call_us(lambda: registry.exec_op("add", small, small))
        prof.set_profiling_mode(prof.ProfilingMode.BASIC)
        registry._exec_instrumented = counting("BASIC")
        basic_us = per_call_us(lambda: registry.exec_op("add", small, small))
    finally:
        prof.set_profiling_mode(None)
        registry._exec_instrumented = instrumented
    if n_instr["OFF"] or not n_instr["BASIC"]:
        fail(f"exec_op reached the instrumented dispatch {n_instr['OFF']} "
             f"times under OFF and {n_instr['BASIC']} under BASIC: want "
             "none under OFF, every call under BASIC")
    if off_us - bare_us >= (basic_us - bare_us) / 2:
        fail(f"exec_op under OFF costs {off_us:.2f} us a call, BASIC "
             f"{basic_us:.2f}, torch.add itself {bare_us:.2f}: OFF's extra "
             "is not under half of BASIC's")
    log(f"op surface (d): NAN_PANIC raised naming 'log' and 'softmax'; "
        f"exec_op('add') on 16 floats: {off_us:.2f} us a call OFF, "
        f"{basic_us:.2f} us BASIC, torch.add {bare_us:.2f} us "
        f"(host clock); instrumented dispatches OFF {n_instr['OFF']}, "
        f"BASIC {n_instr['BASIC']} [{smi}]")

    # (e) infer_shape: meta tensors only, no card memory, no kernel
    class Devices(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    self.seen.add(t.device.type)
            return out

    todo = []
    for case in cases:
        args = case.args(np.random.RandomState(0))
        if args and all(isinstance(a, np.ndarray) for a in args):
            todo.append((case, [a.shape for a in args]))
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    ck.reset_counts()
    rec, answered = Devices(), 0
    t0 = time.perf_counter()
    with rec:
        for case, shp in todo:
            try:
                shapes.infer_shape(case.op, *shp, **case.kwargs)
                answered += 1
            except Exception:   # data-dependent shapes do not answer
                pass
    infer_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    if torch.cuda.memory_allocated() != mem0:
        fail("infer_shape allocated card memory")
    if rec.seen - {"meta"}:
        fail(f"infer_shape made tensors on {sorted(rec.seen - {'meta'})}")
    if any(ck.LAUNCHES.values()):
        fail(f"infer_shape launched kernels: {ck.LAUNCHES}")
    log(f"op surface (e): infer_shape answered {answered} of {len(todo)} "
        f"cases on meta tensors in {infer_s * 1e3:.0f} ms, card memory "
        f"unchanged, no kernel launched")
    conv_contract_cost(smi)
    log(f"op surface: phase {time.perf_counter() - t_phase:.1f} s")
    return launched


def conv_contract_cost(smi: str) -> None:
    """Phase 35 (f): what the conv ops' shape contract costs the eager
    path. ResNet-50 B=64 bf16 NHWC fused: ms an eager ``output()`` and an
    eager ``fit`` step, in turns with the contract as shipped (counted)
    and stubbed out, on/off/off/on; then µs a check, cached and
    uncached."""
    import torch

    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.ops import convolution as conv
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (RESNET_BATCH, 3, 224, 224), dtype=np.float32)).to(dev)
    y = torch.from_numpy(np.eye(1000, dtype=np.float32)[
        rng.integers(0, 1000, RESNET_BATCH)]).to(dev)
    ds = DataSet(x, y)
    net = resnet50_bf16()
    net.fit(ds)
    net.output(x)
    shipped = conv._check_call
    checks = [0]

    def counted(*a, **k):
        checks[0] += 1
        return shipped(*a, **k)

    def stub(*a, **k):
        return None

    # the contract on and stubbed out alternate call by call (on, off,
    # off, on), so the host's drift over seconds falls on both alike
    times = {("on", "fwd"): [], ("off", "fwd"): [], ("on", "step"): [],
             ("off", "step"): []}
    per_fwd = set()

    def timed(turn, what, fn):
        conv._check_call = counted if turn == "on" else stub
        checks[0] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times[(turn, what)].append((time.perf_counter() - t0) * 1e3)
        if turn == "on" and what == "fwd":
            per_fwd.add(checks[0])

    try:
        for _ in range(CONV_CHECK_FORWARDS):
            for turn in ("on", "off", "off", "on"):
                timed(turn, "fwd", lambda: net.output(x))
        for _ in range(CONV_CHECK_STEPS):
            for turn in ("on", "off", "off", "on"):
                timed(turn, "step", lambda: (net.fit(ds), net.score()))
    finally:
        conv._check_call = shipped
    if len(per_fwd) != 1 or 0 in per_fwd:
        fail(f"phase 35 (f): checks a forward {sorted(per_fwd)}: want the "
             "same non-zero count in each forward")
    if not np.isfinite(net.score()):
        fail(f"phase 35 (f): ResNet-50 loss {net.score()} is not finite")

    def spread(v):
        q1, q2, q3 = np.percentile(v, [25, 50, 75])
        return f"{q2:.3f} [{q1:.3f}-{q3:.3f}]"

    d_fwd = np.median(times[("on", "fwd")]) - np.median(times[("off", "fwd")])
    d_step = np.median(times[("on", "step")]) \
        - np.median(times[("off", "step")])
    # ResNet-50's first 3x3 conv of stage 2, NHWC, on meta tensors
    xm = torch.empty((RESNET_BATCH, 56, 56, 64), device="meta")
    wm = torch.empty((64, 64, 3, 3), device="meta")
    kw = dict(stride=(1, 1), pad=(1, 1), dilation=(1, 1), mode="truncate",
              data_format="NHWC", groups=1)
    n = 20000
    shipped("conv2d", xm, wm, **kw)
    t0 = time.perf_counter()
    for _ in range(n):
        shipped("conv2d", xm, wm, **kw)
    cached_us = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for _ in range(n):
        conv._CHECKED.clear()
        shipped("conv2d", xm, wm, **kw)
    uncached_us = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for _ in range(n):
        stub("conv2d", xm, wm, **kw)
    stub_us = (time.perf_counter() - t0) / n * 1e6
    log(f"op surface (f): the conv contract on ResNet-50 B={RESNET_BATCH} "
        f"bf16 NHWC eager, {min(per_fwd)} checks a forward; ms median "
        f"[quartiles] a forward on {spread(times[('on', 'fwd')])}, off "
        f"{spread(times[('off', 'fwd')])} ({len(times[('on', 'fwd')])} "
        f"each), a step on {spread(times[('on', 'step')])}, off "
        f"{spread(times[('off', 'step')])} ({len(times[('on', 'step')])} "
        f"each); median on - off: forward {d_fwd:+.3f} ms, step "
        f"{d_step:+.3f} ms; a "
        f"check {cached_us:.2f} us cached, {uncached_us:.2f} us uncached, "
        f"{stub_us:.2f} us stubbed (host clock) [{smi}]")


def lifecycle_storm(smi: str) -> dict:
    """Phase 37: continuous training on the card. BERT-base (pre-LN,
    bf16, flash) v1 served captured from a ``ModelRegistry`` whose
    servers record every request into a ``TrafficCapture``; one thread
    submits a steady 150 requests/s (1-8 rows of 128 tokens) for the
    whole phase; a BertBench-shaped step (B=64, T=128, Adam at LC_LR) from
    v1's parameters, captured once before the traffic, trains 4 steps a
    round and hands the driver a snapshot; the eval gate scores each
    candidate in parity mode on 64 captured rows. The plan kills the
    trainer (a sleep subprocess, SIGKILLed) at roll 2, poisons round 3's
    candidate with NaN and reads roll 4's confirmation as an SLO
    regression; a second driver over the same state directory resumes.
    Returns the flash and layer-norm launches and replays of the phase
    (``lifecycle_launches``, ``lifecycle_replays``)."""
    import collections
    import shutil
    import weakref

    import torch

    from deeplearning4j_tpu_torch import profiler as prof
    from deeplearning4j_tpu_torch.faults import FaultPlan, ServingLoad
    from deeplearning4j_tpu_torch.lifecycle import (EvalGate,
                                                    LifecycleDriver,
                                                    TrafficCapture,
                                                    TrainerKilledError,
                                                    spawn_trainer_process)
    from deeplearning4j_tpu_torch.models import transformer as tfm
    from deeplearning4j_tpu_torch.nn import compilecache as cc
    from deeplearning4j_tpu_torch.ops import cuda_kernels as ck
    from deeplearning4j_tpu_torch.profile_fit import BertBench
    from deeplearning4j_tpu_torch.serving import ModelRegistry, ServingError
    from deeplearning4j_tpu_torch.serving.server import ModelServer
    from deeplearning4j_tpu_torch.train.resilience import DriverStateStore
    from deeplearning4j_tpu_torch.train.updaters import Adam
    ck.install_platform_overrides()
    t_phase = time.perf_counter()
    T, dev = LC_SEQ, torch.device("cuda")
    per_fwd = {"flash_attention": 12, "layer_norm": 25}
    cfg = tfm.TransformerConfig.bert_base(dtype=torch.bfloat16,
                                          use_flash_attention=True)
    gc.collect()
    torch.cuda.synchronize()
    tmp = tempfile.mkdtemp(prefix="dl4j-lifecycle-")
    cap_path = os.path.join(tmp, "traffic.jsonl")
    state_dir = os.path.join(tmp, "driver")
    traffic_capture = TrafficCapture(cap_path, sample_rate=1.0,
                                     max_records=LC_REQUESTS)
    reg = ModelRegistry(batch_limit=32, head="argmax", input_dtype=np.int32,
                        capture=traffic_capture)
    proc = spawn_trainer_process()
    stop = threading.Event()
    ends = collections.defaultdict(list)    # server -> its batch ends
    dispatch_batch = ModelServer._dispatch_batch

    def dispatch_timed(self, batch):
        try:
            return dispatch_batch(self, batch)
        finally:
            ends[self.name].append(time.perf_counter())
    ModelServer._dispatch_batch = dispatch_timed
    try:
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        v1 = tfm.TransformerLM(cfg, seed=0)
        torch.cuda.synchronize()
        weights_b = torch.cuda.memory_allocated() - mem0
        t0 = time.perf_counter()
        reg.load("bert", v1, shapes=[(T,)])
        torch.cuda.synchronize()
        footprint = torch.cuda.memory_allocated() - mem0
        log(f"lifecycle: v1 BERT-base bf16 loaded and captured in "
            f"{time.perf_counter() - t0:.2f} s; a version holds "
            f"{footprint / 1e9:.3f} GB allocated: weights "
            f"{weights_b / 1e9:.3f}, its load {(footprint - weights_b) / 1e9:.3f}")

        # what the traffic capture costs a submit, on v1's server: 200
        # submits with it and 200 without, in turns, each answered (into a
        # file of their own: the eval set comes from the steady traffic)
        srv = reg.server("bert", 1)
        timed_capture = TrafficCapture(os.path.join(tmp, "submit.jsonl"))
        rng = np.random.RandomState(1)
        us = {True: [], False: []}
        for i in range(2 * LC_SUBMIT_SAMPLES):
            on = i % 2 == 0
            srv._traffic_capture = timed_capture if on else None
            x = rng.randint(0, cfg.vocab_size, (1, T)).astype(np.int32)
            t0 = time.perf_counter_ns()
            h = srv.submit(x)
            us[on].append((time.perf_counter_ns() - t0) / 1e3)
            h.get(60)
        srv._traffic_capture = traffic_capture
        sub_on, sub_off = (float(np.median(us[k])) for k in (True, False))
        log(f"lifecycle: submit {sub_on:.1f} us with the traffic capture "
            f"on, {sub_off:.1f} us off (median of {LC_SUBMIT_SAMPLES} "
            f"each, one server, 1 x {T} tokens, host clock) [{smi}]")

        # the record alone, on the same file system
        rec_us = []
        for i in range(LC_SUBMIT_SAMPLES):
            x = rng.randint(0, cfg.vocab_size, (1, T)).astype(np.int32)
            t0 = time.perf_counter_ns()
            timed_capture.record(x)
            rec_us.append((time.perf_counter_ns() - t0) / 1e3)
        log(f"lifecycle: TrafficCapture.record of 1 x {T} tokens "
            f"{float(np.median(rec_us)):.1f} us alone (median of "
            f"{LC_SUBMIT_SAMPLES}, host clock) [{smi}]")

        # the trainer: BertBench's step shape (B=64, T=128) from v1's
        # parameters at the fine-tuning rate, captured once
        bench = BertBench()
        bench.train_step = tfm.make_train_step(cfg, Adam(LC_LR))
        bench.opt = tfm.init_opt_state(bench.params, Adam(LC_LR))
        with torch.no_grad():
            for a, b in zip(cc.state_tensors(bench.params),
                            cc.state_tensors(v1.params)):
                a.copy_(b)
        del v1          # the registry holds it until v1 is retired
        disp = bench.captured()
        args = (bench.tokens, bench.targets, bench.mask)
        disp.warm(*args)
        train_losses = []

        def trainer(r):
            t0 = time.perf_counter()
            for _ in range(LC_STEPS):
                loss = disp(*args)
            train_losses.append(float(loss))
            snap = tfm.TransformerLM(cfg, params=tfm.copy_params(
                bench.params))
            split[r]["train"] += time.perf_counter() - t0
            return snap

        # the traffic: one thread, the whole phase
        load = ServingLoad.seeded(seed=0, mix="steady", n=LC_REQUESTS,
                                  rps=150, max_rows=8)
        for spec in load.specs:
            spec.deadline = 10.0

        def tokens(rng, spec):
            return rng.randint(0, cfg.vocab_size, (spec.rows, T)).astype(
                np.int32)
        out = {}
        replay = threading.Thread(target=lambda: out.setdefault(
            "res", load.replay(lambda x, deadline=None: reg.submit(
                "bert", x, deadline=deadline), (T,), make=tokens,
                stop=stop)))
        hits0 = cc.cache_stats()["memory"]["hits"]
        ck.reset_counts()
        replay.start()
        while traffic_capture.captured < 32 and replay.is_alive():
            time.sleep(0.05)
        eval_x = TrafficCapture.eval_features(cap_path, max_rows=64)
        log(f"lifecycle: eval set {eval_x.shape} from the captured traffic")

        weights = {1: weakref.ref(reg.server("bert", 1).model)}
        # v1 is the incumbent the driver starts from
        DriverStateStore(state_dir).save({
            "round": 0, "phase": "idle", "in_round": None, "roll_index": 0,
            "incumbent": 1, "candidate_version": None, "quarantined": [],
            "promotions": 0, "rollbacks": 0})
        plan = FaultPlan(trainer_death_at_roll=2, bad_candidate_at={3: "nan"},
                         slo_regression_during_canary=4)
        split = collections.defaultdict(collections.Counter)
        loads, verdicts = [], {}

        def driver():
            d = LifecycleDriver(reg, "bert", trainer, state_dir,
                                eval_x=eval_x, shapes=[(T,)], gate=EvalGate(),
                                observe_ticks=2, confirm_ticks=2,
                                tick_interval=LC_TICK_S, faults=plan,
                                trainer_process=proc)
            gate, load_v, evaluate = d._gate, d._load, d.gate.evaluate

            def gate_timed(r, cand):
                t0 = time.perf_counter()
                try:
                    return gate(r, cand)
                finally:
                    split[r]["gate"] += time.perf_counter() - t0

            def evaluate_kept(cand, inc, x, y=None):
                v = evaluate(cand, inc, x, y)
                verdicts[len(verdicts) + 1] = v
                log(f"lifecycle gate {len(verdicts)}: {v!r}, parity_rel "
                    f"{v.detail.get('parity_rel')}, rows "
                    f"{v.detail.get('rows')}")
                return v

            def load_timed(r, cand):
                inc = reg.active_version("bert")
                t0 = time.perf_counter()
                try:
                    v = load_v(r, cand)
                    weights[v] = weakref.ref(cand)
                    return v
                finally:
                    t1 = time.perf_counter()
                    split[r]["load"] += t1 - t0
                    loads.append((r, inc, t0, t1))
            d._gate, d._load, d.gate.evaluate = (gate_timed, load_timed,
                                                 evaluate_kept)
            return d

        spent = {}      # a retired version's counts, read before it goes

        def retire_spent():
            """Retire what is neither served, nor the rollback target,
            nor the canary: its graphs and weights are freed."""
            m = reg.models()["bert"]
            keep = {m["active"], m["previous"], m["canary"]}
            for v, info in m["versions"].items():
                if v not in keep and not info["retired"]:
                    sv = reg.server("bert", v)
                    spent[v] = (sv.recompiles_after_warmup(),
                                sv.captures_after_warmup())
                    reg.retire("bert", v, timeout=60)

        mem, reserved, round_s, summary = {}, {}, {}, None
        alive = {}

        def run_round(d, r):
            t0 = time.perf_counter()
            try:
                return d.run(r)
            finally:
                round_s[r] = round_s.get(r, 0.0) + time.perf_counter() - t0
                retire_spent()
                gc.collect()
                alive[r] = sorted(v for v, w in weights.items()
                                  if w() is not None)
                torch.cuda.synchronize()
                mem[r] = torch.cuda.memory_allocated()
                reserved[r] = torch.cuda.memory_reserved()

        drv = driver()
        run_round(drv, 1)
        try:
            run_round(drv, 2)
        except TrainerKilledError as e:
            killed = e
        else:
            fail("phase 37: the trainer did not die at roll 2")
        if proc.poll() is None or proc.returncode != -9:
            fail(f"phase 37: the trainer process is not SIGKILLed "
                 f"({proc.returncode})")
        active_at_death = reg.active_version("bert")
        drv2 = driver()
        if not drv2.resumed:
            fail("phase 37: the second driver did not resume")
        run_round(drv2, 2)
        run_round(drv2, 3)
        probe = np.random.RandomState(99).randint(
            0, cfg.vocab_size, (8, T)).astype(np.int32)
        probe_t = torch.from_numpy(probe).to(dev)
        pre_ids = reg.output("bert", probe)
        pre_v = reg.active_version("bert")
        v3 = reg.server("bert", pre_v).model
        # host copies: the evidence must not weigh on the card's memory
        pre_logits = v3.logits(probe_t).cpu()
        pre_params = [p.detach().cpu() for p in v3.parameters()]
        run_round(drv2, 4)
        post_v = reg.active_version("bert")
        post_ids = reg.output("bert", probe)
        post_logits = reg.server("bert", post_v).model.logits(probe_t).cpu()
        same_params = all(bits_equal(a, b.detach().cpu()) for a, b in zip(
            pre_params, v3.parameters()))
        del v3, pre_params
        summary = run_round(drv2, 5)
        stop.set()
        replay.join(120)
        if replay.is_alive():
            fail("phase 37: the traffic thread did not stop")
        res = out["res"]
        lat, errors, resolved = [], [], True
        for _spec, h in res:
            if isinstance(h, Exception):
                errors.append(h)
                continue
            try:
                h.get(60)
                lat.append(h.resolved_at - h.enqueued_at)
            except Exception as e:
                errors.append(e)
            resolved &= h.resolutions == 1
        torch.cuda.synchronize()
        hits = cc.cache_stats()["memory"]["hits"] - hits0
        launches = {k: ck.LAUNCHES[k] for k in per_fwd}
        replays = {k: ck.REPLAYS[k] for k in per_fwd}
        plain = dict(ck.PLAIN_CALLS)
        ModelServer._dispatch_batch = dispatch_batch

        # ------------------------------------------------- printed first
        for r in sorted(round_s):
            s = split[r]
            log(f"lifecycle round {r}: {round_s[r]:.2f} s = train "
                f"{s['train']:.2f} + gate {s['gate']:.2f} + load and "
                f"capture {s['load']:.2f} + canary and confirm "
                f"{round_s[r] - s['train'] - s['gate'] - s['load']:.2f}; "
                f"after it (spent versions retired; models alive "
                f"{alive[r]}) memory_allocated "
                f"{mem[r] / 1e9:.3f} GB, memory_reserved "
                f"{reserved[r] / 1e9:.3f} GB [{smi}]")
        reg_m = prof.get_registry()
        for name in ("dl4j_lifecycle_gate_seconds",
                     "dl4j_lifecycle_roll_seconds"):
            h = reg_m.get(name)
            log(f"{name}: count {h.count}, sum {h.sum:.4f} s, mean "
                f"{h.sum / max(h.count, 1) * 1e3:.2f} ms")
        lat_ms = np.asarray(lat) * 1e3
        log(f"lifecycle: {len(res)} requests over {load.specs[len(res) - 1].at:.1f} s "
            f"offered at 150/s, latency p50 {np.percentile(lat_ms, 50):.2f} "
            f"ms, p99 {np.percentile(lat_ms, 99):.2f} ms, {len(errors)} "
            f"structured errors {sorted({type(e).__name__ for e in errors})}"
            f" [{smi}]")
        for r, inc, t0, t1 in loads:
            e = np.asarray(ends[f"bert:v{inc}"])
            during = np.concatenate([e[e < t0][-1:],
                                     e[(e >= t0) & (e <= t1)],
                                     e[e > t1][:1]])
            gaps = np.diff(during)
            log(f"lifecycle round {r}: the incumbent v{inc}'s longest gap "
                f"between batches while the candidate loads "
                f"({t1 - t0:.2f} s) {1e3 * gaps.max(initial=0.0):.2f} ms "
                f"over {len(gaps)} gaps")
        log(f"lifecycle: flash launches {launches['flash_attention']}, "
            f"replays {replays['flash_attention']}; layer_norm launches "
            f"{launches['layer_norm']}, replays {replays['layer_norm']}; "
            f"{hits} graph replays; train losses "
            f"{[round(v, 5) for v in train_losses]}; traffic capture "
            f"{traffic_capture.captured} records, {traffic_capture.dropped} "
            f"dropped")

        # ------------------------------------------------------- checks
        versions = sorted(reg.models()["bert"]["versions"])
        final_v = reg.active_version("bert")
        if active_at_death != 2:
            fail(f"phase 37: v{active_at_death} served after the death, "
                 "want v2")
        if final_v != 5 or drv2.incumbent_version != 5:
            fail(f"phase 37: the registry ends on v{final_v} (driver "
                 f"{drv2.incumbent_version}), want the last good v5")
        q = drv2.quarantined
        if [x["reason"] for x in q] != ["gate:non_finite_outputs",
                                        "slo_regression"] \
                or q[0]["version"] is not None or versions != [1, 2, 3, 4, 5]:
            fail(f"phase 37: quarantined {q}, versions {versions}: want the "
                 "NaN candidate quarantined by the gate and never loaded, "
                 "then one SLO regression")
        if drv2.rollbacks != 1 or summary["rollbacks"] != 1:
            fail(f"phase 37: {drv2.rollbacks} rollbacks, want 1")
        if pre_v != 3 or post_v != 3 \
                or not np.array_equal(pre_ids, post_ids) \
                or not bits_equal(pre_logits, post_logits) \
                or not same_params:
            fail(f"phase 37: before the roll v{pre_v}, after the rollback "
                 f"v{post_v}: the served ids, the restored model's logits "
                 "or its parameters are not bit-equal")
        if not resolved or not all(isinstance(e, ServingError)
                                   for e in errors):
            fail(f"phase 37: requests not resolved exactly once, or errors "
                 f"that are no ServingError: "
                 f"{sorted({type(e).__name__ for e in errors})}")
        for v in versions:
            if v in spent:
                counts = spent[v]
            else:
                sv = reg.server("bert", v)
                counts = (sv.recompiles_after_warmup(),
                          sv.captures_after_warmup())
            if any(counts):
                fail(f"phase 37: bert:v{v} recompiles {counts[0]}, "
                     f"captures {counts[1]} after warmup")
        stats = cc.cache_stats()
        if disp.captures() != 1 or stats["capture_failures"]:
            fail(f"phase 37: the trainer captured {disp.captures()} "
                 f"graphs; cache stats {stats}")
        if replays != {k: n * hits for k, n in per_fwd.items()} \
                or any(plain.values()):
            fail(f"phase 37: replays {replays} over {hits} graph replays "
                 f"(plain calls {plain}): want 12 flash and 25 layer_norm "
                 "a replay")
        st = DriverStateStore(state_dir).load()
        if st is None or st["phase"] != "idle" or st["in_round"] is not None \
                or st["round"] != 5:
            fail(f"phase 37: the driver's state ends {st}")
        held = [v for v in alive[5] if v in spent]
        if held:
            fail(f"phase 37: retired versions {held} still hold their "
                 "models")
        if mem[5] > mem[2] + footprint:
            fail(f"phase 37: memory after round 5 {mem[5] / 1e9:.3f} GB "
                 f"exceeds round 2's {mem[2] / 1e9:.3f} GB by more than a "
                 f"version ({footprint / 1e9:.3f} GB)")
        bad = [i for i, v in verdicts.items() if v.passing
               and v.detail.get("parity_rel") is None]
        if bad:
            fail(f"phase 37: passing verdicts {bad} report no parity_rel")
        log(f"phase 37: the lifecycle storm on BERT-base: trainer killed at "
            f"roll {killed.roll_index} (round {killed.round_index}) and "
            f"resumed, the NaN candidate quarantined unloaded, one rollback "
            f"bit-equal, v5 served; {len(res)} requests each resolved once; "
            f"phase {time.perf_counter() - t_phase:.1f} s [{smi}]")
        return {"launches": launches, "replays": replays}
    finally:
        ModelServer._dispatch_batch = dispatch_batch
        stop.set()
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        reg.close()
        shutil.rmtree(tmp, ignore_errors=True)


def bound(nbytes: int, ops: int, peak: float) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate for their
    type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


if __name__ == "__main__":
    main()
