#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (deeplearning4j_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and nothing is passed over:

1. environment — card name and power limit, torch/CUDA versions; TF32 off.
2. build — ``nvcc`` builds every kernel of the path from ``csrc/`` (one
   process per source, all at once); prints each kernel's registers and
   spills from ``-Xptxas -v`` and, by ``cuobjdump -sass``, the HMMA
   (tensor-core) instructions in the libraries of ``fused_mm``,
   ``fused_c3``, ``fused_mm_bwd``, ``fused_c3_bwd`` (with
   ``fused_c3_bwd_in`` and ``fused_c3_bwd_w``), ``lstm_fwd``,
   ``lstm_bwd``, ``flash_fwd`` and ``flash_bwd_dkv`` (with
   ``flash_bwd_dq``); it fails if one holds none.
3. kernels — ``fused_mm`` and ``fused_c3`` at every distinct shape the
   ResNet50 gives them at batch 32, in float32 and bfloat16, held against
   their plain PyTorch versions on the card and run twice for
   bitwise-equal results; kernel, plain and library-yardstick (cuDNN conv
   of the normalized input) times, by CUDA events around back-to-back calls
   as the path makes them, beside each call's bound. Then the backward
   kernels at the same shapes on random
   dy, y and dstats: ``fused_mm_bwd`` for every 1×1 call, and at every 3×3
   shape BOTH routes (``fused_c3_bwd`` in one call, ``fused_c3_bwd_in``
   + ``fused_c3_bwd_w`` in two), each held against its plain version (dx,
   dW, dscale, dshift), run twice for bitwise-equal results, and timed
   beside its bound, its plain version and a library yardstick
   (``torch.matmul`` for 1×1, cuDNN's ``convolution_backward`` for 3×3);
   all three 3×3 backward kernels also at the train phase's batch 128,
   where the two routes are compared per shape, and ``fused_mm`` and
   ``fused_mm_bwd`` at every 1×1 call of batch 128 in bf16. The rows of the
   six conv kernels and ``flash_fwd`` also carry their kernels' device time
   by ``torch.profiler`` beside their library's, and the CUDA launches
   (kernels and memsets on the card) one wrapper call makes.
   Then ``lstm_fwd`` and ``lstm_bwd`` at the LSTM slice shape (T 60, N 128,
   H 256), the LSTM benchmark geometry (T 128, N 256, H 512) and a TBPTT
   segment (T 50, N 32, H 256), f32 and bf16, masked and unmasked: against their plain versions, bitwise on a
   second run, timed beside their bound, the latency floor (T × one
   barrier of the kernel's own kind on its own grid, measured: a cluster
   barrier for ``lstm_fwd``'s cluster route, else a grid barrier) and
   cuDNN's LSTM layer (unmasked), with ``lstm_fwd``'s plan and the
   clusters the card keeps resident for it. Then
   ``flash_fwd``, ``flash_bwd_dkv`` and ``flash_bwd_dq`` at the BERT-base
   slice shape (N 64, T 128, H 12, Dh 64; f32 and bf16; unmasked, a ragged
   key mask, causal), the long-sequence geometry (T 1024/2048/4096 at N
   16/8/4, bf16, causal or not) and one edge shape (T 37, Dh 16, f32 and
   bf16, causal, with fully masked rows), on strided views of one packed
   projection: against their plain versions, bitwise on a second run,
   timed beside their bound, the plain versions and
   ``F.scaled_dot_product_attention`` (whose backend is reported).
4. slice — the full-width ResNet50 (64×64×3, 200 classes, s2d stem,
   fused blocks, bf16) built on the card from a seed, served through
   ``ServingEngine`` to four client threads; every answer is held against
   ``model.output`` on the same rows, the kernel launch counters against
   36 + 16 launches per dispatched batch, and the f32 model with kernels
   against the same model on the plain path.
5. train — the same model trained by Nesterovs(1e-2, 0.9) in bf16 on one
   fixed random batch of 128 through ``make_scan_train_step`` (K = 4
   steps per call): the launch counters of one call grow by exactly
   K × (36, 16, 36, 13, 3, 3) for (fused_mm, fused_c3, fused_mm_bwd,
   fused_c3_bwd, fused_c3_bwd_in, fused_c3_bwd_w); over 24 steps every
   loss is finite and the best after the first is below the first; step
   ms, images/s and peak memory; and the f32 model's gradients at batch 8
   through the kernels against the same step on the plain versions.

6. lstm_serve — the committed TextGenerationLSTM (f32) scores 128
   corpus windows of 60 chars through ``output()`` (probabilities against
   the plain path, cross-entropy < 2.5) and generates 200 chars greedily
   through ``rnn_time_step`` (each step held against the plain path
   teacher-forced on the same tokens); exactly 2 ``lstm_fwd`` launches per
   call; sequences/s, ms per call and ms per char.
7. lstm_train — the same model from seed 123, batch 128 × 60 corpus
   windows, Adam(2e-3) + clip 5, 24 steps in K = 4 step calls: exactly
   2 ``lstm_fwd`` + 2 ``lstm_bwd`` launches per step, the loss falls, and
   one f32 step matches the plain path (loss, gradients); step ms, chars/s
   and peak memory.
8. bert_serve — the BERT-base-geometry stack (embedding 30522 → 768,
   learned positions, 12 pre-LN blocks of width 768 with 12 heads,
   ``RnnOutputLayer(30522)``; benchmarks/baseline_suite.py:159-213) built
   on the card from seed 123 in bf16: ``output()`` on 64 × 128 integer
   ids and on a ragged batch with a features mask, exactly 12
   ``flash_fwd`` launches per call; the f32 stack through the kernels
   against the plain path (probabilities); tokens/s, ms per call, peak
   memory.
9. bert_train — the same stack, Adam(1e-4), bf16, one fixed random batch
   of 32 × 128, K = 4 steps per call, 24 steps: exactly K × 12 launches of
   each flash kernel per call, the loss starts near ln 30522 and falls, one
   f32 step matches the plain path (loss, gradients); step ms, tokens/s,
   peak memory.

10. digits_eval — the committed ``LeNet`` and ``SimpleCNN`` digit models
   (``init_pretrained(flavor="digits")``) restored on the card and
   evaluated on the held-out UCI digits (LeNet through
   ``DigitsDataSetIterator``, 320 images as ``drop_last`` gives them;
   SimpleCNN on all 360 as NHWC): accuracy at least 0.98 and 0.95; each
   model's card probabilities within DIGITS_PROB_TOL of each row's largest
   of the same port model on the CPU, with no argmax difference; images/s
   of ``evaluate``. This slice runs no TPU kernel: the convolutions are
   plain torch, as the JAX package leaves them to XLA.
11. digits_train — ``LeNet()`` (f32, Adam(1e-3), seed 123) trained from
   scratch on the card by ``fit(DigitsDataSetIterator(64, train=True),
   epochs=12)`` through the device feeder, then evaluated: held-out
   accuracy at least 0.98; one epoch with ``k_steps=4`` equals one with
   ``k_steps=1`` from the same init within DIGITS_PARAM_TOL of each
   array's largest; three steps under each of the ten updaters, the three
   L2 gradient normalizations and a ``StepSchedule``: the card's updater
   matches the CPU's on the card's gradients within DIGITS_PARAM_TOL, and
   whole steps on each device are reported beside it (cuDNN on and off);
   ``SimpleCNN`` (28×28×1, BN, dropout
   0.5) fitted two epochs on the NHWC digits lowers its training loss;
   step ms, images/s, epoch wall, the feeder's stall ms, peak memory and,
   with ``--profile``, the card's busy share over one epoch.
12. generate — ``GenerationEngine`` over the committed TextGenerationLSTM
   (f32, 8 slots, TF32 off; its tick is plain torch and launches none of
   the eleven kernels). 16 corpus prompts of 20 chars, submitted
   staggered, 32 new tokens each (128 before PR 24): every greedy stream equals
   ``reference_decode`` on the card (the ``lstm_fwd`` path) up to the
   oracle's first near tie (top-2 probability gap < LSTM_PROB_TOL). One
   seeded sampled request alone at bucket 1 equals itself among 7
   co-residents at bucket 8. Chunked prefill (64) against tick prefill,
   speculative decode (k 3) against plain counter-mode decode, greedy
   and seeded, and two-turn sessions against one run, all bitwise. The
   int8 head passes its gate (top-1 budget 0.03) and decodes; the bf16
   head decodes; both report their agreement with the f32 streams.
   ``assert_warm()`` on every engine. Tokens/s at 8 slots, per-token
   p50/p99, TTFT with tick and chunked prefill, speculative acceptance,
   warmup seconds, the oracle's ``lstm_fwd`` launches and, with
   ``--profile``, the card's busy share of a full-slot run.
13. serve_http — ``python -m deeplearning4j_tpu_torch serve`` as users
   start the system. The slice ResNet50 (bf16, nontrivial BN from a
   seed) saved to a zip and served in process by ``cmd_serve(...,
   block=False)``: ``POST /api/predict`` with 1, 7, 32 and 45 images (45
   splits), then 4 client threads × 8 requests of 1-32 images (16
   before PR 24), every
   answer bitwise the served engine's ``output`` on the same rows and
   ``n`` right, 36 + 16 launches a dispatched batch (added to the kernels
   line). Behind ``--slo-ms`` (the fleet front door): ``/api/fleet/swap``
   to a second zip (another seed) gives its engine's answers and
   ``/api/fleet/rollback`` v1's again, bitwise; an expired
   ``X-Deadline-Ms`` answers 504, a pool at its pending bound 503 with
   ``Retry-After``; ``/api/fleet/stats`` names both versions. The
   committed TextGenerationLSTM zip with ``--generate`` (8 slots, prefill
   chunk 64): predict on one-hot corpus windows within LSTM_SERVE_TOL of
   each row's largest of ``model.output`` (2 ``lstm_fwd`` launches a
   batch, added to the kernels line), 8 concurrent greedy SSE streams
   against ``reference_decode`` under the near-tie rule, the generation
   stats and the ``dl4j_gen_*``/``dl4j_serving_*`` series present,
   ``/healthz`` 200, ``assert_warm()`` on both engines. The same zip
   served by ``python -m deeplearning4j_tpu_torch serve ... --duration
   30`` in a subprocess: its banner's URL answers ``/healthz`` 200 and a
   predict equal to the in-process answer, ``/api/serving/stats`` names
   ``cuda:0``, and it exits 0. Measured: HTTP predict p50/p99 at 1 and 32
   images against the engine's own, images/s of the 4 clients, SSE
   tokens/s and TTFT against the engine's, warmup and swap seconds.

14. rnn_tbptt — the recurrent family. The TextGenerationLSTM configuration
   (2 x LSTM(256), RnnOutputLayer(77), Adam(2e-3) + clip 5, f32, seed 123)
   with ``backprop_type("tbptt")`` and segments of 50, fitted on 8
   batches of 32 corpus windows of 1000 chars and one of 1020 (a ragged
   tail of 20): exactly 2 ``lstm_fwd`` + 2 ``lstm_bwd`` launches a segment
   (40 + 40 a batch, 42 + 42 the ragged one), the iteration count up by 20
   (21), every loss finite, the last batch's mean segment loss below the
   first's, the tail step moving the parameters; on one batch from the
   same init the kernels' segment chain against the plain versions'
   chain (the first segment's loss and gradients, every segment's loss,
   the carries handed on and the parameters after the batch, bounded by
   the plain chain's own row-order noise); ``rnn_time_step`` in 20 calls
   of 50 against ``output()`` on the 1000 chars. The layers at width 256
   on 32 x 60 windows with a ragged mask: ``Bidirectional(LSTM)`` in all
   four modes (output and one train step against the plain path, 2
   ``lstm_fwd`` a call, 2 + 2 a step), ``LastTimeStep`` and
   ``MaskZeroLayer`` around an LSTM against the plain path, and
   ``GravesLSTM``, ``GravesBidirectionalLSTM`` and ``SimpleRnn`` (no
   kernel) on the card against the CPU. The graph of
   examples/streaming_rnn_and_pretrained.py at width 256: a TBPTT fit
   (segments of 8) with a features mask and no labels mask against the
   CPU, then ``rnn_time_step`` a tick at a time against ``output()``. A
   ``GenerationEngine`` (8 slots) over 2 x ``GravesLSTM(256)`` + the
   head: 8 greedy streams of 64 against ``reference_decode`` under the
   near-tie rule. Measured: segment ms, chars/s and the batch wall of
   TBPTT beside standard BPTT over the same chars in one call, peak
   memory, and with ``--profile`` the busy share of a TBPTT batch.

15. zoo — the convolutional model library (plain torch, no kernel on its
   main path). The bench ResNet50 (bench.py:46-56: 64x64x3, 200 classes,
   bf16, s2d stem) from the train phase's weights, trained as the train
   phase trains the pallas arm (Nesterovs(1e-2, 0.9), batch 128, K = 4,
   24 steps) by ``fused_impl="xla"`` and by the per-layer graph
   (``fused_blocks=False``, weights by ``unfuse_resnet50_params``): every
   loss finite, the best after the first below the first, no launch of
   kernels 1-6, step ms, images/s and peak memory beside the pallas arm's
   (the train phase); the f32 gradients at batch 8 of the "xla" and
   "pallas" blocks on the same weights within the train phase's noise-set
   bound (kernels 1-6 run here); both statistics routes of
   ``conv_bn_stats_xla`` timed at every 1x1 call of the bench shape in
   bf16 and the rule they set. VGG16 (benchmarks/baseline_suite.py:32-64:
   64x64x3, 200 classes, bf16, Nesterovs) trained in K = 4 step calls at
   batch 128 (the batch's loss, read by the model's f32 twin, falls;
   images/s, peak memory) and served through ``ServingEngine`` at every
   bucket, bitwise ``model.output``. YOLO2 at 416x416x3 (20 classes, the
   VOC anchors, f32): output and train-mode loss against the same model
   on the CPU within the card's own noise rule, Adam at a warm-up rate
   on one batch of 8 seeded synthetic boxes lowers the loss,
   ``get_predicted_objects`` returns boxes; the decode of one output on
   the card against the CPU's (``decodes_agree``): every decoded tensor
   within DECODE_ULPS f32 ulps of its largest entry, and the lists after
   NMS equal or parting first at a near tie. AlexNet, VGG19, Darknet19,
   TinyYOLO, GoogLeNet, InceptionResNetV1 and FaceNetNN4Small2 at their
   defaults: f32 output of 2 rows against the CPU under the same rule,
   one finite train step that moves the parameters, the parameter count.
   The committed digit LeNet frozen through its last dense layer with an
   even/odd head from ``n_out_replace``, fitted on the digits: the frozen
   parameters and state bitwise unchanged; held-out accuracy.

16. keras_import — the Keras importer (modelimport/) on the card. The
   card's machine has no h5py and no keras, so the importer's conversion
   runs on committed resources (tools/keras_card_resources.py, read by
   ``KerasResourceArchive``). The 14 committed fixtures (k1_*, k2_* .h5,
   k3_* .keras) imported and run in f32, each within rtol 1e-4, atol 1e-5
   of its ``tests/resources/keras/*_io.npz`` (k3_attention through
   ``flash_fwd`` at 3 heads x Dh 4, k1_lstm and k3_temporal's
   Bidirectional through ``lstm_fwd``); k1_lstm fine-tuned by one Adam
   step (``lstm_fwd`` + ``lstm_bwd``), its gradients against the plain
   path. BERT-base (12 x 768, 12 heads, FFN 3072, vocab 30522, seq 128)
   from its committed configuration with seeded weights: f32 hidden states
   within 1e-4 of each position's largest against Keras's; bf16
   ``output()`` at 64 x 128 (12 ``flash_fwd`` a call); the fine-tune of
   benchmarks/baseline_suite.py:296-356 (AVG pooling + 2-class head, bf16,
   Adam(2e-5), ``shadow_cast``) at 128 x 128, K = 4, 3 calls: K x (12, 12,
   12) flash launches a call, the loss falls, the shadow-cast call bitwise
   the same call without it, one f32 step's gradients within 1e-4
   relative L2 of the plain path; the frozen encoder's leaves bitwise
   after a call. InceptionV3 at 299x299x3, 1000 classes: output and
   ``avg_pool`` within rtol 1e-3, atol 1e-5 of Keras's, f32 inference at
   128, the fine-tune of benchmarks/baseline_suite.py:216-270 (200
   classes, bf16, Adam(1e-4)) at 64, K = 4, 2 calls, a finite loss that
   moves (no TPU kernel on that path). Then constraints, weight noise and
   the legacy optimizers: the committed TextGenerationLSTM with a
   MaxNormConstraint, one Sgd step card against CPU, the norms bounded;
   DropConnect at rate 0 bitwise the plain step, its zeros and scaling at
   0.3, WeightNoise's mean and spread, a noisy step through the LSTM
   kernels; LBFGS and conjugate gradient on the digits LeNet, card
   against CPU. Step ms, tokens/s or images/s and peak memory for each.

17. observed_fit — the observed training loop (listeners, telemetry, the
   span tracer, the flight recorder, early stopping, StatsListener, record
   readers) through ``fit(iterator)``. The slice ResNet50 (bf16, fused
   blocks, s2d stem, 200 classes, the ``nontrivial_bn`` weights) trained
   at batch 128 by ``EarlyStoppingTrainer`` -> ``fit(iterator,
   k_steps=4)`` for two epochs of 2 calls with a held-out
   ``DataSetLossCalculator``, with a ``TelemetryCollector`` (per layer,
   histograms, flushed every 8 steps), ``ScoreIterationListener``,
   ``PerformanceListener``, ``CollectScoresIterationListener``,
   ``CheckpointListener``, ``StatsListener`` (served by ``UIServer``), a
   ``SpanTracer`` and a ``FlightRecorder``: the first epoch's parameters
   and losses bitwise those of the same batches through the K-step call
   made directly; each call's launches K x the train phase's per step,
   and the profiler's count of the hand-written kernels the same with
   and without telemetry; the telemetry's loss column bitwise the calls'
   losses, its first grad_norm within 1e-5 of ``vector_norm`` of
   ``value_and_grad``'s gradients, no non-finite count, the fetches one
   per 8 steps plus the tail flush of each fit; sync debug mode "error"
   around every telemetry record, every collector step that does not
   flush and the listeners' calls (after the first flush); the
   dashboard's ``/api/sessions``, the trace's spans, the checkpoint; the
   early-stopping result's restored best model re-scored bitwise. A
   clone fitted with one NaN batch (its row's non-finite count, the
   histograms written though not due, one ``nonfinite`` dump); a
   listener allocating past ``mem_get_info`` inside ``fit`` (the OOM
   surfaces, one ``oom`` dump with the allocator's numbers, one more step
   after ``empty_cache``). ms per step and the busy share with every
   observer on and with none, a warm epoch then OBS_REPEATS timed ones
   each, interleaved. The ResNet50
   ``ServingEngine`` with a tracer: 32 requests bitwise the untraced
   engine's, each batch's queue_wait, batch_form, dispatch, device and
   fetch spans. The rnn_tbptt model (segments of 50, 32 x 1000 chars), 2
   batches by ``fit`` with telemetry: 2 + 2 LSTM launches a segment, the
   rows' losses bitwise the segments'. The bert_train model, 1 call (2
   before PR 24) of
   ``fit(iterator, k_steps=4)`` with telemetry and a tracer: 48 launches
   of each flash kernel a call, the losses bitwise the same K-step calls
   made directly (with the feeder's ones labels mask). The committed
   digits written as CSV, read by ``CSVRecordReader`` ->
   ``RecordReaderDataSetIterator`` into one LeNet epoch: the parameters
   bitwise those of the same batches from ``DigitsDataSetIterator``.
   cuDNN runs deterministic algorithms in this phase.

18. quant_serve — int8 serving (parallel/quant.py,
   evaluation/quant_gate.py). ``int8_conv`` and ``int8_dot`` on the card
   at LeNet's shapes and at K = 4608: the int32 accumulator equal to an
   int64 host product, the output bitwise the CPU's. The committed LeNet
   behind ``ServingEngine(precision=PrecisionPolicy.int8(digits test
   split))`` at batch 32: 12 requests of 1-45 rows bitwise the
   ``QuantizedModel``'s walk at the bucket, the gate passes, two
   calibrations on the card give one hash (and whether it equals the CPU
   port's is recorded, not gated), images/s and p50/p99 at 32 beside the
   f32 engine, ``params_nbytes``. The TextGenerationLSTM with an int8
   ``RnnOutputLayer`` and f32 LSTMs: exactly 2 ``lstm_fwd`` launches a
   served call, the gate passes, top-1 agreement with the f32 engine,
   sequences/s. The fleet: an int8 LeNet pool admitted behind a passing
   ``QuantGate``, a swap behind an impossible gate refused with the old
   version answering bitwise, ``dl4j_fleet_quant_gate_total`` counting
   one pass and one fail.
19. model_library — the rest of the model library. A 784 -> (256, 256) ->
   32 Bernoulli VAE pretrained on the 1797 digits for 3 epochs (the
   negative ELBO of a fixed batch falls; one pretrain step with injected
   epsilon card against CPU within LOSS_RTOL and LIB_STEP_RTOL;
   ``reconstruction_log_probability`` and ``generate_at_mean_given_z``);
   an AutoEncoder 784-500-250 stack (corruption 0.3) pretrained, then
   fitted (the loss falls). The MoE sequence stack (embedding 30522 ->
   768, positions, 2 pre-LN blocks of 768 with 12 heads, MixtureOfExperts
   of 8 experts of 3072, top 2, capacity factor 1.25, RnnOutputLayer
   30522; bf16, Adam(1e-4)) at 32 x 128 with a ragged padding mask: 24
   steps, 2 launches of each flash kernel a step, the loss falls (the
   mean of the last 4 steps below the first), the aux loss finite and
   counted in the loss, masked tokens' MoE output exactly 0, dispatch and
   capacity drops recorded, one f32 step through the kernels against the
   plain versions (loss, gradients, the parameters after the step). A LambdaLayer + SameDiffLayer network card against
   CPU; ``check_model_gradients`` in float64 on the card for dense +
   AutoEncoder + MoE + SameDiff + output; an f64 LSTM raising TypeError
   from the kernel wrapper. ``memory_report`` of LeNet, the bench
   ResNet50, TextGenerationLSTM and the BERT geometry;
   ``device_memory_analysis(train=True)`` of LeNet and ResNet50 at 128
   beside a real step's allocator peak. ``KMeansClustering(10)`` of
   LeNet's 500-wide features of the digits card against CPU (centers,
   inertia, purity); exact t-SNE of the 1797 digits (each of the first
   20 steps card against CPU from the same state, the whole run's time,
   KL and trustworthiness), Barnes-Hut on 300 points; a TsneListener in
   a LeNet fit writing its coordinates to a running UIServer.

20. cluster — the multi-node serving tier (parallel/node.py,
   parallel/remote.py). The slice ResNet50 (bf16, fused blocks, the
   ``nontrivial_bn`` weights) on two in-process ``ServingNode``s, each with
   its own engine (batch limit 32, warmed), one ``NodeRegistry`` and one
   ``RemoteDispatcher`` over HTTP: 4 clients x 10 requests of 1-32 images
   (15 before PR 24),
   node a drained after 20 answers. Every answer bitwise the answering
   node's engine's ``output`` on the same request and within 5e-3 of
   ``model.output``; the drain finishes every admitted request and
   deregisters; the dispatcher's OK count and the nodes' served counts
   each equal the requests; 36 + 16 launches a dispatched batch (added to
   the kernels line); an ``AutoScaler`` tick reads the gossip. Then
   ``python -m deeplearning4j_tpu_torch serve --join`` on the model's zip:
   its cold start (spawn to registered, after its warmup, 0 live
   compiles), split into its warmup (the kernel libraries' first load,
   timed alone in a fresh process, and the sweep) and imports + restore
   + HTTP, beside this run's nvcc seconds for the two sources;
   SIGKILLed halfway through 12 requests over it and node b (every request
   answered, bitwise b's engine, the failures retried onto b); a rejoin
   with the same id answering; SIGTERM draining it to exit 0 with its
   record gone.
21. neighbors — the retrieval tier (retrieval/, the fleet's retrieval
   pool, ui/neighbors_module.py). The JAX package's full geometry
   (benchmarks/neighbors.py): a 1,000,000 x 64 blob corpus (488 blobs,
   seed 0), shards of 262144, IVF with 256 clusters (k-means on the
   card) and nprobe 64, built in f32 and in int8; 64 probes near corpus
   rows at k 10 (k ladder 10, 40). f32 brute ids equal a float64 oracle's
   except at near ties (a swap's true gap within 1e-6 of |q|^2 + |c|^2:
   the f32 expanded form rounds at the scale of its terms); recall@10 of
   int8 brute, IVF f32 and IVF int8 at least 0.95; a repeat bitwise; zero
   live compiles after warmup; queries/s, p50/p99 and the corpus bytes
   each arm reads on the card. The committed JAX-saved index
   (tests/resources/retrieval, tools/retrieval_resources.py): the card's
   ids equal the port's CPU ids in every arm, distances within 1e-5 of
   |q|^2 + |c|^2. The f32 index saved to a store: two ``RetrievalNode``s
   owning shards {0,1} and {2,3}, a ``NeighborsDispatcher``'s merged
   answer bitwise the single engine's, ``partial: true`` with one node
   down; ``serve --neighbors-index --join`` on shard 0 answering, then
   SIGTERM-drained to exit 0.
22. embeddings — the NLP and graph embedding tier (nlp/, graph/,
   utils/native.py; plain torch steps, none of the eleven kernels). The
   native pair generator must build (g++ at first use into build/native)
   and be in use. Word2Vec at benchmarks/baseline_suite.py:464-520's
   geometry: 3M zipf(1.05) tokens over 100k words from default_rng(0) in
   sentences of 40, layer 128, window 5, negative 5, batch 65536, seed 3,
   pairgen "auto"; four arms (SGNS with shared negatives, HS, CBOW, SGNS
   with device pair generation). Each arm: tokens/s of the fit drained by
   reading one element, peak memory; its first superchunk (HS: the
   first EMB_HS_PARITY_CHUNKS chunk steps of it; device pairs: the first
   flush, on the card's draws) from the initial tables on the card against the CPU
   path (EMB_PARITY_TOL of each table's largest entry) and twice on the
   card bitwise; its first superchunk once with every sync an error
   (torch.cuda.set_sync_debug_mode); torch ops a chunk and the
   card's busy share over superchunks (torch.profiler); the host-pair
   arms' overlapped producer bitwise the serial loop on the first 100k
   tokens. Planted topics (20 x 50 words, 200k tokens): in-topic cosine
   above cross-topic for SGNS, HS and CBOW; write_full_model and
   read_full_model keep the card-trained vectors. ParagraphVectors at
   baseline_suite.py:523-615's geometry cut to 5k docs (20k there)
   x 100 tokens, 50k words: DBOW and DM, tokens/s; infer_vector +
   predict of 200 held
   documents of 10 labelled planted topics beat chance by
   EMB_PREDICT_MARGIN. GloVe on the first 200k tokens: the loss falls over
   5 epochs, one step repeats bitwise. DeepWalk and Node2Vec on two
   communities of 2000 vertices, walks of 40: mean similarity within above
   across.
23. online — online learning (online/, streaming/broker.py,
   ui/online_module.py) on the slice ResNet50 (bf16, fused blocks, s2d
   stem, 200 classes) at batch 32. An ``OnlineServing`` over a
   ``TcpTransport`` broker served in this process; a publisher thread
   sends labelled batches (each label a fixed function of its pixels,
   from a seed: the argmax of a random projection of the 4 x 4 channel
   means over 10 classes) while two client threads are served. The three
   model copies and the engine's committed copy share no storage. Gates:
   the learner takes at least 20 steps, and kernels 1-6 launch in the
   learner (1-2 in its thread, the backward's 3-6 in the device thread
   PyTorch's autograd runs a CUDA backward on), 1-2 in the serving
   dispatcher's thread and in the scorer's (launches tallied by thread); ``promoter.run_once`` promotes a
   snapshot before a deadline, the pool's committed params then equal the
   snapshot bitwise, and a served batch equals a forward of the eval
   clone loaded with the snapshot within the slice phase's padded-vs-
   direct bound (5e-3); a degraded candidate (the output layer's W x 25)
   forced in makes ``sentinel.check()`` return ``score`` (or ``nan``) and
   the committed params equal the pre-swap ones bitwise. ``python -m
   deeplearning4j_tpu_torch serve --online --stream-endpoint`` on the
   model's zip in a subprocess answers ``/api/predict``,
   ``/api/online/stats`` (learner alive, iterations rising),
   ``/api/online/promote`` (counted) and ``/api/online/rollback``. A
   ``ConvolutionalListener`` on a LeNet fit of the committed digits on
   the card: its PNGs decode to the CPU listener's grids (same
   parameters) within one gray level. Measured: the learner's images/s
   while serving, the serving p50/p99 during learning, the seconds of a
   scoring pass.
24. aot_cache — the persisted kernel cache (parallel/aot_cache.py) in
   fresh processes on the slice ResNet50 engine (bf16), each pointing
   ``cuda_build.BUILD_DIR`` at its own empty directory in its own code:
   a cold process builds the two forward libraries (``build_log``) and
   saves them to an ``ArtifactStore`` key; a ``serve --join`` node given
   ``--artifact-store`` warms from the key's directory with no ``nvcc``
   and answers bitwise what the cold process answered (cuDNN
   deterministic in both); a run with another feature shape falls
   through to a build and names ``serving.feature_shape``; a corrupted
   blob is quarantined, its library rebuilt and republished, and the
   answer is bitwise the cold one. Measured: the spawn-to-``assert_warm``
   seconds of the cold process and the warm node, the nvcc seconds.
25. data_parallel — ``ParallelWrapper`` (parallel/wrapper.py) over the
   slice ResNet50 (kernels 1-6). (1) One rank in this process, an NCCL
   group of world size 1, bf16: SHARED_GRADIENTS for 4 steps of 32 rows
   and AVERAGING with averaging_frequency 4 bitwise 4 plain ``fit``
   steps (params, BN state, updater state, loss); ASYNC_ELASTIC without
   stragglers against AVERAGING (its merge θ + (l − θ) rounds, so its
   parameters are held to the train phase's f32 bounds, its state and
   loss bitwise); kernels 1-6 at the train phase's count a step in each.
   cuDNN runs deterministic algorithms (the stem convolution) wherever
   steps are compared bitwise.
   (2) Two gloo ranks on the one card, started with ``spawn``
   (parallel/launch.py: a FileStore, a collective timeout, a join
   deadline), f32: 3 SHARED_GRADIENTS steps on a global batch of 2 x 32,
   a sharded checkpoint after each, the ranks bitwise equal; rank 0
   within the train phase's f32 bounds of one process taking each step
   on the 64 rows from the same state (the model's file, then the ranks'
   checkpoint of the step before): every step's loss 1e-5, the first
   step's update max(1e-3, 3 x its row-order noise: the largest of
   DP_PERMUTATIONS runs of it on the rows permuted; later updates are
   chaotic at this size); the telemetry replica ring holds both ranks'
   fingerprints. (3) A sharded checkpoint at step
   3: a fresh model in each rank restored from it takes step 4 bitwise as
   the unbroken run; restored here at world size 1, bitwise rank 0's step
   3. (4) The collective watchdog in CPU subprocess groups (the Iris MLP):
   a peer SIGKILLed after step 3 leaves the survivor to exit
   PEER_LOSS_EXIT_CODE (43) with the PEER_LOSS.json marker, a peer_loss
   dump and an emergency checkpoint that restores at the marker's
   iteration; a peer asleep past the deadline while beating is a
   straggler (both exit 0). The in-process runs' and the ranks' launches
   count; the plain references' do not.
26. model_parallel — model parallelism (parallel/tensor_parallel.py,
   ring_attention.py, pipeline.py, moe.py) in one group of two gloo ranks
   on the card (spawned; rank 0 also takes each arm's one-process
   reference, whose launches do not count). Tensor parallelism: the
   BERT-base graph of modelimport/bert.py:27-28 from its committed
   configuration (seeded weights) with the fine-tune head, 32 x 128, on
   {data 1, model 2}: 6 heads a rank; f32 against the replicated model
   (the encoder's output within 1e-5 of its largest entry, the loss
   within 1e-5, every gradient leaf within 1e-4 rel L2), 12 launches each
   of kernels 9-11 for the step; bf16 (the fine-tune's compute dtype), 4
   ``fit`` steps of the split model at the fine-tune's Adam(2e-5): finite
   losses, 12 launches each a step and rank. Sequence parallelism at N 8, T 512 (BERT's max_len), H
   12, Dh 64: ring and Ulysses, causal or with a ragged key mask, f32 and
   bf16, each rank half the sequence: outputs and q/k/v gradients against
   ``flash_attention`` on the whole sequence (f32 1e-5 and 1e-4 of the
   largest entry, bf16 Y_TOL's 1e-2), Ulysses through kernels 9-11 on 6
   heads. The pipeline: ``PipelinedTransformerLM`` (vocab 30522, width
   768, 12 heads, 12 layers, max_len 128) over a pipe axis of 2 (6
   stages a rank, circular, M 2, remat on as the model defaults, so each
   stage's forward runs again in the backward under
   ``torch.utils.checkpoint``), 16 x 128, f32: loss and gradients
   against pipelined=False within 1e-5 and 1e-4, one SGD step each and
   the loss after it within 1e-5; 24 launches of kernel 9 a rank (12
   stage applications and their 12 recomputations) and 12 each of
   kernels 10 and 11. Experts: the MoE stack's expert layer
   of phase 19 (8 experts of 3072 at width 768, top 2, capacity factor
   1.25) on 32 x 128 tokens leaning towards expert 0, 4 experts and half
   the tokens a rank: output within 1e-5 of its largest entry, aux and z
   losses within 1e-5, the capacity drops (the slots the split layer's
   own dispatch left empty, summed over the ranks) nonzero and equal to
   the unsplit layer's. The
   3D mesh, the LSTM and conv-chain plans stay in the CPU tests: 8 ranks
   would take 8 CUDA contexts on the one card, and those plans run no
   kernel (plain torch). PR 24 cut depth to pay for this phase:
   ``generate``'s streams 32 new tokens (128), ``serve_http``'s clients 8
   requests each (16) and its latency 10 requests (20), ``neighbors``' 10
   timed batches (20), ``observed_fit``'s timed epochs 1 an arm (2),
   ``cluster``'s requests 10 a client (15), and this phase's unsplit bf16
   BERT fit in rank 0 (4 steps beside the split ones, never gated).

It prints the phases' total seconds and the script's wall time, the
kernels' JSON line, then the card's name and power limit,
and last ``{"ok": true, "device": {...}}``. Without a card (or without the
rest of the repository beside it) it exits non-zero and prints no result.
Each run keeps its log and its details in its own directory,
``chiprun_out/<UTC time>-<pid>/`` (``chip_smoke.log``,
``chip_smoke.json``); a failure prints ``[fail] phase=<name>: <error>``
and its traceback there and on the output, and the run exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import threading
import time
import traceback
from unittest import mock

_T_START = time.perf_counter()

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # H100 SXM, dense
PEAK_BYTES = 3.35e12
# kernel vs plain version on the card: y elementwise |Δ| <= atol + rtol·|ref|
# (f32: both sum in f32, in different orders; bf16: the same f32 sums,
# then one rounding to bf16 that a last-bit difference can flip);
# statistics (f32 sums over M rows) |Δ| <= 1e-4·max|ref| + 1e-3
Y_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (1e-2, 1e-2)}
STATS_RTOL, STATS_ATOL = 1e-4, 1e-3
# the f32 model through the kernels vs through the plain versions:
# pooled features, |Δ| <= 1e-4·(1 + max|ref|)
SLICE_F32_RTOL = 1e-4
# backward kernel vs plain version: dx elementwise as y above, relative to
# max|ref| (|Δ| <= atol·max|ref| + rtol·|ref|); dW, dscale, dshift (f32
# sums over M of the same rounded factors, in another order)
# |Δ| <= 1e-4·max|ref| + 1e-5
DX_TOL = Y_TOL
SUM_RTOL, SUM_ATOL = 1e-4, 1e-5
# the f32 train step through the kernels vs through the plain versions:
# the loss within LOSS_RTOL; the gradients, per parameter and over all of
# them, within relative L2 error max(GRAD_RTOL, GRAD_NOISE x the larger
# of the two paths' own errors when the batch rows are summed in another
# order). A random-init 50-layer BN stack at batch 8 amplifies f32
# summation-order differences (ReLU masks and max-pool choices that flip
# on a last-bit change) to 1-4% relative in its gradients (measured on
# an H100 by this script: plain vs plain on permuted rows 1.1% over all,
# 1.6% worst; kernels vs kernels 2.9% and 4.0%), so a fixed 1e-3 cannot
# hold for any two f32 implementations; a wiring fault (a lost statistics
# cotangent, a wrong route) moves gradients by O(1).
GRAD_RTOL, GRAD_NOISE, LOSS_RTOL = 1e-3, 3.0, 1e-5
_CSRC = "deeplearning4j_tpu_torch/csrc/"
SOURCES = {"fused_mm": _CSRC + "fused_mm.cu",
           "fused_c3": _CSRC + "fused_c3.cu",
           "fused_mm_bwd": _CSRC + "fused_mm_bwd.cu",
           "fused_c3_bwd": _CSRC + "fused_c3_bwd.cu",
           "fused_c3_bwd_in": _CSRC + "fused_c3_bwd.cu",
           "fused_c3_bwd_w": _CSRC + "fused_c3_bwd.cu",
           "lstm_fwd": _CSRC + "lstm_fwd.cu",
           "lstm_bwd": _CSRC + "lstm_bwd.cu",
           "flash_fwd": _CSRC + "flash_fwd.cu",
           "flash_bwd_dkv": _CSRC + "flash_bwd.cu",
           "flash_bwd_dq": _CSRC + "flash_bwd.cu"}
_TPU = "deeplearning4j_tpu/ops/fused_conv.py:"
REPLACES = {"fused_mm": _TPU + "57", "fused_c3": _TPU + "156",
            "fused_mm_bwd": _TPU + "230", "fused_c3_bwd": _TPU + "379",
            "fused_c3_bwd_in": _TPU + "317", "fused_c3_bwd_w": _TPU + "348",
            "lstm_fwd": "deeplearning4j_tpu/ops/pallas_lstm.py:109",
            "lstm_bwd": "deeplearning4j_tpu/ops/pallas_lstm.py:206",
            "flash_fwd": "deeplearning4j_tpu/ops/pallas_kernels.py:40",
            "flash_bwd_dkv": "deeplearning4j_tpu/ops/pallas_kernels.py:180",
            "flash_bwd_dq": "deeplearning4j_tpu/ops/pallas_kernels.py:230"}
# the kernels whose libraries' bf16 bodies multiply on the tensor cores
# (lstm_fwd: its per-tick product, f32 by 3xTF32 too; lstm_bwd: its dWh
# product; flash_bwd_dkv: the flash_bwd library, both backward passes),
# and the kernels whose rows also carry device times
# (every conv kernel: their walls at the path shapes are bound by the
# wrappers' host work; the flash kernels, beside SDPA's; the LSTM kernels'
# rows always carry them, beside cuDNN's layer)
MMA_SOURCES = ("fused_mm", "fused_c3", "fused_mm_bwd", "fused_c3_bwd",
               "lstm_fwd", "lstm_bwd", "flash_fwd", "flash_bwd_dkv")
DEVICE_TIMED = ("fused_mm", "fused_c3", "fused_mm_bwd", "fused_c3_bwd",
                "fused_c3_bwd_in", "fused_c3_bwd_w", "flash_fwd",
                "flash_bwd_dkv", "flash_bwd_dq")
FORWARD = ("fused_mm", "fused_c3")
BACKWARD = ("fused_mm_bwd", "fused_c3_bwd", "fused_c3_bwd_in",
            "fused_c3_bwd_w")
TRAIN_BATCH, TRAIN_K, TRAIN_CALLS = 128, 4, 6     # 24 steps
N_REQUESTS = 64          # requests of 1-48 rows from four client threads
SLICE = dict(num_classes=200, height=64, width=64, channels=3,
             fused_blocks=True, fused_impl="pallas", s2d_stem=True,
             compute_dtype="bfloat16")
# the LSTM kernels' shapes (T, N, H): the slice (TextGenerationLSTM at
# batch 128), the repo's LSTM throughput geometry
# (benchmarks/baseline_suite.py:381-446), a TBPTT segment of rnn_tbptt
# (50 ticks of a batch of 32) and the imported Keras LSTM fixture of
# keras_import (k1_lstm: 7 ticks, 4 rows, 8 units)
LSTM_SHAPES = {"slice": (60, 128, 256), "benchmark": (128, 256, 512),
               "tbptt": (50, 32, 256), "keras": (7, 4, 8)}
# LSTM kernel vs plain version, |diff| relative to max(1, max|ref|) per
# output: f32 1e-4 (the same f32 products summed in another order, carried
# through T ticks); bf16 3e-2 (a sum-order difference can flip one bf16
# rounding of h, ~4e-3 at |h| < 1, and the flipped value feeds every later
# tick)
LSTM_TOL = {"float32": 1e-4, "bfloat16": 3e-2}
# the f32 pretrained model through the kernels vs the plain path: softmax
# probabilities |diff| <= 1e-4, in scoring and at every generation step;
# a differing argmax is allowed only where the plain top-2 gap is below it
LSTM_PROB_TOL = 1e-4
LSTM_SERVE_WINDOWS, GEN_PROMPT, GEN_CHARS = 128, 20, 200
# the generation engine (generate): the committed model, f32, 8 slots;
# 16 corpus prompts of 20 chars, 32 new tokens each (cut from 128 in PR
# 24, with the time of phase 26), staggered; greedy
# streams must equal reference_decode's up to the oracle's first near tie
# (top-2 probability gap < LSTM_PROB_TOL); every mode against plain
# decode bitwise; the int8 head's gate at a top-1 budget of 0.03
GEN_SLOTS, GEN_STREAMS, GEN_PROMPT_CHARS, GEN_NEW = 8, 16, 20, 32
GEN_CHUNK, GEN_SPEC_K, GEN_LONG_PROMPT, GEN_SEED = 64, 3, 150, 11
GEN_INT8_BUDGET = 0.03
# serve_http: the ResNet50 zip over /api/predict (the fixed sizes, then
# four clients of SERVE_PER_CLIENT requests of 1-32 images), the HTTP
# latency at 1 and 32 images over SERVE_LATENCY_REPS requests, the
# TextGenerationLSTM zip's predict on SERVE_WINDOWS one-hot windows (each
# row within LSTM_SERVE_TOL of its largest probability of model.output:
# the same f32 forward, whose cuBLAS input projection may take another
# algorithm at the served bucket), and the subprocess's --duration
# (PR 24 cut the clients' requests from 16 to 8 and the latency requests
# from 20 to 10, with the time of phase 26)
SERVE_SIZES, SERVE_CLIENTS, SERVE_PER_CLIENT = (1, 7, 32, 45), 4, 8
SERVE_LATENCY_REPS, SERVE_WINDOWS, SERVE_DURATION = 10, 8, 30
SERVE_SEED, LSTM_SERVE_TOL = 13, 1e-5
# training: seed 123, batch 128 x 60, Adam(2e-3) + clip 5, K = 4 steps per
# call, 24 steps; one f32 step's gradients through the kernels vs the plain
# versions within relative L2 1e-3 per parameter (the same f32 products
# summed in other orders through 60 ticks, with no BN or ReLU to amplify
# them as in the ResNet check above; the loss within LOSS_RTOL)
LSTM_TRAIN_BATCH, LSTM_TRAIN_K, LSTM_TRAIN_CALLS = 128, 4, 6
LSTM_GRAD_RTOL = 1e-3
# rnn_tbptt: the TextGenerationLSTM configuration (f32, seed 123,
# Adam(2e-3) + clip 5) trained by truncated BPTT in segments of TBPTT_K on
# batches of TBPTT_BATCH corpus windows of TBPTT_CHARS (the lengths of
# dl4j-examples' LSTMCharModellingExample: sequences of 1000, truncation
# 50, batch 32), TBPTT_BATCHES of them, then one of TBPTT_RAGGED chars (a
# ragged tail of 20). The kernels' segment chain on one batch against the
# plain versions' chain from the same init: the first segment's loss
# within LOSS_RTOL and its gradients within LSTM_GRAD_RTOL (relative L2);
# every segment's loss, the carries each hands on and the parameters after
# the batch within max(floor, CHAIN_NOISE x the plain f32 chain's own
# distance from the same chain in float64). Adam compounds the f32
# summation-order noise of one segment into the next segment's
# parameters, so a fixed bound cannot hold for any two f32
# implementations over 20 steps (the ResNet check's reasoning, above);
# two f32 chains each within e of the exact one differ by at most 2e. The
# noise is taken against float64 and not, as for the ResNet, from permuted
# batch rows: permuting the rows changes the order of the sums over rows
# (dW) but not of each row's h @ Wh, the sum in which the kernels differ
# from torch.matmul (an H100 read the permuted plain chain 9x nearer the
# plain chain than the kernels' chain). The kernels' own e is larger than
# the plain chain's by KERNEL_EPS: lstm_fwd's sigmoid and tanh come from
# __expf and __fdividef, within 1e-6 of expf and tanhf (lstm_fwd.cu:413),
# about 8 f32 ulps at 1 where torch's are within one, and every tick of
# every segment carries that into h and c; the bounds scale by it. A lost
# carry or a wrong mask moves them by O(1).
TBPTT_K, TBPTT_BATCH, TBPTT_CHARS = 50, 32, 1000
TBPTT_BATCHES, TBPTT_RAGGED = 8, 1020
CHAIN_FLOOR = {"loss": LOSS_RTOL, "carry": 1e-4, "param": 1e-4}
CHAIN_NOISE, KERNEL_EPS = 3.0, 1e-6 / 2.0 ** -23
# streaming (rnn_time_step in segments, or a tick at a time) against
# output() on the whole sequence: each row within max(LSTM_SERVE_TOL,
# CHAIN_NOISE x the larger of the plain path's own difference between the
# two ways and the kernels' difference from the plain path on the whole
# sequence): lstm_fwd_plan may take another route at T 50 (or 1) than at
# T 1000, and f32 sums in another order drift over 1000 ticks
# the layer family at the TextGenerationLSTM's width: FAMILY_BATCH x
# FAMILY_T one-hot corpus windows with a right-padded ragged mask; the
# streaming graph of examples/streaming_rnn_and_pretrained.py at width 256
# (GRAPH_N x GRAPH_T, TBPTT segments of GRAPH_K, GRAPH_FITS fits); the
# generation engine over 2 x GravesLSTM(256) + the head, GRAVES_STREAMS
# greedy streams of GRAVES_NEW tokens
FAMILY_BATCH, FAMILY_T, FAMILY_H = 32, 60, 256
GRAPH_N, GRAPH_T, GRAPH_K, GRAPH_FITS = 64, 24, 8, 4
GRAVES_STREAMS, GRAVES_NEW = 8, 64
ATTN_KERNELS = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")
# the flash kernels' shapes (N, T, H, Dh): the BERT-base slice at the
# serving batch (and, further down, at the train batch), the long-sequence
# geometry of benchmarks/attn_crossover.py:55-56 ((N, T), H 12, Dh 64) and
# one edge
ATTN_SLICE = (64, 128, 12, 64)
ATTN_LONG = ((16, 1024), (8, 2048), (4, 4096))
ATTN_EDGE = (2, 37, 3, 16)
# the imported Keras attention fixture (k3_attention: 3 heads x Dh 4 over
# 10 steps, batch 4), a shape the BERT geometry never gives the kernels
ATTN_KERAS = (4, 10, 3, 4)
# flash kernel vs plain version, |diff| relative to max(1, max|ref|):
# f32 2e-5 (tests/test_pallas_kernels.py's bound: the same f32 products
# summed in another order); bf16 2^-7, one bf16 ulp at the largest
# magnitude (the same f32 values, then one rounding that a last-bit
# difference can flip); lse (f32 in both) 2e-5
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -7}
# the BERT-base geometry (benchmarks/baseline_suite.py:159-213, widths of
# modelimport/bert.py:27-28): 12 pre-LN blocks of width 768 with 12 heads,
# vocabulary 30522, sequence 128; random weights from seed 123
BERT = dict(vocab=30522, width=768, heads=12, blocks=12, seq=128)
BERT_SEED = 123
BERT_SERVE_BATCH = 64
BERT_TRAIN_BATCH, BERT_TRAIN_K, BERT_TRAIN_CALLS = 32, 4, 6   # 24 steps
# the f32 stack through the kernels vs the plain versions: each position's
# probabilities within BERT_PROB_TOL of that position's largest probability
# (an absolute limit would sit above the mean probability 1/30522, so it is
# relative to the row; 5e-5 is about 12x the 4.04e-06 measured on an H100,
# a forward that ignores the key mask reads 0.958); one train step's loss
# within LOSS_RTOL and each parameter's gradient within relative L2 1e-4
# (the same f32 products summed in other orders through 12 blocks; no ReLU
# masks or max-pool choices to amplify them, unlike the ResNet check)
BERT_PROB_TOL, BERT_GRAD_RTOL = 5e-5, 1e-4
# the digits slice (LeNet, SimpleCNN): card probabilities against the same
# port model on the CPU within DIGITS_PROB_TOL of each row's largest (f32
# convolutions summed in other orders by cuDNN and the CPU); parameters
# after the same steps (card vs CPU, or k_steps=4 vs 1 on the card) within
# DIGITS_PARAM_TOL of each array's largest (ROADMAP's f32 bound for
# post-step parameters)
DIGITS_PROB_TOL, DIGITS_PARAM_TOL = 1e-5, 1e-4
DIGITS_EPOCHS, DIGITS_BATCH = 12, 64
DIGITS_ACC = {"LeNet": 0.98, "SimpleCNN": 0.95}
# zoo: the bench ResNet50 (bench.py:46-56: 64x64x3, 200 classes, bf16,
# s2d stem) in the two new arms, trained like the train phase's pallas arm
# (Nesterovs(1e-2, 0.9), batch TRAIN_BATCH, K = TRAIN_K, TRAIN_CALLS
# calls); VGG16 at benchmarks/baseline_suite.py:32-64 (64x64x3, 200
# classes, bf16) trained in VGG_CALLS K-step calls of VGG_BATCH and served
# at every bucket; YOLO2 at 416x416x3 (20 classes, the VOC anchors, f32)
# trained by Adam on one batch of YOLO_BATCH for YOLO_STEPS steps; the
# other zoo models at their defaults on ZOO_ROWS rows; the digit LeNet's
# transfer over TRANSFER_EPOCHS epochs. The card's f32 output against the
# same model on the CPU: each row within max(ZOO_FLOOR, ZOO_NOISE x the
# card's own noise: the rows reversed, and each row alone, against the
# batch) of the row's largest magnitude
ZOO_BENCH = dict(num_classes=200, height=64, width=64, channels=3,
                 s2d_stem=True, compute_dtype="bfloat16")
ZOO_ARMS = {"xla": dict(fused_blocks=True, fused_impl="xla"),
            "unfused": dict(fused_blocks=False)}
VGG = dict(num_classes=200, height=64, width=64, compute_dtype="bfloat16")
VGG_BATCH, VGG_CALLS = 512, 6      # the suite's batch
YOLO = dict(num_classes=20, height=416, width=416)
# YOLO2's default Adam(1e-3) diverges from random weights: its first step
# moves each of the head's 1024 input weights of a box by ±1e-3 together,
# shifting the raw outputs by up to ~1 and exp(tw) by a factor e (an
# H100 read 2535 -> 1.0e9 in one step); 1e-5 is a warm-up rate
YOLO_BATCH, YOLO_STEPS, YOLO_LR = 8, 12, 1e-5
ZOO_OTHERS = ("AlexNet", "VGG19", "Darknet19", "TinyYOLO", "GoogLeNet",
              "InceptionResNetV1", "FaceNetNN4Small2")
ZOO_ROWS, ZOO_FLOOR, ZOO_NOISE = 2, 1e-4, 3.0
TRANSFER_EPOCHS = 3


_RUN_LOG = None      # the run's own log file (main opens it)


def log(msg=""):
    print(msg, flush=True)
    if _RUN_LOG is not None:
        _RUN_LOG.write(f"{msg}\n")
        _RUN_LOG.flush()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_report(text):
    """[(entry function, registers, "stores/loads" spill bytes)] from the
    ``-Xptxas -v`` output of one build."""
    import re
    rows, fn, spills = [], "?", "?"
    for line in text.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        regs = re.search(r"Used (\d+) registers", line)
        if entry:
            fn = entry.group(1)
        elif spill:
            spills = f"{spill.group(1)}/{spill.group(2)}"
        elif regs:
            rows.append((fn, int(regs.group(1)), spills))
            spills = "?"
    return rows


def hmma_counts(cuda_build, sources):
    """{kernel: {function: HMMA instructions}} in the SASS of the library
    that holds each kernel (``cuobjdump -sass``), the proof that its
    tensor-core kernels use the tensor cores; raises if a library has none.
    Logs "not measured" where the toolkit has no cuobjdump."""
    import shutil
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        log("  HMMA count: not measured (no cuobjdump)")
        return None
    out = {}
    for src in sources:
        sass = subprocess.run([tool, "-sass", str(cuda_build.library_path(
            cuda_build.SOURCE_OF[src]))], capture_output=True, text=True,
            check=True, timeout=120).stdout
        counts, fn = {}, "?"
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :")[1].strip()
            elif "HMMA" in line:
                counts[fn] = counts.get(fn, 0) + 1
        out[src] = counts
        log(f"  {src}: {sum(counts.values())} HMMA in SASS: " + ", ".join(
            f"{f[:48]} {n}" for f, n in counts.items()))
        if not counts:
            raise AssertionError(f"{src}: no HMMA instruction in its SASS")
    return out


def cuda_time(fn, iters=20, warmup=3):
    """Mean ms of ``fn()`` on the card (CUDA events around ``iters``)."""
    import torch
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def path_calls(conf, batch):
    """{call: count} of the fused-conv launches of one forward."""
    from deeplearning4j_tpu_torch.nn.layers.fused import FusedBottleneckBlock
    calls = {}
    for node in conf.nodes:
        if isinstance(node.layer, FusedBottleneckBlock):
            it = conf.layer_input_type(node.name)
            for c in node.layer.kernel_calls(it, batch):
                calls[c] = calls.get(c, 0) + 1
    return calls


def call_macs(call):
    """Multiply-adds of one product of the call (x·W, or dx or dW of its
    backward): a 3×3 SAME tap that falls outside the image multiplies a
    zero and is not counted, so an image row or column of h pixels has
    3h − 2 inside taps (all 9 taps per pixel only far from the border)."""
    n, h, w, cin = call.x_shape
    cout = call.w_shape[-1]
    if call.kernel == "fused_c3":              # stride 1
        return n * (3 * h - 2) * (3 * w - 2) * cin * cout
    return n * -(-h // call.stride) * -(-w // call.stride) * cin * cout


def call_cost(call, dtype):
    """(flops, bytes) the call must do: each input read once (the rows a
    strided 1×1 needs), each output written once."""
    n, h, w, cin = call.x_shape
    cout = call.w_shape[-1]
    isz = 2 if dtype == "bfloat16" else 4
    ho, wo = -(-h // call.stride), -(-w // call.stride)
    m = n * ho * wo
    k = cin * (9 if call.kernel == "fused_c3" else 1)
    flops = 2.0 * call_macs(call)
    x_bytes = (n * h * w * cin if call.kernel == "fused_c3" else m * cin)
    nbytes = isz * (x_bytes + k * cout + m * cout) + 4 * (2 * cin + 2 * cout)
    return flops, nbytes


def check_kernel_call(call, dtype, gen):
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops import fused_conv as fc
    dt = getattr(torch, dtype)
    cin = call.x_shape[3]
    fan_in = cin * (9 if call.kernel == "fused_c3" else 1)
    x = torch.randn(call.x_shape, generator=gen, device="cuda").to(dt)
    w = (torch.randn(call.w_shape, generator=gen, device="cuda")
         * math.sqrt(2.0 / fan_in)).to(dt)
    s = 1.0 + 0.1 * torch.randn(cin, generator=gen, device="cuda")
    b = 0.1 * torch.randn(cin, generator=gen, device="cuda")
    args = (x, w, s, b, call.relu_in, call.norm_in, call.stride)

    with torch.inference_mode():
        y, st = fc.fused_conv_bn_act(*args)
        again = fc.fused_conv_bn_act(*args)
        yr, str_ = fc._conv_reference(*args)
        torch.cuda.synchronize()
        rtol, atol = Y_TOL[dtype]
        dy = (y.float() - yr.float()).abs()
        y_ok = bool((dy <= atol + rtol * yr.float().abs()).all())
        ds = (st - str_).abs().max().item()
        s_ok = ds <= STATS_RTOL * str_.abs().max().item() + STATS_ATOL
        res = {"kernel": call.kernel, "dtype": dtype,
               "x": list(call.x_shape), "w": list(call.w_shape),
               "stride": call.stride, "norm_in": call.norm_in,
               "max_abs_err": dy.max().item(), "stats_max_abs_err": ds,
               "ok": y_ok and s_ok,
               "bitwise_repeat": (torch.equal(y, again[0])
                                  and torch.equal(st, again[1]))}

        # the yardstick's operands in cuDNN's layout, made once outside
        # the timed call: x as a channels_last view, W copied to match
        e = fc._norm_in(x, s, b, call.relu_in, call.norm_in)
        e_nchw = e.permute(0, 3, 1, 2)
        w_oihw = (w.reshape(1, 1, *w.shape) if w.ndim == 2 else w) \
            .permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
        pad = 1 if call.kernel == "fused_c3" else 0

        # timed as the served path calls it (inference: no statistics);
        # the library yardstick is cuDNN's conv of the normalized input
        path_args = args + (False,)
        res["ms"] = cuda_time(lambda: fc.fused_conv_bn_act(*path_args))
        res["ms_with_stats"] = cuda_time(lambda: fc.fused_conv_bn_act(*args))
        res["plain_ms"] = cuda_time(lambda: fc._conv_reference(*path_args))
        library = lambda: F.conv2d(e_nchw, w_oihw, stride=call.stride,
                                   padding=pad)
        res["library_ms"] = cuda_time(library)
        if call.kernel in DEVICE_TIMED:
            res["device_ms"], res["launches_per_call"] = device_trace(
                lambda: fc.fused_conv_bn_act(*path_args))
            res["library_device_ms"] = device_ms(library)
    flops, nbytes = call_cost(call, dtype)
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    res["bound_ms"] = 1e3 * max(t_ops, t_bytes)
    res["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
    return res


def bwd_cost(call, dtype, part="both"):
    """(flops, bytes) of a backward call: dx and dW products 2·macs each
    (``call_macs``: the taps inside the image); dy, y, x and W read once,
    dx (x's full shape) and the f32 dW written once, plus the per-channel
    vectors. ``part`` "dx" or "dw" counts one launch of the split route."""
    n, h, w, cin = call.x_shape
    cout = call.w_shape[-1]
    isz = 2 if dtype == "bfloat16" else 4
    ho, wo = -(-h // call.stride), -(-w // call.stride)
    m = n * ho * wo
    k = cin * (9 if call.kernel == "fused_c3" else 1)
    x_rows = n * h * w if call.kernel == "fused_c3" else m
    reads = isz * (2 * m * cout + x_rows * cin) + 4 * (2 * cout + 2 * cin)
    dx = isz * (n * h * w * cin + k * cout) + 4 * 2 * cin
    dw = 4 * k * cout
    flops = {"both": 4.0, "dx": 2.0, "dw": 2.0}[part] * call_macs(call)
    nbytes = reads + {"both": dx + dw, "dx": dx, "dw": dw}[part]
    return flops, nbytes


def bound(flops, nbytes, dtype):
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _max_err(got, ref):
    return max((a.float() - r.float()).abs().max().item()
               for a, r in zip(got, ref))


def _bwd_ok(got, ref, dtype, with_dx):
    """dx elementwise (DX_TOL), the f32 sums against their largest entry;
    ``with_dx`` False: every output is a sum (the dW launch)."""
    ok = True
    for i, (a, r) in enumerate(zip(got, ref)):
        a, r = a.float(), r.float()
        d, big = (a - r).abs(), r.abs().max().item()
        if i == 0 and with_dx:
            rtol, atol = DX_TOL[dtype]
            ok &= bool((d <= atol * big + rtol * r.abs()).all())
        else:
            ok &= d.max().item() <= SUM_RTOL * big + SUM_ATOL
    return ok


def check_backward_call(call, dtype, gen):
    """Rows for the backward of one path call: ``fused_mm_bwd`` for a 1×1
    call; ``fused_c3_bwd``, ``fused_c3_bwd_in`` and ``fused_c3_bwd_w`` for
    a 3×3 call (both routes)."""
    import torch
    from deeplearning4j_tpu_torch.ops import fused_conv as fc
    dt = getattr(torch, dtype)
    n, h, w, cin = call.x_shape
    cout = call.w_shape[-1]
    fan_in = cin * (9 if call.kernel == "fused_c3" else 1)
    x = torch.randn(call.x_shape, generator=gen, device="cuda").to(dt)
    wt = (torch.randn(call.w_shape, generator=gen, device="cuda")
          * math.sqrt(2.0 / fan_in)).to(dt)
    s = 1.0 + 0.1 * torch.randn(cin, generator=gen, device="cuda")
    b = 0.1 * torch.randn(cin, generator=gen, device="cuda")
    ho, wo = -(-h // call.stride), -(-w // call.stride)
    dy = torch.randn((n, ho, wo, cout), generator=gen, device="cuda").to(dt)
    y = torch.randn((n, ho, wo, cout), generator=gen, device="cuda").to(dt)
    dst = 1e-3 * torch.randn((2, cout), generator=gen, device="cuda")
    flags = (call.relu_in, call.norm_in)

    # the library yardstick's inputs, made once outside the timed call:
    # dyc and the normalized input (channels_last views for cuDNN, W
    # copied to match, so the timed call holds no layout copy)
    xs = x[:, ::call.stride, ::call.stride] if call.stride != 1 else x
    dyc = fc._dyc(dy, y, dst)
    e = fc._norm_in(xs, s, b, *flags)
    if call.kernel == "fused_mm":
        d2, e2, wtt = dyc.reshape(-1, cout), e.reshape(-1, cin), wt.t()
        library = {"both": lambda: (torch.matmul(d2, wtt),
                                    torch.matmul(e2.t(), d2))}
        runs = {"fused_mm_bwd": (
            "both", True, lambda: fc.fused_mm_bwd(dy, y, x, wt, dst, s, b,
                                                  *flags, call.stride),
            lambda: fc.fused_mm_bwd_reference(dy, y, x, wt, dst, s, b,
                                              *flags, call.stride))}
    else:
        dyc_c, e_c = (t.permute(0, 3, 1, 2) for t in (dyc, e))
        w_oihw = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        conv_bwd = lambda mask: lambda: torch.ops.aten.convolution_backward(
            dyc_c, e_c, w_oihw, None, [1, 1], [1, 1], [1, 1], False, [0, 0],
            1, mask)
        library = {"both": conv_bwd([True, True, False]),
                   "dx": conv_bwd([True, False, False]),
                   "dw": conv_bwd([False, True, False])}
        args = (dy, y, x, wt, dst, s, b, *flags)
        wargs = (dy, y, x, dst, s, b, *flags)
        runs = {
            "fused_c3_bwd": ("both", True, lambda: fc.fused_c3_bwd(*args),
                             lambda: fc.fused_c3_bwd_reference(*args)),
            "fused_c3_bwd_in": ("dx", True, lambda: fc.fused_c3_bwd_in(*args),
                                lambda: fc.fused_c3_bwd_in_reference(*args)),
            "fused_c3_bwd_w": ("dw", False,
                               lambda: (fc.fused_c3_bwd_w(*wargs),),
                               lambda: (fc.fused_c3_bwd_w_reference(*wargs),)),
        }
    rows = []
    for name, (part, with_dx, kern, plain) in runs.items():
        got, again, ref = kern(), kern(), plain()
        torch.cuda.synchronize()
        row = {"kernel": name, "dtype": dtype, "x": list(call.x_shape),
               "w": list(call.w_shape), "stride": call.stride,
               "norm_in": call.norm_in, "max_abs_err": _max_err(got, ref),
               "ok": _bwd_ok(got, ref, dtype, with_dx),
               "bitwise_repeat": all(torch.equal(a, c)
                                     for a, c in zip(got, again))}
        row["ms"] = cuda_time(kern)
        row["plain_ms"] = cuda_time(plain)
        row["library_ms"] = cuda_time(library[part])
        if name in DEVICE_TIMED:
            row["device_ms"], row["launches_per_call"] = device_trace(kern)
            row["library_device_ms"] = device_ms(library[part])
        row["bound_ms"], row["bound_by"] = bound(*bwd_cost(call, dtype, part),
                                                 dtype)
        rows.append(row)
    return rows


def _device_note(row):
    return ("" if "device_ms" not in row else
            f" device={row['device_ms']:.4f} lib_device="
            f"{row['library_device_ms']:.4f} launches="
            f"{row['launches_per_call']:g}")


def _summary(name, rows, launches=None):
    """One kernel's line: per bf16 train step (or served forward) at batch
    32, the sum over the path's calls of (value per call x calls)."""
    rs = [r for r in rows if r["kernel"] == name and r["dtype"] == "bfloat16"
          and r["on_path"] and r["batch"] == 32]
    tot = lambda key: sum(r[key] * r["per_step"] for r in rs)
    by_ops = sum(r["bound_ms"] * r["per_step"] for r in rs
                 if r["bound_by"] == "operations")
    out = {"name": name, "route": "cuda", "source": SOURCES[name],
           "replaces": REPLACES[name],
           "per_step": sum(r["per_step"] for r in rs),
           "max_abs_err": max(r["max_abs_err"] for r in rows
                              if r["kernel"] == name),
           "ms": tot("ms"), "plain_ms": tot("plain_ms"),
           "bound_ms": tot("bound_ms"),
           "bound_by": ("operations" if by_ops >= tot("bound_ms") / 2
                        else "bytes"),
           "library_ms": tot("library_ms")}
    if name in FORWARD:
        out["ms_with_stats"] = tot("ms_with_stats")
    if rs and all("device_ms" in r for r in rs):
        out["device_ms"] = tot("device_ms")
        out["library_device_ms"] = tot("library_device_ms")
    return out


def route_table(rows):
    """The two 3×3 backward routes per shape at batch 32 and the train
    batch: one call of ``fused_c3_bwd`` against ``fused_c3_bwd_in`` +
    ``fused_c3_bwd_w``, wall and device ms (logged; the route rule is
    ``fc._backward``'s)."""
    out = []
    by = {(r["kernel"], r["dtype"], tuple(r["x"])): r for r in rows
          if r["batch"] in (32, TRAIN_BATCH)}
    for (kern, dtype, x), r in by.items():
        if kern != "fused_c3_bwd":
            continue
        i, w = by[("fused_c3_bwd_in", dtype, x)], by[("fused_c3_bwd_w",
                                                       dtype, x)]
        row = {"dtype": dtype, "x": list(x), "merged_ms": r["ms"],
               "split_ms": i["ms"] + w["ms"],
               "merged_device_ms": r["device_ms"],
               "split_device_ms": i["device_ms"] + w["device_ms"],
               "on_path": "merged" if r["on_path"] else "split"}
        out.append(row)
        log(f"  route {dtype:8s} x={x}: merged {row['merged_ms']:.4f} ms "
            f"(device {row['merged_device_ms']:.4f}), split "
            f"{row['split_ms']:.4f} ms (device "
            f"{row['split_device_ms']:.4f}); the path takes {row['on_path']}")
    return out


def _merged(fc, call):
    """Whether the train path takes the one-call 3×3 backward route for
    ``call`` (fc._backward's rule)."""
    return call.x_shape[3] <= fc.C3_MERGED_MAX_CIN and call.norm_in


def phase_kernels(report):
    import torch
    from deeplearning4j_tpu_torch.ops import fused_conv as fc
    from deeplearning4j_tpu_torch.zoo.models import ResNet50
    conf = ResNet50(**SLICE).conf()
    calls = path_calls(conf, 32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    # the train phase's own batch: every 3×3 call (both routes, f32 and
    # bf16) and every 1×1 call (bf16, forward and backward)
    train_calls = path_calls(conf, TRAIN_BATCH)
    forward = [(call, count, 32, dtype) for call, count in calls.items()
               for dtype in ("float32", "bfloat16")]
    forward += [(call, count, TRAIN_BATCH, "bfloat16")
                for call, count in train_calls.items()
                if call.kernel == "fused_mm"]
    for call, count, batch, dtype in forward:
        r = check_kernel_call(call, dtype, gen)
        r.update(per_step=count, on_path=True, batch=batch)
        rows.append(r)
        log(f"  {r['kernel']:15s} {dtype:8s} x={tuple(r['x'])} "
            f"w={tuple(r['w'])} s={r['stride']} norm={int(r['norm_in'])}"
            f" err={r['max_abs_err']:.3g} stats_err="
            f"{r['stats_max_abs_err']:.3g} ms={r['ms']:.4f} "
            f"stats_ms={r['ms_with_stats']:.4f} "
            f"plain={r['plain_ms']:.4f} lib={r['library_ms']:.4f} "
            f"bound={r['bound_ms']:.4f} ({r['bound_by']})"
            f"{_device_note(r)}"
            f"{'' if r['ok'] else '  <-- DISAGREES'}"
            f"{'' if r['bitwise_repeat'] else '  <-- NOT BITWISE'}")
    backward = [(call, count, 32) for call, count in calls.items()]
    backward += [(call, count, TRAIN_BATCH)
                 for call, count in train_calls.items()]
    for call, count, batch in backward:
        merged = _merged(fc, call)
        dtypes = (("bfloat16",) if batch == TRAIN_BATCH
                  and call.kernel == "fused_mm" else ("float32", "bfloat16"))
        for dtype in dtypes:
            for r in check_backward_call(call, dtype, gen):
                r["per_step"] = count
                r["batch"] = batch
                r["on_path"] = (r["kernel"] == "fused_mm_bwd" or merged ==
                                (r["kernel"] == "fused_c3_bwd"))
                rows.append(r)
                log(f"  {r['kernel']:15s} {dtype:8s} x={tuple(r['x'])} "
                    f"w={tuple(r['w'])} s={r['stride']} "
                    f"norm={int(r['norm_in'])} path={int(r['on_path'])} "
                    f"err={r['max_abs_err']:.3g} ms={r['ms']:.4f} "
                    f"plain={r['plain_ms']:.4f} lib={r['library_ms']:.4f} "
                    f"bound={r['bound_ms']:.4f} ({r['bound_by']})"
                    f"{_device_note(r)}"
                    f"{'' if r['ok'] else '  <-- DISAGREES'}"
                    f"{'' if r['bitwise_repeat'] else '  <-- NOT BITWISE'}")
    report["kernel_calls"] = rows
    report["c3_routes"] = route_table(rows)
    bad = [r for r in rows if not r["ok"] or not r.get("bitwise_repeat",
                                                        True)]
    if bad:
        raise AssertionError(f"{len(bad)} kernel calls disagree with the "
                             "plain version beyond tolerance or differ "
                             "between two runs")
    summary = {name: _summary(name, rows) for name in FORWARD + BACKWARD}
    for name, k in summary.items():
        log(f"  {name:15s} per bf16 step at batch 32: {k['ms']:.4f} ms "
            f"(library {k['library_ms']:.4f}), device "
            f"{k.get('device_ms', math.nan):.4f} (library "
            f"{k.get('library_device_ms', math.nan):.4f}), bound "
            f"{k['bound_ms']:.4f}")
    report["kernels"] = summary
    return summary


# ---------------------------------------------------------------------------
# phase 4: the served slice
# ---------------------------------------------------------------------------

def nontrivial_bn(model, seed=0):
    """Running statistics (and BN affine params) from numpy, so the
    random-weight network keeps O(1) activations: the residual branches'
    last BN (bn3, bnds) gets a small gamma."""
    import numpy as np
    rng = np.random.default_rng(seed)
    params = {ln: {k: v.float().cpu().numpy() for k, v in lp.items()}
              for ln, lp in model.params.items()}
    state = {ln: {k: v.cpu().numpy() for k, v in st.items()}
             for ln, st in model.model_state.items()}
    for st in state.values():
        for k, v in st.items():
            if k.endswith("mean"):
                st[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            elif k.endswith("var"):
                st[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    for lp in params.values():
        for k, v in lp.items():
            if k in ("bn3_gamma", "bnds_gamma"):
                lp[k] = rng.uniform(0.2, 0.4, v.shape).astype(np.float32)
            elif k.endswith("gamma"):
                lp[k] = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
            elif k.endswith("beta"):
                lp[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
    return params, state


def plain_kernels():
    """Every kernel wrapper of ops/fused_conv.py patched to its plain
    version (the forward and the backward of ``fused_conv_bn_act``)."""
    import contextlib
    from deeplearning4j_tpu_torch.ops import fused_conv as fc
    plain = {"fused_mm": fc.fused_mm_reference,
             "fused_c3": fc.fused_c3_reference,
             "fused_mm_bwd": fc.fused_mm_bwd_reference,
             "fused_c3_bwd": fc.fused_c3_bwd_reference,
             "fused_c3_bwd_in": fc.fused_c3_bwd_in_reference,
             "fused_c3_bwd_w": fc.fused_c3_bwd_w_reference}
    stack = contextlib.ExitStack()
    for name, ref in plain.items():
        stack.enter_context(mock.patch.object(fc, name, ref))
    return stack


def profile_calls(fn, card, what, n=10, warmup=3):
    """Device time by kernel over ``n`` calls of ``fn`` (torch.profiler),
    beside their wall time: the device's busy share of one call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "cuda_time_total", 0.0)
        if dev_us > 0 and ev.device_type.name == "CUDA":
            rows.append((ev.key, dev_us / n / 1e3, ev.count // n))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"  profile over {n} {what} [{card}]: wall {wall_ms:.3f} ms/call, "
        f"device kernels {busy:.3f} ms/call (busy "
        f"{100 * busy / wall_ms:.1f}%)")
    for key, ms, count in rows[:16]:
        log(f"    {ms:8.4f} ms  x{count:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_ms": busy,
            "kernels": [{"name": k, "ms": m, "per_call": c}
                        for k, m, c in rows]}


def phase_slice(report, card, profile=False):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.serialization import params_from_jax
    from deeplearning4j_tpu_torch.ops import fused_conv as fc
    from deeplearning4j_tpu_torch.parallel.serving import ServingEngine
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    t0 = time.perf_counter()
    model = ResNet50(**SLICE).init()           # cuda, seeded generator
    params_np, state_np = nontrivial_bn(model)
    params_from_jax(params_np, state_np, model.device, model=model)
    calls = path_calls(model.conf, 1)
    per_fwd = {k: sum(n for c, n in calls.items() if c.kernel == k)
               for k in FORWARD}
    log(f"  model: {model.num_params()} params on {model.device}, "
        f"{per_fwd} launches per forward, init {time.perf_counter() - t0:.1f}s")

    torch.cuda.reset_peak_memory_stats()
    engine = ServingEngine(model, batch_limit=32, feature_shape=(64, 64, 3),
                           precision="bf16")
    log(f"  engine: ladder {engine.ladder}, warmup "
        f"{engine.warmup_seconds:.2f}s")
    rng = np.random.default_rng(1)
    sizes = rng.integers(1, 49, N_REQUESTS)
    reqs = [rng.normal(0, 1, (int(k), 64, 64, 3)).astype(np.float32)
            for k in sizes]
    answers = [None] * len(reqs)

    def client(idx):
        futs = [(i, engine.submit(reqs[i])) for i in idx]
        for i, f in futs:
            answers[i] = f.result()

    batches0 = engine.dispatch_count
    fc.reset_launch_counts()
    t_start = time.perf_counter()
    threads = [threading.Thread(target=client,
                                args=(range(t, len(reqs), 4),))
               for t in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    t_serve = time.perf_counter() - t_start
    launches = dict(fc.LAUNCHES)
    batches = engine.dispatch_count - batches0
    stats = engine.stats()
    peak = torch.cuda.max_memory_allocated()

    # steady state: full buckets back to back from one client
    full = rng.normal(0, 1, (32, 64, 64, 3)).astype(np.float32)
    n_full = 40
    t1 = time.perf_counter()
    futs = [engine.submit(full) for _ in range(n_full)]
    for f in futs:
        f.result()
    t_full = time.perf_counter() - t1

    # device time of the served forward at batch 32 (kernels and all)
    xb = torch.from_numpy(full).cuda()
    fwd_ms = cuda_time(lambda: engine.forward(xb), iters=10)
    log(f"  served forward at batch 32: {fwd_ms:.3f} ms [{card}]")
    if profile:
        with torch.inference_mode():
            report["profile"] = profile_calls(
                lambda: engine.forward(xb), card,
                "bf16 forwards at batch 32")
    engine.shutdown()

    rows = int(sizes.sum())
    log(f"  served {len(reqs)} requests / {rows} images in {t_serve:.3f}s "
        f"over {batches} batches: {len(reqs) / t_serve:.1f} req/s, "
        f"{rows / t_serve:.1f} img/s, p50 {stats['latency_ms']['p50']:.2f} "
        f"ms, p99 {stats['latency_ms']['p99']:.2f} ms, peak memory "
        f"{peak / 2**20:.1f} MiB [{card}]")
    log(f"  full buckets: {n_full} x 32 images in {t_full:.3f}s: "
        f"{n_full * 32 / t_full:.1f} img/s [{card}]")
    log(f"  launches during traffic: {launches} for {batches} batches")
    for k in FORWARD:
        if launches[k] != per_fwd[k] * batches or launches[k] == 0:
            raise AssertionError(
                f"{k}: {launches[k]} launches for {batches} batches, "
                f"expected {per_fwd[k]} per batch")

    # every answer against model.output on the same rows
    n_bitwise, worst, worst_top = 0, 0.0, 0
    for x, a in zip(reqs, answers):
        ref = model.output(x).float().cpu().numpy()
        if a is None or a.shape != ref.shape or not np.isfinite(a).all():
            raise AssertionError("missing, misshapen or non-finite answer")
        if np.array_equal(a, ref):
            n_bitwise += 1
        worst = max(worst, float(np.abs(a - ref).max()))
        worst_top += int((a.argmax(1) != ref.argmax(1)).sum())
    log(f"  answers vs model.output: {n_bitwise}/{len(reqs)} bitwise, "
        f"max |diff| {worst:.3g}, top-1 disagreements {worst_top}")
    if worst > 5e-3:
        raise AssertionError(f"served answers differ from model.output by "
                             f"{worst} (> 5e-3)")

    # f32 model: kernels vs plain versions on the card
    m32 = ResNet50(**dict(SLICE, compute_dtype="float32")).init()
    m32.set_params(model.params, model.model_state)
    x = torch.from_numpy(reqs[0][:8].copy()).cuda()
    walk = lambda: m32._walk(m32.params, m32.model_state, {"in": x})[0]
    with torch.inference_mode():
        a_k = walk()
        with plain_kernels():
            a_p = walk()
    feat_err = (a_k["avgpool"] - a_p["avgpool"]).abs().max().item()
    feat_max = a_p["avgpool"].abs().max().item()
    prob_err = (a_k["out"] - a_p["out"]).abs().max().item()
    log(f"  f32 kernels vs plain: pooled features |diff| {feat_err:.3g} "
        f"(max |ref| {feat_max:.3g}), probabilities |diff| {prob_err:.3g}")
    if not feat_err <= SLICE_F32_RTOL * (1.0 + feat_max):
        raise AssertionError("f32 slice through the kernels disagrees with "
                             "the plain path")

    report["slice"] = {
        "requests": len(reqs), "images": rows, "batches": batches,
        "seconds": t_serve, "requests_per_s": len(reqs) / t_serve,
        "images_per_s": rows / t_serve, "latency_ms": stats["latency_ms"],
        "full_bucket_images_per_s": n_full * 32 / t_full,
        "forward_ms_b32": fwd_ms, "peak_memory_bytes": peak,
        "launches": launches, "launches_per_forward": per_fwd,
        "bitwise_answers": n_bitwise, "max_answer_diff": worst,
        "f32_feature_diff": feat_err, "f32_prob_diff": prob_err}
    return launches


# ---------------------------------------------------------------------------
# phase 5: training the slice
# ---------------------------------------------------------------------------

def grad_errors(got, ref):
    """Relative L2 errors of gradient dicts: per parameter (worst, its
    name, median) and over all parameters at once."""
    import numpy as np
    from deeplearning4j_tpu_torch.models.serialization import flatten_paths
    errs, num, den = {}, 0.0, 0.0
    got = flatten_paths(got)
    for path, r in flatten_paths(ref).items():
        d = (got[path] - r).double()
        num += float((d * d).sum())
        den += float((r.double() ** 2).sum())
        errs[path] = (d.norm() / r.double().norm().clamp_min(
            1e-30)).item()
    name = max(errs, key=errs.get)
    return {"worst": errs[name], "name": name,
            "median": float(np.median(list(errs.values()))),
            "all": (num / max(den, 1e-300)) ** 0.5}


def phase_train(report, card, profile=False):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.serialization import params_from_jax
    from deeplearning4j_tpu_torch.ops import fused_conv as fc
    from deeplearning4j_tpu_torch.optimize import solver
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    model = ResNet50(**SLICE).init()           # cuda, seeded generator
    params_np, state_np = nontrivial_bn(model)
    params_from_jax(params_np, state_np, model.device, model=model)
    per_step = train_launches_per_step(model, fc)
    log(f"  model: {model.num_params()} params, launches per step "
        f"{per_step}")

    rng = np.random.default_rng(3)
    b, k = TRAIN_BATCH, TRAIN_K
    x = torch.from_numpy(rng.normal(0, 1, (b, 64, 64, 3)).astype(
        np.float32)).cuda()
    y = torch.from_numpy(np.eye(200, dtype=np.float32)[
        rng.integers(0, 200, b)]).cuda()
    xk = x.unsqueeze(0).expand(k, *x.shape).contiguous()
    yk = y.unsqueeze(0).expand(k, *y.shape).contiguous()
    scan = model._build_scan_train_step()

    def call():
        model.train_state, losses = scan(model.train_state, (xk,), (yk,))
        return losses

    fc.reset_launch_counts()
    losses = [call()]
    torch.cuda.synchronize()
    launches = dict(fc.LAUNCHES)
    log(f"  launches over one {k}-step call: {launches}")
    for name, n in per_step.items():
        if launches[name] != k * n:
            raise AssertionError(f"{name}: {launches[name]} launches in one "
                                 f"{k}-step call, expected {k} x {n}")
    losses.append(call())                     # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(TRAIN_CALLS - 2):
        losses.append(call())
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / ((TRAIN_CALLS - 2) * k)
    peak = torch.cuda.max_memory_allocated()
    losses = torch.cat(losses).float().cpu().numpy()
    log(f"  train step at batch {b}: {step_ms:.3f} ms, "
        f"{1e3 * b / step_ms:.1f} images/s, peak memory "
        f"{peak / 2**20:.1f} MiB [{card}]")
    log(f"  losses over {len(losses)} steps: "
        f"{' '.join(f'{v:.4f}' for v in losses)}")
    if not np.isfinite(losses).all() or not losses[1:].min() < losses[0]:
        raise AssertionError("the train loss did not fall (or is not "
                             "finite)")
    if model.iteration != TRAIN_CALLS * k:
        raise AssertionError(f"iteration {model.iteration}")
    if profile:
        report["train_profile"] = profile_calls(
            call, card, f"{k}-step bf16 train calls at batch {b}", n=2,
            warmup=1)

    # f32 at batch 8: the step's gradients through the kernels against
    # the same step on the plain versions, beside each path's own
    # summation-order noise (the same batch with its rows permuted)
    m32 = ResNet50(**dict(SLICE, compute_dtype="float32")).init()
    params_from_jax(params_np, state_np, m32.device, model=m32)
    x8, y8 = x[:8], y[:8]
    perm = torch.from_numpy(rng.permutation(len(x8))).cuda()
    grads = lambda xx, yy: solver.value_and_grad(
        m32._loss, m32.train_state, (xx,), (yy,))
    loss_k, _, g_k = grads(x8, y8)
    _, _, g_kq = grads(x8[perm], y8[perm])
    fc.reset_launch_counts()
    with plain_kernels():
        loss_p, _, g_p = grads(x8, y8)
        _, _, g_q = grads(x8[perm], y8[perm])
    if any(fc.LAUNCHES.values()):
        raise AssertionError("the plain step launched a kernel")
    err_k = grad_errors(g_k, g_p)
    err_q, err_kq = grad_errors(g_q, g_p), grad_errors(g_kq, g_k)
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    log(f"  f32 step at batch 8, kernels vs plain: loss rel {loss_err:.3g}, "
        f"gradients rel L2 worst {err_k['worst']:.3g} ({err_k['name']}), "
        f"median {err_k['median']:.3g}, all {err_k['all']:.3g}")
    for what, e in (("plain", err_q), ("kernels", err_kq)):
        log(f"  {what} vs {what} on permuted rows: worst {e['worst']:.3g}, "
            f"median {e['median']:.3g}, all {e['all']:.3g}")
    for key in ("worst", "all"):
        limit = max(GRAD_RTOL, GRAD_NOISE * max(err_q[key], err_kq[key]))
        if err_k[key] > limit:
            raise AssertionError(f"f32 gradients through the kernels "
                                 f"disagree with the plain path ({key}: "
                                 f"{err_k[key]:.3g} > {limit:.3g})")
    if loss_err > LOSS_RTOL:
        raise AssertionError("f32 loss through the kernels disagrees with "
                             "the plain path")
    report["train"] = {
        "batch": b, "k": k, "steps": len(losses),
        "losses": losses.tolist(), "step_ms": step_ms,
        "images_per_s": 1e3 * b / step_ms, "peak_memory_bytes": peak,
        "launches": launches, "launches_per_step": per_step,
        "f32_loss_rel_err": loss_err, "f32_grad_rel_l2": err_k,
        "f32_grad_rel_l2_plain_permuted": err_q,
        "f32_grad_rel_l2_kernels_permuted": err_kq}
    return launches


# ---------------------------------------------------------------------------
# the LSTM slice (TPU kernels 7-8): kernels, scoring/generation, training
# ---------------------------------------------------------------------------

def plain_lstm():
    """Both fused-LSTM wrappers patched to their plain versions."""
    import contextlib
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(fl, "lstm_fwd",
                                          fl.lstm_fwd_reference))
    stack.enter_context(mock.patch.object(fl, "lstm_bwd",
                                          fl.lstm_bwd_reference))
    return stack


def lstm_cost(t, n, h, dtype, masked, part):
    """(flops, bytes) of one call: every input read once, every output
    written once; the forward's product 2·T·N·H·4H, the backward's two."""
    isz = 2 if dtype == "bfloat16" else 4
    m = t * n if masked else 0
    state = isz * 4 * n * h                 # h0, c0 in; hT, cT out (or d*)
    if part == "lstm_fwd":
        nbytes = isz * (2 * t * n * 4 * h + 3 * t * n * h + h * 4 * h + m)
        return 2.0 * t * n * h * 4 * h, nbytes + state
    nbytes = (isz * (2 * t * n * 4 * h + 4 * t * n * h + h * 4 * h + m)
              + 4 * h * 4 * h)
    return 4.0 * t * n * h * 4 * h, nbytes + state


def barrier_ms(cluster, gx, gy, smem):
    """Mean ms of one barrier on a (gx, gy) grid of blocks with ``smem``
    bytes of shared memory each: a cluster barrier among ``cluster`` blocks
    (cluster > 0) or a grid barrier (a cooperative launch)."""
    import torch
    from deeplearning4j_tpu_torch.ops import cuda_build
    probe = cuda_build.helper("lstm_fwd", "dl4j_lstm_barrier_probe")

    def run(iters):
        err = probe(cluster, gx, gy, smem, iters,
                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"barrier probe failed with CUDA error {err}")
    return (cuda_time(lambda: run(1000), iters=5) -
            cuda_time(lambda: run(0), iters=5)) / 1000


def lstm_floors(t, n, h, dtype):
    """{kernel: (ms of one tick's barrier, what it is)} on each LSTM
    kernel's own grid at (T, N, H): lstm_fwd's plan (a cluster barrier on
    the cluster route) and lstm_bwd's grid barrier."""
    import torch
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bf16 = dtype == "bfloat16"
    fp = fl.lstm_fwd_plan(t, n, h, bf16, sms)
    bp = fl.lstm_bwd_plan(t, n, h, bf16, sms)
    cluster = fp.slices if fp.route == "cluster" else 0
    return {"lstm_fwd": (barrier_ms(cluster, fp.slices, fp.row_tiles,
                                    fp.smem), fp),
            "lstm_bwd": (barrier_ms(0, bp.slices, bp.row_tiles, bp.smem),
                         bp)}


def _lstm_err(got, ref):
    """Largest |kernel - plain| over the outputs, each relative to
    max(1, its largest reference magnitude)."""
    return max((a.float() - r.float()).abs().max().item() /
               max(1.0, r.float().abs().max().item())
               for a, r in zip(got, ref))


def check_lstm_shape(where, t, n, h, dtype, masked, gen, floors):
    """Rows of lstm_fwd and lstm_bwd at one shape: against the plain
    version, bitwise on a second run, timed beside the bound, the latency
    floor (T x the kernel's barrier in ``floors``) and (unmasked) cuDNN's
    LSTM layer."""
    import torch
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    dt = getattr(torch, dtype)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    zx = r(t, n, 4 * h).to(dt)
    wh = (r(h, 4 * h) / math.sqrt(h)).to(dt)
    h0, c0 = (0.5 * r(n, h)).to(dt), (0.5 * r(n, h)).to(dt)
    mask3 = ((torch.rand(t, n, 1, generator=gen, device="cuda") > 0.2)
             .to(dt) if masked else None)
    fargs = (zx, h0, c0, wh, mask3)
    ys, gates, tcs, ccs, _, _ = fl.lstm_fwd_reference(*fargs)
    bargs = (r(t, n, h).to(dt), r(n, h).to(dt), r(n, h).to(dt), gates, tcs,
             torch.cat([c0[None], ccs[:-1]]), torch.cat([h0[None], ys[:-1]]),
             mask3, wh)
    rows = []
    for name, args, plain in (("lstm_fwd", fargs, fl.lstm_fwd_reference),
                              ("lstm_bwd", bargs, fl.lstm_bwd_reference)):
        kern = lambda: getattr(fl, name)(*args)
        got, again, ref = kern(), kern(), plain(*args)
        torch.cuda.synchronize()
        err = _lstm_err(got, ref)
        row = {"kernel": name, "where": where, "dtype": dtype,
               "shape": [t, n, h], "masked": masked, "max_abs_err": err,
               "ok": err <= LSTM_TOL[dtype],
               "bitwise_repeat": all(torch.equal(a, b)
                                     for a, b in zip(got, again)),
               "ms": cuda_time(kern, iters=10),
               "plain_ms": cuda_time(lambda: plain(*args), iters=3,
                                     warmup=1),
               "latency_floor_ms": t * floors[name][0],
               "barrier_ms": floors[name][0],
               "plan": floors[name][1]._asdict(), "library_ms": None,
               "library_device_ms": None}
        row["device_ms"], row["launches_per_call"] = device_trace(kern, n=5)
        row["bound_ms"], row["bound_by"] = bound(
            *lstm_cost(t, n, h, dtype, masked, name), dtype)
        rows.append(row)
    if not masked:
        _cudnn_yardstick(rows, t, n, h, dt, gen)
    return rows


def _cudnn_yardstick(rows, t, n, h, dt, gen):
    """cuDNN's LSTM layer (torch.nn.LSTM, weights permuted from [i|f|o|g]
    to its [i|f|g|o]) against the port's layer (torch.matmul projection +
    lstm_fwd), forward, and its backward alone against lstm_bwd's call:
    library_ms of the two rows. The port never calls cuDNN."""
    import torch
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    x = r(t, n, h).to(dt)
    wx, wh = (r(h, 4 * h) / math.sqrt(h)).to(dt), \
        (r(h, 4 * h) / math.sqrt(h)).to(dt)
    b = (0.1 * r(4 * h)).to(dt)
    h0, c0 = (0.5 * r(n, h)).to(dt), (0.5 * r(n, h)).to(dt)
    perm = torch.cat([torch.arange(0, 2 * h), torch.arange(3 * h, 4 * h),
                      torch.arange(2 * h, 3 * h)]).cuda()
    lstm = torch.nn.LSTM(h, h).to(device="cuda", dtype=dt)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(wx.t()[perm])
        lstm.weight_hh_l0.copy_(wh.t()[perm])
        lstm.bias_ih_l0.copy_(b[perm])
        lstm.bias_hh_l0.zero_()
    lstm.flatten_parameters()       # cuDNN's packed weights, as it runs best
    state = (h0[None], c0[None])
    port = lambda: fl.lstm_fused(torch.matmul(x, wx) + b, h0, c0, wh)
    with torch.no_grad():
        ref = lstm(x, state)[0]
        got = port()[0]
        fwd_ms = cuda_time(lambda: lstm(x, state))
        layer_ms = cuda_time(port)
    xg = x.clone().requires_grad_()
    out = lstm(xg, state)[0]
    dy = r(t, n, h).to(dt)
    bwd = lambda: torch.autograd.grad(
        out, [xg] + list(lstm.parameters()), dy, retain_graph=True)
    bwd_ms = cuda_time(bwd)
    with torch.no_grad():
        fwd_dev = device_trace(lambda: lstm(x, state), n=5, per_call=True)[0]
    fwd_row, bwd_row = rows
    fwd_row.update(library_ms=fwd_ms, port_layer_ms=layer_ms,
                   library_device_ms=fwd_dev,
                   cudnn_max_abs_err=(got.float() - ref.float())
                   .abs().max().item())
    bwd_row.update(library_ms=bwd_ms, library_device_ms=device_trace(
        bwd, n=5, per_call=True)[0])


def phase_lstm_kernels(gen):
    """lstm_fwd and lstm_bwd at the slice shape and the benchmark
    geometry, f32 and bf16, masked and unmasked."""
    from deeplearning4j_tpu_torch.ops import cuda_build
    resident = cuda_build.helper("lstm_fwd", "dl4j_lstm_max_clusters")
    rows = []
    for where, (t, n, h) in LSTM_SHAPES.items():
        for dtype in ("float32", "bfloat16"):
            floors = lstm_floors(t, n, h, dtype)
            fp = floors["lstm_fwd"][1]
            clusters = (resident(fp.slices, fp.smem, int(dtype == "bfloat16"))
                        if fp.route == "cluster" else None)
            log(f"  {dtype} T,N,H={t},{n},{h}: lstm_fwd plan {fp.route}, "
                f"{fp.slices} x {fp.row_tiles} blocks of {fp.units} units x "
                f"{fp.rows} rows, {fp.smem} B"
                + ("" if clusters is None else
                   f", {clusters} clusters of {fp.slices} resident (needs "
                   f"{fp.row_tiles})") + "; barriers: "
                + ", ".join(f"{k} {1e3 * v[0]:.2f} us" for k, v in
                            floors.items()))
            for masked in (False, True):
                for r in check_lstm_shape(where, t, n, h, dtype, masked, gen,
                                          floors):
                    rows.append(r)
                    lib = ("-" if r["library_ms"] is None
                           else f"{r['library_ms']:.4f} (device "
                           f"{r['library_device_ms']:.4f})")
                    log(f"  {r['kernel']:15s} {dtype:8s} T,N,H={t},{n},{h} "
                        f"mask={int(masked)} err={r['max_abs_err']:.3g} "
                        f"ms={r['ms']:.4f} device={r['device_ms']:.4f} "
                        f"launches={r['launches_per_call']:g} "
                        f"plain={r['plain_ms']:.4f} "
                        f"lib={lib} bound={r['bound_ms']:.4f} "
                        f"({r['bound_by']}) floor={r['latency_floor_ms']:.4f}"
                        f"{'' if r['ok'] else '  <-- DISAGREES'}"
                        f"{'' if r['bitwise_repeat'] else '  <-- NOT BITWISE'}")
    return rows


def _lstm_summary(name, rows):
    """One LSTM kernel's line: per call at the slice shape in f32,
    unmasked, as the scoring and training paths call it."""
    r = next(r for r in rows if r["kernel"] == name and r["where"] ==
             "slice" and r["dtype"] == "float32" and not r["masked"])
    out = {"name": name, "route": "cuda", "source": SOURCES[name],
           "replaces": REPLACES[name],
           "max_abs_err": max(x["max_abs_err"] for x in rows
                              if x["kernel"] == name)}
    out.update({k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "latency_floor_ms",
                                  "device_ms", "library_device_ms")})
    return out


def corpus_windows(n, t, rng=None):
    """(one-hot x (n, t, 77), next-char ids (n, t)) from the committed
    corpus: consecutive windows, or random starts with ``rng``."""
    import numpy as np
    from deeplearning4j_tpu_torch.generation.decode import Vocab
    corpus = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "tests", "resources", "pretrained", "corpus.txt")
    with open(corpus, encoding="utf-8") as f:
        ids = np.array(Vocab.load().encode(f.read()))
    starts = (np.arange(n) * t if rng is None
              else rng.integers(0, len(ids) - t - 1, n))
    x = np.eye(77, dtype=np.float32)[np.stack([ids[s:s + t]
                                               for s in starts])]
    return x, np.stack([ids[s + 1:s + t + 1] for s in starts]), ids


def phase_lstm_serve(report, card, profile=False):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.generation.decode import Vocab
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    from deeplearning4j_tpu_torch.zoo.models import TextGenerationLSTM

    model = TextGenerationLSTM().init_pretrained()      # cuda, f32
    x_np, y, ids = corpus_windows(LSTM_SERVE_WINDOWS, 60)
    x = torch.from_numpy(x_np).cuda()
    eye = torch.eye(77, device="cuda")
    prompt = ids[:GEN_PROMPT].tolist()

    fl.reset_launch_counts()
    probs = model.output(x)
    torch.cuda.synchronize()
    after_score = dict(fl.LAUNCHES)
    # greedy generation through rnn_time_step: the prompt in one call,
    # then one call per generated char fed back
    t0 = time.perf_counter()
    out, carries = model.rnn_time_step(eye[prompt][None])
    step_probs, tokens = [out[0, -1]], []
    for i in range(GEN_CHARS):
        tokens.append(int(step_probs[-1].argmax()))
        if i + 1 < GEN_CHARS:
            out, carries = model.rnn_time_step(eye[tokens[-1]][None],
                                               carries)
            step_probs.append(out[0, -1])
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = dict(fl.LAUNCHES)
    log(f"  launches: {after_score} after one output() call, {launches} "
        f"after {GEN_CHARS} rnn_time_step calls more")
    if after_score != {"lstm_fwd": 2, "lstm_bwd": 0} or launches != {
            "lstm_fwd": 2 + 2 * GEN_CHARS, "lstm_bwd": 0}:
        raise AssertionError("lstm_fwd must launch exactly twice per "
                             "output() and per rnn_time_step call")

    with plain_lstm():
        probs_p = model.output(x)
        seq = prompt + tokens[:-1]
        forced, _ = model.rnn_time_step(eye[seq][None])
    prob_err = (probs - probs_p).abs().max().item()
    p_true = probs.cpu().numpy()[np.arange(len(y))[:, None],
                                 np.arange(60)[None, :], y]
    xent = float(-np.mean(np.log(np.maximum(p_true, 1e-9))))
    kern = torch.stack(step_probs)
    plain = forced[0, GEN_PROMPT - 1:]
    gen_err = (kern - plain).abs().max().item()
    top2 = plain.topk(2, dim=-1).values
    gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    differ = (kern.argmax(-1) != plain.argmax(-1)).cpu().numpy()
    near = [int(i) for i in np.nonzero(gap < LSTM_PROB_TOL)[0]]
    bad = [int(i) for i in np.nonzero(differ & (gap >= LSTM_PROB_TOL))[0]]
    log(f"  output() on {len(y)} corpus windows: probabilities vs plain "
        f"|diff| {prob_err:.3g}, per-char cross-entropy {xent:.4f}")
    log(f"  {GEN_CHARS} greedy chars: {Vocab.load().decode(tokens)!r}")
    log(f"  generation vs plain teacher-forced on the same tokens: "
        f"|diff| {gen_err:.3g}, argmax differs at {int(differ.sum())} "
        f"steps, near ties (top-2 gap < {LSTM_PROB_TOL}) at {near}")
    if prob_err > LSTM_PROB_TOL or gen_err > LSTM_PROB_TOL or bad:
        raise AssertionError("the LSTM kernels disagree with the plain path "
                             "in scoring or generation")
    if not xent < 2.5:
        raise AssertionError(f"per-char cross-entropy {xent} >= 2.5")

    out_ms = cuda_time(lambda: model.output(x), iters=10)
    log(f"  output() at {len(y)} x 60: {out_ms:.3f} ms, "
        f"{1e3 * len(y) / out_ms:.1f} sequences/s; generation "
        f"{1e3 * gen_s / GEN_CHARS:.3f} ms per char [{card}]")
    if profile:
        with torch.inference_mode():
            report["lstm_serve_profile"] = profile_calls(
                lambda: model.output(x), card,
                f"f32 output() calls at {len(y)} x 60")
    report["lstm_serve"] = {
        "windows": len(y), "prob_diff": prob_err, "xent": xent,
        "gen_chars": GEN_CHARS, "gen_prob_diff": gen_err,
        "gen_argmax_differs": int(differ.sum()), "gen_near_ties": near,
        "output_ms": out_ms, "sequences_per_s": 1e3 * len(y) / out_ms,
        "ms_per_char": 1e3 * gen_s / GEN_CHARS, "launches": launches}
    return launches


def _gen_prompts(n, chars, seed):
    """``n`` prompts of ``chars`` ids from random committed-corpus
    windows."""
    import numpy as np
    x, _, _ = corpus_windows(n, chars, np.random.default_rng(seed))
    return [row.tolist() for row in x.argmax(-1)]


def _gen_streams(eng, prompts, stagger_s=0.0, burst=None, **kw):
    """Submit every prompt (after the first ``burst``, ``stagger_s``
    apart) and return each stream's result."""
    streams = []
    for i, p in enumerate(prompts):
        if burst is not None and i >= burst:
            time.sleep(stagger_s)
        streams.append(eng.submit(p, **kw))
    return [s.result(timeout=600) for s in streams]


def _seeded(i):
    return dict(greedy=False, temperature=0.8, top_k=10, seed=GEN_SEED + i)


def _common_prefix(a, b):
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n


def _first_near_tie(model, eye, prompt, ref):
    """The first decoded position of ``ref`` (``reference_decode``'s ids
    after ``prompt``) whose top-2 probabilities are within LSTM_PROB_TOL,
    teacher-forced; ``len(ref)`` when there is none. A stream may part
    from the oracle there and only there."""
    import numpy as np
    probs, _ = model.rnn_time_step(eye[prompt + ref[:-1]][None])
    top2 = probs[0, len(prompt) - 1:].topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    ties = np.nonzero(gaps < LSTM_PROB_TOL)[0]
    return int(ties[0]) if len(ties) else len(ref)


class _BucketWatch:
    """Samples an engine's slot bucket (its ``dl4j_gen_slot_bucket``
    gauge) every millisecond in a thread."""

    def __init__(self, eng):
        self.seen, self._stop = [], threading.Event()
        self._gauge = eng.registry.get_metric("dl4j_gen_slot_bucket")
        self._session = eng.session_id
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while not self._stop.is_set():
            b = int(self._gauge.get(session=self._session))
            if not self.seen or self.seen[-1] != b:
                self.seen.append(b)
            time.sleep(1e-3)

    def stop(self):
        self._stop.set()
        self._t.join(timeout=10)
        return self.seen


def phase_generate(report, card, profile=False):
    """The generation engine over the committed TextGenerationLSTM on the
    card (module docstring, phase 12). Runs none of the eleven kernels:
    its ``lstm_fwd`` launches come from the oracle and the int8 probe."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.generation import (
        GenerationEngine, SessionStore, Vocab, extract_decode_spec,
        reference_decode)
    from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    from deeplearning4j_tpu_torch.zoo.models import TextGenerationLSTM

    model = TextGenerationLSTM().init_pretrained()      # cuda, f32
    spec = extract_decode_spec(model)
    vocab = Vocab.load()
    eye = torch.eye(spec.vocab_size, device="cuda")
    prompts = _gen_prompts(GEN_STREAMS, GEN_PROMPT_CHARS, GEN_SEED)
    out = {"card": card, "slots": GEN_SLOTS, "streams": GEN_STREAMS,
           "prompt_chars": GEN_PROMPT_CHARS, "new_tokens": GEN_NEW}
    engines = []

    def engine(name, **kw):
        eng = GenerationEngine(model, max_slots=GEN_SLOTS,
                               registry=MetricsRegistry(),
                               session_id=f"gen-{name}", **kw)
        engines.append(eng)
        return eng

    fl.reset_launch_counts()
    # 1. greedy streams, staggered, against the oracle
    f32 = engine("f32")
    watch = _BucketWatch(f32)
    got = _gen_streams(f32, prompts, stagger_s=0.05, burst=GEN_SLOTS,
                       max_new_tokens=GEN_NEW)
    buckets = watch.stop()
    full, parts = 0, []
    for i, (p, g) in enumerate(zip(prompts, got)):
        ref = reference_decode(model, p, GEN_NEW, stop_id=f32.stop_id)
        tie = _first_near_tie(model, eye, p, ref)
        agree = _common_prefix(g["ids"], ref)
        if g["ids"] == ref:
            full += 1
        else:
            parts.append({"stream": i, "agree": agree, "near_tie": tie})
            if agree < tie:
                raise AssertionError(
                    f"stream {i} parts from reference_decode at {agree}, "
                    f"before the oracle's first near tie at {tie}")
    st = f32.stats()
    log(f"  {full} of {GEN_STREAMS} greedy streams equal reference_decode "
        f"in full; the others part at near ties: {parts}; reasons "
        f"{sorted(set(g['reason'] for g in got))}, lengths "
        f"{[g['n'] for g in got]}; buckets seen {buckets}, max active "
        f"{st['slots']['max_active']}")
    if st["slots"]["max_active"] != GEN_SLOTS:
        raise AssertionError("the staggered traffic never filled the slots")
    out["greedy"] = {"full": full, "parted": parts, "buckets": buckets,
                     "lengths": [g["n"] for g in got],
                     "sample": vocab.decode(got[0]["ids"])}

    # 2. bucket invariance: one seeded sampled request alone, then among
    # seven co-residents. First, logged: would cuBLAS's own products at
    # the tick's shapes give a row other bits at another row count (the
    # reason the tick multiplies 8 rows a call)?
    gen = torch.Generator(device="cuda").manual_seed(GEN_SEED)
    x = torch.randn((GEN_SLOTS, spec.hidden_sizes[-1]), generator=gen,
                    device="cuda")
    lib = {}
    for name, w in (("Wh", model.params[spec.lstm_names[-1]]["Wh"]),
                    ("head", model.params[spec.head_name]["W"])):
        whole = x @ w
        lib[name] = [s for s in (1, 2, 4)
                     if not torch.equal(x[:s] @ w, whole[:s])]
    log(f"  torch.matmul at (S, {x.shape[1]}) @ Wh and @ the head: row "
        f"counts whose rows differ from the same rows at S {GEN_SLOTS}: "
        f"{lib}")
    out["library_rows_differ"] = lib
    inv = engine("invariance", stop_text=None)
    kw = dict(_seeded(0), max_new_tokens=GEN_NEW)
    watch = _BucketWatch(inv)
    alone = inv.submit(prompts[0], **kw).result(timeout=600)
    alone_buckets = watch.stop()
    watch = _BucketWatch(inv)
    crowd = [inv.submit(p, **_seeded(j + 1), max_new_tokens=GEN_NEW + 32)
             for j, p in enumerate(prompts[1:GEN_SLOTS])]
    mine = inv.submit(prompts[0], **kw).result(timeout=600)
    for s in crowd:
        s.result(timeout=600)
    crowd_buckets = watch.stop()
    log(f"  sampled stream alone (buckets {alone_buckets}) vs among "
        f"{GEN_SLOTS - 1} co-residents (buckets {crowd_buckets}): equal "
        f"{alone['ids'] == mine['ids']}, "
        f"{_common_prefix(alone['ids'], mine['ids'])} of {alone['n']} tokens")
    if alone_buckets != [1] or GEN_SLOTS not in crowd_buckets:
        raise AssertionError("the invariance runs did not sit at buckets 1 "
                             f"and {GEN_SLOTS}")
    if alone["ids"] != mine["ids"]:
        raise AssertionError("a sampled stream depends on its bucket")
    out["bucket_invariance"] = {"tokens": alone["n"], "equal": True}

    # 3. the other modes against plain decode, bitwise
    longs = _gen_prompts(2, GEN_LONG_PROMPT, GEN_SEED + 1)
    mode_prompts = prompts[:GEN_SLOTS] + longs
    plain = engine("plain", stop_text=None)
    chunked = engine("chunked", stop_text=None, prefill_chunk=GEN_CHUNK)
    counter = engine("counter", stop_text=None, sampling="counter")
    specd = engine("speculative", stop_text=None, speculative=GEN_SPEC_K)

    def both(eng):
        greedy = _gen_streams(eng, mode_prompts, max_new_tokens=GEN_NEW)
        seeded = []
        for i, p in enumerate(mode_prompts):
            seeded.append(eng.submit(p, **_seeded(i), max_new_tokens=GEN_NEW))
        return [g["ids"] for g in greedy] + [
            s.result(timeout=600)["ids"] for s in seeded]

    checks = {}
    for name, a, b in (("chunked vs tick prefill", chunked, plain),
                       ("speculative vs counter", specd, counter)):
        xa, xb = both(a), both(b)
        same = sum(u == v for u, v in zip(xa, xb))
        log(f"  {name}: {same} of {len(xa)} streams (greedy and seeded, "
            f"{len(longs)} prompts of {GEN_LONG_PROMPT} chars) equal")
        checks[name] = same
        if same != len(xa):
            raise AssertionError(f"{name}: streams differ")
    store = SessionStore(spec, registry=MetricsRegistry(),
                         session_id="gen-session")
    sess = engine("session", stop_text=None, session_store=store)
    half = GEN_NEW // 2
    turns = {}
    for turn in (0, 1):
        streams = []
        for i, p in enumerate(prompts[:4]):
            for mode, skw in (("greedy", {}), ("seeded", _seeded(i))):
                streams.append(((i, mode), sess.submit(
                    p if turn == 0 else [], session=f"s{i}-{mode}",
                    max_new_tokens=half, **skw)))
        for key, s in streams:
            turns.setdefault(key, []).extend(s.result(timeout=600)["ids"])
    same = 0
    for (i, mode), ids in turns.items():
        skw = _seeded(i) if mode == "seeded" else {}
        one = plain.submit(prompts[i], max_new_tokens=GEN_NEW,
                           **skw).result(timeout=600)["ids"]
        same += one == ids
    log(f"  two-turn sessions vs one run: {same} of {len(turns)} equal; "
        f"store {store.stats()['hits']}")
    checks["sessions vs one run"] = same
    if same != len(turns):
        raise AssertionError("a resumed session differs from one run")
    out["modes"] = checks

    # 4. precision arms on the greedy streams
    f32_ids = [g["ids"] for g in got]
    arms = {}
    for arm in ("int8", "bf16"):
        eng = engine(arm, precision=arm, int8_budget=GEN_INT8_BUDGET)
        ids = [g["ids"] for g in _gen_streams(eng, prompts,
                                              max_new_tokens=GEN_NEW)]
        pos = sum(min(len(a), len(b)) for a, b in zip(ids, f32_ids))
        agree = sum(sum(x == y for x, y in zip(a, b))
                    for a, b in zip(ids, f32_ids))
        arms[arm] = {
            "gate_agreement": (eng.gate_result.top1_agreement
                               if eng.gate_result else None),
            "token_agreement": agree / pos,
            "streams_equal": sum(a == b for a, b in zip(ids, f32_ids)),
            "first_divergence": [_common_prefix(a, b)
                                 for a, b in zip(ids, f32_ids)]}
        log(f"  {arm} head: {arms[arm]}")
    out["precision"] = arms
    oracle_launches = dict(fl.LAUNCHES)

    # 5. numbers: a full-slot throughput run, then every engine warm
    fl.reset_launch_counts()
    thr = engine("throughput", stop_text=None)
    thr.generate(prompts[0], max_new_tokens=8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = _gen_streams(thr, prompts[:GEN_SLOTS], max_new_tokens=GEN_NEW)
    wall = time.perf_counter() - t0
    if fl.LAUNCHES["lstm_fwd"] or fl.LAUNCHES["lstm_bwd"]:
        raise AssertionError("the engine's tick launched an LSTM kernel")
    tokens = sum(r["n"] for r in res)
    lat = thr.stats()["latency_ms"]["token"]
    if profile:
        out["profile"] = profile_calls(
            lambda: _gen_streams(thr, prompts[:GEN_SLOTS],
                                 max_new_tokens=GEN_NEW), card,
            f"runs of {GEN_SLOTS} x {GEN_NEW} tokens through the engine",
            n=1, warmup=0)
    # TTFT of one request alone in its engine, median over the prompts
    ttft = {}
    for mode, eng in (("tick", plain), ("chunked", chunked)):
        for kind, ps in (("short", prompts[:GEN_SLOTS]), ("long", longs)):
            ttft[f"{mode}_{kind}"] = float(np.median([
                eng.submit(p, max_new_tokens=1).result(timeout=600)[
                    "ttft_ms"] for p in ps]))
    acc = specd.stats()["speculative"]
    for eng in engines:
        eng.assert_warm()
    out.update({
        "tokens_per_s": tokens / wall, "throughput_tokens": tokens,
        "throughput_wall_s": wall, "token_ms": lat, "ttft_ms": ttft,
        "speculative": acc, "oracle_lstm_fwd_launches": oracle_launches,
        "warmup_s": {e.session_id: e.warmup_s for e in engines}})
    log(f"  {GEN_SLOTS} slots x {GEN_NEW} tokens: {tokens / wall:.1f} "
        f"tokens/s; per-token dispatch ms p50 {lat['p50']:.3f} p99 "
        f"{lat['p99']:.3f}; TTFT ms alone, median, {GEN_PROMPT_CHARS}- and "
        f"{GEN_LONG_PROMPT}-char prompts: tick prefill "
        f"{ttft['tick_short']:.3f} and {ttft['tick_long']:.3f}, chunked "
        f"{ttft['chunked_short']:.3f} and {ttft['chunked_long']:.3f};"
        f" speculative acceptance {acc['acceptance']} ({acc['accepted']}"
        f" of {acc['proposed']} drafts); warmup s "
        f"{ {k: round(v, 3) for k, v in out['warmup_s'].items()} }; "
        f"assert_warm holds on {len(engines)} engines [{card}]")
    log(f"  lstm_fwd launches (oracle and int8 probe only): "
        f"{oracle_launches}")
    for eng in engines:
        eng.shutdown()
    report["generate"] = out


# ---------------------------------------------------------------------------
# phase 13: the serve CLI over HTTP
# ---------------------------------------------------------------------------

def _http(url, body=None, headers=None, raw=False):
    """(status, headers, body) of a GET (``body`` None) or a JSON POST;
    the body parsed as JSON unless ``raw``."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            code, hdrs, data = r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        code, hdrs, data = e.code, dict(e.headers), e.read()
    return code, hdrs, data.decode() if raw else json.loads(data)


def _predict(url, x, headers=None):
    """POST ``x`` to /api/predict; (status, answer as f32 or the error
    body, n, client ms)."""
    import numpy as np
    t0 = time.perf_counter()
    code, _, out = _http(url + "/api/predict", {"features": x.tolist()},
                         headers)
    ms = (time.perf_counter() - t0) * 1e3
    if code != 200:
        return code, out, None, ms
    return code, np.asarray(out["output"], np.float32), out["n"], ms


def _sse(url, body):
    """One /api/generate event stream: (events, client TTFT ms)."""
    import urllib.request
    req = urllib.request.Request(
        url + "/api/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    t0, ttft, events = time.perf_counter(), None, []
    with urllib.request.urlopen(req, timeout=600) as r:
        if not r.headers["Content-Type"].startswith("text/event-stream"):
            raise AssertionError("/api/generate is not an event stream")
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data:"):
                ev = json.loads(line[5:])
                if ttft is None and "token" in ev:
                    ttft = (time.perf_counter() - t0) * 1e3
                events.append(ev)
    return events, ttft


def _image_shape():
    return (SLICE["height"], SLICE["width"], SLICE["channels"])


def _pixels(rng, n):
    """``n`` slice-model images of multiples of 1/32 in [-2, 2]: short
    JSON numbers (a 45-image body stays under the server's 8 MiB cap),
    exact in float32."""
    return (rng.integers(-64, 65, (n,) + _image_shape()) / 32).astype(
        "float32")


def _ms_quantiles(ms):
    import numpy as np
    return {"p50": float(np.percentile(ms, 50)),
            "p99": float(np.percentile(ms, 99))}


class _ServeProcess:
    """``python -m deeplearning4j_tpu_torch serve ...`` as a user starts
    it, its standard output read in a thread until the banner's last
    line."""

    def __init__(self, args, last):
        self.lines, self.url = [], None
        self._ready = threading.Event()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve",
             *args], cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self._t = threading.Thread(target=self._read, args=(last,),
                                   daemon=True)
        self._t.start()

    def _read(self, last):
        import re
        for line in self.proc.stdout:
            self.lines.append(line.rstrip())
            m = re.match(r"serving .* at (http://\S+) ", line)
            if m:
                self.url = m.group(1)
            if line.strip().startswith(last):
                self._ready.set()
        self._ready.set()

    def wait_ready(self, timeout):
        if not self._ready.wait(timeout) or self.url is None:
            raise AssertionError("serve did not come up: "
                                 + " | ".join(self.lines[-20:]))
        return self.url

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self._t.join(timeout=10)


def _in_process_images_per_s(eng, reqs):
    """The engine's own rate over the same requests from as many
    threads, without HTTP and JSON."""
    def client(row):
        for f in [eng.submit(x) for x in row]:
            f.result()
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(row,)) for row in reqs]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    return sum(len(x) for row in reqs for x in row) / (
        time.perf_counter() - t0)


def _json_host_ms(x):
    """Host ms of the JSON work a request of ``x`` costs outside HTTP: the
    client's encode, and the server's decode plus the float32 array."""
    import numpy as np
    t0 = time.perf_counter()
    body = json.dumps({"features": x.tolist()})
    t1 = time.perf_counter()
    np.asarray(json.loads(body)["features"], np.float32)
    t2 = time.perf_counter()
    return {"encode": (t1 - t0) * 1e3, "decode": (t2 - t1) * 1e3}


def phase_serve_http(report, card):
    """``python -m deeplearning4j_tpu_torch serve`` on the card (module
    docstring, phase 13): the ResNet50 zip over HTTP, the fleet front
    door, the TextGenerationLSTM zip's predict and SSE routes, and the
    real entry point in a subprocess (started first, so that its
    ``--duration`` runs beside the other steps). Returns the served
    path's kernel launches."""
    import tempfile

    import numpy as np

    t_phase = time.perf_counter()
    out = {"card": card, "seconds": {}}
    launches = {name: 0 for name in SOURCES}
    rng = np.random.default_rng(SERVE_SEED)
    textgen = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "deeplearning4j_tpu", "zoo", "weights",
                           "textgen_lstm.zip")
    lstm_args = ["--model", textgen, "--warmup-shape", "60", "77",
                 "--ui-port", "0"]
    windows, _, _ = corpus_windows(SERVE_WINDOWS, 60, rng)
    sub = _ServeProcess(lstm_args + ["--duration", str(SERVE_DURATION)],
                        last="stats:")
    tmp = tempfile.TemporaryDirectory(prefix="serve_http_")
    try:
        zips = _resnet_zips(tmp.name)
        out["seconds"]["zips"] = time.perf_counter() - t_phase
        # 4. the real entry point: its banner's URL, health, device and
        # one predict (held to the in-process server's answer in step 3)
        sub_url = sub.wait_ready(300)
        code, sub_answer, _, _ = _predict(sub_url, windows)
        health = _http(sub_url + "/healthz")[0]
        dev = _http(sub_url + "/api/serving/stats")[2]["device"]
        if code != 200 or health != 200 or dev != "cuda:0":
            raise AssertionError(f"the subprocess answered {code}, "
                                 f"/healthz {health}, device {dev}")
        for step, fn in (("resnet", _serve_resnet), ("fleet", _serve_fleet)):
            t0 = time.perf_counter()
            for k, n in fn(out, card, zips, rng).items():
                launches[k] += n
            out["seconds"][step] = time.perf_counter() - t0
        t0 = time.perf_counter()
        a = _serve_lstm(out, launches, card, lstm_args, windows, rng)
        out["seconds"]["lstm"] = time.perf_counter() - t0
        if not np.array_equal(sub_answer, a):
            raise AssertionError("the subprocess's predict differs from "
                                 "the in-process server's")
        rc = sub.proc.wait(timeout=SERVE_DURATION + 300)
    finally:
        sub.stop()
        tmp.cleanup()          # the two ResNet50 zips
    if rc != 0:
        raise AssertionError(f"the serve subprocess exited {rc}: "
                             + " | ".join(sub.lines[-20:]))
    out["subprocess"] = {"url": sub.url, "rc": rc, "device": dev}
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    log(f"  python -m deeplearning4j_tpu_torch serve: answered on {dev} "
        f"equal to the in-process server, exited {rc}; phase seconds "
        f"{ {k: round(v, 1) for k, v in out['seconds'].items()} }")
    report["serve_http"] = out
    return launches


def _resnet_zips(tmp):
    """The slice ResNet50 (bf16) with nontrivial BN, saved as v1 and, from
    another seed, v2."""
    from deeplearning4j_tpu_torch.models.serialization import (
        params_from_jax, save_model)
    from deeplearning4j_tpu_torch.zoo.models import ResNet50
    zips = {}
    for version, seed in (("v1", 0), ("v2", 1)):
        m = ResNet50(**SLICE, seed=123 + seed).init()
        params_from_jax(*nontrivial_bn(m, seed), m.device, model=m)
        zips[version] = os.path.join(tmp, f"resnet50_{version}.zip")
        save_model(m, zips[version])
        del m
    return zips


def _resnet_args(zips):
    return ["--model", zips["v1"], "--bf16", "--warmup-shape",
            *map(str, _image_shape()), "--batch-limit", "32", "--ui-port",
            "0"]


def _serve_resnet(out, card, zips, rng):
    """Phase 13, step 1: the ResNet50 zip behind ParallelInference."""
    import numpy as np
    from deeplearning4j_tpu_torch.__main__ import cmd_serve
    from deeplearning4j_tpu_torch.ops import fused_conv as fc
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    per_fwd = {k: sum(n for c, n in path_calls(
        ResNet50(**SLICE).conf(), 1).items() if c.kernel == k)
        for k in FORWARD}
    front, server = cmd_serve(["serve", *_resnet_args(zips)], block=False)
    eng, url = front.engine, server.url
    out["resnet_warmup_s"] = eng.warmup_seconds
    try:
        fixed = [_pixels(rng, n) for n in SERVE_SIZES]
        sizes = rng.integers(1, 33, (SERVE_CLIENTS, SERVE_PER_CLIENT))
        reqs = [[_pixels(rng, int(n)) for n in row] for row in sizes]
        answers = [[None] * SERVE_PER_CLIENT for _ in range(SERVE_CLIENTS)]

        def client(c):
            for i, x in enumerate(reqs[c]):
                answers[c][i] = _predict(url, x)

        fc.reset_launch_counts()
        batches0 = eng.dispatch_count
        got_fixed = [_predict(url, x) for x in fixed]
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(SERVE_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        batches = eng.dispatch_count - batches0
        served = {k: fc.LAUNCHES[k] for k in FORWARD}
        if any(served[k] != per_fwd[k] * batches or not served[k]
               for k in FORWARD):
            raise AssertionError(f"served launches {served} for {batches} "
                                 f"batches, expected {per_fwd} a batch")
        n_req = 0
        for x, (code, a, n, _) in zip(
                fixed + [x for row in reqs for x in row],
                got_fixed + [a for row in answers for a in row]):
            n_req += 1
            if code != 200 or n != len(x):
                raise AssertionError(f"/api/predict answered {code}, n {n} "
                                     f"for {len(x)} images")
            if not np.array_equal(a, eng.output(x)):
                raise AssertionError("an HTTP answer differs from the "
                                     "engine's output on the same rows")
        images = int(sizes.sum())
        direct = _in_process_images_per_s(eng, reqs)
        out["resnet_http"] = {
            "requests": n_req, "batches": batches, "launches": served,
            "clients_images_per_s": images / wall,
            "in_process_images_per_s": direct,
            "clients_requests": int(sizes.size)}
        log(f"  ResNet50 zip: {n_req} HTTP answers (sizes {SERVE_SIZES}, "
            f"then {SERVE_CLIENTS} clients x {SERVE_PER_CLIENT} of 1-32 "
            f"images) bitwise equal to the engine's output; {batches} "
            f"batches, launches {served}; {SERVE_CLIENTS} clients "
            f"{images / wall:.1f} images/s over HTTP, {direct:.1f} in "
            f"process; warmup {eng.warmup_seconds:.3f}s [{card}]")

        # what HTTP and JSON add: client wall against the engine's own
        # request latency over the same requests, and the JSON alone
        lat = {}
        for n in (1, 32):
            x = _pixels(rng, n)
            eng.latency.mark()
            ms = [_predict(url, x)[3] for _ in range(SERVE_LATENCY_REPS)]
            q = eng.latency.delta_quantiles((0.5, 0.99))
            lat[n] = {"http_ms": _ms_quantiles(ms),
                      "engine_ms": {"p50": q[0.5] * 1e3,
                                    "p99": q[0.99] * 1e3},
                      "json_host_ms": _json_host_ms(x),
                      "body_bytes": len(json.dumps({"features":
                                                    x.tolist()}))}
            log(f"  {n} image(s), {SERVE_LATENCY_REPS} requests: HTTP p50 "
                f"{lat[n]['http_ms']['p50']:.3f} ms p99 "
                f"{lat[n]['http_ms']['p99']:.3f}; engine p50 "
                f"{lat[n]['engine_ms']['p50']:.3f} p99 "
                f"{lat[n]['engine_ms']['p99']:.3f}; JSON alone "
                f"{lat[n]['json_host_ms']}; body {lat[n]['body_bytes']} "
                f"bytes [{card}]")
        out["predict_latency"] = lat
        eng.assert_warm()
        if _http(url + "/healthz")[0] != 200:
            raise AssertionError("/healthz is not 200 after ResNet50 traffic")
    finally:
        front.shutdown()
        server.stop()
    return served


def _serve_fleet(out, card, zips, rng):
    """Phase 13, step 2: the fleet front door — swap, rollback, an
    expired deadline, a pool at its pending bound."""
    import numpy as np
    from deeplearning4j_tpu_torch.__main__ import cmd_serve

    front, server = cmd_serve(["serve", *_resnet_args(zips), "--slo-ms",
                               "1000", "--model-version", "v1"],
                              block=False)
    url, name = server.url, "resnet50_v1"
    try:
        x = _pixels(rng, 5)
        code, a1, _, _ = _predict(url, x)
        if code != 200 or not np.array_equal(
                a1, front.pool(name).engines[0].output(x)):
            raise AssertionError("fleet predict differs from its engine")
        t0 = time.perf_counter()
        code, _, sw = _http(url + "/api/fleet/swap",
                            {"version": "v2", "path": zips["v2"]})
        swap_s = time.perf_counter() - t0
        if code != 200 or sw["active_version"] != "v2":
            raise AssertionError(f"swap answered {code}: {sw}")
        code, a2, _, _ = _predict(url, x)
        if not np.array_equal(a2, front.pool(name).engines[0].output(x)) \
                or np.array_equal(a1, a2):
            raise AssertionError("after the swap the answer is not v2's")
        t0 = time.perf_counter()
        code, _, rb = _http(url + "/api/fleet/rollback", {})
        rollback_s = time.perf_counter() - t0
        code, a3, _, _ = _predict(url, x)
        if rb["active_version"] != "v1" or not np.array_equal(a1, a3):
            raise AssertionError("rollback does not give v1's answers")
        code, _, body = _http(url + "/api/predict",
                              {"features": x[:1].tolist()},
                              {"X-Deadline-Ms": "0.000001"})
        if code != 504 or body.get("error") != "deadline":
            raise AssertionError(f"an expired deadline answered {code}")
        pool = front.pool(name)
        with pool.lock:      # the pending bound reached
            held, pool.pending = pool.pending, front.max_pending
        try:
            code, hdrs, body = _http(url + "/api/predict",
                                     {"features": x[:1].tolist()})
        finally:
            with pool.lock:
                pool.pending = held
        if code != 503 or body.get("reason") != "queue" \
                or "Retry-After" not in hdrs:
            raise AssertionError(f"a full pool answered {code} {hdrs}")
        st = _http(url + "/api/fleet/stats")[2]["pools"][name]
        if (st["active_version"], st["standby_version"]) != ("v1", "v2"):
            raise AssertionError(f"fleet stats name {st}")
        front.assert_warm()
        out["fleet"] = {"swap_s": swap_s, "rollback_s": rollback_s,
                        "deadline_status": 504, "shed_status": 503,
                        "versions": [st["active_version"],
                                     st["standby_version"]]}
        log(f"  fleet: swap to v2 {swap_s:.3f}s (restore + warmup), "
            f"rollback {rollback_s:.4f}s, both bitwise; expired deadline "
            f"504, full pool 503 + Retry-After [{card}]")
    finally:
        front.shutdown()
        server.stop()
    return {}


def _serve_lstm(out, launches, card, lstm_args, windows, rng):
    """Phase 13, step 3: the TextGenerationLSTM zip served in this
    process with ``--generate``: predict through ``lstm_fwd`` and SSE
    streams against ``reference_decode``. Returns the predict answer on
    ``windows``."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.__main__ import cmd_serve
    from deeplearning4j_tpu_torch.generation import (extract_decode_spec,
                                                     reference_decode)
    from deeplearning4j_tpu_torch.models.serialization import restore_model
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    from deeplearning4j_tpu_torch.ui.generation_module import \
        GenerationModule

    front, server = cmd_serve(["serve", *lstm_args, "--generate",
                               "--gen-slots", str(GEN_SLOTS),
                               "--gen-prefill-chunk", str(GEN_CHUNK)],
                              block=False)
    gen = next(m.engine for m in server._modules
               if isinstance(m, GenerationModule))
    url, eng = server.url, front.engine
    try:
        model = restore_model(lstm_args[1])
        fl.reset_launch_counts()
        b0 = eng.dispatch_count
        code, a, n, _ = _predict(url, windows)
        lstm_launches = fl.LAUNCHES["lstm_fwd"]
        if code != 200 or n != SERVE_WINDOWS:
            raise AssertionError(f"LSTM predict answered {code}")
        if lstm_launches != 2 * (eng.dispatch_count - b0):
            raise AssertionError(f"{lstm_launches} lstm_fwd launches for "
                                 f"{eng.dispatch_count - b0} batches")
        launches["lstm_fwd"] += lstm_launches
        ref = model.output(windows).float().cpu().numpy()
        err = float((np.abs(a - ref).max(-1) / ref.max(-1)).max())
        if err > LSTM_SERVE_TOL:
            raise AssertionError(f"LSTM predict off model.output by {err}")
        out["lstm_predict"] = {"windows": SERVE_WINDOWS, "rel_err": err,
                               "bitwise": bool(np.array_equal(a, ref)),
                               "lstm_fwd_launches": lstm_launches}
        log(f"  TextGenerationLSTM zip: {SERVE_WINDOWS} windows, within "
            f"{err:.3g} of each row's largest of model.output (bitwise "
            f"{np.array_equal(a, ref)}), {lstm_launches} lstm_fwd launches")

        eye = torch.eye(extract_decode_spec(model).vocab_size,
                        device="cuda")
        prompts = _gen_prompts(GEN_SLOTS, GEN_PROMPT_CHARS, SERVE_SEED)
        results = [None] * GEN_SLOTS

        def stream(i):
            results[i] = _sse(url, {"prompt": prompts[i], "greedy": True,
                                    "max_new_tokens": GEN_NEW})
        t0 = time.perf_counter()
        threads = [threading.Thread(target=stream, args=(i,))
                   for i in range(GEN_SLOTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        full, tokens = 0, 0
        for p, (events, _) in zip(prompts, results):
            ids = [e["token"] for e in events if "token" in e]
            if not events[-1].get("done") or events[-1]["n"] != len(ids):
                raise AssertionError(f"a stream ended with {events[-1]}")
            tokens += len(ids)
            want = reference_decode(model, p, GEN_NEW, stop_id=gen.stop_id)
            if ids == want:
                full += 1
            elif _common_prefix(ids, want) < _first_near_tie(model, eye, p,
                                                             want):
                raise AssertionError("an SSE stream parts from "
                                     "reference_decode before a near tie")
        gst = _http(url + "/api/generation/stats")[2]
        # the same streams through the engine in process
        t0 = time.perf_counter()
        direct = _gen_streams(gen, prompts, max_new_tokens=GEN_NEW)
        direct_rate = sum(r["n"] for r in direct) / (
            time.perf_counter() - t0)
        metrics = _http(url + "/metrics", raw=True)[2]
        if not all(f"\n{fam}" in metrics for fam in ("dl4j_gen_tokens_total",
                                                     "dl4j_serving_requests")):
            raise AssertionError("/metrics lacks dl4j_gen_* or "
                                 "dl4j_serving_*")
        if _http(url + "/healthz")[0] != 200:
            raise AssertionError("/healthz is not 200 after generation")
        eng.assert_warm()
        gen.assert_warm()
        ttft_http = float(np.median([t for _, t in results]))
        out["sse"] = {"streams": GEN_SLOTS, "equal_in_full": full,
                      "tokens": tokens, "tokens_per_s": tokens / wall,
                      "in_process_tokens_per_s": direct_rate,
                      "ttft_http_ms_median": ttft_http,
                      "engine_ttft_ms": gst["latency_ms"]["ttft"],
                      "engine_token_ms": gst["latency_ms"]["token"],
                      "warmup_s": {"predict": eng.warmup_seconds,
                                   "generate": gst["warmup_s"]}}
        log(f"  {GEN_SLOTS} SSE streams: {full} equal reference_decode in "
            f"full, the others part at near ties; {tokens} tokens, "
            f"{tokens / wall:.1f} tokens/s over HTTP, {direct_rate:.1f} for "
            f"the same streams in process; TTFT over HTTP median "
            f"{ttft_http:.3f} ms, engine p50 "
            f"{gst['latency_ms']['ttft']['p50']:.3f}; warmup predict "
            f"{eng.warmup_seconds:.3f}s, generate {gst['warmup_s']}s; "
            f"/healthz 200, assert_warm on both engines [{card}]")
    finally:
        # the CLI's order: the front door, the generation engine, the
        # HTTP server
        front.shutdown()
        gen.shutdown()
        server.stop()
    return a


def phase_lstm_train(report, card, profile=False):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    from deeplearning4j_tpu_torch.optimize import solver
    from deeplearning4j_tpu_torch.zoo.models import TextGenerationLSTM

    b, k, t = LSTM_TRAIN_BATCH, LSTM_TRAIN_K, 60
    model = TextGenerationLSTM(seed=123).init()         # cuda, f32
    x_np, y_ids, _ = corpus_windows(b, t, np.random.default_rng(123))
    y_np = np.eye(77, dtype=np.float32)[y_ids]
    x, y = torch.from_numpy(x_np).cuda(), torch.from_numpy(y_np).cuda()
    xk = x.unsqueeze(0).expand(k, *x.shape).contiguous()
    yk = y.unsqueeze(0).expand(k, *y.shape).contiguous()
    scan = model._build_scan_train_step()

    def call():
        model.train_state, losses = scan(model.train_state, xk, yk)
        return losses

    fl.reset_launch_counts()
    losses = [call()]
    torch.cuda.synchronize()
    launches = dict(fl.LAUNCHES)
    log(f"  launches over one {k}-step call: {launches}")
    if launches != {"lstm_fwd": 2 * k, "lstm_bwd": 2 * k}:
        raise AssertionError(f"expected {2 * k} lstm_fwd and {2 * k} "
                             "lstm_bwd launches")
    losses.append(call())                     # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(LSTM_TRAIN_CALLS - 2):
        losses.append(call())
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / ((LSTM_TRAIN_CALLS - 2) * k)
    peak = torch.cuda.max_memory_allocated()
    losses = torch.cat(losses).float().cpu().numpy()
    log(f"  train step at batch {b} x {t}: {step_ms:.3f} ms, "
        f"{1e3 * b * t / step_ms:.1f} chars/s, peak memory "
        f"{peak / 2**20:.1f} MiB [{card}]")
    log(f"  losses over {len(losses)} steps: "
        f"{' '.join(f'{v:.4f}' for v in losses)}")
    if not np.isfinite(losses).all() or not losses[1:].min() < losses[0]:
        raise AssertionError("the train loss did not fall (or is not "
                             "finite)")
    if profile:
        report["lstm_train_profile"] = profile_calls(
            call, card, f"{k}-step f32 train calls at batch {b}", n=2,
            warmup=1)

    # one f32 step through the kernels against the plain versions
    m32 = TextGenerationLSTM(seed=123).init()
    args = m32._step_args(DataSet(x_np, y_np))
    loss_k, _, g_k = solver.value_and_grad(m32._loss, m32.train_state, *args)
    with plain_lstm():
        loss_p, _, g_p = solver.value_and_grad(m32._loss, m32.train_state,
                                               *args)
    err = grad_errors(g_k, g_p)
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    log(f"  f32 step, kernels vs plain: loss rel {loss_err:.3g}, gradients "
        f"rel L2 worst {err['worst']:.3g} ({err['name']}), median "
        f"{err['median']:.3g}, all {err['all']:.3g}")
    if loss_err > LOSS_RTOL or err["worst"] > LSTM_GRAD_RTOL:
        raise AssertionError("the f32 train step through the LSTM kernels "
                             "disagrees with the plain path")
    report["lstm_train"] = {
        "batch": b, "timesteps": t, "k": k, "steps": len(losses),
        "losses": losses.tolist(), "step_ms": step_ms,
        "chars_per_s": 1e3 * b * t / step_ms, "peak_memory_bytes": peak,
        "launches": launches, "f32_loss_rel_err": loss_err,
        "f32_grad_rel_l2": err}
    return launches


# ---------------------------------------------------------------------------
# phase 14: the recurrent family (TBPTT, the layers, a streaming graph,
# Graves generation) through kernels 7 and 8
# ---------------------------------------------------------------------------

def tbptt_model(device="cuda", backprop="tbptt"):
    """The TextGenerationLSTM configuration (seed 123) with segments of
    TBPTT_K, or trained as standard BPTT."""
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.zoo.models import TextGenerationLSTM
    conf = TextGenerationLSTM(seed=123).conf()
    conf.backprop_type = backprop
    conf.tbptt_fwd_length = conf.tbptt_back_length = TBPTT_K
    return MultiLayerNetwork(conf, device=device).init()


def corpus_batch(rng, n, chars):
    """A DataSet of ``n`` one-hot corpus windows of ``chars`` with their
    next-char labels."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    x, y_ids, _ = corpus_windows(n, chars, rng)
    return DataSet(x, np.eye(77, dtype=np.float32)[y_ids])


def tbptt_chain(model, ds):
    """Fit ``ds`` as one TBPTT batch, recording each segment's loss, the
    carries it hands on, and the parameters the last segment starts
    from."""
    step = model._tbptt_step or model._build_tbptt_step()
    rec = {"losses": [], "carries": [], "before_last": None}

    def spy(ts, *args):
        rec["before_last"] = ts.params
        ts, loss, carries = step(ts, *args)
        rec["losses"].append(loss)
        rec["carries"].append(carries)
        return ts, loss, carries
    model._tbptt_step = spy
    try:
        model.fit(ds)
    finally:
        model._tbptt_step = step
    return rec


def as_f64(model):
    """``model`` with float64 parameters, optimizer state and TBPTT
    carries: the exact reference of its f32 chain."""
    from deeplearning4j_tpu_torch.optimize.updaters import tree_map
    model.set_params(tree_map(lambda t: t.double(), model.params))
    model.opt_state = model._tx.init(model.params)
    zero = model._zero_carries
    model._zero_carries = lambda n: {
        k: tuple(t.double() for t in v) if isinstance(v, tuple)
        else v.double() for k, v in zero(n).items()}
    return model


def f64_data(ds):
    """A DataSet of numpy arrays in float64."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    d = lambda a: None if a is None else a.astype("float64")
    return DataSet(d(ds.features), d(ds.labels), d(ds.features_mask),
                   d(ds.labels_mask))


def chain_diff(a, b):
    """The largest differences of two segment chains: each segment's loss
    (relative), each carry handed on (over that carry's largest) and the
    parameters after the batch (over each array's largest)."""
    loss = max(abs(x.item() - y.item()) / abs(y.item())
               for x, y in zip(a["losses"], b["losses"]))
    carry = 0.0
    for ca, cb in zip(a["carries"], b["carries"]):
        for name in ca:
            for u, v in zip(ca[name], cb[name]):
                carry = max(carry, ((u.double() - v.double()).abs().max() /
                                    v.double().abs().max()).item())
    param, worst = rel_param_err(a["params"], b["params"])
    return {"loss": loss, "carry": carry, "param": param,
            "param_worst": worst}


def stream_bound(kernel_drift, plain_drift, kernel_vs_plain):
    """(bound, passed) of a streamed-against-whole comparison (the
    constants' comment above CHAIN_NOISE)."""
    b = max(LSTM_SERVE_TOL, CHAIN_NOISE * max(plain_drift, kernel_vs_plain))
    return b, kernel_drift <= b


def _tbptt_gates(report, card, fl, rng):
    """TBPTT batches at full width: launches, iterations, the loss, the
    ragged tail; segment ms and chars/s. Returns the launches."""
    import numpy as np
    import torch
    model = tbptt_model()
    segs = TBPTT_CHARS // TBPTT_K
    counted = {"lstm_fwd": 0, "lstm_bwd": 0}
    torch.cuda.reset_peak_memory_stats()
    walls, means = [], []
    for b in range(TBPTT_BATCHES):
        ds = corpus_batch(rng, TBPTT_BATCH, TBPTT_CHARS)
        it0 = model.iteration
        torch.cuda.synchronize()
        fl.reset_launch_counts()
        t0 = time.perf_counter()
        model.fit(ds)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launches = dict(fl.LAUNCHES)
        for k in counted:
            counted[k] += launches[k]
        if launches != {"lstm_fwd": 2 * segs, "lstm_bwd": 2 * segs}:
            raise AssertionError(f"batch {b}: launches {launches}, expected "
                                 f"{2 * segs} + {2 * segs}")
        if model.iteration - it0 != segs:
            raise AssertionError(f"batch {b}: the iteration count advanced "
                                 f"by {model.iteration - it0}, not {segs}")
        losses = torch.stack(model.last_segment_losses).cpu().numpy()
        if not np.isfinite(losses).all():
            raise AssertionError(f"batch {b}: a segment loss is not finite")
        means.append(float(losses.mean()))
    log(f"  {TBPTT_BATCHES} batches of {TBPTT_BATCH} x {TBPTT_CHARS} chars, "
        f"{segs} segments of {TBPTT_K}: mean segment loss per batch "
        f"{' '.join(f'{m:.4f}' for m in means)}; launches {counted}")
    if not means[-1] < means[0]:
        raise AssertionError("the last batch's mean segment loss is not "
                             "below the first batch's")
    # the ragged batch: 21 segments, the last padded to TBPTT_K and masked
    ds = corpus_batch(rng, TBPTT_BATCH, TBPTT_RAGGED)
    segs_r = -(-TBPTT_RAGGED // TBPTT_K)
    it0 = model.iteration
    fl.reset_launch_counts()
    rec = tbptt_chain(model, ds)
    torch.cuda.synchronize()
    launches = dict(fl.LAUNCHES)
    for k in counted:
        counted[k] += launches[k]
    moved, _ = rel_param_err(model.params, rec["before_last"])
    log(f"  ragged batch of {TBPTT_RAGGED} chars: {len(rec['losses'])} "
        f"segments, launches {launches}, the tail step moved the "
        f"parameters by {moved:.3g} of the largest")
    if (launches != {"lstm_fwd": 2 * segs_r, "lstm_bwd": 2 * segs_r}
            or model.iteration - it0 != segs_r or not moved > 0):
        raise AssertionError("the ragged batch: wrong launches, iteration "
                             "count, or a tail step that moved nothing")
    wall = float(np.mean(walls[1:]))
    peak = torch.cuda.max_memory_allocated()
    out = {"batches": TBPTT_BATCHES, "batch": TBPTT_BATCH,
           "chars": TBPTT_CHARS, "segment": TBPTT_K,
           "mean_segment_losses": means, "batch_wall_ms": 1e3 * wall,
           "segment_ms": 1e3 * wall / segs,
           "chars_per_s": TBPTT_BATCH * TBPTT_CHARS / wall,
           "ragged_tail_moved": moved, "launches": counted}
    log(f"  TBPTT batch wall {1e3 * wall:.1f} ms, {1e3 * wall / segs:.3f} "
        f"ms a segment, {out['chars_per_s']:.0f} chars/s [{card}]")
    # the same 32 x 1000 chars as standard BPTT in one call; each model's
    # peak memory of one fit above what was allocated before it (earlier
    # phases' tensors included)
    std = tbptt_model(backprop="standard")
    std.fit(ds_std := corpus_batch(rng, TBPTT_BATCH, TBPTT_CHARS))

    def fit_peak(m):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        m.fit(ds_std)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0,
                torch.cuda.max_memory_allocated() - base)
    sw, out["standard_peak_memory_bytes"] = fit_peak(std)
    _, out["tbptt_peak_memory_bytes"] = fit_peak(model)
    out.update(standard_wall_ms=1e3 * sw,
               standard_chars_per_s=TBPTT_BATCH * TBPTT_CHARS / sw,
               peak_memory_bytes=peak)
    log(f"  standard BPTT over the same {TBPTT_BATCH} x {TBPTT_CHARS} in one "
        f"call: {1e3 * sw:.1f} ms, {out['standard_chars_per_s']:.0f} chars/s,"
        f" peak {out['standard_peak_memory_bytes'] / 2**20:.1f} MiB above "
        f"the allocation before the fit, against TBPTT's "
        f"{out['tbptt_peak_memory_bytes'] / 2**20:.1f} MiB [{card}]")
    return out, model, counted


def _tbptt_chains(card, rng):
    """The kernels' segment chain against the plain versions' on one batch,
    from the same init; the bounds from the plain f32 chain's distance
    from the float64 chain."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.optimize import solver
    ds = corpus_batch(rng, TBPTT_BATCH, TBPTT_CHARS)
    # the first segment: one step's loss and gradients
    m = tbptt_model()
    first = DataSet(ds.features[:, :TBPTT_K], ds.labels[:, :TBPTT_K])
    args = m._step_args(first)
    loss_k, _, g_k = solver.value_and_grad(m._loss, m.train_state, *args)
    with plain_lstm():
        loss_p, _, g_p = solver.value_and_grad(m._loss, m.train_state,
                                               *args)
    gerr = grad_errors(g_k, g_p)
    lerr = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    chains = {}
    for name in ("kernels", "plain", "plain_f64"):
        m = tbptt_model()
        if name == "kernels":
            rec = tbptt_chain(m, ds)
        else:
            with plain_lstm():
                rec = (tbptt_chain(m, ds) if name == "plain" else
                       tbptt_chain(as_f64(m), f64_data(ds)))
        rec["params"] = m.params
        chains[name] = rec
    diff = chain_diff(chains["kernels"], chains["plain"])
    noise = chain_diff(chains["plain"], chains["plain_f64"])
    exact = chain_diff(chains["kernels"], chains["plain_f64"])
    bounds = {k: max(CHAIN_FLOOR[k], CHAIN_NOISE * KERNEL_EPS * noise[k])
              for k in CHAIN_FLOOR}
    log(f"  first segment, kernels vs plain: loss rel {lerr:.3g}, gradients "
        f"rel L2 worst {gerr['worst']:.3g} ({gerr['name']}), all "
        f"{gerr['all']:.3g}")
    log(f"  the {len(chains['kernels']['losses'])}-segment chain, kernels vs "
        f"plain: loss {diff['loss']:.3g}, carries {diff['carry']:.3g}, "
        f"parameters {diff['param']:.3g} ({diff['param_worst']}); the plain "
        f"f32 chain against float64: loss {noise['loss']:.3g}, carries "
        f"{noise['carry']:.3g}, parameters {noise['param']:.3g}; the "
        f"kernels' against float64: loss {exact['loss']:.3g}, carries "
        f"{exact['carry']:.3g}, parameters {exact['param']:.3g}; bounds "
        f"{bounds}")
    if lerr > LOSS_RTOL or gerr["worst"] > LSTM_GRAD_RTOL:
        raise AssertionError("the first TBPTT segment through the kernels "
                             "disagrees with the plain path")
    if any(diff[k] > bounds[k] for k in bounds):
        raise AssertionError("the kernels' TBPTT segment chain disagrees "
                             "with the plain versions' chain")
    return {"first_loss_rel": lerr, "first_grad_rel_l2": gerr,
            "chain_diff": diff, "chain_noise": noise,
            "kernels_vs_f64": exact, "bounds": bounds}


def _stream_check(card, model, ds, fl):
    """rnn_time_step over the sequence in segments of TBPTT_K against
    output() on the whole of it. Returns (report, launches)."""
    import torch
    x = torch.as_tensor(ds.features, device="cuda")
    segs = x.shape[1] // TBPTT_K

    def streamed():
        carries, outs = None, []
        for s in range(0, x.shape[1], TBPTT_K):
            y, carries = model.rnn_time_step(x[:, s:s + TBPTT_K], carries)
            outs.append(y)
        return torch.cat(outs, 1)
    fl.reset_launch_counts()
    got = streamed()
    torch.cuda.synchronize()
    launches = dict(fl.LAUNCHES)
    whole = model.output(x)
    with plain_lstm():
        p_stream, p_whole = streamed(), model.output(x)
    drift = row_rel_err(got, whole)
    plain_drift = row_rel_err(p_stream, p_whole)
    kvp = row_rel_err(whole, p_whole)
    bound, ok = stream_bound(drift, plain_drift, kvp)
    log(f"  rnn_time_step in {segs} calls of {TBPTT_K} vs output() on "
        f"{x.shape[1]} ticks: {drift:.3g} of each row's largest (plain path "
        f"{plain_drift:.3g}; kernels vs plain whole {kvp:.3g}; bound "
        f"{bound:.3g}); launches {launches}")
    if launches != {"lstm_fwd": 2 * segs, "lstm_bwd": 0} or not ok:
        raise AssertionError("streamed rnn_time_step disagrees with output()"
                             " (or launched other than 2 lstm_fwd a call)")
    return ({"drift": drift, "plain_drift": plain_drift,
             "kernels_vs_plain": kvp, "bound": bound}, launches)


def family_inputs(rng):
    """FAMILY_BATCH one-hot corpus windows of FAMILY_T, next-char labels,
    and a right-padded ragged mask (the padded steps zeroed in x)."""
    import numpy as np
    x, y_ids, _ = corpus_windows(FAMILY_BATCH, FAMILY_T, rng)
    lens = rng.integers(FAMILY_T // 3, FAMILY_T + 1, FAMILY_BATCH)
    lens[0] = FAMILY_T
    m = (np.arange(FAMILY_T)[None] < lens[:, None]).astype(np.float32)
    x = x * m[:, :, None]
    return x, np.eye(77, dtype=np.float32)[y_ids], m, lens


def family_model(layer, last=False, device="cuda"):
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.output import (OutputLayer,
                                                           RnnOutputLayer)
    from deeplearning4j_tpu_torch.optimize.updaters import Adam
    head = (OutputLayer if last else RnnOutputLayer)(n_out=77)
    conf = (NeuralNetConfiguration.Builder().seed(123).updater(Adam(2e-3))
            .list().layer(layer).layer(head)
            .set_input_type(InputType.recurrent(77, FAMILY_T)).build())
    return MultiLayerNetwork(conf, device=device).init()


def _family(card, rng, fl):
    """The recurrent layers at width 256 on a ragged batch: the kernel-
    running ones against the plain path, the others card against CPU."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.layers import recurrent as R
    from deeplearning4j_tpu_torch.optimize import solver
    x, y, m, lens = family_inputs(rng)
    xt = torch.as_tensor(x, device="cuda")
    mt = torch.as_tensor(m, device="cuda")
    out = {}
    for mode in ("concat", "add", "mul", "average"):
        model = family_model(R.Bidirectional(
            fwd=R.LSTM(n_out=FAMILY_H), mode=mode))
        fl.reset_launch_counts()
        probs = model.output(xt, mask=mt)
        torch.cuda.synchronize()
        fwd = dict(fl.LAUNCHES)
        with plain_lstm():
            ref = model.output(xt, mask=mt)
        perr = (probs - ref).abs().max().item()
        args = model._step_args(DataSet(x, y, m))
        fl.reset_launch_counts()
        loss_k, _, g_k = solver.value_and_grad(model._loss,
                                               model.train_state, *args)
        torch.cuda.synchronize()
        step = dict(fl.LAUNCHES)
        with plain_lstm():
            loss_p, _, g_p = solver.value_and_grad(model._loss,
                                                   model.train_state, *args)
        gerr = grad_errors(g_k, g_p)
        lerr = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
        log(f"  Bidirectional(LSTM({FAMILY_H})) {mode}: probabilities "
            f"kernels vs plain {perr:.3g}, launches {fwd}; one step: loss "
            f"rel {lerr:.3g}, gradients rel L2 worst {gerr['worst']:.3g} "
            f"({gerr['name']}), launches {step}")
        if (fwd != {"lstm_fwd": 2, "lstm_bwd": 0}
                or step != {"lstm_fwd": 2, "lstm_bwd": 2}
                or perr > LSTM_PROB_TOL or lerr > LOSS_RTOL
                or gerr["worst"] > LSTM_GRAD_RTOL):
            raise AssertionError(f"Bidirectional {mode} disagrees with the "
                                 "plain path or launched the wrong kernels")
        out[f"bidirectional_{mode}"] = {"prob_err": perr, "loss_rel": lerr,
                                        "grad_rel_l2": gerr["worst"]}
    for name, layer, last in (
            ("last_time_step", R.LastTimeStep(inner=R.LSTM(n_out=FAMILY_H)),
             True),
            ("mask_zero", R.MaskZeroLayer(inner=R.LSTM(n_out=FAMILY_H)),
             False)):
        model = family_model(layer, last)
        mask = None if name == "mask_zero" else mt
        fl.reset_launch_counts()
        probs = model.output(xt, mask=mask)
        torch.cuda.synchronize()
        launches = dict(fl.LAUNCHES)
        with plain_lstm():
            ref = model.output(xt, mask=mask)
        perr = (probs - ref).abs().max().item()
        log(f"  {name}(LSTM({FAMILY_H})): probabilities kernels vs plain "
            f"{perr:.3g}, launches {launches}")
        if launches != {"lstm_fwd": 1, "lstm_bwd": 0} or \
                perr > LSTM_PROB_TOL:
            raise AssertionError(f"{name} disagrees with the plain path")
        out[name] = {"prob_err": perr}
    for name, layer in (("graves_lstm", R.GravesLSTM(n_out=FAMILY_H)),
                        ("graves_bidirectional",
                         R.GravesBidirectionalLSTM(n_out=FAMILY_H)),
                        ("simple_rnn", R.SimpleRnn(n_out=FAMILY_H))):
        cpu = family_model(layer, device="cpu")
        model = family_model(layer)
        model.set_params(cpu.params, cpu.model_state)
        fl.reset_launch_counts()
        t0 = time.perf_counter()
        probs = model.output(xt, mask=mt)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        err = row_rel_err(probs.cpu(), cpu.output(x, mask=m))
        log(f"  {name}({FAMILY_H}) card vs CPU: {err:.3g} of each row's "
            f"largest, {ms:.1f} ms, launches {dict(fl.LAUNCHES)} [{card}]")
        if err > DIGITS_PROB_TOL or any(fl.LAUNCHES.values()):
            raise AssertionError(f"{name}: the card disagrees with the CPU")
        out[name] = {"prob_err": err, "output_ms": ms}
    return out


def _graph(card, rng, fl):
    """The streaming example's graph at width 256: a TBPTT fit with a
    features mask (no labels mask), card against CPU within the CPU f32
    fit's distance from float64 (the chain bounds), then a tick at a time
    against output(). Returns (report, launches)."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.output import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.layers.recurrent import LSTM
    from deeplearning4j_tpu_torch.ops.activations import Activation
    from deeplearning4j_tpu_torch.ops.losses import LossFunction
    from deeplearning4j_tpu_torch.optimize.updaters import Adam

    def graph(device):
        g = (NeuralNetConfiguration.Builder().seed(7).updater(Adam(5e-3))
             .graph_builder().add_inputs("in")
             .set_input_types(InputType.recurrent(3)))
        g.add_layer("lstm", LSTM(n_out=FAMILY_H,
                                 activation=Activation.TANH), "in")
        g.add_layer("out", RnnOutputLayer(n_out=2, loss=LossFunction.MCXENT,
                                          activation=Activation.SOFTMAX),
                    "lstm")
        g.set_outputs("out")
        g.backprop_type("tbptt").tbptt_fwd_length(GRAPH_K)
        return ComputationGraph(g.build(), device=device).init()

    n, t = GRAPH_N, GRAPH_T
    x = rng.normal(0, 1, (n, t, 3)).astype(np.float32)
    run_mean = np.cumsum(x[..., 0], axis=1) / np.arange(1, t + 1)
    y = np.zeros((n, t, 2), np.float32)
    y[..., 1] = run_mean > 0
    y[..., 0] = 1.0 - y[..., 1]
    lens = rng.integers(t // 2, t + 1, n)
    m = (np.arange(t)[None] < lens[:, None]).astype(np.float32)
    runs = {}
    counted = {"lstm_fwd": 0, "lstm_bwd": 0}
    for name, device in (("card", "cuda"), ("cpu", "cpu"),
                         ("cpu_f64", "cpu")):
        g = graph(device)
        ds = DataSet(x, y, m)
        if name == "cpu_f64":
            g, ds = as_f64(g), f64_data(ds)
        losses = []
        fl.reset_launch_counts()
        for _ in range(GRAPH_FITS):
            g.fit(ds)
            losses += [v.item() for v in g.last_segment_losses]
        if device == "cuda":
            for k in counted:
                counted[k] += fl.LAUNCHES[k]
        runs[name] = (g, losses)
    segs = -(-t // GRAPH_K) * GRAPH_FITS

    def rel(a, b):
        return max(abs(u - v) / abs(v) for u, v in zip(a, b))
    card_g, card_l = runs["card"]
    lerr = rel(card_l, runs["cpu"][1])
    lnoise = rel(runs["cpu"][1], runs["cpu_f64"][1])
    perr, worst = rel_param_err(card_g.params, runs["cpu"][0].params)
    pnoise, _ = rel_param_err(runs["cpu"][0].params,
                              runs["cpu_f64"][0].params)
    lb = max(CHAIN_FLOOR["loss"], CHAIN_NOISE * KERNEL_EPS * lnoise)
    pb = max(CHAIN_FLOOR["param"], CHAIN_NOISE * KERNEL_EPS * pnoise)
    log(f"  graph in -> LSTM({FAMILY_H}) -> RnnOutputLayer(2), TBPTT "
        f"{GRAPH_K}, {GRAPH_FITS} fits of {n} x {t} with a features mask: "
        f"launches {counted} (expected {segs} + {segs}); "
        f"card vs CPU: segment losses {lerr:.3g} (bound {lb:.3g}), "
        f"parameters {perr:.3g} ({worst}; bound {pb:.3g}); the CPU's f32 "
        f"against float64: losses {lnoise:.3g}, parameters {pnoise:.3g}")
    if (counted != {"lstm_fwd": segs, "lstm_bwd": segs} or lerr > lb
            or perr > pb):
        raise AssertionError("the TBPTT graph on the card disagrees with "
                             "the CPU (or launched the wrong kernels)")
    # then a tick at a time against output(x, mask=None)
    xt = torch.as_tensor(x, device="cuda")
    card_g.rnn_clear_previous_state()
    fl.reset_launch_counts()
    streamed = torch.stack([card_g.rnn_time_step(xt[:, s])
                            for s in range(t)], 1)
    torch.cuda.synchronize()
    launches = dict(fl.LAUNCHES)
    for k in counted:
        counted[k] += launches[k]
    whole = card_g.output(xt)
    with plain_lstm():
        card_g.rnn_clear_previous_state()
        p_stream = torch.stack([card_g.rnn_time_step(xt[:, s])
                                for s in range(t)], 1)
        p_whole = card_g.output(xt)
    drift = row_rel_err(streamed, whole)
    plain_drift = row_rel_err(p_stream, p_whole)
    kvp = row_rel_err(whole, p_whole)
    bound, ok = stream_bound(drift, plain_drift, kvp)
    log(f"  rnn_time_step a tick at a time vs output(): {drift:.3g} (plain "
        f"{plain_drift:.3g}, kernels vs plain {kvp:.3g}, bound {bound:.3g}),"
        f" launches {launches}")
    if launches != {"lstm_fwd": t, "lstm_bwd": 0} or not ok:
        raise AssertionError("the graph's streamed rnn_time_step disagrees "
                             "with output()")
    return ({"segment_loss_err": lerr, "loss_bound": lb, "param_err": perr,
             "param_bound": pb, "stream_drift": drift,
             "stream_bound": bound}, counted)


def _graves_generation(card, rng):
    """GenerationEngine(max_slots=8) over 2 x GravesLSTM(256) + the head
    (seed 123; peepholes drawn from the same seed): greedy streams against
    reference_decode under the near-tie rule."""
    import torch
    from deeplearning4j_tpu_torch.generation import (GenerationEngine,
                                                     reference_decode)
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.output import RnnOutputLayer
    from deeplearning4j_tpu_torch.nn.layers.recurrent import GravesLSTM
    from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
    conf = (NeuralNetConfiguration.Builder().seed(123).list()
            .layer(GravesLSTM(n_out=FAMILY_H))
            .layer(GravesLSTM(n_out=FAMILY_H))
            .layer(RnnOutputLayer(n_out=77))
            .set_input_type(InputType.recurrent(77)).build())
    model = MultiLayerNetwork(conf, device="cuda").init()
    gen = torch.Generator().manual_seed(123)
    params = {k: dict(v) for k, v in model.params.items()}
    for name in ("layer_0", "layer_1"):
        for k in ("pI", "pF", "pO"):
            params[name][k] = 0.5 * torch.rand(FAMILY_H, generator=gen) \
                - 0.25
    model.set_params(params)
    eye = torch.eye(77, device="cuda")
    prompts = _gen_prompts(GRAVES_STREAMS, GEN_PROMPT_CHARS, GEN_SEED)
    eng = GenerationEngine(model, max_slots=GEN_SLOTS, stop_text=None,
                           registry=MetricsRegistry(), session_id="graves")
    try:
        t0 = time.perf_counter()
        got = _gen_streams(eng, prompts, max_new_tokens=GRAVES_NEW)
        wall = time.perf_counter() - t0
        eng.assert_warm()
        max_active = eng.stats()["slots"]["max_active"]
    finally:
        eng.shutdown()
    full, parts = 0, []
    for i, (p, g) in enumerate(zip(prompts, got)):
        ref = reference_decode(model, p, GRAVES_NEW)
        tie = _first_near_tie(model, eye, p, ref)
        agree = _common_prefix(g["ids"], ref)
        if g["ids"] == ref:
            full += 1
        else:
            parts.append({"stream": i, "agree": agree, "near_tie": tie})
            if agree < tie:
                raise AssertionError(
                    f"Graves stream {i} parts from reference_decode at "
                    f"{agree}, before the oracle's first near tie at {tie}")
    tok_s = GRAVES_STREAMS * GRAVES_NEW / wall
    log(f"  Graves generation, {GEN_SLOTS} slots: {full} of "
        f"{GRAVES_STREAMS} greedy streams of {GRAVES_NEW} equal "
        f"reference_decode in full, the others part at near ties {parts}; "
        f"max active {max_active}; {tok_s:.0f} tokens/s [{card}]")
    return {"full": full, "parted": parts, "tokens_per_s": tok_s,
            "max_active": max_active}


def phase_rnn_tbptt(report, card, profile=False):
    """The recurrent family on the card (module docstring, phase 14)."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plans = {dt: fl.lstm_fwd_plan(TBPTT_K, TBPTT_BATCH, FAMILY_H,
                                  dt == "bfloat16", sms)._asdict()
             for dt in ("float32", "bfloat16")}
    log(f"  lstm_fwd_plan at the segment shape (T {TBPTT_K}, N "
        f"{TBPTT_BATCH}, H {FAMILY_H}): {plans}")
    rng = np.random.default_rng(123)
    t0 = time.perf_counter()
    out, model, launches = _tbptt_gates(report, card, fl, rng)
    out["fwd_plans"] = plans
    out["chain"] = _tbptt_chains(card, rng)
    stream, sl = _stream_check(card, model, corpus_batch(
        rng, TBPTT_BATCH, TBPTT_CHARS), fl)
    out["stream"] = stream
    if profile:
        ds = corpus_batch(rng, TBPTT_BATCH, TBPTT_CHARS)
        out["profile"] = profile_calls(lambda: model.fit(ds), card,
                                       "TBPTT batches", n=1, warmup=1)
    out["family"] = _family(card, rng, fl)
    out["graph"], gl = _graph(card, rng, fl)
    out["graves_generation"] = _graves_generation(card, rng)
    for k in launches:
        launches[k] += sl[k] + gl[k]
    out["phase_seconds"] = time.perf_counter() - t0
    log(f"  phase {out['phase_seconds']:.1f} s; launches counted for the "
        f"kernels line {launches}")
    report["rnn_tbptt"] = out
    return launches


# ---------------------------------------------------------------------------
# the attention slice (TPU kernels 9-11): kernels, serving, training
# ---------------------------------------------------------------------------

def plain_flash():
    """The three flash wrappers patched to their plain versions."""
    import contextlib
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    stack = contextlib.ExitStack()
    for name in ATTN_KERNELS:
        stack.enter_context(mock.patch.object(
            fa, name, getattr(fa, name + "_reference")))
    return stack


def attn_inputs(n, t, h, dh, dtype, mode, gen):
    """q, k, v as the strided views of one packed (N, T, H, 3, Dh)
    projection (as SelfAttentionLayer cuts them), dO, the key mask and the
    causal flag of one ``mode``: "none", "masked" (ragged key lengths),
    "causal", or "edge" (causal, one fully masked batch row, and the first
    key of another masked so its first query sees no key)."""
    import torch
    dt = getattr(torch, dtype)
    qkv = torch.randn((n, t, h, 3, dh), generator=gen, device="cuda").to(dt)
    q, k, v = qkv[:, :, :, 0], qkv[:, :, :, 1], qkv[:, :, :, 2]
    do = torch.randn((n, t, h, dh), generator=gen, device="cuda").to(dt)
    mask = None
    if mode in ("masked", "edge"):
        lengths = torch.randint(1, t + 1, (n,), generator=gen,
                                device="cuda")
        mask = (torch.arange(t, device="cuda")[None, :] < lengths[:, None]
                ).float()
        if mode == "edge":
            mask[0] = 0.0
            mask[1, 0] = 0.0
    return q, k, v, do, mask, mode in ("causal", "edge")


def attn_cost(kernel, q, mask, causal):
    """(flops, bytes) of one call: 4, 8 or 6 · H · Dh FLOP per live
    (query, key) pair (a valid key, and not after the query when causal),
    counted from this call's mask; q, k, v (and dO) read once, the mask,
    lse (and delta) read or written once, the outputs written once."""
    import torch
    n, t, h, dh = q.shape
    isz = q.element_size()
    valid = (torch.ones((n, t), device=q.device) if mask is None
             else (mask > 0).float())
    if causal:
        live = float((valid * (t - torch.arange(t, device=q.device))).sum())
    else:
        live = float(t * valid.sum())
    elem, rows = n * t * h * dh, 4 * n * h * t
    mbytes = 0 if mask is None else 4 * n * t
    flops = {"flash_fwd": 4, "flash_bwd_dkv": 8, "flash_bwd_dq": 6}[kernel] \
        * h * dh * live
    nbytes = {"flash_fwd": isz * 4 * elem + rows,
              "flash_bwd_dkv": isz * 6 * elem + 2 * rows,
              "flash_bwd_dq": isz * 5 * elem + 2 * rows}[kernel]
    return flops, nbytes + mbytes


def sdpa_backend(fn):
    """The name of the longest device kernel of one call of ``fn``: which
    of F.scaled_dot_product_attention's backends ran."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(getattr(e, "device_time_total", 0.0), e.key)
            for e in prof.key_averages() if e.device_type.name == "CUDA"]
    return max(rows)[1][:80] if rows else "not seen by the profiler"


def device_trace(fn, n=10, per_call=False):
    """(device ms, CUDA launches) of one call of ``fn`` by torch.profiler.
    The ms are the mean time of each kernel it launches, summed over its
    kernels (each launched once a call, as the device-timed wrappers' and
    their yardsticks' are; a mean per launch, because the trace can miss
    the first launch of its window); with ``per_call``, every kernel's
    total over the ``n`` calls divided by ``n``, for a call that launches
    one kernel many times (cuDNN's LSTM layer). Where a call's wall time
    (``cuda_time``) is bound by the host, this is what its kernels cost the
    card. The launches are the kernels and memsets the trace saw on the
    card, over ``n`` calls, rounded to a whole number a call. A trace that
    recorded no kernel at all is taken again, up to five times, and then
    reads NaN (not measured), never 0."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        # "Activity Buffer Request" is the tracer's own device activity
        events = [e for e in prof.key_averages()
                  if e.device_type.name == "CUDA"
                  and not e.key.startswith("Activity Buffer")]
        ms = sum(getattr(e, "device_time_total", 0.0) /
                 (n if per_call else max(1, e.count)) for e in events) / 1e3
        if ms > 0:
            return ms, round(sum(e.count for e in events) / n)
    return math.nan, math.nan


def device_ms(fn, n=10):
    """The device ms of ``device_trace``."""
    return device_trace(fn, n)[0]


def check_attn_shape(where, n, t, h, dh, dtype, mode, gen):
    """Rows of the three flash kernels at one shape: against their plain
    versions, bitwise on a second run, timed beside the bound, the plain
    version and F.scaled_dot_product_attention (forward; its autograd
    backward, which computes dq, dk and dv together, for both backward
    rows)."""
    import torch
    import torch.nn.functional as F
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    q, k, v, do, mask, causal = attn_inputs(n, t, h, dh, dtype, mode, gen)
    ref_out, ref_lse = fa.flash_fwd_reference(q, k, v, mask, causal)
    delta = fa.attention_delta(do, ref_out)
    bargs = (q, k, v, mask, do, ref_lse, delta, causal)
    runs = {"flash_fwd": (q, k, v, mask, causal), "flash_bwd_dkv": bargs,
            "flash_bwd_dq": bargs}

    # the library yardstick on (N, H, T, Dh) views of the same tensors
    qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
    am = None
    if mask is not None:
        am = (mask > 0)[:, None, None, :]
        if causal:
            am = am & torch.ones((t, t), dtype=torch.bool,
                                 device="cuda").tril()
    sdpa = lambda a, b, c: F.scaled_dot_product_attention(
        a, b, c, attn_mask=am, is_causal=causal and am is None)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qh, kh, vh))
    og = sdpa(qg, kg, vg)
    lib_bwd = lambda: torch.autograd.grad(og, (qg, kg, vg), doh,
                                          retain_graph=True)
    lib = {"flash_fwd": lambda: sdpa(qh, kh, vh),
           "flash_bwd_dkv": lib_bwd, "flash_bwd_dq": lib_bwd}
    long = t >= 1024
    iters, plain_iters = (5, 2) if long else (20, 3)
    rows = []
    for name, args in runs.items():
        kern = lambda: getattr(fa, name)(*args)
        plain = lambda: getattr(fa, name + "_reference")(*args)
        got, again, ref = kern(), kern(), plain()
        torch.cuda.synchronize()
        if name == "flash_bwd_dq":
            got, again, ref = (got,), (again,), (ref,)
        errs = [(a.float() - r.float()).abs().max().item() /
                max(1.0, r.float().abs().max().item())
                for a, r in zip(got, ref)]
        tol = [2e-5 if name == "flash_fwd" and i == 1 else ATTN_TOL[dtype]
               for i in range(len(errs))]          # lse is f32
        row = {"kernel": name, "where": where, "dtype": dtype, "mode": mode,
               "shape": [n, t, h, dh], "max_abs_err": max(errs),
               "ok": all(e <= b for e, b in zip(errs, tol)),
               "bitwise_repeat": all(torch.equal(a, b)
                                     for a, b in zip(got, again)),
               "ms": cuda_time(kern, iters=iters, warmup=2),
               "plain_ms": cuda_time(plain, iters=plain_iters, warmup=1),
               "library_ms": cuda_time(lib[name], iters=iters, warmup=2)}
        row["bound_ms"], row["bound_by"] = bound(
            *attn_cost(name, q, mask, causal), dtype)
        if name in DEVICE_TIMED:
            row["device_ms"], row["launches_per_call"] = device_trace(
                kern, n=iters)
            row["library_device_ms"] = device_ms(lib[name], n=iters)
        rows.append(row)
    rows[0]["sdpa_backend"] = sdpa_backend(lib["flash_fwd"])
    rows[1]["sdpa_backend"] = rows[2]["sdpa_backend"] = sdpa_backend(lib_bwd)
    return rows


def phase_attn_kernels(gen):
    """The flash kernels at the BERT slice shape (f32 and bf16; unmasked,
    ragged key mask, causal), the long-sequence geometry (bf16, causal or
    not), one edge shape (f32 and bf16) and bert_train's shape."""
    shapes = [("slice", ATTN_SLICE, dtype, mode)
              for dtype in ("float32", "bfloat16")
              for mode in ("none", "masked", "causal")]
    shapes += [("long", (n, t, 12, 64), "bfloat16", mode)
               for n, t in ATTN_LONG for mode in ("none", "causal")]
    shapes += [("edge", ATTN_EDGE, dtype, "edge")
               for dtype in ("float32", "bfloat16")]
    # bert_train's calls: bf16, unmasked, at the train batch
    shapes.append(("train", (BERT_TRAIN_BATCH,) + ATTN_SLICE[1:], "bfloat16",
                   "none"))
    # keras_import's new shapes: the Keras attention fixture (f32 as
    # imported, bf16 for the 2-byte staging at Dh 4) and the imported
    # BERT-base fine-tune's batch
    shapes += [("keras", ATTN_KERAS, dtype, "none")
               for dtype in ("float32", "bfloat16")]
    shapes.append(("keras_finetune", (KERAS_BERT_FT_BATCH,) + ATTN_SLICE[1:],
                   "bfloat16", "none"))
    rows = []
    for where, (n, t, h, dh), dtype, mode in shapes:
        for r in check_attn_shape(where, n, t, h, dh, dtype, mode, gen):
            rows.append(r)
            log(f"  {r['kernel']:15s} {dtype:8s} N,T,H,Dh={n},{t},{h},{dh} "
                f"{mode:6s} err={r['max_abs_err']:.3g} ms={r['ms']:.4f} "
                f"plain={r['plain_ms']:.4f} sdpa={r['library_ms']:.4f} "
                f"bound={r['bound_ms']:.4f} ({r['bound_by']})"
                f"{_device_note(r)} [{r['sdpa_backend']}]"
                f"{'' if r['ok'] else '  <-- DISAGREES'}"
                f"{'' if r['bitwise_repeat'] else '  <-- NOT BITWISE'}")
    return rows


def _attn_summary(name, rows):
    """One flash kernel's line: per call at the shape its main path gives
    it, bf16 and unmasked: the served full batch for flash_fwd, the train
    batch for the backward kernels, which only bert_train runs; the error
    is the largest over every call, relative to max(1, max|ref|)."""
    where = "slice" if name == "flash_fwd" else "train"
    r = next(r for r in rows if r["kernel"] == name and r["where"] == where
             and r["dtype"] == "bfloat16" and r["mode"] == "none")
    out = {"name": name, "route": "cuda", "source": SOURCES[name],
           "replaces": REPLACES[name],
           "max_abs_err": max(x["max_abs_err"] for x in rows
                              if x["kernel"] == name)}
    out.update({k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")})
    if "device_ms" in r:
        out.update(device_ms=r["device_ms"],
                   library_device_ms=r["library_device_ms"])
    return out


def bert_model(compute_dtype, seed=BERT_SEED, device=None):
    """The BERT-base-geometry stack of benchmarks/baseline_suite.py:159-213
    (bert_train), built by the port on ``device`` (the card by default)
    from ``seed``."""
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        LearnedPositionalEmbedding, TransformerEncoderBlock)
    from deeplearning4j_tpu_torch.nn.layers.feedforward import \
        EmbeddingSequenceLayer
    from deeplearning4j_tpu_torch.nn.layers.output import RnnOutputLayer
    from deeplearning4j_tpu_torch.optimize.updaters import Adam
    c = BERT
    b = (NeuralNetConfiguration.Builder().seed(seed).updater(Adam(1e-4))
         .compute_dtype(compute_dtype).list()
         .layer(EmbeddingSequenceLayer(n_in=c["vocab"], n_out=c["width"]))
         .layer(LearnedPositionalEmbedding(max_len=c["seq"])))
    for _ in range(c["blocks"]):
        b = b.layer(TransformerEncoderBlock(n_out=c["width"],
                                            n_heads=c["heads"], ffn_mult=4))
    conf = (b.layer(RnnOutputLayer(n_out=c["vocab"]))
            .set_input_type(InputType.recurrent(1, c["seq"])).build())
    return MultiLayerNetwork(conf, device=device).init()


def ragged_mask(n, t, rng, min_len=16):
    import numpy as np
    lengths = rng.integers(min_len, t + 1, n)
    lengths[0] = t
    return (np.arange(t)[None, :] < lengths[:, None]).astype(np.float32)


def row_rel_err(p, ref):
    """The largest |p - ref| of each position over that position's largest
    reference probability, maximised over positions."""
    return ((p - ref).abs().amax(-1) / ref.amax(-1)).max().item()


def _flash_launches(fa):
    return {k: fa.LAUNCHES[k] for k in ATTN_KERNELS}


def phase_bert_serve(report, card, profile=False):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    c, b = BERT, BERT_SERVE_BATCH
    t0 = time.perf_counter()
    model = bert_model("bfloat16")
    log(f"  model: {model.num_params()} params on {model.device}, init "
        f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(0, c["vocab"], (b, c["seq"]))).cuda()
    fmask = torch.from_numpy(ragged_mask(b, c["seq"], rng)).cuda()

    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    probs = model.output(ids)
    torch.cuda.synchronize()
    after_full = _flash_launches(fa)
    probs_m = model.output(ids, mask=fmask)
    torch.cuda.synchronize()
    launches = _flash_launches(fa)
    peak = torch.cuda.max_memory_allocated()
    log(f"  launches: {after_full} after one output() call, {launches} "
        "after a second on a ragged batch with a features mask")
    per_call = c["blocks"]
    if after_full != {"flash_fwd": per_call, "flash_bwd_dkv": 0,
                      "flash_bwd_dq": 0} or launches["flash_fwd"] != \
            2 * per_call or launches["flash_bwd_dkv"] + \
            launches["flash_bwd_dq"]:
        raise AssertionError(f"expected exactly {per_call} flash_fwd "
                             "launches per output() call")
    for what, p in (("full", probs), ("masked", probs_m)):
        pf = p.float()
        if tuple(p.shape) != (b, c["seq"], c["vocab"]) or \
                not torch.isfinite(pf).all() or \
                (pf.sum(-1) - 1).abs().max().item() > 2e-2:
            raise AssertionError(f"{what} output: not finite probabilities "
                                 f"of shape {(b, c['seq'], c['vocab'])}")

    # the f32 model through the kernels against the plain versions; the
    # control is a forward that ignores the key mask, a fault the check
    # must see
    m32 = bert_model("float32")
    m32.set_params(model.params, model.model_state)
    small, small_mask = ids[:4], fmask[:4]
    no_mask = lambda q, k, v, mask=None, causal=False: \
        fa.flash_fwd_reference(q, k, v, None, causal)
    with torch.inference_mode():
        p_k = m32.output(small, mask=small_mask)
        with plain_flash():
            p_p = m32.output(small, mask=small_mask)
            with mock.patch.object(fa, "flash_fwd", no_mask):
                p_c = m32.output(small, mask=small_mask)
    prob_err, control = row_rel_err(p_k, p_p), row_rel_err(p_c, p_p)
    log(f"  f32 kernels vs plain on 4 x {c['seq']} (ragged): probabilities "
        f"|diff| / row max {prob_err:.3g} (absolute "
        f"{(p_k - p_p).abs().max().item():.3g}); control, the key mask "
        f"ignored: {control:.3g} (absolute "
        f"{(p_c - p_p).abs().max().item():.3g})")
    if not prob_err <= BERT_PROB_TOL:
        raise AssertionError("the f32 BERT stack through the flash kernels "
                             "disagrees with the plain path")
    if not control > BERT_PROB_TOL:
        raise AssertionError("the probability check cannot tell a forward "
                             "that ignores the key mask from the plain path")
    del m32, p_k, p_p, p_c

    out_ms = cuda_time(lambda: model.output(ids), iters=10)
    masked_ms = cuda_time(lambda: model.output(ids, mask=fmask), iters=10)
    log(f"  output() at {b} x {c['seq']}: {out_ms:.3f} ms, "
        f"{1e3 * b * c['seq'] / out_ms:.1f} tokens/s (ragged with mask "
        f"{masked_ms:.3f} ms), peak memory {peak / 2**20:.1f} MiB [{card}]")
    if profile:
        with torch.inference_mode():
            report["bert_serve_profile"] = profile_calls(
                lambda: model.output(ids), card,
                f"bf16 output() calls at {b} x {c['seq']}", n=5)
    report["bert_serve"] = {
        "batch": b, "seq": c["seq"], "params": model.num_params(),
        "output_ms": out_ms, "masked_output_ms": masked_ms,
        "tokens_per_s": 1e3 * b * c["seq"] / out_ms,
        "peak_memory_bytes": peak, "launches": launches,
        "f32_prob_row_rel_diff": prob_err,
        "control_prob_row_rel_diff": control}
    return launches


def phase_bert_train(report, card, profile=False):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.optimize import solver
    c, b, k = BERT, BERT_TRAIN_BATCH, BERT_TRAIN_K
    model = bert_model("bfloat16")
    rng = np.random.default_rng(0)
    ids_np = rng.integers(0, c["vocab"], (b, c["seq"]))
    lab_np = rng.integers(0, c["vocab"], (b, c["seq"]))
    ids = torch.from_numpy(ids_np).cuda()
    y = torch.zeros((b, c["seq"], c["vocab"]), device="cuda")
    y.scatter_(2, torch.from_numpy(lab_np).cuda()[..., None], 1.0)
    xk = ids.unsqueeze(0).expand(k, *ids.shape)
    yk = y.unsqueeze(0).expand(k, *y.shape)
    scan = model._build_scan_train_step()

    def call():
        model.train_state, losses = scan(model.train_state, xk, yk)
        return losses

    fa.reset_launch_counts()
    losses = [call()]
    torch.cuda.synchronize()
    launches = _flash_launches(fa)
    log(f"  launches over one {k}-step call: {launches}")
    if launches != {name: k * c["blocks"] for name in ATTN_KERNELS}:
        raise AssertionError(f"expected {k} x {c['blocks']} launches of each "
                             "flash kernel")
    losses.append(call())                     # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(BERT_TRAIN_CALLS - 2):
        losses.append(call())
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / ((BERT_TRAIN_CALLS - 2) * k)
    peak = torch.cuda.max_memory_allocated()
    losses = torch.cat(losses).float().cpu().numpy()
    tokens = b * c["seq"]
    log(f"  train step at batch {b} x {c['seq']}: {step_ms:.3f} ms, "
        f"{1e3 * tokens / step_ms:.1f} tokens/s, peak memory "
        f"{peak / 2**20:.1f} MiB [{card}]")
    log(f"  losses over {len(losses)} steps: "
        f"{' '.join(f'{v:.4f}' for v in losses)}")
    if not np.isfinite(losses).all() or not losses[1:].min() < losses[0] \
            or abs(losses[0] - math.log(c["vocab"])) > 1.0:
        raise AssertionError("the train loss did not start near ln(vocab) "
                             "and fall (or is not finite)")
    if profile:
        report["bert_train_profile"] = profile_calls(
            call, card, f"{k}-step bf16 train calls at batch {b}", n=2,
            warmup=1)
    del xk, yk, y

    # one f32 step at a small ragged batch: kernels against plain versions
    m32 = bert_model("float32")
    m32.set_params(model.params)
    fm = ragged_mask(4, c["seq"], rng)
    y4 = np.zeros((4, c["seq"], c["vocab"]), np.float32)
    y4[np.arange(4)[:, None], np.arange(c["seq"])[None, :],
       lab_np[:4]] = 1.0
    args = m32._step_args(DataSet(ids_np[:4], y4, fm))
    loss_k, _, g_k = solver.value_and_grad(m32._loss, m32.train_state, *args)
    with plain_flash():
        loss_p, _, g_p = solver.value_and_grad(m32._loss, m32.train_state,
                                               *args)
    err = grad_errors(g_k, g_p)
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    log(f"  f32 step at 4 x {c['seq']} (ragged), kernels vs plain: loss rel "
        f"{loss_err:.3g}, gradients rel L2 worst {err['worst']:.3g} "
        f"({err['name']}), median {err['median']:.3g}, all "
        f"{err['all']:.3g}")
    if loss_err > LOSS_RTOL or err["worst"] > BERT_GRAD_RTOL:
        raise AssertionError("the f32 train step through the flash kernels "
                             "disagrees with the plain path")
    report["bert_train"] = {
        "batch": b, "seq": c["seq"], "k": k, "steps": len(losses),
        "losses": losses.tolist(), "step_ms": step_ms,
        "tokens_per_s": 1e3 * tokens / step_ms, "peak_memory_bytes": peak,
        "launches": launches, "f32_loss_rel_err": loss_err,
        "f32_grad_rel_l2": err}
    return launches


# ---------------------------------------------------------------------------
# the digits slice: LeNet and SimpleCNN through fit/evaluate (no TPU kernel)
# ---------------------------------------------------------------------------

def digits_test_nhwc():
    """The held-out digits as SimpleCNN takes them: a NHWC DataSet of all
    360 images (tests/test_pretrained_artifacts.py:48-51)."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.fetchers import \
        DigitsDataSetIterator
    x, y = DigitsDataSetIterator.fetch(train=False)
    return DataSet(x.reshape(-1, 28, 28, 1), np.eye(10, dtype=np.float32)[y])


def rel_param_err(a, b):
    """The largest |a - b| of each parameter array over that array's
    largest |b|, and the worst array's name."""
    from deeplearning4j_tpu_torch.models.serialization import flatten_paths
    fa, fb = flatten_paths(a), flatten_paths(b)
    if not fb:
        return 0.0, "-"
    errs = {k: ((fa[k].float().cpu() - fb[k].float().cpu()).abs().max()
                / fb[k].float().abs().max().clamp(min=1e-30)).item()
            for k in fb}
    worst = max(errs, key=errs.get)
    return errs[worst], worst


def phase_digits_eval(report, card):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import \
        ArrayDataSetIterator
    from deeplearning4j_tpu_torch.datasets.fetchers import \
        DigitsDataSetIterator
    from deeplearning4j_tpu_torch.zoo.models import LeNet, SimpleCNN

    nhwc = digits_test_nhwc()
    out = {}
    for zoo in (LeNet(), SimpleCNN()):
        name = type(zoo).__name__
        model = zoo.init_pretrained(flavor="digits")        # cuda
        ref = zoo.init_pretrained(flavor="digits", device="cpu")
        if name == "LeNet":
            x = nhwc.features.reshape(-1, 28 * 28)
            make = lambda: DigitsDataSetIterator(DIGITS_BATCH, train=False,
                                                 shuffle=False)
        else:
            x = nhwc.features
            make = lambda: ArrayDataSetIterator(nhwc, DIGITS_BATCH)
        ev = model.evaluate(make())
        acc, n = ev.accuracy(), int(ev.confusion_matrix().sum())
        ev_cpu = ref.evaluate(make())
        p = model.output(x).cpu().numpy()
        q = ref.output(x).numpy()
        row_err = float((np.abs(p - q).max(1) / q.max(1)).max())
        flips = int((p.argmax(1) != q.argmax(1)).sum())
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            model.evaluate(make())
            times.append(time.perf_counter() - t0)
        ips = n / min(times)
        log(f"  {name}: accuracy {acc:.4f} on {n} held-out images (CPU "
            f"{ev_cpu.accuracy():.4f}); card vs CPU probabilities: worst "
            f"row {row_err:.3g} of its largest, {flips} argmax "
            f"differences; evaluate {1e3 * min(times):.2f} ms, "
            f"{ips:.0f} images/s [{card}]")
        if acc < DIGITS_ACC[name]:
            raise AssertionError(f"{name}: held-out accuracy {acc} < "
                                 f"{DIGITS_ACC[name]}")
        if row_err > DIGITS_PROB_TOL or flips:
            raise AssertionError(f"{name}: card probabilities disagree with "
                                 "the CPU's")
        out[name] = {"accuracy": acc, "images": n,
                     "cpu_accuracy": ev_cpu.accuracy(),
                     "prob_row_rel_err": row_err, "argmax_flips": flips,
                     "evaluate_ms": [1e3 * t for t in times],
                     "images_per_s": ips}
    report["digits_eval"] = out


def lenet_with(updater=None, grad_norm=None, device=None):
    """LeNet (seed 123) under ``updater`` and a gradient normalization."""
    import dataclasses
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.updaters import \
        GradientNormalizationConfig
    from deeplearning4j_tpu_torch.zoo.models import LeNet
    conf = (LeNet() if updater is None else LeNet(updater=updater)).conf()
    if grad_norm is not None:
        conf.global_config = dataclasses.replace(
            conf.global_config,
            gradient_normalization=GradientNormalizationConfig(*grad_norm))
    return MultiLayerNetwork(conf, device=device).init()


def digits_updater_cases():
    """(name, updater, gradient normalization, whether its whole steps are
    gated) of the three-step check. The Adam family's whole steps are
    reported only: m / sqrt(v) turns f32 noise in a near-zero gradient
    into a step of up to lr, 1.2e-4 of the dense weight's largest after
    three steps with cuDNN off (measured on an H100)."""
    from deeplearning4j_tpu_torch.optimize import updaters as U
    from deeplearning4j_tpu_torch.optimize.schedules import StepSchedule
    return [
        ("Sgd", U.Sgd(0.05), None, True),
        ("Nesterovs", U.Nesterovs(0.01, 0.9), None, True),
        ("Adam", U.Adam(1e-3), None, False),
        ("AdamW", U.AdamW(1e-3), None, False),
        ("AdaMax", U.AdaMax(2e-3), None, False),
        ("Nadam", U.Nadam(1e-3), None, False),
        ("AMSGrad", U.AMSGrad(1e-3), None, False),
        ("RmsProp", U.RmsProp(1e-3), None, True),
        ("AdaGrad", U.AdaGrad(1e-2), None, True),
        ("AdaDelta", U.AdaDelta(), None, True),
        ("Adam+clip_l2_global", U.Adam(1e-3), ("clip_l2_global", 1.0), False),
        ("Adam+clip_l2_per_layer", U.Adam(1e-3), ("clip_l2_per_layer", 0.5),
         False),
        ("Adam+renormalize_l2", U.Adam(1e-3), ("renormalize_l2", 1.0), False),
        ("Sgd(StepSchedule)", U.Sgd(StepSchedule(0.05, 0.5, 2)), None, True)]


def phase_digits_train(report, card, profile=False):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import (
        ArrayDataSetIterator, DataSet)
    from deeplearning4j_tpu_torch.datasets.fetchers import \
        DigitsDataSetIterator
    from deeplearning4j_tpu_torch.optimize import solver
    from deeplearning4j_tpu_torch.optimize.updaters import tree_map
    from deeplearning4j_tpu_torch.zoo.models import LeNet, SimpleCNN

    out = {}
    # LeNet from scratch, 12 epochs through the feeder
    model = LeNet().init()                              # cuda, f32, seed 123
    # counted without a pass over the iterator: each pass advances its
    # epoch and with it the shuffle order that fit would start from
    n_train = (len(DigitsDataSetIterator.fetch(train=True)[1])
               // DIGITS_BATCH * DIGITS_BATCH)
    train = DigitsDataSetIterator(DIGITS_BATCH, train=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.fit(train, epochs=DIGITS_EPOCHS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    steps = model.iteration
    stalls = model.last_feeder.pass_stall_ms
    ev = model.evaluate(DigitsDataSetIterator(DIGITS_BATCH, train=False,
                                              shuffle=False))
    acc = ev.accuracy()
    step_ms = 1e3 * wall / steps
    log(f"  LeNet fit {DIGITS_EPOCHS} epochs x {steps // DIGITS_EPOCHS} "
        f"steps at batch {DIGITS_BATCH}: {wall:.2f} s ({1e3 * wall / DIGITS_EPOCHS:.1f} ms an "
        f"epoch, first epoch included), {step_ms:.3f} ms a step, "
        f"{n_train * DIGITS_EPOCHS / wall:.0f} images/s, feeder stall "
        f"{sum(stalls):.1f} ms in all (per epoch "
        f"{' '.join(f'{v:.1f}' for v in stalls)}), peak memory "
        f"{peak / 2**20:.1f} MiB [{card}]")
    log(f"  held-out accuracy {acc:.4f}, last loss {model.score():.4f}")
    if acc < DIGITS_ACC["LeNet"] or model.epoch_count != DIGITS_EPOCHS:
        raise AssertionError(f"LeNet trained on the card: accuracy {acc} < "
                             f"{DIGITS_ACC['LeNet']}")
    out["lenet_fit"] = {
        "epochs": DIGITS_EPOCHS, "steps": steps, "wall_s": wall,
        "epoch_ms": 1e3 * wall / DIGITS_EPOCHS, "step_ms": step_ms,
        "images_per_s": n_train * DIGITS_EPOCHS / wall,
        "stall_ms_per_epoch": stalls, "peak_memory_bytes": peak,
        "accuracy": acc}
    if profile:
        ep = DigitsDataSetIterator(DIGITS_BATCH, train=True)
        out["lenet_fit_profile"] = profile_calls(
            lambda: model.fit(ep, epochs=1), card,
            f"LeNet fit epochs ({n_train // DIGITS_BATCH} steps)", n=2,
            warmup=1)

    # one epoch at k_steps=4 against k_steps=1 from one seeded init, with
    # cuDNN's deterministic algorithms: its default backward algorithms
    # differ from run to run in the last bits, and 22 Adam steps carry
    # that to 1e-4 of a weight's largest whatever k is (1.45e-4 on an
    # H100 in the first run of this check)
    fitted = {}
    torch.backends.cudnn.deterministic = True
    for k in (1, 4):
        m = LeNet().init()
        t0 = time.perf_counter()
        m.fit(DigitsDataSetIterator(DIGITS_BATCH, train=True), epochs=1,
              k_steps=k)
        torch.cuda.synchronize()
        fitted[k] = (m, time.perf_counter() - t0)
    torch.backends.cudnn.deterministic = False
    err, worst = rel_param_err(fitted[4][0].params, fitted[1][0].params)
    log(f"  one epoch k_steps=4 vs 1: worst parameter {err:.3g} of its "
        f"largest ({worst}); epoch wall {1e3 * fitted[1][1]:.1f} ms (k=1), "
        f"{1e3 * fitted[4][1]:.1f} ms (k=4)")
    if err > DIGITS_PARAM_TOL or fitted[4][0].iteration != \
            fitted[1][0].iteration:
        raise AssertionError("k_steps=4 and k_steps=1 disagree")
    out["k_steps"] = {"param_rel_err": err, "worst": worst,
                      "epoch_ms": {str(k): 1e3 * v[1]
                                   for k, v in fitted.items()}}

    # three steps under every updater, normalization and a schedule, held
    # to the CPU three ways. (1) The updater arithmetic: each step's
    # gradients come from the card's step and go through the updater on
    # the card and, copied, through the same updater on the CPU. (2) With
    # cuDNN off, the gradients of each of the card's three fit steps
    # against the CPU's at the same parameters and batch. (3) With cuDNN
    # off, whole fit steps on each device, for the updaters that do not
    # divide by sqrt(v) (see digits_updater_cases). Whole steps with cuDNN
    # on are reported only: cuDNN's convolution gives values of up to
    # 2.4e-7 where the CPU's sum is exactly 0 (49 of the 50 such conv2
    # pre-activations of the first batch, 24 of them positive, measured on
    # an H100), so ReLU opens there and the biases behind it move by 1-2%
    # of their largest in three steps
    batches = [b for _, b in zip(range(3), DigitsDataSetIterator(
        DIGITS_BATCH, train=True, shuffle=False))]
    to_cpu = lambda tree: tree_map(lambda t: t.cpu(), tree)
    rows = []
    for name, upd, gn, gate_steps in digits_updater_cases():
        row = {"case": name}
        cuda_m, cpu_m = lenet_with(upd, gn), lenet_with(upd, gn, device="cpu")
        for b in batches:
            loss, new_ms, grads = solver.value_and_grad(
                cuda_m._loss, cuda_m.train_state, *cuda_m._step_args(b),
                cuda_m._generator)
            with torch.no_grad():
                for m, g in ((cuda_m, grads),
                             (cpu_m, tree_map(lambda t: t.cpu(), grads))):
                    u, m.opt_state = m._tx.update(g, m.opt_state, m.params)
                    m.params = solver.apply_updates(m.params, u)
            cuda_m.model_state = new_ms
        row["param_rel_err"], row["worst"] = rel_param_err(cuda_m.params,
                                                           cpu_m.params)
        row["state_rel_err"], _ = rel_param_err(cuda_m.opt_state,
                                                cpu_m.opt_state)
        row["grad_rel_err"] = (0.0, "-")
        for key, cudnn in (("steps_cudnn_off", False), ("steps", True)):
            torch.backends.cudnn.enabled = cudnn
            a, c = lenet_with(upd, gn), lenet_with(upd, gn, device="cpu")
            for b in batches:
                if not cudnn:
                    _, _, g_card = solver.value_and_grad(
                        a._loss, a.train_state, *a._step_args(b),
                        a._generator)
                    ts = a.train_state._replace(
                        params=to_cpu(a.params),
                        model_state=to_cpu(a.model_state))
                    _, _, g_cpu = solver.value_and_grad(
                        c._loss, ts, *c._step_args(b), c._generator)
                    row["grad_rel_err"] = max(row["grad_rel_err"],
                                              rel_param_err(g_card, g_cpu))
                a.fit(b)
                c.fit(b)
            torch.backends.cudnn.enabled = True
            row[key] = rel_param_err(a.params, c.params)
        row["steps_gated"] = gate_steps
        rows.append(row)
        log(f"  3 steps {name:<24} card updater vs CPU updater on the "
            f"card's gradients: parameters {row['param_rel_err']:.3g}, "
            f"state {row['state_rel_err']:.3g}; cuDNN off, gradients card "
            f"vs CPU {row['grad_rel_err'][0]:.3g} "
            f"({row['grad_rel_err'][1]}), whole steps "
            f"{row['steps_cudnn_off'][0]:.3g} ({row['steps_cudnn_off'][1]})"
            f"{'' if gate_steps else ' [reported]'}; cuDNN on, whole steps "
            f"{row['steps'][0]:.3g} ({row['steps'][1]}) [reported]")
    out["updaters"] = rows
    bad = [r["case"] for r in rows
           if r["param_rel_err"] > DIGITS_PARAM_TOL
           or r["state_rel_err"] > DIGITS_PARAM_TOL
           or r["grad_rel_err"][0] > DIGITS_PARAM_TOL
           or (r["steps_gated"]
               and r["steps_cudnn_off"][0] > DIGITS_PARAM_TOL)]
    if bad:
        raise AssertionError(f"LeNet's steps on the card disagree with the "
                             f"CPU's under {', '.join(bad)}")

    # SimpleCNN (BN, dropout 0.5) on the NHWC digits, two epochs
    x, y = DigitsDataSetIterator.fetch(train=True)
    data = DataSet(x.reshape(-1, 28, 28, 1), np.eye(10, dtype=np.float32)[y])
    scnn = SimpleCNN(height=28, width=28, channels=1).init()
    before = scnn.score(data)
    t0 = time.perf_counter()
    scnn.fit(ArrayDataSetIterator(data, DIGITS_BATCH, shuffle=True,
                                  seed=123), epochs=2)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    after = scnn.score(data)
    log(f"  SimpleCNN 28x28x1 two epochs: training loss {before:.4f} -> "
        f"{after:.4f}, {1e3 * wall / scnn.iteration:.3f} ms a step "
        f"[{card}]")
    if not (np.isfinite(after) and after < before):
        raise AssertionError("SimpleCNN's training loss did not fall")
    out["simplecnn_fit"] = {"loss_before": before, "loss_after": after,
                            "steps": scnn.iteration,
                            "step_ms": 1e3 * wall / scnn.iteration}
    report["digits_train"] = out


# ---------------------------------------------------------------------------
# phase 15: the convolutional model library (no kernel on its main path)
# ---------------------------------------------------------------------------

def _zoo_model(name, device="cuda", **kw):
    from deeplearning4j_tpu_torch.zoo import models as Z
    return getattr(Z, name)(**kw).init(device=device)


def _copy_model(model, device):
    """The same configuration on ``device`` with ``model``'s parameters
    and state."""
    cls = type(model)
    out = cls(model.conf, device=device).init()
    out.set_params(model.params, model.model_state)
    return out


def _row_err(got, ref):
    """The largest |got - ref| of each row over that row's largest |ref|,
    worst row."""
    got = got.float().cpu().reshape(got.shape[0], -1)
    ref = ref.float().cpu().reshape(ref.shape[0], -1)
    return ((got - ref).abs().amax(1) / ref.abs().amax(1).clamp_min(
        1e-30)).max().item()


def card_vs_cpu(model, cpu_model, x):
    """(error, bound, noise): the card's f32 output of ``x`` against the
    same model's on the CPU, row by row relative to the row's largest
    magnitude; the bound is max(ZOO_FLOOR, ZOO_NOISE x the card's own
    noise: the same rows reversed, each row alone, and the batch with
    cuDNN off (other convolution algorithms), against the batch's
    output)."""
    import numpy as np
    import torch
    y = model.output(x)
    rev = model.output(np.ascontiguousarray(x[::-1])).flip(0)
    alone = torch.cat([model.output(x[i:i + 1]) for i in range(len(x))])
    with torch.backends.cudnn.flags(enabled=False):
        other = model.output(x)
    noise = max(_row_err(rev, y), _row_err(alone, y), _row_err(other, y))
    err = _row_err(y, cpu_model.output(x))
    return err, max(ZOO_FLOOR, ZOO_NOISE * noise), noise


def _zoo_batch(rng, n, cfg):
    """(x, one-hot y) on the card: ``n`` random images of ``cfg``'s size."""
    import numpy as np
    import torch
    c = cfg["num_classes"]
    x = rng.normal(0, 1, (n, cfg["height"], cfg["width"], 3)).astype(
        np.float32)
    y = np.eye(c, dtype=np.float32)[rng.integers(0, c, n)]
    return (torch.from_numpy(x).to(device="cuda"),
            torch.from_numpy(y).to(device="cuda"))


def _zoo_labels(out_shape, boxes, rng):
    """One-hot classes, or YOLO labels (N, H, W, 4 + C): boxes in grid
    units, a one-hot class in about half the cells, the rest empty."""
    import numpy as np
    if len(out_shape) == 2:
        return np.eye(out_shape[1], dtype=np.float32)[
            rng.integers(0, out_shape[1], out_shape[0])]
    n, h, w, d = out_shape
    c = d // len(boxes) - 5
    y = np.zeros((n, h, w, 4 + c), np.float32)
    y[..., 0] = rng.uniform(0, w, (n, h, w))
    y[..., 1] = rng.uniform(0, h, (n, h, w))
    y[..., 2:4] = rng.uniform(0.5, 4.0, (n, h, w, 2))
    obj = rng.uniform(size=(n, h, w)) < 0.5
    y[..., 4:][obj] = np.eye(c, dtype=np.float32)[
        rng.integers(0, c, int(obj.sum()))]
    return y


def _params_moved(model, before):
    import torch
    return sum(any(not torch.equal(v, before[k][n]) for n, v in lp.items())
               for k, lp in model.params.items())


def _snapshot(model):
    return {k: {n: v.detach().clone() for n, v in lp.items()}
            for k, lp in model.params.items()}


def _zoo_resnet_arms(out, card, params_np, state_np):
    """The bench ResNet50 trained by each new arm from the train phase's
    weights: 24 steps in K-step calls, no kernel launch."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.serialization import params_from_jax
    from deeplearning4j_tpu_torch.ops import fused_conv as fc
    from deeplearning4j_tpu_torch.zoo.models import (ResNet50,
                                                     unfuse_resnet50_params)
    rng = np.random.default_rng(3)
    b, k = TRAIN_BATCH, TRAIN_K
    x, y = _zoo_batch(rng, b, ZOO_BENCH)
    xk = x.unsqueeze(0).expand(k, *x.shape).contiguous()
    yk = y.unsqueeze(0).expand(k, *y.shape).contiguous()
    arms = {}
    for arm, kw in ZOO_ARMS.items():
        model = ResNet50(**ZOO_BENCH, **kw).init()
        if kw["fused_blocks"]:
            p, s = params_np, state_np
        else:
            p, s = unfuse_resnet50_params(params_np, state_np)
            p = {n: p.get(n, {}) for n in model.params}
            s = {n: s.get(n, {}) for n in model.model_state}
        params_from_jax(p, s, model.device, model=model)
        scan = model._build_scan_train_step()

        def call():
            model.train_state, losses = scan(model.train_state, (xk,), (yk,))
            return losses

        fc.reset_launch_counts()
        losses = [call(), call()]                 # the first compiles
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start, end = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        for _ in range(TRAIN_CALLS - 2):
            losses.append(call())
        end.record()
        torch.cuda.synchronize()
        launched = {n: c for n, c in fc.LAUNCHES.items() if c}
        step_ms = start.elapsed_time(end) / ((TRAIN_CALLS - 2) * k)
        peak = torch.cuda.max_memory_allocated()
        losses = torch.cat(losses).float().cpu().numpy()
        log(f"  ResNet50 {arm}: {model.num_params()} params; train step at "
            f"batch {b}: {step_ms:.3f} ms, {1e3 * b / step_ms:.1f} images/s, "
            f"peak memory {peak / 2**20:.1f} MiB [{card}]; losses "
            f"{' '.join(f'{v:.4f}' for v in losses)}")
        if launched:
            raise AssertionError(f"the {arm} arm launched {launched}")
        if not np.isfinite(losses).all() or not losses[1:].min() < losses[0]:
            raise AssertionError(f"the {arm} arm's loss did not fall (or is "
                                 "not finite)")
        arms[arm] = {"step_ms": step_ms, "images_per_s": 1e3 * b / step_ms,
                     "peak_memory_bytes": peak, "losses": losses.tolist(),
                     "params": model.num_params()}
        del model, scan
        torch.cuda.empty_cache()
    pallas = out.get("pallas_arm")
    line = "  bench ResNet50 step ms at batch 128 (bf16, K=4): " + ", ".join(
        f"{a} {v['step_ms']:.3f}" for a, v in arms.items())
    log(line + (f", pallas {pallas['step_ms']:.3f} (the train phase)"
                if pallas else ", pallas: the train phase did not run")
        + f" [{card}]")
    out["arms"] = arms


def _zoo_grad_check(out, card, params_np, state_np):
    """f32 gradients at batch 8: the "xla" block against the "pallas"
    block (kernels 1-6) on the same weights, beside each arm's own
    summation-order noise (the batch's rows permuted)."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.serialization import params_from_jax
    from deeplearning4j_tpu_torch.ops import fused_conv as fc
    from deeplearning4j_tpu_torch.optimize import solver
    from deeplearning4j_tpu_torch.zoo.models import ResNet50
    rng = np.random.default_rng(8)
    x, y = _zoo_batch(rng, 8, ZOO_BENCH)
    perm = torch.from_numpy(rng.permutation(8)).to(device="cuda")
    grads, launches = {}, {}
    for impl in ("xla", "pallas"):
        m = ResNet50(**dict(ZOO_BENCH, compute_dtype="float32"),
                     fused_blocks=True, fused_impl=impl).init()
        params_from_jax(params_np, state_np, m.device, model=m)
        g = lambda xx, yy: solver.value_and_grad(m._loss, m.train_state,
                                                 (xx,), (yy,))
        fc.reset_launch_counts()
        grads[impl] = (g(x, y), g(x[perm], y[perm]))
        torch.cuda.synchronize()
        launches[impl] = dict(fc.LAUNCHES)
    (lx, _, gx), (_, _, gxq) = grads["xla"]
    (lp, _, gp), (_, _, gpq) = grads["pallas"]
    err = grad_errors(gx, gp)
    noise_x, noise_p = grad_errors(gxq, gx), grad_errors(gpq, gp)
    loss_err = abs(lx.item() - lp.item()) / abs(lp.item())
    log(f"  f32 gradients at batch 8, xla vs pallas block: loss rel "
        f"{loss_err:.3g}, rel L2 worst {err['worst']:.3g} ({err['name']}), "
        f"median {err['median']:.3g}, all {err['all']:.3g}; own noise on "
        f"permuted rows: xla worst {noise_x['worst']:.3g} all "
        f"{noise_x['all']:.3g}, pallas worst {noise_p['worst']:.3g} all "
        f"{noise_p['all']:.3g}; pallas launches {launches['pallas']}")
    if any(launches["xla"].values()):
        raise AssertionError("the xla block launched a kernel")
    if not all(launches["pallas"][n] for n in ("fused_mm", "fused_c3",
                                               "fused_mm_bwd")):
        raise AssertionError("the pallas block ran without its kernels")
    for key in ("worst", "all"):
        limit = max(GRAD_RTOL, GRAD_NOISE * max(noise_x[key],
                                                noise_p[key]))
        if err[key] > limit:
            raise AssertionError(f"xla and pallas gradients disagree ({key}:"
                                 f" {err[key]:.3g} > {limit:.3g})")
    if loss_err > LOSS_RTOL:
        raise AssertionError("xla and pallas losses disagree")
    out["xla_vs_pallas_grads"] = {
        "loss_rel_err": loss_err, "grad_rel_l2": err, "xla_noise": noise_x,
        "pallas_noise": noise_p, "pallas_launches": launches["pallas"]}


def _zoo_gram_rule(out, card):
    """Both statistics routes of conv_bn_stats_xla at every 1×1 call of the
    bench shape (batch 128, bf16): forward, and forward + backward."""
    import torch
    from deeplearning4j_tpu_torch.ops import fused_conv as fc
    from deeplearning4j_tpu_torch.zoo.models import ResNet50
    conf = ResNet50(**ZOO_BENCH, fused_blocks=True, fused_impl="xla").conf()
    calls = {c: n for c, n in path_calls(conf, TRAIN_BATCH).items()
             if c.kernel == "fused_mm"}
    g = torch.Generator(device="cuda").manual_seed(5)
    rows = []
    for call, count in calls.items():
        n, h, w, cin = call.x_shape
        cout = call.w_shape[1]
        x = torch.randn(call.x_shape, generator=g, device="cuda").to(
            torch.bfloat16).requires_grad_(True)
        wt = (torch.randn((cin, cout), generator=g, device="cuda")
              / cin ** 0.5).to(torch.bfloat16).requires_grad_(True)
        s = (1 + 0.1 * torch.randn(cin, generator=g, device="cuda")
             ).requires_grad_(True)
        b = (0.1 * torch.randn(cin, generator=g, device="cuda")
             ).requires_grad_(True)
        times = {}
        for mode in ("always", "never"):
            def fwd():
                with torch.no_grad():
                    return fc.conv_bn_stats_xla(x, wt, s, b, call.relu_in,
                                                call.norm_in, call.stride,
                                                gram=mode)

            def step():
                y, st = fc.conv_bn_stats_xla(x, wt, s, b, call.relu_in,
                                             call.norm_in, call.stride,
                                             gram=mode)
                torch.autograd.backward([y, st], [torch.ones_like(y),
                                                  torch.ones_like(st)])
            times[mode] = (cuda_time(fwd, iters=10), cuda_time(step, iters=5))
        gram_wins = times["always"][1] < times["never"][1]
        rows.append({"m": n * -(-h // call.stride) * -(-w // call.stride),
                     "cin": cin, "cout": cout, "stride": call.stride,
                     "norm_in": call.norm_in, "per_step": count,
                     "gram_ms": times["always"], "direct_ms": times["never"],
                     "gram_wins": gram_wins,
                     "auto": fc.gram_route("auto")})
        log(f"  1x1 M {rows[-1]['m']:6d} {cin:4d}->{cout:4d} s{call.stride} "
            f"x{count}: fwd gram {times['always'][0]:.4f} direct "
            f"{times['never'][0]:.4f} ms; fwd+bwd gram "
            f"{times['always'][1]:.4f} direct {times['never'][1]:.4f} ms -> "
            f"{'gram' if gram_wins else 'direct'}"
            f" (auto: {'gram' if rows[-1]['auto'] else 'direct'})")
    total = lambda pick: sum(r["per_step"] * (r["gram_ms"][1] if pick(r)
                                              else r["direct_ms"][1])
                             for r in rows)
    policies = {"auto": total(lambda r: r["auto"]),
                "always": total(lambda r: True),
                "never": total(lambda r: False),
                "best": total(lambda r: r["gram_wins"])}
    wins = sorted((r["cin"], r["cout"]) for r in rows if r["gram_wins"])
    losses = sorted((r["cin"], r["cout"]) for r in rows if not r["gram_wins"])
    log(f"  Gram rule from these times [{card}]: the Gram route wins at "
        f"(cin, cout) {wins}, the direct route at {losses}; one step's 1x1 "
        f"statistics ms (fwd+bwd) by policy: "
        + ", ".join(f"{k} {v:.3f}" for k, v in policies.items()))
    out["gram"] = {"calls": rows, "policy_ms": policies}


def _zoo_vgg16(out, card):
    """VGG16 at the baseline suite's shape: K-step training and serving."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.parallel.serving import ServingEngine
    model = _zoo_model("VGG16", **VGG)
    shape = (VGG["height"], VGG["width"], 3)
    rng = np.random.default_rng(16)
    b, k = VGG_BATCH, TRAIN_K
    x, y = _zoo_batch(rng, b, VGG)
    xk = x.unsqueeze(0).expand(k, *x.shape).contiguous()
    yk = y.unsqueeze(0).expand(k, *y.shape).contiguous()
    scan = model._build_scan_train_step()

    def call():                      # a MultiLayerNetwork takes tensors
        model.train_state, losses = scan(model.train_state, xk, yk)
        return losses

    # the bf16 loss is a bf16 logsumexp, whose ulp at ln 200 (2^-5) is
    # larger than what a few steps take off, so the loss is read before
    # and after the steps by the f32 twin of the model (no dropout)
    twin = _zoo_model("VGG16", **dict(VGG, compute_dtype="float32"))
    data = DataSet(x, y)
    twin.set_params(model.params, model.model_state)
    first = twin.score(data)
    losses = [call()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(VGG_CALLS - 1):
        losses.append(call())
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / ((VGG_CALLS - 1) * k)
    peak = torch.cuda.max_memory_allocated()
    losses = torch.cat(losses).float().cpu().numpy()
    twin.set_params(model.params, model.model_state)
    last = twin.score(data)
    log(f"  VGG16 {shape}/{VGG['num_classes']} bf16: {model.num_params()} "
        f"params; train step "
        f"at batch {b}: {step_ms:.3f} ms, {1e3 * b / step_ms:.1f} images/s, "
        f"peak memory {peak / 2**20:.1f} MiB [{card}]; bf16 losses "
        f"{' '.join(f'{v:.4f}' for v in losses)}; the batch's loss read in "
        f"f32 {first:.5f} -> {last:.5f} over {len(losses)} steps")
    if not np.isfinite(losses).all() or not last < first:
        raise AssertionError("VGG16's loss did not fall (or is not finite)")
    engine = ServingEngine(
        model, batch_limit=32, feature_shape=shape,
        precision="bf16" if VGG["compute_dtype"] == "bfloat16" else "f32")
    n_bitwise, sizes = 0, list(engine.ladder)
    t0 = time.perf_counter()
    for size in sizes:
        rows = rng.normal(0, 1, (size,) + shape).astype(np.float32)
        served = engine.output(rows)
        ref = model.output(rows).float().cpu().numpy()
        n_bitwise += int(np.array_equal(np.asarray(served, np.float32), ref))
    engine.shutdown()
    log(f"  VGG16 served through ServingEngine at buckets {sizes}: "
        f"{n_bitwise}/{len(sizes)} answers bitwise model.output "
        f"({time.perf_counter() - t0:.2f}s)")
    if n_bitwise != len(sizes):
        raise AssertionError("VGG16's served answers differ from "
                             "model.output")
    out["vgg16"] = {"step_ms": step_ms, "images_per_s": 1e3 * b / step_ms,
                    "peak_memory_bytes": peak, "losses": losses.tolist(),
                    "f32_loss_before": first, "f32_loss_after": last,
                    "params": model.num_params(), "served_buckets": sizes}


# YOLO2's decode, card against CPU (zoo phase). After 12 Adam steps from
# random weights the scores are flat: some 976 boxes above half the best
# score lie between 0.0343 and about 0.069, a mean gap of about 3.5e-5
# between neighbours, where an f32 ulp is 3.7e-9 to 7.5e-9. The card's and
# the CPU's exp and sigmoid differ by an ulp or two, so each gap has about
# a 3e-4 chance of being a tie that can swap, and 975 gaps give about 0.25
# swaps a run: an ordered list equal in full is not a function of the
# decode alone. So the check has two parts (``decodes_agree``):
# (a) every decoded tensor (centres, sizes, confidences, class
#     probabilities, and the score conf * max prob) from the same output
#     lies within DECODE_ULPS f32 ulps of its largest entry of the CPU's;
# (b) the lists after NMS are equal, or the first box where they part is a
#     near tie: its score within 2x the score bound of (a) of a neighbour's
#     or of the threshold, in either device's list. Any other parting
#     fails. The bound is set here, before any run.
DECODE_ULPS = 8
DECODE_NAMES = ("cx", "cy", "bw", "bh", "conf", "probs", "score")


def decoded(layer, pred):
    """{name: numpy} of ``layer._decode(pred)`` in f32 on ``pred``'s
    device, with the score ``conf * max prob`` that the threshold reads."""
    import torch
    with torch.no_grad():
        parts = layer._decode(pred.float())
        score = parts[4] * parts[5].amax(-1)
    return {n: t.cpu().numpy() for n, t in zip(DECODE_NAMES,
                                               parts + (score,))}


def decodes_agree(card, host, threshold, card_dets, host_dets,
                  ulps=DECODE_ULPS):
    """The two-part YOLO2 decode check (see DECODE_ULPS): ``card`` and
    ``host`` are ``decoded`` dicts of one output, the ``*_dets`` the
    ``get_predicted_objects`` lists at ``threshold``. Returns a report
    with ``ok``, each tensor's (difference, bound), and the parting."""
    import numpy as np
    diffs, ok, why = {}, True, []
    for n in DECODE_NAMES:
        a, b = np.asarray(card[n], np.float32), np.asarray(host[n],
                                                           np.float32)
        d = float(np.abs(a.astype(np.float64) - b).max())
        bound = ulps * float(np.spacing(np.float32(np.abs(b).max())))
        diffs[n] = (d, bound)
        if not d <= bound:
            ok = False
            why.append(f"{n} differs by {d:.3g} > {bound:.3g}")
    tie = 2 * diffs["score"][1]
    keys = lambda ds: [(d.example, d.predicted_class) for d in ds]
    parting = None
    if keys(card_dets) != keys(host_dets):
        i = next((j for j, (a, b) in enumerate(zip(card_dets, host_dets))
                  if (a.example, a.predicted_class)
                  != (b.example, b.predicted_class)),
                 min(len(card_dets), len(host_dets)))

        def near(ds):
            if i >= len(ds):
                return False
            c = ds[i].confidence
            others = [ds[j].confidence for j in (i - 1, i + 1)
                      if 0 <= j < len(ds)] + [threshold]
            return any(abs(c - o) <= tie for o in others)
        near_tie = near(card_dets) or near(host_dets)
        parting = {"index": i, "near_tie": near_tie, "tie_bound": tie,
                   "card": card_dets[max(i - 1, 0):i + 2],
                   "cpu": host_dets[max(i - 1, 0):i + 2]}
        if not near_tie:
            ok = False
            why.append(f"the lists part at box {i}, not a near tie")
    return {"ok": ok, "why": "; ".join(why), "diffs": diffs,
            "same": parting is None, "parting": parting}


def _zoo_yolo2(out, card):
    """YOLO2 at 416x416x3 (20 classes, the VOC anchors), f32: Adam on one
    fixed batch of synthetic boxes; the card against the CPU; decoding."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.layers.objdetect import \
        get_predicted_objects
    import dataclasses
    from deeplearning4j_tpu_torch.models.computation_graph import \
        ComputationGraph
    from deeplearning4j_tpu_torch.optimize.updaters import Adam
    from deeplearning4j_tpu_torch.zoo.models import YOLO2
    conf = YOLO2(**YOLO).conf()
    conf.global_config = dataclasses.replace(conf.global_config,
                                             updater=Adam(YOLO_LR))
    model = ComputationGraph(conf, device="cuda").init()
    cpu = _copy_model(model, "cpu")
    layer = model.conf.node("yolo").layer
    rng = np.random.default_rng(2)
    it = model.conf.network_input_types[0]
    x = rng.normal(0, 1, (YOLO_BATCH,) + tuple(it.shape())).astype(
        np.float32)
    grid = tuple(model.output(x[:1]).shape[1:])
    y = _zoo_labels((YOLO_BATCH,) + grid, layer.boxes, rng)
    rows = x[:ZOO_ROWS]
    err, bound, noise = card_vs_cpu(model, cpu, rows)
    two = DataSet(rows, y[:ZOO_ROWS])
    lc, lp = model.score(two), cpu.score(two)
    lrev = model.score(DataSet(np.ascontiguousarray(rows[::-1]),
                               np.ascontiguousarray(y[:ZOO_ROWS][::-1])))
    with torch.backends.cudnn.flags(enabled=False):
        lother = model.score(two)
    loss_noise = max(abs(lrev - lc), abs(lother - lc)) / abs(lc)
    loss_err = abs(lc - lp) / abs(lp)
    loss_bound = max(LOSS_RTOL, ZOO_NOISE * loss_noise)
    log(f"  YOLO2 {'x'.join(map(str, it.shape()))}/20 f32: "
        f"{model.num_params()} params; card vs "
        f"CPU output {err:.3g} (bound {bound:.3g}, card noise {noise:.3g}), "
        f"train-mode loss {lc:.5f} vs {lp:.5f}: rel {loss_err:.3g} (bound "
        f"{loss_bound:.3g}, noise {loss_noise:.3g})")
    if err > bound or loss_err > loss_bound:
        raise AssertionError("YOLO2 on the card disagrees with the CPU")
    del cpu
    data = DataSet(x, y)
    losses = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(YOLO_STEPS):
        model.fit(data)
        losses.append(model._last_loss)
    losses = torch.stack(losses).float().cpu().numpy()
    step_ms = 1e3 * (time.perf_counter() - t0) / YOLO_STEPS
    # boxes scoring at least half the best score, decoded on the card and,
    # from the same output, on the CPU
    pred = model.output(x[:2])
    dec_card, dec_host = decoded(layer, pred), decoded(layer, pred.cpu())
    threshold = 0.5 * float(dec_card["score"].max())
    dets = get_predicted_objects(layer, pred, threshold)
    host = get_predicted_objects(layer, pred.cpu(), threshold)
    rep = decodes_agree(dec_card, dec_host, threshold, dets, host)
    log(f"  YOLO2 Adam({YOLO_LR:g}) on one batch of {YOLO_BATCH}: losses "
        f"{' '.join(f'{v:.2f}' for v in losses)}; {step_ms:.1f} ms a step "
        f"[{card}]; {len(dets)} boxes above {threshold:.4f} (half the best "
        f"score) after NMS, the same list {rep['same']} from the CPU's "
        f"decode; first {dets[:1]}")
    log("  YOLO2 decode card vs CPU (bound "
        f"{DECODE_ULPS} f32 ulps of the largest entry): " + ", ".join(
            f"{n} {d:.3g} ({b:.3g})" for n, (d, b) in rep["diffs"].items()))
    if not np.isfinite(losses).all() or not losses[1:].min() < losses[0]:
        raise AssertionError("YOLO2's loss did not fall")
    if rep["parting"] is not None:
        p = rep["parting"]
        log(f"  YOLO2 decodes part at box {p['index']} of {len(dets)} "
            f"(card) and {len(host)} (CPU), near tie {p['near_tie']} "
            f"(within {p['tie_bound']:.3g}): card {p['card']}, CPU "
            f"{p['cpu']}")
    if not dets or not rep["ok"]:
        raise AssertionError("get_predicted_objects returned no box, or "
                             "the decodes disagree: " + rep["why"])
    out["yolo2"] = {"params": model.num_params(), "output_err": err,
                    "output_bound": bound, "output_noise": noise,
                    "loss_err": loss_err, "loss_bound": loss_bound,
                    "losses": losses.tolist(), "step_ms": step_ms,
                    "detections": len(dets), "threshold": threshold,
                    "decode_diffs": rep["diffs"],
                    "same_list": rep["same"]}


def _zoo_others(out, card):
    """The rest of the zoo at each model's JAX default size: f32 output of
    2 rows against the CPU, one train step, the parameter count."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    rows = {}
    for name in ZOO_OTHERS:
        t0 = time.perf_counter()
        model = _zoo_model(name)
        cpu = _copy_model(model, "cpu")
        it = (model.conf.network_input_types[0] if hasattr(
            model.conf, "network_input_types") else model.conf.input_type)
        rng = np.random.default_rng(7)
        x = rng.normal(0, 1, (ZOO_ROWS,) + tuple(it.shape())).astype(
            np.float32)
        err, bound, noise = card_vs_cpu(model, cpu, x)
        del cpu
        out_layer = (model.conf.node(model.conf.network_outputs[0]).layer
                     if hasattr(model.conf, "nodes")
                     else model.conf.layers[-1])
        out_shape = tuple(model.output(x[:1]).shape)
        y = _zoo_labels((ZOO_ROWS,) + out_shape[1:],
                        getattr(out_layer, "boxes", ()), rng)
        before = _snapshot(model)
        model.fit(DataSet(x, y))
        loss = float(model._last_loss)
        moved = _params_moved(model, before)
        rows[name] = {"params": model.num_params(), "output_err": err,
                      "bound": bound, "noise": noise, "loss": loss,
                      "layers_moved": moved,
                      "seconds": time.perf_counter() - t0}
        log(f"  {name} {'x'.join(map(str, it.shape()))}: "
            f"{model.num_params()} params; card vs CPU {err:.3g} (bound "
            f"{bound:.3g}, card noise {noise:.3g}); one step loss "
            f"{loss:.4f}, {moved} layers moved "
            f"({rows[name]['seconds']:.1f}s)")
        if err > bound or not np.isfinite(loss) or moved == 0:
            raise AssertionError(f"{name} on the card: output or step "
                                 "failed its check")
        del model, before
        torch.cuda.empty_cache()
    out["others"] = rows


def _zoo_transfer(out, card):
    """The committed digit LeNet, frozen up to its last dense layer, with a
    new even/odd head by n_out_replace, fitted on the digits on the
    card."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import (
        ArrayDataSetIterator, DataSet)
    from deeplearning4j_tpu_torch.datasets.fetchers import \
        DigitsDataSetIterator
    from deeplearning4j_tpu_torch.nn.transferlearning import (
        FineTuneConfiguration, TransferLearning)
    from deeplearning4j_tpu_torch.optimize.updaters import Sgd
    from deeplearning4j_tpu_torch.zoo.models import LeNet
    base = LeNet().init_pretrained(flavor="digits")            # cuda
    names = [l.name for l in base.conf.layers]
    model = (TransferLearning.Builder(base)
             .fine_tune_configuration(FineTuneConfiguration.Builder()
                                      .updater(Sgd(0.05)).build())
             .set_feature_extractor(names[-2])
             .n_out_replace(names[-1], 2)
             .build())
    before = _snapshot(model)
    state = {k: {n: v.clone() for n, v in st.items()}
             for k, st in model.model_state.items()}
    data = {}
    for split in (True, False):
        x, yi = DigitsDataSetIterator.fetch(train=split)
        data[split] = DataSet(x.reshape(len(x), -1).astype(np.float32),
                              np.eye(2, dtype=np.float32)[yi % 2])
    t0 = time.perf_counter()
    model.fit(ArrayDataSetIterator(data[True], DIGITS_BATCH, shuffle=True,
                                   seed=1), epochs=TRANSFER_EPOCHS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    frozen = [n for n in names[:-1] if before[n]]
    same = all(torch.equal(v, model.params[n][k])
               for n in frozen for k, v in before[n].items())
    same_state = all(torch.equal(v, model.model_state[n][k])
                     for n, st in state.items() for k, v in st.items())
    head_moved = not torch.equal(before[names[-1]]["W"],
                                 model.params[names[-1]]["W"])
    acc = model.evaluate(ArrayDataSetIterator(data[False],
                                              DIGITS_BATCH)).accuracy()
    log(f"  transfer: LeNet digits frozen through {names[-2]} "
        f"({len(frozen)} layers), new even/odd head, {TRANSFER_EPOCHS} "
        f"epochs in {wall:.2f}s: frozen params bitwise {same}, state "
        f"bitwise {same_state}, head moved {head_moved}; held-out accuracy "
        f"{acc:.4f} [{card}]")
    if not (same and same_state and head_moved):
        raise AssertionError("the transfer-learning freeze did not hold")
    out["transfer"] = {"frozen_layers": frozen, "epochs": TRANSFER_EPOCHS,
                       "seconds": wall, "heldout_accuracy": acc}


def phase_zoo(report, card):
    """The convolutional model library on the card; returns the launches
    of kernels 1-6 on its main path (none: every arm here is plain
    torch)."""
    import torch
    from deeplearning4j_tpu_torch.zoo.models import ResNet50
    t0 = time.perf_counter()
    out = {}
    if "train" in report:
        out["pallas_arm"] = {k: report["train"][k]
                             for k in ("step_ms", "images_per_s",
                                       "peak_memory_bytes")}
    seed_model = ResNet50(**ZOO_BENCH, fused_blocks=True,
                          fused_impl="xla").init(device="cpu")
    params_np, state_np = nontrivial_bn(seed_model)
    del seed_model
    for part in (lambda: _zoo_resnet_arms(out, card, params_np, state_np),
                 lambda: _zoo_grad_check(out, card, params_np, state_np),
                 lambda: _zoo_gram_rule(out, card),
                 lambda: _zoo_yolo2(out, card),
                 lambda: _zoo_others(out, card),
                 lambda: _zoo_transfer(out, card),
                 lambda: _zoo_vgg16(out, card)):
        t1 = time.perf_counter()
        part()
        torch.cuda.empty_cache()
        log(f"  ({time.perf_counter() - t1:.1f}s)")
    out["seconds"] = time.perf_counter() - t0
    log(f"  zoo phase: {out['seconds']:.1f}s [{card}]")
    report["zoo"] = out
    return {}


# ---------------------------------------------------------------------------
# keras_import: the Keras importer on committed configurations and weights
# ---------------------------------------------------------------------------

# The card's machine has neither h5py nor keras, so the importer's file
# reading stays on a CPU (modelimport/hdf5.py, held against h5py by the
# tests) and tools/keras_card_resources.py commits what the conversion
# needs under KERAS_RES: each fixture's model_config, Keras version and
# training_config (<name>.json) with the legacy-named weight dicts that
# Hdf5Archive.layer_weights returns (<name>.npz, "layer::key" entries); and
# for BERT-base and InceptionV3 the configuration with a manifest (each
# layer's weights in Keras order: their legacy keys and shape), whose
# weights both sides draw by seeded_keras_arrays, and Keras's outputs on
# those weights (<name>_golden.npz).
KERAS_RES = os.path.join("deeplearning4j_tpu_torch", "modelimport",
                         "resources")
KERAS_FIXTURES = ("k1_mlp", "k1_cnn_atrous", "k1_lstm", "k1_merge",
                  "k2_googlenet_bits", "k2_yolo_bits", "k2_temporal",
                  "k2_reshape_permute", "k2_selu_alpha_dropout", "k3_conv",
                  "k3_temporal", "k3_merges", "k3_attention",
                  "k3_pool_extras")
KERAS_SEED = 16


def keras_layer_seed(layer_name: str, seed: int = KERAS_SEED) -> int:
    """A layer's own seed, from a hash of its name: an order slip between
    the two sides moves that layer's weights, never every later layer's."""
    import hashlib
    digest = hashlib.sha256(f"{seed}:{layer_name}".encode()).digest()
    return int.from_bytes(digest[:8], "little")


def _keras_fans(shape):
    """Keras's glorot fans (keras.src.initializers: the receptive field is
    the product of all but the last two axes)."""
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    rf = math.prod(shape[:-2])
    return shape[-2] * rf, shape[-1] * rf


def seeded_keras_arrays(layer_name, groups, seed: int = KERAS_SEED):
    """The imported full-width models' weights, one array per (keys,
    shape) group of a layer in Keras's weight order, drawn from the
    layer's own generator: kernels glorot-uniform, embeddings, biases,
    beta and moving mean U(±0.05), gamma U(0.8, 1.2), moving variance
    U(0.5, 1.5). float32 uniforms mapped in float32. The one definition
    that tools/keras_card_resources.py (which sets these weights into
    Keras for the goldens) and the card's reader both call."""
    import numpy as np
    rng = np.random.default_rng(keras_layer_seed(layer_name, seed))
    out = []
    for keys, shape in groups:
        shape = tuple(int(d) for d in shape)
        leaf = keys[0].split("/")[-1]
        if leaf.endswith("kernel"):
            fan_in, fan_out = _keras_fans(shape)
            lim = math.sqrt(6.0 / (fan_in + fan_out))
            lo, hi = -lim, lim
        elif leaf in ("embeddings", "bias", "beta", "moving_mean"):
            lo, hi = -0.05, 0.05
        elif leaf == "gamma":
            lo, hi = 0.8, 1.2
        elif leaf == "moving_variance":
            lo, hi = 0.5, 1.5
        else:
            raise ValueError(f"no seeded rule for weight {keys[0]!r} of "
                             f"layer {layer_name!r}")
        u = rng.random(shape, dtype=np.float32)
        out.append(np.float32(lo) + np.float32(hi - lo) * u)
    return out


def inception_input(images_u8):
    """uint8 pixels -> InceptionV3's [-1, 1] input (numpy float32), as the
    resource tool and the card both make it."""
    import numpy as np
    return images_u8.astype(np.float32) / np.float32(127.5) - np.float32(1)


class KerasResourceArchive:
    """The importer's archive interface (modelimport/keras.py:
    ``model_config``, ``keras_version``, ``read_attribute_as_json``,
    ``layer_weights``) over a committed resource: ``<stem>.json`` and
    either ``<stem>.npz`` (a fixture's weight dicts) or the json's
    manifest, whose weights come from ``seeded_keras_arrays``."""

    def __init__(self, stem: str):
        import numpy as np
        with open(stem + ".json") as f:
            self._meta = json.load(f)
        self._dicts = None
        if os.path.exists(stem + ".npz"):
            self._dicts = {}
            with np.load(stem + ".npz") as z:
                for key in z.files:
                    layer, name = key.split("::", 1)
                    self._dicts.setdefault(layer, {})[name] = z[key]

    def model_config(self):
        return self._meta["model_config"]

    def keras_version(self) -> int:
        return int(self._meta["keras_version"])

    def read_attribute_as_json(self, name):
        value = self._meta.get(name)
        if value is None:
            raise KeyError(name)
        return value

    def layer_weights(self, name):
        if self._dicts is not None:
            return dict(self._dicts.get(name, {}))
        groups = self._meta["manifest"].get(name, [])
        out = {}
        for (keys, _), arr in zip(groups, seeded_keras_arrays(name, groups)):
            for k in keys:
                out[k] = arr
        return out


# the keras_import phase's bounds and sizes. Fixtures: each output within
# rtol 1e-4, atol 1e-5 of its _io.npz (tests/test_keras_fixtures.py:45).
# BERT-base f32: each position's |diff| within 1e-4 of that position's
# largest |Keras value| (the same f32 products summed in other orders
# through 12 blocks). InceptionV3 f32: rtol 1e-3, atol 1e-5
# (tests/test_keras_import.py:333), output and avg_pool features.
KERAS_FIXTURE_TOL = (1e-4, 1e-5)
KERAS_BERT_ROW_TOL = 1e-4
KERAS_IV3_TOL = (1e-3, 1e-5)
# the fixtures' kernel launches per output() call: k3_attention attends
# once (3 heads x Dh 4), k1_lstm runs one LSTM, k3_temporal a
# Bidirectional(LSTM) (the forward kernel twice)
KERAS_FIXTURE_LAUNCHES = {"k3_attention": {"flash_fwd": 1},
                          "k1_lstm": {"lstm_fwd": 1},
                          "k3_temporal": {"lstm_fwd": 2}}
# the imported BERT-base: bf16 output() at 64 x 128; the fine-tune of
# benchmarks/baseline_suite.py:296-356 (AVG pooling + 2-class head,
# bf16 compute, Adam(2e-5), shadow cast) at 128 x 128 in K-step calls (the
# suite's K is 16; 4 keeps the phase short); the frozen-encoder variant of
# tests/test_bert_finetune.py:63-120 at 32 x 128, Adam(1e-2)
KERAS_BERT_SERVE_BATCH = 64
KERAS_BERT_FT_BATCH, KERAS_BERT_FT_K, KERAS_BERT_FT_CALLS = 128, 4, 3
KERAS_BERT_FROZEN_BATCH = 32
# the imported InceptionV3: f32 inference at 128; the fine-tune of
# benchmarks/baseline_suite.py:216-270 (200 classes by n_out_replace, bf16
# compute, Adam(1e-4)) at 64 in K-step calls
KERAS_IV3_SERVE_BATCH = 128
KERAS_IV3_FT_BATCH, KERAS_IV3_FT_K, KERAS_IV3_FT_CALLS = 64, 4, 2
# item 4a on the card: the committed TextGenerationLSTM at 32 x 60 corpus
# windows under Sgd (Adam's first step turns a sign flip of a near-zero
# gradient into a full step), card against CPU within DIGITS_PARAM_TOL;
# DropConnect's zero share within 5 sigma of p; WeightNoise's mean and
# standard deviation; LBFGS and CG on the digits LeNet from its seed
KERAS_4A_BATCH, KERAS_4A_LR = 32, 0.5
KERAS_4A_DROP, KERAS_4A_NOISE = 0.3, 0.01
KERAS_4A_ITERS, KERAS_4A_ROWS = 3, 256


def _kernel_counts():
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    return {**fa.LAUNCHES, **fl.LAUNCHES}


def _counted(launches, fn):
    """``fn()``, with the kernel launches it made added to ``launches``
    (the phase's main-path count) and returned."""
    before = _kernel_counts()
    out = fn()
    import torch
    torch.cuda.synchronize()
    made = {k: v - before[k] for k, v in _kernel_counts().items()}
    for k, v in made.items():
        launches[k] = launches.get(k, 0) + v
    return out, {k: v for k, v in made.items() if v}


def keras_resource(name):
    """The committed resource ``name`` as an archive, with the host seconds
    its weights take to read or draw."""
    arch = KerasResourceArchive(os.path.join(KERAS_RES, name))
    weights = arch.layer_weights
    arch.weight_seconds = 0.0

    def timed(layer):
        t0 = time.perf_counter()
        out = weights(layer)
        arch.weight_seconds += time.perf_counter() - t0
        return out
    arch.layer_weights = timed
    return arch


def _keras_fixtures(out, card, launches):
    """The 14 fixtures through the importer on the card, against their
    _io.npz; one imported LSTM's Adam step, its gradients against the
    plain path."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.modelimport.keras import _import_archive
    from deeplearning4j_tpu_torch.models.serialization import flatten_paths
    from deeplearning4j_tpu_torch.nn.transferlearning import (
        FineTuneConfiguration, TransferLearning)
    from deeplearning4j_tpu_torch.optimize import solver
    from deeplearning4j_tpu_torch.optimize.updaters import Adam
    rtol, atol = KERAS_FIXTURE_TOL
    rows = {}
    for name in KERAS_FIXTURES:
        model = _import_archive(keras_resource(name), "cuda")
        io = np.load(os.path.join("tests", "resources", "keras",
                                  name + "_io.npz"))
        y, made = _counted(launches, lambda: model.output(io["x"]))
        y = y.float().cpu().numpy()
        ok = y.shape == io["y"].shape and bool(
            np.allclose(y, io["y"], rtol=rtol, atol=atol))
        err = float(np.abs(y - io["y"]).max()) if y.shape == io["y"].shape \
            else math.inf
        want = KERAS_FIXTURE_LAUNCHES.get(name, {})
        rows[name] = {"model": type(model).__name__, "max_abs_err": err,
                      "ok": ok, "launches": made}
        log(f"  {name:22s} {type(model).__name__:17s} max|diff| {err:.3g} "
            f"launches {made or '-'}{'' if ok else '  <-- DISAGREES'}")
        if not ok:
            raise AssertionError(f"fixture {name}: the card's output is not "
                                 f"within rtol {rtol}, atol {atol} of its "
                                 "_io.npz")
        if made != want:
            raise AssertionError(f"fixture {name}: launches {made}, expected "
                                 f"{want}")

    # k1_lstm fine-tuned by Adam: one fit step through lstm_fwd + lstm_bwd
    base = _import_archive(keras_resource("k1_lstm"), "cuda")
    ft = (TransferLearning.Builder(base).fine_tune_configuration(
        FineTuneConfiguration.Builder().updater(Adam(1e-3)).build()).build())
    rng = np.random.default_rng(4)
    x = rng.normal(size=(16, 7, 6)).astype(np.float32)
    y = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 16)]
    before = {k: v.clone() for k, v in flatten_paths(ft.params).items()}
    _, made = _counted(launches, lambda: ft.fit(DataSet(x, y)))
    loss = ft.score()
    after = flatten_paths(ft.params)
    moved = sum(int(not torch.equal(after[k], before[k])) for k in before)
    args = ft._step_args(DataSet(x, y))
    loss_k, _, g_k = solver.value_and_grad(ft._loss, ft.train_state, *args)
    with plain_lstm():
        loss_p, _, g_p = solver.value_and_grad(ft._loss, ft.train_state,
                                               *args)
    err = grad_errors(g_k, g_p)
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    log(f"  k1_lstm + Adam(1e-3): one fit step, launches {made}, loss "
        f"{loss:.5f}, {moved} of {len(before)} arrays moved; gradients "
        f"kernels vs plain rel L2 worst {err['worst']:.3g} ({err['name']}), "
        f"loss rel {loss_err:.3g}")
    if made != {"lstm_fwd": 1, "lstm_bwd": 1} or not math.isfinite(loss) \
            or moved != len(before) or ft.iteration != 1:
        raise AssertionError("the imported LSTM's Adam step did not run "
                             "through lstm_fwd and lstm_bwd and move every "
                             "array")
    if loss_err > LOSS_RTOL or err["worst"] > LSTM_GRAD_RTOL:
        raise AssertionError("the imported LSTM's gradients through the "
                             "kernels disagree with the plain path")
    out["fixtures"] = rows
    out["lstm_adam_step"] = {"launches": made, "loss": loss,
                             "grad_rel_l2": err, "loss_rel_err": loss_err}


def _bert_graft(model, dtype, lr, frozen=False):
    """The fine-tune of benchmarks/baseline_suite.py:296-356: AVG pooling
    and a 2-class OutputLayer grafted on the imported encoder by
    TransferLearning.GraphBuilder; ``frozen`` freezes the encoder
    (tests/test_bert_finetune.py:63-120)."""
    from deeplearning4j_tpu_torch.nn.layers.output import (
        GlobalPoolingLayer, OutputLayer, PoolingType)
    from deeplearning4j_tpu_torch.nn.transferlearning import (
        FineTuneConfiguration, TransferLearning)
    from deeplearning4j_tpu_torch.optimize.updaters import Adam
    enc = model.conf.network_outputs[0]
    ftc = FineTuneConfiguration.Builder().updater(Adam(lr))
    if dtype == "bfloat16":
        ftc = ftc.compute_dtype("bfloat16")
    gb = TransferLearning.GraphBuilder(model).fine_tune_configuration(
        ftc.build())
    if frozen:
        gb = gb.set_feature_extractor(enc)
    return (gb.add_layer("pool", GlobalPoolingLayer(
        pooling_type=PoolingType.AVG), enc)
        .add_layer("cls", OutputLayer(n_out=2), "pool")
        .set_outputs("cls").build())


def _bert_batch(rng, n, seq, vocab, k=None):
    """(ids, positions) as int64 on the card (an id is cast once, by the
    embedding's gather; bf16 compute never sees it), one-hot 2-class
    labels; stacked K times when ``k`` is given."""
    import numpy as np
    import torch
    ids = torch.from_numpy(rng.integers(0, vocab, (n, seq))).cuda()
    pos = torch.arange(seq, device="cuda").expand(n, seq)
    y = torch.from_numpy(np.eye(2, dtype=np.float32)[
        rng.integers(0, 2, n)]).cuda()
    if k is None:
        return (ids, pos), (y,)
    st = lambda a: a.unsqueeze(0).expand(k, *a.shape)
    return (st(ids), st(pos)), (st(y),)


def _same_state(a, b):
    """Bitwise equality of two parameter dicts."""
    import torch
    from deeplearning4j_tpu_torch.models.serialization import flatten_paths
    fa, fb = flatten_paths(a), flatten_paths(b)
    return fa.keys() == fb.keys() and all(torch.equal(fa[k], fb[k])
                                          for k in fa)


def _keras_bert(out, card, launches):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.modelimport.keras import _import_archive
    from deeplearning4j_tpu_torch.models.base import cast_params
    from deeplearning4j_tpu_torch.models.serialization import flatten_paths
    from deeplearning4j_tpu_torch.nn.layers.attention import \
        SelfAttentionLayer
    from deeplearning4j_tpu_torch.nn.transferlearning import (
        FineTuneConfiguration, TransferLearning)
    from deeplearning4j_tpu_torch.optimize import solver
    res = {}
    arch = keras_resource("bert_base")
    t0 = time.perf_counter()
    model = _import_archive(arch, "cuda")
    torch.cuda.synchronize()
    res["import_s"] = time.perf_counter() - t0
    res["weight_draw_s"] = arch.weight_seconds
    g = np.load(os.path.join(KERAS_RES, "bert_base_golden.npz"))
    ids = torch.from_numpy(g["ids"]).long().cuda()
    seq = ids.shape[1]
    pos = torch.arange(seq, device="cuda").expand_as(ids)
    blocks = sum(isinstance(n.layer, SelfAttentionLayer)
                 for n in model.conf.nodes)
    h, made = _counted(launches, lambda: model.output(ids, pos))
    e = g["hidden_head"].shape[1]
    got = torch.cat([h[:, :e], h[:, -e:]], 1).float().cpu()
    ref = torch.from_numpy(np.concatenate([g["hidden_head"],
                                           g["hidden_tail"]], 1))
    err = ((got - ref).abs().amax(-1) / ref.abs().amax(-1)).max().item()
    log(f"  BERT-base imported: {model.num_params()} params, import "
        f"{res['import_s']:.1f}s of which {res['weight_draw_s']:.1f}s draw "
        f"the seeded weights; f32 output of {tuple(ids.shape)} against "
        f"Keras at {2 * e} positions: |diff| / position max {err:.3g} "
        f"(absolute {(got - ref).abs().max().item():.3g}), launches {made}")
    if not err <= KERAS_BERT_ROW_TOL or made != {"flash_fwd": blocks}:
        raise AssertionError("the imported BERT-base disagrees with Keras "
                             f"(or did not attend through {blocks} flash_fwd "
                             "launches)")
    res["f32_row_rel_err"] = err
    vocab = model.params["tok_embed"]["W"].shape[0]

    # bf16 output() at 64 x 128
    m16 = (TransferLearning.GraphBuilder(model).fine_tune_configuration(
        FineTuneConfiguration.Builder().compute_dtype("bfloat16").build())
        .build())
    rng = np.random.default_rng(6)
    (ids64, pos64), _ = _bert_batch(rng, KERAS_BERT_SERVE_BATCH, seq, vocab)
    torch.cuda.reset_peak_memory_stats()
    y16, made = _counted(launches, lambda: m16.output(ids64, pos64))
    peak = torch.cuda.max_memory_allocated()
    if made != {"flash_fwd": blocks} or not torch.isfinite(y16).all() or \
            tuple(y16.shape) != (KERAS_BERT_SERVE_BATCH, seq, h.shape[-1]):
        raise AssertionError(f"bf16 output(): launches {made} (expected "
                             f"{blocks} flash_fwd) or a non-finite or "
                             "misshapen output")
    with torch.inference_mode():
        out_ms = cuda_time(lambda: m16.output(ids64, pos64), iters=10)
    tok = KERAS_BERT_SERVE_BATCH * seq
    log(f"  bf16 output() at {KERAS_BERT_SERVE_BATCH} x {seq}: {out_ms:.3f} "
        f"ms, {1e3 * tok / out_ms:.1f} tokens/s, peak memory "
        f"{peak / 2**20:.1f} MiB, launches {made} a call [{card}]")
    res["serve"] = {"batch": KERAS_BERT_SERVE_BATCH, "output_ms": out_ms,
                    "tokens_per_s": 1e3 * tok / out_ms,
                    "peak_memory_bytes": peak, "launches_per_call": made}
    del m16, y16

    # the bf16 fine-tune with the shadow cast, and the same call without it
    b, k = KERAS_BERT_FT_BATCH, KERAS_BERT_FT_K
    ft = _bert_graft(model, "bfloat16", 2e-5)
    twin = ft.clone()
    feats, labels = _bert_batch(np.random.default_rng(0), b, seq, vocab, k)
    shadow = ft._build_scan_train_step(
        shadow_cast=lambda p: cast_params(p, "bfloat16"))
    plain = twin._build_scan_train_step()
    torch.cuda.reset_peak_memory_stats()
    (ts, l0), made = _counted(launches, lambda: shadow(ft.train_state, feats,
                                                       labels))
    twin.train_state, l0_plain = plain(twin.train_state, feats, labels)
    bitwise = torch.equal(l0, l0_plain) and _same_state(ts.params,
                                                        twin.params)
    ft.train_state = ts
    del twin
    want = {n: k * blocks for n in ATTN_KERNELS}
    log(f"  fine-tune bf16 at {b} x {seq}, K={k}: launches of one call "
        f"{made}; the shadow-cast call against the same call without it: "
        f"{'bitwise' if bitwise else 'DIFFERENT'}")
    if made != want:
        raise AssertionError(f"expected {want} flash launches a call")
    if not bitwise:
        raise AssertionError("the shadow-cast call is not bitwise the same "
                             "call without it")
    losses = [l0]
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(KERAS_BERT_FT_CALLS - 1):
        (ft.train_state, ls), _ = _counted(
            launches, lambda: shadow(ft.train_state, feats, labels))
        losses.append(ls)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / ((KERAS_BERT_FT_CALLS - 1) * k)
    peak = torch.cuda.max_memory_allocated()
    losses = torch.cat(losses).float().cpu().numpy()
    log(f"  fine-tune step: {step_ms:.3f} ms, {1e3 * b * seq / step_ms:.1f} "
        f"tokens/s, peak memory {peak / 2**20:.1f} MiB [{card}]; losses "
        f"{' '.join(f'{v:.4f}' for v in losses)}")
    if not np.isfinite(losses).all() or not losses[1:].min() < losses[0]:
        raise AssertionError("the fine-tune loss did not fall (or is not "
                             "finite)")
    res["finetune"] = {"batch": b, "seq": seq, "k": k,
                       "losses": losses.tolist(), "step_ms": step_ms,
                       "tokens_per_s": 1e3 * b * seq / step_ms,
                       "peak_memory_bytes": peak, "launches_per_call": made,
                       "shadow_bitwise": bitwise}
    del ft, shadow, plain, feats, labels
    torch.cuda.empty_cache()

    # one f32 step of the grafted model: kernels against plain versions
    ft32 = _bert_graft(model, "float32", 2e-5)
    (f4, p4), (y4,) = _bert_batch(np.random.default_rng(1), 4, seq, vocab)
    args = ft32._step_args(MultiDataSet((f4, p4), (y4,)))
    loss_k, _, g_k = solver.value_and_grad(ft32._loss, ft32.train_state,
                                           *args)
    with plain_flash():
        loss_p, _, g_p = solver.value_and_grad(ft32._loss, ft32.train_state,
                                               *args)
    gerr = grad_errors(g_k, g_p)
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    log(f"  f32 fine-tune step at 4 x {seq}, kernels vs plain: loss rel "
        f"{loss_err:.3g}, gradients rel L2 worst {gerr['worst']:.3g} "
        f"({gerr['name']}), median {gerr['median']:.3g}, all "
        f"{gerr['all']:.3g}")
    if loss_err > LOSS_RTOL or gerr["worst"] > BERT_GRAD_RTOL:
        raise AssertionError("the f32 fine-tune step through the flash "
                             "kernels disagrees with the plain path")
    res["f32_step"] = {"loss_rel_err": loss_err, "grad_rel_l2": gerr}
    del ft32, g_k, g_p

    # the frozen encoder (set_feature_extractor): frozen leaves bitwise
    fz = _bert_graft(model, "bfloat16", 1e-2, frozen=True)
    frozen_names = [n for n in fz.layer_names if n not in ("pool", "cls")]
    snap = {n: {k: v.clone() for k, v in
                flatten_paths(fz.params[n]).items()} for n in frozen_names}
    head = fz.params["cls"]["W"].clone()
    feats, labels = _bert_batch(np.random.default_rng(2),
                                KERAS_BERT_FROZEN_BATCH, seq, vocab, k)
    step = fz._build_scan_train_step(
        shadow_cast=lambda p: cast_params(p, "bfloat16"))
    (fz.train_state, fl_), made = _counted(
        launches, lambda: step(fz.train_state, feats, labels))
    kept = all(_same_state(snap[n], flatten_paths(fz.params[n]))
               for n in frozen_names)
    moved = not torch.equal(head, fz.params["cls"]["W"])
    log(f"  frozen encoder at {KERAS_BERT_FROZEN_BATCH} x {seq}, K={k}: "
        f"{len(frozen_names)} frozen layers "
        f"{'bitwise unchanged' if kept else 'CHANGED'}, the head "
        f"{'moved' if moved else 'DID NOT MOVE'}, launches {made}, losses "
        f"{' '.join(f'{v:.4f}' for v in fl_.float().cpu().tolist())}")
    if not kept or not moved or not torch.isfinite(fl_).all():
        raise AssertionError("the frozen-encoder fine-tune changed a frozen "
                             "leaf or left the head as it was")
    res["frozen"] = {"layers": len(frozen_names), "launches": made}
    out["bert_base"] = res


def _keras_inception(out, card, launches):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.modelimport.keras import _import_archive
    from deeplearning4j_tpu_torch.nn.transferlearning import (
        FineTuneConfiguration, TransferLearning)
    from deeplearning4j_tpu_torch.optimize.updaters import Adam
    res = {}
    arch = keras_resource("inception_v3")
    t0 = time.perf_counter()
    model = _import_archive(arch, "cuda")
    torch.cuda.synchronize()
    res["import_s"] = time.perf_counter() - t0
    res["weight_draw_s"] = arch.weight_seconds
    g = np.load(os.path.join(KERAS_RES, "inception_v3_golden.npz"))
    x = torch.from_numpy(inception_input(g["images_u8"])).cuda()
    inp, head = model.conf.network_inputs[0], model.conf.network_outputs[0]
    with torch.inference_mode():
        acts, _ = model._walk(model.params, model.model_state, {inp: x})
    rtol, atol = KERAS_IV3_TOL
    errs = {}
    for what, key in ((head, "predictions"), ("avg_pool", "avg_pool")):
        got = acts[what].float().cpu().numpy()
        ref = g[key]
        errs[key] = {"max_abs": float(np.abs(got - ref).max()),
                     "max_rel": float((np.abs(got - ref) /
                                       np.maximum(np.abs(ref), 1e-30)).max()),
                     "ok": bool(np.allclose(got, ref, rtol=rtol, atol=atol))}
    log(f"  InceptionV3 imported: {model.num_params()} params, import "
        f"{res['import_s']:.1f}s of which {res['weight_draw_s']:.1f}s draw "
        f"the seeded weights; f32 against Keras on 2 images: " + ", ".join(
            f"{k} max|diff| {v['max_abs']:.3g} (rel {v['max_rel']:.3g})"
            for k, v in errs.items()))
    if not all(v["ok"] for v in errs.values()):
        raise AssertionError(f"the imported InceptionV3 is not within rtol "
                             f"{rtol}, atol {atol} of Keras")
    res["vs_keras"] = errs

    rng = np.random.default_rng(8)
    side = g["images_u8"].shape[1:]
    xb = torch.from_numpy(inception_input(rng.integers(
        0, 256, (KERAS_IV3_SERVE_BATCH,) + side, dtype=np.uint8))).cuda()
    torch.cuda.reset_peak_memory_stats()
    yb = model.output(xb)
    peak = torch.cuda.max_memory_allocated()
    if not torch.isfinite(yb).all():
        raise AssertionError("InceptionV3 output at batch 128 not finite")
    ms = cuda_time(lambda: model.output(xb), iters=5, warmup=1)
    log(f"  f32 output() at {KERAS_IV3_SERVE_BATCH}: {ms:.3f} ms, "
        f"{1e3 * KERAS_IV3_SERVE_BATCH / ms:.1f} images/s, peak memory "
        f"{peak / 2**20:.1f} MiB [{card}]")
    res["serve"] = {"batch": KERAS_IV3_SERVE_BATCH, "output_ms": ms,
                    "images_per_s": 1e3 * KERAS_IV3_SERVE_BATCH / ms,
                    "peak_memory_bytes": peak}
    del xb, yb, acts

    b, k = KERAS_IV3_FT_BATCH, KERAS_IV3_FT_K
    ft = (TransferLearning.GraphBuilder(model).fine_tune_configuration(
        FineTuneConfiguration.Builder().updater(Adam(1e-4))
        .compute_dtype("bfloat16").build())
        .n_out_replace(head, 200).build())
    del model
    x = torch.from_numpy(rng.normal(size=(b,) + side)
                         .astype(np.float32)).cuda()
    y = torch.zeros((b, 200), device="cuda")
    y[torch.arange(b), torch.from_numpy(rng.integers(0, 200, b)).cuda()] = 1
    xs, ys = x.unsqueeze(0).expand(k, *x.shape), y.unsqueeze(0).expand(
        k, *y.shape)
    scan = ft._build_scan_train_step()
    torch.cuda.reset_peak_memory_stats()
    (ft.train_state, l0), made = _counted(
        launches, lambda: scan(ft.train_state, (xs,), (ys,)))
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    losses = [l0]
    start.record()
    for _ in range(KERAS_IV3_FT_CALLS - 1):
        ft.train_state, ls = scan(ft.train_state, (xs,), (ys,))
        losses.append(ls)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / ((KERAS_IV3_FT_CALLS - 1) * k)
    peak = torch.cuda.max_memory_allocated()
    losses = torch.cat(losses).float().cpu().numpy()
    log(f"  fine-tune bf16 at {b}, K={k}: {step_ms:.3f} ms a step, "
        f"{1e3 * b / step_ms:.1f} images/s, peak memory {peak / 2**20:.1f} "
        f"MiB [{card}]; kernel launches {made or 'none'}; losses "
        f"{' '.join(f'{v:.4f}' for v in losses)}")
    if not np.isfinite(losses).all() or losses.max() == losses.min() \
            or made:
        raise AssertionError("the InceptionV3 fine-tune loss is not finite "
                             "or does not move (or a TPU kernel ran)")
    res["finetune"] = {"batch": b, "k": k, "losses": losses.tolist(),
                       "step_ms": step_ms, "images_per_s": 1e3 * b / step_ms,
                       "peak_memory_bytes": peak}
    out["inception_v3"] = res


def _lstm_4a(layer_kw, device):
    """The committed TextGenerationLSTM's configuration with ``layer_kw``
    (constraints, weight noise) set on every layer and Sgd(KERAS_4A_LR),
    on ``device``, from the committed weights."""
    import dataclasses
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.optimize.updaters import Sgd
    from deeplearning4j_tpu_torch.zoo.models import TextGenerationLSTM
    base = TextGenerationLSTM().init_pretrained(device=device)
    conf = base.conf
    g = dataclasses.replace(conf.global_config, updater=Sgd(KERAS_4A_LR))
    conf = dataclasses.replace(
        conf, global_config=g,
        layers=tuple(dataclasses.replace(l, **layer_kw) for l in conf.layers))
    m = MultiLayerNetwork(conf, device=device).init()
    m.set_params(base.params, base.model_state)
    return m


def _keras_4a(out, card, launches):
    """Constraints, weight noise and the legacy optimizers on the card."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.fetchers import \
        DigitsDataSetIterator
    from deeplearning4j_tpu_torch.nn.constraints import MaxNormConstraint
    from deeplearning4j_tpu_torch.nn.distributions import NormalDistribution
    from deeplearning4j_tpu_torch.nn.weightnoise import (DropConnect,
                                                         WeightNoise)
    from deeplearning4j_tpu_torch.optimize import solver
    from deeplearning4j_tpu_torch.optimize.legacy import optimize_model
    from deeplearning4j_tpu_torch.zoo.models import LeNet
    res = {}
    x_np, y_ids, _ = corpus_windows(KERAS_4A_BATCH, 60,
                                    np.random.default_rng(11))
    ds = DataSet(x_np, np.eye(77, dtype=np.float32)[y_ids])
    norms = lambda w: torch.linalg.norm(w.float().reshape(-1, w.shape[-1]),
                                        dim=0)

    # MaxNorm at the median column norm of the first LSTM's Wx
    probe = _lstm_4a({}, "cpu")
    c = float(norms(probe.params["layer_0"]["Wx"]).median())
    kw = {"constraints": (MaxNormConstraint(max_norm=c),)}
    card_m, cpu_m, free = (_lstm_4a(kw, "cuda"), _lstm_4a(kw, "cpu"),
                           _lstm_4a({}, "cuda"))
    _, made = _counted(launches, lambda: card_m.fit(ds))
    cpu_m.fit(ds)
    free.fit(ds)
    err, worst = rel_param_err(card_m.params, cpu_m.params)
    top = max(norms(v).max().item() for n, lp in card_m.params.items()
              for k, v in lp.items() if k != "b")
    bound = not _same_state(card_m.params, free.params)
    log(f"  MaxNorm({c:.4f}) on the TextGenerationLSTM, one Sgd step at "
        f"{KERAS_4A_BATCH} x 60: card vs CPU {err:.3g} ({worst}); largest "
        f"column norm after {top:.6f}; "
        f"{'binds' if bound else 'DOES NOT BIND'}; launches {made}")
    if err > DIGITS_PARAM_TOL or top > c * (1 + 1e-5) or not bound or \
            made != {"lstm_fwd": 2, "lstm_bwd": 2}:
        raise AssertionError("the constrained step disagrees with the CPU, "
                             "leaves a column above the max norm, or did "
                             "not run through the LSTM kernels")
    res["max_norm"] = {"max_norm": c, "card_vs_cpu": err, "launches": made}
    del card_m, cpu_m, free

    # DropConnect at rate 0: its noise is the identity, bitwise, and its
    # step the plain step within DIGITS_PARAM_TOL (bitwise on the CPU,
    # tests/test_torch_constraints_noise.py; on an H100 the rate-0 step
    # read 2.37e-08 from the plain one, which repeats bitwise: the log
    # names the gradient that differs most); at 0.3 its zeros and its
    # scaling; a noisy step through the kernels
    zero, plain, again = (_lstm_4a({"weight_noise": DropConnect(p=0.0)},
                                   "cuda"), _lstm_4a({}, "cuda"),
                          _lstm_4a({}, "cuda"))
    gen = torch.Generator(device="cuda").manual_seed(0)
    noised = DropConnect(p=0.0).apply_noise(plain.params, gen)
    ident = _same_state(noised, plain.params)
    args = plain._step_args(ds)
    g_zero = solver.value_and_grad(zero._loss, zero.train_state, *args,
                                   generator=zero._generator)[2]
    g_plain = solver.value_and_grad(plain._loss, plain.train_state,
                                    *args)[2]
    gdiff = grad_errors(g_zero, g_plain)
    _, made0 = _counted(launches, lambda: zero.fit(ds))
    plain.fit(ds)
    again.fit(ds)
    same = _same_state(zero.params, plain.params) and \
        zero.score() == plain.score()
    repeat = _same_state(again.params, plain.params)
    err0 = rel_param_err(zero.params, plain.params)[0]
    err_repeat = rel_param_err(again.params, plain.params)[0]
    w = plain.params["layer_0"]["Wx"]
    dropped = DropConnect(p=KERAS_4A_DROP).apply_noise({"Wx": w}, gen)["Wx"]
    share = (dropped == 0).float().mean().item()
    sigma = math.sqrt(KERAS_4A_DROP * (1 - KERAS_4A_DROP) / w.numel())
    kept = dropped != 0
    scaled = torch.equal(dropped[kept], (w / (1 - KERAS_4A_DROP))[kept])
    noisy = WeightNoise(NormalDistribution(0.0, KERAS_4A_NOISE)).apply_noise(
        {"Wx": w}, gen)["Wx"] - w
    mean, std = noisy.mean().item(), noisy.std().item()
    noisy_m = _lstm_4a({"weight_noise": DropConnect(p=KERAS_4A_DROP)},
                       "cuda")
    _, made1 = _counted(launches, lambda: noisy_m.fit(ds))
    log(f"  DropConnect(0): noise "
        f"{'the identity' if ident else 'NOT the identity'}; its step "
        f"{'bitwise' if same else 'not bitwise'} the "
        f"plain step ({err0:.3g}; the plain step against its repeat "
        f"{'bitwise' if repeat else f'{err_repeat:.3g}'}; gradients rel "
        f"L2 worst {gdiff['worst']:.3g} ({gdiff['name']}); launches "
        f"{made0}); DropConnect({KERAS_4A_DROP}) zeros "
        f"{share:.5f} (sigma {sigma:.2g}), kept weights "
        f"{'exactly' if scaled else 'NOT'} w/(1-p); WeightNoise N(0, "
        f"{KERAS_4A_NOISE}) mean {mean:.3g}, std {std:.5f}; a DropConnect "
        f"step: loss {noisy_m.score():.4f}, launches {made1}")
    if not ident or err0 > DIGITS_PARAM_TOL or \
            abs(share - KERAS_4A_DROP) > 5 * sigma or not scaled or \
            abs(mean) > 5 * KERAS_4A_NOISE / math.sqrt(w.numel()) or \
            abs(std / KERAS_4A_NOISE - 1) > 0.02 or \
            not math.isfinite(noisy_m.score()) or \
            made1 != {"lstm_fwd": 2, "lstm_bwd": 2}:
        raise AssertionError("weight noise: the rate-0 step is not the plain "
                             "step, or the noise's statistics are off")
    res["weight_noise"] = {"rate0_identity": ident, "rate0_bitwise": same,
                           "rate0_err": err0, "plain_repeat_bitwise": repeat,
                           "plain_repeat_err": err_repeat,
                           "rate0_grad_rel_l2": gdiff, "zero_share": share,
                           "noise_mean": mean, "noise_std": std}
    del zero, plain, again, noisy_m

    # LBFGS and conjugate gradient on the digits LeNet from its seed
    images, labels = DigitsDataSetIterator.fetch(train=True)
    dd = DataSet(images[:KERAS_4A_ROWS], np.eye(10, dtype=np.float32)[
        labels[:KERAS_4A_ROWS]])
    res["legacy"] = {}
    for algo in ("lbfgs", "cg"):
        runs = {}
        for dev in ("cuda", "cpu"):
            m = LeNet().init(device=dev)
            t0 = time.perf_counter()
            with torch.backends.cudnn.flags(enabled=False):
                r = optimize_model(m, dd, algo, KERAS_4A_ITERS, 0.0)
            runs[dev] = (m, r, time.perf_counter() - t0)
        (mc, rc, sc), (mp, rp, _) = runs["cuda"], runs["cpu"]
        perr, worst = rel_param_err(mc.params, mp.params)
        lerr = abs(rc.loss - rp.loss) / abs(rp.loss)
        log(f"  {algo}: {rc.iterations} iterations, loss {rc.loss:.6f} "
            f"(CPU {rp.loss:.6f}, {rp.iterations}); card vs CPU loss rel "
            f"{lerr:.3g}, params {perr:.3g} ({worst}); {sc:.2f}s on the card "
            "(cuDNN off)")
        if rc.iterations != rp.iterations or rc.iterations < 1 or \
                lerr > DIGITS_PARAM_TOL or perr > DIGITS_PARAM_TOL:
            raise AssertionError(f"{algo} on the card disagrees with the CPU")
        res["legacy"][algo] = {"iterations": rc.iterations, "loss": rc.loss,
                               "loss_rel_err": lerr, "param_err": perr,
                               "seconds": sc}
    out["item_4a"] = res


def phase_keras_import(report, card):
    """The Keras importer on the card; returns the flash and LSTM kernel
    launches of its main paths."""
    import torch
    t0 = time.perf_counter()
    out, launches = {}, {}
    for name, part in (("fixtures", _keras_fixtures),
                       ("bert_base", _keras_bert),
                       ("inception_v3", _keras_inception),
                       ("item_4a", _keras_4a)):
        t1 = time.perf_counter()
        log(f"  [{name}]")
        part(out, card, launches)
        torch.cuda.empty_cache()
        log(f"  ({time.perf_counter() - t1:.1f}s)")
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = dict(launches)
    log(f"  keras_import phase: {out['seconds']:.1f}s, main-path launches "
        f"{launches} [{card}]")
    report["keras_import"] = out
    return launches


# ---------------------------------------------------------------------------
# the observed training loop: listeners, telemetry, tracer, flight recorder,
# early stopping, StatsListener and record readers through fit(iterator)
# ---------------------------------------------------------------------------

OBS_BATCH, OBS_K, OBS_CALLS, OBS_EPOCHS = 128, 4, 2, 2   # 8 steps an epoch
OBS_FLUSH, OBS_HIST_INTERVAL = 8, 4
OBS_HELD_OUT = 256
OBS_GRAD_RTOL = 1e-5
OBS_REPEATS = 1                 # 2 before PR 24
OBS_TBPTT_BATCHES = 2
OBS_BERT_CALLS = 2
OBS_SERVE_REQUESTS = 16
OBS_SCRATCH = os.path.join("build", "observed_fit")   # large files, removed


class _SyncGuard:
    """Sync debug mode "error" around the telemetry record of every step,
    every collector step that does not flush and the listeners' calls,
    armed after the model's first flush (the record's first call builds
    its constants on the card). ``calls`` counts the guarded calls."""

    def __init__(self, torch, collector):
        self.torch = torch
        self.tc = collector
        self.armed = False
        self.calls = {"record": 0, "on_step": 0, "listeners": 0}
        record, on_step = collector.spec.record, collector.on_step

        def guarded_record(*a, **k):
            with self.region("record"):
                return record(*a, **k)

        def guarded_on_step(ts, steps=1):
            if collector.will_flush(steps):
                on_step(ts, steps)
                self.armed = True
                return
            with self.region("on_step"):
                on_step(ts, steps)
        collector.spec.record = guarded_record
        collector.on_step = guarded_on_step

    def region(self, what):
        import contextlib
        guard = self

        @contextlib.contextmanager
        def cm():
            if not guard.armed:
                yield
                return
            guard.calls[what] += 1
            guard.torch.cuda.set_sync_debug_mode("error")
            try:
                yield
            finally:
                guard.torch.cuda.set_sync_debug_mode("default")
        return cm()

    def listeners(self, inner):
        """``inner`` wrapped: its iteration_done calls run guarded."""
        from deeplearning4j_tpu_torch.optimize.listeners import \
            TrainingListener
        guard = self

        class Guarded(TrainingListener):
            def on_epoch_start(self, model, epoch):
                for lst in inner:
                    lst.on_epoch_start(model, epoch)

            def on_epoch_end(self, model, epoch):
                for lst in inner:
                    lst.on_epoch_end(model, epoch)

            def iteration_done(self, *args):
                with guard.region("listeners"):
                    for lst in inner:
                        lst.iteration_done(*args)

            def on_crash_dump(self, model, path, reason):
                for lst in inner:
                    lst.on_crash_dump(model, path, reason)
        return Guarded()


def _spy(step, log_to, counters=()):
    """``step`` wrapped: each call's returned losses (and, per counter
    module, the launches it made) are appended to ``log_to``."""
    def call(ts, *args):
        before = [dict(m.LAUNCHES) for m in counters]
        ts, losses = step(ts, *args)
        made = {}
        for m, b in zip(counters, before):
            made.update({k: m.LAUNCHES[k] - b[k] for k in b})
        log_to.append((losses, made))
        return ts, losses
    return call


def _flushes_expected(calls_per_fit, k, interval):
    """The collector's fetches over fits of ``calls_per_fit`` K-step calls
    each: one whenever ``interval`` steps have accumulated, and the tail
    flush that ends every fit."""
    n, pending = 0, 0
    for calls in calls_per_fit:
        for _ in range(calls):
            pending += k
            if pending >= interval:
                n, pending = n + 1, 0
        n, pending = n + 1, 0
    return n


def _hand_kernel_counts(fn):
    """{device kernel: launches} of one call of ``fn`` (torch.profiler,
    the card's activity only) for the hand-written kernels: every CUDA
    kernel of csrc/ lives in the ``dl4j`` namespace."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type.name == "CUDA" and "dl4j::" in e.key}


def _sync_sites(fn):
    """{python file:line: count} of the synchronizing CUDA operations one
    call of ``fn`` makes (sync debug mode "warn")."""
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{os.path.relpath(w.filename)}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return sites


def _params_equal(a, b):
    from deeplearning4j_tpu_torch.models.serialization import flatten_paths
    fa, fb = flatten_paths(a), flatten_paths(b)
    bad = [k for k in fb if not fa[k].equal(fb[k])]
    return not bad and set(fa) == set(fb), bad[:3]


def _observed_resnet(card, out, run_dir):
    """ResNet50 at SLICE through EarlyStoppingTrainer -> fit(iterator,
    k_steps=4) with every observer attached; the gates of the module
    docstring's phase 17, step 1."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import (
        ArrayDataSetIterator, DataSet)
    from deeplearning4j_tpu_torch.earlystopping import (
        DataSetLossCalculator, EarlyStoppingConfiguration,
        EarlyStoppingTrainer, InMemoryModelSaver,
        MaxEpochsTerminationCondition)
    from deeplearning4j_tpu_torch.models.serialization import params_from_jax
    from deeplearning4j_tpu_torch.observe import (FlightRecorder, SpanTracer,
                                                  TelemetryCollector)
    from deeplearning4j_tpu_torch.ops import fused_conv as fc
    from deeplearning4j_tpu_torch.optimize import solver
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CheckpointListener, CollectScoresIterationListener,
        PerformanceListener, ScoreIterationListener, TrainingListener)
    from deeplearning4j_tpu_torch.ui import (InMemoryStatsStorage,
                                             StatsListener, UIServer)
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    b, k = OBS_BATCH, OBS_K
    laps = [time.perf_counter()]

    def lap():
        """Seconds since the last lap, for the log."""
        laps.append(time.perf_counter())
        return f"{laps[-1] - laps[-2]:.1f}s"
    model = ResNet50(**SLICE).init()
    params_np, state_np = nontrivial_bn(model)
    params_from_jax(params_np, state_np, model.device, model=model)
    per_step = {}                   # as the train phase counts them
    for call, n in path_calls(model.conf, 1).items():
        if call.kernel == "fused_mm":
            bwd = ["fused_mm_bwd"]
        elif call.x_shape[3] <= fc.C3_MERGED_MAX_CIN and call.norm_in:
            bwd = ["fused_c3_bwd"]
        else:
            bwd = ["fused_c3_bwd_in", "fused_c3_bwd_w"]
        for name in [call.kernel] + bwd:
            per_step[name] = per_step.get(name, 0) + n
    twin = model.clone()                    # nothing attached
    grad_ref = model.clone()                # the first step's state
    rng = np.random.default_rng(17)
    n_train = OBS_CALLS * k * b
    img, classes = _image_shape(), SLICE["num_classes"]
    x = rng.normal(0, 1, (n_train,) + img).astype(np.float32)
    y = np.eye(classes, dtype=np.float32)[rng.integers(0, classes, n_train)]
    xt = rng.normal(0, 1, (OBS_HELD_OUT,) + img).astype(np.float32)
    yt = np.eye(classes, dtype=np.float32)[rng.integers(0, classes,
                                                        OBS_HELD_OUT)]
    train = ArrayDataSetIterator(DataSet(x, y), b)
    held_out = DataSetLossCalculator(ArrayDataSetIterator(DataSet(xt, yt),
                                                          b))

    tc = TelemetryCollector(flush_interval=OBS_FLUSH, histograms=True,
                            hist_interval=OBS_HIST_INTERVAL)
    tracer = SpanTracer()
    recorder = FlightRecorder(os.path.join(run_dir, "dumps"))
    storage = InMemoryStatsStorage()
    ui = UIServer(port=0).attach(storage)
    ui.start()
    stats = StatsListener(storage, session_id="observed_resnet50")
    perf = PerformanceListener(1)
    score = ScoreIterationListener(1)
    collect = CollectScoresIterationListener(1)
    # a full checkpoint (about 180 MB) is written under build/, not into
    # the run directory, and removed when the phase ends
    ckpt = CheckpointListener(os.path.join(OBS_SCRATCH, "checkpoints"),
                              every_n_epochs=OBS_EPOCHS, keep_last=1)
    after_epoch = {}

    class Snapshot(TrainingListener):
        def on_epoch_end(self, m, epoch):
            after_epoch.setdefault(epoch, {
                ln: {kk: v.clone() for kk, v in lp.items()}
                for ln, lp in m.params.items()})

    model.set_telemetry(tc)
    guard = _SyncGuard(torch, tc)
    model.set_listeners(guard.listeners([score, perf, collect, stats]),
                        ckpt, Snapshot())
    model.set_tracer(tracer)
    model.set_flight_recorder(recorder)
    calls = []
    model._scan_step = _spy(model._build_scan_train_step(), calls, (fc,))
    conf = (EarlyStoppingConfiguration.Builder()
            .model_saver(InMemoryModelSaver())
            .score_calculator(held_out)
            .epoch_termination_conditions(
                MaxEpochsTerminationCondition(OBS_EPOCHS)).build())
    fc.reset_launch_counts()
    t0 = time.perf_counter()
    result = EarlyStoppingTrainer(conf, model, train, k_steps=k).fit()
    torch.cuda.synchronize()
    es_s = time.perf_counter() - t0
    log(f"  [setup and fit {lap()}] early stopping: {result} in "
        f"{es_s:.1f}s; scores "
        f"{result.score_vs_epoch} [{card}]")

    # attaching the observers changes nothing: the first epoch's calls
    # made directly on the same staged batches (the feeder's ones labels
    # mask) from the same state
    scan = twin._build_scan_train_step()
    ones = torch.ones((k, b), device="cuda")
    direct = []
    for c in range(OBS_CALLS):
        sl = slice(c * k * b, (c + 1) * k * b)
        xs = torch.from_numpy(x[sl].reshape((k, b) + img)).cuda()
        ys = torch.from_numpy(y[sl].reshape(k, b, classes)).cuda()
        twin.train_state, ls = scan(twin.train_state, (xs,), (ys,), None,
                                    (ones,), twin._generator)
        direct.append(ls)
    same, bad = _params_equal(after_epoch[0], twin.params)
    fit_losses = torch.cat([ls for ls, _ in calls]).float().cpu().numpy()
    direct_losses = torch.cat(direct).float().cpu().numpy()
    log(f"  [{lap()}] epoch 0 with every observer vs {OBS_CALLS} direct "
        f"K={k} calls: "
        f"parameters bitwise {same} {bad}; losses bitwise "
        f"{np.array_equal(fit_losses[:OBS_CALLS * k], direct_losses)}")
    if not same or not np.array_equal(fit_losses[:OBS_CALLS * k],
                                      direct_losses):
        raise AssertionError(f"observers changed the training: {bad}")

    # launches: per call exactly K x the train phase's per-step counts
    for i, (_, made) in enumerate(calls):
        want = {name: k * n for name, n in per_step.items()}
        if {kk: v for kk, v in made.items() if kk in want} != want:
            raise AssertionError(f"call {i}: launches {made}, expected "
                                 f"{want}")
    launches = {name: sum(made[name] for _, made in calls)
                for name in per_step}
    log(f"  {len(calls)} calls of {k} steps: launches {launches} "
        f"(= {len(calls)} x {k} x {per_step})")

    # telemetry rows against the returned losses and a plain gradient
    rows = tc.history
    row_losses = np.array([r["loss"] for r in rows], np.float32)
    rows_bitwise = bool(np.array_equal(row_losses, fit_losses))
    _, _, g0 = solver.value_and_grad(
        grad_ref._loss, grad_ref.train_state,
        (torch.from_numpy(x[:b]).cuda(),), (torch.from_numpy(y[:b]).cuda(),),
        None, (torch.ones(b, device="cuda"),), grad_ref._generator)
    gnorm = torch.linalg.vector_norm(torch.cat(
        [g.reshape(-1).float() for g in solver.tree_leaves(g0)])).item()
    grad_err = abs(rows[0]["grad_norm"] - gnorm) / gnorm
    nonfinite = sum(r["nonfinite_count"] for r in rows)
    fetches = _flushes_expected([OBS_CALLS] * OBS_EPOCHS, k, OBS_FLUSH)
    log(f"  [{lap()}] telemetry: {len(rows)} rows, loss column bitwise "
        f"{rows_bitwise}, grad_norm rel err {grad_err:.3g} "
        f"against vector_norm of value_and_grad, nonfinite {nonfinite}, "
        f"{tc.fetch_count} fetches (expected {fetches}), "
        f"{len(tc.hist_history)} histogram rows; sync guard calls "
        f"{guard.calls}")
    if not rows_bitwise or grad_err > OBS_GRAD_RTOL \
            or nonfinite or tc.fetch_count != fetches \
            or len(rows) != OBS_EPOCHS * OBS_CALLS * k \
            or min(guard.calls.values()) == 0:
        raise AssertionError("telemetry rows, fetches or sync guard")

    # the profiler's count of the hand-written kernels: telemetry adds none
    a, p = model.clone(), model.clone()
    a.set_telemetry(TelemetryCollector(flush_interval=OBS_FLUSH,
                                       histograms=True, hist_interval=1))
    a._ensure_ring()
    a_step, p_step = a._build_scan_train_step(), p._build_scan_train_step()
    xs = torch.from_numpy(x[:k * b].reshape((k, b) + img)).cuda()
    ys = torch.from_numpy(y[:k * b].reshape(k, b, classes)).cuda()

    def run(m, step):
        def f():
            m.train_state, _ = step(m.train_state, (xs,), (ys,), None,
                                    (ones,), m._generator)
        return f
    run(a, a_step)()
    run(p, p_step)()
    sync_sites = {arm: _sync_sites(run(m, st)) for arm, m, st in
                  (("observed", a, a_step), ("plain", p, p_step))}
    log(f"  [{lap()}] syncs inside one {k}-step call (sync debug mode \"warn\"): "
        f"{sync_sites}")
    prof_obs = _hand_kernel_counts(run(a, a_step))
    prof_plain = _hand_kernel_counts(run(p, p_step))
    log(f"  [{lap()}] profiler, one {k}-step call: {sum(prof_obs.values())} hand-"
        f"written kernel launches observed, {sum(prof_plain.values())} "
        f"without telemetry ({len(prof_obs)} kernels)")
    if prof_obs != prof_plain or not prof_obs:
        raise AssertionError(f"telemetry changed the hand-written kernel "
                             f"launches: {prof_obs} vs {prof_plain}")
    del a, p

    # the dashboard, the trace, the checkpoints
    import urllib.request
    with urllib.request.urlopen(ui.url + "/api/sessions") as r:
        sessions = json.loads(r.read())
    ui.stop()
    ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt.dir, f))
                     for f in os.listdir(ckpt.dir))
    trace_path = tracer.save(os.path.join(run_dir, "observed_fit.trace.json"))
    spans = {}
    for ev in tracer.events:
        spans[ev["name"]] = spans.get(ev["name"], 0) + 1
    ckpts = sorted(os.listdir(ckpt.dir))
    log(f"  [{lap()}] /api/sessions {sessions}; {len(storage.get_all_updates('observed_resnet50'))} "
        f"stats records; trace {trace_path}: {spans}; checkpoints {ckpts}; "
        f"score listener {len(score.scores)}, collected {len(collect.scores)}"
        f", performance {len(perf.history)} records")
    if "observed_resnet50" not in sessions or not {
            "etl", "host_to_device", "dispatch", "telemetry_flush", "eval",
            "checkpoint"} <= set(spans) or len(ckpts) != 1:
        raise AssertionError("dashboard session, trace spans or checkpoints")

    # early stopping: the restored best model re-scores to the saved score
    rescore = held_out.calculate_score(result.best_model)
    log(f"  best epoch {result.best_model_epoch} "
        f"({result.termination_reason.value}: "
        f"{result.termination_details}), saved score "
        f"{result.best_model_score!r}, restored re-scored {rescore!r}")
    if rescore != result.best_model_score or result.best_model_epoch < 0:
        raise AssertionError("the restored best model scores differently")

    out["resnet50"] = {
        "early_stopping_s": es_s, "best_epoch": result.best_model_epoch,
        "termination": [result.termination_reason.value,
                        result.termination_details],
        "scores": result.score_vs_epoch, "rows": len(rows),
        "fetches": tc.fetch_count, "grad_norm_rel_err": grad_err,
        "guarded_calls": guard.calls, "spans": spans,
        "checkpoint_ms": [e["dur"] / 1e3 for e in tracer.events
                          if e["name"] == "checkpoint"],
        "checkpoint_bytes": ckpt_bytes,
        "profiler_hand_launches": sum(prof_obs.values()),
        "sync_sites_per_call": sync_sites,
        "launches_per_call": {n: k * v for n, v in per_step.items()}}
    model.set_listeners()
    return model, launches, (x, y, ones)


def _observed_faults(card, out, run_dir, model, data):
    """A NaN batch and an OOM inside fit, each on a clone."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import (
        ArrayDataSetIterator, DataSet)
    from deeplearning4j_tpu_torch.observe import (FlightRecorder,
                                                  TelemetryCollector)
    from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
    x, y, _ = data
    b = OBS_BATCH
    nan = model.clone()
    tc = TelemetryCollector(flush_interval=2, histograms=True,
                            hist_interval=100)
    rec = FlightRecorder(os.path.join(run_dir, "nan_dumps"))
    nan.set_telemetry(tc)
    nan.set_flight_recorder(rec)
    xn = x[:3 * b].copy()
    xn[b + 5, 3, 3, 1] = np.nan            # in the second batch
    it0 = nan.iteration
    nan.fit(ArrayDataSetIterator(DataSet(xn, y[:3 * b]), b))
    row = next(r for r in tc.history if r["iteration"] == it0 + 2)
    hist_iters = [h["iteration"] for h in tc.hist_history]
    reasons = [os.path.basename(p).split("_")[1] for p in rec.dumps]
    log(f"  NaN batch: row {it0 + 2} nonfinite_count "
        f"{row['nonfinite_count']:.0f}, histograms at {hist_iters} "
        f"(interval 100), dumps {reasons}")
    if not row["nonfinite_count"] > 0 or it0 + 2 not in hist_iters \
            or reasons != ["nonfinite"]:
        raise AssertionError("the NaN step's row, histograms or dump")
    del nan

    oom = model.clone()
    rec = FlightRecorder(os.path.join(run_dir, "oom_dumps"))
    oom.set_flight_recorder(rec)

    class Hog(TrainingListener):
        """Asks for more than the card has: past ``mem_get_info``'s free
        bytes and the allocator's cached ones alike."""
        def iteration_done(self, *args):
            _, total = torch.cuda.mem_get_info()
            torch.empty(total + (1 << 30), dtype=torch.uint8, device="cuda")
    oom.set_listeners(Hog())
    raised = None
    try:
        oom.fit(ArrayDataSetIterator(DataSet(x[:b], y[:b]), b))
    except torch.OutOfMemoryError as e:
        raised = e
    if raised is None or len(rec.dumps) != 1 or "dump_oom_" not in \
            rec.dumps[0]:
        raise AssertionError(f"OOM inside fit: raised {raised!r}, dumps "
                             f"{rec.dumps}")
    with open(os.path.join(rec.dumps[0], "memory.json")) as f:
        mem = json.load(f)
    dev = mem["devices"][0]
    torch.cuda.empty_cache()
    oom.set_listeners()
    oom.fit(DataSet(x[b:2 * b], y[b:2 * b]))
    after = oom.score()
    log(f"  OOM inside fit: {type(raised).__name__} surfaced, dump "
        f"{os.path.basename(rec.dumps[0])}: in use {dev.get('bytes_in_use')}"
        f", reserved {dev.get('bytes_reserved')}, free "
        f"{dev.get('bytes_free')} of {dev.get('bytes_limit')}; after "
        f"empty_cache one more step, loss {after:.4f}")
    if dev.get("bytes_in_use") is None or not math.isfinite(after):
        raise AssertionError("the OOM dump's memory section or the step "
                             "after it")
    out["faults"] = {"nan_row": row, "nan_hist_iterations": hist_iters,
                     "oom_memory": dev, "loss_after_oom": after}
    del oom


def _observed_times(card, out, run_dir, model, data):
    """ms per step and the card's busy share of one fit epoch (3 K-step
    calls) with every observer on and with none, interleaved."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from deeplearning4j_tpu_torch.datasets.dataset import (
        ArrayDataSetIterator, DataSet)
    from deeplearning4j_tpu_torch.observe import (FlightRecorder, SpanTracer,
                                                  TelemetryCollector)
    from deeplearning4j_tpu_torch.optimize.listeners import (
        CollectScoresIterationListener, PerformanceListener,
        ScoreIterationListener)
    from deeplearning4j_tpu_torch.ui import InMemoryStatsStorage, \
        StatsListener
    x, y, _ = data
    on, off = model.clone(), model.clone()
    on.set_telemetry(TelemetryCollector(flush_interval=OBS_FLUSH,
                                        histograms=True,
                                        hist_interval=OBS_HIST_INTERVAL))
    on.set_listeners(ScoreIterationListener(1), PerformanceListener(1),
                     CollectScoresIterationListener(1),
                     StatsListener(InMemoryStatsStorage()))
    on.set_tracer(SpanTracer())
    on.set_flight_recorder(FlightRecorder(os.path.join(run_dir,
                                                       "time_dumps")))
    off.set_flight_recorder(FlightRecorder(enabled=False))
    train = lambda: ArrayDataSetIterator(DataSet(x, y), OBS_BATCH)
    steps = OBS_CALLS * OBS_K

    def epoch(m):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.fit(train(), k_steps=OBS_K)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / steps
    for m in (on, off):
        epoch(m)                                   # warm
    ms = {"on": [], "off": []}
    for _ in range(OBS_REPEATS):
        for arm, m in (("on", on), ("off", off)):
            ms[arm].append(epoch(m))
    # busy share: the device time a step in one profiled epoch (the
    # card's activity only) over the mean wall time a step of the
    # unprofiled epochs
    busy = {}
    for arm, m in (("on", on), ("off", off)):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA
                                 if torch.cuda.is_available()
                                 else ProfilerActivity.CPU]) as prof:
            epoch(m)
        dev = sum(getattr(e, "device_time_total", 0.0)
                  for e in prof.key_averages()
                  if e.device_type.name == "CUDA") / 1e3 / steps
        busy[arm] = dev / float(np.mean(ms[arm]))
    for arm in ("on", "off"):
        v = np.array(ms[arm])
        log(f"  {arm:>3}: {v.mean():.2f} ms/step (min {v.min():.2f}, max "
            f"{v.max():.2f}, {OBS_REPEATS} interleaved epochs of {steps} "
            f"steps at batch {OBS_BATCH}), busy {100 * busy[arm]:.1f}% "
            f"[{card}]")
    out["times"] = {"ms_per_step": ms, "busy": busy, "card": card}


def _observed_tbptt(card, out):
    """The rnn_tbptt model and segment shape, 2 batches through fit with
    telemetry and a ScoreIterationListener."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import ListDataSetIterator
    from deeplearning4j_tpu_torch.observe import TelemetryCollector
    from deeplearning4j_tpu_torch.ops import fused_lstm as fl
    from deeplearning4j_tpu_torch.optimize.listeners import (
        ScoreIterationListener, TrainingListener)
    model = tbptt_model()
    rng = np.random.default_rng(23)
    data = [corpus_batch(rng, TBPTT_BATCH, TBPTT_CHARS)
            for _ in range(OBS_TBPTT_BATCHES)]
    segs = TBPTT_CHARS // TBPTT_K
    tc = TelemetryCollector(flush_interval=segs)
    seg_losses = []

    class Segments(TrainingListener):
        def iteration_done(self, m, *args):
            seg_losses.extend(float(v) for v in m.last_segment_losses)
    score = ScoreIterationListener(1)
    model.set_telemetry(tc)
    model.set_listeners(score, Segments())
    fl.reset_launch_counts()
    model.fit(ListDataSetIterator(data))
    launches = dict(fl.LAUNCHES)
    rows = [r["loss"] for r in tc.history]
    n = OBS_TBPTT_BATCHES * segs
    log(f"  TBPTT ({OBS_TBPTT_BATCHES} batches of {TBPTT_BATCH} x "
        f"{TBPTT_CHARS}, segments of {TBPTT_K}): launches {launches} "
        f"(expected 2 + 2 a segment, {n} segments), {len(rows)} rows, "
        f"losses bitwise the segments' {rows == seg_losses}, scores "
        f"{score.scores}")
    if launches != {"lstm_fwd": 2 * n, "lstm_bwd": 2 * n} \
            or rows != seg_losses or len(rows) != n:
        raise AssertionError("TBPTT launches or telemetry rows")
    out["tbptt"] = {"launches": launches, "rows": len(rows)}
    return launches


def _observed_bert(card, out):
    """The bert_train model, 2 calls of fit(iterator, k_steps=4) with
    telemetry and a tracer, against direct calls on the same batches."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import (
        DataSet, ListDataSetIterator)
    from deeplearning4j_tpu_torch.observe import (SpanTracer,
                                                  TelemetryCollector)
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    c, b, k = BERT, BERT_TRAIN_BATCH, BERT_TRAIN_K
    model = bert_model("bfloat16")
    twin = model.clone()
    rng = np.random.default_rng(29)
    batches = []
    for _ in range(2):
        ids = rng.integers(0, c["vocab"], (b, c["seq"]))
        lab = np.zeros((b, c["seq"], c["vocab"]), np.float32)
        lab[np.arange(b)[:, None], np.arange(c["seq"])[None, :],
            rng.integers(0, c["vocab"], (b, c["seq"]))] = 1.0
        batches.append(DataSet(ids, lab))
    order = [batches[i % 2] for i in range(OBS_BERT_CALLS * k)]
    tc = TelemetryCollector(flush_interval=k)
    tracer = SpanTracer()
    model.set_telemetry(tc)
    model.set_tracer(tracer)
    calls = []
    model._scan_step = _spy(model._build_scan_train_step(), calls, (fa,))
    t0 = time.perf_counter()
    model.fit(ListDataSetIterator(order), k_steps=k)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    scan = twin._build_scan_train_step()
    ones = torch.ones((k, b, c["seq"]), device="cuda")
    xk = torch.from_numpy(np.stack([d.features for d in order[:k]])).cuda()
    yk = torch.from_numpy(np.stack([d.labels for d in order[:k]])).cuda()
    direct = []
    for _ in range(OBS_BERT_CALLS):
        twin.train_state, ls = scan(twin.train_state, xk, yk, None, ones,
                                    twin._generator)
        direct.append(ls)
    fit_losses = torch.cat([ls for ls, _ in calls]).float().cpu().numpy()
    direct_losses = torch.cat(direct).float().cpu().numpy()
    rows = np.array([r["loss"] for r in tc.history], np.float32)
    want = {name: k * c["blocks"] for name in ATTN_KERNELS}
    made = [{kk: v for kk, v in m.items() if kk in want} for _, m in calls]
    log(f"  BERT ({b} x {c['seq']}, K={k}, {OBS_BERT_CALLS} fit calls in "
        f"{fit_s:.1f}s): flash launches a call {made}, losses bitwise the "
        f"direct calls' {np.array_equal(fit_losses, direct_losses)}, rows "
        f"bitwise {np.array_equal(rows, fit_losses)}, spans "
        f"{sorted({e['name'] for e in tracer.events})}")
    if any(m != want for m in made) or len(made) != OBS_BERT_CALLS \
            or not np.array_equal(fit_losses, direct_losses) \
            or not np.array_equal(rows, fit_losses):
        raise AssertionError("BERT launches or losses")
    out["bert"] = {"fit_s": fit_s, "losses": fit_losses.tolist()}
    return {name: sum(m[name] for m in made) for name in ATTN_KERNELS}


def _observed_records(card, out):
    """The committed digits as CSV, through CSVRecordReader ->
    RecordReaderDataSetIterator into one LeNet epoch, against the same
    batches from DigitsDataSetIterator."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.fetchers import \
        DigitsDataSetIterator
    from deeplearning4j_tpu_torch.datasets.records import (
        CSVRecordReader, RecordReaderDataSetIterator)
    from deeplearning4j_tpu_torch.zoo.models import LeNet
    rows = []
    for ds in DigitsDataSetIterator(DIGITS_BATCH, train=True):
        rows.append(np.concatenate(
            [ds.features, ds.labels.argmax(1)[:, None]], axis=1))
    rows = np.concatenate(rows)
    os.makedirs(OBS_SCRATCH, exist_ok=True)
    path = os.path.join(OBS_SCRATCH, "digits_train.csv")
    with open(path, "w") as f:
        for r in rows:
            f.write(",".join(repr(float(np.float32(v))) for v in r) + "\n")
    a = LeNet().init()
    b = a.clone()
    it = RecordReaderDataSetIterator(CSVRecordReader(path=path),
                                     DIGITS_BATCH, label_index=28 * 28,
                                     num_classes=10)
    a.fit(it)
    b.fit(DigitsDataSetIterator(DIGITS_BATCH, train=True))
    same, bad = _params_equal(a.params, b.params)
    log(f"  records: {len(rows)} digits as CSV -> CSVRecordReader -> "
        f"RecordReaderDataSetIterator({DIGITS_BATCH}): one LeNet epoch "
        f"({a.iteration} steps) bitwise the digits iterator's {same} {bad}")
    if not same or a.iteration != b.iteration:
        raise AssertionError("records-fed LeNet differs")
    out["records"] = {"rows": len(rows), "steps": a.iteration}


def _observed_serving(card, out, model):
    """The ResNet50 ServingEngine with a SpanTracer: 32 requests answered
    bitwise as by the untraced engine, every batch's spans in the trace."""
    import numpy as np
    from deeplearning4j_tpu_torch.observe import SpanTracer
    from deeplearning4j_tpu_torch.ops import fused_conv as fc
    from deeplearning4j_tpu_torch.parallel.serving import ServingEngine
    rng = np.random.default_rng(31)
    reqs = [rng.normal(0, 1, (int(n),) + _image_shape()).astype(np.float32)
            for n in rng.integers(1, 33, OBS_SERVE_REQUESTS)]
    tracer = SpanTracer()
    answers = {}
    fc.reset_launch_counts()
    for name, tr in (("traced", tracer), ("untraced", None)):
        with ServingEngine(model, batch_limit=32,
                           feature_shape=_image_shape(),
                           precision=("bf16" if SLICE["compute_dtype"]
                                      == "bfloat16" else "f32"),
                           tracer=tr) as eng:
            if name == "traced":
                fc.reset_launch_counts()
            answers[name] = [eng.output(x) for x in reqs]
            if name == "traced":
                served = {kk: fc.LAUNCHES[kk] for kk in FORWARD}
    same = all(np.array_equal(p, q) for p, q in zip(answers["traced"],
                                                    answers["untraced"]))
    spans = {}
    for ev in tracer.events:
        spans[ev["name"]] = spans.get(ev["name"], 0) + 1
    log(f"  traced serving: {OBS_SERVE_REQUESTS} requests bitwise the "
        f"untraced engine's {same}; spans {spans}; launches {served}")
    per_batch = ("queue_wait", "batch_form", "dispatch", "device", "fetch")
    if not same or any(spans.get(s, 0) != OBS_SERVE_REQUESTS
                       for s in per_batch):
        raise AssertionError("traced serving differs or lacks spans")
    out["serving"] = {"spans": spans}
    return served


def phase_observed_fit(report, card):
    """The observed training loop (module docstring, phase 17)."""
    import torch
    run_dir = os.path.join(report["run_dir"], "observed_fit")
    os.makedirs(run_dir, exist_ok=True)
    out = {}
    launches = {}

    def add(d):
        for kk, v in d.items():
            launches[kk] = launches.get(kk, 0) + v
    seconds = out["seconds"] = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        result = fn()
        seconds[name] = time.perf_counter() - t0
        log(f"  ({name}: {seconds[name]:.1f}s)")
        return result
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        model, made, data = timed("resnet50", lambda: _observed_resnet(
            card, out, run_dir))
        add(made)
        timed("faults", lambda: _observed_faults(card, out, run_dir, model,
                                                  data))
        timed("times", lambda: _observed_times(card, out, run_dir, model,
                                                data))
        add(timed("serving", lambda: _observed_serving(card, out, model)))
        del model, data
        torch.cuda.empty_cache()
        add(timed("tbptt", lambda: _observed_tbptt(card, out)))
        add(timed("bert", lambda: _observed_bert(card, out)))
        torch.cuda.empty_cache()
        timed("records", lambda: _observed_records(card, out))
    finally:
        torch.backends.cudnn.deterministic = deterministic
        import shutil
        shutil.rmtree(OBS_SCRATCH, ignore_errors=True)
    report["observed_fit"] = out
    return launches


# ---------------------------------------------------------------------------
# quant_serve: int8 serving (parallel/quant.py, evaluation/quant_gate.py)
# ---------------------------------------------------------------------------

QUANT_BATCH = 32          # the served batch (and the engine's batch limit)
QUANT_TIMED_CALLS = 40    # timed requests of QUANT_BATCH rows, per engine
QUANT_LSTM_LAUNCHES = 2   # lstm_fwd launches a served TextGenerationLSTM call
# int8 exactness on the card: (x NHWC, w HWIO, strides, padding, dilation,
# groups) of int8_conv and (rows, K, N) of int8_dot: LeNet's shapes and a
# K = 4608 contraction (past the f32 route's exact width of 1040)
QUANT_CONV_CASES = (
    ((32, 28, 28, 1), (5, 5, 1, 20), (1, 1), ((0, 0), (0, 0)), (1, 1), 1),
    ((32, 12, 12, 20), (5, 5, 20, 50), (1, 1), ((0, 0), (0, 0)), (1, 1), 1),
    ((8, 6, 6, 512), (3, 3, 512, 16), (1, 1), ((0, 0), (0, 0)), (1, 1), 1))
QUANT_DOT_CASES = ((32, 800, 500), (32, 500, 10), (64, 4608, 77))


def _int64_conv(xq, wq, stride, dil):
    """The exact integer convolution of int8 NHWC activations and HWIO
    weights (no padding, one group) on the host in int64: (N, L, Cout)."""
    import torch
    kh, kw, _, cout = wq.shape
    cols = torch.nn.functional.unfold(
        xq.permute(0, 3, 1, 2).double(), (kh, kw), dilation=dil,
        stride=stride).long()
    w2 = wq.long().permute(2, 0, 1, 3).reshape(-1, cout)
    return torch.einsum("nkl,ko->nlo", cols, w2)


def quant_exactness():
    """``int8_conv`` and ``int8_dot`` on the card: their int32
    accumulators held against an int64 host product bitwise, and their
    rescaled outputs against the CPU's bitwise."""
    import torch
    from deeplearning4j_tpu_torch.ops.quantize import (
        _int_matmul, int8_conv, int8_conv_accumulator, int8_dot,
        quantize_act)
    rows = []
    g = torch.Generator().manual_seed(18)
    for xs_, ws_, s, pad, d, grp in QUANT_CONV_CASES:
        x = torch.randn(xs_, generator=g)
        wq = torch.randint(-127, 128, ws_, generator=g, dtype=torch.int8)
        xs = torch.tensor(float(x.abs().max()) / 127)
        kw = dict(window_strides=s, padding=pad, rhs_dilation=d,
                  feature_group_count=grp)
        xq = quantize_act(x, xs)
        acc = int8_conv_accumulator(xq.cuda(), wq.cuda(), **kw).cpu()
        exact = _int64_conv(xq, wq, s, d)
        ok = acc.dtype == torch.int32 and torch.equal(
            acc.reshape(exact.shape).long(), exact)
        ws = torch.rand(ws_[-1], generator=g) * 0.01
        same = torch.equal(int8_conv(x.cuda(), wq.cuda(), ws.cuda(),
                                     xs.cuda(), **kw).cpu(),
                           int8_conv(x, wq, ws, xs, **kw))
        rows.append({"op": "int8_conv", "x": list(xs_), "w": list(ws_),
                     "K": ws_[0] * ws_[1] * ws_[2], "exact": bool(ok),
                     "cpu_bitwise": bool(same)})
    for m, k, n in QUANT_DOT_CASES:
        x = torch.rand((m, k), generator=g) * 2 - 1
        wq = torch.randint(-127, 128, (k, n), generator=g, dtype=torch.int8)
        xs = torch.tensor(1.0 / 127)
        xq = quantize_act(x, xs)
        acc = _int_matmul(xq.float().cuda(), wq.float().cuda()).cpu()
        ok = acc.dtype == torch.int32 and torch.equal(
            acc.long(), xq.long() @ wq.long())
        ws = torch.rand(n, generator=g) * 0.01
        same = torch.equal(int8_dot(x.cuda(), wq.cuda(), ws.cuda(),
                                    xs.cuda()).cpu(), int8_dot(x, wq, ws, xs))
        rows.append({"op": "int8_dot", "x": [m, k], "w": [k, n], "K": k,
                     "exact": bool(ok), "cpu_bitwise": bool(same)})
    return rows


def _serve_times(eng, x, calls):
    """Per-request ms of ``calls`` sequential requests of ``x`` (after one
    warm request): p50, p99 and rows/s."""
    import numpy as np
    eng.output(x)
    ms = []
    for _ in range(calls):
        t0 = time.perf_counter()
        eng.output(x)
        ms.append(1e3 * (time.perf_counter() - t0))
    ms = np.asarray(ms)
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "rows_per_s": 1e3 * len(x) * calls / float(ms.sum())}


def _bucket_walk(eng, x):
    """The int8 engine's answer as the QuantizedModel's direct walk gives
    it: each chunk of at most the batch limit padded to its bucket with
    its last row (the port's padded-bucket contract)."""
    import numpy as np
    import torch
    qm = eng.quantized
    fwd = qm.build_inference_fn()
    out = []
    for i in range(0, len(x), eng.batch_limit):
        c = x[i:i + eng.batch_limit]
        b = eng.bucket_of(len(c))
        pad = np.concatenate([c, np.repeat(c[-1:], b - len(c), 0)])
        y = fwd(qm.params, qm.model.model_state,
                torch.from_numpy(pad).cuda())
        out.append(y.float().cpu().numpy()[:len(c)])
    return np.concatenate(out)


def _quant_lenet(out, card):
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.fetchers import \
        DigitsDataSetIterator
    from deeplearning4j_tpu_torch.evaluation.quant_gate import (
        QuantGate, run_quant_gate)
    from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
    from deeplearning4j_tpu_torch.parallel.quant import (PrecisionPolicy,
                                                         calibrate,
                                                         params_nbytes)
    from deeplearning4j_tpu_torch.parallel.serving import ServingEngine
    from deeplearning4j_tpu_torch.zoo.models import LeNet
    x, _ = DigitsDataSetIterator.fetch(train=False)
    x = x.astype(np.float32)
    lenet = LeNet().init_pretrained(flavor="digits")
    policy = PrecisionPolicy.int8(x)
    t0 = time.perf_counter()
    eng = ServingEngine(lenet, batch_limit=QUANT_BATCH,
                        feature_shape=x.shape[1:], precision=policy,
                        registry=MetricsRegistry(), session_id="q-lenet")
    start_s = time.perf_counter() - t0
    f32 = ServingEngine(lenet, batch_limit=QUANT_BATCH,
                        feature_shape=x.shape[1:],
                        registry=MetricsRegistry(), session_id="f-lenet")
    try:
        rng = np.random.default_rng(18)
        sizes = [1, 7, 32, 45] + [int(v) for v in rng.integers(1, 33, 8)]
        lo, bitwise = 0, True
        for n in sizes:
            req = x[lo % 300:lo % 300 + n]
            lo += n
            bitwise &= bool(np.array_equal(eng.output(req),
                                           _bucket_walk(eng, req)))
        gate = run_quant_gate(lenet, policy, QuantGate(),
                              quantized=eng.quantized, model_name="LeNet")
        h1 = calibrate(lenet, policy).hash()
        h2 = calibrate(lenet, policy).hash()
        cpu = LeNet().init_pretrained(flavor="digits", device="cpu")
        c_cpu = calibrate(cpu, policy)
        c_card = eng.quantized.calibration
        scale_rel = max(abs(c_card.scales[k] - c_cpu.scales[k])
                        / c_cpu.scales[k] for k in c_cpu.scales)
        t8 = _serve_times(eng, x[:QUANT_BATCH], QUANT_TIMED_CALLS)
        tf = _serve_times(f32, x[:QUANT_BATCH], QUANT_TIMED_CALLS)
        st = eng.stats()
        res = {
            "engine_start_s": start_s, "bitwise_vs_walk": bitwise,
            "request_sizes": sizes,
            "gate": gate.summary(), "gate_passed": gate.passed,
            "top1_agreement": gate.top1_agreement,
            "max_prob_delta": gate.max_logit_delta,
            "hash_repeat_equal": h1 == h2 == c_card.hash(),
            "hash": c_card.hash(), "cpu_hash": c_cpu.hash(),
            "card_hash_equals_cpu": c_card.hash() == c_cpu.hash(),
            "scale_rel_card_vs_cpu": scale_rel,
            "quantized_layers": eng.quantized.quantized_layers,
            "fallback": st["quant"]["fallback"],
            "layer_errors": st["quant"]["layers"],
            "int8": t8, "f32": tf,
            "params_nbytes": {"int8": params_nbytes(eng.quantized.params),
                              "f32": params_nbytes(lenet.params)},
            "resident_bytes": {"int8": eng.params_resident_bytes,
                               "f32": f32.params_resident_bytes}}
        eng.assert_warm()
    finally:
        eng.shutdown()
        f32.shutdown()
    log(f"  LeNet int8: answers bitwise the QuantizedModel walk at the "
        f"bucket over {len(sizes)} requests: {bitwise}; {gate.summary()}")
    log(f"  LeNet calibration hash repeatable on the card: "
        f"{res['hash_repeat_equal']}; equal to the CPU port's: "
        f"{res['card_hash_equals_cpu']} (scales within "
        f"{scale_rel:.3g} relative); quantized {res['quantized_layers']}")
    log(f"  LeNet at {QUANT_BATCH}: int8 {t8['rows_per_s']:.1f} images/s "
        f"p50 {t8['p50_ms']:.3f} p99 {t8['p99_ms']:.3f} ms; f32 "
        f"{tf['rows_per_s']:.1f} images/s p50 {tf['p50_ms']:.3f} p99 "
        f"{tf['p99_ms']:.3f} ms; params {res['params_nbytes']['int8']} "
        f"against {res['params_nbytes']['f32']} bytes [{card}]")
    if not (bitwise and gate.passed and res["hash_repeat_equal"]):
        raise AssertionError("LeNet int8: the served answers, the gate or "
                             "the calibration hash failed")
    if res["params_nbytes"]["int8"] >= res["params_nbytes"]["f32"]:
        raise AssertionError("int8 params are not smaller than f32")
    out["lenet"] = res
    return lenet, x, policy


def _quant_lstm(out, card, launches):
    import numpy as np
    from deeplearning4j_tpu_torch.evaluation.quant_gate import (
        QuantGate, run_quant_gate)
    from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
    from deeplearning4j_tpu_torch.parallel.quant import (PrecisionPolicy,
                                                         params_nbytes)
    from deeplearning4j_tpu_torch.parallel.serving import ServingEngine
    from deeplearning4j_tpu_torch.zoo.models import TextGenerationLSTM
    model = TextGenerationLSTM().init_pretrained()
    # the gate's case: 96 one-hot streams of 60 from default_rng(1234)
    vocab = model.layers[-1].n_out
    ids = np.random.default_rng(1234).integers(0, vocab, size=(96, 60))
    feats = np.eye(vocab, dtype=np.float32)[ids]
    policy = PrecisionPolicy.int8(feats)
    eng, made = _counted(launches, lambda: ServingEngine(
        model, batch_limit=QUANT_BATCH, feature_shape=feats.shape[1:],
        precision=policy, registry=MetricsRegistry(), session_id="q-lstm"))
    f32 = ServingEngine(model, batch_limit=QUANT_BATCH,
                        feature_shape=feats.shape[1:],
                        registry=MetricsRegistry(), session_id="f-lstm")
    try:
        per_call = []
        for n in (32, 5, 32):
            _, m = _counted(launches, lambda: eng.output(feats[:n]))
            per_call.append(m.get("lstm_fwd", 0))
        gate, m_gate = _counted(launches, lambda: run_quant_gate(
            model, policy, QuantGate(), quantized=eng.quantized,
            model_name="TextGenerationLSTM"))
        y8 = eng.output(feats)
        yf = f32.output(feats)
        agree = float(np.mean(y8.argmax(-1) == yf.argmax(-1)))
        t8 = _serve_times(eng, feats[:QUANT_BATCH], QUANT_TIMED_CALLS // 2)
        tf = _serve_times(f32, feats[:QUANT_BATCH], QUANT_TIMED_CALLS // 2)
        res = {"launches_engine_start": made, "lstm_fwd_per_call": per_call,
               "gate": gate.summary(), "gate_passed": gate.passed,
               "gate_launches": m_gate, "top1_agreement_vs_f32": agree,
               "quantized_layers": eng.quantized.quantized_layers,
               "int8": t8, "f32": tf,
               "params_nbytes": {"int8": params_nbytes(eng.quantized.params),
                                 "f32": params_nbytes(model.params)}}
        eng.assert_warm()
    finally:
        eng.shutdown()
        f32.shutdown()
    log(f"  TextGenerationLSTM int8 (head {res['quantized_layers']}, LSTMs "
        f"f32): lstm_fwd launches a served call {per_call}, engine start "
        f"(calibration, probe, warmup) {made}, gate {m_gate}; "
        f"{gate.summary()}; top-1 agreement with the f32 engine {agree:.4f}")
    log(f"  TextGenerationLSTM at {QUANT_BATCH} x 60: int8 "
        f"{t8['rows_per_s']:.1f} sequences/s (p50 {t8['p50_ms']:.3f} ms), "
        f"f32 {tf['rows_per_s']:.1f} (p50 {tf['p50_ms']:.3f} ms); params "
        f"{res['params_nbytes']['int8']} against "
        f"{res['params_nbytes']['f32']} bytes [{card}]")
    if per_call != [QUANT_LSTM_LAUNCHES] * 3 or not gate.passed:
        raise AssertionError("TextGenerationLSTM int8: not 2 lstm_fwd "
                             "launches a call, or the gate failed")
    out["textgen"] = res


def _quant_fleet(out, card, lenet, x, policy):
    import numpy as np
    from deeplearning4j_tpu_torch.evaluation.quant_gate import (
        QuantGate, QuantGateError)
    from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
    from deeplearning4j_tpu_torch.parallel.fleet import FleetRouter
    from deeplearning4j_tpu_torch.zoo.models import LeNet
    reg = MetricsRegistry()
    router = FleetRouter(registry=reg, session_id="q-fleet", window_s=10.0)
    why = None
    try:
        pool = router.add_pool(
            "lenet", lenet, version="v1", precision=policy,
            quant_gate=QuantGate(samples=x), feature_shape=x.shape[1:],
            batch_limit=QUANT_BATCH)
        y1 = router.output(x[:QUANT_BATCH], model="lenet")
        pool.quant_gate = QuantGate(top1_budget=0.0, logit_budget=1e-9,
                                    samples=x)
        try:
            router.swap("lenet", LeNet().init_pretrained(flavor="digits"),
                        "v2")
        except QuantGateError as e:
            why = str(e)
        same = np.array_equal(router.output(x[:QUANT_BATCH], model="lenet"),
                              y1)
        text = reg.render()
        counts = {o: f'dl4j_fleet_quant_gate_total{{model="lenet",'
                     f'outcome="{o}"}} 1.0' in text for o in ("pass", "fail")}
        res = {"admitted": pool.gate_results[0].summary(),
               "swap_refused": why is not None, "refusal": why,
               "active_version": pool.active_version,
               "old_version_bitwise": same, "gate_counter": counts}
    finally:
        router.shutdown()
    log(f"  fleet: int8 pool admitted ({res['admitted']}); the swap behind "
        f"an impossible gate refused: {why is not None}, v1 still active "
        f"and bitwise: {same}; dl4j_fleet_quant_gate_total pass/fail: "
        f"{counts}")
    if not (why is not None and same and res["active_version"] == "v1"
            and all(counts.values())):
        raise AssertionError("fleet int8 gate: the swap was not refused, "
                             "the old version changed, or the counter is "
                             "wrong")
    out["fleet"] = res


def phase_quant_serve(report, card):
    out = {}
    launches = {}
    rows = quant_exactness()
    for r in rows:
        log(f"  {r['op']} x {r['x']} w {r['w']} (K {r['K']}): int32 "
            f"accumulator exact against int64 {r['exact']}, bitwise the "
            f"CPU's {r['cpu_bitwise']}")
    out["exactness"] = rows
    bad = [r for r in rows if not (r["exact"] and r["cpu_bitwise"])]
    if bad:
        raise AssertionError(f"int8 products not exact on the card: {bad}")
    lenet, x, policy = _quant_lenet(out, card)
    _quant_lstm(out, card, launches)
    _quant_fleet(out, card, lenet, x, policy)
    report["quant_serve"] = out
    return launches


# ---------------------------------------------------------------------------
# model_library: VAE, AutoEncoder, MoE, custom layers, gradient check,
# memory, k-means, t-SNE
# ---------------------------------------------------------------------------

LIB_VAE = dict(n_out=32, encoder_layer_sizes=(256, 256),
               decoder_layer_sizes=(256, 256))
LIB_VAE_EPOCHS, LIB_AE_EPOCHS, LIB_FIT_EPOCHS = 3, 2, 3
LIB_PRETRAIN_BATCH = 128
# the MoE sequence stack: the BERT geometry's width and heads, 2 blocks
LIB_MOE = dict(vocab=30522, width=768, heads=12, blocks=2, seq=128,
               experts=8, hidden=3072, top_k=2, capacity_factor=1.25)
# 24 steps: the stack's loss stands near ln 30522 for its first 6 (the
# router has sent every token to 3 of the 8 experts, and capacity drops
# half the slots), then falls (10.3489 -> 9.1163 in 24 steps on an H100)
LIB_MOE_BATCH, LIB_MOE_STEPS, LIB_MOE_CHECK_BATCH = 32, 24, 4
LIB_STEP_RTOL = 1e-4      # one step card vs CPU / kernels vs plain: rel L2
LIB_CUSTOM_TOL = 1e-6     # custom layers card vs CPU, of each row's largest
LIB_KMEANS_TOL = 1e-4     # k-means centers card vs CPU, of the largest
LIB_TSNE_CHECK_STEPS = 20
LIB_TSNE_TOL = 1e-4       # one exact step card vs CPU, of the largest
LIB_BH_POINTS, LIB_BH_ITERS = 300, 20
LIB_MEMORY_BATCH = 128


def library_mln(device="cuda"):
    """Dense + AutoEncoder + MixtureOfExperts + SameDiffLayer + output on
    12 features: the gradient check's model."""
    import torch
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.feedforward import (
        AutoEncoder, DenseLayer, MixtureOfExperts)
    from deeplearning4j_tpu_torch.nn.layers.misc import SameDiffLayer
    from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer
    from deeplearning4j_tpu_torch.ops.activations import Activation
    from deeplearning4j_tpu_torch.ops.losses import LossFunction
    conf = (NeuralNetConfiguration.Builder().seed(11).list()
            .layer(DenseLayer(n_out=8, activation=Activation.TANH))
            .layer(AutoEncoder(n_out=7, activation=Activation.SIGMOID))
            .layer(MixtureOfExperts(n_out=7, num_experts=3, hidden=5,
                                    top_k=2, capacity_factor=2.0,
                                    activation=Activation.TANH))
            .layer(SameDiffLayer(
                param_shapes={"W": (7, 5), "b": (5,)},
                fn=lambda p, x: torch.tanh(x @ p["W"] + p["b"]),
                out_type=lambda it: it.__class__(5)))
            .layer(OutputLayer(n_out=3, loss=LossFunction.MCXENT))
            .set_input_type(InputType.feed_forward(12)).build())
    return MultiLayerNetwork(conf, device=device).init()


def library_data(n=6, seed=0):
    """A batch of ``n`` rows for ``library_mln``."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 12)).astype(np.float32)
    return DataSet(x, np.eye(3, dtype=np.float32)[np.arange(n) % 3])


def _all_digits():
    """The committed digits, train and test split together: (1797, 784)
    features in [0, 1] and their labels."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.fetchers import \
        DigitsDataSetIterator
    xa, ya = DigitsDataSetIterator.fetch(train=True)
    xb, yb = DigitsDataSetIterator.fetch(train=False)
    return (np.concatenate([xa, xb]).astype(np.float32),
            np.concatenate([np.asarray(ya), np.asarray(yb)]))


def _batches(x, b, y=None):
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    return [DataSet(x[i:i + b], None if y is None else y[i:i + b])
            for i in range(0, len(x) - b + 1, b)]


def _tree_rel_l2(a, b):
    """The relative L2 error of all of ``a``'s leaves against ``b``'s."""
    from deeplearning4j_tpu_torch.models.serialization import flatten_paths
    fa, fb = flatten_paths(a), flatten_paths(b)
    num = sum(float((fa[k].double().cpu() - v.double().cpu()).square()
                    .sum()) for k, v in fb.items())
    den = sum(float(v.double().cpu().square().sum()) for v in fb.values())
    return (num / max(den, 1e-300)) ** 0.5


def _lib_vae(out, card, x):
    import torch
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer
    from deeplearning4j_tpu_torch.nn.layers.variational import (
        BernoulliReconstructionDistribution, VariationalAutoencoder)
    from deeplearning4j_tpu_torch.ops.activations import Activation
    from deeplearning4j_tpu_torch.optimize.updaters import Adam
    conf = (NeuralNetConfiguration.Builder().seed(18).updater(Adam(1e-3))
            .list().layer(VariationalAutoencoder(
                activation=Activation.LEAKYRELU,
                reconstruction_distribution=(
                    BernoulliReconstructionDistribution()), **LIB_VAE))
            .layer(OutputLayer(n_out=10))
            .set_input_type(InputType.feed_forward(x.shape[1])).build())
    model = MultiLayerNetwork(conf).init()
    layer = model.layers[0]
    cpu = _copy_model(model, "cpu")
    g = torch.Generator().manual_seed(5)
    xb = x[:LIB_PRETRAIN_BATCH]
    eps = torch.randn((LIB_PRETRAIN_BATCH, LIB_VAE["n_out"]), generator=g)
    # one pretrain step from the same params and noise, card and CPU
    tx = conf.global_config.updater.to_transform()
    steps = {}
    for m, dev in ((model, "cuda"), (cpu, "cpu")):
        lp = m.params[layer.name]
        lp2, _, loss = m.pretrain_step(0, tx, lp, tx.init(lp), xb,
                                       eps=[eps.to(dev)])
        steps[dev] = (float(loss), lp2)
    loss_err = abs(steps["cuda"][0] - steps["cpu"][0]) / abs(steps["cpu"][0])
    param_err = _tree_rel_l2(steps["cuda"][1], steps["cpu"][1])

    def elbo():
        with torch.no_grad():
            return float(layer.pretrain_loss(
                model.params[layer.name], torch.from_numpy(xb).cuda(),
                eps=[eps.cuda()]))
    before = elbo()
    t0 = time.perf_counter()
    model.pretrain(_batches(x, LIB_PRETRAIN_BATCH), epochs=LIB_VAE_EPOCHS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    after = elbo()
    with torch.no_grad():
        lp = model.params[layer.name]
        xt = torch.from_numpy(x[:64]).cuda()
        logp = layer.reconstruction_log_probability(
            lp, xt, generator=torch.Generator(device="cuda").manual_seed(0))
        gen = layer.generate_at_mean_given_z(lp, torch.zeros(
            (4, LIB_VAE["n_out"]), device="cuda"))
    extras_ok = bool(torch.isfinite(logp).all()
                     and gen.shape == (4, x.shape[1])
                     and torch.isfinite(gen).all())
    n_img = LIB_VAE_EPOCHS * (len(x) // LIB_PRETRAIN_BATCH) \
        * LIB_PRETRAIN_BATCH
    res = {"elbo_before": before, "elbo_after": after,
           "pretrain_s": secs, "epochs": LIB_VAE_EPOCHS,
           "images_per_s": n_img / secs,
           "step_loss_rel_card_vs_cpu": loss_err,
           "step_params_rel_l2_card_vs_cpu": param_err,
           "mean_log_p_x": float(logp.mean()), "extras_ok": extras_ok}
    log(f"  VAE 784 -> (256, 256) -> 32 (Bernoulli): negative ELBO on a "
        f"fixed batch {before:.3f} -> {after:.3f} after {LIB_VAE_EPOCHS} "
        f"epochs ({secs:.2f} s, {res['images_per_s']:.0f} images/s); one "
        f"step with injected eps card vs CPU: loss {loss_err:.3g}, params "
        f"{param_err:.3g} rel L2; mean log p(x) {res['mean_log_p_x']:.2f} "
        f"[{card}]")
    if not (after < before and loss_err <= LOSS_RTOL
            and param_err <= LIB_STEP_RTOL and extras_ok):
        raise AssertionError("VAE: the ELBO did not fall, the step "
                             "disagrees with the CPU, or the extras fail")
    out["vae"] = res


def _lib_autoencoder(out, card, x, y):
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.feedforward import AutoEncoder
    from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer
    from deeplearning4j_tpu_torch.ops.activations import Activation
    from deeplearning4j_tpu_torch.optimize.updaters import Adam
    conf = (NeuralNetConfiguration.Builder().seed(18).updater(Adam(1e-3))
            .list()
            .layer(AutoEncoder(n_out=500, activation=Activation.SIGMOID,
                               corruption_level=0.3))
            .layer(AutoEncoder(n_out=250, activation=Activation.SIGMOID,
                               corruption_level=0.3))
            .layer(OutputLayer(n_out=10))
            .set_input_type(InputType.feed_forward(x.shape[1])).build())
    model = MultiLayerNetwork(conf).init()
    onehot = np.eye(10, dtype=np.float32)[y]
    data = DataSet(x[:512], onehot[:512])
    t0 = time.perf_counter()
    model.pretrain(_batches(x, LIB_PRETRAIN_BATCH), epochs=LIB_AE_EPOCHS)
    pre_s = time.perf_counter() - t0
    recon = float(model.score())
    before = model.score(data)
    for _ in range(LIB_FIT_EPOCHS):
        for b in _batches(x, 64, onehot):
            model.fit(b)
    after = model.score(data)
    res = {"pretrain_s": pre_s, "last_reconstruction_loss": recon,
           "loss_before_fit": before, "loss_after_fit": after}
    log(f"  AutoEncoder 784-500-250 (corruption 0.3): pretrain "
        f"{LIB_AE_EPOCHS} epochs a layer in {pre_s:.2f} s (last "
        f"reconstruction loss {recon:.3f}); supervised loss {before:.4f} -> "
        f"{after:.4f} after {LIB_FIT_EPOCHS} epochs [{card}]")
    if not after < before:
        raise AssertionError("AutoEncoder stack: the supervised loss did not "
                             "fall after pretraining")
    out["autoencoder"] = res


def moe_stack(compute_dtype, seed=18, device="cuda"):
    """EmbeddingSequenceLayer(30522 -> 768), LearnedPositionalEmbedding,
    2 pre-LN TransformerEncoderBlocks (768, 12 heads), MixtureOfExperts
    (8 experts of 3072, top 2, capacity factor 1.25, GELU),
    RnnOutputLayer(30522), Adam(1e-4), on ``device`` from ``seed``."""
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.attention import (
        LearnedPositionalEmbedding, TransformerEncoderBlock)
    from deeplearning4j_tpu_torch.nn.layers.feedforward import (
        EmbeddingSequenceLayer, MixtureOfExperts)
    from deeplearning4j_tpu_torch.nn.layers.output import RnnOutputLayer
    from deeplearning4j_tpu_torch.ops.activations import Activation
    from deeplearning4j_tpu_torch.optimize.updaters import Adam
    c = LIB_MOE
    b = (NeuralNetConfiguration.Builder().seed(seed).updater(Adam(1e-4))
         .compute_dtype(compute_dtype).list()
         .layer(EmbeddingSequenceLayer(n_in=c["vocab"], n_out=c["width"]))
         .layer(LearnedPositionalEmbedding(max_len=c["seq"])))
    for _ in range(c["blocks"]):
        b = b.layer(TransformerEncoderBlock(n_out=c["width"],
                                            n_heads=c["heads"], ffn_mult=4))
    conf = (b.layer(MixtureOfExperts(
        n_out=c["width"], num_experts=c["experts"], hidden=c["hidden"],
        top_k=c["top_k"], capacity_factor=c["capacity_factor"],
        activation=Activation.GELU))
        .layer(RnnOutputLayer(n_out=c["vocab"]))
        .set_input_type(InputType.recurrent(1, c["seq"])).build())
    return MultiLayerNetwork(conf, device=device).init()


def _moe_batch(rng, n):
    """``n`` random id sequences with random one-hot labels and a ragged
    padding mask (features and labels)."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    c = LIB_MOE
    ids = rng.integers(0, c["vocab"], (n, c["seq"]))
    lab = rng.integers(0, c["vocab"], (n, c["seq"]))
    fm = ragged_mask(n, c["seq"], rng, min_len=c["seq"] // 2)
    y = np.zeros((n, c["seq"], c["vocab"]), np.float32)
    y[np.arange(n)[:, None], np.arange(c["seq"])[None, :], lab] = 1.0
    return DataSet(ids, y, fm, fm)


def _lib_moe(out, card, launches):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.optimize import solver
    from deeplearning4j_tpu_torch.parallel.moe import route_top_k
    c = LIB_MOE
    rng = np.random.default_rng(18)
    model = moe_stack("bfloat16")
    moe_i = len(model.layers) - 2
    moe_name = model.layers[moe_i].name
    ds = _moe_batch(rng, LIB_MOE_BATCH)
    losses, aux, step_launches = [], [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LIB_MOE_STEPS):
        _, made = _counted(launches, lambda: model.fit(ds))
        step_launches.append(made)
        losses.append(model.score())
        aux.append(float(model.model_state[moe_name]["moe_aux_loss"]))
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / LIB_MOE_STEPS
    want = {k: c["blocks"] for k in ATTN_KERNELS}
    # routing and masked tokens on the trained stack, with the batch's mask
    args = model._step_args(ds)
    with torch.no_grad():
        h, _ = model._forward(model.params, model.model_state, args[0],
                              args[2], False, upto=moe_i)
        y_moe, _ = model._forward(model.params, model.model_state, args[0],
                                  args[2], False, upto=moe_i + 1)
        fm = args[2] > 0
        masked_zero = bool((y_moe[~fm] == 0).all())
        logits = h.reshape(-1, c["width"]) @ model.params[moe_name][
            "gate"].to(h.dtype)
        cap = max(1, int(c["capacity_factor"] * c["top_k"]
                         * logits.shape[0] / c["experts"]))
        d, comb, a, z = route_top_k(logits, c["top_k"], cap,
                                    token_mask=args[2].reshape(-1))
        valid = int(args[2].sum())
        routed = int(d.sum())
        per_expert = d.sum((0, 2)).long().tolist()
    # one f32 step on a small ragged batch: kernels against plain versions,
    # and the aux term counted in the loss
    m32 = moe_stack("float32")
    m32.set_params(model.params)
    small = _moe_batch(rng, LIB_MOE_CHECK_BATCH)
    a32 = m32._step_args(small)
    loss_k, _, g_k = solver.value_and_grad(m32._loss, m32.train_state, *a32)
    with plain_flash():
        loss_p, _, g_p = solver.value_and_grad(m32._loss, m32.train_state,
                                               *a32)
    gerr = grad_errors(g_k, g_p)
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    with torch.no_grad():
        total, st = m32._loss(m32.params, m32.model_state, *a32, None, 0)
        with mock.patch("deeplearning4j_tpu_torch.models."
                        "multi_layer_network.moe_aux_loss",
                        lambda s: None):
            bare, _ = m32._loss(m32.params, m32.model_state, *a32, None, 0)
    aux32 = float(st[moe_name]["moe_aux_loss"])
    aux_in_loss = abs(float(total) - float(bare) - aux32) <= 1e-5 * abs(
        float(total))
    m_k, m_p = m32.clone(), m32.clone()
    m_k.fit(small)
    with plain_flash():
        m_p.fit(small)
    param_err = _tree_rel_l2(m_k.params, m_p.params)
    res = {"batch": LIB_MOE_BATCH, "seq": c["seq"], "steps": LIB_MOE_STEPS,
           "losses": losses, "aux": aux, "step_ms": step_ms,
           "tokens_per_s": 1e3 * LIB_MOE_BATCH * c["seq"] / step_ms,
           "launches_per_step": step_launches, "masked_out_zero": masked_zero,
           "valid_tokens": valid, "capacity": cap, "dispatched": routed,
           "dropped": c["top_k"] * valid - routed,
           "per_expert": per_expert, "combine_sum": float(comb.sum()),
           "aux_loss_router": float(a), "z_loss_router": float(z),
           "f32_loss_rel_err": loss_err, "f32_grad_rel_l2": gerr,
           "f32_step_params_rel_l2": param_err, "aux_in_loss": aux_in_loss,
           "aux_f32": aux32,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    log(f"  MoE stack (2 x 768/12 blocks, 8 experts of 3072, top 2) bf16 at "
        f"{LIB_MOE_BATCH} x {c['seq']} with a ragged mask: losses "
        f"{' '.join(f'{v:.4f}' for v in losses)}, moe_aux_loss "
        f"{' '.join(f'{v:.4f}' for v in aux)}; {step_ms:.2f} ms a step, "
        f"{res['tokens_per_s']:.0f} tokens/s; flash launches a step "
        f"{step_launches[-1]} [{card}]")
    log(f"  routing: {valid} valid tokens, capacity {cap}, {routed} "
        f"dispatched ({res['dropped']} dropped), per expert {per_expert}; "
        f"masked tokens' MoE output exactly 0: {masked_zero}")
    log(f"  f32 step at {LIB_MOE_CHECK_BATCH} x {c['seq']}, kernels vs plain: "
        f"loss {loss_err:.3g}, gradients worst {gerr['worst']:.3g} "
        f"({gerr['name']}), params after one Adam step {param_err:.3g} rel "
        f"L2; aux {aux32:.5f} counted in the loss: {aux_in_loss}")
    if any(m != want for m in step_launches):
        raise AssertionError(f"MoE stack: flash launches a step "
                             f"{step_launches}, expected {want}")
    if not (np.isfinite(losses).all() and np.mean(losses[-4:]) < losses[0]
            and np.isfinite(aux).all() and masked_zero and aux_in_loss):
        raise AssertionError("MoE stack: the loss did not fall, the aux "
                             "loss is not finite or not in the loss, or a "
                             "masked token's output is not 0")
    if loss_err > LOSS_RTOL or gerr["worst"] > BERT_GRAD_RTOL \
            or param_err > LIB_STEP_RTOL:
        raise AssertionError("MoE stack: the f32 step through the flash "
                             "kernels disagrees with the plain path")
    out["moe"] = res
    del model, m32, m_k, m_p
    torch.cuda.empty_cache()


def _lib_custom(out, card, x):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.gradientcheck import check_model_gradients
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
    from deeplearning4j_tpu_torch.nn.layers.misc import (LambdaLayer,
                                                         SameDiffLayer)
    from deeplearning4j_tpu_torch.nn.layers.output import (OutputLayer,
                                                           RnnOutputLayer)
    from deeplearning4j_tpu_torch.nn.layers.recurrent import LSTM
    conf = (NeuralNetConfiguration.Builder().seed(18).list()
            .layer(DenseLayer(n_out=64))
            .layer(LambdaLayer(fn=lambda v: v * torch.sigmoid(v)))
            .layer(SameDiffLayer(
                param_shapes={"W": (64, 32), "b": (32,)},
                fn=lambda p, v: torch.tanh(v @ p["W"] + p["b"]),
                out_type=lambda it: it.__class__(32)))
            .layer(OutputLayer(n_out=10))
            .set_input_type(InputType.feed_forward(x.shape[1])).build())
    model = MultiLayerNetwork(conf).init()
    cpu = _copy_model(model, "cpu")
    err = _row_err(model.output(x[:256]), cpu.output(x[:256]))
    t0 = time.perf_counter()
    grad_ok = check_model_gradients(library_mln("cuda"), library_data(),
                                    max_params_per_leaf=6, verbose=False)
    gc_s = time.perf_counter() - t0
    lstm_conf = (NeuralNetConfiguration.Builder().seed(1).list()
                 .layer(LSTM(n_out=8)).layer(RnnOutputLayer(n_out=3))
                 .set_input_type(InputType.recurrent(4, 5)).build())
    rng = np.random.default_rng(0)
    lds = DataSet(rng.normal(size=(2, 5, 4)).astype(np.float32),
                  np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 5))])
    lstm_error = None
    try:
        check_model_gradients(MultiLayerNetwork(lstm_conf).init(), lds,
                              verbose=False)
    except TypeError as e:
        lstm_error = str(e)
    res = {"custom_row_rel_err_card_vs_cpu": err,
           "gradient_check_passed": grad_ok, "gradient_check_s": gc_s,
           "f64_lstm_type_error": lstm_error}
    log(f"  LambdaLayer + SameDiffLayer MLN card vs CPU: {err:.3g} of each "
        f"row's largest; float64 gradient check of dense + AutoEncoder + "
        f"MoE + SameDiff + output on the card: {grad_ok} ({gc_s:.1f} s); "
        f"f64 LSTM on the card: TypeError {lstm_error!r}")
    if err > LIB_CUSTOM_TOL or not grad_ok or lstm_error is None \
            or "float32 or bfloat16" not in lstm_error:
        raise AssertionError("custom layers, the gradient check or the f64 "
                             "LSTM guard failed on the card")
    out["custom"] = res


def _lib_memory(out, card):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.memory import (device_memory_analysis,
                                                    memory_report)
    from deeplearning4j_tpu_torch.optimize.updaters import Nesterovs
    from deeplearning4j_tpu_torch.zoo import models as Z

    def resnet():
        # bench.py:46-56: 64x64x3, 200 classes, bf16, s2d stem, fused
        # blocks as bench.py trains them, Nesterovs(1e-2, 0.9)
        return Z.ResNet50(updater=Nesterovs(1e-2, 0.9), fused_blocks=True,
                          fused_impl="xla", **ZOO_BENCH)
    confs = {"LeNet": Z.LeNet().conf(), "ResNet50": resnet().conf(),
             "TextGenerationLSTM": Z.TextGenerationLSTM().conf(),
             "BERT": bert_model("bfloat16", device="cpu").conf}
    rep = {}
    for name, conf in confs.items():
        r = memory_report(conf, name)
        rep[name] = {"parameters": r.total_parameters,
                     "train_bytes_at_32": r.total_bytes(32),
                     "train_bytes_at_128": r.total_bytes(128)}
        log(f"  memory_report {name}: {r.total_parameters:,} parameters, "
            f"train estimate {r.total_bytes(32) / 2**20:.1f} MiB at 32, "
            f"{r.total_bytes(128) / 2**20:.1f} MiB at 128 (f32)")
    dev = {}
    b = LIB_MEMORY_BATCH
    for name, make, n_out in (("LeNet", lambda: Z.LeNet().init(), 10),
                              ("ResNet50", lambda: resnet().init(), 200)):
        model = make()
        ana = device_memory_analysis(model, batch_size=b, train=True)
        fwd = device_memory_analysis(model, batch_size=b, train=False)
        it = (model.conf.network_input_types[0]
              if hasattr(model.conf, "network_inputs")
              else model.conf.input_type)
        xz = np.zeros((b,) + tuple(it.shape()), np.float32)
        yz = np.zeros((b, n_out), np.float32)
        model.fit(DataSet(xz, yz))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model.fit(DataSet(xz, yz))
        torch.cuda.synchronize()
        real = torch.cuda.max_memory_allocated() - base
        dev[name] = {"train": ana, "forward": fwd,
                     "real_step_peak_above_resident": real}
        log(f"  device_memory_analysis {name} at {b}: train step "
            f"{ana['temp_size_in_bytes'] / 2**20:.1f} MiB above "
            f"{ana['argument_size_in_bytes'] / 2**20:.1f} MiB of arguments "
            f"(a real fit step: {real / 2**20:.1f} MiB above resident); "
            f"forward {fwd['temp_size_in_bytes'] / 2**20:.1f} MiB [{card}]")
        if not (ana.get("temp_size_in_bytes", 0) > 0
                and fwd.get("temp_size_in_bytes", 0) > 0):
            raise AssertionError(f"{name}: device_memory_analysis is empty")
        del model
        torch.cuda.empty_cache()
    out["memory"] = {"report": rep, "device": dev}


def _trustworthiness(x, y, k=5):
    """The trustworthiness T(k) of an embedding ``y`` of ``x`` (Venna and
    Kaski): 1 - 2 / (n k (2n - 3k - 1)) times the sum, over each point's
    k embedding neighbours, of how far their rank in the input space lies
    beyond k."""
    import numpy as np
    n = x.shape[0]

    def sq(a):
        s = (a * a).sum(1)
        d = s[:, None] + s[None, :] - 2 * a @ a.T
        np.fill_diagonal(d, np.inf)
        return d
    rank = np.empty((n, n), np.int64)
    order = np.argsort(sq(x.astype(np.float64)), axis=1)
    rank[np.arange(n)[:, None], order] = np.arange(n)[None, :] + 1
    nn_y = np.argsort(sq(y.astype(np.float64)), axis=1)[:, :k]
    r = rank[np.arange(n)[:, None], nn_y]
    return 1.0 - 2.0 / (n * k * (2 * n - 3 * k - 1)) * np.clip(
        r - k, 0, None).sum()


def _lib_kmeans_tsne(out, card, x, y):
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.clustering import KMeansClustering
    from deeplearning4j_tpu_torch.manifold import tsne as TT
    from deeplearning4j_tpu_torch.ui import TsneListener, UIServer
    from deeplearning4j_tpu_torch.ui.storage import InMemoryStatsStorage
    from deeplearning4j_tpu_torch.zoo.models import LeNet
    lenet = LeNet().init_pretrained(flavor="digits")
    feats = lenet.feed_forward(x)[-2].float().cpu().numpy()
    t0 = time.perf_counter()
    km = KMeansClustering(10, seed=18).apply_to(feats)
    km_s = time.perf_counter() - t0
    kc = KMeansClustering(10, seed=18, device="cpu").apply_to(feats)
    center_err = float(np.abs(km.cluster_centers_ - kc.cluster_centers_)
                       .max() / np.abs(kc.cluster_centers_).max())
    purity = float(sum(np.bincount(y[km.labels_ == c]).max()
                       for c in np.unique(km.labels_)) / len(y))
    same_labels = bool(np.array_equal(km.labels_, kc.labels_))
    log(f"  k-means(10) of LeNet's 500-wide features of {len(x)} digits: "
        f"{km.n_iter_} Lloyd steps in {km_s:.3f} s, inertia "
        f"{km.inertia_:.1f} (CPU {kc.inertia_:.1f}), purity {purity:.4f}, "
        f"centers card vs CPU {center_err:.3g} of the largest, labels equal "
        f"{same_labels} [{card}]")
    if center_err > LIB_KMEANS_TOL:
        raise AssertionError("k-means centers on the card disagree with the "
                             "CPU's")
    # exact t-SNE of the digits: the first steps card vs CPU from the same
    # state (a difference grows about tenfold a step under early
    # exaggeration, so each step is held, not the trajectory), then the
    # whole run on the card
    ts = TT.Tsne(seed=18)
    t0 = time.perf_counter()
    P = ts._p_matrix(x.astype(np.float64)).astype(np.float32)
    p_s = time.perf_counter() - t0
    Pc, Pg = torch.from_numpy(P), torch.from_numpy(P).cuda()
    y0 = torch.from_numpy(ts._init_y(len(x)).astype(np.float32))
    state = (y0, torch.zeros_like(y0), torch.ones_like(y0))
    step_err = 0.0
    for it in range(LIB_TSNE_CHECK_STEPS):
        ex, mom = ts._schedule(it)
        want = TT._tsne_step(Pc * ex if ex != 1.0 else Pc, *state, mom,
                             ts.learning_rate)
        got = TT._tsne_step(Pg * ex if ex != 1.0 else Pg,
                            *(s.cuda() for s in state), mom,
                            ts.learning_rate)
        for a, b in zip(got[:3], want[:3]):
            step_err = max(step_err, float((a.cpu() - b).abs().max()
                                           / b.abs().max().clamp(min=1e-3)))
        state = want[:3]
    t0 = time.perf_counter()
    emb = ts.fit_transform(x)
    tsne_s = time.perf_counter() - t0
    trust = float(_trustworthiness(x, emb))
    t0 = time.perf_counter()
    bh = TT.BarnesHutTsne(theta=0.5, n_iter=LIB_BH_ITERS,
                          seed=18).fit_transform(x[:LIB_BH_POINTS])
    bh_s = time.perf_counter() - t0
    log(f"  exact t-SNE of {len(x)} digits ({x.shape[1]}-d): P on the host "
        f"{p_s:.2f} s; each of the first {LIB_TSNE_CHECK_STEPS} steps card "
        f"vs CPU from the same state within {step_err:.3g} of the largest; "
        f"{ts.n_iter} iterations (P included) {tsne_s:.2f} s, KL "
        f"{ts.kl_divergence_:.4f}, trustworthiness(5) {trust:.4f}; "
        f"Barnes-Hut (theta 0.5) on {LIB_BH_POINTS} points, {LIB_BH_ITERS} "
        f"iterations {bh_s:.2f} s [{card}]")
    if step_err > LIB_TSNE_TOL or not np.isfinite(emb).all() \
            or not np.isfinite(bh).all():
        raise AssertionError("t-SNE: a step on the card disagrees with the "
                             "CPU's, or an embedding is not finite")
    # TsneListener in a short fit, pushing to a running UIServer
    srv = UIServer(port=0).attach(InMemoryStatsStorage()).start()
    try:
        lst = TsneListener(srv, frequency=2, max_points=200, n_iter=100)
        lst.set_example(x[:200], y[:200])
        model = LeNet().init()
        model.set_listeners(lst)
        onehot = np.eye(10, dtype=np.float32)[y]
        for b in _batches(x[:128], 64, onehot[:128]):
            model.fit(b)
        joined = lst.join(timeout=120)
        data = getattr(srv._httpd, "tsne_data", None)
        n_pts = len(data["points"]) if data else 0
    finally:
        srv.stop()
    log(f"  TsneListener in a LeNet fit: {n_pts} coordinates on the "
        f"dashboard's t-SNE tab")
    if not (joined and n_pts == 200):
        raise AssertionError("TsneListener wrote no coordinates")
    out["kmeans"] = {"seconds": km_s, "iterations": km.n_iter_,
                     "inertia": km.inertia_, "cpu_inertia": kc.inertia_,
                     "purity": purity, "center_rel_err": center_err,
                     "labels_equal": same_labels}
    out["tsne"] = {"points": len(x), "p_matrix_s": p_s,
                   "check_steps": LIB_TSNE_CHECK_STEPS,
                   "step_rel_err_card_vs_cpu": step_err,
                   "seconds": tsne_s, "iterations": ts.n_iter,
                   "kl": ts.kl_divergence_, "trustworthiness_5": trust,
                   "barnes_hut_s": bh_s, "listener_points": n_pts}


def phase_model_library(report, card):
    import torch
    out = {}
    launches = {}
    x, y = _all_digits()
    _lib_vae(out, card, x)
    _lib_autoencoder(out, card, x, y)
    torch.cuda.reset_peak_memory_stats()
    _lib_moe(out, card, launches)
    _lib_custom(out, card, x)
    _lib_memory(out, card)
    _lib_kmeans_tsne(out, card, x, y)
    report["model_library"] = out
    return launches


# ---------------------------------------------------------------------------
# cluster: serve --join nodes over ResNet50 behind the RemoteDispatcher
# ---------------------------------------------------------------------------

CLUSTER_CLIENTS, CLUSTER_PER_CLIENT = 4, 10    # 40 requests of 1-32 images
CLUSTER_DRAIN_AT = 20          # node a drains once this many have answered
CLUSTER_SUB_REQUESTS = 12      # through the subprocess's kill and rejoin
CLUSTER_SEED = 19


class _NodeProcess:
    """``python -m deeplearning4j_tpu_torch serve ... --join`` as a user
    starts a node; its output read in a thread, its registration read from
    the registry."""

    def __init__(self, args):
        self.lines = []
        self.t_start = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "deeplearning4j_tpu_torch", "serve",
             *args], cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self._t = threading.Thread(target=self._read, daemon=True)
        self._t.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip())

    def wait_registered(self, registry, node_id, timeout):
        """The node's record with this process's pid (a node registers
        only after its warmup); returns (record, seconds since spawn)."""
        deadline = time.perf_counter() + timeout
        while time.perf_counter() < deadline:
            rec = registry.read_all().get(node_id)
            if rec and rec.get("pid") == self.proc.pid:
                return rec, time.perf_counter() - self.t_start
            if self.proc.poll() is not None:
                break
            time.sleep(0.05)
        raise AssertionError(f"node {node_id} never registered (exit "
                             f"{self.proc.poll()}): "
                             + " | ".join(self.lines[-20:]))

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self._t.join(timeout=10)


def _answering_transport():
    """The dispatcher's HTTP transport, recording on the calling thread
    which URL the last attempt went to (predict returns on its first OK
    attempt, so that is the answering node)."""
    from deeplearning4j_tpu_torch.parallel import remote
    seen = threading.local()

    def transport(url, body, timeout_s):
        seen.url = url
        return remote._http_transport(url, body, timeout_s)
    return transport, seen


def _cluster_clients(dispatcher, seen, reqs, nodes_by_url, answers,
                     on_answer=None):
    """CLUSTER_CLIENTS threads sending ``reqs`` (a list per client)
    through ``dispatcher``; ``answers[c][i]`` = (output f32, n, node)."""
    import numpy as np
    done = [0]
    lock = threading.Lock()
    errors = []

    def client(c):
        try:
            for i, x in enumerate(reqs[c]):
                out = dispatcher.predict(x)
                url = seen.url.split("/api/")[0]
                answers[c][i] = (np.asarray(out["output"], np.float32),
                                 out["n"], nodes_by_url.get(url, url))
                with lock:
                    done[0] += 1
                    n = done[0]
                if on_answer is not None:
                    on_answer(n)
        except BaseException as e:      # re-raised by the caller
            errors.append(e)
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(len(reqs))]
    for th in threads:
        th.start()
    return threads, errors


def _dispatch_oks(dispatcher):
    return {dict(k)["node"]: v
            for k, v in dispatcher._c_dispatch.series().items()
            if dict(k).get("outcome") == "ok"}


def phase_cluster(report, card):
    """Two in-process ``ServingNode``s and a ``serve --join`` subprocess
    over the slice ResNet50 behind one ``RemoteDispatcher`` (module
    docstring, phase 20). Returns the in-process nodes' kernel launches."""
    import tempfile

    import numpy as np
    from deeplearning4j_tpu_torch.models.serialization import (
        params_from_jax, save_model)
    from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
    from deeplearning4j_tpu_torch.ops import fused_conv as fc
    from deeplearning4j_tpu_torch.parallel.node import (AutoScaler,
                                                        NodeRegistry,
                                                        ServingNode)
    from deeplearning4j_tpu_torch.parallel.remote import RemoteDispatcher
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    t_phase = time.perf_counter()
    out = {"card": card, "seconds": {}}
    rng = np.random.default_rng(CLUSTER_SEED)
    tmp = tempfile.TemporaryDirectory(prefix="cluster_")
    reg_dir = os.path.join(tmp.name, "registry")
    registry = NodeRegistry(reg_dir)
    zip_path = os.path.join(tmp.name, "resnet50.zip")
    model = ResNet50(**SLICE).init()           # cuda, seeded generator
    params_from_jax(*nontrivial_bn(model), model.device, model=model)
    save_model(model, zip_path)
    per_fwd = {k: sum(n for c, n in path_calls(model.conf, 1).items()
                      if c.kernel == k) for k in FORWARD}
    node_args = ["--model", zip_path, "--bf16", "--warmup-shape",
                 *map(str, _image_shape()), "--batch-limit", "32",
                 "--ui-port", "0", "--join", reg_dir, "--node-id", "sub"]
    nodes, dispatcher, sub = [], None, None
    try:
        engine_kw = dict(batch_limit=32, feature_shape=_image_shape(),
                         precision="bf16")
        for nid in ("a", "b"):
            nodes.append(ServingNode(
                model, node_id=nid, registry=registry, model_name="resnet",
                metrics_registry=MetricsRegistry(), window_s=10.0,
                device="cuda", **engine_kw))
        engines = {n.node_id: n.router.pool("resnet").engines[0]
                   for n in nodes}
        transport, seen = _answering_transport()
        dispatcher = RemoteDispatcher(registry, metrics=MetricsRegistry(),
                                      transport=transport, seed=0,
                                      timeout_s=120.0)
        out["seconds"]["setup"] = time.perf_counter() - t_phase

        # ---- 1. traffic over the two in-process nodes, A drained
        sizes = rng.integers(1, 33, (CLUSTER_CLIENTS, CLUSTER_PER_CLIENT))
        reqs = [[_pixels(rng, int(n)) for n in row] for row in sizes]
        flat = [x for row in reqs for x in row]
        t0 = time.perf_counter()
        ref = {nid: [e.output(x) for x in flat]
               for nid, e in engines.items()}
        direct = [model.output(x).float().cpu().numpy() for x in flat]
        out["seconds"]["references"] = time.perf_counter() - t0
        fc.reset_launch_counts()
        batches0 = {nid: e.dispatch_count for nid, e in engines.items()}
        answers = [[None] * CLUSTER_PER_CLIENT
                   for _ in range(CLUSTER_CLIENTS)]
        drain_now = threading.Event()
        urls = {n.url: n.node_id for n in nodes}
        t0 = time.perf_counter()
        threads, errors = _cluster_clients(
            dispatcher, seen, reqs, urls, answers,
            on_answer=lambda n: n >= CLUSTER_DRAIN_AT and drain_now.set())
        if not drain_now.wait(600):
            raise AssertionError("cluster traffic stalled before the drain")
        drained = nodes[0].drain(timeout_s=60.0)
        left_after_drain = registry.read_all()
        for th in threads:
            th.join()
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        batches = {nid: e.dispatch_count - batches0[nid]
                   for nid, e in engines.items()}
        launches = {k: fc.LAUNCHES[k] for k in FORWARD}
        n_req = len(flat)
        by_node = {"a": 0, "b": 0}
        worst = 0.0
        for i, (x, (a, n, nid)) in enumerate(
                zip(flat, [a for row in answers for a in row])):
            if n != len(x) or a.shape != ref[nid][i].shape \
                    or not np.isfinite(a).all():
                raise AssertionError(f"request {i}: n {n} for {len(x)} "
                                     "images, or a misshapen answer")
            if not np.array_equal(a, ref[nid][i]):
                raise AssertionError(f"request {i}: node {nid}'s answer "
                                     "differs from its own engine's output")
            by_node[nid] += 1
            worst = max(worst, float(np.abs(a - direct[i]).max()))
        if worst > 5e-3:
            raise AssertionError(f"cluster answers differ from model.output "
                                 f"by {worst} (> 5e-3)")
        oks = _dispatch_oks(dispatcher)
        served = {n.node_id: n.router.pool("resnet").ring.count
                  for n in nodes}
        if sum(oks.values()) != n_req or sum(served.values()) != n_req:
            raise AssertionError(f"{n_req} requests, dispatcher OKs {oks}, "
                                 f"nodes served {served}")
        if not drained["drained"] or drained["inflight_left"] \
                or "a" in left_after_drain or by_node["a"] == 0:
            raise AssertionError(f"node a's drain {drained}, registry "
                                 f"{sorted(left_after_drain)}, answers "
                                 f"{by_node}")
        for k in FORWARD:
            want = per_fwd[k] * sum(batches.values())
            if launches[k] != want or not launches[k]:
                raise AssertionError(f"{k}: {launches[k]} launches for "
                                     f"{batches} batches, expected {want}")
        shed = sum(v for k, v in dispatcher._c_dispatch.series().items()
                   if dict(k).get("outcome") == "shed")
        images = int(sizes.sum())
        out["in_process"] = {
            "requests": n_req, "images": images, "by_node": by_node,
            "dispatch_ok": oks, "dispatch_shed": shed,
            "node_served": served, "batches": batches,
            "launches": launches, "drain": drained,
            "max_diff_vs_model_output": worst, "wall_s": wall,
            "images_per_s": images / wall}
        log(f"  {n_req} requests ({images} images) through the "
            f"RemoteDispatcher over HTTP, {CLUSTER_CLIENTS} clients: each "
            f"answer bitwise its node's engine; by node {by_node}; node a "
            f"drained after {CLUSTER_DRAIN_AT} answers in "
            f"{drained['seconds']:.3f}s with {drained['inflight_left']} left "
            f"and deregistered; dispatcher OKs {oks} (503s retried: {shed}),"
            f" served {served}; max |diff| vs model.output {worst:.3g}; "
            f"{images / wall:.1f} images/s [{card}]")
        log(f"  launches {launches} for {batches} batches "
            f"({per_fwd} a batch)")

        # ---- 2. the autoscaler reads the gossip
        clock = [0.0]
        stopped = []
        scaler = AutoScaler(registry, spawn=lambda: None,
                            stop=stopped.append, idle_after_s=1.0,
                            clock=lambda: clock[0])
        nodes[1]._beat_now()            # gossip b's final counts first
        ticks = [scaler.tick()]
        clock[0] += 1.0
        ticks.append(scaler.tick())
        gossip = registry.read_all()["b"]["stats"]
        if ticks != [None, "down"] or stopped not in (["b"], ["sub"]):
            raise AssertionError(f"autoscaler ticks {ticks}, stopped "
                                 f"{stopped}")
        out["autoscaler"] = {"ticks": ticks, "stopped": stopped,
                             "gossip_b": gossip}
        log(f"  AutoScaler over the gossip: ticks {ticks}, would stop "
            f"{stopped}; node b gossips {gossip}")

        # ---- 3. the subprocess node: cold start, SIGKILL, rejoin, SIGTERM
        sub = _NodeProcess(node_args)
        rec, cold_total = sub.wait_registered(registry, "sub", 600)
        code, _, st = _http(rec["url"] + "/api/serving/stats")
        dev = st.get("device")
        if code != 200 or st["recompiles_after_warmup"] != 0 \
                or dev != "cuda:0":
            raise AssertionError(f"the subprocess node's stats: {code} {st}")
        load_s = _kernel_load_seconds()
        cold = {"spawn_to_registered_s": cold_total,
                "warmup_s": st["warmup_s"],
                "kernel_load_s": load_s,
                "warmup_sweep_s": st["warmup_s"] - load_s,
                "import_restore_serve_s": cold_total - st["warmup_s"],
                "nvcc_build_s": {k: _build_seconds(k) for k in FORWARD}}
        out["cold_start"] = cold
        log(f"  subprocess node cold start: {cold_total:.2f}s from spawn to "
            f"registered (warm: registers after its sweep, 0 live "
            f"compiles); its warmup {st['warmup_s']:.3f}s holds the kernel "
            f"libraries' first load ({load_s:.3f}s in a fresh process, "
            f"built by this run's build phase) and the sweep "
            f"({cold['warmup_sweep_s']:.3f}s); imports + restore + HTTP "
            f"{cold['import_restore_serve_s']:.2f}s; nvcc of the two "
            f"sources when nothing is built: {cold['nvcc_build_s']} [{card}]")
        out["subprocess"] = _cluster_subprocess(
            card, registry, dispatcher, seen, nodes[1], sub, node_args,
            rng, engines["b"])
    finally:
        for n in nodes:
            n.shutdown()
        if dispatcher is not None:
            dispatcher.shutdown()
        if sub is not None:
            sub.stop()
        tmp.cleanup()
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    log(f"  cluster phase seconds "
        f"{ {k: round(v, 1) for k, v in out['seconds'].items()} }")
    report["cluster"] = out
    return out["in_process"]["launches"]


def _kernel_load_seconds():
    """Seconds a fresh process takes to load the two forward kernels'
    libraries (already built): what a node's first dispatch pays for
    them, inside its warmup."""
    code = ("import time; t0 = time.perf_counter(); "
            "from deeplearning4j_tpu_torch.ops import cuda_build; "
            "[cuda_build.kernel(k) for k in ('fused_mm', 'fused_c3')]; "
            "print(time.perf_counter() - t0)")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         cwd=os.path.dirname(os.path.abspath(__file__)),
                         capture_output=True, text=True, timeout=300)
    return float(out.stdout.split()[-1])


def _build_seconds(source):
    """Seconds this run's build phase took for ``source`` (None when it
    found the library already built)."""
    from deeplearning4j_tpu_torch.ops import cuda_build
    got = cuda_build.build_log.get(source)
    return None if got is None else got[0]


def _cluster_subprocess(card, registry, dispatcher, seen, node_b, sub,
                        node_args, rng, engine_b):
    """Phase 20, step 3: traffic over node b and the subprocess node; the
    subprocess SIGKILLed mid-stream (its requests retried onto b), a
    rejoin with the same id, and its SIGTERM drain to exit 0."""
    import signal

    import numpy as np
    res = {}
    sizes = rng.integers(1, 33, (2, CLUSTER_SUB_REQUESTS // 2))
    reqs = [[_pixels(rng, int(n)) for n in row] for row in sizes]
    flat = [x for row in reqs for x in row]
    ref = [engine_b.output(x) for x in flat]
    sub_url = registry.read_all()["sub"]["url"]

    def run(label, kill_at=None, proc=None):
        answers = [[None] * len(reqs[0]) for _ in reqs]
        killed = threading.Event()

        def on_answer(n):
            if kill_at is not None and n >= kill_at \
                    and not killed.is_set():
                killed.set()
                proc.send_signal(signal.SIGKILL)
        urls = {node_b.url: "b", registry.read_all()["sub"]["url"]: "sub"}
        threads, errors = _cluster_clients(dispatcher, seen, reqs, urls,
                                           answers, on_answer)
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        by = {"b": 0, "sub": 0}
        for i, (a, n, nid) in enumerate(
                [a for row in answers for a in row]):
            if n != len(flat[i]) or not np.array_equal(a, ref[i]):
                raise AssertionError(f"{label}: request {i} answered by "
                                     f"{nid} differs from node b's engine")
            by[nid] = by.get(nid, 0) + 1
        return by, killed.is_set()

    oks0 = sum(_dispatch_oks(dispatcher).values())
    errs0 = sum(v for k, v in dispatcher._c_dispatch.series().items()
                if dict(k).get("outcome") == "error")
    by, killed = run("SIGKILL", kill_at=len(flat) // 2, proc=sub.proc)
    sub.proc.wait(timeout=60)
    errs = sum(v for k, v in dispatcher._c_dispatch.series().items()
               if dict(k).get("outcome") == "error") - errs0
    oks = sum(_dispatch_oks(dispatcher).values()) - oks0
    if not killed or sub.proc.returncode != -signal.SIGKILL \
            or oks != len(flat) or by["sub"] == 0 or errs == 0:
        raise AssertionError(f"SIGKILL step: killed {killed}, rc "
                             f"{sub.proc.returncode}, OKs {oks} of "
                             f"{len(flat)}, by node {by}")
    res["sigkill"] = {"by_node": by, "failed_attempts_retried": errs,
                      "rc": sub.proc.returncode,
                      "stale_record_left": "sub" in registry.read_all()}
    log(f"  subprocess node SIGKILLed after {len(flat) // 2} of {len(flat)} "
        f"answers: every request answered (by node {by}), {errs} failed "
        f"attempts retried onto b, each answer bitwise b's engine; its "
        f"record left behind: {res['sigkill']['stale_record_left']}")

    # rejoin with the same id: the new record overwrites the stale one
    sub2 = _NodeProcess(node_args)
    try:
        rec, cold2 = sub2.wait_registered(registry, "sub", 600)
        if rec["url"] == sub_url and rec["pid"] == sub.proc.pid:
            raise AssertionError("the rejoin did not replace the record")
        by2, _ = run("rejoin")
        if by2["sub"] == 0:
            raise AssertionError(f"the rejoined node answered nothing: "
                                 f"{by2}")
        sub2.proc.send_signal(signal.SIGTERM)
        rc = sub2.proc.wait(timeout=120)
        sub2._t.join(timeout=10)
    finally:
        sub2.stop()
    drain_line = [ln for ln in sub2.lines if "SIGTERM drain" in ln]
    if rc != 0 or not drain_line or "sub" in registry.read_all():
        raise AssertionError(f"SIGTERM: rc {rc}, {drain_line}, registry "
                             f"{sorted(registry.read_all())}: "
                             + " | ".join(sub2.lines[-20:]))
    res["rejoin"] = {"cold_start_s": cold2, "by_node": by2, "rc": rc,
                     "drain": drain_line[0]}
    log(f"  rejoined as 'sub' (new pid, {cold2:.2f}s to registered), "
        f"answered {by2}; SIGTERM: '{drain_line[0]}', exit {rc}, record "
        f"gone [{card}]")
    return res


# ---------------------------------------------------------------------------
# neighbors: the sharded f32/int8/IVF retrieval tier
# ---------------------------------------------------------------------------

NN = dict(vectors=1_000_000, dim=64, blobs=488, shard_rows=262144,
          clusters=256, nprobe=64, batch=64, k=10, k_ladder=(10, 40),
          seed=0)
NN_TIMED_BATCHES = 10           # 20 before PR 24
NN_RECALL_FLOOR = 0.95
# a swap against the float64 oracle is a near tie when the true gap is
# within this of |q|^2 + |c|^2: the f32 expanded form d^2 = |q|^2 - 2q.c +
# |c|^2 rounds at the scale of its terms (an ulp of 1152 is 1.2e-4), so a
# gap of 1e-5 of d^2 itself (3e-5 at d^2 = 2.9) is below its rounding
NN_NEAR_TIE = 1e-6
NN_TERM_TOL = 1e-5             # card vs CPU distances, of |q|^2 + |c|^2
NN_RESOURCES = os.path.join("tests", "resources", "retrieval")


def blob_corpus(n, dim, k_blobs, seed=0, spread=0.15):
    """The JAX package's ``benchmarks/neighbors.py`` corpus (a copy):
    seeded mixture-of-gaussians, the clustered geometry of embeddings."""
    import numpy as np
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k_blobs, dim)).astype(np.float32) * 3.0
    assign = rng.integers(k_blobs, size=n)
    pts = centers[assign] + \
        rng.normal(size=(n, dim)).astype(np.float32) * spread
    return pts.astype(np.float32)


def exact_oracle64(corpus, queries, k, block=65536):
    """Exact float64 top-k (distances, ids) by blocked full scan."""
    import numpy as np
    q = queries.astype(np.float64)
    q2 = np.sum(q * q, axis=1)[:, None]
    best_d = np.full((len(q), k), np.inf)
    best_i = np.full((len(q), k), -1, np.int64)
    for lo in range(0, len(corpus), block):
        c = corpus[lo:lo + block].astype(np.float64)
        d = q2 - 2.0 * (q @ c.T) + np.sum(c * c, axis=1)[None, :]
        part = np.argpartition(d, k, axis=1)[:, :k]
        dd = np.concatenate([best_d, np.take_along_axis(d, part, 1)], 1)
        ii = np.concatenate([best_i, part + lo], axis=1)
        order = np.lexsort((ii, dd), axis=1)[:, :k]
        best_d = np.take_along_axis(dd, order, axis=1)
        best_i = np.take_along_axis(ii, order, axis=1)
    return best_d, best_i


def _d64(corpus, queries, ids):
    import numpy as np
    rows = corpus[ids].astype(np.float64)              # [B, k, D]
    return ((rows - queries[:, None, :].astype(np.float64)) ** 2).sum(-1)


def _oracle_check(corpus, queries, ids, od, oi):
    """The f32 brute arm against the float64 oracle: ids equal, except at
    a swap of near ties. Returns (rows with ids equal, swaps, the largest
    gap of a swap relative to the distance, and relative to the expanded
    form's terms |q|^2 + |c|^2)."""
    import numpy as np
    gap = np.abs(_d64(corpus, queries, ids) - od)
    terms = np.sum(queries.astype(np.float64) ** 2, axis=1)[:, None] + \
        np.sum(corpus[ids].astype(np.float64) ** 2, axis=-1)
    swaps = ids != oi
    if not swaps.any():
        return int(len(ids)), 0, 0.0, 0.0
    return (int((~swaps).all(axis=1).sum()), int(swaps.sum()),
            float((gap / np.maximum(od, 1e-30))[swaps].max()),
            float((gap / terms)[swaps].max()))


def _recall(found, oracle):
    hits = sum(len(set(int(v) for v in f if v >= 0) & set(int(v) for v in o))
               for f, o in zip(found, oracle))
    return hits / float(oracle.size)


def _arm_bytes(engine, mode):
    """Corpus bytes the arm's search reads, resident on the device."""
    names = (("vectors", "c2", "ids", "row_scales") if mode == "brute" else
             ("centroids", "clustered", "c_scales", "c_c2", "c_ids"))
    return sum(t.numel() * t.element_size() for sh in engine._shards
               for t in (getattr(sh, n) for n in names) if t is not None)


def _nn_arm(engine, mode, queries, k):
    """qps, p50 and a bitwise repeat of one arm at batch len(queries)."""
    import numpy as np
    d, i = engine.search(queries, k, mode=mode)
    d2, i2 = engine.search(queries, k, mode=mode)
    repeat = d.tobytes() == d2.tobytes() and i.tobytes() == i2.tobytes()
    ms = []
    t0 = time.perf_counter()
    for _ in range(NN_TIMED_BATCHES):
        t1 = time.perf_counter()
        engine.search(queries, k, mode=mode)
        ms.append((time.perf_counter() - t1) * 1e3)
    wall = time.perf_counter() - t0
    return d, i, {"qps": NN_TIMED_BATCHES * len(queries) / wall,
                  "p50_ms": float(np.percentile(ms, 50)),
                  "p99_ms": float(np.percentile(ms, 99)),
                  "bitwise_repeat": repeat,
                  "resident_bytes": _arm_bytes(engine, mode)}


def phase_neighbors(report, card):
    """The 1M x 64 index in four arms, the port against its CPU answers
    on a JAX-saved index, and the cluster tier (module docstring, phase
    21)."""
    import tempfile

    import numpy as np
    from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
    from deeplearning4j_tpu_torch.parallel.aot_cache import ArtifactStore
    from deeplearning4j_tpu_torch.retrieval.engine import RetrievalEngine
    from deeplearning4j_tpu_torch.retrieval.index import ShardedCorpusIndex

    t_phase = time.perf_counter()
    out = {"card": card, "geometry": dict(NN), "seconds": {}, "arms": {}}
    t0 = time.perf_counter()
    corpus = blob_corpus(NN["vectors"], NN["dim"], NN["blobs"], NN["seed"])
    rng = np.random.default_rng(NN["seed"] + 1)
    queries = (corpus[rng.integers(len(corpus), size=NN["batch"])]
               + rng.normal(size=(NN["batch"], NN["dim"])).astype(
                   np.float32) * 0.05).astype(np.float32)
    od, oi = exact_oracle64(corpus, queries, NN["k"])
    out["seconds"]["corpus_and_oracle"] = time.perf_counter() - t0
    engines = {}
    for precision in ("f32", "int8"):
        t0 = time.perf_counter()
        index = ShardedCorpusIndex.build(
            corpus, shard_rows=NN["shard_rows"], precision=precision,
            ivf_clusters=NN["clusters"], nprobe_hint=NN["nprobe"],
            seed=NN["seed"], device="cuda")
        built = time.perf_counter() - t0
        eng = RetrievalEngine(index, k_ladder=NN["k_ladder"],
                              max_batch=NN["batch"], nprobe=NN["nprobe"],
                              registry=MetricsRegistry(),
                              session_id=f"nn-{precision}", device="cuda")
        eng.warmup()
        engines[precision] = eng
        out["seconds"][f"build_{precision}"] = built
        out["seconds"][f"warmup_{precision}"] = eng.warmup_seconds
        log(f"  {precision} index: {len(index.shards)} shards of "
            f"{NN['shard_rows']}, IVF {NN['clusters']} clusters (cap "
            f"{index.ivf['cap']}); built in {built:.1f}s, warmup "
            f"{eng.warmup_seconds:.2f}s over {len(eng._cells)} cells, "
            f"{eng.resident_bytes / 2**20:.1f} MiB on the card")
    for precision, mode in (("f32", "brute"), ("int8", "brute"),
                            ("f32", "ivf"), ("int8", "ivf")):
        eng = engines[precision]
        d, i, arm = _nn_arm(eng, mode, queries, NN["k"])
        arm["recall_at_10"] = _recall(i, oi)
        if precision == "f32" and mode == "brute":
            same, swaps, gap_d, gap = _oracle_check(corpus, queries, i, od,
                                                    oi)
            arm.update(rows_equal_oracle=same, swaps=swaps,
                       largest_swap_gap_of_d2=gap_d,
                       largest_swap_gap_of_terms=gap)
            if gap > NN_NEAR_TIE:
                raise AssertionError(
                    f"f32 brute: {swaps} ids differ from the float64 "
                    f"oracle, one by a gap of {gap:.3g} of |q|^2 + |c|^2 "
                    f"(> {NN_NEAR_TIE})")
        elif arm["recall_at_10"] < NN_RECALL_FLOOR:
            raise AssertionError(f"{precision} {mode}: recall@10 "
                                 f"{arm['recall_at_10']:.4f} < "
                                 f"{NN_RECALL_FLOOR}")
        if not arm["bitwise_repeat"]:
            raise AssertionError(f"{precision} {mode}: a repeat differs")
        out["arms"][f"{mode}-{precision}"] = arm
        log(f"  {mode}-{precision}: recall@10 {arm['recall_at_10']:.4f}"
            + (f" (ids equal the float64 oracle in {arm['rows_equal_oracle']}"
               f" of {NN['batch']} rows, {arm['swaps']} near-tie swaps, "
               f"largest gap {arm['largest_swap_gap_of_d2']:.2g} of d^2, "
               f"{arm['largest_swap_gap_of_terms']:.2g} of |q|^2 + |c|^2)"
               if "swaps" in arm else "")
            + f", repeat bitwise; {arm['qps']:.0f} queries/s at batch "
            f"{NN['batch']}, p50 {arm['p50_ms']:.3f} ms, p99 "
            f"{arm['p99_ms']:.3f} ms; {arm['resident_bytes'] / 2**20:.1f} "
            f"MiB resident [{card}]")
    for eng in engines.values():
        eng.assert_warm()
    log(f"  live compiles after warmup: "
        f"{ {p: e.recompiles_after_warmup for p, e in engines.items()} }")

    out["reference"] = _nn_reference(card)
    tmp = tempfile.TemporaryDirectory(prefix="neighbors_")
    try:
        t0 = time.perf_counter()
        store = ArtifactStore(os.path.join(tmp.name, "store"))
        ShardedCorpusIndex.build(
            corpus, shard_rows=NN["shard_rows"], precision="f32",
            seed=NN["seed"]).save(store, "nn")
        out["seconds"]["save"] = time.perf_counter() - t0
        del engines
        out["cluster"] = _nn_cluster(card, store, tmp.name, queries)
    finally:
        tmp.cleanup()
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    log(f"  neighbors phase seconds "
        f"{ {k: round(v, 1) for k, v in out['seconds'].items()} }")
    report["neighbors"] = out


def _nn_close(got, want, q, c2):
    """Distances within NN_TERM_TOL of the expanded form's terms |q|^2 +
    |c|^2 (the form cancels for near neighbours, so two summation orders
    differ by an ulp of the terms, not of d^2)."""
    import numpy as np
    q2 = np.sum(q.astype(np.float64) ** 2, axis=1, keepdims=True)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    return float((err / (q2 + np.abs(c2))).max())


def _nn_reference(card):
    """The committed JAX-saved small index (tools/retrieval_resources.py):
    the card's answers against the port's CPU answers, every arm."""
    import numpy as np
    from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
    from deeplearning4j_tpu_torch.parallel.aot_cache import ArtifactStore
    from deeplearning4j_tpu_torch.retrieval.engine import RetrievalEngine
    from deeplearning4j_tpu_torch.retrieval.index import ShardedCorpusIndex
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        NN_RESOURCES)
    store = ArtifactStore(root)
    q = np.load(os.path.join(root, "queries.npy"))
    res = {}
    for precision in ("f32", "int8"):
        key = f"small-{precision}"
        eng = {dev: RetrievalEngine(
            ShardedCorpusIndex.load(store, key), k_ladder=(10, 40),
            max_batch=16, registry=MetricsRegistry(),
            device=dev).warmup() for dev in ("cuda", "cpu")}
        norms = np.concatenate([
            np.sum(s.astype(np.float64) ** 2, axis=1)
            for s in _refine_or_rows(store, key)])
        for mode in ("brute", "ivf"):
            dc, ic = eng["cuda"].search(q, 10, mode=mode)
            dp, ip = eng["cpu"].search(q, 10, mode=mode)
            err = _nn_close(dc, dp, q, norms[ip])
            res[f"{mode}-{precision}"] = {
                "ids_equal": bool(np.array_equal(ic, ip)),
                "distance_err_of_terms": err}
            if not np.array_equal(ic, ip) or err > NN_TERM_TOL:
                raise AssertionError(
                    f"{mode}-{precision} on the JAX-saved index: the card's "
                    f"ids differ from the CPU's or distances by {err:.3g} "
                    f"of |q|^2 + |c|^2 (> {NN_TERM_TOL})")
        for e in eng.values():
            e.assert_warm()
    log(f"  JAX-saved {NN_RESOURCES} index, 16 queries x 10: the card's ids "
        f"equal the port's CPU ids in every arm, distances within "
        f"{max(r['distance_err_of_terms'] for r in res.values()):.3g} of "
        f"|q|^2 + |c|^2 [{card}]")
    return res


def _refine_or_rows(store, key):
    """The f32 source rows of each shard of a saved index, in id order."""
    from deeplearning4j_tpu_torch.retrieval.index import ShardedCorpusIndex
    idx = ShardedCorpusIndex.load(store, key)
    return [(s.refine if s.refine is not None else s.vectors[:s.n])
            for s in idx.shards]


def _nn_cluster(card, store, tmp, queries):
    """Two in-process RetrievalNodes owning shards {0,1} and {2,3}, a
    NeighborsDispatcher against the single engine, a node down, and one
    ``serve --neighbors-index --join`` subprocess SIGTERM-drained."""
    import signal

    import numpy as np
    from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
    from deeplearning4j_tpu_torch.parallel.node import NodeRegistry
    from deeplearning4j_tpu_torch.retrieval.cluster import (
        NeighborsDispatcher, RetrievalNode)
    from deeplearning4j_tpu_torch.retrieval.engine import RetrievalEngine
    from deeplearning4j_tpu_torch.retrieval.index import ShardedCorpusIndex

    res = {}
    reg_dir = os.path.join(tmp, "registry")
    registry = NodeRegistry(reg_dir)
    k = NN["k"]

    def engine(shards=None):
        return RetrievalEngine(
            ShardedCorpusIndex.load(store, "nn", shard_ids=shards),
            k_ladder=(k,), max_batch=NN["batch"],
            registry=MetricsRegistry(), device="cuda")
    t0 = time.perf_counter()
    single = engine().warmup()
    ids = single.shard_ids                      # {0, 1} and {2, 3} at 1M
    halves = (ids[:len(ids) // 2], ids[len(ids) // 2:])
    nodes = [RetrievalNode(engine(s), node_id=f"nn{j}", registry=registry,
                           metrics_registry=MetricsRegistry(),
                           device="cuda")
             for j, s in enumerate(halves)]
    disp = NeighborsDispatcher(registry, timeout_s=120.0,
                               metrics=MetricsRegistry())
    try:
        res["setup_s"] = time.perf_counter() - t0
        full = disp.search(queries, k)
        sd, si = single.search(queries, k)
        bitwise = full["ids"].tobytes() == si.tobytes() and \
            full["distances"].tobytes() == sd.tobytes()
        if full["partial"] or not bitwise:
            raise AssertionError(f"the dispatcher's merged answer: partial "
                                 f"{full['partial']}, bitwise the single "
                                 f"engine {bitwise}")
        ms = []
        for _ in range(5):
            t1 = time.perf_counter()
            disp.search(queries, k)
            ms.append((time.perf_counter() - t1) * 1e3)
        nodes[1].shutdown()
        part = disp.search(queries, k)
        if not part["partial"] or part["shards_answered"] != len(halves[0]) \
                or part["shards_total"] != len(ids):
            raise AssertionError(f"with node nn1 down: {part['partial']}, "
                                 f"{part['shards_answered']} of "
                                 f"{part['shards_total']}")
        res.update(merged_bitwise_single=bitwise,
                   fanout_p50_ms=float(np.percentile(ms, 50)),
                   partial={k2: part[k2] for k2 in
                            ("partial", "shards_answered", "shards_total")})
        log(f"  NeighborsDispatcher over nn0 {halves[0]} + nn1 {halves[1]}: "
            f"merged "
            f"answer bitwise the single engine's, fan-out p50 "
            f"{res['fanout_p50_ms']:.2f} ms for {NN['batch']} queries over "
            f"HTTP; nn1 down: partial {part['partial']}, "
            f"{part['shards_answered']} of {part['shards_total']} shards "
            f"[{card}]")
    finally:
        disp.shutdown()
        for n in nodes:
            n.shutdown()
        del single

    # the entry point as a node: load shard 0, serve, SIGTERM drain
    sub = _NodeProcess(["--neighbors-index", "nn", "--artifact-store",
                        store.root.as_posix(), "--neighbors-shards", "0",
                        "--neighbors-k-ladder", str(k), "--ui-port", "0",
                        "--join", reg_dir, "--node-id", "nnsub"])
    try:
        rec, cold = sub.wait_registered(registry, "nnsub", 600)
        code, _, body = _http(rec["url"] + "/api/neighbors",
                              {"queries": queries[:4].tolist(), "k": k})
        if code != 200 or rec["stats"]["shards"] != [0]:
            raise AssertionError(f"the subprocess node answered {code}, "
                                 f"gossips {rec['stats']}")
        sub.proc.send_signal(signal.SIGTERM)
        rc = sub.proc.wait(timeout=120)
        sub._t.join(timeout=10)
    finally:
        sub.stop()
    drain = [ln for ln in sub.lines if "SIGTERM drain" in ln]
    if rc != 0 or not drain or "nnsub" in registry.read_all():
        raise AssertionError(f"neighbors node SIGTERM: rc {rc}, {drain}: "
                             + " | ".join(sub.lines[-20:]))
    res["subprocess"] = {"spawn_to_registered_s": cold, "rc": rc,
                         "drain": drain[0]}
    log(f"  serve --neighbors-index --join (shard 0): registered "
        f"{cold:.2f}s after spawn, answered /api/neighbors, SIGTERM "
        f"'{drain[0]}', exit {rc}, record gone [{card}]")
    return res


EMB = dict(vocab=100_000, tokens=3_000_000, sentence=40, zipf=1.05,
           corpus_seed=0, layer=128, window=5, negative=5, batch=65536,
           seed=3, serial_tokens=100_000,
           topics=20, topic_words=50, topic_tokens=200_000, topic_epochs=3,
           pv_docs=5_000, pv_len=100, pv_vocab=50_000,
           label_topics=10, label_docs=2000, label_len=50, label_held=200,
           label_epochs=5, glove_tokens=200_000, glove_epochs=5,
           graph_side=2000, graph_degree=10, graph_cross=0.01, walk=40)
EMB_PARITY_TOL = 1e-5     # card vs CPU after a superchunk, of each table's largest
# the HS arm holds the first EMB_HS_PARITY_CHUNKS chunk steps of its first
# superchunk (of 8) against the CPU: the CPU's side of a whole HS
# superchunk took most of the phase; the other host-pair arms hold the
# whole superchunk
EMB_HS_PARITY_CHUNKS = 2
EMB_PREDICT_MARGIN = 0.3  # held-out predict accuracy over chance (1 / labels)
EMB_ARMS = {"sgns": {}, "hs": {"use_hierarchic_softmax": True},
            "cbow": {"use_cbow": True},
            "sgns_device_pairs": {"device_pair_generation": True}}


def zipf_sentences(v, n, length, a, seed):
    """``n`` tokens drawn zipf(``a``) over ``v`` words from
    ``default_rng(seed)``, in sentences of ``length`` (the JAX package's
    benchmarks/baseline_suite.py corpus)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    freq = 1.0 / np.arange(1, v + 1) ** a
    freq /= freq.sum()
    words = np.char.add("w", rng.choice(v, size=n, p=freq).astype("U7"))
    return [words[i:i + length].tolist() for i in range(0, n, length)]


def topic_sentences(topics, per_topic, tokens, length, seed):
    """Planted topics: each sentence draws its words from one topic's
    ``per_topic`` words. Returns (sentences, topic of each sentence)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n = tokens // length
    topic = rng.integers(0, topics, n)
    ids = topic[:, None] * per_topic + rng.integers(0, per_topic,
                                                    (n, length))
    return [[f"t{i}" for i in row] for row in ids], topic


def topic_cosines(model, topics, per_topic):
    """(mean in-topic cosine, mean cross-topic cosine) over every pair of
    the planted words."""
    import numpy as np
    mat = model.word_vectors_matrix
    rows = [model.vocab.index_of(f"t{i}") for i in range(topics * per_topic)]
    v = mat[rows].astype(np.float64)
    v /= np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
    cos = v @ v.T
    t = np.arange(topics * per_topic) // per_topic
    same = (t[:, None] == t[None, :]) & ~np.eye(len(t), dtype=bool)
    cross = t[:, None] != t[None, :]
    return float(cos[same].mean()), float(cos[cross].mean())


def _rel_err(got, ref):
    import numpy as np
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def _count_ops(fn):
    """Torch operators one call of ``fn`` dispatches (its host's work; on
    the card one launch or more each)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return Count.n


def _no_sync(fn):
    """``fn()`` with every synchronizing CUDA call an error."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def w2v_model(kw, device, **extra):
    from deeplearning4j_tpu_torch.nlp.word2vec import Word2Vec
    return Word2Vec(**{**dict(layer_size=EMB["layer"],
                              window_size=EMB["window"],
                              negative=EMB["negative"], min_word_frequency=1,
                              epochs=1, batch_size=EMB["batch"],
                              seed=EMB["seed"], pairgen="auto"),
                       **kw, **extra}, device=device)


def _recorder(store):
    """Wrap a callable to keep its first call's arguments."""
    def wrap(fn):
        def call(*args, **kwargs):
            if not store:
                store.append((args, kwargs))
            return fn(*args, **kwargs)
        return call
    return wrap


def _emb_arm(card, name, kw, seqs, n_tokens):
    """One Word2Vec arm at the full geometry: the timed fit, then its
    first superchunk card against CPU, twice on the card and once with
    every sync an error, its ops, busy share and memory."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.nlp import skipgram as sk
    from deeplearning4j_tpu_torch.nlp.sequence_vectors import host_array

    arm = {"kw": kw, "seconds": {}}
    t0 = time.perf_counter()
    m = w2v_model(kw, "cuda")
    m.build_vocab(seqs)
    m._init_tables()
    snap = (host_array(m.syn0), host_array(m.syn1))
    arm["seconds"]["vocab"] = time.perf_counter() - t0
    first = []
    device_pairs = kw.get("device_pair_generation", False)
    if device_pairs:
        orig = sk.skipgram_token_update
        sk.skipgram_token_update = _recorder(first)(orig)
    else:
        m._dispatch_chunks = _recorder(first)(m._dispatch_chunks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        m.fit(seqs)
        float(m.syn0[0, 0])          # drain the card inside the timer
        wall = time.perf_counter() - t0
    finally:
        if device_pairs:
            sk.skipgram_token_update = orig
        else:
            del m._dispatch_chunks
    arm["seconds"]["fit"] = wall
    arm["tokens_per_s"] = n_tokens / wall
    arm["peak_mib"] = torch.cuda.max_memory_allocated() / 2**20
    if not np.isfinite(host_array(m.syn0)).all():
        raise AssertionError(f"{name}: non-finite syn0 after the fit")
    (args, kwargs), = first

    if device_pairs:
        tokens, lengths, b, negs, lr = args[2:7]

        def superchunk(model):
            dev = model.syn0.device
            sk.skipgram_token_update(
                model.syn0, model.syn1, tokens.to(dev), lengths.to(dev),
                b.to(dev), negs.to(dev), lr, **kwargs)
        chunks, cut = 1, None
        parity = superchunk
    else:
        prep = args[0]

        def superchunk(model):
            model._dispatch_chunks(prep)
        # every array of a prep has the chunk steps on its first axis
        cut = EMB_HS_PARITY_CHUNKS if m.use_hs else None
        head = prep if cut is None else (prep[0],) + tuple(
            a[:cut] for a in prep[1:])

        def parity(model):
            model._dispatch_chunks(head)
        # a prep's lrs (last, or before the shared negatives) are > 0
        # exactly in its filled chunks
        chunks = int(np.count_nonzero(prep[-2] if prep[0] == "shared"
                                      else prep[-1]))

    def run_on(model):
        model.set_tables(*snap)
        parity(model)
        return host_array(model.syn0), host_array(model.syn1)

    t0 = time.perf_counter()
    card_a = run_on(m)
    card_b = run_on(m)
    cpu = w2v_model(kw, "cpu")
    cpu.vocab, cpu._table = m.vocab, m._table
    if m.use_hs:
        cpu._ensure_hs_matrices()
    cpu_t = run_on(cpu)
    arm["seconds"]["parity"] = time.perf_counter() - t0
    arm["parity_err"] = [_rel_err(a, r) for a, r in zip(card_a, cpu_t)]
    arm["bitwise_repeat"] = all(np.array_equal(a, r)
                                for a, r in zip(card_a, card_b))
    if max(arm["parity_err"]) > EMB_PARITY_TOL:
        raise AssertionError(f"{name}: card vs CPU after the parity "
                             f"chunks {arm['parity_err']} > "
                             f"{EMB_PARITY_TOL}")
    if not arm["bitwise_repeat"]:
        raise AssertionError(f"{name}: the parity chunks differ between "
                             "two runs on the card")
    m.set_tables(*snap)
    _no_sync(lambda: superchunk(m))
    arm["no_sync"] = True
    arm["ops_per_chunk"] = _count_ops(lambda: superchunk(m)) / chunks
    prof = profile_calls(lambda: superchunk(m), card,
                         f"{name} superchunks", n=3, warmup=1)
    arm["busy"] = prof["device_ms"] / prof["wall_ms"]
    arm["superchunk_ms"] = prof["wall_ms"]
    arm["chunks"] = chunks
    held = ("flush" if device_pairs else "superchunk" if cut is None
            else f"{cut} chunk steps")
    arm["parity_held"] = held
    log(f"  {name}: {arm['tokens_per_s']:.0f} tokens/s ({n_tokens} tokens "
        f"in {wall:.2f}s, vocab {arm['seconds']['vocab']:.1f}s), peak "
        f"{arm['peak_mib']:.0f} MiB; its first {held} "
        f"card vs CPU {max(arm['parity_err']):.2e} of the largest entry, "
        f"repeat "
        f"bitwise, no sync; {arm['ops_per_chunk']:.0f} torch ops a chunk, "
        f"{prof['wall_ms']:.1f} ms a superchunk, busy "
        f"{100 * arm['busy']:.1f}% [{card}]")
    return arm, m


def _emb_serial(name, kw, seqs):
    """The overlapped producer against the serial loop: bitwise tables."""
    import numpy as np
    from deeplearning4j_tpu_torch.nlp.sequence_vectors import host_array
    tables = []
    for overlap in (True, False):
        m = w2v_model(kw, "cuda", overlap_pairgen=overlap)
        m.fit(seqs)
        tables.append((host_array(m.syn0), host_array(m.syn1)))
    same = all(np.array_equal(a, b) for a, b in zip(*tables))
    if not same:
        raise AssertionError(f"{name}: the overlapped producer's tables "
                             "differ from the serial loop's")
    return same


def _emb_topics(out, card):
    """The quality gate on planted topics, and save/restore."""
    import tempfile

    import numpy as np
    from deeplearning4j_tpu_torch.nlp import serializer
    from deeplearning4j_tpu_torch.nlp.sequence_vectors import host_array
    seqs, _ = topic_sentences(EMB["topics"], EMB["topic_words"],
                              EMB["topic_tokens"], EMB["sentence"], 1)
    out["topics"] = {}
    sgns = None
    for name, kw in (("sgns", {}), ("hs", {"use_hierarchic_softmax": True}),
                     ("cbow", {"use_cbow": True})):
        m = w2v_model(kw, "cuda", epochs=EMB["topic_epochs"],
                      batch_size=512)
        m.fit(seqs)
        inside, cross = topic_cosines(m, EMB["topics"], EMB["topic_words"])
        out["topics"][name] = {"in_topic": inside, "cross_topic": cross}
        log(f"  planted topics {name}: mean cosine in-topic {inside:.4f}, "
            f"cross-topic {cross:.4f}")
        if not inside > cross:
            raise AssertionError(f"{name}: in-topic cosine {inside:.4f} "
                                 f"not above cross-topic {cross:.4f}")
        sgns = sgns or m
    with tempfile.TemporaryDirectory(prefix="w2v_") as tmp:
        path = os.path.join(tmp, "w2v.npz")
        serializer.write_full_model(sgns, path)
        back = serializer.read_full_model(path, device="cuda")
        same = (np.array_equal(host_array(back.syn0), host_array(sgns.syn0))
                and np.array_equal(host_array(back.syn1),
                                   host_array(sgns.syn1))
                and back.vocab.words() == sgns.vocab.words())
    if not same:
        raise AssertionError("write_full_model/read_full_model changed "
                             "the card-trained vectors")
    out["save_restore_equal"] = True
    log("  write_full_model -> read_full_model on the card: vectors equal")


def _emb_paragraphs(out, card):
    """ParagraphVectors at the suite's geometry (DBOW and DM), then
    infer_vector + predict on labelled planted topics."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.nlp.paragraph_vectors import \
        ParagraphVectors
    from deeplearning4j_tpu_torch.nlp.sentence_iterators import \
        LabelledDocument
    n_tok = EMB["pv_docs"] * EMB["pv_len"]
    words = zipf_sentences(EMB["pv_vocab"], n_tok, EMB["pv_len"],
                           EMB["zipf"], EMB["corpus_seed"])
    docs = [LabelledDocument(" ".join(w), [f"DOC_{i}"])
            for i, w in enumerate(words)]
    out["pv"] = {}
    for dm in (False, True):
        pv = ParagraphVectors(dm=dm, layer_size=EMB["layer"],
                              window_size=EMB["window"],
                              negative=EMB["negative"], min_word_frequency=1,
                              epochs=1, batch_size=EMB["batch"],
                              seed=EMB["seed"], device="cuda")
        t0 = time.perf_counter()
        pv.fit(docs)
        float(pv.syn0[0, 0])
        wall = time.perf_counter() - t0
        if not torch.isfinite(pv.syn0).all():
            raise AssertionError(f"ParagraphVectors dm={dm}: non-finite")
        key = "dm" if dm else "dbow"
        out["pv"][key] = {"tokens_per_s": n_tok / wall, "seconds": wall}
        log(f"  ParagraphVectors {key}: {n_tok / wall:.0f} tokens/s "
            f"({EMB['pv_docs']} docs x {EMB['pv_len']}, vocab "
            f"{pv.vocab.num_words()}, {wall:.2f}s) [{card}]")
    seqs, topic = topic_sentences(EMB["label_topics"], EMB["topic_words"],
                                  EMB["label_docs"] * EMB["label_len"],
                                  EMB["label_len"], 2)
    held = EMB["label_held"]
    train = [LabelledDocument(" ".join(s), [f"T{t}"])
             for s, t in zip(seqs[held:], topic[held:])]
    pv = ParagraphVectors(layer_size=EMB["layer"], window_size=EMB["window"],
                          negative=EMB["negative"], epochs=EMB["label_epochs"],
                          seed=EMB["seed"], device="cuda")
    pv.fit(train)
    hits = sum(pv.predict(" ".join(s)) == f"T{t}"
               for s, t in zip(seqs[:held], topic[:held]))
    acc, chance = hits / held, 1.0 / EMB["label_topics"]
    out["pv"]["predict"] = {"accuracy": acc, "chance": chance,
                            "margin": acc - chance}
    log(f"  ParagraphVectors predict on {held} held documents of "
        f"{EMB['label_topics']} planted topics: accuracy {acc:.3f}, chance "
        f"{chance:.3f}, margin {acc - chance:.3f} (gate "
        f"{EMB_PREDICT_MARGIN})")
    if acc - chance < EMB_PREDICT_MARGIN:
        raise AssertionError(f"ParagraphVectors predict accuracy {acc:.3f} "
                             f"does not beat chance {chance:.3f} by "
                             f"{EMB_PREDICT_MARGIN}")


def _emb_glove(out, card, seqs):
    """GloVe on the corpus's first tokens: the loss falls; one step
    repeats bitwise on the card."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.nlp import glove as gl
    n = EMB["glove_tokens"] // EMB["sentence"]
    g = gl.Glove(layer_size=EMB["layer"], window_size=EMB["window"],
                 epochs=EMB["glove_epochs"], batch_size=EMB["batch"],
                 seed=EMB["seed"], device="cuda")
    t0 = time.perf_counter()
    g.fit(seqs[:n])
    wall = time.perf_counter() - t0
    losses = g.epoch_losses
    falls = all(b < a for a, b in zip(losses, losses[1:]))
    rng = np.random.default_rng(5)
    v = g.vocab.num_words()
    freq = 1.0 / np.arange(1, v + 1) ** EMB["zipf"]
    rows, cols = (torch.from_numpy(rng.choice(v, EMB["batch"],
                                              p=freq / freq.sum())).cuda()
                  for _ in range(2))
    logx = torch.from_numpy(rng.random(EMB["batch"]).astype(np.float32)
                            ).cuda()
    weight = torch.rand(EMB["batch"], device="cuda",
                        generator=torch.Generator("cuda").manual_seed(1))

    def state():
        gen = torch.Generator("cuda").manual_seed(2)
        w = [torch.rand((v, EMB["layer"]), device="cuda", generator=gen)
             for _ in range(2)]
        b = [torch.rand(v, device="cuda", generator=gen) for _ in range(2)]
        return w + b + [torch.full_like(x, 1e-8) for x in w + b]

    runs = []
    for _ in range(2):
        s = state()
        loss = gl._glove_step(*s, rows, cols, logx, weight, 0.05)
        runs.append([x.cpu() for x in s] + [loss.cpu()])
    repeat = all(torch.equal(a, b) for a, b in zip(*runs))
    out["glove"] = {"epoch_losses": losses, "loss_falls": falls,
                    "step_bitwise_repeat": repeat, "seconds": wall,
                    "tokens_per_s": n * EMB["sentence"] * len(losses) / wall}
    log(f"  GloVe on {n * EMB['sentence']} tokens (vocab {v}): epoch losses "
        f"{[round(x, 5) for x in losses]}, {wall:.2f}s for "
        f"{len(losses)} epochs; one step at batch {EMB['batch']} bitwise "
        f"on a repeat: {repeat} [{card}]")
    if not falls:
        raise AssertionError(f"GloVe loss does not fall: {losses}")
    if not repeat:
        raise AssertionError("a GloVe step differs between two runs")


def two_communities(side, degree, cross, seed):
    """Two communities of ``side`` vertices: each vertex links to
    ``degree // 2`` random vertices of its own side, and with probability
    ``cross`` to one of the other side."""
    import numpy as np
    from deeplearning4j_tpu_torch.graph import Graph
    rng = np.random.default_rng(seed)
    g = Graph(2 * side)
    for v in range(2 * side):
        base = (v // side) * side
        for u in rng.integers(0, side, degree // 2):
            if base + u != v:
                g.add_edge(v, int(base + u))
        if rng.random() < cross:
            g.add_edge(v, int((side - base) + rng.integers(0, side)))
    return g


def _emb_graph(out, card):
    import numpy as np
    from deeplearning4j_tpu_torch.graph import DeepWalk, Node2Vec
    side = EMB["graph_side"]
    g = two_communities(side, EMB["graph_degree"], EMB["graph_cross"], 4)
    rng = np.random.default_rng(6)
    a = rng.integers(0, 2 * side, 4000)
    b = rng.integers(0, 2 * side, 4000)
    same = (a // side) == (b // side)
    out["graph"] = {}
    for cls, kw in ((DeepWalk, {}), (Node2Vec, {"p": 1.0, "q": 0.5})):
        t0 = time.perf_counter()
        m = cls(vector_size=EMB["layer"], window_size=EMB["window"],
                walk_length=EMB["walk"], seed=EMB["seed"], device="cuda",
                **kw)
        m.fit(g)
        wall = time.perf_counter() - t0
        mat = m.word_vectors_matrix.astype(np.float64)
        rows = np.array([m.vocab.index_of(str(v)) for v in range(2 * side)])
        u = mat[rows] / np.maximum(np.linalg.norm(mat[rows], axis=1,
                                                  keepdims=True), 1e-12)
        cos = np.einsum("id,id->i", u[a], u[b])
        inside, across = float(cos[same].mean()), float(cos[~same].mean())
        out["graph"][cls.__name__] = {"within": inside, "across": across,
                                      "seconds": wall}
        log(f"  {cls.__name__} on two communities of {side} (walks of "
            f"{EMB['walk']}): mean similarity within {inside:.4f}, across "
            f"{across:.4f}, {wall:.1f}s [{card}]")
        if not inside > across:
            raise AssertionError(f"{cls.__name__}: within {inside:.4f} not "
                                 f"above across {across:.4f}")


def phase_embeddings(report, card):
    """The NLP and graph embedding tier (module docstring, phase 22)."""
    import torch
    from deeplearning4j_tpu_torch.utils import native

    t_phase = time.perf_counter()
    out = {"card": card, "geometry": dict(EMB), "seconds": {}, "arms": {}}
    t0 = time.perf_counter()
    if not native.pairgen_available():
        raise AssertionError("the native pair generator did not build: "
                             "the card would be measured on the numpy "
                             "producer")
    out["seconds"]["native_build"] = time.perf_counter() - t0
    log(f"  native pair generator: {native.library_path()} "
        f"({out['seconds']['native_build']:.1f}s)")
    t0 = time.perf_counter()
    seqs = zipf_sentences(EMB["vocab"], EMB["tokens"], EMB["sentence"],
                          EMB["zipf"], EMB["corpus_seed"])
    out["seconds"]["corpus"] = time.perf_counter() - t0
    prefix = seqs[:EMB["serial_tokens"] // EMB["sentence"]]
    for name, kw in EMB_ARMS.items():
        t0 = time.perf_counter()
        arm, _m = _emb_arm(card, name, kw, seqs, EMB["tokens"])
        if not kw.get("device_pair_generation"):
            arm["overlap_equals_serial"] = _emb_serial(name, kw, prefix)
            log(f"  {name}: the overlapped producer equals the serial loop "
                f"bitwise on the first {EMB['serial_tokens']} tokens")
        out["arms"][name] = arm
        out["seconds"][name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    for step, fn in (("topics", lambda: _emb_topics(out, card)),
                     ("paragraph_vectors",
                      lambda: _emb_paragraphs(out, card)),
                     ("glove", lambda: _emb_glove(out, card, seqs)),
                     ("graph", lambda: _emb_graph(out, card))):
        t0 = time.perf_counter()
        fn()
        out["seconds"][step] = time.perf_counter() - t0
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    log(f"  embeddings phase seconds "
        f"{ {k: round(v, 1) for k, v in out['seconds'].items()} }")
    report["embeddings"] = out


# ---- phase 23: online learning ------------------------------------------

ONLINE_BATCH = 32             # the learner's micro-batch, the engine's limit
ONLINE_MIN_STEPS = 20         # learner steps before the promotion gates
ONLINE_CLASSES = 10           # labels used out of the 200: a prior to learn
ONLINE_SEED = 23
ONLINE_HOLDOUT_EVERY = 4
ONLINE_HOLDOUT_MAX = 128
ONLINE_SERVE_TOL = 5e-3       # the slice phase's padded-vs-direct bound
ONLINE_DEGRADE = 25.0         # the degraded candidate's output W scale
ONLINE_DEADLINE_S = 120.0
ONLINE_CLI_TOPIC = "train-cli"
CONV_FIT_STEPS = 4


def online_labels(seed=ONLINE_SEED):
    """Labels as a fixed function of the pixels (from ``seed``): the
    argmax of a random projection of the 4 x 4 grid of channel means,
    over ONLINE_CLASSES of the 200 classes, so a holdout loss can fall."""
    import numpy as np
    proj = np.random.default_rng(seed).normal(
        size=(4 * 4 * SLICE["channels"], ONLINE_CLASSES))
    h, w, c = _image_shape()

    def label(x):
        n = len(x)
        pooled = x.reshape(n, 4, h // 4, 4, w // 4, c).mean((2, 4))
        cls = np.argmax(pooled.reshape(n, -1) @ proj, 1)
        return np.eye(SLICE["num_classes"], dtype=np.float32)[cls]
    return label


class _Publisher:
    """A thread publishing labelled slice-model batches: to ``topic``
    while fewer than 6 wait unconsumed in ``stream``, and to
    ``cli_topic`` at most every 0.2 s."""

    def __init__(self, transport, topic, stream, cli_topic):
        import numpy as np
        from deeplearning4j_tpu_torch.online import publish_samples
        self.published = 0
        self._stop = threading.Event()
        label, rng = online_labels(), np.random.default_rng(ONLINE_SEED)

        def run():
            t_cli = 0.0
            while not self._stop.is_set():
                x = _pixels(rng, ONLINE_BATCH)
                if self.published - stream.batches_consumed < 6:
                    publish_samples(transport, topic, x, label(x))
                    self.published += 1
                if time.perf_counter() - t_cli > 0.2:
                    publish_samples(transport, cli_topic, x, label(x))
                    t_cli = time.perf_counter()
                self._stop.wait(0.005)
        self._t = threading.Thread(target=run, daemon=True,
                                   name="online-publisher")
        self._t.start()

    def stop(self):
        self._stop.set()
        self._t.join(10)


def _by_thread(fc):
    """Wrap ``fc._count`` so each launch is also tallied by the kind of
    thread that made it: the learner (its forward), autograd's device
    thread (the backward of a step: PyTorch runs a CUDA backward on a
    worker thread of its own, and only the learner runs one here), the
    serving dispatcher, the scorer on this thread; the global counters
    are unchanged. Returns (tallies, restore)."""
    import collections
    real = fc._count
    tallies = {"learner": collections.Counter(),
               "learner_backward": collections.Counter(),
               "serving": collections.Counter(),
               "scoring": collections.Counter()}
    main = threading.current_thread()

    def counted(name):
        real(name)
        t = threading.current_thread()
        if t.name == "online-learner":
            tallies["learner"][name] += 1
        elif t.name.startswith("serving-dispatch"):
            tallies["serving"][name] += 1
        elif t is main:
            tallies["scoring"][name] += 1
        else:
            tallies["learner_backward"][name] += 1
    fc._count = counted

    def restore():
        fc._count = real
    return tallies, restore


def _trees_bitwise(a, b):
    import torch
    from deeplearning4j_tpu_torch.models.serialization import flatten_paths
    fa, fb = flatten_paths(a), flatten_paths(b)
    return set(fa) == set(fb) and all(
        torch.equal(fa[k].cpu(), torch.as_tensor(fb[k]).cpu()) for k in fa)


def _online_cli(zip_path, port):
    """``serve --online`` on the model's zip, fed from ``port``."""
    return _ServeProcess(
        ["--model", zip_path, "--warmup-shape", *map(str, _image_shape()),
         "--batch-limit", str(ONLINE_BATCH), "--ui-port", "0", "--online",
         "--stream-endpoint", f"127.0.0.1:{port}", "--stream-topic",
         ONLINE_CLI_TOPIC, "--holdout-every", str(ONLINE_HOLDOUT_EVERY),
         "--holdout-max", str(ONLINE_HOLDOUT_MAX),
         "--promote-interval-s", "3600"], last="online:")


def _online_cli_gates(cli, out):
    """Gate 4: the subprocess answers predict, stats, promote and
    rollback; its learner is alive, its iterations rise, the promotion
    is counted."""
    import numpy as np
    url = cli.wait_ready(ONLINE_DEADLINE_S)
    x = _pixels(np.random.default_rng(5), 2)
    code, ans, n, _ = _predict(url, x)
    if code != 200 or ans.shape != (2, SLICE["num_classes"]) or n != 2:
        raise AssertionError(f"serve --online predict answered {code}")
    first, deadline = None, time.perf_counter() + ONLINE_DEADLINE_S
    while True:
        code, _, st = _http(url + "/api/online/stats")
        it = st["learner"]["iterations"]
        if code != 200 or not st["learner"]["alive"]:
            raise AssertionError(f"serve --online's learner is not alive: "
                                 f"{st}")
        first = it if first is None else first
        if it > first and st["stream"]["holdout_examples"] > 0:
            break
        if time.perf_counter() > deadline:
            raise AssertionError(f"serve --online's learner does not "
                                 f"advance: {st}")
        time.sleep(0.2)
    code, _, d = _http(url + "/api/online/promote", {"force": True})
    if code != 200 or not d["promoted"]:
        raise AssertionError(f"serve --online promote answered {code}: {d}")
    code, _, st2 = _http(url + "/api/online/stats")
    if (st2["promotion"]["promotions"] != 1 or not st2["learner"]["alive"]
            or st2["learner"]["iterations"] < it):
        raise AssertionError(f"serve --online stats after the promotion: "
                             f"{st2}")
    code, _, rb = _http(url + "/api/online/rollback", {})
    if code != 200 or rb["active_version"] != "v0":
        raise AssertionError(f"serve --online rollback answered {code}: "
                             f"{rb}")
    out["cli"] = {"iterations": [first, it, st2["learner"]["iterations"]],
                  "promotion": d["version"], "score_s": d["score_seconds"]}
    log(f"  serve --online: predict 200, learner iterations {first} -> "
        f"{st2['learner']['iterations']}, promote {d['version']} "
        f"(forced, {d['score_seconds']:.2f}s), rollback to "
        f"{rb['active_version']}")


def _conv_listener(out, card):
    """Gate 5: ConvolutionalListener on a LeNet fit of the committed
    digits on the card; its PNGs decode to the CPU listener's grids
    (same parameters, same example) within one gray level."""
    import base64
    import zlib

    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.ui.convolutional import \
        ConvolutionalListener
    from deeplearning4j_tpu_torch.ui.storage import InMemoryStatsStorage
    from deeplearning4j_tpu_torch.zoo.models import LeNet

    def gray(b64):
        raw = base64.b64decode(b64)
        pos, w, h, idat = 8, 0, 0, b""
        while pos < len(raw):
            n = int.from_bytes(raw[pos:pos + 4], "big")
            tag, body = raw[pos + 4:pos + 8], raw[pos + 8:pos + 8 + n]
            if tag == b"IHDR":
                w, h = int.from_bytes(body[:4], "big"), \
                    int.from_bytes(body[4:8], "big")
            elif tag == b"IDAT":
                idat += body
            pos += 12 + n
        img = np.frombuffer(zlib.decompress(idat), np.uint8)
        return img.reshape(h, w + 1)[:, 1:].astype(int)

    x, y = _all_digits()
    model = LeNet().init_pretrained(flavor="digits")      # on the card
    storage = InMemoryStatsStorage()
    listener = ConvolutionalListener(storage, "conv", frequency=1)
    listener.set_example(x[:1])
    model.set_listeners(listener)
    for i in range(CONV_FIT_STEPS):
        sl = slice(64 * i, 64 * (i + 1))
        model.fit(DataSet(x[sl], np.eye(10, dtype=np.float32)[y[sl]]))
    card_ups = [u for u in storage.get_all_updates("conv")
                if u.get("type") == "activations"]
    cpu = LeNet().init_pretrained(flavor="digits", device="cpu")
    cpu.set_params({k: {kk: v.cpu() for kk, v in d.items()}
                    for k, d in model.params.items()},
                   {k: {kk: v.cpu() for kk, v in d.items()}
                    for k, d in model.model_state.items()})
    cpu_storage = InMemoryStatsStorage()
    ConvolutionalListener(cpu_storage, "conv", frequency=1).set_example(
        x[:1]).iteration_done(cpu, model.iteration, 0, 0.0, 0.0, 64)
    want = cpu_storage.get_all_updates("conv")[-1]["activations_png"]
    got = card_ups[-1]["activations_png"]
    worst = max(int(np.abs(gray(got[k]) - gray(want[k])).max())
                for k in want)
    log(f"  ConvolutionalListener: {len(card_ups)} activation updates over "
        f"{CONV_FIT_STEPS} card steps, {len(got)} layers; the last against "
        f"the CPU listener's grids: max {worst} gray level(s)")
    if len(card_ups) != CONV_FIT_STEPS or list(got) != list(want) \
            or worst > 1:
        raise AssertionError("ConvolutionalListener on the card differs "
                             "from the CPU's")
    out["conv_listener"] = {"updates": len(card_ups), "layers": len(got),
                            "max_gray_levels": worst}


def phase_online(report, card):
    """Online learning on the slice ResNet50 (module docstring, phase 23).
    Returns the kernels' launches of its main path: the learner's,
    the serving pool's and the scorer's."""
    import tempfile

    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.models.serialization import (
        flatten_paths, params_from_jax, save_model)
    from deeplearning4j_tpu_torch.observe.registry import MetricsRegistry
    from deeplearning4j_tpu_torch.online import Candidate, OnlineServing
    from deeplearning4j_tpu_torch.ops import fused_conv as fc
    from deeplearning4j_tpu_torch.streaming.broker import TcpTransport
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    t_phase = time.perf_counter()
    out = {"card": card, "seconds": {}}
    tmp = tempfile.TemporaryDirectory(prefix="online_")
    broker = TcpTransport().serve()
    model = ResNet50(**SLICE).init()           # cuda, seeded generator
    params_from_jax(*nontrivial_bn(model, seed=ONLINE_SEED), model.device,
                    model=model)
    zip_path = os.path.join(tmp.name, "resnet50.zip")
    save_model(model, zip_path)
    cli = _online_cli(zip_path, broker.port)
    online = publisher = None
    stop_clients = threading.Event()
    lat_ms, clients = [], []
    restore = lambda: None
    try:
        online = OnlineServing(
            model, TcpTransport(port=broker.port), topic="train",
            model_name="resnet", feature_shape=_image_shape(),
            batch_limit=ONLINE_BATCH, holdout_every=ONLINE_HOLDOUT_EVERY,
            holdout_max=ONLINE_HOLDOUT_MAX, holdout_batch=ONLINE_BATCH,
            registry=MetricsRegistry())
        engine = online.pool.engines[0]
        ptrs = [{t.data_ptr() for t in flatten_paths(tree).values()}
                for tree in (model.params, online.promoter.eval_model.params,
                             engine.model.params, engine._committed[0])]
        if any(ptrs[i] & ptrs[j] for i in range(4) for j in range(i + 1, 4)):
            raise AssertionError("the online model copies share storage")
        out["seconds"]["setup"] = time.perf_counter() - t_phase

        # ---- 1. the learner trains while requests are served
        tallies, restore = _by_thread(fc)
        fc.reset_launch_counts()
        online.start(background_promotion=False)
        publisher = _Publisher(TcpTransport(port=broker.port), "train",
                               online.stream, cli_topic=ONLINE_CLI_TOPIC)

        def client(seed):
            rng = np.random.default_rng(seed)
            while not stop_clients.is_set():
                x = _pixels(rng, int(rng.integers(1, ONLINE_BATCH + 1)))
                t0 = time.perf_counter()
                online.output(x)
                lat_ms.append((time.perf_counter() - t0) * 1e3)
        clients = [threading.Thread(target=client, args=(s,), daemon=True)
                   for s in (1, 2)]
        t_learn = time.perf_counter()
        it0 = online.learner.iterations
        for th in clients:
            th.start()
        deadline = time.perf_counter() + ONLINE_DEADLINE_S
        while (online.learner.iterations < ONLINE_MIN_STEPS
               or online.stream.holdout_examples < ONLINE_BATCH):
            if not online.learner.alive or time.perf_counter() > deadline:
                raise AssertionError(f"the learner stalled: {online.stats()} "
                                     f"{online.learner.error!r}")
            time.sleep(0.05)
        steps = online.learner.iterations - it0
        learn_s = time.perf_counter() - t_learn
        served = len(lat_ms)
        q = _ms_quantiles(list(lat_ms))
        out["learner_images_per_s"] = steps * ONLINE_BATCH / learn_s
        out["serving_while_learning_ms"] = q
        log(f"  learner: {steps} steps of {ONLINE_BATCH} in {learn_s:.1f}s "
            f"while serving ({out['learner_images_per_s']:.1f} images/s); "
            f"{served} requests of 1-{ONLINE_BATCH} images served meanwhile, "
            f"p50 {q['p50']:.2f} ms, p99 {q['p99']:.2f} ms")

        # ---- 2. a good promotion, committed bitwise from its snapshot
        decision, snap = None, None
        while decision is None or not decision.promoted:
            if time.perf_counter() > deadline:
                raise AssertionError(f"no promotion before the deadline: "
                                     f"{decision}")
            snap = online.learner.snapshot(timeout=10)
            if snap is not None:
                decision = online.promoter.run_once(candidate=snap)
                log(f"  promotion at iteration {snap.iteration}: "
                    f"{decision.reason} (candidate "
                    f"{decision.candidate_score:.4f}, active "
                    f"{decision.active_score:.4f}, scored in "
                    f"{decision.score_seconds:.2f}s)")
        stop_clients.set()
        for th in clients:
            th.join(30)
        committed = engine.committed_host()
        if not (_trees_bitwise(committed[0], snap.params)
                and _trees_bitwise(committed[1], snap.model_state)):
            raise AssertionError("the promoted params differ from the "
                                 "candidate's snapshot")
        x = _pixels(np.random.default_rng(6), 7)
        served_x = online.output(x)
        online.promoter._load_eval(snap.params, snap.model_state)
        before = dict(tallies["scoring"])
        direct = online.promoter.eval_model.output(x).float().cpu().numpy()
        compared = {k: tallies["scoring"][k] - before.get(k, 0)
                    for k in tallies["scoring"]}
        serve_err = float(np.abs(served_x - direct).max())
        log(f"  promoted {decision.version}: committed params bitwise the "
            f"snapshot; a served batch of 7 against the snapshot's direct "
            f"forward |diff| {serve_err:.3g} (bound {ONLINE_SERVE_TOL})")
        if not np.isfinite(served_x).all() or serve_err > ONLINE_SERVE_TOL:
            raise AssertionError("served answers differ from the snapshot's "
                                 "forward")
        out["promotion"] = {"iteration": snap.iteration,
                            "candidate_score": decision.candidate_score,
                            "active_score": decision.active_score,
                            "score_seconds": decision.score_seconds,
                            "served_vs_direct": serve_err}

        # ---- 3. a degraded candidate, forced in and rolled back bitwise
        pre = engine.committed_host()
        bad_params = {k: {kk: v.clone() for kk, v in d.items()}
                      for k, d in snap.params.items()}
        bad_params["out"]["W"] *= ONLINE_DEGRADE
        bad = Candidate(bad_params, snap.model_state, snap.iteration,
                        snap.samples_seen, time.time())
        forced = online.promoter.run_once(candidate=bad, force=True)
        verdict = online.sentinel.check()
        after = engine.committed_host()
        log(f"  degraded candidate (output W x{ONLINE_DEGRADE}): "
            f"{forced.reason} at score {forced.candidate_score:.4f}; "
            f"sentinel {verdict!r}; active version "
            f"{online.pool.active_version}")
        if not forced.promoted or verdict not in ("score", "nan") \
                or not _trees_bitwise(after[0], pre[0]) \
                or not _trees_bitwise(after[1], pre[1]):
            raise AssertionError("the degraded candidate was not rolled "
                                 "back to the pre-swap params bitwise")
        online.router.assert_warm()
        out["rollback"] = {"forced_score": forced.candidate_score,
                           "verdict": verdict}
        restore()
        # the main path's launches, less the comparison forward's
        launches = {k: fc.LAUNCHES[k] - compared.get(k, 0)
                    for k in fc.LAUNCHES}
        tallies["scoring"].subtract(compared)
        out["launches"] = {k: dict(v) for k, v in tallies.items()}
        log(f"  launches by thread: "
            f"{ {k: dict(v) for k, v in tallies.items()} }")
        trained = tallies["learner"] + tallies["learner_backward"]
        if (any(trained[k] == 0 for k in fc.LAUNCHES)
                or any(tallies[w][k] == 0 for w in ("learner", "serving",
                                                    "scoring")
                       for k in FORWARD)):
            raise AssertionError("kernels 1-6 did not all launch in the "
                                 "learner, or 1-2 in serving and scoring")
        online.stop()
        online = None
        out["seconds"]["in_process"] = time.perf_counter() - t_phase

        # ---- 4. serve --online in a subprocess (the publisher feeds its
        # topic still; the stopped learner's backlog holds the other)
        t0 = time.perf_counter()
        _online_cli_gates(cli, out)
        out["seconds"]["cli"] = time.perf_counter() - t0

        # ---- 5. ConvolutionalListener on the card
        t0 = time.perf_counter()
        _conv_listener(out, card)
        out["seconds"]["conv_listener"] = time.perf_counter() - t0
    finally:
        restore()
        stop_clients.set()
        if publisher is not None:
            publisher.stop()
        if online is not None:
            online.stop()
        cli.stop()
        broker.close()
        tmp.cleanup()
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    report["online"] = out
    return launches


# ---- phase 24: the persisted kernel cache --------------------------------

AOT_KEY = "resnet50"
AOT_SHAPE_OTHER = (32, 32, 3)     # another feature shape: a named mismatch
# the subprocesses' own code: BUILD_DIR at their own empty directory
# before the first kernel call, cuDNN deterministic, then an engine (or a
# serve --join node) over the model's zip with the store's cache dir
AOT_CHILD = r'''
import json, sys, time
from pathlib import Path
spec = json.loads(sys.argv[1])
import numpy as np
import torch
torch.backends.cudnn.deterministic = True
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from deeplearning4j_tpu_torch.ops import cuda_build
cuda_build.BUILD_DIR = Path(spec["build_dir"])
if spec["mode"] == "node":
    from deeplearning4j_tpu_torch.__main__ import cmd_serve
    node, server = cmd_serve(["serve", *spec["args"]], block=False)
    node.router.assert_warm()
    eng = node.router.pool(spec["name"]).engines[0]
    print(json.dumps({"warm": True, "url": node.url,
                      "build_log": sorted(cuda_build.build_log),
                      "aot": eng.stats()["aot_cache"]}), flush=True)
    time.sleep(600)
from deeplearning4j_tpu_torch.models.serialization import restore_model
from deeplearning4j_tpu_torch.parallel.serving import ServingEngine
model = restore_model(spec["zip"], device=spec["device"])
eng = ServingEngine(model, batch_limit=32, feature_shape=tuple(spec["shape"]),
                    precision="bf16", model_version="v1",
                    aot_cache_dir=spec["cache_dir"])
eng.assert_warm()
print(json.dumps({"warm": True}), flush=True)
x = np.load(spec["x"])
if x.shape[1:] == tuple(spec["shape"]):
    np.save(spec["out"], eng.output(x))
stats = eng.stats()["aot_cache"]
eng.shutdown()
print(json.dumps({"build_log": sorted(cuda_build.build_log), "aot": stats,
                  "nvcc_s": {k: v[0] for k, v in cuda_build.build_log.items()}}),
      flush=True)
'''


class _AotChild:
    """One AOT_CHILD subprocess; its JSON lines read in a thread, the
    seconds from its spawn to its warm line recorded."""

    def __init__(self, spec):
        self.lines, self.json = [], []
        self.warm_s = None
        self._warm = threading.Event()
        self._t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", AOT_CHILD, json.dumps(spec)],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        self._t = threading.Thread(target=self._read, daemon=True)
        self._t.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip())
            if line.startswith("{"):
                doc = json.loads(line)
                self.json.append(doc)
                if doc.get("warm") and self.warm_s is None:
                    self.warm_s = time.perf_counter() - self._t0
                    self._warm.set()
        self._warm.set()

    def wait_warm(self, timeout=300):
        if not self._warm.wait(timeout) or self.warm_s is None:
            raise AssertionError("a cache subprocess did not warm up: "
                                 + " | ".join(self.lines[-20:]))
        return self.json[0]

    def result(self, timeout=300):
        self.proc.wait(timeout)
        self._t.join(10)
        if self.proc.returncode != 0:
            raise AssertionError("a cache subprocess failed: "
                                 + " | ".join(self.lines[-20:]))
        return self.json[-1]

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self._t.join(10)


def phase_aot_cache(report, card):
    """The persisted kernel cache across fresh processes (module
    docstring, phase 24). Its kernels launch in subprocesses, outside
    this process's counters."""
    import shutil
    import tempfile

    import numpy as np
    from deeplearning4j_tpu_torch.models.serialization import (
        params_from_jax, save_model)
    from deeplearning4j_tpu_torch.ops import cuda_build
    from deeplearning4j_tpu_torch.parallel.aot_cache import ArtifactStore
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    t_phase = time.perf_counter()
    out = {"card": card, "seconds": {}}
    tmp = tempfile.TemporaryDirectory(prefix="aot_")
    root = tmp.name
    model = ResNet50(**SLICE).init()
    params_from_jax(*nontrivial_bn(model, seed=24), model.device, model=model)
    zip_path = os.path.join(root, "resnet50.zip")
    save_model(model, zip_path)
    del model
    store = ArtifactStore(os.path.join(root, "store"))
    key_dir = store.cache_dir(AOT_KEY)
    x_path = os.path.join(root, "x.npy")
    np.save(x_path, _pixels(np.random.default_rng(24), 7))

    def spec(name, shape=_image_shape(), cache_dir=key_dir):
        return {"mode": "engine", "device": "cuda", "zip": zip_path,
                "shape": list(shape),
                "cache_dir": cache_dir, "x": x_path,
                "out": os.path.join(root, f"{name}.npy"),
                "build_dir": os.path.join(root, f"kernels-{name}")}
    children = []
    try:
        # ---- cold: builds both forward libraries, then saves them
        cold = _AotChild(spec("cold"))
        children.append(cold)
        cold.wait_warm()
        got = cold.result()
        want = np.load(os.path.join(root, "cold.npy"))
        log(f"  cold process: spawn to assert_warm {cold.warm_s:.2f}s; "
            f"nvcc built {got['build_log']} "
            f"({ {k: round(v, 2) for k, v in got['nvcc_s'].items()} } s); "
            f"cache {got['aot']['state']}, saved {got['aot']['saved']}")
        if sorted(got["build_log"]) != sorted(FORWARD) \
                or got["aot"]["state"] != "cold" \
                or got["aot"]["saved"] != len(FORWARD):
            raise AssertionError(f"the cold process did not build and save "
                                 f"the forward libraries: {got}")
        out["cold"] = {"spawn_to_warm_s": cold.warm_s, **got}

        # ---- beside each other: a warm serve --join node on the store;
        # a run with another feature shape, and a run with one blob
        # corrupted, each on a copy of the key's directory
        other_dir = os.path.join(root, "other")
        shutil.copytree(key_dir, other_dir)
        bad_dir = os.path.join(root, "corrupted")
        shutil.copytree(key_dir, bad_dir)
        blob = os.path.join(bad_dir, cuda_build.library_path(
            "fused_c3").name)
        with open(blob, "r+b") as f:
            f.seek(4096)
            b = f.read(1)
            f.seek(4096)
            f.write(bytes([b[0] ^ 0xFF]))
        mismatch = _AotChild(spec("mismatch", AOT_SHAPE_OTHER, other_dir))
        children.append(mismatch)
        corrupt = _AotChild(spec("corrupt", cache_dir=bad_dir))
        children.append(corrupt)
        name = os.path.splitext(os.path.basename(zip_path))[0]
        node = _AotChild({
            "mode": "node", "name": name,
            "build_dir": os.path.join(root, "kernels-warm"),
            "args": ["--model", zip_path, "--bf16", "--warmup-shape",
                     *map(str, _image_shape()), "--batch-limit", "32",
                     "--ui-port", "0", "--join", os.path.join(root, "reg"),
                     "--node-id", "warm", "--artifact-store",
                     str(store.root), "--model-key", AOT_KEY,
                     "--device", "cuda"]})
        children.append(node)
        doc = node.wait_warm()
        code, ans, n, _ = _predict(doc["url"], np.load(x_path))
        node_equal = code == 200 and np.array_equal(ans, want)
        log(f"  warm serve --join node: spawn to assert_warm "
            f"{node.warm_s:.2f}s; nvcc ran for {doc['build_log']}; cache "
            f"{doc['aot']['state']}, {doc['aot']['hits']} libraries "
            f"restored; its answer bitwise the cold process's {node_equal}")
        if doc["build_log"] or doc["aot"]["state"] != "warm" \
                or doc["aot"]["hits"] != len(FORWARD) or not node_equal:
            raise AssertionError(f"the warm node: {doc}, answer {code}")
        node.stop()
        out["warm"] = {"spawn_to_warm_s": node.warm_s, **doc}

        mismatch.wait_warm()
        got = mismatch.result()
        log(f"  feature shape {AOT_SHAPE_OTHER}: cache "
            f"{got['aot']['state']} ({got['aot']['reason']}); nvcc built "
            f"{got['build_log']}")
        if got["aot"]["state"] != "mismatch" \
                or "'serving.feature_shape'" not in got["aot"]["reason"] \
                or sorted(got["build_log"]) != sorted(FORWARD):
            raise AssertionError(f"the mismatched run: {got}")
        out["mismatch"] = got

        corrupt.wait_warm()
        got = corrupt.result()
        again = np.load(os.path.join(root, "corrupt.npy"))
        log(f"  corrupted fused_c3 blob: cache {got['aot']['state']} "
            f"({got['aot']['reason']}), quarantined "
            f"{got['aot']['quarantined']}, restored {got['aot']['libraries']}"
            f", nvcc rebuilt {got['build_log']}, republished "
            f"{os.path.exists(blob)}; answer bitwise the cold one "
            f"{np.array_equal(again, want)}")
        if got["aot"]["quarantined"] != 1 \
                or got["build_log"] != ["fused_c3"] \
                or not os.path.exists(blob + ".quarantine") \
                or not os.path.exists(blob) \
                or not np.array_equal(again, want):
            raise AssertionError(f"the corrupted blob: {got}")
        out["corrupt"] = got
    finally:
        for c in children:
            c.stop()
        tmp.cleanup()
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    report["aot_cache"] = out


# ---- phase 25: data-parallel training -----------------------------------

DP_BATCH, DP_STEPS = 32, 4        # one rank: 4 steps of 32 rows, bf16
DP_RANKS, DP_ROWS, DP_SYNC_STEPS = 2, 32, 3   # two ranks x 32 rows, f32
DP_PERMUTATIONS = 3               # permuted runs of the noise of step 1
DP_SEED = 25
DP_JOIN_S = 300.0                 # a spawned group's join deadline
DP_GROUP_S = 120.0                # every collective's timeout
# the watchdog runs (CPU ranks, the Iris MLP): heartbeats every
# DP_BEAT_S, a peer dead past DP_DEAD_S, a collective in flight past
# DP_DEADLINE_S classified; the slow peer sleeps DP_SLEEP_S while its
# heartbeat thread keeps beating
DP_BEAT_S, DP_DEAD_S, DP_DEADLINE_S, DP_SLEEP_S = 0.1, 2.0, 1.0, 3.0


def train_launches_per_step(model, fc):
    """{kernel: launches} of one train step of the fused ResNet50: the
    forward's calls and each one's backward route."""
    per_step = {}
    for call, n in path_calls(model.conf, 1).items():
        per_step[call.kernel] = per_step.get(call.kernel, 0) + n
        if call.kernel == "fused_mm":
            bwd = ["fused_mm_bwd"]
        elif call.x_shape[3] <= fc.C3_MERGED_MAX_CIN and call.norm_in:
            bwd = ["fused_c3_bwd"]
        else:
            bwd = ["fused_c3_bwd_in", "fused_c3_bwd_w"]
        for k in bwd:
            per_step[k] = per_step.get(k, 0) + n
    return per_step


def _host_trees(model):
    """{group/path: numpy} of a model's params, state and updater state."""
    from deeplearning4j_tpu_torch.models.serialization import flatten_paths
    out = {}
    for group in ("params", "model_state", "opt_state"):
        for k, v in flatten_paths(getattr(model, group)).items():
            out[f"{group}/{k}"] = v.detach().float().cpu().numpy()
    return out


def _trees_digest(model) -> str:
    import hashlib
    h = hashlib.sha256()
    for k, v in sorted(_host_trees(model).items()):
        h.update(k.encode())
        h.update(v.tobytes())
    return h.hexdigest()


def _dp_mlp():
    from deeplearning4j_tpu_torch.models.multi_layer_network import \
        MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn.config import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.inputs import InputType
    from deeplearning4j_tpu_torch.nn.layers.feedforward import DenseLayer
    from deeplearning4j_tpu_torch.nn.layers.output import OutputLayer
    from deeplearning4j_tpu_torch.ops.activations import Activation
    from deeplearning4j_tpu_torch.optimize.updaters import Sgd
    conf = (NeuralNetConfiguration.Builder().seed(1).updater(Sgd(0.1))
            .list().layer(DenseLayer(n_out=16, activation=Activation.TANH))
            .layer(OutputLayer(n_out=3))
            .set_input_type(InputType.feed_forward(4)).build())
    return MultiLayerNetwork(conf, device="cpu").init()


def dp_sync_rank(rank, world, zip_path, data_path, out_dir, ckpt_dir):
    """One rank of the two on the card (gloo): SHARED_GRADIENTS steps 1-3
    on its 32 of each batch's 64 rows, a sharded checkpoint after each,
    step 4; then a fresh model restored from the checkpoint of step 3
    takes step 4 again. Writes its digests, launches, losses,
    checkpoints and replica rows."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import (
        DataSet, ListDataSetIterator)
    from deeplearning4j_tpu_torch.models.serialization import restore_model
    from deeplearning4j_tpu_torch.observe.telemetry import TelemetryCollector
    from deeplearning4j_tpu_torch.ops import fused_conv as fc
    from deeplearning4j_tpu_torch.parallel.checkpoint import (
        restore_sharded, save_sharded)
    from deeplearning4j_tpu_torch.parallel.wrapper import (ParallelWrapper,
                                                           TrainingMode)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the stem convolution's default cuDNN backward differs from run to
    # run in the last bits: the resumed step is compared bitwise
    torch.backends.cudnn.deterministic = True
    data = np.load(data_path)
    batches = [DataSet(x, y) for x, y in zip(data["x"], data["y"])]

    def wrapper(m):
        return (ParallelWrapper.builder(m)
                .training_mode(TrainingMode.SHARED_GRADIENTS)
                .workers(world).build())
    m = restore_model(zip_path, device="cuda")
    tel = TelemetryCollector(flush_interval=1)
    m.set_telemetry(tel)
    w = wrapper(m)
    fc.reset_launch_counts()
    losses, digests, ckpts = [], {}, []
    for i, b in enumerate(batches):
        w.fit(ListDataSetIterator([b]))
        losses.append(float(m._last_loss))
        if i < DP_SYNC_STEPS:
            ckpts.append(save_sharded(m.train_state, ckpt_dir))
        if i + 1 == DP_SYNC_STEPS:
            ckpt = ckpts[-1]
            digests["step3"] = _trees_digest(m)
            if rank == 0:
                np.savez(os.path.join(out_dir, "rank0_step3.npz"),
                         **_host_trees(m))
    torch.cuda.synchronize()
    launches = dict(fc.LAUNCHES)
    digests["step4"] = _trees_digest(m)
    fresh = restore_model(zip_path, device="cuda")
    restore_sharded(fresh, ckpt)
    resumed_at = fresh.iteration
    wrapper(fresh).fit(ListDataSetIterator(batches[DP_SYNC_STEPS:]))
    digests["resumed_step4"] = _trees_digest(fresh)
    rec = tel.last_replica_record()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"losses": losses, "digests": digests,
                   "launches": launches, "resumed_at": resumed_at,
                   "ckpts": ckpts, "replica": rec,
                   "replica_rows": len(tel.replica_history)}, f)


def dp_watchdog_rank(rank, world, out_dir, scenario):
    """One CPU rank of the watchdog runs: the Iris MLP under
    SHARED_GRADIENTS with a CollectiveWatchdog. In "kill" rank 1 SIGKILLs
    itself after step 3 and the survivor must leave with
    PEER_LOSS_EXIT_CODE; in "sleep" rank 1 sleeps past the deadline after
    step 3 while its heartbeat thread beats, and both finish."""
    import signal
    from deeplearning4j_tpu_torch.datasets.fetchers import \
        IrisDataSetIterator
    from deeplearning4j_tpu_torch.observe.flight_recorder import \
        FlightRecorder
    from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
    from deeplearning4j_tpu_torch.parallel.cluster import (
        PEER_LOSS_EXIT_CODE, CollectiveWatchdog)
    from deeplearning4j_tpu_torch.parallel.wrapper import ParallelWrapper

    m = _dp_mlp()
    m.set_flight_recorder(FlightRecorder(os.path.join(out_dir, "dumps"),
                                         enabled=True))
    wd = CollectiveWatchdog(os.path.join(out_dir, "heartbeats"), rank=rank,
                            n_ranks=world, interval_s=DP_BEAT_S,
                            deadline_s=DP_DEADLINE_S, dead_after_s=DP_DEAD_S,
                            model=m, checkpoint_dir=os.path.join(
                                out_dir, "ckpt"), exit_on_loss=True)

    class Trip(TrainingListener):
        def iteration_done(self, model, iteration, epoch, loss, etl_ms,
                           examples):
            if rank == 1 and iteration == 3:
                if scenario == "kill":
                    os.kill(os.getpid(), signal.SIGKILL)
                time.sleep(DP_SLEEP_S)
    m.add_listeners(Trip())
    wd.start()
    try:
        ParallelWrapper.builder(m).workers(world).watchdog(wd).build().fit(
            IrisDataSetIterator(batch_size=32), epochs=2)
    except Exception:
        if wd.peer_loss_event is not None:
            os._exit(PEER_LOSS_EXIT_CODE)
        raise
    finally:
        wd.stop()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"straggler_waits": wd.straggler_waits,
                   "peer_loss": wd.peer_loss_event,
                   "iteration": m.iteration}, f)


def _dp_one_rank(out, card, fc, batches, fresh, per_step):
    """Item 1: one rank in this process over NCCL; returns launches."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import \
        ListDataSetIterator
    from deeplearning4j_tpu_torch.parallel.wrapper import (ParallelWrapper,
                                                           TrainingMode)
    plain = fresh()
    plain_losses = []
    for b in batches:
        plain.fit(b)
        plain_losses.append(plain._last_loss)
    ref = _host_trees(plain)
    # the loss a dispatch reports: SHARED_GRADIENTS' last step's, a
    # round's mean over its local steps (the JAX package's pmean of the
    # mean)
    ref_loss = {"SHARED_GRADIENTS": float(plain_losses[-1]),
                "AVERAGING": float(torch.stack(plain_losses).mean())}
    launches = {k: 0 for k in per_step}
    trees, losses = {}, {}
    for mode in ("SHARED_GRADIENTS", "AVERAGING", "ASYNC_ELASTIC"):
        m = fresh()
        w = (ParallelWrapper.builder(m)
             .training_mode(TrainingMode[mode]).workers(1)
             .averaging_frequency(DP_STEPS).build())
        fc.reset_launch_counts()
        w.fit(ListDataSetIterator(batches))
        torch.cuda.synchronize()
        got = {k: fc.LAUNCHES[k] for k in per_step}
        for k, n in got.items():
            launches[k] += n
        want = {k: DP_STEPS * n for k, n in per_step.items()}
        log(f"  one rank (NCCL) {mode}: {DP_STEPS} steps, launches {got}")
        if got != want:
            raise AssertionError(f"{mode}: launches {got}, expected {want}")
        if m.iteration != DP_STEPS:
            raise AssertionError(f"{mode}: iteration {m.iteration}")
        trees[mode], losses[mode] = _host_trees(m), float(m._last_loss)
    differ = lambda a, b: sorted(k for k in a if not np.array_equal(a[k],
                                                                    b[k]))
    res = {"launches_per_step": per_step}
    for mode in ("SHARED_GRADIENTS", "AVERAGING"):
        bad = differ(trees[mode], ref)
        res[mode] = {"bitwise_plain_fit": not bad, "loss": losses[mode],
                     "plain_loss": ref_loss[mode]}
        log(f"  {mode} at one rank: {len(ref)} leaves bitwise {DP_STEPS} "
            f"plain fit steps: {not bad}; loss {losses[mode]:.6f} vs "
            f"{ref_loss[mode]:.6f}")
        if bad or losses[mode] != ref_loss[mode]:
            raise AssertionError(f"{mode} at one rank differs from plain "
                                 f"fit: {bad[:4]}")
    # ASYNC_ELASTIC's merge is θ + Σ w (local - base) / Σ w: at one rank
    # θ + (l - θ), which rounds where l - θ is not exact, so its
    # parameters are held to the train phase's f32 bounds against
    # AVERAGING (its state and updater state, merged as (1 · l) / 1, and
    # its loss stay bitwise)
    a, v = trees["ASYNC_ELASTIC"], trees["AVERAGING"]
    p0 = _host_trees(fresh())
    bad = differ(a, v)
    state_bad = [k for k in bad if not k.startswith("params/")]
    num = sum(float(((a[k] - v[k]).astype(np.float64) ** 2).sum())
              for k in a if k.startswith("params/"))
    den = sum(float(((v[k] - p0[k]).astype(np.float64) ** 2).sum())
              for k in a if k.startswith("params/"))
    rel = (num / max(den, 1e-300)) ** 0.5
    # in ulps of each leaf's largest entry
    ulps = max(float(np.abs(a[k] - v[k]).max() / np.spacing(
        np.abs(v[k]).max().astype(np.float32)))
        for k in a if k.startswith("params/"))
    res["ASYNC_ELASTIC"] = {"bitwise_averaging": not bad,
                            "params_differ": len(bad),
                            "update_rel_l2": rel, "max_ulps": ulps,
                            "loss": losses["ASYNC_ELASTIC"]}
    log(f"  ASYNC_ELASTIC (no straggler) vs AVERAGING at one rank: bitwise "
        f"{not bad} ({len(bad)} parameter leaves differ, at most "
        f"{ulps:.2f} ulps; update rel L2 {rel:.3g}, bound {GRAD_RTOL}); "
        f"state and updater state bitwise {not state_bad}; loss "
        f"{losses['ASYNC_ELASTIC']:.6f} vs {losses['AVERAGING']:.6f}")
    if state_bad or rel > GRAD_RTOL or abs(
            losses["ASYNC_ELASTIC"] - losses["AVERAGING"]) > LOSS_RTOL * abs(
            losses["AVERAGING"]):
        raise AssertionError("ASYNC_ELASTIC without stragglers departs "
                             "from AVERAGING")
    out["one_rank"] = res
    return launches


def _dp_two_ranks(out, card, tmp, fresh, per_step):
    """Items 2 and 3: two gloo ranks on the one card, f32, and the
    sharded checkpoint; returns the ranks' launches."""
    import numpy as np
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models.serialization import (
        restore_model, save_model)
    from deeplearning4j_tpu_torch.parallel.checkpoint import restore_sharded
    from deeplearning4j_tpu_torch.parallel.launch import spawn_ranks
    rng = np.random.default_rng(DP_SEED + 1)
    n = DP_RANKS * DP_ROWS
    x = rng.normal(0, 1, (DP_SYNC_STEPS + 1, n) + _image_shape()).astype(
        np.float32)
    y = np.eye(SLICE["num_classes"], dtype=np.float32)[
        rng.integers(0, SLICE["num_classes"], (DP_SYNC_STEPS + 1, n))]
    zip_path = os.path.join(tmp, "resnet50_f32.zip")
    data_path = os.path.join(tmp, "batches.npz")
    save_model(fresh("float32"), zip_path)
    np.savez(data_path, x=x, y=y)
    run = os.path.join(tmp, "sync")
    os.makedirs(run)
    t0 = time.perf_counter()
    codes = spawn_ranks(dp_sync_rank, DP_RANKS, (
        zip_path, data_path, run, os.path.join(run, "ckpt")),
        run_dir=run, backend="gloo", timeout_s=DP_JOIN_S,
        group_timeout_s=DP_GROUP_S, name="sync")
    out["seconds"]["two_ranks"] = time.perf_counter() - t0
    if codes != [0] * DP_RANKS:
        raise AssertionError(f"the two-rank group exited {codes}")
    ranks = [json.load(open(os.path.join(run, f"rank{r}.json")))
             for r in range(DP_RANKS)]
    d0, d1 = ranks[0]["digests"], ranks[1]["digests"]
    equal = d0 == d1
    # each step again in one process on the 64 rows, from the state the
    # ranks took it from (the model's file, then their checkpoint of the
    # step before): its loss, a forward on the same weights, within the
    # train phase's LOSS_RTOL. The first step's update is held as the train
    # phase holds the gradients: max(GRAD_RTOL, GRAD_NOISE x the row-order
    # noise), the noise the largest of DP_PERMUTATIONS runs of that step on
    # the rows permuted (its samples spread 4x in a CPU rehearsal). Only the
    # first: the later steps' updates are chaotic at this size (3 steps put
    # rank 0 and a permuted process each 73-108% in relative L2 from one
    # process's update), while one step's noise is a few percent and a
    # wiring fault (a lost statistics cotangent) moves it by O(1).
    ckpts = ranks[0]["ckpts"]
    t0 = time.perf_counter()
    single, perm, after = (restore_model(zip_path, device="cuda")
                           for _ in range(3))
    start, perm_start = _host_trees(single), perm.train_state
    restore_sharded(after, ckpts[0])
    got1 = _host_trees(after)

    def update_err(a, ref):
        errs, num, den = {}, 0.0, 0.0
        for k in ref:
            if not k.startswith("params/"):
                continue
            d = (a[k] - ref[k]).astype(np.float64)
            r = (ref[k] - start[k]).astype(np.float64)
            num += float((d * d).sum())
            den += float((r * r).sum())
            errs[k] = float(np.linalg.norm(d) / max(np.linalg.norm(r),
                                                    1e-30))
        return {"worst": max(errs.values()), "all": (num / den) ** 0.5}
    rel = lambda a, b: abs(a - b) / abs(b)
    loss_rel, noise = [], {"worst": 0.0, "all": 0.0}
    for i in range(DP_SYNC_STEPS):
        if i:
            restore_sharded(single, ckpts[i - 1])
        single.fit(DataSet(x[i], y[i]))
        loss_rel.append(rel(ranks[0]["losses"][i], float(single._last_loss)))
        if i:
            continue
        ref = _host_trees(single)
        err = update_err(got1, ref)
        for _ in range(DP_PERMUTATIONS):
            order = rng.permutation(n)
            perm.train_state = perm_start
            perm.fit(DataSet(x[0][order], y[0][order]))
            e = update_err(_host_trees(perm), ref)
            noise = {k: max(v, e[k]) for k, v in noise.items()}
    out["seconds"]["single_process"] = time.perf_counter() - t0
    rep = ranks[0]["replica"] or {}
    fps = rep.get("param_norm", [])
    log(f"  two ranks on the card (gloo, spawn), f32, {DP_SYNC_STEPS} "
        f"SHARED_GRADIENTS steps of {DP_RANKS} x {DP_ROWS} rows: ranks "
        f"bitwise equal {equal}; each step against one process taking it "
        f"on the {n} rows from the same state: loss rel "
        f"{', '.join(f'{e:.3g}' for e in loss_rel)} (bound {LOSS_RTOL}); "
        f"step 1's update rel L2 worst {err['worst']:.3g}, all "
        f"{err['all']:.3g} (row-order noise, the largest of "
        f"{DP_PERMUTATIONS}: {noise['worst']:.3g}, {noise['all']:.3g}; "
        f"bound max({GRAD_RTOL}, {GRAD_NOISE} x noise)); replica ring "
        f"{ranks[0]['replica_rows']} rows, fingerprints {fps} [{card}]")
    if not equal:
        raise AssertionError(f"the ranks differ: {d0} vs {d1}")
    for key in ("worst", "all"):
        limit = max(GRAD_RTOL, GRAD_NOISE * noise[key])
        if err[key] > limit:
            raise AssertionError(f"two ranks vs one process: step 1's "
                                 f"update {key} {err[key]:.3g} > "
                                 f"{limit:.3g}")
    if any(e > LOSS_RTOL for e in loss_rel):
        raise AssertionError(f"two ranks vs one process: losses {loss_rel}")
    if len(fps) != DP_RANKS or len(set(fps)) != 1 or not all(
            np.isfinite(fps)):
        raise AssertionError(f"the replica ring lacks the ranks' "
                             f"fingerprints: {rep}")
    # item 3: the checkpoint of step 3, restored in a fresh model in each
    # rank of the same group, took step 4 as the unbroken run did; and it
    # restores at world size 1 here, bitwise rank 0's step 3
    resumed = all(r["digests"]["resumed_step4"] == r["digests"]["step4"]
                  and r["resumed_at"] == DP_SYNC_STEPS for r in ranks)
    restore_sharded(after, ckpts[-1])
    here_trees = _host_trees(after)
    got = dict(np.load(os.path.join(run, "rank0_step3.npz")))
    at_one = all(np.array_equal(here_trees[k], got[k]) for k in got)
    log(f"  sharded checkpoint at step {DP_SYNC_STEPS} "
        f"({os.path.basename(ckpts[-1])}): restored into a fresh "
        f"model in each rank, step {DP_SYNC_STEPS + 1} bitwise the unbroken "
        f"run's {resumed}; restored at world size 1, bitwise rank 0's step "
        f"{DP_SYNC_STEPS} {at_one}")
    if not resumed or not at_one:
        raise AssertionError("the sharded checkpoint did not resume "
                             "bitwise")
    out["two_ranks"] = {"bitwise_ranks": equal, "loss_rel": loss_rel,
                        "update_rel_l2": err, "row_order_noise": noise,
                        "fingerprints": fps, "resumed_bitwise": resumed,
                        "restored_at_world_1": at_one,
                        "launches_per_rank": [r["launches"] for r in ranks]}
    totals = {k: 0 for k in per_step}
    for r in ranks:
        for k in totals:
            totals[k] += r["launches"].get(k, 0)
    want = {k: (DP_SYNC_STEPS + 1) * n for k, n in per_step.items()}
    if any(r["launches"].get(k, 0) != want[k] for r in ranks for k in want):
        raise AssertionError(f"a rank's launches {ranks[0]['launches']} "
                             f"differ from {want}")
    return totals


def _dp_watchdog(out, tmp):
    """Item 4: the collective watchdog in two CPU subprocess groups, run
    side by side."""
    from deeplearning4j_tpu_torch.parallel.checkpoint import restore_sharded
    from deeplearning4j_tpu_torch.parallel.cluster import (
        PEER_LOSS_EXIT_CODE, PEER_LOSS_MARKER)
    from deeplearning4j_tpu_torch.parallel.launch import spawn_ranks
    res = {}

    def group(scenario):
        run = os.path.join(tmp, f"watchdog_{scenario}")
        os.makedirs(run)
        t0 = time.perf_counter()
        try:
            codes = spawn_ranks(dp_watchdog_rank, 2, (run, scenario),
                                run_dir=run, backend="gloo",
                                timeout_s=DP_JOIN_S,
                                group_timeout_s=DP_GROUP_S, name=scenario)
        except BaseException as e:          # named by the caller
            codes = repr(e)
        res[scenario] = {"codes": codes,
                         "seconds": time.perf_counter() - t0}
    threads = [threading.Thread(target=group, args=(s,))
               for s in ("kill", "sleep")]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for scenario in ("kill", "sleep"):
        run = os.path.join(tmp, f"watchdog_{scenario}")
        codes = res[scenario]["codes"]
        if scenario == "kill":
            marker = os.path.join(run, "ckpt", f"{PEER_LOSS_MARKER}.0")
            event = json.load(open(marker)) if os.path.exists(marker) \
                else {}
            em = event.get("emergency_checkpoint")
            restored = None
            if em:
                m = _dp_mlp()
                restore_sharded(m, em)
                restored = m.iteration
            dumps = os.path.join(run, "dumps")
            ctx = [os.path.join(dumps, d, "context.json")
                   for d in (os.listdir(dumps) if os.path.isdir(dumps)
                             else [])]
            ctx = [json.load(open(p)) for p in ctx if os.path.exists(p)]
            res[scenario].update(event=event, restored_iteration=restored,
                                 dumps=len(ctx))
            log(f"  watchdog, peer SIGKILLed after step 3: exit codes "
                f"{codes}; marker {event.get('reason')} dead "
                f"{event.get('dead_ranks')} at iteration "
                f"{event.get('iteration')}; emergency checkpoint "
                f"{os.path.basename(em or '-')} restores at iteration "
                f"{restored}; {len(ctx)} peer_loss dump(s)")
            if codes[0] != PEER_LOSS_EXIT_CODE or event.get(
                    "dead_ranks") != [1] or restored != event.get(
                    "iteration") or not ctx:
                raise AssertionError("the survivor of a killed peer did not "
                                     "leave as peer loss with a restorable "
                                     "emergency checkpoint")
        else:
            done = os.path.join(run, "rank0.json")
            r0 = json.load(open(done)) if os.path.exists(done) else {
                "straggler_waits": 0, "peer_loss": "no result"}
            res[scenario].update(rank0=r0)
            log(f"  watchdog, peer asleep {DP_SLEEP_S:.1f}s past the "
                f"{DP_DEADLINE_S:.1f}s deadline while beating: exit codes "
                f"{codes}, rank 0 straggler waits {r0['straggler_waits']}, "
                f"peer loss {r0['peer_loss']}")
            if codes != [0, 0] or r0["peer_loss"] is not None or \
                    r0["straggler_waits"] < 1:
                raise AssertionError("a slow but beating peer was not "
                                     "classified a straggler")
    out["watchdog"] = res


def phase_data_parallel(report, card):
    """Data-parallel training over the slice ResNet50 (module docstring,
    phase 25). Returns the main path's kernel launches."""
    import tempfile

    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models.serialization import params_from_jax
    from deeplearning4j_tpu_torch.ops import cuda_build
    from deeplearning4j_tpu_torch.ops import fused_conv as fc
    from deeplearning4j_tpu_torch.parallel.mesh import (
        initialize_distributed, shutdown_distributed)
    from deeplearning4j_tpu_torch.zoo.models import ResNet50

    t_phase = time.perf_counter()
    out = {"card": card, "seconds": {}}
    # the ranks load these libraries and never compile one themselves
    cuda_build.build()
    tmp = tempfile.TemporaryDirectory(prefix="data_parallel_")
    base = ResNet50(**SLICE).init()
    params_np, state_np = nontrivial_bn(base)
    per_step = train_launches_per_step(base, fc)
    del base

    def fresh(dtype="bfloat16"):
        m = ResNet50(**dict(SLICE, compute_dtype=dtype)).init()
        params_from_jax(params_np, state_np, m.device, model=m)
        return m

    rng = np.random.default_rng(DP_SEED)
    batches = [DataSet(rng.normal(0, 1, (DP_BATCH,) + _image_shape())
                       .astype(np.float32),
                       np.eye(SLICE["num_classes"], dtype=np.float32)[
                           rng.integers(0, SLICE["num_classes"], DP_BATCH)])
               for _ in range(DP_STEPS)]
    t0 = time.perf_counter()
    initialize_distributed("nccl", 0, 1, store_path=os.path.join(
        tmp.name, "nccl.store"), timeout_s=DP_GROUP_S,
        device=torch.device("cuda", 0))
    # cuDNN's deterministic algorithms for the stem convolution: its
    # default backward differs from run to run in the last bits, and the
    # wrapper's steps are held bitwise against plain fit's
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        launches = _dp_one_rank(out, card, fc, batches, fresh, per_step)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutdown_distributed()
    out["seconds"]["one_rank"] = time.perf_counter() - t0
    # the watchdog's CPU groups run beside the two ranks on the card
    t0 = time.perf_counter()
    failed = []

    def watchdog():
        try:
            _dp_watchdog(out, tmp.name)
        except BaseException as e:
            failed.append(e)
        out["seconds"]["watchdog"] = time.perf_counter() - t0
    bg = threading.Thread(target=watchdog)
    bg.start()
    try:
        for k, n in _dp_two_ranks(out, card, tmp.name, fresh,
                                  per_step).items():
            launches[k] += n
    finally:
        bg.join()
    if failed:
        raise failed[0]
    tmp.cleanup()
    out["seconds"]["phase"] = time.perf_counter() - t_phase
    out["launches"] = launches
    log(f"  data_parallel phase seconds "
        f"{ {k: round(v, 1) for k, v in out['seconds'].items()} }")
    report["data_parallel"] = out
    return launches


# ---------------------------------------------------------------------------
# phase 26: model parallelism (tensor, sequence, pipeline, expert)
# ---------------------------------------------------------------------------

MP_RANKS = 2                      # gloo ranks on the one card
MP_SEED = 26
MP_JOIN_S = 420.0                 # the group's join deadline
MP_GROUP_S = 180.0                # every collective's timeout
MP_BERT_BATCH = 32                # the BERT-base graph at 32 x 128
MP_BF16_STEPS = 4
MP_SEQ = dict(n=8, t=512, h=12, dh=64)      # BERT's max_len
MP_LM = dict(vocab=30522, width=768, heads=12, layers=12, max_len=128,
             batch=16, lr=0.1)
MP_MOE_TOKENS = 32 * 128          # the MoE stack's batch of phase 19
# f32 split against one process on the same state: the forward within
# MP_FWD_TOL of its largest entry, losses within MP_LOSS_RTOL, each
# gradient leaf within MP_GRAD_RTOL relative L2; the sequence arms'
# outputs and q/k/v gradients against flash_attention on the whole
# sequence within (out, grads) x the largest entry: f32 the same bounds,
# bf16 Y_TOL's (a bf16 ulp of the rounded output, the ring's f32 body
# against the kernel's bf16 products)
MP_FWD_TOL, MP_LOSS_RTOL, MP_GRAD_RTOL = 1e-5, 1e-5, 1e-4
MP_SEQ_TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-2, 1e-2)}


def _uncounted(fn):
    """``fn()`` with the flash kernels' launch counts left as they were:
    the one-process references are not the main path."""
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    import torch
    before = dict(fa.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    fa.LAUNCHES.update(before)
    return out


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _of_max(got, ref):
    ref = ref.float()
    return ((got.float() - ref).abs().max() / ref.abs().max().clamp_min(
        1e-30)).item()


def _mp_tp(rank, res):
    """Megatron tensor parallelism over the imported BERT-base graph with
    the fine-tune head, on {data 1, model 2}: f32 forward, loss and
    gradients against the replicated model in rank 0, then 4 bf16 fit
    steps of the split model."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.datasets.dataset import MultiDataSet
    from deeplearning4j_tpu_torch.modelimport.keras import _import_archive
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.optimize import solver
    from deeplearning4j_tpu_torch.parallel.mesh import create_mesh
    from deeplearning4j_tpu_torch.parallel.tensor_parallel import (
        gather_tree, plan_tp, shard_train_state)
    enc_model = _import_archive(keras_resource("bert_base"), "cuda")
    enc = enc_model.conf.network_outputs[0]
    vocab = enc_model.params["tok_embed"]["W"].shape[0]
    (ids, pos), (y,) = _bert_batch(np.random.default_rng(MP_SEED),
                                   MP_BERT_BATCH, BERT["seq"], vocab)
    inputs = dict(zip(enc_model.conf.network_inputs, (ids, pos)))
    m = _bert_graft(enc_model, "float32", 1e-4)
    args = ((ids, pos), (y,), None, None)

    def hidden(model):
        with torch.inference_mode():
            acts, _ = model._walk(model.params, model.model_state, inputs)
        return acts[enc]
    ref = None
    if rank == 0:
        ref = _uncounted(lambda: (hidden(m),) + solver.value_and_grad(
            m._loss, m.train_state, *args)[::2])
    mesh = create_mesh({"data": 1, "model": MP_RANKS})
    plan = plan_tp(m, mesh)
    shard_train_state(m, plan)
    heads = (m.params["l0_mha"]["Wqkv"].shape[1]
             // (3 * BERT["width"] // BERT["heads"]))
    h = hidden(m)
    before = dict(fa.LAUNCHES)
    loss, _, g = solver.value_and_grad(m._loss, m.train_state, *args)
    torch.cuda.synchronize()
    f32_launches = {k: v - before[k] for k, v in fa.LAUNCHES.items()}
    whole = gather_tree(g, plan.param_shardings, mesh)
    out = {"local_heads": heads, "f32_launches": f32_launches,
           "split_layers": sorted(plan.parts)}
    if rank == 0:
        out.update(fwd_of_max=_of_max(h, ref[0]),
                   loss_rel=_rel(loss, ref[1]),
                   grads=grad_errors(whole, ref[2]))
    del m, g, whole, ref
    # bf16 at the fine-tune's rate (benchmarks/baseline_suite.py:296-356),
    # split the same way, 4 fit steps
    data = MultiDataSet([ids, pos], [y])
    m16 = _bert_graft(enc_model, "bfloat16", 2e-5)
    del enc_model
    shard_train_state(m16, plan_tp(m16, mesh))
    per_step, losses = [], []
    for _ in range(MP_BF16_STEPS):
        before = dict(fa.LAUNCHES)
        m16.fit(data)
        torch.cuda.synchronize()
        per_step.append({k: v - before[k] for k, v in fa.LAUNCHES.items()})
        losses.append(float(m16._last_loss))
    out.update(bf16_losses=losses, bf16_launches_per_step=per_step)
    res["tp"] = out


def _mp_seq(rank, res):
    """Ring and Ulysses attention at N 8, T 512, H 12, Dh 64 over the two
    ranks, causal or with a ragged key mask, f32 and bf16: outputs and
    q/k/v gradients against flash_attention on the whole sequence."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.parallel import ring_attention as RA
    from deeplearning4j_tpu_torch.parallel.mesh import (all_gather,
                                                        create_mesh)
    mesh = create_mesh({RA.SEQ_AXIS: MP_RANKS})
    ax = mesh.axis(RA.SEQ_AXIS)
    c = MP_SEQ
    tl = c["t"] // MP_RANKS
    rows = slice(ax.index * tl, (ax.index + 1) * tl)
    arms = {}
    for dtype in ("float32", "bfloat16"):
        for fn in ("ring", "ulysses"):
            for kind in ("causal", "masked"):
                g = torch.Generator(device="cuda").manual_seed(MP_SEED)
                dt = getattr(torch, dtype)
                q, k, v = (torch.randn((c["n"], c["t"], c["h"], c["dh"]),
                                       generator=g, device="cuda").to(dt)
                           for _ in range(3))
                w = torch.randn(q.shape, generator=g, device="cuda")
                mask = None
                if kind == "masked":
                    mask = torch.from_numpy(ragged_mask(
                        c["n"], c["t"], np.random.default_rng(MP_SEED),
                        min_len=c["t"] // 4)).cuda()
                causal = kind == "causal"

                def run(q, k, v, m, f):
                    q, k, v = (a.detach().requires_grad_() for a in (q, k, v))
                    o = f(q, k, v, m)
                    (o.float() * w_of(o)).sum().backward()
                    return o.detach(), q.grad, k.grad, v.grad
                w_of = lambda o: w if o.shape[1] == c["t"] else w[:, rows]
                ref = None
                if rank == 0:
                    ref = _uncounted(lambda: run(
                        q, k, v, mask, lambda a, b, cc, m: fa.flash_attention(
                            a, b, cc, mask=m, causal=causal)))
                split = getattr(RA, f"{fn}_self_attention")
                before = dict(fa.LAUNCHES)
                t0 = time.perf_counter()
                got = run(q[:, rows], k[:, rows], v[:, rows],
                          None if mask is None else mask[:, rows],
                          lambda a, b, cc, m: split(a, b, cc, mesh, mask=m,
                                                    causal=causal))
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                made = {k_: n - before[k_] for k_, n in fa.LAUNCHES.items()}
                whole = [all_gather(t.contiguous(), 1, ax.group)
                         for t in got]
                arm = {"seconds": secs, "launches": made}
                if rank == 0:
                    arm.update(out_of_max=_of_max(whole[0], ref[0]),
                               grads_of_max=max(_of_max(a, b) for a, b in
                                                zip(whole[1:], ref[1:])))
                arms[f"{fn}_{kind}_{dtype}"] = arm
    res["seq"] = arms


def _mp_pipe(rank, res):
    """PipelinedTransformerLM at BERT-base width (12 layers, vocab 30522,
    max_len 128) over a pipe axis of 2 (R 6, circular, M 2), 16 x 128,
    f32: the loss and gradients against pipelined=False in rank 0, then
    one SGD step on both sides and the loss after it."""
    import numpy as np
    import torch
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    from deeplearning4j_tpu_torch.optimize.updaters import tree_map
    from deeplearning4j_tpu_torch.parallel.mesh import (all_gather,
                                                        create_mesh)
    from deeplearning4j_tpu_torch.parallel.pipeline import (
        PipelinedTransformerLM)
    c = MP_LM
    mesh = create_mesh({"pipe": MP_RANKS})
    # remat on, the model's default: every stage is recomputed in the
    # backward under torch.utils.checkpoint
    lm = PipelinedTransformerLM(vocab=c["vocab"], width=c["width"],
                                n_heads=c["heads"], n_layers=c["layers"],
                                max_len=c["max_len"], mesh=mesh)
    whole = lm.init(MP_SEED, device="cuda")
    rng = np.random.default_rng(MP_SEED)
    toks = torch.from_numpy(rng.integers(0, c["vocab"], (c["batch"],
                                                          c["max_len"])))
    toks = toks.cuda()
    tgts = torch.roll(toks, -1, dims=1)

    def loss_grads(p, pipelined):
        p = tree_map(lambda a: a.detach().requires_grad_(), p)
        loss = lm.loss(p, toks, tgts, pipelined=pipelined)
        loss.backward()
        return p, loss.detach(), tree_map(lambda a: a.grad, p)

    def sgd(p, g):
        return tree_map(lambda a, b: (a - c["lr"] * b).detach(), p, g)
    ref = None
    if rank == 0:
        def reference():
            p, loss, g = loss_grads(whole, False)
            with torch.no_grad():
                loss2 = lm.loss(sgd(p, g), toks, tgts, pipelined=False)
            return loss, g, loss2
        ref = _uncounted(reference)
    local = lm.shard_params(whole)
    del whole
    before = dict(fa.LAUNCHES)
    t0 = time.perf_counter()
    p, loss, g = loss_grads(local, True)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    made = {k: v - before[k] for k, v in fa.LAUNCHES.items()}
    ax = mesh.axis("pipe")
    gathered = dict(g)
    gathered["blocks"] = tree_map(lambda a: all_gather(a, 0, ax.group),
                                  g["blocks"])
    # the step after the SGD update, timed warm
    t0 = time.perf_counter()
    _, loss2, _ = loss_grads(sgd(p, g), True)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    out = {"seconds": secs, "warm_seconds": warm, "launches": made,
           "stages_on_rank": lm.repeats, "microbatches":
           lm.num_microbatches, "remat": lm.remat}
    if rank == 0:
        out.update(loss_rel=_rel(loss, ref[0]),
                   grads=grad_errors(gathered, ref[1]),
                   step_loss_rel=_rel(loss2, ref[2]),
                   losses=[float(loss), float(loss2)])
    res["pipe"] = out


def _mp_experts(rank, res):
    """The MoE stack's expert layer of phase 19 (8 experts of 3072 at
    width 768, top 2, capacity factor 1.25) on 32 x 128 tokens, 4 experts
    and half the tokens a rank: the output, aux and z losses and the
    capacity drops against the unsplit layer in rank 0."""
    import torch
    from deeplearning4j_tpu_torch.nn.inputs import RecurrentType
    from deeplearning4j_tpu_torch.nn.layers.feedforward import \
        MixtureOfExperts
    from deeplearning4j_tpu_torch.ops.activations import Activation
    from deeplearning4j_tpu_torch.parallel import moe as TM
    from deeplearning4j_tpu_torch.parallel.mesh import (all_gather,
                                                        all_reduce_,
                                                        create_mesh)
    c = LIB_MOE
    layer = MixtureOfExperts(n_out=c["width"], num_experts=c["experts"],
                             hidden=c["hidden"], top_k=c["top_k"],
                             capacity_factor=c["capacity_factor"],
                             activation=Activation.GELU)
    g = torch.Generator().manual_seed(MP_SEED)
    p = {k: v.cuda() for k, v in layer.initialize(
        g, RecurrentType(c["width"], c["seq"])).items()}
    # tokens leaning towards expert 0, so that its capacity drops some
    x = torch.randn((MP_MOE_TOKENS, c["width"]), generator=g).cuda()
    x = x + 3.0 * p["gate"][:, 0] / p["gate"][:, 0].norm()
    kw = dict(top_k=c["top_k"], capacity_factor=c["capacity_factor"],
              activation=Activation.GELU.apply)
    cap = max(1, int(c["capacity_factor"] * c["top_k"] * MP_MOE_TOKENS
                     / c["experts"]))
    slots = c["top_k"] * MP_MOE_TOKENS
    ref = None
    if rank == 0:
        with torch.no_grad():
            ref = TM.moe_ffn(x, p["gate"], p["w_in"], p["b_in"], p["w_out"],
                             p["b_out"], **kw)
    mesh = create_mesh({TM.EXPERT_AXIS: MP_RANKS})
    ax = mesh.axis(TM.EXPERT_AXIS)
    e, t = c["experts"] // MP_RANKS, MP_MOE_TOKENS // MP_RANKS
    mine = lambda a, n: a[ax.index * n:(ax.index + 1) * n]
    TM.set_default_mesh(mesh)
    try:
        with torch.no_grad():
            t0 = time.perf_counter()
            out = TM.moe_ffn(mine(x, t), p["gate"], mine(p["w_in"], e),
                             mine(p["b_in"], e), mine(p["w_out"], e),
                             mine(p["b_out"], e), **kw)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
    finally:
        TM.set_default_mesh(None)
    y = all_gather(out.y.contiguous(), 0, ax.group)
    # the slots the split layer's own dispatch filled, over both ranks
    dispatched = all_reduce_(out.dispatched.reshape(1).clone(),
                             group=ax.group)
    res_e = {"seconds": secs, "experts_on_rank": e, "capacity": cap,
             "dropped": slots - round(dispatched.item())}
    if rank == 0:
        res_e.update(y_of_max=_of_max(y, ref.y),
                     aux_rel=_rel(out.aux_loss, ref.aux_loss),
                     z_rel=_rel(out.router_z_loss, ref.router_z_loss),
                     ref_dropped=slots - round(ref.dispatched.item()))
    res["experts"] = res_e


def mp_rank(rank, world, out_dir):
    """One rank of the two on the card (gloo): every arm in turn (tensor,
    sequence, pipeline, expert parallelism), each rank's flash launches
    counted from zero; rank 0 also takes the one-process references."""
    import torch
    from deeplearning4j_tpu_torch.ops import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"seconds": {}}
    # torch.utils.checkpoint imports torch._dynamo at its first call: a
    # one-time cost, taken here and not in the pipeline arm's timed step
    t0 = time.perf_counter()
    import torch._dynamo  # noqa: F401
    res["seconds"]["imports"] = time.perf_counter() - t0
    fa.reset_launch_counts()
    for name, arm in (("tp", _mp_tp), ("seq", _mp_seq), ("pipe", _mp_pipe),
                      ("experts", _mp_experts)):
        t0 = time.perf_counter()
        arm(rank, res)
        torch.cuda.empty_cache()
        res["seconds"][name] = time.perf_counter() - t0
    torch.cuda.synchronize()
    res["launches"] = dict(fa.LAUNCHES)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _mp_gates(r0, ranks):
    """The phase's failures, as messages (empty when every arm passes)."""
    bad = []
    tp = r0["tp"]
    want = {k: BERT["blocks"] for k in ATTN_KERNELS}
    if tp["fwd_of_max"] > MP_FWD_TOL or tp["loss_rel"] > MP_LOSS_RTOL or \
            tp["grads"]["worst"] > MP_GRAD_RTOL:
        bad.append(f"tensor parallel f32 against the replicated model: "
                   f"forward {tp['fwd_of_max']:.3g}, loss "
                   f"{tp['loss_rel']:.3g}, worst gradient "
                   f"{tp['grads']['worst']:.3g} ({tp['grads']['name']})")
    for r, rk in enumerate(ranks):
        t = rk["tp"]
        if t["local_heads"] != BERT["heads"] // MP_RANKS or \
                t["f32_launches"] != want or \
                any(s != want for s in t["bf16_launches_per_step"]) or \
                not all(math.isfinite(v) for v in t["bf16_losses"]):
            bad.append(f"rank {r}: {t['local_heads']} heads, f32 launches "
                       f"{t['f32_launches']}, bf16 a step "
                       f"{t['bf16_launches_per_step']}, losses "
                       f"{t['bf16_losses']} (want {want} on "
                       f"{BERT['heads'] // MP_RANKS} heads, finite)")
        for name, arm in rk["seq"].items():
            if name.startswith("ulysses") and (
                    arm["launches"]["flash_fwd"] < 1
                    or arm["launches"]["flash_bwd_dq"] < 1):
                bad.append(f"rank {r}: {name} launched {arm['launches']}")
        # each of a rank's R stages a microbatch: one causal block, its
        # forward recomputed in the backward under remat
        pp = rk["pipe"]
        apps = pp["stages_on_rank"] * pp["microbatches"]
        want_pp = {"flash_fwd": 2 * apps, "flash_bwd_dkv": apps,
                   "flash_bwd_dq": apps}
        if not pp["remat"] or pp["launches"] != want_pp:
            bad.append(f"rank {r}: the pipeline (remat {pp['remat']}) "
                       f"launched {pp['launches']}, want {want_pp} with "
                       "remat")
    for name, arm in r0["seq"].items():
        fo, fg = MP_SEQ_TOL[name.rsplit("_", 1)[1]]
        if arm["out_of_max"] > fo or arm["grads_of_max"] > fg:
            bad.append(f"{name}: output {arm['out_of_max']:.3g} (bound "
                       f"{fo}), gradients {arm['grads_of_max']:.3g} "
                       f"(bound {fg}) of the largest entry")
    pp = r0["pipe"]
    if pp["loss_rel"] > MP_LOSS_RTOL or pp["step_loss_rel"] > MP_LOSS_RTOL \
            or pp["grads"]["worst"] > MP_GRAD_RTOL:
        bad.append(f"pipeline against pipelined=False: loss "
                   f"{pp['loss_rel']:.3g}, after a step "
                   f"{pp['step_loss_rel']:.3g}, worst gradient "
                   f"{pp['grads']['worst']:.3g} ({pp['grads']['name']})")
    ex = r0["experts"]
    if ex["y_of_max"] > MP_FWD_TOL or ex["aux_rel"] > MP_LOSS_RTOL or \
            ex["z_rel"] > MP_LOSS_RTOL or ex["ref_dropped"] <= 0 or \
            ex["dropped"] != ex["ref_dropped"]:
        bad.append(f"experts against the unsplit layer: output "
                   f"{ex['y_of_max']:.3g}, aux {ex['aux_rel']:.3g}, z "
                   f"{ex['z_rel']:.3g}, dropped {ex['dropped']} vs "
                   f"{ex['ref_dropped']}")
    return bad


def phase_model_parallel(report, card):
    """Model parallelism on the card (module docstring, phase 26): one
    group of two gloo ranks runs every arm. Returns the ranks' flash
    launches (the main path)."""
    import tempfile

    from deeplearning4j_tpu_torch.ops import cuda_build
    from deeplearning4j_tpu_torch.parallel.launch import spawn_ranks
    t_phase = time.perf_counter()
    # the ranks load these libraries and never compile one themselves
    cuda_build.build()
    tmp = tempfile.TemporaryDirectory(prefix="model_parallel_")
    codes = spawn_ranks(mp_rank, MP_RANKS, (tmp.name,), run_dir=tmp.name,
                        backend="gloo", timeout_s=MP_JOIN_S,
                        group_timeout_s=MP_GROUP_S, name="mp")
    if codes != [0] * MP_RANKS:
        raise AssertionError(f"the model-parallel group exited {codes}")
    ranks = [json.load(open(os.path.join(tmp.name, f"rank{r}.json")))
             for r in range(MP_RANKS)]
    tmp.cleanup()
    r0 = ranks[0]
    tp, pp, ex = r0["tp"], r0["pipe"], r0["experts"]
    log(f"  tensor parallel, BERT-base graph + fine-tune head at "
        f"{MP_BERT_BATCH} x {BERT['seq']} on {{data 1, model {MP_RANKS}}}: "
        f"{tp['local_heads']} heads a rank; f32 against the replicated "
        f"model: forward {tp['fwd_of_max']:.3g} of the largest entry, loss "
        f"{tp['loss_rel']:.3g}, gradients rel L2 worst "
        f"{tp['grads']['worst']:.3g} ({tp['grads']['name']}), all "
        f"{tp['grads']['all']:.3g}; launches of the f32 step "
        f"{tp['f32_launches']}; bf16 losses "
        f"{' '.join(f'{v:.4f}' for v in tp['bf16_losses'])}, "
        f"launches a step {tp['bf16_launches_per_step'][-1]} [{card}]")
    for name, arm in r0["seq"].items():
        log(f"  {name} at {MP_SEQ}: output {arm['out_of_max']:.3g}, "
            f"q/k/v gradients {arm['grads_of_max']:.3g} of the largest "
            f"entry against flash_attention on the whole sequence; "
            f"{arm['seconds'] * 1e3:.1f} ms forward + backward, launches "
            f"{ {k: v for k, v in arm['launches'].items() if v} }")
    log(f"  pipeline, LM {MP_LM} over pipe {MP_RANKS} (R {pp['stages_on_rank']}"
        f", M {pp['microbatches']}): loss {pp['loss_rel']:.3g}, gradients "
        f"rel L2 worst {pp['grads']['worst']:.3g} ({pp['grads']['name']}), "
        f"after one SGD step {pp['step_loss_rel']:.3g} (losses "
        f"{pp['losses']}); forward + backward {pp['seconds']:.2f} s cold, "
        f"{pp['warm_seconds']:.3f} s warm; launches of a step "
        f"{pp['launches']}")
    log(f"  experts, 8 of 3072 at 768 over {MP_RANKS} ranks "
        f"({ex['experts_on_rank']} each), {MP_MOE_TOKENS} tokens: output "
        f"{ex['y_of_max']:.3g} of the largest entry, aux {ex['aux_rel']:.3g}"
        f", z {ex['z_rel']:.3g}, dropped {ex['dropped']} (unsplit "
        f"{ex['ref_dropped']}) at capacity {ex['capacity']}; "
        f"{ex['seconds'] * 1e3:.1f} ms")
    for r, rk in enumerate(ranks):
        log(f"  rank {r}: arm seconds "
            f"{ {k: round(v, 1) for k, v in rk['seconds'].items()} }, "
            f"flash launches {rk['launches']}")
    bad = _mp_gates(r0, ranks)
    report["model_parallel"] = {"card": card, "ranks": ranks,
                                "seconds": time.perf_counter() - t_phase}
    if bad:
        raise AssertionError("; ".join(bad))
    launches = {}
    for rk in ranks:
        for k, v in rk["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return launches


def main(argv=None) -> int:
    global _RUN_LOG
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="env,build,kernels,slice,train,"
                    "lstm_serve,lstm_train,bert_serve,bert_train,"
                    "digits_eval,digits_train,generate,serve_http,"
                    "rnn_tbptt,zoo,keras_import,observed_fit,quant_serve,"
                    "model_library,cluster,neighbors,embeddings,online,"
                    "aot_cache,data_parallel,model_parallel",
                    help="comma-separated subset of the phases to run")
    ap.add_argument("--profile", action="store_true",
                    help="also trace the served forward, the train steps, "
                    "a full-slot generation run and a TBPTT batch with "
                    "torch.profiler")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    # the port itself (fails in a directory without the repository)
    from deeplearning4j_tpu_torch.ops import cuda_build

    # every run keeps its own log and report
    run_dir = os.path.join("chiprun_out", time.strftime(
        "%Y%m%dT%H%M%SZ", time.gmtime()) + f"-{os.getpid()}")
    os.makedirs(run_dir, exist_ok=True)
    _RUN_LOG = open(os.path.join(run_dir, "chip_smoke.log"), "w")
    report = {"run_dir": run_dir, "phases": sorted(phases),
              "phase_seconds": {}}
    log(f"[run] log and report in {run_dir}")

    def phase(name, fn):
        """``fn()``, its seconds recorded; a failure is named with its
        phase and its traceback, then raised again."""
        t0 = time.perf_counter()
        try:
            result = fn()
        except BaseException as e:
            log(f"[fail] phase={name}: {type(e).__name__}: {e}")
            log(traceback.format_exc().rstrip())
            raise
        report["phase_seconds"][name] = time.perf_counter() - t0
        log(f"[{name}] {report['phase_seconds'][name]:.1f}s")
        return result

    try:
        return _run(args, phases, report, phase, torch, cuda_build)
    finally:
        with open(os.path.join(run_dir, "chip_smoke.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
        _RUN_LOG.close()
        _RUN_LOG = None


def _run(args, phases, report, phase, torch, cuda_build) -> int:
    card = card_line()

    def env():
        log(f"[env] {card}; torch {torch.__version__}, CUDA "
            f"{torch.version.cuda}, {torch.cuda.get_device_name(0)} x"
            f"{torch.cuda.device_count()}")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        report["card"] = card
    phase("env", env)

    if "build" in phases:
        def build():
            t0 = time.perf_counter()
            cuda_build.build()
            report["build_seconds"] = time.perf_counter() - t0
            log(f"[build] {report['build_seconds']:.1f}s")
            report["ptxas"] = {}
            for name, (sec, text) in cuda_build.build_log.items():
                report["ptxas"][name] = ptxas_report(text)
                for fn, regs, spills in report["ptxas"][name]:
                    log(f"  {name}: {fn[:60]} registers={regs} "
                        f"spills={spills}")
            report["hmma"] = hmma_counts(cuda_build, MMA_SOURCES)
        phase("build", build)

    summary = {}
    if "kernels" in phases:
        def kernels():
            log("[kernels] every path shape at batch 32, f32 and bf16")
            summary.update(phase_kernels(report))
            log("[kernels] lstm_fwd and lstm_bwd at (T, N, H) = "
                f"{list(LSTM_SHAPES.values())}, f32 and bf16, masked or not")
            rows = phase_lstm_kernels(torch.Generator(device="cuda")
                                      .manual_seed(0))
            report["lstm_kernel_calls"] = rows
            if not all(r["ok"] and r["bitwise_repeat"] for r in rows):
                raise AssertionError("an LSTM kernel disagrees with its "
                                     "plain version or differs between two "
                                     "runs")
            for name in ("lstm_fwd", "lstm_bwd"):
                summary[name] = _lstm_summary(name, rows)
            log("[kernels] flash_fwd, flash_bwd_dkv and flash_bwd_dq at "
                f"(N, T, H, Dh) = {ATTN_SLICE} (f32 and bf16; unmasked, "
                f"ragged key mask, causal), (N, T) = {list(ATTN_LONG)} bf16 "
                f"causal or not, {ATTN_EDGE} f32 and bf16 causal with masked "
                f"rows, batch {BERT_TRAIN_BATCH} bf16 unmasked (bert_train's "
                f"calls), {ATTN_KERAS} f32 and bf16 (the imported Keras "
                f"attention fixture) and batch {KERAS_BERT_FT_BATCH} bf16 "
                "(the imported BERT fine-tune)")
            rows = phase_attn_kernels(torch.Generator(device="cuda")
                                      .manual_seed(0))
            report["attn_kernel_calls"] = rows
            if not all(r["ok"] and r["bitwise_repeat"] for r in rows):
                raise AssertionError("a flash kernel disagrees with its "
                                     "plain version or differs between two "
                                     "runs")
            for name in ATTN_KERNELS:
                summary[name] = _attn_summary(name, rows)
        phase("kernels", kernels)

    launches = {name: 0 for name in SOURCES}

    def run(name, note, fn):
        if name in phases:
            log(f"[{name}] {note}")
            for k, n in (phase(name, fn) or {}).items():
                launches[k] += n

    run("slice", "ResNet50 64x64x3/200 bf16 served through ServingEngine",
        lambda: phase_slice(report, card, args.profile))
    run("train", f"ResNet50 64x64x3/200 bf16, batch {TRAIN_BATCH}, "
        f"K={TRAIN_K} steps per call",
        lambda: phase_train(report, card, args.profile))
    run("lstm_serve", f"pretrained TextGenerationLSTM f32: output() on "
        f"{LSTM_SERVE_WINDOWS} windows of 60, {GEN_CHARS} greedy chars",
        lambda: phase_lstm_serve(report, card, args.profile))
    run("lstm_train", f"TextGenerationLSTM f32, batch {LSTM_TRAIN_BATCH} x "
        f"60, Adam(2e-3) + clip 5, K={LSTM_TRAIN_K} steps per call",
        lambda: phase_lstm_train(report, card, args.profile))
    bert = (f"{BERT['blocks']} x {BERT['width']}/{BERT['heads']} heads, "
            f"vocab {BERT['vocab']}, seq {BERT['seq']}")
    run("bert_serve", f"BERT-base geometry ({bert}) bf16: output() on "
        f"{BERT_SERVE_BATCH} x {BERT['seq']} ids",
        lambda: phase_bert_serve(report, card, args.profile))
    run("bert_train", f"BERT-base geometry ({bert}) bf16, Adam(1e-4), batch "
        f"{BERT_TRAIN_BATCH} x {BERT['seq']}, K={BERT_TRAIN_K} steps per "
        "call", lambda: phase_bert_train(report, card, args.profile))
    # the digits slice runs no kernel of SOURCES (plain torch convolutions)
    run("digits_eval", "pretrained LeNet and SimpleCNN on the held-out UCI "
        "digits, card against CPU", lambda: phase_digits_eval(report, card))
    run("digits_train", f"LeNet f32 Adam(1e-3) from scratch, "
        f"fit(DigitsDataSetIterator({DIGITS_BATCH}), "
        f"epochs={DIGITS_EPOCHS}); updaters; SimpleCNN two epochs",
        lambda: phase_digits_train(report, card, args.profile))
    # the generation engine runs no kernel of SOURCES (plain torch ticks)
    run("generate", f"GenerationEngine over the pretrained "
        f"TextGenerationLSTM f32, {GEN_SLOTS} slots: {GEN_STREAMS} "
        f"staggered greedy streams of {GEN_NEW} tokens, bucket invariance, "
        "chunked/speculative/session modes, int8 and bf16 heads",
        lambda: phase_generate(report, card, args.profile))
    run("serve_http", "python -m deeplearning4j_tpu_torch serve: the "
        "ResNet50 zip (bf16) over /api/predict and the fleet front door, "
        "the TextGenerationLSTM zip's predict and SSE generation, the entry "
        "point in a subprocess", lambda: phase_serve_http(report, card))
    run("rnn_tbptt", f"TextGenerationLSTM f32 by TBPTT ({TBPTT_BATCHES} "
        f"batches of {TBPTT_BATCH} x {TBPTT_CHARS} chars, segments of "
        f"{TBPTT_K}, one of {TBPTT_RAGGED}), the chain against the plain "
        f"path, streaming; the recurrent layers at width {FAMILY_H}; the "
        "streaming graph; Graves generation",
        lambda: phase_rnn_tbptt(report, card, args.profile))
    # the model library runs no kernel of SOURCES on its main path (its
    # xla-vs-pallas gradient check launches kernels 1-6 to compare them)
    run("zoo", "the bench ResNet50 (64x64x3/200 bf16) fused_impl=\"xla\" "
        "and unfused beside pallas; the Gram rule; VGG16 train + serve; "
        "YOLO2 416x416; the rest of the zoo card vs CPU; LeNet transfer",
        lambda: phase_zoo(report, card))
    run("keras_import", "the 14 Keras fixtures, the imported BERT-base "
        "(f32 against Keras, bf16 output, the bf16 fine-tune with the "
        "shadow cast, the frozen encoder) and InceptionV3 at 299 (against "
        "Keras, inference, the fine-tune) from committed configurations; "
        "constraints, weight noise, LBFGS and CG",
        lambda: phase_keras_import(report, card))
    run("observed_fit", "the observed training loop: ResNet50 64x64x3/200 "
        f"bf16 through EarlyStoppingTrainer -> fit(iterator, k_steps="
        f"{OBS_K}) with telemetry, listeners, StatsListener, a tracer and a "
        "flight recorder; NaN and OOM dumps; observers on/off times; traced "
        "serving; TBPTT and BERT fits with telemetry; CSV records into "
        "LeNet", lambda: phase_observed_fit(report, card))
    run("quant_serve", "int8 serving: int8_conv and int8_dot against int64 "
        f"products; the committed LeNet behind an int8 ServingEngine at "
        f"{QUANT_BATCH} (the gate, calibration hashes, against f32); the "
        "TextGenerationLSTM with an int8 head and f32 LSTMs (lstm_fwd); the "
        "fleet's int8 pool behind its gate",
        lambda: phase_quant_serve(report, card))
    run("model_library", "the VAE and AutoEncoder pretrained on the "
        "digits; the MoE sequence stack (2 x 768/12 blocks, 8 experts) bf16 "
        f"at {LIB_MOE_BATCH} x {LIB_MOE['seq']} with a padding mask; custom "
        "layers; the f64 gradient check; memory reports; k-means and t-SNE "
        "of the digits; TsneListener",
        lambda: phase_model_library(report, card))
    run("cluster", "ResNet50 64x64x3/200 bf16 on two ServingNodes behind a "
        f"RemoteDispatcher over HTTP ({CLUSTER_CLIENTS * CLUSTER_PER_CLIENT} "
        "requests of 1-32 images, a drain), the AutoScaler, then a serve "
        "--join subprocess: cold start, SIGKILL, rejoin, SIGTERM",
        lambda: phase_cluster(report, card))
    # retrieval runs no kernel of SOURCES (a matmul and a top-k)
    run("neighbors", f"{NN['vectors']} x {NN['dim']} blob corpus, shards "
        f"of {NN['shard_rows']}, IVF {NN['clusters']} / nprobe "
        f"{NN['nprobe']}, f32 and int8, batch {NN['batch']} at k "
        f"{NN['k']}; the JAX-saved index card vs CPU; RetrievalNodes, the "
        "NeighborsDispatcher and a serve --neighbors-index --join "
        "subprocess", lambda: phase_neighbors(report, card))
    # the embedding tier runs no kernel of SOURCES (its steps are plain
    # torch, as the JAX package leaves them to XLA)
    run("embeddings", f"Word2Vec {EMB['tokens']} zipf tokens over "
        f"{EMB['vocab']} words, layer {EMB['layer']}, window "
        f"{EMB['window']}, batch {EMB['batch']}: {', '.join(EMB_ARMS)}; "
        "planted topics; ParagraphVectors DBOW/DM; GloVe; DeepWalk and "
        "Node2Vec; save/restore. No launch of the eleven kernels",
        lambda: phase_embeddings(report, card))
    run("online", "online learning on the ResNet50 64x64x3/200 bf16: "
        f"OnlineServing over a TCP broker, batch {ONLINE_BATCH}, the learner "
        "(kernels 1-6) training while the pool (1-2) serves; a good "
        "promotion, a degraded one rolled back, serve --online in a "
        "subprocess, ConvolutionalListener on LeNet",
        lambda: phase_online(report, card))
    # the cache's kernels launch in its subprocesses, outside the counters
    run("aot_cache", "the persisted kernel cache: cold and warm processes "
        "on the ResNet50 engine (a serve --join node warm from the store), "
        "another feature shape, a corrupted blob",
        lambda: phase_aot_cache(report, card))
    run("data_parallel", "ParallelWrapper over the ResNet50 64x64x3/200: "
        f"one NCCL rank in process (SHARED_GRADIENTS, AVERAGING, "
        f"ASYNC_ELASTIC against plain fit, bf16), {DP_RANKS} gloo ranks on "
        f"the card (f32, {DP_RANKS} x {DP_ROWS} rows) and a sharded "
        "checkpoint, the collective watchdog in subprocesses",
        lambda: phase_data_parallel(report, card))
    run("model_parallel", f"tensor parallelism over the BERT-base graph "
        f"({MP_BERT_BATCH} x {BERT['seq']}, f32 and bf16), ring and Ulysses "
        f"attention at {MP_SEQ}, the pipelined LM ({MP_LM['layers']} x "
        f"{MP_LM['width']}, vocab {MP_LM['vocab']}) and the expert layer, "
        f"{MP_RANKS} gloo ranks on the card",
        lambda: phase_model_parallel(report, card))
    total = sum(report["phase_seconds"].values())
    log(f"[total] phases {total:.1f}s, script wall "
        f"{time.perf_counter() - _T_START:.1f}s")

    kernels = []
    for name, k in summary.items():
        entry = {key: k[key] for key in
                 ("name", "route", "source", "replaces")}
        # the main paths' launches: served traffic (in-process and over
        # HTTP) and the K-step train call (conv kernels); scoring,
        # generation, HTTP predict, the K-step train call, the TBPTT
        # batches, the streamed rnn_time_step calls, the TBPTT graph, the
        # imported LSTM fixtures and the constrained and noisy
        # TextGenerationLSTM steps (LSTM kernels); two output() calls, the
        # K-step train call, the imported BERT-base's output, fine-tune
        # and frozen-encoder calls and the Keras attention fixture (flash
        # kernels); and the observed fits' K-step calls (conv and flash
        # kernels), TBPTT batches (LSTM kernels) and traced serving; the
        # int8 TextGenerationLSTM's engine start (calibration, probe and
        # warmup), served calls and gate (lstm_fwd); the MoE stack's train
        # steps (flash kernels); the two in-process cluster nodes' batches
        # behind the RemoteDispatcher (conv kernels); the data-parallel
        # wrapper's steps in this process and in its two ranks (conv
        # kernels); the model-parallel ranks' split BERT steps, Ulysses
        # calls and pipeline stages (flash kernels)
        entry["launches"] = launches[name]
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms"):
            entry[key] = k[key]
        kernels.append(entry)
    report["kernels_line"] = kernels
    print(json.dumps({"kernels": kernels}))
    print(card)
    if _RUN_LOG is not None:
        _RUN_LOG.write(json.dumps({"kernels": kernels}) + f"\n{card}\n")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
