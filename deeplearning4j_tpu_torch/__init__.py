"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of ``deeplearning4j_tpu``.

The JAX package (``deeplearning4j_tpu``) stays the reference; this package
mirrors its layout and names module for module, imports only ``torch``
and numpy, and runs its kernels as hand-written CUDA C++ for the H100
(``csrc/``, sm_90a, built with ``nvcc`` at first use).

What is ported so far is the serving and the training path of the
fused-block ResNet50: ``zoo.models.ResNet50(fused_blocks=True)`` →
``models.ComputationGraph`` → ``nn.layers.fused.FusedBottleneckBlock`` →
``ops.fused_conv`` (forward kernels ``fused_mm`` and ``fused_c3``;
backward kernels ``fused_mm_bwd``, ``fused_c3_bwd``, ``fused_c3_bwd_in``
and ``fused_c3_bwd_w``), served by ``parallel.serving.ServingEngine`` and
trained by ``ComputationGraph.fit`` / ``optimize.solver``; checkpoints
(with optimizer state) are the JAX package's zip format
(``models.serialization``). The char-level ``zoo.models.TextGenerationLSTM``
→ ``models.MultiLayerNetwork`` → ``nn.layers.recurrent.LSTM`` →
``ops.fused_lstm`` (kernels ``lstm_fwd`` and ``lstm_bwd``) scores
(``output``), generates greedily (``rnn_time_step``,
``generation.decode.reference_decode``) and trains with Adam and value
clipping; ``generation.GenerationEngine`` serves it by continuous-
batching decode (chunked prefill, speculative decode, resumable
sessions, an f32/bf16/int8 head). ``python -m deeplearning4j_tpu_torch
serve`` starts them as a user does: a saved zip behind the HTTP server
(``ui/``: ``/api/predict``, ``/api/generate`` as SSE, ``/metrics``,
``/healthz``), through ``parallel.inference.ParallelInference`` or the
fleet front door (``parallel.fleet.FleetRouter``). Recurrent models
(``nn.layers.recurrent``: LSTM, GravesLSTM, SimpleRnn, the bidirectional
and wrapper layers) train by truncated BPTT on both model types, the
LSTM segments through the same two kernels, and a ``ComputationGraph``
streams them with stored state (``rnn_time_step``). ``modelimport``
imports Keras models (``.h5``, ``.keras``) onto the card, where an
imported attention runs the flash kernels and an imported LSTM the LSTM
kernels. ``fit`` is observed as in the JAX package: listeners
(``optimize.listeners``, ``ui.StatsListener``), in-step telemetry in a
ring on the card, a span tracer and a flight recorder (``observe``);
``earlystopping`` trains through it, and ``datasets.records`` feeds it
from CSV and in-memory records.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise rather than carry on on the CPU.
"""

__version__ = "0.1.0"
