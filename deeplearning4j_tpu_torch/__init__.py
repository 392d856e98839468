"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of deeplearning4j_tpu.

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
clipping.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise rather than carry on on the CPU.
"""

__version__ = "0.1.0"
