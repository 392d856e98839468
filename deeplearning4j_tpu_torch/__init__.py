"""deeplearning4j_tpu_torch — the PyTorch/CUDA port of deeplearning4j_tpu.

The JAX package (``deeplearning4j_tpu``) stays the reference; this package
mirrors its layout and names module for module, imports only ``torch``
and numpy, and runs its kernels as hand-written CUDA C++ for the H100
(``csrc/``, sm_90a, built with ``nvcc`` at first use).

What is ported so far is the serving path of the fused-block ResNet50:
``zoo.models.ResNet50(fused_blocks=True)`` → ``models.ComputationGraph``
→ ``nn.layers.fused.FusedBottleneckBlock`` → ``ops.fused_conv``
(kernels ``fused_mm`` and ``fused_c3``), served by
``parallel.serving.ServingEngine``; checkpoints are the JAX package's
zip format (``models.serialization``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise rather than carry on on the CPU.
"""

__version__ = "0.1.0"
