"""Generative serving: continuous-batching autoregressive decode.

The port of the JAX package's ``generation/``. A single-tick step
advances every slot of a fixed-size batch by one token; the (h, c) LSTM
carry and the per-slot sampling keys stay device-resident across ticks,
sequences join and leave the batch mid-flight, and the sampled tokens
stream back as they decode.

v2 serving modes (opt-in per engine): chunked prefill (one prefill
dispatch per prompt chunk instead of one tick per char), resumable
sessions (retired carries pinned device-side, LRU-tiered to host,
checkpointed into the shared ArtifactStore for cross-node resume), and
speculative decode (n-gram draft + one-dispatch batched verify,
bitwise-equal to plain decode under counter-based splitmix64 sampling
keys).

- ``decode.py``      pure tick/prefill builders, vocab, reference decode
- ``engine.py``      GenerationEngine: slots, scheduler, warmup sweep
- ``session.py``     SessionStore: tiered resumable carries
- ``speculative.py`` NGramDraft + the batched verify step
"""

from deeplearning4j_tpu_torch.generation.decode import (
    DecodeSpec, Vocab, extract_decode_spec, head_bytes_per_token,
    prefill_chunk_ladder, reference_decode)
from deeplearning4j_tpu_torch.generation.engine import (
    GenerationEngine, GenerationStream)
from deeplearning4j_tpu_torch.generation.session import (
    CarrySnapshot, SessionStore)
from deeplearning4j_tpu_torch.generation.speculative import (
    NGramDraft, counter_keys)

__all__ = ["DecodeSpec", "Vocab", "extract_decode_spec",
           "head_bytes_per_token", "prefill_chunk_ladder",
           "reference_decode", "GenerationEngine", "GenerationStream",
           "CarrySnapshot", "SessionStore", "NGramDraft",
           "counter_keys"]
