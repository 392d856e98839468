#!/usr/bin/env python3
"""CPU rehearsals of ``chip_smoke.py``'s ``generate`` and ``serve_http``
phases, and the op count of one decode tick. It runs against the tree in
the working directory (so one copy measures a parent tree and its change
alike); run it from a tree's root on any machine:

    python3 tools/gen_rehearsal.py rehearse [NEW_TOKENS]   # default 32
    python3 tools/gen_rehearsal.py serve
    python3 tools/gen_rehearsal.py ops
    python3 tools/gen_rehearsal.py rnn
    python3 tools/gen_rehearsal.py zoo
    python3 tools/gen_rehearsal.py keras
    python3 tools/gen_rehearsal.py observed
    python3 tools/gen_rehearsal.py cluster
    python3 tools/gen_rehearsal.py neighbors
    python3 tools/gen_rehearsal.py embeddings [ARM ...]
    python3 tools/gen_rehearsal.py online
    python3 tools/gen_rehearsal.py aot
    python3 tools/gen_rehearsal.py data_parallel
    python3 tools/gen_rehearsal.py model_parallel

``rehearse`` runs ``phase_generate`` end to end on the CPU with the
committed model: chip_smoke's source is executed with its ``"cuda"``
device strings turned to ``"cpu"`` and ``torch.cuda.synchronize()``
removed, ``resolve_device`` is pinned to the CPU in the modules that call
it, and ``GEN_NEW`` is lowered. Every check of the phase runs; its
times are CPU times, which say nothing about the card.

``serve`` runs ``phase_serve_http`` the same way (about 60 s): every
``serve`` gets ``--device cpu`` (in process and in its subprocess), the
ResNet50 is cut to 32×32 with 10 classes, one client sends 4 requests,
and the wrappers of ``fused_mm``, ``fused_c3`` and ``lstm_fwd`` count a
launch for each plain call, so the launch gates run too.

``rnn`` runs ``phase_rnn_tbptt`` the same way at a cut size (batches
of 4 windows of 200 chars, 3 of them, width 32 for the layer family,
short Graves streams), with ``lstm_fwd`` and ``lstm_bwd`` counting a
launch for each plain call and the card's memory counters stubbed, so
every gate of the phase runs.

``zoo`` runs ``phase_zoo`` the same way at a cut size (the bench
ResNet50 and VGG16 at 32×32 in f32, batch 8, K = 2; YOLO2 and the rest of
the zoo at 64×64; one transfer epoch), with CUDA events timed by the host
clock and the six conv wrappers counting a launch for each plain call,
so every gate of the phase runs; its times say nothing about the
card.

``keras`` runs ``phase_keras_import`` the same way (every ``"cuda"``
turned to ``"cpu"``) on the committed fixtures and on BERT and
InceptionV3 resources that ``tools/keras_card_resources.py`` writes into
a temporary directory at a cut size (BERT 2 x 32 with 4 heads and a
vocabulary of 64 at seq 128; InceptionV3 at 75×75×3), with cut batches,
the flash and LSTM wrappers counting a launch for each plain call, so
every gate of the phase runs. It needs keras and h5py.

``observed`` runs ``phase_observed_fit`` the same way (every ``"cuda"``
turned to ``"cpu"``) at a cut size (the ResNet50 at 32×32×3 with 10
classes in f32, batch 8; BERT 2 x 32 with 4 heads, a vocabulary of 64 at
seq 16, batch 2; TBPTT batches of 4 x 200 chars; 4 served requests),
with the conv, LSTM and flash wrappers counting a launch for each plain
call. What exists only on the card is stubbed: sync debug mode is a
no-op, ``mem_get_info`` raises the OOM the phase provokes, the dump's
memory section gets a device entry, and the profiler's hand-written
kernel count is a constant. Every other gate of the phase runs.

``cluster`` runs ``phase_cluster`` the same way (every ``"cuda"``
turned to ``"cpu"``, every ``serve`` subprocess given ``--device cpu``)
with the ResNet50 cut to 32×32 with 10 classes, 2 clients x 12 requests
and 12 through the subprocess, and ``fused_mm``/``fused_c3`` counting a
launch for each plain call, so every gate of the phase runs.

``neighbors`` runs ``phase_neighbors`` the same way with the corpus cut
to 20000 x 64 (shards of 8192, 32 clusters, nprobe 8, batch 16), so
every gate of the phase runs.

``embeddings`` runs ``phase_embeddings`` the same way (every ``"cuda"``
turned to ``"cpu"``) at a cut size (60k tokens over 2000 words, layer
32, batch 4096; 4 planted topics; 400 ParagraphVectors documents; two
communities of 300 vertices), with the card's memory counters and sync
debug mode stubbed, so every other gate of the phase runs (naming arms,
e.g. ``sgns``, runs only those Word2Vec arms); its times say nothing
about the card.

``online`` runs ``phase_online`` the same way (every ``"cuda"`` turned
to ``"cpu"``, the ``serve --online`` subprocess given ``--device cpu``)
with the ResNet50 cut to 32×32 with 10 classes and the six conv
wrappers counting a launch for each plain call, so every gate of the
phase runs.

``aot`` runs ``phase_aot_cache`` the same way with the ResNet50 cut
likewise. The CPU's forward reaches no kernel library, so each cache
subprocess's code gets a prelude that has its warmup reach
``fused_mm`` and ``fused_c3`` and "build" a stand-in library for each
(bytes, and an entry in ``build_log``) where none exists: the cache's
save, restore, mismatch and quarantine gates then run as on the card.

``data_parallel`` runs ``phase_data_parallel``: its ranks are spawned
processes, so the rewritten source goes to ``build/rehearsal/
dp_rehearsal.py`` for them to import, with "nccl" turned to "gloo" and
the six conv wrappers counting in every process; the ResNet50 is cut to
32x32 with 10 classes and 8 rows a step (16 over the two ranks).

``model_parallel`` runs ``phase_model_parallel`` the same way
(``build/rehearsal/mp_rehearsal.py``; the flash wrappers count a launch
for each plain call) at cut sizes: the BERT-base graph at 2 x 128, the
sequence arms at T 64, the LM at 4 layers and 2 x 16 tokens, the expert
layer on 256 tokens.

``ops`` counts the top-level torch ops of one f32 tick at 8 slots
(``torch.profiler`` on the CPU): the host's work a tick, which on the card
is one launch or more per op.
"""

from __future__ import annotations

import collections
import sys
import time
import types
from pathlib import Path

import torch

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))


def _cpu_resolve(device=None):
    return torch.device("cpu")


def _cpu_smoke(mode="device"):
    """chip_smoke.py executed with its card pinned to the CPU; with
    ``mode="cpu_all"`` every ``"cuda"`` string and ``.cuda()`` too."""
    from deeplearning4j_tpu_torch.generation import engine, session
    from deeplearning4j_tpu_torch.models import (computation_graph,
                                                 multi_layer_network,
                                                 serialization)
    from deeplearning4j_tpu_torch.utils import device
    for mod in (device, computation_graph, multi_layer_network,
                serialization, session, engine):
        mod.resolve_device = _cpu_resolve
    src = (ROOT / "chip_smoke.py").read_text()
    src = src.replace('device="cuda"', 'device="cpu"').replace(
        "torch.cuda.synchronize()", "None").replace(
        'dev != "cuda:0"', 'dev != "cpu"')
    if mode == "cpu_all":
        src = src.replace('"cuda"', '"cpu"').replace(".cuda()", ".cpu()")
    smoke = types.ModuleType("chip_smoke_cpu")
    smoke.__file__ = str(ROOT / "chip_smoke.py")
    exec(compile(src, "chip_smoke_cpu", "exec"), smoke.__dict__)
    return smoke


def rehearse(new_tokens: int) -> None:
    smoke = _cpu_smoke()
    smoke.GEN_NEW = new_tokens
    t0 = time.perf_counter()
    smoke.phase_generate({}, "CPU rehearsal")
    print(f"rehearsal: {time.perf_counter() - t0:.1f} s on the CPU")


def serve() -> None:
    import deeplearning4j_tpu_torch.__main__ as cli
    from deeplearning4j_tpu_torch.ops import fused_conv, fused_lstm
    smoke = _cpu_smoke()
    on_card = cli.cmd_serve
    cli.cmd_serve = lambda argv, block=True: on_card(
        list(argv) + ["--device", "cpu"], block)
    _count_launches(fused_conv, ("fused_mm", "fused_c3"))
    _count_launches(fused_lstm, ("lstm_fwd",))

    class CpuServe(smoke._ServeProcess):
        def __init__(self, args, last):
            super().__init__(list(args) + ["--device", "cpu"], last)
    smoke._ServeProcess = CpuServe
    smoke.SLICE = dict(smoke.SLICE, height=32, width=32, num_classes=10)
    smoke.SERVE_CLIENTS, smoke.SERVE_PER_CLIENT = 1, 4
    smoke.SERVE_LATENCY_REPS, smoke.GEN_NEW, smoke.SERVE_DURATION = 3, 16, 12
    t0 = time.perf_counter()
    print(smoke.phase_serve_http({}, "CPU rehearsal"))
    print(f"rehearsal: {time.perf_counter() - t0:.1f} s on the CPU")


def _count_launches(mod, names):
    """Each wrapper in ``names`` counts a launch for each (plain) call."""
    for name in names:
        def counted(*a, _fn=getattr(mod, name), _name=name, **kw):
            mod._count(_name)
            return _fn(*a, **kw)
        setattr(mod, name, counted)


def rnn() -> None:
    from deeplearning4j_tpu_torch.ops import fused_lstm
    smoke = _cpu_smoke()
    _count_launches(fused_lstm, ("lstm_fwd", "lstm_bwd"))
    torch.cuda.reset_peak_memory_stats = lambda *a: None
    torch.cuda.max_memory_allocated = lambda *a: 0
    torch.cuda.get_device_properties = lambda *a: types.SimpleNamespace(
        multi_processor_count=132)
    smoke.TBPTT_BATCH, smoke.TBPTT_CHARS, smoke.TBPTT_BATCHES = 4, 200, 3
    smoke.TBPTT_RAGGED = 220
    smoke.FAMILY_BATCH, smoke.FAMILY_H = 4, 32
    smoke.GRAPH_N, smoke.GRAPH_FITS = 8, 2
    smoke.GRAVES_STREAMS, smoke.GRAVES_NEW, smoke.GEN_SLOTS = 2, 8, 2
    t0 = time.perf_counter()
    print(smoke.phase_rnn_tbptt({}, "CPU rehearsal"))
    print(f"rehearsal: {time.perf_counter() - t0:.1f} s on the CPU")


class _HostEvent:
    """``torch.cuda.Event`` timed by the host clock."""

    def __init__(self, *args, **kwargs):
        self.t = 0.0

    def record(self, *args):
        self.t = time.perf_counter()

    def elapsed_time(self, end):
        return 1e3 * (end.t - self.t)


def zoo() -> None:
    from deeplearning4j_tpu_torch.ops import fused_conv
    smoke = _cpu_smoke()
    _count_launches(fused_conv, ("fused_mm", "fused_c3", "fused_mm_bwd",
                                 "fused_c3_bwd", "fused_c3_bwd_in",
                                 "fused_c3_bwd_w"))
    torch.cuda.Event = _HostEvent
    torch.cuda.reset_peak_memory_stats = lambda *a: None
    torch.cuda.max_memory_allocated = lambda *a: 0
    smoke.TRAIN_BATCH, smoke.TRAIN_K, smoke.TRAIN_CALLS = 8, 2, 3
    # bf16 convolutions are slow on the CPU: the rehearsal trains in f32
    smoke.ZOO_BENCH = dict(smoke.ZOO_BENCH, height=32, width=32,
                           compute_dtype="float32")
    smoke.VGG = dict(smoke.VGG, height=32, width=32,
                     compute_dtype="float32")
    smoke.VGG_BATCH, smoke.YOLO_BATCH, smoke.YOLO_STEPS = 8, 2, 3
    smoke.YOLO = dict(smoke.YOLO, height=64, width=64)
    smoke.TRANSFER_EPOCHS = 1
    on_card = smoke._zoo_model
    side = lambda name: 67 if name == "AlexNet" else 64   # AlexNet's least
    smoke._zoo_model = lambda name, device="cpu", **kw: on_card(
        name, device, **dict(dict(height=side(name), width=side(name)),
                             **kw))
    t0 = time.perf_counter()
    print(smoke.phase_zoo({}, "CPU rehearsal"))
    print(f"rehearsal: {time.perf_counter() - t0:.1f} s on the CPU")


def keras() -> None:
    import shutil
    import tempfile

    import keras as K

    from deeplearning4j_tpu_torch.modelimport.bert import build_keras_bert
    from deeplearning4j_tpu_torch.ops import flash_attention, fused_lstm
    sys.path.insert(0, str(ROOT / "tools"))
    import keras_card_resources as tool
    smoke = _cpu_smoke("cpu_all")
    _count_launches(flash_attention, ("flash_fwd", "flash_bwd_dkv",
                                      "flash_bwd_dq"))
    _count_launches(fused_lstm, ("lstm_fwd", "lstm_bwd"))
    torch.cuda.Event = _HostEvent
    torch.cuda.reset_peak_memory_stats = lambda *a: None
    torch.cuda.max_memory_allocated = lambda *a: 0
    res = tempfile.mkdtemp()
    try:
        for name in smoke.KERAS_FIXTURES:
            for ext in (".json", ".npz"):
                shutil.copy(ROOT / smoke.KERAS_RES / (name + ext), res)
        tool.IV3_SHAPE = (75, 75, 3)
        small = {"bert_base": build_keras_bert(
            vocab=64, width=32, n_layers=2, n_heads=4, ffn=64, max_len=128,
            seq_len=128),
            "inception_v3": K.applications.InceptionV3(
                weights=None, input_shape=tool.IV3_SHAPE, classes=1000)}
        for name, km in small.items():
            tool.set_seeded(km)
            meta = tool.model_resource(km)
            tool.check_seeded(km, meta)
            tool.dump_json(meta, f"{res}/{name}.json")
            import numpy as np
            np.savez(f"{res}/{name}_golden.npz", **tool.golden(name, km))
        smoke.KERAS_RES = res
        smoke.KERAS_BERT_SERVE_BATCH = 4
        smoke.KERAS_BERT_FT_BATCH, smoke.KERAS_BERT_FT_K = 4, 2
        smoke.KERAS_BERT_FROZEN_BATCH = 4
        smoke.KERAS_IV3_SERVE_BATCH, smoke.KERAS_IV3_FT_BATCH = 2, 2
        smoke.KERAS_IV3_FT_K = 2
        smoke.KERAS_4A_BATCH, smoke.KERAS_4A_ROWS = 4, 64
        t0 = time.perf_counter()
        print(smoke.phase_keras_import({}, "CPU rehearsal"))
        print(f"rehearsal: {time.perf_counter() - t0:.1f} s on the CPU")
    finally:
        shutil.rmtree(res)


def ops() -> None:
    from torch.profiler import ProfilerActivity, profile

    from deeplearning4j_tpu_torch.generation import decode as D
    from deeplearning4j_tpu_torch.zoo.models import TextGenerationLSTM
    model = TextGenerationLSTM().init_pretrained(device="cpu")
    spec = D.extract_decode_spec(model)
    dp = D.commit_decode_params(model, spec, "f32")
    tick = D.build_tick(model, spec)
    S = 8
    h, c, rng = D.zero_carries(spec, S, "cpu")
    i64 = dict(dtype=torch.int64)
    b = dict(dtype=torch.bool)
    args = (torch.zeros(S, **i64), torch.zeros(S, **b),
            torch.zeros(S, **i64), torch.ones(S, **b), torch.ones(S),
            torch.zeros(S, **i64), torch.ones(S, **b),
            torch.zeros((S, 2), **i64), torch.zeros(S, **b))
    with torch.no_grad():
        tick(dp, h, c, rng, *args)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            tick(dp, h, c, rng, *args)
    top = [e.name for e in prof.events() if e.cpu_parent is None]
    print(f"top-level torch ops in one f32 tick at {S} slots: {len(top)}")
    print(collections.Counter(top).most_common(12))


def observed() -> None:
    from deeplearning4j_tpu_torch.observe import flight_recorder
    from deeplearning4j_tpu_torch.ops import (flash_attention, fused_conv,
                                              fused_lstm)
    smoke = _cpu_smoke("cpu_all")
    _count_launches(fused_conv, ("fused_mm", "fused_c3", "fused_mm_bwd",
                                 "fused_c3_bwd", "fused_c3_bwd_in",
                                 "fused_c3_bwd_w"))
    _count_launches(fused_lstm, ("lstm_fwd", "lstm_bwd"))
    _count_launches(flash_attention, ("flash_fwd", "flash_bwd_dkv",
                                      "flash_bwd_dq"))

    def oom(*args):
        raise torch.OutOfMemoryError("CPU rehearsal: past mem_get_info")
    torch.cuda.mem_get_info = oom
    torch.cuda.set_sync_debug_mode = lambda mode: None
    section = flight_recorder.FlightRecorder._memory_section

    def memory(self, model, reason):
        out = section(self, model, reason)
        out["devices"] = [{"id": 0, "bytes_in_use": 0}]
        return out
    flight_recorder.FlightRecorder._memory_section = memory
    smoke._hand_kernel_counts = lambda fn: (fn(), {"rehearsal": 1})[1]
    smoke.SLICE = dict(smoke.SLICE, height=32, width=32, num_classes=10,
                       compute_dtype="float32")
    smoke.OBS_BATCH, smoke.OBS_HELD_OUT, smoke.OBS_SERVE_REQUESTS = 8, 16, 4
    smoke.BERT = dict(vocab=64, width=32, heads=4, blocks=2, seq=16)
    smoke.BERT_TRAIN_BATCH = 2
    smoke.TBPTT_BATCH, smoke.TBPTT_CHARS = 4, 200
    report = {"run_dir": str(ROOT / "build" / "rehearsal")}
    t0 = time.perf_counter()
    print(smoke.phase_observed_fit(report, "CPU rehearsal"))
    print(f"rehearsal: {time.perf_counter() - t0:.1f} s on the CPU")


class _CpuNodes:
    """chip_smoke's node subprocesses with ``--device cpu``."""

    @staticmethod
    def patch(smoke):
        class CpuNode(smoke._NodeProcess):
            def __init__(self, args):
                super().__init__(list(args) + ["--device", "cpu"])
        smoke._NodeProcess = CpuNode


def cluster() -> None:
    from deeplearning4j_tpu_torch.ops import fused_conv
    smoke = _cpu_smoke("cpu_all")
    _CpuNodes.patch(smoke)
    smoke._kernel_load_seconds = lambda: 0.0      # no nvcc, no libraries
    _count_launches(fused_conv, ("fused_mm", "fused_c3"))
    smoke.SLICE = dict(smoke.SLICE, height=32, width=32, num_classes=10)
    smoke.CLUSTER_CLIENTS, smoke.CLUSTER_PER_CLIENT = 2, 12
    smoke.CLUSTER_DRAIN_AT, smoke.CLUSTER_SUB_REQUESTS = 8, 12
    t0 = time.perf_counter()
    print(smoke.phase_cluster({}, "CPU rehearsal"))
    print(f"rehearsal: {time.perf_counter() - t0:.1f} s on the CPU")


def neighbors() -> None:
    smoke = _cpu_smoke("cpu_all")
    _CpuNodes.patch(smoke)
    smoke.NN = dict(smoke.NN, vectors=20000, blobs=16, shard_rows=8192,
                    clusters=32, nprobe=8, batch=16)
    t0 = time.perf_counter()
    smoke.phase_neighbors({}, "CPU rehearsal")
    print(f"rehearsal: {time.perf_counter() - t0:.1f} s on the CPU")


def embeddings(only=()) -> None:
    smoke = _cpu_smoke("cpu_all")
    torch.cuda.reset_peak_memory_stats = lambda *a, **k: None
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    torch.cuda.empty_cache = lambda: None
    torch.cuda.set_sync_debug_mode = lambda mode: None
    smoke.EMB_ARMS = {k: v for k, v in smoke.EMB_ARMS.items()
                      if not only or k in only}
    smoke.EMB = dict(smoke.EMB, vocab=2000, tokens=60_000, layer=32,
                     batch=4096, serial_tokens=20_000, topics=4,
                     topic_tokens=20_000, pv_docs=400, pv_len=50,
                     pv_vocab=1000, label_topics=4, label_docs=300,
                     label_held=40, glove_tokens=20_000, graph_side=300,
                     walk=20)
    t0 = time.perf_counter()
    report = {}
    smoke.phase_embeddings(report, "CPU rehearsal")
    print(f"rehearsal: {time.perf_counter() - t0:.1f} s on the CPU")


def online() -> None:
    from deeplearning4j_tpu_torch.ops import fused_conv
    smoke = _cpu_smoke("cpu_all")

    class CpuServe(smoke._ServeProcess):
        def __init__(self, args, last):
            super().__init__(list(args) + ["--device", "cpu"], last)
    smoke._ServeProcess = CpuServe
    _count_launches(fused_conv, tuple(fused_conv.LAUNCHES))
    smoke.SLICE = dict(smoke.SLICE, height=32, width=32, num_classes=10)
    t0 = time.perf_counter()
    report = {}
    print(smoke.phase_online(report, "CPU rehearsal"))
    print(f"rehearsal: {time.perf_counter() - t0:.1f} s on the CPU")


_AOT_PRELUDE = """
import contextlib
_real_record = cuda_build.record_sources
@contextlib.contextmanager
def _record():
    with _real_record() as seen:
        yield seen
        for s in ("fused_mm", "fused_c3"):
            seen.add(s)
            if not cuda_build.library_path(s).exists():
                cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
                cuda_build.library_path(s).write_bytes(
                    ("stand-in " + s).encode() * 2000)
                cuda_build.build_log[s] = (0.0, "")
cuda_build.record_sources = _record
"""


def aot() -> None:
    smoke = _cpu_smoke("cpu_all")
    anchor = 'cuda_build.BUILD_DIR = Path(spec["build_dir"])\n'
    assert anchor in smoke.AOT_CHILD
    smoke.AOT_CHILD = smoke.AOT_CHILD.replace(anchor, anchor + _AOT_PRELUDE)
    smoke.SLICE = dict(smoke.SLICE, height=32, width=32, num_classes=10)
    smoke.AOT_SHAPE_OTHER = (16, 16, 3)
    t0 = time.perf_counter()
    report = {}
    smoke.phase_aot_cache(report, "CPU rehearsal")
    print(f"rehearsal: {time.perf_counter() - t0:.1f} s on the CPU")


_DP_PRELUDE = """
def _rehearsal_counting():
    from deeplearning4j_tpu_torch.ops import fused_conv as _fc
    for _name in ("fused_mm", "fused_c3", "fused_mm_bwd", "fused_c3_bwd",
                  "fused_c3_bwd_in", "fused_c3_bwd_w"):
        def counted(*a, _fn=getattr(_fc, _name), _n=_name, **kw):
            _fc._count(_n)
            return _fn(*a, **kw)
        setattr(_fc, _name, counted)
_rehearsal_counting()
"""


def data_parallel() -> None:
    """``phase_data_parallel`` on the CPU: its ranks are spawned, so the
    rewritten source is a file (``build/rehearsal/dp_rehearsal.py``, a
    name the repository's own chip_smoke cannot shadow) that they import
    by name; every "cuda" is "cpu", "nccl" is "gloo", the
    wrappers of kernels 1-6 count a launch for each plain call (in the
    ranks too), and the ResNet50 is cut to 32x32 with 10 classes, 8 rows
    a step."""
    src = (ROOT / "chip_smoke.py").read_text()
    src = src.replace('"cuda"', '"cpu"').replace(".cuda()", ".cpu()")
    src = src.replace("torch.cuda.synchronize()", "None")
    src = src.replace('"nccl"', '"gloo"')
    src = src.replace("themselves\n    cuda_build.build()\n",
                      "themselves\n")
    for call in ("ResNet50(**SLICE).init()",
                 "ResNet50(**dict(SLICE, compute_dtype=dtype)).init()"):
        src = src.replace(call, call[:-1] + 'device="cpu")')
    anchor = "_T_START = time.perf_counter()\n"
    src = src.replace(anchor, anchor + _DP_PRELUDE)
    out = ROOT / "build" / "rehearsal"
    out.mkdir(parents=True, exist_ok=True)
    (out / "dp_rehearsal.py").write_text(src)
    sys.path.insert(0, str(out))
    import dp_rehearsal as smoke
    smoke.SLICE = dict(smoke.SLICE, height=32, width=32, num_classes=10)
    smoke.DP_BATCH, smoke.DP_ROWS = 8, 8
    t0 = time.perf_counter()
    smoke.phase_data_parallel({}, "CPU rehearsal")
    print(f"rehearsal: {time.perf_counter() - t0:.1f} s on the CPU")


_MP_PRELUDE = """
def _rehearsal_counting():
    from deeplearning4j_tpu_torch.ops import flash_attention as _fa
    for _name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        def counted(*a, _fn=getattr(_fa, _name), _n=_name, **kw):
            _fa._count(_n)
            return _fn(*a, **kw)
        setattr(_fa, _name, counted)
_rehearsal_counting()
"""


def model_parallel() -> None:
    """``phase_model_parallel`` on the CPU, as ``data_parallel`` runs its
    phase (``build/rehearsal/mp_rehearsal.py``, imported by the spawned
    ranks; every "cuda" the CPU; the flash wrappers counting a launch for
    each plain call), at cut sizes: the BERT-base graph at 2 x 128, the
    sequence arms at T 64, the LM at 4 layers, 2 x 16 tokens, the expert
    layer on 256 tokens."""
    src = (ROOT / "chip_smoke.py").read_text()
    src = src.replace('"cuda"', '"cpu"').replace(".cuda()", ".cpu()")
    src = src.replace("torch.cuda.synchronize()", "None")
    src = src.replace("themselves\n    cuda_build.build()\n",
                      "themselves\n")
    anchor = "_T_START = time.perf_counter()\n"
    src = src.replace(anchor, anchor + _MP_PRELUDE)
    src = src.replace("MP_BERT_BATCH = 32 ", "MP_BERT_BATCH = 2 ")
    src = src.replace("MP_SEQ = dict(n=8, t=512,", "MP_SEQ = dict(n=2, t=64,")
    src = src.replace("MP_LM = dict(vocab=30522, width=768, heads=12, "
                      "layers=12, max_len=128,\n             batch=16,",
                      "MP_LM = dict(vocab=30522, width=768, heads=12, "
                      "layers=4, max_len=16,\n             batch=2,")
    src = src.replace("MP_MOE_TOKENS = 32 * 128 ", "MP_MOE_TOKENS = 256 ")
    out = ROOT / "build" / "rehearsal"
    out.mkdir(parents=True, exist_ok=True)
    (out / "mp_rehearsal.py").write_text(src)
    sys.path.insert(0, str(out))
    import mp_rehearsal as smoke
    t0 = time.perf_counter()
    smoke.phase_model_parallel({}, "CPU rehearsal")
    print(f"rehearsal: {time.perf_counter() - t0:.1f} s on the CPU")


def main(argv) -> int:
    if not argv or argv[0] not in ("rehearse", "serve", "ops", "rnn", "zoo",
                                   "keras", "observed", "cluster",
                                   "neighbors", "embeddings", "online",
                                   "aot", "data_parallel", "model_parallel"):
        print(__doc__)
        return 2
    if argv[0] == "ops":
        ops()
    elif argv[0] == "serve":
        serve()
    elif argv[0] == "rnn":
        rnn()
    elif argv[0] == "zoo":
        zoo()
    elif argv[0] == "keras":
        keras()
    elif argv[0] == "observed":
        observed()
    elif argv[0] == "cluster":
        cluster()
    elif argv[0] == "neighbors":
        neighbors()
    elif argv[0] == "embeddings":
        embeddings(argv[1:])
    elif argv[0] == "online":
        online()
    elif argv[0] == "aot":
        aot()
    elif argv[0] == "data_parallel":
        data_parallel()
    elif argv[0] == "model_parallel":
        model_parallel()
    else:
        rehearse(int(argv[1]) if len(argv) > 1 else 32)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
