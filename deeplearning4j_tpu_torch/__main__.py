"""``python -m deeplearning4j_tpu_torch`` — operational entry points.

``serve`` loads a saved model zip onto the card, starts the serving
engine (or the fleet front door) and the UI server, so that
``/metrics`` (Prometheus), ``/healthz`` (degradation verdict),
``POST /api/predict``, ``GET /api/serving/stats`` and, with
``--generate``, ``POST /api/generate`` (an SSE token stream) are live:

    python -m deeplearning4j_tpu_torch serve --model model.zip \
        --warmup-shape 64 64 3 --batch-limit 32 --ui-port 9000

``--join DIR`` runs the same model as a cluster node (parallel/node.py):
it heartbeats into the registry directory, answers a RemoteDispatcher,
and SIGTERM drains it (finish in-flight, deregister, exit 0).
``--neighbors-index KEY --artifact-store DIR`` serves a saved retrieval
index instead of a model (``POST /api/neighbors``; with ``--join`` as a
RetrievalNode gossiping its shards). ``--online --stream-endpoint
HOST:PORT`` trains the restored model off a broker topic while a clone
serves (online/), with ``GET /api/online/stats`` and ``POST
/api/online/promote|rollback``. ``--artifact-store`` auto-discovers a
measured tuned config (``--tuned-config KEY`` names its key,
``--no-tuned`` skips it), and ``--aot-cache-dir`` (or a node's artifact
store) persists the built kernel libraries so a fresh process runs no
``nvcc``.

The parser is the JAX package's (``python -m deeplearning4j_tpu``) with
every flag, so its command lines parse unchanged, plus ``--device``
(``cuda`` unless ``cpu`` is asked for; without a card the command exits
non-zero rather than serve on the CPU). Flags whose machinery is not
ported exit with the ROADMAP.md queue 1 item that will port it.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

# dest of each flag whose machinery is not ported -> (what, ROADMAP item)
_NOT_PORTED = {
    "no_pipeline": ("the blocking dispatcher (an A/B arm of the "
                    "pipelined one)", 12),
}


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m deeplearning4j_tpu_torch",
        description="deeplearning4j_tpu_torch operational CLI")
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser(
        "serve", help="serve a saved model over the batching engine "
        "(ParallelWrapperMain analog for inference)")
    s.add_argument("--model", required=False, default=None,
                   help="path to a save_model() zip (required unless "
                   "--neighbors-index serves a retrieval index "
                   "instead)")
    # the reference's flag names, snake-cased: --workers -> --replicas
    # (model-per-device fan-out), --batchLimit/--queueLimit/--timeout
    # keep their meaning, --inferenceMode keeps its two values
    s.add_argument("--replicas", default="1",
                   help="device replicas to serve on: 1 or 'auto' (every "
                   "visible card; one card is ported) (reference: "
                   "--workers)")
    s.add_argument("--batch-limit", type=int, default=None,
                   help="max examples per device batch (default: the "
                   "tuned-config value when one loads, else 32)")
    s.add_argument("--queue-limit", type=int, default=128,
                   help="bound on queued request chunks")
    s.add_argument("--timeout-ms", type=float, default=5.0,
                   help="upper bound on batch aggregation")
    s.add_argument("--inference-mode", default="batched",
                   choices=["batched", "inplace"],
                   help="batched = the serving engine; inplace = direct "
                   "locked calls (reference: --inferenceMode)")
    s.add_argument("--depth", type=int, default=1,
                   help="in-flight batches between dispatcher and "
                   "completion thread (pipeline double-buffer depth)")
    s.add_argument("--no-pipeline", action="store_true",
                   help="blocking dispatcher (fixed aggregation window); "
                   "for A/B comparison only")
    s.add_argument("--bf16", action="store_true",
                   help="serve a bfloat16 copy of the float params")
    s.add_argument("--warmup-shape", type=int, nargs="*", default=None,
                   metavar="DIM",
                   help="per-example feature shape (no batch dim), e.g. "
                   "'--warmup-shape 784' or '--warmup-shape 28 28 1'; "
                   "enables the bucket-ladder warmup sweep so no live "
                   "request makes a bucket's first dispatch")
    s.add_argument("--dtype", default="float32",
                   help="request feature dtype")
    s.add_argument("--aot-cache-dir", default=None, metavar="DIR",
                   help="persist the built kernel libraries the served "
                   "forward reaches here; a fresh process restores them "
                   "and runs no nvcc (falls through to a live build on "
                   "any fingerprint mismatch)")
    s.add_argument("--slo-ms", type=float, default=None, metavar="MS",
                   help="serve behind the fleet front door with this "
                   "p99 SLO: admission control + windowed-p99 shedding "
                   "(503 on shed) + hot version swap/rollback routes")
    s.add_argument("--model-version", default="v1",
                   help="version label for the fleet pool / AOT cache "
                   "fingerprint")
    s.add_argument("--ui-port", type=int, default=9000,
                   help="UI/metrics port (0 picks a free one)")
    s.add_argument("--duration", type=float, default=None,
                   help="serve for N seconds then exit (default: until "
                   "interrupted)")
    s.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the model serves: the card (default; "
                   "exits without one) or, only when asked, the CPU")
    # ---- multi-node fleet (join a serving cluster) -------------------
    n = s.add_argument_group(
        "multi-node fleet", "join a health-gossiped serving cluster "
        "(parallel/node.py): heartbeat into a shared registry dir, "
        "warm the AOT table from a shared artifact store, and drain "
        "gracefully on SIGTERM (finish in-flight, deregister, exit 0)")
    n.add_argument("--join", default=None, metavar="DIR",
                   help="node registry directory to gossip into "
                   "(a shared filesystem path); enables node mode")
    n.add_argument("--node-id", default=None,
                   help="stable node identity in the registry "
                   "(default: the pid); a rejoining node reuses its id")
    n.add_argument("--artifact-store", default=None, metavar="DIR",
                   help="shared AOT/calibration artifact store root "
                   "(bucket layout); joining nodes warm from one saved "
                   "sweep with zero live compiles")
    n.add_argument("--model-key", default=None,
                   help="artifact-store key for this model (default: "
                   "the model file's basename)")
    n.add_argument("--tuned-config", default=None, metavar="KEY",
                   nargs="?", const="tuned_config",
                   help="load a measured TunedConfig artifact from "
                   "--artifact-store under KEY (bare flag: the default "
                   "key) and let it size every engine this process "
                   "starts; with --artifact-store set, the default key "
                   "is auto-discovered even without this flag. A "
                   "fingerprint mismatch falls through to the "
                   "committed defaults, never a crash")
    n.add_argument("--no-tuned", action="store_true",
                   help="skip TunedConfig auto-discovery from "
                   "--artifact-store; every knob keeps its explicit "
                   "or committed-default value")
    n.add_argument("--drain-timeout", type=float, default=30.0,
                   metavar="S",
                   help="SIGTERM grace: max seconds to finish in-flight "
                   "requests before exiting anyway")
    # ---- retrieval serving (nearest-neighbor index) -----------------
    r = s.add_argument_group(
        "retrieval serving", "serve a nearest-neighbor index "
        "(retrieval/) instead of a model: jitted fused distance+top-k "
        "over the index's shards, POST /api/neighbors. With --join, "
        "the node gossips its shard ownership so NeighborsDispatcher "
        "can scatter-gather across the cluster")
    r.add_argument("--neighbors-index", default=None, metavar="KEY",
                   help="artifact-store key of a saved "
                   "ShardedCorpusIndex (requires --artifact-store); "
                   "enables retrieval mode, --model becomes optional")
    r.add_argument("--neighbors-shards", default=None, metavar="IDS",
                   help="comma-separated shard ids this node loads and "
                   "owns (default: every shard in the manifest)")
    r.add_argument("--neighbors-k-ladder", default=None,
                   metavar="KS", help="warmed k values; a request's k "
                   "is served by the next rung up and sliced "
                   "(default: the tuned-config ladder when one loads, "
                   "else 1,10,100)")
    r.add_argument("--neighbors-batch", type=int, default=64,
                   metavar="N", help="max query batch per dispatch "
                   "(pow2 bucket ladder below it is warmed too)")
    r.add_argument("--nprobe", type=int, default=None, metavar="N",
                   help="IVF clusters probed per query (default: the "
                   "index build's hint; ignored for brute indexes)")
    # ---- online learning (train-and-serve in one process) -----------
    o = s.add_argument_group(
        "online learning", "train-and-serve in one process: consume a "
        "broker sample stream, incrementally fit the restored model, "
        "and hot-promote holdout-gated candidates into the warm "
        "serving engines (zero recompiles); a regression sentinel "
        "auto-rolls-back on live p99/score regressions")
    o.add_argument("--online", action="store_true",
                   help="enable the online-learning loop (needs "
                   "--stream-endpoint and batched inference mode)")
    o.add_argument("--stream-endpoint", default=None, metavar="HOST:PORT",
                   help="TCP broker to consume training samples from "
                   "(streaming/broker.py TcpTransport)")
    o.add_argument("--stream-topic", default="train",
                   help="broker topic carrying packed sample frames")
    o.add_argument("--promote-interval-s", type=float, default=5.0,
                   help="seconds between promotion-gate cycles")
    o.add_argument("--min-delta", type=float, default=0.0,
                   help="required holdout-score improvement margin; "
                   "candidates within it are rejected as 'equal'")
    o.add_argument("--score-budget-s", type=float, default=None,
                   help="advisory wall-clock budget for one holdout "
                   "scoring pass (over-budget is flagged, not fatal)")
    o.add_argument("--rollback-p99-factor", type=float, default=3.0,
                   help="sentinel: live p99 over baseline*factor (and "
                   "over the floor) rolls the promotion back")
    o.add_argument("--rollback-p99-floor-ms", type=float, default=50.0,
                   help="sentinel: absolute p99 floor (ms) the live "
                   "value must also exceed before a p99 rollback")
    o.add_argument("--rollback-score-delta", type=float, default=0.0,
                   help="sentinel: tolerated live holdout-score slack "
                   "vs the pre-swap baseline before a score rollback")
    o.add_argument("--sentinel-window-s", type=float, default=30.0,
                   help="how long the sentinel watches after each "
                   "promotion")
    o.add_argument("--holdout-every", type=int, default=8,
                   help="divert every Nth stream micro-batch to the "
                   "holdout reservoir (never trained on)")
    o.add_argument("--holdout-max", type=int, default=512,
                   help="holdout reservoir bound, in examples")
    # ---- generative serving (autoregressive decode) ------------------
    g = s.add_argument_group(
        "generative serving", "serve autoregressive decode next to "
        "predict: a continuous-batching GenerationEngine "
        "(generation/engine.py) over the restored recurrent model "
        "streams tokens at POST /api/generate (SSE); "
        "--gen-slo-token-ms puts it behind the fleet front door's "
        "admission control with per-token-p99 shedding")
    g.add_argument("--generate", action="store_true",
                   help="enable decode serving (the model must be a "
                   "stacked-LSTM + dense-head network, e.g. the "
                   "committed TextGenerationLSTM artifact)")
    g.add_argument("--gen-slots", type=int, default=None, metavar="N",
                   help="continuous-batching slot count: concurrent "
                   "sequences decoding in one device batch; the "
                   "warmup sweeps the pow2 bucket ladder up to this "
                   "(default: the tuned-config value when one loads, "
                   "else 8)")
    g.add_argument("--gen-max-new", type=int, default=256, metavar="N",
                   help="default per-request max generated tokens")
    g.add_argument("--gen-precision", default="f32",
                   choices=["f32", "bf16", "int8"],
                   help="dense-head precision arm; int8 rides "
                   "ops/quantize.py and must pass the decode-level "
                   "next-token-agreement gate at startup")
    g.add_argument("--gen-slo-token-ms", type=float, default=None,
                   metavar="MS",
                   help="per-token p99 SLO: routes /api/generate "
                   "through fleet admission control (503 + Retry-After "
                   "on shed)")
    g.add_argument("--gen-queue-limit", type=int, default=128,
                   help="bound on sequences waiting for a slot")
    g.add_argument("--gen-prefill-chunk", type=int, default=None,
                   metavar="C",
                   help="chunked prefill: consume prompts in dispatches "
                   "of up to C tokens (pow2 ladder, warmed) instead of "
                   "one tick per char; 0 disables (default: the "
                   "tuned-config value when one loads, else 0)")
    g.add_argument("--gen-speculative", type=int, default=0,
                   metavar="K",
                   help="speculative decode: n-gram draft proposes up "
                   "to K tokens per slot, verified in one batched "
                   "dispatch; accepted output stays bitwise-equal to "
                   "plain decode. 0 disables")
    g.add_argument("--gen-sampling", default=None,
                   choices=["chain", "counter"],
                   help="seeded-sampling key derivation: chain (legacy "
                   "carried split chain) or counter (a hash of "
                   "(seed, position) — replayable anywhere; the "
                   "default when --gen-speculative is on)")
    g.add_argument("--gen-session-dir", default=None, metavar="DIR",
                   help="enable resumable sessions, checkpointing "
                   "carries into this shared ArtifactStore root so a "
                   "session resumes on another node after a drain")
    g.add_argument("--gen-session-cap", type=int, default=0,
                   metavar="N",
                   help="enable resumable sessions with N carries "
                   "pinned device-side (LRU to host beyond that); "
                   "local-only unless --gen-session-dir adds the "
                   "cross-node checkpoint tier")
    g.add_argument("--gen-carry-int8", action="store_true",
                   help="store session carries int8-quantized "
                   "(ops/quantize.py rows) — ~4x more resumable "
                   "sessions per chip, trades away bitwise resume")
    for action in s._actions:
        if action.dest in _NOT_PORTED:
            # absent from the namespace unless given on the command line
            action.default = argparse.SUPPRESS
    return p


def _refuse_unported(args) -> None:
    """Exit naming the ROADMAP item of the first unported flag given."""
    for dest, (what, item) in _NOT_PORTED.items():
        if hasattr(args, dest):
            flag = "--" + dest.replace("_", "-")
            raise SystemExit(
                f"serve: {flag} needs {what}, which is not ported yet "
                f"(ROADMAP.md, queue 1 item {item})")


def _load_tuned_for_serve(args):
    """Resolve the machine-measured TunedConfig for this serve process.

    With ``--artifact-store`` the tuned artifact is auto-discovered
    under the default key; ``--tuned-config [KEY]`` names another key,
    and ``--no-tuned`` skips it. The loaded (or fallen-through) config
    installs process-wide, so every engine built below — serving pools,
    generation, retrieval, the device feeder — resolves its un-flagged
    knobs from it. The expectation is machine-level (no weights
    binding): a config measured on this device with this torch and CUDA
    applies to whatever model this node serves; any fingerprint-field
    mismatch (a config the JAX package wrote included) means the
    committed defaults."""
    if args.artifact_store is None or args.no_tuned:
        return None
    from deeplearning4j_tpu_torch.observe.flight_recorder import (
        default_flight_recorder)
    from deeplearning4j_tpu_torch.optimize import autotune
    from deeplearning4j_tpu_torch.parallel.aot_cache import ArtifactStore
    cfg = autotune.load_tuned(
        ArtifactStore(args.artifact_store),
        expect=autotune.fingerprint(device=args.device),
        key=args.tuned_config or autotune.TUNED_KEY,
        recorder=default_flight_recorder())
    autotune.set_process_tuned(cfg)
    if cfg.load_outcome == "loaded":
        print(f"tuned config: loaded {sorted(cfg.values)} from "
              f"{args.artifact_store}")
    else:
        print(f"tuned config: {cfg.load_outcome} "
              f"({cfg.load_reason}) — committed defaults in effect")
    return cfg


def _wait(args) -> None:
    try:
        if args.duration is not None:
            time.sleep(args.duration)
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass


def cmd_serve(args, block: bool = True):
    """Start engine + UI server. ``args`` is the parsed namespace or an
    argument list (``["serve", "--model", ...]``). ``block=False``
    returns ``(front, server)`` for in-process use (tests, notebooks) —
    front is the ParallelInference facade, the FleetRouter when
    ``--slo-ms`` puts the fleet front door up, or the OnlineServing
    runtime with ``--online``. Each exposes ``shutdown()``."""
    if not isinstance(args, argparse.Namespace):
        args = _build_parser().parse_args(list(args))
    _refuse_unported(args)
    if not args.model and not args.neighbors_index:
        raise SystemExit("--model is required (or --neighbors-index to "
                         "serve a retrieval index)")
    import numpy as np
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serve: no CUDA device is available; pass "
                         "--device cpu to serve on the CPU explicitly")
    # the measured tuned config (auto-discovered from --artifact-store)
    # installs process-wide before any engine is built
    tuned = _load_tuned_for_serve(args)
    if args.neighbors_index:
        return _cmd_serve_neighbors(args, block)

    from deeplearning4j_tpu_torch.models.serialization import restore_model
    from deeplearning4j_tpu_torch.optimize.autotune import resolve_tuned
    from deeplearning4j_tpu_torch.parallel.inference import (
        InferenceMode, ParallelInference)
    from deeplearning4j_tpu_torch.ui.server import UIServer
    from deeplearning4j_tpu_torch.ui.serving_module import (
        FleetModule, ServingModule)
    from deeplearning4j_tpu_torch.ui.storage import InMemoryStatsStorage

    # un-flagged knobs resolve through the tuned config here, so every
    # construction and banner below sees real values
    args.batch_limit = int(resolve_tuned(args.batch_limit, tuned,
                                         "serving.batch_limit"))
    args.gen_slots = int(resolve_tuned(args.gen_slots, tuned,
                                       "generation.max_slots"))
    args.gen_prefill_chunk = int(resolve_tuned(
        args.gen_prefill_chunk, tuned, "generation.prefill_chunk"))
    model = restore_model(args.model, device=args.device)
    replicas = args.replicas if args.replicas == "auto" \
        else int(args.replicas)
    mode = InferenceMode(args.inference_mode)
    kwargs = {}
    if mode == InferenceMode.BATCHED:
        kwargs = dict(
            replicas=replicas, depth=args.depth,
            precision="bf16" if args.bf16 else "f32",
            dtype=np.dtype(args.dtype), aot_cache_dir=args.aot_cache_dir,
            feature_shape=(tuple(args.warmup_shape)
                           if args.warmup_shape else None))
    name = os.path.splitext(os.path.basename(args.model))[0] or "default"
    if args.join:
        return _serve_node(args, model, name, replicas, mode, kwargs, block)

    fleet = None
    online = None
    if args.online:
        online = _serve_online(args, model, name, mode, kwargs)
        fleet = online.router
        engine = online.pool.engines[0]
        front = online
    elif args.slo_ms is not None and mode == InferenceMode.BATCHED:
        # fleet front door: admission control + SLO shedding wrap the
        # engine; the pool is named after the model file
        from deeplearning4j_tpu_torch.parallel.fleet import FleetRouter
        fleet = FleetRouter(slo_ms=args.slo_ms, device=args.device)
        fleet.add_pool(
            name, model, version=args.model_version,
            batch_limit=args.batch_limit, queue_limit=args.queue_limit,
            timeout_ms=args.timeout_ms, **kwargs)
        engine = fleet.pool(name).engines[0]
        front = fleet
    else:
        front = ParallelInference(
            model, inference_mode=mode, batch_limit=args.batch_limit,
            queue_limit=args.queue_limit, timeout_ms=args.timeout_ms,
            **kwargs)
        # INPLACE answers /api/predict through the facade itself, on
        # the handler's thread
        engine = front.engine if front.engine is not None else front

    # generative serving rides the same process: a GenerationEngine
    # over the same restored model, exposed at /api/generate — behind
    # fleet admission when an SLO (request- or token-level) is armed
    gen_engine = None
    gen_router = None
    gen_name = name + "-gen"
    if args.generate:
        from deeplearning4j_tpu_torch.generation import (
            GenerationEngine, SessionStore, extract_decode_spec)
        gen_store = None
        if args.gen_session_dir or args.gen_session_cap:
            art_store = None
            if args.gen_session_dir:
                from deeplearning4j_tpu_torch.parallel.aot_cache import (
                    ArtifactStore)
                art_store = ArtifactStore(args.gen_session_dir)
            gen_store = SessionStore(
                extract_decode_spec(model),
                device_capacity=args.gen_session_cap or 32,
                store=art_store,
                carry_dtype="int8" if args.gen_carry_int8 else "f32",
                device=model.device)
        gen_engine = GenerationEngine(
            model, max_slots=args.gen_slots,
            precision=args.gen_precision,
            max_new_tokens=args.gen_max_new,
            queue_limit=args.gen_queue_limit,
            prefill_chunk=args.gen_prefill_chunk,
            speculative=args.gen_speculative,
            sampling=args.gen_sampling,
            session_store=gen_store)
        if fleet is not None or args.gen_slo_token_ms is not None:
            gen_router = fleet
            if gen_router is None:
                from deeplearning4j_tpu_torch.parallel.fleet import (
                    FleetRouter)
                gen_router = FleetRouter(session_id="generate",
                                         device=args.device)
            gen_router.add_generation_pool(
                gen_name, gen_engine, slo_token_ms=args.gen_slo_token_ms)

    server = UIServer(port=args.ui_port)
    server.attach(InMemoryStatsStorage())
    if fleet is not None:
        # FleetModule first: its admission-controlled /api/predict wins
        # the route merge; ServingModule keeps /api/serving/stats live
        server.register_module(FleetModule(fleet))
    server.register_module(ServingModule(engine))
    if online is not None:
        from deeplearning4j_tpu_torch.ui.online_module import OnlineModule
        server.register_module(OnlineModule(online))
    if gen_engine is not None:
        from deeplearning4j_tpu_torch.ui.generation_module import (
            GenerationModule)
        server.register_module(
            GenerationModule(router=gen_router, model=gen_name)
            if gen_router is not None
            else GenerationModule(engine=gen_engine))
    server.start()
    print(f"serving {args.model} at {server.url} "
          f"(mode={mode.value}, replicas={replicas}, "
          f"batch_limit={args.batch_limit}"
          + (f", slo={args.slo_ms}ms" if args.slo_ms is not None else "")
          + (f", aot_cache={args.aot_cache_dir}"
             if args.aot_cache_dir else "") + ")")
    print(f"  metrics:  {server.url}/metrics")
    print(f"  health:   {server.url}/healthz")
    print(f"  predict:  POST {server.url}/api/predict "
          '{"features": [[...], ...]}')
    print(f"  stats:    GET  {server.url}/api/serving/stats")
    if fleet is not None:
        print(f"  fleet:    GET  {server.url}/api/fleet/stats, "
              f"POST {server.url}/api/fleet/swap|rollback")
    if online is not None:
        print(f"  online:   GET  {server.url}/api/online/stats, "
              f"POST {server.url}/api/online/promote|rollback")
    if gen_engine is not None:
        print(f"  generate: POST {server.url}/api/generate "
              '{"prompt": "...", "stream": true}  (SSE token stream, '
              f"slots={args.gen_slots}, "
              f"precision={args.gen_precision}"
              + (f", prefill_chunk={args.gen_prefill_chunk}"
                 if args.gen_prefill_chunk else "")
              + (f", speculative={args.gen_speculative}"
                 if args.gen_speculative else "")
              + (", sessions=on" if gen_engine.session_store
                 is not None else "") + ")")
        print(f"  genstats: GET  {server.url}/api/generation/stats")
    sys.stdout.flush()
    if not block:
        return front, server
    try:
        _wait(args)
    finally:
        front.shutdown()
        # front.shutdown() covers the generation engine only when its
        # pool rides the same fleet router; the standalone cases are
        # shut down here
        if gen_router is not None and gen_router is not fleet:
            gen_router.shutdown()
        elif gen_engine is not None and gen_router is None:
            gen_engine.shutdown()
        server.stop()
    return 0


def _serve_online(args, model, name, mode, kwargs):
    """``--online``: train-and-serve in one process (online/runtime.py):
    the restored model trains off the broker topic at
    ``--stream-endpoint`` while a clone serves behind the fleet front
    door, with holdout-gated promotion and the regression sentinel."""
    from deeplearning4j_tpu_torch.online import OnlineServing
    from deeplearning4j_tpu_torch.parallel.inference import InferenceMode
    from deeplearning4j_tpu_torch.streaming.broker import TcpTransport
    if mode != InferenceMode.BATCHED:
        raise SystemExit("--online requires --inference-mode batched")
    if args.stream_endpoint is None:
        raise SystemExit("--online requires --stream-endpoint HOST:PORT")
    host, _, port = args.stream_endpoint.rpartition(":")
    transport = TcpTransport(host or "127.0.0.1", int(port))
    kw = {k: v for k, v in kwargs.items() if k != "feature_shape"}
    online = OnlineServing(
        model, transport, topic=args.stream_topic, model_name=name,
        feature_shape=kwargs.get("feature_shape"),
        batch_limit=args.batch_limit, queue_limit=args.queue_limit,
        timeout_ms=args.timeout_ms, slo_ms=args.slo_ms,
        promote_interval_s=args.promote_interval_s,
        min_delta=args.min_delta, score_budget_s=args.score_budget_s,
        rollback_p99_factor=args.rollback_p99_factor,
        rollback_p99_floor_s=args.rollback_p99_floor_ms / 1000.0,
        rollback_score_delta=args.rollback_score_delta,
        sentinel_window_s=args.sentinel_window_s,
        holdout_every=args.holdout_every, holdout_max=args.holdout_max,
        **kw)
    return online.start()


def _block_then(args, stop) -> int:
    try:
        _wait(args)
    finally:
        stop()
    return 0


def _serve_node(args, model, name, replicas, mode, kwargs, block):
    """``--join``: the model as a cluster node — FleetRouter + engine
    behind the HTTP surface, heartbeating into the shared registry;
    SIGTERM drains it (finish in-flight, deregister, exit 0)."""
    from deeplearning4j_tpu_torch.parallel.aot_cache import ArtifactStore
    from deeplearning4j_tpu_torch.parallel.inference import InferenceMode
    from deeplearning4j_tpu_torch.parallel.node import (
        NodeRegistry, ServingNode, install_sigterm_drain)
    if mode != InferenceMode.BATCHED:
        raise SystemExit("--join requires --inference-mode batched")
    if args.generate:
        raise SystemExit(
            "--generate is not supported in --join node mode; run it as a "
            "standalone serve process")
    store = ArtifactStore(args.artifact_store) \
        if args.artifact_store else None
    node_kwargs = {k: v for k, v in kwargs.items() if k != "replicas"}
    node = ServingNode(
        model, node_id=args.node_id or str(os.getpid()),
        registry=NodeRegistry(args.join), model_name=name,
        version=args.model_version, slo_ms=args.slo_ms,
        artifact_store=store, model_key=args.model_key,
        pool_size=(1 if replicas == "auto" else int(replicas)),
        ui_port=args.ui_port, batch_limit=args.batch_limit,
        queue_limit=args.queue_limit, timeout_ms=args.timeout_ms,
        device=args.device, **node_kwargs)
    install_sigterm_drain(node, timeout_s=args.drain_timeout)
    print(f"node {node.node_id} serving {args.model} at {node.url} "
          f"(registry={args.join}"
          + (f", artifact_store={args.artifact_store}"
             if args.artifact_store else "") + ")")
    print(f"  predict:  POST {node.url}/api/predict "
          '{"features": [[...], ...]}')
    print(f"  metrics:  {node.url}/metrics")
    sys.stdout.flush()
    if not block:
        return node, node.server
    return _block_then(args, node.shutdown)


def _cmd_serve_neighbors(args, block: bool):
    """Retrieval mode of ``serve``: load a saved ShardedCorpusIndex from
    the artifact store and serve POST /api/neighbors through a
    FleetRouter retrieval pool. ``--join`` runs it as a gossiping
    RetrievalNode instead (shard ownership in the heartbeat, SIGTERM
    drain). ``block=False`` returns ``(front, server)``."""
    from deeplearning4j_tpu_torch.parallel.aot_cache import ArtifactStore
    from deeplearning4j_tpu_torch.retrieval.engine import RetrievalEngine
    from deeplearning4j_tpu_torch.retrieval.index import ShardedCorpusIndex

    if not args.artifact_store:
        raise SystemExit("--neighbors-index requires --artifact-store")
    store = ArtifactStore(args.artifact_store)
    shard_ids = None
    if args.neighbors_shards:
        shard_ids = [int(s) for s in
                     args.neighbors_shards.split(",") if s != ""]
    # an explicit --neighbors-k-ladder wins, else the committed
    # (1, 10, 100)
    ladder = None if args.neighbors_k_ladder is None else tuple(
        int(k) for k in args.neighbors_k_ladder.split(",") if k != "")
    index = ShardedCorpusIndex.load(store, args.neighbors_index,
                                    shard_ids=shard_ids)
    engine = RetrievalEngine(index, k_ladder=ladder,
                             max_batch=args.neighbors_batch,
                             nprobe=args.nprobe,
                             session_id=f"nn-{args.neighbors_index}",
                             device=args.device)

    if args.join:
        from deeplearning4j_tpu_torch.parallel.node import (
            NodeRegistry, install_sigterm_drain)
        from deeplearning4j_tpu_torch.retrieval.cluster import RetrievalNode
        node = RetrievalNode(
            engine, node_id=args.node_id or str(os.getpid()),
            registry=NodeRegistry(args.join), slo_ms=args.slo_ms,
            ui_port=args.ui_port, store=store,
            index_key=args.neighbors_index, device=args.device)
        install_sigterm_drain(node, timeout_s=args.drain_timeout)
        print(f"node {node.node_id} serving index "
              f"{args.neighbors_index} (shards "
              f"{list(engine.shard_ids)}) at {node.url} "
              f"(registry={args.join})")
        sys.stdout.flush()
        if not block:
            return node, node.server
        return _block_then(args, node.shutdown)

    from deeplearning4j_tpu_torch.parallel.fleet import FleetRouter
    from deeplearning4j_tpu_torch.ui.neighbors_module import NeighborsModule
    from deeplearning4j_tpu_torch.ui.server import UIServer
    from deeplearning4j_tpu_torch.ui.storage import InMemoryStatsStorage
    engine.warmup()
    router = FleetRouter(slo_ms=args.slo_ms,
                         session_id=f"nn-{args.neighbors_index}",
                         device=args.device)
    router.add_retrieval_pool("neighbors", engine, slo_ms=args.slo_ms)
    server = UIServer(port=args.ui_port)
    server.attach(InMemoryStatsStorage())
    server.register_module(NeighborsModule(
        router=router, model="neighbors", store=store,
        index_key=args.neighbors_index))
    server.start()
    print(f"serving index {args.neighbors_index} "
          f"({engine.index.n_total} vectors, "
          f"{len(engine.shard_ids)} shards) at {server.url}")
    print(f"  neighbors: POST {server.url}/api/neighbors "
          '{"vector": [...], "k": 10}')
    print(f"  stats:     GET  {server.url}/api/neighbors/stats")
    print(f"  metrics:   {server.url}/metrics")
    sys.stdout.flush()
    if not block:
        return router, server

    def stop():
        server.stop()
        router.shutdown()
    return _block_then(args, stop)


def main(argv: Optional[List[str]] = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.command == "serve":
        rc = cmd_serve(args)
        return rc if isinstance(rc, int) else 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
