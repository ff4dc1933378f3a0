#!/usr/bin/env python
"""Serving front end: stdin/stdout JSON lines, or HTTP/SSE with --http
(``tnn_tpu.cli.serve``).

    echo '{"tokens": [464, 3616, 286], "max_new_tokens": 16}' | \
        python -m tnn_tpu_torch.cli.serve --model gpt2_small

    python -m tnn_tpu_torch.cli.serve --model-file gpt2.tnn \
        --vocab vocab.bin --no-chunked-prefill

    python -m tnn_tpu_torch.cli.serve --model gpt2_small --replicas 2 \
        --http 127.0.0.1:8100

Each stdin line is one request, or a cancel:

    {"id": 3, "tokens": [464, 3616, 286], "max_new_tokens": 8,
     "temperature": 0.8, "top_k": 40, "top_p": 0.9, "stop_token": 50256,
     "deadline_s": 30.0, "max_queue_s": 5.0, "priority": 0}
    {"id": 4, "prompt": "The meaning of life is"}
    {"op": "cancel", "id": 3}

A ``"prompt"`` line is encoded with ``--vocab`` when one is given and as
its UTF-8 bytes otherwise. ``id`` defaults to the engine request id;
``deadline_s`` defaults to ``--deadline-s`` (0: none). Responses stream
as the engine produces them, one JSON object per line, as the JAX front
end emits them:

    {"event": "token", "id": 3, "token": 257}
    {"event": "done", "id": 3, "tokens": [...], "finish_reason": "length",
     "ttft_ms": 12.3, "text": "..."}                   ("text" with --vocab)
    {"event": "error", "id": 3, "reason": "..."}
    {"event": "error", "id": 5, "reason": "queue full: ...",
     "rejected": true}                  (--max-queue-depth; serving goes on)
    {"event": "timeout", "id": 3, "reason": "..."}     (deadline expired)
    {"event": "cancelled", "id": 3, "reason": "..."}
    {"event": "error", "id": 6, "reason": "supervisor is draining: ...",
     "draining": true}                 (a line read after the drain began)

Terminal events also carry ``trace_id`` and ``latency_breakdown`` (queued,
prefill, decode, stalled and host-gap ms; preemptions, migrations).

The server runs under ``serving.supervisor.EngineSupervisor``, as the JAX
front end does: the engine steps on the supervisor's worker thread (which
owns it and the card) while this main thread reads stdin, submits and
cancels through the supervisor's command queue and alone writes stdout,
from the events the worker puts on a queue. The supervisor adds crash
recovery (a step that raises restarts the engine: running requests migrate
and continue token-exact under greedy decoding, ``--migration-budget``
migrations each; ``--max-restarts`` restarts with backoff, then every
request fails and the process exits 1), an optional step-latency watchdog
(``--watchdog-s``: a slower step counts as a crash; the first steps of a
cold process build the kernels with nvcc and capture the pdecode CUDA
graph, so set it above that or leave it off) and one graceful drain:
SIGINT, SIGTERM and EOF all close admissions, let the requests in flight
finish (or time out after ``--drain-deadline-s``), flush every event and
exit 0. Each request gets exactly one terminal event. ``--trace PATH``
writes the engine's spans and instants as a Chrome / Perfetto trace at
exit; ``--flight-dir DIR`` receives the flight recorder's JSONL dumps (the
last steps' records) on a crash, a watchdog trip, the restart budget's end
and the drain.
The engine runs its overlapped loop, as the JAX front end's does: a step
is on the card while the host commits the one before and runs the
deferred work (``--no-overlap`` runs each step synchronously; the tokens
are the same).
Weights come from a ``.tnn`` file (``--model-file``, written by either
package's ``save_model``) or are seeded random (``--model``, ``--seed``);
``--device`` defaults to cuda and the server refuses to start without a
card unless ``--device cpu``. ``--no-chunked-prefill`` serves the JAX
engine's whole-prompt prefill (and so runs without the prefix cache);
``--max-queue-depth`` bounds the wait queue (a full queue sheds a queued
request of larger ``priority`` value, else rejects the line);
``--preemption-budget`` caps recompute preemptions per request (-1:
none); ``--no-logit-guard`` lets a row with non-finite logits go on.

``--sp N`` serves with sequence parallelism: the KV pool's blocks split
over N shards, a request's blocks round-robin over them, so the longest
servable context is N times one shard's. ``--sp-devices`` names the
shards' devices as a comma list (``cuda:0,cuda:0`` puts two shards on one
card); the default is the first N cards, or N copies of the CPU.
``--tp N`` serves with tensor parallelism: attention heads, the MLP's
columns and the KV pool's heads split over N shards, with two all-reduces
a layer; ``--tp-devices`` names the shards' devices as ``--sp-devices``
does. Its stderr line gives the heads and the KV bytes a token costs per
shard.

The prefix cache is on (``--no-prefix-cache`` turns it off): requests that
share a prompt prefix fork its KV blocks instead of prefilling them.
``--spec ngram`` or ``--spec draft`` serves with speculative decoding
(``--spec-k`` drafted tokens verified per decode row and step); the draft
model is a seeded random ``gpt2_tiny`` with the target's vocabulary.
Greedy output is token-exact either way. The stderr summary carries the
``prefix_*`` and ``spec_*`` gauges.

``--http HOST:PORT`` serves HTTP/SSE (``serving/server.py``: ``POST
/v1/generate``, ``POST /v1/cancel``, ``GET /v1/health``, ``GET /v1/stats``,
``GET /metrics``) instead of stdin; the bound address is printed as
``tnn-serve: listening on http://HOST:PORT`` on stderr (port 0 picks a
free one). SIGINT and SIGTERM drain and exit 0.

The fleet: ``--replicas N`` runs N supervised replicas behind
``serving.router.Router`` (join-shortest-queue placement, breakers,
retries, token-exact migration when a replica dies, ``--hedge-ttft-s`` /
``--hedge-budget`` hedging, ``--degrade-factor`` ejection). The replicas
share the model's weights on the card; each has its own engine, pool and
worker thread. ``--roles prefill,decode`` (or ``auto``) disaggregates:
prompts of at least ``--disagg-prompt-threshold`` tokens prefill on a
prefill replica and move to a decode replica at their first token,
carrying their KV blocks (``--no-handoff-kv``: recompute instead);
``--fleet-prefix`` pulls a prefix's KV from the replica that holds it.
``--autoscale MIN:MAX`` sizes the fleet by load (zero-loss scale-down).
``--host-tier-bytes`` gives each engine a host-RAM KV tier for evicted
prefix blocks. ``--compile-cache DIR`` builds and loads the CUDA kernels
in DIR, so a second start with the same DIR runs no nvcc. Impossible
fleets are refused before any weight is built, with the JAX front end's
messages.
"""
from __future__ import annotations

import argparse
import json
import os
import queue
import select
import signal
import sys

import numpy as np

from tnn_tpu_torch import checkpoint
from tnn_tpu_torch.data.tokenizer import Tokenizer
from tnn_tpu_torch.models import zoo
from tnn_tpu_torch.ops import runtime
from tnn_tpu_torch.profiling.profiler import Profiler
from tnn_tpu_torch.serving import compile_cache
from tnn_tpu_torch.serving.autoscaler import Autoscaler
from tnn_tpu_torch.serving.engine import InferenceEngine
from tnn_tpu_torch.serving.router import Router
from tnn_tpu_torch.serving.scheduler import AdmissionRejected
from tnn_tpu_torch.serving.server import run_server
from tnn_tpu_torch.serving.supervisor import EngineSupervisor, ShuttingDown


def _emit(obj) -> None:
    sys.stdout.write(json.dumps(obj) + "\n")
    sys.stdout.flush()


def _stdin_ready(fd: int, timeout) -> bool:
    return bool(select.select([fd], [], [], timeout)[0])


def _sp_preflight(ap, args, sp_devices) -> None:
    """The JAX front end's fail-fast checks of an impossible SP setup, run
    before any weight is built."""
    if sp_devices is not None and len(sp_devices) != args.sp:
        ap.error(f"--sp-devices names {len(sp_devices)} device(s) for "
                 f"--sp {args.sp}")
    if sp_devices is None and args.device.startswith("cuda"):
        import torch
        n_dev = torch.cuda.device_count()
        if args.sp > n_dev:
            ap.error(f"--sp {args.sp} exceeds the {n_dev} visible card(s); "
                     "put several shards on one card with --sp-devices")
    if args.host_tier_bytes:
        ap.error("--host-tier-bytes is incompatible with --sp > 1 "
                 "(a demoted block's pages live on one context-mesh "
                 "shard; run the host tier on single-chip replicas)")
    if args.num_blocks % args.sp:
        ap.error(f"--num-blocks {args.num_blocks} does not divide evenly "
                 f"over --sp {args.sp} shards")
    if args.quant_weights:
        ap.error("--quant-weights is incompatible with --sp > 1 (serve fp "
                 "weights under SP)")
    if args.decode_path == "fused":
        ap.error("--decode-path fused is incompatible with --sp > 1 (the "
                 "fused kernel assembles one chip's contiguous cache; use "
                 "auto, paged, or standard)")
    # the engine's assembly width, from the model's shape alone
    if args.model_file:
        max_len = checkpoint.read_tensor_file_header(
            args.model_file)[1]["model_config"]["max_len"]
    else:
        max_len = zoo.create(args.model, device="meta", seed=None).max_len
    cap = min(max_len, (args.num_blocks - args.sp) * args.block_size)
    msl = min(args.max_seq_len or cap, cap)
    nb = -(-msl // args.block_size)
    if nb % args.sp:
        ap.error(f"--sp {args.sp} does not divide the assembly width ({nb} "
                 f"blocks/seq from max_seq_len {msl}, block size "
                 f"{args.block_size}); pick --max-seq-len (or --num-blocks/"
                 "--block-size) so ceil(max_seq_len / block_size) is a "
                 "multiple of sp")


def _tp_preflight(ap, args, tp_devices) -> None:
    """The JAX front end's fail-fast checks of an impossible TP setup, run
    before any weight is built."""
    if tp_devices is not None and len(tp_devices) != args.tp:
        ap.error(f"--tp-devices names {len(tp_devices)} device(s) for "
                 f"--tp {args.tp}")
    if tp_devices is None and args.device.startswith("cuda"):
        import torch
        n_dev = torch.cuda.device_count()
        if args.tp > n_dev:
            ap.error(f"--tp {args.tp} exceeds the {n_dev} visible card(s); "
                     "put several shards on one card with --tp-devices")
    if args.model_file:
        cfg = checkpoint.read_tensor_file_header(
            args.model_file)[1]["model_config"]
    else:
        cfg = zoo.create(args.model, device="meta", seed=None).get_config()
    h_kv = cfg.get("num_kv_heads") or cfg["num_heads"]
    if h_kv % args.tp:
        ap.error(f"--tp {args.tp} does not divide the model's {h_kv} KV "
                 "head(s); head-sharded TP needs num_kv_heads % tp == 0")
    if args.quant_weights:
        ap.error("--quant-weights is incompatible with --tp > 1 "
                 "(int8 weight leaves don't column-shard)")
    if args.decode_path == "fused":
        ap.error("--decode-path fused is incompatible with --tp > 1 "
                 "(the fused kernel stacks whole-model weights; use "
                 "auto, paged, or standard)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", default="gpt2_small", choices=zoo.names(),
                    help="zoo name (used when --model-file is absent)")
    ap.add_argument("--model-file", default="", help=".tnn snapshot")
    ap.add_argument("--vocab", default="",
                    help="vocab.bin (the reference format)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--num-blocks", type=int, default=64,
                    help="KV pool size in blocks (1 is reserved scratch)")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--max-batch-size", type=int, default=8)
    ap.add_argument("--chunk-size", type=int, default=64)
    ap.add_argument("--no-chunked-prefill", action="store_true",
                    help="whole-prompt prefill: one prefill program per "
                         "admitted prompt (also turns the prefix cache "
                         "off)")
    ap.add_argument("--max-queue-depth", type=int, default=0,
                    help="bounded admission: reject submits past this many "
                         "waiting requests (0 = unbounded); a more "
                         "important arrival sheds a less important queued "
                         "request")
    ap.add_argument("--preemption-budget", type=int, default=16,
                    help="recompute preemptions a request may take before "
                         "it fails (-1 = unlimited)")
    ap.add_argument("--no-logit-guard", action="store_true",
                    help="disable per-row non-finite logit detection")
    ap.add_argument("--max-new-tokens", type=int, default=32,
                    help="default for requests that omit it")
    ap.add_argument("--kv-dtype", default="f32", choices=("f32", "int8"),
                    help="KV pool page dtype: int8 halves resident KV and "
                         "decode page traffic (per-row f32 scale sidecar; "
                         "output gated by closeness, not exactness)")
    ap.add_argument("--quant-weights", action="store_true",
                    help="serve projection/MLP matmuls from int8 weights "
                         "via the in-kernel-dequant quant_matmul kernel")
    ap.add_argument("--decode-path", default="auto",
                    choices=("auto", "standard", "fused", "paged"),
                    help="decode program: paged (the paged-attention "
                         "kernel), standard (assembled caches), fused (the "
                         "one-launch decode-stack kernel on lockstep "
                         "batches; needs --quant-weights), or auto")
    ap.add_argument("--max-seq-len", type=int, default=0,
                    help="longest request (prompt + new tokens); 0 = the "
                         "model's or the pool's limit, whichever is less")
    ap.add_argument("--sp", type=int, default=1,
                    help="sequence-parallel degree: shard the KV pool's "
                         "blocks over this many shards")
    ap.add_argument("--sp-devices", default="",
                    help="comma list of one device per shard, e.g. "
                         "cuda:0,cuda:0 (default: the first --sp cards)")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: shard attention heads and "
                         "the paged KV pool head-wise over this many shards "
                         "(two all-reduces a layer; needs num_kv_heads %% "
                         "tp == 0; token-exact vs tp=1)")
    ap.add_argument("--tp-devices", default="",
                    help="comma list of one device per TP shard, e.g. "
                         "cuda:0,cuda:0 (default: the first --tp cards)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable automatic prefix caching (content-"
                         "addressed KV block reuse across requests)")
    ap.add_argument("--prefix-cache-min-hit-blocks", type=int, default=1,
                    help="ignore prefix-cache matches shorter than this "
                         "many full KV blocks")
    ap.add_argument("--spec", default="off",
                    choices=("off", "ngram", "draft"),
                    help="speculative decoding: 'ngram' self-drafts from the "
                         "request's own context, 'draft' drafts with a "
                         "seeded random gpt2_tiny of the target's vocab")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="max drafted tokens verified per decode row per "
                         "step (the mixed step widens to k+1)")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="default per-request wall deadline (0 = none)")
    ap.add_argument("--no-overlap", action="store_true",
                    help="run the synchronous engine loop (one blocking "
                         "fetch per step, no step in flight during host "
                         "bookkeeping)")
    ap.add_argument("--watchdog-s", type=float, default=0.0,
                    help="step-latency watchdog: a step exceeding this wall "
                         "time restarts the engine (0 = off; set it above "
                         "the cold start: the first steps build the CUDA "
                         "kernels with nvcc and capture the decode graph)")
    ap.add_argument("--max-restarts", type=int, default=2,
                    help="engine crash/watchdog recoveries before the "
                         "supervisor gives up and fails all requests")
    ap.add_argument("--migration-budget", type=int, default=3,
                    help="crash migrations one request may absorb before "
                         "it fails as poison (-1 = unlimited)")
    ap.add_argument("--drain-deadline-s", type=float, default=30.0,
                    help="graceful-drain budget: in-flight work past this "
                         "deadline times out (0 = wait forever)")
    ap.add_argument("--trace", default="",
                    help="enable request-scoped tracing and write the "
                         "engine's spans and instants as a Chrome/Perfetto "
                         "trace to this path on exit")
    ap.add_argument("--flight-dir", default="",
                    help="directory for the flight recorder's JSONL dumps "
                         "(the last steps' records) on crash, watchdog "
                         "trip, restart-budget exhaustion and drain")
    ap.add_argument("--http", default="",
                    help="serve HTTP+SSE on HOST:PORT instead of stdin "
                         "JSON lines (e.g. 127.0.0.1:8100; port 0 picks "
                         "a free one)")
    ap.add_argument("--compile-cache", default="",
                    help="kernel build directory: CUDA kernels built by a "
                         "previous run (or a sibling replica on shared "
                         "storage) are loaded instead of rebuilt with "
                         "nvcc; keyed by source, headers and flags, so a "
                         "changed source misses cleanly")
    ap.add_argument("--host-tier-bytes", type=int, default=0,
                    help="host-RAM KV tier capacity in bytes (0 = off): "
                         "prefix-cache blocks the pool would reclaim are "
                         "demoted to host memory and re-admitted on a later "
                         "prefix hit after a digest check (a corrupt block "
                         "degrades to an uncached miss, never wrong KV); "
                         "requires the prefix cache and chunked prefill")
    ap.add_argument("--autoscale", default="",
                    help="MIN:MAX — run a load-driven autoscaler over the "
                         "replica fleet: scale up under queue pressure, "
                         "scale down after a hysteresis-guarded quiet "
                         "period by draining the least-loaded replica with "
                         "its live streams migrated token-exact; "
                         "--replicas sets the starting size (clamped into "
                         "[MIN, MAX])")
    ap.add_argument("--replicas", type=int, default=1,
                    help="run N supervised engine replicas behind a failover "
                         "router: join-shortest-queue placement, per-replica "
                         "circuit breakers, bounded retries, and token-exact "
                         "mid-stream migration when a replica dies")
    ap.add_argument("--hedge-ttft-s", type=float, default=-1.0,
                    help="router hedging: duplicate a request onto the "
                         "next-best replica when its first token is this "
                         "late (-1 = adaptive, the fleet's rolling TTFT "
                         "p95). First token wins; the loser is cancelled "
                         "and never charges a breaker")
    ap.add_argument("--hedge-budget", type=float, default=0.1,
                    help="max concurrent hedges as a fraction of open "
                         "requests, consulted before every fire "
                         "(0 = hedging off)")
    ap.add_argument("--degrade-factor", type=float, default=2.0,
                    help="eject a replica from placement as DEGRADED when "
                         "its health score stays worse than this multiple "
                         "of the fleet median (0 = ejection off); its live "
                         "streams proactively migrate token-exact")
    ap.add_argument("--roles", default="",
                    help="disaggregated prefill/decode serving: comma-"
                         "separated per-replica roles (prefill|decode|mixed) "
                         "matching the fleet size, or 'auto' to let the "
                         "router rank replicas by health score and dedicate "
                         "the healthiest half to decode")
    ap.add_argument("--disagg-prompt-threshold", type=int, default=128,
                    help="with --roles: prompts at least this many tokens "
                         "long prefer a prefill replica; the router hands "
                         "the stream to a decode replica at the first-token "
                         "boundary (token-exact)")
    ap.add_argument("--no-handoff-kv", action="store_true",
                    help="disable the KV-block handoff at the prefill/"
                         "decode boundary — the stream still moves, via "
                         "token-exact recompute-resume (A/B baseline)")
    ap.add_argument("--fleet-prefix", action="store_true",
                    help="fleet-wide shared prefix cache: the router tracks "
                         "which replica holds which prefix chain keys and "
                         "pulls blocks from a peer on a local miss through "
                         "the digest-verified export/adopt path")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sp_devices = [d for d in args.sp_devices.split(",") if d] or None
    tp_devices = [d for d in args.tp_devices.split(",") if d] or None
    autoscale, roles = _fleet_preflight(ap, args)
    if args.tp < 1:
        ap.error(f"--tp must be >= 1, got {args.tp}")
    if args.tp > 1:
        _tp_preflight(ap, args, tp_devices)
    if args.sp > 1:
        if args.tp > 1:
            ap.error(f"--sp {args.sp} with --tp {args.tp} is unsupported "
                     "this engine — the context mesh and the head mesh "
                     "would need a 2-D shard_map; pick ONE of --sp / --tp "
                     "per replica")
        _sp_preflight(ap, args, sp_devices)
    if args.compile_cache:
        # before any kernel library loads: every build lands in the cache
        cache_dir = compile_cache.enable(args.compile_cache)
        warm = compile_cache.entry_count(cache_dir)
        print(f"compile cache: {cache_dir} "
              f"({'warm, %d entries' % warm if warm else 'cold'})",
              file=sys.stderr)

    tokenizer = Tokenizer().load(args.vocab) if args.vocab else None
    if args.model_file:
        model = checkpoint.load_model(args.model_file, device=args.device)
        print(f"{args.model_file} on {model.device}", file=sys.stderr)
    else:
        model = zoo.create(args.model, device=args.device, seed=args.seed)
        print(f"random-weight {args.model} on {model.device} "
              f"(seed {args.seed})", file=sys.stderr)
    draft_model = None
    if args.spec == "draft":
        draft_model = zoo.create("gpt2_tiny", vocab_size=model.vocab_size,
                                 max_len=model.max_len, device=args.device,
                                 seed=args.seed + 1)
        print("spec=draft: random-weight gpt2_tiny drafter (seed "
              f"{args.seed + 1})", file=sys.stderr)
    fleet = args.replicas > 1 or autoscale is not None
    profilers = []

    def build_engine(idx=0):
        prof = None
        if args.trace and fleet:
            prof = Profiler(source=f"replica{idx}")
            profilers.append(prof)
        return InferenceEngine(
            model, num_blocks=args.num_blocks, block_size=args.block_size,
            max_batch_size=args.max_batch_size, chunk_size=args.chunk_size,
            chunked_prefill=not args.no_chunked_prefill,
            max_queue_depth=args.max_queue_depth,
            preemption_budget=(None if args.preemption_budget < 0
                               else args.preemption_budget),
            migration_budget=(None if args.migration_budget < 0
                              else args.migration_budget),
            logit_guard=not args.no_logit_guard,
            seed=args.seed, kv_dtype=args.kv_dtype,
            quant_weights=args.quant_weights, decode_path=args.decode_path,
            max_seq_len=args.max_seq_len or None, sp=args.sp,
            sp_devices=sp_devices, tp=args.tp, tp_devices=tp_devices,
            prefix_cache=not args.no_prefix_cache,
            prefix_cache_min_hit_blocks=args.prefix_cache_min_hit_blocks,
            spec=args.spec, spec_k=args.spec_k, draft_model=draft_model,
            overlap=not args.no_overlap, profiler=prof,
            trace=bool(args.trace), host_tier_bytes=args.host_tier_bytes,
            device=args.device)

    def build_supervisor(eng, idx=0):
        # each replica dumps into its own subdirectory, so the sequence
        # numbers of different replicas never collide
        flight_dir = args.flight_dir or None
        if flight_dir and fleet:
            flight_dir = os.path.join(flight_dir, f"replica{idx}")
        return EngineSupervisor(
            eng, watchdog_step_s=args.watchdog_s or None,
            max_restarts=args.max_restarts,
            drain_deadline_s=args.drain_deadline_s or None,
            flight_dir=flight_dir)

    engine = build_engine()
    if args.host_tier_bytes:
        print(f"host KV tier: {args.host_tier_bytes} bytes, verified "
              "re-admission (corrupt blocks degrade to uncached misses)",
              file=sys.stderr)
    if args.tp > 1:
        print(f"tensor parallel: tp={args.tp}, "
              f"{model.num_heads // args.tp} head(s)/shard, per-shard KV "
              f"{engine.stats()['kv_bytes_per_token_per_shard']} B/token "
              f"over {', '.join(str(d) for d in engine.pool.devices)}",
              file=sys.stderr)
    if args.sp > 1:
        print(f"sequence parallel: sp={args.sp}, "
              f"{engine.pool.blocks_per_shard} block(s)/shard, max context "
              f"{engine.max_seq_len} tokens over "
              f"{', '.join(str(d) for d in engine.pool.devices)}",
              file=sys.stderr)
    scaler = None
    router_prof = None
    if fleet:
        # replicas share the model's weights; each has its own engine,
        # pool and supervised worker thread. With --autoscale the fleet
        # starts at the clamped --replicas size
        n0 = args.replicas
        if autoscale is not None:
            n0 = min(max(args.replicas, autoscale[0]), autoscale[1])
        if isinstance(roles, list) and len(roles) != n0:
            ap.error(f"--roles names {len(roles)} replica(s) but the "
                     f"fleet starts at {n0} — give one role per replica "
                     "or use --roles auto")
        sups = [build_supervisor(engine)] + [
            build_supervisor(build_engine(i), i) for i in range(1, n0)]
        router_prof = Profiler(source="router") if args.trace else None
        supervisor = Router(
            sups,
            migration_budget=(10 ** 9 if args.migration_budget < 0
                              else args.migration_budget),
            hedge_ttft_s=(None if args.hedge_ttft_s < 0
                          else args.hedge_ttft_s),
            hedge_budget=args.hedge_budget,
            degrade_factor=args.degrade_factor, roles=roles,
            disagg_prompt_threshold=args.disagg_prompt_threshold,
            handoff_kv=not args.no_handoff_kv,
            fleet_prefix=args.fleet_prefix, seed=args.seed,
            profiler=router_prof)
        print(f"router: {n0} supervised replicas", file=sys.stderr)
        if roles is not None:
            kv = "recompute-resume only" if args.no_handoff_kv \
                else "verified KV-block handoff"
            print(f"disaggregated serving: roles="
                  f"{roles if roles == 'auto' else ','.join(roles)}, "
                  f"prompt threshold {args.disagg_prompt_threshold}, {kv}",
                  file=sys.stderr)
        if args.fleet_prefix:
            print("fleet prefix cache: content-addressed directory + "
                  "peer block pulls (verified)", file=sys.stderr)
        if autoscale is not None:
            next_idx = [n0]

            def scale_factory():
                idx = next_idx[0]
                next_idx[0] += 1
                return build_supervisor(build_engine(idx), idx)

            scaler = Autoscaler(supervisor, scale_factory,
                                min_replicas=autoscale[0],
                                max_replicas=autoscale[1]).start()
            print(f"autoscaler: {autoscale[0]}..{autoscale[1]} replicas, "
                  "zero-loss scale-down (live streams migrate token-exact "
                  "before a replica drains)", file=sys.stderr)
    else:
        supervisor = build_supervisor(engine)

    try:
        if args.http:
            host, _, port = args.http.rpartition(":")
            code = run_server(supervisor, host=host or "127.0.0.1",
                              port=int(port), tokenizer=tokenizer,
                              default_max_new=args.max_new_tokens)
            supervisor.join(30.0)   # the workers exit before teardown
            _print_summary(supervisor)
        else:
            code = _serve_stdin(supervisor, model, tokenizer, args)
    finally:
        if scaler is not None:
            scaler.stop()
    if args.trace:
        trace = engine.profiler
        if router_prof is not None:
            # one merged view: the router's instants and every replica's
            # spans, each source on its own track
            trace = router_prof
            for prof in profilers:
                trace.merge(prof)
        trace.to_chrome_trace(args.trace)
        print(f"trace written to {args.trace}", file=sys.stderr)
    if args.compile_cache:
        print(f"compile cache: {compile_cache.entry_count(cache_dir)} "
              f"kernel libraries in {cache_dir}; nvcc ran "
              f"{runtime.nvcc_runs} time(s) in this process",
              file=sys.stderr)
    return code


def _fleet_preflight(ap, args):
    """The JAX front end's fail-fast checks of an impossible fleet, run
    before any weight is built; returns (autoscale bounds or None, roles
    or None)."""
    autoscale = None
    if args.autoscale:
        lo, sep, hi = args.autoscale.partition(":")
        try:
            autoscale = (int(lo), int(hi))
        except ValueError:
            autoscale = None
        if not sep or autoscale is None:
            ap.error(f"--autoscale {args.autoscale!r} is not MIN:MAX "
                     "(two integers, e.g. --autoscale 1:4)")
        if autoscale[0] < 1:
            ap.error(f"--autoscale MIN must be >= 1, got {autoscale[0]}")
        if autoscale[1] < autoscale[0]:
            ap.error(f"--autoscale MAX ({autoscale[1]}) must be >= MIN "
                     f"({autoscale[0]})")
    if args.host_tier_bytes < 0:
        ap.error(f"--host-tier-bytes must be >= 0, got "
                 f"{args.host_tier_bytes}")
    if args.host_tier_bytes and (args.no_prefix_cache
                                 or args.no_chunked_prefill):
        ap.error("--host-tier-bytes needs the prefix cache (the tier "
                 "is keyed by its rolling-hash chain) — drop "
                 "--no-prefix-cache/--no-chunked-prefill or the tier")
    if args.host_tier_bytes and args.tp > 1:
        ap.error("--host-tier-bytes is incompatible with --tp > 1 "
                 "(demoted page slices would need a cross-shard "
                 "gather/scatter)")
    roles = None
    if args.roles:
        if args.replicas <= 1 and not args.autoscale:
            ap.error("--roles needs a replica fleet "
                     "(--replicas N > 1 or --autoscale MIN:MAX)")
        if args.roles == "auto":
            roles = "auto"
        else:
            roles = [r.strip() for r in args.roles.split(",")]
            bad = sorted(set(r for r in roles
                             if r not in ("prefill", "decode", "mixed")))
            if bad:
                ap.error(f"--roles: unknown role(s) {', '.join(bad)} "
                         "(choose prefill, decode, or mixed)")
            if "prefill" in roles and not any(
                    r in ("decode", "mixed") for r in roles):
                ap.error("--roles: a disaggregated fleet needs at least "
                         "one decode or mixed replica")
    if args.disagg_prompt_threshold < 1:
        ap.error(f"--disagg-prompt-threshold must be >= 1, got "
                 f"{args.disagg_prompt_threshold}")
    if args.fleet_prefix and (args.no_prefix_cache
                              or args.no_chunked_prefill):
        ap.error("--fleet-prefix needs the prefix cache (pulled blocks "
                 "are keyed by its rolling-hash chain) — drop "
                 "--no-prefix-cache/--no-chunked-prefill")
    return autoscale, roles


def _serve_stdin(supervisor, model, tokenizer, args) -> int:
    """The stdin JSON-lines loop as a client of the supervisor (the JAX
    front end's ``_serve_stdin``): requests go to the worker through the
    command queue, events come back through the sink queue, and SIGINT,
    SIGTERM and EOF all start the one graceful drain."""
    out_q: "queue.Queue" = queue.Queue()
    supervisor.event_sink = out_q.put
    user_ids = {}
    rid_by_user = {}

    def handle_line(line: bytes):
        """Submit or cancel (on the worker, inside ``handle_lines``'s
        command); returns the error event of a bad line, None otherwise.
        A bad line never kills the server."""
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            return {"event": "error", "reason": f"bad json: {e}"}
        if not isinstance(req, dict):
            return {"event": "error", "reason": "a request is a JSON object"}
        if req.get("op") == "cancel":
            user_id = req.get("id")
            rid = rid_by_user.get(json.dumps(user_id))
            if rid is None or not supervisor.cancel(rid):
                return {"event": "error", "id": user_id,
                        "reason": "cancel: unknown or already-terminal id"}
            return None    # the sweep emits the cancelled event
        try:
            if "tokens" in req:
                ids = req["tokens"]
            elif tokenizer is not None:
                ids = tokenizer.encode(req["prompt"])
            else:
                ids = np.frombuffer(req["prompt"].encode(), np.uint8) \
                    .astype(np.int32) % model.vocab_size
            deadline = req.get("deadline_s", args.deadline_s or None)
            rid = supervisor.submit(
                ids, int(req.get("max_new_tokens", args.max_new_tokens)),
                temperature=float(req.get("temperature", 0.0)),
                top_k=int(req.get("top_k", 0)),
                top_p=float(req.get("top_p", 0.0)),
                stop_token=req.get("stop_token"),
                deadline_s=float(deadline) if deadline else None,
                max_queue_s=(float(req["max_queue_s"])
                             if req.get("max_queue_s") else None),
                priority=int(req.get("priority", 0)))
        except AdmissionRejected as e:
            return {"event": "error", "id": req.get("id"), "reason": str(e),
                    "rejected": True}
        except ShuttingDown as e:
            return {"event": "error", "id": req.get("id"), "reason": str(e),
                    "draining": True}
        except (ValueError, KeyError, TypeError) as e:
            return {"event": "error", "id": req.get("id"), "reason": str(e)}
        user_ids[rid] = req.get("id", rid)
        rid_by_user[json.dumps(user_ids[rid])] = rid
        return None

    def handle_lines(lines) -> None:
        """The lines of one read in one command on the worker, so that no
        step runs between them (requests that arrive together join the
        same step, as they did before the supervisor). A router places
        each line on its own replica, so it takes them one by one."""
        execute = getattr(supervisor, "execute", None)

        def run():
            return [handle_line(x) for x in lines if x.strip()]

        errors = execute(run) if execute is not None else run()
        flush_events()
        for ev in errors:
            if ev is not None:
                _emit(ev)

    def emit_event(ev) -> None:
        out = dict(ev)
        rid = out.get("id")
        out["id"] = user_ids.get(rid, rid)
        if ev.get("event") == "done" and tokenizer is not None:
            out["text"] = tokenizer.decode(ev["tokens"])
        _emit(out)

    def flush_events() -> None:
        while True:
            try:
                emit_event(out_q.get_nowait())
            except queue.Empty:
                return

    supervisor.start()
    old_handlers = {}
    try:
        for signum in (signal.SIGINT, signal.SIGTERM):
            old_handlers[signum] = signal.signal(
                signum, lambda sig, frame: supervisor.request_drain(
                    f"{signal.Signals(sig).name} received"))
    except ValueError:
        pass     # not the main thread (embedded use): signals stay external
    fd = sys.stdin.fileno()
    pending = b""
    try:
        eof = False
        while not supervisor.finished:
            flush_events()
            if eof or supervisor.draining:
                supervisor.join(0.05)      # a drain runs: wait for it
                continue
            if not _stdin_ready(fd, 0.05):
                continue
            data = os.read(fd, 1 << 16)
            if not data:
                eof = True
                data = b"\n"
            pending += data
            *lines, pending = pending.split(b"\n")
            handle_lines(lines)
            if eof:
                # EOF drains: the work in flight finishes instead of being
                # dropped by the process's exit
                supervisor.request_drain("stdin EOF")
        supervisor.join(30.0)
        flush_events()
    finally:
        for signum, handler in old_handlers.items():
            signal.signal(signum, handler)
    _print_summary(supervisor)
    return supervisor.exit_code if supervisor.exit_code is not None else 0


def _print_summary(supervisor) -> None:
    print("serve summary: " + json.dumps(
        {k: round(v, 3) if isinstance(v, float) else v
         for k, v in supervisor.stats().items()}), file=sys.stderr)


if __name__ == "__main__":
    sys.exit(main())
