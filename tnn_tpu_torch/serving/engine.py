"""InferenceEngine (``tnn_tpu.serving.engine``): continuous batching over the
paged KV pool on one device.

    submit() --> Scheduler (FCFS queue) --> step():
        ONE mixed step packs decode rows (1 token each) and prefill CHUNKS
        (up to chunk_size prompt tokens each) into a ragged batch; a step
        with no chunk work runs a pure-decode program instead
      --> streamed tokens / finished requests

Decode-path selection (``decode_path``), as in the JAX engine: "auto"
probes the PAGED path first (the model decodes straight against the pool's
pages: ``GPT2.apply_paged`` / ``apply_decode_paged``, every layer writing
its new K/V rows in place and calling the ragged paged-attention kernel
once, ``ops.paged_attention``). Where that path is off ("standard",
"fused", or a model without ``apply_decode_paged``) the steps run on
ASSEMBLED caches: ``kv_pool.gather_kv`` builds each row's contiguous cache
from its block table, the model's ``apply_cached`` runs on it, and
``scatter_chunk`` / ``scatter_token`` write the step's new rows back. The
"fused" path adds one program: a pure-decode step whose live rows all sit
at one offset (lockstep) runs every block in one launch of the fused
decode-stack kernel (``models.fused_decode``, ``ops.decode_stack``);
ragged decode steps and every prefill chunk run the standard programs. It
needs decode-quantized weights (``quant_weights=True``), a compute-dtype
pool, and a geometry ``pick_chunks`` accepts; "fused" raises otherwise,
"auto" records why in ``fused_fallback_reason`` (``paged_fallback_reason``
likewise for the paged probe).

The engine runs the JAX engine's chunked prefill, recompute preemption
(LIFO victims, a per-request preemption budget) and per-row logit guard
(``logit_guard=False`` lets a non-finite row go on), ``cancel``,
``abort_all`` and the per-request ``deadline_s`` / ``max_queue_s``
(expired at the top of each step's build: TIMED_OUT). Bounded admission
(``max_queue_depth``): a submit to a full queue sheds a queued request of
larger ``priority`` value or raises ``AdmissionRejected`` ("reject"), or
steps the engine until the queue has room ("block"). A step that raises
propagates to the caller: a kernel failure is never turned into failed
requests (a whole-prompt prefill the step had not admitted yet FAILs, so
that no request is lost).

Whole-prompt prefill (``chunked_prefill=False``, the JAX engine's legacy
path, which its CLI's ``--no-chunked-prefill`` serves): each admitted
prompt runs one prefill program, ``model.apply_cached`` over the prompt
padded to a power of two of blocks (capped at ``blocks_per_seq``), its
last live row's logits checked and sampled, every layer's cache written
into the prompt's blocks by ``kv_pool.scatter_prefill`` (the bucket's
tail into the scratch block); the step's decode rows then run the
pure-decode program. All of a step's programs come back in its one fetch;
a row admitted this way takes its first decode token in the next step.
This path turns the prefix cache off and refuses speculative decoding,
as the JAX engine does.

The overlapped loop (``overlap=True``; off by default, the CLI turns it
on), as in the JAX engine: ``begin_step`` builds and dispatches a step
and stages its one fetch (on CUDA a non-blocking copy of the small result
bundle into one of two pinned host buffers, then an event);
``finish_step`` waits on that event and commits; ``run_deferred`` runs
the prefix publishes the commit queued. The drive loop
(``run_until_complete``, the CLI) runs deferred work while the step is on
the card, and ``try_speculate`` dispatches a pure-decode step N+1 from
the predicted row state before step N commits, reading N's sampled
tokens on the device. ``finish_step`` adopts it when the prediction held
and rolls it back otherwise (its pre-grown blocks freed, the sampling
generator's state restored, so stochastic rows draw what overlap-off
draws). A direct ``step()`` stays synchronous either way. Inputs reach
the card through pinned memory in one non-blocking copy a step.

On a CUDA device at sp = 1 every "pdecode" step replays a CUDA graph of
the program, captured once per compile key (``serving/step_graph.py``):
the counterpart of the JAX engine's jitted program. The other programs
run eagerly.

Automatic prefix caching (``prefix_cache=True``, the default, as in the
JAX engine): admission probes a content-addressed index of full KV blocks
(``serving/prefix_cache.py``) with the request's prompt, forks the matched
blocks into its table, and prefills only the uncached tail. Every block a
prefill chunk fills is published back at the end of the step. A released
block the index still names parks in the pool's evictable LRU and is
reclaimed on demand, so the cache never shrinks the pool. A fully cached
prompt keeps its last token out of the match (its recomputation gives the
first-token logits) and takes a copy-on-write clone of the block that
token writes into (``kv_pool.copy_blocks``), on the source block's shard
under SP: indexed blocks are immutable. Publishing is suspended while live
requests hold more than ``prefix_publish_max_occupancy`` of the pool.

Speculative decoding (``spec="ngram"``, ``"draft"`` or a
``spec_decode.Drafter``): each decode row packs its pending token and up
to ``spec_k`` drafted candidates as a ragged ``q_len = 1 + k`` row of the
mixed step, whose full (B, Q, V) logits feed verification: greedy rows
accept the longest draft prefix that matches the argmax at each position,
stochastic rows run rejection sampling with ``self.generator``. Accepted
tokens commit as a prefill chunk's do, and ``pool.truncate`` rolls the
rejected tail's blocks back. On the paged path the verify rows run through
the paged-attention kernel; a draft step of the fused path runs the
standard spec program, and its draft-free lockstep steps still run the
fused kernel. Device drafts come back in the step's one fetch.
``kv_dtype="int8"`` stores the pool as int8 pages with f32 scales (the
attention kernel reads them in place; the assembled paths dequantize at
the gather), ``quant_weights=True`` serves a copy of the model with int8
matmul weights (``nn.quant``).

Sequence parallelism (``sp > 1``, ``serving/sp.py``): the pool's blocks
split over sp shards on the devices ``sp_devices`` names (one card may
hold several), a request's table positions draw their blocks round-robin,
and each step stages every shard's local tables
(``step_build.shard_tables``). On the paged path every layer sweeps each
shard's pages with the paged kernel's stats form and merges the partials;
on the standard path ``gather_kv`` sums the shards' owned positions into
one cache and the scatters write each shard's own rows. As in the JAX
engine, SP refuses ``quant_weights`` and the fused path, and needs
``num_blocks`` and the table width ``blocks_per_seq`` to divide by sp.

Tensor parallelism (``tp > 1``, ``serving/tp.py``): attention heads, the
MLP's columns and the pool's KV heads split over tp shards on the devices
``tp_devices`` names (one card may hold several); every shard holds every
block, so the host-side bookkeeping is that of tp = 1. The paged, standard
and whole-prompt programs run over the shards with two all-reduces a
layer, and each dispatch records one ``serve.allreduce`` span. As in the
JAX engine, TP refuses ``quant_weights``, MoE models, the host tier, sp >
1 and the fused path. pdecode steps replay CUDA graphs when every shard
sits on the engine's device, and run eagerly otherwise.

Fault isolation, as in the JAX engine (``faults=`` takes a seeded
``faults.FaultPlan``): an injected allocation failure at a chunk boundary
or in decode growth FAILs only its request; a NaN the plan adds to a row's
logits (every program adds the step's ``poison`` column before the logit
guard, the pdecode graph included) FAILs only that row; an injected step
exception (``FaultInjected``, raised on the host before the launch) is
retried once with the same inputs and sampling state when transient, and
otherwise aborts the batch and zeroes the pages (``_abort_batch``); the
plan's ``EngineCrash`` escapes ``step()`` for a supervisor to recover
(``serving/supervisor.py``, through ``migrate_running``). An exception the
plan did not inject (a kernel error on the card) still propagates: a CUDA
error may be sticky, so only a supervisor's restart can tell. The overlap
loop does not speculate under a fault plan. Each step leaves a
flight-recorder note (``last_step_record``, ``last_finished_record``:
programs, rows, fill, pool occupancy, latency, faults fired), finalized
even when the step crashes. ``trace=True`` records the JAX engine's
instants (``serve.submit``, ``serve.admit``, ...) and ``profiled`` spans
(``serve.mixed``, ``serve.decode_paged``, ``serve.fetch``, ...) into
``profiler``; spans time host dispatch, never the device. Every request
carries a ``trace_id`` and the clocks behind ``latency_breakdown``.

Host KV tier (``host_tier_bytes > 0``, ``serving/kv_tier.py``): a block the
pool reclaims while the prefix cache still indexes it is copied to a
bounded host buffer first (``_demote_blocks``, the pool's ``demote_hook``:
one synchronous batched copy on the allocation path), and admission walks
the prompt's chain keys to write demoted blocks back (``_tier_readmit``)
before it probes, digest-verified, in place, so the captured pdecode
graphs read them. Cross-replica KV handoff: ``export_prefix`` serializes
the longest exportable chain prefix of a token sequence as digest-carrying
host wire blocks, queued on the current stream after every step that
wrote the pages; ``adopt_prefix`` verifies and writes them into this
pool's index; ``prefix_keys`` lists what this replica can export (the
router's fleet directory). A block that fails its digest or geometry
check is dropped and the request recomputes it: counted, never wrong.

Debug guards, as in the JAX engine: ``TNN_DEBUG_SYNC=1`` (read at
construction into ``debug_sync``) runs the step's build, its commit and
the speculative dispatch under torch's sync-debug mode "error"
(``serving/sync_guard.py``); the input put, the fetch's event wait and a
graph's capture are its only exempt points, and a synchronizing call
anywhere else FAILs the step's requests with an error naming its line.
``TNN_POOL_DEBUG=1`` makes the pool check its invariants after every
bookkeeping mutation (``kv_pool.PagedKVPool``).
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import time
from typing import (Any, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from ..models import fused_decode, sampling
from ..nn.quant import quantize_for_decode
from ..ops import runtime
from ..ops.decode_stack import check_kernel_geometry, fused_decode_stack
from ..profiling.profiler import EventType, Profiler, profiled
from ..utils.bucketing import pow2_bucket
from ..utils.device import resolve_device
from . import kv_pool, spec_decode, step_build, step_graph, sync_guard
from .faults import FaultInjected, FaultPlan
from .kv_pool import PagedKVPool, PoolExhausted
from .kv_tier import HostKVTier, leaf_dtype_name, tier_digest
from .metrics import ServingMetrics
from .prefix_cache import PrefixCache
from .scheduler import (TERMINAL_STATES, AdmissionRejected, Request,
                        RequestState, Scheduler)
from .sp import SPContext
from .tp import TPContext
from .tracing import Tracer


class SampleInputs(NamedTuple):
    """A step's token matrix, per-row sampling parameters and logit poison
    column on the device: what ``_sample`` reads."""
    toks: torch.Tensor
    temps: torch.Tensor
    topks: torch.Tensor
    topps: torch.Tensor
    poison: torch.Tensor


class StepInFlight:
    """One dispatched, uncommitted step (``tnn_tpu.serving.engine.
    StepInFlight``): its flight-recorder note, event buckets, one record
    per launched program (whole-prompt prefills, then the decode; or the
    one mixed step), the staged fetch of all their results and, after
    ``try_speculate``, a speculatively dispatched successor. ``prefills``
    lists the requests its whole-prompt prefills admit at commit;
    ``gen_before`` each decode-phase row's generated count when the step
    began (the stall clock)."""

    __slots__ = ("note", "fired_before", "gen_before", "latency_s", "t0",
                 "events", "recs", "prefills", "fetch", "spec", "sync_trip")

    def __init__(self, t0: float, note: Dict[str, Any],
                 fired_before: Optional[collections.Counter] = None):
        self.note = note
        self.fired_before = fired_before
        self.gen_before: Dict[int, int] = {}
        self.latency_s = 0.0
        self.t0 = t0
        self.events: Dict[str, List] = {"tokens": [], "finished": [],
                                        "failed": [], "timed_out": []}
        self.recs: List[Dict[str, Any]] = []
        self.prefills: List[Request] = []
        self.fetch: Optional[Dict[str, Any]] = None
        self.spec: Optional[Dict[str, Any]] = None
        # a speculative dispatch's TNN_DEBUG_SYNC trip, failed at commit
        self.sync_trip: Optional[str] = None


class InferenceEngine:
    """Continuous-batching inference over one GPT2-family model.

    model : a ``models.gpt2.GPT2`` whose parameters live on ``device``.
    num_blocks, block_size : KV pool geometry (block 0 is reserved scratch).
    max_batch_size : rows per step.
    token_budget : the most model tokens a step processes (decode rows +
        prompt chunks, or whole prompts).
    chunk_size : prompt tokens a request may push per mixed step.
    chunked_prefill : False serves whole-prompt prefill (module
        docstring); it turns the prefix cache off and refuses ``spec``.
    max_queue_depth : bounded admission; 0 leaves the queue unbounded.
    admission_policy : "reject" (shed a less important queued request, or
        raise ``AdmissionRejected``) or "block" (``submit`` steps the
        engine until the queue has room).
    logit_guard : a row whose logits are not finite FAILs its request
        while the rest of the batch keeps its tokens; False lets it go on.
    preemption_budget : recompute preemptions a request may take before it
        FAILs instead of requeueing (None = unlimited).
    seed : seeds the sampling ``torch.Generator``.
    kv_dtype : "f32" (pages in the model's compute dtype) or "int8" (int8
        pages with a per-(position, head) f32 scale).
    quant_weights : serve from int8 weights: the engine quantizes a copy of
        the model (``nn.quant.quantize_for_decode``) and leaves the
        caller's unchanged.
    decode_path : "auto" | "standard" | "fused" | "paged" (module
        docstring).
    max_seq_len : the longest request (prompt + new tokens); None or 0
        takes min(model.max_len, pool capacity in positions), and a larger
        value is cut to that. It sets the table width every step passes.
    sp : sequence-parallel degree (module docstring); sp_devices names one
        device per shard (default: the first sp cards, or sp copies of the
        CPU), the first of them the model's.
    tp : tensor-parallel degree (module docstring); tp_devices names one
        device per shard, as sp_devices does.
    prefix_cache : automatic prefix caching (module docstring); False
        turns off matching, publishing and the evictable pool.
    prefix_cache_min_hit_blocks : ignore matches shorter than this many
        full blocks.
    prefix_publish_max_occupancy : suspend publishes while live requests
        hold more than this share of the pool (counted in
        ``stats()["publish_suspended"]``); matching stays on.
    spec : "off", "ngram" (self-drafting from each row's context), "draft"
        (``draft_model`` proposes) or a ``spec_decode.Drafter``.
    spec_k : the most drafted tokens a decode row verifies per step.
    draft_model : a GPT2-family model on the engine's device sharing the
        target's vocabulary, for ``spec="draft"``.
    overlap : the overlapped loop (module docstring); a direct ``step()``
        stays synchronous.
    faults : a ``faults.FaultPlan`` (module docstring); the pool's
        ``alloc`` consults it too.
    migration_budget : crash re-admissions (``migrate_running``) a request
        may take before it FAILs as poison (None = unlimited).
    host_tier_bytes : the host KV tier's bound in bytes (module
        docstring); 0 turns it off. Needs the prefix cache and chunked
        prefill, and refuses sp > 1, as the JAX engine does.
    profiler : a ``profiling.Profiler`` the metrics tick into and the
        ``profiled`` spans land in.
    trace : request-scoped tracing (module docstring); creates a
        ``Profiler(source="engine")`` when none is given. Host-side only:
        traced runs are token-exact against untraced ones.

    device : "cuda" by default; raises without a card.
    """

    def __init__(self, model, *, num_blocks: int = 64, block_size: int = 16,
                 max_batch_size: int = 8, token_budget: int = 2048,
                 chunk_size: int = 64, chunked_prefill: bool = True,
                 max_queue_depth: int = 0, admission_policy: str = "reject",
                 logit_guard: bool = True,
                 preemption_budget: Optional[int] = 16, seed: int = 0,
                 kv_dtype: str = "f32", quant_weights: bool = False,
                 decode_path: str = "auto",
                 max_seq_len: Optional[int] = None, sp: int = 1,
                 sp_devices: Optional[Sequence[Any]] = None, tp: int = 1,
                 tp_devices: Optional[Sequence[Any]] = None,
                 prefix_cache: bool = True,
                 prefix_cache_min_hit_blocks: int = 1,
                 prefix_publish_max_occupancy: float = 0.95,
                 spec: Any = "off", spec_k: int = 4, draft_model=None,
                 overlap: bool = False,
                 faults: Optional[FaultPlan] = None,
                 migration_budget: Optional[int] = 3,
                 profiler: Optional[Profiler] = None, trace: bool = False,
                 host_tier_bytes: int = 0, device="cuda"):
        if getattr(model, "kv_cache_dtype", None):
            raise ValueError(
                "the paged pool stores compute-dtype pages; "
                f"kv_cache_dtype={model.kv_cache_dtype!r} models are not "
                "servable — quantize the POOL instead (kv_dtype='int8')")
        if kv_dtype not in ("f32", "int8"):
            raise ValueError(f"kv_dtype must be 'f32' or 'int8', "
                             f"got {kv_dtype!r}")
        if decode_path not in ("auto", "standard", "fused", "paged"):
            raise ValueError(f"unknown decode_path {decode_path!r}")
        self.device = resolve_device(device)
        param_dev = next(model.parameters()).device
        if param_dev != self.device:
            raise ValueError(f"model parameters live on {param_dev}, engine "
                             f"device is {self.device}")
        if admission_policy not in ("reject", "block"):
            raise ValueError(
                f"unknown admission_policy {admission_policy!r}")
        if max_queue_depth < 0:
            raise ValueError("max_queue_depth must be >= 0 (0 = unbounded)")
        if preemption_budget is not None and preemption_budget < 0:
            raise ValueError("preemption_budget must be >= 0 or None")
        if migration_budget is not None and migration_budget < 0:
            raise ValueError("migration_budget must be >= 0 or None")
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        if prefix_cache_min_hit_blocks < 1:
            raise ValueError("prefix_cache_min_hit_blocks must be >= 1")
        if host_tier_bytes < 0:
            raise ValueError("host_tier_bytes must be >= 0 (0 = no tier)")
        if host_tier_bytes and not (prefix_cache and chunked_prefill):
            raise ValueError(
                "host_tier_bytes requires the prefix cache (tier entries "
                "are addressed by its chain keys) — enable prefix_cache "
                "and chunked_prefill, or set host_tier_bytes=0")
        if host_tier_bytes and tp > 1:
            raise ValueError(
                "host_tier_bytes with tp>1 is unsupported — demoted page "
                "slices would need a cross-shard gather/scatter; run the "
                "host tier on single-chip replicas")
        if host_tier_bytes and sp > 1:
            raise ValueError(
                "host_tier_bytes with sp>1 is unsupported — a demoted "
                "block's pages live on one context-mesh shard and the "
                "re-admission write would need per-shard routing; run the "
                "host tier on single-chip replicas")
        self.drafter: Optional[spec_decode.Drafter] = None
        self.spec_mode = spec if isinstance(spec, str) else \
            getattr(spec, "name", "custom")
        self.spec_k = int(spec_k)
        if isinstance(spec, spec_decode.Drafter):
            self.drafter = spec
        elif spec == "ngram":
            self.drafter = spec_decode.NGramDrafter()
        elif spec == "draft":
            if draft_model is None:
                raise ValueError("spec='draft' needs draft_model")
            if draft_model.vocab_size != model.vocab_size:
                raise ValueError(
                    f"draft model vocab {draft_model.vocab_size} != target "
                    f"vocab {model.vocab_size}: drafted token ids must be "
                    "meaningful to the target")
            draft_dev = next(draft_model.parameters()).device
            if draft_dev != self.device:
                raise ValueError(f"draft model parameters live on "
                                 f"{draft_dev}, engine device is "
                                 f"{self.device}")
            self.drafter = spec_decode.DraftModelDrafter(draft_model)
        elif spec != "off":
            raise ValueError(f"unknown spec {spec!r} (off | ngram | draft | "
                             "a spec_decode.Drafter)")
        if self.drafter is not None:
            if not chunked_prefill:
                raise ValueError(
                    "speculative decoding requires chunked_prefill: the "
                    "ragged mixed step is its verification primitive")
            if self.spec_k < 1:
                raise ValueError("spec_k must be >= 1")
        self.max_queue_depth = int(max_queue_depth)
        self.admission_policy = admission_policy
        self.logit_guard = bool(logit_guard)
        self.kv_dtype = kv_dtype
        self.quant_weights = bool(quant_weights)
        moe = bool(getattr(model, "moe_experts", 0))
        self.tp = int(tp)
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        self._tp: Optional[TPContext] = None
        if self.tp > 1:
            if self.quant_weights:
                raise ValueError(
                    "quant_weights with tp>1 is unsupported — Int8Weight "
                    "leaves don't column-shard; serve fp weights under TP")
            if moe:
                raise ValueError(
                    "tensor-parallel serving does not support MoE models "
                    "(expert dispatch is not head-sharded)")
        self.sp = int(sp)
        if self.sp < 1:
            raise ValueError(f"sp must be >= 1, got {sp}")
        self._sp: Optional[SPContext] = None
        if self.sp > 1:
            if self.tp > 1:
                raise ValueError(
                    "sp>1 with tp>1 is unsupported, as in the JAX engine: "
                    "pick ONE of sp / tp per replica")
            if self.quant_weights:
                raise ValueError(
                    "quant_weights with sp>1 is unsupported, as in the JAX "
                    "engine (its int8 leaves re-materialize off the context "
                    "mesh); serve fp weights under SP")
            if moe:
                raise ValueError(
                    "sequence-parallel serving does not support MoE models "
                    "(expert dispatch is not sequence-sharded)")
            self._sp = SPContext(model, self.sp, devices=sp_devices)
        if self.tp > 1:
            self._tp = TPContext(model, self.tp, devices=tp_devices)
        self.model = quantize_for_decode(model) if self.quant_weights \
            else model
        # what the paged programs step: the shard adapter under SP or TP
        # (same paged interface over lists of shard pages)
        self._step_model = self._sp.model if self._sp \
            else self._tp.model if self._tp else self.model
        # the JAX engine's compile-key suffix: int8 pools and sharded
        # replicas run other programs than the f32 single-device one
        self._kv_key = (("int8",) if kv_dtype == "int8" else ()) + \
            ((f"tp{self.tp}",) if self.tp > 1 else ()) + \
            ((f"sp{self.sp}",) if self.sp > 1 else ())
        self.preemption_budget = preemption_budget
        self.migration_budget = migration_budget
        self.faults = faults
        self.pool = PagedKVPool(
            num_layers=model.num_layers, num_kv_heads=model.num_kv_heads,
            head_dim=model.d_model // model.num_heads, num_blocks=num_blocks,
            block_size=block_size, dtype=model.policy.compute_dtype,
            device=self.device, kv_dtype=kv_dtype, sp=self.sp, tp=self.tp,
            devices=(self._sp.devices if self._sp
                     else self._tp.devices if self._tp else None))
        self.pool.fault_plan = faults
        cap = min(model.max_len, self.pool.capacity * block_size)
        self.max_seq_len = min(max_seq_len or cap, cap)
        # fixed table width: every step passes this many blocks per row,
        # and the assembled paths gather this many positions per row
        self.blocks_per_seq = self.pool.blocks_for(self.max_seq_len)
        if self.blocks_per_seq % self.sp:
            raise ValueError(
                f"assembly width blocks_per_seq={self.blocks_per_seq} does "
                f"not divide over sp={self.sp} shards; pick max_seq_len (or "
                "num_blocks/block_size) so ceil(max_seq_len / block_size) "
                "is a multiple of sp")
        self.assembly_len = self.blocks_per_seq * block_size
        self.chunked_prefill = bool(chunked_prefill)
        self.scheduler = Scheduler(
            max_batch_size=max_batch_size, token_budget=token_budget,
            chunk_size=chunk_size if self.chunked_prefill else 0,
            spec_tokens=self.spec_k if self.drafter is not None else 0)
        self.prefix_cache: Optional[PrefixCache] = None
        # whole-prompt prefill scatters whole prompts over fresh tables, so
        # it shares no blocks: the cache is off there, as in the JAX engine
        if prefix_cache and self.chunked_prefill:
            self.prefix_cache = PrefixCache(
                block_size=block_size,
                min_hit_blocks=prefix_cache_min_hit_blocks)
            # free() parks still-indexed blocks in the evictable LRU;
            # alloc() reports the reclaimed ones so the index forgets them
            self.pool.evictable_filter = self.prefix_cache.contains_block
            self.pool.reclaim_hook = self.prefix_cache.drop_blocks
        # the host KV tier: demote_hook runs BEFORE reclaim_hook, while the
        # cache still maps block -> chain key
        self.kv_tier: Optional[HostKVTier] = None
        if host_tier_bytes:
            self.kv_tier = HostKVTier(int(host_tier_bytes), fault_plan=faults)
            self.pool.demote_hook = self._demote_blocks
        # admission probes the cache (read-only) to budget its grants
        self.scheduler.prefix_cache = self.prefix_cache
        self.prefix_publish_max_occupancy = float(prefix_publish_max_occupancy)
        # prefix publishes queued by a step's commit, run at its end
        self._deferred: List[Any] = []
        # (rid, error) of queued requests a submit shed: reported in the
        # next step's "failed" events
        self._shed: List[Tuple[int, str]] = []
        if trace and profiler is None:
            profiler = Profiler(source="engine")
        self.profiler = profiler
        self.metrics = ServingMetrics(profiler)
        self.tracer = Tracer(profiler if trace else None)
        if self._tp is not None:
            self._tp.tracer = self.tracer
        self.step_seq = 0                # begun steps, adopted ones included
        self._step_note: Optional[Dict[str, Any]] = None
        self._finished_note: Optional[Dict[str, Any]] = None
        self._last_step_latency_s = 0.0
        # host-side gauges cached at submit and commit (the static ones
        # once): the supervisor's health_gauges serves them to other
        # threads without an engine touch
        self._gauge_extras = {"kv_dtype": self.kv_dtype,
                              "kv_bytes_per_token":
                                  self.pool.kv_bytes_per_token,
                              "quant_weights": int(self.quant_weights),
                              "tp_degree": self.tp,
                              # each shard holds 1/tp of every page's heads
                              "kv_bytes_per_token_per_shard":
                                  (self.pool.kv_bytes_per_token
                                   + self.pool.kv_scale_bytes_per_token)
                                  // self.tp,
                              "sp_degree": self.sp,
                              "pool_blocks_per_shard":
                                  self.pool.blocks_per_shard,
                              "host_tier_max_bytes": int(host_tier_bytes)}
        # the stall clock: the last step that emitted decode-phase tokens
        self._last_decode_emit: Optional[float] = None
        # distinct program compile keys run (JAX's len(self._jit))
        self._compile_keys: set = set()
        self._refresh_gauges()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.overlap = bool(overlap)
        # TNN_DEBUG_SYNC=1: the step runs under torch's sync-debug mode
        # (sync_guard), armed on a CUDA engine only
        self.debug_sync = os.environ.get("TNN_DEBUG_SYNC", "") == "1"
        self._sync_armed = self.debug_sync and self.device.type == "cuda"
        self._flight: Optional[StepInFlight] = None
        self._t_fetch_done: Optional[float] = None
        # the two pinned host buffers the steps' bundles land in, in turn
        self._pinned: List[Optional[torch.Tensor]] = [None, None]
        self._pinned_slot = 0
        # captured pdecode programs by compile key (step_graph.py); only
        # the card comparison sets _eager_steps to run them eagerly
        self._graphs: Dict[tuple, step_graph.DecodeGraph] = {}
        self._eager_steps = False
        self.requests: Dict[int, Request] = {}
        self._rid = itertools.count()
        self.model_steps = 0     # committed steps that ran a model forward
        # dispatched programs: "mixed" / "pdecode" on the paged path,
        # "mixed_standard" / "decode" / "fdecode" (lockstep, the fused
        # kernel) off it, "prefill" for a whole-prompt prefill; a
        # rolled-back speculative dispatch counts here, not in model_steps
        self.program_steps: collections.Counter = collections.Counter()
        self.paged_fallback_reason: Optional[str] = None
        self.fused_fallback_reason: Optional[str] = None
        self._paged = False
        self._fused: Optional[Dict[str, Any]] = None
        # auto probes paged first: it serves ragged batches natively and
        # never assembles a cache
        if decode_path in ("auto", "paged"):
            try:
                self._probe_paged()
                self._paged = True
            except ValueError as e:
                if decode_path == "paged":
                    raise
                self.paged_fallback_reason = str(e)
        else:
            self.paged_fallback_reason = \
                f"disabled (decode_path={decode_path!r})"
        if self._paged:
            self.fused_fallback_reason = "unused (paged decode path selected)"
        elif decode_path in ("auto", "fused"):
            try:
                self._fused = self._probe_fused(max_batch_size)
            except ValueError as e:
                if decode_path == "fused":
                    raise
                self.fused_fallback_reason = str(e)
        else:
            self.fused_fallback_reason = \
                f"disabled (decode_path={decode_path!r})"

    # -- decode-path probes ---------------------------------------------------

    def _probe_paged(self) -> None:
        """Validate the paged decode path against this model; raises
        ValueError (with the reason) when auto must fall back."""
        if not hasattr(self.model, "apply_decode_paged"):
            raise ValueError(
                f"{type(self.model).__name__} has no apply_decode_paged: the "
                "paged path needs the model to decode straight against pool "
                "pages (see GPT2.apply_decode_paged)")

    def _probe_fused(self, batch: int) -> Dict[str, Any]:
        """Validate the fused decode kernel against this model and pool;
        raises ValueError (with the reason) when the standard path must be
        used: the JAX engine's refusals, then, on CUDA, every static limit
        of K8 (``decode_stack.check_kernel_geometry``) at the geometry the
        fused program always runs, ``batch`` rows (``pack_decode`` pads to
        it) over the whole assembly."""
        if any(getattr(b, "moe", None) is not None
               for b in self.model.blocks):
            raise ValueError("fused decode does not support MoE blocks")
        if self.kv_dtype == "int8":
            raise ValueError(
                "fused decode assembles a contiguous compute-dtype cache: "
                "int8 pages would dequantize outside the kernel with no "
                "bandwidth win; int8 pools use the paged or standard path")
        if self.tp > 1:
            raise ValueError(
                "fused decode stacks whole-model weights into one kernel "
                "invocation — head-sharded TP params cannot stack; tp>1 "
                "serves the paged or standard path")
        if self.sp > 1:
            raise ValueError(
                "fused decode assembles one chip's contiguous cache: a "
                "block-sharded SP pool has no single-chip cache to "
                "assemble; sp>1 serves the paged or standard path")
        model = self.model
        chunks = fused_decode.pick_chunks(
            model.d_model, 4 * model.d_model, batch, self.assembly_len)
        if chunks is None:
            raise ValueError("model too large for the fused kernel's VMEM "
                             "budget at this batch/assembly geometry")
        if self.device.type == "cuda":
            check_kernel_geometry(
                batch, model.d_model, 4 * model.d_model, chunks,
                model.d_model // model.num_heads,
                model.policy.compute_dtype,
                blocks=runtime.sm_count(self.device))
        return {"stacks": fused_decode.stack_decode_weights(model),
                "chunks": chunks}

    # -- request lifecycle ----------------------------------------------------

    def _refresh_gauges(self) -> None:
        self._health_gauges = {
            "queue_depth": self.scheduler.queue_depth,
            "num_running": len(self.scheduler.running),
            "step_latency_s": self._last_step_latency_s,
            "tier_blocks": len(self.kv_tier) if self.kv_tier is not None
            else 0,
            **self._gauge_extras}

    def submit(self, prompt_ids, max_new_tokens: int, *,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
               stop_token: Optional[int] = None,
               deadline_s: Optional[float] = None,
               max_queue_s: Optional[float] = None,
               priority: int = 0,
               migration_budget: Optional[int] = None,
               trace_id: Optional[str] = None) -> int:
        """Queue a generation request; returns its request id.
        ``deadline_s`` bounds its wall time from submit, ``max_queue_s``
        any one stretch it waits QUEUED; past either it is TIMED_OUT.
        ``migration_budget`` caps its crash re-admissions (None: the
        engine's); ``trace_id`` names its trace (default ``t<rid>``).

        With ``max_queue_depth`` set and the queue full, "reject" FAILs the
        queued request ``shed_victim`` names (a larger ``priority`` value
        is less important), reported in the next step's "failed" events,
        or raises ``AdmissionRejected``; "block" runs ``step()`` until the
        queue has room."""
        prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        if prompt.min() < 0 or prompt.max() >= self.model.vocab_size:
            raise ValueError(f"prompt token ids must lie in [0, "
                             f"{self.model.vocab_size})")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        total = prompt.size + max_new_tokens
        if total > self.max_seq_len:
            raise ValueError(
                f"prompt {prompt.size} + max_new_tokens {max_new_tokens} "
                f"exceeds max_seq_len {self.max_seq_len}")
        if self.pool.blocks_for(total) > self.pool.capacity:
            raise ValueError(
                f"request needs {self.pool.blocks_for(total)} blocks but the "
                f"pool only has {self.pool.capacity}")
        if self.max_queue_depth and \
                self.scheduler.queue_depth >= self.max_queue_depth:
            if self.admission_policy == "reject":
                victim = self.scheduler.shed_victim(int(priority))
                if victim is None:
                    self.metrics.observe_rejected()
                    raise AdmissionRejected(self.scheduler.queue_depth,
                                            self.max_queue_depth)
                self._terminate(
                    victim, RequestState.FAILED,
                    f"shed under overload: queued at priority "
                    f"{victim.priority}, displaced by a priority "
                    f"{int(priority)} arrival", {"failed": self._shed},
                    "failed")
                self.metrics.observe_shed()
            # "block": every step admits or expires work, and the queue
            # head fits an empty pool (checked above), so this ends
            while self.has_work and \
                    self.scheduler.queue_depth >= self.max_queue_depth:
                self.step()
        rid = next(self._rid)
        req = Request(rid=rid, prompt=prompt,
                      max_new_tokens=int(max_new_tokens),
                      temperature=float(temperature), top_k=int(top_k),
                      top_p=float(top_p), stop_token=stop_token,
                      submit_time=time.perf_counter(),
                      deadline_s=deadline_s, max_queue_s=max_queue_s,
                      priority=int(priority),
                      migration_budget=(self.migration_budget
                                        if migration_budget is None
                                        else int(migration_budget)))
        req.trace_id = trace_id if trace_id else f"t{rid}"
        self.requests[rid] = req
        self.scheduler.submit(req)
        self._refresh_gauges()
        if self.tracer.enabled:
            self.tracer.instant("serve.submit", trace=req.trace_id, rid=rid)
        return rid

    def cancel(self, rid: int, reason: str = "cancelled by client") -> bool:
        """Abort a queued or running request: its blocks are freed and it
        is CANCELLED, with ``reason`` as its error. Returns False when the
        id is unknown or already terminal. A step in flight skips its
        row at commit."""
        req = self.requests.get(rid)
        if req is None or req.state in TERMINAL_STATES:
            return False
        self._terminate(req, RequestState.CANCELLED, reason)
        return True

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    @property
    def in_flight(self) -> Optional[StepInFlight]:
        """The dispatched, uncommitted step, when one is pending."""
        return self._flight

    def result(self, rid: int) -> Request:
        return self.requests[rid]

    def output_tokens(self, rid: int) -> List[int]:
        return list(self.requests[rid].out_tokens)

    def abort_all(self, reason: str, *,
                  state: RequestState = RequestState.FAILED,
                  include_queued: bool = False,
                  reset_pages: bool = True) -> Dict[str, List]:
        """Terminate every RUNNING request (with ``include_queued`` every
        QUEUED one too) in ``state`` with ``reason``; with ``reset_pages``
        zero the pool's pages and drop the prefix index (zeroed pages no
        longer hold the indexed KV). A step in flight is dropped, its
        whole-prompt prefills terminated with the rest. Returns step-shaped
        event buckets."""
        events: Dict[str, List] = {"tokens": [], "finished": [],
                                   "failed": [], "timed_out": []}
        bucket = "timed_out" if state is RequestState.TIMED_OUT \
            else "failed"
        if self._flight is not None:
            self._abort_flight(self._flight, reason, state, events, bucket)
        self._flight = None
        self._deferred.clear()
        for req in list(self.scheduler.running):
            self._terminate(req, state, reason, events, bucket)
        if include_queued:
            for req in list(self.scheduler.waiting):
                self._terminate(req, state, reason, events, bucket)
        if reset_pages:
            self._reset_pages()
        return events

    def _reset_pages(self) -> None:
        """Zero the pool's pages and drop the prefix index: zeroed pages no
        longer hold the indexed KV."""
        self.pool.reset_pages()
        self._last_decode_emit = None
        if self.prefix_cache is not None:
            # purge without demoting: zeroed pages are never salvaged
            self.pool.purge_evictable()
            self.prefix_cache.clear()
        if self.kv_tier is not None:
            # entries demoted before the failure derive from pages that can
            # no longer be cross-checked: nothing pre-failure re-admits
            self.kv_tier.clear()

    def migrate_running(self, reason: str) -> Dict[str, List]:
        """Crash re-admission (the supervisor's restart): every RUNNING
        request loses its KV but not its progress. Its committed tokens
        become an extended prompt through the scheduler's resume path, so
        its stream goes on from the last emitted token, token-exact under
        greedy decoding; a request whose ``migration_budget`` is spent
        FAILs instead (a poison request must not wedge the restart loop).
        A step in flight (with its speculative successor) is dropped, the
        pages are zeroed and the prefix index dropped, as in ``abort_all``.
        Returns step-shaped buckets holding only the budget failures."""
        events: Dict[str, List] = {"tokens": [], "finished": [],
                                   "failed": [], "timed_out": []}
        if self._flight is not None:
            # whole-prompt prefills the dropped step launched were never
            # admitted: back to the queue's front, in their order, blocks
            # freed (no migration is charged)
            for req in reversed(self._flight.prefills):
                if req.state is RequestState.QUEUED \
                        and req not in self.scheduler.waiting:
                    if req.block_table:
                        self.pool.free(req.block_table)
                        req.block_table = []
                    req.cache_len = 0
                    self.scheduler.waiting.appendleft(req)
        self._flight = None
        self._deferred.clear()
        now = time.perf_counter()
        for req in list(self.scheduler.running):
            budget = req.migration_budget
            if budget is not None and req.migrations >= budget:
                self._terminate(
                    req, RequestState.FAILED,
                    f"migration budget exhausted ({budget}) — last "
                    f"failure: {reason}", events, "failed")
                continue
            self._note_leave_running(req, now)
            self.pool.free(req.block_table)
            req.block_table = []
            req.cache_len = 0
            self.scheduler.migrate(req)
            self.metrics.observe_migration(len(req.resume_tokens))
            if self.tracer.enabled:
                self.tracer.instant("serve.migrate", trace=req.trace_id,
                                    rid=req.rid, step=self.step_seq)
        self._reset_pages()
        return events

    def release(self) -> None:
        """Drop the pool's pages, the captured graphs and the host tier:
        the engine serves nothing afterwards (a retired replica's end).
        Its bookkeeping and metrics stay readable. Under the capture lock:
        another replica's worker may be capturing, and a graph's teardown
        must not land inside its capture."""
        with step_graph._CAPTURE_LOCK:
            self._graphs.clear()
            self.pool.release_pages()
        if self.kv_tier is not None:
            self.kv_tier.clear()

    def stats(self) -> Dict[str, Any]:
        s: Dict[str, Any] = dict(self.metrics.summary())
        for st in RequestState:
            s[f"requests_{st.value}"] = sum(
                1 for r in self.requests.values() if r.state is st)
        s.update({"queue_depth": self.scheduler.queue_depth,
                  "num_running": len(self.scheduler.running),
                  "pool_free_blocks": self.pool.num_free,
                  "pool_allocated_blocks": self.pool.num_allocated,
                  "pool_evictable_blocks": self.pool.num_evictable,
                  "prefix_cache_enabled": self.prefix_cache is not None,
                  "prefix_indexed_blocks": (len(self.prefix_cache)
                                            if self.prefix_cache is not None
                                            else 0),
                  "prefix_publish_suspended_now": (
                      self.prefix_cache is not None
                      and self.pool.occupancy
                      > self.prefix_publish_max_occupancy),
                  "chunked_prefill": self.chunked_prefill,
                  "spec": self.spec_mode,
                  "spec_k": self.spec_k if self.drafter is not None else 0,
                  "model_steps": self.model_steps,
                  "kv_dtype": self.kv_dtype,
                  "kv_bytes_per_token": self.pool.kv_bytes_per_token,
                  "kv_scale_bytes_per_token":
                      self.pool.kv_scale_bytes_per_token,
                  "quant_weights": self.quant_weights,
                  "tp_degree": self.tp,
                  "kv_bytes_per_token_per_shard":
                      self._gauge_extras["kv_bytes_per_token_per_shard"],
                  "compiled_step_signatures": len(self._compile_keys),
                  "decode_path": ("paged" if self._paged
                                  else "fused" if self._fused is not None
                                  else "standard"),
                  "program_steps": dict(self.program_steps),
                  "overlap": self.overlap,
                  "step_graphs": len(self._graphs),
                  "graph_replays": sum(g.replays
                                       for g in self._graphs.values()),
                  "sp_degree": self.sp,
                  "pool_blocks_per_shard": self.pool.blocks_per_shard,
                  "step_seq": self.step_seq,
                  "host_tier_enabled": self.kv_tier is not None})
        # tier counters: live with a tier, zeroed keys without one
        s.update(self.kv_tier.stats() if self.kv_tier is not None else {
            "tier_blocks": 0, "tier_bytes": 0, "tier_max_bytes": 0,
            "tier_demotions": 0, "tier_demote_failures": 0,
            "tier_readmits": 0, "tier_corrupt_dropped": 0,
            "tier_evictions": 0})
        return s

    def check_invariants(self) -> None:
        """Pool bookkeeping plus full block accounting against every
        running request's table."""
        running = [r for r in self.scheduler.running if r.block_table]
        self.pool.check_invariants([r.block_table for r in running],
                                   [r.cache_len for r in running])
        if self.kv_tier is not None:
            self.kv_tier.check_invariants()

    def run_until_complete(self, max_steps: int = 100_000) \
            -> Dict[int, List[int]]:
        """Step until every request is terminal; returns {rid: generated
        tokens} of the FINISHED ones. With ``overlap`` this is the
        overlapped drive loop: dispatch, speculate, deferred work, then
        fetch and commit."""
        steps = 0
        while self.has_work or self._flight is not None:
            if self.overlap:
                if self._flight is None:
                    self.begin_step()
                self.try_speculate()
                self.run_deferred()
                self.finish_step()
            else:
                self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"no convergence after {max_steps} steps")
        self.run_deferred()
        return {rid: list(r.out_tokens) for rid, r in self.requests.items()
                if r.state is RequestState.FINISHED}

    # -- engine step ----------------------------------------------------------

    def step(self) -> Dict[str, List]:
        """Run one serving step: expire deadlines, admit, then one mixed
        prefill+decode step (or a pure-decode step), then the step's prefix
        publishes. Returns the step's events::

            {"tokens": [(rid, token), ...], "finished": [rid, ...],
             "failed": [(rid, error), ...], "timed_out": [(rid, error), ...]}

        Always synchronous: a step already in flight (an overlapped drive
        dispatched it) is finished, else one is begun and finished; the
        deferred publishes run before it returns."""
        if self._flight is None:
            self.begin_step()
        events = self.finish_step()
        self.run_deferred()
        return events

    def begin_step(self) -> StepInFlight:
        """Build and dispatch one step without fetching its results:
        deadlines, scheduling, admission, staging and the launch; the
        step's one fetch is staged, not waited on. Raises RuntimeError
        when a step is in flight already."""
        if self._flight is not None:
            raise RuntimeError("a step is already in flight: finish_step() "
                               "first")
        self.step_seq += 1
        fired_before = (collections.Counter(self.faults.fired)
                        if self.faults is not None else None)
        # made before the body runs: a crash at the step's very top
        # (faults.on_step) still leaves a record naming the batch
        note: Dict[str, Any] = {
            "step_seq": self.step_seq,
            "queued": self.scheduler.queue_depth,
            "running_rids": [r.rid for r in self.scheduler.running],
            "programs": []}
        self._step_note = note
        flight = StepInFlight(time.perf_counter(), note, fired_before)
        flight.gen_before = {
            r.rid: r.num_generated for r in self.scheduler.running
            if r.state is RequestState.RUNNING
            and r.cache_len >= r.prefill_len}
        try:
            with torch.inference_mode(), self._sync_guard():
                self._build_step(flight)
        except sync_guard.SyncTripped as e:
            # as the JAX engine's transfer error: the step's requests
            # FAIL, the pages are zeroed, the engine serves on
            self._abort_batch(list(self.scheduler.running),
                              f"step failed: {e}", flight.events,
                              flight.prefills)
            flight.recs, flight.fetch = [], None
        except BaseException as e:
            self._finalize_note(flight)
            self._abort_flight(flight, f"step failed: {e}")
            raise
        self._flight = flight
        return flight

    def finish_step(self) -> Dict[str, List]:
        """Wait for the in-flight step's bundle and commit it; then adopt
        or roll back a speculative successor, so that ``in_flight`` is the
        adopted step or None. Returns the step's events."""
        flight = self._flight
        if flight is None:
            raise RuntimeError("no step in flight")
        try:
            with torch.inference_mode(), self._sync_guard():
                self._commit_step(flight)
        except sync_guard.SyncTripped as e:
            flight.sync_trip = f"step commit failed: {e}"
        finally:
            self._flight = None
            self._finalize_note(flight)
            self._finished_note = flight.note
        if flight.sync_trip is not None:
            self._abort_batch(list(self.scheduler.running),
                              flight.sync_trip, flight.events)
        self.metrics.observe_step_latency(flight.latency_s)
        self._last_step_latency_s = flight.latency_s
        # a decode-phase row that survived the step without a token spent
        # it stalled (a retried fault, a step behind peer prefills)
        for r in self.scheduler.running:
            if r.state is RequestState.RUNNING and \
                    r.num_generated == flight.gen_before.get(r.rid, -1):
                r.stall_s += flight.latency_s
        self._resolve_speculation(flight)
        events = flight.events
        if self._shed:
            events["failed"][:0] = self._shed
            self._shed = []
        return events

    def run_deferred(self) -> None:
        """Run the queued prefix publishes (work no commit depends on).
        The overlapped loop runs them while a step is on the card."""
        while self._deferred:
            self._deferred.pop(0)()

    # -- the flight recorder's notes (JAX's _finalize_note, last_step_record,
    # last_finished_record, _note_program) ------------------------------------

    def _finalize_note(self, flight: StepInFlight) -> None:
        dt = time.perf_counter() - flight.t0
        flight.latency_s = dt
        note = flight.note
        note["step_latency_s"] = round(dt, 6)
        note["pool_allocated"] = self.pool.num_allocated
        note["pool_evictable"] = self.pool.num_evictable
        before = flight.fired_before
        note["faults_fired"] = {} if before is None else {
            k: int(v - before.get(k, 0))
            for k, v in self.faults.fired.items() if v - before.get(k, 0)}

    def last_step_record(self) -> Optional[Dict[str, Any]]:
        """The newest step's flight-recorder record: each launched program's
        kind, compile key, rows and fill, queue depth, pool occupancy, step
        latency, faults fired. None before the first step. A crashing step
        still finalizes its record."""
        return dict(self._step_note) if self._step_note is not None \
            else None

    def last_finished_record(self) -> Optional[Dict[str, Any]]:
        """The record of the newest step that committed: under overlap the
        newest note may belong to a step still in flight."""
        return dict(self._finished_note) \
            if self._finished_note is not None else None

    def _note_program(self, kind: str, key, rids: List[int],
                      fill: float) -> None:
        """Attach one launched program to the current step's note; the
        key gains the engine's ``_kv_key`` suffix."""
        key = tuple(key) + self._kv_key
        self._compile_keys.add(key)
        if self._step_note is not None:
            self._step_note["programs"].append(
                {"kind": kind, "compile_key": list(key),
                 "rids": list(rids), "fill": round(fill, 4)})

    def _sync_guard(self):
        """The step's TNN_DEBUG_SYNC region (``sync_guard.guarded``) on an
        armed engine, else nothing."""
        return sync_guard.guarded() if self._sync_armed \
            else contextlib.nullcontext()

    def _sync_exempt(self):
        """A deliberate transfer inside the step: the guard's exempt
        point on an armed engine, else nothing."""
        return sync_guard.exempt() if self._sync_armed \
            else contextlib.nullcontext()

    # -- per-request latency clocks (JAX's _note_admit, _note_prefill_done,
    # _note_leave_running) ----------------------------------------------------

    def _note_admit(self, req: Request, now: float) -> None:
        """Close the queued clock at admission, open the prefill phase."""
        wait = max(0.0, now - req.queued_time)
        req.queued_s += wait
        self.metrics.observe_queue_wait(wait)
        req.phase = "prefill"
        req.phase_t0 = now
        if self.tracer.enabled:
            self.tracer.instant("serve.admit", trace=req.trace_id,
                                rid=req.rid, step=self.step_seq)

    def _note_prefill_done(self, req: Request, now: float) -> None:
        if req.phase == "prefill":
            req.prefill_s += max(0.0, now - req.phase_t0)
        req.phase = "decode"
        req.phase_t0 = now

    def _note_leave_running(self, req: Request, now: float) -> None:
        """Close the open phase clock: preemption, migration or a terminal
        exit ends the running stretch alike."""
        if req.phase == "prefill":
            req.prefill_s += max(0.0, now - req.phase_t0)
        elif req.phase == "decode":
            req.decode_s += max(0.0, now - req.phase_t0)
        req.phase = ""

    def _build_step(self, flight: StepInFlight) -> None:
        events = flight.events
        if self.faults is not None:
            self.faults.on_step()
        self._enforce_deadlines(events)
        plan = self.scheduler.schedule(self.pool)
        if self.chunked_prefill:
            chunks = dict(plan.chunks)
            for req in plan.prefills:
                if not self._admit(req, events):
                    chunks.pop(req.rid, None)
                elif req.rid in chunks:
                    # the grant was budgeted against the scheduler's probe:
                    # clamp it to the tail the fork left (a clone that
                    # found no block admitted uncached)
                    chunks[req.rid] = min(chunks[req.rid],
                                          req.prefill_len - req.cache_len)
            rec = self._build(chunks, events)
            if rec is not None:
                flight.recs.append(rec)
        else:
            # whole-prompt prefills launch before the step's decode and
            # commit from the same fetch: a row admitted here takes its
            # first decode token next step
            flight.prefills = list(plan.prefills)
            for req in plan.prefills:
                self._prefill_build(req, flight)
            self._ensure_decode_capacity(events)
            live = [r for r in self.scheduler.running
                    if r.state is RequestState.RUNNING
                    and r.cache_len >= r.prefill_len]
            if live:
                rec = self._decode_launch(live, events=events,
                                          pending=flight.prefills)
                if rec is not None:
                    flight.recs.append(rec)
        if flight.recs:
            flight.fetch = self._stage_fetch(flight.recs)

    def _commit_step(self, flight: StepInFlight) -> None:
        if not flight.recs:
            return
        try:
            outs = self._fetch_bundle(flight.fetch)
        except BaseException as e:
            self._abort_flight(flight, f"step fetch failed: {e}")
            raise
        self.model_steps += 1
        for rec, out in zip(flight.recs, outs):
            if rec["kind"] == "prefill":
                self._prefill_commit(rec, out, flight.events)
            elif rec["kind"] == "decode":
                self._decode_commit(rec, out, flight.events)
            else:
                self._mixed_commit(rec, out, flight.events)
        if not any(r.state is RequestState.RUNNING
                   and r.cache_len >= r.prefill_len
                   for r in self.scheduler.running):
            # no decode-phase rows left: the next decode token starts a new
            # stream, so the stall clock must not span the idle gap
            self._last_decode_emit = None
        self.metrics.observe_gauges(
            self.scheduler.queue_depth, self.pool.occupancy,
            self.pool.kv_bytes_per_token, tp_degree=self.tp,
            sp_degree=self.sp,
            tier_blocks=len(self.kv_tier) if self.kv_tier is not None else 0,
            tier_bytes=self.kv_tier.bytes_used if self.kv_tier is not None
            else 0.0)
        self._refresh_gauges()

    def _abort_flight(self, flight: StepInFlight, error: str,
                      state: RequestState = RequestState.FAILED,
                      events=None, bucket: str = "failed") -> None:
        """A step that cannot commit: the requests its whole-prompt
        prefills were to admit (popped from the queue, in neither the queue
        nor the running set) end in ``state``, their blocks freed, so that
        no request is lost. Rows the scheduler holds are left to the
        caller."""
        for req in flight.prefills:
            if req.state is RequestState.QUEUED:
                self._terminate(req, state, error,
                                flight.events if events is None else events,
                                bucket)

    def _stage_fetch(self, recs: Sequence[Dict[str, Any]]) -> Dict:
        """Queue the step's one fetch behind its launches: every record's
        int64 results back to back in one device tensor; on CUDA a
        non-blocking copy of it into the next of two pinned host buffers
        (a step and its speculative successor are in flight at most),
        then an event ``_fetch_bundle`` waits on."""
        devs = [rec["dev"].reshape(-1) for rec in recs]
        dev = devs[0] if len(devs) == 1 else torch.cat(devs)
        fetch: Dict[str, Any] = {"dev": dev,
                                 "shapes": [tuple(r["dev"].shape)
                                            for r in recs]}
        if dev.device.type != "cuda":
            return fetch
        slot = self._pinned_slot
        self._pinned_slot ^= 1
        buf = self._pinned[slot]
        if buf is None or buf.numel() < dev.numel():
            buf = self._pinned[slot] = torch.empty(
                max(dev.numel(), 1024), dtype=torch.int64, pin_memory=True)
        host = buf[:dev.numel()]
        host.copy_(dev, non_blocking=True)
        fetch["host"] = host
        fetch["ready"] = torch.cuda.Event()
        fetch["ready"].record()
        return fetch

    def _fetch_bundle(self, fetch: Dict[str, Any]) -> List[np.ndarray]:
        """The step's one device-to-host fetch, split back into each
        record's results."""
        with profiled("serve.fetch", EventType.COMPUTE, self.profiler), \
                self._sync_exempt():
            if "ready" in fetch:
                fetch["ready"].synchronize()
                flat = fetch["host"].numpy().copy()
            else:
                flat = fetch["dev"].numpy().copy()
        self._t_fetch_done = time.perf_counter()
        outs, at = [], 0
        for shape in fetch["shapes"]:
            n = int(np.prod(shape))
            outs.append(flat[at:at + n].reshape(shape))
            at += n
        return outs

    def _mark_dispatch(self) -> None:
        """Before a step's launch: the wall gap since the previous bundle
        fetch is the host gap the overlapped loop exists to close. A
        speculative dispatch precedes the fetch it would wait for; its
        adoption records a zero gap instead."""
        t = self._t_fetch_done
        if t is None:
            return
        self._t_fetch_done = None
        gap = time.perf_counter() - t
        self.metrics.observe_host_gap(gap)
        for r in self.scheduler.running:
            if r.state is RequestState.RUNNING:
                r.host_gap_s += gap
        if self.tracer.enabled:
            self.tracer.instant("serve.host_gap", step=self.step_seq,
                                ms=round(gap * 1e3, 3))

    def _enforce_deadlines(self, events) -> None:
        now = time.perf_counter()
        for req in list(self.scheduler.waiting):
            if req.deadline_s is not None and \
                    now - req.submit_time > req.deadline_s:
                self._terminate(
                    req, RequestState.TIMED_OUT,
                    f"deadline {req.deadline_s}s exceeded while queued",
                    events, "timed_out")
            elif req.max_queue_s is not None and \
                    now - req.queued_time > req.max_queue_s:
                self._terminate(
                    req, RequestState.TIMED_OUT,
                    f"max_queue_s {req.max_queue_s}s exceeded",
                    events, "timed_out")
        for req in list(self.scheduler.running):
            if req.deadline_s is not None and \
                    now - req.submit_time > req.deadline_s:
                self._terminate(
                    req, RequestState.TIMED_OUT,
                    f"deadline {req.deadline_s}s exceeded after "
                    f"{req.num_generated} tokens", events, "timed_out")

    # -- speculative step pipelining ------------------------------------------

    def try_speculate(self) -> bool:
        """Dispatch step N+1 while step N is in flight, when N+1's build
        is fixed by committed state and N's unfetched tokens: a pure
        decode step N whose rows all survive its commit (no stop token, no
        deadline, room for two more tokens), the same rows still running,
        KV growth that fits without preemption, no drafter, no fault
        plan, an empty wait queue, and not the fused path. The dispatch
        reads N's sampled tokens on the device, so nothing syncs;
        ``finish_step`` adopts it or rolls it back. Its KV writes land at
        positions at or past every surviving row's committed length, or in
        blocks a rollback frees: always overwritten before they are read.
        Returns True when a step was dispatched."""
        flight = self._flight
        if (not self.overlap or flight is None or flight.spec is not None
                or self.faults is not None
                or self.drafter is not None or self.scheduler.waiting
                or len(flight.recs) != 1
                or flight.recs[0]["kind"] != "decode"
                or not (self._paged or self._fused is None)):
            return False
        rec = flight.recs[0]
        live = rec["live"]
        if live != [r for r in self.scheduler.running
                    if r.state is RequestState.RUNNING]:
            return False
        grows = []
        for req in live:
            if (req.cache_len < req.prefill_len
                    or req.stop_token is not None
                    or req.deadline_s is not None
                    or req.num_generated + 1 >= req.max_new_tokens
                    or req.cache_len + 2 > self.max_seq_len):
                return False
            grows.append(max(0, self.pool.blocks_for(req.cache_len + 2)
                             - len(req.block_table)))
        if sum(grows) and not self.pool.can_alloc(sum(grows)):
            return False
        rollback: List[Any] = []

        def undo() -> None:
            for req, orig, ext in rollback:
                self.pool.free(ext)
                del req.block_table[orig:]

        try:
            for req, g in zip(live, grows):
                if g:
                    ext = self.pool.alloc(g, start=len(req.block_table))
                    rollback.append((req, len(req.block_table), ext))
                    req.block_table.extend(ext)
        except PoolExhausted:
            undo()
            return False
        # the predicted row state: each offset one token on
        step = step_build.pack_decode(
            live, b=self.scheduler.max_batch_size, nb=self.blocks_per_seq,
            scratch=PagedKVPool.SCRATCH, paged=self._paged,
            fused_available=False, speculative=True)
        gen_state = self.generator.get_state()
        t0 = time.perf_counter()
        try:
            with torch.inference_mode(), self._sync_guard(), \
                    profiled("serve.decode_spec", EventType.COMPUTE,
                             self.profiler):
                nxt = self._decode_launch(live, step,
                                          toks=rec["dev"][0])
                fetch = self._stage_fetch([nxt])
        except BaseException as e:
            undo()
            self.generator.set_state(gen_state)
            if not isinstance(e, sync_guard.SyncTripped):
                raise
            # step N commits; its rows then FAIL with the trip
            flight.sync_trip = f"speculative dispatch failed: {e}"
            return False
        b = self.scheduler.max_batch_size
        key = (step.program, b, self.blocks_per_seq) + self._kv_key
        self._compile_keys.add(key)
        flight.spec = {"rec": nxt, "fetch": fetch, "t0": t0,
                       "rollback": rollback,
                       "gen_state": gen_state,
                       "offsets": {r.rid: int(step.offsets[i])
                                   for i, r in enumerate(live)},
                       "prog": {"kind": "decode_paged" if self._paged
                                else "decode",
                                "compile_key": list(key),
                                "rids": [r.rid for r in live],
                                "fill": round(len(live) / b, 4)}}
        return True

    def _resolve_speculation(self, flight: StepInFlight) -> None:
        """After ``flight`` committed: adopt its speculative successor when
        the prediction held (the same rows, each exactly one token on,
        still running, the queue still empty), else roll it back: free its
        pre-grown blocks and restore the generator's state, so the rebuilt
        step draws what overlap-off draws."""
        spec = flight.spec
        if spec is None:
            return
        flight.spec = None
        rec = spec["rec"]
        live = rec["live"]
        predicted = (
            not self.scheduler.waiting
            and live == [r for r in self.scheduler.running
                         if r.state is RequestState.RUNNING]
            and all(req.cache_len == spec["offsets"][req.rid]
                    for req in live))
        if not predicted:
            for req, orig, ext in spec["rollback"]:
                if req.block_table[orig:orig + len(ext)] == ext:
                    # a terminated or preempted row freed its whole table
                    # already, extension included
                    self.pool.free(ext)
                    del req.block_table[orig:]
            self.generator.set_state(spec["gen_state"])
            self.metrics.observe_overlap_rebuild()
            return
        # the dispatched step is the next step: its step number and note
        # are given at adoption
        self.step_seq += 1
        note: Dict[str, Any] = {
            "step_seq": self.step_seq,
            "queued": self.scheduler.queue_depth,
            "running_rids": [r.rid for r in live],
            "programs": [dict(spec["prog"])],
            "speculative": True}
        self._step_note = note
        nxt = StepInFlight(spec["t0"], note)
        nxt.gen_before = {r.rid: r.num_generated for r in live}
        nxt.recs = [rec]
        nxt.fetch = spec["fetch"]
        self._flight = nxt
        self.metrics.observe_overlap_adopted()
        self.metrics.observe_host_gap(0.0)
        self._t_fetch_done = None

    def _admit(self, req: Request, events) -> bool:
        nb_total = self.pool.blocks_for(req.prefill_len)
        if nb_total > self.blocks_per_seq:
            self._terminate(req, RequestState.FAILED,
                            f"oversized resume: {req.prefill_len} tokens "
                            f"need {nb_total} blocks > {self.blocks_per_seq}",
                            events, "failed")
            return False
        req.cache_len = 0
        if self.prefix_cache is not None:
            self._match_prefix(req)
        self._note_admit(req, time.perf_counter())
        self.scheduler.admit(req)
        return True

    def _match_prefix(self, req: Request) -> None:
        """Admission-time cache hit: fork the matched blocks into the
        request's table and mark their positions resident, so the chunked
        prefill pushes only the uncached tail. A full-cover hit forks all
        but its last block and clones that one (the recomputed last token
        writes inside it; indexed blocks are immutable). If the clone finds
        no block, the forks are released and the request admits uncached:
        a cache miss, not a failure."""
        seq = req.resume_tokens
        if self.kv_tier is not None and len(self.kv_tier):
            self._tier_readmit(seq)
        blocks, cached, cow = self.prefix_cache.probe(seq)
        self.metrics.observe_prefix_lookup(cached if blocks else 0, len(seq))
        if not blocks:
            return
        table = self.pool.fork(blocks[:-1] if cow else blocks)
        if cow:
            # alloc's start is a table position: the owner shard's index
            # puts the clone on its source's shard, where the copy runs
            try:
                copy = self.pool.alloc(1, start=self.pool.owner(blocks[-1]))
            except PoolExhausted:
                if table:
                    self.pool.free(table)
                return
            self.pool.copy_block(blocks[-1], copy[0])
            table = table + copy
            self.metrics.observe_prefix_cow()
        req.block_table = table
        req.cache_len = cached

    # -- the host KV tier -----------------------------------------------------

    def _demote_blocks(self, blocks: List[int]) -> None:
        """``pool.demote_hook``: copy reclaimed-but-indexed blocks to the
        host tier before ``reclaim_hook`` unindexes them, in one batched
        copy (``export_blocks``). Best-effort: an unindexed block, the
        tier's bound or an injected ``tier.demote_fail`` each leave the
        plain eviction that would have happened without a tier."""
        if self.kv_tier is None or self.pool.pages_deleted():
            return
        pairs = [(b, self.prefix_cache.key_of(b)) for b in blocks]
        pairs = [(b, k) for b, k in pairs if k is not None]
        if not pairs:
            return
        host = self.pool.export_blocks([b for b, _ in pairs])
        for (b, key), leaves in zip(pairs, host):
            if self.kv_tier.demote(key, leaves) and self.tracer.enabled:
                self.tracer.instant("tier.demote", block=b,
                                    tier_blocks=len(self.kv_tier),
                                    tier_bytes=self.kv_tier.bytes_used)

    def _tier_readmit(self, seq) -> None:
        """Walk this prompt's chain keys and write back every demoted
        block the device index lacks: allocate a block, digest-verify the
        tier entry (a corrupt one frees the block again and ends the walk:
        an uncached miss), write its pages in place, index it
        (``prefix_cache.adopt``) and release it into the evictable LRU,
        from where ``probe`` and ``fork`` revive it as if it had never
        left. Pool pressure (or an injected alloc fault) ends the walk
        early: the tier only ever adds hits."""
        readmitted = 0
        for key in self.prefix_cache.chain_keys(seq):
            if self.prefix_cache.contains_key(key):
                continue            # on the card; deeper keys may be tiered
            if key not in self.kv_tier:
                break               # the chain broke: nothing deeper matches
            try:
                blk = self.pool.alloc(1)
            except (PoolExhausted, FaultInjected):
                break
            if key not in self.kv_tier:
                # the alloc's own reclaim demoted blocks and displaced this
                # entry: an ordinary miss, not corruption
                self.pool.free(blk)
                break
            leaves = self.kv_tier.verify_readmit(key)
            if leaves is None:
                self.metrics.observe_tier_corrupt()
                self.pool.free(blk)
                break
            payload_k, payload_v = self.pool.host_payload(leaves, blk[0])
            self.pool.adopt_blocks([(blk[0], payload_k, payload_v)])
            self.prefix_cache.adopt(key, blk[0])
            self.pool.free(blk)     # indexed: parks evictable, probe sees it
            readmitted += 1
        if readmitted:
            self.metrics.observe_tier_hit(readmitted)
            if self.tracer.enabled:
                self.tracer.instant("tier.readmit", blocks=readmitted,
                                    tier_blocks=len(self.kv_tier),
                                    tier_bytes=self.kv_tier.bytes_used)

    # -- cross-replica KV handoff (disaggregated serving) ---------------------

    def export_prefix(self, tokens: Sequence[int],
                      max_blocks: Optional[int] = None) -> List[tuple]:
        """Serialize the longest exportable chain prefix of ``tokens``: a
        list of ``(chain_key, leaves, digest)`` wire blocks in chain order
        (``leaves`` as ``pool.export_blocks`` gives them, ``digest =
        tier_digest(key, leaves)``), with a 4th element under sp > 1: the
        shard that held the block. Each key comes from the device index or
        from the host tier (``peek``: verified, not consumed); the walk
        stops at the first key neither holds. Read-only: no refcount
        moves; an empty result means the receiver recomputes.

        The deferred publishes run first (a boundary export right after
        the first-token commit must find the chain this request just
        prefilled), and the page copy is queued on the current stream
        after every step this thread launched, a step in flight included,
        so it reads what they wrote."""
        if self.prefix_cache is None or self.pool.pages_deleted():
            return []
        self.run_deferred()
        keys = self.prefix_cache.chain_keys(tokens)
        if max_blocks is not None:
            keys = keys[:max_blocks]
        sources: List[tuple] = []      # (key, device block | None, leaves)
        for key in keys:
            blk = self.prefix_cache.block_of(key)
            if blk is not None:
                sources.append((key, blk, None))
                continue
            leaves = (self.kv_tier.peek(key)
                      if self.kv_tier is not None else None)
            if leaves is None:
                break
            sources.append((key, None, leaves))
        # outside any step: another engine's guarded step must not trip
        # this deliberate copy
        with self._sync_exempt():
            fetched = iter(self.pool.export_blocks(
                [b for _, b, _ in sources if b is not None]))
        exports = []
        for i, (key, blk, leaves) in enumerate(sources):
            if blk is not None:
                leaves = next(fetched)
            if self.pool.sp > 1:
                exports.append((key, leaves, tier_digest(key, leaves),
                                self.pool.owner(blk) if blk is not None
                                else i % self.pool.sp))
            else:
                exports.append((key, leaves, tier_digest(key, leaves)))
        if exports:
            self.metrics.observe_handoff_export(len(exports))
            if self.tracer.enabled:
                self.tracer.instant("handoff.export", blocks=len(exports),
                                    wire_bytes=sum(
                                        sum(x.nbytes for x in ex[1])
                                        for ex in exports))
        return exports

    def _wire_leaves_ok(self, leaves) -> bool:
        """Geometry guard for wire payloads: a digest proves only that the
        bytes are what the SENDER exported, and a sender with another pool
        geometry or page width would still verify. Shapes as in the JAX
        engine; float leaves must also carry this pool's page dtype (bf16
        as ``BF16_WIRE``). A mismatch degrades to recompute-resume."""
        shape = (self.pool.num_layers, self.pool.num_kv_heads,
                 self.pool.block_size, self.pool.head_dim)
        if self.pool.kv_dtype == "int8":
            return (len(leaves) == 4
                    and leaves[0].shape == shape
                    and leaves[2].shape == shape
                    and leaves[0].dtype == np.int8
                    and leaves[2].dtype == np.int8
                    and leaves[1].shape == shape[:-1] + (1,)
                    and leaves[3].shape == shape[:-1] + (1,)
                    and leaves[1].dtype == np.float32
                    and leaves[3].dtype == np.float32)
        want = self.pool.wire_dtype_name()
        return (len(leaves) == 2
                and leaves[0].shape == shape and leaves[1].shape == shape
                and leaf_dtype_name(leaves[0]) == want
                and leaf_dtype_name(leaves[1]) == want)

    def adopt_prefix(self, exports: Sequence[tuple]) -> int:
        """Adopt wire blocks into this replica's prefix index; returns how
        many of the chain are RESIDENT afterwards (fresh adopts plus keys
        already held: the caller asks "will the resume hit here?"; the
        ``handoff_adopted_blocks`` metric counts real writes only). Per
        block, in chain order: skip a key already held; recompute
        ``tier_digest`` over the wire bytes against the shipped digest (a
        mismatch, real or the seeded ``handoff.corrupt``, drops the block
        and stops the walk: a chain cannot adopt past a hole); check the
        geometry; allocate a block (on the sender's shard mod sp); write
        it in place; index it and park it evictable, from where probe and
        fork serve it like local KV. Every degradation returns a smaller
        count, and the router recomputes: never a wrong token."""
        if self.prefix_cache is None or self.pool.pages_deleted():
            return 0
        adopted = resident = 0
        for i, ex in enumerate(exports):
            key, leaves, digest = ex[0], ex[1], ex[2]
            shard = (ex[3] if len(ex) > 3 else i) % self.pool.sp
            if self.prefix_cache.contains_key(key):
                resident += 1       # dedupe: served here, keep walking
                continue
            if self.faults is not None:
                if self.faults.handoff_slow():
                    time.sleep(self.faults.handoff_slow_s)
                if self.faults.handoff_corrupt():
                    # flip one byte of a COPY: the digest check below must
                    # catch planted damage as it would real wire rot
                    leaves = tuple(np.array(x, copy=True) for x in leaves)
                    flat = leaves[0].reshape(-1).view(np.uint8)
                    flat[0] ^= 0xFF
            leaves = tuple(np.asarray(x) for x in leaves)
            if tier_digest(key, leaves) != digest:
                self.metrics.observe_handoff_corrupt()
                break
            if not self._wire_leaves_ok(leaves):
                break               # geometry mismatch: recompute instead
            try:
                blk = self.pool.alloc(1, start=shard)
            except (PoolExhausted, FaultInjected):
                break
            with self._sync_exempt():     # outside any step, as above
                payload_k, payload_v = self.pool.host_payload(leaves,
                                                              blk[0])
                self.pool.adopt_blocks([(blk[0], payload_k, payload_v)])
            if not self.prefix_cache.adopt(key, blk[0]):
                # raced a local publish of the same chain: served either way
                self.pool.free(blk)
                resident += 1
                continue
            self.pool.free(blk)     # indexed: parks evictable
            adopted += 1
            resident += 1
        if adopted:
            self.metrics.observe_handoff_adopt(adopted)
            if self.tracer.enabled:
                self.tracer.instant("handoff.adopt", blocks=adopted)
        return resident

    def prefix_keys(self) -> List[bytes]:
        """Chain keys this replica can export now: the device index plus
        the host tier's entries (the router's fleet directory refreshes
        from this; keys are content addresses, alike on every replica)."""
        if self.prefix_cache is None:
            return []
        keys = self.prefix_cache.keys()
        if self.kv_tier is not None:
            have = set(keys)
            keys.extend(k for k in self.kv_tier.keys() if k not in have)
        return keys

    def _terminate(self, req: Request, state: RequestState, error: str,
                   events=None, bucket: Optional[str] = None) -> None:
        """A non-FINISHED exit: free the request's blocks, move it to
        ``state`` (FAILED, CANCELLED or TIMED_OUT), count it and, mid-step,
        report it in the step's ``bucket``. Its queued publishes are
        dropped by their own check when they run."""
        now = time.perf_counter()
        if req.state is RequestState.QUEUED:
            req.queued_s += max(0.0, now - req.queued_time)
        else:
            self._note_leave_running(req, now)
        if req.block_table:
            self.pool.free(req.block_table)
            req.block_table = []
        self.scheduler.terminate(req, state, error)
        if self.tracer.enabled:
            self.tracer.instant("serve.terminal", trace=req.trace_id,
                                rid=req.rid, state=state.value,
                                step=self.step_seq)
        if state is RequestState.FAILED:
            self.metrics.observe_failed()
        elif state is RequestState.CANCELLED:
            self.metrics.observe_cancelled()
        else:
            self.metrics.observe_timeout()
        if events is not None and bucket is not None:
            events[bucket].append((req.rid, error))

    def _preempt(self, req: Request) -> None:
        self._note_leave_running(req, time.perf_counter())
        self.pool.free(req.block_table)
        req.block_table = []
        req.cache_len = 0
        self.scheduler.requeue(req)
        self.metrics.observe_preemption(req.rid)
        if self.tracer.enabled:
            self.tracer.instant("serve.preempt", trace=req.trace_id,
                                rid=req.rid, step=self.step_seq)

    def _ensure_decode_capacity(self, events) -> None:
        """Whole-prompt mode: every running row gets the block its next
        token writes into, preempting (LIFO) when the pool runs dry."""
        for req in list(self.scheduler.running):
            if req.state is RequestState.RUNNING:
                self._grow_blocks(req, 1, events, chunk=False)

    def _grow_blocks(self, req: Request, new_tokens: int, events, *,
                     chunk: bool) -> bool:
        """Grow ``req.block_table`` to cover ``cache_len + new_tokens``
        positions, preempting (LIFO) when the pool runs dry. Returns True
        when the row still runs this step. An allocation that fails all the
        same (an injected fault) FAILs only this request; ``chunk`` marks a
        prompt-chunk boundary, the fault plan's prefill site."""
        needed = self.pool.blocks_for(req.cache_len + new_tokens)
        grow = max(0, needed - len(req.block_table))
        # under SP table position j's block comes from shard j % sp
        while grow and not self.pool.can_alloc(
                grow, start=len(req.block_table)):
            victim = self.scheduler.preempt_victim()
            if victim is None or (victim is req
                                  and len(self.scheduler.running) == 1):
                raise RuntimeError("KV pool deadlock: no preemption victim "
                                   "can free enough blocks")
            if self.preemption_budget is not None and \
                    victim.preemptions >= self.preemption_budget:
                self._terminate(victim, RequestState.FAILED,
                                f"preemption budget exhausted "
                                f"({victim.preemptions} >= "
                                f"{self.preemption_budget})",
                                events, "failed")
            else:
                self._preempt(victim)
            if victim is req:
                return False
        if req.state is not RequestState.RUNNING:
            return False
        try:
            if chunk and self.faults is not None:
                self.faults.on_prefill()
            if grow:
                req.block_table.extend(
                    self.pool.alloc(grow, start=len(req.block_table)))
        except (PoolExhausted, FaultInjected) as e:
            where = "at chunk boundary" if chunk else "mid-decode"
            self._terminate(req, RequestState.FAILED,
                            f"pool allocation failed {where}: {e}",
                            events, "failed")
            return False
        return True

    def _propose_drafts(self) -> Dict[int, Any]:
        """Up to ``spec_k`` drafted tokens per decode-phase row, clamped so
        the accepted drafts plus the verifier's token never pass
        ``max_new_tokens`` or the position cap; empty proposals are
        dropped (those rows run as plain decode rows). A drafter returns
        host tokens or a ``DeviceDraft``, already clamped into the
        vocabulary on the device. The fault plan's ``draft.poison`` site
        shifts a proposal by one token id."""
        drafts: Dict[int, Any] = {}
        vocab = self.model.vocab_size
        for req in self.scheduler.running:
            if req.state is not RequestState.RUNNING or \
                    req.cache_len < req.prefill_len:
                continue
            rem = req.max_new_tokens - req.num_generated
            k = min(self.spec_k, rem - 1,
                    self.max_seq_len - req.cache_len - 1)
            if k < 1:
                continue
            d = self.drafter.draft(req, k)
            if not isinstance(d, spec_decode.DeviceDraft):
                d = [int(t) % vocab for t in d][:k]
            if not len(d):
                continue
            if self.faults is not None and self.faults.poison_draft():
                # a corrupted draft: verification must reject it, at the
                # cost of acceptance only
                if isinstance(d, spec_decode.DeviceDraft):
                    d = spec_decode.DeviceDraft((d.toks + 1) % vocab)
                else:
                    d = [(t + 1) % vocab for t in d]
            drafts[req.rid] = d
        return drafts

    def _build(self, chunks: Dict[int, int], events) -> Optional[Dict]:
        """Drafts, capacity pass, packing and launch. Returns the launched
        step's record (device results unfetched) or None when nothing
        ran."""
        t0 = time.perf_counter()
        spec_on = self.drafter is not None
        # drafts come first, so decode rows reserve blocks for every
        # drafted position in the capacity pass
        drafts = self._propose_drafts() if spec_on else {}
        for req in list(self.scheduler.running):
            if req.state is not RequestState.RUNNING:
                continue        # preempted or failed as an earlier victim
            if req.cache_len < req.prefill_len:
                take = chunks.get(req.rid)
                if take and not self._grow_blocks(req, take, events,
                                                  chunk=True):
                    chunks.pop(req.rid, None)
                continue
            d = drafts.get(req.rid)
            if d:
                # speculation degrades first: a draft whose blocks are not
                # free is shed before its row would preempt a peer for it
                grow = self.pool.blocks_for(req.cache_len + 1 + len(d)) \
                    - len(req.block_table)
                if grow > 0 and not self.pool.can_alloc(
                        grow, start=len(req.block_table)):
                    drafts.pop(req.rid)
                    d = None
            if not self._grow_blocks(req, 1 + (len(d) if d else 0), events,
                                     chunk=False):
                drafts.pop(req.rid, None)
        live = self.scheduler.running
        dec = [r for r in live if r.cache_len >= r.prefill_len]
        chk = [r for r in live
               if r.cache_len < r.prefill_len and r.rid in chunks]
        n_spec = sum(len(drafts.get(r.rid, ())) for r in dec)
        if not chk and not n_spec:
            if not dec:
                return None
            rec = self._decode_launch(dec, events=events)
            if rec is None:
                return None
            if spec_on:
                # draft-free rows still count in the acceptance statistics
                rec["spec_rows"] = len(dec)
            return rec
        rows = dec + chk
        takes = {r.rid: chunks[r.rid] for r in chk}
        b = self.scheduler.max_batch_size
        step = step_build.pack_mixed(
            rows, len(dec), drafts, takes, b=b,
            nb=self.blocks_per_seq, scratch=PagedKVPool.SCRATCH)
        if self.faults is not None:
            if dec:
                step.poison[:len(dec)][
                    self.faults.poison_rows(len(dec))] = np.nan
            for i in range(len(dec), len(rows)):
                if self.faults.poison_prefill():
                    step.poison[i] = np.nan
        kind = "spec" if spec_on else "mixed"
        self._note_program(kind, (kind, b, step.toks.shape[1],
                                  self.blocks_per_seq),
                           [r.rid for r in rows], fill=len(rows) / b)
        toks, starts, q_lens, n_draft, temps, topks, topps, poison, \
            tables = self._put_step([step.toks, step.starts, step.q_lens,
                                     step.n_draft, step.temps, step.topks,
                                     step.topps, step.poison], step.tables)
        for i, d in step.dev_drafts:   # device drafts, spliced on the device
            toks[i, 1:1 + len(d)] = d.toks.to(toks.device)
        rec = {"kind": kind, "rows": rows,
               "n_dec": len(dec), "takes": takes, "n_draft": step.n_draft,
               "n_spec": n_spec, "t0": t0, "b": b,
               "qw": step.toks.shape[1]}
        self._mark_dispatch()
        if not self._decode_site(rows, events):
            return None
        with profiled("serve.mixed", EventType.COMPUTE, self.profiler), \
                self._dispatch_span():
            if spec_on:
                # verification reads every position: the (B, Q, V) cube
                if self._paged:
                    self.program_steps["spec"] += 1
                    logits = self._step_model.apply_paged(
                        toks, self.pool.pages_k, self.pool.pages_v, tables,
                        starts, q_lens)
                else:
                    self.program_steps["spec_standard"] += 1
                    logits = self._mixed_standard(toks, tables, starts,
                                                  q_lens, last_only=False)
                accepts, newtok, ok = self._spec_verify(
                    logits, toks, q_lens, n_draft, step, poison)
                # one bundle: the token matrix brings device drafts' values
                rec["dev"] = torch.cat([torch.stack([accepts, newtok,
                                                     ok.long()]),
                                        toks.long().T])
                return rec
            if self._paged:
                self.program_steps["mixed"] += 1
                logits = self._step_model.apply_paged(
                    toks, self.pool.pages_k, self.pool.pages_v, tables,
                    starts, q_lens, last_only=True)
            else:
                self.program_steps["mixed_standard"] += 1
                logits = self._mixed_standard(toks, tables, starts, q_lens)
            rec["dev"] = self._sample(
                logits, SampleInputs(toks, temps, topks, topps, poison))
        return rec

    def _decode_site(self, rows: Sequence[Request], events,
                     pending: Sequence[Request] = ()) -> bool:
        """The fault plan's decode site, on the host before a step's
        launch: a transient ``FaultInjected`` is retried once (nothing was
        launched, so the retry runs the same inputs with the same sampling
        state), a persistent one aborts the batch (``_abort_batch``; the
        whole-prompt prefills ``pending`` this step launched fail with it).
        Returns True when the launch goes ahead."""
        if self.faults is None:
            return True
        for attempt in (0, 1):
            try:
                self.faults.on_decode()
                return True
            except FaultInjected as e:
                if attempt == 0 and e.transient:
                    self.metrics.observe_step_retry()
                    continue
                self._abort_batch(rows, f"decode step failed: {e}", events,
                                  pending)
        return False

    def _abort_batch(self, rows: Sequence[Request], error: str, events,
                     pending: Sequence[Request] = ()) -> None:
        """A step failure no row can be blamed for (JAX's ``_abort_batch``
        and ``_recover_pages_if_dead``): every running row of the batch
        FAILs, then the pages are zeroed and every request still holding
        KV FAILs too (``abort_all``). Queued requests keep the engine
        serving; they re-prefill from scratch. The whole-prompt prefills
        the step launched (``pending``, not admitted yet) wrote into the
        zeroed pages, so they FAIL as well."""
        for req in rows:
            if req.state is RequestState.RUNNING:
                self._terminate(req, RequestState.FAILED, error, events,
                                "failed")
        for req in pending:
            if req.state is RequestState.QUEUED:
                self._terminate(req, RequestState.FAILED, error, events,
                                "failed")
        ev = self.abort_all("KV pages lost to a failed step")
        for bucket in ("failed", "timed_out"):
            events[bucket].extend(ev[bucket])

    # -- whole-prompt prefill (JAX's _prefill_fn, _prefill_build,
    # _prefill_commit) --------------------------------------------------------

    def _prefill_build(self, req: Request, flight: StepInFlight) -> None:
        """Allocate the resume sequence's blocks and launch its prefill
        program; the record joins ``flight``. A row that cannot start
        FAILs."""
        events = flight.events
        t0 = time.perf_counter()
        seq = req.resume_tokens
        nb = self.pool.blocks_for(len(seq))
        if nb > self.blocks_per_seq:
            self._terminate(req, RequestState.FAILED,
                            f"oversized resume: {len(seq)} tokens need {nb} "
                            f"blocks > {self.blocks_per_seq}", events,
                            "failed")
            return
        try:
            if self.faults is not None:
                self.faults.on_prefill()
            req.block_table = self.pool.alloc(nb)
        except (PoolExhausted, FaultInjected) as e:
            self._terminate(req, RequestState.FAILED,
                            f"prefill failed: {e}", events, "failed")
            return
        # the program's width is a power of two of blocks, so N prompt
        # lengths take O(log N) shapes; only nb blocks are real, the
        # bucket's tail rows land in the scratch block
        nb_bucket = pow2_bucket(nb, cap=self.blocks_per_seq)
        ids = np.zeros((1, nb_bucket * self.pool.block_size), np.int32)
        ids[0, :len(seq)] = seq
        table = np.asarray([self.pool.padded_table(req.block_table,
                                                   nb_bucket)], np.int32)
        poison = np.float32("nan") if (
            self.faults is not None and self.faults.poison_prefill()) \
            else np.float32(0.0)
        width = nb_bucket * self.pool.block_size
        self._note_program("prefill", ("prefill", width), [req.rid],
                           fill=len(seq) / width)
        ids, temps, topks, topps, poison, tables = self._put_step(
            [ids, np.asarray([req.temperature], np.float32),
             np.asarray([req.top_k], np.int32),
             np.asarray([req.top_p], np.float32),
             np.asarray([poison], np.float32)], table)
        self._mark_dispatch()
        self.program_steps["prefill"] += 1
        with profiled("serve.prefill", EventType.COMPUTE, self.profiler), \
                self._dispatch_span():
            dev = self._prefill(ids, len(seq), tables,
                                SampleInputs(ids, temps, topks, topps,
                                             poison))
        flight.recs.append({"kind": "prefill", "req": req, "t0": t0,
                            "seq_len": len(seq), "dev": dev})

    def _prefill(self, ids, length: int, tables, step: SampleInputs):
        """The whole-prompt program: ``apply_cached`` over the padded
        prompt on fresh caches, the logit guard and a sample at row
        ``length - 1``, every layer's cache scattered into the blocks.
        Returns the (2, 1) bundle."""
        model = self._tp.model if self._tp is not None else self.model
        caches = model.init_cache(1, ids.shape[1])
        logits = model.apply_cached(ids, caches, 0)
        bundle = self._sample(logits[0, length - 1][None], step)
        if self._tp is not None:     # caches[layer][shard]: each its pages
            for s, (pk, pv) in enumerate(self.pool.shard_pages()):
                dev = self._tp.devices[s]
                for pages, key in ((pk, "k"), (pv, "v")):
                    kv_pool.scatter_prefill(
                        pages, tables[0].to(dev),
                        torch.stack([c[s][key][0] for c in caches]))
            return bundle
        blocks = tables[0] if self._sp is None else [t[0] for t in tables]
        for pages, key in ((self.pool.pages_k, "k"),
                           (self.pool.pages_v, "v")):
            kv_pool.scatter_prefill(
                pages, blocks, torch.stack([c[key][0] for c in caches]))
        return bundle

    def _prefill_commit(self, rec, out, events) -> None:
        """Admit the prefilled row and emit its first token (a preempted
        request keeps its pending token: the prefill's sample is not
        used)."""
        req = rec["req"]
        if req.state in TERMINAL_STATES:
            return                      # cancelled while in flight
        tok, ok = int(out[0, 0]), bool(out[1, 0])
        if self.logit_guard and not ok:
            self._terminate(req, RequestState.FAILED,
                            "non-finite logits in prefill", events, "failed")
            return
        req.cache_len = rec["seq_len"]
        # the queued clock closes at the launch, so the whole-prompt
        # forward counts as prefill time
        self._note_admit(req, rec["t0"])
        self.scheduler.admit(req)
        now = time.perf_counter()
        self._note_prefill_done(req, now)
        self.metrics.observe_prefill(rec["seq_len"], now - rec["t0"])
        if not req.out_tokens:
            req.ttft_s = now - req.submit_time
            self.metrics.observe_ttft(req.ttft_s)
            if self.tracer.enabled:
                self.tracer.instant("serve.first_token", trace=req.trace_id,
                                    rid=req.rid, step=self.step_seq)
            self._emit(req, tok, events)

    _DECODE_SPANS = {"pdecode": "serve.decode_paged",
                     "fdecode": "serve.decode_fused",
                     "decode": "serve.decode"}

    def _decode_launch(self, live: Sequence[Request],
                       step: Optional[step_build.DecodeStep] = None,
                       toks: Optional[torch.Tensor] = None, events=None,
                       pending: Sequence[Request] = ()) -> Optional[Dict]:
        """Pack (unless ``step`` is given) and launch a pure-decode step.
        ``toks``, a device tensor, replaces the packed token column: a
        speculative step's tokens are step N's unfetched samples (its
        program note is made at adoption, and no fault site runs: the
        engine does not speculate under a fault plan). A pdecode step
        replays its captured graph where graphs run. Returns None when the
        fault plan's decode site aborted the batch (into ``events``, with
        the step's ``pending`` whole-prompt prefills)."""
        t0 = time.perf_counter()
        if step is None:
            step = step_build.pack_decode(
                live, b=self.scheduler.max_batch_size,
                nb=self.blocks_per_seq, scratch=PagedKVPool.SCRATCH,
                paged=self._paged, fused_available=self._fused is not None)
        label = self._DECODE_SPANS[step.program]
        speculative = toks is not None
        if not speculative:
            if self.faults is not None:
                step.poison[:len(live)][
                    self.faults.poison_rows(len(live))] = np.nan
            b = step.toks.shape[0]
            self._note_program(label.split(".", 1)[1],
                               (step.program, b, self.blocks_per_seq),
                               [r.rid for r in live], fill=len(live) / b)
        rec = {"kind": "decode", "live": list(live), "t0": t0,
               "b": step.toks.shape[0]}
        if speculative:
            # padding rows take token 0, as in a packed step: a MoE
            # block's routing reads every row (the JAX engine passes them
            # step N's samples, so its MoE models lose overlap-exactness)
            toks = torch.where(
                torch.arange(toks.shape[0], device=toks.device) < len(live),
                toks, 0)
        graph = step.program == "pdecode" and self._graph_steps
        if graph:
            host = step_graph.stage(step_graph.decode_arrays(step))
        else:
            put_toks, offsets, temps, topks, topps, poison, tables = \
                self._put_step([step.toks, step.offsets, step.temps,
                                step.topks, step.topps, step.poison],
                               step.tables)
            toks = toks.to(torch.int32) if speculative else put_toks
        self._mark_dispatch()
        if not speculative and not self._decode_site(live, events,
                                                     pending):
            return None
        self.program_steps[step.program] += 1
        with profiled(label, EventType.COMPUTE, self.profiler), \
                self._dispatch_span():
            if graph:
                rec["dev"] = self._decode_graph().run(host, toks)
            elif step.program == "pdecode":
                rec["dev"] = self._pdecode(toks, offsets, tables, temps,
                                           topks, topps, poison)[1]
            else:
                logits = self._fused_decode(
                    toks, tables, int(step.offsets[0])) \
                    if step.program == "fdecode" \
                    else self._decode_standard(toks, tables, offsets)
                rec["dev"] = self._sample(
                    logits, SampleInputs(toks, temps, topks, topps, poison))
        return rec

    def _dispatch_span(self):
        """The ``serve.allreduce`` span of one TP dispatch (tp= and
        count=, the all-reduces it runs), traced engines only."""
        if self._tp is None or not self.tracer.enabled:
            return contextlib.nullcontext()
        return self._tp.span()

    def _pdecode(self, toks, offsets, tables, temps, topks, topps, poison):
        """The paged pure-decode program, the one that is captured:
        (logits, (2, B) bundle)."""
        logits = self._step_model.apply_decode_paged(
            toks, self.pool.pages_k, self.pool.pages_v, tables, offsets)
        return logits, self._sample(
            logits, SampleInputs(toks, temps, topks, topps, poison))

    @property
    def _graph_steps(self) -> bool:
        """pdecode steps replay captured graphs: on CUDA at sp = 1, with
        every TP shard on the engine's device."""
        return (self.device.type == "cuda" and self._sp is None
                and (self._tp is None
                     or all(d == self.device for d in self._tp.devices))
                and not self._eager_steps)

    def _decode_graph(self) -> step_graph.DecodeGraph:
        key = (self.scheduler.max_batch_size, self.blocks_per_seq)
        graph = self._graphs.get(key)
        if graph is None:
            # the capture waits for its side stream on purpose
            with self._sync_exempt():
                graph = self._graphs[key] = step_graph.DecodeGraph(
                    self._pdecode, self.generator, batch=key[0],
                    blocks_per_seq=key[1], scratch=PagedKVPool.SCRATCH,
                    device=self.device)
        return graph

    # -- the assembled-cache programs (JAX's _mixed_standard_fn, _decode_fn,
    # _fused_decode_fn) ---------------------------------------------------

    def _gather(self, tables):
        return kv_pool.gather_kv(self.pool.pages_k, self.pool.pages_v,
                                 tables,
                                 out_dtype=self.model.policy.compute_dtype)

    def _mixed_standard(self, toks, tables, starts, q_lens, *,
                        last_only: bool = True):
        """The ragged mixed step on assembled caches: each row's chunk runs
        ``apply_cached`` at its own start; the head runs on each row's
        last live position (on every position without ``last_only``: the
        spec step's verification); the chunk's new rows go back to the
        pages."""
        if self._tp is not None:
            return self._tp.model.mixed_standard(
                toks, self.pool.pages_k, self.pool.pages_v, tables, starts,
                q_lens, last_only=last_only)
        model = self.model
        b, qw = toks.shape
        kf, vf = self._gather(tables)
        # pad the time axis by qw: a chunk ending at the assembly edge
        # writes past it (the padded tail is never scattered back: its
        # tokens are dead and scatter_chunk drops them)
        kf = torch.nn.functional.pad(kf, (0, 0, 0, qw))
        vf = torch.nn.functional.pad(vf, (0, 0, 0, qw))
        x = model.wpe(model.wte(toks), offset=starts)
        rows = torch.arange(b, device=toks.device)[:, None]
        pos = starts.long()[:, None] + torch.arange(qw, device=toks.device)
        rows_k, rows_v = [], []
        for i, blk in enumerate(model.blocks):
            x, cache = blk.apply_cached(x, {"k": kf[i], "v": vf[i]}, starts)
            rows_k.append(cache["k"][rows, :, pos])      # (B, Q, H, Dh)
            rows_v.append(cache["v"][rows, :, pos])
        if last_only:
            last = x[rows[:, 0], (q_lens.long() - 1).clamp_min(0)]
            logits = model._head(last[:, None])[:, 0]
        else:
            logits = model._head(x)
        kv_pool.scatter_chunk(self.pool.pages_k, tables, starts,
                              torch.stack(rows_k), q_lens)
        kv_pool.scatter_chunk(self.pool.pages_v, tables, starts,
                              torch.stack(rows_v), q_lens)
        return logits

    def _decode_standard(self, toks, tables, offsets):
        """The ragged pure-decode step on assembled caches."""
        if self._tp is not None:
            return self._tp.model.decode_standard(
                toks, self.pool.pages_k, self.pool.pages_v, tables, offsets)
        model = self.model
        kf, vf = self._gather(tables)
        x = model.wpe(model.wte(toks[:, None]), offset=offsets)
        rows = torch.arange(toks.shape[0], device=toks.device)
        pos = offsets.long()
        rows_k, rows_v = [], []
        for i, blk in enumerate(model.blocks):
            x, cache = blk.apply_cached(x, {"k": kf[i], "v": vf[i]},
                                        offsets)
            rows_k.append(cache["k"][rows, :, pos])      # (B, H, Dh)
            rows_v.append(cache["v"][rows, :, pos])
        logits = model._head(x)[:, -1]
        kv_pool.scatter_token(self.pool.pages_k, tables, offsets,
                              torch.stack(rows_k))
        kv_pool.scatter_token(self.pool.pages_v, tables, offsets,
                              torch.stack(rows_v))
        return logits

    def _fused_decode(self, toks, tables, offset: int):
        """The lockstep pure-decode step: every row at ``offset``; all
        blocks in one fused decode-stack launch over the assembled caches,
        then ln_f and the head; the new row of every layer goes back to the
        pages."""
        model = self.model
        kf, vf = self._gather(tables)

        def flat(c):   # (L, B, H, T, Dh) -> the kernel's (L, B, T, D)
            n_layers, b, h, t, dh = c.shape
            return c.transpose(2, 3).reshape(n_layers, b, t, h * dh)

        kc, vc = flat(kf), flat(vf)
        del kf, vf
        x = model.wpe(model.wte(toks[:, None]), offset=offset)[:, 0]
        x_out, kc, vc = fused_decode_stack(
            x, offset, kc, vc, self._fused["stacks"],
            num_heads=model.num_heads, chunks=self._fused["chunks"])
        logits = model._head(x_out[:, None, :])[:, -1]
        n_layers, b, _, d = kc.shape
        h = model.num_kv_heads
        offsets = torch.full((b,), offset, dtype=torch.int32,
                             device=toks.device)
        for pages, c in ((self.pool.pages_k, kc), (self.pool.pages_v, vc)):
            kv_pool.scatter_token(pages, tables, offsets,
                                  c[:, :, offset].reshape(n_layers, b, h,
                                                          d // h))
        return logits

    def _put_step(self, arrays: Sequence[np.ndarray],
                  tables: Optional[np.ndarray] = None) -> List[Any]:
        """A step's host arrays on the engine's device (on CUDA one
        non-blocking copy from pinned memory), then, with ``tables``, the
        step's tables as the programs take them (``_put_tables``)."""
        arrays = list(arrays)
        if tables is not None and self._sp is None:
            arrays.append(tables)
        with self._sync_exempt():
            if self.device.type == "cuda":
                flat = step_graph.stage(arrays).to(self.device,
                                                   non_blocking=True)
                out = step_build.split_inputs(flat, arrays)
            else:
                out = [torch.from_numpy(a).to(self.device) for a in arrays]
        if tables is not None and self._sp is not None:
            out.append(self._put_tables(tables))
        return out

    def _put_tables(self, tables: np.ndarray):
        """A step's GLOBAL block tables under SP: each shard's local tables
        on its device."""
        local = step_build.shard_tables(tables, self.sp,
                                        self.pool.blocks_per_shard)
        with self._sync_exempt():
            return [torch.from_numpy(t).pin_memory().to(d, non_blocking=True)
                    if torch.device(d).type == "cuda"
                    else torch.from_numpy(t).to(d)
                    for t, d in zip(local, self._sp.devices)]

    def _sample(self, logits: torch.Tensor,
                step: SampleInputs) -> torch.Tensor:
        """(2, B) int64 device tensor: sampled tokens and the logit guard,
        over the logits plus the step's poison column (zero but where a
        fault plan poisons a row: adding 0.0 changes no logit)."""
        logits = logits + step.poison[:, None]
        ok = torch.isfinite(logits).all(dim=-1)
        newtok = sampling.sample_ragged(logits, self.generator, step.temps,
                                        step.topks, step.topps)
        return torch.stack([newtok, ok.long()])

    def _spec_verify(self, logits, toks, q_lens, n_draft, step,
                     poison=None):
        """Verify a ragged speculative step from its full (B, Q, V) logits.

        Row i is ``[x_0, d_1..d_k, pad]`` with ``q_lens = 1 + n_draft``:
        position j's logits judge token j + 1. Greedy rows (t <= 0) accept
        the longest draft prefix that matches the argmax, the tokens
        token-by-token decode would emit. Stochastic rows run rejection
        sampling: the drafters are deterministic, so accepting d with
        probability p_target(d) and redrawing a rejection from the target
        with d masked out leaves the target's distribution. Chunk rows
        (n_draft 0) reduce to the plain last-position sample. Returns
        Returns (accepts, next token, all live logits finite), int64 and
        bool. ``poison`` (B,), when given, is added to every position of
        its row first."""
        logits = logits.float()
        if poison is not None:
            logits = logits + poison[:, None, None]
        b, q, v = logits.shape
        dev = logits.device
        q_lens, n_draft = q_lens.long(), n_draft.long()
        pos = torch.arange(q, device=dev)[None]
        live = pos < q_lens[:, None]
        ok = torch.where(live[:, :, None], torch.isfinite(logits),
                         True).flatten(1).all(1)
        # drafted[:, j]: the token position j's logits must predict
        drafted = torch.cat([toks[:, 1:], torch.zeros_like(toks[:, :1])],
                            1).long()
        greedy = logits.argmax(-1)
        match = greedy == drafted
        # the host's sampling parameters say whether any row samples; an
        # all-greedy step filters and draws nothing
        sampled = bool((step.temps > 0.0).any())
        if sampled:
            t, k, p = self._put_step([step.temps, step.topks, step.topps])
            filtered = sampling.filter_logits(logits, t[:, None],
                                              k[:, None], p[:, None])
            p_draft = torch.softmax(filtered, -1).gather(
                -1, drafted[..., None])[..., 0]
            u = torch.rand(p_draft.shape, generator=self.generator,
                           device=dev)
            match = torch.where(t[:, None] > 0.0, u < p_draft, match)
        match &= pos < n_draft[:, None]
        accepts = match.long().cumprod(1).sum(1)
        # the verifier's token: at the first unaccepted position, which is
        # position a on a decode row and the last live one on a chunk row
        s = (accepts + q_lens - 1 - n_draft).clamp(0, q - 1)
        newtok = greedy.gather(1, s[:, None])[:, 0]
        if sampled:
            fsel = filtered.gather(1, s[:, None, None].expand(b, 1, v))[:, 0]
            # the rejection residual: the refused draft masked out of the
            # target before the redraw
            rej_tok = toks.long().gather(1,
                                         (s + 1).clamp_max(q - 1)[:, None])
            refused = (accepts < n_draft)[:, None] & (
                torch.arange(v, device=dev)[None] == rej_tok)
            fres = fsel.masked_fill(refused, sampling.NEG_INF)
            noise = torch.empty_like(fres).exponential_(
                generator=self.generator)
            newtok = torch.where(t > 0.0, (fres - noise.log()).argmax(-1),
                                 newtok)
        return accepts, newtok, ok

    # -- commit ---------------------------------------------------------------

    def _emit(self, req: Request, tok: int, events) -> None:
        req.next_token = tok
        req.out_tokens.append(tok)
        events["tokens"].append((req.rid, tok))
        self._maybe_finish(req, tok, events)

    def _mark_decode_emit(self) -> None:
        """Stamp a step that emitted decode-phase tokens: the gap between
        consecutive stamps is the decode stall that chunking bounds."""
        now = time.perf_counter()
        if self._last_decode_emit is not None:
            self.metrics.observe_decode_stall(now - self._last_decode_emit)
        self._last_decode_emit = now

    def _decode_commit(self, rec, out, events) -> None:
        newtok, ok = out
        emitted = 0
        for i, req in enumerate(rec["live"]):
            if req.state in TERMINAL_STATES:
                continue
            if self.logit_guard and not ok[i]:
                self._terminate(req, RequestState.FAILED,
                                "non-finite logits in decode step", events,
                                "failed")
                continue
            req.cache_len += 1
            self._emit(req, int(newtok[i]), events)
            emitted += 1
        self._mark_decode_emit()
        self.metrics.observe_decode(len(rec["live"]),
                                    time.perf_counter() - rec["t0"],
                                    rec["b"])
        if rec.get("spec_rows"):
            self.metrics.observe_spec(0, 0, emitted, rows=rec["spec_rows"])

    def _mixed_commit(self, rec, out, events) -> None:
        spec_on = rec["kind"] == "spec"
        if spec_on:
            accepts, newtok, ok, toks = out[0], out[1], out[2], out[3:].T
        else:
            newtok, ok = out
        n_dec = rec["n_dec"]
        now = time.perf_counter()
        emitted = 0
        for i, req in enumerate(rec["rows"]):
            if req.state in TERMINAL_STATES:
                continue
            if self.logit_guard and not ok[i]:
                self._terminate(req, RequestState.FAILED,
                                "non-finite logits in decode step"
                                if i < n_dec else
                                "non-finite logits in prefill chunk",
                                events, "failed")
                continue
            if i < n_dec and not spec_on:
                req.cache_len += 1
                self._emit(req, int(newtok[i]), events)
                emitted += 1
                continue
            if i < n_dec:
                # the accepted drafts, then the verifier's token, stopping
                # at the first finish, where token-by-token decode stops
                a = int(accepts[i])
                committed = 0
                for tok in [int(x) for x in toks[i, 1:1 + a]] + \
                        [int(newtok[i])]:
                    req.cache_len += 1
                    committed += 1
                    self._emit(req, tok, events)
                    if req.state is not RequestState.RUNNING:
                        break
                self.metrics.observe_spec(int(rec["n_draft"][i]), a,
                                          committed)
                emitted += committed
                if req.state is RequestState.RUNNING:
                    # roll the rejected drafts' blocks back
                    req.block_table = self.pool.truncate(req.block_table,
                                                         req.cache_len)
                continue
            take = rec["takes"][req.rid]
            req.cache_len += take
            self.metrics.observe_prefill_chunk(take)
            if self.faults is not None:
                self.faults.prefill_delay(take)
            if self.tracer.enabled:
                self.tracer.instant("serve.prefill_chunk",
                                    trace=req.trace_id, rid=req.rid,
                                    step=self.step_seq, take=take)
            if self.prefix_cache is not None:
                # every block this chunk filled is immutable now; publishing
                # is suspended while live requests crowd the pool (a larger
                # evictable set would only churn reclaims)
                if self.pool.occupancy > self.prefix_publish_max_occupancy:
                    self.metrics.observe_publish_suspended()
                else:
                    self._defer_publish(req)
            if req.cache_len < req.prefill_len:
                continue                    # more chunks to go
            self._note_prefill_done(req, now)
            if req.out_tokens:
                # a preempted or migrated request keeps its pending
                # next_token (its final chunk's sample is redundant)
                continue
            req.ttft_s = now - req.submit_time
            self.metrics.observe_ttft(req.ttft_s, under_load=n_dec > 0)
            if self.tracer.enabled:
                self.tracer.instant("serve.first_token", trace=req.trace_id,
                                    rid=req.rid, step=self.step_seq)
            self._emit(req, int(newtok[i]), events)
        self.metrics.observe_mixed_step(
            n_dec + rec["n_spec"] + sum(rec["takes"].values()),
            rec["b"] * rec["qw"])
        if n_dec:
            self._mark_decode_emit()
            self.metrics.observe_decode(
                emitted if spec_on else n_dec,
                time.perf_counter() - rec["t0"], rec["b"])

    def _defer_publish(self, req: Request) -> None:
        """Queue a publish of the request's full blocks for the end of the
        step. It checks its snapshot when it runs: the request still
        RUNNING, its cache no shorter and its table's prefix unchanged;
        otherwise the blocks may be reused already, and it does nothing. A
        request that finishes in the same commit runs its own publishes
        first (``_flush_deferred_for``)."""
        cache = self.prefix_cache
        tokens = req.resume_tokens
        snap = list(req.block_table)
        clen = req.cache_len
        step = self.step_seq

        def run() -> None:
            if (req.state is not RequestState.RUNNING
                    or req.cache_len < clen
                    or req.block_table[:len(snap)] != snap):
                return
            cache.publish(tokens, snap, clen)
            if self.tracer.enabled:
                self.tracer.instant("serve.publish", trace=req.trace_id,
                                    rid=req.rid, step=step)

        run.rid = req.rid
        self._deferred.append(run)

    def _flush_deferred_for(self, req: Request) -> None:
        """Run this request's queued publishes now, before its blocks are
        freed: a request can fill its last block and finish in one
        commit."""
        keep = []
        for fn in self._deferred:
            if fn.rid == req.rid:
                fn()
            else:
                keep.append(fn)
        self._deferred = keep

    def _maybe_finish(self, req: Request, tok: int, events) -> None:
        if req.stop_token is not None and tok == req.stop_token:
            reason = "stop_token"
        elif req.num_generated >= req.max_new_tokens:
            reason = "length"
        else:
            return
        self._note_leave_running(req, time.perf_counter())
        if self._deferred:
            self._flush_deferred_for(req)
        self.pool.free(req.block_table)
        req.block_table = []
        self.scheduler.finish(req, reason)
        self.metrics.observe_finish(req.ttft_s)
        if self.tracer.enabled:
            self.tracer.instant("serve.finish", trace=req.trace_id,
                                rid=req.rid, reason=reason,
                                step=self.step_seq)
        events["finished"].append(req.rid)
