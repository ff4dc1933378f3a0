"""Continuous-batching scheduler (``tnn_tpu.serving.scheduler``): FCFS
admission, a per-step token budget, chunked prefill (or, with
``chunk_size=0``, whole-prompt admission), LIFO recompute preemption and
priority shedding under bounded admission.

Running requests decode one token every step; queued requests are admitted
whenever the batch has a free slot, the step's token budget allows a chunk
and the pool has blocks. When the pool runs dry the latest-admitted running
request frees its blocks and re-queues at the front, carrying its generated
tokens as an extended prompt; under greedy decoding the re-prefill
reproduces its KV token for token. The scheduler is host-side policy only
and copies the JAX scheduler's decisions exactly. Its view of the pool is
``pool.num_allocatable``, which under sequence parallelism is the
bottleneck shard's (``sp * min_s(avail_s)``), so SP admission needs no
branch here, and, with a prefix cache, ``pool.is_evictable``: admission
probes the cache (read-only) so that cached positions cost no budget and
forked blocks no allocation. With speculative decoding (``spec_tokens``)
each decode row reserves ``1 + spec_tokens`` of the budget. With
``chunk_size=0`` a request is admitted only when its whole prompt fits the
step's budget (decode rows first take one token each) and its blocks fit
the pool; a prompt over the whole budget runs when it is the only work.
``shed_victim`` picks the queued request that a more important arrival
displaces when the engine's queue is full. ``migrate`` re-admits a running
request after an engine restart (the supervisor's crash recovery), charged
to its ``migration_budget``; ``Request.latency_breakdown`` is the per-request
time attribution the terminal events carry.
"""
from __future__ import annotations

import enum
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"        # waiting for admission (fresh or preempted)
    RUNNING = "running"      # holds pool blocks; decodes every step
    FINISHED = "finished"    # completed normally (length | stop_token)
    FAILED = "failed"        # non-finite logits, alloc failure, budget
    CANCELLED = "cancelled"  # the client called engine.cancel(rid)
    TIMED_OUT = "timed_out"  # deadline_s or max_queue_s expired


TERMINAL_STATES = frozenset({RequestState.FINISHED, RequestState.FAILED,
                             RequestState.CANCELLED, RequestState.TIMED_OUT})


class AdmissionRejected(RuntimeError):
    """``InferenceEngine.submit`` backpressure: the wait queue is at
    ``max_queue_depth`` under the "reject" policy and no queued request is
    less important than the arrival."""

    def __init__(self, queue_depth: int, max_queue_depth: int):
        self.queue_depth = queue_depth
        self.max_queue_depth = max_queue_depth
        super().__init__(
            f"queue full: {queue_depth} waiting >= max_queue_depth "
            f"{max_queue_depth}")


@dataclass
class Request:
    """One generation request plus its engine-managed lifecycle state."""
    rid: int
    prompt: np.ndarray                  # (P,) int32
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    stop_token: Optional[int] = None
    submit_time: float = 0.0
    deadline_s: Optional[float] = None   # wall budget from submit
    max_queue_s: Optional[float] = None  # longest stretch spent QUEUED
    priority: int = 0                    # smaller = more important; read
    #                                      only when shedding under overload

    # -- engine-managed --
    state: RequestState = RequestState.QUEUED
    block_table: List[int] = field(default_factory=list)
    cache_len: int = 0                  # tokens resident in the KV pool
    prefill_len: int = 0                # tokens the current (re-)prefill
    #                                     pushes; while cache_len is short of
    #                                     it the row takes prompt chunks
    next_token: Optional[int] = None    # sampled but not yet fed back
    out_tokens: List[int] = field(default_factory=list)
    preemptions: int = 0
    migrations: int = 0                 # crash re-admissions
    migration_budget: Optional[int] = None  # migrations before the request
    #                                     FAILs as poison (None: unlimited)
    ttft_s: Optional[float] = None
    finish_reason: str = ""
    error: str = ""                     # detail for FAILED, CANCELLED and
    #                                     TIMED_OUT
    queued_time: float = 0.0            # the last move into QUEUED
    trace_id: str = ""                  # set at submit, kept across
    #                                     migrations
    # -- latency breakdown: wall seconds summed over requeues --
    queued_s: float = 0.0               # time spent QUEUED
    prefill_s: float = 0.0              # (re-)prefill time
    decode_s: float = 0.0               # decode-phase time
    stall_s: float = 0.0                # decode-phase steps that emitted no
    #                                     token for this row (part of
    #                                     decode_s: a retried fault, a step
    #                                     behind peer prefills)
    host_gap_s: float = 0.0             # time between a step's fetch and
    #                                     the next dispatch while running
    phase: str = ""                     # "", "prefill" or "decode": the
    phase_t0: float = 0.0               # open clock of the accumulators

    @property
    def is_terminal(self) -> bool:
        return self.state in TERMINAL_STATES

    def latency_breakdown(self) -> Dict[str, float]:
        """Where this request's lifetime went, in ms (terminal events carry
        it): queued, prefill, decode, stalled and host-gap time, and its
        preemption and migration counts."""
        return {
            "queued_ms": round(self.queued_s * 1e3, 3),
            "prefill_ms": round(self.prefill_s * 1e3, 3),
            "decode_ms": round(self.decode_s * 1e3, 3),
            "stalled_ms": round(self.stall_s * 1e3, 3),
            "host_gap_ms": round(self.host_gap_s * 1e3, 3),
            "preemptions": self.preemptions,
            "migrations": self.migrations,
        }

    @property
    def num_generated(self) -> int:
        return len(self.out_tokens)

    @property
    def resume_tokens(self) -> np.ndarray:
        """The sequence a (re-)prefill pushes: the prompt plus every
        generated token already fed back (the pending ``next_token`` is
        carried over as-is, so recovery never re-samples)."""
        if not self.out_tokens:
            return self.prompt
        fed = np.asarray(self.out_tokens[:-1], np.int32)
        return np.concatenate([self.prompt, fed])


@dataclass
class StepPlan:
    prefills: List[Request]
    decodes: List[Request]
    #: rid -> prompt tokens to push this step for rows still mid-prefill
    chunks: Dict[int, int] = field(default_factory=dict)


class Scheduler:
    """FCFS continuous batching over a PagedKVPool with Sarathi-style
    chunked prefill: each decode-phase row costs ``1 + spec_tokens`` budget
    tokens (its pending token and the drafted candidates scored beside it),
    rows still mid-prefill take up to ``chunk_size`` more of their prompt,
    and what is left admits queued requests at chunk granularity. The
    oldest mid-prefill row always advances; a sole request is admitted even
    over budget. ``chunk_size=0`` admits whole prompts instead (the JAX
    scheduler's legacy mode)."""

    def __init__(self, max_batch_size: int = 8, token_budget: int = 2048,
                 chunk_size: int = 64, spec_tokens: int = 0):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if chunk_size < 0:
            raise ValueError("chunk_size must be >= 0")
        if spec_tokens < 0:
            raise ValueError("spec_tokens must be >= 0")
        self.max_batch_size = int(max_batch_size)
        self.token_budget = int(token_budget)
        self.chunk_size = int(chunk_size)
        self.spec_tokens = int(spec_tokens)
        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []  # admission order (oldest first)
        # the engine's PrefixCache or None; admission only probes it, and
        # the engine forks at admit with nothing run in between, so both
        # see the same index
        self.prefix_cache = None

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    @property
    def queue_depth(self) -> int:
        return len(self.waiting)

    def submit(self, req: Request) -> None:
        req.state = RequestState.QUEUED
        req.queued_time = time.perf_counter()
        self.waiting.append(req)

    def schedule(self, pool) -> StepPlan:
        """Plan one step (``_schedule_chunked`` unless ``chunk_size`` is
        0). Whole-prompt mode: running rows take one budget token each; a
        queued request is admitted when its resume sequence fits what is
        left (or it is the only work) and its blocks fit the pool, in
        strict FCFS order."""
        if self.chunk_size:
            return self._schedule_chunked(pool)
        budget = self.token_budget - len(self.running)
        prefills: List[Request] = []
        planned_blocks = 0
        while self.waiting and \
                len(self.running) + len(prefills) < self.max_batch_size:
            req = self.waiting[0]
            need = len(req.resume_tokens)
            nb = pool.blocks_for(need)
            if planned_blocks + nb > pool.num_allocatable:
                break
            if need > budget and (prefills or self.running):
                break
            budget -= need
            planned_blocks += nb
            req.prefill_len = need
            prefills.append(self.waiting.popleft())
        return StepPlan(prefills=prefills, decodes=list(self.running))

    def _schedule_chunked(self, pool) -> StepPlan:
        """Plan one chunked step: the chunk grants of running mid-prefill rows and
        the queued requests to admit (strictly FCFS: a blocked queue head
        blocks everyone behind it). A cache hit's positions cost no budget
        and its forked blocks no allocation; reviving an evictable matched
        block takes reclaimable capacity, so it counts against
        ``pool.num_allocatable`` beside fresh blocks."""
        chunks: Dict[int, int] = {}
        budget = self.token_budget
        prefilling: List[Request] = []
        for req in self.running:
            if req.cache_len >= req.prefill_len:
                budget -= 1 + self.spec_tokens
            else:
                prefilling.append(req)
        for i, req in enumerate(prefilling):
            rem = req.prefill_len - req.cache_len
            avail = budget if budget >= 1 else (1 if i == 0 else 0)
            take = min(self.chunk_size, rem, avail)
            if take <= 0:
                continue
            chunks[req.rid] = take
            budget -= take
        prefills: List[Request] = []
        planned_blocks = 0
        while self.waiting and \
                len(self.running) + len(prefills) < self.max_batch_size:
            req = self.waiting[0]
            total = len(req.resume_tokens)
            sole = not self.running and not prefills
            if budget < 1 and not sole:
                break
            cached = forked = revive = 0
            if self.prefix_cache is not None:
                mb, cached, cow = self.prefix_cache.probe(req.resume_tokens)
                if mb:
                    # a full-cover hit forks all but its last block, whose
                    # copy-on-write clone counts in nb below
                    shared = mb[:-1] if cow else mb
                    forked = len(shared)
                    revive = sum(1 for b in shared if pool.is_evictable(b))
            take = min(self.chunk_size, total - cached, max(budget, 1))
            nb = pool.blocks_for(cached + take) - forked
            if planned_blocks + nb + revive > pool.num_allocatable:
                break
            req.prefill_len = total
            chunks[req.rid] = take
            budget -= take
            planned_blocks += nb + revive
            prefills.append(self.waiting.popleft())
        return StepPlan(prefills=prefills, decodes=list(self.running),
                        chunks=chunks)

    # -- lifecycle callbacks (engine-driven) ----------------------------------

    def admit(self, req: Request) -> None:
        req.state = RequestState.RUNNING
        self.running.append(req)

    def finish(self, req: Request, reason: str = "length") -> None:
        req.state = RequestState.FINISHED
        req.finish_reason = reason
        self.running.remove(req)

    def terminate(self, req: Request, state: RequestState,
                  error: str = "") -> None:
        """Move a request to FAILED, CANCELLED or TIMED_OUT from wherever
        it lives (the engine frees its blocks first)."""
        if state not in TERMINAL_STATES or state is RequestState.FINISHED:
            raise ValueError(f"terminate() is for failure states, got "
                             f"{state}")
        if req in self.running:
            self.running.remove(req)
        elif req in self.waiting:
            self.waiting.remove(req)
        req.state = state
        req.finish_reason = state.value
        req.error = error

    def shed_victim(self, priority: int) -> Optional[Request]:
        """The queued request an arrival of ``priority`` displaces when the
        queue is full: the one with the largest priority value, and only
        when strictly larger than ``priority``; among equals the newest.
        Running requests are never shed."""
        victim: Optional[Request] = None
        for req in self.waiting:
            if req.priority > priority and \
                    (victim is None or req.priority >= victim.priority):
                victim = req
        return victim

    def preempt_victim(self) -> Optional[Request]:
        """LIFO: the latest-admitted running request loses its blocks first
        (it has the least sunk prefill work)."""
        return self.running[-1] if self.running else None

    def requeue(self, req: Request) -> None:
        """Recompute preemption: back to the FRONT of the queue so FCFS
        order holds; generated tokens ride along via ``resume_tokens``."""
        self.running.remove(req)
        req.state = RequestState.QUEUED
        req.queued_time = time.perf_counter()
        req.preemptions += 1
        self.waiting.appendleft(req)

    def migrate(self, req: Request) -> None:
        """Crash re-admission: the motion of ``requeue``, charged to the
        request's ``migrations`` (its migration budget), not to
        ``preemptions``. The engine frees the blocks first; the resume
        sequence and the pending ``next_token`` make the resumed stream
        token-exact under greedy decoding."""
        self.running.remove(req)
        req.state = RequestState.QUEUED
        req.queued_time = time.perf_counter()
        req.migrations += 1
        self.waiting.appendleft(req)
