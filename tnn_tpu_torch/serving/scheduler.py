"""Continuous-batching scheduler (``tnn_tpu.serving.scheduler``): FCFS
admission, a per-step token budget, chunked prefill and LIFO recompute
preemption.

Running requests decode one token every step; queued requests are admitted
whenever the batch has a free slot, the step's token budget allows a chunk
and the pool has blocks. When the pool runs dry the latest-admitted running
request frees its blocks and re-queues at the front, carrying its generated
tokens as an extended prompt; under greedy decoding the re-prefill
reproduces its KV token for token. The scheduler is host-side policy only
and copies the JAX scheduler's decisions exactly (with the prefix cache
off). Its only view of the pool is ``pool.num_allocatable``, which under
sequence parallelism is the bottleneck shard's (``sp * min_s(free_s)``),
so SP admission needs no branch here.
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


TERMINAL_STATES = frozenset({RequestState.FINISHED, RequestState.FAILED})


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
    ttft_s: Optional[float] = None
    finish_reason: str = ""
    error: str = ""
    queued_time: float = 0.0

    @property
    def is_terminal(self) -> bool:
        return self.state in TERMINAL_STATES

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
    chunked prefill: each decode-phase row costs 1 budget token, rows still
    mid-prefill take up to ``chunk_size`` more of their prompt, and what is
    left admits queued requests at chunk granularity. The oldest mid-prefill
    row always advances; a sole request is admitted even over budget."""

    def __init__(self, max_batch_size: int = 8, token_budget: int = 2048,
                 chunk_size: int = 64):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        self.max_batch_size = int(max_batch_size)
        self.token_budget = int(token_budget)
        self.chunk_size = int(chunk_size)
        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []  # admission order (oldest first)

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
        """Plan one step: the chunk grants of running mid-prefill rows and
        the queued requests to admit (strictly FCFS: a blocked queue head
        blocks everyone behind it)."""
        chunks: Dict[int, int] = {}
        budget = self.token_budget
        prefilling: List[Request] = []
        for req in self.running:
            if req.cache_len >= req.prefill_len:
                budget -= 1
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
            take = min(self.chunk_size, total, max(budget, 1))
            nb = pool.blocks_for(take)
            if planned_blocks + nb > pool.num_allocatable:
                break
            req.prefill_len = total
            chunks[req.rid] = take
            budget -= take
            planned_blocks += nb
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

    def fail(self, req: Request, error: str) -> None:
        """Move a request to FAILED from wherever it lives (the engine frees
        its blocks first)."""
        if req in self.running:
            self.running.remove(req)
        elif req in self.waiting:
            self.waiting.remove(req)
        req.state = RequestState.FAILED
        req.finish_reason = RequestState.FAILED.value
        req.error = error

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
