"""InferenceEngine (``tnn_tpu.serving.engine``): continuous batching over the
paged KV pool on one device.

    submit() --> Scheduler (FCFS queue) --> step():
        ONE mixed step packs decode rows (1 token each) and prefill CHUNKS
        (up to chunk_size prompt tokens each) into a ragged batch through
        GPT2.apply_paged; a step with no chunk work runs the pure-decode
        GPT2.apply_decode_paged instead
      --> streamed tokens / finished requests

Every layer of either forward writes its new K/V rows into the pool pages in
place and calls the ragged paged-attention kernel once
(``ops.paged_attention``), so a step launches that kernel ``num_layers``
times. This port runs the JAX engine's paged path with the prefix cache off:
chunked prefill, recompute preemption (LIFO victims, a per-request
preemption budget) and the per-row logit guard. Steps run synchronously
(one host fetch of the sampled tokens per step), and a step that raises
propagates to the caller: a kernel failure is never turned into failed
requests. Speculative decoding, the overlapped loop, int8 pools and weights,
tensor/sequence parallelism and the fault plan are not ported yet.
"""
from __future__ import annotations

import itertools
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models import sampling
from ..utils.device import resolve_device
from . import step_build
from .kv_pool import PagedKVPool
from .metrics import ServingMetrics
from .scheduler import TERMINAL_STATES, Request, RequestState, Scheduler


class InferenceEngine:
    """Continuous-batching inference over one GPT2-family model.

    model : a ``models.gpt2.GPT2`` whose parameters live on ``device``.
    num_blocks, block_size : KV pool geometry (block 0 is reserved scratch).
    max_batch_size : rows per step.
    chunk_size : prompt tokens a request may push per mixed step.
    preemption_budget : recompute preemptions a request may take before it
        FAILs instead of requeueing (None = unlimited).
    seed : seeds the sampling ``torch.Generator``.

    A request may hold up to min(model.max_len, pool capacity) positions,
    a step processes at most 2048 tokens (decode rows + prompt chunks), and
    a row whose logits are not finite FAILs its request while the rest of
    the batch keeps its tokens (the logit guard).
    device : "cuda" by default; raises without a card.
    """

    def __init__(self, model, *, num_blocks: int = 64, block_size: int = 16,
                 max_batch_size: int = 8, chunk_size: int = 64,
                 preemption_budget: Optional[int] = 16, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        param_dev = next(model.parameters()).device
        if param_dev != self.device:
            raise ValueError(f"model parameters live on {param_dev}, engine "
                             f"device is {self.device}")
        if preemption_budget is not None and preemption_budget < 0:
            raise ValueError("preemption_budget must be >= 0 or None")
        self.model = model
        self.preemption_budget = preemption_budget
        self.pool = PagedKVPool(
            num_layers=model.num_layers, num_kv_heads=model.num_kv_heads,
            head_dim=model.d_model // model.num_heads, num_blocks=num_blocks,
            block_size=block_size, dtype=model.policy.compute_dtype,
            device=self.device)
        self.max_seq_len = min(model.max_len,
                               self.pool.capacity * block_size)
        # fixed table width: every step passes this many blocks per row
        self.blocks_per_seq = self.pool.blocks_for(self.max_seq_len)
        self.scheduler = Scheduler(max_batch_size=max_batch_size,
                                   chunk_size=chunk_size)
        self.metrics = ServingMetrics()
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.requests: Dict[int, Request] = {}
        self._rid = itertools.count()
        self.model_steps = 0     # steps that ran a model forward

    # -- request lifecycle ----------------------------------------------------

    def submit(self, prompt_ids, max_new_tokens: int, *,
               temperature: float = 0.0, top_k: int = 0, top_p: float = 0.0,
               stop_token: Optional[int] = None) -> int:
        """Queue a generation request; returns its request id."""
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
        rid = next(self._rid)
        req = Request(rid=rid, prompt=prompt,
                      max_new_tokens=int(max_new_tokens),
                      temperature=float(temperature), top_k=int(top_k),
                      top_p=float(top_p), stop_token=stop_token,
                      submit_time=time.perf_counter())
        self.requests[rid] = req
        self.scheduler.submit(req)
        return rid

    @property
    def has_work(self) -> bool:
        return self.scheduler.has_work

    def result(self, rid: int) -> Request:
        return self.requests[rid]

    def stats(self) -> Dict[str, Any]:
        s: Dict[str, Any] = dict(self.metrics.summary())
        for st in RequestState:
            s[f"requests_{st.value}"] = sum(
                1 for r in self.requests.values() if r.state is st)
        s.update({"queue_depth": self.scheduler.queue_depth,
                  "num_running": len(self.scheduler.running),
                  "pool_free_blocks": self.pool.num_allocatable,
                  "model_steps": self.model_steps})
        return s

    def check_invariants(self) -> None:
        """Pool bookkeeping plus full block accounting against every
        running request's table."""
        running = [r for r in self.scheduler.running if r.block_table]
        self.pool.check_invariants([r.block_table for r in running],
                                   [r.cache_len for r in running])

    def run_until_complete(self, max_steps: int = 100_000) \
            -> Dict[int, List[int]]:
        """Step until every request is terminal; returns {rid: generated
        tokens} of the FINISHED ones."""
        steps = 0
        while self.has_work:
            self.step()
            steps += 1
            if steps > max_steps:
                raise RuntimeError(f"no convergence after {max_steps} steps")
        return {rid: list(r.out_tokens) for rid, r in self.requests.items()
                if r.state is RequestState.FINISHED}

    # -- engine step ----------------------------------------------------------

    def step(self) -> Dict[str, List]:
        """Run one serving step: admit, then one mixed prefill+decode step
        (or a pure-decode step). Returns the step's events::

            {"tokens": [(rid, token), ...], "finished": [rid, ...],
             "failed": [(rid, error), ...]}
        """
        t0 = time.perf_counter()
        events: Dict[str, List] = {"tokens": [], "finished": [],
                                   "failed": []}
        plan = self.scheduler.schedule(self.pool)
        chunks = dict(plan.chunks)
        for req in plan.prefills:
            if not self._admit(req, events):
                chunks.pop(req.rid, None)
            elif req.rid in chunks:
                chunks[req.rid] = min(chunks[req.rid],
                                      req.prefill_len - req.cache_len)
        with torch.inference_mode():
            rec = self._build(chunks, events)
            if rec is not None:
                self.model_steps += 1
                newtok, ok = rec["dev"].cpu().numpy()   # the step's one fetch
                if rec["kind"] == "mixed":
                    self._mixed_commit(rec, newtok, ok, events)
                else:
                    self._decode_commit(rec, newtok, ok, events)
        self.metrics.observe_step_latency(time.perf_counter() - t0)
        return events

    def _admit(self, req: Request, events) -> bool:
        nb_total = self.pool.blocks_for(req.prefill_len)
        if nb_total > self.blocks_per_seq:
            self._fail(req, f"oversized resume: {req.prefill_len} tokens "
                       f"need {nb_total} blocks > {self.blocks_per_seq}",
                       events)
            return False
        req.cache_len = 0
        self.scheduler.admit(req)
        return True

    def _fail(self, req: Request, error: str, events) -> None:
        if req.block_table:
            self.pool.free(req.block_table)
            req.block_table = []
        self.scheduler.fail(req, error)
        self.metrics.observe_failed()
        events["failed"].append((req.rid, error))

    def _preempt(self, req: Request) -> None:
        self.pool.free(req.block_table)
        req.block_table = []
        req.cache_len = 0
        self.scheduler.requeue(req)
        self.metrics.observe_preemption()

    def _grow_blocks(self, req: Request, new_tokens: int, events) -> bool:
        """Grow ``req.block_table`` to cover ``cache_len + new_tokens``
        positions, preempting (LIFO) when the pool runs dry. Returns True
        when the row still runs this step."""
        needed = self.pool.blocks_for(req.cache_len + new_tokens)
        grow = max(0, needed - len(req.block_table))
        while grow and not self.pool.can_alloc(grow):
            victim = self.scheduler.preempt_victim()
            if victim is None or (victim is req
                                  and len(self.scheduler.running) == 1):
                raise RuntimeError("KV pool deadlock: no preemption victim "
                                   "can free enough blocks")
            if self.preemption_budget is not None and \
                    victim.preemptions >= self.preemption_budget:
                self._fail(victim, f"preemption budget exhausted "
                           f"({victim.preemptions} >= "
                           f"{self.preemption_budget})", events)
            else:
                self._preempt(victim)
            if victim is req:
                return False
        if req.state is not RequestState.RUNNING:
            return False
        if grow:
            req.block_table.extend(self.pool.alloc(grow))
        return True

    def _build(self, chunks: Dict[int, int], events) -> Optional[Dict]:
        """Capacity pass, packing and launch. Returns the launched step's
        record (device results unfetched) or None when nothing ran."""
        for req in list(self.scheduler.running):
            if req.state is not RequestState.RUNNING:
                continue        # preempted or failed as an earlier victim
            if req.cache_len < req.prefill_len:
                take = chunks.get(req.rid)
                if take and not self._grow_blocks(req, take, events):
                    chunks.pop(req.rid, None)
            else:
                self._grow_blocks(req, 1, events)
        live = self.scheduler.running
        dec = [r for r in live if r.cache_len >= r.prefill_len]
        chk = [r for r in live
               if r.cache_len < r.prefill_len and r.rid in chunks]
        if not chk:
            return self._decode_launch(dec) if dec else None
        rows = dec + chk
        takes = {r.rid: chunks[r.rid] for r in chk}
        step = step_build.pack_mixed(
            rows, len(dec), takes, b=self.scheduler.max_batch_size,
            nb=self.blocks_per_seq, scratch=PagedKVPool.SCRATCH)
        put = self._put
        logits = self.model.apply_paged(
            put(step.toks), self.pool.pages_k, self.pool.pages_v,
            put(step.tables), put(step.starts), put(step.q_lens),
            last_only=True)
        return {"kind": "mixed", "dev": self._sample(logits, step),
                "rows": rows, "n_dec": len(dec), "takes": takes}

    def _decode_launch(self, live: Sequence[Request]) -> Dict:
        step = step_build.pack_decode(live, b=self.scheduler.max_batch_size,
                                      nb=self.blocks_per_seq,
                                      scratch=PagedKVPool.SCRATCH)
        put = self._put
        logits = self.model.apply_decode_paged(
            put(step.toks), self.pool.pages_k, self.pool.pages_v,
            put(step.tables), put(step.offsets))
        return {"kind": "decode", "dev": self._sample(logits, step),
                "live": list(live)}

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    def _sample(self, logits: torch.Tensor, step) -> torch.Tensor:
        """(2, B) int64 device tensor: sampled tokens and the logit guard."""
        ok = torch.isfinite(logits).all(dim=-1)
        newtok = sampling.sample_ragged(
            logits, self.generator, self._put(step.temps),
            self._put(step.topks), self._put(step.topps))
        return torch.stack([newtok, ok.long()])

    # -- commit ---------------------------------------------------------------

    def _emit(self, req: Request, tok: int, events) -> None:
        req.next_token = tok
        req.out_tokens.append(tok)
        events["tokens"].append((req.rid, tok))
        self._maybe_finish(req, tok, events)

    def _decode_commit(self, rec, newtok, ok, events) -> None:
        emitted = 0
        for i, req in enumerate(rec["live"]):
            if req.state in TERMINAL_STATES:
                continue
            if not ok[i]:
                self._fail(req, "non-finite logits in decode step", events)
                continue
            req.cache_len += 1
            self._emit(req, int(newtok[i]), events)
            emitted += 1
        self.metrics.observe_decode(emitted)

    def _mixed_commit(self, rec, newtok, ok, events) -> None:
        n_dec = rec["n_dec"]
        now = time.perf_counter()
        emitted = 0
        for i, req in enumerate(rec["rows"]):
            if req.state in TERMINAL_STATES:
                continue
            if not ok[i]:
                self._fail(req, "non-finite logits in decode step"
                           if i < n_dec else
                           "non-finite logits in prefill chunk", events)
                continue
            if i < n_dec:
                req.cache_len += 1
                self._emit(req, int(newtok[i]), events)
                emitted += 1
                continue
            take = rec["takes"][req.rid]
            req.cache_len += take
            self.metrics.observe_prefill_chunk(take)
            if req.cache_len < req.prefill_len or req.out_tokens:
                # more chunks to go; or a preempted request whose pending
                # next_token survives (its final chunk's sample is redundant)
                continue
            req.ttft_s = now - req.submit_time
            self.metrics.observe_ttft(req.ttft_s)
            self._emit(req, int(newtok[i]), events)
        if n_dec:
            self.metrics.observe_decode(emitted)

    def _maybe_finish(self, req: Request, tok: int, events) -> None:
        if req.stop_token is not None and tok == req.stop_token:
            reason = "stop_token"
        elif req.num_generated >= req.max_new_tokens:
            reason = "length"
        else:
            return
        self.pool.free(req.block_table)
        req.block_table = []
        self.scheduler.finish(req, reason)
        self.metrics.observe_finish()
        events["finished"].append(req.rid)
