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
(LIFO victims, a per-request preemption budget) and per-row logit guard,
with the prefix cache off. Steps run synchronously (one host fetch of the
sampled tokens per step), and a step that raises propagates to the
caller: a kernel failure is never turned into failed requests.
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
Speculative decoding, the overlapped loop, tensor parallelism and the
fault plan are not ported yet.
"""
from __future__ import annotations

import collections
import itertools
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..models import fused_decode, sampling
from ..nn.quant import quantize_for_decode
from ..ops import runtime
from ..ops.decode_stack import check_kernel_geometry, fused_decode_stack
from ..utils.device import resolve_device
from . import kv_pool, step_build
from .kv_pool import PagedKVPool
from .metrics import ServingMetrics
from .scheduler import TERMINAL_STATES, Request, RequestState, Scheduler
from .sp import SPContext


class InferenceEngine:
    """Continuous-batching inference over one GPT2-family model.

    model : a ``models.gpt2.GPT2`` whose parameters live on ``device``.
    num_blocks, block_size : KV pool geometry (block 0 is reserved scratch).
    max_batch_size : rows per step.
    chunk_size : prompt tokens a request may push per mixed step.
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

    A request may hold up to max_seq_len positions,
    a step processes at most 2048 tokens (decode rows + prompt chunks), and
    a row whose logits are not finite FAILs its request while the rest of
    the batch keeps its tokens (the logit guard).
    device : "cuda" by default; raises without a card.
    """

    def __init__(self, model, *, num_blocks: int = 64, block_size: int = 16,
                 max_batch_size: int = 8, chunk_size: int = 64,
                 preemption_budget: Optional[int] = 16, seed: int = 0,
                 kv_dtype: str = "f32", quant_weights: bool = False,
                 decode_path: str = "auto",
                 max_seq_len: Optional[int] = None, sp: int = 1,
                 sp_devices: Optional[Sequence[Any]] = None,
                 device="cuda"):
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
        if preemption_budget is not None and preemption_budget < 0:
            raise ValueError("preemption_budget must be >= 0 or None")
        self.kv_dtype = kv_dtype
        self.quant_weights = bool(quant_weights)
        self.sp = int(sp)
        if self.sp < 1:
            raise ValueError(f"sp must be >= 1, got {sp}")
        self._sp: Optional[SPContext] = None
        if self.sp > 1:
            if self.quant_weights:
                raise ValueError(
                    "quant_weights with sp>1 is unsupported, as in the JAX "
                    "engine (its int8 leaves re-materialize off the context "
                    "mesh); serve fp weights under SP")
            self._sp = SPContext(model, self.sp, devices=sp_devices)
        self.model = quantize_for_decode(model) if self.quant_weights \
            else model
        # what the paged programs step: the shard adapter under SP (same
        # paged interface over lists of shard pages and tables)
        self._step_model = self._sp.model if self._sp else self.model
        self.preemption_budget = preemption_budget
        self.pool = PagedKVPool(
            num_layers=model.num_layers, num_kv_heads=model.num_kv_heads,
            head_dim=model.d_model // model.num_heads, num_blocks=num_blocks,
            block_size=block_size, dtype=model.policy.compute_dtype,
            device=self.device, kv_dtype=kv_dtype, sp=self.sp,
            devices=self._sp.devices if self._sp else None)
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
        self.scheduler = Scheduler(max_batch_size=max_batch_size,
                                   chunk_size=chunk_size)
        self.metrics = ServingMetrics()
        self.metrics.kv_bytes_per_token = self.pool.kv_bytes_per_token
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.requests: Dict[int, Request] = {}
        self._rid = itertools.count()
        self.model_steps = 0     # steps that ran a model forward
        # model steps by program: "mixed" / "pdecode" on the paged path,
        # "mixed_standard" / "decode" / "fdecode" (lockstep, the fused
        # kernel) off it
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
        it) over the whole assembly. Tensor parallelism, which the JAX
        engine also refuses here, does not exist in the port."""
        if self.kv_dtype == "int8":
            raise ValueError(
                "fused decode assembles a contiguous compute-dtype cache: "
                "int8 pages would dequantize outside the kernel with no "
                "bandwidth win; int8 pools use the paged or standard path")
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
                  "model_steps": self.model_steps,
                  "kv_dtype": self.kv_dtype,
                  "kv_bytes_per_token": self.pool.kv_bytes_per_token,
                  "kv_scale_bytes_per_token":
                      self.pool.kv_scale_bytes_per_token,
                  "quant_weights": self.quant_weights,
                  "decode_path": ("paged" if self._paged
                                  else "fused" if self._fused is not None
                                  else "standard"),
                  "program_steps": dict(self.program_steps),
                  "sp_degree": self.sp,
                  "pool_blocks_per_shard": self.pool.blocks_per_shard})
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
            req.block_table.extend(
                self.pool.alloc(grow, start=len(req.block_table)))
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
        toks, tables = put(step.toks), self._put_tables(step.tables)
        starts, q_lens = put(step.starts), put(step.q_lens)
        if self._paged:
            self.program_steps["mixed"] += 1
            logits = self._step_model.apply_paged(
                toks, self.pool.pages_k, self.pool.pages_v, tables, starts,
                q_lens, last_only=True)
        else:
            self.program_steps["mixed_standard"] += 1
            logits = self._mixed_standard(toks, tables, starts, q_lens)
        return {"kind": "mixed", "dev": self._sample(logits, step),
                "rows": rows, "n_dec": len(dec), "takes": takes}

    def _decode_launch(self, live: Sequence[Request]) -> Dict:
        step = step_build.pack_decode(
            live, b=self.scheduler.max_batch_size, nb=self.blocks_per_seq,
            scratch=PagedKVPool.SCRATCH, paged=self._paged,
            fused_available=self._fused is not None)
        put = self._put
        toks, tables = put(step.toks), self._put_tables(step.tables)
        self.program_steps[step.program] += 1
        if step.program == "pdecode":
            logits = self._step_model.apply_decode_paged(
                toks, self.pool.pages_k, self.pool.pages_v, tables,
                put(step.offsets))
        elif step.program == "fdecode":
            logits = self._fused_decode(toks, tables, int(step.offsets[0]))
        else:
            logits = self._decode_standard(toks, tables, put(step.offsets))
        return {"kind": "decode", "dev": self._sample(logits, step),
                "live": list(live)}

    # -- the assembled-cache programs (JAX's _mixed_standard_fn, _decode_fn,
    # _fused_decode_fn) ---------------------------------------------------

    def _gather(self, tables):
        return kv_pool.gather_kv(self.pool.pages_k, self.pool.pages_v,
                                 tables,
                                 out_dtype=self.model.policy.compute_dtype)

    def _mixed_standard(self, toks, tables, starts, q_lens):
        """The ragged mixed step on assembled caches: each row's chunk runs
        ``apply_cached`` at its own start; the head runs on each row's
        last live position; the chunk's new rows go back to the pages."""
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
        last = x[rows[:, 0], (q_lens.long() - 1).clamp_min(0)]
        logits = model._head(last[:, None])[:, 0]
        kv_pool.scatter_chunk(self.pool.pages_k, tables, starts,
                              torch.stack(rows_k), q_lens)
        kv_pool.scatter_chunk(self.pool.pages_v, tables, starts,
                              torch.stack(rows_v), q_lens)
        return logits

    def _decode_standard(self, toks, tables, offsets):
        """The ragged pure-decode step on assembled caches."""
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

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    def _put_tables(self, tables: np.ndarray):
        """A step's GLOBAL block tables as the programs take them: one
        tensor, or under SP each shard's local tables on its device."""
        if self._sp is None:
            return self._put(tables)
        local = step_build.shard_tables(tables, self.sp,
                                        self.pool.blocks_per_shard)
        return [torch.from_numpy(t).to(d)
                for t, d in zip(local, self._sp.devices)]

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
