"""The paged pure-decode program as a captured CUDA graph: the port's
counterpart of the JAX engine's ``_jit_step`` and its ``self._jit`` cache
(``tnn_tpu.serving.engine``).

The JAX engine dispatches one compiled program per step. On a CUDA device
at sp = 1 the port captures its "pdecode" program (``apply_decode_paged``,
the logit guard and ``sample_ragged``) once per compile key
(``max_batch_size``, ``blocks_per_seq``) and replays it on every
pure-decode step, in place of some 1,400 eager dispatches. A step copies
its inputs into the graph's static buffer in one host-to-device copy (a
speculative step then copies step N's sampled tokens over the token
column on the device) and replays on the current stream; the static
``(2, B)`` bundle holds the sampled tokens and the logit guard. The logit
poison column (zero unless a fault plan poisons a row) is one more static
input of the same copy, so a NaN row fails through the replay exactly as
through the eager program.

Capture rules:

- The warm-up and the capture run on scratch inputs: every table entry
  the pool's scratch block, offsets 0, so the warm-up's K/V writes land in
  that block only (the capture itself runs nothing).
- The sampling generator's state is saved before them and restored after,
  so they consume no draws. The generator is registered with the graph,
  and each replay advances it by what the captured draws take, as the
  eager step would.
- The warm-up runs eagerly, outside the capture, on the stream the
  capture uses: it builds and loads every kernel library, passes each
  one-time ``cudaFuncSetAttribute`` and makes every arrival-counter buffer
  (``runtime.zeroed_counters``) at the size the program needs. The
  buffers are the graph's own (``runtime.private_counters``): the warm-up
  runs beside other replicas' launches of the same kernels on the default
  stream, and shared arrival counters would mix their counts. The graph
  keeps them, so nothing frees memory it writes.
- The wrappers count their launches in Python, which a replay does not
  run: the launches the warm-up and the capture counted on this thread
  (``runtime.thread_launches``) are taken back out, and each replay adds
  the capture's count again. Launches other replicas' workers make
  meanwhile stay counted.
- Replicas of a fleet share a card and step on threads of their own: one
  process-wide lock (``_CAPTURE_LOCK``) serializes their warm-ups and
  captures, so no two captures run at once. While any thread captures,
  a device-wide ``torch.cuda.synchronize()`` from another thread fails
  ("operation not permitted when stream is capturing") and the process
  aborts: the engine's own paths wait on events only, and code that
  must synchronize the device beside running replicas holds the lock
  (it is reentrant, so that code may itself capture).

- The capture runs with ``capture_error_mode="thread_local"``. Under the
  supervised server the engine steps on the supervisor's worker thread
  while the main thread reads input and prints; the default "global" mode
  would let a CUDA call from another thread invalidate the capture. (The
  supervisor also keeps every engine touch on the worker: ``worker_only``,
  and ``stats()`` marshalled through it.)

A failed capture or replay raises; nothing falls back to eager steps.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from ..ops import runtime
from . import step_build


def _launch_counters() -> List[Tuple[object, str]]:
    """(wrapper, attribute) of every kernel launch counter of the port."""
    from ..ops import decode_stack, paged_attention, quant_matmul

    pa = paged_attention.paged_attention
    return [(pa, "launches"), (pa, "int8_launches"), (pa, "stats_launches"),
            (pa, "int8_stats_launches"),
            (quant_matmul.int8_matmul, "launches"),
            (decode_stack.fused_decode_stack, "launches")]


#: one capture at a time in the process (the fleet's workers share a card)
_CAPTURE_LOCK = threading.RLock()


def _take_back(since, until) -> None:
    """Subtract from the global counters the launches this thread
    counted between two ``runtime.thread_launches()`` readings."""
    for fn, attr in _launch_counters():
        n = until[(id(fn), attr)] - since[(id(fn), attr)]
        if n:
            runtime.count_launch(fn, attr, -n)


def decode_arrays(step: step_build.DecodeStep) -> List[np.ndarray]:
    """A pdecode step's host inputs in the order the program takes them
    and the graph's static buffer holds them: tokens, offsets, tables,
    temperatures, top-k, top-p, the logit poison column."""
    return [step.toks, step.offsets, step.tables, step.temps, step.topks,
            step.topps, step.poison]


class DecodeGraph:
    """One captured pdecode program.

    program(toks, offsets, tables, temps, topks, topps, poison)
    -> (logits, bundle)
    runs the step on device tensors. ``inputs`` is the static int32
    buffer whose views the graph reads, ``logits`` and ``bundle`` its
    static outputs, ``launches`` the kernel launches one replay makes,
    ``capture_s`` the wall time of the warm-up and the capture."""

    def __init__(self, program: Callable, generator: torch.Generator, *,
                 batch: int, blocks_per_seq: int, scratch: int, device):
        self.device = torch.device(device)
        # scratch inputs: no rows, every table entry the scratch block
        like = decode_arrays(step_build.pack_decode(
            [], b=batch, nb=blocks_per_seq, scratch=scratch, paged=True,
            fused_available=False))
        self.inputs = torch.from_numpy(step_build.flat_inputs(like)).to(
            self.device)
        self.views = step_build.split_inputs(self.inputs, like)
        t0 = time.perf_counter()
        with _CAPTURE_LOCK, runtime.private_counters() as own:
            stream = torch.cuda.Stream(self.device)
            current = torch.cuda.current_stream(self.device)
            saved = generator.get_state()
            before = runtime.thread_launches()
            captured = before
            stream.wait_stream(current)
            try:
                with torch.cuda.stream(stream):
                    program(*self.views)                 # the warm-up
                    warm = runtime.thread_launches()
                    self.graph = torch.cuda.CUDAGraph()
                    self.graph.register_generator_state(generator)
                    self.graph.capture_begin(
                        capture_error_mode="thread_local")
                    try:
                        self.logits, self.bundle = program(*self.views)
                    finally:
                        self.graph.capture_end()
                current.wait_stream(stream)
                stream.synchronize()
            finally:
                generator.set_state(saved)
                captured = runtime.thread_launches()
                _take_back(before, captured)
        self.launches = [(fn, attr, captured[(id(fn), attr)]
                          - warm[(id(fn), attr)])
                         for fn, attr in _launch_counters()]
        self.counters = list(own.values())
        self.replays = 0
        self.capture_s = time.perf_counter() - t0

    def run(self, host: torch.Tensor, toks: torch.Tensor = None) \
            -> torch.Tensor:
        """Replay on ``host``, the step's flat inputs (pinned, as
        ``step_build.flat_inputs`` lays them out); ``toks``, a device
        tensor, replaces the token column. Returns the static bundle."""
        self.inputs.copy_(host, non_blocking=True)
        if toks is not None:
            self.views[0].copy_(toks)
        self.graph.replay()
        for fn, attr, n in self.launches:
            if n:
                runtime.count_launch(fn, attr, n)
        self.replays += 1
        return self.bundle


def stage(arrays: Sequence[np.ndarray]) -> torch.Tensor:
    """A step's host arrays as one pinned int32 tensor, ready for a
    non-blocking copy to the card. PyTorch's caching host allocator records
    the copy's event, so the block is not handed out again until the copy
    has run."""
    return torch.from_numpy(step_build.flat_inputs(arrays)).pin_memory()
