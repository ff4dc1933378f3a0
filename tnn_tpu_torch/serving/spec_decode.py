"""Speculative-decoding drafters (``tnn_tpu.serving.spec_decode``).

A drafter proposes up to ``k`` continuation tokens for one decode row. The
engine packs ``[next_token, d_1, ..., d_k]`` as a ragged ``q_len = k + 1``
row into its mixed step, scores every position in one forward (on the
paged path the verify row goes through the paged-attention kernel like a
prefill chunk), and commits the longest verified prefix plus one token of
its own (greedy rows accept a draft iff it is the argmax; stochastic rows
run rejection sampling). A bad drafter costs acceptance, never
correctness.

``NGramDrafter`` looks the row's own context up for the most recent
earlier occurrence of its length-n suffix and proposes what followed it,
on the host. ``DraftModelDrafter`` greedily decodes k tokens with a small
stand-in model's own ``apply_cached`` cache (one row, context width
bucketed to powers of two) and returns them on the device, clamped into
the vocabulary there, as a ``DeviceDraft``: the engine splices them into
the step's token matrix and reads their values back in the step's one
fetch. The draft model must share the target's vocabulary.

Both drafters are deterministic given the context, which is what makes
stochastic verification exact: the proposal is a point mass.
"""
from __future__ import annotations

from typing import List, Union

import numpy as np
import torch

from ..utils.bucketing import pow2_bucket


class DeviceDraft:
    """A proposal whose token ids stay on the device: ``toks`` is a (k,)
    int32 tensor, already clamped into the target vocabulary."""

    __slots__ = ("toks",)

    def __init__(self, toks: torch.Tensor):
        self.toks = toks

    def __len__(self) -> int:
        return int(self.toks.shape[0])

    def tolist(self) -> List[int]:
        """The draft's values. This syncs: for tests and tools off the step
        path."""
        return self.toks.cpu().tolist()


DraftResult = Union[List[int], DeviceDraft]


class Drafter:
    """``draft(req, k)`` sees a request mid-decode (context: ``req.prompt``
    then ``req.out_tokens``, whose last element is the pending
    ``next_token``) and returns 0..k proposed token ids. Fewer, or none,
    is always legal."""

    name = "base"

    def draft(self, req, k: int) -> DraftResult:
        raise NotImplementedError


def _context(req) -> np.ndarray:
    out = np.asarray(req.out_tokens, np.int32)
    return np.concatenate([req.prompt, out]) if out.size else req.prompt


class NGramDrafter(Drafter):
    """Propose the tokens that followed the most recent earlier occurrence
    of the context's length-n suffix, n from ``max_n`` down to
    ``min_n``."""

    name = "ngram"

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not 1 <= min_n <= max_n:
            raise ValueError(f"need 1 <= min_n <= max_n, got "
                             f"[{min_n}, {max_n}]")
        self.max_n = int(max_n)
        self.min_n = int(min_n)

    def draft(self, req, k: int) -> List[int]:
        ctx = _context(req)
        for n in range(min(self.max_n, len(ctx) - 1), self.min_n - 1, -1):
            suffix = ctx[-n:]
            # windows over ctx[:-1]: each start has a token after its match,
            # and the suffix's own start is excluded
            windows = np.lib.stride_tricks.sliding_window_view(ctx[:-1], n)
            hits = np.flatnonzero((windows == suffix).all(axis=1))
            if hits.size:
                j = int(hits[-1]) + n     # the most recent repetition
                return [int(t) for t in ctx[j:j + k]]
        return []


class DraftModelDrafter(Drafter):
    """A small stand-in model's greedy decode of k tokens: one prefill of
    the padded context, then k - 1 single-token steps, on the model's own
    device. Padded positions past the context hold garbage KV that the
    causal mask keeps out of every attended range."""

    name = "draft"

    def __init__(self, model):
        self.model = model

    @torch.inference_mode()
    def draft(self, req, k: int) -> DraftResult:
        model = self.model
        ctx = _context(req)
        # the draft model's own position cap may be shorter than the
        # target's: a shorter draft is still useful
        k = min(k, model.max_len - len(ctx))
        if k < 1 or len(ctx) < 1:
            return []
        # len(ctx) <= max_len - k, so the bucket never undershoots ctx
        width = pow2_bucket(len(ctx), cap=model.max_len - k)
        ids = np.zeros((1, width), np.int64)
        ids[0, :len(ctx)] = ctx
        caches = model.init_cache(1, width + k)
        ids = torch.from_numpy(ids)
        if model.device.type == "cuda":
            # an explicit put: pinned memory, no wait for the card (the
            # step runs the drafter inside its TNN_DEBUG_SYNC guard)
            ids = ids.pin_memory().to(model.device, non_blocking=True)
        logits = model.apply_cached(ids.to(model.device), caches, 0)
        tok = logits[0, len(ctx) - 1].argmax()
        drafts = [tok]
        for j in range(k - 1):
            logits = model.apply_cached(tok.view(1, 1), caches, len(ctx) + j)
            tok = logits[0, -1].argmax()
            drafts.append(tok)
        # clamp into the target vocabulary on the device: a host-side
        # clamp would need the values
        return DeviceDraft(torch.stack(drafts).remainder(model.vocab_size)
                           .to(torch.int32))
