"""Deterministic fault injection for chaos-testing the serving engine
(``tnn_tpu.serving.faults``; pure numpy, the port keeps its own copy so
the same seed over the same call sequence fires the same faults).

A seeded ``FaultPlan`` hooks into the two places faults enter a serving
stack — the allocator (``PagedKVPool.alloc`` consults ``pool.fault_plan``)
and the engine's step sites (``InferenceEngine(..., faults=plan)``) — and
fires failures either probabilistically or at explicit 1-based call
indices:

- **pool-alloc failure**: an injected ``PoolExhausted`` raised before any
  bookkeeping mutates, mid-prefill or mid-decode-growth;
- **step exceptions**: ``FaultInjected`` raised at the prefill/decode call
  sites (host-level, *before* the launch, so the pool pages are never
  harmed by the injection itself). ``transient_exc=True`` models a
  recoverable glitch — the engine retries the decode once with the same
  sampling state; ``False`` models a hard step failure (batch abort);
- **NaN logits**: per-row poison values that flow through the compiled
  step's real logits, exercising the engine's logit guard exactly as a
  genuine numeric blowup would;
- **draft poisoning**: corrupts a decode row's speculative-draft proposal
  before it is packed (``draft.poison``), proving token-exact verification
  rejects garbage drafts at the cost of acceptance rate only;
- **artificial step latency**: ``time.sleep`` at the top of every engine
  step (or only the steps named by ``step_delay_calls``), for deadline /
  queue-timeout / watchdog tests that need wall time to pass;
- **engine-loop crash**: ``EngineCrash`` raised at the top of scheduled
  steps. Deliberately *not* a ``FaultInjected`` — nothing inside the
  engine catches it, so it escapes ``engine.step()`` entirely, modelling
  the step loop itself dying. Only a supervisor above the engine
  (``serving/supervisor.py``) can recover;
- **connection-level faults**: ``client_disconnect`` / ``slow_consumer`` /
  ``malformed_request`` are consulted by front ends and chaos harnesses
  (the engine never calls them) to decide when a simulated client drops
  mid-stream, stalls its reads, or sends a garbage payload;
- **replica-level faults**: ``replica_kill`` (site "replica.kill") is
  consulted by the router's chaos harness to hard-kill a chosen replica
  mid-step; ``net_delay`` / ``net_drop`` (sites "net.delay" / "net.drop")
  model router↔replica call latency and loss at the router's call seam;
  ``replica_slow`` (site "replica.slow") schedules the *gray* failure — a
  chosen replica turns persistently slow (``Router.slow_replica`` applies
  ``replica_slow_s`` of per-step delay) without ever erroring;
  ``net_partition`` (site "net.partition") opens a window of
  ``net_partition_rounds`` consults during which EVERY router↔replica
  call fails (``partition_active`` is the per-call pure read);
  ``flaky_drop`` (site "net.flaky") drops calls to one configured
  ``flaky_replica`` only — one bad NIC, not a bad network;
- **host-tier faults**: ``tier_demote_fail`` (site "tier.demote_fail")
  makes a demotion fail — the block falls back to plain eviction;
  ``tier_corrupt`` (site "tier.corrupt") flips a byte in a demoted
  payload at readmit time, which the tier's digest check must catch and
  degrade to an uncached miss; ``tier_slow_readmit`` (site
  "tier.slow_readmit") stalls a readmit ``tier_slow_readmit_s`` without
  failing it (a paged-out host buffer, not a corrupt one);
- **KV-handoff faults**: ``handoff_corrupt`` (site "handoff.corrupt")
  flips a byte in a cross-replica wire payload before the receiver's
  digest verification — the verifier must catch it and the router
  degrades to recompute-resume; ``handoff_slow`` (site "handoff.slow")
  stalls an adopt ``handoff_slow_s`` without failing it;
- **fleet-scaling faults**: ``scale_join_fail`` (site "scale.join_fail")
  makes a replica join fail mid-scale-up — the router's ``add_replica``
  raises before the new replica enters placement, and the autoscaler's
  bounded retry must absorb it.

Everything is driven by one ``numpy`` Generator seeded at construction:
the same plan over the same call sequence fires the same faults, so chaos
tests are reproducible bit-for-bit. ``plan.calls`` / ``plan.fired`` record
per-site call and fire counts for assertions.

    plan = FaultPlan(seed=7, alloc_fail_prob=0.1, nan_logit_calls=(4,))
    eng = InferenceEngine(model, params, faults=plan, ...)
    ...
    assert plan.fired["pool.alloc"] > 0

The invariant every chaos test asserts: every submitted request reaches a
terminal state, survivors are token-identical to a fault-free run, and the
pool ends with zero leaked blocks (``check_invariants`` clean).
"""
from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Tuple

import numpy as np


class FaultInjected(RuntimeError):
    """Raised by a FaultPlan at an injected step-exception site."""

    def __init__(self, site: str, call: int, transient: bool = True):
        self.site = site
        self.call = call
        self.transient = transient
        kind = "transient" if transient else "persistent"
        super().__init__(f"injected {kind} fault at {site} (call #{call})")


class EngineCrash(RuntimeError):
    """Injected engine-loop death. NOT a FaultInjected on purpose: the
    engine's internal retry/isolation paths must not see it — it escapes
    ``engine.step()`` so that only a supervisor can observe and recover."""


@dataclass
class FaultPlan:
    """Seeded, deterministic fault schedule. ``*_calls`` are explicit
    1-based call indices that always fire; ``*_prob`` adds an independent
    per-call (or per-row, for NaN logits) Bernoulli draw."""

    seed: int = 0
    # injected PoolExhausted from pool.alloc (site "pool.alloc")
    alloc_fail_prob: float = 0.0
    alloc_fail_calls: Tuple[int, ...] = ()
    # host-level exceptions at the engine's step sites
    prefill_exc_prob: float = 0.0
    prefill_exc_calls: Tuple[int, ...] = ()       # site "prefill"
    decode_exc_prob: float = 0.0
    decode_exc_calls: Tuple[int, ...] = ()        # site "decode"
    transient_exc: bool = True                    # decode retries once if True
    # NaN poison added to logits inside the step program
    nan_logit_prob: float = 0.0                   # per live row, per decode
    nan_logit_calls: Tuple[int, ...] = ()         # poisons row 0 of that call
    nan_prefill_calls: Tuple[int, ...] = ()       # site "prefill.logits"
    # corrupted speculative-draft proposals (site "draft.poison"): the engine
    # replaces a row's drafted tokens with garbage BEFORE packing them, so the
    # verifier must reject them — proving corrupted drafts cost acceptance,
    # never correctness. Consulted once per non-empty draft.
    draft_poison_prob: float = 0.0
    draft_poison_calls: Tuple[int, ...] = ()
    # artificial latency at the top of engine steps; empty step_delay_calls
    # delays every step, otherwise only the listed 1-based step indices
    step_delay_s: float = 0.0
    step_delay_calls: Tuple[int, ...] = ()
    # artificial latency proportional to prompt tokens committed by a
    # prefill chunk (site "prefill.delay"): models compute cost that scales
    # with chunk size, so benches can surface prefill/decode interference
    # on hosts where the real forward pass is too cheap to measure
    prefill_delay_per_token_s: float = 0.0
    # engine-loop crash escaping engine.step (site "engine.step")
    step_crash_calls: Tuple[int, ...] = ()
    # connection-level faults, consulted by front ends / chaos clients
    client_disconnect_prob: float = 0.0
    client_disconnect_calls: Tuple[int, ...] = ()  # site "client.disconnect"
    slow_consumer_prob: float = 0.0
    slow_consumer_calls: Tuple[int, ...] = ()      # site "client.slow"
    slow_consumer_stall_s: float = 0.05            # how long a slow read stalls
    malformed_request_prob: float = 0.0
    malformed_request_calls: Tuple[int, ...] = ()  # site "client.malformed"
    # replica-level faults, consulted by the router / its chaos harness
    replica_kill_prob: float = 0.0
    replica_kill_calls: Tuple[int, ...] = ()       # site "replica.kill"
    net_delay_prob: float = 0.0
    net_delay_calls: Tuple[int, ...] = ()          # site "net.delay"
    net_delay_s: float = 0.01                      # injected call latency
    net_drop_prob: float = 0.0
    net_drop_calls: Tuple[int, ...] = ()           # site "net.drop"
    # gray failure: a chosen replica turns PERSISTENTLY slow (site
    # "replica.slow"). Like replica.kill, the plan decides WHEN; the
    # harness picks WHICH replica and applies replica_slow_s per step
    replica_slow_prob: float = 0.0
    replica_slow_calls: Tuple[int, ...] = ()       # site "replica.slow"
    replica_slow_s: float = 0.02                   # injected per-step delay
    # router↔replica network partition (site "net.partition"): a hit opens
    # a window of net_partition_rounds consults during which EVERY
    # router↔replica call must fail — a switch outage, not per-call loss
    net_partition_prob: float = 0.0
    net_partition_calls: Tuple[int, ...] = ()
    net_partition_rounds: int = 3
    # per-replica flaky drop (site "net.flaky"): only calls to
    # flaky_replica are consulted/dropped (-1 disables the site)
    flaky_replica: int = -1
    flaky_drop_prob: float = 0.0
    flaky_drop_calls: Tuple[int, ...] = ()
    # host-KV-tier faults (consulted by serving.kv_tier.HostKVTier)
    tier_demote_fail_prob: float = 0.0
    tier_demote_fail_calls: Tuple[int, ...] = ()   # site "tier.demote_fail"
    tier_corrupt_prob: float = 0.0
    tier_corrupt_calls: Tuple[int, ...] = ()       # site "tier.corrupt"
    tier_slow_readmit_prob: float = 0.0
    tier_slow_readmit_calls: Tuple[int, ...] = ()  # site "tier.slow_readmit"
    tier_slow_readmit_s: float = 0.01              # injected readmit stall
    # cross-replica KV-handoff faults (consulted by engine.adopt_prefix on
    # the RECEIVING replica): handoff_corrupt flips a byte of a wire payload
    # before digest verification — the verifier must catch it and the router
    # degrades to recompute-resume; handoff_slow stalls the adopt
    # handoff_slow_s without failing it (a congested transfer, not a lost
    # one)
    handoff_corrupt_prob: float = 0.0
    handoff_corrupt_calls: Tuple[int, ...] = ()    # site "handoff.corrupt"
    handoff_slow_prob: float = 0.0
    handoff_slow_calls: Tuple[int, ...] = ()       # site "handoff.slow"
    handoff_slow_s: float = 0.01                   # injected adopt stall
    # fleet-scaling faults (consulted by Router.add_replica)
    scale_join_fail_prob: float = 0.0
    scale_join_fail_calls: Tuple[int, ...] = ()    # site "scale.join_fail"

    calls: Counter = field(default_factory=Counter, init=False)
    fired: Counter = field(default_factory=Counter, init=False)

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._partition_left = 0   # consults left in the open window

    # -- internal -------------------------------------------------------------

    def _fires(self, site: str, prob: float, at_calls: Tuple[int, ...]) -> bool:
        self.calls[site] += 1
        n = self.calls[site]
        # draw even on scheduled hits so the rng stream depends only on the
        # call sequence, not on which mechanism fired
        drew = prob > 0.0 and float(self._rng.random()) < prob
        hit = n in at_calls or drew
        if hit:
            self.fired[site] += 1
        return hit

    # -- hook sites -----------------------------------------------------------

    def on_alloc(self, n: int, num_free: int) -> None:
        """Called by PagedKVPool.alloc before mutating the free list."""
        if self._fires("pool.alloc", self.alloc_fail_prob,
                       self.alloc_fail_calls):
            from .kv_pool import PoolExhausted

            raise PoolExhausted(
                f"injected allocation failure "
                f"(call #{self.calls['pool.alloc']}: wanted {n}, "
                f"{num_free} free)")

    def on_prefill(self) -> None:
        """Engine prefill site — fires before the request allocates blocks."""
        if self._fires("prefill", self.prefill_exc_prob,
                       self.prefill_exc_calls):
            raise FaultInjected("prefill", self.calls["prefill"],
                                self.transient_exc)

    def on_decode(self) -> None:
        """Engine decode site — fires before the step's launch (pages and
        generator untouched, so a transient fault is safely retryable)."""
        if self._fires("decode", self.decode_exc_prob, self.decode_exc_calls):
            raise FaultInjected("decode", self.calls["decode"],
                                self.transient_exc)

    def poison_prefill(self) -> bool:
        """True when this prefill's logits should be poisoned to NaN."""
        return self._fires("prefill.logits", 0.0, self.nan_prefill_calls)

    def poison_draft(self) -> bool:
        """True when this row's speculative-draft proposal should be
        corrupted before packing (site "draft.poison"). Verification must
        reject the garbage tokens — the request's output stream stays exact,
        only the acceptance rate pays."""
        return self._fires("draft.poison", self.draft_poison_prob,
                           self.draft_poison_calls)

    def poison_rows(self, num_live: int) -> np.ndarray:
        """Boolean ``(num_live,)`` mask of decode rows whose logits this
        call poisons to NaN (site "decode.logits"; nth-call poisons row 0)."""
        self.calls["decode.logits"] += 1
        n = self.calls["decode.logits"]
        mask = np.zeros(num_live, bool)
        if num_live and n in self.nan_logit_calls:
            mask[0] = True
        if self.nan_logit_prob > 0.0 and num_live:
            mask |= self._rng.random(num_live) < self.nan_logit_prob
        self.fired["decode.logits"] += int(mask.sum())
        return mask

    def on_step(self) -> None:
        """Top of every engine step: artificial latency, and the injected
        engine-loop crash site (``EngineCrash`` escapes ``engine.step``)."""
        crash = self._fires("engine.step", 0.0, self.step_crash_calls)
        n = self.calls["engine.step"]
        if self.step_delay_s > 0.0 and (
                not self.step_delay_calls or n in self.step_delay_calls):
            time.sleep(self.step_delay_s)
        if crash:
            raise EngineCrash(f"injected engine-loop crash (step #{n})")

    def prefill_delay(self, tokens: int) -> None:
        """Per-token artificial prefill latency (site "prefill.delay"):
        called once per committed prompt chunk with the number of tokens
        it advanced. Lets a bench charge prefill work a realistic cost so
        prefill/decode interference shows up in step cadence."""
        if self.prefill_delay_per_token_s > 0.0 and tokens > 0:
            time.sleep(self.prefill_delay_per_token_s * tokens)

    # -- connection-level sites (called by front ends, not the engine) --------

    def client_disconnect(self) -> bool:
        """One streamed event reached a chaos client: True when the client
        drops the connection mid-stream (site "client.disconnect")."""
        return self._fires("client.disconnect", self.client_disconnect_prob,
                           self.client_disconnect_calls)

    def slow_consumer(self) -> bool:
        """True when a chaos client should stall its next read for
        ``slow_consumer_stall_s`` (site "client.slow")."""
        return self._fires("client.slow", self.slow_consumer_prob,
                           self.slow_consumer_calls)

    def malformed_request(self) -> bool:
        """True when a chaos client should corrupt its next request payload
        (site "client.malformed")."""
        return self._fires("client.malformed", self.malformed_request_prob,
                           self.malformed_request_calls)

    # -- replica-level sites (called by the router / its chaos harness) -------

    def replica_kill(self) -> bool:
        """Consulted once per router pump round (or harness-defined tick):
        True when the chosen replica should be hard-killed mid-step (site
        "replica.kill"). WHICH replica dies is the harness's choice — the
        plan only decides WHEN, keeping the schedule seed-deterministic."""
        return self._fires("replica.kill", self.replica_kill_prob,
                           self.replica_kill_calls)

    def net_delay(self) -> bool:
        """True when a router↔replica call should stall ``net_delay_s``
        before dispatch (site "net.delay")."""
        return self._fires("net.delay", self.net_delay_prob,
                           self.net_delay_calls)

    def net_drop(self) -> bool:
        """True when a router↔replica call should be dropped — the router
        sees a connection failure and must retry/fail over (site
        "net.drop")."""
        return self._fires("net.drop", self.net_drop_prob,
                           self.net_drop_calls)

    def replica_slow(self) -> bool:
        """Consulted once per router pump round (or harness tick): True
        when the chosen replica should turn persistently slow — the gray
        failure itself (site "replica.slow"). As with ``replica_kill``,
        the plan only decides WHEN; the harness picks WHICH replica and
        actuates via ``Router.slow_replica(idx, replica_slow_s)``."""
        return self._fires("replica.slow", self.replica_slow_prob,
                           self.replica_slow_calls)

    def net_partition(self) -> bool:
        """Consulted once per router pump round (site "net.partition"):
        True while a partition window is open. A hit opens (or extends) a
        window of ``net_partition_rounds`` consults; for its duration
        ``partition_active`` is True and every router↔replica call fails.
        The rng stream depends only on the consult sequence, so the same
        seed over the same rounds opens the same windows."""
        hit = self._fires("net.partition", self.net_partition_prob,
                          self.net_partition_calls)
        if hit:
            self._partition_left = max(self._partition_left,
                                       int(self.net_partition_rounds))
        active = self._partition_left > 0
        if active:
            self._partition_left -= 1
        return active

    @property
    def partition_active(self) -> bool:
        """Is a net.partition window currently open? Pure read — the
        router consults this per call WITHOUT advancing the rng stream
        (window accounting lives in the per-round ``net_partition``)."""
        return self._partition_left > 0

    # -- host-tier sites (called by serving.kv_tier.HostKVTier) ---------------

    def tier_demote_fail(self) -> bool:
        """Consulted once per demotion attempt: True when this block's
        demotion should fail (site "tier.demote_fail"). The tier returns
        False to the pool's demote hook and the block is plainly evicted —
        a failed demote may cost a future hit, never a request."""
        return self._fires("tier.demote_fail", self.tier_demote_fail_prob,
                           self.tier_demote_fail_calls)

    def tier_corrupt(self) -> bool:
        """Consulted once per readmit attempt: True when the demoted
        payload should be corrupted before the tier's digest verification
        (site "tier.corrupt"). The verifier must catch the damage and
        degrade the lookup to an uncached miss — never wrong KV."""
        return self._fires("tier.corrupt", self.tier_corrupt_prob,
                           self.tier_corrupt_calls)

    def tier_slow_readmit(self) -> bool:
        """Consulted once per readmit attempt: True when the readmit should
        stall ``tier_slow_readmit_s`` before proceeding (site
        "tier.slow_readmit") — a paged-out or contended host buffer. The
        readmit still succeeds; only latency pays."""
        return self._fires("tier.slow_readmit", self.tier_slow_readmit_prob,
                           self.tier_slow_readmit_calls)

    # -- KV-handoff sites (called by engine.adopt_prefix on the receiver) -----

    def handoff_corrupt(self) -> bool:
        """Consulted once per adopted wire block: True when the payload
        should be corrupted before digest verification (site
        "handoff.corrupt"). The verifier must catch the damage and the
        handoff degrades to recompute-resume — never wrong KV, never a
        dropped request."""
        return self._fires("handoff.corrupt", self.handoff_corrupt_prob,
                           self.handoff_corrupt_calls)

    def handoff_slow(self) -> bool:
        """Consulted once per adopted wire block: True when the adopt
        should stall ``handoff_slow_s`` before proceeding (site
        "handoff.slow") — a congested inter-replica transfer. The adopt
        still succeeds; only latency pays."""
        return self._fires("handoff.slow", self.handoff_slow_prob,
                           self.handoff_slow_calls)

    # -- fleet-scaling sites (called by Router.add_replica) -------------------

    def scale_join_fail(self) -> bool:
        """Consulted once per replica-join attempt: True when the join
        should fail before the new replica enters placement (site
        "scale.join_fail"). The autoscaler's bounded retry absorbs it; the
        fleet never sees a half-joined replica."""
        return self._fires("scale.join_fail", self.scale_join_fail_prob,
                           self.scale_join_fail_calls)

    def flaky_drop(self, replica: int) -> bool:
        """True when THIS call to ``replica`` should drop (site
        "net.flaky"). Only the configured ``flaky_replica`` is consulted,
        so the rng stream depends only on the flaky replica's own call
        sequence — calls to healthy replicas never perturb the schedule."""
        if self.flaky_replica < 0 or replica != self.flaky_replica:
            return False
        return self._fires("net.flaky", self.flaky_drop_prob,
                           self.flaky_drop_calls)
