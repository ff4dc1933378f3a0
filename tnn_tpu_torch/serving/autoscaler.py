"""Load-driven fleet autoscaler (``tnn_tpu.serving.autoscaler``): a control
loop over :class:`Router`.

The router gives the fleet *resilience* — it reroutes around dead and
degraded replicas — but its fleet size is fixed at construction. A real
deployment's load is not: a traffic spike that doubles queue depth wants
more replicas NOW, and the quiet hour after it wants them gone (card
hours are the cost model's denominator). This module closes that loop:

    observe  -> router.open_requests / num_active_replicas (load per
                replica) and router.ttft_quantile(95) vs the SLO
    decide   -> threshold crossings filtered by hysteresis + cooldown
    actuate  -> router.add_replica(factory)   (scale up)
                router.retire_replica(victim) (scale down, zero-loss)

Stability over reactivity
-------------------------
A naive threshold controller flaps: one burst admits a replica, the
burst's own completion drops load below the down-threshold, the replica
is retired, the next burst re-admits it — each cycle paying engine
construction and losing the retired replica's prefix cache. Three
standard guards (the same trio as the supervisor's restart/backoff and
the router's circuit breakers — "bounded reaction" is this codebase's
recurring answer to feedback loops):

- **dual thresholds**: scale up above ``up_load``, down below
  ``down_load``, with a dead band between them (enforced
  ``up_load > down_load`` at construction);
- **hysteresis**: load must stay below ``down_load`` CONTINUOUSLY for
  ``hysteresis_s`` before a scale-down fires (one quiet tick proves
  nothing; ``_low_since`` resets on any tick at or above threshold);
- **cooldown**: after ANY scale action, both directions are locked out
  for ``cooldown_s`` — the fleet must re-converge before the controller
  trusts its signal again (a just-joined replica starts empty, which
  temporarily deflates mean load; reacting to that would retire it).

Scale-up joins are retried at most ``join_retries`` times per tick
(``scale.join_fail`` chaos fires as :class:`NetDrop`, a
``ConnectionError``): bounded like every retry loop in this repo, and a
tick that exhausts its retries simply leaves scaling to a later tick —
the fleet stays at its current size, requests keep flowing.

Scale-down picks the active replica with the FEWEST router-assigned
live streams (cheapest zero-loss migration) and retires it through
:meth:`Router.retire_replica`, which proactively migrates its streams
token-exact and drains the replica gracefully — the autoscaler never
drops a request by construction. The router refuses to retire the last
active replica, and ``min_replicas``/``max_replicas`` bound the fleet
even if thresholds misfire.

Driving: ``tick()`` is the whole control law — pump-driven harnesses
interleave it with ``router.pump()`` for deterministic tests; started
routers get a daemon thread via ``start()``/``stop()`` ticking every
``interval_s``.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

from .router import Router
from .supervisor import EngineSupervisor

__all__ = ["Autoscaler"]


class Autoscaler:
    """Threshold controller with hysteresis + cooldown over one router.

    ``replica_factory`` is a zero-arg callable building a ready
    :class:`EngineSupervisor`; it runs once per successful scale-up (the
    ``scale.join_fail`` chaos site fires before it, so an injected join
    failure never half-builds an engine).
    """

    def __init__(self, router: Router,
                 replica_factory: Callable[[], EngineSupervisor], *,
                 min_replicas: int = 1, max_replicas: int = 4,
                 up_load: float = 4.0, down_load: float = 1.0,
                 slo_ttft_s: Optional[float] = None,
                 hysteresis_s: float = 0.25, cooldown_s: float = 0.5,
                 join_retries: int = 2, interval_s: float = 0.05):
        if min_replicas < 1:
            raise ValueError(
                f"min_replicas must be >= 1, got {min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas ({max_replicas}) must be >= min_replicas "
                f"({min_replicas})")
        if not up_load > down_load:
            raise ValueError(
                f"up_load ({up_load}) must exceed down_load "
                f"({down_load}) — a dead band prevents flapping")
        if slo_ttft_s is not None and slo_ttft_s <= 0:
            raise ValueError(f"slo_ttft_s must be > 0, got {slo_ttft_s}")
        if hysteresis_s < 0 or cooldown_s < 0:
            raise ValueError("hysteresis_s and cooldown_s must be >= 0")
        if join_retries < 0:
            raise ValueError(
                f"join_retries must be >= 0, got {join_retries}")
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.router = router
        self.replica_factory = replica_factory
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.up_load = float(up_load)
        self.down_load = float(down_load)
        self.slo_ttft_s = None if slo_ttft_s is None else float(slo_ttft_s)
        self.hysteresis_s = float(hysteresis_s)
        self.cooldown_s = float(cooldown_s)
        self.join_retries = int(join_retries)
        self.interval_s = float(interval_s)
        self._low_since: Optional[float] = None
        self._last_action_t: float = -float("inf")
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # counters (stats/observability)
        self.ticks = 0
        self.ups = 0
        self.downs = 0
        self.join_failures = 0

    # -- control law -----------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One observe/decide/actuate round. Returns ``"up"``/``"down"``
        when an action fired, else None. ``now`` is injectable for
        deterministic hysteresis tests."""
        t = time.monotonic() if now is None else float(now)
        self.ticks += 1
        if getattr(self.router, "draining", False) or \
                getattr(self.router, "finished", False):
            return None       # shutdown in progress: the drain owns the fleet
        active = self.router.num_active_replicas()
        if active == 0:
            return None       # fleet collapsed: restarts, not scaling
        load = self.router.open_requests / active
        slo_breached = False
        if self.slo_ttft_s is not None:
            p95 = self.router.ttft_quantile(95.0)
            slo_breached = p95 is not None and p95 > self.slo_ttft_s
        in_cooldown = (t - self._last_action_t) < self.cooldown_s

        if load > self.up_load or slo_breached:
            self._low_since = None
            if active >= self.max_replicas or in_cooldown:
                return None
            if self._scale_up():
                self._last_action_t = t
                return "up"
            return None

        if load < self.down_load and active > self.min_replicas:
            if self._low_since is None:
                self._low_since = t
            if (t - self._low_since) < self.hysteresis_s or in_cooldown:
                return None
            if self._scale_down():
                self._low_since = None
                self._last_action_t = t
                return "down"
            return None

        self._low_since = None     # inside the dead band: reset the timer
        return None

    def _scale_up(self) -> bool:
        """Join one replica, retrying injected join failures at most
        ``join_retries`` extra times — bounded, like every retry loop
        here; an exhausted tick defers to a later one."""
        attempts = 0
        while attempts <= self.join_retries:
            attempts += 1
            try:
                self.router.add_replica(self.replica_factory)
            except ConnectionError:   # NetDrop from scale.join_fail
                self.join_failures += 1
                continue
            self.ups += 1
            return True
        return False

    def _scale_down(self) -> bool:
        """Retire the active replica with the fewest live streams (the
        cheapest zero-loss migration); the router guards the last
        replica standing."""
        loads = self.router.replica_load()
        if not loads:
            return False
        victim = min(loads, key=lambda i: (loads[i], i))
        if self.router.retire_replica(victim):
            self.downs += 1
            return True
        return False

    # -- the control thread (started routers) ---------------------------------

    def start(self) -> "Autoscaler":
        """Tick on a daemon thread every ``interval_s`` until stop()."""
        if self._thread is not None:
            raise RuntimeError("autoscaler already started")
        self._stop.clear()

        def _loop() -> None:
            while not self._stop.wait(self.interval_s):
                try:
                    self.tick()
                except Exception:  # noqa: BLE001 — the control loop must
                    pass           # outlive any one bad observation

        self._thread = threading.Thread(
            target=_loop, name="tnn-autoscaler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5.0)

    # -- observability ---------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        return {
            "ticks": self.ticks,
            "scale_ups": self.ups,
            "scale_downs": self.downs,
            "join_failures": self.join_failures,
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "active_replicas": self.router.num_active_replicas(),
        }
