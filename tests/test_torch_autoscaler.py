"""Port parity: ``serving/autoscaler.py`` (``Autoscaler``) against the JAX
package's, on a stub router with a hand-advanced clock (the control law
alone), and on a real port fleet.

- One scripted load sequence (open requests, TTFT p95, join failures,
  draining, a collapsed fleet) drives a JAX and a port autoscaler over
  twin stub routers: every tick's decision, the fleet size after it, the
  retire victims and the final ``stats()`` are equal.
- The constructor refusals carry JAX's texts.
- The control thread starts once, ticks, and stops idempotently.
- On a port fleet (tiny FP32 engines, ``pump``-driven): a burst scales
  1 -> up, the quiet after it scales back down, and every request reaches
  exactly one ``done`` with the tokens one engine gives (zero-loss
  scale-down through migration); the retired replica's pages are released.
"""
import time

import numpy as np
import pytest

from tnn_tpu.serving import Autoscaler as JAutoscaler
from tnn_tpu_torch.core import dtypes as tdt
from tnn_tpu_torch.models.gpt2 import GPT2
from tnn_tpu_torch.serving import (Autoscaler, EngineSupervisor,
                                   InferenceEngine, Router)

TINY = dict(vocab_size=128, max_len=64, num_layers=2, d_model=32,
            num_heads=2)
KW = dict(num_blocks=32, block_size=4, max_batch_size=4, max_seq_len=32)


class StubRouter:
    """Duck-typed router: load and TTFT are set directly, actions mutate
    counters (JAX's ``tests/test_serving.py::_StubRouter``)."""

    def __init__(self, active=1, open_requests=0):
        self.active = active
        self.open_requests = open_requests
        self.draining = False
        self.finished = False
        self.p95 = None
        self.adds = 0
        self.retires = []
        self.fail_joins = 0

    def num_active_replicas(self):
        return self.active

    def ttft_quantile(self, q):
        return self.p95

    def add_replica(self, factory):
        if self.fail_joins > 0:
            self.fail_joins -= 1
            raise ConnectionError("injected join failure")
        factory()
        self.active += 1
        self.adds += 1
        return self.active - 1

    def retire_replica(self, idx, reason="scale-down"):
        if self.active <= 1:
            return False
        self.active -= 1
        self.retires.append(idx)
        return True

    def replica_load(self):
        return {i: (i * 7) % 3 for i in range(self.active)}


# (time, open requests, p95, fail_joins, draining, active override)
SCRIPT = [
    (0.0, 10, None, 0, False, None), (0.5, 20, None, 0, False, None),
    (2.1, 20, None, 0, False, None), (2.2, 40, None, 5, False, None),
    (4.5, 40, None, 0, False, None), (6.6, 2, 0.5, 0, False, None),
    (9.0, 2, 0.1, 0, False, None), (9.1, 0, None, 0, False, None),
    (9.5, 6, None, 0, False, None), (10.2, 0, None, 0, False, None),
    (11.3, 0, None, 0, False, None), (12.4, 0, None, 0, False, None),
    (13.0, 0, None, 0, False, None), (15.0, 0, None, 0, False, None),
    (17.0, 100, None, 0, True, None), (18.0, 5, None, 0, False, 0),
    (19.0, 0, None, 0, False, 3), (20.5, 0, None, 0, False, None),
    (22.6, 0, None, 0, False, None),
]


def _run(cls):
    r = StubRouter(active=1)
    s = cls(r, lambda: object(), min_replicas=1, max_replicas=4,
            up_load=4.0, down_load=1.0, hysteresis_s=1.0, cooldown_s=2.0,
            join_retries=2, slo_ttft_s=0.25)
    log = []
    for now, load, p95, fails, draining, active in SCRIPT:
        r.open_requests, r.p95, r.fail_joins = load, p95, fails
        r.draining = draining
        if active is not None:
            r.active = active
        log.append((now, s.tick(now=now), r.active, r.adds,
                    list(r.retires)))
    return log, s.stats()


def test_decisions_match_jax_over_a_script():
    jlog, jstats = _run(JAutoscaler)
    tlog, tstats = _run(Autoscaler)
    assert tlog == jlog
    assert tstats == jstats
    assert any(d == "up" for _, d, *_ in tlog)
    assert any(d == "down" for _, d, *_ in tlog)


@pytest.mark.parametrize("kw", [
    dict(min_replicas=0), dict(min_replicas=3, max_replicas=2),
    dict(up_load=1.0, down_load=1.0), dict(slo_ttft_s=0.0),
    dict(join_retries=-1), dict(interval_s=0.0)])
def test_refusals_match_jax(kw):
    base = dict(min_replicas=1, max_replicas=4, up_load=4.0, down_load=1.0)
    base.update(kw)
    with pytest.raises(ValueError) as je:
        JAutoscaler(StubRouter(), lambda: object(), **base)
    with pytest.raises(ValueError) as te:
        Autoscaler(StubRouter(), lambda: object(), **base)
    assert str(te.value) == str(je.value)


def test_control_thread_start_stop():
    s = Autoscaler(StubRouter(), lambda: object(), interval_s=0.01)
    assert s.start() is s
    with pytest.raises(RuntimeError, match="already started"):
        s.start()
    deadline = time.monotonic() + 5.0
    while s.ticks == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    s.stop()
    assert s.ticks > 0
    s.stop()


def test_fleet_burst_scales_up_and_down_zero_loss():
    tm = GPT2(**TINY, policy=tdt.FP32, device="cpu", seed=0)

    def make():
        return EngineSupervisor(InferenceEngine(tm, device="cpu", **KW),
                                restart_backoff_s=0.0)

    events = []
    router = Router([make()], event_sink=events.append, seed=0)
    scaler = Autoscaler(router, make, min_replicas=1, max_replicas=3,
                        up_load=2.0, down_load=0.5, hysteresis_s=0.2,
                        cooldown_s=0.05)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 128, 5 + i % 4).astype(np.int32)
               for i in range(8)]
    clock, gids, sizes = 0.0, [], []
    for p in prompts:
        gids.append(router.submit(p, 6))
        router.pump(1)
        clock += 0.05
        scaler.tick(now=clock)
        sizes.append(router.num_active_replicas())
    for _ in range(400):
        router.pump(1)
        clock += 0.05
        scaler.tick(now=clock)
        sizes.append(router.num_active_replicas())
        if not router.open_requests and router.num_active_replicas() == 1:
            break
    st = scaler.stats()
    assert st["scale_ups"] >= 1 and st["scale_downs"] >= 1, sizes
    assert max(sizes) > 1 and sizes[-1] == 1
    ref = InferenceEngine(tm, device="cpu", **KW)
    rids = [ref.submit(p, 6) for p in prompts]
    want = ref.run_until_complete()
    term = {}
    for e in events:
        if e["event"] != "token":
            assert e["id"] not in term, "two terminal events"
            term[e["id"]] = e
    assert [term[g]["event"] for g in gids] == ["done"] * len(gids)
    assert [term[g]["tokens"] for g in gids] == [want[r] for r in rids]
    router.pump(2)         # the retired replicas finish their drains
    for h in router.replicas:
        if h.retired:
            assert h.released and h.sup.engine.pool.pages_k.numel() == 0
        else:
            assert h.sup.engine.pool.num_allocated == 0
