"""Share (%) of the window's model steps that carried prompt work (the
engine's mixed or prefill programs) among all its model steps, from
``engine.program_steps`` at the window's start and at the counters' end
(where a traced run's profiler starts)."""


def read(run):
    a, b = run.data.get("steps_before"), run.data.get("steps_after")
    if a is None or b is None:
        return None
    delta = {k: b.get(k, 0) - a.get(k, 0) for k in b}
    total = sum(delta.values())
    mixed = sum(v for k, v in delta.items()
                if k.startswith("mixed") or k == "prefill")
    return None if total <= 0 else 100.0 * mixed / total
