"""Model FLOPs utilisation of a train step (%): a step's model FLOPs
(``yardstick.model_flops_per_step``) over the window's step time and
the card's peak for the compute dtype."""
from portbench.yardstick import PEAK_OPS, model_flops_per_step


def read(run):
    steps = run.data.get("steps")
    if not steps:
        return None
    cfg = run.config
    flops = model_flops_per_step(cfg["n_layer"], cfg["n_embd"],
                                 cfg["vocab_size"], run.data["batch"],
                                 run.data["seq"])
    step_s = run.data["window_s"] / steps
    return 100.0 * flops / step_s / PEAK_OPS[cfg["precision"]["compute"]]
