"""K4's share (%) of its roofline: the least time the card could take
for one causal flash forward at the step's shape (``yardstick.
flash_work``), over K4's device time a call in the traced steps (its
kernels: every ``flash_fwd*`` body)."""
from portbench.metrics_common import flash_roofline


def read(run):
    return flash_roofline(
        run, 0, lambda b: b.startswith("flash_fwd"),
        lambda b: b.startswith("flash_fwd"))
