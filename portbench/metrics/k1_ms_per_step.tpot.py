"""K1's device time a model step (ms): the paged-attention kernel's time
in the traced sub-window over the model steps the engine ran in it."""
from portbench.yardstick import kernel_base


def read(run):
    steps = run.data.get("trace_steps")
    if run.trace is None or not steps:
        return None
    sec, n = run.trace.seconds_of(
        lambda label: kernel_base(label) == "paged_attention_kernel")
    return None if n == 0 else sec / steps * 1e3
