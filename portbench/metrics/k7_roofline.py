"""K7's share (%) of its roofline: the least time for one fused causal
flash backward at the step's shape, over K7's device time a call in the
traced steps (its own kernels: the delta pre-pass and the fused body;
the zero fill and the dQ cast are generic copies the trace cannot tie
to the call, left out)."""
from portbench.metrics_common import flash_roofline


def read(run):
    return flash_roofline(
        run, 1, lambda b: b in ("flash_bwd_wgmma_kernel", "flash_bwd_kernel",
                                "flash_delta_kernel"),
        lambda b: b in ("flash_bwd_wgmma_kernel", "flash_bwd_kernel"))
