"""A drag step's model FLOPs (the forward and the input gradient of the
tapped blocks, not the recompute) over the stretch at the bf16 peak."""

from port_bench.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "edit")
