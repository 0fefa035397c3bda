"""GroupNorm-SiLU calls of a drag step (forward, and backward of the tapped
blocks): their summed least time over the profiled time of the
GroupNorm-SiLU kernels (the recompute's launches included), in %."""

from port_bench.readers import GN_KERNELS, roofline_pct


def read(ctx):
    return roofline_pct(ctx, "edit", ("gn_silu", "gn_silu_bwd"), GN_KERNELS)
