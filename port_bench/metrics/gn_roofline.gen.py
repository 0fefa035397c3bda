"""GroupNorm-SiLU calls of the forwards: their summed least time over the
profiled time of the GroupNorm-SiLU kernels, in %."""

from port_bench.readers import GN_KERNELS, roofline_pct


def read(ctx):
    return roofline_pct(ctx, "generate", ("gn_silu",), GN_KERNELS)
