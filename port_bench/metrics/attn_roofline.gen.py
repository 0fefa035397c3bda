"""Attention calls of the forwards: their summed least time over the
profiled time of the attention kernels, in %."""

from port_bench.readers import ATTN_KERNELS, roofline_pct


def read(ctx):
    return roofline_pct(ctx, "generate", ("attn",), ATTN_KERNELS)
