"""Attention calls of a drag step (forward, and backward of the tapped
blocks): their summed least time over the profiled time of the attention
kernels (the recompute's launches included), in %."""

from port_bench.readers import ATTN_KERNELS, roofline_pct


def read(ctx):
    return roofline_pct(ctx, "edit", ("attn", "attn_bwd"), ATTN_KERNELS)
