"""The UNet forwards' model FLOPs over the stretch at the bf16 peak."""

from port_bench.readers import mfu_pct


def read(ctx):
    return mfu_pct(ctx, "generate")
