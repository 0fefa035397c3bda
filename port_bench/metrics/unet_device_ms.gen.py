"""Device ms per DDIM step of the kernels the host launched inside the
benchmark's ``unet`` span (one UNet forward at the cell's batch)."""

from port_bench.readers import span_ms


def read(ctx):
    return span_ms(ctx, "generate", "unet")
