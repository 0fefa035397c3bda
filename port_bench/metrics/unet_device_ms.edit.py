"""Device ms per drag step inside the ``unet`` span: the forward at the
cell's batch with its feature tap."""

from port_bench.readers import span_ms


def read(ctx):
    return span_ms(ctx, "edit", "unet")
