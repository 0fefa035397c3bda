"""Device ms per DDIM step outside the ``unet`` span: the DDIM update,
the casts and the noise of ``sample_batches``' loop."""

from port_bench.readers import outside_ms


def read(ctx):
    return outside_ms(ctx, "generate", "unet")
