"""Device ms per drag step outside the forward's span: the losses, the
remat recompute, the backward through the tapped blocks and the guided
update."""

from port_bench.readers import outside_ms


def read(ctx):
    return outside_ms(ctx, "edit", "unet")
