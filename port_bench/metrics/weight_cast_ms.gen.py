"""Device ms per DDIM step of the program's ``weight_cast`` spans: each
layer's weight and bias cast to the activation dtype, once per call."""

from port_bench.spans import ms_per_step


def read(ctx):
    return ms_per_step(ctx, "generate", ("weight_cast",))
