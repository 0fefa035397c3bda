"""Device ms per DDIM step of the program's elementwise spans around the
products: ``bias_add``, ``residual``, ``concat`` and ``embed`` (the time
embedding, less the dense layers' own spans inside)."""

from port_bench.spans import ms_per_step

SPANS = ("bias_add", "residual", "concat", "embed")


def read(ctx):
    return ms_per_step(ctx, "generate", SPANS)
