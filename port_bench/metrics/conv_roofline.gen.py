"""The forwards' convolutions, all dtypes: their summed least time
(``conv_calls.py``) over the device ms of the program's ``conv`` and
``conv_fp32`` spans, in %."""

from port_bench.spans import conv_roofline_pct


def read(ctx):
    return conv_roofline_pct(ctx, "generate")
