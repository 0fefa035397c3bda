"""Share of the profiled stretch in which no device activity ran."""

from port_bench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx, "edit")
