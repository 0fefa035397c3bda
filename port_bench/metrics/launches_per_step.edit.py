"""Host calls that put work on the device (kernel launches, copies, sets;
one per profiler correlation id, so a graph launch counts once) per drag
step: the step is paced by the host, which takes longer with each."""

from port_bench.readers import launches_per_step


def read(ctx):
    return launches_per_step(ctx, "edit")
