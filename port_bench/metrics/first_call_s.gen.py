"""Seconds of set-up in the program's ``first_call`` counter (the first UNet
forward of each signature, cuDNN's algorithm search in it), less the
``kernel_build`` inside it (building or loading the Hopper kernels)."""

from port_bench.spans import first_call_s


def read(ctx):
    return first_call_s(ctx, "generate")
