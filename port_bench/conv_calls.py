"""Every convolution of one UNet forward, counted from a configuration and a
batch, whatever implements it: the input conv, each ResBlock's two 3x3
convs (the first after any resample) and its 1x1 skip where the widths
differ, and the output head's conv. A call's bound is the larger of its
FLOPs (2·N·H·W·C_out·C_in·k², as ``flops.py`` counts them) at the bf16
tensor-core peak and its bytes (input, weight and output, each once) at the
HBM rate, at the precision ``flops.py`` uses: a bf16 torso, an fp32 head.
"""

from __future__ import annotations

from typing import List

from port_bench.flops import BF16, FP32, Call
from port_bench.reference.unet import Arch, Layer, layout


def _conv(name: str, batch: int, size: int, cin: int, cout: int, k: int, width: int, op: str = "conv") -> Call:
    hw = size * size
    nbytes = width * (batch * hw * (cin + cout) + cout * cin * k * k)
    return Call(op, name, nbytes, 2.0 * batch * hw * cout * cin * k * k)


def _res(l: Layer, batch: int) -> List[Call]:
    s = l.size * 2 if l.updown == "up" else (l.size // 2 if l.updown == "down" else l.size)
    calls = [_conv(f"{l.name}.in_layers.2", batch, s, l.cin, l.cout, 3, BF16),
             _conv(f"{l.name}.out_layers.3", batch, s, l.cout, l.cout, 3, BF16)]
    if l.cin != l.cout:
        calls.append(_conv(f"{l.name}.skip_connection", batch, s, l.cin, l.cout, 1, BF16))
    return calls


def forward_convs(a: Arch, batch: int) -> List[Call]:
    """The convolutions of one forward at ``batch``: op ``conv`` (bf16) or
    ``conv_fp32`` (the head)."""
    lay = layout(a)
    calls: List[Call] = []
    for l in [l for b in lay.input_blocks for l in b] + list(lay.middle) + [l for b in lay.output_blocks for l in b]:
        if l.kind == "conv":
            calls.append(_conv(l.name, batch, l.size, l.cin, l.cout, 3, BF16))
        elif l.kind == "res":
            calls += _res(l, batch)
    calls.append(_conv("out.2", batch, a.image_size, lay.out_ch, a.out_channels, 3, FP32, "conv_fp32"))
    return calls
