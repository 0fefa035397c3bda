"""Weights of a configuration made from the seed, on the device, in fp32
(the dtype the port holds them in), under the reference's state-dict names.

One draw of uniforms for all parameters, then each tensor's range: weights
U(+-sqrt(3 / fan_in)), biases U(+-1 / sqrt(fan_in)), GroupNorm scales
U(0.9, 1.1) and shifts U(+-0.1). Unlike the ADM init, no layer is zeroed
(each ResBlock's last conv, the attention projections and the output conv
are drawn like the rest), so every parameter carries signal and the
outputs a check compares are not identically zero.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from port_bench.reference.unet import Arch, param_shapes


def make_weights(arch: Arch, seed: int, device) -> Dict[str, torch.Tensor]:
    shapes = param_shapes(arch)
    sizes = [int(np.prod(s)) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device)
    out, fan_in = {}, {}
    for (name, shape), t in zip(shapes.items(), flat.split(sizes)):
        base = name.rsplit(".", 1)[0]
        if len(shape) > 1:
            fan_in[base] = int(np.prod(shape[1:]))
            lo, hi = -math.sqrt(3.0 / fan_in[base]), math.sqrt(3.0 / fan_in[base])
        elif base in fan_in:  # a bias after its weight
            lo, hi = -1.0 / math.sqrt(fan_in[base]), 1.0 / math.sqrt(fan_in[base])
        elif name.endswith(".weight"):  # GroupNorm scale
            lo, hi = 0.9, 1.1
        else:  # GroupNorm shift
            lo, hi = -0.1, 0.1
        out[name] = t.mul_(hi - lo).add_(lo).view(shape)
    return out
