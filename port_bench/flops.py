"""The work of the UNet's calls, counted from a configuration and a batch,
whatever kernel computes them: every convolution, dense layer and attention
product (FLOPs, 2 per multiply-add, as ``torch.utils.flop_counter`` counts
them), and every GroupNorm-SiLU and attention call with the bytes it must
move (each input read once, each output written once) and its least time on
the card (``peaks.py``).

A drag step (``edit_step``) is the forward at batch N plus the input
gradient of every block the loss reaches through the feature tap (the input
and middle blocks and output blocks 0..feat_layer): each reached product's
input gradient is one product of the same size, an attention backward four
products (dV, dP, dQ, dK), a GroupNorm-SiLU backward reads x and dy and
writes dx. A recompute is not counted, nor weight gradients (the weights
are frozen).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from port_bench.peaks import bound_s
from port_bench.reference.unet import Arch, Layer, Layout, layout

BF16, FP32 = 2, 4


@dataclasses.dataclass
class Call:
    """One kernel-sized call of a forward or backward."""

    op: str  # 'gn_silu' | 'attn' | 'gn_silu_bwd' | 'attn_bwd'
    name: str
    nbytes: float
    tensor_flops: float = 0.0

    @property
    def bound_s(self) -> float:
        return bound_s(self.nbytes, self.tensor_flops)


def _res_products(a: Arch, l: Layer, emb_ch: int) -> Dict[str, float]:
    """FLOPs per sample of a ResBlock's products: the convs (3x3 in and out,
    1x1 skip) at their spatial sizes and the embedding's dense layer."""
    s_out = l.size * 2 if l.updown == "up" else (l.size // 2 if l.updown == "down" else l.size)
    hw = s_out * s_out
    e = 2 * l.cout if a.use_scale_shift_norm else l.cout
    out = {
        "in_conv": 2.0 * hw * l.cout * l.cin * 9,
        "out_conv": 2.0 * hw * l.cout * l.cout * 9,
        "emb": 2.0 * emb_ch * e,
    }
    if l.cin != l.cout:
        out["skip"] = 2.0 * hw * l.cout * l.cin
    return out


def _attn_products(l: Layer) -> Dict[str, float]:
    t, c = l.size * l.size, l.cin
    return {"qkv": 2.0 * t * c * 3 * c, "proj": 2.0 * t * c * c, "attn": 4.0 * t * t * c}


def _layers(lay: Layout, output_blocks: int = None) -> List[Layer]:
    ls = [l for b in lay.input_blocks for l in b] + list(lay.middle)
    return ls + [l for b in lay.output_blocks[:output_blocks] for l in b]


def forward_flops(a: Arch, batch: int = 1) -> float:
    """FLOPs of one UNet forward at ``batch``."""
    lay = layout(a)
    mc, emb = a.model_channels, lay.emb_ch
    per = 2.0 * mc * emb + 2.0 * emb * emb  # time embedding
    for l in _layers(lay):
        if l.kind == "conv":
            per += 2.0 * l.size * l.size * l.cout * l.cin * 9
        elif l.kind == "res":
            per += sum(_res_products(a, l, emb).values())
        else:
            per += sum(_attn_products(l).values())
    per += 2.0 * a.image_size ** 2 * a.out_channels * lay.out_ch * 9
    return per * batch


def input_grad_flops(a: Arch, batch: int, feat_layer: int) -> float:
    """FLOPs of the input gradient of the blocks a feature-tap loss reaches."""
    lay = layout(a)
    per = 0.0
    for l in _layers(lay, feat_layer + 1):
        if l.kind == "conv":
            per += 2.0 * l.size * l.size * l.cout * l.cin * 9
        elif l.kind == "res":
            p = _res_products(a, l, lay.emb_ch)
            per += p["in_conv"] + p["out_conv"] + p.get("skip", 0.0)
        else:
            p = _attn_products(l)
            per += p["qkv"] + p["proj"] + 2.0 * p["attn"]
    return per * batch


def edit_step_flops(a: Arch, batch: int, feat_layer: int) -> float:
    return forward_flops(a, batch) + input_grad_flops(a, batch, feat_layer)


def _gn_calls(a: Arch, batch: int, layers: List[Layer], lay: Layout, head: bool, bwd: bool) -> List[Call]:
    """GroupNorm-SiLU calls: two per ResBlock (in: [N, s, s, cin] before
    any resample; out: [N, s', s', cout] with FiLM), bf16, and the output
    head's in fp32."""
    calls = []
    for l in layers:
        if l.kind != "res":
            continue
        s2 = l.size * 2 if l.updown == "up" else (l.size // 2 if l.updown == "down" else l.size)
        shapes = [(f"{l.name}.in", l.size * l.size * l.cin, l.cin, False),
                  (f"{l.name}.out", s2 * s2 * l.cout, l.cout, a.use_scale_shift_norm)]
        for name, n_el, c, film in shapes:
            act = batch * n_el * BF16
            params = 2 * c * FP32 + (2 * batch * c * BF16 if film else 0)
            if bwd:
                calls.append(Call("gn_silu_bwd", name, 3 * act + params))
            else:
                calls.append(Call("gn_silu", name, 2 * act + params))
    if head:
        n_el = a.image_size ** 2 * lay.out_ch
        calls.append(Call("gn_silu", "out.0", 2 * batch * n_el * FP32 + 2 * lay.out_ch * FP32))
    return calls


def _attn_calls(layers: List[Layer], batch: int, bwd: bool) -> List[Call]:
    calls = []
    for l in layers:
        if l.kind != "attn":
            continue
        t, c = l.size * l.size, l.cin
        if bwd:  # read qkv and dO, write dqkv; four products
            calls.append(Call("attn_bwd", l.name, batch * t * 7 * c * BF16, 8.0 * batch * t * t * c))
        else:  # read qkv, write the output; two products
            calls.append(Call("attn", l.name, batch * t * 4 * c * BF16, 4.0 * batch * t * t * c))
    return calls


def forward_calls(a: Arch, batch: int) -> List[Call]:
    """The GroupNorm-SiLU and attention calls of one forward."""
    lay = layout(a)
    layers = _layers(lay)
    return _gn_calls(a, batch, layers, lay, True, False) + _attn_calls(layers, batch, False)


def edit_step_calls(a: Arch, batch: int, feat_layer: int) -> List[Call]:
    """Those of a drag step: the forward, and the backward of each reached call."""
    lay = layout(a)
    reached = _layers(lay, feat_layer + 1)
    return (forward_calls(a, batch) + _gn_calls(a, batch, reached, lay, False, True)
            + _attn_calls(reached, batch, True))
