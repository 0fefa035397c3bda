"""The benchmark's own count of the UNet's work: 0.635 TFLOP per sample at
NFD's widths, 0.614 for ImageNet-128 ADM (the same torso, 3 channels in
and 6 out), and exactly what
``torch.utils.flop_counter`` counts on the port's tiny UNet, forward and a
drag step's input gradient."""

import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import flops
from port_bench.reference.unet import Arch, layout
from port_bench.spec import HERE


def _arch(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return Arch.from_config(json.load(f))


@pytest.mark.parametrize("name,tflop", [("nfd_chairs", 0.635), ("adm_imagenet128", 0.614)])
def test_published_widths_count_tflop_per_sample(name, tflop):
    a = _arch(name)
    assert round(flops.forward_flops(a) / 1e12, 3) == tflop
    assert flops.forward_flops(a, 32) == 32 * flops.forward_flops(a)


def _tiny(by_count: bool):
    from ishapediting_tpu_torch.config import preset
    from ishapediting_tpu_torch.models.unet import UNetModel

    cfg = preset("tiny").unet
    if by_count:
        import dataclasses

        cfg = dataclasses.replace(cfg, num_heads=2, num_head_channels=-1)
    arch = Arch(image_size=cfg.image_size, in_channels=cfg.in_channels, model_channels=cfg.model_channels,
                out_channels=cfg.out_channels, num_res_blocks=cfg.num_res_blocks,
                attention_resolutions=tuple(cfg.image_size // d for d in cfg.attention_ds),
                channel_mult=cfg.channel_mult, num_heads=cfg.num_heads,
                num_head_channels=cfg.num_head_channels, num_heads_upsample=cfg.num_heads_upsample,
                use_scale_shift_norm=cfg.use_scale_shift_norm, resblock_updown=cfg.resblock_updown)
    return UNetModel(cfg).eval().requires_grad_(False), arch


@pytest.mark.parametrize("by_count", [False, True])
def test_forward_count_equals_flop_counter_on_the_tiny_unet(by_count):
    unet, arch = _tiny(by_count)
    x = torch.randn(3, 16, 16, 6)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        unet(x, torch.tensor([1, 2, 3]))
    assert fc.get_total_flops() == flops.forward_flops(arch, 3)


@pytest.mark.parametrize("feat_layer", [0, 1])
def test_drag_step_count_equals_flop_counter_on_the_tiny_unet(feat_layer):
    """Forward, then the input gradient of a loss on the tapped feature
    (frozen weights). The port's attention Function recomputes its two
    products in its backward (as a flash backward does); the benchmark's
    count leaves a recompute out, so it is added here."""
    unet, arch = _tiny(False)
    x = torch.randn(2, 16, 16, 6, requires_grad=True)
    with FlopCounterMode(display=False) as fc:
        _, feat = unet(x, torch.tensor([5, 9]), feat_layer=feat_layer)
        feat.square().sum().backward()
    lay = layout(arch)
    reached = flops._layers(lay, feat_layer + 1)
    recompute = sum(2 * flops._attn_products(l)["attn"] for l in reached if l.kind == "attn")
    assert fc.get_total_flops() == flops.edit_step_flops(arch, 2, feat_layer) + recompute


def test_calls_and_bounds_of_the_chairs_cells():
    a = _arch("nfd_chairs")
    fwd = flops.forward_calls(a, 32)
    assert sum(c.op == "gn_silu" for c in fwd) == 71 and sum(c.op == "attn" for c in fwd) == 16
    step = flops.edit_step_calls(a, 16, 8)
    # the blocks a drag step's loss reaches: as many as the port's remat recomputes
    from ishapediting_tpu_torch.config import preset
    from ishapediting_tpu_torch.models.unet import kernel_calls_recomputed

    gn, attn = kernel_calls_recomputed(preset("chairs").unet, 8)
    assert (gn, attn) == (56, 16)
    assert sum(c.op == "gn_silu_bwd" for c in step) == gn and sum(c.op == "attn_bwd" for c in step) == attn
    # bytes-bound: a bf16 [32, 128, 128, 256] GroupNorm-SiLU reads and writes 268 MB
    first = fwd[0]
    assert first.nbytes == 2 * 32 * 128 * 128 * 256 * 2 + 2 * 256 * 4
    assert first.bound_s == pytest.approx(first.nbytes / 3.35e12)
