"""The plain reference against the port's plain CPU path, with the same
weights: the UNet and its feature tap, the schedules, the feature planes
and the drag losses, and whole miniature runs of each cell in fp32, where
the two must agree to rounding."""

import json
import os
import time

import numpy as np
import pytest
import torch

from port_bench import system
from port_bench.reference import diffusion as D
from port_bench.reference import drag as R
from port_bench.reference.unet import Arch, UNet, fp8_quant, param_shapes
from port_bench.run import measure
from port_bench.spec import HERE, ROOT
from port_bench.tests.mini import CELLS, MINI_ARCH, mini
from port_bench.weights import make_weights

CONFIGS = [c["name"] for c in json.load(open(os.path.join(ROOT, "BENCHMARK.json")))["configs"]]


def _config(name, **over):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg.update(over)
    return cfg


def _port_unet(cfg, weights):
    pc = system.pipeline_config(cfg, "10")
    from ishapediting_tpu_torch.models.unet import UNetModel

    with torch.device("meta"):
        unet = UNetModel(pc.unet)
    unet.load_state_dict(weights, assign=True)
    return unet.eval()


@pytest.mark.parametrize("name", CONFIGS)
def test_parameter_names_and_shapes_match_the_port(name):
    from ishapediting_tpu_torch.models.unet import UNetModel

    cfg = _config(name)
    with torch.device("meta"):
        port = UNetModel(system.pipeline_config(cfg, "10").unet)
    ref = param_shapes(Arch.from_config(cfg))
    assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == ref
    assert sum(int(np.prod(s)) for s in ref.values()) == cfg["parameters"]


@pytest.mark.parametrize("heads", ["chairs", "by_count"])
def test_unet_and_tap_match_the_port_in_fp32(heads):
    over = dict(MINI_ARCH, compute_dtype="float32")
    if heads == "by_count":
        over.update(num_heads=2, num_head_channels=-1)
    cfg = _config("nfd_chairs", **over)
    arch = Arch.from_config(cfg)
    w = make_weights(arch, 7, "cpu")
    x = torch.randn(2, 16, 16, 6, generator=torch.Generator().manual_seed(0))
    t = torch.tensor([3, 917])
    with torch.no_grad():
        out_p, feat_p = _port_unet(cfg, w)(x, t, feat_layer=1)
        out_r, feat_r = UNet(arch, w)(x.permute(0, 3, 1, 2), t, 1)
    assert out_r.abs().mean() > 0.05  # the weights carry signal
    torch.testing.assert_close(out_p.permute(0, 3, 1, 2), out_r, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(feat_p.permute(0, 3, 1, 2), feat_r, rtol=1e-4, atol=1e-4)


def test_fp8_control_departs_from_fp32():
    cfg = _config("nfd_chairs", **MINI_ARCH)
    arch = Arch.from_config(cfg)
    w = make_weights(arch, 3, "cpu")
    x = torch.randn(1, 6, 16, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, _ = UNet(arch, w)(x, torch.tensor([500]))
        b, _ = UNet(arch, w, fp8_quant)(x, torch.tensor([500]))
    rel = float((a - b).norm() / a.norm())
    assert 1e-3 < rel < 0.5


@pytest.mark.parametrize("respacing", ["ddim50", "200", "10"])
def test_schedules_match_the_port(respacing):
    from ishapediting_tpu_torch.core.schedule import make_schedule

    port = make_schedule(1000, "linear", respacing)
    ref = D.respaced(1000, respacing, "cpu")
    assert torch.equal(port.timestep_map, ref.tmap)
    for a, b in [(port.alphas_cumprod, ref.acp), (port.posterior_mean_coef1, ref.coef1),
                 (port.posterior_mean_coef2, ref.coef2), (port.log_betas, ref.log_betas),
                 (port.posterior_log_variance_clipped, ref.post_log_var)]:
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_fast_edit_schedule_matches_the_port():
    from ishapediting_tpu_torch.core.schedule import fast_edit_schedule, make_schedule, named_beta_schedule

    port, pos = fast_edit_schedule(make_schedule(1000, "linear", "200"), named_beta_schedule("linear", 1000),
                                   170, 20)
    ref, rpos = D.fast_edit(D.respaced(1000, "200", "cpu"), 1000, 170, 20, "cpu")
    assert np.array_equal(pos, rpos)
    assert torch.equal(port.timestep_map, ref.tmap)
    torch.testing.assert_close(port.alphas_cumprod, ref.acp, rtol=0, atol=0)


def test_feature_planes_and_drag_losses_match_the_port():
    from ishapediting_tpu_torch.edit.drag import build_drag_problem, drag_losses
    from ishapediting_tpu_torch.edit.features import regroup_features

    g = torch.Generator().manual_seed(2)
    feat = torch.randn(2, 64, 64, 512, generator=g)  # the chairs tap at output block 8
    port = regroup_features(feat)  # [N, 3, s, s, C]
    ref = R.plane_features(feat.permute(0, 3, 1, 2))  # [N, 3, C, s, s]
    torch.testing.assert_close(port, ref.permute(0, 1, 3, 4, 2), rtol=0, atol=0)
    src, tgt = np.array([[0.3, -0.5, 0.7]]), np.array([[0.42, -0.45, 0.66]])
    prob = build_drag_problem(src, tgt, r1=12, voxel_size=2 / 256, feat_width=64)
    h = R.Handles(src, tgt, 12, 2 / 256, 64, "cpu")
    assert h.count == prob.mask_count
    m_p, k_p = drag_losses(port[0], port[1], prob)
    m_r, k_r = R.losses(ref[0], ref[1], h)
    torch.testing.assert_close(m_p, m_r, rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(k_p, k_r, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("cell", CELLS)
def test_whole_mini_run_agrees_with_the_reference_in_fp32(cell):
    """Every step of the cell's timed path and set-up, worked out again by
    the reference from the seed, to rounding when both run in fp32."""
    line = measure(mini(cell, {"rel_err": 1e-4, "guide_err": 1e-4}, dtype="float32"), 2 ** 31 + 12345,
                   0.2, False, device="cpu", t0=time.time())
    assert line["correct"], line["check"]
    assert all(c["value"] < 1e-4 for c in line["check"].values())
