"""The system under test: the port's entry points that the kinds
(``kinds/<kind>.py``) share, as the CLIs drive them. A kind imports what
else of the program it drives inside its own methods; nothing of the
benchmark imports the JAX package.
"""

from __future__ import annotations

import dataclasses

import torch

from ishapediting_tpu_torch.config import DiffusionConfig, PipelineConfig, UNetConfig
from ishapediting_tpu_torch.core.schedule import make_schedule
from ishapediting_tpu_torch.edit.batch import build_batched_problems, drag_edit_batched, invert_batched
from ishapediting_tpu_torch.edit.engine import DragEngine
from ishapediting_tpu_torch.models.unet import UNetModel
from ishapediting_tpu_torch.parallel.sampling import sample_batches

__all__ = ["engine", "schedule", "sample_batches", "invert_batched", "drag_edit_batched",
           "build_batched_problems", "DragEngine"]


def pipeline_config(cfg: dict, respacing: str) -> PipelineConfig:
    """The port's config from a configuration file (guided-diffusion's
    flags, read as ``UNetConfig.from_reference_args`` reads them), with
    the port's default edit settings."""
    unet = UNetConfig.from_reference_args(
        image_size=cfg["image_size"], num_channels=cfg["num_channels"],
        num_res_blocks=cfg["num_res_blocks"],
        channel_mult=",".join(str(m) for m in cfg["channel_mult"]),
        attention_resolutions=cfg["attention_resolutions"], learn_sigma=cfg["learn_sigma"],
        in_out_channels=cfg["in_channels"], num_heads=cfg["num_heads"],
        num_head_channels=cfg["num_head_channels"], num_heads_upsample=cfg["num_heads_upsample"],
        use_scale_shift_norm=cfg["use_scale_shift_norm"], resblock_updown=cfg["resblock_updown"],
        dropout=cfg["dropout"],
    )
    unet = dataclasses.replace(unet, compute_dtype=cfg["compute_dtype"])
    diffusion = DiffusionConfig(
        base_steps=cfg["diffusion_steps"], noise_schedule=cfg["noise_schedule"],
        timestep_respacing=respacing, learn_sigma=cfg["learn_sigma"],
        predict_xstart=cfg["predict_xstart"], rescale_timesteps=cfg["rescale_timesteps"],
        clip_denoised=cfg["clip_denoised"],
    )
    return PipelineConfig(unet=unet, diffusion=diffusion,
                          plane_channels=cfg["plane_channels"], num_planes=cfg["num_planes"])


def engine(config: PipelineConfig, weights: dict, device) -> DragEngine:
    """A ``DragEngine`` over a UNet that holds ``weights`` (the benchmark's
    tensors, assigned, not copied)."""
    with torch.device("meta"):
        unet = UNetModel(config.unet)
    unet.load_state_dict(weights, assign=True)
    return DragEngine(config, unet=unet, device=device)


def schedule(config: PipelineConfig, respacing: str, device):
    d = config.diffusion
    return make_schedule(d.base_steps, d.noise_schedule, respacing,
                         rescale_timesteps=d.rescale_timesteps).to(device)
