"""Typed configuration: frozen dataclasses and per-category presets.

The same vocabulary and presets as the JAX package's ``config.py``; the only
difference is that the compute dtype is exposed as a ``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """ADM UNet architecture (reference: unet.py:396-671, script_util.py:132-187).

    Defaults are the published NFD triplane model: 128^2 latent "image",
    96 in/out channels (3 planes x 32), learned sigma doubling the output.
    """

    image_size: int = 128
    in_channels: int = 96
    model_channels: int = 256
    out_channels: int = 192  # in_channels * 2 when learn_sigma
    num_res_blocks: int = 2
    attention_ds: Tuple[int, ...] = (4, 8, 16)  # downsample factors with attention
    # per-level width multipliers; may be fractional (512^2 table uses 0.5)
    channel_mult: Tuple[float, ...] = (1, 1, 2, 3, 4)
    num_heads: int = 4
    num_head_channels: int = 64
    num_heads_upsample: int = -1
    use_scale_shift_norm: bool = True
    resblock_updown: bool = True
    conv_resample: bool = True
    dropout: float = 0.1
    num_classes: Optional[int] = None
    # bf16 torso, fp32 GroupNorm statistics, time embedding and output head
    compute_dtype: str = "bfloat16"

    @property
    def torch_compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @staticmethod
    def from_reference_args(
        image_size: int = 128,
        num_channels: int = 256,
        num_res_blocks: int = 2,
        channel_mult: str = "",
        attention_resolutions: str = "32,16,8",
        learn_sigma: bool = True,
        in_out_channels: int = 96,
        num_heads: int = 4,
        num_head_channels: int = 64,
        num_heads_upsample: int = -1,
        use_scale_shift_norm: bool = True,
        resblock_updown: bool = True,
        dropout: float = 0.1,
        **_unused,
    ) -> "UNetConfig":
        """Build from the reference's flag vocabulary (script_util.py:132-187)."""
        if channel_mult == "":
            table = {
                512: (0.5, 1, 1, 2, 2, 4, 4),
                256: (1, 1, 2, 2, 4, 4),
                128: (1, 1, 2, 3, 4),
                64: (1, 2, 3, 4),
            }
            mult = table[image_size]
        else:
            mult = tuple(
                int(f) if float(f).is_integer() else float(f)
                for f in (float(m) for m in channel_mult.split(","))
            )
        att_ds = tuple(
            image_size // int(res) for res in attention_resolutions.split(",")
        )
        return UNetConfig(
            image_size=image_size,
            in_channels=in_out_channels,
            model_channels=num_channels,
            out_channels=in_out_channels * 2 if learn_sigma else in_out_channels,
            num_res_blocks=num_res_blocks,
            attention_ds=tuple(sorted(att_ds)),
            channel_mult=tuple(mult),
            num_heads=num_heads,
            num_head_channels=num_head_channels,
            num_heads_upsample=num_heads_upsample,
            use_scale_shift_norm=use_scale_shift_norm,
            resblock_updown=resblock_updown,
            dropout=dropout,
        )


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    """Noise schedule + respacing (reference: gaussian_diffusion.py:18-62,
    respace.py:6-59, script_util.py:389-427)."""

    base_steps: int = 1000
    noise_schedule: str = "linear"
    # respacing: "" (all steps), "N" (evenly strided to N), "ddimN" or "dpmN"
    timestep_respacing: str = "200"
    learn_sigma: bool = True  # LEARNED_RANGE variance
    predict_xstart: bool = False  # False => model predicts epsilon
    rescale_timesteps: bool = False
    clip_denoised: bool = True


@dataclasses.dataclass(frozen=True)
class EditConfig:
    """Drag-edit hyperparameters (reference: drag_utils.py:23-58,197-199,302)."""

    w_time: int = 170  # guidance starts at this respaced step
    feat_layer: int = 8  # UNet output-block feature tap (valid 7-9)
    grad_scale: float = 600.0
    mask_weight: float = 0.2
    r1: int = 12  # cubic neighborhood radius, in shape-grid voxels
    shape_resolution: int = 256
    loss_type: str = "l2"  # "l1" | "l2"
    # storage dtype of the per-step guidance feature cache [w_time,3,s,s,C']
    feat_store_dtype: str = "bfloat16"  # "float32" | "bfloat16"
    inversion_chunk: int = 8
    edit_steps: Optional[int] = None

    @property
    def voxel_size(self) -> float:
        return 2.0 / self.shape_resolution


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Real-shape triplane fitting (reference: drag_utils.py:36-39,401-471)."""

    points_size: int = 200_000
    points_uniform_ratio: float = 0.5
    surface_jitter: float = 0.01
    batch_points: int = 40_000
    grad_scale: float = 600.0
    fit_steps: Optional[int] = None
    opt_epochs: int = 20
    opt_lr: float = 1e-3
    opt_smooth_weight: float = 0.3
    opt_l2_weight: float = 0.001
    opt_tv_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Everything needed to run generation / editing for one category."""

    unet: UNetConfig = dataclasses.field(default_factory=UNetConfig)
    diffusion: DiffusionConfig = dataclasses.field(default_factory=DiffusionConfig)
    edit: EditConfig = dataclasses.field(default_factory=EditConfig)
    fit: FitConfig = dataclasses.field(default_factory=FitConfig)
    plane_channels: int = 32
    num_planes: int = 3

    @property
    def latent_shape(self) -> Tuple[int, int, int]:
        """(H, W, C) of one latent, NHWC."""
        s = self.unet.image_size
        return (s, s, self.num_planes * self.plane_channels)

    def with_steps(self, num_steps: int) -> "PipelineConfig":
        return self._with_respacing(str(num_steps))

    def with_ddim(self, num_steps: int) -> "PipelineConfig":
        return self._with_respacing(f"ddim{num_steps}")

    def with_dpm(self, num_steps: int) -> "PipelineConfig":
        """log-SNR-uniform grid for the DPM-Solver++(2M) sampler."""
        return self._with_respacing(f"dpm{num_steps}")

    def _with_respacing(self, respacing: str) -> "PipelineConfig":
        return dataclasses.replace(
            self,
            diffusion=dataclasses.replace(
                self.diffusion, timestep_respacing=respacing
            ),
        )


def with_feat_store_dtype(config: PipelineConfig, dtype: Optional[str]) -> PipelineConfig:
    """Override ``edit.feat_store_dtype`` when ``dtype`` is given; ``None``
    keeps what the config already says."""
    if dtype is None or dtype == config.edit.feat_store_dtype:
        return config
    return dataclasses.replace(
        config, edit=dataclasses.replace(config.edit, feat_store_dtype=dtype)
    )


def preset(
    category: str = "chairs", num_steps: int = 200, use_ddim: bool = False
) -> PipelineConfig:
    """Per-category presets. The three released categories share the
    architecture (reference: generate.py:19-48); "tiny" is a miniature
    same-topology pipeline for CPU tests."""
    if category == "tiny":
        cfg = PipelineConfig(
            unet=UNetConfig(
                image_size=16,
                in_channels=6,
                model_channels=16,
                out_channels=12,
                num_res_blocks=1,
                attention_ds=(2,),
                channel_mult=(1, 2),
                num_head_channels=8,
                dropout=0.0,
                compute_dtype="float32",
            ),
            diffusion=DiffusionConfig(base_steps=100, timestep_respacing="10"),
            edit=EditConfig(
                w_time=6, feat_layer=1, shape_resolution=32, r1=2,
                feat_store_dtype="float32",
            ),
            fit=FitConfig(points_size=4000, batch_points=1000, opt_epochs=2),
            plane_channels=2,
        )
        steps = min(num_steps, 10)
        return cfg.with_ddim(steps) if use_ddim else cfg.with_steps(steps)
    if category not in ("chairs", "cars", "planes"):
        raise ValueError(f"unknown category: {category}")
    cfg = PipelineConfig()
    return cfg.with_ddim(num_steps) if use_ddim else cfg.with_steps(num_steps)
