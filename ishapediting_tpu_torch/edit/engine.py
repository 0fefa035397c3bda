"""DragEngine: the headless product layer (reference DragStuff,
drag_utils.py:174-583), generation part.

Owns the UNet, the decoder and the statistics of one category, plus the
per-session latent state::

    engine = DragEngine(preset("chairs"))             # random weights, on cuda
    engine.update_latent_params(seed=7)               # generate + cache
    mesh = engine.mesh                                # TriMesh

``update_latent_params`` draws x_T from a ``torch.Generator`` seeded with
``seed``, so the same seed gives a different shape here than in the JAX
package; pass ``latent=`` to start both from the same x_T.

``get_mesh`` decodes the occupancy grid on the device, copies it to the host
as fp16 (33 MB at 256^3), and marches and smooths it with the native C++
code.
"""

from __future__ import annotations

import time
import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ishapediting_tpu_torch.config import PipelineConfig
from ishapediting_tpu_torch.core.diffusion import (
    p_sample_guidance,
    sample_loop_with_features,
    xstart_model_adapter,
)
from ishapediting_tpu_torch.core.schedule import Schedule, make_schedule, validate_w_time
from ishapediting_tpu_torch.edit.features import regroup_features
from ishapediting_tpu_torch.edit.fit import latent_to_planes
from ishapediting_tpu_torch.geometry.marching import grid_to_mesh
from ishapediting_tpu_torch.geometry.mesh import TriMesh
from ishapediting_tpu_torch.io.model_dir import TriplaneStats, discover_model_dir, load_stats
from ishapediting_tpu_torch.models.unet import UNetModel, init_unet_
from ishapediting_tpu_torch.ops.triplane import TriplaneDecoder, decode_grid, init_decoder_
from ishapediting_tpu_torch.utils.device import resolve_device, set_cuda_flags


class DragEngine:
    def __init__(
        self,
        config: Optional[PipelineConfig] = None,
        unet: Optional[UNetModel] = None,
        decoder: Optional[TriplaneDecoder] = None,
        stats: Optional[TriplaneStats] = None,
        seed: int = 0,
        device=None,
    ):
        """Random weights from ``seed`` where ``unet``/``decoder`` are not
        given. ``device`` defaults to ``cuda`` and raises without one."""
        self.device = resolve_device(device)
        set_cuda_flags()
        self.config = config or PipelineConfig()
        gen = torch.Generator(device=self.device).manual_seed(seed)
        if unet is None:
            with torch.device(self.device):
                unet = init_unet_(UNetModel(self.config.unet), gen)
        if decoder is None:
            with torch.device(self.device):
                decoder = init_decoder_(TriplaneDecoder(self.config.plane_channels), gen)
        self.unet = unet.to(self.device).eval().requires_grad_(False)
        self.decoder = decoder.to(self.device).eval().requires_grad_(False)
        self.stats = stats or TriplaneStats.identity(
            self.config.num_planes * self.config.plane_channels
        )
        d = self.config.diffusion
        self.sched: Schedule = make_schedule(
            d.base_steps, d.noise_schedule, d.timestep_respacing,
            rescale_timesteps=d.rescale_timesteps,
        ).to(self.device)
        # x0-prediction checkpoints: the adapter indexes the full base chain
        self._base_sched: Optional[Schedule] = (
            make_schedule(d.base_steps, d.noise_schedule, "",
                          rescale_timesteps=d.rescale_timesteps).to(self.device)
            if d.predict_xstart else None
        )
        self.half_range = torch.as_tensor(self.stats.half_range, dtype=torch.float32, device=self.device)
        self.middle = torch.as_tensor(self.stats.middle, dtype=torch.float32, device=self.device)

        # session state (reference: drag_utils.py:193-208)
        self.latent_code: Optional[np.ndarray] = None
        self.w: Optional[torch.Tensor] = None
        self.w0: Optional[torch.Tensor] = None
        self.feature_guidance: Optional[torch.Tensor] = None  # [w_time,3,s,s,C']
        self.mesh: Optional[TriMesh] = None
        self.mesh0: Optional[TriMesh] = None
        self.last_mesh_walls: Optional[Dict[str, float]] = None

    @classmethod
    def from_model_dir(
        cls,
        main_path: str,
        config: Optional[PipelineConfig] = None,
        allow_identity_stats: bool = False,
        device=None,
        **kw,
    ) -> "DragEngine":
        """Load a reference-layout category directory of ``.pt`` checkpoints
        and statistics (reference: drag_utils.py:213-249). A missing
        ``statistics/`` is an error unless ``allow_identity_stats``."""
        from ishapediting_tpu_torch.io.convert import load_torch_checkpoint, load_torch_decoder

        config = config or PipelineConfig()
        info = discover_model_dir(main_path)
        if not info.unet_ckpt:
            raise FileNotFoundError(f"no ddpm*/ema* checkpoint under {main_path}")
        if not info.decoder_ckpt:
            raise FileNotFoundError(f"no decoder .pt under {main_path}")
        if info.stats_dir:
            stats = load_stats(info.stats_dir)
        elif allow_identity_stats:
            warnings.warn(
                f"no statistics/ under {main_path}: using identity triplane normalization",
                stacklevel=2,
            )
            stats = None
        else:
            raise FileNotFoundError(
                f"no statistics/ directory under {main_path} (expected "
                "statistics/<name>/{lower_bound,upper_bound}.npy); pass "
                "allow_identity_stats=True to load anyway"
            )
        unet = load_torch_checkpoint(info.unet_ckpt, UNetModel(config.unet))
        decoder = load_torch_decoder(info.decoder_ckpt, TriplaneDecoder(config.plane_channels))
        return cls(config=config, unet=unet, decoder=decoder, stats=stats, device=device, **kw)

    # ------------------------------------------------------------------
    # Model function
    # ------------------------------------------------------------------

    def model_fn(self, feat: bool = False):
        """``fn(x, t_orig) -> (out, feat or None)`` over the engine's UNet;
        ``feat=True`` also returns the tapped guidance feature map."""
        feat_layer = self.config.edit.feat_layer if feat else -1
        unet = self.unet

        def fn(x, t_orig):
            return unet(x, t_orig, feat_layer=feat_layer)

        if self._base_sched is not None:
            return xstart_model_adapter(self._base_sched, fn)
        return fn

    def _check_w_time(self) -> int:
        return validate_w_time(
            self.sched, self.config.edit.w_time,
            context=f"timestep_respacing={self.config.diffusion.timestep_respacing!r}",
        )

    # ------------------------------------------------------------------
    # Generation (reference: update_latent_params, drag_utils.py:252-280)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def update_latent_params(
        self, latent: Optional[np.ndarray] = None, seed: int = 0, noises: Optional[Sequence] = None
    ) -> np.ndarray:
        """Sample a shape from noise (x_T drawn from a generator seeded with
        ``seed``, or the given ``latent``), caching ``w`` and the per-step
        guidance features; returns the final normalized latent [1,H,W,C].
        ``noises`` (one per step, in loop order) replaces the step noise the
        generator seeded with ``seed + 1`` would draw, to replay a run."""
        shape = (1,) + self.config.latent_shape
        if latent is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            x_T = torch.randn(shape, generator=gen, device=self.device)
        else:
            x_T = torch.as_tensor(np.asarray(latent), dtype=torch.float32, device=self.device).reshape(shape)
        self.latent_code = x_T.cpu().numpy()

        w_time = self._check_w_time()
        feat_dtype = getattr(torch, self.config.edit.feat_store_dtype)
        out = sample_loop_with_features(
            self.sched,
            self.model_fn(feat=True),
            x_T,
            torch.Generator(device=self.device).manual_seed(seed + 1),
            w_time=w_time,
            feat_postprocess=lambda f: regroup_features(f)[0].to(feat_dtype),
            noises=noises,
            clip_denoised=self.config.diffusion.clip_denoised,
        )
        self.w = out["w"]
        self.w0 = self.w
        self.feature_guidance = out["features"]
        x0 = out["sample"]
        self.mesh0 = self.get_mesh(x0)
        self.mesh = self.mesh0.copy()
        return x0.cpu().numpy()

    # ------------------------------------------------------------------
    # Latent -> mesh (reference: get_mesh, drag_utils.py:282-300)
    # ------------------------------------------------------------------

    @torch.no_grad()
    def decode_latent_grid(self, latent, res: Optional[int] = None) -> np.ndarray:
        """Normalized latent -> dense occupancy logits [res,res,res] on the
        host: decoded on the device into fp16, then copied over."""
        res = res or self.config.edit.shape_resolution
        lat = torch.as_tensor(latent, dtype=torch.float32).to(self.device)
        planes = latent_to_planes(
            lat.reshape((1,) + self.config.latent_shape), self.half_range, self.middle
        )
        grid = decode_grid(self.decoder, planes, res=res, out_dtype=torch.float16)
        return grid.cpu().numpy().astype(np.float32)

    @torch.no_grad()
    def get_mesh(self, latent=None, t: int = 0, smooth: int = 10, res: Optional[int] = None) -> TriMesh:
        """Finish any remaining ``t`` sampling steps, decode the occupancy
        grid, march and smooth the mesh. ``res`` overrides the config's
        shape_resolution for this call."""
        shape = (1,) + self.config.latent_shape
        if latent is None:
            gen = torch.Generator(device=self.device).manual_seed(0)
            latent = torch.randn(shape, generator=gen, device=self.device)
        latent = torch.as_tensor(latent, dtype=torch.float32).to(self.device).reshape(shape)
        walls: Dict[str, float] = {}
        t_all = time.perf_counter()
        if t > 0:
            gen = torch.Generator(device=self.device).manual_seed(1234)
            mf = self.model_fn(feat=False)
            for step in range(t - 1, -1, -1):
                tb = torch.full((1,), step, dtype=torch.long, device=self.device)
                latent = p_sample_guidance(
                    self.sched, mf, latent, tb, gen,
                    clip_denoised=self.config.diffusion.clip_denoised,
                )["sample"]
            walls["finish_steps_s"] = time.perf_counter() - t_all
        t0 = time.perf_counter()
        grid = self.decode_latent_grid(latent, res=res)
        walls["decode_fetch_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        mesh = grid_to_mesh(grid, iso=0.0, to_unit=True)
        walls["march_host_s"] = time.perf_counter() - t0
        if smooth > 0:
            t0 = time.perf_counter()
            mesh = mesh.filter_smooth_simple(smooth)
            walls["smooth_s"] = time.perf_counter() - t0
        walls["n_verts"] = len(mesh.vertices)
        walls["total_s"] = time.perf_counter() - t_all
        self.last_mesh_walls = walls
        return mesh

    def clear_params(self) -> None:
        self.mesh0 = None
        self.mesh = None
        self.latent_code = None
        self.w0 = None
        self.w = None
        self.feature_guidance = None

    def reset_params(self) -> None:
        if self.mesh0 is not None:
            self.mesh = self.mesh0.copy()
        if self.w0 is not None:
            self.w = self.w0
