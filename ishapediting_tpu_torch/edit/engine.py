"""DragEngine: the headless product layer (reference DragStuff,
drag_utils.py:174-583): generation, inversion, drag editing and real-shape
fitting.

Owns the UNet, the decoder and the statistics of one category, plus the
per-session latent state::

    engine = DragEngine(preset("chairs"))             # random weights, on cuda
    engine.update_latent_params(seed=7)               # generate + cache
    engine.drag_edit(sources, targets, scale=1200, cof=0.4)
    engine.fit_real_shape(mesh_path="chair.obj", path=workdir)  # + inversion
    frames = engine.morph(engine.sample_latent(1), engine.sample_latent(2), n=5)

Randomness comes from ``torch.Generator``s seeded with the caller's seed, so
a seed gives another shape than in the JAX package; every stochastic entry
point also takes its draws directly (``latent=``, ``noises=``) to replay a
run of the JAX engine.

``get_mesh`` decodes the occupancy grid on the device through fp16. On a
CUDA engine it marches the grid on the card (``ops/marching.py``) and copies
only the welded vertices and triangles to the host; on a CPU engine (and
past 512^3, the device edge key's bound) it copies the grid and marches with
the native C++ code. Smoothing runs on the host in both cases.

State kept for parity with the reference: ``w``/``w0`` (the x_{w_time}
latent), per-step guidance features, per-step variances and variance_noise
from inversion, ``mesh``/``mesh0``, and the ``tri_feat.npy`` /
``mesh_recon.obj`` cache contract (drag_utils.py:403-409,466-470).
"""

from __future__ import annotations

import os
import time
import warnings
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ishapediting_tpu_torch.config import PipelineConfig
from ishapediting_tpu_torch.core.diffusion import (
    ddpm_inversion,
    p_sample_guidance,
    p_sample_loop,
    sample_loop_with_features,
    xstart_model_adapter,
)
from ishapediting_tpu_torch.core.schedule import (
    Schedule,
    fast_edit_schedule,
    make_schedule,
    named_beta_schedule,
    validate_w_time,
)
from ishapediting_tpu_torch.edit.drag import build_drag_problem, make_drag_step
from ishapediting_tpu_torch.edit.features import regroup_features
from ishapediting_tpu_torch.edit.fit import fit_direct, fit_guided, latent_to_planes, sample_training_points
from ishapediting_tpu_torch.edit.morph import morph_latents
from ishapediting_tpu_torch.geometry.marching import grid_to_mesh
from ishapediting_tpu_torch.geometry.mesh import TriMesh
from ishapediting_tpu_torch.io.model_dir import TriplaneStats, discover_model_dir, load_stats
from ishapediting_tpu_torch.models.unet import UNetModel, init_unet_
from ishapediting_tpu_torch.ops.marching import MAX_RES, device_grid_to_mesh
from ishapediting_tpu_torch.ops.triplane import TriplaneDecoder, decode_grid, init_decoder_
from ishapediting_tpu_torch.utils.device import resolve_device, set_cuda_flags


def latent_to_nchw(latent_nhwc: np.ndarray) -> np.ndarray:
    """Internal [1,H,W,C] -> reference [1,C,H,W] (tri_feat.npy contract)."""
    return np.ascontiguousarray(np.asarray(latent_nhwc).transpose(0, 3, 1, 2))


def latent_from_nchw(latent_nchw: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(latent_nchw).transpose(0, 2, 3, 1))


class DragEngine:
    def __init__(
        self,
        config: Optional[PipelineConfig] = None,
        unet: Optional[UNetModel] = None,
        decoder: Optional[TriplaneDecoder] = None,
        stats: Optional[TriplaneStats] = None,
        seed: int = 0,
        device=None,
        remat: bool = False,
    ):
        """Random weights from ``seed`` where ``unet``/``decoder`` are not
        given. ``device`` defaults to ``cuda`` and raises without one.
        ``remat`` recomputes the UNet's blocks in the backward of the guided
        paths (drag and fit steps): off by default, as in the JAX package,
        since batch 1 fits the card; on for memory-bound batched runs."""
        self.device = resolve_device(device)
        self.remat = remat
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
        self.variances: Optional[torch.Tensor] = None  # [w_time,1,H,W,C], from inversion
        self.variance_noise: Optional[torch.Tensor] = None
        self.mesh: Optional[TriMesh] = None
        self.mesh0: Optional[TriMesh] = None
        self.edited_latent: Optional[np.ndarray] = None  # last drag result
        # per-step guidance losses of the last drag_edit ({"motion", "mask"})
        self.last_drag_losses: Optional[Dict[str, np.ndarray]] = None
        self.last_fit_losses: Optional[np.ndarray] = None  # per step of the last direct fit
        # wall-clock attribution: latent_inversion / drag_edit / fit_real_shape
        # fill last_phase_walls (with a "path" tag), every get_mesh
        # last_mesh_walls
        self.last_phase_walls: Optional[Dict[str, float]] = None
        self.last_mesh_walls: Optional[Dict[str, float]] = None
        self.train_flag = True  # cooperative stop for drag_edit
        self._fast_edit_scheds: Dict[int, Tuple[Schedule, np.ndarray]] = {}
        self._fit_scheds: Dict[int, Schedule] = {}

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
        and statistics (reference: drag_utils.py:213-249), or of the JAX
        package's ``unet.orbax`` / ``decoder.orbax``, which are preferred
        over the ``.pt`` files when both are there (as the JAX package's
        loader does). A missing ``statistics/`` is an error unless
        ``allow_identity_stats``."""
        from ishapediting_tpu_torch.io.convert import load_torch_checkpoint, load_torch_decoder
        from ishapediting_tpu_torch.io.orbax import load_decoder, load_unet_state_dict

        config = config or PipelineConfig()
        info = discover_model_dir(main_path)
        if not (info.unet_orbax or info.unet_ckpt):
            raise FileNotFoundError(f"no ddpm*/ema* checkpoint or unet.orbax under {main_path}")
        if not (info.decoder_orbax or info.decoder_ckpt):
            raise FileNotFoundError(f"no decoder .pt or decoder.orbax under {main_path}")
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
        unet = UNetModel(config.unet)
        if info.unet_orbax:
            unet.load_state_dict(load_unet_state_dict(info.unet_orbax))
        else:
            load_torch_checkpoint(info.unet_ckpt, unet)
        decoder = TriplaneDecoder(config.plane_channels)
        if info.decoder_orbax:
            load_decoder(info.decoder_orbax, decoder)
        else:
            load_torch_decoder(info.decoder_ckpt, decoder)
        return cls(config=config, unet=unet, decoder=decoder, stats=stats, device=device, **kw)

    # ------------------------------------------------------------------
    # Model function
    # ------------------------------------------------------------------

    def model_fn(self, feat: bool = False, remat: bool = False):
        """``fn(x, t_orig) -> (out, feat or None)`` over the engine's UNet;
        ``feat=True`` also returns the tapped guidance feature map, ``remat``
        recomputes the UNet's blocks in a backward pass."""
        feat_layer = self.config.edit.feat_layer if feat else -1
        unet = self.unet

        def fn(x, t_orig):
            return unet(x, t_orig, feat_layer=feat_layer, remat=remat)

        if self._base_sched is not None:
            return xstart_model_adapter(self._base_sched, fn)
        return fn

    def _check_w_time(self) -> int:
        return validate_w_time(
            self.sched, self.config.edit.w_time,
            context=f"timestep_respacing={self.config.diffusion.timestep_respacing!r}",
        )

    def _sync(self) -> None:
        """Wait for the device, so a wall time covers its work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

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
            x_T = torch.randn(shape, generator=self._generator(seed), device=self.device)
        else:
            x_T = torch.as_tensor(latent, dtype=torch.float32, device=self.device).reshape(shape)
        self.latent_code = x_T.cpu().numpy()

        w_time = self._check_w_time()
        feat_dtype = getattr(torch, self.config.edit.feat_store_dtype)
        out = sample_loop_with_features(
            self.sched,
            self.model_fn(feat=True),
            x_T,
            self._generator(seed + 1),
            w_time=w_time,
            feat_postprocess=lambda f: regroup_features(f)[0].to(feat_dtype),
            noises=noises,
            clip_denoised=self.config.diffusion.clip_denoised,
        )
        self.w = out["w"]
        self.w0 = self.w
        self.feature_guidance = out["features"]
        self.variances = None
        self.variance_noise = None
        x0 = out["sample"]
        self.mesh0 = self.get_mesh(x0)
        self.mesh = self.mesh0.copy()
        return x0.cpu().numpy()

    # ------------------------------------------------------------------
    # Latent -> mesh (reference: get_mesh, drag_utils.py:282-300)
    # ------------------------------------------------------------------

    def _decode_grid(self, latent, res: int) -> torch.Tensor:
        """Normalized latent -> occupancy logits [res,res,res] on the device,
        quantized through fp16 (the grid both marching paths see)."""
        lat = torch.as_tensor(latent, dtype=torch.float32).to(self.device)
        planes = latent_to_planes(
            lat.reshape((1,) + self.config.latent_shape), self.half_range, self.middle
        )
        return decode_grid(self.decoder, planes, res=res, out_dtype=torch.float16)

    @torch.no_grad()
    def decode_latent_grid(self, latent, res: Optional[int] = None) -> np.ndarray:
        """Normalized latent -> dense occupancy logits [res,res,res] on the
        host: decoded on the device into fp16, then copied over."""
        res = res or self.config.edit.shape_resolution
        return self._decode_grid(latent, res).cpu().numpy().astype(np.float32)

    def _march_on_device(self, res: int) -> bool:
        """A CUDA engine marches on the card up to the edge key's 512^3
        bound; a CPU engine, and larger grids, march on the host."""
        return self.device.type == "cuda" and res <= MAX_RES

    @torch.no_grad()
    def march_grid(self, grid: torch.Tensor, walls: Optional[Dict] = None,
                   t0: Optional[float] = None) -> TriMesh:
        """March an fp16 occupancy grid decoded on the engine's device (as
        ``_decode_grid`` gives it) at iso 0 into the unit cube, as
        ``get_mesh`` does: on the card for a CUDA engine up to 512^3, else
        copied to the host and marched there. ``walls`` receives the decode
        (from ``t0``) and march times."""
        walls = {} if walls is None else walls
        t0 = time.perf_counter() if t0 is None else t0
        if self._march_on_device(grid.shape[0]):
            grid = grid.float()
            self._sync()
            walls["decode_device_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            mesh, stats = device_grid_to_mesh(grid, iso=0.0, to_unit=True)
            walls["device_march_s"] = time.perf_counter() - t0
            walls.update(stats)
            walls["impl"] = "device"
        else:
            grid = grid.cpu().numpy().astype(np.float32)
            walls["decode_fetch_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            mesh = grid_to_mesh(grid, iso=0.0, to_unit=True)
            walls["march_host_s"] = time.perf_counter() - t0
            walls["impl"] = "host"
        return mesh

    @torch.no_grad()
    def get_mesh(
        self, latent=None, t: int = 0, smooth: int = 10, res: Optional[int] = None,
        noises: Optional[Sequence] = None,
    ) -> TriMesh:
        """Finish any remaining ``t`` sampling steps (noise from a generator
        seeded with 1234, or ``noises``, one per step), decode the occupancy
        grid, march and smooth the mesh. ``res`` overrides the config's
        shape_resolution for this call."""
        shape = (1,) + self.config.latent_shape
        if latent is None:
            latent = torch.randn(shape, generator=self._generator(0), device=self.device)
        latent = torch.as_tensor(latent, dtype=torch.float32).to(self.device).reshape(shape)
        walls: Dict[str, float] = {}
        t_all = time.perf_counter()
        if t > 0:
            latent = self._finish_steps(latent, t, self._generator(1234), noises=noises)
            self._sync()
            walls["finish_steps_s"] = time.perf_counter() - t_all
        res = res or self.config.edit.shape_resolution
        t0 = time.perf_counter()
        mesh = self.march_grid(self._decode_grid(latent, res), walls, t0)
        if smooth > 0:
            t0 = time.perf_counter()
            mesh = mesh.filter_smooth_simple(smooth)
            walls["smooth_s"] = time.perf_counter() - t0
        walls["n_verts"] = len(mesh.vertices)
        walls["total_s"] = time.perf_counter() - t_all
        self.last_mesh_walls = walls
        return mesh

    @torch.no_grad()
    def _finish_steps(self, latent, t_start: int, generator, sched: Optional[Schedule] = None,
                      noises: Optional[Sequence] = None) -> torch.Tensor:
        """Unguided ancestral steps t_start-1 .. 0 of ``sched`` (default: the
        engine's chain); ``noises[i]`` replaces the draw of loop step i."""
        sched = self.sched if sched is None else sched
        mf = self.model_fn(feat=False)
        x = latent
        for i, t in enumerate(range(t_start - 1, -1, -1)):
            tb = torch.full((x.shape[0],), t, dtype=torch.long, device=self.device)
            noise = None if noises is None else torch.as_tensor(
                noises[i], dtype=torch.float32, device=self.device)
            x = p_sample_guidance(sched, mf, x, tb, generator, noise=noise,
                                  clip_denoised=self.config.diffusion.clip_denoised)["sample"]
        return x

    # ------------------------------------------------------------------
    # Drag editing (reference: training, drag_utils.py:302-399)
    # ------------------------------------------------------------------

    def _fast_edit_schedule(self, count: int) -> Tuple[Schedule, np.ndarray]:
        """Window-respaced schedule for fast drag editing, cached per count
        (``core.schedule.fast_edit_schedule``)."""
        if count not in self._fast_edit_scheds:
            d = self.config.diffusion
            sched, positions = fast_edit_schedule(
                self.sched, named_beta_schedule(d.noise_schedule, d.base_steps),
                self.config.edit.w_time, count, rescale_timesteps=d.rescale_timesteps,
            )
            self._fast_edit_scheds[count] = (sched.to(self.device), positions)
        return self._fast_edit_scheds[count]

    def _fit_schedule(self, count: int) -> Schedule:
        """Coarser respaced chain for fast real-shape fitting, cached per
        count: the guided fit starts from pure noise and has no
        feature-cache contract, so a plain respacing is its fast schedule."""
        if count not in self._fit_scheds:
            if count < 2:
                raise ValueError(f"fit_steps must be >= 2; got {count}")
            d = self.config.diffusion
            self._fit_scheds[count] = make_schedule(
                d.base_steps, d.noise_schedule, str(int(count)), rescale_timesteps=d.rescale_timesteps,
            ).to(self.device)
        return self._fit_scheds[count]

    def drag_edit(
        self,
        sources: np.ndarray,
        targets: np.ndarray,
        scale: Optional[float] = None,
        cof: Optional[float] = None,
        seed: int = 0,
        chunk: int = 10,
        noise_mode: str = "resample",
        progress_callback: Optional[Callable[[float], None]] = None,
        edit_steps: Optional[int] = None,
        noises: Optional[Sequence] = None,
    ) -> TriMesh:
        """Run the guided edit from ``w``; returns (and caches) the edited
        mesh. Every ``chunk`` steps ``progress_callback`` gets the fraction
        done and the cooperative stop is checked: set
        ``engine.train_flag = False`` and the remaining steps run unguided,
        as in the reference (drag_utils.py:337-339,399).

        ``noise_mode`` (the reference's edit-mode variants,
        drag_utils.py:342-346, 388-396): "resample" (default, fresh noise
        each step), "fixed_variance" (fresh noise, inversion-recorded
        variance) or "replay" (inversion-recorded variance_noise replayed
        exactly); the last two need a preceding ``latent_inversion`` or
        real-shape fit.

        ``edit_steps`` (fast editing; default ``config.edit.edit_steps``,
        None = every step of ``w_time``): walk a window-respaced schedule of
        that many guided steps instead, with resample noise only; guidance
        features come from the same cache (rows of the kept positions).

        Step noise comes from a generator seeded with ``seed``; ``noises``
        (one per step of the whole walk, guided steps then any unguided
        finishing steps, in loop order) replaces it."""
        if self.w is None or self.feature_guidance is None:
            raise RuntimeError(
                "no cached latent: call update_latent_params() or fit_real_shape() first"
            )
        w_time = self._check_w_time()
        edit_cfg = self.config.edit
        scale = edit_cfg.grad_scale if scale is None else scale
        cof = edit_cfg.mask_weight if cof is None else cof
        if noise_mode not in ("resample", "fixed_variance", "replay"):
            raise ValueError(f"unknown noise_mode {noise_mode!r}")
        if edit_steps is None:
            edit_steps = edit_cfg.edit_steps
        fast = edit_steps is not None and edit_steps < w_time
        if fast and noise_mode != "resample":
            raise ValueError(
                "edit_steps (fast editing) supports noise_mode='resample' only: "
                "inversion-recorded variances/noise belong to the full per-step grid"
            )
        if noise_mode != "resample" and (self.variances is None or self.variance_noise is None):
            raise RuntimeError(
                f"noise_mode={noise_mode!r} needs inversion-recorded variances: "
                "run latent_inversion()/fit_real_shape() first"
            )
        if fast:
            sched_edit, positions = self._fast_edit_schedule(int(edit_steps))
            n_steps = int(edit_steps)
        else:
            sched_edit, positions = self.sched, np.arange(w_time)
            n_steps = w_time
        problem = build_drag_problem(
            sources, targets, r1=edit_cfg.r1, voxel_size=edit_cfg.voxel_size,
            feat_width=self.feature_guidance.shape[-2], device=self.device,
        )
        step = make_drag_step(
            sched_edit, self.model_fn(feat=True, remat=self.remat), problem, scale=float(scale),
            cof=float(cof),
            loss_type=edit_cfg.loss_type, clip_denoised=self.config.diffusion.clip_denoised,
        )
        self.train_flag = True
        gen = self._generator(seed)
        img = self.w.float()
        t = n_steps
        stop_time = 0
        done = 0  # steps run, the index of the next noise
        motions, masks = [], []
        t_all = time.perf_counter()
        while t > 0:
            n = min(chunk, t)
            for tt in range(t - 1, t - 1 - n, -1):
                row = w_time - 1 - int(positions[tt])  # feature-cache row of this step
                kw = {}
                if noise_mode == "fixed_variance":
                    kw["variance_override"] = self.variances[row]
                elif noise_mode == "replay":
                    kw["variance_noise"] = self.variance_noise[row]
                if noises is not None:
                    kw["noise"] = torch.as_tensor(noises[done], dtype=torch.float32, device=self.device)
                img, (motion, mask) = step(img, tt, self.feature_guidance[row], gen, **kw)
                motions.append(motion)
                masks.append(mask)
                done += 1
            t -= n
            if progress_callback is not None:
                progress_callback(1.0 - t / max(n_steps - 1.0, 1.0))
            if not self.train_flag:
                stop_time = t
                break
        self.last_drag_losses = {
            "motion": torch.stack(motions).cpu().numpy() if motions else np.zeros(0, np.float32),
            "mask": torch.stack(masks).cpu().numpy() if masks else np.zeros(0, np.float32),
        }
        rest = None if noises is None else noises[done:]
        if fast and stop_time > 0:
            # stopped mid-walk: the unguided rest belongs to the fast schedule
            img = self._finish_steps(img, stop_time, gen, sched=sched_edit, noises=rest)
            stop_time = 0
        self.edited_latent = img.cpu().numpy()
        device_s = time.perf_counter() - t_all
        t0 = time.perf_counter()
        self.mesh = self.get_mesh(img, t=stop_time, noises=rest)
        self.last_phase_walls = {
            "path": "drag",
            "edit_steps": n_steps,
            "device_s": device_s,
            "mesh_s": time.perf_counter() - t0,
            "total_s": time.perf_counter() - t_all,
        }
        return self.mesh

    def drag_loss_summary(self) -> Optional[Dict[str, float]]:
        """First/last per-step guidance diagnostics of the most recent
        ``drag_edit`` as plain floats, or None when none were recorded."""
        losses = self.last_drag_losses
        if losses is None or not losses["motion"].size:
            return None
        return {
            "motion_first": float(losses["motion"][0]),
            "motion_last": float(losses["motion"][-1]),
            "mask_last": float(losses["mask"][-1]),
        }

    # ------------------------------------------------------------------
    # Real-shape fitting + inversion (reference: drag_utils.py:401-471,552-566)
    # ------------------------------------------------------------------

    def fit_real_shape(
        self,
        mesh: Optional[TriMesh] = None,
        mesh_path: Optional[str] = None,
        center_mesh: bool = True,
        tri_feat_path: Optional[str] = None,
        path: str = "./",
        seed: int = 0,
        fit_steps: Optional[int] = None,
    ) -> None:
        """Fit a user mesh to a triplane latent by classifier-guided
        reconstruction, cache it (``<path>/tri_feat.npy``, NCHW: the
        reference's cache contract), run the edit-friendly inversion and
        write the replayed mesh to ``<path>/mesh_recon.obj``. With
        ``tri_feat_path`` a cached fit is loaded and only inverted.

        ``fit_steps`` (fast fitting; default ``config.fit.fit_steps``, None =
        the full chain): guide a respaced chain of that many steps. The
        inversion always runs the full chain."""
        if tri_feat_path is not None:
            self.latent_inversion(latent_from_nchw(np.load(tri_feat_path)))
            return
        if mesh is None:
            if mesh_path is None:
                raise ValueError("need mesh, mesh_path, or tri_feat_path")
            mesh = TriMesh.read(mesh_path)
        if center_mesh:
            mesh = mesh.copy().normalize_unit_cube()
        if fit_steps is None:
            fit_steps = self.config.fit.fit_steps
        fast = fit_steps is not None and int(fit_steps) < self.sched.num_timesteps
        sched_fit = self._fit_schedule(int(fit_steps)) if fast else self.sched

        t_all = time.perf_counter()
        points, occ = sample_training_points(mesh, self.config.fit, seed=seed)
        points_s = time.perf_counter() - t_all
        fcfg = self.config.fit
        t0 = time.perf_counter()
        latent = fit_guided(
            sched_fit, self.model_fn(feat=False, remat=self.remat), self.decoder,
            torch.as_tensor(points, device=self.device), torch.as_tensor(occ, device=self.device),
            self.half_range, self.middle, self._generator(seed),
            latent_shape=self.config.latent_shape, batch_points=fcfg.batch_points,
            scale=fcfg.grad_scale, clip_denoised=self.config.diffusion.clip_denoised,
        )
        self._sync()
        guided_s = time.perf_counter() - t0
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "tri_feat.npy"), latent_to_nchw(latent.cpu().numpy()))
        self.clear_params()
        # the inversion decodes the replayed sample (== latent exactly): one
        # decode serves both mesh and mesh0
        self.latent_inversion(latent)
        nested = self.last_phase_walls or {}
        self.last_phase_walls = {
            "path": "fit",
            "fit_steps": int(sched_fit.num_timesteps),
            "points_s": points_s,
            "guided_s": guided_s,
            "inversion_device_s": nested.get("device_s", 0.0),
            "mesh_s": nested.get("mesh_s", 0.0),
            "total_s": time.perf_counter() - t_all,
        }
        self.mesh0.write(os.path.join(path, "mesh_recon.obj"))

    def fit_real_shape_direct(
        self,
        mesh: Optional[TriMesh] = None,
        mesh_path: Optional[str] = None,
        center_mesh: bool = True,
        path: str = "./",
        seed: int = 0,
        init_noise=None,
        draws: Optional[Sequence] = None,
    ) -> np.ndarray:
        """Direct-Adam triplane fit (reference train_triplane_opt,
        drag_utils.py:473-550): writes ``<path>/tri_feat_opt.npy`` (NCHW)
        and ``<path>/mesh_opt.obj``; returns the normalized latent
        [1, H, W, C]. Draws come from a generator seeded with ``seed``, or
        ``init_noise``/``draws`` (``edit.fit.fit_direct``). The per-step
        losses land in ``last_fit_losses``."""
        if mesh is None:
            if mesh_path is None:
                raise ValueError("need mesh or mesh_path")
            mesh = TriMesh.read(mesh_path)
        if center_mesh:
            mesh = mesh.copy().normalize_unit_cube()
        t_all = time.perf_counter()
        points, occ = sample_training_points(mesh, self.config.fit, seed=seed)
        points_s = time.perf_counter() - t_all
        losses = []
        t0 = time.perf_counter()
        latent = fit_direct(
            self.decoder, torch.as_tensor(points, device=self.device),
            torch.as_tensor(occ, device=self.device), self.half_range, self.middle,
            self.stats.means, self.stats.stds, self._generator(seed), self.config.fit,
            latent_shape=self.config.latent_shape, init_noise=init_noise, draws=draws,
            losses=losses,
        )
        self._sync()
        opt_s = time.perf_counter() - t0
        self.last_fit_losses = torch.stack(losses).cpu().numpy()
        latent = latent.cpu().numpy()
        os.makedirs(path, exist_ok=True)
        np.save(os.path.join(path, "tri_feat_opt.npy"), latent_to_nchw(latent))
        t0 = time.perf_counter()
        self.get_mesh(latent).write(os.path.join(path, "mesh_opt.obj"))
        self.last_phase_walls = {
            "path": "fit_direct",
            "opt_steps": len(losses),
            "points_s": points_s,
            "opt_s": opt_s,
            "mesh_s": time.perf_counter() - t0,
            "total_s": time.perf_counter() - t_all,
        }
        return latent

    @torch.no_grad()
    def latent_inversion(self, latent, seed: int = 0, noises: Optional[Sequence] = None) -> None:
        """Edit-friendly DDPM inversion of a normalized latent: records
        ``w``, the per-step guidance features, variances and
        variance_noise, and the replayed mesh (reference:
        drag_utils.py:552-566). Forward noise comes from a generator seeded
        with ``seed``; ``noises[t]`` (t ascending) replaces it."""
        w_time = self._check_w_time()
        feat_dtype = getattr(torch, self.config.edit.feat_store_dtype)
        latent = torch.as_tensor(latent, dtype=torch.float32, device=self.device).reshape(
            (1,) + self.config.latent_shape)
        t_all = time.perf_counter()
        out = ddpm_inversion(
            self.sched, self.model_fn(feat=True), latent, self._generator(seed),
            steps=w_time, feat_postprocess=lambda f: regroup_features(f).to(feat_dtype),
            clip_denoised=self.config.diffusion.clip_denoised,
            chunk=self.config.edit.inversion_chunk, noises=noises,
        )
        self._sync()
        device_s = time.perf_counter() - t_all
        self.w = out["latent"]
        self.w0 = self.w
        # [steps, B=1, ...] -> the drag loop's [w_time, 3, s, s, C']; the
        # variances keep their [steps, 1, H, W, C] per-step-batch shape
        self.feature_guidance = out["features"][:, 0]
        self.variances = out["variances"]
        self.variance_noise = out["variance_noise"]
        t0 = time.perf_counter()
        self.mesh = self.get_mesh(out["sample"])
        self.mesh0 = self.mesh.copy()
        self.last_phase_walls = {
            "path": "inversion",
            "device_s": device_s,
            "mesh_s": time.perf_counter() - t0,
            "total_s": time.perf_counter() - t_all,
        }

    @torch.no_grad()
    def sample_latent(self, seed: int = 0, latent=None, noises: Optional[Sequence] = None) -> np.ndarray:
        """Plain ancestral sample -> normalized latent [1, H, W, C], without
        the guidance-feature cache of ``update_latent_params`` (for callers
        that do not edit, such as morphing). x_T comes from a generator
        seeded with ``seed`` (or ``latent``), the step noise from one seeded
        with ``seed + 1`` (or ``noises``)."""
        shape = (1,) + self.config.latent_shape
        if latent is None:
            x_T = torch.randn(shape, generator=self._generator(seed), device=self.device)
        else:
            x_T = torch.as_tensor(latent, dtype=torch.float32, device=self.device).reshape(shape)
        x = p_sample_loop(self.sched, self.model_fn(), x_T, self._generator(seed + 1),
                          noises=noises, clip_denoised=self.config.diffusion.clip_denoised)
        return x.cpu().numpy()

    @torch.no_grad()
    def morph(self, latent_a, latent_b, n: int = 5, mesh=None) -> np.ndarray:
        """Latent-space morph between two shapes: DDIM-encode both
        normalized latents as one batch, slerp at ``n`` uniform mix weights,
        decode every frame as one batch-``n`` DDIM walk (``edit/morph.py``).
        With ``mesh`` (a ``parallel.mesh.DataMesh``, ``n`` divisible by its
        ranks) each rank decodes its frames and every rank of the axis gets
        all of them. Returns normalized latents [n, H, W, C]; mesh a frame
        with ``get_mesh(latents[k][None])``."""
        if n < 2:
            raise ValueError(f"need at least 2 morph frames, got {n}")
        shape = self.config.latent_shape
        a = torch.as_tensor(latent_a, dtype=torch.float32, device=self.device).reshape(shape)
        b = torch.as_tensor(latent_b, dtype=torch.float32, device=self.device).reshape(shape)
        alphas = [float(x) for x in np.linspace(0.0, 1.0, n)]
        t0 = time.perf_counter()
        walls: Dict[str, float] = {}
        frames = morph_latents(self.sched, self.model_fn(), a, b, alphas,
                               clip_denoised=self.config.diffusion.clip_denoised,
                               walls=walls, mesh=mesh)
        out = frames.cpu().numpy()
        self.last_phase_walls = {"path": "morph", "frames": n, **walls,
                                 "total_s": time.perf_counter() - t0}
        return out

    # ------------------------------------------------------------------
    # Session state (reference: drag_utils.py:568-583)
    # ------------------------------------------------------------------

    def clear_params(self) -> None:
        self.mesh0 = None
        self.mesh = None
        self.latent_code = None
        self.w0 = None
        self.w = None
        self.feature_guidance = None
        self.variances = None
        self.variance_noise = None
        self.last_drag_losses = None

    def reset_params(self) -> None:
        if self.mesh0 is not None:
            self.mesh = self.mesh0.copy()
        if self.w0 is not None:
            self.w = self.w0
