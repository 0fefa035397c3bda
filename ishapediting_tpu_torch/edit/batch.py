"""Batched multi-shape editing: N independent shapes, each with its own
cached ``w`` latent, guidance features and handle set, edited together.

The reference edits one shape at a time (drag_utils.py:303-304); the JAX
package vmaps a per-shape scan (BASELINE.json config 5). Here every step is
one batch-N UNet forward and one backward: the N shapes' losses are summed,
never averaged, so each shape's latent gradient equals its single-shape
gradient (the UNet's GroupNorm and attention are per sample). ``scale`` and
``cof`` may be per-shape [N] weights. The whole real-shape path batches:
``fit_real_shapes_batched`` -> ``invert_batched`` -> ``drag_edit_batched``,
including the inversion-anchored noise modes ("fixed_variance", "replay").

All shapes share one handle count (``build_batched_problems`` pads with
repeated handles, a no-op for both losses). Spreading the shapes over
several GPUs waits for the multi-GPU slice.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ishapediting_tpu_torch.core.diffusion import ddpm_inversion, p_sample_guidance
from ishapediting_tpu_torch.core.schedule import Schedule, validate_w_time
from ishapediting_tpu_torch.edit.drag import DragProblem, build_drag_problem, drag_losses
from ishapediting_tpu_torch.edit.features import regroup_features
from ishapediting_tpu_torch.edit.fit import fit_guided, sample_training_points


def stack_problems(problems: Sequence[DragProblem]) -> DragProblem:
    """[per-shape DragProblem] -> one DragProblem with a leading shape axis
    (``mask_count`` becomes a [N] tensor)."""
    n_handles = {p.patch_grid.shape[1] for p in problems}
    if len(n_handles) != 1:
        raise ValueError(
            f"all shapes must share one handle count, got {sorted(n_handles)}; "
            "pad with repeated handles"
        )
    return DragProblem(
        patch_grid=torch.stack([p.patch_grid for p in problems]),
        shift_grid=torch.stack([p.shift_grid for p in problems]),
        masks=torch.stack([p.masks for p in problems]),
        mask_count=torch.tensor([float(p.mask_count) for p in problems], device=problems[0].masks.device),
    )


def _shape_problem(problems: DragProblem, i: int) -> DragProblem:
    return DragProblem(problems.patch_grid[i], problems.shift_grid[i], problems.masks[i],
                       problems.mask_count[i])


def drag_edit_batched(
    sched: Schedule,
    model_fn_feat: Callable,
    w_batch: torch.Tensor,  # [N, 1, H, W, C]
    features_batch: torch.Tensor,  # [N, w_time, 3, s, s, C']
    problems: DragProblem,  # stacked, leading shape axis
    generators: Optional[Sequence[torch.Generator]] = None,
    *,
    w_time: int,
    scale,
    cof,
    loss_type: str = "l2",
    clip_denoised: bool = True,
    noise_mode: str = "resample",
    variances_batch: Optional[torch.Tensor] = None,  # [N, w_time, 1, H, W, C]
    variance_noise_batch: Optional[torch.Tensor] = None,  # same shape
    edit_positions: Optional[np.ndarray] = None,
    noises: Optional[Sequence] = None,
) -> torch.Tensor:
    """Edit N shapes together; returns [N, 1, H, W, C] latents.

    ``model_fn_feat`` must return the tapped feature (pass
    ``engine.model_fn(feat=True, remat=...)``). ``scale``/``cof``: scalars
    or per-shape [N] weights. ``noise_mode`` as the single-shape engine:
    "resample" (fresh noise), "fixed_variance" (the inversion-recorded
    variance), "replay" (the recorded variance_noise replayed exactly); the
    last two need the stacked inversion records of ``invert_batched``.

    Fast editing (resample only): pass the window-respaced schedule of
    ``core.schedule.fast_edit_schedule`` as ``sched`` and its kept chain
    positions as ``edit_positions``; step j then takes feature row
    ``w_time - 1 - positions[::-1][j]`` of the same ``features_batch``.

    Shape i's step noise comes from ``generators[i]``; ``noises[j]`` ([N,
    ...] per step j, in loop order) replaces the draws."""
    if noise_mode not in ("resample", "fixed_variance", "replay"):
        raise ValueError(f"unknown noise_mode {noise_mode!r}")
    if features_batch.shape[1] != w_time:
        # the silent failure mode here would be a gather of the wrong rows
        raise ValueError(
            f"features_batch has {features_batch.shape[1]} rows but w_time={w_time} "
            "(invert_batched records one row per window step)"
        )
    if edit_positions is None:
        validate_w_time(sched, w_time, context="drag_edit_batched")
    elif not (0 <= np.min(edit_positions) and np.max(edit_positions) < w_time):
        raise ValueError(
            f"edit_positions must lie in [0, w_time={w_time}); got "
            f"[{np.min(edit_positions)}, {np.max(edit_positions)}]"
        )
    if edit_positions is not None and noise_mode != "resample":
        raise ValueError(
            "edit_positions (fast editing) supports noise_mode='resample' only: "
            "inversion-recorded variances/noise belong to the full per-step grid"
        )
    if noise_mode != "resample" and (variances_batch is None or variance_noise_batch is None):
        raise ValueError(
            f"noise_mode={noise_mode!r} needs variances_batch and variance_noise_batch "
            "from invert_batched()"
        )
    n = w_batch.shape[0]
    dev = w_batch.device
    x = w_batch.float().reshape((n,) + tuple(w_batch.shape[-3:]))
    if edit_positions is not None:
        positions = np.asarray(edit_positions, np.int64)
        n_steps = len(positions)
        rows = w_time - 1 - positions[::-1]
    else:
        n_steps = w_time
        rows = np.arange(w_time)
    if noise_mode == "replay" or noises is not None:
        gens = None
    elif generators is None or len(generators) != n:
        raise ValueError(f"need {n} generators (one per shape) or noises=")
    else:
        gens = list(generators)
    scale_t = torch.as_tensor(np.broadcast_to(np.asarray(scale, np.float32), (n,)).copy(), device=dev)
    cof_t = torch.as_tensor(np.broadcast_to(np.asarray(cof, np.float32), (n,)).copy(), device=dev)
    shape_problems = [_shape_problem(problems, i) for i in range(n)]
    bcast = (n,) + (1,) * (x.ndim - 1)

    for j in range(n_steps):
        t = n_steps - 1 - j
        row = int(rows[j])
        kw: Dict[str, torch.Tensor] = {}
        if noise_mode == "replay":
            kw["variance_noise"] = variance_noise_batch[:, row].reshape(x.shape).float()
        else:
            if noises is not None:
                kw["noise"] = torch.as_tensor(noises[j], dtype=torch.float32, device=dev).reshape(x.shape)
            else:
                kw["noise"] = torch.cat([
                    torch.randn((1,) + x.shape[1:], generator=g, device=dev) for g in gens])
            if noise_mode == "fixed_variance":
                kw["variance"] = variances_batch[:, row].reshape(x.shape).float()
        im = x.detach().requires_grad_(True)
        tb = torch.full((n,), t, dtype=torch.long, device=dev)
        with torch.enable_grad():
            out = p_sample_guidance(sched, model_fn_feat, im, tb, clip_denoised=clip_denoised, **kw)
            edit_feats = regroup_features(out["inter_feat"])  # [N, 3, s, s, C]
            loss = 0.0
            for i in range(n):
                motion, mask = drag_losses(edit_feats[i], features_batch[i, row], shape_problems[i],
                                           loss_type)
                loss = loss - motion - cof_t[i] * mask
        (grad,) = torch.autograd.grad(loss, im)
        x = out["sample"].detach() + out["variance"].detach() * (scale_t.reshape(bcast) * grad)
    return x[:, None]


def invert_batched(
    sched: Schedule,
    model_fn_feat: Callable,
    latents: torch.Tensor,  # [N, H, W, C] normalized
    generator: Optional[torch.Generator] = None,
    *,
    w_time: int,
    clip_denoised: bool = True,
    chunk: int = 2,
    feat_dtype: torch.dtype = torch.float32,
    noises: Optional[Sequence] = None,
) -> Dict[str, torch.Tensor]:
    """Edit-friendly inversion of N latents as one batch, laid out for
    ``drag_edit_batched``:

      w:               [N, 1, H, W, C]
      features:        [N, w_time, 3, s, s, C'] in ``feat_dtype``
      variances:       [N, w_time, 1, H, W, C]
      variance_noise:  [N, w_time, 1, H, W, C]
      sample:          [N, H, W, C]  (== latents, the replay identity)

    The backward evaluations run ``chunk`` steps per forward (batch
    ``chunk * N``). Forward noise from ``generator``, or ``noises[t]``
    ([N, H, W, C], t ascending)."""
    validate_w_time(sched, w_time, context="invert_batched")
    with torch.no_grad():
        out = ddpm_inversion(
            sched, model_fn_feat, latents.float(), generator, steps=w_time,
            feat_postprocess=lambda f: regroup_features(f).to(feat_dtype),
            clip_denoised=clip_denoised, chunk=chunk, noises=noises,
        )

    def move(a):
        return a.transpose(0, 1)

    return {
        "w": out["latent"][:, None],
        "features": move(out["features"]),
        "variances": move(out["variances"])[:, :, None],
        "variance_noise": move(out["variance_noise"])[:, :, None],
        "sample": out["sample"],
    }


def fit_real_shapes_batched(
    sched_fit: Schedule,
    model_fn: Callable,
    decoder,
    meshes: Sequence,
    half_range: torch.Tensor,
    middle: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    latent_shape: Tuple[int, int, int],
    fit_cfg,
    seed: int = 0,
    clip_denoised: bool = True,
    x_T: Optional[torch.Tensor] = None,
    noises: Optional[Sequence] = None,
    batch_indices: Optional[Sequence] = None,
) -> torch.Tensor:
    """Classifier-guided reconstruction of N meshes together: host point
    sampling per mesh (mesh i with ``seed + i``), then one batched
    ``fit_guided`` with a BCE term per shape. Returns normalized latents
    [N, H, W, C]; ``x_T``/``noises``/``batch_indices`` replace the draws as
    in ``fit_guided``."""
    pts, occ = [], []
    for i, m in enumerate(meshes):
        p, o = sample_training_points(m, fit_cfg, seed=seed + i)
        pts.append(p)
        occ.append(o)
    dev = half_range.device
    return fit_guided(
        sched_fit, model_fn, decoder,
        torch.as_tensor(np.stack(pts), device=dev), torch.as_tensor(np.stack(occ), device=dev),
        half_range, middle, generator, latent_shape=latent_shape,
        batch_points=fit_cfg.batch_points, scale=fit_cfg.grad_scale, clip_denoised=clip_denoised,
        x_T=x_T, noises=noises, batch_indices=batch_indices,
    )


def build_batched_problems(
    sources_list: Sequence[np.ndarray],
    targets_list: Sequence[np.ndarray],
    *,
    r1: int,
    voxel_size: float,
    feat_width: int,
    device=None,
) -> DragProblem:
    """Per-shape handle sets -> stacked DragProblem (pads to the largest
    handle count by repeating each shape's last handle pair)."""
    max_handles = max(np.asarray(s).reshape(-1, 3).shape[0] for s in sources_list)
    problems: List[DragProblem] = []
    for src, tgt in zip(sources_list, targets_list):
        src = np.asarray(src, np.float32).reshape(-1, 3)
        tgt = np.asarray(tgt, np.float32).reshape(-1, 3)
        if src.shape[0] < max_handles:
            pad = max_handles - src.shape[0]
            src = np.concatenate([src, np.repeat(src[-1:], pad, 0)], 0)
            tgt = np.concatenate([tgt, np.repeat(tgt[-1:], pad, 0)], 0)
        problems.append(build_drag_problem(src, tgt, r1=r1, voxel_size=voxel_size,
                                           feat_width=feat_width, device=device))
    return stack_problems(problems)
