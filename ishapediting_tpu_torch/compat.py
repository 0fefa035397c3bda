"""Reference-named convenience facade.

Users migrating from iShapEditing can import the surface they know (same
names, argument shapes and semantics) backed by the port (reference
symbols: meshProcess.py:7-118, visualize.py:36-128, image_sample.py:138-201).
Decoding runs on the device of the decoder's parameters; sampling on the
engine's device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ishapediting_tpu_torch.geometry.arap import arap_deform
from ishapediting_tpu_torch.geometry.marching import grid_to_mesh
from ishapediting_tpu_torch.geometry.mesh import TriMesh
from ishapediting_tpu_torch.geometry.metrics import (  # noqa: F401
    chamfer_distance as calc_chamfer,
    hausdorff_distance as calc_hausdorff,
    iou as calc_iou,
    local_distance as calc_local_distance,
)
from ishapediting_tpu_torch.geometry.occupancy import points_occupancy, signed_distance
from ishapediting_tpu_torch.geometry.recon import cloud2mesh  # noqa: F401
from ishapediting_tpu_torch.geometry.render import write_png
from ishapediting_tpu_torch.io.planes import planes_to_nhwc as _planes_to_nhwc
from ishapediting_tpu_torch.ops.triplane import TriplaneDecoder, decode_grid, decode_points_chunked


def calc_implicit_field(mesh: TriMesh, points: np.ndarray, sdf: bool = True) -> np.ndarray:
    """Occupancy or signed distance at points (reference: meshProcess.py:7-14)."""
    if sdf:
        return signed_distance(mesh, points)
    return points_occupancy(mesh, points)


def calc_mesh_points_normals(mesh, pcd: Optional[np.ndarray] = None, n: int = 2048) -> Dict:
    """Surface samples + normals (reference: meshProcess.py:108-118).
    Normals come from the nearest triangle's face normal."""
    from scipy.spatial import cKDTree

    if isinstance(mesh, str):
        mesh = TriMesh.read(mesh)
    pnt = (
        np.asarray(pcd, np.float32)
        if pcd is not None
        else mesh.sample_points_uniformly(n).astype(np.float32)
    )
    centroids = mesh.vertices[mesh.triangles].mean(axis=1)
    _, tri_idx = cKDTree(centroids).query(pnt)
    return {"points": pnt, "normals": mesh.triangle_normals()[tri_idx].astype(np.float32)}


def arap(mesh: TriMesh, static_ids, handle_ids, handle_pos, max_iter: int = 50) -> TriMesh:
    """ARAP deform with static + handle constraints
    (reference: meshProcess.py:222-236)."""
    static_pos = [mesh.vertices[i] for i in static_ids]
    constraint_ids = list(static_ids) + list(handle_ids)
    constraint_pos = np.asarray(list(static_pos) + list(handle_pos))
    return arap_deform(mesh, constraint_ids, constraint_pos, max_iter=max_iter)


def _planes_on(decoder: TriplaneDecoder, triplanes: np.ndarray) -> torch.Tensor:
    """[3,C,H,W] or [3,H,W,C] -> NHWC float32 planes on the decoder's device."""
    planes = _planes_to_nhwc(np.asarray(triplanes, np.float32))
    return torch.from_numpy(np.ascontiguousarray(planes)).to(decoder.fourier_B.device)


@torch.no_grad()
def decode_occupancy_grid(decoder: TriplaneDecoder, triplanes: np.ndarray, res: int = 128) -> np.ndarray:
    """Occupancy logits [res, res, res] on the host, decoded on the device
    of the decoder's parameters (the grid ``create_obj`` marches)."""
    return decode_grid(decoder, _planes_on(decoder, triplanes), res=res).cpu().numpy()


def create_obj(
    decoder: TriplaneDecoder,
    triplanes: np.ndarray,
    res: int = 128,
    output_path: Optional[str] = None,
) -> TriMesh:
    """Triplanes -> mesh (reference: visualize.py:36-105 create_obj /
    create_obj_o3d). ``triplanes``: [3, 32, H, W] (reference NCHW layout)
    or [3, H, W, 32]. Decodes on the decoder's device, marches on the host."""
    mesh = grid_to_mesh(decode_occupancy_grid(decoder, triplanes, res), iso=0.0, to_unit=True)
    if output_path:
        mesh.write(output_path)
    return mesh


def cross_section_coords(res: int, axis: str = "z") -> np.ndarray:
    """[res*res, 3] points of the mid-plane normal to ``axis``."""
    xx = np.linspace(-1, 1, res, dtype=np.float32)
    a, b = np.meshgrid(xx, xx, indexing="ij")
    zeros = np.zeros_like(a)
    if axis == "z":
        coords = np.stack([a, b, zeros], -1)
    elif axis == "y":
        coords = np.stack([a, zeros, b], -1)
    else:
        coords = np.stack([zeros, a, b], -1)
    return coords.reshape(-1, 3)


@torch.no_grad()
def cross_section(
    decoder: TriplaneDecoder,
    triplanes: np.ndarray,
    res: int = 512,
    axis: str = "z",
    save_path: Optional[str] = None,
) -> np.ndarray:
    """Binary occupancy cross-section at the mid-plane
    (reference: visualize.py:10-33). Returns [res, res] uint8; with
    ``save_path`` also writes it as a PNG, inside white on black (the
    reference draws it with matplotlib, which the port does not use)."""
    planes = _planes_on(decoder, triplanes)
    logits = decode_points_chunked(decoder, planes, torch.from_numpy(cross_section_coords(res, axis)))
    img = (logits.reshape(res, res) > 0).to(torch.uint8).cpu().numpy()
    if save_path:
        write_png(save_path, np.repeat(img[:, :, None] * 255, 3, axis=2))
    return img


def noise2shape(
    model_dir: Optional[str] = None,
    num_samples: int = 8,
    batch_size: int = 8,
    num_steps: int = 256,
    use_ddim: bool = False,
    seed: int = 0,
    engine=None,
    device=None,
) -> np.ndarray:
    """Batch unconditional sampling returning unnormalized triplanes NHWC
    [num_samples, H, W, 96] (reference: image_sample.py:138-201 returns NHWC
    after permute at :189-190). Batch i draws from a generator seeded with
    ``seed + i`` on the engine's device (``device``, default ``cuda``, when
    the engine is loaded from ``model_dir``)."""
    from ishapediting_tpu_torch.config import PipelineConfig
    from ishapediting_tpu_torch.edit.engine import DragEngine
    from ishapediting_tpu_torch.parallel.sampling import sample_batches

    if engine is None:
        config = PipelineConfig().with_ddim(num_steps) if use_ddim else PipelineConfig().with_steps(num_steps)
        engine = DragEngine.from_model_dir(model_dir, config=config, device=device)
    arr = sample_batches(
        engine.sched,
        engine.model_fn(feat=False),
        num_samples=num_samples,
        batch_size=batch_size,
        latent_shape=engine.config.latent_shape,
        device=engine.device,
        seed=seed,
        sampler="ddim" if use_ddim else "ddpm",
        clip_denoised=engine.config.diffusion.clip_denoised,
    )
    return arr * engine.stats.half_range + engine.stats.middle
