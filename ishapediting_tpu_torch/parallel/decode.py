"""Dense occupancy decode over every rank of a mesh (the JAX package's
``parallel/decode.py``).

The res^3 sweep is embarrassingly parallel along x (SURVEY §5.7: the
trajectory batch and the 16.7M-point occupancy sweep are the honest scaling
axes; the reference runs it as 336 sequential 50k-point chunks on one GPU,
visualize.py:76-97). ``decode_grid_sharded`` gives each rank a slab of
x-rows: the per-plane precompute (resize, Fourier projection, sin/cos; about
res/3 times cheaper than the per-voxel MLP) runs on every rank, the MLP only
over the rank's rows. ``decode_grids_batched`` gives each rank whole grids.
Both split over every rank of a ``data`` x ``model`` mesh in row-major
order, as the JAX package's ``lin = lin * mesh.shape[name] +
axis_index(name)`` does.

Both return this rank's part; ``parallel.mesh.gather_mesh`` of it equals
``ops.triplane.decode_grid`` bit for bit: the same precompute and the same
chunk shapes per row.
"""

from __future__ import annotations

from typing import Optional

import torch

from ishapediting_tpu_torch.ops.triplane import TriplaneDecoder, _grid_precompute, _grid_rows, decode_grid
from ishapediting_tpu_torch.parallel.mesh import DataMesh


@torch.no_grad()
def decode_grid_sharded(
    dec: TriplaneDecoder,
    planes: torch.Tensor,
    mesh: DataMesh,
    *,
    res: int = 256,
    chunk: int = 16,
    compute_dtype: torch.dtype = torch.bfloat16,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """This rank's x-slab [res / ranks, res, res] of the occupancy logits of
    ``planes`` [3, h, w, c] (``decode_grid``'s contract). ``res`` must divide
    by the mesh's rank count; rows go ``chunk`` at a time, cut to the largest
    divisor of the slab."""
    if res % mesh.n_ranks:
        raise ValueError(
            f"res={res} must divide by the mesh's {mesh.n_ranks} ranks "
            "(pad res or use ops.triplane.decode_grid)"
        )
    rows = mesh.mesh_rows(res)
    per = rows.stop - rows.start
    c = min(chunk, per)
    while per % c:  # largest divisor of the slab not exceeding chunk
        c -= 1
    pre = _grid_precompute(dec, planes, res)
    out = torch.empty((per, res, res), dtype=out_dtype or torch.float32, device=planes.device)
    for i0 in range(0, per, c):
        out[i0 : i0 + c] = _grid_rows(dec, pre, rows.start + i0, c, compute_dtype)
    return out


@torch.no_grad()
def decode_grids_batched(
    dec: TriplaneDecoder,
    planes_batch: torch.Tensor,  # [N, 3, h, w, c]
    mesh: DataMesh,
    *,
    res: int = 256,
    chunk: int = 16,
    compute_dtype: torch.dtype = torch.bfloat16,
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """This rank's grids [N / ranks, res, res, res] of N triplanes, whole
    grids per rank (the batch-generation decode; the reference decodes its
    samples one after another on one GPU, generate.py:89-98). N must divide
    by the mesh's rank count."""
    n = planes_batch.shape[0]
    if n % mesh.n_ranks:
        raise ValueError(
            f"batch {n} must divide by the mesh's {mesh.n_ranks} ranks "
            "(pad the batch or decode per sample)"
        )
    return torch.stack([
        decode_grid(dec, planes, res=res, chunk=chunk, compute_dtype=compute_dtype, out_dtype=out_dtype)
        for planes in planes_batch[mesh.mesh_rows(n)]
    ])
