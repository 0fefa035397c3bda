"""Datasets: triplane latents for DDPM training + occupancy point sets for
decoder training (reference: triplane_decoder/dataset_3d.py:1-47 and the
OccupancyDatas wrapper at drag_utils.py:162-170).

Host-side NumPy with simple epoch shuffling, the JAX package's draws: the
same seed gives the same batches. The train step moves each batch to the
device.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from ishapediting_tpu_torch.io.model_dir import TriplaneStats


class TriplaneDataset:
    """Directory of ``.npy`` triplanes -> normalized [-1,1] NHWC batches.

    Accepts [C, H, W] (reference layout) or [H, W, C] files; normalization
    uses the category bounds stats (x = (tri - middle) / half_range)."""

    def __init__(
        self,
        root: str,
        stats: Optional[TriplaneStats] = None,
        channels: int = 96,
    ):
        self.files = sorted(
            os.path.join(root, f) for f in os.listdir(root) if f.endswith(".npy")
        )
        if not self.files:
            raise FileNotFoundError(f"no .npy triplanes under {root}")
        self.stats = stats or TriplaneStats.identity(channels)
        self.channels = channels

    def __len__(self) -> int:
        return len(self.files)

    def _load(self, path: str) -> np.ndarray:
        arr = np.load(path).astype(np.float32)
        if arr.ndim == 4 and arr.shape[0] == 1:
            arr = arr[0]
        if arr.shape[0] == self.channels:  # CHW -> HWC
            arr = arr.transpose(1, 2, 0)
        return (arr - self.stats.middle) / self.stats.half_range

    def batches(
        self, batch_size: int, seed: int = 0, epochs: Optional[int] = None
    ) -> Iterator[np.ndarray]:
        rng = np.random.default_rng(seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = rng.permutation(len(self.files))
            for start in range(0, len(order) - batch_size + 1, batch_size):
                idx = order[start : start + batch_size]
                yield np.stack([self._load(self.files[i]) for i in idx])
            epoch += 1


class OccupancyDataset:
    """Points + occupancy labels, one object (reference: dataset_3d.py
    OccupancyDataset / drag_utils.py OccupancyDatas)."""

    def __init__(self, points: np.ndarray, occupancies: np.ndarray):
        self.points = np.asarray(points, np.float32).reshape(-1, 3)
        self.occupancies = np.asarray(occupancies, np.float32).reshape(-1)
        assert len(self.points) == len(self.occupancies)

    @staticmethod
    def from_npy(points_path: str, occ_path: str) -> "OccupancyDataset":
        return OccupancyDataset(np.load(points_path), np.load(occ_path))

    def __len__(self) -> int:
        return len(self.points)

    def batches(
        self, batch_size: int, seed: int = 0, epochs: Optional[int] = None
    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        rng = np.random.default_rng(seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = rng.permutation(len(self.points))
            for start in range(0, len(order) - batch_size + 1, batch_size):
                idx = order[start : start + batch_size]
                yield self.points[idx], self.occupancies[idx]
            epoch += 1


class MultiOccupancyDataset:
    """Per-object occupancy point sets for joint decoder training
    (reference: dataset_3d.py MultiOccupancyDataset)."""

    def __init__(self, objects: Sequence[OccupancyDataset]):
        self.objects = list(objects)

    def __len__(self) -> int:
        return len(self.objects)

    def batches(
        self, batch_size: int, seed: int = 0, epochs: Optional[int] = None
    ) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
        """Yields (obj_idx, points, occs), cycling over objects."""
        rng = np.random.default_rng(seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            for obj_idx in rng.permutation(len(self.objects)):
                ds = self.objects[obj_idx]
                idx = rng.integers(0, len(ds), batch_size)
                yield int(obj_idx), ds.points[idx], ds.occupancies[idx]
            epoch += 1
