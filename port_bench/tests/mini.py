"""A miniature of each cell for the CPU tests: the same code paths, the
UNet and the traffic cut to a size the CPU runs in seconds."""

from __future__ import annotations

import copy
import dataclasses
import glob
import os

from port_bench.spec import HERE, ROOT, CellSpec, load, load_json

MINI_ARCH = {
    "image_size": 16, "in_channels": 6, "num_channels": 32, "num_res_blocks": 1,
    "channel_mult": [1, 2], "attention_resolutions": "8", "num_head_channels": 16,
    "plane_channels": 2,
}
MINI_PLANES = {1: {"in_channels": 3, "plane_channels": 3}}  # a latent of one plane keeps its channels
MINI_TRAFFIC = {
    "generate": {"batch": 3, "steps": 4, "check": {"rows": 2}, "trace": {"skip_calls": 1, "calls": 2}},
    "edit": {"shapes": 4, "latent_steps": 4, "chain_steps": 10, "w_time": 6, "edit_steps": 3,
             "feat_layer": 1, "r1": 2, "shape_resolution": 32, "inversion_group": 2,
             "inversion_chunk": 2, "check": {"rows": 2}, "trace": {"skip_steps": 1, "steps": 1}},
}


def benchmark() -> dict:
    """``BENCHMARK.json`` with the cells held out (``held_out/<cell>.json``)
    added back."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    for path in sorted(glob.glob(os.path.join(HERE, "held_out", "*.json"))):
        held = load_json(path)
        for key in ("workloads", "end_to_end", "per_layer"):
            bench[key] = bench[key] + held[key]
    return bench


CELLS = [w["name"] for w in benchmark()["workloads"]]  # held-out cells too


def mini(cell: str, limits=None, dtype=None) -> CellSpec:
    """The cell (of ``benchmark()``) at miniature size (both precisions as
    the configuration states them)."""
    spec = load(cell, benchmark())
    spec = dataclasses.replace(spec, config=copy.deepcopy(spec.config), traffic=copy.deepcopy(spec.traffic))
    by_count = spec.config["num_head_channels"] == -1
    spec.config.update(MINI_ARCH)
    spec.config.update(MINI_PLANES.get(spec.config["num_planes"], {}))
    if by_count:  # heads by count: 2 heads of 32 channels at 8x8
        spec.config.update(num_heads=2, num_head_channels=-1)
    kind = spec.traffic["kind"]
    spec.traffic.update(MINI_TRAFFIC[kind])
    if kind == "edit":
        spec.traffic["remat"] = "on"
    if dtype is not None:  # the torso's and the feature cache's dtype
        spec.config.update(compute_dtype=dtype, feat_store_dtype=dtype)
    if limits is not None:
        spec.traffic["limits"] = limits
    return spec
