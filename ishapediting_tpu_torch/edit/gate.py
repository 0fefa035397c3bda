"""The toy edit-gate pipeline and its committed weights.

``tests/assets/edit_gate.npz`` holds a small trained sphere-with-bumps
system (UNet EMA weights ``ema::<module>::<leaf>``, decoder weights
``dec::...``, normalization statistics, the first training latent) and the
numbers of the fixed-seed replay-mode drag it was validated with
(``eval_seed``, ``scale``, ``cof``, ``achieved_reduction``, ...). The gate
inverts ``latent0`` with the forward noises those numbers were recorded
with (the JAX package's draws at ``eval_seed``; other draws give another
trajectory, on which the recorded reduction does not hold), then runs a
scale-0 and a guided replay drag of the rightmost vertex by +0.25 in x, and
asks that the guided run end with a motion loss at least half the recorded
reduction below the scale-0 run.

``toy_config`` is the port's copy of the configuration those weights were
trained for (the JAX package's ``tools/make_edit_gate_asset.py``).
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from ishapediting_tpu_torch.config import (
    DiffusionConfig,
    EditConfig,
    FitConfig,
    PipelineConfig,
    UNetConfig,
)

PLANE_RES, PLANE_CH = 16, 8
DEC_MAPPING, DEC_HIDDEN = 16, 64
ASSET = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "tests", "assets", "edit_gate.npz",
)


def toy_config() -> PipelineConfig:
    return PipelineConfig(
        unet=UNetConfig(
            image_size=PLANE_RES,
            in_channels=3 * PLANE_CH,
            model_channels=32,
            out_channels=6 * PLANE_CH,
            num_res_blocks=1,
            attention_ds=(4,),
            channel_mult=(1, 2),
            num_head_channels=16,
            dropout=0.0,
            compute_dtype="float32",
        ),
        diffusion=DiffusionConfig(base_steps=100, timestep_respacing="25"),
        edit=EditConfig(w_time=12, feat_layer=1, shape_resolution=48, r1=5,
                        feat_store_dtype="float32"),
        fit=FitConfig(points_size=10_000, batch_points=2_000),
        plane_channels=PLANE_CH,
    )


def unflatten(npz, base: str) -> Dict:
    """``base::a::b`` keys of an npz -> nested dict {a: {b: array}}."""
    out: Dict = {}
    for key in npz.files:
        if not key.startswith(base + "::"):
            continue
        node = out
        parts = key.split("::")[1:]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(npz[key])
    return out


def engine_from_asset(path: str = ASSET, device=None) -> Tuple["DragEngine", Dict]:  # noqa: F821
    """The toy ``DragEngine`` with the asset's weights and statistics, and
    the asset's scalars as a dict."""
    from ishapediting_tpu_torch.edit.engine import DragEngine
    from ishapediting_tpu_torch.io.convert import decoder_state_dict_from_jax, unet_state_dict_from_jax
    from ishapediting_tpu_torch.io.model_dir import TriplaneStats
    from ishapediting_tpu_torch.models.unet import UNetModel
    from ishapediting_tpu_torch.ops.triplane import TriplaneDecoder

    npz = np.load(path)
    cfg = toy_config()
    unet = UNetModel(cfg.unet)
    unet.load_state_dict(unet_state_dict_from_jax(unflatten(npz, "ema")), strict=True)
    dec = TriplaneDecoder(PLANE_CH, mapping=DEC_MAPPING, hidden=DEC_HIDDEN)
    dec.load_state_dict(decoder_state_dict_from_jax(unflatten(npz, "dec")), strict=True)
    stats = TriplaneStats(half_range=np.asarray(npz["half_range"]), middle=np.asarray(npz["middle"]))
    engine = DragEngine(cfg, unet=unet, decoder=dec, stats=stats, device=device)
    return engine, {k: np.asarray(npz[k]) for k in npz.files if "::" not in k}


def recorded_inversion_noises(engine, asset: Dict):
    """The forward noises of the inversion the asset's numbers were
    recorded with, ``normal(fold_in(PRNGKey(eval_seed), t))`` of the JAX
    package, t ascending (recomputed by ``utils/threefry.py``)."""
    from ishapediting_tpu_torch.utils import threefry

    key = threefry.prng_key(int(asset["eval_seed"]))
    shape = (1,) + engine.config.latent_shape
    return [threefry.normal(threefry.fold_in(key, t), shape) for t in range(engine.config.edit.w_time)]


def gate_drags(engine, asset: Dict, noises=None, chunk: int = 4):
    """The gate's runs on ``engine``: inversion of ``latent0`` with
    ``noises`` (its forward noises, t ascending; default the recorded ones),
    then the scale-0 and the guided replay drag. Returns (per-step motion
    losses of the scale-0 run, those of the guided run, the original mesh,
    the edited mesh)."""
    seed = int(asset["eval_seed"])
    if noises is None:
        noises = recorded_inversion_noises(engine, asset)
    engine.latent_inversion(asset["latent0"][None], seed=seed, noises=noises)
    original = engine.mesh0
    if len(original.vertices) == 0:
        raise RuntimeError("inversion replay produced an empty mesh")
    handle = original.vertices[np.argmax(original.vertices[:, 0])].astype(np.float32)
    target = handle + np.array([0.25, 0, 0], np.float32)
    engine.drag_edit(handle[None], target[None], scale=0.0, cof=0.0, seed=seed,
                     chunk=chunk, noise_mode="replay")
    base = engine.last_drag_losses["motion"].copy()
    edited = engine.drag_edit(handle[None], target[None], scale=float(asset["scale"]),
                              cof=float(asset["cof"]), seed=seed, chunk=chunk, noise_mode="replay")
    return base, engine.last_drag_losses["motion"].copy(), original, edited
