"""Write ``tests/assets/orbax/``: what the JAX package writes with orbax, for
the port's orbax reader (``ishapediting_tpu_torch/io/orbax.py``) to read on
a machine without JAX, orbax or tensorstore.

    env JAX_PLATFORMS=cpu python tests/assets/make_orbax_assets.py

Writes, from the JAX package on the CPU:

- ``model/``: a ``preset("tiny")`` model dir as ``cli.train
  --export_model_dir`` writes it: ``unet.orbax`` and ``decoder.orbax``
  (``io/checkpoint.py::save_params``; every UNet weight random from numpy,
  the ADM init's zeroed ones too, so that a sample carries signal) and
  identity ``statistics/``;
- ``jax_ddim.npz``: ``x_T`` (batch 2) and JAX's DDIM-10 latents from it on
  that dir's UNet;
- ``train/step_3``: the train state ``train/loop.py::train`` saves after 3
  steps of the tiny preset on synthetic latents (``TrainState(step, params,
  ema_params, opt_state)``, optax ``chain(clip_by_global_norm, adamw)``);
- ``sha256.json``: the SHA-256 of every leaf as ``load_params`` restores it
  (its bytes, C order), by path, with its dtype and shape.

Not run by the tests: its output is committed.
"""

import hashlib
import json
import os
import shutil
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from ishapediting_tpu.config import preset  # noqa: E402
from ishapediting_tpu.core import diffusion  # noqa: E402
from ishapediting_tpu.core.schedule import make_schedule  # noqa: E402
from ishapediting_tpu.edit.engine import DragEngine  # noqa: E402
from ishapediting_tpu.io.checkpoint import load_params, save_params  # noqa: E402
from ishapediting_tpu.models.unet import init_unet_params  # noqa: E402
from ishapediting_tpu.ops.triplane import init_decoder_params  # noqa: E402
from ishapediting_tpu.train.loop import train  # noqa: E402

OUT = os.path.join(ROOT, "tests", "assets", "orbax")


def signal_params(params, seed):
    """``params`` with every leaf drawn from numpy (weights scaled by fan-in)."""
    rng = np.random.default_rng(seed)
    out = {}
    for prefix, leaves in params.items():
        entry = {}
        for leaf, arr in leaves.items():
            if leaf == "w":
                v = rng.normal(size=arr.shape) / np.sqrt(int(np.prod(arr.shape[:-1])))
            elif leaf == "scale":
                v = 1.0 + 0.1 * rng.normal(size=arr.shape)
            else:
                v = 0.1 * rng.normal(size=arr.shape)
            entry[leaf] = jnp.asarray(v.astype(np.float32))
        out[prefix] = entry
    return out


def leaf_hashes(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arr = np.ascontiguousarray(np.asarray(leaf))
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        out[key] = {"sha256": hashlib.sha256(arr.tobytes()).hexdigest(), "dtype": str(arr.dtype),
                    "shape": list(arr.shape)}
    return out


def main():
    shutil.rmtree(OUT, ignore_errors=True)
    cfg = preset("tiny", 10, use_ddim=True)
    model = os.path.join(OUT, "model")
    unet = signal_params(init_unet_params(jax.random.PRNGKey(0), cfg.unet), seed=1)
    save_params(os.path.join(model, "unet.orbax"), unet)
    save_params(os.path.join(model, "decoder.orbax"),
                init_decoder_params(jax.random.PRNGKey(2), in_channels=cfg.plane_channels))
    ident = os.path.join(model, "statistics", "identity")
    os.makedirs(ident)
    channels = cfg.latent_shape[-1]
    np.save(os.path.join(ident, "lower_bound.npy"), np.full(channels, -1.0, np.float32))
    np.save(os.path.join(ident, "upper_bound.npy"), np.full(channels, 1.0, np.float32))

    engine = DragEngine.from_model_dir(model, config=cfg)
    x_T = np.random.default_rng(3).normal(size=(2,) + cfg.latent_shape).astype(np.float32)
    ddim = diffusion.ddim_sample_loop(engine.sched, engine._model_fn(False), jnp.asarray(x_T),
                                      jax.random.PRNGKey(4), clip_denoised=cfg.diffusion.clip_denoised)
    np.savez(os.path.join(OUT, "jax_ddim.npz"), x_T=x_T, ddim=np.asarray(ddim))

    rng = np.random.default_rng(5)
    data = np.clip(rng.standard_normal((4,) + cfg.latent_shape), -1, 1).astype(np.float32)

    def batches():
        while True:
            yield data[rng.integers(0, 4, 2)]

    sched = make_schedule(cfg.diffusion.base_steps, cfg.diffusion.noise_schedule, "")
    train(cfg.unet, sched, signal_params(init_unet_params(jax.random.PRNGKey(6), cfg.unet), seed=7), batches(),
          total_steps=3, ckpt_dir=os.path.join(OUT, "train"), ckpt_every=3, log_every=100, seed=8)

    hashes = {}
    for name in ("model/unet.orbax", "model/decoder.orbax", "train/step_3"):
        hashes[name] = leaf_hashes(load_params(os.path.join(OUT, name)))
    with open(os.path.join(OUT, "sha256.json"), "w") as f:
        json.dump(hashes, f, indent=1, sort_keys=True)
    total = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(OUT) for n in ns)
    print(f"wrote {OUT}: {total} bytes")


if __name__ == "__main__":
    main()
