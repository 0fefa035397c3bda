"""Latent-space shape morphing from the command line.

    python -m ishapediting_tpu_torch.cli.morph --random_init --preset chairs \
        --seed_a 3 --seed_b 7 --frames 5 --out morphs/

Each endpoint is a generated shape (``--seed_a``/``--seed_b``) or a saved
physical triplane ``.npy`` (``--tri_a``/``--tri_b``, the layouts of
``io/planes.py``). Both endpoints DDIM-encode as one batch-2 walk, are
interpolated with slerp, and all frames decode as one batch-K walk
(``edit/morph.py``). Writes ``frame_kk.obj`` meshes and ``latents.npy``
([K, H, W, C] normalized). Runs on CUDA unless ``--device cpu``. Under
``torchrun``, when the frame count divides by the ranks, each rank decodes
and meshes its own frames (one per rank at K = ranks) and rank 0 writes
``latents.npy``; otherwise rank 0 morphs alone. Ranks that share one card
need ``--dist_backend gloo``. Seeds give other shapes than the JAX
package's CLI: the random streams differ.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Morph between two shapes through the diffusion noise space")
    p.add_argument("--model_dir", type=str, default=None)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--preset", type=str, default="chairs")
    p.add_argument("--num_steps", type=int, default=200)
    p.add_argument("--seed_a", type=int, default=None, help="generate endpoint A from this latent seed")
    p.add_argument("--seed_b", type=int, default=None)
    p.add_argument("--tri_a", type=str, default=None,
                   help="endpoint A from a physical triplane .npy")
    p.add_argument("--tri_b", type=str, default=None)
    p.add_argument("--frames", type=int, default=5)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--shape_resolution", type=int, default=None,
                   help="mesh grid resolution (default: the preset's)")
    p.add_argument("--smooth", type=int, default=10)
    p.add_argument("--skip_decode", action="store_true", help="write latents.npy only")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dist_backend", type=str, default=None, choices=["nccl", "gloo"],
                   help="process-group backend under torchrun (default: nccl on cuda, gloo on "
                        "cpu); ranks that share one card need gloo")
    return p


def endpoint_latent(engine, seed, tri_path, which: str) -> np.ndarray:
    """A normalized latent [1, H, W, C] (seed) or [H, W, C] (triplane)."""
    from ishapediting_tpu_torch.io.planes import load_planes

    if (seed is None) == (tri_path is None):
        raise SystemExit(f"give exactly one of --seed_{which} / --tri_{which}")
    if seed is not None:
        return engine.sample_latent(seed=seed)  # no feature cache: morphing does not edit
    try:
        planes = load_planes(tri_path)  # [3, H, W, C]
    except ValueError as exc:
        raise SystemExit(str(exc)) from exc
    h, w = planes.shape[1:3]
    phys = planes.transpose(1, 2, 0, 3).reshape(h, w, -1)  # [H, W, 3C]
    half = np.asarray(engine.stats.half_range, np.float32)
    mid = np.asarray(engine.stats.middle, np.float32)
    return (phys - mid) / np.where(half == 0, 1.0, half)


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ishapediting_tpu_torch.config import preset
    from ishapediting_tpu_torch.edit.engine import DragEngine
    from ishapediting_tpu_torch.parallel import mesh as pmesh

    if pmesh.launched():
        pmesh.initialize_distributed(args.dist_backend, device=args.device)
    n_world, _ = pmesh.world()
    # one frame trajectory per rank where the frames divide; else rank 0 alone
    mesh = pmesh.make_mesh(n_world if args.frames % n_world == 0 else 1, device=args.device)
    if not (args.model_dir or args.random_init):
        raise SystemExit("need --model_dir or --random_init")
    if not mesh.active:
        pmesh.barrier()
        return None, None
    config = preset(args.preset, args.num_steps)
    if args.model_dir:
        engine = DragEngine.from_model_dir(args.model_dir, config=config, device=mesh.device)
    else:
        engine = DragEngine(config, seed=args.seed, device=mesh.device)
    pmesh.replicate(engine.unet, mesh)
    pmesh.replicate(engine.decoder, mesh)

    lat_a = endpoint_latent(engine, args.seed_a, args.tri_a, "a")
    lat_b = endpoint_latent(engine, args.seed_b, args.tri_b, "b")
    t0 = time.time()
    latents = engine.morph(lat_a, lat_b, n=args.frames, mesh=mesh)
    print(f"morphed {args.frames} frames (batched encode+decode"
          + (f", over {mesh.size} ranks" if mesh.size > 1 else "")
          + f", {round(time.time() - t0, 3)}s)")

    os.makedirs(args.out, exist_ok=True)
    if mesh.rank == 0:
        np.save(os.path.join(args.out, "latents.npy"), latents)
    if not args.skip_decode:
        for k in range(latents.shape[0])[mesh.rows(latents.shape[0])]:
            mesh_k = engine.get_mesh(latents[k][None], smooth=args.smooth, res=args.shape_resolution)
            path = os.path.join(args.out, f"frame_{k:02d}.obj")
            mesh_k.write(path)
            print(f"wrote {path} ({len(mesh_k.vertices)} verts)")
    pmesh.barrier()
    return engine, latents


if __name__ == "__main__":
    main()
