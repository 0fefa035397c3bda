"""Batch triplane generation CLI (reference: generate.py + image_sample.py).

    python -m ishapediting_tpu_torch.cli.generate --random_init --preset chairs \
        --use_ddim --num_steps 50 --num_samples 8 --batch_size 8 \
        --shape_resolution 256 --save_dir samples/chairs

Outputs match the reference contract: ``<save_dir>/triplanes/{i}.npy``
([C, H, W] float32, physical scale) and ``<save_dir>/objects/{i}.obj``;
``--save_npz`` adds one ``samples_NxHxWxC.npz`` batch file and
``--save_intermediate 0,5,9`` the post-step latents at those loop indices
(``intermediate_tensors/<i>_it<step>.npy``, NCHW, physical scale).
Runs on CUDA unless ``--device cpu``; ``--random_init`` runs the published
architecture with random weights (no checkpoints needed). Seeds give other
shapes than the JAX package's CLI: the random streams differ.

Under ``torchrun`` every batch splits over the largest number of ranks that
divides ``--batch_size`` (``parallel/sampling.py``; the samples equal a
one-rank run's) and rank 0 writes the triplanes; ranks that share one card
need ``--dist_backend gloo``::

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m ishapediting_tpu_torch.cli.generate --random_init --preset tiny \
        --device cpu --dist_backend gloo --num_samples 4 --batch_size 2 \
        --sharded_decode --save_dir samples/tiny
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Generate triplane samples and decode them to meshes")
    p.add_argument("--model_dir", type=str, default=None,
                   help="category dir (ddpm ckpt + decoder + statistics)")
    p.add_argument("--random_init", action="store_true",
                   help="random weights (no checkpoints needed)")
    p.add_argument("--preset", type=str, default="chairs",
                   help="chairs|cars|planes|tiny (tiny = CPU smoke config)")
    p.add_argument("--num_samples", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--num_steps", type=int, default=256)
    p.add_argument("--use_ddim", action="store_true")
    p.add_argument("--use_dpm", action="store_true",
                   help="DPM-Solver++(2M) on a log-SNR-uniform grid")
    p.add_argument("--shape_resolution", type=int, default=256)
    p.add_argument("--sharded_decode", action="store_true",
                   help="with several ranks, each rank decodes, marches and writes its own "
                        "grids, one per rank at a time (parallel.decode.decode_grids_batched); "
                        "without it, or with one usable rank, rank 0 decodes every sample in "
                        "turn, as the reference does (generate.py:89-98)")
    p.add_argument("--save_npz", action="store_true",
                   help="also save one samples_NxHxWxC.npz batch file (image_sample.py contract)")
    p.add_argument("--save_intermediate", type=str, default=None,
                   help="comma-separated loop indices at which to keep the per-step latents "
                        "(reference save_intermediate, image_sample.py:70-102), e.g. '0,100,199'")
    p.add_argument("--save_dir", type=str, default="samples/out")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--skip_decode", action="store_true")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dist_backend", type=str, default=None, choices=["nccl", "gloo"],
                   help="process-group backend under torchrun (default: nccl on cuda, gloo on "
                        "cpu); ranks that share one card need gloo")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    snapshot_steps = None
    if args.save_intermediate:
        snapshot_steps = tuple(int(s) for s in args.save_intermediate.split(",") if s != "")
        if args.use_dpm:
            raise SystemExit("--save_intermediate is not supported with --use_dpm "
                             "(the snapshot loop covers ddpm/ddim only)")
    from ishapediting_tpu_torch.config import preset
    from ishapediting_tpu_torch.edit.engine import DragEngine
    from ishapediting_tpu_torch.parallel import mesh as pmesh
    from ishapediting_tpu_torch.parallel.sampling import plan_data_mesh, sample_batches

    if pmesh.launched():
        pmesh.initialize_distributed(args.dist_backend, device=args.device)
    mesh, usable = plan_data_mesh(args.batch_size, device=args.device)
    config = preset(args.preset, args.num_steps, use_ddim=args.use_ddim)
    if args.use_dpm:
        config = config.with_dpm(min(args.num_steps, config.diffusion.base_steps))
    if args.model_dir:
        engine = DragEngine.from_model_dir(args.model_dir, config=config, device=mesh.device)
    elif args.random_init:
        engine = DragEngine(config, seed=args.seed, device=mesh.device)
    else:
        raise SystemExit("need --model_dir or --random_init")
    lead = mesh.rank == 0
    if usable > 1:
        t0 = time.time()
        pmesh.replicate(engine.unet, mesh)
        pmesh.replicate(engine.decoder, mesh)
        engine._sync()
        print(f"rank {mesh.rank}: {usable} of {pmesh.world()[0]} ranks sample; weights broadcast from "
              f"rank 0 in {round(time.time() - t0, 4)} s")
    if args.use_dpm and lead:
        # duplicate log-SNR snaps collapse near the base step count
        requested = min(args.num_steps, config.diffusion.base_steps)
        print(f"dpm respacing: requested {requested} steps, realized {engine.sched.num_timesteps}")

    os.makedirs(f"{args.save_dir}/triplanes", exist_ok=True)
    t1 = time.time()
    if snapshot_steps is not None:
        samples, snapshots = _sample_with_snapshots(engine, args, snapshot_steps, mesh, usable)
    else:
        samples = sample_batches(
            engine.sched,
            engine.model_fn(feat=False),
            num_samples=args.num_samples,
            batch_size=args.batch_size,
            latent_shape=config.latent_shape,
            seed=args.seed,
            sampler="dpm" if args.use_dpm else ("ddim" if args.use_ddim else "ddpm"),
            clip_denoised=config.diffusion.clip_denoised,
            mesh=mesh,
            usable=usable,
        )
    t2 = time.time()
    print("ddpm time:", round(t2 - t1, 4))

    if lead:
        _write_samples(engine, args, samples, snapshots if snapshot_steps else None, snapshot_steps)
    if not args.skip_decode:
        os.makedirs(f"{args.save_dir}/objects", exist_ok=True)
        done = 0
        if args.sharded_decode and usable > 1:
            done = _decode_sharded(engine, args, samples, mesh, usable)
        if lead:
            for idx in range(done, samples.shape[0]):
                print(f"Decoding triplane {idx}...")
                mesh_out = engine.get_mesh(torch.from_numpy(samples[idx][None]), smooth=0,
                                           res=args.shape_resolution)
                mesh_out.write(f"{args.save_dir}/objects/{idx}.obj")
        print("Done!")
        print("decode time:", round(time.time() - t2, 4))
    pmesh.barrier()
    return samples


def _write_samples(engine, args, samples, snapshots, snapshot_steps):
    """The triplanes ``{i}.npy``, the ``.npz`` and the intermediates, in
    physical scale and NCHW as the reference saves them."""
    phys = samples * engine.stats.half_range + engine.stats.middle
    if args.save_npz:  # the FID-style batch file (reference: image_sample.py:120-130)
        shape_str = "x".join(str(d) for d in phys.shape)
        np.savez(os.path.join(args.save_dir, f"samples_{shape_str}.npz"), phys)
        print(f"saved samples_{shape_str}.npz")
    for idx in range(phys.shape[0]):
        np.save(f"{args.save_dir}/triplanes/{idx}.npy", phys[idx].transpose(2, 0, 1).astype(np.float32))
        print(f"saving to {args.save_dir}/triplanes/{idx}.npy...")
    if snapshot_steps:
        # reference contract: intermediate_tensors/<obj>_it<idx>.npy, NCHW,
        # physical scale (image_sample.py:94-102)
        os.makedirs(f"{args.save_dir}/intermediate_tensors", exist_ok=True)
        snaps = snapshots * engine.stats.half_range + engine.stats.middle
        for k, step_idx in enumerate(snapshot_steps):
            for obj in range(snaps.shape[1]):
                np.save(f"{args.save_dir}/intermediate_tensors/{obj}_it{step_idx}.npy",
                        snaps[k, obj].transpose(2, 0, 1).astype(np.float32))
        print(f"saved {len(snapshot_steps)}x{snaps.shape[1]} intermediate tensors")


def _decode_sharded(engine, args, samples, mesh, usable) -> int:
    """Whole groups of ``usable`` samples, one grid per rank of the data axis
    at a time: each rank decodes, marches and writes its own. Returns how
    many samples the groups covered (the rest go to rank 0 one by one)."""
    from ishapediting_tpu_torch.edit.fit import latents_to_planes
    from ishapediting_tpu_torch.parallel.decode import decode_grids_batched

    k = (samples.shape[0] // usable) * usable
    if not mesh.active:
        return k
    for g0 in range(0, k, usable):
        lat = torch.as_tensor(samples[g0 : g0 + usable], device=engine.device)
        planes = latents_to_planes(lat, engine.half_range, engine.middle)
        grids = decode_grids_batched(engine.decoder, planes, mesh, res=args.shape_resolution,
                                     out_dtype=torch.float16)  # get_mesh's grid
        for j, grid in enumerate(grids):
            idx = g0 + mesh.rows(usable).start + j
            print(f"Decoding triplane {idx}...")
            engine.march_grid(grid).write(f"{args.save_dir}/objects/{idx}.obj")
    return k


def _sample_with_snapshots(engine, args, snapshot_steps, mesh, usable):
    """``sample_batches``'s batches and draws (x_T, then the step noise, from
    a generator seeded with ``seed + batch``), through the snapshot loop on
    rank 0 alone: the same samples a plain run gives, on every rank, and
    their intermediates [K, N, H, W, C] on rank 0 (None elsewhere)."""
    from ishapediting_tpu_torch.core.diffusion import p_sample_loop_snapshots
    from ishapediting_tpu_torch.parallel.mesh import broadcast_flat, world
    from ishapediting_tpu_torch.parallel.sampling import batch_plan

    shape = (args.num_samples,) + engine.config.latent_shape
    if mesh.rank != 0:
        samples = torch.empty(shape, device=engine.device)
        broadcast_flat([samples])
        return samples.cpu().numpy(), None
    samples, snapshots = [], []
    with torch.no_grad():
        plan = batch_plan(args.num_samples, args.batch_size, usable, mesh.size)
        for batch_idx, (n, _) in enumerate(plan):
            gen = torch.Generator(device=engine.device).manual_seed(args.seed + batch_idx)
            x_T = torch.randn((n,) + engine.config.latent_shape, generator=gen, device=engine.device)
            out = p_sample_loop_snapshots(
                engine.sched, engine.model_fn(feat=False), x_T, gen, snapshot_steps=snapshot_steps,
                use_ddim=args.use_ddim, clip_denoised=engine.config.diffusion.clip_denoised,
            )
            samples.append(out["sample"])
            snapshots.append(out["snapshots"].cpu().numpy())
    samples = torch.cat(samples)
    if world()[0] > 1:
        broadcast_flat([samples])
    return samples.cpu().numpy(), np.concatenate(snapshots, axis=1)


if __name__ == "__main__":
    main()
