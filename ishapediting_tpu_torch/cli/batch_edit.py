"""Batched multi-shape drag editing from the command line.

N shapes, real meshes or generated seeds, go through fit -> inversion ->
drag with one batch-N UNet forward per step (``edit/batch.py``), then are
meshed on the host one by one.

Examples (on the card unless ``--device cpu``)::

    # the same drag on 4 generated shapes
    python -m ishapediting_tpu_torch.cli.batch_edit --random_init --preset chairs \
        --latent_seed 1 --latent_seed 2 --latent_seed 3 --latent_seed 4 \
        --source 0.1 0.2 0.3 --target 0.1 0.5 0.3 --out edited/

    # N real meshes, per-shape edits from an EditLog (edit ids in order)
    python -m ishapediting_tpu_torch.cli.batch_edit --model_dir models/chairs \
        --mesh a.obj --mesh b.obj --edit_log EditLog --out edited/

    # CPU smoke
    python -m ishapediting_tpu_torch.cli.batch_edit --random_init --preset tiny \
        --latent_seed 1 --latent_seed 2 --source 0.2 0 0 --target 0.4 0 0 \
        --device cpu --out /tmp/batch_out

Under ``torchrun`` the shapes split over the largest number of ranks that
divides N (one shape per rank at N = ranks): each rank fits, inverts and
drags its shapes and writes their meshes, with each shape's draws those of
its index, so the results equal a one-rank run's; rank 0 writes the EditLog.
Ranks that share one card need ``--dist_backend gloo``. Seeds give other
shapes than the JAX package's CLI: the random streams differ.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Batched drag editing")
    p.add_argument("--model_dir", type=str, default=None)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--preset", type=str, default="chairs")
    p.add_argument("--num_steps", type=int, default=200)
    p.add_argument("--w_time", type=int, default=None,
                   help="edit window in respaced steps (default: the preset's; a chain shorter "
                        "than the preset's window needs a shorter one)")
    p.add_argument("--mesh", type=str, action="append", default=[], help="real mesh path (repeatable)")
    p.add_argument("--latent_seed", type=int, action="append", default=[],
                   help="generate a shape from this seed (repeatable)")
    p.add_argument("--source", type=float, nargs=3, action="append", default=[])
    p.add_argument("--target", type=float, nargs=3, action="append", default=[])
    p.add_argument("--edit_log", type=str, default=None,
                   help="per-shape edits: the log's edit ids, sorted, map to shape order")
    p.add_argument("--scale", type=float, default=600.0)
    p.add_argument("--lam", type=float, default=0.2)
    p.add_argument("--edit_steps", type=int, default=None,
                   help="fast editing: respace the w_time edit window to this many guided steps "
                        "(forces resample noise); default: the full walk")
    p.add_argument("--fit_steps", type=int, default=None,
                   help="fast fitting: respace the batched guided fit to this many steps; "
                        "default: the full chain")
    p.add_argument("--noise_mode", type=str, default="replay",
                   choices=["replay", "fixed_variance", "resample"],
                   help="inversion-anchored replay (default) or fresh noise")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default="edited_batch")
    p.add_argument("--remat", type=str, default="auto", choices=("auto", "on", "off"),
                   help="recompute the UNet's blocks in the backward of the batched drag and "
                        "fit: 'auto' turns it on when more than 8 shapes share the device "
                        "(activation memory grows with the shapes per device)")
    p.add_argument("--feat_dtype", type=str, default=None, choices=["float32", "bfloat16"],
                   help="guidance-feature cache dtype; default: keep the config's")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--dist_backend", type=str, default=None, choices=["nccl", "gloo"],
                   help="process-group backend under torchrun (default: nccl on cuda, gloo on "
                        "cpu); ranks that share one card need gloo")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ishapediting_tpu_torch.cli.edit import parse_edit_log, write_edit_log
    from ishapediting_tpu_torch.config import preset, with_feat_store_dtype
    from ishapediting_tpu_torch.edit.batch import (
        build_batched_problems,
        drag_edit_batched,
        fit_real_shapes_batched,
        invert_batched,
    )
    from ishapediting_tpu_torch.edit.engine import DragEngine
    from ishapediting_tpu_torch.geometry.mesh import TriMesh
    from ishapediting_tpu_torch.parallel import mesh as pmesh
    from ishapediting_tpu_torch.parallel.sampling import sample_sharded

    if bool(args.mesh) == bool(args.latent_seed):
        raise SystemExit("give either --mesh ... or --latent_seed ... (>= 1)")
    n = len(args.mesh) or len(args.latent_seed)
    if args.edit_log:
        log = parse_edit_log(args.edit_log)
        ids = sorted(log)
        if len(ids) < n:
            raise SystemExit(f"EditLog has {len(ids)} edits for {n} shapes")
        specs = [log[ids[i]] for i in range(n)]
    else:
        if not args.source or len(args.source) != len(args.target):
            raise SystemExit("need matching --source/--target or --edit_log")
        shared = {"sources": np.asarray(args.source, np.float32),
                  "targets": np.asarray(args.target, np.float32),
                  "scale": args.scale, "lam": args.lam}
        specs = [shared] * n
    scales = np.asarray([float(s["scale"]) for s in specs], np.float32)
    lams = np.asarray([float(s["lam"]) for s in specs], np.float32)

    if not (args.model_dir or args.random_init):
        raise SystemExit("need --model_dir or --random_init")
    if pmesh.launched():
        pmesh.initialize_distributed(args.dist_backend, device=args.device)
    # the data axis: the largest rank count that divides n
    n_world, _ = pmesh.world()
    data = max(d for d in range(1, min(n, n_world) + 1) if n % d == 0)
    mesh = pmesh.make_mesh(data, device=args.device)
    if not mesh.active:
        pmesh.barrier()
        return None
    config = with_feat_store_dtype(preset(args.preset, args.num_steps), args.feat_dtype)
    if args.w_time is not None:
        config = dataclasses.replace(config, edit=dataclasses.replace(config.edit, w_time=args.w_time))
    if args.model_dir:
        engine = DragEngine.from_model_dir(args.model_dir, config=config, device=mesh.device)
    else:
        engine = DragEngine(config, seed=args.seed, device=mesh.device)
    pmesh.replicate(engine.unet, mesh)
    pmesh.replicate(engine.decoder, mesh)
    os.makedirs(args.out, exist_ok=True)
    if data > 1:
        print(f"{n} shapes over a data axis of {data} ranks (rank {mesh.rank})")
    else:
        print(f"{n} shapes on one {engine.device.type} device")
    # activation memory of the batched forward + backward grows with the
    # shapes per device; the engine's default (off) is a batch-1 choice
    per = n // data
    use_remat = engine.remat or per > 8 if args.remat == "auto" else args.remat == "on"
    if use_remat != engine.remat:
        print(f"remat={'on' if use_remat else 'off'} for the batched programs ({per} shapes/device)")
    mf = engine.model_fn(feat=True, remat=use_remat)
    mf_plain = engine.model_fn(feat=False, remat=use_remat)
    clip = config.diffusion.clip_denoised
    gen = engine._generator
    walls = {}

    # --- latents: fit real meshes or sample from seeds --------------------
    t0 = time.perf_counter()
    if args.mesh:
        meshes = [TriMesh.read(m).normalize_unit_cube() for m in args.mesh]
        sched_fit = engine.sched
        if args.fit_steps is not None and args.fit_steps < engine.sched.num_timesteps:
            sched_fit = engine._fit_schedule(args.fit_steps)
            print(f"fast fitting: {sched_fit.num_timesteps} of {engine.sched.num_timesteps} guided steps")
        print("fitting meshes to triplanes (batched classifier guidance) ...")
        latents = fit_real_shapes_batched(
            sched_fit, mf_plain, engine.decoder, meshes, engine.half_range, engine.middle,
            gen(args.seed), latent_shape=config.latent_shape, fit_cfg=config.fit, seed=args.seed,
            clip_denoised=clip, mesh=mesh,
        )
    else:
        print("sampling latents (batched) ...")
        x_T = torch.cat([torch.randn((1,) + config.latent_shape, generator=gen(s), device=engine.device)
                         for s in args.latent_seed])
        latents = sample_sharded(engine.sched, mf_plain, mesh, batch_size=n, latent_shape=config.latent_shape,
                                 generator=gen(args.seed + 1), sampler="ddpm", clip_denoised=clip, x_T=x_T)
    engine._sync()
    walls["latents_s"] = time.perf_counter() - t0

    # --- inversion (batched) ----------------------------------------------
    print("edit-friendly inversion (batched) ...")
    t0 = time.perf_counter()
    inv = invert_batched(engine.sched, mf, latents, gen(args.seed + 2), w_time=config.edit.w_time,
                         clip_denoised=clip, feat_dtype=getattr(torch, config.edit.feat_store_dtype),
                         mesh=mesh)
    engine._sync()
    walls["inversion_s"] = time.perf_counter() - t0

    # --- drag (batched) -----------------------------------------------------
    problems = build_batched_problems(
        [s["sources"] for s in specs], [s["targets"] for s in specs], r1=config.edit.r1,
        voxel_size=config.edit.voxel_size, feat_width=inv["features"].shape[-2], device=engine.device,
    )
    sched_drag, positions = engine.sched, None
    noise_mode = args.noise_mode
    if args.edit_steps is not None and args.edit_steps < config.edit.w_time:
        sched_drag, positions = engine._fast_edit_schedule(args.edit_steps)
        noise_mode = "resample"  # recorded noise belongs to the full grid
        print(f"fast editing: {args.edit_steps} of {config.edit.w_time} guided steps (noise_mode=resample)")
    print(f"dragging {n} shapes ({noise_mode}) ...")
    t0 = time.perf_counter()
    edited = drag_edit_batched(
        sched_drag, mf, inv["w"], inv["features"], problems,
        [gen(args.seed + 3 + i) for i in range(n)], w_time=config.edit.w_time, scale=scales, cof=lams,
        clip_denoised=clip, noise_mode=noise_mode,
        variances_batch=None if positions is not None else inv["variances"],
        variance_noise_batch=None if positions is not None else inv["variance_noise"],
        edit_positions=positions, mesh=mesh,
    )
    engine._sync()
    walls["drag_s"] = time.perf_counter() - t0

    # --- decode + write: each rank its own shapes, rank 0 the EditLog --------
    t0 = time.perf_counter()
    for i in range(n)[mesh.rows(n)]:
        engine.get_mesh(latents[i : i + 1]).write(os.path.join(args.out, f"original{i + 1:02d}.obj"))
        m = engine.get_mesh(edited[i])
        out_path = os.path.join(args.out, f"edit{i + 1:02d}.obj")
        m.write(out_path)
        print(f"  wrote {out_path} ({len(m.vertices)} verts)")
    if mesh.rank == 0:
        for i in range(n):
            write_edit_log(os.path.join(args.out, "EditLog"), f"{i + 1:02d}", specs[i]["sources"],
                           specs[i]["targets"], float(specs[i]["scale"]), float(specs[i]["lam"]))
    pmesh.barrier()
    walls["mesh_s"] = time.perf_counter() - t0
    print("walls " + " ".join(f"{k}={v:.3f}" for k, v in walls.items()))
    return {"engine": engine, "latents": latents, "inversion": inv, "problems": problems,
            "edited": edited, "noise_mode": noise_mode, "remat": use_remat, "walls": walls}


if __name__ == "__main__":
    main()
