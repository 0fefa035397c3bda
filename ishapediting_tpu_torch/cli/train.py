"""Training CLI: train or fine-tune a triplane DDPM on a directory of
triplane ``.npy`` files, with checkpoint/resume, on the card unless
``--device cpu``.

    python -m ishapediting_tpu_torch.cli.train --data samples/chairs_samples/triplanes \
        --stats models/chairs/statistics/chairs_triplanes_stats \
        --ckpt_dir runs/chairs_ft --steps 10000 --batch_size 8

Use ``--synthetic N`` (N random latents, the JAX package's NumPy stream) for
a run without assets, and ``--preset tiny --device cpu`` on the CPU.
``--export_model_dir`` then writes a category directory as the JAX
package's does (``unet.orbax``, ``decoder.orbax``, ``statistics/``), which
either package's ``DragEngine.from_model_dir`` loads: train -> serve.
"""

from __future__ import annotations

import argparse
import os
import shutil

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a triplane DDPM")
    p.add_argument("--data", type=str, default=None, help="dir of triplane .npy")
    p.add_argument("--stats", type=str, default=None, help="statistics dir")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic latents (smoke testing)")
    p.add_argument("--preset", type=str, default="chairs")
    p.add_argument("--init_from", type=str, default=None,
                   help="torch ema .pt, category dir or unet.orbax dir to fine-tune from")
    p.add_argument("--ckpt_dir", type=str, default="runs/default")
    p.add_argument("--steps", type=int, default=10_000)
    p.add_argument("--ckpt_every", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--ema_rate", type=float, default=0.9999)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--export_model_dir", type=str, default=None,
                   help="after training, write a serveable category dir "
                        "(unet.orbax EMA + decoder.orbax + statistics) that "
                        "DragEngine.from_model_dir loads directly")
    p.add_argument("--decoder_from", type=str, default=None,
                   help="decoder for --export_model_dir: an orbax dir or a "
                        "torch .pt")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def synthetic_batches(n: int, latent_shape, batch_size: int, seed: int):
    """The JAX package's synthetic stream: ``n`` latents clipped to [-1, 1],
    then batches of random indices, all from one NumPy generator."""
    rng = np.random.default_rng(seed)
    data = np.clip(rng.standard_normal((n,) + tuple(latent_shape)).astype(np.float32), -1, 1)
    while True:
        yield data[rng.integers(0, n, batch_size)]


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from ishapediting_tpu_torch.config import preset
    from ishapediting_tpu_torch.core.schedule import make_schedule
    from ishapediting_tpu_torch.io.dataset import TriplaneDataset
    from ishapediting_tpu_torch.io.model_dir import TriplaneStats, discover_model_dir, load_stats
    from ishapediting_tpu_torch.models.unet import UNetModel, init_unet_
    from ishapediting_tpu_torch.train.loop import train
    from ishapediting_tpu_torch.utils.device import resolve_device, set_cuda_flags

    config = preset(args.preset)
    # training uses the full (non-respaced) chain
    sched = make_schedule(config.diffusion.base_steps, config.diffusion.noise_schedule, "")
    channels = config.num_planes * config.plane_channels
    stats = load_stats(args.stats) if args.stats else TriplaneStats.identity(channels)

    if args.data:
        batches = TriplaneDataset(args.data, stats, channels=channels).batches(args.batch_size, seed=args.seed)
    elif args.synthetic:
        batches = synthetic_batches(args.synthetic, config.latent_shape, args.batch_size, args.seed)
    else:
        raise SystemExit("need --data or --synthetic")

    dev = resolve_device(args.device)
    set_cuda_flags()
    with torch.device(dev):
        model = UNetModel(config.unet)
    if args.init_from:
        from ishapediting_tpu_torch.io.convert import load_torch_checkpoint
        from ishapediting_tpu_torch.io.orbax import load_unet_state_dict

        path = args.init_from
        if os.path.isdir(path):  # an orbax dir, or a model dir (its unet.orbax preferred, as serving does)
            info = discover_model_dir(path)
            orbax_dir = path if os.path.exists(os.path.join(path, "manifest.ocdbt")) else info.unet_orbax
            if orbax_dir:
                model.load_state_dict(load_unet_state_dict(orbax_dir))
            elif info.unet_ckpt is None:
                raise SystemExit(f"no ddpm*/ema* checkpoint or unet.orbax under {args.init_from}")
            else:
                load_torch_checkpoint(info.unet_ckpt, model)
        else:
            load_torch_checkpoint(path, model)
    else:
        init_unet_(model, torch.Generator(device=dev).manual_seed(args.seed))

    state = train(
        config.unet, sched, model, batches,
        total_steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        lr=args.lr, grad_clip=args.grad_clip, ema_rate=args.ema_rate, seed=args.seed,
    )
    print(f"done at step {state.step}; checkpoints in {args.ckpt_dir}")

    if args.export_model_dir:
        export_model_dir(args.export_model_dir, state.ema_params, decoder_from=args.decoder_from,
                         stats_dir=args.stats, channels=channels)
        print(f"exported servable model dir: {args.export_model_dir}")
    return state


def export_model_dir(out_dir: str, ema_params, decoder_from=None, stats_dir=None, channels: int = 96,
                     model=None, mesh=None) -> None:
    """Write a servable category directory as the JAX package's
    ``cli/train.py::export_model_dir`` does: ``unet.orbax`` (the EMA
    weights in JAX's layout), ``decoder.orbax`` (from ``decoder_from``: an
    orbax dir or a torch ``.pt``) and ``statistics/`` (copied from
    ``stats_dir``, or explicit identity bounds when absent). Either
    package's ``DragEngine.from_model_dir`` loads the result. A cut model's
    EMA (``model`` cut by ``shard_params_tp``) is gathered whole first;
    over a ``mesh`` every rank calls this, the first writes and the others
    wait."""
    import torch

    from ishapediting_tpu_torch.io.checkpoint import load_params, save_params
    from ishapediting_tpu_torch.io.convert import (
        jax_decoder_from_state_dict,
        jax_params_from_unet_state_dict,
        read_pt_state_dict,
    )
    from ishapediting_tpu_torch.parallel.tensor import gather_named

    if model is not None:
        ema_params = gather_named(model, ema_params)
    if mesh is not None and mesh.n_ranks > 1:
        if mesh.rank == 0:
            export_model_dir(out_dir, ema_params, decoder_from, stats_dir, channels)
        torch.distributed.barrier(group=mesh.mesh_group)
        return
    os.makedirs(out_dir, exist_ok=True)
    save_params(os.path.join(out_dir, "unet.orbax"), jax_params_from_unet_state_dict(ema_params))
    if decoder_from:
        if os.path.isdir(decoder_from):
            dec = load_params(decoder_from)
        else:
            dec = jax_decoder_from_state_dict(read_pt_state_dict(decoder_from))
        save_params(os.path.join(out_dir, "decoder.orbax"), dec)
    else:
        print(
            f"WARNING: no --decoder_from; {out_dir} has no decoder and "
            "DragEngine.from_model_dir will refuse to load it until a "
            "decoder.orbax (or decoder .pt) is added"
        )
    stats_out = os.path.join(out_dir, "statistics")
    if stats_dir:
        dst = os.path.join(stats_out, os.path.basename(os.path.normpath(stats_dir)))
        if not os.path.exists(dst):
            shutil.copytree(stats_dir, dst)
    else:
        # explicit identity bounds so the exported dir loads without
        # allow_identity_stats (the normalization really is identity for a
        # model trained on already-normalized latents)
        ident = os.path.join(stats_out, "identity")
        os.makedirs(ident, exist_ok=True)
        np.save(os.path.join(ident, "lower_bound.npy"), np.full(channels, -1.0, np.float32))
        np.save(os.path.join(ident, "upper_bound.npy"), np.full(channels, 1.0, np.float32))


if __name__ == "__main__":
    main()
