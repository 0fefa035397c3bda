"""Training CLI: train or fine-tune a triplane DDPM on a directory of
triplane ``.npy`` files, with checkpoint/resume, on the card unless
``--device cpu``.

    python -m ishapediting_tpu_torch.cli.train --data samples/chairs_samples/triplanes \
        --stats models/chairs/statistics/chairs_triplanes_stats \
        --ckpt_dir runs/chairs_ft --steps 10000 --batch_size 8

Use ``--synthetic N`` (N random latents, the JAX package's NumPy stream) for
a run without assets, and ``--preset tiny --device cpu`` on the CPU.
``--export_model_dir`` then writes a category directory in the reference's
layout that ``DragEngine.from_model_dir`` loads: train -> serve.
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
                   help="torch ema .pt or category dir to fine-tune from")
    p.add_argument("--ckpt_dir", type=str, default="runs/default")
    p.add_argument("--steps", type=int, default=10_000)
    p.add_argument("--ckpt_every", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--grad_clip", type=float, default=1.0)
    p.add_argument("--ema_rate", type=float, default=0.9999)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--export_model_dir", type=str, default=None,
                   help="after training, write a servable category dir (ddpm_<preset>_ckpts/"
                        "ema_<step>.pt, <preset>_decoder.pt, statistics/) that "
                        "DragEngine.from_model_dir loads")
    p.add_argument("--decoder_from", type=str, default=None,
                   help="decoder .pt (reference MultiTriplane.net state_dict) for --export_model_dir")
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

        path = args.init_from
        if os.path.isdir(path):
            path = discover_model_dir(path).unet_ckpt
            if path is None:
                raise SystemExit(f"no ddpm*/ema* checkpoint under {args.init_from}")
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
        export_model_dir(args.export_model_dir, state.ema_params, state.step, args.preset,
                         decoder_from=args.decoder_from, stats_dir=args.stats,
                         channels=channels, plane_channels=config.plane_channels)
        print(f"exported servable model dir: {args.export_model_dir}")
    return state


def export_model_dir(out_dir: str, ema_params, step: int, name: str, decoder_from=None,
                     stats_dir=None, channels: int = 96, plane_channels: int = 32) -> None:
    """Write a servable category directory in the reference's asset layout
    (drag_utils.py:213-228): ``ddpm_<name>_ckpts/ema_<step>.pt`` (the EMA
    UNet state_dict), ``<name>_decoder.pt`` (read from ``decoder_from``, a
    torch ``.pt``) and ``statistics/`` (copied from ``stats_dir``, or
    explicit identity bounds when absent). ``DragEngine.from_model_dir``
    loads the result."""
    import torch

    from ishapediting_tpu_torch.io.convert import load_torch_decoder
    from ishapediting_tpu_torch.ops.triplane import TriplaneDecoder

    os.makedirs(out_dir, exist_ok=True)
    ckpts = os.path.join(out_dir, f"ddpm_{name}_ckpts")
    os.makedirs(ckpts, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in ema_params.items()},
               os.path.join(ckpts, f"ema_{step}.pt"))
    if decoder_from:
        if os.path.isdir(decoder_from):
            raise SystemExit(
                f"--decoder_from {decoder_from} is a directory (an orbax checkpoint of the JAX "
                "package?): reading orbax waits for the orbax reader (ROADMAP, Queue 1: io/orbax); "
                "give a torch .pt"
            )
        dec = load_torch_decoder(decoder_from, TriplaneDecoder(plane_channels))
        torch.save(dec.state_dict(), os.path.join(out_dir, f"{name}_decoder.pt"))
    else:
        print(
            f"WARNING: no --decoder_from; {out_dir} has no decoder and "
            "DragEngine.from_model_dir will refuse to load it until a decoder .pt is added"
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
