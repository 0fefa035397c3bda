"""Where one chairs UNet forward (and one guided drag step, and one train
step) spends its device time, on one CUDA card.

    python -m ishapediting_tpu_torch.tools.profile_unet --batch 1 2 [--drag] [--train]

For each batch size: the steady-state forward time (CUDA events), the
device time of the kernels per forward and the device's idle share, each
hand-written kernel's device ms, launches and summed bound per forward, and
a ``torch.profiler`` table of device time by kernel name over a few
forwards, on random weights from a seed. Prints the card's name and power
limit first. ``--drag`` does the same for one drag step at batch 1
(``edit/drag.py::make_drag_step``: the forward with its feature tap, the
drag losses and ``torch.autograd.grad`` through the UNet, whose
GroupNorm-SiLU and attention backward launch the backward kernels).
``--train`` does the same for one train step at batch 8
(``train/trainer.py::make_train_step``: the train forward with dropout
under remat, the losses, the backward with every block recomputed, the
gradient clip, AdamW and the EMA). Both print the device time spent inside
the kernels' backward nodes (``GroupNormSiLUBackward``,
``QKVAttentionBackward``), their share of the call's device time, and what
of it is not the node's backward kernels (the torch ops between them; a
remat recompute that a node's saved tensors set off is counted in it too).

The summed bound of a kernel is, over the launches of one forward as
``hopper_kernels.record_launches`` lists them (shapes recorded during the
forward), the least time of each launch: its bytes at the HBM rate, or its
operations at the peak rate of their type where those take longer.
"""

from __future__ import annotations

import argparse
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

ITERS = 5  # forwards per timing and per profile
# autograd nodes of the kernels' Functions and the backward kernels each
# launches; a trace names each node's call so (and its wrapper
# "autograd::engine::evaluate_function: <node>", which holds the same kernels)
BACKWARD_NODES = {"GroupNormSiLUBackward": ("gn_bwd_reduce", "gn_bwd_apply"),
                  "QKVAttentionBackward": ("attn_bwd_dq", "attn_bwd_dkdv")}
KERNELS = {  # LAUNCHES key -> the CUDA kernel's name in a profiler trace (csrc/*.cu)
    "gn_stats": "gn_stats_kernel",
    "gn_norm": "gn_norm_kernel",
    "attention": "attention_kernel",
    "attention_generic": "attention_generic_kernel",
    "gn_bwd_reduce": "gn_bwd_reduce_kernel",
    "gn_bwd_apply": "gn_bwd_apply_kernel",
    "attn_bwd_dq": "attn_bwd_dq_kernel",
    "attn_bwd_dkdv": "attn_bwd_dkdv_kernel",
    "bias_add": "bias_add_kernel",
    "bias_residual": "bias_residual_kernel",
}


def kernel_accounting(fwd, iters: int = ITERS) -> dict:
    """Per forward ``fwd()`` on the card: for each hand-written kernel, its
    device ms (profiler), launches and summed bound ms, plus the forward's
    kernels-busy ms. Returns {"busy_ms": ..., "kernels": {name: {...}}} and
    the profiler's kernel rows under "events"."""
    from ishapediting_tpu_torch.ops import hopper_kernels as hk
    from ishapediting_tpu_torch.utils.device import bound_ms, kernel_rows

    fwd()
    torch.cuda.synchronize()
    with hk.record_launches() as recs:
        fwd()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fwd()
        torch.cuda.synchronize()
    events = kernel_rows(prof)
    out = {}
    for key, name in KERNELS.items():
        rows = [e for e in events if name in e.key]
        mine = [r for r in recs if r["kernel"] == key]
        out[key] = dict(
            ms=sum(e.self_device_time_total for e in rows) / 1e3 / iters,
            launches=len(mine),
            bound_ms=sum(bound_ms(r["bytes"], r["tensor_flops"], r["fp32_flops"], r["tf32_flops"])[0]
                         for r in mine),
        )
    busy = sum(e.self_device_time_total for e in events) / 1e3 / iters
    averages = prof.key_averages()
    backward = {
        node: sum(e.device_time_total for e in averages if e.key == node) / 1e3 / iters
        for node in BACKWARD_NODES
    }
    return dict(busy_ms=busy, kernels=out, events=events, backward_ms=backward)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, nargs="+", default=[1, 2])
    p.add_argument("--rows", type=int, default=15, help="kernel names to list")
    p.add_argument("--drag", action="store_true",
                   help="also profile one guided drag step at batch 1 (forward + backward)")
    p.add_argument("--train", action="store_true",
                   help="also profile one train step at batch 8 (forward, remat backward, AdamW, EMA)")
    p.add_argument("--no_cudnn_benchmark", action="store_true",
                   help="take cuDNN's heuristic algorithm choice instead of timing")
    args = p.parse_args(argv)

    from ishapediting_tpu_torch.config import preset
    from ishapediting_tpu_torch.models.unet import UNetModel, init_unet_
    from ishapediting_tpu_torch.utils.device import cuda_ms, resolve_device, set_cuda_flags

    dev = resolve_device("cuda")
    set_cuda_flags(cudnn_benchmark=not args.no_cudnn_benchmark)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(f"card: {card}; cudnn.benchmark={torch.backends.cudnn.benchmark}")
    cfg = preset("chairs")
    gen = torch.Generator(device=dev).manual_seed(0)
    with torch.device(dev):
        unet = init_unet_(UNetModel(cfg.unet), gen).eval().requires_grad_(False)
    runs = []
    for batch in args.batch:
        x = torch.randn((batch,) + cfg.latent_shape, generator=gen, device=dev)
        t = torch.full((batch,), 500, dtype=torch.long, device=dev)

        def fwd(x=x, t=t):
            with torch.no_grad():
                unet(x, t)

        runs.append((f"batch {batch}: forward", fwd))
    if args.drag:
        runs.append(("batch 1: drag step", drag_step_fn(unet, cfg, gen, dev)))
    if args.train:
        runs.append(("batch 8: train step", train_step_fn(cfg, gen, dev)))
    for label, fn in runs:
        ms = cuda_ms(fn, ITERS)
        acc = kernel_accounting(fn)
        busy = acc["busy_ms"]
        print(f"{label} {ms:.3f} ms (CUDA events); kernels busy {busy:.3f} ms "
              f"per call (profiler), device idle {1 - busy / ms:.1%}")
        for key, k in acc["kernels"].items():
            print(f"  {key}: {k['ms']:.4f} ms, {k['launches']} launches per call, "
                  f"summed bound {k['bound_ms']:.4f} ms")
        for node, node_ms in acc["backward_ms"].items():
            if node_ms:
                own = sum(acc["kernels"][k]["ms"] for k in BACKWARD_NODES[node])
                print(f"  inside {node} nodes: {node_ms:.3f} ms per call, {node_ms / busy:.1%} of "
                      f"the device time; its backward kernels {own:.3f} ms, the rest {node_ms - own:.3f} ms")
        events = sorted(acc["events"], key=lambda e: -e.self_device_time_total)
        for e in events[: args.rows]:
            print(f"  {e.self_device_time_total / 1e3 / ITERS:9.3f} ms "
                  f"{e.count // ITERS:5d}x  {e.key[:110]}")


def drag_step_fn(unet, cfg, gen, dev):
    """One guided drag step of the config's edit settings at batch 1, in the
    middle of its chain, one handle, against the features of a first forward."""
    from ishapediting_tpu_torch.core.schedule import make_schedule
    from ishapediting_tpu_torch.edit.drag import build_drag_problem, make_drag_step
    from ishapediting_tpu_torch.edit.features import regroup_features

    d, e = cfg.diffusion, cfg.edit
    sched = make_schedule(d.base_steps, d.noise_schedule, d.timestep_respacing).to(dev)
    x = torch.randn((1,) + cfg.latent_shape, generator=gen, device=dev)
    with torch.no_grad():
        _, feat = unet(x, torch.full((1,), 500, dtype=torch.long, device=dev), feat_layer=e.feat_layer)
    origin = regroup_features(feat)[0]
    problem = build_drag_problem([[0.5, 0.0, 0.0]], [[0.6, 0.0, 0.0]], r1=e.r1, voxel_size=e.voxel_size,
                                 feat_width=origin.shape[-2], device=dev)
    step = make_drag_step(sched, lambda a, b: unet(a, b, feat_layer=e.feat_layer), problem,
                          scale=e.grad_scale, cof=e.mask_weight)
    return lambda: step(x, sched.num_timesteps // 2, origin, gen)



def train_step_fn(cfg, gen, dev, batch: int = 8):
    """One train step of the config's UNet at ``batch`` (its own fp32
    master weights, AdamW with clip 1.0, EMA 0.9999, remat), on synthetic
    latents and the same draws every call."""
    from ishapediting_tpu_torch.core.schedule import make_schedule
    from ishapediting_tpu_torch.models.unet import UNetModel, init_unet_
    from ishapediting_tpu_torch.train.trainer import init_train_state, make_optimizer, make_train_step

    with torch.device(dev):
        model = init_unet_(UNetModel(cfg.unet), gen)
    state = init_train_state(model, make_optimizer(model.parameters(), lr=1e-4, grad_clip=1.0))
    sched = make_schedule(cfg.diffusion.base_steps, cfg.diffusion.noise_schedule, "")
    step = make_train_step(cfg.unet, sched)
    x = torch.randn((batch,) + cfg.latent_shape, generator=gen, device=dev).clamp(-1, 1)
    draws = torch.Generator(device=dev)

    def fn():
        draws.manual_seed(0)
        step(state, x, draws)

    return fn


if __name__ == "__main__":
    main()
