#!/usr/bin/env python3
"""Drive the PyTorch port's generation, editing, serving, training,
evaluation, data-parallel and tensor-parallel paths, and its reading of the
JAX package's orbax checkpoints, once on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout, one H100
    python3 chip_smoke.py --phases 2,7   # the build and some phases: no result line

Phases, each fatal on failure (exit code 1, no result line):

1. build the Hopper kernels (``ishapediting_tpu_torch/csrc``, nvcc) and the
   native meshing library (g++) from the checkout's sources into ``build/``;
2. hold every kernel against its plain PyTorch version at the main path's
   shapes and types (the generic attention kernel in fp32 at the chairs
   shapes and at the tiny preset's head dim 8, and in bf16 at head dim 8,
   at the heads-by-count chairs UNet's 192 over T=256 and 256 over T=64,
   and at 512),
   and time kernel, plain version, the closest PyTorch library call, and
   the least time the card could take (``bound_ms``); then the backward
   kernels (``gn_bwd_reduce``, ``gn_bwd_apply``, ``attn_bwd_dq``,
   ``attn_bwd_dkdv``) element by element against their plain twins at the
   chairs train step's shapes (batch 8), the drag step's T=1024 level
   (batch 1), the heads-by-count and the fp32 UNets' shapes, timed beside
   the twins, the bound and the backward of
   ``F.scaled_dot_product_attention``, each row naming the route it ran
   (``hk.attention_bwd_route``: "hopper" or "generic"), the GroupNorm
   pair's finished outputs bit for bit what the twin's finish makes of its
   own partials, two runs bit-equal, and one ``GroupNormSiLU`` backward's
   trace holding its two kernels and nothing else; then gradients through each
   kernel's autograd Function (kernel forward, backward kernels) against
   autograd through the plain composition, at every chairs input at batch
   1 and at the fp32 UNets' inputs, with and without FiLM, one launch of
   each backward kernel per call; then the bias epilogue
   (``bias_add_kernel``, ``bias_residual_kernel``) at every [rows, C],
   dtype and form that a forward of either benchmark configuration (chairs,
   adm128) gives it at batch 1, 2 and 32, into a new tensor and into the
   product's own buffer, ``torch.equal`` to the plain composition (under
   autograd the composition itself, with no launch), and timed against the
   eager adds and its bytes bound (``tools/bias_epilogue_bench.py``);
3. check the whole UNet on the card against the same module on the CPU
   (plain versions) on a small input: a bf16 torso at head dim 64 (the
   wgmma attention kernel), then the ``tiny`` preset (fp32 torso, head dim
   8: the generic attention kernel, ``gn_stats`` at one channel per group)
   to a relative L2 error of 1e-4; then the fp32 path end to end:
   ``DragEngine(preset("tiny"), device="cuda").update_latent_params``; then
   the edit gate (``tests/assets/edit_gate.npz``, fp32 toy UNet) on the
   card: inversion with the recorded noises, scale-0 and guided replay
   drags, the guided motion loss at least half the recorded reduction below
   the scale-0 one, and the per-step motion losses held to the same run on
   the CPU;
4. the main path at the published chairs width (421M parameters, bf16
   torso, random weights from a seed; only step counts are cut):
   ``cli.generate`` with DDIM and with DPM-Solver++(2M), 10 steps, 2 samples
   at batch 2, DDIM's two decoded to 256^3 meshes (the DPM run samples with
   ``--skip_decode``: its decode is DDIM's, cut for time); then ``DragEngine.update_latent_params`` on a
   20-step chain (w_time 10) with its guidance-feature cache and its 256^3
   mesh (marched on the card); then the editing path on that engine: a
   resample drag over the whole w_time walk, ``latent_inversion`` of the
   generated latent, a replay drag, ``fit_real_shape`` of the first mesh
   (3 guided steps); then ``cli.edit`` (200-step generation, a 10-step fast
   drag, two 256^3 meshes); then device marching against host marching on
   one 256^3 grid; then each kernel's device ms, launches and summed bound
   per chairs forward at batch 1 and 2
   (``tools/profile_unet.py::kernel_accounting``);
   in every run of phases 3 to 8 the launch counters are reset just before
   it and read just after it, and each must equal the UNet forwards of that
   run times the kernel's calls per forward (a drag or fit step is one
   forward; the bias epilogues ``models/unet.py::epilogue_calls_per_forward``
   in each forward that wants no gradient, the time-embedding path's in one
   that wants it for its input alone (``film_epilogues``), plus three plain
   ones for each MLP call of the triplane decoder on the card that wants
   none, which ``DecoderCounter`` counts) plus, for each backward pass, the two
   backward kernels of every GroupNorm-SiLU and attention node it runs (a
   drag step's loss reaches the blocks
   ``models/unet.py::kernel_calls_recomputed`` lists for its feature tap, a
   fit step's every call of the forward); under remat the backward also
   runs those blocks' GroupNorm-SiLU and attention kernels and FiLM
   projections a second time;
   chairs runs launch no generic attention, the fp32 runs no wgmma
   attention;
5. the serving surfaces on the same chairs engine: ``fit_real_shape_direct``
   of the first 256^3 mesh at the published ``FitConfig`` (its loss must
   fall), ``morph`` of two ``sample_latent``s at 3 frames, ``cli.morph``,
   ``cli.batch_edit`` on 2 seeds (batched generation, inversion, replay
   drag over a 5-step edit window, four 256^3 meshes),
   ``drag_edit_batched`` on its records without
   and with remat, held to two single-shape ``drag_edit`` runs with the same
   noises and to each other, ``fit_real_shapes_batched`` of two 256^3
   meshes, and a ``cli.serve`` session through ``serve_loop`` over a pipe
   (a ``stop`` written while the drag runs), every response ok; timings and
   each batched run's peak device memory are printed beside the card;
6. the heads-by-count UNet (``UNetConfig.from_reference_args(
   num_head_channels=-1)``: 4 heads per attention block, so head dims 128,
   192 and 256) at the published chairs width, on its own ``DragEngine``:
   DDIM-10 at batch 2 (twice), a 20-step ``update_latent_params`` and a
   2-step fast drag, at 71/71/5/11 launches per forward exactly, then its
   per-forward kernel accounting;
7. training (``train/``, ``cli/train.py``): one train step (dropout 0.1,
   remat) on the card against the CPU with the same t, noise and dropout
   masks, on phase 3's bf16 miniature UNet (loss terms to 3e-2, gradients
   held to an fp32 step) and on the fp32 tiny UNet through the generic
   kernel (1e-4); remat against no remat on the card with generator-drawn
   masks (1e-5); ``train_decoder`` at the published decoder widths on a
   sphere (held-out accuracy > 0.9); ``cli.train`` at the published chairs
   width, batch 8 (4 steps, a checkpoint written as the JAX package's orbax
   train state, timed beside one ``torch.save`` of the same tensors, the
   checkpoint held to the state, a resume to step 6 from it,
   ``--export_model_dir`` with the trained decoder: ``unet.orbax``,
   ``decoder.orbax``), the export served by ``DragEngine.from_model_dir``
   (DDIM-10 at batch 2 from a fixed x_T bit-equal to the in-memory EMA
   UNet's, a 20-step ``update_latent_params``); a bf16 miniature
   overfitting 4 latents in 30 steps; train s/step (first and steady),
   peak memory, checkpoint bytes, write and read seconds and MB/s, and
   decoder s/step printed; every train step
   launches the forward's kernels, under remat every block's again, and
   the backward kernels of every call (141/141/32 forward and 71/71/16/16
   backward per chairs step, exact);
8. the remaining CLIs and host modules on the chairs engine of phase 4
   (or one built alike): ``cli.decode`` of phase 4's DDIM triplane on the
   card at 128^3 with ``--cross_section``, held to the same planes decoded
   on the CPU (occupancy and mask equal except where |logit| < 1e-3, the
   mesh of the same triangles), then at 256^3, timed; ``cli.eval`` pairs
   mode on phase 4's ``cli.edit`` meshes, original and edited (chamfer,
   hausdorff, IoU, local IoU around the handle of its EditLog);
   ``solver_mesh_sweep`` on the chairs UNet with the base chain cut to 50
   for time (budget 10, one seed: 120 forwards, four 256^3 meshes; the
   ancestral chain's JAX draws timed on the host) and ``cli.eval
   --solver_sweep --random_init --preset tiny`` (the generic kernel); the
   GUI (``gui/app.py``) on the headless Open3D backend over a
   ``DragEngine`` of phase 7's exported model dir (or one written with
   random weights): select, create (20 steps), two picks through the
   rendered depth, a 2-step drag, save mesh + EditLog and picture, its
   meshes at 64^3; launches exact per run; ``--phases 8`` runs alone (on
   DDIM-10 samples of its own engine, decoded and evaluated in pairs);
9. first, the one-rank reference of phases 9 and 10: phase 4's chairs UNet
   (the CUDA generator of seed 0) with signal in the weights the ADM init
   zeroes (with them zero the UNet outputs exactly 0, and any torso or
   weights on any rank would match it): a forward and DDIM-10 at batch 2,
   a servable model dir of it, and (with phase 10) two train steps. Then two ranks sharing the card
   (``python -m torch.distributed.run --standalone --nproc_per_node 2
   chip_smoke.py --rank-worker <dir>``, gloo: NCCL refuses two ranks on one
   device), each running in-process: (a) ``cli.generate --model_dir``
   DDIM-10 at chairs width, 2 samples at batch 2 (one trajectory per rank)
   with ``--sharded_decode`` (each rank decodes, marches and writes its own
   256^3 mesh), the gathered latents held to the reference's (relative L2
   2e-2); (b) ``decode_grid_sharded``
   of the first latent at 256^3, gathered, bit-equal to ``decode_grid``;
   (c) the data-parallel train step on phase 3's bf16 miniature (global
   batch 4, remat, dropout; two steps), parameters and EMA bit-equal across
   the ranks, loss terms, ``distributed_mean_kvs`` and gradients held to a
   one-rank step at batch 4 in this process (3e-2), and a step with one
   rank's rows NaN changing no rank; (d) on the tiny preset
   ``invert_batched`` + ``drag_edit_batched`` at N=2 with recorded noises
   and ``morph_latents`` at 2 frames over the ranks, against one rank
   (1e-4); each rank's launches exact and added to the totals; a rank that
   fails fails the phase, with no retry on one rank;
10. the model axis and ``cli.serve`` over ranks: two ranks sharing the card
    (``torchrun ... chip_smoke.py --tp-worker <dir>``, gloo), with the serve
    requests on torchrun's stdin: (a) each rank builds the reference's
    chairs UNet on the CPU and cuts it over ``make_mesh(2,
    model_parallel=2)`` (``shard_params_tp``; at most 0.51 of one rank's
    parameter bytes each); one forward at batch 2 and DDIM-10 at batch 2 on
    a ``DragEngine`` over the cut UNet, held to the reference's (relative
    L2 2e-2), the gathers per forward and their time printed; (b) the fp32 miniature (widths 64-256) cut and whole on
    each rank: the guidance gradient and a 2-step drag with the recorded
    noises, without and with remat (1e-4); (c) ``decode_grid_sharded``
    over the 2-D mesh at 256^3, gathered, bit-equal to ``decode_grid``;
    (d) ``cli.serve``'s ``main`` with ``--dist_backend gloo`` in each rank:
    ``init_random`` at chairs width, ``sample`` and a 2-step drag on rank
    0, ``load_model`` of the reference's model dir, ``generate`` of 2
    samples at batch 2 over the ranks (DDIM-10, triplanes held to the
    reference's at 2e-2, meshes at 64^3), ``status``, ``quit``, every
    response ok; (e) the reference's UNet (cut, dropout 0.1) trains two
    steps at global batch 2 (remat, grad_clip 0.1, below the gradient's
    norm so the clip runs; draws from CPU generators), held to the
    reference's two one-rank steps on the same draws (loss, mse, vb and
    ``grad_norm`` to 1e-3, every parameter's clipped gradient norm to
    2e-2), with each rank's bytes of parameters, EMA and
    moments, peak GiB, first and steady s/step and gloo seconds printed;
    then the fp32 miniature's train step cut against whole (loss,
    ``grad_norm``, parameters after the step, 1e-4) and a checkpoint saved
    cut (orbax, written by the first rank) and loaded whole (parameters,
    EMA, Adam moments and step bit-equal); each rank's launches exact and added
    to the totals;
11. the JAX package's orbax checkpoints (``tests/assets/orbax``, written by
    ``tests/assets/make_orbax_assets.py``; the card's machine has no JAX,
    orbax or tensorstore): ``DragEngine.from_model_dir`` of the tiny model
    dir on the card, every leaf of the three trees against
    ``sha256.json``, DDIM-10 from JAX's x_T through the kernels against
    JAX's latents (max abs 1e-3), ``cli.decode --model_dir`` on the dir,
    ``train`` resumed from the JAX ``step_3`` for one step (step 4, finite
    loss), and the reader's MB/s;
12. print the ``{"kernels": [...]}`` line, the card's name and power limit,
    and as the last line ``{"ok": true, "device": {...}}``.

Each phase's start is printed as it begins and each phase's wall before
the total, to keep the run well inside its watchdog.

Exits non-zero without a result when no CUDA card is present or when the
port's package is not beside this script.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
# what phases 4 and 7 leave for phase 8 (which makes its own when they did not run)
KEPT_TRIPLANES = os.path.join(WORK, "kept_triplanes")  # cli.generate's DDIM samples
KEPT_EDIT = os.path.join(WORK, "kept_edit")  # cli.edit's original.obj, edit00.obj and EditLog
KEPT_MODELS = os.path.join(WORK, "kept_models")  # cli.train's exported model dir
SIGNAL_DIR = os.path.join(WORK, "signal_chairs")  # phases 9 and 10's servable model dir (signal_reference)
TIME_LIMIT_S = 1100  # the run must end well inside 1200 s, build included

TPU_KERNELS = {  # the Pallas kernel, or for a backward kernel the custom_vjp's backward, it replaces
    "gn_stats": "ishapediting_tpu/ops/pallas_kernels.py:109",
    "gn_norm": "ishapediting_tpu/ops/pallas_kernels.py:126",
    "attention": "ishapediting_tpu/ops/pallas_kernels.py:259",
    "attention_generic": "ishapediting_tpu/ops/pallas_kernels.py:259",
    "gn_bwd_reduce": "ishapediting_tpu/ops/pallas_kernels.py:214",
    "gn_bwd_apply": "ishapediting_tpu/ops/pallas_kernels.py:214",
    "attn_bwd_dq": "ishapediting_tpu/ops/pallas_kernels.py:311",
    "attn_bwd_dkdv": "ishapediting_tpu/ops/pallas_kernels.py:311",
    # no TPU kernel: XLA fuses the JAX package's bias adds into its convolutions, and its residual adds
    "bias_add": "none: ishapediting_tpu/ops/nn.py:101 (out + b), fused by XLA",
    "bias_residual": "none: ishapediting_tpu/models/unet.py:465,478 (x + hh, h + out), fused by XLA",
}
SOURCES = {
    "gn_stats": "ishapediting_tpu_torch/csrc/groupnorm_silu.cu",
    "gn_norm": "ishapediting_tpu_torch/csrc/groupnorm_silu.cu",
    "attention": "ishapediting_tpu_torch/csrc/attention.cu",
    "attention_generic": "ishapediting_tpu_torch/csrc/attention_generic.cu",
    "gn_bwd_reduce": "ishapediting_tpu_torch/csrc/groupnorm_silu.cu",
    "gn_bwd_apply": "ishapediting_tpu_torch/csrc/groupnorm_silu.cu",
    "attn_bwd_dq": "ishapediting_tpu_torch/csrc/attention_bwd_hopper.cu",  # the headline row's route
    "attn_bwd_dkdv": "ishapediting_tpu_torch/csrc/attention_bwd_hopper.cu",
    "bias_add": "ishapediting_tpu_torch/csrc/bias_epilogue.cu",
    "bias_residual": "ishapediting_tpu_torch/csrc/bias_epilogue.cu",
}
BWD_ATTN_SOURCES = {  # each attention backward row's source, by hk.attention_bwd_route
    "hopper": "ishapediting_tpu_torch/csrc/attention_bwd_hopper.cu",
    "generic": "ishapediting_tpu_torch/csrc/attention_bwd.cu",
}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def watchdog() -> None:
    """End the process, and so every thread and child, past the limit."""

    def _kill():
        print(f"chip_smoke FAILED: over {TIME_LIMIT_S} s", file=sys.stderr, flush=True)
        for proc in _CHILDREN:  # torchrun's group; its ranks end with it (PR_SET_PDEATHSIG)
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, 9)
        os._exit(3)

    t = threading.Timer(TIME_LIMIT_S, _kill)
    t.daemon = True
    t.start()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def library_ms(fn):
    """``device_ms`` of a PyTorch library call used only as a yardstick; None,
    with the reason printed, where this PyTorch build refuses the call."""
    from ishapediting_tpu_torch.utils.device import device_ms

    try:
        return device_ms(fn)
    except Exception as e:  # noqa: BLE001 - a yardstick, not a path of the port
        say(f"    library call refused: {type(e).__name__}: {e}")
        return None


def sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def gn_inputs(gen, shape, dtype, film, dev):
    n, c = shape[0], shape[-1]
    x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(dtype)
    scale = torch.randn(c, generator=gen, device=dev) * 0.1 + 1.0
    bias = torch.randn(c, generator=gen, device=dev) * 0.1
    f = None
    if film:
        f = tuple((torch.randn((n, c), generator=gen, device=dev) * 0.2).to(dtype) for _ in range(2))
    return x, scale, bias, f


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name, got, want, atol, rtol) -> float:
    """|got - want| <= atol + rtol |want| everywhere; returns max |got - want|."""
    err = max_err(got, want)
    excess = float(((got.float() - want.float()).abs() - rtol * want.float().abs()).max())
    ok = excess <= atol and bool(got.isfinite().all())
    say(f"  {name}: max_abs_err {err:.3e} (tol {atol:g} + {rtol:g}|plain|) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


def var_form(part):
    """Partials (count, mean, M2) as (count, mean, variance): O(1) values,
    so that an absolute error means the same for every split size."""
    return torch.cat([part[..., :2], part[..., 2:] / part[..., :1]], dim=-1)


def kernel_checks(hk, dev):
    from ishapediting_tpu_torch.ops.attention import dense_qkv_attention
    from ishapediting_tpu_torch.ops.nn import effective_groups
    from ishapediting_tpu_torch.utils.device import bound_ms, device_ms

    gen = torch.Generator(device=dev).manual_seed(0)
    report = {}
    say("[2] kernels against their plain versions (main-path shapes)")

    # groupnorm_silu at the main path's extremes: both launches together, then
    # each launch alone. The first case is also each launch's headline row.
    gn_cases = [
        ((2, 128, 128, 512), torch.bfloat16, True, 2e-2, 2e-2),
        ((2, 8, 8, 2048), torch.bfloat16, False, 2e-2, 2e-2),
        ((2, 128, 128, 256), torch.float32, False, 1e-4, 1e-4),  # the fp32 output head
    ]
    rows = {"gn_stats": [], "gn_norm": [], "attention": []}
    for shape, dtype, film, atol, rtol in gn_cases:
        x, scale, bias, f = gn_inputs(gen, shape, dtype, film, dev)
        got = hk.groupnorm_silu(x, scale, bias, film=f)
        torch.cuda.synchronize()
        want = hk.groupnorm_silu_plain(x, scale, bias, film=f)
        dname = str(dtype)[6:]
        tag = f"{list(shape)} {dname}{' film' if film else ''}"
        check_close(f"groupnorm_silu {tag}", got, want, atol, rtol)
        both_ms = device_ms(lambda: hk.groupnorm_silu(x, scale, bias, film=f), kernel="::gn_")
        p_ms = device_ms(lambda: hk.groupnorm_silu_plain(x, scale, bias, film=f), 5)
        xn = x.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
        lib_ms = library_ms(lambda: F.silu(F.group_norm(xn, 32, scale.to(dtype), bias.to(dtype))))
        b_ms, _ = bound_ms(2 * nbytes(x))
        say(f"    both launches {both_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"F.group_norm+F.silu {lib_ms} ms, bound {b_ms:.4f} ms")

        g = effective_groups(shape[-1], 32)
        part = hk.gn_stats_cuda(x, g)
        torch.cuda.synchronize()
        err_s = check_close(f"gn_stats {tag}, (count, mean, M2/count)", var_form(part),
                            var_form(hk.gn_stats_plain(x, g)), 1e-4, 1e-4)
        sb_ms, sb_by = bound_ms(nbytes(x, part), fp32_flops=4 * x.numel())
        xv = x.view(shape[0], -1, g, shape[-1] // g)
        s_ms = device_ms(lambda: hk.gn_stats_cuda(x, g), kernel="gn_stats_kernel")
        s_lib = library_ms(lambda: torch.var_mean(xv, dim=(1, 3), correction=0))
        y = hk.gn_norm_cuda(x, part, scale, bias, film=f)
        torch.cuda.synchronize()
        n_tol = 1e-2 if dtype == torch.bfloat16 else 1e-5  # one rounding of x's dtype
        err_n = check_close(f"gn_norm {tag}", y,
                            hk.gn_norm_plain(x, part, scale, bias, film=f), n_tol, n_tol)
        nb_ms, nb_by = bound_ms(nbytes(x, y, part, scale, bias, *(f or ())),
                             fp32_flops=12 * x.numel())
        n_ms = device_ms(lambda: hk.gn_norm_cuda(x, part, scale, bias, film=f),
                         kernel="gn_norm_kernel")
        sp_ms = device_ms(lambda: hk.gn_stats_plain(x, g), 5)
        np_ms = device_ms(lambda: hk.gn_norm_plain(x, part, scale, bias, film=f), 5)
        say(f"    gn_stats {s_ms:.4f} ms (plain {sp_ms:.4f}, bound {sb_ms:.4f}, torch.var_mean "
            f"{s_lib}), gn_norm {n_ms:.4f} ms (plain {np_ms:.4f}, bound {nb_ms:.4f})")
        rows["gn_stats"].append(dict(shape=list(shape), dtype=dname, film=film, ms=s_ms,
                                     plain_ms=sp_ms, bound_ms=sb_ms, library_ms=s_lib,
                                     max_abs_err=err_s))
        rows["gn_norm"].append(dict(shape=list(shape), dtype=dname, film=film, ms=n_ms,
                                    plain_ms=np_ms, bound_ms=nb_ms, library_ms=None,
                                    both_ms=both_ms, both_library_ms=lib_ms, max_abs_err=err_n))
        if "gn_stats" not in report:
            report["gn_stats"] = dict(
                shape=list(shape), dtype=dname, max_abs_err=err_s,
                tol="1e-4 + 1e-4|plain| on (count, mean, M2/count)", ms=s_ms, plain_ms=sp_ms,
                library_ms=s_lib, bound_ms=sb_ms, bound_by=sb_by,
            )
            report["gn_norm"] = dict(
                shape=list(shape), dtype=dname, max_abs_err=err_n, tol="1e-2 + 1e-2|plain|",
                ms=n_ms, plain_ms=np_ms,
                library_ms=None,  # no one PyTorch call normalizes from given statistics
                bound_ms=nb_ms, bound_by=nb_by,
            )

    # Backward through the autograd.Function (the backward kernels) at a small shape.
    x, scale, bias, f = gn_inputs(gen, (2, 8, 8, 64), torch.float32, True, dev)
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias, *f)]
    ref = [t.clone().requires_grad_(True) for t in (x, scale, bias, *f)]
    (hk.groupnorm_silu(leaves[0], leaves[1], leaves[2], film=tuple(leaves[3:])) ** 2).sum().backward()
    (hk.groupnorm_silu_plain(ref[0], ref[1], ref[2], film=tuple(ref[3:])) ** 2).sum().backward()
    torch.cuda.synchronize()
    for i, (a, b) in enumerate(zip(leaves, ref)):
        check_close(f"groupnorm_silu backward, input {i}", a.grad, b.grad, 1e-3, 1e-3)

    # Attention at the three main-path shapes (batch 2, head dim 64).
    for t, heads in ((1024, 8), (256, 12), (64, 16)):
        ch = 64
        qkv = torch.randn((2, t, heads * 3 * ch), generator=gen, device=dev).to(torch.bfloat16)
        got = hk.attention_qkv(qkv, heads)
        torch.cuda.synchronize()
        err = check_close(f"attention T={t} H={heads} ch={ch} bf16", got,
                          dense_qkv_attention(qkv, heads), 2e-2, 0.0)
        q, k, v = qkv.view(2, t, heads, 3, ch).permute(3, 0, 2, 1, 4).unbind(0)
        k_ms = device_ms(lambda: hk.attention_qkv(qkv, heads), kernel="attention_kernel")
        p_ms = device_ms(lambda: dense_qkv_attention(qkv, heads), 5)
        lib_ms = library_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=ch ** -0.5))
        b_ms, b_by = bound_ms(nbytes(qkv, got), tensor_flops=4.0 * 2 * heads * t * t * ch,
                           fp32_flops=4.0 * 2 * heads * t * t)
        say(f"    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, sdpa {lib_ms} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        rows["attention"].append(dict(shape=list(qkv.shape), heads=heads, ms=k_ms, plain_ms=p_ms,
                                      bound_ms=b_ms, library_ms=lib_ms, max_abs_err=err))
        if t == 1024:
            report["attention"] = dict(
                shape=list(qkv.shape), heads=heads, dtype="bfloat16", max_abs_err=err,
                tol="2e-2", ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by,
            )

    # The generic kernel: fp32 at the chairs shapes and at the tiny preset's
    # head dim 8, bf16 at head dim 8 (the dtypes and head dims the wgmma
    # kernel does not take), bf16 at the heads-by-count chairs UNet's head
    # dims (192 over T=256 at 16^2, 256 over T=64 at 8^2) and past 256 (512:
    # the chunked path). Bound: the bytes, or the products on the route's
    # units: bf16 tensor cores (989 TFLOP/s) for bf16, three TF32 passes
    # (495 TFLOP/s) for fp32 (3xTF32; the fp32 FMA bound at 67 TFLOP/s is
    # printed beside it).
    rows["attention_generic"] = []
    for t, heads, ch, dtype in ((1024, 8, 64, torch.float32), (256, 12, 64, torch.float32),
                                (64, 16, 64, torch.float32), (64, 4, 8, torch.float32),
                                (64, 4, 8, torch.bfloat16), (256, 4, 192, torch.bfloat16),
                                (64, 4, 256, torch.bfloat16), (64, 2, 512, torch.bfloat16)):
        qkv = torch.randn((2, t, heads * 3 * ch), generator=gen, device=dev).to(dtype)
        dname = str(dtype)[6:]
        got = hk.attention_qkv(qkv, heads)
        torch.cuda.synchronize()
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        err = check_close(f"attention_generic T={t} H={heads} ch={ch} {dname}", got,
                          dense_qkv_attention(qkv, heads), tol, 0.0)
        q, k, v = qkv.view(2, t, heads, 3, ch).permute(3, 0, 2, 1, 4).unbind(0)
        k_ms = device_ms(lambda: hk.attention_qkv(qkv, heads), kernel="attention_generic_kernel")
        p_ms = device_ms(lambda: dense_qkv_attention(qkv, heads), 5)
        lib_ms = library_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=ch ** -0.5))
        products, softmax = 4.0 * 2 * heads * t * t * ch, 4.0 * 2 * heads * t * t
        fma_ms, _ = bound_ms(nbytes(qkv, got), fp32_flops=products)
        if dtype == torch.float32:
            b_ms, b_by = bound_ms(nbytes(qkv, got), tf32_flops=3 * products, fp32_flops=softmax)
            unit = "3xTF32 at 495 TFLOP/s" if b_by == "operations" else "bytes at 3.35 TB/s"
        else:
            b_ms, b_by = bound_ms(nbytes(qkv, got), tensor_flops=products, fp32_flops=softmax)
            unit = "bf16 tensor cores at 989 TFLOP/s" if b_by == "operations" else "bytes at 3.35 TB/s"
        geo = hk.attention_generic_geometry(2, t, heads, ch, dtype)
        say(f"    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, sdpa {lib_ms} ms, "
            f"bound {b_ms:.4f} ms ({unit}; fp32 FMA bound {fma_ms:.4f} ms), launch: bucket "
            f"{geo['bucket']}, {'chunked' if geo['chunked'] else 'fast path'}, grid {geo['grid']}, "
            f"cluster split {geo['split']}")
        rows["attention_generic"].append(dict(shape=list(qkv.shape), heads=heads, dtype=dname,
                                              ms=k_ms, bound_ms=b_ms, bound_by=b_by,
                                              bound_unit=unit, fp32_fma_bound_ms=fma_ms,
                                              library_ms=lib_ms, plain_ms=p_ms, max_abs_err=err))
        if "attention_generic" not in report:
            report["attention_generic"] = dict(
                shape=list(qkv.shape), heads=heads, dtype=dname, max_abs_err=err,
                tol="1e-4 (fp32), 2e-2 (bf16)", ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, bound_unit=unit, fp32_fma_bound_ms=fma_ms,
            )
    for name, r in rows.items():
        report[name]["shapes"] = r
    return report


# ---------------------------------------------------------------------------
# phase 2, backward: gradients through the kernels' autograd Functions
# ---------------------------------------------------------------------------

BF16, FP32 = torch.bfloat16, torch.float32
# (H, W, C, dtype) of every groupnorm_silu input of one chairs forward
# (tests/test_torch_kernels.py::CHAIRS_GN records them from a forward).
CHAIRS_GN = [
    (8, 8, 1024, BF16), (64, 64, 256, BF16), (128, 128, 256, BF16), (32, 32, 512, BF16),
    (16, 16, 768, BF16), (64, 64, 512, BF16), (128, 128, 512, BF16), (32, 32, 256, BF16),
    (16, 16, 512, BF16), (8, 8, 768, BF16), (8, 8, 2048, BF16), (32, 32, 768, BF16),
    (8, 8, 1792, BF16), (16, 16, 1024, BF16), (16, 16, 1792, BF16), (16, 16, 1536, BF16),
    (16, 16, 1280, BF16), (32, 32, 1280, BF16), (32, 32, 1024, BF16), (64, 64, 768, BF16),
    (128, 128, 256, FP32),
]
# groupnorm_silu inputs of the fp32 UNets run on the card (edit-gate toy, tiny)
FP32_GN = [(16, 16, 32), (8, 8, 64), (8, 8, 128), (16, 16, 96), (16, 16, 16), (8, 8, 32),
           (8, 8, 48), (16, 16, 48)]
CHAIRS_ATTN = [(1024, 8, 64), (256, 12, 64), (64, 16, 64)]  # T, heads, head dim; bf16
FP32_ATTN = [(64, 4, 16), (64, 4, 8)]  # the edit-gate toy's middle block; tiny
HEADS_BY_COUNT_ATTN = [(256, 4, 192), (64, 4, 256)]  # heads-by-count chairs, 16^2 and 8^2; bf16
GRAD_TOL = {BF16: 1e-2, FP32: 1e-5}  # of the largest gradient magnitude


def grad_rel_err(fn, plain, inputs, seed) -> float:
    """max |grad via fn - grad via plain| / max |grad via plain| over every
    input, for the loss sum(out * r) with a random cotangent r."""
    leaves = [t.detach().clone().requires_grad_(True) for t in inputs]
    ref = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*leaves)
    gen = torch.Generator(device=out.device).manual_seed(seed)
    r = torch.randn(out.shape, generator=gen, device=out.device).to(out.dtype)
    got = torch.autograd.grad((out * r).float().sum(), leaves)
    want = torch.autograd.grad((plain(*ref) * r).float().sum(), ref)
    err = 0.0
    for g, w in zip(got, want):
        if not bool(g.isfinite().all()):
            return float("inf")
        err = max(err, max_err(g, w) / max(float(w.float().abs().max()), 1e-6))
    return err


def check_rel(name, got, want, tol) -> float:
    """max |got - want| <= tol * max |want|, everything finite; returns
    max |got - want|."""
    err = max_err(got, want)
    rel = err / max(float(want.float().abs().max()), 1e-30)
    ok = rel <= tol and bool(got.isfinite().all())
    say(f"  {name}: max_abs_err {err:.3e}, relative to the largest {rel:.2e} (tol {tol:g}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"{name} disagrees with its plain version")
    return err


# The backward kernels at the main path's shapes: the chairs train step's
# GroupNorm inputs at batch 8 (the largest, with FiLM: the second norm of a
# ResBlock), the widest, and an fp32 UNet's (one channel per group); the
# chairs attention at batch 8 (T 1024, 256, 64), the drag step's T=1024
# level at batch 1, the heads-by-count head dims at batch 1, and the fp32
# UNets' head dims 8 and 16. The first case of each is its kernels'
# headline row.
BWD_GN_CASES = [((8, 128, 128, 256), BF16, True), ((8, 64, 64, 512), BF16, False),
                ((1, 8, 8, 2048), BF16, True), ((1, 16, 16, 16), FP32, True), ((2, 16, 16, 96), FP32, True)]
BWD_ATTN_CASES = [(8, 1024, 8, 64, BF16), (8, 256, 12, 64, BF16), (8, 64, 16, 64, BF16), (1, 1024, 8, 64, BF16),
                  (1, 256, 4, 192, BF16), (1, 64, 4, 256, BF16), (2, 64, 4, 8, FP32), (1, 64, 4, 16, FP32)]
BWD_TOL = {BF16: 2e-2, FP32: 1e-5}  # of the largest value: one rounding to bf16, or fp32 sums in another order
# gn_bwd_reduce's partials, of the largest: fp32 sums in another order; in
# bf16 also a rounding tie of the emulated composition broken the other way
# now and then (the kernel forms xhat by one fma), one bf16 ulp of one term
GN_SUMS_TOL = {BF16: 1e-3, FP32: 1e-4}


def backward_kernel_checks(hk, dev, report) -> None:
    """Each backward kernel element by element against its plain twin on the
    same inputs (the reduce's partials, dx, dQ with the workspace, dK and
    dV), and its device ms beside the twin's, the bound and (attention) the
    backward of ``F.scaled_dot_product_attention``."""
    from ishapediting_tpu_torch.ops.nn import effective_groups
    from ishapediting_tpu_torch.utils.device import bound_ms, device_ms

    say("[2] backward kernels against their plain twins (main-path shapes)")
    gen = torch.Generator(device=dev).manual_seed(2)
    rows = {k: [] for k in ("gn_bwd_reduce", "gn_bwd_apply", "attn_bwd_dq", "attn_bwd_dkdv")}
    for shape, dtype, film in BWD_GN_CASES:
        x, scale, bias, f = gn_inputs(gen, shape, dtype, film, dev)
        gy = torch.randn(shape, generator=gen, device=dev).to(dtype)
        g = effective_groups(shape[-1], 32)
        part = hk.gn_stats_cuda(x, g)
        tag = f"{list(shape)} {str(dtype)[6:]}{' film' if film else ''}"
        red = hk.gn_bwd_reduce_cuda(x, part, gy, scale, bias, film=f)
        dx = hk.gn_bwd_apply_cuda(x, gy, red.stats, scale, bias, film=f)
        torch.cuda.synchronize()
        want = hk.gn_bwd_reduce_plain(x, part, gy, scale, bias, film=f)
        err_r = check_rel(f"gn_bwd_reduce {tag}, (S1, S2) partials", red.sums, want.sums, GN_SUMS_TOL[dtype])
        # the finished outputs: against the twin's, and bit for bit what the
        # twin's finish makes of the kernel's own partials (same sums, same order)
        cpu = [t.cpu() for t in (red.sums, red.stats[:, 0], red.stats[:, 1], scale, bias)]
        exact = hk.gn_bwd_finish_plain(*cpu, shape[1] * shape[2], f and tuple(t.cpu() for t in f))
        outs = [("mean, rstd", red.stats[:, :2], want.stats[:, :2]), ("A, B", red.stats[:, 2:], want.stats[:, 2:])]
        outs += [(k, getattr(red, k), getattr(want, k)) for k in ("dscale", "dbias", "dfs", "dfb")
                 if getattr(red, k) is not None]
        for what, got, w in outs:  # a gradient stored in bf16 also carries that one rounding
            tol = BWD_TOL[BF16] if got.dtype == BF16 else GN_SUMS_TOL[dtype]
            err_r = max(err_r, check_rel(f"gn_bwd_reduce {tag}, {what}", got, w, tol))
        if not all(torch.equal(a.cpu(), b) for a, b in zip(red[1:], exact) if a is not None):
            fail(f"gn_bwd_reduce {tag}: the finished outputs are not what its partials give in the twin's order")
        err_a = check_rel(f"gn_bwd_apply {tag}, dx", dx, hk.gn_bwd_apply_plain(x, gy, red.stats, scale, bias,
                                                                                film=f), BWD_TOL[dtype])
        red2 = hk.gn_bwd_reduce_cuda(x, part, gy, scale, bias, film=f)
        dx2 = hk.gn_bwd_apply_cuda(x, gy, red2.stats, scale, bias, film=f)
        if not all(a is None or torch.equal(a, b) for a, b in zip((*red, dx), (*red2, dx2))):
            fail(f"GroupNorm backward {tag}: two runs on one input differ")
        params = nbytes(part, scale, bias, *(f or ()))
        grads = nbytes(*(t for t in red[2:] if t is not None))
        rb_ms, rb_by = bound_ms(nbytes(x, gy, red.sums, red.stats) + params + grads, fp32_flops=16 * x.numel())
        ab_ms, ab_by = bound_ms(nbytes(x, gy, dx, red.stats) + params, fp32_flops=18 * x.numel())
        r_ms = device_ms(lambda: hk.gn_bwd_reduce_cuda(x, part, gy, scale, bias, film=f),
                         kernel="gn_bwd_reduce_kernel")
        a_ms = device_ms(lambda: hk.gn_bwd_apply_cuda(x, gy, red.stats, scale, bias, film=f),
                         kernel="gn_bwd_apply_kernel")
        rp_ms = device_ms(lambda: hk.gn_bwd_reduce_plain(x, part, gy, scale, bias, film=f), 5)
        ap_ms = device_ms(lambda: hk.gn_bwd_apply_plain(x, gy, red.stats, scale, bias, film=f), 5)
        all_ms = device_ms(lambda: hk.gn_silu_bwd_cuda(x, part, gy, scale, bias, film=f))
        say(f"    gn_bwd_reduce {r_ms:.4f} ms (plain {rp_ms:.4f}, bound {rb_ms:.4f}), gn_bwd_apply "
            f"{a_ms:.4f} ms (plain {ap_ms:.4f}, bound {ab_ms:.4f}); the whole backward {all_ms:.4f} ms "
            f"(the kernels {r_ms + a_ms:.4f}); two runs bit-equal")
        base = dict(shape=list(shape), dtype=str(dtype)[6:], film=film, library_ms=None, backward_ms=all_ms,
                    kernels_ms=r_ms + a_ms)
        rows["gn_bwd_reduce"].append(dict(base, ms=r_ms, plain_ms=rp_ms, bound_ms=rb_ms, bound_by=rb_by,
                                          max_abs_err=err_r))
        rows["gn_bwd_apply"].append(dict(base, ms=a_ms, plain_ms=ap_ms, bound_ms=ab_ms, bound_by=ab_by,
                                         max_abs_err=err_a))
    gn_backward_trace(hk, dev)
    for n, t, heads, ch, dtype in BWD_ATTN_CASES:
        qkv = torch.randn((n, t, heads * 3 * ch), generator=gen, device=dev).to(dtype)
        gout = torch.randn((n, t, heads * ch), generator=gen, device=dev).to(dtype)
        out = hk.attention_qkv(qkv, heads)
        kernel_route = hk.attention_bwd_route(dtype, ch)
        tag = f"T={t} H={heads} ch={ch} {str(dtype)[6:]} batch {n}, {kernel_route} route"
        dqkv = torch.zeros_like(qkv)
        lse, d, sq = hk.attn_bwd_dq_cuda(qkv, out, gout, heads, dqkv)
        hk.attn_bwd_dkdv_cuda(qkv, gout, lse, d, heads, dqkv, sq=sq)
        torch.cuda.synchronize()
        dq, lse_p, d_p = hk.attn_bwd_dq_plain(qkv, out, gout, heads)
        dk, dv = hk.attn_bwd_dkdv_plain(qkv, gout, lse, d, heads)
        got = dqkv.view(n, t, heads, 3, ch).unbind(3)
        tol = BWD_TOL[dtype]
        err_q = max(check_rel(f"attn_bwd_dq {tag}, {what}", a, b, tol)
                    for what, a, b in (("log-sum-exp", lse, lse_p), ("D", d, d_p), ("dQ", got[0], dq)))
        err_kv = max(check_rel(f"attn_bwd_dkdv {tag}, {what}", a, b, tol)
                     for what, a, b in (("dK", got[1], dk), ("dV", got[2], dv)))
        q_ms = device_ms(lambda: hk.attn_bwd_dq_cuda(qkv, out, gout, heads, dqkv), kernel="attn_bwd_dq_kernel")
        kv_ms = device_ms(lambda: hk.attn_bwd_dkdv_cuda(qkv, gout, lse, d, heads, dqkv, sq=sq),
                          kernel="attn_bwd_dkdv_kernel")
        qp_ms = device_ms(lambda: hk.attn_bwd_dq_plain(qkv, out, gout, heads), 5)
        kvp_ms = device_ms(lambda: hk.attn_bwd_dkdv_plain(qkv, gout, lse, d, heads), 5)
        leaves = [a.detach().requires_grad_(True)
                  for a in qkv.view(n, t, heads, 3, ch).permute(3, 0, 2, 1, 4).unbind(0)]
        o = F.scaled_dot_product_attention(*leaves, scale=ch ** -0.5)
        go = gout.view(n, t, heads, ch).transpose(1, 2)
        lib_ms = library_ms(lambda: torch.autograd.grad(o, leaves, go, retain_graph=True))
        # dQ's function needs three T^2*ch products (S, dP, dQ), dK and dV's
        # four (S, dP, dV, dK); about 8 fp32 operations per logit each.
        logits = 8.0 * n * heads * t * t
        work = [dict(tensor_flops=2.0 * k * n * heads * t * t * ch, fp32_flops=logits) if dtype == BF16
                else dict(fp32_flops=2.0 * k * n * heads * t * t * ch + logits) for k in (3, 4)]
        qb_ms, qb_by = bound_ms(nbytes(qkv, out, gout, lse, d) + nbytes(dqkv) // 3, **work[0])
        kvb_ms, kvb_by = bound_ms(nbytes(qkv, gout, lse, d) + 2 * nbytes(dqkv) // 3, **work[1])
        say(f"    attn_bwd_dq {q_ms:.4f} ms (plain {qp_ms:.4f}, bound {qb_ms:.4f} {qb_by}), attn_bwd_dkdv "
            f"{kv_ms:.4f} ms (plain {kvp_ms:.4f}, bound {kvb_ms:.4f} {kvb_by}); SDPA backward {lib_ms} ms")
        base = dict(shape=list(qkv.shape), heads=heads, dtype=str(dtype)[6:], kernel_route=kernel_route,
                    source=BWD_ATTN_SOURCES[kernel_route],
                    library_ms=lib_ms,
                    library="backward of F.scaled_dot_product_attention (dQ, dK, dV: both kernels' work)")
        rows["attn_bwd_dq"].append(dict(base, ms=q_ms, plain_ms=qp_ms, bound_ms=qb_ms, bound_by=qb_by,
                                        max_abs_err=err_q))
        rows["attn_bwd_dkdv"].append(dict(base, ms=kv_ms, plain_ms=kvp_ms, bound_ms=kvb_ms, bound_by=kvb_by,
                                          max_abs_err=err_kv))
        del o, leaves
    tols = {"gn_bwd_reduce": "bf16 1e-3, fp32 1e-4 of the largest partial, statistic and fp32 gradient; "
                             "2e-2 of the largest gradient stored in bf16",
            "gn_bwd_apply": "bf16 2e-2, fp32 1e-5 of the largest",
            "attn_bwd_dq": "bf16 2e-2, fp32 1e-5 of the largest", "attn_bwd_dkdv": "bf16 2e-2, fp32 1e-5 of the largest"}
    for name, r in rows.items():
        report[name] = dict(r[0], tol=tols[name], shapes=r)


def gn_backward_trace(hk, dev) -> None:
    """One ``GroupNormSiLU`` backward (bf16, FiLM, every gradient asked for)
    under the profiler: exactly the two backward kernels, once each."""
    from torch.profiler import ProfilerActivity, profile

    from ishapediting_tpu_torch.utils.device import kernel_rows

    gen = torch.Generator(device=dev).manual_seed(3)
    x, scale, bias, f = gn_inputs(gen, (2, 32, 32, 256), BF16, True, dev)
    leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias, *f)]
    y = hk.groupnorm_silu(leaves[0], leaves[1], leaves[2], film=tuple(leaves[3:]))
    gy = torch.randn(y.shape, generator=gen, device=dev).to(y.dtype)
    torch.autograd.grad(y, leaves, gy, retain_graph=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.autograd.grad(y, leaves, gy)
        torch.cuda.synchronize()
    names = sorted(f"{e.key[:60]} x{e.count}" for e in kernel_rows(prof))
    say(f"  one GroupNormSiLU backward's device work: {names}")
    if len(names) != 2 or not ("gn_bwd_apply_kernel" in names[0] and "gn_bwd_reduce_kernel" in names[1]) or \
            not all(n.endswith(" x1") for n in names):
        fail(f"a GroupNormSiLU backward ran {names}, not the two backward kernels once each")


def backward_checks(hk, dev, report) -> None:
    from ishapediting_tpu_torch.ops.attention import dense_qkv_attention

    backward_kernel_checks(hk, dev, report)
    say("[2] backward: autograd through each kernel's Function (kernel forward, backward kernels) "
        "against autograd through the plain composition, batch 1")
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = {"gn": 0.0, "attention": 0.0, "attention_generic": 0.0}
    cases = [(h, w, c, dt) for h, w, c, dt in CHAIRS_GN] + [(h, w, c, FP32) for h, w, c in FP32_GN]
    reset(hk)
    for h, w, c, dtype in cases:
        for film in (False, True):
            x, scale, bias, f = gn_inputs(gen, (1, h, w, c), dtype, film, dev)
            if film:
                fn = lambda a, s, b, f1, f2: hk.groupnorm_silu(a, s, b, film=(f1, f2))  # noqa: E731
                plain = lambda a, s, b, f1, f2: hk.groupnorm_silu_plain(a, s, b, film=(f1, f2))  # noqa: E731
            else:
                fn, plain = hk.groupnorm_silu, hk.groupnorm_silu_plain
            err = grad_rel_err(fn, plain, (x, scale, bias, *(f or ())), seed=c)
            worst["gn"] = max(worst["gn"], err)
            if not err <= GRAD_TOL[dtype]:
                fail(f"groupnorm_silu gradient at [1,{h},{w},{c}] {dtype} film {film}: relative error {err:.2e}")
    say(f"  groupnorm_silu, {len(cases)} inputs (21 chairs, {len(FP32_GN)} fp32 UNet) with and without FiLM: "
        f"largest relative gradient error {worst['gn']:.2e} (tol 1e-2 bf16, 1e-5 fp32) ok")
    attn_cases = [(a, BF16) for a in CHAIRS_ATTN + HEADS_BY_COUNT_ATTN] + [(a, FP32) for a in FP32_ATTN]
    for (t, heads, ch), dtype in attn_cases:
        qkv = torch.randn((1, t, heads * 3 * ch), generator=gen, device=dev).to(dtype)
        err = grad_rel_err(lambda q: hk.attention_qkv(q, heads),
                           lambda q: dense_qkv_attention(q, heads), (qkv,), seed=t + ch)
        route = hk.attention_route(dtype, ch)
        worst[route] = max(worst[route], err)
        ok = err <= GRAD_TOL[dtype]
        say(f"  {route} gradient T={t} H={heads} ch={ch} {str(dtype)[6:]}: relative error "
            f"{err:.2e} (tol {GRAD_TOL[dtype]:g}) {'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"{route} gradient disagrees with the plain composition's")
    # each Function backward launched its two kernels, and nothing else ran the plain composition
    want_gn, want_attn = 2 * len(cases), len(attn_cases)
    got = dict(hk.LAUNCHES)
    say(f"  launches in the gradient checks: {got}")
    if (got["gn_bwd_reduce"], got["gn_bwd_apply"], got["attn_bwd_dq"], got["attn_bwd_dkdv"]) != (
            want_gn, want_gn, want_attn, want_attn):
        fail(f"the gradient checks' backward launches {got} are not {want_gn} per GroupNorm kernel and "
             f"{want_attn} per attention kernel")
    report["gn_stats"]["backward_rel_err"] = report["gn_norm"]["backward_rel_err"] = worst["gn"]
    report["attention"]["backward_rel_err"] = worst["attention"]
    report["attention_generic"]["backward_rel_err"] = worst["attention_generic"]
    report["gn_bwd_reduce"]["backward_rel_err"] = report["gn_bwd_apply"]["backward_rel_err"] = worst["gn"]
    report["attn_bwd_dq"]["backward_rel_err"] = report["attn_bwd_dkdv"]["backward_rel_err"] = max(
        worst["attention"], worst["attention_generic"])


# ---------------------------------------------------------------------------
# phase 2, bias epilogue: every shape the benchmark configurations give it
# ---------------------------------------------------------------------------

# the epilogue's timed rows: (rows, C, dtype, form), the first of each kernel its headline
EPILOGUE_TIMED = {
    "bias_add": [(32 * 128 * 128, 256, "bfloat16", "plain"), (32 * 32 * 32, 1536, "bfloat16", "plain"),
                 (32 * 128 * 128, 192, "float32", "plain"), (32 * 128 * 128, 6, "float32", "plain")],
    "bias_residual": [(32 * 128 * 128, 256, "bfloat16", "fused"), (32 * 128 * 128, 256, "bfloat16", "fused_skip"),
                      (32 * 32 * 32, 512, "bfloat16", "fused_skip"), (32 * 8 * 8, 1024, "bfloat16", "fused")],
}


def epilogue_checks(hk, dev, report) -> None:
    """The bias epilogue at every ([rows, C], dtype, form) that a forward of
    either benchmark configuration (``tools/bias_epilogue_bench.py``'s
    ``cell_configs``) gives it at batch 1, 2 (the main path's) and 32 (the
    benchmark's): the kernel into a new tensor and, with no gradient
    wanted, into y's own buffer, each ``torch.equal`` to the plain
    composition; each launch counted. Then, under autograd, the plain
    composition itself (output and gradients bit-equal, no launch, y
    untouched), and each kernel's device ms against its bytes bound and the
    eager adds it replaced at ``EPILOGUE_TIMED``."""
    from ishapediting_tpu_torch.tools import bias_epilogue_bench as beb

    say("[2] bias epilogue against the plain composition at every shape of a chairs and an adm128 forward "
        "(batch 1, 2, 32)")
    shapes = sorted({c for cfg in beb.cell_configs().values() for batch in (1, 2, 32)
                     for c in beb.forward_epilogues(cfg, batch)}, key=str)
    gen = torch.Generator(device=dev).manual_seed(3)
    reset(hk)
    worst = 0.0
    for (rows, c), dtype, form in shapes:
        y, b, res, rb = beb.inputs(rows, c, dtype, form, gen)
        want = hk.bias_epilogue_plain(y, b, res, rb)
        new = hk.bias_epilogue_cuda(y, b, res, rb)
        with torch.no_grad():
            mine = hk.bias_epilogue(y, b, res, rb)  # into y's own buffer
        ok = torch.equal(new, want) and torch.equal(mine, want) and mine.data_ptr() == y.data_ptr()
        worst = max(worst, float((new.float() - want.float()).abs().max()))
        if not ok:
            fail(f"bias epilogue [{rows}, {c}] {dtype} {form}: not bit-equal to the plain composition "
                 f"(largest difference {worst:g})")
        del y, b, res, rb, want, new, mine
    torch.cuda.synchronize()
    n_plain = sum(f == "plain" for _, _, f in shapes)
    want_n = dict(zero_counts(hk), bias_add=2 * n_plain, bias_residual=2 * (len(shapes) - n_plain))
    if dict(hk.LAUNCHES) != want_n:
        fail(f"bias epilogue checks: launches {dict(hk.LAUNCHES)} are not {want_n}")
    say(f"  {len(shapes)} shapes ({n_plain} plain, {len(shapes) - n_plain} fused; C from "
        f"{min(s[0][1] for s in shapes)} to {max(s[0][1] for s in shapes)}, bf16 and fp32): bit-equal, "
        f"into a new tensor and into y's buffer")
    grad_worst = 0.0
    reset(hk)
    for dtype in (BF16, FP32):
        for form in ("plain", "fused", "fused_skip"):
            y, b, res, rb = beb.inputs(2 * 16 * 16, 256, dtype, form, gen)
            y0, dout = y.clone(), torch.randn(y.shape, generator=gen, device=dev).to(dtype)
            got, ref = [], []
            for fn, out in ((hk.bias_epilogue, got), (hk.bias_epilogue_plain, ref)):
                leaves = [None if t is None else t.detach().requires_grad_(True) for t in (y, b, res, rb)]
                o = fn(*leaves)
                out.append(o)
                out.extend(torch.autograd.grad(o, [t for t in leaves if t is not None], dout))
            for g, r in zip(got, ref):
                if g.dtype != r.dtype or not torch.equal(g, r):
                    fail(f"bias epilogue under autograd, {form} {dtype}: output or gradient differs from "
                         f"autograd through the composition")
                grad_worst = max(grad_worst, float((g.float() - r.float()).abs().max()))
            if not torch.equal(y, y0):
                fail(f"bias epilogue under autograd, {form} {dtype}: wrote into y")
    if any(hk.LAUNCHES.values()):
        fail(f"bias epilogue under autograd launched {dict(hk.LAUNCHES)}")
    say("  under autograd (bf16 and fp32, three forms): the plain composition, no launch, gradients bit-equal")
    for kernel, timed in EPILOGUE_TIMED.items():
        rows = []
        for r, c, dtype, form in timed:
            row = beb.bench(r, c, dtype, form)
            if not row["bit_equal"]:
                fail(f"bias epilogue [{r}, {c}] {dtype} {form}: the timed run is not bit-equal")
            rows.append(dict(shape=[r, c], dtype=dtype, form=form, ms=row["kernel_ms"], plain_ms=row["eager_ms"],
                             bound_ms=row["bound_ms"], library_ms=None, vec=row["vec"], max_abs_err=0.0))
            say(f"    {kernel} [{r}, {c}] {dtype} {form}: {row['kernel_ms']:.4f} ms ({row['kernel_pct_of_bound']:.1f}% "
                f"of its bound {row['bound_ms']:.4f}), the eager adds {row['eager_ms']:.4f} ms, vectors of {row['vec']}")
        head = rows[0]
        report[kernel] = dict(
            shape=head["shape"], dtype=head["dtype"], form=head["form"], max_abs_err=worst,
            tol="0: torch.equal at every shape of both configurations at batch 1, 2, 32",
            ms=head["ms"], plain_ms=head["plain_ms"], library_ms=None,  # no one PyTorch call adds a bias alone
            bound_ms=head["bound_ms"], bound_by="bytes", shapes=rows, backward_rel_err=grad_worst,
            checked_shapes=len(shapes))


# ---------------------------------------------------------------------------
# phase 3: the whole UNet, card against CPU, small input
# ---------------------------------------------------------------------------


# phase 3's bf16 miniature UNet (head dim 64: the wgmma attention kernel)
MINI_BF16 = dict(image_size=16, in_channels=6, model_channels=64, out_channels=12, num_res_blocks=1,
                 attention_ds=(2,), channel_mult=(1, 2), num_head_channels=64)


def signal_model(cfg, gen):
    """A UNet of ``cfg`` on the CPU with random weights from ``gen``, its
    zero modules given signal too, so that every path carries it."""
    from ishapediting_tpu_torch.models.unet import UNetModel, init_unet_

    model = init_unet_(UNetModel(cfg), gen)
    with torch.no_grad():
        for p in model.parameters():
            if not p.any():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
    return model


def unet_card_check(hk, dev, cfg, tol, what):
    """One UNet forward on the card (kernels) against the same module on
    the CPU (plain versions), small input: relative L2 error of the output
    and the feature tap <= ``tol``, and the launch counts of one forward."""
    from ishapediting_tpu_torch.models.unet import epilogue_calls_per_forward

    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(5)
    model = signal_model(cfg, gen).eval()
    x = torch.randn((2, cfg.image_size, cfg.image_size, cfg.in_channels), generator=gen)
    t = torch.tensor([3, 700])
    with torch.no_grad():
        out_c, feat_c = model(x, t, feat_layer=1)
        model.to(dev)
        reset(hk)
        out_g, feat_g = model(x.to(dev), t.to(dev), feat_layer=1)
    torch.cuda.synchronize()
    gn, attn, plain, fused, _ = calls_per_forward(cfg)
    want = dict(zero_counts(hk), gn_stats=gn, gn_norm=gn, bias_add=plain, bias_residual=fused)
    want[hk.attention_route(cfg.torch_compute_dtype, cfg.num_head_channels)] = attn
    got = dict(hk.LAUNCHES)
    say(f"  {what}: launches {got} (want {want})")
    if got != want:
        fail(f"UNet ({what}) launches {got} are not {want}")
    if (plain, fused) != epilogue_calls_per_forward(cfg):  # the smoke's own count, against the layout's
        fail(f"UNet ({what}): the smoke counts {(plain, fused)} epilogues, models/unet.py "
             f"{epilogue_calls_per_forward(cfg)}")
    for name, a, b in (("output", out_g, out_c), ("feature tap", feat_g, feat_c)):
        a = a.to(cpu).float()
        rel = float((a - b).norm() / b.norm())
        ok = rel <= tol and bool(a.isfinite().all()) and a.shape == b.shape
        say(f"  {name} {list(a.shape)}: relative L2 error {rel:.3e} (tol {tol:g}, {what}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            fail(f"UNet ({what}) {name} on the card disagrees with the CPU")


def edit_gate_on_card(hk, counter, totals, device="cuda") -> dict:
    """The committed toy system's gate on the card (fp32: gn kernels and the
    generic attention), launch counts exact, then the same run on the CPU:
    per-step motion losses within 1e-3 of the CPU's (relative)."""
    from ishapediting_tpu_torch.edit.gate import engine_from_asset, gate_drags

    engine, asset = engine_from_asset(device=device)
    per = calls_per_forward(engine.config.unet)
    route = hk.attention_route(engine.config.unet.torch_compute_dtype,
                               engine.config.unet.num_head_channels)
    say("  edit gate (tests/assets/edit_gate.npz, toy fp32 UNet 16x16x24, w_time 12): "
        "inversion with the recorded noises, scale-0 and guided replay drags, chunk 4")
    sync()
    reset(hk)
    counter.n = 0
    t0 = time.perf_counter()
    base, guided, original, edited = gate_drags(engine, asset)
    sync()
    wall = time.perf_counter() - t0
    check_counts(hk, "edit gate", counter.n, per, totals, route, steps=len(base) + len(guided),
                 back=backward_nodes(engine.config.unet, engine.config.edit.feat_layer))
    cpu_engine, _ = engine_from_asset(device="cpu")
    cbase, cguided, _, _ = gate_drags(cpu_engine, asset)
    reduction = 1.0 - guided[-1] / base[-1]
    need = 0.5 * float(asset["achieved_reduction"])
    rel = max(float(np.max(np.abs(a - b) / np.abs(b))) for a, b in ((base, cbase), (guided, cguided)))
    say(f"  edit gate: motion {base[-1]:.4f} -> {guided[-1]:.4f}, reduction {reduction:+.4f} "
        f"(need >= {need:.4f}: half of the recorded {float(asset['achieved_reduction']):.4f}; "
        f"CPU run {1 - cguided[-1] / cbase[-1]:+.4f}), per-step motion losses vs CPU: relative "
        f"error {rel:.2e} (tol 1e-3), edited mesh {len(edited.vertices)} vertices, wall {wall:.1f} s")
    if not (reduction >= need and rel <= 1e-3 and len(edited.vertices) > 0):
        fail("the edit gate does not hold on the card")
    return dict(reduction=reduction, cpu_reduction=1 - cguided[-1] / cbase[-1], rel_err=rel, wall_s=wall)


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------


class ForwardCounter:
    """Counts UNet forwards through a global module hook (no code change),
    and keeps the host time at which each one started."""

    def __init__(self, unet_cls):
        self.n = 0
        self.starts = []
        self._cls = unet_cls
        self._handle = torch.nn.modules.module.register_module_forward_pre_hook(self._hook)

    def _hook(self, mod, args):
        if isinstance(mod, self._cls):
            self.n += 1
            self.starts.append(time.perf_counter())

    def close(self):
        self._handle.remove()


class DecoderCounter:
    """Counts the triplane decoder's MLP calls that launch its bias
    epilogues (on the card, no gradient wanted: decodes, not decoder
    losses) by wrapping ``ops/triplane.py::_mlp_from_sincos``, through which
    every decode goes (no code change). Each runs the decoder's three dense
    layers, so launches three plain epilogues; ``reset`` zeroes the count
    with the launch counters."""

    LAYERS = 3

    def __init__(self):
        from ishapediting_tpu_torch.ops import hopper_kernels as hk
        from ishapediting_tpu_torch.ops import triplane

        self.n = 0
        real = triplane._mlp_from_sincos

        def counting(dec, sin_x, cos_x, compute_dtype):
            params = (p for i in (1, 3, 5) for p in dec[i].parameters())
            if sin_x.is_cuda and sin_x.numel() and not hk.needs_grad(sin_x, cos_x, *params):
                self.n += 1
            return real(dec, sin_x, cos_x, compute_dtype)

        triplane._mlp_from_sincos = counting


DECODER = None  # the process's DecoderCounter, made by main()


def reset(hk) -> None:
    """Zero the launch counters and the decoder's call count."""
    hk.reset_launch_counts()
    DECODER.n = 0


def with_decoder(want: dict) -> dict:
    """``want`` plus the plain bias epilogues of the decoder calls since the
    last ``reset``."""
    return dict(want, bias_add=want.get("bias_add", 0) + DecoderCounter.LAYERS * DECODER.n)


def zero_counts(hk) -> dict:
    return {k: 0 for k in hk.LAUNCHES}


def epilogues(ucfg, cut_min=None) -> tuple:
    """(plain, fused) bias epilogues of one forward that wants no gradient
    (under autograd none launches: ``hk.bias_epilogue`` takes the plain
    composition) of a UNet of config ``ucfg``. ``cut_min``: layers with that
    many output features or more are cut over the model axis
    (``parallel/tensor.py``): each adds its bias on its slice (a plain
    epilogue), and a ResBlock or attention block whose last product is cut
    adds its residual by the plain composition. Uncut, it is
    ``models/unet.py::epilogue_calls_per_forward``, which
    ``unet_card_check`` holds it to."""
    from ishapediting_tpu_torch.models.unet import build_layout

    def layer(l):
        cut = cut_min is not None and l.out_ch >= cut_min
        if l.kind == "res":  # conv1, FiLM; conv2 with the skip conv and the residual, or each alone when cut
            return (2 + 1 + (l.in_ch != l.out_ch), 0) if cut else (2, 1)
        if l.kind == "attn":  # qkv; the projection with the residual, or alone when cut
            return (2, 0) if cut else (1, 1)
        return int(l.use_conv), 0  # the input conv, a resample's conv

    layout = build_layout(ucfg)
    counts = [layer(l) for b in (*layout.input_blocks, layout.middle_block, *layout.output_blocks) for l in b]
    # and outside the blocks: the time MLP's two dense layers, the output conv
    return 3 + sum(c[0] for c in counts), sum(c[1] for c in counts)


def film_epilogues(ucfg, recompute=None) -> int:
    """Plain bias epilogues that a forward under autograd still launches
    when only its input wants the gradient (drag and fit steps; the UNet's
    weights are frozen): nothing on the time embedding's path wants one, so
    the time MLP's two dense layers and each ResBlock's FiLM projection take
    the kernel. ``recompute`` (the feature tap's output block, or "head"):
    the FiLM projections that a remat backward reruns, one per ResBlock of
    the blocks it recomputes (``kernel_calls_recomputed``'s)."""
    from ishapediting_tpu_torch.models.unet import build_layout

    layout = build_layout(ucfg)
    blocks = [*layout.input_blocks, layout.middle_block]
    if recompute is None:
        return 2 + sum(l.kind == "res" for b in blocks + list(layout.output_blocks) for l in b)
    n = len(layout.output_blocks) if recompute == "head" else recompute + 1
    return sum(l.kind == "res" for b in blocks + list(layout.output_blocks[:n]) for l in b)


def calls_per_forward(ucfg, cut_min=None) -> tuple:
    """(GroupNorm-SiLU calls, attention calls, plain epilogues, fused
    epilogues) of one forward that wants no gradient (``epilogues``), and
    the plain epilogues of one that wants it for its input alone
    (``film_epilogues``)."""
    from ishapediting_tpu_torch.models.unet import kernel_calls_per_forward

    return kernel_calls_per_forward(ucfg) + epilogues(ucfg, cut_min=cut_min) + (film_epilogues(ucfg),)


def calls_recomputed(ucfg, feat_layer) -> tuple:
    """What a remat drag step's backward recomputes (its feature tap at
    ``feat_layer``): GroupNorm-SiLU calls, attention calls, FiLM epilogues."""
    from ishapediting_tpu_torch.models.unet import kernel_calls_recomputed

    return kernel_calls_recomputed(ucfg, feat_layer) + (film_epilogues(ucfg, feat_layer),)


def backward_nodes(ucfg, feat_layer: int = -1) -> tuple:
    """(GroupNorm-SiLU, attention) autograd nodes that one backward pass
    runs, each launching its two backward kernels once: a drag step's loss
    reaches the feature tap at ``feat_layer`` (the blocks
    ``kernel_calls_recomputed`` lists); a fit or train step's
    (``feat_layer`` -1) the output, so every call of the forward."""
    from ishapediting_tpu_torch.models.unet import kernel_calls_per_forward, kernel_calls_recomputed

    return kernel_calls_per_forward(ucfg) if feat_layer < 0 else kernel_calls_recomputed(ucfg, feat_layer)


def backward_launches(hk, ucfg, feat_layer: int = -1, steps: int = 1) -> dict:
    """The backward kernels' launches of ``steps`` backward passes (see
    ``backward_nodes``), as a LAUNCHES-keyed dict."""
    gn, attn = backward_nodes(ucfg, feat_layer)
    return dict(zero_counts(hk), gn_bwd_reduce=gn * steps, gn_bwd_apply=gn * steps,
                attn_bwd_dq=attn * steps, attn_bwd_dkdv=attn * steps)


def check_counts(hk, phase, forwards, per_fwd, totals, attn_kernel="attention", again=(0, 0, 0), steps=0,
                 back=(0, 0)):
    """Launches of the run just made: each GroupNorm-SiLU call launches
    gn_stats and gn_norm, each attention call ``attn_kernel`` only, each
    forward that wants no gradient its plain and fused bias epilogues, one
    that wants it for its input its time-embedding path's (``per_fwd``:
    ``calls_per_forward``), and the decoder's calls theirs
    (``with_decoder``); each of ``steps`` backward passes (each after one
    forward under autograd) launches gn_bwd_reduce and gn_bwd_apply for
    each of ``back[0]`` GroupNorm-SiLU nodes and attn_bwd_dq and
    attn_bwd_dkdv for each of ``back[1]`` attention nodes
    (``backward_nodes``), and under remat also recomputes ``again``
    (``calls_recomputed``)."""
    gn, attn, plain, fused, film = per_fwd
    quiet = forwards - steps  # the forwards that want no gradient
    want = dict(zero_counts(hk), gn_stats=gn * forwards + again[0] * steps,
                gn_norm=gn * forwards + again[0] * steps, gn_bwd_reduce=back[0] * steps,
                gn_bwd_apply=back[0] * steps, attn_bwd_dq=back[1] * steps, attn_bwd_dkdv=back[1] * steps,
                bias_add=plain * quiet + (film + again[2]) * steps, bias_residual=fused * quiet)
    want[attn_kernel] = attn * forwards + again[1] * steps
    want = with_decoder(want)
    got = dict(hk.LAUNCHES)
    extra = (f", {steps} backward passes of {back[0]}/{back[1]} nodes, {again[0] * steps}/{again[0] * steps}/"
             f"{again[1] * steps}/{again[2] * steps} forward launches recomputed" if steps else "")
    say(f"  launches in {phase}: {got} for {forwards} UNet forwards and {DECODER.n} decoder calls{extra} "
        f"(want {want})")
    if forwards <= 0 or got != want:
        fail(f"{phase}: launch counts {got} are not {want}")
    for k, v in got.items():
        totals[k] = totals.get(k, 0) + v


def run_cli(hk, counter, per_fwd, totals, sampler_flag, phase,
            preset_name="chairs", device="cuda", res=256, keep=False, decode=True):
    import numpy as np

    from ishapediting_tpu_torch.cli.generate import main as generate
    from ishapediting_tpu_torch.config import preset

    h, w, c = preset(preset_name).latent_shape
    out = os.path.join(WORK, phase)
    shutil.rmtree(out, ignore_errors=True)
    argv = ["--random_init", "--preset", preset_name, sampler_flag, "--num_steps", "10",
            "--num_samples", "2", "--batch_size", "2", "--shape_resolution", str(res),
            "--save_dir", out, "--seed", "0", "--device", device] + ([] if decode else ["--skip_decode"])
    say(f"  python -m ishapediting_tpu_torch.cli.generate {' '.join(argv)}")
    buf = io.StringIO()
    sync()
    reset(hk)
    counter.n = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        samples = generate(argv)
    sync()
    wall = time.perf_counter() - t0
    check_counts(hk, phase, counter.n, per_fwd, totals)
    log = buf.getvalue()
    sample_s = float(next(l for l in log.splitlines() if l.startswith("ddpm time:")).split(":")[1])
    if samples.shape != (2, h, w, c) or not np.isfinite(samples).all():
        fail(f"{phase}: latents {samples.shape} not finite or of the wrong shape")
    for i in range(2):
        tri = np.load(os.path.join(out, "triplanes", f"{i}.npy"))
        obj = os.path.join(out, "objects", f"{i}.obj")
        if tri.shape != (c, h, w) or not np.isfinite(tri).all():
            fail(f"{phase}: triplane {i} has shape {tri.shape} or is not finite")
        if decode and (not os.path.exists(obj) or os.path.getsize(obj) == 0):
            fail(f"{phase}: mesh {i} is missing or empty")
    decoded = "--skip_decode: no meshes"
    if decode:
        decode_s = float(next(l for l in log.splitlines() if l.startswith("decode time:")).split(":")[1])
        size_mb = sum(os.path.getsize(os.path.join(out, "objects", f"{i}.obj")) for i in range(2)) / 1e6
        decoded = f"decode+mesh+write {decode_s:.3f} s, OBJ {size_mb:.0f} MB"
    if keep and phase == "ddim":  # phase 8 decodes these planes again
        shutil.copytree(os.path.join(out, "triplanes"), KEPT_TRIPLANES, dirs_exist_ok=True)
    shutil.rmtree(out)  # the 256^3 meshes of random weights are large
    say(f"  {phase}: sampling {sample_s:.3f} s for 2 samples ({2 / sample_s:.3f} samples/s, "
        f"first run, launch overheads included), {decoded}, wall {wall:.1f} s")
    return sample_s, samples


def run_engine(hk, counter, per_fwd, totals, cfg, label, phase="engine",
               attn_kernel="attention", device="cuda"):
    import numpy as np

    from ishapediting_tpu_torch.edit.engine import DragEngine

    res = cfg.edit.shape_resolution
    say(f"  DragEngine({label}).update_latent_params(seed=0) -> get_mesh at {res}^3")
    engine = DragEngine(cfg, seed=0, device=device)
    sync()
    reset(hk)
    counter.n = 0
    t0 = time.perf_counter()
    lat = engine.update_latent_params(seed=0)
    sync()
    wall = time.perf_counter() - t0
    check_counts(hk, phase, counter.n, per_fwd, totals, attn_kernel)
    feats = engine.feature_guidance
    walls = engine.last_mesh_walls
    ok = (
        lat.shape == (1,) + cfg.latent_shape and np.isfinite(lat).all()
        and feats is not None and feats.shape[0] == cfg.edit.w_time
        and bool(feats.float().isfinite().all())
        and len(engine.mesh.vertices) > 0 and len(engine.mesh.triangles) > 0
    )
    say(f"  {phase}: latent {lat.shape}, guidance cache {list(feats.shape)} {feats.dtype}, "
        f"mesh {len(engine.mesh.vertices)} vertices / {len(engine.mesh.triangles)} triangles, "
        f"mesh walls {fmt_walls(walls)}, wall {wall:.1f} s")
    if not ok:
        fail(f"{phase}: latent, guidance features or mesh not as expected")
    return engine, lat, wall


def fmt_walls(walls) -> str:
    return json.dumps({k: round(v, 3) if isinstance(v, float) else v for k, v in walls.items()})


def counted(hk, counter, per_fwd, totals, phase, fn, forwards, **recompute):
    """Run ``fn`` with the launch counters and the forward counter set to 0
    just before and read just after: ``forwards`` UNet forwards, each
    launching its calls per forward (plus the backward passes and remat
    recomputes of ``recompute``, as ``check_counts`` takes them; its
    ``steps`` may be a function, called after the run). Returns (fn's
    result, wall s, peak device GiB of the run)."""
    sync()
    reset(hk)
    counter.n = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    sync()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    if counter.n != forwards:
        fail(f"{phase}: {counter.n} UNet forwards, expected {forwards}")
    if callable(recompute.get("steps")):
        recompute["steps"] = recompute["steps"]()
    check_counts(hk, phase, counter.n, per_fwd, totals, **recompute)
    return out, wall, peak


def check_mesh(phase, mesh, walls=None):
    ok = len(mesh.vertices) > 0 and len(mesh.triangles) > 0 and bool(np.isfinite(mesh.vertices).all())
    say(f"  {phase}: mesh {len(mesh.vertices)} vertices / {len(mesh.triangles)} triangles"
        + (f", mesh walls {fmt_walls(walls)}" if walls else ""))
    if not ok:
        fail(f"{phase}: empty or non-finite mesh")


def chairs_edit_runs(hk, counter, per_fwd, totals, engine, x0) -> dict:
    """The editing path on the chairs engine after ``update_latent_params``:
    resample drag over the whole w_time walk (step times from a synced
    progress callback, one step per chunk), inversion of the generated
    latent, replay drag, and the guided fit of the first generated mesh."""
    w_time = engine.config.edit.w_time
    first_mesh = engine.mesh0
    v = first_mesh.vertices
    handle = v[np.argmax(v[:, 0])].astype(np.float32)
    src, tgt = handle[None], (handle + np.array([0.1, 0, 0], np.float32))[None]
    out = {}

    ticks = []

    def tick(_):
        sync()
        ticks.append(time.perf_counter())

    def drag(mode):
        ticks.clear()
        ticks.append(time.perf_counter())
        return engine.drag_edit(src, tgt, seed=0, chunk=1, noise_mode=mode, progress_callback=tick)

    for mode in ("resample", "replay"):
        if mode == "replay":
            say(f"  DragEngine.latent_inversion of the generated latent ({w_time} steps, "
                f"inversion_chunk {engine.config.edit.inversion_chunk})")
            _, wall, _ = counted(hk, counter, per_fwd, totals, "inversion",
                              lambda: engine.latent_inversion(x0),
                              -(-w_time // engine.config.edit.inversion_chunk))
            ok = (engine.feature_guidance.shape[0] == w_time
                  and engine.variances.shape == (w_time, 1) + engine.config.latent_shape
                  and all(bool(t.float().isfinite().all()) for t in
                          (engine.w, engine.feature_guidance, engine.variances, engine.variance_noise)))
            if not ok:
                fail("inversion: recorded state not as expected")
            out["inversion_s"] = engine.last_phase_walls["device_s"]
            check_mesh("inversion", engine.mesh0, engine.last_mesh_walls)
            say(f"  inversion: {out['inversion_s']:.3f} s for {w_time} steps on the card, wall "
                f"{wall:.1f} s with the mesh")
        say(f"  DragEngine.drag_edit noise_mode={mode!r}, {w_time} guided steps, one handle")
        mesh, wall, _ = counted(hk, counter, per_fwd, totals, f"drag {mode}", lambda: drag(mode), w_time,
                                steps=w_time, back=backward_nodes(engine.config.unet, engine.config.edit.feat_layer))
        steps = np.diff(ticks)
        losses = engine.last_drag_losses
        if not (np.isfinite(engine.edited_latent).all() and np.isfinite(losses["motion"]).all()
                and len(losses["motion"]) == w_time):
            fail(f"drag {mode}: latent or losses not finite")
        check_mesh(f"drag {mode}", mesh, engine.last_mesh_walls)
        steady = float(np.median(steps[2:]))
        out[f"drag_{mode}_s_per_step"] = steady
        out[f"drag_{mode}_walls"] = dict(engine.last_phase_walls)
        out[f"drag_{mode}_mesh_walls"] = dict(engine.last_mesh_walls)
        say(f"  drag {mode}: {steady:.4f} s/step steady state (median of steps 3-{w_time}; "
            f"first {steps[0]:.3f} s), motion loss {losses['motion'][0]:.4g} -> "
            f"{losses['motion'][-1]:.4g}, phase walls {fmt_walls(engine.last_phase_walls)}, "
            f"wall {wall:.1f} s")

    fit_dir = os.path.join(WORK, "fit")
    fit_steps = 3
    shutil.rmtree(fit_dir, ignore_errors=True)
    say(f"  DragEngine.fit_real_shape of the first generated mesh ({len(first_mesh.triangles)} "
        f"triangles), fit_steps {fit_steps}, {engine.config.fit.points_size} points, batch "
        f"{engine.config.fit.batch_points}")
    _, wall, _ = counted(hk, counter, per_fwd, totals, "fit",
                         lambda: engine.fit_real_shape(mesh=first_mesh, path=fit_dir, seed=0,
                                                       fit_steps=fit_steps),
                         fit_steps + -(-w_time // engine.config.edit.inversion_chunk),
                         steps=fit_steps, back=backward_nodes(engine.config.unet))
    h, w, c = engine.config.latent_shape
    tri = np.load(os.path.join(fit_dir, "tri_feat.npy"))
    recon = os.path.join(fit_dir, "mesh_recon.obj")
    if tri.shape != (1, c, h, w) or not np.isfinite(tri).all() or os.path.getsize(recon) == 0:
        fail("fit: tri_feat.npy or mesh_recon.obj not as expected")
    check_mesh("fit", engine.mesh0, engine.last_mesh_walls)
    walls = engine.last_phase_walls
    out["fit_s_per_step"] = walls["guided_s"] / fit_steps
    out["fit_walls"] = dict(walls)
    say(f"  fit: {walls['guided_s'] / fit_steps:.4f} s/step over {fit_steps} guided steps (cuDNN "
        f"timing the backward shapes of the head included), inversion "
        f"{walls['inversion_device_s']:.3f} s, phase walls {fmt_walls(walls)}, wall {wall:.1f} s")
    shutil.rmtree(fit_dir)  # the 256^3 OBJ of random weights is large
    return out


def engine_steps(cfg) -> int:
    from ishapediting_tpu_torch.core.schedule import make_schedule

    d = cfg.diffusion
    return make_schedule(d.base_steps, d.noise_schedule, d.timestep_respacing).num_timesteps


def run_cli_edit(hk, counter, per_fwd, totals, preset_name="chairs", num_steps=200,
                 edit_steps=10, device="cuda", keep=False) -> float:
    """``cli.edit`` at chairs width: 200-step generation (w_time 170), one
    handle, a 10-step fast drag, original and edited 256^3 meshes."""
    from ishapediting_tpu_torch.cli.edit import main as edit_main
    from ishapediting_tpu_torch.config import preset

    out = os.path.join(WORK, "cli_edit")
    shutil.rmtree(out, ignore_errors=True)
    argv = ["--random_init", "--preset", preset_name, "--num_steps", str(num_steps),
            "--latent_seed", "0", "--source", "0.5", "0", "0", "--target", "0.6", "0", "0",
            "--edit_steps", str(edit_steps), "--out", out, "--device", device]
    cfg = preset(preset_name, num_steps)
    say(f"  python -m ishapediting_tpu_torch.cli.edit {' '.join(argv)}")
    buf = io.StringIO()

    def run():
        with contextlib.redirect_stdout(buf):
            return edit_main(argv)

    drags = min(edit_steps, cfg.edit.w_time)
    engine, wall, _ = counted(hk, counter, per_fwd, totals, "cli.edit", run, engine_steps(cfg) + drags,
                              steps=drags, back=backward_nodes(cfg.unet, cfg.edit.feat_layer))
    for f in ("original.obj", "edit00.obj", "EditLog"):
        if not os.path.exists(os.path.join(out, f)) or os.path.getsize(os.path.join(out, f)) == 0:
            fail(f"cli.edit: {f} missing or empty")
    if not np.isfinite(engine.edited_latent).all():
        fail("cli.edit: edited latent not finite")
    size_mb = sum(os.path.getsize(os.path.join(out, f)) for f in ("original.obj", "edit00.obj")) / 1e6
    if keep:  # phase 8's cli.eval compares the two meshes around the EditLog's handle
        os.replace(out, KEPT_EDIT)
    else:
        shutil.rmtree(out)
    say(f"  cli.edit: seed -> edited mesh {wall:.1f} s (200 generation steps, 10 guided steps, "
        f"two 256^3 meshes, {size_mb:.0f} MB of OBJ), drag walls "
        f"{fmt_walls(engine.last_phase_walls)}, edited mesh walls {fmt_walls(engine.last_mesh_walls)}")
    return wall


def march_compare(engine, x0) -> dict:
    """Device marching against host marching on the same 256^3 grid (decoded
    once, through fp16): equal triangle and vertex counts; triangle
    signatures (centroid, area; [-1,1] units) matched both ways within 2e-4
    in three slabs; the matched triangles wound alike, but for at most 1e-4
    of them (fp32 against fp64 near a zero of the orientation test), where
    both paths orient by the same rule: centroid rounding to an index off
    the grid's border and lying on no half-voxel tie. (The host's native
    C++, bit-equal to the JAX package's, takes un-normalized differences,
    which weigh a border axis half as much, and rounds ties away from zero;
    the device path, like JAX's, takes ``np.gradient``'s stencil and rounds
    ties to even: tests/test_torch_marching.py.) Signed volumes are printed,
    not held: on random weights the surface's many components nearly cancel
    (a few thousandths of the cube), so a relative bound on it says little."""
    from scipy.spatial import cKDTree

    from ishapediting_tpu_torch.geometry.marching import grid_to_mesh
    from ishapediting_tpu_torch.ops.marching import device_grid_to_mesh

    res = engine.config.edit.shape_resolution
    with torch.no_grad():
        grid = engine._decode_grid(torch.as_tensor(x0), res).float()
    sync()
    device_grid_to_mesh(grid)  # first call: allocator and kernel warm-up
    times = []
    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        dev, stats = device_grid_to_mesh(grid)
        times.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    host_grid = grid.cpu().numpy()
    fetch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = grid_to_mesh(host_grid, iso=0.0, to_unit=True)
    host_s = time.perf_counter() - t0

    def geometry(m):
        """Centroids, areas and normals of ``m``'s triangles, and its signed
        volume off the border and ties and whole, reckoned on the card in
        float64 (12M triangles: NumPy takes tens of seconds on the host)."""
        v = torch.as_tensor(m.vertices, dtype=torch.float64, device="cuda")
        p = v[torch.as_tensor(m.triangles, device="cuda")]  # [F, 3, 3]
        n = torch.linalg.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        cen = p.mean(dim=1)
        vox_c = (cen + 1.0) * res / 2.0  # voxel units
        vox = torch.round(vox_c)
        tie = ((vox_c - torch.floor(vox_c) - 0.5).abs() < 1e-4).any(dim=1)  # fp32 centroid ties too
        inner = ((vox > 0) & (vox < res - 1)).all(dim=1) & ~tie
        triple = (p[:, 0] * torch.linalg.cross(p[:, 1], p[:, 2])).sum(dim=1)
        same_rule = inner & (n.norm(dim=1) > 1e-12)
        out = (torch.cat([cen, 0.5 * n.norm(dim=1, keepdim=True)], dim=1).cpu().numpy(), n.cpu().numpy(),
               same_rule.cpu().numpy(), float(triple[inner].sum()) / 6.0, float(triple.sum()) / 6.0,
               int((~inner).sum()))
        del v, p, n, cen, vox_c, vox, tie, inner, triple, same_rule
        torch.cuda.empty_cache()
        return out

    sd, nd, same_rule, vd, fd, bd = geometry(dev)
    sh, nh, _, vh, fh, bh = geometry(host)
    worst, checked, compared, flips = 0.0, 0, 0, 0
    for x0s in (-0.5, 0.0, 0.5):
        for a, b, dev_side in ((sd, sh, True), (sh, sd, False)):
            inner = (a[:, 0] > x0s + 1e-3) & (a[:, 0] < x0s + 0.02 - 1e-3)
            outer = np.nonzero((b[:, 0] >= x0s) & (b[:, 0] <= x0s + 0.02))[0]
            if not inner.any():
                continue
            dist, idx = cKDTree(b[outer]).query(a[inner])
            worst = max(worst, float(dist.max()))
            checked += int(inner.sum())
            if dev_side:  # winding of the matched pairs the two rules decide alike
                rule = same_rule[inner]
                dots = (nd[inner] * nh[outer[idx]]).sum(axis=1)
                compared += int(rule.sum())
                flips += int((rule & (dots < 0)).sum())
    dev_s = min(times)
    say(f"  256^3 march: device {dev_s:.3f} s ({stats['march_cells']} active cells, "
        f"{stats['march_tris']} triangles, {len(dev.vertices)} vertices; runs {times}), host "
        f"{host_s:.3f} s (+ {fetch_s:.3f} s grid fetch; {len(host.triangles)} triangles, "
        f"{len(host.vertices)} vertices); signatures: {checked} triangles matched, largest "
        f"distance {worst:.2e} (tol 2e-4); winding: {flips} of {compared} matched triangles off "
        f"the border and ties differ (tol 1e-4 of them); signed volume off the border and ties "
        f"device {vd:.6f} host {vh:.6f}, whole mesh {fd:.6f} / {fh:.6f} ({bd} triangles on the "
        f"border or a tie)")
    if not (len(dev.triangles) == len(host.triangles) > 0 and len(dev.vertices) == len(host.vertices)
            and checked > 0 and worst < 2e-4 and compared > 0 and flips <= 1e-4 * compared):
        fail("device marching disagrees with host marching on the 256^3 grid")
    return dict(device_march_s=dev_s, host_march_s=host_s, grid_fetch_s=fetch_s,
                march_cells=stats["march_cells"], march_tris=stats["march_tris"],
                n_verts=len(dev.vertices), signature_err=worst, winding_flips=flips,
                winding_compared=compared)


def unet_forward_ms(engine, batch):
    """Steady-state device time of one chairs UNet forward at ``batch``."""
    from ishapediting_tpu_torch.utils.device import cuda_ms

    shape = (batch,) + engine.config.latent_shape
    x = torch.randn(shape, device=engine.device)
    t = torch.full((batch,), 500, device=engine.device, dtype=torch.long)
    with torch.no_grad():
        return cuda_ms(lambda: engine.unet(x, t), 5)


def forward_accounting(engine, label="chairs") -> dict:
    """Each kernel's device ms, launches and summed bound per forward of the
    engine's UNet at batch 1 and 2, with the shapes recorded during the
    forward."""
    from ishapediting_tpu_torch.tools.profile_unet import kernel_accounting

    out = {}
    for batch in (1, 2):
        shape = (batch,) + engine.config.latent_shape
        x = torch.randn(shape, device=engine.device)
        t = torch.full((batch,), 500, device=engine.device, dtype=torch.long)

        def fwd():
            with torch.no_grad():
                engine.unet(x, t)

        acc = kernel_accounting(fwd)
        out[f"batch{batch}"] = acc["kernels"]
        for name, k in acc["kernels"].items():
            say(f"  per {label} forward, batch {batch}: {name} {k['ms']:.4f} ms, "
                f"{k['launches']} launches, summed bound {k['bound_ms']:.4f} ms")
    return out


def ddim_steady_s(engine) -> float:
    """Host seconds of a second DDIM-10 sampling of 2 samples at batch 2."""
    from ishapediting_tpu_torch.core.schedule import make_schedule
    from ishapediting_tpu_torch.parallel.sampling import sample_batches

    sched = make_schedule(1000, "linear", "ddim10").to(engine.device)
    kw = dict(num_samples=2, batch_size=2, latent_shape=engine.config.latent_shape,
              device=engine.device, sampler="ddim")
    sample_batches(sched, engine.model_fn(), **kw)
    sync()
    t0 = time.perf_counter()
    sample_batches(sched, engine.model_fn(), **kw)
    sync()
    return time.perf_counter() - t0


# ---------------------------------------------------------------------------
# phase 5: the serving surfaces on the chairs engine
# ---------------------------------------------------------------------------


def rel_l2(a, b) -> float:
    a, b = torch.as_tensor(a).float().cpu(), torch.as_tensor(b).float().cpu()
    return float((a - b).norm() / b.norm())


HANDLE = (np.array([[0.5, 0.0, 0.0]], np.float32), np.array([[0.6, 0.0, 0.0]], np.float32))  # source, target


BATCH_W_TIME = 5  # phase 5's batched edit window: the engine's 20-step chain guides 10 steps; cut for time


def serving_runs(hk, counter, per_fwd, totals, engine, first_mesh, card) -> dict:
    """The serving surfaces at chairs width: the direct fit, morphing
    (engine and ``cli.morph``), ``cli.batch_edit`` and the batched drag
    (without and with remat, held to single-shape drags), the batched fit,
    and a scripted ``cli.serve`` session over a pipe."""
    from ishapediting_tpu_torch.cli.batch_edit import main as batch_main
    from ishapediting_tpu_torch.cli.morph import main as morph_main
    from ishapediting_tpu_torch.edit.batch import drag_edit_batched, fit_real_shapes_batched

    cfg = engine.config
    steps = engine.sched.num_timesteps
    w_time = BATCH_W_TIME
    out = {}

    # -- the direct fit (decoder only: no UNet forward, the decoder's epilogues alone)
    fit_dir = os.path.join(WORK, "fit_direct")
    shutil.rmtree(fit_dir, ignore_errors=True)
    say(f"  DragEngine.fit_real_shape_direct of the first generated mesh ({len(first_mesh.triangles)} "
        f"triangles), published FitConfig: {cfg.fit.opt_epochs} epochs x "
        f"{cfg.fit.points_size // cfg.fit.batch_points} batches of {cfg.fit.batch_points} points")
    sync()
    reset(hk)
    counter.n = 0
    t0 = time.perf_counter()
    engine.fit_real_shape_direct(mesh=first_mesh, path=fit_dir, seed=0)
    wall = time.perf_counter() - t0
    if counter.n:
        fail(f"direct fit: the decoder-only fit ran {counter.n} UNet forwards")
    check_launches(hk, "direct fit (the decoder's epilogues alone)", zero_counts(hk))
    losses, walls = engine.last_fit_losses, engine.last_phase_walls
    tri = np.load(os.path.join(fit_dir, "tri_feat_opt.npy"))
    # random decoder weights may put the fitted field on one side of the
    # iso level: the mesh may be empty, the file must be there
    if not (np.isfinite(losses).all() and losses[-1] < losses[0] and np.isfinite(tri).all()
            and tri.shape == (1, cfg.latent_shape[2]) + cfg.latent_shape[:2]
            and os.path.exists(os.path.join(fit_dir, "mesh_opt.obj"))):
        fail(f"direct fit: loss {losses[0]} -> {losses[-1]} did not fall, or outputs not as expected")
    shutil.rmtree(fit_dir)
    out["fit_direct"] = dict(walls, loss_first=float(losses[0]), loss_last=float(losses[-1]),
                             s_per_step=walls["opt_s"] / walls["opt_steps"])
    say(f"  ({card}) direct fit: {walls['opt_s'] / walls['opt_steps']:.4f} s/step over "
        f"{walls['opt_steps']} Adam steps, loss {losses[0]:.4f} -> {losses[-1]:.4f}, total {wall:.1f} s "
        f"(points {walls['points_s']:.2f} s, mesh {walls['mesh_s']:.2f} s, "
        f"{engine.last_mesh_walls['n_verts']} vertices)")

    # -- morph on the engine, then cli.morph --------------------------------
    morph_fwd = 2 * steps + (steps - 1) + steps  # two samples, encode, decode

    def morph():
        a, b = engine.sample_latent(seed=1), engine.sample_latent(seed=2)
        return engine.morph(a, b, n=3)

    say("  DragEngine.morph of two sample_latent()s, 3 frames (encode batch 2, decode batch 3)")
    frames, wall, peak = counted(hk, counter, per_fwd, totals, "morph", morph, morph_fwd)
    walls = engine.last_phase_walls
    if frames.shape != (3,) + cfg.latent_shape or not np.isfinite(frames).all():
        fail("morph: frames not finite or of the wrong shape")
    out["morph"] = dict(walls, wall_s=wall, peak_gib=peak)
    say(f"  ({card}) morph: encode {walls['encode_s']:.3f} s ({steps - 1} steps, batch 2), decode "
        f"{walls['decode_s'] / 3:.3f} s per frame ({walls['decode_s']:.3f} s for 3 frames, {steps} steps), "
        f"wall {wall:.1f} s with both samples, peak {peak:.2f} GiB")
    mout = os.path.join(WORK, "cli_morph")
    shutil.rmtree(mout, ignore_errors=True)
    argv = ["--random_init", "--preset", "chairs", "--num_steps", str(steps), "--seed_a", "1", "--seed_b",
            "2", "--frames", "2", "--smooth", "0", "--out", mout, "--device", "cuda"]
    say(f"  python -m ishapediting_tpu_torch.cli.morph {' '.join(argv)}")
    buf = io.StringIO()

    def run_morph():
        with contextlib.redirect_stdout(buf):
            return morph_main(argv)

    (_, lat), wall, _ = counted(hk, counter, per_fwd, totals, "cli.morph", run_morph, morph_fwd)
    if lat.shape != (2,) + cfg.latent_shape or not all(
            os.path.getsize(os.path.join(mout, f"frame_{k:02d}.obj")) > 0 for k in range(2)):
        fail("cli.morph: latents or frame OBJs not as expected")
    shutil.rmtree(mout)
    out["cli_morph_wall_s"] = wall
    say(f"  cli.morph: {wall:.1f} s (two samples, encode, decode, two 256^3 frame meshes)")

    # -- cli.batch_edit, then the batched drag on its records ---------------
    bout = os.path.join(WORK, "batch_edit")
    shutil.rmtree(bout, ignore_errors=True)
    argv = ["--random_init", "--preset", "chairs", "--num_steps", str(steps), "--w_time", str(w_time),
            "--latent_seed", "0", "--latent_seed", "1", "--source", *map(str, HANDLE[0][0]),
            "--target", *map(str, HANDLE[1][0]), "--out", bout, "--device", "cuda"]
    say(f"  python -m ishapediting_tpu_torch.cli.batch_edit {' '.join(argv)}")
    buf = io.StringIO()

    def run_batch():
        with contextlib.redirect_stdout(buf):
            return batch_main(argv)

    chunk = 2  # invert_batched's default: 2 steps per forward
    drag_back = backward_nodes(cfg.unet, cfg.edit.feat_layer)
    res, wall, peak = counted(hk, counter, per_fwd, totals, "cli.batch_edit", run_batch,
                              steps + -(-w_time // chunk) + w_time, steps=w_time, back=drag_back)
    for i in (1, 2):
        for f in (f"original{i:02d}.obj", f"edit{i:02d}.obj"):
            if os.path.getsize(os.path.join(bout, f)) == 0:
                fail(f"cli.batch_edit: {f} empty")
    if not bool(res["edited"].isfinite().all()) or res["noise_mode"] != "replay":
        fail("cli.batch_edit: edited latents not finite")
    shutil.rmtree(bout)
    bw = res["walls"]
    out["cli_batch_edit"] = dict(bw, wall_s=wall, peak_gib=peak)
    say(f"  ({card}) cli.batch_edit, N=2: sampling {bw['latents_s']:.3f} s, inversion "
        f"{bw['inversion_s']:.3f} s, replay drag {bw['drag_s'] / w_time:.4f} s/step (first batched "
        f"drag of the process: cuDNN times the batch-2 backward), four 256^3 meshes {bw['mesh_s']:.1f} s, "
        f"wall {wall:.1f} s, peak {peak:.2f} GiB")

    beng, inv, problems = res["engine"], res["inversion"], res["problems"]
    gen = torch.Generator(device="cuda").manual_seed(7)
    noises = torch.randn((w_time, 2, 1) + cfg.latent_shape, generator=gen, device="cuda")
    scale, cof = cfg.edit.grad_scale, cfg.edit.mask_weight
    again = calls_recomputed(cfg.unet, cfg.edit.feat_layer)
    say(f"  remat: each drag step's backward recomputes {again[0]} GroupNorm-SiLU and {again[1]} "
        f"attention calls and {again[2]} FiLM epilogues (input and middle blocks, output blocks "
        f"0..{cfg.edit.feat_layer})")
    batched = {}
    for label, remat in (("plain", False), ("remat first", True), ("remat", True)):
        fn = lambda remat=remat: drag_edit_batched(  # noqa: E731
            beng.sched, beng.model_fn(feat=True, remat=remat), inv["w"], inv["features"], problems,
            w_time=w_time, scale=scale, cof=cof, noises=noises)
        kw = dict(again=again if remat else (0, 0, 0), steps=w_time, back=drag_back)
        edited, wall, peak = counted(hk, counter, per_fwd, totals, f"batched drag ({label})", fn, w_time,
                                     **kw)
        batched[label] = edited
        out[f"batched_drag_{label.replace(' ', '_')}"] = dict(s_per_step=wall / w_time, wall_s=wall,
                                                               peak_gib=peak)
        say(f"  ({card}) batched drag N=2 ({label}): {wall / w_time:.4f} s/step over {w_time} steps, "
            f"peak {peak:.2f} GiB")
    tol = 2e-2  # bf16 torso: batch 1 and batch 2 take other cuDNN algorithms
    err_remat = rel_l2(batched["remat"], batched["plain"])
    err_again = rel_l2(batched["remat first"], batched["remat"])
    singles = []
    for i in range(2):
        beng.w, beng.w0 = inv["w"][i], inv["w"][i]
        beng.feature_guidance = inv["features"][i]
        counted(hk, counter, per_fwd, totals, f"single-shape drag {i}", lambda i=i: beng.drag_edit(
            HANDLE[0], HANDLE[1], scale=scale, cof=cof, noises=[noises[j, i] for j in range(w_time)]),
            w_time, steps=w_time, back=drag_back)
        singles.append(rel_l2(batched["plain"][i], beng.edited_latent))
    say(f"  batched drag against two single-shape drag_edit runs, same noises: relative L2 "
        f"{singles[0]:.2e}, {singles[1]:.2e}; remat against plain {err_remat:.2e}, remat twice "
        f"{err_again:.2e} (tol {tol:g})")
    if not (max(singles) <= tol and err_remat <= tol and err_again <= tol):
        fail("the batched drag disagrees with single-shape drags or with itself under remat")
    out["batched_vs_single_rel_l2"] = singles
    out["remat_vs_plain_rel_l2"] = err_remat

    sched_fit = beng._fit_schedule(3)
    meshes = [first_mesh, engine.mesh0]
    say(f"  fit_real_shapes_batched of two 256^3 meshes ({len(meshes[0].triangles)}, "
        f"{len(meshes[1].triangles)} triangles), 3 guided steps at batch 2")
    lat, wall, peak = counted(hk, counter, per_fwd, totals, "batched fit", lambda: fit_real_shapes_batched(
        sched_fit, beng.model_fn(), beng.decoder, meshes, beng.half_range, beng.middle,
        beng._generator(0), latent_shape=cfg.latent_shape, fit_cfg=cfg.fit), 3, steps=3,
        back=backward_nodes(cfg.unet))
    if lat.shape != (2,) + cfg.latent_shape or not bool(lat.isfinite().all()):
        fail("batched fit: latents not finite or of the wrong shape")
    out["batched_fit"] = dict(wall_s=wall, peak_gib=peak)
    say(f"  ({card}) batched fit N=2: {wall:.1f} s with host point sampling, peak {peak:.2f} GiB")
    del res, beng, inv, batched

    out["serve"] = serve_session(hk, counter, per_fwd, totals, cfg, card)
    return out


def serve_session(hk, counter, per_fwd, totals, cfg, card) -> dict:
    """``cli.serve``'s ``serve_loop`` in a thread, fed through a pipe one
    request at a time; the ``stop`` line is written after the drag's first
    progress event. Every response must be ok."""
    import queue

    from ishapediting_tpu_torch.cli.serve import EditServer, serve_loop

    steps = engine_steps(cfg)
    sdir = os.path.join(WORK, "serve")
    shutil.rmtree(sdir, ignore_errors=True)
    r_fd, w_fd = os.pipe()
    instream, writer = os.fdopen(r_fd, "r"), os.fdopen(w_fd, "w")
    msgs: "queue.Queue" = queue.Queue()

    class Out:
        def write(self, text):
            for line in text.splitlines():
                if line.strip():
                    msgs.put(json.loads(line))

        def flush(self):
            pass

    errors = []
    server = EditServer(device="cuda")
    th = threading.Thread(target=lambda: _capture(lambda: serve_loop(instream, Out(), server), errors),
                          daemon=True)
    reqs = [
        {"cmd": "init_random", "preset": "chairs", "num_steps": steps, "w_time": cfg.edit.w_time,
         "feat_layer": cfg.edit.feat_layer, "seed": 0},
        {"cmd": "sample", "seed": 0},
        {"cmd": "drag", "sources": HANDLE[0].tolist(), "targets": HANDLE[1].tolist(), "chunk": 2},
        {"cmd": "save_mesh", "path": os.path.join(sdir, "edit.obj")},
        {"cmd": "metrics", "points": 20000},
        {"cmd": "render", "path": os.path.join(sdir, "shot.png"), "size": 256},
        {"cmd": "edit_log", "path": os.path.join(sdir, "EditLog")},
        {"cmd": "generate", "num_samples": 2, "batch_size": 2, "sampler": "ddim", "num_steps": 10,
         "decode": True, "smooth": 0},
        {"cmd": "morph", "seed_a": 1, "seed_b": 2, "frames": 2},
        {"cmd": "status"},
        {"cmd": "quit"},
    ]
    forwards = steps + cfg.edit.w_time + 10 + (2 * steps + (steps - 1) + steps)
    say(f"  cli.serve session over a pipe: {', '.join(r['cmd'] for r in reqs)} (a stop line written "
        f"while the drag runs)")

    def session():
        walls, responses = {}, []
        th.start()
        for req in reqs:
            t0 = time.perf_counter()
            writer.write(json.dumps(req) + "\n")
            writer.flush()
            stop_sent = False
            while True:
                try:
                    msg = msgs.get(timeout=600)
                except queue.Empty:
                    fail(f"serve: no answer to {req['cmd']} ({errors})")
                if "event" in msg:
                    if req["cmd"] == "drag" and msg["event"] == "progress" and not stop_sent:
                        writer.write(json.dumps({"cmd": "stop"}) + "\n")
                        writer.flush()
                        stop_sent = True
                    continue
                responses.append(msg)
                if msg.get("cmd") == req["cmd"]:
                    break
            walls[req["cmd"]] = time.perf_counter() - t0
        th.join(timeout=60)
        writer.close()
        instream.close()
        bad = [r for r in responses if not r.get("ok")]
        if errors or bad or th.is_alive():
            fail(f"serve: failed responses {bad} {errors}")
        return walls, responses

    # the stop lands after the drag's first chunk or a later one: the guided
    # steps (each one backward pass) are those the engine recorded
    guided = lambda: len(server.engine.last_drag_losses["motion"])  # noqa: E731
    (walls, responses), total, _ = counted(hk, counter, per_fwd, totals, "cli.serve session", session,
                                           forwards, steps=guided,
                                           back=backward_nodes(cfg.unet, cfg.edit.feat_layer))
    drag = next(r for r in responses if r.get("cmd") == "drag")
    if not drag["stopped_early"] or not any(r.get("cmd") == "stop" for r in responses):
        fail("serve: the stop line did not stop the drag")
    if os.path.getsize(os.path.join(sdir, "shot.png")) == 0:
        fail("serve: empty render")
    shutil.rmtree(sdir)
    say(f"  ({card}) cli.serve session, wall per request: "
        + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items()) + f"; total {total:.1f} s; drag stopped "
        f"early, motion loss {drag['motion_loss_first']:.4g} -> {drag['motion_loss_last']:.4g}")
    return dict(walls, total_s=total)


# ---------------------------------------------------------------------------
# phase 6: the heads-by-count UNet at chairs width
# ---------------------------------------------------------------------------


def launches_per_forward(hk, ucfg, cut_min=None) -> dict:
    """Each kernel's launches in one forward of a UNet of config ``ucfg``:
    two GroupNorm launches per GroupNorm-SiLU call, each attention call on
    the kernel ``attention_route`` picks for its head dim, and the bias
    epilogues (``epilogues``; ``cut_min`` for a cut UNet)."""
    from ishapediting_tpu_torch.models.unet import attention_head_dims, kernel_calls_per_forward

    gn, _ = kernel_calls_per_forward(ucfg)
    plain, fused = epilogues(ucfg, cut_min=cut_min)
    want = dict(zero_counts(hk), gn_stats=gn, gn_norm=gn, bias_add=plain, bias_residual=fused)
    for ch in attention_head_dims(ucfg):
        want[hk.attention_route(ucfg.torch_compute_dtype, ch)] += 1
    return want


def counted_routes(hk, counter, totals, phase, fn, forwards, per, extra=None):
    """Run ``fn`` with the launch counters and the forward counter set to 0
    just before and read just after: ``forwards`` UNet forwards, each
    launching ``per`` (a LAUNCHES-keyed dict), plus ``extra`` (the backward
    passes' launches, ``backward_launches``). Returns (fn's result, wall s)."""
    sync()
    reset(hk)
    counter.n = 0
    t0 = time.perf_counter()
    out = fn()
    sync()
    wall = time.perf_counter() - t0
    got = dict(hk.LAUNCHES)
    want = with_decoder({k: v * forwards + (extra or {}).get(k, 0) for k, v in per.items()})
    say(f"  launches in {phase}: {got} for {counter.n} UNet forwards and {DECODER.n} decoder calls (want {want})")
    if counter.n != forwards or got != want:
        fail(f"{phase}: {counter.n} forwards and launches {got}, expected {forwards} and {want}")
    for k, v in got.items():
        totals[k] = totals.get(k, 0) + v
    return out, wall


def heads_by_count_runs(hk, counter, totals) -> dict:
    """The UNet that splits heads by count (``num_head_channels=-1``, ADM's
    ``num_heads=4``) at the published chairs width, bf16 torso, random
    weights: heads of 128 channels at 32^2 (the wgmma kernel), 192 at 16^2
    and 256 at 8^2 (the generic kernel). Through the normal entry points:
    a ``DragEngine``, DDIM-10 at batch 2 by ``parallel/sampling.py`` as
    ``cli.generate`` drives it on that engine's UNet (twice: first run, then
    steady state), a 20-step ``update_latent_params`` (w_time 10, its mesh
    at 64^3: the 256^3 mesh tail is timed by phase 4), and a 2-step fast
    drag, whose steps reach the generic kernel's Function in the forward
    and recompute the plain composition in the backward. Launch counts
    exact per run; then each kernel's ms, launches and summed bound per
    forward at batch 1 and 2."""
    from ishapediting_tpu_torch.config import PipelineConfig, UNetConfig
    from ishapediting_tpu_torch.core.schedule import make_schedule
    from ishapediting_tpu_torch.edit.engine import DragEngine
    from ishapediting_tpu_torch.parallel.sampling import sample_batches

    base = PipelineConfig(unet=UNetConfig.from_reference_args(num_head_channels=-1))
    cfg = dataclasses.replace(base.with_steps(20), edit=dataclasses.replace(
        base.edit, w_time=10, feat_layer=8, shape_resolution=64))
    per = launches_per_forward(hk, cfg.unet)
    expected = dict(zero_counts(hk), gn_stats=71, gn_norm=71, attention=5, attention_generic=11, bias_add=90,
                    bias_residual=51)
    say(f"  heads-by-count UNet (num_heads 4, num_head_channels -1): per forward {per}")
    if per != expected:
        fail(f"heads-by-count launches per forward {per} are not {expected}")
    engine = DragEngine(config=cfg, seed=0, device="cuda")
    sched = make_schedule(1000, "linear", "ddim10").to(engine.device)
    kw = dict(num_samples=2, batch_size=2, latent_shape=cfg.latent_shape, device=engine.device,
              sampler="ddim")
    out = {}
    for run in ("first", "steady"):
        samples, wall = counted_routes(hk, counter, totals, f"heads-by-count DDIM-10 ({run})",
                                       lambda: sample_batches(sched, engine.model_fn(), **kw), 10, per)
        if samples.shape != (2,) + cfg.latent_shape or not np.isfinite(samples).all():
            fail(f"heads-by-count DDIM-10: samples {samples.shape} not finite or of the wrong shape")
        out[f"ddim10_{run}_samples_per_s"] = 2 / wall
        say(f"  heads-by-count DDIM-10 at batch 2 ({run} run): {wall:.3f} s, {2 / wall:.3f} samples/s")
    lat, wall = counted_routes(hk, counter, totals, "heads-by-count update_latent_params",
                               lambda: engine.update_latent_params(seed=0), 20, per)
    check_mesh("heads-by-count update_latent_params", engine.mesh0, engine.last_mesh_walls)
    if not np.isfinite(lat).all() or engine.feature_guidance.shape[0] != 10:
        fail("heads-by-count update_latent_params: latent or guidance cache not as expected")
    out["update_latent_params_s"] = wall
    mesh, wall = counted_routes(hk, counter, totals, "heads-by-count drag (2 guided steps)",
                                lambda: engine.drag_edit(*HANDLE, seed=0, chunk=1, edit_steps=2), 2,
                                dict(per, bias_add=film_epilogues(cfg.unet), bias_residual=0),  # under autograd
                                backward_launches(hk, cfg.unet, cfg.edit.feat_layer, steps=2))
    losses = engine.last_drag_losses
    if not (np.isfinite(engine.edited_latent).all() and np.isfinite(losses["motion"]).all()
            and len(losses["motion"]) == 2):
        fail("heads-by-count drag: edited latent or losses not finite")
    out["drag_2_steps_s"] = wall
    say(f"  heads-by-count: update_latent_params {out['update_latent_params_s']:.2f} s (20 steps, "
        f"64^3 mesh), drag {wall:.2f} s for 2 guided steps (motion loss {losses['motion'][0]:.4g} "
        f"-> {losses['motion'][-1]:.4g}, edited latent finite)")
    out["per_forward"] = forward_accounting(engine, "heads-by-count")
    return out


# ---------------------------------------------------------------------------
# phase 7: training
# ---------------------------------------------------------------------------


def train_step_launches(hk, ucfg, remat: bool = True) -> dict:
    """Each kernel's launches in one train step of a UNet of config
    ``ucfg``: the forward's and, under remat, every block's again (the loss
    reaches the output, and the output head is not checkpointed); the
    backward kernels once for every GroupNorm-SiLU and attention call of the
    forward. No bias epilogue: the forward wants the gradient."""
    from ishapediting_tpu_torch.models.unet import attention_head_dims, kernel_calls_recomputed

    want = dict(launches_per_forward(hk, ucfg), bias_add=0, bias_residual=0)
    for k, v in backward_launches(hk, ucfg).items():
        want[k] += v
    if remat:
        gn, _ = kernel_calls_recomputed(ucfg, -1, head=True)
        want["gn_stats"] += gn
        want["gn_norm"] += gn
        for ch in attention_head_dims(ucfg):
            want[hk.attention_route(ucfg.torch_compute_dtype, ch)] += 1
    return want


def check_launches(hk, phase, want, totals=None) -> None:
    """The launch counters against ``want``; the run's launches are added to
    ``totals`` unless it is None (a comparison with the plain versions).
    The decoder's calls add their plain epilogues (``with_decoder``)."""
    got, want = dict(hk.LAUNCHES), with_decoder(want)
    say(f"  launches in {phase}: {got} with {DECODER.n} decoder calls (want {want})")
    if got != want:
        fail(f"{phase}: launch counts {got} are not {want}")
    if totals is not None:
        for k, v in got.items():
            totals[k] = totals.get(k, 0) + v


def grad_rel_errs(model, ref) -> dict:
    """Each parameter's relative L2 error of ``model``'s gradient against
    ``ref``'s, relative to the larger of the reference tensor's norm and 1e-4
    of the global gradient norm (a conv bias feeding a GroupNorm of one
    channel per group has gradient zero up to rounding)."""
    want = {k: p.grad.detach().double().cpu() for k, p in ref.named_parameters()}
    got = {k: p.grad.detach().double().cpu() for k, p in model.named_parameters()}
    floor = 1e-4 * float(torch.sqrt(sum(v.square().sum() for v in want.values())))
    return {k: float((got[k] - want[k]).norm()) / max(float(want[k].norm()), floor) for k in want}


def train_card_check(hk, cfg, tol, what, device="cuda") -> dict:
    """One train step on the card (kernels) against the same step on the
    CPU (plain versions): the same weights, t, noise and dropout masks, remat
    on, no gradient clipping; launches exact; the loss terms within ``tol``
    (relative). Gradients: both steps are held to a third step on the CPU at
    the next precision (a bf16 torso against fp32, fp32 against float64),
    each parameter's gradient on the card within the larger of ``tol`` and
    twice the CPU step's own error (relative L2). On the CPU a bf16 torso
    puts single tensors' gradients 2-4% from fp32, and fp32 puts the
    gradients that are zero by symmetry (a conv bias ahead of a GroupNorm
    of one channel per group) about 1e-4 of the floor from float64."""
    import copy

    from ishapediting_tpu_torch.core.schedule import make_schedule
    from ishapediting_tpu_torch.models.unet import UNetModel, draw_dropout_masks
    from ishapediting_tpu_torch.train.trainer import init_train_state, make_optimizer, make_train_step

    sched = make_schedule(1000, "linear", "")
    gen = torch.Generator().manual_seed(6)
    cpu_model = signal_model(cfg, gen)
    card_model = copy.deepcopy(cpu_model).to(device)
    s = cfg.image_size
    batch = torch.randn((2, s, s, cfg.in_channels), generator=gen).clamp(-1, 1)
    noise = torch.randn(batch.shape, generator=gen)
    masks = draw_dropout_masks(cfg, 2, gen)
    t = torch.tensor([3, 700])
    ref_cfg = dataclasses.replace(cfg, compute_dtype="float32" if cfg.compute_dtype == "bfloat16"
                                  else "float64")
    ref_model = UNetModel(ref_cfg)
    ref_model.load_state_dict(cpu_model.state_dict())
    ref_model.to(getattr(torch, ref_cfg.compute_dtype))
    metrics = {}
    for name, model, mcfg in (("cpu", cpu_model, cfg), (device, card_model, cfg), ("ref", ref_model, ref_cfg)):
        dev, dt = ("cpu", mcfg.torch_compute_dtype) if name == "ref" else (name, torch.float32)
        state = init_train_state(model, make_optimizer(model.parameters(), grad_clip=0.0))
        sync()
        reset(hk)
        metrics[name] = make_train_step(mcfg, sched)(
            state, batch.to(dev, dt), t=t.to(dev), noise=noise.to(dev, dt),
            dropout_masks=[None if m is None else m.to(dev) for m in masks])
        sync()
        if name == device:
            check_launches(hk, f"train step ({what})", train_step_launches(hk, cfg))
    loss_err = max(abs(metrics[device][k] - metrics["cpu"][k]) / abs(metrics["cpu"][k])
                   for k in ("loss", "mse", "vb"))
    vs_cpu = grad_rel_errs(card_model, cpu_model)
    card_err, cpu_err = grad_rel_errs(card_model, ref_model), grad_rel_errs(cpu_model, ref_model)
    worst = max(card_err, key=lambda k: card_err[k] / max(tol, 2 * cpu_err[k]))
    ok = loss_err <= tol and card_err[worst] <= max(tol, 2 * cpu_err[worst])
    out = dict(loss_rel_err=loss_err, grad_vs_cpu=max(vs_cpu.values()), grad_vs_ref=max(card_err.values()),
               cpu_grad_vs_ref=max(cpu_err.values()), tol=tol, reference=ref_cfg.compute_dtype)
    say(f"  train step, card against CPU ({what}, dropout {cfg.dropout}): loss "
        f"{metrics[device]['loss']:.6g} / {metrics['cpu']['loss']:.6g}, loss terms relative error "
        f"{loss_err:.2e}; gradients, worst relative L2: card against CPU {out['grad_vs_cpu']:.2e}, "
        f"against the {ref_cfg.compute_dtype} step card {out['grad_vs_ref']:.2e} and CPU "
        f"{out['cpu_grad_vs_ref']:.2e}; closest to its bound: {worst} {card_err[worst]:.2e} (bound "
        f"{max(tol, 2 * cpu_err[worst]):.2e}) (tol {tol:g}) {'ok' if ok else 'FAIL'}")
    if not ok:
        fail(f"train step ({what}) on the card disagrees with the CPU")
    return out


def remat_check(hk, cfg, device="cuda") -> dict:
    """On the card, a train step with generator-drawn dropout masks under
    remat against the same step without: the same seed gives the same masks
    in the recompute, so the gradients agree to 1e-5 (relative L2 over all
    parameters; summation order differs between the two backward passes).
    A third step under remat with another seed must differ by more than
    1e-3: a recompute that drew other masks would show."""
    import copy

    from ishapediting_tpu_torch.core.schedule import make_schedule
    from ishapediting_tpu_torch.train.trainer import init_train_state, make_optimizer, make_train_step

    sched = make_schedule(1000, "linear", "")
    gen = torch.Generator().manual_seed(7)
    base = signal_model(cfg, gen)
    batch = torch.randn((2, cfg.image_size, cfg.image_size, cfg.in_channels), generator=gen).clamp(-1, 1)
    grads = {}
    for remat, seed in ((False, 11), (True, 11), (True, 12)):
        model = copy.deepcopy(base).to(device)
        state = init_train_state(model, make_optimizer(model.parameters(), grad_clip=0.0))
        sync()
        reset(hk)
        make_train_step(cfg, sched, remat=remat)(state, batch.to(device),
                                                 torch.Generator(device=device).manual_seed(seed))
        sync()
        check_launches(hk, f"train step, remat {'on' if remat else 'off'}, seed {seed}",
                       train_step_launches(hk, cfg, remat))
        grads[remat, seed] = torch.cat([p.grad.detach().double().flatten().cpu() for p in model.parameters()])

    def rel(a, b):
        return float((grads[a] - grads[b]).norm() / grads[b].norm())

    err, other = rel((True, 11), (False, 11)), rel((True, 12), (False, 11))
    say(f"  remat against no remat on the card (fp32, dropout {cfg.dropout}, masks from one "
        f"generator seed): gradients' relative L2 {err:.2e} (tol 1e-5); with another seed "
        f"{other:.2e} (need > 1e-3)")
    if not (err <= 1e-5 and other > 1e-3):
        fail("train step: remat changes the gradients (dropout masks not replayed?)")
    return dict(grad_rel_err=err, other_seed_rel=other)


def sphere_decoder(hk, device="cuda") -> tuple:
    """``train_decoder`` at the published decoder widths (planes 128^2 x 32
    channels, Fourier mapping 64, hidden 128) on a sphere's occupancy, 150
    steps of 2048 points: held-out accuracy > 0.9 as in the JAX package's
    test, and more than half the inside points found. Launches nothing."""
    from ishapediting_tpu_torch.io.dataset import MultiOccupancyDataset, OccupancyDataset
    from ishapediting_tpu_torch.ops.triplane import decode_points
    from ishapediting_tpu_torch.train.decoder import train_decoder

    rng = np.random.default_rng(0)
    pts = rng.uniform(-1, 1, (20000, 3)).astype(np.float32)
    occ = (np.linalg.norm(pts, axis=1) < 0.5).astype(np.float32)
    batches = MultiOccupancyDataset([OccupancyDataset(pts, occ)]).batches(2048, seed=0)
    steps = 150
    sync()
    reset(hk)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        dec, bank = train_decoder(batches, num_objs=1, steps=steps, resolution=128, channels=32,
                                  mapping=64, hidden=128, lr=3e-3, log_every=1000, device=device)
    sync()
    wall = time.perf_counter() - t0
    check_launches(hk, "decoder training", zero_counts(hk))
    test = rng.uniform(-1, 1, (4000, 3)).astype(np.float32)
    with torch.no_grad():
        pred = (decode_points(dec, bank[0], torch.from_numpy(test).to(device))[:, 0] > 0).cpu().numpy()
    truth = np.linalg.norm(test, axis=1) < 0.5
    acc, inside = float((pred == truth).mean()), float(pred[truth].mean())
    say(f"  train_decoder (planes 128^2 x 32, mapping 64, hidden 128), {steps} steps of 2048 points: "
        f"{wall / steps * 1e3:.2f} ms/step ({wall:.2f} s, first step included), held-out accuracy "
        f"{acc:.4f} (need > 0.9), inside points found {inside:.4f} (need > 0.5)")
    if not (acc > 0.9 and inside > 0.5):
        fail("decoder training did not learn the sphere")
    path = os.path.join(WORK, "sphere_decoder.pt")
    torch.save(dec.state_dict(), path)
    return path, dict(s_per_step=wall / steps, accuracy=acc, inside_found=inside)


def parse_ckpt(log: str, what: str) -> tuple:
    """(bytes, seconds) of the loop's "checkpointed <path> (N bytes in S s)"
    line for ``what``, or (None, seconds) of its "resumed ... (loaded in S
    s)" line."""
    for line in log.splitlines():
        if what in line and "checkpointed" in line:
            n, _, _, sec, _ = line.rsplit("(", 1)[1].split()
            return int(n), float(sec)
        if what in line and "resumed from" in line:
            return None, float(line.rsplit("loaded in ", 1)[1].split()[0])
    fail(f"cli.train: no checkpoint line for {what} in its output")


def chairs_training(hk, counter, totals, decoder_pt, preset_name="chairs", device="cuda", keep=False) -> dict:
    """``cli.train`` at the published chairs width (421M parameters, bf16
    torso, dropout 0.1, the 1000-step chain, AdamW lr 1e-4, clip 1.0, EMA
    0.9999, remat), batch 8 of synthetic 128x128x96 latents: 4 steps with a
    checkpoint at step 4 (the JAX package's orbax train state, timed beside
    one ``torch.save`` of the same tensors), the checkpoint loaded and held
    to the state the run returned, a resume to step 6 from it with the
    export of a model dir (``unet.orbax``, ``decoder.orbax``), and that dir
    served by ``DragEngine.from_model_dir``: DDIM-10 at batch 2 from a fixed
    x_T equal to the in-memory EMA UNet's bit for bit, and a 20-step
    ``update_latent_params`` with a 64^3 mesh. Launches exact per step."""
    from ishapediting_tpu_torch.cli.train import main as train_main
    from ishapediting_tpu_torch.config import preset
    from ishapediting_tpu_torch.core.diffusion import ddim_sample_loop
    from ishapediting_tpu_torch.core.schedule import make_schedule
    from ishapediting_tpu_torch.edit.engine import DragEngine
    from ishapediting_tpu_torch.io.checkpoint import load_train_state, whole_state
    from ishapediting_tpu_torch.models.unet import UNetModel
    from ishapediting_tpu_torch.train.loop import latest_checkpoint
    from ishapediting_tpu_torch.train.trainer import init_train_state, make_optimizer

    chairs = preset(preset_name)
    per_step = train_step_launches(hk, chairs.unet)
    expected = dict(zero_counts(hk), gn_stats=141, gn_norm=141, attention=32, gn_bwd_reduce=71,
                    gn_bwd_apply=71, attn_bwd_dq=16, attn_bwd_dkdv=16)
    say(f"  {preset_name} train step at batch 8: per step {per_step}")
    if preset_name == "chairs" and per_step != expected:
        fail(f"chairs launches per train step {per_step} are not {expected}")
    ckpt, export = os.path.join(WORK, "train_ckpt"), os.path.join(WORK, "train_export")
    for d in (ckpt, export):
        shutil.rmtree(d, ignore_errors=True)
    argv = ["--preset", preset_name, "--synthetic", "16", "--batch_size", "8", "--ckpt_dir", ckpt,
            "--ckpt_every", "4", "--seed", "0", "--device", device]
    out = {}

    def run(extra, steps, label):
        say(f"  python -m ishapediting_tpu_torch.cli.train {' '.join(argv + extra)}")
        buf = io.StringIO()
        sync()
        reset(hk)
        counter.n, counter.starts = 0, []
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            state = train_main(argv + extra)
        sync()
        wall = time.perf_counter() - t0
        if counter.n != steps:
            fail(f"{label}: {counter.n} UNet forwards for {steps} steps")
        check_launches(hk, f"{label} ({steps} steps)", {k: v * steps for k, v in per_step.items()}, totals)
        gaps = np.diff(counter.starts).tolist()  # step i's start to step i+1's
        peak = torch.cuda.max_memory_allocated() / 2**30 if device == "cuda" else float("nan")
        return state, buf.getvalue(), wall, gaps, peak

    state, log, wall, gaps, peak = run(["--steps", "4"], 4, "cli.train")
    loss0 = float(next(l for l in log.splitlines() if l.startswith("| loss")).split("|")[2])
    # a non-finite loss leaves the step count where it was: 4 steps applied = 4 finite losses
    if state.step != 4 or not np.isfinite(loss0) or latest_checkpoint(ckpt) != os.path.join(ckpt, "step_4"):
        fail(f"cli.train: step {state.step}, loss {loss0}, checkpoints {os.listdir(ckpt)}")
    nbytes, save_s = parse_ckpt(log, "step_4")
    if not os.path.exists(os.path.join(ckpt, "step_4", "manifest.ocdbt")):
        fail(f"cli.train: step_4 is not an orbax checkpoint: {sorted(os.listdir(os.path.join(ckpt, 'step_4')))}")
    out.update(first_step_s=gaps[0], steady_s=gaps[1:], run_wall_s=wall, peak_gib=peak,
               ckpt_bytes=nbytes, save_s=[save_s], loss_step0=loss0)
    say(f"  cli.train: 4 steps at batch 8, step 0 loss {loss0:.4f}; step s {[round(g, 3) for g in gaps]} "
        f"(first: cuDNN times the new shapes), peak device memory {peak:.2f} GiB; checkpoint step_4 "
        f"(orbax) {nbytes / 1e9:.3f} GB written in {save_s:.2f} s ({nbytes / save_s / 1e6:.0f} MB/s); "
        f"wall {wall:.1f} s")
    pt = os.path.join(WORK, "train_state_compare.pt")
    sync()
    t0 = time.perf_counter()
    torch.save(whole_state(state), pt)
    pt_s = time.perf_counter() - t0
    out.update(torch_save_bytes=os.path.getsize(pt), torch_save_s=pt_s)
    os.remove(pt)
    say(f"  for comparison only: torch.save of the same state {out['torch_save_bytes'] / 1e9:.3f} GB in "
        f"{pt_s:.2f} s ({out['torch_save_bytes'] / pt_s / 1e6:.0f} MB/s)")

    with torch.device(device):
        fresh = UNetModel(chairs.unet)
    restored = init_train_state(fresh, make_optimizer(fresh.parameters()))
    t0 = time.perf_counter()
    load_train_state(latest_checkpoint(ckpt), restored)
    sync()
    load_s = time.perf_counter() - t0
    saved_opt, got_opt = state.optimizer.state_dict()["state"], restored.optimizer.state_dict()["state"]
    same = (restored.step == state.step and len(saved_opt) == len(got_opt) > 0
            and all(torch.equal(a, b) for a, b in zip(state.model.parameters(), fresh.parameters()))
            and all(torch.equal(state.ema_params[k], v) for k, v in restored.ema_params.items())
            and all(saved_opt[i][k].device == got_opt[i][k].device and torch.equal(saved_opt[i][k], got_opt[i][k])
                    for i in saved_opt for k in saved_opt[i]))
    say(f"  load_train_state(step_4): {load_s:.2f} s ({nbytes / load_s / 1e6:.0f} MB/s, read, mapped to the "
        f"port's layout and placed on the card); params, EMA, Adam moments and step equal the saved state: {same}")
    if not same:
        fail("the loaded checkpoint differs from the state that was saved")
    out["load_s"] = [load_s]
    del state, restored, fresh

    state, log, wall, gaps, peak = run(["--steps", "6", "--export_model_dir", export,
                                        "--decoder_from", decoder_pt], 2, "cli.train resumed")
    resumed = f"resumed from {os.path.join(ckpt, 'step_4')} at step 4" in log
    if not (resumed and state.step == 6 and latest_checkpoint(ckpt) == os.path.join(ckpt, "step_6")):
        fail(f"cli.train resume: resumed {resumed}, step {state.step}, checkpoints {os.listdir(ckpt)}")
    out["steady_s"] += gaps
    out["resumed_peak_gib"] = peak  # cuDNN has timed its algorithms: no search in this run
    out["save_s"].append(parse_ckpt(log, "step_6")[1])
    out["load_s"].append(parse_ckpt(log, "step_4")[1])
    say(f"  cli.train resumed at step 4 (loaded in {out['load_s'][-1]:.2f} s), 2 steps to step 6 "
        f"(step s {[round(g, 3) for g in gaps]}), peak device memory {peak:.2f} GiB, step_6 saved in "
        f"{out['save_s'][-1]:.2f} s, exported {sorted(os.listdir(export))}; wall {wall:.1f} s")

    cfg = dataclasses.replace(chairs.with_steps(20), edit=dataclasses.replace(
        chairs.edit, w_time=min(chairs.edit.w_time, 10), shape_resolution=64))
    if sorted(os.listdir(export)) != ["decoder.orbax", "statistics", "unet.orbax"]:
        fail(f"cli.train --export_model_dir wrote {sorted(os.listdir(export))}")
    t0 = time.perf_counter()
    engine = DragEngine.from_model_dir(export, config=cfg, device=device)
    load_s = time.perf_counter() - t0
    if not all(torch.equal(v, state.ema_params[k]) for k, v in engine.unet.state_dict().items()):
        fail("the served UNet's weights are not the trained EMA")
    with torch.device(device):
        in_memory = UNetModel(chairs.unet)
    in_memory.load_state_dict(state.ema_params)
    memory_engine = DragEngine(cfg, unet=in_memory, decoder=engine.decoder, stats=engine.stats, device=device)
    del state
    sched10 = make_schedule(1000, "linear", "ddim10").to(device)
    x_T = torch.randn((2,) + tuple(chairs.latent_shape), generator=torch.Generator(device=device).manual_seed(7),
                      device=device)
    per_fwd = calls_per_forward(cfg.unet)
    ddim, eps = {}, {}
    t999 = torch.full((2,), 999, dtype=torch.long, device=device)
    for label, eng in (("served", engine), ("in-memory", memory_engine)):
        with torch.no_grad():
            ddim[label], wall, _ = counted(hk, counter, per_fwd, totals, f"DDIM-10 of the {label} EMA UNet",
                                           lambda e=eng: ddim_sample_loop(sched10, e.model_fn(), x_T,
                                                                          clip_denoised=cfg.diffusion.clip_denoised),
                                           10)
            eps[label], _, _ = counted(hk, counter, per_fwd, totals, f"a forward of the {label} EMA UNet",
                                       lambda e=eng: e.model_fn()(x_T, t999)[0], 1)
    same = (torch.equal(ddim["served"], ddim["in-memory"]) and torch.equal(eps["served"], eps["in-memory"])
            and bool(ddim["served"].isfinite().all()))
    say(f"  train -> serve: DDIM-10 at batch 2 from a fixed x_T and one forward at t 999, the served orbax export "
        f"against the in-memory EMA UNet: bit-equal {same} (max |x_0| {float(ddim['served'].abs().max()):.4f}, "
        f"max |output| {float(eps['served'].abs().max()):.3g})")
    if not same:
        fail("the served export's DDIM-10 or forward differs from the in-memory EMA UNet's")
    del memory_engine, in_memory, ddim, eps
    lat, wall, _ = counted(hk, counter, calls_per_forward(cfg.unet), totals,
                           "served update_latent_params", lambda: engine.update_latent_params(seed=0), 20)
    check_mesh("served update_latent_params", engine.mesh0, engine.last_mesh_walls)
    if lat.shape != (1,) + cfg.latent_shape or not np.isfinite(lat).all():
        fail("train -> serve: the served latent is not finite or of the wrong shape")
    say(f"  train -> serve: DragEngine.from_model_dir {load_s:.2f} s (EMA weights), "
        f"update_latent_params {wall:.2f} s (20 steps, 64^3 mesh), latent finite")
    out.update(serve_load_s=load_s, serve_update_latent_params_s=wall)
    shutil.rmtree(ckpt)
    if keep:  # phase 8's GUI serves it
        os.makedirs(KEPT_MODELS)
        shutil.move(export, os.path.join(KEPT_MODELS, "chairs_trained"))
    else:
        shutil.rmtree(export)
    return out


def overfit_check(hk, counter, totals, device="cuda") -> dict:
    """The bf16 miniature UNet (dropout 0.1) trained by ``train.loop.train``
    on 4 fixed latents for 30 steps at lr 1e-3: the mean loss of the last 5
    steps below that of the first 5. Launches exact."""
    import itertools

    from ishapediting_tpu_torch.config import UNetConfig
    from ishapediting_tpu_torch.core.schedule import make_schedule
    from ishapediting_tpu_torch.models.unet import UNetModel, init_unet_
    from ishapediting_tpu_torch.train.loop import train

    cfg = UNetConfig(**MINI_BF16, dropout=0.1)
    latents = np.clip(np.random.default_rng(0).standard_normal((4, 16, 16, 6)), -1, 1).astype(np.float32)
    with torch.device(device):
        model = init_unet_(UNetModel(cfg), torch.Generator(device=device).manual_seed(0))
    losses = []

    def record(step):
        def wrapped(state, batch, gen):
            metrics = step(state, batch, gen)
            losses.append(metrics["loss"])
            return metrics

        return wrapped

    steps = 30
    sync()
    reset(hk)
    counter.n = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        train(cfg, make_schedule(1000, "linear", ""), model, itertools.repeat(latents), total_steps=steps,
              lr=1e-3, log_every=1000, step_transform=record)
    sync()
    wall = time.perf_counter() - t0
    if counter.n != steps:
        fail(f"overfit: {counter.n} UNet forwards for {steps} steps")
    check_launches(hk, f"overfit ({steps} steps)",
                   {k: v * steps for k, v in train_step_launches(hk, cfg).items()}, totals)
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    say(f"  overfit, bf16 miniature UNet on 4 latents, {steps} steps at lr 1e-3: mean loss of the first "
        f"5 steps {first:.4f}, of the last 5 {last:.4f}; {wall / steps * 1e3:.1f} ms/step")
    if not (np.isfinite(losses).all() and last < first):
        fail("overfit: the loss did not fall")
    return dict(first5=first, last5=last, s_per_step=wall / steps)


def training_runs(hk, counter, totals, card, device="cuda", preset_name="chairs", keep=False) -> dict:
    """Phase 7: the train step card against CPU, remat against no remat,
    decoder training, ``cli.train`` at chairs width -> serve, and a small
    overfit; the training numbers printed beside the card."""
    from ishapediting_tpu_torch.config import UNetConfig, preset

    out = {"card_vs_cpu": {
        "bf16_head_dim_64": train_card_check(hk, UNetConfig(**MINI_BF16, dropout=0.1), 3e-2,
                                             "bf16 torso, head dim 64", device),
        "fp32_tiny": train_card_check(hk, dataclasses.replace(preset("tiny").unet, dropout=0.1), 1e-4,
                                      "fp32 torso, head dim 8, generic attention", device),
    }}
    out["remat"] = remat_check(hk, dataclasses.replace(preset("tiny").unet, dropout=0.1), device)
    decoder_pt, out["decoder"] = sphere_decoder(hk, device)
    out["chairs"] = chairs_training(hk, counter, totals, decoder_pt, preset_name, device, keep)
    out["overfit"] = overfit_check(hk, counter, totals, device)
    c = out["chairs"]
    steady = float(np.mean(c["steady_s"]))
    say(f"  training on {card}: {preset_name} train step at batch 8 {c['first_step_s']:.2f} s first, "
        f"{steady:.3f} s steady ({8 / steady:.2f} samples/s), peak device memory {c['peak_gib']:.2f} GiB "
        f"with cuDNN's algorithm search, {c['resumed_peak_gib']:.2f} GiB in the resumed run, "
        f"checkpoint (orbax) {c['ckpt_bytes'] / 1e9:.3f} GB saved in {c['save_s']} s, loaded in {c['load_s']} s "
        f"(torch.save of the same state {c['torch_save_s']:.2f} s); "
        f"decoder {out['decoder']['s_per_step'] * 1e3:.2f} ms/step")
    return out


# ---------------------------------------------------------------------------
# phase 8: the remaining CLIs and host modules
# ---------------------------------------------------------------------------

CHECK_RES = 128  # cli.decode held to the CPU: the grid the CPU decodes in about a second
MESH_RES = 256  # cli.decode timed, the solver sweep's meshes: the published grid
GUI_RES = 64  # the GUI's meshes only: the NumPy renderer draws each at every pick and save


def mesh_match(a, b, differ: np.ndarray, res: int, device="cuda") -> np.ndarray:
    """For each triangle of ``a`` (a unit-cube mesh marched at ``res``^3)
    whose cell lies more than two cells from every voxel of ``differ``, its
    distance to ``b``: the least, over the four triangles of ``b`` with the
    nearest centroids, of the largest coordinate difference between a vertex
    of one triangle and the nearest vertex of the other (so winding and
    vertex order do not count). The differences are taken on ``device``."""
    from scipy.spatial import cKDTree

    ta, tb = a.vertices[a.triangles], b.vertices[b.triangles]
    ca = ta.mean(axis=1)
    bad = np.argwhere(differ)
    if len(bad):  # a voxel is a corner of the cells one below it and its own
        far = cKDTree(bad).query(np.floor((ca + 1) / 2 * res), p=np.inf, workers=-1)[0] > 2
        ta, ca = ta[far], ca[far]
    idx = torch.from_numpy(cKDTree(tb.mean(axis=1)).query(ca, k=4, workers=-1)[1]).to(device)
    ta = torch.from_numpy(ta).to(device)
    cand = torch.from_numpy(tb).to(device)[idx]  # [n, 4, 3, 3]
    d = (ta[:, None, :, None] - cand[:, :, None]).abs().amax(-1)  # [n, 4, 3 of a, 3 of b]
    return torch.maximum(d.amin(-1).amax(-1), d.amin(-2).amax(-1)).amin(-1).cpu().numpy()


def phase8_inputs(engine) -> tuple:
    """The triplane .npy files to decode ([96,128,128], physical scale), the
    decoder that goes with them as a .pt, the mesh pair to evaluate (None:
    the decoded meshes) and its EditLog: phase 4's (cli.generate's first
    DDIM sample, which decodes with the engine's decoder, the same seed and
    preset; cli.edit's original and edited meshes), else DDIM-10 samples of
    this engine at batch 2 and an EditLog written here."""
    from ishapediting_tpu_torch.cli.edit import write_edit_log
    from ishapediting_tpu_torch.core.schedule import make_schedule
    from ishapediting_tpu_torch.edit.fit import latents_to_planes
    from ishapediting_tpu_torch.parallel.sampling import sample_batches

    d = os.path.join(WORK, "host_modules")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    dec_pt = os.path.join(d, "chairs_decoder.pt")
    torch.save(engine.decoder.state_dict(), dec_pt)
    if os.path.isdir(KEPT_TRIPLANES) and os.path.isdir(KEPT_EDIT):
        pair = [os.path.join(KEPT_EDIT, f) for f in ("original.obj", "edit00.obj")]
        planes = [os.path.join(KEPT_TRIPLANES, "0.npy")]
        return d, dec_pt, planes, pair, os.path.join(KEPT_EDIT, "EditLog"), "phase 4's"
    cfg = engine.config
    h, w, c = cfg.latent_shape
    sched = make_schedule(cfg.diffusion.base_steps, cfg.diffusion.noise_schedule, "ddim10").to(engine.device)
    lat = sample_batches(sched, engine.model_fn(), num_samples=2, batch_size=2, latent_shape=cfg.latent_shape,
                         device=engine.device, sampler="ddim")
    tri = latents_to_planes(torch.from_numpy(lat).to(engine.device), engine.half_range, engine.middle)
    planes = []
    for i in range(2):  # [3, H, W, C/3] -> the [C, H, W] of cli.generate
        planes.append(os.path.join(d, f"{i}.npy"))
        np.save(planes[-1], tri[i].permute(0, 3, 1, 2).reshape(c, h, w).cpu().numpy())
    log = os.path.join(d, "EditLog")
    write_edit_log(log, "00", np.array([[0.5, 0.0, 0.0]]), np.array([[0.6, 0.0, 0.0]]), 600.0, 0.2)
    return d, dec_pt, planes, None, log, "DDIM-10 samples of this engine"


def decode_runs(engine, d, dec_pt, planes, device="cuda") -> tuple:
    """``cli.decode`` on the card: the first planes at 128^3 with
    ``--cross_section``, held to the same planes decoded on the CPU by the
    plain path: the grid the CLI marched has the CPU's occupancy except at
    voxels where |logit| < 1e-3; the CLI's mesh has the CPU mesh's
    triangles (up to vertex order, vertices by the stated quantile) outside
    the cells next to those voxels; the mask is the CPU's except where
    |logit| < 1e-3. Then every input at 256^3, timed. Returns (numbers, the
    256^3 OBJ paths)."""
    import copy

    from ishapediting_tpu_torch import compat
    from ishapediting_tpu_torch.cli.decode import main as decode_main
    from ishapediting_tpu_torch.geometry.marching import grid_to_mesh
    from ishapediting_tpu_torch.geometry.render import read_png
    from ishapediting_tpu_torch.io.planes import load_planes
    from ishapediting_tpu_torch.ops.triplane import decode_points_chunked

    out = {}
    marched = []  # (grid, mesh) of each march inside cli.decode's create_obj

    def march(grid, *args, **kwargs):
        mesh = grid_to_mesh(grid, *args, **kwargs)
        marched.append((grid, mesh))
        return mesh

    argv = ["--input", planes[0], "--output", os.path.join(d, f"d{CHECK_RES}.obj"), "--res", str(CHECK_RES),
            "--model_path", dec_pt, "--cross_section", os.path.join(d, f"cs{CHECK_RES}.png"), "--device", device]
    say(f"  python -m ishapediting_tpu_torch.cli.decode {' '.join(argv)}")
    buf = io.StringIO()
    compat.grid_to_mesh = march
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            (card_mesh,) = decode_main(argv)
        out["decode_check_wall_s"] = time.perf_counter() - t0
    finally:
        compat.grid_to_mesh = grid_to_mesh
    ((card_grid, marched_mesh),) = marched
    if marched_mesh is not card_mesh:
        fail("cli.decode: the mesh it returned is not the one create_obj marched")
    nhwc = load_planes(planes[0])
    cpu_dec = copy.deepcopy(engine.decoder).cpu()
    t0 = time.perf_counter()
    cpu_grid = compat.decode_occupancy_grid(cpu_dec, nhwc, CHECK_RES)
    cpu_mesh = grid_to_mesh(cpu_grid)  # create_obj's march
    with torch.no_grad():  # cross_section's points
        logits = decode_points_chunked(cpu_dec, torch.from_numpy(nhwc),
                                       torch.from_numpy(compat.cross_section_coords(CHECK_RES)))
    logits = logits.reshape(CHECK_RES, CHECK_RES).numpy()
    out["cpu_decode_check_s"] = time.perf_counter() - t0
    differ = (card_grid > 0) != (cpu_grid > 0)
    worst = float(np.abs(cpu_grid[differ]).max()) if differ.any() else 0.0
    out.update(grid_max_abs_diff=float(np.abs(card_grid - cpu_grid).max()), voxels_differ=int(differ.sum()),
               inside_share=float((cpu_grid > 0).mean()))
    if worst >= 1e-3:
        fail(f"cli.decode: card and CPU occupancy differ at a voxel with |logit| {worst:.3g} >= 1e-3")
    if len(card_mesh.triangles) == 0:
        fail(f"cli.decode: empty mesh at {CHECK_RES}^3")
    t0 = time.perf_counter()
    moved = [mesh_match(card_mesh, cpu_mesh, differ, CHECK_RES, device),
             mesh_match(cpu_mesh, card_mesh, differ, CHECK_RES, device)]
    out["mesh_match_s"] = time.perf_counter() - t0
    out["triangles_compared"] = [len(m) for m in moved]
    out["triangles_set_aside"] = [len(card_mesh.triangles) - len(moved[0]), len(cpu_mesh.triangles) - len(moved[1])]
    moved = np.concatenate(moved)
    out.update(mesh_moved_q999=float(np.quantile(moved, 0.999)), mesh_moved_max=float(moved.max()))
    say(f"  cli.decode {CHECK_RES}^3 on the card against the CPU: grids differ by {out['grid_max_abs_diff']:.3g} "
        f"at most, occupancy differs at {out['voxels_differ']} voxels (largest |logit| there {worst:.3g}), "
        f"{out['inside_share']:.4f} of the grid inside; meshes {len(card_mesh.triangles)}/"
        f"{len(cpu_mesh.triangles)} triangles, {out['triangles_compared']} compared away from those voxels "
        f"({out['triangles_set_aside']} set aside), vertices apart by {out['mesh_moved_q999']:.3g} at the "
        f"0.999 quantile, {out['mesh_moved_max']:.3g} at most ({out['mesh_match_s']:.1f} s); wall "
        f"{out['decode_check_wall_s']:.2f} s, CPU {out['cpu_decode_check_s']:.2f} s")
    if out["mesh_moved_q999"] >= 2e-3 or out["mesh_moved_max"] >= 2 / CHECK_RES:
        fail(f"cli.decode: the card's {CHECK_RES}^3 mesh is not the CPU's away from the voxels that differ")
    mask = read_png(os.path.join(d, f"cs{CHECK_RES}.png"))[:, :, 0] > 0
    mdiff = mask != (logits > 0)
    say(f"  cross-section {CHECK_RES}^2: {int(mdiff.sum())} pixels differ from the CPU's, {mask.mean():.4f} inside")
    if mdiff.any() and np.abs(logits[mdiff]).max() >= 1e-3:
        fail("cli.decode: the cross-section differs from the CPU's where |logit| >= 1e-3")

    outdir = os.path.join(d, "meshes")
    os.makedirs(outdir)
    argv = ["--input", *planes, "--output", outdir, "--res", str(MESH_RES), "--model_path", dec_pt,
            "--device", device]
    say(f"  python -m ishapediting_tpu_torch.cli.decode {' '.join(argv)}")
    buf = io.StringIO()
    sync()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        meshes = decode_main(argv)
    out["decode_wall_s"] = time.perf_counter() - t0
    out["decode_s_each"] = [float(l.rsplit(", ", 1)[1].rstrip("s)")) for l in buf.getvalue().splitlines()
                            if " -> " in l]
    out["decode_triangles"] = [len(m.triangles) for m in meshes]
    for i, m in enumerate(meshes):
        check_mesh(f"cli.decode {MESH_RES}^3 #{i}", m)
    say(f"  cli.decode {MESH_RES}^3 of {len(planes)} input(s): {out['decode_s_each']} s each (decode on the card, "
        f"march, OBJ write), {out['decode_triangles']} triangles, wall {out['decode_wall_s']:.1f} s")
    return out, [os.path.join(outdir, os.path.splitext(os.path.basename(p))[0] + ".obj") for p in planes]


def eval_runs(d, pair, edit_log) -> dict:
    """``cli.eval`` pairs mode on two 256^3 meshes of random weights:
    chamfer, hausdorff, IoU, and local IoU around the EditLog's handles."""
    from ishapediting_tpu_torch.cli.eval import main as eval_main

    a, b = pair
    argv = ["--mesh_a", a, "--mesh_b", b, "--metrics", "chamfer", "hausdorff", "iou", "local",
            "--edit_log", edit_log, "--out", os.path.join(d, "eval.json")]
    say(f"  python -m ishapediting_tpu_torch.cli.eval {' '.join(argv)}")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rows, summary = eval_main(argv)
    wall = time.perf_counter() - t0
    row = rows[0]
    ok = (all(np.isfinite(row[k]) for k in ("chamfer", "hausdorff", "iou", "local_iou"))
          and 0 <= row["iou"] <= 1 and 0 <= row["local_iou"] <= 1 and row["chamfer"] > 0
          and json.load(open(os.path.join(d, "eval.json")))["summary"] == summary)
    say(f"  cli.eval pair (two meshes of {os.path.getsize(a) / 1e9:.2f} and {os.path.getsize(b) / 1e9:.2f} GB "
        f"of OBJ, 100,000 points): " + json.dumps({k: v for k, v in row.items() if not k.startswith("mesh")})
        + f", wall {wall:.1f} s")
    if not ok:
        fail("cli.eval: a metric is not finite, out of range, or the report differs")
    return dict(eval_pair_wall_s=wall, **{k: v for k, v in row.items() if not k.startswith("mesh")})


SWEEP_BASE_STEPS = 50  # phase 8's chairs sweep: the base chain (dense reference and DDPM), cut for time;
# at 20 steps the linear schedule, scaled by 1000 / steps, reaches beta 1 (alphas_cumprod 0)


def sweep_runs(hk, counter, totals, engine, per_fwd, device="cuda") -> dict:
    """``solver_mesh_sweep`` on the chairs UNet and decoder (base chain cut
    to ``SWEEP_BASE_STEPS`` for time: the dense DDIM reference, ddpm50,
    ddim10, dpm10; 120 forwards at batch 1, four 256^3 meshes); then ``cli.eval --solver_sweep
    --random_init --preset tiny`` on the card (fp32: the generic attention
    kernel). Launches exact per run."""
    from ishapediting_tpu_torch.cli.eval import main as eval_main
    from ishapediting_tpu_torch.config import preset
    from ishapediting_tpu_torch.core.solver_eval import solver_mesh_sweep
    from ishapediting_tpu_torch.edit.engine import DragEngine
    from ishapediting_tpu_torch.utils import threefry

    cfg = engine.config
    cfg = dataclasses.replace(cfg, diffusion=dataclasses.replace(cfg.diffusion, base_steps=SWEEP_BASE_STEPS),
                              edit=dataclasses.replace(cfg.edit, shape_resolution=MESH_RES))
    sweep_engine = DragEngine(cfg, unet=engine.unet, decoder=engine.decoder, stats=engine.stats, device=device)
    say(f"  solver_mesh_sweep(chairs, base chain {SWEEP_BASE_STEPS}, budgets (10,), 1 seed, max_attempts 1)")
    walls = []
    get_mesh = sweep_engine.get_mesh

    def timed_mesh(latent):
        t0 = time.perf_counter()
        m = get_mesh(latent)
        walls.append(time.perf_counter() - t0)
        return m

    sweep_engine.get_mesh = timed_mesh
    draws, normal = [], threefry.normal

    def timed_normal(key, shape):  # x_T and the ancestral chain's step noise, JAX's draws on the host
        t0 = time.perf_counter()
        z = normal(key, shape)
        draws.append(time.perf_counter() - t0)
        return z

    threefry.normal = timed_normal
    try:
        report, wall, _ = counted(hk, counter, per_fwd, totals, "solver sweep (chairs)",
                                  lambda: solver_mesh_sweep(sweep_engine, n_seeds=1, budgets=(10,), max_attempts=1),
                                  2 * SWEEP_BASE_STEPS + 20)
    finally:
        threefry.normal = normal
    out = {"chairs_sweep_wall_s": wall, "chairs_sweep_mesh_s": walls, "chairs_sweep": report,
           "chairs_sweep_draws": len(draws), "chairs_sweep_draw_s": sum(draws)}
    say(f"  solver sweep (chairs): {len(draws)} threefry normal draws of {(1,) + tuple(cfg.latent_shape)} on the host "
        f"(x_T and the ancestral chain's step noise) took {sum(draws):.2f} s of the sweep's {wall:.1f} s")
    ok = (report["seeds"] == 1 and all(report[k]["empty"] == 0 and np.isfinite(report[k]["cd_mean"])
                                       for k in (f"ddpm{SWEEP_BASE_STEPS}", "ddim10", "dpm10")))
    say(f"  solver sweep (chairs): {json.dumps(report)}; mesh walls {[round(w, 2) for w in walls]} s, "
        f"wall {wall:.1f} s")
    if not ok:
        fail("solver sweep (chairs): an empty reference or solver mesh, or a non-finite distance")

    argv = ["--solver_sweep", "--random_init", "--preset", "tiny", "--budgets", "10", "5", "--sweep_seeds", "1",
            "--max_attempts", "1", "--point_num", "5000", "--out", os.path.join(WORK, "sweep_tiny.json"),
            "--device", device]
    say(f"  python -m ishapediting_tpu_torch.cli.eval {' '.join(argv)}")
    buf = io.StringIO()
    sync()
    reset(hk)
    counter.n = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        tiny = eval_main(argv)
    sync()
    wall = time.perf_counter() - t0
    forwards = 100 + 130 * tiny["seeds"]  # the reference chain, then per seed 100 + 10 + 10 + 5 + 5
    if counter.n != forwards:
        fail(f"cli.eval --solver_sweep tiny: {counter.n} UNet forwards, expected {forwards}")
    check_counts(hk, "cli.eval --solver_sweep (tiny)", forwards, calls_per_forward(preset("tiny").unet),
                 totals, attn_kernel="attention_generic")
    say(f"  cli.eval --solver_sweep (tiny, on the card): {json.dumps(tiny)}, wall {wall:.1f} s")
    if tiny["ref"] != "ddim100-dense" or not {"ddpm100", "ddim10", "dpm10", "ddim5", "dpm5"} <= tiny.keys():
        fail("cli.eval --solver_sweep tiny: report keys not as expected")
    out.update(tiny_sweep_wall_s=wall, tiny_sweep=tiny)
    return out


class _SyncThread:
    """``threading.Thread`` for the GUI's workers, run in the calling thread,
    so that each button's work is over when ``click`` returns."""

    def __init__(self, target=None, daemon=None, args=(), kwargs=None):
        self._target, self._args, self._kwargs = target, args, kwargs or {}

    def start(self):
        self._target(*self._args, **self._kwargs)


def gui_runs(hk, counter, totals, engine, per_fwd, dec_pt, device="cuda") -> dict:
    """The GUI over ``DragEngine`` on the headless Open3D backend, on the
    card: select a model (phase 7's exported one, else random weights
    written here as ``cli.train --export_model_dir`` writes one), create a mesh (20 steps, w_time
    10, the seed 0), pick a source and a target by clicks on the rendered
    depth, drag (2 guided steps: forward through the kernels, backward
    through their autograd Functions), save the mesh with its EditLog and
    the picture. The engine keeps the chairs edit config (its 256^3 voxel
    spacing sets the drag's handle patches); only the meshes it hands the
    GUI are marched at 64^3 (GUI_RES)."""
    from ishapediting_tpu_torch.cli.edit import parse_edit_log
    from ishapediting_tpu_torch.cli.train import export_model_dir
    from ishapediting_tpu_torch.geometry.render import read_png
    from ishapediting_tpu_torch.gui.headless import SyntheticMouseEvent, install_headless_open3d

    install_headless_open3d()
    import ishapediting_tpu_torch.gui.app as gui_app

    if gui_app.o3d.geometry.TriangleMesh.__module__ != "ishapediting_tpu_torch.gui.headless":
        fail("GUI: the app did not bind the port's headless backend")
    gui_app.threading = types.SimpleNamespace(Thread=_SyncThread)  # this module's workers only
    if not os.path.isdir(KEPT_MODELS):
        os.makedirs(KEPT_MODELS)
        export_model_dir(os.path.join(KEPT_MODELS, "chairs_random"), engine.unet.state_dict(), decoder_from=dec_pt,
                         channels=engine.config.latent_shape[-1])
    (name,) = os.listdir(KEPT_MODELS)
    app = gui_app.App(models_root=KEPT_MODELS, device=device, config=engine.config)
    out = {}
    t0 = time.perf_counter()
    app._model_combo.on_selection_changed(name, 0)
    out["select_model_s"] = time.perf_counter() - t0
    if app._status.text != f"{name} loaded" or app.engine.device.type != device:
        fail(f"GUI: selecting {name} left the status {app._status.text!r}")
    app.engine.get_mesh = functools.partial(app.engine.get_mesh, res=GUI_RES)
    app._latent_edit.text_value = "0"
    _, out["create_mesh_s"], _ = counted(hk, counter, per_fwd, totals, "GUI create mesh",
                                         app._create_btn.click, 20)
    if app._status.text != "mesh created":
        fail(f"GUI create: status {app._status.text!r}")
    created = app.mesh
    check_mesh("GUI create mesh", created, app.engine.last_mesh_walls)

    # two clicks on the rendered surface: near the image center, and 40 px right of it
    scene = app._scene.scene
    t0 = time.perf_counter()
    _, depth = scene.render()
    out["render_s"] = time.perf_counter() - t0
    hit = np.argwhere(depth < 1.0)
    if len(hit) == 0:
        fail("GUI: the created mesh is not in the rendered view")
    h, w = depth.shape
    clicks = []
    for target in ((h / 2, w / 2), (h / 2, w / 2 + 40)):
        y, x = hit[np.argmin(np.abs(hit - np.array(target)).sum(axis=1))]
        clicks.append((int(x), int(y)))
    t0 = time.perf_counter()
    for x, y in clicks:
        if app._mouse_event(SyntheticMouseEvent(x=x, y=y)) != gui_app.gui.Widget.EventCallbackResult.HANDLED:
            fail("GUI: a ctrl-click was not handled")
    out["two_picks_s"] = time.perf_counter() - t0
    if len(app.source_pnt) != 1 or len(app.target_pnt) != 1:
        fail(f"GUI: picks gave {len(app.source_pnt)} sources and {len(app.target_pnt)} targets")
    on_mesh = [np.abs(created.vertices - p).sum(axis=1).min() for p in app.source_pnt + app.target_pnt]
    if max(on_mesh) != 0.0:
        fail("GUI: a picked point is not a vertex of the mesh")
    say(f"  GUI: picks at pixels {clicks} -> source {np.round(app.source_pnt[0], 4).tolist()}, target "
        f"{np.round(app.target_pnt[0], 4).tolist()} ({out['two_picks_s']:.1f} s for two picks; one render "
        f"of the {len(created.triangles)}-triangle scene {out['render_s']:.1f} s)")

    app._edit_steps_edit.text_value = "2"
    _, out["drag_s"], _ = counted(hk, counter, per_fwd, totals, "GUI drag (2 guided steps)",
                                  app._start_btn.click, 2, steps=2,
                                  back=backward_nodes(app.engine.config.unet, app.engine.config.edit.feat_layer))
    if not app._status.text.startswith("edit done (motion loss "):
        fail(f"GUI drag: status {app._status.text!r}")
    dragged = app.mesh
    check_mesh("GUI drag", dragged, app.engine.last_mesh_walls)
    if len(dragged.vertices) == len(created.vertices) and np.array_equal(dragged.vertices, created.vertices):
        fail("GUI drag: the dragged mesh is the created one")

    gdir = os.path.join(WORK, "gui")
    shutil.rmtree(gdir, ignore_errors=True)
    os.makedirs(gdir)
    t0 = time.perf_counter()
    app._save_mesh_btn.click()
    app.window.dialog.on_done(os.path.join(gdir, "edited.obj"))
    out["save_mesh_s"] = time.perf_counter() - t0
    edits = parse_edit_log(os.path.join(gdir, "EditLog"))
    if (list(edits) != ["01"] or not np.allclose(edits["01"]["sources"], app.source_pnt[0], atol=1e-6)
            or not np.allclose(edits["01"]["targets"], app.target_pnt[0], atol=1e-6)
            or os.path.getsize(os.path.join(gdir, "edited.obj")) == 0):
        fail(f"GUI save mesh: EditLog {edits} or the OBJ not as expected")
    t0 = time.perf_counter()
    app._save_pic_btn.click()
    app.window.dialog.on_done(os.path.join(gdir, "shot.png"))
    out["save_picture_s"] = time.perf_counter() - t0
    img = read_png(os.path.join(gdir, "shot.png"))
    white = (img == 255).all(axis=2)
    if img.shape != (480, 640, 3) or white.all() or not white[0, 0] or not white[-1, -1]:
        fail("GUI save picture: the PNG is empty or its background is not white")
    out.update(model=name, mesh_res=GUI_RES, edit_shape_resolution=app.engine.config.edit.shape_resolution,
               created_triangles=len(created.triangles),
               dragged_triangles=len(dragged.triangles), picture_surface_share=float(1 - white.mean()),
               status=app._status.text)
    say(f"  GUI on the card: select {out['select_model_s']:.1f} s, create {out['create_mesh_s']:.1f} s, "
        f"drag {out['drag_s']:.1f} s, save mesh {out['save_mesh_s']:.1f} s, save picture "
        f"{out['save_picture_s']:.1f} s; {app._status.text}")
    shutil.rmtree(gdir)
    return out


def host_module_runs(hk, counter, totals, mp=None, device="cuda", preset_name="chairs") -> dict:
    """Phase 8 on phase 4's chairs engine where it ran, else on one built
    here (random weights from the seed 0, the same as phase 4's)."""
    from ishapediting_tpu_torch.config import preset
    from ishapediting_tpu_torch.edit.engine import DragEngine

    if mp is not None:
        engine, per_fwd = mp["engine"], mp["per_fwd"]
    else:
        chairs = preset(preset_name, 20)
        chairs = dataclasses.replace(chairs, edit=dataclasses.replace(
            chairs.edit, w_time=10, feat_layer=chairs.edit.feat_layer if preset_name == "tiny" else 8))
        engine, per_fwd = DragEngine(chairs, seed=0, device=device), calls_per_forward(chairs.unet)
    t_all = time.perf_counter()
    d, dec_pt, planes, pair, edit_log, source = phase8_inputs(engine)
    say(f"  inputs: {source} triplanes {[os.path.relpath(p, ROOT) for p in planes]}, meshes and EditLog")
    out = {"inputs": source}
    t0 = time.perf_counter()
    numbers, decoded = decode_runs(engine, d, dec_pt, planes, device)
    out.update(numbers)
    out["decode_phase_wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out.update(eval_runs(d, pair or decoded, edit_log))
    out["eval_wall_s"] = time.perf_counter() - t0
    for path in decoded + (pair or []):  # OBJs of random weights at 256^3 are large
        os.remove(path)
    t0 = time.perf_counter()
    out.update(sweep_runs(hk, counter, totals, engine, per_fwd, device))
    out["sweep_wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["gui"] = gui_runs(hk, counter, totals, engine, per_fwd, dec_pt, device)
    out["gui_wall_s"] = time.perf_counter() - t0
    out["phase_wall_s"] = time.perf_counter() - t_all
    for kept in (d, KEPT_TRIPLANES, KEPT_EDIT, KEPT_MODELS):
        shutil.rmtree(kept, ignore_errors=True)
    say(f"  phase 8: decode {out['decode_phase_wall_s']:.1f} s, eval {out['eval_wall_s']:.1f} s, sweeps "
        f"{out['sweep_wall_s']:.1f} s, GUI {out['gui_wall_s']:.1f} s; {out['phase_wall_s']:.1f} s in all")
    return out


# ---------------------------------------------------------------------------
# phase 9: two ranks on the one card
# ---------------------------------------------------------------------------


RANKS = 2  # processes sharing the card, over gloo (NCCL refuses two ranks on one device)
RANK_LIMIT_S = 400  # a rank still running past this ends itself
DP_BATCH = 4  # the data-parallel step's global batch
TINY_SRC = [np.array([[0.3, 0.1, -0.2]], np.float32),
            np.array([[-0.2, 0.3, 0.1], [0.1, -0.3, 0.2]], np.float32)]
TINY_SCALE, TINY_COF = [40.0, 60.0], [0.3, 0.1]
_CHILDREN: list = []  # process groups the watchdog kills with the parent


def phase9_inputs() -> dict:
    """What the ranks and the parent's one-rank runs share, from numpy and
    CPU generators: (c) the bf16 miniature's weights seed, two global
    batches with their t, noise and dropout masks, and a batch whose last
    rank's rows are NaN; (d) two tiny latents, the inversion's and the
    drag's per-step noises, the handles."""
    from ishapediting_tpu_torch.config import UNetConfig, preset
    from ishapediting_tpu_torch.models.unet import draw_dropout_masks

    cfg = UNetConfig(**MINI_BF16, dropout=0.1)
    gen = torch.Generator().manual_seed(8)
    s = cfg.image_size
    steps = []
    for _ in range(2):
        batch = torch.randn((DP_BATCH, s, s, cfg.in_channels), generator=gen).clamp(-1, 1)
        steps.append(dict(batch=batch, t=torch.randint(1, 1000, (DP_BATCH,), generator=gen),
                          noise=torch.randn(batch.shape, generator=gen),
                          masks=draw_dropout_masks(cfg, DP_BATCH, gen)))
    bad = steps[1]["batch"].clone()
    bad[(RANKS - 1) * DP_BATCH // RANKS:] = float("nan")
    tiny = preset("tiny")
    rng = np.random.default_rng(9)
    w = tiny.edit.w_time
    shape = (2,) + tiny.latent_shape
    return dict(steps=steps, nan_batch=bad,
                latents=rng.uniform(-0.8, 0.8, shape).astype(np.float32),
                inv_noises=rng.normal(size=(w,) + shape).astype(np.float32),
                drag_noises=rng.normal(size=(w,) + shape).astype(np.float32))


def dp_model(device):
    from ishapediting_tpu_torch.config import UNetConfig

    cfg = UNetConfig(**MINI_BF16, dropout=0.1)
    return cfg, signal_model(cfg, torch.Generator().manual_seed(6)).to(device)


def flat_params(model) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in model.parameters()]).cpu()


def tiny_edit_runs(inputs, device, mesh=None) -> dict:
    """(d) on the tiny preset: ``invert_batched`` with the recorded
    inversion noises, ``drag_edit_batched`` on its records with the
    recorded drag noises, ``morph_latents`` at 2 frames; over the ranks of
    ``mesh``, or on one rank."""
    from ishapediting_tpu_torch.config import preset
    from ishapediting_tpu_torch.edit.batch import build_batched_problems, drag_edit_batched, invert_batched
    from ishapediting_tpu_torch.edit.engine import DragEngine
    from ishapediting_tpu_torch.edit.morph import morph_latents
    from ishapediting_tpu_torch.parallel.mesh import replicate

    tiny = preset("tiny")
    eng = DragEngine(tiny, seed=0, device=device)
    if mesh is not None:
        replicate(eng.unet, mesh)
        replicate(eng.decoder, mesh)
    w = tiny.edit.w_time
    lat = torch.from_numpy(inputs["latents"]).to(device)
    inv = invert_batched(eng.sched, eng.model_fn(feat=True), lat, w_time=w,
                         noises=list(inputs["inv_noises"]), mesh=mesh)
    problems = build_batched_problems(TINY_SRC, [s + np.float32(0.2) for s in TINY_SRC], r1=tiny.edit.r1,
                                      voxel_size=tiny.edit.voxel_size, feat_width=inv["features"].shape[-2],
                                      device=device)
    edited = drag_edit_batched(eng.sched, eng.model_fn(feat=True), inv["w"], inv["features"], problems,
                               w_time=w, scale=TINY_SCALE, cof=TINY_COF, noises=list(inputs["drag_noises"]),
                               mesh=mesh)
    with torch.no_grad():
        frames = morph_latents(eng.sched, eng.model_fn(), lat[0], lat[1], [0.0, 1.0], mesh=mesh)
    return dict(drag=edited.cpu(), morph=frames.cpu())


def tiny_edit_forwards() -> int:
    """UNet forwards of ``tiny_edit_runs`` on each rank: the inversion's
    ceil(w_time / 2) batched evaluations, w_time drag steps, the morph's
    T - 1 encode and T decode steps."""
    from ishapediting_tpu_torch.config import preset

    tiny = preset("tiny")
    w, steps = tiny.edit.w_time, int(tiny.diffusion.timestep_respacing)
    return -(-w // 2) + w + (steps - 1) + steps


def rank_worker(work: str, backend: str, device="cuda", preset_name="chairs", grid_res=256) -> None:
    """One rank of phase 9, started by torchrun; every part fatal (exit 1,
    which ends the other rank through torchrun). Writes its numbers to
    ``rank<r>.json`` and its tensors to ``rank<r>.pt`` in ``work``."""
    import ctypes
    import signal

    ctypes.CDLL("libc.so.6").prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG: end with torchrun
    if os.getppid() == 1:
        sys.exit(1)
    t = threading.Timer(RANK_LIMIT_S, lambda: os._exit(3))
    t.daemon = True
    t.start()
    sys.path.insert(0, ROOT)
    from ishapediting_tpu_torch.cli.generate import main as generate
    from ishapediting_tpu_torch.config import preset
    from ishapediting_tpu_torch.core.schedule import make_schedule
    from ishapediting_tpu_torch.edit.engine import DragEngine
    from ishapediting_tpu_torch.edit.fit import latent_to_planes
    from ishapediting_tpu_torch.models.unet import UNetModel
    from ishapediting_tpu_torch.ops import hopper_kernels as hk
    from ishapediting_tpu_torch.ops.triplane import decode_grid
    from ishapediting_tpu_torch.parallel import mesh as pmesh
    from ishapediting_tpu_torch.parallel.decode import decode_grid_sharded
    from ishapediting_tpu_torch.train.trainer import init_train_state, make_optimizer, make_train_step
    from ishapediting_tpu_torch.utils.device import set_cuda_flags
    from ishapediting_tpu_torch.utils.logger import distributed_mean_kvs

    t_start = time.perf_counter()
    pmesh.initialize_distributed(backend, device=device)
    mesh = pmesh.make_mesh(device=device)
    rank, dev = mesh.rank, mesh.device
    set_cuda_flags()
    counter = ForwardCounter(UNetModel)
    totals: dict = {}
    res: dict = {"rank": rank, "size": mesh.size, "device": str(dev), "backend": backend}
    tensors: dict = {}

    def tag(msg):
        say(f"  [rank {rank}] {msg}")

    # (a) cli.generate at full width over the reference's model dir, one trajectory per rank, sharded decode
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    out = os.path.join(work, "generate")
    argv = ["--model_dir", inputs["model_dir"], "--preset", preset_name, "--use_ddim", "--num_steps", "10", "--num_samples", "2",
            "--batch_size", "2", "--seed", "0", "--sharded_decode", "--shape_resolution", str(grid_res),
            "--save_dir", out, "--device", device, "--dist_backend", backend]
    per_fwd = calls_per_forward(preset(preset_name).unet)
    buf = io.StringIO()
    sync()
    reset(hk)
    counter.n = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        samples = generate(argv)
    sync()
    res["generate_wall_s"] = time.perf_counter() - t0
    if counter.n != 10:
        fail(f"rank {rank}: cli.generate ran {counter.n} UNet forwards, expected 10 (DDIM-10 at batch 1)")
    check_counts(hk, f"rank {rank} cli.generate", counter.n, per_fwd, totals)
    res["generate_launches"] = dict(hk.LAUNCHES)
    log = buf.getvalue().splitlines()
    res["sample_s"] = float(next(l for l in log if l.startswith("ddpm time:")).split(":")[1])
    res["decode_mesh_s"] = float(next(l for l in log if l.startswith("decode time:")).split(":")[1])
    res["broadcast_s"] = float(next(l for l in log if "weights broadcast" in l).split(" in ")[1].split()[0])
    obj = os.path.join(out, "objects", f"{rank}.obj")
    res["mesh_bytes"] = os.path.getsize(obj) if os.path.exists(obj) else 0
    if res["mesh_bytes"] == 0:
        fail(f"rank {rank}: its 256^3 mesh {obj} is missing or empty")
    os.remove(obj)  # 256^3 meshes of random weights are large
    res["generate_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    tensors["samples"] = torch.from_numpy(samples)
    tag(f"cli.generate: sampling {res['sample_s']:.3f} s, decode+mesh {res['decode_mesh_s']:.3f} s "
        f"({res['mesh_bytes'] / 1e6:.0f} MB OBJ), weights broadcast {res['broadcast_s']:.3f} s, "
        f"wall {res['generate_wall_s']:.1f} s, peak {res['generate_peak_gib']:.2f} GiB")

    # (b) the first latent decoded over the ranks at 256^3, against decode_grid on one rank
    eng = DragEngine(preset(preset_name, 10, use_ddim=True), seed=0, device=dev)
    pmesh.replicate(eng.decoder, mesh)
    planes = latent_to_planes(torch.from_numpy(samples[:1]).to(dev), eng.half_range, eng.middle)
    sync()
    t0 = time.perf_counter()
    slab = decode_grid_sharded(eng.decoder, planes, mesh, res=grid_res)
    sync()
    res["slab_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    grid = pmesh.gather(slab, mesh)
    sync()
    res["gather_s"] = time.perf_counter() - t0
    if rank == 0:
        t0 = time.perf_counter()
        ref = decode_grid(eng.decoder, planes, res=grid_res)
        sync()
        res["decode_grid_s"] = time.perf_counter() - t0
        res["grid_equal"] = bool(torch.equal(grid, ref))
        res["grid_max_abs_diff"] = float((grid - ref).abs().max())
        if not res["grid_equal"]:
            fail(f"decode_grid_sharded over {mesh.size} ranks differs from decode_grid by "
                 f"{res['grid_max_abs_diff']:.3g}")
        tag(f"decode_grid_sharded {grid_res}^3: slab {res['slab_s']:.3f} s, gather {res['gather_s']:.3f} s; "
            f"decode_grid on one rank {res['decode_grid_s']:.3f} s; bit-equal")
        del ref
    del eng, slab, grid, planes
    torch.cuda.empty_cache()

    # (c) the data-parallel train step on the bf16 miniature, global batch 4, remat, dropout
    cfg, model = dp_model(dev)
    pmesh.replicate(model, mesh)
    state = init_train_state(model, make_optimizer(model.parameters(), grad_clip=0.0))
    step = make_train_step(cfg, make_schedule(1000, "linear", ""), mesh=mesh)
    want = train_step_launches(hk, cfg)
    res["train"] = []
    for i, st in enumerate(inputs["steps"]):
        sync()
        reset(hk)
        t0 = time.perf_counter()
        metrics = step(state, st["batch"].to(dev), t=st["t"].to(dev), noise=st["noise"].to(dev),
                       dropout_masks=[None if m is None else m.to(dev) for m in st["masks"]])
        sync()
        check_launches(hk, f"rank {rank} train step {i + 1}", want, totals)
        res["train"].append(dict(metrics, s=time.perf_counter() - t0,
                                 mean_kvs=distributed_mean_kvs(metrics)))
        if i == 0:
            tensors["grads"] = {k: p.grad.detach().float().cpu() for k, p in model.named_parameters()}
        tensors[f"params_{i + 1}"] = flat_params(model)
    tensors["ema"] = torch.cat([v.reshape(-1) for v in state.ema_params.values()]).cpu()
    before = flat_params(model)
    reset(hk)
    metrics = step(state, inputs["nan_batch"].to(dev), t=inputs["steps"][1]["t"].to(dev),
                   noise=inputs["steps"][1]["noise"].to(dev),
                   dropout_masks=[None if m is None else m.to(dev) for m in inputs["steps"][1]["masks"]])
    sync()
    check_launches(hk, f"rank {rank} train step, NaN shard", want, totals)
    res["nan"] = dict(loss=metrics["loss"], unchanged=bool(torch.equal(before, flat_params(model))),
                      step=state.step)
    if not (math.isnan(metrics["loss"]) and res["nan"]["unchanged"] and state.step == 2):
        fail(f"rank {rank}: the step with a NaN shard changed the state ({res['nan']})")
    tag(f"data-parallel train step (bf16 miniature, global batch {DP_BATCH}, remat, dropout 0.1): "
        f"{[round(r['s'], 3) for r in res['train']]} s, loss {[r['loss'] for r in res['train']]}; "
        f"NaN shard: no rank steps")
    del model, state

    # (d) the tiny preset: batched drag and morph over the ranks
    sync()
    reset(hk)
    counter.n = 0
    t0 = time.perf_counter()
    tensors.update(tiny_edit_runs(inputs, dev, mesh))
    sync()
    res["tiny_s"] = time.perf_counter() - t0
    tiny_per = calls_per_forward(preset("tiny").unet)
    if counter.n != tiny_edit_forwards():
        fail(f"rank {rank}: the tiny runs made {counter.n} UNet forwards, expected {tiny_edit_forwards()}")
    tiny = preset("tiny")
    check_counts(hk, f"rank {rank} tiny drag and morph", counter.n, tiny_per, totals, "attention_generic",
                 steps=tiny.edit.w_time, back=backward_nodes(tiny.unet, tiny.edit.feat_layer))
    tag(f"tiny invert + drag + morph over the ranks: {res['tiny_s']:.1f} s")

    res["totals"] = totals
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["wall_s"] = time.perf_counter() - t_start
    counter.close()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.save(tensors, os.path.join(work, f"rank{rank}.pt"))
    pmesh.barrier()
    if rank == 0:
        shutil.rmtree(out, ignore_errors=True)
    torch.distributed.destroy_process_group()


def ranks_phase(totals, card, ref, device="cuda") -> dict:
    """Phase 9: ``RANKS`` ranks on the one card over gloo, launched once with
    torchrun; their results held to one-rank runs: (a) the gathered DDIM
    latents of ``SIGNAL_DIR``'s UNet to ``ref``'s (``signal_reference``;
    relative L2 2e-2, bf16 batch 1 against batch 2),
    (b) reported by rank 0, (c) parameters bit-equal across ranks, loss
    terms and gradients to the parent's one-rank step at batch 4 (3e-2, the
    bf16 tolerance of phase 7), (d) to the parent's one-rank runs (1e-4)."""
    import gc
    import signal

    from ishapediting_tpu_torch.core.schedule import make_schedule
    from ishapediting_tpu_torch.train.trainer import init_train_state, make_optimizer, make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    say(f"  parent before the ranks: {torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
        f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved")
    d = os.path.join(WORK, "ranks")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    inputs = dict(phase9_inputs(), model_dir=SIGNAL_DIR)
    torch.save(inputs, os.path.join(d, "inputs.pt"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(RANKS),
           os.path.abspath(__file__), "--rank-worker", d, "--dist_backend", "gloo"]
    say(f"  {' '.join(cmd[1:])}")
    log_path = os.path.join(d, "ranks.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, start_new_session=True)
        _CHILDREN.append(proc)
        try:
            rc = proc.wait(timeout=RANK_LIMIT_S + 60)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            rc = "timeout"
    wall = time.perf_counter() - t0
    with open(log_path) as f:
        lines = f.read().splitlines()
    for line in lines:
        if line.startswith("  [rank") or "launches in rank" in line:
            say(line)
    if rc != 0:
        say("\n".join(lines[-60:]))
        fail(f"phase 9: the ranks ended with {rc}")
    ranks = []
    for r in range(RANKS):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            ranks.append(dict(json.load(f), tensors=torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)))

    # (a) the gathered latents against the one-rank DDIM run of the same weights
    samples = ranks[0]["tensors"]["samples"].numpy()
    a_err = [rel_l2(samples[i], ref["ddim"][i]) for i in range(2)]
    same = all(np.array_equal(r["tensors"]["samples"].numpy(), samples) for r in ranks)
    say(f"  (a) cli.generate over {RANKS} ranks against the one-rank DDIM-10 of the same weights: relative L2 "
        f"{a_err[0]:.2e}, {a_err[1]:.2e} (tol 2e-2); the ranks' samples equal: {same}")
    if not (max(a_err) <= 2e-2 and same and np.isfinite(samples).all()):
        fail("phase 9 (a): the latents sampled over the ranks disagree with the one-rank run")

    # (c) the data-parallel step against the parent's one-rank step at batch 4
    r0, r1 = ranks[0]["tensors"], ranks[1]["tensors"]
    for k in ("params_1", "params_2", "ema"):
        if not torch.equal(r0[k], r1[k]):
            fail(f"phase 9 (c): {k} differ between the ranks")
    cfg, model = dp_model(device)
    state = init_train_state(model, make_optimizer(model.parameters(), grad_clip=0.0))
    step = make_train_step(cfg, make_schedule(1000, "linear", ""))
    one = []
    for i, st in enumerate(inputs["steps"]):
        one.append(step(state, st["batch"].to(device), t=st["t"].to(device), noise=st["noise"].to(device),
                        dropout_masks=[None if m is None else m.to(device) for m in st["masks"]]))
        if i == 0:
            grads = {k: p.grad.detach().float().cpu() for k, p in model.named_parameters()}
    loss_err = max(abs(r["train"][i][k] - one[i][k]) / abs(one[i][k])
                   for r in ranks for i in range(2) for k in ("loss", "mse", "vb"))
    kvs_err = max(abs(r["train"][i]["mean_kvs"][k] - one[i][k]) / abs(one[i][k])
                  for r in ranks for i in range(2) for k in ("loss", "mse", "vb"))
    floor = 1e-4 * float(torch.sqrt(sum(g.square().sum() for g in grads.values())))
    g_err = {k: float((r0["grads"][k] - g).norm()) / max(float(g.norm()), floor) for k, g in grads.items()}
    g_all = float(torch.sqrt(sum((r0["grads"][k] - g).square().sum() for k, g in grads.items()))
                  / torch.sqrt(sum(g.square().sum() for g in grads.values())))
    worst = max(g_err, key=g_err.get)
    say(f"  (c) data-parallel step: parameters and EMA bit-equal across the ranks after each step; "
        f"against the one-rank step at batch {DP_BATCH}: loss terms {loss_err:.2e}, "
        f"distributed_mean_kvs {kvs_err:.2e}, gradients relative L2 {g_all:.2e} (worst tensor {worst} "
        f"{g_err[worst]:.2e}) (tol 3e-2); NaN shard: {[r['nan'] for r in ranks]}")
    if not (loss_err <= 3e-2 and kvs_err <= 3e-2 and g_err[worst] <= 3e-2):
        fail("phase 9 (c): the data-parallel step disagrees with the one-rank step")
    del model, state

    # (d) the tiny drag and morph against the parent's one-rank runs
    one_tiny = tiny_edit_runs(inputs, device)
    d_err = {k: max(float((r["tensors"][k] - one_tiny[k]).abs().max()) for r in ranks) for k in ("drag", "morph")}
    say(f"  (d) tiny preset over the ranks against one rank: batched drag N=2 max abs {d_err['drag']:.2e}, "
        f"morph at 2 frames {d_err['morph']:.2e} (tol 1e-4)")
    if not max(d_err.values()) <= 1e-4:
        fail("phase 9 (d): the batched drag or the morph over the ranks disagrees with one rank")

    # (e) every rank's launches into the totals
    for r in ranks:
        for k, v in r["totals"].items():
            totals[k] = totals.get(k, 0) + v
    shutil.rmtree(d)
    out = dict(wall_s=wall, rel_l2_vs_one_rank=a_err, train_loss_rel_err=loss_err, train_grad_rel_l2=g_all,
               tiny_max_abs=d_err, ranks=[{k: v for k, v in r.items() if k != "tensors"} for r in ranks])
    say(f"  ({card}) phase 9 over {RANKS} ranks sharing the card (gloo): "
        + "; ".join(f"rank {r['rank']}: sampling {r['sample_s']:.2f} s, decode+mesh {r['decode_mesh_s']:.2f} s, "
                    f"broadcast {r['broadcast_s']:.2f} s, peak {r['peak_gib']:.2f} GiB, wall {r['wall_s']:.1f} s"
                    for r in ranks)
        + f"; phase wall {wall:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 10: the model axis and cli.serve over ranks, two ranks on the one card
# ---------------------------------------------------------------------------


TP_LIMIT_S = 600  # a rank of phase 10 still running past this ends itself
# (b)'s fp32 miniature: its widths reach the cut policy's 256 output features
MINI_TP = dict(image_size=16, in_channels=6, model_channels=64, out_channels=12, num_res_blocks=1,
               attention_ds=(2,), channel_mult=(1, 2, 4), num_head_channels=32, dropout=0.0,
               compute_dtype="float32")
MINI_TP_FEAT = 1  # its feature tap: [N, 8, 8, 256]
MINI_TP_STEPS = 4  # (b)'s chain: the tiny pipeline at 4 respaced steps, w_time 2
MINI_HANDLE = (np.array([[0.2, 0.1, 0.0]], np.float32), np.array([[0.4, 0.1, 0.0]], np.float32))
TP_BYTES_LIMIT = 0.51  # a rank's share of the chairs UNet's parameter bytes at model_parallel=2
SERVE_FORWARDS = (32, 10)  # cli.serve's UNet forwards on rank 0 (generate 10, sample 20, drag 2) and rank 1


def phase10_inputs() -> dict:
    """From CPU generators: (a) a batch-2 chairs input with its timesteps;
    (b) the miniature's input, timesteps and output weights for the
    guidance gradient, and the drag's x_T and per-step noises."""
    from ishapediting_tpu_torch.config import preset

    chairs, tiny = preset("chairs").unet, preset("tiny")
    gen = torch.Generator().manual_seed(10)
    shape = (1,) + tiny.latent_shape
    return dict(
        x=torch.randn((2, chairs.image_size, chairs.image_size, chairs.in_channels), generator=gen),
        t=torch.tensor([999, 500]),
        mini_x=torch.randn((2,) + tiny.latent_shape, generator=gen), mini_t=torch.tensor([5, 77]),
        w_out=torch.randn((2, 16, 16, 12), generator=gen), w_feat=torch.randn((2, 8, 8, 256), generator=gen),
        x_T=torch.randn(shape, generator=gen), gen_noises=[torch.randn(shape, generator=gen) for _ in range(MINI_TP_STEPS)],
        drag_noises=[torch.randn(shape, generator=gen) for _ in range(2)])


def signal_chairs(gen_device, preset_name="chairs", dropout=0.0):
    """Phase 4's chairs UNet (``init_unet_`` from the generator of seed 0 on
    ``gen_device``) built on the CPU, with signal in the weights the ADM
    init zeroes (each ResBlock's last conv, each attention projection, the
    output conv): U(+-0.1 sqrt(3 / fan_in)) from a CPU generator. Phase 4's
    UNetModel itself computes an output of exactly 0, which any torso would
    match. ``dropout``: the rate of its train forward (no weight changes)."""
    from ishapediting_tpu_torch.config import preset
    from ishapediting_tpu_torch.models.unet import UNetModel, init_unet_

    cfg = dataclasses.replace(preset(preset_name).unet, dropout=dropout)
    model = init_unet_(UNetModel(cfg), torch.Generator(device=gen_device).manual_seed(0))
    gen = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for p in model.parameters():
            if p.dim() > 1 and not p.any():
                p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * (0.1 * math.sqrt(3.0 / p[0].numel())))
    return model.eval().requires_grad_(False)


TRAIN_TP_BATCH = 2  # (e)'s global batch
TRAIN_TP_DROPOUT = 0.1
TRAIN_TP_CLIP = 0.1  # below the chairs-width gradient's global norm (0.17), so the clip runs on both sides
TRAIN_TP_METRIC_TOL = 1e-3  # (e)'s loss terms and global norm, cut against one rank
TRAIN_TP_NORMS_TOL = 2e-2  # (e)'s per-parameter gradient norms, cut against one rank


def train_draws(cfg, step, dev, batch=TRAIN_TP_BATCH):
    """(e)'s draws of step ``step``, from a CPU generator (the same in every
    process): a global batch in [-1, 1] with its t, noise and dropout
    masks, on ``dev``."""
    from ishapediting_tpu_torch.models.unet import draw_dropout_masks

    gen = torch.Generator().manual_seed(30 + step)
    s = cfg.image_size
    x = torch.randn((batch, s, s, cfg.in_channels), generator=gen).clamp(-1, 1)
    t, noise = torch.randint(0, 1000, (batch,), generator=gen), torch.randn(x.shape, generator=gen)
    masks = draw_dropout_masks(cfg, batch, gen) if cfg.dropout > 0 else None
    if masks is not None:
        masks = [None if m is None else m.to(dev) for m in masks]
    return x.to(dev), dict(t=t.to(dev), noise=noise.to(dev), dropout_masks=masks)


def train_steps(model, cfg, dev, mesh=None, steps=2) -> tuple:
    """(e): ``steps`` train steps of ``model`` (remat, AdamW at lr 1e-4,
    grad_clip ``TRAIN_TP_CLIP``, the full 1000-step chain) on ``train_draws``, over
    ``mesh`` or on one rank: the state, and each step's metrics, wall and
    clipped gradient norm per parameter (a cut slice's summed over the
    model axis), the peak GiB and the bytes of parameters, EMA and
    moments this rank holds."""
    from ishapediting_tpu_torch.core.schedule import make_schedule
    from ishapediting_tpu_torch.train.trainer import (grad_square_norms, init_train_state, make_optimizer,
                                                      make_train_step)

    state = init_train_state(model, make_optimizer(model.parameters(), 1e-4, grad_clip=TRAIN_TP_CLIP))
    step = make_train_step(cfg, make_schedule(1000, "linear", ""), mesh=mesh)
    out = dict(metrics=[], step_s=[], norms=[])
    torch.cuda.reset_peak_memory_stats()
    for k in range(steps):
        x, draws = train_draws(cfg, k, dev)
        sync()
        t0 = time.perf_counter()
        out["metrics"].append(step(state, x, **draws))
        sync()
        out["step_s"].append(time.perf_counter() - t0)
        out["norms"].append(grad_square_norms(state).sqrt().cpu())
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    moments = [v for st in state.optimizer.state.values() for v in st.values() if torch.is_tensor(v) and v.dim()]
    out["state_bytes"] = nbytes(*model.parameters(), *state.ema_params.values(), *moments)
    return state, out


def signal_reference(totals, device="cuda", train=True) -> dict:
    """Phases 9 and 10's one-rank reference: ``signal_chairs`` on one rank,
    a forward at batch 2 on phase 10's input and DDIM-10 at batch 2 (seed
    0, drawn as ``cli.generate`` and ``cli.serve``'s ``generate`` draw it),
    then, with ``train``, phase 10 (e)'s two train steps at global batch 2
    (its launches exact, added to ``totals``);
    its UNet and decoder written to ``SIGNAL_DIR`` as a servable model dir
    with identity statistics (a written triplane is its normalized
    latent), which the ranks load."""
    import gc

    from ishapediting_tpu_torch.cli.train import export_model_dir
    from ishapediting_tpu_torch.config import preset
    from ishapediting_tpu_torch.edit.engine import DragEngine
    from ishapediting_tpu_torch.parallel.sampling import sample_batches

    t0 = time.perf_counter()
    chairs = preset("chairs", 10, use_ddim=True)
    one = DragEngine(chairs, unet=signal_chairs(device, dropout=TRAIN_TP_DROPOUT), device=device)
    inputs = phase10_inputs()
    with torch.no_grad():
        forward, _ = one.unet(inputs["x"].to(device), inputs["t"].to(device))
    ddim = sample_batches(one.sched, one.model_fn(), num_samples=2, batch_size=2,
                          latent_shape=chairs.latent_shape, seed=0, sampler="ddim",
                          clip_denoised=chairs.diffusion.clip_denoised, device=device)
    shutil.rmtree(SIGNAL_DIR, ignore_errors=True)
    dec_pt = os.path.join(WORK, "signal_decoder.pt")
    torch.save(one.decoder.state_dict(), dec_pt)
    export_model_dir(SIGNAL_DIR, one.unet.state_dict(), decoder_from=dec_pt, channels=chairs.latent_shape[-1])
    os.remove(dec_pt)
    out = dict(forward=forward.float().cpu().numpy(), ddim=ddim)
    model = one.unet
    del one, forward
    gc.collect()
    torch.cuda.empty_cache()
    if not (np.isfinite(out["ddim"]).all() and np.abs(out["forward"]).max() > 0):
        fail("the one-rank reference of phases 9 and 10: its forward is zero or its samples not finite")
    said = ""
    if train:  # phase 10 (e)'s reference: two train steps of the same UNet on one rank
        from ishapediting_tpu_torch.ops import hopper_kernels as hk

        ucfg = dataclasses.replace(chairs.unet, dropout=TRAIN_TP_DROPOUT)
        reset(hk)
        state, tr = train_steps(model, ucfg, device)
        check_launches(hk, "one-rank reference train steps (2)", {k: 2 * v for k, v in train_step_launches(
            hk, ucfg).items()}, totals)
        out["train"] = tr
        del state
        said = (f"; two train steps at batch {TRAIN_TP_BATCH} (dropout {TRAIN_TP_DROPOUT}, remat, grad_clip {TRAIN_TP_CLIP}): "
                f"{', '.join(f'{s:.2f}' for s in tr['step_s'])} s, peak {tr['peak_gib']:.2f} GiB, "
                f"{tr['state_bytes']} bytes of parameters, EMA and moments")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    say(f"  one-rank reference (phase 4's chairs UNet with signal in its zeroed weights): a forward at "
        f"batch 2 and DDIM-10 at batch 2, written to {os.path.relpath(SIGNAL_DIR, ROOT)}{said}; "
        f"{out['wall_s']:.1f} s")
    return out


def mini_tp_model():
    """(b)'s miniature on the CPU, every weight carrying signal, seed 11."""
    from ishapediting_tpu_torch.config import UNetConfig

    return signal_model(UNetConfig(**MINI_TP), torch.Generator().manual_seed(11))


def mini_tp_runs(model, inputs, dev, remat) -> dict:
    """The guidance gradient (d/dx of weighted output and feature tap) and
    ``update_latent_params`` + a 2-step ``drag_edit`` with the recorded
    noises on a ``DragEngine`` (the tiny pipeline at ``MINI_TP_STEPS``
    steps, w_time 2) over ``model``."""
    from ishapediting_tpu_torch.config import UNetConfig, preset
    from ishapediting_tpu_torch.edit.engine import DragEngine

    x = inputs["mini_x"].to(dev).requires_grad_(True)
    out, feat = model(x, inputs["mini_t"].to(dev), feat_layer=MINI_TP_FEAT, remat=remat)
    loss = (out * inputs["w_out"].to(dev)).sum() + (feat * inputs["w_feat"].to(dev)).sum()
    grad = torch.autograd.grad(loss, x)[0].cpu()
    tiny = preset("tiny", MINI_TP_STEPS)
    cfg = dataclasses.replace(tiny, unet=UNetConfig(**MINI_TP),
                              edit=dataclasses.replace(tiny.edit, w_time=2, feat_layer=MINI_TP_FEAT))
    eng = DragEngine(cfg, unet=model, seed=0, device=dev, remat=remat)
    eng.update_latent_params(latent=inputs["x_T"].numpy(), noises=inputs["gen_noises"])
    eng.drag_edit(*MINI_HANDLE, scale=30.0, cof=0.2, noises=inputs["drag_noises"])
    return dict(grad=grad, edited=torch.from_numpy(np.asarray(eng.edited_latent)))


def mini_tp_launches(remat, cut_min=None) -> dict:
    """Launches of ``mini_tp_runs``: ``MINI_TP_STEPS`` + 3 forwards (the
    gradient's, the sampling steps, 2 drag steps); the gradient's backward
    runs every node (its loss reaches the output) and each drag step's those
    its tap reaches; under remat the gradient's backward recomputes every
    block and each drag step's those its tap reaches. The sampling steps
    want no gradient and launch every bias epilogue (``epilogues``;
    ``cut_min`` for the cut miniature); the other three forwards their
    time-embedding path's, and under remat the recomputed FiLM projections
    (``film_epilogues``)."""
    from ishapediting_tpu_torch.config import UNetConfig
    from ishapediting_tpu_torch.models.unet import kernel_calls_per_forward, kernel_calls_recomputed

    cfg = UNetConfig(**MINI_TP)
    forwards = MINI_TP_STEPS + 3
    gn, attn = (forwards * c for c in kernel_calls_per_forward(cfg))
    plain, fused = (MINI_TP_STEPS * c for c in epilogues(cfg, cut_min=cut_min))
    plain += 3 * film_epilogues(cfg)
    if remat:
        head, tap = kernel_calls_recomputed(cfg, -1, head=True), kernel_calls_recomputed(cfg, MINI_TP_FEAT)
        gn, attn = gn + head[0] + 2 * tap[0], attn + head[1] + 2 * tap[1]
        plain += film_epilogues(cfg, "head") + 2 * film_epilogues(cfg, MINI_TP_FEAT)
    want = {"gn_stats": gn, "gn_norm": gn, "attention": 0, "attention_generic": attn, "bias_add": plain,
            "bias_residual": fused}
    grad, drag = backward_nodes(cfg), backward_nodes(cfg, MINI_TP_FEAT)
    gn_b, attn_b = grad[0] + 2 * drag[0], grad[1] + 2 * drag[1]
    return dict(want, gn_bwd_reduce=gn_b, gn_bwd_apply=gn_b, attn_bwd_dq=attn_b, attn_bwd_dkdv=attn_b)


def param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def tp_worker(work: str, backend: str, device="cuda", preset_name="chairs", grid_res=256) -> None:
    """One rank of phase 10, started by torchrun; every part fatal (exit 1,
    which ends the other rank through torchrun). Writes its numbers to
    ``rank<r>.json`` and its tensors to ``rank<r>.pt`` in ``work``; (d)
    serves the requests on torchrun's stdin."""
    import ctypes
    import signal

    ctypes.CDLL("libc.so.6").prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG: end with torchrun
    if os.getppid() == 1:
        sys.exit(1)
    t = threading.Timer(TP_LIMIT_S, lambda: os._exit(3))
    t.daemon = True
    t.start()
    sys.path.insert(0, ROOT)
    from ishapediting_tpu_torch.cli import serve
    from ishapediting_tpu_torch.config import preset
    from ishapediting_tpu_torch.edit.engine import DragEngine
    from ishapediting_tpu_torch.edit.fit import latent_to_planes
    from ishapediting_tpu_torch.models.unet import UNetModel
    from ishapediting_tpu_torch.ops import hopper_kernels as hk
    from ishapediting_tpu_torch.ops.triplane import decode_grid
    from ishapediting_tpu_torch.parallel import mesh as pmesh
    from ishapediting_tpu_torch.parallel import tensor as ptensor
    from ishapediting_tpu_torch.parallel.decode import decode_grid_sharded
    from ishapediting_tpu_torch.parallel.sampling import sample_batches
    from ishapediting_tpu_torch.utils.device import set_cuda_flags

    t_start = time.perf_counter()
    pmesh.initialize_distributed(backend, device=device)
    mesh = pmesh.make_mesh(RANKS, model_parallel=RANKS, device=device)
    rank, dev = mesh.rank, mesh.device
    set_cuda_flags()
    counter = ForwardCounter(UNetModel)
    totals: dict = {}
    res: dict = {"rank": rank, "shape": mesh.shape, "backend": backend}
    tensors: dict = {}
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)

    def tag(msg):
        say(f"  [rank {rank}] {msg}")

    # (a) the chairs UNet built on the CPU (phase 4's weights, signal in its zero modules), cut; (e) trains it
    chairs = preset(preset_name, 10, use_ddim=True)
    per_fwd = calls_per_forward(chairs.unet)
    per_cut = calls_per_forward(chairs.unet, cut_min=ptensor.MIN_CUT_FEATURES)
    t0 = time.perf_counter()
    model = signal_chairs(dev, preset_name, dropout=TRAIN_TP_DROPOUT)
    res["whole_bytes"] = param_bytes(model)
    res["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ptensor.shard_params_tp(model, mesh)
    sync()
    res["cut_s"] = time.perf_counter() - t0
    res["param_bytes"] = param_bytes(model)
    res["cut_layers"] = sum(getattr(m, "model_axis", None) is not None for m in model.modules())
    res["bytes_ratio"] = res["param_bytes"] / res["whole_bytes"]
    if res["bytes_ratio"] > TP_BYTES_LIMIT:
        fail(f"rank {rank}: holds {res['param_bytes']} parameter bytes, {res['bytes_ratio']:.4f} of one rank's")
    engine = DragEngine(chairs, unet=model, seed=0, device=dev)
    x, tt = inputs["x"].to(dev), inputs["t"].to(dev)
    with torch.no_grad():
        (out, _), res["first_forward_s"], peak1 = counted(hk, counter, per_cut, totals,
                                                          f"rank {rank} cut forward (first)", lambda: model(x, tt), 1)
        ptensor.reset_gather_counts()
        _, res["forward_s"], peak2 = counted(hk, counter, per_cut, totals, f"rank {rank} cut forward",
                                             lambda: model(x, tt), 1)
    res["gathers"], res["gather_s"], res["gather_bytes"] = (ptensor.GATHERS[k] for k in ("calls", "s", "bytes"))
    tensors["forward"] = out.float().cpu()
    kw = dict(num_samples=2, batch_size=2, latent_shape=chairs.latent_shape, seed=0, sampler="ddim",
              clip_denoised=chairs.diffusion.clip_denoised, mesh=mesh)
    samples, res["ddim_s"], peak3 = counted(hk, counter, per_cut, totals, f"rank {rank} DDIM-10 (model axis)",
                                            lambda: sample_batches(engine.sched, engine.model_fn(), **kw), 10)
    tensors["ddim"] = torch.from_numpy(samples)
    res["first_peak_gib"], res["peak_gib"] = peak1, max(peak2, peak3)
    tag(f"chairs UNet cut over the model axis {mesh.shape}: {res['cut_layers']} layers cut, "
        f"{res['param_bytes']} parameter bytes ({res['bytes_ratio']:.4f} of one rank's {res['whole_bytes']}), "
        f"built on the CPU {res['build_s']:.1f} s, cut {res['cut_s']:.2f} s; forward at batch 2 "
        f"{res['first_forward_s']:.2f} s first, then {res['forward_s']:.3f} s with {res['gathers']} gathers ({res['gather_bytes'] / 1e6:.0f} MB) in "
        f"{res['gather_s']:.3f} s; DDIM-10 at batch 2 {res['ddim_s']:.2f} s; peak {res['first_peak_gib']:.2f} "
        f"GiB in the first forward (cuDNN's algorithm search), {res['peak_gib']:.2f} GiB after")

    # (c) the first latent decoded over the 2-D mesh at 256^3, against decode_grid
    planes = latent_to_planes(torch.from_numpy(samples[:1]).to(dev), engine.half_range, engine.middle)
    pmesh.replicate(engine.decoder, mesh)
    sync()
    t0 = time.perf_counter()
    slab = decode_grid_sharded(engine.decoder, planes, mesh, res=grid_res)
    sync()
    res["slab_s"], res["slab_shape"] = time.perf_counter() - t0, list(slab.shape)
    grid = pmesh.gather_mesh(slab, mesh)
    if rank == 0:
        ref = decode_grid(engine.decoder, planes, res=grid_res)
        res["grid_equal"] = bool(torch.equal(grid, ref))
        if not res["grid_equal"]:
            fail(f"decode_grid_sharded over the 2-D mesh differs from decode_grid by "
                 f"{float((grid - ref).abs().max()):.3g}")
        tag(f"decode_grid_sharded {grid_res}^3 over {mesh.shape}: slab {res['slab_shape']} in {res['slab_s']:.3f} s; "
            f"gathered, bit-equal to decode_grid")
        del ref
    del engine, slab, grid, planes, out
    torch.cuda.empty_cache()

    # (b) the fp32 miniature's guidance gradient and a 2-step drag, cut and whole, without and with remat
    cut = ptensor.shard_params_tp(mini_tp_model(), mesh).eval().requires_grad_(False)
    whole = mini_tp_model().to(dev).eval().requires_grad_(False)
    for remat in (False, True):
        for label, m in (("cut", cut), ("whole", whole)):
            sync()
            reset(hk)
            t0 = time.perf_counter()
            tensors[f"mini_{label}_remat{int(remat)}"] = mini_tp_runs(m, inputs, dev, remat)
            sync()
            res[f"mini_{label}_remat{int(remat)}_s"] = time.perf_counter() - t0
            check_launches(hk, f"rank {rank} miniature gradient + drag ({label}, remat {remat})",
                           mini_tp_launches(remat, ptensor.MIN_CUT_FEATURES if label == "cut" else None), totals)
    tag("fp32 miniature, guidance gradient + 2-step drag, cut / whole: "
        + ", ".join(f"remat {r} {res[f'mini_cut_remat{r}_s']:.2f} / {res[f'mini_whole_remat{r}_s']:.2f} s"
                    for r in (0, 1)))
    del cut, whole

    # (d) cli.serve over the ranks, on the requests piped to torchrun's stdin
    sync()
    reset(hk)
    counter.n = 0
    t0 = time.perf_counter()
    serve.main(["--dist_backend", backend, "--device", device])
    sync()
    res["serve_wall_s"] = time.perf_counter() - t0
    want = SERVE_FORWARDS[min(rank, 1)]
    if counter.n != want:
        fail(f"rank {rank}: cli.serve ran {counter.n} UNet forwards, expected {want}")
    drags = 2 if rank == 0 else 0  # the 2-step drag runs on the first rank
    check_counts(hk, f"rank {rank} cli.serve", counter.n, per_fwd, totals, steps=drags,
                 back=backward_nodes(chairs.unet, 8))
    tag(f"cli.serve over the ranks: {counter.n} UNet forwards, wall {res['serve_wall_s']:.1f} s")

    # (e) the chairs UNet cut over the model axis trains: two steps on the reference's draws
    from ishapediting_tpu_torch.config import UNetConfig
    from ishapediting_tpu_torch.core.schedule import make_schedule
    from ishapediting_tpu_torch.io.checkpoint import load_train_state, save_train_state, whole_state
    from ishapediting_tpu_torch.train.trainer import init_train_state, make_optimizer, make_train_step

    ucfg = dataclasses.replace(chairs.unet, dropout=TRAIN_TP_DROPOUT)
    sync()
    reset(hk)
    ptensor.reset_gather_counts()
    state, tr = train_steps(model, ucfg, dev, mesh)
    check_launches(hk, f"rank {rank} cut train steps (2)", {k: 2 * v for k, v in train_step_launches(
        hk, ucfg).items()}, totals)
    tensors["train_norms"] = tr.pop("norms")
    res["train"] = dict(tr, gathers=ptensor.GATHERS["calls"], gloo_s=ptensor.GATHERS["s"],
                        whole_state_bytes=4 * res["whole_bytes"])
    tag(f"cut train steps at global batch {TRAIN_TP_BATCH}: {', '.join(f'{x:.2f}' for x in tr['step_s'])} s "
        f"(first, steady), peak {tr['peak_gib']:.2f} GiB, {tr['state_bytes']} bytes of parameters, EMA and "
        f"moments ({tr['state_bytes'] / res['train']['whole_state_bytes']:.4f} of one rank's), "
        f"{res['train']['gathers']} gathers in {res['train']['gloo_s']:.2f} s")
    del state, model
    torch.cuda.empty_cache()

    # (e) the fp32 miniature: one step cut and whole on the same draws; a checkpoint saved cut, loaded whole
    mcfg = UNetConfig(**MINI_TP)
    sched = make_schedule(1000, "linear", "")
    states = {}
    for label, m in (("cut", ptensor.shard_params_tp(mini_tp_model(), mesh)), ("whole", mini_tp_model().to(dev))):
        st = init_train_state(m, make_optimizer(m.parameters(), 1e-4, grad_clip=1.0))
        x, draws = train_draws(mcfg, 0, dev)
        sync()
        reset(hk)
        res[f"mini_train_{label}"] = make_train_step(mcfg, sched, mesh=mesh if label == "cut" else None)(
            st, x, **draws)
        check_launches(hk, f"rank {rank} miniature train step ({label})", train_step_launches(hk, mcfg), totals)
        states[label] = st
    cut_params = ptensor.gather_named(states["cut"].model, dict(states["cut"].model.named_parameters()))
    tensors["mini_train_cut"] = {k: v.detach().cpu() for k, v in cut_params.items()}
    tensors["mini_train_whole"] = {k: v.detach().cpu() for k, v in states["whole"].model.named_parameters()}
    ckpt = os.path.join(work, "mini_cut_ckpt")
    t0 = time.perf_counter()
    nbytes = save_train_state(ckpt, states["cut"], mesh)  # orbax, written by the mesh's first rank
    save_s = time.perf_counter() - t0
    saved = whole_state(states["cut"])
    fresh = mini_tp_model().to(dev)
    loaded = load_train_state(ckpt, init_train_state(fresh, make_optimizer(fresh.parameters(), 1e-4, grad_clip=1.0)))
    got = whole_state(loaded)
    res["mini_ckpt_equal"] = (os.path.exists(os.path.join(ckpt, "manifest.ocdbt")) and got["step"] == saved["step"] == 1
                              and all(torch.equal(got[f][k], saved[f][k]) for f in ("params", "ema_params")
                                      for k in saved[f])
                              and all(torch.equal(got["optimizer"]["state"][i][m], v)
                                      for i, st in saved["optimizer"]["state"].items() for m, v in st.items()))
    tag(f"fp32 miniature train step cut / whole: loss {res['mini_train_cut']['loss']:.6g} / "
        f"{res['mini_train_whole']['loss']:.6g}; cut checkpoint (orbax, {nbytes} bytes, {save_s:.2f} s) loaded "
        f"whole, params, EMA, Adam moments and step bit-equal: {res['mini_ckpt_equal']}")
    del states, fresh

    res["totals"] = totals
    res["wall_s"] = time.perf_counter() - t_start
    counter.close()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    torch.save(tensors, os.path.join(work, f"rank{rank}.pt"))
    pmesh.barrier()
    torch.distributed.destroy_process_group()


def norms_rel_err(got, want) -> float:
    """The largest error of per-parameter gradient norms, each relative to
    the larger of its own and 1e-3 of the whole gradient's norm."""
    got, want = got.double(), want.double()
    floor = 1e-3 * float(want.square().sum().sqrt())
    return float(((got - want).abs() / want.clamp_min(floor)).max())


def tp_phase(totals, card, ref, device="cuda") -> dict:
    """Phase 10: ``RANKS`` ranks on the one card over gloo, launched once
    with torchrun, with the session's requests on its stdin; their results
    held to one-rank runs: (a) the cut forward and DDIM-10 to the same runs
    of the whole UNet (``ref``, ``signal_reference``; relative L2 2e-2),
    (b) the cut miniature to the whole one (1e-4), (c) reported by rank 0,
    (d) every response ok and the triplanes that the server generated from
    ``SIGNAL_DIR`` to ``ref``'s DDIM-10 (2e-2)."""
    import gc
    import signal

    gc.collect()
    torch.cuda.empty_cache()
    d = os.path.join(WORK, "model_axis")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    inputs = phase10_inputs()
    torch.save(inputs, os.path.join(d, "inputs.pt"))
    sdir = os.path.join(d, "served")
    reqs = [
        {"cmd": "init_random", "preset": "chairs", "num_steps": 20, "w_time": 10, "feat_layer": 8,
         "shape_resolution": 64, "seed": 0},
        {"cmd": "sample", "seed": 0},
        {"cmd": "drag", "sources": HANDLE[0].tolist(), "targets": HANDLE[1].tolist(), "edit_steps": 2},
        {"cmd": "load_model", "model_dir": SIGNAL_DIR, "preset": "chairs", "num_steps": 20},
        {"cmd": "generate", "num_samples": 2, "batch_size": 2, "sampler": "ddim", "num_steps": 10, "seed": 0,
         "out_dir": sdir, "decode": True, "shape_resolution": 64, "smooth": 0},
        {"cmd": "status"},
        {"cmd": "quit"},
    ]
    req_path = os.path.join(d, "requests.jsonl")
    with open(req_path, "w") as f:
        f.write("".join(json.dumps(r) + "\n" for r in reqs))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(RANKS),
           os.path.abspath(__file__), "--tp-worker", d, "--dist_backend", "gloo"]
    say(f"  {' '.join(cmd[1:])} < {os.path.relpath(req_path, ROOT)}")
    log_path = os.path.join(d, "ranks.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log, open(req_path) as stdin:
        proc = subprocess.Popen(cmd, stdin=stdin, stdout=log, stderr=subprocess.STDOUT, cwd=ROOT,
                                start_new_session=True)
        _CHILDREN.append(proc)
        try:
            rc = proc.wait(timeout=TP_LIMIT_S + 60)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            rc = "timeout"
    wall = time.perf_counter() - t0
    with open(log_path) as f:
        lines = f.read().splitlines()
    for line in lines:
        if line.startswith("  [rank") or "launches in rank" in line:
            say(line)
    if rc != 0:
        say("\n".join(lines[-60:]))
        fail(f"phase 10: the ranks ended with {rc}")
    ranks = []
    for r in range(RANKS):
        with open(os.path.join(d, f"rank{r}.json")) as f:
            ranks.append(dict(json.load(f), tensors=torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)))

    # (a) the cut forward and DDIM-10 against the whole UNet's on one rank
    fwd_err = [rel_l2(r["tensors"]["forward"].numpy(), ref["forward"]) for r in ranks]
    ddim_err = [rel_l2(r["tensors"]["ddim"][i].numpy(), ref["ddim"][i]) for r in ranks for i in range(2)]
    say(f"  (a) chairs UNet over the model axis: forward at batch 2 against the whole UNet's on one rank, "
        f"relative L2 {max(fwd_err):.2e}; DDIM-10 latents {max(ddim_err):.2e} (tol 2e-2); "
        f"{ranks[0]['gathers']} gathers per forward; parameter bytes per rank "
        f"{[r['param_bytes'] for r in ranks]} ({ranks[0]['bytes_ratio']:.4f} of one rank's, limit 0.51)")
    if not (max(fwd_err) <= 2e-2 and max(ddim_err) <= 2e-2):
        fail("phase 10 (a): the forward or DDIM-10 over the model axis disagrees with one rank")

    # (b) the miniature cut against whole, on each rank
    b_err = {}
    for remat in (0, 1):
        for k in ("grad", "edited"):
            b_err[f"{k}_remat{remat}"] = max(rel_l2(r["tensors"][f"mini_cut_remat{remat}"][k].numpy(),
                                                    r["tensors"][f"mini_whole_remat{remat}"][k].numpy())
                                             for r in ranks)
    say(f"  (b) fp32 miniature over the model axis against whole (relative L2, tol 1e-4): "
        + ", ".join(f"{k} {v:.2e}" for k, v in b_err.items()))
    if not max(b_err.values()) <= 1e-4:
        fail("phase 10 (b): the guidance gradient or drag over the model axis disagrees with one rank")

    # (d) the serve session: every response ok, the served model's triplanes against the one-rank reference
    msgs = [json.loads(line) for line in lines if line.startswith("{")]
    responses = [m for m in msgs if "cmd" in m]
    if [m["cmd"] for m in responses] != [r["cmd"] for r in reqs] or not all(m["ok"] for m in responses):
        fail(f"phase 10 (d): cli.serve over the ranks answered {responses}")
    serve_err = [rel_l2(np.load(os.path.join(sdir, "triplanes", f"{i}.npy")).transpose(1, 2, 0), ref["ddim"][i])
                 for i in range(2)]
    gen_resp = next(m for m in responses if m["cmd"] == "generate")
    say(f"  (d) cli.serve over {RANKS} ranks: {len(responses)} responses, all ok; generate sampled "
        f"{gen_resp['sample_s']:.2f} s, decoded 2 meshes at 64^3 in {gen_resp['decode_s']:.2f} s; triplanes "
        f"of the loaded model against its one-rank DDIM-10 relative L2 {max(serve_err):.2e} (tol 2e-2); session wall "
        f"{ranks[0]['serve_wall_s']:.1f} s")
    if not max(serve_err) <= 2e-2:
        fail("phase 10 (d): the served triplanes disagree with the one-rank samples of the same weights")

    # (e) the cut train steps against the one-rank reference's; the miniature cut against whole
    rt = ref["train"]
    e_err = {}
    for i in range(2):
        for k in ("loss", "mse", "vb", "grad_norm"):
            want = rt["metrics"][i][k]
            e_err[f"step{i + 1}_{k}"] = max(abs(r["train"]["metrics"][i][k] - want) / abs(want) for r in ranks)
        e_err[f"step{i + 1}_param_grad_norms"] = max(norms_rel_err(r["tensors"]["train_norms"][i], rt["norms"][i])
                                                     for r in ranks)
    say(f"  (e) chairs UNet over the model axis, two train steps at global batch {TRAIN_TP_BATCH} against one "
        f"rank (relative, tol {TRAIN_TP_METRIC_TOL:g} on loss, mse, vb and grad_norm, {TRAIN_TP_NORMS_TOL:g} on "
        f"each of the {len(rt['norms'][0])} parameters' clipped gradient norms; grad_clip {TRAIN_TP_CLIP}): "
        + ", ".join(f"{k} {v:.2e}" for k, v in e_err.items()))
    say("  (e) measured: one-rank " + ", ".join(f"step {i + 1} loss {m['loss']:.6g} mse {m['mse']:.6g} vb "
                                                 f"{m['vb']:.6g} grad_norm {m['grad_norm']:.6g}"
                                                 for i, m in enumerate(rt["metrics"]))
        + "; rank 0 " + ", ".join(f"step {i + 1} loss {m['loss']:.6g} mse {m['mse']:.6g} vb {m['vb']:.6g} "
                                  f"grad_norm {m['grad_norm']:.6g}" for i, m in enumerate(ranks[0]["train"]["metrics"])))
    if not all(v <= (TRAIN_TP_NORMS_TOL if k.endswith("param_grad_norms") else TRAIN_TP_METRIC_TOL)
               for k, v in e_err.items()):
        fail("phase 10 (e): the cut train steps disagree with the one-rank steps")
    if not all(m["grad_norm"] > TRAIN_TP_CLIP for m in rt["metrics"]):
        fail(f"phase 10 (e): the gradient's global norm is below grad_clip {TRAIN_TP_CLIP}: the clip did not run")
    m_err = {k: max(abs(r["mini_train_cut"][k] - r["mini_train_whole"][k]) / abs(r["mini_train_whole"][k])
                    for r in ranks) for k in ("loss", "grad_norm")}
    m_err["params"] = max(rel_l2(torch.cat([v.reshape(-1) for v in r["tensors"]["mini_train_cut"].values()]).numpy(),
                                 torch.cat([v.reshape(-1) for v in r["tensors"]["mini_train_whole"].values()]).numpy())
                          for r in ranks)
    say(f"  (e) fp32 miniature train step cut against whole (relative, tol 1e-4): "
        + ", ".join(f"{k} {v:.2e}" for k, v in m_err.items())
        + f"; cut checkpoint loaded whole bit-equal on every rank: {all(r['mini_ckpt_equal'] for r in ranks)}")
    if not (max(m_err.values()) <= 1e-4 and all(r["mini_ckpt_equal"] for r in ranks)):
        fail("phase 10 (e): the miniature's cut train step or checkpoint disagrees with the whole one")

    for r in ranks:
        for k, v in r["totals"].items():
            totals[k] = totals.get(k, 0) + v
    shutil.rmtree(d)
    out = dict(wall_s=wall, forward_rel_l2=fwd_err, ddim_rel_l2=ddim_err, mini_rel_l2=b_err, serve_rel_l2=serve_err,
               train_rel_err=e_err, mini_train_rel_err=m_err, reference_train={
                   k: v for k, v in rt.items() if k != "norms"},
               train_param_grad_norms={  # each step's clipped gradient norm per parameter
                   who: [[float(f"{x:.6g}") for x in n.tolist()] for n in norms]
                   for who, norms in (("one_rank", rt["norms"]), ("rank0", ranks[0]["tensors"]["train_norms"]))},
               serve_responses=[{k: v for k, v in m.items() if k in ("cmd", "ok", "sample_s", "decode_s")}
                                for m in responses],
               ranks=[{k: v for k, v in r.items() if k != "tensors"} for r in ranks])
    say(f"  ({card}) phase 10 over {RANKS} ranks sharing the card (gloo): "
        + "; ".join(f"rank {r['rank']}: {r['param_bytes']} parameter bytes, peak {r['peak_gib']:.2f} GiB in (a), "
                    f"forward {r['forward_s']:.3f} s ({r['gathers']} gathers, {r['gather_s']:.3f} s), DDIM-10 "
                    f"{r['ddim_s']:.2f} s, serve {r['serve_wall_s']:.1f} s, train steps "
                    f"{r['train']['step_s'][0]:.2f} / {r['train']['step_s'][1]:.2f} s (peak {r['train']['peak_gib']:.2f} "
                    f"GiB, {r['train']['state_bytes']} state bytes, gloo {r['train']['gloo_s']:.2f} s), "
                    f"wall {r['wall_s']:.1f} s" for r in ranks)
        + f"; phase wall {wall:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 11: a model dir and a train state the JAX package wrote with orbax
# ---------------------------------------------------------------------------


ORBAX_ASSETS = os.path.join(ROOT, "tests", "assets", "orbax")  # tests/assets/make_orbax_assets.py wrote it
ORBAX_DDIM_ATOL = 1e-3  # the card's fp32 kernels against JAX on the CPU after 10 DDIM steps


def tree_items(tree, prefix=""):
    """(path, tensor) of every array leaf of a ``load_params`` tree, its
    dict keys and list indices joined by '/' (``None`` leaves skipped)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return [] if tree is None else [(prefix, tree)]
    return [kv for k, v in items for kv in tree_items(v, f"{prefix}/{k}" if prefix else str(k))]


def leaf_record(t) -> dict:
    bf16 = t.dtype == torch.bfloat16
    arr = np.ascontiguousarray((t.view(torch.uint16) if bf16 else t).numpy())
    return {"sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
            "dtype": "bfloat16" if bf16 else str(arr.dtype), "shape": list(arr.shape)}


def orbax_phase(hk, counter, totals, card) -> dict:
    """Phase 11: the committed fixture (``tests/assets/orbax``: a tiny model
    dir and a train state the JAX package saved with orbax) on the card:
    ``DragEngine.from_model_dir`` and every leaf against ``sha256.json``;
    DDIM-10 from its x_T through the kernels against JAX's latents;
    ``cli.decode --model_dir``; ``train`` resumed from the JAX ``step_3``
    for one step; the reader's MB/s."""
    from ishapediting_tpu_torch.cli.decode import main as decode_main
    from ishapediting_tpu_torch.config import preset
    from ishapediting_tpu_torch.core.diffusion import ddim_sample_loop
    from ishapediting_tpu_torch.core.schedule import make_schedule
    from ishapediting_tpu_torch.edit.engine import DragEngine
    from ishapediting_tpu_torch.io.orbax import load_params
    from ishapediting_tpu_torch.models.unet import UNetModel
    from ishapediting_tpu_torch.train.loop import train

    out = {}
    model_dir = os.path.join(ORBAX_ASSETS, "model")
    cfg = preset("tiny", 10, use_ddim=True)
    t0 = time.perf_counter()
    engine = DragEngine.from_model_dir(model_dir, config=cfg, device="cuda")
    sync()
    out["from_model_dir_s"] = time.perf_counter() - t0
    with open(os.path.join(ORBAX_ASSETS, "sha256.json")) as f:
        want = json.load(f)
    t0 = time.perf_counter()
    trees = {name: load_params(os.path.join(ORBAX_ASSETS, name)) for name in want}
    out["read_s"] = time.perf_counter() - t0
    out["read_bytes"] = sum(os.path.getsize(os.path.join(dp, n)) for name in want
                            for dp, _, ns in os.walk(os.path.join(ORBAX_ASSETS, name)) for n in ns)
    out["read_mb_s"] = out["read_bytes"] / out["read_s"] / 1e6
    out["leaves"] = 0
    for name, leaves in want.items():
        got = dict(tree_items(trees[name]))
        if sorted(got) != sorted(leaves) or any(leaf_record(v) != leaves[k] for k, v in got.items()):
            fail(f"phase 11: {name} read by the port differs from the leaves JAX restored (sha256.json)")
        out["leaves"] += len(got)
    say(f"  read {out['leaves']} leaves of 3 orbax trees ({out['read_bytes']} bytes) in {out['read_s']:.3f} s "
        f"({out['read_mb_s']:.1f} MB/s), each equal to sha256.json; from_model_dir on the card "
        f"{out['from_model_dir_s']:.3f} s")

    npz = np.load(os.path.join(ORBAX_ASSETS, "jax_ddim.npz"))
    x_T = torch.from_numpy(npz["x_T"]).cuda()
    per_fwd = calls_per_forward(cfg.unet)
    with torch.no_grad():
        lat, out["ddim_s"], _ = counted(
            hk, counter, per_fwd, totals, "orbax model DDIM-10 at batch 2",
            lambda: ddim_sample_loop(engine.sched, engine.model_fn(), x_T, clip_denoised=cfg.diffusion.clip_denoised),
            10, attn_kernel="attention_generic")
    lat = lat.cpu().numpy()
    out["ddim_max_abs_err"] = float(np.abs(lat - npz["ddim"]).max())
    say(f"  DDIM-10 of the JAX-trained dir from JAX's x_T on the card: max |err| {out['ddim_max_abs_err']:.2e} "
        f"against JAX's latents (tol {ORBAX_DDIM_ATOL}), {out['ddim_s']:.3f} s")
    if not out["ddim_max_abs_err"] <= ORBAX_DDIM_ATOL:
        fail("phase 11: DDIM-10 of the orbax model dir disagrees with JAX's latents")

    d = os.path.join(WORK, "orbax")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    planes = os.path.join(d, "latent0.npy")
    np.save(planes, lat[0].transpose(2, 0, 1))  # identity statistics: the triplane is the latent
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        meshes = decode_main(["--input", planes, "--output", os.path.join(d, "latent0.obj"), "--model_dir",
                              model_dir, "--res", "64", "--device", "cuda"])
    out["decode_s"] = time.perf_counter() - t0
    if not os.path.exists(os.path.join(d, "latent0.obj")):
        fail("phase 11: cli.decode --model_dir on the orbax dir wrote no mesh")
    say(f"  cli.decode --model_dir (decoder.orbax) at 64^3: {len(meshes[0].vertices)} vertices, "
        f"{out['decode_s']:.2f} s")

    ckpt = os.path.join(d, "train")
    shutil.copytree(os.path.join(ORBAX_ASSETS, "train"), ckpt)
    seen = {}

    def watch(step):
        def run(state, batch, gen):
            seen["metrics"] = step(state, batch, gen)
            return seen["metrics"]
        return run

    rng = np.random.default_rng(11)
    batches = (np.clip(rng.standard_normal((2,) + cfg.latent_shape), -1, 1).astype(np.float32) for _ in range(9))
    model = UNetModel(cfg.unet).cuda()
    sync()
    reset(hk)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        state = train(cfg.unet, make_schedule(cfg.diffusion.base_steps, cfg.diffusion.noise_schedule, ""), model,
                      batches, total_steps=4, ckpt_dir=ckpt, log_every=100, step_transform=watch)
    sync()
    out["resume_s"] = time.perf_counter() - t0
    check_launches(hk, "train resumed from the JAX step_3 (1 step)", train_step_launches(hk, cfg.unet), totals)
    out["resumed_step"], out["resumed_loss"] = state.step, seen["metrics"]["loss"]
    say(f"  train resumed from the JAX train state step_3 on the card: step {state.step}, loss "
        f"{out['resumed_loss']:.6g}, {out['resume_s']:.2f} s (load, one step, a save)")
    if state.step != 4 or not math.isfinite(out["resumed_loss"]):
        fail("phase 11: the resumed JAX train state did not reach step 4 with a finite loss")
    shutil.rmtree(d)
    say(f"  ({card}) phase 11: reader {out['read_mb_s']:.1f} MB/s")
    return out


def card_phase(hk, dev, counter, totals) -> dict:
    """Phase 3: the whole UNet on the card against the CPU, the tiny
    engine, and the edit gate."""
    from ishapediting_tpu_torch.config import UNetConfig, preset

    say("[3] UNet on the card (kernels) against the CPU (plain versions), small input; "
        "the edit gate")
    unet_card_check(hk, dev, UNetConfig(**MINI_BF16, dropout=0.0), 3e-2, "bf16 torso, head dim 64")
    unet_card_check(hk, dev, preset("tiny").unet, 1e-4, "tiny preset: fp32 torso, head dim 8")
    tiny = preset("tiny")
    tiny_fwd = calls_per_forward(tiny.unet)
    say(f"  tiny per UNet forward: {tiny_fwd[0]} GroupNorm-SiLU calls, {tiny_fwd[1]} attention "
        f"calls ({hk.attention_route(tiny.unet.torch_compute_dtype, tiny.unet.num_head_channels)})")
    run_engine(hk, counter, tiny_fwd, totals, tiny, "preset('tiny')", "tiny engine",
               attn_kernel="attention_generic")
    return edit_gate_on_card(hk, counter, totals)


def main_path(hk, counter, totals, keep=False) -> dict:
    """Phase 4: the main path at the published chairs width."""
    from ishapediting_tpu_torch.config import preset

    say("[4] main path, published chairs config at full width, random weights "
        "(step counts cut: 10/10/20-step sampling, w_time 10, fit 3 steps, cli.edit 200 "
        "generation + 10 guided steps; widths and the 256^3 grid as published)")
    chairs = preset("chairs", 20)
    per_fwd = calls_per_forward(chairs.unet)
    say(f"  per UNet forward: {per_fwd[0]} GroupNorm-SiLU calls, {per_fwd[1]} attention calls")
    ddim_s, _ = run_cli(hk, counter, per_fwd, totals, "--use_ddim", "ddim", keep=keep)
    run_cli(hk, counter, per_fwd, totals, "--use_dpm", "dpm", decode=False)
    chairs = dataclasses.replace(chairs, edit=dataclasses.replace(
        chairs.edit, w_time=10, feat_layer=8, shape_resolution=256))
    engine, lat, gen_wall = run_engine(hk, counter, per_fwd, totals, chairs,
                                       "preset('chairs', 20), w_time=10, feat_layer=8")
    first_mesh = engine.mesh0
    edits = chairs_edit_runs(hk, counter, per_fwd, totals, engine, lat)
    say(f"  seed -> edited mesh on the engine: {gen_wall + edits['drag_resample_walls']['total_s']:.1f} s "
        f"(20-step generation with its 256^3 mesh, then a 10-step drag with its 256^3 mesh)")
    edits["cli_edit_wall_s"] = run_cli_edit(hk, counter, per_fwd, totals, keep=keep)
    return dict(chairs=chairs, per_fwd=per_fwd, ddim_s=ddim_s, engine=engine, lat=lat,
                first_mesh=first_mesh, edits=edits)


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Drive the port once on one CUDA card")
    parser.add_argument("--phases", type=str, default="2,3,4,5,6,7,8,9,10,11",
                        help="phases to run after the build (a partial run prints no result line)")
    parser.add_argument("--rank-worker", type=str, default=None,
                        help="run as one rank of phase 9 (torchrun starts these), writing into this dir")
    parser.add_argument("--tp-worker", type=str, default=None,
                        help="run as one rank of phase 10 (torchrun starts these), writing into this dir")
    parser.add_argument("--dist_backend", type=str, default="gloo",
                        help="phases 9 and 10's process-group backend (ranks sharing one card need gloo)")
    args = parser.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "ishapediting_tpu_torch")):
        fail("the port's package ishapediting_tpu_torch/ is not beside this script")
    sys.path.insert(0, ROOT)
    global DECODER
    DECODER = DecoderCounter()
    if args.rank_worker:
        rank_worker(args.rank_worker, args.dist_backend)
        return
    if args.tp_worker:
        tp_worker(args.tp_worker, args.dist_backend)
        return
    phases = {int(p) for p in args.phases.split(",")}
    if 5 in phases and 4 not in phases:
        parser.error("phase 5 runs on phase 4's engine")
    watchdog()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs one CUDA card")
    from ishapediting_tpu_torch import native
    from ishapediting_tpu_torch.models.unet import UNetModel
    from ishapediting_tpu_torch.ops import hopper_kernels as hk
    from ishapediting_tpu_torch.utils.device import set_cuda_flags

    card = card_line()
    dev = torch.device("cuda")
    say(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    say("[1] build")
    t0 = time.perf_counter()
    native_err = []
    nt = threading.Thread(target=lambda: _capture(native.build_native, native_err))
    nt.start()
    try:
        lib = hk.build_kernels()
    except Exception as e:  # noqa: BLE001 - reported, then fatal
        fail(f"kernel build: {e}")
    nt.join()
    if native_err:
        fail(f"native build: {native_err[0]}")
    say(f"  built {os.path.relpath(lib, ROOT)} and the native library in "
        f"{time.perf_counter() - t0:.1f} s")
    set_cuda_flags()
    os.makedirs(WORK, exist_ok=True)
    for kept in (KEPT_TRIPLANES, KEPT_EDIT, KEPT_MODELS):
        shutil.rmtree(kept, ignore_errors=True)

    starts = {"1": 0.0}

    def begin(phase):
        """Note when a phase starts, so that the run's time can be read per phase."""
        starts[phase] = time.perf_counter() - t_start
        say(f"  (phase {phase} starts {starts[phase]:.1f} s into the run)")

    def phase_walls():
        marks = sorted(starts.items(), key=lambda kv: kv[1]) + [("end", time.perf_counter() - t_start)]
        return {a[0]: round(b[1] - a[1], 1) for a, b in zip(marks, marks[1:])}

    report = {}
    if 2 in phases:
        begin("2")
        report = kernel_checks(hk, dev)
        backward_checks(hk, dev, report)
        epilogue_checks(hk, dev, report)
    counter = ForwardCounter(UNetModel)
    totals: dict = {}
    if 3 in phases:
        begin("3")
        gate = card_phase(hk, dev, counter, totals)
    if 4 in phases:
        begin("4")
        mp = main_path(hk, counter, totals, keep=8 in phases)
        engine, lat, edits = mp["engine"], mp["lat"], mp["edits"]
    if 5 in phases:
        begin("5")
        say("[5] serving surfaces on the chairs engine (direct fit, morph, cli.morph, cli.batch_edit, "
            "batched drag with and without remat, batched fit, cli.serve)")
        serving = serving_runs(hk, counter, mp["per_fwd"], totals, engine, mp["first_mesh"], card)
    if 6 in phases:
        begin("6")
        say("[6] heads-by-count UNet (UNetConfig.from_reference_args(num_head_channels=-1)) at chairs "
            "width: DDIM-10 at batch 2, update_latent_params, a 2-step drag")
        hbc = heads_by_count_runs(hk, counter, totals)
    if 7 in phases:
        begin("7")
        say("[7] training: a train step card against CPU, remat against no remat, decoder training, "
            "cli.train at chairs width (batch 8, checkpoint, resume, export) -> serve, an overfit")
        training = training_runs(hk, counter, totals, card, keep=8 in phases)
    if 8 in phases:
        begin("8")
        say("[8] the remaining CLIs and host modules: cli.decode (card against CPU at 128^3, then 256^3), "
            "cli.eval on cli.edit's two 256^3 meshes, the solver sweep (chairs, then cli.eval "
            "--solver_sweep tiny), the headless GUI over DragEngine (create, pick, drag, save)")
        host = host_module_runs(hk, counter, totals, mp if 4 in phases else None)
    if 9 in phases or 10 in phases:
        begin("9-10 reference")
        say("[9-10] the one-rank reference of phases 9 and 10")
        ref = signal_reference(totals, train=10 in phases)
    if 9 in phases:
        begin("9")
        say(f"[9] {RANKS} ranks sharing the card over gloo (one torchrun launch): cli.generate DDIM-10 at "
            "chairs width with --sharded_decode, decode_grid_sharded at 256^3, the data-parallel train step, "
            "the tiny batched drag and morph over the ranks")
        ranks = ranks_phase(totals, card, ref)
    if 10 in phases:
        begin("10")
        say(f"[10] {RANKS} ranks sharing the card over gloo (one torchrun launch): the chairs UNet cut over "
            "the model axis (forward, DDIM-10), the fp32 miniature's guidance gradient and drag, "
            "decode_grid_sharded over the 2-D mesh, cli.serve over the ranks, two train steps of the cut UNet, "
            "the miniature's cut train step and checkpoint")
        model_axis = tp_phase(totals, card, ref)
    shutil.rmtree(SIGNAL_DIR, ignore_errors=True)
    if 11 in phases:
        begin("11")
        say("[11] the JAX package's orbax checkpoints on the card: the committed tiny model dir (every leaf "
            "against its hash, DDIM-10 against JAX's latents, cli.decode --model_dir) and train resumed "
            "from its train state")
        orbax = orbax_phase(hk, counter, totals, card)
    counter.close()
    if phases != {2, 3, 4, 5, 6, 7, 8, 9, 10, 11}:
        say(f"phase walls (s): {json.dumps(phase_walls())}")
        say(f"partial run (phases {sorted(phases)}): total {time.perf_counter() - t_start:.1f} s; "
            f"launches {totals}; no result line")
        return
    begin("4 (end): march comparison and accounting")
    edits["march"] = march_compare(engine, lat)
    per_forward = forward_accounting(engine)
    fwd_ms = {b: unet_forward_ms(engine, b) for b in (1, 2)}
    steady_s = ddim_steady_s(engine)
    ddim_s = mp["ddim_s"]
    say(f"  chairs UNet forward (steady state, CUDA events): batch 1 {fwd_ms[1]:.2f} ms, "
        f"batch 2 {fwd_ms[2]:.2f} ms; DDIM-10 at batch 2: {2 / ddim_s:.3f} samples/s in the "
        f"CLI run (first run: cuDNN algorithm timing included), {2 / steady_s:.3f} samples/s "
        f"steady state")
    say(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    kernels = []
    for name in SOURCES:
        r = report[name]
        if totals.get(name, 0) <= 0:
            fail(f"{name} was not launched by the main-path runs")
        kernels.append(dict(
            name=name, route="cuda", source=r.get("source", SOURCES[name]), replaces=TPU_KERNELS[name],
            launches=totals[name], max_abs_err=r["max_abs_err"], tol=r["tol"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"], shape=r["shape"],
            shapes=r["shapes"], per_forward={b: per_forward[b][name] for b in per_forward},
            per_forward_heads_by_count={b: hbc["per_forward"][b][name] for b in hbc["per_forward"]},
            backward_rel_err=r["backward_rel_err"],
            **({"kernel_route": r["kernel_route"]} if "kernel_route" in r else {}),
        ))
    say("edit path: " + json.dumps({"gate": gate, **edits}, default=float))
    say("serving: " + json.dumps(serving, default=float))
    say("heads-by-count: " + json.dumps({k: v for k, v in hbc.items() if k != "per_forward"},
                                        default=float))
    say("training: " + json.dumps(training, default=float))
    say("host modules: " + json.dumps(host, default=float))
    say("ranks: " + json.dumps(ranks, default=float))
    say("model axis: " + json.dumps(model_axis, default=float))
    say("orbax: " + json.dumps(orbax, default=float))
    say(f"phase walls (s): {json.dumps(phase_walls())}")
    say(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


def _capture(fn, errors):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - handed to the main thread
        errors.append(e)


if __name__ == "__main__":
    main()
