#!/usr/bin/env python3
"""Drive the PyTorch port's generation, editing and serving paths once on
one NVIDIA card.

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
   pass: gradients through each kernel's autograd Function (kernel forward,
   plain recompute backward) against autograd through the plain
   composition, at every chairs input at batch 1 and at the fp32 UNets'
   inputs;
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
   at batch 2, 256^3 meshes; then ``DragEngine.update_latent_params`` on a
   20-step chain (w_time 10) with its guidance-feature cache and its 256^3
   mesh (marched on the card); then the editing path on that engine: a
   resample drag over the whole w_time walk, ``latent_inversion`` of the
   generated latent, a replay drag, ``fit_real_shape`` of the first mesh
   (3 guided steps, twice: the second call runs without cuDNN's timing of
   new shapes); then ``cli.edit`` (200-step generation, a 10-step fast
   drag, two 256^3 meshes); then device marching against host marching on
   one 256^3 grid; then each kernel's device ms, launches and summed bound
   per chairs forward at batch 1 and 2
   (``tools/profile_unet.py::kernel_accounting``);
   in every run of phases 3 to 7 the launch counters are reset just before
   it and read just after it, and each must equal the UNet forwards of that
   run times the kernel's calls per forward (a drag or fit step is one
   forward; its backward recomputes through the plain versions and launches
   nothing, but under remat it runs the blocks the loss reaches a second
   time, ``models/unet.py::kernel_calls_recomputed`` per step; chairs runs
   launch no generic attention, the fp32 runs no wgmma attention);
5. the serving surfaces on the same chairs engine: ``fit_real_shape_direct``
   of the first 256^3 mesh at the published ``FitConfig`` (its loss must
   fall), ``morph`` of two ``sample_latent``s at 3 frames, ``cli.morph``,
   ``cli.batch_edit`` on 2 seeds (batched generation, inversion, replay
   drag, four 256^3 meshes), ``drag_edit_batched`` on its records without
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
   width, batch 8 (4 steps, a checkpoint, the checkpoint held to the state,
   a resume to step 6, ``--export_model_dir`` with the trained decoder),
   the export served by ``DragEngine.from_model_dir`` (a 20-step
   ``update_latent_params``); a bf16 miniature overfitting 4 latents in 30
   steps; train s/step (first and steady), peak memory, checkpoint bytes
   and save/load seconds and decoder s/step printed; every train step
   launches the forward's kernels and, under remat, every block's again
   (141/141/32 per chairs step, exact);
8. print the ``{"kernels": [...]}`` line, the card's name and power limit,
   and as the last line ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA card is present or when the
port's package is not beside this script.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")
TIME_LIMIT_S = 1100  # the run must end well inside 1200 s, build included

TPU_KERNELS = {
    "gn_stats": "ishapediting_tpu/ops/pallas_kernels.py:109",
    "gn_norm": "ishapediting_tpu/ops/pallas_kernels.py:126",
    "attention": "ishapediting_tpu/ops/pallas_kernels.py:259",
    "attention_generic": "ishapediting_tpu/ops/pallas_kernels.py:259",
}
SOURCES = {
    "gn_stats": "ishapediting_tpu_torch/csrc/groupnorm_silu.cu",
    "gn_norm": "ishapediting_tpu_torch/csrc/groupnorm_silu.cu",
    "attention": "ishapediting_tpu_torch/csrc/attention.cu",
    "attention_generic": "ishapediting_tpu_torch/csrc/attention_generic.cu",
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

    # Backward through the autograd.Function (plain recompute) at a small shape.
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


def backward_checks(hk, dev, report) -> None:
    from ishapediting_tpu_torch.ops.attention import dense_qkv_attention

    say("[2] backward: autograd through each kernel's Function (kernel forward, plain "
        "recompute) against autograd through the plain composition, batch 1")
    gen = torch.Generator(device=dev).manual_seed(1)
    worst = {"gn": 0.0, "attention": 0.0, "attention_generic": 0.0}
    cases = [(h, w, c, dt) for h, w, c, dt in CHAIRS_GN] + [(h, w, c, FP32) for h, w, c in FP32_GN]
    for h, w, c, dtype in cases:
        x, scale, bias, f = gn_inputs(gen, (1, h, w, c), dtype, True, dev)
        err = grad_rel_err(lambda a, s, b, f1, f2: hk.groupnorm_silu(a, s, b, film=(f1, f2)),
                           lambda a, s, b, f1, f2: hk.groupnorm_silu_plain(a, s, b, film=(f1, f2)),
                           (x, scale, bias, *f), seed=c)
        worst["gn"] = max(worst["gn"], err)
        if not err <= GRAD_TOL[dtype]:
            fail(f"groupnorm_silu gradient at [1,{h},{w},{c}] {dtype}: relative error {err:.2e}")
    say(f"  groupnorm_silu, {len(cases)} inputs (21 chairs, {len(FP32_GN)} fp32 UNet): "
        f"largest relative gradient error {worst['gn']:.2e} (tol 1e-2 bf16, 1e-5 fp32) ok")
    for (t, heads, ch), dtype in ([(a, BF16) for a in CHAIRS_ATTN + HEADS_BY_COUNT_ATTN]
                                  + [(a, FP32) for a in FP32_ATTN]):
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
    report["gn_stats"]["backward_rel_err"] = report["gn_norm"]["backward_rel_err"] = worst["gn"]
    report["attention"]["backward_rel_err"] = worst["attention"]
    report["attention_generic"]["backward_rel_err"] = worst["attention_generic"]


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
    from ishapediting_tpu_torch.models.unet import kernel_calls_per_forward

    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(5)
    model = signal_model(cfg, gen).eval()
    x = torch.randn((2, cfg.image_size, cfg.image_size, cfg.in_channels), generator=gen)
    t = torch.tensor([3, 700])
    with torch.no_grad():
        out_c, feat_c = model(x, t, feat_layer=1)
        model.to(dev)
        hk.reset_launch_counts()
        out_g, feat_g = model(x.to(dev), t.to(dev), feat_layer=1)
    torch.cuda.synchronize()
    gn, attn = kernel_calls_per_forward(cfg)
    want = {"gn_stats": gn, "gn_norm": gn, "attention": 0, "attention_generic": 0}
    want[hk.attention_route(cfg.torch_compute_dtype, cfg.num_head_channels)] = attn
    say(f"  {what}: launches {dict(hk.LAUNCHES)} (want {want})")
    if dict(hk.LAUNCHES) != want:
        fail(f"UNet ({what}) launches {dict(hk.LAUNCHES)} are not {want}")
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
    from ishapediting_tpu_torch.models.unet import kernel_calls_per_forward

    engine, asset = engine_from_asset(device=device)
    per = kernel_calls_per_forward(engine.config.unet)
    route = hk.attention_route(engine.config.unet.torch_compute_dtype,
                               engine.config.unet.num_head_channels)
    say("  edit gate (tests/assets/edit_gate.npz, toy fp32 UNet 16x16x24, w_time 12): "
        "inversion with the recorded noises, scale-0 and guided replay drags, chunk 4")
    sync()
    hk.reset_launch_counts()
    counter.n = 0
    t0 = time.perf_counter()
    base, guided, original, edited = gate_drags(engine, asset)
    sync()
    wall = time.perf_counter() - t0
    check_counts(hk, "edit gate", counter.n, per, totals, route)
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


def check_counts(hk, phase, forwards, per_fwd, totals, attn_kernel="attention", again=(0, 0), steps=0):
    """Launches of the run just made: each GroupNorm-SiLU call launches
    gn_stats and gn_norm, each attention call ``attn_kernel`` only; under
    remat, each of ``steps`` backward passes also recomputes ``again``
    (GroupNorm-SiLU, attention) calls. Without remat a backward launches
    nothing."""
    gn, attn = per_fwd
    want = {"gn_stats": gn * forwards + again[0] * steps, "gn_norm": gn * forwards + again[0] * steps,
            "attention": 0, "attention_generic": 0}
    want[attn_kernel] = attn * forwards + again[1] * steps
    got = dict(hk.LAUNCHES)
    extra = f", of which {again[0] * steps}/{again[0] * steps}/{again[1] * steps} recomputed" if steps else ""
    say(f"  launches in {phase}: {got} for {forwards} UNet forwards{extra} (want {want})")
    if forwards <= 0 or got != want:
        fail(f"{phase}: launch counts {got} are not {want}")
    for k, v in got.items():
        totals[k] = totals.get(k, 0) + v


def run_cli(hk, counter, per_fwd, totals, sampler_flag, phase,
            preset_name="chairs", device="cuda", res=256):
    import numpy as np

    from ishapediting_tpu_torch.cli.generate import main as generate
    from ishapediting_tpu_torch.config import preset

    h, w, c = preset(preset_name).latent_shape
    out = os.path.join(WORK, phase)
    shutil.rmtree(out, ignore_errors=True)
    argv = ["--random_init", "--preset", preset_name, sampler_flag, "--num_steps", "10",
            "--num_samples", "2", "--batch_size", "2", "--shape_resolution", str(res),
            "--save_dir", out, "--seed", "0", "--device", device]
    say(f"  python -m ishapediting_tpu_torch.cli.generate {' '.join(argv)}")
    buf = io.StringIO()
    sync()
    hk.reset_launch_counts()
    counter.n = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        samples = generate(argv)
    sync()
    wall = time.perf_counter() - t0
    check_counts(hk, phase, counter.n, per_fwd, totals)
    log = buf.getvalue()
    sample_s = float(next(l for l in log.splitlines() if l.startswith("ddpm time:")).split(":")[1])
    decode_s = float(next(l for l in log.splitlines() if l.startswith("decode time:")).split(":")[1])
    if samples.shape != (2, h, w, c) or not np.isfinite(samples).all():
        fail(f"{phase}: latents {samples.shape} not finite or of the wrong shape")
    for i in range(2):
        tri = np.load(os.path.join(out, "triplanes", f"{i}.npy"))
        obj = os.path.join(out, "objects", f"{i}.obj")
        if tri.shape != (c, h, w) or not np.isfinite(tri).all():
            fail(f"{phase}: triplane {i} has shape {tri.shape} or is not finite")
        if not os.path.exists(obj) or os.path.getsize(obj) == 0:
            fail(f"{phase}: mesh {i} is missing or empty")
    size_mb = sum(os.path.getsize(os.path.join(out, "objects", f"{i}.obj")) for i in range(2)) / 1e6
    shutil.rmtree(out)  # the 256^3 meshes of random weights are large
    say(f"  {phase}: sampling {sample_s:.3f} s for 2 samples ({2 / sample_s:.3f} samples/s, "
        f"first run, launch overheads included), decode+mesh+write {decode_s:.3f} s, "
        f"OBJ {size_mb:.0f} MB, wall {wall:.1f} s")
    return sample_s


def run_engine(hk, counter, per_fwd, totals, cfg, label, phase="engine",
               attn_kernel="attention", device="cuda"):
    import numpy as np

    from ishapediting_tpu_torch.edit.engine import DragEngine

    res = cfg.edit.shape_resolution
    say(f"  DragEngine({label}).update_latent_params(seed=0) -> get_mesh at {res}^3")
    engine = DragEngine(cfg, seed=0, device=device)
    sync()
    hk.reset_launch_counts()
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
    launching its calls per forward (plus ``recompute``, as
    ``check_counts`` takes it). Returns (fn's result, wall s, peak device
    GiB of the run)."""
    sync()
    hk.reset_launch_counts()
    counter.n = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    sync()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    if counter.n != forwards:
        fail(f"{phase}: {counter.n} UNet forwards, expected {forwards}")
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
        mesh, wall, _ = counted(hk, counter, per_fwd, totals, f"drag {mode}", lambda: drag(mode), w_time)
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
    for run in ("first", "second"):
        shutil.rmtree(fit_dir, ignore_errors=True)
        say(f"  DragEngine.fit_real_shape of the first generated mesh ({len(first_mesh.triangles)} "
            f"triangles), fit_steps {fit_steps}, {engine.config.fit.points_size} points, batch "
            f"{engine.config.fit.batch_points} ({run} call)")
        _, wall, _ = counted(hk, counter, per_fwd, totals, f"fit ({run} call)",
                          lambda: engine.fit_real_shape(mesh=first_mesh, path=fit_dir, seed=0,
                                                        fit_steps=fit_steps),
                          fit_steps + -(-w_time // engine.config.edit.inversion_chunk))
        h, w, c = engine.config.latent_shape
        tri = np.load(os.path.join(fit_dir, "tri_feat.npy"))
        recon = os.path.join(fit_dir, "mesh_recon.obj")
        if tri.shape != (1, c, h, w) or not np.isfinite(tri).all() or os.path.getsize(recon) == 0:
            fail("fit: tri_feat.npy or mesh_recon.obj not as expected")
        check_mesh("fit", engine.mesh0, engine.last_mesh_walls)
        walls = engine.last_phase_walls
        out[f"fit_{run}_s_per_step"] = walls["guided_s"] / fit_steps
        out[f"fit_{run}_walls"] = dict(walls)
        say(f"  fit ({run} call): {walls['guided_s'] / fit_steps:.4f} s/step over {fit_steps} guided "
            f"steps{' (cuDNN timing the backward shapes of the head included)' if run == 'first' else ''}, "
            f"inversion {walls['inversion_device_s']:.3f} s, phase walls {fmt_walls(walls)}, "
            f"wall {wall:.1f} s")
    shutil.rmtree(fit_dir)  # the 256^3 OBJ of random weights is large
    return out


def engine_steps(cfg) -> int:
    from ishapediting_tpu_torch.core.schedule import make_schedule

    d = cfg.diffusion
    return make_schedule(d.base_steps, d.noise_schedule, d.timestep_respacing).num_timesteps


def run_cli_edit(hk, counter, per_fwd, totals, preset_name="chairs", num_steps=200,
                 edit_steps=10, device="cuda") -> float:
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

    engine, wall, _ = counted(hk, counter, per_fwd, totals, "cli.edit", run,
                           engine_steps(cfg) + min(edit_steps, cfg.edit.w_time))
    for f in ("original.obj", "edit00.obj", "EditLog"):
        if not os.path.exists(os.path.join(out, f)) or os.path.getsize(os.path.join(out, f)) == 0:
            fail(f"cli.edit: {f} missing or empty")
    if not np.isfinite(engine.edited_latent).all():
        fail("cli.edit: edited latent not finite")
    size_mb = sum(os.path.getsize(os.path.join(out, f)) for f in ("original.obj", "edit00.obj")) / 1e6
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

    def sig(m):
        v, t = m.vertices, m.triangles
        area = 0.5 * np.linalg.norm(np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]]), axis=1)
        return np.concatenate([v[t].mean(axis=1), area[:, None]], axis=1)

    def interior_volume(m):
        v, t = m.vertices, m.triangles
        cen = (v[t].mean(axis=1) + 1.0) * res / 2.0  # voxel units
        vox = np.rint(cen)
        half = (np.abs(cen - np.floor(cen) - 0.5) < 1e-4).any(axis=1)  # fp32 centroid ties too
        keep = ((vox > 0) & (vox < res - 1)).all(axis=1) & ~half
        tk = t[keep]
        vol = float(np.einsum("ij,ij->", v[tk[:, 0]], np.cross(v[tk[:, 1]], v[tk[:, 2]]))) / 6.0
        full = float(np.einsum("ij,ij->", v[t[:, 0]], np.cross(v[t[:, 1]], v[t[:, 2]]))) / 6.0
        return vol, full, int((~keep).sum())

    def normals(m):
        v, t = m.vertices, m.triangles
        return np.cross(v[t[:, 1]] - v[t[:, 0]], v[t[:, 2]] - v[t[:, 0]])

    sd, sh = sig(dev), sig(host)
    nd, nh = normals(dev), normals(host)
    cen = (sd[:, :3] + 1.0) * res / 2.0  # voxel units
    same_rule = (((np.rint(cen) > 0) & (np.rint(cen) < res - 1)).all(axis=1)
                 & ~(np.abs(cen - np.floor(cen) - 0.5) < 1e-4).any(axis=1)  # fp32 ties too
                 & (np.linalg.norm(nd, axis=1) > 1e-12))
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
    vd, fd, bd = interior_volume(dev)
    vh, fh, bh = interior_volume(host)
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


def serving_runs(hk, counter, per_fwd, totals, engine, first_mesh, card) -> dict:
    """The serving surfaces at chairs width: the direct fit, morphing
    (engine and ``cli.morph``), ``cli.batch_edit`` and the batched drag
    (without and with remat, held to single-shape drags), the batched fit,
    and a scripted ``cli.serve`` session over a pipe."""
    from ishapediting_tpu_torch.cli.batch_edit import main as batch_main
    from ishapediting_tpu_torch.cli.morph import main as morph_main
    from ishapediting_tpu_torch.edit.batch import drag_edit_batched, fit_real_shapes_batched
    from ishapediting_tpu_torch.models.unet import kernel_calls_recomputed

    cfg = engine.config
    steps = engine.sched.num_timesteps
    w_time = cfg.edit.w_time
    out = {}

    # -- the direct fit (decoder only: no UNet forward, no launch) ----------
    fit_dir = os.path.join(WORK, "fit_direct")
    shutil.rmtree(fit_dir, ignore_errors=True)
    say(f"  DragEngine.fit_real_shape_direct of the first generated mesh ({len(first_mesh.triangles)} "
        f"triangles), published FitConfig: {cfg.fit.opt_epochs} epochs x "
        f"{cfg.fit.points_size // cfg.fit.batch_points} batches of {cfg.fit.batch_points} points")
    sync()
    hk.reset_launch_counts()
    counter.n = 0
    t0 = time.perf_counter()
    engine.fit_real_shape_direct(mesh=first_mesh, path=fit_dir, seed=0)
    wall = time.perf_counter() - t0
    say(f"  launches in direct fit: {dict(hk.LAUNCHES)} for {counter.n} UNet forwards (want none)")
    if counter.n or any(hk.LAUNCHES.values()):
        fail("direct fit: the decoder-only fit ran the UNet or launched a kernel")
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
    res, wall, peak = counted(hk, counter, per_fwd, totals, "cli.batch_edit", run_batch,
                              steps + -(-w_time // chunk) + w_time)
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
    again = kernel_calls_recomputed(cfg.unet, cfg.edit.feat_layer)
    say(f"  remat: each drag step's backward recomputes {again[0]} GroupNorm-SiLU and {again[1]} "
        f"attention calls (input and middle blocks, output blocks 0..{cfg.edit.feat_layer})")
    batched = {}
    for label, remat in (("plain", False), ("remat first", True), ("remat", True)):
        fn = lambda remat=remat: drag_edit_batched(  # noqa: E731
            beng.sched, beng.model_fn(feat=True, remat=remat), inv["w"], inv["features"], problems,
            w_time=w_time, scale=scale, cof=cof, noises=noises)
        kw = dict(again=again, steps=w_time) if remat else {}
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
            w_time)
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
        beng._generator(0), latent_shape=cfg.latent_shape, fit_cfg=cfg.fit), 3)
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
    th = threading.Thread(target=lambda: _capture(
        lambda: serve_loop(instream, Out(), EditServer(device="cuda")), errors), daemon=True)
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

    (walls, responses), total, _ = counted(hk, counter, per_fwd, totals, "cli.serve session", session,
                                           forwards)
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


def launches_per_forward(hk, ucfg) -> dict:
    """Each kernel's launches in one forward of a UNet of config ``ucfg``:
    two GroupNorm launches per GroupNorm-SiLU call, and each attention call
    on the kernel ``attention_route`` picks for its head dim."""
    from ishapediting_tpu_torch.models.unet import attention_head_dims, kernel_calls_per_forward

    gn, _ = kernel_calls_per_forward(ucfg)
    want = {"gn_stats": gn, "gn_norm": gn, "attention": 0, "attention_generic": 0}
    for ch in attention_head_dims(ucfg):
        want[hk.attention_route(ucfg.torch_compute_dtype, ch)] += 1
    return want


def counted_routes(hk, counter, totals, phase, fn, forwards, per):
    """Run ``fn`` with the launch counters and the forward counter set to 0
    just before and read just after: ``forwards`` UNet forwards, each
    launching ``per`` (a LAUNCHES-keyed dict). Returns (fn's result, wall s)."""
    sync()
    hk.reset_launch_counts()
    counter.n = 0
    t0 = time.perf_counter()
    out = fn()
    sync()
    wall = time.perf_counter() - t0
    got = dict(hk.LAUNCHES)
    want = {k: v * forwards for k, v in per.items()}
    say(f"  launches in {phase}: {got} for {counter.n} UNet forwards (want {want})")
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
    expected = {"gn_stats": 71, "gn_norm": 71, "attention": 5, "attention_generic": 11}
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
                                lambda: engine.drag_edit(*HANDLE, seed=0, chunk=1, edit_steps=2),
                                2, per)
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
    reaches the output, and the output head is not checkpointed). The
    kernels' backward recomputes the plain versions and launches nothing."""
    from ishapediting_tpu_torch.models.unet import attention_head_dims, kernel_calls_recomputed

    want = launches_per_forward(hk, ucfg)
    if remat:
        gn, _ = kernel_calls_recomputed(ucfg, -1, head=True)
        want["gn_stats"] += gn
        want["gn_norm"] += gn
        for ch in attention_head_dims(ucfg):
            want[hk.attention_route(ucfg.torch_compute_dtype, ch)] += 1
    return want


def check_launches(hk, phase, want, totals=None) -> None:
    """The launch counters against ``want``; the run's launches are added to
    ``totals`` unless it is None (a comparison with the plain versions)."""
    got = dict(hk.LAUNCHES)
    say(f"  launches in {phase}: {got} (want {want})")
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
        hk.reset_launch_counts()
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
        hk.reset_launch_counts()
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
    hk.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        dec, bank = train_decoder(batches, num_objs=1, steps=steps, resolution=128, channels=32,
                                  mapping=64, hidden=128, lr=3e-3, log_every=1000, device=device)
    sync()
    wall = time.perf_counter() - t0
    check_launches(hk, "decoder training", {k: 0 for k in hk.LAUNCHES})
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


def chairs_training(hk, counter, totals, decoder_pt, preset_name="chairs", device="cuda") -> dict:
    """``cli.train`` at the published chairs width (421M parameters, bf16
    torso, dropout 0.1, the 1000-step chain, AdamW lr 1e-4, clip 1.0, EMA
    0.9999, remat), batch 8 of synthetic 128x128x96 latents: 4 steps with a
    checkpoint at step 4, the checkpoint loaded and held to the state the
    run returned, a resume to step 6 with the export of a model dir, and that
    dir served by ``DragEngine.from_model_dir`` (a 20-step
    ``update_latent_params`` with a 64^3 mesh). Launches exact per step."""
    from ishapediting_tpu_torch.cli.train import main as train_main
    from ishapediting_tpu_torch.config import preset
    from ishapediting_tpu_torch.edit.engine import DragEngine
    from ishapediting_tpu_torch.io.checkpoint import load_train_state
    from ishapediting_tpu_torch.models.unet import UNetModel, kernel_calls_per_forward
    from ishapediting_tpu_torch.train.loop import latest_checkpoint
    from ishapediting_tpu_torch.train.trainer import init_train_state, make_optimizer

    chairs = preset(preset_name)
    per_step = train_step_launches(hk, chairs.unet)
    expected = {"gn_stats": 141, "gn_norm": 141, "attention": 32, "attention_generic": 0}
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
        hk.reset_launch_counts()
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
    out.update(first_step_s=gaps[0], steady_s=gaps[1:], run_wall_s=wall, peak_gib=peak,
               ckpt_bytes=nbytes, save_s=[save_s], loss_step0=loss0)
    say(f"  cli.train: 4 steps at batch 8, step 0 loss {loss0:.4f}; step s {[round(g, 3) for g in gaps]} "
        f"(first: cuDNN times the new shapes), peak device memory {peak:.2f} GiB; checkpoint step_4 "
        f"{nbytes / 1e9:.3f} GB saved in {save_s:.2f} s; wall {wall:.1f} s")

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
    say(f"  load_train_state(step_4): {load_s:.2f} s; params, EMA, Adam moments and step equal the "
        f"saved state: {same}")
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
    t0 = time.perf_counter()
    engine = DragEngine.from_model_dir(export, config=cfg, device=device)
    load_s = time.perf_counter() - t0
    if not all(torch.equal(v, state.ema_params[k]) for k, v in engine.unet.state_dict().items()):
        fail("the served UNet's weights are not the trained EMA")
    del state
    lat, wall, _ = counted(hk, counter, kernel_calls_per_forward(cfg.unet), totals,
                           "served update_latent_params", lambda: engine.update_latent_params(seed=0), 20)
    check_mesh("served update_latent_params", engine.mesh0, engine.last_mesh_walls)
    if lat.shape != (1,) + cfg.latent_shape or not np.isfinite(lat).all():
        fail("train -> serve: the served latent is not finite or of the wrong shape")
    say(f"  train -> serve: DragEngine.from_model_dir {load_s:.2f} s (EMA weights), "
        f"update_latent_params {wall:.2f} s (20 steps, 64^3 mesh), latent finite")
    out.update(serve_load_s=load_s, serve_update_latent_params_s=wall)
    for d in (ckpt, export):
        shutil.rmtree(d)
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
    hk.reset_launch_counts()
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


def training_runs(hk, counter, totals, card, device="cuda", preset_name="chairs") -> dict:
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
    out["chairs"] = chairs_training(hk, counter, totals, decoder_pt, preset_name, device)
    out["overfit"] = overfit_check(hk, counter, totals, device)
    c = out["chairs"]
    steady = float(np.mean(c["steady_s"]))
    say(f"  training on {card}: {preset_name} train step at batch 8 {c['first_step_s']:.2f} s first, "
        f"{steady:.3f} s steady ({8 / steady:.2f} samples/s), peak device memory {c['peak_gib']:.2f} GiB "
        f"with cuDNN's algorithm search, {c['resumed_peak_gib']:.2f} GiB in the resumed run, "
        f"checkpoint {c['ckpt_bytes'] / 1e9:.3f} GB saved in {c['save_s']} s, loaded in {c['load_s']} s; "
        f"decoder {out['decoder']['s_per_step'] * 1e3:.2f} ms/step")
    return out


def card_phase(hk, dev, counter, totals) -> dict:
    """Phase 3: the whole UNet on the card against the CPU, the tiny
    engine, and the edit gate."""
    from ishapediting_tpu_torch.config import UNetConfig, preset
    from ishapediting_tpu_torch.models.unet import kernel_calls_per_forward

    say("[3] UNet on the card (kernels) against the CPU (plain versions), small input; "
        "the edit gate")
    unet_card_check(hk, dev, UNetConfig(**MINI_BF16, dropout=0.0), 3e-2, "bf16 torso, head dim 64")
    unet_card_check(hk, dev, preset("tiny").unet, 1e-4, "tiny preset: fp32 torso, head dim 8")
    tiny = preset("tiny")
    tiny_fwd = kernel_calls_per_forward(tiny.unet)
    say(f"  tiny per UNet forward: {tiny_fwd[0]} GroupNorm-SiLU calls, {tiny_fwd[1]} attention "
        f"calls ({hk.attention_route(tiny.unet.torch_compute_dtype, tiny.unet.num_head_channels)})")
    run_engine(hk, counter, tiny_fwd, totals, tiny, "preset('tiny')", "tiny engine",
               attn_kernel="attention_generic")
    return edit_gate_on_card(hk, counter, totals)


def main_path(hk, counter, totals) -> dict:
    """Phase 4: the main path at the published chairs width."""
    from ishapediting_tpu_torch.config import preset
    from ishapediting_tpu_torch.models.unet import kernel_calls_per_forward

    say("[4] main path, published chairs config at full width, random weights "
        "(step counts cut: 10/10/20-step sampling, w_time 10, fit 3 steps, cli.edit 200 "
        "generation + 10 guided steps; widths and the 256^3 grid as published)")
    chairs = preset("chairs", 20)
    per_fwd = kernel_calls_per_forward(chairs.unet)
    say(f"  per UNet forward: {per_fwd[0]} GroupNorm-SiLU calls, {per_fwd[1]} attention calls")
    ddim_s = run_cli(hk, counter, per_fwd, totals, "--use_ddim", "ddim")
    run_cli(hk, counter, per_fwd, totals, "--use_dpm", "dpm")
    chairs = dataclasses.replace(chairs, edit=dataclasses.replace(
        chairs.edit, w_time=10, feat_layer=8, shape_resolution=256))
    engine, lat, gen_wall = run_engine(hk, counter, per_fwd, totals, chairs,
                                       "preset('chairs', 20), w_time=10, feat_layer=8")
    first_mesh = engine.mesh0
    edits = chairs_edit_runs(hk, counter, per_fwd, totals, engine, lat)
    say(f"  seed -> edited mesh on the engine: {gen_wall + edits['drag_resample_walls']['total_s']:.1f} s "
        f"(20-step generation with its 256^3 mesh, then a 10-step drag with its 256^3 mesh)")
    edits["cli_edit_wall_s"] = run_cli_edit(hk, counter, per_fwd, totals)
    return dict(chairs=chairs, per_fwd=per_fwd, ddim_s=ddim_s, engine=engine, lat=lat,
                first_mesh=first_mesh, edits=edits)


def main() -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Drive the port once on one CUDA card")
    parser.add_argument("--phases", type=str, default="2,3,4,5,6,7",
                        help="phases to run after the build (a partial run prints no result line)")
    phases = {int(p) for p in parser.parse_args().phases.split(",")}
    if 5 in phases and 4 not in phases:
        parser.error("phase 5 runs on phase 4's engine")
    watchdog()
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(ROOT, "ishapediting_tpu_torch")):
        fail("the port's package ishapediting_tpu_torch/ is not beside this script")
    sys.path.insert(0, ROOT)
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

    report = {}
    if 2 in phases:
        report = kernel_checks(hk, dev)
        backward_checks(hk, dev, report)
    counter = ForwardCounter(UNetModel)
    totals: dict = {}
    if 3 in phases:
        gate = card_phase(hk, dev, counter, totals)
    if 4 in phases:
        mp = main_path(hk, counter, totals)
        engine, lat, edits = mp["engine"], mp["lat"], mp["edits"]
    if 5 in phases:
        say("[5] serving surfaces on the chairs engine (direct fit, morph, cli.morph, cli.batch_edit, "
            "batched drag with and without remat, batched fit, cli.serve)")
        serving = serving_runs(hk, counter, mp["per_fwd"], totals, engine, mp["first_mesh"], card)
    if 6 in phases:
        say("[6] heads-by-count UNet (UNetConfig.from_reference_args(num_head_channels=-1)) at chairs "
            "width: DDIM-10 at batch 2, update_latent_params, a 2-step drag")
        hbc = heads_by_count_runs(hk, counter, totals)
    if 7 in phases:
        say("[7] training: a train step card against CPU, remat against no remat, decoder training, "
            "cli.train at chairs width (batch 8, checkpoint, resume, export) -> serve, an overfit")
        training = training_runs(hk, counter, totals, card)
    counter.close()
    if phases != {2, 3, 4, 5, 6, 7}:
        say(f"partial run (phases {sorted(phases)}): total {time.perf_counter() - t_start:.1f} s; "
            f"launches {totals}; no result line")
        return
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
    for name in ("gn_stats", "gn_norm", "attention", "attention_generic"):
        r = report[name]
        if totals.get(name, 0) <= 0:
            fail(f"{name} was not launched by the main-path runs")
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=TPU_KERNELS[name],
            launches=totals[name], max_abs_err=r["max_abs_err"], tol=r["tol"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"], shape=r["shape"],
            shapes=r["shapes"], per_forward={b: per_forward[b][name] for b in per_forward},
            per_forward_heads_by_count={b: hbc["per_forward"][b][name] for b in hbc["per_forward"]},
            backward_rel_err=r["backward_rel_err"],
        ))
    say("edit path: " + json.dumps({"gate": gate, **edits}, default=float))
    say("serving: " + json.dumps(serving, default=float))
    say("heads-by-count: " + json.dumps({k: v for k, v in hbc.items() if k != "per_forward"},
                                        default=float))
    say("training: " + json.dumps(training, default=float))
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
