#!/usr/bin/env python3
"""Drive the PyTorch port's generation path once on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout, one H100

Phases, each fatal on failure (exit code 1, no result line):

1. build the Hopper kernels (``ishapediting_tpu_torch/csrc``, nvcc) and the
   native meshing library (g++) from the checkout's sources into ``build/``;
2. hold every kernel against its plain PyTorch version at the main path's
   shapes and types (the generic attention kernel in fp32 at the chairs
   shapes and at the tiny preset's head dim 8, and in bf16 at head dim 8),
   and time kernel, plain version, the closest PyTorch library call, and
   the least time the card could take (``bound_ms``);
3. check the whole UNet on the card against the same module on the CPU
   (plain versions) on a small input: a bf16 torso at head dim 64 (the
   wgmma attention kernel), then the ``tiny`` preset (fp32 torso, head dim
   8: the generic attention kernel, ``gn_stats`` at one channel per group)
   to a relative L2 error of 1e-4; then the fp32 path end to end:
   ``DragEngine(preset("tiny"), device="cuda").update_latent_params``;
4. the main path at the published chairs width (421M parameters, bf16
   torso, random weights from a seed; only step counts are cut):
   ``cli.generate`` with DDIM and with DPM-Solver++(2M), 10 steps, 2 samples
   at batch 2, 256^3 meshes; then ``DragEngine.update_latent_params`` on a
   20-step chain with its guidance-feature cache and its 256^3 mesh; then
   each kernel's device ms, launches and summed bound per chairs forward at
   batch 1 and 2 (``tools/profile_unet.py::kernel_accounting``);
   in every run of phases 3 and 4 the launch counters are reset just before
   it and read just after it, and each must equal the UNet forwards of that
   run times the kernel's calls per forward (chairs runs launch no generic
   attention, the tiny run no wgmma attention);
5. print the ``{"kernels": [...]}`` line, the card's name and power limit,
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
        say(f"    gn_stats {s_ms:.4f} ms (bound {sb_ms:.4f}, torch.var_mean {s_lib}), "
            f"gn_norm {n_ms:.4f} ms (bound {nb_ms:.4f})")
        rows["gn_stats"].append(dict(shape=list(shape), dtype=dname, film=film, ms=s_ms,
                                     bound_ms=sb_ms, library_ms=s_lib))
        rows["gn_norm"].append(dict(shape=list(shape), dtype=dname, film=film, ms=n_ms,
                                    bound_ms=nb_ms, library_ms=None, both_ms=both_ms,
                                    both_library_ms=lib_ms))
        if "gn_stats" not in report:
            report["gn_stats"] = dict(
                shape=list(shape), dtype=dname, max_abs_err=err_s,
                tol="1e-4 + 1e-4|plain| on (count, mean, M2/count)", ms=s_ms,
                plain_ms=device_ms(lambda: hk.gn_stats_plain(x, g), 5),
                library_ms=s_lib, bound_ms=sb_ms, bound_by=sb_by,
            )
            report["gn_norm"] = dict(
                shape=list(shape), dtype=dname, max_abs_err=err_n, tol="1e-2 + 1e-2|plain|",
                ms=n_ms, plain_ms=device_ms(lambda: hk.gn_norm_plain(x, part, scale, bias, film=f), 5),
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
        rows["attention"].append(dict(shape=list(qkv.shape), heads=heads, ms=k_ms,
                                      bound_ms=b_ms, library_ms=lib_ms))
        if t == 1024:
            report["attention"] = dict(
                shape=list(qkv.shape), heads=heads, dtype="bfloat16", max_abs_err=err,
                tol="2e-2", ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by,
            )

    # The generic kernel: fp32 at the chairs shapes and at the tiny preset's
    # head dim 8, bf16 at head dim 8 (the dtypes and head dims the wgmma
    # kernel does not take). Bound: bytes, or fp32 FMA at 67 TFLOP/s.
    rows["attention_generic"] = []
    for t, heads, ch, dtype in ((1024, 8, 64, torch.float32), (256, 12, 64, torch.float32),
                                (64, 16, 64, torch.float32), (64, 4, 8, torch.float32),
                                (64, 4, 8, torch.bfloat16)):
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
        b_ms, b_by = bound_ms(nbytes(qkv, got), fp32_flops=4.0 * 2 * heads * t * t * ch)
        say(f"    kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, sdpa {lib_ms} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        rows["attention_generic"].append(dict(shape=list(qkv.shape), heads=heads, dtype=dname,
                                              ms=k_ms, bound_ms=b_ms, library_ms=lib_ms,
                                              plain_ms=p_ms, max_abs_err=err))
        if "attention_generic" not in report:
            report["attention_generic"] = dict(
                shape=list(qkv.shape), heads=heads, dtype=dname, max_abs_err=err,
                tol="1e-4 (fp32), 2e-2 (bf16)", ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by,
            )
    for name, r in rows.items():
        report[name]["shapes"] = r
    return report


# ---------------------------------------------------------------------------
# phase 3: the whole UNet, card against CPU, small input
# ---------------------------------------------------------------------------


def unet_card_check(hk, dev, cfg, tol, what):
    """One UNet forward on the card (kernels) against the same module on
    the CPU (plain versions), small input: relative L2 error of the output
    and the feature tap <= ``tol``, and the launch counts of one forward."""
    from ishapediting_tpu_torch.models.unet import UNetModel, init_unet_, kernel_calls_per_forward

    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(5)
    model = init_unet_(UNetModel(cfg), gen).eval()
    with torch.no_grad():  # give the zero modules signal, so every path carries it
        for p in model.parameters():
            if not p.any():
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
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


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------


class ForwardCounter:
    """Counts UNet forwards through a global module hook (no code change)."""

    def __init__(self, unet_cls):
        self.n = 0
        self._cls = unet_cls
        self._handle = torch.nn.modules.module.register_module_forward_pre_hook(self._hook)

    def _hook(self, mod, args):
        if isinstance(mod, self._cls):
            self.n += 1

    def close(self):
        self._handle.remove()


def check_counts(hk, phase, forwards, per_fwd, totals, attn_kernel="attention"):
    """Launches of the run just made: each GroupNorm-SiLU call launches
    gn_stats and gn_norm, each attention call ``attn_kernel`` only."""
    gn, attn = per_fwd
    want = {"gn_stats": gn * forwards, "gn_norm": gn * forwards, "attention": 0,
            "attention_generic": 0}
    want[attn_kernel] = attn * forwards
    got = dict(hk.LAUNCHES)
    say(f"  launches in {phase}: {got} for {forwards} UNet forwards (want {want})")
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
        f"mesh walls {json.dumps({k: round(v, 3) for k, v in walls.items()})}, wall {wall:.1f} s")
    if not ok:
        fail(f"{phase}: latent, guidance features or mesh not as expected")
    return engine


def unet_forward_ms(engine, batch):
    """Steady-state device time of one chairs UNet forward at ``batch``."""
    from ishapediting_tpu_torch.utils.device import cuda_ms

    shape = (batch,) + engine.config.latent_shape
    x = torch.randn(shape, device=engine.device)
    t = torch.full((batch,), 500, device=engine.device, dtype=torch.long)
    with torch.no_grad():
        return cuda_ms(lambda: engine.unet(x, t), 5)


def forward_accounting(engine) -> dict:
    """Each kernel's device ms, launches and summed bound per chairs forward
    at batch 1 and 2, with the shapes recorded during the forward."""
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
            say(f"  per chairs forward, batch {batch}: {name} {k['ms']:.4f} ms, "
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


def main() -> None:
    watchdog()
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(ROOT, "ishapediting_tpu_torch")):
        fail("the port's package ishapediting_tpu_torch/ is not beside this script")
    sys.path.insert(0, ROOT)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs one CUDA card")
    from ishapediting_tpu_torch import native
    from ishapediting_tpu_torch.models.unet import UNetModel, kernel_calls_per_forward
    from ishapediting_tpu_torch.config import UNetConfig, preset
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

    report = kernel_checks(hk, dev)
    say("[3] UNet on the card (kernels) against the CPU (plain versions), small input")
    unet_card_check(hk, dev, UNetConfig(
        image_size=16, in_channels=6, model_channels=64, out_channels=12, num_res_blocks=1,
        attention_ds=(2,), channel_mult=(1, 2), num_head_channels=64, dropout=0.0,
    ), 3e-2, "bf16 torso, head dim 64")
    unet_card_check(hk, dev, preset("tiny").unet, 1e-4, "tiny preset: fp32 torso, head dim 8")
    counter = ForwardCounter(UNetModel)
    totals: dict = {}
    tiny = preset("tiny")
    tiny_fwd = kernel_calls_per_forward(tiny.unet)
    say(f"  tiny per UNet forward: {tiny_fwd[0]} GroupNorm-SiLU calls, {tiny_fwd[1]} attention "
        f"calls ({hk.attention_route(tiny.unet.torch_compute_dtype, tiny.unet.num_head_channels)})")
    run_engine(hk, counter, tiny_fwd, totals, tiny, "preset('tiny')", "tiny engine",
               attn_kernel="attention_generic")

    say("[4] main path, published chairs config at full width, random weights "
        "(step counts cut to 10/10/20; widths as published)")
    chairs = preset("chairs", 20)
    per_fwd = kernel_calls_per_forward(chairs.unet)
    say(f"  per UNet forward: {per_fwd[0]} GroupNorm-SiLU calls, {per_fwd[1]} attention calls")
    ddim_s = run_cli(hk, counter, per_fwd, totals, "--use_ddim", "ddim")
    run_cli(hk, counter, per_fwd, totals, "--use_dpm", "dpm")
    chairs = dataclasses.replace(chairs, edit=dataclasses.replace(
        chairs.edit, w_time=10, feat_layer=8, shape_resolution=256))
    engine = run_engine(hk, counter, per_fwd, totals, chairs,
                        "preset('chairs', 20), w_time=10, feat_layer=8")
    counter.close()
    per_forward = forward_accounting(engine)
    fwd_ms = {b: unet_forward_ms(engine, b) for b in (1, 2)}
    steady_s = ddim_steady_s(engine)
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
        ))
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
