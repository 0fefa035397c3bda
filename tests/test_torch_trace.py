"""The port's spans (``utils/trace.py``) on the CPU: a span off costs no
profiler range and no CUDA call; under a profiler spans nest as ``ishape:``
ranges, with parent and root ids and self times; one miniature UNet forward
records each of its layers' calls; ``first_call`` fires once per signature
and leaves out the kernel build inside it; the sampler, the copy to the host
and the drag step record their spans; a kernel launch builds its record
only inside ``record_launches``.
"""

import ast
import dataclasses
import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ishapediting_tpu_torch.config import preset
from ishapediting_tpu_torch.core.schedule import make_schedule
from ishapediting_tpu_torch.edit import drag as tdrag
from ishapediting_tpu_torch.edit.features import regroup_features
from ishapediting_tpu_torch.models.unet import UNetModel, build_layout, kernel_calls_per_forward
from ishapediting_tpu_torch.ops import hopper_kernels as hk
from ishapediting_tpu_torch.parallel.sampling import sample_batches
from ishapediting_tpu_torch.utils import logger, trace

torch.set_num_threads(2)

CFG = preset("tiny")


@pytest.fixture(autouse=True)
def fresh_registry():
    trace.reset()
    yield
    trace.reset()


def _profiled(fn):
    p = profile(activities=[ProfilerActivity.CPU])
    p.start()
    try:
        fn()
    finally:
        p.stop()
    return p


def _tiny_unet(**changes):
    torch.manual_seed(0)
    return UNetModel(dataclasses.replace(CFG.unet, **changes)).eval().requires_grad_(False)


def _fail(*a, **k):
    raise AssertionError("called while no profiler records")


def test_a_span_off_opens_nothing(monkeypatch):
    """No profiler: every span is the one shared no-op context, and a UNet
    forward (its first call included, on the CPU) opens no profiler range,
    makes no CUDA call and records nothing but the set-up counter."""
    unet = _tiny_unet()
    x = torch.randn((2,) + CFG.latent_shape)
    monkeypatch.setattr(trace, "_Range", _fail)
    for name in ("Event", "is_initialized", "current_stream", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, _fail)
    assert trace.span("conv") is trace.span("unet")
    assert logger.trace_annotation is trace.span and logger.span is trace.span
    with torch.no_grad():
        unet(x, torch.tensor([1, 2]))
        unet(x, torch.tensor([3, 4]))
    assert trace.snapshot() == {} and trace.records() == []
    assert trace.setup_seconds()["first_call"] > 0


def test_spans_nest_in_the_profiler_trace(tmp_path):
    """Under a CPU profiler the spans are nested ``ishape:`` ranges of the
    exported trace; each record names its parent and its root (a span on a
    thread with none open there is a root of its own); self time is a span
    less its children."""

    def work():
        with trace.span("outer"):
            with trace.span("a"):
                torch.ones(64).sum()
            with trace.span("b"):
                with trace.span("c"):
                    torch.ones(64).cumsum(0)
                th = threading.Thread(target=lambda: trace.span("worker").__enter__().__exit__())
                th.start()
                th.join(timeout=30)
                assert not th.is_alive()
        with trace.span("second"):
            pass

    p = _profiled(work)
    path = str(tmp_path / "trace.json")
    p.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("name", "").startswith(trace.PREFIX)]
    iv = {e["name"][len(trace.PREFIX):]: (e["ts"], e["ts"] + e["dur"]) for e in events}
    assert {"outer", "a", "b", "c", "second"} <= set(iv)

    def inside(child, parent):
        return iv[parent][0] <= iv[child][0] and iv[child][1] <= iv[parent][1]

    assert inside("a", "outer") and inside("b", "outer") and inside("c", "b")
    assert not inside("c", "a") and not inside("second", "outer")
    rec = {r["name"]: r for r in trace.records()}
    outer = rec["outer"]["id"]
    assert rec["outer"]["parent"] is None and rec["outer"]["root"] == outer
    assert rec["a"]["parent"] == outer and rec["b"]["parent"] == outer and rec["c"]["parent"] == rec["b"]["id"]
    assert {rec[n]["root"] for n in "abc"} == {outer}
    for name in ("second", "worker"):
        assert rec[name]["parent"] is None and rec[name]["root"] == rec[name]["id"]
    snap = trace.snapshot()
    assert snap["outer"]["self_host_ms"] == pytest.approx(
        rec["outer"]["host_ms"] - rec["a"]["host_ms"] - rec["b"]["host_ms"])
    assert snap["b"]["self_host_ms"] == pytest.approx(rec["b"]["host_ms"] - rec["c"]["host_ms"])
    assert snap["c"]["self_host_ms"] == snap["c"]["host_ms"] > 0
    assert all(snap[n]["calls"] == 1 for n in ("outer", "a", "b", "c", "second", "worker"))


def _expected_calls(cfg, bf16: bool):
    lay = build_layout(cfg)
    layers = [l for b in lay.input_blocks for l in b] + list(lay.middle_block)
    layers += [l for b in lay.output_blocks for l in b]
    res = [l for l in layers if l.kind == "res"]
    attn = sum(l.kind == "attn" for l in layers)
    resampled = [l for l in layers if l.kind == "upsample" or l.updown != "none"
                 or (l.kind == "downsample" and not l.use_conv)]  # a strided conv is no resample
    convs = (sum(l.kind == "conv" for l in layers) + sum(2 + (l.in_ch != l.out_ch) for l in res)
             + sum(l.kind in ("downsample", "upsample") and l.use_conv for l in layers) + 1)
    linears = 2 + len(res) + 2 * attn
    gn, n_attn = kernel_calls_per_forward(cfg)
    # each ResBlock's last conv, its skip conv and each attention block's
    # projection add their biases in the block's fused epilogue (``residual``)
    fused = len(res) + sum(l.in_ch != l.out_ch for l in res) + attn
    return {"unet": 1, "conv": convs - 1 if bf16 else 0, "conv_fp32": 1 if bf16 else convs,
            "linear": linears, "weight_cast": convs + linears, "bias_add": convs + linears - fused,
            "gn_silu": gn, "attention": n_attn, "group_norm": attn, "residual": len(res) + attn,
            "concat": len(lay.output_blocks), "embed": 1, "resample": len(resampled)}


@pytest.mark.parametrize("changes", [{}, {"compute_dtype": "bfloat16", "resblock_updown": False}],
                         ids=["fp32_updown", "bf16_resample_layers"])
def test_one_forward_records_each_layer(changes):
    """One forward of a miniature UNet under a profiler: as many ``conv``
    (bf16; the fp32 head and an fp32 UNet's as ``conv_fp32``), ``linear``,
    ``gn_silu`` and ``attention`` spans, and of their neighbours, as its
    architecture has calls; every one a descendant of the ``unet`` span."""
    unet = _tiny_unet(**changes)
    x = torch.randn((2,) + CFG.latent_shape)
    with torch.no_grad():
        unet(x, torch.tensor([1, 2]))  # the first call, outside the profiler
        trace.reset()
        _profiled(lambda: unet(x, torch.tensor([3, 4])))
    snap = trace.snapshot()
    want = {k: v for k, v in _expected_calls(unet.config, "compute_dtype" in changes).items() if v}
    assert {k: v["calls"] for k, v in snap.items() if k != "act_cast"} == want
    assert snap["act_cast"]["calls"] == 2  # the torso's dtype in, the head's out
    recs = trace.records()
    root = next(r["id"] for r in recs if r["name"] == "unet")
    assert all(r["root"] == root for r in recs)


def test_first_call_fires_once_per_signature():
    """``first_call`` counts without a profiler, once per new (shape, dtype,
    device, feat_layer, remat, grad mode), not on a repeat."""
    unet = _tiny_unet()
    x = torch.randn((2,) + CFG.latent_shape)
    t = torch.tensor([1, 2])
    calls = [(True, lambda: unet(x, t)), (False, lambda: unet(x, t)),
             (True, lambda: unet(x, t, feat_layer=1)), (True, lambda: unet(x[:1], t[:1]))]
    with torch.no_grad():
        for new, call in calls:
            before = trace.setup_seconds()["first_call"]
            call()
            assert (trace.setup_seconds()["first_call"] > before) == new
    before = trace.setup_seconds()["first_call"]
    unet(x, t)  # grad mode on
    after = trace.setup_seconds()["first_call"]
    unet(x, t)
    assert before < after == trace.setup_seconds()["first_call"]
    assert trace.snapshot() == {}


def test_first_call_leaves_out_the_kernel_build_inside_it():
    """``setup_seconds``: a first call's wall seconds less the kernel build
    inside it; a build outside any first call counts to the build alone."""
    with trace.first_call(torch.device("cpu")):
        time.sleep(0.02)
        with trace.kernel_build():
            time.sleep(0.05)
    s = trace.setup_seconds()
    assert 0.02 <= s["first_call"] < 0.045 and s["kernel_build"] >= 0.05
    with trace.kernel_build():
        time.sleep(0.01)
    assert trace.setup_seconds()["first_call"] == s["first_call"]
    assert trace.setup_seconds()["kernel_build"] >= s["kernel_build"] + 0.01
    trace.reset()
    assert trace.setup_seconds() == {"first_call": 0.0, "kernel_build": 0.0}


def test_the_sampler_the_copy_and_the_drag_step_record_their_spans():
    """Sampling records a ``unet`` span per step, two ``sampler_step`` spans
    per step (the model output's posterior, then the update) and one
    ``to_host``; a drag step records ``drag_loss``, ``drag_backward`` (the
    backward's ``gn_silu_bwd`` and ``attn_bwd`` inside it) and
    ``drag_update``."""
    unet = _tiny_unet()
    d = CFG.diffusion
    sched = make_schedule(d.base_steps, d.noise_schedule, "3", rescale_timesteps=d.rescale_timesteps)
    _profiled(lambda: sample_batches(sched, lambda x, t: unet(x, t), num_samples=2, batch_size=2,
                                     latent_shape=CFG.latent_shape, device="cpu", seed=3, sampler="ddim"))
    snap = trace.snapshot()
    assert (snap["unet"]["calls"], snap["sampler_step"]["calls"], snap["to_host"]["calls"]) == (3, 6, 1)

    trace.reset()
    fl = CFG.edit.feat_layer
    model_fn = lambda x, t: unet(x, t, feat_layer=fl)  # noqa: E731
    x = torch.randn((1,) + CFG.latent_shape)
    with torch.no_grad():
        origin = regroup_features(unet(x, torch.tensor([2]), feat_layer=fl)[1])[0]
    rng = np.random.default_rng(3)
    src = rng.uniform(-0.6, 0.6, (2, 3)).astype(np.float32)
    problem = tdrag.build_drag_problem(src, src + 0.1, r1=2, voxel_size=2.0 / 32, feat_width=origin.shape[1])
    step = tdrag.make_drag_step(sched, model_fn, problem, scale=10.0, cof=0.3)
    _profiled(lambda: step(x, 2, origin, noise=torch.randn_like(x)))
    snap = trace.snapshot()
    for name in ("drag_loss", "drag_backward", "drag_update", "unet", "gn_silu_bwd", "attn_bwd"):
        assert snap[name]["calls"] >= 1, name
    recs = {r["id"]: r for r in trace.records()}
    backward = next(r["id"] for r in recs.values() if r["name"] == "drag_backward")
    assert all(r["parent"] == backward for r in recs.values() if r["name"] in ("gn_silu_bwd", "attn_bwd"))


def test_a_launch_builds_its_record_only_inside_record_launches():
    """Each ``_record`` call of the kernel module sits under ``if _records
    is not None``, so a launch outside ``record_launches`` sums no bytes."""
    path = hk.__file__
    with open(path) as f:
        tree = ast.parse(f.read())
    guarded, calls = set(), []
    for node in ast.walk(tree):
        if isinstance(node, ast.If) and ast.unparse(node.test) == "_records is not None":
            guarded |= {id(n) for n in ast.walk(node)}
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id == "_record":
            calls.append(node)
    assert len(calls) == 8
    assert all(id(c) in guarded for c in calls)
    with hk.record_launches() as recs:
        assert hk._records is recs
    assert hk._records is None and os.path.isfile(path)
