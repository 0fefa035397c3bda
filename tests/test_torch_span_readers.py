"""The benchmark's side of the port's spans, on the CPU: ``port_bench``'s
trace reduction gives its own spans the same device time, busy share and
launches when the trace also holds the program's ``ishape:`` ranges (filed
as a real CPU profile of ``span`` files them), and only the idle gaps'
labels can name them; a capture's profile is found from its reduced trace;
the span readers (``conv_roofline.gen``, ``weight_cast_ms.gen``,
``elementwise_ms.gen``, ``first_call_s.gen``) read a profile's events as
they should, each device activity counted once to the innermost range
holding its launch, 0.0 where the stretch ran UNet calls and no range of
their kind,
None where the cell is of another kind, ran nothing, or the program has no
counter; a context's configuration and batch are found from its counts;
``conv_calls`` counts the convolution part of ``flops.forward_flops`` and
what ``torch.utils.flop_counter`` counts as convolutions on a miniature
UNet.
"""

import json
import os
import sys

import pytest
import torch
from torch.autograd import DeviceType
from torch.utils.flop_counter import FlopCounterMode

from ishapediting_tpu_torch.config import preset
from ishapediting_tpu_torch.models.unet import UNetModel
from ishapediting_tpu_torch.utils import trace as program_trace
from port_bench import conv_calls, flops, spans
from port_bench import spec as spec_mod
from port_bench.peaks import bound_s
from port_bench.reference.unet import Arch, layout
from port_bench.trace import Capture, Trace
from port_bench.trace import span as bench_span

torch.set_num_threads(2)

CELL = "chairs-gen-b32"
READERS = ("conv_roofline.gen", "weight_cast_ms.gen", "elementwise_ms.gen", "first_call_s.gen")


def _ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _bench_events():
    """Two UNet calls of the benchmark's span, each launching a conv (from
    an aten op), a GroupNorm kernel (straight from the host, as a ctypes
    launch is) and an add, and a DDIM update after it outside the span."""
    ev = []
    for k, t0 in enumerate((0, 100)):
        ev += [_ev("user_annotation", "bench:unet", t0, 40),
               _ev("cpu_op", "aten::cudnn_convolution", t0 + 2, 5),
               _ev("cuda_runtime", "cudaLaunchKernel", t0 + 3, 1, corr=10 * k + 1),
               _ev("cuda_runtime", "cudaLaunchKernel", t0 + 12, 1, corr=10 * k + 2),
               _ev("cpu_op", "aten::add", t0 + 22, 5),
               _ev("cuda_runtime", "cudaLaunchKernel", t0 + 23, 1, corr=10 * k + 3),
               _ev("cpu_op", "aten::mul", t0 + 60, 4),
               _ev("cuda_runtime", "cudaLaunchKernel", t0 + 61, 1, corr=10 * k + 4),
               _ev("kernel", "sm90_xmma_fprop_bf16", t0 + 20, 20, corr=10 * k + 1),
               _ev("kernel", "gn_norm_kernel", t0 + 45, 5, corr=10 * k + 2),
               _ev("kernel", "vectorized_elementwise_kernel", t0 + 55, 6, corr=10 * k + 3),
               _ev("kernel", "vectorized_elementwise_kernel", t0 + 70, 3, corr=10 * k + 4)]
    return ev


def _program_cat() -> str:
    """The category a CPU profile's export gives the program's ranges."""
    p = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    with p:
        with program_trace.span("conv"):
            pass
    events = p.profiler.kineto_results.events()
    names = [e.name() for e in events]
    assert "ishape:conv" in names
    return "user_annotation" if events[names.index("ishape:conv")].is_user_annotation() else "cpu_op"


def _program_ranges(cat):
    ev = []
    for t0 in (0, 100):
        ev += [_ev(cat, "ishape:unet", t0 + 1, 38), _ev(cat, "ishape:conv", t0 + 1.5, 6.5),
               _ev(cat, "ishape:gn_silu", t0 + 11, 3), _ev(cat, "ishape:bias_add", t0 + 21, 7),
               _ev(cat, "ishape:sampler_step", t0 + 59, 7)]
    return ev


def test_program_ranges_move_nothing_of_the_benchmark_spans():
    """The program's ranges change no device time, busy share, window or
    launch count of the reduced trace; an idle gap keeps its length and its
    benchmark span, and names the program's range only where that is the
    innermost op around the launch (a kernel launched from no aten op)."""
    cat = _program_cat()
    plain, both = Trace(_bench_events()), Trace(_bench_events() + _program_ranges(cat))
    assert plain.device_ms(span="unet") == pytest.approx(0.062)
    assert both.device_ms(span="unet") == plain.device_ms(span="unet")
    assert both.device_ms(outside="unet") == plain.device_ms(outside="unet")
    assert (both.busy_s, both.window_s, both.launches) == (plain.busy_s, plain.window_s, plain.launches)
    assert both.breakdown()["device_ops"] == plain.breakdown()["device_ops"]
    renamed = "unet / ishape:gn_silu" if cat == "cpu_op" else "unet / ?"
    assert both.gaps == {(renamed if k == "unet / ?" else k): v for k, v in plain.gaps.items()}
    assert plain.gaps["unet / ?"] == pytest.approx(10e-6)  # 40-45 and 140-145


def test_a_capture_is_found_from_its_reduced_trace():
    """``program_events`` gives the profile's events of the capture reduced
    to a trace (the program's ranges among them), and nothing for a trace no
    capture reduced."""
    cap = Capture(cuda=False)
    cap.start()
    with bench_span("unet"):
        with program_trace.span("unet"):
            with program_trace.span("conv"):
                torch.ones(64).sum()
    cap.stop()
    t = cap.reduce()
    events = spans.program_events(t)
    iv = {e.name(): (e.start_ns(), e.end_ns()) for e in events if e.name().startswith("ishape:")}
    assert iv["ishape:unet"][0] <= iv["ishape:conv"][0] <= iv["ishape:conv"][1] <= iv["ishape:unet"][1]
    assert spans.device_ms_by_span(events) == {}  # no device here
    assert spans.program_events(Trace(_bench_events())) == []


class _K:
    """A profiler event: host (a range or a launch) or device."""

    def __init__(self, name, t0, dur, corr=0, device=False, annotation=False):
        self._v = (name, t0, dur, corr, device, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[1] + self._v[2]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return DeviceType.CUDA if self._v[4] else DeviceType.CPU

    def is_user_annotation(self):
        return self._v[5]


def _program_events(calls, ranges=True):
    """``calls`` forwards as a profile's events, device µs a call: conv 2400
    (bf16) and 1100 (the head), casts 110, bias adds 1000, residual adds 250,
    concatenations 160, the embedding's own 15 beside its dense layer's 5,
    GroupNorm-SiLU 900 launched straight from the host, and 17 in the
    ``unet`` range outside any leaf; one kernel with no launch record after
    the bias add (200, so the bias add's); the device's annotation range of
    the benchmark's span; ops numbered like the next launch (the profiler
    numbers ops and launches apart). Without ``ranges``, the same
    with no program range."""
    leaves = (("conv", 2400), ("conv_fp32", 1100), ("weight_cast", 110), ("bias_add", 1000), ("residual", 250),
              ("concat", 160), ("gn_silu", 900))
    ev, ops, corr, t = [], [], 0, 0

    def launch(us, at):
        nonlocal corr
        corr += 1
        ev.extend([_K("cudaLaunchKernel", at, 1, corr), _K("kernel", 10 ** 9 + at, us * 1000, corr, device=True)])
        ops.append(_K("aten::op", at - 1, 3, corr + 1))  # numbered like the next launch

    for _ in range(calls):
        ev.append(_K("bench:unet", 10 ** 9 + t, 10 ** 6, 999, device=True, annotation=True))
        if ranges:
            ev += [_K("ishape:unet", t, 10 ** 5), _K("ishape:embed", t + 10, 100), _K("ishape:linear", t + 20, 20)]
        launch(5, t + 30)  # the embedding's dense layer
        launch(15, t + 105)  # the embedding's own
        for k, (name, us) in enumerate(leaves):
            at = t + 1000 * (k + 1)
            if ranges:
                ev.append(_K("ishape:" + name, at, 500))
            launch(us, at + 100)
            if name == "bias_add":
                ev.append(_K("kernel", 10 ** 9 + at + 150, 200 * 1000, device=True))
        launch(17, t + 9000)
        t += 10 ** 5
    return ev + ops


def _conv_bound_ms():
    with open(os.path.join(spec_mod.HERE, "configs", "nfd_chairs.json")) as f:
        arch = Arch.from_config(json.load(f))
    return sum(c.bound_s for c in conv_calls.forward_convs(arch, 32)) * 1e3


def _ctx(kind="generate", steps=10):
    with open(os.path.join(spec_mod.HERE, "configs", "nfd_chairs.json")) as f:
        arch = Arch.from_config(json.load(f))
    t = Trace(_bench_events())
    t.calls = t.steps = steps
    return {"kind": kind, "trace": t, "flops_per_call": flops.forward_flops(arch, 32),
            "unit_calls": flops.forward_calls(arch, 32)}


@pytest.mark.parametrize("events,kind,steps,want", [
    (_program_events(10), "generate", 10, {"conv_roofline.gen": 100 * _conv_bound_ms() / 3.5,
                                           "weight_cast_ms.gen": 0.11, "elementwise_ms.gen": 1.2 + 0.25 + 0.16 + 0.015,
                                           "first_call_s.gen": 9.0}),
    (_program_events(10, ranges=False), "generate", 10, {"conv_roofline.gen": 0.0, "weight_cast_ms.gen": 0.0,
                                                         "elementwise_ms.gen": 0.0, "first_call_s.gen": 9.0}),
    (_program_events(10), "edit", 10, dict.fromkeys(READERS)),
    (_program_events(10), "generate", 0, {"conv_roofline.gen": None, "weight_cast_ms.gen": None,
                                          "elementwise_ms.gen": None, "first_call_s.gen": 9.0}),
], ids=["full", "program_without_ranges", "other_kind", "no_steps"])
def test_span_readers(monkeypatch, events, kind, steps, want):
    monkeypatch.setattr(spans, "program_events", lambda trace: events)
    monkeypatch.setattr(program_trace, "setup_seconds", lambda: {"first_call": 9.0, "kernel_build": 40.0})
    ctx = _ctx(kind, steps)
    got = {name: spec_mod.reader(name)(ctx) for name in want}
    assert got == pytest.approx(want)


def test_every_device_activity_counts_once_to_its_innermost_range():
    """The leaf spans and the ``unet`` range's own part add up to every
    activity launched inside the forward, each counted once."""
    ms = spans.device_ms_by_span(_program_events(2))
    assert ms == pytest.approx({"conv": 4.8, "conv_fp32": 2.2, "weight_cast": 0.22, "bias_add": 2.4, "residual": 0.5,
                                "concat": 0.32, "gn_silu": 1.8, "linear": 0.01, "embed": 0.03, "unet": 0.034})


def test_first_call_s_is_none_for_a_program_without_the_counter(monkeypatch):
    monkeypatch.setitem(sys.modules, "ishapediting_tpu_torch.utils.trace", None)
    assert spec_mod.reader("first_call_s.gen")(_ctx()) is None


@pytest.mark.parametrize("cell", ["chairs-gen-b32", "adm128-gen-b32"])
@pytest.mark.parametrize("batch", [1, 32])
def test_a_contexts_configuration_and_batch_are_found(cell, batch):
    arch = Arch.from_config(spec_mod.load(cell).config)
    ctx = {"flops_per_call": flops.forward_flops(arch, batch), "unit_calls": flops.forward_calls(arch, batch)}
    assert spans.arch_and_batch(ctx) == (arch, batch)
    ctx["flops_per_call"] *= 1.5
    assert spans.arch_and_batch(ctx) is None


def test_the_span_readers_are_declared_for_the_gen_cells():
    bench = spec_mod.load_json(os.path.join(spec_mod.ROOT, "BENCHMARK.json"))
    mine = {m["name"]: m for m in bench["per_layer"] if m["name"] in READERS}
    assert set(mine) == set(READERS)
    for name, m in mine.items():
        assert m["workloads"] == ["chairs-gen-b32", "adm128-gen-b32"]
        assert m["moves"] == ("setup_s" if name == "first_call_s.gen" else "gen_samples_per_s")
        assert m["source"] == ("program_counter" if name == "first_call_s.gen" else "device_trace")
        assert callable(spec_mod.reader(name))


def _conv_flops_in_forward(a: Arch) -> float:
    """``flops.forward_flops`` less its time embedding, the ResBlocks' dense
    layers and the attention products, per sample."""
    lay = layout(a)
    rest = 2.0 * a.model_channels * lay.emb_ch + 2.0 * lay.emb_ch ** 2
    for l in flops._layers(lay):
        if l.kind == "res":
            rest += flops._res_products(a, l, lay.emb_ch)["emb"]
        elif l.kind == "attn":
            rest += sum(flops._attn_products(l).values())
    return flops.forward_flops(a) - rest


@pytest.mark.parametrize("name", ["nfd_chairs", "adm_imagenet128"])
def test_conv_calls_sum_to_the_convolutions_of_forward_flops(name):
    with open(os.path.join(spec_mod.HERE, "configs", name + ".json")) as f:
        a = Arch.from_config(json.load(f))
    calls = conv_calls.forward_convs(a, 32)
    assert sum(c.tensor_flops for c in calls) == pytest.approx(32 * _conv_flops_in_forward(a), rel=1e-12)
    assert [c.op for c in calls].count("conv_fp32") == 1 and calls[-1].name == "out.2"
    head = calls[-1]
    assert head.nbytes == 4 * 32 * (a.image_size ** 2 * (layout(a).out_ch + a.out_channels)) + 4 * (
        a.out_channels * layout(a).out_ch * 9)
    assert all(c.bound_s == bound_s(c.nbytes, c.tensor_flops) for c in calls)


def test_conv_calls_equal_the_flop_counters_convolutions():
    cfg = preset("tiny").unet
    arch = Arch(image_size=cfg.image_size, in_channels=cfg.in_channels, model_channels=cfg.model_channels,
                out_channels=cfg.out_channels, num_res_blocks=cfg.num_res_blocks,
                attention_resolutions=tuple(cfg.image_size // d for d in cfg.attention_ds),
                channel_mult=cfg.channel_mult, num_heads=cfg.num_heads, num_head_channels=cfg.num_head_channels,
                num_heads_upsample=cfg.num_heads_upsample, use_scale_shift_norm=cfg.use_scale_shift_norm,
                resblock_updown=cfg.resblock_updown)
    unet = UNetModel(cfg).eval().requires_grad_(False)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        unet(torch.randn((3,) + (cfg.image_size, cfg.image_size, cfg.in_channels)), torch.tensor([1, 2, 3]))
    counted = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
    assert sum(c.tensor_flops for c in conv_calls.forward_convs(arch, 3)) == counted["aten.convolution"]
