"""Device time of the program's own spans in a traced stretch. The port marks
its ops with profiler ranges ``ishape:<name>``
(``ishapediting_tpu_torch/utils/trace.py``); here each device activity of
the capture goes to the innermost such range that holds its launch, as
``trace.py`` gives it to the innermost benchmark span. So a span's device
ms are its own, not its children's (the ``unet`` range keeps what no leaf
range inside it holds), on the device's clock: the host's pace moves none
of them.

The reduced trace (``trace.py::Trace``) keeps only the benchmark's spans, so
the ranges are read from the profile of the capture that was reduced to it:
its events, the ones the exported trace holds.

A reader returns None where the cell is of another kind or the stretch ran
no device work, and 0.0 where the stretch ran UNet calls but no range of its
kind (a program without spans, or one that took the op away).
"""

from __future__ import annotations

import gc
import glob
import json
import os
import weakref
from typing import Dict, Optional, Sequence, Tuple

from torch.autograd import DeviceType

from port_bench import conv_calls, flops
from port_bench.reference.unet import Arch
from port_bench.trace import Capture, _innermost

PREFIX = "ishape:"
CONV_SPANS = ("conv", "conv_fp32")
HERE = os.path.dirname(os.path.abspath(__file__))

_by_trace = weakref.WeakKeyDictionary()  # device ms by span, by reduced trace


def device_ms_by_span(events) -> Dict[str, float]:
    """Device ms of a profile's activities (``KinetoEvent``s) by the
    innermost ``ishape:`` range holding their launch: an activity is tied to
    the CUDA API call (``cu*``) that launched it by the profiler's
    correlation id, and one without such a call takes the range of the
    activity before it; activities in no range, and the device's annotation
    ranges, are left out."""
    host = [e for e in events if e.device_type() == DeviceType.CPU]
    dev = sorted((e for e in events if e.device_type() != DeviceType.CPU and not e.is_user_annotation()),
                 key=lambda e: e.start_ns())
    launched = {e.correlation_id(): e.start_ns() for e in host if e.name().startswith("cu")}
    ranges = [(e.start_ns(), e.end_ns(), e.name()[len(PREFIX):]) for e in host if e.name().startswith(PREFIX)]
    at = [launched.get(e.correlation_id()) for e in dev]
    known = [i for i, t in enumerate(at) if t is not None]
    label = dict(zip(known, _innermost(ranges, [at[i] for i in known])))
    out: Dict[str, float] = {}
    last = None
    for i, e in enumerate(dev):
        last = label[i] if i in label else last
        if last is not None:
            out[last] = out.get(last, 0.0) + e.duration_ns() / 1e6
    return out


def program_events(trace) -> list:
    """The profile of the capture reduced to ``trace`` (``Capture.prof``),
    as the profiler's events; none where no capture in the process holds
    it."""
    cap = next((o for o in gc.get_objects() if type(o) is Capture and o.trace is trace), None)
    return [] if cap is None else list(cap.prof.profiler.kineto_results.events())


def span_ms(trace) -> Dict[str, float]:
    """``device_ms_by_span`` of the stretch reduced to ``trace``, read once."""
    if trace not in _by_trace:
        _by_trace[trace] = device_ms_by_span(program_events(trace))
    return _by_trace[trace]


def _ok(ctx, kind: str) -> bool:
    return ctx.get("kind") == kind and ctx["trace"].steps > 0 and bool(ctx["trace"].events)


def ms_per_step(ctx, kind: str, names: Sequence[str]) -> Optional[float]:
    """Device ms per step of the spans ``names``, each without its children."""
    if not _ok(ctx, kind):
        return None
    ms = span_ms(ctx["trace"])
    return sum(ms.get(n, 0.0) for n in names) / ctx["trace"].steps


def arch_and_batch(ctx) -> Optional[Tuple[Arch, int]]:
    """The configuration (of ``configs/``) and batch whose forward the
    context counts (``flops_per_call``, ``unit_calls``)."""
    for path in sorted(glob.glob(os.path.join(HERE, "configs", "*.json"))):
        with open(path) as f:
            arch = Arch.from_config(json.load(f))
        batch = round(ctx["flops_per_call"] / flops.forward_flops(arch, 1))
        work = flops.forward_flops(arch, batch)
        if batch >= 1 and abs(work - ctx["flops_per_call"]) <= 1e-9 * work and flops.forward_calls(arch, batch) == ctx["unit_calls"]:
            return arch, batch
    return None


def conv_roofline_pct(ctx, kind: str) -> Optional[float]:
    """100 x the least time of the UNet calls' convolutions (``conv_calls``)
    over the device ms of the ``conv`` and ``conv_fp32`` spans."""
    ms = ms_per_step(ctx, kind, CONV_SPANS)
    if not ms:
        return ms
    cell = arch_and_batch(ctx)
    if cell is None:
        return None
    bound_ms = sum(c.bound_s for c in conv_calls.forward_convs(*cell)) * 1e3
    return 100.0 * bound_ms * ctx["trace"].calls / ctx["trace"].steps / ms


def first_call_s(ctx, kind: str) -> Optional[float]:
    """Seconds of the first UNet call of each signature (cuDNN's search in
    it), less the kernels' build or load; None for a program without the
    counter."""
    if ctx.get("kind") != kind:
        return None
    try:
        from ishapediting_tpu_torch.utils.trace import setup_seconds
    except ImportError:
        return None
    return setup_seconds()["first_call"]
