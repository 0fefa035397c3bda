"""A ``torch.profiler`` capture of a stretch of the window, reduced to what
the per-layer readers read: every device activity (kernels, copies, sets)
with its time and the benchmark span (``bench:<name>``, a
``record_function`` range of the harness) whose host code launched it, the
union of device-busy time, the idle gaps, and the counts of UNet calls and
steps inside the stretch.

A device activity is tied to its launch by the profiler's correlation id;
one without a launch record takes the span of the activity before it. A
launch is in the innermost benchmark span that holds it in time (the
backward runs on autograd's worker thread while the main thread waits
inside its span).
"""

from __future__ import annotations

import collections
import json
import os
import tempfile
from typing import Dict, List, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_PREFIX = "bench:"
TOP = 6  # entries of each breakdown list
NAME_CHARS = 40  # of a device op
OP_CHARS = 32  # of the host op that ends an idle gap


def span(name: str):
    """A benchmark span around host code (a profiler range; a few
    microseconds when no profiler runs)."""
    import torch

    return torch.profiler.record_function(SPAN_PREFIX + name)


def short(name: str) -> str:
    name = name[5:] if name.startswith("void ") else name
    return name[:NAME_CHARS]


def _innermost(intervals, queries):
    """For each query time, the label of the innermost interval holding it
    (intervals nested or disjoint), or None."""
    ivs = sorted(intervals, key=lambda iv: (iv[0], -iv[1]))
    order = sorted(range(len(queries)), key=queries.__getitem__)
    out: List[Optional[str]] = [None] * len(queries)
    stack, k = [], 0
    for qi in order:
        q = queries[qi]
        while k < len(ivs) and ivs[k][0] <= q:
            while stack and stack[-1][1] < ivs[k][0]:
                stack.pop()
            stack.append(ivs[k])
            k += 1
        while stack and stack[-1][1] < q:
            stack.pop()
        out[qi] = stack[-1][2] if stack else None
    return out


class Trace:
    """The reduced trace. ``events``: device activities (name, start_us,
    dur_us, span); ``window_s``, ``busy_s``; ``launches``: host calls that
    put work on the device; ``calls`` and ``steps``: UNet calls and loop
    steps inside the stretch (set by the cell)."""

    def __init__(self, trace_events: List[dict], outer: Optional[str] = None):
        """``outer``: the span that holds the whole stretch (it opened
        before the profiler started, so the trace does not hold it)."""
        dev = [e for e in trace_events if e.get("ph") == "X" and e.get("cat", "").lower() in DEVICE_CATS]
        launches = {e["args"]["correlation"]: e for e in trace_events
                    if e.get("ph") == "X" and e.get("cat", "").lower() in LAUNCH_CATS
                    and "correlation" in e.get("args", {})}
        spans = [(e["ts"], e["ts"] + e["dur"], e["name"][len(SPAN_PREFIX):]) for e in trace_events
                 if e.get("ph") == "X" and e.get("cat", "").lower() == "user_annotation"
                 and e.get("name", "").startswith(SPAN_PREFIX)]
        ops_by_tid = collections.defaultdict(list)
        for e in trace_events:
            if e.get("ph") == "X" and e.get("cat", "").lower() == "cpu_op":
                ops_by_tid[e.get("tid")].append((e["ts"], e["ts"] + e["dur"], e["name"]))
        dev.sort(key=lambda e: e["ts"])
        launch = [launches.get(e.get("args", {}).get("correlation")) for e in dev]
        known = [i for i, l in enumerate(launch) if l is not None]
        span_of = _innermost(spans, [launch[i]["ts"] for i in known])
        op_of: Dict[int, Optional[str]] = {}
        for tid, ops in ops_by_tid.items():
            idx = [i for i in known if launch[i].get("tid") == tid]
            for i, name in zip(idx, _innermost(ops, [launch[i]["ts"] for i in idx])):
                op_of[i] = name
        labels = dict(zip(known, span_of))
        # host calls that put work on the device (a graph launch is one)
        self.launches = len({launch[i]["args"]["correlation"] for i in known})
        self.events = []
        last_span = None
        for i, e in enumerate(dev):
            s = (labels[i] or outer) if i in labels else last_span
            last_span = s
            self.events.append((e.get("name", "?"), float(e["ts"]), float(e.get("dur", 0.0)), s,
                                op_of.get(i)))
        stamps = [(e["ts"], e["ts"] + e.get("dur", 0.0)) for e in trace_events
                  if e.get("ph") == "X" and "ts" in e]
        t0 = min(s for s, _ in stamps) if stamps else 0.0
        t1 = max(s for _, s in stamps) if stamps else 0.0
        self.window_s = (t1 - t0) / 1e6
        busy, gaps, end = 0.0, collections.Counter(), t0
        for name, ts, dur, s, op in self.events:
            if ts > end:
                gaps[f"{s or 'outside spans'} / {(op or '?')[:OP_CHARS]}"] += (ts - end) / 1e6
            busy += max(0.0, ts + dur - max(ts, end))
            end = max(end, ts + dur)
        if t1 > end and self.events:
            gaps["after the last launch"] += (t1 - end) / 1e6
        self.busy_s = busy / 1e6
        self.gaps = gaps
        self.calls = 0
        self.steps = 0

    def device_ms(self, span: Optional[str] = None, outside: Optional[str] = None,
                  names=None) -> float:
        """Summed device ms of the activities launched in ``span`` (or not
        in ``outside``), of a kernel whose name holds one of ``names``."""
        total = 0.0
        for name, _, dur, s, _ in self.events:
            if span is not None and s != span:
                continue
            if outside is not None and s == outside:
                continue
            if names is not None and not any(n in name for n in names):
                continue
            total += dur
        return total / 1e3

    def breakdown(self) -> dict:
        ops = collections.Counter()
        for name, _, dur, _, _ in self.events:
            ops[short(name)] += dur / 1e6
        return {"device_ops": [[k, v] for k, v in ops.most_common(TOP)],
                "idle_gaps": [[k, v] for k, v in self.gaps.most_common(TOP)]}


class Capture:
    """Profiles from ``start()`` to ``stop()`` (each after a device
    synchronise, so the stretch holds exactly the work launched inside it),
    then reduces the trace."""

    def __init__(self, cuda: bool = True):
        from torch.profiler import ProfilerActivity, profile

        self.cuda = cuda
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        self.prof = profile(activities=acts)
        self.state = "idle"
        self.trace: Optional[Trace] = None

    def start(self) -> None:
        import torch

        if self.state == "idle":
            if self.cuda:
                torch.cuda.synchronize()
            self.prof.start()
            self.state = "on"

    def stop(self) -> None:
        import torch

        if self.state == "on":
            if self.cuda:
                torch.cuda.synchronize()
            self.prof.stop()
            self.state = "done"

    def reduce(self, outer: Optional[str] = None) -> Trace:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.remove(path)
        self.trace = Trace(events, outer)
        return self.trace


def quantile(values, q: float) -> float:
    """Linear-interpolated quantile (numpy's default) without numpy."""
    v = sorted(values)
    pos = (len(v) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)
