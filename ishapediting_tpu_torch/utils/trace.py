"""The port's spans: named stretches of its code, on the profiler's clock.

``span(name)`` marks one op or phase at the site where the work is done
(the UNet forward, each convolution and its weight cast, a DDIM update, a
drag step's backward, ...). It records only while a ``torch.profiler``
records (``start_trace``/``stop_trace``, or any other profiler of the
process); otherwise it returns one shared no-op context, which makes no
CUDA call and opens no range. A recorded span is:

- a profiler range ``ishape:<name>`` (the fast record function where torch
  has one, about 1.5 µs, which the trace files as an op), so that it sits in
  the profiler's trace beside the launches it holds: a span's device time is
  that of the kernels whose launch lies inside it and inside none of its
  children (``port_bench/spans.py`` reads the trace so);
- its host time (``time.perf_counter_ns``), its parent (the innermost span
  open on its thread) and its root (the outermost one); a span opened on a
  thread with none open, such as autograd's worker, is a root of its own,
  and in the trace it lies inside the span that waits for it.

``snapshot()`` sums the recorded spans by name: calls, host ms, and self
host ms (a span less the part its children cover).

Two set-up counters record always, each firing once per new thing:
``first_call`` (the first UNet forward of a new signature, which holds
cuDNN's algorithm search and ends with a synchronise) and ``kernel_build``
(the build or load of the Hopper kernels). ``setup_seconds()`` gives their
wall seconds, ``first_call`` less the builds inside it.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import defaultdict
from typing import Dict, List

import torch
import torch.autograd.profiler as _autograd_profiler

PREFIX = "ishape:"
_OFF = contextlib.nullcontext()
_Range = getattr(torch._C._profiler, "_RecordFunctionFast", None) or torch.profiler.record_function

_local = threading.local()
_ids = itertools.count(1)
_done: List[tuple] = []  # (name, id, parent, root, host ms) of each closed span
_setup = {"first_call": 0.0, "kernel_build": 0.0}


class _Span:
    __slots__ = ("name", "id", "parent", "root", "stack", "range", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.id = next(_ids)
        self.parent, self.root = (stack[-1].id, stack[-1].root) if stack else (None, self.id)
        stack.append(self)
        self.stack = stack
        self.range = _Range(PREFIX + self.name)
        self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ms = (time.perf_counter_ns() - self.t0) / 1e6
        self.range.__exit__(None, None, None)
        self.stack.pop()
        _done.append((self.name, self.id, self.parent, self.root, ms))
        return False


def span(name: str):
    """A span named ``name`` around the block while a profiler records;
    otherwise the shared no-op context."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


trace_annotation = span


def records() -> List[dict]:
    """Every recorded span: name, id, parent, root, host ms."""
    return [dict(name=n, id=i, parent=p, root=r, host_ms=ms) for n, i, p, r, ms in list(_done)]


def snapshot() -> Dict[str, dict]:
    """By name: ``calls``, ``host_ms`` and ``self_host_ms``."""
    done = list(_done)
    children: Dict[int, float] = defaultdict(float)
    for _, _, parent, _, ms in done:
        if parent is not None:
            children[parent] += ms
    out: Dict[str, dict] = {}
    for name, i, _, _, ms in done:
        e = out.setdefault(name, dict(calls=0, host_ms=0.0, self_host_ms=0.0))
        e["calls"] += 1
        e["host_ms"] += ms
        e["self_host_ms"] += max(0.0, ms - children[i])
    return out


@contextlib.contextmanager
def first_call(device: torch.device):
    """The ``first_call`` counter around the first call of a new signature:
    waits for ``device`` at its end, so that its seconds hold the call's
    device work and cuDNN's algorithm search."""
    built, t0 = _setup["kernel_build"], time.perf_counter()
    with span("first_call"):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    _setup["first_call"] += time.perf_counter() - t0 - (_setup["kernel_build"] - built)


@contextlib.contextmanager
def kernel_build():
    """The ``kernel_build`` counter around the build or load of the kernels."""
    t0 = time.perf_counter()
    with span("kernel_build"):
        yield
    _setup["kernel_build"] += time.perf_counter() - t0


def setup_seconds() -> Dict[str, float]:
    """Wall seconds of ``first_call`` (less the kernel builds inside it) and
    of ``kernel_build``, since the process started or ``reset()``."""
    return dict(_setup)


def reset() -> None:
    """Forget the recorded spans and zero the set-up counters."""
    _done.clear()
    for k in _setup:
        _setup[k] = 0.0


_trace = None


def start_trace(log_dir: str):
    """Record CPU and (where present) CUDA activity, and the spans, until
    ``stop_trace``; the trace is written under ``log_dir`` (TensorBoard's
    trace layout)."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    global _trace
    if _trace is not None:
        raise RuntimeError("a trace is already running")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _trace = profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir))
    _trace.start()


def stop_trace():
    global _trace
    if _trace is None:
        raise RuntimeError("no trace is running")
    trace, _trace = _trace, None
    trace.stop()
