"""Key-value metrics logger + profiling scopes.

Covers the reference's OpenAI-baselines logger surface that the pipeline
actually uses (reference: logger.py:211-316,405-476): ``logkv``/``dumpkvs``,
``log``, timing scopes (``profile_kv``/``@profile``), and pluggable writers
(stdout / csv / jsonl / tensorboard-if-available), configured by
``ISHAPE_LOGDIR`` / ``ISHAPE_LOG_FORMAT`` env vars.

Additions over the reference: ``torch.profiler`` integration
(``trace_annotation`` names a region of the timeline; ``start_trace`` /
``stop_trace`` record CPU and CUDA activity into a trace under a directory).
"""

from __future__ import annotations

import contextlib
import csv
import json
import os
import sys
import time
from collections import defaultdict
from typing import Dict, List, Optional

DEBUG, INFO, WARN, ERROR = 10, 20, 30, 40


class _StdoutWriter:
    def write_kvs(self, kvs: Dict) -> None:
        if not kvs:
            return
        key_width = max(len(str(k)) for k in kvs)
        lines = ["-" * (key_width + 20)]
        for k in sorted(kvs):
            v = kvs[k]
            vs = f"{v:.5g}" if isinstance(v, float) else str(v)
            lines.append(f"| {str(k):<{key_width}} | {vs:<12} |")
        lines.append(lines[0])
        print("\n".join(lines), flush=True)

    def write_line(self, line: str) -> None:
        print(line, flush=True)


class _JsonlWriter:
    def __init__(self, path: str):
        self._f = open(path, "a")

    def write_kvs(self, kvs: Dict) -> None:
        self._f.write(json.dumps(kvs, default=float) + "\n")
        self._f.flush()

    def write_line(self, line: str) -> None:
        pass


class _CsvWriter:
    def __init__(self, path: str):
        self._path = path
        self._keys: List[str] = []
        self._rows: List[Dict] = []

    def write_kvs(self, kvs: Dict) -> None:
        self._rows.append(dict(kvs))
        for k in kvs:
            if k not in self._keys:
                self._keys.append(k)
        with open(self._path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._keys)
            w.writeheader()
            w.writerows(self._rows)

    def write_line(self, line: str) -> None:
        pass


class KVLogger:
    def __init__(self, log_dir: Optional[str] = None, formats=("stdout",)):
        self.log_dir = log_dir
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
        self._writers = []
        for fmt in formats:
            if fmt == "stdout":
                self._writers.append(_StdoutWriter())
            elif fmt == "json":
                self._writers.append(
                    _JsonlWriter(os.path.join(log_dir or ".", "progress.jsonl"))
                )
            elif fmt == "csv":
                self._writers.append(
                    _CsvWriter(os.path.join(log_dir or ".", "progress.csv"))
                )
            elif fmt == "tensorboard":
                try:
                    from torch.utils.tensorboard import SummaryWriter

                    self._writers.append(_TBWriter(SummaryWriter(log_dir)))
                except Exception:
                    pass
        self._kvs: Dict = {}
        self._counts: Dict = defaultdict(int)
        self.level = INFO
        self._durations: Dict[str, float] = defaultdict(float)
        self._step = 0

    def logkv(self, key, val) -> None:
        self._kvs[key] = val

    def logkv_mean(self, key, val) -> None:
        old, cnt = self._kvs.get(key, 0.0), self._counts[key]
        self._kvs[key] = old * cnt / (cnt + 1) + float(val) / (cnt + 1)
        self._counts[key] = cnt + 1

    def dumpkvs(self) -> Dict:
        for name, dur in self._durations.items():
            self._kvs[f"time/{name}"] = dur
        out = dict(self._kvs)
        for w in self._writers:
            w.write_kvs(out)
        self._kvs.clear()
        self._counts.clear()
        self._durations.clear()
        self._step += 1
        return out

    def log(self, *args, level: int = INFO) -> None:
        if level >= self.level:
            for w in self._writers:
                w.write_line(" ".join(map(str, args)))

    @contextlib.contextmanager
    def profile_kv(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._durations[name] += time.perf_counter() - t0

    def profile(self, name: str):
        def decorator(fn):
            def wrapped(*a, **kw):
                with self.profile_kv(name):
                    return fn(*a, **kw)

            return wrapped

        return decorator


class _TBWriter:
    def __init__(self, writer):
        self._w = writer
        self._step = 0

    def write_kvs(self, kvs: Dict) -> None:
        for k, v in kvs.items():
            try:
                self._w.add_scalar(k, float(v), self._step)
            except (TypeError, ValueError):
                pass
        self._step += 1
        self._w.flush()

    def write_line(self, line: str) -> None:
        pass


_logger: Optional[KVLogger] = None


def configure(log_dir: Optional[str] = None, formats=None) -> KVLogger:
    """Env-configurable like the reference (logger.py:444-466):
    ``ISHAPE_LOGDIR``, ``ISHAPE_LOG_FORMAT`` (comma-separated)."""
    global _logger
    log_dir = log_dir or os.environ.get("ISHAPE_LOGDIR")
    if formats is None:
        formats = tuple(
            os.environ.get("ISHAPE_LOG_FORMAT", "stdout").split(",")
        )
    _logger = KVLogger(log_dir, formats)
    return _logger


def get_logger() -> KVLogger:
    global _logger
    if _logger is None:
        _logger = configure()
    return _logger


@contextlib.contextmanager
def profile_kv(name: str):
    with get_logger().profile_kv(name):
        yield


_trace = None


@contextlib.contextmanager
def trace_annotation(name: str):
    """Annotate a region in the ``torch.profiler`` timeline."""
    from torch.profiler import record_function

    with record_function(name):
        yield


def start_trace(log_dir: str):
    """Record CPU and (where present) CUDA activity until ``stop_trace``;
    the trace is written under ``log_dir`` (TensorBoard's trace layout)."""
    import torch
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
