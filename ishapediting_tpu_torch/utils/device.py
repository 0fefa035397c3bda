"""Device selection, numeric flags and device timing.

Entry points run on CUDA unless the caller asks for the CPU; there is no
quiet CPU fallback.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``cuda``; a CUDA device is an error when none is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: cuda or cpu")
    return dev


def set_cuda_flags(cudnn_benchmark: bool = True) -> None:
    """Full fp32 for fp32 matmuls and convolutions (cuDNN would otherwise run
    the fp32 output head and the decoder's fp32 products in TF32), and cuDNN
    timing its algorithms once per shape: without it, cuDNN's heuristic picks
    an FFT algorithm for the fp32 head convolution at batch 2 whose kernels
    took 428 ms of device time per chairs forward on an H100 80GB HBM3 at
    700 W, against 10.9 ms for the whole forward with timing on
    (``tools/profile_unet.py``)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = cudnn_benchmark


def cuda_ms(fn: Callable[[], object], iters: int = 20) -> float:
    """Mean device time in ms of ``fn`` over ``iters`` back-to-back calls
    (CUDA events, after two warm-up calls). The inputs stay the same, so an
    input under the 50 MB L2 is partly served from it, as it is after the op
    that produced it in the UNet."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# Published peaks of one H100 SXM (NVIDIA data sheet; dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
TF32_TENSOR_FLOPS = 495e12
FP32_FLOPS = 67e12


def bound_ms(nbytes: float, tensor_flops: float = 0.0, fp32_flops: float = 0.0,
             tf32_flops: float = 0.0):
    """(least ms, what bounds it) of work that moves ``nbytes`` and does
    ``tensor_flops`` on the bf16 tensor cores, ``tf32_flops`` on the TF32
    tensor cores and ``fp32_flops`` on the FMA units: the larger of bytes
    over the HBM rate and operations over the peak rate of their type."""
    times = {
        "bytes": nbytes / HBM_BYTES_PER_S,
        "operations": max(tensor_flops / BF16_TENSOR_FLOPS, tf32_flops / TF32_TENSOR_FLOPS,
                          fp32_flops / FP32_FLOPS),
    }
    by = max(times, key=times.get)
    return times[by] * 1e3, by


# Rows of the profiler's own device activity, not the program's kernels.
PROFILER_ACTIVITIES = ("Buffer Flush", "Activity Buffer Request")


def kernel_rows(prof):
    """The rows of a ``torch.profiler`` run that are the program's kernels
    (not the device-side copies of ``record_function`` ranges, such as
    ``Optimizer.step#AdamW.step``, which span kernels counted already)."""
    from torch.autograd import DeviceType

    return [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.key not in PROFILER_ACTIVITIES
        and not getattr(e, "is_user_annotation", False)
    ]


def device_ms(fn: Callable[[], object], iters: int = 20, kernel: Optional[str] = None) -> float:
    """Device time in ms per call of the kernels ``fn`` launches (only those
    whose name contains ``kernel``, if given), summed from a
    ``torch.profiler`` trace of ``iters`` calls after one warm-up call.
    Unlike ``cuda_ms`` it leaves out the gaps in which the device waits for
    the host, which for a kernel of tens of microseconds can be most of the
    wall time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # the profiler now and then returns a trace without device rows
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in kernel_rows(prof) if kernel is None or kernel in e.key]
        if rows:
            return sum(e.self_device_time_total for e in rows) / 1e3 / iters
    raise RuntimeError(f"no kernel {kernel!r} in three traces")
