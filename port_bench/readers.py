"""Arithmetic the per-layer readers (``metrics/<name>.py``) share. Each
takes the reader's context (``ctx``: ``kind``, the reduced ``trace``, the
cell's ``flops_per_call`` and ``unit_calls``, the count of UNet ``calls``
and loop steps in the traced stretch) and returns None where the cell has
nothing to read."""

from __future__ import annotations

from typing import Optional, Sequence

from port_bench.peaks import BF16_TENSOR_FLOPS

GN_KERNELS = ("gn_stats_kernel", "gn_norm_kernel", "gn_bwd_reduce_kernel", "gn_bwd_apply_kernel")
ATTN_KERNELS = ("attention_kernel", "attention_generic_kernel", "attn_bwd_dq_kernel", "attn_bwd_dkdv_kernel")


def _ok(ctx, kind: str) -> bool:
    return ctx.get("kind") == kind and ctx["trace"].steps > 0 and ctx["trace"].events


def span_ms(ctx, kind: str, span: str) -> Optional[float]:
    """Device ms per step of what the host launched inside ``span``."""
    if not _ok(ctx, kind):
        return None
    return ctx["trace"].device_ms(span=span) / ctx["trace"].steps


def outside_ms(ctx, kind: str, span: str) -> Optional[float]:
    """Device ms per step of everything else."""
    if not _ok(ctx, kind):
        return None
    return ctx["trace"].device_ms(outside=span) / ctx["trace"].steps


def roofline_pct(ctx, kind: str, ops: Sequence[str], kernels: Sequence[str]) -> Optional[float]:
    """100 x the summed least time of the cell's calls of ``ops`` (the
    benchmark's own count, ``flops.py``) over the profiled time of the
    kernels named ``kernels``; None where no such kernel ran."""
    if not _ok(ctx, kind):
        return None
    ms = ctx["trace"].device_ms(names=kernels)
    if ms <= 0:
        return None
    bound_ms = sum(c.bound_s for c in ctx["unit_calls"] if c.op in ops) * 1e3 * ctx["trace"].steps
    return 100.0 * bound_ms / ms


def idle_pct(ctx, kind: str) -> Optional[float]:
    if not _ok(ctx, kind) or ctx["trace"].window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx["trace"].busy_s / ctx["trace"].window_s)


def mfu_pct(ctx, kind: str) -> Optional[float]:
    """Model FLOPs of the steps in the stretch over the stretch's length
    at the bf16 tensor-core peak."""
    if not _ok(ctx, kind) or ctx["trace"].window_s <= 0:
        return None
    work = ctx["flops_per_call"] * ctx["trace"].steps
    return 100.0 * work / (ctx["trace"].window_s * BF16_TENSOR_FLOPS)


def launches_per_step(ctx, kind: str) -> Optional[float]:
    """Host calls that put work on the device, per step."""
    if not _ok(ctx, kind):
        return None
    return ctx["trace"].launches / ctx["trace"].steps
