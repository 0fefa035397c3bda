"""Hand-written Hopper kernels for the UNet's two fused hot ops, their plain
PyTorch versions, ``torch.autograd.Function`` wrappers and launch counters.

Two ops, four kernels (CUDA C++ for ``sm_90a``, sources in ``csrc/``):

- ``groupnorm_silu`` (``csrc/groupnorm_silu.cu``, two launches: ``gn_stats``
  and ``gn_norm``): GroupNorm with fp32 statistics + optional FiLM
  scale-shift + SiLU over NHWC activations, bf16 or fp32. ``gn_stats``
  walks whole rows, one 16-byte channel vector per thread, and writes at
  most 32 (count, mean, M2) partials per (sample, group), merging the
  statistics of a large input's blocks inside thread block clusters;
  ``gn_norm`` merges the partials and normalizes. Replaces
  ``ishapediting_tpu/ops/pallas_kernels.py::groupnorm_silu``.
- ``attention_qkv``: ADM legacy QKV attention over ``[N, T, H*3*ch]`` at
  every dtype (fp32, bf16) and head dim the TPU kernel takes. bf16 at ch in
  {32, 64, 128} takes the ``wgmma`` + TMA kernel (``csrc/attention.cu``,
  counted as ``attention``); fp32 at any ch and bf16 at any other ch take
  the generic ``mma.sync`` kernel (``csrc/attention_generic.cu``: bf16
  tensor cores, fp32 as 3xTF32; counted as ``attention_generic``). Replaces
  ``ishapediting_tpu/ops/pallas_kernels.py::attention_qkv``.

Dispatch is by device and nothing else: a CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises. The kernels build at
first use with nvcc into ``build/kernels/`` (one ``nvcc -c`` per source,
started together, then one link) and bind through ctypes. Backward passes
recompute through the plain versions, as the JAX package's ``custom_vjp``
does. ``LAUNCHES`` counts each kernel launch, so that a run can show it went
through the kernels; ``record_launches`` also lists each launch's shape and
the bytes and operations its bound counts. Launch shapes are computed here
(``gn_stats_geometry``, ``gn_norm_geometry``, ``attention_geometry``,
``attention_generic_geometry``) and passed to the C entry points.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

import torch

from ishapediting_tpu_torch.ops.attention import dense_qkv_attention
from ishapediting_tpu_torch.ops.nn import effective_groups, group_norm, silu

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
SOURCES = ("groupnorm_silu.cu", "attention.cu", "attention_generic.cu")
LIB_NAME = "libishape_kernels.so"
NVCC_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

LAUNCHES: Dict[str, int] = {"gn_stats": 0, "gn_norm": 0, "attention": 0, "attention_generic": 0}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_records: Optional[List[dict]] = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def record_launches():
    """Yield a list that gets one dict per kernel launch inside the block:
    ``kernel``, ``shape`` and ``dtype`` of its main input, the ``bytes`` it
    must move (each input read once, each output written once) and its
    ``tensor_flops`` (bf16 tensor cores), ``tf32_flops`` (TF32 tensor cores)
    and ``fp32_flops`` (FMA units).
    ``gn_norm`` is recorded where ``groupnorm_silu_cuda`` launches it."""
    global _records
    outer, _records = _records, []
    try:
        yield _records
    finally:
        _records = outer


def _record(kernel: str, x: torch.Tensor, nbytes: int, tensor_flops: float = 0.0,
            fp32_flops: float = 0.0, tf32_flops: float = 0.0) -> None:
    if _records is not None:
        _records.append(dict(kernel=kernel, shape=tuple(x.shape), dtype=str(x.dtype)[6:],
                             bytes=nbytes, tensor_flops=tensor_flops, fp32_flops=fp32_flops,
                             tf32_flops=tf32_flops))


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the Hopper kernels cannot be built")


def build_kernels() -> str:
    """Compile every source in ``csrc/`` (one nvcc each, in parallel) and
    link them into one shared library. Returns its path; rebuilds only when
    a source is newer than the library. Processes that start together (the
    ranks of one launch) build once: the others wait on a file lock, then
    find the library up to date."""
    lib_path = os.path.join(BUILD_DIR, LIB_NAME)
    srcs = [os.path.join(CSRC_DIR, s) for s in SOURCES]

    def up_to_date():
        return os.path.exists(lib_path) and all(
            os.path.getmtime(s) <= os.path.getmtime(lib_path) for s in srcs)

    if up_to_date():
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes, or the process dies
        if not up_to_date():
            _compile_and_link(srcs, lib_path)
    return lib_path


def _compile_and_link(srcs, lib_path) -> None:
    nvcc = _nvcc()
    flags = NVCC_ARCH + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    objs, procs = [], []
    for src in srcs:
        obj = os.path.join(BUILD_DIR, os.path.basename(src) + f".{os.getpid()}.o")
        objs.append(obj)
        procs.append(
            subprocess.Popen(
                [nvcc, *flags, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
        )
    logs = [p.communicate()[0] for p in procs]
    for src, p, log in zip(srcs, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
    tmp = lib_path + f".{os.getpid()}.tmp"
    link = subprocess.run(
        [nvcc, *NVCC_ARCH, "-shared", "-o", tmp, *objs],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, lib_path)  # atomic: a reader never sees half a file
    for obj in objs:
        os.remove(obj)


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build_kernels())
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.ishape_gn_stats.argtypes = [p, p] + [i] * 13 + [p]
            lib.ishape_gn_stats.restype = i
            lib.ishape_gn_norm.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, f, i, i, i, i, i, p]
            lib.ishape_gn_norm.restype = i
            lib.ishape_attention.argtypes = [p, p, i, i, i, i, i, p]
            lib.ishape_attention.restype = i
            lib.ishape_attention_smem.argtypes = [i, i]
            lib.ishape_attention_smem.restype = i
            lib.ishape_attention_generic.argtypes = [p, p, i, i, i, i, i, i, p]
            lib.ishape_attention_generic.restype = i
            lib.ishape_attention_generic_smem.argtypes = [i, i]
            lib.ishape_attention_generic_smem.restype = i
            lib.ishape_error_string.argtypes = [i]
            lib.ishape_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.ishape_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: {msg} (cudaError {rc})")


def _require_cuda(t: torch.Tensor, name: str, dtypes) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not supported (want {dtypes})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check_device(t: torch.Tensor) -> None:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}: cpu (plain) or cuda (kernel)")


# The card the launch shapes are sized for (H100 SXM).
NUM_SMS = 132
MAX_BLOCK_THREADS = 1024
MAX_SMEM_BYTES = 232448  # 227 KB: the most shared memory one block may use


# ---------------------------------------------------------------------------
# GroupNorm + FiLM + SiLU
# ---------------------------------------------------------------------------

_GN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GN_VEC = {torch.float32: 4, torch.bfloat16: 8}  # elements per 16-byte vector
_GN_MAX_GROUPS = 1024
_GN_STATS_MAX_THREADS = 1024  # the statistics kernel's launch bound and per-thread slots
_GN_STATS_THREADS = 512  # threads per statistics block, at most
_GN_STATS_BLOCKS_PER_SM = 2  # resident at once: one wave of long-lived blocks
_GN_STATS_CLUSTER = 2  # CTAs per thread block cluster, where clusters pay
_GN_STATS_CLUSTER_ROWS = 16  # rows per thread past which a sample's blocks form clusters
_GN_MAX_SPLITS = 32  # partials per (sample, group), at most
_GN_NORM_THREADS = 512  # threads per normalize block, at most (the kernel's launch bound)
_GN_NORM_BLOCKS_PER_SM = 2  # resident at once: one wave, each thread with 4 rows in flight
_GN_NORM_MAX_BDX = 512  # channel vectors per block; wider C splits over grid y


def groupnorm_silu_plain(x, scale, bias, num_groups=32, eps=1e-5, film=None):
    """The composition the kernel fuses (the JAX package's ``ops/nn.py``
    ``group_norm_silu`` off the TPU): GroupNorm cast to x's dtype, FiLM and
    SiLU in x's dtype. ``film``: optional (scale, shift), each [N, C]."""
    y = group_norm(x, scale, bias, num_groups, eps)
    if film is not None:
        n, c = x.shape[0], x.shape[-1]
        fs = film[0].reshape(n, 1, 1, c)
        fb = film[1].reshape(n, 1, 1, c)
        y = y * (1 + fs) + fb
    return silu(y)


def gn_stats_geometry(n: int, hw: int, c: int, vec: int) -> dict:
    """Launch shape of the ``gn_stats`` kernel for x [n, hw, c] with ``vec``
    channels per thread: block (bdx, bdy) and the row walk as in
    ``gn_norm_geometry``; grid (grid_x, grid_c, n). Each of the ``clusters``
    groups of ``cluster`` row blocks writes one partial per group, so a group
    has ``splits`` = grid_c * clusters <= 32 partials. A cluster launch costs
    about 1 us of device time on an H100, so blocks form clusters (of
    ``_GN_STATS_CLUSTER``) only where 32 blocks per sample would leave each
    thread more than ``_GN_STATS_CLUSTER_ROWS`` rows; elsewhere
    ``cluster`` is 1 (a plain launch). About ``_GN_STATS_BLOCKS_PER_SM``
    blocks per SM at most, never more row blocks than rows to give them."""
    if c % vec:
        raise ValueError(f"{c} channels are not whole vectors of {vec}")
    vpr = c // vec
    bdx = min(vpr, _GN_STATS_THREADS)
    bdy = max(1, _GN_STATS_THREADS // bdx)
    grid_c = -(-vpr // bdx)
    if grid_c > _GN_MAX_SPLITS:
        raise ValueError(f"{c} channels in vectors of {vec}: over {_GN_MAX_SPLITS} channel blocks")
    max_clusters = _GN_MAX_SPLITS // grid_c
    want = -(-(_GN_STATS_BLOCKS_PER_SM * NUM_SMS) // (n * grid_c))
    blocks = max(1, min(-(-hw // bdy), want))
    cluster = 1
    if hw > max_clusters * bdy * _GN_STATS_CLUSTER_ROWS:
        cluster = min(_GN_STATS_CLUSTER, blocks)
    clusters = min(max_clusters, -(-blocks // cluster))
    grid_x = clusters * cluster
    return dict(
        vec=vec, block=(bdx, bdy), grid=(grid_x, grid_c, n), row_step=grid_x * bdy,
        cluster=cluster, clusters=clusters, splits=grid_c * clusters,
        # Static: sums and a pivot per thread slot; dynamic (clusters only):
        # the leader's sums per CTA and group touched, at most one per vector.
        smem_bytes=16 * _GN_STATS_MAX_THREADS + (12 * cluster * bdx if cluster > 1 else 0),
    )


def gn_norm_geometry(n: int, hw: int, c: int, vec: int) -> dict:
    """Launch shape of the ``gn_norm`` kernel for x [n, hw, c] with ``vec``
    channels per thread: block (bdx, bdy), grid (row blocks, channel blocks,
    n). Thread (tx, ty) of block (bx, cb) owns channel vector cb*bdx + tx and
    rows bx*bdy + ty + k*row_step, k = 0, 1, ... (``csrc/groupnorm_silu.cu``).
    About ``_GN_NORM_BLOCKS_PER_SM`` long-lived blocks per SM in all, so the
    per-block prologue (merge the partials, fold the coefficients) is paid a
    few hundred times per call."""
    if c % vec:
        raise ValueError(f"{c} channels are not whole vectors of {vec}")
    vpr = c // vec
    bdx = min(vpr, _GN_NORM_MAX_BDX)
    bdy = max(1, _GN_NORM_THREADS // bdx)
    grid_c = -(-vpr // bdx)
    per_sample = -(-(_GN_NORM_BLOCKS_PER_SM * NUM_SMS) // (n * grid_c))
    grid_x = max(1, min(-(-hw // bdy), per_sample))
    return dict(
        vec=vec, block=(bdx, bdy), grid=(grid_x, grid_c, n), row_step=grid_x * bdy,
        smem_bytes=2 * 4 * _GN_MAX_GROUPS,  # group means and rstds, static
    )


def gn_vec(x: torch.Tensor, *outs: torch.Tensor) -> int:
    """Channels per thread of ``gn_norm``: a 16-byte vector where C and the
    pointers allow it, else 1."""
    vec = _GN_VEC[x.dtype]
    if x.shape[-1] % vec or any(t.data_ptr() % 16 for t in (x, *outs)):
        return 1
    return vec


def gn_stats_vec(x: torch.Tensor, groups: int) -> int:
    """Channels per thread of ``gn_stats``: a 16-byte vector where the group
    width and the pointer allow it (a vector's channels in one group), else 1."""
    vec = _GN_VEC[x.dtype]
    if (x.shape[-1] // groups) % vec or x.data_ptr() % 16:
        return 1
    return vec


def gn_stats_plain(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Plain version of the ``gn_stats`` kernel: fp32 (count, mean, M2) of
    each (sample, group, split) of NHWC ``x``, as [N, G, S, 3], split as the
    kernel splits (``gn_stats_geometry``): partial cb*clusters + s holds the
    rows of cluster s and the channels of channel block cb (count 0 for a
    group outside that channel block)."""
    n, h, w, c = x.shape
    hw, cg = h * w, c // groups
    geo = gn_stats_geometry(n, hw, c, gn_stats_vec(x, groups))
    bdx, bdy = geo["block"]
    dev = x.device
    row_cluster = (torch.arange(hw, device=dev) % geo["row_step"]) // bdy // geo["cluster"]
    chan_block = (torch.arange(c, device=dev) // geo["vec"] // bdx).reshape(groups, cg)
    xg = x.float().reshape(n, hw, groups, cg)
    parts = []
    for cb in range(geo["grid"][1]):
        for s in range(geo["clusters"]):
            m = ((row_cluster == s)[:, None, None] & (chan_block == cb)[None]).float()
            count = m.sum(dim=(0, 2)).expand(n, groups)
            mean = (xg * m).sum(dim=(1, 3)) / count.clamp(min=1)
            m2 = ((xg - mean[:, None, :, None]) * m).square().sum(dim=(1, 3))
            parts.append(torch.stack([count, mean, m2], dim=-1))
    return torch.stack(parts, dim=2)


def gn_norm_plain(x, part, scale, bias, eps=1e-5, film=None):
    """Plain version of the ``gn_norm`` kernel: merge the partial statistics
    ``part`` [N, G, S, 3], then normalize, affine, FiLM and SiLU in fp32 with
    one cast to x's dtype at the end."""
    n, h, w, c = x.shape
    g = part.shape[1]
    count, mean, m2 = part.unbind(-1)
    total = count.sum(-1)
    mu = (count * mean).sum(-1) / total
    var = (m2.sum(-1) + (count * (mean - mu[..., None]).square()).sum(-1)) / total
    xg = x.float().reshape(n, h, w, g, c // g)
    y = (xg - mu[:, None, None, :, None]) * torch.rsqrt(var + eps)[:, None, None, :, None]
    y = y.reshape(n, h, w, c) * scale.float() + bias.float()
    if film is not None:
        fs = film[0].float().reshape(n, 1, 1, c)
        fb = film[1].float().reshape(n, 1, 1, c)
        y = y * (1 + fs) + fb
    return silu(y).to(x.dtype)


def gn_stats_cuda(x: torch.Tensor, groups: int) -> torch.Tensor:
    """Launch the statistics kernel on x [N, H, W, C] (contiguous, bf16 or
    fp32). Returns the fp32 partials [N, G, S, 3] of ``gn_stats_plain``."""
    _require_cuda(x, "x", tuple(_GN_DTYPES))
    if x.ndim != 4 or x.shape[-1] % groups:
        raise ValueError(f"x must be [N, H, W, C] with C divisible by {groups}, got {tuple(x.shape)}")
    if not 1 <= groups <= _GN_MAX_GROUPS:
        raise ValueError(f"{groups} groups: the kernel takes 1..{_GN_MAX_GROUPS}")
    n, h, w, c = x.shape
    geo = gn_stats_geometry(n, h * w, c, gn_stats_vec(x, groups))
    part = torch.empty((n, groups, geo["splits"], 3), dtype=torch.float32, device=x.device)
    lib = _load()
    _check(lib, lib.ishape_gn_stats(
        x.data_ptr(), part.data_ptr(), _GN_DTYPES[x.dtype], n, h * w, c, groups, geo["splits"],
        geo["vec"], *geo["block"], *geo["grid"][:2], geo["cluster"], geo["clusters"], _stream(x),
    ), "gn_stats")
    LAUNCHES["gn_stats"] += 1
    _record("gn_stats", x, _nbytes(x, part), fp32_flops=3 * x.numel())
    return part


def gn_norm_cuda(x, part, scale, bias, eps=1e-5, film=None):
    """Launch the normalize kernel on x [N, H, W, C] with the partials
    ``part`` [N, G, S, 3] of ``gn_stats_cuda``. Allocates the output."""
    _require_cuda(x, "x", tuple(_GN_DTYPES))
    _require_cuda(part, "part", (torch.float32,))
    if x.ndim != 4:
        raise ValueError(f"x must be [N, H, W, C], got {tuple(x.shape)}")
    n, h, w, c = x.shape
    if part.ndim != 4 or part.shape[0] != n or part.shape[3] != 3 or c % part.shape[1]:
        raise ValueError(f"part {tuple(part.shape)} does not fit x {tuple(x.shape)}")
    g, s = part.shape[1], part.shape[2]
    gamma = scale.detach().float().reshape(c).contiguous()
    beta = bias.detach().float().reshape(c).contiguous()
    film_t = None
    if film is not None:
        film_t = torch.stack(
            [film[0].detach().reshape(n, c), film[1].detach().reshape(n, c)], dim=1
        ).float().contiguous()  # [N, 2, C], scale row first
    for name, t in (("part", part), ("scale", gamma), ("bias", beta), ("film", film_t)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    y = torch.empty_like(x)
    geo = gn_norm_geometry(n, h * w, c, gn_vec(x, y))
    lib = _load()
    _check(lib, lib.ishape_gn_norm(
        x.data_ptr(), y.data_ptr(), part.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), 0 if film_t is None else film_t.data_ptr(),
        _GN_DTYPES[x.dtype], n, h * w, c, g, s, float(eps), geo["vec"], *geo["block"],
        *geo["grid"][:2], _stream(x),
    ), "gn_norm")
    LAUNCHES["gn_norm"] += 1
    return y


def groupnorm_silu_cuda(x, scale, bias, num_groups=32, eps=1e-5, film=None):
    """Both GroupNorm-SiLU kernels on x [N, H, W, C] (contiguous, bf16 or
    fp32): statistics, then merge and normalize."""
    _require_cuda(x, "x", tuple(_GN_DTYPES))
    part = gn_stats_cuda(x, effective_groups(x.shape[-1], num_groups))
    y = gn_norm_cuda(x, part, scale, bias, eps, film)
    n, c = x.shape[0], x.shape[-1]
    _record("gn_norm", x, _nbytes(x, y, part) + 4 * (2 * c + (0 if film is None else 2 * n * c)),
            fp32_flops=12 * x.numel())
    return y


class GroupNormSiLU(torch.autograd.Function):
    """Forward: the kernel on CUDA, the plain version on the CPU. Backward:
    recompute through the plain version (no backward kernel, as in JAX)."""

    @staticmethod
    def forward(ctx, x, scale, bias, film_scale, film_shift, num_groups, eps):
        ctx.save_for_backward(x, scale, bias, film_scale, film_shift)
        ctx.num_groups, ctx.eps = num_groups, eps
        film = None if film_scale is None else (film_scale, film_shift)
        if x.is_cuda:
            return groupnorm_silu_cuda(x, scale, bias, num_groups, eps, film)
        return groupnorm_silu_plain(x, scale, bias, num_groups, eps, film)

    @staticmethod
    def backward(ctx, gy):
        saved = ctx.saved_tensors
        inputs = [
            None if t is None else t.detach().requires_grad_(ctx.needs_input_grad[i])
            for i, t in enumerate(saved)
        ]
        x, scale, bias, fs, fb = inputs
        with torch.enable_grad():
            y = groupnorm_silu_plain(
                x, scale, bias, ctx.num_groups, ctx.eps,
                None if fs is None else (fs, fb),
            )
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        grads = iter(torch.autograd.grad(y, wanted, gy, allow_unused=True))
        out = [
            next(grads) if t is not None and t.requires_grad else None
            for t in inputs
        ]
        return (*out, None, None)


def groupnorm_silu(x, scale, bias, num_groups=32, eps=1e-5, film=None):
    """Fused ``silu(group_norm(x) [* (1 + fs) + fb])`` over NHWC ``x``.
    ``film``: optional (scale, shift), each reshapeable to [N, C] (the ADM
    scale-shift-norm FiLM, reference: unet.py:245-252)."""
    _check_device(x)
    fs, fb = (None, None) if film is None else film
    return GroupNormSiLU.apply(x, scale, bias, fs, fb, num_groups, eps)


# ---------------------------------------------------------------------------
# QKV attention
# ---------------------------------------------------------------------------

_ATTN_HEAD_DIMS = (32, 64, 128)  # the wgmma kernel's, in bf16
_ATTN_ROWS = 64  # query rows per CTA (one consumer warpgroup)
_ATTN_STAGES = 3  # K/V ring depth
_ATTN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ATTN_GENERIC_THREADS = 128  # four warps, 16 query rows each
_ATTN_GENERIC_ROWS = 64  # query rows per CTA
# O-accumulator buckets (output channels held in registers); past the last,
# the chunked path.
_ATTN_GENERIC_BUCKETS = {torch.float32: (16, 32, 48, 64, 96, 128),
                         torch.bfloat16: (16, 32, 48, 64, 96, 128, 192, 256)}
_ATTN_GENERIC_STAGES = {torch.float32: 3, torch.bfloat16: 4}  # K/V ring depth
_ATTN_GENERIC_CHUNK = 64  # Q/K channels per chunk of the chunked path
_ATTN_GENERIC_SLICE = 256  # output channels per CTA of the chunked path
_ATTN_GENERIC_MAX_SPLIT = 4  # CTAs per cluster sharing a query tile's keys, at most
_ATTN_GENERIC_PAD = {torch.float32: 4, torch.bfloat16: 8}  # 16 bytes of row padding


def attention_geometry(n: int, t: int, heads: int, ch: int) -> dict:
    """Launch shape of the attention kernel (``csrc/attention.cu``): one CTA
    of one consumer warpgroup (64 query rows) and one producer warp per
    (query tile, batch*head); grid (query tiles, n*heads). K/V tiles of 128
    keys, or 64 where T <= 64 (no half-empty tile) and at ch = 128
    (registers). Shared memory: the Q tile, a 3-stage K/V ring, 1 KB of
    alignment slack and the mbarriers, as ``smem_bytes<CH, KEYS>()``."""
    if ch not in _ATTN_HEAD_DIMS:
        raise ValueError(f"head dim {ch} not supported (kernel takes {_ATTN_HEAD_DIMS})")
    keys = 64 if t <= 64 or ch == 128 else 128
    return dict(
        threads=128 + 32, grid=(-(-t // _ATTN_ROWS), n * heads),
        keys_per_tile=keys, key_tiles=-(-t // keys),
        smem_bytes=1024 + _ATTN_ROWS * ch * 2 + 2 * _ATTN_STAGES * keys * ch * 2
        + 8 * (2 * _ATTN_STAGES + 1),
    )


def attention_generic_geometry(n: int, t: int, heads: int, ch: int,
                               dtype: torch.dtype = torch.float32) -> dict:
    """Launch shape of the generic attention kernel
    (``csrc/attention_generic.cu``): 128 threads (four warps of 16 query
    rows) per CTA; grid (query tiles of 64 rows, n*heads, z). The head dim
    is padded to ``chp``, the next multiple of 16.

    Fast path (``chunked`` false: fp32 up to chp 128, bf16 up to 256): the O
    accumulator is sized by the least ``bucket`` >= chp; K/V tiles of
    ``keys_per_tile`` (32 for fp32 and past bucket 128, else 64) in a ring
    of ``stages`` (3 fp32, 4 bf16). Shared memory in rows of chp + pad
    elements (pad: 16 bytes): Q and the ring (64 + 2 * stages * keys rows),
    for fp32 also the lo halves of the 3xTF32 split of Q, K and V (64 + 2 *
    keys rows). bf16 at ch 192 and 256 (``tma``): TMA boxes into unpadded,
    128-byte swizzled rows after 1 KB of alignment slack. A thread block
    cluster of ``split`` CTAs (grid z) shares each query tile's key tiles:
    doubled up to 4 while the grid stays within half the SMs and each CTA
    keeps two key tiles.

    Chunked path (past the fast path): grid z slices the output channels by
    256; logits over chunks of 64 channels; tiles of 32 keys; shared memory
    Q [64][64 + pad], K [32][64 + pad], V [32][256 + pad], twice for fp32.
    ``smem_bytes`` mirrors ``smem_bytes``/``smem_tma`` in the source."""
    if ch < 1:
        raise ValueError(f"head dim {ch} not supported (kernel takes any ch >= 1)")
    if dtype not in _ATTN_DTYPES:
        raise TypeError(f"qkv: dtype {dtype} not supported (want {tuple(_ATTN_DTYPES)})")
    tf32x3 = dtype == torch.float32  # hi and lo halves in shared memory
    chp = 16 * -(-ch // 16)
    slice_, chunk, rows = _ATTN_GENERIC_SLICE, _ATTN_GENERIC_CHUNK, _ATTN_GENERIC_ROWS
    buckets, stages = _ATTN_GENERIC_BUCKETS[dtype], _ATTN_GENERIC_STAGES[dtype]
    chunked = chp > buckets[-1]
    bucket = slice_ if chunked else next(b for b in buckets if chp <= b)
    keys = 32 if tf32x3 or bucket > 128 else 64
    pad, elt = _ATTN_GENERIC_PAD[dtype], (4 if tf32x3 else 2)
    tma = not tf32x3 and not chunked and ch % 64 == 0 and ch > 128
    if chunked:
        smem = elt * (2 if tf32x3 else 1) * ((rows + keys) * (chunk + pad) + keys * (slice_ + pad))
    elif tma:
        smem = 1024 + elt * (rows + 2 * stages * keys) * ch
    else:
        smem = elt * (rows + 2 * stages * keys + (rows + 2 * keys if tf32x3 else 0)) * (chp + pad)
    qtiles, key_tiles = -(-t // rows), -(-t // keys)
    split = 1
    while (not chunked and split < _ATTN_GENERIC_MAX_SPLIT
           and 2 * split * qtiles * n * heads <= NUM_SMS // 2 and 4 * split <= key_tiles):
        split *= 2
    return dict(
        threads=_ATTN_GENERIC_THREADS,
        grid=(qtiles, n * heads, -(-chp // slice_) if chunked else split),
        chp=chp, bucket=bucket, chunked=chunked, tma=tma, keys_per_tile=keys, key_tiles=key_tiles,
        stages=0 if chunked else stages, split=split, smem_bytes=smem,
    )


def attention_route(dtype: torch.dtype, ch: int) -> str:
    """Which kernel (``LAUNCHES`` key) takes qkv of ``dtype`` at head dim
    ``ch``: the wgmma kernel for bf16 at ch in {32, 64, 128}, the generic one
    for fp32 or bf16 at any other ch >= 1; anything else raises."""
    if dtype not in _ATTN_DTYPES:
        raise TypeError(f"qkv: dtype {dtype} not supported (want {tuple(_ATTN_DTYPES)})")
    if ch < 1:
        raise ValueError(f"head dim {ch} not supported (kernels take any ch >= 1)")
    if dtype == torch.bfloat16 and ch in _ATTN_HEAD_DIMS:
        return "attention"
    return "attention_generic"


def attention_qkv_cuda(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Launch an attention kernel on qkv [N, T, H*3*ch] (contiguous, fp32 or
    bf16), the one ``attention_route`` picks."""
    _require_cuda(qkv, "qkv", tuple(_ATTN_DTYPES))
    if qkv.ndim != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv {tuple(qkv.shape)} is not [N, T, {num_heads}*3*ch]")
    n, t, width = qkv.shape
    ch = width // (3 * num_heads)
    route = attention_route(qkv.dtype, ch)
    out = torch.empty((n, t, num_heads * ch), dtype=qkv.dtype, device=qkv.device)
    lib = _load()
    products = 4.0 * n * num_heads * t * t * ch  # flops of Q K^T and P V
    if route == "attention":
        geo = attention_geometry(n, t, num_heads, ch)
        # The tensor map wants a 16-byte aligned base and row and sample
        # strides that are multiples of 16 bytes.
        if qkv.data_ptr() % 16 or (width * qkv.element_size()) % 16:
            raise ValueError("qkv must be 16-byte aligned, with rows a multiple of 16 bytes")
        _check(lib, lib.ishape_attention(
            qkv.data_ptr(), out.data_ptr(), n, t, num_heads, ch, geo["keys_per_tile"], _stream(qkv)
        ), "attention")
        # The products on the tensor cores; the softmax, about 4 fp32
        # operations per logit, on the FMA units.
        _record(route, qkv, _nbytes(qkv, out), tensor_flops=products,
                fp32_flops=4.0 * n * num_heads * t * t)
    else:
        geo = attention_generic_geometry(n, t, num_heads, ch, qkv.dtype)
        _check(lib, lib.ishape_attention_generic(
            qkv.data_ptr(), out.data_ptr(), _ATTN_DTYPES[qkv.dtype], n, t, num_heads, ch,
            geo["chp"], _stream(qkv)
        ), "attention_generic")
        # bf16: the products on the bf16 tensor cores; fp32: three TF32
        # passes of each (3xTF32). The softmax on the FMA units.
        softmax = 4.0 * n * num_heads * t * t
        if qkv.dtype == torch.bfloat16:
            _record(route, qkv, _nbytes(qkv, out), tensor_flops=products, fp32_flops=softmax)
        else:
            _record(route, qkv, _nbytes(qkv, out), tf32_flops=3 * products, fp32_flops=softmax)
    LAUNCHES[route] += 1
    return out


class QKVAttention(torch.autograd.Function):
    """Forward: the kernel on CUDA, ``dense_qkv_attention`` on the CPU.
    Backward: recompute through ``dense_qkv_attention``."""

    @staticmethod
    def forward(ctx, qkv, num_heads):
        ctx.save_for_backward(qkv)
        ctx.num_heads = num_heads
        if qkv.is_cuda:
            return attention_qkv_cuda(qkv, num_heads)
        return dense_qkv_attention(qkv, num_heads)

    @staticmethod
    def backward(ctx, gout):
        (qkv,) = ctx.saved_tensors
        qkv = qkv.detach().requires_grad_(True)
        with torch.enable_grad():
            out = dense_qkv_attention(qkv, ctx.num_heads)
        (g,) = torch.autograd.grad(out, qkv, gout)
        return g, None


def attention_qkv(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Fused ADM attention; same contract as ``dense_qkv_attention``
    (qkv [N, T, H*3*ch], per-head q/k/v contiguous; reference: unet.py:328-354)."""
    _check_device(qkv)
    return QKVAttention.apply(qkv, num_heads)
