"""Hand-written Hopper kernels for the UNet's fused hot ops, forward and
backward, their plain PyTorch versions, ``torch.autograd.Function`` wrappers
and launch counters.

Three ops, ten kernels (CUDA C++ for ``sm_90a``, sources in ``csrc/``):

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
- The backward halves of both (in place of the JAX package's VJPs
  ``_gn_silu_bwd`` and ``_attn_bwd``; the kernels emulate eager PyTorch's
  differentiation of the port's plain composition on the card): the
  GroupNorm-SiLU backward in two launches and nothing else,
  ``gn_bwd_reduce`` (per-channel sums of the cotangent through SiLU, FiLM
  and the affine, finished in the kernel into the parameters' gradients and
  the group terms of dx) and ``gn_bwd_apply`` (dx), beside the forward in
  ``csrc/groupnorm_silu.cu``;
  the attention backward in two, ``attn_bwd_dq`` and ``attn_bwd_dkdv``
  (every dtype and head dim the forward takes), each with two routes as
  the forward has: bf16 at ch in {32, 64, 128} on the TMA + ``wgmma``
  kernels (``csrc/attention_bwd_hopper.cu``), fp32 and bf16 at any other
  ch on the generic ``mma.sync`` kernels (``csrc/attention_bwd.cu``).
- ``bias_epilogue`` (``csrc/bias_epilogue.cu``, one launch): every
  convolution's and dense layer's bias add, ``rnd(y + b)``
  (``bias_add_kernel``, counted as ``bias_add``), and the fused form
  that a ResBlock's last conv or an attention block's projection takes,
  ``rnd(res + rnd(y + b))``, with ``rnd(res + rb)`` first where the
  residual is a skip conv's raw product (``bias_residual_kernel``,
  counted as ``bias_residual``): the biases read as the layer stores them
  (fp32) and rounded to the activation dtype, each add one fp32 add
  rounded to the dtype, bit-equal to eager PyTorch's casts and adds.
  16-byte vectors where C and the pointers allow, narrower where not. A
  call that wants no gradient writes into the product's buffer; under
  autograd the plain composition runs, with autograd's own backward. No
  TPU kernel: the JAX package leaves these adds to XLA.

Dispatch is by device: a CPU tensor takes the plain version (the
backward: autograd through the plain composition, as the JAX package's
VJPs); a CUDA tensor launches the kernel or raises. The bias epilogue alone
also asks whether a gradient is wanted (``needs_grad``): under autograd,
and on any device but a card, it is the plain composition. The
kernels build at first use with nvcc into ``build/kernels/`` (one ``nvcc
-c`` per source, started together, then one link) and bind through ctypes.
``LAUNCHES`` counts each kernel launch, so that a run can show it went
through the kernels; ``record_launches`` also lists each launch's shape and
the bytes and operations its bound counts. Launch shapes are computed here
(``gn_stats_geometry``, ``gn_norm_geometry``, ``gn_bwd_geometry``,
``attention_geometry``, ``attention_generic_geometry``,
``attention_bwd_geometry``, ``bias_epilogue_geometry``) and passed to the C
entry points.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import operator
import os
import shutil
import subprocess
import threading
from typing import Dict, List, NamedTuple, Optional

import torch

from ishapediting_tpu_torch.ops.attention import dense_qkv_attention
from ishapediting_tpu_torch.ops.nn import effective_groups, group_norm, silu
from ishapediting_tpu_torch.utils.trace import kernel_build, span

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "kernels")
SOURCES = ("groupnorm_silu.cu", "attention.cu", "attention_generic.cu", "attention_bwd.cu",
           "attention_bwd_hopper.cu", "bias_epilogue.cu")
LIB_NAME = "libishape_kernels.so"
NVCC_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]

LAUNCHES: Dict[str, int] = {"gn_stats": 0, "gn_norm": 0, "attention": 0, "attention_generic": 0,
                            "gn_bwd_reduce": 0, "gn_bwd_apply": 0, "attn_bwd_dq": 0, "attn_bwd_dkdv": 0,
                            "bias_add": 0, "bias_residual": 0}

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
    """Append one launch to the open ``record_launches`` list; a launch site
    calls it only while one is open (``_records is not None``), so that no
    launch counts bytes for a list nobody keeps."""
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
            with kernel_build():
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
            lib.ishape_gn_bwd_reduce.argtypes = [ctypes.POINTER(_GnBwdArgs), p]
            lib.ishape_gn_bwd_reduce.restype = i
            lib.ishape_gn_bwd_apply.argtypes = [ctypes.POINTER(_GnBwdArgs), p]
            lib.ishape_gn_bwd_apply.restype = i
            lib.ishape_attn_bwd_dq.argtypes = [p] * 7 + [i] * 6 + [p]
            lib.ishape_attn_bwd_dq.restype = i
            lib.ishape_attn_bwd_dkdv.argtypes = [p] * 6 + [i] * 6 + [p]
            lib.ishape_attn_bwd_dkdv.restype = i
            lib.ishape_attn_bwd_wgmma_smem.argtypes = [i, i]
            lib.ishape_attn_bwd_wgmma_smem.restype = i
            lib.ishape_bias_epilogue.argtypes = [p] * 5 + [i] * 8 + [p]
            lib.ishape_bias_epilogue.restype = i
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
    mu, rstd = merge_partials(part, eps)
    xg = x.float().reshape(n, h, w, g, c // g)
    y = (xg - mu[:, None, None, :, None]) * rstd[:, None, None, :, None]
    y = y.reshape(n, h, w, c) * scale.float() + bias.float()
    if film is not None:
        fs = film[0].float().reshape(n, 1, 1, c)
        fb = film[1].float().reshape(n, 1, 1, c)
        y = y * (1 + fs) + fb
    return silu(y).to(x.dtype)


def merge_partials(part: torch.Tensor, eps: float = 1e-5):
    """(mean, rstd), each [N, G], of the partials [N, G, S, 3] of
    ``gn_stats``: Chan's merge of (count, mean, M2), rstd = 1/sqrt(var + eps)."""
    count, mean, m2 = part.unbind(-1)
    total = count.sum(-1)
    mu = (count * mean).sum(-1) / total
    var = (m2.sum(-1) + (count * (mean - mu[..., None]).square()).sum(-1)) / total
    return mu, torch.rsqrt(var + eps)


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
    if _records is not None:
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
    gamma, beta, film_t = _gn_params(x, part, scale, bias, film)
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


def _gn_params(x, part, scale, bias, film):
    """gamma, beta [C] and the FiLM terms (fs, fb) [N, 2, C] (None without
    FiLM) as the normalize kernel reads them: fp32, contiguous, on x's card."""
    n, c = x.shape[0], x.shape[-1]
    gamma = scale.detach().float().reshape(c).contiguous()
    beta = bias.detach().float().reshape(c).contiguous()
    film_t = None
    if film is not None:
        film_t = torch.stack([film[0].detach().reshape(n, c), film[1].detach().reshape(n, c)], dim=1)
        film_t = film_t.float().contiguous()
    for name, t in (("part", part), ("scale", gamma), ("bias", beta), ("film", film_t)):
        if t is not None and t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    return gamma, beta, film_t


def groupnorm_silu_cuda(x, scale, bias, num_groups=32, eps=1e-5, film=None):
    """Both GroupNorm-SiLU kernels on x [N, H, W, C] (contiguous, bf16 or
    fp32): statistics, then merge and normalize. Returns (y, the
    statistics' partials), which the backward kernels read."""
    _require_cuda(x, "x", tuple(_GN_DTYPES))
    part = gn_stats_cuda(x, effective_groups(x.shape[-1], num_groups))
    y = gn_norm_cuda(x, part, scale, bias, eps, film)
    if _records is not None:
        n, c = x.shape[0], x.shape[-1]
        _record("gn_norm", x, _nbytes(x, y, part) + 4 * (2 * c + (0 if film is None else 2 * n * c)),
                fp32_flops=12 * x.numel())
    return y, part


# The backward. With a = xhat*gamma + beta, z = a*t1 + fb the SiLU's input
# (t1 = 1 + fs), gz = gy*sigmoid(z)*(1 + z*(1 - sigmoid(z))) and, per (n, c),
# S1 = sum_hw gz, S2 = sum_hw gz*xhat: dfb = S1, dfs = gamma*S2 + beta*S1,
# dbeta = sum_n t1*S1, dgamma = sum_n t1*S2, and with A, B the group means
# of k*gz and k*gz*xhat (k = gamma*t1), dx = rstd*(k*gz - A - xhat*B).
# gz is evaluated at the rounding points in x's dtype of eager PyTorch's
# backward of the port's plain composition (``groupnorm_silu_plain``) on the
# card (a, a*t1, z, sigmoid(z), each product, 1 - sigmoid(z) and the sum:
# PyTorch's CUDA bf16 sigmoid backward rounds after each op; t1 = 1 + fs in
# fs's dtype; nothing rounds in fp32), the reference of chip_smoke.py's
# gradient gate. The JAX package's VJP rounds elsewhere: it differentiates
# ``_gn_silu_reference``, which forms a*(1 + fs) + fb in fp32 and rounds
# once. gn_bwd_reduce writes S1, S2 as partials over row blocks, and its
# last block per (sample, channel block) finishes them: the gradients of the
# parameters and, per group, (mean, rstd, A, B); gn_bwd_apply writes dx.

_GN_BWD_THREADS = 512  # threads per backward block, at most (the kernels' launch bound)
_GN_BWD_BLOCKS_PER_SM = 2  # resident at once: one wave
_GN_BWD_ROW_SPLITS = 32  # row blocks per (sample, channel block), about, where channel blocks can narrow
_GN_BWD_MIN_SPAN = 64  # bytes of a row one block reads, at least (two 32-byte sectors)
_GN_BWD_MAX_WIDTH = 512  # channels per block, at most (so a group of at most 512 channels)
_GN_NEEDS_ALL = (True,) * 5  # gradients wanted: x, scale, bias, film scale, film shift


class GnBwdOut(NamedTuple):
    """What ``gn_bwd_reduce`` (and its twin) returns: the workspace's
    (S1, S2) partials [N, grid_x, 2, C] fp32, ``stats`` [N, 4, G] fp32 (mean,
    rstd, A, B per group: what ``gn_bwd_apply`` reads), and the parameters'
    gradients in their dtypes and shapes (None where not asked for, and dfs,
    dfb without FiLM)."""
    sums: torch.Tensor
    stats: torch.Tensor
    dscale: Optional[torch.Tensor]
    dbias: Optional[torch.Tensor]
    dfs: Optional[torch.Tensor]
    dfb: Optional[torch.Tensor]


def gn_bwd_geometry(x: torch.Tensor, groups: int, *ts: torch.Tensor) -> dict:
    """Launch shape of ``gn_bwd_reduce`` and ``gn_bwd_apply`` on x [N, H, W, C]
    and the tensors ``ts`` they read or write beside it: block (bdx, bdy),
    grid (grid_x row blocks, grid_c channel blocks, N). Thread (tx, ty) of
    block (bx, cb) owns channel vector cb*bdx + tx (16 bytes where a vector
    lies in one group and the pointers allow, else one channel) and rows
    bx*bdy + ty + k*row_step. A channel block holds whole groups (bdx a
    power-of-two multiple of a group's vectors, at most a warp's 32 unless
    one group is wider); where a sample's blocks would leave more than about
    ``_GN_BWD_ROW_SPLITS`` row blocks for the reduce's finishing block to sum,
    channel blocks narrow, down to ``_GN_BWD_MIN_SPAN`` bytes of a row."""
    n, h, w, c = x.shape
    hw, cg = h * w, c // groups
    vec = _GN_VEC[x.dtype]
    if cg % vec or any(t.data_ptr() % 16 for t in (x, *ts)):
        vec = 1
    if cg > _GN_BWD_MAX_WIDTH:
        raise ValueError(f"groups of {cg} channels: the backward kernels take at most {_GN_BWD_MAX_WIDTH}")
    vg, vpr = cg // vec, c // vec  # vectors per group and per row
    blocks = _GN_BWD_BLOCKS_PER_SM * NUM_SMS
    want_c = -(-blocks // (n * _GN_BWD_ROW_SPLITS))
    min_bdx = -(-_GN_BWD_MIN_SPAN // (vec * x.element_size()))
    m = 1
    while vg * m * 2 <= min(32, vpr):
        m *= 2
    while m > 1 and -(-vpr // (vg * m)) < want_c and vg * m // 2 >= min_bdx:
        m //= 2
    bdx = vg * m
    bdy = max(1, _GN_BWD_THREADS // bdx)
    grid_c = -(-vpr // bdx)
    grid_x = max(1, min(-(-hw // bdy), blocks // (n * grid_c)))  # no block past the one wave
    return dict(vec=vec, block=(bdx, bdy), grid=(grid_x, grid_c, n), row_step=grid_x * bdy)


def _sum_in_order(ts):
    """((t0 + t1) + t2) + ...: a sum in the order the kernels take it."""
    return functools.reduce(torch.add, ts)


def gn_bwd_reduce_plain(x, part, gy, scale, bias, eps=1e-5, film=None, need=_GN_NEEDS_ALL) -> GnBwdOut:
    """Plain version of ``gn_bwd_reduce``: fp32 (S1, S2) per (sample, row
    block, channel) as [N, S, 2, C], the rows split as the kernel splits them
    (row r to block (r mod row_step) // bdy, ``gn_bwd_geometry``), then what
    its finishing blocks compute from them (``gn_bwd_finish_plain``) with the
    statistics merged from the forward's partials."""
    n, h, w, c = x.shape
    geo = gn_bwd_geometry(x, part.shape[1], gy)
    mean, rstd = merge_partials(part, eps)
    gz, xhat = _gn_bwd_terms(x, mean, rstd, gy, scale, bias, film)
    hw = h * w
    split = (torch.arange(hw, device=x.device) % geo["row_step"]) // geo["block"][1]
    terms = torch.stack([gz, gz * xhat], dim=3).reshape(n, hw, 2, c)
    sums = torch.zeros((n, geo["grid"][0], 2, c), dtype=torch.float32, device=x.device)
    sums.index_add_(1, split, terms)
    return GnBwdOut(sums, *gn_bwd_finish_plain(sums, mean, rstd, scale, bias, hw, film, need))


def gn_bwd_finish_plain(sums, mean, rstd, scale, bias, hw, film=None, need=_GN_NEEDS_ALL):
    """What ``gn_bwd_reduce``'s finishing blocks compute from the partials
    ``sums`` [N, S, 2, C] and the statistics ``mean``, ``rstd`` [N, G], in
    their order and rounding (so the same partials give the same bits):
    (stats [N, 4, G], dscale, dbias, dfs, dfb) as ``GnBwdOut`` holds them.
    S1, S2 sum the partials in row-block order; A, B sum k*S1, k*S2 over a
    group's channels in order, over hw*cg; dbias and dscale sum t1*S1,
    t1*S2 over the samples in order."""
    n, c = sums.shape[0], sums.shape[-1]
    groups = mean.shape[1]
    cg = c // groups
    s1, s2 = _sum_in_order(sums.unbind(1)).unbind(1)
    gamma, beta = scale.detach().float().reshape(c), bias.detach().float().reshape(c)
    t1 = None if film is None else (1 + film[0].detach()).reshape(n, c).float()
    k = gamma if t1 is None else gamma * t1
    ab = _sum_in_order(torch.stack([k * s1, k * s2], 1).reshape(n, 2, groups, cg).unbind(-1)) / (hw * cg)
    stats = torch.stack([mean.float(), rstd.float(), ab[:, 0], ab[:, 1]], 1)
    w1, w2 = (s1, s2) if t1 is None else (t1 * s1, t1 * s2)
    dscale = _sum_in_order(w2.unbind(0)).to(scale.dtype).reshape(scale.shape) if need[1] else None
    dbias = _sum_in_order(w1.unbind(0)).to(bias.dtype).reshape(bias.shape) if need[2] else None
    dfs = dfb = None
    if film is not None:
        fs, fb = film
        dfs = (gamma * s2 + beta * s1).to(fs.dtype).reshape(fs.shape) if need[3] else None
        dfb = s1.to(fb.dtype).reshape(fb.shape) if need[4] else None
    return stats, dscale, dbias, dfs, dfb


def _gn_bwd_terms(x, mean, rstd, gy, scale, bias, film):
    """gz (the cotangent at the SiLU's input, at the rounding points of
    eager PyTorch's backward of the plain composition on the card) and
    xhat, each [N, H, W, C] fp32, from the statistics ``mean``, ``rstd``
    [N, G]."""
    n, h, w, c = x.shape
    g = mean.shape[1]
    rnd = lambda t: t.to(x.dtype).float()  # noqa: E731
    mu, rs = (t.repeat_interleave(c // g, dim=1).reshape(n, 1, 1, c) for t in (mean, rstd))
    xhat = (x.float() - mu) * rs
    z = rnd(xhat * scale.float().reshape(c) + bias.float().reshape(c))
    if film is not None:
        t1 = (1 + film[0].detach()).reshape(n, 1, 1, c).float()
        z = rnd(rnd(z * t1) + film[1].detach().reshape(n, 1, 1, c).float())
    sg = rnd(torch.sigmoid(z))
    gy = gy.float()
    return rnd(rnd(gy * sg) + rnd(rnd(rnd(gy * z) * rnd(1 - sg)) * sg)), xhat


def gn_bwd_apply_plain(x, gy, stats, scale, bias, film=None):
    """Plain version of ``gn_bwd_apply``: dx = rstd*(k*gz - A - xhat*B) in
    fp32 from ``stats`` [N, 4, G] (mean, rstd, A, B), cast once to x's
    dtype."""
    n, h, w, c = x.shape
    g = stats.shape[2]
    mean, rstd, a, b = stats.unbind(1)
    gz, xhat = _gn_bwd_terms(x, mean, rstd, gy, scale, bias, film)
    k = scale.float().reshape(c)
    if film is not None:
        k = k * (1 + film[0].detach()).reshape(n, 1, 1, c).float()
    rs, a, b = (t.repeat_interleave(c // g, dim=1).reshape(n, 1, 1, c) for t in (rstd, a, b))
    return (rs * (k * gz - a - xhat * b)).to(x.dtype)


def gn_silu_bwd_plain(x, part, gy, scale, bias, eps=1e-5, film=None):
    """The backward of ``groupnorm_silu`` in closed form, with the kernels'
    partials: (dx, dscale, dbias, dfs, dfb), each in its input's dtype and
    shape (dfs, dfb None without FiLM). ``part``: the forward's statistics
    partials [N, G, S, 3]."""
    red = gn_bwd_reduce_plain(x, part, gy, scale, bias, eps, film)
    dx = gn_bwd_apply_plain(x, gy, red.stats, scale, bias, film)
    return dx, red.dscale, red.dbias, red.dfs, red.dfb


class _GnBwdArgs(ctypes.Structure):
    """The C struct ``GnBwdArgs`` of ``csrc/groupnorm_silu.cu``, field by
    field: pointers, FiLM row strides, dtype codes (0 fp32, 1 bf16), sizes,
    eps and the launch shape."""
    _fields_ = (
        [(f, ctypes.c_void_p) for f in ("x", "gy", "part", "gamma", "beta", "fs", "fb", "sums", "fin",
                                        "stats", "count", "dgamma", "dbeta", "dfs", "dfb", "dx")]
        + [("fs_ld", ctypes.c_longlong), ("fb_ld", ctypes.c_longlong)]
        + [(f, ctypes.c_int) for f in ("dtype", "gamma_t", "beta_t", "fs_t", "fb_t", "N", "HW", "C", "G", "S")]
        + [("eps", ctypes.c_float)]
        + [(f, ctypes.c_int) for f in ("vec", "bdx", "bdy", "grid_x", "grid_c")]
    )


# Arrival counters of gn_bwd_reduce per (device, stream): zeroed once, and
# every launch leaves them 0 (its finishing blocks reset what they counted).
_gn_bwd_counters: Dict[tuple, torch.Tensor] = {}


def _arrival_counters(x: torch.Tensor, size: int) -> torch.Tensor:
    key = (x.device.index, _stream(x))
    with _lock:
        t = _gn_bwd_counters.get(key)
        if t is None or t.numel() < size:
            t = _gn_bwd_counters[key] = torch.zeros(max(size, 4096), dtype=torch.int32, device=x.device)
        return t


def _gn_bwd_param(t: torch.Tensor, x: torch.Tensor, name: str, rows: int = 0):
    """A parameter as the backward kernels read it: [C] (or [N, C] rows of
    unit stride) on x's card, fp32 or bf16 (no copy on the main path).
    Returns (tensor, dtype code, row stride)."""
    c = x.shape[-1]
    t = t.detach().reshape(rows, c) if rows else t.detach().reshape(c)
    if t.device != x.device:
        raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if t.dtype not in _GN_DTYPES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported (want float32 or bfloat16)")
    if t.stride(-1) != 1:
        t = t.contiguous()
    return t, _GN_DTYPES[t.dtype], t.stride(0) if rows else 0


def _gn_bwd_args(x, gy, scale, bias, film, geo, **ptrs) -> _GnBwdArgs:
    n, h, w, c = x.shape
    gamma, gamma_t, _ = _gn_bwd_param(scale, x, "scale")
    beta, beta_t, _ = _gn_bwd_param(bias, x, "bias")
    a = _GnBwdArgs(x=x.data_ptr(), gy=gy.data_ptr(), gamma=gamma.data_ptr(), beta=beta.data_ptr(),
                   dtype=_GN_DTYPES[x.dtype], gamma_t=gamma_t, beta_t=beta_t, N=n, HW=h * w, C=c,
                   vec=geo["vec"], bdx=geo["block"][0], bdy=geo["block"][1], grid_x=geo["grid"][0],
                   grid_c=geo["grid"][1])
    fs = fb = None
    if film is not None:
        (fs, a.fs_t, a.fs_ld), (fb, a.fb_t, a.fb_ld) = (_gn_bwd_param(f, x, name, n) for f, name in
                                                          zip(film, ("film scale", "film shift")))
        if x.dtype == torch.bfloat16 and (fs.dtype, fb.dtype) != (x.dtype, x.dtype):
            raise TypeError("bf16 x: the backward kernels take the FiLM terms in bf16")
        a.fs, a.fb = fs.data_ptr(), fb.data_ptr()
    for k, v in ptrs.items():
        setattr(a, k, 0 if v is None else v.data_ptr())
    a._keep = (gamma, beta, fs, fb)  # any copies, alive while the struct is
    return a


def _gn_bwd_check(x, gy):
    _require_cuda(x, "x", tuple(_GN_DTYPES))
    _require_cuda(gy, "gy", (x.dtype,))
    if x.ndim != 4 or gy.shape != x.shape:
        raise ValueError(f"x {tuple(x.shape)} and gy {tuple(gy.shape)} must be one [N, H, W, C] shape")


def gn_bwd_reduce_cuda(x, part, gy, scale, bias, eps=1e-5, film=None, need=_GN_NEEDS_ALL) -> GnBwdOut:
    """Launch ``gn_bwd_reduce`` on x and its cotangent gy (both [N, H, W, C],
    contiguous, x's dtype) with the forward's partials ``part``. Returns the
    ``GnBwdOut`` of ``gn_bwd_reduce_plain``; writes the parameters'
    gradients that ``need`` (x, scale, bias, fs, fb) asks for."""
    _gn_bwd_check(x, gy)
    _require_cuda(part, "part", (torch.float32,))
    n, h, w, c = x.shape
    if part.ndim != 4 or part.shape[0] != n or part.shape[3] != 3 or c % part.shape[1]:
        raise ValueError(f"part {tuple(part.shape)} does not fit x {tuple(x.shape)}")
    g, s = part.shape[1], part.shape[2]
    geo = gn_bwd_geometry(x, g, gy)
    grid_x, grid_c = geo["grid"][:2]
    ws = torch.empty(n * (grid_x + 1) * 2 * c + n * 4 * g, dtype=torch.float32, device=x.device)
    sums = ws[: n * grid_x * 2 * c].view(n, grid_x, 2, c)
    fin = ws[n * grid_x * 2 * c: n * (grid_x + 1) * 2 * c]
    stats = ws[n * (grid_x + 1) * 2 * c:].view(n, 4, g)
    dscale = torch.empty_like(scale, memory_format=torch.contiguous_format) if need[1] else None
    dbias = torch.empty_like(bias, memory_format=torch.contiguous_format) if need[2] else None
    fs, fb = (None, None) if film is None else film
    dfs = torch.empty_like(fs, memory_format=torch.contiguous_format) if fs is not None and need[3] else None
    dfb = torch.empty_like(fb, memory_format=torch.contiguous_format) if fb is not None and need[4] else None
    count = _arrival_counters(x, n * grid_c + grid_c)
    args = _gn_bwd_args(x, gy, scale, bias, film, geo, part=part, sums=sums, fin=fin, stats=stats,
                        count=count, dgamma=dscale, dbeta=dbias, dfs=dfs, dfb=dfb)
    args.G, args.S, args.eps = g, s, float(eps)
    lib = _load()
    _check(lib, lib.ishape_gn_bwd_reduce(ctypes.byref(args), _stream(x)), "gn_bwd_reduce")
    LAUNCHES["gn_bwd_reduce"] += 1
    if _records is not None:
        _record("gn_bwd_reduce", x, _nbytes(x, gy, part, scale, bias, *(film or ()), sums, stats, dscale,
                                            dbias, dfs, dfb), fp32_flops=16 * x.numel())
    return GnBwdOut(sums, stats, dscale, dbias, dfs, dfb)


def gn_bwd_apply_cuda(x, gy, stats, scale, bias, film=None):
    """Launch ``gn_bwd_apply``: dx in x's dtype from x, gy and the reduce's
    ``stats`` [N, 4, G] (mean, rstd, A, B)."""
    _gn_bwd_check(x, gy)
    _require_cuda(stats, "stats", (torch.float32,))
    n, h, w, c = x.shape
    g = stats.shape[-1]
    if stats.shape != (n, 4, g) or c % g:
        raise ValueError(f"stats {tuple(stats.shape)} does not fit x {tuple(x.shape)}")
    dx = torch.empty_like(x)
    geo = gn_bwd_geometry(x, g, gy, dx)
    args = _gn_bwd_args(x, gy, scale, bias, film, geo, stats=stats, dx=dx)
    args.G = g
    lib = _load()
    _check(lib, lib.ishape_gn_bwd_apply(ctypes.byref(args), _stream(x)), "gn_bwd_apply")
    LAUNCHES["gn_bwd_apply"] += 1
    if _records is not None:
        _record("gn_bwd_apply", x, _nbytes(x, gy, dx, stats, scale, bias, *(film or ())), fp32_flops=18 * x.numel())
    return dx


def gn_silu_bwd_cuda(x, part, gy, scale, bias, eps=1e-5, film=None, need=_GN_NEEDS_ALL):
    """Both backward kernels, and nothing else where gy is contiguous in x's
    dtype: ``gn_bwd_reduce`` (the gradients of the parameters ``need`` asks
    for), then ``gn_bwd_apply`` (dx, only if ``need[0]``). Returns what
    ``gn_silu_bwd_plain`` returns (None for what ``need`` leaves out)."""
    gy = gy.to(x.dtype).contiguous()
    red = gn_bwd_reduce_cuda(x, part, gy, scale, bias, eps, film, need)
    dx = gn_bwd_apply_cuda(x, gy, red.stats, scale, bias, film) if need[0] else None
    return dx, red.dscale, red.dbias, red.dfs, red.dfb


class GroupNormSiLU(torch.autograd.Function):
    """Forward: the kernels on CUDA, the plain version on the CPU. Backward:
    on CUDA the backward kernels (``gn_silu_bwd_cuda``, reading the
    forward's statistics partials); on the CPU autograd through the plain
    composition, as the JAX package's VJP."""

    @staticmethod
    def forward(ctx, x, scale, bias, film_scale, film_shift, num_groups, eps):
        ctx.num_groups, ctx.eps = num_groups, eps
        film = None if film_scale is None else (film_scale, film_shift)
        if x.is_cuda:
            y, part = groupnorm_silu_cuda(x, scale, bias, num_groups, eps, film)
            ctx.save_for_backward(x, scale, bias, film_scale, film_shift, part)
            return y
        ctx.save_for_backward(x, scale, bias, film_scale, film_shift, None)
        return groupnorm_silu_plain(x, scale, bias, num_groups, eps, film)

    @staticmethod
    def backward(ctx, gy):
        with span("gn_silu_bwd"):
            *saved, part = ctx.saved_tensors
            need = ctx.needs_input_grad
            if part is not None:
                x, scale, bias, fs, fb = saved
                grads = gn_silu_bwd_cuda(x, part, gy, scale, bias, ctx.eps,
                                         None if fs is None else (fs, fb), need=need[:5])
                return (*grads, None, None)
            inputs = [
                None if t is None else t.detach().requires_grad_(need[i])
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
    with span("gn_silu"):  # around apply: the Function's own host time is the span's
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
    if route == "attention":
        geo = attention_geometry(n, t, num_heads, ch)
        # The tensor map wants a 16-byte aligned base and row and sample
        # strides that are multiples of 16 bytes.
        if qkv.data_ptr() % 16 or (width * qkv.element_size()) % 16:
            raise ValueError("qkv must be 16-byte aligned, with rows a multiple of 16 bytes")
        _check(lib, lib.ishape_attention(
            qkv.data_ptr(), out.data_ptr(), n, t, num_heads, ch, geo["keys_per_tile"], _stream(qkv)
        ), "attention")
    else:
        geo = attention_generic_geometry(n, t, num_heads, ch, qkv.dtype)
        _check(lib, lib.ishape_attention_generic(
            qkv.data_ptr(), out.data_ptr(), _ATTN_DTYPES[qkv.dtype], n, t, num_heads, ch,
            geo["chp"], _stream(qkv)
        ), "attention_generic")
    LAUNCHES[route] += 1
    if _records is not None:
        # The products (Q K^T and P V) on the bf16 tensor cores, or in fp32
        # as three TF32 passes of each (3xTF32, the generic route); the
        # softmax, about 4 fp32 operations per logit, on the FMA units.
        products = 4.0 * n * num_heads * t * t * ch
        flops = dict(tensor_flops=products) if qkv.dtype == torch.bfloat16 else dict(tf32_flops=3 * products)
        _record(route, qkv, _nbytes(qkv, out), fp32_flops=4.0 * n * num_heads * t * t, **flops)
    return out


# The backward, with s = ch^-1/4 on both q and k: P = softmax((sQ)(sK)^T),
# D = rowsum(dO * O), dV = P^T dO, dS = P * (dO V^T - D), dQ = s dS (sK),
# dK = s dS^T (sQ), at the dense composition's rounding points in qkv's
# dtype (sQ, sK, the logits and dO V^T rounded to it; P and dS rounded to it
# as product operands; nothing rounds in fp32), as eager PyTorch
# differentiates ``dense_qkv_attention`` on the card, the reference of
# chip_smoke.py's gradient gate. attn_bwd_dq (a CTA per query tile) sweeps
# the keys once with an online log-sum-exp (dS relative to the running row
# maximum, rounded before its product, the dQ sums rescaled when the
# maximum moves and divided by the row sum at the end); it writes the
# log-sum-exp and D to an fp32 workspace [N, H, T]. attn_bwd_dkdv (a CTA per
# key tile) sweeps the query tiles, rebuilds P from the log-sum-exp, and sums
# dK and dV. Both write into dqkv in qkv's [N, T, H*3*ch] layout. Two routes,
# as the forward's: "hopper" for bf16 at ch in {32, 64, 128}
# (``csrc/attention_bwd_hopper.cu``: TMA, an mbarrier ring, ``wgmma``, two
# consumer warpgroups splitting the swept tiles; its workspace also holds
# sQ = rnd(s q) [N, T, H*ch] bf16, scaled once per tile by attn_bwd_dq and
# swept by attn_bwd_dkdv), "generic" for the rest (``csrc/attention_bwd.cu``:
# ``mma.sync`` in bf16, FMA in fp32).

_ATTN_BWD_ROWS = 64  # rows of a CTA's own tile (and of each tile the generic route sweeps)
_ATTN_BWD_CHUNK = 64  # channels per chunk of the generic route's logit products
_ATTN_BWD_STAGES = 4  # the Hopper route's ring of swept tiles
_ATTN_BWD_THREADS_HOPPER = 2 * 128 + 32  # two consumer warpgroups and a producer warp


def attention_bwd_route(dtype: torch.dtype, ch: int) -> str:
    """Which backward kernels take qkv of ``dtype`` at head dim ``ch``:
    "hopper" (TMA + ``wgmma``) for bf16 at ch in {32, 64, 128}, "generic"
    for fp32 or bf16 at any other ch >= 1; anything else raises. Both count
    as ``attn_bwd_dq`` and ``attn_bwd_dkdv``."""
    if dtype not in _ATTN_DTYPES:
        raise TypeError(f"qkv: dtype {dtype} not supported (want {tuple(_ATTN_DTYPES)})")
    if ch < 1:
        raise ValueError(f"head dim {ch} not supported (kernels take any ch >= 1)")
    return "hopper" if dtype == torch.bfloat16 and ch in _ATTN_HEAD_DIMS else "generic"


def _attn_bwd_hopper_smem(ch: int, dkdv: bool) -> int:
    """The Hopper route's dynamic shared memory (``Layout`` in
    ``csrc/attention_bwd_hopper.cu``): 1 KB of alignment slack, the two own
    tiles [64][ch] bf16, four stages of two swept tiles [sweep][ch], the row
    values (dkdv: each stage's lse and D; dq: the own rows' D), the second
    warpgroup's partial sums (128 threads x (dkdv: ch; dq: ch/2 + 4)
    floats), nine mbarriers."""
    sweep = 32 if dkdv and ch == 128 else 64
    rowvals = _ATTN_BWD_STAGES * 2 * sweep * 4 if dkdv else _ATTN_BWD_ROWS * 4
    merge = 128 * (ch if dkdv else ch // 2 + 4) * 4
    tiles = 2 * _ATTN_BWD_ROWS * ch * 2 + _ATTN_BWD_STAGES * 2 * sweep * ch * 2
    return 1024 + tiles + rowvals + merge + 8 * (2 * _ATTN_BWD_STAGES + 1)


def attention_bwd_geometry(n: int, t: int, heads: int, ch: int, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Launch shape of both attention backward kernels on the route
    ``attention_bwd_route`` picks. Hopper (``csrc/attention_bwd_hopper.cu``):
    288 threads (two consumer warpgroups and a producer warp), grid (tiles of
    64 own rows: queries for ``attn_bwd_dq``, keys for ``attn_bwd_dkdv``,
    n*heads), swept tiles of ``sweep_dq`` / ``sweep_dkdv`` rows alternating
    between the warpgroups through a 4-stage ring, one CTA per SM. Generic
    (``csrc/attention_bwd.cu``): 128 threads (four warps of 16 rows); grid
    (tiles of 64 rows, n*heads, output slices); each CTA holds the gradient
    of ``out_cols`` output channels (16, 32 or 64 up to 64 channels, 128
    past them: slices of 128, each recomputing the logits over every chunk
    of 64 channels). Shared memory: for each of the four operands (own
    x1, x2, swept y1, y2) a tile [64][64 + 16 bytes of padding] of qkv's
    dtype per chunk of 64 channels where they fit (``resident_dq`` /
    ``resident_dkdv``: the own tiles load once, a swept tile in one round),
    else one (the chunks stream through it); fp32 also a [16][68] fp32
    scratch per warp; ``attn_bwd_dkdv`` also the swept tile's log-sum-exp
    and D."""
    route = attention_bwd_route(dtype, ch)
    tiles = -(-t // _ATTN_BWD_ROWS)
    if route == "hopper":
        return dict(route=route, threads=_ATTN_BWD_THREADS_HOPPER, grid=(tiles, n * heads), out_cols=ch,
                    chunks=1, stages=_ATTN_BWD_STAGES, sweep_dq=64, sweep_dkdv=32 if ch == 128 else 64,
                    smem_dq=_attn_bwd_hopper_smem(ch, False), smem_dkdv=_attn_bwd_hopper_smem(ch, True))
    out_cols = 16 if ch <= 16 else 32 if ch <= 32 else 64 if ch <= 64 else 128
    chunks = -(-ch // _ATTN_BWD_CHUNK)
    elt, pad = (4, 4) if dtype == torch.float32 else (2, 8)
    tile = _ATTN_BWD_ROWS * (_ATTN_BWD_CHUNK + pad) * elt
    scratch = 4 * 16 * (_ATTN_BWD_ROWS + 4) * 4 if dtype == torch.float32 else 0

    def smem(dkdv, nb):
        return 4 * nb * tile + scratch + (2 * _ATTN_BWD_ROWS * 4 if dkdv else 0)

    nb = {k: chunks if smem(k, chunks) <= MAX_SMEM_BYTES else 1 for k in (False, True)}
    return dict(route=route, threads=128, grid=(tiles, n * heads, -(-ch // out_cols)),
                out_cols=out_cols, chunks=chunks, resident_dq=nb[False] == chunks,
                resident_dkdv=nb[True] == chunks, smem_dq=smem(False, nb[False]),
                smem_dkdv=smem(True, nb[True]))


def _attn_heads(t: torch.Tensor, num_heads: int, parts: int):
    """[N, T, H*parts*ch] as ``parts`` fp32 tensors [N, T, H, ch]."""
    n, tt, width = t.shape
    ch = width // (parts * num_heads)
    return t.float().reshape(n, tt, num_heads, parts, ch).unbind(3)


def _attn_bwd_terms(qkv, gout, num_heads):
    """(sQ, sK, the logits, dP = dO V^T, s, x -> x rounded to qkv's dtype),
    fp32, at the rounding points of eager PyTorch's backward of the dense
    composition on the card."""
    q, k, v = _attn_heads(qkv, num_heads, 3)
    (do,) = _attn_heads(gout, num_heads, 1)
    rnd = lambda t: t.to(qkv.dtype).float()  # noqa: E731
    s = q.shape[-1] ** -0.25
    qs, ks = rnd(q * s), rnd(k * s)
    logits = rnd(torch.einsum("nthc,nshc->nhts", qs, ks))
    return qs, ks, logits, rnd(torch.einsum("nthc,nshc->nhts", do, v)), s, rnd


def attn_bwd_dq_plain(qkv, out, gout, num_heads):
    """Plain version of ``attn_bwd_dq``: (dQ [N, T, H, ch], log-sum-exp
    [N, H, T], D [N, H, T]), fp32, ``out`` the forward's output."""
    qs, ks, logits, dp, s, rnd = _attn_bwd_terms(qkv, gout, num_heads)
    (o,), (do,) = _attn_heads(out, num_heads, 1), _attn_heads(gout, num_heads, 1)
    lse = torch.logsumexp(logits, dim=-1)
    d = (do * o).sum(-1).transpose(1, 2)
    ds = rnd(torch.exp(logits - lse[..., None]) * (dp - d[..., None]))
    return torch.einsum("nhts,nshc->nthc", ds, ks) * s, lse, d


def attn_bwd_dkdv_plain(qkv, gout, lse, d, num_heads):
    """Plain version of ``attn_bwd_dkdv``: (dK, dV), each [N, T, H, ch]
    fp32, from the log-sum-exp and D of ``attn_bwd_dq``."""
    qs, ks, logits, dp, s, rnd = _attn_bwd_terms(qkv, gout, num_heads)
    (do,) = _attn_heads(gout, num_heads, 1)
    p = torch.exp(logits - lse[..., None])
    ds = rnd(p * (dp - d[..., None]))
    return torch.einsum("nhts,nthc->nshc", ds, qs) * s, torch.einsum("nhts,nthc->nshc", rnd(p), do)


def attention_bwd_plain(qkv, out, gout, num_heads):
    """The backward of ``attention_qkv`` in closed form, through the
    kernels' workspace (log-sum-exp and D): dqkv in qkv's dtype and layout."""
    dq, lse, d = attn_bwd_dq_plain(qkv, out, gout, num_heads)
    dk, dv = attn_bwd_dkdv_plain(qkv, gout, lse, d, num_heads)
    return torch.stack([dq, dk, dv], dim=3).reshape(qkv.shape).to(qkv.dtype)


def _attn_bwd_check(qkv, gout, num_heads):
    _require_cuda(qkv, "qkv", tuple(_ATTN_DTYPES))
    _require_cuda(gout, "gout", (qkv.dtype,))
    if qkv.ndim != 3 or qkv.shape[-1] % (3 * num_heads):
        raise ValueError(f"qkv {tuple(qkv.shape)} is not [N, T, {num_heads}*3*ch]")
    n, t, width = qkv.shape
    if gout.shape != (n, t, width // 3):
        raise ValueError(f"gout {tuple(gout.shape)} does not fit qkv {tuple(qkv.shape)}")
    ch = width // (3 * num_heads)
    geo = attention_bwd_geometry(n, t, num_heads, ch, qkv.dtype)
    # The Hopper route's tensor maps want 16-byte aligned bases (rows are
    # whole 16-byte units at ch 32, 64 and 128).
    if geo["route"] == "hopper" and (qkv.data_ptr() % 16 or gout.data_ptr() % 16):
        raise ValueError("qkv and gout must be 16-byte aligned")
    return n, t, ch, geo


def _attn_bwd_flops(qkv, n, t, heads, ch, products):
    """The bound's work: ``products`` T^2*ch products (on the bf16 tensor
    cores, or the FMA units in fp32) and about 8 fp32 operations per logit.
    dQ's function needs three (S, dP, dQ), dK and dV's four (S, dP, dV,
    dK): the function's work, whatever a kernel's design repeats."""
    products, elementwise = 2.0 * products * n * heads * t * t * ch, 8.0 * n * heads * t * t
    if qkv.dtype == torch.bfloat16:
        return dict(tensor_flops=products, fp32_flops=elementwise)
    return dict(fp32_flops=products + elementwise)


def attn_bwd_dq_cuda(qkv, out, gout, num_heads, dqkv):
    """Launch ``attn_bwd_dq``: writes dQ into the q columns of ``dqkv``
    (qkv's shape and dtype) and returns the workspace for
    ``attn_bwd_dkdv_cuda``: the fp32 log-sum-exp and D, each [N, H, T], and
    on the Hopper route sQ = rnd(s q) [N, T, H*ch] in bf16 (None on the
    generic route). qkv, out and gout contiguous, of one dtype."""
    n, t, ch, geo = _attn_bwd_check(qkv, gout, num_heads)
    _require_cuda(out, "out", (qkv.dtype,))
    _require_cuda(dqkv, "dqkv", (qkv.dtype,))
    if out.shape != gout.shape or dqkv.shape != qkv.shape:
        raise ValueError(f"out {tuple(out.shape)} or dqkv {tuple(dqkv.shape)} does not fit qkv")
    if geo["route"] == "hopper" and (out.data_ptr() % 16 or dqkv.data_ptr() % 16):
        raise ValueError("out and dqkv must be 16-byte aligned")
    lse = torch.empty((n, num_heads, t), dtype=torch.float32, device=qkv.device)
    d = torch.empty_like(lse)
    sq = torch.empty_like(out) if geo["route"] == "hopper" else None
    lib = _load()
    _check(lib, lib.ishape_attn_bwd_dq(
        qkv.data_ptr(), out.data_ptr(), gout.data_ptr(), dqkv.data_ptr(), lse.data_ptr(), d.data_ptr(),
        None if sq is None else sq.data_ptr(), _ATTN_DTYPES[qkv.dtype], n, t, num_heads, ch,
        geo["out_cols"], _stream(qkv),
    ), "attn_bwd_dq")
    LAUNCHES["attn_bwd_dq"] += 1
    if _records is not None:
        _record("attn_bwd_dq", qkv, _nbytes(qkv, out, gout, lse, d) + _nbytes(dqkv) // 3,
                **_attn_bwd_flops(qkv, n, t, num_heads, ch, products=3))
    return lse, d, sq


def attn_bwd_dkdv_cuda(qkv, gout, lse, d, num_heads, dqkv, sq=None):
    """Launch ``attn_bwd_dkdv``: writes dK and dV into the k and v columns
    of ``dqkv`` from the workspace of ``attn_bwd_dq_cuda`` (lse, d and, on
    the Hopper route, sq)."""
    n, t, ch, geo = _attn_bwd_check(qkv, gout, num_heads)
    _require_cuda(dqkv, "dqkv", (qkv.dtype,))
    for name, w in (("lse", lse), ("d", d)):
        _require_cuda(w, name, (torch.float32,))
        if w.shape != (n, num_heads, t):
            raise ValueError(f"{name} {tuple(w.shape)} is not [{n}, {num_heads}, {t}]")
    if dqkv.shape != qkv.shape:
        raise ValueError(f"dqkv {tuple(dqkv.shape)} does not fit qkv {tuple(qkv.shape)}")
    if geo["route"] == "hopper":
        if sq is None:
            raise ValueError("the Hopper route sweeps the sQ workspace of attn_bwd_dq_cuda")
        _require_cuda(sq, "sq", (torch.bfloat16,))
        if sq.shape != gout.shape:
            raise ValueError(f"sq {tuple(sq.shape)} does not fit gout {tuple(gout.shape)}")
        if dqkv.data_ptr() % 16 or sq.data_ptr() % 16:
            raise ValueError("dqkv and sq must be 16-byte aligned")
    lib = _load()
    _check(lib, lib.ishape_attn_bwd_dkdv(
        qkv.data_ptr(), gout.data_ptr(), lse.data_ptr(), d.data_ptr(),
        None if geo["route"] != "hopper" else sq.data_ptr(), dqkv.data_ptr(),
        _ATTN_DTYPES[qkv.dtype], n, t, num_heads, ch, geo["out_cols"], _stream(qkv),
    ), "attn_bwd_dkdv")
    LAUNCHES["attn_bwd_dkdv"] += 1
    if _records is not None:
        _record("attn_bwd_dkdv", qkv, _nbytes(qkv, gout, lse, d) + 2 * _nbytes(dqkv) // 3,
                **_attn_bwd_flops(qkv, n, t, num_heads, ch, products=4))


def attention_bwd_cuda(qkv, out, gout, num_heads):
    """Both attention backward kernels: dqkv in qkv's dtype and layout."""
    gout = gout.to(qkv.dtype).contiguous()
    dqkv = torch.empty_like(qkv)
    lse, d, sq = attn_bwd_dq_cuda(qkv, out, gout, num_heads, dqkv)
    attn_bwd_dkdv_cuda(qkv, gout, lse, d, num_heads, dqkv, sq=sq)
    return dqkv


class QKVAttention(torch.autograd.Function):
    """Forward: the kernel on CUDA, ``dense_qkv_attention`` on the CPU.
    Backward: on CUDA the backward kernels (``attention_bwd_cuda``, reading
    the forward's output); on the CPU autograd through
    ``dense_qkv_attention``, as the JAX package's VJP."""

    @staticmethod
    def forward(ctx, qkv, num_heads):
        ctx.num_heads = num_heads
        if qkv.is_cuda:
            out = attention_qkv_cuda(qkv, num_heads)
            ctx.save_for_backward(qkv, out)
            return out
        ctx.save_for_backward(qkv, None)
        return dense_qkv_attention(qkv, num_heads)

    @staticmethod
    def backward(ctx, gout):
        qkv, out = ctx.saved_tensors
        with span("attn_bwd"):
            if out is not None:
                return attention_bwd_cuda(qkv, out, gout, ctx.num_heads), None
            qkv = qkv.detach().requires_grad_(True)
            with torch.enable_grad():
                out = dense_qkv_attention(qkv, ctx.num_heads)
            (g,) = torch.autograd.grad(out, qkv, gout)
            return g, None


def attention_qkv(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Fused ADM attention; same contract as ``dense_qkv_attention``
    (qkv [N, T, H*3*ch], per-head q/k/v contiguous; reference: unet.py:328-354)."""
    _check_device(qkv)
    with span("attention"):
        return QKVAttention.apply(qkv, num_heads)


# ---------------------------------------------------------------------------
# Bias epilogue (with the residual add folded in)
# ---------------------------------------------------------------------------

_BIAS_DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # of y, res and out; the biases are fp32
_BIAS_THREADS = 512  # threads per block, at most (the kernel's launch bound)
_BIAS_BLOCKS_PER_SM = 2  # resident at once: one wave of long-lived blocks
_BIAS_MAX_BDX = 512  # channel vectors per block; wider C splits over grid y


def bias_epilogue_plain(y, b, res=None, res_bias=None):
    """The composition the kernel fuses, as eager PyTorch computes it: the
    bias cast to y's dtype, ``y + b``, then ``res + that`` (with ``res +
    res_bias`` first where given), each add in fp32 rounded to the dtype.
    ``b`` None: y is a cut layer's gathered output, its bias already added."""
    h = y if b is None else y + b.to(y.dtype)
    if res is None:
        return h
    if res_bias is not None:
        res = res + res_bias.to(y.dtype)
    return res + h


def bias_vec(c: int, esize: int, ptrs) -> int:
    """Channels per thread of the bias epilogue: the widest vector of 16, 8
    or 4 bytes, or one element, that divides ``c`` and to which every
    address of ``ptrs`` (out, y and res; 0 for an absent tensor) is
    aligned; ``esize`` the bytes of one element. The biases are loaded one
    by one and need no alignment."""
    addr = functools.reduce(operator.or_, ptrs)  # aligned as its least aligned address
    vec = 16 // esize
    while vec > 1 and (c % vec or addr % (vec * esize)):
        vec //= 2
    return vec


@functools.lru_cache(maxsize=None)
def bias_epilogue_geometry(rows: int, c: int, vec: int) -> dict:
    """Launch shape of the bias epilogue (``csrc/bias_epilogue.cu``) on
    [rows, c] with ``vec`` channels per thread: block (bdx, bdy), grid
    (row blocks, channel blocks). Thread (tx, ty) of block (bx, cb) owns
    channel vector cb*bdx + tx and rows bx*bdy + ty + k*row_step, up to
    four 16-byte loads in flight; about ``_BIAS_BLOCKS_PER_SM`` blocks per
    SM in all (one wave), never more row blocks than rows to give them.
    Cached: the UNet asks for the same few shapes every forward (do not
    change the dict)."""
    if c % vec:
        raise ValueError(f"{c} channels are not whole vectors of {vec}")
    vpr = c // vec
    bdx = min(vpr, _BIAS_MAX_BDX)
    bdy = max(1, _BIAS_THREADS // bdx)
    grid_c = -(-vpr // bdx)
    per = -(-(_BIAS_BLOCKS_PER_SM * NUM_SMS) // grid_c)
    grid_x = max(1, min(-(-rows // bdy), per))
    return dict(vec=vec, block=(bdx, bdy), grid=(grid_x, grid_c), row_step=grid_x * bdy)


def bias_epilogue_cuda(y, b, res=None, res_bias=None, out=None):
    """Launch the bias epilogue: ``rnd(y + rnd(b))`` (the plain form,
    ``res`` None), ``rnd(res + rnd(y + rnd(b)))`` or, with ``res_bias``,
    ``rnd(rnd(res + rnd(res_bias)) + rnd(y + rnd(b)))``, rnd the rounding
    to y's dtype: bit-equal to ``bias_epilogue_plain``. y and res: one shape
    [..., C], contiguous, bf16 or fp32, on one card; b and res_bias [C],
    fp32 (the layer's bias as stored). Writes into ``out`` (y itself is
    allowed) or a new tensor. The checks and the launch take a few host
    microseconds: every product of a forward calls it."""
    c, dev, dt = y.shape[-1], y.get_device(), y.dtype
    if dt not in _BIAS_DTYPES or dev < 0 or not y.is_contiguous():
        _require_cuda(y, "y", tuple(_BIAS_DTYPES))
    for name, t in (("b", b), ("res_bias", res_bias)):
        if t is not None and (t.dtype != torch.float32 or t.get_device() != dev or t.numel() != c
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: {t.dtype} [{t.numel()}] on {t.device} for {c} channels of y on {y.device} "
                             f"(fp32, as the layer stores it, contiguous)")
    for name, t in (("res", res), ("out", out)):
        if t is not None and (t.dtype != dt or t.get_device() != dev or t.shape != y.shape
                              or not t.is_contiguous()):
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device} does not fit y, {dt} "
                             f"{tuple(y.shape)} on {y.device} (contiguous)")
    if res_bias is not None and res is None:
        raise ValueError("res_bias needs res")
    if out is None:
        out = torch.empty(y.shape, dtype=dt, device=y.device)
    rows = y.numel() // c if c else 0
    if rows == 0:
        return out
    ptrs = (out.data_ptr(), y.data_ptr(), 0 if res is None else res.data_ptr())
    geo = bias_epilogue_geometry(rows, c, bias_vec(c, y.element_size(), ptrs))
    lib = _lib or _load()
    # the current stream's raw pointer, without the Stream object that
    # torch.cuda.current_stream builds (a forward launches 141 epilogues)
    stream = torch._C._cuda_getCurrentRawStream(dev)
    rc = lib.ishape_bias_epilogue(ptrs[0], ptrs[1], b.data_ptr(), ptrs[2],
                                  None if res_bias is None else res_bias.data_ptr(), _BIAS_DTYPES[dt], rows, c,
                                  geo["vec"], *geo["block"], *geo["grid"], stream)
    if rc:
        _check(lib, rc, "bias_epilogue")
    kernel = "bias_add" if res is None else "bias_residual"
    LAUNCHES[kernel] += 1
    if _records is not None:
        adds = 1 if res is None else 2 if res_bias is None else 3
        _record(kernel, y, _nbytes(y, b, res, res_bias, out), fp32_flops=adds * y.numel())
    return out


def needs_grad(*ts) -> bool:
    """Whether autograd records an op on any of ``ts`` (None skipped)."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def bias_epilogue(y, b, res=None, res_bias=None):
    """``y + b``, or ``res + (y + b)`` (``res + res_bias`` first where
    given), with eager PyTorch's rounding: the biases cast to y's dtype
    (the layer's fp32 bias is passed as stored), one fp32 add per ``+``,
    rounded to the dtype. y is a product that no op has saved (a fresh
    convolution or dense output). A CUDA call that wants no gradient (the
    forwards of sampling, inversion, decoding; in a drag or fit step, the
    time embedding's path) launches the kernel, writing the result into y's
    own buffer, and returns it. Under autograd (drag, fit and train steps),
    on any other device (the CPU; meta, for shape-only forwards) and for
    ``b`` None (a cut layer whose bias was added before its gather): the
    plain composition, whose backward is autograd's. The steps under autograd are paced by the host, and a
    Python autograd Function around the kernel cost them more host time
    than the kernel saved on the card."""
    if b is None or not y.is_cuda or needs_grad(y, b, res, res_bias):
        return bias_epilogue_plain(y, b, res, res_bias)
    y = y.contiguous()
    return bias_epilogue_cuda(y, b, None if res is None else res.contiguous(), res_bias, out=y)
