"""Where the generic attention kernel's time goes, on one CUDA card.

    python -m ishapediting_tpu_torch.tools.attention_probe

Builds copies of ``csrc/attention_generic.cu`` into ``build/attention_probe/``
(nvcc, one process each, started together) and times them through the same
C entry point, on fresh inputs of batch 2 at the shapes of
``attention_bench.SHAPES`` that take the fast path:

- **ablations**: the kernel with one part commented out (the Q K^T
  products, P V, the softmax, the fp32 3xTF32 split of K/V, the cluster
  split of the keys, and the three compute parts at once), each its device
  time
  (``utils/device.py::device_ms``, profiler, 20 calls). A variant computes
  garbage; only its time means anything.
- **timeline**: the kernel with ``%globaltimer`` read at its start, after
  the prologue's copies are issued, after the first tile has landed, after
  the key loop and at its end; per CTA (mean over CTAs) the time to issue
  the prologue, to wait for the first tile, the key loop and the epilogue.

Prints the card's name and power limit first. Timing only: the kernel is
checked against its plain version by the tests and ``chip_smoke.py``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np
import torch

from ishapediting_tpu_torch.ops import hopper_kernels as hk

OUT_DIR = os.path.join(os.path.dirname(hk.BUILD_DIR), "attention_probe")
# Text of the fast paths that an ablation comments out (every occurrence:
# the TMA, cp.async fp32 and cp.async bf16 lines).
PARTS = {
    "qk": ["qk<KEYS>(p, sq + 16 * warp * st, sql + 16 * warp * st, st, ks, skl, st, chp, lane);",
           "qk<KEYS>(p, sq + 16 * warp * st, st, ks, st, chp, lane);",
           "qk_sw<KEYS>(p, sq, sk + (it % STAGES) * nb * KEYS * 128, chp, warp, lane);"],
    "pv": ["pv<KEYS, NO>(o, p, vs, svl, st, ocols, lane);", "pv<KEYS, NO>(o, p, vs, st, ocols, lane);",
           "pv_sw<KEYS, NO>(o, p, sv + (it % STAGES) * nb * KEYS * 128, lane);"],
    "softmax": ["softmax_step<KEYS, NO, false>(p, o, m, l, k0, Tn, sc, t);",
                "softmax_step<KEYS, NO, true>(p, o, m, l, k0, Tn, sc, t);"],
    "tf32_split": ["split_tile(ks, skl, st, KEYS, chp, sc);", "split_tile(vs, svl, st, KEYS, chp, 1.f);"],
    # no cluster split of the keys (cs stays 1)
    "cluster": ["while (cs < kMaxSplit && 2 * cs * ctas <= kNumSMs / 2 && 4 * cs <= ntiles) cs *= 2;"],
}
COMPUTE = ("qk", "pv", "softmax")
# Timeline probes: (text, the same text with a timer read before or after
# it), at every occurrence (both fast paths).
TIMELINE = [
    ("namespace {\n", "namespace {\n__device__ long long g_tl[4096 * 5];\n"
     "__device__ __forceinline__ long long gtime() {\n"
     "  long long t;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n  return t;\n}\n"
     "__device__ __forceinline__ void probe_record(long long (&tl)[5]) {\n"
     "  __syncthreads();\n"
     "  const int cta = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);\n"
     "  tl[4] = gtime();\n"
     "  if (threadIdx.x == 0 && cta < 4096)\n"
     "    for (int i = 0; i < 5; ++i) g_tl[cta * 5 + i] = tl[i];\n}\n"),
    ("  const int ntiles = (Tn + KEYS - 1) / KEYS;\n",
     "  const int ntiles = (Tn + KEYS - 1) / KEYS;\n  long long tl[5] = {gtime(), 0, 0, 0, 0};\n"),
    ("    for (int it = 0; it < nl; ++it) {\n", "    tl[1] = gtime();\n    for (int it = 0; it < nl; ++it) {\n"),
    ("      cp_async_wait<STAGES - 1>();\n      __syncthreads();\n",
     "      cp_async_wait<STAGES - 1>();\n      __syncthreads();\n      if (it == 0) tl[2] = gtime();\n"),
    ("      mbar_wait(smem_u32(&full[it % STAGES]), (it / STAGES) & 1);\n",
     "      mbar_wait(smem_u32(&full[it % STAGES]), (it / STAGES) & 1);\n      if (it == 0) tl[2] = gtime();\n"),
    ("    if (cs > 1) {\n      combine_store", "    tl[3] = gtime();\n    if (cs > 1) {\n      combine_store"),
    ("                           b, h, cs, rank);\n      return;",
     "                           b, h, cs, rank);\n      probe_record(tl);\n      return;"),
    ("        store1(orow + c, o[n][2 * r] * inv);\n    }\n  }\n}\n",
     "        store1(orow + c, o[n][2 * r] * inv);\n    }\n  }\n  if (!CHUNKED) probe_record(tl);\n}\n"),
]
TIMELINE_GET = ('\nextern "C" int probe_timeline(long long* host, int n) {\n'
                "  return (int)cudaMemcpyFromSymbol(host, g_tl, sizeof(long long) * 5 * n);\n}\n")


def _variants(src: str) -> dict:
    out = {"kernel": src}
    for name, lines in PARTS.items():
        out[f"no_{name}"] = _replace_all(src, [(line, "/* " + line + " */") for line in lines])
    out["no_compute"] = _replace_all(
        src, [(line, "/* " + line + " */") for name in COMPUTE for line in PARTS[name]])
    out["timeline"] = _replace_all(src, TIMELINE) + TIMELINE_GET
    return out


def _replace_all(src: str, pairs) -> str:
    for a, b in pairs:
        if a not in src:
            raise RuntimeError(f"probe point not in the source: {a!r}")
        src = src.replace(a, b)
    return src


def _build(variants: dict) -> dict:
    os.makedirs(OUT_DIR, exist_ok=True)
    nvcc = hk._nvcc()
    procs = {}
    for name, src in variants.items():
        cu = os.path.join(OUT_DIR, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [nvcc, *hk.NVCC_ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-o", os.path.join(OUT_DIR, f"{name}.so"), cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the {name} variant:\n{log}")
        lib = ctypes.CDLL(os.path.join(OUT_DIR, f"{name}.so"))
        p_, i_ = ctypes.c_void_p, ctypes.c_int
        lib.ishape_attention_generic.argtypes = [p_, p_] + [i_] * 6 + [p_]
        libs[name] = lib
    libs["timeline"].probe_timeline.argtypes = [ctypes.c_void_p, ctypes.c_int]
    return libs


def main() -> None:
    from ishapediting_tpu_torch.tools.attention_bench import SHAPES
    from ishapediting_tpu_torch.utils.device import device_ms

    if not torch.cuda.is_available():
        raise SystemExit("attention_probe needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    with open(os.path.join(hk.CSRC_DIR, "attention_generic.cu")) as f:
        libs = _build(_variants(f.read()))
    stream = torch.cuda.current_stream().cuda_stream
    for t, heads, ch, dname in SHAPES:
        dtype = getattr(torch, dname)
        geo = hk.attention_generic_geometry(2, t, heads, ch, dtype)
        if geo["chunked"] or hk.attention_route(dtype, ch) != "attention_generic":
            continue
        gen = torch.Generator(device="cuda").manual_seed(0)
        qkv = torch.randn((2, t, heads * 3 * ch), generator=gen, device="cuda").to(dtype)
        out = torch.empty((2, t, heads * ch), device="cuda", dtype=dtype)
        code = 0 if dtype == torch.float32 else 1

        def launch(lib):
            rc = lib.ishape_attention_generic(qkv.data_ptr(), out.data_ptr(), code, 2, t, heads, ch,
                                              geo["chp"], stream)
            if rc:
                raise RuntimeError(f"launch failed: cudaError {rc}")

        times = {
            name: round(1e3 * device_ms(lambda lib=lib: launch(lib), kernel="attention_generic_kernel"), 2)
            for name, lib in libs.items() if name != "timeline"
        }
        for _ in range(3):
            launch(libs["timeline"])
        torch.cuda.synchronize()
        ctas = geo["grid"][0] * geo["grid"][1] * geo["grid"][2]
        tl = np.zeros(ctas * 5, np.int64)
        libs["timeline"].probe_timeline(tl.ctypes.data, ctas)
        tl = tl.reshape(ctas, 5).astype(np.float64) / 1e3  # us
        phases = dict(
            issue_prologue=np.mean(tl[:, 1] - tl[:, 0]), first_tile=np.mean(tl[:, 2] - tl[:, 1]),
            key_loop=np.mean(tl[:, 3] - tl[:, 1]), epilogue=np.mean(tl[:, 4] - tl[:, 3]),
            cta=np.mean(tl[:, 4] - tl[:, 0]), span=tl[:, 4].max() - tl[:, 0].min(),
        )
        print(f"T={t} H={heads} ch={ch} {dname} ({ctas} CTAs, split {geo['split']}): us per call "
              + ", ".join(f"{k} {v}" for k, v in times.items()) + "; timeline us per CTA (mean): "
              + ", ".join(f"{k} {v:.2f}" for k, v in phases.items()), flush=True)


if __name__ == "__main__":
    main()
