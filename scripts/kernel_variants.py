#!/usr/bin/env python3
"""What holds the kernels K1 and K3 back: time variants of their sources.

Run from the repository root:  python3 scripts/kernel_variants.py [batch]

With ``batch``, K1 and K4 run at the batch ask's (256, 1024, 1024) on its
data (chip_smoke.batch_dataset, 1,000 points padded to 1,024) with 8
walkers per unit, instead of the chain's shape below.

Each variant is a kernel's source with one part taken out or changed,
built by its own ``nvcc`` (all at once) into ``bask_tpu_torch/_build/``
and loaded with ``ctypes``. A variant that takes work out computes
wrong values; it only shows what that work costs.

K1 (``csrc/gram.cu``) at the chain's shape (50, 512, 512), d = 15,
nu = 5/2, shared X:

* ``as is``: the kernel, checked against its float64 plain version;
* ``no store``: the output stored only where an impossible value comes
  out, so the write (the kernel's bytes bound) all but disappears;
* ``no exp, no sqrt``: the Matern value replaced by d2 itself;
* ``fast exp``: ``__expf`` (``ex2.approx``) for every ``expf``;
* ``2 blocks per SM``: ``__launch_bounds__`` asking for two resident
  blocks instead of three (more registers, fewer warps).

K4 (``csrc/gram_wb.cu``, ``gram_wb_kernel``) at K1's shape and inputs,
5 walkers per unit:

* ``as is``: the kernel, checked against its float64 plain version;
* ``no store``: no TMA store issued (the epilogue still fills the
  staging tiles), so the write all but disappears;
* ``no exp, no sqrt``: the Matern value replaced by d2 itself;
* ``one-pass TF32``: the cross term as hi.hi alone (one MMA for three);
* ``no MMA``: no tensor-core product at all (the dot stays 0);
* ``no store wait``: no wait for the stores of the step before (the
  staging tiles may be overwritten while they drain).

K3 (``csrc/chol_base.cu``) at (50, 128, 128):

* ``as is``: the kernel, checked against its float64 plain version;
* ``no R update``: the steps update the trailing matrix but not the
  residual that becomes L^-1;
* ``no updates``: the steps only publish the pivot column, pass the
  barrier and take the pivot's rsqrt;
* ``no steps``: the block loads its matrix and stores it.

Each variant's device time alone (torch.profiler, median of 30
launches) is taken in turns (as listed, then reversed, twice). Prints
the card's name and power limit, then one JSON line per variant. Exits
non-zero without a CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

ROUNDS = 2
WB = 5  # K4's walkers per unit (8 with ``batch``)
CSRC = os.path.join(os.path.dirname(os.path.abspath(cs.__file__)), "bask_tpu_torch", "csrc")


def _median(times):
    """The median of the turns that recorded the kernel (a profiler session
    can come back empty on the card; PERF.md section 7), or None."""
    seen = [t for t in times if t is not None]
    return float(np.median(seen)) if seen else None


def _replace(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"the kernel source changed: {old!r} not found")
    return src.replace(old, new)


def gram_variants(src: str) -> dict:
    matern = "__device__ __forceinline__ float matern(float d2) {"
    store = (
        "    *reinterpret_cast<float4*>(ob + (long long)row * n_pad + col) =\n"
        "        make_float4(v[0], v[1], v[2], v[3]);"
    )
    return {
        "as is": src,
        "no store": _replace(src, store, "    if (v[0] + v[1] + v[2] + v[3] == -12345.0f)\n" + store),
        "no exp, no sqrt": _replace(src, matern, matern + "\n  return d2;"),
        "fast exp": _replace(src, "#include <cuda_runtime.h>",
                             "#include <cuda_runtime.h>\n#define expf __expf"),
        "2 blocks per SM": _replace(src, "__launch_bounds__(kThreads, 3)",
                                    "__launch_bounds__(kThreads, 2)"),
    }


def gram_wb_variants(src: str) -> dict:
    matern = "__device__ __forceinline__ float matern(float d2) {"
    store = '  asm volatile(\n      "cp.async.bulk.tensor.3d'
    return {
        "as is": src,
        "no store": _replace(src, store, "  if (b >= 0) return;\n" + store),
        "no exp, no sqrt": _replace(src, matern, matern + "\n  return d2;"),
        "one-pass TF32": _replace(src, "if (!kOnePass) {", "if (false) {"),
        "no MMA": _replace(_replace(src, "if (!kOnePass) {", "if (false) {"),
                           "            mma_tf32(acc[mt][nt], ah[mt], bh[nt]);\n", ""),
        "no store wait": _replace(src, "      bulk_wait_read_all();", ""),
    }


def with_header(src: str) -> str:
    """A source with ``gram_common.cuh`` pasted in, so that a variant is
    one file and its edits reach the shared epilogue."""
    with open(os.path.join(CSRC, "gram_common.cuh")) as f:
        return _replace(src, '#include "gram_common.cuh"', f.read())


def chol_variants(src: str) -> dict:
    m_update = (
        "          M[a][b] = fmaf(-ca, cb, M[a][b]);\n"
    )
    r_update = (
        "          R[a][b] = fmaf(-ca, xb, R[a][b]);\n"
    )
    steps = "      if (j >= m) break;"
    no_r = _replace(src, r_update, "")
    return {
        "as is": src,
        "no R update": no_r,
        "no updates": _replace(no_r, m_update, ""),
        "no steps": _replace(src, steps, "      if (j >= 0) break;"),
    }


# what each kernel's name holds: in the profiler's events, and in ptxas's
# (mangled) report, where "gram_kernel" alone would also be K2's
NAMES = {"K1": "gram_kernel", "K3": "chol_inv_kernel", "K4": "gram_wb_kernel"}
PTXAS_NAMES = {**NAMES, "K1": "11gram_kernelILb0"}


def build(variants: dict) -> dict:
    """{(kernel, name): (library, [(registers, spill bytes)] of the
    kernel's entries)}, one nvcc per variant."""
    from bask_tpu_torch.ops import _cuda

    _cuda._BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (key, src) in enumerate(variants.items()):
        cu = _cuda._BUILD / f"variant_{i}.cu"
        cu.write_text(src)
        so = cu.with_suffix(".so")
        cmd = [_cuda._nvcc(), _cuda._ARCH, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas=-v", "-o", str(so), str(cu)]
        procs[key] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE, text=True))
    libs = {}
    for key, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{err}")
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _cuda._SIGNATURES.items():
            if hasattr(lib, name):
                getattr(lib, name).argtypes = argtypes
                getattr(lib, name).restype = ctypes.c_int
        regs = sorted({(r, s) for _, r, s, _ in cs._ptxas_entries(PTXAS_NAMES[key[0]], err)})
        libs[key] = (lib, regs)
    return libs


def main() -> int:
    import torch

    from bask_tpu_torch.ops import chol_base, gram
    from bask_tpu_torch.ops import kernels as bk

    if not torch.cuda.is_available():
        print("kernel_variants.py: no CUDA device available", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    with open(os.path.join(CSRC, "gram.cu")) as f:
        src = with_header(f.read())
    with open(os.path.join(CSRC, "gram_wb.cu")) as f:
        wb_src = with_header(f.read())
    variants = {("K1", k): v for k, v in gram_variants(src).items()}
    variants.update({("K4", k): v for k, v in gram_wb_variants(wb_src).items()})
    with open(os.path.join(CSRC, "chol_base.cu")) as f:
        variants.update({("K3", k): v for k, v in chol_variants(f.read()).items()})
    libs = build(variants)

    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    batch = sys.argv[1:2] == ["batch"]
    B = cs.BATCH_WALKERS if batch else cs.N_WALKERS // 2
    n_pad = cs.BATCH_PAD if batch else cs.N_PAD
    n_obs = cs.BATCH_OBS if batch else cs.N_OBS
    wb = 8 if batch else WB

    def check(err):
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")

    # K1's inputs
    X = cs.batch_dataset()[0] if batch else cs.bench_dataset()[0]
    Xp = np.full((n_pad, cs.N_DIM), 0.5)
    Xp[:n_obs] = X
    Xd = torch.tensor(Xp, dtype=torch.float32, device=dev)
    alpha = torch.full((n_pad,), 1e-6, dtype=torch.float32, device=dev)
    kernel = cs.bench_kernel(bk, 2.5)
    spec = gram.match_fusable(kernel)
    th = torch.tensor(kernel.theta0[None] + 0.2 * np.random.RandomState(0).randn(B, kernel.n_theta),
                      dtype=torch.float32, device=dev)
    K = torch.empty((B, n_pad, n_pad), dtype=torch.float32, device=dev)
    # K3's inputs
    m = 128
    B3 = cs.N_WALKERS // 2  # K3 at (50, 128, 128) either way
    A = torch.tensor(cs._spd_batch(np.random.RandomState(0), B3, m), dtype=torch.float32, device=dev)
    L = torch.empty_like(A)
    Linv = torch.empty_like(A)

    K4 = torch.empty_like(K)

    def launch(key):
        lib = libs[key][0]
        if key[0] == "K1":
            return lambda: check(lib.bask_gram_f32(
                th.data_ptr(), th.stride(0), 1, 1, cs.N_DIM, Xd.data_ptr(), 0,
                alpha.data_ptr(), n_obs, B, n_pad, cs.N_DIM, 2, K.data_ptr(), stream,
            ))
        if key[0] == "K4":
            return lambda: check(lib.bask_gram_wb_f32(
                th.data_ptr(), th.stride(0), 1, 1, cs.N_DIM, Xd.data_ptr(), 0,
                alpha.data_ptr(), n_obs, B, n_pad, cs.N_DIM, 2, wb, K4.data_ptr(), stream,
            ))
        return lambda: check(lib.bask_chol_inv_f32(
            A.data_ptr(), A.stride(0), A.stride(1), L.data_ptr(), Linv.data_ptr(), B3, m, stream,
        ))

    launch(("K1", "as is"))()
    launch(("K4", "as is"))()
    rows = [0, B // 3, 2 * B // 3, B - 1]
    ref = gram.fused_masked_gram_plain(spec, th[rows].double(), Xd.double(), alpha.double(), n_obs)
    for name, out in (("K1", K), ("K4", K4)):
        if float((out[rows].double() - ref).abs().max()) > 4e-6 * float(ref.abs().max()):
            raise AssertionError(f"{name} as is disagrees with its plain version")
    launch(("K3", "as is"))()
    Lr, _ = chol_base.chol_inv_plain(A.double())
    if float((L.double() - Lr).abs().max()) > 2e-5:
        raise AssertionError("K3 as is disagrees with the float64 factor")

    del ref
    bounds = {"K1": cs.gram_bound(B, n_pad, cs.N_DIM),
              "K3": cs.bound_ms(4 * B3 * (m * (m + 1) // 2 + 2 * m * m), B3 * 2 * m**3 / 3)}
    bounds["K4"] = bounds["K1"]
    times = {key: [] for key in libs}
    order = list(libs) + list(libs)[::-1]
    for _ in range(ROUNDS):
        for key in order:
            _, ops = cs.profiled(launch(key), reps=30)
            times[key].append(cs.kernel_us(ops, NAMES[key[0]]))
    for key, (_, regs) in libs.items():
        bound, by = bounds[key[0]]
        print(json.dumps({"kernel": key[0], "variant": key[1], "alone_us_turns": times[key],
                          "median_us": _median(times[key]),
                          "registers_and_spill_bytes": regs,
                          "bound_us": bound * 1e3, "bound_by": by,
                          "shape": [B, n_pad, n_pad] if key[0] != "K3" else [cs.N_WALKERS // 2, m, m],
                          **({"wb": wb} if key[0] == "K4" else {})}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
