#!/usr/bin/env python3
"""What holds K5's tensor-core kernel back: time variants of its source.

Run from the repository root:  python3 scripts/k5_variants.py [rounds]

Each variant is ``csrc/pathwise.cu`` (with ``gram_common.cuh`` pasted
in, and only its nu = 5/2 kernels instantiated) with one part taken out
or changed (a replacement whose text is no longer in the source
raises), built by its own ``nvcc`` (all at once) into the build
directory and loaded with ``ctypes``. A variant that takes work out
computes wrong values; it only shows what that work costs. All run the
batch ask's query launch on ``chip_smoke.k5_synthetic``'s inputs (256
rows x 65,536 queries, 1,024 features, 1,000 of 1,024 points, d 15,
nu 5/2, R 1):

* ``as is``: the kernel, checked against its float64 plain version on
  four rows; also timed with the features alone (no training points)
  and the training points alone (no features);
* ``16 warps a block, stages of 128``: one block of 512 queries per SM
  (16 warps, as two blocks of 8 give), each stage's split shared by twice
  the queries;
* ``no near-pair test``: d2 never formed again from differences;
* ``no Matern``: k_nu replaced by the clamped d2 itself;
* ``no cosine``: the cosine replaced by the reduced argument;
* ``no MMA``: no tensor-core product at all (the accumulators keep
  their initial values);
* ``cosine of the unreduced argument``: ``__cosf`` of 2 pi u, without
  taking the nearest integer off u first;
* ``1 block per SM``: ``__launch_bounds__`` asking for one resident
  block of 8 warps instead of two (up to 255 registers);
* ``4 m-tiles a warp, 1 block per SM``: 64 queries a warp (512 a block),
  each B fragment serving four m-tiles.

Each variant's device time alone (torch.profiler, median of 3 launches)
is taken in turns (as listed, then reversed, ``rounds`` times, 2 by
default). Prints the card's name and power limit, then one JSON line
per variant with its registers and spills. Exits non-zero without a
CUDA card.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

kv = cs._load_script("kernel_variants")
PTXAS_NAME = "pathwise_mma_kernelILi2ELi16ELi1E"

def variants(src: str) -> dict:
    r = kv._replace
    src = r(src, """    p.kernel = nu_code == 0   ? mma_for<0>(d, r)
               : nu_code == 1 ? mma_for<1>(d, r)
               : nu_code == 2 ? mma_for<2>(d, r)
                              : mma_for<3>(d, r);""", "    p.kernel = mma_for<2>(d, r);")
    src = r(src, """    p.kernel = nu_code == 0   ? simt_for<0>(r)
               : nu_code == 1 ? simt_for<1>(r)
               : nu_code == 2 ? simt_for<2>(r)
                              : simt_for<3>(r);""", "    p.kernel = simt_for<2>(r);")
    matern = "acc[mt][e] = matern<kNu>(acc[mt][e] < 0.0f ? 0.0f : acc[mt][e]);"
    lo_mmas = ("        mma_tf32(acc[mt], al[mt][ks], bh[ks]);\n"
               "        mma_tf32(acc[mt], ah[mt][ks], bl[ks]);\n")
    hi_mma = "        mma_tf32(acc[mt], ah[mt][ks], bh[ks]);\n"
    one_block = r(src, "__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")
    wide_block = r(r(r(src, "constexpr int kWarps = 8;", "constexpr int kWarps = 16;"),
                     "constexpr int kStage = 64;", "constexpr int kStage = 128;"),
                   "__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 1)")
    return {
        "as is": src,
        "16 warps a block, stages of 128": wide_block,
        "no near-pair test": r(src, "if (__any_sync(0xffffffffu, near)) {", "if (false) {"),
        "no Matern": r(src, matern, "acc[mt][e] = acc[mt][e] < 0.0f ? 0.0f : acc[mt][e];"),
        "no cosine": r(src, "acc[mt][e] = __cosf(f * kTwoPiF);", "acc[mt][e] = f;"),
        "no MMA": r(r(src, lo_mmas, ""), hi_mma, ""),
        "cosine of the unreduced argument": r(
            src, "const float f = acc[mt][e] - rintf(acc[mt][e]);", "const float f = acc[mt][e];"),
        "1 block per SM": one_block,
        "4 m-tiles a warp, 1 block per SM": r(one_block, "kMT = kD == 16 ? 2 : 1;",
                                              "kMT = kD == 16 ? 4 : 1;"),
    }


def build(sources: dict) -> dict:
    """{name: (library, [(registers, spill bytes)] of the batch ask's
    instantiation)}, one nvcc per variant."""
    from bask_tpu_torch.ops import _cuda

    _cuda._build_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (name, src) in enumerate(sources.items()):
        cu = _cuda._build_dir / f"k5_variant_{i}.cu"
        cu.write_text(src)
        so = cu.with_suffix(".so")
        cmd = [_cuda._nvcc(), _cuda._ARCH, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas=-v", "-o", str(so), str(cu)]
        procs[name] = (so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        lib = ctypes.CDLL(str(so))
        lib.bask_pathwise_values_f32.argtypes = _cuda._SIGNATURES["bask_pathwise_values_f32"]
        lib.bask_pathwise_values_f32.restype = ctypes.c_int
        regs = sorted({(r, s) for _, r, s, _ in cs._ptxas_entries(PTXAS_NAME, err)})
        libs[name] = (lib, regs)
    return libs

def main() -> int:
    import torch

    from bask_tpu_torch.ops import pathwise_values as pv

    if not torch.cuda.is_available():
        print("k5_variants.py: no CUDA device available", file=sys.stderr)
        return 1
    rounds = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    with open(os.path.join(kv.CSRC, "pathwise.cu")) as f:
        libs = build(variants(kv.with_header(f.read())))

    dev = torch.device("cuda", 0)
    args = cs.k5_synthetic(dev, 2.5, cs.BATCH_K, cs.BATCH_CAND)
    nu, Xq, omega, phase, W, coef, X, inv_ls, V, amp = args
    B, M, d = omega.shape
    m = Xq.shape[0]
    out = torch.empty((B, m, 1), dtype=torch.float32, device=dev)

    def launch(lib, t=args, feats=True, points=True):
        _, Xq_, om, ph, W_, c, X_, il, V_, a = t
        err = lib.bask_pathwise_values_f32(
            Xq_.data_ptr(), 0, om.data_ptr(), ph.data_ptr(), W_.data_ptr(), c.data_ptr(),
            X_.data_ptr() if points else None, 0, il.data_ptr(), V_.data_ptr(), a.data_ptr(),
            out.data_ptr(), om.shape[0], m, M if feats else 0, X_.shape[0], d, 1,
            pv._NU_CODE[nu], torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"a K5 variant failed: CUDA error {err}")
        return out

    keep = [0, 85, 170, 255]
    sub = (nu, Xq, *(t[keep] for t in (omega, phase, W, coef)), X,
           *(t[keep] for t in (inv_ls, V, amp)))
    ref = pv.pathwise_values_plain(*(t.double() if torch.is_tensor(t) else t for t in sub))
    got = launch(libs["as is"][0], sub)[:len(keep)].double()
    err = float((got - ref).abs().max())
    if not err <= cs.K5_REL_TOL * float(ref.abs().max()):
        raise AssertionError(f"K5 as is misses float64: {err}")
    del ref, got

    runs = {name: (lambda lib=lib: launch(lib)) for name, (lib, _) in libs.items()}
    runs["as is: features alone"] = lambda: launch(libs["as is"][0], points=False)
    runs["as is: points alone"] = lambda: launch(libs["as is"][0], feats=False)
    turns = {k: [] for k in runs}
    for _ in range(rounds):
        for key in list(runs) + list(runs)[::-1]:
            _, ops = cs.profiled(runs[key], reps=3)
            us = cs.kernel_us(ops, "pathwise_mma_kernel")
            turns[key].append(None if us is None else us / 1e3)
    for key, t in turns.items():
        med = kv._median(t)
        print(json.dumps({
            "variant": key, "alone_ms": med, "alone_ms_turns": t,
            "registers_spills": libs[key.split(":")[0]][1],
            "share_of_as_is": None if med is None else med / kv._median(turns["as is"]),
        }), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
