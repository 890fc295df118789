#!/usr/bin/env python3
"""K6 and K7 of this tree against K6 and K7 built from another tree's
sources, in turns on one card.

Run from the repository root:

    python3 scripts/warp_ab.py OTHER_CSRC [rounds] [NAME=VALUE ...]

``OTHER_CSRC`` is another checkout's ``bask_tpu_torch/csrc``, for example
an earlier commit's unpacked with ``git archive`` into a directory that
``.gitignore`` lists (``git archive <commit> bask_tpu_torch/csrc | tar -x
-C build/parent``, then ``build/parent/bask_tpu_torch/csrc``), or this
tree's own with its tuning constants changed: each ``NAME=VALUE`` turns
``constexpr int NAME = ...;`` of ``warp.cu`` into ``constexpr int NAME =
VALUE;`` (``kK7Entries=2``; a name the source lacks raises). That
``warp.cu``, so changed, is built by one nvcc into a library of its own
(the copy in the build directory); both export ``bask_warp_f32`` and
``bask_unwarp_f32`` with one signature. Four float32 launches on seeded
inputs (``chip_smoke._warp_case``): K6 at the batch ask's queries (256,
65,536, 15) from shared X and at the chain's half-batch (50, 512, 15); K7
at the ask's candidate grid (65,536, 15) and the north-star grid (500,
15), 30 bisection steps over the bit patterns (a ``warp.cu`` older than
that bisection reads its last argument as rounds of 6 halvings of [0, 1]
instead). Each kernel is first held to the float64 plain version
(K6 on four rows of the ask's shape, all of the chain's, within
``WARP_TOL``; K7 on the first 4,096 rows by ``chip_smoke.unwarp_share``);
then both are timed alone (torch.profiler device time, median of 3
launches) in turns: this, other, other, this, ``rounds`` times (2 by
default). Prints the card's name and power limit, the other library's
ptxas report for K6 and K7, and one JSON line per launch with both
medians, their ratio and the bound. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
import kernel_costs  # noqa: E402  (beside this script)

# (kernel, shape of X or Z, rows of log-parameters, seed)
LAUNCHES = [("K6", (cs.BATCH_CAND, cs.N_DIM), (cs.BATCH_K,), 23),
            ("K6", (cs.N_PAD, cs.N_DIM), (cs.N_WALKERS // 2,), 20),
            ("K7", (cs.BATCH_CAND, cs.N_DIM), (), 25),
            ("K7", (cs.N_CAND, cs.N_DIM), (), 24)]
CHECK_ROWS = list(cs.CHECK_DRAWS)
K7_CHECK = 4096
ENTRIES = ("bask_warp_f32", "bask_unwarp_f32")


def build_other(csrc: str, settings):
    """(the library built from ``csrc``'s warp.cu with the ``NAME=VALUE``
    ``settings`` of its constants, nvcc's report)."""
    from bask_tpu_torch.ops import _cuda

    path = os.path.join(csrc, "warp.cu")
    if not os.path.exists(path):
        raise RuntimeError(f"no warp.cu under {csrc}")
    with open(path) as f:
        text = f.read()
    for setting in settings:
        name, value = setting.split("=")
        text, n = re.subn(rf"constexpr int {name} = [^;]+;", f"constexpr int {name} = {value};",
                          text)
        if n != 1:
            raise RuntimeError(f"warp.cu under {csrc} has no one constant {name}")
    _cuda._build_dir.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(text.encode()).hexdigest()[:12]
    source = _cuda._build_dir / f"warp_other_{tag}.cu"
    source.write_text(text)
    so = source.with_suffix(".so")
    proc = subprocess.run(
        [_cuda._nvcc(), _cuda._ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
         "-Xptxas=-v", "-I", csrc, "-o", str(so), str(source)],
        capture_output=True, text=True,
    )
    if proc.returncode:
        raise RuntimeError(f"nvcc failed:\n{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    for entry in ENTRIES:
        getattr(lib, entry).argtypes = _cuda._SIGNATURES[entry]
        getattr(lib, entry).restype = ctypes.c_int
    return lib, proc.stderr


def other_launch(lib, kernel, X, la, lb):
    """The other library's K6 (warp only) or K7 (30 steps) on the
    wrappers' layout of the arguments."""
    import torch

    from bask_tpu_torch.ops import warp_values as wv

    Xk, x_stride, la_, lb_, B, n, d, shape = wv._layout(X, la, lb)
    out = torch.empty(shape, dtype=X.dtype, device=X.device)
    strides = [ctypes.c_longlong(t.stride(0) if B > 1 else 0) for t in (la_, lb_)]
    stream = torch.cuda.current_stream(X.device).cuda_stream
    head = (Xk.data_ptr(), ctypes.c_longlong(x_stride), la_.data_ptr(), strides[0],
            lb_.data_ptr(), strides[1], out.data_ptr())
    if kernel == "K6":
        err = lib.bask_warp_f32(*head, None, B, ctypes.c_longlong(n), d, stream)
    else:
        steps = wv.full_steps(torch.float32)
        err = lib.bask_unwarp_f32(*head, B, ctypes.c_longlong(n), d, steps, stream)
    if err:
        raise RuntimeError(f"the other {kernel} failed: CUDA error {err}")
    return out


def held_to_float64(kernel, launch, X, la, lb):
    """K6: the largest |difference| from the float64 plain version (on
    CHECK_ROWS of a (256, ...) output); K7: the largest share of its limit
    on the first K7_CHECK rows. Returns (number, within the limit)."""
    from bask_tpu_torch.ops import warp_values as wv

    out = launch()
    if kernel == "K6":
        if out.shape[0] > max(CHECK_ROWS):
            out, la, lb = out[CHECK_ROWS], la[CHECK_ROWS], lb[CHECK_ROWS]
        err = float((out.double() - wv.warp_plain(X.double(), la.double(), lb.double()))
                    .abs().max())
        return err, err <= cs.WARP_TOL["float32"]
    z64 = X[:K7_CHECK].double()
    ref = wv.unwarp_plain(z64, la.double(), lb.double())
    share = cs.unwarp_share(out[:K7_CHECK], ref, z64, la, lb, "float32")
    return share, share <= 1.0


def bound(kernel, X, la, lb, entries):
    from bask_tpu_torch.ops import warp_values as wv

    if kernel == "K6":
        n_bytes = 4 * (X.numel() + la.numel() + lb.numel() + entries)
        return cs.bound_ms(n_bytes, kernel_costs.k6_operations(entries))
    n_bytes = 4 * (2 * entries + la.numel() + lb.numel())
    return cs.bound_ms(n_bytes, kernel_costs.k7_operations(entries, wv.full_steps(X.dtype)))


def main() -> int:
    import torch

    from bask_tpu_torch.ops import warp_values as wv

    if not torch.cuda.is_available():
        print("warp_ab.py: no CUDA device available", file=sys.stderr)
        return 1
    args = [a for a in sys.argv[1:] if "=" not in a]
    settings = [a for a in sys.argv[1:] if "=" in a]
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    rounds = int(args[1]) if len(args) > 1 else 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    other, report = build_other(args[0], settings)
    print(json.dumps({"other": args[0], "settings": settings, "other_ptxas": [
        {"entry": e, "registers": r, "spill_bytes": s, "static_smem_bytes": m}
        for e, r, s, m in cs._ptxas_entries("warp_kernel", report)]}), flush=True)

    dev = torch.device("cuda", 0)
    for kernel, shape, rows, seed in LAUNCHES:
        X, la, lb = cs._warp_case(dev, "float32", shape, rows, seed)
        key = "::warp_kernel" if kernel == "K6" else "unwarp_kernel"

        def this(X=X, la=la, lb=lb, kernel=kernel):
            return (wv.warp_values(X, la, lb) if kernel == "K6"
                    else wv.unwarp_values(X, la, lb))

        def that(X=X, la=la, lb=lb, kernel=kernel):
            return other_launch(other, kernel, X, la, lb)

        checks = {"this": held_to_float64(kernel, this, X, la, lb),
                  "other": held_to_float64(kernel, that, X, la, lb)}
        if not all(ok for _, ok in checks.values()):
            raise AssertionError(f"{kernel} at {shape} x {rows} misses float64: {checks}")
        turns = {"this": [], "other": []}
        for _ in range(rounds):
            for name in ("this", "other", "other", "this"):
                us = cs.alone_us(this if name == "this" else that, key, reps=3)
                turns[name].append(None if us is None else us / 1e3)
        med = {k: float(np.median([t for t in v if t is not None])) for k, v in turns.items()}
        entries = int(np.prod(torch.broadcast_shapes(X.shape, la.shape[:-1] + (1, X.shape[-1]))))
        bound_ms, by = bound(kernel, X, la, lb, entries)
        print(json.dumps({
            "kernel": kernel, "shape": list(rows) + list(shape), "entries": entries,
            "card": smi, "alone_ms_turns": turns, "median_ms": med,
            "speedup": med["other"] / med["this"], "bound_ms": bound_ms, "bound_by": by,
            "times_bound": {k: v / bound_ms for k, v in med.items()},
            "float64_check": {k: v[0] for k, v in checks.items()},
            "check_is": "max |err|" if kernel == "K6" else "largest share of the limit",
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
