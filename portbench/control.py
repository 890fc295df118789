"""Read a cell's compared numbers for the program and for its precision
control, on several seeds in one process, at the cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 [--seconds 10] [--share 1]
                                 [--fault chain_half_stuck]

For each seed: the cell's set-up and a short window of its own load (every
unit checked with ``--share 1``), then the numbers of the check twice: on
the program's outputs, and on the reference put in the program's place in
float32 with TF32 matmuls (:mod:`portbench.checks`). ``--fault`` plants a
fault of :mod:`portbench.faults` in the program for the whole run. One
JSON line per seed; the limits in ``limits/<cell>.json`` are set between
the program's largest reading and the control's (or a fault's) smallest.
Needs the card.
"""

import contextlib
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--share", type=float, default=None)
    parser.add_argument("--fault", default=None)
    args = parser.parse_args(argv)
    bench_run._fixed_caches()
    import torch

    from bask_tpu_torch.ops import _cuda
    from bask_tpu_torch.utils.aot import enable_aot_cache
    from portbench import common, core, faults

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    enable_aot_cache(str(bench_run.CACHE / "kernels"))
    _cuda.library()
    bench = core.benchmark()
    cell = core.cell(bench, args.workload)
    cfg, mix = core.config(bench, cell["config"]), core.traffic(cell["traffic"])
    loop = core.loop(mix["loop"])
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = common.Run(args.workload, cfg, mix, seed, args.seconds, dev, None, args.share)
        with faults.FAULTS[args.fault]() if args.fault else contextlib.nullcontext():
            out = loop.run(run)
        del out["state"]
        gc.collect()
        torch.cuda.empty_cache()
        line = {"workload": args.workload, "seed": seed, "fault": args.fault,
                "units": out["attempted"], "failed": out["failed"],
                "checked": out["info"]["checked_units"],
                "program": loop.numbers(out["records"], cfg, mix, "program", dev),
                "tf32": loop.numbers(out["records"], cfg, mix, "tf32", dev),
                "limits": core.limits(args.workload), "seconds": time.perf_counter() - t0}
        print("control: " + json.dumps(line), flush=True)
        del out
        gc.collect()
    return 0


if __name__ == "__main__":
    sys.exit(main())
