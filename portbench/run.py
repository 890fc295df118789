"""Run one cell of the benchmark of ``bask_tpu_torch`` once, on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (the kernel library, built into
``portbench/.cache/kernels`` on a checkout's first run and loaded after,
the data made from the seed, what the cell's traffic needs) counts as
``setup_s``, from the process's start to the window's first unit. Then
the cell's closed loop runs for ``--seconds`` (to the first unit boundary
after them), the correctness check judges the checked units against the
plain reference once the program's state is freed, and the last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (``--trace 0``: the cell's end-to-end metrics;
``--trace 1``: its per-layer metrics, with spans, one profiler session and
``breakdown``), ``device`` and, last, ``checks`` (each compared number
with its limit, also the last lines of standard error).

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with 2 and prints no result; with JAX or the JAX package loaded once the
window has closed, with 3.
"""

import time

T0 = time.perf_counter()  # the process's start, for setup_s

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "portbench" / ".cache"
MARKS = [("start", T0)]  # the ends of the parts of set-up before the loop's


def _fixed_caches():
    """Every build and kernel cache at a fixed path inside the checkout;
    host math on four threads."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["OMP_NUM_THREADS"] = "4"


def _card_line(torch) -> dict:
    """The card's name and power limit, and the kernel library's build."""
    from bask_tpu_torch.ops import _cuda

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        smi = f"not read ({exc})"
    return {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
            "library_built": _cuda.build_info.get("built"),
            "library_seconds": _cuda.build_info.get("seconds")}


def _launches() -> dict:
    from bask_tpu_torch.ops import chol_base, gram, pathwise_values, warp_values
    from bask_tpu_torch.parallel import mcmc

    counters = {"K1 or K4 (fused_masked_gram_batch)": gram.fused_masked_gram_batch,
                "K2": gram.fused_masked_gram_lower_batch, "K3": chol_base.chol_inv_base,
                "K4": gram.fused_masked_gram_wb_batch, "K5": pathwise_values.pathwise_values,
                "K6": warp_values.warp_values, "K7": warp_values.unwarp_values}
    out = {k: getattr(f, "launches", None) for k, f in counters.items()}
    out["chain_graphs"] = dict(mcmc.graph_stats)
    return out


def run_cell(cell_name: str, seed: int, seconds: float, trace: bool, device, cfg=None,
             mix=None, sample_share=None, side="program", entry=None) -> dict:
    """One run of a cell on ``device``: the result line's object, with
    the earlier lines' facts under ``"info"``. ``cfg`` and ``mix`` replace
    the cell's files (the tests' small sizes), ``entry`` its entry in
    ``BENCHMARK.json`` (a cell it does not list); ``side="tf32"`` judges the
    precision control in the program's place. The mix names its loop
    (``loops/<loop>.py``). Measures nothing about a device it is not
    given: :func:`main` asks for the card."""
    import torch

    from portbench import common, core

    device = torch.device(device)
    bench = core.benchmark()
    cell = entry or core.cell(bench, cell_name)
    cfg = cfg or core.config(bench, cell["config"])
    mix = mix or core.traffic(cell["traffic"])
    limits = core.limits(cell_name)
    tracer = core.Tracer(torch) if trace else None
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    loop = core.loop(mix["loop"])
    run = common.Run(cell_name, cfg, mix, seed, seconds, device, tracer, sample_share)
    out = loop.run(run)
    setup_s = run.window.t0 - T0
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    marks = MARKS + run.marks + [("window", run.window.t0)]
    info = {"loop": out["info"], "launches": _launches(), "window": run.window.counted,
            "host": run.window.host,
            "setup_parts_s": {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}}
    del out["state"]
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = loop.numbers(out["records"], cfg, mix, side, device)
    correct = all(v <= limits[k] for k, v in numbers.items())  # NaN fails
    checked = {k: {"value": v if v == v else None, "limit": limits[k]}
               for k, v in numbers.items()}
    if trace:
        tr = core.Trace(tracer, out["attempted"], cfg, mix)
        metrics = {}
        for m in core.cell_metrics(bench, "per_layer", cell_name):
            value = core.metric_reader(m["name"])(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        info["spans"] = tr.spans
        info["counts"] = tr.counts
    else:
        values = {"setup_s": setup_s, **out["metrics"]}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in core.cell_metrics(bench, "end_to_end", cell_name)}
    device_info = {"platform": "gpu" if on_card else device.type,
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"], device_info["window_s"] = tr.busy_s, tr.window_s
        if tr.window_s:
            result["breakdown"] = tr.breakdown()
    result["checks"] = checked
    result["info"] = info
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _fixed_caches()
    sys.path.insert(0, str(ROOT))
    import torch

    import bask_tpu_torch  # noqa: F401
    from portbench import core

    MARKS.append(("imports", time.perf_counter()))
    chips = core.cell(core.benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from bask_tpu_torch.ops import _cuda
    from bask_tpu_torch.utils.aot import enable_aot_cache

    enable_aot_cache(str(CACHE / "kernels"))
    torch.cuda.init()
    MARKS.append(("card", time.perf_counter()))
    _cuda.library()
    MARKS.append(("kernel library", time.perf_counter()))
    print("card: " + json.dumps(_card_line(torch)), flush=True)
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    loaded = core.forbidden_loaded(sys.modules)
    if loaded:
        print(f"portbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    print("info: " + json.dumps(result.pop("info"), default=float), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
