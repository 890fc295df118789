#!/usr/bin/env python3
"""What NCCL does when two ranks of one process group share one card.

Run from the repository root:  python3 scripts/nccl_two_ranks.py [timeout_s]

Starts two processes; each calls
``bask_tpu_torch.parallel.distributed.init_distributed`` with NCCL on
``cuda:0`` (world size 2), then one ``all_reduce`` of a one-element
tensor. Each process prints one JSON line with what happened (the sum,
or the exception's type and first lines). The parent waits at most
``timeout_s`` seconds (default 90), kills what is left, and prints the
card's name and power limit and one JSON line with both outcomes. The
port does not work around the result: a mesh across processes takes one
card per rank. Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _rank(coord: str, rank: int) -> None:
    import torch

    from bask_tpu_torch.parallel.distributed import init_distributed

    out = {"rank": rank}
    try:
        init_distributed(coord, 2, rank, local_device_ids=[0])
        x = torch.ones(1, device="cuda:0") * (rank + 1)
        torch.distributed.all_reduce(x)
        torch.cuda.synchronize()
        out["all_reduce"] = float(x)
    except Exception as e:  # the outcome is the measurement
        out["error"] = type(e).__name__
        out["message"] = str(e).splitlines()[:6]
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    print(json.dumps(out), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("nccl_two_ranks.py: no CUDA device available", file=sys.stderr)
        return 1
    timeout = float(sys.argv[1]) if len(sys.argv) > 1 else 90.0
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", coord, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    result = []
    for p in procs:
        try:
            text, _ = p.communicate(timeout=timeout)
            code = p.returncode
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
            code = "killed after timeout"
        lines = [ln for ln in text.splitlines() if ln.startswith("{")]
        result.append({"exit": code, "outcome": json.loads(lines[-1]) if lines else None,
                       "tail": text.splitlines()[-8:]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi)
    print(json.dumps({"two_ranks_one_card": result, "torch": torch.__version__,
                      "nccl": ".".join(map(str, torch.cuda.nccl.version()))}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        _rank(sys.argv[2], int(sys.argv[3]))
    else:
        sys.exit(main())
