"""The benchmark of ``bask_tpu_torch`` (the PyTorch and CUDA port) on
NVIDIA H100 cards: ``python3 portbench/run.py --workload <cell> ...``."""
