"""PyTorch + CUDA port of bask_tpu (fully-Bayesian Bayesian optimization).

The JAX package ``bask_tpu`` is the reference; this package mirrors its
module layout. Its hand-written CUDA kernels (``csrc/``: the gram kernels
K1 and K2, the base Cholesky K3) build at first use on a CUDA tensor; on
the CPU their plain PyTorch versions run. Entry points place their
tensors on the CUDA card unless the caller names another device.
"""

from .acquisition import (
    LCB,
    PVRS,
    Expectation,
    ExpectedImprovement,
    MaxValueSearch,
    ThompsonSampling,
    TopTwoEI,
    VarianceReduction,
    evaluate_acquisitions,
    evaluate_acquisitions_fused,
)
from .models.bayesgpr import BayesGPR
from .optimizer import Optimizer
from .space import Categorical, Integer, Real, Space
from .utils.progress import get_progress_bar
from .utils.result import create_result, expected_minimum
from .utils.validation import validate_zeroone

__all__ = [
    "BayesGPR",
    "Optimizer",
    "ExpectedImprovement",
    "TopTwoEI",
    "Expectation",
    "LCB",
    "MaxValueSearch",
    "ThompsonSampling",
    "VarianceReduction",
    "PVRS",
    "evaluate_acquisitions",
    "evaluate_acquisitions_fused",
    "Space",
    "Real",
    "Integer",
    "Categorical",
    "get_progress_bar",
    "create_result",
    "expected_minimum",
    "validate_zeroone",
]
