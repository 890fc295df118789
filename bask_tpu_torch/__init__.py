"""PyTorch + CUDA port of bask_tpu (fully-Bayesian Bayesian optimization).

The JAX package ``bask_tpu`` is the reference; this package mirrors its
module layout. Its hand-written CUDA kernels (``csrc/``: the gram kernels
K1 and K2, the base Cholesky K3) build at first use on a CUDA tensor; on
the CPU their plain PyTorch versions run. Entry points place their
tensors on the CUDA card unless the caller names another device.
``BayesSearchCV`` needs scikit-learn and is imported on first use.
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


def __getattr__(name):
    # BayesSearchCV pulls in scikit-learn: import it on first use, so the
    # package imports where scikit-learn is not installed
    if name == "BayesSearchCV":
        from .searchcv import BayesSearchCV

        return BayesSearchCV
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
