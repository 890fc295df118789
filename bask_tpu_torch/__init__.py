"""PyTorch + CUDA port of bask_tpu (fully-Bayesian Bayesian optimization).

The JAX package ``bask_tpu`` is the reference; this package mirrors its
module layout and its top-level names, plus ``evaluate_acquisitions_fused``.
``warmup_optimizer`` builds the kernel library and captures the chain's
CUDA graphs per padding bucket before a loop's first tell;
``enable_aot_cache`` keeps the built library across processes. Its
hand-written CUDA kernels (``csrc/``: the gram kernels K1, K2 and K4, the
base Cholesky K3) build at first use on a CUDA tensor; on the CPU their
plain PyTorch versions run. Entry points place their tensors on the CUDA
card unless the caller names another device. ``BayesSearchCV`` needs
scikit-learn and is imported on first use.
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
from .optimizer import ACQUISITION_FUNC, Optimizer
from .space import Categorical, Integer, Real, Space, normalize_dimensions
from .utils.init_seq import r2_sequence, sb_sequence
from .utils.median import geometric_median
from .utils.priors import construct_default_kernel, guess_priors, make_roundflat
from .utils.progress import get_progress_bar
from .utils.result import create_result, expected_minimum
from .utils.serialization import load_gpr, load_optimizer, save_gpr, save_optimizer
from .utils.aot import disable_aot_cache, enable_aot_cache
from .utils.validation import validate_zeroone
from .utils.warmup import warmup_optimizer

__version__ = "0.6.0"  # the JAX package's

__all__ = [
    "BayesGPR",
    "Optimizer",
    "ACQUISITION_FUNC",
    "evaluate_acquisitions",
    "evaluate_acquisitions_fused",
    "ExpectedImprovement",
    "TopTwoEI",
    "Expectation",
    "LCB",
    "MaxValueSearch",
    "ThompsonSampling",
    "VarianceReduction",
    "PVRS",
    "Space",
    "Real",
    "Integer",
    "Categorical",
    "normalize_dimensions",
    "geometric_median",
    "guess_priors",
    "construct_default_kernel",
    "make_roundflat",
    "r2_sequence",
    "sb_sequence",
    "validate_zeroone",
    "create_result",
    "expected_minimum",
    "warmup_optimizer",
    "enable_aot_cache",
    "disable_aot_cache",
    "__version__",
]


def __getattr__(name):
    # BayesSearchCV pulls in scikit-learn: import it on first use, so the
    # package imports where scikit-learn is not installed
    if name == "BayesSearchCV":
        from .searchcv import BayesSearchCV

        return BayesSearchCV
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
