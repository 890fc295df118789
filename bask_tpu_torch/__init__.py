"""PyTorch + CUDA port of bask_tpu (fully-Bayesian Bayesian optimization).

The JAX package ``bask_tpu`` is the reference; this package mirrors its
module layout. Its two hand-written CUDA kernels (``csrc/``) build at
first use on a CUDA tensor; on the CPU their plain PyTorch versions run.
"""

from .acquisition import PVRS, ExpectedImprovement, evaluate_acquisitions_fused
from .models.bayesgpr import BayesGPR
from .optimizer import Optimizer
from .space import Categorical, Integer, Real, Space
from .utils.validation import validate_zeroone

__all__ = [
    "BayesGPR",
    "Optimizer",
    "ExpectedImprovement",
    "PVRS",
    "evaluate_acquisitions_fused",
    "Space",
    "Real",
    "Integer",
    "Categorical",
    "validate_zeroone",
]
