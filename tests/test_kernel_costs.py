"""The cost models of ``scripts/kernel_costs.py``: the operation counts
that define the bounds of K5 (the pathwise draws' values), K6 (the input
warp) and K7 (its inverse), at the batch ask's shapes."""

import importlib.util
import math
from pathlib import Path

import pytest

pytest.importorskip("torch")

_PATH = Path(__file__).resolve().parent.parent / "scripts" / "kernel_costs.py"
_spec = importlib.util.spec_from_file_location("kernel_costs", _PATH)
costs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(costs)


def test_operation_count():
    """K5's count: 2d + 4 per (query, feature) pair and 2d + 8 per (query,
    point) pair at one column, 2 more a column; 1.22e12 at the batch ask
    with its 1,000 real points."""
    assert costs.k5_operations(1, 1, 1, 0, 15) == 34
    assert costs.k5_operations(1, 1, 0, 1, 15) == 38
    assert costs.k5_operations(1, 1, 1, 1, 15, r=3) == 34 + 38 + 8
    assert abs(costs.k5_operations(256, 65536, 1024, 1000, 15) / 1.2224e12 - 1) < 1e-3


def test_operation_counts():
    """The counts that define K6's and K7's bounds at the batch ask's
    shapes, what the function needs: 160 operations a CDF (3 a term with
    the coefficients made per column); (256, 65,536, 15) warped, 4.08e10;
    a 65,536 x 15 float32 grid unwarped to adjacent floats in 30 bisection
    steps, 4.81e9."""
    assert costs.CDF_OPERATIONS == 160
    assert costs.k6_operations(256 * 65536 * 15) == pytest.approx(4.0769e10, rel=1e-4)
    assert costs.k7_operations(65536 * 15, 30) == pytest.approx(4.8091e9, rel=1e-4)
    assert math.isclose(costs.k6_operations(1, with_pdf=True) - costs.k6_operations(1), 5)
