"""Input validation helpers (capability parity with reference
``bask/utils.py:212-228``)."""

from __future__ import annotations

import numpy as np

__all__ = ["validate_zeroone"]


def validate_zeroone(arr):
    """Raise ValueError unless every entry lies in [0, 1]."""
    arr = np.asarray(arr)
    if np.any(arr < 0) or np.any(arr > 1) or np.any(~np.isfinite(arr)):
        raise ValueError("Not all values of the array are between 0 and 1.")
