"""Split R-hat for the hyperposterior chain (host NumPy).

Copied from :mod:`bask_tpu.utils.diagnostics` (only ``split_rhat``, which
``BayesGPR.sample(until_rhat=...)`` uses). Walkers of an ensemble sampler
interact, so treating them as independent chains makes R-hat
approximate, as with emcee's own tooling.
"""

from __future__ import annotations

import numpy as np

__all__ = ["split_rhat"]


def _as3d(chains):
    x = np.asarray(chains, dtype=float)
    if x.ndim == 2:
        x = x[:, :, None]
    if x.ndim != 3:
        raise ValueError(
            f"expected (n_draws, n_chains[, n_dim]), got shape {x.shape}"
        )
    return x


def split_rhat(chains):
    """Split-chain R-hat per dimension: ``(n, m, d) -> (d,)``.

    Each chain is split in half (catching non-stationarity within a
    chain), then the classic between/within variance ratio is computed
    over the ``2m`` half-chains.
    """
    x = _as3d(chains)
    n = x.shape[0] - (x.shape[0] % 2)
    half = n // 2
    if half < 2:
        raise ValueError("need at least 4 draws per chain for split R-hat")
    # (half, 2m, d)
    x = np.concatenate([x[:half], x[half:n]], axis=1)
    chain_means = x.mean(axis=0)  # (2m, d)
    chain_vars = x.var(axis=0, ddof=1)  # (2m, d)
    W = chain_vars.mean(axis=0)
    B = half * chain_means.var(axis=0, ddof=1)
    var_plus = (half - 1) / half * W + B / half
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.sqrt(var_plus / W)
