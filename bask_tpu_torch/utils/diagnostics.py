"""MCMC convergence diagnostics for the hyperposterior chain (host NumPy).

Copied from :mod:`bask_tpu.utils.diagnostics` (NumPy only there too):
split R-hat, which ``BayesGPR.sample(until_rhat=...)`` uses, and the
effective sample size and integrated autocorrelation time that
``BayesGPR.mcmc_diagnostics`` reports. All take ``(n_draws, n_chains,
n_dim)`` arrays. Walkers of an ensemble sampler interact, so treating them
as independent chains makes these estimates approximate, as with emcee's
own tooling.
"""

from __future__ import annotations

import numpy as np

__all__ = ["split_rhat", "effective_sample_size", "integrated_autocorr_time"]


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


def _autocov_fft(x):
    """Per-column autocovariance of (n, ...) along axis 0 via FFT."""
    n = x.shape[0]
    x = x - x.mean(axis=0, keepdims=True)
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x, n=nfft, axis=0)
    acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=0)[:n].real
    return acov / n


def effective_sample_size(chains):
    """ESS per dimension: ``(n, m, d) -> (d,)``.

    Pooled-autocorrelation estimator: per-chain autocovariances are
    averaged, converted to correlations against the pooled variance (so
    persistent between-chain mean differences reduce ESS), and truncated
    with Geyer's initial positive-pair sequence.
    """
    x = _as3d(chains)
    n, m, d = x.shape
    if n < 4:
        raise ValueError("need at least 4 draws for an ESS estimate")
    acov = _autocov_fft(x)  # (n, m, d)
    mean_acov = acov.mean(axis=1)  # (n, d)
    chain_vars = acov[0] * n / (n - 1)  # (m, d)
    W = chain_vars.mean(axis=0)  # (d,)
    chain_means = x.mean(axis=0)  # (m, d)
    if m > 1:
        B_over_n = chain_means.var(axis=0, ddof=1)
        var_plus = (n - 1) / n * W + B_over_n
    else:
        var_plus = (n - 1) / n * W + W / n
    with np.errstate(divide="ignore", invalid="ignore"):
        rho = 1.0 - (W - mean_acov) / var_plus  # (n, d)
    ess = np.empty(d)
    for k in range(d):
        # Geyer pairs: P_t = rho_{2t} + rho_{2t+1}, stop at the first negative
        r = rho[:, k]
        pairs = r[0 : n - 1 : 2] + r[1:n:2]
        tau = -1.0
        prev = np.inf
        for p in pairs:
            if p < 0:
                break
            p = min(p, prev)  # enforce a monotone decrease
            prev = p
            tau += 2.0 * p
        tau = max(tau, 1.0 / np.finfo(float).max)
        ess[k] = n * m / max(tau, 1e-12)
    return np.minimum(ess, n * m * np.ones(d))


def integrated_autocorr_time(chains, c: float = 5.0):
    """emcee-style integrated autocorrelation time: ``(n, m, d) -> (d,)``.

    Normalized per-walker autocorrelations are averaged over walkers and
    summed with Sokal's automatic window (the smallest ``M`` with
    ``M >= c * tau(M)``).
    """
    x = _as3d(chains)
    n, m, d = x.shape
    if n < 4:
        raise ValueError("need at least 4 draws for autocorrelation times")
    acov = _autocov_fft(x)  # (n, m, d)
    with np.errstate(divide="ignore", invalid="ignore"):
        rho = acov / acov[0:1]  # normalize per walker
    f = np.nanmean(rho, axis=1)  # (n, d)
    taus_cum = 2.0 * np.cumsum(f, axis=0) - 1.0
    out = np.empty(d)
    for k in range(d):
        t = taus_cum[:, k]
        window = np.arange(len(t)) >= c * t
        idx = int(np.argmax(window)) if window.any() else len(t) - 1
        out[k] = max(t[idx], 1.0)
    return out
