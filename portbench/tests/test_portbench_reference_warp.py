"""The reference's Beta-CDF warp against SciPy's incomplete beta."""

import numpy as np
import pytest
import scipy.special
import torch

from portbench.reference import warp


def _grid(seed, size):
    r = np.random.default_rng(seed)
    a = np.exp(r.uniform(np.log(0.05), np.log(20.0), size))
    b = np.exp(r.uniform(np.log(0.05), np.log(20.0), size))
    x = r.uniform(0.0, 1.0, size)
    x[:8] = [0.0, 1.0, 1e-300, 1e-12, 1.0 - 1e-12, 0.5, 1e-6, 1.0 - 1e-6]
    return a, b, x


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_betainc_matches_scipy_in_float64(seed):
    """a, b in [0.05, 20] (the warp prior's 5-sigma box, a, b in [0.22,
    4.5], inside it) and x in [0, 1], edges included."""
    a, b, x = _grid(seed, 20000)
    got = warp.betainc(*(torch.tensor(v) for v in (a, b, x))).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, scipy.special.betainc(a, b, x), rtol=0, atol=1e-13)


@pytest.mark.parametrize("log_ab", [-1.5, 0.0, 1.5])
def test_betainc_at_the_prior_edges(log_ab):
    """The prior's 5 sigma on both log-parameters at once, over x."""
    x = np.linspace(0.0, 1.0, 1001)
    a = torch.full((x.size,), float(np.exp(log_ab)), dtype=torch.float64)
    got = warp.betainc(a, 1.0 / a, torch.tensor(x)).numpy()
    want = scipy.special.betainc(np.exp(log_ab), np.exp(-log_ab), x)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-13)


def test_float32_stays_float32():
    x = torch.rand(64, 3)
    out = warp.warp(x, torch.zeros(3), torch.zeros(3))
    assert out.dtype == torch.float32
    torch.testing.assert_close(out, x, rtol=0, atol=1e-6)  # a = b = 1 is the identity


def test_warp_broadcasts_one_warp_per_row_of_draws():
    X = torch.rand(50, 4, dtype=torch.float64)
    la, lb = 0.3 * torch.randn(6, 4, dtype=torch.float64), 0.3 * torch.randn(6, 4, dtype=torch.float64)
    out = warp.warp(X, la, lb)
    assert out.shape == (6, 50, 4)
    want = scipy.special.betainc(np.exp(la.numpy())[:, None], np.exp(lb.numpy())[:, None],
                                 X.numpy()[None])
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-13)


def test_an_entry_that_does_not_converge_reads_nan(monkeypatch):
    monkeypatch.setattr(warp, "MAX_TERMS", 2)
    out = warp.betainc(torch.tensor([15.0]), torch.tensor([18.0]), torch.tensor([0.4]))
    assert torch.isnan(out).all()
