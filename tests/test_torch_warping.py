"""Beta-CDF input warping in the port against the JAX package (float64)
and scipy: warp, warp_grad and unwarp, the incomplete beta function's
fixed-depth continued fraction, the default prior and the parameter
split, and the warped MCMC log-probability (per-walker warped X)."""

import math

import numpy as np
import pytest
import scipy.special as sp
import scipy.stats as st

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from bask_tpu.models import bayesgpr as jbg  # noqa: E402
from bask_tpu.models import gp as jgp  # noqa: E402
from bask_tpu.models import warping as jwp  # noqa: E402
from bask_tpu.ops import kernels as jk  # noqa: E402
from bask_tpu.utils.priors import guess_priors as jax_guess_priors  # noqa: E402
from bask_tpu_torch import convert  # noqa: E402
from bask_tpu_torch.models import bayesgpr as tbg  # noqa: E402
from bask_tpu_torch.models import warping as twp  # noqa: E402
from bask_tpu_torch.utils.priors import guess_priors  # noqa: E402


def _grid_params():
    """x on a grid with both ends, and (a, b) pairs spanning 0.2 .. 5."""
    x = np.concatenate([[0.0, 1e-12, 1.0 - 1e-12, 1.0], np.linspace(0.01, 0.99, 45)])
    ab = np.exp(np.linspace(np.log(0.2), np.log(5.0), 6))
    a, b = (v.ravel() for v in np.meshgrid(ab, ab))
    return x, np.log(a), np.log(b)


def test_warp_matches_jax_and_scipy():
    x, la, lb = _grid_params()
    X = np.repeat(x[:, None], len(la), axis=1)  # column j warped by (a_j, b_j)
    ours = twp.warp(torch.from_numpy(X), torch.from_numpy(la), torch.from_numpy(lb)).numpy()
    ref = np.asarray(jwp.warp(jnp.asarray(X), jnp.asarray(la), jnp.asarray(lb)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-10)
    for j in range(len(la)):
        cdf = st.beta(np.exp(la[j]), np.exp(lb[j])).cdf(x)
        np.testing.assert_allclose(ours[:, j], cdf, rtol=0, atol=1e-10)


def test_warp_grad_matches_jax():
    x, la, lb = _grid_params()
    X = np.repeat(x[:, None], len(la), axis=1)
    ours = twp.warp_grad(torch.from_numpy(X), torch.from_numpy(la), torch.from_numpy(lb)).numpy()
    ref = np.asarray(jwp.warp_grad(jnp.asarray(X), jnp.asarray(la), jnp.asarray(lb)))
    np.testing.assert_allclose(ours, ref, rtol=1e-10, atol=1e-10)


def test_unwarp_matches_jax_and_scipy():
    _, la, lb = _grid_params()
    z = np.linspace(0.01, 0.99, 25)
    Z = np.repeat(z[:, None], len(la), axis=1)
    ours = twp.unwarp(torch.from_numpy(Z), torch.from_numpy(la), torch.from_numpy(lb)).numpy()
    ref = np.asarray(jwp.unwarp(jnp.asarray(Z), jnp.asarray(la), jnp.asarray(lb)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-9)
    for j in range(len(la)):
        ppf = st.beta(np.exp(la[j]), np.exp(lb[j])).ppf(z)
        np.testing.assert_allclose(ours[:, j], ppf, rtol=0, atol=1e-9)
    # round trip through the forward warp
    back = twp.warp(torch.from_numpy(ours), torch.from_numpy(la), torch.from_numpy(lb)).numpy()
    np.testing.assert_allclose(back, Z, atol=1e-9)


@pytest.mark.parametrize(
    "lo,hi,bound", [(0.2, 5.0, 2e-15), (0.05, 20.0, 5e-14), (0.01, 100.0, 2e-11)]
)
def test_betainc_depth_against_scipy(lo, hi, bound):
    """The accuracy of the 48-term continued fraction that the warping
    module states, on random (a, b, x) with exact 0, 1 and tiny x."""
    rng = np.random.RandomState(0)
    a, b = (np.exp(rng.uniform(np.log(lo), np.log(hi), 4000)) for _ in range(2))
    x = rng.uniform(size=4000)
    x[:20], x[20:40], x[40:60] = 0.0, 1.0, 1e-12
    ours = twp.betainc(*(torch.from_numpy(v) for v in (a, b, x))).numpy()
    assert np.abs(ours - sp.betainc(a, b, x)).max() <= bound


def test_per_walker_warp_layout():
    """(W, d) parameters and (n, d) inputs give each walker's own warp."""
    rng = np.random.RandomState(1)
    X = rng.uniform(size=(20, 3))
    LA, LB = 0.4 * rng.randn(4, 3), 0.4 * rng.randn(4, 3)
    ours = twp.warp(torch.from_numpy(X), torch.from_numpy(LA), torch.from_numpy(LB)).numpy()
    assert ours.shape == (4, 20, 3)
    for w in range(4):
        ref = np.asarray(jwp.warp(jnp.asarray(X), jnp.asarray(LA[w]), jnp.asarray(LB[w])))
        np.testing.assert_allclose(ours[w], ref, rtol=0, atol=1e-10)


def test_prior_and_split_match_exactly():
    rng = np.random.RandomState(2)
    la, lb = rng.randn(3), rng.randn(3)
    ours = float(twp.default_warp_log_prior(torch.from_numpy(la), torch.from_numpy(lb)))
    assert ours == float(jwp.default_warp_log_prior(jnp.asarray(la), jnp.asarray(lb)))
    x = np.arange(7.0)
    for t, j in zip(twp.split_warp_params(torch.from_numpy(x), 2), jwp.split_warp_params(jnp.asarray(x), 2)):
        assert t.tolist() == np.asarray(j).tolist()
    # batched rows split along the last axis
    rows = torch.arange(14.0).reshape(2, 7)
    theta, a, b = twp.split_warp_params(rows, 2)
    assert theta.shape == (2, 3) and a.tolist() == [[3.0, 4.0], [10.0, 11.0]]
    assert b.tolist() == [[5.0, 6.0], [12.0, 13.0]]


def test_warped_log_prob_matches_jax():
    """The same (W, n_theta + 2d) positions through both packages' batched
    log-probability with n_warp = d (float64, LAPACK factorizations):
    rtol 1e-9, and -inf in both for a walker whose warped gram is
    singular."""
    rng = np.random.RandomState(3)
    n, n_pad, d, W = 40, 64, 2, 6
    kernel = jk.ConstantKernel(1.0, (0.1, 2.0)) * jk.Matern(
        (0.3, 0.3), (0.05, 2.0), nu=2.5
    ) + jk.WhiteKernel(0.05, (1e-5, 1e5))
    X = np.full((n_pad, d), 0.5)
    X[:n] = rng.uniform(size=(n, d))
    X[30:40] = X[:10]  # duplicates: singular without noise and jitter
    y = np.zeros(n_pad)
    y[:n] = np.sin(4 * X[:n, 0]) + X[:n, 1] + 0.05 * rng.randn(n)
    alpha = np.zeros(n_pad)
    mask = np.arange(n_pad) < n
    pos = np.concatenate(
        [kernel.theta0[None] + 0.2 * rng.randn(W, kernel.n_theta), 0.3 * rng.randn(W, 2 * d)],
        axis=1,
    )
    pos[2, kernel.n_theta - 1] = -200.0  # noise exp(-200) = 0: singular
    data_j = jgp.make_data(*(jnp.asarray(a) for a in (X, y, alpha)), jnp.asarray(mask))
    lp_j = np.asarray(
        jbg._make_log_prob_batch(
            kernel, tuple(jax_guess_priors(kernel)), jwp.default_warp_log_prior, d, data_j
        )(jnp.asarray(pos))
    )
    spec = convert.kernel_spec(kernel)
    data_t = convert.gp_data(X, y, alpha, mask, device="cpu")
    lp_t = tbg._make_log_prob_batch(
        spec, tuple(guess_priors(spec)), data_t, n, twp.default_warp_log_prior, d
    )(torch.from_numpy(pos)).numpy()
    assert lp_j[2] == -math.inf and lp_t[2] == -math.inf
    keep = np.arange(W) != 2
    assert np.isfinite(lp_j[keep]).all()
    np.testing.assert_allclose(lp_t[keep], lp_j[keep], rtol=1e-9)
