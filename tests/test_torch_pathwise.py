"""Pathwise draws of the port against the JAX package: a BayesGPR fitted
by JAX at float64 (normalized y; with and without input warping) and
carried into the port by ``convert``, the port's evaluation functions
given JAX's randoms (the frequencies' normals and chi-square draws, the
phases, the feature weights, the noise normals). Both ``sample_mean``
branches of ``thompson_argmin_pathwise``: draws within 1e-8, equal top-k
sets. JAX runs at x64, where ``pathwise_topk_hyper`` takes its vmap
route (ROADMAP queue 3)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bask_tpu.models import pathwise as jpw  # noqa: E402
from bask_tpu.models.bayesgpr import BayesGPR as JaxBayesGPR  # noqa: E402
from bask_tpu.ops import kernels as jk  # noqa: E402
from bask_tpu.ops.pallas_gram import match_fusable as jax_match  # noqa: E402
from bask_tpu_torch import convert  # noqa: E402
from bask_tpu_torch.models import pathwise as tpw  # noqa: E402
from bask_tpu_torch.ops.gram import match_fusable  # noqa: E402

M = 64  # random features
S = 6  # draws
TOL = 1e-8


def _fit(warp):
    rng = np.random.RandomState(0)
    X = rng.uniform(size=(24, 2))
    y = np.sin(5 * X[:, 0]) * np.cos(3 * X[:, 1]) + 0.05 * rng.randn(24)
    kernel = jk.ConstantKernel(1.0, (0.1, 2.0)) * jk.Matern((0.3, 0.3), (0.05, 2.0), nu=2.5)
    gp = JaxBayesGPR(kernel=kernel, normalize_y=True, warp_inputs=warp, random_state=0)
    gp.fit(X, y, n_desired_samples=64, n_burnin=5, n_walkers_per_thread=16,
           progress=False, warn_rhat=None)
    ours = convert.fitted_bayesgpr(
        kernel=gp._spec, theta=gp.theta, chain=gp.chain_, pos=gp.pos_, noise=gp.noise_,
        X=gp._X_orig, y=gp._y_orig, y_mean=gp.y_train_mean_, y_std=gp.y_train_std_,
        alpha=gp.alpha, noise_vector=gp._noise_vector, warp_alphas=gp.warp_alphas_,
        warp_betas=gp.warp_betas_, device="cpu",
    )
    return gp, ours


@pytest.fixture(scope="module")
def models():
    return {False: _fit(False), True: _fit(True)}


GRID = np.random.RandomState(1).uniform(size=(300, 2))


def _jax_randoms(key, spec, d, n_pad, n_samples):
    """The randoms ``bask_tpu.models.pathwise.pathwise_samples`` draws
    from ``key``, in its order, as the port's PathwiseRandoms."""
    k_freq, k_phase, k_w, k_eps = jax.random.split(key, 4)
    kz, ku = jax.random.split(k_freq)
    z = jax.random.normal(kz, (M, d), dtype=jnp.float64)
    u = 2.0 * jax.random.gamma(ku, spec.nu, (M, 1), dtype=jnp.float64)
    phase = jax.random.uniform(k_phase, (M,), dtype=jnp.float64, maxval=2.0 * math.pi)
    w = jax.random.normal(k_w, (M, n_samples), dtype=jnp.float64)
    e = jax.random.normal(k_eps, (n_pad, n_samples), dtype=jnp.float64)
    return tpw.PathwiseRandoms(*(torch.from_numpy(np.array(a)) for a in (z, u, phase, w, e)))


def _stack(rands):
    return tpw.PathwiseRandoms(*(torch.stack(parts) for parts in zip(*rands)))


@pytest.mark.parametrize("warp", [False, True])
def test_consensus_draws_match_jax(models, warp, monkeypatch):
    """pathwise_samples (the sample_mean branch) for JAX's randoms, and
    BayesGPR.sample_y_pathwise / thompson_argmin_pathwise(sample_mean=True)
    with the port's draw function handing over the same randoms."""
    gp, ours = models[warp]
    spec = jax_match(gp._spec)
    seed = 5
    n_pad = gp._data.X.shape[0]
    rand = _jax_randoms(jax.random.PRNGKey(seed), spec, 2, n_pad, S)
    ref = np.asarray(gp.sample_y_pathwise(GRID, n_samples=S, random_state=seed, n_features=M))
    monkeypatch.setattr(ours, "_pathwise_randoms", lambda *a, **k: rand)
    got = ours.sample_y_pathwise(GRID, n_samples=S, random_state=seed, n_features=M)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    idx_j = gp.thompson_argmin_pathwise(GRID, n_samples=S, top_k=5, random_state=seed, n_features=M)
    idx_t = ours.thompson_argmin_pathwise(GRID, n_samples=S, top_k=5, random_state=seed, n_features=M)
    assert idx_t.shape == (S, 5)
    assert [set(r) for r in idx_t] == [set(r) for r in np.asarray(idx_j)]


def _jax_hyper_draws(gp, rows, key):
    """The per-row draws of JAX's pathwise_topk_hyper (its scan body at
    x64: the vmap gram, jnp.linalg.cholesky, pathwise_samples)."""
    from bask_tpu.models import warping as jwp

    spec = jax_match(gp._spec)
    n_warp = gp._X_orig.shape[1] if gp.warp_inputs else 0
    n_gp = rows.shape[1] - 2 * n_warp
    out, rands = [], []
    for row, k in zip(jnp.asarray(rows), jax.random.split(key, rows.shape[0])):
        X, Xq = gp._data.X, jnp.asarray(GRID)
        if n_warp:
            _, la, lb = jwp.split_warp_params(row, n_warp)
            X, Xq = jwp.warp(X, la, lb), jwp.warp(Xq, la, lb)
        d = gp._data._replace(X=X)
        L = jnp.linalg.cholesky(jpw._fused_spec_gram(spec, row[:n_gp], X, gp._data))
        out.append(np.asarray(jpw.pathwise_samples(spec, row[:n_gp], d, L, Xq, k, 1, M))[:, 0])
        rands.append(_jax_randoms(k, spec, 2, X.shape[0], 1))
    return np.stack(out), _stack(rands)


@pytest.mark.parametrize("warp", [False, True])
def test_hyper_draws_and_topk_match_jax(models, warp, monkeypatch):
    """pathwise_topk_hyper given JAX's per-row randoms: every draw within
    1e-8 of JAX's, the top-k sets equal to JAX's pathwise_topk_hyper, and
    BayesGPR.thompson_argmin_pathwise(sample_mean=False) the same."""
    gp, ours = models[warp]
    seed = 11
    rows = gp.chain_[np.random.RandomState(seed).choice(len(gp.chain_), S, replace=True)]
    ref, rand = _jax_hyper_draws(gp, rows, jax.random.PRNGKey(seed))
    spec = match_fusable(ours._spec)
    idx, draws = tpw.pathwise_topk_hyper(
        spec, ours._tensor(rows), ours._data, ours._tensor(GRID), rand, ours._n_warp(), 7,
        keep=range(S),
    )
    np.testing.assert_allclose(draws.numpy(), ref, rtol=0, atol=TOL)
    idx_j = np.asarray(gp.thompson_argmin_pathwise(
        GRID, n_samples=S, top_k=7, random_state=seed, n_features=M, sample_mean=False
    ))
    assert [set(r) for r in idx.numpy()] == [set(r) for r in idx_j]
    monkeypatch.setattr(ours, "_pathwise_randoms", lambda *a, **k: rand)
    got = ours.thompson_argmin_pathwise(
        GRID, n_samples=S, top_k=7, random_state=seed, n_features=M, sample_mean=False
    )
    np.testing.assert_array_equal(got, idx.numpy())


def test_chunks_give_the_per_draw_results(models, monkeypatch):
    """One draw per chunk gives the same draws and top-k as one chunk."""
    gp, ours = models[True]
    rows = ours._tensor(gp.chain_[:S])
    gen = torch.Generator().manual_seed(0)
    spec = match_fusable(ours._spec)
    rand = tpw.draw_pathwise_randoms(gen, spec.nu, M, 2, ours._data.X.shape[0], 1, batch=(S,),
                                     dtype=torch.float64)
    args = (spec, rows, ours._data, ours._tensor(GRID), rand, ours._n_warp(), 5)
    whole = tpw.pathwise_topk_hyper(*args, keep=range(S))
    monkeypatch.setattr(tpw, "CHUNK_BYTES", 1)
    chunked = tpw.pathwise_topk_hyper(*args, keep=range(S))
    np.testing.assert_array_equal(chunked[0].numpy(), whole[0].numpy())
    np.testing.assert_allclose(chunked[1].numpy(), whole[1].numpy(), rtol=0, atol=1e-12)


def test_topk_matches_jax_on_nan_and_ties():
    """A non-PD row gives a NaN draw: JAX's top_k puts NaN last and breaks
    ties by index; the port's selection does the same."""
    rows = np.array([
        [np.nan] * 6,
        [3.0, np.nan, 1.0, 2.0, np.nan, 0.0],
        [1.0, 1.0, 0.0, 1.0, 2.0, 0.0],
        [0.5, -1.0, 2.0, -1.0, 0.0, 3.0],
    ])
    ref = np.asarray(jax.lax.top_k(-jnp.asarray(rows), 3)[1])
    np.testing.assert_array_equal(tpw._topk_min(torch.from_numpy(rows), 3).numpy(), ref)


def test_non_pd_row_gives_nan_draw_and_does_not_raise(models):
    gp, ours = models[False]
    rows = np.array(gp.chain_[:2])
    rows[1, :] = np.nan
    spec = match_fusable(ours._spec)
    rand = tpw.draw_pathwise_randoms(torch.Generator().manual_seed(1), spec.nu, M, 2,
                                     ours._data.X.shape[0], 1, batch=(2,), dtype=torch.float64)
    idx, draws = tpw.pathwise_topk_hyper(spec, ours._tensor(rows), ours._data,
                                         ours._tensor(GRID), rand, 0, 4, keep=[0, 1])
    assert torch.isfinite(draws[0]).all() and torch.isnan(draws[1]).all()
    assert idx[1].tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("nu", [0.5, 1.5, 2.5, math.inf])
def test_chi_square_draws_have_2nu_degrees_of_freedom(nu):
    """u is a sum of 2 nu squared normals: mean 2 nu, variance 4 nu."""
    rand = tpw.draw_pathwise_randoms(torch.Generator().manual_seed(2), nu, 20000, 3, 8, 1,
                                     dtype=torch.float64)
    if math.isinf(nu):
        assert rand.u is None
        return
    u = rand.u.numpy().ravel()
    assert abs(u.mean() - 2 * nu) < 5 * math.sqrt(4 * nu / u.size)
    assert abs(u.var() / (4 * nu) - 1.0) < 0.1
    assert rand.phase.min() >= 0.0 and rand.phase.max() < 2 * math.pi


def test_pathwise_refuses_kernels_outside_the_fused_family(models):
    _, ours = models[False]
    saved = ours._spec
    from bask_tpu_torch.ops import kernels as bk

    ours._spec = bk.RBF(1.0) * bk.RBF(1.0)
    try:
        with pytest.raises(NotImplementedError):
            ours.thompson_argmin_pathwise(GRID, n_samples=2)
    finally:
        ours._spec = saved
