"""The port's ensemble moves given the random numbers the JAX package
draws (rebuilt here from the same keys, split as parallel/mcmc.py splits
them) give the same positions, log-probs and acceptances; the demix
mixture samples a Gaussian target; move specs parse alike."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bask_tpu.models.bayesgpr import _canonical_moves as jax_moves  # noqa: E402
from bask_tpu.parallel import mcmc as jm  # noqa: E402
from bask_tpu_torch.models.bayesgpr import _canonical_moves  # noqa: E402
from bask_tpu_torch.parallel import mcmc as tm  # noqa: E402

D = 4
_A = np.random.RandomState(0).randn(D, D)
PREC = _A @ _A.T / D + np.eye(D)  # precision of the Gaussian target


def lp_jax(x):
    # the support x_0 < 1.5 puts -inf proposals on the path
    q = -0.5 * jnp.einsum("wi,ij,wj->w", x, PREC, x)
    return jnp.where(x[:, 0] < 1.5, q, -jnp.inf)


def lp_torch(x):
    q = -0.5 * torch.einsum("wi,ij,wj->w", x, torch.from_numpy(PREC), x)
    return torch.where(x[:, 0] < 1.5, q, -torch.inf)


def _halves(seed, h=12):
    rng = np.random.RandomState(seed)
    active = 0.5 * rng.randn(h, D)
    other = 0.5 * rng.randn(h, D)
    return active, other


def _compare(jax_out, torch_out):
    ja, jl, jacc = (np.asarray(v) for v in jax_out)
    ta, tl, tacc = torch_out
    np.testing.assert_allclose(ta.numpy(), ja, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-12)
    assert int(tacc) == int(jacc)
    assert 0 < int(jacc) < len(jl)  # both outcomes exercised


def test_stretch_half_update_matches_jax():
    active, other = _halves(1)
    h, c = len(active), len(other)
    key = jax.random.PRNGKey(3)
    k_partner, k_z, k_accept = jax.random.split(key, 3)
    draws = tuple(
        torch.tensor(np.asarray(v))
        for v in (
            jax.random.randint(k_partner, (h,), 0, c),
            jax.random.uniform(k_z, (h,), dtype=jnp.float64),
            jax.random.uniform(k_accept, (h,), dtype=jnp.float64),
        )
    )
    lp_a = lp_jax(jnp.asarray(active))
    ref = jm._half_update(lp_jax, jnp.asarray(active), lp_a, jnp.asarray(other), key, 2.0, D)
    ours = tm.stretch_half_update(
        lp_torch, torch.from_numpy(active), torch.tensor(np.asarray(lp_a)),
        torch.from_numpy(other), draws, 2.0,
    )
    _compare(ref, ours)


@pytest.mark.parametrize("gamma", [2.38 / (2.0 * D) ** 0.5, 1.0])
def test_de_half_update_matches_jax(gamma):
    active, other = _halves(2)
    h, c = len(active), len(other)
    key = jax.random.PRNGKey(5)
    k_j, k_k, k_eps, k_accept = jax.random.split(key, 4)
    draws = tuple(
        torch.tensor(np.asarray(v))
        for v in (
            jax.random.randint(k_j, (h,), 0, c),
            jax.random.randint(k_k, (h,), 0, c - 1),
            jax.random.normal(k_eps, (h, D), dtype=jnp.float64),
            jax.random.uniform(k_accept, (h,), dtype=jnp.float64),
        )
    )
    lp_a = lp_jax(jnp.asarray(active))
    ref = jm._de_half_update(
        lp_jax, jnp.asarray(active), lp_a, jnp.asarray(other), key, gamma, 1e-5
    )
    ours = tm.de_half_update(
        lp_torch, torch.from_numpy(active), torch.tensor(np.asarray(lp_a)),
        torch.from_numpy(other), draws, gamma, 1e-5,
    )
    _compare(ref, ours)


def test_snooker_half_update_matches_jax():
    active, other = _halves(3)
    h, c = len(active), len(other)
    key = jax.random.PRNGKey(7)
    k_z, k_z1, k_z2, k_accept = jax.random.split(key, 4)
    draws = tuple(
        torch.tensor(np.asarray(v))
        for v in (
            jax.random.randint(k_z, (h,), 0, c),
            jax.random.randint(k_z1, (h,), 0, c - 1),
            jax.random.randint(k_z2, (h,), 0, c - 2),
            jax.random.uniform(k_accept, (h,), dtype=jnp.float64),
        )
    )
    lp_a = lp_jax(jnp.asarray(active))
    ref = jm._snooker_half_update(
        lp_jax, jnp.asarray(active), lp_a, jnp.asarray(other), key, 1.7
    )
    ours = tm.snooker_half_update(
        lp_torch, torch.from_numpy(active), torch.tensor(np.asarray(lp_a)),
        torch.from_numpy(other), draws, 1.7,
    )
    _compare(ref, ours)


def test_demix_samples_gaussian_target():
    """The DE 0.8 + snooker 0.2 mixture (the default at W >= 6) recovers
    the target's mean and covariance."""

    def lp(x):
        return -0.5 * torch.einsum("wi,ij,wj->w", x, torch.from_numpy(PREC), x)

    pos0 = torch.from_numpy(0.01 * np.random.RandomState(4).randn(64, D))
    chain, final = tm.run_ensemble(
        lp, pos0, seed=11, n_steps=800, moves=_canonical_moves("demix")
    )
    assert chain.shape == (800, 64, D)
    acc = int(final.accepted) / (800 * 64)
    assert 0.1 < acc < 0.9
    flat = tm.flatten_chain(chain, discard=300, thin=5).numpy()
    cov = np.linalg.inv(PREC)
    np.testing.assert_allclose(flat.mean(0), 0.0, atol=0.15)
    np.testing.assert_allclose(np.cov(flat.T), cov, atol=0.12 * np.abs(cov).max())


def test_stretch_chain_is_reproducible():
    pos0 = torch.from_numpy(0.1 * np.random.RandomState(5).randn(16, D))
    a, fa = tm.run_ensemble(lp_torch, pos0, seed=3, n_steps=20)
    b, fb = tm.run_ensemble(lp_torch, pos0, seed=3, n_steps=20)
    assert torch.equal(a, b) and int(fa.accepted) == int(fb.accepted)


@pytest.mark.parametrize(
    "spec", ["auto", None, "stretch", "de", "demix", "tri", "demix:jump=0.2",
             (("de", 3.0), ("snooker", 1.0))],
)
def test_move_specs_parse_like_jax(spec):
    assert _canonical_moves(spec) == jax_moves(spec)


def test_bad_move_specs_raise():
    for spec in ("leapfrog", "de:jump=2", "demix:nope=1"):
        with pytest.raises(ValueError):
            _canonical_moves(spec)
    with pytest.raises(ValueError):
        tm.validate_walker_count(4, (("snooker", 1.0),))
