"""bask_tpu_torch kernel specs against bask_tpu.ops.kernels at float64:
theta layout, full and cross grams, diagonals, batched theta, and the
White-summand index; general-nu Matern, Exponentiation and
CompoundKernel among them, which the fused gram kernel does not take."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from bask_tpu.ops import kernels as jk  # noqa: E402
from bask_tpu_torch import convert  # noqa: E402
from bask_tpu_torch.ops import gram  # noqa: E402
from bask_tpu_torch.ops import kernels as tk  # noqa: E402

SPECS = [
    jk.ConstantKernel(1.3, (0.1, 2.0)),
    jk.WhiteKernel(0.7, (1e-5, 1e5)),
    jk.RBF(0.4, (0.1, 1.0)),
    jk.RBF((0.4, 0.2, 0.9), (0.1, 1.0)),
    jk.Matern(0.5, (0.1, 1.0), nu=0.5),
    jk.Matern((0.5, 0.3, 0.7), (0.1, 1.0), nu=1.5),
    jk.Matern(0.5, (0.1, 1.0), nu=2.5),
    jk.ConstantKernel(1.5, (0.1, 2.0)) * jk.Matern((0.3, 0.3, 0.3), (0.2, 0.5), nu=2.5)
    + jk.WhiteKernel(0.1, (1e-5, 1e5)),
    jk.ConstantKernel(1.0, "fixed") * jk.RBF(0.6, (0.1, 2.0))
    + jk.WhiteKernel(0.1, "fixed"),
]
# kernels outside the fused family (grams in plain torch)
GENERAL = [
    jk.Matern((0.5, 0.3, 0.7), (0.1, 1.0), nu=1.7),
    jk.ConstantKernel(1.5, (0.1, 2.0)) * jk.Matern(0.4, (0.1, 1.0), nu=0.7)
    + jk.WhiteKernel(0.1, (1e-5, 1e5)),
    jk.Exponentiation(jk.RBF(0.4, (0.1, 1.0)), 2.0),
    jk.ConstantKernel(1.2, (0.1, 2.0)) * jk.Exponentiation(
        jk.Matern((0.4, 0.6, 0.5), (0.1, 1.0), nu=2.5), 1.5
    ) + jk.WhiteKernel(0.1, (1e-5, 1e5)),
    jk.CompoundKernel((jk.RBF(0.4, (0.1, 1.0)), jk.Matern(0.5, (0.1, 1.0), nu=3.5))),
]
SPECS += GENERAL

rng = np.random.RandomState(0)
X = rng.uniform(size=(7, 3))
Y = rng.uniform(size=(5, 3))


def _t(a):
    return torch.tensor(np.asarray(a), dtype=torch.float64)


@pytest.mark.parametrize("spec", SPECS)
def test_theta_layout(spec):
    ours = convert.kernel_spec(spec)
    assert ours.n_theta == spec.n_theta
    np.testing.assert_array_equal(ours.theta0, spec.theta0)
    np.testing.assert_array_equal(ours.bounds, spec.bounds)
    assert tk.white_theta_index(ours) == jk.white_theta_index(spec)
    theta = spec.theta0 + 0.1
    assert ours.with_theta(theta) == convert.kernel_spec(spec.with_theta(theta))


@pytest.mark.parametrize("spec", SPECS)
def test_eval_and_diag_match_jax(spec):
    ours = convert.kernel_spec(spec)
    theta = spec.theta0 + 0.05 * rng.randn(spec.n_theta)
    jt = jnp.asarray(theta)
    np.testing.assert_allclose(
        ours.eval(_t(theta), _t(X)).numpy(),
        np.asarray(spec.eval(jt, jnp.asarray(X))),
        rtol=1e-12, atol=1e-14,
    )
    np.testing.assert_allclose(
        ours.eval(_t(theta), _t(X), _t(Y)).numpy(),
        np.asarray(spec.eval(jt, jnp.asarray(X), jnp.asarray(Y))),
        rtol=1e-12, atol=1e-14,
    )
    np.testing.assert_allclose(
        ours.diag(_t(theta), _t(X)).numpy(),
        np.asarray(spec.diag(jt, jnp.asarray(X))),
        rtol=1e-12,
    )


def test_batched_theta_is_per_theta_eval():
    """A (B, n_theta) theta batch gives (B, n, m) grams: JAX's vmap."""
    spec = SPECS[7]
    ours = convert.kernel_spec(spec)
    thetas = spec.theta0[None] + 0.1 * rng.randn(4, spec.n_theta)
    batch = ours.eval(_t(thetas), _t(X), _t(Y)).numpy()
    diag = ours.diag(_t(thetas), _t(X)).numpy()
    assert batch.shape == (4, 7, 5) and diag.shape == (4, 7)
    for b in range(4):
        jt = jnp.asarray(thetas[b])
        np.testing.assert_allclose(
            batch[b], np.asarray(spec.eval(jt, jnp.asarray(X), jnp.asarray(Y))),
            rtol=1e-12, atol=1e-14,
        )
        np.testing.assert_allclose(
            diag[b], np.asarray(spec.diag(jt, jnp.asarray(X))), rtol=1e-12
        )


def test_unported_kernels_raise():
    """A kernel class the port does not have is refused by name."""

    class DotProduct(jk.RBF):
        pass

    with pytest.raises(NotImplementedError):
        convert.kernel_spec(DotProduct(1.0, (0.1, 1.0)))
    with pytest.raises(NotImplementedError):
        convert.kernel_spec(jk.Exponentiation(DotProduct(1.0, (0.1, 1.0)), 2.0))


@pytest.mark.parametrize("spec", GENERAL, ids=lambda k: type(k).__name__)
def test_general_kernels_are_not_fusable(spec):
    """Like ``pallas_gram.match_fusable``: None, so the grams are built by
    the spec and K1 never sees these kernels."""
    assert gram.match_fusable(convert.kernel_spec(spec)) is None


def test_general_nu_batched_theta_and_pow():
    """A (B, n_theta) batch of general-nu thetas is B evaluations, and
    ``k ** e`` is Exponentiation, with the leaves and White index of JAX."""
    spec = GENERAL[1]
    ours = convert.kernel_spec(spec)
    thetas = spec.theta0[None] + 0.1 * rng.randn(3, spec.n_theta)
    batch = ours.eval(_t(thetas), _t(X)).numpy()
    off = ~np.eye(len(X), dtype=bool)
    for b in range(3):
        want = np.asarray(spec.eval(jnp.asarray(thetas[b]), jnp.asarray(X)))
        np.testing.assert_allclose(batch[b][off], want[off], rtol=1e-12, atol=1e-14)
        # JAX's self-distance is a rounding residue (~1e-16), not 0 as the
        # port's: k_0.7 moves by ~r^1.4 there
        np.testing.assert_allclose(np.diag(batch[b]), np.diag(want), rtol=1e-9)
    powered = tk.RBF(0.4, (0.1, 1.0)) ** 2
    assert powered == tk.Exponentiation(tk.RBF(0.4, (0.1, 1.0)), 2.0)
    for k in GENERAL:
        ours = convert.kernel_spec(k)
        assert [type(leaf).__name__ for leaf in tk.iter_leaves(ours)] == [
            type(leaf).__name__ for leaf in jk.iter_leaves(k)
        ]
        assert tk.white_theta_index(ours) == jk.white_theta_index(k)
