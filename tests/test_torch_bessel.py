"""bask_tpu_torch.ops.bessel against scipy.special.kve and bask_tpu's
on-device Bessel, and the general-nu Matern built on it: values, the
closed-form derivative in r, and the r -> 0 limit."""

import math

import numpy as np
import pytest
import scipy.special as sps

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from bask_tpu.ops import bessel as jbessel  # noqa: E402
from bask_tpu.ops import kernels as jk  # noqa: E402
from bask_tpu_torch.ops import bessel  # noqa: E402
from bask_tpu_torch.ops import kernels as tk  # noqa: E402

# both regimes (Temme below 2, CF2 above), the switch point, and the
# range the Matern operating distances reach
X = np.concatenate([np.logspace(-8, 0.3, 60), [2.0, 1.9999999, 2.0000001],
                    np.linspace(2.05, 60.0, 80)])
ORDERS = [0.0, 0.3, 0.5, 0.7, 1.0, 1.2, 1.7, 2.5, 3.3, 5.5, 7.9, 12.0, -1.7]


@pytest.mark.parametrize("nu", ORDERS)
def test_kve_matches_scipy(nu):
    """Within 1e-13 relative of scipy's kve (finite values), as the JAX
    package's bessel is."""
    got = bessel.kve(nu, torch.tensor(X, dtype=torch.float64)).numpy()
    want = sps.kve(nu, X)
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-13, atol=0)


@pytest.mark.parametrize("nu", [0.3, 1.7, 5.5])
def test_log_kve_matches_jax(nu):
    got = bessel.log_kve(nu, torch.tensor(X, dtype=torch.float64)).numpy()
    want = np.asarray(jbessel.log_kve(nu, jnp.asarray(X)))
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-13)


def test_kve_float32_in_float32_out():
    """float64 inside, the input's dtype out."""
    x = torch.tensor(X[60:], dtype=torch.float32)
    out = bessel.kve(1.7, x)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), sps.kve(1.7, X[60:].astype(np.float32)), rtol=1e-6)


@pytest.mark.parametrize("nu", [0.3, 1.7, 3.5, 7.2])
def test_general_matern_value_and_derivative(nu):
    """k_nu(r) against the JAX package's host oracle and its closed-form
    dk/dr (1e-12), autograd's dk/dr equal to the closed form, and the
    r -> 0 limit: k = 1, dk/dr = 0, finite."""
    r = np.concatenate([[0.0, 1e-12, 1e-9], np.linspace(1e-3, 8.0, 50)])
    rt = torch.tensor(r, dtype=torch.float64, requires_grad=True)
    k = tk.matern_general(rt, nu)
    (dk,) = torch.autograd.grad(k.sum(), rt)
    np.testing.assert_allclose(k.detach().numpy(), jk._matern_general_np(r, nu),
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(dk.numpy(), jk._matern_general_dr_np(r, nu),
                               rtol=1e-11, atol=1e-13)
    assert k[0].item() == 1.0 and dk[0].item() == 0.0


def test_general_matern_second_derivative_is_finite():
    """The Laplace init differentiates the closed-form backward once more;
    central differences of dk/dr agree with it."""
    nu = 1.7
    r = torch.linspace(0.2, 4.0, 9, dtype=torch.float64, requires_grad=True)
    (dk,) = torch.autograd.grad(tk.matern_general(r, nu).sum(), r, create_graph=True)
    (d2k,) = torch.autograd.grad(dk.sum(), r)
    h = 1e-5
    rr = r.detach()
    fd = (torch.as_tensor(jk._matern_general_dr_np((rr + h).numpy(), nu))
          - torch.as_tensor(jk._matern_general_dr_np((rr - h).numpy(), nu))) / (2 * h)
    np.testing.assert_allclose(d2k.numpy(), fd.numpy(), rtol=1e-6, atol=1e-8)
    assert math.isfinite(float(d2k.sum()))
