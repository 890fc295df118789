"""Arguments of the JAX package that the port once lacked, against
``bask_tpu``: ``n_threads`` on ``BayesGPR.fit`` and ``BayesGPR.sample``
(by keyword and in its fourth position, with JAX's walker count on the
same data), the ``kernel_`` setter, ``warping.unwarp(n_iter=)`` and
``nb=`` / ``precision=`` on the blocked solves."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import bask_tpu  # noqa: E402
from bask_tpu.models import warping as jwp  # noqa: E402
from bask_tpu.ops import fast_cholesky as jfc  # noqa: E402
from bask_tpu.ops import kernels as jk  # noqa: E402
import bask_tpu_torch  # noqa: E402
from bask_tpu_torch.models import warping as twp  # noqa: E402
from bask_tpu_torch.ops import fast_cholesky as tfc  # noqa: E402
from bask_tpu_torch.ops import kernels as tk  # noqa: E402


def _data(n=12):
    rng = np.random.RandomState(0)
    X = rng.uniform(size=(n, 1))
    return X, np.sin(4.0 * X[:, 0]) + 0.1 * rng.randn(n)


def _gp(port):
    if port:
        kernel = tk.ConstantKernel(1.0, (0.1, 10.0)) * tk.Matern(1.0, (0.05, 5.0), nu=2.5)
        return bask_tpu_torch.BayesGPR(kernel=kernel, random_state=0, device="cpu")
    kernel = jk.ConstantKernel(1.0, (0.1, 10.0)) * jk.Matern(1.0, (0.05, 5.0), nu=2.5)
    return bask_tpu.BayesGPR(kernel=kernel, random_state=0)


# (how the call is made, n_threads, n_walkers_per_thread): the walkers
# are max(2, n_threads x per thread), rounded up to even
FIT_CALLS = [
    ("keyword", 2, 10),  # 20, the probe of the fault
    ("positional", 2, 10),
    ("keyword", 3, 5),  # 15 -> 16
    ("positional", 1, 1),  # 1 -> 2
]


def _fit(port, how, n_threads, per_thread):
    X, y = _data()
    gp = _gp(port)
    if how == "positional":
        # X, y, noise_vector, n_threads, n_desired_samples, n_burnin,
        # n_walkers_per_thread
        gp.fit(X, y, None, n_threads, 40, 2, per_thread, False)
    else:
        gp.fit(X, y, n_threads=n_threads, n_desired_samples=40, n_burnin=2,
               n_walkers_per_thread=per_thread, progress=False)
    return gp


@pytest.mark.parametrize("call", FIT_CALLS, ids=lambda c: "%s-%dx%d" % c)
def test_fit_n_threads_gives_jax_walker_count(call):
    how, n_threads, per_thread = call
    want = _fit(False, how, n_threads, per_thread).pos_.shape[0]
    gp = _fit(True, how, n_threads, per_thread)
    assert want == max(2, n_threads * per_thread + (n_threads * per_thread) % 2)
    assert gp.pos_.shape[0] == want
    assert gp.chain_steps_.shape[1] == want


@pytest.mark.parametrize("how", ["keyword", "positional"])
def test_sample_n_threads_gives_jax_walker_count(how):
    X, y = _data()
    counts = []
    for port in (False, True):
        gp = _fit(port, "keyword", 1, 10)  # a spec and data; 10 walkers
        if how == "positional":
            gp.sample(X, y, None, 3, 48, 1, 1, 7)  # 3 x 7 = 21 -> 22 walkers
        else:
            gp.sample(X, y, n_threads=3, n_desired_samples=48, n_burnin=1,
                      n_walkers_per_thread=7)
        counts.append(gp.pos_.shape[0])
    assert counts == [22, 22]


def test_until_rhat_legs_keep_the_n_threads_walkers():
    """The legs that ``until_rhat`` adds run the same 20 walkers."""
    X, y = _data()
    gp = _fit(True, "keyword", 1, 10)
    with pytest.warns(UserWarning):  # R-hat 1.0 is out of reach
        gp.sample(X, y, n_threads=2, n_walkers_per_thread=10, n_desired_samples=40,
                  until_rhat=1.0, max_extensions=2, extension_steps=2)
    assert gp.pos_.shape[0] == 20
    assert gp.chain_steps_.shape[1] == 20
    assert gp.until_rhat_result_["steps"] == gp.chain_steps_.shape[0]


def test_kernel_setter_assigns_the_spec():
    """``tests/test_kernel_state.py``'s setter case on the port: reference
    code assigns ``kernel_`` directly."""
    gp = _gp(True)
    assert gp.kernel_ is None
    fitted = _fit(True, "keyword", 1, 10)
    gp.kernel_ = fitted._spec
    assert gp._spec is fitted._spec
    jgp = _gp(False)
    jgp.kernel_ = "spec"
    assert jgp._spec == "spec"


@pytest.mark.parametrize("n_iter", [10, 60])
def test_unwarp_n_iter_matches_jax(n_iter):
    """Within 2^-n_iter of JAX's bisection of n_iter steps: both brackets
    hold the root and are at most 2^-n_iter wide. Beside it, the two
    packages' incomplete beta functions agree to ~1e-10 at these (a, b),
    which moves the root by up to the 1e-9 that
    ``tests/test_torch_warping.py`` holds the default unwarp to."""
    z = np.linspace(0.01, 0.99, 25)
    ab = np.exp(np.linspace(np.log(0.2), np.log(5.0), 4))
    a, b = (v.ravel() for v in np.meshgrid(ab, ab))
    Z = np.repeat(z[:, None], len(a), axis=1)
    ours = twp.unwarp(torch.from_numpy(Z), torch.from_numpy(np.log(a)),
                      torch.from_numpy(np.log(b)), n_iter=n_iter).numpy()
    ref = np.asarray(jwp.unwarp(jnp.asarray(Z), jnp.asarray(np.log(a)), jnp.asarray(np.log(b)),
                                n_iter=n_iter))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2.0 ** -n_iter + 1e-9)
    if n_iter == 60:  # the default: today's 10 rounds, unchanged
        default = twp.unwarp(torch.from_numpy(Z), torch.from_numpy(np.log(a)),
                             torch.from_numpy(np.log(b))).numpy()
        np.testing.assert_array_equal(ours, default)


@pytest.mark.parametrize("n", [256, 320, 576])
def test_block_solves_take_nb(n):
    """``nb=`` equal to the factorization's panel width gives the results
    without it, which are JAX's (with the same ``nb``); ``precision=``
    is accepted; another ``nb`` raises."""
    rng = np.random.RandomState(1)
    A = rng.randn(2, n, n)
    A = A @ np.swapaxes(A, -1, -2) / n + 1e-3 * np.eye(n)
    y, Y = rng.randn(2, n), rng.randn(2, n, 3)
    nb = tfc.pick_nb(n)
    L, invs = tfc.block_cholesky(torch.from_numpy(A), nb=nb)
    Lj, invs_j = jfc.block_cholesky(jnp.asarray(A), nb=nb)
    t_y, t_Y = torch.from_numpy(y), torch.from_numpy(Y)
    cases = [
        (tfc.block_forward_solve(L, invs, t_y, nb=nb), tfc.block_forward_solve(L, invs, t_y),
         jfc.block_forward_solve(Lj, invs_j, jnp.asarray(y), nb=nb)),
        (tfc.block_solve_lower_mat(L, invs, t_Y, nb=nb, precision=None),
         tfc.block_solve_lower_mat(L, invs, t_Y),
         jfc.block_solve_lower_mat(Lj, invs_j, jnp.asarray(Y), nb=nb, precision=None)),
        (tfc.block_solve_upper_mat(L, invs, t_Y, nb=nb), tfc.block_solve_upper_mat(L, invs, t_Y),
         jfc.block_solve_upper_mat(Lj, invs_j, jnp.asarray(Y), nb=nb)),
    ]
    for with_nb, without, ref in cases:
        assert torch.equal(with_nb, without)
        np.testing.assert_allclose(with_nb.numpy(), np.asarray(ref), rtol=1e-10, atol=1e-10)
    other = 128 if nb == 256 else 256
    for fn, rhs in ((tfc.block_forward_solve, t_y), (tfc.block_solve_lower_mat, t_Y),
                    (tfc.block_solve_upper_mat, t_Y)):
        with pytest.raises(ValueError):
            fn(L, invs, rhs, nb=other)
