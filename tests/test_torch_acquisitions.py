"""The six acquisitions added to the port beside EI and PVRS (TopTwoEI,
Expectation, LCB, MaxValueSearch, ThompsonSampling, VarianceReduction),
without warping, on the fixed-chain problem of
tests/test_parity_golden.py: the JAX package's surfaces there are pinned
to the reference formulas, and the port must give the same surfaces at
rtol 1e-5 with the same argmax. MES gets the Gumbel uniforms JAX draws;
Thompson sampling, whose draws torch cannot replay, is held to the
5-sigma Monte-Carlo bound around its expectation."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bask_tpu import acquisition as jacq  # noqa: E402
from bask_tpu.models.bayesgpr import BayesGPR as JaxBayesGPR  # noqa: E402
from bask_tpu.ops import kernels as jk  # noqa: E402
from bask_tpu.utils.median import geometric_median  # noqa: E402
from bask_tpu_torch import acquisition as tacq  # noqa: E402
from bask_tpu_torch import convert  # noqa: E402
from bask_tpu_torch.optimizer import ACQUISITION_FUNC  # noqa: E402

SEED = 7
N_DRAWS = 20
RTOL = 1e-5

# the problem and the deterministic chain of tests/test_parity_golden.py
X_TRAIN = np.array([-2.0, -1.0, 1.0, 2.0])[:, None]
Y_TRAIN = np.array([0.0, -1.0, 1.0, 2.0])
X_GRID = np.linspace(-2.0, 2.0, num=101)[:, None]
CHAIN = np.log([0.6, 1.0, 0.01]) + 0.10 * np.random.RandomState(42).randn(512, 3)


@pytest.fixture(scope="module")
def fixed():
    kernel = jk.ConstantKernel(1.0, (1e-4, 1.0)) * jk.RBF(1.0, (0.5, 1.5))
    gp = JaxBayesGPR(kernel=kernel, normalize_y=False, random_state=1)
    gp.fit(X_TRAIN, Y_TRAIN, n_desired_samples=8, n_burnin=1,
           n_walkers_per_thread=8, progress=False)
    gp.chain_ = CHAIN.copy()
    median = np.asarray(geometric_median(jnp.asarray(CHAIN)))
    gp.theta = median
    gp.noise_ = float(np.exp(median[2]))
    ours = convert.fitted_bayesgpr(
        kernel=gp._spec, theta=gp.theta, chain=gp.chain_, pos=gp.pos_,
        noise=gp.noise_, X=gp._X_orig, y=gp._y_orig, alpha=gp.alpha,
        device="cpu",
    )
    return gp, ours


@pytest.mark.parametrize(
    "name,kwargs",
    [("ttei", {}), ("mean", {}), ("lcb", {}), ("lcb", {"alpha": "inf"}), ("ei", {})],
)
def test_uncertainty_acquisitions_match_jax(fixed, name, kwargs):
    gp, ours = fixed
    acq_j = jacq.TopTwoEI() if name == "ttei" else {
        "mean": jacq.Expectation(), "lcb": jacq.LCB(), "ei": jacq.ExpectedImprovement()
    }[name]
    ref = jacq.evaluate_acquisitions(
        X_GRID, gp, acquisition_functions=(acq_j,), n_samples=N_DRAWS,
        random_state=SEED, **kwargs,
    )[0]
    vals = tacq.evaluate_acquisitions_fused(
        X_GRID, ours, ACQUISITION_FUNC[name], n_samples=N_DRAWS, random_state=SEED, **kwargs
    )[0]
    np.testing.assert_allclose(vals, ref, rtol=RTOL, atol=1e-10)
    assert np.argmax(vals) == np.argmax(ref)


def test_mes_with_jax_uniforms(fixed):
    gp, ours = fixed
    ref = jacq.evaluate_acquisitions(
        X_GRID, gp, acquisition_functions=(jacq.MaxValueSearch(),),
        n_samples=N_DRAWS, random_state=SEED,
    )[0]
    # the dispatcher's RNG bookkeeping: rows, then the two seeds
    rs = np.random.RandomState(SEED)
    idx = rs.choice(len(CHAIN), replace=False, size=N_DRAWS)
    rs.randint(0, 2**31 - 1)
    keys = jax.random.split(jax.random.PRNGKey(rs.randint(0, 2**31 - 1)), N_DRAWS)
    u = np.stack([
        np.asarray(jax.random.uniform(k, (1000,), dtype=jnp.float64, minval=1e-12, maxval=1.0))
        for k in keys
    ])
    vals = tacq._fused_marginal_vals(
        ours._tensor(CHAIN[idx]), ours._data, ours._tensor(X_GRID), ours._spec,
        ours.white_index_, len(X_TRAIN), tacq.MaxValueSearch(), {"u": torch.from_numpy(u)},
    ).numpy()
    assert np.isfinite(vals).all()
    vals = vals.sum(0) / N_DRAWS
    np.testing.assert_allclose(vals, ref, rtol=RTOL, atol=1e-10)
    assert np.argmax(vals) == np.argmax(ref)
    # the port's own uniforms go through the same code path
    own = tacq.evaluate_acquisitions_fused(
        X_GRID, ours, ACQUISITION_FUNC["mes"], n_samples=N_DRAWS, random_state=SEED
    )
    assert own.shape == (1, len(X_GRID)) and np.isfinite(own).all()


def test_variance_reduction_matches_jax(fixed):
    gp, ours = fixed
    ref = jacq.evaluate_acquisitions(
        X_GRID, gp, acquisition_functions=(jacq.VarianceReduction(),),
        n_samples=0, random_state=SEED,
    )[0]
    vals = tacq.evaluate_acquisitions_fused(
        X_GRID, ours, ACQUISITION_FUNC["vr"], n_samples=0, random_state=SEED
    )[0]
    np.testing.assert_allclose(vals, ref, rtol=RTOL)
    assert np.argmax(vals) == np.argmax(ref)


def test_thompson_sampling_statistics(fixed):
    """E[TS] = -mean over draws of mu, with variance sum(std_i^2) / S^2:
    the port's TS average within 5 sigma of JAX's Expectation average
    over the same chain rows."""
    gp, ours = fixed
    S = 256
    ts = tacq.evaluate_acquisitions_fused(
        X_GRID, ours, ACQUISITION_FUNC["ts"], n_samples=S, random_state=SEED
    )[0]
    expect = jacq.evaluate_acquisitions(
        X_GRID, gp, acquisition_functions=(jacq.Expectation(),), n_samples=S,
        random_state=SEED,
    )[0]
    idx = np.random.RandomState(SEED).choice(len(CHAIN), replace=False, size=S)
    _, std = tacq._per_draw_body(
        ours._tensor(CHAIN[idx]), ours._data, ours._tensor(X_GRID), ours._spec,
        ours.white_index_, len(X_TRAIN),
    )
    tol = 5.0 * np.sqrt((std.numpy() ** 2).sum(0)) / S + 1e-12
    assert np.all(np.abs(ts - expect) < tol), np.max(np.abs(ts - expect) - tol)


def test_registry_has_the_jax_keys():
    from bask_tpu.optimizer import ACQUISITION_FUNC as JAX_FUNCS

    assert sorted(ACQUISITION_FUNC) == sorted(JAX_FUNCS)
    for key, acq in ACQUISITION_FUNC.items():
        assert type(acq).__name__ == type(JAX_FUNCS[key]).__name__
