"""The port's warped model (``BayesGPR(warp_inputs=True)``) against the
benchmark's plain float64 reference (``portbench/reference/warp_gp.py``,
plain PyTorch written from the definitions) on the CPU, at d 3, n 30 and
16 walkers on seeded data: the chain's log-probability, PVRS and the grid's
inverse warp, each as the warped sequential loop runs them."""

import copy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bask_tpu_torch import acquisition as tacq  # noqa: E402
from bask_tpu_torch.models import bayesgpr as tbg  # noqa: E402
from bask_tpu_torch.models import warping as twp  # noqa: E402
from bask_tpu_torch.ops import kernels as bk  # noqa: E402
from portbench.reference import gp as ref  # noqa: E402
from portbench.reference import priors  # noqa: E402
from portbench.reference import warp as ref_warp  # noqa: E402
from portbench.reference import warp_gp  # noqa: E402

D, N, WALKERS, NU = 3, 30, 16, 2.5
JITTER = 1e-10  # BayesGPR's alpha on the gram's diagonal at float64


@pytest.fixture(scope="module")
def fitted():
    """A warped float64 BayesGPR fitted on 30 noisy points of the
    benchmark's bowl, with its data as the reference takes it (targets
    normalized as the model normalizes them)."""
    rng = np.random.RandomState(7)
    X = rng.uniform(size=(N, D))
    y = ((X - 0.5) ** 2).sum(1) + 0.05 * rng.randn(N)
    kernel = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern(
        (0.3,) * D, (0.05, 2.0), nu=NU) + bk.WhiteKernel(0.05, (1e-5, 1e5))
    gp = tbg.BayesGPR(kernel, warp_inputs=True, normalize_y=True, random_state=0,
                      device="cpu", dtype=torch.float64)
    gp.fit(X, y, n_desired_samples=64, n_burnin=5, n_walkers_per_thread=WALKERS,
           progress=False, warn_rhat=None)
    return gp, torch.from_numpy(X), torch.from_numpy((y - y.mean()) / y.std())


def _rows(gp):
    """The chain's last walkers, their warps pushed off the identity so
    that the warp moves every term."""
    rows = torch.from_numpy(gp.chain_[-WALKERS:]).clone()
    gen = torch.Generator().manual_seed(1)
    rows[:, -2 * D :] += 0.4 * torch.randn(WALKERS, 2 * D, generator=gen, dtype=torch.float64)
    return rows


def test_warped_log_prob_batch_is_the_priors_plus_the_warped_lml(fitted):
    gp, X, y = fitted
    rows = _rows(gp)
    lp = tbg._make_log_prob_batch(gp._spec, gp._resolve_priors(None), gp._data, N,
                                  gp._resolve_warp_priors(None), D)(rows)
    want = warp_gp.log_posterior(rows, X, y, JITTER, NU, D)
    # both float64: the program's 48-term fraction is within 2e-15 of the
    # Beta CDF here (a, b in [0.2, 5]) and the factorizations sum in other
    # orders; they meet within 6e-13 at log-posteriors of ~120
    torch.testing.assert_close(lp, want, rtol=1e-10, atol=1e-10)
    # the same rows scored at the unwarped inputs, the warp prior kept, miss
    theta, la, lb = warp_gp.split(rows, D)
    unwarped = torch.stack([ref.lml(t, X, y, JITTER, NU) for t in theta])
    assert (lp - (priors.log_prior(theta, D) + warp_gp.warp_prior(la, lb) + unwarped)
            ).abs().max() > 1e-3


def test_consensus_lml_at_the_programs_consensus(fitted):
    gp, X, y = fitted
    la, lb = (torch.from_numpy(w) for w in (gp.warp_alphas_, gp.warp_betas_))
    want = float(ref.lml(torch.from_numpy(gp.theta), ref_warp.warp(X, la, lb), y, JITTER, NU))
    # float64 on both sides, the same operations on the consensus: equal here
    assert gp.log_marginal_likelihood_value_ == pytest.approx(want, rel=1e-10, abs=1e-10)


def test_pvrs_of_a_warped_model_is_the_warped_reference(fitted, monkeypatch):
    gp, X, y = fitted
    probes, original = [], tacq._thompson_probes

    def keep(*args, **kwargs):
        probes.append(original(*args, **kwargs))
        return probes[-1]
    monkeypatch.setattr(tacq, "_thompson_probes", keep)
    grid = np.random.RandomState(3).uniform(size=(40, D))
    vals = tacq.PVRS()(grid, gp, random_state=5)
    (P,) = probes
    la, lb = (torch.from_numpy(w) for w in (gp.warp_alphas_, gp.warp_betas_))
    want = warp_gp.pvrs(torch.from_numpy(gp.theta), la, lb, X, y, JITTER, NU,
                        torch.from_numpy(grid), P).numpy()
    # float64 on both sides; the program borders its factor by rank one
    # where the reference solves afresh: 4e-16 of the largest value here
    np.testing.assert_allclose(vals, want, rtol=1e-9, atol=1e-11 * np.abs(want).max())
    # the reference warps the grid itself: the same grid left unwarped
    # scores 7e-4 of the largest value away
    plain = ref.pvrs(torch.from_numpy(gp.theta), ref_warp.warp(X, la, lb), y, JITTER, NU,
                     torch.from_numpy(grid), P).numpy()
    assert np.abs(plain - want).max() > 1e-4 * np.abs(want).max()


@pytest.mark.parametrize("warp", ["consensus", "skewed"])
def test_unwarp_then_the_reference_warp_gives_back_the_uniforms(fitted, warp):
    gp = copy.deepcopy(fitted[0])
    if warp == "skewed":  # a in [1.6, 2.7], b in [0.45, 0.6]: a pdf far from 1
        gp.create_warpers(np.log([1.6, 2.0, 2.7]), np.log([0.6, 0.5, 0.45]))
    Z = np.random.RandomState(4).uniform(size=(200, D))
    x = gp.unwarp(Z)
    back = ref_warp.warp(torch.from_numpy(x), torch.from_numpy(gp.warp_alphas_),
                         torch.from_numpy(gp.warp_betas_)).numpy()
    # the inverse ends on adjacent float64 x: what is left is the CDF's
    # slope times a rounding of x and the fractions' own error, 7e-16 at
    # the consensus and 4e-14 at the skewed warp
    np.testing.assert_allclose(back, Z, rtol=0, atol=1e-12)
    assert np.abs(x - Z).max() > (1e-3 if warp == "skewed" else 0.0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 3e-6), (torch.float64, 1e-14)])
def test_unwarp_of_a_steep_warp_lands_in_its_cell(dtype, tol):
    """A consensus warp with a or b near 0.03 (the sequential loop's
    strongest on the card reach 0.04): the CDF is so steep at an end that
    z up to 0.3 lies below 2^-60, so halving [0, 1] 60 times, as the JAX
    package does, leaves z there up to 0.3 from the CDF of any x it can
    return. The port's inverse (``warping.unwarp``, as ``BayesGPR.unwarp``
    runs it) ends on the type's best x: z lies in the float64 CDF's image
    of x's cell in the type (``warp_gp.unwarp_gap``), up to the type's
    own CDF rounding (3e-6 in float32, the card's limit on K6 and K7;
    float64's fraction is within 1e-14 of the Beta CDF here)."""
    la = torch.log(torch.tensor([0.03, 1.0, 0.04], dtype=torch.float64))
    lb = torch.log(torch.tensor([1.0, 0.03, 25.0], dtype=torch.float64))
    z = torch.from_numpy(np.random.RandomState(5).uniform(size=(300, 3)))
    z[:4] = torch.tensor([1e-9, 0.05, 0.3, 0.999]).unsqueeze(1)
    x = twp.unwarp(z.to(dtype), la.to(dtype), lb.to(dtype))
    assert x.dtype == dtype
    gap = warp_gp.unwarp_gap(x.double(), z.to(dtype).double(), la, lb, dtype=dtype)
    assert float(gap.max()) <= tol
    # a bisection that halves [0, 1] 60 times returns x >= 2^-61 here, and
    # its CDF misses z by up to 0.3
    halved = torch.clamp(x.double(), min=2.0 ** -61)
    assert float(warp_gp.unwarp_gap(halved, z, la, lb, dtype=torch.float64).max()) > 0.1
