"""The port's batch ask against the JAX package's: ``Optimizer.ask(n_points>1)``
in the initial design (r2, sb, random), then after a fit on both sides
of the 2,048-candidate switch, with the GP's draws stubbed by one shared
function on both sides (as ``tests/test_round2_fixes.py`` stubs them):
the pathwise branch's call, the exact ``sample_y`` branch, the
NotImplementedError subsample fallback and the host de-duplication must
pick the same points. Also ``normalize_y``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from bask_tpu import Optimizer as JaxOptimizer  # noqa: E402
from bask_tpu.models.bayesgpr import BayesGPR as JaxBayesGPR  # noqa: E402
from bask_tpu_torch import BayesGPR, Optimizer, convert  # noqa: E402

DIMS = [(-1.0, 1.0), (0.0, 2.0)]


@pytest.mark.parametrize("strategy", ["r2", "sb", "random"])
def test_initial_design_batches_match_jax(strategy):
    pts = []
    for cls, kw in ((JaxOptimizer, {}), (Optimizer, {"device": "cpu"})):
        opt = cls(dimensions=DIMS, n_initial_points=5, init_strategy=strategy, random_state=3, **kw)
        first = np.asarray(opt.ask(n_points=3))
        opt.tell([list(p) for p in first[:2]], [0.1, 0.2], fit=False)
        pts.append((first, np.asarray(opt.ask(n_points=4))))
    (a1, a2), (b1, b2) = pts
    np.testing.assert_allclose(b1, a1, rtol=0, atol=1e-12)
    np.testing.assert_allclose(b2, a2, rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def fitted():
    """A JAX and a port Optimizer told the same 10 points (EI with no
    draws, so the tells are cheap); their RNGs are in the same state."""
    rng = np.random.RandomState(0)
    X = np.column_stack([rng.uniform(-1, 1, 10), rng.uniform(0, 2, 10)])
    y = np.sin(3 * X[:, 0]) + (X[:, 1] - 1.0) ** 2
    opts = []
    for cls, kw in ((JaxOptimizer, {}), (Optimizer, {"device": "cpu", "dtype": torch.float64})):
        opt = cls(dimensions=DIMS, n_points=3000, n_initial_points=10, init_strategy="random",
                  acq_func="ei", random_state=0,
                  gp_sample_kwargs={"until_rhat": None, "n_walkers_per_thread": 8}, **kw)
        opt.tell(X.tolist(), y.tolist(), n_samples=0, gp_samples=16, gp_burnin=2)
        opts.append(opt)
    return opts


def _stubs(calls):
    def topk(X, n_samples=1, top_k=8, random_state=0, n_features=1024, sample_mean=True):
        calls.append({"m": len(X), "n_samples": n_samples, "top_k": top_k,
                      "sample_mean": sample_mean})
        draws = np.random.RandomState(random_state).randn(n_samples, len(X)) + X.sum(1)
        return np.argsort(draws, axis=1)[:, :top_k]

    def sample_y(X, n_samples=1, random_state=0, **kwargs):
        calls.append({"m": len(X), "exact": True})
        return np.random.RandomState(random_state).randn(len(X), n_samples) + X.sum(1)[:, None]

    return topk, sample_y


def _ask_both(fitted, monkeypatch, n_points, grid, topk_fn=None):
    out, calls = [], []
    for opt in fitted:
        topk, sample_y = _stubs(calls)
        monkeypatch.setattr(opt.gp, "thompson_argmin_pathwise", topk_fn or topk)
        monkeypatch.setattr(opt.gp, "sample_y", sample_y)
        monkeypatch.setattr(opt, "n_points", grid)
        out.append(np.asarray(opt.ask(n_points=n_points)))
    return out, calls


def test_pathwise_branch_above_2048_candidates(fitted, monkeypatch):
    (ref, got), calls = _ask_both(fitted, monkeypatch, 6, 3000)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    assert len({tuple(p) for p in got}) == 6
    assert calls[0] == calls[1] == {"m": 3000, "n_samples": 6, "top_k": 12, "sample_mean": False}


def test_exact_branch_at_2048_candidates_or_fewer(fitted, monkeypatch):
    (ref, got), calls = _ask_both(fitted, monkeypatch, 5, 2048)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    assert calls[0] == calls[1] == {"m": 2048, "exact": True}


def test_subsample_fallback_for_a_non_pathwise_kernel(fitted, monkeypatch):
    def refuse(*args, **kwargs):
        raise NotImplementedError

    (ref, got), calls = _ask_both(fitted, monkeypatch, 3, 4096, topk_fn=refuse)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    assert calls[0] == calls[1] == {"m": 2048, "exact": True}


def test_duplicate_argmins_are_replaced(fitted, monkeypatch):
    """Every draw names candidate 0 only: the host de-duplication walks on
    to the first unused candidates, the same on both sides."""

    def same(X, n_samples=1, top_k=8, **kwargs):
        return np.zeros((n_samples, top_k), dtype=int)

    (ref, got), _ = _ask_both(fitted, monkeypatch, 4, 3000, topk_fn=same)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    assert len({tuple(p) for p in got}) == 4


def test_batch_larger_than_the_grid_raises(fitted, monkeypatch):
    monkeypatch.setattr(fitted[1], "n_points", 3)
    with pytest.raises(ValueError):
        fitted[1].ask(n_points=4)


def test_normalize_y_like_jax():
    """normalize_y standardizes y (std 0 -> 1) and the noise vector by the
    variance, as the JAX package does; off, the targets stay raw."""
    rng = np.random.RandomState(2)
    X, y, nv = rng.uniform(size=(9, 2)), 3.0 + 2.0 * rng.randn(9), 0.1 * rng.rand(9)
    for normalize in (True, False):
        for yy in (y, np.full(9, 4.0)):
            jgp = JaxBayesGPR(normalize_y=normalize)
            jgp._set_data(X, yy, nv)
            ours = BayesGPR(normalize_y=normalize, device="cpu", dtype=torch.float64)
            ours._set_data(X, yy, nv)
            assert ours.y_train_mean_ == pytest.approx(jgp.y_train_mean_, rel=1e-15)
            assert ours.y_train_std_ == pytest.approx(jgp.y_train_std_, rel=1e-15)
            np.testing.assert_allclose(ours._data.y.numpy(), np.asarray(jgp._data.y), rtol=1e-15)
            np.testing.assert_allclose(
                ours._data.alpha_diag.numpy(), np.asarray(jgp._data.alpha_diag), rtol=1e-15
            )


def test_convert_carries_normalize_y():
    kernel = convert.bk.RBF(1.0) + convert.bk.WhiteKernel(0.1)
    common = dict(kernel=kernel, theta=kernel.theta0, chain=kernel.theta0[None], pos=None,
                  X=np.eye(3), y=np.arange(3.0), device="cpu")
    assert convert.fitted_bayesgpr(**common, y_mean=1.0, y_std=0.8).normalize_y
    assert not convert.fitted_bayesgpr(**common).normalize_y
    assert convert.fitted_bayesgpr(**common, normalize_y=True).normalize_y
