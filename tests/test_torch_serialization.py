"""Checkpoints across the two packages, and pickling of the port's
models: a BayesGPR or Optimizer saved by bask_tpu loads in bask_tpu_torch
and predicts the same (1e-10 at float64), and the reverse; kernel specs
(general-nu Matern, Exponentiation, CompoundKernel among them) serialize
to the same JSON; port models pickle, those pickled before the fit
options existed included."""

import json
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from bask_tpu import Optimizer as JaxOptimizer  # noqa: E402
from bask_tpu.models.bayesgpr import BayesGPR as JaxBayesGPR  # noqa: E402
from bask_tpu.ops import kernels as jk  # noqa: E402
from bask_tpu.utils import serialization as jser  # noqa: E402
from bask_tpu_torch import Optimizer, convert  # noqa: E402
from bask_tpu_torch.models.bayesgpr import BayesGPR  # noqa: E402
from bask_tpu_torch.utils import serialization as tser  # noqa: E402

KERNEL = jk.ConstantKernel(1.0, (0.1, 2.0)) * jk.Matern((0.3, 0.3), (0.05, 2.0), nu=2.5)
GRID = np.random.RandomState(1).uniform(0.05, 0.95, size=(11, 2))
SPECS = [
    KERNEL + jk.WhiteKernel(0.1, (1e-5, 1e5)),
    jk.ConstantKernel(1.0, "fixed") * jk.RBF(0.6, (0.1, 2.0)),
    jk.Matern((0.5, 0.3), (0.1, 1.0), nu=1.7) + jk.WhiteKernel(0.1, "fixed"),
    jk.Exponentiation(jk.Matern(0.5, (0.1, 1.0), nu=float("inf")), 2.0),
    jk.CompoundKernel((jk.RBF(0.4, (0.1, 1.0)), jk.Matern(0.5, (0.1, 1.0), nu=3.5))),
]


def _bowl(n, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.uniform(size=(n, 2))
    return X, np.sin(5 * X[:, 0]) * np.cos(3 * X[:, 1]) + 0.05 * rng.randn(n)


@pytest.fixture(scope="module")
def jax_gp():
    X, y = _bowl(30)
    gp = JaxBayesGPR(kernel=KERNEL, normalize_y=True, warp_inputs=True, random_state=0,
                     chain_init="laplace", ml2_objective="map", moves="stretch")
    gp.fit(X, y, noise_vector=np.full(30, 1e-3), n_desired_samples=64, n_burnin=5,
           n_walkers_per_thread=16, progress=False, warn_rhat=None)
    return gp


@pytest.mark.parametrize("spec", SPECS, ids=lambda k: type(k).__name__)
def test_kernel_dicts_are_the_same_json(spec):
    ours = convert.kernel_spec(spec)
    assert json.dumps(tser.kernel_to_dict(ours)) == json.dumps(jser.kernel_to_dict(spec))
    assert tser.kernel_from_dict(jser.kernel_to_dict(spec)) == ours


def test_jax_checkpoint_loads_in_the_port(jax_gp, tmp_path):
    path = str(tmp_path / "gp.npz")
    jser.save_gpr(jax_gp, path)
    ours = tser.load_gpr(path, device="cpu", dtype=torch.float64)
    for a, b in zip(ours.predict(GRID, return_std=True), jax_gp.predict(GRID, return_std=True)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(ours.chain_, jax_gp.chain_)
    assert (ours.chain_init, ours.ml2_objective, ours.moves) == ("laplace", "map", (("stretch", 1.0),))
    assert ours.n_proposals_ == jax_gp.n_proposals_


def test_port_checkpoint_loads_in_jax(jax_gp, tmp_path):
    ours = convert.bayesgpr_from_jax(jax_gp, device="cpu")
    path = str(tmp_path / "gp.npz")
    tser.save_gpr(ours, path)
    theirs = jser.load_gpr(path)
    for a, b in zip(theirs.predict(GRID, return_std=True), ours.predict(GRID, return_std=True)):
        np.testing.assert_allclose(np.asarray(a), b, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(theirs.warp_alphas_, ours.warp_alphas_, rtol=0, atol=0)
    again = tser.load_gpr(path, device="cpu", dtype=torch.float64)
    np.testing.assert_allclose(again.predict(GRID), ours.predict(GRID), rtol=1e-12)


def _tell_bowl(opt, n):
    X, y = _bowl(n, seed=2)
    for x, v in zip(X, y):
        opt.tell(list(x), float(v), gp_samples=32, gp_burnin=2)


def test_optimizer_checkpoints_cross_load(tmp_path):
    """A JAX Optimizer's checkpoint gives a port Optimizer with the same
    observations, next point, RNG states and predictions; saved again by
    the port it loads in JAX with the same."""
    common = dict(dimensions=[(0.0, 1.0)] * 2, n_initial_points=6, random_state=3,
                  n_points=64, gp_sample_kwargs={"until_rhat": None,
                                                 "n_walkers_per_thread": 16})
    jopt = JaxOptimizer(**common)
    _tell_bowl(jopt, 7)
    path = str(tmp_path / "opt.npz")
    jser.save_optimizer(jopt, path)
    ours = tser.load_optimizer(path, device="cpu", dtype=torch.float64)
    assert ours.ask() == list(jopt.ask())
    assert ours.Xi == jopt.Xi and ours.yi == jopt.yi
    assert ours.rng.randint(2**31) == jopt.rng.randint(2**31)
    assert ours.gp.random_state.randint(2**31) == jopt.gp.random_state.randint(2**31)
    np.testing.assert_allclose(ours.gp.predict(GRID), jopt.gp.predict(GRID), rtol=1e-10)
    path2 = str(tmp_path / "opt2.npz")
    tser.save_optimizer(ours, path2)
    back = jser.load_optimizer(path2)
    assert list(back.ask()) == ours.ask()
    np.testing.assert_allclose(back.gp.predict(GRID), ours.gp.predict(GRID), rtol=1e-10)


def test_port_optimizer_round_trip_and_pickle(tmp_path):
    """The port's own save/load and pickle of a fitted Optimizer: the same
    next ask and predictions, and the same warm tell afterwards."""
    opt = Optimizer(dimensions=[(0.0, 1.0)] * 2, n_initial_points=6, random_state=3,
                    n_points=64, device="cpu", dtype=torch.float64,
                    gp_sample_kwargs={"until_rhat": None, "n_walkers_per_thread": 16})
    _tell_bowl(opt, 7)
    path = str(tmp_path / "opt.npz")
    tser.save_optimizer(opt, path)
    loaded = tser.load_optimizer(path, device="cpu", dtype=torch.float64)
    pickled = pickle.loads(pickle.dumps(opt))
    for other in (loaded, pickled):
        assert other.ask() == opt.ask()
        np.testing.assert_allclose(other.gp.predict(GRID), opt.gp.predict(GRID), rtol=1e-12)
    x = opt.ask()
    nexts = []
    for o in (opt, pickled):
        o.tell(x, 0.3, gp_samples=32, gp_burnin=2)
        nexts.append(o.ask())
    assert nexts[0] == nexts[1]


def test_pickles_of_earlier_models_still_load():
    """A model pickled before the fit options existed: its state has no
    new fields and holds its tensors as tensors. It loads, takes the
    defaults, and predicts as before."""
    X, y = _bowl(20)
    gp = BayesGPR(convert.kernel_spec(KERNEL), random_state=0, device="cpu",
                  dtype=torch.float64)
    gp.fit(X, y, n_desired_samples=32, n_walkers_per_thread=16, n_burnin=0, warn_rhat=None)
    old = dict(gp.__dict__)
    for name in ("optimizer", "n_restarts_optimizer", "copy_X_train", "chain_init",
                 "ml2_subsample", "ml2_objective", "host_prior_mode"):
        del old[name]
    restored = BayesGPR.__new__(BayesGPR)
    restored.__setstate__(pickle.loads(pickle.dumps(old)))
    assert (restored.optimizer, restored.chain_init, restored.ml2_objective) == (
        "lbfgs", "ball", "lml")
    np.testing.assert_allclose(restored.predict(GRID), gp.predict(GRID), rtol=1e-14)
    state = gp.__getstate__()
    assert isinstance(state["_post"].L, np.ndarray)
