"""``warmup_optimizer`` in the port against the JAX package's.

The same clone and the same synthetic tells: both warmups run with the
Optimizer classes replaced by recorders, which take the clone's arguments
and its tells and fit nothing, so the bucket lists, the clone's arguments
(JAX's, plus the port's device, dtype and ``host_prior_mode``) and every
tell's points and keywords are compared directly. A real warmup on the CPU
then leaves ``opt`` as it was and lets no R-hat warning out (the chain
graphs themselves need a card: ``tests/test_torch_cuda.py``)."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import bask_tpu.optimizer as jopt_mod  # noqa: E402
import bask_tpu_torch.optimizer as topt_mod  # noqa: E402
from bask_tpu import Optimizer as JaxOptimizer  # noqa: E402
from bask_tpu.utils.warmup import warmup_optimizer as jax_warmup  # noqa: E402
from bask_tpu_torch import Optimizer, warmup_optimizer  # noqa: E402

DIMS = [(0.0, 1.0), (-2.0, 2.0)]
OBS = (2, 3, 70, 130, 64)


def _recorder(log):
    class Recorder:
        def __init__(self, **kwargs):
            self.kwargs = kwargs
            self.gp_sample_kwargs = dict(kwargs.get("gp_sample_kwargs") or {})
            log.append(self)
            self.tells = []

        def tell(self, x, y, **kw):
            self.tells.append((np.asarray(x, dtype=float), np.asarray(y, dtype=float),
                               dict(kw), dict(self.gp_sample_kwargs)))

    return Recorder


def _recorded(module, warmup, opt):
    log = []
    original = module.Optimizer
    module.Optimizer = _recorder(log)
    try:
        buckets = warmup(opt, OBS, gp_samples=20, gp_burnin=2, n_samples=3, rng_seed=4)
    finally:
        module.Optimizer = original
    (clone,) = log
    return buckets, clone


def test_warmup_makes_jax_buckets_clone_and_tells():
    kw = dict(dimensions=DIMS, n_points=32, n_initial_points=2, init_strategy="random",
              acq_func="ei", random_state=1, gp_kwargs={"moves": "demix"},
              gp_sample_kwargs={"n_walkers_per_thread": 16})
    jopt = JaxOptimizer(**kw)
    topt = Optimizer(**kw, device="cpu")
    j_buckets, j_clone = _recorded(jopt_mod, jax_warmup, jopt)
    t_buckets, t_clone = _recorded(topt_mod, warmup_optimizer, topt)
    assert t_buckets == j_buckets == [64, 128, 192]
    # JAX's arguments, plus where the port's model lives
    assert set(t_clone.kwargs) == set(j_clone.kwargs) | {"device", "dtype"}
    assert set(t_clone.kwargs["gp_kwargs"]) == set(j_clone.kwargs["gp_kwargs"]) | {
        "host_prior_mode"}
    for name in ("n_points", "n_initial_points", "init_strategy", "random_state",
                 "gp_sample_kwargs", "acq_polish", "acq_polish_starts", "acq_polish_lr",
                 "mesh", "gp_priors", "acq_func_kwargs"):
        assert t_clone.kwargs[name] == j_clone.kwargs[name], name
    assert t_clone.kwargs["acq_func"] is topt.acq_func
    assert t_clone.kwargs["gp_kernel"] is topt.gp._user_kernel
    assert t_clone.kwargs["gp_kwargs"]["moves"] == topt.gp.moves
    assert (t_clone.kwargs["device"], t_clone.kwargs["dtype"]) == (topt.gp.device, topt.gp.dtype)
    # a cold tell (one R-hat leg) filling each bucket to one below, then a warm one
    assert len(t_clone.tells) == len(j_clone.tells) == 6
    for (tx, ty, tkw, tsk), (jx, jy, jkw, jsk) in zip(t_clone.tells, j_clone.tells):
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(ty, jy)
        assert tkw == jkw and tsk == jsk
    assert [t[3].get("max_extensions") for t in t_clone.tells] == [1, None] * 3


def test_warmup_leaves_opt_alone_and_silent():
    """A real warmup on the CPU: ``opt``'s observations, model and random
    state are untouched, and the cold tell's one-leg R-hat warning does
    not escape."""
    opt = Optimizer(dimensions=DIMS, n_points=32, n_initial_points=2,
                    init_strategy="random", acq_func="ei", random_state=1, device="cpu",
                    gp_sample_kwargs={"n_walkers_per_thread": 16})
    rng_state = opt.rng.get_state()
    gp_state = opt.gp.random_state.get_state()
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        warnings.filterwarnings("default", message="(?!.*did not reach R-hat).*")
        assert warmup_optimizer(opt, (2,), gp_samples=20, gp_burnin=2, n_samples=3) == [64]
    for got, want in zip(opt.rng.get_state(), rng_state):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(opt.gp.random_state.get_state(), gp_state):
        np.testing.assert_array_equal(got, want)
    assert opt.Xi == [] and opt.yi == [] and opt.gp.pos_ is None and opt.gp.chain_ is None
