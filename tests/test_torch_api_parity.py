"""The port's public surface against the JAX package's: ``progress``
through ``Optimizer.tell``, ``BayesGPR.fit`` and ``BayesGPR.sample`` (the
same next ask with and without the bar), the check on the number of
``gp_priors`` with JAX's message, the top-level names (``__all__``) and
``log_marginal_likelihood(clone_kernel=)``."""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import bask_tpu  # noqa: E402
import bask_tpu_torch  # noqa: E402
from bask_tpu_torch.parallel import mcmc  # noqa: E402

# JAX's names the port lacks (none since warmup_optimizer and the AOT
# cache were ported), and the port's one extra
TPU_ONLY = set()
PORT_ONLY = {"evaluate_acquisitions_fused"}


def _tell_and_ask(progress):
    """tests/test_round2_fixes.py's tell_progress case on the port."""
    opt = bask_tpu_torch.Optimizer(
        dimensions=[(0.0, 1.0)], n_initial_points=2, init_strategy="random",
        n_points=32, random_state=5, device="cpu",
    )
    opt.tell([[0.2], [0.8], [0.5]], [0.3, 0.1, -0.2], n_samples=2, gp_samples=20,
             gp_burnin=2, progress=progress)
    return opt.ask(), opt.gp.chain_, opt.gp.theta


def test_tell_progress_gives_the_same_ask(monkeypatch):
    """With the bar the chain ticks it in chunks of 8 steps up to its
    length; the chain, the consensus and the next ask are the same."""
    bars = []

    class Recorder:
        def __init__(self, total):
            self.total, self.count, self.closed = total, 0, False
            bars.append(self)

        def update(self, n):
            self.count += n

        def close(self):
            self.closed = True

    plain = _tell_and_ask(False)
    no_bar = mcmc.get_progress_bar(False, 0)
    monkeypatch.setattr(mcmc, "get_progress_bar",
                        lambda display, total: Recorder(total) if display else no_bar)
    shown = _tell_and_ask(True)
    assert bars and all(b.closed and b.count == b.total for b in bars)
    assert shown[0] == plain[0]
    np.testing.assert_array_equal(shown[1], plain[1])
    np.testing.assert_array_equal(shown[2], plain[2])


@pytest.mark.parametrize("owner,method", [("Optimizer", "tell"), ("BayesGPR", "fit"),
                                          ("BayesGPR", "sample")])
def test_progress_parameter_and_default_match_jax(owner, method):
    ours = inspect.signature(getattr(getattr(bask_tpu_torch, owner), method))
    theirs = inspect.signature(getattr(getattr(bask_tpu, owner), method))
    assert ours.parameters["progress"].default == theirs.parameters["progress"].default


def test_wrong_number_of_gp_priors_raises_jax_error():
    """A list of priors that is not d + 2 long is refused before the fit,
    with the JAX package's message."""
    messages = []
    for pkg, kw in ((bask_tpu, {}), (bask_tpu_torch, {"device": "cpu"})):
        opt = pkg.Optimizer(dimensions=[(0.0, 1.0)], n_initial_points=2, random_state=0,
                            gp_priors=[lambda x: 0.0 * x] * 2, **kw)
        with pytest.raises(ValueError) as err:
            opt.tell([[0.2], [0.8], [0.5]], [0.3, 0.1, -0.2])
        messages.append(str(err.value))
        assert opt.gp.pos_ is None  # nothing was fitted
    assert messages[0] == messages[1] == (
        "The number of priors does not match the number of dimensions + 2."
    )


def test_top_level_names_match_jax():
    assert set(bask_tpu_torch.__all__) ^ set(bask_tpu.__all__) == TPU_ONLY | PORT_ONLY
    from bask_tpu_torch import ACQUISITION_FUNC, __version__, save_optimizer  # noqa: F401

    assert __version__ == bask_tpu.__version__
    assert sorted(ACQUISITION_FUNC) == sorted(bask_tpu.ACQUISITION_FUNC)
    # every name of JAX's top level that the port has, outside __all__ too
    jax_names = {n for n in vars(bask_tpu) if not n.startswith("_")} - TPU_ONLY
    modules = {n for n in jax_names if inspect.ismodule(getattr(bask_tpu, n))}
    assert all(hasattr(bask_tpu_torch, n) for n in jax_names - modules)
    for name in ("save_gpr", "load_gpr", "save_optimizer", "load_optimizer", "get_progress_bar"):
        assert callable(getattr(bask_tpu_torch, name))


def test_log_marginal_likelihood_takes_clone_kernel():
    rng = np.random.RandomState(3)
    X = rng.uniform(size=(12, 2))
    y = np.sin(3 * X).sum(1)
    gp = bask_tpu_torch.BayesGPR(random_state=0, device="cpu", dtype=torch.float64)
    gp.fit(X, y, n_desired_samples=20, n_walkers_per_thread=10, n_burnin=2, progress=False)
    theta = gp.theta + 0.1
    assert gp.log_marginal_likelihood(theta, clone_kernel=False) == gp.log_marginal_likelihood(theta)
    assert gp.log_marginal_likelihood(clone_kernel=False) == gp.log_marginal_likelihood_value_
    ours = inspect.signature(bask_tpu_torch.BayesGPR.log_marginal_likelihood).parameters
    theirs = inspect.signature(bask_tpu.BayesGPR.log_marginal_likelihood).parameters
    assert ours["clone_kernel"].default is theirs["clone_kernel"].default is True
