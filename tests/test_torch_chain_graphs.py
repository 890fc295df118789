"""The cache key of the chain's CUDA graphs (``parallel/mcmc.py``) and
which configurations ``BayesGPR`` sends to a graph; pure Python, no card.

The key of a configuration must hit for the same work (a second model
with the same kernel and priors; another n inside the padding bucket)
and miss when anything the captured step depends on changes: the device,
the dtype, the walker count, the chain's dimension, the bucket, d, the
fused spec, a prior's identity, the warp, ``gram.LOWER_GRAM``, the
``gram._K4_ROUTE`` entry, the float32 matmul precision; a move is keyed
with its parameters. The replays themselves are held bit-equal to the
eager chain on the card (``tests/test_torch_cuda.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from bask_tpu_torch import BayesGPR  # noqa: E402
from bask_tpu_torch.models import bayesgpr as tbg  # noqa: E402
from bask_tpu_torch.ops import gram  # noqa: E402
from bask_tpu_torch.ops import kernels as bk  # noqa: E402
from bask_tpu_torch.parallel import mcmc  # noqa: E402
from bask_tpu_torch.parallel.mesh import Mesh  # noqa: E402


def _kernel(nu=2.5, d=3):
    return bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern((0.3,) * d, (0.05, 2.0), nu=nu)


def _model(n=70, d=3, nu=2.5, kernel=None, **kw):
    """A model with its data set as ``fit`` sets it (kernel + White), not fitted."""
    rng = np.random.RandomState(0)
    X = rng.uniform(size=(n, d))
    gp = BayesGPR(kernel or _kernel(nu, d), random_state=0, device="cpu", **kw)
    gp._spec = gp._user_kernel + bk.WhiteKernel(1.0, (1e-5, 1e5))
    gp._set_data(X, np.sin(3 * X[:, 0]), None)
    return gp


@pytest.fixture
def fusable_on_cpu(monkeypatch):
    """The fused spec as on a card: the graph description is built the
    same way for CPU tensors (only its key is read here)."""
    monkeypatch.setattr(tbg, "fused_spec_for",
                        lambda kernel, X: gram.match_fusable(kernel)
                        if X.dtype == torch.float32 and X.shape[-2] % 64 == 0 else None)


def _key(gp, priors=None, W=20, warp=None, device="cuda:0"):
    priors = gp._resolve_priors(priors)
    n_warp = gp._n_warp()
    g = gp._chain_graph(priors, gp._resolve_warp_priors(warp), n_warp, None, None)
    D = gp._spec.n_theta + 2 * n_warp
    return mcmc._entry_key(g, W, D, gp.dtype, device)


def test_same_work_hits(fusable_on_cpu):
    a, b = _model(), _model(n=100)  # another model; another n in bucket 128
    assert a._data.X.shape == b._data.X.shape == (128, 3)
    assert _key(a) == _key(b)
    assert _key(a, warp=(tbg.wp.default_warp_log_prior,) * 2) is not None


def test_each_keyed_field_misses(fusable_on_cpu, monkeypatch):
    base_gp = _model()
    base = _key(base_gp)

    def own_prior(x):
        return -0.5 * x * x

    other = {
        "device": _key(base_gp, device="cuda:1"),
        "walkers": _key(base_gp, W=24),
        "bucket": _key(_model(n=130)),
        "d": _key(_model(d=4)),
        "fused spec (nu)": _key(_model(nu=1.5)),
        "priors": _key(base_gp, priors=[own_prior] * 4),
        "warp (and D)": _key(_model(warp_inputs=True)),
    }
    with monkeypatch.context() as m:
        m.setattr(gram, "LOWER_GRAM", "on")
        other["LOWER_GRAM"] = _key(base_gp)
    with monkeypatch.context() as m:
        m.setitem(gram._K4_ROUTE, (128, 3), 2)
        other["K4 route"] = _key(base_gp)
    precision = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        other["matmul precision"] = _key(base_gp)
    finally:
        torch.set_float32_matmul_precision(precision)
    gp64 = BayesGPR(_kernel(), random_state=0, device="cpu", dtype=torch.float64)
    g = base_gp._chain_graph(base_gp._resolve_priors(None), tbg.wp.default_warp_log_prior, 0,
                             None, None)
    D = base_gp._spec.n_theta
    assert mcmc._entry_key(g, 20, D, torch.float32, "cuda:0") == base
    other["dtype"] = mcmc._entry_key(g, 20, D, gp64.dtype, "cuda:0")
    other["chain dimension"] = mcmc._entry_key(g, 20, D + 1, torch.float32, "cuda:0")
    for field, key in other.items():
        assert key != base, field
    assert len(set(other.values())) == len(other)
    assert _key(base_gp) == base  # the switches above were put back
    moves = [mcmc._branch_key(n, a) for n, a in (
        ("de", 2.0), ("snooker", 2.0), ("stretch", 2.0), ("stretch", 1.5), ("de:jump=0.2", 2.0))]
    assert len(set(moves)) == len(moves) and mcmc._branch_key("de", 2) == moves[0]


def test_configurations_that_stay_eager(fusable_on_cpu):
    """mesh=, row_mesh, a host-adapter prior and a kernel outside the
    fused family give no graph; the rest do."""
    gp = _model()
    priors = gp._resolve_priors(None)
    warp = gp._resolve_warp_priors(None)
    assert isinstance(gp._chain_graph(priors, warp, 0, None, None), mcmc.ChainGraph)
    mesh = Mesh(["cpu"] * 2, ("w",))
    assert gp._chain_graph(priors, warp, 0, mesh, None) is None
    assert gp._chain_graph(priors, warp, 0, None, (mesh, 256, False)) is None
    host = (tbg._HostPrior(lambda x: 0.0, False),) + priors[1:]
    assert gp._chain_graph(host, warp, 0, None, None) is None
    general = _model(nu=1.7)
    assert general._chain_graph(general._resolve_priors(None), warp, 0, None, None) is None


def test_a_graph_runs_on_a_card_only():
    g = mcmc.ChainGraph(key=("cpu only",), inputs=(torch.zeros(64, 2),),
                        build=lambda bufs: None)
    with pytest.raises(RuntimeError, match="CUDA device"):
        mcmc.run_ensemble(lambda x: -(x * x).sum(1), torch.zeros(8, 2), 0, 2, graph=g)
    mcmc.CHAIN_GRAPHS = "off"
    try:  # switched off, the graph is ignored: the eager chain
        chain, _ = mcmc.run_ensemble(lambda x: -(x * x).sum(1), torch.zeros(8, 2), 0, 2,
                                     graph=g)
        assert chain.shape == (2, 8, 2)
    finally:
        mcmc.CHAIN_GRAPHS = "on"
    mcmc._GRAPH_CACHE.clear()


def _stand_in_capture(captured):
    """``_capture_step`` without a card: warm as on the card, then a
    "graph" whose replay runs the captured step eagerly on the entry's
    buffers, and the launches one step counts."""

    def capture(body, warm, pool, device, counters):
        for _ in range(mcmc._WARM_STEPS):
            warm()
        captured.append(body)
        return type("Replay", (), {"replay": staticmethod(body)})(), tuple(0 for _ in counters)

    return capture


@pytest.mark.parametrize("warp", [False, True])
def test_graph_machinery_replays_the_eager_chain(fusable_on_cpu, monkeypatch, warp):
    """On the CPU, with a stand-in capture that replays the captured step
    eagerly: a fit's chain through the graph path (static data buffers,
    n_real as a tensor, randoms drawn into the branches' buffers, the
    state written back in place, demix switching branches) equals the
    eager chain bit for bit, and the next sample() of the same model, at
    another n in the bucket, captures nothing new."""
    captured = []
    monkeypatch.setattr(mcmc, "_capture_step", _stand_in_capture(captured))
    monkeypatch.setattr(mcmc, "_GRAPH_CACHE", type(mcmc._GRAPH_CACHE)())
    chains = {}
    for mode in ("off", "on"):
        monkeypatch.setattr(mcmc, "CHAIN_GRAPHS", mode)
        gp = _model(n=40, d=2, warp_inputs=warp, optimizer=None, moves="demix")
        X, y = gp._X_orig, gp._y_orig
        gp.fit(X, y, n_desired_samples=12 * 8, n_walkers_per_thread=8, n_burnin=0,
               warn_rhat=None, progress=False)
        gp.sample(np.vstack([X, [[0.5] * 2]]), np.append(y, 0.1), n_desired_samples=5 * 8,
                  n_walkers_per_thread=8, warn_rhat=None)
        chains[mode] = (gp.chain_, gp.n_accepted_, gp.theta)
    assert len(captured) == 2  # de and snooker, once each
    np.testing.assert_array_equal(chains["on"][0], chains["off"][0])
    assert chains["on"][1] == chains["off"][1]
    np.testing.assert_array_equal(chains["on"][2], chains["off"][2])
