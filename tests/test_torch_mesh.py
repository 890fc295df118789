"""The port's meshes (``bask_tpu_torch.parallel.mesh``) and walker and
candidate sharding against the JAX package on its 8 virtual CPU devices,
with port meshes of the CPU listed 8 (or 2) times: ``batched_lml(mesh=)``
bit-equal to the unsharded port and within 1e-10 of JAX's
``batched_lml(mesh=walker_mesh(8))``; the walker count rounded 100 -> 112;
``sample(mesh=)`` equal to the unsharded chain (``test_sharded_sample.py``);
sharded-candidate acquisition equal to unsharded
(``test_sharded_candidates.py``); ``Optimizer(mesh=)`` tells; the mesh's
collectives and its error messages."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from bask_tpu.ops import kernels as jk  # noqa: E402
from bask_tpu.ops import linalg as jlin  # noqa: E402
from bask_tpu.parallel.mesh import walker_mesh as jax_walker_mesh  # noqa: E402
from bask_tpu_torch import Optimizer  # noqa: E402
from bask_tpu_torch import acquisition as tacq  # noqa: E402
from bask_tpu_torch.models import gp as tgp  # noqa: E402
from bask_tpu_torch.models.bayesgpr import BayesGPR  # noqa: E402
from bask_tpu_torch.ops import kernels as tk  # noqa: E402
from bask_tpu_torch.ops import linalg as tlin  # noqa: E402
from bask_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from bask_tpu_torch.parallel.mesh import Mesh  # noqa: E402

CPU8 = ["cpu"] * 8


def _lml_problem(W, n_pad=64, n_real=57, d=3, seed=0):
    rng = np.random.RandomState(seed)
    X = np.zeros((n_pad, d))
    X[:n_real] = rng.uniform(size=(n_real, d))
    y = np.zeros(n_pad)
    y[:n_real] = rng.randn(n_real)
    mask = np.arange(n_pad) < n_real
    alpha = np.full(n_pad, 1e-6)
    kj, kt = (m.ConstantKernel(1.0, (0.1, 2.0)) * m.Matern((0.3,) * d, (0.05, 2.0), nu=2.5)
              + m.WhiteKernel(0.05, (1e-5, 1e5)) for m in (jk, tk))
    thetas = kj.theta0[None, :] + 0.1 * rng.randn(W, kj.n_theta)
    return kj, kt, thetas, X, y, alpha, mask


@pytest.mark.parametrize("per_walker", [False, True])
def test_batched_lml_mesh(per_walker):
    """Each of the 8 entries' walker shard through the whole pipeline: the
    result is the unsharded port's bit for bit and JAX's sharded result
    within 1e-10."""
    W = 16
    kj, kt, thetas, X, y, alpha, mask = _lml_problem(W)
    Xin = X
    if per_walker:
        Xin = X[None] + 0.01 * np.random.RandomState(1).randn(W, *X.shape)
    args = [torch.as_tensor(a) for a in (thetas, Xin, y, alpha, mask)]
    plain = tlin.batched_lml(kt, *args)
    sharded = tlin.batched_lml(kt, *args, mesh=Mesh(CPU8))
    assert torch.equal(plain, sharded)
    jmesh = jax_walker_mesh(8)
    want = jax.jit(lambda t, Xj: jlin.batched_lml(
        kj, t, Xj, *(jnp.asarray(a) for a in (y, alpha, mask)), mesh=jmesh
    ))(jnp.asarray(thetas), jnp.asarray(Xin))
    np.testing.assert_allclose(sharded.numpy(), np.asarray(want), rtol=1e-10)


def _gp(seed, d=1):
    return BayesGPR(
        kernel=tk.ConstantKernel(1.0, (0.1, 2.0)) * tk.Matern((0.3,) * d if d > 1 else 0.3,
                                                              (0.05, 2.0), nu=2.5),
        random_state=seed, device="cpu", dtype=torch.float64,
    )


def test_sharded_sample_matches_unsharded():
    """``fit(mesh=)`` on 8 entries with 64 walkers: the chain, the final
    ensemble and the consensus theta equal the unsharded run's."""
    rng = np.random.RandomState(0)
    X = rng.uniform(size=(14, 1))
    y = np.sin(5 * X[:, 0])
    gp_a = _gp(7)
    gp_a.fit(X, y, n_burnin=2, n_walkers_per_thread=64, progress=False)
    gp_b = _gp(7)
    gp_b.fit(X, y, n_burnin=2, n_walkers_per_thread=64, progress=False, mesh=Mesh(CPU8))
    np.testing.assert_array_equal(gp_b.chain_, gp_a.chain_)
    np.testing.assert_array_equal(gp_b.pos_, gp_a.pos_)
    np.testing.assert_array_equal(gp_b.theta, gp_a.theta)


def test_mesh_rounds_walkers_to_devices():
    """100 walkers on an 8-entry mesh round up to 112 (each half-ensemble
    of 56 splits into 7 per entry)."""
    rng = np.random.RandomState(0)
    X = rng.uniform(size=(10, 1))
    gp = _gp(3)
    gp.fit(X, np.sin(5 * X[:, 0]), n_burnin=1, n_desired_samples=112, progress=False,
           mesh=Mesh(CPU8))
    assert gp.chain_steps_.shape[1] == 112
    assert np.isfinite(gp.chain_).all()


def _fitted_2d():
    rng = np.random.RandomState(0)
    X = rng.uniform(size=(12, 2))
    gp = _gp(3, d=2)
    gp.fit(X, np.sin(4 * X[:, 0]) + X[:, 1], n_burnin=2, n_desired_samples=16,
           n_walkers_per_thread=16, progress=False)
    return gp, rng


def test_sharded_candidate_grid_matches_unsharded():
    """EI over a 64-point grid split 8 ways: each entry predicts its
    candidates, the means and the values are gathered once each for the
    minimum and the argmax; values and argmax equal the unsharded ones."""
    gp, rng = _fitted_2d()
    Xc = torch.as_tensor(rng.uniform(size=(64, 2)))
    theta = gp._tensor(gp.theta)
    ei = tacq.ExpectedImprovement()
    mu, std = tgp.predict(gp._spec, theta, gp._post, gp._post_data, Xc, return_std=True)
    vals_ref = ei(mu, std)

    mesh = Mesh(CPU8, ("cand",))
    parts = tmesh.shard_candidates(Xc, mesh, axis="cand")
    assert [p.shape[0] for p in parts] == [8] * 8
    preds = [tgp.predict(gp._spec, theta, gp._post, gp._post_data, p, return_std=True)
             for p in parts]
    y_opt = mesh.all_gather([m for m, _ in preds], device="cpu").min()
    vals = mesh.all_gather([ei(m, s, y_opt=y_opt) for m, s in preds], device="cpu")
    np.testing.assert_allclose(vals.numpy(), vals_ref.numpy(), rtol=1e-12)
    assert int(torch.argmax(vals)) == int(torch.argmax(vals_ref))


@pytest.mark.parametrize("acq", ["ei", "lcb"])
def test_sharded_marginal_acquisition_matches_unsharded(acq):
    """``evaluate_acquisitions_fused(mesh=)``: the per-draw predictions
    over the candidate grid split 8 ways give the unsharded values."""
    gp, rng = _fitted_2d()
    X = rng.uniform(size=(40, 2))
    a = {"ei": tacq.ExpectedImprovement(), "lcb": tacq.LCB()}[acq]
    plain = tacq.evaluate_acquisitions_fused(X, gp, a, n_samples=5, random_state=4)
    sharded = tacq.evaluate_acquisitions_fused(X, gp, a, n_samples=5, random_state=4,
                                               mesh=Mesh(CPU8))
    np.testing.assert_allclose(sharded, plain, rtol=1e-12, atol=1e-15)


def _run_mesh_loop(mesh, n_tells=5):
    opt = Optimizer(
        dimensions=[(-1.0, 1.0)], n_points=50, n_initial_points=3, init_strategy="random",
        acq_func="ei", random_state=5, mesh=mesh, device="cpu", dtype=torch.float64,
        gp_sample_kwargs={"until_rhat": None, "moves": "stretch"},
    )
    rng = np.random.RandomState(2)
    nxs = []
    for _ in range(n_tells):
        x = opt.ask()
        opt.tell(x, float(x[0] ** 2 + 0.01 * rng.randn()), n_samples=4, gp_samples=64,
                 gp_burnin=2)
        if opt._next_x is not None:
            nxs.append(np.asarray(opt._next_x, dtype=float))
    return np.asarray(nxs), np.asarray(opt.gp.chain_)


def test_optimizer_mesh_matches_unsharded_loop():
    """``Optimizer(mesh=)`` on 2 entries (halves of 50 -> 25 each): the
    chains and the next points of the loop equal the unsharded run's."""
    nxs_plain, chain_plain = _run_mesh_loop(None)
    nxs_mesh, chain_mesh = _run_mesh_loop(Mesh(["cpu"] * 2))
    assert np.array_equal(chain_plain, chain_mesh)
    assert np.array_equal(nxs_plain, nxs_mesh)


def test_optimizer_mesh_rounds_walkers():
    nxs, chain = _run_mesh_loop(Mesh(CPU8), n_tells=4)
    assert chain.shape[0] % 112 == 0
    assert np.isfinite(chain).all() and len(nxs) == 2


def test_row_mesh_messages():
    """``mesh=`` and ``row_mesh`` exclude each other, and the Optimizer
    refuses ``row_mesh``, with the JAX package's messages."""
    mesh = Mesh(CPU8, ("r",))
    gp = BayesGPR(kernel=tk.ConstantKernel(1.0, (0.1, 2.0)) * tk.RBF(0.3, (0.05, 2.0)),
                  row_mesh=mesh, device="cpu", dtype=torch.float64)
    X = np.random.RandomState(0).uniform(size=(8, 1))
    gp._spec = gp._user_kernel
    gp._set_data(X, X[:, 0], None)
    gp._theta = gp._spec.theta0
    with pytest.raises(ValueError, match="mutually exclusive"):
        gp.sample(mesh=mesh, n_desired_samples=4)
    with pytest.raises(ValueError, match="row_mesh"):
        Optimizer([(0.0, 1.0)], gp_kwargs={"row_mesh": mesh}, n_initial_points=2, device="cpu")
    with pytest.raises(ValueError, match="one .* or two"):
        BayesGPR(row_mesh=_ThreeAxes(), device="cpu")


class _ThreeAxes:
    """A mesh-like object of three axes (a :class:`Mesh` has one or two)."""

    axis_names = ("a", "b", "c")


def test_mesh_layout_and_errors():
    m = Mesh(np.array(CPU8).reshape(2, 4).tolist(), ("w", "r"))
    assert list(m.shape.items()) == [("w", 2), ("r", 4)] and m.size == 8
    assert m.row(1).axis_names == ("r",) and m.row(1).devices.shape == (4,)
    assert Mesh(CPU8).replicas() == [torch.device("cpu")]
    with pytest.raises(ValueError, match="axis names"):
        Mesh(CPU8, ("a", "b"))
    with pytest.raises(RuntimeError, match="CUDA card"):
        Mesh(["cuda:%d" % (torch.cuda.device_count() if torch.cuda.is_available() else 0)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA card"):
            tmesh.walker_mesh(1)


def test_mesh_collectives():
    """all_gather, broadcast, all_reduce and the chunk order of
    shard_walkers on a mesh that repeats one device."""
    mesh = Mesh(["cpu"] * 3, ("walkers",))
    x = torch.arange(14.0).reshape(7, 2)
    parts = tmesh.shard_walkers(x, mesh)
    assert [p.shape[0] for p in parts] == [3, 2, 2]
    assert torch.equal(mesh.all_gather(parts, device="cpu"), x)
    full = mesh.all_gather([p.T for p in parts], dim=1)
    assert list(full) == [torch.device("cpu")] and torch.equal(full[torch.device("cpu")], x.T)
    assert torch.equal(mesh.broadcast(parts[1], 1)[torch.device("cpu")], parts[1])
    assert float(mesh.all_reduce([p.sum() for p in parts])) == float(x.sum())
    assert torch.equal(mesh.all_reduce([p[0] for p in parts]), x[[0, 3, 5]].sum(0))
