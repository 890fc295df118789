"""The port's multi-process runtime (``bask_tpu_torch.parallel.distributed``)
in two spawned processes, gloo, 4 CPU entries each: the counterpart of
``tests/test_multihost.py`` and its worker. The parent computes the
single-process port results; each worker runs the same program over the
8-entry mesh that spans both processes and checks that its results equal
them: the chain of ``fit(mesh=)``, the acquisition over the sharded
candidate grid and its argmax, and the row-sharded LML.
The workers import no JAX (each checks it).

Run as ``python tests/test_torch_distributed.py <coordinator> <world>
<rank> <reference.npz>`` it is one worker.
"""

import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import torch  # noqa: E402

torch.set_num_threads(1)


def _problem():
    from bask_tpu_torch.ops import kernels as bk

    rng = np.random.RandomState(0)
    X = rng.uniform(size=(12, 2))
    y = np.sin(3 * X[:, 0]) + 0.1 * rng.randn(12)
    kernel = bk.ConstantKernel(1.0, (0.1, 2.0)) * bk.Matern((0.3, 0.3), (0.05, 2.0), nu=2.5)
    Xc = rng.uniform(size=(40, 2))
    return kernel, X, y, Xc


def _results(mesh):
    """(chain, pos, theta, EI over the grid, its argmax, row LML) of the
    program, on ``mesh`` (None: one process, no mesh)."""
    from bask_tpu_torch.acquisition import ExpectedImprovement, evaluate_acquisitions_fused
    from bask_tpu_torch.models.bayesgpr import BayesGPR
    from bask_tpu_torch.ops.dist_chol import row_sharded_lml
    from bask_tpu_torch.parallel.mesh import Mesh

    kernel, X, y, Xc = _problem()
    gp = BayesGPR(kernel=kernel, random_state=3, device="cpu", dtype=torch.float64)
    gp.fit(X, y, n_burnin=2, n_desired_samples=32, n_walkers_per_thread=16, progress=False,
           mesh=mesh, moves="stretch")
    ei = evaluate_acquisitions_fused(Xc, gp, ExpectedImprovement(), n_samples=4,
                                     random_state=1, mesh=mesh)[0]
    best = int(np.argmax(ei))
    rows = Mesh(["cpu"] * 8, ("r",)) if mesh is None else mesh
    d = gp._data
    lml = row_sharded_lml(gp._spec, gp._tensor(gp.theta), d.X, d.y, d.alpha_diag, d.mask,
                          rows, nb=8)
    return {"chain": gp.chain_, "pos": gp.pos_, "theta": gp.theta, "ei": ei,
            "best": np.array(best), "lml": np.array(float(lml))}


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_parity(tmp_path):
    ref = _results(None)
    path = str(tmp_path / "ref.npz")
    np.savez(path, **ref)
    coord = f"127.0.0.1:{_free_port()}"
    env = {k: v for k, v in os.environ.items() if not k.startswith(("MASTER_", "JAX_"))}
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), coord, "2", str(r), path],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)
    ]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0])
        finally:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert "PARITY OK" in out, out


def _worker(coord, world, rank, ref_path):
    from bask_tpu_torch.parallel.distributed import (
        global_walker_mesh,
        init_distributed,
        shard_global,
    )

    r, w = init_distributed(coord, int(world), int(rank), local_device_ids=[0, 1, 2, 3],
                            device="cpu")
    assert (r, w) == (int(rank), int(world))
    mesh = global_walker_mesh()
    assert mesh.size == 8 and mesh.local == [4 * r + i for i in range(4)]
    shards = shard_global(np.arange(16.0), mesh, "walkers")
    assert [float(s[0]) for s in shards] == [8.0 * r + 2.0 * i for i in range(4)]
    ref = np.load(ref_path)
    got = _results(mesh)
    for key in ("chain", "pos", "theta", "best", "lml"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    # each entry predicts 5 candidates, where the parent predicted 40 at
    # once: the matmuls may round differently
    np.testing.assert_allclose(got["ei"], ref["ei"], rtol=1e-12, atol=1e-15)
    assert "jax" not in sys.modules, "a worker imported JAX"
    torch.distributed.destroy_process_group()
    print("PARITY OK", r)


if __name__ == "__main__":
    _worker(*sys.argv[1:5])
