"""The port's ``Space.rvs_transformed`` and the BO loop's candidate grid
against the JAX package's list path, ``transform(rvs(n, random_state))``:
bit for bit, over every dimension type, and with the random stream left
where the list path leaves it."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bask_tpu.space as jax_space  # noqa: E402
from bask_tpu import Optimizer as JaxOptimizer  # noqa: E402
from bask_tpu_torch import Optimizer  # noqa: E402
from bask_tpu_torch import space as torch_space  # noqa: E402

# each builds its dimensions from a space module, so both packages get
# the same space
SPACES = {
    "real": lambda m: [m.Real(-2.0, 3.0)],
    "real_log": lambda m: [m.Real(1e-3, 10.0, prior="log-uniform")],
    "integer": lambda m: [m.Integer(-3, 7)],
    "integer_log": lambda m: [m.Integer(1, 1000, prior="log-uniform")],
    "integer_point": lambda m: [m.Integer(4, 4), m.Integer(5, 5, prior="log-uniform")],
    "categorical": lambda m: [m.Categorical(["a", "b", "c"])],
    "categorical_prior": lambda m: [m.Categorical(["a", "b", "c", "d"], prior=[0.1, 0.2, 0.3, 0.4])],
    "categorical_equal": lambda m: [m.Categorical([1, 1.0, "a"])],
    "categorical_single": lambda m: [m.Categorical(["only"])],
    "mixed": lambda m: [
        m.Real(0.0, 1.0),
        m.Categorical(["x", "y", 2, 2.0], prior=[0.4, 0.3, 0.2, 0.1]),
        m.Integer(1, 64, prior="log-uniform"),
        m.Real(0.01, 100.0, prior="log-uniform"),
        m.Integer(-5, 5),
        m.Categorical(["lo", "hi"]),
    ],
}


@pytest.mark.parametrize("n", [1, 500, 65536])
@pytest.mark.parametrize("name", sorted(SPACES))
def test_rvs_transformed_matches_jax_list_path(name, n):
    ref_rs, rs = np.random.RandomState(11), np.random.RandomState(11)
    ref = jax_space.Space(SPACES[name](jax_space))
    want = ref.transform(ref.rvs(n_samples=n, random_state=ref_rs))
    got = torch_space.Space(SPACES[name](torch_space)).rvs_transformed(n_samples=n, random_state=rs)
    assert got.dtype == np.float64 and got.flags.c_contiguous
    assert got.shape == (n, ref.transformed_n_dims)
    assert np.array_equal(got, want)
    assert rs.randint(2**31) == ref_rs.randint(2**31)


def test_candidate_grid_matches_jax_optimizer():
    dims = [(0.0, 1.0)] * 15
    ref = JaxOptimizer(dimensions=dims, n_points=500, random_state=5)
    opt = Optimizer(dimensions=dims, n_points=500, random_state=5, device="cpu")
    got = opt._candidate_grid()
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert got.flags.c_contiguous and got.shape == (500, 15)
    assert np.array_equal(got, ref._candidate_grid())
    assert opt.rng.randint(2**31) == ref.rng.randint(2**31)


def test_candidate_grid_never_takes_the_list_path(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the candidate grid went through the per-point list path")

    dims = [(0.0, 1.0), (1, 9), ["a", "b", "c"]]
    ref = JaxOptimizer(dimensions=dims, n_points=300, random_state=2)
    opt = Optimizer(dimensions=dims, n_points=300, random_state=2, device="cpu")
    monkeypatch.setattr(torch_space.Space, "rvs", refuse)
    monkeypatch.setattr(torch_space.Space, "transform", refuse)
    got = opt._candidate_grid()
    assert got.shape == (300, 5)
    assert np.array_equal(got, ref._candidate_grid())
