"""The port's geometric median (``bask_tpu_torch/utils/median.py``) on the
CPU: against the JAX package's ``while_loop`` at float32 (chains of the
warm tell's shapes and a larger one, rows at the start's mean so the
Vardi-Zhang branch runs, a chain that never meets ``eps``, a ``max_iter``
past one block of stop checks), and the graph path's rule with a
stand-in capture whose replay runs the captured block eagerly: a key's
first call eager, its second captures, later ones only replay, each the
eager loop bit for bit with its stop checks. The replays on the card are
held bit-equal to the eager loop in ``tests/test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from bask_tpu.utils import median as jmedian  # noqa: E402
from bask_tpu_torch.utils import graphs as tgraphs  # noqa: E402
from bask_tpu_torch.utils import median, trace  # noqa: E402

from torch_graph_stand_in import stand_in_graphs  # noqa: E402,F401


def _chain(n, d, seed=0, offset=0.0):
    return (offset + np.random.RandomState(seed).randn(n, d)).astype(np.float32)


def _at_the_mean(n, d, k, seed=0):
    """``k`` rows at 0.5 and ``n - k`` dyadic rows whose mean is exactly
    0.5, so the first iterate sits on ``k`` rows (``num_zeros`` = k): one
    row is pulled off (the correction moves), 60 hold the median."""
    w = np.random.RandomState(seed).randint(-16, 17, size=(n - k, d)) / 8.0
    w[-1] = -w[:-1].sum(0)
    return np.vstack([np.full((k, d), 0.5), 0.5 + w]).astype(np.float32)


def _reference(X, max_iter):
    return np.asarray(jmedian.geometric_median(jnp.asarray(X, dtype=jnp.float32),
                                               max_iter=max_iter))


CASES = {
    "warm tell (100, 17)": (_chain(100, 17), 200),
    "warped warm tell (100, 47)": (_chain(100, 47, 1), 200),
    "(2000, 17)": (_chain(2000, 17, 2), 200),
    "one row at the mean": (_at_the_mean(100, 17, 1), 200),
    "60 rows at the mean": (_at_the_mean(100, 17, 60), 200),
    # float32 steps near 1e3 never fall below eps: both loops stop at max_iter
    "never converges": (_chain(100, 17, 3, offset=1e3), 200),
    # 60 duplicated rows: ~30 iterations, cut after the first stop check
    "max_iter 26": (np.vstack([np.repeat(_chain(1, 17, 4), 60, 0), _chain(40, 17, 5)]), 26),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_median_matches_the_jax_package_at_float32(case):
    X, max_iter = CASES[case]
    got = median.geometric_median(torch.as_tensor(X), max_iter=max_iter).numpy()
    want = _reference(X, max_iter)
    assert got.dtype == np.float32
    # float32 sums in another order; a stop one iteration apart moves < eps
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def test_the_cases_exercise_what_they_name():
    X, _ = CASES["never converges"]
    y = torch.as_tensor(X).mean(0)
    delta = torch.tensor(float("inf"))
    for _ in range(200):
        y, delta = median._iteration(torch.as_tensor(X), y, delta, 1e-5)
    assert delta >= 1e-5
    for k in (1, 60):
        X = torch.as_tensor(_at_the_mean(100, 17, k))
        assert (X.mean(0) == 0.5).all()  # the start sits on the k rows
        moved = median.geometric_median(X) - 0.5
        assert (moved.abs().max() > 0.05) if k == 1 else (moved == 0).all()


@pytest.fixture
def graphs(stand_in_graphs):
    """The shared stand-in capture (an empty median cache), traced; the
    captured bodies."""
    trace.reset()
    trace.enable()
    try:
        yield stand_in_graphs
    finally:
        trace.disable()
        trace.reset()


def _counts():
    spans = trace.snapshot()["spans"]
    return tuple(spans.get(n, {"count": 0})["count"]
                 for n in ("span.gp.median_capture", "span.gp.median_replay", "span.wait"))


@pytest.mark.parametrize("case, max_iter", [
    ("warm tell (100, 17)", 200), ("warm tell (100, 17)", 26),
    ("max_iter 26", 26), ("max_iter 26", 50), ("max_iter 26", 200),
    ("never converges", 200), ("never converges", 60), ("60 rows at the mean", 200),
])
def test_graph_path_is_the_eager_loop_bit_for_bit(graphs, case, max_iter):
    """Three calls of one key: eager, capture and replay, replay; each the
    eager loop's result with its stop checks, whole blocks replayed."""
    X = torch.as_tensor(CASES[case][0])
    want = median._eager(X, 1e-5, max_iter)
    want_checks = _counts()[2]
    got, counts = [], []
    for _ in range(3):
        trace.reset()
        got.append(median._graphed(X.clone(), 1e-5, max_iter))
        counts.append(_counts())
    for g in got:
        assert torch.equal(g, want)
    assert len(graphs) == 1
    blocks = max(c[1] for c in counts)
    assert counts[0] == (0, 0, want_checks)
    assert counts[1] == (1, blocks, want_checks) and counts[2] == (0, blocks, want_checks)
    assert 1 <= blocks <= max_iter // median._CHECK_EVERY


def test_each_key_captures_once_and_the_oldest_is_freed(graphs, monkeypatch):
    monkeypatch.setattr(tgraphs, "MAX_ENTRIES", 2)
    a, b, c = (torch.as_tensor(_chain(40, d, d)) for d in (3, 4, 5))
    for X in (a, a, b, b, a):
        median._graphed(X, 1e-5, 50)
    assert len(graphs) == 2  # a's and b's
    median._graphed(a, 1e-3, 50)  # another eps is another key
    assert len(graphs) == 2 and list(tgraphs.MEDIAN) == [_key(a, 1e-5), _key(a, 1e-3)]
    median._graphed(c, 1e-5, 50)
    median._graphed(b, 1e-5, 50)  # b was freed: seen anew, eager
    assert len(graphs) == 2
    # a transposed view of the same shape and values is another key
    at = torch.as_tensor(_chain(3, 40, 3)).T
    assert at.shape == a.shape and _key(at, 1e-5) != _key(a, 1e-5)


def _key(X, eps):
    return (tuple(X.shape), X.stride(), X.dtype, str(X.device), float(eps),
            torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)


def test_a_matmul_setting_is_another_key(graphs):
    """A graph keeps the math mode of its capture, so a change of the
    float32 matmul precision sees the key anew: eager, then a capture."""
    X = torch.as_tensor(_chain(40, 3))
    for _ in range(2):
        median._graphed(X, 1e-5, 50)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        assert median._key(X, 1e-5) == _key(X, 1e-5) not in tgraphs.MEDIAN
        median._graphed(X, 1e-5, 50)
        assert len(graphs) == 1
        assert torch.equal(median._graphed(X, 1e-5, 50), median._eager(X, 1e-5, 50))
        assert len(graphs) == 2
    finally:
        torch.set_float32_matmul_precision(before)


def test_cpu_tensors_always_run_eagerly(graphs):
    X = torch.as_tensor(_chain(100, 17))
    for _ in range(3):
        median.geometric_median(X)
    assert graphs == [] and not tgraphs.MEDIAN
    assert _counts()[:2] == (0, 0)
