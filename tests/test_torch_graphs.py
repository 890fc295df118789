"""The port's one home of CUDA graphs (``bask_tpu_torch/utils/graphs.py``)
on the CPU: what the modules around it may import, that it holds the
package's only capture site, and that a replay of the chain's step and of
the median's block adds the launches its capture counted, through the
shared stand-in capture of ``torch_graph_stand_in.py``. The captures
themselves run on the card (``tests/test_torch_cuda.py``)."""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import bask_tpu_torch  # noqa: E402
from bask_tpu_torch.parallel import mcmc  # noqa: E402
from bask_tpu_torch.utils import graphs, median  # noqa: E402

from torch_graph_stand_in import stand_in_graphs  # noqa: E402,F401

PACKAGE = Path(bask_tpu_torch.__file__).parent


def _imported(path: Path):
    """The absolute names of the modules a file of ``utils/`` imports."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            module = node.module or ""
            if node.level:
                base = "bask_tpu_torch.utils".rsplit(".", node.level - 1)[0]
                module = f"{base}.{module}" if module else base
            yield module
            yield from (f"{module}.{a.name}" for a in node.names)


@pytest.mark.parametrize("name", ["median.py", "graphs.py"])
def test_the_median_and_the_graphs_import_no_layer_above_them(name):
    names = list(_imported(PACKAGE / "utils" / name))
    assert "torch" in names
    above = [n for n in names
             if n.startswith(("bask_tpu_torch.parallel", "bask_tpu_torch.models"))]
    assert above == []


def test_graphs_holds_the_only_capture_site():
    sites = {}
    for path in PACKAGE.rglob("*.py"):
        text = path.read_text()
        for call in ("torch.cuda.CUDAGraph(", "torch.cuda.graph("):
            if call in text:
                sites.setdefault(call, []).append(
                    (str(path.relative_to(PACKAGE)), text.count(call)))
    assert sites == {"torch.cuda.CUDAGraph(": [("utils/graphs.py", 1)],
                     "torch.cuda.graph(": [("utils/graphs.py", 1)]}


def _fake_kernel():
    """A counted wrapper that launches nothing: one "launch" a call."""

    def kernel(x):
        kernel.launches += 1
        return x

    return graphs.counted(kernel)


def test_a_chain_replay_adds_the_launches_of_its_step(stand_in_graphs, monkeypatch):
    """A stretch step calls the log-probability once a half: the capture
    counts 2 launches, each replay adds them, and the warm-up and the
    capture add none, so the graphed chain counts what the eager one does
    (1 for the start's log-probability, 2 a step)."""
    monkeypatch.setattr(mcmc, "graph_stats", {"captures": 0, "replays": 0})
    kernel = _fake_kernel()

    def log_prob(pos):
        return kernel(-(pos * pos).sum(1))

    graph = mcmc.ChainGraph(key=("fake",), inputs=(torch.zeros(64, 2),),
                            build=lambda buffers: log_prob)
    pos0 = torch.randn(8, 2, generator=torch.Generator().manual_seed(0))
    eager, _ = mcmc.run_ensemble(log_prob, pos0, 3, 5)
    assert kernel.launches == 1 + 2 * 5
    kernel.launches = 0
    chain, _ = mcmc.run_ensemble(log_prob, pos0, 3, 5, graph=graph)
    assert torch.equal(chain, eager)
    assert kernel.launches == 1 + 2 * 5 and len(stand_in_graphs) == 1
    (entry,) = graphs.CHAIN.values()
    (branch,) = entry.branches.values()
    assert branch.step.launches == ((kernel, 2),)
    assert mcmc.graph_stats == {"captures": 1, "replays": 5}


def test_a_median_replay_adds_the_launches_of_its_block(stand_in_graphs, monkeypatch):
    """With a counted call in every Weiszfeld iteration, a block's capture
    counts 25 launches and each replay adds them: the eager call, the
    capturing call and a replaying call each count the eager loop's 50
    (eps 0 never stops the loop)."""
    kernel = _fake_kernel()
    iteration = median._iteration
    monkeypatch.setattr(median, "_iteration",
                        lambda X, y, delta, eps: iteration(kernel(X), y, delta, eps))
    X = torch.randn(40, 3, generator=torch.Generator().manual_seed(1))
    want = median._eager(X, 0.0, 50)
    assert kernel.launches == 50
    for call in range(3):
        kernel.launches = 0
        assert torch.equal(median._graphed(X, 0.0, 50), want)
        assert kernel.launches == 50, call
    (block,) = graphs.MEDIAN.values()
    assert block.graph.launches == ((kernel, 25),) and len(stand_in_graphs) == 1
