"""One stand-in for the port's CUDA-graph capture on the CPU.

A test module takes the ``stand_in_graphs`` fixture with
``from torch_graph_stand_in import stand_in_graphs  # noqa: F401``.
"""

import pytest


class _EagerGraph:
    """A captured "graph" without a card: its replay runs the body with the
    launch counters left as they were (a replay on the card calls no
    wrapper; ``graphs.Captured.replay`` adds the counted launches)."""

    def __init__(self, body, counters):
        self.body = body
        self.counters = counters

    def replay(self):
        start = [f.launches for f in self.counters]
        self.body()
        for f, n in zip(self.counters, start):
            f.launches = n


@pytest.fixture
def stand_in_graphs(monkeypatch):
    """``bask_tpu_torch.utils.graphs.capture`` without a card, with empty
    graph caches and a registry of counted wrappers that a test may add to.
    The stand-in warms as on the card, runs the body once in place of the
    capture (its counted launches are what each replay adds, and every
    counter is put back, as a capture does), and returns a graph whose
    replay runs the body eagerly. Yields the captured bodies."""
    from bask_tpu_torch.utils import graphs

    captured = []

    def capture(body, warm, device, pool=None):
        counters = tuple(graphs.COUNTED)
        start = [f.launches for f in counters]
        for _ in range(graphs.WARM_RUNS):
            warm()
        before = [f.launches for f in counters]
        body()
        launches = tuple((f, f.launches - b) for f, b in zip(counters, before)
                         if f.launches != b)
        for f, n in zip(counters, start):
            f.launches = n
        captured.append(body)
        return graphs.Captured(_EagerGraph(body, counters), launches)

    monkeypatch.setattr(graphs, "capture", capture)
    monkeypatch.setattr(graphs, "CHAIN", graphs.Cache(first_call=True))
    monkeypatch.setattr(graphs, "MEDIAN", graphs.Cache(first_call=False))
    monkeypatch.setattr(graphs, "COUNTED", list(graphs.COUNTED))
    yield captured
