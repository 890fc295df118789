"""The timed path broken underneath a tiny run: ``correct`` comes out
false, once for each fault the cell can have (a step that returns its
state unchanged, half of a batch left out, a chain on stale data, an
answer altered where it is produced)."""

import numpy as np
import pytest
import torch


@pytest.fixture
def patch(monkeypatch):
    return monkeypatch.setattr


def test_refit_that_keeps_its_state(run_tiny, patch):
    from bask_tpu_torch.models.bayesgpr import BayesGPR

    original = BayesGPR.sample

    def unchanged(self, X=None, y=None, *args, **kwargs):
        if self.pos_ is None:  # the cold tell samples
            return original(self, X, y, *args, **kwargs)
        return self
    patch(BayesGPR, "sample", unchanged)
    assert not run_tiny("ns15d.seq_pvrs")["correct"]


def test_next_point_altered(run_tiny, patch):
    from bask_tpu_torch import Optimizer

    original = Optimizer.ask

    def altered(self, n_points=1):
        x = original(self, n_points)
        return list(np.clip(np.asarray(x) + 0.05, 0.0, 1.0)) if n_points == 1 else x
    patch(Optimizer, "ask", altered)
    result = run_tiny("ns15d.seq_pvrs")
    assert result["checks"]["lml_rel"]["value"] <= result["checks"]["lml_rel"]["limit"]
    assert not result["correct"]


def test_half_of_the_rows_left_out_of_the_mean(run_tiny, patch):
    from bask_tpu_torch import acquisition

    def half(vals, n_samples):
        keep = vals[: max(1, n_samples // 2)]
        return keep.sum(axis=0) / len(keep)
    patch(acquisition, "_finite_mean", half)
    assert not run_tiny("ns15d.seq_ei")["correct"]


def test_draw_values_altered(run_tiny, patch):
    from bask_tpu_torch.models import pathwise

    original = pathwise.pathwise_values_plain

    def altered(*args, **kwargs):
        out = original(*args, **kwargs)
        return out + 1e-2 * out.abs().max()
    patch(pathwise, "pathwise_values_plain", altered)
    assert not run_tiny("batch15d.ask")["correct"]


def test_batch_points_altered(run_tiny, patch):
    from bask_tpu_torch import Optimizer

    original = Optimizer._ask_batch

    def altered(self, n_points):
        pts = np.asarray(original(self, n_points))
        return list(pts[::-1])  # each draw handed another draw's point
    patch(Optimizer, "_ask_batch", altered)
    assert not run_tiny("batch15d.ask")["correct"]


@pytest.mark.parametrize("fault,number", [("draw_consensus_warp", "draw_rel"),
                                          ("grid_not_unwarped", "grid_rel")])
def test_warped_ask_fault(run_tiny, fault, number):
    """A draw warped by the consensus warp instead of its own row's, and a
    grid handed on uniform in the warped space, each fail their number."""
    from portbench import faults

    with faults.FAULTS[fault]():
        result = run_tiny("batch15d_warp.ask")
    checks = result["checks"]
    assert checks[number]["value"] > checks[number]["limit"] and not result["correct"], checks


@pytest.mark.parametrize("cell", ["ns15d.fit", "ns15d.seq_pvrs"])
def test_chain_that_keeps_its_state(run_tiny, patch, cell):
    from bask_tpu_torch.models import bayesgpr
    from bask_tpu_torch.parallel.mcmc import EnsembleState

    original, calls = bayesgpr.run_ensemble, [0]

    def unchanged(log_prob, pos0, seed, n_steps, *args, **kwargs):
        calls[0] += 1
        if cell != "ns15d.fit" and calls[0] == 1:  # the sequential cells' cold tell
            return original(log_prob, pos0, seed, n_steps, *args, **kwargs)
        lp = log_prob(pos0)
        chain = pos0[None].expand(n_steps, *pos0.shape).clone()
        return chain, EnsembleState(pos=pos0.clone(), log_prob=lp,
                                    accepted=torch.zeros((), dtype=torch.int64))
    patch(bayesgpr, "run_ensemble", unchanged)
    result = run_tiny(cell)
    assert result["checks"]["stuck_share"]["value"] == 1.0 and not result["correct"]


@pytest.mark.parametrize("cell", ["ns15d.fit", "ns15d.seq_pvrs", "ns15d.seq_ei"])
def test_chain_whose_second_half_keeps_its_state(run_tiny, cell):
    from portbench import faults

    with faults.chain_half_stuck():
        result = run_tiny(cell)
    checks = result["checks"]
    assert checks["stuck_share"]["value"] >= 0.5 and not result["correct"], checks
    assert checks["chain_lp_rel"]["value"] <= checks["chain_lp_rel"]["limit"]


@pytest.mark.parametrize("cell", ["ns15d.fit", "ns15d.seq_pvrs"])
def test_chain_on_stale_data(run_tiny, patch, cell):
    """The chain's log-probability built on the data of the model's
    previous chain (a fit's on the previous fit's), as a replay that kept
    its old inputs would be."""
    from bask_tpu_torch.models import bayesgpr

    original, last = bayesgpr._make_log_prob_batch, {}

    def stale(kernel, priors, data, *args, **kwargs):
        old = last.get(data.X.shape)
        last[data.X.shape] = data
        return original(kernel, priors, data if old is None else old, *args, **kwargs)
    patch(bayesgpr, "_make_log_prob_batch", stale)
    result = run_tiny(cell)
    checks = result["checks"]
    assert checks["chain_lp_rel"]["value"] > checks["chain_lp_rel"]["limit"], checks
    assert not result["correct"]


def test_chain_log_probability_altered(run_tiny, patch):
    from bask_tpu_torch.parallel import mcmc

    original = mcmc._accept

    def altered(active, lp_active, prop, lp_prop, *args):
        return original(active, lp_active, prop, lp_prop * (1 + 1e-4), *args)
    patch(mcmc, "_accept", altered)
    result = run_tiny("ns15d.fit")
    assert result["checks"]["chain_lp_rel"]["value"] > 5e-5 and not result["correct"]


def test_consensus_lml_altered(run_tiny, patch):
    from bask_tpu_torch.models.bayesgpr import BayesGPR

    original = BayesGPR._set_consensus_from_flat

    def altered(self, flat):
        original(self, flat)
        self.log_marginal_likelihood_value_ *= 1.001
        return self
    patch(BayesGPR, "_set_consensus_from_flat", altered)
    assert not run_tiny("ns15d.fit")["correct"]


def test_recorders_leave_the_program_as_they_found_it(run_tiny):
    from bask_tpu_torch import acquisition
    from bask_tpu_torch.models import pathwise
    from bask_tpu_torch.models import bayesgpr

    def entries():
        return (acquisition.evaluate_acquisitions_fused, acquisition._thompson_probes,
                pathwise.pathwise_topk_hyper, bayesgpr.BayesGPR.sample, bayesgpr.run_ensemble)
    before = entries()
    run_tiny("ns15d.seq_pvrs", seconds=0.5, trace=False)
    assert entries() == before
