"""``examples/experiments/failures.json`` through both facades.

The spec crosses a two-member scenario study with four failure
coordinates: healthy, ``links:0.05`` and ``degrade:0.3:0.5`` (static
masks: plain cells, one stacked ``run``) and ``blip`` (timed events at
300 and 900 µs: cells driven through ``run_window`` rounds with mask
surgery between them). Loaded by both packages' ``load_experiment`` and
run by both ``run``\\ s, the port on the engine's CPU path: the same cells
in the same order, reports equal (the golden's pinned fields exactly,
other floats to rtol 1e-5: ``tests/torch_parity.py``).

Member 1 of ``links:0.05`` loses a link its route needs and runs to the
50 ms horizon, 25,000 ticks of 2 µs in both packages; on the port's
eager CPU path that is most of this file's time (minutes on one core),
so the file stands apart from ``tests/test_torch_experiment.py``.
"""
import os

import pytest
import torch

from repro import union as REF
from repro_torch import union
from repro_torch.union import planner as PLN
from torch_parity import assert_cells_match

SPEC = os.path.join(os.path.dirname(__file__), "..", "examples",
                    "experiments", "failures.json")


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_failures_spec_matches_jax_facade():
    exp = union.load_experiment(SPEC)
    want_exp = REF.load_experiment(SPEC)
    assert exp.to_dict() == want_exp.to_dict()
    assert [f.name for f in exp.grid.failures] == [
        "healthy", "links:0.05", "degrade:0.3:0.5", "blip"]
    plan = PLN.plan(exp)
    assert "failures axis: healthy, links:0.05, degrade:0.3:0.5, blip" in \
        plan.describe()
    (node,) = plan.nodes
    assert [c.failure is not None and c.failure.has_timed_events
            for c in node.cells] == [False] * 6 + [True] * 2

    want = REF.run(want_exp)
    got = union.run(exp, plan=plan, device="cpu")
    assert len(got.cells) == 8
    assert_cells_match(got.cells, want.cells)
    by = {c.key: c.report for c in got.cells}
    # the timed cells ran through their events and finished early; the
    # stalled member ran to the horizon with its job unfinished
    for m in (0, 1):
        rep = by[f"tiny-mix/1d/RN/ADP/blip/m{m}"]
        assert all(rep["config"]["all_done"])
        assert rep["virtual_time_ms"] > 0.2
    stalled = by["tiny-mix/1d/RN/ADP/links:0.05/m1"]
    assert stalled["virtual_time_ms"] == 50.0
    assert stalled["config"]["all_done"] == [False, True]
    assert set(got.summary["scenario_studies"]) == set(
        want.summary["scenario_studies"])
