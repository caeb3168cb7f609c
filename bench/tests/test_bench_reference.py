"""The plain reference against the port: the small forms of both
configurations (the paper's mixes on the small 1D and 2D dragonflies)
through ``repro_torch.union.run`` on the CPU and through the reference,
every report leaf equal."""
import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]
DATA = BENCH / "tests" / "data"


@pytest.mark.parametrize("scenario", [
    "dragonfly1d_workload1_small.json", "dragonfly2d_workload3_small.json"])
def test_reference_reports_equal_the_ports(scenario):
    import judge
    from reference.study import member_reports
    from repro_torch import union
    from repro_torch.union.scenario import Scenario

    torch.set_num_threads(1)
    sc = json.loads((DATA / scenario).read_text())
    seeds = [2147483000, 12]
    res = union.run(union.Experiment(
        name="ref", scenarios=[Scenario.from_dict(sc)], members=len(seeds),
        seeds=seeds), device="cpu")
    got = [c.report for c in res.scenario_cells]
    want = member_reports(sc, seeds, "cpu")
    assert all(sum(a["count"] for a in r["latency"].values()) > 100
               for r in want)
    numbers = judge.judge(got, want)
    assert numbers["exact_leaves_off"] == 0
    assert numbers["sum_leaves_rel_gap"] == 0.0
    assert numbers["leaves"] > 70 * len(seeds)
