"""The plain reference's graph path on the card against its eager path on
the CPU: a scenario's member reports (``Simulator.run``) and a trace
cell's records (``Windows``), both replays of captured tick graphs with
the link demand summed on the host between replays. Skips without a
card:

    python3 -m pytest -q -p no:cacheprovider -m cuda bench/tests/test_bench_reference_cuda.py
"""
import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
DATA = BENCH / "tests" / "data"
sys.path.insert(0, str(BENCH))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the reference's graph path)")
    return "cuda"


@pytest.mark.cuda
def test_member_reports_on_the_card_equal_the_cpus(card):
    import judge
    from reference.study import member_reports

    sc = json.loads((DATA / "tiny.json").read_text())
    seeds = [5, 2147483000]
    got = member_reports(sc, seeds, card)
    want = member_reports(sc, seeds, "cpu")
    n = judge.judge(got, want)
    assert n["exact_leaves_off"] == 0
    assert n["sum_leaves_rel_gap"] < 1e-4


@pytest.mark.cuda
def test_trace_cells_on_the_card_equal_the_cpus(card):
    import judge
    from kinds.trace import SUM_LEAVES, trace_dict
    from reference.sched import run_cell

    tr = trace_dict(json.loads((DATA / "dragonfly1d_trace_small.json")
                               .read_text()))
    for policy in ("fcfs", "easy"):
        got = run_cell(tr, 12, policy, card)
        want = run_cell(tr, 12, policy, "cpu")
        n = judge.judge([got], [want], sums=SUM_LEAVES)
        assert n["exact_leaves_off"] == 0, policy
        assert n["sum_leaves_rel_gap"] < 1e-4
