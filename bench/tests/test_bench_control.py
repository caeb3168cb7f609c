"""The control: the reference in the precision below the simulator's
float32 (bfloat16), put in the program's place, is judged not correct by
the configurations' limits; the float32 reference against itself is."""
import json
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
DATA = BENCH / "tests" / "data"


@pytest.mark.parametrize("config", ["dragonfly1d_workload1",
                                    "dragonfly2d_workload3"])
def test_bfloat16_reference_fails_the_limits(config):
    import judge
    from reference.study import member_reports

    torch.set_num_threads(1)
    sc = json.loads((DATA / "tiny.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{config}.json").read_text())
    seeds = [5, 2147483000]
    want = member_reports(sc, seeds, "cpu")
    ok, _ = judge.verdict(judge.judge(want, want), limits)
    assert ok
    control = member_reports(sc, seeds, "cpu", fdt=torch.bfloat16)
    numbers = judge.judge(control, want)
    ok, _ = judge.verdict(numbers, limits)
    assert not ok
    assert numbers["exact_leaves_off"] > 0
    assert numbers["sum_leaves_rel_gap"] > 100 * limits["sum_leaves_rel_gap"]
