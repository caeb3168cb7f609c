"""The harness on the CPU: a rehearsal of a run at a small size prints a
result line of the contract's shape with no module of JAX or the JAX
package loaded; the benchmark's own code imports neither (and the
reference nothing of the program); without a card the harness prints no
result; the judge and the member sampling."""
import ast
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
DATA = BENCH / "tests" / "data"
sys.path.insert(0, str(BENCH))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def rehearse(*extra, workload="df1d_w1.study8"):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, str(BENCH / "tests" / "rehearse.py"), workload,
         str(DATA / "tiny.json"), str(DATA / "tiny_traffic.json"), *extra],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1]), res.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_benchmark_sources_import_no_jax_and_no_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not set(_imports(f)) & FORBIDDEN, f


def test_reference_imports_nothing_of_the_program():
    for f in sorted((BENCH / "reference").glob("*.py")):
        assert not set(_imports(f)) & (FORBIDDEN | {"repro_torch"}), f


def test_rehearsal_prints_the_contracts_line_without_jax():
    out, err = rehearse()
    res = out["result"]
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] == 4
    assert res["device"]["platform"] == "cpu"
    assert res["device"]["memory_peak_bytes"] is None  # not measured
    assert res["checks"]["exact_leaves_off"] == dict(value=0, limit=0)
    # traced on the CPU: only host readings, never a device number
    assert set(res["metrics"]) <= {"facade.host_share",
                                   "engine.ticks_per_vms"}
    assert "facade.host_share" in res["metrics"]
    assert not set(out["modules"]) & FORBIDDEN
    assert {"repro_torch", "reference", "torch"} <= set(out["modules"])
    assert err.strip().splitlines()[-1] == "correct: True"


def test_without_a_card_the_harness_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the run would measure")
    res = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "df1d_w1.study8", "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 2
    assert res.stdout == ""
    assert "no CUDA device" in res.stderr


def test_judge_counts_missing_reports_and_compares_sums_by_gap():
    import judge

    want = {"dropped": 0, "latency": {"a": {"count": 3, "avg_us": 2.0}},
            "link_load": {"levels": ["local"], "local_total_bytes": 10.0},
            "sim_wall_s": 1.0}
    got = json.loads(json.dumps(want))
    got["sim_wall_s"] = 5.0
    got["latency"]["a"]["avg_us"] = 2.0 * (1 + 1e-6)
    n = judge.judge([got, None], [want, want])
    assert n["exact_leaves_off"] == 5  # the missing report's leaves
    assert n["sum_leaves_rel_gap"] == pytest.approx(1e-6)
    got["latency"]["a"]["count"] = 4
    assert judge.judge([got], [want])["exact_leaves_off"] == 1
    ok, rows = judge.verdict(dict(exact_leaves_off=0, sum_leaves_rel_gap=0.5),
                             dict(exact_leaves_off=0, sum_leaves_rel_gap=1))
    assert ok and rows[0] == ("exact_leaves_off", 0, 0)
    assert math.isnan(float("nan")) and judge._same(float("nan"),
                                                    float("nan"))


def test_checked_members_cover_every_position_first():
    import studygen

    picks = studygen.checked_members(2**31 + 7, repeats=3, members=4,
                                     checked=6)
    assert len(set(picks)) == 6
    assert sorted(p for _, p in picks[:4]) == [0, 1, 2, 3]
    assert all(0 <= r < 3 for r, _ in picks)
    assert picks == studygen.checked_members(2**31 + 7, 3, 4, 6)
    assert len(studygen.checked_members(1, repeats=2, members=1,
                                        checked=8)) == 2


def test_warmup_members_are_none_of_the_windows():
    import studygen

    tr = json.loads((BENCH / "traffic" / "study8.json").read_text())
    gen = studygen.MemberSeeds(tr, 2**31 + 11)
    assert gen.block() == tr["member_seeds"] == gen.block()
    warm = gen.warmup()
    assert len(warm) == 8 and not set(warm) & set(tr["member_seeds"])
    assert warm == studygen.MemberSeeds(tr, 2**31 + 11).warmup()
