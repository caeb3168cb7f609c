"""``python -m repro_torch.union`` against ``python -m repro.union``.

Both CLIs' ``main(argv)`` run in this process on the same arguments (the
port's with ``--device cpu``): the verify skill's tiny scenario as a
three-member campaign prints the same summary and writes the same result
file, wall times left out; ``--list``, ``--plan`` and ``--emit`` print and
write the same; a cross-fabric ``--plan`` names the same nodes.
"""
import json
import os
import re

import pytest
import torch

from repro.union import cli as REF_CLI
from repro.union.experiment import Results as RefResults
from repro_torch.union import cli as CLI
from repro_torch.union.experiment import Results
from torch_parity import assert_cells_match

TINY = {
    "name": "tiny", "placement": "RN", "tick_us": 2.0, "horizon_ms": 50.0,
    "pool_size": 256,
    "jobs": [{"app": "pp", "ranks": 2, "source": (
        "For 4 repetitions { task 0 sends a 1024 byte message to task 1 "
        "then task 1 sends a 1024 byte message to task 0 }")}],
}
# wall-clock readings in the printed summary: "in 5.8s", "wall=0.3s",
# "(10.25 members/s)"
WALL = re.compile(r"\d+\.\d+s\b|\(\d+\.\d+ members/s\)")


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both(capsys, tmp_path, argv, out=True):
    """Run both CLIs on ``argv`` (``{out}`` -> a directory each); return
    their printed lines (wall times masked, the out directory replaced by
    ``OUT``) and their out directories."""
    runs = []
    for name, main, extra in (("ref", REF_CLI.main, []),
                              ("port", CLI.main, ["--device", "cpu"])):
        d = tmp_path / name
        args = [a.replace("{out}", str(d)) for a in argv]
        if out:
            args += ["--out", str(d)]
        main(args + extra)
        text = capsys.readouterr().out.replace(str(d), "OUT")
        runs.append((WALL.sub("T", text).splitlines(), d))
    return runs


def test_tiny_campaign_matches(capsys, tmp_path):
    # the summary prints each package's engine-cache traffic: start both
    # caches empty
    from repro.netsim.engine import clear_engine_cache as ref_clear
    from repro_torch.netsim.engine import clear_engine_cache

    ref_clear()
    clear_engine_cache()
    spec = tmp_path / "tiny.json"
    spec.write_text(json.dumps(TINY))
    (want, wdir), (got, gdir) = both(
        capsys, tmp_path, ["--scenario", str(spec), "--members", "3"])
    assert got == want
    assert got[-1] == "wrote OUT/tiny__1d__RN__ADP__small__m3_s0.json"
    assert sorted(os.listdir(gdir)) == sorted(os.listdir(wdir))
    for fname in os.listdir(wdir):
        w = RefResults.load(str(wdir / fname))
        g = Results.load(str(gdir / fname))
        assert g.experiment == w.experiment
        assert_cells_match(g.cells, w.cells)
        assert set(g.summary) == set(w.summary)


def test_list_plan_and_emit_match(capsys, tmp_path):
    (want, _), (got, _) = both(capsys, tmp_path, ["--list"], out=False)
    assert got == want and got[0].startswith("builtin mixes")
    fabrics = os.path.join(os.path.dirname(__file__), os.pardir, "examples",
                           "experiments", "fabrics.json")
    (want, _), (got, _) = both(capsys, tmp_path,
                               ["--experiment", fabrics, "--plan"],
                               out=False)
    assert got == want and len(got) > 3
    (want, _), (got, _) = both(
        capsys, tmp_path,
        ["--scenario", "workload1", "--members", "4", "--placements", "RN",
         "RG", "--baselines", "--plan"], out=False)
    assert got == want
    (want, wdir), (got, gdir) = both(
        capsys, tmp_path, ["--scenario", "workload2", "--iters", "2",
                           "--topo", "torus", "--emit", "{out}.json"],
        out=False)
    assert got == [line.replace("ref.json", "port.json") for line in want]
    assert json.loads((tmp_path / "port.json").read_text()) == \
        json.loads((tmp_path / "ref.json").read_text())
