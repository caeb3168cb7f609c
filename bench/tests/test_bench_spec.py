"""BENCHMARK.json keeps to the benchmark's contract, and the harness
finds every cell's, configuration's and metric's files by name, in
``BENCHMARK.json`` and in the trace kind's rehearsal spec
(``data/trace_cells.json``, a cell for the CPU only)."""
import importlib.util
import json
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
TRACE_SPEC_FILE = BENCH / "tests" / "data" / "trace_cells.json"
SPECS = {ROOT / "BENCHMARK.json": SPEC,
         TRACE_SPEC_FILE: json.loads(TRACE_SPEC_FILE.read_text())}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
# (spec file, name) of every cell, per-layer metric and configuration
ALL_CELLS = [(f, w["name"]) for f, sp in SPECS.items()
             for w in sp["workloads"]]
ALL_METRICS = [(f, m["name"]) for f, sp in SPECS.items()
               for m in sp["per_layer"]]
KINDS = {c["name"]: json.loads((ROOT / c["file"]).read_text()).get(
    "kind", "scenario") for sp in SPECS.values() for c in sp["configs"]}
# each kind's traffic keys and the rate its cells report
KIND_TRAFFIC = {"scenario": {"member_seeds", "checked"},
                "trace": {"seeds", "policies", "checked"}}
KIND_RATES = {"scenario": {"sim_rate", "scenario_rate", "split_rate"},
              "trace": {"trace_rate"}}


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "bench/run.py"]
    assert SPEC["paths"] == ["bench"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_entries_have_just_their_keys_and_valid_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for section, want in keys.items():
        names = [e["name"] for e in SPEC[section]]
        assert len(names) == len(set(names)), section
        for e in SPEC[section]:
            assert set(e) - {"workloads"} == want, (section, e)
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
            for k in ("why", "layer"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
    for c in SPEC["configs"]:
        assert 1 <= len(c["source"]) <= 200 and len(c["reduced"]) <= 16
    all_names = [e["name"] for s in ("end_to_end", "per_layer")
                 for e in SPEC[s]]
    assert len(all_names) == len(set(all_names))


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert {"sim_rate", "scenario_rate", "split_rate", "peak_mem_mib",
            "setup_s"} <= set(e2e)
    assert e2e["setup_s"]["bound"] == 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_cells_pairs_chips_and_configs_used():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] in (1, 4) for w in SPEC["workloads"])
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(
        1, len(CELLS) // 4)
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def test_each_kind_has_its_module_and_each_configuration_its_limits():
    import run

    assert set(KINDS.values()) == set(KIND_TRAFFIC)
    used = {KINDS[c["name"]] for c in SPEC["configs"]}
    assert used <= set(KIND_TRAFFIC)
    for kind in KIND_TRAFFIC:
        mod = run.kind_of({"kind": kind})
        assert callable(mod.Study), kind
    assert run.kind_of({}).__file__.endswith("scenario.py")
    with pytest.raises(run.NoRun):
        run.kind_of({"kind": "no_such_kind"})
    files = [BENCH / "limits" / f"{c['name']}.json" for c in SPEC["configs"]]
    for path in files + [BENCH / "tests" / "data" / "trace_limits.json"]:
        limits = json.loads(path.read_text())
        assert set(limits) == {"exact_leaves_off", "sum_leaves_rel_gap"}
        assert limits["exact_leaves_off"] == 0


@pytest.mark.parametrize("spec,config", [
    (f, c["name"]) for f, sp in SPECS.items() for c in sp["configs"]
    if KINDS[c["name"]] == "trace"], ids=lambda v: getattr(v, "name", v))
def test_trace_configuration_files_load_as_traces(spec, config):
    import importlib.util

    from repro_torch.sched.trace import Trace

    c = {x["name"]: x for x in SPECS[spec]["configs"]}[config]
    assert c["file"].startswith("bench/")
    spec = importlib.util.spec_from_file_location(
        "kind_trace", BENCH / "kinds" / "trace.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    d = json.loads((ROOT / c["file"]).read_text())
    tr = Trace.from_dict(mod.trace_dict(d))
    # a deployment's trace runs on the paper's fabric; the rehearsal's on
    # the small one
    assert tr.scale == ("paper" if spec.name == "BENCHMARK.json"
                        else "small") and tr.name == config
    assert all(j.source and j.ranks for j in tr.jobs)
    assert set(c["reduced"]) <= {"horizon_ms", "iters"}


@pytest.mark.parametrize("config", [c for c, k in KINDS.items()
                                    if k == "scenario"])
def test_configuration_files_load_as_scenarios(config):
    from repro_torch.union.scenario import Scenario

    c = {x["name"]: x for x in SPEC["configs"]}[config]
    assert c["file"].startswith("bench/")
    sc = Scenario.from_json(str(ROOT / c["file"]))
    assert sc.scale == "paper" and sc.name == config
    assert all(j.source and j.ranks for j in sc.jobs)
    assert set(c["reduced"]) <= {"horizon_ms"}
    assert (BENCH / "limits" / f"{config}.json").exists()


@pytest.mark.parametrize("spec,cell", ALL_CELLS,
                         ids=[c for _, c in ALL_CELLS])
def test_each_cell_finds_its_files_and_reports_its_metrics(spec, cell):
    import run

    w, config, e2e, per_layer = run.cell_spec(cell, spec)
    kind = KINDS[w["config"]]
    folder = BENCH / "traffic" if spec == ROOT / "BENCHMARK.json" else (
        spec.parent)
    traffic = json.loads((folder / f"{w['traffic']}.json").read_text())
    assert set(traffic) == KIND_TRAFFIC[kind]
    seeds = traffic.get("member_seeds", traffic.get("seeds"))
    assert len(set(seeds)) == len(seeds)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and names & KIND_RATES[kind]
    if kind == "trace":  # every policy's cells are compared
        assert traffic["checked"] >= len(traffic["policies"])
    assert per_layer


@pytest.mark.parametrize("spec,metric", ALL_METRICS,
                         ids=[m for _, m in ALL_METRICS])
def test_each_per_layer_metric_has_a_reader(spec, metric):
    sp = SPECS[spec]
    m = {x["name"]: x for x in sp["per_layer"]}[metric]
    assert m["moves"] in {e["name"] for e in sp["end_to_end"]}
    cells = [w["name"] for w in sp["workloads"]]
    assert set(m.get("workloads", cells)) <= set(cells)
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("reader", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    empty = dict(spans=[], repeats=[], clean_repeats=[], span_origin_ns=0,
                 replay_profile=None, boundary_profile=None, chips=1)
    assert mod.read(empty) is None  # nothing to read: no number


def test_layers_are_named_alike():
    layers = {m["layer"] for sp in SPECS.values() for m in sp["per_layer"]}
    assert layers == {"facade", "engine loop", "tick", "sim kernels",
                      "device", "member split", "scheduler"}
