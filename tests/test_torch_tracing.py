"""The port's tracing on the CPU: the spans of the facade, the engine loop
and the member split, what a run records with tracing off, and the spans
in a ``torch.profiler`` profile.

* with tracing off a facade run records no span and no part field, and a
  run after a traced one keeps the engine's graphs and counts;
* with tracing on the facade emits ``union.member_report`` once a member,
  ``engine.stack``, ``engine.chunk``, ``engine.unstack`` and
  ``union.summarize``, and its reports equal the untraced run's bit for
  bit (host wall times aside);
* ``Engine.prun`` on one CPU group emits ``engine.prun`` and one
  ``engine.replica`` with its members, device time and wait;
* under a CPU profile each span is a CPU event of the same name;
* ``RunStats.merged`` and the facade's totals carry the part times.
"""
import json

import pytest
import torch

from repro_torch import obs, union
from repro_torch.netsim import engine as ENG
from repro_torch.union import experiment as EXP
from repro_torch.union import manager as MGR
from repro_torch.union.scenario import Scenario, ScenarioJob

PP = ("For 4 repetitions { task 0 sends a 1024 byte message to task 1 "
      "then task 1 sends a 1024 byte message to task 0 }")


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tracer():
    """The process's tracer, cleared, with tracing off again after the
    test."""
    tr = obs.get_tracer()
    tr.clear()
    yield tr
    obs.disable()
    tr.clear()


def tiny():
    return Scenario(name="tiny", jobs=[ScenarioJob(app="pp", source=PP,
                                                   ranks=2)],
                    placement="RN", tick_us=2.0, horizon_ms=5.0,
                    pool_size=256)


def study(members=2):
    return union.run(union.Experiment(name="t", scenarios=[tiny()],
                                      members=members), device="cpu")


def reports(res):
    out = [dict(c.report) for c in res.scenario_cells]
    for r in out:
        r.pop("sim_wall_s")  # host wall time
    return json.dumps(out, sort_keys=True)


def names(tr):
    return [e["name"] for e in tr.events if e.get("ph") != "C"]


def test_untraced_run_records_no_spans_and_no_parts(tracer):
    rs = MGR.resolve(tiny(), seed=3)
    eng = MGR.build(rs, device="cpu")
    state = eng.init_state(seed=5)
    eng.run(state)
    before = (set(eng.graphs), eng.last_run.graph_launches)
    obs.enable()
    eng.run(state)
    obs.disable()
    assert "engine.chunk" in names(tracer)
    tracer.clear()
    eng.run(state)
    st = eng.last_run
    assert (set(eng.graphs), st.graph_launches) == before
    assert st.part_device_ms == {} and st.part_ticks == 0
    res = study()
    assert tracer.events == []
    eng_tot = res.telemetry["engine"]["batched"]
    assert "part_device_ms" not in eng_tot and "part_ticks" not in eng_tot
    assert res.telemetry["spans"] == {}


def test_traced_facade_emits_its_spans_and_the_same_reports(tracer):
    plain = study(members=3)
    obs.enable()
    traced = study(members=3)
    obs.disable()
    got = names(tracer)
    assert got.count("union.member_report") == 3
    seeds = sorted(e["args"]["seed"] for e in tracer.events
                   if e["name"] == "union.member_report")
    assert seeds == sorted(c.seed for c in traced.scenario_cells)
    for name in ("engine.stack", "engine.chunk", "engine.unstack",
                 "union.summarize"):
        assert name in got, name
    stack = next(e for e in tracer.events if e["name"] == "engine.stack")
    assert stack["args"] == dict(members=3, device="cpu")
    # no device number on the CPU
    assert "device_ms" not in str([e.get("args") for e in tracer.events
                                   if e["name"] == "engine.chunk"])
    assert reports(traced) == reports(plain)
    assert "part_ticks" not in traced.telemetry["engine"]["batched"]


def test_prun_on_one_group_emits_prun_and_one_replica(tracer):
    rs = MGR.resolve(tiny(), seed=3)
    eng = MGR.build(rs, device="cpu")
    batch = ENG.stack_members([eng.init_state(seed=s) for s in (5, 6)])
    obs.enable()
    eng.prun([batch])
    obs.disable()
    prun = [e for e in tracer.events if e["name"] == "engine.prun"]
    reps = [e for e in tracer.events if e["name"] == "engine.replica"]
    assert len(prun) == 1 and prun[0]["args"] == dict(replicas=1)
    assert len(reps) == 1
    args = reps[0]["args"]
    assert (args["device"], args["members"]) == ("cpu", 2)
    assert args["replay_device_ms"] == 0.0 and args["wait_ms"] >= 0.0
    # the replica's span lies inside the call's
    p, r = prun[0], reps[0]
    assert p["ts_us"] <= r["ts_us"]
    assert r["ts_us"] + r["dur_us"] <= p["ts_us"] + p["dur_us"]


def test_spans_are_cpu_events_of_a_profile(tracer):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        study()  # tracing off: no labels
        obs.enable()
        study()
        obs.disable()
    profiled = [e.name for e in prof.events()]
    spans = set(names(tracer))
    assert {"union.run", "union.member_report", "engine.chunk",
            "union.summarize"} <= spans
    for name in spans:
        assert profiled.count(name) == names(tracer).count(name), name


def test_part_times_are_merged_and_totalled():
    a = ENG.RunStats(device="cuda", ticks=64, replays=8, graph_ticks=8,
                     part_device_ms=dict(emit=1.0, drain=0.5), part_ticks=8)
    b = ENG.RunStats(device="cuda", ticks=64, replays=8, graph_ticks=8,
                     part_device_ms=dict(emit=2.0, drain=0.25), part_ticks=8)
    m = ENG.RunStats.merged("cuda", [a, b])
    assert m.part_device_ms == dict(emit=3.0, drain=0.75)
    assert m.part_ticks == 16
    tot = EXP._engine_totals()
    EXP._add_run(tot, ENG.RunStats(device="cuda"))
    assert "part_device_ms" not in tot
    EXP._add_run(tot, m)
    EXP._add_run(tot, a)
    assert tot["part_device_ms"] == dict(emit=4.0, drain=1.25)
    assert tot["part_ticks"] == 24

