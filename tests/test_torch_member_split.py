"""The member split across devices: ``Engine.prun`` and the facade's
split of a batched node, on the CPU with the device list patched.

The reference shards a vectorised node's members over its local XLA
devices (``jax.pmap`` of ``run``) when the device count divides them; the
port splits them into one stacked chunk a device and runs the chunks on
the engine's replicas (:meth:`repro_torch.netsim.engine.Engine.prun`).
Here ``repro_torch.device.local_devices`` is patched to a list of 2 or 4
CPU entries: entries of one device share its engine and run in turn.

* ``prun`` over 2 and 4 chunks equals the stacked ``run`` bit for bit in
  every leaf of every member (4 members of a two-job scenario: seeds,
  placements and a later arrival, a rank slowdown, a static fault mask);
  its stats are the replicas' summed;
* the facade with 4 members on 2 devices calls ``prun`` once and its
  cells equal the JAX facade's ``pmap`` path, run in a subprocess on 2
  forced host devices (``torch_parity``'s contract: report fields and
  integers exact, other floats to rtol 1e-5);
* 3 members on 2 devices stay one stacked batch, and ``vmapped=False``
  runs members one by one: ``prun`` is not called;
* the experiment golden's two-member scenario part on 2 devices equals
  the golden exactly;
* replicas come from the engine cache: a second run at the same
  envelope builds nothing, and an engine of ``build_engine`` has none.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import device as DEV
from repro_torch import union
from repro_torch.netsim import engine as ENG
from repro_torch.netsim import faults as F
from repro_torch.union import manager as MGR
from repro_torch.union.scenario import Scenario, ScenarioJob
from test_experiment import AR, PP
from test_torch_experiment import GOLDEN, assert_member_matches, tiny_scenario
from torch_parity import assert_bitwise_equal, report_mismatches

SRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src")

# the JAX facade's pmap path: 4 members of the tiny scenario on 2 forced
# host devices, the cells written as JSON
JAX_SPLIT = r"""
import json, sys
import jax
from repro import union
from repro.union.scenario import Scenario
assert jax.local_device_count() == 2, jax.local_device_count()
sc = Scenario.from_dict(json.loads(sys.argv[1]))
res = union.run(union.Experiment(name="split", scenarios=[sc], members=4))
with open(sys.argv[2], "w") as f:
    json.dump([c.to_dict() for c in res.cells], f)
"""


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """The engine's CPU path runs many small ops; one intra-op thread is
    faster than many when test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def jax_split(tmp_path_factory):
    """The JAX facade's cells, started with the module in a subprocess so
    that it runs beside the port's tests; waited for where read."""
    out = str(tmp_path_factory.mktemp("jax_split") / "cells.json")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SPLIT,
         json.dumps(tiny_scenario().to_dict()), out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def cells():
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, log[-3000:]
        with open(out) as f:
            return json.load(f)

    yield cells
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture
def devices(monkeypatch):
    """``local_devices`` patched to ``n`` CPU entries; ``calls`` counts
    ``Engine.prun``'s calls."""
    calls = []
    prun = ENG.Engine.prun

    def spy(self, states, *a, **kw):
        calls.append(len(states))
        return prun(self, states, *a, **kw)

    monkeypatch.setattr(ENG.Engine, "prun", spy)

    def patch(n):
        monkeypatch.setattr(DEV, "local_devices",
                            lambda device=None: [torch.device("cpu")] * n)
        return calls

    return patch


def split_scenario():
    """Two jobs on the small 1D dragonfly: an 8-rank allreduce and a
    ping-pong that arrives later."""
    return Scenario(
        name="split",
        jobs=[ScenarioJob(app="ar8", source=AR, ranks=8),
              ScenarioJob(app="pp1", source=PP, ranks=2, start_us=100.0)],
        placement="RN", tick_us=2.0, horizon_ms=50.0, pool_size=256)


@pytest.fixture(scope="module")
def members():
    """The bound engine, 4 member states that differ in every input
    ``init_state`` takes, and their stacked run."""
    rs = MGR.resolve(split_scenario(), seed=3)
    eng = MGR.build(rs, device="cpu")
    other = MGR.resolve(split_scenario(), seed=9)
    P0 = rs.jobs[0].skeleton.n_ranks
    slow = torch.ones(P0).numpy()
    slow[: P0 // 4] = 1.5
    states = [
        eng.init_state(seed=11),
        eng.init_state(seed=12, placements=other.placements(9),
                       start_us=[0.0, 400.0]),
        eng.init_state(seed=13, rank_slowdown_override=[slow, None]),
        eng.init_state(seed=14, faults=F.parse_failure(
            "degrade:0.1:0.25").initial_state(rs.topo, 2)),
    ]
    stacked = eng.run(ENG.stack_members(states))
    return dict(eng=eng, rs=rs, states=states, stacked=stacked,
                stacked_stats=eng.last_run)


@pytest.mark.parametrize("D", [2, 4])
def test_prun_equals_the_stacked_run(members, D):
    eng, states = members["eng"], members["states"]
    chunk = len(states) // D
    finals = eng.prun([ENG.stack_members(states[d * chunk:(d + 1) * chunk])
                       for d in range(D)])
    assert len(finals) == D
    for i in range(len(states)):
        assert_bitwise_equal(
            ENG.member_state(finals[i // chunk], i % chunk),
            ENG.member_state(members["stacked"], i))
    st = eng.last_run
    assert len(st.replicas) == D and st.device == "cpu"
    assert st.ticks == sum(r.ticks for r in st.replicas) > 0
    assert st.ticks >= members["stacked_stats"].ticks
    assert st.liveness_reads == sum(r.liveness_reads for r in st.replicas)


def test_members_differ(members):
    st = members["stacked"]
    rows = {tuple(st.metrics.lat_sum[i].tolist()) for i in range(4)}
    assert len(rows) == 4
    assert bool((st.faults.link_bw_factor[3] == 0.25).any())
    assert float(st.jobs.slowdown[2, 0, 0]) == 1.5


def test_facade_split_matches_jax_pmap(devices, jax_split):
    calls = devices(2)
    exp = union.Experiment(name="split", scenarios=[tiny_scenario()],
                           members=4)
    got = union.run(exp, device="cpu")
    assert calls == [2]
    tot = got.telemetry["engine"]["batched"]
    assert tot["calls"] == 1 and tot["ticks"] > 0
    want = jax_split()
    got_d = json.loads(json.dumps([c.to_dict() for c in got.cells]))
    assert [(c["name"], c["seed"], c["member"]) for c in got_d] == [
        (c["name"], c["seed"], c["member"]) for c in want]
    for g, w in zip(got_d, want):
        gr, wr = g.pop("report"), w.pop("report")
        assert g == w
        bad = report_mismatches(gr, wr, f"cell {g['member']}")
        assert not bad, bad[:10]


def test_facade_split_equals_stacked(devices):
    """The same study on 2 devices and on one: the same reports, host
    times aside."""
    exp = union.Experiment(name="split", scenarios=[split_scenario()],
                           members=4, base_seed=5)
    devices(1)
    one = union.run(exp, device="cpu")
    calls = devices(2)
    two = union.run(exp, device="cpu")
    assert calls == [2]
    for a, b in zip(two.cells, one.cells):
        assert report_mismatches(a.report, b.report, exact=True) == []


def test_golden_on_two_devices(devices):
    calls = devices(2)
    with open(GOLDEN) as f:
        golden = json.load(f)
    res = union.run(union.Experiment(
        name="tiny", scenarios=[tiny_scenario()], members=2), device="cpu")
    assert calls == [2]
    assert len(res.cells) == 2
    for cell, g in zip(res.cells, golden["scenario"]["members"]):
        assert_member_matches(cell.report, g)


def test_three_members_on_two_devices_stay_stacked(devices):
    calls = devices(2)
    res = union.run(union.Experiment(
        name="tiny", scenarios=[tiny_scenario()], members=3), device="cpu")
    assert calls == [] and len(res.cells) == 3
    assert res.telemetry["engine"]["batched"]["calls"] == 1


def test_unvectorised_members_run_one_by_one(devices):
    calls = devices(2)
    res = union.run(union.Experiment(
        name="tiny", scenarios=[tiny_scenario()], members=4,
        vmapped=False), device="cpu")
    assert calls == [] and len(res.cells) == 4
    assert res.telemetry["engine"]["batched"]["calls"] == 4


def test_replicas_come_from_the_engine_cache(devices, members):
    devices(4)
    exp = union.Experiment(name="tiny", scenarios=[tiny_scenario()],
                           members=4, base_seed=40)
    union.run(exp, device="cpu")
    again = union.run(exp, device="cpu")
    assert again.engine_cache["builds"] == 0
    assert again.engine_cache["hits"] >= 1
    # a bound engine's replica on its own device is the cached engine,
    # whose captured graphs it shares
    eng = members["eng"]
    s0 = ENG.engine_cache_stats()
    rep = eng.replica(torch.device("cpu"))
    s1 = ENG.engine_cache_stats()
    assert rep is not eng and rep.graphs is eng.graphs
    assert (s1["hits"], s1["builds"]) == (s0["hits"] + 1, s0["builds"])
    assert eng.replica(torch.device("cpu")) is rep


def test_an_uncached_engine_has_no_replicas(members):
    rs = members["rs"]
    eng = ENG.build_engine(rs.topo, rs.jobs, ur=rs.ur, net=rs.net,
                           pool_size=rs.pool_size, device="cpu")
    assert eng.replica is None
    on_meta = ENG.state_to(members["states"][0], "meta")
    with pytest.raises(ValueError, match="no replica on meta"):
        eng.prun([ENG.stack_members([members["states"][0]]), on_meta])


def test_local_devices():
    assert DEV.local_devices("cpu") == [torch.device("cpu")]
    assert DEV.local_devices("meta") == [torch.device("meta")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DEV.local_devices()
