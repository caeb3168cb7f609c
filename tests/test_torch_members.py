"""Member batches of the port's engine against the JAX package's.

On the ``equiv-mix`` golden scenario (two jobs and UR background on the
small 1D dragonfly, pool 512, tick 2 µs), three members that differ in
every per-member input ``init_state`` takes:

* member 0: the scenario's own placements, engine seed 11;
* member 1: the placements (jobs and UR) of another placement seed, the
  second job arriving later (``start_us``), engine seed 12;
* member 2: a rank slowdown of 1.5 on a tenth of the first job's ranks
  and a fault mask (a tenth of the fabric links at a quarter of their
  bandwidth: a dead local link can stall a message until the horizon,
  40,000 ticks here), engine seed 13.

The port's batch (``stack_members`` then ``run``) equals the JAX
engine's ``stack_members`` batch of the same members leaf by leaf
(integers exact, floats to rtol 1e-5), and each member of the port's
batch equals its own B = 1 run bit for bit. The per-member arguments
(``rank_slowdown_override``, ``start_us``, ``jobs_override``) pack the
reference's job tables.
"""
import jax
import numpy as np
import pytest
import torch

from repro.netsim import engine as REF_ENG
from repro.netsim import faults as REF_F
from repro.union import manager as REF_MGR
from repro_torch.netsim import engine as ENG
from repro_torch.netsim import faults as F
from repro_torch.union import manager as MGR
from repro_torch.union.scenario import Scenario
from test_engine_equivalence import CASES
from torch_parity import assert_bitwise_equal, assert_port_equals_ref


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """The engine's CPU path runs many small ops; one intra-op thread is
    faster than many when test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _members(ref_rs, topo):
    """Three members' init_state arguments (numpy), the same for both
    packages."""
    other = REF_MGR.resolve(CASES["equiv-mix"][0](), seed=7)
    placements = [np.asarray(j.rank2node) for j in other.jobs] + [
        np.asarray(other.ur.rank2node)]
    P0 = ref_rs.jobs[0].skeleton.n_ranks
    slow = np.ones(P0, np.float32)
    slow[: max(1, P0 // 10)] = 1.5
    return [
        dict(seed=11),
        dict(seed=12, placements=placements, start_us=[0.0, 900.0]),
        dict(seed=13, rank_slowdown_override=[slow, None],
             faults="degrade:0.1:0.25"),
    ]


def _with_mask(kw, mask_of):
    kw = dict(kw)
    if "faults" in kw:
        kw["faults"] = mask_of(kw["faults"])
    return kw


@pytest.fixture(scope="module")
def batches():
    make, seed = CASES["equiv-mix"]
    ref_rs = REF_MGR.resolve(make(), seed=seed)
    members = _members(ref_rs, ref_rs.topo)
    ref_eng = REF_MGR.build(ref_rs)
    ref_states = [ref_eng.init_state(**_with_mask(
        kw, lambda s: REF_F.parse_failure(s).initial_state(ref_rs.topo, 2)))
        for kw in members]
    ref = jax.block_until_ready(
        ref_eng.run(REF_ENG.stack_members(ref_states)))

    rs = MGR.resolve(Scenario.from_dict(make().to_dict()), seed=seed)
    eng = MGR.build(rs, device="cpu")
    states = [eng.init_state(**_with_mask(
        kw, lambda s: F.parse_failure(s).initial_state(rs.topo, 2)))
        for kw in members]
    port = eng.run(ENG.stack_members(states))
    solo = [eng.run(s) for s in states]
    return dict(ref=ref, port=port, solo=solo, rs=rs, eng=eng)


def test_batch_matches_reference_batch(batches):
    assert batches["port"].t.shape == (3,)
    assert_port_equals_ref(batches["port"], batches["ref"])


@pytest.mark.parametrize("i", range(3))
def test_each_member_equals_its_own_run(batches, i):
    assert_bitwise_equal(ENG.member_state(batches["port"], i),
                         batches["solo"][i])


def test_members_differ_and_finish(batches):
    port = batches["port"]
    # every member differs from the others in its trajectory
    ts = port.t.tolist()
    cnt = port.metrics.lat_cnt.tolist()
    assert len({(t, tuple(c)) for t, c in zip(ts, cnt)}) == 3
    for i in range(3):
        m = ENG.member_state(port, i)
        assert all(ENG.job_done(m, ji) for ji in range(2))
        assert int(m.pool.dropped) == 0
    assert float(port.jobs.start[1, 1]) == 900.0
    assert bool((port.faults.link_bw_factor[2] == 0.25).any())
    assert float(port.jobs.slowdown[2, 0, 0]) == 1.5
    assert batches["eng"].capacity == batches["rs"].capacity


def test_member_arguments_pack_the_reference_tables():
    make, seed = CASES["equiv-mix"]
    ref_rs = REF_MGR.resolve(make(), seed=seed)
    rs = MGR.resolve(Scenario.from_dict(make().to_dict()), seed=seed)
    P0 = rs.jobs[0].skeleton.n_ranks
    slow = [np.linspace(1.0, 2.0, P0).astype(np.float32), None]
    eng = ENG.build_engine(rs.topo, rs.jobs, ur=rs.ur, net=rs.net,
                           pool_size=rs.pool_size, device="cpu")
    ref_eng = REF_ENG.build_engine(ref_rs.topo, ref_rs.jobs, ur=ref_rs.ur,
                                   net=ref_rs.net, pool_size=ref_rs.pool_size)
    kw = dict(rank_slowdown_override=slow, start_us=[50.0, 300.0])
    pairs = [(eng.init_state(**kw), ref_eng.init_state(**kw)),
             (eng.init_state(jobs_override=rs.jobs[:1]),
              ref_eng.init_state(jobs_override=ref_rs.jobs[:1]))]
    for got, want in pairs:
        for name in ENG.JobTable._fields:
            np.testing.assert_array_equal(
                getattr(got.jobs, name).numpy(),
                np.asarray(getattr(want.jobs, name)), err_msg=name)
    got, st = pairs[0][0], pairs[1][0]
    assert got.jobs.start.tolist() == [50.0, 300.0]
    assert got.jobs.slowdown[0, :P0].tolist() == slow[0].tolist()
    # a job set override with no other argument: the job's own tables,
    # the empty slot padded
    assert st.jobs.start.tolist()[0] == float(rs.jobs[0].start_us)
    assert bool((st.jobs.slowdown == 1.0).all())
    assert float(st.jobs.start[1]) == float("inf")
