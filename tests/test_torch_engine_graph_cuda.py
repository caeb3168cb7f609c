"""The engine's ``run`` on the card: replays of a captured CUDA graph.

Needs an NVIDIA GPU and ``nvcc`` (the simulator's kernels are built at
first use); skips without a card. Imports nothing of JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_engine_graph_cuda.py

On the two engine goldens' scenarios (``equiv-mix`` seed 3,
``equiv-coll`` seed 5, as ``tests/test_engine_equivalence.py`` builds
them), under the contract of ``tests/test_engine_equivalence.py:98-135``
(integers exact, floats to rtol 1e-5: float sums taken by atomics on the
card vary in their last bits):

* the graph ``run`` equals an eager loop of ``tick``;
* chunk sizes 1, 12, 48 and 64 give one result (graphs of 1, 4, 8 and
  8 ticks);
* a second ``run`` call leaves the state the first one returned alone;
* a batch of three members on an engine with probes and histograms, one
  member with a fault mask, equals each member's own B = 1 run;
* a capture that fails raises; ``run`` never steps the ticks eagerly.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops as KOPS
from repro_torch.netsim import engine as ENG
from repro_torch.netsim import faults as F
from repro_torch.obs import HistConfig, ProbeConfig
from repro_torch.union import manager as MGR
from repro_torch.union.scenario import Scenario, ScenarioJob, URDecl
from repro_torch.union.seeds import engine_seed
from torch_parity import assert_port_states_close

PP = (
    "For 4 repetitions {\n"
    " task 0 sends a 4096 byte message to task 1 then\n"
    " task 1 sends a 4096 byte message to task 0 }"
)
AR = (
    "For 3 repetitions {\n"
    " all tasks allreduce a 65536 byte message then\n"
    " all tasks compute for 200 microseconds }"
)
COLL = (
    "For 2 repetitions {\n"
    " all tasks exchange a 2048 byte message with their neighbors"
    " in a 2x2x2 grid then\n"
    " task 0 multicasts a 4096 byte message to all other tasks then\n"
    " all tasks allreduce a 512 byte message then\n"
    " task 0 asynchronously sends a 1024 byte message to all other tasks then\n"
    " all tasks synchronize then\n"
    " all tasks compute for 50 microseconds }"
)


def golden_scenarios():
    """The engine goldens' scenarios (``tests/data_engine_golden.json``)
    and their seeds, in the port's own scenario classes."""
    mix = Scenario(
        name="equiv-mix",
        jobs=[ScenarioJob(app="ar8", source=AR, ranks=8),
              ScenarioJob(app="pp2", source=PP, ranks=2, start_us=700.0)],
        placement="RN", routing="ADP",
        ur=URDecl(ranks=16, size_bytes=4096.0, interval_us=300.0),
        tick_us=2.0, horizon_ms=80.0, pool_size=512,
    )
    coll = Scenario(
        name="equiv-coll",
        jobs=[ScenarioJob(app="coll8", source=COLL, ranks=8),
              ScenarioJob(app="pp2", source=PP, ranks=2, start_us=150.0)],
        placement="RN", routing="ADP", tick_us=2.0, horizon_ms=60.0,
        pool_size=512,
    )
    return {"equiv-mix": (mix, 3), "equiv-coll": (coll, 5)}


def eager_run(eng, state, horizon_us, chunk=64):
    """``run``'s loop with eager ticks: liveness read once a chunk."""
    batched = state.t.dim() == 1
    s = state if batched else ENG._tree_map(lambda x: x[None], state)
    while bool(ENG.member_live(s, horizon_us).any()):
        for _ in range(chunk):
            s = eng.tick(s)
    return s if batched else ENG.member_state(s, 0)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run captures CUDA graphs of the "
                    "tick; the CPU path is the eager loop)")
    return torch.device("cuda", 0)


def _engine(case, dev, **kw):
    sc, seed = golden_scenarios()[case]
    rs = MGR.resolve(sc, seed=seed)
    eng = MGR.build(rs, device=dev, **kw)
    # a scenario's engine shares the cached engine's graphs: each test
    # starts from a fresh capture
    eng.drop_graphs()
    return rs, eng, engine_seed(seed)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(golden_scenarios()))
def test_graph_run_equals_eager_ticks(card, case):
    rs, eng, seed = _engine(case, card)
    got = eng.run(eng.init_state(seed=seed))
    stats = eng.last_run
    assert stats.device == "cuda" and stats.captured and stats.replays > 0
    assert stats.ticks == stats.replays * stats.graph_ticks
    assert stats.graph_launches["drain_tick"] == stats.graph_ticks
    assert stats.graph_calls == stats.graph_launches
    want = eager_run(eng, eng.init_state(seed=seed), rs.horizon_us)
    assert_port_states_close(got, want)


@pytest.mark.cuda
def test_chunk_sizes_give_one_result(card):
    rs, eng, seed = _engine("equiv-coll", card)
    base = eng.run(eng.init_state(seed=seed), chunk=64)
    for chunk, per_graph in ((1, 1), (12, 4), (48, 8)):
        got = eng.run(eng.init_state(seed=seed), chunk=chunk)
        assert eng.last_run.graph_ticks == per_graph
        assert_port_states_close(got, base)


@pytest.mark.cuda
def test_returned_state_is_a_copy(card):
    rs, eng, seed = _engine("equiv-mix", card)
    first = eng.run(eng.init_state(seed=seed))
    kept = ENG._tree_map(torch.clone, first)
    second = eng.run(eng.init_state(seed=seed, start_us=[0.0, 2000.0]))
    assert not eng.last_run.captured  # the cached graph replayed
    assert float(second.t) > float(first.t)
    for a, b in zip(ENG._leaves(first), ENG._leaves(kept)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_observed_faulted_batch_equals_its_members(card):
    rs, eng, seed = _engine("equiv-mix", card, probes=ProbeConfig(),
                            hist=HistConfig())
    mask = F.parse_failure("degrade:0.1:0.25").initial_state(rs.topo, 1)
    members = [eng.init_state(seed=seed),
               eng.init_state(seed=seed + 7, faults=mask),
               eng.init_state(seed=seed + 9, start_us=[0.0, 300.0])]
    batch = eng.run(ENG.stack_members(members))
    assert eng.last_run.captured and batch.t.shape == (3,)
    for i, m in enumerate(members):
        solo = eng.run(m)
        assert_port_states_close(ENG.member_state(batch, i), solo)
        assert int(solo.probes.idx) > 0
        np.testing.assert_array_equal(
            solo.hist.counts.sum((1, 2)).cpu().numpy(),
            solo.metrics.lat_cnt.cpu().numpy())


@pytest.mark.cuda
def test_failed_capture_raises(card, monkeypatch):
    """A host sync inside the tick cannot be captured: ``run`` raises and
    returns no state (no eager loop takes over). Last in this file: a
    failed capture may leave its capture stream current."""
    rs, eng, seed = _engine("equiv-coll", card)
    real = KOPS.drain_tick

    def syncing(*args, **kw):
        float(args[1].sum())  # a device-to-host read
        return real(*args, **kw)

    monkeypatch.setattr(KOPS, "drain_tick", syncing)
    state = eng.init_state(seed=seed)
    with pytest.raises(RuntimeError):
        eng.run(state)
    assert eng.last_run is None
    assert float(state.t) == 0.0
