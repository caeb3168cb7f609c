"""The port's lock-step batched scheduler against the JAX package's.

``run_trace_batch`` over a seed × policy grid of ``_mini_trace`` (two
slots) with a third cell whose fabric loses a tenth of its links at
300 µs and gets them back at 1,100 µs (fault masks applied between
windows, each window landing on an event). Every cell's records, window
count, timeline and final state equal the JAX batch's (integers exact,
floats to rtol 1e-5; ``tests/torch_parity.py``) and the port's own
sequential ``run_trace`` of that cell, bit for bit.
"""
import dataclasses

import torch
import pytest

from repro.netsim import faults as REF_F
from repro.sched import scheduler as REF_S
from repro_torch.netsim import faults as F
from repro_torch.sched import scheduler as S
from test_sched import _mini_trace
from test_torch_sched import assert_same_result, port_trace
from torch_parity import assert_bitwise_equal


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """The engine's CPU path runs many small ops; one intra-op thread is
    faster than many when test workers share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_batch_with_a_midrun_outage_matches_jax_and_sequential():
    tr = _mini_trace(slots=2)
    ptr = port_trace(tr)

    def outage(mod):
        return mod.FailureSpec(name="outage", events=[
            mod.FaultEvent(t_us=300.0, kind="random_links", fraction=0.1,
                           seed=7),
            mod.FaultEvent(t_us=1100.0, kind="random_links", fraction=0.1,
                           seed=7, factor=1.0),
        ])

    grid = [("fcfs", 5), ("easy", 4)]
    want = REF_S.run_trace_batch(
        [(tr, p, s) for p, s in grid] + [(tr, "easy", 4, outage(REF_F))],
        collect_state=True, timeline=True)
    got = S.run_trace_batch(
        [(ptr, p, s) for p, s in grid] + [(ptr, "easy", 4, outage(F))],
        collect_state=True, timeline=True, device="cpu")
    seq = [S._run_trace_impl(ptr, policy=p, seed=s, collect_state=True,
                             timeline=True, device="cpu") for p, s in grid]
    seq.append(S._run_trace_impl(
        ptr, policy="easy", seed=4, failure=outage(F), collect_state=True,
        timeline=True, device="cpu"))
    for g, w, q in zip(got, want, seq):
        assert_same_result(g, w)
        assert g.windows == q.windows
        assert [dataclasses.astuple(r)[:-1] for r in g.records] == \
            [dataclasses.astuple(r)[:-1] for r in q.records]
        assert_bitwise_equal(g.final_state, q.final_state)
    # the outage moved the faulted cell off its healthy twin
    assert [r.finish_us for r in got[2].records] != \
        [r.finish_us for r in got[1].records]
    assert got[0].engine_windows == got[2].engine_windows  # shared totals
