"""The port's CPU path against the JAX engine over a paper-scale prefix.

Both paper runs of ``chip_smoke.py`` (``PAPER_1D``: workload1 on the 1D
dragonfly, 10 ms; ``PAPER_2D``: workload3 on the 2D dragonfly, 6 ms; RG
placement, adaptive routing, 5 us tick, seed 0, the 65,536-message pool)
are built by each package from its own ``mix_scenario`` and
``manager.resolve``, and each engine starts from its own
``init_state(seed=engine_seed(0))``: nothing is carried across, so the
resolve, the placement, the skeletons and the initial state are held too.
The JAX engine ticks under ``jax.jit``, the port on the CPU with one
torch thread. Every leaf of the state is compared at tick 0 and every 16
ticks up to N = 128 ticks (integers exactly, routes included; floats to
rtol 1e-5), and a failure names the tick and the leaf. N = 128 is the
prefix ``chip_smoke.py`` holds the card to this CPU path over
(``CARD_VS_CPU_TICKS``), so card = port CPU path = JAX for the first 128
ticks of both paper runs.

N = 128. Measured on one CPU core with one torch thread: 28 s (1D) and
50 s (2D) a case, set-up and the JAX compile included (a port tick takes
about 0.2 s and 0.35 s). The test also asserts that over 1,000
messages are in flight at tick 128, so the comparison is not empty.
"""
import jax
import numpy as np
import pytest
import torch

from repro.union import manager as REF_MGR
from repro.union.scenario import mix_scenario as ref_mix_scenario
from repro_torch.union import manager as MGR
from repro_torch.union.scenario import mix_scenario
from repro_torch.union.seeds import engine_seed
from test_torch_engine import _first_mismatch

TICKS = 128  # chip_smoke.CARD_VS_CPU_TICKS
EVERY = 16
PAPER = {  # chip_smoke's PAPER_1D and PAPER_2D
    "workload1-1d": ("workload1", "1d", 10.0),
    "workload3-2d": ("workload3", "2d", 6.0),
}


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scenario(make, workload, topo, horizon_ms):
    return make(workload, topo=topo, scale="paper", placement="RG",
                routing="ADP", tick_us=5.0, horizon_ms=horizon_ms)


@pytest.mark.parametrize("case", sorted(PAPER))
def test_port_cpu_path_matches_jax_over_paper_prefix(case):
    workload, topo, horizon_ms = PAPER[case]
    ref_rs = REF_MGR.resolve(
        _scenario(ref_mix_scenario, workload, topo, horizon_ms), seed=0)
    ref_eng = REF_MGR.build(ref_rs)
    ref_tick = jax.jit(ref_eng.tick)
    ref_st = ref_eng.init_state(seed=engine_seed(0))

    rs = MGR.resolve(_scenario(mix_scenario, workload, topo, horizon_ms),
                     seed=0)
    eng = MGR.build(rs, device="cpu")
    st = eng.init_state(seed=engine_seed(0))

    mismatch = _first_mismatch(st, ref_st)
    assert mismatch is None, f"{case}, tick 0: {mismatch}"
    for i in range(1, TICKS + 1):
        ref_st = ref_tick(ref_st)
        st = eng.tick(st)
        if i % EVERY == 0:
            mismatch = _first_mismatch(st, ref_st)
            assert mismatch is None, f"{case}, tick {i}: {mismatch}"
    # the comparison is not empty: thousands of messages are in flight
    in_flight = int(st.pool.active.sum())
    assert in_flight == int(np.asarray(ref_st.pool.active).sum())
    assert in_flight > 1000, in_flight
    assert float(st.t) == float(jax.device_get(ref_st.t)) > 0.0
