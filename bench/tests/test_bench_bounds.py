"""The yardstick's byte and operation counts against counts made by hand
for a small shape."""
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import bounds  # noqa: E402

# two members, 3 job slots of up to 4 ranks and 5 ops, a pool of 16
# messages of route width 10, 100 links, 12 routers in 3 groups of 4 with
# 2 global links a group pair, 4 metric rows, 6 UR ranks, 2 windows, 8 bins
S = bounds.SimShapes(B=2, J=3, Pmax=4, OPmax=5, M=16, K=10, L=100, R=12,
                     G=3, a=4, lpp=2, n_apps=4, Pu=6, W=2, BINS=8)


def test_state_bytes_by_hand():
    vms = 12 * 34  # 8 four-byte leaves and 2 bool leaves a rank slot
    ur = 6 * 12  # next time, count, node
    pool = 16 * (1 + 28 + 40 + 4) + 8  # flags, 7 leaves, route, stack
    metrics = 4 * 8 * 4 + 4 * 16 + 101 * 4 + 4 * 12 * 4 + 2 * 4 * 12 * 4 + 8
    jobs = 3 * 5 * 32 + 3 * 8 + 12 * 8 + 3 * 4
    faults = 100 * 4 + 12 * 4
    assert bounds.state_bytes(S) == 4 + vms + ur + pool + metrics + 8 \
        + jobs + faults


def test_tick_bytes_by_hand():
    tables = 12 * 4 * 8 + 2 * 9 * 2 * 8 + 100 * 32 + 101 * 4
    assert bounds.table_bytes(S) == tables
    assert bounds.tick_bytes(S) == 2 * 2 * bounds.state_bytes(S) + tables
    assert bounds.tick_bound_ms(S) == pytest.approx(
        bounds.tick_bytes(S) / 3.35e12 * 1e3)


def test_drain_bound_by_hand():
    inputs = 2 * 16 * 40 + 2 * 16 * 13 + 2 * 4 + 2 * 101 * 4 + 101 * 4
    outputs = 2 * 16 * 9 + 2 * 101 * 4 + 2 * 4 * 12 * 4
    ms, by = bounds.drain_bound_ms(S)
    assert by == "bytes"
    assert ms == pytest.approx((inputs + outputs) / 3.35e12 * 1e3)


def test_drain_is_bound_by_bytes_at_six_operations_a_route_entry():
    # 6 operations a 4-byte route entry: far under the H100's 20 a byte
    s = bounds.SimShapes(B=8, J=4, Pmax=2048, OPmax=2000, M=65536, K=10,
                         L=53856, R=1056, G=33, a=32, lpp=4, n_apps=5,
                         Pu=4096)
    ms, by = bounds.drain_bound_ms(s)
    assert by == "bytes"
    assert ms > 8 * 65536 * 10 * 6 / 67e12 * 1e3


def test_link_demand_bytes_by_hand():
    assert bounds.link_demand_bytes(S) == 2 * 16 * (40 + 1 + 4) + 2 * 101 * 4
