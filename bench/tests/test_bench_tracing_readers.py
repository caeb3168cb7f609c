"""The readers of the program's tick parts and member-split spans, on
hand-made contexts: each gives its value where the program recorded what
it reads, and nothing where it did not (a program without the
instrumentation, or the CPU)."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from readers import same_as  # noqa: E402

PARTS = ("emit", "demand", "route", "drain", "account", "skip")


def ctx(repeats, spans=(), origin=0):
    return dict(repeats=repeats, clean_repeats=repeats, spans=list(spans),
                span_origin_ns=origin, replay_profile=None,
                boundary_profile=None, chips=1)


def engine(parts=None, ticks=0, **kw):
    out = dict(ticks=1280, replay_device_ms=9000.0, **kw)
    if parts is not None:
        out.update(part_device_ms=parts, part_ticks=ticks)
    return out


@pytest.mark.parametrize("suffix", ["", ".single"])
@pytest.mark.parametrize("part", PARTS)
def test_tick_part_reads_device_ms_a_tick(part, suffix):
    read = same_as(f"tick.{part}_ms{suffix}")
    reps = [dict(engine=engine({p: 8.0 * (i + 1) for i, p in
                                enumerate(PARTS)}, ticks=8)),
            dict(engine=engine({p: 4.0 for p in PARTS}, ticks=16))]
    want = (8.0 * (PARTS.index(part) + 1) + 4.0) / 24
    assert read(ctx(reps)) == pytest.approx(want)
    # a program that times no part: the fields are absent
    assert read(ctx([dict(engine=engine()), dict(engine=engine())])) is None
    assert read(ctx([])) is None


def _split_spans(t0_us, wall_ms, device_ms, replicas=4):
    """One repeat's ``engine.prun`` span and its replicas' spans."""
    out = [dict(name="engine.prun", cat="engine", ts_us=t0_us,
                dur_us=wall_ms * 1000.0, cpu_ms=1.0, tid=0,
                args=dict(replicas=replicas))]
    for d, ms in enumerate(device_ms):
        out.append(dict(name="engine.replica", cat="engine",
                        ts_us=t0_us + 10.0, dur_us=ms * 1000.0, cpu_ms=1.0,
                        tid=d + 1, args=dict(device=f"cuda:{d}", members=2,
                                             replay_device_ms=ms,
                                             wait_ms=wall_ms - ms)))
    return out


def test_card_busy_share_reads_the_replicas_over_the_call():
    read = same_as("split.card_busy_share")
    origin = 5_000_000_000
    # repeat k runs from 10 s to 15 s and from 20 s to 25 s past origin
    reps = [dict(t0_ns=origin + 10**10 * (k + 1),
                 t1_ns=origin + 10**10 * (k + 1) + 5 * 10**9, engine={})
            for k in range(2)]
    spans = (_split_spans(1.1e7, 4000.0, [3600.0, 3700.0, 3800.0, 3900.0])
             + _split_spans(2.1e7, 4000.0, [4000.0] * 4)
             # a span of a profiled repeat, outside the clean ones
             + _split_spans(0.5e7, 4000.0, [100.0] * 4)
             + [dict(name="cache", cat="counter", ph="C", ts_us=1.2e7,
                     args=dict(hits=1.0))])
    got = read(ctx(reps, spans, origin))
    assert got == pytest.approx((100.0 * 15000.0 / 16000.0 + 100.0) / 2)
    # no split call (one card, or the CPU without device time)
    assert read(ctx(reps, [], origin)) is None
    cpu = _split_spans(1.1e7, 4000.0, [0.0, 0.0])
    assert read(ctx(reps, cpu, origin)) is None
