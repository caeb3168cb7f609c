"""The traced run's ``Tap`` on the CPU: where members are split over
cards (one host thread a card), the profiler starts and stops only while
no card's thread is inside a replay. Replays, cards and the profiler are
stand-ins here; the watchers and the serving thread are the harness's."""
from __future__ import annotations

import sys
import threading
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import profiling  # noqa: E402


class FakeTap(profiling.Tap):
    """A tap whose cards are thread-local numbers and whose profiler
    records how many replays were running when it started or stopped."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.local = threading.local()
        self.inside = 0
        self.inside_lock = threading.Lock()
        self.toggles = []

    def _device(self) -> int:
        return self.local.dev

    def _seen(self, what):
        with self.inside_lock:
            self.toggles.append((what, self.inside))

    def _start(self):
        self._seen("start")
        self.prof = object()

    def _stop(self):
        self._seen("stop")
        self.prof = None
        return dict(events=[], lo=0, hi=1, offset_ns=0)

    def replay(self):
        self._before_replay()
        with self.inside_lock:
            self.inside += 1
        time.sleep(0.0005)
        with self.inside_lock:
            self.inside -= 1
        self._after_replay()


def _split_call(tap, cards, replays):
    """One repeat of a split call: a thread a card, each replaying, all
    joined, then the facade's member report."""

    def card(dev):
        tap.local.dev = dev
        for _ in range(replays):
            tap.replay()

    def call():
        threads = [threading.Thread(target=card, args=(d,))
                   for d in range(cards)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        tap._on_boundary()

    worker = threading.Thread(target=call)
    worker.start()
    tap.serve(worker)
    worker.join()


@pytest.mark.parametrize("cards", [1, 4])
def test_the_profiler_toggles_only_while_no_card_replays(cards):
    tap = FakeTap(replays=2, skip=5, boundary_replays=2, graph_ticks=8)
    for repeat in range(2):
        tap.repeat = repeat
        _split_call(tap, cards, replays=40)
    # the replay profile (taken again up to TRIES times, as its stand-in
    # sees no kernel) and the boundary profile each started and stopped
    assert len(tap.toggles) == 2 * profiling.TRIES + 2
    assert tap.p1_state == "failed" and tap.p2_state == "done"
    assert [inside for _, inside in tap.toggles] == [0] * len(tap.toggles)
    assert tap.unquiet == 0 and not tap.hold and tap.parked == 0
