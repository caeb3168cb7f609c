"""The scenario kind: a configuration that is a scenario file (the port's
``Scenario.from_dict``) under traffic that names the member seeds of a
``union.run`` call (``studygen.MemberSeeds``). Each repeat runs those
members as one study; the check compares sampled members' reports with
the reference's (``reference/study.py``)."""
from __future__ import annotations

import sys
import time
from typing import Dict, List

import judge
import studygen


def _replica_stats(engine_module):
    """The per-replica stats of the last split call (``Engine.prun``), if
    the last call split its members."""
    for eng in engine_module._ENGINE_CACHE.values():
        st = eng.last_run
        if st is not None and st.replicas:
            return [dict(ticks=r.ticks, replays=r.replays,
                         replay_device_ms=r.replay_device_ms)
                    for r in st.replicas]
    return []


class Study:
    """A cell of scenario members: its warm-up, its repeats, their
    records and the check."""

    def __init__(self, name: str, config: Dict, traffic: Dict, seed: int,
                 device: str):
        from repro_torch import union
        from repro_torch.netsim import engine as ENG
        from repro_torch.union import manager as MGR
        from repro_torch.union.scenario import Scenario

        self.name, self.config, self.seed, self.device = (name, config,
                                                          seed, device)
        self.checked = int(traffic["checked"])
        self.gen = studygen.MemberSeeds(traffic, seed)
        self.units = self.gen.members
        self.union, self.ENG, self.Scenario = union, ENG, Scenario
        self.scenario = Scenario.from_dict(config)
        # the profiles' boundary: the facade's member reports
        self.tap_target, self.tap_rounds = (MGR, "member_report"), None

    def _study(self, scn, seeds):
        return self.union.run(self.union.Experiment(
            name=self.name, scenarios=[scn], members=len(seeds),
            seeds=list(seeds)), store=None, device=self.device)

    def warmup(self) -> None:
        """One call of the cell's member count whose jobs arrive after
        the horizon: the same engine, batch and graphs, almost nothing
        to simulate."""
        horizon_us = self.scenario.horizon_ms * 1000.0
        self._study(self.Scenario.from_dict(studygen.late_start(
            self.config, horizon_us)), self.gen.warmup())

    def call(self):
        """One repeat: the study of the cell's member seeds."""
        return self._study(self.scenario, self.gen.block())

    def record(self, res) -> Dict:
        return dict(seeds=self.gen.block(),
                    reports=[c.report for c in res.scenario_cells],
                    engine=res.telemetry["engine"].get("batched", {}),
                    replicas=_replica_stats(self.ENG))

    def virtual_ms(self, repeats: List[Dict]) -> float:
        return studygen.member_virtual_ms(
            [r for rep in repeats for r in rep["reports"]])

    def failed(self, repeats: List[Dict]) -> int:
        reports = [r for rep in repeats for r in rep["reports"]]
        return len(repeats) * self.units - len(reports) + sum(
            1 for r in reports if r.get("dropped", 0) > 0)

    def judge(self, repeats: List[Dict]) -> Dict:
        """The check: ``checked`` members drawn from the seed, each
        report against the reference's of its member seed."""
        from reference.study import member_reports

        t_ref = time.perf_counter()
        picks = studygen.checked_members(self.seed, len(repeats),
                                         self.units, self.checked)
        got = [repeats[r]["reports"][p] if p < len(repeats[r]["reports"])
               else None for r, p in picks]
        distinct = sorted({repeats[r]["seeds"][p] for r, p in picks})
        ref = dict(zip(distinct, member_reports(self.config, distinct,
                                                self.device)))
        want = [ref[repeats[r]["seeds"][p]] for r, p in picks]
        numbers = judge.judge(got, want)
        print(f"bench: reference {time.perf_counter() - t_ref:.3f} s for "
              f"{len(distinct)} members, {len(picks)} reports compared, "
              f"{numbers['leaves']} leaves", file=sys.stderr)
        return numbers

    def shapes(self, chips: int):
        """The shapes of one engine call of the scenario
        (``bounds.SimShapes``), worked out by the reference from the
        scenario file: a card's share of the members where they split."""
        import bounds
        from reference.study import Study as RefStudy

        members = self.units
        batch = members // (chips if chips > 1 and members % chips == 0
                            else 1)
        st = RefStudy(self.config)
        t = st.topo
        return bounds.SimShapes(
            B=batch, J=len(st.programs),
            Pmax=max(p.n_ranks for p in st.programs),
            OPmax=max(p.n_ops for p in st.programs), M=st.pool_size,
            K=t.route_width, L=t.n_links, R=t.n_routers, G=t.n_groups,
            a=t.routers_per_group, lpp=t.links_per_pair,
            n_apps=len(st.programs) + (1 if st.ur else 0),
            Pu=int(st.ur["ranks"]) if st.ur else 0)
