"""repro_torch.union — the paper's workload manager on the port's engine.

**One front door**: declare an
:class:`~repro_torch.union.experiment.Experiment` (closed-mix scenario
ensembles and/or an open-stream trace study, crossed with a grid of
seeds × placements × routing × failures × queue policies) and call
:func:`union.run <repro_torch.union.experiment.run>` — the planner lowers
it into engine-bucketed execution nodes, every engine comes from the
process-wide cache on one device (CUDA unless ``device="cpu"``), and you
get back the JAX package's schema-v4
:class:`~repro_torch.union.experiment.Results`::

    from repro_torch import union
    exp = union.Experiment(
        name="study", scenarios=[union.mix_scenario("workload1")],
        members=8, grid=union.StudyGrid(placements=["RN", "RG"]))
    results = union.run(exp, store="results/store")
    results.save("results.json")

Modules: :mod:`~repro_torch.union.experiment` (the spec, ``run`` and
Results), :mod:`~repro_torch.union.planner` (grid expansion and engine
bucketing), :mod:`~repro_torch.union.scenario`,
:mod:`~repro_torch.union.manager` (resolution and single-member runs),
:mod:`~repro_torch.union.seeds`, :mod:`~repro_torch.union.report` (the
summary/format pipeline and the paper's interference summaries),
:mod:`~repro_torch.union.store` (the content-hash store),
:mod:`~repro_torch.union.validate`, :mod:`~repro_torch.union.ensemble`
(the deprecated campaign front doors, shims over ``run``),
:mod:`~repro_torch.union.cli`, and :mod:`~repro_torch.union.serve` +
:mod:`~repro_torch.union.client` (the persistent Union server and its
stdlib client).

CLI (the JAX package's flags, plus ``--device``)::

    python -m repro_torch.union --experiment my_study.json
    python -m repro_torch.union --scenario workload1 --members 8
    python -m repro_torch.union --trace poisson --sched fcfs easy
    python -m repro_torch.union --list
    python -m repro_torch.union.serve --port 8642 --store results/store
"""
from repro_torch.union.scenario import (  # noqa: F401
    MIXES,
    MIX_HAS_UR,
    Scenario,
    ScenarioJob,
    URDecl,
    load_scenario,
    mix_scenario,
)
from repro_torch.union.manager import ResolvedScenario, resolve, run_scenario  # noqa: F401
from repro_torch.union.ensemble import (  # noqa: F401
    CampaignResult,
    run_campaign,
    run_ragged_campaign,
    run_sched_campaign,
)
from repro_torch.union.experiment import (  # noqa: F401
    CellResult,
    Experiment,
    Results,
    RunCancelled,
    StudyGrid,
    TraceStudy,
    load_experiment,
    run,
)
from repro_torch.union.store import ExperimentStore  # noqa: F401
from repro_torch.union.report import (  # noqa: F401
    campaign_summary,
    format_results,
    interference_summary,
    results_summary,
)
from repro_torch.union.seeds import engine_seed, place_seed  # noqa: F401
from repro_torch.union.validate import SpecError  # noqa: F401
