"""repro_torch.union — the paper's workload manager on the port's engine.

So far: declarative scenarios (:mod:`~repro_torch.union.scenario`), their
resolution into engine inputs and single-member runs
(:mod:`~repro_torch.union.manager`), the shared seed derivation
(:mod:`~repro_torch.union.seeds`) and spec validation
(:mod:`~repro_torch.union.validate`). The experiment facade, ensembles,
the store and the server of the JAX package are not ported yet.
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
from repro_torch.union.seeds import engine_seed, place_seed  # noqa: F401
from repro_torch.union.validate import SpecError  # noqa: F401
