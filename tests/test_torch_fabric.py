"""The port's copies of the jax-free modules have not drifted.

The port keeps its own copies of the DSL, the skeleton translator, the
workloads, the dragonfly builders, the placement policies, the model
configuration and the architecture registry. Built from the same inputs,
each must give what the JAX package's module gives.
"""
import dataclasses

import numpy as np
import pytest

from repro import configs as ref_configs
from repro.core import workloads as ref_workloads
from repro.netsim.fabric import get_fabric as ref_get_fabric
from repro.netsim.placement import place_jobs as ref_place_jobs
from repro_torch import configs
from repro_torch.core import workloads
from repro_torch.netsim.fabric import get_fabric
from repro_torch.netsim.placement import place_jobs
from repro_torch.union.scenario import Scenario, ScenarioJob, mix_scenario

DRAGONFLIES = [(n, s) for n in ("1d", "2d") for s in ("small", "paper")]
ARRAYS = ("link_kind", "link_bw", "link_dst_router", "link_src_router",
          "local_link_id", "global_gw", "global_link_id")
SIZES = ("n_routers", "n_nodes", "n_links", "links_per_pair", "route_width",
         "place_routers", "nodes_per_router", "place_groups",
         "nodes_per_group")


@pytest.mark.parametrize("name,scale", DRAGONFLIES)
def test_dragonfly_builders_match(name, scale):
    want, got = ref_get_fabric(name, scale), get_fabric(name, scale)
    for a in ARRAYS:
        w, g = getattr(want, a), getattr(got, a)
        assert w.dtype == g.dtype, a
        np.testing.assert_array_equal(g, w, err_msg=a)
    for a in SIZES:
        assert getattr(got, a) == getattr(want, a), a
    assert got.cache_key() == want.cache_key()
    for (ln, lm), (wn, wm) in zip(got.link_levels().items(),
                                  want.link_levels().items()):
        assert ln == wn
        np.testing.assert_array_equal(lm, wm)


@pytest.mark.parametrize("scale", ["small", "paper"])
@pytest.mark.parametrize("app", sorted(ref_workloads.SPECS))
def test_workload_skeletons_match(app, scale):
    want = ref_workloads.build_skeleton(app, scale)
    got = workloads.build_skeleton(app, scale)
    assert got.n_ranks == want.n_ranks
    np.testing.assert_array_equal(got.ops, want.ops)
    np.testing.assert_array_equal(got.grid, want.grid)


@pytest.mark.parametrize("policy", ["RN", "RR", "RG"])
@pytest.mark.parametrize("name,scale", [("1d", "small"), ("2d", "paper")])
def test_placements_match(policy, name, scale):
    topo = get_fabric(name, scale)
    ref_topo = ref_get_fabric(name, scale)
    sizes = [64, 64, 128, 32] if scale == "small" else [1024, 512, 2048, 512]
    for seed in (0, 1, 7):
        want = ref_place_jobs(ref_topo, sizes, policy, seed=seed)
        got = place_jobs(topo, sizes, policy, seed=seed)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fabric", ["fat_tree", "torus"])
def test_unported_fabric_fails_validation(fabric):
    sc = Scenario(name="x", jobs=[ScenarioJob(app="nn")], topo=fabric)
    with pytest.raises(ValueError, match="not yet ported"):
        sc.validate()
    with pytest.raises(ValueError, match="not yet ported"):
        get_fabric(fabric, "small")


def test_mix_scenarios_validate():
    for wl in ("workload1", "workload2", "workload3", "baseline-nn"):
        mix_scenario(wl, topo="2d", scale="paper").validate()


DERIVED = ("padded_vocab", "d_qkv", "ssm_d_inner", "ssm_n_heads",
           "n_periods")


@pytest.mark.parametrize("arch", configs.PORTED)
@pytest.mark.parametrize("smoke", [False, True])
def test_model_configs_match(arch, smoke):
    get = "get_smoke_config" if smoke else "get_config"
    want = getattr(ref_configs, get)(arch)
    got = getattr(configs, get)(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for a in DERIVED:
        assert getattr(got, a) == getattr(want, a), a
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


def test_registry_matches_and_refuses_the_rest():
    assert configs.ARCH_IDS == ref_configs.ARCH_IDS
    for arch in ref_configs.ARCH_IDS:
        assert configs.canon(arch.replace("_", "-")) == \
            ref_configs.canon(arch.replace("_", "-"))
        if arch in configs.PORTED:
            continue
        with pytest.raises(ValueError, match="not yet ported"):
            configs.get_config(arch)
    cfg = ref_configs.get_config("jamba_v01_52b")
    assert dataclasses.asdict(configs.smoke_shrink(cfg)) == \
        dataclasses.asdict(ref_configs.smoke_shrink(cfg))
