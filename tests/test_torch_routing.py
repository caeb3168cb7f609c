"""The port's dragonfly router against the JAX package's.

``repro_torch.netsim.routing.compute_routes`` must give exactly the routes
and hop counts of ``repro.netsim.routing.compute_routes`` (run under
``jax.jit``, as the engine runs it): MIN and ADP on the 1D and 2D
dragonflies, with random link demand, dead links at 1e18, the batched
``demand_offsets`` layout, and the paper-scale tables. Inputs are made
with numpy from a seed and handed to both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.netsim import routing as ref_routing
from repro.netsim.fabric import get_fabric as ref_get_fabric
from repro_torch.netsim import routing
from repro_torch.netsim.fabric import get_fabric


def _ref_routes(topo, src, dst, rand, demand, adaptive, offsets):
    T = ref_routing.topo_arrays(topo)
    fn = jax.jit(lambda s, d, r, dem, off: ref_routing.compute_routes(
        T, s, d, r, dem, adaptive, demand_offsets=off))
    routes, hops = fn(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(rand),
                      jnp.asarray(demand), jnp.asarray(offsets))
    return np.asarray(routes), np.asarray(hops)


def _port_routes(topo, src, dst, rand, demand, adaptive, offsets):
    T = routing.topo_arrays(topo, "cpu")
    routes, hops = routing.compute_routes(
        T, torch.as_tensor(src), torch.as_tensor(dst), torch.as_tensor(rand),
        torch.as_tensor(demand), adaptive,
        demand_offsets=torch.as_tensor(offsets))
    return routes.numpy(), hops.numpy()


def _messages(topo, n, seed, members=1, dead=0.0):
    """Random (src, dst, rand) triples and a (members*(L+1),) demand table
    with an optional fraction of dead links at 1e18, as the engine builds
    it."""
    rng = np.random.default_rng(seed)
    L = topo.n_links
    src = rng.integers(0, topo.n_nodes, size=n, dtype=np.int32)
    dst = rng.integers(0, topo.n_nodes, size=n, dtype=np.int32)
    rand = rng.integers(0, 2**31 - 1, size=n, dtype=np.int32)
    demand = (rng.random((members, L + 1)) * 1e6).astype(np.float32)
    demand[rng.random((members, L + 1)) < 0.3] = 0.0
    if dead:
        demand[:, :L][rng.random((members, L)) < dead] += np.float32(1e18)
    offsets = (rng.integers(0, members, size=n) * (L + 1)).astype(np.int32)
    return src, dst, rand, demand.reshape(-1), offsets


def _check(topo_name, scale, adaptive, n, seed, members=1, dead=0.0):
    ref_topo = ref_get_fabric(topo_name, scale)
    topo = get_fabric(topo_name, scale)
    msgs = _messages(topo, n, seed, members, dead)
    want_r, want_h = _ref_routes(ref_topo, *msgs[:4], adaptive, msgs[4])
    got_r, got_h = _port_routes(topo, *msgs[:4], adaptive, msgs[4])
    assert got_r.dtype == np.int32 and got_h.dtype == np.int32
    np.testing.assert_array_equal(got_r, want_r)
    np.testing.assert_array_equal(got_h, want_h)
    return got_r


@pytest.mark.parametrize("topo_name", ["1d", "2d"])
@pytest.mark.parametrize("adaptive", [False, True])
def test_small_fabric_routes_match(topo_name, adaptive):
    _check(topo_name, "small", adaptive, 2048, 1)


@pytest.mark.parametrize("topo_name", ["1d", "2d"])
def test_adaptive_routes_match_with_dead_links(topo_name):
    routes = _check(topo_name, "small", True, 2048, 2, dead=0.1)
    assert (routes >= 0).sum(axis=1).max() > 6  # some Valiant detours


@pytest.mark.parametrize("topo_name", ["1d", "2d"])
def test_batched_demand_offsets_match(topo_name):
    _check(topo_name, "small", True, 2048, 3, members=3, dead=0.05)


@pytest.mark.parametrize("topo_name", ["1d", "2d"])
@pytest.mark.parametrize("adaptive", [False, True])
def test_paper_fabric_routes_match(topo_name, adaptive):
    _check(topo_name, "paper", adaptive, 4096, 4, dead=0.02)
