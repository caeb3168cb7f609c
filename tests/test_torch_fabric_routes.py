"""The port's fat-tree and torus routers against the JAX package's.

``fat_tree_routes`` and ``torus_routes`` of ``repro_torch`` must give
exactly the routes and hop counts of the JAX package's routers on the
``small`` and ``paper`` fabrics, in both modes: under random link demand
(the generator of ``tests/test_fabric.py``'s route property), under
dead-link masks (1e18 demand, as the engine surfaces a dead link), and
with per-message ``demand_offsets`` into a flattened ``(B*(L+1),)``
member batch. Inputs are made with numpy from a seed and handed to both.

The JAX routers run op by op here. Each reduction compiled alone is
XLA's in-order fold over a row; a ``jax.jit`` of the whole torus router
fuses its two cost sums into one loop whose order XLA picks (not a fold,
on the paper torus with this file's demand: a route whose two costs tie
in the fold can differ in the last bit there). The engine's fused tick
is held separately, on whole runs (``tests/test_torch_fabric_engine.py``).

Also pinned here: the fat-tree spray's ties (the first least cost, as
``jnp.argmin`` takes it), the torus cost as a left-to-right float32 fold,
the reference fault that the port reproduces (the fat-tree adaptive
router crossing a dead down-link while the minimal route is healthy), and
the dead-link property of ``tests/test_fabric.py`` on the fabrics whose
adaptive routers keep it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.netsim.fabric import get_fabric as ref_get_fabric
from repro_torch.netsim.fabric import get_fabric
from repro_torch.netsim.routing import route_cost

FABRICS = [(n, s) for n in ("fat_tree", "torus") for s in ("small", "paper")]


def _ref_routes(topo, src, dst, rand, demand, adaptive, offsets):
    T, fn = topo.routing_tables()
    routes, hops = fn(T, jnp.asarray(src), jnp.asarray(dst),
                      jnp.asarray(rand), jnp.asarray(demand), adaptive,
                      demand_offsets=jnp.asarray(offsets))
    return np.asarray(routes), np.asarray(hops)


def _port_routes(topo, src, dst, rand, demand, adaptive, offsets):
    T, fn = topo.routing_tables("cpu")
    routes, hops = fn(T, torch.as_tensor(src), torch.as_tensor(dst),
                      torch.as_tensor(rand), torch.as_tensor(demand),
                      adaptive, demand_offsets=torch.as_tensor(offsets))
    assert routes.dtype == hops.dtype == torch.int32
    return routes.numpy(), hops.numpy()


def _messages(topo, n, seed, members, dead):
    """Random (src, dst, rand) triples, a (members*(L+1),) demand table
    (uniform in [0, 1e12), as ``tests/test_fabric.py`` draws it) with an
    optional fraction of dead links at 1e18 (terminal links and the dummy
    row stay up) and per-message member offsets."""
    rng = np.random.default_rng(seed)
    L = topo.n_links
    src = rng.integers(0, topo.n_nodes, size=n, dtype=np.int32)
    dst = rng.integers(0, topo.n_nodes, size=n, dtype=np.int32)
    rand = rng.integers(0, 2**31 - 1, size=n, dtype=np.int32)
    demand = rng.uniform(0, 1e12, (members, L + 1)).astype(np.float32)
    if dead:
        mask = rng.random((members, L + 1)) < dead
        mask[:, : 2 * topo.n_nodes] = False
        mask[:, -1] = False
        demand = np.where(mask, np.float32(1e18), np.float32(0.0))
    offsets = (rng.integers(0, members, size=n) * (L + 1)).astype(np.int32)
    return src, dst, rand, demand.reshape(-1), offsets


def _check(name, scale, adaptive, msgs):
    want = _ref_routes(ref_get_fabric(name, scale), *msgs[:4], adaptive,
                       msgs[4])
    got = _port_routes(get_fabric(name, scale), *msgs[:4], adaptive, msgs[4])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    return got


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("name,scale", FABRICS)
def test_routes_match_under_random_demand(name, scale, adaptive):
    topo = get_fabric(name, scale)
    routes, hops = _check(name, scale, adaptive,
                          _messages(topo, 3000, 11, members=3, dead=0.0))
    assert routes.shape == (3000, topo.route_width)
    assert (hops == (routes >= 0).sum(1)).all()


@pytest.mark.parametrize("dead", [0.02, 0.2])
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("name,scale", FABRICS)
def test_routes_match_under_dead_links(name, scale, adaptive, dead):
    topo = get_fabric(name, scale)
    _check(name, scale, adaptive,
           _messages(topo, 2000, 29, members=2, dead=dead))


@pytest.mark.parametrize("name", ["fat_tree", "torus"])
def test_zero_demand_ties_match(name):
    """All demand 0: every spray candidate ties (the rotation decides) and
    both torus orders cost 0 (the DOR route stays)."""
    topo = get_fabric(name, "small")
    src, dst, rand, demand, offsets = _messages(topo, 2000, 3, 2, 0.0)
    demand = np.zeros_like(demand)
    routes, _ = _check(name, "small", True, (src, dst, rand, demand, offsets))
    minimal, _ = _port_routes(topo, src, dst, rand, demand, False, offsets)
    if name == "torus":
        np.testing.assert_array_equal(routes, minimal)
    else:
        # the spray's first up-link is the rotation's first candidate
        m = topo.m
        e_s = src // topo.hosts_per_edge
        other_edge = e_s != dst // topo.hosts_per_edge
        want = topo.up1_link[e_s, rand % m]
        np.testing.assert_array_equal(routes[other_edge, 1],
                                      want[other_edge])


@pytest.mark.parametrize("K", [8, 21])
def test_route_cost_is_a_left_fold(K):
    """The torus cost sum is the float32 left-to-right fold (what XLA's
    reduction gives on the CPU), not a pairwise sum: numpy's pairwise sum
    differs from it in many rows, so the pin bites."""
    rng = np.random.default_rng(K)
    n, L = 20000, 4096
    demand = rng.uniform(0, 1e12, L + 1).astype(np.float32)
    bw = rng.uniform(1.0, 50.0, L).astype(np.float32)
    route = rng.integers(-1, L, (n, K)).astype(np.int64)

    class T:
        link_bw = torch.as_tensor(bw)

    got = route_cost(T, torch.as_tensor(route), torch.as_tensor(demand),
                     torch.zeros(n, dtype=torch.int64)).numpy()
    idx = np.maximum(route, 0)
    terms = np.where(route >= 0, demand[idx] / bw[idx], np.float32(0.0))
    fold = np.add.accumulate(terms, axis=1, dtype=np.float32)[:, -1]
    np.testing.assert_array_equal(got, fold)
    assert (terms.sum(axis=1, dtype=np.float32) != fold).any()
    want = np.asarray(jax.jit(jax.vmap(jnp.sum))(jnp.asarray(terms)))
    np.testing.assert_array_equal(got, want)


def test_fat_tree_adaptive_crosses_dead_down_link_as_reference():
    """The reference fault that the port reproduces bit for bit: the
    fat-tree spray costs only the up-links it picks, so on
    ``fat_tree_small`` node 0 -> 503 with rand 5 and core->agg link 2243
    dead, the adaptive route keeps 2243 while D-mod-k's route is healthy.
    Both packages give the same two routes."""
    topo = get_fabric("fat_tree", "small")
    demand = np.zeros(topo.n_links + 1, np.float32)
    demand[2243] = np.float32(1e18)
    args = (np.array([0], np.int32), np.array([503], np.int32),
            np.array([5], np.int32), demand)
    off = np.zeros(1, np.int32)
    ref_topo = ref_get_fabric("fat_tree", "small")
    for adaptive, want in ((True, [0, 1013, 1470, 2243, 2735, 1007]),
                           (False, [0, 1013, 1475, 2303, 2735, 1007])):
        got, _ = _port_routes(topo, *args, adaptive, off)
        ref, _ = _ref_routes(ref_topo, *args, adaptive, off)
        assert got[0].tolist() == want
        assert ref[0].tolist() == want


def _route_links(topo, route):
    return [int(x) for x in route if 2 * topo.n_nodes <= int(x) < topo.n_links]


@pytest.mark.parametrize("name", ["1d", "2d", "torus"])
def test_routes_avoid_dead_links(name):
    """``tests/test_fabric.py``'s dead-link property on the port, from
    seeded draws: an adaptive route crosses a dead link only when the
    minimal route for the same pair is dead too. The fat tree does not
    keep it (the pin above), in both packages."""
    topo = get_fabric(name, "small")
    T, fn = topo.routing_tables("cpu")
    rng = np.random.default_rng(5)
    for _ in range(40):
        frac = float(rng.choice([0.02, 0.05, 0.1, 0.2]))
        dead = np.zeros(topo.n_links + 1, bool)
        k = max(1, int(np.ceil(frac * topo.n_links)))
        dead[rng.choice(topo.n_links, size=k, replace=False)] = True
        dead[: 2 * topo.n_nodes] = False
        dead[-1] = False
        demand = torch.as_tensor(np.where(dead, 1e18, 0.0).astype(np.float32))
        n = 64
        src = torch.as_tensor(rng.integers(0, topo.n_nodes, n))
        dst = torch.as_tensor(rng.integers(0, topo.n_nodes, n))
        rand = torch.as_tensor(rng.integers(0, 2**31 - 1, n))
        adp, _ = fn(T, src, dst, rand, demand, True)
        mn, _ = fn(T, src, dst, rand, demand, False)
        for a, m in zip(adp.numpy(), mn.numpy()):
            if any(dead[x] for x in _route_links(topo, a)):
                assert any(dead[x] for x in _route_links(topo, m))
