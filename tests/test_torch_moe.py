"""The port's MoE layer against the JAX package's, on the CPU.

Weights come from the JAX package's ``moe_init`` and are copied into the
port's ``MoE`` module; inputs are drawn with numpy from a seed. Output
and aux loss are held to rtol 1e-5, atol 1e-6 in float32: the two sum the
router, expert and scatter products in other orders. ``expert_capacity``
and the top-k order (the lower index first among equal values, as
``lax.top_k``) are equal; at ``no_drop``'s capacity factor an expert
takes a whole row.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import moe as JMOE
from repro_torch.configs import get_smoke_config
from repro_torch.models import moe as MOE

RTOL, ATOL = 1e-5, 1e-6
jax_moe = jax.jit(JMOE.apply_moe, static_argnums=2)


def _moe(cfg, tree):
    mod = MOE.MoE(cfg, torch.Generator().manual_seed(0))
    assert sorted(n for n, _ in mod.named_parameters()) == sorted(tree)
    with torch.no_grad():
        for k, v in tree.items():
            getattr(mod, k).copy_(torch.tensor(np.asarray(v)))
    return mod


@pytest.mark.parametrize("E,K,cf,n", list(itertools.product(
    [8, 40], [2, 8], [1.0, 1.25], [1, 5, 64, 4096])))
def test_expert_capacity(E, K, cf, n):
    cfg = get_smoke_config("granite_moe_3b_a800m").replace(
        moe_num_experts=E, moe_top_k=K, moe_capacity_factor=cf)
    jcfg = jax_smoke_config("granite_moe_3b_a800m").replace(
        moe_num_experts=E, moe_top_k=K, moe_capacity_factor=cf)
    assert MOE.expert_capacity(cfg, n) == JMOE.expert_capacity(jcfg, n)
    assert MOE.expert_capacity(cfg, 1) == 1
    assert MOE.expert_capacity(MOE.no_drop(cfg), n) == n


def test_top_breaks_ties_like_lax_top_k():
    x = np.array([[1, 3, 3, 0, 3, -1e30, -1e30], [2, 2, 2, 2, 2, 2, 2]],
                 np.float32)
    for k in (1, 3, 6):
        vals, idx = MOE._top(torch.as_tensor(x), k)
        wv, wi = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(wv))


CASES = {
    # one expert over capacity: every token's router favours expert 0
    "over_capacity": ("mixtral_8x22b", 2, 40, True),
    # a row of 5: C = 5, so no expert can drop a token
    "under_capacity": ("granite_moe_3b_a800m", 3, 5, False),
    # decode: S = 1, C = 1
    "decode": ("granite_moe_3b_a800m", 4, 1, False),
    "decode_relu2": ("mixtral_8x22b", 3, 1, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_moe_matches(case):
    arch, B, S, hot = CASES[case]
    act = "relu2" if case.endswith("relu2") else "swiglu"
    jcfg = jax_smoke_config(arch).replace(mlp_act=act)
    cfg = get_smoke_config(arch).replace(mlp_act=act)
    tree = jax.tree_util.tree_map(
        np.asarray, JMOE.moe_init(jax.random.PRNGKey(5), jcfg))
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if hot:
        x[..., 0] = 4.0
        tree["router"] = tree["router"].copy()
        tree["router"][0] = 0.0
        tree["router"][0, 0] = 2.0
    want, waux = jax_moe(tree, jnp.asarray(x), jcfg)
    got, aux = MOE.apply_moe(_moe(cfg, tree), torch.as_tensor(x), cfg)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(waux), rtol=RTOL)
    C = MOE.expert_capacity(cfg, S)
    probs = torch.softmax(torch.as_tensor(x) @ torch.tensor(tree["router"]),
                          dim=-1)
    picked = torch.zeros_like(probs).scatter_(
        -1, MOE._top(probs, cfg.moe_top_k)[1], 1.0).sum(dim=1)  # (B, E)
    assert bool((picked > C).any()) == hot, (picked, C)
