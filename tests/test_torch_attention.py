"""The port's attention, norms, RoPE and MLPs against the JAX package's.

Inputs are drawn with numpy from a seed and go through both functions;
layer weights come from the JAX package's initialisers (``attn_init``,
``mlp_init``) and are copied into the port's modules. Everything runs in
float32 and is held to rtol 1e-5, atol 1e-6: the two sum the score, PV
and projection products in other orders, so they agree to float32
rounding, not bit for bit. ``chunked_attention`` runs over a grid of
causal or not, window 0 and 5, chunks of 4, 16 and 64, and GQA with 1
and 3 query heads per KV head, on 37 keys (padded to a multiple of 4 and
16; a chunk of 64 is cut to 37), and with a key mask in which one row
has no valid key. With bfloat16 score and PV operands the tolerance
adds one bfloat16 rounding (2^-8) of the largest value: the two round
probabilities computed in float32 by other code, and a probability on a
rounding boundary can round the other way.
"""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import layers as JL
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as L

RTOL, ATOL = 1e-5, 1e-6
jax_train = jax.jit(JL.attention_train, static_argnums=2)
jax_decode = jax.jit(JL.attention_decode, static_argnums=3)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _module(cls, cfg, tree):
    """A port module (``L.Attention``, ``L.MLP``) holding ``tree``'s
    weights."""
    mod = cls(cfg, torch.Generator().manual_seed(0))
    assert sorted(n for n, _ in mod.named_parameters()) == sorted(tree)
    with torch.no_grad():
        for k, v in tree.items():
            getattr(mod, k).copy_(torch.tensor(np.asarray(v)))
    return mod


def test_rope_matches():
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 9, 3, 16)
    pos = rng.integers(0, 5000, (2, 9)).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        _close(L.rope_freqs(16, theta), JL.rope_freqs(16, theta))
        _close(L.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta),
               JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms_match(norm):
    cfg = get_smoke_config("mistral_nemo_12b").replace(norm=norm)
    rng = np.random.default_rng(1)
    p = {k: _rand(rng, cfg.d_model) for k in L.norm_init(cfg)}
    x = 3.0 + _rand(rng, 2, 5, cfg.d_model)  # a mean for LayerNorm to take
    got = L.apply_norm({k: torch.as_tensor(v) for k, v in p.items()},
                       torch.as_tensor(x), cfg)
    _close(got, JL.apply_norm({k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x), cfg))
    assert sorted(p) == sorted(JL.norm_init(cfg))


def _qkv(seed, B, Sq, Skv, hkv, rep, dh=8):
    rng = np.random.default_rng(seed)
    return (_rand(rng, B, Sq, hkv * rep, dh), _rand(rng, B, Skv, hkv, dh),
            _rand(rng, B, Skv, hkv, dh))


GRID = list(itertools.product([True, False], [0, 5], [4, 16, 64], [1, 3]))


@pytest.fixture(scope="module")
def jax_grid():
    """The JAX function at every point of the grid, in one jitted program
    (one compilation instead of 24)."""
    ins = {rep: tuple(map(jnp.asarray, _qkv(2, 2, 37, 37, 2, rep)))
           for rep in (1, 3)}

    def every(ins):
        return {g: JL.chunked_attention(*ins[g[3]], causal=g[0], window=g[1],
                                        chunk=g[2]) for g in GRID}

    return jax.jit(every)(ins)


@pytest.mark.parametrize("causal,window,chunk,rep", GRID)
def test_chunked_attention_grid(jax_grid, causal, window, chunk, rep):
    q, k, v = _qkv(2, 2, 37, 37, 2, rep)
    got = L.chunked_attention(*map(torch.as_tensor, (q, k, v)),
                              causal=causal, window=window, chunk=chunk)
    assert got.shape == q.shape and got.dtype == torch.float32
    _close(got, jax_grid[(causal, window, chunk, rep)])


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_key_mask(causal):
    """Rows of random valid keys, and one row with none: the reference
    masks with a finite ``NEG_INF``, so that row averages every value
    (pads included), and so must the port."""
    q, k, v = _qkv(3, 3, 21, 21, 1, 3)
    valid = np.random.default_rng(4).random((3, 21)) < 0.6
    valid[:, 0] = True
    valid[1] = False
    kw = dict(causal=causal, chunk=8)
    got = L.chunked_attention(*map(torch.as_tensor, (q, k, v)),
                              kv_valid=torch.as_tensor(valid), **kw)
    want = JL.chunked_attention(*map(jnp.asarray, (q, k, v)),
                                kv_valid=jnp.asarray(valid), **kw)
    _close(got, want)
    assert np.isfinite(got.numpy()).all()


def test_chunked_attention_bf16_products():
    q, k, v = _qkv(5, 2, 19, 19, 2, 3)
    kw = dict(causal=True, window=5, chunk=8, matmul_bf16=True)
    got = L.chunked_attention(*map(torch.as_tensor, (q, k, v)), **kw)
    want = JL.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw)
    _close(got, want, atol=2.0 ** -8 * float(np.abs(v).max()))


@pytest.mark.parametrize("arch,extra", [
    ("mistral_nemo_12b", {}),
    ("mixtral_8x22b", dict(sliding_window=5)),
    ("nemotron_4_340b", dict(qkv_bias=True)),
])
def test_attention_train_and_decode(arch, extra):
    """``attention_train`` on a sequence, then ``attention_decode`` over it
    token by token against the JAX cache: a sliding window of 5 over 12
    tokens wraps its ring twice."""
    jcfg = jax_smoke_config(arch).replace(**extra)
    cfg = get_smoke_config(arch).replace(**extra)
    tree = JL.attn_init(jax.random.PRNGKey(7), jcfg)
    rng = np.random.default_rng(6)
    if cfg.qkv_bias:
        tree = {k: (_rand(rng, *v.shape) if k.startswith("b") else v)
                for k, v in tree.items()}
    attn = _module(L.Attention, cfg, tree)
    x = _rand(rng, 2, 12, cfg.d_model)
    got, (gk, gv) = L.attention_train(attn, torch.as_tensor(x), cfg)
    want, (wk, wv) = jax_train(tree, jnp.asarray(x), jcfg)
    _close(got, want)
    _close(gk, wk)
    _close(gv, wv)

    jcache = JL.make_kv_cache(jcfg, 2, 12, dtype=jnp.float32)
    cache = L.make_kv_cache(cfg, 2, 12, dtype=torch.float32)
    assert cache["k"].shape == jcache["k"].shape
    for t in range(12):
        xt = x[:, t:t + 1]
        want, jcache = jax_decode(tree, jnp.asarray(xt), jcache, jcfg)
        got, cache = L.attention_decode(attn, torch.as_tensor(xt), cache,
                                        cfg)
        _close(got, want)
        for key in ("k", "v"):
            _close(cache[key], jcache[key])
        assert int(cache["pos"]) == int(jcache["pos"]) == t + 1


def test_attention_decode_past_a_full_cache():
    """A full-attention cache of 4 fed 7 tokens: the reference's
    ``dynamic_update_slice`` clamps the write to the last slot."""
    jcfg = jax_smoke_config("mistral_nemo_12b")
    cfg = get_smoke_config("mistral_nemo_12b")
    tree = JL.attn_init(jax.random.PRNGKey(8), jcfg)
    attn = _module(L.Attention, cfg, tree)
    x = _rand(np.random.default_rng(9), 2, 7, cfg.d_model)
    jcache = JL.make_kv_cache(jcfg, 2, 4, dtype=jnp.float32)
    cache = L.make_kv_cache(cfg, 2, 4, dtype=torch.float32)
    for t in range(7):
        xt = x[:, t:t + 1]
        want, jcache = jax_decode(tree, jnp.asarray(xt), jcache, jcfg)
        got, cache = L.attention_decode(attn, torch.as_tensor(xt), cache,
                                        cfg)
        _close(got, want)
        _close(cache["k"], jcache["k"])


@pytest.mark.parametrize("act", ["swiglu", "relu2", "gelu"])
def test_apply_mlp(act):
    jcfg = jax_smoke_config("mistral_nemo_12b").replace(mlp_act=act)
    cfg = get_smoke_config("mistral_nemo_12b").replace(mlp_act=act)
    tree = JL.mlp_init(jax.random.PRNGKey(10), jcfg)
    mlp = _module(L.MLP, cfg, tree)
    x = _rand(np.random.default_rng(11), 2, 7, cfg.d_model)
    _close(L.apply_mlp(mlp, torch.as_tensor(x), cfg),
           JL.apply_mlp(tree, jnp.asarray(x), jcfg))
