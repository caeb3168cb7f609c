"""The encoder-decoder and the vision-language model through the port
against the JAX package.

``whisper_medium`` (an encoder over frame embeddings, cross-attention in
every decoder block) and ``internvl2_1b`` (projected patch embeddings
before the text) at their smoke configs, in float32, from one set of
weights: drawn by the port, with random nonzero attention and LayerNorm
biases, laid out as the JAX tree (``torch_parity.jax_params``) and carried
back by ``params_from_jax``. Tolerances as for the decoders: hidden states
rtol 1e-4, atol 1e-5 (other summation orders, compounded over layers);
greedy tokens equal.

The reference's cross K/V cache leaves out the K and V biases that its
cross-attention adds (ROADMAP C.6), so an encoder-decoder's forward and
its prefill-then-decode compute other functions once those biases are
nonzero; the port reproduces that, and ``test_cross_kv_cache_drops_
biases`` pins it in both packages.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import layers as JL
from repro.models import model as JMDL
from repro_torch import configs
from repro_torch.launch import serve as SERVE
from repro_torch.models import layers as L
from repro_torch.models import model as MDL
from repro_torch.models.convert import params_from_jax
from torch_parity import jax_params, jax_serve

ARCHS = ["whisper_medium", "internvl2_1b"]
PROMPT, GEN, SLOTS = 6, 12, 2


def _randomise_biases(model, seed):
    """Random attention and LayerNorm biases (and norm scales), so that
    every one of them enters the comparison."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("bq", "bk", "bv", "bias"):
                p.copy_(torch.as_tensor(
                    0.3 * rng.standard_normal(tuple(p.shape)), dtype=p.dtype))
            elif leaf == "scale":
                p.copy_(torch.as_tensor(
                    1 + 0.2 * rng.standard_normal(tuple(p.shape)),
                    dtype=p.dtype))
    return model


class Setup:
    def __init__(self, arch, zero_biases=False):
        self.jcfg = ref_configs.get_smoke_config(arch)
        self.cfg = configs.get_smoke_config(arch)
        drawn = MDL.init_model(self.cfg, seed=3, device="cpu")
        if not zero_biases:
            _randomise_biases(drawn, 4)
        self.drawn = drawn
        self.jparams = jax_params(drawn)
        self.params = params_from_jax(
            jax.tree_util.tree_map(np.asarray, self.jparams), self.cfg)
        jcfg = self.jcfg
        self.forward = jax.jit(lambda p, t, fe: (
            JMDL.forward_hidden(p, t, jcfg, frontend_embeds=fe),
            JMDL.prefill_forward(p, t, jcfg, frontend_embeds=fe)))
        self.step = jax.jit(lambda p, s, t: JMDL.decode_step(p, s, t, jcfg))
        self.xkv = jax.jit(lambda p, fe: JMDL._encode_xkv(
            p, JMDL.encode(p, fe, jcfg), jcfg))

    def frontend(self, B, seed):
        P = self.cfg.enc_seq if self.cfg.enc_layers else self.cfg.num_patches
        return np.random.default_rng(seed).standard_normal(
            (B, P, self.cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def setups():
    made = {}

    def get(arch, zero_biases=False):
        if (arch, zero_biases) not in made:
            made[arch, zero_biases] = Setup(arch, zero_biases)
        return made[arch, zero_biases]

    return get


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax(setups, arch):
    """The JAX ``init_model``'s structure, shapes and dtypes (the encoder
    stack, ``enc_norm``, every ``xattn``/``norm_x``, ``patch_proj``), and
    every leaf carried into the parameter it was drawn as."""
    s = setups(arch)
    want = jax.eval_shape(lambda k: JMDL.init_model(k, s.jcfg),
                          jax.random.PRNGKey(0))
    assert jax.tree_util.tree_structure(s.jparams) == \
        jax.tree_util.tree_structure(want)
    for got, w in zip(jax.tree_util.tree_leaves(s.jparams),
                      jax.tree_util.tree_leaves(want)):
        assert (got.shape, got.dtype) == (w.shape, w.dtype)
    drawn = dict(s.drawn.named_parameters())
    got = dict(s.params.named_parameters())
    assert sorted(got) == sorted(drawn)
    for name, p in got.items():
        assert torch.equal(p, drawn[name]), name
    assert ("enc_layers" in s.jparams) == (arch == "whisper_medium")
    assert ("patch_proj" in s.jparams) == (arch == "internvl2_1b")


@pytest.mark.parametrize("arch", ARCHS)
def test_encode_forward_and_prefill_tokens(setups, arch):
    s = setups(arch)
    S = 10
    toks, fe = _tokens(s.cfg, 3, S, 2), s.frontend(3, 3)
    (want_h, _), want_tok = s.forward(s.jparams, jnp.asarray(toks),
                                      jnp.asarray(fe))
    got_h, aux = MDL.forward_hidden(s.params, torch.as_tensor(toks), s.cfg,
                                    frontend_embeds=torch.as_tensor(fe))
    assert got_h.shape == (3, S + s.cfg.num_patches, s.cfg.d_model)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-4,
                               atol=1e-5)
    assert float(aux) == 0.0
    got = MDL.prefill_forward(s.params, torch.as_tensor(toks), s.cfg,
                              frontend_embeds=torch.as_tensor(fe))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_tok))
    if s.cfg.enc_layers:
        want_enc = JMDL.encode(s.jparams, jnp.asarray(fe), s.jcfg)
        got_enc = MDL.encode(s.params, torch.as_tensor(fe), s.cfg)
        assert got_enc.shape == (3, s.cfg.enc_seq, s.cfg.d_model)
        np.testing.assert_allclose(got_enc.numpy(), np.asarray(want_enc),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_with_xkv_then_decode_matches(setups, arch):
    """``prefill`` with the frontend (the cross K/V cache for whisper; the
    reference's decode has no patch path), then greedy steps: equal."""
    s = setups(arch)
    prompt, fe = _tokens(s.cfg, SLOTS, PROMPT, 3), s.frontend(SLOTS, 4)
    jstate = JMDL.init_decode_state(s.jcfg, SLOTS, PROMPT + GEN,
                                    dtype=jnp.float32)
    if s.cfg.enc_layers:
        jstate["xkv"] = s.xkv(s.jparams, jnp.asarray(fe))
    for t in range(PROMPT):
        jtok, jstate = s.step(s.jparams, jstate, jnp.asarray(prompt[:, t]))
    state = MDL.init_decode_state(s.cfg, SLOTS, PROMPT + GEN,
                                  dtype=torch.float32, device="cpu")
    assert ("xkv" in state) == bool(s.cfg.enc_layers)
    state, tok = MDL.prefill(s.params, state, torch.as_tensor(prompt), s.cfg,
                             frontend_embeds=torch.as_tensor(fe))
    if s.cfg.enc_layers:
        k, v = state["xkv"][0]["pos0"]
        jk, jv = jstate["xkv"]["pos0"]
        np.testing.assert_allclose(k.numpy(), np.asarray(jk)[0], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv)[0], rtol=1e-4,
                                   atol=1e-5)
    want, got = [np.asarray(jtok)], [tok.numpy()]
    for _ in range(GEN - 1):
        jtok, jstate = s.step(s.jparams, jstate, jtok)
        tok, state = MDL.decode_step(s.params, state, tok, s.cfg)
        want.append(np.asarray(jtok))
        got.append(tok.numpy())
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


def test_init_decode_state_with_xkv(setups):
    s = setups("whisper_medium")
    st = MDL.init_decode_state(s.cfg, 2, 8, dtype=torch.float32,
                               device="cpu", with_xkv=True)
    want = JMDL.init_decode_state(s.jcfg, 2, 8, dtype=jnp.float32,
                                  with_xkv=True)
    k, v = st["xkv"][1]["pos0"]
    assert len(st["xkv"]) == s.cfg.n_periods
    assert k.shape == v.shape == want["xkv"]["pos0"][0].shape[1:]
    assert not k.any() and not v.any()
    assert MDL.init_decode_state(s.cfg, 2, 8, device="cpu")["xkv"] is None


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_jax(setups, arch):
    """Three requests in waves of two slots; whisper with each request's
    frames encoded into the cross K/V."""
    s = setups(arch)
    prompts = _tokens(s.cfg, 3, PROMPT, 5)
    fe = s.frontend(3, 6) if s.cfg.enc_layers else None
    want = jax_serve(s.step, s.jparams, s.jcfg, prompts, slots=SLOTS,
                     gen_len=GEN, frontend=fe, encode=s.xkv)
    got, stats = SERVE.serve(s.params, s.cfg, prompts, slots=SLOTS,
                             gen_len=GEN, frontend=fe, device="cpu")
    assert got == want
    assert stats["requests"] == 3 and stats["tokens"] == 3 * GEN


@functools.partial(jax.jit, static_argnums=(3,))
def _jax_cross(pp, h, enc_out, cfg):
    """The reference's cross-attention of one block two ways: as the
    forward computes it, and against the K/V that prefill caches."""
    stacked = {"layers": {"pos0": jax.tree_util.tree_map(lambda a: a[None],
                                                         pp)}}
    xkv = jax.tree_util.tree_map(
        lambda a: a[0], JMDL._encode_xkv(stacked, enc_out, cfg)["pos0"])
    full = JL.attention_cross(pp["xattn"], JL.apply_norm(pp["norm_x"], h, cfg),
                              enc_out, cfg)
    return full, JMDL._cross_decode(pp, h, xkv, cfg)


class _OneBlock:
    """A stand-in model of one period holding one block."""

    def __init__(self, pp):
        self.layers = [{"pos0": pp}]


def _port_cross(pp, h, enc_out, cfg):
    full = L.attention_cross(pp.xattn, L.apply_norm(pp.norm_x, h, cfg),
                             enc_out, cfg)
    xkv = MDL._encode_xkv(_OneBlock(pp), enc_out, cfg)[0]["pos0"]
    return full, MDL._cross_decode(pp, h, xkv, cfg)


def _port_agreement(s, toks, fe):
    """Where the port's forward and its prefill-then-decode pick the same
    greedy token."""
    to = torch.as_tensor
    h, _ = MDL.forward_hidden(s.params, to(toks), s.cfg,
                              frontend_embeds=to(fe))
    full = torch.argmax(L.mask_padded_vocab(
        L.logits_from_hidden(s.params, h, s.cfg).float(), s.cfg), dim=-1)
    state = MDL.init_decode_state(s.cfg, toks.shape[0], toks.shape[1],
                                  dtype=torch.float32, device="cpu")
    state, first = MDL.prefill(s.params, state, to(toks[:, :1]), s.cfg,
                               frontend_embeds=to(fe))
    preds = [first]
    for t in range(1, toks.shape[1]):
        nxt, state = MDL.decode_step(s.params, state, to(toks[:, t]), s.cfg)
        preds.append(nxt)
    return (torch.stack(preds, 1) == full).numpy()


def _jax_agreement(s, toks, fe):
    (h, _), _ = s.forward(s.jparams, jnp.asarray(toks), jnp.asarray(fe))
    full = np.asarray(jnp.argmax(JL.mask_padded_vocab(
        JL.logits_from_hidden(s.jparams, h, s.jcfg).astype(jnp.float32),
        s.jcfg), axis=-1))
    state = JMDL.init_decode_state(s.jcfg, toks.shape[0], toks.shape[1],
                                   dtype=jnp.float32)
    state["xkv"] = s.xkv(s.jparams, jnp.asarray(fe))
    preds = []
    for t in range(toks.shape[1]):
        nxt, state = s.step(s.jparams, state, jnp.asarray(toks[:, t]))
        preds.append(np.asarray(nxt))
    return np.stack(preds, 1) == full


def test_cross_kv_cache_drops_biases(setups):
    """C.6: with nonzero ``bk``/``bv`` a decode token's cross-attention
    against the prefill cache differs from the forward's
    ``attention_cross`` (the cache has no K/V biases), in both packages
    by the same amount; with zero biases the two agree. Over the whole
    model, forward and prefill-then-decode then pick other tokens, at the
    same positions in both packages."""
    for zero in (False, True):
        s = setups("whisper_medium", zero_biases=zero)
        jpp = jax.tree_util.tree_map(lambda a: a[0],
                                     s.jparams["layers"]["pos0"])
        pp = s.params.layers[0]["pos0"]
        rng = np.random.default_rng(7)
        h = rng.standard_normal((2, 1, s.cfg.d_model)).astype(np.float32)
        enc = rng.standard_normal(
            (2, s.cfg.enc_seq, s.cfg.d_model)).astype(np.float32)
        jfull, jdec = _jax_cross(jpp, jnp.asarray(h), jnp.asarray(enc),
                                 s.jcfg)
        full, dec = _port_cross(pp, torch.as_tensor(h), torch.as_tensor(enc),
                                s.cfg)
        np.testing.assert_allclose(full.numpy(), np.asarray(jfull),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), rtol=1e-4,
                                   atol=1e-5)
        gap, jgap = (dec - full).numpy(), np.asarray(jdec - jfull)
        np.testing.assert_allclose(gap, jgap, rtol=1e-4, atol=1e-5)
        if zero:
            assert np.abs(gap).max() < 1e-5
        else:
            assert np.abs(gap).max() > 1e-2
    s = setups("whisper_medium")
    toks, fe = _tokens(s.cfg, 2, 16, 8), s.frontend(2, 9)
    port, ref = _port_agreement(s, toks, fe), _jax_agreement(s, toks, fe)
    np.testing.assert_array_equal(port, ref)
    assert port.mean() < 1.0


def test_forward_agrees_with_decode_at_zero_biases(setups):
    """Where the reference's path makes them comparable (the biases at
    their initial zeros), the forward's greedy tokens and token-by-token
    decode with the cross K/V agree on at least 95 % of tokens."""
    s = setups("whisper_medium", zero_biases=True)
    toks, fe = _tokens(s.cfg, 2, 16, 10), s.frontend(2, 11)
    match = float(_port_agreement(s, toks, fe).mean())
    assert match >= 0.95, match


def test_serve_cli_on_cpu(capsys):
    assert SERVE.main(["--arch", "whisper_medium", "--smoke", "--device",
                       "cpu", "--requests", "3", "--slots", "2",
                       "--prompt-len", "4", "--gen-len", "3"]) == 0
    assert "served 3 requests, 9 tokens" in capsys.readouterr().out
