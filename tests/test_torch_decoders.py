"""Every decoder-only architecture through the port against the JAX package.

Parametrised over the seven smoke configs ported with attention, the
dense MLPs and the MoE layer (``mamba2_370m`` has its own file). Both
packages compute from one set of weights: drawn by the port's
``init_model``, laid out as the JAX package's ``init_model`` tree
(structure, shapes and dtypes checked against it) and carried back by
``params_from_jax``. Tolerances:

* ``forward_hidden`` and its aux loss, float32: rtol 1e-4, atol 1e-5 (the
  two sum their products in other orders; the error compounds over the
  layers and norms);
* greedy tokens (``prefill_forward``, prefill then 24 decode steps, the
  serve loop): equal;
* the chunked forward against token-by-token decode, the port alone: at
  least 95 % of greedy tokens equal, as ``tests/test_models.py`` asks of
  the JAX package;
* bfloat16 weights and compute (a dense, a MoE and the hybrid config),
  each half of each layer (mixer; MLP or MoE) from the same input: its
  output to 2^-6 of its largest value plus 2^-6 of each value, four
  bfloat16 roundings (2^-8 each): the two packages round their float32
  sums to bfloat16 after every product, norm and residual add, and a sum
  that lands on the other side of a rounding boundary moves the result
  by one such step; the MoE aux loss, computed in float32 from the same
  input, to rtol 1e-5. Larger spans are not compared in bfloat16: such a
  step in a MoE layer's input can flip a token's expert choice
  (``mixtral_8x22b``'s attention-then-MoE layer moves 97 of 3,072 values
  by up to 0.46 so, ``jamba_v01_52b``'s final hidden state 16 by up to
  0.29).
* the chunked forward against token-by-token decode uses a MoE capacity
  factor of E/k (see ``test_forward_agrees_with_decode``).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import layers as JL
from repro.models import mamba2 as JMB
from repro.models import moe as JMOE
from repro.models import model as JMDL
from repro_torch import configs
from repro_torch.launch import serve as SERVE
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import model as MDL
from repro_torch.models.convert import params_from_jax
from repro_torch.models.moe import no_drop
from repro_torch.train.serve_step import (
    make_decode_state, make_decode_step, make_prefill_step)
from torch_parity import jax_serve

ARCHS = ["mistral_nemo_12b", "command_r_35b", "mistral_large_123b",
         "nemotron_4_340b", "mixtral_8x22b", "granite_moe_3b_a800m",
         "jamba_v01_52b"]
PROMPT, GEN, SLOTS = 6, 24, 2  # one decode-state shape for every test
BF16_TOL = 2.0 ** -6


def jax_tree(model, cfg):
    """The port's parameters as a JAX ``init_model`` tree: every layer leaf
    stacked on a leading ``n_periods`` axis, in its parameter's dtype
    (bfloat16 values convert exactly)."""
    def arr(ts):
        return jnp.asarray(np.stack([t.float().numpy() for t in ts]),
                           dtype=jnp.dtype(str(ts[0].dtype).split(".")[1]))

    names = [n for n, _ in model.layers[0].named_parameters()]
    tree = {"layers": {}}
    for n, p in model.named_parameters():
        if not n.startswith("layers."):
            sub, _, leaf = n.rpartition(".")
            (tree.setdefault(sub, {}) if sub else tree)[leaf] = arr([p])[0]
    for n in names:
        pos, part, leaf = n.split(".")
        ts = [dict(period.named_parameters())[n] for period in model.layers]
        tree["layers"].setdefault(pos, {}).setdefault(part, {})[leaf] = \
            arr(ts)
    return tree


class Setup:
    """One architecture's smoke config in both packages, one set of
    weights for both (drawn by the port's ``init_model``, with the JAX
    ``init_model``'s structure, shapes and dtypes, then carried back by
    ``params_from_jax``), and the jitted JAX functions."""

    def __init__(self, arch, dtype=None):
        self.jcfg = ref_configs.get_smoke_config(arch)
        self.cfg = configs.get_smoke_config(arch)
        if dtype:
            self.jcfg = self.jcfg.replace(param_dtype=dtype,
                                          compute_dtype=dtype)
            self.cfg = self.cfg.replace(param_dtype=dtype,
                                        compute_dtype=dtype)
        jcfg = self.jcfg
        self.drawn = MDL.init_model(self.cfg, seed=3, device="cpu")
        self.jparams = jax_tree(self.drawn, self.cfg)
        self.tree = jax.tree_util.tree_map(np.asarray, self.jparams)
        self.params = params_from_jax(self.tree, self.cfg)
        self.forward = jax.jit(lambda p, t: (JMDL.forward_hidden(p, t, jcfg),
                                             JMDL.prefill_forward(p, t, jcfg)))
        self.step = jax.jit(lambda p, s, t: JMDL.decode_step(p, s, t, jcfg))


@pytest.fixture(scope="module")
def setups():
    made = {}

    def get(arch, dtype=None):
        if (arch, dtype) not in made:
            made[arch, dtype] = Setup(arch, dtype)
        return made[arch, dtype]

    return get


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int32)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copies_match(arch):
    for get in ("get_config", "get_smoke_config"):
        want = getattr(ref_configs, get)(arch)
        got = getattr(configs, get)(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.param_count() == want.param_count()


def test_all_configs_match():
    """``all_configs()`` has the reference's ids, in its order, and each
    config equal to the reference's field for field."""
    want, got = ref_configs.all_configs(), configs.all_configs()
    assert list(got) == list(want)
    for arch, cfg in want.items():
        assert dataclasses.asdict(got[arch]) == dataclasses.asdict(cfg), arch


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax(setups, arch):
    """The tree has the JAX ``init_model``'s structure, shapes and dtypes,
    and ``params_from_jax`` carries every leaf of it into the parameter
    it was drawn as."""
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
        assert p.dtype == drawn[name].dtype
        assert torch.equal(p, drawn[name]), name


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_hidden_and_prefill_tokens(setups, arch):
    s = setups(arch)
    toks = _tokens(s.cfg, 3, 40, 2)
    (want_h, want_aux), want_tok = s.forward(s.jparams, jnp.asarray(toks))
    got_h, aux = MDL.forward_hidden(s.params, torch.as_tensor(toks), s.cfg)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-4,
                               atol=1e-5)
    assert (float(aux) > 0) == bool(s.cfg.moe_num_experts)
    got = make_prefill_step(s.cfg)(s.params, torch.as_tensor(toks))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_tok))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_matches(setups, arch):
    """A prompt fed through ``prefill``, then 24 greedy steps: equal."""
    s = setups(arch)
    prompt = _tokens(s.cfg, SLOTS, PROMPT, 3)
    jstate = JMDL.init_decode_state(s.jcfg, SLOTS, PROMPT + GEN,
                                    dtype=jnp.float32)
    for t in range(PROMPT):
        jtok, jstate = s.step(s.jparams, jstate, jnp.asarray(prompt[:, t]))
    state = make_decode_state(s.cfg, SLOTS, PROMPT + GEN,
                              dtype=torch.float32, device="cpu")
    state, tok = MDL.prefill(s.params, state, torch.as_tensor(prompt), s.cfg)
    step = make_decode_step(s.cfg)
    want, got = [np.asarray(jtok)], [tok.numpy()]
    for _ in range(GEN - 1):
        jtok, jstate = s.step(s.jparams, jstate, jtok)
        tok, state = step(s.params, state, tok)
        want.append(np.asarray(jtok))
        got.append(tok.numpy())
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_agrees_with_decode(setups, arch):
    """The chunked forward's greedy tokens against token-by-token decode.
    A MoE forward drops a row's tokens past an expert's capacity, which
    decode (one token, C = 1) never does, so the two compute the same
    function only when nothing can drop: the check runs at a capacity
    factor of E/k, where C = S (the JAX package agrees on 0.9375 of
    ``mixtral_8x22b``'s tokens here at the config's 1.25, and on all at
    E/k)."""
    s = setups(arch)
    cfg = no_drop(s.cfg)
    toks = torch.as_tensor(_tokens(cfg, 2, 32, 4))
    h, _ = MDL.forward_hidden(s.params, toks, cfg)
    full = torch.argmax(L.mask_padded_vocab(
        L.logits_from_hidden(s.params, h, cfg).float(), cfg), dim=-1)
    state = MDL.init_decode_state(cfg, 2, 32, dtype=torch.float32,
                                  device="cpu")
    preds = []
    for t in range(toks.shape[1]):
        nxt, state = MDL.decode_step(s.params, state, toks[:, t], cfg)
        preds.append(nxt)
    match = float((torch.stack(preds, 1) == full).float().mean())
    assert match >= 0.95, match


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_jax(setups, arch):
    """Three requests in waves of two slots (one idle in the second)."""
    s = setups(arch)
    prompts = _tokens(s.cfg, 3, PROMPT, 5)
    want = jax_serve(s.step, s.jparams, s.jcfg, prompts, slots=SLOTS,
                     gen_len=GEN)
    got, stats = SERVE.serve(s.params, s.cfg, prompts, slots=SLOTS,
                             gen_len=GEN, device="cpu")
    assert got == want
    assert stats["requests"] == 3 and stats["tokens"] == 3 * GEN
    assert stats["waves"] == 2


@functools.partial(jax.jit, static_argnums=(2, 3))
def jax_mixer(pp, h, cfg, spec):
    """The JAX package's mixer of one position (its first half)."""
    hn = JL.apply_norm(pp["norm1"], h, cfg)
    if spec.kind == "attn":
        return JL.attention_train(pp["attn"], hn, cfg)[0]
    return JMB.mamba_forward(pp["mamba"], hn, cfg)


@functools.partial(jax.jit, static_argnums=(2, 3))
def jax_ffn(pp, u, cfg, spec):
    """The JAX package's MLP or MoE of one position, with the residual,
    and the MoE aux loss."""
    hn = JL.apply_norm(pp["norm2"], u, cfg)
    if spec.mlp == "moe":
        out, aux = JMOE.apply_moe(pp["moe"], hn, cfg)
        return u + out, aux
    return u + JL.apply_mlp(pp["mlp"], hn, cfg), jnp.zeros((), jnp.float32)


def _bf16_close(got, want, what):
    assert got.dtype == torch.bfloat16, what
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_TOL,
                               atol=BF16_TOL * float(np.abs(want).max()),
                               err_msg=what)


def _port(x):
    return torch.tensor(np.asarray(x, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("arch", ["mistral_nemo_12b", "mixtral_8x22b",
                                  "jamba_v01_52b"])
def test_bf16_layers(setups, arch):
    """bfloat16 weights and compute, each half of each position (the
    mixer, then the MLP or MoE) from the JAX package's input to it, so a
    rounding step does not compound or flip a MoE layer's expert choice
    on the way."""
    s = setups(arch, "bfloat16")
    assert s.params.embed.dtype == torch.bfloat16
    toks = _tokens(s.cfg, 2, 24, 6)
    jh = JL.embed_tokens(s.jparams["embed"], jnp.asarray(toks), s.jcfg)
    h = L.embed_tokens(s.params.embed, torch.as_tensor(toks), s.cfg)
    assert torch.equal(h, _port(jh))
    for pi, period in enumerate(s.params.layers):
        for i, spec in enumerate(s.cfg.period):
            pp, what = period[f"pos{i}"], f"period {pi} pos{i}"
            jpp = jax.tree_util.tree_map(lambda x: x[pi],
                                         s.jparams["layers"][f"pos{i}"])
            hn = L.apply_norm(pp.norm1, _port(jh), s.cfg)
            got = (L.attention_train(pp.attn, hn, s.cfg)[0]
                   if spec.kind == "attn"
                   else M.mamba_forward(pp.mamba, hn, s.cfg))
            want = jax_mixer(jpp, jh, s.jcfg, spec)
            _bf16_close(got, want, what + " mixer")
            ju = jh + want
            jh, want_aux = jax_ffn(jpp, ju, s.jcfg, spec)
            got, aux = MDL._apply_mlp(pp, _port(ju), s.cfg, spec)
            _bf16_close(got, jh, what + " " + spec.mlp)
            if spec.mlp == "moe":
                np.testing.assert_allclose(float(aux), float(want_aux),
                                           rtol=1e-5)


def test_serve_cli_on_cpu(capsys):
    assert SERVE.main(["--arch", "mistral_nemo_12b", "--smoke", "--device",
                       "cpu", "--requests", "3", "--slots", "2",
                       "--prompt-len", "4", "--gen-len", "3"]) == 0
    assert "served 3 requests, 9 tokens" in capsys.readouterr().out
