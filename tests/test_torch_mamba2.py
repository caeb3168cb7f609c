"""The port's Mamba-2 serving path against the JAX package's, on the CPU.

Both packages compute from one set of weights: the JAX package's
``init_model`` tree, carried over by ``repro_torch.models.convert.
params_from_jax``, on ``get_smoke_config("mamba2_370m")`` (float32
compute). Tolerances:

* ``ssd_chunked``, ``mamba_forward`` and ``mamba_decode``: rtol 1e-5. The
  port's chunked scan sums in another order than the reference's jnp
  einsums, so the two agree to float32 rounding, not bit for bit;
* ``forward_hidden``: rtol 1e-4, atol 1e-5, for the same reason, compounded
  over the layers and the norms;
* greedy tokens (``prefill_forward``, a 24-step ``decode_step`` sequence
  and the serve loop): equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import mamba2 as JM
from repro.models import model as JMDL
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve as SERVE
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import model as MDL
from repro_torch.models.convert import params_from_jax
from repro_torch.train.serve_step import (
    make_decode_state, make_decode_step, make_prefill_step)
from torch_parity import jax_serve

ARCH = "mamba2_370m"


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_smoke_config(ARCH)
    cfg = get_smoke_config(ARCH)
    jparams = JMDL.init_model(jax.random.PRNGKey(3), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, cfg, jparams, params_from_jax(tree, cfg)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int32)


def _layer0(jparams):
    return jax.tree_util.tree_map(lambda a: a[0],
                                  jparams["layers"]["pos0"]["mamba"])


def test_ssd_chunked_ragged_sequence(setup):
    """S = 37 with chunk 16: the port pads to 48 with dt = 0 and crops."""
    _, cfg, _, _ = setup
    rng = np.random.default_rng(0)
    B, S, nh, hd, ds = 2, 37, cfg.ssm_n_heads, cfg.ssm_head_dim, cfg.ssm_state
    x = rng.standard_normal((B, S, nh, hd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, nh)) - 2)).astype(np.float32)
    A = (-np.exp(rng.standard_normal(nh))).astype(np.float32)
    Bm = rng.standard_normal((B, S, ds)).astype(np.float32)
    Cm = rng.standard_normal((B, S, ds)).astype(np.float32)
    D = rng.standard_normal(nh).astype(np.float32)
    args = (x, dt, A, Bm, Cm, D)
    want = JM.ssd_chunked(*map(jnp.asarray, args), chunk=cfg.ssm_chunk)
    got = M.ssd_chunked(*map(torch.as_tensor, args), chunk=cfg.ssm_chunk)
    assert got.shape == (B, S, nh, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_mamba_forward_and_decode(setup):
    jcfg, cfg, jparams, params = setup
    mixer = params.layers[0]["pos0"].mamba
    jp = _layer0(jparams)
    x = np.random.default_rng(1).standard_normal(
        (2, 21, cfg.d_model)).astype(np.float32)
    want = JM.mamba_forward(jp, jnp.asarray(x), jcfg)
    got = M.mamba_forward(mixer, torch.as_tensor(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)

    jcache = JM.make_mamba_cache(jcfg, 2)
    cache = M.make_mamba_cache(cfg, 2)
    for t in range(5):
        xt = x[:, t:t + 1]
        want, jcache = JM.mamba_decode(jp, jnp.asarray(xt), jcache, jcfg)
        got, cache = M.mamba_decode(mixer, torch.as_tensor(xt), cache, cfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
        for k in cache:
            np.testing.assert_allclose(cache[k].numpy(),
                                       np.asarray(jcache[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_forward_hidden_and_prefill_tokens(setup):
    jcfg, cfg, jparams, params = setup
    toks = _tokens(cfg, 3, 40, 2)
    want_h, _ = jax.jit(lambda p, t: JMDL.forward_hidden(p, t, jcfg))(
        jparams, jnp.asarray(toks))
    got_h, aux = MDL.forward_hidden(params, torch.as_tensor(toks), cfg)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=1e-4,
                               atol=1e-5)
    want = JMDL.prefill_forward(jparams, jnp.asarray(toks), jcfg)
    got = make_prefill_step(cfg)(params, torch.as_tensor(toks))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_decode_sequence_matches(setup):
    """Prompt fed through ``prefill``, then 24 greedy steps: equal tokens."""
    jcfg, cfg, jparams, params = setup
    prompt = _tokens(cfg, 2, 6, 3)
    jstep = jax.jit(lambda p, s, t: JMDL.decode_step(p, s, t, jcfg))
    jstate = JMDL.init_decode_state(jcfg, 2, 30, dtype=jnp.float32)
    for t in range(prompt.shape[1]):
        jtok, jstate = jstep(jparams, jstate, jnp.asarray(prompt[:, t]))
    state = make_decode_state(cfg, 2, 30, dtype=torch.float32, device="cpu")
    state, tok = MDL.prefill(params, state, torch.as_tensor(prompt), cfg)
    step = make_decode_step(cfg)
    want, got = [np.asarray(jtok)], [tok.numpy()]
    for _ in range(24):
        jtok, jstate = jstep(jparams, jstate, jtok)
        tok, state = step(params, state, tok)
        want.append(np.asarray(jtok))
        got.append(tok.numpy())
    np.testing.assert_array_equal(np.stack(got), np.stack(want))


def test_forward_agrees_with_decode(setup):
    """The chunked forward's greedy tokens against token-by-token decode,
    the check ``tests/test_models.py`` applies to the JAX package."""
    _, cfg, _, params = setup
    toks = torch.as_tensor(_tokens(cfg, 2, 40, 4))
    h, _ = MDL.forward_hidden(params, toks, cfg)
    full = torch.argmax(L.mask_padded_vocab(
        L.logits_from_hidden(params, h, cfg).float(), cfg), dim=-1)
    state = MDL.init_decode_state(cfg, 2, 40, dtype=torch.float32,
                                  device="cpu")
    preds = []
    for t in range(toks.shape[1]):
        nxt, state = MDL.decode_step(params, state, toks[:, t], cfg)
        preds.append(nxt)
    match = float((torch.stack(preds, 1) == full).float().mean())
    assert match >= 0.95, match


def test_serve_loop_matches_jax(setup):
    jcfg, cfg, jparams, params = setup
    prompts = _tokens(cfg, 5, 7, 5)  # 5 requests in waves of 3: one slot idle
    step = jax.jit(lambda p, s, t: JMDL.decode_step(p, s, t, jcfg))
    want = jax_serve(step, jparams, jcfg, prompts, slots=3, gen_len=9)
    got, stats = SERVE.serve(params, cfg, prompts, slots=3, gen_len=9,
                             device="cpu")
    assert got == want
    assert stats["requests"] == 5 and stats["tokens"] == 45
    assert stats["waves"] == 2 and stats["decode_steps"] == 32


def test_serve_cli_on_cpu(capsys):
    assert SERVE.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--prompt-len",
                       "4", "--gen-len", "3"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens" in out


def test_unported_architectures_raise():
    """Every architecture of the registry is ported (the encoder-decoder
    and the vision-language model since they came with cross-attention
    and patch embeddings); an unknown one raises."""
    from repro_torch.configs import ARCH_IDS, PORTED, get_config

    assert PORTED == ARCH_IDS
    for arch in ("whisper_medium", "internvl2_1b"):
        assert get_config(arch).name == arch.replace("_", "-")
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("llama_7b")
    cfg = get_smoke_config(ARCH)
    for extra in (dict(enc_layers=2, enc_seq=24), dict(num_patches=8)):
        model = MDL.init_model(cfg.replace(**extra), device="cpu")
        assert hasattr(model, "enc_layers") == ("enc_layers" in extra)
        assert hasattr(model, "patch_proj") == ("num_patches" in extra)