"""Training on the port against the JAX package.

* One train step (flash cross-entropy, attention's and the cross-
  entropy's recomputing backwards, the Mamba-2 mixer's gradient through
  the plain scan, MoE, AdamW) of every architecture's smoke config
  against ``repro.train.train_step.make_train_step`` from the same
  weights and batch, in float32: the loss, the aux loss and ``grad_norm``
  to rtol 1e-4; every updated parameter and both moments to rtol 2e-4,
  atol 2e-5 (``tests/test_models.py``'s tolerance for accumulation), at
  an AdamW eps of 1e-6 (see ``OPT``); again at the default eps 1e-8, with
  every gradient leaf against ``jax.grad`` of the reference's loss and
  the parameters compared where the gradient is clear of rounding.
* ``accum=2`` against ``accum=1``; ``cfg.remat`` against none.
* The gradients of flash attention (causal, windowed, GQA, padded keys;
  bidirectional) and of both cross-entropies against ``jax.grad`` of the
  reference's, rtol 1e-4 with an absolute floor of 1e-5 of the largest
  value (float32 sums in other orders).
* The Mamba-2 mixer's gradient (autograd through ``ssd_scan_plain``)
  against ``jax.grad`` of the reference's ``mamba_forward``, with a
  length that right-pads the last chunk with zero-dt rows.
* The train launcher: a run with checkpoints resumed from its newest one
  equals the uninterrupted run; ``--arch whisper_medium`` fails in both
  launchers as the reference does (ROADMAP C.7: no frame embeddings).
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.models import layers as JL
from repro.models import mamba2 as JMB
from repro.models import model as JMDL
from repro.optim import adamw as JADAM
from repro.train import train_step as JTS
from repro_torch import configs
from repro_torch.launch import train as TRAIN
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M
from repro_torch.models import model as MDL
from repro_torch.models.convert import leaf_of, params_from_jax
from repro_torch.optim import adamw
from repro_torch.train.train_step import (init_state, make_loss_fn,
                                         make_train_step)
from torch_parity import jax_params

# eps 1e-6 (both packages): Adam's first step moves each element by
# lr · g / (|g| + eps), so with eps 1e-8 an element whose gradient sums to
# within float32 rounding of 0 (about 1e-9 here) moves by anything up to lr
# either way in either package; at 1e-6 that rounding moves it by 1e-3 lr
OPT = dict(lr=1e-3, total_steps=10, warmup_steps=2, eps=1e-6)


def _batch(cfg, seed, B=2, S=24):
    """tokens, targets and the frontend (frames or patches), as in
    ``tests/test_models.py``'s ``_batch``, drawn with numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    tgts = np.roll(toks, -1, axis=1)
    fe = None
    if cfg.enc_layers:
        fe = rng.standard_normal((B, cfg.enc_seq, cfg.d_model))
    if cfg.num_patches:
        toks = toks[:, :S - cfg.num_patches]
        tgts = tgts[:, :toks.shape[1]]
        fe = rng.standard_normal((B, cfg.num_patches, cfg.d_model))
    return toks, tgts, None if fe is None else fe.astype(np.float32)


def _model(arch, seed=3):
    cfg = configs.get_smoke_config(arch)
    drawn = MDL.init_model(cfg, seed=seed, device="cpu")
    jparams = jax_params(drawn)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg)
    params.requires_grad_(True)
    return cfg, params, jparams


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_train_step_matches_jax(arch):
    cfg, params, jparams = _model(arch)
    jcfg = ref_configs.get_smoke_config(arch)
    toks, tgts, fe = _batch(cfg, 1)
    jopt = JADAM.OptConfig(**OPT)
    jargs = (jparams, JADAM.init(jparams, jopt), jnp.asarray(toks),
             jnp.asarray(tgts)) + ((jnp.asarray(fe),) if fe is not None
                                   else ())
    jp, jo, jm = jax.jit(JTS.make_train_step(jcfg, jopt))(*jargs)
    opt = adamw.OptConfig(**OPT)
    p, o, m = make_train_step(cfg, opt)(
        params, adamw.init(params, opt), torch.as_tensor(toks),
        torch.as_tensor(tgts), None if fe is None else torch.as_tensor(fe))
    for k in ("loss", "aux", "grad_norm", "total_loss", "lr"):
        _close(float(m[k]), float(jm[k]), 1e-4, 1e-7, k)
    assert (float(m["aux"]) > 0) == bool(cfg.moe_num_experts)
    assert int(o.step) == int(jo.step) == 1
    changed = 0
    for name, q in p.named_parameters():
        want = leaf_of(jp, name)
        _close(q.detach().numpy(), want, 2e-4, 2e-5, name)
        _close(o.m[name].numpy(), leaf_of(jo.m, name), 2e-4, 2e-5, "m " + name)
        _close(o.v[name].numpy(), leaf_of(jo.v, name), 2e-4, 2e-5, "v " + name)
        changed += not np.array_equal(q.detach().numpy(),
                                      leaf_of(jparams, name))
    assert changed > len(list(p.parameters())) // 2


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_train_step_at_default_eps_matches_jax(arch):
    """The step as the launcher runs it (AdamW's default eps 1e-8): the
    whole loss's gradients against ``jax.grad`` of the reference's, every
    leaf to rtol 1e-4 with an absolute floor of 1e-5 of its largest value
    plus 1e-7 of the largest gradient of all; then the step against the reference's ``adamw.update`` of those
    gradients: the metrics and both moments everywhere, each updated
    parameter where its gradient is well clear of float32 rounding and of
    eps (elsewhere the first step moves an element by up to lr either
    way, see ``OPT``)."""
    cfg, params, jparams = _model(arch)
    jcfg = ref_configs.get_smoke_config(arch)
    toks, tgts, fe = _batch(cfg, 1)
    jfe = None if fe is None else jnp.asarray(fe)
    (jtotal, _), jg = jax.jit(jax.value_and_grad(
        JTS.make_loss_fn(jcfg), has_aux=True))(
            jparams, jnp.asarray(toks), jnp.asarray(tgts), jfe)
    tfe = None if fe is None else torch.as_tensor(fe)
    total, _ = make_loss_fn(cfg)(params, torch.as_tensor(toks),
                                 torch.as_tensor(tgts), tfe)
    _close(float(total.detach()), float(jtotal), 1e-4, 1e-7, "total loss")
    named = list(params.named_parameters())
    gs = torch.autograd.grad(total, [q for _, q in named], allow_unused=True)
    # a leaf whose gradient is 0 in exact arithmetic (cross-attention's bk:
    # softmax ignores a bias shared by every key) holds float32 rounding at
    # the scale of the largest gradient, so that is the absolute floor
    floor = 1e-7 * max(float(np.abs(np.asarray(g)).max())
                       for g in jax.tree_util.tree_leaves(jg))
    for (name, q), g in zip(named, gs):
        want = np.asarray(leaf_of(jg, name), np.float32)
        _close(np.zeros(q.shape, np.float32) if g is None else g.numpy(),
               want, 1e-4, 1e-5 * float(np.abs(want).max()) + floor,
               "grad " + name)

    opt = adamw.OptConfig(lr=OPT["lr"], total_steps=OPT["total_steps"],
                          warmup_steps=OPT["warmup_steps"])
    jopt = JADAM.OptConfig(lr=OPT["lr"], total_steps=OPT["total_steps"],
                           warmup_steps=OPT["warmup_steps"])
    assert opt.eps == jopt.eps == 1e-8
    jp, jo, jm = JADAM.update(jg, JADAM.init(jparams, jopt), jparams, jopt)
    before = {n: q.detach().clone() for n, q in named}
    p, o, m = make_train_step(cfg, opt)(
        params, adamw.init(params, opt), torch.as_tensor(toks),
        torch.as_tensor(tgts), tfe)
    for k in ("grad_norm", "lr"):
        _close(float(m[k]), float(jm[k]), 1e-4, 1e-7, k)
    compared = total_elems = 0
    for name, q in p.named_parameters():
        _close(o.m[name].numpy(), leaf_of(jo.m, name), 2e-4, 2e-5, "m " + name)
        _close(o.v[name].numpy(), leaf_of(jo.v, name), 2e-4, 2e-5, "v " + name)
        g = np.abs(np.asarray(leaf_of(jg, name), np.float32))
        clear = g > max(1e-3 * float(g.max()), 1e-5)
        got, want = q.detach().numpy(), np.asarray(leaf_of(jp, name))
        _close(got[clear], want[clear], 2e-4, 2e-5, name)
        assert not (clear.any() and np.array_equal(
            got[clear], before[name].numpy()[clear])), name
        compared += int(clear.sum())
        total_elems += g.size
    assert compared > total_elems // 2


def test_grad_accum_equivalence():
    """accum=2 on the global batch against accum=1 (the reference's
    ``test_grad_accum_equivalence``)."""
    cfg = configs.get_smoke_config("mistral_nemo_12b")
    opt = adamw.OptConfig(**OPT)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (4, 16),
                                             dtype=np.int32)
    tgts = np.roll(toks, -1, axis=1)
    outs = []
    for accum in (1, 2):
        params, state = init_state(cfg, opt, seed=5, device="cpu")
        p, _, m = make_train_step(cfg, opt, accum=accum)(
            params, state, torch.as_tensor(toks), torch.as_tensor(tgts))
        outs.append((dict(p.named_parameters()), float(m["total_loss"])))
    assert abs(outs[0][1] - outs[1][1]) < 1e-4
    for name, a in outs[0][0].items():
        _close(a.detach().numpy(), outs[1][0][name].detach().numpy(), 2e-4,
               2e-5, name)


def test_remat_gives_the_same_gradients():
    """``cfg.remat`` runs each period and encoder layer under
    ``torch.utils.checkpoint``: the same loss and gradients."""
    cfg = configs.get_smoke_config("whisper_medium")
    toks, tgts, fe = _batch(cfg, 3)
    grads = []
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        params, _ = init_state(c, adamw.OptConfig(), seed=1, device="cpu")
        total, _ = MDL.lm_loss(params, torch.as_tensor(toks),
                               torch.as_tensor(tgts), c,
                               frontend_embeds=torch.as_tensor(fe))
        total.backward()
        grads.append({n: q.grad.clone() for n, q in params.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=1e-6, atol=1e-7)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _grad_close(got, want, what):
    want = np.asarray(want, np.float32)
    _close(got, want, 1e-4, 1e-5 * float(np.abs(want).max()), what)


@pytest.mark.parametrize("causal,window,H,Hkv,Skv,chunk,masked", [
    (True, 0, 4, 4, 40, 16, False),    # causal, padded to 3 chunks
    (True, 8, 4, 2, 40, 16, False),    # sliding window, GQA
    (False, 0, 6, 2, 37, 16, True),    # bidirectional, padded and masked keys
    (False, 0, 4, 1, 24, 1024, False),  # one chunk (the chunk cut to Skv)
])
def test_flash_attention_gradient(causal, window, H, Hkv, Skv, chunk,
                                  masked):
    rng = np.random.default_rng(H + Skv)
    B, Sq, dh = 2, Skv if causal else 9, 8
    q, k, v = (_rand(rng, B, Sq, H, dh), _rand(rng, B, Skv, Hkv, dh),
               _rand(rng, B, Skv, Hkv, dh))
    w = _rand(rng, B, Sq, H, dh)
    valid = rng.random((B, Skv)) < 0.8 if masked else None
    kw = dict(causal=causal, window=window, chunk=chunk)

    def jloss(q, k, v):
        o = JL.chunked_attention(
            q, k, v, kv_valid=None if valid is None else jnp.asarray(valid),
            **kw)
        return jnp.sum(o * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    o = L.chunked_attention(
        tq, tk, tv, kv_valid=None if valid is None else torch.as_tensor(valid),
        **kw)
    _close(o.detach().numpy(), JL.chunked_attention(
        *map(jnp.asarray, (q, k, v)),
        kv_valid=None if valid is None else jnp.asarray(valid), **kw),
        1e-4, 1e-5, "o")
    (o * torch.as_tensor(w)).sum().backward()
    for name, t, ww in zip("qkv", (tq, tk, tv), want):
        _grad_close(t.grad.numpy(), ww, "d" + name)


def test_flash_attention_saves_no_score_matrix():
    """What autograd keeps for the backward: the inputs, the output and
    the log-sum-exp, not a (Sq, Skv) matrix of probabilities."""
    B, S, H, dh = 1, 64, 2, 8
    q, k, v = (torch.randn(B, S, H, dh, requires_grad=True) for _ in "qkv")
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        L.chunked_attention(q, k, v, causal=True, chunk=16)
    assert len(saved) == 6, saved  # q, k, v, the key mask, o, lse
    assert all(tuple(s[-2:]) != (S, S) for s in saved), saved


def test_cross_entropies_and_their_gradients():
    """``flash_cross_entropy`` (the recomputing backward), ``lm_loss_flash``
    and ``cross_entropy_chunked`` against the reference's, untied and
    tied, with padding targets (-1) and a vocabulary tail to mask."""
    rng = np.random.default_rng(11)
    for arch in ("mistral_nemo_12b", "mamba2_370m"):  # untied, tied
        cfg = configs.get_smoke_config(arch).replace(vocab_size=250)
        jcfg = ref_configs.get_smoke_config(arch).replace(vocab_size=250)
        params = MDL.init_model(cfg, seed=2, device="cpu")
        params.requires_grad_(True)
        jparams = jax_params(params)
        h = _rand(rng, 2, 37, cfg.d_model)
        tgt = rng.integers(-1, cfg.vocab_size, (2, 37), dtype=np.int32)
        for name, port, ref in (
                ("flash", L.lm_loss_flash, JL.lm_loss_flash),
                ("chunked", L.cross_entropy_chunked,
                 JL.cross_entropy_chunked)):
            def jloss(p, h):
                return ref(p, h, jnp.asarray(tgt), jcfg, chunk=16)

            jl, (jgp, jgh) = jax.value_and_grad(jloss, argnums=(0, 1))(
                jparams, jnp.asarray(h))
            th = torch.tensor(h, requires_grad=True)
            loss = port(params, th, torch.as_tensor(tgt), cfg, chunk=16)
            params.zero_grad()
            loss.backward()
            _close(loss.item(), float(jl), 1e-5, 1e-7, f"{arch} {name}")
            _grad_close(th.grad.numpy(), jgh, f"{arch} {name} dh")
            w = "embed" if cfg.tie_embeddings else "unembed"
            _grad_close(getattr(params, w).grad.numpy(), jgp[w],
                        f"{arch} {name} d{w}")


def test_mamba_mixer_gradient_with_padded_chunk():
    """The mixer at S = 40 with chunks of 16 (the last one right-padded
    with 8 zero-dt rows): its output and every parameter's and the
    input's gradient against ``jax.grad`` of the reference's."""
    cfg = configs.get_smoke_config("mamba2_370m")
    jcfg = ref_configs.get_smoke_config("mamba2_370m")
    rng = np.random.default_rng(12)
    model = MDL.init_model(cfg, seed=4, device="cpu")
    with torch.no_grad():  # away from the init's zeros and ones
        for name, p in model.layers[0]["pos0"].mamba.named_parameters():
            p.add_(torch.as_tensor(0.2 * rng.standard_normal(tuple(p.shape)),
                                   dtype=p.dtype))
    mixer = model.layers[0]["pos0"].mamba
    mixer.requires_grad_(True)
    jp = {n: jnp.asarray(p.detach().numpy()) for n, p in
          mixer.named_parameters()}
    x, w = _rand(rng, 2, 40, cfg.d_model), _rand(rng, 2, 40, cfg.d_model)

    def jloss(p, x):
        return jnp.sum(JMB.mamba_forward(p, x, jcfg) * w)

    jl, (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jp, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    out = M.mamba_forward(mixer, tx, cfg)
    loss = (out * torch.as_tensor(w)).sum()
    loss.backward()
    _close(loss.item(), float(jl), 1e-4, 1e-5, "loss")
    _grad_close(tx.grad.numpy(), jgx, "dx")
    for name, p in mixer.named_parameters():
        _grad_close(p.grad.numpy(), jgp[name], "d" + name)


def test_launcher_resume_equals_uninterrupted(tmp_path, capsys):
    """6 steps straight against 4, a checkpoint, and 2 more resumed from
    it (the data stream resumes at the checkpoint's step)."""
    base = ["--arch", "internvl2_1b", "--smoke", "--device", "cpu",
            "--global-batch", "2", "--seq-len", "12", "--log-every", "1"]
    full, part = tmp_path / "full", tmp_path / "part"
    assert TRAIN.main(base + ["--steps", "6", "--ckpt-dir", str(full),
                              "--ckpt-every", "100"]) == 0
    assert TRAIN.main(base + ["--steps", "4", "--ckpt-dir", str(part),
                              "--ckpt-every", "2"]) == 0
    out = capsys.readouterr().out
    assert TRAIN.main(base + ["--steps", "6", "--ckpt-dir", str(part),
                              "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "step     5" in out
    a = np.load(full / "ckpt_0000000006.npz")
    b = np.load(part / "ckpt_0000000006.npz")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        if k != "__meta__":
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_whisper_fails_in_both_train_launchers(tmp_path, monkeypatch):
    """C.7: neither launcher gives the step frame embeddings, so
    ``encode(params, None, cfg)`` fails on ``None``'s missing cast, in
    the JAX package (``astype``) and in the port (``to``)."""
    from repro.launch import train as JTRAIN

    args = ["--arch", "whisper_medium", "--smoke", "--steps", "1",
            "--global-batch", "2", "--seq-len", "8"]
    with pytest.raises(AttributeError, match="'NoneType' .* 'to'"):
        TRAIN.main(args + ["--device", "cpu"])
    monkeypatch.setattr(sys, "argv", ["train"] + args)
    with pytest.raises(AttributeError, match="'NoneType' .* 'astype'"):
        JTRAIN.main()
    # the step itself trains whisper when given frames
    cfg = configs.get_smoke_config("whisper_medium")
    toks, tgts, fe = _batch(cfg, 4)
    opt = adamw.OptConfig(**OPT)
    params, state = init_state(cfg, opt, seed=0, device="cpu")
    _, _, m = make_train_step(cfg, opt)(params, state, torch.as_tensor(toks),
                                        torch.as_tensor(tgts),
                                        torch.as_tensor(fe))
    assert np.isfinite(float(m["loss"]))


def test_decay_mask_and_schedule_match_the_reference():
    from repro.optim.adamw import _decayable

    params = MDL.init_model(configs.get_smoke_config("jamba_v01_52b"),
                            device="cpu")
    for name, _ in params.named_parameters():
        leaf = name.rsplit(".", 1)[-1]

        class Key:
            key = leaf

        assert adamw.decayable(name) == _decayable((Key,)), name
    cfg, jcfg = adamw.OptConfig(**OPT), JADAM.OptConfig(**OPT)
    for step in (0, 1, 2, 5, 10, 12):
        _close(float(adamw.schedule(cfg, torch.tensor(step))),
               float(JADAM.schedule(jcfg, jnp.asarray(step))), 1e-6, 0,
               f"lr at {step}")
