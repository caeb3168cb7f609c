"""The port's checkpoint manager: the reference's five properties, and
checkpoints that restore across the two packages.

The files keep the JAX package's format and keys (``|``-joined tree paths,
each layer leaf stacked on its ``n_periods`` axis), so a checkpoint of
``(params, opt_state)`` written by ``repro.checkpoint.manager`` restores
into the port's model and optimizer state, and the reverse, bit for bit.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as JCK
from repro.optim import adamw as JADAM
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as MDL
from repro_torch.models.convert import leaf_of
from repro_torch.optim import adamw
from repro_torch.train.train_step import init_state, make_train_step
from torch_parity import jax_params


def _state(arch="internvl2_1b", seed=0, moment_dtype="float32"):
    """A model and an optimizer state with nonzero moments (one step)."""
    cfg = get_smoke_config(arch)
    opt_cfg = adamw.OptConfig(lr=1e-3, total_steps=8, warmup_steps=1,
                              moment_dtype=moment_dtype)
    params, opt = init_state(cfg, opt_cfg, seed=seed, device="cpu")
    toks = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (2, 12), dtype=np.int32))
    params, opt, _ = make_train_step(cfg, opt_cfg)(params, opt, toks,
                                                   toks.roll(-1, 1))
    return cfg, params, opt


def _fresh(cfg, moment_dtype="float32", seed=9):
    return init_state(cfg, adamw.OptConfig(moment_dtype=moment_dtype),
                      seed=seed, device="cpu")


def _named(state):
    params, opt = state
    out = {"step": opt.step}
    out.update({"p " + n: p for n, p in params.named_parameters()})
    out.update({"m " + n: t for n, t in opt.m.items()})
    out.update({"v " + n: t for n, t in opt.v.items()})
    return out


def _equal(a, b):
    na, nb = _named(a), _named(b)
    assert sorted(na) == sorted(nb)
    for k, t in na.items():
        assert t.dtype == nb[k].dtype and torch.equal(t, nb[k]), k


@pytest.fixture
def state():
    return _state()


def test_save_restore_bit_equal(tmp_path, state):
    cfg, params, opt = state
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(7, (params, opt))
    restored, meta = mgr.restore(7, _fresh(cfg))
    assert meta["step"] == 7
    _equal((params, opt), restored)


def test_bfloat16_moments_and_plain_trees(tmp_path):
    """bfloat16 leaves are stored as float32 and cast back; dicts, lists
    and arrays keep their structure."""
    cfg, params, opt = _state(moment_dtype="bfloat16")
    assert opt.m["embed"].dtype == torch.bfloat16
    mgr = CheckpointManager(str(tmp_path))
    extra = {"a": [np.arange(3), torch.ones(2, dtype=torch.bfloat16)]}
    mgr.save(1, (params, opt, extra))
    (p, o, e), _ = mgr.restore(1, _fresh(cfg, "bfloat16") + (extra,))
    _equal((params, opt), (p, o))
    np.testing.assert_array_equal(e["a"][0], np.arange(3))
    assert e["a"][1].dtype == torch.bfloat16 and bool((e["a"][1] == 1).all())
    with np.load(tmp_path / "ckpt_0000000001.npz") as z:
        assert z["1|m|embed"].dtype == np.float32


def test_async_save_and_latest(tmp_path, state):
    cfg, params, opt = state
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(3, (params, opt))
    mgr.save_async(9, (params, opt))
    assert mgr.latest_step() == 9
    restored, _ = mgr.restore(9, _fresh(cfg))
    _equal((params, opt), restored)


def test_gc_keeps_newest(tmp_path, state):
    _, params, opt = state
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, (params, opt))
    ckpts = sorted(f for f in os.listdir(tmp_path) if f.startswith("ckpt_"))
    assert len(ckpts) == 2
    assert mgr.latest_step() == 4


def test_crash_mid_write_leaves_no_corrupt_latest(tmp_path, state):
    """Atomicity: a stray tmp file never shadows a committed checkpoint."""
    cfg, params, opt = state
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, (params, opt))
    with open(os.path.join(tmp_path, "tmp.6.npz"), "wb") as f:
        f.write(b"garbage")
    assert mgr.latest_step() == 5
    restored, _ = mgr.restore(5, _fresh(cfg))
    _equal((params, opt), restored)


def test_restart_loop(tmp_path):
    """Train 2 steps, 'crash', resume from the checkpoint and train 2
    more: the state equals 4 steps straight, bit for bit."""
    cfg = get_smoke_config("internvl2_1b").replace(num_patches=0)
    opt_cfg = adamw.OptConfig(lr=1e-3, total_steps=8, warmup_steps=1)
    step = make_train_step(cfg, opt_cfg)
    rng = np.random.default_rng(2)
    batches = [torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 16),
                                            dtype=np.int32))
               for _ in range(4)]
    p, o = init_state(cfg, opt_cfg, seed=1, device="cpu")
    for t in batches:
        p, o, _ = step(p, o, t, t.roll(-1, 1))
    ref = (p, o)
    mgr = CheckpointManager(str(tmp_path))
    p, o = init_state(cfg, opt_cfg, seed=1, device="cpu")
    for t in batches[:2]:
        p, o, _ = step(p, o, t, t.roll(-1, 1))
    mgr.save(2, (p, o))
    del p, o  # "crash"
    (p, o), meta = mgr.restore(2, init_state(cfg, opt_cfg, seed=7,
                                             device="cpu"))
    for t in batches[meta["step"]:]:
        p, o, _ = step(p, o, t, t.roll(-1, 1))
    _equal(ref, (p, o))


def _jax_state(params, opt):
    """The port's state as the JAX package's (params, OptState) tree."""
    def moments(d):
        return jax_params(_Named(d))

    return jax_params(params), JADAM.OptState(
        step=jnp.asarray(int(opt.step), jnp.int32), m=moments(opt.m),
        v=moments(opt.v))


class _Named:
    def __init__(self, d):
        self.d = d

    def named_parameters(self):
        return self.d.items()


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    cfg, params, opt = _state("mixtral_8x22b", seed=3)
    jstate = _jax_state(params, opt)
    JCK.CheckpointManager(str(tmp_path)).save(4, jstate, meta={"by": "jax"})
    restored, meta = CheckpointManager(str(tmp_path)).restore(4, _fresh(cfg))
    assert meta == {"by": "jax", "step": 4}
    _equal((params, opt), restored)


def test_port_checkpoint_restores_into_jax(tmp_path):
    cfg, params, opt = _state("jamba_v01_52b", seed=4)
    CheckpointManager(str(tmp_path)).save(6, (params, opt))
    template = _jax_state(*_fresh(cfg))
    (jp, jo), meta = JCK.CheckpointManager(str(tmp_path)).restore(6, template)
    assert meta["step"] == 6 and int(jo.step) == 1
    for name, p in params.named_parameters():
        np.testing.assert_array_equal(np.asarray(leaf_of(jp, name)),
                                      p.detach().numpy(), err_msg=name)
        np.testing.assert_array_equal(np.asarray(leaf_of(jo.m, name)),
                                      opt.m[name].numpy(), err_msg=name)
        np.testing.assert_array_equal(np.asarray(leaf_of(jo.v, name)),
                                      opt.v[name].numpy(), err_msg=name)
    with np.load(tmp_path / "ckpt_0000000006.npz") as z:
        assert sorted(k for k in z.files if k != "__meta__") == sorted(
            JCK._flatten(template))
