"""The port's sharding rules, mesh and roofline against the JAX package's.

* every parameter's spec (with ``fsdp=("data",)`` and without) equals the
  reference's ``PartitionSpec`` of the same leaf, less its stacked lead,
  for every architecture's smoke config; the same for the decode caches'
  specs, the batch specs and the divisibility guard on the reference's
  ``FakeMesh`` cases;
* ``cell_plan`` and the dry run's input shapes and dtypes equal the
  reference's for every applicable (arch × shape), and so do the meta
  model's and optimizer state's;
* ``collective_stats`` on HLO text, ``roofline_terms`` (explicit peaks)
  and ``model_flops`` equal the reference's exactly; the ring factors of
  ``collective_stats_from_comms`` are the HLO path's;
* the activation constraints return their argument itself outside
  ``mesh_axes``;
* ``to_placements`` shards a dim on ("pod", "data") pod-major, and the
  H100's rates replace the TPU's.

Meshes here are over a fake process group of 8 ranks (no communication),
set up for the module and torn down after it.
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.configs import SHAPES as REF_SHAPES
from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke
from repro.launch import roofline as REF_RL
from repro.launch import specs as REF_SPECS
from repro.models import model as REF_MDL
from repro.train import sharding as REF_SH
from repro_torch.configs import (
    ARCH_IDS, SHAPES, cell_applicable, get_config, get_smoke_config)
from repro_torch.launch import mesh as MESH
from repro_torch.launch import roofline as RL
from repro_torch.launch import specs as SPECS
from repro_torch.models import model as MDL
from repro_torch.models.convert import jax_path
from repro_torch.train import sharding as SH


@pytest.fixture(scope="module")
def fake_world():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    yield
    dist.destroy_process_group()


def _ref_params(cfg):
    return jax.eval_shape(lambda k: REF_MDL.init_model(k, cfg),
                          jax.random.PRNGKey(0))


def _ref_leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("fsdp", [("data",), None])
def test_param_specs_equal_reference(arch, fsdp):
    ref_params = _ref_params(ref_smoke(arch))
    ref_specs = REF_SH.param_specs(ref_params, model="model", fsdp=fsdp)
    model = MDL.init_model(get_smoke_config(arch), device="meta")
    specs = SH.param_specs(model, model="model", fsdp=fsdp)
    assert set(specs) == {n for n, _ in model.named_parameters()}
    for name, spec in specs.items():
        path, idx = jax_path(name)
        want = _ref_leaf(ref_specs, path)
        if idx is not None:  # stacked: the reference's lead is None
            assert tuple(want)[0] is None, (name, want)
            want = P(*tuple(want)[1:])
        assert P(*spec) == want, (name, spec, want)


def _ref_state(cfg, shard_batch=True):
    return jax.eval_shape(functools.partial(
        REF_MDL.init_decode_state, cfg, 2, 16, dtype=jnp.bfloat16,
        with_xkv=bool(cfg.enc_layers)))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_state_specs_equal_reference(arch):
    """The meta model and optimizer state against the reference's
    ``ShapeDtypeStruct`` trees (smoke configs), leaf by leaf."""
    ref_p, ref_o = REF_SPECS.model_state_specs(ref_smoke(arch))
    params, opt = SPECS.model_state_specs(get_smoke_config(arch))

    def same(t, want, idx):
        shape = tuple(want.shape)[1:] if idx is not None else tuple(
            want.shape)
        return (t.device.type == "meta" and tuple(t.shape) == shape
                and str(t.dtype).split(".")[-1] == str(want.dtype))

    for name, t in params.named_parameters():
        path, idx = jax_path(name)
        assert same(t, _ref_leaf(ref_p, path), idx), name
        for which in ("m", "v"):
            assert same(getattr(opt, which)[name],
                        _ref_leaf(getattr(ref_o, which), path), idx), name
    assert opt.step.shape == () and opt.step.dtype == torch.int32


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("shard_seq", [False, True])
def test_cache_specs_equal_reference(arch, shard_seq):
    b = None if shard_seq else ("data",)
    ref_cfg, cfg = ref_smoke(arch), get_smoke_config(arch)
    ref = REF_SH.cache_specs(_ref_state(ref_cfg), batch_axes=b,
                             model="model", shard_seq=shard_seq)
    state = MDL.init_decode_state(cfg, 2, 16, device="meta",
                                  with_xkv=bool(cfg.enc_layers))
    got = SH.cache_specs(state, batch_axes=b, model="model",
                         shard_seq=shard_seq)
    n = 0
    for per in got["layers"]:
        for pos, cache in per.items():
            for name, spec in cache.items():
                want = ref["layers"][pos][name]
                assert tuple(want)[0] is None
                assert P(*spec) == P(*tuple(want)[1:]), (pos, name)
                n += 1
    if cfg.enc_layers:
        for per in got["xkv"]:
            for pos, kv in per.items():
                for j, spec in enumerate(kv):
                    want = ref["xkv"][pos][j]
                    assert P(*spec) == P(*tuple(want)[1:])
                    n += 1
    assert n >= cfg.n_periods * len(cfg.period)


@pytest.mark.parametrize("axes", [("data",), ("pod", "data")])
def test_batch_specs_equal_reference(axes):
    ref = REF_SH.batch_specs(axes)
    got = SH.batch_specs(axes)
    assert set(got) == set(ref)
    for k in got:
        assert P(*got[k]) == ref[k]


def test_divisibility_guard_equals_reference():
    class FakeMesh:
        shape = {"data": 16, "model": 16, "pod": 2}

    cases = [(P("model", "data"), (14, 64)), (P("model", "data"), (32, 64)),
             (P(("pod", "data"), None), (64, 64)),
             (P(("pod", "data"), "model"), (16, 48)), (P(None, None), (3, 5))]
    for spec, shape in cases:
        want = REF_SPECS._fit_spec(spec, jax.ShapeDtypeStruct(shape,
                                                               jnp.float32),
                                   FakeMesh())
        got = SPECS._fit_spec(tuple(spec), torch.empty(shape, device="meta"),
                              FakeMesh())
        assert P(*got) == want, (spec, shape, got, want)


def _cells():
    return [(a, s) for a in ARCH_IDS for s in SHAPES
            if cell_applicable(get_config(a), s)]


def test_shapes_and_applicable_cells_equal_reference():
    assert SHAPES == REF_SHAPES
    from repro.configs import cell_applicable as ref_applicable

    for a in ARCH_IDS:
        for s in SHAPES:
            assert cell_applicable(get_config(a), s) == ref_applicable(
                ref_get_config(a), s)


@pytest.mark.parametrize("arch,shape", _cells())
def test_cell_plan_and_input_specs_equal_reference(arch, shape):
    cfg, ref_cfg = get_config(arch), ref_get_config(arch)
    for n_dp in (1, 16, 32):
        assert SPECS.cell_plan(cfg, shape, n_dp) == REF_SPECS.cell_plan(
            ref_cfg, shape, n_dp)
    got = SPECS.input_specs(arch, shape, cfg)
    want = REF_SPECS.input_specs(arch, shape, ref_cfg)
    assert got.keys() == want.keys() and got["kind"] == want["kind"]
    for k in got:
        if k in ("kind", "state"):
            continue
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k
    if "state" in got:
        n_periods = cfg.n_periods
        assert len(got["state"]["layers"]) == n_periods
        for per in got["state"]["layers"]:
            for pos, cache in per.items():
                for name, t in cache.items():
                    w = want["state"]["layers"][pos][name]
                    assert t.device.type == "meta"
                    assert (n_periods,) + tuple(t.shape) == tuple(w.shape)
                    assert str(t.dtype).split(".")[-1] == str(w.dtype)
        if cfg.enc_layers:
            for per in got["state"]["xkv"]:
                for pos, kv in per.items():
                    for j, t in enumerate(kv):
                        w = want["state"]["xkv"][pos][j]
                        assert (n_periods,) + tuple(t.shape) == w.shape


HLO = """
  %all-gather.1 = bf16[2048,5120] all-gather(bf16[128,5120] %p), replica_groups={{0,1,2,3,4,5,6,7,8,9,10,11,12,13,14,15}}, dimensions={0}
  %all-reduce-start.2 = f32[4096] all-reduce-start(f32[4096] %x), replica_groups=[16,16]<=[256]
  %all-reduce-done.2 = f32[4096] all-reduce-done(f32[4096] %all-reduce-start.2)
  %reduce-scatter.3 = bf16[64,5120] reduce-scatter(bf16[1024,5120] %g), replica_groups={{0,16,32,48}}, dimensions={0}
  %all-to-all.4 = (bf16[8,128], bf16[8,128]) all-to-all(bf16[8,128] %a, bf16[8,128] %b), replica_groups={{0,1}}
  ROOT %collective-permute.5 = s32[100] collective-permute(s32[100] %c), source_target_pairs={{0,1},{1,0}}
  %add.6 = f32[4096] add(f32[4096] %y, f32[4096] %z)
  %all-reduce.7 = (f32[16], bf16[32]) all-reduce(f32[16] %u, bf16[32] %v), to_apply=%sum
"""


@pytest.mark.parametrize("devices", [256, 512])
def test_collective_stats_equal_reference(devices):
    assert RL.collective_stats(HLO, devices) == REF_RL.collective_stats(
        HLO, devices)


def test_collective_stats_from_comms_apply_the_hlo_ring_factors():
    stats = REF_RL.collective_stats(HLO, 256)
    records = [("all-gather", 2048 * 5120 * 2, 16), ("all-reduce", 4096 * 4, 16),
               ("reduce-scatter", 64 * 5120 * 2, 4),
               ("all-to-all", 2 * 8 * 128 * 2, 2),
               ("collective-permute", 400, 256), ("all-reduce", 16 * 4 + 64, 0)]
    got = RL.collective_stats_from_comms(records, 256)
    assert got == stats
    assert set(got) == {"wire_bytes_per_device", "by_kind_bytes",
                        "by_kind_count"}
    with pytest.raises(ValueError, match="unknown collective kind"):
        RL.collective_stats_from_comms([("broadcast", 8, 2)], 2)


def test_roofline_terms_and_model_flops_equal_reference():
    peaks = dict(peak_flops=123e12, hbm_bw=2e12, ici_bw=100e9)
    for f, b, w in ((1e15, 1e11, 1e9), (1e12, 1e13, 1e9), (1e12, 1e9, 1e13),
                    (0.0, 0.0, 0.0)):
        kw = dict(flops_per_device=f, bytes_per_device=b,
                  wire_bytes_per_device=w)
        assert RL.roofline_terms(**kw, **peaks) == REF_RL.roofline_terms(
            **kw, **peaks)
    for a in ARCH_IDS:
        for kind in ("train", "serve"):
            assert RL.model_flops(get_config(a), 4096, kind) == \
                REF_RL.model_flops(ref_get_config(a), 4096, kind)


def test_rates_are_the_h100s():
    assert (MESH.PEAK_FLOPS_BF16, MESH.PEAK_FLOPS_FP32, MESH.HBM_BW,
            MESH.NVLINK_BW) == (989e12, 67e12, 3.35e12, 450e9)
    t = RL.roofline_terms(flops_per_device=989e12, bytes_per_device=3.35e12,
                          wire_bytes_per_device=450e9)
    assert t["compute_s"] == t["memory_s"] == t["collective_s"] == 1.0
    import pathlib

    for rel in ("launch/mesh.py", "launch/roofline.py", "launch/dryrun.py",
                "launch/specs.py", "train/sharding.py"):
        text = (pathlib.Path(MESH.__file__).parents[1] / rel).read_text()
        for tpu in (r"197e12", r"819e9", r"(?<![\d.])50e9", r"v5e"):
            assert not re.search(tpu, text), (rel, tpu)


def test_constraints_are_identities_outside_mesh_axes(fake_world):
    x = torch.ones((2, 4, 8))
    q = torch.ones((2, 4, 2, 4))
    assert SH.constrain_acts(x) is x
    assert SH.constrain_attn_q(q) is q
    assert SH.constrain_attn_out(q) is q
    assert SH.constrain(q, ("batch", None, "model", None)) is q
    mesh = MESH.make_mesh((2, 2), ("data", "model"), "cpu")
    d = SH.distribute(q, mesh, (Replicate(), Shard(2)))
    assert SH.constrain_acts(d) is d and SH.constrain_attn_q(d) is d
    assert SH.constrain(d, ("batch", None, None, None)) is d
    with SH.mesh_axes(("data",), "model", model_size=2):
        c = SH.constrain_attn_q(d)
        assert c is not d and tuple(c.placements) == (Shard(0), Shard(2))
        assert SH.constrain_acts(x) is x  # a plain tensor stays as it is
    assert not SH.active()


def test_to_placements_shards_pod_major(fake_world):
    mesh = MESH.make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    pl = SH.to_placements((("pod", "data"), "model"), mesh)
    assert pl == (Shard(0), Shard(0), Shard(1))
    assert SH.to_placements((None, ("data",)), mesh) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        SH.to_placements((("data", "pod"),), mesh)
    with pytest.raises(ValueError, match="used twice"):
        SH.to_placements(("data", "data"), mesh)
    # rank 0 = (pod 0, data 0): the first quarter of the rows, as JAX's
    # P(("pod", "data")) gives device (0, 0); the order of the other
    # ranks' blocks is held on a real mesh in tests/test_torch_mesh_train.py
    t = SH.distribute(torch.arange(16.0).reshape(8, 2), mesh, pl)
    np.testing.assert_array_equal(t.to_local().numpy(),
                                  [[0.0], [2.0]])


def test_production_mesh_needs_its_ranks(fake_world):
    with pytest.raises(RuntimeError, match="needs 256 ranks"):
        MESH.make_production_mesh(device_type="cpu")
    smoke = MESH.make_smoke_mesh("cpu")
    assert smoke.mesh_dim_names == ("data", "model")
    assert tuple(smoke.shape) == (1, 1)
    assert MESH.batch_axes_of(smoke) == ("data",)
    assert MESH.model_axis_of(smoke) == "model"
    m = MESH.make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")
    assert MESH.batch_axes_of(m) == ("pod", "data")
