"""The port's dry run on a fake process group of 4 ranks (no device memory).

* every architecture's smoke config (cut to one period), in each
  applicable kind of step
  (train, prefill, decode, long-context decode), gives a record with
  exactly the key set of the reference's ``run_cell`` (read from the
  reference's source: importing its ``launch/dryrun.py`` would force 512
  XLA devices on this process), ``analysis`` with the reference's keys;
* on a (1, 1) mesh a step's FLOPs a device equal those of the same step
  on unsharded ``meta`` tensors;
* on (2, 2), a column- then row-parallel MLP's matrix FLOPs a device are
  a quarter of the global FLOPs, and its all-reduce's wire bytes follow
  the ring factor;
* the 1-/2-period extrapolation equals the full-depth count, encoder
  included;
* ``from_dryrun_record`` of both packages gives the same DSL from a record
  the port wrote, and the CLI writes ``<arch>__<shape>__<mesh>.json``.

The cells run at small shapes (``SHAPES`` cut for the module): the key
sets and the counts' structure do not depend on the sizes, and the
reference's shapes take minutes a cell for the SSM configs on this CPU.
"""
import ast
import json
import pathlib

import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.core import hlo2skeleton as REF_HLO
from repro_torch.configs import (
    ARCH_IDS, SHAPES, cell_applicable, get_smoke_config)
from repro_torch.core import hlo2skeleton as HLO
from repro_torch.launch import dryrun as D
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as MDL
from repro_torch.optim import adamw
from repro_torch.train import sharding as SH
from repro_torch.train.train_step import make_train_step

REF_DRYRUN = (pathlib.Path(__file__).resolve().parents[1] / "src" / "repro"
              / "launch" / "dryrun.py")
SMALL = {
    "train_4k": dict(seq_len=64, global_batch=8, kind="train"),
    "prefill_32k": dict(seq_len=64, global_batch=4, kind="prefill"),
    "decode_32k": dict(seq_len=64, global_batch=8, kind="decode"),
    "long_500k": dict(seq_len=128, global_batch=1, kind="decode"),
}


@pytest.fixture(scope="module")
def world():
    import torch.distributed as dist

    assert not dist.is_initialized()
    D.init_fake_world(4)
    saved = dict(SHAPES)
    SHAPES.update(SMALL)
    try:
        yield
    finally:
        SHAPES.clear()
        SHAPES.update(saved)
        dist.destroy_process_group()


def _reference_keys():
    """The record's keys and the analysis dict's, from the reference's
    ``lower_cell``'s meta dict, ``run_cell``'s additions and its
    ``dict(meta, ...)``, and ``analysis_terms``' ``out``."""
    tree = ast.parse(REF_DRYRUN.read_text())
    fns = {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}
    keys = set()
    for node in ast.walk(fns["lower_cell"]):
        if isinstance(node, ast.Assign) and isinstance(
                node.targets[0], ast.Name) and node.targets[0].id == "meta":
            keys |= {k.arg for k in node.value.keywords}
    for node in ast.walk(fns["run_cell"]):
        if isinstance(node, ast.Subscript) and isinstance(
                node.value, ast.Name) and node.value.id == "meta" and \
                isinstance(node.ctx, ast.Store):
            keys.add(node.slice.value)
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == \
                "dict" and node.args and getattr(node.args[0], "id", "") == \
                "meta":
            keys |= {k.arg for k in node.keywords}
    ana = set()
    for node in ast.walk(fns["analysis_terms"]):
        if isinstance(node, ast.Assign) and isinstance(
                node.targets[0], ast.Name) and node.targets[0].id == "out":
            ana |= {k.arg for k in node.value.keywords}
        if isinstance(node, ast.Subscript) and getattr(
                node.value, "id", "") == "out" and isinstance(
                node.ctx, ast.Store):
            ana.add(node.slice.value)
    return keys, ana


def test_reference_key_set_is_read():
    keys, ana = _reference_keys()
    assert {"arch", "accum", "params", "remat", "mesh", "lower_s",
            "flops_per_device", "useful_flops_ratio"} <= keys
    assert len(keys) == 28
    assert ana == {"flops", "bytes", "wire", "per_period", "base",
                   "collective_kinds", "per_enc_layer"}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_record_has_the_reference_keys(world, arch):
    keys, ana_keys = _reference_keys()
    cfg = get_smoke_config(arch)
    # one period of the smoke config (two for the encoder-decoder, whose
    # encoder the analysis counts per layer): the keys do not depend on
    # depth, and each period costs this CPU a second of DTensor dispatch
    cfg = cfg.replace(n_layers=len(cfg.period)) if not cfg.enc_layers else cfg
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    kinds = set()
    for shape in SHAPES:
        if not cell_applicable(cfg, shape):
            continue
        analyze = shape == "train_4k" and arch in ("mistral_nemo_12b",
                                                   "whisper_medium")
        rec = D.run_cell(arch, shape, "single", mesh=mesh, cfg=cfg,
                         analyze=analyze)
        assert set(rec) == keys, (shape, set(rec) ^ keys)
        kinds.add(rec["kind"])
        assert rec["flops_per_device"] > 0 and rec["n_devices"] == 4
        assert set(rec["memory"]) == {"argument_size_in_bytes",
                                      "output_size_in_bytes",
                                      "temp_size_in_bytes"}
        assert set(rec["collectives"]) == {"wire_bytes_per_device",
                                           "by_kind_bytes", "by_kind_count"}
        json.dumps(rec)
        if analyze:
            want = ana_keys - ({"per_enc_layer"} if cfg.enc_layers <= 1
                               else set())
            assert set(rec["analysis"]) == want
        else:
            assert rec["analysis"] is None
            assert rec["flops_per_device"] == rec["raw_cost_flops"]
    assert kinds == {"train", "prefill", "decode"}


def _unsharded_flops(cfg):
    """FLOPs of the smoke train step on plain meta tensors (no mesh)."""
    shp = SHAPES["train_4k"]
    params = MDL.init_model(cfg, device="meta")
    params.requires_grad_(True)
    opt_cfg = adamw.OptConfig(moment_dtype=cfg.param_dtype)
    opt = adamw.init(params, opt_cfg)
    toks = torch.empty((shp["global_batch"], shp["seq_len"]),
                       dtype=torch.int32, device="meta")
    with D.DeviceCounter() as ctr:
        make_train_step(cfg, opt_cfg)(params, opt, toks, toks)
    assert not ctr.comms
    return ctr.flops


@pytest.mark.parametrize("arch", ["mistral_nemo_12b", "mamba2_370m",
                                  "mixtral_8x22b"])
def test_one_by_one_mesh_counts_the_unsharded_flops(world, arch):
    cfg = get_smoke_config(arch)
    mesh = make_mesh((1, 1), ("data", "model"), "cpu")
    rec = D.run_cell(arch, "train_4k", "single", mesh=mesh, cfg=cfg,
                     analyze=False, accum=1)
    # the dry run's default remat recomputes each period in the backward
    assert rec["raw_cost_flops"] == _unsharded_flops(
        cfg.replace(remat=True)) > 0
    assert rec["collectives"]["wire_bytes_per_device"] == 0


def test_mlp_flops_are_a_quarter_and_allreduce_follows_the_ring(world):
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    B, S, d, ff = 8, 16, 32, 64
    x = SH.distribute(torch.empty((B, S, d), device="meta"), mesh,
                      (Shard(0), Replicate()))
    w1 = SH.distribute(torch.empty((d, ff), device="meta"), mesh,
                       (Replicate(), Shard(1)))  # column-parallel
    w2 = SH.distribute(torch.empty((ff, d), device="meta"), mesh,
                       (Replicate(), Shard(0)))  # row-parallel
    with D.DeviceCounter() as ctr:
        with SH.mesh_axes(("data",), "model", model_size=2):
            y = SH.reduce_partial(torch.relu(x @ w1) @ w2)
    assert tuple(y.placements) == (Shard(0), Replicate())
    global_flops = 2 * B * S * d * ff * 2
    assert ctr.flops * 4 == global_flops
    assert ctr.comms == [("all-reduce", (B // 2) * S * d * 4, 2)]
    stats = RL.collective_stats_from_comms(ctr.comms, 4)
    out_bytes = (B // 2) * S * d * 4
    assert stats["wire_bytes_per_device"] == 2 * out_bytes * (2 - 1) / 2


@pytest.mark.parametrize("arch", ["mistral_nemo_12b", "whisper_medium",
                                  "mamba2_370m"])
def test_depth_extrapolation_equals_the_full_depth_count(world, arch):
    cfg = get_smoke_config(arch)
    plen = len(cfg.period)
    cfg = cfg.replace(n_layers=3 * plen,
                      enc_layers=3 if cfg.enc_layers else 0)
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    rec = D.run_cell(arch, "train_4k", "single", mesh=mesh, cfg=cfg,
                     accum=1)
    full = rec["raw_cost_flops"]
    ana = rec["analysis"]
    assert ana["flops"] == full == rec["flops_per_device"]
    assert ana["per_period"]["flops"] > 0
    assert ("per_enc_layer" in ana) == bool(cfg.enc_layers)
    # bytes and wire bytes extrapolate the same way
    run, _, _, _ = D.lower_cell(arch, "train_4k", mesh, accum=1,
                                cfg_override=cfg.replace(remat=True))
    _, ctr, coll = D.trace_cell(run, 4)
    assert ana["bytes"] == ctr.bytes
    assert ana["wire"] == coll["wire_bytes_per_device"]


def test_cli_record_feeds_both_hlo_skeletons(world, tmp_path, monkeypatch):
    """The CLI's record (a smoke config in place of the full one) through
    both packages' ``from_dryrun_record``: the same DSL."""
    monkeypatch.setattr(D, "get_config", get_smoke_config)
    monkeypatch.setattr(D, "init_fake_world", lambda n: None)
    monkeypatch.setattr(
        D, "make_production_mesh",
        lambda multi_pod=False, device_type=None: make_mesh(
            (2, 2), ("data", "model"), device_type))
    out = tmp_path / "results" / "dryrun"
    assert D.main(["--arch", "mistral_nemo_12b", "--shape", "train_4k",
                   "--mesh", "single", "--out", str(out)]) == 0
    path = out / "mistral_nemo_12b__train_4k__single.json"
    rec = json.loads(path.read_text())
    assert rec["arch"] == "mistral_nemo_12b" and rec["mesh"] == "single"
    got = HLO.from_dryrun_record(str(path), steps=3)
    assert got == REF_HLO.from_dryrun_record(str(path), steps=3)
    assert "allreduce" in got
    # a cell that fails writes its traceback beside
    assert D.main(["--arch", "mistral_nemo_12b", "--shape", "nope",
                   "--out", str(out)]) == 1
    assert (out / "mistral_nemo_12b__nope__single.json.err").exists()
