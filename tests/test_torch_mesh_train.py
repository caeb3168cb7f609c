"""The port's sharded training on a mesh of four CPU processes (gloo).

One job of four processes, spawned once for the module, on a (2, 2)
("data", "model") mesh set up with a ``FileStore`` under a temporary
directory (no network):

* one train step of the ``mistral_nemo_12b`` and ``mamba2_370m`` smoke
  configs, parameters and moments placed by ``cell_shardings`` and the
  batch's rows by ``device_batch``, against the same step in one process
  without a mesh: the loss and every updated parameter within rtol 1e-5,
  atol 1e-6 (float32; the mesh's all-reduces add in another order). The
  optimizer's eps is 1e-6, as in ``tests/test_torch_train.py``: Adam's
  first step moves an element by lr · g / (|g| + eps), so at 1e-8 an
  element whose gradient sums to about 0 moves by ±lr on the sign of its
  rounding;
* a checkpoint saved on the (2, 2) mesh restores on a (4, 1) mesh and in
  one process (this one) equal to the saved global arrays, exactly;
* each rank's rows of ``device_batch`` are the same rows of
  ``host_batch``, exactly, on both meshes;
* the ``local_map`` pieces in layouts the two steps do not take
  (attention reading a whole KV head, context-parallel attention, the
  MoE layer) equal the same functions on whole tensors, forward and
  gradients, within the same tolerance.

Each rank writes what it found to a JSON file; the tests read them.
"""
import json
import multiprocessing as mp
import os

import numpy as np
import pytest
import torch

WORLD = 4
ARCHS = ("mistral_nemo_12b", "mamba2_370m")
OPT = dict(lr=1e-3, total_steps=10, warmup_steps=2, eps=1e-6)
GLOBAL_BATCH, SEQ = 4, 32
RTOL, ATOL = 1e-5, 1e-6


def _rel_excess(a, b):
    """max(|a - b| - (ATOL + RTOL |b|)): <= 0 when within tolerance."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) - (ATOL + RTOL * np.abs(b))))


def _worker(rank, tmp):
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import DataConfig, device_batch, host_batch
    from repro_torch.launch.mesh import batch_axes_of, make_mesh
    from repro_torch.launch.specs import cell_shardings
    from repro_torch.optim import adamw
    from repro_torch.train import sharding as SH
    from repro_torch.train.train_step import init_state, make_train_step

    store = dist.FileStore(os.path.join(tmp, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    out = {}
    mesh = make_mesh((2, 2), ("data", "model"), "cpu")
    baxes = batch_axes_of(mesh)
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        opt_cfg = adamw.OptConfig(**OPT)
        dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                        global_batch=GLOBAL_BATCH)
        step = make_train_step(cfg, opt_cfg)
        # one process, no mesh
        p1, o1 = init_state(cfg, opt_cfg, seed=0, device="cpu")
        toks, tgts = device_batch(dc, 0, "cpu")
        p1, o1, m1 = step(p1, o1, toks, tgts)
        # the (2, 2) mesh
        pm, _ = init_state(cfg, opt_cfg, seed=0, device="cpu")
        sh = cell_shardings(cfg, "train_4k", mesh)
        SH.place_params(pm, sh["params"], mesh)
        om = adamw.init(pm, opt_cfg)
        toks, tgts = device_batch(dc, 0, "cpu", mesh, baxes)
        with SH.mesh_axes(baxes, "model", model_size=2):
            pm, om, mm = step(pm, om, toks, tgts)
        ref = dict(p1.named_parameters())
        res = {"loss": _rel_excess(mm["loss"].full_tensor(), m1["loss"]),
               "sharded": sum(isinstance(p, DTensor) and any(
                   not pl.is_replicate() for pl in p.placements)
                   for p in pm.parameters()),
               "params": {}}
        for n, p in pm.named_parameters():
            res["params"][n] = _rel_excess(p.detach().full_tensor(),
                                           ref[n].detach())
        out[arch] = res
        if arch == "mistral_nemo_12b":  # the elastic restore
            saved = {n: p.detach().full_tensor().numpy()
                     for n, p in pm.named_parameters()}
            ckdir = os.path.join(tmp, "ckpt")
            CheckpointManager(ckdir).save(1, (pm, om))
            if rank == 0:
                np.savez(os.path.join(tmp, "saved.npz"), **saved)
            dist.barrier()
            mesh41 = make_mesh((4, 1), ("data", "model"), "cpu")
            sh41 = cell_shardings(cfg, "train_4k", mesh41)
            tmpl = init_state(cfg, opt_cfg, seed=5, device="cpu")
            (rp, ro), _ = CheckpointManager(ckdir).restore(
                1, tmpl, placements=(sh41["params"], sh41["opt"]),
                mesh=mesh41)
            out["restore_41"] = {
                "exact": all(np.array_equal(p.detach().full_tensor().numpy(),
                                            saved[n])
                             for n, p in rp.named_parameters()),
                "on_mesh": all(isinstance(p, DTensor)
                               and p.device_mesh == mesh41
                               for p in rp.parameters()),
                "moments": all(np.array_equal(
                    ro.m[n].full_tensor().numpy(),
                    om.m[n].full_tensor().numpy()) for n in ro.m)}
            rows = {}
            for name, m in (("22", mesh), ("41", mesh41)):
                t, g = device_batch(dc, 3, "cpu", m, batch_axes_of(m))
                lt = t.to_local().numpy()
                n_rows = lt.shape[0]
                blk = m.get_local_rank("data")
                ht, hg = host_batch(dc, 3, blk * n_rows, (blk + 1) * n_rows)
                rows[name] = (np.array_equal(lt, ht)
                              and np.array_equal(g.to_local().numpy(), hg)
                              and tuple(t.shape) == (GLOBAL_BATCH, SEQ))
            out["rows"] = rows
    out["pieces"] = _pieces(mesh)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def _pieces(mesh):
    """The local_map pieces in layouts the two smoke steps do not take,
    against the same function on whole tensors, forward and gradients
    (excess over the tolerance, <= 0 when within): attention with query
    heads on ``model`` reading one whole KV head (rep 4), attention
    context-parallel (the queries' sequence on ``model``, causal), and
    the MoE layer with its batch on ``data`` and experts' ff on
    ``model``."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    from repro_torch.train import sharding as SH

    g = torch.Generator().manual_seed(3)
    res = {}

    def both(fn, args, placements, fn_mesh=None):
        ref_in = [a.clone().requires_grad_(True) for a in args]
        ref = fn(*ref_in)
        ref.square().sum().backward()
        d_in = [SH.distribute(a, mesh, pl).requires_grad_(True)
                for a, pl in zip(args, placements)]
        with SH.mesh_axes(("data",), "model", model_size=2):
            got = (fn_mesh or fn)(*d_in)
            got.square().sum().backward()
        errs = [_rel_excess(got.full_tensor().detach(), ref.detach())]
        errs += [_rel_excess(d.grad.full_tensor(), r.grad)
                 for d, r in zip(d_in, ref_in)]
        return max(errs)

    q = torch.randn(4, 16, 4, 8, generator=g)
    kv = torch.randn(4, 16, 1, 8, generator=g)
    heads = (Shard(0), Shard(2))
    res["attention_kv_whole"] = both(
        lambda a, b, c: L.chunked_attention(a, b, c, causal=True, chunk=8),
        (q, kv, kv.clone()), (heads, (Shard(0), Replicate()),
                              (Shard(0), Replicate())))
    seq = (Shard(0), Shard(1))
    k2 = torch.randn(4, 16, 2, 8, generator=g)
    res["attention_context_parallel"] = both(
        lambda a, b, c: L.chunked_attention(a, b, c, causal=True, chunk=8,
                                            window=6),
        (q, k2, k2.clone()), (seq, (Shard(0), Replicate()),
                              (Shard(0), Replicate())))
    cfg = get_smoke_config("mixtral_8x22b")
    moe = MOE.MoE(cfg, torch.Generator().manual_seed(4), device="cpu")
    placed = MOE.MoE(cfg, torch.Generator().manual_seed(4), device="cpu")
    SH.place_params(placed, {n: SH.to_placements(spec, mesh) for n, spec
                             in SH.param_specs(placed, fsdp=("data",))
                             .items()}, mesh)
    x = torch.randn(4, 16, cfg.d_model, generator=g)
    res["moe"] = both(lambda a: MOE.apply_moe(moe, a, cfg)[0], (x,),
                      ((Shard(0), Replicate()),),
                      lambda a: MOE.apply_moe(placed, a, cfg)[0])
    return res


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh_train"))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, tmp)) for r in range(WORLD)]
    env = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=240)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        if env is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = env
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    ranks = []
    for r in range(WORLD):
        with open(os.path.join(tmp, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    return tmp, ranks


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_train_step_matches_one_process(job, arch):
    _, ranks = job
    for res in ranks:
        r = res[arch]
        assert r["loss"] <= 0, r["loss"]
        bad = {n: e for n, e in r["params"].items() if e > 0}
        assert not bad, bad
        assert r["sharded"] > 0  # the mesh really split parameters


def test_checkpoint_restores_on_another_mesh(job):
    _, ranks = job
    for res in ranks:
        assert res["restore_41"] == {"exact": True, "on_mesh": True,
                                     "moments": True}


def test_checkpoint_from_mesh_restores_in_one_process(job):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import init_state

    tmp, _ = job
    cfg = get_smoke_config("mistral_nemo_12b")
    opt_cfg = adamw.OptConfig(**OPT)
    tmpl = init_state(cfg, opt_cfg, seed=5, device="cpu")
    (p, _), meta = CheckpointManager(os.path.join(tmp, "ckpt")).restore(
        1, tmpl)
    assert meta["step"] == 1
    with np.load(os.path.join(tmp, "saved.npz")) as saved:
        for n, t in p.named_parameters():
            np.testing.assert_array_equal(t.detach().numpy(), saved[n])


@pytest.mark.parametrize("piece", ["attention_kv_whole",
                                   "attention_context_parallel", "moe"])
def test_local_map_pieces_match_whole_tensors(job, piece):
    _, ranks = job
    for res in ranks:
        assert res["pieces"][piece] <= 0, res["pieces"][piece]


@pytest.mark.parametrize("mesh", ["22", "41"])
def test_device_batch_rows_are_host_batch_rows(job, mesh):
    _, ranks = job
    assert all(res["rows"][mesh] for res in ranks)
