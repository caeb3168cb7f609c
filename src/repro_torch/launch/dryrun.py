"""Multi-pod dry run: trace every (arch × shape × mesh) cell's step on a
mesh of 256 (or 512) ranks in one process, with no device memory.

The port's counterpart of the JAX package's ``launch/dryrun.py``, which
lowers and compiles each cell on 512 forced XLA host devices and reads
the compiled module's costs. Here one process joins a fake process group
(``torch.testing``'s ``FakeStore``: collectives return at once and move
nothing) of the mesh's size, builds the production mesh, places the
``meta`` parameters, optimizer state and inputs by ``cell_shardings``
(each tensor a DTensor whose local shard has a shape and no data), and
runs the train, prefill or decode step under the sharding constraints.
A dispatch mode below DTensor sees the ops rank 0 runs on its local
shards and counts, for one device:

* FLOPs: torch's flop counter (matrix products; what a step's time is
  made of) of each local op — not the global op a ``FlopCounterMode``
  around DTensor code would count;
* bytes accessed: each local op's inputs and outputs (views move none),
  op by op as eager PyTorch runs them, with no fusion;
* collectives: each functional collective DTensor issues (kind, output
  bytes, group size), read against ``CommDebugMode``'s counts, and turned
  into wire bytes by ``roofline.collective_stats_from_comms``.

Usage:
  python -m repro_torch.launch.dryrun --arch mistral_nemo_12b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--mesh both] [--out results/dryrun]

Each cell writes ``<out>/<arch>__<shape>__<mesh>.json`` (or ``.err``) with
every key of the reference's record; ``core.hlo2skeleton`` reads it for
``hlo:`` jobs.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref
from collections import Counter
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import ARCH_IDS, SHAPES, cell_applicable, get_config
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import (
    cell_plan, cell_shardings, input_specs, model_state_specs)
from repro_torch.optim import adamw
from repro_torch.train import sharding as SH
from repro_torch.train.serve_step import make_decode_step, make_prefill_step
from repro_torch.train.train_step import make_train_step

# functional collectives (``_c10d_functional``) by the roofline's kinds
COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
}
# ops that touch no memory of their own
_FREE = {"wait_tensor", "_wrap_tensor_autograd", "detach", "empty",
         "empty_strided", "empty_like", "lift_fresh"}


def init_fake_world(world_size: int) -> None:
    """Join a fake process group of ``world_size`` ranks as rank 0 (once
    in a process)."""
    if dist.is_initialized():
        if dist.get_world_size() < world_size:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is set "
                f"up; the dry run needs {world_size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class DeviceCounter(TorchDispatchMode):
    """FLOPs, bytes accessed, collectives and live bytes of the ops one
    rank runs on its local tensors. DTensor ops pass (``NotImplemented``)
    and come back as the local ops DTensor issues; ops on fake tensors
    (DTensor's own shape propagation) are not the device's and are not
    counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.comms = []  # (kind, output bytes, group size)
        self.live = 0
        self.peak_live = 0

    def _drop(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        from torch._subclasses.fake_tensor import FakeTensor

        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out
        name = func._overloadpacket.__name__
        if func.namespace == "_c10d_functional":
            kind = COLLECTIVES.get(name)
            if kind is not None:
                group = dist.distributed_c10d._resolve_process_group(
                    args[-1]).size()
                self.comms.append((kind, sum(map(_nbytes, outs)), group))
            elif name not in _FREE:
                raise NotImplementedError(f"dry run: collective {func}")
            return out
        if func._overloadpacket in flop_registry:
            self.flops += flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out)
        if func.is_view or name in _FREE:
            return out
        self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        known = {id(t) for t in ins}
        for t in outs:  # new tensors (not an input written in place)
            if id(t) not in known:
                n = _nbytes(t)
                self.live += n
                weakref.finalize(t, self._drop, n)
        self.peak_live = max(self.peak_live, self.live)
        return out


def _local_bytes(tree) -> int:
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in _tensors(tree))


def lower_cell(arch: str, shape_name: str, mesh, *, fsdp: bool = True,
               seq_parallel: bool = False, accum: Optional[int] = None,
               cfg_override=None, layout: str = "tp"):
    """Place one cell on ``mesh`` and return (a function that runs its
    step once, the meta dict, the config, the argument tree)."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shp = SHAPES[shape_name]
    sh = cell_shardings(cfg, shape_name, mesh, fsdp=fsdp, layout=layout)
    batch_axes, n_dp = sh["batch_axes"], sh["n_dp"]
    plan = cell_plan(cfg, shape_name, n_dp)
    if accum is not None:
        plan["accum"] = accum
    ins = input_specs(arch, shape_name, cfg)
    kind = ins.pop("kind")
    params, _ = model_state_specs(cfg, opt=False)
    SH.place_params(params, sh["params"], mesh)
    placed = {k: SH.distribute(v, mesh, sh[k]) for k, v in ins.items()
              if k != "state"}
    ctx = dict(batch_axes=batch_axes, model_axis="model",
               seq_parallel=seq_parallel,
               model_size=(1 if layout == "dp" else
                           mesh.size(mesh.mesh_dim_names.index("model"))))
    if kind == "train":
        params.requires_grad_(True)
        opt_cfg = adamw.OptConfig(moment_dtype=cfg.param_dtype)
        opt = adamw.init(params, opt_cfg)
        step_fn = make_train_step(cfg, opt_cfg, accum=plan["accum"])
        args = [params, opt, placed["tokens"], placed["targets"]]
        if "frontend" in placed:
            args.append(placed["frontend"])
    elif kind == "prefill":
        step_fn = make_prefill_step(cfg)
        args = [params, placed["tokens"]]
        if "frontend" in placed:
            args.append(placed["frontend"])
    else:  # decode
        step_fn = make_decode_step(cfg)
        state = SH.map_specs(lambda pl, t: SH.distribute(t, mesh, pl),
                             sh["state"], ins["state"])
        args = [params, state, placed["token"]]

    def run():
        with SH.mesh_axes(**ctx), torch.set_grad_enabled(kind == "train"):
            return step_fn(*args)

    n_tokens = shp["global_batch"] * (shp["seq_len"] if kind != "decode"
                                      else 1)
    meta = dict(
        arch=arch, shape=shape_name, kind=kind, accum=plan["accum"],
        n_devices=mesh.size(), n_dp=n_dp, n_tokens=n_tokens,
        params=cfg.param_count(), active_params=cfg.active_param_count(),
        fsdp=fsdp, seq_parallel=seq_parallel, layout=layout,
    )
    return run, meta, cfg, args


def trace_cell(run, mesh_size: int):
    """Run a placed cell's step once under the counters: (its outputs,
    the DeviceCounter, collective stats)."""
    with CommDebugMode() as comm, DeviceCounter() as ctr:
        out = run()
    counted = Counter(k for k, _, _ in ctr.comms)
    seen = Counter()
    for op, n in comm.get_comm_counts().items():
        kind = COLLECTIVES.get(getattr(op, "__name__", str(op)).split(".")[-1])
        if kind is not None:
            seen[kind] += n
    if seen != counted:
        raise RuntimeError(f"dry run: collectives counted {dict(counted)}, "
                           f"CommDebugMode saw {dict(seen)}")
    return out, ctr, RL.collective_stats_from_comms(ctr.comms, mesh_size)


def _variant_cost(arch, shape_name, mesh, cfg_v, *, fsdp, seq_parallel,
                  layout):
    """(flops, bytes, wire bytes, collective stats) a device of one
    reduced-depth variant's step, at accum 1."""
    run, _, _, _ = lower_cell(arch, shape_name, mesh, fsdp=fsdp,
                              seq_parallel=seq_parallel, accum=1,
                              cfg_override=cfg_v, layout=layout)
    _, ctr, coll = trace_cell(run, mesh.size())
    return (float(ctr.flops), float(ctr.bytes),
            float(coll["wire_bytes_per_device"]), coll)


def analysis_terms(arch, shape_name, mesh, *, fsdp, seq_parallel,
                   layout="tp", remat: bool = True,
                   remat_policy: str = "full", attn_bf16: bool = False,
                   cfg=None) -> Dict[str, Any]:
    """Per-device costs extrapolated in depth, as the reference's: the
    step's costs are affine in the number of periods, cost(L) = base +
    L·per_period, so 1- and 2-period variants (and a 2-layer encoder)
    give the full depth. The port's trace runs every period, so on a
    config small enough to trace in full the extrapolation must equal
    the full-depth count (``tests/test_torch_dryrun.py``)."""
    cfg = (cfg if cfg is not None else get_config(arch)).replace(
        remat=remat, remat_policy=remat_policy, attn_bf16=attn_bf16)
    plen = len(cfg.period)
    v1 = cfg.replace(n_layers=plen, enc_layers=min(cfg.enc_layers, 1))
    v2 = cfg.replace(n_layers=2 * plen, enc_layers=min(cfg.enc_layers, 1))
    kw = dict(fsdp=fsdp, seq_parallel=seq_parallel, layout=layout)
    f1, b1, w1, _ = _variant_cost(arch, shape_name, mesh, v1, **kw)
    f2, b2, w2, coll2 = _variant_cost(arch, shape_name, mesh, v2, **kw)
    nP = cfg.n_periods
    out = dict(
        flops=f1 + (nP - 1) * (f2 - f1),
        bytes=b1 + (nP - 1) * (b2 - b1),
        wire=w1 + (nP - 1) * (w2 - w1),
        per_period=dict(flops=f2 - f1, bytes=b2 - b1, wire=w2 - w1),
        base=dict(flops=2 * f1 - f2, bytes=2 * b1 - b2, wire=2 * w1 - w2),
        collective_kinds=coll2["by_kind_count"],
    )
    if cfg.enc_layers > 1:
        v3 = cfg.replace(n_layers=plen, enc_layers=2)
        f3, b3, w3, _ = _variant_cost(arch, shape_name, mesh, v3, **kw)
        ne = cfg.enc_layers
        out["flops"] += (ne - 1) * (f3 - f1)
        out["bytes"] += (ne - 1) * (b3 - b1)
        out["wire"] += (ne - 1) * (w3 - w1)
        out["per_enc_layer"] = dict(flops=f3 - f1, bytes=b3 - b1,
                                    wire=w3 - w1)
    return out


def run_cell(arch: str, shape_name: str, mesh_kind: str, *,
             fsdp: bool = True, seq_parallel: bool = False,
             accum: Optional[int] = None, analyze: bool = True,
             layout: str = "tp", remat: bool = True,
             remat_policy: str = "full", attn_bf16: bool = False,
             mesh=None, cfg=None) -> Dict[str, Any]:
    """One cell's record. ``mesh``: the production mesh of ``mesh_kind``
    unless given (tests pass small meshes); ``cfg``: the arch's config
    unless given (tests pass smoke configs).

    ``lower_s`` is the time to place the cell (its meta state and
    inputs as DTensors), ``compile_s`` the time to trace its step.
    ``memory``: the local bytes of the step's arguments and outputs,
    exactly, and ``temp_size_in_bytes``, an estimate: the most bytes that
    the ops' new tensors held alive at once while the step ran (what the
    caching allocator would hold beyond the arguments, without its
    rounding and fragmentation).
    """
    mesh = mesh if mesh is not None else make_production_mesh(
        multi_pod=(mesh_kind == "multi"), device_type="cpu")
    cfg0 = cfg if cfg is not None else get_config(arch)
    cfg_run = cfg0.replace(remat=remat, remat_policy=remat_policy,
                           attn_bf16=attn_bf16)
    t0 = time.time()
    run, meta, cfg, args = lower_cell(
        arch, shape_name, mesh, fsdp=fsdp, seq_parallel=seq_parallel,
        accum=accum, layout=layout, cfg_override=cfg_run)
    meta["remat"] = remat
    meta["remat_policy"] = remat_policy
    meta["attn_bf16"] = attn_bf16
    arg_bytes = _local_bytes(args)
    t1 = time.time()
    out, ctr, coll = trace_cell(run, mesh.size())
    t2 = time.time()
    mem_d = {"argument_size_in_bytes": arg_bytes,
             "output_size_in_bytes": _local_bytes(out),
             "temp_size_in_bytes": ctr.peak_live}
    del out, args, run

    if analyze:
        ana = analysis_terms(
            arch, shape_name, mesh, fsdp=fsdp, seq_parallel=seq_parallel,
            layout=layout, remat=remat, remat_policy=remat_policy,
            attn_bf16=attn_bf16, cfg=cfg0)
        flops_dev, bytes_dev, wire_dev = ana["flops"], ana["bytes"], ana["wire"]
    else:
        ana = None
        flops_dev, bytes_dev = float(ctr.flops), float(ctr.bytes)
        wire_dev = coll["wire_bytes_per_device"]

    terms = RL.roofline_terms(flops_per_device=flops_dev,
                              bytes_per_device=bytes_dev,
                              wire_bytes_per_device=wire_dev)
    mf = RL.model_flops(cfg, meta["n_tokens"],
                        "train" if meta["kind"] == "train" else "serve")
    return dict(
        meta,
        mesh=mesh_kind,
        lower_s=round(t1 - t0, 2),
        compile_s=round(t2 - t1, 2),
        flops_per_device=flops_dev,
        bytes_per_device=bytes_dev,
        wire_bytes_per_device=wire_dev,
        raw_cost_flops=float(ctr.flops),
        collectives=coll,
        analysis=ana,
        memory=mem_d,
        roofline=terms,
        model_flops_total=mf,
        useful_flops_ratio=(mf / (flops_dev * mesh.size())
                            if flops_dev else 0.0),
    )


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--accum", type=int, default=None)
    ap.add_argument("--tag", default="")
    ap.add_argument("--layout", default="tp", choices=["tp", "dp"])
    ap.add_argument("--no-remat", action="store_true")
    ap.add_argument("--remat-policy", default="full",
                    choices=["full", "dots"])
    ap.add_argument("--attn-bf16", action="store_true")
    ap.add_argument("--no-analyze", action="store_true",
                    help="skip the depth variants (multi-pod sweep: the "
                    "deliverable is a traced step + memory fit)")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    init_fake_world(512 if "multi" in meshes else 256)
    if args.all:
        cells = [(a, s) for a in ARCH_IDS for s in SHAPES
                 if cell_applicable(get_config(a), s)]
    else:
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in cells:
        for mk in meshes:
            tag = f"{arch}__{shape}__{mk}" + (f"__{args.tag}" if args.tag
                                              else "")
            path = os.path.join(args.out, tag + ".json")
            print(f"=== {tag} ===", flush=True)
            try:
                rec = run_cell(
                    arch, shape, mk, fsdp=not args.no_fsdp,
                    seq_parallel=args.seq_parallel, accum=args.accum,
                    analyze=not args.no_analyze, layout=args.layout,
                    remat=not args.no_remat, remat_policy=args.remat_policy,
                    attn_bf16=args.attn_bf16)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                r = rec["roofline"]
                print(f"    ok: trace={rec['compile_s']}s "
                      f"dominant={r['dominant']} "
                      f"compute={r['compute_s']:.4f}s "
                      f"mem={r['memory_s']:.4f}s "
                      f"coll={r['collective_s']:.4f}s "
                      f"frac={r['roofline_fraction']:.3f}", flush=True)
            except Exception as e:
                failures += 1
                with open(path + ".err", "w") as f:
                    f.write(traceback.format_exc())
                print(f"    FAIL: {type(e).__name__}: {e}", flush=True)
    print(f"done, failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
