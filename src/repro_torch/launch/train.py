"""Training launcher: one device, or a mesh.

The port's counterpart of the JAX package's ``launch/train.py``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2_1b \
      --smoke --device cpu --steps 6 --global-batch 4 --seq-len 32 \
      --ckpt-dir /tmp/ck --ckpt-every 3

The reference's flags, plus ``--device`` (``cuda`` by default: the run
raises without a card; ``cpu`` runs on the CPU). The mesh is built as the
reference builds it: with ``--smoke``, the (1, 1) smoke mesh, over a
process group of this one process (NCCL on the card, gloo on the CPU, its
store a file in a temporary directory) that the run sets up and tears
down; without it, the (16, 16) production mesh when the process is one
rank of a world that has its 256 ranks (``torchrun``'s ``WORLD_SIZE``);
in a world of one process, no mesh and one device. On a mesh the
parameters and the optimizer's moments are DTensors placed by
``launch.specs.cell_shardings``, each rank makes its own rows of the batch
(``device_batch``), and the step runs under the sharding constraints
(``train.sharding.mesh_axes``). Either way: the config registry, the
synthetic data pipeline, the train step (gradient accumulation, the bf16
policy: the moments in the config's ``param_dtype``), atomic and async
checkpoints of the global arrays, and ``--resume`` from the newest one
with the data stream resumed at its step. As in the reference, the step
is given no frame embeddings, so ``--arch whisper_medium`` fails in the
encoder (``None.to``); the train step itself trains it when given them.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import os
import shutil
import tempfile
import time

import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, device_batch
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (
    batch_axes_of, make_production_mesh, make_smoke_mesh)
from repro_torch.launch.specs import cell_shardings
from repro_torch.optim import adamw
from repro_torch.train import sharding as SH
from repro_torch.train.train_step import init_state, make_train_step


def build(args):
    """(cfg, opt_cfg, data config, step function) for parsed flags."""
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt_cfg = adamw.OptConfig(
        lr=args.lr, total_steps=args.steps,
        warmup_steps=max(args.steps // 20, 5), moment_dtype=cfg.param_dtype)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                    global_batch=args.global_batch)
    return cfg, opt_cfg, dc, make_train_step(cfg, opt_cfg, accum=args.accum)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU tests, quick runs)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    return ap


@contextlib.contextmanager
def one_process_group(dev):
    """A process group of this process alone (NCCL for a card, gloo for
    the CPU) with its store in a temporary directory, torn down on exit;
    nothing when a group is already set up."""
    if dist.is_initialized():
        yield
        return
    tmp = tempfile.mkdtemp(prefix="repro_torch_pg_")
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0,
        world_size=1, device_id=dev if dev.type == "cuda" else None)
    try:
        yield
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def place_state(cfg, params, opt_cfg, mesh):
    """A model's parameters placed on ``mesh`` by the train cell's
    shardings (in place), and a zero optimizer state of DTensor moments
    placed alike."""
    SH.place_params(params, cell_shardings(cfg, "train_4k", mesh)["params"],
                    mesh)
    return params, adamw.init(params, opt_cfg)


def mesh_context(mesh):
    """``mesh_axes`` for a step on ``mesh``."""
    names = list(mesh.mesh_dim_names)
    return SH.mesh_axes(batch_axes_of(mesh), "model",
                        model_size=mesh.size(names.index("model")))


def _value(x) -> float:
    return float(x.full_tensor() if isinstance(x, DTensor) else x)


def _mesh_world(args, dev):
    """(a context that sets up the run's process group, whether the run
    has a mesh)."""
    if args.smoke:
        return one_process_group(dev), True
    if int(os.environ.get("WORLD_SIZE", "1")) >= 256:
        return _env_group(dev), True
    return contextlib.nullcontext(), False


@contextlib.contextmanager
def _env_group(dev):
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        yield
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg, opt_cfg, dc, step_fn = build(args)
    group, on_mesh = _mesh_world(args, dev)
    with group:
        mesh = None
        step_context = contextlib.nullcontext
        params, opt_state = init_state(cfg, opt_cfg, seed=0, device=dev)
        if on_mesh:
            mesh = (make_smoke_mesh(dev.type) if args.smoke
                    else make_production_mesh(device_type=dev.type))
            params, opt_state = place_state(cfg, params, opt_cfg, mesh)
            step_context = functools.partial(mesh_context, mesh)
        ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
        start = 0
        if ckpt and args.resume and ckpt.latest_step() is not None:
            start = ckpt.latest_step()
            (params, opt_state), _ = ckpt.restore(start, (params, opt_state))
            print(f"resumed from step {start}")

        t0 = time.time()
        for step in range(start, args.steps):
            tokens, targets = device_batch(
                dc, step, dev, mesh, batch_axes_of(mesh) if mesh else ())
            with step_context():
                params, opt_state, metrics = step_fn(params, opt_state,
                                                     tokens, targets)
            if (step + 1) % args.log_every == 0 or step == start:
                print(f"step {step + 1:5d} loss {_value(metrics['loss']):.4f} "
                      f"gnorm {_value(metrics['grad_norm']):.3f} "
                      f"lr {_value(metrics['lr']):.2e} "
                      f"({(time.time() - t0) / (step - start + 1):.2f}s/step)",
                      flush=True)
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save_async(step + 1, (params, opt_state))
        if ckpt:
            ckpt.save(args.steps, (params, opt_state))
            print(f"final checkpoint at step {args.steps}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
