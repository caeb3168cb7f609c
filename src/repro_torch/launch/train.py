"""Training driver on one device.

The port's counterpart of the JAX package's ``launch/train.py``:

  PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2_1b \
      --smoke --device cpu --steps 6 --global-batch 4 --seq-len 32 \
      --ckpt-dir /tmp/ck --ckpt-every 3

The reference's flags, plus ``--device`` (``cuda`` by default: the run
raises without a card; ``cpu`` runs on the CPU). One device and no mesh:
the config registry, the synthetic data pipeline (``device_batch`` of each
step), the train step (gradient accumulation, the bf16 policy: the
moments in the config's ``param_dtype``), atomic and async checkpoints,
and ``--resume`` from the newest one with the data stream resumed at its
step. As in the reference, the step is given no frame embeddings, so
``--arch whisper_medium`` fails in the encoder (``None.to``); the train
step itself trains it when given them.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import DataConfig, device_batch
from repro_torch.device import resolve_device
from repro_torch.optim import adamw
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


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg, opt_cfg, dc, step_fn = build(args)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    params, opt_state = init_state(cfg, opt_cfg, seed=0, device=dev)
    start = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        start = ckpt.latest_step()
        (params, opt_state), _ = ckpt.restore(start, (params, opt_state))
        print(f"resumed from step {start}")

    t0 = time.time()
    for step in range(start, args.steps):
        tokens, targets = device_batch(dc, step, dev)
        params, opt_state, metrics = step_fn(params, opt_state, tokens,
                                             targets)
        if (step + 1) % args.log_every == 0 or step == start:
            print(f"step {step + 1:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} "
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
