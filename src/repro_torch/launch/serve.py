"""LM serving driver: batched greedy decoding with continuous batching slots.

The port's counterpart of the JAX package's ``launch/serve.py`` (the
language-model token-decoding server, not the Union simulation service).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mistral_nemo_12b \
      --smoke --device cpu --requests 8 --prompt-len 16 --gen-len 24

Every architecture of the registry serves (``repro_torch.configs.PORTED``).

Rows of the decode batch are serving slots. Requests are admitted in
waves of ``slots``: a wave starts from a fresh decode state, feeds the
prompts token by token through ``decode_step``, then generates
``gen_len`` tokens greedily, and its slots are refilled from the queue.
An encoder-decoder (``whisper_medium``) given each request's frame
embeddings encodes a wave's frames first and decodes against their cross
K/V, which the reference's serve loop leaves out (it builds its decode
state without ``xkv``, so its whisper decodes with no cross-attention);
the CLI draws random frames for it. The vision-language model serves its
text as the reference does (decode has no patch path).
``--device`` defaults to ``cuda`` and the run raises without a card;
``--device cpu`` runs on the CPU. Prompts and frames are drawn with numpy
from ``--seed``, the weights from a ``torch.Generator`` with the same
seed.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models import model as MDL
from repro_torch.models.config import ModelConfig
from repro_torch.train.serve_step import make_decode_state, make_decode_step


def serve(params, cfg: ModelConfig, prompts: np.ndarray, *, slots: int,
          gen_len: int, frontend: Optional[np.ndarray] = None,
          device=None) -> Tuple[Dict[int, List[int]], Dict]:
    """Serve ``prompts`` ((requests, prompt_len) token ids) in waves of
    ``slots`` rows; an encoder-decoder's ``frontend`` ((requests,
    enc_seq, d) frame embeddings) is encoded a wave at a time into the
    cross K/V (idle slots get zero frames). Returns the generated tokens
    of every request and the run's counts: requests, tokens, waves, decode
    steps, wall seconds."""
    dev = resolve_device(device)
    n_req, plen = prompts.shape
    ctx = plen + gen_len
    decode = make_decode_step(cfg)
    prompts_dev = torch.as_tensor(np.asarray(prompts, np.int32), device=dev)
    if frontend is not None:
        frontend_dev = torch.as_tensor(np.asarray(frontend, np.float32),
                                       device=dev)
    queue = list(range(n_req))
    outputs: Dict[int, List[int]] = {}
    waves = steps = 0
    t0 = time.perf_counter()
    while queue:
        slot_req = [queue.pop(0) if queue else -1 for _ in range(slots)]
        occupied = torch.as_tensor([r >= 0 for r in slot_req], device=dev)
        feed_prompts = torch.zeros((slots, plen), dtype=torch.int32,
                                   device=dev)
        rows = [s for s, r in enumerate(slot_req) if r >= 0]
        feed_prompts[rows] = prompts_dev[[slot_req[s] for s in rows]]
        state = make_decode_state(cfg, slots, ctx, dtype=torch.float32,
                                  device=dev)
        if cfg.enc_layers and frontend is not None:
            frames = torch.zeros((slots,) + frontend_dev.shape[1:],
                                 dtype=frontend_dev.dtype, device=dev)
            frames[rows] = frontend_dev[[slot_req[s] for s in rows]]
            state = MDL.attach_xkv(params, state, frames, cfg)
        tok = torch.zeros((slots,), dtype=torch.int32, device=dev)
        generated = []
        for t in range(ctx):
            if t < plen:
                feed = feed_prompts[:, t]
            else:
                feed = torch.where(occupied, tok, 0)
            tok, state = decode(params, state, feed)
            steps += 1
            if t >= plen:
                generated.append(tok)
        gen = (torch.stack(generated, dim=1).cpu().numpy() if generated
               else np.zeros((slots, 0), np.int32))  # (slots, gen_len)
        for s in rows:
            outputs[slot_req[s]] = gen[s].tolist()
        waves += 1
    wall = time.perf_counter() - t0
    stats = dict(requests=len(outputs),
                 tokens=sum(len(v) for v in outputs.values()),
                 waves=waves, decode_steps=steps, slots=slots, wall_s=wall)
    return outputs, stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    dev = resolve_device(args.device)
    params = MDL.init_model(cfg, seed=args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size, (args.requests, args.prompt_len),
                           dtype=np.int32)
    frontend = (rng.standard_normal(
        (args.requests, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        if cfg.enc_layers else None)
    outputs, st = serve(params, cfg, prompts, slots=args.slots,
                        gen_len=args.gen_len, frontend=frontend, device=dev)
    print(f"served {st['requests']} requests, {st['tokens']} tokens in "
          f"{st['wall_s']:.2f}s ({st['tokens'] / max(st['wall_s'], 1e-9):.1f} "
          f"tok/s, {st['waves']} waves) on {dev}")
    for r in range(min(args.requests, 3)):
        print(f"req{r}: {outputs[r][:10]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
