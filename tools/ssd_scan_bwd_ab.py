#!/usr/bin/env python3
"""Hold this checkout's SSD scan backward against another build of it, on one card.

    mkdir -p build
    git show <rev>:src/repro_torch/kernels/csrc/ssd_scan_bwd.cu > build/ssd_scan_bwd_other.cu
    python3 tools/ssd_scan_bwd_ab.py build/ssd_scan_bwd_other.cu

The other source is either of the checkout's C interface (the chunk-parallel
kernels: it exports ``ssd_scan_bwd_kernel_info``, and runs through this
checkout's wrapper), or of the one-block-a-row design that came before them:
its ``ssd_scan_bwd_launch`` takes (x, dt, A, B, C, dy, dh_final, cb_ts,
cb_st, hs, BH, nc, Q, hd, ds, heads_per_group, dx, ddt, dA, dB, dC, stream)
and writes dB and dC per row, which the tool sums over each group's rows as
that design's wrapper did. The tool builds it with the flags of
``repro_torch.kernels._build`` (and its own ``// nvcc-flags:`` lines) into
``build/`` and runs both on the inputs of ``chip_smoke.py``'s backward
phase at two of its shapes: the training shapes of mamba2_370m (8
sequences x 32 heads, 32 chunks of 128, head 64, state 128, B and C per
sequence) and jamba's group shape (128 heads of 64 sharing one group,
state 16). It prints one JSON line: per shape and
output, how many values differ between the two bit for bit, the largest
difference, and each build's largest error to a float64 plain version
beside the float32 plain version's; and each one's milliseconds a call at
the training shapes by CUDA events, timed in turns (other, this, this,
other). Needs a CUDA card and nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="path of the other ssd_scan_bwd.cu")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ssd_scan_bwd_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from chip_smoke import ssd_inputs, time_ms
    from repro_torch.kernels import _build, ssd_scan
    from repro_torch.kernels.ssd_scan import (ssd_scan_bwd_cuda,
                                              ssd_scan_bwd_plain)

    so = os.path.join(ROOT, "build", "ssd_scan_bwd_ab_other.so")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.file_flags(args.other), "-o", so,
                    args.other], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    same_interface = hasattr(lib, "ssd_scan_bwd_kernel_info")
    this_lib = _build.load("ssd_scan_bwd")

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)

    def case(BH, G, hd, ds, seed):
        ins = ssd_inputs(BH, G, 32, 128, hd, ds, seed, dev)
        dy = torch.as_tensor(np.random.default_rng(seed + 1).standard_normal(
            tuple(ins[0].shape)).astype(np.float32), device=dev)
        return ins, dy

    def run_this(ins, dy):
        _build._LIBS["ssd_scan_bwd"] = this_lib
        ssd_scan._bwd_entry_points.cache_clear()
        return ssd_scan_bwd_cuda(*ins, dy)

    def run_other(ins, dy):
        if same_interface:
            _build._LIBS["ssd_scan_bwd"] = lib
            ssd_scan._bwd_entry_points.cache_clear()
            return ssd_scan_bwd_cuda(*ins, dy)
        launch = lib.ssd_scan_bwd_launch
        launch.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p] * 6
        launch.restype = ctypes.c_int
        BH, nc, Q, hd = ins[0].shape
        G, ds = ins[3].shape[0], ins[3].shape[-1]

        def empty(*shape):
            return torch.empty(shape, device=dev)

        dx, ddt, dA = empty(BH, nc, Q, hd), empty(BH, nc, Q), empty(BH)
        dB, dC = empty(BH, nc, Q, ds), empty(BH, nc, Q, ds)
        cb_ts, cb_st = empty(G, nc, Q, Q), empty(G, nc, Q, Q)
        hs = empty(BH, nc, ds, hd)
        p = torch.Tensor.data_ptr
        err = launch(*(p(t) for t in ins), p(dy), None, p(cb_ts), p(cb_st),
                     p(hs), BH, nc, Q, hd, ds, BH // G, p(dx), p(ddt), p(dA),
                     p(dB), p(dC), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ssd_scan_bwd_ab: the other build's launch "
                               f"failed ({err})")
        return (dx, ddt, dA, dB.view(G, BH // G, nc, Q, ds).sum(dim=1),
                dC.view(G, BH // G, nc, Q, ds).sum(dim=1))

    shapes = dict(train=(256, 8, 64, 128, 21), jamba_group=(128, 1, 64, 16,
                                                            25))
    outputs, ms = {}, None
    for shape, (BH, G, hd, ds, seed) in shapes.items():
        ins, dy = case(BH, G, hd, ds, seed)
        was, now = run_other(ins, dy), run_this(ins, dy)
        want = ssd_scan_bwd_plain(*ins, dy)
        want64 = ssd_scan_bwd_plain(*(t.double() for t in ins), dy.double())
        torch.cuda.synchronize()
        rows = {}
        for name, a, b, w, w64 in zip(NAMES, was, now, want, want64):
            rows[name] = dict(
                values=b.numel(),
                values_differ=int((a.view(torch.int32)
                                   != b.view(torch.int32)).sum()),
                max_abs_diff=float((a - b).abs().max()),
                max_abs=float(w64.abs().max()),
                other_err_f64=float((a.double() - w64).abs().max()),
                this_err_f64=float((b.double() - w64).abs().max()),
                plain_err_f64=float((w.double() - w64).abs().max()))
        outputs[shape] = rows
        if shape == "train":
            ms = [time_ms(lambda: f(ins, dy), reps=5, warmup=1)
                  for f in (run_other, run_this, run_this, run_other)]
        del was, now, want, want64, ins, dy
        torch.cuda.empty_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(dict(card=card, other=args.other,
                          other_interface="checkout's" if same_interface
                          else "one block a row", outputs=outputs,
                          train_ms_other_this_this_other=ms)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
