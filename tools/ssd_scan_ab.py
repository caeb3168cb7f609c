#!/usr/bin/env python3
"""Hold this checkout's SSD scan kernel against another build of it, on one card.

    git show <rev>:src/repro_torch/kernels/csrc/ssd_scan.cu > build/ssd_scan_other.cu
    python3 tools/ssd_scan_ab.py build/ssd_scan_other.cu

The other source is one of the one-kernel design that came before the C Bᵀ
pre-pass: its ``ssd_scan_launch`` takes (x, dt, A, B, C, BH, nc, Q, hd,
ds, heads_per_group, y, h, stream). The tool builds it with the flags of
``repro_torch.kernels._build`` into ``build/``, runs both on the inputs of
``chip_smoke.py``'s phase 4 (the Mamba-2 prefill shapes: 8 requests x 32
heads, 32 chunks of 128, head 64, state 128, B and C per request), and
prints one JSON line: how many values of y and of the final state differ
between the two, bit for bit, and each one's milliseconds a call by CUDA
events, timed in turns (other, this, this, other). Needs a CUDA card and
nvcc; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", help="path of the other ssd_scan.cu")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("ssd_scan_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from chip_smoke import ssd_inputs, time_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd_scan import ssd_scan_cuda

    so = os.path.join(ROOT, "build", "ssd_scan_ab_other.so")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, args.other],
                   check=True, capture_output=True, text=True)
    launch = ctypes.CDLL(so).ssd_scan_launch
    launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p] * 3
    launch.restype = ctypes.c_int

    dev = torch.device("cuda", 0)
    B, nh, S, Q, hd, ds = 8, 32, 4096, 128, 64, 128
    ins = ssd_inputs(B * nh, B, S // Q, Q, hd, ds, 7, dev)
    BH, nc = B * nh, S // Q
    p = _build.ptr

    def other():
        y = torch.empty((BH, nc, Q, hd), device=dev)
        h = torch.empty((BH, ds, hd), device=dev)
        err = launch(*(p(t) for t in ins), BH, nc, Q, hd, ds,
                     BH // B, p(y), p(h),
                     ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"ssd_scan_ab: the other build's launch "
                               f"failed ({err})")
        return y, h

    def this():
        return ssd_scan_cuda(*ins)

    (y0, h0), (y1, h1) = other(), this()
    torch.cuda.synchronize()
    ms = [time_ms(f, reps=10, warmup=2) for f in (other, this, this, other)]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True).stdout.strip()

    def differ(a, b):
        return int((a.view(torch.int32) != b.view(torch.int32)).sum())

    print(json.dumps(dict(
        card=card, other=args.other, BH=BH, groups=B, nc=nc, Q=Q, hd=hd,
        ds=ds, y_values=y1.numel(), y_values_differ=differ(y0, y1),
        h_values=h1.numel(), h_values_differ=differ(h0, h1),
        ms_other_this_this_other=ms)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
