"""repro_torch — the PyTorch/CUDA port of the ``repro`` package.

It mirrors ``src/repro/``'s layout and module names and runs on an NVIDIA
GPU (H100, ``sm_90a``). It imports ``torch`` and ``numpy`` and nothing of
JAX or of the ``repro`` package. Entry points run on CUDA unless the
caller passes ``device="cpu"``; without a card they raise.

The slice ported so far is the simulator's main path: scenario ->
resolve -> build -> run -> report, with the drain tick as a CUDA kernel
(``kernels/csrc/drain_tick.cu``) on the dragonfly fabrics.
"""
