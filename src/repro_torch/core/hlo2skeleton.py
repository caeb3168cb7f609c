"""hlo2skeleton: Union skeletons for ML jobs from dry-run records.

The paper built its ML workloads (CosmoFlow, AlexNet) by hand from Horovod
traces. Here the equivalent skeleton is derived *mechanically* from a
dry-run record of a compiled training step: its per-step collective
traffic (wire bytes per device) and FLOPs. We emit a Union DSL program —
one training step = compute delay segments interleaved with the aggregate
gradient collectives — which then flows through the SAME parse →
translate → validate pipeline as every hand-written workload, and co-runs
with HPC skeletons in the dragonfly simulator.

The port's copy of the JAX package's module: a record gives both packages
the same DSL source (``tests/test_torch_validation.py`` holds them to
it). Records are JSON with ``params``, ``flops_per_device``, ``layout``,
``arch`` and ``shape``; the port makes none.

Mapping notes (DESIGN.md §9): subgroup (model-axis) collectives are folded
into one job-wide ALLREDUCE of equal wire volume; all-to-all volume is
likewise folded. The preserved quantities are per-device traffic volume and
the compute/communicate cadence — the interference-relevant features.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

from repro_torch.core.translator import translate_source

# the compute peak (FLOP/s a rank) of the simulated ML job that the
# dry-run records were made for: with ``mfu`` it turns a record's FLOPs
# into the job's compute time. Equal to the JAX package's, so that both
# packages emit the same DSL from one record.
PEAK_FLOPS = 197e12


BUCKET_BYTES = 128 << 20  # gradient-fusion bucket (Horovod/NCCL-style)
MAX_BUCKETS = 24


def ml_workload_source(
    *,
    name: str,
    flops_per_device: float,
    grad_bytes_per_rank: float,
    steps: int = 8,
    mfu: float = 0.4,
) -> str:
    """Emit Union DSL for `steps` training steps of the profiled model.

    The inter-node traffic modeled is the *gradient synchronization* volume
    (params·bytes / TP shards), issued as fused allreduce buckets between
    compute segments — the pattern the paper traced from Horovod. Intra-step
    TP/ZeRO weight gathers overlap compute on the fabric-local mesh and are
    not exposed to the data-center network model.
    """
    compute_ms = flops_per_device / (mfu * PEAK_FLOPS) * 1e3
    n_buckets = max(1, min(MAX_BUCKETS, -(-int(grad_bytes_per_rank) // BUCKET_BYTES)))
    bucket = max(int(grad_bytes_per_rank / n_buckets), 64)
    seg_ms = max(compute_ms / n_buckets, 0.05)
    body = []
    for _ in range(n_buckets):
        body.append(f"  all tasks compute for {seg_ms:.3f} milliseconds then")
        body.append(f"  all tasks allreduce a {bucket} byte message then")
    body[-1] = body[-1][: -len(" then")]
    src = "\n".join(
        [
            f"# Auto-extracted by hlo2skeleton from the compiled step of {name}",
            'Require language version "1.5".',
            f'steps is "training steps" and comes from "--steps" with default {steps}.',
            "For steps repetitions {",
            *body,
            "}",
        ]
    )
    return src


def from_dryrun_record(path: str, steps: int = 8, mfu: float = 0.4) -> str:
    """Build the DSL source from a dry-run JSON record."""
    with open(path) as f:
        rec = json.load(f)
    tp_shards = 16 if rec.get("layout", "tp") == "tp" else 1
    grad_bytes = rec["params"] * 2 / tp_shards  # bf16 grads per rank
    return ml_workload_source(
        name=f"{rec['arch']}:{rec['shape']}",
        flops_per_device=rec["flops_per_device"],
        grad_bytes_per_rank=grad_bytes,
        steps=steps,
        mfu=mfu,
    )


def build_ml_skeleton(
    arch: str,
    shape: str,
    dryrun_dir: str = "results/dryrun",
    mesh: str = "single",
    n_ranks: int = 256,
    steps: int = 8,
    overrides: Optional[Dict] = None,
):
    """Dry-run record -> DSL -> registered skeleton (standard pipeline)."""
    path = os.path.join(dryrun_dir, f"{arch}__{shape}__{mesh}.json")
    src = from_dryrun_record(path, steps=steps)
    return translate_source(src, f"ml_{arch}_{shape}", n_ranks, overrides)
