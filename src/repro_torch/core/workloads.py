"""The paper's hybrid-workload applications, written in the Union DSL.

§IV-B of the paper: two ML skeletons (CosmoFlow, AlexNet) built with Union,
three SWM-style HPC skeletons (MILC, Nekbone, LAMMPS), one synthetic
nearest-neighbor kernel (NN), and uniform-random (UR) background traffic.
UR is generated directly by the network simulator (as in CODES) — it is a
synthetic source, not a Union program.

Every workload is parameterized by scale: ``paper`` uses the paper's rank
counts; ``small`` divides ranks so benches run on this CPU container.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from repro_torch.core import dsl
from repro_torch.core.translator import translate_source


@dataclass(frozen=True)
class WorkloadSpec:
    name: str
    source: str
    paper_ranks: int
    small_ranks: int
    overrides_paper: Tuple[Tuple[str, float], ...] = ()
    overrides_small: Tuple[Tuple[str, float], ...] = ()


COSMOFLOW = WorkloadSpec(
    name="cosmoflow",
    source="""
# CosmoFlow: periodic gradient allreduce (28.15 MiB every 129 ms) [paper §IV-B]
Require language version "1.5".
iters is "Number of training steps" and comes from "--iters" with default 20.
Assert that "needs at least two tasks" with num_tasks >= 2.
For iters repetitions {
  all tasks compute for 129 milliseconds then
  all tasks allreduce a 28.15 MiB message
}
""",
    paper_ranks=1024,
    small_ranks=64,
    overrides_small=(("iters", 6),),
)

ALEXNET = WorkloadSpec(
    name="alexnet",
    source="""
# AlexNet/Horovod: negotiation (4- and 25-byte msgs + broadcast) before each
# gradient update; each update allreduces ~235 MiB in four fused tensors.
Require language version "1.5".
updates is "Number of gradient updates" and comes from "--updates" with default 12.
Assert that "needs at least two tasks" with num_tasks >= 2.
For updates repetitions {
  all tasks send a 4 byte message to task 0 then
  all tasks send a 25 byte message to task 0 then
  task 0 multicasts a 25 byte message to all other tasks then
  all tasks compute for 25 milliseconds then
  all tasks allreduce a 58.75 MiB message then
  all tasks allreduce a 58.75 MiB message then
  all tasks allreduce a 58.75 MiB message then
  all tasks allreduce a 58.75 MiB message
}
""",
    paper_ranks=512,
    small_ranks=64,
    overrides_small=(("updates", 4),),
)

NN = WorkloadSpec(
    name="nn",
    source="""
# Nearest Neighbor: 3-D cartesian halo exchange, 128 KiB nonblocking [paper §IV-B]
Require language version "1.5".
iters is "Iterations" and comes from "--iters" with default 60.
For iters repetitions {
  all tasks exchange a 128 KiB message with their neighbors in a 8x8x8 grid then
  all tasks compute for 2 milliseconds
}
""",
    paper_ranks=512,
    small_ranks=64,
    overrides_small=(("iters", 8),),
)

NN_SMALL_SRC = NN.source.replace("8x8x8", "4x4x4")

MILC = WorkloadSpec(
    name="milc",
    source="""
# MILC: 4-D lattice QCD halo exchange, 486 KiB nonblocking send/recv [paper §IV-B]
Require language version "1.5".
iters is "CG iterations" and comes from "--iters" with default 40.
For iters repetitions {
  all tasks exchange a 486 KiB message with their neighbors in a 8x8x8x8 grid then
  all tasks compute for 3 milliseconds
}
""",
    paper_ranks=4096,
    small_ranks=256,
    overrides_small=(("iters", 6),),
)

MILC_SMALL_SRC = MILC.source.replace("8x8x8x8", "4x4x4x4")

NEKBONE = WorkloadSpec(
    name="nekbone",
    source="""
# Nekbone: conjugate-gradient solve — many tiny 8-byte allreduces plus
# mid-size neighbor exchanges (8 B .. 165 KiB) [paper §IV-B]
Require language version "1.5".
iters is "CG iterations" and comes from "--iters" with default 50.
For iters repetitions {
  all tasks allreduce a 8 byte message then
  all tasks exchange a 70 KiB message with their neighbors in a 13x13x13 grid then
  all tasks allreduce a 8 byte message then
  all tasks compute for 1 milliseconds
}
""",
    paper_ranks=2197,
    small_ranks=216,
    overrides_small=(("iters", 8),),
)

NEKBONE_SMALL_SRC = NEKBONE.source.replace("13x13x13", "6x6x6")

LAMMPS = WorkloadSpec(
    name="lammps",
    source="""
# LAMMPS: molecular dynamics — small allreduces, halo exchange 4 B..135 KiB,
# blocking send / nonblocking receive [paper §IV-B]
Require language version "1.5".
iters is "MD steps" and comes from "--iters" with default 50.
For iters repetitions {
  all tasks exchange a 64 KiB message with their neighbors in a 16x16x8 grid then
  all tasks allreduce a 8 byte message then
  all tasks compute for 2 milliseconds
}
""",
    paper_ranks=2048,
    small_ranks=128,
    overrides_small=(("iters", 8),),
)

LAMMPS_SMALL_SRC = LAMMPS.source.replace("16x16x8", "8x4x4")

SPECS: Dict[str, WorkloadSpec] = {
    w.name: w for w in [COSMOFLOW, ALEXNET, NN, MILC, NEKBONE, LAMMPS]
}

_SMALL_SRC = {
    "nn": NN_SMALL_SRC,
    "milc": MILC_SMALL_SRC,
    "nekbone": NEKBONE_SMALL_SRC,
    "lammps": LAMMPS_SMALL_SRC,
}


def get_source(name: str, scale: str = "paper") -> Tuple[str, int, Dict]:
    spec = SPECS[name]
    if scale == "paper":
        return spec.source, spec.paper_ranks, dict(spec.overrides_paper)
    src = _SMALL_SRC.get(name, spec.source)
    return src, spec.small_ranks, dict(spec.overrides_small)


def build_skeleton(name: str, scale: str = "paper", overrides: Optional[Dict] = None):
    """DSL source -> parsed -> translated skeleton (auto-registered)."""
    src, ranks, ov = get_source(name, scale)
    ov.update(overrides or {})
    return translate_source(src, f"{name}_{scale}", ranks, ov)


def build_application(name: str, scale: str = "paper", overrides: Optional[Dict] = None):
    """The 'full application' reference run for validation (§V)."""
    from repro_torch.core.interp import run_source

    src, ranks, ov = get_source(name, scale)
    ov.update(overrides or {})
    return run_source(src, name, ranks, ov)
