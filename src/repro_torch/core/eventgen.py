"""Event generator — public API shim.

The paper's event generator is the layer that lets skeleton ranks emit
communication events *in situ* with the simulation. In the port, as in
the JAX package, the rank VM (program counters, collective round
expansion, cumulative blocking counters) and the network tick are fused
into one tick function — the code lives in
``repro_torch.netsim.engine`` (``vm_emit`` and the VM steps of the tick).

This module re-exports the user-facing pieces so the paper's architecture
(Fig. 3: translator | event generator | CODES) maps one-to-one onto the
package layout.
"""
from repro_torch.netsim.engine import (  # noqa: F401
    JobSpec,
    URSpec,
    VMState,
    build_engine,
)
from repro_torch.core.skeleton import OP, SkeletonProgram, available, get, register  # noqa: F401
