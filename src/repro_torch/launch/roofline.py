"""Roofline terms of a dry-run step, against the H100's rates.

compute   = FLOPs a device / 989e12             [bf16 dense peak, H100 SXM]
memory    = bytes a device / 3.35e12            [HBM3]
collective= wire bytes a device / 450e9         [NVLink, per direction]

(the rates are :mod:`repro_torch.launch.mesh`'s). The port's copy of the
JAX package's ``launch/roofline.py``: :func:`collective_stats` still
reads HLO text (the reference's dry-run artifacts), and
:func:`collective_stats_from_comms` applies the same ring factors to the
collectives that the port's dry run records as its step runs (kind,
output bytes, group size).
"""
from __future__ import annotations

import re
from collections import defaultdict
from typing import Any, Dict, Iterable, Tuple

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "token": 0, "f8e4m3fn": 1, "f8e5m2": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COLLECTIVE_KINDS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)


def _shape_bytes(shape_str: str) -> int:
    """bytes of 'bf16[2048,5120]' (tuple shapes handled by caller)."""
    m = _SHAPE_RE.match(shape_str.strip())
    if not m:
        return 0
    dt, dims = m.groups()
    nbytes = _DTYPE_BYTES.get(dt, 4)
    n = 1
    for d in dims.split(","):
        if d:
            n *= int(d)
    return n * nbytes


def _group_size(line: str, total_devices: int) -> int:
    m = re.search(r"replica_groups=\{\{([^}]*)\}", line)
    if m:
        return len(m.group(1).split(","))
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]", line)  # iota v2 format
    if m:
        return int(m.group(2))
    return total_devices


def _wire_bytes(kind: str, out_bytes: float, n: int) -> float:
    """Bytes a device puts on the wire for one collective of ``kind``
    whose output is ``out_bytes``, over a group of ``n`` (ring
    algorithms)."""
    n = max(n, 1)
    ring = (n - 1) / n
    if kind == "all-gather":
        return out_bytes * ring
    if kind == "reduce-scatter":
        return out_bytes * (n - 1)  # input = out*n; wire = in*(n-1)/n
    if kind == "all-reduce":
        return 2 * out_bytes * ring
    if kind == "all-to-all":
        return out_bytes * ring
    return out_bytes  # collective-permute


def _stats(per_kind_bytes, per_kind_count) -> Dict[str, Any]:
    return {
        "wire_bytes_per_device": sum(per_kind_bytes.values()),
        "by_kind_bytes": dict(per_kind_bytes),
        "by_kind_count": dict(per_kind_count),
    }


def collective_stats(hlo_text: str, total_devices: int) -> Dict[str, Any]:
    """Sum wire bytes per device for each collective kind."""
    per_kind_bytes: Dict[str, float] = defaultdict(float)
    per_kind_count: Dict[str, int] = defaultdict(int)
    for line in hlo_text.splitlines():
        s = line.strip()
        m = re.match(r"(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\([^)]*\)|[\w\[\],]+)\s+([\w\-]+)", s)
        if not m:
            continue
        shape_part, opname = m.groups()
        kind = None
        for ck in _COLLECTIVE_KINDS:
            if opname == ck or opname.startswith(ck + "-"):
                # exclude -start/-done duplicates: count only -start or plain
                if opname.endswith("-done"):
                    kind = None
                    break
                kind = ck
                break
        if kind is None:
            continue
        # output bytes (tuple shapes: sum elements)
        if shape_part.startswith("("):
            inner = shape_part[1:-1]
            out_bytes = sum(_shape_bytes(p) for p in inner.split(", "))
        else:
            out_bytes = _shape_bytes(shape_part)
        n = max(_group_size(s, total_devices), 1)
        per_kind_bytes[kind] += _wire_bytes(kind, out_bytes, n)
        per_kind_count[kind] += 1
    return _stats(per_kind_bytes, per_kind_count)


def collective_stats_from_comms(records: Iterable[Tuple[str, float, int]],
                                n_devices: int) -> Dict[str, Any]:
    """:func:`collective_stats` of the collectives a run recorded: each
    record (kind, output bytes, group size), the kind one of
    ``_COLLECTIVE_KINDS``; a group size of 0 means every device."""
    per_kind_bytes: Dict[str, float] = defaultdict(float)
    per_kind_count: Dict[str, int] = defaultdict(int)
    for kind, out_bytes, n in records:
        if kind not in _COLLECTIVE_KINDS:
            raise ValueError(f"unknown collective kind {kind!r}")
        per_kind_bytes[kind] += _wire_bytes(kind, out_bytes, n or n_devices)
        per_kind_count[kind] += 1
    return _stats(per_kind_bytes, per_kind_count)


def roofline_terms(
    *,
    flops_per_device: float,
    bytes_per_device: float,
    wire_bytes_per_device: float,
    peak_flops: float = PEAK_FLOPS_BF16,
    hbm_bw: float = HBM_BW,
    ici_bw: float = NVLINK_BW,
) -> Dict[str, float]:
    compute_s = flops_per_device / peak_flops
    memory_s = bytes_per_device / hbm_bw
    collective_s = wire_bytes_per_device / ici_bw
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
    }
    dominant = max(terms, key=terms.get)
    bound = max(compute_s, memory_s, collective_s)
    terms.update(
        dominant=dominant,
        step_lower_bound_s=bound,
        roofline_fraction=compute_s / bound if bound > 0 else 0.0,
    )
    return terms


def model_flops(cfg, n_tokens: int, kind: str = "train") -> float:
    """6·N_active·D (training) or 2·N_active·D (single forward/decode)."""
    n_active = cfg.active_param_count()
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active * n_tokens
