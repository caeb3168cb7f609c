"""Content-hash experiment store: simulate every distinct cell once.

The port of the JAX package's ``repro.union.store``, the persistence
layer under the experiment facade: each study **cell** — one ensemble
member or one (trace seed × policy) scheduler run — is keyed by a
canonical SHA-256 fingerprint of everything that determines its result:

* the fully-resolved spec of the cell itself (the grid-substituted
  scenario with its actual arrival schedule, or the materialized trace
  plus policy/slots), including the cell's seed;
* the observability configuration (probes / hist / timeline), because an
  instrumented run carries extra report payloads;
* code-relevant versions: the store layout version, the Results schema
  version, torch's version and CUDA version, and the device type of the
  run (numerics may differ across any of them). The JAX package's
  fingerprints name its jax version and backend instead, so the two
  packages never replay each other's cells, and a run on the CPU never
  replays a run on the card.

:func:`repro_torch.union.experiment.run` consults the store per cell
before each plan node executes and persists fresh :class:`CellResult`s after —
so re-submitting an identical experiment re-executes **zero** cells, and
changing one grid cell re-executes only that cell. Entries are one JSON
file each under ``<root>/cells/<hh>/<hash>.json`` (atomic
write-then-rename; corrupt or version-mismatched entries read as
misses), so a store survives process restarts, is rsync-able, and is
shared safely between processes running against the same directory.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Any, Dict, Optional

import numpy as np

# Bump when engine semantics change in a way the fingerprint inputs do
# not capture (a changed store version invalidates every prior entry).
STORE_VERSION = 1


def code_versions(device=None) -> Dict[str, Any]:
    """The version block baked into every fingerprint: the store and
    Results schema versions, torch's and its CUDA's, and the type of
    ``device``, the run's device (CUDA by default; naming it needs no
    card)."""
    import torch

    from repro_torch.union.experiment import SCHEMA_VERSION

    return dict(
        store=STORE_VERSION,
        results_schema=SCHEMA_VERSION,
        torch=torch.__version__,
        cuda=torch.version.cuda,
        device=torch.device("cuda" if device is None else device).type,
    )


def _digest(payload: Dict[str, Any]) -> str:
    """Canonical content hash: sorted-key, minimal-separator JSON."""
    blob = json.dumps(payload, sort_keys=True, separators=(",", ":"),
                      default=float)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()


def _obs_key(exp) -> Dict[str, Any]:
    """The observability axes that change a cell's report payload."""
    return dict(
        probes=int(exp.probes),
        probe_every=int(exp.probe_every) if exp.probes else None,
        hist=int(exp.hist),
        timeline=bool(exp.timeline),
    )


def _failure_key(cell) -> Optional[Dict[str, Any]]:
    """The failures-axis coordinate, resolved to its full event schedule.

    ``None`` for healthy cells — the key is *omitted* from the payload so
    every pre-failures-axis store entry keeps its fingerprint (healthy
    runs are bit-identical to them).
    """
    fl = getattr(cell, "failure", None)
    if fl is None or fl.is_healthy:
        return None
    return fl.to_dict()


def scenario_fingerprint(exp, cell, device=None) -> str:
    """Fingerprint of one ensemble-member cell (planner ScenarioCell).

    ``start_us`` is the member's *actual* arrival schedule — scenario
    offsets plus any per-member jitter — so ``arrival_jitter_us`` is
    captured without hashing the experiment envelope. Execution strategy
    (``vmapped``, engine envelope) is deliberately excluded: batched,
    sharded and sequential runs are bit-identical (golden-pinned).
    A non-healthy failures-axis coordinate adds its full event schedule
    (healthy cells hash exactly as before the axis existed). ``device``
    is the run's (:func:`code_versions`).
    """
    payload = dict(
        kind="scenario",
        scenario=cell.scenario.to_dict(),
        seed=int(cell.seed),
        member=int(cell.member),
        start_us=[float(x) for x in np.asarray(cell.start_us).ravel()],
        strict=bool(exp.strict),
        obs=_obs_key(exp),
        versions=code_versions(device),
    )
    fk = _failure_key(cell)
    if fk is not None:
        payload["failure"] = fk
    return _digest(payload)


def trace_fingerprint(exp, study, trace, cell, device=None) -> str:
    """Fingerprint of one (trace seed × policy) scheduler cell.

    Hashes the **materialized** trace (synthetic studies redraw arrivals
    per seed, so the draw itself is captured), not the study spec —
    ``batch`` is excluded because lock-stepped and sequential drivers are
    bit-identical (golden-pinned). Non-healthy failures-axis cells add
    their event schedule, exactly like scenario cells. ``device`` is the
    run's (:func:`code_versions`).
    """
    payload = dict(
        kind="trace",
        trace=trace.to_dict(),
        policy=cell.policy,
        seed=int(cell.seed),
        slots=int(study.slots or trace.slots),
        tau_us=float(study.tau_us),
        obs=_obs_key(exp),
        versions=code_versions(device),
    )
    fk = _failure_key(cell)
    if fk is not None:
        payload["failure"] = fk
    return _digest(payload)


class ExperimentStore:
    """A directory of completed cells keyed by content fingerprint.

    ``get``/``put`` are the whole protocol; both are safe under
    concurrent readers and a single writer per entry (atomic
    write-then-rename — and identical fingerprints write identical
    payloads, so even racing writers converge).
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.cells_dir = os.path.join(self.root, "cells")
        os.makedirs(self.cells_dir, exist_ok=True)

    def cell_path(self, fingerprint: str) -> str:
        return os.path.join(
            self.cells_dir, fingerprint[:2], f"{fingerprint}.json")

    def get(self, fingerprint: str):
        """The stored CellResult, or ``None`` (miss / corrupt entry /
        store-version mismatch — all read as misses, never as errors)."""
        from repro_torch.union.experiment import CellResult

        path = self.cell_path(fingerprint)
        try:
            with open(path) as f:
                entry = json.load(f)
            if (entry.get("store_version") != STORE_VERSION
                    or entry.get("fingerprint") != fingerprint):
                return None
            return CellResult(**entry["cell"])
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def put(self, fingerprint: str, cell) -> str:
        """Persist one completed cell (atomic). Returns the entry path."""
        path = self.cell_path(fingerprint)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            dir=os.path.dirname(path), suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(dict(
                    store_version=STORE_VERSION,
                    fingerprint=fingerprint,
                    cell=cell.to_dict(),
                ), f, default=float)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return path

    def stats(self) -> Dict[str, Any]:
        """Entry count + on-disk bytes (walked fresh — the store may be
        shared with other processes)."""
        entries = 0
        size = 0
        for dirpath, _, files in os.walk(self.cells_dir):
            for name in files:
                if name.endswith(".json"):
                    entries += 1
                    try:
                        size += os.path.getsize(os.path.join(dirpath, name))
                    except OSError:
                        pass
        return dict(entries=entries, bytes=size, dir=self.root)

    def gc(self, max_bytes: Optional[int] = None,
           max_age_s: Optional[float] = None) -> Dict[str, Any]:
        """See :func:`store_gc`."""
        return store_gc(self, max_bytes=max_bytes, max_age_s=max_age_s)


def store_gc(store, max_bytes: Optional[int] = None,
             max_age_s: Optional[float] = None) -> Dict[str, Any]:
    """Prune a store to a size cap and/or an age cap.

    ``store`` is an :class:`ExperimentStore` or a root directory path.
    Entries older than ``max_age_s`` (by mtime — the write time; reads
    leave entries untouched) are removed first; then, while the store
    still exceeds ``max_bytes``, the oldest-written entries go — for a
    content-hash store of immutable cells, write age is the eviction
    order that keeps the freshest results. Stale ``.tmp`` files from
    crashed writers are always swept. Returns
    ``{"removed", "freed_bytes", "entries", "bytes"}``.
    """
    import time as _time

    if isinstance(store, str):
        store = ExperimentStore(store)
    now = _time.time()
    entries = []  # (mtime, size, path)
    removed = 0
    freed = 0
    for dirpath, _, files in os.walk(store.cells_dir):
        for name in files:
            path = os.path.join(dirpath, name)
            try:
                st = os.stat(path)
            except OSError:
                continue
            if name.endswith(".tmp"):
                # leftover from a crashed writer: always swept
                try:
                    os.unlink(path)
                    removed += 1
                    freed += st.st_size
                except OSError:
                    pass
                continue
            if not name.endswith(".json"):
                continue
            if max_age_s is not None and now - st.st_mtime > max_age_s:
                try:
                    os.unlink(path)
                    removed += 1
                    freed += st.st_size
                except OSError:
                    pass
                continue
            entries.append((st.st_mtime, st.st_size, path))
    total = sum(sz for _, sz, _ in entries)
    if max_bytes is not None and total > max_bytes:
        entries.sort()  # oldest-written first
        for _, sz, path in entries:
            if total <= max_bytes:
                break
            try:
                os.unlink(path)
            except OSError:
                continue
            total -= sz
            removed += 1
            freed += sz
    after = store.stats()
    return dict(removed=removed, freed_bytes=freed,
                entries=after["entries"], bytes=after["bytes"])
