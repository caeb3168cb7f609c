"""Shared by metric readers: a metric that reads the same quantity as
another, in cells that report another end-to-end metric, reuses its
reader (``read = same_as("<metric>")``)."""
from __future__ import annotations

import importlib.util
from pathlib import Path

METRICS = Path(__file__).resolve().parent / "metrics"


def same_as(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), METRICS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
