"""Strict, path-aware spec validation shared by scenario/trace/experiment.

Every JSON-loadable spec in the workload manager funnels its dict through
these helpers so a typo'd key or out-of-range value raises with the exact
path of the offender (``experiment.scenarios[1].jobs[0].startus``) instead
of being silently dropped or surfacing as a bare ``TypeError``.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Type


class SpecError(ValueError):
    """A spec dict failed validation; the message carries the JSON path."""


def check_keys(d: Dict[str, Any], allowed: Iterable[str], path: str,
               kind: str) -> None:
    """Reject unknown keys, naming the offending path and the legal set."""
    unknown = set(d) - set(allowed)
    if unknown:
        raise SpecError(
            f"unknown {kind} keys at {path}: {sorted(unknown)} "
            f"(expected a subset of {sorted(allowed)})"
        )


def check_mapping(d: Any, path: str, kind: str) -> Dict[str, Any]:
    if not isinstance(d, dict):
        raise SpecError(f"{path}: expected a {kind} object, got "
                        f"{type(d).__name__}")
    return d


def dataclass_from_dict(cls: Type, d: Any, path: str, kind: str):
    """Build ``cls(**d)`` with unknown-key and value-range errors reported
    against ``path``; ``cls.validate()`` runs when defined."""
    d = check_mapping(d, path, kind)
    check_keys(d, cls.__dataclass_fields__, path, kind)
    try:
        obj = cls(**d)
    except (TypeError, ValueError) as e:
        raise SpecError(f"{path}: {e}") from e
    validate = getattr(obj, "validate", None)
    if validate is not None:
        reraise_with_path(validate, path)
    return obj


def reraise_with_path(validate, path: str) -> None:
    """Run a spec's ``validate()``; prefix any complaint with the path."""
    try:
        validate()
    except SpecError:
        raise
    except ValueError as e:
        raise SpecError(f"{path}: {e}") from e
