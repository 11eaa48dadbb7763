"""Structured benchmark output: the ``BENCH_*.json`` schema.

Port of ``src/repro/bench_schema.py``, copied so the port imports nothing of
the reference: the same rows and the same ``config_hash``, so a row written
by either package reads and compares in the other.  Every emitter
(``repro_torch/launch/serve.py --json``, :class:`repro_torch.run.BenchHook`)
writes the same machine-readable row format so results are comparable across
commits and gateable in CI (``benchmarks/bench_gate.py``):

    {"schema": "bench.v1", "rows": [
        {"name": "kernels/fused_apply/speedup",
         "value": 7.1, "unit": "x", "config": "<12-hex config hash>",
         "meta": {"gate": "higher", "tol": 0.25, ...}}, ...]}

``name`` is a stable slash-separated identifier; ``config`` hashes the exact
cell configuration so a row is only comparable to a baseline produced from
the same configuration.  ``meta.gate`` marks a row as regression-gated
("higher" = larger is better, e.g. speedups; "lower" = smaller is better,
e.g. wall-clock) with relative tolerance ``meta.tol`` (default 0.25).
Rows without ``meta.gate`` are informational.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any

SCHEMA_VERSION = "bench.v1"

__all__ = [
    "SCHEMA_VERSION",
    "config_hash",
    "bench_row",
    "write_bench_json",
    "read_bench_json",
    "validate_rows",
]


def config_hash(config: dict[str, Any] | str) -> str:
    """12-hex digest of a canonicalized config dict (or a pre-hashed string)."""
    if isinstance(config, str):
        return config
    blob = json.dumps(config, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:12]


def bench_row(
    name: str, value: float, unit: str, config: dict[str, Any] | str, **meta: Any
) -> dict:
    """One schema row; ``meta`` carries free-form context (gate, tol, series)."""
    row = {
        "name": str(name),
        "value": float(value),
        "unit": str(unit),
        "config": config_hash(config),
    }
    if meta:
        row["meta"] = meta
    return row


def write_bench_json(path: str, rows: list[dict]) -> str:
    """Validate + write a ``BENCH_*.json`` file; returns the path."""
    validate_rows(rows)
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump({"schema": SCHEMA_VERSION, "rows": rows}, f, indent=2, sort_keys=False)
        f.write("\n")
    return path


def read_bench_json(path: str) -> list[dict]:
    with open(path) as f:
        doc = json.load(f)
    if doc.get("schema") != SCHEMA_VERSION:
        raise ValueError(f"{path}: unknown schema {doc.get('schema')!r}")
    rows = doc.get("rows")
    if not isinstance(rows, list):
        raise ValueError(f"{path}: missing rows list")
    validate_rows(rows)
    return rows


def validate_rows(rows: list[dict]) -> None:
    """Raise ValueError unless every row matches the bench.v1 row schema."""
    seen: set[str] = set()
    for i, row in enumerate(rows):
        if not isinstance(row, dict):
            raise ValueError(f"row {i}: not an object")
        for key, typ in (("name", str), ("unit", str), ("config", str)):
            if not isinstance(row.get(key), typ):
                raise ValueError(f"row {i}: missing/invalid {key!r}")
        value = row.get("value")
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            raise ValueError(f"row {i} ({row['name']}): missing/invalid 'value'")
        if "meta" in row and not isinstance(row["meta"], dict):
            raise ValueError(f"row {i} ({row['name']}): 'meta' must be an object")
        gate = (row.get("meta") or {}).get("gate")
        if gate not in (None, "higher", "lower"):
            raise ValueError(f"row {i} ({row['name']}): gate must be 'higher'|'lower'")
        if row["name"] in seen:
            raise ValueError(f"row {i}: duplicate name {row['name']!r}")
        seen.add(row["name"])
