"""Exporters and the stable metrics-snapshot schema (counterpart of
``repro/obs/export.py``: the same schema, so ``tools/obs_report.py`` and
``tools/bench_compare.py`` read the port's snapshots unchanged).

Snapshot schema (``schema: 1``) — the machine-readable contract the CI
artifact check and ``tools/bench_compare.py --metrics`` gate against::

    {
      "schema": 1,
      "counters":   {"tuning.cache_hit": 12.0, ...},
      "gauges":     {"kvpool.pages_in_use": {"value": 4.0,
                                             "high_water": 9.0}, ...},
      "histograms": {"serve.ttft_ms": {"count": 6, "sum": ..., "min": ...,
                                       "max": ..., "p50": ..., "p90": ...,
                                       "p99": ..., ["buckets": {...}]},
                     ...}
    }

A writer may add sibling top-level keys (``launch/serve.py`` adds a
``"run"`` section with trace-level figures); validation only constrains
the sections above.  Histogram ``min``/``max``/percentiles are ``null``
while empty — presence of the *series* is the contract, not a sample
count.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, Mapping

from repro_torch.obs.metrics import Registry

SNAPSHOT_SCHEMA = 1

_HIST_KEYS = ("count", "sum", "min", "max", "p50", "p90", "p99")


def validate_snapshot(snap: Mapping, *,
                      required_counters: Iterable[str] = (),
                      required_gauges: Iterable[str] = (),
                      required_histograms: Iterable[str] = ()) -> None:
    """Raise ``ValueError`` unless ``snap`` is a structurally valid
    schema-1 snapshot containing the required series."""
    if not isinstance(snap, Mapping):
        raise ValueError("snapshot is not a mapping")
    if snap.get("schema") != SNAPSHOT_SCHEMA:
        raise ValueError(f"snapshot schema {snap.get('schema')!r} != "
                         f"{SNAPSHOT_SCHEMA}")
    for section in ("counters", "gauges", "histograms"):
        if not isinstance(snap.get(section), Mapping):
            raise ValueError(f"snapshot missing section {section!r}")
    for name, val in snap["counters"].items():
        if not isinstance(val, (int, float)):
            raise ValueError(f"counter {name!r} is not numeric: {val!r}")
    for name, g in snap["gauges"].items():
        if not isinstance(g, Mapping) or "value" not in g \
                or "high_water" not in g:
            raise ValueError(f"gauge {name!r} missing value/high_water")
    for name, h in snap["histograms"].items():
        missing = [k for k in _HIST_KEYS if k not in h]
        if missing:
            raise ValueError(f"histogram {name!r} missing {missing}")
    for kind, table, wanted in (
            ("counter", snap["counters"], required_counters),
            ("gauge", snap["gauges"], required_gauges),
            ("histogram", snap["histograms"], required_histograms)):
        absent = [n for n in wanted if n not in table]
        if absent:
            raise ValueError(f"snapshot missing required {kind}s: "
                             f"{absent} (have {sorted(table)})")


def flatten_snapshot(snap: Mapping) -> Dict[str, float]:
    """Dotted scalar view of a snapshot — what ``bench_compare.py
    --metrics`` ratios.  Counters flatten as-is; gauges contribute
    ``.value``/``.high_water``; histograms contribute every non-null
    summary stat (``.p50``, ``.p99``, ``.count``, ...)."""
    out: Dict[str, float] = {}
    for name, val in snap.get("counters", {}).items():
        out[name] = float(val)
    for name, g in snap.get("gauges", {}).items():
        out[f"{name}.value"] = float(g["value"])
        out[f"{name}.high_water"] = float(g["high_water"])
    for name, h in snap.get("histograms", {}).items():
        for k in _HIST_KEYS:
            v = h.get(k)
            if isinstance(v, (int, float)):
                out[f"{name}.{k}"] = float(v)
    return out


def write_metrics(path: str, registry: Registry, extra: Mapping = None,
                  required_counters: Iterable[str] = (),
                  required_gauges: Iterable[str] = (),
                  required_histograms: Iterable[str] = ()) -> Dict:
    """Write (and return) the registry snapshot, validated (with any
    required series), with ``extra`` merged in as additional top-level
    sections."""
    snap = registry.snapshot()
    if extra:
        for k, v in extra.items():
            if k in ("schema", "counters", "gauges", "histograms"):
                raise ValueError(f"extra section {k!r} collides with the "
                                 f"snapshot schema")
            snap[k] = v
    validate_snapshot(snap, required_counters=required_counters,
                      required_gauges=required_gauges,
                      required_histograms=required_histograms)
    with open(path, "w") as f:
        json.dump(snap, f, indent=1, sort_keys=True)
    return snap


def write_prometheus(path: str, registry: Registry) -> str:
    text = registry.to_prometheus()
    with open(path, "w") as f:
        f.write(text)
    return text
