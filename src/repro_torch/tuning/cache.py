"""Persistent tuning cache (counterpart of ``repro/tuning/cache.py``):
schema-versioned JSON, loaded once, saved atomically.

One file holds every tuned entry for a machine, keyed by ``(op, M, N, K,
dtype, backend, device_kind)`` in the reference's key format
(:func:`cache_key` returns the reference's string for the same
arguments).  The same problem on another backend (the CPU, or another
card) tunes independently.

The file layout is ``{"schema": N, "entries": {key: entry}}``.  A schema
mismatch, or an unreadable file, discards the whole cache rather than let
stale configs drive the kernels.

The port's cache is a file of its own (``$REPRO_TORCH_TUNING_CACHE``, else
``~/.cache/repro_torch/tuning_cache.json``) with its own schema numbers:
its GEMM and attention entries hold Hopper plans where the JAX package's
hold Pallas tiles, both packages key CPU entries with backend ``cpu``, and
each discards a file of another schema, so a shared file would let each
destroy or misread the other's entries.

Schema history:

* **v1** — ops ``gemm`` (a ``kernels/gemm.Plan``), ``attention`` (a
  ``kernels/flash_attention.Plan``, keyed with ``extra="h{hq}x{hkv}"``),
  ``decode`` (the chunk of ``decode_chunk``), ``wkv`` (the chunk of
  ``wkv_chunk``), and the reference's ``pack`` (v3 fields) and ``serve``
  (v8 fields).
"""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path
from typing import Any, Dict, Optional

SCHEMA_VERSION = 1

_ENV_VAR = "REPRO_TORCH_TUNING_CACHE"


def default_cache_path() -> Path:
    """Cache location: $REPRO_TORCH_TUNING_CACHE, else
    ~/.cache/repro_torch/tuning_cache.json."""
    env = os.environ.get(_ENV_VAR)
    if env:
        return Path(env).expanduser()
    return Path("~/.cache/repro_torch/tuning_cache.json").expanduser()


def cache_key(op: str, m: int, n: int, k: int, dtype: str, backend: str,
              device_kind: str, extra: str = "") -> str:
    """Canonical key.  ``extra`` carries op-specific context (e.g. mesh
    shape for the pack op, the GQA heads for attention) without widening
    the common schema.  Ops with fewer than three shape dims reuse the
    slots as the reference does (decode stores (Sk, D) as m/n with k=1).

    >>> cache_key("gemm", 512, 256, 128, "bfloat16", "cpu", "cpu")
    'gemm|m512|n256|k128|bfloat16|cpu|cpu'
    >>> cache_key("pack", 8, 8, 8, "f32", "cpu", "cpu", extra="mesh2x4")
    'pack|m8|n8|k8|f32|cpu|cpu|mesh2x4'
    """
    key = f"{op}|m{m}|n{n}|k{k}|{dtype}|{backend}|{device_kind}"
    return f"{key}|{extra}" if extra else key


class TuningCache:
    """Load-once, save-atomically JSON cache of tuned kernel configs."""

    def __init__(self, path: Optional[Path] = None):
        self.path = Path(path) if path is not None else default_cache_path()
        self.entries: Dict[str, Dict[str, Any]] = {}
        self._loaded = False

    # -- persistence --------------------------------------------------------

    def load(self) -> "TuningCache":
        self._loaded = True
        self.entries = {}
        try:
            raw = json.loads(self.path.read_text())
        except (OSError, ValueError):
            return self
        if not isinstance(raw, dict) or raw.get("schema") != SCHEMA_VERSION:
            # Version mismatch: discard rather than misinterpret.
            return self
        entries = raw.get("entries")
        if isinstance(entries, dict):
            self.entries = entries
        return self

    def save(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        payload = {"schema": SCHEMA_VERSION, "entries": self.entries}
        fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                   prefix=self.path.name, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    # -- access -------------------------------------------------------------

    def _ensure_loaded(self) -> None:
        if not self._loaded:
            self.load()

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        self._ensure_loaded()
        entry = self.entries.get(key)
        from repro_torch.obs import count
        count("tuning.cache_hit" if entry is not None
              else "tuning.cache_miss")
        return entry

    def put(self, key: str, entry: Dict[str, Any]) -> None:
        self._ensure_loaded()
        self.entries[key] = entry

    def clear(self) -> int:
        """Drop all entries and delete the backing file.  Returns count."""
        self._ensure_loaded()
        n = len(self.entries)
        self.entries = {}
        try:
            self.path.unlink()
        except OSError:
            pass
        return n

    def __len__(self) -> int:
        self._ensure_loaded()
        return len(self.entries)
