"""Design spaces for the autotuner (counterpart of
``repro/tuning/space.py``): for each op, the set of plans the port's
kernel takes, never the TPU's tiles.

* **gemm** — every :class:`~repro_torch.kernels.gemm.Plan` of
  ``gemm.candidates``: row and column tiles, the K slices as a cluster or
  walked by one block, and the ring's depth.  The K walk (``splits_for``)
  is fixed by (K, N, dtype), so every candidate sums each output in the
  same order and gives the same bits, and a row's result stays
  independent of its batch.  f32 has one candidate (``SIMT_PLAN``).
* **attention** — ``flash_attention.candidates``: query rows a block,
  packed GQA heads and ring depth.  ``kv_tile`` is fixed by (D, dtype),
  so a prompt gives the same bits whole or in chunks.
* **decode** — one candidate, ``decode_chunk(d, kv_dtype)`` keys a
  chunk.  The kernels refuse any other value: the chunk fixes the order
  in which a slot's partial states are merged, and paged decode must
  equal dense decode bit for bit.
* **wkv** — one candidate, ``wkv_chunk(t, n, dtype)`` steps a chunk.
  The kernels refuse any other value: the chunking fixes the sums of the
  chunked scan, and a restarted training run must repeat its bits.
* **pack** and **serve** — the reference's spaces, copied: pure Python,
  the same candidate lists.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from repro_torch.kernels import decode_attention, flash_attention, gemm, wkv

# Canonical dtype spellings accepted by the CLI and the dispatch calls.
_DTYPE_ALIASES = {
    "bf16": "bfloat16", "f32": "float32", "fp32": "float32",
    "f16": "float16", "fp16": "float16", "i8": "int8",
}


def canonical_dtype(dtype) -> str:
    """'bf16' / torch.bfloat16 -> 'bfloat16' (the reference's names).

    >>> canonical_dtype("bf16"), canonical_dtype(torch.int8)
    ('bfloat16', 'int8')
    """
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    name = str(dtype)
    return _DTYPE_ALIASES.get(name, name)


def torch_dtype(dtype) -> torch.dtype:
    """A dtype or its name (any spelling :func:`canonical_dtype` takes) as
    a ``torch.dtype``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    found = getattr(torch, canonical_dtype(dtype), None)
    if not isinstance(found, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r} (try bf16, f32, int8)")
    return found


@dataclasses.dataclass(frozen=True)
class GemmCandidate:
    """One launch of ``gama_gemm``: the fields of ``gemm.Plan``."""

    bm: int
    bn: int
    splits: int
    cluster: int
    stages: int

    @property
    def plan(self) -> gemm.Plan:
        return gemm.Plan(self.bm, self.bn, self.splits, self.cluster,
                         self.stages)

    @classmethod
    def from_plan(cls, p: gemm.Plan) -> "GemmCandidate":
        return cls(*p)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "GemmCandidate":
        return cls(bm=int(d["bm"]), bn=int(d["bn"]), splits=int(d["splits"]),
                   cluster=int(d["cluster"]), stages=int(d["stages"]))


@dataclasses.dataclass(frozen=True)
class AttentionCandidate:
    """One launch of ``flash_attention``: the fields of its ``Plan``."""

    route: str
    rows: int
    heads: int
    stages: int
    kv_tile: int

    @property
    def plan(self) -> flash_attention.Plan:
        return flash_attention.Plan(self.route, self.rows, self.heads,
                                    self.stages, self.kv_tile)

    @classmethod
    def from_plan(cls, p: flash_attention.Plan) -> "AttentionCandidate":
        return cls(*p)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "AttentionCandidate":
        return cls(route=str(d["route"]), rows=int(d["rows"]),
                   heads=int(d["heads"]), stages=int(d["stages"]),
                   kv_tile=int(d["kv_tile"]))


@dataclasses.dataclass(frozen=True)
class DecodeCandidate:
    """Keys per chunk of a slot's cache for the decode kernels."""

    bk: int

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "DecodeCandidate":
        return cls(bk=int(d["bk"]))


@dataclasses.dataclass(frozen=True)
class WkvCandidate:
    """Time steps per chunk of the WKV6 kernels."""

    chunk: int

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "WkvCandidate":
        return cls(chunk=int(d["chunk"]))


@dataclasses.dataclass(frozen=True)
class PackCandidate:
    """One point of the pack-level design space (the reference's v3
    fields)."""

    p: int                     # cascade depth: K shards per pack column
    q: int                     # pack columns: N shards (p * q = |model|)
    stagger: int = 1           # ring-schedule offset per column (Fig. 7)
    reduce: str = "ring"       # "ring" (staggered) | "psum" (baseline)
    overlap: bool = False      # K-streamed compute/communicate fusion

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "PackCandidate":
        return cls(p=int(d["p"]), q=int(d["q"]),
                   stagger=int(d.get("stagger", 0)),
                   reduce=str(d.get("reduce", "psum")),
                   overlap=bool(d.get("overlap", False)))


@dataclasses.dataclass(frozen=True)
class ServeCandidate:
    """Continuous-batching engine tunables (the reference's v8 fields):
    ``slots`` requests decode per batched step; ``page_size`` tokens a
    page (0 = the dense per-slot max_len layout); ``kv_dtype`` the page
    dtype ("" keeps the cache dtype, "int8" quantized pages, paged only);
    ``prefill_chunk`` the chunk size (0 = monolithic prefill);
    ``prefix_cache`` radix-tree prefix sharing over pool pages (paged
    only)."""

    slots: int
    page_size: int = 0
    kv_dtype: str = ""
    prefill_chunk: int = 0
    prefix_cache: bool = False

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> "ServeCandidate":
        return cls(slots=int(d["slots"]),
                   page_size=int(d.get("page_size", 0)),
                   kv_dtype=str(d.get("kv_dtype", "")),
                   prefill_chunk=int(d.get("prefill_chunk", 0)),
                   prefix_cache=bool(d.get("prefix_cache", False)))


class DesignSpace:
    """Enumerators over legal candidates for each tunable op."""

    @classmethod
    def gemm(cls, m: int, k: int, n: int,
             dtype: torch.dtype) -> List[GemmCandidate]:
        """Every plan ``gama_gemm`` takes at this shape with its fixed K
        walk (``gemm.candidates``)."""
        return [GemmCandidate.from_plan(p)
                for p in gemm.candidates(m, k, n, dtype)]

    @classmethod
    def attention(cls, hq: int, hkv: int, d: int,
                  dtype: torch.dtype) -> List[AttentionCandidate]:
        """Every plan ``flash_attention`` takes for these heads, head dim
        and dtype (``flash_attention.candidates``)."""
        return [AttentionCandidate.from_plan(p)
                for p in flash_attention.candidates(hq, hkv, d, dtype)]

    @classmethod
    def decode(cls, sk: int, d: int,
               kv_dtype: torch.dtype) -> List[DecodeCandidate]:
        """One point: ``decode_chunk(d, kv_dtype)``.  The chunk fixes the
        order of a slot's partial-state merge, so the kernels refuse any
        other (paged must equal dense bit for bit); ``sk`` does not enter."""
        return [DecodeCandidate(bk=decode_attention.decode_chunk(d, kv_dtype))]

    @classmethod
    def wkv(cls, t: int, n: int, dtype: torch.dtype) -> List[WkvCandidate]:
        """One point: ``wkv_chunk(t, n, dtype)``.  The chunking fixes the
        scan's sums, so the kernels refuse any other (a restart must
        repeat its bits)."""
        return [WkvCandidate(chunk=wkv.wkv_chunk(t, n, dtype))]

    @classmethod
    def pack(cls, m: int, k: int, n: int,
             model_axis: int) -> List[PackCandidate]:
        """Pack-level candidates (the reference's): every (P, Q)
        factorization of the model axis, crossed with the stagger offset,
        the reduce order and the K-streamed overlap bit (ring only; P = 1
        has no cross-device reduce, so only the trivial schedule).

        >>> [(c.p, c.q) for c in DesignSpace.pack(512, 512, 512, 4)
        ...  if c.reduce == "psum" and c.stagger == 0]
        [(1, 4), (2, 2), (4, 1)]
        """
        out: List[PackCandidate] = []
        for p in range(1, model_axis + 1):
            if model_axis % p:
                continue
            q = model_axis // p
            if p == 1:
                out.append(PackCandidate(p=1, q=q, stagger=0,
                                         reduce="psum"))
                continue
            staggers = sorted({0, 1, p // 2})
            for stagger in staggers:
                for overlap in (False, True):
                    out.append(PackCandidate(p=p, q=q, stagger=stagger,
                                             reduce="ring",
                                             overlap=overlap))
            out.append(PackCandidate(p=p, q=q, stagger=0, reduce="psum"))
        return out

    SERVE_SLOTS: Sequence[int] = (1, 2, 4, 8, 16, 32)
    SERVE_PAGE_SIZES: Sequence[int] = (0, 16, 32, 64)   # 0 = dense KV
    SERVE_KV_DTYPES: Sequence[str] = ("", "int8")       # "" = cache dtype
    SERVE_PREFILL_CHUNKS: Sequence[int] = (0, 16, 32)   # 0 = monolithic
    SERVE_PREFIX_CACHE: Sequence[bool] = (False, True)  # paged only

    @classmethod
    def serve(cls, max_slots: int = 32,
              max_len: int = 0) -> List[ServeCandidate]:
        """The reference's serve space: slot counts (powers of two up to
        ``max_slots``, and always 8) crossed with the page size (0 =
        dense; pages of at least twice ``max_len`` excluded), the page
        dtype (paged only), the prefill chunk (paged: a page multiple;
        below ``max_len``) and the prefix-cache bit (paged only).

        >>> [c.slots for c in DesignSpace.serve(max_slots=4)
        ...  if c.page_size == 0 and c.prefill_chunk == 0]
        [1, 2, 4, 8]
        """
        slots = {s for s in cls.SERVE_SLOTS if s <= max(max_slots, 1)}
        slots.add(8)
        pages = [p for p in cls.SERVE_PAGE_SIZES
                 if max_len <= 0 or p == 0 or p < 2 * max_len]
        return [ServeCandidate(slots=s, page_size=p, kv_dtype=kd,
                               prefill_chunk=pc, prefix_cache=px)
                for s in sorted(slots) for p in pages
                for kd in cls.SERVE_KV_DTYPES if p or not kd
                for pc in cls.SERVE_PREFILL_CHUNKS
                if (pc == 0 or ((p == 0 or pc % p == 0)
                                and (max_len <= 0 or pc < max_len)))
                for px in cls.SERVE_PREFIX_CACHE if p or not px]
