"""Programmatic reproduction of the paper's tables (II-VI + Fig. 6).

Each function returns rows as dicts with both our value and the paper's
published value so benchmarks can print side-by-side deltas and tests can
assert tolerances.  See aiesim.py for which quantities are exact, which
are predicted from the calibrated stall model, and which are calibration
inputs.
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.core import aiesim, array_map, hw
from repro_torch.core import buffer_placement as bp
from repro_torch.core import pack as pack_mod
from repro_torch.core.gemm_model import (compute_cycles, gamma, memory_bytes,
                                   memory_utilization)
from repro_torch.core.tile_search import PAPER_TILES, search_aie_tiles

# Published numbers (for side-by-side comparison).
PAPER_TABLE2 = {
    # precision: (gamma, mem_usage, mem_util_constrained)
    "int8-int32": (0.72, 64512, 0.98),
    "int8-int16": (0.96, 63488, 0.97),
    "int8-int8": (0.96, 65536, 1.00),
    "bf16-bf16": (0.96, 65536, 1.00),
}
PAPER_TABLE3 = {
    # precision: (theo, uncon, loc, addr) KCC
    "int8-int32": (2160, 2426, 3076, 2590),
    "int8-int16": (2944, 3141, 3923, 3345),
    "int8-int8": (3584, 3686, 4340, 3831),
    "bf16-bf16": (3072, 3135, 3598, 3255),
}
PAPER_TABLE4 = {
    # precision: (uncon, loc, addr) pack KCC at G=4
    "int8-int32": (2665, 3198, 2711),
    "int8-int16": (3326, 4126, 3419),
    "int8-int8": (3980, 4273, 4009),
    "bf16-bf16": (3361, 4340, 3404),
}
PAPER_TABLE5 = {
    # precision: (TOPS/TBFLOPS, TE)
    "int8-int32": (133.0, 0.69),
    "int8-int16": (159.0, 0.82),
    "int8-int8": (165.0, 0.85),
    "bf16-bf16": (83.0, 0.86),
}
PAPER_TABLE6 = {
    # (precision, prior work): improvement in pp
    ("int8-int32", "MaxEVA"): 9.0,
    ("int8-int16", "AMA"): 8.7,
    ("int8-int8", "CHARM"): 53.6,
    ("int8-int8", "ARIES"): 39.0,
}


def table2() -> List[Dict]:
    """Single-AIE kernel sizes: gamma and memory utilization (exact)."""
    rows = []
    for name, shape in PAPER_TILES.items():
        p = hw.PRECISIONS[name]
        pg, pm, pu = PAPER_TABLE2[name]
        rows.append({
            "precision": name, "m": shape.m, "k": shape.k, "n": shape.n,
            "gamma": gamma(shape, p), "paper_gamma": pg,
            "mem_bytes": memory_bytes(shape, p), "paper_mem_bytes": pm,
            "mem_util": memory_utilization(shape, p), "paper_mem_util": pu,
        })
    return rows


def table2_search() -> List[Dict]:
    """What our exhaustive search picks (vs the paper's published tiles)."""
    rows = []
    for name, paper_shape in PAPER_TILES.items():
        p = hw.PRECISIONS[name]
        found = search_aie_tiles(p, top=1)[0]
        rows.append({
            "precision": name,
            "search_m": found.shape.m, "search_k": found.shape.k,
            "search_n": found.shape.n, "search_gamma": found.gamma,
            "search_util": found.mem_utilization,
            "paper_m": paper_shape.m, "paper_k": paper_shape.k,
            "paper_n": paper_shape.n,
            "match": found.shape == paper_shape,
        })
    return rows


def table3() -> List[Dict]:
    rows = []
    for name in PAPER_TILES:
        s = aiesim.simulate_kernel(name)
        theo, uncon, loc, addr = PAPER_TABLE3[name]
        rows.append({
            "precision": name,
            "theoretical_kcc": s.theoretical_kcc, "paper_theoretical": theo,
            "kcc_unconstrained": s.kcc[bp.UNCONSTRAINED], "paper_uncon": uncon,
            "kcc_location": s.kcc[bp.LOCATION], "paper_location": loc,
            "kcc_address": s.kcc[bp.ADDRESS], "paper_address": addr,
            "kce_address": s.kce[bp.ADDRESS],
            "recovered_pp": (s.kce[bp.ADDRESS] - s.kce[bp.LOCATION]) * 100,
        })
    return rows


def table4(g: int = 4) -> List[Dict]:
    rows = []
    for name in PAPER_TILES:
        s = aiesim.simulate_pack(name, g)
        uncon, loc, addr = PAPER_TABLE4[name]
        rows.append({
            "precision": name, "g": g,
            "pack_kcc_unconstrained": s.kcc[bp.UNCONSTRAINED],
            "paper_uncon": uncon,
            "pack_kcc_location": s.kcc[bp.LOCATION], "paper_location": loc,
            "pack_kcc_address": s.kcc[bp.ADDRESS], "paper_address": addr,
            "cascade_stall": s.cascade_stall,
            "pack_kce_address": s.kce[bp.ADDRESS],
        })
    return rows


def fig6(name: str = "int8-int8") -> List[Dict]:
    rows = aiesim.fig6_curve(name)
    lo, hi = pack_mod.scalable_window()
    for r in rows:
        r["window"] = (lo, hi)
    return rows


def table5() -> List[Dict]:
    rows = []
    for name in PAPER_TILES:
        a = aiesim.simulate_array(name)
        tops, te = PAPER_TABLE5[name]
        rows.append({
            "precision": name,
            "M": a.gemm.m, "K": a.gemm.k, "N": a.gemm.n,
            "throughput_tops": a.throughput_ops / 1e12, "paper_tops": tops,
            "te": a.te, "paper_te": te,
            "engines": a.cfg.engines,
            "utilization": a.utilization,
            "plio_in": a.cfg.plio_in, "plio_out": a.cfg.plio_out,
            "y": a.cfg.y, "g": a.cfg.g, "x": a.cfg.x,
        })
    return rows


def table6() -> List[Dict]:
    rows = aiesim.table6_comparison()
    for r in rows:
        key = (r["precision"], r["prior_work"])
        r["paper_improvement_pp"] = PAPER_TABLE6.get(key)
    return rows


def staggered_placement() -> List[Dict]:
    """Fig. 7: skew sweep for the final (Y=8, G=4, X=9) configuration."""
    cfg = array_map.best_array_config()
    rows = []
    for skew in range(cfg.g):
        o = array_map.evaluate_skew(cfg, skew)
        rows.append({
            "skew": skew,
            "min_adjacent_separation": o.min_adjacent_separation,
            "routes": o.routes, "engines_used": o.engines_used,
            "utilization": o.utilization,
        })
    chosen = array_map.choose_skew(cfg)
    for r in rows:
        r["chosen"] = r["skew"] == chosen.skew
    return rows
