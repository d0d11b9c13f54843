"""GamaPlan — end-to-end GEMM planning for the TPU deployment target.

This is the paper's methodology re-targeted:

* single AIE  -> per-core Pallas tile plan (:func:`plan_local_tiles`),
* pack (G)    -> *cascade parallelism*: K-sharding a GEMM over a subgroup
                 of G devices of the `model` mesh axis, partial sums moved
                 by reduce-scatter (the TPU's cascade stream),
* (Y, G, X)   -> mesh mapping: Y = `data` axis (shards M), the `model`
                 axis factored into G (K-shard) x X (N-shard),
* PLIO limits -> ICI time; the pack-size sweep (Fig. 6) becomes a G sweep
                 whose cost curve trades cascade collective bytes against
                 weight-shard HBM pressure and compute granularity.

The planner produces *static* plans from shapes only — it never touches
device state — so it can be used at config time, inside tests, and by
the dry-run driver alike.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.core import hw
from repro_torch.core.tile_search import TpuTilePlan, search_tpu_tiles

# ---------------------------------------------------------------------------
# Sites and local tiling
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GemmSite:
    """One GEMM in the model: C[M,N] = A[M,K] @ B[K,N] (global shapes)."""

    name: str
    m: int
    k: int
    n: int
    precision: hw.Precision = hw.BF16_BF16

    @property
    def flops(self) -> int:
        return 2 * self.m * self.k * self.n


def plan_local_tiles(site: GemmSite, chip: hw.TpuChip = hw.TPU_V5E,
                     dp: int = 1, g: int = 1, x: int = 1) -> TpuTilePlan:
    """Tile plan for the per-device shard of a (possibly sharded) site."""
    m = max(1, site.m // dp)
    k = max(1, site.k // g)
    n = max(1, site.n // x)
    return search_tpu_tiles(m, k, n, site.precision, chip)


# ---------------------------------------------------------------------------
# Cascade (pack) planning across the model axis
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CascadeChoice:
    """One (G, X) factoring of the model axis for a GEMM site."""

    g: int              # cascade width (K-shard subgroup size)
    x: int              # N-shard width
    compute_s: float
    hbm_s: float
    ici_s: float        # cascade reduce-scatter + any activation gather
    local_tile: TpuTilePlan

    @property
    def step_s(self) -> float:
        """Pipelined steady state: compute overlaps HBM; ICI mostly does
        not overlap the GEMM it terminates."""
        return max(self.compute_s, self.hbm_s) + self.ici_s

    @property
    def gamma(self) -> float:
        """Paper-style compute/communication ratio for the sharded GEMM."""
        denom = max(self.hbm_s, self.ici_s, 1e-30)
        return self.compute_s / denom


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def plan_cascade(site: GemmSite, data_axis: int, model_axis: int,
                 chip: hw.TpuChip = hw.TPU_V5E,
                 gather_input_over_g: bool = False) -> List[CascadeChoice]:
    """Sweep G over divisors of the model axis (the Fig. 6 analogue).

    For a choice (G, X = model/G):
      * weights shard (K/G, N/X); activations shard M over `data`;
      * each subgroup of G devices produces partial sums of the (M/dp,
        N/X) output block; a reduce-scatter over the G subgroup combines
        them (ring: (G-1)/G of the block crosses ICI);
      * if the input activation is not already K-sharded,
        ``gather_input_over_g`` adds an all-gather over G.
    """
    p = site.precision
    out: List[CascadeChoice] = []
    m_local = max(1, site.m // data_axis)
    for g in _divisors(model_axis):
        x = model_axis // g
        k_local = max(1, site.k // g)
        n_local = max(1, site.n // x)
        flops_local = 2 * m_local * k_local * n_local
        compute_s = flops_local / chip.peak_ops(p)
        hbm_bytes = (m_local * k_local + k_local * n_local) * p.in_bytes \
            + m_local * n_local * p.out_bytes
        hbm_s = hbm_bytes / chip.hbm_bw
        # Cascade reduce-scatter of the partial output over the G subgroup.
        out_block = m_local * n_local * p.out_bytes
        ici_bytes = out_block * (g - 1) / g
        if gather_input_over_g and g > 1:
            in_block = m_local * k_local * p.in_bytes
            ici_bytes += in_block * (g - 1) / g
        ici_s = ici_bytes / chip.ici_bw
        out.append(CascadeChoice(
            g=g, x=x, compute_s=compute_s, hbm_s=hbm_s, ici_s=ici_s,
            local_tile=plan_local_tiles(site, chip, data_axis, g, x)))
    return out


def best_cascade(site: GemmSite, data_axis: int, model_axis: int,
                 chip: hw.TpuChip = hw.TPU_V5E, **kw) -> CascadeChoice:
    choices = plan_cascade(site, data_axis, model_axis, chip, **kw)
    return min(choices, key=lambda c: c.step_s)


# ---------------------------------------------------------------------------
# Transformer-block collective schedules (the array-level analogue)
# ---------------------------------------------------------------------------

#: How the per-layer tensor-parallel collectives are decomposed.
SCHEDULE_ALLREDUCE = "allreduce"     # classic Megatron: AR after out/down proj
SCHEDULE_RS_AG = "rs_ag"             # reduce-scatter + all-gather (seq-par)
SCHEDULE_CASCADE_2D = "cascade_2d"   # G x X factoring with subgroup RS


@dataclasses.dataclass(frozen=True)
class BlockSchedule:
    schedule: str
    g: int
    x: int
    ici_bytes_per_layer: float   # per device
    ici_s_per_layer: float
    note: str = ""


def plan_block_schedules(tokens_per_dp: int, d_model: int, d_ff: int,
                         model_axis: int,
                         precision: hw.Precision = hw.BF16_BF16,
                         chip: hw.TpuChip = hw.TPU_V5E
                         ) -> List[BlockSchedule]:
    """Collective bytes per transformer layer for each schedule.

    Counts the attention-out and FFN-down partial-sum combines (the two
    K-sharded GEMMs per layer under tensor parallelism).  Ring collectives:
    all-reduce moves 2*(W-1)/W of the tensor per device, reduce-scatter and
    all-gather (W-1)/W each.
    """
    w = model_axis
    act = tokens_per_dp * d_model * precision.out_bytes
    frac = (w - 1) / w
    out: List[BlockSchedule] = []
    # Classic all-reduce: 2 ARs per layer (attn out + mlp down).
    ar_bytes = 2 * (2 * frac * act)
    out.append(BlockSchedule(SCHEDULE_ALLREDUCE, g=w, x=w,
                             ici_bytes_per_layer=ar_bytes,
                             ici_s_per_layer=ar_bytes / chip.ici_bw,
                             note="Megatron TP; AR = RS+AG bytes, "
                                  "not overlappable, activations replicated"))
    # RS + AG (sequence parallel): same bytes, but activations stay sharded
    # between the pair, memory drops, and the AG can overlap the next GEMM.
    rsag_bytes = 2 * (2 * frac * act)
    out.append(BlockSchedule(SCHEDULE_RS_AG, g=w, x=w,
                             ici_bytes_per_layer=rsag_bytes,
                             ici_s_per_layer=rsag_bytes / chip.ici_bw * 0.5,
                             note="RS+AG; AG overlaps next GEMM (0.5 factor)"))
    # 2D cascade: factor W = G x X; K-shard only over G so the combine is a
    # subgroup RS of (G-1)/G — fewer bytes when G < W — at the cost of
    # an X-subgroup AG of the (already G-scattered) activations.
    for g in _divisors(w):
        if g in (1,) or g == w:
            continue
        x = w // g
        g_frac = (g - 1) / g
        x_frac = (x - 1) / x
        bytes_ = 2 * (g_frac * act + x_frac * act)
        out.append(BlockSchedule(
            SCHEDULE_CASCADE_2D, g=g, x=x,
            ici_bytes_per_layer=bytes_,
            ici_s_per_layer=bytes_ / chip.ici_bw,
            note=f"subgroup RS over G={g} + AG over X={x}"))
    return out


def best_block_schedule(*args, **kw) -> BlockSchedule:
    return min(plan_block_schedules(*args, **kw),
               key=lambda s: s.ici_s_per_layer)


# ---------------------------------------------------------------------------
# Whole-model plan summary (used by configs/launch)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GamaPlan:
    """A resolved plan: local tiles per site + the block schedule."""

    sites: Dict[str, TpuTilePlan]
    schedule: BlockSchedule
    data_axis: int
    model_axis: int

    def describe(self) -> str:
        lines = [f"GamaPlan(data={self.data_axis}, model={self.model_axis}, "
                 f"schedule={self.schedule.schedule} G={self.schedule.g} "
                 f"X={self.schedule.x})"]
        for name, t in self.sites.items():
            lines.append(f"  {name}: tile ({t.tm}x{t.tk}x{t.tn}) "
                         f"vmem={t.vmem_bytes/2**20:.1f}MiB gamma={t.gamma:.2f}")
        return "\n".join(lines)


def plan_model(sites: List[GemmSite], tokens_per_dp: int, d_model: int,
               d_ff: int, data_axis: int, model_axis: int,
               chip: hw.TpuChip = hw.TPU_V5E,
               schedule: Optional[str] = None) -> GamaPlan:
    scheds = plan_block_schedules(tokens_per_dp, d_model, d_ff, model_axis,
                                  chip=chip)
    if schedule is not None:
        pick = next(s for s in scheds if s.schedule == schedule)
    else:
        pick = min(scheds, key=lambda s: s.ici_s_per_layer)
    tiles = {}
    for s in sites:
        tiles[s.name] = plan_local_tiles(s, chip, data_axis,
                                         pick.g, pick.x)
    return GamaPlan(sites=tiles, schedule=pick, data_axis=data_axis,
                    model_axis=model_axis)
