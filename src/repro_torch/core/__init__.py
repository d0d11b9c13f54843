"""GAMA core: the paper's planning library (counterpart of ``repro/core``,
copied module for module; pure Python, no torch).

Faithful AIE2 path (validates against the paper's tables):
    hw.AIE2Device, gemm_model, tile_search.search_aie_tiles,
    buffer_placement (Algorithm 1), pack, array_map, aiesim, paper_tables.

The JAX package's deployment path, kept for its planner (the cascade
sweep the pack prior ranks with):
    hw.TpuChip, tile_search.search_tpu_tiles, planner (GamaPlan).

The card's model is ``hw.H100_SXM``; on one card the Hopper counterpart of
``planner.plan_local_tiles`` is the tuner's GEMM op
(``repro_torch.tuning``).
"""

from repro_torch.core import hw
from repro_torch.core.gemm_model import GemmShape, gamma, memory_utilization
from repro_torch.core.planner import (GamaPlan, GemmSite, best_block_schedule,
                                      best_cascade, plan_block_schedules,
                                      plan_cascade, plan_local_tiles,
                                      plan_model)
from repro_torch.core.tile_search import (PAPER_TILES, TpuTilePlan,
                                          best_aie_tile, search_aie_tiles,
                                          search_tpu_tiles)

__all__ = [
    "hw", "GemmShape", "gamma", "memory_utilization",
    "GamaPlan", "GemmSite", "best_block_schedule", "best_cascade",
    "plan_block_schedules", "plan_cascade", "plan_local_tiles", "plan_model",
    "PAPER_TILES", "TpuTilePlan", "best_aie_tile", "search_aie_tiles",
    "search_tpu_tiles",
]
