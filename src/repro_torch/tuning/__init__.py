"""repro_torch.tuning — the port's empirical autotuner with analytic
pruning (counterpart of ``repro/tuning``).

* :mod:`~repro_torch.tuning.space` — the plans each of the port's kernels
  takes (the design space), and the reference's pack and serve spaces;
* :mod:`~repro_torch.tuning.prior` — ranks candidates: today's plan
  first, the rest by a model of the card; the reference's pack and serve
  scores;
* :mod:`~repro_torch.tuning.runner` — times survivors on the card (CUDA
  graphs between CUDA events), each held bit for bit to the analytic
  plan's output and within tolerance of the plain version;
* :mod:`~repro_torch.tuning.cache` — persistent, schema-versioned JSON
  cache in the reference's key format, in a file of its own;
* :mod:`~repro_torch.tuning.dispatch` — the hot path: memo, then cache,
  then analytic, consulted by ``kernels.ops.matmul`` / ``attention`` and
  warmed by the serving engine;
* :mod:`~repro_torch.tuning.cli` —
  ``python -m repro_torch.tuning.cli {tune,show,clear}``.
"""

from repro_torch.tuning.cache import (SCHEMA_VERSION, TuningCache, cache_key,
                                      default_cache_path)
from repro_torch.tuning.dispatch import (attention_blocks, decode_block,
                                         gemm_config, pack_config, reset,
                                         set_cache_path, warm_gemm_shapes,
                                         wkv_chunk)
from repro_torch.tuning.space import (AttentionCandidate, DecodeCandidate,
                                      DesignSpace, GemmCandidate,
                                      PackCandidate, ServeCandidate,
                                      WkvCandidate)

__all__ = [
    "SCHEMA_VERSION", "TuningCache", "cache_key", "default_cache_path",
    "attention_blocks", "decode_block", "gemm_config", "pack_config",
    "reset", "set_cache_path", "warm_gemm_shapes", "wkv_chunk",
    "AttentionCandidate", "DecodeCandidate", "DesignSpace",
    "GemmCandidate", "PackCandidate", "ServeCandidate", "WkvCandidate",
]
