"""Synthetic deterministic LM data pipeline: a copy of
``repro/data/pipeline.py`` (numpy only), so ``batch_at(step)`` gives the
reference's batches bit for bit.

Design constraints for thousand-node training:
  * **Deterministic & restart-safe**: batch for step t is a pure function
    of (seed, t) — after a checkpoint restore at step t the stream resumes
    identically, with no data-state to save beyond the step counter.
  * **Shardable**: batches are generated globally and device_put against
    the policy's batch sharding; on a real multi-host cluster each host
    generates only its addressable shard (same counter-based RNG makes
    this trivially consistent).
  * **Prefetch**: a background thread keeps `prefetch` batches ready.

The token distribution is Zipfian with a Markov flavour (next token
depends on the previous one), so the LM loss has real structure to learn —
quickstart.py demonstrates loss decreasing on it.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3


class SyntheticLM:
    """Counter-based synthetic LM stream: batch(t) = f(seed, t)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # A fixed random bigram shift table gives the stream its structure.
        rng = np.random.default_rng(cfg.seed)
        self._shift = rng.integers(0, cfg.vocab_size,
                                   size=(1024,), dtype=np.int64)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step]))
        # Zipf body tokens, clipped into vocab.
        z = rng.zipf(cfg.zipf_a,
                     size=(cfg.global_batch, cfg.seq_len + 1)).astype(np.int64)
        toks = np.minimum(z - 1, cfg.vocab_size - 1)
        # Markov structure: token_t += shift[token_{t-1} % 1024].
        toks[:, 1:] = (toks[:, 1:] + self._shift[toks[:, :-1] % 1024]) \
            % cfg.vocab_size
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def iterate(self, start_step: int = 0,
                prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
        """Prefetching iterator starting at `start_step` (restart-safe)."""
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def worker():
            t = start_step
            while not stop.is_set():
                q.put(self.batch_at(t))
                t += 1

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def host_shard(batch: Dict[str, np.ndarray], host_id: int,
               n_hosts: int) -> Dict[str, np.ndarray]:
    """The slice of a global batch a given host would generate/feed.

    (Single-process here; on a real cluster each host calls this on its
    own generated batch — determinism makes the shards consistent.)
    """
    def cut(x):
        per = x.shape[0] // n_hosts
        return x[host_id * per:(host_id + 1) * per]
    return {k: cut(v) for k, v in batch.items()}
