"""Fault-tolerant training loop (counterpart of
``repro/training/trainer.py``) on one card.

* ``make_train_step``: loss, gradients by torch autograd (attention, the
  norms and wkv6 through their kernels' ``autograd.Function``s, every GEMM
  as a plain matrix product, as the reference's training path), gradient
  accumulation over microbatches, then the AdamW update in place;
* checkpoint every N steps (async, atomic) and automatic restart: a step
  failure restores the latest checkpoint and replays from it;
* straggler detection: per-step wall-time EMA; a step slower than
  ``straggler_factor`` x EMA is recorded.

The reference's shardings and int8 gradient compression wait for the
multi-device slice (ROADMAP Queue A item 12).
"""

from __future__ import annotations

import dataclasses
import tempfile
import time
from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import loss_fn as model_loss_fn
from repro_torch.optim import adamw


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None   # None: a new temporary directory
    ckpt_keep: int = 3
    straggler_factor: float = 3.0
    straggler_ema: float = 0.9
    max_restarts: int = 3
    log_every: int = 10


class StragglerMonitor:
    """EMA-based step-time anomaly detector."""

    def __init__(self, factor: float, ema: float):
        self.factor = factor
        self.ema_coef = ema
        self.ema: Optional[float] = None
        self.events = []

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = (self.ema is not None
                        and dt > self.factor * self.ema)
        if is_straggler:
            self.events.append({"step": step, "dt": dt, "ema": self.ema})
        else:
            # Stragglers do not poison the EMA.
            self.ema = dt if self.ema is None else \
                self.ema_coef * self.ema + (1 - self.ema_coef) * dt
        return is_straggler


def _to_device(batch: Dict[str, Any], device: torch.device
               ) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    grad_accum: int = 1, remat: bool = True,
                    remat_policy: str = "full") -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics); params and moments are updated in place.  ``batch`` holds
    numpy or torch arrays and goes to the params' device.

    With grad_accum > 1 the global batch is split along axis 0 into
    microbatches; gradients average in f32 (a + g / grad_accum, as the
    reference)."""

    def train_step(params, opt_state, batch):
        if "table_t" in params["embed"]:
            raise ValueError("train the tree of models.train_tree: a tied "
                             "table's serving layout table_t would be a "
                             "second leaf with a gradient of its own")
        leaves = adamw.leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        batch = _to_device(batch, leaves[0].device)
        if grad_accum == 1:
            loss, metrics = model_loss_fn(params, batch, cfg, remat=remat,
                                          remat_policy=remat_policy)
            grads = list(torch.autograd.grad(loss, leaves))
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            n = next(iter(batch.values())).shape[0] // grad_accum
            grads = [torch.zeros_like(p, dtype=torch.float32)
                     for p in leaves]
            lsum = torch.zeros((), device=leaves[0].device)
            for i in range(grad_accum):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                loss, _ = model_loss_fn(params, mb, cfg, remat=remat,
                                        remat_policy=remat_policy)
                g = torch.autograd.grad(loss, leaves)
                with torch.no_grad():
                    grads = [a + b.float() / grad_accum
                             for a, b in zip(grads, g)]
                    lsum = lsum + loss.detach() / grad_accum
            metrics = {"ce": lsum, "aux": torch.zeros_like(lsum)}
        params, opt_state, opt_metrics = adamw.update(opt_cfg, grads,
                                                      opt_state, params)
        metrics.update(opt_metrics)
        metrics["loss"] = metrics.get("ce")
        return params, opt_state, metrics

    return train_step


class Trainer:
    """Loop with checkpoint/restart fault tolerance."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig,
                 opt_cfg: adamw.AdamWConfig, params, opt_state,
                 data_iter_fn: Callable[[int], Iterator[Dict]],
                 train_step: Callable,
                 failure_hook: Optional[Callable[[int], None]] = None):
        self.cfg, self.tcfg, self.opt_cfg = cfg, tcfg, opt_cfg
        self.params, self.opt_state = params, opt_state
        self.data_iter_fn = data_iter_fn
        self.train_step = train_step
        self.failure_hook = failure_hook
        self.ckpt_dir = tcfg.ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
        self.ckpt = CheckpointManager(self.ckpt_dir, keep=tcfg.ckpt_keep)
        self.straggler = StragglerMonitor(tcfg.straggler_factor,
                                          tcfg.straggler_ema)
        self.metrics_log = []
        self.restarts = 0

    def _state_tree(self):
        return {"params": self.params, "opt": self.opt_state}

    def _restore(self) -> int:
        tree, step = self.ckpt.restore(self._state_tree())
        self.params, self.opt_state = tree["params"], tree["opt"]
        return step

    def run(self, start_step: int = 0) -> Dict[str, Any]:
        step = start_step
        if self.ckpt.latest_step() is not None and start_step == 0:
            step = self._restore()
        data = self.data_iter_fn(step)
        while step < self.tcfg.steps:
            batch = next(data)
            t0 = time.monotonic()
            try:
                if self.failure_hook is not None:
                    self.failure_hook(step)   # test fault injection
                self.params, self.opt_state, metrics = self.train_step(
                    self.params, self.opt_state, batch)
                loss = float(metrics["loss"])
                if np.isnan(loss):
                    raise FloatingPointError(f"NaN loss at step {step}")
            except Exception as e:  # noqa: BLE001 — any step failure
                self.restarts += 1
                if self.restarts > self.tcfg.max_restarts:
                    raise RuntimeError(
                        f"exceeded max_restarts: {e}") from e
                restored = self.ckpt.latest_step()
                if restored is None:
                    # No checkpoint yet: restart from the current state.
                    step = start_step
                else:
                    step = self._restore()
                data = self.data_iter_fn(step)
                continue
            dt = time.monotonic() - t0
            self.straggler.observe(step, dt)
            if step % self.tcfg.log_every == 0:
                self.metrics_log.append(
                    {"step": step, "loss": loss, "dt": dt,
                     "grad_norm": float(metrics["grad_norm"])})
            step += 1
            if step % self.tcfg.ckpt_every == 0:
                self.ckpt.save(step, self._state_tree())
        self.ckpt.save(step, self._state_tree(), blocking=True)
        return {
            "final_step": step,
            "restarts": self.restarts,
            "straggler_events": self.straggler.events,
            "metrics": self.metrics_log,
        }
