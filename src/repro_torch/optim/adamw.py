"""AdamW with global-norm clipping and a cosine schedule (counterpart of
``repro/optim/adamw.py``), as plain functions over the param dict.

The optimizer state mirrors the param tree (f32 moments).  The formulas
and their order are the reference's: clip by global norm, the moment
updates, bias correction, then the step with decoupled weight decay
inside it, optionally on an f32 master copy.  Unlike the reference, which
returns new trees, :func:`update` updates params and moments **in place**
(a 3B model's f32 params, gradients and two moments already take ~50 GB)
and works through the leaves in groups with ``torch._foreach_*`` ops, so
the ~800 leaves of a 32-layer model cost a few launches per group rather
than several per leaf, and the temporaries stay the size of one group.
``torch.optim.AdamW`` is not the same function (no global clip, decay
outside the bias-corrected step), so it is not used.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

Params = Any

# Leaves are updated in groups of at most this many elements (1 GiB of
# f32), which bounds the optimizer's temporaries.
GROUP_ELEMENTS = 1 << 28


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    # Mixed precision: live params in a low precision and the f32 master
    # copy inside the optimizer state.
    master_weights: bool = False


class OptState(NamedTuple):
    step: torch.Tensor           # 0-dim int32, on the CPU
    mu: Params
    nu: Params
    master: Optional[Params] = None


def leaves(tree: Params) -> List[torch.Tensor]:
    """The tensors of a param tree (dicts and lists), in a fixed order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn, tree: Params) -> Params:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def init(params: Params, master_weights: bool = False) -> OptState:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    master = None
    if master_weights:
        master = tree_map(lambda p: p.detach().float().clone(), params)
    return OptState(step=torch.zeros((), dtype=torch.int32),
                    mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                    master=master)


def schedule(cfg: AdamWConfig, step: int) -> float:
    """Linear warmup then cosine decay to min_lr_ratio."""
    warm = min(1.0, (step + 1) / max(1, cfg.warmup_steps))
    prog = min(max((step - cfg.warmup_steps)
                   / max(1, cfg.total_steps - cfg.warmup_steps), 0.0), 1.0)
    cos = 0.5 * (1 + math.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every element's square, in f32."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.stack(norms).square().sum().sqrt()


def _groups(*lists: List[torch.Tensor]):
    """Zip the lists and cut them into groups of <= GROUP_ELEMENTS."""
    group, size = [], 0
    for row in zip(*lists):
        if group and size + row[0].numel() > GROUP_ELEMENTS:
            yield tuple(map(list, zip(*group)))
            group, size = [], 0
        group.append(row)
        size += row[0].numel()
    if group:
        yield tuple(map(list, zip(*group)))


@torch.no_grad()
def update(cfg: AdamWConfig, grads: Params, state: OptState, params: Params
           ) -> Tuple[Params, OptState, Dict[str, Any]]:
    """One AdamW step.  ``grads`` is a tree (or list) of gradients in the
    order of ``leaves(params)``; it is consumed (scaled in place).  Returns
    (params, new state, {"grad_norm", "lr"}), params and moments updated in
    place."""
    step = int(state.step)
    g_all = [g if g.dtype == torch.float32 else g.float()
             for g in leaves(grads)]
    gnorm = global_norm(g_all)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    t = step + 1
    c1, c2 = 1 - b1 ** t, 1 - b2 ** t
    lr = schedule(cfg, step)
    p_all = leaves(params)
    target = leaves(state.master) if (cfg.master_weights and
                                      state.master is not None) else p_all
    for g, m, v, p, live in _groups(g_all, leaves(state.mu),
                                    leaves(state.nu), target, p_all):
        torch._foreach_mul_(g, scale)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1 - b2)
        m_hat = torch._foreach_div(m, c1)
        denom = torch._foreach_div(v, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        torch._foreach_div_(m_hat, denom)          # m_hat / (sqrt(v_hat) + eps)
        pf = [x if x.dtype == torch.float32 else x.float() for x in p]
        torch._foreach_add_(m_hat, pf, alpha=cfg.weight_decay)
        torch._foreach_add_(pf, m_hat, alpha=-lr)
        for dst, src in zip(p, pf):
            if dst is not src:
                dst.copy_(src)
        if target is not p_all:
            for dst, src in zip(live, p):
                dst.copy_(src)
    new_state = OptState(step=torch.tensor(t, dtype=torch.int32),
                         mu=state.mu, nu=state.nu, master=state.master)
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
