"""int8 weight-only quantization (counterpart of the weight half of
``repro/serving/quant.py``), owned by the model layer: every weight fetch
goes through :func:`maybe_dequant`.

Per output channel, symmetric.  W[k, n] -> q[k, n] int8 with one f32
scale per output channel n, ``scale = max_k |W[k, n]| / 127``.  The
reference dequantizes on every weight fetch and runs the GEMM in the
compute dtype, so the port's weights are fetched the same way and the
GEMM stays the bf16 ``gama_gemm``: int8 weights cut the resident bytes,
not the GEMM's.  The dequantize is one pass, the ``dequant`` kernel on the
card (int8 read, the compute dtype written, the product taken in f32), as
the reference's XLA fuses its expression into one.  The reference stacks each pattern
position's block weights over ``n_groups`` layers; the port keeps one
dict per layer.  Quantization is per output channel, so the codes and
scales of a layer are the same either way; :func:`quantize_params` takes
``groups`` to select and count the leaves as the reference's stacked tree
does.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.kernels import ops

Params = Dict[str, Any]

# Leaf names that hold (in, out) matmul weights, as the reference's
# (``repro/serving/quant.py:50-58``): "w" and "table", and the MoE expert
# stacks "gate", "up" and "down" ((E, K, N), a scale per expert and
# column; in a dense MLP those names hold dicts, whose leaves are "w").
# The router's "w" is quantized like any other; Mamba's conv_w, a_log and
# d are not.
WEIGHT_KEYS = ("w", "table", "gate", "up", "down")
_MIN_SIZE = 1 << 14      # don't quantize tiny vectors/norms


def quantize_weight(w: torch.Tensor,
                    inplace: bool = False) -> Dict[str, torch.Tensor]:
    """(..., K, N) -> {"q": int8 (..., K, N), "scale": f32 (..., N)}.

    Computed in f32 as the reference: ``torch.round`` rounds half to
    even, as ``jnp.round`` does, and an all-zero channel gets scale 0.
    ``max |w|`` is taken as ``max(max w, -min w)`` and the codes rounded
    and clamped in place, so an f32 weight needs one temporary of its
    size (a Jamba expert stack is 3.76 GB), or none with ``inplace`` (the
    caller's f32 ``w`` is overwritten: a fresh draw that nothing else
    reads)."""
    wf = w.float()
    scale = torch.maximum(wf.amax(dim=-2), -wf.amin(dim=-2)) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = (wf.div_(safe[..., None, :]) if inplace and wf is w
         else torch.div(wf, safe[..., None, :])).round_().clamp_(-127, 127)
    return {"q": q.to(torch.int8), "scale": scale}


def dequantize_weight(qw: Dict[str, torch.Tensor],
                      dtype: torch.dtype) -> torch.Tensor:
    """``(q.float() * scale).to(dtype)``, per output channel: the
    ``dequant`` kernel on the card (``ops.dequantize``)."""
    return ops.dequantize(qw["q"], qw["scale"], dtype)


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and "q" in w and "scale" in w


def maybe_dequant(w: Any, dtype: torch.dtype) -> torch.Tensor:
    """Weight fetch hook: dequantize {"q","scale"} leaves, cast others."""
    if is_quantized(w):
        return dequantize_weight(w, dtype)
    return w if w.dtype == dtype else w.to(dtype)


def _is_quantizable(name: str, leaf: Any, groups: int = 0) -> bool:
    """The reference's selection: floating, at least 2-D, at least 2**14
    elements, named like a matmul weight.  A block leaf (``groups`` > 0)
    is one layer of the reference's stack of ``groups`` layers, which has
    one more axis and ``groups`` times the elements."""
    if not isinstance(leaf, torch.Tensor) or not leaf.is_floating_point():
        return False
    if leaf.dim() + (groups > 0) < 2 or leaf.numel() * max(groups, 1) \
            < _MIN_SIZE:
        return False
    return name in WEIGHT_KEYS


def quantize_params(params: Params, groups: int = 1, enc_groups: int = 0,
                    inplace: bool = False) -> Tuple[Params, Dict[str, int]]:
    """Quantize every large matmul weight of the tree; every other leaf is
    kept as it is.  Returns (params, stats) with the reference's stats
    dict: leaves quantized and kept, and bytes before and after.

    ``groups`` is the model's ``n_groups``: the port's ``blocks`` list
    holds one dict per layer where the reference holds one stack per
    pattern position, so a block leaf is selected by its stacked size and
    counted once per stack (its bytes once per layer); an enc-dec model's
    ``encoder["blocks"]`` likewise, its stack of ``enc_groups`` layers.
    Quantize the f32 parameters, as the reference does: codes and scales
    taken from bf16 copies would differ from its.  ``inplace`` lets each
    f32 weight be overwritten as it is quantized (:func:`quantize_weight`).
    """
    stats = {"quantized": 0, "kept": 0, "bytes_before": 0, "bytes_after": 0}

    def walk(name, node, g, count):
        if isinstance(node, dict):
            return {k: walk(k, v, g, count) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(name, v, g, count) for v in node]
        nbytes = (node.numel() * node.element_size()
                  if isinstance(node, torch.Tensor) else 0)
        stats["bytes_before"] += nbytes
        if _is_quantizable(name, node, g):
            stats["quantized"] += count
            qw = quantize_weight(node, inplace)
            stats["bytes_after"] += qw["q"].numel() + 4 * qw["scale"].numel()
            return qw
        stats["kept"] += count
        stats["bytes_after"] += nbytes
        return node

    def stacks(key, sub, g):
        per_group = len(sub) // g
        return [walk(key, b, g, int(i < per_group))
                for i, b in enumerate(sub)]

    out = {}
    for key, sub in params.items():
        if key == "blocks":
            out[key] = stacks(key, sub, groups)
        elif key == "encoder":
            out[key] = {k: stacks(k, v, enc_groups) if k == "blocks"
                        else walk(k, v, 0, 1) for k, v in sub.items()}
        else:
            out[key] = walk(key, sub, 0, 1)
    return out, stats


def weight_stats(params: Params, period: int, itemsize: int
                 ) -> Dict[str, int]:
    """:func:`quantize_params`' stats read off a tree it already
    quantized, as the reference gives them for its tree of
    ``itemsize``-byte parameters: a leaf or an int8 weight is counted once
    per stack (the first ``period`` layers of ``blocks``, one per pattern
    position; an encoder's first layer), its bytes once per layer, its
    original at ``itemsize`` bytes an element whatever the port stores it
    as; ``table_t``, a second layout of the table, is not a parameter."""
    stats = {"quantized": 0, "kept": 0, "bytes_before": 0, "bytes_after": 0}

    def walk(node, count):
        if is_quantized(node):
            stats["quantized"] += count
            stats["bytes_before"] += node["q"].numel() * itemsize
            stats["bytes_after"] += (node["q"].numel()
                                     + 4 * node["scale"].numel())
        elif isinstance(node, dict):
            for key, v in node.items():
                if key != "table_t":
                    walk(v, count)
        elif isinstance(node, list):
            for v in node:
                walk(v, count)
        else:
            stats["kept"] += count
            stats["bytes_before"] += node.numel() * itemsize
            stats["bytes_after"] += node.numel() * itemsize

    for key, sub in params.items():
        if key == "blocks":
            for i, b in enumerate(sub):
                walk(b, int(i < period))
        elif key == "encoder":
            for i, b in enumerate(sub["blocks"]):
                walk(b, int(i == 0))
            walk(sub["final_norm"], 1)
        else:
            walk(sub, 1)
    return stats
