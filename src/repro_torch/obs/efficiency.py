"""Roofline-efficiency telemetry (counterpart of
``repro/obs/efficiency.py``) — the analogue of the paper's %-of-peak
figures.

GAMA's headline results are efficiency numbers: 85% of the chip's int8
peak and 86% of its bf16 peak, i.e. *achieved throughput divided by the
Eq. 1/Eq. 6 analytic peak*.  This module computes the same ratio:

* ``gemm_efficiency`` — one (M, K, N) GEMM's achieved FLOP/s over the
  device peak;
* ``serve_efficiency`` — the serving level: achieved decode tokens/s
  times the model's GEMM FLOPs per token, over the device peak.

The peak comes from the hardware models in :mod:`repro_torch.core.hw`,
picked by the ``backend`` the caller names (the engine passes its
device's type; nothing here probes for a card):

* ``"cuda"`` — :data:`~repro_torch.core.hw.H100_SXM`.  Unlike the
  reference's two chip models, f32 maps to the card's own f32 peak
  (67 TFLOP/s on the SIMT cores) and not to the bf16 floor: the port's
  f32 path never touches the tensor cores, so the bf16 roof would
  overstate it about 15x;
* ``"tpu"`` — the TPU chip model;
* anything else (``"cpu"``) — the paper's VE2802 AIE device, the
  *reference* peak, so CPU runs report honestly minuscule efficiencies
  instead of pretending the host is an accelerator.

``"cpu"`` and ``"tpu"`` give the reference's values exactly.  FLOP
accounting is GEMM-only (the projections + lm head — the terms Eq. 1
models); attention score/value FLOPs and normalizations are excluded, so
the serving figure is a floor.
"""

from __future__ import annotations

from repro_torch.core import hw


def precision_for_dtype(dtype_name: str, backend: str = "cpu"
                        ) -> hw.Precision:
    """Map a compute dtype to the nearest Precision pair of ``backend``'s
    model.

    >>> precision_for_dtype("int8").name
    'int8-int8'
    >>> precision_for_dtype("bfloat16").name
    'bf16-bf16'
    >>> precision_for_dtype("float32").name
    'bf16-bf16'
    >>> precision_for_dtype("float32", backend="cuda").name
    'f32-f32'
    """
    if dtype_name.startswith(("int", "uint")):
        return hw.INT8_INT8
    if backend == "cuda" and dtype_name in ("float32", "f32"):
        return hw.F32_F32
    # bf16 is the widest native MAC precision both of the reference's
    # device models carry; f32 activations rate-limit to it (documented
    # floor).
    return hw.BF16_BF16


def peak_flops(dtype_name: str, backend: str) -> float:
    """Analytic peak ops/s of ``backend``'s device model: the H100 on
    ``"cuda"``, the TPU chip model on ``"tpu"``, else the paper's VE2802
    reference chip."""
    p = precision_for_dtype(dtype_name, backend)
    if backend == "cuda":
        return hw.H100_SXM.peak_ops(p)
    if backend == "tpu":
        return hw.TPU_V5E.peak_ops(p)
    return hw.VE2802.peak_ops(p)


def gemm_efficiency(m: int, k: int, n: int, us_per_call: float,
                    dtype_name: str, backend: str) -> float:
    """Achieved FLOP/s of one timed GEMM over the analytic peak.

    >>> peak = peak_flops("bf16", backend="cpu")
    >>> us_at_peak = 2 * 64**3 / peak * 1e6
    >>> round(gemm_efficiency(64, 64, 64, us_at_peak, "bf16", "cpu"), 6)
    1.0
    """
    if us_per_call <= 0:
        raise ValueError(f"us_per_call must be > 0, got {us_per_call}")
    achieved = 2.0 * m * k * n / (us_per_call / 1e6)
    return achieved / peak_flops(dtype_name, backend)


def model_flops_per_token(cfg) -> float:
    """GEMM FLOPs one decode token costs through a ``ModelConfig``:
    the per-layer projections (fused qkv, out, ffn up/gate/down) times
    ``n_layers``, plus the lm head."""
    qkv_n = (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.d_head
    per_layer = (cfg.d_model * qkv_n                      # fused qkv
                 + cfg.n_heads * cfg.d_head * cfg.d_model  # out proj
                 + 2 * cfg.d_model * cfg.d_ff              # ffn up + gate
                 + cfg.d_ff * cfg.d_model)                 # ffn down
    lm_head = cfg.d_model * cfg.vocab_size
    return 2.0 * (cfg.n_layers * per_layer + lm_head)


def serve_efficiency(cfg, tok_s: float, backend: str) -> float:
    """The serving level's %-of-peak: achieved decode throughput
    (tokens/s) x GEMM FLOPs per token, over the analytic peak for the
    model's compute dtype."""
    if tok_s <= 0:
        raise ValueError(f"tok_s must be > 0, got {tok_s}")
    achieved = tok_s * model_flops_per_token(cfg)
    dtype = getattr(cfg, "compute_dtype", "bfloat16")
    return achieved / peak_flops(dtype, backend)
