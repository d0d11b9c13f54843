"""The paper's own GEMM workloads: Table V array-level sizes (M, K, N)
per precision, as in ``repro/configs/gama_paper.py`` (plain tuples here,
since the reference's ``GemmShape`` lives in its JAX-era ``core``)."""

ARRAY_GEMMS = {
    "int8-int32": (384, 960, 432),
    "int8-int16": (512, 736, 576),
    "int8-int8": (512, 896, 576),
    "bf16-bf16": (512, 384, 576),
}
