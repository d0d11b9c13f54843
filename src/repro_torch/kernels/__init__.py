"""The port's kernels: hand-written CUDA for Hopper beside their plain
PyTorch versions, and the ``ops`` dispatch wrappers over them."""

from repro_torch.kernels import decode_attention, flash_attention, gemm

# Every ported kernel's wrapper module, each with a ``launches`` counter.
KERNEL_MODULES = {
    "gama_gemm": gemm,
    "flash_attention": flash_attention,
    "flash_decode": decode_attention,
}


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.launches = 0
