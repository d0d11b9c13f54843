"""The port's kernels: hand-written CUDA for Hopper beside their plain
PyTorch versions, and the ``ops`` dispatch wrappers over them."""

from repro_torch.kernels import decode_attention, flash_attention, gemm, wkv

# Every ported kernel: its wrapper's module and the name of the launch
# counter there (flash_decode and flash_paged_decode share a module and
# count apart, as do wkv6 and its backward).
KERNEL_COUNTERS = {
    "gama_gemm": (gemm, "launches"),
    "flash_attention": (flash_attention, "launches"),
    "flash_decode": (decode_attention, "launches"),
    "flash_paged_decode": (decode_attention, "paged_launches"),
    "wkv6": (wkv, "launches"),
    "wkv6_bwd": (wkv, "bwd_launches"),
}


def launch_counts() -> dict:
    return {name: getattr(mod, attr)
            for name, (mod, attr) in KERNEL_COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNEL_COUNTERS.values():
        setattr(mod, attr, 0)
