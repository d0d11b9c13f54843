"""PyTorch/CUDA port of the GAMA serving and training stacks, for one
NVIDIA H100.

It mirrors the JAX package ``repro`` module for module (``configs``,
``kernels``, ``models``, ``serving``, ``optim``, ``data``,
``checkpoint``, ``training``, ``launch``) and imports nothing of it.  Its kernels are hand-written CUDA C++ for ``sm_90a`` (``csrc/``),
each beside its plain PyTorch version.  Entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  Asking for CUDA on a host
    without it raises: the port never moves to the CPU by itself."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False; "
            f"pass device='cpu' to run the plain PyTorch versions")
    return dev
