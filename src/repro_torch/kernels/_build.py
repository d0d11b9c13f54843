"""Build and load the port's CUDA kernels (``src/repro_torch/csrc/*.cu``).

Each ``.cu`` source is compiled by ``nvcc`` into its own shared library
with a plain C interface, loaded through ``ctypes`` — no PyTorch headers,
so a build takes seconds.  Libraries go into ``build/repro_torch/`` at the
repository root, named by a digest of the sources and flags, so an edited
source is rebuilt and an unchanged one is reused.  Nothing is built when
this module is imported: the first kernel launch (or :func:`build`) does
it, and all sources compile in parallel, one ``nvcc`` each.  It also
holds the checks every wrapper makes around a launch (:func:`check`,
:func:`refuse_autograd`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
    PATH, else the toolkit's default install location."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the port's CUDA "
                       "kernels are built on the machine with the card")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest()}.so"


def sources() -> Dict[str, Path]:
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def build(force: bool = False) -> Dict[str, str]:
    """Compile every stale source, all at once; returns each built
    library's compiler log (``-Xptxas -v``: registers, shared memory and
    spills per kernel).  Raises with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {name: src for name, src in sources().items()
            if force or not library_path(name).exists()}
    if not todo:
        return {}
    compiler = nvcc()
    procs = {}
    for name, src in todo.items():
        tmp = library_path(name).with_suffix(f".tmp{os.getpid()}")
        cmd = [compiler, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(src)]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        if name not in sources():
            raise KeyError(f"no kernel source csrc/{name}.cu")
        path = library_path(name)
        if not path.exists():
            build()
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib


def check(lib: ctypes.CDLL, prefix: str, code: int) -> None:
    """Raise if a launch returned a CUDA error code."""
    if code != 0:
        fn = getattr(lib, f"{prefix}_error_string")
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{prefix} launch failed: CUDA error {code} "
                           f"({fn(code).decode()})")


def refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would record a launch: a kernel's output has no
    ``grad_fn``, so a gradient through it would silently be zero.  A
    kernel that is differentiated goes through its own
    ``torch.autograd.Function`` (``kernels.wkv.WKV6``), whose forward runs
    with grad mode off."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but the kernel has no backward "
            f"and its output would carry none; call it under torch.no_grad() "
            f"or use the plain version (mode='ref') to differentiate")
