"""Checkpointing: async save, atomic commit, restore by path (counterpart
of ``repro/checkpoint/manager.py``, with its on-disk layout).

Layout: ``<dir>/step_<N>/`` with one ``.npy`` per leaf (the leaf's path
with ``/`` written as ``__``) and a ``manifest.json`` mapping each path to
its file, shape and true dtype.  Writes go to a ``.tmp`` directory that is
renamed atomically, so a crash mid-save never corrupts the latest
checkpoint; the oldest checkpoints beyond ``keep`` are removed.  The
snapshot to host memory is taken when :meth:`CheckpointManager.save` is
called (training then updates its tensors in place) and written on a
background thread.

torch tensors go through numpy; bf16, which numpy cannot hold, is saved as
f32 with ``bfloat16`` in the manifest, as the reference saves ml_dtypes
arrays.  A checkpoint written by either package restores into the other's
tree of the same paths and shapes.  Restore loads leaves by path, checks
each shape and puts each on the template leaf's device and dtype; leaves
the template does not have are dropped.

A NamedTuple (the optimizer's ``OptState``) is written by field index
(``opt/0``, ``opt/1/...``), which is what the reference writes too, and is
read back by index.  The reference reads it back by field name
(``manager.py:169-172``), finds none of its leaves and keeps the
template's: its restore drops the optimizer state (ROADMAP Queue C).
Its ``latest_step`` also does not wait for a write in flight, so a
restart soon after a save may miss it; here it waits.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

PyTree = Any


def _flatten_with_paths(tree: PyTree) -> Dict[str, Any]:
    flat = {}

    def walk(path, node):
        if node is None:          # optional subtrees (e.g. no master copy)
            return
        if isinstance(node, dict):
            for k, v in node.items():
                walk(path + (str(k),), v)
        elif isinstance(node, (list, tuple)):   # NamedTuples by index too
            for i, v in enumerate(node):
                walk(path + (str(i),), v)
        else:
            flat["/".join(path)] = node
    walk((), tree)
    return flat


def _to_host(x: Any) -> np.ndarray:
    """A host copy that later in-place updates of ``x`` do not reach."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.to("cpu", torch.float32, copy=True).numpy()
        return x.to("cpu", copy=True).numpy()
    return np.array(x)


def _true_dtype(x: Any) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).replace("torch.", "")
    return str(np.asarray(x).dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save

    def save(self, step: int, tree: PyTree, blocking: bool = False) -> None:
        """Snapshot to host memory now; write to disk asynchronously."""
        flat = _flatten_with_paths(tree)
        host = {k: (_to_host(v), _true_dtype(v)) for k, v in flat.items()}
        self.wait()
        self._thread = threading.Thread(
            target=self._write_guarded, args=(step, host), daemon=True)
        self._thread.start()
        if blocking:
            self.wait()

    def wait(self) -> None:
        """Join the writer; re-raise what it failed with, if anything."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint write failed") from err

    def _write_guarded(self, step, host) -> None:
        try:
            self._write(step, host)
        except Exception as e:  # noqa: BLE001 — reported by wait()
            self._error = e

    def _write(self, step: int, host: Dict[str, Tuple[np.ndarray, str]]
               ) -> None:
        final = os.path.join(self.dir, f"step_{step:09d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {}
        for key, (arr, true_dtype) in host.items():
            fname = key.replace("/", "__") + ".npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest[key] = {"file": fname, "shape": list(arr.shape),
                             "dtype": true_dtype}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump({"step": step, "leaves": manifest}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)       # atomic commit
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore

    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        """The newest committed step, after any write in flight commits
        (a restart right after a save must find that save)."""
        self.wait()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: PyTree, step: Optional[int] = None
                ) -> Tuple[PyTree, int]:
        """Load into the structure of ``template`` (values replaced): each
        leaf by path, its shape checked, on the template leaf's device and
        in its dtype.  Template leaves the checkpoint lacks are kept."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)["leaves"]
        flat_t = _flatten_with_paths(template)
        leaves = {}
        for key, spec in manifest.items():
            if key not in flat_t:
                continue                      # extra leaf dropped
            arr = np.load(os.path.join(path, spec["file"]))
            tmpl = flat_t[key]
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                 f"template {tuple(tmpl.shape)}")
            if isinstance(tmpl, torch.Tensor):
                leaves[key] = torch.from_numpy(arr).to(device=tmpl.device,
                                                       dtype=tmpl.dtype)
            else:
                leaves[key] = arr.astype(np.asarray(tmpl).dtype)
        return _rebuild(template, leaves), step


def _rebuild(template: PyTree, leaves: Dict[str, Any],
             path: Tuple[str, ...] = ()) -> PyTree:
    if isinstance(template, dict):
        return {k: _rebuild(v, leaves, path + (str(k),))
                for k, v in template.items()}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*(
            _rebuild(v, leaves, path + (str(i),))
            for i, v in enumerate(template)))
    if isinstance(template, list):
        return [_rebuild(v, leaves, path + (str(i),))
                for i, v in enumerate(template)]
    if isinstance(template, tuple):
        return tuple(_rebuild(v, leaves, path + (str(i),))
                     for i, v in enumerate(template))
    return leaves.get("/".join(path), template)
