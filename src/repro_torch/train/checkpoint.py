"""Fault-tolerant checkpointing (the port's copy of
repro.train.checkpoint, same protocol):

  * ATOMIC: write into `step_XXXXXXXX.tmp/`, fsync the manifest, then
    os.rename -> a reader never sees a partial checkpoint; a crash
    mid-save leaves the previous checkpoint intact, and a leftover `.tmp`
    directory is never read.
  * ASYNC: the copy of every leaf to host memory runs on the caller (a
    copy also for CPU tensors, which the trainer then updates in place),
    file I/O on one daemon thread; a save waits for the previous one.
  * TOPOLOGY-FREE: the manifest stores the logical tree (names, shapes,
    dtypes); `restore` places every leaf on the caller's device.
  * GC: keep the last `keep` checkpoints.

Leaves are saved as `.npy`; bf16 leaves are widened to f32 on disk (exact)
and cast back to the target's dtype on restore.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.train import tree


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # ---------------- save ----------------

    def save(self, step: int, state: Any) -> None:
        self.wait()
        flat = tree.flatten_with_paths(state)
        names = ["/".join(str(k) for k in path) for path, _ in flat]
        host = [_host(t) for _, t in flat]
        dtypes = [str(t.dtype).replace("torch.", "") for _, t in flat]

        def _write():
            tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
            final = os.path.join(self.dir, f"step_{step:08d}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest = {"step": step, "leaves": []}
            for i, (name, arr, dt) in enumerate(zip(names, host, dtypes)):
                fn = f"leaf_{i:05d}.npy"
                np.save(os.path.join(tmp, fn), arr)
                manifest["leaves"].append(
                    {"name": name, "file": fn, "shape": list(arr.shape),
                     "dtype": dt})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)          # atomic publish
            self._gc()

        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        for s in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---------------- restore ----------------

    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, target: Any, step: Optional[int] = None,
                device=None) -> Any:
        """The checkpoint at `step` (default: the latest) in the structure
        of `target`, each leaf in its target's dtype, on `device` (default:
        the target leaf's device)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = tree.leaves(target)
        if len(manifest["leaves"]) != len(leaves):
            raise ValueError(
                f"checkpoint has {len(manifest['leaves'])} leaves, "
                f"target has {len(leaves)}")
        out = []
        for rec, tgt in zip(manifest["leaves"], leaves):
            arr = np.load(os.path.join(path, rec["file"]))
            if list(arr.shape) != list(tgt.shape):
                raise ValueError(
                    f"{rec['name']}: checkpoint {arr.shape} vs "
                    f"{tuple(tgt.shape)}")
            out.append(torch.from_numpy(arr).to(
                device=tgt.device if device is None else device,
                dtype=tgt.dtype))
        return tree.unflatten(target, out)
