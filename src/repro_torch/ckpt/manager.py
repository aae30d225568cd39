"""Atomic, keep-N, asynchronous checkpoints in ``repro.ckpt``'s layout.

Layout::

    <dir>/step_000000042.tmp-<nonce>/   (written; the manifest fsync'd)
        MANIFEST.json                    (step, key paths, shapes, dtypes)
        arr_00000.npy ...                (one file per leaf, bf16 as uint16)
    <dir>/step_000000042/                (atomic rename = commit point)

* **Order**: leaves are stored in JAX's flatten order (sorted dict keys,
  NamedTuple fields in order, no leaves for ``None``; see
  :mod:`repro_torch.tree`).  A restore reads them in that order against a
  template tree of the caller's and checks each shape and dtype, so a
  checkpoint written by the reference's ``CheckpointManager`` restores into
  the port's ``TrainState``.  The reference records its structure as a
  pickled JAX ``PyTreeDef``, which the port never unpickles; the port
  records its key paths instead, and the reference cannot restore a
  checkpoint without its ``treedef``.
* **Atomicity**: a checkpoint is visible iff the directory rename completed;
  partial ones are removed when a manager opens the directory.
* **Async**: ``save(..., blocking=False)`` copies every leaf to host memory
  first (a copy also on the CPU, so that an in-place update after the call
  cannot reach the snapshot) and writes from a background thread; ``wait``
  joins it and raises what it raised.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import uuid

import numpy as np
import torch

from ..tree import tree_paths, tree_unflatten

__all__ = ["CheckpointManager"]

_STEP_RE = re.compile(r"^step_(\d{9})$")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = directory
        self.keep_n = keep_n
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._gc_tmp()

    # -- write --------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = True) -> None:
        self.wait()
        pairs = tree_paths(tree)
        host = [_to_host(t) for _, t in pairs]
        manifest = {
            "step": int(step),
            "paths": [p for p, _ in pairs],
            "n_leaves": len(host),
            "dtypes": [_dtype_name(t.dtype) for _, t in pairs],
            "shapes": [list(t.shape) for _, t in pairs],
            "time": time.time(),
        }

        def commit():
            tmp = os.path.join(self.dir, f"step_{step:09d}.tmp-"
                                         f"{uuid.uuid4().hex[:8]}")
            os.makedirs(tmp)
            for i, arr in enumerate(host):
                np.save(os.path.join(tmp, f"arr_{i:05d}.npy"), arr,
                        allow_pickle=False)
            with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            final = os.path.join(self.dir, f"step_{step:09d}")
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # atomic commit
            self._gc_old()

        if blocking:
            commit()
            return

        def run():
            try:
                commit()
            except Exception as e:  # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the pending asynchronous save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("asynchronous checkpoint save failed") from err

    # -- read ---------------------------------------------------------------
    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "MANIFEST.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def restore(self, template, step: int | None = None, device=None):
        """Returns (step, tree): ``template``'s structure with the stored
        leaves, on ``device`` (default: each template leaf's own; a template
        on the ``meta`` device needs one).  Raises if the count, a shape, a
        dtype or (for the port's own checkpoints) a key path differs."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "MANIFEST.json")) as f:
            manifest = json.load(f)
        want = tree_paths(template)
        if manifest["n_leaves"] != len(want):
            raise ValueError(f"{path}: {manifest['n_leaves']} leaves, the "
                             f"template has {len(want)}")
        if "paths" in manifest and manifest["paths"] != [p for p, _ in want]:
            raise ValueError(f"{path}: key paths differ from the template's")
        leaves = []
        for i, (key, t) in enumerate(want):
            got = (manifest["dtypes"][i], manifest["shapes"][i])
            if got != (_dtype_name(t.dtype), list(t.shape)):
                raise ValueError(f"{path} leaf {i} ({key}): stored {got[0]} "
                                 f"{got[1]}, template {_dtype_name(t.dtype)} "
                                 f"{list(t.shape)}")
            arr = np.load(os.path.join(path, f"arr_{i:05d}.npy"),
                          allow_pickle=False)
            dev = device if device is not None else t.device
            if torch.device(dev).type == "meta":
                raise ValueError("a template on the meta device needs a "
                                 "device to restore to")
            leaves.append(_from_host(arr, got[0]).to(dev))
        return step, tree_unflatten(template, leaves)

    # -- GC -----------------------------------------------------------------
    def _gc_old(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    def _gc_tmp(self):
        for name in os.listdir(self.dir):
            if ".tmp-" in name:
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)
