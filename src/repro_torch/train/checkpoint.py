"""Training checkpoints: atomic, async-capable, keep-last-k (the
counterpart of ``repro/train/checkpoint.py``, with its layout).

Layout (one directory per step):
    <dir>/step_00000042.tmp/...   -> os.rename -> <dir>/step_00000042/
        meta.json                   step, leaf paths and dtypes, extra
        leaf_00000.npy ...          one .npy per leaf of the tree

A partly written checkpoint keeps its ``.tmp`` name, so resume-latest
never sees it.  The async writer snapshots the tree to host memory on
the caller's thread (a copy that waits for the card) and writes the
files on a background thread, off the step's path.  A tree is nested
dicts / lists of tensors (``repro_torch.tree``); bf16 leaves are stored
bit for bit as uint16 with their dtype in the meta.  Checkpoints are not
readable across the two packages (the JAX tree stacks layers, this one
keeps a list; ROADMAP A7).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import leaves, leaves_with_paths, unflatten


def _to_host(t: torch.Tensor):
    """(numpy array, dtype name) of a tensor; bf16 as its uint16 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), str(t.dtype).replace("torch.", "")


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr).to(getattr(torch, dtype))


def _snapshot(tree: Any):
    """(paths, host arrays, dtype names) of every leaf."""
    pairs = leaves_with_paths(tree)
    host = [_to_host(t) for _, t in pairs]
    return (["/".join(map(str, p)) for p, _ in pairs],
            [a for a, _ in host], [d for _, d in host])


def _write(directory: str, step: int, paths, arrays, dtypes,
           extra: Optional[dict]) -> str:
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    for i, arr in enumerate(arrays):
        np.save(os.path.join(tmp, f"leaf_{i:05d}.npy"), arr)
    meta = {"step": step, "paths": paths, "dtypes": dtypes,
            "extra": extra or {}}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra: Optional[dict] = None) -> str:
    """Blocking save.  Returns the final checkpoint path."""
    return _write(directory, step, *_snapshot(tree), extra)


def available_steps(directory: str):
    """The steps of the complete checkpoints in ``directory``, sorted."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(name[5:]) for name in os.listdir(directory)
                  if name.startswith("step_") and not name.endswith(".tmp"))


def load_checkpoint(directory: str, step: Optional[int] = None,
                    template: Any = None):
    """Load (the latest by default).  With ``template`` the leaves come
    back in its structure, each on its template leaf's device; without,
    as a list of host tensors.  Returns ``(tree, meta)``."""
    steps = available_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    step = steps[-1] if step is None else step
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    arrs = [_from_host(np.load(os.path.join(path, f"leaf_{i:05d}.npy")), dt)
            for i, dt in enumerate(meta["dtypes"])]
    if template is None:
        return arrs, meta
    devices = [t.device for t in leaves(template)]
    if len(devices) != len(arrs):
        raise ValueError(f"checkpoint {path} holds {len(arrs)} leaves, the "
                         f"template {len(devices)}")
    return unflatten(template, [a.to(d) for a, d in zip(arrs, devices)]), \
        meta


class CheckpointManager:
    """Async checkpointing with keep-last-k GC and resume-latest.  One
    write is in flight at a time; an error of the background write is
    raised by the next ``wait`` (or ``save_async``)."""

    def __init__(self, directory: str, keep_last: int = 3,
                 save_every: int = 100):
        self.directory = directory
        self.keep_last = keep_last
        self.save_every = save_every
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_every == 0

    def save_async(self, step: int, tree: Any, extra=None):
        """Snapshot on the caller's thread, write on a background thread."""
        self.wait()
        snapshot = _snapshot(tree)

        def work():
            try:
                _write(self.directory, step, *snapshot, extra)
                self._gc()
            except Exception as e:      # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("background checkpoint write failed") from err

    def _gc(self):
        for s in available_steps(self.directory)[:-self.keep_last]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, template):
        """``(tree, meta)`` of the latest complete checkpoint, or ``(None,
        None)`` when there is none."""
        self.wait()
        if not available_steps(self.directory):
            return None, None
        return load_checkpoint(self.directory, template=template)
