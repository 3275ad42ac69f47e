"""Checkpoint/restore with atomic writes, retention, resharding restore
(elastic scaling), and preemption-safe semantics.

The counterpart of the reference's ``checkpoint/checkpointer.py``, in
its on-disk format: ``step_N/arrays.npz`` (the flattened tree, each leaf
keyed by its jax ``keystr`` path, e.g. ``['params']['embed']``) and
``step_N/meta.json`` (step, extra, sorted keys).  Writes go to a temp
dir and are ``rename``d into place, so a partially written checkpoint is
never visible.  An f32 (or integer) tree written by either package
restores bitwise in the other.

bfloat16 leaves: numpy has no bfloat16 without ``ml_dtypes``, which the
port does not import, so a bf16 leaf is stored widened to float32, which
holds every bf16 value exactly; restore casts back to the ``like``
leaf's dtype, so a bf16 tree round-trips bitwise (and the reference
restores such a leaf into its bf16 tree the same way).

Resharding: arrays are saved whole (the logical value); the restore
hands each to ``sharding_fn(key, tensor)`` when the caller gives one, to
re-place it for a new topology (N ranks at save, M at load), and
otherwise puts it on the ``like`` leaf's device in its dtype.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import threading
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from ..tree import keystr, tree_flatten, tree_unflatten

_STEP_RE = re.compile(r"^step_(\d+)$")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree: Any) -> dict:
    paths, leaves = tree_flatten(tree)
    return {keystr(p): _to_numpy(leaf) for p, leaf in zip(paths, leaves)}


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._async_thread: Optional[threading.Thread] = None

    # --------------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             blocking: bool = True) -> str:
        """Atomic save.  ``blocking=False`` runs serialization on a side
        thread (async checkpointing) — call ``wait()`` before the next
        save or at exit."""
        flat = _flatten(tree)   # device->host copy happens here
        meta = {"step": int(step), "extra": extra or {},
                "keys": sorted(flat.keys())}

        def _write():
            tmp = tempfile.mkdtemp(dir=self.directory, prefix=".tmp_")
            try:
                np.savez(os.path.join(tmp, "arrays.npz"), **flat)
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(meta, f)
                final = os.path.join(self.directory, f"step_{step}")
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)   # atomic visibility
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            self._retain()

        if blocking:
            _write()
        else:
            self.wait()
            self._async_thread = threading.Thread(target=_write, daemon=True)
            self._async_thread.start()
        return os.path.join(self.directory, f"step_{step}")

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    def _retain(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"),
                          ignore_errors=True)

    # ------------------------------------------------------------ restore
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "meta.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Any,
                sharding_fn: Optional[Callable[[str, torch.Tensor],
                                               torch.Tensor]] = None
                ) -> tuple[Any, dict]:
        """Restore into the structure of ``like`` (a tree of tensors).
        ``sharding_fn(key, tensor) -> tensor`` lets the caller re-place
        each array under a NEW mesh (elastic resharding); by default each
        goes to its ``like`` leaf's device and dtype.  A ``like`` leaf
        that is not a tensor (a flag) comes back as a Python scalar."""
        path = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        paths, leaves = tree_flatten(like)
        new_leaves = []
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for p, leaf in zip(paths, leaves):
                key = keystr(p)
                if key not in data:
                    raise KeyError(f"checkpoint missing {key}")
                arr = data[key]
                if tuple(arr.shape) != tuple(np.shape(leaf)):
                    raise ValueError(f"{key}: checkpoint shape {arr.shape} "
                                     f"!= {tuple(np.shape(leaf))}")
                if not isinstance(leaf, torch.Tensor):
                    new_leaves.append(arr.item())
                    continue
                t = torch.from_numpy(arr)
                if sharding_fn is not None:
                    new_leaves.append(sharding_fn(key, t))
                else:
                    new_leaves.append(t.to(device=leaf.device,
                                           dtype=leaf.dtype))
        return tree_unflatten(paths, new_leaves), meta["extra"]

    def restore_latest(self, like: Any, **kw):
        step = self.latest_step()
        if step is None:
            return None
        tree, extra = self.restore(step, like, **kw)
        return step, tree, extra
