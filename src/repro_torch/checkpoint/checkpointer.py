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

Resharding: arrays are saved whole (the logical value, what the
reference's ``np.asarray`` of a global array gives).  A tree held at
placements (a mesh's blocks) is saved with ``placements``: every rank
gathers it leaf by leaf, so the card holds one whole leaf at a time, and
the first rank writes.  The restore hands each array to
``sharding_fn(key, tensor)`` when the caller gives one, to re-place it
for a new topology (N ranks at save, M at load; :func:`placing`
keeps each rank's block at the placements of a new mesh), and
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
import torch.distributed as dist

from ..tree import keystr, tree_flatten, tree_unflatten

_STEP_RE = re.compile(r"^step_(\d+)$")


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        # a copy, never a view of the leaf (a CPU tensor's ``.cpu()`` is
        # itself): the train loop updates its tree in place while an
        # async save may still be writing this step's values
        return t.to("cpu", copy=True).numpy()
    return np.asarray(leaf)


def _flatten(tree: Any, placements: Any = None, keep: bool = True) -> dict:
    """{keystr path: whole numpy array}; leaves held at ``placements``
    are gathered one at a time (by every rank, and kept on the host only
    where ``keep``)."""
    paths, leaves = tree_flatten(tree)
    if placements is None:
        return {keystr(p): _to_numpy(leaf) for p, leaf in zip(paths, leaves)}
    from ..models.sharding import gather
    out = {}
    with torch.no_grad():
        for p, leaf, pl in zip(paths, leaves,
                               tree_flatten(placements)[1]):
            whole = gather(leaf, pl) if isinstance(leaf, torch.Tensor) \
                else leaf
            if keep:
                out[keystr(p)] = _to_numpy(whole)
    return out


def placing(like: Any, placements: Any) -> Callable[[str, torch.Tensor],
                                                    torch.Tensor]:
    """A ``sharding_fn`` for :meth:`Checkpointer.restore`: each whole
    array in the ``like`` leaf's dtype on its device, then this rank's
    block of it at the leaf's placement (``placements``: ``like``'s)."""
    from ..models.sharding import place
    paths, leaves = tree_flatten(like)
    places = tree_flatten(placements)[1]
    by_key = {keystr(p): (leaf, pl)
              for p, leaf, pl in zip(paths, leaves, places)}

    def fn(key: str, t: torch.Tensor) -> torch.Tensor:
        leaf, pl = by_key[key]
        return place(t.to(device=leaf.device, dtype=leaf.dtype), pl)
    return fn


def _same_shape(key: str, shape, leaf) -> None:
    if tuple(shape) != tuple(np.shape(leaf)):
        raise ValueError(f"{key}: checkpoint shape {tuple(shape)} != "
                         f"{tuple(np.shape(leaf))}")


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._async_thread: Optional[threading.Thread] = None

    # --------------------------------------------------------------- save
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             blocking: bool = True, placements: Any = None) -> str:
        """Atomic save.  ``blocking=False`` runs serialization on a side
        thread (async checkpointing) — call ``wait()`` before the next
        save or at exit.  With ``placements`` (``tree``'s, held under a
        mesh) every rank of the process group must call it: the leaves
        are gathered one at a time, the first rank writes, and no rank
        returns before the checkpoint is visible, so it must be
        ``blocking``."""
        placed = placements is not None and dist.is_initialized()
        if placed and not blocking:
            raise ValueError("a placed save is blocking: every rank waits "
                             "until the first one has written")
        writer = not placed or dist.get_rank() == 0
        # device->host copy happens here
        flat = _flatten(tree, placements, keep=writer)
        if not writer:
            dist.barrier()
            return os.path.join(self.directory, f"step_{step}")
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
            if placed:
                dist.barrier()
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
        each array under a NEW mesh (elastic resharding; :func:`placing`
        keeps this rank's blocks), and what it returns must have the
        ``like`` leaf's shape; by default each array, of the ``like``
        leaf's shape, goes to its device and dtype.  A ``like`` leaf that
        is not a tensor (a flag) comes back as a Python scalar."""
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
                if not isinstance(leaf, torch.Tensor):
                    _same_shape(key, arr.shape, leaf)
                    new_leaves.append(arr.item())
                    continue
                t = torch.from_numpy(arr)
                if sharding_fn is not None:
                    t = sharding_fn(key, t)
                else:
                    _same_shape(key, arr.shape, leaf)
                    t = t.to(device=leaf.device, dtype=leaf.dtype)
                _same_shape(key, t.shape, leaf)
                new_leaves.append(t)
        return tree_unflatten(paths, new_leaves), meta["extra"]

    def restore_latest(self, like: Any, **kw):
        step = self.latest_step()
        if step is None:
            return None
        tree, extra = self.restore(step, like, **kw)
        return step, tree, extra
