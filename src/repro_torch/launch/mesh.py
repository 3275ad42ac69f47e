"""Process groups and device meshes.

The counterpart of the reference's ``launch/mesh.py``.  The port runs
one eager process a rank: :func:`init_process_group` joins this process
to its group (NCCL on the card, gloo on the CPU), and the mesh builders
return a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
over the group's ranks (on the card, each dim's NCCL group runs on a
high-priority stream, so communication overlapped with compute is not
held back behind it).  Functions, not module-level constants:
importing this module touches no device and no process group.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

def _check_device(device: str) -> None:
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a 'cuda' process group needs a CUDA device; "
                           "pass device='cpu' for gloo on the host")


def init_process_group(device: str = "cuda", *,
                       init_method: Optional[str] = None,
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None) -> None:
    """Join this process to the default process group: NCCL on the card
    (the rank's card is ``LOCAL_RANK``, else the rank modulo the cards
    present), gloo on the CPU.  ``rank`` and ``world_size`` default to
    ``RANK`` / ``WORLD_SIZE``; the rendezvous is ``init_method`` (for
    example ``file:///path/store`` or ``tcp://localhost:29500``), else
    ``MASTER_ADDR`` / ``MASTER_PORT`` (``env://``).  A group already
    joined is left as it is."""
    _check_device(device)
    if dist.is_initialized():
        return
    rank = int(os.environ["RANK"]) if rank is None else rank
    world_size = (int(os.environ["WORLD_SIZE"]) if world_size is None
                  else world_size)
    if device == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=init_method or "env://",
                            rank=rank, world_size=world_size)


def _mesh(device: str, shape: Tuple[int, ...], axes: Tuple[str, ...]):
    _check_device(device)
    if not dist.is_initialized():
        init_process_group(device)
    n = int(np.prod(shape))
    if n != dist.get_world_size():
        raise ValueError(f"a {shape} mesh needs {n} ranks, the process "
                         f"group has {dist.get_world_size()}")
    override = None
    if device == "cuda":
        # every axis' NCCL kernels on a high-priority stream: a hop or a
        # gather posted under a product gets SMs before the product's
        # waiting blocks, instead of waiting for them to drain
        opts = dist.ProcessGroupNCCL.Options()
        opts.is_high_priority_stream = True
        override = {axis: ("nccl", opts) for axis in axes}
    return init_device_mesh(device, shape, mesh_dim_names=axes,
                            backend_override=override)


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    """Single pod: (16, 16) = 256 ranks, axes (data, model).
    Multi-pod:  (2, 16, 16) = 512 ranks, axes (pod, data, model) — the
    pod axis carries only the cross-pod gradient reduction.  Built only
    over a process group of exactly that many ranks: real ones, or the
    ``fake`` backend's that the dry-run joins (``launch/dryrun.py``),
    over which nothing runs, so no card is needed for it."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    have = dist.get_world_size() if dist.is_initialized() else None
    if have != n:
        raise ValueError(
            f"a {shape} mesh needs a process group of exactly {n} ranks "
            f"(a 'fake' one for the dry-run); this process has "
            f"{have or 'none'}")
    if dist.get_backend() == "fake":
        return init_device_mesh(device, shape, mesh_dim_names=axes)
    return _mesh(device, shape, axes)


def make_mesh_for_devices(n_devices: Optional[int] = None,
                          model_parallel: int = 1, device: str = "cuda"):
    """Elastic helper: a (data, model) mesh over the process group's
    ranks (restart with N != save-time ranks reshards via the
    checkpointer).  Joins the process group from the environment if this
    process has not joined one."""
    _check_device(device)
    if not dist.is_initialized():
        init_process_group(device)
    n = n_devices or dist.get_world_size()
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by mp={model_parallel}")
    return _mesh(device, (n // model_parallel, model_parallel),
                 ("data", "model"))


def mesh_axes(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def n_chips(mesh) -> int:
    return int(mesh.size())
