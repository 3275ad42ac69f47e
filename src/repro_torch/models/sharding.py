"""Logical-axis sharding rules (MaxText-style) for the model stack, and
the placement of the leaves they give.

The counterpart of the reference's ``models/sharding.py``.  Parameters
and activations are annotated with *logical* axes; the rules map them to
the axes of a ``DeviceMesh``:

  single-pod  (16, 16)    ("data", "model")
  multi-pod   (2, 16, 16) ("pod", "data", "model")

``spec`` and ``fitted_sharding`` make the reference's per-dim axis
choices, recorded as a :class:`Placement`.  Each rank is one eager
process, and under a mesh it *stores* every parameter, gradient and
optimizer moment at its placement, as the reference's ``device_put``
does: :func:`place` keeps this rank's block of a whole value (FSDP on
"data" for the ``embed`` dim, tensor-parallel on "model" for heads, ff,
vocab and experts; an axis that ``fitted_sharding`` drops leaves its
dim whole).

A layer gathers its leaves (:meth:`MeshRules.gather`) just before it
uses them and drops them after, over the batch/FSDP axes of their
placements only: a dim on the model axis stays this rank's block, and
the layer computes on it, as the reference's GSPMD does under its
constraints.  Column projections give this rank's block of the heads,
the ff width or the vocab; ``layers.row_parallel_matmul`` multiplies
that block by the weight's rows and all-reduces (the reference's bf16
``psum``); experts are this rank's E/n.  So the activations the
reference constrains to "model" are this rank's blocks here, produced
by the layer itself, and ``constrain`` is the identity.  A consumer
that cannot take its block gathers the model axis too: ``"whole"``
where every model rank then computes on the whole leaf alike,
``"parts"`` where each uses its own parts of it (see
``transformer.whole_on_model``).
The dry-run's abstract leaves
(:func:`abstract_leaf`) are fake tensors of their placed shapes that
carry their placement.  With no mesh every helper degrades to a no-op.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import torch
from torch._guards import detect_fake_mode

from ..core.distributed import axis_group, mesh_shape

# logical axis vocabulary
BATCH = "batch"       # global batch            -> ("pod","data") / ("data",)
SEQ = "seq"           # sequence (usually unsharded; CP uses it)
EMBED = "embed"       # d_model                 -> fsdp ("data")
MODEL = "model"       # TP dim (heads/ff/vocab) -> "model"
EXPERT = "expert"     # MoE experts             -> "model"
KV = "kv"             # kv heads                -> "model"


@dataclasses.dataclass(frozen=True)
class Placement:
    """A mesh and one physical axis (or tuple of axes, or None) a dim:
    the reference's ``NamedSharding``.  Along a dim over several axes
    the first is the outermost (major) one, as in a ``PartitionSpec``."""
    mesh: Any
    spec: Tuple


@dataclasses.dataclass(frozen=True)
class MeshRules:
    mesh: Optional[Any] = None
    batch_axes: Tuple[str, ...] = ("data",)
    fsdp_axis: Optional[str] = "data"
    model_axis: Optional[str] = "model"
    seq_axis: Optional[str] = None   # context parallelism when set
    # each rank holds its own slice of the batch axes (a data-parallel
    # train step), so a statistic over the batch is summed over them
    batch_split: bool = False

    def axis_size(self, name) -> int:
        if self.mesh is None or name is None:
            return 1
        shape = mesh_shape(self.mesh)
        if isinstance(name, (tuple, list)):
            n = 1
            for a in name:
                n *= shape.get(a, 1)
            return n
        return shape.get(name, 1)

    def batch_size_divides(self, b: int) -> bool:
        return b % max(1, self.axis_size(self.batch_axes)) == 0

    def physical(self, logical: Optional[str]):
        if logical is None:
            return None
        if logical == BATCH:
            return self.batch_axes if len(self.batch_axes) > 1 \
                else self.batch_axes[0]
        if logical == SEQ:
            return self.seq_axis
        if logical == EMBED:
            return self.fsdp_axis
        if logical in (MODEL, EXPERT, KV):
            return self.model_axis
        raise ValueError(f"unknown logical axis {logical!r}")

    def spec(self, *logical) -> Tuple:
        return tuple(self.physical(lg) for lg in logical)

    def sharding(self, *logical) -> Optional[Placement]:
        if self.mesh is None:
            return None
        return Placement(self.mesh, self.spec(*logical))

    def fitted_sharding(self, shape, *logical) -> Optional[Placement]:
        """Like ``sharding`` but drops any axis that does not divide the
        corresponding dim (odd vocab sizes, few kv heads, batch=1...)."""
        if self.mesh is None:
            return None
        if len(shape) != len(logical):
            raise ValueError(f"shape {tuple(shape)} vs logical axes "
                             f"{logical}")
        fitted = []
        for dim, log in zip(shape, logical):
            ax = self.physical(log)
            n = self.axis_size(ax)
            fitted.append(ax if (ax is not None and n > 1
                                 and dim % n == 0) else None)
        return Placement(self.mesh, tuple(fitted))

    def model_ways(self, dim: int) -> int:
        """The ways the model axis splits a dim of size ``dim`` under the
        fitted rule: its size where it divides ``dim``, else 1 (and 1
        with no mesh or no model axis)."""
        n = self.axis_size(self.model_axis)
        return n if (self.mesh is not None and n > 1 and dim % n == 0) \
            else 1

    def constrain(self, x: torch.Tensor, *logical) -> torch.Tensor:
        """The identity: a layer produces this rank's block of an
        activation the reference constrains to "model" by computing on
        its weights' model blocks (see the module's docstring)."""
        return x

    def gather(self, t: torch.Tensor, placement: Optional[Placement],
               model: str = "block") -> torch.Tensor:
        """A leaf stored at ``placement`` as a layer uses it, gathered
        over the batch/FSDP axes it is sharded on.  Differentiable: the
        gradient of this rank's block is summed over an axis along which
        the ranks hold different slices of the batch
        (:meth:`split_batch_axes`), and taken as it is along any other
        (where every rank holds the whole gradient).  ``model`` says what
        becomes of the model axis:

        * ``"block"``: a dim on it stays this rank's block;
        * ``"whole"``: it is gathered too (the global value), and every
          model rank computes on the whole leaf alike;
        * ``"parts"``: it is gathered too, but each model rank uses its
          own parts of the whole leaf (the SSM mixer's ``in_proj``
          columns of its heads), so its gradient covers only those and
          is summed over the model group: a reduce-scatter where the
          leaf is split on the model axis, an all-reduce where it is
          held whole."""
        if model not in ("block", "whole", "parts"):
            raise ValueError(f"model={model!r}: block, whole or parts")
        if placement is None:
            return t
        from ..core.distributed import gather_shards, replicated
        summed = self.split_batch_axes()
        on_model = False
        for dim, ax in enumerate(placement.spec):
            for a in reversed(_axes(ax)):   # innermost first
                if a == self.model_axis:
                    if model == "block":
                        continue
                    on_model = True
                t = gather_shards(t, axis_group(placement.mesh, a), dim,
                                  a in summed or (model == "parts" and
                                                  a == self.model_axis))
        if (model == "parts" and not on_model
                and self.axis_size(self.model_axis) > 1):
            t = replicated(t, self.group(self.model_axis))
        return t

    def gather_tree(self, tree, placements, model=None):
        """:meth:`gather` over a tree and its tree of placements;
        ``model(path)`` (a leaf's tuple of keys within ``tree``) gives
        each leaf's ``model`` mode ("block" for every leaf where
        None)."""
        if self.mesh is None:
            return tree

        def walk(node, places, path):
            if isinstance(node, dict):
                return {k: walk(v, places[k], path + (k,))
                        for k, v in node.items()}
            return self.gather(node, places,
                               model=model(path) if model else "block")
        return walk(tree, placements, ())

    def group(self, name: str):
        """The process group of mesh axis ``name``."""
        return axis_group(self.mesh, name)

    def coordinate(self, name: str) -> int:
        """This rank's index along mesh axis ``name``."""
        return self.mesh.get_local_rank(name)

    def split_batch_axes(self) -> Tuple[str, ...]:
        """The batch axes (outermost first) over which this rank holds
        one slice of the batch: none unless ``batch_split``."""
        if self.mesh is None or not self.batch_split:
            return ()
        return tuple(a for a in self.batch_axes if self.axis_size(a) > 1)


def _axes(ax) -> Tuple[str, ...]:
    """The mesh axes of one dim's entry of a spec."""
    return () if ax is None else (tuple(ax) if isinstance(ax, (tuple, list))
                                  else (ax,))


def _ways(placement: Placement, ax) -> int:
    sizes = mesh_shape(placement.mesh)
    return math.prod(int(sizes[a]) for a in _axes(ax))


def local_shape(shape: Sequence[int], placement: Optional[Placement]
                ) -> Tuple[int, ...]:
    """One device's shard of ``shape`` under ``placement`` (the global
    shape without one): each dim over the product of its axes' sizes."""
    if placement is None:
        return tuple(shape)
    return tuple(dim // _ways(placement, ax)
                 for dim, ax in zip(shape, placement.spec))


def sharded_axes(placement: Optional[Placement]) -> Tuple[str, ...]:
    """The mesh axes a leaf is split over (none for a replicated one)."""
    if placement is None:
        return ()
    return tuple(a for ax in placement.spec for a in _axes(ax))


def layer_placement(placement: Optional[Placement]) -> Optional[Placement]:
    """One layer's placement of a stacked (leading-L) leaf's."""
    if placement is None:
        return None
    if placement.spec[0] is not None:
        raise ValueError(f"the layer dim of a stacked leaf is sharded: "
                         f"{placement.spec}")
    return Placement(placement.mesh, placement.spec[1:])


def block_of(t: torch.Tensor, placement: Optional[Placement]
             ) -> torch.Tensor:
    """This rank's block of the whole value ``t`` under ``placement``, as
    a view of ``t``.  Raises where a dim does not split evenly: a leaf
    is never held whole in place of its block."""
    if placement is None:
        return t
    if len(placement.spec) != t.ndim:
        raise ValueError(f"placement {placement.spec} for a tensor of "
                         f"shape {tuple(t.shape)}")
    mesh = placement.mesh
    for dim, ax in enumerate(placement.spec):
        axes = _axes(ax)
        if not axes:
            continue
        n = _ways(placement, ax)
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of shape {tuple(t.shape)} does "
                             f"not split over {axes} ({n} ways)")
        index = 0
        for a in axes:   # outermost first
            index = index * mesh_shape(mesh)[a] + mesh.get_local_rank(a)
        size = t.shape[dim] // n
        t = t.narrow(dim, index * size, size)
    return t


def place(t: torch.Tensor, placement: Optional[Placement]) -> torch.Tensor:
    """This rank's block of the whole value ``t`` under ``placement``, in
    storage of its own (so ``t`` can be freed); ``t`` itself where the
    placement splits nothing."""
    block = block_of(t, placement)
    if block is t:
        return t
    return block.clone(memory_format=torch.contiguous_format)


def gather(t: torch.Tensor, placement: Optional[Placement]) -> torch.Tensor:
    """The whole value of ``t`` stored at ``placement``, over every axis
    (for reading it: a checkpoint, a test, a cache a layer does not
    consume by its block; a layer's leaves go through
    :meth:`MeshRules.gather`)."""
    if placement is None:
        return t
    return MeshRules(mesh=placement.mesh).gather(t, placement,
                                               model="whole")


def global_shape(t: torch.Tensor) -> Tuple[int, ...]:
    """The whole shape of a leaf held at its placement (an abstract
    leaf's, which carries it)."""
    placement = placement_of(t)
    if placement is None:
        return tuple(t.shape)
    return tuple(int(dim) * _ways(placement, ax)
                 for dim, ax in zip(t.shape, placement.spec))


def require_fake_mode() -> None:
    """Raise unless a ``FakeTensorMode`` is active."""
    if detect_fake_mode() is None:
        raise RuntimeError("abstract leaves are fake tensors: build them "
                           "inside an active FakeTensorMode (the dry-run "
                           "does); nothing is allocated for them")


def abstract_leaf(shape: Sequence[int], dtype: torch.dtype, device,
                  placement: Optional[Placement] = None) -> torch.Tensor:
    """A shape-only tensor: a ``FakeTensor`` of this rank's block of the
    global ``shape`` under ``placement`` (what a rank holds) on
    ``device``, made with ``torch.empty`` inside the caller's active
    ``FakeTensorMode`` and carrying ``placement`` (the dry-run's inputs,
    parameters and states; :func:`global_shape` gives the whole shape
    back).  Outside a fake mode it raises: it never allocates (one
    DeepSeek-V3 expert stack is 15 GB)."""
    require_fake_mode()
    if placement is not None:
        for dim, ax in zip(shape, placement.spec):
            if dim % _ways(placement, ax):
                raise ValueError(f"shape {tuple(shape)} does not split "
                                 f"by {placement.spec}")
    t = torch.empty(local_shape(shape, placement), dtype=dtype,
                    device=device)
    t.placement = placement
    return t


def placement_of(t: torch.Tensor) -> Optional[Placement]:
    """The placement an abstract leaf carries (None for a real tensor)."""
    return getattr(t, "placement", None)


def rules_for_mesh(mesh, *, seq_axis: Optional[str] = None) -> MeshRules:
    if mesh is None:
        return NO_MESH
    names = tuple(mesh.mesh_dim_names)
    batch = tuple(n for n in names if n in ("pod", "data")) or (names[0],)
    fsdp = "data" if "data" in names else None
    model = "model" if "model" in names else None
    return MeshRules(mesh=mesh, batch_axes=batch, fsdp_axis=fsdp,
                     model_axis=model, seq_axis=seq_axis)


NO_MESH = MeshRules(mesh=None, batch_axes=(), fsdp_axis=None,
                    model_axis=None)
