"""Logical-axis sharding rules of the torch port: the port of
``repro.runtime.sharding`` (MaxText-style).

Parameters, caches and batches carry *logical* axis names; the rules map
them to the axes of a ``torch.distributed.device_mesh.DeviceMesh`` with
the reference's axis names (``pod``, ``data``, ``model``):

  batch   -> (pod, data)   data parallelism (the pod axis folds into DP)
  fsdp    -> data          parameter/optimizer storage sharding
  tensor  -> model         TP: heads / ffn-hidden / vocab
  expert  -> model         EP: MoE experts
  capacity-> (pod, data)   the MoE expert buffer's capacity dim
  kv_seq  -> data          sequence-parallel KV cache for long decode
  (anything unlisted)      replicated

:func:`logical_to_spec` gives a :class:`Spec`, one entry per tensor dim
(``None``, a mesh-axis name, or a tuple of them), the counterpart of a
``PartitionSpec``; :func:`placements` turns it into the DTensor
placements (``Shard(i)`` / ``Replicate()``) of each mesh dim, and
:class:`NamedSharding` pairs it with its mesh.

The model layers carry the reference's :func:`constrain` sites: on
DTensors under an active mesh (the dry-run's ``meta`` steps at the
production mesh) they lay activations out, gather ``fsdp``-sharded
weights where they are used, and keep heads the ``tensor`` axis does not
divide replicated (``models.layers``); on plain tensors, or without a
mesh, they are the identity.  The explicitly parallel layers (the
expert-parallel MoE, the sequence-parallel decode, the data-parallel
gradient mean) make their own collectives (``runtime.collectives``).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch.utils import _pytree as pytree

DEFAULT_RULES: Dict[str, Tuple[str, ...]] = {
    "batch": ("pod", "data"),
    "fsdp": ("data",),
    "tensor": ("model",),
    "expert": ("model",),
    "capacity": ("pod", "data"),   # MoE expert-buffer capacity dim
    "kv_seq": ("data",),
}

_state = threading.local()


def _ctx():
    if not hasattr(_state, "mesh"):
        _state.mesh = None
        _state.rules = dict(DEFAULT_RULES)
    return _state


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Dict] = None):
    """Make ``mesh`` (and ``rules``, if given) active in this thread; the
    previous mesh and rules come back on exit, so uses nest."""
    st = _ctx()
    prev = (st.mesh, st.rules)
    st.mesh = mesh
    if rules is not None:
        st.rules = dict(rules)
    try:
        yield
    finally:
        st.mesh, st.rules = prev


def active_mesh():
    return _ctx().mesh


def axis_names(mesh) -> Tuple[str, ...]:
    """A mesh's axis names: a ``DeviceMesh``'s ``mesh_dim_names`` (or an
    ``axis_names`` attribute, as the reference's meshes have)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names", ())
    return tuple(names or ())


def axis_size(mesh, axes) -> int:
    """The number of ranks along the mesh axes ``axes`` (a name or a
    sequence of names) together."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    names = axis_names(mesh)
    n = 1
    for a in axes:
        n *= mesh.shape[names.index(a)]
    return n


class Spec(tuple):
    """A partition spec: one entry per tensor dim, ``None`` (replicated),
    a mesh-axis name, or a tuple of names (the dim split over those axes,
    the first the major one).  Trailing dims may be left out."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def logical_to_spec(axes: Sequence[Optional[str]], mesh=None) -> Spec:
    """Map logical axis names to a :class:`Spec` under the active rules,
    dropping mesh axes the mesh lacks, never using one mesh axis twice,
    and trimming trailing ``None`` entries."""
    st = _ctx()
    mesh = mesh if mesh is not None else st.mesh
    mesh_axes = set(axis_names(mesh)) if mesh is not None else set()
    spec = []
    used = set()
    for ax in axes:
        if ax is None:
            spec.append(None)
            continue
        targets = tuple(a for a in st.rules.get(ax, ())
                        if a in mesh_axes and a not in used)
        used.update(targets)
        if len(targets) == 0:
            spec.append(None)
        elif len(targets) == 1:
            spec.append(targets[0])
        else:
            spec.append(targets)
    while spec and spec[-1] is None:
        spec.pop()
    return Spec(*spec)


def placements(spec: Sequence, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(i)`` where tensor dim ``i`` is split over that mesh axis,
    ``Replicate()`` elsewhere.  A dim split over several mesh axes is
    sharded over each, in the mesh's order, as the spec's tuple reads
    (the reference's meshes list ``pod`` before ``data``)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        for a in _entry_axes(entry):
            out[names.index(a)] = Shard(dim)
    return out


@dataclass(frozen=True)
class NamedSharding:
    """A :class:`Spec` on a mesh: the port's counterpart of
    ``jax.sharding.NamedSharding``."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> list:
        return placements(self.spec, self.mesh)


def fit_spec(spec: Sequence, shape: Sequence[int], mesh) -> Spec:
    """``spec`` with each dim's trailing mesh axes dropped until their
    product divides the dim (a dim none divide is replicated): an even
    split, as DTensor needs to view a sharded dim into others.  The
    reference's GSPMD pads an uneven dim instead."""
    out = []
    for size, entry in zip(shape, list(spec) + [None] * len(shape)):
        axes = list(_entry_axes(entry))
        while axes and size % axis_size(mesh, axes):
            axes.pop()
        out.append(None if not axes else axes[0] if len(axes) == 1
                   else tuple(axes))
    while out and out[-1] is None:
        out.pop()
    return Spec(*out)


def is_distributed(x) -> bool:
    """Is ``x`` a DTensor under an active mesh (what :func:`constrain`
    lays out)?"""
    if active_mesh() is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replicate(t: torch.Tensor, like):
    """``t``, a tensor every rank holds whole, as a DTensor replicated on
    ``like``'s mesh (no collective)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def on_whole(fn, *tensors):
    """``fn(*tensors)``.  Under a mesh, on DTensors, each rank runs ``fn``
    on the whole tensors (each input gathered), and the results come back
    whole on every rank: the counterpart of DTensor's ``local_map`` with
    every placement ``Replicate``, for work DTensor has no sharding rule
    for in every version (the MoE dispatch's scatter and gather)."""
    if not any(is_distributed(t) for t in tensors):
        return fn(*tensors)
    from torch.distributed.tensor import DTensor, Replicate
    mesh = next(t.device_mesh for t in tensors if is_distributed(t))
    whole = [Replicate()] * mesh.ndim
    local = [t.redistribute(mesh, whole).to_local()
             if isinstance(t, DTensor) else t for t in tensors]
    return pytree.tree_map(
        lambda o: DTensor.from_local(o, mesh, whole, run_check=False)
        if isinstance(o, torch.Tensor) else o, fn(*local))


def divides(n: int, axis: str) -> bool:
    """Do the mesh axes of the logical ``axis`` split ``n`` evenly under
    the active mesh and rules (true without a mesh)?"""
    mesh = active_mesh()
    if mesh is None:
        return True
    spec = logical_to_spec((axis,), mesh)
    return not spec or n % axis_size(mesh, _entry_axes(spec[0])) == 0


def constrain(x, *axes: Optional[str]):
    """Lay ``x`` out by the logical ``axes`` under the active mesh: a
    DTensor is redistributed to the spec (:func:`fit_spec`: a dim its
    axes do not divide keeps only the axes that do); a plain tensor, or
    any tensor without an active mesh, comes back as it is.  On a weight
    stored ``fsdp``-sharded, the axes without ``fsdp`` are FSDP's
    all-gather where the weight is used, and its reduce-scatter in the
    backward pass."""
    if not is_distributed(x):
        return x
    mesh = x.device_mesh
    spec = fit_spec(logical_to_spec(axes, mesh), x.shape, mesh)
    # redistributed even where the layout holds already: the backward pass
    # then lays the gradient out as the forward value, whatever layout
    # DTensor's op-by-op choice gave it
    return x.redistribute(mesh, placements(spec, mesh))


def named_sharding(axes: Sequence[Optional[str]],
                   mesh=None) -> Optional[NamedSharding]:
    mesh = mesh if mesh is not None else active_mesh()
    if mesh is None:
        return None
    return NamedSharding(mesh, logical_to_spec(axes, mesh))


def is_axes(x) -> bool:
    """Is ``x`` a leaf of a spec tree: a tuple of logical axis names and
    ``None``s (``()`` included)?"""
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def tree_shardings(spec_tree, mesh=None):
    """Map a tree of logical-axis tuples to :class:`NamedSharding`s (to
    ``None`` without a mesh)."""
    return pytree.tree_map(lambda axes: named_sharding(axes, mesh),
                           spec_tree, is_leaf=is_axes)


def distribute(x: torch.Tensor, sharding: Optional[NamedSharding]):
    """``x``, a global tensor every rank holds, as a DTensor laid out by
    ``sharding`` (each rank keeps its own slice; no collective), or as it
    is where ``sharding`` is None."""
    if sharding is None:
        return x
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x, sharding.mesh, sharding.placements,
                             src_data_rank=None)
