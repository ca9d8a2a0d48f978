"""Device meshes over ``torch.distributed`` ranks: the port of
``repro.launch.mesh``.

Functions, not module-level constants: importing this module touches no
process group.  :func:`init_distributed` joins one (NCCL for ``cuda``,
gloo for ``cpu``, and nothing else: a failure to start NCCL raises);
:func:`make_production_mesh` and :func:`make_debug_mesh` lay the ranks out
as a ``DeviceMesh`` with the reference's axis names.

    torchrun --nproc-per-node 2 -m repro_torch.launch.train --mesh debug
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.distributed as dist

#: the process-group backend of each device type; no other is used
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def init_distributed(device="cuda", *, rank: Optional[int] = None,
                     world_size: Optional[int] = None, store=None) -> bool:
    """Join the default process group for ``device``, unless one exists
    (then its backend must be ``device``'s).  Rank and world size come
    from the caller (with a ``store``, as spawned processes have) or from
    torchrun's ``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` (its
    ``MASTER_ADDR``/``MASTER_PORT`` rendezvous); with neither, a world of
    one over an in-process store.  On ``cuda`` the rank's card is
    ``LOCAL_RANK`` (its rank where that is unset).  Returns True where it
    created the group (the caller then destroys it)."""
    device = torch.device(device)
    backend = BACKENDS[device.type]
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(f"the process group runs {have!r}; "
                               f"{device.type} needs {backend!r}")
        return False
    env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if rank is None:
        rank = int(os.environ["RANK"]) if env else 0
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"]) if env else 1
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL needs a CUDA device and none is "
                               "available; there is no fallback to gloo")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    kw = {}
    if store is not None:
        kw["store"] = store
    elif not env:
        if world_size != 1:
            raise ValueError("a world of several ranks needs a store or "
                             "torchrun's RANK/WORLD_SIZE")
        kw["store"] = dist.HashStore()
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            **kw)
    return True


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape, axes, what: str, device_type: Optional[str] = None):
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"need {n} devices for the {what}, have {have}; start {n} "
            "ranks (torchrun --nproc-per-node, or the 'fake' backend for "
            "shapes alone)")
    if not dist.is_initialized():
        raise RuntimeError(f"the {what} needs a process group: join one "
                           "with init_distributed")
    return DeviceMesh(device_type or _mesh_device_type(),
                      torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")`` with ``multi_pod``, over the first 256 or 512 ranks.  The
    mesh's device type is the process group's (``cuda`` over NCCL, else
    ``cpu``) unless ``device_type`` names one: the dry-run asks for
    ``cuda``, the card's layout, under the ``fake`` backend, where DTensor
    then exchanges shards with an all-to-all as it does on the card (on a
    ``cpu`` mesh it gathers and chunks instead)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes, "production mesh", device_type)


def make_debug_mesh(shape=(1, 1), axes=("data", "model")):
    """A mesh of ``shape`` over the first ranks of the process group
    (tests on 1-4 processes)."""
    return _mesh(tuple(shape), tuple(axes), "debug mesh")
