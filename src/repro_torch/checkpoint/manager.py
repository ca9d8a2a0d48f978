"""Checkpoints for fault tolerance: the port of
``repro.checkpoint.manager``, with its contract.

* **atomic publish**: a checkpoint is written under ``tmp.step_N`` and
  renamed to ``step_N`` only when complete, so a crash mid-save never
  corrupts the latest checkpoint, and a ``tmp.`` directory is never one;
* **async save**: each tensor is copied to the host at once (a copy,
  even of a CPU tensor, so that an update in place after ``save`` returns
  cannot reach the saved values), and written on a background thread,
  so that training goes on; ``wait()`` joins it (the next ``save`` and
  ``restore`` do) and re-raises its error;
* **resharding restore**: checkpoints hold global tensors;
  ``restore(step, shardings=..., device=...)`` loads each onto ``device``
  (the card unless the caller asks for the CPU) and, where ``shardings``
  (a tree of ``runtime.sharding.NamedSharding``s, or None, laid out as
  the state) gives one, lays it out as a DTensor on that sharding's mesh,
  each rank keeping its own slice: a job comes back on another mesh than
  it saved from;
* **one writer under a mesh**: with ``mesh``, rank 0 alone writes (every
  rank gathers a DTensor leaf, so ``save`` is called on every rank), and
  every rank waits for the publish in ``wait()``;
* **auto-resume**: ``latest_step()`` and the step-keyed data pipeline
  give a bitwise-identical replay after a failure;
* **retention**: the last ``keep`` checkpoints.

State is a tree of nested dicts (string keys) and lists whose leaves are
tensors or numbers.  A checkpoint is the directory ``step_N`` holding
``state.pt``: the tree, its leaves copied to the host, as ``torch.save``
writes it (every dtype, bfloat16 included, round-trips bit for bit).
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.runtime.sharding import distribute

STATE_FILE = "state.pt"


def _to_host(leaf):
    if isinstance(leaf, torch.Tensor):
        from torch.distributed.tensor import DTensor
        if isinstance(leaf, DTensor):
            leaf = leaf.full_tensor()
        return leaf.detach().to("cpu", copy=True)
    return torch.as_tensor(leaf)


def _place(tree, shardings):
    """``tree`` with each leaf laid out by its sharding in ``shardings``
    (a tree of the same layout, or None for a whole subtree)."""
    if shardings is None:
        return tree
    if isinstance(tree, dict):
        return {k: _place(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place(v, s) for v, s in zip(tree, shardings))
    return distribute(tree, shardings)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, mesh=None):
        self.dir = directory
        self.keep = keep
        self.mesh = mesh
        self._writer = mesh is None or dist.get_rank() == 0
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending = False

    # -- discovery ------------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # -- save -----------------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any],
             blocking: bool = False) -> None:
        self.wait()
        host_state = pytree.tree_map(_to_host, state)
        self._pending = True
        if not self._writer:
            if blocking:
                self.wait()
            return

        def _write():
            try:
                tmp = os.path.join(self.dir, f"tmp.step_{step}")
                final = os.path.join(self.dir, f"step_{step}")
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
                os.makedirs(tmp)
                torch.save(host_state, os.path.join(tmp, STATE_FILE))
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                self._gc()
            except BaseException as e:  # noqa: BLE001
                self._error = e

        if blocking:
            _write()
            self.wait()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Join the save in flight; under a mesh every rank waits here
        until rank 0 has published it."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending and self.mesh is not None:
            dist.barrier()
        self._pending = False
        if self._error:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def restore(self, step: Optional[int] = None, shardings: Optional[Any]
                = None, device="cuda") -> Dict[str, Any]:
        """The checkpoint of ``step`` (the latest if None), every leaf a
        tensor of its saved dtype on ``device``, laid out by its sharding
        where ``shardings`` gives one (reference manager.py:123-143)."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}", STATE_FILE)
        state = torch.load(path, map_location=device, weights_only=True)
        return _place(state, shardings)
