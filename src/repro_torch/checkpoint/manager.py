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
* **restore onto a device**: ``restore(step, device=...)`` loads each
  tensor onto ``device`` (the port's stand-in for the reference's
  ``shardings``; the card unless the caller asks for the CPU);
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
from torch.utils import _pytree as pytree

STATE_FILE = "state.pt"


def _to_host(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return torch.as_tensor(leaf)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

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
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def restore(self, step: Optional[int] = None,
                device="cuda") -> Dict[str, Any]:
        """The checkpoint of ``step`` (the latest if None), every leaf a
        tensor of its saved dtype on ``device``."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}", STATE_FILE)
        return torch.load(path, map_location=device, weights_only=True)
