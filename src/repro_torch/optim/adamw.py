"""AdamW with global-norm clipping: the port of ``repro.optim.adamw``.

Functional over trees of tensors (nested dicts and lists), as the
reference is over pytrees: :meth:`AdamW.update` takes the gradients, the
state and the parameters and returns new parameters and a new state,
leaving its inputs as they were.  The moments are float32; each new
parameter is cast back to its own dtype.  The update follows the
reference's order of operations (adamw.py:53-83): clip by the global norm,
bias-correct both moments, then the decoupled weight decay.
``torch.optim.AdamW`` is not this update: its ``eps`` sits elsewhere and
it updates in place.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils import _pytree as pytree


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor: float = 0.1) -> Callable[[Any], torch.Tensor]:
    """Linear warmup over ``warmup`` steps, then a cosine from ``peak_lr``
    down to ``floor * peak_lr`` at ``total``; float32, as the reference."""
    def lr(step):
        step = torch.as_tensor(step).float()
        warm = peak_lr * torch.clamp((step + 1) / max(warmup, 1), max=1.0)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0,
                           1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, peak_lr * cos)
    return lr


def global_norm(tree) -> torch.Tensor:
    """The L2 norm of every leaf of ``tree`` together, in float32."""
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in pytree.tree_leaves(tree)))


@dataclass(frozen=True)
class AdamW:
    lr: Callable[[Any], Any]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> Dict[str, Any]:
        leaves = pytree.tree_leaves(params)
        device = leaves[0].device if leaves else "cpu"

        def f32(p):
            return torch.zeros_like(p, dtype=torch.float32)

        return {"m": pytree.tree_map(f32, params),
                "v": pytree.tree_map(f32, params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    def state_specs(self, param_specs) -> Dict[str, Any]:
        """The state's logical axes from the parameters' (``param_specs``):
        each moment laid out as its parameter, the step replicated; on a
        mesh, ``runtime.sharding.tree_shardings`` of it gives the state's
        shardings, as the reference's does."""
        return {"m": param_specs, "v": param_specs, "step": ()}

    @torch.no_grad()
    def update(self, grads, state, params) -> Tuple[Any, Dict[str, Any],
                                                    Dict[str, Any]]:
        step = state["step"] + 1
        gnorm = global_norm(grads)
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
        lr = self.lr(step)
        b1, b2 = self.b1, self.b2
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()

        def upd(g, m, v, p):
            g = g.float() * scale
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            mhat = m / bc1
            vhat = v / bc2
            delta = mhat / (torch.sqrt(vhat) + self.eps)
            delta = delta + self.weight_decay * p.float()
            return (p.float() - lr * delta).to(p.dtype), m, v

        flat_g, spec = pytree.tree_flatten(grads)
        out = [upd(*leaves) for leaves in zip(
            flat_g, pytree.tree_leaves(state["m"]),
            pytree.tree_leaves(state["v"]), pytree.tree_leaves(params))]
        new_p, new_m, new_v = (pytree.tree_unflatten([o[i] for o in out],
                                                     spec)
                               for i in range(3))
        metrics = {"grad_norm": gnorm, "lr": lr}
        return new_p, {"m": new_m, "v": new_v, "step": step}, metrics
