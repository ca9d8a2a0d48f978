"""Random weights from ``--seed``, drawn on the device in a few large
calls, laid out as the program declares them.

The program's ``init_params(device="meta")`` gives the tree of leaf
shapes.  Each leaf takes the first rule of the configuration's ``init``
whose ``|``-separated names hold the leaf's own name (``"*"`` matches
any):

* ``{"normal": s}``: N(0, s^2);
* ``{"normal_fan_in": s}``: N(0, s^2 / fan_in), fan_in the leaf's
  second-to-last size (the rows a ``x @ W`` product sums over);
* ``{"uniform": [a, b]}``: U(a, b).

The leaves of one rule share one flat buffer, filled by one draw per 2^30
values and scaled in place by runs of equal scale (the leaves are laid
out by scale), so no leaf is drawn by itself.  The same seed gives the
same weights on the same device type and torch version.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

CHUNK = 1 << 30


def leaves(tree, prefix: str = "") -> List[Tuple[str, torch.Tensor]]:
    """``(dotted name, tensor)`` of every leaf, in the tree's order."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    items = (tree.items() if isinstance(tree, dict) else enumerate(tree))
    out = []
    for k, v in items:
        out += leaves(v, f"{prefix}.{k}" if prefix else str(k))
    return out


def rebuild(tree, flat: Dict[str, torch.Tensor], prefix: str = ""):
    """``tree``'s structure with each leaf replaced from ``flat``."""
    if isinstance(tree, torch.Tensor):
        return flat[prefix]
    if isinstance(tree, dict):
        return {k: rebuild(v, flat, f"{prefix}.{k}" if prefix else str(k))
                for k, v in tree.items()}
    return [rebuild(v, flat, f"{prefix}.{i}" if prefix else str(i))
            for i, v in enumerate(tree)]


def rule_of(name: str, init: dict) -> Tuple[str, dict]:
    leaf = name.rsplit(".", 1)[-1]
    for key, rule in init.items():
        if key == "*" or leaf in key.split("|"):
            return key, rule
    raise KeyError(f"no init rule for {name}")


def _scale(rule: dict, shape) -> float:
    if "normal_fan_in" in rule:
        return rule["normal_fan_in"] / math.sqrt(shape[-2])
    return rule.get("normal", 1.0)


def draw(meta_tree, init: dict, seed: int, device
         ) -> Dict[str, torch.Tensor]:
    """Every leaf of ``meta_tree`` by its dotted name, float32 (the type
    the cells serve in), drawn from ``seed`` on ``device``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    state = np.random.SeedSequence([seed % 2 ** 64, 3]).generate_state(
        1, np.uint64)[0]
    gen.manual_seed(int(state) & (2 ** 63 - 1))
    groups: Dict[str, list] = {}
    for name, t in leaves(meta_tree):
        key, rule = rule_of(name, init)
        groups.setdefault(key, []).append((name, tuple(t.shape)))
    out: Dict[str, torch.Tensor] = {}
    for key in init:                     # the configuration's rule order
        if key not in groups:
            continue
        rule = init[key]
        items = sorted(groups[key], key=lambda it: _scale(rule, it[1]))
        total = sum(math.prod(s) for _, s in items)
        buf = torch.empty(total, dtype=torch.float32, device=dev)
        for lo in range(0, total, CHUNK):
            part = buf[lo:lo + CHUNK]
            if "uniform" in rule:
                a, b = rule["uniform"]
                part.uniform_(a, b, generator=gen)
            else:
                part.normal_(0.0, 1.0, generator=gen)
        off, run_start, run_scale = 0, 0, None
        for name, shape in items:
            n = math.prod(shape)
            if "uniform" not in rule:
                s = _scale(rule, shape)
                if s != run_scale:
                    if run_scale is not None and run_scale != 1.0:
                        buf[run_start:off].mul_(run_scale)
                    run_start, run_scale = off, s
            out[name] = buf[off:off + n].view(shape)
            off += n
        if run_scale is not None and run_scale != 1.0:
            buf[run_start:off].mul_(run_scale)
    return out


def reference_names(flat: Dict[str, torch.Tensor], param_map: dict
                    ) -> Dict[str, torch.Tensor]:
    """The same tensors under the reference's names (``param_map``:
    program name -> reference name, ``*`` standing for a layer index).
    Every leaf must be mapped."""
    out = {}
    for name, t in flat.items():
        parts = name.split(".")
        if parts[0] == "layers":
            key = ".".join(["layers", "*"] + parts[2:])
            if key not in param_map:
                raise KeyError(f"param_map has no entry for {key}")
            out[param_map[key].replace("*", parts[1], 1)] = t
        else:
            if name not in param_map:
                raise KeyError(f"param_map has no entry for {name}")
            out[param_map[name]] = t
    return out
