"""The comparison that decides ``correct``.

Once the window has closed, a sample of the requests the timed path
finished, drawn from the seed with the longest among them, is run
through the plain reference (``bench/reference``), one sequence at a
time: its prompt and its served tokens, teacher-forced.  At each served
position the number compared is the gap by which the served token's
reference logit lies below the reference's best; the run's reading is
the widest gap over the sample.  A greedy program that computes what the
reference computes reads 0 there, or the rounding of a near tie.

The control (``precision="tf32"``) puts the reference, at TF32, in the
program's place: at each served position it takes the token TF32 ranks
first and reads that token's gap in the float32 reference.

Readings of a sample (each configuration compares those its
``check.limits`` names):

* ``served_gap``: the widest gap over the sample;
* ``requests_off``: the sampled requests with any served token that is
  not the reference's first choice (a gap above 0).  Where the model
  routes tokens to experts, a router near-tie that float32 rounding tips
  the other way in the program changes that token's state, and through
  attention every later position of the sequence a little; later near
  ties of the logits then tip too, so a sound program's widest gap swings
  from 0 to some 0.04 on rare sequences.  The count of such sequences is
  steady from seed to seed where the widest gap is not.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch


def sample(finished: Dict[int, object], seed: int, k: int) -> List:
    """The longest finished request (most served tokens; the lowest id
    on a tie) and ``k - 1`` more drawn from ``seed``."""
    reqs = sorted(finished.values(), key=lambda r: r.rid)
    if not reqs:
        return []
    longest = max(reqs, key=lambda r: (len(r.tokens), -r.rid))
    rest = [r for r in reqs if r is not longest]
    rng = np.random.default_rng(np.random.SeedSequence([seed % 2 ** 64, 4]))
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick.tolist())]


def request_gaps(ref, prompt, tokens, device, control=None
                 ) -> Dict[str, torch.Tensor]:
    """Per served position: ``gap`` of the served token and, with a
    ``control`` reference, ``control_gap``."""
    n = len(tokens)
    seq = torch.tensor(list(prompt) + list(tokens[:-1]), dtype=torch.long,
                       device=device)
    served = torch.tensor(list(tokens), dtype=torch.long, device=device)
    logits = ref.logits(seq, last=n)
    best = logits.max(-1).values
    out = {"gap": best - logits.gather(1, served[:, None])[:, 0]}
    if control is not None:
        first = control.logits(seq, last=n).argmax(-1)
        out["control_gap"] = best - logits.gather(1, first[:, None])[:, 0]
    return {k: v.float().cpu() for k, v in out.items()}


def reading(parts: List[Dict[str, torch.Tensor]], key: str
            ) -> Dict[str, object]:
    """The readings of ``key`` (``gap`` or ``control_gap``) over the
    sample: ``served_gap``, ``requests_off`` and each request's widest
    gap."""
    widest = [float(p[key].max()) for p in parts]
    return {"served_gap": max(widest),
            "requests_off": sum(1 for w in widest if w > 0.0),
            "positions": sum(int(p[key].numel()) for p in parts),
            "per_request": widest}


def decide(numbers: Dict[str, Dict[str, float]]) -> bool:
    """Every number at or under its limit (a missing number or limit
    fails)."""
    return all(n["limit"] is not None and n["value"] is not None
               and n["value"] <= n["limit"] for n in numbers.values())


def lines(numbers: Dict[str, Dict[str, float]]) -> List[str]:
    """One line a number: its name, its reading and its limit."""
    return [f"check {name}: {n['value']!r} limit {n['limit']!r}"
            for name, n in numbers.items()]


def reference_for(cfg: dict, weights, precision: str = "float32"):
    """The configuration's plain reference (``reference.<module>``)."""
    import importlib
    mod = importlib.import_module(f"reference.{cfg['reference']['module']}")
    return mod.Decoder(cfg, weights, precision)


def compare(cfg: dict, weights, reqs, device, with_control: bool = False
            ) -> Dict[str, Optional[Dict[str, float]]]:
    """Run the reference (and, if asked, the control) over the sampled
    requests; returns the program's reading and the control's."""
    ref = reference_for(cfg, weights)
    ctl = reference_for(cfg, weights, "tf32") if with_control else None
    parts = [request_gaps(ref, r.prompt, r.tokens, device, ctl)
             for r in reqs]
    out = {"program": reading(parts, "gap") if parts else None,
           "control": None, "served_tokens": sum(len(r.tokens)
                                                 for r in reqs)}
    if with_control and parts:
        out["control"] = reading(parts, "control_gap")
    return out
