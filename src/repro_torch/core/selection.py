"""Port copy of ``repro.core.selection`` (``src/repro/core/selection.py``), kept in the torch
package so it never imports the JAX package.

Candidate-selection stand-in (the paper defers the real algorithm to
"Blockbuster, Part 2" [9]; this module implements the *contract* §1/§4
describe so the framework is complete):

  * candidates are standard-operator subgraphs (here: whole programs, per
    §4: "if the entire block program is entirely made up of standard
    operators then the entire program can be one of the candidates");
  * the fusion algorithm returns multiple snapshots per candidate;
  * the selector evaluates each snapshot with the traffic cost model and
    picks the cheapest implementation;
  * the selector owns block-shape choice (paper: "the selection algorithm
    is also responsible for choosing the block shapes ... and then
    optimize all the shapes after-the-fact"): ``autotune`` sweeps the
    block-count assignment per dimension and returns the best
    (dims, snapshot) pair — including the degenerate counts (N=1, K=1)
    that the paper notes eliminate Rule-6 work replication.

The cost model's coefficients live in a ``calibrate.CalibrationProfile``
(the default reproduces the historical constants; a *measured* profile is
fitted from per-region kernel timings — see ``core/calibrate.py``).
``autotune(objective="measured")`` closes the loop end-to-end: the
(calibrated) analytic model prunes the sweep, and only the top-K
survivors are actually run and timed — the wall-clock winner is
returned.  ``pipeline.compile(..., autotune="measured")`` supplies the
``measure`` callback (compile + synthetic inputs + the timing harness).
"""

from __future__ import annotations

import itertools
import warnings
from dataclasses import dataclass, replace
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple)

from repro_torch.core import calibrate as CAL
from repro_torch.core import cost as C
from repro_torch.core.fusion import fuse
from repro_torch.core.graph import Graph

# single source of truth for the default coefficients is the default
# CalibrationProfile; these names remain the public aliases
DEFAULT_ITEM_BYTES = CAL.DEFAULT_ITEM_BYTES
KERNEL_LAUNCH_COST = CAL.KERNEL_LAUNCH_COST


@dataclass(frozen=True)
class Selected:
    snapshot_index: int
    graph: Graph
    dims: Dict[str, int]
    cost: float
    costs: Tuple[float, ...]  # per snapshot, for inspection
    # objective="measured" only: the winner's wall seconds and every
    # (dims, seconds) pair the autotuner timed — the analytic choice is
    # always among them, so callers can verify measured <= analytic
    measured_s: Optional[float] = None
    timings: Tuple[Tuple[Tuple[Tuple[str, int], ...], float], ...] = ()


def snapshot_cost(g: Graph, dims: Dict[str, int],
                  item_bytes: Optional[Dict[str, int]] = None,
                  profile: Optional[CAL.CalibrationProfile] = None
                  ) -> float:
    """Cost of one snapshot under a calibration profile (default: the
    historical constants; pass a measured profile — or the legacy
    ``item_bytes`` dict, which overrides its item coefficients)."""
    prof = CAL.resolve_profile(item_bytes, profile)
    return prof.cost(C.traffic(g, dims))


def group_cost(group, dims: Dict[str, int],
               item_bytes: Optional[Dict[str, int]] = None,
               profile: Optional[CAL.CalibrationProfile] = None) -> float:
    """Cost of one region-group megakernel under a calibration profile:
    member traffic with every VMEM-resident edge uncharged (no stores by
    the producer, no loads by in-group consumers) plus exactly one
    kernel launch — the residency-aware cost of what actually runs."""
    prof = CAL.resolve_profile(item_bytes, profile)
    return prof.cost(C.group_traffic(group, dims))


def region_costs(g: Graph, dims: Dict[str, int],
                 item_bytes: Optional[Dict[str, int]] = None,
                 plan=None,
                 profile: Optional[CAL.CalibrationProfile] = None
                 ) -> Optional[Tuple[float, ...]]:
    """Per-kernel traffic attribution of one snapshot.

    The Pallas backend executes a snapshot as its grouped region
    partition (``core/regions.py``): one kernel per region *group*,
    with in-group cross-region values VMEM-resident and only
    cross-group values materialized in global memory.  Pass the
    ``regions.GroupedPlan`` the lowering uses via ``plan`` to get one
    :func:`group_cost` entry per emitted kernel (the honest per-kernel
    breakdown ``core/timing.region_times`` pairs wall times with, by
    kernel id); pass a ``regions.ProgramPlan`` (or nothing) for the
    ungrouped per-region attribution — each entry ``snapshot_cost`` of
    one region's standalone program.  Returns ``None`` for programs the
    partitioner cannot split (MiscNode-bearing graphs take the
    whole-program fallback)."""
    from repro_torch.core import regions as R
    if plan is None:
        try:
            plan = R.plan_program(g)
        except R.RegionError:
            return None
    if isinstance(plan, R.GroupedPlan):
        return tuple(group_cost(grp, dims, item_bytes, profile)
                     for grp in plan.groups)
    return tuple(snapshot_cost(spec.graph, dims, item_bytes, profile)
                 for spec in plan.regions)


def objective_cost(g: Graph, dims: Dict[str, int],
                   item_bytes: Optional[Dict[str, int]] = None,
                   profile: Optional[CAL.CalibrationProfile] = None, *,
                   group: bool = False,
                   blocks: Optional[Dict[str, int]] = None,
                   plan=None,
                   vmem_budget: Optional[int] = None) -> float:
    """The selection objective for one snapshot at fixed dims.

    ``group=False`` (the paper's objective): whole-program traffic with
    every edge charged against global memory — :func:`snapshot_cost`.
    ``group=True`` (the residency-aware objective): ``sum(group_cost)``
    over the deterministic grouped region partition the Pallas backend
    actually emits — resident cross-region edges are free and each
    group costs one launch, so snapshots are ranked by the cost of what
    runs, not the paper's all-edges-global upper bound.  A program the
    partitioner cannot split falls back to :func:`snapshot_cost`
    (whole-program lowering: the two objectives coincide).

    ``plan`` optionally passes a precomputed ``regions.ProgramPlan``
    for ``g`` (the partition is dims-independent, so sweeps reuse it).
    """
    if not group:
        return snapshot_cost(g, dims, item_bytes, profile)
    from repro_torch.core import regions as R
    if plan is None:
        try:
            plan = R.plan_program(g)
        except R.RegionError:
            return snapshot_cost(g, dims, item_bytes, profile)
    gp = R.group_plan(plan, dims, blocks, budget_bytes=vmem_budget)
    return sum(group_cost(grp, dims, item_bytes, profile)
               for grp in gp.groups)


def select(g: Graph, dims: Dict[str, int],
           item_bytes: Optional[Dict[str, int]] = None,
           snapshots: Optional[List[Graph]] = None,
           profile: Optional[CAL.CalibrationProfile] = None, *,
           group: bool = False,
           blocks: Optional[Dict[str, int]] = None,
           vmem_budget: Optional[int] = None,
           _plans: Optional[List] = None) -> Selected:
    """Fuse (if needed) and pick the cheapest snapshot for fixed dims.

    ``group=True`` ranks by the grouped, residency-aware objective (see
    :func:`objective_cost`) — what the Pallas region-group lowering will
    actually pay.  ``_plans`` (internal) carries per-snapshot region
    plans across ``autotune``'s dims sweep so each snapshot is
    partitioned once, not once per assignment."""
    snaps = snapshots if snapshots is not None else fuse(g)
    plans: Optional[List] = None
    if group:
        from repro_torch.core import regions as R
        if _plans is not None and len(_plans) == len(snaps):
            plans = _plans
        else:
            plans = []
            for s in snaps:
                try:
                    plans.append(R.plan_program(s))
                except R.RegionError:
                    plans.append(None)
            if _plans is not None:
                _plans[:] = plans
    costs = tuple(
        objective_cost(s, dims, item_bytes, profile, group=group,
                       blocks=blocks, vmem_budget=vmem_budget,
                       plan=plans[j] if plans is not None else None)
        if group else snapshot_cost(s, dims, item_bytes, profile)
        for j, s in enumerate(snaps))
    i = min(range(len(costs)), key=costs.__getitem__)
    return Selected(i, snaps[i], dict(dims), costs[i], costs)


def _dims_key(dims: Dict[str, int]) -> Tuple[Tuple[str, int], ...]:
    return tuple(sorted(dims.items()))


def sweep_assignments(dim_candidates: Dict[str, Sequence[int]]
                      ) -> Iterable[Dict[str, int]]:
    """The deduplicated block-count grid: assignments that would produce
    an identical ``(Graph.fingerprint(), dims)`` compile key — e.g. from
    repeated candidate values — are yielded exactly once, so they are
    costed (and measured) once."""
    names = sorted(dim_candidates)
    seen = set()
    for combo in itertools.product(*(dim_candidates[n] for n in names)):
        dims = dict(zip(names, combo))
        key = _dims_key(dims)
        if key in seen:
            continue
        seen.add(key)
        yield dims


def finalists(g: Graph, dim_candidates: Dict[str, Sequence[int]],
              item_bytes: Optional[Dict[str, int]] = None,
              snapshots: Optional[List[Graph]] = None, *,
              profile: Optional[CAL.CalibrationProfile] = None,
              top_k: int = 1,
              group: bool = False,
              blocks: Optional[Dict[str, int]] = None,
              vmem_budget: Optional[int] = None) -> List[Selected]:
    """The ``top_k`` cheapest distinct assignments of the sweep under the
    analytic objective, cheapest first (a stable sort: equal costs keep
    sweep order, so the analytic winner is always ``[0]``).  What
    :func:`autotune` ranks and times; a caller may build the finalists'
    kernels ahead of a measured sweep from the same list."""
    snaps = snapshots if snapshots is not None else fuse(g)
    cands: List[Selected] = []
    shared_plans: List = []  # per-snapshot region plans, computed once
    for dims in sweep_assignments(dim_candidates):
        cands.append(select(g, dims, item_bytes, snapshots=snaps,
                            profile=profile, group=group, blocks=blocks,
                            vmem_budget=vmem_budget,
                            _plans=shared_plans if group else None))
    if not cands:
        raise ValueError("empty dim_candidates sweep")
    cands.sort(key=lambda s: s.cost)
    return cands[:max(1, top_k)]


def autotune(g: Graph, dim_candidates: Dict[str, Sequence[int]],
             item_bytes: Optional[Dict[str, int]] = None,
             snapshots: Optional[List[Graph]] = None, *,
             objective: str = "analytic",
             profile: Optional[CAL.CalibrationProfile] = None,
             measure: Optional[Callable[[Selected], float]] = None,
             top_k: int = 3,
             group: bool = False,
             blocks: Optional[Dict[str, int]] = None,
             vmem_budget: Optional[int] = None) -> Selected:
    """Sweep block-count assignments (the paper's block-shape choice) and
    return the globally cheapest (dims, snapshot).  The fusion algorithm
    is invoked ONCE — its choices don't depend on block shapes (paper
    §1).  Callers that already ran ``fuse`` (e.g. ``pipeline.compile``)
    pass the snapshot list via ``snapshots`` to avoid re-fusing.

    ``objective="analytic"`` (default) ranks by the calibrated traffic
    model alone.  ``objective="measured"`` uses the analytic model only
    to *prune*: the ``top_k`` cheapest distinct assignments are handed
    to ``measure`` (compile + run + time; built by ``pipeline.compile``)
    and the wall-clock winner is returned, with its seconds in
    ``Selected.measured_s`` and every timed candidate in
    ``Selected.timings``.  The analytic winner is always measured, so
    the result is never slower than the analytic choice (ties allowed);
    candidates that fail to compile or time are skipped with a warning,
    and if every measurement fails the analytic choice is returned.
    """
    if objective not in ("analytic", "measured"):
        raise ValueError(f"unknown objective {objective!r}; "
                         "one of ('analytic', 'measured')")
    if objective == "measured" and measure is None:
        raise ValueError(
            "objective='measured' needs a measure callback; call through "
            "pipeline.compile(..., autotune='measured'), which builds it")
    ranked = finalists(g, dim_candidates, item_bytes, snapshots,
                       profile=profile,
                       top_k=top_k if objective == "measured" else 1,
                       group=group, blocks=blocks, vmem_budget=vmem_budget)
    if objective == "analytic":
        return ranked[0]

    timed: List[Tuple[float, Selected]] = []
    for sel in ranked:
        try:
            t = float(measure(sel))
        except Exception as err:  # a candidate that cannot run is skipped
            warnings.warn(f"measured autotune: skipping {sel.dims} "
                          f"({type(err).__name__}: {err})", RuntimeWarning,
                          stacklevel=2)
            continue
        if not (t > 0.0 and t < float("inf")):
            continue
        timed.append((t, sel))
    if not timed:
        warnings.warn("measured autotune: every measurement failed; "
                      "returning the analytic choice", RuntimeWarning,
                      stacklevel=2)
        return ranked[0]
    timings = tuple((_dims_key(sel.dims), t) for t, sel in timed)
    t_best, best = min(timed, key=lambda p: p[0])
    return replace(best, measured_s=t_best, timings=timings)
