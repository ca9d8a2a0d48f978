"""The compile driver of the torch port: block program -> fusion ->
numerical stabilization -> snapshot and block-shape selection -> backend
lowering -> cached callable, the port of ``repro.pipeline.driver``.

    kern = pipeline.compile(AP.attention_program(0.125),
                            dims={"M": 2, "D": 2, "N": 4, "L": 2},
                            options=CompileOptions(backend="torch"))
    out = kern({"Q": Q, "KT": K, "VT": V.T})["O"]

Backends:

* ``"py"``    — the numpy interpreter (``codegen_py``), the oracle;
* ``"torch"`` — the plain whole-program lowering (``codegen_torch``);
  ``jit="per-op"`` runs each top-level operator on its own, dispatched
  from Python, the launch-per-operator unfused baseline;
* ``"cuda"``  — ``codegen_cuda.emit_program``: one emitted CUDA kernel per
  region group of the selected snapshot (``group=False``: per region),
  grouped and reported exactly as the reference's ``pallas`` backend.
  Needs ``blocks``.  For CPU tensors each kernel runs its plain version;
  for CUDA tensors it launches.

Every compiled kernel takes and returns merged dense arrays keyed by the
program's input and output names.  ``kern(inputs, instances=k)`` treats
the first ``k`` axes of every input as instance axes (size 1 is shared),
the port's stand-in for ``jax.vmap`` over a compiled kernel.

Results are cached in a two-level :class:`~repro_torch.pipeline.cache.
KernelCache` keyed by ``(Graph.fingerprint(), dims, backend, blocks,
fused)``, the options of ``CompileOptions.cache_opts`` and the
``CODEGEN_VERSION`` salt: in-process hits return the existing callable;
on-disk hits (another process, the same cache directory) skip fusion and
selection and only re-lower, and the nvcc libraries of the re-lowered
kernels are found on disk by their source hash.  ``KernelCache.stats``
counts hits and misses (a serving engine pins its ``CacheStats.delta``);
:data:`STATS` counts, per process, the CUDA kernels emitted and the
fusion and selection runs.

Failures degrade instead of aborting: lowering walks the resilience
ladder (``repro_torch.resilience``) under the ``CompileOptions.resilience``
policy, from the rung the options ask for (cuda: ``grouped``, or
``ungrouped`` with ``group=False``; torch: ``torch``; py: ``interpreter``)
down one rung per failed attempt: ``grouped`` is ``emit_program`` on the
group plan, ``ungrouped`` ``emit_program`` on a per-region plan computed
anew, ``torch`` ``codegen_torch.merged_runner``, ``interpreter`` the numpy
interpreter.  Every attempt is recorded in ``CompiledKernel.
resilience_report`` (``kern.rung`` is the rung that served), every
demotion is counted in ``resilience.METRICS`` and warned, and each rung's
failures feed the cache's health ledger (``KernelCache.health``, keyed by
graph fingerprint), whose open breakers skip a rung without an attempt.
Configuration errors (cuda without ``blocks``) raise before any rung
runs.  **When ``device`` is a CUDA device no compile demotes to a plain
version**: ``torch`` and ``interpreter`` are offered only when the options
ask for them, so a cuda compile on the card stops at ``ungrouped`` (its
kernels launch or it raises), and exhausting the ladder raises
``resilience.LadderError`` (the port's counterpart of the reference's
"the interpreter rung is not servable"; the interpreter also runs numpy
on the CPU).  Lowering emits CUDA source and builds nothing (nvcc runs at
the first launch or in ``codegen_cuda.build``), so an attempt abandoned
by ``attempt_timeout_s`` never leaves a half-built library, and its
kernel is never the one cached.
"""

from __future__ import annotations

import functools
import time
import warnings
from dataclasses import dataclass, replace
from math import lcm
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import resilience as RZ
from repro_torch.core import calibrate as CAL
from repro_torch.core import numerics as NU
from repro_torch.core import regions as REG
from repro_torch.core import selection as SEL
from repro_torch.core.fusion import FusionTrace, fuse
from repro_torch.core.graph import Graph
from repro_torch.pipeline import packing as P
from repro_torch.pipeline.cache import (CacheKey, CachePlan, KernelCache,
                                        default_cache)
from repro_torch.pipeline.options import DEFAULT_OPTIONS, CompileOptions

BACKENDS = ("py", "torch", "cuda")
AUTOTUNE_OBJECTIVES = ("analytic", "measured")

#: per process, what the cache counters (``KernelCache.stats``) do not
#: show: CUDA kernels emitted, fusion runs, selection runs (``select`` or
#: an ``autotune`` sweep) and measured autotune candidates skipped
#: because they failed to compile or run
STATS = {"kernels": 0, "fusions": 0, "selections": 0, "measure_skips": 0}


#: the rungs that run a kernel's plain version, never a demotion on the card
PLAIN_RUNGS = ("torch", "interpreter")


@dataclass
class CompiledKernel:
    """A ready-to-run fused kernel plus its compilation provenance."""

    key: CacheKey
    backend: str
    graph: Graph                      # the selected snapshot
    dims: Dict[str, int]
    blocks: Optional[Dict[str, int]]
    snapshot_index: int
    cost: float                       # predicted cost of the selection
    initial_cost: float               # same model on the unfused program
    cache_hit: Optional[str]          # None | "memory" | "disk"
    stabilized: bool
    in_names: List[str]
    out_names: List[str]
    _fn: Callable = None              # type: ignore
    # cuda backend only: regions emitted, kernels launched, resident
    # edges (codegen_cuda.LoweringReport), the per-kernel cost
    # attribution and the kernel ids it pairs with
    lowering_report: Optional[Any] = None
    region_costs: Optional[Tuple[float, ...]] = None
    kernel_ids: Optional[Tuple[str, ...]] = None
    # autotune="measured" only: the winner's wall seconds (at the sweep's
    # total problem) and every (dims, seconds) candidate the autotuner
    # timed (the analytic choice is always among them); on a fresh sweep
    # also one record per finalist, in analytic order (the first is the
    # analytic winner): its dims, blocks, options, predicted cost,
    # seconds, and why it was skipped (None when it was timed)
    measured_s: Optional[float] = None
    autotune_timings: Optional[Tuple] = None
    autotune_report: Optional[Tuple[Dict[str, Any], ...]] = None
    # fault provenance (resilience.ResilienceReport): the rung requested,
    # the rung that served the compile, and every ladder attempt in
    # between; on every compile (the happy path is one ok attempt at the
    # requested rung)
    resilience_report: Optional[Any] = None

    def __call__(self, inputs: Dict[str, Any], instances: int = 0
                 ) -> Dict[str, Any]:
        missing = [n for n in self.in_names if n not in inputs]
        if missing:
            raise KeyError(f"missing kernel inputs {missing}; "
                           f"expected {self.in_names}")
        if self.demoted_to_plain and any(
                getattr(inputs[n], "is_cuda", False) for n in self.in_names):
            asked = self.resilience_report.requested
            raise RuntimeError(
                f"this compile was demoted from the {asked!r} rung to the "
                f"plain {self.rung!r} rung: it serves CPU tensors only (on "
                "a CUDA tensor a kernel launches or raises)")
        return self._fn(inputs, instances)

    @property
    def predicted_traffic_reduction(self) -> float:
        return self.initial_cost / max(self.cost, 1e-30)

    @property
    def rung(self) -> Optional[str]:
        """The ladder rung that served this compile."""
        return (self.resilience_report.rung
                if self.resilience_report is not None else None)

    @property
    def demoted_to_plain(self) -> bool:
        """Whether the ladder demoted this compile to a plain-version rung
        (one the options did not ask for)."""
        rr = self.resilience_report
        return (rr is not None and rr.rung != rr.requested
                and rr.rung in PLAIN_RUNGS)

    @property
    def launches(self) -> Optional[int]:
        """Kernels launched per call (cuda: groups emitted)."""
        return (self.lowering_report.launches
                if self.lowering_report is not None else None)

    @property
    def resident_edges(self) -> Optional[int]:
        return (self.lowering_report.resident_edges
                if self.lowering_report is not None else None)

    @property
    def grouped_cost(self) -> Optional[float]:
        """Residency-aware predicted cost of what actually runs: the sum
        of the per-kernel attributions (``cost`` is the selection
        objective, which for ``fused=False`` or ungrouped lowering
        charges every cross-region edge)."""
        return (sum(self.region_costs)
                if self.region_costs is not None else None)

    @property
    def kernels(self) -> List[Any]:
        """The emitted kernel objects, in launch order (cuda backend)."""
        raw = getattr(self._fn, "raw_program", None)
        if raw is None:
            return []
        return [fn for _, fn in raw.region_runners]


def _io_info(g: Graph):
    in_info = [(g.nodes[i].name, g.nodes[i].vtype) for i in g.input_ids]
    out_info = [(g.nodes[o].name, vt)
                for o, vt in zip(g.output_ids, P.output_types(g))]
    return in_info, out_info


def _lower_py(g: Graph, dims: Dict[str, int]):
    from repro_torch.core.codegen_py import compile_py
    in_info, out_info = _io_info(g)
    prog = compile_py(g, dims)

    def call(inputs: Dict[str, Any], instances: int = 0):
        if instances:
            raise ValueError("the py backend takes no instance axes")
        if any(getattr(inputs[nm], "is_cuda", False) for nm, _ in in_info):
            raise ValueError("the interpreter runs numpy on the CPU: it "
                             "takes no CUDA tensors")
        nested = {nm: P.to_nested(_numpy(inputs[nm]), vt, dims)
                  for nm, vt in in_info}
        outs = prog(nested)
        return {nm: P.from_nested(outs[nm], vt, dims)
                for nm, vt in out_info}

    return call


def _numpy(a):
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def _merged_call(g: Graph, fn: Callable) -> Callable:
    in_info, out_info = _io_info(g)

    def call(inputs: Dict[str, Any], instances: int = 0):
        outs = fn(*[inputs[nm] for nm, _ in in_info], instances=instances)
        return {nm: o for (nm, _), o in zip(out_info, outs)}

    return call


def _lower_cuda(g: Graph, dims: Dict[str, int], blocks: Dict[str, int],
                pplan, gplan, group: bool):
    """``emit_program`` of the selected snapshot: ``(call, report)``."""
    from repro_torch.core.codegen_cuda import emit_program
    program, report = emit_program(g, dims, blocks, program_plan=pplan,
                                   grouped_plan=gplan, group=group)
    call = _merged_call(g, program)
    # the raw program carries the per-kernel runners that
    # core/timing.region_times and the chip checks drive
    call.raw_program = program
    STATS["kernels"] += len(program.region_runners)
    return call, report


def _rung_thunk(rung: str, g: Graph, dims: Dict[str, int], *,
                blocks: Optional[Dict[str, int]], jit, pplan, gplan,
                group: bool) -> Callable[[], Tuple]:
    """The lowering a ladder rung runs; every thunk returns ``(call,
    LoweringReport-or-None)``.  ``gplan`` is reusable only at the rung it
    was packed for: the other cuda rung plans its own groups."""
    if rung == "grouped":
        return lambda: _lower_cuda(g, dims, blocks, pplan,
                                   gplan if group else None, True)
    if rung == "ungrouped":
        return lambda: _lower_cuda(g, dims, blocks, pplan,
                                   None if group else gplan, False)
    if rung == "torch":
        from repro_torch.core.codegen_torch import merged_runner
        return lambda: (_merged_call(g, merged_runner(
            g, dims, per_op=jit == "per-op")), None)
    return lambda: (_lower_py(g, dims), None)


def _on_card(device) -> bool:
    import torch
    return torch.device(device).type == "cuda"


def _ladder_rungs(start: str, policy, device) -> Tuple[str, ...]:
    """The rungs a compile may attempt: ``start`` down to
    ``policy.max_rung``, less the plain-version rungs below ``start``
    when ``device`` is a CUDA device: on a CUDA tensor a kernel launches
    or raises."""
    rungs = RZ.rungs_from(start, policy.max_rung)
    if _on_card(device):
        rungs = tuple(r for r in rungs
                      if r == start or r not in PLAIN_RUNGS)
    return rungs


def _ladder_lower(rungs: Tuple[str, ...], make_thunk: Callable,
                  policy, rr, *, ledger=None,
                  health_key: Optional[str] = None,
                  cut_on_card: bool = False) -> Tuple:
    """Attempt each allowed rung in order (``policy.retries`` extra
    same-rung tries with exponential backoff, each attempt optionally
    under ``policy.attempt_timeout_s``), recording every attempt in the
    :class:`resilience.ResilienceReport` ``rr``.  Returns the first
    successful rung's ``(call, report)``; raises
    :class:`resilience.LadderError` when every rung is exhausted (its
    message says so when ``cut_on_card``: the plain-version rungs were
    left out because the device is a CUDA device).

    With a :class:`resilience.HealthLedger`, each rung's breaker is
    consulted first: an **open** breaker skips the rung instantly (a
    zero-cost ``skipped_open`` attempt: no retry sleep, no timeout
    worker), a breaker whose cool-down elapsed admits the attempt as a
    half-open **probe**, and every executed attempt's outcome feeds back
    into the ledger.  The default policy costs the happy path nothing: no
    timeout means no worker thread, zero retries no sleep, and the ledger
    holds no entry for a rung that never failed."""
    last: Optional[BaseException] = None
    for ri, rung in enumerate(rungs):
        probe = False
        if ledger is not None and health_key is not None:
            verdict = ledger.decision(health_key, rung)
            if verdict == "open":
                rr.attempts.append(RZ.Attempt(
                    rung, False, 0.0, error="breaker open (skipped)",
                    skipped_open=True))
                RZ.METRICS.skipped_open += 1
                if ri + 1 < len(rungs):
                    warnings.warn(
                        f"compile ladder: rung {rung!r} breaker open; "
                        f"skipping to {rungs[ri + 1]!r}", RuntimeWarning,
                        stacklevel=3)
                continue
            probe = verdict == "probe"
            if probe:
                RZ.METRICS.probes += 1
        thunk = make_thunk(rung)

        def attempt(rung=rung, thunk=thunk):
            RZ.check(f"compile:{rung}")
            return thunk()

        for retry in range(policy.retries + 1):
            if retry:
                time.sleep(policy.backoff_s * (2 ** (retry - 1)))
            t0 = time.perf_counter()
            try:
                res = (RZ.run_with_timeout(attempt,
                                           policy.attempt_timeout_s)
                       if policy.attempt_timeout_s is not None
                       else attempt())
            except Exception as e:  # any lowering failure demotes
                last = e
                rr.attempts.append(RZ.Attempt(
                    rung, False, time.perf_counter() - t0,
                    error=f"{type(e).__name__}: {e}", retry=retry,
                    timed_out=isinstance(e, RZ.AttemptTimeout),
                    probe=probe))
                if ledger is not None and health_key is not None:
                    ledger.record_failure(health_key, rung, e,
                                          policy=policy)
                    if probe:
                        RZ.METRICS.probe_failures += 1
                        probe = False  # retries are ordinary attempts
                continue
            rr.attempts.append(RZ.Attempt(
                rung, True, time.perf_counter() - t0, retry=retry,
                probe=probe))
            rr.rung = rung
            if ledger is not None and health_key is not None:
                ledger.record_success(health_key, rung)
            return res
        if ri + 1 < len(rungs):
            RZ.METRICS.demotions += 1
            warnings.warn(
                f"compile ladder: rung {rung!r} failed "
                f"({rr.attempts[-1].error}); demoting to "
                f"{rungs[ri + 1]!r}", RuntimeWarning, stacklevel=3)
    RZ.METRICS.ladder_failures += 1
    why = (" (on a CUDA device a compile never demotes to a plain "
           "version: the torch and interpreter rungs are not offered)"
           if cut_on_card else "")
    raise RZ.LadderError(
        f"every allowed ladder rung failed{why} ({rr.summary()}); "
        f"last error: {last}", rr)


def _candidate(graph: Graph, dim_candidates: Dict[str, Sequence[int]],
               options: CompileOptions, dims: Dict[str, int], *,
               profile=None, stabilize: bool = False
               ) -> Tuple[CompileOptions, Dict[str, int]]:
    """``(options, block extents)`` that the measured sweep compiles the
    assignment ``dims`` of ``dim_candidates`` with.

    Every candidate runs the SAME total problem: per dim the total extent
    is a base block extent (the caller's ``blocks``, else 8; 1 for stack
    dims) times the lcm of the candidate counts, and each candidate's
    block extent is ``total // count``: the block *count* varies at a
    fixed problem size, the choice the paper's selector owns."""
    from repro_torch.core import timing as T
    blocks = options.blocks_dict or {}
    sd = T.stack_dims(graph)
    total = {d: (1 if d in sd else blocks.get(d, 8))
             * lcm(*{int(c) for c in dim_candidates[d]})
             for d in dim_candidates}
    cand_blocks = {d: total[d] // dims[d] for d in dims}
    bad = [d for d in sd if d in cand_blocks and cand_blocks[d] != 1]
    if bad:
        raise ValueError(f"stack dims {bad} need equal candidate counts "
                         "(block size is pinned to 1)")
    # a candidate is timed on the rung asked for or skipped: never
    # demoted to a plain version, and its failures (a size past shared
    # memory) say nothing of the rung's health
    policy = replace(options._policy(), breaker_threshold=0,
                     max_rung=RZ.start_rung(options.backend,
                                            bool(options.group)))
    cand = options.replace(
        blocks=(cand_blocks if options.backend == "cuda"
                else options.blocks),
        stabilize=stabilize, autotune="analytic", profile=profile,
        resilience=policy)
    return cand, cand_blocks


def _measure_harness(graph: Graph,
                     dim_candidates: Dict[str, Sequence[int]], *,
                     options: CompileOptions, profile, cache: KernelCache,
                     stabilize: bool, device) -> Callable:
    """The ``measure`` callback ``selection.autotune(objective=
    "measured")`` calls for each top-K survivor: compile the candidate
    through this same driver and cache (the in-process level absorbs
    repeats) and time its callable, median of ``measure_repeats`` fenced
    calls on synthetic inputs on ``device`` (:func:`_candidate` sizes
    them).  Measurements are memoized process-wide (``timing.measured``)
    by (fingerprint, dims, backend, device, totals, ...), so re-sweeps
    never re-time a configuration.  Each call is recorded in
    ``measure.report``; one that fails is recorded and re-raised, and
    ``selection.autotune`` skips it with a warning."""
    from repro_torch.core import timing as T
    o = options
    dev = T.device_kind(device)
    fp = graph.fingerprint()
    kernels: Dict[Tuple, CompiledKernel] = {}
    report: List[Dict[str, Any]] = []

    def measure(sel) -> float:
        dkey = tuple(sorted(sel.dims.items()))
        rec = {"dims": dict(sel.dims), "cost": sel.cost, "blocks": None,
               "options": None, "seconds": None, "skipped": None}
        report.append(rec)
        try:
            cand, cand_blocks = _candidate(graph, dim_candidates, o,
                                           sel.dims, profile=profile,
                                           stabilize=stabilize)
            rec.update(blocks=cand_blocks, options=cand)
            mkey = (fp, dkey, o.backend, dev,
                    tuple(sorted(cand_blocks.items())), o.jit, o.fused,
                    o.measure_repeats, o.group, stabilize)

            def thunk() -> float:
                kern = compile(graph, dict(sel.dims), options=cand,
                               cache=cache, device=device)
                kernels[dkey] = kern
                inputs = T.synth_inputs(graph, sel.dims, cand_blocks,
                                        device=device)
                return T.time_callable(kern, inputs, warmup=1,
                                       repeats=o.measure_repeats).median_s

            t = T.measured(mkey, thunk)
        except Exception as err:
            rec["skipped"] = f"{type(err).__name__}: {err}"
            STATS["measure_skips"] += 1
            raise
        if not (0.0 < t < float("inf")):
            rec["skipped"] = f"time {t!r} is not positive and finite"
            STATS["measure_skips"] += 1
        rec["seconds"] = t
        return t

    measure.kernels = kernels
    measure.report = report
    return measure


def _profile(o: CompileOptions, cache: KernelCache, device):
    """The calibration profile selection runs under: ``o.profile``; else,
    under ``autotune="measured"``, the one saved for this backend and
    device under the cache root (the default constants if none was
    saved); else None (the default constants)."""
    if o.profile is not None or o.autotune != "measured":
        return o.profile
    from repro_torch.core import timing as T
    return CAL.load_or_default(cache.root, backend=o.backend,
                               device_kind=T.device_kind(device))


def _stabilized(graph: Graph, o: CompileOptions) -> bool:
    """The resolved stabilization decision (``None``: exactly the
    softmax-bearing programs, ``numerics.needs_stabilization``)."""
    return (NU.needs_stabilization(graph) if o.stabilize is None
            else bool(o.stabilize))


def _snapshots(graph: Graph, fused: bool, stab: bool,
               trace: Optional[FusionTrace] = None
               ) -> Tuple[List[Graph], Graph]:
    """``(snapshots, base)``: the fusion snapshots (with ``fused=False``
    the unfused program alone) and the unfused program priced for
    ``initial_cost``, both stabilized when ``stab``, so the cost model
    ranks the graphs that will lower."""
    snaps = fuse(graph, trace) if fused else [graph.clone()]
    if not stab:
        return snaps, graph
    return [NU.stabilize(s) for s in snaps], NU.stabilize(graph)


def autotune_candidates(graph: Graph,
                        dim_candidates: Dict[str, Sequence[int]], *,
                        options: CompileOptions,
                        cache: Optional[KernelCache] = None,
                        device="cuda") -> List[Dict[str, Any]]:
    """The finalists that ``compile(graph, dim_candidates=...,
    options=options, cache=cache, device=device)`` times, in the order it
    times them (``selection.finalists`` under the same profile, fusion
    and stabilization): per finalist its dims, predicted cost, and the
    ``(options, blocks)`` the sweep compiles it with (``ValueError`` text
    under ``"error"`` where it cannot be sized).  Lets a caller build the
    finalists' kernels ahead of the sweep; caches nothing."""
    o = options
    cache = cache if cache is not None else default_cache()
    profile = _profile(o, cache, device)
    stab = _stabilized(graph, o)
    snaps, base = _snapshots(graph, o.fused, stab)
    out = []
    for sel in SEL.finalists(base, dim_candidates, o.item_bytes_dict,
                             snaps, profile=profile, top_k=o.top_k,
                             group=bool(o.group) and o.backend == "cuda",
                             blocks=o.blocks_dict):
        rec: Dict[str, Any] = {"dims": dict(sel.dims), "cost": sel.cost}
        try:
            rec["options"], rec["blocks"] = _candidate(
                graph, dim_candidates, o, sel.dims, profile=profile,
                stabilize=stab)
        except ValueError as err:
            rec["error"] = str(err)
        out.append(rec)
    return out


def compile(graph: Graph, dims: Optional[Dict[str, int]] = None, *,
            options: Optional[CompileOptions] = None,
            dim_candidates: Optional[Dict[str, Sequence[int]]] = None,
            cache: Optional[KernelCache] = None, device="cuda",
            **kwargs) -> CompiledKernel:
    """Compile a block program into an executing, cached kernel.

    How it compiles is ``options``, a frozen hashable
    :class:`CompileOptions` (or its fields as keywords; passing both is a
    ``TypeError``).  The options hash into the kernel-cache key
    (``CompileOptions.cache_opts``), so equal options never compile twice
    and unequal ones never alias.

    Either ``dims`` (fixed block counts -> ``selection.select``) or
    ``dim_candidates`` (a per-dim sweep -> ``selection.autotune``, which
    also picks the dims) must be given.  ``fused=False`` skips the fusion
    algorithm: the unfused program compiles as is (the baseline).
    ``stabilize`` (``None``: exactly the softmax-bearing programs,
    ``numerics.needs_stabilization``) rewrites every snapshot into online
    softmax before selection.  ``group`` (cuda backend) packs regions into
    megakernel groups and ranks snapshots by the grouped residency-aware
    objective; ``group=False`` emits one kernel per region.

    ``autotune="measured"`` (with ``dim_candidates``) closes the predict
    -> run -> measure loop: the calibrated analytic model prunes the
    sweep, the ``top_k`` cheapest distinct candidates are compiled and
    timed on ``device`` (median of ``measure_repeats`` fenced calls of the
    whole callable on synthetic inputs at a fixed total problem size),
    and the wall-clock winner is what lowers, caches and re-loads.  Under
    either objective the winner lowers at the caller's ``blocks``, as the
    reference's does (a problem of ``blocks × dims``); ``measured_s`` is
    its time at the sweep's total problem.  A candidate that fails to
    compile or launch is skipped with a warning and counted
    (``STATS["measure_skips"]``), never replaced by a plain version.  ``profile`` overrides the calibration profile; by default
    the measured path loads the one saved for this backend and device
    under the cache root (``calibrate.load_or_default``), the analytic
    path keeps the default constants.  ``device`` is where the kernel
    will run: the measured sweep times on it, and keys it (a sweep timed
    on the CPU never serves one asked of the card), and a CUDA device
    leaves the plain-version rungs off the ladder; compiling itself
    touches no device.  Lowering walks the resilience ladder under
    ``options.resilience`` (see the module docstring).
    """
    if options is None:
        try:
            options = CompileOptions(**kwargs) if kwargs else DEFAULT_OPTIONS
        except TypeError as e:
            raise TypeError(f"pipeline.compile: {e}") from None
    elif kwargs:
        raise TypeError("pipeline.compile: pass either options= or the "
                        f"keyword form, not both (extra: {sorted(kwargs)})")
    o = options
    backend, item_bytes, fused = o.backend, o.item_bytes_dict, o.fused
    blocks, jit, group = o.blocks_dict, o.jit, bool(o.group)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    if dims is None and dim_candidates is None:
        raise ValueError("pass dims= (fixed) or dim_candidates= (autotune)")
    if o.autotune not in AUTOTUNE_OBJECTIVES:
        raise ValueError(f"unknown autotune objective {o.autotune!r}; "
                         f"one of {AUTOTUNE_OBJECTIVES}")
    if o.autotune == "measured" and dim_candidates is None:
        raise ValueError("autotune='measured' needs dim_candidates=")
    if backend == "cuda":
        if blocks is None:
            raise ValueError("backend='cuda' needs per-dim block sizes: "
                             "pass blocks=")
        missing = [d for d in (dims if dims is not None else dim_candidates)
                   if d not in blocks]
        if missing:
            raise ValueError(f"blocks missing sizes for dims {missing}")
    cache = cache if cache is not None else default_cache()
    profile = _profile(o, cache, device)
    stab = _stabilized(graph, o)
    vmem_budget = REG.vmem_budget() if backend == "cuda" and group else None
    measure_device = None
    if o.autotune == "measured":
        from repro_torch.core import timing as T
        measure_device = T.device_kind(device)

    # an autotune key embeds the whole candidate sweep, so two sweeps
    # over the same dim names but other candidates never collide
    key_dims = (dims if dims is not None
                else {k: tuple(v) for k, v in dim_candidates.items()})
    opts = o.cache_opts(stabilized=stab,
                        autotuned=dim_candidates is not None,
                        profile=profile, vmem_budget=vmem_budget,
                        measure_device=measure_device)
    key = CacheKey.make(graph.fingerprint(), backend, key_dims, blocks,
                        fused, opts)
    hit = cache.get_kernel(key)
    # a kernel the ladder demoted to a plain version on the CPU is never
    # served to the card: compile it anew for the card
    if hit is not None and not (hit.demoted_to_plain and _on_card(device)):
        return replace(hit, cache_hit="memory")

    plan, selected = cache.get_plan(key)
    timings = measure = None
    autotune_report = None
    # the grouped cuda lowering runs the grouped megakernel schedule, so
    # its snapshots rank by the residency-aware grouped objective; every
    # other backend runs the whole program and keeps the paper's
    sel_group = group and backend == "cuda"
    if plan is None:
        # -- the full pipeline: fuse -> select/autotune --------------------
        STATS["fusions"] += fused
        snaps, base = _snapshots(graph, fused, stab, FusionTrace())
        STATS["selections"] += 1
        if dim_candidates is not None:
            if o.autotune == "measured":
                measure = _measure_harness(
                    graph, dim_candidates, options=o, profile=profile,
                    cache=cache, stabilize=stab, device=device)
            sel = SEL.autotune(base, dim_candidates, item_bytes,
                               snapshots=snaps, objective=o.autotune,
                               profile=profile, measure=measure,
                               top_k=o.top_k, group=sel_group,
                               blocks=blocks)
            if measure is not None:
                timings = sel.timings
                autotune_report = tuple(measure.report)
        else:
            sel = SEL.select(base, dims, item_bytes, snapshots=snaps,
                             profile=profile, group=sel_group,
                             blocks=blocks)
        selected = snaps[sel.snapshot_index]
        # the unfused program priced under the SAME objective as the
        # winner, so predicted_traffic_reduction compares like with like
        init_cost = SEL.objective_cost(base, sel.dims, item_bytes, profile,
                                       group=sel_group, blocks=blocks)
        plan = CachePlan(sel.snapshot_index, sel.dims, sel.cost, sel.costs,
                         init_cost, measured_s=sel.measured_s,
                         stabilized=stab)
        cache_hit = None
    else:
        cache_hit = "disk"
        if selected is None:
            # plan-only disk entry (un-picklable graph): re-fuse and
            # re-apply the same deterministic stabilization so
            # snapshot_index addresses the graph the plan described
            STATS["fusions"] += fused
            selected = _snapshots(graph, fused, stab)[0][
                plan.snapshot_index]
    use_dims = plan.dims
    # the partition is shared between the per-kernel costing and the cuda
    # rungs; a snapshot the partitioner cannot split leaves both cuda
    # rungs to fail (emit_program raises the same RegionError) and the
    # ladder to demote, with the error in the report
    pplan = gplan = plan_err = None
    if backend == "cuda":
        try:
            pplan = REG.plan_program(selected)
        except REG.RegionError as err:
            plan_err = f"{type(err).__name__}: {err}"
        else:
            # kernel groups (one-region groups with group=False)
            gplan = (REG.group_plan(pplan, use_dims, blocks) if group
                     else REG.ungrouped_plan(pplan))
    if cache_hit is None and gplan is not None:
        plan = replace(
            plan, region_costs=SEL.region_costs(selected, use_dims,
                                                item_bytes, plan=gplan,
                                                profile=profile),
            kernel_ids=tuple(grp.gid for grp in gplan.groups),
            launches=gplan.n_launches,
            resident_edges=gplan.n_resident_edges)

    # -- lowering: the selected snapshot, nothing else -----------------------
    # the measured sweep already compiled its candidates through this
    # driver; a candidate lowered exactly as this compile would lower
    # (same backend and, for cuda, the same block extents) is reused, and
    # its provenance adopted in place of a fresh zero-cost attempt
    policy = o._policy()
    start = RZ.start_rung(backend, group)
    rr = RZ.ResilienceReport(requested=start, plan_error=plan_err)
    fn = report = None
    if measure is not None:
        cand = measure.kernels.get(tuple(sorted(use_dims.items())))
        if cand is not None and (backend != "cuda" or cand.blocks == blocks):
            fn, report = cand._fn, cand.lowering_report
            rr = cand.resilience_report or rr
    if fn is None:
        rungs = _ladder_rungs(start, policy, device)
        fn, report = _ladder_lower(
            rungs,
            functools.partial(_rung_thunk, g=selected, dims=use_dims,
                              blocks=blocks, jit=jit, pplan=pplan,
                              gplan=gplan, group=group),
            policy, rr,
            # the cache's ledger is shared by every process on the same
            # cache directory; keyed by graph fingerprint, so one
            # program's bad rung never taints another
            ledger=(cache.health if policy.breaker_threshold > 0
                    else None),
            health_key=graph.fingerprint(),
            cut_on_card=rungs != RZ.rungs_from(start, policy.max_rung))

    # emission may diverge from the planned grouping (a group whose
    # kernel the emitter refuses becomes per-region kernels): the
    # per-kernel costs must describe what runs, or id-based time pairing
    # would drop kernels.  A fresh plan is written once, after lowering,
    # so a plan that cannot lower is never cached
    actual = getattr(getattr(fn, "raw_program", None), "emitted_kernels",
                     None)
    stale = (actual is not None and plan.kernel_ids is not None
             and tuple(gid for gid, _ in actual) != plan.kernel_ids)
    if stale:
        rcosts = [SEL.group_cost(unit, use_dims, item_bytes, profile)
                  if hasattr(unit, "members")
                  else SEL.snapshot_cost(unit.graph, use_dims, item_bytes,
                                         profile)
                  for _, unit in actual]
        plan = replace(plan, region_costs=tuple(rcosts),
                       kernel_ids=tuple(gid for gid, _ in actual),
                       launches=report.launches,
                       resident_edges=report.resident_edges)
    if cache_hit is None or stale:
        cache.put_plan(key, plan, selected)

    in_info, out_info = _io_info(selected)
    kern = CompiledKernel(
        key=key, backend=backend, graph=selected, dims=dict(use_dims),
        blocks=dict(blocks) if blocks else None,
        snapshot_index=plan.snapshot_index, cost=plan.cost,
        initial_cost=plan.initial_cost, cache_hit=cache_hit,
        stabilized=stab, in_names=[n for n, _ in in_info],
        out_names=[n for n, _ in out_info], _fn=fn,
        lowering_report=report, region_costs=plan.region_costs,
        kernel_ids=plan.kernel_ids, measured_s=plan.measured_s,
        autotune_timings=timings, autotune_report=autotune_report,
        resilience_report=rr)
    cache.put_kernel(key, kern)
    return kern
