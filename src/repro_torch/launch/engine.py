"""Continuous-batching decode engine of the torch port: the port of
``repro.launch.engine``.

An open-loop arrival trace feeds a slot scheduler that

* admits requests into free KV-cache slots, prefilling each prompt padded
  to a *shape bucket* (exact under causal masking: pad keys sit only at
  future positions, and later decode steps overwrite them); admission is
  bounded by ``max_queue`` (an arrival past it is rejected with a
  ``queue_full`` record) and a request whose ``deadline_step`` passed
  while it queued is dropped (``deadline_queued``);
* runs ONE ragged decode step per tick across every active slot, each
  sequence at its own cache position.  Positions are kernel data (the
  causal mask's QP/KP inputs), so the same compiled kernels serve every
  step;
* evicts finished sequences, stalled ones (cache slot exhausted),
  sequences past their deadline (``deadline``) and sequences whose logits
  turn non-finite (``nonfinite_logits``), each with a failure record.

``warmup()`` compiles every kernel the loop can touch (one attention and
one SwiGLU kernel per prompt bucket plus the decode pair), builds the CUDA
ones together, and runs each once.  On a CUDA device it then captures each
prompt bucket's prefill and the decode step as CUDA graphs (unless
``cfg.cuda_graphs`` is off), which the loop replays: the host enqueues a
step in one launch instead of thousands (:meth:`Engine._capture_graphs`).
``run()`` then pins zero pipeline
compiles (``CacheStats.delta`` of ``pipeline.default_cache()``: plans
compiled or loaded from disk) and zero nvcc builds.  A warmup in a fresh
process over a cache directory another process filled loads every plan
from disk (``ServeReport.cache_disk_hits``) and builds nothing.

Resilience (``repro_torch.resilience``), and every step of it is loud: a
``RuntimeWarning``, a failure record and a ``ServeReport`` counter.

* **The watchdog**: a decode step that raises demotes decode one rung of
  the serving ladder, ``pipeline-cuda`` -> ``pipeline-torch`` ->
  ``chunked`` (``attn_impl="chunked"``, ``mlp_impl="fused_ref"``, the
  reference's ``xla``/``fused_ref``), and retries the tick once; prefill
  stays on the rung it started on.  When the retry fails too the
  original error is raised.  **The serving ladder runs on CPU tensors
  only**: the lower rungs are the kernels' plain versions, and on the
  card a kernel launches or raises, so a cuda engine's watchdog re-raises
  the decode error and the engine never probes or adopts a demoted
  start (a sticky CUDA error poisons the context besides).
* **Re-promotion** (CPU engines): the failed rung's breaker, in a
  :class:`~repro_torch.resilience.HealthLedger` under
  ``<cache>/health/`` whose clock is the engine tick, admits a half-open
  probe after ``repromote_after`` clean ticks; a probe whose decode step
  gives finite logits swaps the rung back in, a failed one re-opens the
  breaker at doubled cool-down.  The probe decodes on a copy of the KV
  cache: the port's decode writes the cache in place, and a probe must
  never reach a live sequence.  An engine built over a ledger with an
  open breaker starts demoted.
* Demotion and probe compiles are explained and kept out of
  ``decode_recompiles``.
"""

from __future__ import annotations

import dataclasses
import functools
import time
import warnings
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resilience as RZ
from repro_torch import tracing as T
from repro_torch.kernels import grouped_experts as GE


#: the families continuous batching serves: attention models, whose padded
#: prefill is exact under causal masking (the reference's engine.py:42)
SUPPORTED_FAMILIES = ("dense", "moe")


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Request:
    """One serving request: a prompt arriving at an (open-loop) step."""
    rid: int
    prompt: Tuple[int, ...]
    max_new_tokens: int
    arrival_step: int
    # the last engine step this request may still run at: past it a
    # queued request is dropped and an active one evicted (its partial
    # tokens recorded), each with a failure record.  None = no deadline
    deadline_step: Optional[int] = None


def synth_trace(n_requests: int, *, seed: int = 0,
                arrival_rate: float = 1.0,
                prompt_lens: Tuple[int, int] = (4, 24),
                gen_lens: Tuple[int, int] = (4, 16),
                vocab: int = 1000) -> List[Request]:
    """A synthetic open-loop trace (the reference's, draw for draw):
    geometric inter-arrival steps at ``arrival_rate`` requests per step,
    uniform prompt and generation lengths, uniform random tokens."""
    rng = np.random.default_rng(seed)
    reqs, step = [], 0
    for rid in range(n_requests):
        plen = int(rng.integers(prompt_lens[0], prompt_lens[1] + 1))
        glen = int(rng.integers(gen_lens[0], gen_lens[1] + 1))
        reqs.append(Request(
            rid=rid,
            prompt=tuple(int(t) for t in rng.integers(0, vocab, plen)),
            max_new_tokens=glen,
            arrival_step=step))
        step += int(rng.geometric(min(1.0, arrival_rate)) - 1)
    return reqs


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

@dataclass
class StepRecord:
    step: int
    queue_depth: int
    occupancy: int
    n_prefill: int
    n_decode: int
    wall_ms: float          # the step's ``tick`` span (repro_torch.tracing)


@dataclass
class ServeReport:
    """What a serving run did."""
    device: str = ""
    n_requests: int = 0
    n_completed: int = 0
    n_evicted_stalled: int = 0
    n_rejected: int = 0
    n_poisoned: int = 0
    steps: int = 0
    wall_s: float = 0.0
    prefill_tokens: int = 0
    decode_tokens: int = 0       # tokens generated (each prefill's first
                                 # included)
    mean_occupancy: float = 0.0
    max_queue_depth: int = 0
    # the kernel cache (pipeline.default_cache()) from the engine's
    # construction on: in-process hits, plans loaded from disk (another
    # process compiled them), fresh compiles, the hit rate, and corrupt
    # entries quarantined
    cache_memory_hits: int = 0
    cache_disk_hits: int = 0
    cache_misses: int = 0
    cache_hit_rate: float = 0.0
    quarantined: int = 0
    warmup_compiles: int = 0
    warmup_builds: int = 0
    decode_recompiles: int = 0   # pipeline compiles + nvcc builds after
                                 # warmup that no demotion or probe
                                 # explains; MUST be 0
    # -- resilience (all zero, and decode_backend "pipeline-cuda", on the
    #    clean path of a cuda engine) ------------------------------------
    n_deadline_evicted: int = 0  # requests dropped or evicted past deadline
    degradations: int = 0        # compile-ladder demotions
                                 # (resilience.METRICS) + watchdog ones
    cuda_degraded: int = 0       # planned groups the emitter split into
                                 # per-region kernels during warmup
    repromotions: int = 0        # demoted decode rungs probed healthy and
                                 # swapped back in
    probes: int = 0              # half-open re-promotion probes
    probe_failures: int = 0      # probes that failed (breaker re-opened)
    decode_backend: str = ""     # the serving-ladder rung decode ended on
    # launches of every emitted kernel during the run, by
    # "<program>/<kernel id>", and on the card with MoE layers of the
    # grouped expert kernel, by "grouped_experts"
    kernel_launches: Dict[str, int] = field(default_factory=dict)
    # one record per bad shape, queue_full, deadline, poison eviction,
    # watchdog demotion, probe and re-promotion: {"reason", "step", ...};
    # a demotion's and a probe's carry their wall time ("ms")
    failures: List[dict] = field(default_factory=list)
    tokens: Dict[int, List[int]] = field(default_factory=dict)
    per_step: List[StepRecord] = field(default_factory=list)
    # with Engine(record_logits=True): the float32 logits row each token
    # was sampled from, per request (CPU tensors; not serialized)
    logits: Dict[int, List[torch.Tensor]] = field(default_factory=dict)

    def to_json(self) -> dict:
        d = asdict(self)
        d.pop("logits")
        d["tokens"] = {str(k): v for k, v in self.tokens.items()}
        return d


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

@dataclass
class _Slot:
    rid: int
    pos: int                 # next cache position to write (filled length)
    remaining: int
    last_token: int
    generated: List[int]
    deadline: Optional[int] = None


def _demote_cfg(cfg):
    """One watchdog rung down for the serving model: ``pipeline-cuda`` ->
    ``pipeline-torch`` -> ``chunked`` (the plain ``chunked`` attention and
    ``fused_ref`` MLP).  Returns ``(new_cfg, label)``, or ``(None, None)``
    at the bottom.  The interpreter rung is not servable: it runs numpy on
    the CPU."""
    if cfg.attn_impl != "pipeline" and cfg.mlp_impl != "pipeline":
        return None, None
    opts = cfg.pipeline_options
    backend = opts.backend if opts is not None else cfg.pipeline_backend
    if backend == "cuda":
        new_opts = opts.replace(backend="torch") if opts is not None else None
        return dataclasses.replace(cfg, pipeline_backend="torch",
                                   pipeline_options=new_opts), "pipeline-torch"
    return dataclasses.replace(cfg, attn_impl="chunked",
                               mlp_impl="fused_ref",
                               pipeline_options=None), "chunked"


def serving_ladder(device) -> bool:
    """Whether an engine on ``device`` may demote decode down the serving
    ladder: on CPU tensors only, since its lower rungs are the kernels'
    plain versions and on a CUDA tensor a kernel launches or raises."""
    return torch.device(device).type != "cuda"


def _backend_label(cfg) -> str:
    """The serving-ladder rung of a model config, in the labels
    :func:`_demote_cfg` hands out."""
    if cfg.attn_impl != "pipeline" and cfg.mlp_impl != "pipeline":
        return "chunked"
    opts = cfg.pipeline_options
    backend = opts.backend if opts is not None else cfg.pipeline_backend
    return f"pipeline-{backend}"


class Engine:
    """Slot-based continuous-batching scheduler over ``models.lm.LM``.

    ``max_queue`` bounds the queue (None: unbounded); ``repromote_after``
    is the clean decode ticks a demoted rung waits before a half-open
    probe (None: demote for good).  ``run`` raises on a compile after
    warmup that no demotion or probe explains.  On a CUDA device decode
    never demotes (see the module docstring)."""

    def __init__(self, cfg, *, params=None, device="cuda",
                 max_batch: int = 4, max_len: int = 96,
                 prompt_buckets: Sequence[int] = (8, 16, 32),
                 sampling: str = "greedy", temperature: float = 1.0,
                 seed: int = 0, record_logits: bool = False,
                 max_queue: Optional[int] = None,
                 repromote_after: Optional[int] = 8):
        from repro_torch import pipeline
        from repro_torch.models import build_model

        if cfg.family not in SUPPORTED_FAMILIES:
            raise ValueError(f"family {cfg.family!r} is not served by the "
                             "port yet")
        if sampling not in ("greedy", "categorical"):
            raise ValueError(f"unknown sampling {sampling!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # the projections and head stay torch.matmul: full float32,
            # as the reference's f32 serving computes them
            torch.backends.cuda.matmul.allow_tf32 = False
        self.max_batch = int(max_batch)
        self.max_len = int(max_len)
        self.prompt_buckets = tuple(sorted(int(b) for b in prompt_buckets))
        if self.prompt_buckets[-1] >= self.max_len:
            raise ValueError("largest prompt bucket must leave room to "
                             f"decode (buckets={self.prompt_buckets}, "
                             f"max_len={self.max_len})")
        self.sampling = sampling
        self.temperature = float(temperature)
        self.record_logits = record_logits
        self.max_queue = None if max_queue is None else int(max_queue)
        self._gen = torch.Generator().manual_seed(seed)
        # the kernel cache the engine compiles in, and its counters when
        # the engine was made (the report's cache fields count from here)
        self._cache = pipeline.default_cache()
        self._base = self._cache.stats.snapshot()

        # -- re-promotion: the decode rung's breaker, on the tick clock --
        self.repromote_after = (None if repromote_after is None
                                else int(repromote_after))
        self._tick = 0
        self._clean_ticks = 0
        self._demote_stack: List[Tuple[object, str]] = []  # (cfg, label)
        self.repromotions = self.probes = self.probe_failures = 0
        self.watchdog_demotions = 0
        self.explained_compiles = 0  # demotion and probe compiles+builds
        self._ledger = None
        self._hkey = f"serve:{cfg.name}:decode"
        if self.repromote_after is not None and self.repromote_after <= 0:
            raise ValueError("repromote_after must be > 0 (or None to "
                             "disable re-promotion)")
        # a cuda engine never demotes, so it keeps no breaker to probe
        # or adopt
        self._ladder = serving_ladder(self.device)
        if self._ladder and self.repromote_after is not None:
            self._ledger = RZ.HealthLedger(
                self._cache.root / "health" if self._cache.disk else None,
                clock=lambda: float(self._tick))
            self._breaker_policy = RZ.ResiliencePolicy(
                breaker_threshold=1,  # one decode crash opens the breaker
                breaker_cooldown_s=float(self.repromote_after),
                breaker_cooldown_max_s=float(self.repromote_after) * 64)
            # adopt a predecessor's open breaker: start demoted rather
            # than crash the same rung again, the cool-down re-opened on
            # this engine's tick clock
            while True:
                lbl = _backend_label(cfg)
                new_cfg, _ = _demote_cfg(cfg)
                if (new_cfg is None or self._ledger.state(
                        self._hkey, lbl) == "closed"):
                    break
                self._demote_stack.append((cfg, lbl))
                self._ledger.reopen(self._hkey, lbl,
                                    float(self.repromote_after))
                warnings.warn(
                    f"serve: decode rung {lbl!r} breaker is open in the "
                    f"health ledger; starting demoted to "
                    f"{_backend_label(new_cfg)!r}", RuntimeWarning,
                    stacklevel=2)
                cfg = new_cfg
            self.cfg = cfg

        self.model = build_model(cfg)
        # the captured prefills by bucket and decode step ("decode") of a
        # CUDA engine (:meth:`_capture_graphs`), their one memory pool and
        # stream, and the replays so far
        self._graphs: Dict[object, tuple] = {}
        self._pool = self._stream = None
        self.graph_replays = 0
        # prefill stays on the rung the engine started on; the watchdog
        # and re-promotion swap the decode model only
        self._prefill_model = self.model
        self.params = (params if params is not None
                       else self.model.init_params(seed, self.device))
        self.caches = self.model.init_cache(self.max_batch, self.max_len,
                                            self.device)
        self.slots: List[Optional[_Slot]] = [None] * self.max_batch
        self.queue: deque = deque()
        self.kernels: Dict[str, object] = {}
        self._launch_base: Dict[str, int] = {}
        self._warm = None        # the counters after warmup
        self._base_metrics = None  # resilience.METRICS at warmup start
        self.warmup_compiles = 0
        self.warmup_builds = 0
        self.cuda_degraded = 0

    # -- helpers --------------------------------------------------------------
    def _bucket(self, plen: int) -> Optional[int]:
        for b in self.prompt_buckets:
            if plen <= b:
                return b
        return None

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        lg = logits[:, -1].float()
        if self.sampling == "greedy":
            return lg.argmax(-1).cpu().numpy()
        probs = torch.softmax(lg / max(self.temperature, 1e-6), -1).cpu()
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0].numpy()

    def _tensor(self, arr) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), dtype=torch.long,
                               device=self.device)

    def _prefill_into(self, tokens, slot, out=None):
        """``LM.prefill`` of ``tokens`` (1, bucket), its cache written into
        the cache slot the (1,) tensor ``slot`` holds, every entry by name
        (``k``/``v``, or MLA's ``ckv``/``krope``).  Returns the logits, or
        with ``out`` copies them into the front of ``out`` and returns
        that view."""
        logits, cache = self._prefill_model.prefill(self.params, tokens,
                                                    max_len=self.max_len)
        for name, t in cache.items():
            self.caches[name].index_copy_(1, slot, t)
        if out is None:
            return logits
        return out[:, :tokens.shape[1]].copy_(logits)

    def _prefill(self, padded: np.ndarray, slot: int) -> torch.Tensor:
        """Prefill ``padded`` (1, bucket) into cache ``slot``; its logits.
        A captured bucket replays its graph, whose logits live until the
        next replay of any graph."""
        return self._run(padded.shape[1], self._prefill_into,
                         self._tensor(padded), self._tensor([slot]))

    def _decode_inputs(self):
        toks = [s.last_token if s else 0 for s in self.slots]
        pos = [s.pos if s else 0 for s in self.slots]
        return self._tensor(toks)[:, None], self._tensor(pos)

    def _step(self, tokens, pos, model=None, caches=None):
        """One decode step of ``model`` (the serving one) over ``caches``
        (the engine's), written in place: ``(logits, counts)``, ``counts``
        a (B + 1,) tensor on the device (None without MoE layers) for
        :meth:`_read_decode`: each row's (token, k) assignments that land
        on held experts, then the rows the held experts computed, each
        summed over the MoE layers (``layers.moe_apply``).  A model
        without MoE layers is called with ``LM.decode_step``'s four
        arguments alone, the signature a wrapper that stands in for it
        may take (the benchmark's fault checks,
        ``bench/test_bench_harness.py``)."""
        assigned = []
        logits, _ = (model or self.model).decode_step(
            self.params, self.caches if caches is None else caches, tokens,
            pos, **({"assigned": assigned} if self.model.has_moe else {}))
        return logits, torch.stack(assigned).sum(0) if assigned else None

    def _decode_once(self):
        """One serving decode step: its inputs, then :meth:`_step` alone
        as the ``decode.forward`` span (``repro_torch.tracing``)."""
        RZ.check("serve:decode")
        toks, pos = self._decode_inputs()
        with T.TRACER.span("decode.forward",
                           graph=int("decode" in self._graphs)):
            return self._run("decode", self._step, toks, pos)

    def _capture(self, what: str, fn, *inputs):
        """``(graph, static inputs, outputs, launches)``: ``fn`` on copies
        of ``inputs``, run once on the engine's capture stream (lazy
        set-up, such as the stream's cuBLAS workspace, happens there and
        not in the graph), then captured on it as a CUDA graph in the
        engine's memory pool.  A replay reads the static inputs and
        overwrites the outputs in place; ``launches`` pairs each kernel of
        ``self.kernels`` the graph launches with its count a replay.  A
        step that cannot be captured (``what``) raises, its error
        chained."""
        static = tuple(t.clone() for t in inputs)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._stream):
            fn(*static)
        torch.cuda.current_stream(self.device).wait_stream(self._stream)
        before = {name: k.launches for name, k in self.kernels.items()}
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream):
                out = fn(*static)
        except Exception as err:
            raise RuntimeError(f"serve: the {what} cannot be captured as a "
                               "CUDA graph") from err
        launches = [(k, k.launches - before[name])
                    for name, k in self.kernels.items()
                    if k.launches != before[name]]
        return graph, static, out, launches

    def _capture_graphs(self) -> None:
        """Capture each prompt bucket's prefill and the decode step, so
        that each runs as one ``replay`` and the host no longer paces it.

        Every graph is captured into one memory pool, on one stream: a
        capture's working memory is free again when it ends and the next
        capture reuses it.  Replays never overlap and the engine reads a
        replay's outputs before the next replay, so the graphs may share
        it.  Each prefill writes its cache straight into the slot its
        static slot input holds.  The largest bucket's prefill, captured
        first, keeps its logits, and every other bucket's copies its own
        into the front of them: the graphs hold one set of prefill
        logits, not one a bucket.  The decode step writes the cache as the
        eager one does (the warm-up step too, at position 0 of every free
        slot, which a prefill overwrites before the slot is used)."""
        self._pool = torch.cuda.graph_pool_handle()
        self._stream = torch.cuda.Stream(self.device)
        slot = torch.zeros(1, dtype=torch.long, device=self.device)
        logits = None
        for b in sorted(self.prompt_buckets, reverse=True):
            self._graphs[b] = self._capture(
                f"prefill of bucket {b}",
                functools.partial(self._prefill_into, out=logits),
                torch.zeros((1, b), dtype=torch.long, device=self.device),
                slot)
            if logits is None:
                logits = self._graphs[b][2]
        self._graphs["decode"] = self._capture("decode step", self._step,
                                               *self._decode_inputs())

    def _run(self, key, fn, *inputs):
        """``fn(*inputs)``, or where graph ``key`` was captured its replay
        on ``inputs`` (its outputs, overwritten by the next replay), the
        kernels it launched counted as the eager step counts them."""
        if key not in self._graphs:
            return fn(*inputs)
        graph, static, out, launches = self._graphs[key]
        for dst, src in zip(static, inputs):
            dst.copy_(src)
        graph.replay()
        for k, n in launches:
            k.launches += n
        self.graph_replays += 1
        return out

    def _read_decode(self, logits, counts):
        """The one blocking read of a decode step: whether each row's
        logits are finite and, with MoE layers, :meth:`_step`'s
        ``counts`` read with it (None without MoE layers)."""
        fin = torch.isfinite(logits[:, -1]).all(-1)
        if counts is None:
            return fin.cpu().numpy(), None
        both = torch.cat([fin.long(), counts]).cpu().numpy()
        b = fin.shape[0]
        return both[:b].astype(bool), both[b:]

    def _compiles(self) -> Tuple:
        """The counters a compile moves: the kernel cache's and nvcc's."""
        from repro_torch.core import cuda_build
        return self._cache.stats.snapshot(), cuda_build.STATS["builds"]

    def _compiled_since(self, mark: Tuple) -> int:
        from repro_torch.core import cuda_build
        return (self._cache.stats.delta(mark[0]).compiles
                + cuda_build.STATS["builds"] - mark[1])

    def _track(self, cfg, **shapes) -> Dict[str, object]:
        """Compile (or find) the pipeline programs of ``cfg`` and count
        their emitted kernels' launches from now on."""
        from repro_torch.models import layers as L
        programs = L.pipeline_kernels(cfg, max_len=self.max_len,
                                      device=self.device.type, **shapes)
        for prog, kern in programs.items():
            for k in kern.kernels:
                name = f"{prog}/{k.gid}"
                if name not in self.kernels:
                    self.kernels[name] = k
                    self._launch_base[name] = k.launches
        return programs

    # -- lifecycle ------------------------------------------------------------
    def warmup(self) -> int:
        """Compile every pipeline kernel the run loop can touch, build the
        CUDA ones together, and run each once.  ``run()`` pins the
        steady state against the counters taken here.  Returns the number
        of pipeline compiles (plans compiled or loaded from disk)."""
        from repro_torch.core import codegen_cuda

        mark = self._compiles()
        self._base_metrics = RZ.METRICS.snapshot()
        self.kernels, self._launch_base = {}, {}
        programs = self._track(self.cfg, prefill_lens=self.prompt_buckets,
                               decode_batch=self.max_batch)
        self.cuda_degraded = sum(len(k.lowering_report.degraded)
                                 for k in programs.values()
                                 if k.lowering_report is not None)
        if self.device.type == "cuda":
            codegen_cuda.build(list(self.kernels.values()))
            if self.model.has_moe:
                # the MoE layers' grouped expert kernel (layers.moe_apply),
                # counted as the emitted ones: a capture records its
                # launches and each replay adds them
                self.kernels["grouped_experts"] = GE.KERNEL
                self._launch_base["grouped_experts"] = GE.KERNEL.launches
        for b in self.prompt_buckets:
            self._prefill(np.zeros((1, b), np.int64), 0)
        self._step(*self._decode_inputs())
        if self.device.type == "cuda":
            if self.cfg.cuda_graphs and not self._graphs:
                self._capture_graphs()
            torch.cuda.synchronize(self.device)
        # the warm-up decode wrote garbage at position 0 of every slot;
        # real prefills overwrite it before any slot activates
        self._warm = self._compiles()
        self.warmup_compiles = self._cache.stats.delta(mark[0]).compiles
        self.warmup_builds = self._warm[1] - mark[1]
        return self.warmup_compiles

    def _admit(self, req: Request, slot: int, report: ServeReport,
               step: int = 0) -> str:
        """Prefill ``req`` into ``slot``.  Returns ``"ok"`` (admitted or
        satisfied outright), ``"rejected"`` (bad shape: no bucket, or
        prompt + generation past ``max_len``), ``"deadline"`` (its
        deadline passed while it queued) or ``"poisoned"`` (its prefill
        logits are not finite: the slot stays free, its cache row
        cleared).  An admitted request is an ``admit`` span
        (``repro_torch.tracing``), ending at its first token; its
        ``graph`` is 1 where the prefill replayed a captured graph."""
        plen = len(req.prompt)
        if req.deadline_step is not None and step > req.deadline_step:
            report.failures.append({
                "rid": req.rid, "reason": "deadline_queued", "step": step,
                "deadline": req.deadline_step})
            return "deadline"
        span = T.TRACER.begin("admit", req.rid, prompt_tokens=plen)
        bucket = self._bucket(plen)
        if bucket is None or plen + req.max_new_tokens > self.max_len:
            T.TRACER.discard(span)
            report.failures.append({
                "rid": req.rid, "reason": "bad_shape", "step": step,
                "prompt_len": plen, "max_new_tokens": req.max_new_tokens})
            return "rejected"
        span.attrs["bucket_tokens"] = bucket
        span.attrs["graph"] = int(bucket in self._graphs)
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :plen] = req.prompt
        logits = self._prefill(padded, slot)
        # the next-token logits sit at the last REAL position; pad
        # positions to the right are causally invisible to it
        row = logits[:, plen - 1:plen]
        if not bool(torch.isfinite(row).all()):
            T.TRACER.discard(span)
            report.n_poisoned += 1
            report.failures.append({
                "rid": req.rid, "reason": "nonfinite_prefill", "step": step,
                "prompt_len": plen})
            # the prefill wrote the slot: clear it, or the free slot's
            # decode row (at position 0, over the whole row) turns NaN,
            # and an MoE layer's dropped assignments add NaN x 0 into
            # live rows
            for t in self.caches.values():
                t[:, slot].zero_()
            return "poisoned"
        tok = int(self._sample(row)[0])
        T.TRACER.end(span)
        if self.record_logits:
            report.logits[req.rid] = [row[0, 0].float().cpu()]
        if req.max_new_tokens <= 1:
            report.tokens[req.rid] = [tok]
            report.n_completed += 1
            return "ok"
        self.slots[slot] = _Slot(rid=req.rid, pos=plen,
                                 remaining=req.max_new_tokens - 1,
                                 last_token=tok, generated=[tok],
                                 deadline=req.deadline_step)
        return "ok"

    def _watchdog_demote(self, err: BaseException, step: int,
                         report: ServeReport) -> dict:
        """The decode step raised: rebuild decode one rung down the
        serving ladder and keep serving.  Params and the KV cache do not
        depend on the rung, so active sequences continue in place;
        prefill (which did not fail) stays as it is.  Returns the
        demotion's failure record; raises ``err`` when there is no rung
        left, and always on a CUDA device: on CUDA tensors a kernel
        launches or raises, never giving way to its plain version."""
        from repro_torch.models import build_model

        new_cfg, label = (_demote_cfg(self.cfg) if self._ladder
                          else (None, None))
        if new_cfg is None:
            raise err
        if self._ledger is not None:
            # open the failed rung's breaker (threshold 1: a decode crash
            # is never cheap) so re-promotion waits out the cool-down
            old_label = _backend_label(self.cfg)
            self._demote_stack.append((self.cfg, old_label))
            self._ledger.record_failure(self._hkey, old_label, err,
                                        policy=self._breaker_policy)
        self.cfg = new_cfg
        self.model = build_model(new_cfg)
        self.watchdog_demotions += 1
        rec = {"reason": "decode_demotion", "step": step, "to": label,
               "error": f"{type(err).__name__}: {err}"}
        report.failures.append(rec)
        warnings.warn(
            f"serve watchdog: decode step failed ({type(err).__name__}: "
            f"{err}); demoted decode to {label} and continuing",
            RuntimeWarning, stacklevel=2)
        return rec

    def _probe_repromote(self, report: ServeReport, step: int) -> bool:
        """Half-open probe of the rung decode was demoted off: one decode
        step on it, on a **copy** of the KV cache (the decode step writes
        the cache in place; a probe that writes NaN or garbage must never
        reach a live sequence), its logits discarded.  Finite logits swap
        the rung back in and close the breaker; a failure re-opens it at
        doubled cool-down.  Its compiles and builds are explained, and its
        record carries its wall time (``ms``)."""
        from repro_torch.models import build_model

        old_cfg, old_label = self._demote_stack[-1]
        self.probes += 1
        mark = self._compiles()
        t0 = time.perf_counter()
        try:
            spec = RZ.fire("serve:probe")
            if spec is not None and spec.kind == "raise":
                raise RZ.InjectedFault(f"serve:probe[{spec.message}]")
            model = build_model(old_cfg)
            self._track(old_cfg, decode_batch=self.max_batch)
            scratch = {name: t.clone() for name, t in self.caches.items()}
            logits, _ = self._step(*self._decode_inputs(), model, scratch)
            if spec is not None and spec.kind == "nan":
                logits[:, -1] = float("nan")
            if not bool(torch.isfinite(logits[:, -1]).all()):
                raise RuntimeError("probe produced non-finite logits")
        except Exception as e:
            self.probe_failures += 1
            self._ledger.record_failure(self._hkey, old_label, e,
                                        policy=self._breaker_policy)
            report.failures.append({
                "reason": "probe_failed", "step": step, "rung": old_label,
                "error": f"{type(e).__name__}: {e}",
                "ms": (time.perf_counter() - t0) * 1e3})
            warnings.warn(
                f"serve: re-promotion probe of {old_label!r} failed "
                f"({type(e).__name__}: {e}); breaker re-opened at doubled "
                "cool-down", RuntimeWarning, stacklevel=2)
            healed = False
        else:
            self.cfg, self.model = old_cfg, model
            self._demote_stack.pop()
            self.repromotions += 1
            self._ledger.record_success(self._hkey, old_label)
            report.failures.append({
                "reason": "decode_repromotion", "step": step,
                "to": old_label, "ms": (time.perf_counter() - t0) * 1e3})
            warnings.warn(
                f"serve: decode rung {old_label!r} probed healthy after "
                f"{self._clean_ticks} clean ticks; re-promoted",
                RuntimeWarning, stacklevel=2)
            healed = True
        self._clean_ticks = 0
        self.explained_compiles += self._compiled_since(mark)
        self._warm = self._compiles()
        return healed

    def run(self, trace: Sequence[Request],
            max_steps: Optional[int] = None) -> ServeReport:
        """Drive the trace to completion (or ``max_steps``) and report."""
        if self._warm is None:
            self.warmup()
        self._launch_base = {name: k.launches
                             for name, k in self.kernels.items()}
        pending = deque(sorted(trace, key=lambda r: r.arrival_step))
        report = ServeReport(n_requests=len(trace), device=str(self.device))
        occupancy_sum = 0
        step = 0
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda *a: None))
        t_run = time.perf_counter()
        while pending or self.queue or any(self.slots):
            if max_steps is not None and step >= max_steps:
                break
            self._tick = step  # the health ledger's clock
            tick = T.TRACER.begin("tick")
            while pending and pending[0].arrival_step <= step:
                req = pending.popleft()
                if (self.max_queue is not None
                        and len(self.queue) >= self.max_queue):
                    # bounded admission: reject loudly instead of
                    # building an unbounded backlog
                    report.n_rejected += 1
                    report.failures.append({
                        "rid": req.rid, "reason": "queue_full",
                        "step": step, "queue_depth": len(self.queue)})
                else:
                    self.queue.append(req)
            n_prefill = 0
            for slot in [i for i, s in enumerate(self.slots) if s is None]:
                if not self.queue:
                    break
                req = self.queue.popleft()
                status = self._admit(req, slot, report, step)
                if status == "ok":
                    n_prefill += 1
                    report.prefill_tokens += len(req.prompt)
                    report.decode_tokens += 1  # the prefill's first token
                elif status == "rejected":
                    report.n_rejected += 1
                elif status == "deadline":
                    report.n_deadline_evicted += 1
            active = [i for i, s in enumerate(self.slots) if s is not None]
            n_decode = 0
            moe: Dict[str, int] = {}
            if active:
                try:
                    logits, counts = self._decode_once()
                    self._clean_ticks += 1
                except Exception as err:  # the watchdog: demote, retry
                    mark, t_err = self._compiles(), time.perf_counter()
                    rec = self._watchdog_demote(err, step, report)
                    # the retry writes in place what the failed step may
                    # have written: the same token at the same position,
                    # each layer writing its k/v there before its
                    # attention reads it; earlier positions are
                    # untouched and later ones masked
                    try:
                        logits, counts = self._decode_once()
                    except Exception as retry_err:
                        # the demoted rung fails too: serve no further
                        raise err from retry_err
                    # what the demotion cost the tick: the demoted rung's
                    # compiles and its first decode
                    rec["ms"] = (time.perf_counter() - t_err) * 1e3
                    self.explained_compiles += self._compiled_since(mark)
                    self._warm = self._compiles()
                    self._clean_ticks = 0
                spec = RZ.fire("serve:logits")
                if spec is not None and spec.kind == "nan":
                    # poison exactly one co-batched row; the guard below
                    # must contain it to that sequence
                    logits[active[0], -1] = float("nan")
                with T.TRACER.span("decode.read"):
                    fin, counts = self._read_decode(logits, counts)
                if counts is not None:
                    moe["moe_rows"] = int(counts[-1])
                    moe["moe_assigned"] = int(counts[:-1][active].sum())
                for i in active:
                    if fin[i]:
                        continue
                    s = self.slots[i]
                    report.n_poisoned += 1
                    report.failures.append({
                        "rid": s.rid, "reason": "nonfinite_logits",
                        "step": step, "pos": s.pos})
                    report.tokens[s.rid] = s.generated
                    self.slots[i] = None
                active = [i for i in active if fin[i]]
                sampled = self._sample(logits)
                for i in active:
                    s = self.slots[i]
                    tok = int(sampled[i])
                    if self.record_logits:
                        report.logits[s.rid].append(
                            logits[i, -1].float().cpu())
                    s.pos += 1
                    s.generated.append(tok)
                    s.last_token = tok
                    s.remaining -= 1
                    n_decode += 1
                    if s.remaining <= 0 or s.pos >= self.max_len:
                        if s.remaining > 0:
                            report.n_evicted_stalled += 1
                        else:
                            report.n_completed += 1
                        report.tokens[s.rid] = s.generated
                        self.slots[i] = None
                    elif s.deadline is not None and step >= s.deadline:
                        report.n_deadline_evicted += 1
                        report.failures.append({
                            "rid": s.rid, "reason": "deadline",
                            "step": step, "deadline": s.deadline})
                        report.tokens[s.rid] = s.generated
                        self.slots[i] = None
            # re-promotion: after enough clean ticks on a demoted rung,
            # the breaker admits one half-open probe of the rung above
            if (self._demote_stack and self._ledger is not None
                    and self._clean_ticks >= self.repromote_after
                    and self._ledger.decision(
                        self._hkey, self._demote_stack[-1][1]) == "probe"):
                self._probe_repromote(report, step)
            sync()
            T.TRACER.end(tick, n_prefill=n_prefill, n_decode=n_decode,
                         **moe)
            occ = sum(1 for s in self.slots if s is not None)
            occupancy_sum += occ
            report.decode_tokens += n_decode
            report.per_step.append(StepRecord(
                step=step, queue_depth=len(self.queue), occupancy=occ,
                n_prefill=n_prefill, n_decode=n_decode,
                wall_ms=tick.ns / 1e6))
            report.max_queue_depth = max(report.max_queue_depth,
                                         len(self.queue))
            step += 1

        report.steps = step
        report.wall_s = time.perf_counter() - t_run
        report.mean_occupancy = occupancy_sum / max(step, 1)
        life = self._cache.stats.delta(self._base)
        report.cache_memory_hits = life.memory_hits
        report.cache_disk_hits = life.disk_hits
        report.cache_misses = life.misses
        report.cache_hit_rate = life.hit_rate
        report.quarantined = life.quarantined
        report.warmup_compiles = self.warmup_compiles
        report.warmup_builds = self.warmup_builds
        report.decode_recompiles = self._compiled_since(self._warm)
        report.kernel_launches = {name: k.launches - self._launch_base[name]
                                  for name, k in self.kernels.items()}
        report.degradations = (RZ.METRICS.delta(self._base_metrics).demotions
                               + self.watchdog_demotions)
        report.cuda_degraded = self.cuda_degraded
        report.repromotions = self.repromotions
        report.probes = self.probes
        report.probe_failures = self.probe_failures
        report.decode_backend = _backend_label(self.cfg)
        if report.decode_recompiles:
            raise RuntimeError(
                f"{report.decode_recompiles} compiles or nvcc builds after "
                "warmup that no demotion or probe explains: a "
                "steady-state step met a shape outside the warmed set")
        return report
