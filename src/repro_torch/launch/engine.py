"""Continuous-batching decode engine of the torch port: the port of
``repro.launch.engine``.

An open-loop arrival trace feeds a slot scheduler that

* admits requests into free KV-cache slots, prefilling each prompt padded
  to a *shape bucket* (exact under causal masking: pad keys sit only at
  future positions, and later decode steps overwrite them);
* runs ONE ragged decode step per tick across every active slot, each
  sequence at its own cache position.  Positions are kernel data (the
  causal mask's QP/KP inputs), so the same compiled kernels serve every
  step;
* evicts finished sequences, stalled ones (cache slot exhausted) and
  sequences whose logits turn non-finite.

``warmup()`` compiles every kernel the loop can touch (one attention and
one SwiGLU kernel per prompt bucket plus the decode pair), builds the CUDA
ones together, and runs each once; ``run()`` then pins zero pipeline
compiles (``CacheStats.delta`` of ``pipeline.default_cache()``: plans
compiled or loaded from disk) and zero nvcc builds.  A warmup in a fresh
process over a cache directory another process filled loads every plan
from disk (``ServeReport.cache_disk_hits``) and builds nothing.  The
reference's watchdog demotion and re-promotion, deadlines and bounded
queue wait for the resilience slice: on the card they would be a
fallback away from the kernels.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


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
    wall_ms: float


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
    decode_tokens: int = 0
    tokens_per_s: float = 0.0
    decode_tokens_per_s: float = 0.0
    p50_token_ms: float = 0.0
    p99_token_ms: float = 0.0
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
                                 # warmup; MUST be 0
    # launches of every emitted kernel during the run, by
    # "<program>/<kernel id>"
    kernel_launches: Dict[str, int] = field(default_factory=dict)
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


class Engine:
    """Slot-based continuous-batching scheduler over ``models.lm.LM``."""

    def __init__(self, cfg, *, params=None, device="cuda",
                 max_batch: int = 4, max_len: int = 96,
                 prompt_buckets: Sequence[int] = (8, 16, 32),
                 sampling: str = "greedy", temperature: float = 1.0,
                 seed: int = 0, record_logits: bool = False):
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
        self._gen = torch.Generator().manual_seed(seed)
        self.model = build_model(cfg)
        self.params = (params if params is not None
                       else self.model.init_params(seed, self.device))
        self.caches = self.model.init_cache(self.max_batch, self.max_len,
                                            self.device)
        self.slots: List[Optional[_Slot]] = [None] * self.max_batch
        self.queue: deque = deque()
        self.kernels: Dict[str, object] = {}
        from repro_torch import pipeline
        # the kernel cache the engine compiles in, and its counters when
        # the engine was made (the report's cache fields count from here)
        self._cache = pipeline.default_cache()
        self._base = self._cache.stats.snapshot()
        self._warm = None        # the counters after warmup
        self.warmup_compiles = 0
        self.warmup_builds = 0

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

    def _prefill(self, padded: np.ndarray):
        return self.model.prefill(self.params, self._tensor(padded),
                                  max_len=self.max_len)

    def _decode(self):
        toks = [s.last_token if s else 0 for s in self.slots]
        pos = [s.pos if s else 0 for s in self.slots]
        return self.model.decode_step(self.params, self.caches,
                                      self._tensor(toks)[:, None],
                                      self._tensor(pos))

    def _insert(self, cache, slot: int) -> None:
        for name in ("k", "v"):
            self.caches[name][:, slot] = cache[name][:, 0]

    # -- lifecycle ------------------------------------------------------------
    def warmup(self) -> int:
        """Compile every pipeline kernel the run loop can touch, build the
        CUDA ones together, and run each once.  ``run()`` pins the
        steady state against the counters taken here.  Returns the number
        of pipeline compiles (plans compiled or loaded from disk)."""
        from repro_torch.core import codegen_cuda, cuda_build
        from repro_torch.models import layers as L

        c0, b0 = self._cache.stats.snapshot(), cuda_build.STATS["builds"]
        cfg = self.cfg
        programs = L.pipeline_kernels(cfg, prefill_lens=self.prompt_buckets,
                                      decode_batch=self.max_batch,
                                      max_len=self.max_len)
        self.kernels = {}
        for prog, kern in programs.items():
            for k in kern.kernels:
                self.kernels[f"{prog}/{k.gid}"] = k
        if self.device.type == "cuda":
            codegen_cuda.build(list(self.kernels.values()))
        for b in self.prompt_buckets:
            lg, cache = self._prefill(np.zeros((1, b), np.int64))
            self._insert(cache, 0)
        lg, _ = self._decode()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # the warm-up decode wrote garbage at position 0 of every slot;
        # real prefills overwrite it before any slot activates
        self.warmup_compiles = self._cache.stats.delta(c0).compiles
        self.warmup_builds = cuda_build.STATS["builds"] - b0
        self._warm = (self._cache.stats.snapshot(),
                      cuda_build.STATS["builds"])
        return self.warmup_compiles

    def _admit(self, req: Request, slot: int, report: ServeReport) -> str:
        plen = len(req.prompt)
        bucket = self._bucket(plen)
        if bucket is None or plen + req.max_new_tokens > self.max_len:
            report.failures.append({
                "rid": req.rid, "reason": "bad_shape",
                "prompt_len": plen, "max_new_tokens": req.max_new_tokens})
            return "rejected"
        padded = np.zeros((1, bucket), np.int64)
        padded[0, :plen] = req.prompt
        logits, cache = self._prefill(padded)
        # the next-token logits sit at the last REAL position; pad
        # positions to the right are causally invisible to it
        row = logits[:, plen - 1:plen]
        if not bool(torch.isfinite(row).all()):
            report.n_poisoned += 1
            report.failures.append({"rid": req.rid,
                                    "reason": "nonfinite_prefill"})
            return "poisoned"
        self._insert(cache, slot)
        tok = int(self._sample(row)[0])
        if self.record_logits:
            report.logits[req.rid] = [row[0, 0].float().cpu()]
        if req.max_new_tokens <= 1:
            report.tokens[req.rid] = [tok]
            report.n_completed += 1
            return "ok"
        self.slots[slot] = _Slot(rid=req.rid, pos=plen,
                                 remaining=req.max_new_tokens - 1,
                                 last_token=tok, generated=[tok])
        return "ok"

    def run(self, trace: Sequence[Request],
            max_steps: Optional[int] = None) -> ServeReport:
        """Drive the trace to completion (or ``max_steps``) and report."""
        if self._warm is None:
            self.warmup()
        start = {name: k.launches for name, k in self.kernels.items()}
        pending = deque(sorted(trace, key=lambda r: r.arrival_step))
        report = ServeReport(n_requests=len(trace), device=str(self.device))
        token_lat_ms: List[float] = []
        occupancy_sum = 0
        step = 0
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda *a: None))
        t_run = time.perf_counter()
        while pending or self.queue or any(self.slots):
            if max_steps is not None and step >= max_steps:
                break
            t0 = time.perf_counter()
            while pending and pending[0].arrival_step <= step:
                self.queue.append(pending.popleft())
            n_prefill = 0
            for slot in [i for i, s in enumerate(self.slots) if s is None]:
                if not self.queue:
                    break
                req = self.queue.popleft()
                status = self._admit(req, slot, report)
                if status == "ok":
                    n_prefill += 1
                    report.prefill_tokens += len(req.prompt)
                    report.decode_tokens += 1  # the prefill's first token
                elif status == "rejected":
                    report.n_rejected += 1
            active = [i for i, s in enumerate(self.slots) if s is not None]
            n_decode = 0
            if active:
                logits, self.caches = self._decode()
                fin = torch.isfinite(logits[:, -1]).all(-1).cpu().numpy()
                for i in active:
                    if fin[i]:
                        continue
                    s = self.slots[i]
                    report.n_poisoned += 1
                    report.failures.append({"rid": s.rid, "step": step,
                                            "reason": "nonfinite_logits"})
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
            sync()
            wall_ms = (time.perf_counter() - t0) * 1e3
            token_lat_ms.extend([wall_ms] * (n_decode + n_prefill))
            occ = sum(1 for s in self.slots if s is not None)
            occupancy_sum += occ
            report.decode_tokens += n_decode
            report.per_step.append(StepRecord(
                step=step, queue_depth=len(self.queue), occupancy=occ,
                n_prefill=n_prefill, n_decode=n_decode, wall_ms=wall_ms))
            report.max_queue_depth = max(report.max_queue_depth,
                                         len(self.queue))
            step += 1

        report.steps = step
        report.wall_s = time.perf_counter() - t_run
        total = report.prefill_tokens + report.decode_tokens
        report.tokens_per_s = total / max(report.wall_s, 1e-9)
        report.decode_tokens_per_s = (report.decode_tokens
                                      / max(report.wall_s, 1e-9))
        if token_lat_ms:
            report.p50_token_ms = float(np.percentile(token_lat_ms, 50))
            report.p99_token_ms = float(np.percentile(token_lat_ms, 99))
        report.mean_occupancy = occupancy_sum / max(step, 1)
        from repro_torch.core import cuda_build
        life = self._cache.stats.delta(self._base)
        report.cache_memory_hits = life.memory_hits
        report.cache_disk_hits = life.disk_hits
        report.cache_misses = life.misses
        report.cache_hit_rate = life.hit_rate
        report.quarantined = life.quarantined
        report.warmup_compiles = self.warmup_compiles
        report.warmup_builds = self.warmup_builds
        report.decode_recompiles = (
            self._cache.stats.delta(self._warm[0]).compiles
            + cuda_build.STATS["builds"] - self._warm[1])
        report.kernel_launches = {name: k.launches - start[name]
                                  for name, k in self.kernels.items()}
        if report.decode_recompiles:
            raise RuntimeError(
                f"{report.decode_recompiles} compiles or nvcc builds after "
                "warmup: a steady-state step met a shape outside the "
                "warmed set")
        return report
