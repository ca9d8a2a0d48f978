"""``repro_torch.resilience``: the degradation ladder, fault isolation and
deterministic fault injection of the torch port's compile pipeline and
serving engine, a copy of ``repro.resilience`` (``src/repro/resilience.py``)
kept in the torch package so it never imports the JAX package.

Lowering can fail on some backend and shape, on-disk state can corrupt,
and a request can produce non-finite logits.  This module is the shared
vocabulary for surviving all three:

* **The ladder**: :data:`LADDER` orders the compile strategies from
  fastest to most conservative::

      grouped      one emitted CUDA kernel per region group
      ungrouped    one emitted CUDA kernel per region (no residency)
      torch        the plain whole-program lowering (codegen_torch)
      interpreter  the numpy interpreter (always correct; the CPU only)

  ``pipeline.compile`` starts at the rung its options ask for and, when
  an attempt raises or times out, *demotes* one rung at a time until
  :class:`ResiliencePolicy.max_rung`, recording every attempt in a
  :class:`ResilienceReport` on the returned kernel.  Every demotion is
  loud: a ``RuntimeWarning``, the report, and :data:`METRICS`.  For a
  CUDA device the driver offers ``torch`` and ``interpreter`` only when
  the options ask for them: on the card a compile never demotes to a
  plain version.  The default policy adds no happy-path work: no timeout thread, no retry
  sleep, one ``try`` around the lowering call that already existed.

* **Fault injection**: :class:`FaultPlan` fires deterministic faults
  (exceptions, slow compiles, cache corruption, NaN logits) at chosen
  per-site call indices.  Sites are string names checked by the code
  paths (``compile:<rung>``, ``cache:get_plan``, ``serve:decode``,
  ``serve:logits``, ``serve:probe``); an inactive plan costs one ``None``
  check.  Activate programmatically (:func:`install` / :func:`faults`) or
  via ``$REPRO_TORCH_FAULT_PLAN`` (inline JSON or a path to a JSON file).
  The variable is the port's own: a process that imports both packages
  never fires one package's plan in the other.

* **The health ledger**: :class:`HealthLedger` is a per-(key, rung)
  circuit breaker: ``closed`` (healthy) -> ``open`` after
  ``breaker_threshold`` consecutive failures (cool-down doubles per
  trip) -> ``half_open`` after the cool-down, admitting exactly one
  *probe*; a passing probe closes the breaker, a failing one re-opens
  it at doubled cool-down.  Entries persist as checksummed JSON
  envelopes (``pipeline.cache``'s) under ``<cache>/health/``, so rung
  health survives process restarts and is shared cross-process.
  ``pipeline.compile`` consults it to skip known-open rungs instantly,
  and the serving engine uses it to *re-promote* a demoted decode rung
  after N clean ticks.  The happy path does zero ledger I/O: no entries
  exist until a rung fails.

* **Metrics**: :data:`METRICS` counts ladder demotions process-wide (the
  serving engine reports the delta per run), as ``pipeline.CacheStats``
  counts quarantines.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import warnings
from contextlib import contextmanager
from dataclasses import asdict, dataclass, field, fields, replace
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# fastest first; each entry is strictly more conservative than the one
# before it.  ``pipeline.compile`` maps its options to a starting rung
# (cuda+group -> grouped, cuda -> ungrouped, torch -> torch, py ->
# interpreter) and only ever moves DOWN the list.
LADDER = ("grouped", "ungrouped", "torch", "interpreter")

FAULT_KINDS = ("raise", "sleep", "nan", "corrupt")


class InjectedFault(RuntimeError):
    """Raised by :func:`check` at a site a :class:`FaultPlan` targets."""


class AttemptTimeout(RuntimeError):
    """A ladder attempt exceeded ``ResiliencePolicy.attempt_timeout_s``.
    The underlying work keeps running in its worker thread (python
    cannot kill it); the ladder moves on without waiting."""


class LadderError(RuntimeError):
    """Every allowed rung failed.  ``.report`` carries the full
    per-attempt record (rung, elapsed, error) for triage."""

    def __init__(self, msg: str, report: "ResilienceReport"):
        super().__init__(msg)
        self.report = report


def rung_index(rung: str) -> int:
    if rung not in LADDER:
        raise ValueError(f"unknown ladder rung {rung!r}; one of {LADDER}")
    return LADDER.index(rung)


def start_rung(backend: str, group: bool) -> str:
    """The rung ``pipeline.compile`` starts at for a backend/group pair."""
    if backend == "cuda":
        return "grouped" if group else "ungrouped"
    if backend == "torch":
        return "torch"
    return "interpreter"


def rungs_from(start: str, max_rung: str) -> Tuple[str, ...]:
    """The rungs a compile may attempt, in order: ``start`` down to
    ``max_rung`` inclusive.  A ``max_rung`` *above* the start permits no
    demotion at all — only the starting rung is attempted."""
    s, m = rung_index(start), rung_index(max_rung)
    if m < s:
        return (start,)
    return LADDER[s:m + 1]


@dataclass(frozen=True)
class ResiliencePolicy:
    """How far, how patiently, and how often a compile may retry before
    demoting.  Frozen and hashable: lives on ``CompileOptions`` and
    participates in the kernel-cache key (non-default policies only, so
    default cache keys stay byte-identical to pre-resilience builds).

    * ``max_rung`` — the deepest ladder rung a compile may demote to;
      exhausting it raises :class:`LadderError`.
    * ``attempt_timeout_s`` — wall-clock budget per attempt; ``None``
      (default) runs inline with no watchdog thread.
    * ``retries`` — extra same-rung attempts for transient failures
      (including timeouts) before demoting, with exponential backoff
      ``backoff_s * 2**retry`` between them.
    * ``breaker_threshold`` — consecutive failures of a (fingerprint,
      rung) pair before its :class:`HealthLedger` breaker opens and the
      rung is skipped without an attempt; ``0`` disables the breaker.
    * ``breaker_cooldown_s`` / ``breaker_cooldown_max_s`` — how long an
      open breaker waits before admitting a half-open probe; doubles
      per trip, capped at the max.
    """

    max_rung: str = "interpreter"
    attempt_timeout_s: Optional[float] = None
    retries: int = 0
    backoff_s: float = 0.05
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 60.0
    breaker_cooldown_max_s: float = 3600.0

    def __post_init__(self):
        rung_index(self.max_rung)  # validate
        if self.retries < 0:
            raise ValueError(f"retries must be >= 0, got {self.retries}")
        if self.breaker_threshold < 0:
            raise ValueError(
                f"breaker_threshold must be >= 0, got {self.breaker_threshold}")

    def key(self) -> Tuple:
        """Canonical value tuple (hashing / cache-key embedding)."""
        return (self.max_rung, self.attempt_timeout_s, int(self.retries),
                float(self.backoff_s), int(self.breaker_threshold),
                float(self.breaker_cooldown_s),
                float(self.breaker_cooldown_max_s))


DEFAULT_POLICY = ResiliencePolicy()


@dataclass
class Attempt:
    """One ladder attempt: a (rung, retry) pair and how it went."""

    rung: str
    ok: bool
    elapsed_s: float              # wall time of this attempt (calibration
                                  # input for attempt_timeout_s)
    error: Optional[str] = None   # "ExcType: message" when not ok
    retry: int = 0                # 0 = first try at this rung
    timed_out: bool = False
    skipped_open: bool = False    # breaker open: rung skipped, not run
    probe: bool = False           # half-open probe after cool-down


@dataclass
class ResilienceReport:
    """The compile's fault provenance: which rung was requested, which
    rung actually served it, and every attempt in between.  Attached to
    ``CompiledKernel.resilience_report`` on every compile (the happy
    path is one ok attempt at the requested rung, zero demotions)."""

    requested: str = "grouped"
    rung: Optional[str] = None        # the rung that served the compile
    attempts: List[Attempt] = field(default_factory=list)
    # RegionError from the driver's region partitioning, when the
    # partitioner could not split the selected snapshot (the lowering
    # then took emit_program's whole-program fallback)
    plan_error: Optional[str] = None

    @property
    def demotions(self) -> int:
        """Rungs descended from the requested one (0 on the happy path)."""
        if self.rung is None:
            return 0
        return max(rung_index(self.rung) - rung_index(self.requested), 0)

    @property
    def errors(self) -> List[str]:
        return [a.error for a in self.attempts if a.error]

    @property
    def skipped_open(self) -> int:
        """Rungs skipped because their health-ledger breaker was open."""
        return sum(1 for a in self.attempts if a.skipped_open)

    @property
    def probes(self) -> int:
        """Half-open probe attempts admitted after a cool-down."""
        return sum(1 for a in self.attempts if a.probe)

    def wall_by_rung(self) -> Dict[str, List[float]]:
        """Wall times of every *executed* attempt, grouped by rung — the
        raw material for calibrating ``attempt_timeout_s`` from real
        measurements instead of guesses."""
        out: Dict[str, List[float]] = {}
        for a in self.attempts:
            if not a.skipped_open:
                out.setdefault(a.rung, []).append(a.elapsed_s)
        return out

    def suggest_timeout_s(self, margin: float = 4.0) -> Optional[float]:
        """A candidate ``attempt_timeout_s``: the slowest *successful*
        attempt times ``margin``.  ``None`` when nothing succeeded."""
        oks = [a.elapsed_s for a in self.attempts if a.ok]
        return max(oks) * float(margin) if oks else None

    def to_json(self) -> Dict[str, Any]:
        d = asdict(self)
        d["demotions"] = self.demotions
        d["skipped_open"] = self.skipped_open
        d["probes"] = self.probes
        return d

    def summary(self) -> str:
        steps = ", ".join(
            f"{a.rung}{'#%d' % a.retry if a.retry else ''}:"
            f"{'skip-open' if a.skipped_open else ('ok' if a.ok else ('timeout' if a.timed_out else 'fail'))}"
            for a in self.attempts)
        return (f"requested={self.requested} served={self.rung} "
                f"demotions={self.demotions} [{steps}]")


# ---------------------------------------------------------------------------
# process-wide resilience metrics (mirrors pipeline.CacheStats)
# ---------------------------------------------------------------------------

@dataclass
class ResilienceMetrics:
    demotions: int = 0         # ladder rungs descended (compile pipeline)
    ladder_failures: int = 0   # compiles that exhausted every rung
    faults_fired: int = 0      # injected faults that actually fired
    abandoned_workers: int = 0  # timeout workers left running (daemonic)
    skipped_open: int = 0      # ladder rungs skipped on an open breaker
    probes: int = 0            # half-open probe attempts (compile ladder)
    probe_failures: int = 0    # probes that failed (breaker re-opened)

    def snapshot(self) -> "ResilienceMetrics":
        return replace(self)

    def delta(self, since: "ResilienceMetrics") -> "ResilienceMetrics":
        return ResilienceMetrics(**{
            f.name: getattr(self, f.name) - getattr(since, f.name)
            for f in fields(self)})


METRICS = ResilienceMetrics()


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FaultSpec:
    """Fire ``kind`` at ``site`` on the listed 0-based call indices.

    Kinds: ``raise`` (an :class:`InjectedFault` from :func:`check`),
    ``sleep`` (stall ``sleep_s`` — drives the attempt-timeout path),
    ``nan`` / ``corrupt`` (returned to the caller, which applies the
    mutation itself: the engine NaNs one logits row, the kernel cache
    garbles the on-disk entry so the REAL integrity machinery detects
    it)."""

    site: str
    indices: Tuple[int, ...] = (0,)
    kind: str = "raise"
    message: str = "injected fault"
    sleep_s: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")
        object.__setattr__(self, "indices",
                           tuple(int(i) for i in self.indices))

    def to_json(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "FaultSpec":
        return cls(site=str(d["site"]),
                   indices=tuple(d.get("indices", (0,))),
                   kind=str(d.get("kind", "raise")),
                   message=str(d.get("message", "injected fault")),
                   sleep_s=float(d.get("sleep_s", 0.0)))


class FaultPlan:
    """A deterministic schedule of faults.  Each production site calls
    :func:`fire`; the plan counts the call (per site) and fires the
    matching :class:`FaultSpec` when the count hits one of its indices.
    Everything is index-based, so the same plan against the same code
    path fires identically every run — that is what lets the chaos CI
    job pin quarantine/demotion counters *exactly*.

    ``seed`` is provenance (recorded in reports) and the randomness
    source for :meth:`seeded` helpers; the plan itself is deterministic
    by construction."""

    def __init__(self, specs: Sequence[FaultSpec] = (), *, seed: int = 0):
        self.specs = tuple(specs)
        self.seed = int(seed)
        self._by_site: Dict[str, List[FaultSpec]] = {}
        for s in self.specs:
            self._by_site.setdefault(s.site, []).append(s)
        self._calls: Dict[str, int] = {}
        self.fired: List[Tuple[str, int, str]] = []  # (site, index, kind)
        self._lock = threading.Lock()

    def fire(self, site: str) -> Optional[FaultSpec]:
        """Count one call at ``site``; return the spec that fires at
        this index, if any (thread-safe: ladder attempts may run in
        timeout worker threads)."""
        with self._lock:
            idx = self._calls.get(site, 0)
            self._calls[site] = idx + 1
            for spec in self._by_site.get(site, ()):
                if idx in spec.indices:
                    self.fired.append((site, idx, spec.kind))
                    METRICS.faults_fired += 1
                    return spec
        return None

    def calls(self, site: str) -> int:
        return self._calls.get(site, 0)

    def fired_count(self, site: Optional[str] = None) -> int:
        if site is None:
            return len(self.fired)
        return sum(1 for s, _, _ in self.fired if s == site)

    def expected_count(self, site_prefix: str = "") -> int:
        """How many faults this plan schedules at sites matching the
        prefix — what the chaos gate pins counters against."""
        return sum(len(s.indices) for s in self.specs
                   if s.site.startswith(site_prefix))

    def reset(self) -> None:
        with self._lock:
            self._calls.clear()
            self.fired.clear()

    def to_json(self) -> Dict[str, Any]:
        return {"seed": self.seed,
                "faults": [s.to_json() for s in self.specs]}

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "FaultPlan":
        return cls([FaultSpec.from_json(s) for s in d.get("faults", ())],
                   seed=int(d.get("seed", 0)))


_ACTIVE: Optional[FaultPlan] = None
#: the environment variable a plan is read from; not the reference's
#: ``REPRO_FAULT_PLAN``, so a process holding both packages keeps their
#: plans apart
ENV_VAR = "REPRO_TORCH_FAULT_PLAN"
# lazily-parsed $REPRO_TORCH_FAULT_PLAN, cached per env value so per-site
# call counters survive across active() calls
_ENV_PLAN: Tuple[Optional[str], Optional[FaultPlan]] = (None, None)


def install(plan: Optional[FaultPlan]) -> None:
    """Set (or clear, with ``None``) the process-wide fault plan."""
    global _ACTIVE
    _ACTIVE = plan


@contextmanager
def faults(plan: FaultPlan):
    """Scope a fault plan: ``with resilience.faults(plan): ...``."""
    prev = _ACTIVE
    install(plan)
    try:
        yield plan
    finally:
        install(prev)


def active() -> Optional[FaultPlan]:
    """The installed plan, else one parsed from ``$REPRO_TORCH_FAULT_PLAN``
    (inline JSON or a path to a JSON file), else ``None``."""
    if _ACTIVE is not None:
        return _ACTIVE
    global _ENV_PLAN
    raw = os.environ.get(ENV_VAR)
    if not raw:
        return None
    if _ENV_PLAN[0] == raw:
        return _ENV_PLAN[1]
    text = raw
    if not raw.lstrip().startswith("{"):
        with open(raw) as f:
            text = f.read()
    plan = FaultPlan.from_json(json.loads(text))
    _ENV_PLAN = (raw, plan)
    return plan


def fire(site: str) -> Optional[FaultSpec]:
    """Consult the active plan at ``site``.  No plan -> ``None`` (one
    global read: the cost injection adds to the happy path)."""
    plan = active()
    return plan.fire(site) if plan is not None else None


def check(site: str) -> None:
    """The compile-site hook: raise on ``raise`` faults, stall on
    ``sleep`` faults (so an ``attempt_timeout_s`` watchdog can catch the
    slow compile), ignore kinds the site does not implement."""
    spec = fire(site)
    if spec is None:
        return
    if spec.kind == "sleep":
        time.sleep(spec.sleep_s)
        return
    if spec.kind == "raise":
        raise InjectedFault(f"{site}[{spec.message}]")


# ---------------------------------------------------------------------------
# timeout runner
# ---------------------------------------------------------------------------

def run_with_timeout(fn, timeout_s: float):
    """Run ``fn()`` in a **daemon** worker thread and wait at most
    ``timeout_s``.  On timeout the worker keeps running (python offers
    no preemption) but the caller gets :class:`AttemptTimeout`
    immediately and the ladder moves on: a hung lowering must not hang
    the server.  The abandoned attempt's result is never used: the
    ladder returns only what an attempt it waited for produced, so its
    kernel is never the one cached.  The worker is daemonic so an abandoned
    attempt can never block process exit (``ThreadPoolExecutor``
    workers are non-daemon and join at interpreter shutdown, which
    turned one hung compile into a hung process); every abandonment is
    counted in ``METRICS.abandoned_workers``."""
    done = threading.Event()
    box: List[Any] = [None, None]  # [result, exception]

    def _worker():
        try:
            box[0] = fn()
        except BaseException as e:  # propagate *any* failure to the caller
            box[1] = e
        finally:
            done.set()

    t = threading.Thread(target=_worker, name="repro-torch-ladder-worker",
                         daemon=True)
    t.start()
    if not done.wait(timeout_s):
        METRICS.abandoned_workers += 1
        raise AttemptTimeout(
            f"attempt exceeded {timeout_s:g}s (daemon worker left running)")
    if box[1] is not None:
        raise box[1]
    return box[0]


# ---------------------------------------------------------------------------
# the health ledger: a persistent per-(key, rung) circuit breaker
# ---------------------------------------------------------------------------

BREAKER_STATES = ("closed", "open", "half_open")
_LEDGER_SCHEMA = 1


@dataclass
class BreakerEntry:
    """Health of one (key, rung) pair.  ``key`` is a graph fingerprint
    for compile-side breakers or ``serve:<model>:decode`` for the
    engine's decode breaker."""

    key: str
    rung: str
    state: str = "closed"
    failures: int = 0        # consecutive failures while closed
    trips: int = 0           # closed/half_open -> open transitions
    cooldown_s: float = 0.0  # cool-down used at the last trip
    open_until: float = 0.0  # ledger-clock time the breaker half-opens
    last_error: Optional[str] = None
    updated_at: float = 0.0

    def to_json(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "BreakerEntry":
        known = {f.name for f in fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class HealthStats:
    """Ledger instrumentation.  ``reads``/``writes`` count *entry file*
    I/O — the zero-overhead acceptance pin: a healthy process never
    reads or writes a ledger entry."""

    reads: int = 0          # entry envelopes read from disk
    writes: int = 0         # entry envelopes written or removed
    skipped_open: int = 0   # decisions that returned "open"
    probes: int = 0         # decisions that admitted a half-open probe
    trips: int = 0          # breakers opened (incl. re-opens)
    resets: int = 0         # breakers closed again (recovery)
    corrupt: int = 0        # unreadable envelopes discarded

    def snapshot(self) -> "HealthStats":
        return replace(self)

    def delta(self, since: "HealthStats") -> "HealthStats":
        return HealthStats(**{
            f.name: getattr(self, f.name) - getattr(since, f.name)
            for f in fields(self)})


class HealthLedger:
    """A per-(key, rung) circuit breaker with optional on-disk
    persistence.

    States: ``closed`` (attempt normally) → ``open`` after
    ``breaker_threshold`` consecutive :meth:`record_failure` calls
    (skip the rung until the cool-down elapses; cool-down is
    ``breaker_cooldown_s * 2**(trips-1)`` capped at
    ``breaker_cooldown_max_s``) → ``half_open`` (one probe admitted by
    :meth:`decision`) → ``closed`` on :meth:`record_success`, or back
    to ``open`` at doubled cool-down on another failure.

    ``root=None`` keeps the ledger memory-only (``disk=False`` caches,
    unit tests).  With a root, every entry persists as a checksummed
    JSON envelope ``{"schema", "sha256", "entry"}`` written atomically
    (``pipeline.cache``'s envelope, tmp + fsync + rename; a crashed
    writer's tmp file is swept by ``KernelCache.recover``), so breaker
    state survives crashes and is shared by
    sibling processes pointed at the same kernel cache.  The directory
    is only created on the first write — a healthy install never even
    makes it, which is what keeps the happy path at zero ledger I/O.

    ``clock`` is injectable for determinism: the serving engine passes
    its tick counter, tests pass a fake; default is wall time.
    """

    def __init__(self, root: Optional[os.PathLike] = None, *,
                 clock: Callable[[], float] = time.time):
        self.root = Path(root) if root is not None else None
        self.clock = clock
        self.stats = HealthStats()
        self._entries: Dict[Tuple[str, str], BreakerEntry] = {}
        self._lock = threading.Lock()
        self._dir_seen = False  # latched True once <root> is known to exist

    # -- persistence ------------------------------------------------------

    def _path(self, key: str, rung: str) -> Optional[Path]:
        if self.root is None:
            return None
        h = hashlib.sha256(f"{key}|{rung}".encode()).hexdigest()[:32]
        return self.root / f"{h}.json"

    def _have_dir(self) -> bool:
        if self.root is None:
            return False
        if not self._dir_seen:
            self._dir_seen = self.root.is_dir()
        return self._dir_seen

    def _load(self, key: str, rung: str) -> Optional[BreakerEntry]:
        """The entry for (key, rung): in-memory first, then disk.  A
        missing or corrupt envelope is ``closed`` (fail open: a broken
        ledger must never take a healthy rung out of service)."""
        ck = (key, rung)
        if ck in self._entries:
            return self._entries[ck]
        path = self._path(key, rung)
        if path is None or not self._have_dir():
            return None
        try:
            raw = path.read_bytes()
        except OSError:
            return None
        self.stats.reads += 1
        from repro_torch.pipeline.cache import open_envelope
        try:
            entry = BreakerEntry.from_json(
                open_envelope(raw, "entry", _LEDGER_SCHEMA))
            if entry.state not in BREAKER_STATES:
                raise ValueError(f"state {entry.state!r}")
        except Exception as e:
            self.stats.corrupt += 1
            warnings.warn(
                f"health ledger: discarding corrupt entry {path} "
                f"({type(e).__name__}: {e})", RuntimeWarning, stacklevel=3)
            try:
                path.unlink()
            except OSError:
                pass
            return None
        self._entries[ck] = entry
        return entry

    def _store(self, entry: BreakerEntry) -> None:
        self._entries[(entry.key, entry.rung)] = entry
        path = self._path(entry.key, entry.rung)
        if path is None:
            return
        from repro_torch.pipeline.cache import KernelCache, envelope
        try:
            path.parent.mkdir(parents=True, exist_ok=True)
            self._dir_seen = True
            KernelCache._atomic_write(path, envelope(
                "entry", entry.to_json(), _LEDGER_SCHEMA).encode())
            self.stats.writes += 1
        except OSError as e:
            warnings.warn(f"health ledger: could not persist {path} ({e})",
                          RuntimeWarning, stacklevel=3)

    def _remove(self, key: str, rung: str) -> None:
        self._entries.pop((key, rung), None)
        path = self._path(key, rung)
        if path is not None and self._have_dir():
            try:
                path.unlink()
                self.stats.writes += 1
            except OSError:
                pass

    # -- breaker protocol -------------------------------------------------

    def state(self, key: str, rung: str) -> str:
        """The current breaker state, with no side effects."""
        with self._lock:
            e = self._load(key, rung)
            return e.state if e is not None else "closed"

    def entry(self, key: str, rung: str) -> Optional[BreakerEntry]:
        with self._lock:
            e = self._load(key, rung)
            return replace(e) if e is not None else None

    def decision(self, key: str, rung: str) -> str:
        """What the caller should do with this rung right now:

        * ``"closed"`` — attempt normally.
        * ``"open"``   — skip instantly, cool-down not yet elapsed.
        * ``"probe"``  — cool-down elapsed; the breaker has moved to
          ``half_open`` and this caller owns the single probe.  Follow
          up with :meth:`record_success` or :meth:`record_failure`.
        """
        with self._lock:
            e = self._load(key, rung)
            if e is None or e.state == "closed":
                return "closed"
            now = float(self.clock())
            if e.state == "open":
                if now < e.open_until:
                    self.stats.skipped_open += 1
                    return "open"
                e.state = "half_open"
                e.updated_at = now
                self.stats.probes += 1
                self._store(e)
                return "probe"
            # half_open: a probe is already in flight.  If its owner
            # crashed, admit another once a full cool-down has passed.
            if now >= e.updated_at + max(e.cooldown_s, 0.0):
                e.updated_at = now
                self.stats.probes += 1
                self._store(e)
                return "probe"
            self.stats.skipped_open += 1
            return "open"

    def record_failure(self, key: str, rung: str, error: Any = None, *,
                       policy: Optional[ResiliencePolicy] = None) -> str:
        """Count one failure; returns the resulting state.  A failed
        half-open probe re-opens at doubled cool-down; ``closed``
        failures accumulate and trip at ``breaker_threshold``."""
        policy = policy or DEFAULT_POLICY
        if policy.breaker_threshold <= 0:
            return "disabled"
        with self._lock:
            e = self._load(key, rung) or BreakerEntry(key=key, rung=rung)
            now = float(self.clock())
            e.failures += 1
            e.last_error = (f"{type(error).__name__}: {error}"
                            if isinstance(error, BaseException)
                            else (str(error) if error is not None else None))
            e.updated_at = now
            if e.state == "half_open":
                # the probe failed: back to open, cool-down doubled
                e.trips += 1
                e.cooldown_s = min(max(e.cooldown_s, policy.breaker_cooldown_s) * 2,
                                   policy.breaker_cooldown_max_s)
                e.state = "open"
                e.open_until = now + e.cooldown_s
                self.stats.trips += 1
            elif e.state == "closed" and e.failures >= policy.breaker_threshold:
                e.trips += 1
                e.cooldown_s = min(
                    policy.breaker_cooldown_s * (2 ** (e.trips - 1)),
                    policy.breaker_cooldown_max_s)
                e.state = "open"
                e.open_until = now + e.cooldown_s
                self.stats.trips += 1
            self._store(e)
            return e.state

    def record_success(self, key: str, rung: str) -> None:
        """The rung worked: close the breaker and drop its entry (the
        ledger returns to its pristine, zero-I/O shape).  A success on a
        pair the ledger has never seen is a no-op — no entry is created,
        so the happy path stays write-free."""
        with self._lock:
            if (key, rung) not in self._entries:
                return  # never seen unhealthy -> nothing to reset
            if self._entries[(key, rung)].state != "closed" \
                    or self._entries[(key, rung)].failures:
                self.stats.resets += 1
            self._remove(key, rung)

    def reopen(self, key: str, rung: str, cooldown_s: float,
               error: Any = None) -> None:
        """Force the breaker open for ``cooldown_s`` from *this*
        ledger's clock — used when a fresh process adopts persisted
        breaker state whose ``open_until`` was written by a different
        clock (the engine's tick clock restarts at 0 every process)."""
        with self._lock:
            e = self._load(key, rung) or BreakerEntry(key=key, rung=rung)
            now = float(self.clock())
            e.state = "open"
            e.trips = max(e.trips, 1)
            e.cooldown_s = float(cooldown_s)
            e.open_until = now + float(cooldown_s)
            e.updated_at = now
            if error is not None:
                e.last_error = str(error)
            self._store(e)

    def entries(self) -> List[BreakerEntry]:
        """Every known entry (memory + disk) — the triage view."""
        with self._lock:
            if self._have_dir():
                from repro_torch.pipeline.cache import open_envelope
                for p in sorted(self.root.glob("*.json")):
                    try:
                        ent = BreakerEntry.from_json(open_envelope(
                            p.read_bytes(), "entry", _LEDGER_SCHEMA))
                    except Exception:
                        continue
                    self._entries.setdefault((ent.key, ent.rung), ent)
            return [replace(e) for e in self._entries.values()]
