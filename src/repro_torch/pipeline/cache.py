"""Two-level kernel cache for ``pipeline.compile``: a copy of
``repro.pipeline.cache`` (``src/repro/pipeline/cache.py``), kept in the
torch package so it never imports the JAX package.

* **in-process**: compiled-callable objects keyed by the full compile
  key; a hit returns the existing kernel with zero work.
* **on-disk**: the *compilation plan* (selected snapshot index, dims,
  costs) as JSON plus the selected snapshot graph itself pickled next to
  it.  A disk hit skips fusion, the autotune sweep and snapshot
  selection; only backend lowering reruns, and the nvcc libraries it
  needs are found by the hash of their source
  (``core/cuda_build.py:source_key``), so a plan never loads a stale
  ``.so``.  Programs holding un-picklable ``MiscNode.fn`` closures
  degrade to plan-only entries (fusion reruns, selection doesn't).

Keys combine the graph fingerprint with every input that affects the
emitted kernel: backend, dims, block shapes, whether fusion ran, the
options of ``CompileOptions.cache_opts`` and the port's own
``CODEGEN_VERSION`` salt.  The cache directory is
``calibrate.default_cache_root()``: ``$REPRO_TORCH_KERNEL_CACHE``, else
``build/repro_torch/cache`` in the repository (gitignored).

The on-disk level is a size-capped LRU: every hit touches the entry's
mtime, and after every write the oldest entries are evicted until the
directory fits ``max_disk_bytes`` (default 1 GiB, overridable via
``$REPRO_TORCH_KERNEL_CACHE_MAX_BYTES``; ``0``/negative disables
eviction).

Integrity: every on-disk artifact is checksummed (plan JSON rides in a
``{"schema", "sha256", "plan"}`` envelope, graph pickles carry a magic +
sha256 header) and verified on read.  A corrupt, truncated or
wrong-schema entry is **quarantined** (moved to ``<cache>/quarantine/``
for triage, never silently deleted), counted in :class:`CacheStats`
(``corrupt_plans`` / ``corrupt_graphs`` / ``quarantined``), and logged
with the offending path; the compile then proceeds as a miss.  Writes
are crash-safe (unique temp file + fsync + atomic rename) and
concurrent writers are serialized with a best-effort ``flock`` on
``<cache>/.lock`` where the platform provides one.

Resilience (``repro_torch.resilience``): ``KernelCache.health`` is the
compile ladder's :class:`~repro_torch.resilience.HealthLedger`, persisted
under ``<cache>/health/`` in the same checksummed envelopes
(:func:`envelope`), and ``get_plan`` is the ``cache:get_plan`` fault
site, whose ``corrupt`` kind garbles the real on-disk plan so that the
quarantine above detects it.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import time
import warnings
from dataclasses import asdict, dataclass, fields
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.graph import Graph

# v4: checksummed envelopes (plan JSON + graph pickle header) with
# quarantine on mismatch.  Old unversioned artifacts hash to different
# digests, so they are never read — just unreferenced bytes the LRU
# eviction eventually clears.
_SCHEMA_VERSION = 4

# magic prefixing every graph pickle: 8 bytes tag + 32 bytes sha256 of
# the payload that follows
_GRAPH_MAGIC = b"RPRGRPH1"

# Version salt for everything downstream of the graph fingerprint: fusion
# rules, the selection cost model and the port's code generators
# (``codegen_torch``, ``codegen_cuda``).  Bump it whenever any of them
# changes the plans it makes, so a stale on-disk plan from an older
# build is never loaded.  The port counts its own versions, from 1.
CODEGEN_VERSION = 1

DEFAULT_MAX_DISK_BYTES = 1 << 30  # 1 GiB

# crash-recovery sweep thresholds (KernelCache.recover): a *.tmp file
# whose embedded writer pid is dead — or older than this — is an orphan
# from a crashed writer; a .lock nobody holds and older than this is
# stale.  Quarantine is capped at a byte budget, oldest-first.
STALE_TMP_AGE_S = 3600.0
STALE_LOCK_AGE_S = 3600.0
DEFAULT_QUARANTINE_MAX_BYTES = 64 << 20  # 64 MiB


def _tmp_writer_pid(name: str) -> Optional[int]:
    """The writer pid embedded in an ``{entry}.{pid}.tmp`` name, else
    ``None`` (a tmp file this cache's writers did not produce)."""
    parts = name.rsplit(".", 2)
    if len(parts) == 3 and parts[2] == "tmp":
        try:
            return int(parts[1])
        except ValueError:
            return None
    return None


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except (OSError, OverflowError):
        return True  # EPERM etc.: some process owns it — assume alive
    return True


def _norm(d: Optional[Dict[str, Any]]) -> Tuple:
    return tuple(sorted(d.items())) if d else ()


@dataclass(frozen=True)
class CacheKey:
    fingerprint: str
    backend: str
    dims: Tuple = ()
    blocks: Tuple = ()
    fused: bool = True
    opts: Tuple = ()  # backend/selection options that change the kernel
                      # (resolved interpret flag, jit, item_bytes, ...)

    @classmethod
    def make(cls, fingerprint: str, backend: str,
             dims: Optional[Dict[str, int]],
             blocks: Optional[Dict[str, int]], fused: bool,
             opts: Tuple = ()) -> "CacheKey":
        return cls(fingerprint, backend, _norm(dims), _norm(blocks), fused,
                   opts)

    def digest(self) -> str:
        # CODEGEN_VERSION is read at call time so tests (and hot-reloads)
        # that bump the module global invalidate every existing entry
        raw = json.dumps([_SCHEMA_VERSION, CODEGEN_VERSION,
                          self.fingerprint, self.backend,
                          self.dims, self.blocks, self.fused, self.opts])
        return hashlib.sha256(raw.encode()).hexdigest()[:32]


@dataclass
class CachePlan:
    """What selection decided — everything needed to re-lower without
    re-running fusion or the block-shape sweep."""

    snapshot_index: int
    dims: Dict[str, int]
    cost: float
    costs: Tuple[float, ...]
    initial_cost: float
    # per-kernel traffic attribution of the selected snapshot (pallas
    # backend: one entry per emitted kernel — a region-group megakernel
    # counts once), None for other backends
    region_costs: Optional[Tuple[float, ...]] = None
    # wall seconds of the winning config when the plan came from a
    # measured autotune sweep (optional key; absent in older entries)
    measured_s: Optional[float] = None
    # stable ids of the emitted kernels, aligned with region_costs — the
    # timing harness pairs measured kernel times with costs by id
    kernel_ids: Optional[Tuple[str, ...]] = None
    # grouped-lowering provenance: kernels launched per call and
    # cross-region values kept VMEM-resident
    launches: Optional[int] = None
    resident_edges: Optional[int] = None
    # True when the snapshots were rewritten by ``numerics.stabilize``
    # before selection (snapshot_index addresses the stabilized list)
    stabilized: bool = False

    def to_json(self) -> Dict[str, Any]:
        d = asdict(self)
        d["costs"] = list(self.costs)
        d["region_costs"] = (list(self.region_costs)
                             if self.region_costs is not None else None)
        d["kernel_ids"] = (list(self.kernel_ids)
                           if self.kernel_ids is not None else None)
        return d

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "CachePlan":
        rc = d.get("region_costs")
        ms = d.get("measured_s")
        kids = d.get("kernel_ids")
        launches = d.get("launches")
        resident = d.get("resident_edges")
        return cls(int(d["snapshot_index"]), dict(d["dims"]),
                   float(d["cost"]), tuple(d["costs"]),
                   float(d["initial_cost"]),
                   tuple(rc) if rc is not None else None,
                   float(ms) if ms is not None else None,
                   tuple(str(k) for k in kids) if kids is not None
                   else None,
                   int(launches) if launches is not None else None,
                   int(resident) if resident is not None else None,
                   bool(d.get("stabilized", False)))


@dataclass
class CacheStats:
    memory_hits: int = 0
    disk_hits: int = 0
    misses: int = 0
    # -- integrity counters: every recovered-from error is named --------
    corrupt_plans: int = 0    # unreadable/bad-checksum/bad-schema plan JSON
    corrupt_graphs: int = 0   # unreadable/bad-checksum graph pickle
    quarantined: int = 0      # files moved to <cache>/quarantine/
    write_errors: int = 0     # failed plan/graph writes (entry skipped)
    evict_errors: int = 0     # failed unlinks during LRU eviction
    io_errors: int = 0        # failed stat/utime/scan (entry degraded)
    # -- startup crash-recovery sweep (KernelCache.recover) -------------
    recovered_tmp: int = 0         # orphaned *.pid.tmp from dead writers
    stale_locks: int = 0           # unheld, over-age .lock files removed
    quarantine_evicted: int = 0    # quarantine files over the byte budget

    @property
    def compiles(self) -> int:
        """Compile paths that did NOT hit the in-process kernel cache:
        fresh compilations (``misses``) plus disk-plan reloads
        (``disk_hits``).  Serving engines pin the steady-state growth of
        this counter to zero to prove no per-step recompiles."""
        return self.misses + self.disk_hits

    @property
    def hit_rate(self) -> float:
        hits = self.memory_hits + self.disk_hits
        total = hits + self.misses
        return hits / total if total else 1.0

    def snapshot(self) -> "CacheStats":
        return CacheStats(**{f.name: getattr(self, f.name)
                             for f in fields(self)})

    def delta(self, since: "CacheStats") -> "CacheStats":
        """Counter growth since a ``snapshot()``."""
        return CacheStats(**{
            f.name: getattr(self, f.name) - getattr(since, f.name)
            for f in fields(self)})


def envelope(field: str, body: Dict[str, Any],
             schema: int = _SCHEMA_VERSION) -> str:
    """A checksummed JSON envelope ``{"schema", "sha256", field}``: the
    sha256 is over ``body`` serialized with sorted keys."""
    payload = json.dumps(body, sort_keys=True)
    digest = hashlib.sha256(payload.encode()).hexdigest()
    return json.dumps({"schema": schema, "sha256": digest,
                       field: json.loads(payload)})


def open_envelope(blob: bytes, field: str,
                  schema: int = _SCHEMA_VERSION) -> Dict[str, Any]:
    """The body of an :func:`envelope`; raises ``CacheIntegrityError`` on
    unparseable JSON, a missing body, another schema or a checksum
    mismatch."""
    try:
        env = json.loads(blob.decode("utf-8"))
    except (ValueError, UnicodeDecodeError) as e:
        raise CacheIntegrityError(f"unparseable JSON ({e})") from None
    if not isinstance(env, dict) or field not in env:
        raise CacheIntegrityError(f"not a {field} envelope")
    if env.get("schema") != schema:
        raise CacheIntegrityError(f"schema {env.get('schema')!r} != {schema}")
    payload = json.dumps(env[field], sort_keys=True)
    digest = hashlib.sha256(payload.encode()).hexdigest()
    if digest != env.get("sha256"):
        raise CacheIntegrityError("checksum mismatch (corrupt/truncated)")
    return env[field]


def _graph_blob(graph: Graph) -> bytes:
    payload = pickle.dumps(graph)
    return _GRAPH_MAGIC + hashlib.sha256(payload).digest() + payload


class CacheIntegrityError(ValueError):
    """An on-disk entry failed its schema or checksum guard."""


def _read_plan(path: Path) -> CachePlan:
    """Parse + verify a plan envelope; raises on any integrity failure
    (missing file raises FileNotFoundError, a plain miss)."""
    body = open_envelope(path.read_bytes(), "plan")
    try:
        return CachePlan.from_json(body)
    except (KeyError, TypeError, ValueError) as e:
        raise CacheIntegrityError(f"malformed plan ({e})") from None


def _read_graph(path: Path) -> Graph:
    blob = path.read_bytes()
    head = len(_GRAPH_MAGIC) + 32
    if len(blob) < head or not blob.startswith(_GRAPH_MAGIC):
        raise CacheIntegrityError("graph pickle missing integrity header")
    digest, payload = blob[len(_GRAPH_MAGIC):head], blob[head:]
    if hashlib.sha256(payload).digest() != digest:
        raise CacheIntegrityError(
            "graph checksum mismatch (corrupt/truncated)")
    return pickle.loads(payload)


class KernelCache:
    def __init__(self, root: Optional[os.PathLike] = None,
                 disk: bool = True,
                 max_disk_bytes: Optional[int] = None):
        if root is None:
            # shared with core/calibrate.py: calibration profiles live
            # under <root>/calibration/, next to the plans they tune
            from repro_torch.core.calibrate import default_cache_root
            root = default_cache_root()
        if max_disk_bytes is None:
            max_disk_bytes = int(os.environ.get(
                "REPRO_TORCH_KERNEL_CACHE_MAX_BYTES", DEFAULT_MAX_DISK_BYTES))
        self.root = Path(root)
        self.disk = disk
        self.max_disk_bytes = max_disk_bytes
        self._kernels: Dict[CacheKey, Any] = {}
        self.stats = CacheStats()
        self._health = None
        self.recover()

    @property
    def health(self):
        """This cache's :class:`~repro_torch.resilience.HealthLedger`:
        breaker state of compile rungs, persisted under ``<root>/health/``
        (memory-only for ``disk=False`` caches).  Built lazily; it reads
        and writes nothing until a rung fails."""
        if self._health is None:
            from repro_torch import resilience as RZ
            self._health = RZ.HealthLedger(
                self.root / "health" if self.disk else None)
        return self._health

    # -- startup crash recovery --------------------------------------------
    def recover(self) -> None:
        """Crash-recovery sweep, run once per cache construction:

        * remove orphaned ``*.{pid}.tmp`` files, in the cache directory
          and in its ``health/`` ledger, left by writers that
          died between open and rename (dead pid, or over-age as the
          cross-host fallback where the pid namespace differs);
        * remove a stale ``.lock`` that no live process holds (flock
          acquirable) once it is over-age;
        * cap ``<root>/quarantine/`` at ``$REPRO_TORCH_QUARANTINE_MAX_BYTES``
          (oldest-first) so triage copies cannot grow without bound.

        Every action is counted (``recovered_tmp`` / ``stale_locks`` /
        ``quarantine_evicted``) and warned — never silent."""
        if not self.disk:
            return
        try:
            if not self.root.is_dir():
                return
        except OSError:
            return
        now = time.time()
        for d in (self.root, self.root / "health"):
            try:
                tmps = sorted(d.glob("*.tmp"))
            except OSError:
                continue
            for tmp in tmps:
                pid = _tmp_writer_pid(tmp.name)
                if pid is not None and pid != os.getpid() \
                        and not _pid_alive(pid):
                    orphan = True
                else:
                    # our own pid, a live writer, or an unparseable name:
                    # only reclaim once clearly abandoned by age
                    try:
                        orphan = now - tmp.stat().st_mtime > STALE_TMP_AGE_S
                    except OSError:
                        continue
                if not orphan:
                    continue
                try:
                    tmp.unlink()
                except OSError:
                    continue
                self.stats.recovered_tmp += 1
                warnings.warn(
                    f"kernel cache: recovered orphaned tmp file {tmp} "
                    f"(writer pid {pid} is gone)", RuntimeWarning,
                    stacklevel=2)
        self._sweep_stale_lock(now)
        self._cap_quarantine()

    def _sweep_stale_lock(self, now: float) -> None:
        lock = self.root / ".lock"
        try:
            age = now - lock.stat().st_mtime
        except OSError:
            return
        if age <= STALE_LOCK_AGE_S:
            return
        try:
            import fcntl
            fd = os.open(str(lock), os.O_RDWR)
        except (ImportError, OSError):
            return
        try:
            try:
                # acquirable => no live writer holds it => genuinely stale
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except OSError:
                return  # held by a live process: not stale
            try:
                lock.unlink()
            except OSError:
                return
            self.stats.stale_locks += 1
            warnings.warn(
                f"kernel cache: removed stale lock {lock} "
                f"(unheld, {age:.0f}s old)", RuntimeWarning, stacklevel=3)
        finally:
            os.close(fd)

    def _cap_quarantine(self) -> int:
        budget = int(os.environ.get("REPRO_TORCH_QUARANTINE_MAX_BYTES",
                                    DEFAULT_QUARANTINE_MAX_BYTES))
        if budget < 0:
            return 0  # negative budget disables the cap
        try:
            files = [(p, p.stat()) for p in self.quarantine_dir.iterdir()
                     if p.is_file()]
        except OSError:
            return 0
        total = sum(st.st_size for _, st in files)
        evicted = 0
        for p, st in sorted(files, key=lambda e: e[1].st_mtime):
            if total <= budget:
                break
            try:
                p.unlink()
            except OSError:
                continue
            total -= st.st_size
            evicted += 1
        if evicted:
            self.stats.quarantine_evicted += evicted
            warnings.warn(
                f"kernel cache: evicted {evicted} oldest quarantine "
                f"file(s) over the {budget}-byte budget", RuntimeWarning,
                stacklevel=3)
        return evicted

    # -- in-process level ---------------------------------------------------
    def get_kernel(self, key: CacheKey):
        k = self._kernels.get(key)
        if k is not None:
            self.stats.memory_hits += 1
        return k

    def put_kernel(self, key: CacheKey, kernel) -> None:
        self._kernels[key] = kernel

    # -- on-disk level ------------------------------------------------------
    def _paths(self, key: CacheKey) -> Tuple[Path, Path]:
        d = key.digest()
        return self.root / f"{d}.json", self.root / f"{d}.graph.pkl"

    @property
    def quarantine_dir(self) -> Path:
        return self.root / "quarantine"

    def quarantine(self, path: Path, reason: str) -> None:
        """Move a corrupt artifact aside for triage (never silently
        delete it) and count it; falls back to unlink if the move
        itself fails."""
        qdir = self.quarantine_dir
        try:
            qdir.mkdir(parents=True, exist_ok=True)
            path.replace(qdir / path.name)
        except OSError:
            try:
                path.unlink()
            except OSError as e:
                self.stats.io_errors += 1
                warnings.warn(
                    f"kernel cache: could not quarantine OR remove "
                    f"corrupt entry {path} ({e}); it will be re-read",
                    RuntimeWarning, stacklevel=3)
                return
        self.stats.quarantined += 1
        warnings.warn(
            f"kernel cache: quarantined corrupt entry {path} -> "
            f"{qdir / path.name} ({reason})", RuntimeWarning, stacklevel=3)
        self._cap_quarantine()  # keep triage copies under the byte budget

    def get_plan(self, key: CacheKey
                 ) -> Tuple[Optional[CachePlan], Optional[Graph]]:
        """Returns (plan, selected_graph); graph may be None (plan-only).
        A corrupt/truncated/stale-schema entry is quarantined, counted,
        and treated as a miss — never silently swallowed."""
        if not self.disk:
            return None, None
        pj, pg = self._paths(key)
        # fault injection: garble the real on-disk entry, so that the
        # integrity checks below detect it
        from repro_torch import resilience as RZ
        spec = RZ.fire("cache:get_plan")
        if spec is not None and spec.kind == "corrupt" and pj.exists():
            blob = pj.read_bytes()
            pj.write_bytes(blob[:max(len(blob) // 2, 1)] + b"\xff{corrupt")
        try:
            plan = _read_plan(pj)
        except FileNotFoundError:
            return None, None
        except CacheIntegrityError as e:
            self.stats.corrupt_plans += 1
            warnings.warn(f"kernel cache: corrupt plan {pj}: {e}",
                          RuntimeWarning, stacklevel=2)
            self.quarantine(pj, str(e))
            if pg.exists():  # its paired graph describes a dead plan
                self.quarantine(pg, "paired with corrupt plan")
            return None, None
        except OSError as e:
            self.stats.io_errors += 1
            warnings.warn(f"kernel cache: unreadable plan {pj}: {e}",
                          RuntimeWarning, stacklevel=2)
            return None, None
        graph: Optional[Graph] = None
        try:
            graph = _read_graph(pg)
        except FileNotFoundError:
            graph = None  # plan-only entry: expected, not an error
        except (CacheIntegrityError, pickle.PickleError, AttributeError,
                ImportError, EOFError, IndexError) as e:
            self.stats.corrupt_graphs += 1
            warnings.warn(f"kernel cache: corrupt graph {pg}: {e} "
                          "(degrading to plan-only entry)",
                          RuntimeWarning, stacklevel=2)
            self.quarantine(pg, str(e))
        except OSError as e:
            self.stats.io_errors += 1
            warnings.warn(f"kernel cache: unreadable graph {pg}: {e}",
                          RuntimeWarning, stacklevel=2)
        for path in (pj, pg):  # LRU touch: a hit is recent use
            try:
                os.utime(path)
            except OSError:
                self.stats.io_errors += 1  # missing graph lands here; fine
        self.stats.disk_hits += 1
        return plan, graph

    def _lock(self):
        """Best-effort inter-process write lock (<root>/.lock).  Returns
        a context manager; a no-op where flock is unavailable."""
        root = self.root

        class _Lock:
            def __enter__(self):
                self.fd = None
                try:
                    import fcntl
                    root.mkdir(parents=True, exist_ok=True)
                    self.fd = os.open(str(root / ".lock"),
                                      os.O_CREAT | os.O_RDWR)
                    fcntl.flock(self.fd, fcntl.LOCK_EX)
                except (ImportError, OSError):
                    if self.fd is not None:
                        os.close(self.fd)
                        self.fd = None
                return self

            def __exit__(self, *exc):
                if self.fd is not None:
                    try:
                        import fcntl
                        fcntl.flock(self.fd, fcntl.LOCK_UN)
                    except (ImportError, OSError):
                        pass
                    os.close(self.fd)
                return False

        return _Lock()

    @staticmethod
    def _atomic_write(path: Path, data: bytes) -> None:
        """Crash-safe write: unique temp file (no cross-process tmp-name
        collisions) + fsync + atomic rename."""
        tmp = path.parent / f"{path.name}.{os.getpid()}.tmp"
        fd = os.open(str(tmp), os.O_CREAT | os.O_WRONLY | os.O_TRUNC)
        try:
            os.write(fd, data)
            os.fsync(fd)
        finally:
            os.close(fd)
        tmp.replace(path)

    def put_plan(self, key: CacheKey, plan: CachePlan,
                 graph: Optional[Graph]) -> None:
        # a fresh plan is a compile-path miss whether or not it persists
        # (disk=False caches still feed the serving recompile counters)
        self.stats.misses += 1
        if not self.disk:
            return
        pj, pg = self._paths(key)
        with self._lock():
            try:
                self.root.mkdir(parents=True, exist_ok=True)
                self._atomic_write(
                    pj, envelope("plan", plan.to_json()).encode())
            except OSError as e:
                self.stats.write_errors += 1
                warnings.warn(f"kernel cache: failed to write plan {pj}: "
                              f"{e} (entry not cached)",
                              RuntimeWarning, stacklevel=2)
                return
            if graph is not None:
                try:
                    self._atomic_write(pg, _graph_blob(graph))
                except (OSError, pickle.PickleError, TypeError,
                        AttributeError) as e:
                    # plan-only entry: fusion reruns on a disk hit.
                    # Un-picklable MiscNode closures land here routinely,
                    # so count + warn but keep the plan
                    self.stats.write_errors += 1
                    warnings.warn(
                        f"kernel cache: failed to write graph {pg}: {e} "
                        "(plan-only entry; fusion reruns on hit)",
                        RuntimeWarning, stacklevel=2)
            self.evict()

    # -- eviction -----------------------------------------------------------
    def disk_entries(self) -> List[Tuple[str, float, int]]:
        """(digest, last-use mtime, total bytes) per on-disk entry."""
        out = []
        try:
            plans = sorted(self.root.glob("*.json"))
        except OSError as e:
            self.stats.io_errors += 1
            warnings.warn(f"kernel cache: cannot scan {self.root}: {e}",
                          RuntimeWarning, stacklevel=2)
            return []
        for pj in plans:
            digest = pj.name[:-len(".json")]
            mtime, size = 0.0, 0
            for path in (pj, self.root / f"{digest}.graph.pkl"):
                try:
                    st = path.stat()
                except OSError:
                    continue  # unpaired graph / racing eviction: normal
                mtime = max(mtime, st.st_mtime)
                size += st.st_size
            out.append((digest, mtime, size))
        return out

    def evict(self) -> int:
        """Delete least-recently-used on-disk entries until the cache
        fits ``max_disk_bytes``.  Returns the number of entries evicted;
        a non-positive cap disables eviction."""
        if not self.disk or self.max_disk_bytes <= 0:
            return 0
        entries = self.disk_entries()
        total = sum(size for _, _, size in entries)
        evicted = 0
        for digest, _, size in sorted(entries, key=lambda e: e[1]):
            if total <= self.max_disk_bytes:
                break
            for path in (self.root / f"{digest}.json",
                         self.root / f"{digest}.graph.pkl"):
                try:
                    path.unlink()
                except FileNotFoundError:
                    pass  # plan-only entry / concurrent eviction
                except OSError as e:
                    self.stats.evict_errors += 1
                    warnings.warn(
                        f"kernel cache: failed to evict {path}: {e}",
                        RuntimeWarning, stacklevel=2)
            total -= size
            evicted += 1
        return evicted

    def clear_memory(self) -> None:
        self._kernels.clear()


_DEFAULT: Optional[KernelCache] = None


def default_cache() -> KernelCache:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = KernelCache()
    return _DEFAULT


def reset_default_cache() -> None:
    """Drop the process-wide cache object (tests)."""
    global _DEFAULT
    _DEFAULT = None
