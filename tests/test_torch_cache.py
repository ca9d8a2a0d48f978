"""The port's kernel cache (``repro_torch.pipeline.cache``), a copy of the
reference's: plan envelopes and graph pickles checksummed and quarantined
when corrupt, atomic writes, the crash-recovery sweep, size-capped LRU
eviction, the ``CODEGEN_VERSION`` salt, disk hits across a process
boundary (a real one too: no fusion, no selection), and the serving
engine's warm start from disk on CPU tensors.  Mirrors the reference's
``tests/test_cache_eviction.py``, the cache tests of
``tests/test_pipeline.py`` and ``tests/test_resilience.py``'s cache
integrity tests; every cache lives in ``tmp_path``."""

import json
import os
import pickle
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.pipeline import cache as JC
from repro_torch import pipeline as TP
from repro_torch.core import array_program as TAP
from repro_torch.pipeline import cache as C
from test_torch_cuda import PROGRAMS, merged_inputs  # noqa: E402
import torch_port  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
LN_DIMS = {"M": 2, "K": 4, "N": 2}


def _ln():
    return TAP.layernorm_matmul_program(32.0)


def _plan(i=0):
    return C.CachePlan(0, {"M": i + 1}, 1.0, (1.0,), 2.0)


def _key(i=0):
    return C.CacheKey.make(f"fp{i}", "torch", {"M": i + 1}, None, True)


def _seed(kc, graph=True):
    key = C.CacheKey.make("fp-test", "torch", {"M": 2}, None, True)
    plan = C.CachePlan(0, {"M": 2}, 1.0, (1.0, 2.0), 2.0)
    kc.put_plan(key, plan, _ln() if graph else None)
    return key, plan


# ---------------------------------------------------------------------------
# Plans and keys
# ---------------------------------------------------------------------------

def test_cache_plan_json_has_the_references_fields():
    full = dict(region_costs=(5.0, 5.0), measured_s=1.25e-3,
                kernel_ids=("g0", "g1"), launches=2, resident_edges=1,
                stabilized=True)
    port = C.CachePlan(1, {"M": 2}, 10.0, (10.0, 20.0), 20.0, **full)
    ref = JC.CachePlan(1, {"M": 2}, 10.0, (10.0, 20.0), 20.0, **full)
    assert port.to_json() == ref.to_json()
    assert C.CachePlan.from_json(ref.to_json()) == port
    assert C.CachePlan.from_json(port.to_json()) == port
    d = port.to_json()
    del d["measured_s"], d["kernel_ids"], d["stabilized"]
    old = C.CachePlan.from_json(d)
    assert old.measured_s is None and old.kernel_ids is None
    assert old.stabilized is False


def test_keys_are_salted_by_the_ports_own_version(monkeypatch):
    key = _key()
    a = key.digest()
    monkeypatch.setattr(C, "CODEGEN_VERSION", C.CODEGEN_VERSION + 1)
    assert key.digest() != a
    assert TP.CODEGEN_VERSION >= 1


def test_default_root_is_the_environment_or_the_build_dir(monkeypatch,
                                                          tmp_path):
    from repro_torch.core import calibrate as CAL
    monkeypatch.setenv("REPRO_TORCH_KERNEL_CACHE", str(tmp_path))
    TP.reset_default_cache()
    try:
        assert TP.default_cache().root == tmp_path
        assert TP.default_cache() is TP.default_cache()
    finally:
        TP.reset_default_cache()
    monkeypatch.delenv("REPRO_TORCH_KERNEL_CACHE")
    assert CAL.default_cache_root() == ROOT / "build" / "repro_torch" / \
        "cache"


# ---------------------------------------------------------------------------
# The driver over the cache (tests/test_pipeline.py)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["py", "torch", "cuda"])
@pytest.mark.parametrize("name", ["flash", "layernorm_matmul",
                                  "rmsnorm_swiglu"])
def test_second_compile_is_memory_hit_then_disk_hit(name, backend,
                                                    tmp_path):
    build, dims, blocks = PROGRAMS[name]
    opts = TP.CompileOptions(backend=backend,
                             blocks=blocks if backend == "cuda" else None)
    c1 = TP.KernelCache(tmp_path)
    k1 = TP.compile(build(TAP), dims, options=opts, cache=c1)
    k2 = TP.compile(build(TAP), dims, options=opts, cache=c1)
    assert (k1.cache_hit, k2.cache_hit) == (None, "memory")
    assert k2._fn is k1._fn
    c2 = TP.KernelCache(tmp_path)
    k3 = TP.compile(build(TAP), dims, options=opts, cache=c2)
    assert k3.cache_hit == "disk" and c2.stats.disk_hits == 1
    assert (k3.snapshot_index, k3.dims, k3.cost) == (
        k1.snapshot_index, k1.dims, k1.cost)
    assert k3.kernel_ids == k1.kernel_ids
    assert k3.region_costs == k1.region_costs
    feed = {n: torch.from_numpy(v)
            for n, v in merged_inputs(k1.graph, dims, blocks).items()}
    for n, v in k1(feed).items():
        np.testing.assert_allclose(np.asarray(k3(feed)[n]), np.asarray(v),
                                   rtol=0, atol=0)


def test_disk_hit_survives_a_process_boundary(tmp_path):
    """A second Python process over the same directory loads the plan
    and the selected snapshot from disk: no fusion, no selection."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "from repro_torch import pipeline as TP\n"
        "from repro_torch.core import array_program as AP\n"
        "k = TP.compile(AP.gqa_attention_program(0.25, causal=True),\n"
        "               {'H': 2, 'M': 2, 'D': 2, 'N': 2, 'L': 2},\n"
        "               options=TP.CompileOptions(backend='cuda', blocks=\n"
        "               {'H': 1, 'M': 4, 'D': 8, 'N': 4, 'L': 8}))\n"
        "print(json.dumps([k.cache_hit, k.snapshot_index, TP.STATS]))\n")
    env = dict(os.environ, REPRO_TORCH_KERNEL_CACHE=str(tmp_path))
    runs = [json.loads(subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, check=True, timeout=300).stdout.splitlines()[-1])
        for _ in range(2)]
    (hit1, snap1, st1), (hit2, snap2, st2) = runs
    assert (hit1, hit2) == (None, "disk") and snap1 == snap2
    assert (st1["fusions"], st1["selections"]) == (1, 1)
    assert (st2["fusions"], st2["selections"]) == (0, 0)
    assert st1["kernels"] == st2["kernels"] >= 1
    assert not list(tmp_path.rglob("*.tmp"))


def test_codegen_version_salts_disk_cache(tmp_path, monkeypatch):
    c1 = TP.KernelCache(tmp_path)
    assert TP.compile(_ln(), LN_DIMS, cache=c1).cache_hit is None
    assert TP.compile(_ln(), LN_DIMS,
                      cache=TP.KernelCache(tmp_path)).cache_hit == "disk"
    monkeypatch.setattr(C, "CODEGEN_VERSION", C.CODEGEN_VERSION + 1)
    assert TP.compile(_ln(), LN_DIMS,
                      cache=TP.KernelCache(tmp_path)).cache_hit is None


def test_cache_key_covers_kernel_affecting_options(tmp_path):
    cache = TP.KernelCache(tmp_path)
    k1 = TP.compile(_ln(), LN_DIMS, cache=cache)
    for extra in ({"jit": "per-op"}, {"fused": False},
                  {"item_bytes": {"block": 1, "vector": 1, "scalar": 1}}):
        k = TP.compile(_ln(), LN_DIMS, cache=cache, **extra)
        assert k.key != k1.key and k.cache_hit is None, extra
    build, dims, blocks = PROGRAMS["layernorm_matmul"]
    kc = TP.compile(build(TAP), dims, backend="cuda", blocks=blocks,
                    cache=cache)
    ku = TP.compile(build(TAP), dims, backend="cuda", blocks=blocks,
                    group=False, cache=cache)
    assert ("vmem_budget", kc.key.opts[-1][1]) in kc.key.opts
    assert ("group", False) in ku.key.opts and ku.key != kc.key


def test_plan_that_cannot_lower_is_not_cached(tmp_path):
    build, dims, _ = PROGRAMS["layernorm_matmul"]
    cache = TP.KernelCache(tmp_path)
    with pytest.raises(ValueError, match="stack dim|needs per-dim|missing"):
        TP.compile(build(TAP), dims, backend="cuda", blocks={"M": 4},
                   cache=cache)
    assert cache.stats.misses == 0 and not cache.disk_entries()


# ---------------------------------------------------------------------------
# Integrity (tests/test_resilience.py's cache tests)
# ---------------------------------------------------------------------------

def test_plan_roundtrip_and_checksum_envelope(tmp_path):
    kc = TP.KernelCache(tmp_path)
    key, plan = _seed(kc)
    got, graph = kc.get_plan(key)
    assert got == plan and graph.fingerprint() == _ln().fingerprint()
    env = json.loads((tmp_path / f"{key.digest()}.json").read_text())
    assert env["schema"] == C._SCHEMA_VERSION and len(env["sha256"]) == 64
    assert not list(tmp_path.glob("*.tmp"))


def test_missing_entry_is_a_plain_miss_no_counters(tmp_path):
    kc = TP.KernelCache(tmp_path)
    assert kc.get_plan(_key(7)) == (None, None)
    st = kc.stats
    assert (st.corrupt_plans, st.corrupt_graphs, st.quarantined,
            st.io_errors, st.disk_hits) == (0, 0, 0, 0, 0)


@pytest.mark.parametrize("mutate,reason", [
    (lambda b: b[: len(b) // 2], "truncated"),
    (lambda b: b"\xffgarbage" + b[8:], "garbled bytes"),
    (lambda b: b.replace(b'"snapshot_index": 0',
                         b'"snapshot_index": 9'), "checksum mismatch"),
    (lambda b: json.dumps({"schema": 3, "sha256": "0" * 64,
                           "plan": {}}).encode(), "stale schema"),
])
def test_corrupt_plan_quarantined_counted_warned(tmp_path, mutate, reason):
    kc = TP.KernelCache(tmp_path)
    key, _ = _seed(kc)
    pj = tmp_path / f"{key.digest()}.json"
    pj.write_bytes(mutate(pj.read_bytes()))
    with pytest.warns(RuntimeWarning, match=re.escape(str(pj))):
        assert kc.get_plan(key) == (None, None), reason
    assert kc.stats.corrupt_plans == 1 and kc.stats.quarantined == 2
    assert sorted(p.name for p in (tmp_path / "quarantine").iterdir()) == \
        sorted([pj.name, f"{key.digest()}.graph.pkl"])
    assert kc.get_plan(key) == (None, None)
    assert kc.stats.corrupt_plans == 1


def test_corrupt_entry_recompiles_through_the_driver(tmp_path):
    """A compile over a corrupt plan quarantines it, counts it, and
    compiles afresh: a miss, not a crash and not a stale plan."""
    TP.compile(_ln(), LN_DIMS, cache=TP.KernelCache(tmp_path))
    for pj in tmp_path.glob("*.json"):
        pj.write_bytes(pj.read_bytes()[:20])
    c2 = TP.KernelCache(tmp_path)
    with pytest.warns(RuntimeWarning, match="corrupt plan"):
        k = TP.compile(_ln(), LN_DIMS, cache=c2)
    assert k.cache_hit is None
    assert (c2.stats.corrupt_plans, c2.stats.quarantined,
            c2.stats.misses) == (1, 2, 1)


def test_corrupt_graph_degrades_to_plan_only(tmp_path):
    kc = TP.KernelCache(tmp_path)
    key, plan = _seed(kc)
    pg = tmp_path / f"{key.digest()}.graph.pkl"
    pg.write_bytes(pg.read_bytes()[:-10])
    with pytest.warns(RuntimeWarning, match="corrupt graph"):
        got, graph = kc.get_plan(key)
    assert got == plan and graph is None
    assert (kc.stats.corrupt_graphs, kc.stats.quarantined,
            kc.stats.disk_hits) == (1, 1, 1)


def test_plan_only_entry_refuses_and_selects_nothing(tmp_path):
    """A disk hit whose graph is gone re-fuses to address the snapshot
    the plan names, and runs no selection."""
    TP.compile(_ln(), LN_DIMS, cache=TP.KernelCache(tmp_path))
    for pg in tmp_path.glob("*.graph.pkl"):
        pg.unlink()
    before = dict(TP.STATS)
    k = TP.compile(_ln(), LN_DIMS, cache=TP.KernelCache(tmp_path))
    assert k.cache_hit == "disk"
    assert TP.STATS["fusions"] == before["fusions"] + 1
    assert TP.STATS["selections"] == before["selections"]


def test_graph_missing_magic_header_rejected(tmp_path):
    kc = TP.KernelCache(tmp_path)
    key, plan = _seed(kc)
    (tmp_path / f"{key.digest()}.graph.pkl").write_bytes(
        pickle.dumps({"not": "a graph"}))
    with pytest.warns(RuntimeWarning, match="integrity header"):
        got, graph = kc.get_plan(key)
    assert got == plan and graph is None
    assert kc.stats.corrupt_graphs == 1


def test_write_failure_counts_and_warns(tmp_path):
    blocker = tmp_path / "blocked"
    blocker.write_text("a regular file where the cache dir should be")
    kc = TP.KernelCache(root=blocker / "sub")
    with pytest.warns(RuntimeWarning, match="failed to write plan"):
        kc.put_plan(_key(), _plan(), _ln())
    assert kc.stats.write_errors == 1 and kc.stats.misses == 1


def test_unpicklable_graph_is_plan_only_with_counter(tmp_path):
    g = _ln()
    g._poison = lambda x: x
    kc = TP.KernelCache(tmp_path)
    with pytest.warns(RuntimeWarning, match="plan-only"):
        kc.put_plan(_key(), _plan(), g)
    assert kc.stats.write_errors == 1
    got, graph = kc.get_plan(_key())
    assert got is not None and graph is None


def test_cache_stats_snapshot_delta_cover_all_counters():
    st = C.CacheStats(memory_hits=3, disk_hits=1, misses=2,
                      corrupt_plans=4, quarantined=5)
    snap = st.snapshot()
    st.quarantined += 2
    st.io_errors += 1
    d = st.delta(snap)
    assert (d.quarantined, d.io_errors, d.corrupt_plans,
            d.memory_hits) == (2, 1, 0, 0)


def test_recovery_sweeps_orphaned_tmp_and_stale_lock(tmp_path):
    tmp_path.mkdir(exist_ok=True)
    dead = subprocess.run([sys.executable, "-c", "import os; "
                           "print(os.getpid())"], capture_output=True,
                          text=True, check=True).stdout.strip()
    orphan = tmp_path / f"abc.json.{dead}.tmp"
    orphan.write_text("half a plan")
    mine = tmp_path / f"abc.json.{os.getpid()}.tmp"
    mine.write_text("a live writer's")
    lock = tmp_path / ".lock"
    lock.write_text("")
    old = time.time() - 2 * C.STALE_LOCK_AGE_S
    os.utime(lock, (old, old))
    with pytest.warns(RuntimeWarning, match="orphaned tmp"):
        kc = TP.KernelCache(tmp_path)
    assert not orphan.exists() and mine.exists() and not lock.exists()
    assert (kc.stats.recovered_tmp, kc.stats.stale_locks) == (1, 1)


def test_quarantine_is_capped(tmp_path, monkeypatch):
    q = tmp_path / "quarantine"
    q.mkdir(parents=True)
    for i in range(4):
        (q / f"e{i}.json").write_bytes(b"x" * 100)
        t = time.time() - 100 * (4 - i)
        os.utime(q / f"e{i}.json", (t, t))
    monkeypatch.setenv("REPRO_TORCH_QUARANTINE_MAX_BYTES", "250")
    with pytest.warns(RuntimeWarning, match="evicted 2 oldest"):
        kc = TP.KernelCache(tmp_path)
    assert sorted(p.name for p in q.iterdir()) == ["e2.json", "e3.json"]
    assert kc.stats.quarantine_evicted == 2


# ---------------------------------------------------------------------------
# Eviction (tests/test_cache_eviction.py)
# ---------------------------------------------------------------------------

def _age(cache, key, seconds):
    for path in cache._paths(key):
        if path.exists():
            t = time.time() - seconds
            os.utime(path, (t, t))


def test_old_plans_evicted_fresh_survive(tmp_path):
    cache = TP.KernelCache(tmp_path, max_disk_bytes=1 << 40)
    for i in range(3):
        cache.put_plan(_key(i), _plan(i), _ln())
    per_entry = sum(s for _, _, s in cache.disk_entries()) / 3
    cache.max_disk_bytes = int(per_entry * 2.5)
    for i, age in enumerate((300, 200, 100)):
        _age(cache, _key(i), age)
    assert cache.evict() == 1
    assert cache.get_plan(_key(0)) == (None, None)
    assert cache.get_plan(_key(1))[0] is not None
    assert cache.get_plan(_key(2))[0] is not None


def test_eviction_is_lru_not_fifo(tmp_path):
    cache = TP.KernelCache(tmp_path, max_disk_bytes=1 << 40)
    for i in range(2):
        cache.put_plan(_key(i), _plan(i), _ln())
    per_entry = sum(s for _, _, s in cache.disk_entries()) / 2
    _age(cache, _key(0), 300)
    _age(cache, _key(1), 200)
    assert cache.get_plan(_key(0))[0] is not None   # a hit refreshes it
    cache.max_disk_bytes = int(per_entry * 1.5)
    assert cache.evict() == 1
    assert cache.get_plan(_key(0))[0] is not None
    assert cache.get_plan(_key(1)) == (None, None)


def test_writes_trigger_eviction_and_compile_recovers(tmp_path):
    att = TAP.attention_program(0.125)
    att_dims = {"M": 2, "D": 2, "N": 2, "L": 2}
    cache = TP.KernelCache(tmp_path, max_disk_bytes=1 << 40)
    TP.compile(_ln(), LN_DIMS, cache=cache)
    per_entry = sum(s for _, _, s in cache.disk_entries())
    cache.max_disk_bytes = int(per_entry * 1.5)
    for p in tmp_path.glob("*"):
        t = time.time() - 300
        os.utime(p, (t, t))
    TP.compile(att, att_dims, cache=cache)
    assert len(cache.disk_entries()) == 1
    c2 = TP.KernelCache(tmp_path, max_disk_bytes=1 << 40)
    assert TP.compile(att, att_dims, cache=c2).cache_hit == "disk"
    assert TP.compile(_ln(), LN_DIMS, cache=c2).cache_hit is None


def test_zero_cap_disables_eviction(tmp_path):
    cache = TP.KernelCache(tmp_path, max_disk_bytes=0)
    for i in range(3):
        cache.put_plan(_key(i), _plan(i), _ln())
    assert cache.evict() == 0 and len(cache.disk_entries()) == 3


def test_cap_from_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_KERNEL_CACHE_MAX_BYTES", "12345")
    assert TP.KernelCache(tmp_path).max_disk_bytes == 12345


# ---------------------------------------------------------------------------
# Serving: a warm start from disk on CPU tensors
# ---------------------------------------------------------------------------

def _fresh_process(monkeypatch, root):
    """What a new process over ``root`` starts from: no in-process
    kernels, a new default cache object."""
    from repro_torch.models import layers as L
    monkeypatch.setenv("REPRO_TORCH_KERNEL_CACHE", str(root))
    TP.reset_default_cache()
    L.attention_kernel.cache_clear()
    L.swiglu_kernel.cache_clear()


def test_engine_serves_warm_from_the_disk_cache(monkeypatch, tmp_path):
    """Reduced smollm-135m on the cuda backend's plain versions, served
    twice over one cache directory as two processes would: the first
    misses every program, the second loads every plan from disk with no
    fusion or selection, and both sample the same tokens."""
    from repro_torch.launch import serve as S
    cfg = S.ServeConfig(reduced=True, n_layers=2, device="cpu",
                        n_requests=4, gen_lens=(2, 5))
    reports = []
    try:
        for _ in range(2):
            _fresh_process(monkeypatch, tmp_path)
            before = dict(TP.STATS)
            rep = S.run(cfg)
            reports.append((rep, {k: TP.STATS[k] - before[k]
                                  for k in ("fusions", "selections")}))
    finally:
        _fresh_process(monkeypatch, tmp_path)
        TP.reset_default_cache()
    (cold, cold_st), (warm, warm_st) = reports
    assert cold.warmup_compiles == warm.warmup_compiles == 8
    assert (cold.cache_misses, cold.cache_disk_hits) == (8, 0)
    assert (warm.cache_misses, warm.cache_disk_hits) == (0, 8)
    assert warm.cache_hit_rate == 1.0 and warm.quarantined == 0
    assert cold_st == {"fusions": 8, "selections": 8}
    assert warm_st == {"fusions": 0, "selections": 0}
    assert warm.decode_recompiles == cold.decode_recompiles == 0
    assert warm.tokens == cold.tokens and warm.n_completed == 4
    assert not list(tmp_path.rglob("*.tmp"))
