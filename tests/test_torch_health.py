"""Self-healing rungs in the port, test for test the reference's
``tests/test_health.py``: the ``HealthLedger`` circuit breaker (state
machine, checksummed persistence in the cache's envelopes, zero I/O on
the happy path), ladder integration (skip known-open rungs, probe after
the cool-down), serving-engine re-promotion (demote -> clean ticks ->
half-open probe -> swap back), the cache's crash-recovery sweep of the
ledger's directory, and the sweep and contention tests that
``tests/test_torch_cache.py`` does not already hold."""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from repro_torch import pipeline
from repro_torch import resilience as RZ
from repro_torch.core import array_program as TAP
from repro_torch.pipeline import cache as C
from test_torch_cuda import PROGRAMS  # noqa: E402
from test_torch_resilience import (_no_env_plan, engine,  # noqa: E402, F401
                                   fresh_cache, oracle, tiny_cfg)
import torch_port  # noqa: F401

SRC = Path(pipeline.__file__).resolve().parents[2]


# ---------------------------------------------------------------------------
# the breaker state machine (memory-only, injectable clock)
# ---------------------------------------------------------------------------

def test_breaker_closed_open_halfopen_cycle():
    clk = [0.0]
    led = RZ.HealthLedger(None, clock=lambda: clk[0])
    pol = RZ.ResiliencePolicy(breaker_threshold=2, breaker_cooldown_s=10.0)
    key = "fp-abc"
    assert led.decision(key, "grouped") == "closed"
    assert led.record_failure(key, "grouped", "boom", policy=pol) == "closed"
    assert led.record_failure(key, "grouped", "boom", policy=pol) == "open"
    assert led.decision(key, "grouped") == "open"
    assert led.stats.trips == 1 and led.stats.skipped_open == 1
    # cool-down elapses -> exactly one half-open probe is admitted
    clk[0] = 10.0
    assert led.decision(key, "grouped") == "probe"
    assert led.state(key, "grouped") == "half_open"
    # a failed probe re-opens at DOUBLED cool-down
    assert led.record_failure(key, "grouped", "still bad",
                              policy=pol) == "open"
    e = led.entry(key, "grouped")
    assert e.cooldown_s == 20.0 and e.open_until == 30.0
    assert led.decision(key, "grouped") == "open"
    clk[0] = 30.0
    assert led.decision(key, "grouped") == "probe"
    # a passing probe closes the breaker and drops the entry entirely
    led.record_success(key, "grouped")
    assert led.decision(key, "grouped") == "closed"
    assert led.entry(key, "grouped") is None
    assert led.stats.resets == 1


def test_breaker_cooldown_caps_and_threshold_zero_disables():
    clk = [0.0]
    led = RZ.HealthLedger(None, clock=lambda: clk[0])
    pol = RZ.ResiliencePolicy(breaker_threshold=1, breaker_cooldown_s=10.0,
                              breaker_cooldown_max_s=25.0)
    led.record_failure("k", "torch", "x", policy=pol)
    for expect in (20.0, 25.0, 25.0):  # doubles, then pins at the cap
        clk[0] = led.entry("k", "torch").open_until
        assert led.decision("k", "torch") == "probe"
        led.record_failure("k", "torch", "x", policy=pol)
        assert led.entry("k", "torch").cooldown_s == expect
    # threshold 0 disables the breaker: failures never open it
    off = RZ.HealthLedger(None)
    zero = RZ.ResiliencePolicy(breaker_threshold=0)
    for _ in range(5):
        assert off.record_failure("k", "torch", "x",
                                  policy=zero) == "disabled"
    assert off.decision("k", "torch") == "closed"
    with pytest.raises(ValueError, match="breaker_threshold"):
        RZ.ResiliencePolicy(breaker_threshold=-1)


def test_halfopen_probe_owner_crash_admits_another_after_cooldown():
    clk = [0.0]
    led = RZ.HealthLedger(None, clock=lambda: clk[0])
    pol = RZ.ResiliencePolicy(breaker_threshold=1, breaker_cooldown_s=10.0)
    led.record_failure("k", "grouped", "x", policy=pol)
    clk[0] = 10.0
    assert led.decision("k", "grouped") == "probe"
    # the probe's owner never reported back; concurrent callers wait...
    assert led.decision("k", "grouped") == "open"
    # ...until a full cool-down has passed, then another probe is allowed
    clk[0] = 20.0
    assert led.decision("k", "grouped") == "probe"


def test_zero_threshold_compile_touches_no_ledger(tmp_path):
    """``breaker_threshold=0``: the compile ladder takes no ledger at
    all, so a failing rung leaves nothing under ``<cache>/health/``."""
    cache = C.KernelCache(root=tmp_path)
    build, dims, blocks = PROGRAMS["layernorm_matmul"]
    plan = RZ.FaultPlan([RZ.FaultSpec(site="compile:grouped")])
    opts = pipeline.CompileOptions(
        backend="cuda", blocks=blocks,
        resilience=RZ.ResiliencePolicy(breaker_threshold=0))
    with RZ.faults(plan), pytest.warns(RuntimeWarning,
                                       match="compile ladder"):
        kern = pipeline.compile(build(TAP), dims, options=opts, cache=cache)
    assert kern.rung == "ungrouped"
    assert not (tmp_path / "health").exists()
    assert cache.health.stats.writes == 0


# ---------------------------------------------------------------------------
# persistence: checksummed envelopes, fresh-process round-trip, corruption
# ---------------------------------------------------------------------------

def test_ledger_roundtrips_across_a_fresh_process(tmp_path):
    """Breaker state written by a REAL separate process is read back
    here: rung health survives restarts and is shared cross-process."""
    hroot = tmp_path / "health"
    script = (
        "import sys\n"
        "sys.path.insert(0, sys.argv[2])\n"
        "from repro_torch import resilience as RZ\n"
        "led = RZ.HealthLedger(sys.argv[1], clock=lambda: 100.0)\n"
        "pol = RZ.ResiliencePolicy(breaker_threshold=2,\n"
        "                          breaker_cooldown_s=50.0)\n"
        "led.record_failure('fp-x', 'grouped', 'boom', policy=pol)\n"
        "led.record_failure('fp-x', 'grouped', 'boom', policy=pol)\n"
        "assert 'jax' not in sys.modules and 'repro' not in sys.modules\n"
    )
    subprocess.run([sys.executable, "-c", script, str(hroot), str(SRC)],
                   check=True, timeout=120)
    envs = list(hroot.glob("*.json"))
    assert len(envs) == 1
    env = json.loads(envs[0].read_text())
    assert set(env) == {"schema", "sha256", "entry"}
    assert len(env["sha256"]) == 64
    # the cache's own envelope reader accepts it
    assert C.open_envelope(envs[0].read_bytes(), "entry",
                           RZ._LEDGER_SCHEMA)["state"] == "open"
    assert not list(hroot.glob("*.tmp"))  # atomic write left no temp files

    clk = [120.0]
    led = RZ.HealthLedger(hroot, clock=lambda: clk[0])
    assert led.state("fp-x", "grouped") == "open"
    assert led.stats.reads == 1
    e = led.entry("fp-x", "grouped")
    assert (e.failures, e.trips, e.open_until) == (2, 1, 150.0)
    assert "boom" in e.last_error
    assert led.decision("fp-x", "grouped") == "open"
    clk[0] = 150.0
    assert led.decision("fp-x", "grouped") == "probe"
    # recovery unlinks the envelope: the dir is pristine again
    led.record_success("fp-x", "grouped")
    assert list(hroot.glob("*.json")) == []


@pytest.mark.parametrize("mutate", [
    lambda t: t[:40] + "garbage",
    lambda t: t.replace('"failures": 1', '"failures": 7'),
    lambda t: t.replace('"schema": 1', '"schema": 9')],
    ids=["truncated", "checksum", "schema"])
def test_corrupt_envelope_fails_open_and_is_discarded(tmp_path, mutate):
    hroot = tmp_path / "health"
    led = RZ.HealthLedger(hroot)
    pol = RZ.ResiliencePolicy(breaker_threshold=1)
    led.record_failure("fp", "grouped", "x", policy=pol)
    path = next(hroot.glob("*.json"))
    text = path.read_text()
    assert mutate(text) != text
    path.write_text(mutate(text))
    fresh = RZ.HealthLedger(hroot)
    with pytest.warns(RuntimeWarning, match="corrupt entry"):
        # a broken ledger must never take a healthy rung out of service
        assert fresh.decision("fp", "grouped") == "closed"
    assert fresh.stats.corrupt == 1
    assert not path.exists()  # discarded, not re-read forever


def test_happy_path_is_zero_ledger_io(tmp_path):
    """A clean compile reads and writes no ledger entry, starts no
    timeout thread, and never creates ``<cache>/health/``."""
    cache = C.KernelCache(root=tmp_path)
    build, dims, blocks = PROGRAMS["layernorm_matmul"]
    threads = threading.active_count()
    for opts in (pipeline.CompileOptions(backend="torch"),
                 pipeline.CompileOptions(backend="cuda", blocks=blocks)):
        kern = pipeline.compile(build(TAP), dims, options=opts, cache=cache)
        assert kern.rung == RZ.start_rung(opts.backend, True)
    assert threading.active_count() == threads
    assert not (tmp_path / "health").exists()
    st = cache.health.stats
    assert (st.reads, st.writes, st.skipped_open, st.probes) == (0, 0, 0, 0)


# ---------------------------------------------------------------------------
# ladder integration: skip open rungs instantly, probe after cool-down
# ---------------------------------------------------------------------------

def test_ladder_skips_open_rung_and_probes_after_cooldown(tmp_path):
    build, dims, _ = PROGRAMS["layernorm_matmul"]
    g = build(TAP)
    cache = C.KernelCache(root=tmp_path)
    clk = [0.0]
    cache.health.clock = lambda: clk[0]
    pol = RZ.ResiliencePolicy(breaker_threshold=2, breaker_cooldown_s=100.0,
                              retries=0)
    opts = pipeline.CompileOptions(backend="torch", resilience=pol)
    plan = RZ.FaultPlan([RZ.FaultSpec(site="compile:torch",
                                      indices=(0, 1))])

    def compile_(m):
        return pipeline.compile(g, {**dims, "M": m}, options=opts,
                                cache=cache, device="cpu")

    with RZ.faults(plan), pytest.warns(RuntimeWarning,
                                       match="compile ladder"):
        k1, k2 = compile_(2), compile_(4)
        assert k1.rung == k2.rung == "interpreter"
        # two consecutive torch failures tripped the breaker: the third
        # compile skips the rung INSTANTLY, compile:torch never called
        before = RZ.METRICS.snapshot()
        with pytest.warns(RuntimeWarning, match="breaker open"):
            k3 = compile_(8)
        assert plan.calls("compile:torch") == 2
        assert k3.rung == "interpreter"
        rr = k3.resilience_report
        assert rr.attempts[0].skipped_open and not rr.attempts[0].ok
        assert rr.skipped_open == 1
        assert RZ.METRICS.delta(before).skipped_open == 1
        # METRICS.demotions untouched by the skip
        assert RZ.METRICS.delta(before).demotions == 0

        # the open state is SHARED: a fresh cache on the same dir sees it
        assert C.KernelCache(root=tmp_path).health.state(
            g.fingerprint(), "torch") == "open"

        # cool-down elapses -> the next compile probes and recovers
        clk[0] = 100.0
        before = RZ.METRICS.snapshot()
        k4 = compile_(16)
        assert k4.rung == "torch"
        assert k4.resilience_report.attempts[0].probe
        assert k4.resilience_report.probes == 1
        assert RZ.METRICS.delta(before).probes == 1
    # recovery removed the entry: the health dir is pristine again
    assert list((tmp_path / "health").glob("*.json")) == []


def test_attempt_wall_times_recorded_for_timeout_calibration():
    rr = RZ.ResilienceReport(requested="grouped")
    rr.attempts = [
        RZ.Attempt("grouped", False, 0.0, skipped_open=True),
        RZ.Attempt("ungrouped", False, 0.8, error="X: y"),
        RZ.Attempt("ungrouped", True, 0.5, retry=1),
        RZ.Attempt("torch", True, 0.1),
    ]
    walls = rr.wall_by_rung()
    assert "grouped" not in walls  # skipped rungs never ran: no sample
    assert walls["ungrouped"] == [0.8, 0.5] and walls["torch"] == [0.1]
    assert rr.suggest_timeout_s(margin=4.0) == pytest.approx(2.0)
    assert RZ.ResilienceReport().suggest_timeout_s() is None
    js = json.loads(json.dumps(rr.to_json()))
    assert js["skipped_open"] == 1 and js["probes"] == 0


def test_run_with_timeout_daemon_worker_counted_and_transparent():
    before = RZ.METRICS.snapshot()
    started = threading.Event()

    def hang():
        started.set()
        time.sleep(30)

    with pytest.raises(RZ.AttemptTimeout):
        RZ.run_with_timeout(hang, 0.1)
    assert started.wait(5)
    workers = [t for t in threading.enumerate()
               if t.name.startswith("repro-torch-ladder")]
    # the leaked worker is daemonic: it can never block process exit
    assert workers and all(t.daemon for t in workers)
    assert RZ.METRICS.delta(before).abandoned_workers == 1
    # the non-timeout paths stay transparent: values and exceptions
    assert RZ.run_with_timeout(lambda: 7, 5.0) == 7
    with pytest.raises(ZeroDivisionError):
        RZ.run_with_timeout(lambda: 1 // 0, 5.0)
    assert RZ.METRICS.delta(before).abandoned_workers == 1


# ---------------------------------------------------------------------------
# serving-engine re-promotion: the inverse of the watchdog
# ---------------------------------------------------------------------------

def test_engine_self_heals_end_to_end(fresh_cache):
    """A transient decode fault demotes decode to the torch rung; after
    ``repromote_after`` clean ticks a half-open probe swaps the cuda rung
    back in mid-run.  Tokens equal the sequential oracle's, and the ledger
    entry clears."""
    from repro_torch.launch.engine import synth_trace
    eng = engine(tiny_cfg("cuda"), max_batch=2, max_len=32,
                 prompt_buckets=(8,), repromote_after=2)
    trace = synth_trace(4, seed=1, arrival_rate=1.0, prompt_lens=(2, 7),
                        gen_lens=(3, 5), vocab=eng.cfg.vocab)
    plan = RZ.FaultPlan([RZ.FaultSpec(site="serve:decode", indices=(1,),
                                      message="transient decode fault")])
    with RZ.faults(plan), pytest.warns(RuntimeWarning,
                                       match="re-promoted"):
        report = eng.run(trace)
    assert report.n_completed == len(trace)
    assert eng.watchdog_demotions == 1
    assert (report.repromotions, report.probes,
            report.probe_failures) == (1, 1, 0)
    assert report.decode_backend == "pipeline-cuda"
    demote = [f for f in report.failures
              if f["reason"] == "decode_demotion"]
    heal = [f for f in report.failures
            if f["reason"] == "decode_repromotion"]
    assert len(demote) == 1 and demote[0]["to"] == "pipeline-torch"
    assert len(heal) == 1 and heal[0]["to"] == "pipeline-cuda"
    # cool-down honored: the probe waited >= repromote_after clean ticks
    assert heal[0]["step"] - demote[0]["step"] >= 2
    # probe compiles are explained: strict_no_recompile stayed armed.
    # The explained ones are the demoted rung's two decode programs: the
    # probe back to cuda found its programs in memory and built nothing
    assert report.decode_recompiles == 0
    assert eng.explained_compiles == 2
    for req in trace:
        assert report.tokens[req.rid] == oracle(eng, req)
    led = RZ.HealthLedger(pipeline.default_cache().root / "health")
    assert led.state(eng._hkey, "pipeline-cuda") == "closed"
    d = json.loads(json.dumps(report.to_json()))
    assert d["repromotions"] == 1 and d["decode_backend"] == "pipeline-cuda"


def test_engine_failed_probe_reopens_at_doubled_cooldown(fresh_cache):
    from repro_torch.launch.engine import synth_trace
    eng = engine(tiny_cfg("cuda"), max_batch=2, max_len=48,
                 prompt_buckets=(8,), repromote_after=2)
    trace = synth_trace(6, seed=2, arrival_rate=1.0, prompt_lens=(2, 7),
                        gen_lens=(5, 7), vocab=eng.cfg.vocab)
    plan = RZ.FaultPlan([
        RZ.FaultSpec(site="serve:decode", indices=(1,)),
        RZ.FaultSpec(site="serve:probe", indices=(0,),
                     message="probe still cold"),
    ])
    with RZ.faults(plan), pytest.warns(RuntimeWarning, match="probe"):
        report = eng.run(trace)
    assert (report.repromotions, report.probes,
            report.probe_failures) == (1, 2, 1)
    assert report.decode_backend == "pipeline-cuda"
    failed = [f for f in report.failures if f["reason"] == "probe_failed"]
    healed = [f for f in report.failures
              if f["reason"] == "decode_repromotion"]
    assert len(failed) == 1 and len(healed) == 1
    # the failed probe doubled the cool-down: the second probe waited at
    # least 2 * repromote_after ticks after the first
    assert healed[0]["step"] - failed[0]["step"] >= 4
    assert report.n_completed == len(trace)
    assert report.decode_recompiles == 0


def test_engine_adopts_persisted_breaker_state_across_processes(
        fresh_cache):
    """A predecessor crashed the cuda decode rung and died before
    healing: a new engine adopts the persisted open breaker, starts
    demoted, then probes and re-promotes, with no watchdog demotion in
    this engine."""
    from repro_torch.launch.engine import synth_trace
    cfg = tiny_cfg("cuda")
    hroot = pipeline.default_cache().root / "health"
    RZ.HealthLedger(hroot).reopen(
        f"serve:{cfg.name}:decode", "pipeline-cuda", 1000.0,
        error="predecessor decode crash")
    with pytest.warns(RuntimeWarning, match="starting demoted"):
        eng = engine(cfg, max_batch=2, max_len=32, prompt_buckets=(8,),
                     repromote_after=2)
    assert eng._demote_stack and eng.watchdog_demotions == 0
    assert eng.cfg.pipeline_backend == "torch"
    trace = synth_trace(4, seed=1, arrival_rate=1.0, prompt_lens=(2, 7),
                        gen_lens=(3, 5), vocab=eng.cfg.vocab)
    with pytest.warns(RuntimeWarning, match="re-promoted"):
        report = eng.run(trace)
    assert report.repromotions == 1
    assert report.decode_backend == "pipeline-cuda"
    assert report.degradations == 0  # nothing demoted in THIS engine
    assert report.n_completed == len(trace)
    assert report.decode_recompiles == 0
    # the probe compiled the cuda decode programs: their kernels are
    # tracked from then on
    assert any(n.startswith("attention_decode/") for n in eng.kernels)


def test_clean_engine_run_zero_probe_counters_and_zero_ledger_io(
        fresh_cache):
    from repro_torch.launch.engine import synth_trace
    eng = engine(tiny_cfg("cuda"), max_batch=2, max_len=32,
                 prompt_buckets=(8,))
    trace = synth_trace(3, seed=0, arrival_rate=1.0, prompt_lens=(2, 6),
                        gen_lens=(2, 4), vocab=eng.cfg.vocab)
    threads = threading.active_count()
    report = eng.run(trace)
    assert threading.active_count() == threads  # no timeout worker
    assert (report.repromotions, report.probes,
            report.probe_failures) == (0, 0, 0)
    assert report.decode_backend == "pipeline-cuda"
    st = eng._ledger.stats
    assert (st.reads, st.writes, st.probes, st.skipped_open) == (0, 0, 0, 0)
    st = pipeline.default_cache().health.stats
    assert (st.reads, st.writes) == (0, 0)
    assert not (pipeline.default_cache().root / "health").exists()


# ---------------------------------------------------------------------------
# the cache's crash-recovery sweep (the rest is in tests/test_torch_cache.py)
# ---------------------------------------------------------------------------

def test_recovery_sweep_removes_dead_writer_tmp_files_in_health(tmp_path):
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()  # a pid guaranteed dead: a process that already exited
    hdir = tmp_path / "health"
    hdir.mkdir(parents=True)
    dead = hdir / f"abc.json.{p.pid}.tmp"
    dead.write_text("half-written breaker entry from a crashed writer")
    live = hdir / f"def.json.{os.getpid()}.tmp"
    live.write_text("an in-flight write by a live process")
    foreign_old = hdir / "weird.tmp"  # no pid: age decides
    foreign_old.write_text("x")
    os.utime(foreign_old, (0, 0))
    with pytest.warns(RuntimeWarning, match="orphaned tmp"):
        kc = C.KernelCache(root=tmp_path)
    assert kc.stats.recovered_tmp == 2
    assert not dead.exists() and not foreign_old.exists()
    assert live.exists()  # never races a live writer


def test_recovery_sweep_spares_a_held_lock(tmp_path):
    import fcntl
    lock = tmp_path / ".lock"
    lock.write_text("")
    os.utime(lock, (0, 0))
    fd = os.open(str(lock), os.O_RDWR)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)  # a live writer holds it
        kc = C.KernelCache(root=tmp_path)
        assert kc.stats.stale_locks == 0 and lock.exists()
    finally:
        os.close(fd)


def test_recovery_sweep_is_silent_on_a_clean_cache(tmp_path, recwarn):
    kc = C.KernelCache(root=tmp_path)  # dir does not even exist yet
    st = kc.stats
    assert (st.recovered_tmp, st.stale_locks, st.quarantine_evicted) == \
        (0, 0, 0)
    mem = C.KernelCache(disk=False)  # memory-only caches never sweep
    assert mem.stats.recovered_tmp == 0 and mem.health.root is None
    assert not [w for w in recwarn.list
                if "kernel cache" in str(w.message)]


_CONTENTION_SCRIPT = """
import hashlib, json, sys
sys.path.insert(0, sys.argv[1])
from repro_torch import pipeline
from repro_torch.core import array_program as AP

g = AP.layernorm_matmul_program(32.0)
dims = {"M": 2, "K": 4, "N": 2}
kern = pipeline.compile(g, dims, backend="py")
plan_path = pipeline.default_cache().root / (kern.key.digest() + ".json")
print(json.dumps({
    "cost": kern.cost,
    "snapshot": kern.snapshot_index,
    "sha": hashlib.sha256(plan_path.read_bytes()).hexdigest(),
}))
"""


def test_cross_process_contention_same_key(tmp_path):
    """Two processes compile the same key at once: both succeed, the
    surviving plan is byte-identical from both sides, and nothing is
    quarantined or left half-written."""
    env = dict(os.environ, REPRO_TORCH_KERNEL_CACHE=str(tmp_path))
    env.pop(RZ.ENV_VAR, None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CONTENTION_SCRIPT, str(SRC)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        text=True) for _ in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert outs[0] == outs[1]  # same plan, byte-identical envelope
    assert not list(tmp_path.glob("*.tmp"))
    assert not (tmp_path / "quarantine").exists()
    assert len(list(tmp_path.glob("*.json"))) == 1
    kc = C.KernelCache(root=tmp_path)
    assert (kc.stats.recovered_tmp, kc.stats.stale_locks) == (0, 0)
    kern = pipeline.compile(TAP.layernorm_matmul_program(32.0),
                            {"M": 2, "K": 4, "N": 2}, backend="py",
                            cache=kc)
    assert kern.cache_hit == "disk"
    assert kc.stats.corrupt_plans == 0 and kc.stats.quarantined == 0
