"""The port's resilience layer (``repro_torch.resilience``), test for test
the reference's ``tests/test_resilience.py``: degradation-ladder compiles
under injected faults (a matrix over the in-repo programs, each landing
rung held against the reference's at the same rung index and against the
reference's interpreter oracle), the ``cache:get_plan`` fault site,
serving-engine fault isolation (poison eviction with co-batched oracle
match, watchdog demotion, bounded admission, deadlines) and the
``FaultPlan`` machinery.  The cache-integrity half of the reference's
file is ``tests/test_torch_cache.py``.  Port-only: the default-policy key
digests pinned byte for byte, a CUDA device never offered a plain-version
rung (a compile, a cached CPU demotion, a call or a serving engine), the
port's own ``$REPRO_TORCH_FAULT_PLAN``, and a sticky decode error
re-raised by the watchdog."""

import json
import time
import types
import warnings

import numpy as np
import pytest
import torch

from repro import pipeline as JP
from repro import resilience as JRZ
from repro.core import array_program as JAP
from repro_torch import configs, pipeline
from repro_torch import resilience as RZ
from repro_torch.core import array_program as TAP
from repro_torch.models import layers as L
from reference_cpu import reference_on_cpu  # noqa: E402, F401
from test_torch_cuda import PROGRAMS, merged_inputs  # noqa: E402
import torch_port  # noqa: F401


def _fresh(monkeypatch, root):
    """A new process's state over cache directory ``root``: no
    in-process kernels, no default cache object."""
    monkeypatch.setenv("REPRO_TORCH_KERNEL_CACHE", str(root))
    pipeline.reset_default_cache()
    L.attention_kernel.cache_clear()
    L.swiglu_kernel.cache_clear()


@pytest.fixture()
def fresh_cache(tmp_path, monkeypatch):
    _fresh(monkeypatch, tmp_path)
    yield tmp_path
    _fresh(monkeypatch, tmp_path)


@pytest.fixture(autouse=True)
def _no_env_plan(monkeypatch):
    monkeypatch.delenv(RZ.ENV_VAR, raising=False)
    monkeypatch.delenv("REPRO_FAULT_PLAN", raising=False)
    RZ.install(None)
    JRZ.install(None)
    yield
    RZ.install(None)
    JRZ.install(None)


def _mem_cache():
    return pipeline.KernelCache(disk=False)


# ---------------------------------------------------------------------------
# ladder primitives
# ---------------------------------------------------------------------------

def test_ladder_order_and_rungs_from():
    assert RZ.LADDER == ("grouped", "ungrouped", "torch", "interpreter")
    assert RZ.start_rung("cuda", True) == "grouped"
    assert RZ.start_rung("cuda", False) == "ungrouped"
    assert RZ.start_rung("torch", True) == "torch"
    assert RZ.start_rung("py", True) == "interpreter"
    assert RZ.rungs_from("grouped", "interpreter") == RZ.LADDER
    assert RZ.rungs_from("ungrouped", "torch") == ("ungrouped", "torch")
    # a max_rung ABOVE the start permits no demotion at all
    assert RZ.rungs_from("torch", "grouped") == ("torch",)
    with pytest.raises(ValueError):
        RZ.rung_index("warp-speed")
    # the reference's ladder, rung for rung (jax -> torch)
    assert [r.replace("jax", "torch") for r in JRZ.LADDER] == \
        list(RZ.LADDER)


def test_policy_is_frozen_hashable_and_keyed():
    p = RZ.ResiliencePolicy(max_rung="torch", retries=2)
    assert hash(p) != hash(RZ.DEFAULT_POLICY)
    assert p.key() == ("torch", None, 2, 0.05, 3, 60.0, 3600.0)
    with pytest.raises(ValueError):
        RZ.ResiliencePolicy(max_rung="nope")
    # non-default policies land in the cache-key opts; the default stays
    # byte-identical to keys made before the field existed
    base = pipeline.CompileOptions(backend="torch")
    keyed = pipeline.CompileOptions(backend="torch", resilience=p)
    assert base.cache_opts(stabilized=False, autotuned=False) == \
        pipeline.CompileOptions(
            backend="torch",
            resilience=RZ.ResiliencePolicy()).cache_opts(
                stabilized=False, autotuned=False)
    assert ("resilience", p.key()) in keyed.cache_opts(
        stabilized=False, autotuned=False)
    assert base != keyed


# the digests of one fixed program's default-policy keys, taken on the
# tree before CompileOptions had a resilience field: a plan cached then
# must still hit
_PINNED_DIGESTS = {"py": "904639f0dc9477caf60d4744980e0d65",
                   "torch": "be3aa042969d62f81bc4bdca7c626c60",
                   "cuda": "a37a314598c58e4578e709b2d8dc1a2a"}


@pytest.mark.parametrize("backend", sorted(_PINNED_DIGESTS))
def test_default_policy_keys_are_byte_identical(backend):
    build, dims, blocks = PROGRAMS["layernorm_matmul"]
    for opts in (pipeline.CompileOptions(
            backend=backend, blocks=blocks if backend == "cuda" else None),
            pipeline.CompileOptions(
                backend=backend,
                blocks=blocks if backend == "cuda" else None,
                resilience=RZ.ResiliencePolicy())):
        kern = pipeline.compile(build(TAP), dims, options=opts,
                                cache=_mem_cache())
        assert kern.key.digest() == _PINNED_DIGESTS[backend]


def test_serving_decode_key_is_byte_identical():
    """smollm-135m's decode attention at its serving shape: the key the
    parent's warm start (chip_smoke.py phase 4a) loads."""
    dims, blocks = L._pipeline_dims_blocks({"M": 1, "D": 64, "N": 96,
                                            "L": 64})
    dims["H"], blocks["H"] = 3, 1
    kern = pipeline.compile(
        TAP.gqa_attention_program(1.0 / 8.0, causal=True), dims,
        options=pipeline.CompileOptions(backend="cuda", blocks=blocks),
        cache=_mem_cache())
    assert kern.key.digest() == "08062f352b0d108e01933dadf73490cb"


# ---------------------------------------------------------------------------
# the fault-injection matrix: every program x injected compile faults,
# held against the reference's ladder under the same faults
# ---------------------------------------------------------------------------

_FAULT_MATRIX = [
    # (faulted rungs, expected served rung, expected demotions)
    ((), "grouped", 0),
    (("grouped",), "ungrouped", 1),
    (("grouped", "ungrouped"), "torch", 2),
    (("grouped", "ungrouped", "torch"), "interpreter", 3),
]


@pytest.mark.parametrize("name", sorted(PROGRAMS))
@pytest.mark.parametrize("rungs,rung,demotions", _FAULT_MATRIX,
                         ids=["none", "grouped", "ungrouped", "torch"])
def test_ladder_matrix_matches_reference_and_oracle(name, rungs, rung,
                                                    demotions):
    build, dims, blocks = PROGRAMS[name]
    inputs = merged_inputs(build(TAP), dims, blocks)
    jg = build(JAP)
    oracle = JP.compile(jg, dims, backend="py",
                        cache=JP.KernelCache(disk=False))(dict(inputs))
    jplan = JRZ.FaultPlan([JRZ.FaultSpec(site=f"compile:{r}")
                           for r in rungs if r != "torch"]
                          + [JRZ.FaultSpec(site="compile:jax")
                             for r in rungs if r == "torch"])
    with JRZ.faults(jplan), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = JP.compile(jg, dims, backend="pallas", blocks=blocks,
                         cache=JP.KernelCache(disk=False))

    plan = RZ.FaultPlan([RZ.FaultSpec(site=f"compile:{r}") for r in rungs])
    before = RZ.METRICS.snapshot()
    with RZ.faults(plan), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        kern = pipeline.compile(build(TAP), dims, backend="cuda",
                                blocks=blocks, cache=_mem_cache(),
                                device="cpu")
    rr = kern.resilience_report
    assert rr.rung == rung == kern.rung and rr.requested == "grouped"
    assert rr.demotions == demotions == ref.resilience_report.demotions
    assert RZ.rung_index(rung) == JRZ.rung_index(ref.rung)
    assert len(rr.errors) == len(rungs)
    assert all("InjectedFault" in e for e in rr.errors)
    assert plan.fired_count() == len(rungs)
    assert RZ.METRICS.delta(before).demotions == demotions
    assert sum("compile ladder" in str(w.message)
               for w in caught) == demotions
    got = kern({n: torch.from_numpy(v) for n, v in inputs.items()})
    for nm in oracle:
        np.testing.assert_allclose(np.asarray(got[nm]),
                                   np.asarray(oracle[nm]),
                                   rtol=2e-4, atol=2e-4)


def test_happy_path_report_is_one_ok_attempt():
    build, dims, blocks = PROGRAMS["layernorm_matmul"]
    before = RZ.METRICS.snapshot()
    kern = pipeline.compile(build(TAP), dims, backend="cuda",
                            blocks=blocks, cache=_mem_cache())
    rr = kern.resilience_report
    assert rr.rung == rr.requested == "grouped"
    assert rr.demotions == 0 and rr.errors == []
    assert [a.ok for a in rr.attempts] == [True]
    d = RZ.METRICS.delta(before)
    assert d.demotions == 0 and d.faults_fired == 0
    # the report is JSON-serializable provenance
    js = json.loads(json.dumps(rr.to_json()))
    assert js["demotions"] == 0 and js["rung"] == "grouped"


def test_retry_recovers_at_same_rung():
    """A transient failure with a retry budget: the second try at the
    SAME rung succeeds, no demotion recorded."""
    build, dims, blocks = PROGRAMS["layernorm_matmul"]
    plan = RZ.FaultPlan([RZ.FaultSpec(site="compile:grouped",
                                      indices=(0,))])
    opts = pipeline.CompileOptions(
        backend="cuda", blocks=blocks,
        resilience=RZ.ResiliencePolicy(retries=1, backoff_s=0.0))
    with RZ.faults(plan):
        kern = pipeline.compile(build(TAP), dims, options=opts,
                                cache=_mem_cache())
    rr = kern.resilience_report
    assert rr.rung == "grouped" and rr.demotions == 0
    assert [(a.ok, a.retry) for a in rr.attempts] == [(False, 0),
                                                      (True, 1)]


def test_slow_compile_times_out_and_demotes():
    build, dims, blocks = PROGRAMS["layernorm_matmul"]
    plan = RZ.FaultPlan([RZ.FaultSpec(site="compile:grouped",
                                      kind="sleep", sleep_s=5.0)])
    opts = pipeline.CompileOptions(
        backend="cuda", blocks=blocks,
        resilience=RZ.ResiliencePolicy(attempt_timeout_s=0.2))
    t0 = time.perf_counter()
    with RZ.faults(plan), pytest.warns(RuntimeWarning,
                                       match="compile ladder"):
        kern = pipeline.compile(build(TAP), dims, options=opts,
                                cache=_mem_cache())
    assert time.perf_counter() - t0 < 4.0  # did not wait for the sleep
    rr = kern.resilience_report
    assert rr.attempts[0].timed_out and not rr.attempts[0].ok
    assert rr.rung == "ungrouped"


def test_bounded_max_rung_exhaustion_raises_ladder_error():
    build, dims, blocks = PROGRAMS["layernorm_matmul"]
    plan = RZ.FaultPlan([RZ.FaultSpec(site="compile:grouped"),
                         RZ.FaultSpec(site="compile:ungrouped")])
    opts = pipeline.CompileOptions(
        backend="cuda", blocks=blocks,
        resilience=RZ.ResiliencePolicy(max_rung="ungrouped"))
    before = RZ.METRICS.snapshot()
    with RZ.faults(plan), pytest.warns(RuntimeWarning), \
            pytest.raises(RZ.LadderError) as ei:
        pipeline.compile(build(TAP), dims, options=opts, cache=_mem_cache())
    rep = ei.value.report
    assert [a.rung for a in rep.attempts] == ["grouped", "ungrouped"]
    assert RZ.METRICS.delta(before).ladder_failures == 1
    assert "not offered" not in str(ei.value)


@pytest.mark.parametrize("blocks", [None, {"M": 4}],
                         ids=["no-blocks", "missing-dims"])
def test_config_errors_raise_instead_of_demoting(blocks):
    """A caller's mistake (cuda without blocks, or without a dim's block)
    is not a failure to survive: it raises before any rung runs."""
    build, dims, _ = PROGRAMS["layernorm_matmul"]
    plan = RZ.FaultPlan()
    before = RZ.METRICS.snapshot()
    with RZ.faults(plan), pytest.raises(ValueError, match="blocks"):
        pipeline.compile(build(TAP), dims, backend="cuda", blocks=blocks,
                         cache=_mem_cache())
    assert plan.calls("compile:grouped") == 0
    assert RZ.METRICS.delta(before).demotions == 0


def test_cuda_device_is_never_offered_the_interpreter():
    """On a CUDA device (a device string: compiling touches no device) a
    compile never demotes to a plain version: a cuda ladder stops at
    ``ungrouped`` and a torch one at ``torch``, so neither the torch rung
    nor the interpreter is offered, and exhausting the ladder raises
    ``LadderError`` saying so.  On the CPU the same faults land on the
    interpreter."""
    from repro_torch.pipeline import driver as D
    pol = RZ.DEFAULT_POLICY
    for dev in ("cuda", "cuda:0", torch.device("cuda", 1)):
        assert D._ladder_rungs("grouped", pol, dev) == (
            "grouped", "ungrouped")
        assert D._ladder_rungs("ungrouped", pol, dev) == ("ungrouped",)
        assert D._ladder_rungs("torch", pol, dev) == ("torch",)
    assert D._ladder_rungs("grouped", pol, "cpu") == RZ.LADDER
    # an explicit py backend is the interpreter by request, not demotion
    assert D._ladder_rungs("interpreter", pol, "cuda") == ("interpreter",)
    build, dims, blocks = PROGRAMS["layernorm_matmul"]
    sites = ("compile:grouped", "compile:ungrouped")
    plan = RZ.FaultPlan([RZ.FaultSpec(site=s) for s in sites])
    with RZ.faults(plan), pytest.warns(RuntimeWarning), \
            pytest.raises(RZ.LadderError, match="never demotes to a plain") \
            as ei:
        pipeline.compile(build(TAP), dims, backend="cuda", blocks=blocks,
                         cache=_mem_cache(), device="cuda:0")
    assert [a.rung for a in ei.value.report.attempts] == [
        "grouped", "ungrouped"]
    assert plan.calls("compile:torch") == 0
    plan = RZ.FaultPlan([RZ.FaultSpec(site=s)
                         for s in sites + ("compile:torch",)])
    with RZ.faults(plan), pytest.warns(RuntimeWarning):
        kern = pipeline.compile(build(TAP), dims, backend="cuda",
                                blocks=blocks, cache=_mem_cache(),
                                device="cpu")
    assert kern.rung == "interpreter"
    # and the interpreter serves no CUDA tensor (a stand-in with
    # ``is_cuda``: there is no card here)
    inputs = {n: torch.from_numpy(v) for n, v in
              merged_inputs(build(TAP), dims, blocks).items()}
    inputs[kern.in_names[0]] = types.SimpleNamespace(is_cuda=True)
    with pytest.raises(RuntimeError, match="serves CPU tensors only"):
        kern(inputs)
    with pytest.raises(ValueError, match="no CUDA tensors"):
        kern._fn(inputs)


def test_cpu_demotion_is_never_served_to_the_card():
    """A compile the ladder demoted to the torch rung on the CPU refuses a
    CUDA tensor (a stand-in with ``is_cuda``) when called, and a later
    compile of the same program for a CUDA device does not take it from
    the in-memory cache: it lowers anew on the cuda rung."""
    build, dims, blocks = PROGRAMS["layernorm_matmul"]
    cache = _mem_cache()
    plan = RZ.FaultPlan([RZ.FaultSpec(site="compile:grouped"),
                         RZ.FaultSpec(site="compile:ungrouped")])
    with RZ.faults(plan), pytest.warns(RuntimeWarning):
        cpu = pipeline.compile(build(TAP), dims, backend="cuda",
                               blocks=blocks, cache=cache, device="cpu")
    assert cpu.rung == "torch" and cpu.demoted_to_plain
    inputs = {n: torch.from_numpy(v) for n, v in
              merged_inputs(build(TAP), dims, blocks).items()}
    want = cpu(inputs)  # CPU tensors: the plain version serves
    inputs[cpu.in_names[0]] = types.SimpleNamespace(is_cuda=True)
    with pytest.raises(RuntimeError, match="serves CPU tensors only"):
        cpu(inputs)
    card = pipeline.compile(build(TAP), dims, backend="cuda", blocks=blocks,
                            cache=cache, device="cuda")
    assert card.rung == "grouped" and card.cache_hit != "memory"
    assert not card.demoted_to_plain
    # the CPU compile asked for nothing plain: a torch backend is no
    # demotion, and serves what it was asked for
    asked = pipeline.compile(build(TAP), dims, backend="torch",
                             cache=cache, device="cuda")
    assert asked.rung == "torch" and not asked.demoted_to_plain
    got = card({n: torch.from_numpy(v) for n, v in
                merged_inputs(build(TAP), dims, blocks).items()})
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# fault plan machinery
# ---------------------------------------------------------------------------

def test_fault_plan_is_deterministic_and_roundtrips():
    spec = RZ.FaultSpec(site="compile:grouped", indices=(1, 3),
                        kind="raise", message="boom")
    plan = RZ.FaultPlan([spec], seed=7)
    fired = [plan.fire("compile:grouped") is not None for _ in range(5)]
    assert fired == [False, True, False, True, False]
    assert plan.calls("compile:grouped") == 5
    assert plan.fired_count() == 2
    assert plan.expected_count("compile:") == 2

    plan2 = RZ.FaultPlan.from_json(
        json.loads(json.dumps(plan.to_json())))
    assert plan2.seed == 7 and plan2.specs == (spec,)
    fired2 = [plan2.fire("compile:grouped") is not None for _ in range(5)]
    assert fired2 == fired  # same plan, same schedule, every run

    plan.reset()
    assert plan.calls("compile:grouped") == 0 and plan.fired_count() == 0
    with pytest.raises(ValueError, match="fault kind"):
        RZ.FaultSpec(site="x", kind="explode")


def test_env_var_activates_plan_in_its_own_package_only(monkeypatch):
    """``$REPRO_TORCH_FAULT_PLAN`` activates a plan in the port and not in
    the reference; the reference's ``$REPRO_FAULT_PLAN`` activates one in
    the reference and not in the port."""
    raw = json.dumps({"seed": 1, "faults": [
        {"site": "compile:grouped", "indices": [0]}]})
    assert RZ.ENV_VAR == "REPRO_TORCH_FAULT_PLAN"
    monkeypatch.setenv("REPRO_TORCH_FAULT_PLAN", raw)
    plan = RZ.active()
    assert plan is not None and plan.seed == 1
    assert RZ.active() is plan  # cached per env value: counters survive
    assert JRZ.active() is None
    with pytest.raises(RZ.InjectedFault):
        RZ.check("compile:grouped")
    monkeypatch.delenv("REPRO_TORCH_FAULT_PLAN")
    monkeypatch.setenv("REPRO_FAULT_PLAN", raw)
    assert RZ.active() is None and JRZ.active() is not None
    RZ.check("compile:grouped")  # the reference's plan never fires here


def test_run_with_timeout_does_not_block_on_hung_worker():
    t0 = time.perf_counter()
    with pytest.raises(RZ.AttemptTimeout):
        RZ.run_with_timeout(lambda: time.sleep(10), 0.1)
    assert time.perf_counter() - t0 < 5.0  # returned without joining


# ---------------------------------------------------------------------------
# the cache:get_plan fault site (the cache's integrity tests are in
# tests/test_torch_cache.py)
# ---------------------------------------------------------------------------

def test_injected_cache_corruption_drives_real_machinery(fresh_cache):
    """A ``corrupt`` fault garbles the REAL on-disk entry; detection,
    quarantine and recompile all run for real."""
    g = TAP.layernorm_matmul_program(32.0)
    dims = {"M": 2, "K": 4, "N": 2}
    assert pipeline.compile(g, dims, backend="torch").cache_hit is None
    pipeline.reset_default_cache()
    plan = RZ.FaultPlan([RZ.FaultSpec(site="cache:get_plan",
                                      kind="corrupt")])
    with RZ.faults(plan), pytest.warns(RuntimeWarning,
                                       match="corrupt plan"):
        k2 = pipeline.compile(g, dims, backend="torch")
    assert k2.cache_hit is None  # quarantined -> an honest miss
    st = pipeline.default_cache().stats
    assert st.corrupt_plans == 1 and st.quarantined == 2
    assert len(list((fresh_cache / "quarantine").iterdir())) == 2
    # the rewritten entry serves the next compile from disk again
    pipeline.reset_default_cache()
    assert pipeline.compile(g, dims, backend="torch").cache_hit == "disk"


# ---------------------------------------------------------------------------
# serving isolation: poison eviction, watchdog, admission bounds, deadlines
# ---------------------------------------------------------------------------

def tiny_cfg(backend="torch", **overrides):
    mc = configs.get_reduced_config(
        "smollm-135m", n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
        d_head=32, d_ff=128, vocab=128, **overrides)
    return configs.with_pipeline(
        mc, options=pipeline.CompileOptions(backend=backend))


def engine(cfg, **kw):
    from repro_torch.launch.engine import Engine
    kw.setdefault("sampling", "greedy")
    return Engine(cfg, device="cpu", seed=0, **kw)


def oracle(eng, req):
    """Per-sequence sequential greedy decode: no batching, no padding."""
    m, params = eng.model, eng.params
    lg, cache = m.prefill(params, torch.tensor([req.prompt]),
                          max_len=eng.max_len)
    tok = int(lg[0, -1].argmax())
    toks, pos = [tok], len(req.prompt)
    for _ in range(req.max_new_tokens - 1):
        lg, cache = m.decode_step(params, cache, torch.tensor([[tok]]), pos)
        tok = int(lg[0, -1].argmax())
        toks.append(tok)
        pos += 1
    return toks


def test_poison_request_evicted_cobatched_match_oracle(fresh_cache):
    """One NaN-logits request is evicted with a failure record while
    every co-batched sequence's tokens equal the sequential oracle's."""
    from repro_torch.launch.engine import synth_trace
    eng = engine(tiny_cfg("torch"), max_batch=3, max_len=48,
                 prompt_buckets=(8, 16))
    trace = synth_trace(6, seed=3, arrival_rate=1.5, prompt_lens=(3, 14),
                        gen_lens=(3, 6), vocab=eng.cfg.vocab)
    plan = RZ.FaultPlan([RZ.FaultSpec(site="serve:logits", indices=(1,),
                                      kind="nan")])
    with RZ.faults(plan):
        report = eng.run(trace)
    assert report.n_poisoned == 1
    bad = [f for f in report.failures
           if f["reason"] == "nonfinite_logits"]
    assert len(bad) == 1 and "rid" in bad[0] and "step" in bad[0]
    poisoned = bad[0]["rid"]
    assert report.n_completed == len(trace) - 1
    for req in trace:
        if req.rid != poisoned:
            assert report.tokens[req.rid] == oracle(eng, req), req.rid


def test_watchdog_demotes_decode_and_keeps_serving(fresh_cache):
    """A decode crash mid-run demotes decode one rung and the run
    completes; tokens equal the oracle on the ORIGINAL impl (the demoted
    rung computes the same function)."""
    from repro_torch.launch.engine import synth_trace
    eng = engine(tiny_cfg("cuda"), max_batch=2, max_len=32,
                 prompt_buckets=(8,))
    ref_eng = engine(tiny_cfg("cuda"), max_batch=2, max_len=32,
                     prompt_buckets=(8,))
    trace = synth_trace(4, seed=1, arrival_rate=1.0, prompt_lens=(2, 7),
                        gen_lens=(3, 5), vocab=eng.cfg.vocab)
    plan = RZ.FaultPlan([RZ.FaultSpec(site="serve:decode", indices=(1,))])
    with RZ.faults(plan), pytest.warns(RuntimeWarning,
                                       match="serve watchdog"):
        report = eng.run(trace)
    assert report.n_completed == len(trace)
    assert eng.watchdog_demotions == 1
    assert report.degradations >= 1
    demos = [f for f in report.failures
             if f["reason"] == "decode_demotion"]
    assert len(demos) == 1 and demos[0]["to"] == "pipeline-torch"
    # the demotion's compiles are explained, and nothing else compiled
    assert report.decode_recompiles == 0 and eng.explained_compiles > 0
    for req in trace:
        assert report.tokens[req.rid] == oracle(ref_eng, req)


def test_watchdog_reraises_a_sticky_error(fresh_cache, monkeypatch):
    """When the retry on the demoted rung fails too (a sticky CUDA error
    poisons the whole context), the original error is raised: once, no
    loop down the ladder."""
    from repro_torch.launch.engine import Request
    from repro_torch.models import lm
    eng = engine(tiny_cfg("cuda"), max_batch=2, max_len=32,
                 prompt_buckets=(8,))
    eng.warmup()
    calls = []

    def sticky(self, *a, **k):
        calls.append(self.cfg.pipeline_backend)
        raise RuntimeError(f"illegal memory access #{len(calls)}")

    monkeypatch.setattr(lm.LM, "decode_step", sticky)
    with pytest.warns(RuntimeWarning, match="serve watchdog"), \
            pytest.raises(RuntimeError, match="#1") as ei:
        eng.run([Request(0, (1, 2, 3), 4, 0)])
    assert calls == ["cuda", "torch"]
    assert "#2" in str(ei.value.__cause__)
    assert eng.watchdog_demotions == 1


def test_card_engine_never_demotes_decode(fresh_cache, monkeypatch):
    """On the card (``serving_ladder`` is false for a CUDA device; the
    rule is applied here to CPU tensors, there being no card) a decode
    fault raises out of ``run`` as it is: no demotion to the plain
    ``pipeline-torch`` rung, no probe, no breaker in the health ledger,
    and an open breaker another engine left there is not adopted."""
    from pathlib import Path

    from repro_torch.launch import engine as E
    from repro_torch.launch.engine import Request
    assert E.serving_ladder("cpu") and not E.serving_ladder("cuda:0")
    assert not E.serving_ladder(torch.device("cuda", 1))
    trace = [Request(0, (1, 2, 3), 6, 0), Request(1, (4, 5), 6, 0)]
    plan = RZ.FaultPlan([RZ.FaultSpec(site="serve:decode", indices=(1,))])
    cpu = engine(tiny_cfg("cuda"), max_batch=2, max_len=32,
                 prompt_buckets=(8,), repromote_after=64)
    with RZ.faults(plan), pytest.warns(RuntimeWarning,
                                       match="serve watchdog"):
        assert cpu.run(trace).decode_backend == "pipeline-torch"
    hdir = Path(pipeline.default_cache().root) / "health"
    assert len(list(hdir.glob("*.json"))) == 1  # an open breaker

    monkeypatch.setattr(E, "serving_ladder", lambda device: False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # nothing demoted or adopted
        card = engine(tiny_cfg("cuda"), max_batch=2, max_len=32,
                      prompt_buckets=(8,), repromote_after=2)
        assert card.cfg.pipeline_backend == "cuda"
        card.warmup()
        plan.reset()
        with RZ.faults(plan), pytest.raises(RZ.InjectedFault):
            card.run(trace)
    assert (card.watchdog_demotions, card.probes) == (0, 0)
    assert card.cfg.pipeline_backend == "cuda" and card._ledger is None
    assert len(list(hdir.glob("*.json"))) == 1  # only the CPU engine's


def test_bounded_admission_rejects_with_record(fresh_cache):
    from repro_torch.launch.engine import Request
    eng = engine(tiny_cfg("torch"), max_batch=1, max_len=32,
                 prompt_buckets=(8,), max_queue=1)
    trace = [Request(rid=i, prompt=(1, 2, 3), max_new_tokens=3,
                     arrival_step=0) for i in range(5)]
    report = eng.run(trace)
    overflows = [f for f in report.failures
                 if f["reason"] == "queue_full"]
    assert report.n_rejected == len(overflows) > 0
    assert report.max_queue_depth <= 1
    assert report.n_completed == len(trace) - report.n_rejected


def test_deadline_evicts_queued_and_active(fresh_cache):
    from repro_torch.launch.engine import Request
    eng = engine(tiny_cfg("torch"), max_batch=1, max_len=48,
                 prompt_buckets=(8,))
    trace = [
        # holds the only slot for a while
        Request(rid=0, prompt=(1, 2, 3), max_new_tokens=12,
                arrival_step=0),
        # active eviction: admitted but cut off mid-generation
        Request(rid=1, prompt=(4, 5, 6), max_new_tokens=12,
                arrival_step=0, deadline_step=14),
        # queued eviction: expires while waiting behind the others
        Request(rid=2, prompt=(7, 8), max_new_tokens=4,
                arrival_step=0, deadline_step=2),
    ]
    report = eng.run(trace)
    assert report.n_deadline_evicted == 2
    reasons = sorted(f["reason"] for f in report.failures)
    assert reasons == ["deadline", "deadline_queued"]
    assert report.n_completed == 1
    assert 0 < len(report.tokens[1]) < 12  # partial output recorded


def test_clean_serve_run_has_zero_resilience_counters(fresh_cache):
    from repro_torch.launch.engine import synth_trace
    eng = engine(tiny_cfg("cuda"), max_batch=2, max_len=32,
                 prompt_buckets=(8,))
    trace = synth_trace(3, seed=0, arrival_rate=1.0, prompt_lens=(2, 6),
                        gen_lens=(2, 4), vocab=eng.cfg.vocab)
    report = eng.run(trace)
    assert (report.degradations, report.quarantined, report.n_poisoned,
            report.n_deadline_evicted, report.cuda_degraded) == (
                0, 0, 0, 0, 0)
    assert report.decode_backend == "pipeline-cuda"
    assert report.failures == []
    # every serving program on its requested rung
    progs = L.pipeline_kernels(eng.cfg, prefill_lens=(8,), decode_batch=2,
                               max_len=32)
    assert {k.rung for k in progs.values()} == {"grouped"}
    # the new counters serialize with the report
    d = json.loads(json.dumps(report.to_json()))
    assert d["degradations"] == 0 and d["failures"] == []
