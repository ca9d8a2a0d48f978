"""The port's serving engine under faults, held against the reference's on
the CPU: reduced smollm-135m (2 layers) with the reference's weights, the
port on backend ``cuda`` (its kernels' plain versions on CPU tensors), the
reference on ``pallas`` (interpret mode), fed the same trace and the same
``FaultPlan``.  The trace is ``chip_smoke.py``'s (phase 4's requests, at
the full vocabulary), and the cases are its phase 11 runs:

* ``watchdog``: a decode fault, re-promotion off;
* ``chaos``: the reference's chaos plan (both cuda rungs of the first
  compile, the first plan read corrupted, a NaN logits row) on a filled
  cache directory, which poisons one request;
* ``card_chaos``: phase 11's cut of it for the card, where a compile
  never demotes to a plain version: the grouped rung faulted only;
* ``queue``: ``max_queue=2`` with every request arriving at once;
* ``deadline``: ``chip_smoke.deadline_trace`` (deadlines queued and
  active) with ``max_queue=2``;
* ``heal``: the reference's heal plan (a decode fault and a failing first
  probe).

The chaos, card_chaos, deadline and heal runs start, as on the card,
from a cache directory holding every serving program's plan on the
kernels' backend and on the plain one (phase 4 serves both); they run in
``tests/test_torch_resilience_chip.py``, a file of their own so that
the test workers share the load.  Each case gives the same failure
records (labels mapped ``pallas`` -> ``cuda``, ``jax`` -> ``torch``,
``xla`` -> ``chunked``), the same counters and the same greedy tokens as
the reference, and card_chaos and deadline give the counters
``chip_smoke.py`` holds the card to (``resilience_expected``,
``DEADLINE_RECORDS``).
Port-only: a probe on a rung that writes NaN over the whole cache leaves
the next ticks' tokens bit-equal to a run without the probe (the probe
decodes on a copy), and an open breaker persisted by one engine is
adopted by the next engine on the same cache directory."""

import dataclasses
import sys
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro import pipeline as JP
from repro import resilience as JRZ
from repro.launch import engine as JE
from repro.models import layers as JL
from repro_torch import configs as TC
from repro_torch import pipeline as TP
from repro_torch import resilience as RZ
from repro_torch.launch import engine as TE
from repro_torch.models import layers as TL
from repro_torch.models.lm import LM as TLM
from reference_cpu import reference_on_cpu  # noqa: E402, F401
import torch_port  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as CS  # noqa: E402

ENGINE = dict(max_batch=CS.SERVE["max_batch"], max_len=CS.SERVE["max_len"],
              prompt_buckets=CS.SERVE["prompt_buckets"], seed=0)
LABELS = {"pipeline-pallas": "pipeline-cuda", "pipeline-jax":
          "pipeline-torch", "xla": "chunked"}
COUNTERS = ("n_completed", "n_rejected", "n_poisoned", "n_deadline_evicted",
            "n_evicted_stalled", "degradations", "repromotions", "probes",
            "probe_failures", "quarantined", "cache_misses",
            "cache_disk_hits", "decode_recompiles", "steps")
CASES = {
    # name: (faults, engine options, trace maker, warm cache)
    "watchdog": ([{"site": "serve:decode", "indices": [2],
                   "kind": "raise"}], {"repromote_after": None}, None,
                 False),
    "chaos": (list(CS.CHAOS_FAULTS), {}, None, True),
    "card_chaos": (list(CS.CARD_CHAOS_FAULTS), {}, None, True),
    "queue": ([], {"max_queue": CS.DEADLINE_MAX_QUEUE}, None, False),
    "deadline": ([], {"max_queue": CS.DEADLINE_MAX_QUEUE},
                 CS.deadline_trace, True),
    "heal": (list(CS.HEAL_FAULTS),
             {"repromote_after": CS.HEAL_REPROMOTE_AFTER}, None, True),
}


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    monkeypatch.delenv(RZ.ENV_VAR, raising=False)
    monkeypatch.delenv("REPRO_FAULT_PLAN", raising=False)
    monkeypatch.setenv("REPRO_KERNEL_CACHE", str(tmp_path / "ref"))
    monkeypatch.setenv("REPRO_TORCH_KERNEL_CACHE", str(tmp_path / "port"))
    _new_process()
    yield
    _new_process()


def _new_process():
    """What a new process starts from: no in-process kernel of either
    package, new default caches (the disk directories stay)."""
    JP.reset_default_cache()
    JL._attention_kernel.cache_clear()
    JL._swiglu_kernel.cache_clear()
    TP.reset_default_cache()
    TL.attention_kernel.cache_clear()
    TL.swiglu_kernel.cache_clear()
    RZ.install(None)
    JRZ.install(None)


def _configs():
    # the full vocabulary, so that chip_smoke.py's trace embeds as is
    vocab = TC.get_config(CS.RESILIENCE_ARCH).vocab
    jc = JC.with_pipeline(
        JC.get_reduced_config(CS.RESILIENCE_ARCH, n_layers=2, vocab=vocab),
        options=JP.CompileOptions(backend="pallas"))
    tc = TC.with_pipeline(
        TC.get_reduced_config(CS.RESILIENCE_ARCH, n_layers=2, vocab=vocab),
        options=TP.CompileOptions(backend="cuda"))
    return jc, tc


def _trace(vocab, make=None):
    trace = TE.synth_trace(CS.SERVE["n_requests"], seed=CS.SERVE["seed"],
                           prompt_lens=CS.SERVE["prompt_lens"],
                           gen_lens=CS.SERVE["gen_lens"], vocab=vocab)
    trace = make(trace) if make else trace
    return trace, [JE.Request(**dataclasses.asdict(r)) for r in trace]


def _plans(faults):
    return (JRZ.FaultPlan.from_json({"faults": faults}),
            RZ.FaultPlan.from_json({"faults": faults}))


def _records(report, port):
    out = []
    for f in report.failures:
        f = {k: v for k, v in f.items() if k not in ("error", "ms")}
        for k in ("to", "rung"):
            if k in f and not port:
                f[k] = LABELS.get(f[k], f[k])
        out.append(f)
    return out


def _serve(jcfg, tcfg, trace, jtrace, faults, opts, warm):
    """Both engines over the same trace and plan: the reference's
    report, the port's report and the port's engine.  ``warm``: clean
    warmups on the kernels' backend and on the plain one fill each cache
    directory first, and the faulted run starts from a new process's
    state over it."""
    ref_params = None
    if warm:
        ref = JE.Engine(jcfg, **ENGINE, **opts)
        ref_params = ref.params
        ref.warmup()
        JE.Engine(dataclasses.replace(
            jcfg, pipeline_backend="jax",
            pipeline_options=JP.CompileOptions(backend="jax")),
            **ENGINE, **opts).warmup()
    jplan, tplan = _plans(faults)
    with JRZ.faults(jplan), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        JP.reset_default_cache()
        JL._attention_kernel.cache_clear()
        JL._swiglu_kernel.cache_clear()
        ref = JE.Engine(jcfg, **ENGINE, **opts)
        want = ref.run(jtrace)
    params = TLM(tcfg).from_jax_params(
        jax.tree.map(np.asarray, ref_params or ref.params), "cpu")
    if warm:
        for cfg in (tcfg, TC.with_pipeline(tcfg, backend="torch")):
            TE.Engine(cfg, params=params, device="cpu", **ENGINE,
                      **opts).warmup()
        TP.reset_default_cache()
        TL.attention_kernel.cache_clear()
        TL.swiglu_kernel.cache_clear()
    with RZ.faults(tplan), warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        eng = TE.Engine(tcfg, params=params, device="cpu", **ENGINE, **opts)
        got = eng.run(trace)
    assert len(jplan.fired) == len(tplan.fired) == tplan.expected_count()
    got.warnings = [str(w.message) for w in caught]
    return want, got, eng


@pytest.mark.parametrize("case", ["watchdog", "queue"])
def test_engine_under_faults_matches_reference(case):
    check_case(case)


def check_case(case):
    """One case of :data:`CASES`: the port's engine against the
    reference's, and against ``chip_smoke.py``'s expectations."""
    faults, opts, make, warm = CASES[case]
    jcfg, tcfg = _configs()
    trace, jtrace = _trace(tcfg.vocab, make)
    want, got, eng = _serve(jcfg, tcfg, trace, jtrace, faults, opts, warm)

    assert _records(got, True) == _records(want, False)
    assert {k: getattr(got, k) for k in COUNTERS} == {
        k: getattr(want, k) for k in COUNTERS}
    assert got.decode_backend == LABELS.get(want.decode_backend,
                                            want.decode_backend)
    poisoned = {f["rid"] for f in got.failures
                if f["reason"] == "nonfinite_logits"}
    assert {r: t for r, t in got.tokens.items() if r not in poisoned} == {
        r: t for r, t in want.tokens.items() if r not in poisoned}
    # every demotion and probe is loud
    for reason, text in (("decode_demotion", "serve watchdog"),
                         ("probe_failed", "re-promotion probe"),
                         ("decode_repromotion", "re-promoted")):
        n = sum(f["reason"] == reason for f in got.failures)
        assert sum(text in w for w in got.warnings) == n
    ladder = sum("compile ladder" in w for w in got.warnings)
    assert ladder == RZ.FaultPlan.from_json(
        {"faults": faults}).expected_count("compile:")

    # the counters chip_smoke.py holds the card to, by the same rule
    progs = TL.pipeline_kernels(
        tcfg, prefill_lens=ENGINE["prompt_buckets"],
        decode_batch=ENGINE["max_batch"], max_len=ENGINE["max_len"],
        device="cpu")
    rungs = sorted(k.rung for k in progs.values())
    card_run = {"card_chaos": "chaos", "deadline": "deadline"}.get(case)
    if card_run is not None:
        from repro_torch.core import cuda_build
        have = dict(vars(got), torch_programs=rungs.count("torch"),
                    ungrouped_programs=rungs.count("ungrouped"),
                    nvcc_builds=cuda_build.STATS["builds"])
        expect = CS.resilience_expected(card_run, len(progs))
        assert {k: have[k] for k in expect} == expect
    if case in ("chaos", "card_chaos"):
        qdir = Path(TP.default_cache().root) / "quarantine"
        assert len(list(qdir.iterdir())) == got.quarantined
        assert len(poisoned) == 1
        landed = "torch" if case == "chaos" else "ungrouped"
        assert rungs == sorted(["grouped"] * 7 + [landed])
        assert progs["attention_prefill8"].rung == landed
    if case == "heal":
        assert [f["reason"] for f in got.failures] == [
            "decode_demotion", "probe_failed", "decode_repromotion"]
        assert got.decode_backend == "pipeline-cuda"
        assert not list((Path(TP.default_cache().root) / "health").glob(
            "*.json"))
    if case == "deadline":
        reasons = [f["reason"] for f in got.failures]
        assert {k: reasons.count(k) for k in CS.DEADLINE_RECORDS} == \
            CS.DEADLINE_RECORDS
        assert len(reasons) == sum(CS.DEADLINE_RECORDS.values())


def _tiny(backend="cuda"):
    mc = TC.get_reduced_config("smollm-135m", n_layers=2, d_model=64,
                               n_heads=2, n_kv_heads=2, d_head=32, d_ff=128,
                               vocab=128)
    return TC.with_pipeline(mc, options=TP.CompileOptions(backend=backend))


def test_probe_on_a_nan_writing_rung_leaves_live_sequences_alone(
        monkeypatch):
    """The probe's rung writes NaN over the whole KV cache it is given
    and returns NaN logits.  The probe fails, and the tokens of every
    request equal those of a run with re-promotion off (no probe at
    all), bit for bit: the probe decoded on a copy of the cache."""
    from repro_torch import models
    trace = TE.synth_trace(4, seed=2, arrival_rate=1.0, prompt_lens=(2, 7),
                           gen_lens=(6, 8), vocab=128)
    faults = [{"site": "serve:decode", "indices": [1], "kind": "raise"}]

    def serve(repromote_after):
        _new_process()
        eng = TE.Engine(_tiny(), device="cpu", max_batch=2, max_len=48,
                        prompt_buckets=(8,), seed=0,
                        repromote_after=repromote_after)
        with RZ.faults(RZ.FaultPlan.from_json({"faults": faults})), \
                warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return eng.run(trace)

    no_probe = serve(None)
    real = models.build_model

    class NanWriting:
        def __init__(self, cfg):
            self.cfg, self.inner = cfg, real(cfg)

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def decode_step(self, params, caches, tokens, pos):
            logits, _ = self.inner.decode_step(params, caches, tokens, pos)
            for t in caches.values():
                t.fill_(float("nan"))
            return torch.full_like(logits, float("nan")), caches

    built = []

    def build_model(cfg):
        # the engine's own model first, then a cuda model only the probe
        # builds (the watchdog builds the torch rung's)
        built.append(cfg.pipeline_backend)
        return (NanWriting(cfg) if len(built) > 1
                and cfg.pipeline_backend == "cuda" else real(cfg))

    monkeypatch.setattr(models, "build_model", build_model)
    probed = serve(2)
    assert built[:3] == ["cuda", "torch", "cuda"]
    assert probed.probes >= 1 and probed.probe_failures == probed.probes
    assert probed.repromotions == 0 and probed.n_poisoned == 0
    assert all("non-finite" in f["error"] for f in probed.failures
               if f["reason"] == "probe_failed")
    assert probed.tokens == no_probe.tokens
    assert probed.n_completed == no_probe.n_completed == len(trace)


def test_open_breaker_is_adopted_by_the_next_engine():
    """One engine's decode crash opens the cuda rung's breaker in the
    cache directory's health ledger; the next engine on that directory
    starts demoted (warned), then probes and re-promotes, and its tokens
    equal a clean engine's."""
    trace = TE.synth_trace(4, seed=1, arrival_rate=1.0, prompt_lens=(2, 7),
                           gen_lens=(4, 6), vocab=128)
    first = TE.Engine(_tiny(), device="cpu", max_batch=2, max_len=32,
                      prompt_buckets=(8,), seed=0, repromote_after=64)
    plan = RZ.FaultPlan([RZ.FaultSpec(site="serve:decode", indices=(1,))])
    with RZ.faults(plan), pytest.warns(RuntimeWarning,
                                       match="serve watchdog"):
        crashed = first.run(trace)
    assert crashed.decode_backend == "pipeline-torch"
    hdir = Path(TP.default_cache().root) / "health"
    assert len(list(hdir.glob("*.json"))) == 1

    _new_process()
    with pytest.warns(RuntimeWarning, match="starting demoted"):
        second = TE.Engine(_tiny(), device="cpu", max_batch=2, max_len=32,
                           prompt_buckets=(8,), seed=0, repromote_after=2)
    assert second.cfg.pipeline_backend == "torch"
    with pytest.warns(RuntimeWarning, match="re-promoted"):
        healed = second.run(trace)
    assert (healed.repromotions, healed.degradations) == (1, 0)
    assert healed.decode_backend == "pipeline-cuda"
    assert not list(hdir.glob("*.json"))  # the breaker closed

    _new_process()
    clean = TE.Engine(_tiny(), device="cpu", max_batch=2, max_len=32,
                      prompt_buckets=(8,), seed=0).run(trace)
    assert healed.tokens == clean.tokens == crashed.tokens
