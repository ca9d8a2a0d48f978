"""The port's compile driver against the reference's: ``CompileOptions``,
analytic selection (``dims`` and ``dim_candidates``), measured autotune,
the unfused baselines and per-kernel timing, on CPU tensors.

* equal options hash and key equal, ``cache_opts`` makes the reference's
  decisions (its ``torch`` backend for the reference's ``jax``, ``cuda``
  for ``pallas``, less the ``interpret`` flag);
* the same program, dims or candidates and options select the same
  snapshot and dims, and lower to the same ``LoweringReport``: the SwiGLU
  and GQA attention programs at smollm-135m's and llama3.2-1b's full
  widths (costing and emission only), all five in-repo programs small;
* under one deterministic fake ``measure`` the measured autotune picks
  the reference's winner; through the driver's own harness the winner is
  never slower than the analytic winner, a candidate that cannot emit is
  skipped and counted, and a disk hit re-loads the winner unmeasured;
* ``fused=False`` (regions grouped or not) and ``jit="per-op"`` equal the
  reference interpreter on the original program within 1e-5, and the
  unfused programs emit at the serving widths;
* ``timing.region_times`` pairs kernel times with kernel costs by id.

Every compile here runs on its own cache directory (``tmp_path``)."""

import warnings
from math import lcm

import numpy as np
import pytest
import torch

from repro import configs as JC
from repro import pipeline as JP
from repro.core import array_program as JAP
from repro.core import calibrate as JCAL
from repro.core import selection as JSEL
from repro.core.interpreter import run as j_run
from repro.pipeline import packing as JPK
from repro_torch import configs as TC
from repro_torch import pipeline as TP
from repro_torch.core import array_program as TAP
from repro_torch.core import calibrate as TCAL
from repro_torch.core import codegen_cuda as CC
from repro_torch.core import selection as TSEL
from repro_torch.core import timing as T
from repro_torch.core.fusion import fuse
from repro_torch.models.layers import _pipeline_dims_blocks
from test_torch_cuda import PROGRAMS, merged_inputs  # noqa: E402
import torch_port  # noqa: F401

# the reference's measured-autotune grids (tests/test_measured_autotune.py)
CANDIDATES = {
    "layernorm_matmul": {"M": [1, 2], "K": [2, 4], "N": [1, 2]},
    "rmsnorm_swiglu": {"M": [1, 2], "D": [2], "K": [2, 3], "N": [2]},
    "flash": {"M": [1, 2], "D": [2], "N": [2, 3], "L": [2]},
    "causal": {"M": [2], "D": [2], "N": [2], "L": [1, 2]},
    "gqa": {"H": [2], "M": [1, 2], "D": [2], "N": [2], "L": [2]},
}


@pytest.fixture(autouse=True)
def _fresh_measurements():
    T.clear_measurements()
    yield
    T.clear_measurements()


def _ln():
    return TAP.layernorm_matmul_program(32.0)


LN_DIMS = {"M": 2, "K": 4, "N": 2}


# ---------------------------------------------------------------------------
# CompileOptions (the reference's tests/test_compile_options.py)
# ---------------------------------------------------------------------------

def test_hash_equality_dict_order_insensitive():
    a = TP.CompileOptions(backend="cuda", blocks={"M": 8, "N": 4},
                          item_bytes={"x": 4, "y": 2})
    b = TP.CompileOptions(backend="cuda", blocks={"N": 4, "M": 8},
                          item_bytes={"y": 2, "x": 4})
    assert a == b and hash(a) == hash(b)
    assert a.blocks_dict == {"M": 8, "N": 4}
    assert a != a.replace(group=False)
    assert {a: 1}[b] == 1


def test_default_options_keep_their_identity():
    """The defaults equal and hash as the fields the port always had
    (backend and blocks): a config's options, the layers' lru_caches and
    the engine's pins see no new distinction."""
    assert TP.CompileOptions() == TP.DEFAULT_OPTIONS
    assert TP.CompileOptions(backend="torch") == TP.DEFAULT_OPTIONS
    cuda = TP.CompileOptions(backend="cuda")
    assert cuda.replace(blocks={"M": 2}) == TP.CompileOptions(
        backend="cuda", blocks=(("M", 2),))
    assert hash(cuda.replace(blocks={"M": 2})) == hash(
        TP.CompileOptions(backend="cuda", blocks={"M": 2}))


def test_kwargs_shim_aliases_options_form():
    cache = TP.KernelCache(disk=False)
    k1 = TP.compile(_ln(), LN_DIMS, backend="py", cache=cache)
    k2 = TP.compile(_ln(), LN_DIMS, options=TP.CompileOptions(backend="py"),
                    cache=cache)
    assert k1.key == k2.key and k2.cache_hit == "memory"


def test_default_options_alias():
    cache = TP.KernelCache(disk=False)
    k1 = TP.compile(_ln(), LN_DIMS, cache=cache)
    k2 = TP.compile(_ln(), LN_DIMS, options=TP.DEFAULT_OPTIONS, cache=cache)
    assert k2.cache_hit == "memory" and k1.key == k2.key


def test_both_forms_is_type_error():
    with pytest.raises(TypeError, match="not both"):
        TP.compile(_ln(), LN_DIMS, options=TP.CompileOptions(),
                   backend="py", cache=TP.KernelCache(disk=False))


def test_unknown_kwarg_is_type_error():
    with pytest.raises(TypeError, match="unexpected keyword"):
        TP.compile(_ln(), LN_DIMS, bogus_flag=True,
                   cache=TP.KernelCache(disk=False))


def test_unequal_options_never_alias():
    cache = TP.KernelCache(disk=False)
    k1 = TP.compile(_ln(), LN_DIMS, cache=cache)
    k2 = TP.compile(_ln(), LN_DIMS, options=TP.CompileOptions(jit="per-op"),
                    cache=cache)
    assert k1.key != k2.key and k2.cache_hit is None


def _profiles(cal):
    custom = cal.CalibrationProfile({"block": 2.0, "vector": 1.0,
                                     "scalar": 0.5}, 3.0)
    return {"none": None, "default": cal.DEFAULT_PROFILE, "custom": custom}


@pytest.mark.parametrize("profile", ["none", "default", "custom"])
@pytest.mark.parametrize("extra", [
    {}, {"group": False}, {"jit": False}, {"jit": "per-op"},
    {"item_bytes": {"block": 4}}, {"autotune": "measured"}])
@pytest.mark.parametrize("backend", [("torch", "jax"), ("cuda", "pallas"),
                                     ("py", "py")])
def test_cache_opts_make_the_references_decisions(backend, extra, profile):
    port_be, ref_be = backend
    for stabilized in (False, True):
        for autotuned in (False, True):
            budget = 1 << 23 if port_be == "cuda" else None
            port = TP.CompileOptions(backend=port_be, **extra).cache_opts(
                stabilized=stabilized, autotuned=autotuned,
                profile=_profiles(TCAL)[profile], vmem_budget=budget)
            ref = JP.CompileOptions(
                backend=ref_be, interpret=True if ref_be == "pallas"
                else None, **extra).cache_opts(
                stabilized=stabilized, autotuned=autotuned,
                profile=_profiles(JCAL)[profile], vmem_budget=budget)
            assert port == tuple(o for o in ref if o[0] != "interpret")


def test_with_pipeline_threads_options():
    o = TP.CompileOptions(backend="cuda", group=False)
    cfg = TC.with_pipeline(TC.get_reduced_config("smollm-135m"), options=o)
    assert cfg.pipeline_options == o and cfg.pipeline_backend == "cuda"
    assert cfg.attn_impl == "pipeline" and cfg.mlp_impl == "pipeline"
    hash(cfg)
    ref = JC.with_pipeline(JC.get_reduced_config("smollm-135m"),
                           options=JP.CompileOptions(backend="pallas"))
    assert ref.pipeline_backend == "pallas"


def test_layers_resolve_options_as_the_reference():
    from repro_torch.models import layers as L
    cfg = TC.get_reduced_config("smollm-135m")
    assert L._pipeline_options(cfg) == TP.CompileOptions(backend="torch")
    assert L._pipeline_options("cuda") == TP.CompileOptions(backend="cuda")
    o = TP.CompileOptions(backend="cuda", group=False)
    assert L._pipeline_options(o) is o
    assert L._pipeline_options(TC.with_pipeline(cfg, options=o)) is o


def test_stats_helpers():
    s = TP.CacheStats(memory_hits=3, disk_hits=1, misses=2)
    assert s.compiles == 3 and abs(s.hit_rate - 4 / 6) < 1e-9
    snap = s.snapshot()
    s.misses += 5
    d = s.delta(snap)
    assert d.misses == 5 and d.compiles == 5 and d.memory_hits == 0


# ---------------------------------------------------------------------------
# Analytic selection against the reference
# ---------------------------------------------------------------------------

def _full(arch, prog):
    """(program maker, serving dims, blocks, candidates, base blocks) of one
    serving program at an architecture's full width."""
    cfg = TC.get_config(arch)
    if prog == "swiglu":
        d = cfg.d_model
        sizes = {"M": 4, "D": d, "K": cfg.d_ff, "N": d}
        build = (lambda A: A.rmsnorm_ffn_swiglu_program(
            float(d), eps=float(cfg.norm_eps)))
    else:
        sizes = {"M": 1, "D": cfg.d_head, "N": 96, "L": cfg.d_head}
        build = (lambda A: A.gqa_attention_program(
            1.0 / cfg.d_head ** 0.5, causal=True))
    dims, blocks = _pipeline_dims_blocks(sizes)
    cands = {k: sorted({n, max(1, n // 2)}) for k, n in dims.items()}
    base = {k: sizes[k] // lcm(*cands[k]) for k in sizes}
    if prog != "swiglu":
        dims["H"] = cands["H"] = cfg.n_heads // cfg.n_kv_heads
        cands["H"], blocks["H"], base["H"] = [dims["H"]], 1, 1
    return build, dims, blocks, cands, base


def _same(port, ref):
    assert port.snapshot_index == ref.snapshot_index
    assert port.dims == ref.dims
    assert port.cost == pytest.approx(ref.cost, rel=1e-12)
    assert port.lowering_report.summary() == ref.lowering_report.summary()


@pytest.mark.parametrize("arch", ["smollm-135m", "llama3.2-1b"])
@pytest.mark.parametrize("prog", ["swiglu", "gqa"])
def test_full_width_selection_matches_reference(arch, prog, tmp_path):
    """Costing and emission only: nothing runs at these widths."""
    build, dims, blocks, cands, base = _full(arch, prog)
    jc, tc = JP.KernelCache(tmp_path / "ref"), TP.KernelCache(tmp_path)
    _same(TP.compile(build(TAP), dims, options=TP.CompileOptions(
              backend="cuda", blocks=blocks), cache=tc),
          JP.compile(build(JAP), dims, options=JP.CompileOptions(
              backend="pallas", blocks=blocks), cache=jc))
    _same(TP.compile(build(TAP), dim_candidates=cands,
                     options=TP.CompileOptions(backend="cuda", blocks=base),
                     cache=tc),
          JP.compile(build(JAP), dim_candidates=cands,
                     options=JP.CompileOptions(backend="pallas",
                                               blocks=base), cache=jc))


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_small_selection_matches_reference(name, tmp_path):
    build, dims, blocks = PROGRAMS[name]
    jc, tc = JP.KernelCache(tmp_path / "ref"), TP.KernelCache(tmp_path)
    for extra in ({}, {"group": False}, {"fused": False}):
        _same(TP.compile(build(TAP), dims, options=TP.CompileOptions(
                  backend="cuda", blocks=blocks, **extra), cache=tc),
              JP.compile(build(JAP), dims, options=JP.CompileOptions(
                  backend="pallas", blocks=blocks, **extra), cache=jc))
        _same(TP.compile(build(TAP), dim_candidates=CANDIDATES[name],
                         options=TP.CompileOptions(backend="cuda",
                                                   blocks=blocks, **extra),
                         cache=tc),
              JP.compile(build(JAP), dim_candidates=CANDIDATES[name],
                         options=JP.CompileOptions(backend="pallas",
                                                   blocks=blocks, **extra),
                         cache=jc))


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_measured_selection_picks_the_references_winner(name):
    """One deterministic fake ``measure`` (anti-correlated with the
    analytic cost, a tie broken by the dims): the port's and the
    reference's ``autotune`` time the same finalists and pick the same
    winner."""
    build, _, _ = PROGRAMS[name]

    def fake(sel):
        return 1.0 / sel.cost + 1e-9 * sum(sel.dims.values())

    port = TSEL.autotune(build(TAP), CANDIDATES[name], objective="measured",
                         measure=fake, top_k=3)
    ref = JSEL.autotune(build(JAP), CANDIDATES[name], objective="measured",
                        measure=fake, top_k=3)
    assert port.dims == ref.dims and port.snapshot_index == ref.snapshot_index
    assert port.measured_s == ref.measured_s
    assert port.timings == ref.timings


# ---------------------------------------------------------------------------
# Measured autotune through the driver (tests/test_measured_autotune.py)
# ---------------------------------------------------------------------------

def test_sweep_dedupes_equivalent_assignments():
    got = list(TSEL.sweep_assignments({"M": [2, 2, 2], "K": [4, 4],
                                       "N": [1, 2, 1]}))
    assert got == [{"M": 2, "K": 4, "N": 1}, {"M": 2, "K": 4, "N": 2}]


def test_measured_duplicate_assignments_timed_once():
    calls = []

    def measure(sel):
        calls.append(dict(sel.dims))
        return 1e-3

    TSEL.autotune(_ln(), {"M": [2, 2], "K": [4, 4], "N": [2]},
                  objective="measured", measure=measure, top_k=8)
    assert calls == [{"M": 2, "K": 4, "N": 2}]


def test_measured_failures_fall_back_to_analytic():
    def broken(sel):
        raise RuntimeError("no device")

    with pytest.warns(RuntimeWarning, match="every measurement failed"):
        best = TSEL.autotune(_ln(), {"M": [1, 2], "K": [2], "N": [2]},
                             objective="measured", measure=broken, top_k=2)
    analytic = TSEL.autotune(_ln(), {"M": [1, 2], "K": [2], "N": [2]})
    assert best.dims == analytic.dims and best.measured_s is None


def test_measured_objective_validation():
    with pytest.raises(ValueError, match="objective"):
        TSEL.autotune(_ln(), {"M": [1]}, objective="psychic")
    with pytest.raises(ValueError, match="measure callback"):
        TSEL.autotune(_ln(), {"M": [1]}, objective="measured")
    with pytest.raises(ValueError, match="dim_candidates"):
        TP.compile(_ln(), LN_DIMS, autotune="measured",
                   cache=TP.KernelCache(disk=False))


def test_measurement_memo():
    calls = []

    def thunk():
        calls.append(1)
        return 1.5

    key = ("fp", (("M", 2),), "torch", "cpu")
    assert T.measured(key, thunk) == 1.5
    assert T.measured(key, thunk) == 1.5
    assert len(calls) == 1 and T.measurement_count() == 1


def test_pipeline_measured_autotune_torch(tmp_path):
    cands = {"M": [1, 2], "K": [2, 4], "N": [1, 2]}
    opts = TP.CompileOptions(autotune="measured", top_k=2,
                             measure_repeats=2)
    kern = TP.compile(_ln(), dim_candidates=cands, options=opts,
                      cache=TP.KernelCache(tmp_path), device="cpu")
    assert kern.cache_hit is None and kern.measured_s > 0
    assert all(kern.dims[d] in cands[d] for d in cands)
    assert len(kern.autotune_timings) <= 2
    assert kern.measured_s == min(t for _, t in kern.autotune_timings)
    assert set(kern(T.synth_inputs(_ln(), kern.dims))) == {"Z"}
    ka = TP.compile(_ln(), dim_candidates=cands,
                    cache=TP.KernelCache(tmp_path))
    assert ka.key != kern.key
    n = T.measurement_count()
    k2 = TP.compile(_ln(), dim_candidates=cands, options=opts,
                    cache=TP.KernelCache(tmp_path), device="cpu")
    assert k2.cache_hit == "disk" and T.measurement_count() == n
    assert k2.dims == kern.dims and k2.measured_s == kern.measured_s


def test_pipeline_measured_autotune_cuda_backend(tmp_path):
    """The cuda backend on CPU tensors (its kernels' plain versions): the
    finalists share one total problem, and the winner lowers at the
    caller's blocks, as the reference's does, a disk hit too."""
    g = TAP.rmsnorm_ffn_swiglu_program(16.0)
    cands = {"M": [1, 2], "D": [2], "K": [2, 3], "N": [2]}
    base = {"M": 4, "D": 8, "K": 4, "N": 4}
    opts = TP.CompileOptions(backend="cuda", blocks=base,
                             autotune="measured", top_k=3)
    kern = TP.compile(g, dim_candidates=cands, options=opts,
                      cache=TP.KernelCache(tmp_path), device="cpu")
    rep = kern.autotune_report
    assert len(rep) == 3 and all(r["skipped"] is None for r in rep)
    for r in rep:
        assert {d: r["blocks"][d] * r["dims"][d] for d in base} == {
            d: base[d] * lcm(*cands[d]) for d in base}
    assert kern.dims in [r["dims"] for r in rep] and kern.blocks == base
    assert [r["dims"] for r in rep] == [
        c["dims"] for c in TP.autotune_candidates(
            g, cands, options=opts, cache=TP.KernelCache(tmp_path),
            device="cpu")]
    feed = T.synth_inputs(g, kern.dims, kern.blocks)
    want = TP.compile(g, kern.dims, options=TP.CompileOptions(
        backend="torch"), cache=TP.KernelCache(disk=False))(feed)["O"]
    torch.testing.assert_close(kern(feed)["O"], want, rtol=1e-5, atol=1e-5)
    again = TP.compile(g, dim_candidates=cands, options=opts,
                       cache=TP.KernelCache(tmp_path), device="cpu")
    assert again.cache_hit == "disk" and again.blocks == kern.blocks
    assert again.lowering_report.summary() == kern.lowering_report.summary()


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_objectives_lower_the_winner_at_one_problem_size(backend, tmp_path):
    """The objective picks the winner and nothing else: with one finalist
    both objectives pick the same dims, and the kernels take inputs of one
    shape (``blocks × dims``) and return the same outputs."""
    g = TAP.rmsnorm_ffn_swiglu_program(16.0)
    cands = {"M": [1, 2], "D": [2], "K": [2, 3], "N": [2]}
    base = {"M": 4, "D": 8, "K": 4, "N": 4}
    opts = TP.CompileOptions(backend=backend, blocks=base)
    kerns = [TP.compile(g, dim_candidates=cands, options=o,
                        cache=TP.KernelCache(tmp_path / o.autotune),
                        device="cpu")
             for o in (opts, opts.replace(autotune="measured", top_k=1))]
    assert kerns[0].dims == kerns[1].dims
    assert kerns[0].blocks == kerns[1].blocks
    feed = T.synth_inputs(g, kerns[0].dims, base)
    outs = [k(feed)["O"] for k in kerns]
    assert outs[0].shape == outs[1].shape == (
        base["M"] * kerns[0].dims["M"], base["N"] * kerns[0].dims["N"])
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_measured_key_names_the_device_it_timed_on(tmp_path, monkeypatch):
    """A sweep timed on the CPU never serves a compile that asks for the
    card's, from memory or from disk: the measuring device is keyed."""
    cands = {"M": [1, 2], "K": [2], "N": [2]}
    opts = TP.CompileOptions(autotune="measured", top_k=2)
    cache = TP.KernelCache(tmp_path)
    cpu = TP.compile(_ln(), dim_candidates=cands, options=opts, cache=cache,
                     device="cpu")
    assert ("measure_device", T.device_kind("cpu")) in cpu.key.opts
    monkeypatch.setattr(T, "device_kind", lambda dev: "NVIDIA H100 80GB")
    for c in (cache, TP.KernelCache(tmp_path)):
        card = TP.compile(_ln(), dim_candidates=cands, options=opts,
                          cache=c, device="cpu")
        assert card.key != cpu.key
        assert ("measure_device", "NVIDIA H100 80GB") in card.key.opts
    assert card.cache_hit == "disk"     # the card's own entry, from disk
    analytic = TP.compile(_ln(), dim_candidates=cands, cache=cache)
    assert not any(k == "measure_device" for k, _ in analytic.key.opts)


def test_candidate_past_shared_memory_is_skipped_and_counted(tmp_path):
    """A finalist whose one region needs more shared memory than an H100
    block has cannot emit: the sweep skips it with a warning and counts
    it, and a finalist that emits wins; nothing runs a plain version in
    its place."""
    g = TAP.layernorm_matmul_program(32.0)
    cands = {"M": [1, 8], "K": [1, 4], "N": [1, 2]}
    opts = TP.CompileOptions(backend="cuda",
                             blocks={"M": 32, "K": 64, "N": 64},
                             autotune="measured", top_k=8)
    skips = TP.STATS["measure_skips"]
    with pytest.warns(RuntimeWarning, match="skipping"):
        kern = TP.compile(g, dim_candidates=cands, options=opts,
                          cache=TP.KernelCache(tmp_path), device="cpu")
    skipped = [r for r in kern.autotune_report if r["skipped"]]
    assert skipped and all("shared memory" in r["skipped"]
                           for r in skipped)
    assert TP.STATS["measure_skips"] - skips == len(skipped)
    assert kern.measured_s is not None
    assert all(k.smem_bytes <= CC.SMEM_LIMIT for k in kern.kernels)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_measured_choice_never_slower_than_analytic(name, tmp_path):
    build, _, blocks = PROGRAMS[name]
    opts = TP.CompileOptions(backend="cuda", blocks=blocks,
                             autotune="measured", top_k=3,
                             measure_repeats=2)
    kern = TP.compile(build(TAP), dim_candidates=CANDIDATES[name],
                      options=opts, cache=TP.KernelCache(tmp_path),
                      device="cpu")
    # finalists are timed in analytic order: the first is the analytic
    # winner, the one an analytic compile picks
    analytic = kern.autotune_report[0]["dims"]
    assert analytic == TP.compile(
        build(TAP), dim_candidates=CANDIDATES[name],
        options=opts.replace(autotune="analytic"),
        cache=TP.KernelCache(tmp_path)).dims
    times = dict(kern.autotune_timings)
    akey = tuple(sorted(analytic.items()))
    assert akey in times and kern.measured_s <= times[akey]


def test_measured_loads_the_saved_profile(tmp_path):
    """Under ``autotune="measured"`` the driver loads the profile saved
    for the backend and device under the cache root, and keys by it."""
    cands = {"M": [1, 2], "K": [2], "N": [2]}
    opts = TP.CompileOptions(autotune="measured", top_k=1)
    k1 = TP.compile(_ln(), dim_candidates=cands, options=opts,
                    cache=TP.KernelCache(tmp_path), device="cpu")
    prof = TCAL.CalibrationProfile({"block": 1.0, "vector": 1.0,
                                    "scalar": 1.0}, 2.0, backend="torch",
                                   device_kind=T.device_kind("cpu"))
    TCAL.save_profile(prof, tmp_path)
    k2 = TP.compile(_ln(), dim_candidates=cands, options=opts,
                    cache=TP.KernelCache(tmp_path), device="cpu")
    assert ("profile", prof.digest()) in k2.key.opts
    assert k1.key != k2.key and k2.cache_hit is None


@pytest.mark.parametrize("where", ["options", "saved"])
def test_finalists_follow_the_profile_the_sweep_runs_under(where, tmp_path):
    """``autotune_candidates`` names the finalists the measured sweep
    times, in its order, under a profile that reorders them: passed in
    the options, or saved under the cache root for the device."""
    g = TAP.rmsnorm_ffn_swiglu_program(16.0)
    cands = {"M": [1, 2], "D": [1, 2], "K": [1, 2, 4], "N": [1, 2]}
    opts = TP.CompileOptions(backend="cuda",
                             blocks={"M": 4, "D": 4, "K": 4, "N": 4},
                             autotune="measured", top_k=3)
    cache = TP.KernelCache(tmp_path)
    default = [c["dims"] for c in TP.autotune_candidates(
        g, cands, options=opts, cache=cache, device="cpu")]
    # vector items and launches only: the third finalist changes
    prof = TCAL.CalibrationProfile(
        {"block": 0.0, "vector": 1e-5, "scalar": 0.0}, 20.0,
        backend="cuda", device_kind=T.device_kind("cpu"),
        work_coef={"matmul": 0.0, "elementwise": 0.0, "reduce": 0.0},
        instance_coef=1e-3)
    if where == "options":
        opts = opts.replace(profile=prof)
    else:
        TCAL.save_profile(prof, tmp_path)
    named = [c["dims"] for c in TP.autotune_candidates(
        g, cands, options=opts, cache=cache, device="cpu")]
    assert named != default
    kern = TP.compile(g, dim_candidates=cands, options=opts, cache=cache,
                      device="cpu")
    assert [r["dims"] for r in kern.autotune_report] == named


# ---------------------------------------------------------------------------
# The unfused baselines
# ---------------------------------------------------------------------------

def _oracle(name):
    build, dims, blocks = PROGRAMS[name]
    g, jg = build(TAP), build(JAP)
    inputs = merged_inputs(g, dims, blocks)
    nested = {jg.nodes[i].name: JPK.to_nested(inputs[jg.nodes[i].name],
                                              jg.nodes[i].vtype, dims)
              for i in jg.input_ids}
    outs = j_run(jg, nested, dims)
    want = {jg.nodes[o].name: JPK.from_nested(outs[jg.nodes[o].name], vt,
                                              dims)
            for o, vt in zip(jg.output_ids, JPK.output_types(jg))}
    return g, dims, blocks, inputs, want


@pytest.mark.parametrize("opts", [
    dict(backend="torch", jit="per-op"),
    dict(backend="torch", jit="per-op", fused=False),
    dict(backend="torch", fused=False),
    dict(backend="cuda", fused=False),
    dict(backend="cuda", fused=False, group=False)],
    ids=["torch-per-op", "torch-per-op-unfused", "torch-unfused",
         "cuda-unfused", "cuda-unfused-per-region"])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_unfused_baselines_equal_the_interpreter(name, opts, tmp_path):
    g, dims, blocks, inputs, want = _oracle(name)
    o = TP.CompileOptions(blocks=blocks if opts["backend"] == "cuda"
                          else None, **opts)
    kern = TP.compile(g, dims, options=o, cache=TP.KernelCache(tmp_path))
    if not o.fused:
        assert kern.graph.fingerprint() == g.fingerprint() or kern.stabilized
        assert kern.predicted_traffic_reduction == pytest.approx(1.0)
    if o.backend == "cuda" and not o.group:
        assert kern.launches == kern.lowering_report.n_regions
    got = kern({n: torch.from_numpy(v) for n, v in inputs.items()})
    for n, w in want.items():
        np.testing.assert_allclose(got[n].numpy(), w, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["smollm-135m", "llama3.2-1b"])
@pytest.mark.parametrize("prog", ["swiglu_decode", "swiglu_prefill8",
                                  "swiglu_prefill32", "attention_decode",
                                  "attention_prefill8",
                                  "attention_prefill32"])
def test_served_programs_emit_every_planned_group(arch, prog, tmp_path):
    """The serving path's fused programs at full width (the shapes of the
    serve CLI's defaults) emit one kernel for each planned group: the
    emitter's per-region fallback is for the unfused baseline, and a
    serving group that needed it would be a fault."""
    cfg = TC.get_config(arch)
    t = 4 if prog.endswith("decode") else int(prog.rsplit("prefill")[-1])
    if prog.startswith("swiglu"):
        g = TAP.rmsnorm_ffn_swiglu_program(float(cfg.d_model),
                                           eps=float(cfg.norm_eps))
        sizes = {"M": t, "D": cfg.d_model, "K": cfg.d_ff, "N": cfg.d_model}
    else:
        g = TAP.gqa_attention_program(1.0 / cfg.d_head ** 0.5, causal=True)
        s = 1 if prog.endswith("decode") else t
        sizes = {"M": s, "D": cfg.d_head, "N": 96 if s == 1 else s,
                 "L": cfg.d_head}
    dims, blocks = _pipeline_dims_blocks(sizes)
    if prog.startswith("attention"):
        dims["H"], blocks["H"] = cfg.n_heads // cfg.n_kv_heads, 1
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        kern = TP.compile(g, dims, options=TP.CompileOptions(
            backend="cuda", blocks=blocks), cache=TP.KernelCache(tmp_path))
    assert kern.lowering_report.degraded == []
    assert all("." not in gid for gid in kern.kernel_ids)
    assert all(k.smem_bytes <= CC.SMEM_LIMIT for k in kern.kernels)


@pytest.mark.parametrize("arch", ["smollm-135m", "llama3.2-1b"])
@pytest.mark.parametrize("prog", ["swiglu", "gqa"])
@pytest.mark.parametrize("group", [True, False], ids=["grouped",
                                                      "per-region"])
def test_unfused_programs_emit_at_serving_widths(arch, prog, group,
                                                 tmp_path):
    """Every unfused serving program emits at its full width within the
    H100's shared memory; a group past it becomes per-region kernels,
    and the driver's per-kernel costs follow what was emitted."""
    build, dims, blocks, _, _ = _full(arch, prog)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        kern = TP.compile(build(TAP), dims, options=TP.CompileOptions(
            backend="cuda", blocks=blocks, fused=False, group=group),
            cache=TP.KernelCache(tmp_path))
    assert all(k.smem_bytes <= CC.SMEM_LIMIT for k in kern.kernels)
    assert len(kern.kernel_ids) == len(kern.region_costs) == kern.launches
    assert kern.kernel_ids == tuple(
        kr.gid for kr, _ in kern._fn.raw_program.region_runners)


def test_group_past_shared_memory_becomes_per_region_kernels(tmp_path):
    """The unfused SwiGLU program at smollm-135m's width and 32 tokens:
    its first group needs 1.45 MB of shared memory, so it is emitted as
    one kernel a member region (ids ``<gid>.<node>``), the plan is
    reconciled with what was emitted, and the outputs are unchanged."""
    dims, blocks = _pipeline_dims_blocks({"M": 32, "D": 576, "K": 1536,
                                          "N": 576})
    g = TAP.rmsnorm_ffn_swiglu_program(576.0, eps=1e-5)
    with pytest.warns(RuntimeWarning, match="fell back to per-region"):
        kern = TP.compile(g, dims, options=TP.CompileOptions(
            backend="cuda", blocks=blocks, fused=False),
            cache=TP.KernelCache(tmp_path))
    assert any("." in gid for gid in kern.kernel_ids)
    assert [d.split(":")[:2] for d in kern.lowering_report.degraded] == [
        ["g0", "4+5+6+7+14+15+9"]]
    assert kern.launches == 9 and len(kern.region_costs) == 9
    again = TP.compile(g, dims, options=TP.CompileOptions(
        backend="cuda", blocks=blocks, fused=False),
        cache=TP.KernelCache(tmp_path))
    assert again.cache_hit == "disk" and again.kernel_ids == kern.kernel_ids


# ---------------------------------------------------------------------------
# Per-kernel timing
# ---------------------------------------------------------------------------

def test_region_times_pair_with_region_costs(tmp_path):
    build, dims, blocks = PROGRAMS["rmsnorm_swiglu"]
    g = build(TAP)
    kern = TP.compile(g, dims, options=TP.CompileOptions(
        backend="cuda", blocks=blocks), cache=TP.KernelCache(tmp_path))
    rts = T.region_times(kern, T.synth_inputs(g, dims, blocks), repeats=2)
    assert len(rts) == len(kern.region_costs) == kern.launches
    assert all(r.median_s > 0 and r.gid for r in rts)
    paired = T.pair_region_times(kern, rts)
    assert [gid for gid, _, _ in paired] == list(kern.kernel_ids)
    assert sorted(paired) == sorted(T.pair_region_times(kern, rts[::-1]))
    stages = T.stage_time_attribution(kern, rts)
    assert len(stages) == kern.lowering_report.n_regions
    for t in rts:
        assert sum(s for gid, _, s in stages if gid == t.gid) == \
            pytest.approx(t.median_s)
    feats = TCAL.group_features(kern.graph, kern.dims, kern.blocks)
    assert [gid for gid, _, _ in T.pair_region_features(rts, feats)] == \
        list(kern.kernel_ids)
    kt = TP.compile(g, dims, cache=TP.KernelCache(tmp_path))
    assert T.region_times(kt, T.synth_inputs(g, dims)) is None


def test_synth_inputs_are_seeded_and_positional():
    g = TAP.gqa_attention_program(0.25, causal=True)
    dims, blocks = PROGRAMS["gqa"][1:]
    a = T.synth_inputs(g, dims, blocks, generator=torch.Generator()
                       .manual_seed(3))
    b = T.synth_inputs(g, dims, blocks, seed=3)
    for n in a:
        assert torch.equal(a[n], b[n]) and a[n].dtype == torch.float32
    assert torch.equal(a["QP"], torch.arange(a["QP"].shape[0],
                                             dtype=torch.float32))
    assert T.stack_dims(g) == frozenset({"H"})
    assert T.synth_blocks(g, dims)["H"] == 1


def test_spearman_matches_reference():
    from repro.core import timing as JT
    rng = np.random.default_rng(0)
    for n in (1, 2, 5, 12):
        a, b = rng.normal(size=n), rng.normal(size=n)
        b[:n // 2] = 1.0     # ties
        assert T.spearman(a, b) == JT.spearman(a, b)
    assert T.spearman([1, 1], [1, 2]) == 0.0


def test_fused_snapshots_pickle_and_keep_their_fingerprint():
    import pickle
    from repro_torch.core import numerics as NU
    for g in (TAP.gqa_attention_program(0.125, causal=True),
              TAP.rmsnorm_ffn_swiglu_program(576.0, eps=1e-5)):
        snaps = fuse(g)
        if NU.needs_stabilization(g):
            snaps = [NU.stabilize(s) for s in snaps]
        for s in snaps:
            assert pickle.loads(pickle.dumps(s)).fingerprint() == \
                s.fingerprint()
