"""The emitted CUDA kernels on the card (the ``card`` fixture skips them,
with its reason, on a machine without one).  Run them on the card with

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Every in-repo program compiles on the ``cuda`` backend; every emitted
kernel is built by nvcc, launched on CUDA tensors and held against its
plain version at ``rtol = atol = 2e-4``; a CUDA call counts one launch
per kernel.  The same holds for every fusion snapshot, grouped and
ungrouped (the card side of ``tests/test_torch_coverage.py``), for every
kernel of the serving path at its serving shape (full-width smollm-135m:
decode batch 4, prompt buckets 8/16/32, max_len 96), for qwen2-7b's
SwiGLU on the tensor cores at the benchmark cell's shapes (32 decode rows,
a 64-row prefill), for a kernel whose products all run in
``tiles::dot_k_sum`` with an operand in shared memory and ranks of unequal
shares, and for a reduction whose trip count gives a cluster of 13 ranks
or, having no divisor up to 16, none.  deepseek-v3 as the benchmark cell
serves it: a decode step that never syncs, its prefill and decode
replayed as captured CUDA graphs equal to the eager steps, and its
``noaux_tc`` routing as on the CPU.  The compile driver on the card: a
measured autotune and a disk-hit re-lowering that loads its libraries
without nvcc.  This module imports no JAX: the machine with the card has
none.

A default engine of a qwen2-shaped dense model and of a softmax-routed MoE
one captures its prefills and decode step, replays them equal to the eager
steps, marks its spans and holds one largest-bucket prefill's outputs more
than the eager engine.
"""

import numpy as np
import pytest
import torch

from repro_torch import pipeline as TP
from repro_torch.core import array_program as TAP
from repro_torch.core import codegen_cuda as CC
from repro_torch.core.fusion import fuse
from repro_torch.kernels import grouped_experts as GE
from repro_torch.pipeline import packing as P
import torch_port  # noqa: F401

TOL = 2e-4

# the reference's lowering-coverage matrix (tests/test_lowering_coverage.py)
PROGRAMS = {
    "layernorm_matmul": (lambda A: A.layernorm_matmul_program(32.0),
                         {"M": 2, "K": 4, "N": 2},
                         {"M": 4, "K": 8, "N": 8}),
    "rmsnorm_swiglu": (lambda A: A.rmsnorm_ffn_swiglu_program(16.0),
                       {"M": 2, "D": 2, "K": 3, "N": 2},
                       {"M": 4, "D": 8, "K": 4, "N": 4}),
    "flash": (lambda A: A.attention_program(0.125),
              {"M": 2, "D": 2, "N": 3, "L": 2},
              {"M": 4, "D": 8, "N": 4, "L": 8}),
    "causal": (lambda A: A.causal_attention_program(0.25),
               {"M": 2, "D": 2, "N": 2, "L": 2},
               {"M": 4, "D": 8, "N": 4, "L": 8}),
    "gqa": (lambda A: A.gqa_attention_program(0.25, causal=True),
            {"H": 2, "M": 2, "D": 2, "N": 2, "L": 2},
            {"H": 1, "M": 4, "D": 8, "N": 4, "L": 8}),
}


def merged_inputs(g, dims, blocks, seed=0):
    """Seeded merged inputs of a program (positions for QP/KP)."""
    rng = np.random.default_rng(seed)
    out = {}
    for nid in g.input_ids:
        node = g.nodes[nid]
        vt = node.vtype
        item = tuple(blocks[d] for d in vt.dims[vt.lead_dims:])
        shape = P.merged_shape(vt, item, dims)
        if node.name in ("QP", "KP"):
            out[node.name] = np.arange(shape[0], dtype=np.float32)
        else:
            out[node.name] = (rng.normal(size=shape)
                              / max(shape[-1], 1) ** 0.5).astype(np.float32)
    return out


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with nvcc (sm_90a)")
    return torch.device("cuda")


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_compiled_program_on_card(name, card):
    build, dims, blocks = PROGRAMS[name]
    kern = TP.compile(build(TAP), dims, options=TP.CompileOptions(
        backend="cuda", blocks=blocks))
    feed = {n: torch.from_numpy(v)
            for n, v in merged_inputs(kern.graph, dims, blocks).items()}
    want = kern(feed)                                   # CPU: plain versions
    before = [k.launches for k in kern.kernels]
    got = kern({n: v.to(card) for n, v in feed.items()})
    torch.cuda.synchronize()
    assert [k.launches - b for k, b in zip(kern.kernels, before)] == [
        1] * len(kern.kernels)
    for n in kern.out_names:
        torch.testing.assert_close(got[n].cpu(), want[n], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("group", [True, False], ids=["grouped",
                                                      "ungrouped"])
def test_every_snapshot_runs_on_card(group, card):
    runs, kernels = [], []
    for name, (build, dims, blocks) in sorted(PROGRAMS.items()):
        g = build(TAP)
        inputs = merged_inputs(g, dims, blocks)
        for i, snap in enumerate(fuse(g)):
            fn, _ = CC.emit_program(snap, dims, blocks, group=group)
            feed = [torch.from_numpy(inputs[snap.nodes[j].name])
                    for j in snap.input_ids]
            runs.append((f"{name}[{i}]", fn, feed))
            kernels += [k for _, k in fn.region_runners]
    CC.build(kernels)
    for label, fn, feed in runs:
        want = fn(*feed)
        got = fn(*[t.to(card) for t in feed])
        torch.cuda.synchronize()
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_.cpu(), w_, rtol=TOL, atol=TOL,
                                       msg=label)


# -- the serving path's kernels at their shapes -------------------------------

SERVING = ("attention_prefill8", "attention_prefill16", "attention_prefill32",
           "attention_decode", "swiglu_prefill8", "swiglu_prefill16",
           "swiglu_prefill32", "swiglu_decode")


def serving_inputs(name, device, seed=0):
    """Seeded inputs of the serving program ``name`` at full smollm-135m
    width, with its instance-axis count (as the model layers feed it)."""
    gen = torch.Generator().manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(device)

    d, dff, dh, hkv, group = 576, 1536, 64, 3, 3
    if name.startswith("attention"):
        if name == "attention_decode":
            b, s, skv = 4, 1, 96
            qp = torch.tensor([5.0, 35.0, 65.0, 95.0]).reshape(b, 1, 1)
        else:
            b, s = 1, int(name[len("attention_prefill"):])
            skv = s
            qp = torch.arange(s, dtype=torch.float32).reshape(1, 1, s)
        kp = torch.arange(skv, dtype=torch.float32).reshape(1, 1, skv)
        return {"Q": randn(b, hkv, group, s, dh), "KT": randn(b, hkv, skv, dh),
                "VT": randn(b, hkv, dh, skv), "QP": qp.to(device),
                "KP": kp.to(device)}, 2
    t = 4 if name == "swiglu_decode" else int(name[len("swiglu_prefill"):])
    return {"X": randn(t, d), "WT": randn(dff, d, scale=d ** -0.5),
            "VT": randn(dff, d, scale=d ** -0.5),
            "UT": randn(d, dff, scale=dff ** -0.5)}, 0


def serving_programs():
    """The serving path's compiled programs by name (no card needed)."""
    from repro_torch.launch import serve as S
    from repro_torch.models import layers as L
    cfg = S.ServeConfig()
    return L.pipeline_kernels(S.model_config(cfg),
                              prefill_lens=cfg.prompt_buckets,
                              decode_batch=cfg.max_batch,
                              max_len=cfg.max_len)


@pytest.mark.parametrize("name", SERVING)
def test_serving_kernels_on_card(name, card):
    """Each kernel of the serving program ``name`` launched once on its
    inputs, against its plain version; the SwiGLU kernels lie on 72
    blocks (at least 36)."""
    ck = serving_programs()[name]
    inputs, inst = serving_inputs(name, card)
    raw = ck._fn.raw_program
    env = {ref: inputs[n] for ref, n in zip(raw.input_refs, ck.in_names)}
    CC.build(ck.kernels)
    for kr, kern in raw.region_runners:
        kin = [env[r] for r in kr.in_refs]
        before = kern.launches
        got = kern(*kin, instances=inst)
        want = kern.plain(*kin, instances=inst)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_, w_, rtol=TOL, atol=TOL,
                                       msg=f"{name}/{kern.gid}")
        if name.startswith("swiglu"):
            assert kern.blocks >= 36
        env.update(zip(kr.out_refs, got))


@pytest.mark.parametrize("k_trips,ranks", [(13, 13), (17, 1)])
def test_cluster_size_follows_the_trip_count_on_card(k_trips, ranks, card):
    """rmsnorm_swiglu with 13 or 17 K blocks: the down projection's K
    reduction splits over a cluster of 13 ranks (a non-portable size), or,
    17 having no divisor up to 16, runs in one block per cell."""
    dims = {"M": 2, "D": 2, "K": k_trips, "N": 2}
    blocks = {"M": 4, "D": 8, "K": 4, "N": 4}
    kern = TP.compile(TAP.rmsnorm_ffn_swiglu_program(16.0), dims,
                      options=TP.CompileOptions(backend="cuda",
                                                blocks=blocks))
    assert [k.plan.cluster_size for k in kern.kernels] == [ranks]
    feed = {n: torch.from_numpy(v)
            for n, v in merged_inputs(kern.graph, dims, blocks).items()}
    want = kern(feed)
    got = kern({n: v.to(card) for n, v in feed.items()})
    torch.cuda.synchronize()
    for n in kern.out_names:
        torch.testing.assert_close(got[n].cpu(), want[n], rtol=TOL, atol=TOL)


def test_measured_autotune_on_card(card, tmp_path):
    """``autotune="measured"`` on the card: every finalist compiles and is
    timed at one total problem; the winner is no slower than the analytic
    winner (the first finalist timed), lowers at the caller's blocks, and
    agrees with its kernels' plain versions."""
    from repro_torch.core import timing as T
    g = TAP.rmsnorm_ffn_swiglu_program(16.0)
    cands = {"M": [1, 2], "D": [2], "K": [2, 3], "N": [2]}
    opts = TP.CompileOptions(backend="cuda", blocks={"M": 4, "D": 8,
                                                     "K": 4, "N": 4},
                             autotune="measured", top_k=3)
    cache = TP.KernelCache(tmp_path)
    T.clear_measurements()
    kern = TP.compile(g, dim_candidates=cands, options=opts, cache=cache)
    times = dict(kern.autotune_timings)
    analytic = kern.autotune_report[0]["dims"]
    assert kern.measured_s <= times[tuple(sorted(analytic.items()))]
    assert all(r["skipped"] is None for r in kern.autotune_report)
    assert kern.blocks == opts.blocks_dict
    feed = T.synth_inputs(g, kern.dims, kern.blocks, device=card)
    got = kern(feed)
    want = kern({n: v.cpu() for n, v in feed.items()})
    for n in kern.out_names:
        torch.testing.assert_close(got[n].cpu(), want[n], rtol=TOL, atol=TOL)


def test_disk_hit_relowers_without_nvcc(card, tmp_path):
    """A fresh cache object over the same directory (a new process) loads
    the plan from disk, and its kernels load their libraries without a
    build, then launch and agree with the first compile's."""
    from repro_torch.core import cuda_build as CB
    build, dims, blocks = PROGRAMS["gqa"]
    opts = TP.CompileOptions(backend="cuda", blocks=blocks)
    first = TP.compile(build(TAP), dims, options=opts,
                       cache=TP.KernelCache(tmp_path))
    feed = {n: torch.from_numpy(v).to(card) for n, v in
            merged_inputs(first.graph, dims, blocks).items()}
    want = first(feed)
    builds = CB.STATS["builds"]
    again = TP.compile(build(TAP), dims, options=opts,
                       cache=TP.KernelCache(tmp_path))
    assert again.cache_hit == "disk"
    got = again(feed)
    torch.cuda.synchronize()
    assert CB.STATS["builds"] == builds
    for n in again.out_names:
        torch.testing.assert_close(got[n], want[n], rtol=0, atol=0)


# -- deepseek-v3 (MLA) and mamba2 on the card ---------------------------------

DEEPSEEK_SWIGLU = ("swiglu_decode", "swiglu_prefill8", "swiglu_prefill16",
                   "swiglu_prefill32")


@pytest.mark.parametrize("name", DEEPSEEK_SWIGLU)
def test_deepseek_swiglu_kernels_on_card(name, card):
    """The dense layer's emitted SwiGLU kernels at deepseek-v3's widths
    (d 7168, d_ff 18432: three kernels a program), each launched once on
    seeded inputs of its serving shape, against its plain version."""
    from repro_torch.launch import serve as S
    from repro_torch.models import layers as L
    cfg = S.ServeConfig(arch="deepseek-v3-671b", n_layers=2)
    mc = S.model_config(cfg)
    ck = L.pipeline_kernels(mc, prefill_lens=cfg.prompt_buckets,
                            decode_batch=cfg.max_batch,
                            max_len=cfg.max_len)[name]
    d, dff = mc.d_model, mc.d_ff
    t = cfg.max_batch if name == "swiglu_decode" else int(
        name[len("swiglu_prefill"):])
    gen = torch.Generator(device=card).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=card) * scale

    inputs = {"X": randn(t, d), "WT": randn(dff, d, scale=d ** -0.5),
              "VT": randn(dff, d, scale=d ** -0.5),
              "UT": randn(d, dff, scale=dff ** -0.5)}
    raw = ck._fn.raw_program
    env = {ref: inputs[n] for ref, n in zip(raw.input_refs, ck.in_names)}
    CC.build(ck.kernels)
    assert len(ck.kernels) == 3
    for kr, kern in raw.region_runners:
        kin = [env[r] for r in kr.in_refs]
        before = kern.launches
        got = kern(*kin)
        want = kern.plain(*kin)
        torch.cuda.synchronize()
        assert kern.launches == before + 1
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_, w_, rtol=TOL, atol=TOL,
                                       msg=f"{name}/{kern.gid}")
        env.update(zip(kr.out_refs, got))


QWEN2_7B_SWIGLU = ("swiglu_decode", "swiglu_prefill32", "swiglu_prefill64")


@pytest.mark.parametrize("name", QWEN2_7B_SWIGLU)
def test_qwen2_7b_swiglu_kernels_on_card(name, card):
    """The emitted SwiGLU kernels at qwen2-7b's widths (d 3584, d_ff
    18944) and the benchmark cell's shapes: 32 decode rows, the 32-row
    prefill (the same kernels) and a 64-row prefill block; g1 and g2 on
    the tensor cores (``tiles::dot_k_sum``), each launched once on seeded
    inputs against its plain version."""
    from repro_torch.launch import serve as S
    from repro_torch.models import layers as L
    mc = S.model_config(S.ServeConfig(arch="qwen2-7b", n_layers=1))
    ck = L.pipeline_kernels(mc, prefill_lens=(32, 64), decode_batch=32,
                            max_len=1024)[name]
    d, dff = mc.d_model, mc.d_ff
    t = 32 if name == "swiglu_decode" else int(name[len("swiglu_prefill"):])
    gen = torch.Generator(device=card).manual_seed(0)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=card) * scale

    inputs = {"X": randn(t, d), "WT": randn(dff, d, scale=d ** -0.5),
              "VT": randn(dff, d, scale=d ** -0.5),
              "UT": randn(d, dff, scale=dff ** -0.5)}
    raw = ck._fn.raw_program
    env = {ref: inputs[n] for ref, n in zip(raw.input_refs, ck.in_names)}
    CC.build(ck.kernels)
    assert [k.product_path for k in ck.kernels] == [
        CC.FMA_PATH, CC.TENSOR_PATH, CC.TENSOR_PATH]
    for kr, kern in raw.region_runners:
        kin = [env[r] for r in kr.in_refs]
        got = kern(*kin)
        want = kern.plain(*kin)
        torch.cuda.synchronize()
        for g_, w_ in zip(got, want):
            torch.testing.assert_close(g_, w_, rtol=TOL, atol=TOL,
                                       msg=f"{name}/{kern.gid}")
        env.update(zip(kr.out_refs, got))


#: rmsnorm_swiglu at 16-row blocks: one kernel whose products all run in
#: ``tiles::dot_k_sum`` (the gate/up inside a loop over K, the down
#: projection's operand a in shared memory), the down projection's 13 K
#: trips over a cluster of 7 ranks of 1 or 2 trips
TENSOR_SHAPE = ({"M": 1, "D": 2, "K": 13, "N": 22},
                {"M": 16, "D": 16, "K": 16, "N": 8})


def test_tensor_core_path_in_a_group_on_card(card):
    """:data:`TENSOR_SHAPE`'s kernel on the card against its plain
    version: staged plain copies of a shared-memory operand, a ring reused
    across the calls of a loop, ranks of unequal shares."""
    dims, blocks = TENSOR_SHAPE
    kern = TP.compile(TAP.rmsnorm_ffn_swiglu_program(16.0), dims,
                      options=TP.CompileOptions(backend="cuda",
                                                blocks=blocks))
    assert [(k.product_path, k.plan.cluster_size) for k in kern.kernels] == [
        (CC.TENSOR_PATH, 7)]
    feed = {n: torch.from_numpy(v)
            for n, v in merged_inputs(kern.graph, dims, blocks).items()}
    want = kern(feed)
    got = kern({n: v.to(card) for n, v in feed.items()})
    torch.cuda.synchronize()
    for n in kern.out_names:
        torch.testing.assert_close(got[n].cpu(), want[n], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("ragged", [False, True], ids=["scalar", "ragged"])
def test_mla_decode_on_card_matches_cpu(ragged, card):
    """``mla_decode`` at deepseek-v3's full widths on CUDA tensors (plain
    torch there, as the reference runs plain einsums) against the same
    function on the CPU: output and the compressed cache."""
    import dataclasses
    from repro_torch import configs as C
    from repro_torch.models import common as CM
    from repro_torch.models import layers as L
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(C.get_config("deepseek-v3-671b"),
                              dtype=torch.float32)
    pb = CM.ParamBuilder(np.random.default_rng(0), torch.float32, "cpu")
    p = CM.init_mla(pb, cfg)
    rng = np.random.default_rng(1)
    b, max_len = 4, 96
    cache = {"ckv": torch.from_numpy(rng.normal(
                 size=(b, max_len, cfg.kv_lora_rank)).astype(np.float32)),
             "krope": torch.from_numpy(rng.normal(
                 size=(b, max_len, cfg.qk_rope_dim)).astype(np.float32))}
    x = torch.from_numpy(rng.normal(size=(b, 1, cfg.d_model)).astype(
        np.float32))
    pos = torch.tensor([5, 40, 70, 95]) if ragged else torch.tensor(50)
    gc = {k: v.to(card) for k, v in cache.items()}
    got, _ = L.mla_decode({k: v.to(card) for k, v in p.items()},
                          x.to(card), gc, pos.to(card), cfg)
    want, _ = L.mla_decode(p, x, cache, pos, cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-4)
    for k in cache:
        torch.testing.assert_close(gc[k].cpu(), cache[k], rtol=1e-5,
                                   atol=1e-5)


def test_ssd_chunked_on_card_matches_cpu(card):
    """``_ssd_chunked`` at mamba2-2.7b's widths (80 heads of 64, state
    128, chunk 256) over 600 tokens (three chunks, the last padded), with
    an initial state, on CUDA tensors against the CPU."""
    from repro_torch import configs as C
    from repro_torch.models import layers as L
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = C.get_config("mamba2-2.7b")
    rng = np.random.default_rng(2)
    b, s = 1, 600
    nh, hd, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state

    def normal(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.normal(size=shape)).astype(
            np.float32))

    args = (normal(b, s, nh, hd), torch.nn.functional.softplus(
        normal(b, s, nh)), -torch.exp(normal(nh, scale=0.5)),
        normal(b, s, n, scale=0.1), normal(b, s, n, scale=0.1))
    h0 = normal(b, nh, hd, n)
    y, h = L._ssd_chunked(*(a.to(card) for a in args), cfg, h0=h0.to(card))
    wy, wh = L._ssd_chunked(*args, cfg, h0=h0)
    torch.testing.assert_close(y.cpu(), wy, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h.cpu(), wh, rtol=1e-4, atol=1e-4)


def _deepseek_cell_config(n_layers):
    """deepseek-v3 as the benchmark cell serves it (``noaux_tc``, YaRN,
    experts 0..7 of 256 held, drop-free), cut to ``n_layers``, float32 on
    the emitted kernels."""
    import dataclasses
    from repro_torch import configs as C
    from repro_torch.launch import serve as S
    cfg = dataclasses.replace(
        C.get_config("deepseek-v3-671b"), dtype=torch.float32,
        router_score="sigmoid", router_groups=8, router_groups_kept=4,
        routed_scale=2.5, rope_factor=40.0, rope_original_max=4096,
        rope_beta_fast=32.0, rope_beta_slow=1.0, rope_mscale=1.0,
        rope_mscale_all_dim=1.0, expert_share=(0, 8), capacity_factor=32.0)
    return C.with_pipeline(S.cut_depth(cfg, n_layers), backend="cuda")


def test_deepseek_decode_step_never_syncs_on_card(card):
    """A ragged 32-row decode step of deepseek-v3 at the cell's widths
    (1 dense + 1 MoE layer), as the engine runs it eagerly, enqueues
    everything: no host-device sync under
    ``torch.cuda.set_sync_debug_mode("error")``, each row's count of its
    assignments to the held experts and the rows the held experts
    computed handed back on the device (the grouped expert kernel's
    rows: every assignment, drop-free at capacity factor 32)."""
    from repro_torch.launch.engine import Engine
    cfg = _deepseek_cell_config(2)
    eng = Engine(cfg, device=card, max_batch=32, max_len=256,
                 prompt_buckets=(32,), repromote_after=None)
    eng.warmup()
    gen = torch.Generator(device=card).manual_seed(3)
    toks = torch.randint(0, cfg.vocab, (32, 1), generator=gen, device=card)
    pos = torch.arange(32, device=card) + 3
    eng._step(toks, pos)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, held = eng._step(toks, pos + 1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert logits.shape == (32, 1, cfg.vocab)
    assert bool(torch.isfinite(logits).all())
    assert held.shape == (33,) and held.device.type == "cuda"
    assert bool(((held[:32] >= 0) & (held[:32] <= cfg.top_k)).all())
    assert int(held[:32].sum()) > 0
    assert int(held[32]) == int(held[:32].sum())


def test_deepseek_routing_on_card_matches_cpu(card):
    """``noaux_tc`` at deepseek-v3's widths (256 experts, 8 groups, the
    best 4 kept, top 8, scale 2.5) on CUDA tensors against the CPU: the
    same experts for every token and the same weights."""
    from repro_torch.models import layers as L
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _deepseek_cell_config(4)
    g = torch.Generator().manual_seed(0)
    xn = torch.randn(256, cfg.d_model, generator=g)
    p = {"router": torch.randn(cfg.d_model, 256, generator=g)
         / cfg.d_model ** 0.5,
         "router_bias": 0.05 * torch.randn(256, generator=g)}
    w, ids = L._route(xn, p, cfg)
    wc, idc = L._route(xn.to(card), {k: v.to(card) for k, v in p.items()},
                       cfg)
    order, order_c = ids.sort(-1), idc.cpu().sort(-1)
    assert torch.equal(order.values, order_c.values)
    torch.testing.assert_close(w.gather(1, order.indices),
                               wc.cpu().gather(1, order_c.indices),
                               rtol=1e-5, atol=1e-6)
    assert torch.allclose(w.sum(-1), torch.full((256,), 2.5))


def test_deepseek_graphs_replay_the_eager_steps_on_card(card):
    """With ``cuda_graphs`` the engine captures each bucket's prefill and
    its decode step as CUDA graphs in ``warmup()``: replays on new tokens
    and ragged positions give the eager steps' logits, caches and each
    row's count of its assignments to the held experts (and the rows they
    computed)."""
    import dataclasses
    from repro_torch.launch.engine import Engine
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(_deepseek_cell_config(2), cuda_graphs=True)
    eng = Engine(cfg, device=card, max_batch=32, max_len=256,
                 prompt_buckets=(32,), repromote_after=None)
    eng.warmup()
    assert set(eng._graphs) == {32, "decode"}
    rng = np.random.default_rng(0)
    for slot in range(32):
        padded = np.zeros((1, 32), np.int64)
        padded[0, :20] = rng.integers(0, cfg.vocab, 20)
        logits = eng._prefill(padded, slot)
        want, want_cache = eng.model.prefill(
            eng.params, torch.from_numpy(padded).to(card), max_len=256)
        torch.testing.assert_close(logits, want, rtol=1e-5, atol=1e-5)
        for k in want_cache:
            torch.testing.assert_close(eng.caches[k][:, slot],
                                       want_cache[k][:, 0], rtol=1e-5,
                                       atol=1e-5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (32, 1))).to(card)
    pos = torch.arange(32, device=card) % 12 + 20
    eager = {k: v.clone() for k, v in eng.caches.items()}
    want, want_held = eng._step(toks, pos, caches=eager)
    launched = GE.KERNEL.launches
    got, got_held = eng._run("decode", eng._step, toks, pos)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for k in eager:
        torch.testing.assert_close(eng.caches[k], eager[k], rtol=1e-5,
                                   atol=1e-5)
    assert got_held.shape == (33,) and torch.equal(got_held, want_held)


def _graph_config(kind):
    """Two small float32 configurations on the emitted kernels, 2 layers:
    a qwen2-shaped dense one (GQA group 7, QKV bias) and a softmax-routed
    MoE one (qwen3-moe-30b-a3b reduced)."""
    import dataclasses
    from repro_torch import configs as C
    from repro_torch.launch import serve as S
    if kind == "dense":
        cfg = dataclasses.replace(C.get_reduced_config("qwen2-7b"),
                                  n_heads=14, n_kv_heads=2, d_head=64)
    else:
        cfg = C.get_reduced_config("qwen3-moe-30b-a3b")
    cfg = dataclasses.replace(S.cut_depth(cfg, 2), dtype=torch.float32)
    return C.with_pipeline(cfg, backend="cuda")


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_default_engine_replays_graphs_on_card(kind, card):
    """A default-config engine on the card captures every prompt bucket's
    prefill and the decode step in ``warmup()``; replays on new tokens and
    ragged positions give the eager prefill's and decode step's logits
    and caches within 1e-5 (and each row's count of its assignments to
    the held experts exactly); a served run's
    ``admit`` and ``decode.forward`` spans read ``graph`` = 1 and each
    decode kernel counts a launch a layer a replayed step; the memory
    still allocated after ``warmup()`` is at most one largest-bucket
    prefill's outputs (logits and a sequence's cache) above the eager
    engine's, besides the capture stream's cuBLAS workspace; and the
    memory it keeps reserved (the graphs' one pool, which eager
    allocations cannot use) is at most one largest-bucket eager
    prefill's working set above the eager engine's, besides that
    workspace and one small and one large segment of the caching
    allocator (2 and 20 MiB), where a pool a graph would hold every
    capture's."""
    import dataclasses
    import gc
    from repro_torch import tracing as T
    from repro_torch.launch.engine import Engine, Request
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _graph_config(kind)
    assert cfg.cuda_graphs
    kw = dict(device=card, max_batch=8, max_len=128, prompt_buckets=(32, 64),
              repromote_after=None)

    def blas(stream=None):
        """The allocation a first matrix product on ``stream`` leaves."""
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated(card)
        with torch.cuda.stream(stream or torch.cuda.current_stream(card)):
            a = torch.ones(64, 128, device=card)
            torch.bmm((a @ a.T)[None], a[None])
        del a
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated(card) - before

    def warmed(c):
        """A warmed engine of ``c``, and the memory its construction and
        ``warmup()`` left allocated and reserved (cached blocks that
        ``empty_cache`` can free left out)."""
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        before = (torch.cuda.memory_allocated(card),
                  torch.cuda.memory_reserved(card))
        eng = Engine(c, **kw)
        eng.warmup()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return eng, (torch.cuda.memory_allocated(card) - before[0],
                     torch.cuda.memory_reserved(card) - before[1])

    blas()
    eager, (eager_mem, eager_res) = warmed(
        dataclasses.replace(cfg, cuda_graphs=False))
    assert eager._graphs == {}
    torch.cuda.reset_peak_memory_stats(card)
    start = torch.cuda.memory_allocated(card)
    eager._prefill(np.zeros((1, 64), np.int64), 0)
    torch.cuda.synchronize()
    working = torch.cuda.max_memory_allocated(card) - start
    del eager
    eng, (mem, res) = warmed(cfg)
    assert set(eng._graphs) == {32, 64, "decode"}
    outputs = (64 * cfg.vocab + sum(t[:, :1].numel()
                                    for t in eng.caches.values())) * 4
    workspace = blas(torch.cuda.Stream(card))
    assert mem - eager_mem <= outputs + workspace, (mem, eager_mem, outputs,
                                                    workspace)
    segments = (2 + 20) << 20
    assert res - eager_res <= working + workspace + segments, (
        res, eager_res, working, workspace)
    print(f"{kind}: after warmup() allocated {eager_mem} -> {mem} B, "
          f"reserved {eager_res} -> {res} B; one 64-bucket prefill's "
          f"outputs {outputs} B, working set {working} B; workspace "
          f"{workspace} B")

    rng = np.random.default_rng(0)
    lens = [5, 20, 33, 40, 64, 1, 31, 50]
    for slot, plen in enumerate(lens):
        b = eng._bucket(plen)
        padded = np.zeros((1, b), np.int64)
        padded[0, :plen] = rng.integers(0, cfg.vocab, plen)
        logits = eng._prefill(padded, slot)
        want, want_cache = eng.model.prefill(
            eng.params, torch.from_numpy(padded).to(card), max_len=128)
        torch.testing.assert_close(logits, want, rtol=1e-5, atol=1e-5)
        for k in want_cache:
            torch.testing.assert_close(eng.caches[k][:, slot],
                                       want_cache[k][:, 0], rtol=1e-5,
                                       atol=1e-5)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 1))).to(card)
    pos = torch.tensor(lens, device=card)
    eager_caches = {k: v.clone() for k, v in eng.caches.items()}
    want, want_held = eng._step(toks, pos, caches=eager_caches)
    launched = GE.KERNEL.launches
    got, got_held = eng._run("decode", eng._step, toks, pos)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    for k in eager_caches:
        torch.testing.assert_close(eng.caches[k], eager_caches[k], rtol=1e-5,
                                   atol=1e-5)
    if kind == "moe":
        assert got_held.shape == (9,) and torch.equal(got_held, want_held)
        # the decode graph runs the grouped expert kernel in both MoE
        # layers (8 rows, top-2 of 4), and its replay counts them
        assert eng.kernels["grouped_experts"] is GE.KERNEL
        assert GE.KERNEL.launches - launched == cfg.n_layers
    else:
        assert got_held is None and want_held is None
        assert GE.KERNEL.launches == launched
        assert "grouped_experts" not in eng.kernels

    trace = [Request(rid, tuple(int(t) for t in rng.integers(
        0, cfg.vocab, n)), 6, 0) for rid, n in enumerate([3, 40, 17, 60])]
    replays = eng.graph_replays
    saved, T.TRACER = T.TRACER, T.Tracer()
    try:
        report = eng.run(trace)
        spans = list(T.TRACER.spans)
    finally:
        T.TRACER = saved
    assert report.n_completed == len(trace)
    marked = [s for s in spans if s.name in ("admit", "decode.forward")]
    assert len(marked) == eng.graph_replays - replays
    assert marked and all(s.attrs["graph"] == 1 for s in marked)
    steps = sum(s.name == "decode.forward" for s in spans)
    decode = {n: c for n, c in report.kernel_launches.items()
              if n.startswith("attention_decode/")}
    assert decode and all(c == steps * cfg.n_layers
                          for c in decode.values()), (decode, steps)
