"""The ``deepseek-v3-671b`` configuration on the CPU at small widths
(``reference/deepseek.py`` against the program, on the weights the
benchmark draws), its counts against worked examples, and the harness's
run of its cell in the CPU mode.

The configuration's file lies in ``configs/mla/``: the tests that run
over ``configs/*.json`` hold the configurations of ``reference/decoder.py``
(the control's test builds that reference by name), and this file holds
this one to the same checks against its own reference.

Small widths: d 256, 4 heads, q / kv ranks 64 / 32, RoPE 16, no-RoPE and
value dims 32, 16 experts in 4 groups (2 kept, top 4) of which experts
4..11 are held, 1 shared, 1 dense + 2 MoE layers, YaRN factor 40 over
4096 (at RoPE 16 the ramp runs over pairs 2..6), vocabulary 512.
"""

import copy
import dataclasses

import pytest
import torch

from bench_small import SMALL_PROFILE, small_mix
from benchlib import counts_mla, runner, spec, weights
from benchlib.peaks import bound_s
from reference.deepseek import Decoder

BENCH = spec.load()
CELL = "deepseek-v3-671b.chat"
CONFIG = spec.config(BENCH, "deepseek-v3-671b")
#: the program against the reference in float32: the absorbed decode, the
#: prefill's chunked attention and the experts' batched products sum in
#: other orders than the reference's plain products, ~5e-6 of logits of
#: ~4; the variants below miss by 1e-2 or more
TOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the small model's products take microseconds,
    and with every test process holding a thread per core they stretch
    on a loaded machine (and the harness's window closes before a request
    finishes; ``test_bench_harness.py``)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small() -> dict:
    cfg = copy.deepcopy(CONFIG)
    cfg.update(hidden_size=256, num_hidden_layers=3, num_attention_heads=4,
               num_key_value_heads=4, q_lora_rank=64, kv_lora_rank=32,
               qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32,
               intermediate_size=512, moe_intermediate_size=64,
               n_routed_experts=8, n_group=4, topk_group=2,
               num_experts_per_tok=4, first_k_dense_replace=1,
               vocab_size=512)
    cfg["reference"].update(head_dim=32, router_experts=16,
                            experts_held=[4, 8])
    cfg["port"].update(n_layers=3, d_model=256, n_heads=4, n_kv_heads=4,
                       d_head=32, q_lora_rank=64, kv_lora_rank=32,
                       qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32,
                       d_ff=512, moe_d_ff=64, n_experts=16, top_k=4,
                       router_groups=4, router_groups_kept=2,
                       n_dense_layers=1, capacity_factor=4.0,
                       expert_share=[4, 8], vocab=512)
    cfg["check"]["limits"] = {"served_gap": 1e-3}
    return cfg


def _pair(cfg, seed=11, **port):
    """The program (plain impls) and the reference on one draw of
    weights; ``port`` changes the program's config alone."""
    from repro_torch.models.lm import LM
    mc = runner.port_config(cfg, torch.device("cpu"))
    lm = LM(dataclasses.replace(mc, attn_impl="ref", mlp_impl="unfused"))
    flat = weights.draw(lm.init_params(0, "meta"), cfg["init"], seed, "cpu")
    params = weights.rebuild(lm.init_params(0, "meta"), flat)
    ref = Decoder(cfg, weights.reference_names(flat, cfg["param_map"]))
    if port:
        lm = LM(dataclasses.replace(lm.cfg, **port))
    return lm, params, ref


def _err(got, want):
    return (got - want).abs().max().item() / want.abs().max().item()


def test_config_ports_the_published_sizes():
    cfg, port = CONFIG, CONFIG["port"]
    assert spec.problems(BENCH) == []
    assert port["d_model"] == cfg["hidden_size"]
    assert port["n_layers"] == cfg["num_hidden_layers"] == 19
    assert port["n_dense_layers"] == cfg["first_k_dense_replace"]
    assert port["n_heads"] == cfg["num_attention_heads"]
    assert (port["q_lora_rank"], port["kv_lora_rank"], port["qk_nope_dim"],
            port["qk_rope_dim"], port["v_head_dim"]) == (
        cfg["q_lora_rank"], cfg["kv_lora_rank"], cfg["qk_nope_head_dim"],
        cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    assert port["d_ff"] == cfg["intermediate_size"]
    assert port["moe_d_ff"] == cfg["moe_intermediate_size"]
    assert port["vocab"] == cfg["vocab_size"]
    assert port["norm_eps"] == cfg["rms_norm_eps"]
    assert port["rope_theta"] == cfg["rope_theta"]
    rs = cfg["rope_scaling"]
    assert (port["rope_factor"], port["rope_original_max"],
            port["rope_beta_fast"], port["rope_beta_slow"],
            port["rope_mscale"], port["rope_mscale_all_dim"]) == (
        rs["factor"], rs["original_max_position_embeddings"],
        rs["beta_fast"], rs["beta_slow"], rs["mscale"],
        rs["mscale_all_dim"])
    # the router keeps its published width, groups and top-k
    assert port["n_experts"] == cfg["published"]["n_routed_experts"] \
        == cfg["reference"]["router_experts"] == 256
    assert port["expert_share"] == cfg["reference"]["experts_held"] \
        == [0, cfg["n_routed_experts"]]
    assert (port["top_k"], port["router_groups"], port["router_groups_kept"],
            port["routed_scale"], port["n_shared_experts"]) == (
        cfg["num_experts_per_tok"], cfg["n_group"], cfg["topk_group"],
        cfg["routed_scaling_factor"], cfg["n_shared_experts"])
    assert port["router_score"] == cfg["scoring_func"] == "sigmoid"
    # dropless: an expert's capacity is every token of a step
    assert port["capacity_factor"] * port["top_k"] >= port["n_experts"]
    for key in cfg["reduced"]:
        assert key in cfg and key in cfg["published"]
    # floors: a whole dense block and 4 MoE layers, 8 experts
    assert port["n_layers"] - port["n_dense_layers"] >= 4
    assert cfg["n_routed_experts"] >= 8


def test_reference_matches_the_program():
    lm, params, ref = _pair(small())
    g = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, 512, (2, 30), generator=g)
    with torch.no_grad():
        prog = lm.forward(params, tokens)
        pre, _ = lm.prefill(params, tokens[:, :20], max_len=40)
    for b in range(2):
        want = ref.logits(tokens[b])
        assert _err(prog[b], want) <= TOL
        assert _err(pre[b], want[:20]) <= TOL
    assert torch.equal(ref.logits(tokens[0], last=5),
                       ref.logits(tokens[0])[-5:])


@pytest.mark.parametrize("variant", [
    {"router_score": "softmax"}, {"rope_mscale_all_dim": 0.0},
    {"rope_factor": 1.0}], ids=["softmax_router", "no_mscale", "no_yarn"])
def test_the_program_without_a_part_fails(variant):
    lm, params, ref = _pair(small(), **variant)
    tokens = torch.arange(30) * 7 % 512
    with torch.no_grad():
        prog = lm.forward(params, tokens[None])[0]
    assert _err(prog, ref.logits(tokens)) > 100 * TOL


def test_engine_decode_steps_match_the_reference():
    """Every ragged decode step of the engine against the reference's
    full forward over the prompt and the tokens served before it."""
    from repro_torch.launch.engine import Engine, Request
    lm, params, ref = _pair(small())
    eng = Engine(lm.cfg, params=params, device="cpu", max_batch=3,
                 max_len=40, prompt_buckets=(8, 16), record_logits=True,
                 repromote_after=None)
    g = torch.Generator().manual_seed(5)
    reqs = [Request(rid=i, prompt=tuple(torch.randint(
        0, 512, (n,), generator=g).tolist()), max_new_tokens=8,
        arrival_step=i) for i, n in enumerate((5, 11, 16))]
    rep = eng.run(reqs)
    assert rep.n_completed == 3
    for r in reqs:
        served = rep.tokens[r.rid]
        seq = torch.tensor(list(r.prompt) + served[:-1])
        want = ref.logits(seq, last=len(served))
        got = torch.stack(rep.logits[r.rid])
        assert got.shape == want.shape
        assert _err(got, want) <= TOL


def test_expert_shares_add_up():
    cfg = small()
    cfg["reference"]["experts_held"] = cfg["port"]["expert_share"] = [0, 16]
    _, _, ref = _pair(cfg)
    whole_w = ref.w
    x = torch.randn(10, 256, generator=torch.Generator().manual_seed(0))
    whole = ref.mlp(1, x)
    shared = ref.swiglu(x, whole_w["layers.1.shared_gate_proj"],
                        whole_w["layers.1.shared_up_proj"],
                        whole_w["layers.1.shared_down_proj"])
    parts = torch.zeros_like(whole)
    for first in (0, 4, 8, 12):
        c = dict(cfg, reference=dict(cfg["reference"],
                                     experts_held=[first, 4]))
        share = {k: (v[first:first + 4] if "experts_" in k else v)
                 for k, v in whole_w.items()}
        parts += Decoder(c, share).mlp(1, x)
    torch.testing.assert_close(parts - 3 * shared, whole, rtol=1e-5,
                               atol=1e-5)


def test_counts_decode_row():
    m = counts_mla.MlaShape.of(CONFIG)
    mla = (7168 * 1536 + 1536 * 128 * 192 + 7168 * 576 + 512 * 128 * 256
           + 128 * 128 * 7168)
    assert m.mla_weights == mla == 187_105_280
    assert m.dense_mlp_weights == 396_361_728
    assert m.expert_weights == 44_040_192
    ops, nbytes = counts_mla.tick_work(m, [], [100])
    assert ops == 2 * (19 * mla + 3 * 396_361_728 + 16 * (
        1_835_008 + 44_040_192 + 8 * 8 / 256 * 44_040_192)) \
        + 2 * 19 * 128 * 1088 * 100 + 2 * 7168 * 129280
    assert ops == 13_691_060_224
    weights_ = (19 * (mla + 2 * 7168 + 1536 + 512) + 3 * 396_361_728
                + 16 * (1_835_008 + 256 + 44_040_192) + 7168
                + 7168 * 129280)
    assert weights_ == 6_405_090_304
    assert nbytes == 4 * (weights_ + 7168) + 4 * 16 * 0.25 * 44_040_192 \
        + 19 * 576 * 100 * 4 + 4 * 129280
    assert nbytes == 26_329_927_680
    assert bound_s(ops, nbytes) == nbytes / 3.35e12


def test_counts_prefill_and_decode_tick():
    m = counts_mla.MlaShape.of(CONFIG)
    ops, nbytes = counts_mla.tick_work(m, [70], [100] * 31)
    one = counts_mla.tick_work(m, [], [100])[0]
    row_attn = 2 * 19 * 128 * 1088 * 100
    prompt_attn = 2 * 19 * 128 * 320 * (70 * 71 // 2)
    head = 2 * 7168 * 129280
    per_token = one - row_attn - head
    assert ops == pytest.approx(101 * per_token + 31 * row_attn
                                + prompt_attn + 32 * head)
    touched = 8 * (1 - (1 - 8 / 256) ** 101)
    assert m.touched_experts(101) == pytest.approx(touched)
    assert touched == pytest.approx(7.6761, abs=1e-4)
    # the weights are read once a tick, however many rows share them
    assert nbytes < 2 * counts_mla.tick_work(m, [], [100])[1]
    assert counts_mla.tick_work(m, [], []) == (0.0, 0.0)


@pytest.fixture
def kernel_cache(tmp_path, monkeypatch):
    """The program's plan cache in a directory of the test's own."""
    monkeypatch.setenv("REPRO_TORCH_KERNEL_CACHE", str(tmp_path / "cache"))
    from repro_torch import pipeline
    pipeline.reset_default_cache()
    yield tmp_path / "cache"
    pipeline.reset_default_cache()


def _run(seed, trace):
    return runner.run_cell(BENCH, CELL, seed, 3.0, trace, device="cpu",
                           cfg=small(), mix=small_mix(),
                           log=lambda msg: None, profile=SMALL_PROFILE)


@pytest.mark.parametrize("trace", [False, True], ids=["untraced",
                                                    "traced"])
def test_harness_runs_the_cell(kernel_cache, trace):
    out = _run(21, trace)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"]["served_gap"]["value"] == 0.0
    want = {m["name"] for m in spec.metrics_of(BENCH, CELL, trace)}
    # the card's memory and time, which the CPU has not
    on_card = {"peak_mem_gib", "device_idle_pct", "mla_decode_roofline"}
    assert want - on_card <= set(out["metrics"]) <= want
    if trace:
        # 8 of 16 experts held, top 4: about 2 of a row's 4 assignments
        # land here, in 8 rows of capacity an expert
        assert 50.0 < out["metrics"]["moe_pad_pct"]["value"] < 95.0


def test_zeroed_mla_fails_the_check(kernel_cache, monkeypatch):
    from repro_torch.models import layers as L
    orig = L.mla_decode

    def zeroed(p, x, cache, pos, cfg):
        y, cache = orig(p, x, cache, pos, cfg)
        return torch.zeros_like(y), cache
    monkeypatch.setattr(L, "mla_decode", zeroed)
    out = _run(22, False)
    assert out["correct"] is False
    assert out["checks"]["served_gap"]["value"] > \
        out["checks"]["served_gap"]["limit"]
