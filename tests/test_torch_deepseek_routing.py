"""deepseek-v3's routing and YaRN in the port (port-only fields of
``ModelConfig``), against worked examples, on the CPU:

* ``noaux_tc`` (``layers._route`` with ``router_score="sigmoid"``): the
  correction bias changes which experts a token gets and not their
  weights; an expert outside the kept groups is never chosen, however
  high its score; the weights are the chosen sigmoid scores over their
  sum, times ``routed_scale``;
* one chip's share under that router: 4 shares of 4 of 16 experts,
  summed with the shared expert counted once, equal the whole layer;
* YaRN at deepseek-v3's settings: the correction range (10, 23), the
  frequencies kept at or below it and divided by 40 at or above it, the
  softmax factor (0.1 ln 40 + 1)^2 = 1.87386, and MLA's prefill and
  absorbed decode at one scale;
* the defaults keep the softmax router and plain RoPE, bit for bit.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.models import common as TCM
from repro_torch.models import layers as TL
import torch_port  # noqa: F401

E, GROUPS, KEPT, K = 16, 4, 2, 4


def _router_cfg(**over):
    return TCM.ModelConfig(family="moe", d_model=E, n_experts=E, top_k=K,
                           router_score="sigmoid", router_groups=GROUPS,
                           router_groups_kept=KEPT, routed_scale=2.5,
                           dtype=torch.float32, **over)


def _logits():
    """One token's router logits, group by group (4 experts each): group 2
    holds the best expert (8) but a weak second, so it scores under
    groups 0 and 1 and is not kept."""
    z = torch.full((E,), -0.5)
    z[0:4] = torch.tensor([1.0, 1.0, -1.0, -1.0])      # top two: 1.462
    z[4:8] = torch.tensor([0.6, 0.5, 0.0, -2.0])       # 1.268
    z[8:12] = torch.tensor([3.0, -3.0, -3.0, -3.0])    # 1.000
    return z                                           # group 3: 0.755


def _route(bias):
    # the router is the identity: the token's logits are its input
    p = {"router": torch.eye(E), "router_bias": bias}
    return TL._route(_logits()[None], p, _router_cfg())


def test_noaux_tc_worked_example():
    s = torch.sigmoid(_logits())
    w, ids = _route(torch.zeros(E))
    assert sorted(ids[0].tolist()) == [0, 1, 4, 5]
    assert 8 not in ids[0].tolist()       # its group is not kept
    want = s[ids[0]] / s[ids[0]].sum() * 2.5
    torch.testing.assert_close(w[0], want, rtol=1e-6, atol=0)
    assert w.sum().item() == pytest.approx(2.5, rel=1e-6)


def test_bias_chooses_and_does_not_weight():
    s = torch.sigmoid(_logits())
    bias = torch.zeros(E)
    bias[6] = 0.2            # expert 6's 0.5 + 0.2 passes expert 5's 0.622
    w, ids = _route(bias)
    chosen = ids[0].tolist()
    assert sorted(chosen) == [0, 1, 4, 6]
    # the weights are the sigmoid scores without the bias
    want = s[ids[0]] / s[ids[0]].sum() * 2.5
    torch.testing.assert_close(w[0], want, rtol=1e-6, atol=0)
    assert w[0, chosen.index(6)].item() == pytest.approx(
        0.5 / s[[0, 1, 4, 6]].sum().item() * 2.5, rel=1e-6)
    # a bias large enough on an expert of a dropped group lifts its group
    bias = torch.zeros(E)
    bias[9] = 1.0
    _, ids = _route(bias)
    assert {8, 9} <= set(ids[0].tolist())


def _moe_params(rng, count, shared=True):
    d, f = 24, 8
    p = {"router": torch.from_numpy(rng.normal(size=(d, E)).astype(
             np.float32)) * 0.3,
         "router_bias": torch.from_numpy(rng.normal(size=E).astype(
             np.float32)) * 0.05}
    for name, shape in (("we_gate", (count, d, f)), ("we_up", (count, d, f)),
                        ("we_down", (count, f, d))):
        p[name] = torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)) * shape[1] ** -0.5
    if shared:
        for name, shape in (("shared_w_gate", (d, f)),
                            ("shared_w_up", (d, f)),
                            ("shared_w_down", (f, d))):
            p[name] = torch.from_numpy(rng.normal(size=shape).astype(
                np.float32)) * shape[0] ** -0.5
    return p


def test_shares_add_up_under_noaux_tc():
    rng = np.random.default_rng(0)
    cfg = dataclasses.replace(_router_cfg(), d_model=24, moe_d_ff=8,
                              n_shared_experts=1, capacity_factor=E / K)
    p = _moe_params(rng, E)
    x = torch.from_numpy(rng.normal(size=(2, 5, 24)).astype(np.float32))
    gamma = torch.ones(24)
    whole = TL.moe_apply(p, x, gamma, cfg)
    parts = torch.zeros_like(whole)
    for i in range(4):
        share = {k: (v[4 * i:4 * i + 4] if k.startswith("we_") else v)
                 for k, v in p.items()}
        parts += TL.moe_apply(share, x, gamma, dataclasses.replace(
            cfg, expert_share=(4 * i, 4)))
    xn = TCM.rms_norm(x, gamma, cfg.norm_eps).reshape(10, 24)
    shared = TL._shared_experts(p, xn).reshape(whole.shape)
    torch.testing.assert_close(parts - 3 * shared, whole, rtol=1e-5,
                               atol=1e-5)
    # each token's count of its assignments to the held experts, handed
    # back for the engine's count: the router's own choice, counted; then
    # the rows the padded products computed, held x capacity
    assigned = []
    held = dataclasses.replace(cfg, expert_share=(12, 4))
    TL.moe_apply(share, x, gamma, held, assigned)
    _, ids = TL._route(xn, p, cfg)
    assert len(assigned) == 1 and assigned[0].shape == (11,)
    assert torch.equal(assigned[0][:10], ((ids >= 12) & (ids < 16)).sum(-1))
    assert int(assigned[0][10]) == 4 * TL.moe_capacity(10, held)


YARN = TCM.Yarn(factor=40.0, original_max=4096, beta_fast=32.0,
                beta_slow=1.0, mscale=1.0, mscale_all_dim=1.0)


def test_yarn_range_and_factor():
    assert YARN.correction_range(64, 1e4) == (10, 23)
    assert YARN.cos_scale == 1.0
    assert YARN.softmax_factor == pytest.approx(
        (0.1 * math.log(40) + 1) ** 2, rel=1e-12)
    assert YARN.softmax_factor == pytest.approx(1.87386, abs=1e-5)
    plain = TCM.rope_frequencies(64, 1e4)
    yarn = TCM.rope_frequencies(64, 1e4, "cpu", YARN)
    assert torch.equal(yarn[:11], plain[:11])
    torch.testing.assert_close(yarn[23:], plain[23:] / 40, rtol=1e-6,
                               atol=0)
    between = yarn[11:23] / plain[11:23]
    assert ((between < 1) & (between > 1 / 40)).all()
    assert (between[1:] < between[:-1]).all()


def _mla_cfg(**over):
    return TCM.ModelConfig(d_model=64, n_heads=2, use_mla=True,
                           q_lora_rank=16, kv_lora_rank=16, qk_nope_dim=8,
                           qk_rope_dim=64, v_head_dim=8,
                           dtype=torch.float32, rope_factor=40.0,
                           rope_mscale_all_dim=1.0, **over)


def test_mla_scale_and_both_forms():
    cfg = _mla_cfg()
    assert cfg.yarn == YARN
    assert TL.mla_softmax_scale(cfg) == pytest.approx(
        72 ** -0.5 * 1.87386, rel=1e-5)
    assert TL.mla_softmax_scale(dataclasses.replace(
        cfg, rope_factor=1.0)) == 1.0 / 72 ** 0.5
    pb = TCM.ParamBuilder(np.random.default_rng(0), torch.float32, "cpu")
    p = TCM.init_mla(pb, cfg)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 12, 64)).astype(np.float32))
    full = TL.mla_apply(p, x, cfg)
    cache = TL.mla_init_cache(cfg, 1, 12, torch.float32, "cpu")
    pos = torch.arange(11)
    ckv, krope = TL.mla_kv_compressed(p, x[:, :11], cfg, pos)
    cache["ckv"][:, :11], cache["krope"][:, :11] = ckv, krope
    step, _ = TL.mla_decode(p, x[:, 11:], cache, torch.tensor([11]), cfg)
    torch.testing.assert_close(step[:, 0], full[:, 11], rtol=1e-5,
                               atol=1e-5)


def test_defaults_keep_softmax_and_plain_rope():
    cfg = TCM.ModelConfig(n_experts=8, top_k=2, dtype=torch.float32)
    assert cfg.yarn is None and cfg.router_score == "softmax"
    g = torch.Generator().manual_seed(0)
    xn, w = torch.randn(5, 16, generator=g), torch.randn(16, 8, generator=g)
    top_w, top_ids = TL._route(xn, {"router": w}, cfg)
    probs = torch.softmax(xn @ w, -1)
    want_w, want_ids = torch.topk(probs, 2)
    assert torch.equal(top_ids, want_ids)
    assert torch.equal(top_w, want_w / want_w.sum(-1, keepdim=True))
    x = torch.randn(2, 3, 7, 16, generator=g)
    pos = torch.arange(7)
    freqs = 1.0 / (1e4 ** (torch.arange(0, 16, 2, dtype=torch.float32)
                           / 16))
    ang = pos[:, None].float() * freqs
    x1, x2 = x.chunk(2, -1)
    want = torch.cat([x1 * ang.cos() - x2 * ang.sin(),
                      x1 * ang.sin() + x2 * ang.cos()], -1)
    assert torch.equal(TCM.apply_rope(x, pos, 1e4), want)
    assert "router_bias" not in TCM.init_moe(
        TCM.ParamBuilder(np.random.default_rng(0), torch.float32, "meta"),
        dataclasses.replace(cfg, moe_d_ff=4))
