"""The port's MoE layer against the JAX reference on the same inputs.

``models.layers.moe_apply`` (the reference's unsharded ``moe_apply``:
router softmax in float32, top-k, renormalised weights, per-expert
capacity ``min(T, max(1, ceil(T k cf / E)))`` in the flattened (token, k)
order, drops scattered as zeros, a weighted combine) and ``moe_ref`` (the
dense per-expert oracle) on seeded numpy weights and tokens, within 1e-5
(float32):

* at ``capacity_factor`` 8.0 nothing is dropped, and the layer equals the
  oracle;
* at 1.25 with enough tokens some assignments are dropped, and the port
  drops exactly the reference's (the reference's own routing and
  prefix-count ops, run on the same inputs) and matches its output;
* shared experts add their SwiGLU to every token.

The grouped expert path (the card's, ``kernels/grouped_experts.py``, run
here as its plain version) against the padded products on the same
routing: the grouped dispatch's row counts and table against
``moe_dispatch``'s slots, and the engine's ``moe_rows`` as the rows the
kernel computed.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as JCM
from repro.models import layers as JL
from repro_torch.kernels import grouped_experts as GE
from repro_torch.models import common as TCM
from repro_torch.models import layers as TL
import torch_port  # noqa: F401

TOL = 1e-5
D, E, K, F = 64, 8, 2, 32


def _cfgs(**over):
    fields = dict(family="moe", d_model=D, n_experts=E, top_k=K, moe_d_ff=F,
                  n_layers=1, norm_eps=1e-6)
    fields.update(over)
    return (JCM.ModelConfig(dtype=jnp.float32, **fields),
            TCM.ModelConfig(dtype=torch.float32, **fields))


def _params(seed, shared=0, e=E):
    rng = np.random.default_rng(seed)
    p = {"router": rng.normal(size=(D, e)) * 0.5,
         "we_gate": rng.normal(size=(e, D, F)) * D ** -0.5,
         "we_up": rng.normal(size=(e, D, F)) * D ** -0.5,
         "we_down": rng.normal(size=(e, F, D)) * F ** -0.5}
    if shared:
        f = F * shared
        p.update(shared_w_gate=rng.normal(size=(D, f)) * D ** -0.5,
                 shared_w_up=rng.normal(size=(D, f)) * D ** -0.5,
                 shared_w_down=rng.normal(size=(f, D)) * f ** -0.5)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 24, D)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.normal(size=(D,))).astype(np.float32)
    return p, x, gamma


def _both(fn_j, fn_t, p, x, gamma, jcfg, tcfg):
    want = np.asarray(fn_j({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x), jnp.asarray(gamma), jcfg))
    got = fn_t({k: torch.from_numpy(v) for k, v in p.items()},
               torch.from_numpy(x), torch.from_numpy(gamma), tcfg)
    return got.numpy(), want


def _reference_keep(p, x, gamma, cfg):
    """Which (token, k) assignments the reference keeps: its
    ``moe_apply``'s routing and prefix-count lines (layers.py:485-500)
    on the same inputs."""
    b, s, d = x.shape
    t, e, k = b * s, cfg.n_experts, cfg.top_k
    xn = JCM.rms_norm(jnp.asarray(x), jnp.asarray(gamma),
                      cfg.norm_eps).reshape(t, d)
    probs = jax.nn.softmax(xn @ jnp.asarray(p["router"]), axis=-1)
    _, top_ids = jax.lax.top_k(probs, k)
    cap = int(min(t, max(1, math.ceil(t * k * cfg.capacity_factor / e))))
    flat = jax.nn.one_hot(top_ids, e, dtype=jnp.int32).reshape(t * k, e)
    pos = jax.lax.associative_scan(jnp.add, flat, axis=0) - flat
    return np.asarray((pos * flat).sum(-1).reshape(t, k) < cap)


def _port_keep(p, x, gamma, cfg):
    """The port's kept assignments (``moe_dispatch`` of its routing)."""
    b, s, d = x.shape
    xn = TCM.rms_norm(torch.from_numpy(x), torch.from_numpy(gamma),
                      cfg.norm_eps).reshape(b * s, d)
    _, ids = TL._route(xn, {"router": torch.from_numpy(p["router"])}, cfg)
    keep, _ = TL.moe_dispatch(ids, TL.moe_capacity(b * s, cfg),
                              cfg.n_experts)
    return keep.numpy()


@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared"])
def test_moe_apply_matches_reference_without_drops(shared):
    jcfg, tcfg = _cfgs(capacity_factor=8.0, n_shared_experts=shared)
    p, x, gamma = _params(0, shared)
    got, want = _both(JL.moe_apply, TL.moe_apply, p, x, gamma, jcfg, tcfg)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert _port_keep(p, x, gamma, tcfg).all()
    oracle, _ = _both(JL.moe_ref, TL.moe_ref, p, x, gamma, jcfg, tcfg)
    np.testing.assert_allclose(got, oracle, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_moe_apply_drops_what_the_reference_drops(seed):
    """capacity_factor 1.25: 48 tokens x top-2 over 8 experts leave each
    expert 15 slots, and the router's scale makes some experts popular."""
    jcfg, tcfg = _cfgs(capacity_factor=1.25)
    p, x, gamma = _params(seed)
    keep = _port_keep(p, x, gamma, tcfg)
    np.testing.assert_array_equal(keep, _reference_keep(p, x, gamma, jcfg))
    assert 0 < (~keep).sum() < keep.size
    got, want = _both(JL.moe_apply, TL.moe_apply, p, x, gamma, jcfg, tcfg)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # a token that lost an expert differs from the drop-free oracle
    oracle, _ = _both(JL.moe_ref, TL.moe_ref, p, x, gamma, jcfg, tcfg)
    lost = ~keep.all(-1).reshape(x.shape[:2])
    assert not np.allclose(got[lost], oracle[lost], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got[~lost], oracle[~lost], rtol=TOL, atol=TOL)


def test_moe_ref_matches_reference_oracle():
    jcfg, tcfg = _cfgs(top_k=3, n_shared_experts=2)
    p, x, gamma = _params(4, shared=2)
    got, want = _both(JL.moe_ref, TL.moe_ref, p, x, gamma, jcfg, tcfg)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("shape", [(4, 1), (1, 8)],
                         ids=["decode4", "prefill8"])
def test_moe_apply_matches_reference_at_capacity_one(shape):
    """qwen3-moe's routing (E 128, top-8, cf 1.25) at the engine's shapes:
    a 4-token decode step and an 8-token prefill bucket leave each expert
    one slot, so of two tokens that pick an expert the later in (token, k)
    order is dropped; the port drops the same ones."""
    from repro_torch import configs as TC
    full = TC.get_config("qwen3-moe-30b-a3b")
    e, k, cf = full.n_experts, full.top_k, full.capacity_factor
    jcfg, tcfg = _cfgs(n_experts=e, top_k=k, capacity_factor=cf)
    assert TL.moe_capacity(shape[0] * shape[1], tcfg) == 1
    p, x, gamma = _params(7, e=e)         # drops at both shapes
    x = x.reshape(-1, D)[:shape[0] * shape[1]].reshape(*shape, D)
    keep = _port_keep(p, x, gamma, tcfg)
    np.testing.assert_array_equal(keep, _reference_keep(p, x, gamma, jcfg))
    assert not keep.all()
    got, want = _both(JL.moe_apply, TL.moe_apply, p, x, gamma, jcfg, tcfg)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# -- the grouped expert path (kernels/grouped_experts.py) --------------------
# The held experts on only the rows routed to them: the kernel's plain
# version (what CPU tensors run: the grouped dispatch, the experts on their
# rows, the combine), held against the padded products of
# ``_held_experts_out`` on the same routing.

GD, GF = 48, 24       # a scaled-down width


def _grouped_case(case, rng):
    """``(xn, top_w, top_ids, capacity, base, count, n_experts)`` of each
    case: deepseek's ``noaux_tc`` router at T = 32 over 64 experts (8
    held), a held expert no token picks, one held expert on every token
    (its rows fill its capacity), every expert held, a 256-token prefill,
    and a capacity under the demand (assignments dropped)."""
    t, e, k, base, count, cf = 32, 64, 8, 8, 8, 8.0
    if case == "prefill256":
        t = 256
    elif case == "all_held":
        e, k, base, count = 16, 4, 0, 16
    elif case == "drops":
        cf = 1.0
    xn = torch.from_numpy(rng.normal(size=(t, GD)).astype(np.float32))
    if case in ("noaux_tc", "prefill256", "drops"):
        cfg = TCM.ModelConfig(family="moe", d_model=GD, n_experts=e, top_k=k,
                              router_score="sigmoid", router_groups=8,
                              router_groups_kept=4, routed_scale=2.5,
                              dtype=torch.float32)
        p = {"router": torch.from_numpy(rng.normal(size=(GD, e)).astype(
                 np.float32)) * 0.3,
             "router_bias": torch.from_numpy(rng.normal(size=e).astype(
                 np.float32)) * 0.05}
        top_w, top_ids = TL._route(xn, p, cfg)
    else:
        top_ids = torch.from_numpy(np.stack(
            [rng.choice(e, k, replace=False) for _ in range(t)]))
        if case == "empty":
            top_ids[(top_ids >= base) & (top_ids < base + 2)] = 0
        elif case == "one_takes_all":
            top_ids[:, 0] = base + 3
            top_ids[:, 1:][top_ids[:, 1:] == base + 3] = 0
        top_w = torch.from_numpy(rng.random((t, k)).astype(np.float32))
    capacity = int(min(t, max(1, math.ceil(t * k * cf / e))))
    return xn, top_w, top_ids, capacity, base, count, e


def _grouped_weights(rng, count):
    return {name: torch.from_numpy(rng.normal(size=shape).astype(
                np.float32)) * shape[1] ** -0.5
            for name, shape in (("we_gate", (count, GD, GF)),
                                ("we_up", (count, GD, GF)),
                                ("we_down", (count, GF, GD)))}


@pytest.mark.parametrize("case", ["noaux_tc", "empty", "one_takes_all",
                                  "all_held", "prefill256", "drops"])
def test_grouped_path_matches_padded_path(case):
    """The kernel's plain version gives what the padded products give,
    within 1e-5; each held expert's rows are its kept assignments in
    ``moe_dispatch``'s slot order."""
    rng = np.random.default_rng(31)
    xn, top_w, top_ids, cap, base, count, e = _grouped_case(case, rng)
    p = _grouped_weights(rng, count)
    t, k = top_ids.shape
    want = TL._held_experts_out(p, xn, top_w, top_ids, cap, base, count, e)
    got, n, counts = GE.grouped_moe_cuda(xn, top_w, top_ids, p["we_gate"],
                                         p["we_up"], p["we_down"], base,
                                         cap)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    assert got.abs().max() > 0.1
    mask = (top_ids >= base) & (top_ids < base + count)
    assert counts.shape == (t + 1,)
    assert torch.equal(counts[:t], mask.sum(-1))
    assert int(counts[t]) == int(n.sum())
    # the table: each kept held assignment in its moe_dispatch slot
    keep, slot = TL.moe_dispatch(top_ids, cap, e)
    keep = keep & mask
    n2, table, held2, keep2 = GE.dispatch(top_ids, cap, base, count)
    assert torch.equal(n2, n) and torch.equal(keep2, keep)
    assert torch.equal(held2, mask)
    assert n.dtype == table.dtype == torch.int32 and table.shape == (count,
                                                                     cap)
    want_table = torch.full((count * cap,), -1, dtype=torch.int32)
    want_table[slot[keep] - base * cap] = torch.arange(
        t * k, dtype=torch.int32).view(t, k)[keep]
    assert torch.equal(table.reshape(-1), want_table)
    counts = torch.bincount((top_ids[mask] - base).reshape(-1),
                            minlength=count)
    assert torch.equal(n.long(), counts.clamp(max=cap))
    if case == "empty":
        assert n[0] == n[1] == 0 and n[2:].sum() > 0
    elif case == "one_takes_all":
        assert n[3] == t == cap
    elif case == "drops":
        assert (counts > cap).any()
    elif case == "all_held":
        assert count == e and mask.all()
    # the plain experts write zeros in every slot no held expert computes
    slots = GE.experts(xn, p["we_gate"], p["we_up"], p["we_down"], n, table,
                       k)
    assert (slots[~keep.reshape(-1)] == 0).all()
    assert int(n.sum()) == int(keep.sum())


def test_grouped_kernel_rows_are_the_ticks_moe_rows(monkeypatch):
    """With the held experts on the grouped expert kernel (its plain
    version here), each decoding tick's ``moe_rows`` is the rows the
    kernel computed, summed over the MoE layers inside the decode step:
    Σ_e n[e] over the layers (a tile computes exactly its rows, so
    round_up(n[e], 1)), from the router's own choice, not held x
    capacity."""
    import dataclasses

    from repro_torch import tracing as T
    from repro_torch.launch import serve as S
    from repro_torch.launch.engine import Engine

    monkeypatch.setattr(T, "TRACER", T.Tracer())
    cfg = S.ServeConfig(arch="qwen3-moe-30b-a3b", reduced=True, n_layers=2,
                        backend="cuda", device="cpu", max_batch=3,
                        max_len=48, prompt_buckets=(8, 16), n_requests=5,
                        arrival_rate=1.5, prompt_lens=(3, 14),
                        gen_lens=(2, 6), seed=5)
    mc = S.model_config(cfg)
    base, count = mc.n_experts // 4, mc.n_experts // 2
    mc = dataclasses.replace(mc, expert_share=(base, count))
    engine = Engine(mc, device="cpu", max_batch=cfg.max_batch,
                    max_len=cfg.max_len, prompt_buckets=cfg.prompt_buckets,
                    seed=cfg.seed)
    engine.warmup()
    chosen, route = [], TL._route

    def routed(xn, p, c):
        w, ids = route(xn, p, c)
        chosen.append(ids)
        return w, ids

    monkeypatch.setattr(TL, "_route", routed)
    monkeypatch.setattr(TL, "_takes_grouped", lambda p, xn, ids, e: True)
    report = engine.run(S.trace_for(cfg, mc.vocab))
    assert report.n_completed == cfg.n_requests
    layers = sum(mc.mlp_of(i) == "moe" for i in range(mc.n_layers))
    b = cfg.max_batch
    cap = TL.moe_capacity(b, mc)
    decode = [ids for ids in chosen if ids.shape[0] == b]
    ticks = [s for s in T.TRACER.spans if s.name == "tick"
             and s.attrs["n_decode"]]
    assert ticks and len(decode) == layers * len(ticks)
    padded = layers * count * cap           # the padded products' rows
    for i, tick in enumerate(ticks):
        want = 0
        for ids in decode[i * layers:(i + 1) * layers]:
            n, _, _, _ = GE.dispatch(ids, cap, base, count)
            want += int(n.sum())
        assert tick.attrs["moe_rows"] == want < padded
