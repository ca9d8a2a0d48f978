"""One chip's share of an expert-parallel MoE layer
(``models.layers.moe_apply`` on a config whose ``expert_share`` is
(first, count), the local half of the reference's ``_moe_apply_sharded``,
layers.py:533) against
the whole layer and the JAX reference, on seeded numpy weights, float32:

* the outputs of every share of the experts (1 x 4, 2 x 2, 4 x 1 shares of
  4; 16 experts in 4 shares of 4, jamba's router), summed with the shared
  expert counted once, equal the whole layer's and the reference's
  ``moe_apply`` within 1e-5, at ``capacity_factor`` 8.0 and at 1.25 with
  drops forced by a skewed router;
* a share drops exactly what the whole layer drops: its capacity is the
  whole layer's (``moe_capacity`` over all ``n_experts``), and each of its
  experts' kept assignments are the whole layer's;
* holding every expert, the layer is bit for bit the unsharded layer
  before shares existed (a frozen copy below);
* ``expert_share`` on the config: ``init_params`` draws only the held
  experts' stacks, at the whole layer's scale, ``from_jax_params`` cuts the reference's stacks to
  them, and a share that the weights do not hold raises.
"""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as JCM
from repro.models import layers as JL
from repro_torch import configs as TC
from repro_torch.kernels import ref as R
from repro_torch.models import common as TCM
from repro_torch.models import layers as TL
from repro_torch.models.lm import LM as TLM
import torch_port  # noqa: F401

TOL = 1e-5
D, K, FF = 32, 2, 16


def _cfgs(e, cf, shared=0):
    fields = dict(family="moe", d_model=D, n_experts=e, top_k=K,
                  moe_d_ff=FF, n_layers=1, norm_eps=1e-6,
                  capacity_factor=cf, n_shared_experts=shared)
    return (JCM.ModelConfig(dtype=jnp.float32, **fields),
            TCM.ModelConfig(dtype=torch.float32, **fields))


def _params(seed, e, shared=0, skew=0.0):
    """Seeded weights and inputs; ``skew`` adds a bias toward expert 0 to
    every token's router logits, so that expert overflows its capacity."""
    rng = np.random.default_rng(seed)
    p = {"router": rng.normal(size=(D, e)) * 0.5,
         "we_gate": rng.normal(size=(e, D, FF)) * D ** -0.5,
         "we_up": rng.normal(size=(e, D, FF)) * D ** -0.5,
         "we_down": rng.normal(size=(e, FF, D)) * FF ** -0.5}
    if shared:
        p.update(shared_w_gate=rng.normal(size=(D, FF)) * D ** -0.5,
                 shared_w_up=rng.normal(size=(D, FF)) * D ** -0.5,
                 shared_w_down=rng.normal(size=(FF, D)) * FF ** -0.5)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 24, D)).astype(np.float32)
    x[..., 0] += skew
    p["router"][0, 0] += skew
    gamma = (1.0 + 0.1 * rng.normal(size=(D,))).astype(np.float32)
    return p, x, gamma


def _torch(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _share(p, first, count):
    return {k: (v[first:first + count] if k.startswith("we_") else v)
            for k, v in p.items()}


def _shared_part(p, x, gamma, cfg):
    xn = TCM.rms_norm(x, gamma, cfg.norm_eps)
    return TL._shared_experts(p, xn.reshape(-1, D)).reshape(x.shape)


def _kept(p, x, gamma, cfg):
    b, s, d = x.shape
    xn = TCM.rms_norm(x, gamma, cfg.norm_eps).reshape(b * s, d)
    _, ids = TL._route(xn, p, cfg)
    keep, _ = TL.moe_dispatch(ids, TL.moe_capacity(b * s, cfg),
                              cfg.n_experts)
    return ids, keep


@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared"])
@pytest.mark.parametrize("cf,skew", [(8.0, 0.0), (1.25, 3.0)],
                         ids=["no-drops", "drops"])
@pytest.mark.parametrize("e,shares", [(4, 1), (4, 2), (4, 4), (16, 4)])
def test_shares_sum_to_the_whole_layer_and_the_reference(e, shares, cf,
                                                         skew, shared):
    jcfg, tcfg = _cfgs(e, cf, shared)
    p, x, gamma = _params(e + shares, e, shared, skew)
    tp, tx, tg = _torch(p), torch.from_numpy(x), torch.from_numpy(gamma)
    whole = TL.moe_apply(tp, tx, tg, tcfg)
    count = e // shares
    parts = [TL.moe_apply(_share(tp, i * count, count), tx, tg,
                          dataclasses.replace(
                              tcfg, expert_share=(i * count, count)))
             for i in range(shares)]
    total = sum(parts)
    if shared:
        total = total - (shares - 1) * _shared_part(tp, tx, tg, tcfg)
    np.testing.assert_allclose(total.numpy(), whole.numpy(), rtol=TOL,
                               atol=TOL)
    want = np.asarray(JL.moe_apply({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x), jnp.asarray(gamma), jcfg))
    np.testing.assert_allclose(total.numpy(), want, rtol=TOL, atol=TOL)
    _, keep = _kept(tp, tx, tg, tcfg)
    if cf == 8.0:
        assert keep.all()
    else:
        assert 0 < (~keep).sum() < keep.numel()


def _frozen_moe_apply(p, x, gamma, cfg):
    """The unsharded layer as it was before shares existed."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xn = TCM.rms_norm(x, gamma, cfg.norm_eps).reshape(t, d)
    top_w, top_ids = TL._route(xn, p, cfg)
    capacity = TL.moe_capacity(t, cfg)
    keep, slot = TL.moe_dispatch(top_ids, capacity, e)
    slot = slot.reshape(-1)
    updates = xn.repeat_interleave(k, 0) * keep.reshape(-1, 1).to(xn.dtype)
    buf = torch.zeros(e * capacity, d, dtype=xn.dtype, device=x.device)
    buf.index_add_(0, slot, updates)
    eb = buf.reshape(e, capacity, d)
    h = R.swish(torch.bmm(eb, p["we_gate"])) * torch.bmm(eb, p["we_up"])
    eo = torch.bmm(h, p["we_down"]).reshape(e * capacity, d)
    routed = eo[slot].reshape(t, k, d)
    w = (top_w * keep).to(routed.dtype)
    out = torch.einsum("tkd,tk->td", routed, w)
    if cfg.n_shared_experts:
        out = out + TL._shared_experts(p, xn)
    return out.reshape(b, s, d).to(x.dtype)


@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared"])
@pytest.mark.parametrize("cf,skew", [(8.0, 0.0), (1.25, 3.0)],
                         ids=["no-drops", "drops"])
def test_every_expert_held_is_the_unsharded_layer_bit_for_bit(cf, skew,
                                                              shared):
    _, tcfg = _cfgs(8, cf, shared)
    p, x, gamma = _params(5, 8, shared, skew)
    args = (_torch(p), torch.from_numpy(x), torch.from_numpy(gamma), tcfg)
    want = _frozen_moe_apply(*args)
    assert torch.equal(TL.moe_apply(*args), want)
    held = dataclasses.replace(tcfg, expert_share=(0, 8))
    assert torch.equal(TL.moe_apply(*args[:3], held), want)


def test_a_share_drops_what_the_whole_layer_drops():
    """jamba's router (16 experts, top-2) at the published capacity factor
    1.25: a share of 4 keeps, for its experts, exactly the whole layer's
    assignments, at the whole layer's capacity; a capacity taken over the
    4 held experts would keep more."""
    e, count = 16, 4
    _, tcfg = _cfgs(e, 1.25)
    p, x, gamma = _params(7, e, skew=3.0)
    tp, tx, tg = _torch(p), torch.from_numpy(x), torch.from_numpy(gamma)
    t = x.shape[0] * x.shape[1]
    cap = TL.moe_capacity(t, tcfg)
    assert cap == math.ceil(t * K * 1.25 / e) < math.ceil(t * K * 1.25
                                                          / count)
    ids, keep = _kept(tp, tx, tg, tcfg)
    assert (~keep).any()
    for first in range(0, e, count):
        held = (ids >= first) & (ids < first + count)
        out = TL.moe_apply(_share(tp, first, count), tx, tg,
                           dataclasses.replace(
                               tcfg, expert_share=(first, count)))
        # the share's output from its kept assignments alone, expert by
        # expert, with the whole layer's router weights
        xn = TCM.rms_norm(tx, tg, tcfg.norm_eps).reshape(t, D)
        top_w, _ = TL._route(xn, tp, tcfg)
        want = torch.zeros(t, D)
        for j in range(first, first + count):
            he = R.swish(xn @ tp["we_gate"][j]) * (xn @ tp["we_up"][j])
            wj = torch.where((ids == j) & keep & held, top_w, 0.0).sum(-1)
            want += (he @ tp["we_down"][j]) * wj[:, None]
        np.testing.assert_allclose(out.reshape(t, D).numpy(), want.numpy(),
                                   rtol=TOL, atol=TOL)


def test_share_weights_on_the_config():
    cfg = dataclasses.replace(TC.get_reduced_config("jamba-1.5-large-398b"),
                              n_experts=16, expert_share=(4, 4))
    assert cfg.held_experts == (4, 4)
    tp = TLM(cfg).init_params(seed=0, device="cpu")
    moe = tp["layers"][1]["mlp"]
    assert moe["router"].shape == (cfg.d_model, 16)
    assert moe["we_gate"].shape == (4, cfg.d_model, cfg.moe_d_ff)
    assert moe["we_down"].shape == (4, cfg.moe_d_ff, cfg.d_model)
    # drawn at the whole layer's scale: the reference's stack of all 16
    # has fan-in 16 (its leading dim)
    for name in ("we_gate", "we_up", "we_down"):
        assert abs(moe[name].std().item() - 16 ** -0.5) < 0.01, name
    # a tree of the reference's layout holding all 16 experts' stacks,
    # cut to experts 4..7
    rng = np.random.default_rng(0)

    def stacked(a, e=None):
        shape = list(a.shape)
        if e is not None:
            shape[0] = e
        return rng.normal(size=[1] + shape).astype(np.float32)

    tree = {"embed": stacked(tp["embed"])[0], "ln_f": stacked(tp["ln_f"])[0],
            "stage0": {f"sub{j}": {
                name: ({k: stacked(v, 16 if k.startswith("we_") else None)
                        for k, v in part.items()}
                       if isinstance(part, dict) else stacked(part))
                for name, part in layer.items()}
                for j, layer in enumerate(tp["layers"])}}
    got = TLM(cfg).from_jax_params(tree, device="cpu")
    np.testing.assert_array_equal(
        got["layers"][3]["mlp"]["we_up"].numpy(),
        tree["stage0"]["sub3"]["mlp"]["we_up"][0, 4:8])
    x = torch.zeros(1, 3, cfg.d_model)
    with pytest.raises(ValueError, match="the weights hold"):
        TL.moe_apply(moe, x, torch.ones(cfg.d_model),
                     dataclasses.replace(cfg, expert_share=(0, 8)))
