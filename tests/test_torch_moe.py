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
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import common as JCM
from repro.models import layers as JL
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
