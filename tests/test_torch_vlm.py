"""The port's VLM (internvl2-26b) against the JAX reference on the same
weights.

* its config, full and reduced, equals the reference's field for field
  (``n_vision_tokens`` 256, cut to 16);
* at reduced size (2 layers), on the reference's weights carried over by
  ``LM.from_jax_params`` and seeded vision embeddings, ``forward`` (with
  and without the vision prefix), ``prefill`` (logits and the K/V cache,
  which holds the vision positions) and decode steps after it, and
  ``loss`` match the reference within 1e-4 (float32);
* on the hand-kernel impls (``cuda``; their plain versions on CPU
  tensors) ``forward`` with the vision prefix matches the reference's
  ``interpret`` impls within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_cpu import reference_on_cpu  # noqa: F401
from repro import configs as JC
from repro.models.lm import LM as JLM
from repro_torch import configs as TC
from repro_torch.models.lm import LM as TLM
from torch_port import reference_fields

TOL = 1e-4
ARCH = "internvl2-26b"
N_LAYERS = 2


def test_config_matches_reference():
    for get in ("get_config", "get_reduced_config"):
        port, ref = getattr(TC, get)(ARCH), getattr(JC, get)(ARCH)
        for name, value in reference_fields(port).items():
            assert value == getattr(ref, name), (get, name)
    full = TC.get_config(ARCH)
    assert (full.family, full.n_vision_tokens, full.d_model,
            full.d_head) == ("vlm", 256, 6144, 128)
    assert full.remat and not TC.get_reduced_config(ARCH).remat
    assert TC.get_reduced_config(ARCH).n_vision_tokens == 16


@pytest.fixture(scope="module")
def pair():
    jcfg = JC.get_reduced_config(ARCH, n_layers=N_LAYERS)
    jm = JLM(jcfg)
    params, _ = jm.init_params(jax.random.key(2))
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab, (2, 12)).astype(np.int32)
    vis = rng.normal(size=(2, jcfg.n_vision_tokens, jcfg.d_model)).astype(
        np.float32)
    return jm, tree, toks, vis


def _port(tree, **impls):
    cfg = dataclasses.replace(TC.get_reduced_config(ARCH, n_layers=N_LAYERS),
                              **impls)
    tm = TLM(cfg)
    return tm, tm.from_jax_params(tree, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("with_vision", [True, False])
def test_forward_matches_reference(pair, with_vision):
    jm, tree, toks, vis = pair
    jvis = jnp.asarray(vis) if with_vision else None
    want = jm.forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(toks),
                      jvis)
    tm, tp = _port(tree)
    got = tm.forward(tp, torch.from_numpy(toks),
                     torch.from_numpy(vis) if with_vision else None)
    assert got.shape == want.shape
    _close(got, want)


def test_prefill_and_decode_after_the_vision_prefix_match_reference(pair):
    jm, tree, toks, vis = pair
    jp = jax.tree.map(jnp.asarray, tree)
    p0, nv = 8, vis.shape[1]
    max_len = nv + toks.shape[1]
    lg, cache = jm.prefill(jp, jnp.asarray(toks[:, :p0]), max_len=max_len,
                           vision_embeds=jnp.asarray(vis))
    tm, tp = _port(tree, attn_impl="chunked")
    with torch.no_grad():
        got, tcache = tm.prefill(tp, torch.from_numpy(toks[:, :p0]),
                                 max_len=max_len,
                                 vision_embeds=torch.from_numpy(vis))
        _close(got, lg)
        _close(tcache["k"], cache["stage0"]["sub0"]["k"])
        _close(tcache["v"], cache["stage0"]["sub0"]["v"])
        for i in range(toks.shape[1] - p0):
            tok = toks[:, p0 + i:p0 + i + 1]
            lg, cache = jm.decode_step(jp, cache, jnp.asarray(tok),
                                       nv + p0 + i)
            got, tcache = tm.decode_step(tp, tcache, torch.from_numpy(tok),
                                         nv + p0 + i)
            _close(got, lg)


def test_loss_matches_reference(pair):
    jm, tree, toks, vis = pair
    labels = np.roll(toks, -1, axis=1)
    want = float(jm.loss(jax.tree.map(jnp.asarray, tree), jnp.asarray(toks),
                         jnp.asarray(labels), jnp.asarray(vis)))
    tm, tp = _port(tree)
    got = tm.loss(tp, torch.from_numpy(toks), torch.from_numpy(labels),
                  torch.from_numpy(vis)).item()
    assert abs(got - want) <= 1e-5 * abs(want)


def test_hand_kernel_forward_matches_reference_interpret(pair):
    jm, tree, toks, vis = pair
    jcfg = dataclasses.replace(jm.cfg, attn_impl="interpret",
                               mlp_impl="interpret")
    want = JLM(jcfg).forward(jax.tree.map(jnp.asarray, tree),
                             jnp.asarray(toks), jnp.asarray(vis))
    tm, tp = _port(tree, attn_impl="cuda", mlp_impl="cuda")
    with torch.no_grad():
        got = tm.forward(tp, torch.from_numpy(toks), torch.from_numpy(vis))
    _close(got, want)
