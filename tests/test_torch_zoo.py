"""The port's dense and MoE zoo against the JAX reference.

For llama3.2-1b, qwen2-7b (q/k/v bias), qwen3-32b (per-head q/k RMSNorm)
and qwen3-moe-30b-a3b (128 experts, top-8):

* the configs, full and reduced, equal the reference's field for field;
* ``qkv`` with non-zero biases and non-trivial q/k norm gains equals the
  reference's ``_qkv`` (1e-5);
* at reduced size (2 layers), on the reference's own weights carried over
  by ``LM.from_jax_params`` (biases, norm gains and layer norms set to
  seeded non-trivial values first: at init they are zeros and ones, which
  would hide a missing bias or gain), forward logits, prefill logits and
  cache, and every ragged decode step's logits equal the reference's
  (pipeline impls, backend ``jax``) within 1e-4 on the port's ``torch``
  and ``cuda`` pipeline backends (the latter's plain versions on CPU
  tensors); forward on the hand-kernel impls (``cuda``/``cuda``, plain
  versions on CPU tensors) equals the reference's ``interpret`` impls.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro import pipeline as JP
from repro.models import layers as JL
from repro.models.lm import LM as JLM
from repro_torch import configs as TC
from repro_torch.models import layers as TL
from repro_torch.models.lm import LM as TLM
from torch_port import reference_fields

TOL = 1e-4
N_LAYERS = 2
ARCHS = ["llama3.2-1b", "qwen2-7b", "qwen3-32b", "qwen3-moe-30b-a3b"]
#: parameters the reference initialises to zeros or ones
TRIVIAL = ("bq", "bk", "bv", "q_norm", "k_norm", "ln1", "ln2", "ln_f")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    for get in ("get_config", "get_reduced_config"):
        port, ref = getattr(TC, get)(arch), getattr(JC, get)(arch)
        for name, value in reference_fields(port).items():
            assert value == getattr(ref, name), (get, name)
        assert [port.is_moe_layer(i) for i in range(port.n_layers)] == [
            ref.is_moe_layer(i) for i in range(ref.n_layers)]
    assert TC.get_reduced_config(arch).dtype == torch.float32


def _nontrivial(tree, seed):
    """The numpy tree with every zero- or one-initialised parameter set
    to seeded values around its init."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in TRIVIAL:
                base = 0.0 if k.startswith("b") else 1.0
                out[k] = (base + 0.1 * rng.normal(size=v.shape)).astype(
                    np.float32)
            else:
                out[k] = np.asarray(v, np.float32)
        return out

    return walk(tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_qkv_with_bias_and_qk_norm_matches_reference(arch):
    jcfg = JC.get_reduced_config(arch)
    tcfg = TC.get_reduced_config(arch)
    d, h, hkv, dh = (tcfg.d_model, tcfg.n_heads, tcfg.n_kv_heads,
                     tcfg.d_head)
    rng = np.random.default_rng(3)
    p = {"wq": rng.normal(size=(d, h * dh)) * d ** -0.5,
         "wk": rng.normal(size=(d, hkv * dh)) * d ** -0.5,
         "wv": rng.normal(size=(d, hkv * dh)) * d ** -0.5,
         "bq": rng.normal(size=(h * dh,)), "bk": rng.normal(size=(hkv * dh,)),
         "bv": rng.normal(size=(hkv * dh,)),
         "q_norm": 1.0 + 0.2 * rng.normal(size=(dh,)),
         "k_norm": 1.0 + 0.2 * rng.normal(size=(dh,))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 7, d)).astype(np.float32)
    pos = np.arange(7)
    want = JL._qkv({k: jnp.asarray(v) for k, v in p.items()},
                   jnp.asarray(x), jcfg, jnp.asarray(pos))
    got = TL.qkv({k: torch.from_numpy(v) for k, v in p.items()},
                 torch.from_numpy(x), tcfg, torch.from_numpy(pos))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    # the bias and the gains take part where the config has them
    plain = TL.qkv({k: torch.from_numpy(p[k]) for k in ("wq", "wk", "wv")},
                   torch.from_numpy(x), dataclasses.replace(
                       tcfg, qkv_bias=False, qk_norm=False),
                   torch.from_numpy(pos))
    same = torch.allclose(got[0], plain[0], atol=1e-5)
    assert same == (not tcfg.qkv_bias and not tcfg.qk_norm)


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.fixture(scope="module", params=ARCHS)
def reference(request, tmp_path_factory):
    """The reference LM (pipeline impls, backend ``jax``), its weights
    made non-trivial, and its logits on a forward pass, a prefill and
    every ragged decode step after it."""
    arch = request.param
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_KERNEL_CACHE", str(tmp_path_factory.mktemp("kernels")))
    JP.reset_default_cache()
    try:
        cfg = JC.with_pipeline(JC.get_reduced_config(arch,
                                                     n_layers=N_LAYERS),
                               options=JP.CompileOptions(backend="jax"))
        model = JLM(cfg)
        params, _ = model.init_params(jax.random.key(0))
        tree = _nontrivial(jax.tree.map(np.asarray, params), seed=11)
        jp = jax.tree.map(jnp.asarray, tree)
        toks = _tokens((2, 14), cfg.vocab, seed=1)
        out = {"arch": arch, "tree": tree, "toks": toks,
               "forward": np.asarray(model.forward(
                   jp, jnp.asarray(toks, jnp.int32)))}
        b, p0, max_len = 2, 8, 14
        lg, cache = model.prefill(jp, jnp.asarray(toks[:, :p0], jnp.int32),
                                  max_len=max_len)
        out["prefill"] = np.asarray(lg)
        out["cache_k"] = np.asarray(cache["stage0"]["sub0"]["k"])
        steps, pos = [], jnp.asarray([p0, p0 - 3], jnp.int32)
        for i in range(max_len - p0):
            tok = jnp.asarray(toks[:, p0 + i:p0 + i + 1], jnp.int32)
            lg, cache = model.decode_step(jp, cache, tok, pos + i)
            steps.append(np.asarray(lg))
        out["decode"] = steps
        yield out
    finally:
        mp.undo()
        JP.reset_default_cache()


def _port(arch, tree, **impls):
    cfg = TC.get_reduced_config(arch, n_layers=N_LAYERS)
    cfg = dataclasses.replace(cfg, **impls)
    model = TLM(cfg)
    return model, model.from_jax_params(tree, device="cpu")


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_forward_prefill_and_ragged_decode_match_reference(backend,
                                                           reference):
    ref = reference
    tm, tp = _port(ref["arch"], ref["tree"], attn_impl="pipeline",
                   mlp_impl="pipeline", pipeline_backend=backend)
    toks = torch.from_numpy(ref["toks"])
    got = tm.forward(tp, toks).numpy()
    np.testing.assert_allclose(got, ref["forward"], rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.argmax(-1), ref["forward"].argmax(-1))
    p0, max_len = 8, 14
    lg, cache = tm.prefill(tp, toks[:, :p0], max_len=max_len)
    np.testing.assert_allclose(lg.numpy(), ref["prefill"], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(cache["k"].numpy(), ref["cache_k"],
                               rtol=TOL, atol=TOL)
    pos = torch.tensor([p0, p0 - 3])
    for i, want in enumerate(ref["decode"]):
        lg, cache = tm.decode_step(tp, cache, toks[:, p0 + i:p0 + i + 1],
                                   pos + i)
        np.testing.assert_allclose(lg.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "qwen3-moe-30b-a3b"])
def test_hand_kernel_forward_matches_reference(arch):
    """Path C's impls (``attn_impl = mlp_impl = "cuda"``) at reduced
    size against the reference's ``interpret`` impls."""
    cfg = dataclasses.replace(JC.get_reduced_config(arch, n_layers=N_LAYERS),
                              attn_impl="interpret", mlp_impl="interpret")
    model = JLM(cfg)
    params, _ = model.init_params(jax.random.key(1))
    tree = _nontrivial(jax.tree.map(np.asarray, params), seed=12)
    toks = _tokens((2, 24), cfg.vocab, seed=6)
    want = np.asarray(model.forward(jax.tree.map(jnp.asarray, tree),
                                    jnp.asarray(toks, jnp.int32)))
    tm, tp = _port(arch, tree, attn_impl="cuda", mlp_impl="cuda")
    got = tm.forward(tp, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
