"""The port's dense LM against the JAX reference on the same weights.

Reduced smollm-135m (2 layers): ``LM.from_jax_params`` of the reference's
``LM.init_params``; forward logits, prefill, and decode at every position
(scalar and ragged ``(B,)`` positions) with the port on its ``pipeline``
path (``torch`` and ``cuda`` backends; the latter runs each kernel's plain
version on CPU tensors) and the reference on ``pipeline``/``jax``; and
forward and prefill on the hand-written-kernel impls (``cuda``/``cuda``,
plain versions on CPU tensors) against the reference on
``interpret``/``interpret``.  Logits agree within ``atol = rtol = 1e-4``
(float32) and greedy tokens are equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JC
from repro import pipeline as JP
from repro.models.lm import LM as JLM
from repro_torch import configs as TC
from repro_torch.models import common as TCM
from repro_torch.models import layers as TL
from repro_torch.models.lm import LM as TLM
import torch_port  # noqa: F401

TOL = 1e-4
N_LAYERS = 2


@pytest.fixture(scope="module")
def ref_model(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_KERNEL_CACHE", str(tmp_path_factory.mktemp("kernels")))
    JP.reset_default_cache()
    cfg = JC.with_pipeline(JC.get_reduced_config("smollm-135m",
                                                 n_layers=N_LAYERS),
                           options=JP.CompileOptions(backend="jax"))
    model = JLM(cfg)
    params, _ = model.init_params(jax.random.key(0))
    yield model, params
    mp.undo()
    JP.reset_default_cache()


def _port(backend, ref_params):
    cfg = TC.with_pipeline(TC.get_reduced_config("smollm-135m",
                                                 n_layers=N_LAYERS),
                           backend=backend)
    model = TLM(cfg)
    return model, model.from_jax_params(jax.tree.map(np.asarray, ref_params),
                                        device="cpu")


def _tokens(shape, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape)


def test_reduced_config_matches_reference_fields():
    ref = JC.get_reduced_config("smollm-135m")
    port = TC.get_reduced_config("smollm-135m")
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_head",
              "d_ff", "vocab", "max_seq", "rope_theta", "norm_eps",
              "tie_embeddings", "family"):
        assert getattr(port, f) == getattr(ref, f), f
    full = TC.get_config("smollm-135m")
    assert (full.n_layers, full.d_model, full.vocab) == (30, 576, 49152)
    assert port.dtype == torch.float32


def test_rope_and_rms_norm_match_reference():
    from repro.models import common as JCM
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 5, 8)).astype(np.float32)
    pos = np.array([3, 7])[:, None, None]
    want = np.asarray(JCM.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    got = TCM.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    g = rng.normal(size=(8,)).astype(np.float32)
    want = np.asarray(JCM.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-6))
    got = TCM.rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_forward_logits_match_reference(backend, ref_model):
    jm, jp = ref_model
    tm, tp = _port(backend, jp)
    toks = _tokens((2, 16), jm.cfg.vocab)
    want = np.asarray(jm.forward(jp, jnp.asarray(toks, jnp.int32)))
    got = tm.forward(tp, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_unfused_and_ref_impls_match_pipeline(ref_model):
    """The plain ``ref``/``unfused`` impls compute what the pipeline
    impls compute."""
    jm, jp = ref_model
    tm, tp = _port("torch", jp)
    plain = TLM(TC.get_reduced_config("smollm-135m", n_layers=N_LAYERS))
    toks = torch.from_numpy(_tokens((2, 8), jm.cfg.vocab, seed=4))
    torch.testing.assert_close(plain.forward(tp, toks), tm.forward(tp, toks),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("ragged", [False, True], ids=["scalar", "ragged"])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_prefill_then_decode_every_position(backend, ragged, ref_model):
    jm, jp = ref_model
    tm, tp = _port(backend, jp)
    b, p0, max_len = 2, 6, 16
    steps = max_len - p0        # every position left in the cache
    toks = _tokens((b, p0 + steps), jm.cfg.vocab, seed=2)
    jl, jc = jm.prefill(jp, jnp.asarray(toks[:, :p0], jnp.int32),
                        max_len=max_len)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks[:, :p0]), max_len=max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tc["k"].numpy(),
                               np.asarray(jc["stage0"]["sub0"]["k"]),
                               rtol=TOL, atol=TOL)
    for step in range(steps):
        pos = p0 + step
        tok = toks[:, pos:pos + 1]
        jpos = (jnp.full((b,), pos, jnp.int32) if ragged
                else jnp.asarray(pos, jnp.int32))
        tpos = torch.full((b,), pos) if ragged else pos
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok, jnp.int32), jpos)
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), tpos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal(tl.numpy().argmax(-1),
                                      np.asarray(jl).argmax(-1))


def test_ragged_decode_positions_differ_per_sequence(ref_model):
    """Each sequence at its own cache position: the ragged step equals
    two single-sequence steps at those positions."""
    jm, jp = ref_model
    tm, tp = _port("cuda", jp)
    toks = torch.from_numpy(_tokens((2, 12), jm.cfg.vocab, seed=5))
    _, cache = tm.prefill(tp, toks[:, :10], max_len=16)
    pos = torch.tensor([4, 9])
    both, _ = tm.decode_step(tp, {k: v.clone() for k, v in cache.items()},
                             toks[:, 10:11], pos)
    for i in range(2):
        one = {k: v[:, i:i + 1].clone() for k, v in cache.items()}
        lg, _ = tm.decode_step(tp, one, toks[i:i + 1, 10:11], int(pos[i]))
        torch.testing.assert_close(both[i], lg[0], rtol=TOL, atol=TOL)


def test_attention_pipeline_matches_ref_at_huge_logits():
    """Prefill and per-position decode through the pipeline attention
    stay finite and agree at |logit| ~ 1e4 (the reference's
    ``test_prefill_decode_parity_at_huge_logits``)."""
    cfg = TC.with_pipeline(TCM.ModelConfig(
        d_model=64, n_heads=4, n_kv_heads=1, d_head=16, d_ff=128,
        dtype=torch.float32, rope_theta=0.0), backend="cuda")
    pb = TCM.ParamBuilder(np.random.default_rng(0), torch.float32, "cpu")
    p = {"wq": pb.dense((64, 64)), "wk": pb.dense((64, 16)),
         "wv": pb.dense((64, 16)), "wo": pb.dense((64, 64))}
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 8, 64)).astype(np.float32)) * 100.0
    prefill = TL.attention_apply(p, x, cfg, causal=True)
    assert torch.isfinite(prefill).all()
    cache = TL.attention_init_cache(cfg, 2, 8, torch.float32, "cpu")
    for pos in range(8):
        step, cache = TL.attention_decode(p, x[:, pos:pos + 1], cache, pos,
                                          cfg)
        torch.testing.assert_close(step[:, 0], prefill[:, pos], rtol=2e-3,
                                   atol=2e-3)


@pytest.fixture(scope="module")
def ref_hand(ref_model):
    """The reference on its hand-written kernels, in interpret mode."""
    jm, jp = ref_model
    return JLM(dataclasses.replace(jm.cfg, attn_impl="interpret",
                                   mlp_impl="interpret")), jp


def _port_impls(ref_params, **impls):
    cfg = dataclasses.replace(
        TC.get_reduced_config("smollm-135m", n_layers=N_LAYERS), **impls)
    model = TLM(cfg)
    return model, model.from_jax_params(jax.tree.map(np.asarray, ref_params),
                                        device="cpu")


def test_hand_kernel_forward_matches_reference(ref_hand):
    jm, jp = ref_hand
    tm, tp = _port_impls(jp, attn_impl="cuda", mlp_impl="cuda")
    toks = _tokens((2, 24), jm.cfg.vocab, seed=6)
    want = np.asarray(jm.forward(jp, jnp.asarray(toks, jnp.int32)))
    got = tm.forward(tp, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_hand_kernel_prefill_matches_reference(ref_hand):
    jm, jp = ref_hand
    tm, tp = _port_impls(jp, attn_impl="cuda", mlp_impl="cuda")
    toks = _tokens((2, 20), jm.cfg.vocab, seed=7)
    jl, jc = jm.prefill(jp, jnp.asarray(toks, jnp.int32), max_len=32)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), max_len=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(tc[n].numpy(),
                                   np.asarray(jc["stage0"]["sub0"][n]),
                                   rtol=TOL, atol=TOL)
    with pytest.raises(NotImplementedError, match="static int"):
        tm.decode_step(tp, tc, torch.from_numpy(toks[:, :1]), 20)


def test_chunked_impls_match_reference(ref_model):
    """The plain impls beside the hand path: ``chunked``/``fused_ref``
    against the reference's ``xla``/``fused_ref``."""
    jm, jp = ref_model
    jm = JLM(dataclasses.replace(jm.cfg, attn_impl="xla",
                                 mlp_impl="fused_ref"))
    tm, tp = _port_impls(jp, attn_impl="chunked", mlp_impl="fused_ref")
    toks = _tokens((2, 10), jm.cfg.vocab, seed=9)
    want = np.asarray(jm.forward(jp, jnp.asarray(toks, jnp.int32)))
    got = tm.forward(tp, torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_swiglu_weights_fold_once_per_weight_set():
    """``_swiglu_pipeline`` folds the gain into W/V and transposes W/V/U
    once per weight set: a second call reuses the folds, its output equals
    the output on freshly folded weights, and a weight changed in place
    (its ``_version``) or a new gain is folded again."""
    cfg = TC.with_pipeline(TC.get_reduced_config("smollm-135m"),
                           backend="torch")
    pb = TCM.ParamBuilder(np.random.default_rng(2), torch.float32, "cpu")
    d, f = cfg.d_model, cfg.d_ff
    wg, wu, wd = pb.dense((d, f)), pb.dense((d, f)), pb.dense((f, d))
    gamma = 1.0 + 0.1 * pb.dense((d,), scale=1.0)
    x = pb.dense((6, d), scale=1.0)

    def fresh():
        kern = TL.swiglu_kernel(6, d, f, float(cfg.norm_eps),
                                TL._pipeline_options(cfg))
        wt, vt, ut = TL.fold_swiglu_weights(wg, wu, wd, gamma)
        return kern({"X": x, "WT": wt, "VT": vt, "UT": ut})["O"]

    first = TL._swiglu_pipeline(x, wg, wu, wd, gamma, cfg)
    folds = TL.folded_swiglu_weights(wg, wu, wd, gamma)
    assert all(a is b for a, b in zip(
        folds, TL.folded_swiglu_weights(wg, wu, wd, gamma)))
    torch.testing.assert_close(TL._swiglu_pipeline(x, wg, wu, wd, gamma,
                                                   cfg), first)
    torch.testing.assert_close(first, fresh(), rtol=0, atol=0)
    wg.mul_(2.0)                       # in place: a new _version
    again = TL._swiglu_pipeline(x, wg, wu, wd, gamma, cfg)
    assert TL.folded_swiglu_weights(wg, wu, wd, gamma)[0] is not folds[0]
    torch.testing.assert_close(again, fresh(), rtol=0, atol=0)
    assert not torch.allclose(again, first)
    gamma = gamma * 0.5                # a new gain tensor
    torch.testing.assert_close(
        TL._swiglu_pipeline(x, wg, wu, wd, gamma, cfg), fresh(), rtol=0,
        atol=0)
    key = (id(wg), id(wu), id(wd), id(gamma))
    assert key in TL._FOLDED
    del gamma                          # a freed weight leaves the cache
    assert key not in TL._FOLDED
