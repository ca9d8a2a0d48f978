"""The port's encoder-decoder (whisper) against the JAX reference on the
same weights.

Reduced whisper-tiny (2 encoder and 2 decoder layers, d_model 128,
enc_seq 64): ``EncDec.from_jax_params`` of the reference's
``EncDec.init_params``, frame embeddings and tokens from a seeded numpy
generator.  ``forward`` and ``prefill`` (logits, self and cross caches)
on the hand-kernel impls (``cuda``/``cuda``, each kernel's plain version
on CPU tensors) match the reference on ``interpret``/``interpret``, and on
the plain impls (``chunked``/``fused_ref``) the reference on
``xla``/``fused_ref``; ``decode_step`` on the plain impls matches the
reference's ``xla`` path at every position.  All at ``atol = rtol =
1e-4`` (float32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as JC
from repro.models import encdec as JE
from repro_torch import configs as TC
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.models.lm import build_model
import torch_port  # noqa: F401

TOL = 1e-4
N_LAYERS = 2
# port impls -> the reference's
IMPLS = {("cuda", "cuda"): ("interpret", "interpret"),
         ("chunked", "fused_ref"): ("xla", "fused_ref")}


@pytest.fixture(scope="module")
def ref_params():
    cfg = JC.get_reduced_config("whisper-tiny", n_layers=N_LAYERS)
    params, _ = JE.EncDec(cfg).init_params(jax.random.key(0))
    return jax.tree.map(np.asarray, params)


def _models(ref_params, attn, mlp):
    jimpl = IMPLS[(attn, mlp)]
    jcfg = dataclasses.replace(
        JC.get_reduced_config("whisper-tiny", n_layers=N_LAYERS),
        attn_impl=jimpl[0], mlp_impl=jimpl[1])
    tcfg = dataclasses.replace(
        TC.get_reduced_config("whisper-tiny", n_layers=N_LAYERS),
        attn_impl=attn, mlp_impl=mlp)
    tm = TE.EncDec(tcfg)
    return JE.EncDec(jcfg), tm, tm.from_jax_params(ref_params, device="cpu")


def _inputs(cfg, b=2, s=12, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s))
    frames = rng.normal(size=(b, cfg.enc_seq, cfg.d_model)).astype(
        np.float32)
    return toks, frames


def _close(got: torch.Tensor, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def test_config_matches_reference_fields():
    for reduce in (False, True):
        get = "get_reduced_config" if reduce else "get_config"
        ref = getattr(JC, get)("whisper-tiny")
        port = getattr(TC, get)("whisper-tiny")
        for f in ("family", "n_layers", "n_enc_layers", "enc_seq",
                  "d_model", "n_heads", "n_kv_heads", "d_head", "d_ff",
                  "vocab", "rope_theta", "norm_eps",
                  "tie_embeddings", "max_seq"):
            assert getattr(port, f) == getattr(ref, f), (get, f)
    assert isinstance(build_model(TC.get_config("whisper-tiny")), TE.EncDec)


@pytest.mark.parametrize("impls", list(IMPLS), ids="/".join)
def test_forward_matches_reference(impls, ref_params):
    jm, tm, tp = _models(ref_params, *impls)
    toks, frames = _inputs(jm.cfg)
    want = jm.forward(ref_params, jnp.asarray(toks, jnp.int32),
                      jnp.asarray(frames))
    got = tm.forward(tp, torch.from_numpy(toks), torch.from_numpy(frames))
    _close(got, want)


@pytest.mark.parametrize("impls", list(IMPLS), ids="/".join)
def test_prefill_logits_and_caches_match_reference(impls, ref_params):
    jm, tm, tp = _models(ref_params, *impls)
    toks, frames = _inputs(jm.cfg, seed=1)
    jl, jc = jm.prefill(ref_params, jnp.asarray(toks, jnp.int32),
                        jnp.asarray(frames), max_len=16)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks), torch.from_numpy(frames),
                        max_len=16)
    _close(tl, jl)
    for kind in ("self", "cross"):
        for n in ("k", "v"):
            assert tc[kind][n].shape == jc[kind][n].shape
            _close(tc[kind][n], jc[kind][n])


def test_decode_step_matches_reference_at_every_position(ref_params):
    """Prefill 6 tokens, then decode the rest of a 12-long cache on the
    plain impls, one scalar position at a time."""
    jm, tm, tp = _models(ref_params, "chunked", "fused_ref")
    toks, frames = _inputs(jm.cfg, s=12, seed=2)
    p0, max_len = 6, 12
    jl, jc = jm.prefill(ref_params, jnp.asarray(toks[:, :p0], jnp.int32),
                        jnp.asarray(frames), max_len=max_len)
    tl, tc = tm.prefill(tp, torch.from_numpy(toks[:, :p0]),
                        torch.from_numpy(frames), max_len=max_len)
    for pos in range(p0, max_len):
        tok = toks[:, pos:pos + 1]
        jl, jc = jm.decode_step(ref_params, jc, jnp.asarray(tok, jnp.int32),
                                jnp.asarray(pos, jnp.int32))
        tl, tc = tm.decode_step(tp, tc, torch.from_numpy(tok), pos)
        _close(tl, jl)
    _close(tc["self"]["k"], jc["self"]["k"])


def test_mlp_uses_the_tanh_gelu(ref_params):
    """``jax.nn.gelu`` defaults to the tanh approximation; the port's MLP
    matches it, and the exact-erf GELU would not."""
    x = np.random.default_rng(3).normal(size=(256,)).astype(np.float32) * 3
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    tx = torch.from_numpy(x)
    np.testing.assert_allclose(F.gelu(tx, approximate="tanh").numpy(), want,
                               rtol=1e-6, atol=1e-6)
    assert np.abs(F.gelu(tx).numpy() - want).max() > 1e-4
    jm, tm, tp = _models(ref_params, "cuda", "cuda")
    h = np.random.default_rng(4).normal(size=(2, 5, jm.cfg.d_model)).astype(
        np.float32)
    lp = jax.tree.map(lambda a: jnp.asarray(a[0]), ref_params["dec"])
    want = JE._mlp(lp, jnp.asarray(h), jm.cfg)
    _close(TE._mlp(tp["dec"][0], torch.from_numpy(h), tm.cfg), want)


def test_sinusoid_matches_reference():
    d = 384
    _close(TE._sinusoid(1500, d), JE._sinusoid(1500, d))
    _close(TE._sinusoid_at(37, d), JE._sinusoid_at(jnp.asarray(37), d)[0, 0])


def test_hand_attention_has_no_decode_step(ref_params):
    """The reference cannot decode on its hand flash kernel (a traced
    position meets the kernel's static ``q_offset``); the port raises
    rather than run something else."""
    jm, tm, tp = _models(ref_params, "cuda", "cuda")
    toks, frames = _inputs(jm.cfg, seed=5)
    with pytest.raises(ValueError, match="captures constants"):
        jcache = jm.init_cache(2, 16)
        jm.decode_step(ref_params, jcache, jnp.asarray(toks[:, :1],
                                                       jnp.int32),
                       jnp.asarray(3, jnp.int32))
    _, cache = tm.prefill(tp, torch.from_numpy(toks[:, :4]),
                          torch.from_numpy(frames), max_len=16)
    before = cache["self"]["k"].clone()
    with pytest.raises(NotImplementedError, match="static int"):
        tm.decode_step(tp, cache, torch.from_numpy(toks[:, 4:5]), 4)
    torch.testing.assert_close(cache["self"]["k"], before)
    cfg = dataclasses.replace(tm.cfg, rope_theta=0.0)
    kv = TL.attention_init_cache(cfg, 2, 8, torch.float32, "cpu")
    with pytest.raises(NotImplementedError):
        TL.attention_decode(tp["dec"][0]["attn"],
                            torch.zeros(2, 1, cfg.d_model), kv, 3, cfg)
