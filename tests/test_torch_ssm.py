"""The port's Mamba2 SSD (mamba2-2.7b) against the JAX reference.

* the mamba2-2.7b config, full and reduced, equals the reference's field
  for field;
* ``_causal_conv``, ``_ssd_chunked`` (with and without an initial state,
  at a length of three chunks, the last one padded), ``mamba_apply``,
  ``mamba_prefill`` (output and cache) and ``mamba_decode`` equal the
  reference's functions on the same seeded inputs within 1e-5, the
  per-head parameters set to seeded non-trivial values (at init they are
  zeros and ones, which would hide a missing term);
* the SSD result does not depend on the chunk size, and at the chunk of
  256 the port's float32 SSD stays nearer its float64 result than the
  reference's does (its one departure in arithmetic: sums within each
  segment, not differences of prefix sums);
* the 2-layer model's forward, prefill (logits and the ``h`` / ``conv``
  cache) and decode steps equal the reference's within 1e-4; prefill
  then decode equals the forward pass;
* the serving engine refuses the ``ssm`` family, as the reference's does.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_cpu import reference_on_cpu  # noqa: F401
from repro import configs as JC
from repro.models import layers as JL
from repro.models.lm import LM as JLM
from repro_torch import configs as TC
from repro_torch.launch import serve as S
from repro_torch.launch.engine import Engine
from repro_torch.models import common as TCM
from repro_torch.models import layers as TL
from repro_torch.models.lm import LM as TLM
from torch_port import reference_fields

ARCH = "mamba2-2.7b"
FN_TOL = 1e-5
TOL = 1e-4
N_LAYERS = 2
#: parameters the reference initialises to zeros or ones: their init and
#: the spread of the seeded values set in their place
TRIVIAL = {"conv_b": (0.0, 0.1), "A_log": (0.0, 0.5),
           "dt_bias": (0.0, 0.5), "D": (0.0, 0.5), "ssm_norm": (1.0, 0.1),
           "ln1": (1.0, 0.1), "ln_f": (1.0, 0.1)}


@pytest.mark.parametrize("get", ["get_config", "get_reduced_config"])
def test_config_matches_reference(get):
    port, ref = getattr(TC, get)(ARCH), getattr(JC, get)(ARCH)
    for name, value in reference_fields(port).items():
        assert value == getattr(ref, name), (get, name)
    assert (port.d_inner, port.n_ssm_heads) == (ref.d_inner,
                                                ref.n_ssm_heads)
    assert {port.mixer_of(i) for i in range(port.n_layers)} == {"mamba"}


def _nontrivial(tree, seed):
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in TRIVIAL:
                base, spread = TRIVIAL[k]
                out[k] = (base + spread * rng.normal(size=v.shape)
                          ).astype(np.float32)
            else:
                out[k] = np.asarray(v, np.float32)
        return out

    return walk(tree)


def _cfgs(**over):
    return JC.get_reduced_config(ARCH, **over), TC.get_reduced_config(
        ARCH, **over)


def _mamba_params(tcfg, seed):
    pb = TCM.ParamBuilder(np.random.default_rng(seed), torch.float32, "cpu")
    p = _nontrivial({k: v.numpy() for k, v in
                     TCM.init_mamba(pb, tcfg).items()}, seed + 1)
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _close(got, want, tol=FN_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _normal(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


@pytest.mark.parametrize("s", [1, 2, 9])
def test_causal_conv_matches_reference(s):
    jcfg, tcfg = _cfgs()
    jp, tp = _mamba_params(tcfg, seed=3)
    xbc = _normal(np.random.default_rng(4), 2, s,
                  tcfg.d_inner + 2 * tcfg.ssm_state)
    _close(TL._causal_conv(torch.from_numpy(xbc), tp, tcfg),
           JL._causal_conv(jnp.asarray(xbc), jp, jcfg))


def _ssd_inputs(cfg, s, seed):
    rng = np.random.default_rng(seed)
    b, nh, hd, n = 2, cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    return dict(xh=_normal(rng, b, s, nh, hd),
                dt=np.log1p(np.exp(_normal(rng, b, s, nh))).astype(
                    np.float32),
                A=-np.exp(_normal(rng, nh, scale=0.5)),
                B=_normal(rng, b, s, n, scale=0.5),
                C=_normal(rng, b, s, n, scale=0.5),
                h0=_normal(rng, b, nh, hd, n))


@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
def test_ssd_chunked_matches_reference(with_h0):
    """s = 80 at chunk 32: three chunks, the last padded by 16."""
    jcfg, tcfg = _cfgs()
    assert tcfg.ssm_chunk == 32
    a = _ssd_inputs(tcfg, 80, seed=5)
    h0 = a["h0"] if with_h0 else None
    names = ("xh", "dt", "A", "B", "C")
    wy, wh = JL._ssd_chunked(*(jnp.asarray(a[k]) for k in names), jcfg,
                             h0=None if h0 is None else jnp.asarray(h0))
    gy, gh = TL._ssd_chunked(*(torch.from_numpy(a[k]) for k in names), tcfg,
                             h0=None if h0 is None else torch.from_numpy(h0))
    assert gy.shape == (2, 80, tcfg.n_ssm_heads, tcfg.ssm_head_dim)
    assert torch.isfinite(gy).all() and torch.isfinite(gh).all()
    _close(gy, wy)
    _close(gh, wh)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ssd_segment_sums_stay_near_float64(seed):
    """At mamba2-2.7b's chunk of 256 the port's float32 SSD (segment sums
    summed within each segment) stays within 5e-7 of its float64 result,
    relative to the largest output, where the reference's float32 SSD
    (differences of prefix sums, layers.py:696-699) leaves more than
    1e-6: the one place the port departs from the reference's arithmetic,
    toward the exact result."""
    jcfg, tcfg = _cfgs(ssm_chunk=256)
    rng = np.random.default_rng(seed)
    b, s, nh, hd, n = 1, 512, 8, 16, 16
    args = (_normal(rng, b, s, nh, hd),
            np.log1p(np.exp(_normal(rng, b, s, nh))).astype(np.float32),
            -np.exp(_normal(rng, nh, scale=0.5)),
            _normal(rng, b, s, n, scale=0.5),
            _normal(rng, b, s, n, scale=0.5))
    exact, _ = TL._ssd_chunked(*(torch.from_numpy(a).double() for a in args),
                               tcfg)
    assert exact.dtype == torch.float64
    port, _ = TL._ssd_chunked(*(torch.from_numpy(a) for a in args), tcfg)
    ref, _ = JL._ssd_chunked(*(jnp.asarray(a) for a in args), jcfg)
    scale = exact.abs().max().item()
    port_err = (port.double() - exact).abs().max().item() / scale
    ref_err = np.abs(np.asarray(ref, np.float64)
                     - exact.numpy()).max() / scale
    assert port_err < 5e-7 < 1e-6 < ref_err


def test_ssd_decay_is_finite_where_exp_overflows():
    """Steep decays (dt A far below 0 over a chunk) make exp(seg) overflow
    above the diagonal; masked before the exp, nothing turns NaN."""
    _, tcfg = _cfgs()
    a = _ssd_inputs(tcfg, 40, seed=6)
    a["dt"] = a["dt"] * 400.0
    y, h = TL._ssd_chunked(*(torch.from_numpy(a[k]) for k in
                             ("xh", "dt", "A", "B", "C")), tcfg)
    assert torch.isfinite(y).all() and torch.isfinite(h).all()


def test_ssd_chunk_size_invariance():
    """The chunked scan is exact: ``mamba_apply`` does not depend on the
    chunk size (the reference's tests/test_models_decode.py:77)."""
    _, tcfg = _cfgs()
    _, tp = _mamba_params(tcfg, seed=7)
    gamma = torch.ones(tcfg.d_model)
    x = torch.from_numpy(_normal(np.random.default_rng(8), 2, 24,
                                 tcfg.d_model, scale=0.3))
    outs = [TL.mamba_apply(tp, x, gamma,
                           dataclasses.replace(tcfg, ssm_chunk=q))
            for q in (4, 8, 24)]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], atol=2e-5, rtol=2e-5)


def _block_inputs(cfg, s, seed):
    rng = np.random.default_rng(seed)
    x = _normal(rng, 2, s, cfg.d_model)
    gamma = (1.0 + 0.1 * rng.normal(size=cfg.d_model)).astype(np.float32)
    return x, gamma


@pytest.mark.parametrize("s", [3, 45])
def test_mamba_apply_and_prefill_match_reference(s):
    """s = 3 is shorter than the conv window (its cache is zero-padded),
    45 spans two chunks."""
    jcfg, tcfg = _cfgs()
    jp, tp = _mamba_params(tcfg, seed=9)
    x, gamma = _block_inputs(tcfg, s, seed=10)
    jx, jg = jnp.asarray(x), jnp.asarray(gamma)
    tx, tg = torch.from_numpy(x), torch.from_numpy(gamma)
    _close(TL.mamba_apply(tp, tx, tg, tcfg), JL.mamba_apply(jp, jx, jg, jcfg))
    want, wcache = JL.mamba_prefill(jp, jx, jg, jcfg)
    got, gcache = TL.mamba_prefill(tp, tx, tg, tcfg)
    _close(got, want)
    assert sorted(gcache) == ["conv", "h"]
    assert gcache["h"].dtype == torch.float32
    for k in ("h", "conv"):
        assert gcache[k].shape == wcache[k].shape
        _close(gcache[k], wcache[k])


def test_mamba_decode_matches_reference():
    jcfg, tcfg = _cfgs()
    jp, tp = _mamba_params(tcfg, seed=11)
    rng = np.random.default_rng(12)
    x, gamma = _block_inputs(tcfg, 1, seed=13)
    cache = {"h": _normal(rng, 2, tcfg.n_ssm_heads, tcfg.ssm_head_dim,
                          tcfg.ssm_state),
             "conv": _normal(rng, 2, tcfg.ssm_conv - 1,
                             tcfg.d_inner + 2 * tcfg.ssm_state)}
    want, wcache = JL.mamba_decode(
        jp, jnp.asarray(x), jnp.asarray(gamma),
        {k: jnp.asarray(v) for k, v in cache.items()}, jcfg)
    got, gcache = TL.mamba_decode(
        tp, torch.from_numpy(x), torch.from_numpy(gamma),
        {k: torch.from_numpy(v) for k, v in cache.items()}, tcfg)
    _close(got, want)
    for k in cache:
        _close(gcache[k], wcache[k])


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.fixture(scope="module")
def reference():
    """The reference 2-layer mamba2, its weights made non-trivial, and its
    logits on a forward pass (15 tokens: a chunk of 32 padded), a prefill
    of 9 tokens (and its cache) and the decode steps after it."""
    with jax.default_device(jax.devices("cpu")[0]), \
            jax.default_matmul_precision("highest"):
        cfg = JC.get_reduced_config(ARCH, n_layers=N_LAYERS)
        model = JLM(cfg)
        params, _ = model.init_params(jax.random.key(0))
        tree = _nontrivial(jax.tree.map(np.asarray, params), seed=21)
        jp = jax.tree.map(jnp.asarray, tree)
        toks = _tokens((2, 15), cfg.vocab, seed=22)
        out = {"tree": tree, "toks": toks,
               "forward": np.asarray(model.forward(
                   jp, jnp.asarray(toks, jnp.int32)))}
        p0 = 9
        lg, cache = model.prefill(jp, jnp.asarray(toks[:, :p0], jnp.int32),
                                  max_len=15)
        out["prefill"] = np.asarray(lg)
        out["cache"] = {k: np.asarray(v)
                        for k, v in cache["stage0"]["sub0"].items()}
        steps = []
        for i in range(15 - p0):
            tok = jnp.asarray(toks[:, p0 + i:p0 + i + 1], jnp.int32)
            lg, cache = model.decode_step(jp, cache, tok, p0 + i)
            steps.append(np.asarray(lg))
        out["decode"] = steps
    return out


@pytest.fixture(scope="module")
def port(reference):
    cfg = TC.get_reduced_config(ARCH, n_layers=N_LAYERS)
    tm = TLM(cfg)
    return tm, tm.from_jax_params(reference["tree"], device="cpu")


def test_model_forward_prefill_and_decode_match_reference(reference, port):
    tm, tp = port
    assert set(tp["layers"][0]) == {"ln1", "mixer"}      # no MLP
    toks = torch.from_numpy(reference["toks"])
    got = tm.forward(tp, toks).numpy()
    np.testing.assert_allclose(got, reference["forward"], rtol=TOL,
                               atol=TOL)
    p0 = 9
    lg, cache = tm.prefill(tp, toks[:, :p0], max_len=15)
    np.testing.assert_allclose(lg.numpy(), reference["prefill"], rtol=TOL,
                               atol=TOL)
    assert sorted(cache) == ["conv", "h"]
    for k, want in reference["cache"].items():
        assert cache[k].shape == want.shape
        np.testing.assert_allclose(cache[k].numpy(), want, rtol=TOL,
                                   atol=TOL)
    for i, want in enumerate(reference["decode"]):
        lg, cache = tm.decode_step(tp, cache, toks[:, p0 + i:p0 + i + 1],
                                   p0 + i)
        np.testing.assert_allclose(lg.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("p0", [1, 9, 40])
def test_prefill_then_decode_equals_forward(port, p0):
    """Greedy decode after a prefill of ``p0`` tokens gives, at every
    step, the forward pass's logits over the same tokens (the chip's path
    D rule, here at reduced size; 40 spans two chunks)."""
    tm, tp = port
    toks = torch.from_numpy(_tokens((2, p0), tm.cfg.vocab, seed=23))
    lg, cache = tm.prefill(tp, toks, max_len=p0 + 6)
    steps = [lg[:, -1]]
    for i in range(6):
        nxt = steps[-1].argmax(-1)[:, None]
        toks = torch.cat([toks, nxt], 1)
        lg, cache = tm.decode_step(tp, cache, nxt, p0 + i)
        steps.append(lg[:, 0])
    full = tm.forward(tp, toks)
    for i, got in enumerate(steps):
        torch.testing.assert_close(got, full[:, p0 - 1 + i], rtol=TOL,
                                   atol=TOL)


def test_init_cache_layout():
    cfg = TC.get_reduced_config(ARCH, n_layers=3)
    c = TLM(cfg).init_cache(2, 64, device="cpu")
    assert c["h"].shape == (3, 2, cfg.n_ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state)
    assert c["h"].dtype == torch.float32
    assert c["conv"].shape == (3, 2, cfg.ssm_conv - 1,
                               cfg.d_inner + 2 * cfg.ssm_state)


def test_engine_refuses_ssm():
    with pytest.raises(ValueError, match="not served"):
        Engine(TC.get_reduced_config(ARCH), device="cpu")
    with pytest.raises(SystemExit):
        S.main(["--arch", ARCH, "--reduced", "--device", "cpu"])
