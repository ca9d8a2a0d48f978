"""The port's MLA (deepseek-v3) against the JAX reference.

* the deepseek-v3-671b config, full and reduced, equals the reference's
  field for field;
* ``mla_q`` and ``mla_kv_compressed`` (``q_lora_rank`` 0 and > 0),
  ``mla_apply`` (the port's ``chunked`` against the reference's ``xla``,
  and ``ref`` against ``ref``) and ``mla_decode`` at a scalar and at a
  ragged position vector (output and the compressed cache) equal the
  reference's functions on the same seeded inputs within 1e-5;
* the 2-layer model (1 SwiGLU layer, 1 MoE layer), on the reference's
  weights made non-trivial: forward, prefill (logits and the ``ckv`` /
  ``krope`` cache) and every ragged decode step equal the reference's
  (pipeline impls, backend ``jax``) within 1e-4 on the port's ``torch``
  and ``cuda`` backends (plain versions on CPU tensors);
* the port's CPU engine emits the reference engine's greedy tokens on the
  reference's trace and weights;
* ``pipeline_kernels`` compiles no attention program for MLA, and the
  served SwiGLU programs at full deepseek-v3 width emit one kernel for
  each planned group; the depth cut keeps the dense/MoE mix;
* the decode step's bound counts MLA's compressed cache rows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_cpu import reference_on_cpu  # noqa: F401
from repro import configs as JC
from repro import pipeline as JP
from repro.launch.engine import Engine as JEngine
from repro.launch.engine import synth_trace as j_synth_trace
from repro.models import layers as JL
from repro.models.lm import LM as JLM
from repro_torch import configs as TC
from repro_torch.launch import profile_decode as PD
from repro_torch.launch import serve as S
from repro_torch.launch.engine import Engine
from repro_torch.models import common as TCM
from repro_torch.models import layers as TL
from repro_torch.models.lm import LM as TLM
from torch_port import reference_fields

ARCH = "deepseek-v3-671b"
FN_TOL = 1e-5
TOL = 1e-4
N_LAYERS = 2
#: parameters the reference initialises to ones, with their init
TRIVIAL = {"q_norm": 1.0, "kv_norm": 1.0, "ln1": 1.0, "ln2": 1.0,
           "ln_f": 1.0}


@pytest.mark.parametrize("get", ["get_config", "get_reduced_config"])
def test_config_matches_reference(get):
    port, ref = getattr(TC, get)(ARCH), getattr(JC, get)(ARCH)
    for name, value in reference_fields(port).items():
        assert value == getattr(ref, name), (get, name)
    assert [port.is_moe_layer(i) for i in range(port.n_layers)] == [
        ref.is_moe_layer(i) for i in range(ref.n_layers)]
    assert {port.mixer_of(i) for i in range(port.n_layers)} == {"mla"}


def _nontrivial(tree, seed):
    """The numpy tree with every one-initialised gain set to seeded
    values around one."""
    rng = np.random.default_rng(seed)

    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k in TRIVIAL:
                out[k] = (TRIVIAL[k] + 0.1 * rng.normal(size=v.shape)
                          ).astype(np.float32)
            else:
                out[k] = np.asarray(v, np.float32)
        return out

    return walk(tree)


def _cfgs(q_lora_rank=None, **impls):
    """The reduced configs of both packages (``q_lora_rank`` overridden
    when given)."""
    over = {} if q_lora_rank is None else {"q_lora_rank": q_lora_rank}
    jcfg = JC.get_reduced_config(ARCH, **over)
    tcfg = dataclasses.replace(TC.get_reduced_config(ARCH, **over), **impls)
    return jcfg, tcfg


def _mla_params(tcfg, seed):
    """Seeded MLA weights (numpy), the gains made non-trivial."""
    pb = TCM.ParamBuilder(np.random.default_rng(seed), torch.float32, "cpu")
    return _nontrivial({k: v.numpy() for k, v in
                        TCM.init_mla(pb, tcfg).items()}, seed + 1)


def _both(p):
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def _close(got, want, tol=FN_TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("q_lora_rank", [0, 64])
def test_mla_q_and_kv_compressed_match_reference(q_lora_rank):
    jcfg, tcfg = _cfgs(q_lora_rank)
    p = _mla_params(tcfg, seed=3)
    assert ("wq_a" in p) == (q_lora_rank > 0) and ("wq" in p) == (
        q_lora_rank == 0)
    jp, tp = _both(p)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 9, tcfg.d_model)).astype(np.float32)
    pos = np.arange(9)
    want = JL._mla_q(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    got = TL.mla_q(tp, torch.from_numpy(x), tcfg, torch.from_numpy(pos))
    for g, w in zip(got, want):
        _close(g, w)
    want = JL._mla_kv_compressed(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    got = TL.mla_kv_compressed(tp, torch.from_numpy(x), tcfg,
                               torch.from_numpy(pos))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("impl,ref_impl", [("pipeline", "xla"),
                                           ("chunked", "xla"),
                                           ("ref", "ref")])
@pytest.mark.parametrize("q_lora_rank", [0, 64])
def test_mla_apply_matches_reference(impl, ref_impl, q_lora_rank):
    jcfg, tcfg = _cfgs(q_lora_rank, attn_impl=impl)
    jcfg = dataclasses.replace(jcfg, attn_impl=ref_impl)
    p = _mla_params(tcfg, seed=5)
    jp, tp = _both(p)
    x = np.random.default_rng(6).normal(
        size=(2, 11, tcfg.d_model)).astype(np.float32)
    want = JL.mla_apply(jp, jnp.asarray(x), jcfg, causal=True)
    got = TL.mla_apply(tp, torch.from_numpy(x), tcfg, causal=True)
    _close(got, want)


@pytest.mark.parametrize("ragged", [False, True], ids=["scalar", "ragged"])
@pytest.mark.parametrize("q_lora_rank", [0, 64])
def test_mla_decode_matches_reference(ragged, q_lora_rank):
    """One absorbed decode step against a filled compressed cache, at one
    position for the batch or at a position per sequence (B = 3, each
    its own frontier): output and the cache written at ``pos``."""
    jcfg, tcfg = _cfgs(q_lora_rank)
    p = _mla_params(tcfg, seed=7)
    jp, tp = _both(p)
    rng = np.random.default_rng(8)
    b, max_len = 3, 12
    r, rope = tcfg.kv_lora_rank, tcfg.qk_rope_dim
    cache = {"ckv": rng.normal(size=(b, max_len, r)).astype(np.float32),
             "krope": rng.normal(size=(b, max_len, rope)).astype(np.float32)}
    x = rng.normal(size=(b, 1, tcfg.d_model)).astype(np.float32)
    pos = np.array([7, 2, 10]) if ragged else np.array(6)
    want, wcache = JL.mla_decode(jp, jnp.asarray(x),
                                 {k: jnp.asarray(v) for k, v in cache.items()},
                                 jnp.asarray(pos, jnp.int32), jcfg)
    tcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got, gcache = TL.mla_decode(tp, torch.from_numpy(x), tcache,
                                torch.from_numpy(pos), tcfg)
    _close(got, want)
    for k in cache:
        assert gcache[k] is tcache[k]         # written in place
        _close(tcache[k], wcache[k])


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference 2-layer deepseek-v3 (pipeline impls, backend
    ``jax``), its weights made non-trivial, and its logits on a forward
    pass, a prefill (and its cache) and every ragged decode step after
    it."""
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_KERNEL_CACHE", str(tmp_path_factory.mktemp("kernels")))
    JP.reset_default_cache()
    try:
        with jax.default_device(jax.devices("cpu")[0]), \
                jax.default_matmul_precision("highest"):
            cfg = JC.with_pipeline(
                JC.get_reduced_config(ARCH, n_layers=N_LAYERS),
                options=JP.CompileOptions(backend="jax"))
            model = JLM(cfg)
            params, _ = model.init_params(jax.random.key(0))
            tree = _nontrivial(jax.tree.map(np.asarray, params), seed=11)
            jp = jax.tree.map(jnp.asarray, tree)
            toks = _tokens((2, 14), cfg.vocab, seed=1)
            out = {"tree": tree, "toks": toks,
                   "forward": np.asarray(model.forward(
                       jp, jnp.asarray(toks, jnp.int32)))}
            p0, max_len = 8, 14
            lg, cache = model.prefill(jp, jnp.asarray(toks[:, :p0],
                                                      jnp.int32),
                                      max_len=max_len)
            out["prefill"] = np.asarray(lg)
            stages = [cache[f"stage{i}"]["sub0"] for i in range(2)]
            out["cache"] = {k: np.concatenate([np.asarray(st[k])
                                               for st in stages])
                            for k in ("ckv", "krope")}
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


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_model_forward_prefill_and_ragged_decode_match_reference(
        backend, reference):
    ref = reference
    cfg = dataclasses.replace(TC.get_reduced_config(ARCH, n_layers=N_LAYERS),
                              attn_impl="pipeline", mlp_impl="pipeline",
                              pipeline_backend=backend)
    assert [cfg.is_moe_layer(i) for i in range(N_LAYERS)] == [False, True]
    tm = TLM(cfg)
    tp = tm.from_jax_params(ref["tree"], device="cpu")
    assert set(tp["layers"][0]["mixer"]) == {"wq_a", "q_norm", "wq_b",
                                             "wkv_a", "kv_norm", "wkv_b",
                                             "wo"}
    toks = torch.from_numpy(ref["toks"])
    got = tm.forward(tp, toks).numpy()
    np.testing.assert_allclose(got, ref["forward"], rtol=TOL, atol=TOL)
    p0, max_len = 8, 14
    lg, cache = tm.prefill(tp, toks[:, :p0], max_len=max_len)
    np.testing.assert_allclose(lg.numpy(), ref["prefill"], rtol=TOL,
                               atol=TOL)
    assert sorted(cache) == ["ckv", "krope"]
    for k, want in ref["cache"].items():
        np.testing.assert_allclose(cache[k].numpy(), want, rtol=TOL,
                                   atol=TOL)
    pos = torch.tensor([p0, p0 - 3])
    for i, want in enumerate(ref["decode"]):
        lg, cache = tm.decode_step(tp, cache, toks[:, p0 + i:p0 + i + 1],
                                   pos + i)
        np.testing.assert_allclose(lg.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("backend,capacity_factor", [
    pytest.param("cuda", None, id="cuda"),
    # the full config's capacity factor: experts drop tokens
    pytest.param("torch", 1.25, id="drops-torch")])
def test_greedy_tokens_equal_reference_engine(backend, capacity_factor,
                                              tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_KERNEL_CACHE", str(tmp_path / "ref"))
    monkeypatch.setenv("REPRO_TORCH_KERNEL_CACHE", str(tmp_path / "port"))
    JP.reset_default_cache()
    over = {} if capacity_factor is None else {
        "capacity_factor": capacity_factor}
    try:
        mc = JC.with_pipeline(JC.get_reduced_config(ARCH, n_layers=2,
                                                    **over),
                              options=JP.CompileOptions(backend="jax"))
        ref = JEngine(mc, max_batch=3, max_len=48, prompt_buckets=(8, 16),
                      seed=0, repromote_after=None)
        trace = j_synth_trace(5, seed=0, prompt_lens=(3, 14),
                              gen_lens=(2, 6), vocab=mc.vocab)
        want = ref.run(trace)
    finally:
        JP.reset_default_cache()
    cfg = S.ServeConfig(arch=ARCH, reduced=True, n_layers=2,
                        backend=backend, device="cpu", max_batch=3,
                        max_len=48, prompt_buckets=(8, 16), seed=0)
    mc = dataclasses.replace(S.model_config(cfg), **over)
    params = TLM(mc).from_jax_params(jax.tree.map(np.asarray, ref.params),
                                     "cpu")
    engine = Engine(mc, params=params, device="cpu", max_batch=3,
                    max_len=48, prompt_buckets=(8, 16), seed=0)
    assert sorted(engine.caches) == ["ckv", "krope"]
    got = engine.run(trace)
    assert got.n_completed == want.n_completed == len(trace)
    assert got.tokens == want.tokens
    assert got.decode_recompiles == 0


def test_served_programs_at_full_width_have_no_attention(tmp_path,
                                                         monkeypatch):
    """deepseek-v3 at full width, cut to 2 layers: the serving path's
    programs are the dense layer's SwiGLU only (MLA never takes the
    attention pipeline), each emitting one kernel for each planned group
    (3 at d 7168, d_ff 18432) within shared memory."""
    from repro_torch import pipeline as TP
    from repro_torch.core import codegen_cuda as CC
    monkeypatch.setenv("REPRO_TORCH_KERNEL_CACHE", str(tmp_path))
    TP.reset_default_cache()
    try:
        mc = S.model_config(S.ServeConfig(arch=ARCH, n_layers=2))
        progs = TL.pipeline_kernels(mc, prefill_lens=(8, 16, 32),
                                    decode_batch=4, max_len=96,
                                    device="cpu")
    finally:
        TP.reset_default_cache()
    assert sorted(progs) == ["swiglu_decode", "swiglu_prefill16",
                             "swiglu_prefill32", "swiglu_prefill8"]
    for name, kern in progs.items():
        assert kern.lowering_report.degraded == [], name
        assert len(kern.kernels) == 3, name
        assert all(k.smem_bytes <= CC.SMEM_LIMIT for k in kern.kernels)


@pytest.mark.parametrize("arch,mixer", [(ARCH, "mla"),
                                        ("qwen3-moe-30b-a3b", "attn")])
def test_pipeline_kernels_skip_a_model_of_moe_layers_only(arch, mixer):
    """Cut to 1 layer, deepseek-v3 is one MLA+MoE layer: no program at
    all; qwen3-moe keeps its attention programs and has no SwiGLU."""
    mc = S.model_config(S.ServeConfig(arch=arch, reduced=True, n_layers=1,
                                      backend="torch", device="cpu"))
    assert mc.mixer_of(0) == mixer and mc.is_moe_layer(0)
    progs = TL.pipeline_kernels(mc, prefill_lens=(8,), decode_batch=2,
                                max_len=16, device="cpu")
    assert sorted(progs) == ([] if mixer == "mla" else
                             ["attention_decode", "attention_prefill8"])


@pytest.mark.parametrize("arch,n_layers,moe", [
    (ARCH, 2, [False, True]),
    (ARCH, 1, [True]),
    (ARCH, 4, [False, False, False, True]),
    (ARCH, None, [False] * 3 + [True] * 58),
    ("qwen3-moe-30b-a3b", 2, [True, True]),
    ("llama3.2-1b", 2, [False, False])])
def test_depth_cut_keeps_the_layer_mix(arch, n_layers, moe):
    mc = S.model_config(S.ServeConfig(arch=arch, n_layers=n_layers))
    assert [mc.is_moe_layer(i) for i in range(mc.n_layers)] == moe
    assert (mc.d_model, mc.n_experts) == (TC.get_config(arch).d_model,
                                          TC.get_config(arch).n_experts)


def test_step_bound_counts_the_compressed_cache():
    """``profile_decode.step_cost`` reads the engine's own caches: MLA's
    rows are ``kv_lora_rank + qk_rope_dim`` values a layer, not
    ``2 n_kv_heads d_head``; the untied embedding's unread rows are left
    out, and the MoE layer's experts multiply only their capacity's
    rows."""
    cfg = S.ServeConfig(arch=ARCH, reduced=True, n_layers=2,
                        backend="torch", device="cpu", max_batch=3,
                        max_len=48, prompt_buckets=(8, 16))
    engine = S.build_engine(cfg)
    mc = engine.cfg
    assert not mc.tie_embeddings and mc.is_moe_layer(1)
    weights = sum(t.numel() for t in PD._tensors(engine.params))
    read = weights - (mc.vocab - 3) * mc.d_model
    experts = sum(t.numel() for k, t in engine.params["layers"][1][
        "mlp"].items() if k.startswith("we_"))
    step_bytes, step_flops = PD.step_cost(
        mc, engine.params, engine.caches, engine.max_batch, 10,
        engine.max_len)
    rows = mc.n_layers * 3 * 11 * (mc.kv_lora_rank + mc.qk_rope_dim)
    assert step_bytes == 4 * (read + rows + 3 * mc.vocab)
    assert step_flops == 2 * (3 * (read - experts)
                              + TL.moe_capacity(3, mc) * experts)
