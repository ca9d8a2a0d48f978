"""The port's hybrid family (jamba-1.5-large-398b) against the JAX
reference.

* the jamba config, full and reduced (one period of 8 layers), equals
  the reference's field for field; ``SHAPES``, ``SUBQUADRATIC``,
  ``cell_supported`` and ``all_cells`` equal the reference's;
* ``mixer_of``, ``mlp_of``, ``is_attn_layer`` and ``is_moe_layer`` lay
  every layer out as the reference's ``plan_stages`` does, for every
  decoder-only architecture, full and reduced;
* ``from_jax_params`` carries every sub-layer of a period, interleaved
  (layer ``s * 8 + j`` is ``stage0/sub{j}[s]``), and ``init_params`` draws
  the same layout; the cache is ``k``/``v`` over the attention layers and
  ``h``/``conv`` over the Mamba2 layers (``LM.slots``);
* the reduced model's forward, prefill (logits and every cache entry by
  name) and decode steps equal the reference's within 1e-4, on the plain
  impls and on the pipeline with the ``cuda`` backend (its kernels' plain
  versions on CPU tensors); prefill then decode equals the forward pass;
* the loss within 1e-4 relative and every gradient leaf within 1e-3
  relative L2 of ``jax.value_and_grad``;
* the serving engine refuses ``hybrid``, as the reference's does;
  ``serve.cut_depth`` keeps whole periods; ``launch/train.py`` trains the
  reduced model on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

from reference_cpu import reference_on_cpu  # noqa: F401
from repro import configs as JC
from repro.models.lm import LM as JLM
from repro.models.lm import plan_stages
from repro_torch import configs as TC
from repro_torch.data import SyntheticLMData
from repro_torch.launch import serve as S
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TT
from repro_torch.launch.engine import Engine
from repro_torch.models.lm import LM as TLM
from torch_port import reference_fields

ARCH = "jamba-1.5-large-398b"
TOL = 1e-4
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-3    # relative L2, each leaf
#: parameters the reference initialises to zeros or ones: their init and
#: the spread of the seeded values set in their place
TRIVIAL = {"conv_b": (0.0, 0.1), "A_log": (0.0, 0.5),
           "dt_bias": (0.0, 0.5), "D": (0.0, 0.5), "ssm_norm": (1.0, 0.1),
           "ln1": (1.0, 0.1), "ln2": (1.0, 0.1), "ln_f": (1.0, 0.1)}
#: the port's impls under test: the plain ones, and the pipeline on the
#: cuda backend (each emitted kernel's plain version on CPU tensors)
IMPLS = {"plain": {},
         "pipeline-cuda": dict(attn_impl="pipeline", mlp_impl="pipeline",
                               pipeline_backend="cuda")}


@pytest.mark.parametrize("get", ["get_config", "get_reduced_config"])
def test_config_matches_reference(get):
    port, ref = getattr(TC, get)(ARCH), getattr(JC, get)(ARCH)
    for name, value in reference_fields(port).items():
        assert value == getattr(ref, name), (get, name)
    assert port.n_layers == (72 if get == "get_config" else 8)
    assert port.expert_share is None and port.held_experts == (
        0, port.n_experts)


def test_shape_sets_match_reference():
    assert {k: dataclasses.astuple(v) for k, v in TC.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in JC.SHAPES.items()}
    assert TC.SUBQUADRATIC == JC.SUBQUADRATIC
    assert TC.all_cells() == JC.all_cells()
    for arch, shape in JC.all_cells():
        assert TC.cell_supported(arch, shape) == JC.cell_supported(arch,
                                                                   shape)
    assert list(TC.ARCHS) == list(JC.ARCHS)


def _planned(cfg):
    """(mixer, mlp) of every layer by the reference's ``plan_stages``."""
    out = []
    for stage in plan_stages(cfg):
        for _ in range(stage.n):
            out += [(sub.mixer, sub.mlp) for sub in stage.subs]
    return out


@pytest.mark.parametrize("get", ["get_config", "get_reduced_config"])
@pytest.mark.parametrize("arch", [a for a in JC.ARCHS
                                  if JC.ARCHS[a].family != "encdec"])
def test_layer_plan_matches_plan_stages(arch, get):
    port, ref = getattr(TC, get)(arch), getattr(JC, get)(arch)
    want = _planned(ref)
    assert len(want) == port.n_layers
    assert [(port.mixer_of(i), port.mlp_of(i))
            for i in range(port.n_layers)] == want
    assert [port.is_moe_layer(i) for i in range(port.n_layers)] == [
        ref.is_moe_layer(i) for i in range(ref.n_layers)]
    assert [port.is_attn_layer(i) for i in range(port.n_layers)] == [
        ref.is_attn_layer(i) for i in range(ref.n_layers)]


def test_jamba_period_layout():
    cfg = TC.get_config(ARCH)
    model = TLM(cfg)
    assert model.mixers[:8] == ("mamba",) * 4 + ("attn",) + ("mamba",) * 3
    assert [cfg.mlp_of(i) for i in range(8)] == ["swiglu", "moe"] * 4
    assert model.slots[:16] == (0, 1, 2, 3, 0, 4, 5, 6,
                                7, 8, 9, 10, 1, 11, 12, 13)
    with pytest.raises(ValueError, match="whole periods"):
        TLM(dataclasses.replace(cfg, n_layers=12))


def _nontrivial(tree, seed):
    """The numpy tree with every zero- or one-initialised parameter set to
    seeded values around its init (a missing term would hide there)."""
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


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape)


@pytest.fixture(scope="module")
def reference():
    """The reference's reduced jamba (one period), its weights made
    non-trivial, and its logits on a forward pass of 15 tokens, a prefill
    of 9 tokens (max_len 15, and its cache), the decode steps after it,
    and the loss and its gradients on a batch of ``SyntheticLMData``."""
    with jax.default_device(jax.devices("cpu")[0]), \
            jax.default_matmul_precision("highest"):
        cfg = JC.get_reduced_config(ARCH)
        model = JLM(cfg)
        params, _ = model.init_params(jax.random.key(0))
        tree = _nontrivial(jax.tree.map(np.asarray, params), seed=31)
        jp = jax.tree.map(jnp.asarray, tree)
        toks = _tokens((2, 15), cfg.vocab, seed=32)
        out = {"tree": tree, "toks": toks,
               "forward": np.asarray(model.forward(
                   jp, jnp.asarray(toks, jnp.int32)))}
        p0 = 9
        lg, cache = model.prefill(jp, jnp.asarray(toks[:, :p0], jnp.int32),
                                  max_len=15)
        out["prefill"] = np.asarray(lg)
        out["cache"] = jax.tree.map(np.asarray, cache)
        steps = []
        for i in range(15 - p0):
            tok = jnp.asarray(toks[:, p0 + i:p0 + i + 1], jnp.int32)
            lg, cache = model.decode_step(jp, cache, tok, p0 + i)
            steps.append(np.asarray(lg))
        out["decode"] = steps
        batch = SyntheticLMData(cfg.vocab, 16, 2, seed=0).numpy_batch(0)
        loss, grads = jax.value_and_grad(model.loss)(
            jp, jnp.asarray(batch["tokens"]), jnp.asarray(batch["labels"]))
        out.update(batch=batch, loss=float(loss),
                   grads=jax.tree.map(np.asarray, grads))
    return out


def _port(reference, impl):
    cfg = dataclasses.replace(TC.get_reduced_config(ARCH), **IMPLS[impl])
    tm = TLM(cfg)
    return tm, tm.from_jax_params(reference["tree"], device="cpu")


def test_from_jax_params_interleaves_every_sub_layer(reference):
    tm, tp = _port(reference, "plain")
    stage = reference["tree"]["stage0"]
    assert sorted(stage) == [f"sub{j}" for j in range(8)]
    for i, layer in enumerate(tp["layers"]):
        sub = stage[f"sub{i % 8}"]
        flat, _ = pytree.tree_flatten_with_path(layer)
        for path, leaf in flat:
            want = sub
            for key in path:
                want = want[key.key]
            np.testing.assert_array_equal(leaf.numpy(), want[i // 8])
        assert set(layer) == {"ln1", "mixer", "ln2", "mlp"}
        assert ("router" in layer["mlp"]) == (i % 2 == 1)
        assert ("wq" in layer["mixer"]) == (i == 4)


def test_init_params_and_cache_layout():
    cfg = TC.get_reduced_config(ARCH)
    tm = TLM(cfg)
    tp = tm.init_params(seed=0, device="cpu")
    for i, layer in enumerate(tp["layers"]):
        assert set(layer) == {"ln1", "mixer", "ln2", "mlp"}
        assert ("we_gate" in layer["mlp"]) == cfg.is_moe_layer(i)
        assert ("w_in" in layer["mixer"]) == (tm.mixers[i] == "mamba")
    c = tm.init_cache(2, 64, device="cpu")
    assert sorted(c) == ["conv", "h", "k", "v"]
    assert c["k"].shape == (1, 2, cfg.n_kv_heads, 64, cfg.d_head)
    assert c["h"].shape == (7, 2, cfg.n_ssm_heads, cfg.ssm_head_dim,
                            cfg.ssm_state)
    assert c["h"].dtype == torch.float32
    assert c["conv"].shape == (7, 2, cfg.ssm_conv - 1,
                               cfg.d_inner + 2 * cfg.ssm_state)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_model_forward_prefill_and_decode_match_reference(reference, impl):
    tm, tp = _port(reference, impl)
    toks = torch.from_numpy(reference["toks"])
    with torch.no_grad():
        _close(tm.forward(tp, toks), reference["forward"])
        p0 = 9
        lg, cache = tm.prefill(tp, toks[:, :p0], max_len=15)
        _close(lg, reference["prefill"])
        assert sorted(cache) == ["conv", "h", "k", "v"]
        for i, mixer in enumerate(tm.mixers):
            want = reference["cache"]["stage0"][f"sub{i % 8}"]
            names = ("k", "v") if mixer == "attn" else ("h", "conv")
            assert sorted(want) == sorted(names)
            for name in names:
                got = cache[name][tm.slots[i]]
                assert got.shape == want[name][i // 8].shape
                _close(got, want[name][i // 8])
        for i, want in enumerate(reference["decode"]):
            lg, cache = tm.decode_step(tp, cache,
                                       toks[:, p0 + i:p0 + i + 1], p0 + i)
            _close(lg, want)


@pytest.mark.parametrize("p0", [1, 9, 40])
def test_prefill_then_decode_equals_forward(reference, p0):
    """Greedy decode after a prefill of ``p0`` tokens gives, at every
    step, the forward pass's logits over the same tokens (the reference's
    decode test, tests/test_models_decode.py:17-37, at tier-1 size; path
    E's rule on the card; 40 spans two SSD chunks)."""
    tm, tp = _port(reference, "plain")
    toks = torch.from_numpy(_tokens((2, p0), tm.cfg.vocab, seed=33))
    with torch.no_grad():
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


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


@pytest.mark.parametrize("impl", IMPLS)
def test_loss_and_grads_match_reference(reference, impl):
    """``LM.loss`` and its gradients (``launch.steps.value_and_grad``) on
    a batch of ``SyntheticLMData`` against ``jax.value_and_grad`` of the
    reference's loss (computed in the fixture)."""
    tm, tp = _port(reference, impl)
    loss, grads = TS.value_and_grad(
        tm, tp, {k: torch.from_numpy(v) for k, v in
                 reference["batch"].items()})
    assert abs(loss.item() - reference["loss"]) <= LOSS_RTOL * abs(
        reference["loss"])
    want = tm.from_jax_params(reference["grads"], device="cpu")
    got_l = dict(pytree.tree_flatten_with_path(grads)[0])
    want_l = dict(pytree.tree_flatten_with_path(want)[0])
    assert got_l.keys() == want_l.keys()
    for k, w in want_l.items():
        assert _rel_l2(got_l[k].numpy(), w.numpy()) <= GRAD_RTOL, \
            pytree.keystr(k)


def test_engine_refuses_hybrid():
    with pytest.raises(ValueError, match="not served"):
        Engine(TC.get_reduced_config(ARCH), device="cpu")
    with pytest.raises(SystemExit):
        S.main(["--arch", ARCH, "--reduced", "--device", "cpu"])


@pytest.mark.parametrize("n_layers", [8, 16, 5, 12, 0])
def test_cut_depth_keeps_whole_periods(n_layers):
    cfg = TC.get_config(ARCH)
    if n_layers % 8 or not n_layers:
        with pytest.raises(ValueError, match="whole periods"):
            S.cut_depth(cfg, n_layers)
        return
    cut = S.cut_depth(cfg, n_layers)
    assert cut.n_layers == n_layers
    model = TLM(cut)
    assert model.mixers == TLM(cfg).mixers[:n_layers]
    assert [cut.mlp_of(i) for i in range(n_layers)] == [
        "swiglu", "moe"] * (n_layers // 2)


def test_train_main_trains_the_reduced_hybrid():
    out = TT.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                   "--steps", "3", "--batch", "2", "--seq", "16",
                   "--lr", "1e-2", "--log-every", "1", "--ckpt-every", "0"])
    losses = [loss for _, loss in out["losses"]]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert len(out["params"]["layers"]) == 8
