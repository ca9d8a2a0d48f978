"""The port's training path against the JAX reference on the same weights.

* ``LM.loss`` / ``EncDec.loss`` and their gradients (``launch.steps.
  value_and_grad``) for nine reduced architectures (2 layers: deepseek-v3
  is 1 dense + 1 MoE layer, jamba a period of 2: a Mamba2+SwiGLU and an
  attention+MoE layer), on the reference's weights carried over by
  ``from_jax_params`` (which carries the reference's gradient trees too),
  against ``jax.value_and_grad(model.loss)``: the loss within 1e-5
  relative, each gradient leaf within 1e-4 of its largest magnitude;
* ``softmax_xent``'s gathered gold logit equals the reference's one-hot
  form (1e-6);
* remat (``full`` and ``dots``) gives the gradients of no remat (1e-6),
  and recomputes every hand-kernel call once: twice the forward's calls
  a step, once under ``torch.no_grad``;
* the hand-kernel impls (``cuda``; their plain versions on CPU tensors)
  give the plain impls' loss and gradients (1e-5), jamba's among them
  (flash attention without rope beside a Mamba2 layer).

The train step and ``train.main`` are held in
``test_torch_train_loop.py``.
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
from repro.models import common as JCM
from repro.models.lm import build_model as jbuild
from repro_torch import configs as TC
from repro_torch.kernels import ops as K
from repro_torch.launch import steps as TS
from repro_torch.models import common as TCM
from repro_torch.models.lm import build_model as tbuild
import torch_port  # noqa: F401

N_LAYERS = 2
ARCHS = ["smollm-135m", "qwen2-7b", "qwen3-32b", "qwen3-moe-30b-a3b",
         "deepseek-v3-671b", "mamba2-2.7b", "internvl2-26b", "whisper-tiny",
         "jamba-1.5-large-398b"]
#: a hybrid holds whole periods: jamba's is cut to 2 layers here (its
#: period of 8 is held in test_torch_hybrid.py, by relative L2: through 7
#: SSD layers float32 leaves some leaf past GRAD_TOL of its largest
#: value, as it does mamba2-2.7b's at 8 layers)
PERIOD = {"jamba-1.5-large-398b": {"attn_period": N_LAYERS}}
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4     # of the leaf's largest magnitude


def _models(arch, seed=0, **over):
    """The reference model, its weights (numpy), and the port's model and
    the same weights."""
    period = PERIOD.get(arch, {})
    jcfg = JC.get_reduced_config(arch, n_layers=N_LAYERS, **period)
    tcfg = dataclasses.replace(TC.get_reduced_config(arch,
                                                     n_layers=N_LAYERS,
                                                     **period), **over)
    jm = jbuild(jcfg)
    params, _ = jm.init_params(jax.random.key(seed))
    tree = jax.tree.map(np.asarray, params)
    tm = tbuild(tcfg)
    return jm, tree, tm, tm.from_jax_params(tree, device="cpu")


def _batch(cfg, b=2, s=16, seed=0):
    """numpy tokens and labels (the data pipeline's), and a VLM's vision
    embeddings or an encoder-decoder's frames."""
    from repro_torch.data import SyntheticLMData
    batch = SyntheticLMData(cfg.vocab, s, b, seed=seed).numpy_batch(seed)
    rng = np.random.default_rng(seed + 1)
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.normal(
            size=(b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


def _reference_value_and_grad(jm, tree, batch):
    extra = {k: jnp.asarray(v) for k, v in batch.items()
             if k not in ("tokens", "labels")}
    loss, grads = jax.value_and_grad(jm.loss)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(batch["tokens"]),
        jnp.asarray(batch["labels"]), **extra)
    return float(loss), jax.tree.map(np.asarray, grads)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _leaves_with_paths(tree):
    flat, _ = pytree.tree_flatten_with_path(tree)
    return {pytree.keystr(p): leaf for p, leaf in flat}


def _assert_grads_close(got, want, tol=GRAD_TOL):
    got, want = _leaves_with_paths(got), _leaves_with_paths(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        w = w.detach().numpy()
        err = np.abs(got[k].detach().numpy() - w).max()
        assert err <= tol * np.abs(w).max(), (k, err, np.abs(w).max())


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    jm, tree, tm, tp = _models(arch)
    batch = _batch(tm.cfg)
    want_loss, want_grads = _reference_value_and_grad(jm, tree, batch)
    loss, grads = TS.value_and_grad(tm, tp, _torch_batch(batch))
    assert abs(loss.item() - want_loss) <= LOSS_RTOL * abs(want_loss)
    _assert_grads_close(grads, tm.from_jax_params(want_grads, device="cpu"))


def test_vlm_loss_scores_the_text_positions_only():
    """internvl's loss slices the vision positions off: the logits the loss
    scores are the last ``S`` positions of the forward pass."""
    _, _, tm, tp = _models("internvl2-26b")
    batch = _torch_batch(_batch(tm.cfg))
    with torch.no_grad():
        logits = tm.forward(tp, batch["tokens"], batch["vision_embeds"])
        loss = tm.loss(tp, batch["tokens"], batch["labels"],
                       batch["vision_embeds"])
    s = batch["tokens"].shape[1]
    assert logits.shape[1] == tm.cfg.n_vision_tokens + s
    want = TCM.softmax_xent(logits[:, -s:], batch["labels"])
    assert torch.equal(loss, want)


@pytest.mark.parametrize("shape", [(2, 5, 512), (3, 7, 49)])
def test_softmax_xent_gather_equals_onehot_and_reference(shape):
    rng = np.random.default_rng(sum(shape))
    logits = (rng.normal(size=shape) * 4).astype(np.float32)
    labels = rng.integers(0, shape[-1], shape[:-1]).astype(np.int32)
    want = float(JCM.softmax_xent(jnp.asarray(logits), jnp.asarray(labels)))
    lt, yt = torch.from_numpy(logits), torch.from_numpy(labels)
    gathered = TCM.softmax_xent(lt, yt).item()
    onehot = TCM.softmax_xent(lt, yt, onehot=True).item()
    assert abs(gathered - onehot) <= 1e-6 * abs(onehot)
    assert abs(gathered - want) <= 1e-6 * abs(want)


@pytest.fixture
def kernel_calls(monkeypatch):
    """Counts of the hand-kernel wrappers' calls through ``kernels.ops``
    (on CPU tensors they run their plain versions)."""
    counts = {"flash_attention": 0, "rmsnorm_swiglu": 0,
              "layernorm_matmul": 0}
    for name in counts:
        fn = getattr(K, f"{name}_cuda")

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(K, f"{name}_cuda", counted)
    return counts


@pytest.mark.parametrize("arch", ["smollm-135m", "whisper-tiny"])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_recomputes_each_kernel_and_keeps_the_gradients(
        arch, policy, kernel_calls):
    _, _, tm, tp = _models(arch, attn_impl="cuda", mlp_impl="cuda")
    batch = _torch_batch(_batch(tm.cfg))
    loss0, grads0 = TS.value_and_grad(tm, tp, batch)
    once = dict(kernel_calls)
    assert sum(once.values()) > 0
    on = tbuild(dataclasses.replace(tm.cfg, remat=True,
                                    remat_policy=policy))
    for k in kernel_calls:
        kernel_calls[k] = 0
    loss1, grads1 = TS.value_and_grad(on, tp, batch)
    assert kernel_calls == {k: 2 * n for k, n in once.items()}
    assert torch.equal(loss0, loss1)
    for k, g in _leaves_with_paths(grads0).items():
        torch.testing.assert_close(_leaves_with_paths(grads1)[k], g,
                                   rtol=1e-6, atol=1e-6)
    for k in kernel_calls:
        kernel_calls[k] = 0
    with torch.no_grad():
        on.loss(tp, batch["tokens"], batch["labels"],
                **({"frames": batch["frames"]} if "frames" in batch
                   else {}))
    assert kernel_calls == once


@pytest.mark.parametrize("arch", ["smollm-135m", "internvl2-26b",
                                  "whisper-tiny", "jamba-1.5-large-398b"])
def test_hand_impls_match_plain_impls(arch):
    _, _, hand, tp = _models(arch, attn_impl="cuda", mlp_impl="cuda")
    plain = tbuild(dataclasses.replace(hand.cfg, attn_impl="ref",
                                       mlp_impl="unfused"))
    batch = _torch_batch(_batch(hand.cfg))
    loss_h, grads_h = TS.value_and_grad(hand, tp, batch)
    loss_p, grads_p = TS.value_and_grad(plain, tp, batch)
    assert abs(loss_h.item() - loss_p.item()) <= 1e-5 * abs(loss_p.item())
    _assert_grads_close(grads_h, grads_p, tol=1e-5)
