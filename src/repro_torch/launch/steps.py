"""Step functions and the inputs of every (arch x shape) cell: the port
of ``repro.launch.steps``.

A batch is a dict of tensors: ``tokens`` and ``labels`` (B, S), plus a
VLM's ``vision_embeds`` (B, n_vision_tokens, d_model) or an
encoder-decoder's ``frames`` (B, enc_seq, d_model), which go to the
model's ``loss``/``prefill`` by name.

``input_specs(cfg, shape)`` gives every input of a cell as a tensor on
the ``meta`` device (shape and dtype, no memory: the reference's
``ShapeDtypeStruct``s); ``train_4k``/``prefill_32k`` are train and
prefill steps, ``decode_*``/``long_*`` one new token against a
``seq_len`` cache.  ``make_step`` returns a cell's step function, its
arguments on ``meta`` and the builder of their shardings on a mesh
(``runtime.sharding.NamedSharding`` trees, ``sanitize_shardings``
applied), as the reference's does for its dry-run.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import ShapeSpec
from repro_torch.models.common import ModelConfig
from repro_torch.optim import AdamW, cosine_schedule
from repro_torch.runtime.sharding import (NamedSharding, Spec, constrain,
                                          fit_spec, logical_to_spec,
                                          tree_shardings)


def default_optimizer(total_steps: int = 10000) -> AdamW:
    return AdamW(lr=cosine_schedule(3e-4, 200, total_steps))


def _extras(batch: Dict[str, Any], *skip: str) -> Dict[str, Any]:
    return {k: v for k, v in batch.items() if k not in skip}


def value_and_grad(model, params, batch):
    """``(loss, grads)`` of ``model.loss`` on ``batch``: the loss detached,
    the gradients a tree shaped as ``params`` (the reference's
    ``jax.value_and_grad(model.loss)``)."""
    flat, spec = pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    with torch.enable_grad():
        loss = model.loss(pytree.tree_unflatten(leaves, spec),
                          batch["tokens"], batch["labels"],
                          **_extras(batch, "tokens", "labels"))
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), pytree.tree_unflatten(list(grads), spec)


def make_train_step(model, optimizer: AdamW, mesh=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients, then ``optimizer.update``;
    ``metrics`` holds ``loss``, ``grad_norm`` and ``lr`` as tensors.

    With a ``mesh``, ``batch`` is this rank's rows and the step is data
    parallel over the mesh's batch axes: the loss and gradients are the
    whole batch's (``runtime.collectives.data_parallel_mean``, weighted
    by each rank's labels), so the optimizer, its global-norm clip
    included, sees the global gradient, and the replicated parameters
    stay equal on every rank."""
    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(model, params, batch)
        if mesh is not None:
            from repro_torch.runtime.collectives import data_parallel_mean
            loss, grads = data_parallel_mean(loss, grads,
                                             batch["labels"].numel(), mesh)
        params, opt_state, metrics = optimizer.update(grads, opt_state,
                                                      params)
        return params, opt_state, {"loss": loss, **metrics}
    return train_step


def make_prefill_step(model):
    """``prefill_step(params, batch) -> (last logits, cache)``."""
    @torch.no_grad()
    def prefill_step(params, batch):
        logits, cache = model.prefill(params, batch["tokens"],
                                      **_extras(batch, "tokens"))
        return logits[:, -1], cache
    return prefill_step


def make_serve_step(model):
    """``serve_step(params, batch) -> (next tokens, cache)``: one greedy
    decode step on ``batch``'s ``cache``, ``tokens`` (B, 1) and ``pos``."""
    @torch.no_grad()
    def serve_step(params, batch):
        logits, cache = model.decode_step(params, batch["cache"],
                                          batch["tokens"], batch["pos"])
        # under a mesh, each row's whole vocabulary on its rank (a
        # vocabulary-sharded argmax splits rows it cannot, at batch 1)
        last = constrain(logits[:, -1], "batch", None)
        return torch.argmax(last, dim=-1), cache
    return serve_step


# ---------------------------------------------------------------------------
# the inputs of a cell, and their shardings on a mesh
# ---------------------------------------------------------------------------

def sanitize_shardings(shardings, abstract, mesh):
    """Drop a dimension's trailing mesh axes until their product divides
    it (explicit argument shardings need even splits: 8 KV heads on a
    16-way ``model`` axis, or batch 1 of a long decode on ``data``);
    reference steps.py:28-60.  ``shardings`` and ``abstract`` are trees of
    one layout, ``NamedSharding``s (or None) beside tensors."""
    def fix(sh, ab):
        if sh is None or not hasattr(ab, "shape"):
            return sh
        return NamedSharding(mesh, fit_spec(sh.spec, ab.shape, mesh))

    def walk(sh, ab):
        if isinstance(sh, dict):
            return {k: walk(v, ab[k]) for k, v in sh.items()}
        if isinstance(sh, (list, tuple)) and not isinstance(sh, Spec):
            return type(sh)(walk(v, a) for v, a in zip(sh, ab))
        return fix(sh, ab)

    return walk(shardings, abstract)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Every model input of one cell as a ``meta`` tensor (reference
    steps.py:70-96): a decode step's ``tokens`` (B, 1), scalar ``pos`` and
    the model's cache at ``seq_len``; a train or prefill step's tokens
    (and labels), with a VLM's ``vision_embeds`` or an encoder-decoder's
    ``frames``."""
    from repro_torch.models.lm import build_model
    b, s = shape.global_batch, shape.seq_len
    extras: Dict[str, Any] = {}
    if cfg.family == "vlm":
        extras["vision_embeds"] = _meta((b, cfg.n_vision_tokens,
                                         cfg.d_model), cfg.dtype)
    if cfg.family == "encdec":
        extras["frames"] = _meta((b, cfg.enc_seq, cfg.d_model), cfg.dtype)
    if shape.kind == "train":
        return {"tokens": _meta((b, s), torch.int32),
                "labels": _meta((b, s), torch.int32), **extras}
    if shape.kind == "prefill":
        return {"tokens": _meta((b, s), torch.int32), **extras}
    if shape.kind == "decode":
        return {"tokens": _meta((b, 1), torch.int32),
                "pos": _meta((), torch.int32),
                "cache": build_model(cfg).init_cache(b, s, device="meta")}
    raise ValueError(shape.kind)


def batch_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh,
                    model: Any) -> Dict[str, Any]:
    """``NamedSharding``s laid out as :func:`input_specs`' inputs."""
    def ns(axes):
        return NamedSharding(mesh, logical_to_spec(axes, mesh))

    extras = {}
    if cfg.family == "vlm":
        extras["vision_embeds"] = ns(("batch", None, None))
    if cfg.family == "encdec":
        extras["frames"] = ns(("batch", None, None))
    if shape.kind == "train":
        return {"tokens": ns(("batch", None)), "labels": ns(("batch", None)),
                **extras}
    if shape.kind == "prefill":
        return {"tokens": ns(("batch", None)), **extras}
    return {"tokens": ns(("batch", None)), "pos": ns(()),
            "cache": tree_shardings(model.cache_specs(), mesh)}


def make_step(cfg: ModelConfig, shape: ShapeSpec, model=None,
              optimizer: Optional[AdamW] = None):
    """``(step_fn, args, shardings)`` of one cell (reference
    steps.py:153-195): ``args`` match ``step_fn``'s signature on the
    ``meta`` device (parameters, the optimizer's state for a train step,
    the batch); ``shardings(mesh)`` gives their sanitized
    ``NamedSharding``s."""
    from repro_torch.models.lm import build_model
    model = model or build_model(cfg)
    specs = input_specs(cfg, shape)
    params_s = model.init_params(device="meta")
    param_specs = model.param_specs()

    if shape.kind == "train":
        optimizer = optimizer or default_optimizer()
        step = make_train_step(model, optimizer)
        opt_s = optimizer.init(params_s)
        opt_specs = optimizer.state_specs(param_specs)
        args = (params_s, opt_s, specs)

        def shardings(mesh):
            raw = (tree_shardings(param_specs, mesh),
                   tree_shardings(opt_specs, mesh),
                   batch_shardings(cfg, shape, mesh, model))
            return sanitize_shardings(raw, args, mesh)
        return step, args, shardings

    step = (make_prefill_step(model) if shape.kind == "prefill"
            else make_serve_step(model))
    args = (params_s, specs)

    def shardings(mesh):
        raw = (tree_shardings(param_specs, mesh),
               batch_shardings(cfg, shape, mesh, model))
        return sanitize_shardings(raw, args, mesh)
    return step, args, shardings
