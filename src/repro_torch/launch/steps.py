"""Step functions of the torch port: the port of the step factories of
``repro.launch.steps`` (steps.py:24, 124-150).

A batch is a dict of tensors: ``tokens`` and ``labels`` (B, S), plus a
VLM's ``vision_embeds`` (B, n_vision_tokens, d_model) or an
encoder-decoder's ``frames`` (B, enc_seq, d_model), which go to the
model's ``loss``/``prefill`` by name.  The reference's ``input_specs``,
``batch_shardings``, ``make_step`` and ``sanitize_shardings`` lay a step
out over a device mesh for its dry-run; they wait for the port's
multi-device slice.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils import _pytree as pytree

from repro_torch.optim import AdamW, cosine_schedule


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


def make_train_step(model, optimizer: AdamW):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients, then ``optimizer.update``;
    ``metrics`` holds ``loss``, ``grad_norm`` and ``lr`` as tensors."""
    def train_step(params, opt_state, batch):
        loss, grads = value_and_grad(model, params, batch)
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
        return torch.argmax(logits[:, -1], dim=-1), cache
    return serve_step
