"""Decoder-only LM of the torch port (``family`` ``"dense"``, ``"moe"``,
``"ssm"``, ``"hybrid"`` or ``"vlm"``): the port of ``repro.models.lm``.

Parameters are a dict: ``embed`` (vocab, d), ``ln_f`` (d,), ``head``
(d, vocab) when embeddings are untied, and ``layers``, one dict per layer
with ``ln1`` and ``mixer``, layer ``i``'s token mixer by
``cfg.mixer_of(i)``:

* ``attn``: ``wq``/``wk``/``wv``/``wo``, plus ``bq``/``bk``/``bv`` with
  ``qkv_bias`` and ``q_norm``/``k_norm`` with ``qk_norm``;
* ``mla`` (``use_mla``, deepseek-v3): ``wq_a``/``q_norm``/``wq_b`` (or
  ``wq``), ``wkv_a``, ``kv_norm``, ``wkv_b``, ``wo``;
* ``mamba`` (the ``ssm`` family, a hybrid's non-attention layers):
  ``w_in``, ``conv_w``/``conv_b``, ``A_log``, ``dt_bias``, ``D``,
  ``ssm_norm``, ``w_out``.

A layer with an MLP (``cfg.mlp_of(i)``: every layer but the ``ssm``
family's) also has ``ln2`` and ``mlp``: ``w_gate``/``w_up``/``w_down``
for a SwiGLU layer, ``router``/``we_gate``/``we_up``/``we_down`` (and
``shared_*``) for an MoE layer, the expert stacks holding the experts of
``cfg.held_experts``.  The layer plan is the reference's ``plan_stages``:
an MoE model has ``n_dense_layers`` SwiGLU layers, then MoE layers; a
hybrid (jamba) repeats a period of ``attn_period`` layers, attention at
``period // 2`` and Mamba2 elsewhere, the MLP the MoE every
``moe_period``-th layer.  The reference stacks each stage's super-layers
on a leading axis and scans them; the port loops over the list of
layers.

The cache is one flat dict of tensors by name, each stacked over the
layers of its mixer: ``{"k", "v"}`` (attention layers, batch, kv heads,
max_len, d_head); ``{"ckv", "krope"}`` (MLA layers, batch, max_len,
kv_lora_rank | qk_rope_dim); ``{"h", "conv"}`` (Mamba2 layers, batch,
heads, head_dim, state) in float32 and (Mamba2 layers, batch, ssm_conv -
1, d_inner + 2 state).  ``LM.slots[i]`` is layer ``i``'s index in its
mixer's stack (a hybrid's one attention layer a period is slot ``s`` of
``k``/``v``, its seven Mamba2 layers slots ``7 s`` to ``7 s + 6`` of
``h``/``conv``).  :meth:`LM.decode_step` updates the cache in place.

With ``attn_impl="cuda"`` and ``mlp_impl="cuda"`` the forward pass and
prefill run the paper's hand-written kernels (``kernels/ops.py``), as the
reference's ``"pallas"`` impls do (lm.py:286-294); decode on that
attention raises (``layers.attention_decode``).

A ``vlm`` model (internvl) takes precomputed vision embeddings
``(B, n_vision_tokens, d_model)``, prepended to the token embeddings
(the vision frontend is a stub, as in the reference); :meth:`LM.loss`
scores the text positions only.  Where autograd records, each layer is
recomputed in the backward pass (``cfg.remat``, ``common.remat``).

While a ``torch.profiler`` session records, the embedding, each layer's
mixer and MLP, and the head are model spans (``repro_torch.tracing``:
``embed``; ``attn``, ``mla`` or ``mamba``; ``swiglu`` or ``moe``;
``head``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch import tracing as T
from repro_torch.models import layers as L
from repro_torch.models.encdec import EncDec
from repro_torch.models.common import (ModelConfig, SpecBuilder,
                                       build_params, init_params, remat,
                                       rms_norm, softmax_xent)
from repro_torch.runtime.sharding import constrain

#: the families :class:`LM` runs
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm")
#: the cache tensors of each mixer
CACHE_NAMES = {"attn": ("k", "v"), "mla": ("ckv", "krope"),
               "mamba": ("h", "conv")}
#: the logical axes of each cache tensor past its stacked layer axis
#: (reference layers.py:239, 360, 764)
CACHE_AXES = {"k": ("batch", "tensor", "kv_seq", None),
              "v": ("batch", "tensor", "kv_seq", None),
              "ckv": ("batch", "kv_seq", None),
              "krope": ("batch", "kv_seq", None),
              "h": ("batch", "tensor", None, None),
              "conv": ("batch", None, "tensor")}


class LM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in FAMILIES:
            raise ValueError(f"family {cfg.family!r} is not ported yet")
        if cfg.family == "hybrid" and cfg.n_layers % cfg.attn_period:
            raise ValueError(f"a hybrid holds whole periods: {cfg.n_layers} "
                             f"layers, period {cfg.attn_period}")
        self.cfg = cfg
        self.mixers = tuple(cfg.mixer_of(i) for i in range(cfg.n_layers))
        seen: Dict[str, int] = {}
        slots = []
        for m in self.mixers:
            slots.append(seen.get(m, 0))
            seen[m] = slots[-1] + 1
        self.slots = tuple(slots)

    # -- params ---------------------------------------------------------------
    def init_params(self, seed: int = 0, device="cuda") -> Dict[str, Any]:
        """Random weights from a seed (``models.common.init_params``);
        shapes alone on the ``meta`` device."""
        return init_params(self.cfg, seed, device)

    def param_specs(self) -> Dict[str, Any]:
        """Each parameter's logical axes (``runtime.sharding``), in the
        parameters' layout: the reference's spec tree laid out as
        :meth:`from_jax_params` lays out its arrays, a layer's leaves
        without the stacked layer axis."""
        return build_params(self.cfg, SpecBuilder())

    def from_jax_params(self, tree, device="cuda") -> Dict[str, Any]:
        """The port's parameters from the reference's ``LM.init_params``
        tree (arrays converted to numpy), or a gradient tree of the same
        layout: layer ``s * P + j`` of a stage of ``P`` sub-layers is
        ``stageN/sub{j}`` at index ``s`` of its leading axis (reference
        lm.py:166-186), the stages in layer order.  The expert stacks are
        cut to ``cfg.held_experts``."""
        dtype = self.cfg.dtype
        base, count = self.cfg.held_experts

        def t(a):
            return torch.from_numpy(np.array(a, dtype=np.float32)).to(
                device=device, dtype=dtype)

        def sub(name, a, i):
            a = a[i]
            if name.startswith("we_"):
                a = a[base:base + count]
            return t(a)

        def layer(stack, i):
            return {name: ({k: sub(k, a, i) for k, a in part.items()}
                           if isinstance(part, dict) else t(part[i]))
                    for name, part in stack.items()}

        layers = []
        for si in sorted(int(k[5:]) for k in tree if k.startswith("stage")):
            stage = tree[f"stage{si}"]
            subs = [stage[f"sub{j}"] for j in range(len(stage))]
            layers += [layer(st, i) for i in range(len(subs[0]["ln1"]))
                       for st in subs]
        if len(layers) != self.cfg.n_layers:
            raise ValueError(f"the tree holds {len(layers)} layers, the "
                             f"config {self.cfg.n_layers}")
        params = {"embed": t(tree["embed"]), "layers": layers,
                  "ln_f": t(tree["ln_f"])}
        if "head" in tree:
            params["head"] = t(tree["head"])
        return params

    # -- forward --------------------------------------------------------------
    def _embed(self, params, tokens, vision_embeds=None):
        with T.model_span("embed"):
            x = L.embed(params["embed"], tokens).to(self.cfg.dtype)
            if self.cfg.family == "vlm" and vision_embeds is not None:
                x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
            return constrain(x, "batch", None, None)

    def _logits(self, params, x):
        with T.model_span("head"):
            x = rms_norm(x, params["ln_f"], self.cfg.norm_eps)
            head = (constrain(params["embed"], "tensor", None).T
                    if self.cfg.tie_embeddings
                    else constrain(params["head"], None, "tensor"))
            return constrain(x @ head, "batch", None, "tensor")

    def _mlp(self, p, x, i, assigned=None):
        """Layer ``i``'s MLP residual step (none in an ``ssm`` layer);
        ``assigned`` as ``layers.moe_apply`` takes it."""
        kind = self.cfg.mlp_of(i)
        if kind == "none":
            return x
        with T.model_span(kind):
            return x + L.mlp_apply(p["mlp"], x, p["ln2"], self.cfg, i,
                                   assigned)

    def _layer(self, p, x, i):
        """Layer ``i``: its mixer, then its MLP, each a residual step."""
        cfg = self.cfg
        with T.model_span(self.mixers[i]):
            if self.mixers[i] == "mamba":
                x = x + L.mamba_apply(p["mixer"], x, p["ln1"], cfg)
            else:
                mix = (L.mla_apply if self.mixers[i] == "mla"
                       else L.attention_apply)
                x = x + mix(p["mixer"], rms_norm(x, p["ln1"], cfg.norm_eps),
                            cfg, causal=True)
        return self._mlp(p, x, i)

    def forward(self, params, tokens, vision_embeds=None) -> torch.Tensor:
        x = self._embed(params, tokens, vision_embeds)
        for i, p in enumerate(params["layers"]):
            x = remat(self._layer, self.cfg, p, x, i)
        return self._logits(params, x)

    def loss(self, params, tokens, labels, vision_embeds=None
             ) -> torch.Tensor:
        """Mean next-token cross entropy of ``labels`` (B, S); a VLM's
        vision positions are sliced off first (reference lm.py:217-221)."""
        logits = self.forward(params, tokens, vision_embeds)
        if self.cfg.family == "vlm" and vision_embeds is not None:
            logits = logits[:, vision_embeds.shape[1]:]
        return softmax_xent(logits, labels)

    # -- caches ---------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device="cuda"):
        """Zeros of the cache layout (module docstring): each mixer's
        tensors stacked over that mixer's layers."""
        cfg = self.cfg
        out = {}
        for m in dict.fromkeys(self.mixers):
            if m == "mamba":
                one = L.mamba_init_cache(cfg, batch, cfg.dtype, device)
            elif m == "mla":
                one = L.mla_init_cache(cfg, batch, max_len, cfg.dtype, device)
            else:
                one = L.attention_init_cache(cfg, batch, max_len, cfg.dtype,
                                             device)
            n = self.mixers.count(m)
            out.update({name: t.new_zeros((n, *t.shape))
                        for name, t in one.items()})
        return out

    def cache_specs(self) -> Dict[str, tuple]:
        """The cache's logical axes by name (reference lm.py:236): the
        stacked layer axis (replicated), then the mixer's own."""
        return {name: (None,) + CACHE_AXES[name]
                for m in dict.fromkeys(self.mixers)
                for name in CACHE_NAMES[m]}

    # -- prefill / decode -----------------------------------------------------
    def _prefill_mixer(self, p, x, i, max_len: int):
        """Layer ``i``'s mixer over the prompt ``x`` (B, S, d): its residual
        increment and its cache entries, each sequence axis padded to
        ``max_len``."""
        cfg = self.cfg
        b, s = x.shape[:2]
        pad = (0, 0, 0, max_len - s)
        pos = torch.arange(s, device=x.device)
        if self.mixers[i] == "mamba":
            return L.mamba_prefill(p["mixer"], x, p["ln1"], cfg)
        xn = rms_norm(x, p["ln1"], cfg.norm_eps)
        if self.mixers[i] == "mla":
            # the reference's lm.py:307-319: the layer, then the cache from
            # the compressed projections of the same input
            y = L.mla_apply(p["mixer"], xn, cfg)
            ckv, krope = L.mla_kv_compressed(p["mixer"], xn, cfg, pos)
            return y, {"ckv": L.pad_seq(ckv, pad).to(cfg.dtype),
                       "krope": L.pad_seq(krope, pad).to(cfg.dtype)}
        q, k, v = L.qkv(p["mixer"], xn, cfg,
                        pos if cfg.rope_theta > 0 else None)
        y = L._attend(q, k, v, cfg, causal=True)
        y = y.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.d_head)
        return L.out_proj(y, p["mixer"]["wo"], cfg.n_heads), {
            "k": L.pad_seq(k, pad).to(cfg.dtype),
            "v": L.pad_seq(v, pad).to(cfg.dtype)}

    def prefill(self, params, tokens, max_len: Optional[int] = None,
                vision_embeds=None):
        """Run the prompt (after a VLM's vision embeddings); returns logits
        and a cache filled to the prompt length, its sequence axis padded to
        ``max_len`` for later decode steps (a Mamba2 cache has no sequence
        axis)."""
        x = self._embed(params, tokens, vision_embeds)
        max_len = max_len or x.shape[1]
        caches: Dict[str, list] = {}
        for i, p in enumerate(params["layers"]):
            with T.model_span(self.mixers[i]):
                y, cache = self._prefill_mixer(p, x, i, max_len)
            for name, t in cache.items():
                caches.setdefault(name, []).append(t)
            x = self._mlp(p, x + y, i)
        return self._logits(params, x), {
            name: torch.stack(ts) for name, ts in caches.items()}

    def _decode_mixer(self, p, x, i, cache, pos):
        """Layer ``i``'s mixer for one token ``x`` (B, 1, d): its residual
        increment.  ``cache`` is the layer's own entry of each of its
        mixer's tensors (``caches[name][slots[i]]``), updated in place."""
        cfg = self.cfg
        if self.mixers[i] == "mamba":
            y, new = L.mamba_decode(p["mixer"], x, p["ln1"], cache, cfg)
            for name, t in new.items():
                cache[name].copy_(t)
            return y
        dec = L.mla_decode if self.mixers[i] == "mla" else L.attention_decode
        return dec(p["mixer"], rms_norm(x, p["ln1"], cfg.norm_eps), cache,
                   pos, cfg)[0]

    def decode_step(self, params, caches, tokens, pos, assigned=None):
        """tokens: (B, 1); pos: the filled cache length, a scalar or a
        (B,) vector (ragged continuous batching; a Mamba2 step takes no
        position).  Writes the new cache entries into ``caches`` in place
        and returns ``(logits, caches)``.  ``assigned``, a list, receives
        each MoE layer's count a row of its assignments to held experts,
        then the rows its held experts computed (``layers.moe_apply``)."""
        x = self._embed(params, tokens)
        for i, p in enumerate(params["layers"]):
            cache = {name: caches[name][self.slots[i]]
                     for name in CACHE_NAMES[self.mixers[i]]}
            with T.model_span(self.mixers[i]):
                y = self._decode_mixer(p, x, i, cache, pos)
            x = self._mlp(p, x + y, i, assigned)
        return self._logits(params, x), caches

    @property
    def has_moe(self) -> bool:
        """Whether a layer's MLP is the MoE, whose decode step counts its
        held experts' work in ``decode_step``'s ``assigned``."""
        return any(self.cfg.mlp_of(i) == "moe"
                   for i in range(self.cfg.n_layers))


def build_model(cfg: ModelConfig):
    """The model of ``cfg.family``: :class:`LM` or ``encdec.EncDec``."""
    if cfg.family == "encdec":
        return EncDec(cfg)
    return LM(cfg)
