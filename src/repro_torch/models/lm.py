"""Decoder-only LM of the torch port (``family`` ``"dense"``, ``"moe"``,
``"ssm"`` or ``"vlm"``): the port of ``repro.models.lm``.

Parameters are a dict: ``embed`` (vocab, d), ``ln_f`` (d,), ``head``
(d, vocab) when embeddings are untied, and ``layers``, one dict per layer
with ``ln1`` and ``mixer``, the layer's token mixer by ``cfg.mixer``:

* ``attn``: ``wq``/``wk``/``wv``/``wo``, plus ``bq``/``bk``/``bv`` with
  ``qkv_bias`` and ``q_norm``/``k_norm`` with ``qk_norm``;
* ``mla`` (``use_mla``, deepseek-v3): ``wq_a``/``q_norm``/``wq_b`` (or
  ``wq``), ``wkv_a``, ``kv_norm``, ``wkv_b``, ``wo``;
* ``mamba`` (``family="ssm"``, mamba2): ``w_in``, ``conv_w``/``conv_b``,
  ``A_log``, ``dt_bias``, ``D``, ``ssm_norm``, ``w_out``.

An attention or MLA layer also has ``ln2`` and ``mlp``:
``w_gate``/``w_up``/``w_down`` for a SwiGLU layer,
``router``/``we_gate``/``we_up``/``we_down`` (and ``shared_*``) for an MoE
layer.  As in the reference's ``plan_stages``, an MoE model has
``n_dense_layers`` SwiGLU layers, then MoE layers
(``ModelConfig.is_moe_layer``); a Mamba2 layer has no MLP.  The
reference stacks each stage's layers on a leading axis and scans them;
the port loops over the list.  The cache is a dict of tensors stacked on
a leading layer axis, by mixer: ``{"k", "v"}`` (n_layers, batch, kv
heads, max_len, d_head); ``{"ckv", "krope"}`` (n_layers, batch, max_len,
kv_lora_rank | qk_rope_dim); ``{"h", "conv"}`` (n_layers, batch, heads,
head_dim, state) in float32 and (n_layers, batch, ssm_conv - 1, d_inner
+ 2 state).  :meth:`LM.decode_step` updates it in place.

With ``attn_impl="cuda"`` and ``mlp_impl="cuda"`` the forward pass and
prefill run the paper's hand-written kernels (``kernels/ops.py``), as the
reference's ``"pallas"`` impls do (lm.py:286-294); decode on that
attention raises (``layers.attention_decode``).

A ``vlm`` model (internvl) takes precomputed vision embeddings
``(B, n_vision_tokens, d_model)``, prepended to the token embeddings
(the vision frontend is a stub, as in the reference); :meth:`LM.loss`
scores the text positions only.  Where autograd records, each layer is
recomputed in the backward pass (``cfg.remat``, ``common.remat``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.encdec import EncDec
from repro_torch.models.common import (ModelConfig, init_params, remat,
                                       rms_norm, softmax_xent)

#: the families :class:`LM` runs
FAMILIES = ("dense", "moe", "ssm", "vlm")


class LM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in FAMILIES:
            raise ValueError(f"family {cfg.family!r} is not ported yet")
        self.cfg = cfg

    # -- params ---------------------------------------------------------------
    def init_params(self, seed: int = 0, device="cuda") -> Dict[str, Any]:
        """Random weights from a seed (``models.common.init_params``)."""
        return init_params(self.cfg, seed, device)

    def from_jax_params(self, tree, device="cuda") -> Dict[str, Any]:
        """The port's parameters from the reference's ``LM.init_params``
        tree (arrays converted to numpy; each ``stageN/sub0/...`` stacked
        on a leading layer axis, the stages in layer order, reference
        lm.py:166-186), whatever the layer's mixer and MLP hold."""
        dtype = self.cfg.dtype

        def t(a):
            return torch.from_numpy(np.array(a, dtype=np.float32)).to(
                device=device, dtype=dtype)

        def layer(stack, i):
            return {name: ({k: t(a[i]) for k, a in sub.items()}
                           if isinstance(sub, dict) else t(sub[i]))
                    for name, sub in stack.items()}

        layers = []
        for si in sorted(int(k[5:]) for k in tree if k.startswith("stage")):
            stack = tree[f"stage{si}"]["sub0"]
            layers += [layer(stack, i) for i in range(len(stack["ln1"]))]
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
        x = params["embed"][tokens].to(self.cfg.dtype)
        if self.cfg.family == "vlm" and vision_embeds is not None:
            x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
        return x

    def _logits(self, params, x):
        x = rms_norm(x, params["ln_f"], self.cfg.norm_eps)
        head = (params["embed"].T if self.cfg.tie_embeddings
                else params["head"])
        return x @ head

    def _mlp(self, p, x, i):
        """Layer ``i``'s MLP residual step (none in a Mamba2 layer)."""
        if self.cfg.mixer == "mamba":
            return x
        return x + L.mlp_apply(p["mlp"], x, p["ln2"], self.cfg, i)

    def _layer(self, p, x, i):
        """Layer ``i``: its mixer, then its MLP, each a residual step."""
        cfg = self.cfg
        if cfg.mixer == "mamba":
            x = x + L.mamba_apply(p["mixer"], x, p["ln1"], cfg)
        else:
            mix = L.mla_apply if cfg.mixer == "mla" else L.attention_apply
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
        """Zeros of the cache layout of ``cfg.mixer`` (module docstring)."""
        cfg = self.cfg
        if cfg.mixer == "mamba":
            one = L.mamba_init_cache(cfg, batch, cfg.dtype, device)
        elif cfg.mixer == "mla":
            one = L.mla_init_cache(cfg, batch, max_len, cfg.dtype, device)
        else:
            one = L.attention_init_cache(cfg, batch, max_len, cfg.dtype,
                                         device)
        return {name: t.new_zeros((cfg.n_layers, *t.shape))
                for name, t in one.items()}

    # -- prefill / decode -----------------------------------------------------
    def prefill(self, params, tokens, max_len: Optional[int] = None,
                vision_embeds=None):
        """Run the prompt (after a VLM's vision embeddings); returns logits
        and a cache filled to the prompt length, its sequence axis padded to
        ``max_len`` for later decode steps (a Mamba2 cache has no sequence
        axis)."""
        cfg = self.cfg
        x = self._embed(params, tokens, vision_embeds)
        b, s = x.shape[:2]
        max_len = max_len or s
        pad = (0, 0, 0, max_len - s)
        pos = torch.arange(s, device=x.device)
        caches = []
        for i, p in enumerate(params["layers"]):
            if cfg.mixer == "mamba":
                y, cache = L.mamba_prefill(p["mixer"], x, p["ln1"], cfg)
                x = x + y
            elif cfg.mixer == "mla":
                # the reference's lm.py:307-319: the layer, then the cache
                # from the compressed projections of the same input
                xn = rms_norm(x, p["ln1"], cfg.norm_eps)
                x = x + L.mla_apply(p["mixer"], xn, cfg)
                ckv, krope = L.mla_kv_compressed(p["mixer"], xn, cfg, pos)
                cache = {"ckv": F.pad(ckv, pad).to(cfg.dtype),
                         "krope": F.pad(krope, pad).to(cfg.dtype)}
            else:
                xn = rms_norm(x, p["ln1"], cfg.norm_eps)
                q, k, v = L.qkv(p["mixer"], xn, cfg,
                                pos if cfg.rope_theta > 0 else None)
                y = L._attend(q, k, v, cfg, causal=True)
                y = y.transpose(1, 2).reshape(b, s,
                                              cfg.n_heads * cfg.d_head)
                x = x + y @ p["mixer"]["wo"]
                cache = {"k": F.pad(k, pad).to(cfg.dtype),
                         "v": F.pad(v, pad).to(cfg.dtype)}
            caches.append(cache)
            x = self._mlp(p, x, i)
        return self._logits(params, x), {
            name: torch.stack([c[name] for c in caches])
            for name in caches[0]}

    def decode_step(self, params, caches, tokens, pos):
        """tokens: (B, 1); pos: the filled cache length, a scalar or a
        (B,) vector (ragged continuous batching; a Mamba2 step takes no
        position).  Writes the new cache entries into ``caches`` in place
        and returns ``(logits, caches)``."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        for i, p in enumerate(params["layers"]):
            cache = {name: t[i] for name, t in caches.items()}
            if cfg.mixer == "mamba":
                y, new = L.mamba_decode(p["mixer"], x, p["ln1"], cache, cfg)
                for name, t in new.items():
                    cache[name].copy_(t)
            else:
                dec = (L.mla_decode if cfg.mixer == "mla"
                       else L.attention_decode)
                y, _ = dec(p["mixer"], rms_norm(x, p["ln1"], cfg.norm_eps),
                           cache, pos, cfg)
            x = self._mlp(p, x + y, i)
        return self._logits(params, x), caches


def build_model(cfg: ModelConfig):
    """The model of ``cfg.family``: :class:`LM` or ``encdec.EncDec``."""
    if cfg.family == "encdec":
        return EncDec(cfg)
    return LM(cfg)
