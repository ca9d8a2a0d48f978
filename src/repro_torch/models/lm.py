"""Decoder-only LM of the torch port (``family`` ``"dense"`` or ``"moe"``):
the port of ``repro.models.lm``.

Parameters are a dict: ``embed`` (vocab, d), ``ln_f`` (d,), ``head``
(d, vocab) when embeddings are untied, and ``layers``, one dict per layer
with ``ln1``, ``mixer`` (``wq``/``wk``/``wv``/``wo``, plus ``bq``/``bk``/
``bv`` with ``qkv_bias`` and ``q_norm``/``k_norm`` with ``qk_norm``),
``ln2`` and ``mlp``: ``w_gate``/``w_up``/``w_down`` for a SwiGLU layer,
``router``/``we_gate``/``we_up``/``we_down`` (and ``shared_*``) for an MoE
layer.  As in the reference's ``plan_stages``, an MoE model has
``n_dense_layers`` SwiGLU layers, then MoE layers
(``ModelConfig.is_moe_layer``).  The reference stacks each stage's
layers on a leading axis and scans them; the port loops over the list.
The KV cache is ``{"k", "v"}`` of shape (n_layers, batch, kv heads,
max_len, d_head), updated in place by :meth:`LM.decode_step`.

With ``attn_impl="cuda"`` and ``mlp_impl="cuda"`` the forward pass and
prefill run the paper's hand-written kernels (``kernels/ops.py``), as the
reference's ``"pallas"`` impls do (lm.py:286-294); decode on that
attention raises (``layers.attention_decode``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models.encdec import EncDec
from repro_torch.models.common import ModelConfig, init_params, rms_norm


class LM:
    def __init__(self, cfg: ModelConfig):
        if cfg.family not in ("dense", "moe"):
            raise ValueError(f"family {cfg.family!r} is not ported yet")
        self.cfg = cfg

    # -- params ---------------------------------------------------------------
    def init_params(self, seed: int = 0, device="cuda") -> Dict[str, Any]:
        """Random weights from a seeded numpy generator
        (``models.common.init_params``)."""
        return init_params(self.cfg, seed, device)

    def from_jax_params(self, tree, device="cuda") -> Dict[str, Any]:
        """The port's parameters from the reference's ``LM.init_params``
        tree (arrays converted to numpy; each ``stageN/sub0/...`` stacked
        on a leading layer axis, the stages in layer order, reference
        lm.py:166-186)."""
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
    def _embed(self, params, tokens):
        return params["embed"][tokens].to(self.cfg.dtype)

    def _logits(self, params, x):
        x = rms_norm(x, params["ln_f"], self.cfg.norm_eps)
        head = (params["embed"].T if self.cfg.tie_embeddings
                else params["head"])
        return x @ head

    def forward(self, params, tokens) -> torch.Tensor:
        cfg = self.cfg
        x = self._embed(params, tokens)
        for i, p in enumerate(params["layers"]):
            x = x + L.attention_apply(p["mixer"],
                                      rms_norm(x, p["ln1"], cfg.norm_eps),
                                      cfg, causal=True)
            x = x + L.mlp_apply(p["mlp"], x, p["ln2"], cfg, i)
        return self._logits(params, x)

    # -- caches ---------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device="cuda"):
        cfg = self.cfg
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.d_head)
        return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
                "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}

    # -- prefill / decode -----------------------------------------------------
    def prefill(self, params, tokens, max_len: Optional[int] = None):
        """Run the prompt; returns logits and a cache filled to the prompt
        length, padded to ``max_len`` for later decode steps."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        b, s = tokens.shape
        max_len = max_len or s
        pos = (torch.arange(s, device=x.device) if cfg.rope_theta > 0
               else None)
        ks, vs = [], []
        for i, p in enumerate(params["layers"]):
            xn = rms_norm(x, p["ln1"], cfg.norm_eps)
            q, k, v = L.qkv(p["mixer"], xn, cfg, pos)
            y = L._attend(q, k, v, cfg, causal=True)
            y = y.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.d_head)
            x = x + y @ p["mixer"]["wo"]
            pad = (0, 0, 0, max_len - s)
            ks.append(torch.nn.functional.pad(k, pad).to(cfg.dtype))
            vs.append(torch.nn.functional.pad(v, pad).to(cfg.dtype))
            x = x + L.mlp_apply(p["mlp"], x, p["ln2"], cfg, i)
        return self._logits(params, x), {"k": torch.stack(ks),
                                         "v": torch.stack(vs)}

    def decode_step(self, params, caches, tokens, pos):
        """tokens: (B, 1); pos: the filled cache length, a scalar or a
        (B,) vector (ragged continuous batching).  Writes the new k/v
        into ``caches`` in place and returns ``(logits, caches)``."""
        cfg = self.cfg
        x = self._embed(params, tokens)
        for i, p in enumerate(params["layers"]):
            cache = {"k": caches["k"][i], "v": caches["v"][i]}
            y, _ = L.attention_decode(
                p["mixer"], rms_norm(x, p["ln1"], cfg.norm_eps), cache, pos,
                cfg)
            x = x + y
            x = x + L.mlp_apply(p["mlp"], x, p["ln2"], cfg, i)
        return self._logits(params, x), caches


def build_model(cfg: ModelConfig):
    """The model of ``cfg.family``: :class:`LM` or ``encdec.EncDec``."""
    if cfg.family == "encdec":
        return EncDec(cfg)
    return LM(cfg)
