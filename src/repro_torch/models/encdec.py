"""Whisper-style encoder-decoder of the torch port (``family="encdec"``):
the port of ``repro.models.encdec``.  The audio frontend is a stub, as in
the reference: the caller gives frame embeddings ``(B, enc_seq,
d_model)``.

Whisper uses LayerNorm + GELU MLPs; the LN -> fc1 pair is the paper's
Example 2, so ``mlp_impl="cuda"`` runs it through the hand-written
LayerNorm+Matmul kernel (``kernels.ops.layernorm_matmul``), and
``attn_impl="cuda"`` runs the encoder self, decoder self and cross
attention through the flash kernel.

Parameters are a dict: ``embed`` (vocab, d) (tied head), ``ln_enc_f_g``/
``_b`` and ``ln_f_g``/``_b``, and ``enc``/``dec``, one dict per layer with
``ln1_g``/``_b``, ``attn`` (``wq``/``wk``/``wv``/``wo``), ``ln2_g``/``_b``,
``fc1``, ``fc1_b``, ``fc2``, ``fc2_b``; decoder layers add ``ln_x_g``/``_b``
and ``xattn``.  The reference stacks layers on a leading axis and scans
them; the port loops over the lists.  Caches are ``{"self": {"k", "v"},
"cross": {"k", "v"}}``, each of shape (n_layers, B, Hkv, len, Dh);
:meth:`EncDec.decode_step` updates the self cache in place.  Where
autograd records, each encoder and decoder layer is recomputed in the
backward pass (``cfg.remat``, reference encdec.py:24).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as K
from repro_torch.models import layers as L
from repro_torch.models.common import (ModelConfig, ParamBuilder,
                                       SpecBuilder, init_attention,
                                       layer_norm, remat, softmax_xent)
from repro_torch.runtime.sharding import constrain


def _ln(pb: ParamBuilder, name: str, d: int) -> Dict[str, torch.Tensor]:
    return {name + "_g": pb.ones((d,), (None,)),
            name + "_b": pb.zeros((d,), (None,))}


def _init_enc_layer(pb: ParamBuilder, cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    return {**_ln(pb, "ln1", d), "attn": init_attention(pb, cfg),
            **_ln(pb, "ln2", d),
            "fc1": pb.dense((d, f), ("fsdp", "tensor")),
            "fc1_b": pb.zeros((f,), ("tensor",)),
            "fc2": pb.dense((f, d), ("tensor", "fsdp")),
            "fc2_b": pb.zeros((d,), (None,))}


def _init_dec_layer(pb: ParamBuilder, cfg: ModelConfig):
    return {**_init_enc_layer(pb, cfg), **_ln(pb, "ln_x", cfg.d_model),
            "xattn": init_attention(pb, cfg)}


def _mlp(p, x, cfg: ModelConfig):
    """LN -> fc1 through the fused Example-2 API, then tanh-GELU -> fc2
    (``jax.nn.gelu`` defaults to the tanh approximation)."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    fc1 = constrain(p["fc1"], None, "tensor")
    if cfg.mlp_impl == "unfused":
        h = layer_norm(x2, p["ln2_g"], p["ln2_b"], cfg.norm_eps) @ fc1
    elif cfg.mlp_impl in L.FUSED_MLP_IMPLS:
        h = K.layernorm_matmul(x2, fc1, p["ln2_g"], p["ln2_b"],
                               eps=cfg.norm_eps,
                               impl=L.FUSED_MLP_IMPLS[cfg.mlp_impl])
    else:
        raise ValueError(f"mlp_impl {cfg.mlp_impl!r} is not ported for "
                         "the encoder-decoder")
    h = F.gelu(h + p["fc1_b"], approximate="tanh")
    out = h @ constrain(p["fc2"], "tensor", None) + p["fc2_b"]
    return constrain(out.reshape(b, s, d), "batch", None, None)


def _attn_block(p, x, cfg: ModelConfig, ln: str, causal: bool, kv=None):
    xn = layer_norm(x, p[ln + "_g"], p[ln + "_b"], cfg.norm_eps)
    name = "attn" if ln == "ln1" else "xattn"
    if kv is None:
        return L.attention_apply(p[name], xn, cfg, causal=causal)
    # cross attention: q from x, k/v given (the encoder memory)
    b, s, _ = xn.shape
    h, dh = cfg.n_heads, cfg.d_head
    q = (xn @ constrain(p[name]["wq"], None, L._heads(h))).reshape(
        b, s, h, dh).transpose(1, 2)
    q = constrain(q, "batch", "tensor", None, None)
    o = L._attend(q, kv["k"], kv["v"], cfg, causal=False)
    return L.out_proj(o.transpose(1, 2).reshape(b, s, h * dh),
                      p[name]["wo"], h)


def _cross_kv(p, mem, cfg: ModelConfig):
    b, s, _ = mem.shape
    hkv, dh = cfg.n_kv_heads, cfg.d_head
    ka = L._heads(hkv)
    k = (mem @ constrain(p["xattn"]["wk"], None, ka)).reshape(
        b, s, hkv, dh).transpose(1, 2)
    v = (mem @ constrain(p["xattn"]["wv"], None, ka)).reshape(
        b, s, hkv, dh).transpose(1, 2)
    return {"k": constrain(k, "batch", "tensor", None, None),
            "v": constrain(v, "batch", "tensor", None, None)}


def _sinusoid_at(pos, d: int, device=None) -> torch.Tensor:
    """Sinusoidal embedding (..., d) of positions ``pos`` (any shape)."""
    i = torch.arange(d // 2, dtype=torch.float32, device=device)
    pos = torch.as_tensor(pos, dtype=torch.float32, device=device)
    ang = pos[..., None] / (10000.0 ** (2 * i / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _sinusoid(s: int, d: int, device=None) -> torch.Tensor:
    return _sinusoid_at(torch.arange(s, device=device), d, device)


class EncDec:
    """Whisper backbone: a bidirectional encoder over frame embeddings and
    a causal decoder with cross attention."""

    def __init__(self, cfg: ModelConfig):
        if cfg.family != "encdec":
            raise ValueError(f"EncDec needs family 'encdec', got "
                             f"{cfg.family!r}")
        self.cfg = cfg

    # -- params ---------------------------------------------------------------
    def init_params(self, seed: int = 0, device="cuda") -> Dict[str, Any]:
        """Random weights from a seeded numpy generator, with the
        reference's shapes and scales (shapes alone on ``meta``)."""
        return self._build(ParamBuilder(np.random.default_rng(seed),
                                        self.cfg.dtype, device))

    def param_specs(self) -> Dict[str, Any]:
        """Each parameter's logical axes, in the parameters' layout: the
        reference's spec tree, a layer's leaves without the stacked
        layer axis."""
        return self._build(SpecBuilder())

    def _build(self, pb) -> Dict[str, Any]:
        cfg = self.cfg
        params = {"embed": pb.dense((cfg.vocab, cfg.d_model),
                                    ("tensor", "fsdp"), scale=0.02)}
        params["enc"] = [_init_enc_layer(pb, cfg)
                         for _ in range(cfg.n_enc_layers)]
        params["dec"] = [_init_dec_layer(pb, cfg)
                         for _ in range(cfg.n_layers)]
        params.update(_ln(pb, "ln_enc_f", cfg.d_model))
        params.update(_ln(pb, "ln_f", cfg.d_model))
        return params

    def from_jax_params(self, tree, device="cuda") -> Dict[str, Any]:
        """The port's parameters from the reference's ``EncDec.init_params``
        tree (arrays converted to numpy; ``enc``/``dec`` stacked on a
        leading layer axis)."""
        dtype = self.cfg.dtype

        def t(a):
            return torch.from_numpy(np.array(a, dtype=np.float32)).to(
                device=device, dtype=dtype)

        def layer(stack, i):
            return {k: layer(a, i) if isinstance(a, dict) else t(a[i])
                    for k, a in stack.items()}

        params = {k: t(a) for k, a in tree.items()
                  if k not in ("enc", "dec")}
        params["enc"] = [layer(tree["enc"], i)
                         for i in range(self.cfg.n_enc_layers)]
        params["dec"] = [layer(tree["dec"], i)
                         for i in range(self.cfg.n_layers)]
        return params

    # -- forward --------------------------------------------------------------
    def _embed(self, params, tokens, pos):
        x = L.embed(params["embed"], tokens).to(self.cfg.dtype)
        x = x + _sinusoid_at(pos, self.cfg.d_model, x.device).to(x.dtype)
        return constrain(x, "batch", None, None)

    def _logits(self, params, x):
        x = layer_norm(x, params["ln_f_g"], params["ln_f_b"],
                       self.cfg.norm_eps)
        logits = x @ constrain(params["embed"], "tensor", None).T
        return constrain(logits, "batch", None, "tensor")

    def _enc_layer(self, lp, x):
        x = x + _attn_block(lp, x, self.cfg, "ln1", causal=False)
        return x + _mlp(lp, x, self.cfg)

    def _dec_layer(self, lp, x, mem):
        cfg = self.cfg
        x = x + _attn_block(lp, x, cfg, "ln1", causal=True)
        x = x + _attn_block(lp, x, cfg, "ln_x", causal=False,
                            kv=_cross_kv(lp, mem, cfg))
        return x + _mlp(lp, x, cfg)

    def encode(self, params, frames):
        cfg = self.cfg
        x = frames.to(cfg.dtype)
        x = x + _sinusoid(x.shape[1], cfg.d_model, x.device).to(cfg.dtype)
        x = constrain(x, "batch", None, None)
        for lp in params["enc"]:
            x = remat(self._enc_layer, cfg, lp, x)
        return layer_norm(x, params["ln_enc_f_g"], params["ln_enc_f_b"],
                          cfg.norm_eps)

    def decode(self, params, mem, tokens):
        x = self._embed(params, tokens,
                        torch.arange(tokens.shape[1], device=tokens.device))
        for lp in params["dec"]:
            x = remat(self._dec_layer, self.cfg, lp, x, mem)
        return self._logits(params, x)

    def forward(self, params, tokens, frames):
        return self.decode(params, self.encode(params, frames), tokens)

    def loss(self, params, tokens, labels, frames) -> torch.Tensor:
        """Mean next-token cross entropy of the decoder's ``labels``."""
        return softmax_xent(self.forward(params, tokens, frames), labels)

    # -- serving --------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, device="cuda"):
        cfg = self.cfg

        def zeros(n):
            return torch.zeros((cfg.n_layers, batch, cfg.n_kv_heads, n,
                                cfg.d_head), dtype=cfg.dtype, device=device)

        return {"self": {"k": zeros(max_len), "v": zeros(max_len)},
                "cross": {"k": zeros(cfg.enc_seq), "v": zeros(cfg.enc_seq)}}

    def cache_specs(self):
        """The cache's logical axes, in its layout (reference
        encdec.py:193): the layer axis, then batch, heads, sequence."""
        att = {"k": (None, "batch", "tensor", "kv_seq", None),
               "v": (None, "batch", "tensor", "kv_seq", None)}
        return {"self": att,
                "cross": {n: (None, "batch", "tensor", None, None)
                          for n in ("k", "v")}}

    def prefill(self, params, tokens, frames, max_len: Optional[int] = None):
        """Encode the frames and run the decoder prompt; returns logits and
        the self cache (padded to ``max_len``) and cross cache."""
        cfg = self.cfg
        mem = self.encode(params, frames)
        b, s = tokens.shape
        max_len = max_len or s
        x = self._embed(params, tokens, torch.arange(s, device=tokens.device))
        caches = {"self": {"k": [], "v": []}, "cross": {"k": [], "v": []}}
        pad = (0, 0, 0, max_len - s)
        for lp in params["dec"]:
            xn = layer_norm(x, lp["ln1_g"], lp["ln1_b"], cfg.norm_eps)
            q, k, v = L.qkv(lp["attn"], xn, cfg, None)
            y = L._attend(q, k, v, cfg, causal=True)
            y = y.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.d_head)
            x = x + L.out_proj(y, lp["attn"]["wo"], cfg.n_heads)
            kv_cross = _cross_kv(lp, mem, cfg)
            x = x + _attn_block(lp, x, cfg, "ln_x", causal=False,
                                kv=kv_cross)
            x = x + _mlp(lp, x, cfg)
            caches["self"]["k"].append(L.pad_seq(k, pad).to(cfg.dtype))
            caches["self"]["v"].append(L.pad_seq(v, pad).to(cfg.dtype))
            for n in ("k", "v"):
                caches["cross"][n].append(kv_cross[n].to(cfg.dtype))
        caches = {c: {n: torch.stack(ts) for n, ts in d.items()}
                  for c, d in caches.items()}
        return self._logits(params, x), caches

    def decode_step(self, params, caches, tokens, pos):
        """tokens: (B, 1); pos: the filled self-cache length (a scalar, as
        in the reference).  Writes the new k/v into ``caches`` in place and
        returns ``(logits, caches)``."""
        cfg = self.cfg
        x = self._embed(params, tokens, pos)
        for i, lp in enumerate(params["dec"]):
            xn = layer_norm(x, lp["ln1_g"], lp["ln1_b"], cfg.norm_eps)
            own = {n: caches["self"][n][i] for n in ("k", "v")}
            y, _ = L.attention_decode(lp["attn"], xn, own, pos, cfg)
            x = x + y
            cross = {n: caches["cross"][n][i] for n in ("k", "v")}
            x = x + _attn_block(lp, x, cfg, "ln_x", causal=False, kv=cross)
            x = x + _mlp(lp, x, cfg)
        return self._logits(params, x), caches
