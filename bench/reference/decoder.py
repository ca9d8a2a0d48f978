"""A decoder-only transformer written from the published descriptions of
Qwen2 (arXiv 2407.10671) and Qwen3-MoE (the Hugging Face
``Qwen3MoeForCausalLM``), in plain PyTorch: no kernel, cache or batching.

One call runs one sequence through every layer and returns the logits at
its last positions.  Weights are a flat dict by the names of the
configuration's ``param_map`` and are laid out ``x @ W`` (input rows,
output columns); an expert stack is ``(experts held, in, out)``.

* RMSNorm: ``x * rsqrt(mean(x^2) + eps) * g``, in float32.
* Attention: q, k, v projections (with biases where ``qkv_bias``), a
  per-head RMSNorm of q and k where ``qk_norm``, RoPE in the
  rotate-half form with ``inv_freq = theta^(-2i/d)`` and angles in
  float32 (as the published implementation computes them), causal
  softmax attention with each KV head shared by its query group.
* MLP: SwiGLU ``(silu(x Wg) * (x Wu)) Wd``; or the MoE: router logits
  ``x Wr`` over all ``router_experts``, softmax in float32, the top
  ``num_experts_per_tok``, their weights renormalised to sum to one
  (``norm_topk_prob``), and the sum over the *held* experts only
  (``experts_held`` = first, count) of weight times expert SwiGLU.  The
  published model routes without capacity: every assignment is computed.

``precision="tf32"`` rounds both operands of every matrix product to
TF32 (10 mantissa bits, round to nearest, ties away from zero, as the
tensor cores convert them) and sums in float32: the benchmark's control,
the precision one step below the configuration's float32.  The default
``"float32"`` turns TF32 off.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

Tensor = torch.Tensor


def _tf32(x: Tensor) -> Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Decoder:
    """The reference of one configuration (its file's published keys and
    ``reference`` section)."""

    def __init__(self, cfg: dict, weights: Dict[str, Tensor],
                 precision: str = "float32"):
        if precision not in ("float32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        ref = cfg["reference"]
        self.w = weights
        self.tf32 = precision == "tf32"
        self.d = cfg["hidden_size"]
        self.n_layers = cfg["num_hidden_layers"]
        self.h = cfg["num_attention_heads"]
        self.hkv = cfg["num_key_value_heads"]
        self.dh = ref["head_dim"]
        self.eps = cfg["rms_norm_eps"]
        self.theta = cfg["rope_theta"]
        self.qkv_bias = ref["qkv_bias"]
        self.qk_norm = ref["qk_norm"]
        self.moe = ref["mlp"] == "moe"
        if self.moe:
            self.top_k = cfg["num_experts_per_tok"]
            self.norm_topk = cfg["norm_topk_prob"]
            self.first, self.count = ref["experts_held"]

    # -- pieces ---------------------------------------------------------------
    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        if self.tf32:
            a, b = _tf32(a), _tf32(b)
        return a @ b

    def rmsnorm(self, x: Tensor, g: Tensor) -> Tensor:
        var = x.pow(2).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * g

    def rope(self, x: Tensor, pos: Tensor) -> Tensor:
        """x: (heads, S, dh); pos: (S,)."""
        half = self.dh // 2
        inv_freq = 1.0 / (self.theta ** (
            torch.arange(0, self.dh, 2, dtype=torch.float32,
                         device=x.device) / self.dh))
        ang = pos.float()[:, None] * inv_freq[None, :]
        emb = torch.cat([ang, ang], -1)
        cos, sin = emb.cos(), emb.sin()
        rot = torch.cat([-x[..., half:], x[..., :half]], -1)
        return x * cos + rot * sin

    def attention(self, i: int, x: Tensor) -> Tensor:
        w, p = self.w, f"layers.{i}."
        s = x.shape[0]
        q, k, v = (self.mm(x, w[p + n]) for n in ("q_proj", "k_proj",
                                                   "v_proj"))
        if self.qkv_bias:
            q, k, v = q + w[p + "q_bias"], k + w[p + "k_bias"], \
                v + w[p + "v_bias"]
        q = q.view(s, self.h, self.dh).transpose(0, 1)
        k = k.view(s, self.hkv, self.dh).transpose(0, 1)
        v = v.view(s, self.hkv, self.dh).transpose(0, 1)
        if self.qk_norm:
            q = self.rmsnorm(q, w[p + "q_norm"])
            k = self.rmsnorm(k, w[p + "k_norm"])
        pos = torch.arange(s, device=x.device)
        q, k = self.rope(q, pos), self.rope(k, pos)
        group = self.h // self.hkv
        k = k.repeat_interleave(group, 0)
        v = v.repeat_interleave(group, 0)
        scores = self.mm(q, k.transpose(1, 2)) / math.sqrt(self.dh)
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
        probs = torch.softmax(scores.masked_fill(mask, float("-inf")), -1)
        o = self.mm(probs, v).transpose(0, 1).reshape(s, self.h * self.dh)
        return self.mm(o, w[p + "o_proj"])

    def swiglu(self, x: Tensor, wg: Tensor, wu: Tensor, wd: Tensor
               ) -> Tensor:
        g = self.mm(x, wg)
        return self.mm(g * torch.sigmoid(g) * self.mm(x, wu), wd)

    def mlp(self, i: int, x: Tensor) -> Tensor:
        w, p = self.w, f"layers.{i}."
        if not self.moe:
            return self.swiglu(x, w[p + "gate_proj"], w[p + "up_proj"],
                               w[p + "down_proj"])
        logits = self.mm(x, w[p + "gate"])
        probs = torch.softmax(logits.float(), -1)
        top_w, top_e = torch.topk(probs, self.top_k, -1)
        if self.norm_topk:
            top_w = top_w / top_w.sum(-1, keepdim=True)
        out = torch.zeros_like(x)
        gs, us, ds = (w[p + n] for n in ("experts_gate_proj",
                                         "experts_up_proj",
                                         "experts_down_proj"))
        # the assignments to held experts, grouped by expert into one
        # zero-padded (held, most per expert, d) batch
        local = top_e.reshape(-1) - self.first
        pick = torch.nonzero((local >= 0) & (local < self.count))[:, 0]
        if pick.numel() == 0:
            return out
        e = local[pick]
        order = torch.argsort(e, stable=True)
        pick, e = pick[order], e[order]
        counts = torch.bincount(e, minlength=self.count)
        slot = torch.arange(e.numel(), device=x.device) \
            - (torch.cumsum(counts, 0) - counts)[e]
        rows = pick // self.top_k
        batch = x.new_zeros(self.count, int(counts.max()), x.shape[-1])
        batch[e, slot] = x[rows]
        y = self.swiglu(batch, gs, us, ds)[e, slot]
        out.index_add_(0, rows, y * top_w.reshape(-1)[pick][:, None])
        return out

    # -- the model ------------------------------------------------------------
    @torch.no_grad()
    def logits(self, tokens: Tensor, last: Optional[int] = None) -> Tensor:
        """Float32 logits (last, vocab) at the sequence's last ``last``
        positions (all by default); ``tokens``: (S,) int64."""
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            w = self.w
            x = w["embed_tokens"][tokens].float()
            for i in range(self.n_layers):
                p = f"layers.{i}."
                x = x + self.attention(i, self.rmsnorm(
                    x, w[p + "input_layernorm"]))
                x = x + self.mlp(i, self.rmsnorm(
                    x, w[p + "post_attention_layernorm"]))
            x = x if last is None else x[-last:]
            return self.mm(self.rmsnorm(x, w["norm"]), w["lm_head"])
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev
