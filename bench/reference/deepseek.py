"""DeepSeek-V3 written from its published description (arXiv 2412.19437
and the Hugging Face ``DeepseekV3ForCausalLM`` modelling code), in plain
PyTorch: no kernel, cache or batching.

One call runs one sequence through every layer and returns the logits at
its last positions.  Weights are a flat dict by the names of the
configuration's ``param_map``, laid out ``x @ W`` (input rows, output
columns); an expert stack is ``(experts held, in, out)``.

* RMSNorm: ``x * rsqrt(mean(x^2) + eps) * g``, in float32.
* MLA in its full, non-absorbed form: ``q = q_b(RMS(q_a(x)))`` split per
  head into ``qk_nope_head_dim`` and ``qk_rope_head_dim``; ``kv_a(x)``
  gives the latent (``kv_lora_rank``) and the RoPE key every head
  shares; ``kv_b(RMS(latent))`` expands each head's no-RoPE key and its
  value; causal softmax over keys ``[k_nope, k_rope]`` at the scale
  ``(qk_nope + qk_rope) ** -0.5`` times YaRN's ``mscale(factor,
  mscale_all_dim) ** 2``; ``o_proj``.
* YaRN RoPE (``rope_scaling``), as ``DeepseekV3YarnRotaryEmbedding``
  computes it in float32: ``inv_freq`` blends ``theta^(-2i/d)`` and it
  over ``factor`` by a linear ramp between the correction range's ends;
  cos and sin times ``mscale(factor, mscale) / mscale(factor,
  mscale_all_dim)``; applied in the rotate-half form.  Departure: the
  pairs are the two halves of the RoPE dims, where the checkpoint pairs
  neighbours (a fixed permutation of the RoPE columns of ``q_b_proj``
  and ``kv_a_proj_with_mqa``: the configuration's ``assumed``).
* MLP: the first ``first_k_dense_replace`` layers a SwiGLU of
  ``intermediate_size``; then the MoE: ``noaux_tc`` routing over all
  ``reference.router_experts`` in float32 (sigmoid scores, plus
  ``e_score_correction_bias`` for the choice only; groups scored by the
  sum of their two best, the best ``topk_group`` of ``n_group`` kept,
  the others' scores set to 0.0; the top ``num_experts_per_tok``;
  weights the chosen sigmoid scores over their sum (+1e-20), times
  ``routed_scaling_factor``), the sum over the *held* experts
  (``experts_held`` = first, count) of weight times expert SwiGLU, plus
  the shared expert's SwiGLU on every token.  DeepSeek-V3 drops no
  tokens: every assignment is computed.

``precision="tf32"`` rounds both operands of every matrix product to
TF32 (``reference.decoder``'s rounding) and sums in float32: the
benchmark's control.  The default ``"float32"`` turns TF32 off.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from reference.decoder import _tf32

Tensor = torch.Tensor


def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_range(dim: int, theta: float, original: int, beta_fast: float,
               beta_slow: float):
    """``yarn_find_correction_range``: the pair indices where the ramp
    starts and ends."""
    def at(rotations):
        return (dim * math.log(original / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    return max(math.floor(at(beta_fast)), 0), min(math.ceil(at(beta_slow)),
                                                  dim - 1)


class Decoder:
    """The reference of one DeepSeek-V3 configuration (its file's
    published keys and ``reference`` section)."""

    def __init__(self, cfg: dict, weights: Dict[str, Tensor],
                 precision: str = "float32"):
        if precision not in ("float32", "tf32"):
            raise ValueError(f"unknown precision {precision!r}")
        if (cfg["scoring_func"], cfg["topk_method"]) != ("sigmoid",
                                                          "noaux_tc"):
            raise ValueError("this reference routes by noaux_tc only")
        ref = cfg["reference"]
        self.w = weights
        self.tf32 = precision == "tf32"
        self.n_layers = cfg["num_hidden_layers"]
        self.h = cfg["num_attention_heads"]
        self.nope = cfg["qk_nope_head_dim"]
        self.rope_dim = cfg["qk_rope_head_dim"]
        self.v_dim = cfg["v_head_dim"]
        self.rank = cfg["kv_lora_rank"]
        self.eps = cfg["rms_norm_eps"]
        self.theta = float(cfg["rope_theta"])
        self.dense = cfg["first_k_dense_replace"]
        self.top_k = cfg["num_experts_per_tok"]
        self.groups = cfg["n_group"]
        self.groups_kept = cfg["topk_group"]
        self.routed_scale = cfg["routed_scaling_factor"]
        self.norm_topk = cfg["norm_topk_prob"]
        self.experts = ref["router_experts"]
        self.first, self.count = ref["experts_held"]
        rs = cfg["rope_scaling"] or {}
        self.scale = (self.nope + self.rope_dim) ** -0.5
        self.yarn = rs.get("type") == "yarn"
        if self.yarn:
            f = rs["factor"]
            self.yarn_args = (f, rs["original_max_position_embeddings"],
                              rs["beta_fast"], rs["beta_slow"])
            self.cos_scale = (yarn_mscale(f, rs["mscale"])
                              / yarn_mscale(f, rs["mscale_all_dim"]))
            if rs.get("mscale_all_dim"):
                self.scale *= yarn_mscale(f, rs["mscale_all_dim"]) ** 2

    # -- pieces ---------------------------------------------------------------
    def mm(self, a: Tensor, b: Tensor) -> Tensor:
        if self.tf32:
            a, b = _tf32(a), _tf32(b)
        return a @ b

    def rmsnorm(self, x: Tensor, g: Tensor) -> Tensor:
        var = x.pow(2).mean(-1, keepdim=True)
        return x * torch.rsqrt(var + self.eps) * g

    def inv_freq(self, device) -> Tensor:
        dim = self.rope_dim
        power = self.theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                            device=device) / dim)
        extra = 1.0 / power
        if not self.yarn:
            return extra
        factor, original, fast, slow = self.yarn_args
        inter = 1.0 / (factor * power)
        low, high = yarn_range(dim, self.theta, original, fast, slow)
        if low == high:
            high += 0.001
        ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
                 - low) / (high - low)).clamp(0, 1)
        mask = 1.0 - ramp
        return inter * (1 - mask) + extra * mask

    def rope(self, x: Tensor, pos: Tensor) -> Tensor:
        """x: (..., S, rope_dim); pos: (S,)."""
        half = self.rope_dim // 2
        freqs = torch.outer(pos.float(), self.inv_freq(x.device))
        emb = torch.cat([freqs, freqs], -1)
        cos, sin = emb.cos(), emb.sin()
        if self.yarn:
            cos, sin = cos * self.cos_scale, sin * self.cos_scale
        rot = torch.cat([-x[..., half:], x[..., :half]], -1)
        return x * cos + rot * sin

    def attention(self, i: int, x: Tensor) -> Tensor:
        w, p = self.w, f"layers.{i}."
        s, h = x.shape[0], self.h
        q = self.mm(self.rmsnorm(self.mm(x, w[p + "q_a_proj"]),
                                 w[p + "q_a_layernorm"]), w[p + "q_b_proj"])
        q = q.view(s, h, self.nope + self.rope_dim).transpose(0, 1)
        q_nope, q_pe = q.split([self.nope, self.rope_dim], -1)
        latent, k_pe = self.mm(x, w[p + "kv_a_proj_with_mqa"]).split(
            [self.rank, self.rope_dim], -1)
        kv = self.mm(self.rmsnorm(latent, w[p + "kv_a_layernorm"]),
                     w[p + "kv_b_proj"])
        kv = kv.view(s, h, self.nope + self.v_dim).transpose(0, 1)
        k_nope, v = kv.split([self.nope, self.v_dim], -1)
        pos = torch.arange(s, device=x.device)
        q_pe = self.rope(q_pe, pos)
        k_pe = self.rope(k_pe, pos)[None].expand(h, s, self.rope_dim)
        query = torch.cat([q_nope, q_pe], -1)
        key = torch.cat([k_nope, k_pe], -1)
        scores = self.mm(query, key.transpose(1, 2)) * self.scale
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).triu(1)
        probs = torch.softmax(scores.masked_fill(mask, float("-inf")), -1)
        o = self.mm(probs, v).transpose(0, 1).reshape(s, h * self.v_dim)
        return self.mm(o, w[p + "o_proj"])

    def swiglu(self, x: Tensor, wg: Tensor, wu: Tensor, wd: Tensor
               ) -> Tensor:
        g = self.mm(x, wg)
        return self.mm(g * torch.sigmoid(g) * self.mm(x, wu), wd)

    def route(self, i: int, x: Tensor):
        """``(weights, experts)``, each (S, top_k): ``noaux_tc``."""
        w, p = self.w, f"layers.{i}."
        s = x.shape[0]
        scores = self.mm(x.float(), w[p + "gate"].float()).sigmoid()
        choice = scores + w[p + "e_score_correction_bias"].float()[None]
        group_scores = choice.view(s, self.groups, -1).topk(
            2, dim=-1)[0].sum(-1)
        group_idx = group_scores.topk(self.groups_kept, dim=-1,
                                      sorted=False)[1]
        group_mask = torch.zeros_like(group_scores)
        group_mask.scatter_(1, group_idx, 1)
        score_mask = group_mask[:, :, None].expand(
            s, self.groups, self.experts // self.groups).reshape(s, -1)
        tmp = choice.masked_fill(~score_mask.bool(), 0.0)
        idx = tmp.topk(self.top_k, dim=-1, sorted=False)[1]
        weight = scores.gather(1, idx)
        if self.top_k > 1 and self.norm_topk:
            weight = weight / (weight.sum(-1, keepdim=True) + 1e-20)
        return weight * self.routed_scale, idx

    def mlp(self, i: int, x: Tensor) -> Tensor:
        w, p = self.w, f"layers.{i}."
        if i < self.dense:
            return self.swiglu(x, w[p + "gate_proj"], w[p + "up_proj"],
                               w[p + "down_proj"])
        weight, idx = self.route(i, x)
        out = self.swiglu(x, w[p + "shared_gate_proj"],
                          w[p + "shared_up_proj"], w[p + "shared_down_proj"])
        for e in range(self.count):
            hit = idx == self.first + e                 # (S, top_k)
            rows = torch.nonzero(hit.any(-1))[:, 0]
            if rows.numel() == 0:
                continue
            y = self.swiglu(x[rows], w[p + "experts_gate_proj"][e],
                            w[p + "experts_up_proj"][e],
                            w[p + "experts_down_proj"][e])
            out = out.index_add(0, rows, y * (weight * hit)[rows].sum(
                -1, keepdim=True))
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
