"""The operations and bytes a tick's work needs, counted from shapes:
the numerators of the roofline and MFU shares.  Frozen with the
benchmark, so that a later change to the program cannot move them.

They count what these inputs need, not what the program does:

* operations: 2 per multiply-add of every matrix product that the
  model's arithmetic requires, for the real tokens only (the prompt's
  tokens, not its padded bucket; the active decode rows, not
  ``max_batch``); attention over the positions each token attends
  (``c`` for a decode row at context ``c``; ``P (P + 1) / 2`` for a
  prompt of ``P``); the head on one row per prompt and per decode row
  (the next-token logits); an MoE layer's held experts on the expected
  number of assignments that land on them (``top_k * held / experts``
  a token).  Norms, RoPE, softmax and elementwise products are not
  counted (under 0.1 % of the products at these widths).
* bytes (float32, 4 a value): every weight read once a tick, whatever
  the number of prompts the tick prefills (the embedding only at its
  looked-up rows); an MoE layer's router once and, of its held experts,
  those the tick's ``T`` tokens are expected to touch under top-k
  routing spread evenly over the router's experts,
  ``held * (1 - (1 - top_k / experts) ** T)``: the harness does not see
  the routing; the KV cache at every position a decode row attends (its
  own new one included) and at every position a prompt writes; the
  logits written once.
  Activations between kernels are not counted (a fused step keeps them
  on the chip).

Worked example (qwen2-7b, one decode row at context 100; held in
``test_bench_counts.py`` with the MoE cell's): a layer's products hold
3584 * (2 * 3584 + 2 * 512) + 3 * 3584 * 18944 = 233,046,016 weights
(wq, wk, wv, wo; gate, up, down).  Operations: 2 * 28 * 233,046,016 +
4 * 28 heads * 28 layers * 128 * 100 (attention) + 2 * 3584 * 152064
(head) = 14,180,712,448.  Bytes: 4 * (28 * (233,046,016 + 11,776 gains
and biases) + 3584 + 3584 * 152064 + one embedding row of 3584) = 28,282,
490,880 of weights, 11,468,800 of KV cache (2 * 28 * 4 * 128 * 100 * 4),
608,256 of logits: 28,294,567,936.  Bound: 8.446 ms, by bytes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

F32 = 4


@dataclass(frozen=True)
class ModelShape:
    d: int
    layers: int
    heads: int
    kv_heads: int
    head_dim: int
    d_ff: int            # a dense SwiGLU's width (0: MoE layers)
    vocab: int
    qkv_bias: bool
    experts: int = 0     # the router's experts (0: dense)
    held: int = 0        # experts whose weights this chip holds
    top_k: int = 0
    expert_ff: int = 0

    @classmethod
    def of(cls, cfg: dict) -> "ModelShape":
        ref = cfg["reference"]
        moe = ref["mlp"] == "moe"
        return cls(d=cfg["hidden_size"], layers=cfg["num_hidden_layers"],
                   heads=cfg["num_attention_heads"],
                   kv_heads=cfg["num_key_value_heads"],
                   head_dim=ref["head_dim"],
                   d_ff=0 if moe else cfg["intermediate_size"],
                   vocab=cfg["vocab_size"], qkv_bias=ref["qkv_bias"],
                   experts=ref["router_experts"] if moe else 0,
                   held=ref["experts_held"][1] if moe else 0,
                   top_k=cfg["num_experts_per_tok"] if moe else 0,
                   expert_ff=cfg["moe_intermediate_size"] if moe else 0)

    # -- per layer ------------------------------------------------------------
    @property
    def attn_weights(self) -> int:
        q = self.heads * self.head_dim
        kv = self.kv_heads * self.head_dim
        return self.d * (2 * q + 2 * kv)

    @property
    def dense_mlp_weights(self) -> int:
        return 3 * self.d * self.d_ff

    @property
    def expert_weights(self) -> int:
        return 3 * self.d * self.expert_ff

    @property
    def router_weights(self) -> int:
        return self.d * self.experts

    @property
    def small_weights(self) -> int:
        """Norm gains and biases of a layer."""
        b = ((self.heads + 2 * self.kv_heads) * self.head_dim
             if self.qkv_bias else 0)
        return 2 * self.d + b

    def kv_bytes(self, positions: int) -> int:
        """Keys and values of ``positions`` positions over every layer."""
        return 2 * self.layers * self.kv_heads * self.head_dim \
            * positions * F32

    def touched_experts(self, tokens: int) -> float:
        if not self.experts or tokens == 0:
            return 0.0
        return self.held * (1.0 - (1.0 - self.top_k / self.experts)
                            ** tokens)


def tick_work(m: ModelShape, prefill_lens: Sequence[int],
              decode_ctx: Sequence[int]) -> Tuple[float, float]:
    """``(operations, bytes)`` of one tick that prefills prompts of
    ``prefill_lens`` tokens and decodes rows at contexts ``decode_ctx``
    (the positions each attends, its own included)."""
    tokens = sum(prefill_lens) + len(decode_ctx)
    rows_out = len(prefill_lens) + len(decode_ctx)
    if tokens == 0:
        return 0.0, 0.0
    per_token = m.attn_weights + m.dense_mlp_weights + m.router_weights
    held_share = m.top_k * m.held / m.experts if m.experts else 0.0
    ops = 2.0 * tokens * m.layers * (per_token
                                     + held_share * m.expert_weights)
    attended = sum(p * (p + 1) // 2 for p in prefill_lens) + sum(decode_ctx)
    ops += 4.0 * m.layers * m.heads * m.head_dim * attended
    ops += 2.0 * rows_out * m.d * m.vocab
    weights = m.layers * (per_token + m.small_weights) + m.d + m.d * m.vocab
    nbytes = F32 * (weights + tokens * m.d)
    nbytes += F32 * m.layers * m.touched_experts(tokens) * m.expert_weights
    nbytes += m.kv_bytes(sum(prefill_lens) + sum(decode_ctx))
    nbytes += F32 * rows_out * m.vocab
    return ops, nbytes
