"""The operations and bytes of a tick of a DeepSeek-V3-shaped model (MLA
attention, leading dense SwiGLU layers, then MoE layers with a router, a
shared expert and a chip's share of the routed experts), counted as
``counts.py`` counts a GQA model's: what these inputs need, not what the
program does.  The numerators of ``mla_mfu_pct`` and
``mla_decode_roofline``; frozen with the benchmark.

* operations: 2 per multiply-add of every matrix product, for the real
  tokens only; MLA's projections (``q_a``, ``q_b``, ``kv_a``, ``kv_b``,
  ``o``) once a token: a prompt's token expands its latent through
  ``kv_b``, and a decode row, whose cache holds the latent alone, takes
  its query into the latent space and its context out of it through the
  two halves of ``kv_b`` (the absorbed form), the same multiply-adds;
  attention over the positions each token attends, ``heads * (nope +
  rope + v)`` multiply-adds a position for a prompt's token (keys and
  values expanded) and ``heads * (2 * kv_rank + rope)`` for a decode row
  (scores and context against the latent cache); a dense layer's SwiGLU
  on every token; an MoE layer's router and shared expert on every token
  and its held experts on the expected assignments that land on them
  (``top_k * held / experts`` a token); the head on one row per prompt
  and per decode row.  Norms, RoPE, softmax, the routing's top-k and
  elementwise products are not counted.
* bytes (float32, 4 a value): every weight read once a tick (the
  embedding at its looked-up rows only; of the held experts, those the
  tick's ``T`` tokens are expected to touch, ``held * (1 - (1 - top_k /
  experts) ** T)``); the latent cache (``kv_rank + rope`` values a layer
  and position) at every position a decode row attends, its own
  included, and every position a prompt writes; the logits written once.
  Activations between kernels are not counted.

Worked example (the cell's 19 layers, 3 dense, one decode row at context
100; held in ``test_bench_deepseek.py``): an MLA layer holds 7168 * 1536 +
1536 * 128 * 192 + 7168 * 576 + 512 * 128 * 256 + 128 * 128 * 7168 =
187,105,280 weights; a dense SwiGLU 3 * 7168 * 18432 = 396,361,728; an
expert 3 * 7168 * 2048 = 44,040,192, as the shared one; the router 7168 *
256 = 1,835,008.  Operations: 2 * (19 * 187,105,280 + 3 * 396,361,728 + 16
* (1,835,008 + 44,040,192 + 8 * 8 / 256 * 44,040,192)) + 2 * 19 * 128 *
1088 * 100 (attention) + 2 * 7168 * 129280 (head) = 13,691,060,224.
Bytes: 4 * (6,405,090,304 weights, gains and the router's bias included,
+ one embedding row of 7168) = 25,620,389,888; 704,643,072 of the held
experts the token is expected to touch (16 layers * 8 * 8 / 256 of an
expert); 4,377,600 of latent cache (19 * 576 * 100 * 4); 517,120 of
logits: 26,329,927,680.  Bound: 7.860 ms, by bytes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

F32 = 4


@dataclass(frozen=True)
class MlaShape:
    d: int
    layers: int
    dense_layers: int    # the leading dense SwiGLU layers
    heads: int
    q_rank: int          # q's LoRA rank (0: a plain wq)
    kv_rank: int
    nope: int            # each head's no-RoPE query and key dims
    rope: int            # the shared RoPE key's dims
    v: int
    d_ff: int            # a dense layer's SwiGLU width
    vocab: int
    experts: int         # the router's experts
    held: int            # experts whose weights this chip holds
    top_k: int
    expert_ff: int
    shared: int          # shared experts (each of expert_ff)

    @classmethod
    def of(cls, cfg: dict) -> "MlaShape":
        ref = cfg["reference"]
        return cls(d=cfg["hidden_size"], layers=cfg["num_hidden_layers"],
                   dense_layers=cfg["first_k_dense_replace"],
                   heads=cfg["num_attention_heads"],
                   q_rank=cfg["q_lora_rank"] or 0,
                   kv_rank=cfg["kv_lora_rank"],
                   nope=cfg["qk_nope_head_dim"], rope=cfg["qk_rope_head_dim"],
                   v=cfg["v_head_dim"], d_ff=cfg["intermediate_size"],
                   vocab=cfg["vocab_size"],
                   experts=ref["router_experts"],
                   held=ref["experts_held"][1],
                   top_k=cfg["num_experts_per_tok"],
                   expert_ff=cfg["moe_intermediate_size"],
                   shared=cfg["n_shared_experts"])

    @property
    def moe_layers(self) -> int:
        return self.layers - self.dense_layers

    # -- per layer ------------------------------------------------------------
    @property
    def mla_weights(self) -> int:
        qd = self.nope + self.rope
        q = (self.d * self.q_rank + self.q_rank * self.heads * qd
             if self.q_rank else self.d * self.heads * qd)
        return (q + self.d * (self.kv_rank + self.rope)
                + self.kv_rank * self.heads * (self.nope + self.v)
                + self.heads * self.v * self.d)

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
        """A layer's norm gains (two of d, q's and the latent's)."""
        return 2 * self.d + self.q_rank + self.kv_rank

    def latent_bytes(self, positions: int) -> int:
        """The latent cache of ``positions`` positions over every
        layer."""
        return self.layers * (self.kv_rank + self.rope) * positions * F32

    def touched_experts(self, tokens: int) -> float:
        if tokens == 0:
            return 0.0
        return self.held * (1.0 - (1.0 - self.top_k / self.experts)
                            ** tokens)


def tick_work(m: MlaShape, prefill_lens: Sequence[int],
              decode_ctx: Sequence[int]) -> Tuple[float, float]:
    """``(operations, bytes)`` of one tick that prefills prompts of
    ``prefill_lens`` tokens and decodes rows at contexts ``decode_ctx``
    (the positions each attends, its own included)."""
    tokens = sum(prefill_lens) + len(decode_ctx)
    rows_out = len(prefill_lens) + len(decode_ctx)
    if tokens == 0:
        return 0.0, 0.0
    shared = m.shared * m.expert_weights
    held_share = m.top_k * m.held / m.experts
    per_token = (m.layers * m.mla_weights
                 + m.dense_layers * m.dense_mlp_weights
                 + m.moe_layers * (m.router_weights + shared
                                   + held_share * m.expert_weights))
    ops = 2.0 * tokens * per_token
    prompt_pairs = sum(p * (p + 1) // 2 for p in prefill_lens)
    ops += 2.0 * m.layers * m.heads * (
        (m.nope + m.rope + m.v) * prompt_pairs
        + (2 * m.kv_rank + m.rope) * sum(decode_ctx))
    ops += 2.0 * rows_out * m.d * m.vocab
    weights = (m.layers * (m.mla_weights + m.small_weights)
               + m.dense_layers * m.dense_mlp_weights
               + m.moe_layers * (m.router_weights + m.experts + shared)
               + m.d + m.d * m.vocab)
    nbytes = F32 * (weights + tokens * m.d)
    nbytes += F32 * m.moe_layers * m.touched_experts(tokens) \
        * m.expert_weights
    nbytes += m.latent_bytes(sum(prefill_lens) + sum(decode_ctx))
    nbytes += F32 * rows_out * m.vocab
    return ops, nbytes


#: the configuration the MLA readers count: their one cell's
#: (``BENCHMARK.json`` lists ``deepseek-v3-671b.chat`` alone under them)
CONFIG = "deepseek-v3-671b"


def config_shape(name: str = CONFIG) -> MlaShape:
    """The shape of ``BENCHMARK.json``'s configuration ``name``."""
    from benchlib import spec
    return MlaShape.of(spec.config(spec.load(), name))
