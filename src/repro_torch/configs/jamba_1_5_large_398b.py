"""jamba-1.5-large-398b [hybrid]: Mamba + attention 1:7 interleave (one
attention layer per 8), MoE 16 experts top-2 on every other layer.  The
mamba layers use the Mamba-2 SSD form (one SSM implementation across the
zoo, as in the reference).  [arXiv:2403.19887; hf:ai21labs/AI21-Jamba-1.5-Large]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=24576,
    vocab=65536,
    rope_theta=0.0,        # jamba uses no positional encoding
    attn_period=8,
    n_experts=16,
    top_k=2,
    moe_d_ff=24576,
    moe_period=2,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
)
