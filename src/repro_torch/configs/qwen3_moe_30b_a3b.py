"""qwen3-moe-30b-a3b [moe]: 128 experts top-8, qk_norm GQA.
[hf:Qwen/Qwen3-30B-A3B]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_head=128,
    d_ff=6144,             # unused (no dense layers)
    vocab=151936,
    rope_theta=1e6,
    qk_norm=True,
    n_experts=128,
    top_k=8,
    moe_d_ff=768,
    n_shared_experts=0,
    n_dense_layers=0,
)
