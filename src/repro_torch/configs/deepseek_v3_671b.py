"""deepseek-v3-671b [moe]: MLA, 1 shared + 256 routed top-8 experts, 3
leading dense layers.  MTP (multi-token prediction) is a training
objective and is not modelled, as in the reference.
[arXiv:2412.19437; hf:deepseek-ai/DeepSeek-V3]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_head=128,
    d_ff=18432,            # the 3 dense layers
    vocab=129280,
    rope_theta=1e4,
    # MoE
    n_experts=256,
    top_k=8,
    moe_d_ff=2048,
    n_shared_experts=1,
    n_dense_layers=3,
    # MLA
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
)
