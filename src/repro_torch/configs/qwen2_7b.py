"""qwen2-7b [dense]: GQA + QKV bias.  [arXiv:2407.10671; hf]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-7b",
    family="dense",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_head=128,
    d_ff=18944,
    vocab=152064,
    rope_theta=1e6,
    qkv_bias=True,
    tie_embeddings=False,
)
