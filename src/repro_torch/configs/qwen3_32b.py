"""qwen3-32b [dense]: qk_norm, GQA.  [hf:Qwen/Qwen3-32B family]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    d_head=128,
    d_ff=25600,
    vocab=151936,
    rope_theta=1e6,
    qk_norm=True,
)
