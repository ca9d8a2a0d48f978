"""internvl2-26b [vlm]: InternViT + InternLM2 backbone.  The vision
frontend is a stub, as in the reference: the caller gives precomputed
patch embeddings (n_vision_tokens x d_model), prefixed to the token
embeddings.  [arXiv:2404.16821; hf]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_head=128,
    d_ff=16384,
    vocab=92553,
    rope_theta=1e6,
    n_vision_tokens=256,
)
