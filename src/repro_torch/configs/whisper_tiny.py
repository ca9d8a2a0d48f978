"""whisper-tiny [audio]: encoder-decoder; the conv frontend is a stub, as
in the reference (the caller gives frame embeddings).  LayerNorm MLPs: the
LN -> fc1 pair runs through Flash-LayerNorm+Matmul (Example 2).
[arXiv:2212.04356]"""

from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,           # decoder layers
    n_enc_layers=4,
    enc_seq=1500,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_head=64,
    d_ff=1536,
    vocab=51865,
    rope_theta=0.0,       # sinusoidal positions, no rope
    norm_eps=1e-5,
    tie_embeddings=True,
    max_seq=524288,
)
