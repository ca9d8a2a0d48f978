"""Model configuration and shared layers of the torch port: the port of
``repro.models.common``.

``ModelConfig`` holds a torch dtype (the reference holds a jnp one).
Parameters are plain nested dicts of tensors; :func:`init_params` draws
them from a seeded numpy generator, since the machine with the card has
no JAX, and ``models.lm.LM.from_jax_params`` loads the reference's own
parameters when both packages must compute on the same weights.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"       # dense | moe | encdec (the families ported)
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 64
    d_ff: int = 1024
    vocab: int = 1024
    max_seq: int = 8192
    rope_theta: float = 10000.0
    qkv_bias: bool = False       # qwen2
    qk_norm: bool = False        # qwen3
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    n_dense_layers: int = 0      # leading dense (SwiGLU) layers
    capacity_factor: float = 1.25
    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 1500
    # --- runtime ---
    dtype: Any = torch.bfloat16
    attn_impl: str = "ref"       # ref | chunked | cuda | pipeline
    mlp_impl: str = "unfused"    # unfused | fused_ref | cuda | pipeline
    pipeline_backend: str = "torch"  # py | torch | cuda (the pipeline impls)
    pipeline_options: Any = None  # Optional[pipeline.CompileOptions]: the
                                 # full compile options of the pipeline
                                 # impls; when set, its backend wins over
                                 # pipeline_backend.  Hashable, so the
                                 # config stays usable as a cache key.

    def is_moe_layer(self, i: int) -> bool:
        """Layer ``i``'s MLP is the MoE (the reference's ``moe_period`` is
        1 for every ported config)."""
        return self.n_experts > 0 and i >= self.n_dense_layers


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family variant for CPU tests (the reference's
    ``reduced_config`` for the fields this slice has)."""
    small = dict(
        n_layers=min(cfg.n_layers, 4),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads
        else 4,
        d_head=32,
        d_ff=256,
        vocab=512,
        max_seq=256,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        capacity_factor=8.0,  # no drops at smoke-test scale (exactness)
        moe_d_ff=64 if cfg.n_experts else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        n_dense_layers=min(cfg.n_dense_layers, 1),
        n_enc_layers=min(cfg.n_enc_layers, 2),
        enc_seq=64 if cfg.n_enc_layers else 0,
        dtype=torch.float32,
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float
             ) -> torch.Tensor:
    xf = x.float()
    irms = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * irms * gamma.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def rope_frequencies(d_head: int, theta: float,
                     device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (..., S, Dh) with Dh even; positions (S,) or broadcastable, e.g.
    ``(B, 1, 1)`` for one ragged decode position per sequence."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)
    ang = positions[..., :, None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


class ParamBuilder:
    """Seeded numpy parameter init, laid out like the reference's
    ``ParamBuilder`` trees (dense weights ~ N(0, 1/fan_in))."""

    def __init__(self, rng: np.random.Generator, dtype, device):
        self.rng, self.dtype, self.device = rng, dtype, device

    def _t(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr, dtype=torch.float32).to(
            device=self.device, dtype=self.dtype)

    def dense(self, shape: Tuple[int, ...],
              scale: Optional[float] = None) -> torch.Tensor:
        fan_in = shape[0] if len(shape) >= 2 else 1
        scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        w = self.rng.standard_normal(shape, dtype=np.float32) * scale
        return self._t(w)

    def ones(self, shape: Tuple[int, ...]) -> torch.Tensor:
        return self._t(np.ones(shape, np.float32))

    def zeros(self, shape: Tuple[int, ...]) -> torch.Tensor:
        return self._t(np.zeros(shape, np.float32))


def init_attention(pb: ParamBuilder, cfg: ModelConfig):
    """The q/k/v/o projections, with qwen2's q/k/v biases (zeros) and
    qwen3's per-head q/k RMSNorm gains (ones) where the config has them."""
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    p = {"wq": pb.dense((d, h * dh)), "wk": pb.dense((d, hkv * dh)),
         "wv": pb.dense((d, hkv * dh)), "wo": pb.dense((h * dh, d))}
    if cfg.qkv_bias:
        p.update(bq=pb.zeros((h * dh,)), bk=pb.zeros((hkv * dh,)),
                 bv=pb.zeros((hkv * dh,)))
    if cfg.qk_norm:
        p.update(q_norm=pb.ones((dh,)), k_norm=pb.ones((dh,)))
    return p


def init_swiglu(pb: ParamBuilder, cfg: ModelConfig, d_ff: int,
                prefix: str = ""):
    d = cfg.d_model
    return {prefix + "w_gate": pb.dense((d, d_ff)),
            prefix + "w_up": pb.dense((d, d_ff)),
            prefix + "w_down": pb.dense((d_ff, d))}


def init_moe(pb: ParamBuilder, cfg: ModelConfig):
    """The router (scale 0.02), the experts' stacked SwiGLU weights
    (``we_gate``/``we_up`` (E, d, f), ``we_down`` (E, f, d)) and the
    shared experts' ``shared_*`` SwiGLU, as the reference's ``init_moe``
    draws them (fan-in is the leading dim, as there)."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {"router": pb.dense((d, e), scale=0.02),
         "we_gate": pb.dense((e, d, f)), "we_up": pb.dense((e, d, f)),
         "we_down": pb.dense((e, f, d))}
    if cfg.n_shared_experts:
        p.update(init_swiglu(pb, cfg, f * cfg.n_shared_experts, "shared_"))
    return p


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random LM weights from a seeded numpy generator, with the
    reference's shapes and scales, in the layout ``models/lm.py``
    describes: a SwiGLU MLP, or the MoE where ``cfg.is_moe_layer``."""
    pb = ParamBuilder(np.random.default_rng(seed), cfg.dtype, device)
    d = cfg.d_model
    params = {"embed": pb.dense((cfg.vocab, d), scale=0.02), "layers": []}
    for i in range(cfg.n_layers):
        params["layers"].append({
            "ln1": pb.ones((d,)),
            "mixer": init_attention(pb, cfg),
            "ln2": pb.ones((d,)),
            "mlp": (init_moe(pb, cfg) if cfg.is_moe_layer(i)
                    else init_swiglu(pb, cfg, cfg.d_ff)),
        })
    params["ln_f"] = pb.ones((d,))
    if not cfg.tie_embeddings:
        params["head"] = pb.dense((d, cfg.vocab), scale=0.02)
    return params
