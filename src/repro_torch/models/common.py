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
import functools
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"       # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_head: int = 64
    d_ff: int = 1024
    vocab: int = 1024
    max_seq: int = 8192
    rope_theta: float = 10000.0
    # YaRN (port only; rope_factor 1.0: plain RoPE): the rotary
    # frequencies of pairs past the original length's correction range
    # divided by the factor, and the softmax scale times
    # yarn_mscale(rope_factor, rope_mscale_all_dim) ** 2 (``yarn``)
    rope_factor: float = 1.0
    rope_original_max: int = 4096
    rope_beta_fast: float = 32.0
    rope_beta_slow: float = 1.0
    rope_mscale: float = 1.0
    rope_mscale_all_dim: float = 0.0
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
    moe_period: int = 1          # apply MoE every k-th layer (jamba: 2)
    expert_share: Optional[Tuple[int, int]] = None  # (first expert,
                                 # count) whose weights this card holds:
                                 # one chip of an expert-parallel layer,
                                 # the router still over all n_experts
                                 # (None: every expert)
    # the router's scores (port only; the defaults are the reference's
    # softmax top-k): "sigmoid" is deepseek-v3's noaux_tc (layers._route),
    # with a correction bias that chooses the experts and does not weight
    # them, ``router_groups`` groups of experts of which each token keeps
    # the best ``router_groups_kept``, and the routed output scaled by
    # ``routed_scale``
    router_score: str = "softmax"  # softmax | sigmoid
    router_groups: int = 1
    router_groups_kept: int = 1
    routed_scale: float = 1.0
    # --- MLA (deepseek) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # --- SSM (mamba2 SSD) ---
    ssm_state: int = 128
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    attn_period: int = 0         # hybrid: every k-th layer is attention
                                 # (jamba: 8 -> 1 attn : 7 mamba)
    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    enc_seq: int = 1500
    # --- vlm (internvl) ---
    n_vision_tokens: int = 0
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
    remat: bool = True           # recompute each layer in the backward
    remat_policy: str = "full"   # full | dots (dots: keep the outputs of
                                 # the matrix products; the hand kernels
                                 # are recomputed under either)
    moe_impl: str = "dense"      # dense | shard_map (the expert-parallel
                                 # layer under a mesh with data and model
                                 # axes: layers._moe_apply_sharded)
    attn_p_half: bool = False    # attn_impl "chunked": the PV product takes
                                 # the probabilities in the model dtype,
                                 # float32 sums (reference common.py:89)
    cuda_graphs: bool = True     # serving on a CUDA device: the engine
                                 # replays each prompt bucket's prefill and
                                 # its decode step as captured CUDA graphs
                                 # (port only; launch/engine.py; False:
                                 # eager, for tests and debugging)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def yarn(self) -> Optional["Yarn"]:
        """The YaRN scaling of RoPE, or None for plain RoPE."""
        if self.rope_factor == 1.0:
            return None
        return Yarn(self.rope_factor, self.rope_original_max,
                    self.rope_beta_fast, self.rope_beta_slow,
                    self.rope_mscale, self.rope_mscale_all_dim)

    @property
    def held_experts(self) -> Tuple[int, int]:
        """(first expert, count) of the experts whose weights this card
        holds (``expert_share``; all ``n_experts`` when None)."""
        return self.expert_share or (0, self.n_experts)

    def is_attn_layer(self, i: int) -> bool:
        if self.family not in ("ssm", "hybrid"):
            return True
        if self.family == "ssm":
            return False
        # jamba: one attention layer per attn_period block (at index p//2)
        return i % self.attn_period == (self.attn_period // 2)

    def is_moe_layer(self, i: int) -> bool:
        if self.n_experts == 0:
            return False
        return i >= self.n_dense_layers and (i % self.moe_period ==
                                             self.moe_period - 1)

    def mixer_of(self, i: int) -> str:
        """Layer ``i``'s token mixer, as the reference's ``plan_stages``
        (lm.py:48-72) lays it out: ``"mamba"`` (every layer of the ``ssm``
        family, a hybrid's non-attention layers), ``"mla"`` (``use_mla``)
        or ``"attn"``."""
        if not self.is_attn_layer(i):
            return "mamba"
        return "mla" if self.use_mla else "attn"

    def mlp_of(self, i: int) -> str:
        """Layer ``i``'s MLP: ``"moe"``, ``"swiglu"``, or ``"none"`` (the
        ``ssm`` family; a hybrid's Mamba layers have an MLP)."""
        if self.family == "ssm":
            return "none"
        return "moe" if self.is_moe_layer(i) else "swiglu"


def reduced_config(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family variant for CPU tests (the reference's
    ``reduced_config``; a hybrid keeps one whole period)."""
    small = dict(
        n_layers=min(cfg.n_layers, cfg.attn_period or 4),
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
        q_lora_rank=64 if cfg.q_lora_rank else 0,
        kv_lora_rank=32 if cfg.use_mla else 0,
        qk_nope_dim=32 if cfg.use_mla else 0,
        qk_rope_dim=16 if cfg.use_mla else 0,
        v_head_dim=32 if cfg.use_mla else 0,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_chunk=32,
        n_enc_layers=min(cfg.n_enc_layers, 2),
        enc_seq=64 if cfg.n_enc_layers else 0,
        n_vision_tokens=min(cfg.n_vision_tokens, 16),
        dtype=torch.float32,
        remat=False,
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)


def compute_dtype(dtype) -> torch.dtype:
    """What the norms, the SSD and the loss compute in: float32, where the
    reference upcasts to float32, or float64 for float64 tensors (JAX has
    none by default), so that a float64 model is a float64 yardstick."""
    return torch.promote_types(dtype, torch.float32)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float
             ) -> torch.Tensor:
    ct = compute_dtype(x.dtype)
    xf = x.to(ct)
    irms = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * irms * gamma.to(ct)).to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float) -> torch.Tensor:
    ct = compute_dtype(x.dtype)
    xf = x.to(ct)
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * gamma.to(ct) + beta.to(ct)).to(x.dtype)


def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    """YaRN's attention factor ``0.1 mscale ln(factor) + 1`` (1 for no
    scaling), DeepSeek-V3's ``yarn_get_mscale``."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


@dataclass(frozen=True)
class Yarn:
    """YaRN's scaling of RoPE (arXiv 2309.00071) as DeepSeek-V3's modelling
    code applies it (``DeepseekV3YarnRotaryEmbedding`` and the attention's
    ``softmax_scale``): ``ModelConfig.yarn``."""
    factor: float
    original_max: int
    beta_fast: float
    beta_slow: float
    mscale: float
    mscale_all_dim: float

    def correction_range(self, d_head: int, theta: float) -> Tuple[int, int]:
        """The pair indices ``(low, high)``: pairs at or below ``low`` keep
        their frequency, pairs at or above ``high`` take it divided by the
        factor (``yarn_find_correction_range``)."""
        def dim(rotations):
            return (d_head * math.log(self.original_max
                                      / (rotations * 2 * math.pi))
                    / (2 * math.log(theta)))
        return (max(math.floor(dim(self.beta_fast)), 0),
                min(math.ceil(dim(self.beta_slow)), d_head - 1))

    @property
    def cos_scale(self) -> float:
        """The factor on the rotation's cos and sin."""
        return (yarn_mscale(self.factor, self.mscale)
                / yarn_mscale(self.factor, self.mscale_all_dim))

    @property
    def softmax_factor(self) -> float:
        """The factor on the attention's softmax scale."""
        if not self.mscale_all_dim:
            return 1.0
        return yarn_mscale(self.factor, self.mscale_all_dim) ** 2


def rope_frequencies(d_head: int, theta: float, device=None,
                     yarn: Optional[Yarn] = None) -> torch.Tensor:
    """The rotary frequency of each pair; with ``yarn``, the blend of each
    frequency and it over the factor along the linear ramp between the
    correction range's ends, in float32 in the published order (its
    table, made by device ops alone, is kept per device)."""
    if yarn is not None:
        return _yarn_frequencies(d_head, theta, torch.device(device), yarn)
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


@functools.lru_cache(maxsize=32)
def _yarn_frequencies(d_head: int, theta: float, device: torch.device,
                      yarn: Yarn) -> torch.Tensor:
    power = theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                   device=device) / d_head)
    extra, inter = 1.0 / power, 1.0 / (yarn.factor * power)
    low, high = yarn.correction_range(d_head, theta)
    ramp = ((torch.arange(d_head // 2, dtype=torch.float32, device=device)
             - low) / ((high + 0.001 if low == high else high) - low)
            ).clamp(0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               yarn: Optional[Yarn] = None) -> torch.Tensor:
    """x: (..., S, Dh) with Dh even; positions (S,) or broadcastable, e.g.
    ``(B, 1, 1)`` for one ragged decode position per sequence.  The pairs
    are the two halves of Dh (``x_i``, ``x_{i + Dh/2}``); ``yarn`` scales
    the frequencies (:func:`rope_frequencies`) and cos and sin."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device, yarn)
    ang = positions[..., :, None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    if yarn is not None and yarn.cos_scale != 1.0:
        cos, sin = cos * yarn.cos_scale, sin * yarn.cos_scale
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 onehot: bool = False) -> torch.Tensor:
    """Mean next-token cross entropy, accumulated in float32: the
    logsumexp minus the gold logit (the reference's ``softmax_xent``,
    common.py:248).  The gold logit is gathered; ``onehot=True`` takes it
    by the reference's one-hot reduction instead, which it uses only to
    keep vocabulary-sharded logits sharded.  On DTensor logits under a
    mesh the gold logit is a masked sum over each rank's vocabulary
    slice."""
    from repro_torch.runtime.sharding import (constrain, is_distributed,
                                              replicate)
    lf = logits.to(compute_dtype(logits.dtype))
    if is_distributed(lf):
        # the logsumexp by its parts, so that a vocabulary-sharded row is
        # reduced where it lies (a max and a sum over the ranks), not
        # gathered
        m = lf.detach().amax(-1, keepdim=True)
        logz = (torch.log(torch.exp(lf - m).sum(-1, keepdim=True))
                + m)[..., 0]
    else:
        logz = torch.logsumexp(lf, dim=-1)
    labels = labels.long()
    if onehot:
        gold = (lf * F.one_hot(labels, lf.shape[-1]).to(lf.dtype)).sum(-1)
    elif is_distributed(lf):
        # vocabulary-sharded logits: each rank sums its own slice of the
        # vocabulary where it holds the label (Megatron's vocab-parallel
        # cross entropy), then the ranks add
        ids = constrain(replicate(torch.arange(lf.shape[-1],
                                               device=lf.device), lf),
                        "tensor")
        gold = torch.where(ids == labels[..., None], lf, 0.0).sum(-1)
        # laid out by rows, so that the mean's gradient reaches each
        # rank's rows as they are split (not the whole batch)
        return constrain(logz - gold, "batch", None).mean()
    else:
        gold = lf.gather(-1, labels[..., None])[..., 0]
    return (logz - gold).mean()


#: the products ``remat_policy="dots"`` keeps from the forward pass (the
#: reference's ``dots_with_no_batch_dims_saveable``): the hand kernels are
#: no ATen op, so they are recomputed under either policy, as the
#: reference recomputes its Pallas kernels, which are no ``dot_general``
SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
                  torch.ops.aten.addmm.default)


def remat(fn: Callable, cfg: ModelConfig, *args):
    """``fn(*args)``, one layer, recomputed in the backward pass where
    ``cfg.remat`` is set and autograd records (the reference's ``_remat``,
    lm.py:24): under ``torch.no_grad`` it runs once, as a serving or
    prefill call does."""
    if not (cfg.remat and torch.is_grad_enabled()):
        return fn(*args)
    if cfg.remat_policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=lambda: (
                              create_selective_checkpoint_contexts(
                                  list(SAVED_PRODUCTS))))
    if cfg.remat_policy != "full":
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: expected "
                         "'full' or 'dots'")
    return checkpoint(fn, *args, use_reentrant=False)


class ParamBuilder:
    """Seeded parameter init, laid out like the reference's
    ``ParamBuilder`` trees (dense weights ~ N(0, 1/fan_in)).  Each
    creator takes the leaf's logical axes (``runtime.sharding``), as the
    reference's do; :class:`SpecBuilder` returns them in its place.

    On the CPU numpy's ``rng`` draws every value.  On a CUDA device a
    ``torch.Generator`` on that device, seeded once from ``rng``, draws
    each tensor in place where it lives: numpy draws about 10^9 float32
    values in 15 s on the host, and one of deepseek-v3's expert stacks
    alone holds 3.8 x 10^9 (PERF.md).  So one seed gives one set of weights
    per device type; the tests that hold the port against the reference
    load the reference's own weights (``LM.from_jax_params``).  On the
    ``meta`` device nothing is drawn: each leaf has its shape and dtype
    and no memory, as the reference's ``jax.eval_shape`` gives them."""

    def __init__(self, rng: np.random.Generator, dtype, device):
        self.rng, self.dtype = rng, dtype
        self.device = torch.device(device)
        self._gen = None
        if self.device.type == "cuda":
            self._gen = torch.Generator(device=self.device)
            self._gen.manual_seed(int(rng.integers(2 ** 62)))

    def _t(self, arr: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(arr, dtype=torch.float32).to(
            device=self.device, dtype=self.dtype)

    def dense(self, shape: Tuple[int, ...], axes=None,
              scale: Optional[float] = None) -> torch.Tensor:
        fan_in = shape[0] if len(shape) >= 2 else 1
        scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
        if self.device.type == "meta":
            return torch.empty(shape, dtype=self.dtype, device=self.device)
        if self._gen is not None:
            w = torch.empty(shape, dtype=torch.float32, device=self.device)
            return w.normal_(0.0, scale, generator=self._gen).to(self.dtype)
        w = self.rng.standard_normal(shape, dtype=np.float32) * scale
        return self._t(w)

    def ones(self, shape: Tuple[int, ...], axes=None) -> torch.Tensor:
        return torch.ones(shape, dtype=self.dtype, device=self.device)

    def zeros(self, shape: Tuple[int, ...], axes=None) -> torch.Tensor:
        return torch.zeros(shape, dtype=self.dtype, device=self.device)


class SpecBuilder:
    """Stands in for :class:`ParamBuilder`: each creator returns the
    leaf's logical axes, so the init functions give the spec tree of the
    parameters they lay out (the reference's ``ParamBuilder.specs``)."""

    @staticmethod
    def _axes(shape, axes) -> Tuple[Optional[str], ...]:
        if axes is None or len(axes) != len(shape):
            raise ValueError(f"a leaf of shape {shape} needs one logical "
                             f"axis a dim, got {axes}")
        return tuple(axes)

    def dense(self, shape, axes=None, scale=None):
        return self._axes(shape, axes)

    def ones(self, shape, axes=None):
        return self._axes(shape, axes)

    def zeros(self, shape, axes=None):
        return self._axes(shape, axes)


def init_attention(pb: ParamBuilder, cfg: ModelConfig):
    """The q/k/v/o projections, with qwen2's q/k/v biases (zeros) and
    qwen3's per-head q/k RMSNorm gains (ones) where the config has them."""
    d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    col, row = ("fsdp", "tensor"), ("tensor", "fsdp")
    p = {"wq": pb.dense((d, h * dh), col), "wk": pb.dense((d, hkv * dh), col),
         "wv": pb.dense((d, hkv * dh), col), "wo": pb.dense((h * dh, d), row)}
    if cfg.qkv_bias:
        p.update(bq=pb.zeros((h * dh,), ("tensor",)),
                 bk=pb.zeros((hkv * dh,), ("tensor",)),
                 bv=pb.zeros((hkv * dh,), ("tensor",)))
    if cfg.qk_norm:
        p.update(q_norm=pb.ones((dh,), (None,)),
                 k_norm=pb.ones((dh,), (None,)))
    return p


def init_swiglu(pb: ParamBuilder, cfg: ModelConfig, d_ff: int,
                prefix: str = ""):
    d = cfg.d_model
    return {prefix + "w_gate": pb.dense((d, d_ff), ("fsdp", "tensor")),
            prefix + "w_up": pb.dense((d, d_ff), ("fsdp", "tensor")),
            prefix + "w_down": pb.dense((d_ff, d), ("tensor", "fsdp"))}


def init_moe(pb: ParamBuilder, cfg: ModelConfig):
    """The router over all ``n_experts`` (scale 0.02; with sigmoid scores
    its correction bias ``router_bias``, N(0, 0.02^2), drawn after the
    stacks), the held experts' stacked SwiGLU weights (``we_gate``/
    ``we_up`` (E, d, f), ``we_down`` (E, f, d), E the count of
    ``cfg.held_experts``) and the shared experts' ``shared_*`` SwiGLU, as
    the reference's ``init_moe`` draws them: the stacks' fan-in is their
    leading dim there, the whole layer's ``n_experts``, whatever share a
    card holds."""
    d, f = cfg.d_model, cfg.moe_d_ff
    e = cfg.held_experts[1]
    scale = 1.0 / math.sqrt(cfg.n_experts)
    p = {"router": pb.dense((d, cfg.n_experts), (None, None), scale=0.02),
         "we_gate": pb.dense((e, d, f), ("expert", "fsdp", None), scale),
         "we_up": pb.dense((e, d, f), ("expert", "fsdp", None), scale),
         "we_down": pb.dense((e, f, d), ("expert", None, "fsdp"), scale)}
    if cfg.router_score == "sigmoid":
        p["router_bias"] = pb.dense((cfg.n_experts,), (None,), scale=0.02)
    if cfg.n_shared_experts:
        p.update(init_swiglu(pb, cfg, f * cfg.n_shared_experts, "shared_"))
    return p


def init_mla(pb: ParamBuilder, cfg: ModelConfig):
    """MLA's projections (the reference's ``init_mla``, layers.py:289-303):
    q through the ``q_lora_rank`` bottleneck (``wq_a``, its RMSNorm gain
    ``q_norm``, ``wq_b``), or ``wq`` where the rank is 0; the joint KV
    compression ``wkv_a`` to ``kv_lora_rank`` plus the shared RoPE key,
    its gain ``kv_norm``, the up-projection ``wkv_b`` to every head's
    no-RoPE key and value, and ``wo``."""
    d, h = cfg.d_model, cfg.n_heads
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    r = cfg.kv_lora_rank
    if cfg.q_lora_rank:
        p = {"wq_a": pb.dense((d, cfg.q_lora_rank), ("fsdp", None)),
             "q_norm": pb.ones((cfg.q_lora_rank,), (None,)),
             "wq_b": pb.dense((cfg.q_lora_rank, h * qd), (None, "tensor"))}
    else:
        p = {"wq": pb.dense((d, h * qd), ("fsdp", "tensor"))}
    p.update(wkv_a=pb.dense((d, r + cfg.qk_rope_dim), ("fsdp", None)),
             kv_norm=pb.ones((r,), (None,)),
             wkv_b=pb.dense((r, h * (cfg.qk_nope_dim + cfg.v_head_dim)),
                            (None, "tensor")),
             wo=pb.dense((h * cfg.v_head_dim, d), ("tensor", "fsdp")))
    return p


def init_mamba(pb: ParamBuilder, cfg: ModelConfig):
    """A Mamba2 block (the reference's ``init_mamba``, layers.py:648-659):
    ``w_in`` to z, the conv channels (x, B, C) and dt; the depthwise conv
    ``conv_w`` (scale 0.5) and ``conv_b``; ``A_log``, ``dt_bias`` and the
    skip ``D`` per head (zeros); the gated RMSNorm gain ``ssm_norm``;
    ``w_out``."""
    d, di, n, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.n_ssm_heads
    conv_ch = di + 2 * n
    ten = ("tensor",)
    return {"w_in": pb.dense((d, 2 * di + 2 * n + nh), ("fsdp", "tensor")),
            "conv_w": pb.dense((cfg.ssm_conv, conv_ch), (None, "tensor"),
                               scale=0.5),
            "conv_b": pb.zeros((conv_ch,), ten),
            "A_log": pb.zeros((nh,), ten),
            "dt_bias": pb.zeros((nh,), ten), "D": pb.zeros((nh,), ten),
            "ssm_norm": pb.ones((di,), ten),
            "w_out": pb.dense((di, d), ("tensor", "fsdp"))}


INIT_MIXER = {"attn": init_attention, "mla": init_mla, "mamba": init_mamba}


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda"):
    """Random LM weights from a seed (:class:`ParamBuilder`), with the
    reference's shapes and scales, in the layout ``models/lm.py``
    describes: each layer's mixer by ``cfg.mixer_of``, then its MLP by
    ``cfg.mlp_of`` (the reference's lm.py:80-97)."""
    return build_params(cfg, ParamBuilder(np.random.default_rng(seed),
                                          cfg.dtype, device))


def build_params(cfg: ModelConfig, pb):
    """The LM's parameter tree from the builder ``pb``: tensors from a
    :class:`ParamBuilder`, logical axes from a :class:`SpecBuilder`."""
    d = cfg.d_model
    params = {"embed": pb.dense((cfg.vocab, d), ("tensor", "fsdp"),
                                scale=0.02),
              "layers": []}
    for i in range(cfg.n_layers):
        layer = {"ln1": pb.ones((d,), (None,)),
                 "mixer": INIT_MIXER[cfg.mixer_of(i)](pb, cfg)}
        mlp = cfg.mlp_of(i)
        if mlp != "none":
            layer["ln2"] = pb.ones((d,), (None,))
            layer["mlp"] = (init_moe(pb, cfg) if mlp == "moe"
                            else init_swiglu(pb, cfg, cfg.d_ff))
        params["layers"].append(layer)
    params["ln_f"] = pb.ones((d,), (None,))
    if not cfg.tie_embeddings:
        params["head"] = pb.dense((d, cfg.vocab), ("fsdp", "tensor"),
                                  scale=0.02)
    return params
