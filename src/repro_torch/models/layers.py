"""Attention, MLA, RMSNorm+SwiGLU, MoE (and one chip's share of an
expert-parallel MoE layer) and Mamba2 layers of the torch port: the port
of ``repro.models.layers``, the expert-parallel ``_moe_apply_sharded``
included.

``cfg.attn_impl`` / ``cfg.mlp_impl`` pick the implementation:

* ``"pipeline"`` compiles the paper's block program through
  ``repro_torch.pipeline`` and runs the resulting kernel
  (``cfg.pipeline_backend`` ``"cuda"`` on the card, ``"torch"`` for the
  plain lowering).  Both pipeline paths cast their operands to float32, as
  the reference does (layers.py:127-129, 158-161).
* ``"cuda"`` runs the paper's hand-written kernels through
  ``kernels.ops`` (the reference's ``"pallas"``); ``"chunked"`` (attention)
  and ``"fused_ref"`` (MLP) run their plain versions there, ``"ref"`` the
  plain attention oracle, ``"unfused"`` the MLP op by op.

The projections, ``wo``, the head and the MoE experts stay
``torch.matmul``: none of them is inside a Pallas kernel in the reference
either (its unsharded ``moe_apply`` runs ``einsum`` outside any kernel).
On the card, in float32 and at serving shapes, the held experts run on
the grouped expert kernel (``kernels/grouped_experts.py``), which
replaces no Pallas kernel: each expert on only the rows routed to it.
Nor are MLA's attention and Mamba2's SSD: the reference runs both as
plain XLA whatever the impls say, and the port as plain torch.

Under a mesh (``runtime.sharding.use_mesh``), on DTensors, the layers
carry the reference's ``constrain`` sites; a weight stored
``fsdp``-sharded is gathered over ``data`` where it is used.  The
uneven-heads rule: the ``tensor`` axis splits a projection's heads only
where it divides their count (:func:`_heads`), q's heads and the KV
heads decided apart.  Where q's heads split and the KV heads do not, a
one-token step gathers q's heads and attends replicated, as its cache
is, and a longer step repeats each KV head over its group and splits the
copy as q (:func:`_gqa_layout`); where q's heads do not split, the
attention runs replicated over ``model``, its weights gathered there.
The reference's GSPMD pads such heads to a multiple of the axis and
splits them instead; DTensor cannot view a dim it splits unevenly.
Attention, the SSD, the cache writes and the embedding run on each
rank's own shard under DTensor's ``local_map``.  On plain tensors none
of this changes a value.
"""

from __future__ import annotations

import functools
import math
import weakref
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import grouped_experts as GE
from repro_torch.kernels import ops as K
from repro_torch.kernels import ref as R
from repro_torch.models.common import (ModelConfig, apply_rope,
                                       compute_dtype, rms_norm)
from repro_torch.runtime.collectives import (axis_group, axis_index,
                                            copy_to, sum_over)
from repro_torch.runtime.sharding import (active_mesh, axis_names, axis_size,
                                          constrain, divides, is_distributed,
                                          on_whole, placements)


# ---------------------------------------------------------------------------
# Fusion-pipeline execution path
# ---------------------------------------------------------------------------

def _n_blocks(size: int, target: int = 128) -> int:
    """Smallest block count that divides ``size`` evenly with blocks at
    most ``target`` wide; a size with only pathologically thin divisors
    stays whole (as in the reference)."""
    cnt = max(1, -(-size // target))
    while size % cnt:
        cnt += 1
    if cnt > 1 and (size // cnt) * 4 < target:
        return 1
    return cnt


#: the row blocks (``M``: attention's query rows, the SwiGLU's token rows)
#: the ``cuda`` backend tries past 32 rows, widest first
#: (:func:`_compile_blocked`)
CUDA_ROW_BLOCKS = (128, 64, 32)


def _pipeline_dims_blocks(sizes, row_target: int = 128):
    dims = {d: _n_blocks(s, row_target if d == "M" else 128)
            for d, s in sizes.items()}
    blocks = {d: sizes[d] // n for d, n in dims.items()}
    return dims, blocks


def _lowers_whole(g, dims, options, device) -> bool:
    """Whether ``g`` lowers on its requested rung with every planned group
    one kernel: a compile that may neither demote nor open a breaker, its
    warnings kept quiet."""
    import warnings
    from repro_torch import pipeline as PL
    from repro_torch import resilience as RZ
    probe = RZ.ResiliencePolicy(max_rung=RZ.start_rung(options.backend,
                                                       options.group),
                                breaker_threshold=0)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            kern = PL.compile(g, dims, options=options.replace(
                resilience=probe), device=device)
    except RZ.LadderError:
        return False
    return not kern.lowering_report.degraded


def _compile_blocked(g, sizes, options, device, stack=None):
    """``pipeline.compile`` of ``g`` at ``sizes``, each dim in blocks of up
    to 128 (the reference's), the ``stack`` dims (name: count) in blocks of
    1.  The ``cuda`` emitter holds a block's row tiles in shared memory
    (``codegen_cuda.SMEM_LIMIT``), which 128 rows overrun from
    smollm-135m's widths up (its attention at 128 query rows 396,288 B,
    jamba's SwiGLU gate/up 262,144 B): past 32 rows the row dim takes the
    widest block of :data:`CUDA_ROW_BLOCKS` that lowers whole on its rung,
    by the emitter's own count (:func:`_lowers_whole`)."""
    from repro_torch import pipeline as PL
    targets = ((128,) if options.backend != "cuda"
               or sizes["M"] <= CUDA_ROW_BLOCKS[-1] else CUDA_ROW_BLOCKS)
    for target in targets:
        dims, blocks = _pipeline_dims_blocks(sizes, target)
        for d, n in (stack or {}).items():
            dims[d], blocks[d] = n, 1
        opts = options.replace(blocks=blocks)
        if target == targets[-1] or _lowers_whole(g, dims, opts, device):
            return PL.compile(g, dims, options=opts, device=device)


def _pipeline_options(src):
    """The :class:`pipeline.CompileOptions` of a ModelConfig, a bare
    backend string, or an options instance."""
    from repro_torch import pipeline as PL
    if isinstance(src, PL.CompileOptions):
        return src
    if isinstance(src, str):
        return PL.CompileOptions(backend=src)
    if src.pipeline_options is not None:
        return src.pipeline_options
    return PL.CompileOptions(backend=src.pipeline_backend)


@functools.lru_cache(maxsize=256)
def attention_kernel(s: int, dh: int, sk: int, dv: int, group: int,
                     causal: bool, scale: float, options,
                     device: str = "cuda"):
    """One compiled kernel per (shape, group, causal, scale, options,
    device type).  Query positions are kernel data (the QP/KP inputs), so
    a decode step at any cache position, scalar or ragged, reuses the
    same kernel.  ``device`` is where it will run: on ``"cuda"`` its
    compile never demotes to a plain version."""
    from repro_torch.core import array_program as AP
    if group > 1:
        g = AP.gqa_attention_program(scale, causal=causal)
    elif causal:
        g = AP.causal_attention_program(scale)
    else:
        g = AP.attention_program(scale)
    # the head-group dim is a stack axis
    return _compile_blocked(g, {"M": s, "D": dh, "N": sk, "L": dv}, options,
                            device, {"H": group} if group > 1 else None)


@functools.lru_cache(maxsize=256)
def swiglu_kernel(t: int, d: int, d_ff: int, eps: float, options,
                  device: str = "cuda"):
    from repro_torch.core import array_program as AP
    return _compile_blocked(AP.rmsnorm_ffn_swiglu_program(float(d), eps=eps),
                            {"M": t, "D": d, "K": d_ff, "N": d}, options,
                            device)


def _attention_pipeline(q, k, v, scale: float, cfg: ModelConfig, *,
                        causal: bool = False, q_offset=0) -> torch.Tensor:
    """Attention through the fused pipeline, causal or not, MHA or GQA.

    One compiled kernel per shape, launched once over the instance axes
    (batch, kv head): the port's stand-in for the reference's
    ``jax.vmap`` (layers.py:138-139).  Q is per instance, K/V per
    instance, and the position vector QP is shared across heads and per
    sequence only when ``q_offset`` is a ``(b,)`` vector (ragged
    decode)."""
    opts = _pipeline_options(cfg)
    b, hq, sq, dh = q.shape
    _, hkv, skv, _ = k.shape
    dv = v.shape[3]
    group = hq // hkv
    kern = attention_kernel(sq, dh, skv, dv, group, causal, scale, opts,
                            q.device.type)
    dev = q.device
    f32 = torch.float32
    qf = q.to(f32)
    if group > 1:
        qf = qf.reshape(b, hkv, group, sq, dh)
    feed = {"Q": qf.contiguous(), "KT": k.to(f32).contiguous(),
            "VT": v.to(f32).transpose(-1, -2).contiguous()}
    if causal:
        # a Python int offset is made on the device: no host-to-device
        # copy, so a prefill can be captured as a CUDA graph
        off = (torch.full((), float(q_offset), dtype=f32, device=dev)
               if isinstance(q_offset, int)
               else torch.as_tensor(q_offset, dtype=f32, device=dev))
        qp = off[..., None] + torch.arange(sq, dtype=f32, device=dev)
        feed["QP"] = qp.reshape(-1 if off.dim() == 1 else 1, 1, sq)
        feed["KP"] = torch.arange(skv, dtype=f32, device=dev).reshape(
            1, 1, skv)
    o = kern(feed, instances=2)["O"]
    return o.reshape(b, hq, sq, dv).to(q.dtype)


def fold_swiglu_weights(wg, wu, wd, gamma):
    """The SwiGLU program's weight inputs: ``(diag(g) Wg)^T``, ``(diag(g)
    Wu)^T`` and ``Wd^T``, float32 and contiguous."""
    f32 = torch.float32
    gf = gamma.to(f32)[:, None]
    return ((gf * wg.to(f32)).T.contiguous(),
            (gf * wu.to(f32)).T.contiguous(), wd.to(f32).T.contiguous())


#: folded SwiGLU weights by the ids of (wg, wu, wd, gamma): weak references
#: to the four (an entry leaves when one of them is freed), their
#: ``_version``s (a weight changed in place is folded again), the folds
_FOLDED: Dict[tuple, tuple] = {}


def folded_swiglu_weights(wg, wu, wd, gamma):
    """:func:`fold_swiglu_weights`, computed once per weight set."""
    src = (wg, wu, wd, gamma)
    key = tuple(id(t) for t in src)
    versions = tuple(t._version for t in src)
    hit = _FOLDED.get(key)
    if hit is not None and hit[1] == versions and all(
            r() is t for r, t in zip(hit[0], src)):
        return hit[2]
    folded = fold_swiglu_weights(*src)
    refs = tuple(weakref.ref(t, lambda _, k=key: _FOLDED.pop(k, None))
                 for t in src)
    _FOLDED[key] = (refs, versions, folded)
    return folded


def _swiglu_pipeline(x2, wg, wu, wd, gamma, cfg: ModelConfig
                     ) -> torch.Tensor:
    """RMSNorm+FFN-SwiGLU through the fused pipeline.  The norm gain is
    folded into W/V columns (RMS(x)*g @ W == RMS(x) @ diag(g)W), so the
    paper's gain-free Example-3 program applies unchanged; the folded
    weights are made once per weight set (:func:`folded_swiglu_weights`)."""
    t, d = x2.shape
    d_ff = wg.shape[1]
    kern = swiglu_kernel(t, d, d_ff, float(cfg.norm_eps),
                         _pipeline_options(cfg), x2.device.type)
    wt, vt, ut = folded_swiglu_weights(wg, wu, wd, gamma)
    out = kern({"X": x2.to(torch.float32).contiguous(), "WT": wt, "VT": vt,
                "UT": ut})["O"]
    return out.to(x2.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------

def _heads(n: int) -> Optional[str]:
    """The logical axis of a projection's ``n`` heads: ``"tensor"`` where
    the active mesh's tensor axes divide ``n``, else None, the heads
    replicated (the uneven-heads rule, module docstring)."""
    return "tensor" if divides(n, "tensor") else None


def _gqa_layout(q, k, v):
    """q, k, v laid out for attention under a mesh where the tensor axes
    split q's heads but not the KV heads (GQA): a one-query step gathers
    q's heads and attends replicated, as its cache is; a longer one
    repeats each KV head over its query group, as the reference's
    ``attention_xla_flash`` does, and splits the copy as q (a local
    slice, no collective).  Plain tensors pass as they are."""
    hq, hkv = q.shape[1], k.shape[1]
    if (not is_distributed(q) or hq == hkv or _heads(hkv)
            or not _heads(hq)):
        return q, k, v
    if q.shape[2] == 1:
        return constrain(q, "batch", None, None, None), k, v
    g = hq // hkv
    k, v = (constrain(t.repeat_interleave(g, 1), "batch", "tensor", None,
                      None) for t in (k, v))
    return q, k, v


def _attend(q, k, v, cfg: ModelConfig, *, causal: bool, q_offset=0,
            p_half: bool = False):
    """Attention by ``cfg.attn_impl``; ``p_half`` (``impl="chunked"``
    only, the reference's ``attn_p_half``) feeds the PV product
    probabilities rounded to q's dtype."""
    if cfg.attn_impl == "pipeline":
        return _attention_pipeline(q, k, v, 1.0 / cfg.d_head ** 0.5, cfg,
                                   causal=causal, q_offset=q_offset)
    return on_local_heads(
        lambda q, k, v, off: K.flash_attention(
            q, k, v, causal=causal, q_offset=off, impl=cfg.attn_impl,
            p_half=p_half), *_gqa_layout(q, k, v), q_offset)


def on_local_heads(fn, q, k, v, q_offset=0):
    """``fn(q, k, v, q_offset)``, attention over (b, heads, s, d) tensors.
    Under a mesh, on DTensors, it runs on each rank's own (batch, heads)
    shard under DTensor's ``local_map``, k and v laid out as q, as a
    fused kernel runs per shard: its ops are plain tensor ops, counted at
    the shard's shapes.  Plain tensors go straight to ``fn``."""
    if not is_distributed(q):
        return fn(q, k, v, q_offset)
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map
    q = constrain(q, "batch", "tensor", None, None)
    pl = list(q.placements)
    k, v = (t.redistribute(t.device_mesh, pl) for t in (k, v))
    off_pl = (placements((), q.device_mesh)
              if isinstance(q_offset, DTensor) else None)
    out = local_map(fn, out_placements=pl, in_placements=(pl, pl, pl,
                                                          off_pl),
                    device_mesh=q.device_mesh)(q, k, v, q_offset)
    return constrain(out, "batch", "tensor", None, None)


def qkv(p, x, cfg: ModelConfig, positions):
    """q, k, v of shape (b, heads, s, d_head): the projections, qwen2's
    biases, qwen3's per-head RMSNorm of q and k, then RoPE (the
    reference's ``_qkv`` order)."""
    b, s, _ = x.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    qa, ka = _heads(h), _heads(hkv)
    q = x @ constrain(p["wq"], None, qa)
    k = x @ constrain(p["wk"], None, ka)
    v = x @ constrain(p["wv"], None, ka)
    if cfg.qkv_bias:
        q, k, v = (q + constrain(p["bq"], qa), k + constrain(p["bk"], ka),
                   v + constrain(p["bv"], ka))
    q = q.reshape(b, s, h, dh).transpose(1, 2)
    k = k.reshape(b, s, hkv, dh).transpose(1, 2)
    v = v.reshape(b, s, hkv, dh).transpose(1, 2)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta, cfg.yarn)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.yarn)
    return (constrain(q, "batch", "tensor", None, None),
            constrain(k, "batch", "tensor", None, None),
            constrain(v, "batch", "tensor", None, None))


def out_proj(o, w, n_heads: int):
    """``o @ w``, the heads' output projection, laid out as the residual
    stream (``w`` gathered over ``fsdp``, and over ``tensor`` where the
    heads are replicated)."""
    return constrain(o @ constrain(w, _heads(n_heads), None), "batch", None,
                     None)


def attention_apply(p, x, cfg: ModelConfig, *, causal: bool = True,
                    positions=None) -> torch.Tensor:
    b, s, _ = x.shape
    if positions is None and cfg.rope_theta > 0:
        positions = torch.arange(s, device=x.device)
    q, k, v = qkv(p, x, cfg, positions)
    o = _attend(q, k, v, cfg, causal=causal, p_half=cfg.attn_p_half)
    o = o.transpose(1, 2).reshape(b, s, cfg.n_heads * cfg.d_head)
    return out_proj(o, p["wo"], cfg.n_heads)


def attention_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                         device) -> Dict[str, torch.Tensor]:
    shape = (batch, cfg.n_kv_heads, max_len, cfg.d_head)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def pad_seq(t, pad):
    """``F.pad(t, pad)``; ``t`` as it is where ``pad`` adds nothing (the
    dry-run's prefill fills its cache to the prompt's length, and DTensor
    has no rule for the pad op in every version)."""
    return F.pad(t, pad) if any(pad) else t


def embed(table, tokens):
    """The rows of ``table`` (vocab, d) at ``tokens``.  Under a mesh, on
    DTensors, each rank looks its tokens up in its own slice of the
    vocabulary (``local_map``; the table gathered over ``fsdp``): a token
    outside the slice gives zeros, and the slices' results add over the
    ``tensor`` axis (a pending sum the caller's ``constrain`` resolves),
    Megatron's vocabulary-parallel embedding."""
    if not is_distributed(tokens):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    table = constrain(table, "tensor", None)
    mesh = table.device_mesh
    split = [i for i, pl in enumerate(table.placements)
             if isinstance(pl, Shard)]
    out_pl = [Partial() if i in split else
              (pl if isinstance(pl, Shard) else Replicate())
              for i, pl in enumerate(tokens.placements)]

    def lookup(t_l, tok_l):
        if not split:
            return t_l[tok_l]
        rows = t_l.shape[0]
        first = rows * axis_index(mesh, [mesh.mesh_dim_names[i]
                                         for i in split])
        ids = tok_l.long() - first
        inside = (ids >= 0) & (ids < rows)
        return t_l[ids.clamp(0, rows - 1)] * inside[..., None].to(t_l.dtype)

    # the table's gradient: each rank's rows of its own tokens, to be
    # summed over the ranks the tokens are split over
    grad_pl = [Shard(0) if i in split else
               (Partial() if isinstance(pl, Shard) else Replicate())
               for i, pl in enumerate(tokens.placements)]
    return local_map(lookup, out_placements=out_pl,
                     in_placements=(list(table.placements),
                                    list(tokens.placements)),
                     in_grad_placements=(grad_pl, list(tokens.placements)),
                     device_mesh=mesh)(table, tokens)


def write_at(buf, dim: int, pos, val) -> None:
    """Write ``val`` (size 1 along ``dim``) into the cache ``buf`` at the
    scalar position ``pos``, in place (``index_copy_``: a tensor position,
    no ``.item()``, as the reference's ``dynamic_update_slice``).  Under a
    mesh, on DTensors, each rank writes its own shard (DTensor's
    ``local_map``, ``val`` laid out as ``buf``): the write moves nothing
    between ranks."""
    at = pos.reshape(1)
    if not is_distributed(buf):
        buf.index_copy_(dim, at, val.to(buf.dtype))
        return
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map
    pl = list(buf.placements)
    val = val.to(buf.dtype).redistribute(buf.device_mesh, pl)
    at_pl = (placements((), buf.device_mesh) if isinstance(at, DTensor)
             else None)
    local_map(lambda b, a, v: b.index_copy_(dim, a, v), out_placements=pl,
              in_placements=(pl, at_pl, pl), device_mesh=buf.device_mesh)(
        buf, at, val)


def attention_decode(p, x, cache, pos, cfg: ModelConfig):
    """One-token decode: write k/v at ``pos`` and attend over the cache.

    ``pos`` is a scalar (every sequence at the same position) or a
    ``(b,)`` integer vector (ragged continuous-batching step).  Unlike
    the reference, the cache is updated in place (it is returned too).

    ``attn_impl="cuda"`` raises: the hand-written flash kernel takes its
    causal offset as a static int, as the reference's does
    (kernels/flash_attention.py:44-48), and the reference cannot decode on
    it either."""
    if cfg.attn_impl == "cuda":
        raise NotImplementedError(
            "attn_impl='cuda' has no decode step: the flash kernel bakes the "
            "causal q_offset in as a static int, as the reference's "
            "flash_attention_pallas does, which fails on a traced decode "
            "position there; decode with attn_impl 'chunked', 'ref' or "
            "'pipeline'")
    b = x.shape[0]
    pos = torch.as_tensor(pos, dtype=torch.long, device=x.device)
    ragged = pos.dim() == 1
    positions = None
    if cfg.rope_theta > 0:
        positions = pos[:, None, None] if ragged else pos.reshape(1)
    q, k, v = qkv(p, x, cfg, positions)
    ck, cv = cache["k"], cache["v"]
    if ragged:
        rows = torch.arange(b, device=x.device)
        ck[rows, :, pos] = k[:, :, 0].to(ck.dtype)
        cv[rows, :, pos] = v[:, :, 0].to(cv.dtype)
    else:
        write_at(ck, 2, pos, k)
        write_at(cv, 2, pos, v)
    o = _attend(q, ck, cv, cfg, causal=True, q_offset=pos)
    o = o.transpose(1, 2).reshape(b, 1, cfg.n_heads * cfg.d_head)
    return out_proj(o, p["wo"], cfg.n_heads), cache


# ---------------------------------------------------------------------------
# MLA attention (deepseek-v3): low-rank q/kv compression, decoupled RoPE,
# a compressed-KV cache with the absorbed decode form
# ---------------------------------------------------------------------------

def mla_q(p, x, cfg: ModelConfig, positions):
    """Every head's query, split into its no-RoPE and RoPE parts, each
    (b, h, s, dim): through the ``q_lora_rank`` bottleneck and its RMSNorm,
    or ``wq`` where the rank is 0 (the reference's ``_mla_q``)."""
    b, s, _ = x.shape
    qd = cfg.qk_nope_dim + cfg.qk_rope_dim
    if cfg.q_lora_rank:
        q = rms_norm(x @ constrain(p["wq_a"], None, None), p["q_norm"],
                     cfg.norm_eps) @ p["wq_b"]
    else:
        q = x @ constrain(p["wq"], None, "tensor")
    q = q.reshape(b, s, cfg.n_heads, qd).transpose(1, 2)
    q_nope, q_rope = q.split([cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)
    return q_nope, apply_rope(q_rope, positions, cfg.rope_theta, cfg.yarn)


def mla_kv_compressed(p, x, cfg: ModelConfig, positions):
    """The compressed KV latent (b, s, kv_lora_rank), RMS-normalised, and
    the RoPE key every head shares (b, s, qk_rope_dim): what MLA's cache
    holds (the reference's ``_mla_kv_compressed``)."""
    ckv, k_rope = (x @ constrain(p["wkv_a"], None, None)).split(
        [cfg.kv_lora_rank, cfg.qk_rope_dim], dim=-1)
    ckv = rms_norm(ckv, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope[:, None], positions, cfg.rope_theta,
                        cfg.yarn)[:, 0]
    return ckv, k_rope


def mla_softmax_scale(cfg: ModelConfig) -> float:
    """``(qk_nope_dim + qk_rope_dim) ** -0.5``, times YaRN's mscale squared
    where ``cfg.yarn`` sets one (DeepSeek-V3's ``softmax_scale``)."""
    scale = 1.0 / (cfg.qk_nope_dim + cfg.qk_rope_dim) ** 0.5
    if cfg.yarn is not None:
        scale = scale * cfg.yarn.softmax_factor
    return scale


def mla_apply(p, x, cfg: ModelConfig, *, causal: bool = True,
              positions=None) -> torch.Tensor:
    """Full-sequence MLA: ``wkv_b`` expands the latent to every head's key
    (no-RoPE part, then the shared RoPE key) and value, and attention runs
    over keys of width ``qk_nope_dim + qk_rope_dim`` against values of
    width ``v_head_dim``.

    The reference forces its plain ``xla`` attention here whatever
    ``attn_impl`` says, ``ref`` apart (layers.py:346-348), so MLA reaches
    no Pallas kernel; the port runs its counterpart, the plain ``chunked``
    attention (``kernels/ref.py:attention_chunked``, the reference's
    ``kernels/ref.py:86``), or ``ref``."""
    b, s, _ = x.shape
    h = cfg.n_heads
    if positions is None:
        positions = torch.arange(s, device=x.device)
    q_nope, q_rope = mla_q(p, x, cfg, positions)
    ckv, k_rope = mla_kv_compressed(p, x, cfg, positions)
    kv = (ckv @ p["wkv_b"]).reshape(
        b, s, h, cfg.qk_nope_dim + cfg.v_head_dim).transpose(1, 2)
    k_nope, v = kv.split([cfg.qk_nope_dim, cfg.v_head_dim], dim=-1)
    k_rope_h = k_rope[:, None].expand(b, h, s, cfg.qk_rope_dim)
    q = constrain(torch.cat([q_nope, q_rope], -1), "batch", "tensor", None,
                  None)
    k = constrain(torch.cat([k_nope, k_rope_h], -1), "batch", "tensor", None,
                  None)
    scale = mla_softmax_scale(cfg)
    impl = "ref" if cfg.attn_impl == "ref" else "chunked"
    o = on_local_heads(lambda q, k, v, _: K.flash_attention(
        q, k, v, scale=scale, causal=causal, impl=impl), q, k, v)
    return out_proj(o.transpose(1, 2).reshape(b, s, h * cfg.v_head_dim),
                    p["wo"], h)


def mla_init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
                   device) -> Dict[str, torch.Tensor]:
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "krope": torch.zeros((batch, max_len, cfg.qk_rope_dim),
                                 dtype=dtype, device=device)}


def mla_decode(p, x, cache, pos, cfg: ModelConfig):
    """One-token MLA decode in the absorbed form: the query is taken into
    the latent space through ``wkv_b``'s key half, scores run against the
    compressed cache (``kv_lora_rank + qk_rope_dim`` values a token) in
    float32 with the ``-1e30`` frontier mask, and the context leaves
    through the value half (the reference's ``mla_decode``,
    layers.py:365-409: plain einsums, no kernel, as here).

    ``pos`` is a scalar or a ``(b,)`` vector (ragged continuous-batching
    step).  The cache is written in place at ``pos`` (and returned)."""
    b = x.shape[0]
    h, r = cfg.n_heads, cfg.kv_lora_rank
    pos = torch.as_tensor(pos, dtype=torch.long, device=x.device)
    ragged = pos.dim() == 1
    positions = pos[:, None, None] if ragged else pos.reshape(1)
    q_nope, q_rope = mla_q(p, x, cfg, positions)            # (b,h,1,*)
    ckv_t, krope_t = mla_kv_compressed(p, x, cfg, positions)
    ckv, krope = cache["ckv"], cache["krope"]
    if ragged:
        rows = torch.arange(b, device=x.device)
        ckv[rows, pos] = ckv_t[:, 0].to(ckv.dtype)
        krope[rows, pos] = krope_t[:, 0].to(krope.dtype)
    else:
        write_at(ckv, 1, pos, ckv_t)
        write_at(krope, 1, pos, krope_t)
    f32 = torch.float32
    wkv_b = p["wkv_b"].to(f32).reshape(r, h,
                                       cfg.qk_nope_dim + cfg.v_head_dim)
    w_uk = wkv_b[:, :, :cfg.qk_nope_dim]                    # (r,h,nope)
    w_uv = wkv_b[:, :, cfg.qk_nope_dim:]                    # (r,h,v)
    q_abs = torch.einsum("bhqn,rhn->bhqr", q_nope.to(f32), w_uk)
    ckv_f = ckv.to(f32)
    scale = mla_softmax_scale(cfg)
    s = (torch.einsum("bhqr,bsr->bhqs", q_abs, ckv_f)
         + torch.einsum("bhqe,bse->bhqs", q_rope.to(f32),
                        krope.to(f32))) * scale
    cols = torch.arange(ckv.shape[1], device=x.device)[None, None, None, :]
    frontier = pos[:, None, None, None] if ragged else pos
    s = torch.where(cols <= frontier, s, torch.full_like(s, R.NEG_INF))
    pr = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhqs,bsr->bhqr", pr, ckv_f)
    o = torch.einsum("bhqr,rhv->bhqv", ctx, w_uv)
    o = o.transpose(1, 2).reshape(b, 1, h * cfg.v_head_dim).to(x.dtype)
    return out_proj(o, p["wo"], h), cache


# ---------------------------------------------------------------------------
# RMSNorm + FFN-SwiGLU
# ---------------------------------------------------------------------------

#: ``cfg.mlp_impl`` values that run a fused kernel API of ``kernels.ops``,
#: with the ``impl`` each passes (the reference's layers.py:441-446)
FUSED_MLP_IMPLS = {"fused_ref": "ref", "cuda": "cuda"}


def rmsnorm_swiglu_apply(p, x, gamma, cfg: ModelConfig) -> torch.Tensor:
    """O = (swish(RMS_g(x) @ Wg) * (RMS_g(x) @ Wu)) @ Wd."""
    b, s, d = x.shape
    x2 = x.reshape(b * s, d)
    wg, wu, wd = swiglu_weights(p)
    if cfg.mlp_impl == "pipeline":
        out = _swiglu_pipeline(x2, wg, wu, wd, gamma, cfg)
    elif cfg.mlp_impl == "unfused":
        xn = rms_norm(x2, gamma, cfg.norm_eps)
        gate = xn @ wg
        out = (gate * torch.sigmoid(gate) * (xn @ wu)) @ wd
    elif cfg.mlp_impl in FUSED_MLP_IMPLS:
        out = K.rmsnorm_swiglu(x2, wg, wu, wd, gamma, eps=cfg.norm_eps,
                               impl=FUSED_MLP_IMPLS[cfg.mlp_impl])
    else:
        raise ValueError(f"mlp_impl {cfg.mlp_impl!r} is not ported")
    return constrain(out.reshape(b, s, d), "batch", None, None)


def swiglu_weights(p, prefix: str = ""):
    """A SwiGLU's gate, up and down weights, gathered over ``fsdp`` where
    they are used."""
    return (constrain(p[prefix + "w_gate"], None, "tensor"),
            constrain(p[prefix + "w_up"], None, "tensor"),
            constrain(p[prefix + "w_down"], "tensor", None))


# ---------------------------------------------------------------------------
# MoE (qwen3-moe, deepseek-v3, jamba): top-k routing with capacity,
# scatter dispatch into per-expert buffers, the experts' SwiGLU as batched
# products (on the card, the grouped expert kernel); on one chip of an
# expert-parallel layer, its experts' share
# ---------------------------------------------------------------------------

def _route(xn, p, cfg: ModelConfig):
    """``(top_w, top_ids)``, each (T, top_k), by ``cfg.router_score``:

    * ``"softmax"``: router softmax in float32, top-k, renormalised
      weights (the reference's);
    * ``"sigmoid"``: deepseek-v3's ``noaux_tc``, as its modelling code
      computes it in float32: scores ``s = sigmoid(xn W_r)``; the choice
      by ``c = s + router_bias``: each of ``router_groups`` groups scored
      by the sum of its two best ``c``, the best ``router_groups_kept``
      groups kept, the other groups' ``c`` set to 0.0, the top-k of ``c``;
      the weights ``s`` of the chosen, over their sum (+1e-20), times
      ``routed_scale``.  The bias chooses and does not weight."""
    logits = xn.float() @ p["router"].float()
    if cfg.router_score == "softmax":
        probs = torch.softmax(logits, -1)
        top_w, top_ids = torch.topk(probs, cfg.top_k)  # sorted, descending
        return top_w / top_w.sum(-1, keepdim=True), top_ids
    if cfg.router_score != "sigmoid":
        raise ValueError(f"router_score {cfg.router_score!r}: expected "
                         "'softmax' or 'sigmoid'")
    t, e = logits.shape
    groups = cfg.router_groups
    scores = logits.sigmoid()
    choice = scores + p["router_bias"].float()
    by_group = choice.view(t, groups, e // groups)
    group_scores = by_group.topk(2, dim=-1)[0].sum(-1)
    kept = group_scores.topk(cfg.router_groups_kept, dim=-1)[1]
    mask = torch.zeros_like(group_scores).scatter_(1, kept, 1.0)
    choice = by_group.masked_fill(mask[..., None] == 0, 0.0).view(t, e)
    top_ids = choice.topk(cfg.top_k, dim=-1)[1]
    top_w = scores.gather(1, top_ids)
    top_w = top_w / (top_w.sum(-1, keepdim=True) + 1e-20)
    return top_w * cfg.routed_scale, top_ids


def _shared_experts(p, xn):
    wg, wu, wd = swiglu_weights(p, "shared_")
    return (R.swish(xn @ wg) * (xn @ wu)) @ wd


def moe_capacity(t: int, cfg: ModelConfig) -> int:
    """Slots an expert has for ``t`` tokens (of all ``n_experts``, held
    here or not)."""
    return int(min(t, max(1, math.ceil(t * cfg.top_k * cfg.capacity_factor
                                       / cfg.n_experts))))


def moe_dispatch(top_ids, capacity: int, n_experts: int):
    """``(keep, slot)`` of each (token, k) assignment: its position among
    the expert's earlier assignments in the flattened (token, k) order
    (a prefix count) is its slot, kept while below ``capacity``; a dropped
    one points at the expert's last slot."""
    t, k = top_ids.shape
    flat = F.one_hot(top_ids.reshape(-1), n_experts)      # (T k, E)
    pos = ((flat.cumsum(0) - flat) * flat).sum(-1).reshape(t, k)
    return pos < capacity, top_ids * capacity + pos.clamp(max=capacity - 1)


def _takes_grouped(p, xn, top_ids, n_experts: int) -> bool:
    """Whether the held experts run on the grouped expert kernel: on the
    card, in float32, with no gradient required and no mesh active, where
    the step's assignments average at most one row tile
    (``grouped_experts.RT`` rows) an expert of the ``n_experts``.  The
    kernel reads a touched expert's weights once for each tile of its
    rows, the padded products every held expert's once for all its
    capacity, so past that the kernel's extra passes outweigh the experts
    it leaves unread: on the card deepseek-v3's, qwen3-moe's and jamba's
    layers ran faster on the kernel at up to 8 assignments an expert, and
    qwen3-moe's and jamba's slower at 16 (PERF.md, row 6).  Every other
    caller (CPU tensors, training, the mesh's layers) keeps the padded
    products of :func:`_held_experts_out`."""
    ws = [p[n] for n in ("we_gate", "we_up", "we_down")]
    return (xn.is_cuda and active_mesh() is None
            and top_ids.numel() <= GE.RT * n_experts
            and all(a.dtype == torch.float32 and not a.requires_grad
                    for a in [xn, *ws])
            and xn.shape[1] % 4 == 0 and ws[0].shape[2] % 4 == 0)


def _held_experts_out(p, xn, top_w, top_ids, capacity: int, base: int,
                      count: int, n_experts: int) -> torch.Tensor:
    """The routed output (T, d) the experts ``base`` .. ``base + count -
    1`` give, ``p["we_*"]`` holding their weights: each expert takes at
    most ``capacity`` of the T tokens (:func:`moe_dispatch` over all
    ``n_experts``); a dropped assignment, or one to an expert held
    elsewhere, points at row 0, scatters zeros there and gets weight 0."""
    t, d = xn.shape
    k = top_ids.shape[1]

    def dispatch(xn, top_ids):
        keep, slot = moe_dispatch(top_ids, capacity, n_experts)
        if count < n_experts:
            held = (top_ids >= base) & (top_ids < base + count)
            keep = keep & held
            slot = torch.where(held, slot - base * capacity, 0)
        slot = slot.reshape(-1)
        updates = xn.repeat_interleave(k, 0) * keep.reshape(-1, 1).to(
            xn.dtype)
        buf = xn.new_zeros(count * capacity, d)
        buf.index_add_(0, slot, updates)   # kept slots are distinct: exact
        return buf, keep, slot

    # under a mesh the dispatch and the combine's gather run on the whole
    # batch on every rank (``on_whole``); the experts' products are split
    buf, keep, slot = on_whole(dispatch, xn, top_ids)
    # experts over the model axis and capacity over the data axes (the
    # reference's layers.py:509-517), the stacks gathered over fsdp
    eb = constrain(buf.reshape(count, capacity, d), "expert", "capacity",
                   None)
    wg, wu, wd = (constrain(p[n], "expert", None, None)
                  for n in ("we_gate", "we_up", "we_down"))
    h = R.swish(constrain(torch.bmm(eb, wg), "expert", "capacity", None)
                ) * constrain(torch.bmm(eb, wu), "expert", "capacity", None)
    eo = constrain(torch.bmm(h, wd), "expert", "capacity", None)
    eo = constrain(eo, None, None, None).reshape(count * capacity, d)
    routed = constrain(on_whole(lambda e, i: e[i].reshape(t, k, d), eo,
                                slot), "batch", None, None)
    w = (top_w * keep).to(routed.dtype)
    return torch.einsum("tkd,tk->td", routed, w)


def moe_apply(p, x, gamma, cfg: ModelConfig,
              assigned: Optional[list] = None) -> torch.Tensor:
    """x: (B, S, d).  RMSNorm -> router -> top-k experts (+ shared): the
    reference's unsharded ``moe_apply``.  Each expert takes at most
    :func:`moe_capacity` of the T = B S tokens (:func:`moe_dispatch`); a
    dropped assignment scatters zeros and gets weight 0.  Padding tokens
    and free decode slots route like any other, as in the reference.

    ``cfg.held_experts`` = (first, count): the experts whose weights
    ``p["we_*"]`` hold, as the reference's mesh gives a chip ``e_base``
    and ``e_local`` (layers.py:566, 600).  The router, the capacity and
    the drops are the whole layer's; the output is the part the held
    experts give (plus the shared experts), what one chip of an
    expert-parallel layer adds to the layer's sum before the exchange.
    Holding every expert, this is the unsharded layer.

    With ``cfg.moe_impl == "shard_map"`` under an active mesh that has
    ``data`` and ``model`` axes, the expert-parallel layer runs instead
    (:func:`_moe_apply_sharded`), as in the reference (layers.py:472-476).

    On the card the held experts run on the grouped expert kernel where
    :func:`_takes_grouped` says so, each on only the rows routed to it;
    elsewhere as the padded products of :func:`_held_experts_out`.

    ``assigned``, a list, receives a (T + 1,) tensor on the device (the
    unsharded layer only): each token's count of its (token, k)
    assignments that land on held experts, then the rows the held experts
    computed (on the grouped kernel each one's kept rows, none padded; on
    the padded products count x capacity).  The engine's ``moe_assigned``
    and ``moe_rows``, with no sync."""
    mesh = active_mesh()
    if (cfg.moe_impl == "shard_map" and mesh is not None
            and {"data", "model"} <= set(axis_names(mesh))):
        if is_distributed(x):
            return _moe_apply_local_map(p, x, gamma, cfg, x.device_mesh)
        return _moe_apply_sharded(p, x, gamma, cfg, mesh)
    b, s, d = x.shape
    e = cfg.n_experts
    base, count = cfg.held_experts
    if p["we_gate"].shape[0] != count or not 0 <= base <= e - count:
        raise ValueError(f"experts {base}..{base + count - 1} of {e}: the "
                         f"weights hold {p['we_gate'].shape[0]}")
    t = b * s
    xn = rms_norm(x, gamma, cfg.norm_eps).reshape(t, d)
    # under a mesh the dispatch is the whole batch's (one capacity over
    # every token): the tokens are gathered for it, as GSPMD does
    xg = constrain(xn, None, None)
    top_w, top_ids = _route(xg, p, cfg)
    capacity = moe_capacity(t, cfg)
    if _takes_grouped(p, xg, top_ids, e):
        # the dispatch keeps moe_dispatch's slots and drops; the combine
        # weights each token's kept slots by top_w
        out, _, counts = GE.grouped_moe_cuda(
            xg, top_w, top_ids, p["we_gate"], p["we_up"], p["we_down"],
            base, capacity)
    else:
        out = _held_experts_out(p, xg, top_w, top_ids, capacity, base,
                                count, e)
        if assigned is not None:
            held = ((top_ids >= base) & (top_ids < base + count)).sum(-1)
            counts = torch.cat([held, held.new_full((1,), count * capacity)])
    if assigned is not None:
        assigned.append(counts)
    if cfg.n_shared_experts:
        out = out + _shared_experts(p, xn)
    return constrain(out.reshape(b, s, d).to(x.dtype), "batch", None, None)


def _moe_apply_sharded(p, x, gamma, cfg: ModelConfig, mesh
                       ) -> torch.Tensor:
    """The expert-parallel MoE layer on one rank of ``mesh`` (the
    reference's ``_moe_apply_sharded``, layers.py:533-620).

    ``x`` (B, S, d) is this rank's data shard of the tokens, the same on
    every rank of its ``model`` group; ``p["we_*"]`` hold this rank's
    ``e_local = n_experts / |model|`` experts, ``model`` index ``j``
    holding ``j e_local`` on (an expert stack's ``fsdp`` axis is storage
    only: the rank computes on the whole ``d``).

      1. routing on the rank's tokens (float32 softmax, top-k);
      2. dispatch with the capacity of a data shard, ``cap_local`` =
         :func:`moe_capacity` of its T_local tokens, not the whole
         layer's; the rank fills its own experts' rows only;
      3. its experts' SwiGLU, then the combine of their rows, weighted by
         ``top_w`` in ``xn``'s dtype;
      4. the partials summed over the ``model`` group in bfloat16, as the
         reference's ``psum(out.astype(bfloat16), "model")``; then the
         shared experts.

    The tokens need no exchange: the ``model`` group holds the same
    shard.  The sum is :func:`~repro_torch.runtime.collectives.sum_over`
    and the experts' inputs pass :func:`~repro_torch.runtime.collectives.
    copy_to`, so the gradients of ``x`` and of the router are whole on
    every rank of the group; each weight's gradient is its data shard's
    part, to be summed over ``data`` as any data-parallel gradient is."""
    b, s, d = x.shape
    e = cfg.n_experts
    t = b * s
    e_local = e // axis_size(mesh, "model")
    base = mesh.get_local_rank("model") * e_local
    if p["we_gate"].shape[0] != e_local:
        raise ValueError(f"this model rank holds {e_local} experts from "
                         f"{base}; the weights hold "
                         f"{p['we_gate'].shape[0]}")
    if cfg.expert_share not in (None, (base, e_local)):
        raise ValueError(f"expert_share {cfg.expert_share} is not the "
                         f"mesh's ({base}, {e_local})")
    xn = rms_norm(x, gamma, cfg.norm_eps).reshape(t, d)
    top_w, top_ids = _route(xn, p, cfg)
    group = axis_group(mesh, "model")
    out = _held_experts_out(p, copy_to(xn, group),
                            copy_to(top_w.to(xn.dtype), group), top_ids,
                            moe_capacity(t, cfg), base, e_local, e)
    out = sum_over(out.to(torch.bfloat16), group)
    if cfg.n_shared_experts:
        out = out.to(xn.dtype) + _shared_experts(p, xn)
    return out.reshape(b, s, d).to(x.dtype)


def _moe_apply_local_map(p, x, gamma, cfg: ModelConfig, mesh
                         ) -> torch.Tensor:
    """:func:`_moe_apply_sharded` on DTensors, under DTensor's
    ``local_map`` with the placements of the reference's ``shard_map``
    specs (layers.py:575-610): the tokens split over the batch axes and
    whole on each ``model`` rank, the expert stacks split over ``model``
    (gathered over ``fsdp``: the rank computes on the whole d), the router
    and the shared experts whole; the output split as the tokens."""
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.runtime.sharding import logical_to_spec
    names = sorted(p)
    weights = [constrain(p[n], "expert", None, None) if n.startswith("we_")
               else constrain(p[n], *([None] * p[n].dim())) for n in names]
    rows = placements(logical_to_spec(("batch",), mesh), mesh)
    whole = placements((), mesh)
    in_pl = tuple(placements(logical_to_spec(("expert",), mesh), mesh)
                  if n.startswith("we_") else whole for n in names)
    # each weight's (and gamma's) gradient is its data shard's part, to be
    # summed over the batch axes; x's is its own rows'
    grad_pl = tuple([Partial() if isinstance(r, Shard) else w
                     for r, w in zip(rows, pl)] for pl in (whole,) + in_pl)

    def local(x_l, g_l, *ws):
        return _moe_apply_sharded(dict(zip(names, ws)), x_l, g_l, cfg, mesh)

    fn = local_map(local, out_placements=rows,
                   in_placements=(rows, whole) + in_pl,
                   in_grad_placements=(rows,) + grad_pl, device_mesh=mesh,
                   redistribute_inputs=True)
    return fn(constrain(x, "batch", None, None), constrain(gamma, None),
              *weights)


def moe_ref(p, x, gamma, cfg: ModelConfig) -> torch.Tensor:
    """Dense per-expert loop oracle (tests only; no capacity drops)."""
    b, s, d = x.shape
    xn = rms_norm(x, gamma, cfg.norm_eps).reshape(b * s, d)
    top_w, top_ids = _route(xn, p, cfg)
    out = torch.zeros_like(xn)
    for e_i in range(cfg.n_experts):
        he = R.swish(xn @ p["we_gate"][e_i]) * (xn @ p["we_up"][e_i])
        oe = he @ p["we_down"][e_i]
        wsel = torch.where(top_ids == e_i, top_w, 0.0).sum(-1)
        out = out + oe * wsel[:, None].to(oe.dtype)
    if cfg.n_shared_experts:
        out = out + _shared_experts(p, xn)
    return out.reshape(b, s, d).to(x.dtype)


def mlp_apply(p, x, gamma, cfg: ModelConfig, layer: int,
              assigned: Optional[list] = None) -> torch.Tensor:
    """Layer ``layer``'s MLP on the residual stream ``x``: the MoE where
    ``cfg.is_moe_layer(layer)`` (``assigned`` as :func:`moe_apply` takes
    it), else RMSNorm+SwiGLU."""
    if cfg.is_moe_layer(layer):
        return moe_apply(p, x, gamma, cfg, assigned)
    return rmsnorm_swiglu_apply(p, x, gamma, cfg)


# ---------------------------------------------------------------------------
# Mamba2 (SSD, chunked): attention-free, the chunked matmul form
# ---------------------------------------------------------------------------
# The reference runs all of it as plain XLA, no Pallas kernel
# (layers.py:662-820); the port runs it as plain torch on the tensors'
# device, as the reference does on its own.

def _mamba_proj(p, x, cfg: ModelConfig):
    """z, the conv channels (x_in, B, C) and dt of ``w_in``."""
    di, n = cfg.d_inner, cfg.ssm_state
    return (x @ constrain(p["w_in"], None, "tensor")).split(
        [di, di + 2 * n, cfg.n_ssm_heads], dim=-1)


def _causal_conv(xbc, p, cfg: ModelConfig):
    """Depthwise causal conv of width ``cfg.ssm_conv`` over the sequence
    axis of (b, s, channels), then SiLU."""
    w = p["conv_w"]                                      # (W, C)
    width, s = w.shape[0], xbc.shape[1]
    if is_distributed(xbc):       # zeros before the sequence, as F.pad
        pad = torch.cat([torch.zeros_like(xbc[:, :width - 1]), xbc], 1)
    else:
        pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + s] * w[i] for i in range(width))
    return F.silu(out + p["conv_b"])


def _ssd_chunked(xh, dt, A, B, C, cfg: ModelConfig, h0=None):
    """SSD forward (Mamba-2) in chunks of ``cfg.ssm_chunk``: xh (b, s, nh,
    hd), dt (b, s, nh), A (nh,), B and C (b, s, n).  Returns y (b, s, nh,
    hd) and the final state (b, nh, hd, n), in float32 (float64 for
    float64 inputs: ``compute_dtype``); ``h0`` is the state
    before the first token (zeros when None).  The sequence is padded to
    whole chunks (dt = 0 there, so the state passes through unchanged) and
    y cut back to ``s``.  The reference's inter-chunk ``lax.scan`` is a
    loop over the chunks.  One departure from the reference's arithmetic
    (layers.py:696-699, 708-710), not from its result: the decay exponents
    are sums within each segment, not differences of prefix sums, which
    keeps float32 within 5e-7 of float64 at mamba2-2.7b's chunk of 256
    where the differences leave more than 1e-6 (relative to the largest
    output; tests/test_torch_ssm.py)."""
    b, s, nh, hd = xh.shape
    n = B.shape[-1]
    q = min(cfg.ssm_chunk, s)
    pad = (-s) % q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt, B, C = (F.pad(t, (0, 0, 0, pad)) for t in (dt, B, C))
    L = (s + pad) // q
    ct = compute_dtype(xh.dtype)
    xh = xh.reshape(b, L, q, nh, hd).to(ct)
    dt = dt.reshape(b, L, q, nh).to(ct)
    Bc = B.reshape(b, L, q, n).to(ct)
    Cc = C.reshape(b, L, q, n).to(ct)

    dA = dt * A                                          # (b,L,q,nh) <= 0
    cs = torch.cumsum(dA, dim=2)
    # seg[i, j] = dA_{j+1} + ... + dA_i, summed within the segment (the
    # Mamba-2 paper's segsum), not as cs_i - cs_j: the difference of two
    # prefix sums near -|cs| loses |cs| 2^-24 to cancellation
    ones = torch.ones(q, q, dtype=torch.bool, device=xh.device)
    strict, causal = ones.tril(-1), ones.tril()
    seg = torch.cumsum(dA[:, :, :, None, :].expand(b, L, q, q, nh)
                       .masked_fill(~strict[None, None, :, :, None], 0.0),
                       dim=2)                            # (b,L,q,q,nh)
    # masked before exp: exp(seg) * 0 would be NaN where seg overflows
    decay = torch.exp(seg.masked_fill(~causal[None, None, :, :, None],
                                      float("-inf")))

    # intra-chunk (the diagonal blocks): y = (C B^T . decay . dt) x
    cb = torch.einsum("blqn,blkn->blqk", Cc, Bc)
    att = cb[..., None] * decay * dt[:, :, None, :, :]   # (b,L,q,k,nh)
    y_diag = torch.einsum("blqkh,blkhd->blqhd", att, xh)

    # chunk states: h_c = sum_j exp(cs_end - cs_j) dt_j B_j x_j, the
    # exponent being seg's last row
    w_end = torch.exp(seg[:, :, -1]) * dt                # (b,L,q,nh)
    states = torch.einsum("blqn,blqh,blqhd->blhdn", Bc, w_end, xh)

    # inter-chunk recurrence over the L chunks
    chunk_decay = torch.exp(cs[:, :, -1, :])             # (b,L,nh)
    h = (torch.zeros((b, nh, hd, n), dtype=ct, device=xh.device)
         if h0 is None else h0.to(ct))
    h_prevs = []
    for c in range(L):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prevs, 1)                     # (b,L,nh,hd,n)

    y_inter = torch.einsum("blqn,blqh,blhdn->blqhd", Cc, torch.exp(cs),
                           h_prev)
    y = (y_diag + y_inter).reshape(b, L * q, nh, hd)[:, :s]
    return y, h


def _ssd(xh, dt, A, B, C, cfg: ModelConfig):
    """:func:`_ssd_chunked`.  Under a mesh, on DTensors, each rank runs it
    on its own (batch, heads) shard (DTensor's ``local_map``; B and C,
    shared by the heads, whole on the rank): the recurrence is
    independent per sequence and head, so no rank needs another's."""
    if not is_distributed(xh):
        return _ssd_chunked(xh, dt, A, B, C, cfg)
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    xh = constrain(xh, "batch", None, "tensor", None)
    dt = constrain(dt, "batch", None, "tensor")
    A = constrain(A, "tensor")
    B, C = (constrain(t, "batch", None, None) for t in (B, C))
    split = xh.placements
    ins = [list(t.placements) for t in (xh, dt, A, B, C)]
    # an input whole along a mesh dim the work is split over gets a
    # partial gradient there
    grads = [[pl if isinstance(pl, Shard) else
              Partial() if isinstance(sp, Shard) else pl
              for pl, sp in zip(t_pl, split)] for t_pl in ins]
    h_pl = [Shard(1) if isinstance(sp, Shard) and sp.dim == 2 else sp
            for sp in split]
    return local_map(lambda *a: _ssd_chunked(*a, cfg),
                     out_placements=(list(split), h_pl),
                     in_placements=tuple(ins), in_grad_placements=tuple(grads),
                     device_mesh=xh.device_mesh)(xh, dt, A, B, C)


def _mamba_inner(p, xn, cfg: ModelConfig):
    """The block's body after its norm: returns the output before ``w_out``,
    the raw conv channels and the final SSM state."""
    b, s, _ = xn.shape
    nh, hd, n, di = (cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                     cfg.d_inner)
    ct = compute_dtype(xn.dtype)
    z, xbc_raw, dt = _mamba_proj(p, xn, cfg)
    xbc = _causal_conv(xbc_raw, p, cfg)
    xin, B, C = xbc.split([di, n, n], dim=-1)
    xh = xin.reshape(b, s, nh, hd)
    dt = F.softplus(dt.to(ct) + p["dt_bias"].to(ct))
    A = -torch.exp(p["A_log"].to(ct))
    y, h = _ssd(xh, dt, A, B, C, cfg)
    y = y + xh.to(ct) * p["D"].to(ct)[None, None, :, None]
    y = y.reshape(b, s, di).to(xn.dtype)
    y = rms_norm(y * F.silu(z), p["ssm_norm"], cfg.norm_eps)
    return y, xbc_raw, h


def _mamba_out(y, p):
    """``y @ w_out``, laid out as the residual stream."""
    return constrain(y @ constrain(p["w_out"], "tensor", None), "batch",
                     None, None)


def mamba_apply(p, x, gamma, cfg: ModelConfig) -> torch.Tensor:
    """Pre-norm Mamba2 block on the residual stream ``x`` (returns the
    residual delta)."""
    y, _, _ = _mamba_inner(p, rms_norm(x, gamma, cfg.norm_eps), cfg)
    return _mamba_out(y, p)


def mamba_init_cache(cfg: ModelConfig, batch: int, dtype, device
                     ) -> Dict[str, torch.Tensor]:
    """The decode state: the SSM state ``h`` (float32) and the last
    ``ssm_conv - 1`` raw conv inputs ``conv``."""
    return {"h": torch.zeros((batch, cfg.n_ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1,
                                 cfg.d_inner + 2 * cfg.ssm_state),
                                dtype=dtype, device=device)}


def mamba_prefill(p, x, gamma, cfg: ModelConfig):
    """:func:`mamba_apply` that also returns the decode cache: the final
    SSM state and the raw conv window (zeros before the first token)."""
    s = x.shape[1]
    y, xbc_raw, h = _mamba_inner(p, rms_norm(x, gamma, cfg.norm_eps), cfg)
    w = cfg.ssm_conv - 1
    window = (F.pad(xbc_raw, (0, 0, w - s, 0)) if w > s
              else xbc_raw)[:, -w:]
    return _mamba_out(y, p), {"h": h, "conv": window.to(cfg.dtype)}


def mamba_decode(p, x, gamma, cache, cfg: ModelConfig):
    """One-token SSM step: the conv over the cached window and the new
    input, then the O(1) state update.  Returns the residual delta and the
    new cache ``{"h", "conv"}`` (the caller stores it)."""
    b = x.shape[0]
    nh, hd, n, di = (cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                     cfg.d_inner)
    ct = compute_dtype(x.dtype)
    z, xbc, dt = _mamba_proj(p, rms_norm(x, gamma, cfg.norm_eps), cfg)
    window = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)], 1)
    conv = F.silu((window * p["conv_w"][None]).sum(1, keepdim=True)
                  + p["conv_b"])
    xin, B, C = conv.split([di, n, n], dim=-1)
    xh = xin.reshape(b, nh, hd).to(ct)
    dtv = F.softplus(dt[:, 0].to(ct) + p["dt_bias"].to(ct))   # (b,nh)
    A = -torch.exp(p["A_log"].to(ct))
    decay = torch.exp(dtv * A[None])
    h = cache["h"] * decay[:, :, None, None] + torch.einsum(
        "bh,bhd,bn->bhdn", dtv, xh, B[:, 0].to(ct))
    y = torch.einsum("bhdn,bn->bhd", h, C[:, 0].to(ct))
    y = y + xh * p["D"].to(ct)[None, :, None]
    y = y.reshape(b, 1, di).to(x.dtype)
    y = rms_norm(y * F.silu(z), p["ssm_norm"], cfg.norm_eps)
    return _mamba_out(y, p), {"h": h, "conv": window[:, 1:]}


def pipeline_kernels(cfg: ModelConfig, *, prefill_lens=(),
                     decode_batch: Optional[int] = None,
                     max_len: Optional[int] = None,
                     device: str = "cuda",
                     prefill_batch: int = 1) -> Dict[str, object]:
    """Compile (without running) the pipeline kernels a serving run on
    ``device`` (a device type) touches, by name: one attention and one
    SwiGLU kernel per prefill length (``attention_prefill8``...; the
    SwiGLU over ``prefill_batch`` sequences of that length), plus the
    ragged decode pair (``attention_decode``, ``swiglu_decode``).  Only
    the mixers and MLPs some layer has are compiled: MLA never takes the
    attention pipeline (:func:`mla_apply`), a model of MoE layers only has
    no SwiGLU kernel, and a Mamba2 model neither; a hybrid has both."""
    opts = _pipeline_options(cfg)
    d, eps = cfg.d_model, float(cfg.norm_eps)
    layers = range(cfg.n_layers)
    attn = cfg.attn_impl == "pipeline" and any(
        cfg.mixer_of(i) == "attn" for i in layers)
    mlp = cfg.mlp_impl == "pipeline" and any(
        cfg.mlp_of(i) == "swiglu" for i in layers)
    if attn:
        scale = 1.0 / cfg.d_head ** 0.5
        group = cfg.n_heads // cfg.n_kv_heads
        dh = cfg.d_head
    out: Dict[str, object] = {}
    for s in prefill_lens:
        if attn:
            out[f"attention_prefill{s}"] = attention_kernel(
                s, dh, s, dh, group, True, scale, opts, device)
        if mlp:
            out[f"swiglu_prefill{s}"] = swiglu_kernel(
                prefill_batch * s, d, cfg.d_ff, eps, opts, device)
    if decode_batch is not None:
        if attn:
            out["attention_decode"] = attention_kernel(
                1, dh, max_len, dh, group, True, scale, opts, device)
        if mlp:
            out["swiglu_decode"] = swiglu_kernel(decode_batch, d, cfg.d_ff,
                                                 eps, opts, device)
    return out
