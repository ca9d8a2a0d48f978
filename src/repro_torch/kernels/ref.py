"""Plain PyTorch versions of the hand-written kernels: the port of
``repro.kernels.ref``.

These are the unfused semantics of the paper's Examples 1-3.  The tests
hold the kernels against them, and they are what ``impl="ref"`` and
``impl="chunked"`` run in ``kernels/ops.py``.  They compute in float32 and
return the input's dtype, as the reference does.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _causal_rows(q_offset, sq: int, device) -> torch.Tensor:
    """Query positions ``q_offset + r``: ``(sq, 1)``, or ``(B, 1, 1, sq,
    1)`` for a ``(B,)`` offset (each sequence its own causal frontier).
    A Python int offset is added on the device: no host-to-device copy,
    so a prefill can be captured as a CUDA graph."""
    if isinstance(q_offset, int):
        return torch.arange(sq, device=device)[:, None] + q_offset
    off = torch.as_tensor(q_offset, device=device)
    if off.dim() == 1:
        off = off[:, None, None, None, None]
    return off + torch.arange(sq, device=device)[:, None]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: Optional[float] = None, causal: bool = False,
                  q_offset=0) -> torch.Tensor:
    """Multi-head attention with GQA.

    q: (B, Hq, Sq, Dh); k, v: (B, Hkv, Skv, Dh); Hq % Hkv == 0.  Softmax
    in float32 with max subtraction; ``q_offset`` is a scalar or a
    ``(B,)`` vector of query positions."""
    b, hq, sq, dh = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / dh ** 0.5
    qf = q.float().reshape(b, hkv, group, sq, dh)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    if causal:
        rows = _causal_rows(q_offset, sq, q.device)
        cols = torch.arange(skv, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, v.shape[-1]).to(q.dtype)


def attention_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      scale: Optional[float] = None, causal: bool = False,
                      q_offset=0, k_start: int = 0, block_kv: int = 512,
                      p_half: bool = False):
    """The online softmax of the paper's appendix over the keys ``k``, ``v``
    (positions ``k_start`` on), in chunks of ``block_kv`` keys: the carry
    ``(m, l, acc)``, each ``(B, Hkv, group, Sq, .)``, unnormalised.  No keys
    give the exact-zero carry ``(NEG_INF, 0, 0)``.  ``p_half``: the PV
    product takes the probabilities rounded to q's dtype, the accumulator
    float32 (the reference's ``attention_xla_flash(p_half=True)``,
    kernels/ref.py:107-109: half-precision operands, float32 sums)."""
    b, hq, sq, dh = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[-1]
    group = hq // hkv
    if scale is None:
        scale = 1.0 / dh ** 0.5
    qf = q.float().reshape(b, hkv, group, sq, dh)
    rows = _causal_rows(q_offset, sq, q.device) if causal else None
    m = torch.full((b, hkv, group, sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, group, sq, 1), device=q.device)
    acc = torch.zeros((b, hkv, group, sq, dv), device=q.device)
    for k0 in range(0, skv, block_kv):
        kc = k[:, :, k0:k0 + block_kv].float()
        vc = v[:, :, k0:k0 + block_kv].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kc) * scale
        if causal:
            cols = k_start + k0 + torch.arange(kc.shape[2],
                                               device=q.device)[None, :]
            s = torch.where(rows >= cols, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if p_half:
            p = p.to(q.dtype).float()
        acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p, vc)
        m = m_new
    return m, l, acc


def attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      scale: Optional[float] = None, causal: bool = False,
                      q_offset=0, block_kv: int = 512,
                      p_half: bool = False) -> torch.Tensor:
    """Flash-attention semantics in plain PyTorch (the reference's
    ``attention_xla_flash``): a loop over KV chunks of ``block_kv`` keys
    with the running-max carry of the paper's appendix, so memory stays
    O(Sq * Dh + block_kv * Dh) per head.  ``p_half``: see
    :func:`attention_partial`."""
    _, l, acc = attention_partial(q, k, v, scale=scale, causal=causal,
                                  q_offset=q_offset,
                                  block_kv=min(block_kv, k.shape[2]),
                                  p_half=p_half)
    return (acc / l).reshape(*q.shape[:3], v.shape[-1]).to(q.dtype)


def layernorm_ref(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * gamma.float()
            + beta.float()).to(x.dtype)


def layernorm_matmul_ref(x: torch.Tensor, y: torch.Tensor,
                         gamma: torch.Tensor, beta: torch.Tensor,
                         eps: float = 1e-5) -> torch.Tensor:
    """Paper Example 2 with the affine extension: LayerNorm_rows(X) @ Y."""
    ln = layernorm_ref(x, gamma, beta, eps).float()
    return (ln @ y.float()).to(x.dtype)


def rmsnorm_ref(x: torch.Tensor, gamma: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    irms = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * irms * gamma.float()).to(x.dtype)


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def rmsnorm_swiglu_ref(x: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                       u: torch.Tensor, gamma: torch.Tensor,
                       eps: float = 1e-6) -> torch.Tensor:
    """Paper Example 3: O = (Swish(RMS(X) @ W) * (RMS(X) @ V)) @ U."""
    xn = rmsnorm_ref(x, gamma, eps).float()
    h = swish(xn @ w.float()) * (xn @ v.float())
    return (h @ u.float()).to(x.dtype)
