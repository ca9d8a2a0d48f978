"""Public fused-kernel API with implementation dispatch and training
support: the port of ``repro.kernels.ops``.

``impl``:

* ``"cuda"`` (and ``None``) — the hand-written CUDA kernel on CUDA
  tensors (it launches or raises); on CPU tensors its plain version.  The
  reference's ``"pallas"``; its ``"interpret"`` has no counterpart, the
  plain version takes its place.
* ``"ref"`` — the plain PyTorch oracle (``kernels/ref.py``).
* ``"chunked"`` — attention only: flash semantics as a loop over KV
  chunks (the reference's ``"xla"``, ``attention_xla_flash``).

All three entry points are differentiable: the forward runs the chosen
implementation, the backward is autograd of the plain oracle, recomputed
(the reference's ``_with_ref_vjp``, the Flash-Attention-style backward).

The ``block_*`` arguments are the reference's TPU tile sizes.  They are
accepted for signature parity and steer only ``impl="chunked"``
(``block_kv``); the CUDA kernels choose their own tiles (PERF.md).
``p_half`` steers ``impl="chunked"`` alone, as the reference's steers its
``"xla"``.  The reference's ``unroll`` knob of its XLA scan is not
ported: it exists because XLA's ``cost_analysis`` counts a scan body
once, and PyTorch runs every chunk eagerly.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from repro_torch.kernels import ref as R
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.layernorm_matmul import layernorm_matmul_cuda
from repro_torch.kernels.rmsnorm_swiglu import rmsnorm_swiglu_cuda


class _WithRefVJP(torch.autograd.Function):
    """The reference's ``_with_ref_vjp``: forward ``fused(*args)``;
    backward the VJP of ``ref_fn``, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, fused: Callable, ref_fn: Callable, *args):
        ctx.ref_fn = ref_fn
        ctx.save_for_backward(*args)
        return fused(*args)

    @staticmethod
    def backward(ctx, ct):
        args = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            leaves = [a.detach().requires_grad_(n)
                      for a, n in zip(args, needs)]
            out = ctx.ref_fn(*leaves)
            wanted = [a for a, n in zip(leaves, needs) if n]
            grads = iter(torch.autograd.grad(out, wanted, ct))
        return (None, None, *[next(grads) if n else None for n in needs])


def _impl(impl: Optional[str], allowed) -> str:
    impl = impl or "cuda"
    if impl not in allowed:
        raise ValueError(f"impl {impl!r}: expected one of {allowed}")
    return impl


# ---------------------------------------------------------------------------
# Flash attention (paper Example 1)
# ---------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None, causal: bool = False,
                    q_offset=0, impl: Optional[str] = None,
                    block_q: int = 128, block_kv: int = 512,
                    p_half: bool = False) -> torch.Tensor:
    """Attention of q (B, Hq, Sq, Dh) over k, v (B, Hkv, Skv, Dh), GQA
    when Hq > Hkv.  ``q_offset`` places the queries for the causal mask:
    a static int for ``"cuda"`` (as for the reference's kernel); a scalar
    or a ``(B,)`` tensor for ``"ref"``/``"chunked"``.  ``p_half``: the
    chunked PV product takes the probabilities rounded to q's dtype
    (reference kernels/ref.py:107-109)."""
    impl = _impl(impl, ("cuda", "ref", "chunked"))
    ref_fn = functools.partial(R.attention_ref, scale=scale, causal=causal,
                               q_offset=q_offset)
    if impl == "ref":
        fused = ref_fn
    elif impl == "chunked":
        fused = functools.partial(R.attention_chunked, scale=scale,
                                  causal=causal, q_offset=q_offset,
                                  block_kv=block_kv, p_half=p_half)
    else:
        fused = functools.partial(flash_attention_cuda, scale=scale,
                                  causal=causal, q_offset=q_offset)
    return _WithRefVJP.apply(fused, ref_fn, q, k, v)


# ---------------------------------------------------------------------------
# Flash-LayerNorm+Matmul (paper Example 2)
# ---------------------------------------------------------------------------

def layernorm_matmul(x: torch.Tensor, y: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, *, eps: float = 1e-5,
                     impl: Optional[str] = None, block_m: int = 128,
                     block_n: int = 128, block_k: int = 512) -> torch.Tensor:
    """LayerNorm_{gamma,beta}(x) @ y for x (M, K), y (K, N)."""
    impl = _impl(impl, ("cuda", "ref"))
    ref_fn = functools.partial(R.layernorm_matmul_ref, eps=eps)
    fused = ref_fn if impl == "ref" else functools.partial(
        layernorm_matmul_cuda, eps=eps)
    return _WithRefVJP.apply(fused, ref_fn, x, y, gamma, beta)


# ---------------------------------------------------------------------------
# Flash-RMSNorm+FFN-SwiGLU (paper Example 3)
# ---------------------------------------------------------------------------

def rmsnorm_swiglu(x: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
                   u: torch.Tensor, gamma: torch.Tensor, *,
                   eps: float = 1e-6, impl: Optional[str] = None,
                   block_m: int = 128, block_k: int = 512) -> torch.Tensor:
    """(swish(RMS_gamma(x) @ w) * (RMS_gamma(x) @ v)) @ u for x (M, D),
    w, v (D, K), u (K, N)."""
    impl = _impl(impl, ("cuda", "ref"))
    ref_fn = functools.partial(R.rmsnorm_swiglu_ref, eps=eps)
    fused = ref_fn if impl == "ref" else functools.partial(
        rmsnorm_swiglu_cuda, eps=eps)
    return _WithRefVJP.apply(fused, ref_fn, x, w, v, u, gamma)
