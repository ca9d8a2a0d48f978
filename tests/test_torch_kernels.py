"""The port's hand-written-kernel API (``repro_torch.kernels.ops``) against
the JAX reference (``repro.kernels.ops``) on the same inputs.

The sweeps mirror ``tests/test_kernels.py``: its shapes, float32 and
bfloat16, its tolerances and input scalings.  Numpy makes the inputs from
a seed; the reference runs its Pallas kernels with ``impl="interpret"``.
The port runs ``impl="ref"``, ``impl="cuda"`` on CPU tensors (each
kernel's plain version) and, for attention, ``impl="chunked"``.  The
gradients through the port's ``autograd.Function`` (forward: the kernel
path; backward: autograd of the plain oracle) match ``jax.grad`` through
the reference's ``_with_ref_vjp`` at 1e-4.  The kernels themselves run on
the card in ``tests/test_torch_cuda_kernels.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JK
from repro_torch.core import cuda_build as CB
from repro_torch.kernels import flash_attention as TFA
from repro_torch.kernels import layernorm_matmul as TLN
from repro_torch.kernels import ops as TK
from repro_torch.kernels import ref as TR
from repro_torch.kernels import rmsnorm_swiglu as TSW
import torch_port  # noqa: F401

TOL = {"float32": 2e-4, "bfloat16": 5e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# tests/test_kernels.py:23-31, :48-49, :65-66
FLASH = [(2, 4, 2, 64, 64, 32, False), (1, 8, 8, 96, 96, 64, True),
         (2, 4, 1, 48, 80, 32, False), (1, 2, 2, 1, 100, 64, True),
         (1, 2, 2, 33, 33, 128, True)]
LNMM = [(64, 128, 96), (100, 256, 64), (32, 64, 32), (8, 128, 8)]
SWIGLU = [(64, 128, 96, 64), (40, 64, 256, 64), (16, 128, 64, 128)]


def _arrays(seed, dtype, *shapes, scales=None):
    """Seeded normal arrays, rounded to ``dtype`` and held as float32
    numpy (bfloat16 values are exact in float32)."""
    rng = np.random.default_rng(seed)
    scales = scales or [1.0] * len(shapes)
    out = []
    for shape, s in zip(shapes, scales):
        a = (rng.normal(size=shape) * s).astype(np.float32)
        out.append(np.array(jnp.asarray(a, JDT[dtype]).astype(jnp.float32)))
    return out


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(TDT[dtype]) for a in arrs]


def _check(got: torch.Tensor, want: np.ndarray, dtype, atol, rtol):
    assert got.dtype == TDT[dtype]
    np.testing.assert_allclose(got.float().numpy(), want, atol=atol,
                               rtol=rtol)


@functools.lru_cache(maxsize=None)
def _flash_case(i, dtype):
    b, hq, hkv, sq, skv, dh, causal = FLASH[i]
    q, k, v = _arrays(i, dtype, (b, hq, sq, dh), (b, hkv, skv, dh),
                      (b, hkv, skv, dh))
    qoff = skv - sq if causal else 0
    want = JK.flash_attention(*(jnp.asarray(a, JDT[dtype]) for a in (q, k, v)),
                              causal=causal, q_offset=qoff, impl="interpret",
                              block_q=32, block_kv=32)
    return (q, k, v), causal, qoff, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("impl", ["ref", "cuda", "chunked"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(FLASH)),
                         ids=[str(c) for c in FLASH])
def test_flash_attention_matches_reference(case, dtype, impl):
    arrs, causal, qoff, want = _flash_case(case, dtype)
    got = TK.flash_attention(*_torch(arrs, dtype), causal=causal,
                             q_offset=qoff, impl=impl, block_kv=32)
    _check(got, want, dtype, TOL[dtype], TOL[dtype])


@functools.lru_cache(maxsize=None)
def _lnmm_case(i, dtype):
    m, k, n = LNMM[i]
    x, y = _arrays(10 + i, dtype, (m, k), (k, n))
    gamma, beta = _arrays(20 + i, "float32", (k,), (k,), scales=[0.1, 0.1])
    gamma = gamma + 1.0
    want = JK.layernorm_matmul(jnp.asarray(x, JDT[dtype]),
                               jnp.asarray(y, JDT[dtype]),
                               jnp.asarray(gamma), jnp.asarray(beta),
                               impl="interpret", block_m=32, block_n=32,
                               block_k=64)
    return (x, y), (gamma, beta), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("impl", ["ref", "cuda"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(LNMM)), ids=[str(c) for c in LNMM])
def test_layernorm_matmul_matches_reference(case, dtype, impl):
    xy, gb, want = _lnmm_case(case, dtype)
    x, y = _torch(xy, dtype)
    gamma, beta = (torch.from_numpy(a) for a in gb)
    got = TK.layernorm_matmul(x, y, gamma, beta, impl=impl)
    k = LNMM[case][1]
    _check(got, want, dtype, TOL[dtype] * k ** 0.5, TOL[dtype])


@functools.lru_cache(maxsize=None)
def _swiglu_case(i, dtype):
    m, d, k, n = SWIGLU[i]
    x, w, v, u = _arrays(30 + i, dtype, (m, d), (d, k), (d, k), (k, n),
                         scales=[1.0, d ** -0.5, d ** -0.5, k ** -0.5])
    (gamma,) = _arrays(40 + i, "float32", (d,), scales=[0.1])
    gamma = gamma + 1.0
    want = JK.rmsnorm_swiglu(*(jnp.asarray(a, JDT[dtype])
                               for a in (x, w, v, u)),
                             jnp.asarray(gamma), impl="interpret",
                             block_m=32, block_k=32)
    return (x, w, v, u), gamma, np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("impl", ["ref", "cuda"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(SWIGLU)),
                         ids=[str(c) for c in SWIGLU])
def test_rmsnorm_swiglu_matches_reference(case, dtype, impl):
    arrs, gamma, want = _swiglu_case(case, dtype)
    got = TK.rmsnorm_swiglu(*_torch(arrs, dtype), torch.from_numpy(gamma),
                            impl=impl)
    _check(got, want, dtype, 2 * TOL[dtype], 2 * TOL[dtype])


def test_chunked_attention_is_invariant_to_the_chunk_size():
    """The online-softmax carry makes the result independent of the KV
    decomposition (the reference's appendix claim, test_kernels.py:86)."""
    q, k, v = _torch(_arrays(50, "float32", (1, 2, 32, 32), (1, 2, 96, 32),
                             (1, 2, 96, 32)), "float32")
    outs = [TR.attention_chunked(q, k, v, block_kv=bk) for bk in (16, 32, 96)]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], atol=1e-5, rtol=1e-5)


def _grads_both(jfn, tfn, arrs, ct_shape, seed):
    """d(sum(out * ct)) with respect to every input, through the reference
    (``jax.grad``) and the port (``torch.autograd``)."""
    (ct,) = _arrays(seed, "float32", ct_shape)
    jargs = [jnp.asarray(a) for a in arrs]
    jg = jax.grad(lambda *a: (jfn(*a) * ct).sum(),
                  argnums=tuple(range(len(arrs))))(*jargs)
    targs = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    (tfn(*targs) * torch.from_numpy(ct)).sum().backward()
    return [np.asarray(g) for g in jg], [t.grad.numpy() for t in targs]


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_gradients_match_reference(causal):
    shapes = [(1, 4, 16, 32), (1, 2, 24, 32), (1, 2, 24, 32)]
    arrs = _arrays(60, "float32", *shapes)
    qoff = 8 if causal else 0
    want, got = _grads_both(
        lambda q, k, v: JK.flash_attention(q, k, v, causal=causal,
                                           q_offset=qoff, impl="interpret",
                                           block_q=8, block_kv=8),
        lambda q, k, v: TK.flash_attention(q, k, v, causal=causal,
                                           q_offset=qoff),
        arrs, shapes[0], 61)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


def test_layernorm_matmul_gradients_match_reference():
    arrs = _arrays(70, "float32", (16, 64), (64, 32), (64,), (64,),
                   scales=[1.0, 1.0, 0.1, 0.1])
    arrs[2] = arrs[2] + 1.0
    want, got = _grads_both(
        lambda *a: JK.layernorm_matmul(*a, impl="interpret", block_m=16,
                                       block_n=16, block_k=32),
        lambda *a: TK.layernorm_matmul(*a), arrs, (16, 32), 71)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


def test_rmsnorm_swiglu_gradients_match_reference():
    arrs = _arrays(80, "float32", (16, 64), (64, 32), (64, 32), (32, 64),
                   (64,), scales=[1.0, 1 / 8, 1 / 8, 1 / 8, 0.1])
    arrs[4] = arrs[4] + 1.0
    want, got = _grads_both(
        lambda *a: JK.rmsnorm_swiglu(*a, impl="interpret", block_m=16,
                                     block_k=16),
        lambda *a: TK.rmsnorm_swiglu(*a), arrs, (16, 64), 81)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


def test_cuda_on_cpu_tensors_runs_the_plain_version_without_a_launch():
    """``impl=None`` is ``"cuda"``; on CPU tensors every wrapper runs its
    kernel's plain version and counts no launch."""
    before = [(m.KERNEL.launches, dict(m.KERNEL.shapes))
              for m in (TFA, TLN, TSW)]
    q, k, v = _torch(_arrays(90, "float32", (1, 2, 8, 32), (1, 1, 8, 32),
                             (1, 1, 8, 32)), "float32")
    torch.testing.assert_close(TK.flash_attention(q, k, v, causal=True),
                               TFA.plain(q, k, v, causal=True))
    x, y = _torch(_arrays(91, "float32", (4, 16), (16, 8)), "float32")
    g, b = torch.ones(16), torch.zeros(16)
    torch.testing.assert_close(TK.layernorm_matmul(x, y, g, b),
                               TLN.plain(x, y, g, b))
    w, u = _torch(_arrays(92, "float32", (16, 8), (8, 16)), "float32")
    torch.testing.assert_close(TK.rmsnorm_swiglu(x, w, w, u, g),
                               TSW.plain(x, w, w, u, g))
    assert [(m.KERNEL.launches, dict(m.KERNEL.shapes))
            for m in (TFA, TLN, TSW)] == before


def test_launcher_counts_accepted_launches_by_shape():
    """A launch the C launcher accepts adds one to ``launches`` and, where
    the wrapper names it, to ``shapes[shape]``; a refused one raises and
    counts nothing.  Each wrapper's ``shape_key`` names the operands'
    shapes, the dtype and (attention) causality."""
    kern = CB.Launcher("// no source", "sym")
    rc = {"value": 0}
    kern._fn = lambda *args: rc["value"]          # loaded: nothing to build
    kern.launch(1, 2, shape="a")
    kern.launch(3)
    kern.launch(shape="a")
    assert kern.launches == 3 and kern.shapes == {"a": 2}
    rc["value"] = 700
    with pytest.raises(RuntimeError, match="cudaError 700"):
        kern.launch(shape="a")
    assert kern.launches == 3 and kern.shapes == {"a": 2}
    q, k = torch.zeros(8, 9, 512, 64), torch.zeros(8, 3, 512, 64)
    assert TFA.shape_key(q, k, True) == (
        "q (8, 9, 512, 64) kv (8, 3, 512, 64) float32 causal")
    assert TFA.shape_key(q.bfloat16(), k, False) == (
        "q (8, 9, 512, 64) kv (8, 3, 512, 64) bfloat16")
    x, w, u = torch.zeros(4096, 576), torch.zeros(576, 1536), torch.zeros(
        1536, 576)
    assert TSW.shape_key(x, w, u) == (
        "x (4096, 576) W/V (576, 1536) U (1536, 576) float32")
    assert TLN.shape_key(x, w) == "x (4096, 576) Y (576, 1536) float32"


def test_layernorm_plain_version_takes_the_one_pass_variance():
    """The LN+matmul kernel's plain version computes the TPU kernel's
    arithmetic (``s2/K - mu^2``), which loses digits that the two-pass
    ``layernorm_matmul_ref`` keeps when the rows' mean dwarfs their
    spread; on centred rows the two agree."""
    x, y = _torch(_arrays(93, "float32", (8, 64), (64, 16)), "float32")
    g, b = torch.ones(64), torch.zeros(64)
    torch.testing.assert_close(TLN.plain(x, y, g, b),
                               TR.layernorm_matmul_ref(x, y, g, b),
                               atol=1e-4, rtol=1e-4)
    shifted = x * 1e-2 + 300.0
    assert not torch.allclose(TLN.plain(shifted, y, g, b),
                              TR.layernorm_matmul_ref(shifted, y, g, b),
                              atol=1e-2, rtol=1e-2)


def test_unknown_impl_raises():
    x = torch.zeros(2, 4)
    with pytest.raises(ValueError, match="impl"):
        TK.layernorm_matmul(x, torch.zeros(4, 2), torch.ones(4),
                            torch.zeros(4), impl="interpret")
    with pytest.raises(ValueError, match="impl"):
        TK.rmsnorm_swiglu(x, torch.zeros(4, 3), torch.zeros(4, 3),
                          torch.zeros(3, 4), torch.ones(4), impl="chunked")
