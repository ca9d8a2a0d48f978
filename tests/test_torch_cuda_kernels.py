"""The three hand-written CUDA kernels on the card (the ``card`` fixture
skips them, with its reason, on a machine without one).  Run them on the
card with

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py

Each kernel is built by nvcc, launched on CUDA tensors at the sweep shapes
of ``tests/test_kernels.py`` (float32 and bfloat16) and held against its
plain PyTorch version on the same inputs, at that file's tolerances; each
call counts one launch.  This module imports no JAX: the machine with the
card has none.
"""

import pytest
import torch

from repro_torch.core import cuda_build as CB
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import layernorm_matmul as LN
from repro_torch.kernels import ops as K
from repro_torch.kernels import rmsnorm_swiglu as SW
import torch_port  # noqa: F401

TOL = {torch.float32: 2e-4, torch.bfloat16: 5e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card with nvcc (sm_90a)")
    try:
        CB.nvcc_path()
    except RuntimeError as err:
        pytest.skip(str(err))
    return torch.device("cuda")


def _randn(gen, card, *shape, scale=1.0, dtype=torch.float32):
    return (torch.randn(*shape, generator=gen, device=card)
            * scale).to(dtype)


def _launched(kernel, fn):
    before = kernel.launches
    out = fn()
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize(
    "b,hq,hkv,sq,skv,dh,causal",
    [(2, 4, 2, 64, 64, 32, False), (1, 8, 8, 96, 96, 64, True),
     (2, 4, 1, 48, 80, 32, False), (1, 2, 2, 1, 100, 64, True),
     (1, 2, 2, 33, 33, 128, True), (2, 6, 6, 64, 1500, 64, False),
     # the split regimes of launch_shape: whisper decoder self (16-row
     # blocks, 2 ranks), a short last rank, ranks past the causal
     # frontier, head dims 32 and 128 under a split, GQA under a split
     (2, 6, 6, 64, 64, 64, True), (1, 4, 4, 16, 1000, 64, False),
     (2, 9, 3, 128, 128, 64, True), (1, 2, 2, 8, 300, 32, True),
     (1, 2, 2, 8, 300, 128, False), (1, 6, 2, 40, 700, 64, True)])
def test_flash_attention_on_card(card, b, hq, hkv, sq, skv, dh, causal,
                                 dtype):
    gen = torch.Generator(device=card).manual_seed(0)
    q = _randn(gen, card, b, hq, sq, dh, dtype=dtype)
    k = _randn(gen, card, b, hkv, skv, dh, dtype=dtype)
    v = _randn(gen, card, b, hkv, skv, dh, dtype=dtype)
    qoff = skv - sq if causal else 0
    got = _launched(FA.KERNEL, lambda: FA.flash_attention_cuda(
        q, k, v, causal=causal, q_offset=qoff))
    split = FA.launch_shape(b, hq, hkv, sq, skv, dh, dtype).split
    want = FA.plain(q, k, v, causal=causal, q_offset=qoff, split=split)
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("m,k,n", [(64, 128, 96), (100, 256, 64),
                                   (32, 64, 32), (8, 128, 8),
                                   (3000, 384, 1536),
                                   # whisper decoder (128 x 64 blocks, K
                                   # over 6 cluster ranks); rows of X and
                                   # Y not multiples of 16 bytes (the
                                   # narrow copy path), with a K split and
                                   # without one
                                   (128, 384, 1536), (40, 66, 6),
                                   (1500, 66, 1530)])
def test_layernorm_matmul_on_card(card, m, k, n, dtype):
    gen = torch.Generator(device=card).manual_seed(1)
    x = _randn(gen, card, m, k, dtype=dtype)
    y = _randn(gen, card, k, n, dtype=dtype)
    gamma = _randn(gen, card, k, scale=0.1) + 1.0
    beta = _randn(gen, card, k, scale=0.1)
    got = _launched(LN.KERNEL, lambda: LN.layernorm_matmul_cuda(
        x, y, gamma, beta))
    split = LN.launch_shape(m, k, n, dtype).split
    want = LN.plain(x, y, gamma, beta, split=split)
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(),
                               atol=TOL[dtype] * k ** 0.5, rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("m,d,k,n", [(64, 128, 96, 64), (40, 64, 256, 64),
                                     (16, 128, 64, 128),
                                     (2048, 576, 1536, 576),
                                     (20, 72, 70, 1100),
                                     # M not a multiple of 32, D of 16, K
                                     # of 64; N > 1024 at path width
                                     (100, 200, 300, 96),
                                     (33, 576, 1536, 1300),
                                     # the widths of llama3.2-1b, qwen2-7b
                                     # and qwen3-32b (X streamed, not held
                                     # whole); D 2050 not a multiple of 16
                                     # bytes at width
                                     (256, 2048, 8192, 2048),
                                     (256, 3584, 18944, 3584),
                                     (33, 5120, 300, 1300),
                                     (40, 2050, 130, 600),
                                     # float32 streamed, bfloat16 the panel
                                     (64, 1536, 256, 600)])
def test_rmsnorm_swiglu_on_card(card, m, d, k, n, dtype):
    gen = torch.Generator(device=card).manual_seed(2)
    x = _randn(gen, card, m, d, dtype=dtype)
    w = _randn(gen, card, d, k, scale=d ** -0.5, dtype=dtype)
    v = _randn(gen, card, d, k, scale=d ** -0.5, dtype=dtype)
    u = _randn(gen, card, k, n, scale=k ** -0.5, dtype=dtype)
    gamma = _randn(gen, card, d, scale=0.1) + 1.0
    got = _launched(SW.KERNEL, lambda: SW.rmsnorm_swiglu_cuda(
        x, w, v, u, gamma))
    shape = SW.launch_shape(m, d, k, n, dtype)
    want = SW.plain(x, w, v, u, gamma, cluster=shape.cluster,
                    kslice=shape.kslice)
    assert got.dtype == dtype and torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(),
                               atol=2 * TOL[dtype], rtol=2 * TOL[dtype])


def test_backward_through_the_kernels_on_card(card):
    """``kernels.ops``: forward on the kernel, backward by autograd of the
    plain oracle; gradients equal those of the oracle alone."""
    gen = torch.Generator(device=card).manual_seed(3)
    q = _randn(gen, card, 1, 4, 48, 64).requires_grad_(True)
    kv = [_randn(gen, card, 1, 2, 48, 64).requires_grad_(True)
          for _ in range(2)]
    K.flash_attention(q, *kv, causal=True).square().sum().backward()
    got = [t.grad.clone() for t in (q, *kv)]
    for t in (q, *kv):
        t.grad = None
    K.flash_attention(q, *kv, causal=True,
                      impl="ref").square().sum().backward()
    for g, t in zip(got, (q, *kv)):
        torch.testing.assert_close(g, t.grad, atol=1e-4, rtol=1e-4)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    q = torch.zeros(1, 2, 8, 64, device=card)
    with pytest.raises(TypeError, match="static int"):
        FA.flash_attention_cuda(q, q, q, causal=True,
                                q_offset=torch.tensor(3, device=card))
    odd = torch.zeros(1, 2, 8, 48, device=card)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention_cuda(odd, odd, odd)
    with pytest.raises(ValueError, match="inputs on"):
        FA.flash_attention_cuda(q, q.cpu(), q)
    # any D fits in shared memory now; mixed operand types do not launch
    x = torch.zeros(4, 4000, device=card)
    w = torch.zeros(4000, 8, device=card)
    with pytest.raises(ValueError, match="dtypes"):
        SW.rmsnorm_swiglu_cuda(x, w.bfloat16(), w,
                               torch.zeros(8, 4, device=card),
                               torch.ones(4000, device=card))
