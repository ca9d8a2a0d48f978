"""The hand-written CUDA kernels on the card (the ``card`` fixture skips
them, with its reason, on a machine without one): the paper's three and
the grouped expert kernel of the MoE layer.  Run them on the card with

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


# -- the grouped expert kernel (kernels/grouped_experts.py) ------------------
# deepseek-v3's held experts: d 7168, expert_ff 2048, 8 held of 256, top-8.
# Float32 throughout, held to the float32 tolerance above (2e-4: FFMA sums
# over 7168 or 2048 terms in another order than cuBLAS's).

DS_D, DS_F, DS_E, DS_HELD, DS_K = 7168, 2048, 256, 8, 8


def _routing(gen, card, t, e=DS_E, k=DS_K):
    """Random top-k ids (k distinct experts a token) and weights."""
    ids = torch.rand(t, e, generator=gen, device=card).topk(k, -1)[1]
    return torch.rand(t, k, generator=gen, device=card), ids


def _held_weights(gen, card, count=DS_HELD, d=DS_D, f=DS_F):
    return {"we_gate": _randn(gen, card, count, d, f, scale=d ** -0.5),
            "we_up": _randn(gen, card, count, d, f, scale=d ** -0.5),
            "we_down": _randn(gen, card, count, f, d, scale=f ** -0.5)}


def _grouped(fn, p, x, w, ids, cap):
    return fn(x, w, ids, p["we_gate"], p["we_up"], p["we_down"], 0, cap)


@pytest.mark.parametrize("t,cap", [(32, 32), (256, 256), (32, 2)],
                         ids=["decode32", "prefill256", "drops"])
def test_grouped_experts_on_card(card, t, cap):
    """At deepseek's widths: the kernel against its plain version (row
    counts, held counts and rows computed equal, the output within the
    float32 tolerance), two calls bit for bit, an expert with no row
    unread (NaN weights change nothing), one launch a call; with a
    capacity under the demand (``drops``), the assignments past it
    dropped as the plain version drops them."""
    from repro_torch.kernels import grouped_experts as GE
    gen = torch.Generator(device=card).manual_seed(31)
    x = _randn(gen, card, t, DS_D)
    w, ids = _routing(gen, card, t)
    ids[ids == 5] = DS_E - 1          # held expert 5 gets no row
    if cap < t:                       # held expert 2 on every token
        ids[ids == 2] = DS_E - 2
        ids[:, 0] = 2
    p = _held_weights(gen, card)
    got = _launched(GE.KERNEL, lambda: _grouped(GE.grouped_moe_cuda, p, x,
                                                w, ids, cap))
    want = _grouped(GE.plain, p, x, w, ids, cap)
    demand = torch.bincount(ids[ids < DS_HELD], minlength=DS_HELD)
    assert got[1][5] == 0 and got[1].sum() > 0
    assert torch.equal(got[1].long(), demand.clamp(max=cap))
    assert (demand > cap).any() == (cap < t)
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    assert int(got[2][t]) == int(got[1].sum())
    torch.testing.assert_close(got[0], want[0], rtol=TOL[torch.float32],
                               atol=TOL[torch.float32])
    again = _grouped(GE.grouped_moe_cuda, p, x, w, ids, cap)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    for name in p:
        p[name][5] = float("nan")
    assert torch.equal(_grouped(GE.grouped_moe_cuda, p, x, w, ids, cap)[0],
                       got[0])


def test_grouped_experts_replay_under_new_routing_on_card(card):
    """The kernel captured once as a CUDA graph at the decode step's 32
    rows: replays under two other routings equal the eager calls on them,
    bit for bit, and each replay follows its own row counts."""
    from repro_torch.kernels import grouped_experts as GE
    gen = torch.Generator(device=card).manual_seed(7)
    t = 32
    p = _held_weights(gen, card)
    static = [_randn(gen, card, t, DS_D), *_routing(gen, card, t)]

    def step(x, w, ids):
        return _grouped(GE.grouped_moe_cuda, p, x, w, ids, t)

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        step(*static)                 # builds and loads the kernel
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, n, counts = step(*static)
    for seed in (1, 2):
        g = torch.Generator(device=card).manual_seed(seed)
        inputs = [_randn(g, card, t, DS_D), *_routing(g, card, t)]
        for dst, src in zip(static, inputs):
            dst.copy_(src)
        before = GE.KERNEL.launches
        graph.replay()
        torch.cuda.synchronize()
        assert GE.KERNEL.launches == before   # a replay calls no wrapper
        want, want_n, want_counts = step(*inputs)
        assert torch.equal(n, want_n) and torch.equal(counts, want_counts)
        assert torch.equal(out, want)
        assert torch.isfinite(out).all() and out.abs().max() > 0


def test_moe_layer_takes_the_grouped_kernel_on_card(card):
    """``moe_apply`` in float32 on the card runs the held experts on the
    kernel (one launch a call; ``assigned`` gets each token's held
    assignments, then the rows the kernel computed) and gives the padded
    products' output; with a gradient required it keeps the padded
    products."""
    from repro_torch.kernels import grouped_experts as GE
    from repro_torch.models import common as CM
    from repro_torch.models import layers as L
    gen = torch.Generator(device=card).manual_seed(11)
    d, f, e = 256, 128, 64
    cfg = CM.ModelConfig(family="moe", d_model=d, n_experts=e, top_k=8,
                         moe_d_ff=f, router_score="sigmoid", router_groups=8,
                         router_groups_kept=4, routed_scale=2.5,
                         capacity_factor=8.0, expert_share=(8, 8),
                         dtype=torch.float32)
    p = _held_weights(gen, card, 8, d, f)
    p["router"] = _randn(gen, card, d, e, scale=0.3)
    p["router_bias"] = _randn(gen, card, e, scale=0.05)
    x = _randn(gen, card, 4, 8, d)
    gamma = torch.ones(d, device=card)
    assigned = []
    got = _launched(GE.KERNEL, lambda: L.moe_apply(p, x, gamma, cfg,
                                                   assigned))
    xn = CM.rms_norm(x, gamma, cfg.norm_eps).reshape(32, d)
    w, ids = L._route(xn, p, cfg)
    want = L._held_experts_out(p, xn, w, ids, L.moe_capacity(32, cfg), 8, 8,
                               e).reshape(got.shape)
    torch.testing.assert_close(got, want, rtol=TOL[torch.float32],
                               atol=TOL[torch.float32])
    held = (ids >= 8) & (ids < 16)
    assert torch.equal(assigned[0][:32], held.sum(-1))
    assert int(assigned[0][32]) == int(held.sum())   # drop-free at cf 8
    trained = {k: v.requires_grad_(True) for k, v in p.items()}
    before = GE.KERNEL.launches
    L.moe_apply(trained, x, gamma, cfg)
    assert GE.KERNEL.launches == before
