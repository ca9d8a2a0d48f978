"""The CUDA emitter (``repro_torch.core.codegen_cuda``) at the full
smollm-135m widths of the serving path, without nvcc and without a card.

* its ``LoweringReport`` equals the reference Pallas emitter's for the
  two main-path programs at every engine shape;
* it writes CUDA source for every kernel (one ``__global__`` per region
  group, tile templates from ``csrc/tiles.cuh``, the coalesced product
  ``tiles::dot_k`` for every tile product, shared memory inside the H100
  block limit);
* chaining the kernels' plain versions by ``KernelRun`` gives the
  whole-program output (``rtol = atol = 1e-5``);
* a kernel called on CPU tensors runs its plain version and counts no
  launch, and on tensors of any other non-CUDA device it raises.
"""

import numpy as np
import pytest
import torch

from repro import pipeline as JP
from repro.core import array_program as JAP
from repro_torch import pipeline as TP
from repro_torch.core import array_program as TAP
from repro_torch.core import codegen_cuda as CC
from repro_torch.core import ops as O
from repro_torch.models.layers import _pipeline_dims_blocks
import torch_port  # noqa: F401

# smollm-135m: d_model 576, 9 query heads over 3 KV heads, d_head 64,
# d_ff 1536; engine buckets 8/16/32, max_len 96, max_batch 4
D, DH, DFF, GROUP, MAX_LEN = 576, 64, 1536, 3, 96


def _attention(s, sk):
    dims, blocks = _pipeline_dims_blocks({"M": s, "D": DH, "N": sk, "L": DH})
    dims["H"], blocks["H"] = GROUP, 1
    return (lambda A: A.gqa_attention_program(0.125, causal=True), dims,
            blocks)


def _swiglu(t):
    dims, blocks = _pipeline_dims_blocks({"M": t, "D": D, "K": DFF, "N": D})
    return (lambda A: A.rmsnorm_ffn_swiglu_program(float(D), eps=1e-6),
            dims, blocks)


SHAPES = {
    "attention_prefill8": _attention(8, 8),
    "attention_prefill32": _attention(32, 32),
    "attention_decode": _attention(1, MAX_LEN),
    "swiglu_prefill32": _swiglu(32),
    "swiglu_decode": _swiglu(4),
}


def _port(name):
    build, dims, blocks = SHAPES[name]
    return TP.compile(build(TAP), dims, options=TP.CompileOptions(
        backend="cuda", blocks=blocks))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_report_equals_reference_at_full_width(name, tmp_path):
    build, dims, blocks = SHAPES[name]
    ref = JP.compile(build(JAP), dims, options=JP.CompileOptions(
        backend="pallas", blocks=blocks), cache=JP.KernelCache(tmp_path))
    port = _port(name)
    assert port.lowering_report.summary() == ref.lowering_report.summary()
    assert ref.lowering_report.fallbacks == 0


def test_full_width_swiglu_lowers_to_group_and_region():
    """At full width the SwiGLU program is two kernels: the RMS statistic
    and gate/up projections as one ``emit_group`` megakernel, the down
    projection as one ``emit_region`` kernel.  Each lies on 72 blocks of
    the card: g0 on its 12 lifted K cells times a cluster of 6 splitting
    D, g1 on its 6 N cells times a cluster of 12 splitting K."""
    kern = _port("swiglu_decode")
    assert [k.entry for k in kern.kernels] == ["emit_group", "emit_region"]
    assert kern.lowering_report.resident_edges == 1
    assert [k.blocks for k in kern.kernels] == [72, 72]
    assert [k.plan.cluster_size for k in kern.kernels] == [6, 12]


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_cuda_source_for_every_kernel(name):
    kern = _port(name)
    assert kern.kernels
    for k in kern.kernels:
        assert isinstance(k, CC.CudaKernel)
        src = k.source
        assert '#include "tiles.cuh"' in src
        assert "__global__" in src and 'extern "C" int launch(' in src
        # every product of the serving path is contiguous along k: the
        # tensor-core K loop or the staged CUDA-core product, never
        # tiles::dot
        summed = "tiles::dot_k_sum<" in src
        assert summed or "tiles::dot_k<" in src
        assert "tiles::dot<" not in src
        assert k.product_path == (CC.TENSOR_PATH if summed and
                                  "tiles::dot_k<" not in src
                                  else CC.FMA_PATH)
        assert f"// product path: {k.product_path} (" in src
        assert src.count("{") == src.count("}")
        assert 0 < k.smem_bytes <= CC.SMEM_LIMIT
        assert k.flops > 0


def _qwen2_7b(name):
    """A qwen2-7b serving program as the model layers compile it on the
    ``cuda`` backend: ``swiglu<t>`` over t token rows, ``attention_decode``
    of one query row over 1024 positions (the benchmark cell's
    ``max_len``), ``attention_prefill32``."""
    from repro_torch import configs as C
    from repro_torch.models import layers as L
    cfg = C.get_config("qwen2-7b")
    opts = L._pipeline_options("cuda")
    if name.startswith("swiglu"):
        return L.swiglu_kernel(int(name[len("swiglu"):]), cfg.d_model,
                               cfg.d_ff, float(cfg.norm_eps), opts, "cuda")
    s, sk = (1, 1024) if name == "attention_decode" else (32, 32)
    return L.attention_kernel(s, cfg.d_head, sk, cfg.d_head,
                              cfg.n_heads // cfg.n_kv_heads, True,
                              cfg.d_head ** -0.5, opts, "cuda")


@pytest.mark.parametrize("name,paths", [
    ("swiglu32", [CC.FMA_PATH, CC.TENSOR_PATH, CC.TENSOR_PATH]),
    ("swiglu64", [CC.FMA_PATH, CC.TENSOR_PATH, CC.TENSOR_PATH]),
    ("swiglu4", [CC.FMA_PATH] * 3),
    ("swiglu8", [CC.FMA_PATH] * 3),
    ("attention_decode", [CC.FMA_PATH]),
    ("attention_prefill32", [CC.FMA_PATH]),
])
def test_product_path_by_shape(name, paths):
    """At qwen2-7b's widths the gate/up g1 and the down projection g2
    take ``tiles::dot_k_sum`` from 16 rows on (the cell's 32 decode rows
    and its 32- and 64-row prefill blocks); at 4 and 8 rows, and in
    attention (coupled online-softmax carries), every product stays
    ``tiles::dot_k``; g0 has none.  Each source states its path."""
    kern = _qwen2_7b(name)
    assert [k.product_path for k in kern.kernels] == paths
    for k in kern.kernels:
        src = k.source
        assert f"// product path: {k.product_path} (" in src
        assert 0 < k.smem_bytes <= CC.SMEM_LIMIT
        if k.product_path == CC.TENSOR_PATH:
            assert "tiles::dot_k_sum<" in src and "tiles::dot_k<" not in src
        else:
            assert "tiles::dot_k_sum<" not in src
            assert ("tiles::dot_k<" in src) == (k.gid != "g0:22"), k.gid
        assert "tiles::dot<" not in src


def _tf32(a):
    """float32 rounded to TF32 as ``mma::tf32`` does (ties away)."""
    u = a.view(np.uint32).astype(np.uint64)
    return ((u + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def _toward_zero(v):
    """float64 to float32, rounded toward zero."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


@pytest.mark.parametrize("k", [3584, 8192, 18944])
def test_tensor_core_sums_keep_float32_accuracy(k):
    """``tiles::dot_k_sum``'s arithmetic emulated as the tensor cores do
    it (exact products of TF32 operands, each ``mma`` sum rounded toward
    zero to float32) at qwen2-7b's and jamba's contraction lengths: 3xTF32
    with each k8's three products summed in a fresh fragment and added in
    float32 stays within 2e-5 of float64, while summing them straight into
    the running fragment drifts toward zero by about an ulp of the sum per
    ``mma`` (1.6e-3 on the card at jamba's gate/up before the fresh
    fragment: over the kernels' 2e-4)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, k)).astype(np.float32)
    w = (rng.standard_normal((32, k)) * k ** -0.5).astype(np.float32)
    xh, wh = _tf32(x), _tf32(w)
    xl, wl = _tf32(x - xh), _tf32(w - wh)
    pairs = ((xl, wh), (xh, wl), (xh, wh))
    direct = np.zeros((16, 32), np.float32)
    fresh = np.zeros((16, 32), np.float32)
    for k0 in range(0, k, 8):
        t = np.zeros((16, 32), np.float32)
        for a, b in pairs:
            p = a[:, k0:k0 + 8].astype(np.float64) @ b[:, k0:k0 + 8].T
            direct = _toward_zero(direct + p)
            t = _toward_zero(t + p)
        fresh = fresh + t
    want = x.astype(np.float64) @ w.astype(np.float64).T
    err = np.abs(fresh - want).max()
    assert err < 2e-5
    assert np.abs(direct - want).max() > 5 * err


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_plain_runners_chain_to_the_whole_program(name):
    build, dims, blocks = SHAPES[name]
    kern = _port(name)
    plain = TP.compile(build(TAP), dims, options=TP.CompileOptions(
        backend="torch", blocks=blocks))
    rng = np.random.default_rng(0)
    feed = {}
    for iid in kern.graph.input_ids:
        node = kern.graph.nodes[iid]
        if node.name in ("QP", "KP"):
            n = (dims["M"] * blocks["M"] if node.name == "QP"
                 else dims["N"] * blocks["N"])
            feed[node.name] = torch.arange(n, dtype=torch.float32)
            continue
        from repro_torch.core.blocks import merged_shape
        shape = merged_shape(node.vtype, tuple(
            blocks[d] for d in node.vtype.dims[node.vtype.lead_dims:]), dims)
        feed[node.name] = torch.tensor(rng.normal(size=shape),
                                       dtype=torch.float32)
    raw = kern._fn.raw_program
    env = dict(zip(raw.input_refs, [feed[n] for n in kern.in_names]))
    for kr, k in raw.region_runners:
        for ref, out in zip(kr.out_refs,
                            k.plain(*[env[r] for r in kr.in_refs])):
            env[ref] = out
    got = env[raw.region_runners[-1][0].out_refs[0]]
    want = plain(feed)[plain.out_names[0]]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert all(k.launches == 0 for k in kern.kernels)


def test_kernel_takes_plain_version_only_on_cpu():
    kern = _port("attention_decode").kernels[0]
    cpu = [torch.zeros(s) for s in kern.in_full]
    before = kern.launches
    outs = kern(*cpu)
    assert [tuple(o.shape) for o in outs] == kern.out_full
    assert kern.launches == before          # no launch: the plain version
    meta = [torch.zeros(s, device="meta") for s in kern.in_full]
    with pytest.raises(ValueError, match="CUDA tensors only"):
        kern(*meta)


@pytest.mark.parametrize("expr,consts,args,want", [
    ("exp(a0)", {}, [0.5], np.exp(0.5)),
    ("1/sqrt(a0/DD + 1e-06)", {"DD": 576.0}, [3.0],
     1 / np.sqrt(3 / 576 + 1e-6)),
    ("(a0/KK - a1*a1)**(-0.5)", {"KK": 4.0}, [8.0, 1.0], 1.0),
    ("a0/(1+exp(-a0))*a1", {}, [1.5, 2.0], 1.5 / (1 + np.exp(-1.5)) * 2),
    ("maximum(a0, 0.0) + minimum(a1, -1) * abs(a0)", {}, [-2.0, 0.5],
     0.0 - 1 * 2.0),
    ("tanh(a1) - log(a1) + pi", {}, [-2.0, 0.5],
     np.tanh(0.5) - np.log(0.5) + np.pi),
])
def test_elementwise_translation(expr, consts, args, want):
    """The emitter's C expression, evaluated by Python with C's function
    names bound to numpy, equals the op's own value."""
    import re
    op = O.Elementwise(expr, len(args), consts)
    py = re.sub(r"(\d)f\b", r"\1", CC.expr_to_c(op))
    env = {f"x{i}": np.float32(a) for i, a in enumerate(args)}
    env.update(expf=np.exp, logf=np.log, sqrtf=np.sqrt, fmaxf=np.maximum,
               fminf=np.minimum, fabsf=np.abs, tanhf=np.tanh,
               powf=np.power)
    got = eval(py, {}, env)  # noqa: S307
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(op.apply(np, *args), want, rtol=1e-5)


def test_elementwise_translation_of_where_and_sign():
    op = O.Elementwise("where(a0 > a1, sign(a0), a1)", 2, {})
    assert CC.expr_to_c(op) == (
        "((x0 > x1 ? 1.0f : 0.0f) != 0.0f ? tiles::sign(x0) : x1)")
    with pytest.raises(CC.RegionError):
        CC.expr_to_c(O.Elementwise("a0 % 2", 1, {}))
