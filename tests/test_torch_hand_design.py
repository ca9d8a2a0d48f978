"""The Hopper design of the hand flash-attention, RMSNorm+SwiGLU and
LayerNorm+matmul kernels, checked on the CPU.

* The plain versions follow the kernels' splits (the key axis over
  cluster ranks for attention, d_ff for SwiGLU, K for LayerNorm+matmul)
  and are held against the JAX reference's Pallas kernels in interpret
  mode at the kernels' tolerances (2e-4 attention, 4e-4 SwiGLU, 2e-4 *
  sqrt(K) LayerNorm+matmul), for split counts 1, 2, 3 and 8 (1 to 8 for
  LayerNorm+matmul), an uneven last split, an empty last rank, ranks past
  the causal frontier, GQA and one query row.
* A numpy emulation of 3xTF32 (TF32 rounding through the int32 view, the
  tensor cores' cut of the small part, three products a step summed in
  float32) of attention, SwiGLU and LayerNorm+matmul at the paths' widths
  stays within a tenth of the card tolerances of the float64 result, and
  more than ten times closer than one TF32 pass (which misses SwiGLU's
  4e-4).  LayerNorm+matmul's bfloat16 scheme (two passes over hi and lo
  of the float32 gamma * Y) likewise; on rows whose mean dwarfs their
  spread, where ``acc - mu * colsum(gamma Y)`` cancels, 3xTF32 keeps
  float32's digits and one pass loses them.
* The reference's side runs on jax's CPU device at ``highest`` matmul
  precision (``reference_cpu``), so the file passes on a machine where
  jax also sees a GPU.
* ``launch_shape`` fills the card at the whisper decoder-self and cross
  shapes (attention) and at both of path B's LayerNorm+matmul shapes, and
  keeps every path shape within the cluster, grid and shared-memory
  limits.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JK
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import layernorm_matmul as LN
from repro_torch.kernels import rmsnorm_swiglu as SW
from repro_torch.launch import hand_variants as HV
from reference_cpu import reference_on_cpu  # noqa: E402, F401
import torch_port  # noqa: F401

ATTN_TOL, SWIGLU_TOL, LN_TOL, BF16_TOL = 2e-4, 4e-4, 2e-4, 5e-2

# (b, hq, hkv, sq, skv, dh, causal, q_offset)
ATTN = {
    "gqa-causal-uneven": (1, 4, 2, 40, 200, 32, True, 160),
    "cross": (2, 3, 3, 16, 150, 64, False, 0),
    "ranks-past-frontier": (1, 2, 2, 8, 64, 64, True, 0),
    "one-query-row": (1, 2, 2, 1, 100, 64, True, 99),
}


def _normal(seed, *shapes, scales=None):
    rng = np.random.default_rng(seed)
    scales = scales or [1.0] * len(shapes)
    return [(rng.normal(size=s) * c).astype(np.float32)
            for s, c in zip(shapes, scales)]


@functools.lru_cache(maxsize=None)
def _attn_case(name):
    b, hq, hkv, sq, skv, dh, causal, qoff = ATTN[name]
    q, k, v = _normal(len(name), (b, hq, sq, dh), (b, hkv, skv, dh),
                      (b, hkv, skv, dh))
    want = JK.flash_attention(jnp.asarray(q), jnp.asarray(k),
                              jnp.asarray(v), causal=causal, q_offset=qoff,
                              impl="interpret", block_q=32, block_kv=32)
    return (q, k, v), np.asarray(want)


@pytest.mark.parametrize("split", [1, 2, 3, 8])
@pytest.mark.parametrize("name", list(ATTN))
def test_split_flash_plain_matches_reference(name, split):
    """Each rank's online softmax over 64-key tiles, combined in rank
    order, is the reference's attention (an empty rank or a rank past the
    causal frontier adds exactly nothing)."""
    (q, k, v), want = _attn_case(name)
    _, _, _, _, skv, _, causal, qoff = ATTN[name]
    got = FA.plain(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                   q_offset=qoff, split=split)
    np.testing.assert_allclose(got.numpy(), want, atol=ATTN_TOL,
                               rtol=ATTN_TOL)


def test_split_flash_plain_keeps_the_exact_zero_partial():
    """Rows that see no key of a rank: its carry is (NEG_INF, 0, 0) when
    it has no keys at all, and its weight in the combine is exactly 0, so
    a split leaves the unsplit result's digits nearly untouched."""
    (q, k, v), _ = _attn_case("ranks-past-frontier")
    t = [torch.from_numpy(a) for a in (q, k, v)]
    one = FA.plain(*t, causal=True, split=1)
    four = FA.plain(*t, causal=True, split=4)   # ranks 1-3 see no key
    torch.testing.assert_close(four, one, atol=1e-6, rtol=1e-6)
    m, l, acc = FA.R.attention_partial(t[0], t[1][:, :, :0], t[2][:, :, :0],
                                       k_start=64, block_kv=64)
    assert (m == FA.R.NEG_INF).all() and (l == 0).all() and (acc == 0).all()


@functools.lru_cache(maxsize=None)
def _swiglu_case():
    m, d, k, n = 40, 64, 256, 64
    x, w, v, u, g = _normal(7, (m, d), (d, k), (d, k), (k, n), (d,),
                            scales=[1.0, d ** -0.5, d ** -0.5, k ** -0.5,
                                    0.1])
    g = g + 1.0
    want = JK.rmsnorm_swiglu(*(jnp.asarray(a) for a in (x, w, v, u, g)),
                             impl="interpret", block_m=8, block_k=64)
    return (x, w, v, u, g), np.asarray(want)


@pytest.mark.parametrize("cluster,kslice", [(1, 256), (2, 128), (3, 128),
                                            (4, 64)])
def test_split_swiglu_plain_matches_reference(cluster, kslice):
    """Partial outputs over d_ff slices, summed in rank order (3 ranks of
    128: the last one empty), are the reference's SwiGLU."""
    arrs, want = _swiglu_case()
    got = SW.plain(*(torch.from_numpy(a) for a in arrs), cluster=cluster,
                   kslice=kslice)
    np.testing.assert_allclose(got.numpy(), want, atol=SWIGLU_TOL,
                               rtol=SWIGLU_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("d", [576, 864, 2048, 3584, 5120])
def test_swiglu_shared_memory_fits_at_every_model_width(d, dtype):
    """The normalised rows stay on chip where they fit (smollm-135m, the
    float32 cap); wider, X is streamed and a block's shared memory does
    not grow with D (llama3.2-1b, qwen2-7b, qwen3-32b)."""
    shape = SW.launch_shape(2048, d, 4 * d, d, dtype)
    assert shape.smem <= SW.SMEM_LIMIT
    assert shape.panel == (d <= (864 if dtype == torch.float32 else 1728))
    if not shape.panel:
        assert shape.smem == SW.smem_bytes(10 ** 6, dtype)


def test_swiglu_plain_with_the_kernel_split_matches_reference_at_d2048():
    """llama3.2-1b's widths (D 2048, d_ff 8192, N 2048) on 64 rows: the
    launch splits d_ff over 8 ranks, and the split plain version is the
    reference's ``rmsnorm_swiglu(impl="ref")``."""
    m, d, k, n = 64, 2048, 8192, 2048
    x, w, v, u, g = _normal(13, (m, d), (d, k), (d, k), (k, n), (d,),
                            scales=[1.0, d ** -0.5, d ** -0.5, k ** -0.5,
                                    0.1])
    g = g + 1.0
    shape = SW.launch_shape(m, d, k, n, torch.float32)
    assert shape.cluster == 8
    want = JK.rmsnorm_swiglu(*(jnp.asarray(a) for a in (x, w, v, u, g)),
                             impl="ref")
    got = SW.plain(*(torch.from_numpy(a) for a in (x, w, v, u, g)),
                   cluster=shape.cluster, kslice=shape.kslice)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=SWIGLU_TOL, rtol=SWIGLU_TOL)


@functools.lru_cache(maxsize=None)
def _ln_case():
    m, k, n = 40, 256, 48
    x, y, g, b = _normal(8, (m, k), (k, n), (k,), (k,),
                         scales=[1.0, 1.0, 0.1, 0.1])
    g = g + 1.0
    want = JK.layernorm_matmul(*(jnp.asarray(a) for a in (x, y, g, b)),
                               impl="interpret", block_m=8, block_n=16,
                               block_k=64)
    return (x, y, g, b), np.asarray(want)


@pytest.mark.parametrize("split", range(1, LN.MAX_SPLIT + 1))
def test_split_layernorm_matmul_plain_matches_reference(split):
    """Partial products and statistics over K slices of 32-column steps,
    summed in rank order (3, 5, 6 and 7 ranks take uneven or fewer
    slices), are the reference's LayerNorm+matmul."""
    arrs, want = _ln_case()
    got = LN.plain(*(torch.from_numpy(a) for a in arrs), split=split)
    k = arrs[0].shape[1]
    np.testing.assert_allclose(got.numpy(), want, atol=LN_TOL * k ** 0.5,
                               rtol=LN_TOL)


def test_cpu_layernorm_matmul_runs_the_plain_version_with_the_split():
    x, y, g, b = (torch.from_numpy(a) for a in _normal(
        5, (128, 384), (384, 1536), (384,), (384,)))
    split = LN.launch_shape(128, 384, 1536, torch.float32).split
    assert split == 6
    torch.testing.assert_close(LN.layernorm_matmul_cuda(x, y, g, b),
                               LN.plain(x, y, g, b, split=split), atol=0,
                               rtol=0)


def test_cpu_wrappers_run_the_plain_version_with_the_kernels_split():
    q, k, v = (torch.from_numpy(a) for a in _normal(
        3, (2, 6, 64, 64), (2, 6, 1500, 64), (2, 6, 1500, 64)))
    split = FA.launch_shape(2, 6, 6, 64, 1500, 64, torch.float32).split
    assert split == 8
    torch.testing.assert_close(FA.flash_attention_cuda(q, k, v),
                               FA.plain(q, k, v, split=split), atol=0,
                               rtol=0)
    x, w, v2, u, g = (torch.from_numpy(a) for a in _normal(
        4, (64, 64), (64, 256), (64, 256), (256, 32), (64,)))
    shape = SW.launch_shape(64, 64, 256, 32, torch.float32)
    assert shape.cluster > 1
    torch.testing.assert_close(
        SW.rmsnorm_swiglu_cuda(x, w, v2, u, g),
        SW.plain(x, w, v2, u, g, cluster=shape.cluster,
                 kslice=shape.kslice), atol=0, rtol=0)


# -- 3xTF32, emulated ---------------------------------------------------------

def _tf32(a: np.ndarray) -> np.ndarray:
    """Round float32 to TF32 (10-bit mantissa, nearest, ties away) through
    the int32 view, as ``mma.cuh``'s ``tf32`` does."""
    bits = a.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(
        np.float32)


def _cut(a: np.ndarray) -> np.ndarray:
    """The tensor cores' reading of a float32 as TF32: its top 19 bits."""
    return (a.astype(np.float32).view(np.uint32)
            & np.uint32(0xffffe000)).view(np.float32)


def _mm(a: np.ndarray, b: np.ndarray, passes: int) -> np.ndarray:
    """a (R, K) @ b (K, C) as the kernels' mma.sync m16n8k8 steps do it:
    for each 8-deep step the products (3xTF32: al bh, ah bl, ah bh; one
    pass: ah bh), each step's sum added to a float32 accumulator."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _cut(a - ah), _cut(b - bh)
    terms = [(ah, bh)] if passes == 1 else [(al, bh), (ah, bl), (ah, bh)]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for x, y in terms:
            step = x[:, k0:k0 + 8].astype(np.float64) @ \
                y[k0:k0 + 8].astype(np.float64)
            acc = (acc + step.astype(np.float32)).astype(np.float32)
    return acc


def _attention_rows(q, k, v, mm):
    s = mm(q, k.T) / np.float32(np.sqrt(q.shape[1]))
    p = np.exp(s - s.max(1, keepdims=True)).astype(np.float32)
    return mm(p, v) / p.sum(1, keepdims=True)


def _swiglu_rows(x, w, v, u, mm):
    xn = (x / np.sqrt((x * x).mean(1, keepdims=True) + 1e-6)).astype(
        np.float32)
    a, b = mm(xn, w), mm(xn, v)
    h = (a / (1.0 + np.exp(-a)) * b).astype(np.float32)
    return mm(h, u)


def _exact(a, b):
    return a.astype(np.float64) @ b.astype(np.float64)


@pytest.mark.parametrize("skv", [512, 1500])
def test_3xtf32_attention_meets_the_float32_tolerance(skv):
    """Attention rows at Dh = 64 over smollm's 512 and whisper's 1500
    keys: 3xTF32 within a tenth of 2e-4 of float64, and more than ten
    times closer than one TF32 pass."""
    q, k, v = _normal(11, (4, 64), (skv, 64), (skv, 64))
    want = _attention_rows(q.astype(np.float64), k, v, _exact)
    three = _attention_rows(q, k, v, functools.partial(_mm, passes=3))
    one = _attention_rows(q, k, v, functools.partial(_mm, passes=1))
    err3, err1 = np.abs(three - want).max(), np.abs(one - want).max()
    assert err3 < ATTN_TOL / 10
    assert err1 > 10 * err3


def test_3xtf32_swiglu_meets_the_float32_tolerance():
    """SwiGLU rows at smollm-135m's widths (D 576, d_ff 1536, N 576):
    3xTF32 within a tenth of 4e-4 of float64; one TF32 pass misses 4e-4."""
    d, k, n = 576, 1536, 576
    x, w, v, u = _normal(12, (3, d), (d, k), (d, k), (k, n),
                         scales=[1.0, d ** -0.5, d ** -0.5, k ** -0.5])
    want = _swiglu_rows(x.astype(np.float64), w, v, u, _exact)
    three = _swiglu_rows(x, w, v, u, functools.partial(_mm, passes=3))
    one = _swiglu_rows(x, w, v, u, functools.partial(_mm, passes=1))
    err3, err1 = np.abs(three - want).max(), np.abs(one - want).max()
    assert err3 < SWIGLU_TOL / 10
    assert err1 > SWIGLU_TOL


def _bf16(a: np.ndarray) -> np.ndarray:
    """Round float32 to bfloat16 (nearest, ties to even) through the
    uint32 view, as ``__floats2bfloat162_rn`` does."""
    bits = a.astype(np.float32).view(np.uint32)
    bits = bits + np.uint32(0x7fff) + ((bits >> 16) & np.uint32(1))
    return (bits & np.uint32(0xffff0000)).view(np.float32)


def _mm_bf16(a: np.ndarray, b: np.ndarray, passes: int) -> np.ndarray:
    """a (R, K) @ b (K, C), a exact in bfloat16 and b float32, as the
    LayerNorm+matmul kernel's m16n8k16 steps do it: b split into hi =
    bf16(b) and lo = bf16(b - hi); for each 16-deep step a lo then a hi
    (two passes; one pass: a hi alone), each step's sum added to a
    float32 accumulator."""
    hi = _bf16(b)
    lo = _bf16(b - hi)
    terms = [(a, hi)] if passes == 1 else [(a, lo), (a, hi)]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k0 in range(0, a.shape[1], 16):
        for x, y in terms:
            step = x[:, k0:k0 + 16].astype(np.float64) @ \
                y[k0:k0 + 16].astype(np.float64)
            acc = (acc + step.astype(np.float32)).astype(np.float32)
    return acc


def _ln_numerator(x, y, g, mm):
    """The kernel's acc - mu * colsum(gamma Y), its products by ``mm``."""
    yg = (g[:, None] * y).astype(y.dtype)
    return mm(x, yg) - x.sum(1, keepdims=True) / x.shape[1] * yg.sum(0)


def _ln_fold(x, y, g, b, mm, eps=1e-5):
    """The kernel's fold, its products by ``mm``: Z."""
    k = x.shape[1]
    mu = x.sum(1, keepdims=True) / k
    var = (x * x).sum(1, keepdims=True) / k - mu * mu
    return _ln_numerator(x, y, g, mm) / np.sqrt(var + eps) + b @ y


def _ln_operands(shifted: bool):
    """Four rows at path B's widths (K 384, N 1536); shifted: the rows of
    tests/test_torch_kernels.py's one-pass variance test, x * 1e-2 + 300,
    whose mean dwarfs their spread."""
    x, y, g, b = _normal(21, (4, 384), (384, 1536), (384,), (384,),
                         scales=[1.0, 1.0, 0.1, 0.1])
    if shifted:
        x = (x * 1e-2 + 300.0).astype(np.float32)
    return x, y, (g + 1.0).astype(np.float32), b


def test_3xtf32_layernorm_matmul_meets_the_float32_tolerance():
    """Path B's widths: 3xTF32 within a tenth of 2e-4 * sqrt(K) of
    float64, and more than ten times closer than one TF32 pass."""
    x, y, g, b = _ln_operands(shifted=False)
    want = _ln_fold(*(a.astype(np.float64) for a in (x, y, g, b)), _exact)
    three = _ln_fold(x, y, g, b, functools.partial(_mm, passes=3))
    one = _ln_fold(x, y, g, b, functools.partial(_mm, passes=1))
    err3, err1 = np.abs(three - want).max(), np.abs(one - want).max()
    assert err3 < LN_TOL * 384 ** 0.5 / 10
    assert err1 > 10 * err3


def test_bf16_two_pass_layernorm_matmul_meets_the_bf16_tolerance():
    """bfloat16 X and Y at path B's widths, gamma * Y in float32 as the
    reference multiplies it: two bfloat16 passes (hi, lo of gamma Y)
    within a hundredth of 5e-2 of float64, more than a hundred times
    closer than one pass over bf16(gamma Y)."""
    x, y, g, b = (_bf16(a) if i < 2 else a
                  for i, a in enumerate(_ln_operands(shifted=False)))
    want = _ln_fold(*(a.astype(np.float64) for a in (x, y, g, b)), _exact)
    two = _ln_fold(x, y, g, b, functools.partial(_mm_bf16, passes=2))
    one = _ln_fold(x, y, g, b, functools.partial(_mm_bf16, passes=1))
    err2, err1 = np.abs(two - want).max(), np.abs(one - want).max()
    assert err2 < BF16_TOL / 100
    assert err1 > 100 * err2


def test_shifted_rows_keep_the_cancelling_numerator():
    """Rows x * 1e-2 + 300: acc and mu * colsum(gamma Y) agree in all but
    their last digits.  The one-pass variance makes Z itself noise there
    in float32, in the plain version as in the kernel, so the numerator
    is what the products must keep: 3xTF32 within 1.5 times a float32
    product's error, one TF32 pass over a hundred times worse; bfloat16
    inputs, two passes within 5 times that error (the dropped lo * lo
    term, 2^-17 of each), one pass over a hundred times worse than two."""
    x, y, g, _ = _ln_operands(shifted=True)

    def num(xx, yy, mm):
        return _ln_numerator(xx, yy, g, mm)

    def f32(a, c):
        return (a @ c).astype(np.float32)

    want = num(x.astype(np.float64), y.astype(np.float64), _exact)
    err = {p: np.abs(num(x, y, functools.partial(_mm, passes=p))
                     - want).max() for p in (1, 3)}
    err_f32 = np.abs(num(x, y, f32) - want).max()
    assert err[3] < 1.5 * err_f32
    assert err[1] > 100 * err_f32
    xb, yb = _bf16(x), _bf16(y)
    want = num(xb.astype(np.float64), yb.astype(np.float64), _exact)
    errb = {p: np.abs(num(xb, yb, functools.partial(_mm_bf16, passes=p))
                      - want).max() for p in (1, 2)}
    errb_f32 = np.abs(num(xb, yb, f32) - want).max()
    assert errb[2] < 5 * errb_f32
    assert errb[1] > 100 * errb[2]


def test_tf32_rounding_matches_its_definition():
    x = np.array([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                  -(1.0 + 2 ** -11), 3.0e-7], np.float32)
    got = _tf32(x)
    assert got[0] == 1.0
    assert got[1] == 1.0 + 2 ** -10            # half away from zero
    assert got[2] == 1.0 + 2 ** -9
    assert got[3] == -(1.0 + 2 ** -10)
    assert (got.view(np.uint32) & 0x1fff == 0).all()
    lo = x - got
    assert (got.astype(np.float64) + lo == x).all()     # the split is exact


# -- launch shapes ------------------------------------------------------------

PATH_ATTN = {  # (b, hq, hkv, sq, skv, dh) of paths A and B
    "smollm prefill": (4, 9, 3, 512, 512, 64),
    "whisper encoder": (2, 6, 6, 1500, 1500, 64),
    "whisper decoder self": (2, 6, 6, 64, 64, 64),
    "whisper cross": (2, 6, 6, 64, 1500, 64),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("name", ["whisper decoder self", "whisper cross"])
def test_launch_shape_fills_the_card_at_the_short_whisper_shapes(name,
                                                                 dtype):
    shape = FA.launch_shape(*PATH_ATTN[name], dtype)
    assert shape.blocks >= 96
    assert shape.split > 1
    assert shape.grid == (shape.split, *shape.grid[1:])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("name", list(PATH_ATTN))
def test_launch_shape_keeps_path_shapes_within_limits(name, dtype):
    b, hq, hkv, sq, skv, dh = PATH_ATTN[name]
    shape = FA.launch_shape(b, hq, hkv, sq, skv, dh, dtype)
    assert 1 <= shape.split <= FA.MAX_SPLIT
    assert shape.smem <= FA.SMEM_LIMIT
    assert shape.bq in (16, 64) and shape.threads == 2 * shape.bq
    assert shape.chunk % 16 == 0
    assert (shape.split - 1) * shape.chunk < skv <= shape.split * shape.chunk
    sw = SW.launch_shape(2048, 576, 1536, 576, dtype)
    assert 1 <= sw.cluster <= SW.MAX_CLUSTER and sw.smem <= SW.SMEM_LIMIT
    assert sw.blocks <= SW.SMS
    assert sw.kslice % SW.BKF == 0
    assert (sw.cluster - 1) * sw.kslice < 1536 <= sw.cluster * sw.kslice


def test_launch_shape_splits_every_key_axis_without_empty_ranks():
    for skv in (1, 15, 16, 17, 64, 65, 100, 300, 1000, 1500, 4096):
        for sq in (1, 16, 64, 200):
            for heads in (1, 6, 36):
                s = FA.launch_shape(1, heads, 1, sq, skv, 64, torch.float32)
                assert (s.split - 1) * s.chunk < skv <= s.split * s.chunk
                assert s.split == 1 or s.blocks <= 8 * FA.SMS


PATH_LN = {  # (m, k, n) of path B
    "whisper encoder": (3000, 384, 1536),
    "whisper decoder": (128, 384, 1536),
}


def _ln_limits(shape, m, k, n):
    assert 1 <= shape.split <= LN.MAX_SPLIT
    assert shape.kslice % LN.BK == 0
    assert (shape.split - 1) * shape.kslice < k <= shape.split * shape.kslice
    assert shape.bm in LN.BMS and shape.threads == 2 * shape.bm
    assert shape.grid == (shape.split, -(-m // shape.bm), -(-n // LN.BN))
    assert max(shape.grid[1:]) <= 65535
    assert shape.smem <= LN.SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("name", list(PATH_LN))
def test_layernorm_matmul_launch_fills_the_card_at_path_b(name, dtype):
    m, k, n = PATH_LN[name]
    shape = LN.launch_shape(m, k, n, dtype)
    assert shape.blocks >= LN.SMS
    _ln_limits(shape, m, k, n)
    if name == "whisper decoder":        # 24 blocks of 128 rows unsplit
        assert (shape.bm, shape.split, shape.blocks) == (128, 6, 144)
    else:
        assert (shape.bm, shape.split, shape.blocks) == (128, 1, 576)


def test_layernorm_matmul_launch_splits_k_without_empty_ranks():
    for m in (1, 8, 40, 128, 1000, 3000):
        for k in (1, 31, 32, 33, 66, 384, 1000, 4096):
            for n in (6, 64, 1536):
                s = LN.launch_shape(m, k, n, torch.float32)
                _ln_limits(s, m, k, n)
                assert s.split == 1 or s.blocks <= 8 * LN.SMS


@pytest.mark.parametrize("name", list(HV.VARIANTS))
def test_hand_variants_edit_both_kernels(name):
    """The timing variants of ``launch/hand_variants.py`` apply to the
    kernels' shared header as it stands (the tool raises otherwise), for
    all three hand kernels; LayerNorm+matmul's own variants to its
    source."""
    for mod, file in HV.KERNEL_FILES:
        kern = HV.variant(file, mod.KERNEL, HV.VARIANTS[name])
        assert '#include "mma.cuh"' not in kern.source
        assert kern.key != mod.KERNEL.key
        for _, new in HV.VARIANTS[name]:
            assert new in kern.source
    for subs in HV.LN_VARIANTS.values():
        kern = HV.variant("layernorm_matmul.cu", LN.KERNEL, subs)
        assert kern.key != LN.KERNEL.key
        for _, new in subs:
            assert new in kern.source
