"""The port's multi-device layers on several ranks over gloo against the
reference's own multi-device functions, which run in a child process
with 4 forced CPU devices (``tests/mesh_reference.py``):

* ``layers._moe_apply_sharded`` (``moe_impl="shard_map"`` under a
  (data 2, model 2) mesh, world 4) on reduced qwen3-moe-30b-a3b and
  deepseek-v3-671b (a shared expert), at capacity factors 1.25 (drops
  against each data shard's own capacity) and 8.0: the output within two
  bfloat16 steps of its magnitude (2^-7 of the largest |value|: both sides
  round each partial to bfloat16 and round their sum again, and a partial
  that differs by float32 rounding may round the other way); the
  gradients of the input, of ``gamma`` and of every weight (each
  summed over ``data``, the experts' cut to the rank's slice) within 1e-5
  of their largest value (the cotangent is rounded to bfloat16 alike on
  both sides, so only float32 order differs); drop-free, the output
  within the bfloat16 bound of the port's own ``moe_ref``;
* ``distributed_decode_attention`` at world 2 and 4 on the reference
  test's case (``test_extensions.py:69``, 2e-5) and at positions that
  leave whole shards empty (no NaN; against ``attention_ref`` too);
* ``compressed_psum_mean``: the reference test's 8 steps at world 4, each
  step's synced mean within 1e-6 of the reference's and its error
  feedback equal to it, with the test's own bounds (5 % a step, 2 %
  drift).
"""

import numpy as np
import pytest
import torch

import mesh_reference as MR
import torch_mesh_workers as W

from repro_torch.configs import get_reduced_config
from repro_torch.kernels.ref import attention_ref
from repro_torch.models import layers as TL
import torch_port  # noqa: F401

BF16_STEPS = 2 ** -7     # two bfloat16 steps of the output's magnitude
GRAD_TOL = 1e-5          # of each gradient's largest magnitude
BATCH_PER_SHARD = MR.MOE_X[0] // 2


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = MR.run("collectives", tmp_path_factory.mktemp("ref"))
    return dict(np.load(path))


@pytest.fixture(scope="module")
def ranks(ref, tmp_path_factory):
    """Each world's rank results: ``{world: [rank 0's, ...]}``."""
    tmp = tmp_path_factory.mktemp("ranks")
    npz = str(tmp / "ref.npz")
    np.savez(npz, **ref)
    return {world: W.spawn(W.collectives_rank, world, tmp, npz,
                           MR.MOE_CASES, MR.DECODE_CASES, BATCH_PER_SHARD)
            for world in (4, 2)}


def _close(got, want, tol, what):
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (what, err, np.abs(want).max())


def _moe_gathered(ranks4, n):
    """Case ``n``'s output and gradients over the (data 2, model 2) ranks
    (rank = 2 data + model): the data shards' rows in order; a weight
    gradient from either data row (they are summed over it), the expert
    stacks' slices in model order."""
    pre = f"moe{n}_"
    r = [{k[len(pre):]: v for k, v in d.items() if k.startswith(pre)}
         for d in ranks4]
    got = {}
    for name in r[0]:
        if name in ("out", "dx"):
            got[name] = np.concatenate([r[0][name], r[2][name]])
            for i in (0, 2):      # the model group agrees
                np.testing.assert_array_equal(r[i][name], r[i + 1][name])
        elif name.startswith("d_we_"):
            got[name] = np.concatenate([r[0][name], r[1][name]])
        else:
            got[name] = r[0][name]
            np.testing.assert_array_equal(r[0][name], r[1][name])
    return got


@pytest.mark.parametrize("n", range(len(MR.MOE_CASES)),
                         ids=[f"{a}-cf{c}" for a, c in MR.MOE_CASES])
def test_moe_sharded_matches_reference(ref, ranks, n):
    pre = f"moe{n}_"
    got = _moe_gathered(ranks[4], n)
    _close(got["out"], ref[pre + "out"], BF16_STEPS, "out")
    grads = [k for k in got if k.startswith("d")]
    assert {"dx", "dgamma", "d_router", "d_we_gate", "d_we_up",
            "d_we_down"} <= set(grads)
    if MR.MOE_CASES[n][0] == "deepseek-v3-671b":
        assert "d_shared_w_down" in grads
    for k in grads:
        _close(got[k], ref[pre + k], GRAD_TOL, k)


@pytest.mark.parametrize("n", [n for n, (_, cf) in enumerate(MR.MOE_CASES)
                               if cf == 8.0],
                         ids=[a for a, cf in MR.MOE_CASES if cf == 8.0])
def test_moe_sharded_drop_free_matches_moe_ref(ref, ranks, n):
    pre = f"moe{n}_"
    cfg = get_reduced_config(MR.MOE_CASES[n][0])
    p = {k[len(pre) + 2:]: torch.from_numpy(v) for k, v in ref.items()
         if k.startswith(pre + "p_")}
    want = TL.moe_ref(p, torch.from_numpy(ref[pre + "x"]),
                      torch.from_numpy(ref[pre + "gamma"]), cfg).numpy()
    _close(_moe_gathered(ranks[4], n)["out"], want, BF16_STEPS, "moe_ref")


def test_moe_local_capacity_drops(ref):
    """At capacity factor 1.25 each data shard's capacity binds: the
    sharded layer differs from the whole layer's capacity by more than the
    bfloat16 bound (so the cases above see the per-shard rule)."""
    pre = "moe0_"
    cfg = get_reduced_config(MR.MOE_CASES[0][0], capacity_factor=1.25)
    p = {k[len(pre) + 2:]: torch.from_numpy(v) for k, v in ref.items()
         if k.startswith(pre + "p_")}
    dense = TL.moe_apply(p, torch.from_numpy(ref[pre + "x"]),
                         torch.from_numpy(ref[pre + "gamma"]), cfg).numpy()
    err = np.abs(dense - ref[pre + "out"]).max()
    assert err > 4 * BF16_STEPS * np.abs(dense).max()
    t_local = BATCH_PER_SHARD * MR.MOE_X[1]
    assert TL.moe_capacity(t_local, cfg) < TL.moe_capacity(2 * t_local, cfg)


@pytest.mark.parametrize("world,pos", MR.DECODE_CASES,
                         ids=[f"w{w}-pos{p}" for w, p in MR.DECODE_CASES])
def test_decode_attention_matches_reference(ref, ranks, world, pos):
    outs = [r[f"dec_{world}_{pos}"] for r in ranks[world]]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
    assert np.isfinite(outs[0]).all()
    np.testing.assert_allclose(outs[0], ref[f"dec_{world}_{pos}"],
                               atol=2e-5, rtol=2e-5)
    q, k, v = (torch.from_numpy(ref[f"dec_{n}"]) for n in "qkv")
    want = attention_ref(q, k[:, :, :pos + 1], v[:, :, :pos + 1]).numpy()
    np.testing.assert_allclose(outs[0], want, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(want, ref[f"dec_ref_{pos}"], atol=2e-5,
                               rtol=2e-5)


def test_decode_cases_leave_shards_empty():
    b, h, hkv, s, dh = MR.DECODE_SHAPE
    empty = [(w, p) for w, p in MR.DECODE_CASES
             if (p + 1) <= (w - 1) * s // w]
    assert {w for w, _ in empty} == {2, 4}


@pytest.mark.parametrize("step", range(8))
def test_compressed_psum_mean_matches_reference(ref, ranks, step):
    synced = np.concatenate([r[f"cps_s{step}"] for r in ranks[4]])
    errors = np.concatenate([r[f"cps_e{step}"] for r in ranks[4]])
    np.testing.assert_allclose(synced, ref[f"cps_s{step}"], rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(errors, ref[f"cps_e{step}"])
    exact = ref[f"cps_g{step}"].mean(0)
    assert (np.linalg.norm(synced[0] - exact) / np.linalg.norm(exact)
            < 0.05)


def test_compressed_psum_mean_drift(ref, ranks):
    """Error feedback keeps the accumulated bias under 2 % (the reference
    test's bound)."""
    acc_exact = sum(np.broadcast_to(ref[f"cps_g{s}"].mean(0), (4, 256))
                    for s in range(8))
    acc = sum(np.concatenate([r[f"cps_s{s}"] for r in ranks[4]])
              for s in range(8))
    assert (np.linalg.norm(acc - acc_exact) / np.linalg.norm(acc_exact)
            < 0.02)
