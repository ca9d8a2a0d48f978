"""The port's step analysis, dry-run and hill-climb driver
(``runtime/op_analysis.py``, ``launch/dryrun.py``, ``launch/hillclimb.py``)
against the reference's (``runtime/hlo_analysis.py``, ``launch/dryrun.py``,
``launch/hillclimb.py``):

* ``Roofline`` under the reference's TPU v5e rates equals the
  reference's, term by term; ``collective_bytes`` of the records of an
  HLO snippet's collectives equals the reference's count of the text;
  ``model_flops`` is the reference's;
* ``active_params`` and ``layer_knobs`` for all ten archs,
  ``attention_intermediate_bytes`` for every cell of ``all_cells()``,
  ``VARIANTS`` and the rule sets equal the reference's (values from a
  child process with 256 forced devices, ``tests/mesh_reference.py``);
* each supported cell's per-rank argument bytes at the (16, 16) mesh
  (world 256 under the ``fake`` backend, in a spawned process) equal the
  reference's sum of ``NamedSharding.shard_shape`` bytes;
* the counts: at world 1 a reduced dense train step's FLOPs equal the
  analytic count; the same step's FLOPs on a (4,) ``data`` mesh under
  ``DP_ONLY_RULES`` are exactly a quarter; a ``model``-sharded output
  projection all-reduces twice its output shard; the extrapolation to
  depth 3 equals the direct count; ``meta`` counts equal the CPU's;
  every ``VARIANTS`` entry runs on a reduced MoE cell;
* reduced models on DTensors (the dry-run's layout) against plain
  tensors, and the explicitly parallel layers' ``local_map`` entries
  against their local forms, over gloo;
  ``attention_chunked(p_half=True)`` against the reference's
  ``attention_xla_flash(p_half=True)``; the dry-run's CLI on one cell.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import mesh_reference as MR
import torch_mesh_workers as W
from reference_cpu import reference_on_cpu  # noqa: F401

from repro.runtime import hlo_analysis as JH
from repro_torch import configs as TC
from repro_torch.kernels import ref as R
from repro_torch.launch import dryrun as D
from repro_torch.launch import hillclimb as H
from repro_torch.launch.steps import make_step
from repro_torch.runtime import op_analysis as OA
from repro_torch.runtime import sharding as SH
import torch_port  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
V5E = dict(peak_flops=JH.PEAK_FLOPS, hbm_bw=JH.HBM_BW, link_bw=JH.LINK_BW)
ROOFS = [(1e12, 1e9, {}), (1e9, 4e12, {"all-gather": 1e8}),
         (3e12, 2e9, {"all-reduce": 5e10, "all-to-all": 1e9}),
         (0.0, 0.0, {})]


@pytest.mark.parametrize("flops,hbm,coll", ROOFS)
def test_roofline_matches_reference_under_v5e(flops, hbm, coll):
    want = JH.Roofline(flops=flops, hbm_bytes=hbm, coll_bytes=dict(coll))
    got = OA.Roofline(flops=flops, hbm_bytes=hbm, coll_bytes=dict(coll),
                      **V5E)
    for name in ("total_coll", "t_compute", "t_memory", "t_collective",
                 "bottleneck", "t_bound"):
        assert getattr(got, name) == getattr(want, name), name
    for mf in (0.0, 5e11, flops):
        assert got.fraction_of_roofline(mf) == want.fraction_of_roofline(mf)
    assert got.summary() == want.summary()


def test_h100_constants():
    assert (OA.PEAK_FLOPS, OA.HBM_BW, OA.LINK_BW, OA.HBM_BYTES) == (
        989e12, 3.35e12, 450e9, 80e9)
    r = OA.Roofline(flops=989e12, hbm_bytes=3.35e12,
                    coll_bytes={"all-reduce": 450e9})
    assert (r.t_compute, r.t_memory, r.t_collective) == (1.0, 1.0, 1.0)


#: an HLO snippet's collectives and the ``(kind, bytes)`` records the
#: port's recorder takes from the c10d ops that move the same tensors
HLO = """\
  %ar = f32[256,1024]{1,0} all-reduce(f32[256,1024]{1,0} %x), to_apply=%sum
  %ag = bf16[64,4096]{1,0} all-gather(bf16[4,4096]{1,0} %y), dimensions={0}
  %rs = f32[16,512]{1,0} reduce-scatter(f32[256,512]{1,0} %z), dimensions={0}
  %a2a = bf16[8,128,64]{2,1,0} all-to-all(bf16[8,128,64]{2,1,0} %w)
  %cp = s32[32]{0} collective-permute(s32[32]{0} %p), source_target_pairs={{0,1}}
  %ags = (bf16[4,256]{1,0}, bf16[64,256]{1,0}) all-gather-start(bf16[4,256]{1,0} %u)
  %agd = bf16[64,256]{1,0} all-gather-done((bf16[4,256]{1,0}, bf16[64,256]{1,0}) %ags)
  %add = f32[256,1024]{1,0} add(f32[256,1024]{1,0} %ar, f32[256,1024]{1,0} %ar)
"""
RECORDS = [("all-reduce", 256 * 1024 * 4), ("all-gather", 64 * 4096 * 2),
           ("reduce-scatter", 16 * 512 * 4), ("all-to-all", 8 * 128 * 64 * 2),
           ("collective-permute", 32 * 4),
           ("all-gather", 4 * 256 * 2 + 64 * 256 * 2)]


def test_collective_bytes_matches_reference_hlo():
    # the reference counts the result of an all-reduce, all-gather, ...;
    # its async start's result tuple holds operand and result
    assert OA.collective_bytes(RECORDS) == JH.collective_bytes(HLO)


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_model_flops(kind):
    for n, t in ((1.35e8, 1 << 20), (3.7e10, 4096), (7e9, 1)):
        assert OA.model_flops(n, t, kind) == JH.model_flops(n, t, kind)


# ---------------------------------------------------------------------------
# the reference's dry-run values (a child with 256 forced devices)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = json.loads(MR.run("analysis",
                            tmp_path_factory.mktemp("ref")).read_text())
    assert out["n_devices"] == 256
    return out


@pytest.mark.parametrize("arch", sorted(TC.ARCHS))
def test_active_params_and_layer_knobs(ref, arch):
    cfg = TC.get_config(arch)
    want = ref["knobs"][arch]
    assert D.active_params(cfg) == want["active"]
    knobs, with_counts = D.layer_knobs(cfg)
    assert [list(k) for k in knobs] == want["knobs"]
    c = with_counts({k: 2 for k, _ in knobs})
    assert [c.n_layers, c.n_dense_layers, c.n_enc_layers] == want["at_2"]


def test_attention_intermediate_bytes(ref):
    cells = TC.all_cells()
    assert len(cells) == len(ref["adj"])
    for arch, shape in cells:
        got = D.attention_intermediate_bytes(TC.get_config(arch),
                                             TC.SHAPES[shape])
        assert got == ref["adj"][f"{arch}/{shape}"], (arch, shape)


def _jsonable(x):
    return json.loads(json.dumps(x))


def test_variants_and_rules(ref):
    assert _jsonable(H.VARIANTS) == ref["variants"]
    assert {n: _jsonable(getattr(H, n)) for n in ref["rules"]} == \
        ref["rules"]


@pytest.fixture(scope="module")
def arg_bytes(ref, tmp_path_factory):
    cells = [tuple(c.split("/")) for c in ref["args"]]
    return W.spawn(W.argument_bytes_rank, 256,
                   tmp_path_factory.mktemp("fake"), cells,
                   backend="fake")[0]


@pytest.mark.parametrize("arch", sorted(TC.ARCHS))
def test_argument_bytes_match_reference(ref, arg_bytes, arch):
    cells = [c for c in ref["args"] if c.startswith(arch + "/")]
    assert cells
    for c in cells:
        assert arg_bytes[c] == ref["args"][c], c


# ---------------------------------------------------------------------------
# the counts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    return W.spawn(W.counting_rank, 4, tmp_path_factory.mktemp("fake"),
                   backend="fake")[0]


def test_dp_flops_are_a_quarter_of_world_one(counts):
    w1, dp4 = counts["w1"], counts["dp4"]
    assert w1[0] > 0 and w1[2] == {}
    assert dp4[0] * 4 == w1[0]
    assert dp4[1] < w1[1]
    assert set(dp4[2]) >= {"all-reduce"}       # the gradients' sum


def test_sharded_projection_all_reduces_twice_its_output_shard(counts):
    coll, out_bytes = counts["proj"]
    # the output: rows split over data (4 / 2), whole over model
    assert out_bytes == 2 * 8 * 32 * 4
    assert coll == {"all-reduce": 2.0 * out_bytes}


def test_extrapolation_equals_direct_count_at_depth_3(counts):
    direct, ext = counts["depth3"]
    assert direct == ext


def test_every_variant_runs_on_a_reduced_moe_cell(counts):
    v = counts["variants"]
    assert set(v) == set(H.VARIANTS)
    for name, (flops, hbm, coll) in v.items():
        assert flops > 0 and hbm > 0 and coll, name
    # the expert-parallel layer moves fewer bytes between ranks
    total = {k: sum(c.values()) for k, (_, _, c) in v.items()}
    assert total["moe_shard_map"] < total["baseline"]
    # data parallel alone: no reduce-scatter of fsdp-sharded weights
    assert "reduce-scatter" not in v["dp_only"][2]


def _small_dense(**kw):
    return TC.get_reduced_config("smollm-135m", n_layers=2, remat=False,
                                 **kw)


def _analytic_train_flops(cfg, b, s):
    """Matrix-product FLOPs of one train step: the projections, MLP and
    head three times (forward, and the gradients of both operands); the
    attention products four times (the forward, its recompute for the
    reference VJP, and the two gradients)."""
    d, h, hkv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.d_head, cfg.d_ff)
    t = b * s
    proj = 2 * t * (d * h * dh + 2 * d * hkv * dh + h * dh * d)
    mlp = 2 * t * 3 * d * f
    attn = 2 * 2 * b * h * s * s * dh
    head = 2 * t * d * cfg.vocab
    return cfg.n_layers * (3 * (proj + mlp) + 4 * attn) + 3 * head


def _concrete(args, seed=0):
    """``make_step``'s ``meta`` arguments as CPU tensors: token ids in the
    vocabulary, zeros elsewhere."""
    g = torch.Generator().manual_seed(seed)

    def one(t):
        if t.dtype in (torch.int32, torch.int64):
            return torch.randint(0, 64, t.shape, generator=g,
                                 dtype=t.dtype)
        return torch.randn(t.shape, generator=g).to(t.dtype) * 0.02
    return pytree.tree_map(one, args)


def test_world_one_matmul_flops_are_analytic():
    cfg = _small_dense(attn_impl="ref", mlp_impl="unfused")
    shape = TC.ShapeSpec("t", 32, 4, "train")
    step, args, _ = make_step(cfg, shape)
    a = OA.analyze_step(step, args)
    assert a.roofline.flops == _analytic_train_flops(cfg, 4, 32)
    assert a.roofline.coll_bytes == {}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_meta_counts_equal_cpu_counts(kind):
    cfg = _small_dense(attn_impl="chunked", mlp_impl="fused_ref")
    shape = TC.ShapeSpec(kind, 32, 4, kind)
    step, args, _ = make_step(cfg, shape)
    if kind == "decode":
        args[1]["pos"] = torch.tensor(7, dtype=torch.int32, device="meta")
    meta = OA.analyze_step(step, args)
    real = _concrete(args)
    if kind == "decode":
        real[1]["pos"] = torch.tensor(7, dtype=torch.int32)
    cpu = OA.analyze_step(step, real)
    assert meta.roofline.flops == cpu.roofline.flops > 0
    assert meta.roofline.hbm_bytes == cpu.roofline.hbm_bytes > 0
    assert meta.argument_size_in_bytes == cpu.argument_size_in_bytes == \
        OA.local_bytes(args)
    assert meta.output_size_in_bytes == cpu.output_size_in_bytes > 0
    assert 0 < meta.temp_size_in_bytes == cpu.temp_size_in_bytes


def test_recorder_counts_views_as_free_and_scatters_by_source():
    x = torch.zeros(64, 32)
    src = torch.ones(4, 32)
    idx = torch.tensor([1, 5, 9, 13])
    with OA.OpRecorder() as rec:
        x.view(32, 64).transpose(0, 1)
    assert rec.hbm_bytes == 0 and rec.n_ops == 2
    with OA.OpRecorder() as rec:
        x.index_copy_(0, idx, src)
    assert rec.hbm_bytes == 2 * src.numel() * 4 + idx.numel() * 8
    with OA.OpRecorder() as rec:
        y = x @ torch.ones(32, 16)
        del y
    assert rec.flops == 2 * 64 * 32 * 16
    assert rec.peak_bytes == 32 * 16 * 4 + 64 * 16 * 4 and rec.live == 0


def test_constrain_is_the_identity_on_plain_tensors():
    x = torch.randn(4, 6)

    class Stand:
        axis_names = ("data", "model")
        shape = (2, 3)
    with SH.use_mesh(Stand()):
        assert SH.constrain(x, "batch", "tensor") is x
        assert not SH.is_distributed(x)
        assert SH.divides(6, "tensor") and not SH.divides(4, "tensor")
    assert SH.divides(5, "tensor")
    assert SH.fit_spec(SH.Spec(("pod", "data"), "model"), (4, 6),
                       _Mesh()) == SH.Spec("pod", "model")


class _Mesh:
    mesh_dim_names = ("pod", "data", "model")
    shape = (2, 4, 3)


def test_local_map_layers_match_local_forms(tmp_path):
    out = W.spawn(W.local_map_rank, 4, tmp_path)
    for r in out:
        assert r["moe_shape"] == (2, 8, 128)
        # the same float32 arithmetic on the same shards
        assert r["moe"] <= 1e-6 * r["moe_scale"], r
        assert r["moe_grads"] <= 1e-5, r
        for pos in (45, 10):
            assert r[f"decode_{pos}"] < 2e-5, r


def test_dtensor_layout_matches_plain_models(tmp_path):
    """Reduced models on DTensors at (data 2, model 2) over gloo, laid out
    as the dry-run lays them out, against the same models on plain
    tensors: logits, loss, every gradient leaf, a decode step and its
    cache write; float32, so within summation order (2e-6 of the largest
    value; each leaf relative to its own largest)."""
    out = W.spawn(W.dtensor_model_rank, 4, tmp_path)
    for r in out:
        assert r == out[0]
    for key, v in out[0].items():
        if key.endswith("/grads"):
            assert v <= 1e-5, (key, v)
        else:
            assert v[0] <= 2e-6 * max(v[1], 1.0), (key, v)
    assert {k.split("/")[0] for k in out[0]} == {
        "llama3.2-1b", "qwen3-moe-30b-a3b", "smollm-135m", "decode"}


def test_p_half_matches_reference():
    from repro.kernels import ref as JR
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=shp).astype(np.float32)
               for shp in ((2, 4, 64, 32), (2, 2, 96, 32), (2, 2, 96, 32)))
    got = {}
    for p_half in (False, True):
        tq, tk, tv = (torch.tensor(a).to(torch.bfloat16) for a in (q, k, v))
        o = R.attention_chunked(tq, tk, tv, causal=True, q_offset=32,
                                block_kv=32, p_half=p_half)
        want = JR.attention_xla_flash(
            *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
            causal=True, q_offset=32, block_kv=32, p_half=p_half)
        got[p_half] = o.float().numpy()
        # both round the output to bfloat16 once: one ulp of the largest
        # output apart at most
        tol = 2.0 ** -7 * np.abs(got[p_half]).max()
        err = np.abs(got[p_half] - np.asarray(want, np.float32)).max()
        assert err <= tol, (p_half, err, tol)
    assert np.abs(got[True] - got[False]).max() > 0


def test_dryrun_cli_one_cell(tmp_path):
    out = tmp_path / "dry.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "smollm-135m", "--shape", "decode_32k",
                        "--mesh", "both", "--out", str(out)],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    res = json.loads(out.read_text())
    assert [c["mesh"] for c in res] == ["single", "multi"]
    for c in res:
        assert c["status"] == "ok"
        assert c["n_chips"] == (256 if c["mesh"] == "single" else 512)
        assert c["flops_per_chip"] > 0 and c["hbm_bytes_per_chip"] > 0
        assert c["bottleneck"] in ("compute", "memory", "collective")
        assert isinstance(c["fits_80g_hbm"], bool)
        assert c["argument_size_in_bytes"] > 0
    assert "=== done: 2 ok, 0 skipped, 0 failed" in r.stdout
