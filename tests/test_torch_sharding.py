"""The port's logical sharding rules, meshes, spec trees and step inputs
(``runtime/sharding.py``, ``launch/mesh.py``, ``LM``/``EncDec``
``param_specs``/``cache_specs``, ``launch/steps.py``) against the
reference's:

* ``logical_to_spec`` equals the reference's for every rule set of
  ``launch.hillclimb`` (its ``VARIANTS`` and ``*_RULES``) on the (data,
  model), (pod, data, model) and (data,) layouts (reference values from a
  child process, ``tests/mesh_reference.py``);
* ``param_specs()`` and ``cache_specs()`` equal the reference's spec trees
  for all ten archs (reduced), laid out as the port's trees (a layer's
  leaves without the stacked layer axis; the cache flat by name);
* ``input_specs`` gives the reference's shapes and dtypes for every cell
  of ``all_cells()`` at full config, on the ``meta`` device;
* ``make_step``'s sanitized shardings at the (16, 16) production mesh
  (world 256 under the ``fake`` backend, in a spawned process) equal the
  reference's at 256 forced devices for qwen2-7b ``train_4k`` and
  ``decode_32k``;
* the meshes, DTensor layouts and ``constrain`` at world 4 over gloo, and
  no fallback from NCCL.
"""

import json

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

import mesh_reference as MR
import torch_mesh_workers as W

from repro import configs as JC
from repro.launch import steps as JS
from repro.models import build_model as jbuild
from repro.models.lm import plan_stages
from repro_torch import configs as TC
from repro_torch.launch import mesh as TM
from repro_torch.launch import steps as TS
from repro_torch.models.lm import build_model as tbuild
from repro_torch.runtime import sharding as SH
import torch_port  # noqa: F401

ARCHS = sorted(TC.ARCHS)
CELLS = TC.all_cells()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return json.loads(MR.run("sharding",
                             tmp_path_factory.mktemp("ref")).read_text())


class _Stand:
    def __init__(self, names):
        self.axis_names = tuple(names)


@pytest.mark.parametrize("layout", MR.LAYOUTS, ids="-".join)
@pytest.mark.parametrize("variant", ["baseline", "dp_only", "fsdp_dp",
                                     "SEQ_TENSOR_RULES"])
def test_logical_to_spec_matches_reference(ref, variant, layout):
    cases = [s for s in ref["specs"] if s["variant"] == variant
             and tuple(s["layout"]) == layout]
    assert len(cases) == len(MR.LOGICAL)
    for c in cases:
        with SH.use_mesh(None, c["rules"]):
            got = SH.logical_to_spec(tuple(c["axes"]), _Stand(layout))
        want = tuple(tuple(e) if isinstance(e, list) else e
                     for e in c["spec"])
        assert got == want, c


def test_use_mesh_nests_and_restores():
    a, b = _Stand(("data", "model")), _Stand(("data",))
    assert SH.active_mesh() is None
    with SH.use_mesh(a):
        with SH.use_mesh(b, {"batch": ("data",)}):
            assert SH.active_mesh() is b
            assert SH.logical_to_spec(("batch", "tensor")) == ("data",)
        assert SH.active_mesh() is a
        assert SH.logical_to_spec(("batch", "tensor")) == ("data", "model")
    assert SH.active_mesh() is None
    assert SH.logical_to_spec(("batch", "tensor")) == ()


def _port_layout(tree, cfg, leaf):
    """The reference's stacked spec tree laid out as the port's
    parameters, each stacked leaf through ``leaf`` (as
    ``from_jax_params`` lays out arrays)."""
    def mapped(t):
        return jax.tree.map(leaf, t, is_leaf=SH.is_axes)
    if cfg.family == "encdec":
        out = {k: v for k, v in tree.items() if k not in ("enc", "dec")}
        out["enc"] = [mapped(tree["enc"])] * cfg.n_enc_layers
        out["dec"] = [mapped(tree["dec"])] * cfg.n_layers
        return out
    out = {k: v for k, v in tree.items() if not k.startswith("stage")}
    out["layers"] = []
    for si, stage in enumerate(plan_stages(cfg)):
        subs = [mapped(tree[f"stage{si}"][f"sub{j}"])
                for j in range(len(stage.subs))]
        out["layers"] += subs * stage.n
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    jcfg = JC.get_reduced_config(arch)
    want = _port_layout(JS._abstract_param_specs(jbuild(jcfg)), jcfg,
                        lambda axes: tuple(axes)[1:])
    got = tbuild(TC.get_reduced_config(arch)).param_specs()
    assert got == want
    shapes = tbuild(TC.get_reduced_config(arch)).init_params(device="meta")
    assert (jax.tree.map(len, got, is_leaf=SH.is_axes)
            == jax.tree.map(lambda t: t.dim(), shapes))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_reference(arch):
    jcfg = JC.get_reduced_config(arch)
    want = jbuild(jcfg).cache_specs()
    got = tbuild(TC.get_reduced_config(arch)).cache_specs()
    if jcfg.family == "encdec":
        assert got == want
        return
    flat = {}
    for stage in want.values():
        for sub in stage.values():
            for name, axes in sub.items():
                assert flat.setdefault(name, tuple(axes)) == tuple(axes)
    assert got == flat


def _flat_cache_shapes(jcache, cfg):
    """The reference's stacked cache as the port's flat one: each name's
    layers counted over every stage and sub-layer that holds it."""
    if cfg.family == "encdec":
        return {f"{c}.{n}": (tuple(t.shape), t.dtype)
                for c, d in jcache.items() for n, t in d.items()}
    out = {}
    for stage in jcache.values():
        for sub in stage.values():
            for name, t in sub.items():
                n, rest = t.shape[0], tuple(t.shape[1:])
                have = out.get(name, ((0,) + rest, t.dtype))
                assert have[0][1:] == rest and have[1] == t.dtype
                out[name] = ((have[0][0] + n,) + rest, t.dtype)
    return out


def _tdtype(d):
    return {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
            jnp.int32: torch.int32}[jnp.dtype(d).type]


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_input_specs_match_reference(arch, shape):
    want = JS.input_specs(JC.get_config(arch), JC.SHAPES[shape])
    got = TS.input_specs(TC.get_config(arch), TC.SHAPES[shape])
    assert set(got) == set(want)
    for k in got:
        if k == "cache":
            continue
        assert got[k].is_meta
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert got[k].dtype == _tdtype(want[k].dtype), k
    if "cache" in want:
        cfg = TC.get_config(arch)
        wc = _flat_cache_shapes(want["cache"], cfg)
        gc = ({f"{c}.{n}": t for c, d in got["cache"].items()
               for n, t in d.items()} if cfg.family == "encdec"
              else got["cache"])
        assert set(gc) == set(wc)
        for name, t in gc.items():
            assert t.is_meta
            assert (tuple(t.shape), t.dtype) == (wc[name][0],
                                                 _tdtype(wc[name][1])), name


@pytest.fixture(scope="module")
def production(tmp_path_factory):
    return W.spawn(W.production_rank, 256, tmp_path_factory.mktemp("fake"),
                   MR.STEP_CELLS, backend="fake")[0]


def _spec_tuple(spec):
    return None if spec is None else tuple(
        tuple(e) if isinstance(e, list) else e for e in spec)


def _ref_step_specs(entries, cfg):
    """The reference's ``make_step`` shardings (path, spec) laid out as the
    port's: a stacked parameter's spec for each of its layers, without
    the layer axis; a cache leaf by its name (the port's flat cache keeps
    the layer axis)."""
    out = {}
    stages = plan_stages(cfg)
    for path, spec in entries:
        spec = _spec_tuple(spec)
        at = [i for i, k in enumerate(path) if str(k).startswith("stage")]
        if not at:
            out[tuple(path)] = spec
        elif path[1] == "cache":
            out[tuple(path[:2]) + tuple(path[-1:])] = spec
        else:
            i = at[0]
            si, j = int(path[i][5:]), int(path[i + 1][3:])
            first = sum(st.n * len(st.subs) for st in stages[:si])
            per = len(stages[si].subs)
            for rep in range(stages[si].n):
                out[tuple(path[:i]) + ("layers", first + rep * per + j)
                    + tuple(path[i + 2:])] = spec[1:] if spec else ()
    return out


def test_production_mesh_under_fake_backend(production):
    assert production["names"] == ("data", "model")
    assert production["shape"] == (16, 16)
    assert production["multi_error"].startswith(
        "need 512 devices for the production mesh, have 256")


@pytest.mark.parametrize("arch,shape", MR.STEP_CELLS,
                         ids=[f"{a}-{s}" for a, s in MR.STEP_CELLS])
def test_make_step_shardings_match_reference(ref, production, arch, shape):
    cfg = JC.get_config(arch)
    want = _ref_step_specs(ref["steps"][f"{arch}/{shape}"], cfg)
    got = {tuple(path): _spec_tuple(spec)
           for path, spec in production[f"{arch}/{shape}"]}
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k], k
    # 4 KV heads cannot split 16 ways: the cache's model axis is dropped
    if shape == "decode_32k":
        assert got[(1, "cache", "k")] == (None, "data")


def test_make_step_args_hold_no_memory():
    cfg = TC.get_reduced_config("qwen3-moe-30b-a3b")
    step, args, shardings = TS.make_step(cfg, TC.SHAPES["train_4k"])
    leaves = torch.utils._pytree.tree_leaves(args)
    assert leaves and all(t.is_meta for t in leaves)
    assert callable(step) and callable(shardings)
    params, opt, batch = args
    assert set(opt) == {"m", "v", "step"}
    assert batch["tokens"].shape == (256, 4096)


def test_sanitize_shardings_drops_trailing_axes():
    mesh = _Stand(("pod", "data", "model"))
    mesh.shape = (2, 16, 16)
    mesh.mesh_dim_names = mesh.axis_names
    sh = {"a": SH.NamedSharding(mesh, SH.Spec(("pod", "data"), "model")),
          "b": SH.NamedSharding(mesh, SH.Spec(("pod", "data"))),
          "c": None}
    ab = {"a": torch.empty(8, 24, device="meta"),
          "b": torch.empty(1, device="meta"),
          "c": torch.empty(3, device="meta")}
    out = TS.sanitize_shardings(sh, ab, mesh)
    assert out["a"].spec == ("pod",)
    assert out["b"].spec == ()
    assert out["c"] is None


def test_meta_params_have_the_drawn_shapes():
    for arch in ("jamba-1.5-large-398b", "whisper-tiny"):
        cfg = TC.get_reduced_config(arch)
        meta = tbuild(cfg).init_params(device="meta")
        real = tbuild(cfg).init_params(device="cpu")
        assert (jax.tree.map(lambda t: (tuple(t.shape), t.dtype), meta)
                == jax.tree.map(lambda t: (tuple(t.shape), t.dtype), real))
    full = tbuild(TC.get_config("jamba-1.5-large-398b")).init_params(
        device="meta")
    assert full["embed"].is_meta and full["embed"].shape == (65536, 8192)


def test_layouts_on_a_gloo_mesh(tmp_path):
    out = W.spawn(W.layout_rank, 4, tmp_path)
    g = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    for r in out:
        assert r["spec"] == ("data", "model")
        i, j = r["coord"]
        torch.testing.assert_close(r["local"], g[4 * i:4 * i + 4,
                                                 3 * j:3 * j + 3],
                                   rtol=0, atol=0)
        assert r["y_placements"] == [Shard(0), Replicate()]
        torch.testing.assert_close(r["y_local"], g[4 * i:4 * i + 4],
                                   rtol=0, atol=0)
        torch.testing.assert_close(r["y_full"], g, rtol=0, atol=0)
        assert r["plain_same"] and r["no_mesh"]


def test_meshes_in_one_process():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="need 256 devices for the "
                       "production mesh, have 1"):
        TM.make_production_mesh()
    with pytest.raises(RuntimeError, match="needs a process group"):
        TM.make_debug_mesh()
    assert TM.init_distributed("cpu") is True
    try:
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        mesh = TM.make_debug_mesh()
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        assert TM.init_distributed("cpu") is False
        with pytest.raises(RuntimeError, match="needs 'nccl'"):
            TM.init_distributed("cuda")
    finally:
        dist.destroy_process_group()


def test_cuda_never_falls_back_to_gloo():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: NCCL would start")
    with pytest.raises(RuntimeError, match="no fallback"):
        TM.init_distributed("cuda")
    assert not dist.is_initialized()
