"""What the port's mesh tests run on each rank: ``spawn`` starts the ranks
as processes (``torch.multiprocessing.spawn``) over gloo, or one process
under the ``fake`` backend, each joining through a ``FileStore`` of its
own directory (no fixed port, so the xdist workers never collide) and
destroying its process group before it exits.  Each rank's return value
comes back to the test through ``torch.save``.

This module imports no jax: a spawned rank imports it, and the port's
ranks run without the reference.
"""

import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils import _pytree as pytree


def spawn(fn, world: int, tmp, *args, backend: str = "gloo"):
    """``fn(rank, world, *args)`` on ``world`` ranks (one process of world
    ``world`` for ``backend="fake"``); returns each rank's result."""
    d = tempfile.mkdtemp(dir=tmp)
    procs = 1 if backend == "fake" else world
    mp.spawn(_child, args=(fn, world, d, args, backend), nprocs=procs,
             join=True)
    return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False)
            for r in range(procs)]


def _child(rank, fn, world, d, args, backend):
    from repro_torch.launch.mesh import init_distributed
    torch.set_num_threads(1)
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
    else:
        init_distributed("cpu", rank=rank, world_size=world,
                         store=dist.FileStore(os.path.join(d, "store"),
                                              world))
    try:
        out = fn(rank, world, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(d, f"rank{rank}.pt"))


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), dtype=torch.float32,
                        requires_grad=grad)


# ---------------------------------------------------------------------------
# collectives: the expert-parallel MoE, decode attention, compressed mean
# ---------------------------------------------------------------------------

def moe_rank(ref, cfg, n: int, mesh, batch_per_shard: int):
    """Case ``n``'s MoE layer on this rank of the (data, model) ``mesh``:
    its data shard of ``x``, its model slice of the expert stacks.
    Returns its output and gradients, each weight's and ``gamma``'s
    summed over ``data`` (the data-parallel sum)."""
    from repro_torch.models import layers as TL
    from repro_torch.runtime.collectives import axis_group
    from repro_torch.runtime.sharding import use_mesh
    pre = f"moe{n}_"
    i, j = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    el = cfg.n_experts // mesh.shape[1]
    rows = slice(i * batch_per_shard, (i + 1) * batch_per_shard)
    p = {}
    for k in [k[len(pre) + 2:] for k in ref if k.startswith(pre + "p_")]:
        a = ref[pre + "p_" + k]
        p[k] = _t(a[j * el:(j + 1) * el] if k.startswith("we_") else a, True)
    x = _t(ref[pre + "x"][rows], True)
    gamma = _t(ref[pre + "gamma"], True)
    with use_mesh(mesh):
        y = TL.moe_apply(p, x, gamma, cfg)
    (y * _t(ref[pre + "ct"][rows])).sum().backward()
    data = axis_group(mesh, "data")
    out = {"out": y.detach(), "dx": x.grad}
    for k, t in [("dgamma", gamma)] + [("d_" + k, v) for k, v in p.items()]:
        g = t.grad.clone()
        dist.all_reduce(g, group=data)
        out[k] = g
    return {k: v.numpy() for k, v in out.items()}


def collectives_rank(rank, world, npz, moe_cases, decode_cases,
                     batch_per_shard):
    """Every collective check of ``world`` ranks on the reference's inputs
    (``npz``): the MoE cases at (data 2, model 2) (world 4), the decode
    cases of this world, and 8 steps of ``compressed_psum_mean`` (4)."""
    import dataclasses

    from repro_torch.configs import get_reduced_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim.compression import compressed_psum_mean
    from repro_torch.runtime.collectives import distributed_decode_attention
    ref = dict(np.load(npz))
    out = {}
    if world == 4:
        mesh = make_debug_mesh((2, 2))
        for n, (arch, cf) in enumerate(moe_cases):
            cfg = dataclasses.replace(
                get_reduced_config(arch, capacity_factor=cf),
                moe_impl="shard_map")
            for k, v in moe_rank(ref, cfg, n, mesh,
                                 batch_per_shard).items():
                out[f"moe{n}_{k}"] = v
        dm = make_debug_mesh((4,), ("data",))
        errors = None
        for step in range(8):
            g = {"w": _t(ref[f"cps_g{step}"][rank:rank + 1])}
            synced, errors = compressed_psum_mean(g, dm, ("data",), errors)
            out[f"cps_s{step}"] = synced["w"].numpy()
            out[f"cps_e{step}"] = errors["w"].numpy()
    dm = make_debug_mesh((world,), ("data",))
    q, k, v = (_t(ref[f"dec_{n}"]) for n in "qkv")
    s_shard = k.shape[2] // world
    cut = slice(rank * s_shard, (rank + 1) * s_shard)
    for w, pos in decode_cases:
        if w == world:
            out[f"dec_{w}_{pos}"] = distributed_decode_attention(
                q, k[:, :, cut], v[:, :, cut], pos, dm).numpy()
    return out


# ---------------------------------------------------------------------------
# sharding: meshes, DTensor layouts, make_step at the production mesh
# ---------------------------------------------------------------------------

def _flat_specs(tree, path=()):
    """``[path, spec]`` of every leaf of a sharding tree (None kept)."""
    from repro_torch.runtime.sharding import NamedSharding
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _flat_specs(v, path
                                                                 + (k,))]
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          NamedSharding):
        return [x for i, v in enumerate(tree)
                for x in _flat_specs(v, path + (i,))]
    spec = None if tree is None else [list(e) if isinstance(e, tuple)
                                      else e for e in tree.spec]
    return [[list(path), spec]]


def production_rank(rank, world, cells):
    """Under the fake backend at world 256: the production mesh, the
    multi-pod mesh's refusal, and ``make_step``'s sanitized shardings of
    ``cells``."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import mesh as M
    from repro_torch.launch.steps import make_step
    mesh = M.make_production_mesh()
    out = {"names": mesh.mesh_dim_names, "shape": tuple(mesh.shape)}
    try:
        M.make_production_mesh(multi_pod=True)
    except RuntimeError as e:
        out["multi_error"] = str(e)
    for arch, shape in cells:
        _, args, shardings = make_step(get_config(arch), SHAPES[shape])
        out[f"{arch}/{shape}"] = _flat_specs(shardings(mesh))
    return out


def layout_rank(rank, world):
    """At world 4 on a (data 2, model 2) debug mesh: a tensor distributed
    by a logical spec, ``constrain`` of a DTensor, and ``constrain`` and
    ``named_sharding`` without a mesh or on a plain tensor."""
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.runtime import sharding as SH
    mesh = make_debug_mesh((2, 2))
    g = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    sh = SH.named_sharding(("batch", "tensor"), mesh)
    x = SH.distribute(g, sh)
    plain = torch.ones(3)
    with SH.use_mesh(mesh):
        y = SH.constrain(x, "batch", None)
        same = SH.constrain(plain, "batch") is plain
    return {"spec": tuple(sh.spec), "local": x.to_local().clone(),
            "coord": (mesh.get_local_rank("data"),
                      mesh.get_local_rank("model")),
            "y_placements": list(y.placements),
            "y_local": y.to_local().clone(), "y_full": y.full_tensor(),
            "plain_same": same,
            "no_mesh": SH.constrain(plain, "batch") is plain
            and SH.named_sharding(("batch",)) is None}


# ---------------------------------------------------------------------------
# training: data parallel train.py, resharding restore
# ---------------------------------------------------------------------------

def _reference_weights(tree):
    """Make the port's ``LM.init_params`` load ``tree`` (the reference's
    weights as numpy arrays), as the one-process run does."""
    from repro_torch.models.lm import LM

    def init_params(self, seed=0, device="cuda"):
        return self.from_jax_params(tree, device=device)
    LM.init_params = init_params


def _leaves(tree):
    return [x.detach().clone() for x in pytree.tree_leaves(tree)]


def train_rank(rank, world, argv, tree):
    """``train.main(argv)`` on every rank, on the reference's weights;
    returns its losses and final parameters."""
    from repro_torch.launch import train
    if tree is not None:
        _reference_weights(tree)
    res = train.main(argv)
    return {"losses": res["losses"], "params": _leaves(res["params"])}


def restore_rank(rank, world, ckpt, arch):
    """A checkpoint restored onto its logical shardings on a (data 2,
    model 1) mesh: every leaf's local shard, placements and global
    shape."""
    from torch.distributed.tensor import DTensor

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.lm import build_model
    from repro_torch.optim import AdamW
    from repro_torch.runtime.sharding import tree_shardings
    mesh = make_debug_mesh((world, 1))
    specs = build_model(get_reduced_config(arch)).param_specs()
    opt = AdamW(lr=lambda s: 1e-3)
    shardings = {"params": tree_shardings(specs, mesh),
                 "opt": tree_shardings(opt.state_specs(specs), mesh),
                 "step": None}
    state = CheckpointManager(ckpt, mesh=mesh).restore(shardings=shardings,
                                                       device="cpu")
    out = []
    for x in pytree.tree_leaves(state):
        if isinstance(x, DTensor):
            out.append((x.to_local().clone(), list(x.placements),
                        tuple(x.shape)))
        else:
            out.append((x.clone(), None, tuple(x.shape)))
    return out


# ---------------------------------------------------------------------------
# the dry-run's analysis (launch/dryrun.py, runtime/op_analysis.py) under
# the fake backend
# ---------------------------------------------------------------------------

def argument_bytes_rank(rank, world, cells):
    """At world 256: each cell's per-rank argument bytes at the (16, 16)
    production mesh."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(device_type="cuda")
    return {f"{a}/{s}": D.argument_bytes(get_config(a), SHAPES[s], mesh)
            for a, s in cells}


def _small_train(n_layers=2):
    """A reduced dense train cell: smollm-135m at 2 layers, batch 8 x 32,
    on the dry-run's impls."""
    from repro_torch.configs import ShapeSpec, get_reduced_config
    cfg = get_reduced_config("smollm-135m", n_layers=n_layers,
                             attn_impl="chunked", mlp_impl="fused_ref")
    return cfg, ShapeSpec("small_train", 32, 8, "train")


def counting_rank(rank, world):
    """At world 4 (meshes of device type ``cuda``): a reduced dense train
    step's per-rank counts at world 1 (no mesh) and on a (4,) ``data``
    mesh under ``DP_ONLY_RULES``; a ``model``-sharded output projection's
    collectives; the extrapolation to depth 3 against the direct count on
    a (data 2, model 2) mesh; ``hillclimb``'s variants on a reduced MoE
    cell."""
    import dataclasses
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import ShapeSpec, get_reduced_config
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import hillclimb as H
    from repro_torch.launch.steps import make_step
    from repro_torch.models import layers as L
    from repro_torch.runtime import sharding as SH
    from repro_torch.runtime.op_analysis import analyze_step
    out = {}
    cfg, shape = _small_train()
    step, args, _ = make_step(cfg, shape)
    one = analyze_step(step, args)
    out["w1"] = (one.roofline.flops, one.roofline.hbm_bytes,
                 one.roofline.coll_bytes)
    dp = DeviceMesh("cuda", torch.arange(4), mesh_dim_names=("data",))
    four = D._measure(cfg, shape, dp, rules=H.DP_ONLY_RULES)
    out["dp4"] = (four.roofline.flops, four.roofline.hbm_bytes,
                  four.roofline.coll_bytes)
    mesh = DeviceMesh("cuda", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("data", "model"))
    # o (b, s, heads * dh) split over the heads, wo over its rows
    b, s, h, dh, d = 4, 8, 4, 16, 32
    o = distribute_tensor(torch.empty(b, s, h * dh, device="meta"), mesh,
                          [Shard(0), Shard(2)], src_data_rank=None)
    wo = distribute_tensor(torch.empty(h * dh, d, device="meta"), mesh,
                           [Replicate(), Shard(0)], src_data_rank=None)
    with SH.use_mesh(mesh), implicit_replication():
        proj = analyze_step(lambda o, w: L.out_proj(o, w, h), (o, wo))
    out["proj"] = (proj.roofline.coll_bytes, proj.output_size_in_bytes)
    three = dataclasses.replace(cfg, n_layers=3)
    direct = D._measure(three, shape, mesh)
    ext = D.extrapolated_roofline(three, shape, mesh)
    out["depth3"] = ((direct.roofline.flops, direct.roofline.hbm_bytes,
                      direct.roofline.coll_bytes),
                     (ext.flops, ext.hbm_bytes, ext.coll_bytes))
    moe = get_reduced_config("qwen3-moe-30b-a3b", n_layers=2,
                             attn_impl="chunked", mlp_impl="fused_ref",
                             capacity_factor=1.25)
    mshape = ShapeSpec("small_moe", 16, 8, "train")
    out["variants"] = {}
    for name, spec in H.VARIANTS.items():
        c = dataclasses.replace(moe, **spec.get("cfg", {}))
        r = D.extrapolated_roofline(c, mshape, mesh, spec.get("rules"),
                                    spec.get("out_shardings", False))
        out["variants"][name] = (r.flops, r.hbm_bytes, r.coll_bytes)
    return out


def local_map_rank(rank, world):
    """At world 4 over gloo, a (data 2, model 2) mesh: the DTensor entries
    of the explicitly parallel layers (``local_map``) against their local
    forms on the same shards: the expert-parallel MoE layer, and decode
    attention against the plain oracle.  Returns the largest
    differences."""
    import dataclasses
    from torch.distributed.tensor import (Replicate, Shard,
                                          distribute_tensor)
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels.ref import attention_ref
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import layers as TL
    from repro_torch.models.common import init_moe, ParamBuilder
    from repro_torch.runtime.collectives import distributed_decode_attention
    from repro_torch.runtime.sharding import use_mesh
    mesh = make_debug_mesh((2, 2))
    cfg = dataclasses.replace(
        get_reduced_config("qwen3-moe-30b-a3b", capacity_factor=1.25),
        moe_impl="shard_map")
    p = init_moe(ParamBuilder(np.random.default_rng(0), torch.float32,
                              "cpu"), cfg)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 8, cfg.d_model, generator=g)
    gamma = 1 + 0.1 * torch.randn(cfg.d_model, generator=g)
    i, j = mesh.get_local_rank("data"), mesh.get_local_rank("model")
    el = cfg.n_experts // 2
    local_p = {k: v[j * el:(j + 1) * el] if k.startswith("we_") else v
               for k, v in p.items()}
    rep = [Replicate(), Replicate()]
    dp = {k: distribute_tensor(v, mesh, [Replicate(), Shard(0)]
                               if k.startswith("we_") else rep)
          for k, v in p.items()}
    ct = torch.randn(4, 8, cfg.d_model, generator=g)
    for t in list(local_p.values()) + list(dp.values()):
        t.requires_grad_(True)
    with use_mesh(mesh):
        want = TL.moe_apply(local_p, x[2 * i:2 * i + 2], gamma, cfg)
        (want * ct[2 * i:2 * i + 2]).sum().backward()
        with implicit_replication():
            got = TL.moe_apply(dp, distribute_tensor(
                x, mesh, [Shard(0), Replicate()]),
                distribute_tensor(gamma, mesh, rep), cfg)
            (got * distribute_tensor(ct, mesh, [Shard(0), Replicate()])
             ).sum().backward()
    from repro_torch.runtime.collectives import axis_group
    grad_gap = 0.0
    for k, t in local_p.items():
        want_g = t.grad.clone()
        dist.all_reduce(want_g, group=axis_group(mesh, "data"))
        got_g = dp[k].grad.full_tensor()
        if k.startswith("we_"):
            got_g = got_g[j * el:(j + 1) * el]
        grad_gap = max(grad_gap, float((got_g - want_g).abs().max()
                                       / want_g.abs().max()))
    out = {"moe": float((got.to_local() - want).abs().max()),
           "moe_scale": float(want.abs().max()),
           "moe_shape": tuple(got.to_local().shape),
           "moe_grads": grad_gap}
    q = torch.randn(2, 4, 1, 32, generator=g)
    k = torch.randn(2, 2, 64, 32, generator=g)
    v = torch.randn(2, 2, 64, 32, generator=g)
    seq = [Shard(2), Replicate()]
    for pos in (45, 10):
        o = distributed_decode_attention(
            distribute_tensor(q, mesh, rep), distribute_tensor(k, mesh, seq),
            distribute_tensor(v, mesh, seq), pos, mesh)
        ref = attention_ref(q, k[:, :, :pos + 1], v[:, :, :pos + 1])
        out[f"decode_{pos}"] = float((o.to_local() - ref).abs().max())
    return out


def dtensor_model_rank(rank, world):
    """At world 4 over gloo, a (data 2, model 2) mesh: reduced models on
    DTensors laid out by their logical axes (the dry-run's layout:
    ``constrain`` sites, fsdp gathers, attention and cache writes on each
    rank's shard, the vocabulary-parallel embedding and loss) against the
    same models on plain tensors.  Returns the largest differences, each
    beside the largest plain value."""
    import dataclasses
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models.lm import build_model
    from repro_torch.runtime import sharding as SH
    mesh = make_debug_mesh((2, 2))

    def lay(tree, specs):
        return pytree.tree_map(
            lambda x, ax: SH.distribute(x, SH.NamedSharding(
                mesh, SH.fit_spec(SH.logical_to_spec(ax, mesh), x.shape,
                                  mesh))), tree, specs,
            is_leaf=lambda x: isinstance(x, torch.Tensor))

    def full(x):
        return x.full_tensor() if isinstance(x, DTensor) else x

    def gap(a, b):
        a, b = full(a).detach().float(), b.detach().float()
        return float((a - b).abs().max()), float(b.abs().max())

    out = {}
    g = torch.Generator().manual_seed(0)
    for arch in ("llama3.2-1b", "qwen3-moe-30b-a3b", "smollm-135m"):
        cfg = get_reduced_config(arch, n_layers=2, attn_impl="chunked",
                                 mlp_impl="fused_ref")
        if arch == "smollm-135m":     # 3 heads: replicated over model
            cfg = dataclasses.replace(cfg, n_heads=3, n_kv_heads=3)
        model = build_model(cfg)
        params = model.init_params(seed=0, device="cpu")
        specs = model.param_specs()
        tokens = torch.randint(0, cfg.vocab, (4, 16), generator=g,
                               dtype=torch.int32)
        labels = torch.randint(0, cfg.vocab, (4, 16), generator=g,
                               dtype=torch.int32)
        want = model.forward(params, tokens)
        wl, wg = value_and_grad(model, params, {"tokens": tokens,
                                                "labels": labels})
        with SH.use_mesh(mesh), implicit_replication():
            dp = lay(params, specs)
            dt, dl = (SH.distribute(t, SH.NamedSharding(
                mesh, SH.logical_to_spec(("batch", None), mesh)))
                for t in (tokens, labels))
            got = model.forward(dp, dt)
            gl, gg = value_and_grad(model, dp, {"tokens": dt,
                                                "labels": dl})
        out[f"{arch}/logits"] = gap(got, want)
        out[f"{arch}/loss"] = gap(gl, wl)
        out[f"{arch}/grads"] = max(
            gap(a, b)[0] / max(gap(a, b)[1], 1e-30)
            for a, b in zip(pytree.tree_leaves(gg), pytree.tree_leaves(wg)))
        if arch == "llama3.2-1b":
            _, cache = model.prefill(params, tokens, max_len=24)
            step_tok = tokens[:, :1]
            dcache = {k: v.clone() for k, v in cache.items()}
            want_d, _ = model.decode_step(params, cache, step_tok,
                                          torch.tensor(16))
            with SH.use_mesh(mesh), implicit_replication():
                dc = lay(dcache, model.cache_specs())
                got_d, dc = model.decode_step(
                    dp, dc, SH.distribute(step_tok, SH.NamedSharding(
                        mesh, SH.logical_to_spec(("batch", None), mesh))),
                    SH.distribute(torch.tensor(16), SH.NamedSharding(
                        mesh, SH.Spec())))
            out["decode/logits"] = gap(got_d, want_d)
            out["decode/cache"] = gap(dc["k"], cache["k"])
    return out
