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
