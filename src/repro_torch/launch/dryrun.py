"""Multi-pod dry-run: run every (architecture x input-shape x mesh) cell's
step once per rank on ``meta`` DTensors at the production mesh and record
its per-rank memory, FLOPs, bytes, collectives and roofline terms.  The
port of ``repro.launch.dryrun``, which lowers and compiles each cell with
``jax.jit`` at 512 forced host devices and reads XLA's analyses.

Here the process joins the ``fake`` process-group backend as rank 0 of a
world of 512 (:func:`init_fake_world`: the counterpart of the reference's
module-level ``XLA_FLAGS``, and as there the command must run as a
process of its own, since the default group is process-global), lays the
ranks out as the production mesh with device type ``cuda`` (the card's
layout, whatever this machine has), distributes ``make_step``'s ``meta``
arguments by their sanitized shardings and runs the step under
``runtime.sharding.use_mesh`` and DTensor's ``implicit_replication`` (the
layers' constants are plain tensors) inside
``runtime.op_analysis.analyze_step``.  Nothing is allocated: a rank's
tensors are ``meta`` shards, and every count is rank 0's.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.json

Each cell runs its plain impls in the model dtype: ``attn_impl="chunked"``
(the reference's ``"xla"``: flash attention as a loop over KV chunks, so
the forward scores stay O(block)) and ``mlp_impl="fused_ref"``
(:data:`DRYRUN_IMPLS`).  The roofline terms come from
:func:`extrapolated_roofline`: every stage count at 1, then each at 2,
extrapolated linearly to the full depth.  In eager mode each layer runs
its own ops, so the counts are exactly linear in the stage counts and the
extrapolation is exact, at a small part of the full depth's cost; the
reference needs it because ``cost_analysis`` counts a scanned layer once.
Memory is extrapolated the same way (the arguments are counted at full
depth, from their shardings).  The reference's ``unroll_scans`` has no
counterpart: nothing is scanned.

Both meshes get the roofline terms (the reference measures them on the
single-pod mesh only, to save compile time).  ``fits_80g_hbm`` holds the
arguments plus the step's peak temporaries against the H100's 80 GB, and
``hbm_bytes_kernel_adj`` takes away the attention scores a fused kernel
keeps in shared memory (:func:`attention_intermediate_bytes`).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import sys
import time
import traceback
from typing import Optional

import torch.distributed as dist
from torch.utils import _pytree as pytree

from repro_torch.configs import (ARCHS, SHAPES, all_cells, cell_supported,
                                 get_config)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import make_step
from repro_torch.models.lm import build_model
from repro_torch.runtime import sharding as SH
from repro_torch.runtime.op_analysis import (HBM_BW, HBM_BYTES, Roofline,
                                             analyze_step, local_bytes,
                                             model_flops)

#: the fake world the dry-run joins: the multi-pod mesh's ranks
WORLD = 512
#: the plain impls every dry-run cell runs (the reference's defaults)
DRYRUN_IMPLS = {"attn_impl": "chunked", "mlp_impl": "fused_ref"}


def init_fake_world(world: int = WORLD) -> None:
    """Join the ``fake`` backend as rank 0 of ``world`` ranks, unless this
    process already belongs to a group of at least that many (then it
    must be the ``fake`` backend's)."""
    if dist.is_initialized():
        if dist.get_backend() != "fake" or dist.get_world_size() < world:
            raise RuntimeError(
                f"the dry-run needs the 'fake' backend at world {world}; "
                f"this process runs {dist.get_backend()!r} at "
                f"{dist.get_world_size()}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    # DTensor warns at every sequential reduction over two mesh axes
    logging.getLogger("torch.distributed.tensor").setLevel(logging.ERROR)


def dryrun_config(cfg):
    """``cfg`` on the dry-run's impls (:data:`DRYRUN_IMPLS`)."""
    return dataclasses.replace(cfg, **DRYRUN_IMPLS)


def active_params(cfg) -> float:
    """Parameter count active per token (MoE: top-k + shared only), from
    the parameters' ``meta`` shapes."""
    params = build_model(cfg).init_params(device="meta")
    total = 0
    for path, leaf in pytree.tree_flatten_with_path(params)[0]:
        keys = [getattr(k, "key", getattr(k, "idx", "")) for k in path]
        n = leaf.numel()
        if any(str(k).startswith("we_") for k in keys) and cfg.n_experts:
            n = int(n * cfg.top_k / cfg.n_experts)
        total += n
    return float(total)


def layer_knobs(cfg):
    """Per-family layer-count knobs: (name, full_count, with_counts)."""
    if cfg.family in ("dense", "vlm", "ssm"):
        return ([("layers", cfg.n_layers)],
                lambda c: dataclasses.replace(cfg, n_layers=c["layers"]))
    if cfg.family == "moe":
        knobs = []
        if cfg.n_dense_layers:
            knobs.append(("dense", cfg.n_dense_layers))
        knobs.append(("moe", cfg.n_layers - cfg.n_dense_layers))

        def wc(c):
            nd = c.get("dense", 0)
            return dataclasses.replace(cfg, n_dense_layers=nd,
                                       n_layers=nd + c["moe"])
        return knobs, wc
    if cfg.family == "hybrid":
        return ([("blocks", cfg.n_layers // cfg.attn_period)],
                lambda c: dataclasses.replace(
                    cfg, n_layers=c["blocks"] * cfg.attn_period))
    if cfg.family == "encdec":
        return ([("enc", cfg.n_enc_layers), ("dec", cfg.n_layers)],
                lambda c: dataclasses.replace(cfg, n_enc_layers=c["enc"],
                                              n_layers=c["dec"]))
    raise ValueError(cfg.family)


def distribute_args(args, shardings):
    """``make_step``'s ``meta`` arguments as DTensors laid out by their
    ``NamedSharding``s (each rank's local shard; no collective)."""
    leaves, spec = pytree.tree_flatten(args)
    shs = pytree.tree_leaves(
        shardings, is_leaf=lambda x: x is None
        or isinstance(x, SH.NamedSharding))
    if len(shs) != len(leaves):
        raise ValueError(f"{len(leaves)} arguments, {len(shs)} shardings")
    return pytree.tree_unflatten(
        [SH.distribute(a, s) for a, s in zip(leaves, shs)], spec)


def _pin_outputs(step, in_shardings):
    """``step`` whose updated parameters and optimizer state are laid out
    on their input shardings: the counterpart of the reference's
    ``out_shardings=(in_sh[0], in_sh[1], None)``.  Eager PyTorch has no
    ``jit`` to pin: the outputs are redistributed, and the collectives
    that costs are counted with the step."""
    def pinned(params, opt_state, batch):
        params, opt_state, metrics = step(params, opt_state, batch)
        params, opt_state = (
            distribute_like(t, sh) for t, sh in
            ((params, in_shardings[0]), (opt_state, in_shardings[1])))
        return params, opt_state, metrics
    return pinned


def distribute_like(tree, shardings):
    """Redistribute each DTensor of ``tree`` to its ``NamedSharding``."""
    from torch.distributed.tensor import DTensor
    leaves, spec = pytree.tree_flatten(tree)
    shs = pytree.tree_leaves(
        shardings, is_leaf=lambda x: x is None
        or isinstance(x, SH.NamedSharding))
    out = []
    for t, sh in zip(leaves, shs):
        if isinstance(t, DTensor) and sh is not None:
            want = sh.placements
            if list(t.placements) != want:
                t = t.redistribute(t.device_mesh, want)
        out.append(t)
    return pytree.tree_unflatten(out, spec)


@contextlib.contextmanager
def _on_mesh(mesh, rules=None):
    from torch.distributed.tensor.experimental import implicit_replication
    with SH.use_mesh(mesh, rules=rules), implicit_replication():
        yield


def _measure(cfg, shape, mesh, rules=None, out_shardings=False):
    """Run one config's step on ``meta`` DTensors ->
    ``op_analysis.StepAnalysis`` (roofline terms and memory).  The step
    runs once uncounted first: DTensor's first sight of an op's sharding
    runs ops of its own (index and concatenation bookkeeping) that later
    calls take from its caches, and the count must not depend on what ran
    before it."""
    with _on_mesh(mesh, rules):
        step, args, shardings_fn = make_step(cfg, shape)
        in_sh = shardings_fn(mesh)
        if out_shardings and shape.kind == "train":
            step = _pin_outputs(step, in_sh)
        step(*distribute_args(args, in_sh))
        return analyze_step(step, distribute_args(args, in_sh))


def _extrapolate(cfg, shape, mesh, rules, out_shardings):
    """The full-depth counts from every stage count at 1 and each at 2:
    ``(Roofline, temp bytes, output bytes)``."""
    knobs, with_counts = layer_knobs(cfg)
    ones = {k: 1 for k, _ in knobs}
    base = _measure(with_counts(ones), shape, mesh, rules, out_shardings)
    roof = base.roofline
    flops, hbm = roof.flops, roof.hbm_bytes
    coll = dict(roof.coll_bytes)
    temp, outb = base.temp_size_in_bytes, base.output_size_in_bytes
    for name, full in knobs:
        two = dict(ones)
        two[name] = 2
        m2 = _measure(with_counts(two), shape, mesh, rules, out_shardings)
        r2 = m2.roofline
        flops += (full - 1) * (r2.flops - roof.flops)
        hbm += (full - 1) * (r2.hbm_bytes - roof.hbm_bytes)
        for k in set(r2.coll_bytes) | set(roof.coll_bytes):
            d = r2.coll_bytes.get(k, 0.0) - roof.coll_bytes.get(k, 0.0)
            coll[k] = coll.get(k, 0.0) + (full - 1) * d
        temp += (full - 1) * (m2.temp_size_in_bytes
                              - base.temp_size_in_bytes)
        outb += (full - 1) * (m2.output_size_in_bytes
                              - base.output_size_in_bytes)
    return Roofline(flops=flops, hbm_bytes=hbm, coll_bytes=coll), temp, outb


def extrapolated_roofline(cfg, shape, mesh, rules=None,
                          out_shardings=False) -> Roofline:
    """The step's per-rank roofline terms at full depth: every stage count
    at 1 and each at 2, extrapolated linearly (exact in eager mode: each
    layer runs its own ops)."""
    return _extrapolate(cfg, shape, mesh, rules, out_shardings)[0]


def argument_bytes(cfg, shape, mesh, rules=None) -> int:
    """The full-depth step's arguments' local bytes on rank 0, from
    ``make_step``'s sanitized shardings (nothing runs)."""
    with SH.use_mesh(mesh, rules=rules):
        _, args, shardings_fn = make_step(cfg, shape)
        return local_bytes(distribute_args(args, shardings_fn(mesh)))


def attention_intermediate_bytes(cfg, shape) -> float:
    """Bytes of materialized attention score/probability intermediates,
    PER CHIP (the reference's formula, kept for parity).  A fused
    attention kernel keeps these scores in shared memory on the card, so
    the kernel-adjusted memory term subtracts them (convention:
    write+read once forward; x3 for train to cover the remat recompute and
    backward reads)."""
    if cfg.family == "ssm":
        return 0.0
    b, s = shape.global_batch, shape.seq_len
    sq = 1 if shape.kind == "decode" else s
    n_attn = cfg.n_layers
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.attn_period
    if cfg.family == "encdec":
        n_attn = cfg.n_layers * 2 + cfg.n_enc_layers  # self+cross+enc
    p_elems = b * cfg.n_heads * sq * s
    passes = 2.0 if shape.kind != "train" else 6.0
    return n_attn * p_elems * 4.0 * passes / 256  # per chip (data+tensor)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True, roofline: bool = True) -> dict:
    mesh_name = "multi" if multi_pod else "single"
    ok, reason = cell_supported(arch, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}
    init_fake_world()
    cfg = dryrun_config(get_config(arch))
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cuda")
    n_chips = mesh.size()
    t0 = time.time()
    roof, temp, outb = _extrapolate(cfg, shape, mesh, None, False)
    args_b = argument_bytes(cfg, shape, mesh)
    mem = {"argument_size_in_bytes": int(args_b),
           "output_size_in_bytes": int(outb),
           "temp_size_in_bytes": int(temp)}
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "status": "ok", "n_chips": n_chips,
              "compile_s": round(time.time() - t0, 1)}
    if roofline:
        tokens = shape.global_batch * (shape.seq_len
                                       if shape.kind != "decode" else 1)
        mf = model_flops(active_params(cfg), tokens,
                         "train" if shape.kind == "train" else "serve")
        result.update({
            "roofline_compile_s": result["compile_s"],
            "flops_per_chip": roof.flops,
            "hbm_bytes_per_chip": roof.hbm_bytes,
            "coll_bytes_per_chip": roof.coll_bytes,
            "t_compute_s": roof.t_compute,
            "t_memory_s": roof.t_memory,
            "t_collective_s": roof.t_collective,
            "bottleneck": roof.bottleneck,
            "model_flops_global": mf,
            "model_flops_per_chip": mf / n_chips,
            "useful_flops_ratio": (mf / n_chips) / roof.flops
            if roof.flops else 0.0,
            "roofline_fraction": roof.fraction_of_roofline(mf / n_chips),
        })
        adj = attention_intermediate_bytes(cfg, shape)
        result["hbm_bytes_kernel_adj"] = max(roof.hbm_bytes - adj, 0.0)
        result["t_memory_kernel_adj_s"] = (result["hbm_bytes_kernel_adj"]
                                           / HBM_BW)
    result.update(mem)
    peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    result["fits_80g_hbm"] = bool(peak < HBM_BYTES)
    if verbose:
        print(json.dumps(result, default=str), flush=True)
    return result


def main(argv: Optional[list] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=sorted(ARCHS))
    ap.add_argument("--shape", default=None, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell")
    ap.add_argument("--out", default=None, help="write results JSON here")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        cells = all_cells()
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape)]

    init_fake_world()
    results = []
    failed = 0
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch} x {shape} x {'multi' if mp else 'single'}"
            print(f"=== dry-run {tag}", flush=True)
            try:
                results.append(run_cell(arch, shape, mp))
            except Exception as e:  # noqa: BLE001
                failed += 1
                traceback.print_exc()
                results.append({"arch": arch, "shape": shape,
                                "mesh": "multi" if mp else "single",
                                "status": "failed", "error": repr(e)})
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=2, default=str)
    print(f"=== done: {sum(r['status'] == 'ok' for r in results)} ok, "
          f"{sum(r['status'] == 'skipped' for r in results)} skipped, "
          f"{failed} failed", flush=True)
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
