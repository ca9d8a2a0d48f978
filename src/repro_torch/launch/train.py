"""Fault-tolerant training loop of the torch port: the port of
``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/run1

On the card unless ``--device cpu``.  What it exercises:

* auto-resume from the latest checkpoint (``--resume auto``), the
  step-keyed data pipeline replaying identically;
* an asynchronous checkpoint every ``--ckpt-every`` steps, published
  atomically;
* an injected failure (``--fail-at N``: exit 42 after step N, once the
  checkpoint in flight is published) to drill the crash and the restart;
* ``--n-layers``, the depth cut of ``launch/serve.py`` (full width kept);
* ``--mesh debug|single|multi``: data parallel over the mesh's batch axes
  (``pod``, ``data``) of ``launch.mesh``'s debug mesh (every rank on
  ``data``), the (16, 16) production mesh or the (2, 16, 16) one, which
  raise on a world under 256 or 512 ranks.  Each rank trains on its
  ``SyntheticLMData.host_slice``; parameters and optimizer state are
  replicated; the loss and gradients are the whole batch's, each rank's
  weighted by its tokens, so the optimizer's global-norm clip sees the
  global gradient.  A resume restores each leaf onto its logical
  sharding (``param_specs``, ``AdamW.state_specs``) and gathers it for
  the replicated step.  Rank 0 alone logs and writes checkpoints.  The
  ranks come from torchrun (NCCL on ``cuda``, gloo on ``cpu``) or from a
  process group the caller opened; ``--mesh none`` is the one-process
  run.

    torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --reduced --device cpu --mesh debug --steps 20

On a CUDA device it runs under :func:`deterministic`, so that a resumed
run's parameters equal an uninterrupted run's bit for bit; the embedding's
backward, a scatter with accumulation, is otherwise not deterministic
there.

``main(argv, **cfg_overrides)`` replaces fields of the model configuration
after the flags (e.g. ``attn_impl="cuda", mlp_impl="cuda", dtype=
torch.float32`` to train on the hand-written kernels in float32).  The
reference's TPU compiler flags have no counterpart on the card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time

import torch
from torch.utils import _pytree as pytree


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="train a model of the zoo")
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true",
                    help="use the CPU-scale reduced config")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="auto", choices=["auto", "none"])
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="inject a crash after this step (fault drill)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "debug", "single", "multi"])
    return ap.parse_args(argv)


def model_config(args, **cfg_overrides):
    """The configuration ``args`` and ``cfg_overrides`` ask for."""
    from repro_torch.configs import get_config, get_reduced_config
    from repro_torch.launch.serve import cut_depth
    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    if args.n_layers is not None:
        cfg = cut_depth(cfg, args.n_layers)
    return dataclasses.replace(cfg, **cfg_overrides)


@contextlib.contextmanager
def deterministic(device):
    """On a CUDA ``device``: ``torch.use_deterministic_algorithms(True)``
    and the cuBLAS workspace it asks for (``CUBLAS_WORKSPACE_CONFIG=
    :4096:8`` unless set), both as they were on exit.  cuBLAS reads the
    workspace setting when the process first uses it, so it takes effect
    only in a process that has not yet run a product on the card."""
    if torch.device(device).type != "cuda":
        yield
        return
    was = torch.are_deterministic_algorithms_enabled()
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


def main(argv=None, **cfg_overrides) -> dict:
    """Train; returns ``final_loss``, ``losses`` (``(step, loss)`` at each
    logged step), ``params`` and ``step_s`` (each step's host seconds; a
    logged step's include the card's work, since its loss is read)."""
    args = parse_args(argv)
    device = torch.device(args.device)
    with deterministic(device), mesh_of(args.mesh, device) as mesh:
        return _train(args, device, model_config(args, **cfg_overrides),
                      mesh)


@contextlib.contextmanager
def mesh_of(kind: str, device):
    """The mesh ``--mesh`` names (None for ``none``), joining the process
    group for ``device`` where none is open, and closing the group it
    opened on exit."""
    if kind == "none":
        yield None
        return
    import torch.distributed as dist
    from repro_torch.launch import mesh as M
    created = M.init_distributed(device)
    try:
        if kind == "debug":
            yield M.make_debug_mesh((dist.get_world_size(), 1))
        else:
            yield M.make_production_mesh(multi_pod=kind == "multi")
    finally:
        if created:
            dist.destroy_process_group()


def _gathered(tree):
    from torch.distributed.tensor import DTensor
    return pytree.tree_map(
        lambda x: x.full_tensor() if isinstance(x, DTensor) else x, tree)


def _train(args, device, cfg, mesh) -> dict:
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.lm import build_model
    from repro_torch.optim import AdamW, cosine_schedule
    from repro_torch.runtime.collectives import axis_index, batch_axes
    from repro_torch.runtime.sharding import axis_size, tree_shardings

    model = build_model(cfg)
    optimizer = AdamW(lr=cosine_schedule(args.lr, 20, args.steps))
    data = SyntheticLMData(cfg.vocab, args.seq, args.batch, seed=args.seed)
    lead = mesh is None or dist.get_rank() == 0
    if mesh is None:
        def batch(step):
            return data.batch(step, device)
    else:
        index, count = (axis_index(mesh, batch_axes(mesh)),
                        axis_size(mesh, batch_axes(mesh)))
        if args.batch % count:
            raise ValueError(f"batch {args.batch} does not split over "
                             f"{count} data-parallel ranks")

        def batch(step):
            return data.host_slice(step, index, count, device)
    params = model.init_params(seed=args.seed, device=device)
    opt_state = optimizer.init(params)
    start_step = 0

    mgr = (CheckpointManager(args.ckpt_dir, mesh=mesh) if args.ckpt_dir
           else None)
    if mgr and args.resume == "auto" and mgr.latest_step() is not None:
        shardings = None
        if mesh is not None:
            specs = model.param_specs()
            shardings = {"params": tree_shardings(specs, mesh),
                         "opt": tree_shardings(
                             optimizer.state_specs(specs), mesh),
                         "step": None}
        state = mgr.restore(shardings=shardings, device=device)
        params, opt_state = _gathered(state["params"]), _gathered(
            state["opt"])
        start_step = int(state["step"])
        if lead:
            print(f"resumed from step {start_step}", flush=True)

    train_step = make_train_step(model, optimizer, mesh)
    losses, step_s = [], []
    t0 = last = time.perf_counter()
    for step in range(start_step, args.steps):
        params, opt_state, metrics = train_step(params, opt_state,
                                                batch(step))
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            losses.append((step, loss))
            rate = (step - start_step + 1) / (time.perf_counter() - t0)
            if lead:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"({rate:.2f} it/s)", flush=True)
        now = time.perf_counter()
        step_s.append(now - last)
        last = now
        if mgr and args.ckpt_every > 0 and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, {"params": params, "opt": opt_state,
                                "step": torch.tensor(step + 1)})
        if args.fail_at >= 0 and step == args.fail_at:
            if mgr:
                mgr.wait()
            if lead:
                print("injected failure!", flush=True)
            sys.exit(42)
    if mgr:
        mgr.save(args.steps, {"params": params, "opt": opt_state,
                              "step": torch.tensor(args.steps)},
                 blocking=True)
    return {"final_loss": losses[-1][1] if losses else None,
            "losses": losses, "params": params, "step_s": step_s}


if __name__ == "__main__":
    main()
