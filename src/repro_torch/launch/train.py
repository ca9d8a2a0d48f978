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
* ``--n-layers``, the depth cut of ``launch/serve.py`` (full width kept).

On a CUDA device it runs under :func:`deterministic`, so that a resumed
run's parameters equal an uninterrupted run's bit for bit; the embedding's
backward, a scatter with accumulation, is otherwise not deterministic
there.

``main(argv, **cfg_overrides)`` replaces fields of the model configuration
after the flags (e.g. ``attn_impl="cuda", mlp_impl="cuda", dtype=
torch.float32`` to train on the hand-written kernels in float32); the
reference's ``--mesh`` and its TPU compiler flags wait for the port's
multi-device slice.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys
import time

import torch


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
    with deterministic(device):
        return _train(args, device, model_config(args, **cfg_overrides))


def _train(args, device, cfg) -> dict:
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import SyntheticLMData
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.lm import build_model
    from repro_torch.optim import AdamW, cosine_schedule

    model = build_model(cfg)
    optimizer = AdamW(lr=cosine_schedule(args.lr, 20, args.steps))
    data = SyntheticLMData(cfg.vocab, args.seq, args.batch, seed=args.seed)
    params = model.init_params(seed=args.seed, device=device)
    opt_state = optimizer.init(params)
    start_step = 0

    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr and args.resume == "auto" and mgr.latest_step() is not None:
        state = mgr.restore(device=device)
        params, opt_state = state["params"], state["opt"]
        start_step = int(state["step"])
        print(f"resumed from step {start_step}", flush=True)

    train_step = make_train_step(model, optimizer)
    losses, step_s = [], []
    t0 = last = time.perf_counter()
    for step in range(start_step, args.steps):
        params, opt_state, metrics = train_step(params, opt_state,
                                                data.batch(step, device))
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            losses.append((step, loss))
            rate = (step - start_step + 1) / (time.perf_counter() - t0)
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
