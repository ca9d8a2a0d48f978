"""End-to-end training on the PyTorch/CUDA port: train an LM with
checkpointing and auto-resume on the synthetic data pipeline
(``repro_torch.launch.train``), the attention and the RMSNorm+SwiGLU MLP
on the hand-written CUDA kernels (``attn_impl``/``mlp_impl`` ``"cuda"``).
The port's counterpart of ``examples/train_lm.py``.

The default is a reduced smollm-135m; ``--full`` trains the full
smollm-135m config.  Either way it asserts that the loss falls.

    PYTHONPATH=src python examples/torch_train_lm.py --full --steps 40
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 30

On the card the hand kernels launch; ``--device cpu`` runs their plain
versions.  Without a card and without ``--device cpu`` it raises.
Checkpoints go to ``--ckpt-dir`` (default: a temporary directory, removed
at the end).
"""

import argparse
import shutil
import tempfile

import torch

from repro_torch.launch import train as T


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on "
                           "the kernels' plain versions")
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="torch_train_lm-")
    cli = ["--arch", args.arch, "--steps", str(args.steps),
           "--batch", "8", "--seq", "128", "--lr", "3e-3",
           "--ckpt-dir", ckpt, "--ckpt-every", "100", "--log-every", "10",
           "--device", args.device]
    if not args.full:
        cli.append("--reduced")
    try:
        out = T.main(cli, attn_impl="cuda", mlp_impl="cuda")
    finally:
        if args.ckpt_dir is None:
            shutil.rmtree(ckpt, ignore_errors=True)
    first, last = out["losses"][0][1], out["losses"][-1][1]
    print(f"loss: {first:.3f} -> {last:.3f} over {args.steps} steps")
    assert last < first, "training should reduce loss"
    return out


if __name__ == "__main__":
    main()
