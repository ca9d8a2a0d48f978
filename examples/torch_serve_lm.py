"""Continuous-batching serving on the PyTorch/CUDA port: an open-loop
request trace through the slot scheduler and the ragged decode step on
the emitted CUDA kernels (``repro_torch.launch.serve``).  The port's
counterpart of ``examples/serve_lm.py``; attention-family archs only
(padded bucket prefill is exact under causal masking).

    PYTHONPATH=src python examples/torch_serve_lm.py --arch smollm-135m
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu \\
        --reduced --n-layers 2

On the card the full-width model serves through the emitted kernels;
``--device cpu`` runs their plain versions (with ``--reduced`` to keep it
small).  Without a card and without ``--device cpu`` it raises.
"""

import argparse

import torch

from repro_torch.launch import serve as S


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--n-requests", type=int, default=12)
    ap.add_argument("--sampling", default="greedy",
                    choices=("greedy", "categorical"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n-layers", type=int, default=None)
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to serve on "
                           "the kernels' plain versions")
    cli = ["--arch", args.arch, "--n-requests", str(args.n_requests),
           "--sampling", args.sampling, "--device", args.device]
    if args.reduced:
        cli.append("--reduced")
    if args.n_layers:
        cli += ["--n-layers", str(args.n_layers)]
    report = S.main(cli)
    assert report.n_completed == report.n_requests, report
    assert report.decode_recompiles == 0
    return report


if __name__ == "__main__":
    main()
