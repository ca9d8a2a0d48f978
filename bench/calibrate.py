"""The readings a cell's limit is set from, in one process: the
program's reading and the control's on each of many seeds.

    python3 bench/calibrate.py --workload qwen2-7b.chat --seconds 20 \\
        --seeds 101 102 103 ... --out chiprun_out/cal.jsonl

Each seed is a whole run of the cell (weights, engine, the closed loop
for ``--seconds``, the sample and the reference), and the control reads
the same sampled requests: the reference at TF32 put in the program's
place (``benchlib.check``).  One JSON line a seed.  The benchmark's own
runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

from benchlib import runner, spec  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    runner.setup_env(spec.ROOT)
    bench = spec.load()
    rows = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        keep = {}
        out = runner.run_cell(bench, args.workload, seed, args.seconds,
                              False, keep=keep, control=True)
        cmp = keep["compare"]
        row = {"workload": args.workload, "seed": seed,
               "program": cmp["program"], "control": cmp["control"],
               "served_tokens": cmp["served_tokens"],
               "requests": len(keep["sample"]),
               "correct": out["correct"], "failed": out["failed"],
               "metrics": {k: v["value"] for k, v in out["metrics"].items()},
               "seconds": time.perf_counter() - t0}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del keep, out
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    if args.out:
        Path(args.out).write_text("".join(json.dumps(r) + "\n"
                                          for r in rows))
    bad = runner.forbidden_modules()
    if bad:
        print(f"calibrate: loaded {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
