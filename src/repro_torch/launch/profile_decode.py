"""Where a serving decode step spends its time on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \\
        --arch llama3.2-1b --steps 5 --json profile_decode.json

Builds the serving engine at the full width of ``--arch`` (smollm-135m by
default; ``--n-layers`` cuts the depth; seeded random weights, the
``cuda`` backend), fills every slot with a prefilled prompt,
then runs ``--steps`` ragged decode steps:

* each step on the host clock, ending in ``torch.cuda.synchronize()``;
* the same steps under ``torch.profiler``, after a lead-in step and a
  pause (the profiler can miss the first kernels of a session on the
  card; :func:`bursts` keeps the timed steps' kernels): device time by
  kernel name (the emitted kernels are named ``emit_region_<gid>`` and
  ``emit_group_<gid>``), and the device's busy share of the timed steps'
  wall time (its idle share is the rest);
* the step's bound (:func:`step_cost`): the larger of its bytes (every
  weight, the attended rows of every cache tensor the model has and the
  logits, once) over 3.35 TB/s and its operations over 67 TFLOP/s
  (float32), the H100 SXM data sheet's rates.

It prints one JSON object, and needs a card: without one it exits
nonzero.  :func:`profile_decode` does the same for an engine the caller
has built and warmed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        for v in tree:
            yield from _tensors(v)


def bursts(events, gap_us: float):
    """The device events of a profile (``(start, end, name)``, in
    microseconds on the card's clock) split into bursts wherever the card
    sat idle for more than ``gap_us``, in time order."""
    out, last_end = [], float("-inf")
    for start, end, name in sorted(events):
        if start - last_end > gap_us:
            out.append([])
        out[-1].append((start, end, name))
        last_end = max(last_end, end)
    return out


def _busy_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def step_cost(engine, prompt_len: int):
    """The bytes and float operations a decode step of ``engine`` must
    move and do at ``prompt_len`` filled positions: every weight read
    once, the cache rows attended read once (the values of every cache
    tensor the model has at the ``prompt_len + 1`` positions of each
    sequence: MLA's compressed rows as they are), the logits written
    once, all float32; two operations per weight per sequence."""
    b = engine.max_batch
    weights = sum(t.numel() for t in _tensors(engine.params))
    cache_values = sum(t.numel() // engine.max_len * (prompt_len + 1)
                       for t in engine.caches.values())
    return 4 * (weights + cache_values + b * engine.cfg.vocab), \
        2 * b * weights


def profile_decode(engine, steps: int = 5, prompt_len: int = 20) -> dict:
    """Fill every slot of a warmed ``engine`` with a prefilled prompt of
    ``prompt_len`` tokens, then time ``steps`` ragged decode steps on the
    host clock and profile as many more under ``torch.profiler``.
    Returns the breakdown (see the module docstring)."""
    cfg_len = engine.prompt_buckets[-1]
    rng = np.random.default_rng(0)
    for slot in range(engine.max_batch):
        padded = np.zeros((1, cfg_len), np.int64)
        padded[0, :prompt_len] = rng.integers(0, engine.cfg.vocab,
                                              prompt_len)
        _, cache = engine._prefill(padded)
        engine._insert(cache, slot)
    pos = torch.full((engine.max_batch,), prompt_len, device="cuda")
    toks = torch.zeros((engine.max_batch, 1), dtype=torch.long,
                       device="cuda")

    def step(i):
        return engine.model.decode_step(engine.params, engine.caches, toks,
                                        pos + i)

    step(0)
    torch.cuda.synchronize()
    host_ms = []
    for i in range(steps):
        t0 = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)

    torch.cuda.synchronize()
    pause_s = 0.2            # far longer than any idle gap inside a step
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(0)              # the lead-in, told apart by the pause
        torch.cuda.synchronize()
        time.sleep(pause_s)
        t0 = time.perf_counter()
        for i in range(steps):
            step(i)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    timed = bursts([(ev.time_range.start, ev.time_range.end, ev.name)
                    for ev in prof.events()
                    if ev.device_type == torch.autograd.DeviceType.CUDA],
                   pause_s * 1e6 / 2)[-1]
    by_name, intervals = {}, []
    for start, end, name in timed:
        if end <= start:
            continue
        name = name if len(name) <= 96 else name[:93] + "..."
        by_name[name] = by_name.get(name, 0.0) + end - start
        intervals.append((start, end))
    busy = _busy_us(intervals)
    per_step = {k: v / steps / 1e3 for k, v in
                sorted(by_name.items(), key=lambda kv: -kv[1])}
    step_bytes, step_flops = step_cost(engine, prompt_len)
    return {
        "card": _card(),
        "device": torch.cuda.get_device_name(0),
        "n_layers": engine.cfg.n_layers,
        "batch": engine.max_batch,
        "steps": steps,
        "host_step_ms": host_ms,
        "profiled_window_ms": window_us / 1e3,
        "device_busy_ms": busy / 1e3,
        "device_busy_share": busy / window_us if window_us else None,
        "device_ms_per_step_by_kernel": per_step,
        "step_bytes": step_bytes,
        "step_flops": step_flops,
        "step_bound_ms": max(step_bytes / 3.35e12, step_flops / 67e12) * 1e3,
    }


def main(argv=None) -> dict:
    from repro_torch.launch import serve as S

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--prompt-len", type=int, default=20)
    ap.add_argument("--json", dest="json_out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_decode: needs a CUDA card", file=sys.stderr)
        sys.exit(1)

    engine = S.build_engine(S.ServeConfig(arch=args.arch,
                                          n_layers=args.n_layers, seed=0))
    engine.warmup()
    out = profile_decode(engine, args.steps, args.prompt_len)
    print(json.dumps(out, indent=1))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
