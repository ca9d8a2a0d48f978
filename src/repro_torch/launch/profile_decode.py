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
  weight but the embedding's unread rows, the attended rows of every
  cache tensor the model has, the logits) over 3.35 TB/s and its
  operations over 67 TFLOP/s (float32), the H100 SXM data sheet's rates.

It prints one JSON object, and needs a card: without one it exits
nonzero.  :func:`profile_decode` does the same for an engine the caller
has built and warmed; :func:`profile_steps` for any step function (a
model's ``decode_step`` driven by hand, say), its kernels optionally
split by the layer function that launched them.
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


def step_cost(cfg, params, caches, batch: int, pos: int, max_len: int):
    """The bytes and float operations a decode step of ``batch`` sequences
    must move and do at ``pos`` filled positions of ``max_len``: every
    weight read once but the embedding's unread rows (an untied model
    looks up ``batch`` of them), the attended rows of every cache tensor
    (the values at the ``pos + 1`` positions: MLA's compressed rows as
    they are), the Mamba2 state and conv window (``h``, ``conv``) read and
    written, the logits written once in float32; two operations a weight
    a sequence, an MoE layer's experts (``we_*``) only on their capacity's
    rows (``layers.moe_capacity``), as ``bmm`` multiplies them."""
    from repro_torch.models import layers as L

    def size(t):
        return t.numel() * t.element_size()

    embed = params["embed"]
    unread = (0 if cfg.tie_embeddings
              else embed.numel() - batch * embed.shape[1])
    read = sum(t.numel() for t in _tensors(params)) - unread
    experts = sum(t.numel() for layer in params["layers"]
                  for k, t in layer.get("mlp", {}).items()
                  if k.startswith("we_"))
    nbytes = (sum(size(t) for t in _tensors(params))
              - unread * embed.element_size() + 4 * batch * cfg.vocab)
    for name, t in caches.items():
        nbytes += (2 * size(t) if name in ("h", "conv")
                   else size(t) // max_len * (pos + 1))
    ops = 2 * (batch * (read - experts)
               + (L.moe_capacity(batch, cfg) * experts if experts else 0))
    return nbytes, ops


#: the ``record_function`` ranges of :func:`profile_steps`
TIMED, CLASS = "profile_steps:timed", "profile_steps:class:"


def profile_steps(step, steps: int = 5, classes=None) -> dict:
    """Time ``steps`` calls of ``step(i)`` on the host clock, each ending
    in ``torch.cuda.synchronize()``, then profile as many more under
    ``torch.profiler`` after a lead-in call and a pause (:func:`bursts`
    keeps the timed calls' kernels): device time by kernel name, and the
    card's busy time and share of the timed calls' wall time.

    ``classes`` maps functions of ``models.layers`` to a class of work:
    for the session each runs in a ``record_function`` range (the CPU
    traced too), and each kernel a torch op launched inside one counts to
    the innermost one's class (``device_ms_per_step_by_class``: class,
    then kernel name; ``"other"`` outside them).  Times are ms a step."""
    from repro_torch.models import layers as L
    saved = {}
    for fn_name, cls in (classes or {}).items():
        fn = saved[fn_name] = getattr(L, fn_name)

        def ranged(*a, _fn=fn, _cls=cls, **kw):
            with torch.profiler.record_function(f"{CLASS}{_cls}"):
                return _fn(*a, **kw)
        setattr(L, fn_name, ranged)
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if classes:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    pause_s = 0.2            # far longer than any idle gap inside a step
    try:
        step(0)
        torch.cuda.synchronize()
        host_ms = []
        for i in range(steps):
            t0 = time.perf_counter()
            step(i)
            torch.cuda.synchronize()
            host_ms.append((time.perf_counter() - t0) * 1e3)
        with torch.profiler.profile(activities=acts) as prof:
            step(0)          # the lead-in, told apart by the pause
            torch.cuda.synchronize()
            time.sleep(pause_s)
            t0 = time.perf_counter()
            with torch.profiler.record_function(TIMED):
                for i in range(steps):
                    step(i)
                torch.cuda.synchronize()
            window_us = (time.perf_counter() - t0) * 1e6
    finally:
        for fn_name, fn in saved.items():
            setattr(L, fn_name, fn)
    events = prof.events()
    # a range's span on the card's timeline (a user annotation) is no work
    timed = bursts([(ev.time_range.start, ev.time_range.end, ev.name)
                    for ev in events
                    if ev.device_type == torch.autograd.DeviceType.CUDA
                    and ev.name != TIMED and not ev.name.startswith(CLASS)],
                   pause_s * 1e6 / 2)[-1]
    by_name, intervals = {}, []
    for start, end, name in timed:
        if end <= start:
            continue
        name = name if len(name) <= 96 else name[:93] + "..."
        by_name[name] = by_name.get(name, 0.0) + end - start
        intervals.append((start, end))
    busy = _busy_us(intervals)
    out = {"steps": steps, "host_step_ms": host_ms,
           "profiled_window_ms": window_us / 1e3,
           "device_busy_ms": busy / 1e3,
           "device_busy_share": busy / window_us if window_us else None,
           "device_ms_per_step_by_kernel": {
               k: v / steps / 1e3 for k, v in
               sorted(by_name.items(), key=lambda kv: -kv[1])}}
    if classes:
        by_class = {}
        for ev in events:
            if ev.device_type != torch.autograd.DeviceType.CPU \
                    or not ev.kernels:
                continue
            cls, timed_call, up = None, False, ev
            while up is not None:
                if cls is None and up.name.startswith(CLASS):
                    cls = up.name[len(CLASS):]
                timed_call |= up.name == TIMED
                up = up.cpu_parent
            if not timed_call:
                continue
            part = by_class.setdefault(cls or "other", {})
            for k in ev.kernels:
                part[k.name] = part.get(k.name, 0.0) + k.duration / steps / 1e3
        out["device_ms_per_step_by_class"] = by_class
    return out


def profile_decode(engine, steps: int = 5, prompt_len: int = 20,
                   classes=None) -> dict:
    """Fill every slot of a warmed ``engine`` with a prefilled prompt of
    ``prompt_len`` tokens, then :func:`profile_steps` its ragged decode
    steps, with the step's bound (:func:`step_cost`).  Returns the
    breakdown (see the module docstring)."""
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

    out = profile_steps(step, steps, classes)
    step_bytes, step_flops = step_cost(engine.cfg, engine.params,
                                       engine.caches, engine.max_batch,
                                       prompt_len, engine.max_len)
    return {
        "card": _card(),
        "device": torch.cuda.get_device_name(0),
        "n_layers": engine.cfg.n_layers,
        "batch": engine.max_batch,
        **out,
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
