"""Where a serving decode step spends its time on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_decode \\
        --arch llama3.2-1b --steps 5 --json profile_decode.json

Builds the serving engine at the full width of ``--arch`` (smollm-135m by
default), or of the ``port`` object of ``--config``'s JSON file (a
benchmark configuration: ``--config bench/configs/mla/deepseek-v3-671b.json
--max-batch 32 --max-len 1024`` is that cell's model and decode shape;
``--n-layers`` cuts the depth; ``--max-batch`` slots of
``--max-len`` positions; seeded random weights, the ``cuda`` backend),
fills every slot with a prefilled prompt,
then runs ``--steps`` ragged decode steps, eagerly (``LM.decode_step``
driven by hand; the engine's captured graph replays the same kernels):

* each step on the host clock, ending in ``torch.cuda.synchronize()``,
  and the host's time to enqueue one, the device idle and busy;
* the same steps under ``torch.profiler`` (CPU and CUDA), after a lead-in
  step and a pause (the profiler can miss the first kernels of a session
  on the card; :func:`bursts` keeps the timed steps' kernels): device
  time by kernel name (the emitted kernels are named
  ``emit_region_<gid>`` and ``emit_group_<gid>``), by model span
  (``repro_torch.tracing``) and by product path (an emitted kernel's
  tensor-core or CUDA-core products), the device's busy share of the
  timed steps' wall time, and its idle time by the program span the host
  was in;
* the CUDA syncs one engine decode step makes
  (``torch.cuda.set_sync_debug_mode("warn")``), and the launches one
  step counts of each of the engine's kernels (``launches_per_step``: the
  emitted ones and, with MoE layers, the grouped expert kernel);
* the step's bound (:func:`step_cost`): the larger of its bytes (every
  weight but the embedding's unread rows, the attended rows of every
  cache tensor the model has, the logits) over 3.35 TB/s and its
  operations over 67 TFLOP/s (float32), the H100 SXM data sheet's rates.

It prints one JSON object, and needs a card: without one it exits
nonzero.  :func:`profile_decode` does the same for an engine the caller
has built and warmed; :func:`profile_steps` for any step function (a
model's ``decode_step`` driven by hand, say).
"""

from __future__ import annotations

import argparse
import bisect
import json
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

from repro_torch import tracing as T


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


def bursts(events, gap: float):
    """The device events of a profile (``(start, end, ...)`` tuples on the
    card's clock) split into bursts wherever the card sat idle for more
    than ``gap`` (in the events' unit), in time order."""
    out, last_end = [], float("-inf")
    for ev in sorted(events):
        if ev[0] - last_end > gap:
            out.append([])
        out[-1].append(ev)
        last_end = max(last_end, ev[1])
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


#: the ``record_function`` range of :func:`profile_steps`'s timed calls
TIMED = "profile_steps:timed"
#: the prefix of the host events that launch device work: CUDA runtime
#: (``cuda*``) and CUDA API (``cu*``) calls
LAUNCH_CALLS = "cu"
#: ``torch.cuda._sleep`` cycles ahead of an enqueue timed behind a busy
#: device: ~0.4 s at the H100's 1.98 GHz
BUSY_CYCLES = 800_000_000


#: the product path of a device operation that no emitted kernel ran
NOT_EMITTED = "not emitted"


def product_path(event_name: str, paths: dict) -> str:
    """The product path (``paths``: ``CudaKernel.product_path`` by
    ``CudaKernel.kname``) of the emitted kernel a profiler event names
    (``void emit_region_g1_23_...(KArgs)``), or :data:`NOT_EMITTED`."""
    head = event_name.split("(")[0].split()
    return paths.get(head[-1] if head else event_name, NOT_EMITTED)


def _innermost(ranges, starts, t: float):
    """The name of the innermost of ``ranges`` (``(start, end, name)``,
    sorted by start; ``starts`` their starts) that holds ``t``, or
    ``"other"``: on one thread's nested ranges, the holder that started
    last."""
    for start, end, name in reversed(ranges[:bisect.bisect_right(starts,
                                                                 t)]):
        if end >= t:
            return name
    return "other"


def _gaps(intervals, lo: float, hi: float):
    """The stretches of ``[lo, hi]`` that no interval covers."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def split(host, device, steps: int, paths=None) -> dict:
    """Where a profiled window's device time goes, from the host events
    ``host`` (``(start, end, name, correlation)``, one thread's) and the
    window's device operations ``device`` (the same fields), in ns on the
    profiler's clock; the window is the host event named :data:`TIMED`;
    ``paths``: the emitted kernels' product paths by name
    (:func:`product_path`).

    * ``device_ms_per_step_by_kernel``: by name;
    * ``device_ms_per_step_by_class``: class, then kernel name; a
      kernel's class is the innermost model span (``tracing.MODEL``) that
      held the call that launched it (:data:`LAUNCH_CALLS`, matched by
      correlation id), ``"other"`` where none did, ``"unlinked"`` where
      no launching call was recorded;
    * ``device_ms_per_step_by_product_path``: path, then class: an
      emitted kernel's ``CudaKernel.product_path`` (``"tc3xtf32"``: its
      tile products on the tensor cores, ``"fma"``: on the CUDA cores),
      :data:`NOT_EMITTED` for every other operation;
    * ``device_busy_ms``: the union of the operations' intervals;
    * ``device_idle_ms_per_step_by_span``: the window's stretches with no
      device operation, each by the innermost program span (a model span
      or ``launch``) the host was in at its midpoint, ``"other"`` outside
      them.

    Times are ms (ms a step where named so)."""
    ranges = sorted((s, e, n[len(T.RANGE):]) for s, e, n, _ in host
                    if n.startswith(T.RANGE))
    model = [r for r in ranges if r[2] in T.MODEL]
    starts, model_starts = [r[0] for r in ranges], [r[0] for r in model]
    launched = {c: s for s, _, n, c in host
                if c and n.startswith(LAUNCH_CALLS)}
    lo, hi = next((s, e) for s, e, n, _ in host if n == TIMED)
    by_name, by_class, by_path, intervals = {}, {}, {}, []
    for start, end, name, corr in device:
        if end <= start:
            continue
        ms = (end - start) / steps / 1e6
        short = name if len(name) <= 96 else name[:93] + "..."
        by_name[short] = by_name.get(short, 0.0) + ms
        t = launched.get(corr)
        cls = ("unlinked" if t is None
               else _innermost(model, model_starts, t))
        part = by_class.setdefault(cls, {})
        part[short] = part.get(short, 0.0) + ms
        part = by_path.setdefault(product_path(name, paths or {}), {})
        part[cls] = part.get(cls, 0.0) + ms
        intervals.append((start, end))
    idle = {}
    for start, end in _gaps(intervals, lo, hi):
        name = _innermost(ranges, starts, (start + end) / 2)
        idle[name] = idle.get(name, 0.0) + (end - start) / steps / 1e6
    return {"device_busy_ms": _busy_us(intervals) / 1e6,
            "device_ms_per_step_by_kernel": dict(
                sorted(by_name.items(), key=lambda kv: -kv[1])),
            "device_ms_per_step_by_class": by_class,
            "device_ms_per_step_by_product_path": by_path,
            "device_idle_ms_per_step_by_span": dict(
                sorted(idle.items(), key=lambda kv: -kv[1]))}


def profile_steps(step, steps: int = 5, paths=None) -> dict:
    """Time ``steps`` calls of ``step(i)`` on the host clock, each ending
    in ``torch.cuda.synchronize()``, then profile as many more under
    ``torch.profiler`` (CPU and CUDA) after a lead-in call and a pause
    (:func:`bursts` keeps the timed calls' kernels), split by
    :func:`split`: device time by kernel, by model span and by product
    path (``paths``, as :func:`split` takes them), the card's busy time
    and share of the timed calls' wall time, and its idle time by program
    span.  ``host_enqueue_ms``: the host's time for one call
    to return, with the device idle and behind a busy one.  Times are ms
    a step but the totals'."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    pause_s = 0.2            # far longer than any idle gap inside a step
    step(0)
    torch.cuda.synchronize()
    host_ms = []
    for i in range(steps):
        t0 = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
    # the host's time to enqueue one call, the device idle and behind a
    # kernel that keeps it busy past the enqueue: alike unless a full
    # launch queue makes the host wait for the device
    enqueue_ms = {}
    for where in ("device_idle", "device_busy"):
        torch.cuda.synchronize()
        if where == "device_busy":
            torch.cuda._sleep(BUSY_CYCLES)
        t0 = time.perf_counter()
        step(0)
        enqueue_ms[where] = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        step(0)              # the lead-in, told apart by the pause
        torch.cuda.synchronize()
        time.sleep(pause_s)
        t0 = time.perf_counter()
        with torch.profiler.record_function(TIMED):
            for i in range(steps):
                step(i)
            torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    # the raw events, on one clock for host and device; a range's span on
    # the card's timeline (a user annotation) is no work
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        row = (e.start_ns(), e.end_ns(), e.name(), e.correlation_id())
        if e.device_type() == cpu:
            host.append(row)
        elif e.device_type() == cuda and not e.is_user_annotation():
            device.append(row)
    out = split(host, bursts(device, pause_s * 1e9 / 2)[-1], steps, paths)
    return {"steps": steps, "host_step_ms": host_ms,
            "host_enqueue_ms": enqueue_ms,
            "profiled_window_ms": window_us / 1e3, **out,
            "device_busy_share": (out["device_busy_ms"] * 1e3 / window_us
                                  if window_us else None)}


def syncs(fn) -> list:
    """The CUDA syncs torch reports while ``fn()`` runs
    (``torch.cuda.set_sync_debug_mode("warn")``): each warning's first
    line, once, with its count."""
    seen = {}
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    for w in caught:
        line = str(w.message).splitlines()[0]
        if "called a synchronizing" in line:  # not the mode's notice
            seen[line] = seen.get(line, 0) + 1
    return [[line, n] for line, n in seen.items()]


def profile_decode(engine, steps: int = 5, prompt_len: int = 20) -> dict:
    """Fill every slot of a warmed ``engine`` with a prefilled prompt of
    ``prompt_len`` tokens, then :func:`profile_steps` its ragged decode
    steps, with the step's bound (:func:`step_cost`) and the syncs of one
    step (:func:`syncs`: building its inputs from the slots, and the
    model's ``decode_step``; together the engine's ``decode.forward``).
    Returns the breakdown (see the module docstring)."""
    cfg_len = engine.prompt_buckets[-1]
    rng = np.random.default_rng(0)
    for slot in range(engine.max_batch):
        padded = np.zeros((1, cfg_len), np.int64)
        padded[0, :prompt_len] = rng.integers(0, engine.cfg.vocab,
                                              prompt_len)
        engine._prefill(padded, slot)
    pos = torch.full((engine.max_batch,), prompt_len, device="cuda")
    toks = torch.zeros((engine.max_batch, 1), dtype=torch.long,
                       device="cuda")

    def step(i):
        return engine.model.decode_step(engine.params, engine.caches, toks,
                                        pos + i)

    out = profile_steps(step, steps, {k.kname: k.product_path
                                      for k in engine.kernels.values()
                                      if hasattr(k, "kname")})
    before = {name: k.launches for name, k in engine.kernels.items()}
    step(0)
    out["launches_per_step"] = {
        name: k.launches - before[name]
        for name, k in engine.kernels.items() if k.launches != before[name]}
    out["decode_syncs"] = {"inputs": syncs(engine._decode_inputs),
                           "decode_step": syncs(lambda: step(0))}
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


def config_from_file(path: str, n_layers=None):
    """The float32 ``ModelConfig`` of the ``port`` object of the JSON file
    at ``path``, on the emitted CUDA kernels; ``n_layers`` cuts its depth
    (``serve.cut_depth``)."""
    from repro_torch import configs as C
    from repro_torch.launch import serve as S
    from repro_torch.models.common import ModelConfig
    with open(path) as f:
        port = dict(json.load(f)["port"])
    if port.get("expert_share") is not None:
        port["expert_share"] = tuple(port["expert_share"])
    mc = ModelConfig(**port, dtype=torch.float32)
    if n_layers is not None:
        mc = S.cut_depth(mc, n_layers)
    return C.with_pipeline(mc, backend="cuda")


def main(argv=None) -> dict:
    from repro_torch.launch import serve as S
    from repro_torch.launch.engine import Engine

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--config", default=None,
                    help="a JSON file whose 'port' object holds the "
                         "ModelConfig fields to serve (a benchmark "
                         "configuration's file); replaces --arch")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--n-layers", type=int, default=None)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--prompt-len", type=int, default=20)
    ap.add_argument("--json", dest="json_out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_decode: needs a CUDA card", file=sys.stderr)
        sys.exit(1)

    scfg = S.ServeConfig(arch=args.arch, n_layers=args.n_layers,
                         max_batch=args.max_batch, max_len=args.max_len,
                         seed=0)
    if args.config is None:
        engine = S.build_engine(scfg)
    else:
        engine = Engine(config_from_file(args.config, args.n_layers),
                        device=scfg.device, max_batch=scfg.max_batch,
                        max_len=scfg.max_len, seed=scfg.seed,
                        prompt_buckets=(max(32, 1 << (
                            args.prompt_len - 1).bit_length()),),
                        repromote_after=None)
    engine.warmup()
    out = profile_decode(engine, args.steps, args.prompt_len)
    print(json.dumps(out, indent=1))
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
