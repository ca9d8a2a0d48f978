"""One run of one cell: set-up, the measured window, the readers, the
check.  ``bench/run.py`` calls :func:`main`; the CPU tests call
:func:`run_cell` with ``device="cpu"`` and a small configuration.

Set-up (counted in ``setup_s``, from process start): the program's
import, the weights drawn from the seed on the device, the engine built
and warmed (``Engine.warmup()``: every kernel the run touches compiled,
built and run once), and the first tick, which prefills every client's
first request.  The window opens when that tick ends and closes at the
end of the first tick that ends ``--seconds`` later.  With ``--trace 1``
the profiler runs over ticks from the middle of the window on (a
lead-in tick, then ``PROFILE_TICKS`` more, at least ``PROFILE_MIN_EACH``
of them decode-only and as many with a prefill).

After the window: the peak of device memory is read, the engine is
freed, and the check runs (``benchlib.check``).
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

#: top-level module names that must not be loaded once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: the profiled ticks of a traced run: from this share of the window on,
#: a lead-in tick and then this many, at least PROFILE_MIN_EACH of them
#: decode-only and as many that prefilled (at most four times as many)
PROFILE_START_SHARE = 0.5
PROFILE_TICKS = 24
PROFILE_MIN_EACH = 6


@dataclass
class Run:
    """What the metric readers read (``bench/metrics/<name>.py``)."""
    setup_s: float
    t_open: float
    t_close: float
    ticks: list                      # the window's ticks (serving.Tick)
    requests: dict                   # rid -> serving.Request
    peak_mem_bytes: int
    traced: Optional[list] = None    # (Tick, trace.TickTrace), counted

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open


def port_config(cfg: dict, device):
    """The program's ``ModelConfig`` of the configuration file's
    ``port`` section: float32, the fused pipeline on the emitted CUDA
    kernels (their plain versions on CPU tensors)."""
    import torch
    from repro_torch import configs as C
    from repro_torch.models.common import ModelConfig
    port = dict(cfg["port"])
    if port.get("expert_share") is not None:
        port["expert_share"] = tuple(port["expert_share"])
    mc = ModelConfig(**port, dtype=torch.float32)
    return C.with_pipeline(mc, backend="cuda" if device.type == "cuda"
                           else "torch")


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout.split()
        return float(out[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _window(loop, t_open: float, seconds: float, trace: bool,
            profile: tuple, cuda: bool):
    """Tick until the first tick that ends ``seconds`` after ``t_open``;
    traced, run the profiler over a lead-in tick and the ticks after it
    from ``profile``'s start share of the window on.  Returns the
    profiler (None untraced), the lead-in tick and the counted ticks."""
    import torch
    from benchlib.trace import TICK
    start_share, want, each = profile
    start_at = start_share * seconds
    prof, state, lead, counted = None, "off", None, []
    while time.perf_counter() - t_open < seconds:
        if loop.idle():
            loop.poll()
            continue
        if trace and state == "off" and \
                time.perf_counter() - t_open >= start_at:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if cuda:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            state = "lead"
        on = state in ("lead", "on")
        with (torch.profiler.record_function(TICK) if on
              else contextlib.nullcontext()):
            t = loop.tick(profiled=on)
        if state == "lead":
            lead, state = t, "on"
        elif state == "on":
            counted.append(t)
            n_pre = sum(1 for c in counted if c.n_prefill)
            if (len(counted) >= want and n_pre >= each
                    and len(counted) - n_pre >= each) \
                    or len(counted) >= 4 * want:
                prof.stop()
                state = "done"
    if state in ("lead", "on"):
        prof.stop()
    return prof, lead, counted


def _read_trace(prof, engine, lead, counted, loop, log):
    """The profiled ticks paired with their spans (the lead-in dropped),
    the ``breakdown`` and the ``device`` entries of a traced run."""
    from benchlib import trace as T
    from benchlib.stats import pct
    labels = {k.kname: name for name, k in engine.kernels.items()
              if hasattr(k, "kname")}
    spans = T.summarize(prof.profiler.kineto_results.events(), labels)
    rows = ([lead] if lead is not None else []) + counted
    if len(spans) != len(rows):
        log(f"trace: {len(spans)} tick spans for {len(rows)} profiled "
            "ticks")
    pairs = list(zip(rows, spans))[1:]
    busy = sum(s.busy_ns for _, s in pairs) / 1e9
    span = ((pairs[-1][1].end_ns - pairs[0][1].start_ns) / 1e9
            if pairs else 0.0)
    breakdown = {"device_ops": T.top([s.ops for _, s in pairs]),
                 "idle_gaps": T.top([s.idle for _, s in pairs])}
    on = pct([t.wall_ms for t, _ in pairs if not t.n_prefill], 50)
    off = pct([t.wall_ms for t in loop.ticks[1:]
               if not t.profiled and not t.n_prefill], 50)
    log(f"trace: {len(pairs)} ticks profiled; decode tick median {on} ms "
        f"profiled, {off} ms not")
    return pairs, breakdown, {"busy_s": busy, "window_s": span}


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, *, device: str = "cuda",
             t_start: Optional[float] = None, cfg: Optional[dict] = None,
             mix: Optional[dict] = None, log=None,
             keep: Optional[dict] = None, control: bool = False,
             profile: tuple = (PROFILE_START_SHARE, PROFILE_TICKS,
                               PROFILE_MIN_EACH)) -> dict:
    """Run ``workload`` once; returns the result line as a dict.
    ``cfg``/``mix``/``profile`` replace the cell's files and the profiled
    ticks (the CPU tests' small models); ``keep``, where given, receives
    the run's record and the comparison; ``control`` also reads the
    control (``calibrate.py``; the benchmark's own runs never do)."""
    import torch
    from benchlib import check, spec, weights
    from benchlib.counts import ModelShape
    from benchlib.serving import Loop
    from traffic import gen

    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    w = spec.cell(bench, workload)
    cfg = cfg or spec.config(bench, w["config"])
    mix = mix or spec.traffic(w["traffic"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    from repro_torch.launch.engine import Engine
    from repro_torch.models.lm import LM

    mc = port_config(cfg, dev)
    meta = LM(mc).init_params(0, "meta")
    flat = weights.draw(meta, cfg["init"], seed, dev)
    ref_weights = weights.reference_names(flat, cfg["param_map"])
    eng_cfg = mix["engine"]
    engine = Engine(mc, params=weights.rebuild(meta, flat), device=dev,
                    max_batch=eng_cfg["max_batch"],
                    max_len=eng_cfg["max_len"],
                    prompt_buckets=tuple(eng_cfg["prompt_buckets"]),
                    sampling="greedy", repromote_after=None)
    del flat
    engine.warmup()
    shape = ModelShape.of(cfg)
    loop = Loop(engine, gen.source(mix, cfg["vocab_size"], seed), shape)
    loop.start()
    loop.tick()                         # the first requests' prefills
    t_open = time.perf_counter()
    setup_s = t_open - t_start
    log(f"setup {setup_s:.3f} s; warmup compiles "
        f"{engine.warmup_compiles}, nvcc builds {engine.warmup_builds}")

    prof, lead, counted = _window(loop, t_open, seconds, trace, profile,
                                  cuda)
    ticks = loop.ticks[1:]
    t_close = ticks[-1].end if ticks else t_open
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    traced, breakdown, dev_extra = None, None, {}
    if prof is not None:
        traced, breakdown, dev_extra = _read_trace(prof, engine, lead,
                                                   counted, loop, log)
        del prof

    run = Run(setup_s=setup_s, t_open=t_open, t_close=t_close,
              ticks=ticks,
              requests=loop.requests, peak_mem_bytes=peak, traced=traced)
    metrics = {}
    for m in spec.metrics_of(bench, workload, trace):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    sent_in = [r for r in loop.requests.values()
               if t_open <= r.sent < t_close]
    failed = len(loop.failures) + sum(1 for r in sent_in if r.first is None)
    finished = loop.finished()

    # the program's state goes before the reference runs
    loop.engine = None
    del engine
    gc.collect()
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()

    k = int(cfg["check"]["sample_requests"])
    reqs = check.sample(finished, seed, k)
    t_ref = time.perf_counter()
    cmp = check.compare(cfg, ref_weights, reqs, dev, with_control=control)
    got = cmp["program"] or {}
    log(f"check: {len(reqs)} requests, {cmp['served_tokens']} served "
        f"tokens, reference {time.perf_counter() - t_ref:.3f} s; "
        f"served_gap {got.get('served_gap')!r}, requests_off "
        f"{got.get('requests_off')!r}")
    # the numbers the configuration compares; nothing compared reads
    # None, which fails
    numbers = {name: {"value": got.get(name), "limit": limit}
               for name, limit in cfg["check"]["limits"].items()}
    numbers["failed"] = {"value": failed, "limit": 0}
    correct = check.decide(numbers)
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
        "power_limit_w": _power_limit() if cuda else None,
        **dev_extra,
    }
    out = {"correct": correct, "attempted": len(sent_in), "failed": failed,
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = numbers
    if keep is not None:
        keep.update(run=run, compare=cmp, sample=reqs)
    return out


def setup_env(root: Path) -> None:
    """Every build and kernel cache of the program at a fixed path in the
    checkout: only a cell's first run there compiles."""
    build = root / "build" / "bench"
    os.environ["REPRO_TORCH_KERNEL_CACHE"] = str(build / "kernel-cache")
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "nvcc")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch-extensions")
    os.environ["USE_FLAX"] = "0"
    src = str(root / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="run one benchmark cell once")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchlib import check, spec
    bench = spec.load()
    w = spec.cell(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < w["chips"]:
        print(f"bench: {args.workload} needs {w['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    setup_env(spec.ROOT)
    out = run_cell(bench, args.workload, args.seed, args.seconds,
                   bool(args.trace), t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"bench: the run loaded {bad}", file=sys.stderr)
        return 3
    for line in check.lines(out["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
